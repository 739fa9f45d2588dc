from .synthetic import (ClientData, from_arrays, lm_synthetic_batch,
                        make_dataset, sample_batches)

__all__ = ["ClientData", "from_arrays", "lm_synthetic_batch", "make_dataset",
           "sample_batches"]
