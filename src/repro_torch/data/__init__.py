from .synthetic import ClientData, from_arrays, make_dataset, sample_batches

__all__ = ["ClientData", "from_arrays", "make_dataset", "sample_batches"]
