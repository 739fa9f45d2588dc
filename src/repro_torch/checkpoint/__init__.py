from .checkpoint import (flatten, load_pytree, restore_train_state,
                         save_pytree, save_train_state, zeros_like)

__all__ = ["flatten", "save_pytree", "load_pytree", "save_train_state",
           "restore_train_state", "zeros_like"]
