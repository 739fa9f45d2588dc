from .engine import make_cnn_server, serve_logits, serve_naive
from .state import ServingState, from_train_state

__all__ = ["ServingState", "from_train_state", "make_cnn_server",
           "serve_logits", "serve_naive"]
