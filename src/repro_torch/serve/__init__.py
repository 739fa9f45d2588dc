from .engine import (ServeMeter, make_cnn_server, make_naive_server,
                     serve_logits, serve_naive)
from .state import (CONSENSUS_MODES, ServingState, from_checkpoint,
                    from_train_state)

__all__ = ["CONSENSUS_MODES", "ServeMeter", "ServingState",
           "from_checkpoint", "from_train_state", "make_cnn_server",
           "make_naive_server", "serve_logits", "serve_naive"]
