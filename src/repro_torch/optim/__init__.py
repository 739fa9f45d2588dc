from .sgd import SGD, SGDState

__all__ = ["SGD", "SGDState"]
