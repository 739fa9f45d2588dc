from .sgd import SGD, SGDState, clip_by_global_norm, exp_decay_schedule

__all__ = ["SGD", "SGDState", "exp_decay_schedule", "clip_by_global_norm"]
