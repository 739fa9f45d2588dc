"""mfu: the model FLOPs of a round (`flops`) over round_ms (this run's
untraced window) times the card's published peak in the precision the
step's products run in (TF32 for the CNN's convolutions where cuDNN may
use it, bf16 for the language models)."""
from portbench.metrics import peaks


def read(run):
    if not run.round_s or run.device_name is None:
        return None
    round_s = run.window_s / len(run.round_s)
    peak = peaks.flops(run.device_name, run.precision)
    return 100.0 * run.flops_per_round / (round_s * peak)
