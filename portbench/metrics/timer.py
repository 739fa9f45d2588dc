"""CUDA-event timing of enqueued work (the arithmetic of the port's
`chip_smoke.py` `time_ms`): an event recorded before and after on the
current stream, their elapsed time read once the second has passed."""
from __future__ import annotations

import torch


class Events:
    """with Events() as ev: <enqueue work>; then ev.ms() -> the device's
    milliseconds from the first event to the second."""

    def __enter__(self) -> "Events":
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.start.record()
        return self

    def __exit__(self, *exc) -> None:
        self.end.record()

    def ms(self) -> float:
        self.end.synchronize()
        return self.start.elapsed_time(self.end)
