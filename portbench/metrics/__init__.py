"""Metric readers and the yardstick's arithmetic.

`<metric>.py` for each metric of BENCHMARK.json: `read(run)` -> the
value, or None where the run gives it nothing to read (`harness.Run`).
Beside them the arithmetic the readers share: the published peaks
(`peaks`), the work a round does (`flops`), the least bytes a kernel
call moves (`kernel_bytes`), the CUDA-event timer (`timer`) and the profiler
slice and its event-count check (`trace`)."""
