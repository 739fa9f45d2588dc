"""Metric sinks — where records go (port of `repro/obs/sink.py`).

`MetricsSink` is a structural protocol: anything with emit(record) /
close().  Three implementations cover every current consumer:

  NullSink   telemetry off — emit is a no-op (the default everywhere)
  RingSink   bounded in-memory ring — tests and live dashboards
  JsonlSink  append-a-line-per-record file — runs, CI smoke, report CLI

Sinks are intentionally dumb: no buffering policy beyond the ring's
bound, no aggregation, no schema knowledge past validate-on-emit (only
JsonlSink validates, so a malformed gauge fails at the write site, not
in a reader three tools later).  Aggregation lives in report.py.
"""
from __future__ import annotations

from collections import deque
from typing import Optional, Protocol, runtime_checkable

from . import record as _record


@runtime_checkable
class MetricsSink(Protocol):
    def emit(self, rec: dict) -> None: ...

    def close(self) -> None: ...


class NullSink:
    """Telemetry off.  Shared singleton via `obs.NULL_SINK`."""

    def emit(self, rec: dict) -> None:
        pass

    def close(self) -> None:
        pass


NULL_SINK = NullSink()


class RingSink:
    """Keep the last `capacity` records in memory.  `records` hands back
    a list copy; `last(kind=...)` the newest matching record."""

    def __init__(self, capacity: int = 4096):
        self._ring: deque = deque(maxlen=capacity)

    def emit(self, rec: dict) -> None:
        self._ring.append(rec)

    def close(self) -> None:
        pass

    @property
    def records(self) -> list:
        return list(self._ring)

    def last(self, kind: Optional[str] = None) -> Optional[dict]:
        for rec in reversed(self._ring):
            if kind is None or rec.get("kind") == kind:
                return rec
        return None


class JsonlSink:
    """One JSON record per line, validated then flushed on every emit so
    a crashed run still leaves a readable prefix.  Usable as a context
    manager; close() is idempotent."""

    def __init__(self, path: str, validate: bool = True):
        self.path = str(path)
        self._validate = validate
        self._fh = open(self.path, "a")

    def emit(self, rec: dict) -> None:
        if self._fh is None:
            raise ValueError(f"JsonlSink({self.path}) is closed")
        if self._validate:
            _record.validate(rec)
        self._fh.write(_record.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TeeSink:
    """Fan one stream out to several sinks (e.g. ring for the live view
    + jsonl for the artifact)."""

    def __init__(self, *sinks: MetricsSink):
        self.sinks = sinks

    def emit(self, rec: dict) -> None:
        for s in self.sinks:
            s.emit(rec)

    def close(self) -> None:
        for s in self.sinks:
            s.close()
