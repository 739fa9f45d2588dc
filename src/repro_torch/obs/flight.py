"""Flight recorder + anomaly gates (port of `repro/obs/flight.py`).

`FlightRecorder` is a `MetricsSink` that wraps any inner sink: every
record passes through unchanged, lands in a bounded in-memory ring, and
is scored by a small set of host-side anomaly detectors.  When one trips,
the recorder emits a `kind="alert"` record (schema v2) through the inner
sink AND dumps the ring — the last `capacity` records of context leading
up to the anomaly — to a compressed post-mortem file that
`repro_torch.obs.report --postmortem` renders.  Detectors run per
(run, algo, kind) stream, exactly the streams `report --check`'s mass
gate walks:

  consensus-growth  consensus_gap_mean rose by > `gap_growth`x over the
                    last `window` records of a stream — mixing has
                    stopped contracting (a partitioned / starved graph,
                    a broken schedule, a diverging clique)
  mass-drift        mass_total left its stream's first value beyond
                    `mass_rtol` — the push-sum ledger is leaking, the
                    de-bias z = u/mu is no longer trustworthy
  ef-blowup         ef_ratio fell below `ef_floor` — the wire codec's
                    error-feedback residual dwarfs the signal (the pipe
                    drops value faster than it drains)
  starved-client    staleness_max exceeded `staleness_limit` ticks —
                    some client has fallen that far behind the fleet
                    head (dead, unavailable, or scheduled out), so its
                    mail is rotting and its model is stale

Each detector observes passively: the training program never blocks on
it and the records it forwards are byte-identical to what it received.
After a trip the offending stream's detector sleeps for `cooldown`
records so one sustained anomaly produces one alert, not one per round.
"""
from __future__ import annotations

import gzip
import json
from collections import deque
from typing import Optional

from . import record as _record
from . import sink as _sink

# defaults: deliberately loose — the recorder is a crash cam, not a lint
GAP_GROWTH = 3.0          # x over the window start
MASS_RTOL = 1e-4          # looser than report --check's 1e-5 gate: the
                          # recorder flags the drift the moment it is
                          # unambiguous, the CI gate pins the invariant
EF_FLOOR = 0.05           # the codec_gamma="auto" clip floor — below it
                          # the anneal is already pegged
STALENESS_LIMIT = 100.0   # ticks behind the fleet head
WINDOW = 8
COOLDOWN = 32


class FlightRecorder:
    """MetricsSink wrapper: ring buffer + anomaly detectors + post-mortem
    dumps.

        fr = FlightRecorder(obs.JsonlSink(path), dump_dir=out_dir)
        run_experiment(..., sink=fr)
        ...
        fr.alerts      # every alert record emitted
        fr.dumps       # paths of the post-mortem files written

    Detector thresholds default to the module constants; pass None to
    disable one detector entirely."""

    def __init__(self, sink=None, *, capacity: int = 512,
                 dump_dir: str = ".", window: int = WINDOW,
                 gap_growth: Optional[float] = GAP_GROWTH,
                 mass_rtol: Optional[float] = MASS_RTOL,
                 ef_floor: Optional[float] = EF_FLOOR,
                 staleness_limit: Optional[float] = STALENESS_LIMIT,
                 cooldown: int = COOLDOWN):
        self.sink = sink if sink is not None else _sink.NULL_SINK
        self.dump_dir = str(dump_dir)
        self.window = max(int(window), 2)
        self.gap_growth = gap_growth
        self.mass_rtol = mass_rtol
        self.ef_floor = ef_floor
        self.staleness_limit = staleness_limit
        self.cooldown = max(int(cooldown), 1)
        self._ring: deque = deque(maxlen=int(capacity))
        self._gap: dict = {}        # stream -> deque of recent gaps
        self._mass0: dict = {}      # stream -> first mass_total
        self._sleep: dict = {}      # stream -> records until re-armed
        self.alerts: list = []
        self.dumps: list = []

    # -- MetricsSink protocol -------------------------------------------
    def emit(self, rec: dict) -> None:
        self._ring.append(rec)
        self.sink.emit(rec)
        if rec.get("kind") in ("round", "tick", "graph"):
            self._inspect(rec)

    def close(self) -> None:
        self.sink.close()

    @property
    def records(self) -> list:
        return list(self._ring)

    # -- detectors (host-side, per-stream) -------------------------------
    def _inspect(self, rec: dict) -> None:
        stream = (rec.get("run"), rec.get("algo"), rec.get("kind"))
        verdict = self._detect(stream, rec)
        asleep = self._sleep.get(stream, 0)
        if asleep > 0:
            self._sleep[stream] = asleep - 1
            return
        if verdict is not None:
            self._trip(stream, rec, *verdict)

    def _detect(self, stream, rec: dict):
        """-> (detector, reason, value, threshold) or None.  State (gap
        window, mass anchor) updates even while the stream cools down, so
        re-arming sees current history, not a stale snapshot."""
        out = None
        gap = rec.get("consensus_gap_mean")
        if gap is not None and self.gap_growth is not None:
            hist = self._gap.setdefault(stream,
                                        deque(maxlen=self.window))
            if len(hist) == hist.maxlen and min(hist) > 0 \
                    and gap > self.gap_growth * hist[0]:
                out = ("consensus-growth",
                       f"consensus_gap_mean grew {gap / hist[0]:.2f}x "
                       f"over the last {self.window} records",
                       float(gap), float(self.gap_growth * hist[0]))
            hist.append(float(gap))
        mt = rec.get("mass_total")
        if out is None and mt is not None and self.mass_rtol is not None:
            ref = self._mass0.setdefault(stream, float(mt))
            if abs(mt - ref) > self.mass_rtol * max(abs(ref), 1.0):
                out = ("mass-drift",
                       f"mass_total={mt!r} drifted from {ref!r} "
                       f"(rtol {self.mass_rtol:g})",
                       float(mt), float(ref))
        ef = rec.get("ef_ratio")
        if out is None and ef is not None and self.ef_floor is not None \
                and ef < self.ef_floor:
            out = ("ef-blowup",
                   f"ef_ratio={ef:.4g} below floor {self.ef_floor:g} — "
                   f"error-feedback residual dwarfs the signal",
                   float(ef), float(self.ef_floor))
        st = rec.get("staleness_max")
        if out is None and st is not None \
                and self.staleness_limit is not None \
                and st > self.staleness_limit:
            out = ("starved-client",
                   f"staleness_max={st:.4g} exceeds "
                   f"{self.staleness_limit:g} ticks — a client is dead "
                   f"or starved",
                   float(st), float(self.staleness_limit))
        return out

    # -- the trip: alert record + compressed ring dump ------------------
    def _trip(self, stream, rec: dict, detector: str, reason: str,
              value: float, threshold: float) -> None:
        self._sleep[stream] = self.cooldown
        alert = _record.alert_record(
            run=rec.get("run", ""), algo=rec.get("algo", ""),
            step=rec.get("step", 0), reason=reason, detector=detector,
            value=value, threshold=threshold, source_kind=rec.get("kind"))
        path = self._dump(alert)
        alert["dump"] = path
        self.alerts.append(alert)
        self._ring.append(alert)
        self.sink.emit(alert)

    def _dump(self, alert: dict) -> str:
        import os
        run = "".join(c if c.isalnum() or c in "-_" else "_"
                      for c in str(alert.get("run") or "run"))
        path = os.path.join(
            self.dump_dir,
            f"postmortem-{run}-step{alert.get('step', 0)}.json.gz")
        payload = {"schema": _record.SCHEMA_VERSION, "alert": alert,
                   "records": list(self._ring)}
        with gzip.open(path, "wt") as f:
            json.dump(payload, f)
        self.dumps.append(path)
        return path


def load_postmortem(path: str) -> dict:
    """Read a post-mortem dump back: {'schema', 'alert', 'records'}.
    Rejects dumps written by a NEWER schema, same rule as record.validate
    — `report --postmortem` goes through here."""
    with gzip.open(path, "rt") as f:
        payload = json.load(f)
    v = payload.get("schema", 0)
    if v > _record.SCHEMA_VERSION:
        raise ValueError(
            f"post-mortem schema v{v} is newer than supported "
            f"v{_record.SCHEMA_VERSION} — upgrade the reader")
    return payload
