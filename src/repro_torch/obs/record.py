"""Versioned metric records — the ONE shape every execution path emits
(port of `repro/obs/record.py`, with the same schema constants, so each
package's readers accept the other's files).

Five kinds, one envelope (docs/observability.md §Records):

  kind="round"  sync simulator round / resident Regime B round
  kind="tick"   AsyncRuntime tick window
  kind="serve"  one serve_batch call
  kind="graph"  collaboration-graph snapshot every `graph_every` rounds
                (schema v2; docs/observability.md §Graph diagnostics)
  kind="alert"  flight-recorder anomaly trip (schema v2; obs.flight)

Each record is a flat JSON-able dict with a fixed envelope
(schema/kind/step identity) plus kind-specific required fields and any
number of optional gauges.  This module imports no torch, so
`repro_torch.obs.report` can load it without a device runtime.

Bump SCHEMA_VERSION when a required field changes meaning or a new one
becomes required; readers (report --check) accept
records up to their own version and reject newer ones loudly rather
than misreading them.
"""
from __future__ import annotations

import json
import math
from typing import Any, Dict, Iterable, Iterator, Optional, TextIO, Union

# v2: adds the "graph" and "alert" kinds.  v1 records remain
# valid under v2 readers (no v1 field changed meaning); v2 records are
# rejected loudly by v1 readers — the newer-schema rule below.
SCHEMA_VERSION = 2

# envelope present on every record
_ENVELOPE = ("schema", "kind", "run", "algo", "step")

# per-kind REQUIRED fields beyond the envelope; everything else is an
# optional gauge carried verbatim.
_REQUIRED = {
    "round": ("wire_bytes",),
    "tick": ("vtime", "wire_bytes"),
    "serve": ("path", "batch", "latency_ms"),
    "graph": ("contraction",),
    "alert": ("reason",),
}

_KINDS = tuple(_REQUIRED)


def _clean(v: Any) -> Any:
    """JSON-able scalar: unwrap 0-d tensors / numpy scalars, map the
    non-JSON floats (nan/inf) to None.  A tensor on the card costs one
    device sync here: callers fetch a round's gauges together first
    (`gauges.to_host`)."""
    if hasattr(v, "item"):
        v = v.item()
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


def make_record(kind: str, *, run: str = "", algo: str = "",
                step: int = 0, **gauges: Any) -> Dict[str, Any]:
    """Build a schema-stamped record.  `step` is the round index, tick
    index, or serve-call sequence number.  Gauges may be python scalars,
    numpy scalars, or 0-d tensors (unwrapped here)."""
    rec: Dict[str, Any] = {"schema": SCHEMA_VERSION, "kind": kind,
                           "run": run, "algo": algo, "step": int(step)}
    for k, v in gauges.items():
        if v is None:
            continue
        rec[k] = _clean(v)
    return rec


def round_record(**kw: Any) -> Dict[str, Any]:
    return make_record("round", **kw)


def tick_record(**kw: Any) -> Dict[str, Any]:
    return make_record("tick", **kw)


def serve_record(**kw: Any) -> Dict[str, Any]:
    return make_record("serve", **kw)


def graph_record(**kw: Any) -> Dict[str, Any]:
    return make_record("graph", **kw)


def alert_record(**kw: Any) -> Dict[str, Any]:
    return make_record("alert", **kw)


def validate(rec: Dict[str, Any],
             max_schema: int = SCHEMA_VERSION) -> None:
    """Raise ValueError naming the first problem; returns None when the
    record is well-formed.  A record from a NEWER schema than the reader
    supports is an error — silent misreads are how metric streams rot."""
    if not isinstance(rec, dict):
        raise ValueError(f"record is {type(rec).__name__}, not dict")
    for k in _ENVELOPE:
        if k not in rec:
            raise ValueError(f"missing envelope field {k!r}: {rec}")
    schema = rec["schema"]
    if not isinstance(schema, int) or schema < 1:
        raise ValueError(f"bad schema version {schema!r}")
    if schema > max_schema:
        raise ValueError(
            f"record schema v{schema} is newer than supported v{max_schema}"
            " — upgrade the reader")
    kind = rec["kind"]
    if kind not in _KINDS:
        raise ValueError(f"unknown record kind {kind!r}")
    if not isinstance(rec["step"], int):
        raise ValueError(f"step must be int, got {rec['step']!r}")
    for k in _REQUIRED[kind]:
        if k not in rec:
            raise ValueError(f"{kind} record missing required {k!r}: {rec}")
    for k, v in rec.items():
        if not isinstance(v, (int, float, str, bool, type(None))):
            raise ValueError(f"gauge {k!r} is not a JSON scalar: {v!r}")


def render(rec: Dict[str, Any]) -> str:
    """Human-readable one-liner — the form report prints per row.  Stable field order: identity, the learning
    signal, then whichever gauges the record carries."""
    kind = rec.get("kind", "?")
    bits = [f"[{kind} {rec.get('step', '?'):>4}]"]
    if rec.get("algo"):
        bits.append(rec["algo"])
    for k in ("loss", "acc", "vtime", "latency_ms", "consensus_gap_mean",
              "mass_total", "ef_ratio", "wire_bytes", "round_s",
              "contraction", "moved_mass", "row_cos_mean"):
        if k in rec and rec[k] is not None:
            v = rec[k]
            bits.append(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}")
    if kind == "serve":
        bits.insert(1, f"{rec.get('path', '?')}/B={rec.get('batch', '?')}")
    if kind == "alert":
        bits.append(f"reason={rec.get('reason', '?')}")
        if rec.get("detector"):
            bits.append(f"detector={rec['detector']}")
    return " ".join(bits)


def dumps(rec: Dict[str, Any]) -> str:
    return json.dumps(rec, sort_keys=True)


def load_jsonl(fp: Union[str, TextIO],
               max_schema: Optional[int] = None) -> Iterator[Dict[str, Any]]:
    """Yield validated records from a JSONL file (path or handle).
    Blank lines are skipped; malformed lines raise with their line
    number so CI failures point at the offending record."""
    own = isinstance(fp, str)
    fh = open(fp) if own else fp
    try:
        for i, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                validate(rec, max_schema or SCHEMA_VERSION)
            except ValueError as e:
                raise ValueError(f"line {i}: {e}") from None
            yield rec
    finally:
        if own:
            fh.close()


def schema_of(records: Iterable[Dict[str, Any]]) -> int:
    """Highest schema version present in a record stream (0 if empty) —
    what a reader checks before trusting a stream."""
    return max((r.get("schema", 0) for r in records), default=0)
