"""`repro_torch.obs.report` — render a run's JSONL into summary tables,
and gate it (port of `repro/obs/report.py`; either package's report reads
the other's files).

    PYTHONPATH=src python -m repro_torch.obs.report run.jsonl [--check]
    PYTHONPATH=src python -m repro_torch.obs.report run.jsonl --graph
    PYTHONPATH=src python -m repro_torch.obs.report --diff a.jsonl b.jsonl
    PYTHONPATH=src python -m repro_torch.obs.report --postmortem dump.json.gz

Plain mode prints the per-kind summary tables the benchmarks used to
hand-roll: round/tick progression (loss, acc, consensus gap, mass,
wire bytes, phase timings) and serve latency percentiles per
(path, batch) tag.  `--check` validates every record against the
schema and hard-fails (exit 1) when the push-sum mass ledger drifts
from its own first value beyond f32 tolerance — the CI telemetry
smoke's teeth.  `--graph` renders the schema-v2 collaboration-graph
records: connectivity trajectory, top-k influential edges, per-client
inflow drill-down.  `--diff` is a step-aligned two-run comparison;
`--postmortem` renders a flight-recorder dump (obs.flight).  It reads
records only, no tensors, so it runs with or without a GPU.
"""
from __future__ import annotations

import argparse
import math
import sys
from typing import Iterable, List

from . import record as _record

# f32 tolerance for mass conservation — matches the runtime invariant
# tests (tests/test_hetero_async.py pins rtol=1e-5 on mass_total).
MASS_RTOL = 1e-5


def percentile(xs: List[float], q: float) -> float:
    """Nearest-rank percentile, q in [0, 100].  Tiny and dependency-free
    — matches the ServeMeter's definition so report and live stats
    agree."""
    if not xs:
        return float("nan")
    s = sorted(xs)
    k = max(0, min(len(s) - 1, int(math.ceil(q / 100.0 * len(s))) - 1))
    return s[k]


def _fmt(v, width=10):
    if v is None:
        return " " * (width - 1) + "-"
    if isinstance(v, float):
        return f"{v:>{width}.4g}"
    return f"{v:>{width}}"


def _table(rows: List[dict], cols: List[str], title: str) -> str:
    cols = [c for c in cols if any(c in r for r in rows)]
    if not rows or not cols:
        return ""
    head = " ".join(f"{c:>10}" for c in cols)
    body = "\n".join(" ".join(_fmt(r.get(c)) for c in cols) for r in rows)
    return f"\n== {title} ({len(rows)} records) ==\n{head}\n{body}\n"


# public alias: the fixed-width table of the obs summaries
table = _table


def summarize_rounds(recs: List[dict], kind: str) -> str:
    cols = ["step", "loss", "acc", "vtime", "consensus_gap_mean",
            "consensus_gap_max", "mass_total", "ef_ratio", "grad_norm",
            "update_norm", "wire_bytes", "t_round_s", "round_s"]
    rows = recs if len(recs) <= 12 else (
        recs[:3] + [{"step": "..."}] + recs[-8:])
    return _table(rows, cols, kind)


def summarize_serve(recs: List[dict]) -> str:
    by_tag: dict = {}
    for r in recs:
        by_tag.setdefault((r.get("path"), r.get("batch")), []).append(r)
    rows = []
    for (path, batch), group in sorted(by_tag.items(),
                                       key=lambda kv: str(kv[0])):
        lats = [r["latency_ms"] for r in group
                if r.get("latency_ms") is not None]
        rps = [r["rps"] for r in group if r.get("rps") is not None]
        rows.append({"path": path, "batch": batch, "calls": len(group),
                     "p50_ms": percentile(lats, 50),
                     "p99_ms": percentile(lats, 99),
                     "rps": percentile(rps, 50)})
    return _table(rows, ["path", "batch", "calls", "p50_ms", "p99_ms",
                         "rps"], "serve")


def parse_edges(spec: str) -> List[tuple]:
    """Inverse of obs.graph.top_edges: 'j->i:val|...' -> [(j, i, val)].
    Malformed parts are skipped (a record is data, not code)."""
    out = []
    for part in (spec or "").split("|"):
        if not part:
            continue
        edge, _, val = part.rpartition(":")
        src, _, dst = edge.partition("->")
        try:
            out.append((int(src), int(dst), float(val)))
        except ValueError:
            continue
    return out


def summarize_graph(recs: List[dict]) -> str:
    """The --graph view: connectivity trajectory (contraction estimate,
    moved mass, similarity gauges, degree load) + top-k influential edges
    aggregated across the run + per-client inflow drill-down."""
    cols = ["step", "contraction", "moved_mass", "row_cos_mean",
            "row_cos_min", "head_dist_mean", "in_degree_mean",
            "starved_frac", "staleness_max", "mass_total"]
    rows = recs if len(recs) <= 12 else (
        recs[:3] + [{"step": "..."}] + recs[-8:])
    out = _table(rows, cols, "graph")
    if not out:
        return ""
    edge_sum: dict = {}
    inflow: dict = {}
    for r in recs:
        for src, dst, val in parse_edges(r.get("top_edges", "")):
            edge_sum[(src, dst)] = edge_sum.get((src, dst), 0.0) + val
            inflow[dst] = inflow.get(dst, 0.0) + val
    if edge_sum:
        top = sorted(edge_sum.items(), key=lambda kv: -kv[1])[:8]
        out += "top edges (sum of per-record attribution):\n"
        out += "".join(f"  {s:>4} -> {d:<4} {v:10.4g}\n"
                       for (s, d), v in top)
        cl = sorted(inflow.items(), key=lambda kv: -kv[1])[:8]
        out += "per-client inflow (top receivers):\n"
        out += "".join(f"  client {c:<4} {v:10.4g}\n" for c, v in cl)
    return out


def diff_runs(recs_a: List[dict], recs_b: List[dict]) -> str:
    """--diff: step-aligned comparison of two runs.  Records pair by
    (kind, step); for each shared gauge of interest the table shows
    a, b and the delta b - a.  Streams that never align produce an empty
    table (the caller reports that loudly)."""
    keyed_b = {(r["kind"], r["step"]): r for r in recs_b}
    out = ""
    for kind in ("round", "tick", "graph"):
        rows = []
        for ra in recs_a:
            if ra["kind"] != kind:
                continue
            rb = keyed_b.get((kind, ra["step"]))
            if rb is None:
                continue
            row = {"step": ra["step"]}
            for g in ("loss", "consensus_gap_mean", "mass_total",
                      "wire_bytes", "contraction"):
                va, vb = ra.get(g), rb.get(g)
                if va is None or vb is None:
                    continue
                row[f"{g}_a"] = va
                row[f"d_{g}"] = vb - va
            rows.append(row)
        if len(rows) > 12:
            rows = rows[:3] + [{"step": "..."}] + rows[-8:]
        out += _table(rows, ["step", "loss_a", "d_loss",
                             "consensus_gap_mean_a", "d_consensus_gap_mean",
                             "mass_total_a", "d_mass_total",
                             "wire_bytes_a", "d_wire_bytes",
                             "contraction_a", "d_contraction"],
                      f"diff:{kind} (a vs b; d_* = b - a)")
    return out


def render_postmortem(payload: dict) -> str:
    """Render a flight-recorder dump (obs.flight.load_postmortem): the
    alert, then the tail of the ring leading up to it."""
    alert = payload.get("alert", {})
    recs = payload.get("records", [])
    lines = [f"== post-mortem (schema v{payload.get('schema', '?')}, "
             f"{len(recs)} ring records) ==",
             f"ALERT: {_record.render(alert)}"]
    for k in ("value", "threshold", "dump", "source_kind"):
        if alert.get(k) is not None:
            lines.append(f"  {k} = {alert[k]}")
    tail = recs[-12:]
    if tail:
        lines.append(f"-- last {len(tail)} records before the trip --")
        lines.extend("  " + _record.render(r) for r in tail)
    return "\n".join(lines) + "\n"


def check_mass(recs: Iterable[dict]) -> List[str]:
    """Mass-conservation gate: within each (run, algo, kind) stream the
    mass_total gauge must stay at its first value to f32 rtol.  (Sync
    and async both conserve total mass exactly in exact arithmetic —
    row-stochastic pull mixing preserves the all-ones mu; the push form
    banks in-flight mass in the mailbox — so drift means a bug, not a
    regime.)"""
    first: dict = {}
    errors = []
    for rec in recs:
        mt = rec.get("mass_total")
        if mt is None:
            continue
        key = (rec.get("run"), rec.get("algo"), rec.get("kind"))
        ref = first.setdefault(key, mt)
        if abs(mt - ref) > MASS_RTOL * max(abs(ref), 1.0):
            errors.append(
                f"{rec['kind']} step {rec['step']}: mass_total={mt!r} "
                f"drifted from {ref!r} (rtol {MASS_RTOL:g})")
    return errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.obs.report",
        description="Render (and optionally gate) a telemetry JSONL run.")
    ap.add_argument("jsonl", nargs="+", help="record file(s); with "
                    "--diff exactly two, with --postmortem dump file(s)")
    ap.add_argument("--check", action="store_true",
                    help="validate schema + mass ledger; exit 1 on drift")
    ap.add_argument("--kind", default="",
                    help="restrict to one record kind "
                         "(round/tick/serve/graph/alert)")
    ap.add_argument("--graph", action="store_true",
                    help="render the collaboration-graph records: "
                         "connectivity trajectory, top-k influential "
                         "edges, per-client inflow")
    ap.add_argument("--diff", action="store_true",
                    help="step-aligned comparison of exactly two runs "
                         "(loss / consensus gap / mass / wire-byte "
                         "deltas, b - a)")
    ap.add_argument("--postmortem", action="store_true",
                    help="render flight-recorder dump file(s) "
                         "(obs.flight post-mortems, .json.gz)")
    args = ap.parse_args(argv)

    if args.postmortem:
        from . import flight
        for path in args.jsonl:
            try:
                print(render_postmortem(flight.load_postmortem(path)),
                      end="")
            except (OSError, ValueError, EOFError) as e:
                print(f"report: INVALID post-mortem {path}: {e}",
                      file=sys.stderr)
                return 1
        return 0

    if args.diff and len(args.jsonl) != 2:
        print("report: --diff wants exactly two record files",
              file=sys.stderr)
        return 2

    recs: List[dict] = []
    per_file: List[List[dict]] = []
    try:
        for path in args.jsonl:
            loaded = list(_record.load_jsonl(path))
            per_file.append(loaded)
            recs.extend(loaded)
    except (OSError, ValueError) as e:
        print(f"report: INVALID: {e}", file=sys.stderr)
        return 1

    if args.kind:
        recs = [r for r in recs if r.get("kind") == args.kind]
    if not recs:
        print("report: no records", file=sys.stderr)
        return 1

    if args.diff:
        out = diff_runs(per_file[0], per_file[1])
        if not out:
            print("report: --diff found no step-aligned records",
                  file=sys.stderr)
            return 1
        print(out, end="")
    elif args.graph:
        out = summarize_graph([r for r in recs if r["kind"] == "graph"])
        if out:
            print(out, end="")
        elif not args.check:
            print("report: no graph records (run with graph_every > 0)",
                  file=sys.stderr)
            return 1
        for a in (r for r in recs if r["kind"] == "alert"):
            print(_record.render(a))
    else:
        for kind in ("round", "tick"):
            out = summarize_rounds([r for r in recs if r["kind"] == kind],
                                   kind)
            if out:
                print(out, end="")
        out = summarize_serve([r for r in recs if r["kind"] == "serve"])
        if out:
            print(out, end="")

    if args.check:
        errors = check_mass(recs)
        if errors:
            print("report: MASS LEDGER DRIFT:", file=sys.stderr)
            for e in errors:
                print(f"  {e}", file=sys.stderr)
            return 1
        print(f"\nreport: OK — {len(recs)} records, schema "
              f"v{_record.schema_of(recs)}, mass ledger conserved "
              f"(rtol {MASS_RTOL:g})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
