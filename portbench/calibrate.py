"""The readings the output check's limits are set from, at a cell's own
size and in one process (its set-up is paid once per seed, not per run):

- the program's sound runs, one per seed (the lower readings);
- the control: the reference computed in the precision below the
  configuration's, in the program's place, against the reference;
- the faults planted in the program (`regimes.common.DFedPGPCell._plant`).

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control 4,5,6] [--fault half_batch=7,8,9 ...] [--out FILE]

Each reading is printed as a JSON line; --out writes them all (with
both sides' raw readings), the largest program reading and the smallest
control and fault readings of each number, and the limits that
`check.limits_from` gives; --write-limits writes those into
limits/<cell>.json.  The benchmark's own runs never run this.
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
sys.path.insert(1, os.path.join(ROOT, "src"))

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402

from portbench import catalog, check, harness  # noqa: E402


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def readings(cell, seed: int, kind: str, device) -> dict:
    """One reading: kind "program", "control" or a fault's name."""
    config = catalog.read("configs", cell.config)
    traffic = catalog.read("traffic", cell.traffic)
    regime = importlib.import_module(f"portbench.regimes.{config['regime']}")
    t0 = time.perf_counter()
    if kind == "control":
        c = regime.Cell(config, traffic, seed, device, program=False)
        side = c.reference_readings(control=True)
    else:
        c = regime.Cell(config, traffic, seed, device,
                        fault=None if kind == "program" else kind)
        side = c.readings
        c.release()
    ref = c.reference_readings()
    return {"kind": kind, "seed": seed, "numbers": check.gaps(side, ref),
            "seconds": time.perf_counter() - t0,
            "side": side._asdict(), "reference": ref._asdict()}


def summary(rows: list) -> dict:
    out = {}
    for r in rows:
        for name, v in r["numbers"].items():
            d = out.setdefault(r["kind"], {})
            if r["kind"] == "program":
                d[name] = max(d.get(name, v), v)
            else:
                d[name] = min(d.get(name, v), v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 portbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control", type=_seeds, default=[])
    ap.add_argument("--fault", action="append", default=[],
                    help="name=seed,seed,...")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    ap.add_argument("--write-limits", action="store_true",
                    help="write the limits the readings give into "
                         "limits/<cell>.json")
    args = ap.parse_args(argv)
    cell = catalog.find_cell(catalog.load_benchmark(), args.workload)
    harness.cache_dirs()
    jobs = [("program", s) for s in args.seeds]
    jobs += [("control", s) for s in args.control]
    for spec in args.fault:
        name, seeds = spec.split("=")
        jobs += [(name, s) for s in _seeds(seeds)]
    rows = []
    for kind, seed in jobs:
        row = readings(cell, seed, kind, args.device)
        rows.append(row)
        print(json.dumps({k: row[k] for k in ("kind", "seed", "numbers",
                                               "seconds")}), flush=True)
    result = {"workload": args.workload, "rows": rows,
              "summary": summary(rows),
              "limits": check.limits_from(rows)}
    print(json.dumps(result["summary"]), flush=True)
    print(json.dumps({"limits": result["limits"]}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    if args.write_limits:
        with open(catalog.HERE / "limits" / f"{cell.name}.json", "w") as f:
            json.dump(result["limits"], f, indent=2)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
