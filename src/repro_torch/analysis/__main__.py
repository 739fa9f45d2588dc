"""CLI for the program invariant analyzer.

    python -m repro_torch.analysis --all                 # programs + schedules
    python -m repro_torch.analysis --program simA.resident
    python -m repro_torch.analysis --fixture densify     # exit 1 = tripped
    python -m repro_torch.analysis --list
    ... --device cpu                                     # the plain path

Exit codes: `--all` / `--program` exit 1 on any violation; `--fixture`
exits 1 when the broken fixture trips its detector — so a check asserts
`! python -m repro_torch.analysis --fixture X` for each fixture; an
unknown program exits 2.  The programs run on the card unless
`--device cpu` is given; without a card the CUDA default raises.

The reference's `--devices` flag (host devices forced for its Regime B
mesh) has no counterpart: the port lays all 13 clients on one device.
"""
import argparse
import sys
from typing import List, Optional


def _parse(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="op-recording lint over every registered program")
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--all", action="store_true",
                   help="lint every registered program + schedule kinds")
    g.add_argument("--program", metavar="NAME",
                   help="lint one registered program")
    g.add_argument("--fixture", metavar="NAME",
                   help="run a deliberately-broken fixture (exit 1 = trip)")
    g.add_argument("--list", action="store_true",
                   help="list registered programs and fixtures")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the programs run (default cuda)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    ns = _parse(sys.argv[1:] if argv is None else argv)

    from repro_torch.analysis import detectors, fixtures, programs

    if ns.list:
        print("programs:")
        for name in programs.PROGRAMS:
            print(f"  {name}")
        print("fixtures (each must exit 1):")
        for name in fixtures.FIXTURES:
            print(f"  {name}")
        return 0

    if ns.fixture:
        rows, viols = fixtures.run_fixture(ns.fixture, device=ns.device)
        print(detectors.render_report(rows, [], viols), end="")
        if viols:
            print(f"fixture '{ns.fixture}': detector tripped as intended")
            return 1
        print(f"fixture '{ns.fixture}': detector DID NOT trip "
              f"(the analyzer lost this check)")
        return 0

    names = tuple(programs.PROGRAMS) if ns.all else (ns.program,)
    if not ns.all and ns.program not in programs.PROGRAMS:
        print(f"unknown program '{ns.program}' "
              f"(--list shows the registry)", file=sys.stderr)
        return 2
    rows, viols = [], []
    for name in names:
        row, v = detectors.run_program(
            programs.PROGRAMS[name](device=ns.device))
        rows.append(row)
        viols += v
    srows = []
    if ns.all:
        srows, sviols = detectors.check_schedules()
        viols += sviols
    print(detectors.render_report(rows, srows, viols), end="")
    if viols:
        print(f"{len(viols)} violation(s)")
        return 1
    print("all invariants hold")
    return 0


if __name__ == "__main__":
    sys.exit(main())
