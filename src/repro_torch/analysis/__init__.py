"""Program invariant analyzer (port of `repro/analysis/`).

Checks over every registered program of the port: densification,
donation, per-round op-signature changes (the eager face of a retrace),
host syncs, schedule stochasticity.  Run `python -m repro_torch.analysis
--all` (on the card; `--device cpu` for the plain path) or import the
pytest-facing API:

    from repro_torch.analysis import run_all, run_program, PROGRAMS

Everything here is lazy (PEP 562): importing the package imports no
program, and the port's modules import `analysis.scope` (the named scopes
reviewed sites wrap themselves in) without pulling in the detectors.
"""
from typing import Any

_EXPORTS = {
    "PROGRAMS": "programs", "ProgramInstance": "programs",
    "SIM_M": "programs", "N_ROUNDS": "programs",
    "Violation": "detectors", "run_all": "detectors",
    "run_program": "detectors", "run_fixture": "fixtures",
    "check_densify": "detectors", "check_donation": "detectors",
    "check_retrace": "detectors", "check_host_sync": "detectors",
    "check_topology_stochastic": "detectors",
    "check_schedules": "detectors", "render_report": "detectors",
    "FIXTURES": "fixtures", "scope": "scope",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str) -> Any:
    try:
        module = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    import importlib
    return getattr(importlib.import_module(f".{module}", __name__), name)
