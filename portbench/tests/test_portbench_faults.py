"""A whole run on the CPU at a tiny size (the harness's look for a card
skipped): sound, it is correct and reports its end-to-end metrics; with
the timed path broken underneath it is not.  And the control, the
reference in the precision below the configuration's, reads well above
the program."""
import importlib
import math
import time

import pytest

from portbench import check, harness
from portbench.tests import _tiny

FAULTS = ["half_batch", "no_mix", "frozen"]


def _run(workload, fault=None, seed=3):
    cell, cfg, traffic = _tiny.cell(workload)
    return harness.execute(cell, seed, 0.2, False, "cpu",
                           time.perf_counter(), config=cfg, traffic=traffic,
                           limits=_tiny.limits(workload),
                           fault=fault)


@pytest.mark.parametrize("workload", ["cnn32-sampled25", "qwen2-0.5b-full"])
def test_a_sound_run_is_correct(workload):
    res = _run(workload)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    assert {"setup_s", "round_ms"} <= set(res["metrics"])
    assert all(v["value"] > 0 for v in res["metrics"].values())


@pytest.mark.parametrize("workload", ["cnn32-full", "qwen2-0.5b-sampled50"])
@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_path_is_not_correct(workload, fault):
    res = _run(workload, fault)
    assert not res["correct"], res["checks"]


def test_faults_leave_the_program_as_it_was():
    from repro_torch.core import dfedpgp, gossip
    before = (gossip.mix_flat, dfedpgp.DFedPGP.round_fn_flat,
              dfedpgp.DFedPGP.round_fn_sampled)
    for fault in FAULTS:
        _run("cnn32-full", fault)
    assert before == (gossip.mix_flat, dfedpgp.DFedPGP.round_fn_flat,
                      dfedpgp.DFedPGP.round_fn_sampled)


@pytest.mark.parametrize("workload", ["cnn32-full", "qwen2-0.5b-full"])
def test_the_control_reads_above_the_program(workload):
    _, cfg, traffic = _tiny.cell(workload)
    regime = importlib.import_module(f"portbench.regimes.{cfg['regime']}")
    cell = regime.Cell(cfg, traffic, 4, "cpu")
    prog = cell.readings
    cell.release()
    ref = cell.reference_readings()
    control = check.gaps(cell.reference_readings(control=True), ref)
    sound = check.gaps(prog, ref)
    assert any(control[k] > 3 * sound[k] and control[k] > 1e-4
               for k in sound), (control, sound)
    assert all(math.isfinite(v) for v in control.values())
