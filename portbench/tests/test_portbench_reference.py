"""The plain reference against the program (`repro_torch`) at tiny sizes
on the CPU, both in f32: the same three rounds from the same inputs give
the same losses, first gradients and changes, full and sampled, in both
regimes; and the reference's table restricted to a round's participants
is the program's."""
import importlib

import numpy as np
import pytest
import torch

from portbench import check, inputs
from portbench.reference import dfedpgp as ref_dfedpgp
from portbench.tests import _tiny

CELLS = ["cnn32-full", "cnn32-sampled25", "qwen2-0.5b-full",
         "qwen2-0.5b-sampled50"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [5, 2 ** 31 + 11])
def test_reference_matches_the_program(workload, seed):
    _, cfg, traffic = _tiny.cell(workload)
    regime = importlib.import_module(f"portbench.regimes.{cfg['regime']}")
    cell = regime.Cell(cfg, traffic, seed, "cpu")
    prog = cell.readings
    cell.release()
    numbers = check.gaps(prog, cell.reference_readings())
    for name, value in numbers.items():
        assert value <= _tiny.LIMITS[name], (name, value)
    one_step = {p for p, *_ in cell.specs
                if (traffic["k_u"] if p in cell.shared else traffic["k_v"]) == 1}
    assert set(prog.grad) == one_step and one_step


@pytest.mark.parametrize("m,n,frac", [(12, 3, 0.5), (100, 10, 0.25),
                                      (4, 2, 0.5)])
def test_restricted_table_is_the_programs(m, n, frac):
    from repro_torch.core import topology
    for r in range(4):
        idx, w = inputs.directed_table(77, r, m, n)
        active = inputs.active_ids(77, r, m, frac)
        got_idx, got_w = ref_dfedpgp.induced(idx, w, active)
        P = topology.induced_subgraph(topology.SparseTopology(
            torch.from_numpy(idx), torch.from_numpy(w)), active, "row")
        np.testing.assert_array_equal(got_idx, P.idx.numpy())
        np.testing.assert_allclose(got_w, P.w.numpy(), rtol=1e-6, atol=0)


def test_inputs_are_a_function_of_the_seed():
    a = inputs.directed_table(2 ** 31 + 3, 5, 20, 4)
    b = inputs.directed_table(2 ** 31 + 3, 5, 20, 4)
    c = inputs.directed_table(2 ** 31 + 4, 5, 20, 4)
    assert (a[0] == b[0]).all() and not (a[0] == c[0]).all()
    assert (a[0][:, 0] == np.arange(20)).all()
    assert all(len(set(row)) == 5 for row in a[0].tolist())
    rows = inputs.minibatch_rows(9, 1, 3, 50, 4, 8, "cpu")
    assert all(len(set(r.reshape(-1).tolist())) == 32 for r in rows)
    spec = ("w", (3, 4), ("normal", 0.5))
    assert torch.equal(inputs.leaf(spec, 2, 5, 9, "cpu"),
                       inputs.leaf(spec, 2, 5, 9, "cpu"))
