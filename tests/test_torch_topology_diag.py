"""The topology diagnostics, `TopologySchedule` constructors and schedule
stochasticity checks the port's analyzer needs (`repro_torch.core.topology`,
`repro_torch.analysis.detectors.check_schedules`), held against the JAX
package on the CPU: the same numpy inputs through both packages, exact
(bitwise) where the arithmetic is one IEEE op per entry; the random kinds'
tables equal the port's `get_schedule` (torch cannot replay `jax.random`).
"""
import numpy as np
import pytest
import torch

from repro.analysis import detectors as jdetectors
from repro.analysis import fixtures as jfixtures
from repro.core import topology as jtopology
from repro_torch.analysis import detectors
from repro_torch.core import topology as ttopology

torch.set_num_threads(2)
M = 13


def _t_topo(P):
    return ttopology.SparseTopology(torch.tensor(np.asarray(P.idx)),
                                    torch.tensor(np.asarray(P.w)))


# ---------------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------------
def _dense_input(m=9, seed=0):
    """A row-stochastic (m, m) matrix with uneven row supports and tied
    weights (the ordering rule is visible)."""
    rng = np.random.default_rng(seed)
    A = (rng.random((m, m)) < 0.35) | np.eye(m, dtype=bool)
    W = np.where(A, rng.integers(1, 4, (m, m)), 0).astype(np.float32)
    return (W / W.sum(1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("k", [None, 8])
def test_from_dense_matches_reference(k):
    P = _dense_input()
    want = jtopology.from_dense(P, k)
    got = ttopology.from_dense(P, k)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.w.numpy(), np.asarray(want.w))
    assert got.idx.dtype == torch.int32 and got.w.dtype == torch.float32
    # the short rows are padded with (self, 0)
    pad = got.w.numpy() == 0
    assert pad.any()
    rows = np.broadcast_to(np.arange(P.shape[0])[:, None], pad.shape)
    np.testing.assert_array_equal(got.idx.numpy()[pad], rows[pad])


def test_from_dense_refuses_k_below_nnz():
    P = _dense_input()
    nnz = int((P > 0).sum(1).max())
    with pytest.raises(ValueError, match=f"max row nnz {nnz}"):
        jtopology.from_dense(P, nnz - 1)
    with pytest.raises(ValueError, match=f"max row nnz {nnz}"):
        ttopology.from_dense(P, nnz - 1)


def test_densify_matches_reference():
    P = jtopology.TopologySchedule.random(M, 3, seed=4).at(1)
    np.testing.assert_array_equal(ttopology.densify(_t_topo(P)).numpy(),
                                  np.asarray(jtopology.densify(P)))
    D = _dense_input()
    np.testing.assert_array_equal(ttopology.densify(D).numpy(),
                                  np.asarray(jtopology.densify(D)))


@pytest.mark.parametrize("case", ["random", "zero_column"])
def test_to_column_stochastic_matches_reference(case):
    if case == "random":
        P = jtopology.TopologySchedule.random(M, 3, seed=4).at(0)
        Pt = _t_topo(P)
    else:
        # no self-loops and node 0 pulled by nobody: a zero column of the
        # transposed edge set takes the self-loop
        P = np.zeros((5, 5), np.float32)
        P[0, 1] = P[1, 2] = P[2, 3] = P[3, 4] = P[4, 1] = 1.0
        Pt = P
    want = np.asarray(jtopology.to_column_stochastic(P))
    got = ttopology.to_column_stochastic(Pt).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got.sum(0), 1.0, rtol=1e-6)


def _windows():
    ring = jtopology.TopologySchedule.ring(8)
    exp = jtopology.TopologySchedule.exponential(16)
    pair = np.zeros((4, 4), np.float32)          # {0, 1} and {2, 3}
    pair[[0, 1, 2, 3], [1, 0, 3, 2]] = 0.5
    pair[np.arange(4), np.arange(4)] = 0.5
    # one exponential round at offset 2 splits 16 clients into two cycles;
    # its window of log2(16) rounds is strongly connected
    return {"ring": [ring.at(0)], "exp_offset_2": [exp.at(1)],
            "exp_window": [exp.at(t) for t in range(exp.period)],
            "disconnected_pair": [pair]}


CONNECTED = {"ring": True, "exp_offset_2": False, "exp_window": True,
             "disconnected_pair": False}


@pytest.mark.parametrize("name", list(CONNECTED))
def test_strong_connectivity_matches_reference(name):
    Ps = _windows()[name]
    Pt = [_t_topo(P) if isinstance(P, jtopology.SparseTopology) else P
          for P in Ps]
    assert ttopology.is_strongly_connected(Pt[0]) == \
        jtopology.is_strongly_connected(Ps[0])
    got = ttopology.union_strongly_connected(Pt)
    assert got == jtopology.union_strongly_connected(Ps) == CONNECTED[name]


# ---------------------------------------------------------------------------
# the TopologySchedule constructors
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind,m", [("ring", 13), ("exponential", 16),
                                    ("full", 13)])
def test_static_classmethod_tables_bitwise(kind, m):
    js = getattr(jtopology.TopologySchedule, kind)(m)
    ts = getattr(ttopology.TopologySchedule, kind)(m)
    assert ts == ttopology.get_schedule(kind, m)
    assert (ts.kind, ts.m, ts.n, ts.seed) == (js.kind, js.m, js.n, js.seed)
    for t in range(5):
        np.testing.assert_array_equal(ts.at(t).idx.numpy(),
                                      np.asarray(js.at(t).idx))
        np.testing.assert_array_equal(ts.at(t).w.numpy(),
                                      np.asarray(js.at(t).w))


def test_exponential_refuses_non_power_of_two():
    with pytest.raises(AssertionError, match="power-of-two"):
        jtopology.TopologySchedule.exponential(13)
    with pytest.raises(AssertionError, match="power-of-two"):
        ttopology.TopologySchedule.exponential(13)


@pytest.mark.parametrize("kind", ["random", "undirected"])
def test_random_classmethods_equal_get_schedule(kind):
    ts = getattr(ttopology.TopologySchedule, kind)(M, 3, seed=13)
    assert ts == ttopology.get_schedule(kind, M, 3, 13)
    js = getattr(jtopology.TopologySchedule, kind)(M, 3, seed=13)
    assert (ts.kind, ts.m, ts.n, ts.seed) == (js.kind, js.m, js.n, js.seed)
    assert ts.at(2).idx.shape == tuple(js.at(2).idx.shape)


def test_get_schedule_refuses_unknown_kind():
    with pytest.raises(ValueError, match="schedule kind 'star'"):
        jtopology.get_schedule("star", 8)
    with pytest.raises(ValueError, match="schedule kind 'star'"):
        ttopology.get_schedule("star", 8)


# ---------------------------------------------------------------------------
# schedule stochasticity
# ---------------------------------------------------------------------------
def test_check_schedules_rows_match_reference():
    jrows, jviols = jdetectors.check_schedules()
    trows, tviols = detectors.check_schedules()
    assert trows == jrows and not jviols and not tviols
    assert {r["kind"] for r in trows} == set(
        ttopology.TopologySchedule.KINDS)


def test_stochastic_message_matches_reference():
    P = jfixtures.broken_stochastic_topology()
    want = jdetectors.check_topology_stochastic(P, "leak")
    got = detectors.check_topology_stochastic(_t_topo(P), "leak")
    assert got == want and "row-stochastic" in got[0]
