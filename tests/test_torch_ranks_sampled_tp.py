"""The sampled round and the round gauges across four gloo ranks against
the JAX reference (the cases of tests/test_torch_ranks_sampled.py that
take four ranks, in a file of their own so that the two groups run side
by side):
- 3 sampled rounds of reduced() qwen2-0.5b, m 8, at W 4 with injected
  actives that leave two ranks empty (then one): every state leaf at the
  Regime B tolerance (rtol 1e-4, atol 2e-5), mu bit for bit (k 3 <
  n_act 4: the reference's mix gathers), the dormant rows of every round
  bit for bit, the gauges at rtol 1e-5, atol 1e-6;
- the same at (data 2, model 2) through the tensor-parallel executor (a
  round where data index 0 owns no active client), and 3 resident rounds
  there, gauges included;
- a config whose d_flat is odd (the executor keeps whole rows, so no
  buffer term may sum over the model group) at m 4, frac 0.5: sampled
  rounds (n_act 2 <= k 3: the reference's mix densifies, the cross-rank
  mix gathers; mu at rtol 1e-6) and resident rounds, gauges included;
- telemetry on bit for bit the state of telemetry off at (2, 2)."""
import pytest

from test_torch_ranks_sampled import (M, ODD, check_gauges, check_state,
                                      check_telemetry_is_pure, jobs,
                                      reference_rounds, rounds_job)

# W 4: blocks {0, 1} {2, 3} {4, 5} {6, 7}
ACT4 = ((0, 1, 2, 3), (0, 1, 6, 7), (1, 2, 3, 5))
# (data 2, model 2): blocks {0..3} {4..7}; round 1 leaves data index 0
ACT22 = ((0, 1, 2, 5), (4, 5, 6, 7), (1, 3, 4, 6))
# the odd config at m 4 over (2, 2): blocks {0, 1} {2, 3}
M_ODD = 4
ACT_ODD = ((0, 1), (1, 2), (0, 3))
ODD_KEY = tuple(sorted(ODD.items()))


@pytest.fixture(scope="module")
def group4(tmp_path_factory):
    todo = {"w4": rounds_job(M, actives=ACT4),
            "tp_sampled": rounds_job(M, T=2, actives=ACT22),
            "tp_sampled_off": rounds_job(M, T=2, actives=ACT22,
                                         telemetry=False),
            "tp_resident": rounds_job(M, T=2),
            "tp_resident_off": rounds_job(M, T=2, telemetry=False),
            "odd_sampled": rounds_job(M_ODD, T=2, actives=ACT_ODD,
                                      replace=ODD_KEY),
            "odd_resident": rounds_job(M_ODD, T=2, replace=ODD_KEY)}
    meanwhile = [lambda: reference_rounds(M, ACT4),
                 lambda: reference_rounds(M, ACT22),
                 lambda: reference_rounds(M),
                 lambda: reference_rounds(M_ODD, ACT_ODD, ODD_KEY),
                 lambda: reference_rounds(M_ODD, None, ODD_KEY)]
    return jobs(tmp_path_factory, 4, todo, meanwhile)


def test_sampled_rounds_w4_with_empty_ranks_match_reference(group4):
    check_state(group4["w4"], M, ACT4)
    check_gauges(group4["w4"], M, ACT4)


def test_sampled_rounds_data2_model2_match_reference(group4):
    check_state(group4["tp_sampled"], M, ACT22)
    check_gauges(group4["tp_sampled"], M, ACT22)


def test_resident_gauges_data2_model2_match_reference(group4):
    check_state(group4["tp_resident"], M)
    check_gauges(group4["tp_resident"], M)


@pytest.mark.parametrize("kind", ["tp_sampled", "tp_resident"])
def test_telemetry_on_is_off_bitwise_data2_model2(group4, kind):
    check_telemetry_is_pure(group4[kind], group4[kind + "_off"])


def test_odd_d_flat_sampled_rounds_keep_whole_rows_and_match_reference(
        group4):
    want, _ = reference_rounds(M_ODD, ACT_ODD, ODD_KEY)
    assert want["flat"].shape[1] % 2 == 1
    check_state(group4["odd_sampled"], M_ODD, ACT_ODD, ODD_KEY,
                mu_rtol=1e-6)
    check_gauges(group4["odd_sampled"], M_ODD, ACT_ODD, ODD_KEY)


def test_odd_d_flat_resident_gauges_match_reference(group4):
    check_state(group4["odd_resident"], M_ODD, replace=ODD_KEY)
    check_gauges(group4["odd_resident"], M_ODD, replace=ODD_KEY)
