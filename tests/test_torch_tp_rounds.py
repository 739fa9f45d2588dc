"""Tensor parallelism across four gloo ranks against the JAX reference
(the cases of tests/test_torch_tp.py that take four ranks, in a file of
their own so that the two groups run side by side):
- codeqwen1.5-7b reduced() (4 KV heads) at (data 1, model 4): the loss
  and every leaf's gradient against `jax.value_and_grad` of the
  reference's `loss_fn`;
- 3 resident rounds of reduced() qwen2-0.5b, m 4, at (data 2, model 2)
  with both mixes (a neighbor crosses data indices every round), and 3
  tree-form rounds with the permutation mix, against the reference's
  one-device `round_fn_flat` / `round_fn` over the same schedule: every
  state leaf at the Regime B tolerance (rtol 1e-4, atol 2e-5), mu exact;
- `train.main(["--ranks", "4", "--tp", "2", "--resident", ...])`: its
  records equal the one-rank run's at that tolerance."""
import numpy as np
import pytest

from repro_torch.obs import record as trecord
from repro_torch.launch import train as ttrain
from test_torch_tp import (ATOL, RTOL, _run, check_loss, check_rounds,
                           jobs, loss_case, loss_job, reference_rounds,
                           rounds_job)


@pytest.fixture(scope="module")
def group4(tmp_path_factory):
    """One gloo group of four ranks: the loss at (1, 4), the rounds at
    (2, 2); the reference's side computed while it runs."""
    todo = {"codeqwen": loss_job("codeqwen1.5-7b", 4, {})}
    for g in ("ppermute", "matrix"):
        todo["rounds_" + g] = rounds_job(g, 2, world=2)
    todo["tree"] = rounds_job("ppermute", 2, resident=False, world=2)
    meanwhile = [lambda: loss_case("codeqwen1.5-7b"),
                 lambda: reference_rounds("ppermute", world=2),
                 lambda: reference_rounds("matrix", world=2),
                 lambda: reference_rounds("ppermute", False, world=2)]
    return jobs(tmp_path_factory, 4, todo, meanwhile)


def test_codeqwen_loss_and_gradients_at_model_4_match_reference(group4):
    check_loss(group4["codeqwen"], "codeqwen1.5-7b", {})


@pytest.mark.parametrize("gossip", ["ppermute", "matrix"])
def test_resident_rounds_data2_model2_match_reference(group4, gossip):
    check_rounds(group4["rounds_" + gossip], gossip, world=2)


def test_tree_rounds_data2_model2_match_reference(group4):
    check_rounds(group4["tree"], "ppermute", resident=False, world=2)


TRAIN = ["--arch", "qwen2-0.5b", "--reduced", "--rounds", "2", "--clients",
         "4", "--batch", "2", "--seq", "16", "--neighbors", "2",
         "--resident", "--device", "cpu"]


def _records(path):
    return [r for r in trecord.load_jsonl(str(path)) if r["kind"] == "round"]


def test_train_main_at_data2_model2_gives_the_one_rank_records(tmp_path,
                                                               capsys):
    ttrain.main(TRAIN + ["--metrics", str(tmp_path / "one")])
    capsys.readouterr()
    _run(["-m", "repro_torch.launch.train"] + TRAIN
         + ["--ranks", "4", "--tp", "2", "--metrics", str(tmp_path / "tp")],
         tmp_path)
    one, tp = _records(tmp_path / "one"), _records(tmp_path / "tp")
    assert len(one) == len(tp) == 2
    for a, b in zip(one, tp):
        for key in ("loss", "loss_v", "mu_min", "mu_max"):
            np.testing.assert_allclose(b[key], a[key], rtol=RTOL, atol=ATOL,
                                       err_msg=key)
        assert a["wire_bytes"] == b["wire_bytes"]
