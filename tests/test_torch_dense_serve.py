"""The personalized mixed-user decode of a dense LM (`repro_torch.serve.
decode`, the port of `examples/serve_decode.py`) on the CPU.

One reference checkpoint (the example's fleet: DFedPGP's resident state of
m reduced() models, every row set to client 0's shared part) is read by
the port's `serve.from_checkpoint`; the port's greedy decode (the trunk
once per step, each request's final_norm row, `head_gather_matmul` over
the stacked lm_head) is held against the example's own `decode_hidden`
plus the reference's `head_gather_matmul` on the reference's serving
state.  The example is loaded by path."""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.checkpoint import save_train_state as jsave_train_state
from repro.configs import get_reduced as jget_reduced
from repro.core import dfedpgp as jdfedpgp
from repro.core import partition as jpartition
from repro.kernels import ops as jops
from repro.models import dense as jdense
from repro.models import layers as JL
from repro.optim import SGD as JSGD
from repro_torch import configs, tree
from repro_torch.models import dense as tdense
from repro_torch.serve import decode, from_checkpoint, from_train_state

torch.set_num_threads(2)
EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / "serve_decode.py"


def _example():
    spec = importlib.util.spec_from_file_location("serve_decode_example",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_fleet(cfg, m):
    """The example's fleet, step for step."""
    template = jdense.init_params(jax.random.PRNGKey(0), cfg)
    mask = jpartition.build_mask(template, jpartition.classifier_personal)
    algo = jdfedpgp.DFedPGP(
        loss_fn=lambda p, b: jdense.loss_fn(p, b, cfg), mask=mask,
        opt_u=JSGD(lr=0.1), opt_v=JSGD(lr=0.1))
    stacked = jax.vmap(lambda k: jdense.init_params(k, cfg))(
        jax.random.split(jax.random.PRNGKey(1), m))
    state, layout = algo.init_flat(stacked)
    state = state._replace(flat=jnp.tile(state.flat[0:1], (m, 1)),
                           mu=jnp.full_like(state.mu, 1.0))
    return state, layout


def _reference_greedy(ex, sstate, uid, cfg, tokens, cache_len):
    """The example's serve loop (its decode_hidden, the gathered final_norm
    rows, the reference's head_gather_matmul) -> (B, T) tokens, logits."""
    fnorm = sstate.personal["final_norm"][uid]
    head_w = sstate.personal["lm_head"]
    head_b = jnp.zeros((head_w.shape[0], cfg.vocab), jnp.float32)
    cache = jdense.init_cache(cfg, uid.shape[0], cache_len)

    @jax.jit
    def serve_step(cache, toks, pos):
        h, cache = ex.decode_hidden(sstate.trunk, cache, toks, pos, cfg)
        hp = JL.rms_norm(h[:, 0, :], fnorm.astype(h.dtype), cfg.norm_eps)
        return jops.head_gather_matmul(uid, hp, head_w, head_b), cache

    toks = jnp.zeros((uid.shape[0], 1), jnp.int32)
    out, logits_seen = [], []
    for t in range(tokens):
        logits, cache = serve_step(cache, toks, jnp.int32(t))
        toks = jnp.argmax(logits, -1, keepdims=True).astype(jnp.int32)
        out.append(toks[:, 0])
        logits_seen.append(np.asarray(logits))
    return np.asarray(jnp.stack(out, -1)), logits_seen


# qwen2-0.5b is the example's default; danube's window 16 makes the shared
# cache a 16-slot ring, which 20 tokens wrap
@pytest.mark.parametrize("arch,tokens", [("qwen2-0.5b", 16),
                                         ("h2o-danube-1.8b", 20)])
def test_decode_matches_the_example_on_a_reference_checkpoint(arch, tokens,
                                                              tmp_path):
    ex = _example()
    m, B = 4, 8
    cfg_j, cfg_t = jget_reduced(arch), configs.get_reduced(arch)
    jstate, jlayout = _reference_fleet(cfg_j, m)
    jsave_train_state(str(tmp_path), 42, jstate)
    jss, _ = jserve.from_checkpoint(str(tmp_path), jstate, layout=jlayout,
                                    consensus=0)
    # the port reads the reference's checkpoint against a template of its
    # own fleet's structure
    template, layout = decode.build_fleet(cfg_t, m, device="cpu")
    tss, step = from_checkpoint(str(tmp_path), template, layout=layout,
                                consensus=0)
    assert step == 42 and tss.n_users() == m
    assert sorted(tss.personal) == ["final_norm", "lm_head"]
    # both sides unravel the same consensus row
    jtrunk = jax.tree_util.tree_flatten_with_path(jss.trunk)[0]
    assert len(jtrunk) == len(tree.leaves(tss.trunk))
    for path, leaf in jtrunk:
        got = tree.get(tss.trunk, tuple(k.key for k in path))
        np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))
    for name in ("final_norm", "lm_head"):
        np.testing.assert_array_equal(tss.personal[name].numpy(),
                                      np.asarray(jss.personal[name]))

    juid = jnp.arange(B, dtype=jnp.int32) % m
    want_seq, want_logits = _reference_greedy(ex, jss, juid, cfg_j, tokens,
                                              decode.CACHE_LEN)
    uid = (torch.arange(B) % m).to(torch.int32)
    got_seq, got_logits = decode.greedy(tss, uid, cfg_t, tokens)
    assert got_seq.shape == (B, tokens) and got_seq.dtype == torch.int64
    np.testing.assert_array_equal(got_seq.numpy(), want_seq)
    for t, (g, w) in enumerate(zip(got_logits, want_logits)):
        assert g.shape == (B, cfg_t.vocab) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4,
                                   err_msg=f"step {t}")


def test_serve_step_is_each_users_full_model():
    # request r's logits are the decode step of user uid[r]'s whole model
    # (the trunk with that user's final_norm and lm_head)
    cfg = configs.get_reduced("granite-3-2b")
    m, B = 3, 5
    state, layout = decode.build_fleet(cfg, m, device="cpu")
    sstate = from_train_state(state, layout=layout, consensus=0)
    uid = torch.tensor([2, 0, 1, 1, 2], dtype=torch.int32)
    toks = torch.tensor([[5], [17], [250], [0], [99]])
    cache = tdense.init_cache(cfg, B, 16, device="cpu")
    with torch.no_grad():
        logits, new = decode.serve_step(sstate, uid, cache, toks, 0, cfg)
        assert logits.shape == (B, cfg.vocab) and new["k"].shape[1] == B
        for r in range(B):
            full = sstate.user_model(int(uid[r]))
            one = tdense.init_cache(cfg, 1, 16, device="cpu")
            want, _ = tdense.decode_step(full, one, toks[r:r + 1], 0, cfg)
            np.testing.assert_allclose(logits[r].numpy(), want[0, 0].numpy(),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "h2o-danube-1.8b"])
def test_main_runs_on_the_cpu(arch, capsys):
    assert decode.main(["--arch", arch, "--device", "cpu", "--tokens", "4",
                        "--batch", "6", "--clients", "3"]) == 0
    out = capsys.readouterr().out
    assert "restored step 42; 3 users" in out
    assert "6 mixed-user requests x 4 tokens" in out


def test_main_refuses_other_families_and_needs_a_card_by_default():
    with pytest.raises(SystemExit):
        decode.main(["--arch", "recurrentgemma-9b", "--device", "cpu"])
    if not torch.cuda.is_available():
        # the entry point runs on the card unless the caller asks for the
        # CPU: without one it raises rather than falling back
        with pytest.raises(RuntimeError, match="device='cpu'"):
            decode.main(["--tokens", "1"])
