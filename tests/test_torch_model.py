"""Port parity: the CNN, the flat wire layout, SGD, topologies and the gossip
mix of `repro_torch` against the JAX reference on the same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gossip as jgossip
from repro.core import partition as jpartition
from repro.core import topology as jtopology
from repro.models import cnn as jcnn
from repro.optim import SGD as JSGD
from repro.optim import SGDState as JSGDState
from repro_torch import convert, tree
from repro_torch.core import gossip as tgossip
from repro_torch.core import partition as tpartition
from repro_torch.core import topology as ttopology
from repro_torch.kernels import ref as tref
from repro_torch.models import cnn as tcnn
from repro_torch.optim import SGD as TSGD
from repro_torch.optim import SGDState as TSGDState

torch.set_num_threads(2)
CFG_J = jcnn.CNNConfig()
CFG_T = tcnn.CNNConfig()


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _jax_params(seed, m=None):
    key = jax.random.PRNGKey(seed)
    if m is None:
        return _np_tree(jcnn.init_params(key, CFG_J))
    return _np_tree(jax.vmap(lambda k: jcnn.init_params(k, CFG_J))(
        jax.random.split(key, m)))


def _assert_tree_close(t_tree, j_tree, rtol, atol):
    for path, leaf in tree.paths(t_tree):
        ref = j_tree
        for key in path:
            ref = ref[key]
        np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(ref),
                                   rtol=rtol, atol=atol,
                                   err_msg="/".join(path))


# ---------------------------------------------------------------------------
# CNN: logits, loss and grads at converted params
# ---------------------------------------------------------------------------
def test_cnn_logits_loss_grads_match_reference():
    # f32 on both sides; the convolution, GroupNorm and matmul sums run in
    # another order in XLA:CPU and oneDNN, so agreement is to ~1e-6
    # relative, not bitwise: rtol/atol 2e-5
    p_np = _jax_params(0)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=(6,)).astype(np.int32)
    y[2] = -100                                   # the ignore mask
    pj = jax.tree.map(jnp.asarray, p_np)
    bj = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    pt = convert.params_from_reference(p_np)
    bt = {"x": torch.as_tensor(x), "y": torch.as_tensor(y).long()}

    logits_j = jax.jit(jcnn.logits_fn, static_argnums=2)(pj, bj["x"], CFG_J)
    np.testing.assert_allclose(
        tcnn.logits_fn(pt, bt["x"], CFG_T).numpy(), np.asarray(logits_j),
        rtol=2e-5, atol=2e-5)
    lj, gj = jax.jit(jax.value_and_grad(jcnn.loss_fn), static_argnums=2)(
        pj, bj, CFG_J)
    gt, lt = torch.func.grad_and_value(tcnn.loss_fn)(pt, bt, CFG_T)
    np.testing.assert_allclose(float(lt), float(lj), rtol=2e-5)
    _assert_tree_close(gt, _np_tree(gj), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# the flat wire layout
# ---------------------------------------------------------------------------
def test_flat_layout_wire_order_offsets_pack_unravel():
    # pure copies and reshapes: exact
    p_np = _jax_params(1, m=4)
    pj = jax.tree.map(jnp.asarray, p_np)
    mask_j = jpartition.build_mask(jcnn.init_params(jax.random.PRNGKey(0),
                                                    CFG_J),
                                   jpartition.classifier_personal)
    pt = convert.params_from_reference(p_np)
    mask_t = tpartition.build_mask(pt, tpartition.classifier_personal)
    lay = tgossip.FlatLayout.build(pt, mask_t)
    assert [p[-1] for p in lay.paths] == ["conv1", "conv2", "dense", "gb1",
                                          "gb2", "gn1", "gn2"]
    assert lay.offsets == (0, 432, 5040, 13232, 13248, 13280, 13296)
    assert lay.d_flat == 13328
    assert lay.d_flat == jgossip.FlatLayout.build(pj, mask_j).d_flat

    flat_j = np.asarray(jax.jit(lambda p: jgossip.flatten_shared(p, mask_j))(
        pj))
    flat_t = lay.pack(pt, mask_t)
    np.testing.assert_array_equal(flat_t.numpy(), flat_j)
    _assert_tree_close(lay.unravel(flat_t), p_np, rtol=0, atol=0)
    row_j = jgossip.FlatLayout.build(pj, mask_j).unravel_row(
        jnp.asarray(flat_j[2]))
    _assert_tree_close(lay.unravel_row(flat_t[2]), _np_tree(row_j), rtol=0,
                       atol=0)
    u, v = tpartition.split(pt, mask_t)
    assert set(v) == {"classifier"} and "classifier" not in u
    assert tpartition.count_params(pt, mask_t, shared=True) == 4 * 13328


# ---------------------------------------------------------------------------
# SGD
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_update_matches_reference(nesterov):
    # elementwise f32; XLA:CPU may contract p - step*u into an FMA, so the
    # last ulp can differ: rtol 1e-6, atol 1e-7
    rng = np.random.default_rng(2)
    p = {"a": rng.standard_normal((3, 5)).astype(np.float32),
         "b": rng.standard_normal((4,)).astype(np.float32)}
    g = {"a": rng.standard_normal((3, 5)).astype(np.float32),
         "b": np.float32(0.25)}                     # scalar placeholder
    mo = {"a": rng.standard_normal((3, 5)).astype(np.float32),
          "b": rng.standard_normal((4,)).astype(np.float32)}
    jo = JSGD(lr=0.1, momentum=0.9, weight_decay=5e-4, nesterov=nesterov)
    to = TSGD(lr=0.1, momentum=0.9, weight_decay=5e-4, nesterov=nesterov)
    scale = 0.99 ** 3
    pj, sj = jo.update(jax.tree.map(jnp.asarray, g),
                       JSGDState(jax.tree.map(jnp.asarray, mo)),
                       jax.tree.map(jnp.asarray, p),
                       jnp.asarray(scale, jnp.float32))
    tt = lambda d: {k: torch.as_tensor(v) for k, v in d.items()}
    pt, st = to.update(tt(g), TSGDState(tt(mo)), tt(p),
                       torch.tensor(scale, dtype=torch.float32))
    _assert_tree_close(pt, _np_tree(pj), rtol=1e-6, atol=1e-7)
    _assert_tree_close(st.momentum, _np_tree(sj.momentum), rtol=1e-6,
                       atol=1e-7)
    # the scalar-grad leaf took no weight decay: momentum = 0.9*mo + g
    np.testing.assert_allclose(st.momentum["b"].numpy(),
                               0.9 * mo["b"] + np.float32(0.25), rtol=1e-6)


# ---------------------------------------------------------------------------
# topologies
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind,m", [("exponential", 16), ("ring", 7),
                                    ("full", 6)])
def test_deterministic_topology_tables_equal(kind, m):
    js = jtopology.get_schedule(kind, m)
    ts = ttopology.get_schedule(kind, m)
    for t in range(5):
        jt, tt = js.at(t), ts.at(t)
        np.testing.assert_array_equal(tt.idx.numpy(), np.asarray(jt.idx))
        np.testing.assert_array_equal(tt.w.numpy(), np.asarray(jt.w))
        np.testing.assert_array_equal(tt.dense().numpy(),
                                      np.asarray(jt.dense()))


def test_random_topology_is_row_stochastic_and_deterministic():
    s = ttopology.get_schedule("random", 20, 5, seed=3)
    a, b = s.at(4), s.at(4)
    assert torch.equal(a.idx, b.idx) and a.idx.shape == (20, 6)
    assert not torch.equal(a.idx, s.at(5).idx)
    rows = torch.arange(20)
    assert torch.equal(a.idx[:, 0], rows.to(torch.int32))
    assert all(len(set(r.tolist())) == 6 for r in a.idx)   # no repeats
    np.testing.assert_allclose(a.dense().sum(1).numpy(), 1.0, rtol=1e-6)
    # the undirected kind builds too: k = min(3n, m - 1) + 1
    assert ttopology.get_schedule("undirected", 8, 2).at(0).idx.shape == (
        8, 7)
    with pytest.raises(ValueError, match="MAX_DENSE_M"):
        ttopology.get_schedule("full", ttopology.MAX_DENSE_M + 1)


# ---------------------------------------------------------------------------
# the gossip mix
# ---------------------------------------------------------------------------
def test_mix_flat_matches_reference_sparse_mode():
    # main-path shape.  XLA may contract the reference mix_rows' multiply-
    # add into an FMA while the port rounds the product first, which moves
    # results by up to a few 1e-7 at this shape: equality is not
    # guaranteed, so rtol 1e-6, atol 1e-6
    m, d = 100, 13328
    P = jtopology.get_schedule("random", m, 10, seed=0).at(0)
    rng = np.random.default_rng(3)
    flat = rng.standard_normal((m, d)).astype(np.float32)
    mu = (1.0 + 0.3 * rng.random(m)).astype(np.float32)
    fj, mj = jgossip.mix_flat(P, jnp.asarray(flat), jnp.asarray(mu),
                              mode="sparse")
    Pt = ttopology.SparseTopology(torch.as_tensor(np.asarray(P.idx)),
                                  torch.as_tensor(np.asarray(P.w)))
    ft, mt = tgossip.mix_flat(Pt, torch.as_tensor(flat), torch.as_tensor(mu))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-6,
                               atol=1e-6)
    # the CPU buffer goes through the plain gossip_gather, which equals
    # the port's own mix_rows bit for bit in f32
    assert torch.equal(ft, tgossip.mix_rows(Pt.idx, Pt.w,
                                            torch.as_tensor(flat)))


def test_mix_flat_dense_and_no_sparsity_paths():
    # the dense contraction sums in BLAS order: rtol/atol 1e-5
    m, d = 6, 40
    rng = np.random.default_rng(4)
    flat = torch.as_tensor(rng.standard_normal((m, d)).astype(np.float32))
    mu = torch.ones(m)
    P = ttopology.fully_connected(m)                 # k == m: densifies
    assert tgossip.no_sparsity(P)
    got, mu2 = tgossip.mix_flat(P, flat, mu)
    want = flat.mean(0, keepdim=True).expand(m, d)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(mu2.numpy(), 1.0, rtol=1e-6)
    Pr = ttopology.ring(m)
    dense, _ = tgossip.mix_flat(Pr, flat, mu, mode="dense")
    sparse, _ = tgossip.mix_flat(Pr, flat, mu, mode="sparse")
    np.testing.assert_allclose(dense.numpy(), sparse.numpy(), rtol=1e-5,
                               atol=1e-5)
    # "pallas" is the f32-accumulate gather: for an f32 payload it equals
    # "sparse" bit for bit; an unknown mode raises
    pallas, _ = tgossip.mix_flat(Pr, flat, mu, mode="pallas")
    assert torch.equal(pallas, sparse)
    with pytest.raises(ValueError, match="known"):
        tgossip.mix_flat(Pr, flat, mu, mode="matrix")
    # the async mailbox's edge gate: all ones is the plain mix bit for
    # bit; a dense P has no (m, k) edge identity and raises
    gated, gmu = tgossip.mix_flat(Pr, flat, mu, edge_gate=torch.ones(m, 2))
    _, smu = tgossip.mix_flat(Pr, flat, mu, mode="sparse")
    assert torch.equal(gated, sparse) and torch.equal(gmu, smu)
    with pytest.raises(ValueError, match="SparseTopology"):
        tgossip.mix_flat(Pr.dense(), flat, mu, edge_gate=torch.ones(m, 2))


# ---------------------------------------------------------------------------
# bf16 wire: each gossip mode keeps the reference mode's meaning
# ---------------------------------------------------------------------------
def _wire_inputs(m, d, seed=0):
    P = jtopology.get_schedule("random", m, 4, seed=1).at(seed)
    rng = np.random.default_rng(seed)
    flat = rng.standard_normal((m, d)).astype(np.float32)
    mu = (1.0 + 0.3 * rng.random(m)).astype(np.float32)
    Pt = ttopology.SparseTopology(torch.as_tensor(np.array(P.idx)),
                                  torch.as_tensor(np.array(P.w)))
    return P, Pt, flat, mu


@pytest.mark.parametrize("m,d", [(13, 517), (40, 1000)])
def test_bf16_wire_sparse_matches_reference_sparse(m, d):
    # "sparse" is mix_rows in the wire dtype: w cast to bf16, each product
    # and sum in bf16, on both sides.  Measured equal bit for bit, for the
    # flat buffer and the tree-form gossip_mix
    P, Pt, flat, mu = _wire_inputs(m, d)
    fj, mj = jgossip.mix_flat(P, jnp.asarray(flat), jnp.asarray(mu),
                              mode="sparse", wire_dtype=jnp.bfloat16)
    ft, mt = tgossip.mix_flat(Pt, torch.as_tensor(flat), torch.as_tensor(mu),
                              mode="sparse", wire_dtype=torch.bfloat16)
    assert ft.dtype == torch.float32
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    params = {"a": flat[:, :d // 2].copy(), "b": flat[:, d // 2:].copy()}
    mask = {"a": True, "b": True}
    pj, _ = jgossip.gossip_mix(jax.tree.map(jnp.asarray, params),
                               jnp.asarray(mu), P, mask, mode="sparse",
                               wire_dtype=jnp.bfloat16)
    pt, _ = tgossip.gossip_mix({k: torch.as_tensor(v) for k, v in
                                params.items()}, torch.as_tensor(mu), Pt,
                               mask, mode="sparse", wire_dtype=torch.bfloat16)
    for k in params:
        np.testing.assert_array_equal(pt[k].numpy(), np.asarray(pj[k]))


def test_bf16_wire_pallas_matches_reference_pallas():
    # "pallas" accumulates the bf16 payload in f32 and rounds once, on
    # both sides (the reference's kernel in interpret mode).  They sum in
    # other orders, so an ulp-level f32 difference can flip the bf16
    # rounding: one bf16 ulp, rtol/atol 8e-3 (measured max 3.9e-3)
    P, Pt, flat, mu = _wire_inputs(13, 517)
    fj, mj = jgossip.mix_flat(P, jnp.asarray(flat), jnp.asarray(mu),
                              mode="pallas", wire_dtype=jnp.bfloat16)
    ft, mt = tgossip.mix_flat(Pt, torch.as_tensor(flat), torch.as_tensor(mu),
                              mode="pallas", wire_dtype=torch.bfloat16)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=8e-3,
                               atol=8e-3)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    # the port's "pallas" is the plain gossip_gather on a CPU buffer, and
    # it is not the port's "sparse" (which rounds in bf16 at every step)
    wire = torch.as_tensor(flat).to(torch.bfloat16)
    assert torch.equal(ft, tref.gossip_gather_ref(Pt.idx, Pt.w, wire).float())
    sparse, _ = tgossip.mix_flat(Pt, torch.as_tensor(flat),
                                 torch.as_tensor(mu), mode="sparse",
                                 wire_dtype=torch.bfloat16)
    assert not torch.equal(ft, sparse)


def test_mix_tree_matches_reference():
    # every leaf through mix_rows (sparse P) or the dense einsum: the
    # neighbor sum in j order on both sides, rtol/atol 1e-6
    P, Pt, flat, _ = _wire_inputs(13, 40)
    params = {"a": flat[:, :10].reshape(13, 2, 5).copy(),
              "b": {"c": flat[:, 10:].copy()}}
    tparams = tree.tree_map(torch.as_tensor, params)
    for jp, tp in ((P, Pt), (P.dense(), Pt.dense())):
        want = jgossip.mix_tree(jp, jax.tree.map(jnp.asarray, params))
        got = tgossip.mix_tree(tp, tparams)
        for path, leaf in tree.paths(got):
            np.testing.assert_allclose(
                leaf.numpy(), np.asarray(tree.get(want, path)), rtol=1e-6,
                atol=1e-6)
