"""Port parity of compressed directed gossip: the wire codecs, error
feedback and reference tracking, the `topk_gather` plain version, the
codec branch of `mix_flat`, the codec rounds of DFedPGP and the
simulator's wire meter, each held against the JAX reference on the same
numpy inputs (and the reference's `jax.random` draws where a codec draws).

The CUDA `topk_gather` kernel runs only on a GPU; `chip_smoke.py` holds it
against `kernels.ref.topk_gather_ref` on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compress as jcompress
from repro.compress import feedback as jfeedback
from repro.core import gossip as jgossip
from repro.core import partition as jpartition
from repro.core import topology as jtopology
from repro.data import make_dataset as jmake_dataset
from repro.data import sample_batches as jsample_batches
from repro.fl import simulator as jsim
from repro.kernels import ref as jref
from repro.kernels.topk_gather import topk_gather_pallas
from repro.models import cnn as jcnn
from repro_torch import compress as tcompress
from repro_torch import convert, tree
from repro_torch.compress import feedback as tfeedback
from repro_torch.core import dfedpgp as tdfedpgp
from repro_torch.core import gossip as tgossip
from repro_torch.core import partition as tpartition
from repro_torch.core import topology as ttopology
from repro_torch.core.topology import SparseTopology
from repro_torch.fl import simulator as tsim
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.topk_gather import topk_gather_cuda
from repro_torch.models import cnn as tcnn
from repro_torch.obs import gauges as tgauges
from repro_torch.optim import SGD as TSGD
from repro_torch.optim import SGDState as TSGDState

torch.set_num_threads(2)
CODECS = {"identity": dict(kind="identity"), "topk": dict(kind="topk"),
          "randk": dict(kind="randk"), "qsgd4": dict(kind="qsgd", bits=4),
          "qsgd8": dict(kind="qsgd", bits=8)}


def _codecs(name, ratio=0.25):
    kw = dict(CODECS[name])
    kind = kw.pop("kind")
    return (jcompress.make_codec(kind, ratio=ratio, **kw),
            tcompress.make_codec(kind, ratio=ratio, **kw))


def _rows(m, d, seed):
    # continuous draws: no ties in |x|, so top-K picks one set
    return np.random.default_rng(seed).standard_normal((m, d)).astype(
        np.float32)


def _draws(name, key, m, d, K):
    """The reference codec's own jax.random draws for `key`, as the port's
    explicit draw tensor (codecs.py:167-174, :212)."""
    if name == "randk":
        cols = jax.vmap(lambda kk: jax.random.permutation(kk, d)[:K])(
            jax.random.split(key, m))
        return torch.as_tensor(np.array(cols))
    if name.startswith("qsgd"):
        return torch.as_tensor(np.array(jax.random.uniform(key, (m, d))))
    return None


def _eq(t, j, what=""):
    """Bitwise: same values (as f32 or int64) and shape."""
    a = t.detach()
    a = a.to(torch.float32) if a.is_floating_point() else a.to(torch.int64)
    b = np.asarray(j)
    b = b.astype(np.float32) if np.issubdtype(b.dtype, np.floating) \
        else b.astype(np.int64)
    np.testing.assert_array_equal(a.numpy(), b, err_msg=what)


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(CODECS))
def test_codec_encode_decode_residual_match_reference(name):
    # every codec is elementwise arithmetic in the reference's order, a
    # top-K over tie-free |x|, or the reference's own draws: bitwise
    m, d = 6, 37
    jc, tc = _codecs(name)
    x = _rows(m, d, 1)
    key = jax.random.PRNGKey(5)
    jp = jc.encode(jnp.asarray(x), key)
    tkey = _draws(name, key, m, d, getattr(tc, "k_of", lambda _: 0)(d))
    tp = tc.encode(torch.as_tensor(x), tkey)
    for field in ("values", "indices", "scale"):
        jv, tv = getattr(jp, field), getattr(tp, field)
        assert (jv is None) == (tv is None), field
        if jv is not None:
            _eq(tv, jv, field)
            assert str(tv.dtype).split(".")[-1] == str(jv.dtype), field
    _eq(tc.decode(tp, d), jc.decode(jp, d), "decode")
    _eq(tc.residual(torch.as_tensor(x), tp), jc.residual(jnp.asarray(x), jp),
        "residual")
    for dd in (1, 37, 13328, 65535, 65536, 70001):
        assert tc.row_bytes(dd) == jc.row_bytes(dd)
    assert tc.exact == jc.exact
    if name.startswith("qsgd"):
        # deterministic nearest rounding without a key
        jq, tq = jc.encode(jnp.asarray(x)), tc.encode(torch.as_tensor(x))
        _eq(tq.values, jq.values, "qsgd key=None")
        _eq(tc.decode(tq, d), jc.decode(jq, d), "qsgd key=None decode")


@pytest.mark.parametrize("name", ["topk", "qsgd4", "qsgd8", "randk"])
def test_codec_zero_row_and_index_boundary(name):
    # a zero row: every |x| ties at 0, so top-K may keep other columns than
    # the reference, but decode and residual are zero on both sides
    m, d = 3, 20
    jc, tc = _codecs(name)
    x = _rows(m, d, 2)
    x[1] = 0.0
    key = jax.random.PRNGKey(1)
    jp = jc.encode(jnp.asarray(x), key)
    tp = tc.encode(torch.as_tensor(x), _draws(name, key, m, d,
                                              getattr(tc, "k_of",
                                                      lambda _: 0)(d)))
    _eq(tc.decode(tp, d), jc.decode(jp, d), "decode")
    _eq(tc.residual(torch.as_tensor(x), tp),
        jc.residual(jnp.asarray(x), jp), "residual")
    assert not tc.decode(tp, d)[1].any()
    # uint16 ids up to d = 65535, int32 beyond
    for dd in (65535, 65536):
        assert str(tcompress.index_dtype(dd)).split(".")[-1] == \
            jnp.dtype(jcompress.index_dtype(dd)).name
    if name == "topk":
        rng = np.random.default_rng(3)
        for dd in (65535, 65536):
            # distinct integers (exact in f32) with random signs: tie-free
            row = (rng.permutation(dd) + 1.0) * rng.choice([-1.0, 1.0], dd)
            row = row.astype(np.float32)[None]
            jp = jc.encode(jnp.asarray(row))
            tp = tc.encode(torch.as_tensor(row))
            assert tp.indices.dtype == tcompress.index_dtype(dd)
            _eq(tp.indices, jp.indices, f"indices d={dd}")
            _eq(tp.values, jp.values, f"values d={dd}")


def test_get_codec_and_codec_errors_match_reference():
    assert tcompress.get_codec(None) is None and jcompress.get_codec(
        None) is None
    assert tcompress.KINDS == jcompress.KINDS
    for kind in tcompress.KINDS:
        tc = tcompress.get_codec(kind, ratio=0.125, bits=8, seed=4)
        jc = jcompress.get_codec(kind, ratio=0.125, bits=8, seed=4)
        assert type(tc).__name__ == type(jc).__name__ and tc.seed == 4
        assert tc.row_bytes(1000) == jc.row_bytes(1000)
    cases = [lambda c: c.get_codec("zstd"), lambda c: c.make_codec(None),
             lambda c: c.make_codec("topk", ratio=0.0),
             lambda c: c.make_codec("randk", ratio=1.5),
             lambda c: c.make_codec("qsgd", bits=3)]
    for case in cases:
        with pytest.raises(ValueError) as je:
            case(jcompress)
        with pytest.raises(ValueError) as te:
            case(tcompress)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="randk sampling needs a"):
        tcompress.make_codec("randk").encode(torch.ones(2, 8))
    with pytest.raises(ValueError, match="draws of shape"):
        tcompress.make_codec("qsgd").encode(torch.ones(2, 8),
                                            torch.zeros(2, 7))


# ---------------------------------------------------------------------------
# error feedback and reference tracking
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["identity", "topk", "qsgd4", "randk"])
@pytest.mark.parametrize("with_frac", [False, True])
def test_publish_and_encode_with_feedback_match_reference(name, with_frac):
    # elementwise f32 arithmetic in the reference's order: bitwise
    m, d = 5, 24
    jc, tc = _codecs(name)
    rows, ref0 = _rows(m, d, 4), _rows(m, d, 5)
    ef0 = 0.1 * _rows(m, d, 6)
    wf = np.linspace(0.3, 1.2, m).astype(np.float32) if with_frac else None
    key = jax.random.PRNGKey(9)
    tkey = _draws(name, key, m, d, getattr(tc, "k_of", lambda _: 0)(d))
    J = {k: None if v is None else jnp.asarray(v)
         for k, v in dict(rows=rows, ef=ef0, ref=ref0, wf=wf).items()}
    T = {k: None if v is None else torch.as_tensor(v)
         for k, v in dict(rows=rows, ef=ef0, ref=ref0, wf=wf).items()}
    jp, jef, jrf = jfeedback.publish(jc, J["ef"], J["ref"], J["rows"], key,
                                     wire_frac=J["wf"])
    tp, tef, trf = tfeedback.publish(tc, T["ef"], T["ref"], T["rows"], tkey,
                                     wire_frac=T["wf"])
    _eq(tp.values, jp.values, "publish values")
    _eq(tef, jef, "publish ef")
    _eq(trf, jrf, "publish ref")
    jp, jef = jfeedback.encode_with_feedback(jc, J["ef"], J["rows"], key,
                                             wire_frac=J["wf"])
    tp, tef = tfeedback.encode_with_feedback(tc, T["ef"], T["rows"], tkey,
                                             wire_frac=T["wf"])
    _eq(tp.values, jp.values, "ef values")
    _eq(tef, jef, "ef residual")
    if not tc.exact:
        # value conservation of one encode: decode(p) + ef' == x
        got = tc.decode(tp, d) + tef if not with_frac else None
        if got is not None:
            np.testing.assert_allclose(got.numpy(), rows + ef0, rtol=1e-6,
                                       atol=1e-6)
        with pytest.raises(ValueError, match="init_ef"):
            tfeedback.publish(tc, None, T["ref"], T["rows"], tkey)


def test_init_memory_is_fresh_and_never_aliases_flat():
    flat = torch.as_tensor(_rows(4, 6, 7))
    for name in ("identity", "topk"):
        jc, tc = _codecs(name)
        for fn, jfn in ((tfeedback.init_ef, jfeedback.init_ef),
                        (tfeedback.init_ref, jfeedback.init_ref)):
            t, j = fn(tc, flat), jfn(jc, jnp.asarray(flat.numpy()))
            assert (t is None) == (j is None)
            if t is not None:
                _eq(t, j)
                assert t.dtype == torch.float32
    ref = tfeedback.init_ref(_codecs("topk")[1], flat)
    assert ref.data_ptr() != flat.data_ptr()
    before = ref.clone()
    flat.mul_(3.0)                       # the sampled round writes in place
    assert torch.equal(ref, before)
    assert tfeedback.init_ef(None, flat) is None


# ---------------------------------------------------------------------------
# topk_gather: plain version against the reference's oracle and kernel
# ---------------------------------------------------------------------------
def _payload_inputs(m, k, d, K, seed, cols_dtype=None, dup=False,
                    oob=False):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, m, size=(m, k)).astype(np.int32)
    if k > 1:
        idx[:, 1] = idx[:, 0]                # repeated neighbor ids
    w = rng.random((m, k)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    vals = rng.standard_normal((m, K)).astype(np.float32)
    cols = np.stack([rng.permutation(d)[:K] for _ in range(m)])
    if dup and K > 1:
        cols[:, -1] = cols[:, 0]             # a duplicate column per row
    if oob:
        cols[:, 0] = d + 3                   # dropped
    dt = cols_dtype or (np.uint16 if d <= 0xFFFF else np.int32)
    return idx, w, vals, cols.astype(dt)


def _tt(a):
    a = np.asarray(a)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.astype(np.int32)).to(torch.uint16)
    return torch.from_numpy(np.array(a))


# the reference's sweep (tests/test_compress.py:165-167) plus int32 ids,
# duplicates and dropped columns
@pytest.mark.parametrize("m,k,d,K,extra", [
    (5, 2, 64, 3, {}), (33, 4, 1100, 17, {}), (8, 1, 512, 1, {}),
    (17, 3, 129, 129, {}), (16, 4, 700, 44, {}),
    (9, 3, 260, 20, dict(cols_dtype=np.int32)),
    (9, 3, 260, 20, dict(dup=True)), (9, 3, 260, 20, dict(oob=True))])
def test_topk_gather_ref_matches_reference(m, k, d, K, extra):
    # the reference sums neighbors in an einsum, the port in j order with
    # rounded products: rtol/atol 2e-5 (the reference's kernel tolerance)
    idx, w, vals, cols = _payload_inputs(m, k, d, K, m * 7 + K, **extra)
    want = jref.topk_gather_ref(jnp.asarray(idx), jnp.asarray(w),
                                jnp.asarray(vals), jnp.asarray(cols), d)
    got = tref.topk_gather_ref(_tt(idx), _tt(w), _tt(vals), _tt(cols), d)
    assert got.shape == (m, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    # the ops dispatch on CPU tensors is the plain version, bit for bit
    assert torch.equal(ops.topk_gather(_tt(idx), _tt(w), _tt(vals),
                                       _tt(cols), d), got)


@pytest.mark.parametrize("m,k,d,K", [(5, 2, 64, 3), (17, 3, 129, 129)])
def test_topk_gather_ref_matches_reference_kernel_interpreted(m, k, d, K):
    idx, w, vals, cols = _payload_inputs(m, k, d, K, 11)
    want = topk_gather_pallas(jnp.asarray(idx), jnp.asarray(w),
                              jnp.asarray(vals), jnp.asarray(cols), d,
                              interpret=True)
    got = tref.topk_gather_ref(_tt(idx), _tt(w), _tt(vals), _tt(cols), d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_topk_gather_bf16_values_match_reference():
    # both decode bf16 exactly to f32, sum in f32 and round once to bf16:
    # one bf16 ulp, rtol/atol 8e-3
    idx, w, vals, cols = _payload_inputs(13, 3, 300, 25, 12)
    vb = jnp.asarray(vals).astype(jnp.bfloat16)
    want = jref.topk_gather_ref(jnp.asarray(idx), jnp.asarray(w), vb,
                                jnp.asarray(cols), 300)
    got = tref.topk_gather_ref(_tt(idx), _tt(w),
                               torch.as_tensor(vals).to(torch.bfloat16),
                               _tt(cols), 300)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=8e-3, atol=8e-3)


def test_topk_gather_dispatch_rules():
    idx, w, vals, cols = (_tt(a) for a in _payload_inputs(6, 2, 40, 5, 13))
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="force='cuda'"):
        ops.topk_gather(idx, w, vals, cols, 40, force="cuda")
    for force in ("auto", "ref"):
        with pytest.raises(ValueError, match="block_d"):
            ops.topk_gather(idx, w, vals, cols, 40, force=force,
                            block_d=1024)
    with pytest.raises(ValueError, match="force"):
        ops.topk_gather(idx, w, vals, cols, 40, force="pallas")
    with pytest.raises(ValueError, match="CUDA tensors"):
        topk_gather_cuda(idx, w, vals, cols, 40)
    assert torch.equal(ops.topk_gather(idx, w, vals, cols, 40, force="ref"),
                       tref.topk_gather_ref(idx, w, vals, cols, 40))
    assert ops.launch_counts() == before
    assert ops.KERNELS["topk_gather"] is topk_gather_cuda
    assert "topk_gather" in _build.SOURCES
    assert _build.artifact("topk_gather").name.startswith("topk_gather-")


# ---------------------------------------------------------------------------
# the codec branch of mix_flat
# ---------------------------------------------------------------------------
def _mix_inputs(m=9, n=2, d=260, seed=0):
    P = jtopology.directed_random(jax.random.PRNGKey(seed), m, n)
    rng = np.random.default_rng(seed)
    flat = rng.standard_normal((m, d)).astype(np.float32)
    ref0 = flat + 0.2 * rng.standard_normal((m, d)).astype(np.float32)
    ef0 = 0.05 * rng.standard_normal((m, d)).astype(np.float32)
    mu = (1.0 + 0.3 * rng.random(m)).astype(np.float32)
    return P, flat, mu, ef0, ref0


def _tP(P):
    return SparseTopology(torch.as_tensor(np.asarray(P.idx)),
                          torch.as_tensor(np.asarray(P.w)))


@pytest.mark.parametrize("mode", ["dense", "sparse", "pallas"])
@pytest.mark.parametrize("name,gamma", [("identity", 1.0), ("topk", 1.0),
                                        ("topk", 0.5), ("qsgd4", 1.0)])
def test_mix_flat_codec_matches_reference(mode, name, gamma):
    # publish is elementwise in the reference's order, so ef' and ref' are
    # bitwise.  The mixed rows sum neighbors in another order (einsum vs j
    # order; the reference's interpreted kernels under "pallas"): rtol/atol
    # 1e-6 for "dense"/"sparse", 1e-5 for "pallas"
    P, flat, mu, ef0, ref0 = _mix_inputs()
    m, d = flat.shape
    jc, tc = _codecs(name, ratio=0.1)
    key = jax.random.PRNGKey(2)
    tkey = _draws(name, key, m, d, getattr(tc, "k_of", lambda _: 0)(d))
    exact = tc.exact
    jP = P.dense() if mode == "dense" else P
    tP = _tP(P).dense() if mode == "dense" else _tP(P)
    jout = jgossip.mix_flat(
        jP, jnp.asarray(flat), jnp.asarray(mu), mode=mode, codec=jc,
        ef=None if exact else jnp.asarray(ef0),
        ref=None if exact else jnp.asarray(ref0), key=key,
        codec_gamma=gamma)
    tout = tgossip.mix_flat(
        tP, torch.as_tensor(flat), torch.as_tensor(mu), mode=mode, codec=tc,
        ef=None if exact else torch.as_tensor(ef0),
        ref=None if exact else torch.as_tensor(ref0), key=tkey,
        codec_gamma=gamma)
    tol = 1e-5 if mode == "pallas" else 1e-6
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]),
                               rtol=tol, atol=tol, err_msg="mixed")
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]),
                               rtol=1e-6, atol=1e-6, err_msg="mu")
    if exact:
        assert tout[2] is None and tout[3] is None
        plain = tgossip.mix_flat(tP, torch.as_tensor(flat),
                                 torch.as_tensor(mu), mode=mode)
        assert torch.equal(tout[0], plain[0]) and torch.equal(tout[1],
                                                              plain[1])
    else:
        _eq(tout[2], jout[2], "ef'")
        _eq(tout[3], jout[3], "ref'")


def test_mix_flat_codec_conserves_value_on_push_table():
    # the reference's column-stochastic push form of a random table: the
    # crossing moves value between the rows and the residual memory, it
    # never creates or destroys it.  f32 sums over m = 9 rows: rtol/atol
    # 2e-5 per column
    P, flat, mu, ef0, ref0 = _mix_inputs(seed=3)
    Pp = jtopology.to_push_sparse(P)
    tc = tcompress.make_codec("topk", ratio=0.1)
    for gamma in (1.0, 0.5):
        mixed, mu2, ef2, ref2 = tgossip.mix_flat(
            _tP(Pp), torch.as_tensor(flat), torch.as_tensor(mu),
            mode="sparse", codec=tc, ef=torch.as_tensor(ef0),
            ref=torch.as_tensor(ref0), codec_gamma=gamma)
        np.testing.assert_allclose((mixed.sum(0) + ef2.sum(0)).numpy(),
                                   (flat + ef0).sum(0), rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(float(mu2.sum()), float(mu.sum()),
                                   rtol=1e-6)


def test_mix_flat_codec_guards_match_reference():
    P, flat, mu, ef0, ref0 = _mix_inputs(m=6, d=16)

    def calls(lib, P, arr, bf16, lossy, exact):
        args = (P, arr(flat), arr(mu))
        return [lambda: lib.mix_flat(*args, codec=lossy, wire_dtype=bf16),
                lambda: lib.mix_flat(*args, codec_gamma=0.5),
                lambda: lib.mix_flat(*args, codec=exact, codec_gamma=0.5),
                lambda: lib.mix_flat(*args, codec=lossy, ef=arr(ef0),
                                     ref=arr(ref0), codec_gamma=1.5),
                lambda: lib.mix_flat(*args, codec=lossy, ref=arr(ref0))]

    (jc, tc), (ji, ti) = _codecs("topk"), _codecs("identity")
    for jcall, tcall in zip(
            calls(jgossip, P, jnp.asarray, jnp.bfloat16, jc, ji),
            calls(tgossip, _tP(P), torch.as_tensor, torch.bfloat16, tc, ti)):
        with pytest.raises(ValueError) as je:
            jcall()
        with pytest.raises(ValueError) as te:
            tcall()
        assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# codec rounds of DFedPGP
# ---------------------------------------------------------------------------
M = 8
SIM_KW = dict(m=M, rounds=3, n_neighbors=3, n_train=16, n_test=8, batch=8,
              k_local=2, k_personal=1)
CFG_J, CFG_T = jcnn.CNNConfig(), tcnn.CNNConfig()


def _split(b, kv):
    return {"v": {k: a[:, :kv] for k, a in b.items()},
            "u": {k: a[:, kv:] for k, a in b.items()}}


@pytest.fixture(scope="module")
def draws():
    """The reference run's data, stacked init, per-round batches and
    tables (repro/fl/simulator.py:289-303, :427-432)."""
    sim = jsim.SimConfig(**SIM_KW)
    k_data, k_init, k_run = jax.random.split(jax.random.PRNGKey(sim.seed), 3)
    data = jmake_dataset(k_data, sim.m, n_classes=sim.n_classes,
                         dist=sim.dist, alpha=sim.alpha, c=sim.c,
                         n_train=sim.n_train, n_test=sim.n_test,
                         size=sim.image_size, noise=sim.noise)
    stacked = jax.vmap(lambda k: jcnn.init_params(k, CFG_J))(
        jax.random.split(k_init, sim.m))
    sched = jtopology.get_schedule(sim.topology, sim.m, sim.n_neighbors,
                                   sim.seed)
    k_total = sim.k_local + sim.k_personal
    batches, tables = [], []
    for r in range(sim.rounds):
        _, k_batch, _ = jax.random.split(jax.random.fold_in(k_run, r), 3)
        batches.append(jax.tree.map(np.asarray, jsample_batches(
            k_batch, data, k_total, sim.batch)))
        P = sched.at(r)
        tables.append((np.asarray(P.idx), np.asarray(P.w)))
    return dict(data=data, stacked=stacked, batches=batches, tables=tables)


def _port_algo(**kw):
    sim = tsim.SimConfig(**SIM_KW)
    opt = TSGD(lr=sim.lr, momentum=sim.momentum,
               weight_decay=sim.weight_decay)
    mask = tpartition.build_mask(tcnn.init_params(torch.Generator(), CFG_T),
                                 tpartition.classifier_personal)
    return tdfedpgp.DFedPGP(loss_fn=lambda p, b: tcnn.loss_fn(p, b, CFG_T),
                            mask=mask, opt_u=opt, opt_v=opt,
                            k_v=sim.k_personal, k_u=sim.k_local,
                            lr_decay=sim.lr_decay, **kw)


def _port_rounds(algo, draws, rounds=3):
    tstacked = convert.params_from_reference(jax.tree.map(
        np.asarray, draws["stacked"]))
    state, layout = algo.init_flat(tstacked, device="cpu")
    for r in range(rounds):
        b = {k: torch.from_numpy(np.array(a))
             for k, a in draws["batches"][r].items()}
        idx, w = draws["tables"][r]
        state, _ = algo.round_fn_flat(
            state, SparseTopology(torch.from_numpy(np.array(idx)),
                                  torch.from_numpy(np.array(w))),
            _split(b, algo.k_v), layout)
    return state, layout


def _reference_rounds(draws, rounds=3, **sim_kw):
    sim = jsim.SimConfig(**SIM_KW, **sim_kw)
    mask = jpartition.build_mask(jcnn.init_params(jax.random.PRNGKey(0),
                                                  CFG_J),
                                 jpartition.classifier_personal)
    jalgo = jsim.build_algorithm(
        "dfedpgp", lambda p, b: jcnn.loss_fn(p, b, CFG_J), mask, sim)
    state, layout = jalgo.init_flat(draws["stacked"])
    step = jax.jit(lambda s, P, b: jalgo.round_fn_flat(s, P, b, layout))
    for r in range(rounds):
        idx, w = draws["tables"][r]
        state, _ = step(state, jtopology.SparseTopology(
            jnp.asarray(idx), jnp.asarray(w)), _split(jax.tree.map(
                jnp.asarray, draws["batches"][r]), sim.k_personal))
    return state


def test_round_fn_flat_identity_codec_is_the_codec_free_round(draws):
    plain, _ = _port_rounds(_port_algo(), draws)
    ident, _ = _port_rounds(_port_algo(
        codec=tcompress.make_codec("identity")), draws)
    assert ident.ef is None and ident.ref is None
    for a, b in ((plain.flat, ident.flat), (plain.mu, ident.mu),
                 (plain.opt_u.momentum, ident.opt_u.momentum)):
        assert torch.equal(a, b)


# The reference and the port differ by ~5e-7 in the local steps (conv and
# GroupNorm sum order, ROADMAP §3); top-K of the delta could let such a
# difference pick another entry near the K-th largest |x|, which would move
# one whole entry between ef and ref.  At these seeds no entry flips in 3
# rounds; the tolerance is that of the codec-free rounds (rtol 1e-4, atol
# 2e-5) on every buffer.
@pytest.mark.parametrize("gamma", [1.0, 0.5, "auto"])
def test_round_fn_flat_topk_codec_matches_reference(draws, gamma):
    codec_kw = dict(codec="topk", codec_ratio=1 / 16, codec_gamma=gamma)
    js = _reference_rounds(draws, **codec_kw)
    tc = tcompress.make_codec("topk", ratio=1 / 16, seed=0)
    ts, _ = _port_rounds(_port_algo(codec=tc, codec_gamma=gamma), draws)
    assert int(ts.round) == int(js.round) == 3
    for name in ("flat", "mu", "ef", "ref"):
        np.testing.assert_allclose(
            getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
            rtol=1e-4, atol=2e-5, err_msg=name)
    np.testing.assert_allclose(ts.opt_u.momentum.numpy(),
                               np.asarray(js.opt_u.momentum), rtol=1e-4,
                               atol=2e-5)


def _clone(s):
    def c(a):
        return None if a is None else a.clone()
    return tdfedpgp.FlatDFedPGPState(
        c(s.flat), tree.tree_map(c, s.personal), c(s.mu),
        TSGDState(c(s.opt_u.momentum)),
        TSGDState(tree.tree_map(c, s.opt_v.momentum)), c(s.round), c(s.ef),
        c(s.ref))


def test_sampled_codec_round_matches_full_and_freezes_dormant(draws):
    algo = _port_algo(codec=tcompress.make_codec("topk", ratio=1 / 16),
                      gossip="pallas")
    state, layout = _port_rounds(algo, draws, rounds=1)
    b = _split({k: torch.from_numpy(np.array(a))
                for k, a in draws["batches"][1].items()}, algo.k_v)
    idx, w = draws["tables"][1]
    P = SparseTopology(torch.from_numpy(np.array(idx)),
                       torch.from_numpy(np.array(w)))

    everyone = torch.arange(M, dtype=torch.int32)
    full, _ = algo.round_fn_flat(_clone(state), P, b, layout)
    samp, _ = algo.round_fn_sampled(
        _clone(state), ttopology.induced_subgraph(P, everyone), everyone, b,
        layout)
    for name in ("flat", "mu", "ef", "ref"):
        assert torch.equal(getattr(samp, name), getattr(full, name)), name
    # half the clients active: dormant rows of every buffer stay put, and
    # flat, opt_u, ef and ref are written in place
    active = torch.tensor([1, 2, 5, 6], dtype=torch.int32)
    dormant = torch.ones(M, dtype=torch.bool)
    dormant[active.long()] = False
    st0 = _clone(state)
    ptrs = [t.data_ptr() for t in (st0.flat, st0.opt_u.momentum, st0.ef,
                                   st0.ref)]
    keep = _clone(state)
    bs = {part: {k: a[active.long()] for k, a in bp.items()}
          for part, bp in b.items()}
    new, _ = algo.round_fn_sampled(
        st0, ttopology.induced_subgraph(P, active), active, bs, layout)
    assert [t.data_ptr() for t in (new.flat, new.opt_u.momentum, new.ef,
                                   new.ref)] == ptrs
    for name in ("flat", "ef", "ref", "mu"):
        assert torch.equal(getattr(new, name)[dormant],
                           getattr(keep, name)[dormant]), name
    for name in ("flat", "ef", "ref"):
        assert not torch.equal(getattr(new, name)[~dormant],
                               getattr(keep, name)[~dormant]), name
    assert torch.equal(new.opt_u.momentum[dormant],
                       keep.opt_u.momentum[dormant])


def test_sampled_codec_round_writes_back_in_one_call_like_reference(
        draws, monkeypatch):
    # one full codec round, then one sampled codec round (half the clients)
    # in both engines: the port writes flat, opt_u, ef and ref back through
    # ONE gossip_scatter_many call of 4 pairs (one kernel launch on a GPU),
    # the reference through 4 interpreted Pallas scatters.  Tolerance of
    # the codec-free rounds (rtol 1e-4, atol 2e-5) on every buffer
    codec_kw = dict(codec="topk", codec_ratio=1 / 16, gossip="pallas")
    sim = jsim.SimConfig(**SIM_KW, **codec_kw)
    mask = jpartition.build_mask(jcnn.init_params(jax.random.PRNGKey(0),
                                                  CFG_J),
                                 jpartition.classifier_personal)
    jalgo = jsim.build_algorithm(
        "dfedpgp", lambda p, b: jcnn.loss_fn(p, b, CFG_J), mask, sim)
    js, jlayout = jalgo.init_flat(draws["stacked"])
    active = np.array([1, 2, 5, 6], np.int32)
    jb = [_split(jax.tree.map(jnp.asarray, b), sim.k_personal)
          for b in draws["batches"][:2]]
    jP = [jtopology.SparseTopology(jnp.asarray(i), jnp.asarray(w))
          for i, w in draws["tables"][:2]]
    js, _ = jalgo.round_fn_flat(js, jP[0], jb[0], jlayout)
    js, _ = jax.jit(lambda s, P, a, b: jalgo.round_fn_sampled(
        s, P, a, b, jlayout))(
        js, jtopology.induced_subgraph(jP[1], jnp.asarray(active), "row"),
        jnp.asarray(active), jax.tree.map(lambda a: a[active], jb[1]))

    algo = _port_algo(codec=tcompress.make_codec("topk", ratio=1 / 16),
                      gossip="pallas")
    state, layout = _port_rounds(algo, draws, rounds=1)
    idx, w = draws["tables"][1]
    P = SparseTopology(torch.from_numpy(np.array(idx)),
                       torch.from_numpy(np.array(w)))
    b = _split({k: torch.from_numpy(np.array(a[active]))
                for k, a in draws["batches"][1].items()}, algo.k_v)
    calls = []

    def counted(rows, Xs, Us, *args, **kw):
        calls.append(len(Xs))
        return scatter_many(rows, Xs, Us, *args, **kw)

    scatter_many = ops.gossip_scatter_many
    monkeypatch.setattr(ops, "gossip_scatter_many", counted)
    monkeypatch.setattr(ops, "gossip_scatter", None)    # not on this path
    ta = torch.from_numpy(active)
    ts, _ = algo.round_fn_sampled(
        state, ttopology.induced_subgraph(P, ta), ta, b, layout)
    assert calls == [4]
    assert int(ts.round) == int(js.round) == 2
    for name in ("flat", "mu", "ef", "ref"):
        np.testing.assert_allclose(
            getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
            rtol=1e-4, atol=2e-5, err_msg=name)
    np.testing.assert_allclose(ts.opt_u.momentum.numpy(),
                               np.asarray(js.opt_u.momentum), rtol=1e-4,
                               atol=2e-5)


def test_sampled_codec_round_groups_the_write_back_by_dtype(draws,
                                                            monkeypatch):
    # bf16 params with a lossy codec: flat and momentum are bf16, ef and
    # ref f32, so the write-back is one gossip_scatter_many call per dtype
    # pair (one launch each on a GPU); dormant rows of all four stay put
    algo = _port_algo(codec=tcompress.make_codec("topk", ratio=1 / 16),
                      gossip="pallas")
    stacked = tree.tree_map(lambda a: a.to(torch.bfloat16),
                            convert.params_from_reference(jax.tree.map(
                                np.asarray, draws["stacked"])))
    state, layout = algo.init_flat(stacked, device="cpu")
    keep = _clone(state)
    active = torch.tensor([1, 2, 5, 6], dtype=torch.int32)
    idx, w = draws["tables"][0]
    P = SparseTopology(torch.from_numpy(np.array(idx)),
                       torch.from_numpy(np.array(w)))
    def bf16(a):
        t = torch.from_numpy(np.array(a))[active.long()]
        return t.to(torch.bfloat16) if t.is_floating_point() else t

    b = _split({k: bf16(a) for k, a in draws["batches"][0].items()},
               algo.k_v)
    calls = []

    def counted(rows, Xs, Us, *args, **kw):
        calls.append([(X.dtype, U.dtype) for X, U in zip(Xs, Us)])
        return scatter_many(rows, Xs, Us, *args, **kw)

    scatter_many = ops.gossip_scatter_many
    monkeypatch.setattr(ops, "gossip_scatter_many", counted)
    new, _ = algo.round_fn_sampled(
        state, ttopology.induced_subgraph(P, active), active, b, layout)
    bf, f32 = torch.bfloat16, torch.float32
    assert calls == [[(bf, bf), (bf, bf)], [(f32, f32), (f32, f32)]]
    dormant = torch.ones(M, dtype=torch.bool)
    dormant[active.long()] = False
    for name in ("flat", "ef", "ref"):
        assert torch.equal(getattr(new, name)[dormant],
                           getattr(keep, name)[dormant]), name
        assert not torch.equal(getattr(new, name)[~dormant],
                               getattr(keep, name)[~dormant]), name
    assert torch.equal(new.opt_u.momentum[dormant],
                       keep.opt_u.momentum[dormant])


def test_codec_knobs_raise_the_reference_errors():
    tc = tcompress.make_codec("topk")
    mask = tpartition.build_mask(tcnn.init_params(torch.Generator(), CFG_T),
                                 tpartition.classifier_personal)
    stacked = tcnn.init_params(torch.Generator().manual_seed(0), CFG_T, (4,))
    bad = [dict(codec=tc, codec_gamma="fast"),
           dict(codec_gamma="auto"), dict(codec_gamma=0.5),
           dict(codec=tc, codec_gamma=0.0),
           dict(codec=tc, gossip_dtype=torch.bfloat16),
           dict(codec=tc, mix_fn_flat=lambda *a: a[:2])]
    for kw in bad:
        algo = tdfedpgp.DFedPGP(loss_fn=print, mask=mask, **kw)
        with pytest.raises(ValueError):
            algo.init_flat(stacked, device="cpu")
    tree_state = _port_algo(codec=tc).init(stacked, device="cpu")
    with pytest.raises(ValueError, match="tree-form round_fn"):
        _port_algo(codec=tc).round_fn(tree_state, None, {})
    with pytest.raises(ValueError, match="only applies to lossy"):
        tsim.run_experiment("dfedpgp", tsim.SimConfig(m=4, codec_gamma=0.5),
                            device="cpu")
    # a codec on an algorithm without a flat engine (the reference's error)
    with pytest.raises(ValueError, match="flat engines"):
        tsim.run_experiment("dispfl", tsim.SimConfig(m=4, codec="topk"),
                            device="cpu")


# ---------------------------------------------------------------------------
# the simulator's history: vtime and the wire meter
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("codec", [None, "topk", "qsgd"])
def test_run_experiment_wire_bytes_and_vtime_match_reference(draws, codec):
    # host integer arithmetic on the same tables: exact
    sim_kw = dict(SIM_KW, rounds=2, codec=codec)
    jh = jsim.run_experiment("dfedpgp", jsim.SimConfig(**sim_kw),
                             eval_every=1)
    th = tsim.run_experiment("dfedpgp", tsim.SimConfig(**sim_kw),
                             device="cpu", eval_every=1,
                             topology_at=lambda r: draws["tables"][r])
    assert th["wire_bytes"] == jh["wire_bytes"] and len(th["wire_bytes"]) == 2
    assert th["vtime"] == jh["vtime"] == [3.0, 6.0]
    d = 13328                         # the CNN's shared width, d_flat
    edges = [tgauges.edge_count(SparseTopology(torch.as_tensor(i),
                                               torch.as_tensor(w)))
             for i, w in draws["tables"][:2]]
    assert edges == [M * 3] * 2
    c = tcompress.get_codec(codec)
    assert th["wire_bytes"][-1] == tgauges.bootstrap_bytes(c, M, d) + sum(
        edges) * tgauges.payload_row_bytes(c, d)


def test_convert_carries_codec_memory():
    flat = _rows(3, 5, 8)
    ef, ref = 0.1 * flat, flat + 1.0
    kw = dict(flat=flat, personal={}, mu=np.ones(3, np.float32), mom_u=flat,
              mom_v={}, round=np.int32(2))
    st = convert.flat_state_from_reference(ef=ef, ref=ref, **kw)
    _eq(st.ef, ef)
    _eq(st.ref, ref)
    plain = convert.flat_state_from_reference(**kw)
    assert plain.ef is None and plain.ref is None and int(plain.round) == 2
