"""The arithmetic of the bf16 route of the port's `flash_attention` kernel
(csrc/flash_attention.cu, flash_attention_wgmma_kernel) on the CPU.

The kernel runs only on a GPU.  Here its tile arithmetic is emulated in
torch, step for step: the g query heads of a KV head folded into 128-row
tiles, k-tiles of 64 keys in the kernel's loop order, the online softmax
in the log2 domain, P split into P_hi + P_lo in bf16 with f32
accumulation, acc / max(l, 1e-30) rounded once to bf16.  The emulation is
held to the reference's oracle and its interpreted Pallas kernel on bf16
inputs made with numpy from a seed; the wrapper's fold, k-tile range,
shared-memory budget and tile rule are checked against brute force.
`chip_smoke.py` holds the kernel itself against the plain version on the
card."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

torch.set_num_threads(2)
NEG = -1e30
LOG2E = 1.4426950408889634
TOL = 8e-3          # one bf16 ulp of the output, as chip_smoke.py's bf16 cases


def emulate(q, k, v, *, window=0, scale=None):
    """The bf16 route's arithmetic, tile by tile: q (B, S, H, hd), k and v
    (B, S, Hkv, hd) bf16 -> (B, S, H, hd) bf16."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    (rows, bk), = fa.TC_TILES
    hb, chunks, P = fa.fold(H, Hkv)
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    # the kernel takes scale as a C float and multiplies by log2(e) in f32
    sl2 = (torch.tensor(scale, dtype=torch.float32)
           * torch.tensor(LOG2E, dtype=torch.float32))
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.zeros_like(q)
    r = torch.arange(rows)
    for b in range(B):
        for hk in range(Hkv):
            for ch in range(chunks):
                for qt in range(-(-S // P)):
                    q0 = qt * P
                    pos = q0 + r // hb
                    head = ch * hb + r % hb
                    live = (r < hb * P) & (pos < S) & (head < g)
                    Q = torch.zeros(rows, hd)
                    Q[live] = qf[b, pos[live], hk * g + head[live]]
                    m = torch.full((rows,), NEG)
                    l = torch.zeros(rows)
                    O = torch.zeros(rows, hd)
                    kt0, n_kt = fa.k_tile_range(q0, P, S, window)
                    for kt in range(kt0, kt0 + n_kt):
                        kp = kt * bk + torch.arange(bk)
                        kin = kp < S
                        K = torch.zeros(bk, hd)
                        V = torch.zeros(bk, hd)
                        K[kin] = kf[b, kp[kin], hk]
                        V[kin] = vf[b, kp[kin], hk]
                        ok = kin[None, :] & (kp[None, :] <= pos[:, None])
                        if window > 0:
                            ok &= kp[None, :] > pos[:, None] - window
                        s = torch.where(ok, (Q @ K.T) * sl2,
                                        torch.tensor(NEG))
                        mn = torch.maximum(m, s.max(dim=1).values)
                        alpha = torch.exp2(m - mn)
                        p = torch.exp2(s - mn[:, None])
                        l = alpha * l + p.sum(dim=1)
                        m = mn
                        p_hi = p.bfloat16().float()
                        p_lo = (p - p_hi).bfloat16().float()
                        O = O * alpha[:, None] + p_hi @ V + p_lo @ V
                    res = (O / torch.clamp(l, min=1e-30)[:, None]).bfloat16()
                    out[b, pos[live], hk * g + head[live]] = res[live]
    return out


def _inputs(B, S, H, Hkv, hd, seed, q_scale=1.0, v_std=1.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd)) * q_scale
    k = rng.standard_normal((B, S, Hkv, hd))
    v = rng.standard_normal((B, S, Hkv, hd)) * v_std
    return [a.astype(np.float32) for a in (q, k, v)]


def _both(arrs):
    ts = [torch.as_tensor(a).to(torch.bfloat16) for a in arrs]
    js = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrs]
    return ts, js


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=TOL, atol=TOL)


# (g, Hkv): MHA, GQA 4:1 on two KV heads, the model's MQA 16:1
GROUPS = [(1, 2), (4, 2), (16, 1)]


@pytest.mark.parametrize("hd", [64, 256])
@pytest.mark.parametrize("g,Hkv", GROUPS)
@pytest.mark.parametrize("B,S,window", [(2, 150, 0), (1, 150, 37),
                                        (1, 96, 64)])
def test_emulation_matches_reference(hd, g, Hkv, B, S, window):
    # S 150 is no multiple of the 64-key tile nor of the folded tile's
    # positions; bf16 in and out on every side, f32 math: rtol/atol 8e-3
    arrs = _inputs(B, S, g * Hkv, Hkv, hd, seed=hd + 7 * g + S + window)
    (tq, tk, tv), (jq, jk, jv) = _both(arrs)
    got = emulate(tq, tk, tv, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    _close(got, jref.flash_attention_ref(jq, jk, jv, window=window))
    if S % 32 == 0:
        _close(got, flash_attention_pallas(jq, jk, jv, window=window,
                                           interpret=True, bq=32, bk=32))


@pytest.mark.parametrize("q_scale,v_std", [(8.0, 1.0), (4.0, 2.0)])
def test_emulation_concentrated_softmax(q_scale, v_std):
    # q scaled up concentrates each row's softmax on a few keys, where a P
    # rounded once to bf16 would use most of the tolerance; the split
    # keeps the error at the final rounding
    arrs = _inputs(1, 192, 16, 1, 256, seed=3, q_scale=q_scale, v_std=v_std)
    (tq, tk, tv), (jq, jk, jv) = _both(arrs)
    got = emulate(tq, tk, tv, window=100)
    want = jref.flash_attention_ref(jq, jk, jv, window=100)
    _close(got, want)
    _close(got, flash_attention_pallas(jq, jk, jv, window=100,
                                       interpret=True, bq=64, bk=64))


@pytest.mark.parametrize("H,Hkv", [(16, 1), (8, 2), (2, 2), (12, 1), (3, 1),
                                   (200, 1), (256, 2)])
def test_fold_covers_every_row_once(H, Hkv):
    # every (position, head) of a KV group lies in exactly one row of one
    # tile, and a tile holds at most 128 rows
    S = 300
    g = H // Hkv
    hb, chunks, P = fa.fold(H, Hkv)
    assert hb * P <= fa.TC_TILES[0][0] and hb * chunks >= g
    seen = {}
    for ch in range(chunks):
        for qt in range(-(-S // P)):
            for r in range(hb * P):
                pos, head = qt * P + r // hb, ch * hb + r % hb
                if pos < S and head < g:
                    seen[pos, head] = seen.get((pos, head), 0) + 1
    assert len(seen) == S * g and set(seen.values()) == {1}
    if g <= 128:
        assert chunks == 1 and P == 128 // g


@pytest.mark.parametrize("S,window,P", [(150, 0, 8), (150, 37, 8),
                                        (4096, 2048, 8), (300, 100, 128),
                                        (77, 13, 42), (1, 0, 8),
                                        (1000, 64, 1)])
def test_k_tile_range_is_the_union_of_the_rows_bands(S, window, P):
    bk = fa.TC_TILES[0][1]
    for q0 in range(0, S, P):
        kt0, n = fa.k_tile_range(q0, P, S, window)
        need = set()
        for pos in range(q0, min(q0 + P, S)):
            lo = max(0, pos - window + 1) if window else 0
            need |= {kp // bk for kp in range(lo, pos + 1)}
        assert set(range(kt0, kt0 + n)) == need


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_shared_memory_budget(hd):
    (bq, bk), = fa.TC_TILES
    got = fa.smem_bytes(torch.bfloat16, hd, bq, bk)
    # 1 KB alignment slack, Q, 2 stages of K and V, the mbarriers
    assert got == 1024 + bq * hd * 2 + 2 * fa.TC_STAGES * bk * hd * 2 + 128
    assert got <= fa.MAX_SMEM
    # at hd 256 a third stage would not fit: the ring has two
    if hd == 256:
        assert got == 197_760
        assert got + 2 * bk * hd * 2 > fa.MAX_SMEM
    # the f32 route's default tile fits too
    assert fa.smem_bytes(torch.float32, hd, fa.DEFAULT_BQ,
                         fa.DEFAULT_BK) <= fa.MAX_SMEM


def test_tile_flops_at_the_model_shape():
    # every visited (tile, k-tile) pair, three products each; at least
    # the band's 4 hd flops per pair times 1.5 for the split P
    B, S, H, Hkv, hd, win = 2, 4096, 16, 1, 256, 2048
    pos = np.arange(S)
    pairs = int(((pos[None, :] <= pos[:, None])
                 & (pos[None, :] > pos[:, None] - win)).sum())
    band = 4 * hd * pairs * B * H
    assert band == 206_191_984_640
    got = fa.tc_tile_flops(B, S, H, Hkv, hd, win)
    assert 1.5 * band <= got <= 1.6 * band


def test_bf16_route_tile_rule():
    # the bf16 kernel is built for one tile: other tiles raise and name
    # it; the f32 route keeps its multiples of 16 up to 64
    assert fa.tiles(torch.bfloat16, None, None) == fa.TC_TILES[0]
    assert fa.tiles(torch.bfloat16, 128, 64) == (128, 64)
    for bq, bk in ((64, 64), (32, 16), (128, 32), (None, 32)):
        with pytest.raises(ValueError, match=r"\(128, 64\)"):
            fa.tiles(torch.bfloat16, bq, bk)
    assert fa.tiles(torch.float32, None, None) == (fa.DEFAULT_BQ,
                                                  fa.DEFAULT_BK)
    assert fa.tiles(torch.float32, 32, 16) == (32, 16)
    with pytest.raises(ValueError, match="bq=128"):
        fa.tiles(torch.float32, 128, 64)
    # the knobs stay loud on the plain version
    q = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 1, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bq"):
        ops.flash_attention(q, k, k, bq=128)
