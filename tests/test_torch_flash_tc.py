"""The arithmetic of the bf16 route of the port's `flash_attention` kernel
(csrc/flash_attention.cu, flash_attention_wgmma_kernel) on the CPU.

The kernel runs only on a GPU.  Here its tile arithmetic is emulated in
torch, step for step: the g query heads of a KV head folded into 128-row
tiles (126 live rows at a group of 7, the 2 idle ones holding garbage),
tiles `tc_width(hd)` columns wide (hd 80 zero-padded to 128, the store
clipping the pad), k-tiles of 64 keys in the kernel's loop order, the
online softmax in the log2 domain, P split into P_hi + P_lo in bf16 with
f32 accumulation, acc / max(l, 1e-30) rounded once to bf16.  The
emulation is held to the reference's oracle and its interpreted Pallas
kernel on bf16 inputs made with numpy from a seed; the wrapper's fold,
k-tile range, tile width, shared-memory budget and tile rule are checked
against brute force, and the f32 route's P V column split.
`chip_smoke.py` holds the kernel itself against the plain version on the
card."""
import functools
import importlib.util
import math
from pathlib import Path

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
    width = fa.tc_width(hd)
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
                    # TMA zero-fills rows and columns past the tensor; the
                    # idle rows past hb * P hold whatever shared memory
                    # held: NaN here, which must not reach a live row
                    Q = torch.zeros(rows, width)
                    Q[r >= hb * P] = float("nan")
                    Q[live, :hd] = qf[b, pos[live], hk * g + head[live]]
                    m = torch.full((rows,), NEG)
                    l = torch.zeros(rows)
                    O = torch.zeros(rows, width)
                    kt0, n_kt = fa.k_tile_range(q0, P, S, window)
                    for kt in range(kt0, kt0 + n_kt):
                        kp = kt * bk + torch.arange(bk)
                        kin = kp < S
                        K = torch.zeros(bk, width)
                        V = torch.zeros(bk, width)
                        K[kin, :hd] = kf[b, kp[kin], hk]
                        V[kin, :hd] = vf[b, kp[kin], hk]
                        ok = kin[None, :] & (kp[None, :] <= pos[:, None])
                        if window > 0:
                            ok &= kp[None, :] > pos[:, None] - window
                        # Q K^T's k-steps run over the real hd only
                        s = torch.where(ok, (Q[:, :hd] @ K[:, :hd].T) * sl2,
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
                    # the pad's columns are P times zeros; the store clips
                    # them and stores live rows only
                    assert not res[:, hd:][r < hb * P].any()
                    out[b, pos[live], hk * g + head[live]] = res[live, :hd]
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


# (g, Hkv): MHA, GQA 4:1 on two KV heads, the hybrid model's MQA 16:1,
# qwen2-0.5b's 7:1 (hb 7, P 18: 126 live rows of 128, and P no divisor of
# the 64-key tile)
GROUPS = [(1, 2), (4, 2), (16, 1), (7, 2)]


@pytest.mark.parametrize("hd", [64, 80, 256])
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
                                   (200, 1), (256, 2), (14, 2), (32, 8),
                                   (32, 32)])
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
                                        (1000, 64, 1), (2048, 0, 18),
                                        (1000, 300, 18), (1500, 700, 32)])
def test_k_tile_range_is_the_union_of_the_rows_bands(S, window, P):
    bk = fa.TC_TILES[0][1]
    for q0 in range(0, S, P):
        kt0, n = fa.k_tile_range(q0, P, S, window)
        need = set()
        for pos in range(q0, min(q0 + P, S)):
            lo = max(0, pos - window + 1) if window else 0
            need |= {kp // bk for kp in range(lo, pos + 1)}
        assert set(range(kt0, kt0 + n)) == need


def test_group_of_seven_tiles_straddle_key_tiles():
    # P 18 does not divide the 64-key tile: some q-tiles' bands end in the
    # middle of a k-tile and the next q-tile starts in that same k-tile
    hb, chunks, P = fa.fold(14, 2)
    assert (hb, chunks, P) == (7, 1, 18) and hb * P == 126
    bk = fa.TC_TILES[0][1]
    ends = [(q0 + P - 1) // bk for q0 in range(0, 2048, P)]
    starts = [q0 // bk for q0 in range(0, 2048, P)]
    assert any(s != e for s, e in zip(starts, ends))
    assert any(a == b for a, b in zip(ends, starts[1:]))


def test_tile_width_pads_hd_to_whole_boxes():
    assert {hd: fa.tc_width(hd) for hd in fa.HEAD_DIMS} == \
        {32: 32, 64: 64, 80: 128, 128: 128, 256: 256}


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_shared_memory_budget(hd):
    (bq, bk), = fa.TC_TILES
    got = fa.smem_bytes(torch.bfloat16, hd, bq, bk)
    w = fa.tc_width(hd)
    # 1 KB alignment slack, Q, 2 stages of K and V (all tc_width wide),
    # the mbarriers
    assert got == 1024 + bq * w * 2 + 2 * fa.TC_STAGES * bk * w * 2 + 128
    assert got <= fa.MAX_SMEM
    # hd 80's tiles take as much room as hd 128's
    if hd == 80:
        assert got == fa.smem_bytes(torch.bfloat16, 128, bq, bk) == 99_456
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


def test_tile_flops_at_danube_shape():
    # hd 80: Q K^T over the 80 real columns, both P V products over the
    # 128-wide tile (the pad's columns are P times zeros)
    B, S, H, Hkv, hd, win = 1, 8192, 32, 8, 80, 4096
    (rows, bk), = fa.TC_TILES
    visits = fa.tc_visits(B, S, H, Hkv, win)
    got = fa.tc_tile_flops(B, S, H, Hkv, hd, win)
    assert got == 2 * rows * bk * (80 + 2 * 128) * visits
    pos = np.arange(S)
    pairs = int(((pos[None, :] <= pos[:, None])
                 & (pos[None, :] > pos[:, None] - win)).sum())
    assert got >= 1.5 * 4 * hd * pairs * B * H


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_f32_route_column_split_covers_hd_once(hd):
    # csrc/flash_attention.cu, flash_attention_kernel: thread tx of 16
    # owns columns 2 tx + 32 cc (+1) of P V for cc < NJ, in the last group
    # (TAIL columns wide) only while 2 tx < TAIL
    NJ = (hd + 31) // 32
    TAIL = hd - 32 * (NJ - 1)
    cols = [2 * tx + 32 * cc + e for tx in range(16) for cc in range(NJ)
            if TAIL == 32 or cc < NJ - 1 or 2 * tx < TAIL for e in (0, 1)]
    assert sorted(cols) == list(range(hd))
    assert fa.smem_bytes(torch.float32, hd, fa.DEFAULT_BQ,
                         fa.DEFAULT_BK) <= fa.MAX_SMEM


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


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    """chip_smoke.py as a module (it imports torch only where it runs)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,Hkv,hd,window,rows", [
    (2, 300, 14, 2, 64, 0, 64), (1, 333, 8, 2, 80, 100, 128),
    (2, 77, 7, 1, 80, 13, 16), (1, 256, 4, 4, 32, 256, 50),
    (1, 1, 2, 1, 32, 0, 8)])
def test_plain_chunked_matches_the_plain_version(B, S, H, Hkv, hd, window,
                                                 rows, dtype):
    # chip_smoke.py holds the kernel at qwen2-0.5b's S 32,768 against
    # flash_plain_chunked, since the full score matrix does not fit the
    # card there; it must compute flash_attention_ref's function, rows
    # not dividing S and windows reaching back past a block included
    cs = _chip_smoke()
    rng = np.random.default_rng(S + hd)
    q, k, v = (torch.as_tensor(rng.standard_normal((B, S, h, hd)),
                               dtype=torch.float32).to(dtype)
               for h in (H, Hkv, Hkv))
    got = cs.flash_plain_chunked(torch, q, k, v, window=window, rows=rows)
    want = ops.flash_attention(q, k, v, window=window)
    tol = 2e-5 if dtype == torch.float32 else TOL
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("g,Hkv,hd", [(7, 2, 64), (4, 2, 80)])
def test_block_rel_l2_bound_parts_rounding_from_a_dropped_key_tile(g, Hkv,
                                                                   hd):
    # chip_smoke.py's bf16 bound on the worst 128-row block's relative L2
    # error: the kernel's arithmetic (the emulation) stays far under it,
    # a band that lost its oldest key tile (window short by bk) far over
    cs = _chip_smoke()
    S, window, bk = 512, 256, fa.TC_TILES[0][1]
    rng = np.random.default_rng(g * hd)
    q, k, v = (torch.as_tensor(rng.standard_normal((1, S, h, hd)),
                               dtype=torch.bfloat16)
               for h in (g * Hkv, Hkv, Hkv))
    want = ops.flash_attention(q, k, v, window=window)
    kernel = cs.block_rel_l2(torch, emulate(q, k, v, window=window), want)
    dropped = cs.block_rel_l2(
        torch, ops.flash_attention(q, k, v, window=window - bk), want)
    assert kernel < cs.FLASH_REL_L2_BF16 / 5
    assert dropped > cs.FLASH_REL_L2_BF16 * 5
