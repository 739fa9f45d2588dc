"""The redesigned serve and codec kernels' planning and arithmetic on the CPU.

`head_gather_matmul` (csrc/head_gather.cu) and `topk_gather`
(csrc/topk_gather.cu) run only on a GPU.  What surrounds them is pure
Python and is held here: the planning functions that pick their routes,
grids, rings and shared-memory budgets (`kernels.head_gather.plan`,
`kernels.topk_gather.plan`), and plain-torch emulations of each kernel's
arithmetic order, laid out as the plan lays it out, on seeded numpy inputs
against the JAX reference's Pallas kernels in interpret mode.
`chip_smoke.py` holds the kernels themselves against their plain versions
on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.head_gather import head_gather_matmul_pallas
from repro.kernels.topk_gather import topk_gather_pallas
from repro_torch.kernels import head_gather as hg
from repro_torch.kernels import ref as tref
from repro_torch.kernels import topk_gather as tg

torch.set_num_threads(2)
SMS = 132                        # an H100 SXM
SMEM = 232448                    # the opt-in shared memory of a block
SMEM_DEFAULT = 48 * 1024         # a block's shared memory without opt-in


def _fma_f32(a, b, c):
    """fmaf in float32: the f32 product is exact in f64, then one rounding
    of a*b + c to f32 (a double rounding only on a tie at f64's 53 bits)."""
    return (a.double() * b.double() + c.double()).float()


# ---------------------------------------------------------------------------
# head_gather_matmul: the plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("elem_bytes", [4, 2])
def test_head_plan_takes_the_warp_route_at_the_largest_serve_batch(
        elem_bytes):
    # m 100, d 64, n 10, B 1024: one warp per request, about one block per
    # SM (128 blocks of 8 warps on 132 SMs); 3 groups of 10 lanes
    p = hg.plan(1024, 64, 10, elem_bytes, SMS)
    assert (p.route, p.warps, p.blocks, p.tiles) == ("warp", 8, 128, 1)
    assert (p.block_n, p.groups) == (10, 3)
    # the slab's window (640 elements), H[r] budgeted as f32, the bias row
    w_slot = 64 * 10 * elem_bytes + 16
    assert p.slots == (w_slot, 256 + 16, -(-10 * elem_bytes // 16) * 16 + 16)
    assert p.smem == 8 * sum(p.slots) <= SMEM_DEFAULT
    if elem_bytes == 4:
        assert sum(p.slots) == 2912


@pytest.mark.parametrize("B", [1, 64, 2 * SMS])
def test_head_plan_takes_the_tiled_route_at_small_serve_batches(B):
    # up to 2 requests per SM a 256-thread block per request is faster:
    # 25 groups of 10 classes split the 64 features
    p = hg.plan(B, 64, 10, 4, SMS)
    assert (p.route, p.blocks, p.tiles, p.block_n, p.groups) == (
        "tiled", B, 1, 10, 25)
    assert hg.plan(2 * SMS + 1, 64, 10, 4, SMS).route == "warp"


@pytest.mark.parametrize("B", [1, 133, 1024])
@pytest.mark.parametrize("d", [0, 65, 600, 12288])
@pytest.mark.parametrize("n", [1, 10, 32, 33, 600])
@pytest.mark.parametrize("elem_bytes", [4, 2])
def test_head_plan_invariants(B, d, n, elem_bytes):
    p = hg.plan(B, d, n, elem_bytes, SMS)
    slots = (hg._window(d * n * elem_bytes), hg._window(4 * d),
             hg._window(n * elem_bytes))
    assert (p.route == "warp") == (n <= 32
                                   and sum(slots) <= hg.WARP_SMEM_MAX
                                   and B > hg.WARP_MIN_PER_SM * SMS)
    if p.route == "warp":
        assert p.slots == slots and all(s % 16 == 0 for s in slots)
        assert 1 <= p.warps <= hg.MAX_WARPS and p.groups == 32 // n
        # the blocks cover B requests, the last block at least partly
        assert p.blocks * p.warps >= B > (p.blocks - 1) * p.warps
        # one wave: no more blocks than SMs while a block has room
        if p.warps < hg.MAX_WARPS:
            assert p.blocks <= SMS
        assert p.smem == p.warps * sum(slots) <= SMEM_DEFAULT
    else:
        assert p.warps * 32 == hg.TILED_THREADS and p.blocks == B
        assert 1 <= p.block_n <= hg.MAX_BLOCK_N
        assert p.tiles == -(-n // p.block_n) and p.block_n < n + p.tiles
        assert p.groups == hg.TILED_THREADS // p.block_n
        assert p.groups * p.block_n <= hg.TILED_THREADS
        # H[r] as f32, reused for the groups' partial sums
        assert p.smem == 4 * max(d, hg.TILED_THREADS) <= SMEM_DEFAULT


@pytest.mark.parametrize("B,d,n,block_n,route", [
    (17, 64, 130, None, "tiled"), (999, 12288, 10, None, "tiled"),
    (300, 33, 32, None, "warp"), (300, 33, 33, None, "tiled"),
    (1024, 64, 10, 3, "tiled"), (1024, 64, 10, 256, "tiled"),
    (300, 1, 10, None, "warp"), (5, 1, 10, None, "tiled")])
def test_head_plan_routes(B, d, n, block_n, route):
    p = hg.plan(B, d, n, 4, SMS, block_n)
    assert p.route == route
    if block_n is not None:
        assert p.block_n == block_n


@pytest.mark.parametrize("B,d,n,block_n", [
    (64, 64, 10, 0), (64, 64, 10, 257), (64, 64, 10, -3),
    (4, 12289, 10, None), (4, 12289, 10, 16), (0, 64, 10, None),
    (4, 64, 0, None), (4, -1, 10, None)])
def test_head_plan_refuses(B, d, n, block_n):
    with pytest.raises(ValueError):
        hg.plan(B, d, n, 4, SMS, block_n)


# ---------------------------------------------------------------------------
# head_gather_matmul: the kernel's arithmetic
# ---------------------------------------------------------------------------
def emulate_head(uid, H, W, b, plan):
    """The kernel's order on either route: `groups` lanes / threads per
    class, group g an f32 FMA chain over t = g, g + groups, ...; the
    groups' sums added in group order, then the bias; f32 out."""
    u = uid.long()
    Hf = H.float()
    Wg = W[u].float()                                        # (B, d, n)
    d = H.shape[1]
    total = None
    for g in range(plan.groups):
        acc = torch.zeros((H.shape[0], W.shape[2]))
        for t in range(g, d, plan.groups):
            acc = _fma_f32(Hf[:, t, None], Wg[:, t, :], acc)
        total = acc if total is None else total + acc
    return total + b[u].float()


@pytest.mark.parametrize("B,d,n,m,block_n", [
    (9, 64, 10, 7, None), (16, 65, 7, 5, None), (8, 33, 32, 4, None),
    (12, 30, 40, 6, None), (10, 64, 10, 7, 3), (6, 70, 130, 3, None)])
@pytest.mark.parametrize("dtypes", ["f32/f32", "bf16/bf16", "bf16/f32",
                                    "f32/bf16"])
@pytest.mark.parametrize("sms", [SMS, 2])
def test_head_emulation_matches_reference_kernel(B, d, n, m, block_n,
                                                 dtypes, sms):
    # the kernel's group sums against the interpreted Pallas kernel's dot:
    # both accumulate in f32 in another order, rtol/atol 1e-5 (the card's
    # tolerance against the oracle)
    rng = np.random.default_rng(B * d + n)
    uid = rng.integers(0, m, size=B).astype(np.int32)
    uid[-1] = uid[0]
    H = rng.standard_normal((B, d)).astype(np.float32)
    W = rng.standard_normal((m, d, n)).astype(np.float32)
    b = rng.standard_normal((m, n)).astype(np.float32)
    hdt, wdt = ({"f32": torch.float32, "bf16": torch.bfloat16}[x]
                for x in dtypes.split("/"))
    jd = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    tH, tW, tb = (torch.as_tensor(a).to(t) for a, t in
                  ((H, hdt), (W, wdt), (b, wdt)))
    # the plan of an H100, and of a 2-SM card, on which these batches take
    # the warp route where n <= 32
    p = hg.plan(B, d, n, tW.element_size(), sms, block_n)
    assert p.route == ("warp" if sms == 2 and n <= 32 and block_n is None
                       else "tiled")
    got = emulate_head(torch.as_tensor(uid), tH, tW, tb, p)
    want = head_gather_matmul_pallas(
        jnp.asarray(uid), jnp.asarray(H).astype(jd[hdt]),
        jnp.asarray(W).astype(jd[wdt]), jnp.asarray(b).astype(jd[wdt]),
        interpret=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # and the port's own plain version (the card's oracle)
    np.testing.assert_allclose(
        got.numpy(), tref.head_gather_matmul_ref(
            torch.as_tensor(uid), tH, tW, tb).numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# topk_gather: the plan
# ---------------------------------------------------------------------------
def test_topk_plan_stages_every_neighbor_at_the_codec_shape():
    # m 100, k 11, K 833, d 13,328, f32 values, uint16 columns: whole rows,
    # all 11 payload rows in flight, one 512-thread block per row, one wave
    p = tg.plan(100, 11, 833, 13328, 4, 2, SMS)
    assert (p.route, p.block_d, p.chunks, p.stages) == ("staged", 13328, 1,
                                                        11)
    assert (p.threads, p.blocks, p.resident) == (512, 100, 1)
    # values window 3,332 B -> 3,360; columns 1,666 B -> 1,696
    assert (p.slot_v, p.slot_c) == (3360, 1696)
    # mbarriers 96 + accumulator 53,328 + claims 53,312 + deferred
    # duplicates 2 x 3,344 + 16 + ring 55,616 + neighbor row 88
    assert p.smem == 96 + 53328 + 53312 + 2 * 3344 + 16 + 11 * 5056 + 88
    assert p.smem == 169144 <= SMEM
    p2 = tg.plan(100, 11, 833, 13328, 2, 2, SMS)
    assert (p2.route, p2.chunks, p2.stages, p2.slot_v) == ("staged", 1, 11,
                                                           1696)


def test_topk_plan_takes_the_chunked_route_beyond_one_wave():
    # m 1024, k 16: a whole row's staged block holds an SM alone, so 1,024
    # of them would run in 8 waves; the first version's blocks (53 KB, 4
    # an SM) overlap instead
    staged = tg.staged_smem(16, 833, 13328, 16, 3360, 1696)
    assert tg._resident(staged, tg.STAGED_THREADS) == 1
    p = tg.plan(1024, 16, 833, 13328, 4, 2, SMS)
    assert (p.route, p.block_d, p.chunks, p.stages) == ("chunked", 13328, 1,
                                                        0)
    assert (p.threads, p.blocks, p.resident) == (256, 1024, 4)
    assert p.smem == 4 * 13328 + 8 * 16


def test_topk_plan_rings_where_the_payload_does_not_fit():
    # k 40 in one wave: 2 chunks of 6,664 columns, a ring of 34 of the 40
    # payload rows
    p = tg.plan(50, 40, 831, 13328, 4, 2, SMS)
    assert (p.route, p.chunks, p.block_d, p.stages) == ("staged", 2, 6664,
                                                        34)
    assert p.blocks <= SMS * p.resident and p.smem <= SMEM
    assert tg.staged_smem(40, 831, 6664, 35, p.slot_v, p.slot_c) > SMEM


@pytest.mark.parametrize("m", [1, 37, 100, 1024])
@pytest.mark.parametrize("k", [0, 11, 40])
@pytest.mark.parametrize("K,d", [(0, 64), (1, 512), (833, 13328),
                                 (500, 70001), (40000, 65535)])
@pytest.mark.parametrize("vb,cb", [(4, 2), (2, 4)])
def test_topk_plan_invariants(m, k, K, d, vb, cb):
    p = tg.plan(m, k, K, d, vb, cb, SMS)
    assert p.chunks == -(-d // p.block_d) <= 65535
    assert 1 <= p.block_d <= d and p.blocks == m * p.chunks
    assert p.smem <= SMEM and p.resident >= 1
    slot_v, slot_c = tg._round16(K * vb) + 16, tg._round16(K * cb) + 16
    if p.route == "staged":
        assert (p.slot_v, p.slot_c) == (slot_v, slot_c)
        assert 1 <= p.stages <= max(k, 1) and p.threads == tg.STAGED_THREADS
        assert p.smem == tg.staged_smem(k, K, p.block_d, p.stages, slot_v,
                                        slot_c)
        assert p.blocks <= SMS * p.resident               # one wave
        # the ring is as deep as shared memory allows
        if p.stages < k:
            assert tg.staged_smem(k, K, p.block_d, p.stages + 1, slot_v,
                                  slot_c) > SMEM
    else:
        assert p.stages == 0 and p.threads == tg.THREADS
        assert p.smem == 4 * p.block_d + 8 * k


@pytest.mark.parametrize("args,route,chunks", [
    ((37, 5, 833, 13328, 4, 2), "staged", 3),
    ((13, 3, 500, 70001, 4, 4), "staged", 10),
    ((6, 3, 40000, 65535, 4, 2), "chunked", None),
    ((6, 3, 40000, 65535, 4, 4), "chunked", None),
    ((6, 3, 40000, 65535, 2, 2), "chunked", None)])
def test_topk_plan_routes(args, route, chunks):
    p = tg.plan(*args, SMS)
    assert p.route == route
    if chunks is not None:
        assert p.chunks == chunks


@pytest.mark.parametrize("block_d,stages,route", [
    (128, 0, "chunked"), (13328, 5, "staged"), (4448, 5, "staged")])
def test_topk_plan_takes_valid_block_d(block_d, stages, route):
    p = tg.plan(37, 5, 833, 13328, 4, 2, SMS, block_d)
    assert (p.block_d, p.stages, p.route) == (block_d, stages, route)
    assert p.chunks == -(-13328 // block_d)


@pytest.mark.parametrize("args,block_d", [
    ((8, 5, 833, 13328, 4, 4), 0), ((8, 5, 833, 13328, 4, 4), -5),
    ((8, 5, 833, 70001, 4, 4), 60000), ((8, 5, 833, 70001, 4, 4), 1),
    ((6, 3, 40000, 65535, 4, 4), 70000)])
def test_topk_plan_refuses_invalid_block_d(args, block_d):
    with pytest.raises(ValueError, match="block_d|chunks"):
        tg.plan(*args, SMS, block_d)


@pytest.mark.parametrize("args", [(0, 3, 5, 10, 4, 2), (3, 3, 5, 0, 4, 2),
                                  (3, -1, 5, 10, 4, 2)])
def test_topk_plan_refuses_empty_shapes(args):
    with pytest.raises(ValueError):
        tg.plan(*args, SMS)


# ---------------------------------------------------------------------------
# topk_gather: the staged route's arithmetic
# ---------------------------------------------------------------------------
def _window(addr, nbytes):
    """The kernel's `window`: (a0, bytes, offset) of the 16-byte-aligned
    window that holds nbytes at addr."""
    a0 = addr // 16 * 16
    size = (-(-(addr + nbytes) // 16) * 16 - a0) if nbytes else 0
    return a0, size, addr - a0


@pytest.mark.parametrize("elem", [1, 2, 4])
@pytest.mark.parametrize("n", [0, 1, 2, 15, 16, 17, 833, 1666, 3332])
def test_window_fits_its_slot_and_holds_the_row(elem, n):
    nbytes = n * elem
    for addr in range(0, 64, elem):
        a0, size, off = _window(addr, nbytes)
        assert a0 % 16 == 0 and size % 16 == 0 and a0 + off == addr
        assert size <= tg._round16(nbytes) + 16          # the plan's slot
        if nbytes:
            assert a0 + size >= addr + nbytes
            # every 16-byte chunk holds a byte of the row
            assert a0 + 16 > addr and a0 + size - 16 < addr + nbytes


def emulate_topk_staged(idx, w, values, cols, d, plan, seed=0):
    """The staged kernel, laid out as the plan lays it out: per (row,
    chunk) block, a ring of `stages` slots, each filled with the aligned
    byte windows of a neighbor's value and column rows (the payload arrays
    taken to start on a 16-byte boundary, as a CUDA allocation does) and
    refilled with neighbor j + stages once neighbor j is done; neighbors in
    j order; within one, the pairs in an order the threads may take (a
    seeded shuffle here), each rounded f32 product added in place by the
    pair that claims its column first, a duplicate of the same payload row
    deferred and added after the neighbor; one rounding to values' dtype."""
    m, k = idx.shape
    K = values.shape[1]
    vraw = (values.view(torch.int16) if values.dtype == torch.bfloat16
            else values).numpy().tobytes()
    craw = (cols.to(torch.int32).numpy().astype(np.uint16)
            if cols.dtype == torch.uint16 else cols.numpy()).tobytes()
    vb, cb = values.element_size(), cols.element_size()
    rng = np.random.default_rng(seed)
    out = torch.empty((m, d), dtype=values.dtype)

    def fill(nb):
        slot = []
        for buf, eb, size in ((vraw, vb, plan.slot_v), (craw, cb, plan.slot_c)):
            a0, nbytes, off = _window(nb * K * eb, K * eb)
            assert nbytes <= size
            slot.append((buf[a0:a0 + nbytes].ljust(nbytes, b"\0"), off))
        return slot

    for i in range(m):
        for c0 in range(0, d, plan.block_d):
            width = min(plan.block_d, d - c0)
            acc = torch.zeros(width)
            claim = [-1] * width
            ring = [fill(int(idx[i, j])) for j in range(min(k, plan.stages))]
            for j in range(k):
                (vw, voff), (cw, coff) = ring[j % plan.stages]
                v = torch.frombuffer(bytearray(vw[voff:voff + K * vb]),
                                     dtype=values.dtype).float()
                c = np.frombuffer(cw[coff:coff + K * cb],
                                  dtype=np.uint16 if cb == 2 else np.int32
                                  ).astype(np.int64)
                deferred = []
                for p in rng.permutation(K):
                    off = int(c[p]) - c0
                    if 0 <= off < width:
                        prod = w[i, j] * v[p]                 # f32, rounded
                        if claim[off] != j:
                            claim[off] = j
                            acc[off] = acc[off] + prod
                        else:
                            deferred.append((off, prod))
                for off, prod in deferred:
                    acc[off] = acc[off] + prod
                if j + plan.stages < k:
                    ring[j % plan.stages] = fill(int(idx[i, j + plan.stages]))
            out[i, c0:c0 + width] = acc.to(values.dtype)
    return out


def _payload(m, k, d, K, seed, cols_dtype):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, m, size=(m, k)).astype(np.int32)
    if k > 1:
        idx[:, 1] = idx[:, 0]                # repeated neighbor ids
    w = rng.random((m, k)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    vals = rng.standard_normal((m, K)).astype(np.float32)
    cols = np.stack([rng.permutation(d)[:K] for _ in range(m)])
    return idx, w, vals, cols.astype(cols_dtype)


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.astype(np.int32)).to(torch.uint16)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("m,k,d,K,block_d,stages", [
    (13, 3, 300, 25, None, None),          # whole rows, every row in flight
    (9, 5, 257, 33, None, 2),              # a ring of 2 over 5 neighbors
    (7, 4, 300, 17, 64, None),             # chunks of 64 columns
    (6, 6, 130, 31, 40, 4)])               # chunks and a ring
@pytest.mark.parametrize("cols_dtype", [np.uint16, np.int32])
def test_topk_staged_emulation_is_bitwise_ref_and_matches_reference(
        m, k, d, K, block_d, stages, cols_dtype):
    # odd K: most payload rows start off a 16-byte boundary
    idx, w, vals, cols = _payload(m, k, d, K, m * k + K, cols_dtype)
    ti, tw, tv, tc = _t(idx), _t(w), _t(vals), _t(cols)
    p = tg.plan(m, k, K, d, 4, tc.element_size(), SMS, block_d)
    assert p.route == "staged"
    if stages is not None:
        p = p._replace(stages=stages)      # the ring of a larger shape
    got = emulate_topk_staged(ti, tw, tv, tc, d, p)
    assert torch.equal(got, tref.topk_gather_ref(ti, tw, tv, tc, d))
    want = topk_gather_pallas(jnp.asarray(idx), jnp.asarray(w),
                              jnp.asarray(vals), jnp.asarray(cols), d,
                              interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_topk_staged_emulation_defers_duplicate_columns():
    # a payload row may repeat a column: the second pair finds the claim
    # of its own j and adds after the neighbor, in another order than the
    # plain version's dense decode: rtol/atol 2e-5, as on the card
    idx, w, vals, cols = _payload(9, 3, 260, 20, 4, np.int32)
    cols[:, -1] = cols[:, 0]
    cols[:, -2] = cols[:, 0]
    ti, tw, tv, tc = _t(idx), _t(w), _t(vals), _t(cols)
    p = tg.plan(9, 3, 20, 260, 4, 4, SMS)
    got = emulate_topk_staged(ti, tw, tv, tc, 260, p, seed=1)
    want = tref.topk_gather_ref(ti, tw, tv, tc, 260)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_topk_staged_emulation_bf16_rounds_once():
    # bf16 values: exact in f32, summed in j order, rounded once to bf16,
    # as the plain version: equal bit for bit
    idx, w, vals, cols = _payload(11, 4, 200, 21, 5, np.uint16)
    ti, tw, tc = _t(idx), _t(w), _t(cols)
    tv = torch.as_tensor(vals).to(torch.bfloat16)
    p = tg.plan(11, 4, 21, 200, 2, 2, SMS)._replace(stages=3)
    got = emulate_topk_staged(ti, tw, tv, tc, 200, p)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, tref.topk_gather_ref(ti, tw, tv, tc, 200))
