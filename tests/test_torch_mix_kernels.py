"""The redesigned mix kernels' planning and arithmetic on the CPU.

`pushsum_mix` (csrc/pushsum_mix.cu) and `gossip_gather`
(csrc/gossip_gather.cu) run only on a GPU.  What surrounds them is pure
Python and is held here: the planning functions that pick their tiles,
grids and routes (`kernels.pushsum_mix.plan`, `kernels.gossip_gather.plan`),
and plain-torch emulations of each kernel's arithmetic order, tile by tile
as the plan lays it out, on seeded numpy inputs against the JAX reference's
Pallas kernels in interpret mode.  `chip_smoke.py` holds the kernels
themselves against their plain versions on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gossip_gather import gossip_gather_pallas
from repro.kernels.pushsum_mix import pushsum_mix_pallas
from repro_torch.core import gossip as tgossip
from repro_torch.kernels import gossip_gather as gg
from repro_torch.kernels import pushsum_mix as pm

torch.set_num_threads(2)
SMS = 132                        # an H100 SXM
SMEM = 232448                    # the opt-in shared memory of a block


# ---------------------------------------------------------------------------
# pushsum_mix: the plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,d", [(100, 13328), (1024, 13328)])
def test_pushsum_plan_fills_the_sms_evenly_at_the_main_shapes(m, d):
    p = pm.plan(m, d, 4, SMS)
    blocks = p.panels * p.row_tiles
    # the busiest SM runs ceil(blocks / SMS) blocks; the mean SM has at
    # least 95% of its columns
    assert p.tiles_per_sm == -(-blocks // SMS)
    assert p.balance >= 0.95
    assert blocks > (p.tiles_per_sm - 1) * SMS
    assert p.smem <= SMEM and p.threads <= 512 and p.threads % 32 == 0
    if m == 100:
        # all rows in one tile, padded only to the 8-row thread tile: each
        # U panel is read once; 129 blocks of 104 columns on 132 SMs
        assert (p.tile_m, p.row_tiles, p.bn, p.panels) == (104, 1, 104, 129)
    else:
        assert (p.tile_m, p.row_tiles, p.bn) == (128, 8, 64)


@pytest.mark.parametrize("m", [1, 7, 8, 100, 128, 129, 257, 1024])
@pytest.mark.parametrize("d", [1, 511, 513, 13328])
@pytest.mark.parametrize("elem_bytes", [4, 2])
def test_pushsum_plan_invariants(m, d, elem_bytes):
    p = pm.plan(m, d, elem_bytes, SMS)
    assert p.tile_m % pm.TM == 0 and p.tile_m <= pm.MAX_TILE_M
    # the row tiles cover m, padding each only up to the thread tile
    assert p.tile_m * p.row_tiles >= m
    assert p.tile_m * p.row_tiles - m < pm.TM * p.row_tiles
    assert p.row_tiles == -(-m // pm.MAX_TILE_M)
    assert p.bn % 8 == 0 and 8 <= p.bn <= (
        pm.MAX_BN if p.row_tiles == 1 else pm.MAX_BN_MULTI)
    assert p.panels == -(-d // p.bn) and p.bn < d + 8
    assert p.threads == -(-(p.tile_m // pm.TM * p.bn // pm.TN) // 32) * 32
    assert p.smem == pm.STAGES * pm.BK * (p.tile_m * 4
                                           + p.bn * elem_bytes) <= SMEM


def test_pushsum_plan_refuses_empty_shapes():
    for args in ((0, 5, 4, SMS), (5, 0, 4, SMS), (5, 5, 4, 0)):
        with pytest.raises(ValueError):
            pm.plan(*args)


# ---------------------------------------------------------------------------
# pushsum_mix: the kernel's arithmetic
# ---------------------------------------------------------------------------
def _fma_f32(a, b, c):
    """fmaf in float32: the f32 product is exact in f64, then one rounding
    of a*b + c to f32 (a double rounding only on a tie at f64's 53 bits)."""
    return (a.double() * b.double() + c.double()).float()


def emulate_pushsum_mix(P, U, plan):
    """The CUDA kernel's order: per (row tile, panel) block, zero-padded to
    the tile, the m-long contraction in chunks of BK, one fmaf per k in
    k order; the output in U's dtype."""
    m, d = U.shape
    rows, cols = plan.tile_m * plan.row_tiles, plan.bn * plan.panels
    kp = -(-m // pm.BK) * pm.BK
    Pp = torch.zeros((rows, kp))
    Pp[:m, :m] = P
    Up = torch.zeros((kp, cols))
    Up[:m, :d] = U.float()
    out = torch.empty((rows, cols))
    for r0 in range(0, rows, plan.tile_m):
        for c0 in range(0, cols, plan.bn):
            acc = torch.zeros((plan.tile_m, plan.bn))
            for k0 in range(0, kp, pm.BK):
                for k in range(k0, k0 + pm.BK):
                    acc = _fma_f32(Pp[r0:r0 + plan.tile_m, k, None],
                                   Up[k, None, c0:c0 + plan.bn], acc)
            out[r0:r0 + plan.tile_m, c0:c0 + plan.bn] = acc
    return out[:m, :d].to(U.dtype)


@pytest.mark.parametrize("m,d", [(100, 300), (13, 513), (257, 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pushsum_emulation_matches_reference_kernel(m, d, dtype):
    # the kernel sums m products in k order with FMAs, the interpreted
    # Pallas kernel in XLA's dot order: f32 rtol/atol 1e-5; a bf16 output
    # rounds once on each side after an f32 sum that may differ in the
    # last ulp: one bf16 ulp, rtol/atol 8e-3
    rng = np.random.default_rng(m + d)
    P = rng.random((m, m)).astype(np.float32)
    P /= P.sum(1, keepdims=True)
    U = rng.standard_normal((m, d)).astype(np.float32)
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    Ut = torch.as_tensor(U).to(tdt)
    got = emulate_pushsum_mix(torch.as_tensor(P), Ut,
                              pm.plan(m, d, Ut.element_size(), SMS))
    want = pushsum_mix_pallas(jnp.asarray(P), jnp.asarray(U).astype(jdt),
                              interpret=True)
    tol = 1e-5 if dtype == "float32" else 8e-3
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# gossip_gather: the plan and its routes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,k,d", [(100, 11, 13328), (1024, 16, 13328)])
@pytest.mark.parametrize("elem_bytes", [4, 2])
def test_gather_plan_takes_the_panel_route_evenly_at_the_main_shapes(
        m, k, d, elem_bytes):
    p = gg.plan(m, k, d, elem_bytes, SMS)
    assert p.route == "panel"
    assert p.blocks == -(-d // p.block_d)
    assert p.blocks_per_sm == -(-p.blocks // SMS)
    assert p.blocks > (p.blocks_per_sm - 1) * SMS and p.balance >= 0.95
    assert p.smem <= SMEM and p.threads <= 1024 and p.threads % 32 == 0
    assert p.block_d * m * elem_bytes <= SMEM
    if (m, elem_bytes) == (100, 4):
        # 129 panels of 104 columns, the neighbor table staged beside the
        # panel, 26 column groups x 39 row slots of threads
        assert (p.block_d, p.blocks, p.table, p.threads) == (104, 129, True,
                                                            1024)
        assert p.smem == 100 * 104 * 4 + 100 * 11 * 8


# Regime B's shared row: qwen2-0.5b's 630,167,424 leaves less lm_head and
# final_norm, mixed over m 4 clients (k 3 at 2 neighbors; 2 rows on the
# sampled round's compact set)
D_LM = 494_031_872


@pytest.mark.parametrize("m,k", [(4, 3), (2, 2), (4, 2)])
@pytest.mark.parametrize("elem_bytes", [4, 2])
def test_gather_plan_at_an_lm_shared_row(m, k, elem_bytes):
    # the panel route (m x 16 columns fit shared memory), U read once, a
    # 1-D grid far under 2^31 blocks.  The launch refuses a panel whose
    # block_d / TN column groups exceed its threads; before the cap at
    # TN x PANEL_THREADS the plan chose 14,340 columns here (3,585 groups
    # for 1,024 threads), which the kernel would have refused
    p = gg.plan(m, k, D_LM, elem_bytes, SMS)
    assert p.route == "panel" and p.table
    assert p.block_d <= gg.TN * gg.PANEL_THREADS
    assert p.threads >= p.block_d // gg.TN and p.threads <= 1024
    assert p.blocks == -(-D_LM // p.block_d) < 2 ** 31
    assert p.smem <= SMEM and p.balance >= 0.999
    if (m, k, elem_bytes) == (4, 3, 4):
        assert (p.block_d, p.blocks, p.threads) == (3948, 125_135, 1024)


@pytest.mark.parametrize("m", [1, 2, 4, 17, 100, 1024, 3632])
@pytest.mark.parametrize("d", [4, 13328, 10 ** 6, D_LM])
@pytest.mark.parametrize("elem_bytes", [4, 2])
def test_gather_plan_panel_fits_its_threads(m, d, elem_bytes):
    # what the launch checks (csrc/gossip_gather.cu launch_panel): every
    # column group of a panel has a thread
    p = gg.plan(m, 3, d, elem_bytes, SMS)
    assert p.route == "panel"
    assert p.block_d // gg.TN <= p.threads <= gg.PANEL_THREADS
    assert p.block_d % (16 // elem_bytes) == 0
    with pytest.raises(ValueError, match="column groups"):
        gg.plan(m, 3, d, elem_bytes, SMS, gg.TN * gg.PANEL_THREADS + 16)


@pytest.mark.parametrize("elem_bytes,m_max", [(4, 3632), (2, 7264)])
def test_gather_plan_takes_the_row_route_above_the_smem_limit(elem_bytes,
                                                             m_max):
    # a panel of 16 columns of all m rows must fit the opt-in limit
    assert m_max * gg.PANEL_MIN_COLS * elem_bytes <= SMEM
    assert (m_max + 1) * gg.PANEL_MIN_COLS * elem_bytes > SMEM
    assert gg.plan(m_max, 3, 4096, elem_bytes, SMS).route == "panel"
    p = gg.plan(m_max + 1, 3, 4096, elem_bytes, SMS)
    assert p.route == "row" and p.block_d == gg.ROW_BLOCK_D
    assert p.blocks == (m_max + 1) * 4 and p.threads == 256


@pytest.mark.parametrize("m,elem_bytes,block_d", [
    (100, 4, 6), (100, 4, 0), (100, 4, -4), (100, 4, 584), (100, 2, 12),
    (100, 2, 1168), (4096, 4, 100), (4096, 4, 64), (4096, 4, 4224),
    (8192, 2, 8)])
def test_gather_plan_refuses_invalid_block_d(m, elem_bytes, block_d):
    with pytest.raises(ValueError, match=f"block_d={block_d}"):
        gg.plan(m, 3, 13328, elem_bytes, SMS, block_d)


@pytest.mark.parametrize("m,elem_bytes,block_d", [
    (100, 4, 4), (100, 4, 580), (100, 2, 8), (100, 2, 1160),
    (4096, 4, 128), (4096, 4, 4096)])
def test_gather_plan_takes_valid_block_d(m, elem_bytes, block_d):
    p = gg.plan(m, 3, 13328, elem_bytes, SMS, block_d)
    assert p.block_d == block_d and p.smem <= SMEM


def test_gather_plan_leaves_the_table_out_when_it_would_not_fit():
    p = gg.plan(1024, 16, 13328, 4, SMS)
    assert not p.table and p.smem == 1024 * p.block_d * 4


# ---------------------------------------------------------------------------
# gossip_gather: the panel route's arithmetic
# ---------------------------------------------------------------------------
def emulate_gather_panels(idx, w, U, plan):
    """The panel kernel's order: panel by panel, every output row of the
    panel from the staged panel, the neighbors in j order with a rounded
    f32 product and a rounded f32 add; the output in U's dtype."""
    m, k = idx.shape
    d = U.shape[1]
    out = torch.empty((m, d), dtype=U.dtype)
    nb = idx.long()
    wf = w.float()
    for c0 in range(0, d, plan.block_d):
        panel = U[:, c0:c0 + plan.block_d].float()
        acc = torch.zeros((m, panel.shape[1]))
        for j in range(k):
            term = wf[:, j, None] * panel[nb[:, j]]
            acc = term if j == 0 else acc + term
        out[:, c0:c0 + panel.shape[1]] = acc.to(U.dtype)
    return out


@pytest.mark.parametrize("m,k,d,sms", [(24, 5, 200, 4), (13, 3, 513, SMS),
                                       (100, 11, 416, 2)])
def test_gather_panel_emulation_is_bitwise_mix_rows_and_matches_reference(
        m, k, d, sms):
    rng = np.random.default_rng(m * k + d)
    idx = rng.integers(0, m, size=(m, k)).astype(np.int32)
    idx[:, 1] = idx[:, 0]                  # repeated neighbor ids
    w = rng.random((m, k)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    U = rng.standard_normal((m, d)).astype(np.float32)
    ti, tw, tU = map(torch.as_tensor, (idx, w, U))
    plan = gg.plan(m, k, d, 4, sms)
    assert plan.route == "panel" and plan.blocks >= 2
    got = emulate_gather_panels(ti, tw, tU, plan)
    assert torch.equal(got, tgossip.mix_rows(ti, tw, tU))
    want = gossip_gather_pallas(jnp.asarray(idx), jnp.asarray(w),
                                jnp.asarray(U), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_gather_panel_emulation_bf16_rounds_once():
    # bf16 U: the f32 sum in j order rounded once to bf16, as the plain
    # version: equal bit for bit to its f32 result cast to bf16
    rng = np.random.default_rng(3)
    m, k, d = 24, 4, 72
    idx = torch.as_tensor(rng.integers(0, m, size=(m, k)).astype(np.int32))
    w = torch.as_tensor(rng.random((m, k)).astype(np.float32))
    U = torch.as_tensor(rng.standard_normal((m, d)).astype(
        np.float32)).bfloat16()
    plan = gg.plan(m, k, d, 2, 3)
    got = emulate_gather_panels(idx, w, U, plan)
    want = tgossip.mix_rows(idx, w, U.float()).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


# ---------------------------------------------------------------------------
# gossip_gather over a halo: an (n, k) table over an (N, d) buffer, N > n
# (the cross-rank matrix mix: a rank's own rows, then the rows it received)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,N,k,d,elem_bytes", [
    (50, 80, 11, 13328, 4), (2, 4, 3, 160_350_800, 4), (50, 80, 11, 13328, 2),
    (6, 7, 3, 64, 4)])
def test_gather_plan_sizes_the_panel_by_the_buffer_rows(n, N, k, d,
                                                        elem_bytes):
    p = gg.plan(n, k, d, elem_bytes, SMS, rows=N)
    assert p.route == "panel"
    # the panel stages all N rows; the table and the threads serve n
    assert p.block_d * N * elem_bytes <= SMEM
    panel = -(-N * p.block_d * elem_bytes // 16) * 16
    assert p.smem == panel + (8 * n * k if p.table else 0)
    assert p.threads == min(gg.PANEL_THREADS,
                            -(-(p.block_d // gg.TN * n) // 32) * 32)
    assert p.blocks == -(-d // p.block_d)
    # the widest panel a buffer of N rows allows is narrower than n's
    align = 16 // elem_bytes
    top = min(SMEM // (N * elem_bytes) // align * align,
              gg.TN * gg.PANEL_THREADS)
    assert gg.plan(n, k, d, elem_bytes, SMS, top, N).block_d == top
    if top + align <= gg.TN * gg.PANEL_THREADS:
        with pytest.raises(ValueError, match=f"N={N}"):
            gg.plan(n, k, d, elem_bytes, SMS, top + align, N)
    # N = n is the plan of the square shape
    assert gg.plan(n, k, d, elem_bytes, SMS, rows=n) == \
        gg.plan(n, k, d, elem_bytes, SMS)


@pytest.mark.parametrize("elem_bytes,n_max", [(4, 3632), (2, 7264)])
def test_gather_plan_takes_the_row_route_when_the_buffer_outgrows_a_panel(
        elem_bytes, n_max):
    # the table's rows fit a panel, the buffer's do not: the row route,
    # one block per (table row, chunk)
    assert gg.plan(100, 3, 4096, elem_bytes, SMS, rows=n_max).route == \
        "panel"
    p = gg.plan(100, 3, 4096, elem_bytes, SMS, rows=n_max + 1)
    assert p.route == "row" and p.block_d == gg.ROW_BLOCK_D
    assert p.blocks == 100 * 4 and p.threads == 256 and p.smem == 8 * 3


def test_gather_plan_refuses_a_buffer_smaller_than_the_table():
    with pytest.raises(ValueError, match="rows >= m"):
        gg.plan(5, 3, 64, 4, SMS, rows=4)


def emulate_gather_rows(idx, w, U, block_d):
    """The row kernel's order: one block per (table row, chunk of block_d
    columns), its k neighbor rows read in j order, a rounded f32 product
    and a rounded f32 add per column; the output in U's dtype."""
    m, k = idx.shape
    d = U.shape[1]
    out = torch.empty((m, d), dtype=U.dtype)
    for i in range(m):
        for c0 in range(0, d, block_d):
            c1 = min(d, c0 + block_d)
            acc = None
            for j in range(k):
                term = w[i, j].float() * U[int(idx[i, j]), c0:c1].float()
                acc = term if j == 0 else acc + term
            out[i, c0:c1] = acc.to(U.dtype)
    return out


def _halo_inputs(n, h, k, d, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n + h, size=(n, k)).astype(np.int32)
    idx[:, 0] = np.arange(n)                # each row reads itself first
    idx[:, -1] = n + rng.integers(0, h, size=n)     # and one halo row
    w = rng.random((n, k)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    U = torch.as_tensor(rng.standard_normal((n + h, d)).astype(np.float32))
    return torch.as_tensor(idx), torch.as_tensor(w), U.to(dtype)


@pytest.mark.parametrize("n,h,k,d,sms", [(50, 30, 11, 520, SMS),
                                         (2, 2, 3, 300, 4),
                                         (13, 1, 4, 97, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_halo_emulations_are_bitwise_the_plain_version(n, h, k, d,
                                                               sms, dtype):
    from repro_torch.kernels.ref import gossip_gather_ref
    idx, w, U = _halo_inputs(n, h, k, d, n * 7 + h, dtype)
    want = gossip_gather_ref(idx, w, U)
    assert want.shape == (n, d) and want.dtype == dtype
    eb = U.element_size()
    panel = gg.plan(n, k, d, eb, sms, rows=n + h)
    assert panel.route == "panel"
    assert torch.equal(emulate_gather_panels(idx, w, U, panel), want)
    # the row route at its smallest block_d, which cuts the columns into
    # chunks
    assert torch.equal(emulate_gather_rows(idx, w, U, 128), want)
    if dtype == torch.float32:
        assert torch.equal(want, tgossip.mix_rows(idx, w, U))
