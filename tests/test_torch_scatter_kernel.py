"""The redesigned write-back kernel's planning and index arithmetic on the
CPU, and the plain version of its many-pair op.

`gossip_scatter` (csrc/gossip_scatter.cu) runs only on a GPU.  What
surrounds it is pure Python and is held here: the planning function that
picks its route, tiling and grid (`kernels.gossip_scatter.plan`), a
plain-torch emulation of the kernel's walk (work item -> pair, row and
chunk; thread slot -> columns) that scatters with `gossip_scatter_ref`,
held bitwise against the JAX reference's Pallas kernel in interpret mode,
and `ops.gossip_scatter_many`'s plain version against one reference
scatter per pair.  `chip_smoke.py` holds the kernel itself against its
plain version on the card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import gossip_scatter as gs
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

torch.set_num_threads(2)
SMS = 132                        # an H100 SXM
SMEM = 232448                    # the opt-in shared memory of a block
D_MAIN = 13328                   # the CNN's d_flat


# ---------------------------------------------------------------------------
# the kernel's walk, as csrc/gossip_scatter.cu computes it
# ---------------------------------------------------------------------------
def blocks(plan, n):
    """(row, first column) of every chunk a block of the (n, grid_y) grid
    moves, in the kernel's order: block (p, y) moves chunks y, y + grid_y,
    ... of row p, each of every pair."""
    for y in range(plan.grid_y):
        for p in range(n):
            for c in range(y, plan.chunks, plan.grid_y):
                yield p, c * plan.block_d


def block_columns(plan, d, c0):
    """The columns a block's threads move for each pair, in the kernel's
    order (vector: slot s of thread t holds 4 (s T + t) .. + 3; scalar: 4
    s + j strided by T)."""
    t = np.arange(plan.threads)
    cols = []
    for s in range(plan.vecs):
        for j in range(4):
            if plan.route == "vector":
                c = c0 + (s * plan.threads + t) * 4 + j
            else:
                c = c0 + (s * 4 + j) * plan.threads + t
            cols.append(c[c < d])
    return np.concatenate(cols)


def emulate(plan, rows, Xs, Us, accumulate):
    """The kernel's writes, block by block and pair by pair through
    `gossip_scatter_ref` on the block's columns; an out-of-range row
    writes nothing."""
    m, d = Us[0].shape
    for p, c0 in blocks(plan, rows.shape[0]):
        r = int(rows[p])
        if not 0 <= r < m:
            continue
        cols = torch.as_tensor(block_columns(plan, d, c0))
        for X, U in zip(Xs, Us):
            sub = U[:, cols]
            tref.gossip_scatter_ref(rows[p:p + 1], X[p:p + 1, cols], sub,
                                    accumulate)
            U[:, cols] = sub
    return Us


def coverage(plan, n, d):
    hits = np.zeros((n, d), np.int64)
    for p, c0 in blocks(plan, n):
        np.add.at(hits[p], block_columns(plan, d, c0), 1)
    return hits


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------
def test_plan_at_the_main_shapes():
    # the sampled round at m 100: 25 rows, one slot a thread and pair, 350
    # blocks of 256 threads in one wave, whatever the pairs; bench scale
    # takes the most slots the pairs leave
    for pairs in (1, 2, 4):
        p = gs.plan(25, D_MAIN, SMS, pairs)
        assert (p.route, p.vecs, p.threads, p.block_d, p.chunks, p.blocks) \
            == ("vector", 1, 256, 1024, 14, 350)
    assert p.blocks <= SMS * gs.RESIDENT_BLOCKS
    for pairs, vecs in ((1, 8), (2, 4), (3, 2), (4, 2)):
        big = gs.plan(1024, D_MAIN, SMS, pairs)
        assert big.vecs == vecs == gs.max_vecs(pairs)
        assert big.blocks > SMS * gs.RESIDENT_BLOCKS


@pytest.mark.parametrize("n", [1, 7, 25, 1024])
@pytest.mark.parametrize("d", [1, 5, 513, D_MAIN, 40000])
@pytest.mark.parametrize("pairs", [1, 2, 3, 4])
@pytest.mark.parametrize("sms", [SMS, 2])
@pytest.mark.parametrize("aligned", [True, False])
def test_plan_invariants(n, d, pairs, sms, aligned):
    p = gs.plan(n, d, sms, pairs, aligned=aligned)
    # the vector route only on aligned widths of whole vectors
    assert (p.route == "vector") == (aligned and d % 4 == 0)
    assert p.vecs in (1, 2, 4, 8) and p.vecs * pairs <= gs.MAX_SLOTS
    assert 32 <= p.threads <= gs.THREADS and p.threads % 32 == 0
    assert p.block_d == 4 * p.threads * p.vecs and p.block_d % 128 == 0
    # the fewest slots for the threads: half as many would need more
    # threads than a block has
    assert p.vecs == 1 or p.threads * 2 > gs.THREADS
    assert p.chunks == -(-d // p.block_d)
    assert p.grid_y == min(p.chunks, gs.MAX_GRID_Y)
    assert p.blocks == n * p.grid_y < 2 ** 31
    # one slot where the blocks fit one wave of the card, else the most
    one_wave = n * -(-d // min(1024, -(-d // 128) * 128)) \
        <= sms * gs.RESIDENT_BLOCKS
    assert p.vecs == (1 if one_wave else gs.max_vecs(pairs))
    # every column of each distinct chunk width once (the last chunk may
    # be narrower)
    for c0 in {0, (p.chunks - 1) * p.block_d}:
        cols = block_columns(p, d, c0)
        assert np.array_equal(np.sort(cols),
                              np.arange(c0, min(d, c0 + p.block_d)))


@pytest.mark.parametrize("route,n,d,pairs,sms", [
    (route, *shape) for route in ("vector", "scalar")
    for shape in ((3, 516, 2, 2), (25, 1024, 4, 3), (2, 13328, 1, 1))
] + [("scalar", 9, 77, 1, 1), ("scalar", 3, 513, 3, 2)])
def test_plan_covers_every_element_once(route, n, d, pairs, sms):
    aligned = route == "vector"
    top = 4 * gs.THREADS * gs.max_vecs(pairs)
    for bd in (None, 128, 1152, top):
        pl = gs.plan(n, d, sms, pairs, bd, aligned=aligned)
        assert pl.route == route
        assert (coverage(pl, n, d) == 1).all(), pl


@pytest.mark.parametrize("block_d", [0, -128, 6, 130, 1000, 8192 + 128,
                                     10 ** 6])
@pytest.mark.parametrize("aligned", [True, False])
def test_plan_refuses_invalid_block_d(block_d, aligned):
    with pytest.raises(ValueError,
                       match=r"a multiple of 128 in \[128, 8192\]"):
        gs.plan(25, D_MAIN, SMS, 1, block_d, aligned=aligned)
    with pytest.raises(ValueError, match="block_d"):
        ops.gossip_scatter_many(
            torch.zeros(1, dtype=torch.int32), [torch.zeros((1, 4))],
            [torch.zeros((2, 4))], block_d=block_d)


@pytest.mark.parametrize("pairs,top", [(1, 8192), (2, 4096), (3, 2048),
                                       (4, 2048)])
def test_plan_holds_the_slots_of_all_pairs_to_max_slots(pairs, top):
    assert gs.plan(25, D_MAIN, SMS, pairs, top).vecs * pairs <= 8
    with pytest.raises(ValueError, match=rf"\[128, {top}\]"):
        gs.plan(25, D_MAIN, SMS, pairs, top + 128)


def test_plan_refuses_more_chunks_than_the_grid_holds():
    # the grid holds 65,535 blocks a row: up to that a block moves one
    # chunk, beyond it the blocks stride over the chunks (no width is
    # refused).  What is refused is a row count beyond the grid's x extent
    # and a cap outside its y extent, naming the valid values
    one = gs.plan(1, 128 * gs.MAX_GRID_Y, SMS, 1, 128)
    assert one.chunks == one.grid_y == gs.MAX_GRID_Y
    more = gs.plan(1, 128 * gs.MAX_GRID_Y + 1, SMS, 1, 128)
    assert (more.chunks, more.grid_y) == (gs.MAX_GRID_Y + 1, gs.MAX_GRID_Y)
    with pytest.raises(ValueError, match=r"1 to 2147483647"):
        gs.plan(2 ** 31, 128, SMS, 1)


@pytest.mark.parametrize("block_d,vecs,threads", [
    (128, 1, 32), (1024, 1, 256), (1152, 2, 144), (4096, 4, 256),
    (8192, 8, 256)])
def test_plan_takes_valid_block_d(block_d, vecs, threads):
    p = gs.plan(25, D_MAIN, SMS, 1, block_d)
    assert (p.block_d, p.vecs, p.threads) == (block_d, vecs, threads)
    assert p.chunks == -(-D_MAIN // block_d)


# an LM's shared row: qwen2-0.5b's 630,167,424 leaves less lm_head (896 x
# 151,936) and final_norm (896), the width of Regime B's write-back
D_LM = 494_031_872


@pytest.mark.parametrize("pairs,vecs", [(1, 8), (2, 4), (4, 2)])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_plan_at_an_lm_shared_row(pairs, vecs, n):
    # the sampled Regime-B round writes back 2 pairs (buffer, momentum) of
    # 2 rows; a codec round 4.  Far more blocks than one wave, so the most
    # slots the pairs leave: 1 pair takes 60,307 chunks of 8,192, within
    # the grid's y extent; 2 pairs 120,614 of 4,096 and 4 pairs 241,227 of
    # 2,048, beyond it, so each block strides over up to 2 and 4 of them
    # (the plan refused both before: more than 65,535 chunks)
    p = gs.plan(n, D_LM, SMS, pairs)
    assert (p.route, p.vecs, p.threads) == ("vector", vecs, 256)
    assert p.block_d == 1024 * vecs and p.chunks == -(-D_LM // p.block_d)
    assert p.chunks == {1: 60_307, 2: 120_614, 4: 241_227}[pairs]
    assert p.grid_y == min(p.chunks, gs.MAX_GRID_Y)
    assert p.blocks == n * p.grid_y
    # block y moves chunks y, y + grid_y, ...: every chunk once
    per_block = [len(range(y, p.chunks, p.grid_y)) for y in range(p.grid_y)]
    assert sum(per_block) == p.chunks
    assert max(per_block) == {1: 1, 2: 2, 4: 4}[pairs]


@pytest.mark.parametrize("args", [(0, 5, SMS, 1), (5, 0, SMS, 1),
                                  (5, 5, 0, 1), (5, 5, SMS, 0),
                                  (5, 5, SMS, 5)])
def test_plan_refuses_empty_shapes_and_pair_counts(args):
    with pytest.raises(ValueError):
        gs.plan(*args)


# ---------------------------------------------------------------------------
# the kernel's walk against the reference's interpreted Pallas kernel
# ---------------------------------------------------------------------------
M = 30


@pytest.mark.parametrize("n", [0, 1, 25, M])
@pytest.mark.parametrize("d", [1, 5, 513, D_MAIN])
@pytest.mark.parametrize("udt", ["float32", "bfloat16"])
@pytest.mark.parametrize("accumulate", [False, True])
def test_emulation_equals_reference_kernel(n, d, udt, accumulate):
    # set is an exact copy and accumulate one f32 add then one rounding to
    # U's type on both sides: bit for bit, on both routes, at the plan's
    # tiling for a large and a small card and at a narrow block_d
    rng = np.random.default_rng(n * 7 + d)
    U = rng.standard_normal((M, d)).astype(np.float32)
    X = rng.standard_normal((n, d)).astype(np.float32)
    rows = rng.permutation(M)[:n].astype(np.int32)
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[udt]
    want = np.asarray(jops.gossip_scatter(
        jnp.asarray(rows), jnp.asarray(X), jnp.asarray(U).astype(jdt),
        accumulate=accumulate, force="pallas").astype(jnp.float32))
    if n == 0:
        np.testing.assert_array_equal(want, np.asarray(
            jnp.asarray(U).astype(jdt).astype(jnp.float32)))
        return
    Ut = torch.as_tensor(U).to(tdt)
    plans = [gs.plan(n, d, sms, 1, bd, aligned=aligned)
             for sms in (SMS, 3) for aligned in (True, False)
             for bd in (None, 128 if d <= 513 else 1152)]
    for p in plans:
        got = emulate(p, torch.as_tensor(rows), [torch.as_tensor(X)],
                      [Ut.clone()], accumulate)[0]
        np.testing.assert_array_equal(got.float().numpy(), want,
                                      err_msg=str(p))


@pytest.mark.parametrize("pairs", [2, 3, 4])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("accumulate", [False, True])
def test_emulation_of_many_pairs_equals_reference_scatter_per_pair(
        pairs, aligned, accumulate):
    # the blocks move their chunk of every pair: each pair's U equals one
    # reference scatter of that pair, bit for bit, at the default tiling
    # and at the most slots the pairs leave
    rng = np.random.default_rng(pairs)
    m, n, d = 9, 5, 1284
    rows = rng.permutation(m)[:n].astype(np.int32)
    Xs = [rng.standard_normal((n, d)).astype(np.float32)
          for _ in range(pairs)]
    Us = [rng.standard_normal((m, d)).astype(np.float32)
          for _ in range(pairs)]
    wants = [np.asarray(jops.gossip_scatter(
        jnp.asarray(rows), jnp.asarray(X), jnp.asarray(U),
        accumulate=accumulate, force="ref")) for X, U in zip(Xs, Us)]
    for bd in (None, 4 * gs.THREADS * gs.max_vecs(pairs)):
        p = gs.plan(n, d, 2, pairs, bd, aligned=aligned)
        got = emulate(p, torch.as_tensor(rows),
                      [torch.as_tensor(X) for X in Xs],
                      [torch.tensor(U) for U in Us], accumulate)
        for g, want in zip(got, wants):
            np.testing.assert_array_equal(g.numpy(), want, err_msg=str(p))


@pytest.mark.parametrize("n", [5])
@pytest.mark.parametrize("d", [513, 4097])
@pytest.mark.parametrize("cap", [1, 3])
@pytest.mark.parametrize("udt", ["float32", "bfloat16"])
@pytest.mark.parametrize("accumulate", [False, True])
def test_strided_emulation_equals_reference_kernel(n, d, cap, udt,
                                                   accumulate):
    # the striding instance's block indexing: a grid of `cap` blocks a
    # row (the plan's tiling with grid_y cut to cap, as a row of more
    # than 65,535 chunks gets it) strides over every chunk of its row, at
    # one to eight slots and on both routes; bit for bit against the
    # reference's interpreted Pallas kernel, every element written once
    rng = np.random.default_rng(d * 3 + n + cap)
    U = rng.standard_normal((M, d)).astype(np.float32)
    X = rng.standard_normal((n, d)).astype(np.float32)
    rows = rng.permutation(M)[:n].astype(np.int32)
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[udt]
    want = np.asarray(jops.gossip_scatter(
        jnp.asarray(rows), jnp.asarray(X), jnp.asarray(U).astype(jdt),
        accumulate=accumulate, force="pallas").astype(jnp.float32))
    for bd, aligned in ((128, True), (1152, False), (8192, True)):
        p = gs.plan(n, d, SMS, 1, bd, aligned=aligned)
        p = p._replace(grid_y=min(cap, p.chunks), blocks=n * min(cap,
                                                                 p.chunks))
        assert (coverage(p, n, d) == 1).all(), p
        got = emulate(p, torch.as_tensor(rows), [torch.as_tensor(X)],
                      [torch.tensor(U).to(tdt)], accumulate)[0]
        np.testing.assert_array_equal(got.float().numpy(), want,
                                      err_msg=str(p))


# ---------------------------------------------------------------------------
# ops.gossip_scatter_many: the plain version and its refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pairs", [1, 2, 4])
@pytest.mark.parametrize("xdt,udt", [("float32", "float32"),
                                     ("bfloat16", "bfloat16"),
                                     ("float32", "bfloat16")])
@pytest.mark.parametrize("accumulate", [False, True])
def test_scatter_many_plain_equals_one_reference_scatter_per_pair(
        pairs, xdt, udt, accumulate):
    rng = np.random.default_rng(pairs)
    m, n, d = 11, 4, 70
    rows = rng.permutation(m)[:n].astype(np.int32)
    Xs = [rng.standard_normal((n, d)).astype(np.float32)
          for _ in range(pairs)]
    Us = [rng.standard_normal((m, d)).astype(np.float32)
          for _ in range(pairs)]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
    Ut = [torch.tensor(U).to(td[udt]) for U in Us]     # U stays as drawn
    got = ops.gossip_scatter_many(
        torch.as_tensor(rows), [torch.as_tensor(X).to(td[xdt]) for X in Xs],
        Ut, accumulate=accumulate)
    assert len(got) == pairs and all(a is b for a, b in zip(got, Ut))
    for X, U, g in zip(Xs, Us, got):
        want = jops.gossip_scatter(
            jnp.asarray(rows), jnp.asarray(X).astype(jd[xdt]),
            jnp.asarray(U).astype(jd[udt]), accumulate=accumulate,
            force="ref")
        np.testing.assert_array_equal(
            g.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_scatter_many_refuses_what_one_launch_cannot_take():
    rows = torch.tensor([0, 2], dtype=torch.int32)
    X, U = torch.zeros((2, 8)), torch.zeros((4, 8))
    with pytest.raises(TypeError, match="one X and one U dtype"):
        ops.gossip_scatter_many(rows, [X, X], [U, U.bfloat16()])
    with pytest.raises(TypeError, match="one X and one U dtype"):
        ops.gossip_scatter_many(rows, [X, X.bfloat16()], [U, U.clone()])
    with pytest.raises(ValueError, match="want"):         # rows of 3
        ops.gossip_scatter_many(rows[:1], [X, X], [U, U.clone()])
    with pytest.raises(ValueError, match="want"):         # another width
        ops.gossip_scatter_many(rows, [X, X[:, :4]], [U, U[:, :4]])
    with pytest.raises(ValueError, match="1 to 4"):
        ops.gossip_scatter_many(rows, [X] * 5, [U.clone() for _ in range(5)])
    with pytest.raises(ValueError, match="1 to 4"):
        ops.gossip_scatter_many(rows, [], [])
    with pytest.raises(ValueError, match="force='cuda'"):
        ops.gossip_scatter_many(rows, [X], [U], force="cuda")
