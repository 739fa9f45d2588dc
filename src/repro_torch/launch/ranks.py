"""Ranks of a client mesh on `torch.distributed`: the process-group setup
and the row plans of the cross-rank mixes.

The D data indices of a client mesh each hold a contiguous block of the m
clients (data index d the rows [d m/D, (d+1) m/D)); with T model ranks a
data index is T ranks, each holding one tensor-parallel shard of those
clients (`launch/mesh.py`, `launch/tp.py`).  The backend follows the device: NCCL for CUDA
tensors, gloo for CPU tensors; a CUDA run never falls back to gloo.  The
rendezvous is a file (`init_method="file://..."`), so no port is opened.

The plans are pure functions of (m, D, data index) and the round's
pattern, so every rank computes its peers' side of an exchange without
asking, and the tests and the dry run (`launch/dryrun.py`) read the same
plans the mixes execute.  A plan's peer q is a data index: the mixes
exchange with its global rank q T + t (`ClientMesh.peer`), so the ranks of
one model index t mix their shards among themselves:
- `permutation_steps`: the ppermute mix's pull from (j - off) mod m, one
  step per local row; a step receives the row it combines (or copies it
  locally) and sends the rows its peers combine in the same step, so a
  rank never holds more than one received row;
- `gather_plan`: the matrix mix's halo, the neighbor rows a rank's
  clients read that live on other ranks, and who sends which; over equal
  blocks of the m clients, or over explicit bounds (`compact_bounds`: the
  sampled round's compact working set, whose rows a data index owns
  unevenly and may not own at all).
"""
from __future__ import annotations

import bisect
import os
from typing import NamedTuple, Sequence, Tuple

import torch

from ..device import resolve_device


def backend_for(device) -> str:
    """"nccl" for a CUDA device, "gloo" for the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return "nccl"
    if dev.type == "cpu":
        return "gloo"
    raise ValueError(f"no process-group backend for device {str(dev)!r}")


def init(rank: int, world: int, init_file: str | None, device="cuda"):
    """Join the default process group as `rank` of `world` through the
    rendezvous file `init_file` (no port, no network), or through
    torchrun's environment (`env://`) when init_file is None.  -> the
    rank's torch.device: on CUDA the card `rank mod device_count()`, made
    current.  The backend is `backend_for(device)`: a failing NCCL raises,
    it never becomes gloo."""
    import torch.distributed as dist
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    method = "env://" if init_file is None else \
        "file://" + os.path.abspath(init_file)
    dist.init_process_group(backend_for(dev), init_method=method,
                            world_size=int(world), rank=int(rank))
    return dev


def from_environment() -> Tuple[int, int] | None:
    """(rank, world) from torchrun's environment (RANK, WORLD_SIZE), or
    None outside it."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return None


def shutdown() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def row_range(m: int, world: int, rank: int) -> Tuple[int, int]:
    """The global client rows [lo, hi) of `rank`: contiguous blocks of
    m / world rows."""
    if world < 1 or m % world:
        raise ValueError(f"{m} clients over {world} ranks: the client "
                         f"mesh wants m % W == 0 (equal blocks)")
    n = m // world
    return rank * n, (rank + 1) * n


# ---------------------------------------------------------------------------
# the permutation mix
# ---------------------------------------------------------------------------
class Step(NamedTuple):
    """One step of the permutation mix on one rank: local row `row`
    combines with global source row `src`, held locally at `local` (or
    None) or received from rank `peer`; `sends` are (local row, peer)
    pairs this rank sends in the same step."""
    row: int
    src: int
    local: int | None
    peer: int | None
    sends: Tuple[Tuple[int, int], ...]


def permutation_steps(m: int, world: int, rank: int,
                      off: int) -> Tuple[Step, ...]:
    """Client j pulls from client (j - off) mod m.  Step s handles local
    row s on every rank, so a step's sends and receives pair up across
    ranks in one batch of point-to-point operations."""
    n = m // world
    lo, _ = row_range(m, world, rank)
    steps = []
    for s in range(n):
        src = (lo + s - off) % m
        peer = src // n
        sends = []
        for q in range(world):
            if q == rank:
                continue
            g = (q * n + s - off) % m
            if g // n == rank:
                sends.append((g - lo, q))
        steps.append(Step(s, src, src - lo if peer == rank else None,
                          None if peer == rank else peer, tuple(sends)))
    return tuple(steps)


# ---------------------------------------------------------------------------
# the matrix mix
# ---------------------------------------------------------------------------
class GatherPlan(NamedTuple):
    """The rows a rank reads beyond its own block: `halo` (global ids,
    ascending) placed after the own rows; `recv` and `send` as (peer,
    global rows ascending) pairs."""
    lo: int
    hi: int
    halo: Tuple[int, ...]
    recv: Tuple[Tuple[int, Tuple[int, ...]], ...]
    send: Tuple[Tuple[int, Tuple[int, ...]], ...]

    def position(self, g: int) -> int:
        """Global row g -> its row in the (own + halo) buffer."""
        if self.lo <= g < self.hi:
            return g - self.lo
        return self.hi - self.lo + self.halo.index(g)


def _needs(idx_rows: Sequence[Sequence[int]], lo: int, hi: int):
    return tuple(sorted({int(g) for row in idx_rows for g in row}
                        - set(range(lo, hi))))


def equal_bounds(m: int, world: int) -> Tuple[int, ...]:
    """The world + 1 row bounds of equal blocks: rank q holds [b[q],
    b[q + 1])."""
    return tuple(row_range(m, world, q)[0] for q in range(world)) + (m,)


def compact_bounds(active: Sequence[int], m: int,
                   world: int) -> Tuple[int, ...]:
    """The world + 1 bounds of the compact ids each data index owns in a
    sampled round: `active` are the round's sorted global ids, so the
    compact ids whose rows lie in rank q's block [q m / W, (q + 1) m / W)
    are the range [a_q, a_{q+1}), a_q = searchsorted(active, q m / W).  A
    rank may own none."""
    active = [int(g) for g in active]
    if any(b <= a for a, b in zip(active, active[1:])):
        raise ValueError("compact_bounds wants the sampler's sorted, "
                         "unique ids")
    return tuple(bisect.bisect_left(active, lo)
                 for lo in equal_bounds(m, world)[:-1]) + (len(active),)


def gather_plan(idx: Sequence[Sequence[int]], m: int, world: int,
                rank: int, bounds: Sequence[int] | None = None
                ) -> GatherPlan:
    """idx: the round's full (m, k) neighbor table (global ids, the same
    on every rank).  bounds: the world + 1 row bounds of the ranks' blocks
    (`compact_bounds`; default `equal_bounds(m, world)`); row g belongs to
    the q with bounds[q] <= g < bounds[q + 1]."""
    b = tuple(equal_bounds(m, world) if bounds is None else bounds)
    if len(b) != world + 1 or b[0] != 0 or b[-1] != m or \
            any(y < x for x, y in zip(b, b[1:])):
        raise ValueError(f"bounds {b}: want {world + 1} ascending row "
                         f"bounds from 0 to {m}")

    def owner(g):
        return bisect.bisect_right(b, g) - 1

    lo, hi = b[rank], b[rank + 1]
    halo = _needs(idx[lo:hi], lo, hi)
    recv = tuple((q, tuple(g for g in halo if owner(g) == q))
                 for q in range(world) if q != rank
                 and any(owner(g) == q for g in halo))
    send = []
    for q in range(world):
        if q == rank:
            continue
        want = tuple(g for g in _needs(idx[b[q]:b[q + 1]], b[q], b[q + 1])
                     if lo <= g < hi)
        if want:
            send.append((q, want))
    return GatherPlan(lo, hi, halo, recv, tuple(send))


def exchange(sends, recvs) -> None:
    """One batch of point-to-point operations: `sends` (tensor, peer) and
    `recvs` (tensor to fill, peer), waited for.  Between one pair of ranks
    the operations match in the order they are listed."""
    import torch.distributed as dist
    ops = [dist.P2POp(dist.isend, t, p) for t, p in sends]
    ops += [dist.P2POp(dist.irecv, t, p) for t, p in recvs]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def all_gather_rows(x: torch.Tensor, world: int, group=None,
                    counts: Sequence[int] | None = None) -> torch.Tensor:
    """The (m, ...) concatenation of the (m / D, ...) blocks of the `world`
    ranks of `group` (a client mesh's data group; None: the default
    group), a collective even on one rank (so a one-rank group runs its
    backend).  counts: each rank's row count where they differ (a sampled
    round's compact rows, 0 included): every block travels padded to the
    largest."""
    import torch.distributed as dist
    if counts is None:
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)
    top = max(counts)
    pad = x.new_zeros((top,) + tuple(x.shape[1:]))
    pad[:x.shape[0]] = x
    parts = [torch.empty_like(pad) for _ in range(world)]
    dist.all_gather(parts, pad, group=group)
    return torch.cat([p[:c] for p, c in zip(parts, counts)])
