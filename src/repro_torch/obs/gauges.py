"""Round gauges (port of `repro/obs/gauges.py`).

Every gauge in the first part is PURE: it reads the resident (m, d_flat)
buffer or the (m,) push-sum weights and returns 0-d f32 tensors on their
device, never touching the state that flows on, so a round with
telemetry on leaves its state bit for bit what it is with telemetry off.
`to_host` fetches a round's gauges in one device sync.

Across the ranks of a client mesh (`launch/`) each rank holds a block of
the buffer's rows, or its columns of them; the `*_ranks` gauges take a
rank's share and its `RankGroups` and reduce each term where it is split:
rows over the data group, split columns over the model group, each
exactly once.

The host-side meters at the bottom (wire-byte arithmetic, device memory)
are the one source both runtimes' accounting reads.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..analysis.scope import scope
from ..compress.codecs import MU_BYTES
from ..core import pushsum
from ..core.topology import SparseTopology


# ---------------------------------------------------------------------------
# gauges (pure reads)
# ---------------------------------------------------------------------------
# elements of a gauge's f32 temporaries at a time: the (m, d_flat) buffer
# of qwen2-0.5b at full width (m 4) is 7.36 GiB in f32, and its gauges
# whole held two or three such temporaries beside the round's state
GAUGE_CHUNK = 1 << 27


def _column_slices(x: torch.Tensor) -> list:
    """Slices of x's last dim, each at most GAUGE_CHUNK elements over all
    of x's rows; one slice, the whole of x, below that (the gauges then
    run the same arithmetic as unchunked)."""
    d = x.shape[-1]
    rows = max(1, x.numel() // max(1, d))
    w = max(1, GAUGE_CHUNK // rows)
    return [slice(lo, min(lo + w, d)) for lo in range(0, d, w)] \
        or [slice(0, d)]


def _gap_squares(u: torch.Tensor, mu: torch.Tensor,
                 z_bar: torch.Tensor) -> torch.Tensor:
    """(rows,) f32 sums over the columns of (u_i / mu_i - z_bar)^2, chunk
    by chunk (`_column_slices`)."""
    mu32 = mu[:, None].to(torch.float32)
    ss = None
    for s in _column_slices(u):
        z = u[:, s].to(torch.float32) / mu32
        part = torch.sum(torch.square(z - z_bar[None, s]), dim=1)
        ss = part if ss is None else ss + part
    return ss


def sum_squares(x: torch.Tensor, dim=None) -> torch.Tensor:
    """The f32 sum of squares of x, over everything or (dim = the last
    dim) each row, chunk by chunk (`_column_slices`)."""
    if x.dim() == 0 or (dim is not None and dim not in (-1, x.dim() - 1)):
        return torch.sum(torch.square(x.to(torch.float32)), dim)
    out = None
    for s in _column_slices(x):
        sq = torch.square(x[..., s].to(torch.float32))
        part = torch.sum(sq) if dim is None else torch.sum(sq, dim)
        out = part if out is None else out + part
    return out


def consensus_gap(flat: torch.Tensor, mu: torch.Tensor) -> dict:
    """De-biased row distance to the mass-weighted mean: mean / max over
    clients of ||u_i / mu_i - sum_j u_j / sum_j mu_j||_2, in f32 — the
    runtime face of the graph's connectivity term."""
    z_bar = torch.sum(flat, dim=0, dtype=torch.float32) / \
        torch.sum(mu).to(torch.float32)
    d = torch.sqrt(_gap_squares(flat, mu, z_bar))
    return {"consensus_gap_mean": torch.mean(d),
            "consensus_gap_max": torch.max(d)}


def mass_ledger(mu: torch.Tensor, active_mask=None, *in_flight_mus) -> dict:
    """The push-sum mass ledger: (active, dormant, in-flight, total)
    components of the conserved sum(mu) (`pushsum.mass_split`).
    active_mask=None means everything is active; in_flight_mus are the
    async runtime's mailbox components."""
    if active_mask is None:
        active_mask = torch.ones(mu.shape, dtype=torch.bool,
                                 device=mu.device)
    active, dormant, flight = pushsum.mass_split(mu, active_mask,
                                                 *in_flight_mus)
    return {"mass_active": active, "mass_dormant": dormant,
            "mass_in_flight": flight,
            "mass_total": active + dormant + flight}


def ef_signal_ratio(flat: torch.Tensor, ef: torch.Tensor) -> torch.Tensor:
    """||u|| / (||u|| + ||ef||) in f32, in (0, 1]: 1.0 means the codec pipe
    keeps up (zero residual); a falling ratio means the wire drops value
    faster than it drains.  The same expression
    `DFedPGP(codec_gamma="auto")` reads."""
    un = torch.linalg.vector_norm(flat.to(torch.float32))
    en = torch.linalg.vector_norm(ef.to(torch.float32))
    eps = 1e-12
    return (un + eps) / (un + en + eps)


def l2_norm(x: torch.Tensor, dim=None) -> torch.Tensor:
    """sqrt of the f32 sum of squares (over `dim`, default all), as the
    reference's `jnp.linalg.norm`: torch's CPU `vector_norm` accumulates
    less exactly (1.2e-4 relative at 1.3M elements, reduced()
    qwen2-0.5b's update of four clients)."""
    return torch.sqrt(sum_squares(x, dim))


def buffer_update_norm(flat_before: torch.Tensor,
                       flat_after: torch.Tensor) -> torch.Tensor:
    """Frobenius norm of the local-phase displacement of the buffer, f32."""
    return torch.sqrt(_update_squares(flat_before, flat_after))


def _update_squares(before: torch.Tensor,
                    after: torch.Tensor) -> torch.Tensor:
    """The f32 sum of (after - before)^2, chunk by chunk."""
    out = None
    for s in _column_slices(after):
        d = after[..., s].to(torch.float32) - before[..., s].to(torch.float32)
        part = torch.sum(torch.square(d))
        out = part if out is None else out + part
    return out


def wire_edges(P, fired: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Count of directed non-self edges carrying a payload (0-d int32).
    `fired` restricts to edges whose sender fired (the async form)."""
    if isinstance(P, SparseTopology):
        idx = P.idx.long()
        rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
        mask = (idx != rows) & (P.w > 0)
        if fired is not None:
            mask = fired[idx] & mask
        return torch.sum(mask).to(torch.int32)
    m = P.shape[0]
    mask = (P > 0) & ~torch.eye(m, dtype=torch.bool, device=P.device)
    if fired is not None:
        mask = mask & fired[None, :]
    return torch.sum(mask).to(torch.int32)


def staleness_gauges(local_round: torch.Tensor) -> dict:
    """Per-client lag behind the fleet's head (async runtime):
    lag_i = max_j local_round_j - local_round_i, mean and max."""
    lr = local_round.to(torch.float32)
    lag = torch.max(lr) - lr
    return {"staleness_mean": torch.mean(lag),
            "staleness_max": torch.max(lag)}


def mailbox_gauges(slots_mu: torch.Tensor, inbox_mu: torch.Tensor) -> dict:
    """Mailbox occupancy (async runtime): the fraction of (slot, receiver)
    cells and inbox rows holding mass, and the mu mass in each."""
    return {
        "mailbox_slot_occupancy": torch.mean((slots_mu > 0.0)
                                             .to(torch.float32)),
        "mailbox_inbox_occupancy": torch.mean((inbox_mu > 0.0)
                                              .to(torch.float32)),
        "mailbox_slot_mass": torch.sum(slots_mu),
        "mailbox_inbox_mass": torch.sum(inbox_mu),
    }


# ---------------------------------------------------------------------------
# gauges across the ranks of a client mesh (pure reads, then collectives)
# ---------------------------------------------------------------------------
class RankGroups(NamedTuple):
    """Where a client-mesh rank's share of a gauge reduces
    (`launch.steps.RankRound`).  The rank is data index `index` of the
    data group `data` (`world` data indices, index q at global rank
    peers[q]), holding the rows [index n_rows, (index + 1) n_rows) of
    the buffer.  `model`: its model group (None at T = 1); the buffer's
    terms sum over it only where `columns` (the rank holds a split of each
    row; with whole rows a sum would count every term T times).  Personal
    leaves are shards or, where the plan keeps them whole (`replicated`
    paths), counted on model index 0 alone (`first`)."""
    data: Any
    model: Any
    columns: bool
    world: int
    index: int
    n_rows: int
    peers: tuple
    first: bool
    replicated: frozenset


def _reduced(x: torch.Tensor, group, op=None) -> torch.Tensor:
    """A reduced copy of x over `group` (sum, or `op`)."""
    import torch.distributed as dist
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM if op is None else op,
                    group=group)
    return out


def sum_rows(x: torch.Tensor, groups: RankGroups) -> torch.Tensor:
    """x summed over the data group (terms of every rank's rows)."""
    return _reduced(x, groups.data)


def sum_columns(x: torch.Tensor, groups: RankGroups) -> torch.Tensor:
    """Sums over the rank's buffer columns -> over the whole rows."""
    return _reduced(x, groups.model) if groups.columns else x


def sum_shards(x: torch.Tensor, groups: RankGroups) -> torch.Tensor:
    """Sums over the rank's personal shards -> over the whole leaves."""
    return x if groups.model is None else _reduced(x, groups.model)


def mean_ranks(x: torch.Tensor, n: int, groups: RankGroups) -> torch.Tensor:
    """The data group's sum of x (each rank's sum over its clients) over
    n, the clients of all ranks."""
    return sum_rows(x, groups) / n


def max_ranks(x: torch.Tensor, groups: RankGroups) -> torch.Tensor:
    """The elementwise max of x over the data group."""
    import torch.distributed as dist
    return _reduced(x, groups.data, dist.ReduceOp.MAX)


def consensus_gap_ranks(flat: torch.Tensor, mu: torch.Tensor,
                        groups: RankGroups) -> dict:
    """`consensus_gap` of the whole buffer from a rank's block: z_bar from
    the data group's column sums of u and its sum of mu; each row's
    squared distance summed over the split columns before the square
    root; the mean and max over the data group."""
    z_bar = sum_rows(torch.sum(flat, dim=0, dtype=torch.float32),
                     groups) / \
        sum_rows(torch.sum(mu).to(torch.float32), groups)
    d = torch.sqrt(sum_columns(_gap_squares(flat, mu, z_bar), groups))
    return {"consensus_gap_mean": mean_ranks(torch.sum(d),
                                             groups.world * groups.n_rows,
                                             groups),
            "consensus_gap_max": max_ranks(torch.max(d), groups)}


def update_norm_ranks(flat_before: torch.Tensor, flat_after: torch.Tensor,
                      groups: RankGroups) -> torch.Tensor:
    """`buffer_update_norm` of the rows of every rank (none on some, in a
    sampled round): the squares summed over both groups."""
    return torch.sqrt(sum_columns(sum_rows(
        _update_squares(flat_before, flat_after), groups), groups))


def to_host(values: dict) -> dict:
    """{name: 0-d tensor or Python scalar} -> {name: Python scalar}, with
    ONE device sync: the card's tensors are stacked in f64 (exact for f32
    and int32 values) and copied over once; integer and bool tensors come
    back as int and bool.  Entries that are not scalars are dropped.
    Runs inside the analyzer's scope "obs.to_host", the reviewed
    telemetry boundary of its host-sync check."""
    with scope("obs.to_host"):
        return _to_host(values)


def _to_host(values: dict) -> dict:
    out, on_card = {}, []
    for k, v in values.items():
        if isinstance(v, torch.Tensor):
            if v.dim() == 0:
                if v.is_cuda:
                    on_card.append((k, v))
                else:
                    out[k] = v.item()
        elif v is None or np.ndim(v) == 0:
            out[k] = v
    if on_card:
        host = torch.stack([v.to(torch.float64)
                            for _, v in on_card]).cpu().tolist()
        for (k, v), x in zip(on_card, host):
            if v.dtype == torch.bool:
                out[k] = bool(x)
            elif not v.dtype.is_floating_point:
                out[k] = int(x)
            else:
                out[k] = x
    return {k: out[k] for k in values if k in out}


# ---------------------------------------------------------------------------
# wire-byte arithmetic (host-side; the one source both runtimes read)
# ---------------------------------------------------------------------------
def payload_row_bytes(codec, d_wire: int) -> int:
    """Bytes one client payload costs on the wire: the codec's metered row
    size, or the uncompressed f32 row + the mu scalar."""
    if codec is not None:
        return int(codec.row_bytes(d_wire))
    return 4 * d_wire + MU_BYTES


def bootstrap_bytes(codec, m: int, d_wire: int) -> int:
    """Reference-bootstrap cost of a lossy codec: first contact ships one
    full-fidelity f32 row per client (compress.init_ref).  Exact or absent
    codecs cost zero."""
    if codec is None or codec.exact:
        return 0
    return m * 4 * d_wire


def edge_count(P) -> int:
    """The number of payload-carrying directed non-self edges (positive
    weight) of a concrete round topology — a SparseTopology or a dense
    (m, m) matrix."""
    if isinstance(P, SparseTopology):
        rows = torch.arange(P.idx.shape[0], device=P.idx.device)[:, None]
        return int(((P.w > 0) & (P.idx.long() != rows)).sum())
    eye = torch.eye(P.shape[0], dtype=torch.bool, device=P.device)
    return int(((P > 0) & ~eye).sum())


# ---------------------------------------------------------------------------
# device-memory meters
# ---------------------------------------------------------------------------
def peak_device_memory():
    """Peak bytes allocated on the current CUDA device
    (`torch.cuda.max_memory_allocated`), or None without a GPU or before
    any allocation — callers pair it with the deterministic
    `accounted_bytes`."""
    if not torch.cuda.is_available():
        return None
    peak = torch.cuda.max_memory_allocated()
    return int(peak) if peak else None


def accounted_bytes(*arrays) -> int:
    """Deterministic memory meter: total bytes of the given tensors or
    numpy arrays (lists and tuples are walked one level)."""
    total = 0
    for a in arrays:
        leaves = a if isinstance(a, (list, tuple)) else [a]
        for x in leaves:
            if isinstance(x, torch.Tensor):
                total += x.numel() * x.element_size()
            else:
                total += int(x.size) * int(x.dtype.itemsize)
    return total
