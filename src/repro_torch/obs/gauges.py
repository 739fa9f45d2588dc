"""Round gauges (port of `repro/obs/gauges.py`).

Every gauge in the first part is PURE: it reads the resident (m, d_flat)
buffer or the (m,) push-sum weights and returns 0-d f32 tensors on their
device, never touching the state that flows on, so a round with
telemetry on leaves its state bit for bit what it is with telemetry off.
`to_host` fetches a round's gauges in one device sync.

The host-side meters at the bottom (wire-byte arithmetic, device memory)
are the one source both runtimes' accounting reads.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..analysis.scope import scope
from ..compress.codecs import MU_BYTES
from ..core import pushsum
from ..core.topology import SparseTopology


# ---------------------------------------------------------------------------
# gauges (pure reads)
# ---------------------------------------------------------------------------
def consensus_gap(flat: torch.Tensor, mu: torch.Tensor) -> dict:
    """De-biased row distance to the mass-weighted mean: mean / max over
    clients of ||u_i / mu_i - sum_j u_j / sum_j mu_j||_2, in f32 — the
    runtime face of the graph's connectivity term."""
    u = flat.to(torch.float32)
    z = u / mu[:, None].to(torch.float32)
    z_bar = torch.sum(u, dim=0) / torch.sum(mu).to(torch.float32)
    d = torch.sqrt(torch.sum(torch.square(z - z_bar[None, :]), dim=1))
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


def buffer_update_norm(flat_before: torch.Tensor,
                       flat_after: torch.Tensor) -> torch.Tensor:
    """Frobenius norm of the local-phase displacement of the buffer, f32."""
    d = flat_after.to(torch.float32) - flat_before.to(torch.float32)
    return torch.linalg.vector_norm(d)


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
