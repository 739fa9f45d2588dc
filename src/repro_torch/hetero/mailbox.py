"""Delayed push-sum mailboxes: in-flight mass as stacked tensors (port of
`repro/hetero/mailbox.py`).

When a client fires a directed push it moves ALL of its push-sum mass (the
biased flat row u_i and the weight mu_i, self share included) into per-edge
mailboxes; each edge's message arrives after a per-edge delay.  Receivers
drain arrived mail when they wake for a new local round.  Mass only moves
(client -> slot -> inbox -> client), so the total push-sum weight
sum_i mu_i + (mu in flight) is conserved at every tick for any delay trace.

Representation:

- `slots_flat (D, m, d_flat)` / `slots_mu (D, m)` — a ring of D delivery
  ticks: a push fired at tick t with per-edge delay delta in [0, D-1]
  accumulates into slot (t + 1 + delta) mod D, addressed to the receiving
  client's row.
- `inbox_flat (m, d_flat)` / `inbox_mu (m,)` — arrived, not yet drained.
  Every tick slot (t mod D) is flushed into the inbox, which holds the mass
  until the recipient wakes, so a sleeping client loses no mail to ring
  reuse.

The tick index is a host int, so the slot arithmetic runs on the host.
The functions return new mailboxes and never write their inputs.  The
accumulation of one delay group is one edge-gated `gossip.mix_flat` — one
`kernels.ops.gossip_gather` launch for an f32 buffer on a GPU; a codec
fire's sparse payloads add one `kernels.ops.topk_gather` launch per group.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import gossip
from ..core.topology import SparseTopology
from ..kernels import ops


class Mailbox(NamedTuple):
    slots_flat: torch.Tensor   # (D, m, d_flat) — mass arriving at later ticks
    slots_mu: torch.Tensor     # (D, m) f32
    inbox_flat: torch.Tensor   # (m, d_flat) — arrived, awaiting drain
    inbox_mu: torch.Tensor     # (m,) f32

    @property
    def depth(self) -> int:
        return self.slots_flat.shape[0]


def create(m: int, d_flat: int, depth: int, dtype=torch.float32,
           device="cpu") -> Mailbox:
    """Empty mailbox.  depth = max supported edge delay + 1."""
    if depth < 1:
        raise ValueError(f"mailbox depth must be >= 1, got {depth}")
    return Mailbox(
        torch.zeros((depth, m, d_flat), dtype=dtype, device=device),
        torch.zeros((depth, m), dtype=torch.float32, device=device),
        torch.zeros((m, d_flat), dtype=dtype, device=device),
        torch.zeros((m,), dtype=torch.float32, device=device))


def flush(mail: Mailbox, tick: int) -> Mailbox:
    """Deliver slot (tick mod D) into the inbox and clear it — run at the
    START of every tick, before any push writes slot (tick + D) mod D."""
    slot = int(tick) % mail.depth
    slots_flat, slots_mu = mail.slots_flat.clone(), mail.slots_mu.clone()
    slots_flat[slot] = 0.0
    slots_mu[slot] = 0.0
    return Mailbox(
        slots_flat, slots_mu,
        mail.inbox_flat + mail.slots_flat[slot].to(mail.inbox_flat.dtype),
        mail.inbox_mu + mail.slots_mu[slot])


def _check_push(mail: Mailbox, P, n_groups) -> int:
    if not isinstance(P, SparseTopology):
        raise ValueError("mailbox push needs a SparseTopology (per-edge "
                         "delays have no dense-matrix form)")
    n_groups = mail.depth if n_groups is None else n_groups
    if not 1 <= n_groups <= mail.depth:
        raise ValueError(f"n_groups {n_groups} outside [1, depth="
                         f"{mail.depth}]")
    return n_groups


def push(mail: Mailbox, P: SparseTopology, flat: torch.Tensor,
         mu: torch.Tensor, fired: torch.Tensor, edge_delay: torch.Tensor,
         tick: int, *, mode: str = "sparse",
         n_groups: int | None = None) -> Mailbox:
    """Accumulate the firing clients' outgoing mass into the ring.

    fired: (m,) bool — the senders that push this tick (a sender pushes its
    whole mass; the caller zeroes their u and mu afterwards).  edge_delay:
    (m, k) int in [0, n_groups-1] per RECEIVING edge — entry [i, j] delays
    the message from in-neighbor idx[i, j] to i.  Delay group delta adds
    sum_j w[i,j] * 1[delay==delta] * 1[fired[idx[i,j]]] * u[idx[i,j]] to
    slot (tick + 1 + delta) mod D: one edge-gated `mix_flat` per group.
    n_groups (default depth): the delay groups that can occur — each costs
    a full gated mix, so a caller whose delays are bounded below the ring
    depth passes the bound.  Delays >= n_groups are dropped: clamp them."""
    n_groups = _check_push(mail, P, n_groups)
    fired_g = fired[P.idx.long()]                          # (m, k)
    slots_flat, slots_mu = mail.slots_flat.clone(), mail.slots_mu.clone()
    for delta in range(n_groups):
        gate = (fired_g & (edge_delay == delta)).to(P.w.dtype)
        got_f, got_mu = gossip.mix_flat(P, flat, mu, mode=mode,
                                        edge_gate=gate)
        slot = (int(tick) + 1 + delta) % mail.depth
        slots_flat[slot] += got_f.to(slots_flat.dtype)
        slots_mu[slot] += got_mu
    return Mailbox(slots_flat, slots_mu, mail.inbox_flat, mail.inbox_mu)


def push_payload(mail: Mailbox, P: SparseTopology, flat: torch.Tensor,
                 ef_prev, ref_prev, ref_new, payload, mu: torch.Tensor,
                 fired: torch.Tensor, edge_delay: torch.Tensor, tick: int,
                 *, mode: str = "sparse",
                 n_groups: int | None = None) -> Mailbox:
    """`push` for compressed fires: only the wire edges ship codec
    payloads.  The sender's self share never leaves the machine, so it
    enters the ring at full fidelity at delay 0 together with its
    accumulated residual ef; every non-self edge carries the sender's
    updated public reference ref' (the caller ran `compress.publish` ONCE
    for the fire — never once per group, which would consume the codec
    memory once per group):

        slot += w_self * flat + ef   (self edges, exact, delay 0)
        slot += w[i,j] * ref'[j]     (non-self edges, per delay group)

    mu is never compressed: each group moves sum_j w[i,j]*gate*mu_j as
    `push` does.  Under mode="pallas" a sparse payload splits linearly,
    w @ ref' = w @ ref + w @ decode(p): `kernels.ops.gossip_gather` over
    ref_prev plus `kernels.ops.topk_gather` over the payload, one launch
    each per group; otherwise `gossip.mix_any` over ref_new."""
    n_groups = _check_push(mail, P, n_groups)
    d = mail.slots_flat.shape[2]
    m = flat.shape[0]
    idx = P.idx.long()
    fired_g = fired[idx]                                   # (m, k)
    rows = torch.arange(m, device=idx.device)[:, None]
    w_wire = torch.where(idx == rows, 0.0, P.w)
    use_kernel = (mode == "pallas" and payload.indices is not None
                  and not gossip.no_sparsity(P))
    slots_flat, slots_mu = mail.slots_flat.clone(), mail.slots_mu.clone()
    # the self share and the re-absorbed residual: full fidelity, delay 0
    # (the runtime forces self edges to delay 0)
    sw = gossip.self_weight_of(P)
    self_contrib = torch.where(fired[:, None],
                               sw[:, None] * flat.to(torch.float32)
                               + ef_prev, 0.0)
    slots_flat[(int(tick) + 1) % mail.depth] += self_contrib.to(
        slots_flat.dtype)
    for delta in range(n_groups):
        gate = (fired_g & (edge_delay == delta)).to(P.w.dtype)
        wg = w_wire * gate
        if use_kernel:
            got_f = ops.gossip_gather(P.idx, wg, ref_prev) \
                + ops.topk_gather(P.idx, wg, payload.values.float(),
                                  payload.indices, d)
        else:
            got_f = gossip.mix_any(SparseTopology(P.idx, wg),
                                   ref_new.to(torch.float32))
        # mu: uncompressed over the full edge set (self included)
        got_mu = gossip.mix_any(SparseTopology(P.idx, P.w * gate), mu)
        slot = (int(tick) + 1 + delta) % mail.depth
        slots_flat[slot] += got_f.to(slots_flat.dtype)
        slots_mu[slot] += got_mu
    return Mailbox(slots_flat, slots_mu, mail.inbox_flat, mail.inbox_mu)


def drain(mail: Mailbox, who: torch.Tensor):
    """Hand the inbox rows of `who` (m,) bool to their recipients ->
    (mail', got_flat (m, d_flat), got_mu (m,)); the got rows are zero for
    clients that do not drain, so the caller adds unconditionally."""
    w = who[:, None]
    got_flat = torch.where(w, mail.inbox_flat, 0.0)
    got_mu = torch.where(who, mail.inbox_mu, 0.0)
    return Mailbox(mail.slots_flat, mail.slots_mu,
                   torch.where(w, 0.0, mail.inbox_flat),
                   torch.where(who, 0.0, mail.inbox_mu)), got_flat, got_mu


def in_flight(mail: Mailbox):
    """Per-recipient pending mass (slots + inbox) -> (flat, mu): what eval
    and the mass diagnostics credit to each client."""
    return (mail.slots_flat.sum(0).to(mail.inbox_flat.dtype)
            + mail.inbox_flat, mail.slots_mu.sum(0) + mail.inbox_mu)


def mass(mail: Mailbox) -> torch.Tensor:
    """Total push-sum weight in flight (0-d f32)."""
    return mail.slots_mu.sum() + mail.inbox_mu.sum()
