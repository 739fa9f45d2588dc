"""AsyncRuntime: the tick engine tying clock, mailbox and resident buffer
(port of `repro/hetero/runtime.py`).

One `tick` advances the whole population by one virtual time slice:

1. flush — the mailbox slot whose delivery time has come moves to the
   inbox;
2. wake  — active = next-event time arrived AND available (AND sampled,
   under a participation gate) AND holding or owed positive push-sum
   mass.  Clients at phase 0 of their local round drain their inbox: mass
   merges only at round boundaries;
3. step  — every client computes ONE alternating step
   (`DFedPGP.tick_update_flat`) and the active rows take it;
4. fire  — clients completing step k_v + k_u push their whole mass (self
   share at delay 0) into the mailbox along the tick's directed topology
   and zero their u and mu; their local-round counter and lr decay
   advance;
5. clock — acting clients are charged their step cost.

The reference's `lax.cond(any(fired), ...)` is a host branch on
`bool(fired.any())`: one device sync per tick, and a tick where nobody
fires launches no kernel.  The fire launches one `gossip_gather` per delay
group (`profile_groups`), and a lossy codec fire one `topk_gather` more
per group under gossip="pallas".  The tick steps every client and selects
the active rows, as the reference's vmap does.  With `algo.telemetry` the
tick's metrics add the reference's gauges (in-flight-aware consensus gap,
mass ledger with the mailbox, staleness, mailbox occupancy, update norm,
EF ratio, moved mass over the fired senders): pure reads, so the state is
bit for bit the telemetry-off state.

Contracts (tests/test_torch_async.py): under the uniform profile with
zero delay the tick trajectory is bit for bit the resident sync path
`round_fn_flat` on the same batches and tables; sum(mu) + mailbox mass is
constant at every tick for any delay trace.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .. import tree
from ..analysis.scope import scope
from ..core import gossip, pushsum
from ..core.dfedpgp import CODEC_STREAM, DFedPGP
from ..core.topology import SparseTopology
from ..compress import feedback
from ..device import resolve_device, seeded_generator
from ..obs import gauges
from ..obs import graph as obs_graph
from ..optim import SGDState
from . import clock as vclock
from . import mailbox as mbox
from .profiles import ClientProfile, validate_profile


class AsyncState(NamedTuple):
    flat: torch.Tensor          # (m, d_flat) biased shared buffer u
    personal: dict              # personal leaves (m, ...)
    mu: torch.Tensor            # (m,) f32 push-sum weights (local share)
    opt_u: SGDState             # (m, d_flat) momentum buffer
    opt_v: SGDState             # personal-leaf momentum tree
    phase: torch.Tensor         # (m,) int32 in [0, k_v + k_u)
    local_round: torch.Tensor   # (m,) int32 completed local rounds
    clock: vclock.ClockState
    mail: mbox.Mailbox
    # wire-codec memory: (m, d_flat) f32 for lossy codecs, else None
    ef: Optional[torch.Tensor] = None
    ref: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True, eq=False)
class AsyncRuntime:
    """Per-experiment engine: (algorithm, layout, profile, mailbox depth).
    Build with `AsyncRuntime.build(algo, stacked_params, profile)`, drive
    with a host loop over `tick`, read models with `eval_params`."""
    algo: DFedPGP
    layout: gossip.FlatLayout
    profile: ClientProfile      # on the buffer's device
    depth: int = 4              # mailbox ring depth = max edge delay + 1
    # the delay groups the profile can produce (max push_delay + 1): each
    # costs one gated mix per fire, so a fire loops over this bound
    profile_groups: int = 1
    # lr decay by completed local round: `DFedPGP._lr_scale` of each round
    # number, so a client at round r steps with the bit-identical scale of
    # sync round r (a vectorized pow can differ by an ulp from the 0-d one)
    _lr_table: list = dataclasses.field(default_factory=list, repr=False)

    @classmethod
    def build(cls, algo: DFedPGP, stacked_params: dict,
              profile: ClientProfile, depth: int = 4, device="cuda"):
        """-> (runtime, state) on `device`.  Packs the shared part once and
        validates the profile against the client count."""
        if algo.mix_fn is not None or algo.mix_fn_flat is not None:
            raise ValueError("mix_fn/mix_fn_flat overrides are sync "
                             "round-level features; the async runtime "
                             "mixes through the mailbox")
        if isinstance(algo.codec_gamma, str):
            raise ValueError(
                "codec_gamma='auto' anneals per sync round from the "
                "round's working set; the async tick has no such "
                "boundary — use a static gamma")
        dev = resolve_device(device)
        fstate, layout = algo.init_flat(stacked_params, device=dev)
        m = fstate.mu.shape[0]
        validate_profile(profile, m)
        need = int(torch.as_tensor(profile.push_delay).max()) + 1
        if depth < need:
            raise ValueError(
                f"mailbox depth {depth} < max profile push_delay + 1 "
                f"({need}): late mail would alias onto earlier slots")
        state = AsyncState(
            flat=fstate.flat, personal=fstate.personal, mu=fstate.mu,
            opt_u=fstate.opt_u, opt_v=fstate.opt_v,
            phase=torch.zeros((m,), dtype=torch.int32, device=dev),
            local_round=torch.zeros((m,), dtype=torch.int32, device=dev),
            clock=vclock.init_clock(m, dev),
            mail=mbox.create(m, layout.d_flat, depth, fstate.flat.dtype,
                             dev),
            ef=fstate.ef, ref=fstate.ref)
        return cls(algo, layout, profile.to(dev), depth, need), state

    @property
    def k_total(self) -> int:
        return self.algo.k_v + self.algo.k_u

    def _mix_mode(self) -> str:
        # the mailbox's gated groups ride the sparse engine; "pallas"
        # keeps meaning the f32-accumulate kernel
        return "pallas" if self.algo.gossip == "pallas" else "sparse"

    def _lr_scale(self, local_round: torch.Tensor, t: int) -> torch.Tensor:
        """(m,) lr decay of each client's completed rounds.  A client
        completes at most one round per k_total ticks, so rounds <= t //
        k_total index the table."""
        need = t // self.k_total + 1
        dev = local_round.device
        while len(self._lr_table) < need:
            # the round number is filled on the device, not uploaded
            r = torch.full((), len(self._lr_table), dtype=torch.int32,
                           device=dev)
            self._lr_table.append(self.algo._lr_scale(r))
        table = torch.stack(self._lr_table[:need])
        return table[local_round.long()]

    # ------------------------------------------------------------------
    def tick(self, state: AsyncState, P: SparseTopology, batches: dict,
             edge_delay: Optional[torch.Tensor] = None,
             participation: Optional[torch.Tensor] = None):
        """One virtual time slice.  batches: leaves (m, B, ...) — one
        step's minibatch per client (only active clients consume theirs).
        P: the tick's directed pattern (a SparseTopology on the state's
        device: per-edge delays need edge identity).  edge_delay: optional
        (m, k) int override of the profile's delays, values in
        [0, depth-1] (entry [i, j] delays the message from in-neighbor
        idx[i, j] to i; self edges are forced to 0).  participation:
        optional (m,) bool sampler gate AND-ed into the clock's mask: a
        gated-off client neither steps nor fires, its mu freezes, and mass
        fired at it waits in its inbox.  -> (state', metrics): 0-d tensors
        loss, n_active, n_fired, wire_edges, mass_total, vtime, and the
        gauges with telemetry."""
        if not isinstance(P, SparseTopology):
            raise ValueError("async ticks need a SparseTopology topology")
        algo, prof = self.algo, self.profile
        m = state.mu.shape[0]
        t = state.clock.t

        # 1. deliver the mail whose time has come (the ring slot is a
        # function of the host tick index)
        with scope("async.host_clock"):
            mail = mbox.flush(state.mail, t)

        # 2. wake: time arrived, available, and owns (or is owed, the owed
        # part already delivered) positive push-sum mass
        with scope("async.host_clock"):
            time_ok = vclock.active_mask(state.clock, prof)
        if participation is not None:
            time_ok = time_ok & participation
        active = time_ok & ((state.mu + mail.inbox_mu) > 0.0)
        starters = active & (state.phase == 0)
        mail, got_f, got_mu = mbox.drain(mail, starters)
        flat = state.flat + got_f.to(state.flat.dtype)
        mu = state.mu + got_mu
        flat_pre_step = flat   # post-drain view (update gauge)

        # 3. one alternating step, taken by the active rows
        lr_scale = self._lr_scale(state.local_round, t)
        in_v = state.phase < algo.k_v
        flat2, personal2, ou2, ov2, loss = algo.tick_update_flat(
            flat, state.personal, mu, state.opt_u, state.opt_v, batches,
            in_v, lr_scale, self.layout, algo.k_v > 0)

        def sel(n, o):
            return torch.where(active.reshape((-1,) + (1,) * (n.dim() - 1)),
                               n, o)
        flat = sel(flat2, flat)
        flat_stepped = flat
        personal = tree.tree_map(sel, personal2, state.personal)
        opt_u = SGDState(sel(ou2.momentum, state.opt_u.momentum))
        opt_v = SGDState(tree.tree_map(sel, ov2.momentum,
                                       state.opt_v.momentum))
        phase = torch.where(active, state.phase + 1, state.phase)
        fired = active & (phase >= self.k_total)
        phase = torch.where(fired, 0, phase).to(torch.int32)
        local_round = torch.where(fired, state.local_round + 1,
                                  state.local_round).to(torch.int32)

        # 4. fire: push the whole mass (self share at delay 0).  An
        # explicit edge_delay may use the whole ring; the profile's delays
        # are bounded by profile_groups
        groups = self.depth if edge_delay is not None else \
            self.profile_groups
        idx = P.idx.long()
        if edge_delay is None:
            edge_delay = prof.push_delay[idx]
        edge_delay = torch.clamp(edge_delay.to(torch.int32), 0, groups - 1)
        self_edge = idx == torch.arange(m, device=idx.device)[:, None]
        edge_delay = torch.where(self_edge, 0, edge_delay)
        ef, ref = state.ef, state.ref
        lossy = algo.codec is not None and not algo.codec.exact
        if lossy:
            P = self._gamma_blend(P)
        # one device sync: a tick where nobody fires launches no kernel
        with scope("async.fire_gate"):
            any_fired = bool(fired.any())
        if any_fired:
            with scope("async.fire"):
                if lossy:
                    mail, ef, ref = self._fire_codec(
                        mail, P, flat, mu, fired, edge_delay, t, groups, ef,
                        ref)
                else:
                    mail = mbox.push(mail, P, flat, mu, fired, edge_delay,
                                     t, mode=self._mix_mode(),
                                     n_groups=groups)
        mu_at_fire = mu       # pre-zeroing mu: the mass each fire pushed
        flat = torch.where(fired[:, None], 0.0, flat).to(state.flat.dtype)
        mu = torch.where(fired, 0.0, mu)

        # 5. charge virtual time
        clk = vclock.advance(state.clock, active, prof)

        n_active = active.sum()
        # payload-carrying directed non-self edges: the wire-bytes unit
        nonself = ~self_edge & (P.w > 0)
        with scope("async.host_clock"):
            vtime = torch.tensor(float(clk.t), dtype=torch.float32)
        metrics = {
            "loss": torch.where(active, loss, 0.0).sum()
            / torch.clamp(n_active, min=1).to(loss.dtype),
            "n_active": n_active,
            "n_fired": fired.sum(),
            "wire_edges": (fired[idx] & nonself).sum(),
            "mass_total": pushsum.total_mass(mu, mbox.mass(mail)),
            "vtime": vtime,
        }
        if algo.telemetry:
            # in-flight-aware de-bias (eval_params' accounting): a fired
            # client's mass, self share included, sits in the mailbox
            mail_f, mail_mu = mbox.in_flight(mail)
            metrics.update(gauges.consensus_gap(
                flat + mail_f.to(flat.dtype), mu + mail_mu))
            metrics.update(gauges.mass_ledger(mu, active, mbox.mass(mail)))
            metrics.update(gauges.staleness_gauges(local_round))
            metrics.update(gauges.mailbox_gauges(mail.slots_mu,
                                                 mail.inbox_mu))
            metrics["update_norm"] = gauges.buffer_update_norm(
                flat_pre_step, flat_stepped)
            if state.ef is not None:
                metrics["ef_ratio"] = gauges.ef_signal_ratio(
                    flat_pre_step, state.ef)
            # over the table the fires rode (gamma-blended under a lossy
            # codec)
            metrics["moved_mass"] = obs_graph.moved_mass(P, mu_at_fire,
                                                         fired=fired)
        return AsyncState(flat, personal, mu, opt_u, opt_v, phase,
                          local_round, clk, mail, ef, ref), metrics

    def _gamma_blend(self, P: SparseTopology) -> SparseTopology:
        """The lossy codec's consensus step g: fires ride
        P_g = (1-g) I + g P, still column-stochastic (the extra 1-g sits
        on each row's self slots)."""
        g = float(self.algo.codec_gamma)
        if g == 1.0:
            return P
        idx = P.idx.long()
        is_self = idx == torch.arange(P.m, device=idx.device)[:, None]
        cnt = torch.clamp(is_self.sum(1, keepdim=True), min=1)
        return SparseTopology(P.idx, g * P.w + (1.0 - g) * is_self / cnt)

    def _fire_codec(self, mail, P, flat, mu, fired, edge_delay, t, groups,
                    ef0, ref0):
        """A lossy codec fire over the blended P: the firing rows cross the
        wire once (`compress.publish`, error feedback consumed and
        refilled), and the mailbox takes the self shares exactly and the
        updated references on the wire edges (`mailbox.push_payload`).
        -> (mail, ef, ref)."""
        codec = self.algo.codec
        key = None
        if codec.draws:
            key = seeded_generator(codec.seed, CODEC_STREAM, t, flat.device)
        # the self share never rides the wire: only the wire fraction of
        # the residual is refreshed
        wire_frac = 1.0 - gossip.self_weight_of(P)
        payload, ef2, ref2 = feedback.publish(codec, ef0, ref0, flat, key,
                                              wire_frac=wire_frac)
        # only the firing clients transmit: their codec memory is consumed
        # and refilled, everyone else keeps theirs
        ef1 = torch.where(fired[:, None], ef2, ef0)
        ref1 = torch.where(fired[:, None], ref2, ref0)
        mail = mbox.push_payload(mail, P, flat, ef0, ref0, ref1, payload,
                                 mu, fired, edge_delay, t,
                                 mode=self._mix_mode(), n_groups=groups)
        return mail, ef1, ref1

    # ------------------------------------------------------------------
    def eval_params(self, state: AsyncState) -> dict:
        """Personalized models mid-flight: de-bias counting the mass still
        in mailboxes (`pushsum.debias_in_flight`), unravel, merge
        personal."""
        mail_f, mail_mu = mbox.in_flight(state.mail)
        z, _ = pushsum.debias_in_flight(state.flat, state.mu, mail_f,
                                        mail_mu)
        return gossip.FlatClientState(z, state.personal).to_tree(
            self.layout)

    def mass_total(self, state: AsyncState) -> torch.Tensor:
        """Conserved quantity: local + in-flight push-sum weight."""
        return pushsum.total_mass(state.mu, mbox.mass(state.mail))
