"""DFedPGP — Algorithm 1 (port of `repro/core/dfedpgp.py`).

Per round t, for all clients at once:
  1. z = u / mu                                     (de-bias)
  2. K_v SGD steps on the personal part v at the pinned z       (lines 5-8)
  3. K_u SGD steps on the shared row u, each gradient evaluated at
     z = u^{t,k} / mu and applied to the biased row             (lines 9-12)
  4. push/pull over the round's directed graph:  u <- P u,  mu <- P mu.

Three forms of the round, as in the reference:
- `round_fn_flat` — the resident form: the shared part lives in the
  (m, d_flat) buffer across rounds and mixes through `gossip.mix_flat`
  (the CUDA gossip_gather kernel on a GPU buffer), or through a
  `mix_fn_flat` override such as `kernel_mix.make_kernel_mix_flat`;
- `round_fn_sampled` — partial participation on the resident buffer: only
  the active rows are gathered, stepped, mixed over the induced subgraph
  and written back in place (the CUDA gossip_scatter kernel);
- `round_fn` — the tree form on the stacked params tree (`DFedPGPState`),
  one client's `local_update` vmapped over the clients, then
  `gossip.gossip_mix` or a tree `mix_fn` override.
With a wire `codec` the two resident forms cross through the codec branch
of `gossip.mix_flat` and carry its error-feedback and reference memory in
`FlatDFedPGPState.ef` / `.ref`; the tree form raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.func import grad_and_value, vmap

from .. import compress, tree
from ..device import resolve_device, seeded_generator
from ..kernels import ops
from ..obs import gauges
from ..optim import SGD, SGDState
from . import gossip, local, partition


def _check_uniform_dtype(layout) -> None:
    if len(set(layout.dtypes)) > 1:
        raise ValueError(
            f"resident flat buffer needs a uniform shared-leaf dtype (got "
            f"{sorted({str(d) for d in layout.dtypes})}); mixed-dtype "
            f"shared parts must use the tree-form round_fn")


class DFedPGPState(NamedTuple):
    """Tree-form round state.  The momentum trees have the params'
    structure: full zeros for the part the phase trains, a per-client
    scalar placeholder (m,) for the other part."""
    params: dict           # stacked (m, ...): biased u leaves + personal v
    mu: torch.Tensor       # (m,) f32 push-sum weights
    opt_u: SGDState
    opt_v: SGDState
    round: torch.Tensor    # 0-d int32


class FlatDFedPGPState(NamedTuple):
    """Resident-buffer round state."""
    flat: torch.Tensor     # (m, d_flat) biased shared buffer u
    personal: dict         # personal leaves (m, ...), pruned tree
    mu: torch.Tensor       # (m,) f32 push-sum weights
    opt_u: SGDState        # momentum: one (m, d_flat) buffer
    opt_v: SGDState        # momentum: personal-leaf tree
    round: torch.Tensor    # 0-d int32
    # wire-codec memory: the error-feedback residual and the public
    # reference copies, (m, d_flat) f32 for lossy codecs, else None
    ef: Optional[torch.Tensor] = None
    ref: Optional[torch.Tensor] = None


# knobs of the reference DFedPGP that later slices port: field -> ROADMAP
# queue 1 item that ports it
_UNPORTED = {"grad_hook": 14, "grad_hook_flat": 14, "telemetry": 13}
# stream of `device.seeded_generator` the codec draws come from
CODEC_STREAM = 3


@dataclasses.dataclass(frozen=True)
class DFedPGP:
    loss_fn: Callable              # (params, batch) -> scalar, one client
    mask: Any                      # shared(=True)/personal partition
    opt_u: SGD = SGD(lr=0.1, momentum=0.9, weight_decay=5e-4)
    opt_v: SGD = SGD(lr=0.1, momentum=0.9, weight_decay=5e-4)
    k_v: int = 1                   # personal local steps per round
    k_u: int = 5                   # shared local steps per round
    lr_decay: float = 0.99
    # tree-form mix override (params, mu, round, P) -> (params, mu)
    mix_fn: Optional[Callable] = None
    # resident mix override (flat, mu, round, P) -> (flat, mu), e.g. the
    # dense pushsum_mix kernel of kernel_mix.make_kernel_mix_flat
    mix_fn_flat: Optional[Callable] = None
    grad_hook: Optional[Callable] = None
    grad_hook_flat: Optional[Callable] = None
    # gossip payload dtype (e.g. torch.bfloat16 halves the wire bytes)
    gossip_dtype: Optional[torch.dtype] = None
    # the reference's three engines (core.gossip): "sparse" (default) —
    # mix_rows in the payload dtype, the CUDA gossip_gather kernel for an
    # f32 payload on a GPU; "dense" — the (m, m) contraction; "pallas" —
    # the f32-accumulate gather, the kernel on a GPU in every payload dtype
    gossip: str = "sparse"
    # wire codec of the resident mix (`repro_torch.compress`): lossy codecs
    # carry error-feedback and reference memory in FlatDFedPGPState.ef /
    # .ref; the identity codec is the codec-free path bit for bit.
    # Resident rounds only; mutually exclusive with gossip_dtype
    codec: Optional[Any] = None
    # consensus step of lossy codecs: the codec mix runs on (1-g) I + g P;
    # a float in (0, 1], or "auto": g = ||u|| / (||u|| + ||ef||) clipped
    # to [0.05, 1] each round (`obs.gauges.ef_signal_ratio`)
    codec_gamma: Any = 1.0
    telemetry: bool = False

    def __post_init__(self):
        for name, item in _UNPORTED.items():
            if getattr(self, name) not in (None, False):
                raise NotImplementedError(
                    f"DFedPGP({name}=...) is not ported yet (ROADMAP queue "
                    f"1 item {item})")
        if self.gossip not in gossip.MODES:
            raise ValueError(f"gossip mode {self.gossip!r}; known: "
                             f"{gossip.MODES}")

    def _lr_scale(self, rnd: torch.Tensor) -> torch.Tensor:
        return torch.tensor(self.lr_decay, dtype=torch.float32,
                            device=rnd.device) ** rnd.to(torch.float32)

    # ------------------------------------------------------------------
    # tree form
    # ------------------------------------------------------------------
    def init(self, stacked_params: dict, device="cuda") -> DFedPGPState:
        """-> DFedPGPState on `device`."""
        dev = resolve_device(device)
        params = tree.tree_map(lambda a: a.to(dev), stacked_params)
        m = tree.leaves(params)[0].shape[0]

        def part_momentum(keep_shared: bool) -> SGDState:
            # full momentum only for the part this phase trains; the other
            # part gets a per-client scalar placeholder
            return SGDState(tree.tree_map(
                lambda p, shared: torch.zeros_like(p)
                if shared == keep_shared
                else torch.zeros(p.shape[:1], dtype=p.dtype, device=dev),
                params, self.mask))

        return DFedPGPState(
            params=params,
            mu=torch.ones((m,), dtype=torch.float32, device=dev),
            opt_u=part_momentum(True),
            opt_v=part_momentum(False),
            round=torch.zeros((), dtype=torch.int32, device=dev))

    def local_update(self, params: dict, mu_i, opt_u: SGDState,
                     opt_v: SGDState, batches_v: dict, batches_u: dict,
                     lr_scale, step_gate_u=None):
        """One client's alternating update on its unstacked params tree
        (`round_fn` vmaps it).  batches leaves (K, B, ...); step_gate_u
        (K_u,).  -> (params, opt_u, opt_v, (loss_v, loss_u))."""
        mask = self.mask

        def debias_leaf(p, shared):
            return (p / mu_i).to(p.dtype) if shared else p

        # ---- v-steps at the pinned z^{t,0} (personal gradient only) ----
        z = tree.tree_map(debias_leaf, params, mask)

        def v_loss(p, batch):
            return self.loss_fn(partition.where(mask, z, p), batch)

        params_v, opt_v, loss_v = local.sgd_steps(
            v_loss, self.opt_v, params, opt_v, batches_v, lr_scale,
            grad_filter=lambda g, p: local.masked_grads(g, mask, False))
        params = partition.where(mask, params, params_v)   # new v only

        # ---- u-steps: gradient at z^{t,k} = u^{t,k}/mu, applied to the
        # biased u (not differentiated through the de-bias) ----
        value_and_grad = grad_and_value(self.loss_fn)
        losses = []
        for k in range(next(iter(batches_u.values())).shape[0]):
            z_k = tree.tree_map(debias_leaf, params, mask)
            g, loss = value_and_grad(z_k, {n: a[k] for n, a in
                                           batches_u.items()})
            g = local.masked_grads(g, mask, True)
            p2, s2 = self.opt_u.update(g, opt_u, params, lr_scale)
            if step_gate_u is not None:
                gate = step_gate_u[k]

                def blend(new, old):
                    return tree.tree_map(lambda a, b: (
                        gate * a + (1.0 - gate) * b).to(a.dtype), new, old)
                p2 = blend(p2, params)
                s2 = SGDState(blend(s2.momentum, opt_u.momentum))
            # personal leaves must not move in the u-phase
            params, opt_u = partition.where(mask, p2, params), s2
            losses.append(loss)
        return params, opt_u, opt_v, (loss_v, torch.stack(losses).mean())

    def round_fn(self, state: DFedPGPState, P, batches: dict,
                 step_gate_u=None):
        """One tree-form round.  batches: {'v': leaves (m, K_v, B, ...),
        'u': leaves (m, K_u, B, ...)}; P: the round's SparseTopology (or a
        dense (m, m) matrix) on the state's device; step_gate_u: optional
        (m, K_u) gates.  -> (new_state, metrics)."""
        if self.codec is not None:
            raise ValueError("wire codecs ride the resident flat buffer "
                             "(round_fn_flat / round_fn_sampled); the "
                             "tree-form round_fn has no payload boundary")
        dev = state.mu.device
        lr_scale = self._lr_scale(state.round)
        if step_gate_u is None:
            m, k_u = next(iter(batches["u"].values())).shape[:2]
            step_gate_u = torch.ones((m, k_u), dtype=torch.float32,
                                     device=dev)
        params, opt_u, opt_v, (loss_v, loss_u) = vmap(
            self.local_update, in_dims=(0, 0, 0, 0, 0, 0, None, 0))(
                state.params, state.mu, state.opt_u, state.opt_v,
                batches["v"], batches["u"], lr_scale, step_gate_u)
        if self.mix_fn is not None:
            params, mu = self.mix_fn(params, state.mu, state.round, P)
        else:
            params, mu = gossip.gossip_mix(
                params, state.mu, P, self.mask, mode=self.gossip,
                wire_dtype=self.gossip_dtype)
        new_state = DFedPGPState(params, mu, opt_u, opt_v, state.round + 1)
        metrics = {"loss_v": loss_v.mean(), "loss_u": loss_u.mean(),
                   "mu_min": mu.min(), "mu_max": mu.max()}
        return new_state, metrics

    def eval_params(self, state: DFedPGPState) -> dict:
        """Personalized models: de-biased shared part + personal part."""
        mu = state.mu

        def debias(a, shared):
            if not shared:
                return a
            return a / mu.reshape((-1,) + (1,) * (a.dim() - 1)).to(a.dtype)

        return tree.tree_map(debias, state.params, self.mask)

    # ------------------------------------------------------------------
    # resident flat-buffer form
    # ------------------------------------------------------------------
    def init_flat(self, stacked_params: dict,
                  layout: Optional[gossip.FlatLayout] = None,
                  device="cuda"):
        """-> (FlatDFedPGPState, FlatLayout) on `device`.  Packs the shared
        part once; every later round operates on the resident buffer."""
        dev = resolve_device(device)
        params = tree.tree_map(lambda a: a.to(dev), stacked_params)
        fcs, layout = gossip.FlatClientState.create(params, self.mask,
                                                    layout)
        _check_uniform_dtype(layout)
        self._check_codec()
        m = fcs.flat.shape[0]
        return FlatDFedPGPState(
            flat=fcs.flat,
            personal=fcs.personal,
            mu=torch.ones((m,), dtype=torch.float32, device=dev),
            opt_u=SGDState(torch.zeros_like(fcs.flat)),
            opt_v=SGDState(tree.tree_map(torch.zeros_like, fcs.personal)),
            round=torch.zeros((), dtype=torch.int32, device=dev),
            ef=compress.init_ef(self.codec, fcs.flat),
            ref=compress.init_ref(self.codec, fcs.flat),
        ), layout

    def _check_codec(self) -> None:
        """The reference's build-time validation of the codec knobs."""
        if self.codec is not None and self.mix_fn_flat is not None:
            raise ValueError("codec and mix_fn_flat are mutually "
                             "exclusive: the codec path owns the wire "
                             "crossing (gossip.mix_flat) — a mix override "
                             "would bypass the error-feedback ledger")
        if isinstance(self.codec_gamma, str):
            if self.codec_gamma != "auto":
                raise ValueError(
                    f"codec_gamma must be a float in (0, 1] or 'auto'; "
                    f"got {self.codec_gamma!r}")
            if self.codec is None or self.codec.exact:
                raise ValueError(
                    "codec_gamma='auto' anneals the lossy-codec consensus "
                    "step; the exact/uncompressed mix never blends (drop "
                    "the knob or use a lossy codec)")
            if self.gossip_dtype is not None:
                raise ValueError("codec and gossip_dtype are mutually "
                                 "exclusive: the codec IS the wire format")
            return
        g = float(self.codec_gamma)
        if self.codec is None or self.codec.exact:
            if g != 1.0:
                raise ValueError(
                    f"codec_gamma={g} only applies to lossy codecs; the "
                    f"exact/uncompressed mix never blends (drop the knob "
                    f"or use a lossy codec)")
            if self.codec is None:
                return
        if self.gossip_dtype is not None:
            raise ValueError("codec and gossip_dtype are mutually "
                             "exclusive: the codec IS the wire format")
        if not 0.0 < g <= 1.0:
            raise ValueError(f"codec_gamma must be in (0, 1], got "
                             f"{self.codec_gamma}")

    def _gamma_value(self, flat, ef):
        """The round's consensus step: the static knob as-is, or for "auto"
        a 0-d f32 tensor, `ef_signal_ratio(flat, ef)` clipped to
        [0.05, 1] — exactly 1.0 with a zero residual."""
        if not isinstance(self.codec_gamma, str):
            return self.codec_gamma
        return torch.clamp(gauges.ef_signal_ratio(flat, ef), 0.05, 1.0)

    def _codec_mix(self, P, flat, mu, ef, ref, rnd):
        """The codec crossing of a resident round -> (flat, mu, ef, ref).
        A randomized codec draws from a generator on the buffer's device
        seeded by (codec.seed, round), the port's fold_in of the round
        into the codec's key."""
        key = None
        if self.codec.draws:
            key = seeded_generator(self.codec.seed, CODEC_STREAM, int(rnd),
                                   flat.device)
        return gossip.mix_flat(P, flat, mu, mode=self.gossip,
                               codec=self.codec, ef=ef, ref=ref, key=key,
                               codec_gamma=self._gamma_value(flat, ef))

    def local_update_flat(self, flat, personal, mu, opt_u, opt_v,
                          batches_v, batches_u, lr_scale, step_gate_u,
                          layout: gossip.FlatLayout):
        """All clients' alternating update on the resident buffer.
        flat: (m, d_flat) biased rows; personal: stacked personal leaves;
        batches leaves (m, K, B, ...); step_gate_u: (m, K_u) in {0, 1}.
        -> (flat, personal, opt_u, opt_v, (loss_v, loss_u)) with (m,)
        per-client mean losses."""
        m = flat.shape[0]
        # ---- v-steps at the pinned z^{t,0} (personal gradient only);
        # K_v = 0 skips the phase ----
        if local.n_steps(batches_v) == 0:
            loss_v = torch.zeros((m,), dtype=torch.float32,
                                 device=flat.device)
        else:
            z0 = (flat / mu[:, None]).to(flat.dtype)

            def v_loss(pv, batch, z_row):
                shared = layout.unravel_row(z_row)
                return self.loss_fn(partition.merge(shared, pv), batch)

            def client_v(pv, sv, bv, z_row):
                return local.sgd_steps(v_loss, self.opt_v, pv, sv, bv,
                                       lr_scale, extra=(z_row,))

            personal, opt_v, loss_v = vmap(client_v)(personal, opt_v,
                                                     batches_v, z0)

        # ---- u-steps: gradient at z^{t,k} = u^{t,k}/mu, applied to the
        # biased row (not differentiated through the de-bias) ----
        value_and_grad_u = vmap(grad_and_value(
            local.flat_view_loss(self.loss_fn, layout)))
        losses = []
        for k in range(local.n_steps(batches_u)):
            z = (flat / mu[:, None]).to(flat.dtype)
            g, loss = value_and_grad_u(z, personal,
                                       local.step_batch(batches_u, k))
            flat2, s2 = self.opt_u.update(g, opt_u, flat, lr_scale)
            gate = step_gate_u[:, k:k + 1]
            flat = (gate * flat2 + (1.0 - gate) * flat).to(flat2.dtype)
            opt_u = SGDState((gate * s2.momentum + (1.0 - gate)
                              * opt_u.momentum).to(s2.momentum.dtype))
            losses.append(loss)
        loss_u = torch.stack(losses, dim=1).mean(dim=1)
        return flat, personal, opt_u, opt_v, (loss_v, loss_u)

    def round_fn_flat(self, state: FlatDFedPGPState, P, batches: dict,
                      layout: gossip.FlatLayout, step_gate_u=None):
        """One resident round: local steps on all clients, then the
        push-pull mixes the buffer (`gossip.mix_flat`, or the
        `mix_fn_flat` override).  batches: {'v': leaves (m, K_v, B, ...),
        'u': leaves (m, K_u, B, ...)}; P: the round's SparseTopology on the
        state's device (or a dense (m, m) matrix).  -> (new_state,
        metrics)."""
        if self.mix_fn is not None and self.mix_fn_flat is None:
            raise ValueError("mix_fn overrides operate on tree-form "
                             "leaves; the resident path mixes the flat "
                             "buffer directly — provide mix_fn_flat "
                             "(kernel_mix.make_kernel_mix_flat) or use the "
                             "tree-form round_fn")
        lr_scale = self._lr_scale(state.round)
        if step_gate_u is None:
            m, k_u = next(iter(batches["u"].values())).shape[:2]
            step_gate_u = torch.ones((m, k_u), dtype=torch.float32,
                                     device=state.flat.device)
        flat, personal, opt_u, opt_v, (loss_v, loss_u) = \
            self.local_update_flat(state.flat, state.personal, state.mu,
                                   state.opt_u, state.opt_v, batches["v"],
                                   batches["u"], lr_scale, step_gate_u,
                                   layout)
        ef, ref = state.ef, state.ref
        if self.mix_fn_flat is not None:
            flat, mu = self.mix_fn_flat(flat, state.mu, state.round, P)
        elif self.codec is not None:
            flat, mu, ef, ref = self._codec_mix(P, flat, state.mu, ef, ref,
                                                state.round)
        else:
            flat, mu = gossip.mix_flat(P, flat, state.mu, mode=self.gossip,
                                       wire_dtype=self.gossip_dtype)
        new_state = FlatDFedPGPState(flat, personal, mu, opt_u, opt_v,
                                     state.round + 1, ef, ref)
        metrics = {"loss_v": loss_v.mean(), "loss_u": loss_u.mean(),
                   "mu_min": mu.min(), "mu_max": mu.max()}
        return new_state, metrics

    def round_fn_sampled(self, state: FlatDFedPGPState, P_act, active,
                         batches: dict, layout: gossip.FlatLayout,
                         step_gate_u=None):
        """Partial-participation resident round: only the `active` clients
        act.  Their rows are gathered from the resident buffers, the usual
        local steps and the mix over `P_act` run on the compact
        (n_active, d_flat) working set, and the results go back.

        P_act: the round's topology restricted to the active subset, in
        compact ids (`topology.induced_subgraph(..., "row")`), on the
        state's device.  active: (n_active,) unique global ids, sorted (the
        sampler's output).  batches and step_gate_u are compact: leaves
        lead with (n_active, K, ...).

        IN PLACE: `state.flat`, `state.opt_u.momentum` and, with a lossy
        codec, `state.ef` and `state.ref` are written through
        `kernels.ops.gossip_scatter` (the CUDA kernel on a GPU) and are the
        new state's buffers too — the torch form of the
        reference's aliased, donated buffers.  A caller that needs the old
        state clones it first.  mu, the personal leaves and opt_v are
        small and are copied (`index_copy`).  Dormant rows never move.
        Metrics are means over the active clients; the mu range spans the
        whole buffer."""
        if self.mix_fn is not None or self.mix_fn_flat is not None:
            raise ValueError(
                "mix overrides operate on the full resident buffer; the "
                "sampled round mixes the compact working set — drop the "
                "override or use round_fn_flat")
        dev = state.flat.device
        lr_scale = self._lr_scale(state.round)
        active = torch.as_tensor(active, device=dev).to(torch.int32)
        idx = active.long()
        if step_gate_u is None:
            shp = next(iter(batches["u"].values())).shape[:2]
            step_gate_u = torch.ones(shp, dtype=torch.float32, device=dev)

        def take(t):
            return t.index_select(0, idx)

        flat_a, personal_a, opt_u_a, opt_v_a, (loss_v, loss_u) = \
            self.local_update_flat(
                take(state.flat), tree.tree_map(take, state.personal),
                take(state.mu), SGDState(take(state.opt_u.momentum)),
                SGDState(tree.tree_map(take, state.opt_v.momentum)),
                batches["v"], batches["u"], lr_scale, step_gate_u, layout)
        if self.codec is not None:
            # codec memory (None for an exact codec) rides with its rows
            ef_a, ref_a = (None if t is None else take(t)
                           for t in (state.ef, state.ref))
            flat_a, mu_a, ef_a, ref_a = self._codec_mix(
                P_act, flat_a, take(state.mu), ef_a, ref_a, state.round)
        else:
            ef_a = ref_a = None
            flat_a, mu_a = gossip.mix_flat(P_act, flat_a, take(state.mu),
                                           mode=self.gossip,
                                           wire_dtype=self.gossip_dtype)

        def put(full, new):
            return torch.index_copy(full, 0, idx, new)

        flat = ops.gossip_scatter(active, flat_a, state.flat)
        opt_u = SGDState(ops.gossip_scatter(active, opt_u_a.momentum,
                                            state.opt_u.momentum))
        ef = state.ef if ef_a is None else \
            ops.gossip_scatter(active, ef_a, state.ef)
        ref = state.ref if ref_a is None else \
            ops.gossip_scatter(active, ref_a, state.ref)
        mu = put(state.mu, mu_a)
        personal = tree.tree_map(put, state.personal, personal_a)
        opt_v = SGDState(tree.tree_map(put, state.opt_v.momentum,
                                       opt_v_a.momentum))
        new_state = FlatDFedPGPState(flat, personal, mu, opt_u, opt_v,
                                     state.round + 1, ef, ref)
        metrics = {"loss_v": loss_v.mean(), "loss_u": loss_u.mean(),
                   "mu_min": mu.min(), "mu_max": mu.max(),
                   "n_active": int(idx.shape[0])}
        return new_state, metrics

    def eval_params_flat(self, state: FlatDFedPGPState,
                         layout: gossip.FlatLayout) -> dict:
        """Personalized models: de-bias the buffer, unravel, merge
        personal."""
        z = state.flat / state.mu[:, None].to(state.flat.dtype)
        return gossip.FlatClientState(z, state.personal).to_tree(layout)

    # ------------------------------------------------------------------
    # conversion between the forms
    # ------------------------------------------------------------------
    def state_to_flat(self, state: DFedPGPState,
                      layout: Optional[gossip.FlatLayout] = None):
        """Tree-form -> resident state, -> (FlatDFedPGPState, layout)."""
        fcs, layout = gossip.FlatClientState.create(state.params, self.mask,
                                                    layout)
        _check_uniform_dtype(layout)
        self._check_codec()
        mom, _ = gossip.FlatClientState.create(state.opt_u.momentum,
                                               self.mask, layout)
        mom_v = partition.split(state.opt_v.momentum, self.mask)[1]
        # tree-form states carry no codec memory: a lossy codec starts from
        # fresh error-feedback and reference buffers
        return FlatDFedPGPState(fcs.flat, fcs.personal, state.mu,
                                SGDState(mom.flat), SGDState(mom_v),
                                state.round,
                                compress.init_ef(self.codec, fcs.flat),
                                compress.init_ref(self.codec, fcs.flat)
                                ), layout

    def state_from_flat(self, fstate: FlatDFedPGPState,
                        layout: gossip.FlatLayout) -> DFedPGPState:
        """Resident -> tree-form state.  The other part's momentum slots
        come back as the (m,) zero placeholders `init` creates."""
        params = gossip.FlatClientState(fstate.flat,
                                        fstate.personal).to_tree(layout)
        m = fstate.mu.shape[0]

        def placeholders(keep_shared: bool) -> dict:
            return tree.from_paths(
                (p, torch.zeros((m,), dtype=leaf.dtype, device=leaf.device))
                for p, leaf in tree.paths(params)
                if tree.get(self.mask, p) != keep_shared)

        mom_u = partition.merge(layout.unravel(fstate.opt_u.momentum),
                                placeholders(True))
        mom_v = partition.merge(fstate.opt_v.momentum, placeholders(False))
        return DFedPGPState(params, fstate.mu, SGDState(mom_u),
                            SGDState(mom_v), fstate.round)
