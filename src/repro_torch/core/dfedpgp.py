"""DFedPGP — Algorithm 1 on the resident flat buffer (port of the resident
path of `repro/core/dfedpgp.py`).

Per round t, for all clients at once:
  1. z = u / mu                                     (de-bias)
  2. K_v SGD steps on the personal part v at the pinned z       (lines 5-8)
  3. K_u SGD steps on the shared row u, each gradient evaluated at
     z = u^{t,k} / mu and applied to the biased row             (lines 9-12)
  4. push/pull over the round's directed graph:  u <- P u,  mu <- P mu.

The shared part lives in the (m, d_flat) buffer across rounds; the mix is
`gossip.mix_flat`, which sends the buffer through the CUDA gossip_gather
kernel when it lies on a GPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.func import grad_and_value, vmap

from .. import tree
from ..device import resolve_device
from ..optim import SGD, SGDState
from . import gossip, local, partition


def _check_uniform_dtype(layout) -> None:
    if len(set(layout.dtypes)) > 1:
        raise ValueError(
            f"resident flat buffer needs a uniform shared-leaf dtype (got "
            f"{sorted({str(d) for d in layout.dtypes})})")


class FlatDFedPGPState(NamedTuple):
    """Resident-buffer round state."""
    flat: torch.Tensor     # (m, d_flat) biased shared buffer u
    personal: dict         # personal leaves (m, ...), pruned tree
    mu: torch.Tensor       # (m,) f32 push-sum weights
    opt_u: SGDState        # momentum: one (m, d_flat) buffer
    opt_v: SGDState        # momentum: personal-leaf tree
    round: torch.Tensor    # 0-d int32


# knobs of the reference DFedPGP that later slices port: field -> ROADMAP
# queue 1 item that ports it
_UNPORTED = {"mix_fn": 8, "mix_fn_flat": 8, "grad_hook": 14,
             "grad_hook_flat": 14, "codec": 10, "telemetry": 13}


@dataclasses.dataclass(frozen=True)
class DFedPGP:
    loss_fn: Callable              # (params, batch) -> scalar, one client
    mask: Any                      # shared(=True)/personal partition
    opt_u: SGD = SGD(lr=0.1, momentum=0.9, weight_decay=5e-4)
    opt_v: SGD = SGD(lr=0.1, momentum=0.9, weight_decay=5e-4)
    k_v: int = 1                   # personal local steps per round
    k_u: int = 5                   # shared local steps per round
    lr_decay: float = 0.99
    mix_fn: Optional[Callable] = None
    mix_fn_flat: Optional[Callable] = None
    grad_hook: Optional[Callable] = None
    grad_hook_flat: Optional[Callable] = None
    # gossip payload dtype (e.g. torch.bfloat16 halves the wire bytes)
    gossip_dtype: Optional[torch.dtype] = None
    # "sparse" (default): the gossip_gather kernel on a CUDA buffer, its
    # plain version on a CPU buffer; "dense": the (m, m) contraction
    gossip: str = "sparse"
    codec: Optional[Any] = None
    codec_gamma: Any = 1.0
    telemetry: bool = False

    def __post_init__(self):
        for name, item in _UNPORTED.items():
            if getattr(self, name) not in (None, False):
                raise NotImplementedError(
                    f"DFedPGP({name}=...) is not ported yet (ROADMAP queue "
                    f"1 item {item})")
        if self.codec_gamma != 1.0:
            raise NotImplementedError("codec_gamma belongs to the wire "
                                      "codecs (ROADMAP queue 1 item 10)")
        if self.gossip == "pallas":
            raise ValueError("gossip='pallas' has no meaning in the port: "
                             "'sparse' runs the CUDA gossip_gather kernel "
                             "on a CUDA buffer")
        if self.gossip not in gossip.MODES:
            raise ValueError(f"gossip mode {self.gossip!r}; known: "
                             f"{gossip.MODES}")

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
        m = fcs.flat.shape[0]
        return FlatDFedPGPState(
            flat=fcs.flat,
            personal=fcs.personal,
            mu=torch.ones((m,), dtype=torch.float32, device=dev),
            opt_u=SGDState(torch.zeros_like(fcs.flat)),
            opt_v=SGDState(tree.tree_map(torch.zeros_like, fcs.personal)),
            round=torch.zeros((), dtype=torch.int32, device=dev),
        ), layout

    # ------------------------------------------------------------------
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

            personal, opt_v, loss_v = local.sgd_steps(
                v_loss, self.opt_v, personal, opt_v, batches_v, lr_scale,
                extra=(z0,))

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

    # ------------------------------------------------------------------
    def round_fn_flat(self, state: FlatDFedPGPState, P, batches: dict,
                      layout: gossip.FlatLayout, step_gate_u=None):
        """One resident round: local steps on all clients, then the
        push-pull mixes the buffer.  batches: {'v': leaves
        (m, K_v, B, ...), 'u': leaves (m, K_u, B, ...)}; P: the round's
        SparseTopology on the state's device (or a dense (m, m) matrix).
        -> (new_state, metrics)."""
        lr_scale = torch.tensor(self.lr_decay, dtype=torch.float32,
                                device=state.flat.device) \
            ** state.round.to(torch.float32)
        if step_gate_u is None:
            m, k_u = next(iter(batches["u"].values())).shape[:2]
            step_gate_u = torch.ones((m, k_u), dtype=torch.float32,
                                     device=state.flat.device)
        flat, personal, opt_u, opt_v, (loss_v, loss_u) = \
            self.local_update_flat(state.flat, state.personal, state.mu,
                                   state.opt_u, state.opt_v, batches["v"],
                                   batches["u"], lr_scale, step_gate_u,
                                   layout)
        flat, mu = gossip.mix_flat(P, flat, state.mu, mode=self.gossip,
                                   wire_dtype=self.gossip_dtype)
        new_state = FlatDFedPGPState(flat, personal, mu, opt_u, opt_v,
                                     state.round + 1)
        metrics = {"loss_v": loss_v.mean(), "loss_u": loss_u.mean(),
                   "mu_min": mu.min(), "mu_max": mu.max()}
        return new_state, metrics

    # ------------------------------------------------------------------
    def eval_params_flat(self, state: FlatDFedPGPState,
                         layout: gossip.FlatLayout) -> dict:
        """Personalized models: de-bias the buffer, unravel, merge
        personal."""
        z = state.flat / state.mu[:, None].to(state.flat.dtype)
        return gossip.FlatClientState(z, state.personal).to_tree(layout)
