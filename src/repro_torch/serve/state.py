"""ServingState: the trained buffer, re-packaged for inference.

Port of `repro/serve/state.py` for the resident state.  Training's product
is m personalized models sharing one consensus representation: the
de-biased shared part z = u / mu plus each client's private classifier.
The serving state stores exactly those two pieces:

- ``trunk``: the consensus shared subtree, unraveled once from the
  (m, d_flat) buffer via `FlatLayout`;
- ``personal``: the stacked (m, ...) personal leaves, the per-user
  classifier block the CUDA `head_gather_matmul` kernel gathers from.

Converters accept the resident `FlatDFedPGPState`, the tree-form
`DFedPGPState`, and a checkpoint directory (`from_checkpoint`, through
`checkpoint.restore_train_state`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import tree
from ..checkpoint import restore_train_state
from ..core import gossip, partition
from ..core.dfedpgp import DFedPGPState, FlatDFedPGPState

CONSENSUS_MODES = ("mass", "mean")


class ServingState(NamedTuple):
    """Inference-side state: one consensus trunk + m resident heads."""
    trunk: dict         # shared subtree, de-biased
    personal: dict      # stacked (m, ...) personal leaves

    def n_users(self) -> int:
        return tree.leaves(self.personal)[0].shape[0]

    def user_model(self, i) -> dict:
        """The full personalized model of user i (diagnostics and parity
        checks — the serve path never materializes it)."""
        head = tree.tree_map(lambda a: a[i], self.personal)
        return partition.merge(self.trunk, head)

    def to(self, device) -> "ServingState":
        return ServingState(tree.tree_map(lambda a: a.to(device), self.trunk),
                            tree.tree_map(lambda a: a.to(device),
                                          self.personal))


def _consensus_row(flat: torch.Tensor, mu: torch.Tensor, consensus):
    """One (d_flat,) de-biased consensus row from the resident buffer.

    - int i — anchor on client i: exactly eval_params_flat's expression
      (flat / mu[:, None] in the buffer's dtype), row i;
    - "mass" — (sum_i u_i) / (sum_i mu_i) in f32: the push-sum consensus
      estimate;
    - "mean" — mean_i (u_i / mu_i): the average of the de-biased views.
    """
    if isinstance(consensus, int) and not isinstance(consensus, bool):
        z = flat / mu[:, None].to(flat.dtype)
        return z[consensus]
    if consensus == "mass":
        num = torch.sum(flat.to(torch.float32), dim=0)
        return (num / torch.sum(mu)).to(flat.dtype)
    if consensus == "mean":
        z = flat.to(torch.float32) / mu[:, None]
        return torch.mean(z, dim=0).to(flat.dtype)
    raise ValueError(f"consensus {consensus!r}; known: {CONSENSUS_MODES} "
                     f"or an int client index (anchor)")


def from_train_state(state, *, mask=None, layout=None,
                     consensus="mass") -> ServingState:
    """Trained state -> ServingState.

    state: a FlatDFedPGPState (pass the run's `layout`) or a DFedPGPState
    (pass the partition `mask`; the layout is built from the params).  The
    tree form is packed through the SAME flatten_shared wire layout the
    resident path lives on, so both forms produce identical bits.
    """
    if isinstance(state, FlatDFedPGPState):
        if layout is None:
            raise ValueError("FlatDFedPGPState needs the run's FlatLayout "
                             "(the buffer's static wire layout)")
        flat, mu, personal = state.flat, state.mu, state.personal
    elif isinstance(state, DFedPGPState):
        if mask is None:
            raise ValueError("tree-form DFedPGPState needs the partition "
                             "mask (shared/personal split)")
        fcs, layout = gossip.FlatClientState.create(state.params, mask,
                                                    layout)
        flat, mu, personal = fcs.flat, state.mu, fcs.personal
    else:
        raise TypeError(f"expected FlatDFedPGPState or DFedPGPState, got "
                        f"{type(state).__name__}")
    trunk = layout.unravel_row(_consensus_row(flat, mu, consensus))
    return ServingState(trunk=trunk, personal=personal)


def from_checkpoint(ckpt_dir: str, template, *, mask=None, layout=None,
                    consensus="mass"):
    """-> (ServingState, step).  Restores the latest `step_*.npz` in
    ckpt_dir against `template` (a FlatDFedPGPState or DFedPGPState of the
    run's structure; the restored leaves take its dtypes and device) and
    converts.  bf16 leaves round-trip bit for bit."""
    state, step = restore_train_state(ckpt_dir, template)
    if state is None:
        raise FileNotFoundError(f"no step_*.npz checkpoint in {ckpt_dir}")
    return from_train_state(state, mask=mask, layout=layout,
                            consensus=consensus), step
