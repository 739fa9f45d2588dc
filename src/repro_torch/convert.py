"""Weights and state carried across from the JAX reference.

The reference's CNN parameter dict and the port's have the same keys and
layouts (HWIO conv kernels, (in, out) dense weights), so conversion is a
copy of each array.  Where the reference keeps None placeholders at the
other partition side's leaves, the port's pruned trees drop them.  Inputs
are numpy arrays (or anything `numpy.asarray` accepts): the reference's
tree-form and resident DFedPGP states and its hetero `ClientProfile`.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.dfedpgp import DFedPGPState, FlatDFedPGPState
from .hetero.profiles import ClientProfile
from .optim import SGDState


def _tensor(a, device):
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_reference(tree_of_numpy: dict, device="cpu") -> dict:
    """Nested dict of arrays (None leaves dropped) -> dict of tensors."""
    out = {}
    for key, val in tree_of_numpy.items():
        if val is None:
            continue
        if isinstance(val, dict):
            sub = params_from_reference(val, device)
            if sub:
                out[key] = sub
        else:
            out[key] = _tensor(val, device)
    return out


def flat_state_from_reference(*, flat, personal, mu, mom_u, mom_v, round,
                              device="cpu") -> FlatDFedPGPState:
    """The reference FlatDFedPGPState's arrays -> the port's state:
    flat (m, d_flat), personal tree, mu (m,), mom_u (m, d_flat) (the
    opt_u momentum), mom_v tree (the opt_v momentum), round (scalar)."""
    return FlatDFedPGPState(
        flat=_tensor(flat, device),
        personal=params_from_reference(personal, device),
        mu=_tensor(mu, device).to(torch.float32),
        opt_u=SGDState(_tensor(mom_u, device)),
        opt_v=SGDState(params_from_reference(mom_v, device)),
        round=torch.tensor(int(np.asarray(round)), dtype=torch.int32,
                           device=device))


def tree_state_from_reference(*, params, mu, mom_u, mom_v, round,
                              device="cpu") -> DFedPGPState:
    """The reference DFedPGPState's arrays -> the port's tree-form state:
    params, mom_u (opt_u momentum) and mom_v (opt_v momentum) are full
    trees — the momentum trees with their (m,) scalar placeholders at the
    other part's leaves, as the reference keeps them."""
    return DFedPGPState(
        params=params_from_reference(params, device),
        mu=_tensor(mu, device).to(torch.float32),
        opt_u=SGDState(params_from_reference(mom_u, device)),
        opt_v=SGDState(params_from_reference(mom_v, device)),
        round=torch.tensor(int(np.asarray(round)), dtype=torch.int32,
                           device=device))


def profile_from_reference(*, step_cost, push_delay, avail_period,
                           avail_duty, avail_phase) -> ClientProfile:
    """The reference ClientProfile's (m,) arrays -> the port's (numpy)."""
    return ClientProfile(np.asarray(step_cost, np.float32),
                         np.asarray(push_delay, np.int32),
                         np.asarray(avail_period, np.float32),
                         np.asarray(avail_duty, np.float32),
                         np.asarray(avail_phase, np.float32))
