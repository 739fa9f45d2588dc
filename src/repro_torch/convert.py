"""Weights and state carried across from the JAX reference.

The reference's CNN parameter dict and the port's have the same keys and
layouts (HWIO conv kernels, (in, out) dense weights), so conversion is a
copy of each array.  Where the reference keeps None placeholders at the
other partition side's leaves, the port's pruned trees drop them.  Inputs
are numpy arrays (or anything `numpy.asarray` accepts): the reference's
tree-form and resident DFedPGP states, its baselines' states and its hetero
`ClientProfile`.  Regime B's states are DFedPGP states of stacked LM trees
(nested layer dicts, QKV biases, personal `lm_head` / `final_norm`): the
same two state functions carry them (tests/test_torch_regime_b.py), and
xLSTM's list of layer dicts.
"""
from __future__ import annotations

import numpy as np
import torch

from .core import baselines
from .core.dfedpgp import DFedPGPState, FlatDFedPGPState, round_counter
from .hetero.profiles import ClientProfile
from .optim import SGDState
from .tree import from_paths


def _tensor(a, device):
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _reference_paths(node, prefix: tuple = ()):
    """(path, array) pairs of a reference tree in JAX treedef order (dict
    keys sorted, list and tuple indices ascending); None leaves are
    skipped."""
    if node is None:
        return
    if isinstance(node, dict):
        for key in sorted(node):
            yield from _reference_paths(node[key], prefix + (key,))
    elif isinstance(node, (list, tuple)):
        for i, val in enumerate(node):
            yield from _reference_paths(val, prefix + (i,))
    else:
        yield prefix, node


def params_from_reference(tree_of_numpy: dict, device="cpu") -> dict:
    """Nested dicts, lists and tuples of arrays (None leaves and the
    subtrees they empty dropped) -> the port's tree of tensors: dicts, and
    lists where the reference has lists or tuples (xLSTM's layers and
    decode cache)."""
    return from_paths((p, _tensor(a, device))
                      for p, a in _reference_paths(tree_of_numpy))


def flat_state_from_reference(*, flat, personal, mu, mom_u, mom_v, round,
                              ef=None, ref=None,
                              device="cpu") -> FlatDFedPGPState:
    """The reference FlatDFedPGPState's arrays -> the port's state:
    flat (m, d_flat), personal tree, mu (m,), mom_u (m, d_flat) (the
    opt_u momentum), mom_v tree (the opt_v momentum), round (scalar), and
    the codec memory ef / ref ((m, d_flat) f32, or None)."""
    return FlatDFedPGPState(
        flat=_tensor(flat, device),
        personal=params_from_reference(personal, device),
        mu=_tensor(mu, device).to(torch.float32),
        opt_u=SGDState(_tensor(mom_u, device)),
        opt_v=SGDState(params_from_reference(mom_v, device)),
        round=round_counter(int(np.asarray(round)), device),
        ef=None if ef is None else _tensor(ef, device),
        ref=None if ref is None else _tensor(ref, device))


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


def _round(r, device) -> torch.Tensor:
    return torch.tensor(int(np.asarray(r)), dtype=torch.int32,
                        device=device)


def baseline_state_from_reference(state, device="cpu"):
    """A reference baseline state (`repro.core.baselines`: SimpleState,
    DittoState, OSGPState or DisPFLState, a NamedTuple whose leaves are
    numpy arrays, e.g. after `jax.tree.map(np.asarray, state)`) -> the
    port's state of the same name.  Told apart by their fields; a
    SimpleState's `extra` is None, the FedAvg global model or the FedPartial
    global shared part (None placeholders dropped)."""
    f = state._asdict()

    def tree_(t):
        return params_from_reference(t, device)

    def mom(opt):
        return SGDState(tree_(opt.momentum))

    fields = set(f)
    if fields == set(baselines.SimpleState._fields):
        extra = None if f["extra"] is None else tree_(f["extra"])
        return baselines.SimpleState(tree_(f["params"]), mom(f["opt"]),
                                     _round(f["round"], device), extra)
    if fields == set(baselines.DittoState._fields):
        return baselines.DittoState(
            tree_(f["personal"]), tree_(f["glob_stacked"]), mom(f["opt_p"]),
            mom(f["opt_g"]), tree_(f["glob"]), _round(f["round"], device))
    if fields == set(baselines.OSGPState._fields):
        return baselines.OSGPState(
            tree_(f["params"]), _tensor(f["mu"], device).to(torch.float32),
            mom(f["opt"]), _round(f["round"], device))
    if fields == set(baselines.DisPFLState._fields):
        return baselines.DisPFLState(
            tree_(f["params"]), tree_(f["masks"]), mom(f["opt"]),
            _round(f["round"], device))
    raise TypeError(f"{type(state).__name__} with fields {sorted(fields)} "
                    f"is not a baseline state of the reference")


def profile_from_reference(*, step_cost, push_delay, avail_period,
                           avail_duty, avail_phase) -> ClientProfile:
    """The reference ClientProfile's (m,) arrays -> the port's (numpy)."""
    return ClientProfile(np.asarray(step_cost, np.float32),
                         np.asarray(push_delay, np.int32),
                         np.asarray(avail_period, np.float32),
                         np.asarray(avail_duty, np.float32),
                         np.asarray(avail_phase, np.float32))
