"""The port's parameter trees (`repro_torch.tree`) against JAX's pytrees on
the CPU: list and tuple nodes walk in index order with the integer index
as the key, dicts in sorted-key order — `jax.tree_util.tree_flatten_with_path`'s
order, which is the flat gossip buffer's wire layout and the checkpoint
keys.  `from_paths` rebuilds lists, `tree_map` keeps lists and tuples,
and dict-only trees come out as before."""
import jax
import numpy as np
import pytest
import torch

from repro.core import partition as jpartition
from repro_torch import tree
from repro_torch.core import partition as tpartition
from repro_torch.optim import SGD, clip_by_global_norm


def _jax_key(path) -> tuple:
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


def _nested(seed: int, with_lists: bool):
    """A tree of small tensors: a list of 12 differently keyed dicts (the
    xLSTM layers: "10" and "11" would sort before "2" as strings) and a
    list of tuples (its decode cache) when with_lists, dicts only
    otherwise."""
    g = torch.Generator().manual_seed(seed)

    def t(*shape):
        return torch.randn(shape, generator=g)

    out = {"embed": t(3, 2), "final_norm": t(2),
           "attn": {"wq": t(2, 2), "b": {"z": t(1), "a": t(2)}}}
    if with_lists:
        out["layers"] = [{"ln": t(2), ("w_up" if i % 3 else "r"): t(2, 1)}
                         for i in range(12)]
        out["cache"] = [(t(1), t(2)), (t(3), t(1), t(2))]
    return out


@pytest.mark.parametrize("with_lists", [True, False])
def test_paths_follow_jax_treedef_order(with_lists):
    t = _nested(0, with_lists)
    j = jax.tree.map(lambda a: a.numpy(), t)
    want = [(_jax_key(p), leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(j)[0]]
    got = list(tree.paths(t))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)
    assert [x.numpy().tolist() for x in tree.leaves(t)] == \
        [x.tolist() for x in jax.tree.leaves(j)]
    if with_lists:
        layer_keys = [p[1] for p, _ in got if p[0] == "layers"]
        assert layer_keys == sorted(layer_keys) and 10 in layer_keys


@pytest.mark.parametrize("with_lists", [True, False])
def test_from_paths_inverts_paths(with_lists):
    t = _nested(1, with_lists)
    back = tree.from_paths(tree.paths(t))
    assert [p for p, _ in tree.paths(back)] == [p for p, _ in tree.paths(t)]
    if with_lists:
        assert isinstance(back["layers"], list) and len(back["layers"]) == 12
        # tuples come back as lists (paths cannot tell them apart)
        assert isinstance(back["cache"][1], list)
    else:
        assert back.keys() == t.keys()
    for p, leaf in tree.paths(t):
        assert tree.get(back, p) is leaf


def test_from_paths_keeps_a_pruned_list_in_its_order():
    # a list cut to some of its entries (split of a per-layer mask) stays
    # an int-keyed dict whose sorted keys keep the list's order
    items = [(("layers", i, "w"), torch.tensor([float(i)]))
             for i in (11, 2, 10)]
    t = tree.from_paths(items)
    assert isinstance(t["layers"], dict)
    assert [p[1] for p, _ in tree.paths(t)] == [2, 10, 11]


@pytest.mark.parametrize("with_lists", [True, False])
def test_tree_map_keeps_structure(with_lists):
    a, b = _nested(2, with_lists), _nested(3, with_lists)
    out = tree.tree_map(lambda x, y: x + y, a, b)
    ja = jax.tree.map(lambda x: x.numpy(), a)
    jb = jax.tree.map(lambda x: x.numpy(), b)
    want = jax.tree.map(lambda x, y: x + y, ja, jb)
    assert jax.tree.structure(jax.tree.map(lambda x: x.numpy(), out)) == \
        jax.tree.structure(want)
    for (p, x), (_, w) in zip(tree.paths(out),
                              jax.tree_util.tree_flatten_with_path(want)[0]):
        np.testing.assert_array_equal(x.numpy(), w, err_msg=str(p))
    if with_lists:
        assert isinstance(out["layers"], list)
        assert all(isinstance(c, tuple) for c in out["cache"])
    else:
        # dict-only trees keep their key order, as before
        assert list(out) == list(a) and list(out["attn"]["b"]) == ["z", "a"]


def test_partition_of_a_list_tree_matches_reference():
    # the mask's path strings ("layers/3/ln") are the reference's, and
    # split / merge invert each other with list nodes
    t = _nested(4, True)
    j = jax.tree.map(lambda a: a.numpy(), t)
    pred = (lambda path: not ("final_norm" in path or "layers/1" in path))
    tm = tpartition.build_mask(t, pred)
    jm = jpartition.build_mask(j, pred)
    assert [(p, v) for p, v in tree.paths(tm)] == [
        (_jax_key(p), v)
        for p, v in jax.tree_util.tree_flatten_with_path(jm)[0]]
    u, v = tpartition.split(t, tm)
    # "layers/1" names layers 1, 10 and 11: a list pruned to 9 entries
    assert sorted(v["layers"]) == [1, 10, 11]
    back = tpartition.merge(u, v)
    assert [p for p, _ in tree.paths(back)] == [p for p, _ in tree.paths(t)]
    assert isinstance(back["layers"], list)
    assert tpartition.count_params(t, tm, False) == sum(
        x.numel() for x in tree.leaves(v))


def test_sgd_and_clip_walk_list_trees():
    p, g = _nested(5, True), _nested(6, True)
    opt = SGD(lr=0.1, momentum=0.9, weight_decay=5e-4)
    new, st = opt.update(g, opt.init(p), p)
    assert isinstance(new["layers"], list)
    for path, x in tree.paths(new):
        want = tree.get(p, path) - 0.1 * (tree.get(g, path)
                                          + 5e-4 * tree.get(p, path))
        torch.testing.assert_close(x, want, rtol=0, atol=1e-7)
    clipped, norm = clip_by_global_norm(g, 1.0)
    want = torch.sqrt(sum(torch.sum(x * x) for x in tree.leaves(g)))
    torch.testing.assert_close(norm, want)
    assert isinstance(clipped["cache"][0], tuple)
