"""Tensor parallelism executed across the ranks of a client mesh's 'model'
group (what GSPMD executes of the reference's `sharding.RULES` on its
(data, model) mesh, `repro/launch/steps.py`).

The T ranks of one data index share each of its clients' models.  The
shard plan (`shard_plan`) takes every leaf's split dim from
`sharding.spec_for_path`, the placement the reference resolves (its
`_resolve` relocation included: granite-3-2b's vocab 49,155 moves the
split of `embed` and `lm_head` to d_model); model rank t holds the t-th of
T equal pieces along that dim, or the whole leaf where the plan
replicates it.  Every family runs its shards as Megatron does
(`ModelShards`, handed to its `loss_fn` as `tp=`):
- attention (every family's GQA / MQA, whisper's self and cross
  attention): wq / wk / wv and their biases column-parallel, the rank's
  H / T query heads at the full config's head dim, wo row-parallel.
  Where T divides n_kv_heads the rank holds whole KV heads; where the
  plan cuts K / V inside a head (recurrentgemma's one MQA head, qwen2's 2
  KV heads at T 4) the rank's K / V columns are all-gathered and the KV
  heads of its query heads taken (`ModelShards.kv`);
- SwiGLU: wg / wu column-parallel, wd row-parallel; where the hidden
  width is not a multiple of T (xlstm's sLSTM MLP, 2,047) the plan
  relocates them to d_model: wg / wu split over their input rows (each
  rank's partial products reduced before the gate) and wd over its
  output columns (all-gathered); whisper's GELU MLP: w1 / b1
  column-parallel, w2 row-parallel, b2 after the reduce;
- MoE (`models/moe.py`): each rank holds E / T experts and runs their
  slots of the replicated routing, its partial combine reduced; MLA: wq_a
  column-parallel (cq all-gathered before q_norm), wq_b / wkv_b over
  heads, wkv_a replicated, wo row-parallel;
- the RG-LRU (`models/hybrid.py`) and xLSTM's mLSTM / sLSTM
  (`models/ssm.py`) over their channels and heads, as their modules say;
- embed split over the vocabulary: a masked lookup, then `reduce`; split
  over d_model: the lookup of the rank's columns, then an all-gather
  (the rank's slice backward);
- lm_head split over the vocabulary: the rank's logits and the
  vocab-parallel cross-entropy (`ModelShards.xent`: each rank's
  logsumexp combined over the ranks by a max shift); split over d_model:
  the rank's slice of the features, then `reduce` of the partial logits.
Replicated work runs on a replicated stream whose gradient is whole on
every rank: a replicated tensor enters the rank's own work through `copy`
(identity forward, all-reduce backward), a partial result leaves it
through `reduce` (all-reduce forward, identity backward), and a split
activation joins the stream through `gather` (all-gather forward, the
rank's slice backward).  So every replicated leaf's gradient is whole and
equal on every rank, as `Executor.finish_grad` assumes.  `check_tp`
refuses the splits the forwards do not run.
The collectives are `torch.autograd.Function`s with a `setup_context` and
a `vmap` rule that runs the collective once on the batched tensor: a
collective is elementwise across ranks and every rank of a model group
holds the same clients in the same order, so the clients' dim rides along
under the rounds' `vmap(grad_and_value(...))`.  Each backward calls its
conjugate Function, so the backward's collectives are batched as well.

`Executor` is a rank's share of a Regime B round (`core/dfedpgp.py`,
`launch/steps.py`): the tree form stores each client's leaves as shards;
the resident form holds the columns [t d/T, (t+1) d/T) of its clients'
(d_flat,) rows and momentum (whole rows where d_flat % T != 0, as
`sharding.flat_buffer_spec` replicates them) and the personal tree as
shards.  A resident step all-gathers z = u / mu over the model group,
slices each leaf's shard inside the loss, zeroes the replicated leaves'
gradients on t != 0, reduce-scatters the row gradient over the model
group (each element sums one nonzero term, so it stays exact) and steps
its columns.

At T = 1 every shard is the whole leaf, every collective a one-rank copy
and the cross-entropy's combine exact (m + log(exp(0)) = m), so the
executor's loss and gradients are the plain loss's bit for bit.
"""
from __future__ import annotations

import re
from typing import Optional

import torch

from ..models import layers as L
from ..tree import from_paths, paths
from . import sharding

MODEL_AXES = ("model",)
# leaves whose relocated split the forward runs: embed / lm_head over
# d_model or replicated (`ModelShards.embed` / `.logits`), a SwiGLU's
# wg / wu over their input rows and wd over its output columns
# (`layers.swiglu`)
_ANY_SPLIT = re.compile(r"^(embed|lm_head)$")
_ROWS = re.compile(r"(shared|mlp)/w[gu]$")
_COLS = re.compile(r"(shared|mlp)/wd$")
# the leaf that splits whole query heads, by family
_HEAD_LEAF = re.compile(r"(attn/wq_b|attn/wq|(^|/)wq)$")


def _preferred_dim(path: str, shape) -> Optional[int]:
    """The dim of a leaf `sharding.RULES` asks to split ('model'), before
    `_resolve` relocates a split that does not divide; None where the rule
    replicates the leaf or no rule matches."""
    for pat, spec in sharding.RULES:
        if re.search(pat, path):
            lead = len(shape) - len(spec)
            if lead < 0 or sharding.TP not in spec:
                return None
            return lead + spec.index(sharding.TP)
    return None


def _forward_cuts(path: str, shape, dim: Optional[int]) -> bool:
    """The families' forwards run leaf `path` split on `dim` (None:
    replicated): the rule's own dim, or a relocation `_ANY_SPLIT`,
    `_ROWS` / `_COLS` name."""
    if dim == _preferred_dim(path, shape) or _ANY_SPLIT.search(path):
        return True
    n = len(shape)
    return (dim == n - 2 and _ROWS.search(path) is not None) or \
        (dim == n - 1 and _COLS.search(path) is not None)


def check_tp(cfg, T: int, template=None) -> None:
    """Refuse a split the executor cannot run: T < 1, and at T > 1 a T
    that does not divide n_heads (attention splits whole query heads) or,
    for moe, n_experts (whole experts), and a leaf the plan replicates or
    splits on a dim the family's forward does not cut.  Each refusal
    names the leaf and the dim.  `template`: one client's tree (meta
    tensors will do; default the config's, traced without memory)."""
    if T < 1:
        raise ValueError(f"tp={T}: want at least one model rank")
    if T == 1:
        return
    if template is None:
        from .steps import stacked_param_struct
        template = from_paths((p, x[0]) for p, x in
                              paths(stacked_param_struct(cfg, 1)))
    leaves = dict(paths(template))
    strs = {p: sharding.path_str(p) for p in leaves}

    def leaf(pattern) -> str:
        for p, x in leaves.items():
            if pattern.search(strs[p]):
                d = _preferred_dim(strs[p], tuple(x.shape))
                return f"leaf {strs[p]} {tuple(x.shape)}, dim {d}"
        return "no such leaf"

    for name, what, pattern in (
            ("n_heads", "query heads", _HEAD_LEAF),
            ("n_experts", "experts", re.compile(r"moe/wg$"))):
        n = getattr(cfg, name)
        if n and n % T:
            raise ValueError(f"tp={T} does not divide {name}={n} of "
                             f"{cfg.arch_id}: the forward splits whole "
                             f"{what} ({leaf(pattern)})")
    if cfg.kv_lora and not cfg.q_lora:
        raise ValueError(f"tp={T} on {cfg.arch_id}: MLA without q_lora "
                         f"({leaf(re.compile(r'attn/wq$'))}): the plan "
                         f"cuts the query head dim, which the forward does "
                         f"not cut")
    plan = shard_plan(template, T)
    for p, x in leaves.items():
        shape, dim = tuple(x.shape), plan[p]
        if not _forward_cuts(strs[p], shape, dim):
            want = _preferred_dim(strs[p], shape)
            got = "replicates it" if dim is None else \
                f"splits its dim {dim} ({shape[dim]})"
            raise ValueError(f"tp={T} on {cfg.arch_id}: leaf {strs[p]} "
                             f"{shape}: the plan {got}, where the forward "
                             f"splits dim {want} ({shape[want]}, not a "
                             f"multiple of {T})")


# ---------------------------------------------------------------------------
# the shard plan
# ---------------------------------------------------------------------------
def shard_plan(template, T: int) -> dict:
    """{path: split dim or None} of every leaf of a one-client tree (no
    client dim): the dim `sharding.spec_for_path` puts 'model' on at T
    ranks."""
    plan = {}
    for path, leaf in paths(template):
        spec = sharding.spec_for_path(sharding.path_str(path),
                                      tuple(leaf.shape), MODEL_AXES, T)
        plan[path] = spec.index("model") if "model" in spec else None
    return plan


def _split_dim(x: torch.Tensor, dim: Optional[int], lead: int):
    """dim + lead, or None where the plan replicates the leaf or x has no
    such dim (a tree-form momentum placeholder, (m,) per leaf)."""
    if dim is None or x.dim() <= dim + lead:
        return None
    return dim + lead


def take(x: torch.Tensor, dim: Optional[int], T: int, t: int,
         lead: int = 0) -> torch.Tensor:
    """The t-th of T pieces of x along dim (+ lead leading dims), a view;
    x itself where `_split_dim` finds none."""
    d = _split_dim(x, dim, lead)
    if d is None:
        return x
    n = x.shape[d] // T
    return x.narrow(d, t * n, n)


def shard_tree(tree, plan: dict, T: int, t: int, lead: int = 0,
               copy: bool = False):
    """Every leaf's t-th shard (`take`); with copy a shard that is not the
    whole leaf is copied out, so the caller may free the full tree."""
    def one(path, x):
        s = take(x, plan[path], T, t, lead)
        return s.clone() if copy and s.shape != x.shape else s
    return from_paths((p, one(p, x)) for p, x in paths(tree))


def unshard_tree(tree, plan: dict, T: int, group, lead: int = 0):
    """The whole leaves of a shard tree: each split leaf all-gathered over
    `group` (a collective: every rank of the group calls it)."""
    import torch.distributed as dist
    out = []
    for path, x in paths(tree):
        d = _split_dim(x, plan[path], lead)
        if d is not None:
            parts = [torch.empty_like(x) for _ in range(T)]
            dist.all_gather(parts, x.contiguous(), group=group)
            x = torch.cat(parts, dim=d)
        out.append((path, x))
    return from_paths(out)


# ---------------------------------------------------------------------------
# the collectives (Megatron's conjugate pairs), batched under vmap
# ---------------------------------------------------------------------------
def _single(name: str, old: str):
    """dist.<name> (torch >= 2.13), else its older name dist.<old>: the
    one-tensor all-gather and reduce-scatter, the same arguments."""
    import torch.distributed as dist
    return getattr(dist, name, None) or getattr(dist, old)


def _all_reduce(x: torch.Tensor, group, op=None) -> torch.Tensor:
    import torch.distributed as dist
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM if op is None else op,
                    group=group)
    return out


def _below(fn, x, *args):
    """A vmap rule's call of its Function on the unwrapped tensor: the
    Function again where a transform or autograd below the vmap still
    tracks x, else its forward directly (the rounds' case: vmap is their
    outermost transform).  Each extra pass through the Function costs as
    much host time as the collective itself."""
    if x.requires_grad or torch._C._functorch.is_functorch_wrapped_tensor(x):
        return fn.apply(x, *args)
    return fn.forward(x, *args)


class _Copy(torch.autograd.Function):
    """Copy to the model group: identity forward, all-reduce backward."""

    @staticmethod
    def forward(x, group):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _Reduce.apply(g, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _below(_Copy, x, group), in_dims[0]


class _Reduce(torch.autograd.Function):
    """Reduce from the model group: all-reduce (sum) forward, identity
    backward."""

    @staticmethod
    def forward(x, group):
        return _all_reduce(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return _Copy.apply(g, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _below(_Reduce, x, group), in_dims[0]


class _Max(torch.autograd.Function):
    """The elementwise max over the model group, without a gradient."""

    @staticmethod
    def forward(x, group):
        import torch.distributed as dist
        return _all_reduce(x, group, dist.ReduceOp.MAX)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, g):
        return None, None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _below(_Max, x, group), in_dims[0]


def _batch_first(x, in_dim):
    """The vmap rule's input with its batch dim (if any) in front, so the
    last dim stays the feature dim; -> (x, out dim)."""
    if in_dim is None:
        return x, None
    return x.movedim(in_dim, 0), 0


class _Gather(torch.autograd.Function):
    """All-gather along the last dim over the model group (T pieces in
    rank order) forward, the rank's slice backward."""

    @staticmethod
    def forward(x, group, T, t):
        import torch.distributed as dist
        parts = [torch.empty_like(x) for _ in range(T)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        return _Split.apply(g, *ctx.args), None, None, None

    @staticmethod
    def vmap(info, in_dims, x, group, T, t):
        x, out_dim = _batch_first(x, in_dims[0])
        return _below(_Gather, x, group, T, t), out_dim


class _Split(torch.autograd.Function):
    """The rank's slice of the last dim forward, all-gather backward."""

    @staticmethod
    def forward(x, group, T, t):
        n = x.shape[-1] // T
        return x.narrow(-1, t * n, n).clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, g):
        return _Gather.apply(g, *ctx.args), None, None, None

    @staticmethod
    def vmap(info, in_dims, x, group, T, t):
        x, out_dim = _batch_first(x, in_dims[0])
        return _below(_Split, x, group, T, t), out_dim


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=x.dtype, device=x.device)


class ModelShards:
    """What a family's forward needs to run model rank t's shard: the
    model group of T ranks, the plan's split dims of `embed` (0 vocab, 1
    d_model, None replicated) and `lm_head` (1 vocab, 0 d_model, None
    replicated), and `mlp_d_model`, the shard shapes (f, D / T) of the
    SwiGLU down projections whose split the plan relocated to d_model
    (`layers.swiglu` takes its route from it).  Passed to the families'
    `loss_fn(..., tp=)`."""

    def __init__(self, group, T: int, t: int, embed_dim, head_dim,
                 mlp_d_model=frozenset()):
        self.group, self.T, self.t = group, T, t
        self.embed_dim, self.head_dim = embed_dim, head_dim
        self.mlp_d_model = frozenset(mlp_d_model)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _Copy.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(x, self.group)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The T ranks' pieces of the last dim put together in rank order
        (onto the replicated stream); the rank's slice backward."""
        return _Gather.apply(x, self.group, self.T, self.t)

    def own(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The rank's t-th of T pieces of `dim` of x (a view): of a
        replicated tensor only after `copy`, so that the other ranks'
        pieces get their gradients there."""
        n = x.shape[dim] // self.T
        return x.narrow(dim, self.t * n, n)

    def kv(self, k: torch.Tensor, v: torch.Tensor, cfg):
        """The rank's K and V projections (B, S, Hkv hd / T) -> the KV
        heads of its H / T query heads, (B, S, h, hd) each.  Where T
        divides Hkv they are the rank's own whole heads; else the columns
        are all-gathered and enter through `copy`, and the rank takes the
        one KV head its query heads share (T / Hkv ranks to a head) or,
        where they straddle heads, each query head's own (g 1)."""
        B, S = k.shape[:2]
        H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        if Hkv % self.T == 0:
            return (k.reshape(B, S, Hkv // self.T, hd),
                    v.reshape(B, S, Hkv // self.T, hd))
        k = self.copy(self.gather(k)).reshape(B, S, Hkv, hd)
        v = self.copy(self.gather(v)).reshape(B, S, Hkv, hd)
        h, g = H // self.T, H // Hkv
        first = self.t * h
        if g % h == 0:
            j = first // g
            return k[:, :, j:j + 1], v[:, :, j:j + 1]
        ids = torch.arange(first, first + h, device=k.device) // g
        return k[:, :, ids], v[:, :, ids]

    def embed(self, table: torch.Tensor, tokens: torch.Tensor):
        """The replicated embeddings of `tokens` from the rank's shard of
        the (vocab, d_model) table."""
        if self.embed_dim == 0:
            n = table.shape[0]
            local = tokens - self.t * n
            inside = (local >= 0) & (local < n)
            rows = table[local.clamp(0, n - 1)]
            return self.reduce(torch.where(inside[..., None], rows,
                                           _zero(rows)))
        if self.embed_dim == 1:
            return _Gather.apply(table[tokens], self.group, self.T, self.t)
        return table[tokens]

    def logits(self, x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
        """Features (..., d_model) -> the rank's logits: its vocabulary
        slice (head split over the vocabulary) or all of them."""
        w = head.to(x.dtype)
        if self.head_dim == 1:
            return self.copy(x) @ w
        if self.head_dim == 0:
            n = w.shape[0]
            return self.reduce(self.copy(x)[..., self.t * n:
                                            (self.t + 1) * n] @ w)
        return x @ w

    def xent(self, logits: torch.Tensor, labels: torch.Tensor,
             ignore: int = -100) -> torch.Tensor:
        """`layers.softmax_xent` of the rank's logits (`logits`): where
        they are a vocabulary slice, each rank's logsumexp combined over
        the model group by a max shift (one rank: m + log(exp(0)) = m, the
        plain value bit for bit) and the label's logit taken from the rank
        that holds it."""
        if self.head_dim != 1:
            return L.softmax_xent(logits, labels, ignore)
        lf = logits.to(torch.promote_types(logits.dtype, torch.float32))
        lse_t = torch.logsumexp(lf, dim=-1)
        top = _Max.apply(lse_t.detach(), self.group)
        lse = top + torch.log(self.reduce(torch.exp(lse_t - top)))
        n = lf.shape[-1]
        local = labels - self.t * n
        inside = (local >= 0) & (local < n)
        ll = torch.gather(lf, -1, local.clamp(0, n - 1).long()[..., None])
        ll = self.reduce(torch.where(inside, ll[..., 0], _zero(lf)))
        nll = lse - ll
        w = (labels != ignore).to(torch.float32)
        return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)


# ---------------------------------------------------------------------------
# a rank's share of the Regime B round
# ---------------------------------------------------------------------------
class Executor:
    """Model rank t's share of the clients of its data index.

    cfg: the model; mesh: the client mesh (`mesh.make_host_mesh`);
    template: one client's tree (meta tensors will do); flat_layout: the
    resident buffer's layout (None for the tree form).  `model` is the
    `ModelShards` every family's loss runs on."""

    def __init__(self, cfg, mesh, template, flat_layout=None):
        T = mesh.shape["model"]
        check_tp(cfg, T, template)
        self.T, self.t, self.group = T, mesh.model_index, mesh.model_group
        self.plan = shard_plan(template, T)
        mlp_d_model = {(x.shape[-2], x.shape[-1] // T)
                       for p, x in paths(template)
                       if _COLS.search(sharding.path_str(p))
                       and self.plan[p] == x.dim() - 1}
        self.model = ModelShards(self.group, T, self.t,
                                 self.plan[("embed",)],
                                 self.plan[("lm_head",)], mlp_d_model)
        self.d_flat = self.cols = self.replicated = None
        if flat_layout is not None:
            d = flat_layout.d_flat
            self.d_flat = d
            self.cols = ((self.t * d // T, (self.t + 1) * d // T)
                         if d % T == 0 else (0, d))
            # the (offset, size) of each replicated shared leaf in a row
            self.replicated = tuple(
                (off, n) for p, off, n in zip(flat_layout.paths,
                                              flat_layout.offsets,
                                              flat_layout.sizes)
                if self.plan[p] is None)

    @property
    def whole_rows(self) -> bool:
        """The flat dim is replicated (d_flat % T != 0 at T > 1): every
        rank holds whole rows."""
        return self.T > 1 and self.cols[1] - self.cols[0] == self.d_flat

    @property
    def split_columns(self) -> bool:
        """The rank holds a split of each buffer row (T > 1 and d_flat %
        T == 0): a row's terms sum over the model group."""
        return self.cols is not None and \
            self.cols[1] - self.cols[0] < self.d_flat

    def loss_fn(self, api, cfg):
        """(params, batch) -> one client's loss on the rank's shards."""
        model = self.model
        return lambda p, batch: api.loss_fn(p, batch, cfg, tp=model)

    # -- trees ------------------------------------------------------------
    def shard(self, tree, lead: int = 1):
        """The rank's shards of a client-stacked tree (copies, so the full
        tree may be freed)."""
        return shard_tree(tree, self.plan, self.T, self.t, lead, copy=True)

    def unshard(self, tree, lead: int = 1):
        return unshard_tree(tree, self.plan, self.T, self.group, lead)

    def shard_row(self, shared: dict) -> dict:
        """One client's unraveled shared leaves -> the rank's shards
        (views: the gradient of the row is zero outside them)."""
        return shard_tree(shared, self.plan, self.T, self.t)

    # -- the resident buffer ----------------------------------------------
    def columns(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's columns of an (n, d_flat) buffer, copied out unless
        they are all of it."""
        lo, hi = self.cols
        return x if hi - lo == x.shape[1] else x[:, lo:hi].clone()

    def shard_state(self, state):
        """A FlatDFedPGPState of whole rows -> the rank's: the buffer's and
        its momentum's columns, the personal tree and its momentum as
        shards."""
        return state._replace(
            flat=self.columns(state.flat),
            opt_u=state.opt_u._replace(
                momentum=self.columns(state.opt_u.momentum)),
            personal=self.shard(state.personal),
            opt_v=state.opt_v._replace(
                momentum=self.shard(state.opt_v.momentum)))

    def unshard_state(self, state):
        """The rank's FlatDFedPGPState -> whole rows and leaves (a
        collective over the model group)."""
        return state._replace(
            flat=self._whole(state.flat),
            opt_u=state.opt_u._replace(
                momentum=self._whole(state.opt_u.momentum)),
            personal=self.unshard(state.personal),
            opt_v=state.opt_v._replace(
                momentum=self.unshard(state.opt_v.momentum)))

    def _whole(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist
        if self.whole_rows:
            return x
        parts = [torch.empty_like(x) for _ in range(self.T)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=1)

    def gather_z(self, flat: torch.Tensor, mu: torch.Tensor):
        """z = u / mu of the rank's (n, d_flat / T) columns, all-gathered
        over the model group into (n, d_flat) rows.  The rank's z is
        written into its slot of the gathered rows and each row gathers in
        place, so no second buffer of the columns exists."""
        if self.whole_rows:
            return (flat / mu[:, None]).to(flat.dtype)
        lo, hi = self.cols
        z = torch.empty((flat.shape[0], self.d_flat), dtype=flat.dtype,
                        device=flat.device)
        torch.div(flat, mu[:, None], out=z[:, lo:hi])
        gather = _single("all_gather_single", "all_gather_into_tensor")
        for i in range(z.shape[0]):
            gather(z[i], z[i, lo:hi], group=self.group)
        return z

    def row_norms(self, g: torch.Tensor) -> torch.Tensor:
        """(n,) f32 norms of the whole gradient rows from the rank's
        columns of them (`finish_grad`'s output): the squares summed over
        the model group where the columns are split (`obs.gauges.l2_norm`
        otherwise)."""
        import torch.distributed as dist
        from ..obs.gauges import sum_squares
        sq = sum_squares(g, dim=1)
        if self.split_columns:
            dist.all_reduce(sq, group=self.group)
        return torch.sqrt(sq)

    def finish_grad(self, g: torch.Tensor) -> torch.Tensor:
        """The (n, d_flat) row gradients of the rank's shards -> the
        gradients of its columns: the replicated leaves' zeroed on t != 0,
        then each row reduce-scattered over the model group in place (or
        all-reduced where the rank holds whole rows).  Every element sums
        one nonzero term."""
        import torch.distributed as dist
        g = g.contiguous()
        if self.t != 0:
            for off, n in self.replicated:
                g[:, off:off + n].zero_()
        if self.whole_rows:
            dist.all_reduce(g, group=self.group)
            return g
        lo, hi = self.cols
        scatter = _single("reduce_scatter_single", "reduce_scatter_tensor")
        for i in range(g.shape[0]):
            scatter(g[i, lo:hi], g[i], group=self.group)
        return g[:, lo:hi]
