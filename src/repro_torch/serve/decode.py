"""Personalized mixed-user decode of a dense LM, from a checkpoint.

Port of `examples/serve_decode.py`:

1. "train" an m-client DFedPGP fleet on the resident flat buffer and save
   its `FlatDFedPGPState` (`checkpoint.save_train_state`);
2. `serve.from_checkpoint` -> `ServingState`: the consensus trunk is
   unraveled once from the buffer; the personal leaves (final_norm and
   lm_head under the paper's split) stay stacked (m, ...);
3. decode a batch that mixes users, each request with its own uid: the
   trunk runs once per step for the whole batch against one shared KV
   cache (`dense.decode_hidden`); only the tail is per request: a gathered
   final_norm row, then `ops.head_gather_matmul` over the stacked
   (m, d_model, vocab) lm_head (the CUDA kernel on the card).

    python -m repro_torch.serve.decode [--arch qwen2-0.5b] [--device cpu]
"""
from __future__ import annotations

import argparse
import tempfile
import time

import torch

from ..checkpoint import save_train_state
from ..configs import get_reduced
from ..core import partition
from ..core.dfedpgp import DFedPGP
from ..device import resolve_device
from ..kernels import ops
from ..models import dense
from ..models import layers as L
from ..optim import SGD
from ..tree import tree_map
from .state import ServingState, from_checkpoint

CACHE_LEN = 64          # the shared trunk cache of a decode batch


def build_fleet(cfg, m: int, device="cuda"):
    """An m-client DFedPGP fleet of `cfg`'s dense model, each client from
    its own random init (a generator seeded 0 on `device`), on the
    resident buffer with every row set to client 0's shared part and mu =
    1 (an exactly consensused buffer, as a run reaches by gossiping) ->
    (FlatDFedPGPState, FlatLayout)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    stacked = tree_map(lambda *a: torch.stack(a), *[
        dense.init_params(gen, cfg, dev) for _ in range(m)])
    mask = partition.build_mask(stacked, partition.classifier_personal)
    algo = DFedPGP(loss_fn=lambda p, b: dense.loss_fn(p, b, cfg), mask=mask,
                   opt_u=SGD(lr=0.1), opt_v=SGD(lr=0.1))
    state, layout = algo.init_flat(stacked, device=dev)
    state = state._replace(flat=state.flat[0:1].repeat(m, 1),
                           mu=torch.ones_like(state.mu))
    return state, layout


def serve_step(sstate: ServingState, uid: torch.Tensor, cache: dict,
               tokens: torch.Tensor, pos: int, cfg, force: str = "auto"):
    """One mixed-user decode step: tokens (B, 1) of the requests of users
    uid (B,) int32 at absolute position `pos` -> ((B, vocab) f32 logits,
    new cache).  The trunk runs once for the batch; request r's hidden
    state is normalized with its user's final_norm row and multiplied by
    its user's lm_head slab, plus a zero bias, in one
    `ops.head_gather_matmul` (force as there)."""
    head_w = sstate.personal["lm_head"]
    fnorm = sstate.personal["final_norm"][uid.long()]
    head_b = torch.zeros((head_w.shape[0], head_w.shape[2]),
                         dtype=head_w.dtype, device=head_w.device)
    h, cache = dense.decode_hidden(sstate.trunk, cache, tokens, pos, cfg)
    hp = L.rms_norm(h[:, 0, :], fnorm.to(h.dtype), cfg.norm_eps)
    return ops.head_gather_matmul(uid, hp, head_w, head_b, force=force), \
        cache


def greedy(sstate: ServingState, uid: torch.Tensor, cfg, tokens: int):
    """`tokens` greedy steps for the requests of users uid from token 0,
    one shared cache of CACHE_LEN -> ((B, tokens) int64 sequences, the
    steps' (B, vocab) f32 logits)."""
    dev = uid.device
    B = uid.shape[0]
    cache = dense.init_cache(cfg, B, CACHE_LEN, device=dev)
    toks = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    out, logits_seen = [], []
    with torch.inference_mode():
        for t in range(tokens):
            logits, cache = serve_step(sstate, uid, cache, toks, t, cfg)
            toks = torch.argmax(logits, dim=-1, keepdim=True)
            out.append(toks[:, 0])
            logits_seen.append(logits)
    return torch.stack(out, dim=-1), logits_seen


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain torch path)")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch)
    if cfg.family != "dense":
        ap.error(f"--arch {args.arch}: this demo decodes the dense family")
    dev = resolve_device(args.device)
    m, B = args.clients, args.batch

    # -- a trained-like fleet, checkpointed ------------------------------
    state, layout = build_fleet(cfg, m, dev)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        save_train_state(ckpt_dir, 42, state)
        sstate, step = from_checkpoint(ckpt_dir, state, layout=layout,
                                       consensus=0)
    print(f"[serve] {cfg.arch_id}: restored step {step}; "
          f"{sstate.n_users()} users, trunk shared, personal="
          f"{sorted(sstate.personal)}")

    # -- mixed-user batched greedy decode --------------------------------
    uid = (torch.arange(B, device=dev) % m).to(torch.int32)
    t0 = time.perf_counter()
    seqs, _ = greedy(sstate, uid, cfg, args.tokens)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    print(f"[serve] {B} mixed-user requests x {args.tokens} tokens in "
          f"{dt:.2f}s ({B * args.tokens / dt:.0f} tok/s) on {dev}; one "
          f"trunk forward per step, per-request heads fused")
    for b in range(min(B, 4)):
        print(f"   req {b} (user {int(uid[b])})", seqs[b].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
