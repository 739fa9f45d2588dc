"""Batched personalized inference over a ServingState (port of
`repro/serve/engine.py`).

A serve batch mixes many users: request r carries a user id uid[r] and an
input x[r].  The engine computes trunk features once for the whole batch
(the consensus shared representation is one model), then applies each
request's personal classifier through `ops.head_gather_matmul` — the CUDA
kernel on a GPU — with f32 accumulate.

`serve_naive` keeps the baseline shape of this path: every request runs
its user's full model.

Serve telemetry: pass `meter=ServeMeter()` to the server factories and
every call is timed on the host clock around a synchronized call (the
server waits for its logits on the card before the clock stops), tagged
fused / naive, and folded into rolling p50 / p99 / rps windows —
optionally emitted per call as "serve" records through any
`obs.MetricsSink`.  meter=None (the default) returns the plain server:
no sync, the same calls.
"""
from __future__ import annotations

import time
from collections import deque

import torch
from torch.func import vmap

from .. import obs, tree
from ..device import resolve_device
from ..kernels import ops
from ..models import cnn
from ..obs.report import percentile


def serve_logits(sstate, uid: torch.Tensor, x: torch.Tensor,
                 model_cfg: cnn.CNNConfig, force: str = "auto",
                 block_n: int | None = None) -> torch.Tensor:
    """Mixed-user batched CNN serve: (B,) uid + (B, H, W, C) x -> (B, n)
    f32 logits.  Features run once through the consensus trunk; the
    per-request head is the fused gather + matmul."""
    h = cnn.features(sstate.trunk, x, model_cfg)
    head = sstate.personal["classifier"]
    return ops.head_gather_matmul(uid.to(torch.int32), h, head["w"],
                                  head["b"], force=force, block_n=block_n)


class ServeMeter:
    """Rolling serve-latency histogram keyed by (path, batch) tag.

    Each `observe` folds one call's wall-clock into a bounded window (the
    last `window` calls per tag) and bumps the call counter; `stats`
    renders nearest-rank p50 / p99 latency plus rps at the median — the
    percentile `obs.report` applies to the emitted records.  `sink` gets
    one "serve" record per call (default NULL: in memory only)."""

    def __init__(self, sink=None, window: int = 1024, run: str = "serve"):
        self.sink = sink if sink is not None else obs.NULL_SINK
        self.window = int(window)
        self.run = run
        self._lat: dict = {}     # (path, batch) -> deque of latency_ms
        self._n: dict = {}       # (path, batch) -> total calls
        self._step = 0

    def observe(self, path: str, batch: int, latency_s: float) -> None:
        key = (path, int(batch))
        ms = latency_s * 1e3
        self._lat.setdefault(key, deque(maxlen=self.window)).append(ms)
        self._n[key] = self._n.get(key, 0) + 1
        self._step += 1
        self.sink.emit(obs.serve_record(
            run=self.run, step=self._step, path=path, batch=int(batch),
            latency_ms=ms, rps=(batch / latency_s if latency_s > 0
                                else None)))

    def latencies(self, path: str, batch: int) -> list:
        """The rolling window's raw per-call latencies (ms) of one tag."""
        return list(self._lat.get((path, int(batch)), ()))

    def clear(self, path: str, batch: int) -> None:
        """Drop one tag's window (e.g. warm-up calls); the call counter
        keeps counting."""
        self._lat.get((path, int(batch)), deque()).clear()

    def stats(self) -> list:
        """-> [{path, batch, calls, p50_ms, p99_ms, rps}] sorted by tag,
        over each tag's rolling window (cleared tags are skipped)."""
        rows = []
        for (path, batch), lats in sorted(self._lat.items()):
            xs = list(lats)
            if not xs:
                continue
            p50 = percentile(xs, 50)
            rows.append({
                "path": path, "batch": batch, "calls": self._n[(path, batch)],
                "p50_ms": p50, "p99_ms": percentile(xs, 99),
                "rps": (batch / (p50 * 1e-3)) if p50 > 0 else None,
            })
        return rows


def _metered(serve_fn, meter: ServeMeter, path: str):
    """Wrap a server with host-side timing: call, wait for the logits on
    the card (`torch.cuda.synchronize`; nothing to wait for on the CPU),
    observe — so the number is the call's latency, not its launch time."""
    def timed(uid, x):
        t0 = time.perf_counter()
        out = serve_fn(uid, x)
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        meter.observe(path, uid.shape[0], time.perf_counter() - t0)
        return out

    return timed


def make_cnn_server(sstate, model_cfg: cnn.CNNConfig, force: str = "auto",
                    block_n: int | None = None, device="cuda",
                    meter: ServeMeter | None = None):
    """-> serve(uid, x) -> (B, n) f32 logits, closed over the serving state
    moved to `device` once.  Inputs are moved to that device per call
    (a no-op when they already lie there); no autograd graph is built.
    meter: optional ServeMeter — calls are then timed and tagged
    path="fused"."""
    dev = resolve_device(device)
    resident = sstate.to(dev)

    @torch.no_grad()
    def serve(uid, x):
        return serve_logits(resident, uid.to(dev), x.to(dev), model_cfg,
                            force=force, block_n=block_n)

    return serve if meter is None else _metered(serve, meter, "fused")


def serve_naive(models: dict, uid: torch.Tensor, x: torch.Tensor,
                model_cfg: cnn.CNNConfig) -> torch.Tensor:
    """Baseline: stacked (m, ...) full personalized models; every request
    gathers its user's whole parameter tree and runs its own forward — no
    feature sharing, no fused head."""
    u = uid.long()
    per_request = tree.tree_map(lambda a: a[u], models)

    def one(p, xr):
        return cnn.logits_fn(p, xr[None], model_cfg)[0]

    with torch.no_grad():
        return vmap(one)(per_request, x)


def make_naive_server(models: dict, model_cfg: cnn.CNNConfig,
                      meter: ServeMeter | None = None, device="cuda"):
    """-> serve(uid, x) over `serve_naive`, closed over the stacked full
    models moved to `device` once.  meter: optional ServeMeter — calls are
    then timed and tagged path="naive"."""
    dev = resolve_device(device)
    resident = tree.tree_map(lambda a: a.to(dev), models)

    def serve(uid, x):
        return serve_naive(resident, uid.to(dev), x.to(dev), model_cfg)

    return serve if meter is None else _metered(serve, meter, "naive")
