#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch/`) on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase; needs one GPU
    python3 chip_smoke.py --only build,kernels   # a subset, no final line

Phases, one JSON line each (any failed check exits nonzero and the final
line is never printed):

1. device   — the card's name and power limit; both TF32 flags set False
              (parity against f32 needs full-precision convs and matmuls);
2. build    — the CUDA kernels built from src/repro_torch/csrc/ (one nvcc
              per source, all started together);
3. kernels  — each kernel against its plain torch version on the card;
4. train    — run_experiment("dfedpgp", SimConfig(rounds=5)) at the paper
              defaults on CUDA; gossip_gather must launch once per round;
5. parity   — 2 rounds on CUDA and on the CPU from one init, tables and
              batches: the kernel on the main path against the plain path;
6. serve    — mixed-user batches served from the trained state through
              head_gather_matmul, against force="ref" and serve_naive;
7. timings  — each kernel at the main path's shape: kernel, plain and
              library-call ms (CUDA events), the card's bound, launches.

The last line is {"ok": true, "device": {...}}.  The script imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

PHASES = ("device", "build", "kernels", "train", "parity", "serve",
          "timings")
# published peaks (NVIDIA data sheets, dense): bytes/s of device memory and
# f32 FLOP/s outside the tensor cores
PEAKS = {"PCIe": (2.0e12, 51e12), "NVL": (3.9e12, 60e12),
         "SXM": (3.35e12, 67e12)}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def peaks_for(name: str):
    for key, val in PEAKS.items():
        if key != "SXM" and key in name:
            return key, val
    return "SXM", PEAKS["SXM"]


def time_ms(torch, fn, iters: int = 50, reps: int = 7) -> float:
    """Median over `reps` CUDA-event windows of `iters` back-to-back calls,
    per call, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def _device_events(prof):
    """Device-side profiler events (kernels, copies): a CPU op's device
    time is its kernels' again, so only these are summed."""
    return [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def device_ms(torch, fn, iters: int = 50) -> float:
    """Device time per call: the summed time of every kernel `fn` puts on
    the card (torch.profiler), over `iters` calls, after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = _device_events(prof)
    check(bool(events), "torch.profiler saw no device time")
    return sum(_dev_us(e) for e in events) / 1e3 / iters


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


# ---------------------------------------------------------------------------
def phase_device(ctx):
    torch = ctx["torch"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    bw_kind, (bw, f32) = peaks_for(name)
    ctx.update(name=name, smi=smi, peak_bw=bw, peak_f32=f32)
    emit("device", name=name, nvidia_smi=smi, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0],
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         peaks={"table": bw_kind, "bytes_per_s": bw, "f32_flop_per_s": f32})


def phase_build(ctx):
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build()
    seconds = time.perf_counter() - t0
    for name in _build.SOURCES:
        check(_build.artifact(name).exists(), f"{name} did not build")
    ptxas = {n: [ln.strip() for ln in info["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, info in built.items()}
    emit("build", seconds=round(seconds, 3), built=sorted(built),
         nvcc=_build.nvcc_path(), flags=list(_build.NVCC_FLAGS), ptxas=ptxas)


def _gather_case(torch, m, k, d, seed, dtype, repeat=True):
    g = torch.Generator(device="cuda").manual_seed(seed)
    idx = torch.randint(0, m, (m, k), generator=g, device="cuda",
                        dtype=torch.int32)
    if repeat and k > 1:
        idx[:, 1] = idx[:, 0]
    w = torch.rand((m, k), generator=g, device="cuda")
    w = (w / w.sum(1, keepdim=True)).contiguous()
    U = torch.randn((m, d), generator=g, device="cuda").to(dtype)
    return idx, w, U


def phase_kernels(ctx):
    torch = ctx["torch"]
    from repro_torch.core import gossip, topology
    from repro_torch.kernels import ops
    f32, bf16 = torch.float32, torch.bfloat16
    results = []

    # -- gossip_gather at the main path's shape: the random topology's
    # table, d_flat = 13,328.  f32 must equal mix_rows bit for bit.
    P = topology.get_schedule("random", 100, 10, 0).at(0).to("cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    U = torch.randn((100, 13328), generator=g, device="cuda")
    out = ops.gossip_gather(P.idx, P.w, U, force="cuda")
    torch.cuda.synchronize()
    exact = torch.equal(out, gossip.mix_rows(P.idx, P.w, U)) and \
        torch.equal(out, ops.gossip_gather(P.idx, P.w, U, force="ref"))
    check(exact, "gossip_gather f32 != mix_rows bit for bit at "
                 "(100, 11, 13328)")
    ctx["gossip_err"] = max_abs(out, gossip.mix_rows(P.idx, P.w, U))
    results.append({"kernel": "gossip_gather", "shape": [100, 11, 13328],
                    "dtype": "float32", "check": "bitwise == mix_rows",
                    "max_abs_err": ctx["gossip_err"], "ok": True})
    # bf16 U: kernel and plain version both accumulate in f32 in j order
    # and round once; tolerance one bf16 ulp (rtol/atol 8e-3)
    Ub = U.to(bf16)
    outb = ops.gossip_gather(P.idx, P.w, Ub, force="cuda")
    refb = ops.gossip_gather(P.idx, P.w, Ub, force="ref")
    err = max_abs(outb, refb)
    ok = torch.allclose(outb.float(), refb.float(), rtol=8e-3, atol=8e-3)
    check(ok and outb.dtype == bf16, f"gossip_gather bf16 err {err}")
    results.append({"kernel": "gossip_gather", "shape": [100, 11, 13328],
                    "dtype": "bfloat16", "check": "allclose(8e-3) vs ref",
                    "max_abs_err": err, "ok": True})

    # -- the bench_gossip grid and awkward shapes (repeated ids)
    cases = [(m, k, 4096) for m in (64, 256, 1024) for k in (2, 8, 16)]
    cases += [(13, 1, d) for d in (1, 5, 513)] + [(13, 3, 513), (1, 1, 1)]
    for i, (m, k, d) in enumerate(cases):
        for dtype in (f32, bf16):
            idx, w, Uc = _gather_case(torch, m, k, d, 100 + i, dtype)
            got = ops.gossip_gather(idx, w, Uc, force="cuda")
            want = ops.gossip_gather(idx, w, Uc, force="ref")
            err = max_abs(got, want)
            if dtype == f32:
                ok = torch.equal(got, want) and torch.equal(
                    got, gossip.mix_rows(idx, w, Uc))
            else:
                ok = torch.allclose(got.float(), want.float(), rtol=8e-3,
                                    atol=8e-3)
            check(ok and got.dtype == dtype,
                  f"gossip_gather {(m, k, d)} {dtype} err {err}")
            results.append({"kernel": "gossip_gather", "shape": [m, k, d],
                            "dtype": str(dtype).split(".")[-1],
                            "max_abs_err": err, "ok": True})
    empty = ops.gossip_gather(*(t[:0] for t in _gather_case(
        torch, 4, 2, 8, 0, f32)), force="cuda")
    check(empty.shape == (0, 8), "gossip_gather m=0")

    # -- head_gather_matmul: f32 accumulate in t order with FMAs vs the
    # plain einsum (cuBLAS f32, TF32 off): rtol/atol 1e-5
    def head_case(B, d, n, m, seed, hdt=f32, wdt=f32):
        gh = torch.Generator(device="cuda").manual_seed(seed)
        uid = torch.randint(0, m, (B,), generator=gh, device="cuda",
                            dtype=torch.int32)
        if B > 1:
            uid[-1] = uid[0]
        H = torch.randn((B, d), generator=gh, device="cuda").to(hdt)
        W = torch.randn((m, d, n), generator=gh, device="cuda").to(wdt)
        b = torch.randn((m, n), generator=gh, device="cuda").to(wdt)
        return uid, H, W, b

    hcases = [(B, 64, 10, 100, f32, f32) for B in (1, 64, 1024)]
    hcases += [(17, 64, 1, 100, f32, f32), (17, 64, 130, 100, f32, f32),
               (9, 1, 10, 7, f32, f32), (9, 65, 10, 7, f32, f32),
               (33, 64, 10, 100, bf16, f32), (33, 65, 130, 7, bf16, f32),
               (33, 64, 10, 100, bf16, bf16)]
    for i, (B, d, n, m, hdt, wdt) in enumerate(hcases):
        args = head_case(B, d, n, m, 200 + i, hdt, wdt)
        got = ops.head_gather_matmul(*args, force="cuda")
        want = ops.head_gather_matmul(*args, force="ref")
        err = max_abs(got, want)
        ok = got.dtype == f32 and torch.allclose(got, want, rtol=1e-5,
                                                 atol=1e-5)
        check(ok, f"head_gather_matmul {(B, d, n, m)} {hdt}/{wdt} err {err}")
        if (B, d, n) == (1024, 64, 10):
            ctx["head_err"] = err
        results.append({"kernel": "head_gather_matmul",
                        "shape": [B, d, n, m],
                        "dtype": f"{hdt}/{wdt}".replace("torch.", ""),
                        "max_abs_err": err, "ok": True})
    torch.cuda.synchronize()
    emit("kernels", cases=len(results), results=results)


def phase_train(ctx):
    torch = ctx["torch"]
    from repro_torch.fl.simulator import SimConfig, run_experiment
    from repro_torch.kernels import ops
    sim = SimConfig(rounds=5)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    hist = run_experiment("dfedpgp", sim, device="cuda", eval_every=1,
                          return_state=True)
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    check(counts["gossip_gather"] == sim.rounds,
          f"gossip_gather launched {counts['gossip_gather']} times in "
          f"{sim.rounds} rounds")
    check(all(map(lambda v: v == v and v < 1e3, hist["loss"])),
          f"non-finite loss {hist['loss']}")
    st = hist["state"]
    check(bool(torch.isfinite(st.flat).all()) and st.flat.shape
          == (sim.m, 13328) and st.flat.device.type == "cuda", "trained buffer")
    ctx.update(train_state=st, train_layout=hist["layout"], sim=sim,
               train_launches=counts)
    ms = [s * 1e3 for s in hist["round_s"]]
    emit("train", m=sim.m, n_neighbors=sim.n_neighbors, batch=sim.batch,
         k_local=sim.k_local, k_personal=sim.k_personal, rounds=sim.rounds,
         loss=hist["loss"], acc=hist["acc"], round_ms=ms,
         ms_per_round_after_first=statistics.median(ms[1:]),
         seconds=round(seconds, 3), launches=counts,
         mu_range=[float(st.mu.min()), float(st.mu.max())])


def phase_parity(ctx):
    torch = ctx["torch"]
    from repro_torch import tree
    from repro_torch.core import topology
    from repro_torch.data import make_dataset, sample_batches
    from repro_torch.fl.simulator import SimConfig, run_experiment
    from repro_torch.models import cnn
    sim = SimConfig(rounds=2)
    cfg = cnn.CNNConfig()
    data = make_dataset(7, sim.m, n_train=sim.n_train, n_test=sim.n_test)
    init = cnn.init_params(torch.Generator().manual_seed(7), cfg, (sim.m,))
    sched = topology.get_schedule("random", sim.m, sim.n_neighbors, 7)
    tables = [sched.at(r) for r in range(sim.rounds)]
    batches = [sample_batches(torch.Generator().manual_seed(70 + r), data,
                              sim.k_local + sim.k_personal, sim.batch)
               for r in range(sim.rounds)]
    states = {}
    for dev in ("cuda", "cpu"):
        h = run_experiment("dfedpgp", sim, device=dev, eval_every=1,
                           return_state=True, data=data, init_params=init,
                           topology_at=lambda r: tables[r],
                           batches_at=lambda r: batches[r])
        states[dev] = h["state"]
    a, b = states["cuda"], states["cpu"]
    # f32 on both devices (TF32 off); cuDNN and oneDNN sum convolutions and
    # GroupNorm in other orders, carried through 12 SGD steps: rtol 1e-4,
    # atol 5e-5
    errs = {}

    def cmp(name, x, y):
        errs[name] = max_abs(x.cpu(), y)
        check(torch.allclose(x.cpu(), y, rtol=1e-4, atol=5e-5),
              f"GPU vs CPU {name}: max abs err {errs[name]}")

    cmp("flat", a.flat, b.flat)
    cmp("mu", a.mu, b.mu)
    cmp("opt_u", a.opt_u.momentum, b.opt_u.momentum)
    for path, leaf in tree.paths(a.personal):
        cmp("personal/" + "/".join(path), leaf, tree.get(b.personal, path))
    for path, leaf in tree.paths(a.opt_v.momentum):
        cmp("opt_v/" + "/".join(path), leaf,
            tree.get(b.opt_v.momentum, path))
    emit("parity", rounds=sim.rounds, m=sim.m, rtol=1e-4, atol=5e-5,
         max_abs_err=errs)


def phase_serve(ctx):
    torch = ctx["torch"]
    from repro_torch import tree
    from repro_torch.data import make_dataset
    from repro_torch.kernels import ops
    from repro_torch.models import cnn
    from repro_torch.serve import from_train_state, make_cnn_server, \
        serve_naive
    sim = ctx["sim"]
    cfg = cnn.CNNConfig(image_size=sim.image_size, n_classes=sim.n_classes)
    sstate = from_train_state(ctx["train_state"], layout=ctx["train_layout"],
                              consensus="mass")
    # the test inputs run_experiment trained beside (same seed and sizes)
    data = make_dataset(sim.seed, sim.m, n_classes=sim.n_classes,
                        dist=sim.dist, alpha=sim.alpha, c=sim.c,
                        n_train=sim.n_train, n_test=sim.n_test,
                        size=sim.image_size, noise=sim.noise, device="cuda")
    server = make_cnn_server(sstate, cfg, device="cuda")
    server_ref = make_cnn_server(sstate, cfg, force="ref", device="cuda")
    models = tree.tree_map(lambda *a: torch.stack(a),
                           *[sstate.user_model(i) for i in range(sim.m)])
    rows = {}
    batches = {}
    g = torch.Generator(device="cuda").manual_seed(5)
    for B in (1, 64, 1024):
        uid = (torch.arange(B, device="cuda") % sim.m)[
            torch.randperm(B, generator=g, device="cuda")]
        col = torch.arange(B, device="cuda") // sim.m % sim.n_test
        batches[B] = (uid.to(torch.int32), data.x_test[uid, col].contiguous())
    ops.reset_launch_counts()
    calls = 0
    for B, (uid, x) in batches.items():
        got = server(uid, x)
        calls += 1
        want = server_ref(uid, x)
        naive = serve_naive(models, uid, x, cfg)
        torch.cuda.synchronize()
        e_ref, e_naive = max_abs(got, want), max_abs(got, naive)
        # head: t-ordered FMAs vs cuBLAS f32 -> rtol/atol 1e-5; naive runs
        # the trunk per request (batch 1): other conv algorithms -> 1e-4
        check(got.shape == (B, sim.n_classes) and got.dtype == torch.float32
              and bool(torch.isfinite(got).all()), f"serve B={B} output")
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
              f"serve B={B} vs force='ref': {e_ref}")
        check(torch.allclose(got, naive, rtol=1e-4, atol=1e-4),
              f"serve B={B} vs serve_naive: {e_naive}")
        lat = []
        for _ in range(30):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            server(uid, x)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            calls += 1
        rows[B] = {"p50_ms": statistics.median(lat), "max_abs_err_ref": e_ref,
                   "max_abs_err_naive": e_naive,
                   "acc_vs_labels": float(
                       (got.argmax(-1) == data.y_test[
                           uid.long(), torch.arange(B, device="cuda")
                           // sim.m % sim.n_test]).float().mean())}
    counts = ops.launch_counts()
    check(counts["head_gather_matmul"] == calls,
          f"head_gather_matmul launched {counts['head_gather_matmul']} "
          f"times in {calls} serve calls")
    check(counts["gossip_gather"] == 0, "serve launched gossip_gather")
    ctx["serve_launches"] = counts
    emit("serve", consensus="mass", users=sim.m, calls=calls,
         launches=counts, by_batch=rows)


def phase_timings(ctx):
    torch = ctx["torch"]
    from repro_torch.core import topology
    from repro_torch.kernels import ops
    bw, f32 = ctx["peak_bw"], ctx["peak_f32"]
    kernels = []

    def bound(nbytes, flops):
        t_b, t_o = nbytes / bw * 1e3, flops / f32 * 1e3
        return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")

    def measure(kernel, plain, library):
        """Device ms per call (profiler) and per-call ms of back-to-back
        calls (CUDA events, the Python wrapper's host time included)."""
        return {"ms": device_ms(torch, kernel),
                "plain_ms": device_ms(torch, plain),
                "library_ms": device_ms(torch, library),
                "call_ms": time_ms(torch, kernel),
                "plain_call_ms": time_ms(torch, plain),
                "library_call_ms": time_ms(torch, library)}

    # gossip_gather at the main path's shape
    m, k, d = 100, 11, 13328
    P = topology.get_schedule("random", m, 10, 0).at(0).to("cuda")
    U = torch.randn((m, d), device="cuda")
    rows = torch.arange(m, device="cuda")[:, None].expand(m, k)
    csr = torch.sparse_coo_tensor(
        torch.stack([rows.reshape(-1), P.idx.long().reshape(-1)]),
        P.w.reshape(-1), (m, m), check_invariants=True
    ).coalesce().to_sparse_csr()
    check(torch.allclose(torch.sparse.mm(csr, U),
                         ops.gossip_gather(P.idx, P.w, U), rtol=1e-5,
                         atol=1e-5), "sparse.mm yardstick disagrees")
    t = measure(lambda: ops.gossip_gather(P.idx, P.w, U, force="cuda"),
                lambda: ops.gossip_gather(P.idx, P.w, U, force="ref"),
                lambda: torch.sparse.mm(csr, U))
    b_ms, b_by = bound(2 * m * d * 4 + m * k * 8, 2 * m * k * d)
    kernels.append({
        "name": "gossip_gather", "route": "cuda",
        "source": "src/repro_torch/csrc/gossip_gather.cu",
        "replaces": "src/repro/kernels/gossip_gather.py:117",
        "launches": ctx["train_launches"]["gossip_gather"],
        "max_abs_err": ctx["gossip_err"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": t["library_ms"], "call_ms": t["call_ms"],
        "shape": [m, k, d], "dtype": "float32"})
    gossip_detail = dict(t, bound_us=b_ms * 1e3, bound_by=b_by)

    # head_gather_matmul at the serve path's shapes (m=100, d=64, n=10)
    per_b = {}
    m, d, n = 100, 64, 10
    W = torch.randn((m, d, n), device="cuda")
    bias = torch.randn((m, n), device="cuda")
    for B in (1, 64, 1024):
        uid = torch.randint(0, m, (B,), device="cuda", dtype=torch.int32)
        H = torch.randn((B, d), device="cuda")
        ul = uid.long()
        t = measure(
            lambda: ops.head_gather_matmul(uid, H, W, bias, force="cuda"),
            lambda: ops.head_gather_matmul(uid, H, W, bias, force="ref"),
            lambda: torch.baddbmm(bias[ul].unsqueeze(1), H.unsqueeze(1),
                                  W[ul]))
        users = int(torch.unique(uid).numel())
        nbytes = B * d * 4 + users * (d * n + n) * 4 + B * 4 + B * n * 4
        hb_ms, hb_by = bound(nbytes, 2 * B * d * n + B * n)
        per_b[B] = dict(t, bound_ms=hb_ms, bound_us=hb_ms * 1e3,
                        bound_by=hb_by, distinct_users=users)
    big = per_b[1024]
    kernels.append({
        "name": "head_gather_matmul", "route": "cuda",
        "source": "src/repro_torch/csrc/head_gather.cu",
        "replaces": "src/repro/kernels/head_gather.py:126",
        "launches": ctx["serve_launches"]["head_gather_matmul"],
        "max_abs_err": ctx["head_err"], "ms": big["ms"],
        "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"], "library_ms": big["library_ms"],
        "call_ms": big["call_ms"], "shape": [1024, 64, 10, 100],
        "dtype": "float32"})
    emit("timings", card=ctx["smi"], gossip_gather=gossip_detail,
         round_profile=profile_rounds(ctx),
         head_gather_matmul_by_batch=per_b,
         note="ms/plain_ms/library_ms: device time per call summed over "
              "the kernels each puts on the card (torch.profiler, 50 "
              "calls); *call_ms: median of CUDA-event windows of "
              "back-to-back calls, host time included; inputs warm in L2; "
              "bound_ms from the published peaks of the named card")
    ctx["kernels"] = kernels


def profile_rounds(ctx, rounds: int = 3) -> dict:
    """Where a round's time goes: torch.profiler over `rounds` resident
    rounds continuing from the trained state (after one warm round), with
    the device's busy share and the kernels that take most of it."""
    torch = ctx["torch"]
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import dfedpgp, partition, topology
    from repro_torch.data import make_dataset, sample_batches
    from repro_torch.models import cnn
    from repro_torch.optim import SGD
    sim, layout = ctx["sim"], ctx["train_layout"]
    cfg = cnn.CNNConfig(image_size=sim.image_size, n_classes=sim.n_classes)
    opt = SGD(lr=sim.lr, momentum=sim.momentum,
              weight_decay=sim.weight_decay)
    mask = partition.build_mask(cnn.init_params(torch.Generator(), cfg),
                                partition.classifier_personal)
    algo = dfedpgp.DFedPGP(loss_fn=lambda p, b: cnn.loss_fn(p, b, cfg),
                           mask=mask, opt_u=opt, opt_v=opt,
                           k_v=sim.k_personal, k_u=sim.k_local,
                           lr_decay=sim.lr_decay)
    data = make_dataset(sim.seed, sim.m, n_train=sim.n_train,
                        n_test=sim.n_test, device="cuda")
    sched = topology.get_schedule("random", sim.m, sim.n_neighbors, 1)
    kv = sim.k_personal

    def one_round(state, r):
        b = sample_batches(torch.Generator().manual_seed(500 + r), data,
                           sim.k_local + sim.k_personal, sim.batch)
        b = {"v": {k: a[:, :kv] for k, a in b.items()},
             "u": {k: a[:, kv:] for k, a in b.items()}}
        return algo.round_fn_flat(state, sched.at(r).to("cuda"), b,
                                  layout)[0]

    state = one_round(ctx["train_state"], 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for r in range(1, rounds + 1):
            state = one_round(state, r)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = _device_events(prof)
    check(bool(events), "torch.profiler saw no device time")
    busy_ms = sum(_dev_us(e) for e in events) / 1e3
    top = sorted(events, key=_dev_us, reverse=True)[:10]
    return {"rounds": rounds, "wall_ms_per_round": wall_ms / rounds,
            "device_busy_ms_per_round": busy_ms / rounds,
            "device_busy_share": busy_ms / wall_ms,
            "device_events_per_round": sum(e.count for e in events) / rounds,
            "top_device_kernels": [
                {"name": e.key[:90],
                 "ms_per_round": _dev_us(e) / 1e3 / rounds,
                 "calls_per_round": e.count / rounds} for e in top]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phases to run (default: all)")
    args = ap.parse_args(argv)
    only = [p for p in args.only.split(",") if p]
    unknown = sorted(set(only) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}; known: {PHASES}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no port package at {src / 'repro_torch'}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))

    ctx = {"torch": torch}
    wanted = set(only) | {"device"}
    needs = {"serve": {"train"}, "timings": {"kernels", "train", "serve"}}
    for phase in only:
        missing = needs.get(phase, set()) - wanted
        if missing:
            ap.error(f"phase {phase} needs {sorted(missing)}")
    fns = {"device": phase_device, "build": phase_build,
           "kernels": phase_kernels, "train": phase_train,
           "parity": phase_parity, "serve": phase_serve,
           "timings": phase_timings}
    t0 = time.perf_counter()
    for phase in PHASES:
        if phase in wanted:
            t_phase = time.perf_counter()
            fns[phase](ctx)
            torch.cuda.synchronize()
            print(f"# {phase}: {time.perf_counter() - t_phase:.1f} s",
                  file=sys.stderr, flush=True)
    check("jax" not in sys.modules and "repro" not in sys.modules,
          "the run imported jax or the JAX package")
    print(f"# total {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    if set(PHASES) - wanted:
        print("# partial run (--only): no final line", file=sys.stderr)
        return 0
    print(ctx["smi"], flush=True)
    print(json.dumps({"kernels": ctx["kernels"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
