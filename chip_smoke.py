#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch/`) on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase; needs one GPU
    python3 chip_smoke.py --only build,kernels   # a subset, no final line

Phases, one JSON line each (any failed check exits nonzero and the final
line is never printed):

1. device     — the card's name and power limit; both TF32 flags set False
                (parity against f32 needs full-precision convs and matmuls);
2. build      — the CUDA kernels built from src/repro_torch/csrc/ (one
                nvcc per source, all started together);
3. kernels    — each kernel against its plain torch version on the card,
                at the main paths' shapes and awkward ones;
4. train      — run_experiment("dfedpgp", SimConfig(rounds=5)) at the paper
                defaults on CUDA; gossip_gather must launch once per round;
5. parity     — 2 rounds on CUDA and on the CPU from one init, tables and
                batches: the kernel on the main path against the plain path;
6. sampled    — run_experiment with participation="uniform", frac 0.25:
                gossip_scatter twice and gossip_gather once per round,
                dormant clients frozen bit for bit, sum(mu) = m; one
                sample-all round against round_fn_flat;
7. kernel_mix — 3 rounds of DFedPGP(mix_fn_flat=make_kernel_mix_flat()):
                pushsum_mix once per round; one round against "sparse";
                2 tree-form rounds (SimConfig(resident=False));
8. compress   — run_experiment with codec="topk", gossip="pallas": one
                topk_gather and one gossip_gather per round, the exact
                wire_bytes meter (and the uncompressed one of `train`), a
                crossing on the card against the CPU, value conservation
                on a ring, gamma "auto" and qsgd rounds, sampled codec
                rounds (4 gossip_scatter per round, dormant rows frozen);
9. serve      — mixed-user batches served from the trained state through
                head_gather_matmul, against force="ref" and serve_naive;
10. timings   — each kernel at its path's shape: kernel, plain and
                library-call ms (CUDA events), the card's bound, launches;
                profiles of a full, a sampled and a codec round.

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

PHASES = ("device", "build", "kernels", "train", "parity", "sampled",
          "kernel_mix", "compress", "serve", "timings")
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
    results += _scatter_cases(ctx)
    results += _pushsum_cases(ctx)
    results += _topk_cases(ctx)
    torch.cuda.synchronize()
    emit("kernels", cases=len(results), results=results)


def _scatter_cases(ctx):
    """gossip_scatter against its plain version on the card: f32 and bf16
    U, f32 X into a bf16 U, set and accumulate, unsorted rows, n in {0, 1,
    25, m}, d in {1, 5, 513, 13,328} (13,328 takes the vector path, the
    others and a 4-byte-offset X the scalar one).  Set is an exact copy and
    accumulate one f32 add then one rounding on both sides: bitwise.  The
    kernel writes into U's storage: data_ptr unchanged, dormant rows
    untouched."""
    torch = ctx["torch"]
    from repro_torch.kernels import ops
    f32, bf16 = torch.float32, torch.bfloat16
    m, results, worst = 100, [], 0.0
    g = torch.Generator(device="cuda").manual_seed(7)
    cases = [(n, d, xt, ut, acc) for n in (0, 1, 25, m)
             for d in (1, 5, 513, 13328)
             for xt, ut in ((f32, f32), (bf16, bf16), (f32, bf16))
             for acc in (False, True)]
    for i, (n, d, xt, ut, acc) in enumerate(cases):
        rows = torch.randperm(m, generator=g, device="cuda")[:n].to(
            torch.int32)
        X = torch.randn((n, d), generator=g, device="cuda").to(xt)
        if i % 7 == 3 and n:
            # a 4-byte offset: the kernel must fall back to scalar access
            X = torch.empty(n * d + 1, device="cuda", dtype=xt)[1:].view(
                n, d).copy_(X)
        U0 = torch.randn((m, d), generator=g, device="cuda").to(ut)
        U, want = U0.clone(), U0.clone()
        ptr = U.data_ptr()
        got = ops.gossip_scatter(rows, X, U, accumulate=acc, force="cuda")
        ops.gossip_scatter(rows, X, want, accumulate=acc, force="ref")
        torch.cuda.synchronize()
        dormant = torch.ones(m, dtype=torch.bool, device="cuda")
        dormant[rows.long()] = False
        err = max_abs(got, want)
        worst = max(worst, err)
        check(got is U and U.data_ptr() == ptr and got.dtype == ut,
              f"gossip_scatter {(n, d)} did not write in place")
        check(torch.equal(got, want) and torch.equal(got[dormant],
                                                     U0[dormant]),
              f"gossip_scatter {(n, d)} X {xt} U {ut} acc={acc} err {err}")
        results.append({"kernel": "gossip_scatter", "shape": [m, n, d],
                        "dtype": f"{xt}->{ut}".replace("torch.", ""),
                        "accumulate": acc, "check": "bitwise == ref",
                        "max_abs_err": err, "ok": True})
    ctx["scatter_err"] = worst
    return results


def _pushsum_cases(ctx):
    """pushsum_mix against P.float() @ U.float() (cuBLAS, TF32 off) at m in
    {1, 7, 8, 100, 257}, d in {1, 511, 513, 13,328}, f32 and bf16 U.  Both
    sum m f32 products in other orders: rtol/atol 1e-5 for f32 U; a bf16
    output rounds once on each side, so one bf16 ulp, rtol/atol 8e-3."""
    torch = ctx["torch"]
    from repro_torch.kernels import ops
    f32, bf16 = torch.float32, torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(11)
    results, worst = [], {}
    for m in (1, 7, 8, 100, 257):
        P = torch.rand((m, m), generator=g, device="cuda")
        P = (P / P.sum(1, keepdim=True)).contiguous()
        for d in (1, 511, 513, 13328):
            U32 = torch.randn((m, d), generator=g, device="cuda")
            for dt in (f32, bf16):
                U = U32.to(dt)
                got = ops.pushsum_mix(P, U, force="cuda")
                want = (P.float() @ U.float()).to(dt)
                torch.cuda.synchronize()
                tol = 1e-5 if dt == f32 else 8e-3
                err = max_abs(got, want)
                worst[str(dt)] = max(worst.get(str(dt), 0.0), err)
                check(got.dtype == dt and torch.allclose(
                    got.float(), want.float(), rtol=tol, atol=tol),
                    f"pushsum_mix {(m, d)} {dt} err {err}")
                if (m, d, dt) == (100, 13328, f32):
                    ctx["pushsum_err"] = err
                results.append({"kernel": "pushsum_mix", "shape": [m, d],
                                "dtype": str(dt).split(".")[-1],
                                "rtol_atol": tol, "max_abs_err": err,
                                "ok": True})
    empty = ops.pushsum_mix(torch.zeros((0, 0), device="cuda"),
                            torch.zeros((0, 8), device="cuda"), force="cuda")
    check(empty.shape == (0, 8), "pushsum_mix m=0")
    ctx["pushsum_worst_err"] = worst
    return results


def _payload_case(torch, m, k, d, K, seed, vdt, cdt, repeat=True,
                  dup=False, oob=False):
    """Random neighbor table and sparse payload on the card: K distinct
    columns per row (the codec's contract) unless `dup` repeats one, and
    `oob` puts one column at d + 3 (dropped)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    idx = torch.randint(0, m, (m, k), generator=g, device="cuda",
                        dtype=torch.int32)
    if repeat and k > 1:
        idx[:, 1] = idx[:, 0]
    w = torch.rand((m, k), generator=g, device="cuda")
    w = (w / w.sum(1, keepdim=True)).contiguous()
    vals = torch.randn((m, K), generator=g, device="cuda").to(vdt)
    cols = torch.rand((m, d), generator=g, device="cuda").topk(
        K, dim=1).indices
    if dup and K > 1:
        cols[:, -1] = cols[:, 0]
    if oob:
        cols[:, 0] = d + 3
    return idx, w, vals, cols.to(cdt).contiguous()


def _topk_cases(ctx):
    """topk_gather against topk_gather_ref on the card: the JAX sweep
    shapes (tests/test_compress.py:165-167), the codec path's shape
    (m 100, k 11, K 833, d 13,328) with its real table and with k = 1,
    repeated neighbor ids, f32 and bf16 values, uint16 and int32 columns
    (d > 65535 takes int32), out-of-range columns, duplicate columns, and
    block_d of 128 and of a whole row (dynamic shared memory above 48 KB).
    Both sum each column's neighbors in j order with rounded products and
    round once: bitwise where a row's columns are distinct; duplicates add
    in the atomics' order, rtol/atol 2e-5 (f32) and 8e-3 (bf16).  Also the
    codec wire's uint16 on the card: the int64 -> uint16 cast and a
    host/device copy."""
    torch = ctx["torch"]
    from repro_torch.core import gossip, topology
    from repro_torch.kernels import ops
    f32, bf16, u16, i32 = (torch.float32, torch.bfloat16, torch.uint16,
                           torch.int32)
    ids = torch.arange(65536, device="cuda")
    wire = ids.to(u16)
    check(torch.equal(wire.cpu().cuda().long(), ids) and wire.dtype == u16,
          "uint16 cast / host-device copy on the card")
    results = [{"kernel": "topk_gather", "check": "int64 -> uint16 cast "
                "and host/device copy on the card", "ok": True}]
    Pw = gossip.wire_only(topology.get_schedule("random", 100, 10, 0).at(
        0).to("cuda"))
    cases = [dict(m=m, k=k, d=d, K=K) for m, k, d, K in (
        (5, 2, 64, 3), (33, 4, 1100, 17), (8, 1, 512, 1), (17, 3, 129, 129),
        (16, 4, 700, 44), (100, 11, 13328, 833), (100, 1, 13328, 833),
        (13, 3, 70001, 500), (7, 0, 50, 5))]
    cases += [dict(m=9, k=3, d=260, K=20, oob=True),
              dict(m=9, k=3, d=260, K=20, dup=True),
              dict(m=100, k=11, d=13328, K=833, table=True),
              dict(m=37, k=5, d=13328, K=833, block_d=128),
              dict(m=37, k=5, d=13328, K=833, block_d=13328)]
    worst = {}
    for i, c in enumerate(cases):
        m, k, d, K = c["m"], c["k"], c["d"], c["K"]
        cdts = (i32,) if d > 65535 else (u16, i32)
        for vdt in (f32, bf16):
            for cdt in cdts:
                idx, w, vals, cols = _payload_case(
                    torch, m, k, d, K, 300 + i, vdt, cdt,
                    dup=c.get("dup", False), oob=c.get("oob", False))
                if c.get("table"):
                    idx, w = Pw.idx, Pw.w.contiguous()
                got = ops.topk_gather(idx, w, vals, cols, d, force="cuda",
                                      block_d=c.get("block_d"))
                want = ops.topk_gather(idx, w, vals, cols, d, force="ref")
                torch.cuda.synchronize()
                err = max_abs(got, want)
                bitwise = torch.equal(got, want)
                tol = 2e-5 if vdt == f32 else 8e-3
                if c.get("dup"):
                    ok = torch.allclose(got.float(), want.float(), rtol=tol,
                                        atol=tol)
                    check_name = f"allclose({tol}) vs ref"
                else:
                    ok = bitwise
                    check_name = "bitwise == ref"
                key = f"{vdt}/{cdt}".replace("torch.", "")
                worst[key] = max(worst.get(key, 0.0), err)
                check(ok and got.dtype == vdt and got.shape == (m, d),
                      f"topk_gather {c} {key} err {err} bitwise {bitwise}")
                if (m, k, K, vdt, cdt) == (100, 11, 833, f32, u16) \
                        and c.get("table"):
                    ctx["topk_err"] = err
                results.append({"kernel": "topk_gather", "shape": [m, k, d, K],
                                "dtype": key, "case": {
                                    n: v for n, v in c.items()
                                    if n not in ("m", "k", "d", "K")},
                                "check": check_name, "bitwise": bitwise,
                                "max_abs_err": err, "ok": True})
    empty = ops.topk_gather(*(t[:0] for t in _payload_case(
        torch, 4, 2, 8, 3, 0, f32, u16)), 8, force="cuda")
    check(empty.shape == (0, 8), "topk_gather m=0")
    ctx["topk_worst_err"] = worst
    return results


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
               train_launches=counts, train_hist=hist)
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


def _paper_algo(sim, torch, **kw):
    """The DFedPGP run_experiment builds at the paper defaults, with extra
    fields `kw` (e.g. mix_fn_flat)."""
    from repro_torch.core import dfedpgp, partition
    from repro_torch.models import cnn
    from repro_torch.optim import SGD
    cfg = cnn.CNNConfig(image_size=sim.image_size, n_classes=sim.n_classes)
    opt = SGD(lr=sim.lr, momentum=sim.momentum,
              weight_decay=sim.weight_decay)
    mask = partition.build_mask(cnn.init_params(torch.Generator(), cfg),
                                partition.classifier_personal)
    return dfedpgp.DFedPGP(loss_fn=lambda p, b: cnn.loss_fn(p, b, cfg),
                           mask=mask, opt_u=opt, opt_v=opt,
                           k_v=sim.k_personal, k_u=sim.k_local,
                           lr_decay=sim.lr_decay, **kw), cfg


def _clone_flat_state(state):
    from repro_torch import tree
    from repro_torch.core.dfedpgp import FlatDFedPGPState
    from repro_torch.optim import SGDState

    def c(a):
        return None if a is None else a.clone()
    return FlatDFedPGPState(
        c(state.flat), tree.tree_map(c, state.personal), c(state.mu),
        SGDState(c(state.opt_u.momentum)),
        SGDState(tree.tree_map(c, state.opt_v.momentum)), c(state.round),
        c(state.ef), c(state.ref))


def _round_batches(sim, data, seed, torch):
    from repro_torch.data import sample_batches
    b = sample_batches(torch.Generator().manual_seed(seed), data,
                       sim.k_local + sim.k_personal, sim.batch)
    kv = sim.k_personal
    return {"v": {k: a[:, :kv] for k, a in b.items()},
            "u": {k: a[:, kv:] for k, a in b.items()}}


def phase_sampled(ctx):
    """Partial participation at the paper defaults: 5 rounds of 25 of 100
    clients through run_experiment, then one sample-all round against
    round_fn_flat from the same state."""
    torch = ctx["torch"]
    from repro_torch import tree
    from repro_torch.core import sampling, topology
    from repro_torch.data import make_dataset
    from repro_torch.fl.simulator import SimConfig, run_experiment
    from repro_torch.kernels import ops
    from repro_torch.models import cnn
    sim = SimConfig(rounds=5, participation="uniform",
                    participation_frac=0.25)
    cfg = cnn.CNNConfig(image_size=sim.image_size, n_classes=sim.n_classes)
    init = cnn.init_params(torch.Generator().manual_seed(3), cfg, (sim.m,))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    hist = run_experiment("dfedpgp", sim, device="cuda", eval_every=1,
                          return_state=True, init_params=init)
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    check(counts["gossip_scatter"] == 2 * sim.rounds
          and counts["gossip_gather"] == sim.rounds
          and counts["pushsum_mix"] == 0,
          f"sampled run launches {counts} in {sim.rounds} rounds")
    check(all(map(lambda v: v == v and v < 1e3, hist["loss"])),
          f"non-finite loss {hist['loss']}")
    st, layout = hist["state"], hist["layout"]
    sampler = sampling.get_sampler("uniform", sim.m, sim.participation_frac,
                                   sim.seed)
    ever = torch.zeros(sim.m, dtype=torch.bool)
    for r in range(sim.rounds):
        ever[torch.as_tensor(sampler.active_at(r)).long()] = True
    dormant = (~ever).cuda()
    algo, _ = _paper_algo(sim, torch)
    st0, _ = algo.init_flat(init, device="cuda")
    frozen = torch.equal(st.flat[dormant], st0.flat[dormant]) and \
        torch.equal(st.mu[dormant], st0.mu[dormant]) and \
        torch.equal(st.opt_u.momentum[dormant], st0.opt_u.momentum[dormant])
    for path, leaf in tree.paths(st.personal):
        frozen &= torch.equal(leaf[dormant],
                              tree.get(st0.personal, path)[dormant])
    check(bool(dormant.any()) and frozen,
          f"{int(dormant.sum())} dormant clients: rows not frozen")
    check(bool((st.flat[~dormant] != st0.flat[~dormant]).any()),
          "active rows did not move")
    mu_sum = float(st.mu.sum())
    check(abs(mu_sum - sim.m) <= 1e-6 * sim.m, f"sum mu = {mu_sum}")

    # sample-all on the sampled path vs round_fn_flat, one round from one
    # state (same tables, batches): the same local steps on the same rows;
    # the mixes sum in one order.  Tolerance rtol 1e-5, atol 1e-6; whether
    # it came out bitwise is reported
    data = make_dataset(sim.seed, sim.m, n_train=sim.n_train,
                        n_test=sim.n_test, device="cuda")
    P = topology.get_schedule("random", sim.m, sim.n_neighbors, 9).at(0)
    b = _round_batches(sim, data, 900, torch)
    everyone = torch.arange(sim.m, dtype=torch.int32)
    ops.reset_launch_counts()
    a_state, _ = algo.round_fn_sampled(
        _clone_flat_state(st), topology.induced_subgraph(P, everyone).to(
            "cuda"), everyone, b, layout)
    sample_all_counts = ops.launch_counts()
    f_state, _ = algo.round_fn_flat(_clone_flat_state(st), P.to("cuda"), b,
                                    layout)
    torch.cuda.synchronize()
    errs, bitwise = {}, True
    for name, x, y in (("flat", a_state.flat, f_state.flat),
                       ("mu", a_state.mu, f_state.mu),
                       ("opt_u", a_state.opt_u.momentum,
                        f_state.opt_u.momentum)):
        errs[name] = max_abs(x, y)
        bitwise &= torch.equal(x, y)
        check(torch.allclose(x, y, rtol=1e-5, atol=1e-6),
              f"sample-all vs round_fn_flat {name}: {errs[name]}")
    ms = [s * 1e3 for s in hist["round_s"]]
    emit("sampled", m=sim.m, frac=sim.participation_frac,
         n_active=sampler.n_active, rounds=sim.rounds, launches=counts,
         loss=hist["loss"], acc=hist["acc"], round_ms=ms,
         ms_per_round_after_first=statistics.median(ms[1:]),
         seconds=round(seconds, 3), dormant_clients=int(dormant.sum()),
         dormant_rows_frozen=True, mu_sum=mu_sum,
         sample_all={"launches": sample_all_counts, "rtol": 1e-5,
                     "atol": 1e-6, "max_abs_err": errs,
                     "bitwise": bool(bitwise)})
    ctx.update(sampled_launches=counts, sampled_state=st)


def phase_kernel_mix(ctx):
    """3 rounds of DFedPGP(mix_fn_flat=make_kernel_mix_flat()) at the paper
    defaults: the dense pushsum_mix kernel, once per round; then one round
    from one state against the default "sparse" round; then 2 tree-form
    rounds through run_experiment(resident=False)."""
    torch = ctx["torch"]
    from repro_torch.core import topology
    from repro_torch.core.kernel_mix import make_kernel_mix_flat
    from repro_torch.data import make_dataset
    from repro_torch.fl.simulator import SimConfig, run_experiment
    from repro_torch.kernels import ops
    from repro_torch.models import cnn
    sim = SimConfig()
    algo, cfg = _paper_algo(sim, torch, mix_fn_flat=make_kernel_mix_flat())
    sparse_algo, _ = _paper_algo(sim, torch)
    data = make_dataset(sim.seed, sim.m, n_train=sim.n_train,
                        n_test=sim.n_test, device="cuda")
    init = cnn.init_params(torch.Generator().manual_seed(4), cfg, (sim.m,))
    state, layout = algo.init_flat(init, device="cuda")
    sched = topology.get_schedule("random", sim.m, sim.n_neighbors, 4)
    rounds, ms, losses = 3, [], []
    ops.reset_launch_counts()
    for r in range(rounds):
        b = _round_batches(sim, data, 400 + r, torch)
        t0 = time.perf_counter()
        state, metrics = algo.round_fn_flat(state, sched.at(r).to("cuda"),
                                            b, layout)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss_u"]))
    counts = ops.launch_counts()
    check(counts["pushsum_mix"] == rounds and counts["gossip_gather"] == 0,
          f"kernel-mix run launches {counts} in {rounds} rounds")
    mu_sum = float(state.mu.sum())
    check(bool(torch.isfinite(state.flat).all())
          and abs(mu_sum - sim.m) <= 1e-5 * sim.m,
          f"kernel-mix state: finite flat, sum mu {mu_sum}")
    # one round from one state: dense P sums 100 terms (89 exact zeros)
    # with FMAs in column order, the sparse gather 11 in neighbor order
    # with rounded products: rtol 1e-5, atol 1e-6
    b = _round_batches(sim, data, 499, torch)
    P = sched.at(rounds).to("cuda")
    dense, _ = algo.round_fn_flat(_clone_flat_state(state), P, b, layout)
    sparse, _ = sparse_algo.round_fn_flat(_clone_flat_state(state), P, b,
                                          layout)
    torch.cuda.synchronize()
    errs = {"flat": max_abs(dense.flat, sparse.flat),
            "mu": max_abs(dense.mu, sparse.mu)}
    check(torch.allclose(dense.flat, sparse.flat, rtol=1e-5, atol=1e-6)
          and torch.allclose(dense.mu, sparse.mu, rtol=1e-5, atol=1e-6),
          f"kernel mix vs sparse round: {errs}")
    ctx["kernel_mix_launches"] = counts

    # the tree-form round (resident=False) through run_experiment: its
    # shared leaves flatten and mix through gossip_gather once per round
    tree_sim = SimConfig(rounds=2, resident=False)
    ops.reset_launch_counts()
    tree_hist = run_experiment("dfedpgp", tree_sim, device="cuda",
                               eval_every=1)
    tree_counts = ops.launch_counts()
    check(tree_counts["gossip_gather"] == tree_sim.rounds
          and all(map(lambda v: v == v and v < 1e3, tree_hist["loss"])),
          f"tree-form run: launches {tree_counts}, loss {tree_hist['loss']}")
    emit("kernel_mix", m=sim.m, rounds=rounds, launches=counts,
         loss=losses, round_ms=ms, mu_sum=mu_sum,
         vs_sparse={"rtol": 1e-5, "atol": 1e-6, "max_abs_err": errs},
         tree_form={"rounds": tree_sim.rounds, "launches": tree_counts,
                    "loss": tree_hist["loss"], "acc": tree_hist["acc"],
                    "round_ms": [t * 1e3 for t in tree_hist["round_s"]]})


def phase_compress(ctx):
    """Compressed directed gossip at the paper defaults (codec="topk",
    ratio 1/16: K = 833 of d = 13,328; gossip="pallas"): 5 rounds through
    run_experiment with 1 topk_gather + 1 gossip_gather per round and the
    exact wire meter; one crossing on the card against the CPU; value
    conservation on a column-stochastic table; 3 rounds each of
    codec_gamma="auto" and codec="qsgd"; 3 sampled codec rounds (frac 0.25:
    4 gossip_scatter per round, dormant rows of flat, opt_u, ef and ref
    frozen bit for bit)."""
    torch = ctx["torch"]
    from repro_torch import tree
    from repro_torch.compress import get_codec
    from repro_torch.core import gossip, sampling, topology
    from repro_torch.fl.simulator import SimConfig, run_experiment
    from repro_torch.kernels import ops
    from repro_torch.models import cnn
    from repro_torch.obs import gauges
    sim = SimConfig(rounds=5, codec="topk", gossip="pallas")
    codec = get_codec(sim.codec, ratio=sim.codec_ratio, seed=sim.seed)
    d = 13328
    K = codec.k_of(d)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    hist = run_experiment("dfedpgp", sim, device="cuda", eval_every=1,
                          return_state=True)
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    check(counts["topk_gather"] == sim.rounds
          and counts["gossip_gather"] == sim.rounds
          and counts["gossip_scatter"] == 0 and counts["pushsum_mix"] == 0,
          f"codec run launches {counts} in {sim.rounds} rounds")
    finite = all(v == v and abs(v) < 1e3 for v in hist["loss"] + hist["acc"])
    st = hist["state"]
    check(finite and all(bool(torch.isfinite(t).all())
                         for t in (st.flat, st.ef, st.ref))
          and st.ef.shape == st.ref.shape == (sim.m, d),
          f"codec run: loss {hist['loss']}, acc {hist['acc']}")

    # the wire meter: the reference bootstrap (one f32 row per client),
    # then every non-self edge of each round's table carries K (value,
    # uint16 column) pairs and mu; the uncompressed run of `train` (same
    # tables) carries f32 rows and mu
    sched = topology.get_schedule(sim.topology, sim.m, sim.n_neighbors,
                                  sim.seed)
    edges = [gauges.edge_count(sched.at(r)) for r in range(sim.rounds)]
    row_c, row_u = K * 6 + 4, 4 * d + 4
    want = [sim.m * 4 * d + sum(edges[:r + 1]) * row_c
            for r in range(sim.rounds)]
    want_u = [sum(edges[:r + 1]) * row_u for r in range(sim.rounds)]
    plain_wire = ctx["train_hist"]["wire_bytes"]
    check(hist["wire_bytes"] == want and plain_wire == want_u,
          f"wire_bytes {hist['wire_bytes']} want {want}; uncompressed "
          f"{plain_wire} want {want_u}")

    # one crossing from the trained codec state on the card and on the
    # CPU, same inputs: the kernels against the plain versions, plus
    # cuda's and the CPU's torch.topk / scatter.  rtol/atol 1e-5 on the
    # mixed rows (two gathers summed in another order than the plain
    # decode-then-gather), 1e-6 on ef', ref' and mu'
    P = sched.at(sim.rounds)
    gpu = gossip.mix_flat(P.to("cuda"), st.flat, st.mu, mode="pallas",
                          codec=codec, ef=st.ef, ref=st.ref)
    cpu = gossip.mix_flat(P, st.flat.cpu(), st.mu.cpu(), mode="pallas",
                          codec=codec, ef=st.ef.cpu(), ref=st.ref.cpu())
    cross = {}
    for name, a, b, tol in zip(("mixed", "mu", "ef", "ref"), gpu, cpu,
                               (1e-5, 1e-6, 1e-6, 1e-6)):
        cross[name] = max_abs(a.cpu(), b)
        check(torch.allclose(a.cpu(), b, rtol=tol, atol=tol),
              f"codec crossing card vs CPU {name}: {cross[name]}")

    # column-stochastic table (ring): sum(mixed) + sum(ef') = sum(flat +
    # ef) per column, sum(mu') = m.  f32 sums over 100 rows of O(1)
    # values: rtol/atol 2e-4
    ring = topology.ring(sim.m).to("cuda")
    ones = torch.ones(sim.m, device="cuda")
    mixed, mu2, ef2, _ = gossip.mix_flat(ring, st.flat, ones, mode="pallas",
                                         codec=codec, ef=st.ef, ref=st.ref)
    lhs, rhs = mixed.sum(0) + ef2.sum(0), (st.flat + st.ef).sum(0)
    conserve_err = max_abs(lhs, rhs)
    check(torch.allclose(lhs, rhs, rtol=2e-4, atol=2e-4)
          and abs(float(mu2.sum()) - sim.m) <= 1e-5 * sim.m,
          f"codec crossing on the ring: value err {conserve_err}, sum mu "
          f"{float(mu2.sum())}")

    # the adaptive consensus step and the quantizing codec
    variants = {}
    for name, kw in (("gamma_auto", dict(codec="topk", codec_gamma="auto")),
                     ("qsgd4", dict(codec="qsgd"))):
        ops.reset_launch_counts()
        h = run_experiment("dfedpgp", SimConfig(rounds=3, gossip="pallas",
                                                **kw),
                           device="cuda", eval_every=1)
        ok = all(v == v and abs(v) < 1e3 for v in h["loss"] + h["acc"])
        check(ok, f"codec run {name}: loss {h['loss']}, acc {h['acc']}")
        variants[name] = {"loss": h["loss"], "acc": h["acc"],
                          "wire_bytes": h["wire_bytes"],
                          "launches": ops.launch_counts(),
                          "round_ms": [t * 1e3 for t in h["round_s"]]}

    # sampled codec rounds: ef and ref go back through gossip_scatter too
    ssim = SimConfig(rounds=3, codec="topk", gossip="pallas",
                     participation="uniform", participation_frac=0.25)
    cfg = cnn.CNNConfig(image_size=ssim.image_size, n_classes=ssim.n_classes)
    init = cnn.init_params(torch.Generator().manual_seed(6), cfg, (ssim.m,))
    ops.reset_launch_counts()
    sh = run_experiment("dfedpgp", ssim, device="cuda", eval_every=1,
                        return_state=True, init_params=init)
    scounts = ops.launch_counts()
    check(scounts["topk_gather"] == ssim.rounds
          and scounts["gossip_gather"] == ssim.rounds
          and scounts["gossip_scatter"] == 4 * ssim.rounds,
          f"sampled codec run launches {scounts} in {ssim.rounds} rounds")
    sampler = sampling.get_sampler("uniform", ssim.m,
                                   ssim.participation_frac, ssim.seed)
    ever = torch.zeros(ssim.m, dtype=torch.bool)
    for r in range(ssim.rounds):
        ever[torch.as_tensor(sampler.active_at(r)).long()] = True
    dormant = (~ever).cuda()
    check(bool(dormant.any()), "sampled codec run: no dormant client")
    algo, _ = _paper_algo(ssim, torch, codec=codec, gossip="pallas")
    st0, _ = algo.init_flat(init, device="cuda")
    sst = sh["state"]
    pairs = {"flat": (sst.flat, st0.flat), "mu": (sst.mu, st0.mu),
             "opt_u": (sst.opt_u.momentum, st0.opt_u.momentum),
             "ef": (sst.ef, st0.ef), "ref": (sst.ref, st0.ref)}
    for path, leaf in tree.paths(sst.personal):
        pairs["personal/" + "/".join(path)] = (leaf, tree.get(st0.personal,
                                                              path))
    for name, (a, b) in pairs.items():
        check(torch.equal(a[dormant], b[dormant]),
              f"sampled codec run: dormant rows of {name} moved")
    for name in ("flat", "ef", "ref"):
        a, b = pairs[name]
        check(not torch.equal(a[~dormant], b[~dormant]),
              f"sampled codec run: active rows of {name} did not move")

    ms = [t * 1e3 for t in hist["round_s"]]
    plain_ms = [t * 1e3 for t in ctx["train_hist"]["round_s"]]
    emit("compress", m=sim.m, d=d, K=K, ratio=sim.codec_ratio,
         gossip=sim.gossip, rounds=sim.rounds, launches=counts,
         loss=hist["loss"], acc=hist["acc"], round_ms=ms,
         ms_per_round_after_first=statistics.median(ms[1:]),
         uncompressed_ms_per_round_after_first=statistics.median(
             plain_ms[1:]),
         seconds=round(seconds, 3), edges_per_round=edges,
         wire_bytes=hist["wire_bytes"], wire_bytes_uncompressed=plain_wire,
         row_bytes={"topk": row_c, "uncompressed": row_u,
                    "ratio": row_u / row_c},
         crossing_card_vs_cpu={"max_abs_err": cross, "rtol_atol": {
             "mixed": 1e-5, "mu": 1e-6, "ef": 1e-6, "ref": 1e-6}},
         ring_conservation={"max_abs_err": conserve_err, "rtol_atol": 2e-4,
                            "mu_sum": float(mu2.sum())},
         variants=variants,
         sampled={"frac": ssim.participation_frac, "rounds": ssim.rounds,
                  "launches": scounts, "loss": sh["loss"], "acc": sh["acc"],
                  "dormant_clients": int(dormant.sum()),
                  "dormant_rows_frozen": sorted(pairs)})
    ctx.update(compress_launches=counts, compress_state=st,
               compress_sampled_launches=scounts)


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
    from repro_torch.core import gossip, topology
    from repro_torch.kernels import ops
    from repro_torch.kernels.topk_gather import default_block_d
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
    # gossip_scatter at the sampled path's shape (m=100, n=25 of frac
    # 0.25, f32) and at bench scale (m=4096, n=1024): X read once and n
    # rows written (plus the row ids); no operations
    per_shape = {}
    g = torch.Generator(device="cuda").manual_seed(12)
    for m, n in ((100, 25), (4096, 1024)):
        d = 13328
        U = torch.randn((m, d), generator=g, device="cuda")
        X = torch.randn((n, d), generator=g, device="cuda")
        rows = torch.randperm(m, generator=g, device="cuda")[:n].sort()[
            0].to(torch.int32)
        rl = rows.long()
        t = measure(lambda: ops.gossip_scatter(rows, X, U, force="cuda"),
                    lambda: ops.gossip_scatter(rows, X, U, force="ref"),
                    lambda: U.index_copy_(0, rl, X))
        sb_ms, sb_by = bound(2 * n * d * 4 + n * 4, 0)
        per_shape[f"{m}x{n}"] = dict(t, bound_ms=sb_ms, bound_us=sb_ms * 1e3,
                                     bound_by=sb_by, shape=[m, n, d])
    main = per_shape["100x25"]
    kernels.append({
        "name": "gossip_scatter", "route": "cuda",
        "source": "src/repro_torch/csrc/gossip_scatter.cu",
        "replaces": "src/repro/kernels/gossip_scatter.py:149",
        "launches": ctx["sampled_launches"]["gossip_scatter"],
        "max_abs_err": ctx["scatter_err"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "call_ms": main["call_ms"], "shape": [100, 25, 13328],
        "dtype": "float32"})

    # pushsum_mix at the kernel-mix path's shape (m=100, d=13,328, f32):
    # P and U read once, the output written once; 2*m*m*d operations
    m, d = 100, 13328
    Pd = topology.get_schedule("random", m, 10, 0).at(0).to("cuda").dense()
    U = torch.randn((m, d), device="cuda")
    t = measure(lambda: ops.pushsum_mix(Pd, U, force="cuda"),
                lambda: ops.pushsum_mix(Pd, U, force="ref"),
                lambda: torch.matmul(Pd, U))
    pb_ms, pb_by = bound(m * m * 4 + 2 * m * d * 4, 2 * m * m * d)
    kernels.append({
        "name": "pushsum_mix", "route": "cuda",
        "source": "src/repro_torch/csrc/pushsum_mix.cu",
        "replaces": "src/repro/kernels/pushsum_mix.py:53",
        "launches": ctx["kernel_mix_launches"]["pushsum_mix"],
        "max_abs_err": ctx["pushsum_err"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": pb_ms, "bound_by": pb_by,
        "library_ms": t["library_ms"], "call_ms": t["call_ms"],
        "shape": [m, m, d], "dtype": "float32"})
    pushsum_detail = dict(t, bound_us=pb_ms * 1e3, bound_by=pb_by)

    # topk_gather at the codec path's shape (m=100, k=11 with the self
    # edge's weight zeroed, K=833 of d=13,328, f32 values, uint16 columns)
    # and the bench_gossip grid's m=1024, k=16: the output written once,
    # the payload read once, idx + w; 2*m*k*K operations.  No one PyTorch
    # call computes this: the library yardstick is two calls, a dense
    # decode (index_put_ with accumulate into zeros) and torch.sparse.mm
    # with the wire table in CSR
    topk_shapes = {}
    for m, n in ((100, 10), (1024, 15)):
        d, K = 13328, 833
        Pw = gossip.wire_only(topology.get_schedule("random", m, n, 0).at(0))
        idx, w = Pw.idx.cuda(), Pw.w.cuda().contiguous()
        k = idx.shape[1]
        _, _, vals, cols = _payload_case(torch, m, k, d, K, 13,
                                         torch.float32, torch.uint16)
        rows = torch.arange(m, device="cuda")[:, None].expand(m, K)
        cl = cols.long()
        csr = torch.sparse_coo_tensor(
            torch.stack([torch.arange(m, device="cuda")[:, None].expand(
                m, k).reshape(-1), idx.long().reshape(-1)]),
            w.reshape(-1), (m, m)).coalesce().to_sparse_csr()

        def library():
            dec = torch.zeros((m, d), device="cuda").index_put_(
                (rows, cl), vals, accumulate=True)
            return torch.sparse.mm(csr, dec)

        got = ops.topk_gather(idx, w, vals, cols, d, force="cuda")
        check(torch.allclose(library(), got, rtol=2e-5, atol=2e-5),
              "index_put_ + sparse.mm yardstick disagrees")
        t = measure(lambda: ops.topk_gather(idx, w, vals, cols, d,
                                            force="cuda"),
                    lambda: ops.topk_gather(idx, w, vals, cols, d,
                                            force="ref"),
                    library)
        nbytes = m * d * 4 + m * K * (4 + 2) + m * k * 8
        tb_ms, tb_by = bound(nbytes, 2 * m * k * K)
        # columns per block: each block reads all k*K pairs of its row and
        # keeps those in its chunk, so fewer chunks read less from L2 but
        # give fewer blocks
        sweep = {bd: device_ms(torch, lambda bd=bd: ops.topk_gather(
            idx, w, vals, cols, d, force="cuda", block_d=bd))
            for bd in (1024, 2048, 4096, 8192, d)}
        topk_shapes[f"{m}x{k}"] = dict(t, bound_ms=tb_ms, bound_us=tb_ms * 1e3,
                                       bound_by=tb_by, bound_bytes=nbytes,
                                       shape=[m, k, d, K],
                                       ms_by_block_d=sweep,
                                       default_block_d=default_block_d(
                                           m, k, d, "cuda"))
    main = topk_shapes["100x11"]
    kernels.append({
        "name": "topk_gather", "route": "cuda",
        "source": "src/repro_torch/csrc/topk_gather.cu",
        "replaces": "src/repro/kernels/topk_gather.py:128",
        "launches": ctx["compress_launches"]["topk_gather"],
        "max_abs_err": ctx["topk_err"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "library": "index_put_(accumulate=True) + torch.sparse.mm: 2 calls",
        "call_ms": main["call_ms"], "shape": [100, 11, 13328, 833],
        "dtype": "float32/uint16"})
    emit("timings", card=ctx["smi"], gossip_gather=gossip_detail,
         gossip_scatter_by_shape=per_shape, pushsum_mix=pushsum_detail,
         topk_gather_by_shape=topk_shapes,
         round_profile=profile_rounds(ctx),
         round_profile_sampled=profile_rounds(ctx, frac=0.25),
         round_profile_codec=profile_rounds(ctx, rounds=1, codec="topk"),
         head_gather_matmul_by_batch=per_b,
         note="topk_gather's library_ms is two calls (dense decode by "
              "index_put_, then torch.sparse.mm); "
              "ms/plain_ms/library_ms: device time per call summed over "
              "the kernels each puts on the card (torch.profiler, 50 "
              "calls); *call_ms: median of CUDA-event windows of "
              "back-to-back calls, host time included; inputs warm in L2; "
              "bound_ms from the published peaks of the named card")
    ctx["kernels"] = kernels


def profile_rounds(ctx, rounds: int = 3, frac: float = 1.0,
                   codec=None) -> dict:
    """Where a round's time goes: torch.profiler over `rounds` rounds
    continuing from the trained state (after one warm round), with the
    device's busy share and the kernels that take most of it.  frac < 1
    profiles sampled rounds (uniform participation, the host's sampler
    and induced-subgraph work included) from the sampled phase's state;
    a codec profiles codec rounds (gossip="pallas") from the compress
    phase's state and names the device time of the codec's torch ops
    (the encode's topk, its gathers and scatters)."""
    torch = ctx["torch"]
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.compress import get_codec
    from repro_torch.core import sampling, topology
    from repro_torch.data import make_dataset
    sim, layout = ctx["sim"], ctx["train_layout"]
    extra = {} if codec is None else dict(
        codec=get_codec(codec, seed=sim.seed), gossip="pallas")
    algo, _ = _paper_algo(sim, torch, **extra)
    data = make_dataset(sim.seed, sim.m, n_train=sim.n_train,
                        n_test=sim.n_test, device="cuda")
    sched = topology.get_schedule("random", sim.m, sim.n_neighbors, 1)
    sampler = sampling.get_sampler("uniform", sim.m, frac, 1) \
        if frac < 1.0 else None

    def one_round(state, r):
        b = _round_batches(sim, data, 500 + r, torch)
        if sampler is None:
            return algo.round_fn_flat(state, sched.at(r).to("cuda"), b,
                                      layout)[0]
        active = torch.as_tensor(sampler.active_at(r))
        idx = active.long().cuda()
        b = {part: {k: a.index_select(0, idx) for k, a in bp.items()}
             for part, bp in b.items()}
        P = topology.induced_subgraph(sched.at(r), active).to("cuda")
        return algo.round_fn_sampled(state, P, active, b, layout)[0]

    start = ctx["train_state"] if sampler is None else ctx["sampled_state"]
    if codec is not None:
        start = ctx["compress_state"]
    state = one_round(start, 0)
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
    codec_ops = {}
    if codec is not None:
        for e in prof.key_averages():
            if e.key in ("aten::topk", "aten::gather", "aten::scatter",
                         "aten::abs", "aten::_to_copy"):
                dev_us = getattr(e, "device_time_total",
                                 getattr(e, "cuda_time_total", 0.0))
                codec_ops[e.key] = {"device_ms_per_round":
                                    dev_us / 1e3 / rounds,
                                    "calls_per_round": e.count / rounds}
    return {"rounds": rounds, "frac": frac, "codec": codec,
            "codec_ops": codec_ops,
            "wall_ms_per_round": wall_ms / rounds,
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
    needs = {"serve": {"train"}, "compress": {"train"},
             "timings": {"kernels", "train", "sampled", "kernel_mix",
                         "compress", "serve"}}
    for phase in only:
        missing = needs.get(phase, set()) - wanted
        if missing:
            ap.error(f"phase {phase} needs {sorted(missing)}")
    fns = {"device": phase_device, "build": phase_build,
           "kernels": phase_kernels, "train": phase_train,
           "parity": phase_parity, "sampled": phase_sampled,
           "kernel_mix": phase_kernel_mix, "compress": phase_compress,
           "serve": phase_serve,
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
