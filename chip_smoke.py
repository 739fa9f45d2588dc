#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch/`) on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase; needs one GPU
    python3 chip_smoke.py --only build,kernels   # a subset, no final line

Phases, one JSON line each (any failed check exits nonzero and the final
line is never printed):

1. device     — the card's name and power limit; both TF32 flags set False
                (parity against f32 needs full-precision convs and matmuls)
                and the CPU references pinned to one thread (their float
                order must not depend on the host's core count);
2. build      — the CUDA kernels built from src/repro_torch/csrc/ (one
                nvcc per source, all started together), with the bf16
                flash kernel's registers and spills (ptxas) and its
                HGMMA and TMA instructions (cuobjdump);
3. kernels    — each kernel against its plain torch version on the card,
                at the main paths' shapes and awkward ones;
4. train      — run_experiment("dfedpgp", SimConfig(rounds=5)) at the paper
                defaults on CUDA; gossip_gather must launch once per round;
5. parity     — 2 rounds on CUDA and on the CPU from one init, tables and
                batches (f32 at rtol 1e-4 / atol 5e-5, and f64 at rtol =
                atol = 1e-9); the f32 kernel path bitwise the plain path
                on the card;
6. sampled    — run_experiment with participation="uniform", frac 0.25:
                one gossip_scatter (the write-back of flat and momentum
                in one launch) and one gossip_gather per round,
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
                rounds (one gossip_scatter per round writes flat,
                momentum, ef and ref back; dormant rows frozen);
9. baselines  — the paper's 10 comparison rows at its defaults, 3 rounds
                each through run_experiment: finite loss, accuracy in
                [0, 1], one gossip_gather launch per DFL round (mix_tree's
                one buffer) and none for the CFL rows and local; the
                osgp / dfedavgm flat-core codec runs (topk, "pallas"): one
                topk_gather and one gossip_gather per round, plus one
                gossip_scatter per sampled round, dormant rows frozen;
                every algorithm 2 rounds from one set of draws: the card
                against the CPU in f64 and the f32 kernel path against the
                plain path on the card (rtol 1e-4, atol 5e-5, every state
                leaf); the f32 card-vs-CPU gap reported (max-pool
                near-ties part f32 trajectories);
10. async     — the async runtime (virtual clock, delayed push-sum
                mailboxes) at the paper's defaults: the uniform zero-delay
                ticks bitwise one round_fn_flat; 5 windows of tiered
                speeds and push delays up to 2 through run_experiment:
                mass conserved every tick, one gossip_gather per delay
                group on each fire tick and none on the others, bitwise
                against the plain kernels; 2 windows card vs CPU in f64;
                topk codec fires (+ one topk_gather per group); the osgp
                and dfedavgm legs; 25% participation; window and tick
                times, busy share, the gated gather's device time;
10b. analysis — the program invariant analyzer (`repro_torch.analysis`)
                on the card: `run_all(device="cuda")` over the six
                registered programs (m 13) and the schedule kinds finds no
                violation, its steady-state rounds under
                torch.cuda.set_sync_debug_mode("error"); each broken
                fixture trips its detector on the card; each program's 3
                rounds launch exactly the kernels stated in
                ANALYSIS_LAUNCHES (the wrappers' counts and
                torch.profiler's kernel events); the per-round lr upload
                the detector found in the rounds (since repaired), put
                back for one check, found on the card; `python -m
                repro_torch.analysis --all` in a subprocess exits 0 and
                `--fixture X` returns 1 for every fixture;
11. obs       — the telemetry spine: telemetry-on runs through
                run_experiment with a JSONL sink (5 rounds with graph
                records every 2, 3 sampled rounds, 3 topk codec rounds, 2
                async windows), each bitwise its telemetry-off run with
                the same launches (cuDNN deterministic; two default runs'
                gap reported); mass_total = m in every record; report
                --check; the flight recorder's mass-drift trip and
                post-mortem; maybe_trace naming the gather; peak memory;
                metered serving at B 1, 64, 1024; ms per round with
                telemetry off / on / on with a sink, and per graph
                snapshot;
12. checkpoint — resumed runs bitwise the uninterrupted ones: the resident
                state after round 3 of 5 restored into a zeroed template
                on the card, the topk codec state (ef / ref), the async
                state with its profile after 7 of 12 ticks; serving from
                from_checkpoint bitwise from_train_state's; a bf16 leaf;
                save and restore ms and bytes;
13. serve     — mixed-user batches served from the trained state through
                head_gather_matmul, against force="ref" and serve_naive;
14. lm        — recurrentgemma-9b at full width and depth (38 layers, f32
                params drawn on the card, bf16 compute): prefill_logits
                at B 2, S 4096 (12 flash_attention and 26 rglru launches
                per prefill, finite logits, median ms, each kernel's
                share of device time), 16 greedy decode steps at B 4, peak
                memory; then reduced() in f32 and in bf16 (the wgmma flash
                route) on the card against the CPU (prefill, 24 decode
                steps across the ring wrap, caches);
15. dense     — the dense LM family (qwen2-0.5b, h2o-danube-1.8b,
                granite-3-2b, codeqwen1.5-7b) at full width (f32 params
                drawn on the card, bf16 compute): prefill_logits with
                exactly n_layers flash_attention launches (the wgmma
                kernel named), 16 greedy decode steps at B 4 (and 16 with
                the int8 KV cache for qwen2-0.5b), peak memory, the kernel
                at each head shape against its plain version,
                scaled_dot_product_attention and its bound; the
                personalized mixed-user decode at qwen2-0.5b's full width
                (16 head_gather_matmul launches, logits against the plain
                head, the head at (8, 896, 151,936)); reduced() card
                against CPU in f32 and bf16 and the int8 KV decode;
                python -m repro_torch.serve.decode on the card;
16. regime_b  — Regime B (launch/) on the card: qwen2-0.5b at full
                width with m 4 clients through `python -m
                repro_torch.launch.train`'s main: 3 resident rounds (3
                gossip_gather), 3 sampled rounds of 2 clients (3
                gossip_scatter, dormant rows bit for bit), 2 tree-form
                rounds, 2 telemetry rounds (report --check), ms per
                round, peak memory, a profiled round's busy share;
                gossip_gather and gossip_scatter at d 494,031,872 bitwise
                against their plain versions, timed warm and cold;
                reduced() card vs CPU (3 resident, 2 sampled rounds); one
                full-width prefill step (24 x 4 flash_attention);
17. moe       — the moe family: the flash kernel at deepseek-moe-16b's
                prefill (1, 8,192, 16, 16, 128) against its plain version,
                timed beside SDPA and its bound; deepseek-moe-16b at full
                width and 28 layers (65.5 GB of f32 params drawn on the
                card, bf16 compute): prefill_logits at B 1, S 8,192 (two
                moe_seq_chunk chunks) with exactly 28 flash_attention
                launches, its rerun bitwise, the kernel route against the
                plain route (LM bf16 bound, route flips counted), 16
                greedy decode steps at B 4 from a 4,096 cache, peak
                memory; deepseek-moe-16b and deepseek-v2-236b (MLA, the
                plain attention) at reduced() card vs CPU in f32 and bf16
                (forward, prefill, 8 decode steps, caches) and through 2
                Regime-B resident rounds of launch.train (1 gossip_gather
                a round), card vs CPU;
18. vlm       — qwen2-vl-7b (M-RoPE) the same way: the flash kernel at
                (1, 8,192, 28, 4, 128) (hd 128, a group of 7) held before
                anything is timed; full width (30.5 GB): 1,024 vision
                embeddings + 7,168 tokens, 28 flash_attention launches a
                prefill, decode; reduced() card vs CPU and 2 rounds;
19. ssm       — xlstm-125m (sLSTM + chunkwise mLSTM, a list of 12 layer
                dicts) at full width: prefill_logits at B 1, S 4,096 with
                no kernel launch (16 mLSTM chunks and 4,096 sLSTM steps a
                layer), its rerun bitwise, the busy share over its first
                512 tokens (a device-only profile), the sLSTM layers'
                share, 16 decode steps at B 4 (one profiled), peak memory; 2 resident Regime-B
                rounds at full width (1 gossip_gather a round at (4, 3,
                160,350,800)), a profiled round; the gather at that width
                bitwise its plain version, timed (CUDA events) beside the
                plain gather and torch.sparse.mm (CSR); reduced() card vs
                CPU in f32 and bf16 and 2 reduced rounds;
20. encdec    — whisper-large-v3: the flash kernel at its decoder prefill
                (1, 8,192, 20, 20, 64), hd 64 at a group of 1, held
                against its plain version, timed beside SDPA and its
                bound; full width (32 encoder + 32 decoder layers, 6.4 GB
                of f32 params): 1,500 stub frames and 8,192 decoder
                tokens, 32 flash_attention launches a prefill (none in the
                encoder or cross-attention), its rerun bitwise, the
                kernel route against the plain route, encoder / decoder
                split, prefill_cross then 16 decode steps at B 4 from a
                4,096 cache; reduced() card vs CPU and 2 rounds;
21. timings   — each kernel at its path's shape: kernel, plain and
                library-call ms (CUDA events), the card's bound, launches;
                gossip_gather, pushsum_mix and topk_gather also at m = 1024,
                gossip_gather also at the baselines' full-model widths,
                gossip_scatter at m = 4096; every kernel also with a cold
                L2, the first five with their route, plan and share of the
                bound; the sampled round's write-back (2 and 4 buffers in
                one gossip_scatter launch) against index_copy_ per buffer;
                the launch floor (a one-element kernel) beside the head's
                and the scatter's bounds;
                profiles of a full, a sampled and a codec round.

The last line is {"ok": true, "device": {...}}.  The script imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

PHASES = ("device", "build", "kernels", "train", "parity", "sampled",
          "kernel_mix", "compress", "baselines", "async", "analysis", "obs",
          "checkpoint", "serve", "lm", "dense", "regime_b", "moe", "vlm",
          "ssm", "encdec", "timings")
# the paper's comparison rows (the port's simulator.ALGOS but dfedpgp)
BASELINES = ("local", "fedavg", "fedper", "fedrep", "fedbabu", "ditto",
             "dfedavgm", "dfedavgm-p", "osgp", "dispfl")
# published peaks (NVIDIA data sheets, dense): bytes/s of device memory and
# f32 FLOP/s outside the tensor cores
PEAKS = {"PCIe": (2.0e12, 51e12), "NVL": (3.9e12, 60e12),
         "SXM": (3.35e12, 67e12)}
# dense bf16 tensor-core FLOP/s of the same parts
PEAKS_BF16 = {"PCIe": 756e12, "NVL": 835e12, "SXM": 989e12}
# parameters of recurrentgemma-9b as the reference initializes them
# (jax.eval_shape of repro.models.hybrid.init_params: w_a and w_i are
# (W, W) and lm_head is its own leaf)
LM_PARAMS = 10_444_877_824


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


# Profiler windows that came back without a single device event, or
# (`device_ms`, `_lm_profile`) that lost some of them.  On the
# H100 a short CUDA-only window now and then loses all of its kernels,
# and once three windows in a row; a quiet margin at each end of the
# window keeps them, and a window that is still empty is run again, at
# most PROFILE_ATTEMPTS times, each retry with a margin 4x the last and,
# from the third window on, CPU activity traced beside the device's (the
# device events alone are summed either way).  The re-run windows are
# printed with the timings.
PROFILE_PAD_S = 0.002
PROFILE_ATTEMPTS = 5
PROFILER_MISSES = []


def profiled(torch, run, cpu: bool = False, fatal: bool = True):
    """torch.profiler over `run()`, with a quiet margin on each side of
    it: (profiler, its device events, wall ms of run).  An empty window
    is run again; PROFILE_ATTEMPTS empty ones fail, or give None where
    not `fatal`."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(PROFILE_ATTEMPTS):
        acts = [ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if cpu or attempt >= 2 else [])
        pad = PROFILE_PAD_S * 4 ** attempt
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            torch.cuda.synchronize()
            time.sleep(pad)
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            time.sleep(pad)
        events = _device_events(prof)
        if events:
            return prof, events, wall
        PROFILER_MISSES.append(
            f"{getattr(run, '__qualname__', '?')} (window {attempt + 1})")
    check(not fatal, f"torch.profiler saw no device time in "
                     f"{PROFILE_ATTEMPTS} windows: {PROFILER_MISSES}")
    return None


# `device_ms` calls whose profiler windows kept losing events: their
# time is `queued_ms`'s, printed with the timings
DEVICE_MS_FALLBACKS = []
DEVICE_MS_ATTEMPTS = 3
SPIN_HZ = 2.0e9              # cycles a second of torch.cuda._sleep, at most


def queued_ms(torch, fn, iters: int = 20, reps: int = 3) -> float:
    """Device time per call by CUDA events alone: `iters` calls queued
    behind a spin kernel (torch.cuda._sleep) that outlasts the host's
    enqueueing, so the events time the card running them back to back,
    without the host's launch gaps (the card's own gaps between kernels
    are in); the median over `reps` windows, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(1.5 * host_s * SPIN_HZ) + 4_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def device_ms(torch, fn, iters: int = 50) -> float:
    """Device time per call: the summed time of every kernel `fn` puts on
    the card (torch.profiler), over `iters` calls, after a warm-up call,
    where the window holds up.  Each call launches the same kernels, so a
    window in which some kernel's count is not a whole multiple of the
    calls lost events, and one whose kernels add up to more than the CUDA
    events recorded around the same calls miscounted; either is run again
    with half as many calls and listed in PROFILER_MISSES.  The H100's
    profiler fails both ways: it drops one or two kernel events of a
    window, whatever its length, and in one window read cuDNN's attention
    6% over the events around it.  After DEVICE_MS_ATTEMPTS failed windows
    the time is `queued_ms`'s, and the call is listed in
    DEVICE_MS_FALLBACKS.  Surviving events are never scaled up."""
    name = getattr(fn, "__qualname__", "?")
    fn()
    n = iters
    for _ in range(DEVICE_MS_ATTEMPTS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)

        def calls(n=n, start=start, end=end):
            start.record()
            for _ in range(n):
                fn()
            end.record()

        window = profiled(torch, calls, fatal=False)
        if window is None:
            break
        events = window[1]
        short = sorted((e.key[:60], e.count) for e in events if e.count % n)
        total = sum(_dev_us(e) for e in events) / 1e3
        span = start.elapsed_time(end)
        if not short and total <= span * 1.001 + 1e-3:  # events: ~0.5 us
            return total / n
        PROFILER_MISSES.append(f"{name}: {n} calls, (kernel, events) "
                               f"{short[:3]}, kernels {total} ms in "
                               f"{span} ms of events")
        n = max(1, n // 2)
    call = queued_ms(torch, fn, iters=min(iters, 20))
    DEVICE_MS_FALLBACKS.append(f"{name}: {call} ms")
    return call


FLUSH_BYTES = 256 << 20      # written between calls for a cold L2 (50 MB)


def cold_ms(torch, fn, iters: int = 20) -> float:
    """Device time per call of fn with L2 cold: before each call a 256 MB
    device-to-device copy writes 5x the 50 MB L2 (torch.profiler; the
    copies' own events are left out)."""
    src = torch.empty(FLUSH_BYTES // 4, device="cuda")
    dst = torch.empty_like(src)
    fn()

    def calls():
        for _ in range(iters):
            dst.copy_(src)
            fn()

    _, events, _ = profiled(torch, calls)
    kept = [e for e in events if not e.key.startswith("Memcpy")]
    check(len(kept) < len(events), "the L2 flush left no copy event")
    return sum(_dev_us(e) for e in kept) / 1e3 / iters


def _cold_and_share(torch, t, bound_ms, kernel, library) -> dict:
    """Cold-L2 times of a kernel and its library call, and the bound's
    share of the kernel's warm and cold times.  The bound counts HBM
    bytes: a warm time below it is served from L2, and says so."""
    cold, lib_cold = cold_ms(torch, kernel), cold_ms(torch, library)
    return {"cold_ms": cold, "library_cold_ms": lib_cold,
            "bound_share": bound_ms / t["ms"],
            "bound_share_cold": bound_ms / cold,
            "warm_below_bound": t["ms"] < bound_ms,
            "cold_below_bound": cold < bound_ms}


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


FLASH_BLOCK_ROWS = 128       # query positions per block of block_rel_l2
FLASH_REL_L2_BF16 = 1e-2     # bf16 bound on it: a few bf16 ulps (2^-8)


def block_rel_l2(torch, got, want, rows: int = FLASH_BLOCK_ROWS) -> float:
    """The worst relative L2 error of attention outputs (B, S, H, hd) over
    blocks of `rows` query positions, each block taking every batch row
    and head.  It scales with the output, which shrinks as 1 / sqrt(keys
    in the band) for random inputs, and a fault confined to one query
    tile (a key tile dropped at the edge of its band) shows in its block
    instead of being averaged over the sequence."""
    if not got.numel():
        return 0.0
    err = (got.float() - want.float()).pow(2).sum(dim=(0, 2, 3))
    ref = want.float().pow(2).sum(dim=(0, 2, 3))
    pad = -err.numel() % rows
    err, ref = (torch.nn.functional.pad(t, (0, pad)).view(-1, rows).sum(1)
                for t in (err, ref))
    return float((err / ref.clamp_min(1e-30)).sqrt().max())


# ---------------------------------------------------------------------------
def phase_device(ctx):
    torch = ctx["torch"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the CPU splits its convolution and reduction sums by thread count, so
    # the CPU side of a parity check changes with the host's cores: at
    # some counts a near-tie in the parity run's 2 rounds flips, and opt_u
    # then lies far outside the check's tolerance of the card's (1.8e-3
    # in one run).  One thread gives every host the same reference.
    host_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(smi, flush=True)
    bw_kind, (bw, f32) = peaks_for(name)
    ctx.update(name=name, smi=smi, peak_bw=bw, peak_f32=f32,
               peak_bf16=PEAKS_BF16[bw_kind])
    emit("device", name=name, nvidia_smi=smi, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0],
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         cpu_threads=torch.get_num_threads(), host_threads=host_threads,
         peaks={"table": bw_kind, "bytes_per_s": bw, "f32_flop_per_s": f32,
                "bf16_tensor_flop_per_s": PEAKS_BF16[bw_kind]})


def phase_build(ctx):
    from repro_torch.kernels import _build, flash_attention
    t0 = time.perf_counter()
    built = _build.build()
    seconds = time.perf_counter() - t0
    for name in _build.SOURCES:
        check(_build.artifact(name).exists(), f"{name} did not build")
    ptxas = {n: [ln.strip() for ln in info["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, info in built.items()}
    wgmma = {}
    if "flash_attention" in built:
        log = built["flash_attention"]["log"]
        wgmma = {"ptxas": {f: lines for f, lines in _ptxas_by_entry(
                     log).items() if "flash_attention_wgmma_kernel" in f},
                 "warnings": [ln.strip() for ln in log.splitlines()
                              if "warning" in ln.lower()],
                 "sass": _sass_counts(_build.artifact("flash_attention"))}
        n_hd = len(flash_attention.HEAD_DIMS)
        check(len(wgmma["ptxas"]) == n_hd, f"ptxas built no flash_attention_"
                                           f"wgmma_kernel for the {n_hd} "
                                           f"head dims")
        sass = wgmma["sass"]
        check(sass is None or (len(sass) == n_hd and all(
            c["HGMMA"] > 0 and c["UTMALDG"] > 0 for c in sass.values())),
              f"the bf16 flash kernels issue no HGMMA or TMA load: {sass}")
    emit("build", seconds=round(seconds, 3), built=sorted(built),
         nvcc=_build.nvcc_path(), flags=list(_build.NVCC_FLAGS), ptxas=ptxas,
         flash_wgmma=wgmma)


def _kernel_name(mangled: str) -> str:
    """_ZN...flash_attention_wgmma_kernelILi256EE... -> the kernel's name
    and head dim, flash_attention_wgmma_kernel<256>."""
    return re.sub(r".*\d([A-Za-z_]\w*?_kernel)I\w*?Li(\d+)E.*", r"\1<\2>",
                  mangled)


def _ptxas_by_entry(log: str) -> dict:
    """{entry function: its register / spill lines} from nvcc -Xptxas=-v."""
    out, cur = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = _kernel_name(ln.split("'")[1])
            out[cur] = []
        elif cur is not None and ("registers" in ln or "spill" in ln):
            out[cur].append(ln.strip())
    return out


def _sass_counts(lib, words=("HGMMA", "UTMALDG", "UTMASTG")):
    """Per bf16 flash kernel in the built library, how many SASS lines
    hold each word (cuobjdump beside nvcc); None without cuobjdump."""
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, cur = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = _kernel_name(ln.split("Function :")[1].strip())
            cur = name if "flash_attention_wgmma_kernel" in name else None
            if cur:
                counts[cur] = dict.fromkeys(words, 0)
        elif cur:
            for w in words:
                counts[cur][w] += w in ln
    return counts


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


def _induced_table(torch, P, n_active=50, seed=5):
    """P induced on `n_active` of its clients drawn from a CPU generator
    (the sampled flat-core round's table, compact ids, width kept)."""
    from repro_torch.core import topology
    m = P.idx.shape[0]
    active = torch.randperm(m, generator=torch.Generator().manual_seed(
        seed))[:n_active].sort().values
    return topology.induced_subgraph(P, active.to(P.idx.device), "row")


def _gather_plan(m, k, d, U, block_d=None):
    """The route and tiling gossip_gather_cuda takes for these inputs."""
    from repro_torch.kernels import _build, gossip_gather
    return gossip_gather.plan(m, k, d, U.element_size(),
                              _build.sm_count(U.device), block_d)


def _gather_edge_cases(ctx):
    """gossip_gather on both routes: m = 0, an out-of-range neighbor id
    (its row all NaN, jnp.take's fill; the other rows bitwise), the bf16
    row route (m = 8192) and a block_d each route refuses (ValueError)."""
    torch = ctx["torch"]
    from repro_torch.kernels import ops
    f32, bf16 = torch.float32, torch.bfloat16
    results = []
    empty = ops.gossip_gather(*(t[:0] for t in _gather_case(
        torch, 4, 2, 8, 0, f32)), force="cuda")
    check(empty.shape == (0, 8), "gossip_gather m=0")
    for m, k, d, dt in ((100, 11, 13328, f32), (4096, 3, 129, f32),
                        (8192, 3, 129, bf16)):
        idx, w, U = _gather_case(torch, m, k, d, 90, dt)
        route = _gather_plan(m, k, d, U).route
        if dt == bf16:
            got = ops.gossip_gather(idx, w, U, force="cuda")
            want = ops.gossip_gather(idx, w, U, force="ref")
            err = max_abs(got, want)
            check(torch.allclose(got.float(), want.float(), rtol=8e-3,
                                 atol=8e-3), f"gossip_gather bf16 {route} "
                                             f"route err {err}")
            results.append({"kernel": "gossip_gather", "shape": [m, k, d],
                            "dtype": "bfloat16", "route": route,
                            "max_abs_err": err, "ok": True})
            continue
        bad = idx.clone()
        bad[0, k - 1] = m
        got = ops.gossip_gather(bad, w, U, force="cuda")
        want = ops.gossip_gather(idx, w, U, force="ref")
        check(bool(torch.isnan(got[0]).all()) and torch.equal(got[1:],
                                                               want[1:]),
              f"gossip_gather out-of-range id on the {route} route")
        results.append({"kernel": "gossip_gather", "shape": [m, k, d],
                        "dtype": "float32", "route": route,
                        "check": "out-of-range id -> NaN row, rest bitwise",
                        "ok": True})
    for m, bd in ((100, 6), (100, 584), (4096, 100)):
        idx, w, U = _gather_case(torch, m, 2, 64, 91, f32)
        try:
            ops.gossip_gather(idx, w, U, force="cuda", block_d=bd)
            refused = False
        except ValueError:
            refused = True
        check(refused, f"gossip_gather took block_d={bd} at m={m}")
    return results


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
    # the baselines' full-model widths (mix_tree's one buffer) on their
    # tables: d 13,978 (the whole CNN) on OSGP's random table (k 11) and
    # the undirected one (k 31); d_flat 13,328 at k 31 (DFedAvgM-P); d
    # 27,956 (Dis-PFL's num + den) at k 31; and the sampled flat-core
    # round's table, the undirected one induced on 50 active clients.
    # f32 bitwise mix_rows
    und = topology.get_schedule("undirected", 100, 10, 0).at(0).to("cuda")
    ind = _induced_table(torch, und)
    for Pt, d in ((P, 13978), (und, 13978), (und, 13328), (und, 27956),
                  (ind, 13978)):
        n, k = Pt.idx.shape
        Ud = torch.randn((n, d), generator=g, device="cuda")
        got = ops.gossip_gather(Pt.idx, Pt.w, Ud, force="cuda")
        torch.cuda.synchronize()
        want = gossip.mix_rows(Pt.idx, Pt.w, Ud)
        route = _gather_plan(n, k, d, Ud)
        check(torch.equal(got, want) and torch.equal(
            got, ops.gossip_gather(Pt.idx, Pt.w, Ud, force="ref")),
              f"gossip_gather f32 != mix_rows bit for bit at ({n}, {k}, "
              f"{d}), {route}")
        results.append({"kernel": "gossip_gather", "shape": [n, k, d],
                        "dtype": "float32", "check": "bitwise == mix_rows",
                        "route": route.route, "block_d": route.block_d,
                        "table_in_smem": route.table,
                        "max_abs_err": max_abs(got, want), "ok": True})

    # -- the bench_gossip grid, the timed m = 1024 shape, awkward shapes
    # (repeated ids; d = 513 and 5 take the unaligned staging), the row
    # route (m beyond a 16-column panel: 4096 f32, 8192 bf16) and explicit
    # block_d on both routes.  (1024, 16, 4096) stages no neighbor table
    # (block_d per dtype: m = 4096 is the row route in f32 only)
    cases = [(m, k, 4096, None, None) for m in (64, 256, 1024)
             for k in (2, 8, 16)]
    cases += [(13, 1, d, None, None) for d in (1, 5, 513)]
    cases += [(13, 3, 513, None, None), (1, 1, 1, None, None),
              (1024, 16, 13328, None, None), (100, 11, 13328, 8, 8),
              (100, 11, 13328, 576, 576), (4096, 3, 129, None, None),
              (4096, 3, 1025, 256, 16)]
    for i, (m, k, d, bd32, bd16) in enumerate(cases):
        for dtype in (f32, bf16):
            bd = bd32 if dtype == f32 else bd16
            idx, w, Uc = _gather_case(torch, m, k, d, 100 + i, dtype)
            got = ops.gossip_gather(idx, w, Uc, force="cuda", block_d=bd)
            want = ops.gossip_gather(idx, w, Uc, force="ref")
            err = max_abs(got, want)
            if dtype == f32:
                ok = torch.equal(got, want) and torch.equal(
                    got, gossip.mix_rows(idx, w, Uc))
            else:
                ok = torch.allclose(got.float(), want.float(), rtol=8e-3,
                                    atol=8e-3)
            route = _gather_plan(m, k, d, Uc, bd)
            check(ok and got.dtype == dtype,
                  f"gossip_gather {(m, k, d)} {dtype} {route} err {err}")
            results.append({"kernel": "gossip_gather", "shape": [m, k, d],
                            "dtype": str(dtype).split(".")[-1],
                            "route": route.route, "block_d": route.block_d,
                            "max_abs_err": err, "ok": True})
    results += _gather_edge_cases(ctx)

    results += _head_cases(ctx)
    results += _scatter_cases(ctx)
    results += _pushsum_cases(ctx)
    results += _topk_cases(ctx)
    results += _flash_cases(ctx)
    results += _rglru_cases(ctx)
    torch.cuda.synchronize()
    tol = 8e-3
    emit("kernels", cases=len(results),
         # share_of_tol: the worst element's |got - want| over allclose's
         # bound tol + tol |want|
         flash_model_shape={
             "shape": [2, 4096, 16, 1, 256], "window": 2048,
             "dtype": "bfloat16", "rtol_atol": tol,
             "max_abs_err": ctx["flash_err"][0],
             "share_of_tol": ctx["flash_err"][1],
             "q_x8_max_abs_err": ctx["flash_q_x8_err"][0],
             "q_x8_share_of_tol": ctx["flash_q_x8_err"][1],
             "worst_by_dtype": ctx["flash_worst_err"]},
         results=results)


def _head_cases(ctx):
    """head_gather_matmul against the plain einsum (cuBLAS f32, TF32 off)
    on the card, rtol/atol 1e-5 (the kernel's f32 FMA chains and group
    sums add in another order): the serve shapes (m 100, d 64, n 10; B 1
    and 64 on the tiled route, 1024 on the warp route), all four dtype
    pairs, warp-route slabs that start off a 16-byte boundary (d * n odd,
    n not a multiple of 4), n at the warp route's edges (1, 32) and past
    it (33, 130), d 12,288 and block_n on the tiled route, an out-of-range
    user id (a NaN row) on both routes, and knobs the plan refuses
    (ValueError)."""
    torch = ctx["torch"]
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.head_gather import plan as head_plan
    f32, bf16 = torch.float32, torch.bfloat16
    sms = _build.sm_count("cuda")

    def head_case(B, d, n, m, seed, hdt=f32, wdt=f32):
        gh = torch.Generator(device="cuda").manual_seed(seed)
        uid = torch.randint(0, m, (B,), generator=gh, device="cuda",
                            dtype=torch.int32)
        if B > 1:
            uid[-1] = uid[0]
        # features of standard deviation 1/sqrt(d) past d 1024, so that
        # logits stay O(1) as at the serve shape: with unit features a sum
        # of 12,288 products reaches +-300 and f32 rounding in any order
        # (the oracle's cuBLAS order too) errs by ~1e-4 near zero
        scale = d ** -0.5 if d > 1024 else 1.0
        H = (torch.randn((B, d), generator=gh, device="cuda") * scale).to(
            hdt)
        W = torch.randn((m, d, n), generator=gh, device="cuda").to(wdt)
        b = torch.randn((m, n), generator=gh, device="cuda").to(wdt)
        return uid, H, W, b

    pairs = [(f32, f32), (bf16, f32), (f32, bf16), (bf16, bf16)]
    hcases = [(B, 64, 10, 100, f32, f32, None) for B in (1, 64, 1024)]
    hcases += [(1024, 64, 10, 100, hdt, wdt, None) for hdt, wdt in pairs[1:]]
    hcases += [(17, 64, 1, 100, f32, f32, None),
               (17, 64, 130, 100, f32, f32, None),
               (9, 1, 10, 7, f32, f32, None), (9, 65, 10, 7, f32, f32, None),
               (33, 64, 10, 100, bf16, f32, None),
               (33, 65, 130, 7, bf16, f32, None),
               (33, 64, 10, 100, bf16, bf16, None),
               (40, 65, 7, 9, f32, f32, None), (40, 33, 33, 9, bf16, f32, None),
               # the warp route (more than 2 requests per SM): slabs off a
               # 16-byte boundary, n at its edges
               (300, 65, 7, 9, f32, f32, None),
               (300, 65, 7, 9, bf16, bf16, None),
               (300, 63, 7, 9, f32, bf16, None),
               (300, 65, 10, 7, bf16, f32, None),
               (300, 33, 32, 9, f32, f32, None),
               (300, 64, 1, 100, f32, f32, None),
               (300, 1, 10, 7, f32, f32, None),
               (5, 12288, 10, 3, f32, f32, None),
               (5, 12288, 10, 3, bf16, bf16, None),
               (1024, 64, 10, 100, f32, f32, 3),
               (1024, 64, 10, 100, f32, f32, 256),
               (17, 64, 130, 100, f32, bf16, 32)]
    results = []
    for i, (B, d, n, m, hdt, wdt, bn) in enumerate(hcases):
        args = head_case(B, d, n, m, 200 + i, hdt, wdt)
        got = ops.head_gather_matmul(*args, force="cuda", block_n=bn)
        want = ops.head_gather_matmul(*args, force="ref")
        err = max_abs(got, want)
        ok = got.dtype == f32 and torch.allclose(got, want, rtol=1e-5,
                                                 atol=1e-5)
        pl = head_plan(B, d, n, args[2].element_size(), sms, bn)
        key = f"{hdt}/{wdt}".replace("torch.", "")
        check(ok, f"head_gather_matmul {(B, d, n, m)} {key} block_n {bn} "
                  f"{pl.route} err {err}")
        if (B, d, n, hdt, wdt, bn) == (1024, 64, 10, f32, f32, None):
            ctx["head_err"] = err
        results.append({"kernel": "head_gather_matmul",
                        "shape": [B, d, n, m], "dtype": key,
                        "route": pl.route, "warps": pl.warps,
                        "block_n": pl.block_n, "max_abs_err": err,
                        "ok": True})
    # an out-of-range user id: that row NaN, the others as the oracle
    for B, bn in ((300, None), (64, None), (300, 16)):
        uid, H, W, b = head_case(B, 64, 10, 100, 250)
        bad = uid.clone()
        bad[5] = 100
        got = ops.head_gather_matmul(bad, H, W, b, force="cuda", block_n=bn)
        want = ops.head_gather_matmul(uid, H, W, b, force="ref")
        keep = torch.arange(B, device="cuda") != 5
        check(bool(torch.isnan(got[5]).all()) and torch.allclose(
            got[keep], want[keep], rtol=1e-5, atol=1e-5),
            f"head_gather_matmul out-of-range uid, block_n {bn}")
        results.append({"kernel": "head_gather_matmul",
                        "check": "uid = m gives a NaN row", "route":
                        head_plan(B, 64, 10, 4, sms, bn).route, "ok": True})
    # knobs and shapes the plan refuses
    for B, d, n, bn in ((64, 64, 10, 0), (64, 64, 10, 257),
                        (4, 12289, 10, None), (4, 12289, 10, 16)):
        args = head_case(B, d, n, 3, 260)
        try:
            ops.head_gather_matmul(*args, force="cuda", block_n=bn)
            refused = False
        except ValueError:
            refused = True
        check(refused, f"head_gather_matmul took d={d} block_n={bn}")
        results.append({"kernel": "head_gather_matmul", "check":
                        f"d={d} block_n={bn} refused", "ok": True})
    return results


def _scatter_cases(ctx):
    """gossip_scatter and gossip_scatter_many against their plain versions
    on the card.  The grid: f32 and bf16 U, f32 X into a bf16 U, set and
    accumulate, unsorted rows, n in {0, 1, 25, m}, d in {1, 5, 513,
    13,328} (13,328 takes the vector route, the others and a
    4-byte-offset X the scalar one).  Then each tiling of the plan at full
    width: 8 slots a thread at n 1024, 1 to 8 slots at d 13,328 (block_d),
    and the write-back of 2, 3 and 4 pairs in one launch (f32 as the
    sampled round, bf16, mixed, one misaligned X, the most slots, n 1024;
    4 pairs of 50 rows at d 13,978, the sampled flat-core codec round).
    Set is an exact copy and accumulate one f32 add then one rounding on
    both sides: bitwise.  The kernel writes into each U's storage:
    data_ptr unchanged, dormant rows untouched."""
    torch = ctx["torch"]
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import gossip_scatter as gs
    f32, bf16 = torch.float32, torch.bfloat16
    results, worst = [], 0.0
    g = torch.Generator(device="cuda").manual_seed(7)
    sms = _build.sm_count("cuda")

    def case(m, n, d, xt, ut, acc, pairs=1, block_d=None, offset=()):
        nonlocal worst
        rows = torch.randperm(m, generator=g, device="cuda")[:n].to(
            torch.int32)
        Xs = []
        for q in range(pairs):
            X = torch.randn((n, d), generator=g, device="cuda").to(xt)
            if q in offset and n:
                # a 4-byte offset: the kernel must take the scalar route
                X = torch.empty(n * d + 1, device="cuda", dtype=xt)[1:].view(
                    n, d).copy_(X)
            Xs.append(X)
        U0 = [torch.randn((m, d), generator=g, device="cuda").to(ut)
              for _ in range(pairs)]
        Us, want = [U.clone() for U in U0], [U.clone() for U in U0]
        ptrs = [U.data_ptr() for U in Us]
        if pairs == 1:
            got = [ops.gossip_scatter(rows, Xs[0], Us[0], accumulate=acc,
                                      force="cuda", block_d=block_d)]
            ops.gossip_scatter(rows, Xs[0], want[0], accumulate=acc,
                               force="ref")
        else:
            got = ops.gossip_scatter_many(rows, Xs, Us, accumulate=acc,
                                          force="cuda", block_d=block_d)
            ops.gossip_scatter_many(rows, Xs, want, accumulate=acc,
                                    force="ref")
        torch.cuda.synchronize()
        dormant = torch.ones(m, dtype=torch.bool, device="cuda")
        dormant[rows.long()] = False
        err = max(max_abs(a, b) for a, b in zip(got, want))
        worst = max(worst, err)
        what = f"gossip_scatter {(m, n, d)} x{pairs} X {xt} U {ut} " \
               f"acc={acc} block_d={block_d}"
        check(all(a is b for a, b in zip(got, Us))
              and [U.data_ptr() for U in Us] == ptrs
              and all(U.dtype == ut for U in Us),
              f"{what} did not write in place")
        check(all(torch.equal(a, b) and torch.equal(a[dormant], u[dormant])
                  for a, b, u in zip(got, want, U0)), f"{what} err {err}")
        p = gs.plan(n, d, sms, pairs, block_d,
                    aligned=not (offset and n)) if n and d else None
        results.append({"kernel": "gossip_scatter" if pairs == 1
                        else "gossip_scatter_many", "shape": [m, n, d],
                        "pairs": pairs,
                        "dtype": f"{xt}->{ut}".replace("torch.", ""),
                        "accumulate": acc, "block_d": block_d,
                        "plan": p and p._asdict(),
                        "check": "bitwise == ref", "max_abs_err": err,
                        "ok": True})
        return p

    m = 100
    for i, (n, d, xt, ut, acc) in enumerate(
            (n, d, xt, ut, acc) for n in (0, 1, 25, m)
            for d in (1, 5, 513, 13328)
            for xt, ut in ((f32, f32), (bf16, bf16), (f32, bf16))
            for acc in (False, True)):
        case(m, n, d, xt, ut, acc, offset=(0,) if i % 7 == 3 else ())
    # n 1024: more blocks than the card holds at once, 8 slots a thread
    for xt, ut, acc in ((f32, f32, False), (f32, f32, True),
                        (bf16, bf16, False), (f32, bf16, True)):
        p = case(1200, 1024, 13328, xt, ut, acc)
        check(p.vecs == gs.max_vecs(1) and p.blocks > sms * gs.RESIDENT_BLOCKS,
              f"n 1024 plan {p}")
    # 1 to 8 slots per thread at full width, and the scalar route there
    for block_d in (128, 512, 1152, 2048, 4096, 8192):
        p = case(m, 25, 13328, f32, f32, False, block_d=block_d)
        check(p.vecs * p.threads * 4 == block_d, f"block_d {block_d}: {p}")
    case(m, 25, 13328, bf16, bf16, True, block_d=8192)
    case(m, 25, 13328, f32, f32, True, offset=(0,))
    # the write-back in one launch: 2 pairs (the sampled round), 4 (with
    # a codec), dtypes as the single pair, one misaligned X
    for pairs in (2, 3, 4):
        for xt, ut, acc in ((f32, f32, False), (f32, f32, True),
                            (bf16, bf16, False), (f32, bf16, True)):
            case(m, 25, 13328, xt, ut, acc, pairs=pairs)
        case(m, 25, 513, f32, f32, False, pairs=pairs)
        case(m, 25, 13328, f32, f32, True, pairs=pairs, offset=(1,))
        case(m, 25, 13328, f32, f32, False, pairs=pairs,
             block_d=4 * gs.THREADS * gs.max_vecs(pairs))
        case(1200, 1024, 13328, f32, f32, False, pairs=pairs)
    # the sampled flat-core codec round's write-back: 4 pairs, 50 of 100
    # rows, d 13,978 (not a multiple of 4)
    for acc in (False, True):
        case(m, 50, 13978, f32, f32, acc, pairs=4)
    # more chunks than the grid's y extent: the striding instance (at
    # 128 columns a chunk, 65,537 chunks; both routes, 1 and 2 pairs)
    wide = 128 * gs.MAX_GRID_Y + 132     # a multiple of 4: vector route
    for xt, ut, acc, pairs, off in ((f32, f32, False, 1, ()),
                                    (f32, f32, True, 2, ()),
                                    (bf16, bf16, False, 2, ()),
                                    (f32, f32, True, 1, (0,))):
        p = case(4, 2, wide, xt, ut, acc, pairs=pairs, block_d=128,
                 offset=off)
        check(p.grid_y == gs.MAX_GRID_Y < p.chunks, f"wide plan {p}")
    rows = torch.arange(3, dtype=torch.int32, device="cuda")
    try:
        ops.gossip_scatter_many(
            rows, [torch.zeros((3, 8), device="cuda")] * 2,
            [torch.zeros((4, 8), device="cuda"),
             torch.zeros((4, 8), device="cuda", dtype=bf16)], force="cuda")
        check(False, "gossip_scatter_many took U of two dtypes")
    except TypeError:
        pass
    ctx["scatter_err"] = worst
    return results


def _pushsum_cases(ctx):
    """pushsum_mix against P.float() @ U.float() (cuBLAS, TF32 off) at m in
    {1, 7, 8, 100, 128, 129, 257} (one row tile up to 128, then 2 and 3),
    d in {1, 511, 513, 13,328}, and the timed (1024, 13,328); f32 and bf16
    U, and an f32 U 4 bytes off 16-byte alignment (the unaligned staging).
    Both sum m f32 products in other orders: rtol/atol 1e-5 for f32 U; a
    bf16 output rounds once on each side, so one bf16 ulp, rtol/atol
    8e-3."""
    torch = ctx["torch"]
    from repro_torch.kernels import ops
    f32, bf16 = torch.float32, torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(11)
    results, worst = [], {}
    shapes = [(m, (1, 511, 513, 13328)) for m in (1, 7, 8, 100, 128, 129,
                                                    257)]
    for m, ds in shapes + [(1024, (13328,))]:
        P = torch.rand((m, m), generator=g, device="cuda")
        P = (P / P.sum(1, keepdim=True)).contiguous()
        for d in ds:
            U32 = torch.randn((m, d), generator=g, device="cuda")
            variants = [(f32, False), (bf16, False)]
            if (m, d) == (100, 13328):
                variants.append((f32, True))
            for dt, offset in variants:
                U = U32.to(dt)
                if offset:
                    U = torch.empty(m * d + 1, device="cuda")[1:].view(
                        m, d).copy_(U)
                got = ops.pushsum_mix(P, U, force="cuda")
                want = (P.float() @ U.float()).to(dt)
                torch.cuda.synchronize()
                tol = 1e-5 if dt == f32 else 8e-3
                err = max_abs(got, want)
                worst[str(dt)] = max(worst.get(str(dt), 0.0), err)
                check(got.dtype == dt and torch.allclose(
                    got.float(), want.float(), rtol=tol, atol=tol),
                    f"pushsum_mix {(m, d)} {dt} err {err}")
                if (m, d, dt, offset) == (100, 13328, f32, False):
                    ctx["pushsum_err"] = err
                results.append({"kernel": "pushsum_mix", "shape": [m, d],
                                "dtype": str(dt).split(".")[-1],
                                "unaligned": offset,
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
    the flat-core codec runs' shapes (d 13,978, K 873: m 100 on the
    random table, and m 50 on the undirected table induced on 50 clients),
    repeated neighbor ids, f32 and bf16 values, uint16 and int32 columns
    (d > 65535 takes int32), out-of-range columns, duplicate columns, and
    block_d of 128 and of a whole row (dynamic shared memory above 48 KB).
    The routes of `plan`: staged with every payload row in flight (odd K,
    so most rows start off a 16-byte boundary), staged through a ring (m
    50, k 40: 34 of 40 rows, in 2 chunks), staged in chunks (d 70,001),
    chunked beyond one wave (m 1024, k 16; block_d 128) and where a
    payload row does not fit (K 40,000); duplicate columns on the staged
    route (deferred past the claims); an
    out-of-range neighbor id (a NaN row) on both routes, an empty payload
    (K 0), and block_d values no route takes (ValueError).
    Both sum each column's neighbors in j order with rounded products and
    round once: bitwise where a row's columns are distinct; duplicates add
    in the atomics' order, rtol/atol 2e-5 (f32) and 8e-3 (bf16).  Also the
    codec wire's uint16 on the card: the int64 -> uint16 cast and a
    host/device copy."""
    torch = ctx["torch"]
    from repro_torch.core import gossip, topology
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.topk_gather import plan as topk_plan
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
    Pind = gossip.wire_only(_induced_table(torch, topology.get_schedule(
        "undirected", 100, 10, 0).at(0).to("cuda")))
    cases = [dict(m=m, k=k, d=d, K=K) for m, k, d, K in (
        (5, 2, 64, 3), (33, 4, 1100, 17), (8, 1, 512, 1), (17, 3, 129, 129),
        (16, 4, 700, 44), (100, 11, 13328, 833), (100, 1, 13328, 833),
        (13, 3, 70001, 500), (7, 0, 50, 5))]
    cases += [dict(m=9, k=3, d=260, K=20, oob=True),
              dict(m=9, k=3, d=260, K=20, dup=True),
              dict(m=100, k=11, d=13328, K=833, table=True),
              dict(m=100, k=11, d=13978, K=873, table=True),
              dict(m=50, k=31, d=13978, K=873, table="induced"),
              dict(m=37, k=5, d=13328, K=833, block_d=128),
              dict(m=37, k=5, d=13328, K=833, block_d=13328),
              dict(m=1024, k=16, d=13328, K=833),
              dict(m=50, k=40, d=13328, K=831),
              dict(m=6, k=3, d=65535, K=40000),
              dict(m=9, k=3, d=260, K=20, bad_id=True),
              dict(m=6, k=3, d=65535, K=40000, bad_id=True),
              dict(m=5, k=2, d=64, K=0)]
    worst = {}
    sms = _build.sm_count("cuda")
    for i, c in enumerate(cases):
        m, k, d, K = c["m"], c["k"], c["d"], c["K"]
        cdts = (i32,) if d > 65535 else (u16, i32)
        for vdt in (f32, bf16):
            for cdt in cdts:
                idx, w, vals, cols = _payload_case(
                    torch, m, k, d, K, 300 + i, vdt, cdt,
                    dup=c.get("dup", False), oob=c.get("oob", False))
                if c.get("table") == "induced":
                    idx, w = Pind.idx, Pind.w.contiguous()
                elif c.get("table"):
                    idx, w = Pw.idx, Pw.w.contiguous()
                pl = topk_plan(m, k, K, d, vals.element_size(),
                               cols.element_size(), sms, c.get("block_d"))
                if c.get("bad_id"):
                    # neighbor id m in row 2: that row NaN, the others as
                    # the plain version with the id replaced
                    bad = idx.clone()
                    bad[2, 0] = m
                    got = ops.topk_gather(bad, w, vals, cols, d,
                                          force="cuda")
                    torch.cuda.synchronize()
                    nan_row = bool(torch.isnan(got[2].float()).all())
                    got[2] = 0
                    want = ops.topk_gather(idx, w, vals, cols, d,
                                           force="ref")
                    want[2] = 0
                    check(nan_row, f"topk_gather {c} bad id: no NaN row")
                else:
                    got = ops.topk_gather(idx, w, vals, cols, d,
                                          force="cuda",
                                          block_d=c.get("block_d"))
                    torch.cuda.synchronize()
                    want = ops.topk_gather(idx, w, vals, cols, d,
                                           force="ref")
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
                                "route": pl.route, "block_d": pl.block_d,
                                "stages": pl.stages,
                                "check": check_name, "bitwise": bitwise,
                                "max_abs_err": err, "ok": True})
    empty = ops.topk_gather(*(t[:0] for t in _payload_case(
        torch, 4, 2, 8, 3, 0, f32, u16)), 8, force="cuda")
    check(empty.shape == (0, 8), "topk_gather m=0")
    # block_d values no route takes: none, an accumulator larger than
    # shared memory, more than 65535 chunks
    for bd, d in ((0, 13328), (60000, 70001), (1, 70001)):
        args = _payload_case(torch, 8, 5, d, 833, 9, f32, i32)
        try:
            ops.topk_gather(*args, d, force="cuda", block_d=bd)
            refused = False
        except ValueError:
            refused = True
        check(refused, f"topk_gather took block_d={bd} at d={d}")
        results.append({"kernel": "topk_gather", "check":
                        f"block_d={bd} at d={d} refused", "ok": True})
    ctx["topk_worst_err"] = worst
    return results


def _flash_cases(ctx):
    """flash_attention against flash_attention_ref (full-matrix f32 math,
    cuBLAS with TF32 off) on the card: the JAX sweep's shapes
    (tests/test_kernels.py:102-109), MHA, GQA 2:1 and MQA at hd 32, 64,
    80, 128 and 256, S not a multiple of the tile (1000, 77, 1), window 0,
    = tile, not a multiple of the tile and >= S, B > 1, other tiles (bq,
    bk), f32 and bf16, the dense family's four head shapes at S 2048
    (danube's hd 80 with its window 4096 at S 8192; qwen2's group of 7,
    whose 126-row tiles leave 2 rows idle), and the hybrid model's prefill
    shape, plain and with q scaled x8 (a concentrated softmax).  Both sum
    in f32 in other orders: rtol/atol 2e-5 for f32; a bf16 output rounds
    once on each side, so one bf16 ulp, rtol/atol 8e-3, and since an
    output that averages thousands of keys is small beside 8e-3, also
    block_rel_l2 <= FLASH_REL_L2_BF16 (reported for f32 too).  The bf16
    kernel has one tile (TC_TILES):
    the explicit-tile cases run it at that tile, and one case checks that
    another tile raises."""
    torch = ctx["torch"]
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import TC_TILES
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(B, S, H, Hkv, hd, win, None, None) for B, S, H, Hkv, hd, win in (
        (1, 128, 4, 4, 64, 0), (2, 256, 4, 2, 64, 0), (1, 256, 8, 1, 32, 0),
        (1, 256, 4, 2, 64, 64), (1, 512, 2, 2, 128, 128),
        (2, 128, 2, 1, 128, 96),
        (2, 1000, 4, 4, 64, 0), (2, 1000, 4, 2, 128, 64),
        (2, 1000, 8, 1, 256, 300), (2, 1000, 4, 1, 256, 1000),
        (1, 1000, 2, 1, 256, 2048), (3, 77, 4, 2, 64, 13),
        (2, 1, 4, 1, 256, 0), (0, 16, 2, 1, 64, 0))]
    cases += [(2, 1000, 4, 2, 128, 300, 32, 16), (1, 77, 2, 1, 256, 0, 16, 48),
              (1, 300, 4, 1, 256, 100, 48, 64), (1, 300, 2, 2, 32, 0, 64, 16)]
    # the dense family at full width: qwen2-0.5b (14 on 2, hd 64: g 7),
    # h2o-danube-1.8b (32 on 8, hd 80, window 4096 > S / 2), granite-3-2b
    # (32 on 8, hd 64), codeqwen1.5-7b (32 on 32, hd 128); then g 7 with a
    # window and S no multiple of its 18 positions, hd 80 at awkward S,
    # windows and the f32 route's other tiles
    cases += [(1, 2048, 14, 2, 64, 0, None, None),
              (1, 8192, 32, 8, 80, 4096, None, None),
              (1, 2048, 32, 8, 64, 0, None, None),
              (1, 2048, 32, 32, 128, 0, None, None),
              (2, 1000, 14, 2, 64, 300, None, None),
              (1, 77, 7, 1, 64, 13, None, None),
              (3, 77, 7, 1, 80, 13, None, None),
              (2, 333, 8, 2, 80, 0, None, None),
              (1, 1000, 4, 4, 80, 64, None, None),
              (1, 300, 4, 2, 80, 100, 48, 64)]
    g = torch.Generator(device="cuda").manual_seed(21)
    results, worst = [], {}

    def run(B, S, H, Hkv, hd, win, bq, bk, dt, q_scale=1.0):
        q = (torch.randn((B, S, H, hd), generator=g, device="cuda")
             * q_scale).to(dt)
        k = torch.randn((B, S, Hkv, hd), generator=g, device="cuda").to(dt)
        v = torch.randn((B, S, Hkv, hd), generator=g, device="cuda").to(dt)
        got = ops.flash_attention(q, k, v, window=win, force="cuda", bq=bq,
                                  bk=bk)
        want = ops.flash_attention(q, k, v, window=win, force="ref")
        torch.cuda.synchronize()
        tol = 2e-5 if dt == f32 else 8e-3
        err = max_abs(got, want)
        # the share of allclose's bound |got - want| <= tol + tol |want|
        # that the worst element uses
        share = float(((got.float() - want.float()).abs() / (
            tol + tol * want.float().abs())).max()) if got.numel() else 0.0
        rel = block_rel_l2(torch, got, want)
        key = str(dt).split(".")[-1]
        worst[key] = max(worst.get(key, 0.0), err)
        check(got.dtype == dt and got.shape == q.shape and torch.allclose(
            got.float(), want.float(), rtol=tol, atol=tol)
            and (dt == f32 or rel <= FLASH_REL_L2_BF16),
            f"flash_attention {(B, S, H, Hkv, hd)} window {win} bq {bq} "
            f"bk {bk} {dt} err {err} block rel L2 {rel}")
        results.append({"kernel": "flash_attention",
                        "shape": [B, S, H, Hkv, hd], "window": win,
                        "bq": bq, "bk": bk, "dtype": key, "q_scale": q_scale,
                        "rtol_atol": tol, "max_abs_err": err,
                        "share_of_tol": share, "block_rel_l2": rel,
                        "ok": True})
        return err, share

    for c in cases:
        run(*c, f32)
        # the bf16 kernel runs at its own tile where the case names another
        tile = c[6:] if tuple(c[6:]) in TC_TILES else (None, None)
        run(*c[:6], *tile, bf16)
    q = torch.zeros((1, 64, 2, 64), device="cuda", dtype=bf16)
    kv = torch.zeros((1, 64, 1, 64), device="cuda", dtype=bf16)
    try:
        ops.flash_attention(q, kv, kv, force="cuda", bq=32, bk=16)
        refused = False
    except ValueError:
        refused = True
    check(refused, "the bf16 flash_attention took a tile it is not built "
                   "for (bq 32, bk 16)")
    results.append({"kernel": "flash_attention", "dtype": "bfloat16",
                    "bq": 32, "bk": 16, "refused": True, "ok": True})
    # head dims the kernel is not built for raise on both routes
    for hd in (48, 96, 112):
        for dt in (f32, bf16):
            q = torch.zeros((1, 64, 2, hd), device="cuda", dtype=dt)
            kv = torch.zeros((1, 64, 1, hd), device="cuda", dtype=dt)
            try:
                ops.flash_attention(q, kv, kv, force="cuda")
                refused = False
            except ValueError:
                refused = True
            check(refused, f"flash_attention took hd {hd} ({dt})")
            results.append({"kernel": "flash_attention", "hd": hd,
                            "dtype": str(dt).split(".")[-1],
                            "refused": True, "ok": True})
    # the hybrid model's prefill: B 2, S 4096, 16 heads on 1 kv head,
    # hd 256, window 2048, bf16; then q x8, which concentrates each row's
    # softmax on a few keys (the P_hi + P_lo split is what keeps it within
    # the tolerance)
    ctx["flash_err"] = run(2, 4096, 16, 1, 256, 2048, None, None, bf16)
    ctx["flash_q_x8_err"] = run(2, 4096, 16, 1, 256, 2048, None, None, bf16,
                                q_scale=8.0)
    ctx["flash_worst_err"] = worst
    return results


def _rglru_cases(ctx):
    """rglru against rglru_ref on the card, bitwise: both round the
    product and then the sum of every step.  S and W not multiples of 32
    or 128, B > 1, a ~ 1 and a == 1, other steps ahead (bs) and chains per
    block (bw), empty shapes, and the hybrid model's prefill shape
    (2, 4096, 4096)."""
    torch = ctx["torch"]
    from repro_torch.kernels import ops
    g = torch.Generator(device="cuda").manual_seed(22)
    cases = [dict(shape=s) for s in ((1, 1, 1), (3, 1000, 300),
                                      (2, 37, 4097), (1, 4097, 33),
                                      (0, 5, 7), (2, 0, 7))]
    cases += [dict(shape=(2, 333, 1000), a="near_one"),
              dict(shape=(2, 333, 1000), a="one"),
              dict(shape=(2, 333, 1000), bs=1, bw=32),
              dict(shape=(2, 333, 1000), bs=32, bw=256),
              dict(shape=(2, 333, 1000), bs=2, bw=1024),
              dict(shape=(3, 77, 130), bs=2, bw=96),
              dict(shape=(2, 4096, 4096), main=True)]
    results = []
    for c in cases:
        shape = c["shape"]
        a = torch.rand(shape, generator=g, device="cuda")
        if c.get("a") == "near_one":
            a = 1.0 - a * 1e-6
        elif c.get("a") == "one":
            a = torch.ones(shape, device="cuda")
        b = torch.randn(shape, generator=g, device="cuda")
        got = ops.rglru(a, b, force="cuda", bs=c.get("bs"), bw=c.get("bw"))
        want = ops.rglru(a, b, force="ref")
        torch.cuda.synchronize()
        err = max_abs(got, want)
        check(got.dtype == torch.float32 and got.shape == a.shape
              and torch.equal(got, want),
              f"rglru {c} not bitwise: err {err}")
        if c.get("main"):
            ctx["rglru_err"] = err
        results.append({"kernel": "rglru", "shape": list(shape),
                        "case": {n: v for n, v in c.items() if n != "shape"},
                        "check": "bitwise == ref", "max_abs_err": err,
                        "ok": True})
    # 32 steps ahead take ~156 registers a thread: 1024 threads a block
    # exceed the register file, and the card refuses the launch, which
    # the wrapper must raise rather than return an unwritten tensor
    a = torch.rand((2, 33, 1000), generator=g, device="cuda")
    try:
        ops.rglru(a, a, force="cuda", bs=32, bw=1024)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    check(refused is not None and "CUDA error" in refused,
          f"a refused rglru launch returned instead of raising: {refused}")
    results.append({"kernel": "rglru", "shape": [2, 33, 1000],
                    "case": {"bs": 32, "bw": 1024},
                    "check": "refused launch raises", "error": refused,
                    "ok": True})
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
    # the f32 kernel path against the plain path on the card, every leaf
    # bitwise: the same run with every kernel swapped for its plain version
    with _plain_kernels():
        hp = run_experiment("dfedpgp", sim, device="cuda", eval_every=1,
                            return_state=True, data=data, init_params=init,
                            topology_at=lambda r: tables[r],
                            batches_at=lambda r: batches[r])
    _hold(torch, "dfedpgp", "kernel vs plain f32", dict(_state_leaves(a)),
          dict(_state_leaves(hp["state"])), 0)
    # the same 2 rounds in f64 on both devices, every leaf at rtol = atol =
    # 1e-9: in f64 a max-pool near-tie that parts f32 runs (the
    # `baselines` phase's witness) is ~5e8 times rarer
    f64 = {dev: _dfedpgp_rounds(ctx, sim, dev, torch.float64, init, tables,
                                batches) for dev in ("cuda", "cpu")}
    f64_err = _hold(torch, "dfedpgp", "card vs CPU f64", f64["cuda"],
                    f64["cpu"], 1e-9)
    emit("parity", rounds=sim.rounds, m=sim.m, rtol=1e-4, atol=5e-5,
         max_abs_err=errs, f32_kernel_vs_plain="bitwise",
         f64_card_vs_cpu={"rtol_atol": 1e-9, "max_abs_err": f64_err,
                          "leaves": len(f64["cuda"])})


def _dfedpgp_rounds(ctx, sim, dev, dtype, init, tables, batches) -> dict:
    """len(tables) resident DFedPGP rounds (`round_fn_flat`) at `sim`'s
    knobs in `dtype` on `dev` from CPU draws -> {leaf name: tensor} of the
    final state."""
    torch = ctx["torch"]
    from repro_torch import tree
    from repro_torch.core import partition
    from repro_torch.fl import simulator
    from repro_torch.models import cnn
    cfg = cnn.CNNConfig(image_size=sim.image_size, n_classes=sim.n_classes)
    init = tree.tree_map(lambda a: a.to(dtype), init)
    mask = partition.build_mask(init, partition.classifier_personal)
    algo = simulator.build_algorithm(
        "dfedpgp", lambda p, b: cnn.loss_fn(p, b, cfg), mask, sim)
    state, layout = algo.init_flat(init, device=dev)
    kv = sim.k_personal
    for P, b in zip(tables, batches):
        b = {"x": b["x"].to(dev, dtype), "y": b["y"].to(dev)}
        b = {"v": {k: a[:, :kv] for k, a in b.items()},
             "u": {k: a[:, kv:] for k, a in b.items()}}
        state, _ = algo.round_fn_flat(state, P.to(dev), b, layout)
    if dev == "cuda":
        torch.cuda.synchronize()
    return dict(_state_leaves(state))


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
    check(counts["gossip_scatter"] == sim.rounds
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
    one gossip_scatter launch per round writes back flat, opt_u, ef and
    ref, whose dormant rows stay frozen bit for bit)."""
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

    # sampled codec rounds: ef and ref go back with flat and opt_u in the
    # round's one gossip_scatter launch
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
          and scounts["gossip_scatter"] == ssim.rounds,
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


def _state_leaves(state, prefix=""):
    """(name, tensor) for every tensor of a round state: NamedTuples, dicts
    and tensors, None skipped."""
    if state is None:
        return
    if hasattr(state, "_fields"):
        for name, val in zip(state._fields, state):
            yield from _state_leaves(val, f"{prefix}{name}/")
    elif isinstance(state, dict):
        for key in sorted(state):
            yield from _state_leaves(state[key], f"{prefix}{key}/")
    else:
        yield prefix.rstrip("/"), state


def _parity_draws(torch, sim, cfg, seed: int = 11) -> dict:
    """One set of CPU draws for the baselines' card-vs-CPU rounds: data,
    init and tables from `seed`, round r's batches from 10 seed + r and
    its CFL sample from 10 seed + 10 + r."""
    from repro_torch.core import topology
    from repro_torch.core.baselines import sample
    from repro_torch.data import make_dataset, sample_batches
    from repro_torch.models import cnn
    k_total = sim.k_local + sim.k_personal
    data = make_dataset(seed, sim.m, n_train=sim.n_train, n_test=sim.n_test)
    return {
        "sim": sim, "cfg": cfg, "seed": seed,
        "init": cnn.init_params(torch.Generator().manual_seed(seed), cfg,
                                (sim.m,)),
        "batches": [sample_batches(torch.Generator().manual_seed(
            10 * seed + r), data, k_total, sim.batch)
            for r in range(sim.rounds)],
        "samples": [sample(torch.Generator().manual_seed(10 * seed + 10 + r),
                           sim.m, sim.sample_ratio)
                    for r in range(sim.rounds)],
        "tables": {kind: [topology.get_schedule(
            kind, sim.m, sim.n_neighbors, seed).at(r)
            for r in range(sim.rounds)] for kind in ("random", "undirected")}}


def _baseline_rounds(ctx, name, dev, dtype, draws) -> dict:
    """`draws["sim"].rounds` rounds of one baseline through its algorithm
    object (`simulator.build_algorithm`) in `dtype` on `dev` -> {leaf name:
    tensor} of the final state."""
    torch = ctx["torch"]
    from repro_torch import tree
    from repro_torch.core import partition
    from repro_torch.fl import simulator
    from repro_torch.models import cnn
    sim, cfg = draws["sim"], draws["cfg"]
    init = tree.tree_map(lambda a: a.to(dtype), draws["init"])
    mask = partition.build_mask(init, partition.classifier_personal)
    algo = simulator.build_algorithm(
        name, lambda p, b: cnn.loss_fn(p, b, cfg), mask, sim)
    state = algo.init(init, device=dev)
    kind = "undirected" if name in simulator.UNDIRECTED_ALGOS else "random"
    for r in range(sim.rounds):
        b = draws["batches"][r]
        b = {"x": b["x"].to(dev, dtype), "y": b["y"].to(dev)}
        if name in simulator.CFL:
            ctx_r = draws["samples"][r].to(dev)
        elif name == "local":
            ctx_r = None
        else:
            ctx_r = draws["tables"][kind][r].to(dev)
        state, _ = algo.round_fn(state, ctx_r, b)
    if dev == "cuda":
        torch.cuda.synchronize()
    return dict(_state_leaves(state))


def _hold(torch, algo, what, a, b, tol) -> float:
    """Every leaf of a within rtol = atol = tol of b (tol 0: bitwise) ->
    the max abs error."""
    check(a.keys() == b.keys(), f"{algo} {what}: the states differ in "
                                f"their leaves")
    worst = 0.0
    for leaf, x in a.items():
        y = b[leaf]
        d = x.cpu().double() - y.cpu().double()    # f64 leaves stay f64
        err = float(d.abs().max()) if d.numel() else 0.0
        worst = max(worst, err)
        ok = torch.equal(x.cpu(), y.cpu()) if tol == 0 else \
            torch.allclose(x.cpu(), y.cpu(), rtol=tol, atol=tol)
        check(ok, f"{algo} {what} {leaf}: max abs err {err} (tol {tol})")
    return worst


def _parting_clients(torch, a, b, m) -> tuple:
    """How far state a lies from b -> (max abs error, elements beyond
    rtol 1e-4, atol 5e-5, the clients (rows of the (m, ...) leaves) with
    one)."""
    worst, elems, clients = 0.0, 0, set()
    for leaf, x in a.items():
        x, y = x.cpu().double(), b[leaf].cpu().double()
        d = (x - y).abs()
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
        over = d > 5e-5 + 1e-4 * y.abs()
        elems += int(over.sum())
        if over.dim() and over.shape[0] == m:
            clients |= set(over.reshape(m, -1).any(1).nonzero()
                           .flatten().tolist())
    return worst, elems, clients


def _cnn_probe(torch, cfg):
    """One client's CNN forward as `cnn.features` computes it, returning
    each max pool's input and argmax and each ReLU's input sign."""
    import torch.nn.functional as F
    from repro_torch.models import cnn

    def probe(p, x):
        # the loss only puts the forward under the grad transform, as in
        # a step; the aux outputs are the readings
        f = p["features"]
        x = x.permute(0, 3, 1, 2)
        a1 = cnn._gn(cnn._conv(x, f["conv1"]), f["gn1"], f["gb1"],
                     cfg.gn_groups)
        r1 = F.relu(a1)
        h1, i1 = F.max_pool2d(r1, 2, 2, return_indices=True)
        a2 = cnn._gn(cnn._conv(h1, f["conv2"]), f["gn2"], f["gb2"],
                     cfg.gn_groups)
        r2 = F.relu(a2)
        h2, i2 = F.max_pool2d(r2, 2, 2, return_indices=True)
        a3 = h2.permute(0, 2, 3, 1).reshape(h2.shape[0], -1) @ f["dense"]
        return F.relu(a3).sum(), (r1, i1, r2, i2, a1 > 0, a2 > 0, a3 > 0)
    run = torch.func.vmap(torch.func.grad_and_value(probe, has_aux=True))
    return lambda p, x: run(p, x)[1][1]


def _pool_witness(ctx, draws) -> dict:
    """`local` in f32 on the card and on the CPU from one set of draws,
    one SGD step at a time.  Before each step each device runs the
    model's forward (vmap over the clients, as a step does) on its own
    params and records both max pools' argmax and every ReLU input's
    sign.  -> the clients beyond rtol 1e-4, atol 5e-5 after the rounds;
    the clients with a max-pool window whose argmax differs between the
    devices (its gradient goes to another input) and those with a ReLU
    input of another sign; and the flipped window with the least gap:
    its two inputs on each device and their distance in f32 ulps."""
    import numpy as np
    torch = ctx["torch"]
    from repro_torch.core import baselines
    from repro_torch.models import cnn
    sim, cfg = draws["sim"], draws["cfg"]
    algo = baselines.LocalOnly(loss_fn=lambda p, b: cnn.loss_fn(p, b, cfg))
    probe = _cnn_probe(torch, cfg)
    devs = {"card": "cuda", "cpu": "cpu"}
    states = {side: algo.init(draws["init"], device=dev)
              for side, dev in devs.items()}
    pool_clients, relu_clients, tightest = set(), set(), None
    step = 0
    for r in range(sim.rounds):
        b = draws["batches"][r]
        for k in range(b["x"].shape[1]):
            out = {}
            for side, st in states.items():
                bk = {n: a[:, k:k + 1].to(devs[side]) for n, a in b.items()}
                out[side] = [t.cpu() for t in probe(st.params,
                                                    bk["x"][:, 0])]
                st = st._replace(round=torch.full_like(st.round, r))
                states[side], _ = algo.round_fn(st, None, bk)
            c, g = out["cpu"], out["card"]
            for sc, sg in zip(c[4:], g[4:]):
                relu_clients |= set((sc != sg).reshape(sim.m, -1).any(1)
                                    .nonzero().flatten().tolist())
            for pool, (x_c, i_c, x_g, i_g) in enumerate(
                    ((c[0], c[1], g[0], g[1]), (c[2], c[3], g[2], g[3])), 1):
                xc, xg = x_c.flatten(-2), x_g.flatten(-2)
                ic, ig = i_c.flatten(-2), i_g.flatten(-2)
                top = xc.gather(-1, ic)
                flip = (ic != ig) & (top > 0)
                if not bool(flip.any()):
                    continue
                pool_clients |= set(flip.reshape(sim.m, -1).any(1)
                                    .nonzero().flatten().tolist())
                other = xc.gather(-1, ig)
                ulp = torch.nextafter(top, torch.full_like(top, float("inf")))
                gap = torch.where(flip, (top - other) / (ulp - top),
                                  torch.full_like(top, float("inf")))
                at = int(gap.argmin())
                pos = [int(t) for t in np.unravel_index(at, gap.shape)]
                if tightest is None or float(gap.flatten()[at]) < \
                        tightest["ulps"]:
                    ia, ib = int(ic[tuple(pos)]), int(ig[tuple(pos)])
                    tightest = {
                        "step": step, "pool": pool, "client": pos[0],
                        "sample": pos[1], "channel": pos[2],
                        "window": pos[3], "cpu_argmax": ia,
                        "card_argmax": ib,
                        "cpu_inputs": [float(xc[tuple(pos[:3])][ia]),
                                       float(xc[tuple(pos[:3])][ib])],
                        "card_inputs": [float(xg[tuple(pos[:3])][ia]),
                                        float(xg[tuple(pos[:3])][ib])],
                        "ulps": float(gap.flatten()[at])}
            step += 1
    a, b = (dict(_state_leaves(states[side])) for side in ("card", "cpu"))
    err, elems, parting = _parting_clients(torch, a, b, sim.m)
    flipped = pool_clients | relu_clients
    return {"seed": draws["seed"], "steps": step, "max_abs_err": err,
            "elements_beyond_tol": elems,
            "clients_beyond_tol": sorted(parting),
            "pool_flip_clients": sorted(pool_clients),
            "relu_flip_clients": sorted(relu_clients),
            "parting_all_flipped": parting <= flipped,
            "parting_with_pool_flip": len(parting & pool_clients),
            "tightest_pool_flip": tightest}


class _plain_kernels:
    """Within the block every `kernels.ops` wrapper takes its plain
    version, on any device."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.ops, self.saved = ops, ops._use_kernel
        ops._use_kernel = lambda force, t: self.saved("ref", t)

    def __exit__(self, *exc):
        self.ops._use_kernel = self.saved


def phase_baselines(ctx):
    """The paper's baselines at its defaults (m 100, n_neighbors 10, batch
    32, k_local 5, k_personal 1, sample_ratio 0.1): each of BASELINES for 3
    rounds through run_experiment(device="cuda"), one gossip_gather launch
    per DFL round and none for the CFL rows and local; the flat-core codec
    runs (codec="topk", gossip="pallas"): osgp, then dfedavgm sampling 50
    of 100 clients a round (at frac 0.25 its 25 active clients are fewer
    than the undirected width k 31, and the mix densifies by the
    reference's no_sparsity rule); then every algorithm 2 rounds from the
    same data, init, tables, batches, CFL samples and Dis-PFL masks (CPU
    generators), every state leaf held: the card against the CPU in f64
    at rtol = atol = 1e-9, and the f32 card bitwise against itself with
    every kernel swapped for its plain version (the flat-core runs too).
    The f32 card against the f32 CPU is reported on `local` with the
    max-pool / ReLU flips behind it (`_pool_witness`)."""
    torch = ctx["torch"]
    from repro_torch.compress import get_codec
    from repro_torch.core import partition, sampling
    from repro_torch.fl import simulator
    from repro_torch.fl.simulator import SimConfig, run_experiment
    from repro_torch.kernels import ops
    from repro_torch.models import cnn
    t_phase = time.perf_counter()
    sim = SimConfig(rounds=3)
    dfl = [a for a in BASELINES if a not in simulator.CFL and a != "local"]
    total = dict.fromkeys(ops.KERNELS, 0)
    runs = {}
    for algo in BASELINES:
        ops.reset_launch_counts()
        h = run_experiment(algo, sim, device="cuda", eval_every=1)
        counts = ops.launch_counts()
        want = sim.rounds if algo in dfl else 0
        check(counts["gossip_gather"] == want
              and sum(counts.values()) == want,
              f"{algo}: launches {counts} in {sim.rounds} rounds")
        check(all(v == v and abs(v) < 1e3 for v in h["loss"])
              and all(0.0 <= a <= 1.0 for a in h["acc"]),
              f"{algo}: loss {h['loss']}, acc {h['acc']}")
        check((h["wire_bytes"][-1] > 0) == (algo in dfl),
              f"{algo}: wire_bytes {h['wire_bytes']}")
        ms = [t * 1e3 for t in h["round_s"]]
        runs[algo] = {"launches": counts, "loss": h["loss"],
                      "acc": h["acc"], "round_ms": ms,
                      "ms_per_round_after_first": statistics.median(ms[1:]),
                      "wire_bytes": h["wire_bytes"][-1]}
        for k, v in counts.items():
            total[k] += v

    # the flat-core codec runs
    cfg = cnn.CNNConfig(image_size=sim.image_size, n_classes=sim.n_classes)
    init = cnn.init_params(torch.Generator().manual_seed(8), cfg, (sim.m,))
    flat_runs = {}
    for name, algo, kw in (
            ("osgp_topk", "osgp", {}),
            ("dfedavgm_topk_sampled", "dfedavgm",
             dict(participation="uniform", participation_frac=0.5))):
        fsim = SimConfig(rounds=3, codec="topk", gossip="pallas", **kw)
        sampled = fsim.participation != "full"
        ops.reset_launch_counts()
        h = run_experiment(algo, fsim, device="cuda", eval_every=1,
                           return_state=True, init_params=init)
        counts = ops.launch_counts()
        r = fsim.rounds
        check(counts["topk_gather"] == r and counts["gossip_gather"] == r
              and counts["gossip_scatter"] == (r if sampled else 0)
              and counts["pushsum_mix"] == 0,
              f"{name}: launches {counts} in {r} rounds")
        st = h["state"]
        # the same run from the same init with every kernel swapped for
        # its plain version: every state leaf bitwise (the kernels are
        # bitwise their plain versions on distinct columns, and the rest of
        # the round is the same code on the same card)
        with _plain_kernels():
            ops.reset_launch_counts()
            hp = run_experiment(algo, fsim, device="cuda", eval_every=1,
                                return_state=True, init_params=init)
            plain_counts = ops.launch_counts()
        check(sum(plain_counts.values()) == 0,
              f"{name}: the plain run launched {plain_counts}")
        plain_err = _hold(torch, name, "kernel vs plain f32",
                          dict(_state_leaves(st)),
                          dict(_state_leaves(hp["state"])), 0)
        check(st.flat.shape == (sim.m, 13978)
              and all(bool(torch.isfinite(t).all())
                      for t in (st.flat, st.ef, st.ref))
              and all(v == v and abs(v) < 1e3 for v in h["loss"]),
              f"{name}: loss {h['loss']}")
        entry = {"launches": counts, "loss": h["loss"], "acc": h["acc"],
                 "round_ms": [t * 1e3 for t in h["round_s"]],
                 "wire_bytes": h["wire_bytes"][-1],
                 "kernel_vs_plain": {"check": "bitwise, every state leaf",
                                     "max_abs_err": plain_err}}
        if sampled:
            sampler = sampling.get_sampler("uniform", fsim.m,
                                           fsim.participation_frac,
                                           fsim.seed)
            ever = torch.zeros(fsim.m, dtype=torch.bool)
            for t in range(r):
                ever[torch.as_tensor(sampler.active_at(t)).long()] = True
            dormant = (~ever).cuda()
            check(bool(dormant.any()), f"{name}: no dormant client")
            mask = partition.build_mask(init, partition.classifier_personal)
            core = simulator.build_flat_core(
                algo, None, mask, fsim,
                get_codec("topk", ratio=fsim.codec_ratio, seed=fsim.seed))
            st0, _ = core.init_flat(init, device="cuda")
            for field in ("flat", "mu", "ef", "ref"):
                a, b = getattr(st, field), getattr(st0, field)
                check(torch.equal(a[dormant], b[dormant]),
                      f"{name}: dormant rows of {field} moved")
            check(torch.equal(st.opt_u.momentum[dormant],
                              st0.opt_u.momentum[dormant])
                  and not torch.equal(st.flat[~dormant], st0.flat[~dormant]),
                  f"{name}: momentum rows moved or active rows froze")
            entry.update(n_active=sampler.n_active,
                         dormant_clients=int(dormant.sum()),
                         dormant_rows_frozen=["flat", "mu", "opt_u", "ef",
                                              "ref"])
        flat_runs[name] = entry
        for k, v in counts.items():
            total[k] += v

    # card vs CPU, 2 rounds of each algorithm from one set of CPU draws
    # (data, init, tables, batches, CFL samples; Dis-PFL's masks from its
    # default CPU generator).  In f32 the devices round convolutions and
    # norms differently; where a max-pool window's two largest inputs lie
    # a few ulps apart, or a ReLU input near 0, the devices send that
    # step's gradient different ways, the client's trajectory parts by
    # O(lr * grad) and gossip spreads it (`_pool_witness` shows it on
    # `local`, which has no gossip, for two draw sets).  So the gate runs
    # in f64, where ties that close are ~5e8 times rarer (the ratio of the
    # machine epsilons), at rtol = atol = 1e-9 (f64 readings up to 2.4e-13
    # on the H100); and the f32 card run is held bitwise against itself
    # with every kernel swapped for its plain version
    psim = SimConfig(rounds=2)
    draws = _parity_draws(torch, psim, cfg)
    parity = {}
    for algo in BASELINES:
        # gate 1: the code on the card = on the CPU, in f64
        a = _baseline_rounds(ctx, algo, "cuda", torch.float64, draws)
        b = _baseline_rounds(ctx, algo, "cpu", torch.float64, draws)
        f64_err = _hold(torch, algo, "card vs CPU f64", a, b, 1e-9)
        # gate 2: the f32 kernel path = the plain path, on the card
        k32 = _baseline_rounds(ctx, algo, "cuda", torch.float32, draws)
        with _plain_kernels():
            p32 = _baseline_rounds(ctx, algo, "cuda", torch.float32, draws)
        _hold(torch, algo, "kernel vs plain f32", k32, p32, 0)
        parity[algo] = {"leaves": len(a), "f64_card_vs_cpu": f64_err,
                        "f32_kernel_vs_plain": "bitwise"}
        runs[algo]["card_vs_cpu_max_abs_err"] = f64_err
    # reported: the f32 card against the f32 CPU on `local`, step by step,
    # with the max-pool and ReLU flips behind its parting clients, on the
    # gate's draws and on a second set
    witness = [_pool_witness(ctx, draws),
               _pool_witness(ctx, _parity_draws(torch, psim, cfg, seed=12))]
    ctx["baseline_launches"] = total
    emit("baselines", m=sim.m, n_neighbors=sim.n_neighbors, batch=sim.batch,
         k_local=sim.k_local, k_personal=sim.k_personal,
         sample_ratio=sim.sample_ratio, rounds=sim.rounds, runs=runs,
         flat_core=flat_runs,
         card_vs_cpu={"rounds": psim.rounds, "m": psim.m,
                      "f64_rtol_atol": 1e-9, "by_algo": parity,
                      "f32_local_witness": witness},
         launches_total=total,
         seconds=round(time.perf_counter() - t_phase, 3))


def _tensor_leaves(state) -> dict:
    """{leaf name: tensor} of an async state (the host tick index
    dropped)."""
    torch_leaves = {}
    for name, val in _state_leaves(state):
        if hasattr(val, "is_cuda"):
            torch_leaves[name] = val
    return torch_leaves


def _async_draws(torch, sim, cfg, ticks: int, seed: int = 13) -> dict:
    """One set of CPU draws for the async card-vs-CPU ticks: data and init
    from `seed`, tick t's minibatch from 10 seed + t and its push table
    (`to_push_sparse` of the random schedule's table t)."""
    from repro_torch.core import topology
    from repro_torch.data import make_dataset, sample_batches
    from repro_torch.models import cnn
    data = make_dataset(seed, sim.m, n_train=sim.n_train, n_test=sim.n_test)
    sched = topology.get_schedule("random", sim.m, sim.n_neighbors, seed)
    return {
        "init": cnn.init_params(torch.Generator().manual_seed(seed), cfg,
                                (sim.m,)),
        "batches": [{k: a[:, 0] for k, a in sample_batches(
            torch.Generator().manual_seed(10 * seed + t), data, 1,
            sim.batch).items()} for t in range(ticks)],
        "tables": [topology.to_push_sparse(sched.at(t))
                   for t in range(ticks)]}


def _async_ticks(ctx, sim, dev, dtype, draws) -> dict:
    """len(draws["tables"]) ticks of dfedpgp's AsyncRuntime at `sim`'s
    fleet knobs in `dtype` on `dev` -> {leaf name: tensor} of the final
    state, mailbox included."""
    torch = ctx["torch"]
    from repro_torch import tree
    from repro_torch.core import partition
    from repro_torch.fl import simulator
    from repro_torch.models import cnn
    cfg = cnn.CNNConfig(image_size=sim.image_size, n_classes=sim.n_classes)
    init = tree.tree_map(lambda a: a.to(dtype), draws["init"])
    mask = partition.build_mask(init, partition.classifier_personal)
    rt, state, _ = simulator.build_async(
        "dfedpgp", sim, lambda p, b: cnn.loss_fn(p, b, cfg), mask, init,
        device=dev)
    for P, b in zip(draws["tables"], draws["batches"]):
        state, _ = rt.tick(state, P.to(dev), {"x": b["x"].to(dev, dtype),
                                              "y": b["y"].to(dev)})
    if dev == "cuda":
        torch.cuda.synchronize()
    return _tensor_leaves(state)


def phase_async(ctx):
    """The async heterogeneity runtime at the paper's defaults (m 100,
    d_flat 13,328, n_neighbors 10, batch 32, k_local 5, k_personal 1):
    the uniform zero-delay ticks bitwise one round_fn_flat; 5 windows of
    tiered speeds (spread 5) and push delays up to 2 through
    run_experiment and the same ticks driven directly: mass conserved at
    every tick, one gossip_gather per delay group (3) on each fire tick
    and none on the others, the kernel path bitwise the plain path,
    finite loss, rising virtual time, fast tiers completing more rounds;
    2 windows card against CPU in f64 (rtol = atol = 1e-9, the f32 gap
    reported); topk codec fires under gossip="pallas" (one topk_gather and
    one gossip_gather per group, exact wire bytes, bitwise vs plain); the
    osgp and dfedavgm legs; 25% participation with frozen dormant rows;
    window and tick times, the device's busy share and the gated gather's
    device time."""
    torch = ctx["torch"]
    from repro_torch.core import partition, sampling, topology
    from repro_torch.data import make_dataset
    from repro_torch.device import seeded_generator
    from repro_torch.fl import simulator
    from repro_torch.fl.simulator import SimConfig, run_experiment
    from repro_torch.hetero import mailbox as mbox
    from repro_torch.hetero import profiles
    from repro_torch.hetero.runtime import AsyncRuntime
    from repro_torch.kernels import ops
    from repro_torch.models import cnn
    t_phase = time.perf_counter()
    out, marks = {}, {}

    def mark(name):
        marks[name] = round(time.perf_counter() - t_phase, 3)

    # 1. the sync reduction at full width: uniform profile, delay 0, one
    # round's pull table; k_v + k_u ticks, flush and drain = one round
    sim = SimConfig()
    algo, cfg = _paper_algo(sim, torch)
    data = make_dataset(21, sim.m, n_train=sim.n_train, n_test=sim.n_test,
                        device="cuda")
    init = cnn.init_params(torch.Generator().manual_seed(21), cfg, (sim.m,))
    P = topology.get_schedule("random", sim.m, sim.n_neighbors, 21).at(0) \
        .to("cuda")
    b = _round_batches(sim, data, 210, torch)
    s_sync, layout = algo.init_flat(init, device="cuda")
    ops.reset_launch_counts()
    s_sync, _ = algo.round_fn_flat(s_sync, P, b, layout)
    sync_counts = ops.launch_counts()
    rt, st = AsyncRuntime.build(algo, init, profiles.uniform(sim.m), depth=2,
                                device="cuda")
    ticks = [{k: a[:, t] for k, a in b["v"].items()}
             for t in range(algo.k_v)] + \
        [{k: a[:, t] for k, a in b["u"].items()} for t in range(algo.k_u)]
    ops.reset_launch_counts()
    for t, bt in enumerate(ticks):
        st, mt = rt.tick(st, P, bt)
        check(int(mt["n_fired"]) == (sim.m if t == len(ticks) - 1 else 0),
              f"uniform tick {t}: {int(mt['n_fired'])} fired")
    async_counts = ops.launch_counts()
    check(async_counts["gossip_gather"] == sync_counts["gossip_gather"] == 1
          and sum(async_counts.values()) == 1,
          f"sync reduction launches {async_counts} vs {sync_counts}")
    mail = mbox.flush(st.mail, st.clock.t)
    mail, got_f, got_mu = mbox.drain(mail, torch.ones(
        sim.m, dtype=torch.bool, device="cuda"))
    red = {"flat": (st.flat + got_f, s_sync.flat),
           "mu": (st.mu + got_mu, s_sync.mu),
           "opt_u": (st.opt_u.momentum, s_sync.opt_u.momentum)}
    for name, val in _state_leaves(st.personal, "personal/"):
        red[name] = (val, dict(_state_leaves(s_sync.personal,
                                             "personal/"))[name])
    for name, val in _state_leaves(st.opt_v.momentum, "opt_v/"):
        red[name] = (val, dict(_state_leaves(s_sync.opt_v.momentum,
                                             "opt_v/"))[name])
    for name, (x, y) in red.items():
        check(torch.equal(x, y), f"sync reduction: {name} differs by "
                                 f"{max_abs(x, y)}")
    check(layout.d_flat == 13328, f"d_flat {layout.d_flat}")
    out["sync_reduction"] = {"ticks": len(ticks), "leaves": len(red),
                             "check": "bitwise", "launches": async_counts}
    mark("sync_reduction")

    # 2. heterogeneous windows through run_experiment, then the same
    # ticks driven directly to read each tick's metrics and launches
    hsim = SimConfig(rounds=5, runtime="async", hetero="tiered",
                     speed_spread=5.0, push_delay_max=2, mailbox_depth=4)
    hcfg = cnn.CNNConfig(image_size=hsim.image_size,
                         n_classes=hsim.n_classes)
    hdata = make_dataset(hsim.seed, hsim.m, n_train=hsim.n_train,
                         n_test=hsim.n_test, device="cuda")
    hinit = cnn.init_params(seeded_generator(hsim.seed, 1, 0), hcfg,
                            (hsim.m,))

    hmask = partition.build_mask(hinit, partition.classifier_personal)

    def loss_fn(p, bb):
        return cnn.loss_fn(p, bb, hcfg)

    def hetero_run(name, s):
        """run_experiment, then the same windows through async_round with
        per-tick launch counts -> (history, ticks, final state)."""
        ops.reset_launch_counts()
        h = run_experiment(name, s, device="cuda", eval_every=1,
                           return_state=True, init_params=hinit)
        h["launches"] = ops.launch_counts()
        rt_, st_, sched = simulator.build_async(
            name, s, loss_fn, hmask, hinit, h["engine"].algo.codec, "cuda")
        log = []

        def on_tick(t, state, metrics):
            log.append({"t": t, "launches": ops.launch_counts(),
                        **{k: float(v) for k, v in metrics.items()}})
            ops.reset_launch_counts()

        ops.reset_launch_counts()
        tick, wire = 0, 0
        for _ in range(s.rounds):
            st_, _, tick, wire = simulator.async_round(
                rt_, st_, sched, hdata, s, tick, wire, on_tick=on_tick)
        return h, log, st_, rt_

    h, log, st_direct, hrt = hetero_run("dfedpgp", hsim)
    groups = hrt.profile_groups
    check(groups == 3, f"profile_groups {groups}")
    fire_ticks = [e["t"] for e in log if e["n_fired"] > 0]
    for e in log:
        want = groups if e["n_fired"] > 0 else 0
        check(e["launches"]["gossip_gather"] == want
              and sum(e["launches"].values()) == want,
              f"tick {e['t']}: launches {e['launches']}, fired "
              f"{e['n_fired']}")
        check(abs(e["mass_total"] - hsim.m) <= 1e-5 * hsim.m,
              f"tick {e['t']}: mass {e['mass_total']}")
        check(e["loss"] == e["loss"] and abs(e["loss"]) < 1e3,
              f"tick {e['t']}: loss {e['loss']}")
    check(h["launches"]["gossip_gather"] == groups * len(fire_ticks)
          and sum(h["launches"].values()) == groups * len(fire_ticks),
          f"run_experiment launches {h['launches']}, {len(fire_ticks)} "
          f"fire ticks")
    check(all(0.0 <= a <= 1.0 for a in h["acc"])
          and all(v == v for v in h["loss"]), f"acc {h['acc']}")
    check(all(x < y for x, y in zip(h["vtime"], h["vtime"][1:])),
          f"vtime {h['vtime']}")
    same = _hold(torch, "async", "run_experiment vs direct ticks",
                 _tensor_leaves(h["state"]), _tensor_leaves(st_direct), 0)
    rounds = h["state"].local_round.float().cpu()
    tier = torch.arange(hsim.m) * 5 // hsim.m
    by_tier = [float(rounds[tier == i].mean()) for i in range(5)]
    check(by_tier[0] > by_tier[-1] and all(
        x >= y for x, y in zip(by_tier, by_tier[1:])),
        f"local rounds by tier {by_tier}")
    ctx["async_launches"] = h["launches"]
    window_ms = [t * 1e3 for t in h["round_s"]]
    out["hetero"] = {
        "windows": hsim.rounds, "ticks": len(log), "groups": groups,
        "fire_ticks": fire_ticks, "launches": h["launches"],
        "loss": h["loss"], "acc": h["acc"], "vtime": h["vtime"],
        "mean_local_rounds": h["mean_local_rounds"],
        "local_rounds_by_tier": by_tier,
        "mass_total_by_tick": [e["mass_total"] for e in log],
        "window_ms": window_ms,
        "ms_per_window_after_first": statistics.median(window_ms[1:]),
        "ms_per_tick_after_first": statistics.median(window_ms[1:])
        / hrt.k_total, "direct_vs_run_experiment": same}
    mark("hetero")

    # 3. kernel against plain: the same ticks under the plain versions
    with _plain_kernels():
        ops.reset_launch_counts()
        _, plog, st_plain, _ = hetero_run("dfedpgp", hsim)
    check(all(sum(e["launches"].values()) == 0 for e in plog),
          "the plain async run launched a kernel")
    _hold(torch, "async", "kernel vs plain f32", _tensor_leaves(st_direct),
          _tensor_leaves(st_plain), 0)
    out["kernel_vs_plain"] = {"check": "bitwise, every state leaf incl. "
                              "mailbox slots and inbox",
                              "leaves": len(_tensor_leaves(st_direct))}
    mark("kernel_vs_plain")

    # 4. card against CPU: 2 windows from one set of CPU draws, f64 gated,
    # the f32 gap reported
    psim = SimConfig(rounds=2, runtime="async", hetero="tiered",
                     speed_spread=5.0, push_delay_max=2, mailbox_depth=4)
    draws = _async_draws(torch, psim, hcfg, 2 * hrt.k_total)
    a64 = _async_ticks(ctx, psim, "cuda", torch.float64, draws)
    b64 = _async_ticks(ctx, psim, "cpu", torch.float64, draws)
    f64_err = _hold(torch, "async", "card vs CPU f64", a64, b64, 1e-9)
    a32 = _async_ticks(ctx, psim, "cuda", torch.float32, draws)
    b32 = _async_ticks(ctx, psim, "cpu", torch.float32, draws)
    err32, elems32, parting32 = _parting_clients(torch, a32, b32, psim.m)
    out["card_vs_cpu"] = {
        "ticks": len(draws["tables"]), "f64_rtol_atol": 1e-9,
        "f64_max_abs_err": f64_err, "leaves": len(a64),
        "f32_max_abs_err": err32, "f32_elements_beyond_1e-4_5e-5": elems32,
        "f32_clients_beyond": sorted(parting32)}
    mark("card_vs_cpu")

    # 5. codec fires: topk, gamma 0.5, gossip="pallas"
    csim = SimConfig(rounds=3, runtime="async", hetero="tiered",
                     speed_spread=5.0, push_delay_max=2, mailbox_depth=4,
                     codec="topk", gossip="pallas", codec_gamma=0.5)
    ch, clog, cst, crt = hetero_run("dfedpgp", csim)
    cfire = [e["t"] for e in clog if e["n_fired"] > 0]
    for e in clog:
        want = groups if e["n_fired"] > 0 else 0
        check(e["launches"]["gossip_gather"] == want
              and e["launches"]["topk_gather"] == want
              and sum(e["launches"].values()) == 2 * want,
              f"codec tick {e['t']}: launches {e['launches']}")
        check(abs(e["mass_total"] - csim.m) <= 1e-5 * csim.m,
              f"codec tick {e['t']}: mass {e['mass_total']}")
    with _plain_kernels():
        _, _, cst_plain, _ = hetero_run("dfedpgp", csim)
    _hold(torch, "async codec", "kernel vs plain f32", _tensor_leaves(cst),
          _tensor_leaves(cst_plain), 0)
    codec = crt.algo.codec
    d = crt.layout.d_flat
    edges = int(sum(e["wire_edges"] for e in clog))
    want_bytes = edges * codec.row_bytes(d) + csim.m * 4 * d
    check(ch["wire_bytes"][-1] == want_bytes,
          f"codec wire bytes {ch['wire_bytes'][-1]} != {want_bytes}")
    ctx["async_codec_launches"] = ch["launches"]
    out["codec"] = {"windows": csim.rounds, "gamma": csim.codec_gamma,
                    "fire_ticks": cfire, "launches": ch["launches"],
                    "wire_bytes": ch["wire_bytes"], "wire_edges": edges,
                    "loss": ch["loss"], "acc": ch["acc"],
                    "kernel_vs_plain": "bitwise",
                    "window_ms": [t * 1e3 for t in ch["round_s"]]}
    mark("codec")

    # 6. the other push-sum algorithms, and participation
    legs = {}
    for name in ("osgp", "dfedavgm"):
        lsim = SimConfig(rounds=2, runtime="async", hetero="tiered",
                         speed_spread=5.0, push_delay_max=2)
        ops.reset_launch_counts()
        lh = run_experiment(name, lsim, device="cuda", eval_every=1,
                            return_state=True, init_params=hinit)
        counts = ops.launch_counts()
        mass = float(lh["engine"].mass_total(lh["state"]))
        check(abs(mass - lsim.m) <= 1e-5 * lsim.m
              and all(v == v and abs(v) < 1e3 for v in lh["loss"])
              and counts["gossip_gather"] > 0
              and counts["gossip_gather"] % groups == 0,
              f"{name} async: mass {mass}, loss {lh['loss']}, launches "
              f"{counts}")
        legs[name] = {"launches": counts, "loss": lh["loss"],
                      "acc": lh["acc"], "mass_total": mass,
                      "d_flat": lh["layout"].d_flat,
                      "window_ms": [t * 1e3 for t in lh["round_s"]]}
    out["legs"] = legs
    qsim = SimConfig(rounds=3, runtime="async", hetero="tiered",
                     speed_spread=5.0, push_delay_max=2,
                     participation="uniform", participation_frac=0.25)
    qrt, qst, qsched = simulator.build_async("dfedpgp", qsim, loss_fn,
                                             hmask, hinit, device="cuda")
    sampler = sampling.get_sampler("uniform", qsim.m,
                                   qsim.participation_frac, qsim.seed)
    prev = [qst]
    frozen = {"ticks": 0, "rows_checked": 0, "inbox_grew": 0}

    def on_tick(t, state, metrics):
        before = prev[0]
        dormant = ~torch.as_tensor(sampler.active_mask(t)).cuda()
        for name, (x, y) in {"flat": (state.flat, before.flat),
                             "mu": (state.mu, before.mu),
                             "opt_u": (state.opt_u.momentum,
                                       before.opt_u.momentum)}.items():
            check(torch.equal(x[dormant], y[dormant]),
                  f"tick {t}: a dormant row of {name} moved")
        grew = (state.mail.inbox_mu > before.mail.inbox_mu) & dormant
        frozen["ticks"] += 1
        frozen["rows_checked"] += int(dormant.sum())
        frozen["inbox_grew"] += int(grew.sum())
        check(abs(float(metrics["mass_total"]) - qsim.m) <= 1e-5 * qsim.m,
              f"participation tick {t}: mass {float(metrics['mass_total'])}")
        prev[0] = state

    tick, wire = 0, 0
    for _ in range(qsim.rounds):
        qst, _, tick, wire = simulator.async_round(
            qrt, qst, qsched, hdata, qsim, tick, wire, sampler=sampler,
            on_tick=on_tick)
    check(frozen["inbox_grew"] > 0, "no dormant inbox took mail")
    out["participation"] = dict(frozen, frac=qsim.participation_frac,
                                windows=qsim.rounds,
                                mean_local_rounds=float(
                                    qst.local_round.float().mean()))
    mark("legs_participation")

    # 7. timings: one profiled window from the hetero run's state, and the
    # gossip_gather call on a fire tick's gated push table
    def one_window():
        s2 = st_direct
        simulator.async_round(hrt, s2, topology.get_schedule(
            "random", hsim.m, hsim.n_neighbors, hsim.seed), hdata, hsim,
            len(log), 0)

    _, events, wall_ms = profiled(torch, one_window, cpu=True)
    busy_ms = sum(_dev_us(e) for e in events) / 1e3
    top = sorted(events, key=_dev_us, reverse=True)[:8]
    Pg = topology.to_push_sparse(topology.get_schedule(
        "random", hsim.m, hsim.n_neighbors, hsim.seed).at(fire_ticks[0])
    ).to("cuda")
    delay = hrt.profile.push_delay[Pg.idx.long()]
    gates = {dl: Pg.w * (delay == dl).to(Pg.w.dtype) for dl in range(groups)}
    U = torch.randn((hsim.m, layout.d_flat), device="cuda")
    gated = {}
    for dl, wg in gates.items():
        live = wg > 0
        # the least work this table needs: each live sender's row read
        # once, the output written once, the table read; 2 flops per live
        # edge and column
        senders = int(torch.unique(Pg.idx[live]).numel())
        nbytes = (senders + hsim.m) * layout.d_flat * 4 + Pg.idx.numel() * 8
        flops = 2 * int(live.sum()) * layout.d_flat
        t_b = nbytes / ctx["peak_bw"] * 1e3
        t_o = flops / ctx["peak_f32"] * 1e3
        # the library yardstick: torch.sparse.mm on the live edges in CSR
        rows = torch.arange(hsim.m, device="cuda")[:, None].expand_as(live)
        csr = torch.sparse_coo_tensor(
            torch.stack([rows[live], Pg.idx.long()[live]]), wg[live],
            (hsim.m, hsim.m)).coalesce().to_sparse_csr()
        check(torch.allclose(torch.sparse.mm(csr, U), ops.gossip_gather(
            Pg.idx, wg, U), rtol=1e-5, atol=1e-5),
            "gated sparse.mm yardstick disagrees")
        gated[str(dl)] = {
            "ms": device_ms(torch, lambda wg=wg: ops.gossip_gather(
                Pg.idx, wg, U, force="cuda")),
            "plain_ms": device_ms(torch, lambda wg=wg: ops.gossip_gather(
                Pg.idx, wg, U, force="ref")),
            "library_ms": device_ms(torch, lambda csr=csr: torch.sparse.mm(
                csr, U)),
            "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations",
            "live_edges": int(live.sum()), "live_senders": senders,
            "k": Pg.k}
    out["timings"] = {
        "card": ctx["smi"], "window_wall_ms": wall_ms,
        "tick_wall_ms": wall_ms / hrt.k_total,
        "device_busy_ms_per_window": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "host_syncs_per_window": hrt.k_total,
        "top_device_kernels": [
            {"name": e.key[:90], "ms_per_window": _dev_us(e) / 1e3,
             "calls_per_window": e.count} for e in top],
        "gossip_gather_gated_by_delay_group": gated,
        "note": "window_wall_ms under torch.profiler (CPU and CUDA "
                "activities); ms per window of run_experiment in "
                "hetero.window_ms; gated gather: device ms per call "
                "(profiler, 50 calls), m 100, d_flat 13,328, the fire "
                "tick's push table with delay group g's edges live"}
    emit("async", card=ctx["smi"], m=hsim.m, n_neighbors=hsim.n_neighbors,
         batch=hsim.batch,
         k_local=hsim.k_local, k_personal=hsim.k_personal,
         d_flat=layout.d_flat, profile=hsim.hetero,
         speed_spread=hsim.speed_spread, push_delay_max=hsim.push_delay_max,
         mailbox_depth=hsim.mailbox_depth, **out, seconds_at=marks,
         seconds=round(time.perf_counter() - t_phase, 3))


def _hold_bitwise(torch, a, b, what: str) -> int:
    """Every leaf of two states (NamedTuples, dicts, tensors, host ints)
    equal bit for bit -> the number of leaves held."""
    la, lb = dict(_state_leaves(a)), dict(_state_leaves(b))
    check(la.keys() == lb.keys(),
          f"{what}: leaves differ {sorted(set(la) ^ set(lb))}")
    for name, x in la.items():
        y = lb[name]
        if hasattr(x, "is_cuda"):
            check(x.dtype == y.dtype and x.device == y.device
                  and torch.equal(x, y),
                  f"{what}: {name} differs by {max_abs(x, y)}")
        else:
            check(x == y, f"{what}: {name} {x} != {y}")
    return len(la)


def _add_counts(total: dict, counts: dict) -> dict:
    return {k: total.get(k, 0) + v for k, v in counts.items()}


@contextlib.contextmanager
def _cudnn_deterministic(torch):
    """cuDNN held to its deterministic algorithms for the span, the flag
    restored after: a bitwise comparison of two runs on the card needs
    each run to repeat itself, and with cuDNN's default choice the sampled
    rounds do not (phase `obs` measures the gap)."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def _rerun_gap(torch, runs) -> float:
    """Max |a - b| over every tensor leaf of two runs' final states."""
    a, b = (dict(_state_leaves(h["state"])) for h in runs)
    return max(max_abs(x, b[k]) for k, x in a.items()
               if hasattr(x, "is_cuda"))


# launches of each registered program's N_ROUNDS (3) rounds on the card:
# the f32 "sparse" mix routes through gossip_gather (k < n in every
# program: 13 x 4, the sampled 7 x 4, Regime B 13 x 3 and 6 x 3), the
# sampled rounds write flat and momentum back in one gossip_scatter, the
# async tick fires once in 3 ticks (k_v + k_u = 3; one delay group), and
# every serve call is one head_gather_matmul
ANALYSIS_LAUNCHES = {
    "simA.resident": {"gossip_gather": 3},
    "simA.sampled": {"gossip_gather": 3, "gossip_scatter": 3},
    "regimeB.resident": {"gossip_gather": 3},
    "regimeB.sampled": {"gossip_gather": 3, "gossip_scatter": 3},
    "async.tick": {"gossip_gather": 1},
    "serve.cnn": {"head_gather_matmul": 3},
}
# profiler kernel names of each wrapper's launches
KERNEL_EVENTS = {"gossip_gather": ("gossip_gather",),
                 "gossip_scatter": ("gossip_scatter_kernel",),
                 "head_gather_matmul": ("head_warp_kernel",
                                        "head_tiled_kernel")}


def _analysis_launches(ctx, inst) -> dict:
    """The wrappers' launch counts over inst's N_ROUNDS rounds from a
    fresh state, counts set to 0 just before and read just after, and
    torch.profiler's kernel events of the same rounds (a window short of
    the wrappers' count is run again, at most 3 times: the card's
    profiler drops an event now and then)."""
    torch = ctx["torch"]
    from repro_torch.analysis.programs import N_ROUNDS
    from repro_torch.kernels import ops

    def rounds():
        carry = None
        for t in range(N_ROUNDS):
            out = inst.fn(*inst.args(t, carry))
            carry = inst.carry_of(out)

    for attempt in range(3):
        ops.reset_launch_counts()
        _, events, wall = profiled(torch, rounds)
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        seen = {k: sum(e.count for e in events
                       if any(n in e.key for n in names))
                for k, names in KERNEL_EVENTS.items()}
        seen = {k: v for k, v in seen.items() if v}
        if seen == counts:
            break
        PROFILER_MISSES.append(f"analysis {inst.name}: profiler {seen}, "
                               f"wrappers {counts} (window {attempt + 1})")
    return {"wrappers": counts, "profiler": seen, "wall_ms": wall,
            "windows": attempt + 1}


MEMORY_ROUNDS = 6      # rounds of each Regime B program read for memory


def _memory_rounds(torch, inst, rounds) -> list:
    """After each of `rounds` rounds from a fresh state: the allocator's
    allocated and requested bytes, its active blocks, and the blocks
    handed out larger than asked (more than the 512-byte rounding) as
    (block size, requested size)."""
    out, carry = [], None
    for t in range(rounds):
        res = inst.fn(*inst.args(t, carry))
        carry = inst.carry_of(res)
        del res
        torch.cuda.synchronize()
        blocks = [(b["size"], b["requested_size"])
                  for seg in torch.cuda.memory_snapshot()
                  for b in seg["blocks"] if b["state"] == "active_allocated"]
        out.append({"allocated": torch.cuda.memory_allocated(),
                    "requested": torch.cuda.memory_stats()[
                        "requested_bytes.all.current"],
                    "blocks": len(blocks),
                    "unsplit": sorted(b for b in blocks
                                      if b[0] - b[1] >= 512)})
    return out


def _chained_graph(torch, programs):
    """A round whose new state carries an autograd graph over every
    earlier state (U * w with w requiring grad): autograd, not Python,
    holds the old states, 3.4 MB more each round."""
    dev = torch.device("cuda")
    w = torch.ones((), device=dev, requires_grad=True)
    shape = (programs.SIM_M, 1 << 16)

    def fn(U, b):
        return U * w + b, torch.sum(U.detach())

    return programs.ProgramInstance(
        name="chained-graph", fn=fn,
        round_args=((torch.zeros(shape, device=dev),),) * programs.N_ROUNDS,
        fresh_state=lambda: torch.ones(shape, device=dev), donate=(0,),
        m=programs.SIM_M, device=dev)


def phase_analysis(ctx):
    """The program invariant analyzer on the card: every registered
    program clean (sync debug mode "error" in its steady-state rounds),
    every fixture tripping its own detector, each program's launches
    against ANALYSIS_LAUNCHES, the allocator's requested bytes flat over
    six rounds of each Regime B program, the donation check tripping on
    storage only autograd holds, and the CLI (a subprocess for --all; main
    in-process for the fixtures' exit code 1)."""
    torch = ctx["torch"]
    from repro_torch.analysis import __main__ as analysis_cli
    from repro_torch.analysis import detectors, fixtures, programs
    t0 = time.perf_counter()
    rows, srows, viols = detectors.run_all(device="cuda")
    check(not viols, f"analysis: violations on the card: {viols[:6]}")
    check({r["program"] for r in rows} == set(programs.PROGRAMS)
          and all(r["m"] == programs.SIM_M for r in rows),
          f"analysis rows {rows}")
    check(torch.cuda.get_sync_debug_mode() == 0,
          "the sync debug mode was left on")
    run_all_s = time.perf_counter() - t0
    trips = {}
    for name, (_, expected) in fixtures.FIXTURES.items():
        _, fv = fixtures.run_fixture(name, device="cuda")
        trips[name] = sorted({v.detector for v in fv})
        check(set(expected) <= set(trips[name]),
              f"fixture {name} tripped {trips[name]} on the card, want "
              f"{expected}: {fv}")
    hostsync = [v.message for v in fixtures.run_fixture(
        "hostsync", device="cuda")[1]]
    check(any("set_sync_debug_mode" in m for m in hostsync),
          f"the hostsync fixture did not trip the sync debug mode: "
          f"{hostsync}")
    # the fault the detector found in the shipped rounds, put back for one
    # check: the lr decay base made with torch.tensor every round
    from repro_torch.core.dfedpgp import DFedPGP
    fixed = DFedPGP._lr_scale

    def per_round(self, rnd):
        return torch.tensor(self.lr_decay, dtype=torch.float32,
                            device=rnd.device) ** rnd.to(torch.float32)

    DFedPGP._lr_scale = per_round
    try:
        before_fix = detectors.check_host_sync(
            programs.build_sim_resident(device="cuda"))
    finally:
        DFedPGP._lr_scale = fixed
    check(any("lift_fresh" in m for m in before_fix)
          and any("set_sync_debug_mode" in m for m in before_fix),
          f"the per-round lr upload was not found on the card: "
          f"{before_fix}")
    launches = {}
    for name, builder in programs.PROGRAMS.items():
        got = _analysis_launches(ctx, builder(device="cuda"))
        want = ANALYSIS_LAUNCHES[name]
        check(got["wrappers"] == want and got["profiler"] == want,
              f"analysis {name}: launches {got}, want {want}")
        launches[name] = got
    ctx["analysis_launches"] = {
        k: sum(got["wrappers"].get(k, 0) for got in launches.values())
        for k in KERNEL_EVENTS}
    memory = {name: _memory_rounds(torch, programs.PROGRAMS[name](
        device="cuda"), MEMORY_ROUNDS)
        for name in ("regimeB.resident", "regimeB.sampled")}
    for name, recs in memory.items():
        check(len({r["requested"] for r in recs[1:]}) == 1,
              f"analysis {name}: the allocator's requested bytes move "
              f"across rounds 1..{MEMORY_ROUNDS - 1}: {recs}")
    chained = detectors.check_donation(_chained_graph(torch, programs))
    check(any("requested bytes" in m for m in chained),
          f"the donation check missed a graph chained across rounds "
          f"(storage held by autograd, not Python): {chained}")
    exits = {}
    with contextlib.redirect_stdout(sys.stderr):
        for name in fixtures.FIXTURES:
            exits[name] = analysis_cli.main(["--fixture", name])
    check(all(rc == 1 for rc in exits.values()),
          f"--fixture exit codes {exits}, want 1 each")
    src = Path(__file__).resolve().parent / "src"
    t_cli = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "--all"], capture_output=True, text=True,
                         timeout=300, cwd=str(src.parent),
                         env={**os.environ, "PYTHONPATH": str(src)})
    cli_s = time.perf_counter() - t_cli
    check(cli.returncode == 0 and "all invariants hold" in cli.stdout,
          f"python -m repro_torch.analysis --all exited {cli.returncode}: "
          f"{cli.stdout[-1500:]} {cli.stderr[-1500:]}")
    emit("analysis", card=ctx["smi"], rows=rows, schedules=srows,
         violations_found=[], before_fix_sim_resident=before_fix,
         violations_repaired=[
             "core/dfedpgp.py _lr_scale: torch.tensor(lr_decay) made every "
             "round (aten.lift_fresh; a host-to-device copy on the card) "
             "-> torch.full on the device",
             "hetero/runtime.py _lr_scale: torch.tensor(round) per new "
             "lr-table row -> torch.full on the device"],
         fixtures=trips, fixture_exit_codes=exits, launches=launches,
         memory=memory, chained_graph=chained,
         launches_total=ctx["analysis_launches"],
         cli_all={"rc": cli.returncode, "seconds": cli_s,
                  "stdout_tail": cli.stdout[-400:]},
         run_all_s=run_all_s, seconds=time.perf_counter() - t0)


def phase_obs(ctx):
    """The observability spine at the paper's defaults (m 100, d_flat
    13,328, random topology with 10 neighbours): telemetry-on runs through
    run_experiment with a JSONL sink, each held bit for bit against the
    same run with telemetry off, cuDNN deterministic (two runs with its
    default algorithms are reported, not gated) (5 rounds with graph
    records every 2, 3
    sampled rounds at frac 0.25, 3 topk codec rounds with gamma "auto"
    under gossip="pallas", 2 async windows of tiered speeds and delays up
    to 2), with the same kernel launches; mass_total = m in every record;
    the port's report --check on the JSONL; a flight recorder tripped by
    mu scaled by 1.01; maybe_trace's file naming the gather kernel; the
    peak device memory; metered serving at B 1, 64, 1024; ms per round
    with telemetry off, on, and on with a sink, and per graph snapshot."""
    torch = ctx["torch"]
    import io
    import os
    import shutil
    import tempfile
    from repro_torch import obs
    from repro_torch.core import topology
    from repro_torch.data import make_dataset
    from repro_torch.fl.simulator import SimConfig, run_experiment
    from repro_torch.kernels import ops
    from repro_torch.obs import flight, gauges, graph, record, report
    from repro_torch.serve import ServeMeter, from_train_state, \
        make_cnn_server
    from repro_torch.spec import make_algo_spec
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    jsonl = os.path.join(tmp, "run.jsonl")
    sink = obs.JsonlSink(jsonl)
    runs = {
        "sync": (dict(rounds=5), dict(graph_every=2)),
        "sampled": (dict(rounds=3), dict(participation="uniform",
                                         participation_frac=0.25)),
        "codec": (dict(rounds=3), dict(codec="topk", codec_gamma="auto",
                                       gossip="pallas")),
        "async": (dict(rounds=2, runtime="async", hetero="tiered",
                       speed_spread=5.0, push_delay_max=2,
                       mailbox_depth=4), dict(graph_every=2)),
    }
    out, hists, path_counts = {}, {}, {}

    def leg(name, tel, snk=None):
        sim_kw, spec_kw = runs[name]
        kw = dict(spec_kw)
        if not tel:
            kw.pop("graph_every", None)
        sim = SimConfig(spec=make_algo_spec("dfedpgp", telemetry=tel, **kw),
                        **sim_kw)
        ops.reset_launch_counts()
        h = run_experiment("dfedpgp", sim, device="cuda",
                           eval_every=sim.rounds, return_state=True,
                           sink=snk)
        return h, ops.launch_counts()

    # run to run on the card: the telemetry-off sampled leg twice with
    # cuDNN's default algorithms, then twice deterministic (reported)
    probe = {"default_cudnn": _rerun_gap(torch, [leg("sampled", False)[0]
                                                 for _ in range(2)])}
    with _cudnn_deterministic(torch):
        probe["deterministic_cudnn"] = _rerun_gap(
            torch, [leg("sampled", False)[0] for _ in range(2)])
    print(f"# obs rerun probe: {probe}", file=sys.stderr, flush=True)
    out["rerun_max_abs"] = probe
    check(probe["deterministic_cudnn"] == 0.0,
          f"two deterministic telemetry-off runs differ: {probe}")
    for name in runs:
        with _cudnn_deterministic(torch):
            legs = {tel: leg(name, tel, sink if tel else None)
                    for tel in (False, True)}
        (h_off, c_off), (h_on, c_on) = legs[False], legs[True]
        leaves = _hold_bitwise(torch, h_on["state"], h_off["state"],
                               f"obs {name}: telemetry on vs off")
        check(c_on == c_off, f"obs {name}: launches on {c_on} vs off "
                             f"{c_off}")
        r = runs[name][0]["rounds"]
        want = {"sync": {"gossip_gather": r},
                "sampled": {"gossip_gather": r, "gossip_scatter": r},
                "codec": {"gossip_gather": r, "topk_gather": r}}.get(name)
        if want is not None:
            check(all(c_on[k] == want.get(k, 0) for k in c_on),
                  f"obs {name}: launches {c_on}, want {want}")
        else:
            check(c_on["gossip_gather"] > 0
                  and sum(c_on.values()) == c_on["gossip_gather"],
                  f"obs {name}: launches {c_on}")
        path_counts = _add_counts(path_counts, c_on)
        hists[name] = h_on
        out[name] = {"rounds": r, "leaves_bitwise": leaves,
                     "launches": c_on, "loss": h_on["loss"],
                     "acc": h_on["acc"],
                     "round_ms_on": [t * 1e3 for t in h_on["round_s"]],
                     "round_ms_off": [t * 1e3 for t in h_off["round_s"]]}
    sink.close()

    # the records: every ledger at m; the port's --check gate
    recs = list(record.load_jsonl(jsonl))
    m = SimConfig().m
    kinds = [rec["kind"] for rec in recs]
    check(kinds.count("round") == 5 + 3 + 3 and kinds.count("tick") == 2
          and kinds.count("graph") == 2 + 1, f"record kinds {kinds}")
    for rec in recs:
        check("mass_total" in rec and abs(rec["mass_total"] - m)
              <= 1e-5 * m, f"{rec['kind']} {rec['step']}: mass_total "
                           f"{rec.get('mass_total')}")
        check(rec["kind"] == "graph" or "consensus_gap_mean" in rec,
              f"{rec['kind']} {rec['step']}: no gauges")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = report.main([jsonl, "--check"])
    check(rc == 0, f"report --check exit {rc}")
    out["records"] = {"count": len(recs), "kinds": sorted(set(kinds)),
                      "bytes": os.path.getsize(jsonl),
                      "report_check": buf.getvalue().strip()
                      .splitlines()[-1],
                      "graph_contraction": [r["contraction"] for r in recs
                                            if r["kind"] == "graph"]}

    # the flight recorder: the sync run's records, then mu scaled by 1.01
    st = hists["sync"]["state"]
    fr = flight.FlightRecorder(obs.RingSink(64), dump_dir=tmp)
    sync_recs = [r for r in recs if r["kind"] == "round"][:5]
    for rec in sync_recs:
        fr.emit(rec)
    check(fr.alerts == [], f"healthy run tripped {fr.alerts}")
    fr.emit(obs.round_record(
        run=sync_recs[0]["run"], algo="dfedpgp", step=6, wire_bytes=0,
        **gauges.to_host(gauges.mass_ledger(st.mu * 1.01))))
    check([a["detector"] for a in fr.alerts] == ["mass-drift"],
          f"flight alerts {fr.alerts}")
    pm = flight.load_postmortem(fr.dumps[0])
    check(pm["alert"]["step"] == 6 and len(pm["records"]) == 6,
          f"post-mortem {pm['alert']}, {len(pm['records'])} records")
    out["flight"] = {"alert": fr.alerts[0]["reason"],
                     "postmortem_records": len(pm["records"])}

    # maybe_trace: one telemetry-on round; the trace names the gather
    # (an empty profiler window is retried, as `profiled` does)
    sim = SimConfig()
    algo, cfg = _paper_algo(sim, torch, telemetry=True)
    layout = hists["sync"]["layout"]
    data = make_dataset(sim.seed, sim.m, n_train=sim.n_train,
                        n_test=sim.n_test, device="cuda")
    sched = topology.get_schedule("random", sim.m, sim.n_neighbors,
                                  sim.seed)
    tables = [sched.at(r).to("cuda") for r in range(12)]
    batches = [_round_batches(sim, data, 700 + r, torch) for r in range(12)]
    trace_dir = os.path.join(tmp, "trace")
    named = False
    for attempt in range(1, 4):
        with obs.maybe_trace(trace_dir):
            algo.round_fn_flat(st, tables[0], batches[0], layout)
            torch.cuda.synchronize()
        newest = max(os.listdir(trace_dir))
        with open(os.path.join(trace_dir, newest)) as f:
            text = f.read()
        named = "gossip_gather" in text
        if named:
            break
    check(named, "maybe_trace: no gossip_gather kernel in the trace")
    out["trace"] = {"attempts": attempt, "bytes": len(text)}
    peak = gauges.peak_device_memory()
    check(isinstance(peak, int) and peak > 0, f"peak memory {peak}")
    out["peak_device_memory"] = peak

    # metered serving from the telemetry run's state
    ring = obs.RingSink(256)
    meter = ServeMeter(sink=ring, run="obs-serve")
    server = make_cnn_server(from_train_state(st, layout=layout), cfg,
                             device="cuda", meter=meter)
    g = torch.Generator(device="cuda").manual_seed(9)
    ops.reset_launch_counts()
    calls = 0
    for B in (1, 64, 1024):
        uid = torch.randint(0, sim.m, (B,), generator=g, device="cuda",
                            dtype=torch.int32)
        x = data.x_test[uid.long(), torch.arange(B, device="cuda")
                        % sim.n_test]
        for _ in range(5):
            logits = server(uid, x)
            calls += 1
        check(logits.shape == (B, sim.n_classes)
              and bool(torch.isfinite(logits).all()), f"serve B={B}")
    counts = ops.launch_counts()
    check(counts["head_gather_matmul"] == calls
          and sum(counts.values()) == calls, f"metered serve {counts}")
    path_counts = _add_counts(path_counts, counts)
    check([(r["path"], r["batch"]) for r in ring.records][::5]
          == [("fused", 1), ("fused", 64), ("fused", 1024)],
          "serve records")
    for rec in ring.records:
        record.validate(rec)
    out["serve"] = {"calls": calls, "launches": counts,
                    "stats": meter.stats()}

    # timings: host ms per round (each ending in a device sync) with
    # telemetry off, on, and on with a sink (the gauges fetched in one
    # sync, a JSONL record written), two passes of 12 rounds each, the
    # second in reverse order (the median of the last 10 of each pass,
    # the smaller pass kept); and per graph snapshot
    algo_off, _ = _paper_algo(sim, torch)
    tsink = obs.JsonlSink(os.path.join(tmp, "timing.jsonl"))
    variants = {"off": (algo_off, None), "on": (algo, None),
                "on_sink": (algo, tsink)}
    per_pass = {k: [] for k in variants}
    for order in (list(variants), list(variants)[::-1]):
        for key in order:
            (a, snk), s, ms = variants[key], _clone_flat_state(st), []
            for r in range(12):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s, mt = a.round_fn_flat(s, tables[r], batches[r], layout)
                if snk is not None:
                    snk.emit(obs.round_record(
                        run="timing", algo="dfedpgp", step=r + 1,
                        wire_bytes=0, **gauges.to_host(mt)))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            per_pass[key].append(statistics.median(ms[2:]))
    tsink.close()
    # where telemetry's time goes: 3 rounds of each under the profiler
    profile = {}
    for key in ("off", "on"):
        def run(a=variants[key][0]):
            s = st
            for r in range(3):
                s, _ = a.round_fn_flat(s, tables[r], batches[r], layout)

        _, events, wall_ms = profiled(torch, run, cpu=True)
        profile[key] = {
            "wall_ms_per_round": wall_ms / 3,
            "device_busy_ms_per_round": sum(map(_dev_us, events)) / 3e3,
            "device_events_per_round": sum(e.count for e in events) / 3}
    gring = obs.RingSink(16)
    snap_ms = []
    for r in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph.emit_graph_record(gring, run_id="timing", algo="dfedpgp",
                                m=sim.m, seed=sim.seed, schedule=sched,
                                step=r + 1, t0=r, flat=st.flat, mu=st.mu,
                                personal=st.personal)
        torch.cuda.synchronize()
        snap_ms.append((time.perf_counter() - t0) * 1e3)
    out["timings"] = {
        "card": ctx["smi"],
        "ms_per_round": {k: min(v) for k, v in per_pass.items()},
        "ms_per_round_passes": per_pass,
        "ms_per_graph_snapshot": statistics.median(snap_ms[1:]),
        "profile_3_rounds": profile,
        "note": "host perf_counter around one round_fn_flat at m 100 "
                "(and for on_sink the one-sync gauge fetch and a JSONL "
                "write), synchronized on both ends; the graph snapshot "
                "is emit_graph_record with its own host syncs"}
    shutil.rmtree(tmp)
    ctx["obs_launches"] = path_counts
    emit("obs", card=ctx["smi"], m=sim.m, n_neighbors=sim.n_neighbors,
         d_flat=layout.d_flat, launches=path_counts, **out,
         seconds=round(time.perf_counter() - t_phase, 3))


def phase_checkpoint(ctx):
    """Checkpoints at the paper's defaults (m 100, d_flat 13,328), each
    resumed run held bit for bit against the uninterrupted one (cuDNN
    deterministic): the resident state saved after round 3 of 5 and
    restored into a zeroed template on the card; the same with the topk
    codec's ef / ref (gossip="pallas", gamma "auto"); the async state with
    its profile after 7 ticks (tiered, delays up to 2), then 5 more ticks;
    serving from `from_checkpoint` bitwise `from_train_state`'s; a bf16
    leaf's bits; save and restore ms and file bytes."""
    with _cudnn_deterministic(ctx["torch"]):
        _checkpoint_cases(ctx)


def _checkpoint_cases(ctx):
    torch = ctx["torch"]
    import dataclasses
    import os
    import shutil
    import tempfile
    from repro_torch import checkpoint, compress
    from repro_torch.core import partition, topology
    from repro_torch.data import make_dataset, sample_batches
    from repro_torch.fl import simulator
    from repro_torch.fl.simulator import SimConfig
    from repro_torch.kernels import ops
    from repro_torch.models import cnn
    from repro_torch.serve import from_checkpoint, from_train_state, \
        make_cnn_server
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    sim = SimConfig()
    cfg = cnn.CNNConfig(image_size=sim.image_size, n_classes=sim.n_classes)
    data = make_dataset(31, sim.m, n_train=sim.n_train, n_test=sim.n_test,
                        device="cuda")
    init = cnn.init_params(torch.Generator().manual_seed(31), cfg, (sim.m,))
    sched = topology.get_schedule("random", sim.m, sim.n_neighbors, 31)
    tables = [sched.at(r).to("cuda") for r in range(5)]
    batches = [_round_batches(sim, data, 310 + r, torch) for r in range(5)]

    def timed_save(ckdir, step, state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = checkpoint.save_train_state(ckdir, step, state)
        save_ms = (time.perf_counter() - t0) * 1e3
        template = checkpoint.zeros_like(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored, got_step = checkpoint.restore_train_state(ckdir, template)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        check(got_step == step, f"restored step {got_step}")
        return restored, {"save_ms": save_ms, "restore_ms": restore_ms,
                          "bytes": os.path.getsize(path + ".npz")}

    out, path_counts, saved = {}, {}, {}
    cases = {"sync": {}, "codec": dict(
        codec=compress.get_codec("topk", seed=sim.seed), gossip="pallas",
        codec_gamma="auto")}
    for name, kw in cases.items():
        algo, _ = _paper_algo(sim, torch, **kw)
        s, layout = algo.init_flat(init, device="cuda")
        for r in range(3):
            s, _ = algo.round_fn_flat(s, tables[r], batches[r], layout)
        restored, io_stats = timed_save(os.path.join(tmp, name), 3, s)
        check(restored.flat.device.type == "cuda" and (restored.ef is None)
              == (name == "sync"), f"{name}: restored state")
        _hold_bitwise(torch, restored, s, f"checkpoint {name}: restore")
        saved[name] = (algo, layout, _clone_flat_state(s))
        ops.reset_launch_counts()
        for r in (3, 4):
            restored, _ = algo.round_fn_flat(restored, tables[r],
                                             batches[r], layout)
        counts = ops.launch_counts()
        for r in (3, 4):
            s, _ = algo.round_fn_flat(s, tables[r], batches[r], layout)
        leaves = _hold_bitwise(torch, restored, s,
                               f"checkpoint {name}: resumed vs "
                               f"uninterrupted")
        want = {"gossip_gather": 2} if name == "sync" else \
            {"gossip_gather": 2, "topk_gather": 2}
        check(all(counts[k] == want.get(k, 0) for k in counts),
              f"checkpoint {name}: launches {counts}")
        path_counts = _add_counts(path_counts, counts)
        out[name] = dict(io_stats, leaves_bitwise=leaves, launches=counts,
                         rounds="3 + 2 of 5")

    # the async state with its profile: 7 ticks, save, 5 more ticks
    asim = SimConfig(runtime="async", hetero="tiered", speed_spread=5.0,
                     push_delay_max=2, mailbox_depth=4)
    mask = partition.build_mask(init, partition.classifier_personal)
    rt, st, _ = simulator.build_async(
        "dfedpgp", asim, lambda p, b: cnn.loss_fn(p, b, cfg), mask, init,
        device="cuda")
    ticks = []
    for t in range(12):
        b = sample_batches(torch.Generator().manual_seed(900 + t), data, 1,
                           asim.batch)
        ticks.append((topology.to_push_sparse(sched.at(t)).to("cuda"),
                      {k: a[:, 0] for k, a in b.items()}))
    for P, b in ticks[:7]:
        st, _ = rt.tick(st, P, b)
    blob, io_stats = timed_save(os.path.join(tmp, "async"), 7,
                                {"state": st, "profile": rt.profile})
    _hold_bitwise(torch, blob["state"], st, "checkpoint async: restore")
    _hold_bitwise(torch, blob["profile"], rt.profile,
                  "checkpoint async: profile")
    check(blob["state"].clock.t == 7, f"clock {blob['state'].clock.t}")
    rt2 = dataclasses.replace(rt, profile=blob["profile"])
    restored = blob["state"]
    ops.reset_launch_counts()
    for P, b in ticks[7:]:
        restored, _ = rt2.tick(restored, P, b)
    counts = ops.launch_counts()
    ops.reset_launch_counts()
    for P, b in ticks[7:]:
        st, _ = rt.tick(st, P, b)
    check(counts == ops.launch_counts() and counts["gossip_gather"] > 0
          and sum(counts.values()) == counts["gossip_gather"],
          f"checkpoint async: launches {counts} vs {ops.launch_counts()}")
    leaves = _hold_bitwise(torch, restored, st,
                           "checkpoint async: resumed vs uninterrupted")
    path_counts = _add_counts(path_counts, counts)
    out["async"] = dict(io_stats, leaves_bitwise=leaves, launches=counts,
                        ticks="7 + 5")

    # serving from the checkpoint == from the state it holds
    algo, layout, s3 = saved["sync"]
    want_server = make_cnn_server(from_train_state(s3, layout=layout), cfg,
                                  device="cuda")
    sstate, step = from_checkpoint(os.path.join(tmp, "sync"),
                                   checkpoint.zeros_like(s3), layout=layout)
    check(step == 3, f"from_checkpoint step {step}")
    server = make_cnn_server(sstate, cfg, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    requests = []
    for B in (1, 64, 1024):
        uid = torch.randint(0, sim.m, (B,), generator=g, device="cuda",
                            dtype=torch.int32)
        x = data.x_test[uid.long(), torch.arange(B, device="cuda")
                        % sim.n_test]
        requests.append((uid, x, want_server(uid, x)))
    ops.reset_launch_counts()
    for uid, x, want in requests:
        got = server(uid, x)
        check(torch.equal(got, want), f"from_checkpoint serve B="
                                      f"{uid.shape[0]} differs by "
                                      f"{max_abs(got, want)}")
    counts = ops.launch_counts()
    check(counts["head_gather_matmul"] == len(requests)
          and sum(counts.values()) == len(requests),
          f"serve launches {counts} for {len(requests)} calls")
    path_counts = _add_counts(path_counts, counts)
    out["serve"] = {"batches": [1, 64, 1024], "check": "bitwise",
                    "launches": counts}

    # a bf16 leaf's bits, on the card
    bf = {"w": s3.flat.to(torch.bfloat16)}
    bpath = os.path.join(tmp, "bf16")
    checkpoint.save_pytree(bpath, bf)
    back = checkpoint.load_pytree(bpath, checkpoint.zeros_like(bf))
    check(back["w"].dtype == torch.bfloat16
          and back["w"].device.type == "cuda"
          and torch.equal(back["w"].view(torch.int16),
                          bf["w"].view(torch.int16)), "bf16 bits")
    out["bf16"] = {"shape": list(bf["w"].shape), "check": "bitwise"}
    shutil.rmtree(tmp)
    ctx["checkpoint_launches"] = path_counts
    emit("checkpoint", card=ctx["smi"], m=sim.m, d_flat=layout.d_flat,
         launches=path_counts, **out,
         seconds=round(time.perf_counter() - t_phase, 3))


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


# the device symbols of each LM kernel: the f32 SIMT flash kernel and the
# bf16 wgmma one (the model's prefill runs the latter)
LM_KERNEL_SYMBOLS = {
    "flash_attention": ("flash_attention_kernel",
                        "flash_attention_wgmma_kernel"),
    "rglru": ("rglru_kernel",)}


def _lm_profile(torch, fn, calls: int = 1, expect=None, cpu: bool = True):
    """`calls` calls of fn under torch.profiler: wall and device ms per
    call, the device's busy share, the device ms of each of the two LM
    kernels and their share of the device time, and the ten kernels that
    take the most.  `expect`, the launch counts of one call
    (`ops.launch_counts()`), checks the window: one whose LM kernel events
    fall short of them lost events and is run again, at most
    PROFILE_ATTEMPTS times; `profile_verified` says whether a window kept
    them all (other kernels' events cannot be checked so).  cpu=False
    traces the device alone (a window of ~10^5 launches)."""
    def run():
        for _ in range(calls):
            fn()

    want = {n: calls * (expect or {}).get(n, 0) for n in LM_KERNEL_SYMBOLS}
    for _ in range(PROFILE_ATTEMPTS):
        _, events, wall = profiled(torch, run, cpu=cpu)
        hits = {name: [e for e in events if any(k in e.key for k in keys)]
                for name, keys in LM_KERNEL_SYMBOLS.items()}
        seen = {n: sum(e.count for e in h) for n, h in hits.items()}
        lost = {n: (seen[n], want[n]) for n in want if seen[n] < want[n]}
        if not lost:
            break
        PROFILER_MISSES.append(f"{getattr(fn, '__qualname__', '?')}: LM "
                               f"kernel events (seen, launched) {lost}")
    wall /= calls
    total = sum(_dev_us(e) for e in events) / 1e3 / calls
    by = {n: sum(_dev_us(e) for e in h) / 1e3 / calls
          for n, h in hits.items()}
    names = {n: sorted({e.key[:120] for e in h}) for n, h in hits.items()}
    top = sorted(events, key=_dev_us, reverse=True)[:10]
    return {"calls": calls, "wall_ms": wall, "device_ms": total,
            "device_busy_share": total / wall,
            "device_events_per_call": sum(e.count for e in events) / calls,
            "kernel_ms": by, "kernel_names": names,
            "kernel_events": seen,
            "profile_verified": expect is not None and not lost,
            "events_lost": lost,
            "kernel_share": {n: v / total for n, v in by.items()},
            "top_device_kernels": [{"name": e.key[:90],
                                    "ms": _dev_us(e) / 1e3 / calls,
                                    "calls": e.count / calls}
                                   for e in top]}


def phase_lm(ctx):
    """The hybrid LM's serve path: recurrentgemma-9b at its published
    widths and all 38 layers, f32 parameters drawn on the card, bf16
    compute.  prefill_logits at B 2, S 4096 from lm_synthetic_batch,
    then greedy decode_step from init_cache for 16 steps at B 4; then
    reduced() in f32 and bf16 on the card (kernels) against the CPU
    (plain)."""
    torch = ctx["torch"]
    from repro_torch import configs, models, tree
    from repro_torch.data import lm_synthetic_batch
    from repro_torch.kernels import ops
    from repro_torch.models import hybrid
    cfg = configs.get_config("recurrentgemma-9b")
    P, tail = hybrid._layout(cfg)
    n_lru = 2 * P + tail
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = hybrid.init_params(torch.Generator(device="cuda").manual_seed(0),
                                cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree.leaves(params))
    check(n_params == LM_PARAMS, f"{n_params} parameters, the reference "
                                 f"initializes {LM_PARAMS}")
    pb, ps = 2, 4096                 # prefill batch and length
    batch = lm_synthetic_batch(torch.Generator(device="cuda").manual_seed(1),
                               cfg.vocab, pb, ps)

    def prefill():
        return models.prefill_logits(params, batch, cfg)

    with torch.inference_mode():
        ops.reset_launch_counts()
        logits = prefill()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        check(counts["flash_attention"] == P and counts["rglru"] == n_lru
              and sum(counts.values()) == P + n_lru,
              f"one prefill launched {counts}; want {P} flash_attention "
              f"and {n_lru} rglru")
        check(logits.shape == (pb, 1, cfg.vocab) and logits.dtype
              == torch.bfloat16 and bool(torch.isfinite(logits).all()),
              "prefill logits")
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            prefill()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        share = _lm_profile(torch, prefill, expect=counts)
        check(share["kernel_ms"]["flash_attention"] > 0 and any(
            "flash_attention_wgmma_kernel" in n
            for n in share["kernel_names"]["flash_attention"]),
            f"the prefill profile names no bf16 flash kernel: "
            f"{share['kernel_names']}")
        prefill_peak = torch.cuda.max_memory_allocated()

        B, steps = 4, 16
        tok = lm_synthetic_batch(torch.Generator(device="cuda").manual_seed(2),
                                 cfg.vocab, B, 1)["tokens"]
        cache = hybrid.init_cache(cfg, B, cfg.local_window, device="cuda")
        ops.reset_launch_counts()
        step_ms, generated = [], []
        for pos in range(steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out, cache = hybrid.decode_step(params, cache, tok, pos, cfg)
            tok = out.argmax(-1)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            check(out.shape == (B, 1, cfg.vocab) and bool(
                torch.isfinite(out).all()), f"decode step {pos} logits")
            generated.append(tok[:, 0].tolist())
        decode_counts = ops.launch_counts()
        state = {"cache": cache, "tok": tok, "pos": steps}

        def one_step():
            out, state["cache"] = hybrid.decode_step(
                params, state["cache"], state["tok"], state["pos"], cfg)
            state["tok"] = out.argmax(-1)
            state["pos"] += 1

        decode_profile = _lm_profile(torch, one_step, calls=3,
                                     expect=decode_counts)
    peak = torch.cuda.max_memory_allocated()
    del params, batch, cache, logits, out, state
    torch.cuda.empty_cache()
    ctx["lm_launches"] = counts
    ctx["lm_prefill_ms"] = statistics.median(ms)
    emit("lm", arch=cfg.arch_id, layers=cfg.n_layers, periods=P,
         tail_lru=tail, params=n_params, param_dtype=cfg.param_dtype,
         compute_dtype=cfg.compute_dtype, init_s=init_s,
         prefill={"batch": pb, "seq": ps, "launches": counts,
                  "ms": ms, "ms_median": statistics.median(ms),
                  "peak_bytes": prefill_peak, **share},
         decode={"batch": B, "steps": steps, "cache_len": cfg.local_window,
                 "step_ms": step_ms,
                 "ms_per_token_median_after_first":
                     statistics.median(step_ms[1:]),
                 "launches": decode_counts, "tokens": generated,
                 "profile": decode_profile},
         max_memory_allocated=peak,
         parity=_lm_parity(ctx))


def _lm_parity(ctx):
    """reduced() (5 layers, d 128, 4 heads on 1 KV head, hd 32, window
    16) from one init, the card (flash_attention and rglru kernels, cuBLAS
    with TF32 off) against the CPU (their plain versions): full logits and
    prefill logits at B 2, S 64, then 24 teacher-forced decode steps into
    the 16-slot ring, logits every step and every cache leaf at the end.
    Twice: in f32 (the SIMT flash route), where sum orders differ
    (kernels, cuBLAS, CPU BLAS) through 5 layers: rtol/atol 1e-4; and in
    bf16 compute, whose attention takes flash_attention_wgmma_kernel (the
    profiler must name it), held to the bf16 bounds of the port against
    the reference (tests/test_torch_hybrid.py): max |diff| <= 0.25 and a
    relative L2 error <= 6% per compared tensor."""
    return {"float32": _lm_parity_run(ctx, "float32"),
            "bfloat16": _lm_parity_run(ctx, "bfloat16")}


def _lm_parity_run(ctx, cdtype: str):
    torch = ctx["torch"]
    from repro_torch import configs, models, tree
    from repro_torch.data import lm_synthetic_batch
    from repro_torch.kernels import ops
    from repro_torch.models import hybrid
    cfg = configs.get_reduced("recurrentgemma-9b").replace(
        compute_dtype=cdtype)
    bf16 = cdtype == "bfloat16"
    tol = {"max_abs": 0.25, "rel_l2": 0.06} if bf16 else 1e-4
    P, tail = hybrid._layout(cfg)
    cpu = hybrid.init_params(torch.Generator().manual_seed(5), cfg,
                             device="cpu")
    gpu = tree.tree_map(lambda t: t.cuda(), cpu)
    batch = lm_synthetic_batch(torch.Generator().manual_seed(6), cfg.vocab,
                               2, 64)
    gbatch = {k: t.cuda() for k, t in batch.items()}
    errs, rels = {}, {}

    def cmp(name, a, b):
        a = a.cpu()
        err = max_abs(a, b)
        errs[name] = max(errs.get(name, 0.0), err)
        ok = a.dtype == b.dtype and a.shape == b.shape
        if bf16:
            x, y = a.float(), b.float()
            rel = float((x - y).norm() / y.norm().clamp_min(1e-30))
            rels[name] = max(rels.get(name, 0.0), rel)
            ok = ok and err <= tol["max_abs"] and rel <= tol["rel_l2"]
        else:
            ok = ok and torch.allclose(a, b, rtol=tol, atol=tol)
        check(ok, f"lm parity {cdtype} {name}: err {err} rel "
                  f"{rels.get(name)}")

    with torch.inference_mode():
        ops.reset_launch_counts()
        full = hybrid.forward_train(gpu, gbatch["tokens"], cfg)
        counts = ops.launch_counts()
        check(counts["flash_attention"] == P and counts["rglru"] ==
              2 * P + tail, f"reduced forward launched {counts}")
        names = []
        if bf16:
            _, events, _ = profiled(torch, lambda: hybrid.forward_train(
                gpu, gbatch["tokens"], cfg))
            names = sorted({e.key[:120] for e in events
                            if "flash_attention" in e.key})
            check(any("flash_attention_wgmma_kernel" in n for n in names),
                  f"reduced bf16 forward ran no wgmma flash kernel: {names}")
        cmp("logits", full, hybrid.forward_train(cpu, batch["tokens"], cfg))
        cmp("prefill_logits", models.prefill_logits(gpu, gbatch, cfg),
            models.prefill_logits(cpu, batch, cfg))
        cg = hybrid.init_cache(cfg, 2, 64, device="cuda")
        cc = hybrid.init_cache(cfg, 2, 64, device="cpu")
        ring = cc["p_k"].shape[2]
        for pos in range(24):
            lg, cg = hybrid.decode_step(gpu, cg, gbatch["tokens"][:, pos:pos + 1],
                                        pos, cfg)
            lc, cc = hybrid.decode_step(cpu, cc, batch["tokens"][:, pos:pos + 1],
                                        pos, cfg)
            cmp("decode_logits", lg, lc)
        for name in cc:
            cmp(f"cache/{name}", cg[name], cc[name])
    out = {"config": "reduced", "compute_dtype": cdtype, "seq": 64,
           "window": cfg.local_window, "ring_slots": ring,
           "decode_steps": 24, "launches": counts, "tolerance": tol,
           "max_abs_err": errs}
    if bf16:
        out.update(rel_l2_err=rels, flash_kernels=names)
    return out


# the dense family (models/dense.py) at full width: leaves of the
# reference's init (jax.eval_shape of repro.models.dense.init_params, which
# draws lm_head whatever tie_embeddings says), and each config's prefill
# (batch, length), cut from prefill_32k (B 32, S 32,768) to one card beside
# its weights: qwen2-0.5b by batch only, h2o-danube-1.8b to S 8,192 (twice
# its window 4,096, so the band case runs), granite-3-2b and codeqwen1.5-7b
# to B 2, S 4,096
DENSE_ARCHS = ("qwen2-0.5b", "h2o-danube-1.8b", "granite-3-2b",
               "codeqwen1.5-7b")
DENSE_LEAVES = {"qwen2-0.5b": 630_167_424, "h2o-danube-1.8b": 1_831_201_280,
                "granite-3-2b": 2_634_201_088,
                "codeqwen1.5-7b": 8_190_038_016}
DENSE_PREFILL = {"qwen2-0.5b": (1, 32_768), "h2o-danube-1.8b": (1, 8_192),
                 "granite-3-2b": (2, 4_096), "codeqwen1.5-7b": (2, 4_096)}
# the largest f32 score matrix (B H S S) flash_attention_ref is given on
# the card; a longer prefill is held against flash_plain_chunked
FLASH_REF_SCORE_BYTES = 16e9


def band_pairs(S: int, window: int) -> int:
    """(query, key) pairs of the causal band, keys j <= i and, with a
    window, j > i - window."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def _flash_bound(ctx, B, S, H, Hkv, hd, window, dtype_bytes=2):
    """The attention's least time on the card: 4 hd flops per (query, key)
    pair of the band at the bf16 tensor-core peak, against q, k and v read
    once and the output written once."""
    flops = 4 * hd * band_pairs(S, window) * B * H
    nbytes = dtype_bytes * (2 * B * S * H * hd + 2 * B * S * Hkv * hd)
    t_ops = flops / ctx["peak_bf16"] * 1e3
    t_bytes = nbytes / ctx["peak_bw"] * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes}


def _dense_full(ctx, arch: str) -> dict:
    """One dense config at full width: f32 parameters drawn on the card,
    bf16 compute; prefill_logits (exactly n_layers flash_attention
    launches, the wgmma kernel named, median of 3 after a warm-up), 16
    greedy decode steps at B 4 from a 4,096-token cache (and 16 more with
    the int8 cache for qwen2-0.5b), peak memory."""
    torch = ctx["torch"]
    from repro_torch import configs, models, tree
    from repro_torch.data import lm_synthetic_batch
    from repro_torch.kernels import ops
    from repro_torch.models import dense
    cfg = configs.get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = dense.init_params(torch.Generator(device="cuda").manual_seed(0),
                               cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree.leaves(params))
    check(n_params == DENSE_LEAVES[arch],
          f"{arch}: {n_params} parameters, the reference initializes "
          f"{DENSE_LEAVES[arch]}")
    pb, ps = DENSE_PREFILL[arch]
    batch = lm_synthetic_batch(torch.Generator(device="cuda").manual_seed(1),
                               cfg.vocab, pb, ps)

    def prefill():
        return models.prefill_logits(params, batch, cfg)

    out = {"layers": cfg.n_layers, "params": n_params, "init_s": init_s,
           "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.hd],
           "window": cfg.window}
    with torch.inference_mode():
        ops.reset_launch_counts()
        logits = prefill()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        check(counts["flash_attention"] == cfg.n_layers
              and sum(counts.values()) == cfg.n_layers,
              f"{arch}: one prefill launched {counts}; want "
              f"{cfg.n_layers} flash_attention and nothing else")
        check(logits.shape == (pb, 1, cfg.vocab) and logits.dtype
              == torch.bfloat16 and bool(torch.isfinite(logits).all()),
              f"{arch}: prefill logits")
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            prefill()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        prof = _lm_profile(torch, prefill, expect=counts)
        check(any("flash_attention_wgmma_kernel" in n
                  for n in prof["kernel_names"]["flash_attention"]),
              f"{arch}: the prefill profile names no bf16 flash kernel: "
              f"{prof['kernel_names']}")
        kernel_ms = prof["kernel_ms"]["flash_attention"] / cfg.n_layers
        bound = _flash_bound(ctx, pb, ps, cfg.n_heads, cfg.n_kv_heads,
                             cfg.hd, cfg.window)
        out["prefill"] = {
            "batch": pb, "seq": ps, "launches": counts, "ms": ms,
            "ms_median": statistics.median(ms),
            "device_busy_share": prof["device_busy_share"],
            "profile_verified": prof["profile_verified"],
            "events_lost": prof["events_lost"],
            "flash_ms_per_layer": kernel_ms,
            "flash_share": prof["kernel_share"]["flash_attention"],
            "flash_bound_ms_per_layer": bound["bound_ms"],
            "flash_bound_by": bound["bound_by"],
            "flash_tflop_per_layer": bound["flops"] / 1e12,
            "flash_bound_share": bound["bound_ms"] / kernel_ms,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "top_device_kernels": prof["top_device_kernels"][:6]}
        del logits

        for quant in ((False, True) if arch == "qwen2-0.5b" else (False,)):
            c = cfg.replace(kv_quant=quant)
            B, steps = 4, 16
            tok = lm_synthetic_batch(
                torch.Generator(device="cuda").manual_seed(2), c.vocab, B,
                1)["tokens"]
            cache = dense.init_cache(c, B, 4096, device="cuda")
            ops.reset_launch_counts()
            step_ms, generated = [], []
            for pos in range(steps):
                torch.cuda.synchronize()
                t = time.perf_counter()
                lg, cache = dense.decode_step(params, cache, tok, pos, c)
                tok = lg.argmax(-1)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t) * 1e3)
                check(lg.shape == (B, 1, c.vocab) and bool(
                    torch.isfinite(lg).all()),
                    f"{arch}: decode step {pos} logits (kv_quant {quant})")
                generated.append(tok[:, 0].tolist())
            dcounts = ops.launch_counts()
            check(sum(dcounts.values()) == 0,
                  f"{arch}: decode launched {dcounts}")
            out["decode_int8_kv" if quant else "decode"] = {
                "batch": B, "steps": steps, "cache_len": 4096,
                "cache_bytes": sum(t.numel() * t.element_size()
                                   for t in cache.values()),
                "step_ms": step_ms,
                "ms_per_token_median_after_first":
                    statistics.median(step_ms[1:]),
                "tokens": generated[-1]}
            del cache
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    del params, batch
    torch.cuda.empty_cache()
    return out


def flash_plain_chunked(torch, q, k, v, window: int = 0,
                        rows: int = 2048):
    """flash_attention_ref's math (f32 scores scaled by 1 / sqrt(hd),
    masked logits -1e30, softmax, P V, output in q's dtype), one kv head
    and one block of `rows` query positions at a time against the keys
    its band reaches (a key left out is one the mask zeroes): the plain
    version at a length whose full score matrix does not fit the card."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    g = H // Hkv
    scale = 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    pos = torch.arange(S, device=q.device)
    neg = torch.full((), -1e30, device=q.device)
    for h in range(Hkv):
        heads = slice(h * g, (h + 1) * g)
        kf, vf = k[:, :, h].float(), v[:, :, h].float()
        for i0 in range(0, S, rows):
            i1 = min(i0 + rows, S)
            k0 = max(0, i0 - window + 1) if window else 0
            qf = q[:, i0:i1, heads].float()
            s = torch.einsum("bqgd,bkd->bgqk", qf, kf[:, k0:i1]) * scale
            qp, kp = pos[i0:i1, None], pos[None, k0:i1]
            mask = kp <= qp
            if window:
                mask &= kp > qp - window
            p = torch.softmax(torch.where(mask, s, neg), dim=-1)
            out[:, i0:i1, heads] = torch.einsum(
                "bgqk,bkd->bqgd", p, vf[:, k0:i1]).to(q.dtype)
    return out


def _dense_flash_timing(ctx, arch: str, prefill=None) -> dict:
    """The attention kernel at one config's prefill (DENSE_PREFILL's B
    and S, or `prefill`'s, the config's heads and window, bf16, random
    inputs): held
    against the plain version (flash_attention_ref where its f32 score
    matrix fits in FLASH_REF_SCORE_BYTES, else flash_plain_chunked, which
    is itself held against flash_attention_ref where both run) at the
    tolerances of _flash_cases, then device ms of the kernel, the plain
    version and scaled_dot_product_attention (is_causal, or a boolean
    band mask with a window; timed only, never called by the port), the
    call's ms and the bound."""
    torch = ctx["torch"]
    from repro_torch import configs
    from repro_torch.kernels import ops
    cfg = configs.get_config(arch)
    B, S = prefill or DENSE_PREFILL[arch]
    win = cfg.window
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = torch.Generator(device="cuda").manual_seed(41)
    q, k, v = (torch.randn((B, S, h, hd), generator=g,
                           device="cuda").bfloat16() for h in (H, Hkv, Hkv))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if win and win < S:
        pos = torch.arange(S, device="cuda")
        band = (pos[None, :] <= pos[:, None]) & (
            pos[None, :] > pos[:, None] - win)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=band, enable_gqa=True).transpose(1, 2)
    else:
        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2)

    def kern():
        return ops.flash_attention(q, k, v, window=win, force="cuda")

    def chunked():
        return flash_plain_chunked(torch, q, k, v, window=win)

    full_fits = B * H * S * S * 4 <= FLASH_REF_SCORE_BYTES
    if full_fits:
        def plain():
            return ops.flash_attention(q, k, v, window=win, force="ref")
    else:
        plain = chunked
    got, want = kern(), plain()
    torch.cuda.synchronize()
    tol = 8e-3
    err = max_abs(got, want)
    share = float(((got.float() - want.float()).abs() / (
        tol + tol * want.float().abs())).max())
    rel = block_rel_l2(torch, got, want)
    check(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
          and rel <= FLASH_REL_L2_BF16,
          f"{arch}: flash_attention at its prefill {(B, S, H, Hkv, hd)} "
          f"window {win}: err {err} block rel L2 {rel}")
    out = {"shape": [B, S, H, Hkv, hd], "window": win, "dtype": "bfloat16",
           "plain": "flash_attention_ref" if full_fits
           else "flash_plain_chunked",
           "rtol_atol": tol, "max_abs_err": err, "share_of_tol": share,
           "block_rel_l2": rel, "block_rel_l2_bound": FLASH_REL_L2_BF16}
    if full_fits:
        c = chunked()
        out["chunked_vs_ref_max_abs"] = max_abs(c, want)
        check(torch.allclose(c.float(), want.float(), rtol=tol, atol=tol),
              f"{arch}: flash_plain_chunked disagrees with "
              f"flash_attention_ref by {out['chunked_vs_ref_max_abs']}")
        del c
    del got, want
    check(torch.allclose(sdpa().float(), kern().float(), rtol=2e-2,
                         atol=2e-2),
          f"{arch}: scaled_dot_product_attention yardstick disagrees")
    out.update({"ms": device_ms(torch, kern, iters=10),
                "plain_ms": device_ms(torch, plain, iters=3),
                "library_ms": device_ms(torch, sdpa, iters=10),
                "call_ms": time_ms(torch, kern, iters=5, reps=3),
                **_flash_bound(ctx, B, S, H, Hkv, hd, win)})
    out["bound_share"] = out["bound_ms"] / out["ms"]
    return out


def _dense_personal(ctx) -> dict:
    """The personalized mixed-user decode (serve/decode.py) at qwen2-0.5b's
    full width: m 4 users through DFedPGP.init_flat and from_train_state,
    B 8 requests mixing them (uid = arange(8) % 4), 16 greedy tokens from
    a 64-token cache: one head_gather_matmul launch per step, each step's
    logits against force="ref" on the card (rtol = atol = 1e-5; the
    kernel's f32 sum against the plain einsum's), equal greedy tokens.
    Then the head kernel at this shape: ms, plain and torch.baddbmm over
    the gathered W, and the byte bound with each distinct user's slab
    read once (and with each request's, as the kernel reads them)."""
    torch = ctx["torch"]
    from repro_torch import configs
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.head_gather import plan as head_plan
    from repro_torch.models import dense
    from repro_torch.serve import decode, from_train_state
    cfg = configs.get_config("qwen2-0.5b")
    m, B, T = 4, 8, 16
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, layout = decode.build_fleet(cfg, m, device="cuda")
    sstate = from_train_state(state, layout=layout, consensus=0)
    d_flat = state.flat.shape[1]
    del state
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    uid = (torch.arange(B, device="cuda") % m).to(torch.int32)
    cache = dense.init_cache(cfg, B, decode.CACHE_LEN, device="cuda")
    toks = torch.zeros((B, 1), dtype=torch.int64, device="cuda")
    step_ms, errs, seqs = [], [], []
    with torch.inference_mode():
        ops.reset_launch_counts()
        for t in range(T):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits, new = decode.serve_step(sstate, uid, cache, toks, t, cfg)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            counts = ops.launch_counts()
            want, _ = decode.serve_step(sstate, uid, cache, toks, t, cfg,
                                        force="ref")
            err = max_abs(logits, want)
            errs.append(err)
            check(logits.shape == (B, cfg.vocab) and logits.dtype
                  == torch.float32 and bool(torch.isfinite(logits).all())
                  and torch.allclose(logits, want, rtol=1e-5, atol=1e-5),
                  f"personalized decode step {t}: err {err} against the "
                  f"plain head")
            toks = logits.argmax(-1, keepdim=True)
            check(torch.equal(toks, want.argmax(-1, keepdim=True)),
                  f"personalized decode step {t}: greedy tokens differ")
            seqs.append(toks[:, 0].tolist())
            cache = new
        check(counts["head_gather_matmul"] == T and sum(counts.values())
              == T, f"{T} personalized steps launched {counts}")

        W = sstate.personal["lm_head"]
        bias = torch.zeros((m, cfg.vocab), device="cuda")
        H = torch.randn((B, cfg.d_model), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(
                            9)).bfloat16()
        ul = uid.long()

        def head():
            return ops.head_gather_matmul(uid, H, W, bias, force="cuda")

        def head_lib():
            return torch.baddbmm(bias[ul].unsqueeze(1),
                                 H.float().unsqueeze(1), W[ul])

        check(torch.allclose(head_lib().squeeze(1), head(), rtol=1e-5,
                             atol=1e-5), "baddbmm yardstick disagrees")
        d, n = cfg.d_model, cfg.vocab
        users = int(torch.unique(uid).numel())
        nbytes = B * d * 2 + users * (d * n + n) * 4 + B * 4 + B * n * 4
        per_req = B * d * 2 + B * (d * n + n) * 4 + B * 4 + B * n * 4
        t_ops = (2 * B * d * n + B * n) / ctx["peak_f32"] * 1e3
        hk = {"shape": [B, d, n, m], "dtype": "H bfloat16, W float32",
              "ms": device_ms(torch, head, iters=10),
              "plain_ms": device_ms(torch, lambda: ops.head_gather_matmul(
                  uid, H, W, bias, force="ref"), iters=3),
              "library_ms": device_ms(torch, head_lib, iters=3),
              "call_ms": time_ms(torch, head, iters=10, reps=3),
              "bound_ms": max(nbytes / ctx["peak_bw"] * 1e3, t_ops),
              "bound_by": "bytes" if nbytes / ctx["peak_bw"] * 1e3 >= t_ops
              else "operations",
              "bytes": nbytes, "distinct_users": users,
              "bound_per_request_slab_ms": per_req / ctx["peak_bw"] * 1e3,
              "plan": head_plan(B, d, n, 4,
                                _build.sm_count("cuda"))._asdict()}
        hk["bound_share"] = hk["bound_ms"] / hk["ms"]
    out = {"arch": cfg.arch_id, "users": m, "batch": B, "tokens": T,
           "cache_len": decode.CACHE_LEN, "d_flat": d_flat,
           "setup_s": setup_s,
           "launches": counts, "step_ms": step_ms,
           "ms_per_token_median_after_first": statistics.median(step_ms[1:]),
           "max_abs_err_vs_plain_head": max(errs), "rtol_atol": 1e-5,
           "greedy_tokens_equal": True, "last_tokens": seqs[-1],
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "head_gather_matmul": hk}
    del sstate, cache, W, H
    torch.cuda.empty_cache()
    return out


def _dense_parity_run(ctx, arch: str, cdtype: str, kv_quant: bool = False):
    """reduced() of one dense config from one init, the card (the flash
    kernel, cuBLAS with TF32 off) against the CPU (the plain versions):
    full logits and prefill logits at B 2, S 64, then 24 teacher-forced
    decode steps (danube's window 16 wraps its ring), logits every step and
    every cache leaf at the end.  f32: rtol/atol 1e-4; bf16 (the wgmma
    route, named by the profiler): max |diff| <= 0.25 and relative L2 <=
    6% per tensor.  kv_quant (f32): an int8 value may differ by 1 where the
    two sides' x / s fall on either side of a rounding tie (counted); the
    logits are held to 1e-4 until the first such flip and to 5e-3 after
    it (a flipped value moves its key by one step of its scale)."""
    torch = ctx["torch"]
    from repro_torch import configs, models, tree
    from repro_torch.data import lm_synthetic_batch
    from repro_torch.kernels import ops
    from repro_torch.models import dense
    cfg = configs.get_reduced(arch).replace(compute_dtype=cdtype,
                                            kv_quant=kv_quant)
    bf16 = cdtype == "bfloat16"
    tol = {"max_abs": 0.25, "rel_l2": 0.06} if bf16 else 1e-4
    cpu = dense.init_params(torch.Generator().manual_seed(5), cfg,
                            device="cpu")
    gpu = tree.tree_map(lambda t: t.cuda(), cpu)
    batch = lm_synthetic_batch(torch.Generator().manual_seed(6), cfg.vocab,
                               2, 64)
    gbatch = {k: t.cuda() for k, t in batch.items()}
    errs, rels = {}, {}
    flips = {"count": 0, "first_step": None}

    def cmp(name, a, b, t=None):
        a = a.cpu()
        err = max_abs(a, b)
        errs[name] = max(errs.get(name, 0.0), err)
        ok = a.dtype == b.dtype and a.shape == b.shape
        if bf16:
            x, y = a.float(), b.float()
            rel = float((x - y).norm() / y.norm().clamp_min(1e-30))
            rels[name] = max(rels.get(name, 0.0), rel)
            ok = ok and err <= tol["max_abs"] and rel <= tol["rel_l2"]
        else:
            t = tol if t is None else t
            ok = ok and torch.allclose(a, b, rtol=t, atol=t)
        check(ok, f"dense parity {arch} {cdtype} kv_quant {kv_quant} "
                  f"{name}: err {err} rel {rels.get(name)}")

    with torch.inference_mode():
        ops.reset_launch_counts()
        full = dense.forward_train(gpu, gbatch["tokens"], cfg)
        counts = ops.launch_counts()
        check(counts["flash_attention"] == cfg.n_layers
              and sum(counts.values()) == cfg.n_layers,
              f"reduced {arch} forward launched {counts}")
        names = []
        if bf16:
            _, events, _ = profiled(torch, lambda: dense.forward_train(
                gpu, gbatch["tokens"], cfg))
            names = sorted({e.key[:120] for e in events
                            if "flash_attention" in e.key})
            check(any("flash_attention_wgmma_kernel" in n for n in names),
                  f"reduced {arch} bf16 forward ran no wgmma flash kernel: "
                  f"{names}")
        cmp("logits", full, dense.forward_train(cpu, batch["tokens"], cfg))
        cmp("prefill_logits", models.prefill_logits(gpu, gbatch, cfg),
            models.prefill_logits(cpu, batch, cfg))
        cg = dense.init_cache(cfg, 2, 64, device="cuda")
        cc = dense.init_cache(cfg, 2, 64, device="cpu")
        for pos in range(24):
            lg, cg = dense.decode_step(gpu, cg, gbatch["tokens"][:, pos:pos + 1],
                                       pos, cfg)
            lc, cc = dense.decode_step(cpu, cc, batch["tokens"][:, pos:pos + 1],
                                       pos, cfg)
            if kv_quant:
                for name in ("k", "v"):
                    diff = (cg[name].cpu().int() - cc[name].int()).abs()
                    check(int(diff.max()) <= 1, f"{arch} int8 {name} step "
                                                f"{pos} differs by > 1")
                n_now = int((cg["k"].cpu() != cc["k"]).sum()
                            + (cg["v"].cpu() != cc["v"]).sum())
                if n_now and flips["first_step"] is None:
                    flips["first_step"] = pos
                flips["count"] = max(flips["count"], n_now)
            cmp("decode_logits", lg, lc,
                5e-3 if flips["count"] else None)
        for name in cc:
            if cc[name].dtype == torch.int8:
                continue
            cmp(f"cache/{name}", cg[name], cc[name])
    out = {"config": "reduced", "compute_dtype": cdtype, "seq": 64,
           "window": cfg.window, "ring_slots": cc["k"].shape[2],
           "decode_steps": 24, "launches": counts, "tolerance": tol,
           "max_abs_err": errs}
    if bf16:
        out.update(rel_l2_err=rels, flash_kernels=names)
    if kv_quant:
        out.update(int8_values_off_by_one=flips["count"],
                   int8_values=2 * cc["k"].numel(),
                   first_flip_step=flips["first_step"])
    return out


def phase_dense(ctx):
    """The dense LM family: each of the four configs at full width
    (`_dense_full`), the attention kernel at their prefill shapes, held
    against the plain version and timed (`_dense_flash_timing`), the
    personalized mixed-user decode of
    qwen2-0.5b (`_dense_personal`), reduced() card against CPU in f32 and
    bf16 and qwen2-0.5b's int8 KV decode (`_dense_parity_run`), and
    `python -m repro_torch.serve.decode` on the card."""
    torch = ctx["torch"]
    full, flash = {}, {}
    for arch in DENSE_ARCHS:
        full[arch] = _dense_full(ctx, arch)
        flash[arch] = _dense_flash_timing(ctx, arch)
    personal = _dense_personal(ctx)
    parity = {arch: {dt: _dense_parity_run(ctx, arch, dt)
                     for dt in ("float32", "bfloat16")}
              for arch in DENSE_ARCHS}
    parity["qwen2-0.5b"]["kv_quant_float32"] = _dense_parity_run(
        ctx, "qwen2-0.5b", "float32", kv_quant=True)
    src = Path(__file__).resolve().parent / "src"
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "repro_torch.serve.decode"],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(src.parent),
                         env={**os.environ, "PYTHONPATH": str(src)})
    cli_s = time.perf_counter() - t0
    check(run.returncode == 0 and "restored step 42" in run.stdout,
          f"python -m repro_torch.serve.decode exited {run.returncode}: "
          f"{run.stderr[-2000:]}")
    ctx["dense_launches"] = {
        "flash_attention": sum(f["prefill"]["launches"]["flash_attention"]
                               for f in full.values()),
        "head_gather_matmul": personal["launches"]["head_gather_matmul"]}
    ctx["dense_flash"] = flash
    ctx["dense_head"] = personal["head_gather_matmul"]
    emit("dense", card=ctx["smi"], full_width=full, flash_by_config=flash,
         personalized=personal, parity=parity,
         serve_decode_cli={"rc": run.returncode, "seconds": cli_s,
                           "stdout_tail": run.stdout[-600:]},
         launches=ctx["dense_launches"])


# ---------------------------------------------------------------------------
# Regime B (launch/): qwen2-0.5b at full width, m 4 clients
# ---------------------------------------------------------------------------
REGIME_B_ARGS = ["--arch", "qwen2-0.5b", "--clients", "4", "--batch", "2",
                 "--seq", "128", "--neighbors", "2", "--device", "cuda"]
# the shared row: qwen2-0.5b's 630,167,424 leaves less lm_head (896 x
# 151,936) and final_norm (896), which stay personal
REGIME_B_D = 494_031_872
REGIME_B_PREFILL = (1, 4096)       # (B, S) per client of the prefill step
REGIME_B_TOL = dict(rtol=1e-4, atol=2e-5)


def _train_main(ctx, argv) -> dict:
    """`python -m repro_torch.launch.train` in this process, with a JSONL
    sink: its launch counts (set to 0 just before, read just after), its
    round records, `report --check` on them, its printed lines, the state
    it returns and the peak device memory."""
    torch = ctx["torch"]
    import io
    import tempfile
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.obs import record, report
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trainB.jsonl")
        out = io.StringIO()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            state = train.main(argv + ["--metrics", path])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = ops.launch_counts()
        recs = list(record.load_jsonl(path))
        with contextlib.redirect_stdout(io.StringIO()):
            report_rc = report.main([path, "--check"])
    return {"launches": counts, "records": recs, "state": state,
            "seconds": seconds, "report_check_rc": report_rc,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "stdout_tail": out.getvalue()[-600:]}


def _round_summary(run: dict, rounds: int, m: int = 4) -> dict:
    """Finite losses, sum(mu) = m to rtol 1e-6, ms per round (each round
    ends in a device sync: the records' `round_s`)."""
    recs = [r for r in run["records"] if r["kind"] == "round"]
    check(len(recs) == rounds, f"{len(recs)} round records, want {rounds}")
    losses = [[r["loss"], r["loss_v"]] for r in recs]
    check(all(x is not None and math.isfinite(x) for pair in losses
              for x in pair), f"losses {losses}")
    mu_sum = float(run["state"].mu.sum())
    check(abs(mu_sum - m) <= 1e-6 * m, f"sum mu = {mu_sum}")
    ms = [r["round_s"] * 1e3 for r in recs]
    return {"rounds": rounds, "launches": run["launches"], "loss": losses,
            "round_ms": ms, "ms_per_round_after_first":
                statistics.median(ms[1:]) if rounds > 1 else ms[0],
            "mu_sum": mu_sum, "wire_bytes": recs[-1]["wire_bytes"],
            "peak_bytes": run["peak_bytes"], "seconds": run["seconds"],
            "stdout_tail": run["stdout_tail"]}


def _trainer(argv):
    from repro_torch.launch import train
    ap = train.build_parser()
    return train.Trainer(ap.parse_args(argv), ap)


def _only(counts: dict, **want) -> bool:
    return all(counts[k] == want.get(k, 0) for k in counts)


def _round_profile(ctx, run, r: int, cpu: bool = True) -> dict:
    """torch.profiler over round r of a Trainer: wall and device ms, the
    device's busy share, the gossip_gather kernel's device ms and the
    kernels that take the most.  cpu=False traces the device alone."""
    torch = ctx["torch"]
    _, events, wall = profiled(torch, lambda: run.step(r), cpu=cpu)
    total = sum(_dev_us(e) for e in events) / 1e3
    gather = sum(_dev_us(e) for e in events
                 if "gossip_gather" in e.key) / 1e3
    top = sorted(events, key=_dev_us, reverse=True)[:10]
    return {"wall_ms": wall, "device_ms": total,
            "device_busy_share": total / wall, "gossip_gather_ms": gather,
            "device_events": sum(e.count for e in events),
            "top_device_kernels": [{"name": e.key[:90],
                                    "ms": _dev_us(e) / 1e3,
                                    "calls": e.count} for e in top]}


def _regime_b_sampled(ctx) -> dict:
    """3 sampled rounds (2 of 4 clients) at full width through the
    Trainer `main` drives: one gossip_scatter launch a round writing the
    buffer and the momentum back, the dormant rows bit for bit, sum(mu) =
    4, ms per round (each ending in a device sync)."""
    torch = ctx["torch"]
    from repro_torch import tree
    from repro_torch.core import gossip
    from repro_torch.kernels import ops
    torch.cuda.empty_cache()
    run = _trainer(REGIME_B_ARGS + ["--resident", "--sample", "0.5"])
    st = run.state
    ops.reset_launch_counts()
    want_gather, ms, losses, dormant_ids = 0, [], [], []
    for r in range(3):
        P, active = run.topology(r)
        want_gather += not gossip.no_sparsity(P)
        dormant = torch.ones(run.m, dtype=torch.bool)
        dormant[torch.as_tensor(active).long()] = False
        dormant = dormant.cuda()
        st = run.state
        before = [st.flat[dormant], st.opt_u.momentum[dormant], st.mu[dormant]]
        before += [leaf[dormant] for _, leaf in tree.paths(st.personal)]
        before += [leaf[dormant] for _, leaf in tree.paths(st.opt_v.momentum)]
        ptr = st.flat.data_ptr()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics, _, _ = run.step(r)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        st = run.state
        after = [st.flat[dormant], st.opt_u.momentum[dormant], st.mu[dormant]]
        after += [leaf[dormant] for _, leaf in tree.paths(st.personal)]
        after += [leaf[dormant] for _, leaf in tree.paths(st.opt_v.momentum)]
        check(st.flat.data_ptr() == ptr, "the sampled round did not write "
                                         "the resident buffer in place")
        check(all(torch.equal(a, b) for a, b in zip(before, after)),
              f"round {r}: dormant rows moved")
        del before, after
        losses.append([float(metrics["loss_u"]), float(metrics["loss_v"])])
        dormant_ids.append(torch.nonzero(dormant).flatten().tolist())
    counts = ops.launch_counts()
    check(_only(counts, gossip_scatter=3, gossip_gather=want_gather),
          f"3 sampled rounds launched {counts}; want 3 gossip_scatter and "
          f"{want_gather} gossip_gather")
    check(all(math.isfinite(x) for p in losses for x in p), f"{losses}")
    mu_sum = float(run.state.mu.sum())
    check(abs(mu_sum - run.m) <= 1e-6 * run.m, f"sum mu = {mu_sum}")
    out = {"rounds": 3, "n_active": run.n_lead, "launches": counts,
           "dormant_clients": dormant_ids, "dormant_rows_bitwise": True,
           "loss": losses, "round_ms": ms, "mu_sum": mu_sum,
           "gather_note": "the induced table of 2 rows has k 3 >= 2: the "
                          "mix densifies (as the reference's), no gather"
                          if want_gather == 0 else ""}
    del run, st
    torch.cuda.empty_cache()
    return out


def _wide_times(torch, kernel, plain, library, bound_ms: float) -> dict:
    """Times of a kernel that moves gigabytes a call, its plain version
    and its library call, by CUDA events around back-to-back calls (at
    milliseconds a call the host's share is hidden); cold: each call
    after a 256 MB copy, events around the call alone.  The profiler's
    device time is kept beside them: in one run on the card it read
    both wide kernels a third under their byte bound, which no kernel
    can do, so it had lost events."""
    src = torch.empty(FLUSH_BYTES // 4, device="cuda")
    dst = torch.empty_like(src)
    cold = []
    for _ in range(5):
        dst.copy_(src)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        kernel()
        end.record()
        end.synchronize()
        cold.append(start.elapsed_time(end))
    prof = device_ms(torch, kernel, iters=10)
    return {"ms": time_ms(torch, kernel, iters=5, reps=5),
            "cold_ms": statistics.median(cold),
            "plain_ms": time_ms(torch, plain, iters=2, reps=3),
            "library_ms": time_ms(torch, library, iters=5, reps=5),
            "timer": "CUDA events", "profiler_ms": prof,
            "profiler_below_bound": prof < bound_ms,
            "bound_ms": bound_ms, "bound_by": "bytes"}


def _wide_gather(ctx, d: int, g) -> dict:
    """gossip_gather at (4, 3, d) on a random table (2 neighbors + self)
    and U drawn from the CUDA generator g,
    bitwise against its plain version on the card, timed warm and cold
    (`_wide_times`) beside its byte bound, the plain gather and
    torch.sparse.mm over the table in CSR."""
    torch = ctx["torch"]
    from repro_torch.core import topology
    from repro_torch.kernels import ops
    bw = ctx["peak_bw"]
    m = 4
    torch.cuda.empty_cache()
    P = topology.get_schedule("random", m, 2, 0).at(0).to("cuda")
    k = P.idx.shape[1]
    U = torch.randn((m, d), generator=g, device="cuda")
    ops.reset_launch_counts()
    got = ops.gossip_gather(P.idx, P.w, U, force="cuda")
    want = ops.gossip_gather(P.idx, P.w, U, force="ref")
    check(torch.equal(got, want), f"gossip_gather at (4, {k}, {d}): "
                                  f"err {max_abs(got, want)}")
    check(_only(ops.launch_counts(), gossip_gather=1), "gather launches")
    del got, want
    rows = torch.arange(m, device="cuda")[:, None].expand(m, k)
    csr = torch.sparse_coo_tensor(
        torch.stack([rows.reshape(-1), P.idx.long().reshape(-1)]),
        P.w.reshape(-1), (m, m), check_invariants=True
    ).coalesce().to_sparse_csr()

    def gather():
        return ops.gossip_gather(P.idx, P.w, U, force="cuda")

    def gather_lib():
        return torch.sparse.mm(csr, U)

    pl = _gather_plan(m, k, d, U)
    bytes_g = 2 * m * d * 4 + m * k * 8
    out = {"gossip_gather": dict(
        _wide_times(torch, gather, lambda: ops.gossip_gather(
            P.idx, P.w, U, force="ref"), gather_lib, bytes_g / bw * 1e3),
        shape=[m, k, d], check="bitwise == ref",
        library="torch.sparse.mm (CSR)", bytes=bytes_g, plan=pl._asdict())}
    return out


def _regime_b_kernels(ctx) -> dict:
    """gossip_gather at (4, 3, d 494,031,872) (`_wide_gather`) and
    gossip_scatter_many with 2 rows and 2 f32 pairs at that width, each
    bitwise against its plain version on the card, timed warm and cold
    (`_wide_times`) beside its byte bound and its library call
    (index_copy_ per buffer for the scatter)."""
    torch = ctx["torch"]
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.gossip_scatter import plan as scatter_plan
    bw = ctx["peak_bw"]
    m, d = 4, REGIME_B_D
    g = torch.Generator(device="cuda").manual_seed(23)
    out = _wide_gather(ctx, d, g)
    torch.cuda.empty_cache()
    n, pairs = 2, 2
    rows_s = torch.tensor([0, 2], dtype=torch.int32, device="cuda")
    Xs = [torch.randn((n, d), generator=g, device="cuda")
          for _ in range(pairs)]
    Us = [torch.randn((m, d), generator=g, device="cuda")
          for _ in range(pairs)]
    wants = [u.clone() for u in Us]
    ops.reset_launch_counts()
    ops.gossip_scatter_many(rows_s, Xs, Us, force="cuda")
    ops.gossip_scatter_many(rows_s, Xs, wants, force="ref")
    check(all(torch.equal(a, b) for a, b in zip(Us, wants)),
          f"gossip_scatter_many at (4, 2, {d}) x2 disagrees")
    check(_only(ops.launch_counts(), gossip_scatter=1), "scatter launches")
    del wants
    rl = rows_s.long()

    def scatter():
        return ops.gossip_scatter_many(rows_s, Xs, Us, force="cuda")

    def scatter_lib():
        for X, V in zip(Xs, Us):
            V.index_copy_(0, rl, X)

    bytes_s = pairs * 2 * n * d * 4 + n * 4
    out["gossip_scatter"] = dict(
        _wide_times(torch, scatter, lambda: ops.gossip_scatter_many(
            rows_s, Xs, Us, force="ref"), scatter_lib, bytes_s / bw * 1e3),
        shape=[m, n, d], pairs=pairs, check="bitwise == ref",
        library="index_copy_ per buffer (2 calls)", bytes=bytes_s,
        plan=scatter_plan(n, d, _build.sm_count("cuda"), pairs)._asdict())
    del Xs, Us
    torch.cuda.empty_cache()
    return out


def _to_card(torch, obj):
    """A copy of tensors, dicts and NamedTuples of them on the card."""
    if isinstance(obj, torch.Tensor):
        return obj.to("cuda", copy=True)
    if isinstance(obj, dict):
        return {k: _to_card(torch, v) for k, v in obj.items()}
    if hasattr(obj, "_fields"):
        return type(obj)(*(_to_card(torch, v) for v in obj))
    return obj


def _rounds_card_vs_cpu(ctx, argv, rounds: int, tol_of) -> dict:
    """`rounds` Trainer rounds on the card and on the CPU from one init
    (the CPU run's), one set of batches (the CPU run's) and the schedule's
    tables; every state leaf held at `tol_of(name, cpu_leaf)` -> (rtol,
    atol), mu exact."""
    torch = ctx["torch"]
    cpu = _trainer(argv + ["--device", "cpu"])
    gpu = _trainer(argv + ["--device", "cuda"])
    gpu.state = _to_card(torch, cpu.state)
    for r in range(rounds):
        b = cpu.batches(r)
        cpu.step(r, b)
        gpu.step(r, _to_card(torch, b))
    want, got = (dict(_state_leaves(run.state)) for run in (cpu, gpu))
    check(set(want) == set(got), f"leaves {set(want) ^ set(got)}")
    errs = {}
    for key in want:
        a, b = got[key].cpu(), want[key]
        errs[key] = max_abs(a, b)
        rtol, atol = tol_of(key, b)
        check(torch.allclose(a.double(), b.double(), rtol=rtol, atol=atol),
              f"{argv[:2]} rounds card vs CPU {key}: err {errs[key]}")
    check(torch.equal(got["mu"].cpu(), want["mu"]), f"{argv[:2]}: mu")
    return {"rounds": rounds, "max_abs_err": max(errs.values()),
            "worst_leaf": max(errs, key=errs.get), "mu_exact": True}


def _regime_b_parity(ctx) -> dict:
    """reduced() qwen2-0.5b, f32: 3 resident rounds and 2 sampled rounds
    on the card and on the CPU from one init (the CPU run's), one set of
    batches (the CPU run's) and the schedule's tables; every state leaf at
    rtol 1e-4, atol 2e-5 (the port-vs-reference tolerance of
    tests/test_torch_regime_b.py), mu exact."""
    base = ["--arch", "qwen2-0.5b", "--reduced", "--clients", "4",
            "--batch", "2", "--seq", "32", "--neighbors", "2"]
    out = {}
    for name, extra, rounds in (("resident", ["--resident"], 3),
                                ("sampled", ["--resident", "--sample",
                                             "0.5"], 2)):
        out[name] = dict(_rounds_card_vs_cpu(
            ctx, base + extra, rounds,
            lambda key, leaf: (REGIME_B_TOL["rtol"], REGIME_B_TOL["atol"])),
            **REGIME_B_TOL)
    return out


def _regime_b_prefill(ctx) -> dict:
    """One build_prefill_step call at full width: m 4, B 1, S 4,096, the
    clients looped (the ctypes flash launch cannot run under vmap): 24
    flash_attention launches per client, finite logits."""
    torch = ctx["torch"]
    from repro_torch import configs
    from repro_torch.configs import InputShape
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh, steps, train
    cfg = configs.get_config("qwen2-0.5b")
    m, (B, S) = 4, REGIME_B_PREFILL
    torch.cuda.empty_cache()
    layout = mesh.one_device_layout(m, B)
    shape = InputShape("prefill", S, m * B, "prefill")
    fn, ins, outs, args = steps.build_prefill_step(cfg, None, layout, shape)
    params = train.init_stacked(cfg, m, torch.device("cuda"))
    tokens = torch.randint(0, cfg.vocab, tuple(args[1]["tokens"].shape),
                           generator=torch.Generator(device="cuda")
                           .manual_seed(4), device="cuda")
    with torch.inference_mode():
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = fn(params, {"tokens": tokens})
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = ops.launch_counts()
    check(_only(counts, flash_attention=m * cfg.n_layers),
          f"prefill step launched {counts}; want {m * cfg.n_layers} "
          f"flash_attention")
    check(logits.shape == (m, B, 1, cfg.vocab)
          and bool(torch.isfinite(logits).all()), "prefill step logits")
    del params, logits
    torch.cuda.empty_cache()
    return {"clients": m, "batch": B, "seq": S, "launches": counts,
            "ms_first_call": ms, "logits_shape": [m, B, 1, cfg.vocab]}


def phase_regime_b(ctx):
    """Regime B on the card: qwen2-0.5b at full width (24 layers, d 896,
    vocab 151,936) with m 4 clients through `python -m
    repro_torch.launch.train`'s main: 3 resident rounds (3 gossip_gather),
    3 sampled rounds of 2 clients (3 gossip_scatter, dormant rows bit for
    bit), 2 tree-form rounds (2 gossip_gather), 2 telemetry rounds whose
    JSONL passes report --check; a profiled resident round; both kernels
    at d 494,031,872 against their plain versions; reduced() card vs
    CPU; one full-width prefill step."""
    torch = ctx["torch"]
    resident = _train_main(ctx, REGIME_B_ARGS + ["--rounds", "3",
                                                 "--resident"])
    check(_only(resident["launches"], gossip_gather=3),
          f"3 resident rounds launched {resident['launches']}")
    st = resident["state"]
    check(tuple(st.flat.shape) == (4, REGIME_B_D),
          f"resident buffer {tuple(st.flat.shape)}")
    full = {"resident": _round_summary(resident, 3)}
    del resident, st
    prof_run = _trainer(REGIME_B_ARGS + ["--resident"])
    prof_run.step(0)
    torch.cuda.synchronize()
    full["resident"]["profile"] = _round_profile(ctx, prof_run, 1)
    del prof_run
    full["sampled"] = _regime_b_sampled(ctx)
    tree_run = _train_main(ctx, REGIME_B_ARGS + ["--rounds", "2"])
    check(_only(tree_run["launches"], gossip_gather=2),
          f"2 tree-form rounds launched {tree_run['launches']}")
    full["tree"] = _round_summary(tree_run, 2)
    del tree_run
    tele = _train_main(ctx, REGIME_B_ARGS + ["--rounds", "2", "--resident",
                                             "--telemetry"])
    check(tele["report_check_rc"] == 0,
          f"report --check exited {tele['report_check_rc']}")
    check(_only(tele["launches"], gossip_gather=2),
          f"2 telemetry rounds launched {tele['launches']}")
    check(all(abs(r["mass_total"] - 4) <= 1e-5 * 4
              for r in tele["records"]), "mass_total != 4")
    full["telemetry"] = dict(_round_summary(tele, 2),
                             report_check_rc=tele["report_check_rc"])
    del tele
    torch.cuda.empty_cache()
    kernels = _regime_b_kernels(ctx)
    parity = _regime_b_parity(ctx)
    prefill = _regime_b_prefill(ctx)
    ctx["regime_b_launches"] = {
        "gossip_gather": sum(full[k]["launches"]["gossip_gather"]
                             for k in ("resident", "sampled", "tree",
                                       "telemetry")),
        "gossip_scatter": full["sampled"]["launches"]["gossip_scatter"],
        "flash_attention": prefill["launches"]["flash_attention"]}
    ctx["regime_b_kernels"] = kernels
    emit("regime_b", card=ctx["smi"], arch="qwen2-0.5b", clients=4,
         batch=2, seq=128, d_flat=REGIME_B_D, full_width=full,
         kernels=kernels, parity=parity, prefill_step=prefill,
         launches=ctx["regime_b_launches"])


# ---------------------------------------------------------------------------
# the moe and vlm families (models/moe.py, models/vlm.py)
# ---------------------------------------------------------------------------
# leaves of the reference's full-width init (jax.eval_shape of
# repro.models.moe.init_params / repro.models.vlm.init_params)
FAMILY_LEAVES = {"deepseek-moe-16b": 16_377_694_208,
                 "qwen2-vl-7b": 7_615_616_512,
                 "xlstm-125m": 198_985_040,
                 "whisper-large-v3": 1_601_607_680}
# each full-width prefill's (B, S), cut from prefill_32k (B 32, S 32,768)
# to one card beside its weights: S 8,192, for deepseek-moe-16b two
# moe_seq_chunk chunks of 4,096 (the chunk loop runs), for qwen2-vl-7b its
# 1,024 vision embeddings and 7,168 text tokens; for whisper-large-v3
# 8,192 decoder tokens beside the stub's 1,500 frame embeddings.
# xlstm-125m: S 4,096 (16 mLSTM chunks of 256, 4,096 sLSTM steps a layer),
# cut for the script's time, not the card's memory: its sLSTM loop is
# host-bound (~0.23 ms a step on an H100 host), and at S 8,192 the phase
# took 122 s there
FAMILY_PREFILL = {"deepseek-moe-16b": (1, 8_192), "qwen2-vl-7b": (1, 8_192),
                  "xlstm-125m": (1, 4_096), "whisper-large-v3": (1, 8_192)}
# flash_attention launches of one full-width prefill: one per GQA layer;
# none for xLSTM (no attention), Whisper's 32 decoder layers only (its
# encoder and cross-attention take the plain attention)
FAMILY_FLASH = {"deepseek-moe-16b": 28, "qwen2-vl-7b": 28, "xlstm-125m": 0,
                "whisper-large-v3": 32}
# decode cut from decode_32k (B 128, a 32,768 cache): (B, cache, steps)
FAMILY_DECODE = (4, 4_096, 16)
MOE_ARCHS = ("deepseek-moe-16b", "deepseek-v2-236b")
# the repo's LM bf16 bound (tests/test_torch_dense.py): max |diff| and
# relative L2 per tensor
LM_BF16 = {"max_abs": 0.25, "rel_l2": 0.06}
def _family_batch(torch, cfg, B: int, S: int, generator) -> dict:
    """A prefill batch of S positions on the generator's device: Markov
    tokens (lm_synthetic_batch); for the vlm family the first
    n_vision_tokens positions are stub vision embeddings drawn from the
    same generator and the tokens fill the rest; for the encdec family the
    S tokens are the decoder's, beside the stub frame embeddings drawn
    after them."""
    from repro_torch.data import lm_synthetic_batch
    nv = cfg.n_vision_tokens if cfg.family == "vlm" else 0
    batch = lm_synthetic_batch(generator, cfg.vocab, B, S - nv)
    if nv:
        batch["vision"] = torch.randn((B, nv, cfg.d_model),
                                      generator=generator,
                                      device=generator.device)
    if cfg.family == "encdec":
        batch["frames"] = _frames(torch, cfg, B, generator)
    return batch


def _frames(torch, cfg, B: int, generator):
    """The encdec family's stub frame embeddings (B, n_frames, d_model)
    f32 on the generator's device."""
    return torch.randn((B, cfg.n_frames, cfg.d_model), generator=generator,
                       device=generator.device)


def route_flips(a: list, b: list) -> list:
    """For each dispatch, the tokens whose set of experts differs between
    two runs' (T, K) routes."""
    return [int((x.sort(-1).values.cpu() != y.sort(-1).values.cpu())
                .any(-1).sum()) for x, y in zip(a, b)]


def _bf16_gap(torch, a, b) -> tuple:
    x, y = a.float().cpu(), b.float().cpu()
    return (float((x - y).abs().max()),
            float((x - y).norm() / y.norm().clamp_min(1e-30)))


def _family_forward(cfg, params, batch, route="kernel", routes=None,
                    given=None, last_only=True):
    """The forward on a named attention route, by default at the last
    position only (the prefill's); the moe forward also hands back its
    routes (`routes`) or takes another run's (`given`)."""
    from repro_torch.models import encdec, moe, ssm, vlm
    if cfg.family == "moe":
        return moe.forward_train(params, batch["tokens"], cfg,
                                 last_only=last_only, route=route,
                                 routes=routes, given=given)[0]
    if cfg.family == "ssm":
        return ssm.forward_train(params, batch["tokens"], cfg,
                                 last_only=last_only, route=route)
    mod = encdec if cfg.family == "encdec" else vlm
    return mod.forward_train(params, batch, cfg, last_only=last_only,
                             route=route)


def _family_full(ctx, arch: str) -> dict:
    """One config at full width: f32 parameters drawn on the card, bf16
    compute.  prefill_logits at FAMILY_PREFILL (exactly FAMILY_FLASH
    flash_attention launches and nothing else, the wgmma kernel named where
    there are any, median of 3 after the first), its rerun bitwise, the
    kernel route against the plain route for the whole prefill (the LM
    bf16 bound on the logits; the moe routes that flip counted, by
    dispatch: top-k routing is discontinuous, so bf16 noise flips
    near-ties and a flip moves the residual stream of every later layer),
    16 greedy decode steps at B 4 from a 4,096 cache (no launch; the
    encdec family's encoder run once before them by `prefill_cross`),
    peak memory.  The ssm family's prefill is ~180,000 host launches (the
    sLSTM loop): its profile is a short window, the device alone; its
    prefill is split by layer kind on the host clock (`_prefill_split`),
    the encdec one into encoder and decoder, and one decode step of each
    is profiled."""
    torch = ctx["torch"]
    from repro_torch import configs, models, tree
    from repro_torch.data import lm_synthetic_batch
    from repro_torch.kernels import ops
    cfg = configs.get_config(arch)
    api = models.get_model(cfg)
    n_flash = FAMILY_FLASH[arch]
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(torch.Generator(device="cuda").manual_seed(0),
                             cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree.leaves(params))
    check(n_params == FAMILY_LEAVES[arch],
          f"{arch}: {n_params} parameters, the reference initializes "
          f"{FAMILY_LEAVES[arch]}")
    pb, ps = FAMILY_PREFILL[arch]
    batch = _family_batch(torch, cfg, pb, ps,
                          torch.Generator(device="cuda").manual_seed(1))

    def prefill():
        return models.prefill_logits(params, batch, cfg)

    out = {"layers": cfg.n_layers, "params": n_params, "init_s": init_s,
           "held_before_bytes": held,
           "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.hd]}
    with torch.inference_mode():
        ops.reset_launch_counts()
        logits = prefill()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        check(counts["flash_attention"] == n_flash
              and sum(counts.values()) == n_flash,
              f"{arch}: one prefill launched {counts}; want "
              f"{n_flash} flash_attention and nothing else")
        check(logits.shape == (pb, 1, cfg.vocab) and logits.dtype
              == torch.bfloat16 and bool(torch.isfinite(logits).all()),
              f"{arch}: prefill logits")
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            again = prefill()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            check(torch.equal(again, logits),
                  f"{arch}: a rerun of the prefill differs by "
                  f"{max_abs(again, logits)}")
        pre = {"batch": pb, "seq": ps, "launches": counts, "ms": ms,
               "ms_median": statistics.median(ms), "rerun_bitwise": True}
        if cfg.family == "ssm":
            # a prefill is ~180,000 launches, which the profiler took ~50 s
            # to parse on an H100 host: profile a short steady window, the
            # first SSM_PROFILE_SEQ tokens (the sLSTM loop's steps are
            # alike), the device alone; busy share = profiled device time
            # over that prefill's unprofiled wall time
            short = {"tokens": batch["tokens"][:, :SSM_PROFILE_SEQ]}

            def short_prefill():
                return models.prefill_logits(params, short, cfg)

            short_prefill()
            torch.cuda.synchronize()
            t = time.perf_counter()
            short_prefill()
            torch.cuda.synchronize()
            short_ms = (time.perf_counter() - t) * 1e3
            prof = _lm_profile(torch, short_prefill, expect=counts,
                               cpu=False)
            pre["short_window"] = {
                "seq": SSM_PROFILE_SEQ, "ms": short_ms,
                "device_ms": prof["device_ms"],
                "device_events": prof["device_events_per_call"],
                "profiled_wall_ms": prof["wall_ms"],
                "device_busy_share": prof["device_ms"] / short_ms,
                "top_device_kernels": prof["top_device_kernels"][:6]}
        else:
            prof = _lm_profile(torch, prefill, expect=counts)
            check(any("flash_attention_wgmma_kernel" in n
                      for n in prof["kernel_names"]["flash_attention"]),
                  f"{arch}: the prefill profile names no bf16 flash "
                  f"kernel: {prof['kernel_names']}")
            kernel_ms = prof["kernel_ms"]["flash_attention"] / n_flash
            bound = _flash_bound(ctx, pb, ps, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.hd, cfg.window)
            pre.update({
                "device_busy_share": prof["device_busy_share"],
                "profile_verified": prof["profile_verified"],
                "events_lost": prof["events_lost"],
                "flash_ms_per_layer": kernel_ms,
                "flash_share": prof["kernel_share"]["flash_attention"],
                "flash_bound_ms_per_layer": bound["bound_ms"],
                "flash_bound_share": bound["bound_ms"] / kernel_ms,
                "top_device_kernels": prof["top_device_kernels"][:6]})
        if cfg.family in ("ssm", "encdec"):
            pre["split_ms"] = _prefill_split(torch, cfg, params, batch)
        rk, rp = [], []
        kern = _family_forward(cfg, params, batch, "kernel", rk)
        check(torch.equal(kern, logits), f"{arch}: the forward's kernel "
                                         f"route is not the prefill")
        plain = _family_forward(cfg, params, batch, "plain", rp)
        err, rel = _bf16_gap(torch, kern, plain)
        flips = route_flips(rk, rp)
        n_routes = sum(r.shape[0] for r in rk)
        dropped = []
        if rk:
            from repro_torch.models import moe
            C = moe._capacity(rk[0].shape[0], cfg)
            dropped = [int((torch.bincount(r.reshape(-1), minlength=
                                           cfg.n_experts) - C).clamp(
                min=0).sum()) for r in rk]
            # the dispatch whose routes drop the most pairs, for the
            # dispatch's timing
            ctx["moe_prefill_routes"] = rk[max(range(len(rk)),
                                               key=dropped.__getitem__)]
        check(err <= LM_BF16["max_abs"] and rel <= LM_BF16["rel_l2"],
              f"{arch}: kernel route vs plain route: err {err} rel {rel} "
              f"({sum(flips)} route flips of {n_routes})")
        check(n_flash or torch.equal(kern, plain),
              f"{arch}: no kernel on the path, yet the routes differ")
        del kern, plain, again
        pre.update({
            "kernel_vs_plain_route": {
                "max_abs_err": err, "rel_l2_err": rel, **LM_BF16,
                "route_flips": sum(flips), "routes": n_routes,
                "route_flips_by_dispatch": flips,
                "dropped_pairs_by_dispatch": dropped},
            "peak_bytes": torch.cuda.max_memory_allocated()})
        out["prefill"] = pre
        del logits

        B, C, steps = FAMILY_DECODE
        gen = torch.Generator(device="cuda").manual_seed(2)
        tok = lm_synthetic_batch(gen, cfg.vocab, B, 1)["tokens"]
        cache = api.init_cache(cfg, B, C, device="cuda")
        ops.reset_launch_counts()
        if cfg.family == "encdec":
            from repro_torch.models import encdec
            torch.cuda.synchronize()
            t = time.perf_counter()
            cache = encdec.prefill_cross(params, _frames(torch, cfg, B, gen),
                                         cfg, cache)
            torch.cuda.synchronize()
            out["prefill_cross_ms"] = (time.perf_counter() - t) * 1e3
        step_ms, generated = [], []
        for pos in range(steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            lg, cache = api.decode_step(params, cache, tok, pos, cfg)
            tok = lg.argmax(-1)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            check(lg.shape == (B, 1, cfg.vocab)
                  and bool(torch.isfinite(lg).all()),
                  f"{arch}: decode step {pos} logits")
            generated.append(tok[:, 0].tolist())
        dcounts = ops.launch_counts()
        check(sum(dcounts.values()) == 0, f"{arch}: decode launched "
                                          f"{dcounts}")
        dprof = {}
        if cfg.family in ("ssm", "encdec"):
            prof = _lm_profile(torch, lambda: api.decode_step(
                params, cache, tok, steps, cfg), expect=dcounts)
            dprof = {"profile": {
                k: prof[k] for k in ("wall_ms", "device_ms",
                                     "device_busy_share",
                                     "device_events_per_call")}}
            dprof["profile"]["top_device_kernels"] = \
                prof["top_device_kernels"][:4]
        out["decode"] = {**dprof,
            "batch": B, "steps": steps, "cache_len": C,
            "cache_bytes": sum(t.numel() * t.element_size()
                               for t in tree.leaves(cache)),
            "launches": dcounts, "step_ms": step_ms,
            "ms_per_token_median_after_first": statistics.median(step_ms[1:]),
            "tokens": generated[-1]}
        del cache
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    del params, batch
    torch.cuda.empty_cache()
    return out


def _prefill_split(torch, cfg, params, batch) -> dict:
    """Host-clock ms of the prefill's parts, each ended by a device sync:
    for the ssm family the mLSTM and the sLSTM layers (summed by kind) and
    the head; for the encdec family the encoder (its full-mask attention
    plain) and the decoder with the head."""
    from repro_torch.models import encdec, layers, ssm

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        y = fn()
        torch.cuda.synchronize()
        return y, (time.perf_counter() - t) * 1e3

    if cfg.family == "encdec":
        _, enc = timed(lambda: encdec.encode(params, batch["frames"], cfg))
        _, whole = timed(lambda: encdec.forward_train(params, batch, cfg,
                                                      last_only=True))
        return {"encoder_ms": enc, "decoder_and_head_ms": whole - enc,
                "whole_ms": whole}
    x, emb = timed(lambda: params["embed"][batch["tokens"]].to(cfg.cdtype))
    by = {"mlstm": 0.0, "slstm": 0.0}
    for i, lp in enumerate(params["layers"]):
        kind = ssm._kind(i, cfg)
        fn = ssm.mlstm_block if kind == "mlstm" else ssm.slstm_block
        (x, _), t = timed(lambda fn=fn, lp=lp, x=x: fn(lp, x, cfg))
        by[kind] += t
    _, head = timed(lambda: layers.rms_norm(
        x, params["final_norm"].to(x.dtype), cfg.norm_eps)[:, -1:]
        @ params["lm_head"].to(x.dtype))
    total = emb + by["mlstm"] + by["slstm"] + head
    return {"mlstm_layers_ms": by["mlstm"], "slstm_layers_ms": by["slstm"],
            "embed_and_head_ms": emb + head, "whole_ms": total,
            "slstm_share": by["slstm"] / total,
            "slstm_layers": list(cfg.slstm_layers)}


def _dispatch_timing(ctx, cfg, topi) -> dict:
    """The moe dispatch's buffer write at one prefill chunk of `cfg` with
    the (T, K) routes `topi` and random bf16 tokens: `moe.dispatch` (the
    kept tokens written, the dropped ones into a spare row) bitwise
    against the reference's form, an accumulating `index_put_` of every
    pair's token times keep into slot min(pos, C-1), and both timed.  The
    accumulating form adds the dropped pairs of an expert one after
    another into its last slot."""
    torch = ctx["torch"]
    from repro_torch.models import moe
    (T, K), E, D = topi.shape, cfg.n_experts, cfg.d_model
    g = torch.Generator(device="cuda").manual_seed(17)
    xt = torch.randn((T, D), generator=g, device="cuda").bfloat16()
    flat_e = topi.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = torch.arange(T, device="cuda").repeat_interleave(K)[order]
    pos = torch.arange(T * K, device="cuda") - torch.searchsorted(
        se, torch.arange(E, device="cuda"))[se]
    C = moe._capacity(T, cfg)
    keep = (pos < C).to(xt.dtype)
    slot = torch.clamp(pos, max=C - 1)

    def written():
        return moe.dispatch(xt, se, st, pos, E, C)

    def accumulated():
        return torch.zeros((E, C, D), dtype=xt.dtype,
                           device="cuda").index_put_(
            (se, slot), xt[st] * keep[:, None], accumulate=True)

    check(torch.equal(written(), accumulated()),
          "moe.dispatch differs from the accumulating scatter")
    return {"tokens": T, "experts": E, "top_k": K, "capacity": C,
            "dropped": int((pos >= C).sum()), "bitwise": True,
            "timer": "CUDA events around back-to-back calls",
            "dispatch_ms": time_ms(torch, written, iters=20, reps=5),
            "index_put_accumulate_ms": time_ms(torch, accumulated, iters=20,
                                               reps=5)}


def _family_parity(ctx, arch: str, cdtype: str) -> dict:
    """reduced() of one config from one init, the card (the flash kernel
    on the GQA layers, cuBLAS with TF32 off) against the CPU (the plain
    versions): logits at B 2, S 64 (vlm: 16 vision embeddings and 48
    tokens; encdec: 64 decoder tokens beside 24 frames; ssm: 4 mLSTM
    chunks of 16), prefill logits, 8 teacher-forced decode steps (encdec:
    after `prefill_cross` on each side), every cache leaf at the end.  f32: rtol = atol = 1e-4 and every route equal;
    bf16: the LM bound, the card's own routes' flips counted and the
    outputs compared on a card run given the CPU's routes, so that a flip
    does not move them."""
    torch = ctx["torch"]
    from repro_torch import configs, models, tree
    from repro_torch.kernels import ops
    cfg = configs.get_reduced(arch).replace(compute_dtype=cdtype)
    api = models.get_model(cfg)
    bf16 = cdtype == "bfloat16"
    moe = cfg.family == "moe"
    cpu = api.init_params(torch.Generator().manual_seed(5), cfg,
                          device="cpu")
    gpu = tree.tree_map(lambda t: t.cuda(), cpu)
    batch = _family_batch(torch, cfg, 2, 64, torch.Generator().manual_seed(6))
    gbatch = {k: t.cuda() for k, t in batch.items()}
    errs, rels = {}, {}
    flips, n_routes = [], [0]

    def hold(name, a, b):
        a = a.cpu()
        ok = a.dtype == b.dtype and a.shape == b.shape
        err, rel = _bf16_gap(torch, a, b)
        errs[name], rels[name] = max(errs.get(name, 0.0), err), max(
            rels.get(name, 0.0), rel)
        if bf16:
            ok = ok and err <= LM_BF16["max_abs"] and rel <= LM_BF16["rel_l2"]
        else:
            ok = ok and torch.allclose(a, b, rtol=1e-4, atol=1e-4)
        check(ok, f"{arch} {cdtype} card vs CPU {name}: err {err} rel {rel}")

    def given(run, rc):
        """run(routes, given) on the card: its own routes' flips against
        the CPU's rc counted (none in f32); in bf16 run again on rc."""
        rg = []
        out = run(rg, None)
        flips.extend(route_flips(rg, rc))
        n_routes[0] += sum(r.shape[0] for r in rc)
        if not (bf16 and moe):
            return out
        return run(None, iter([r.cuda() for r in rc]))

    # flash launches of the forward: one per GQA layer (none for MLA),
    # none for xLSTM, Whisper's decoder layers
    n_gqa = 0 if (cfg.kv_lora or cfg.family == "ssm") else cfg.n_layers
    with torch.inference_mode():
        rc = []
        want = _family_forward(cfg, cpu, batch, routes=rc, last_only=False)
        ops.reset_launch_counts()
        _family_forward(cfg, gpu, gbatch, last_only=False)
        counts = ops.launch_counts()
        check(counts["flash_attention"] == n_gqa
              and sum(counts.values()) == n_gqa,
              f"reduced {arch} forward launched {counts}; want {n_gqa} "
              f"flash_attention")
        hold("logits", given(lambda r, g: _family_forward(
            cfg, gpu, gbatch, routes=r, given=g, last_only=False), rc), want)
        if bf16 and moe:
            hold("prefill_logits", given(lambda r, g: _family_forward(
                cfg, gpu, gbatch, routes=r, given=g), rc),
                models.prefill_logits(cpu, batch, cfg))
        else:
            hold("prefill_logits", models.prefill_logits(gpu, gbatch, cfg),
                 models.prefill_logits(cpu, batch, cfg))
        cg = api.init_cache(cfg, 2, 64, device="cuda")
        cc = api.init_cache(cfg, 2, 64, device="cpu")
        if cfg.family == "encdec":
            from repro_torch.models import encdec
            cc = encdec.prefill_cross(cpu, batch["frames"], cfg, cc)
            cg = encdec.prefill_cross(gpu, gbatch["frames"], cfg, cg)

        def step(params, cache, tok, pos, r, g):
            extra = {"routes": r, "given": g} if moe else {}
            return api.decode_step(params, cache, tok, pos, cfg, **extra)

        ops.reset_launch_counts()
        for pos in range(8):
            tok = batch["tokens"][:, pos:pos + 1]
            rc = []
            lc, cc = step(cpu, cc, tok, pos, rc, None)
            lg, cg = given(lambda r, g: step(gpu, cg, tok.cuda(), pos, r, g),
                           rc)
            hold("decode_logits", lg, lc)
        dcounts = ops.launch_counts()
        check(sum(dcounts.values()) == 0, f"reduced {arch} decode launched "
                                          f"{dcounts}")
        for p, leaf in tree.paths(cc):
            hold("cache/" + "/".join(map(str, p)), tree.get(cg, p), leaf)
    check(bf16 or sum(flips) == 0, f"{arch} f32: {sum(flips)} route flips "
                                   f"of {n_routes[0]}")
    out = {"config": "reduced", "compute_dtype": cdtype, "seq": 64,
           "decode_steps": 8, "launches": counts, "max_abs_err": errs,
           "route_flips": sum(flips), "routes": n_routes[0]}
    if bf16:
        out.update(rel_l2_err=rels, tolerance=LM_BF16)
        if moe:
            out["compared_on"] = "the card given the CPU's routes"
    else:
        out["tolerance"] = 1e-4
    return out


def _family_rounds(ctx, arch: str) -> dict:
    """reduced(): 2 Regime-B resident rounds of `python -m
    repro_torch.launch.train` with 4 clients on the card (one
    gossip_gather a round and nothing else: training takes the plain
    route), then 2 rounds card vs CPU from one init and one set of
    batches at the Regime-B tolerance (rtol 1e-4, atol 2e-5), but the
    momentum: after a round it is that round's gradient, held at this
    family's f32 card-vs-CPU tolerance (rtol = atol = 1e-4)."""
    base = ["--arch", arch, "--reduced", "--clients", "4", "--batch", "2",
            "--seq", "32", "--neighbors", "2", "--resident"]
    run = _train_main(ctx, base + ["--rounds", "2", "--device", "cuda"])
    check(_only(run["launches"], gossip_gather=2),
          f"{arch}: 2 resident rounds launched {run['launches']}")
    out = _round_summary(run, 2)
    del run

    def tol_of(key, leaf):
        if key.startswith("opt_u"):
            return 1e-4, 1e-4
        return REGIME_B_TOL["rtol"], REGIME_B_TOL["atol"]

    out["card_vs_cpu"] = _rounds_card_vs_cpu(ctx, base, 2, tol_of)
    return out


def phase_moe(ctx):
    """The moe family: the flash kernel at deepseek-moe-16b's prefill (hd
    128, a group of 1) held against its plain version and timed, then
    deepseek-moe-16b at full width (`_family_full`), deepseek-moe-16b and
    deepseek-v2-236b (MLA) at reduced() card vs CPU in f32 and bf16
    (`_family_parity`) and through 2 Regime-B rounds (`_family_rounds`);
    the dispatch's buffer write against an accumulating scatter, at the
    prefill's routes that drop the most pairs and at uniform random
    routes."""
    torch = ctx["torch"]
    from repro_torch import configs
    arch = "deepseek-moe-16b"
    flash = _dense_flash_timing(ctx, arch, FAMILY_PREFILL[arch])
    full = _family_full(ctx, arch)
    cfg = configs.get_config(arch)
    T, K = ctx["moe_prefill_routes"].shape
    uniform = torch.argsort(torch.rand(
        (T, cfg.n_experts), device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(18)), dim=1)[:, :K]
    full["dispatch"] = {
        "prefill_routes": _dispatch_timing(ctx, cfg,
                                           ctx.pop("moe_prefill_routes")),
        "uniform_routes": _dispatch_timing(ctx, cfg, uniform)}
    parity = {a: {dt: _family_parity(ctx, a, dt)
                  for dt in ("float32", "bfloat16")} for a in MOE_ARCHS}
    rounds = {a: _family_rounds(ctx, a) for a in MOE_ARCHS}
    ctx["moe_launches"] = {
        "flash_attention": full["prefill"]["launches"]["flash_attention"],
        "gossip_gather": sum(r["launches"]["gossip_gather"]
                             for r in rounds.values())}
    ctx["moe_flash"] = flash
    emit("moe", card=ctx["smi"], arch=arch, flash=flash, full_width=full,
         parity=parity, regime_b=rounds, launches=ctx["moe_launches"])


def phase_vlm(ctx):
    """The vlm family (qwen2-vl-7b, M-RoPE): the flash kernel at its
    prefill (hd 128, a group of 7) held against its plain version before
    anything else is timed, then full width (`_family_full`), reduced()
    card vs CPU in f32 and bf16 and 2 Regime-B rounds."""
    arch = "qwen2-vl-7b"
    flash = _dense_flash_timing(ctx, arch, FAMILY_PREFILL[arch])
    full = _family_full(ctx, arch)
    parity = {dt: _family_parity(ctx, arch, dt)
              for dt in ("float32", "bfloat16")}
    rounds = _family_rounds(ctx, arch)
    ctx["vlm_launches"] = {
        "flash_attention": full["prefill"]["launches"]["flash_attention"],
        "gossip_gather": rounds["launches"]["gossip_gather"]}
    ctx["vlm_flash"] = flash
    emit("vlm", card=ctx["smi"], arch=arch, flash=flash, full_width=full,
         parity=parity, regime_b=rounds, launches=ctx["vlm_launches"])


# ---------------------------------------------------------------------------
# the ssm and encdec families (models/ssm.py, models/encdec.py)
# ---------------------------------------------------------------------------
SSM_REGIME_B_ARGS = ["--arch", "xlstm-125m", "--clients", "4", "--batch",
                     "2", "--seq", "128", "--neighbors", "2", "--device",
                     "cuda", "--resident"]
# xlstm-125m's shared row: its 198,985,040 leaves less lm_head (768 x
# 50,304) and final_norm (768), which stay personal
SSM_REGIME_B_D = 160_350_800
# tokens of the ssm prefill's profiled window (2 mLSTM chunks, 512 sLSTM
# steps a layer: ~24,000 launches)
SSM_PROFILE_SEQ = 512


def _ssm_regime_b(ctx) -> dict:
    """xlstm-125m at full width (its list of 12 layer dicts packed into
    the flat row) through 2 resident rounds of `python -m
    repro_torch.launch.train` with the trainer's defaults (m 4, B 2, S
    128, 2 neighbors): exactly one gossip_gather a round over the (4,
    160,350,800) buffer with 3 in-neighbors a row, finite losses, sum(mu)
    = 4, ms per round; then a profiled round of a Trainer (busy share; the
    profile's wall time is the profiled round's own); then the gather at
    that width alone (`_wide_gather`: bitwise its plain version; CUDA
    events beside the plain gather and torch.sparse.mm in CSR)."""
    torch = ctx["torch"]
    run = _train_main(ctx, SSM_REGIME_B_ARGS + ["--rounds", "2"])
    check(_only(run["launches"], gossip_gather=2),
          f"xlstm-125m: 2 resident rounds launched {run['launches']}")
    shape = tuple(run["state"].flat.shape)
    check(shape == (4, SSM_REGIME_B_D), f"xlstm-125m: resident buffer "
                                        f"{shape}")
    out = _round_summary(run, 2)
    del run
    prof_run = _trainer(SSM_REGIME_B_ARGS)
    k = prof_run.schedule.at(0).idx.shape[1]
    check(k == 3, f"xlstm-125m: {k} in-neighbors a row, want 3")
    prof_run.step(0)
    torch.cuda.synchronize()
    # the device alone: with the host's ops traced too (~10^6 events of
    # the vmapped autograd) the profile took 44 s to parse on an H100 host
    out["profile"] = _round_profile(ctx, prof_run, 1, cpu=False)
    out["gather_shape"] = [4, k, SSM_REGIME_B_D]
    del prof_run
    torch.cuda.empty_cache()
    # the gather at this width beside the plain gather and sparse.mm
    out["gather_at_width"] = _wide_gather(
        ctx, SSM_REGIME_B_D,
        torch.Generator(device="cuda").manual_seed(31))["gossip_gather"]
    torch.cuda.empty_cache()
    return out


def phase_ssm(ctx):
    """The ssm family (xlstm-125m, sLSTM at layers 3 and 9, chunkwise
    mLSTM elsewhere): full width and all 12 layers (`_family_full`: no
    kernel launch, the sLSTM loop's share of the prefill), 2 full-width
    Regime-B resident rounds (`_ssm_regime_b`), reduced() card vs CPU in
    f32 and bf16 (`_family_parity`) and 2 reduced rounds card vs CPU
    (`_family_rounds`)."""
    arch = "xlstm-125m"
    full = _family_full(ctx, arch)
    regime_b = _ssm_regime_b(ctx)
    parity = {dt: _family_parity(ctx, arch, dt)
              for dt in ("float32", "bfloat16")}
    rounds = _family_rounds(ctx, arch)
    ctx["ssm_launches"] = {
        "flash_attention": full["prefill"]["launches"]["flash_attention"],
        "gossip_gather": regime_b["launches"]["gossip_gather"]
        + rounds["launches"]["gossip_gather"]}
    ctx["ssm_regime_b"] = {"gossip_gather_shape": regime_b["gather_shape"],
                           "launches": regime_b["launches"],
                           "gossip_gather": regime_b["gather_at_width"]}
    emit("ssm", card=ctx["smi"], arch=arch, full_width=full,
         regime_b_full_width=regime_b, parity=parity, regime_b=rounds,
         launches=ctx["ssm_launches"])


def phase_encdec(ctx):
    """The encdec family (whisper-large-v3): the flash kernel at its
    decoder prefill (1, 8,192, 20, 20, 64), hd 64 at a group of 1, held
    against its plain version before anything is timed, then full width
    (`_family_full`: 32 encoder + 32 decoder layers, 32 flash_attention
    launches a prefill, `prefill_cross` and decode), reduced() card vs CPU
    in f32 and bf16 and 2 reduced Regime-B rounds.  Full-width Regime B
    does not fit one card: with m 4 the shared buffer and its momentum
    alone are 2 x 4 x 1,535,216,640 x 4 B = 49 GB."""
    arch = "whisper-large-v3"
    flash = _dense_flash_timing(ctx, arch, FAMILY_PREFILL[arch])
    full = _family_full(ctx, arch)
    parity = {dt: _family_parity(ctx, arch, dt)
              for dt in ("float32", "bfloat16")}
    rounds = _family_rounds(ctx, arch)
    ctx["encdec_launches"] = {
        "flash_attention": full["prefill"]["launches"]["flash_attention"],
        "gossip_gather": rounds["launches"]["gossip_gather"]}
    ctx["encdec_flash"] = flash
    emit("encdec", card=ctx["smi"], arch=arch, flash=flash, full_width=full,
         parity=parity, regime_b=rounds, launches=ctx["encdec_launches"],
         regime_b_full_width="not run: m 4 clients' shared buffer and "
                             "momentum alone are 49 GB")


def phase_timings(ctx):
    torch = ctx["torch"]
    from repro_torch.core import gossip, topology
    from repro_torch.kernels import ops
    from repro_torch.kernels import _build
    from repro_torch.kernels.head_gather import plan as head_plan
    from repro_torch.kernels.pushsum_mix import plan as pushsum_plan
    from repro_torch.kernels.topk_gather import plan as topk_plan
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

    # gossip_gather at the main path's shape (the random topology's table,
    # m 100, k 11) and at the bench grid's m 1024, k 16, both at d_flat
    # 13,328 f32, then at the baselines' full-model widths (their
    # mix_tree's one buffer): d 13,978 on OSGP's random table (k 11) and
    # DFedAvgM's undirected one (k 31), d_flat 13,328 at k 31
    # (DFedAvgM-P), d 27,956 at k 31 (Dis-PFL's num + den).  U read once,
    # the output written once, idx + w; 2*m*k*d operations.  The library
    # yardstick is torch.sparse.mm with the table in CSR.  cold_ms: the
    # same call with L2 flushed before each
    gather_shapes = {}
    for kind, m, n, d, key in (
            ("random", 100, 10, 13328, "100x11"),
            ("random", 1024, 15, 13328, "1024x16"),
            ("random", 100, 10, 13978, "100x11x13978"),
            ("undirected", 100, 10, 13978, "100x31x13978"),
            ("undirected", 100, 10, 13328, "100x31x13328"),
            ("undirected", 100, 10, 27956, "100x31x27956")):
        P = topology.get_schedule(kind, m, n, 0).at(0).to("cuda")
        k = P.idx.shape[1]
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
        pl = _gather_plan(m, k, d, U)
        gather_shapes[key] = dict(
            t, **_cold_and_share(torch, t, b_ms,
                                 lambda: ops.gossip_gather(
                                     P.idx, P.w, U, force="cuda"),
                                 lambda: torch.sparse.mm(csr, U)),
            bound_ms=b_ms, bound_us=b_ms * 1e3, bound_by=b_by,
            shape=[m, k, d], route=pl.route, block_d=pl.block_d,
            blocks=pl.blocks, threads=pl.threads,
            table_in_smem=pl.table, smem_bytes=pl.smem,
            blocks_per_sm=pl.blocks_per_sm, balance=pl.balance)
    main = gather_shapes["100x11"]
    kernels.append({
        "name": "gossip_gather", "route": "cuda",
        "kernel_route": main["route"],
        "source": "src/repro_torch/csrc/gossip_gather.cu",
        "replaces": "src/repro/kernels/gossip_gather.py:117",
        "launches": ctx["train_launches"]["gossip_gather"],
        "max_abs_err": ctx["gossip_err"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "call_ms": main["call_ms"], "cold_ms": main["cold_ms"],
        "bound_share": main["bound_share"],
        "shape": [100, 11, 13328], "dtype": "float32",
        "baseline_launches": ctx["baseline_launches"]["gossip_gather"],
        "async_launches": ctx["async_launches"]["gossip_gather"],
        "async_codec_launches":
            ctx["async_codec_launches"]["gossip_gather"],
        "obs_launches": ctx["obs_launches"]["gossip_gather"],
        "analysis_launches": ctx["analysis_launches"]["gossip_gather"],
        "checkpoint_launches": ctx["checkpoint_launches"]["gossip_gather"],
        "regime_b_launches": ctx["regime_b_launches"]["gossip_gather"],
        "regime_b": ctx["regime_b_kernels"]["gossip_gather"],
        "moe_launches": ctx["moe_launches"]["gossip_gather"],
        "vlm_launches": ctx["vlm_launches"]["gossip_gather"],
        "ssm_launches": ctx["ssm_launches"]["gossip_gather"],
        "ssm_regime_b": ctx["ssm_regime_b"],
        "encdec_launches": ctx["encdec_launches"]["gossip_gather"]})

    # head_gather_matmul at the serve path's shapes (m=100, d=64, n=10):
    # H read once, each distinct user's slab and bias read once, uid read
    # and the output written once; 2*B*d*n + B*n operations.  The library
    # yardstick is torch.baddbmm over the gathered slabs; cold_ms as for
    # gossip_gather.  launch_floor_ms: the device time of a one-element
    # elementwise kernel, the least any launch takes; tiled_ms: the tiled
    # route at block_n = n (the plan's own route at B 1 and 64, against
    # the warp route at B 1024)
    per_b = {}
    m, d, n = 100, 64, 10
    W = torch.randn((m, d, n), device="cuda")
    bias = torch.randn((m, n), device="cuda")
    one = torch.zeros(1, device="cuda")
    floor_ms = device_ms(torch, lambda: one.add_(1.0))
    # the same kernel by `queued_ms`, device_ms's fallback timer: what
    # it adds to a launch (the card's gap between queued kernels)
    queued_floor_ms = queued_ms(torch, lambda: one.add_(1.0))
    for B in (1, 64, 1024):
        uid = torch.randint(0, m, (B,), device="cuda", dtype=torch.int32)
        H = torch.randn((B, d), device="cuda")
        ul = uid.long()

        def head():
            return ops.head_gather_matmul(uid, H, W, bias, force="cuda")

        def head_lib():
            return torch.baddbmm(bias[ul].unsqueeze(1), H.unsqueeze(1),
                                 W[ul])

        check(torch.allclose(head_lib().squeeze(1), head(), rtol=1e-5,
                             atol=1e-5), "baddbmm yardstick disagrees")
        t = measure(head,
                    lambda: ops.head_gather_matmul(uid, H, W, bias,
                                                   force="ref"),
                    head_lib)
        users = int(torch.unique(uid).numel())
        nbytes = B * d * 4 + users * (d * n + n) * 4 + B * 4 + B * n * 4
        hb_ms, hb_by = bound(nbytes, 2 * B * d * n + B * n)
        pl = head_plan(B, d, n, 4, _build.sm_count("cuda"))
        tiled_ms = device_ms(torch, lambda: ops.head_gather_matmul(
            uid, H, W, bias, force="cuda", block_n=n))
        per_b[B] = dict(t, **_cold_and_share(torch, t, hb_ms, head,
                                             head_lib),
                        bound_ms=hb_ms, bound_us=hb_ms * 1e3,
                        bound_by=hb_by, launch_floor_ms=floor_ms,
                        distinct_users=users, plan=pl._asdict(),
                        tiled_ms=tiled_ms)
    big = per_b[1024]
    kernels.append({
        "name": "head_gather_matmul", "route": "cuda",
        "kernel_route": big["plan"]["route"],
        "source": "src/repro_torch/csrc/head_gather.cu",
        "replaces": "src/repro/kernels/head_gather.py:126",
        "launches": ctx["serve_launches"]["head_gather_matmul"],
        "obs_launches": ctx["obs_launches"]["head_gather_matmul"],
        "analysis_launches": ctx["analysis_launches"]["head_gather_matmul"],
        "checkpoint_launches":
            ctx["checkpoint_launches"]["head_gather_matmul"],
        "dense_launches": ctx["dense_launches"]["head_gather_matmul"],
        "dense_shape": ctx["dense_head"],
        "max_abs_err": ctx["head_err"], "ms": big["ms"],
        "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"], "library_ms": big["library_ms"],
        "call_ms": big["call_ms"], "cold_ms": big["cold_ms"],
        "bound_share": big["bound_share"],
        "launch_floor_ms": floor_ms, "shape": [1024, 64, 10, 100],
        "dtype": "float32"})
    # gossip_scatter at the sampled path's shape (m=100, n=25 of frac
    # 0.25, f32) and at bench scale (m=4096, n=1024): X read once and n
    # rows written (plus the row ids); no operations.  The library
    # yardstick is index_copy_; cold_ms as for gossip_gather.  The
    # sampled round's write-back at m 100 (flat and momentum: 2 pairs in
    # one launch; 4 with a codec) against one index_copy_ per buffer
    from repro_torch.kernels.gossip_scatter import plan as scatter_plan
    per_shape = {}
    g = torch.Generator(device="cuda").manual_seed(12)
    d = 13328
    for m, n in ((100, 25), (4096, 1024)):
        U = torch.randn((m, d), generator=g, device="cuda")
        X = torch.randn((n, d), generator=g, device="cuda")
        rows = torch.randperm(m, generator=g, device="cuda")[:n].sort()[
            0].to(torch.int32)
        rl = rows.long()

        def scatter():
            return ops.gossip_scatter(rows, X, U, force="cuda")

        def scatter_lib():
            return U.index_copy_(0, rl, X)

        t = measure(scatter,
                    lambda: ops.gossip_scatter(rows, X, U, force="ref"),
                    scatter_lib)
        sb_ms, sb_by = bound(2 * n * d * 4 + n * 4, 0)
        per_shape[f"{m}x{n}"] = dict(
            t, **_cold_and_share(torch, t, sb_ms, scatter, scatter_lib),
            bound_ms=sb_ms, bound_us=sb_ms * 1e3, bound_by=sb_by,
            shape=[m, n, d], plan=scatter_plan(
                n, d, _build.sm_count("cuda"))._asdict())
    writeback = {}
    for pairs in (2, 4):
        Xs = [torch.randn((25, d), generator=g, device="cuda")
              for _ in range(pairs)]
        Us = [torch.randn((100, d), generator=g, device="cuda")
              for _ in range(pairs)]
        rows = torch.randperm(100, generator=g, device="cuda")[:25].sort()[
            0].to(torch.int32)
        rl = rows.long()

        def many(Xs=Xs, Us=Us, rows=rows):
            return ops.gossip_scatter_many(rows, Xs, Us, force="cuda")

        def copies(Xs=Xs, Us=Us, rl=rl):
            for X, U in zip(Xs, Us):
                U.index_copy_(0, rl, X)

        t = measure(many, lambda Xs=Xs, Us=Us, rows=rows:
                    ops.gossip_scatter_many(rows, Xs, Us, force="ref"),
                    copies)
        wb_ms, wb_by = bound(pairs * (2 * 25 * d * 4) + 25 * 4, 0)
        writeback[pairs] = dict(
            t, **_cold_and_share(torch, t, wb_ms, many, copies),
            bound_ms=wb_ms, bound_by=wb_by, pairs=pairs,
            plan=scatter_plan(25, d, _build.sm_count("cuda"),
                              pairs)._asdict())
    per_shape["writeback_m100"] = writeback
    main, wb = per_shape["100x25"], writeback[2]
    kernels.append({
        "name": "gossip_scatter", "route": "cuda",
        "kernel_route": main["plan"]["route"],
        "source": "src/repro_torch/csrc/gossip_scatter.cu",
        "replaces": "src/repro/kernels/gossip_scatter.py:149",
        "launches": ctx["sampled_launches"]["gossip_scatter"],
        "max_abs_err": ctx["scatter_err"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "library": "index_copy_",
        "call_ms": main["call_ms"], "cold_ms": main["cold_ms"],
        "bound_share": main["bound_share"], "launch_floor_ms": floor_ms,
        "writeback_ms": wb["ms"], "writeback_call_ms": wb["call_ms"],
        "writeback_bound_ms": wb["bound_ms"],
        "writeback_library_ms": wb["library_ms"],
        "writeback_library": "index_copy_ per buffer (2 calls)",
        "shape": [100, 25, 13328], "dtype": "float32",
        "baseline_launches": ctx["baseline_launches"]["gossip_scatter"],
        "obs_launches": ctx["obs_launches"]["gossip_scatter"],
        "analysis_launches": ctx["analysis_launches"]["gossip_scatter"],
        "regime_b_launches": ctx["regime_b_launches"]["gossip_scatter"],
        "regime_b": ctx["regime_b_kernels"]["gossip_scatter"]})

    # pushsum_mix at the kernel-mix path's shape (m=100, d=13,328, f32)
    # and at m = 1024: P and U read once, the output written once;
    # 2*m*m*d operations.  The library yardstick is torch.matmul (TF32
    # off); cold_ms as for gossip_gather
    pushsum_shapes = {}
    for m in (100, 1024):
        d = 13328
        Pd = topology.get_schedule("random", m, 10, 0).at(0).to(
            "cuda").dense()
        U = torch.randn((m, d), device="cuda")
        t = measure(lambda: ops.pushsum_mix(Pd, U, force="cuda"),
                    lambda: ops.pushsum_mix(Pd, U, force="ref"),
                    lambda: torch.matmul(Pd, U))
        pb_ms, pb_by = bound(m * m * 4 + 2 * m * d * 4, 2 * m * m * d)
        pl = pushsum_plan(m, d, 4, _build.sm_count(U.device))
        pushsum_shapes[f"{m}x{m}"] = dict(
            t, **_cold_and_share(torch, t, pb_ms,
                                 lambda: ops.pushsum_mix(Pd, U, force="cuda"),
                                 lambda: torch.matmul(Pd, U)),
            bound_ms=pb_ms, bound_us=pb_ms * 1e3, bound_by=pb_by,
            f32_peak_share=2 * m * m * d / f32 / (t["ms"] * 1e-3),
            shape=[m, m, d], plan=pl._asdict())
    main = pushsum_shapes["100x100"]
    kernels.append({
        "name": "pushsum_mix", "route": "cuda",
        "source": "src/repro_torch/csrc/pushsum_mix.cu",
        "replaces": "src/repro/kernels/pushsum_mix.py:53",
        "launches": ctx["kernel_mix_launches"]["pushsum_mix"],
        "max_abs_err": ctx["pushsum_err"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "call_ms": main["call_ms"], "cold_ms": main["cold_ms"],
        "bound_share": main["bound_share"],
        "shape": [100, 100, 13328], "dtype": "float32"})

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

        def topk():
            return ops.topk_gather(idx, w, vals, cols, d, force="cuda")

        check(torch.allclose(library(), topk(), rtol=2e-5, atol=2e-5),
              "index_put_ + sparse.mm yardstick disagrees")
        t = measure(topk,
                    lambda: ops.topk_gather(idx, w, vals, cols, d,
                                            force="ref"),
                    library)
        nbytes = m * d * 4 + m * K * (4 + 2) + m * k * 8
        tb_ms, tb_by = bound(nbytes, 2 * m * k * K)
        # columns per block: each block reads all k*K pairs of its row and
        # keeps those in its chunk, so fewer chunks read less from L2 but
        # give more blocks; each block_d on the route the plan takes for it
        sms = _build.sm_count("cuda")
        sweep = {bd: {"ms": device_ms(torch, lambda bd=bd: ops.topk_gather(
            idx, w, vals, cols, d, force="cuda", block_d=bd)),
            "route": topk_plan(m, k, K, d, 4, 2, sms, bd).route}
            for bd in (1024, 2048, 4096, 8192, d)}
        pl = topk_plan(m, k, K, d, 4, 2, sms)
        topk_shapes[f"{m}x{k}"] = dict(
            t, **_cold_and_share(torch, t, tb_ms, topk, library),
            bound_ms=tb_ms, bound_us=tb_ms * 1e3, bound_by=tb_by,
            bound_bytes=nbytes, shape=[m, k, d, K], ms_by_block_d=sweep,
            plan=pl._asdict())
    main = topk_shapes["100x11"]
    kernels.append({
        "name": "topk_gather", "route": "cuda",
        "source": "src/repro_torch/csrc/topk_gather.cu",
        "replaces": "src/repro/kernels/topk_gather.py:128",
        "launches": ctx["compress_launches"]["topk_gather"],
        "obs_launches": ctx["obs_launches"]["topk_gather"],
        "checkpoint_launches": ctx["checkpoint_launches"]["topk_gather"],
        "max_abs_err": ctx["topk_err"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "library": "index_put_(accumulate=True) + torch.sparse.mm: 2 calls",
        "kernel_route": main["plan"]["route"],
        "call_ms": main["call_ms"], "cold_ms": main["cold_ms"],
        "bound_share": main["bound_share"], "shape": [100, 11, 13328, 833],
        "dtype": "float32/uint16",
        "baseline_launches": ctx["baseline_launches"]["topk_gather"],
        "async_codec_launches": ctx["async_codec_launches"]["topk_gather"]})
    # flash_attention at the hybrid model's prefill shape (B 2, S 4096, H
    # 16, Hkv 1, hd 256, window 2048, bf16): q, k, v read once and the
    # output written once (142.6 MB); 4 * hd flops per (query, key) pair
    # inside the band (206.2 GFLOP).  The bound takes both products at the
    # bf16 tensor-core peak (bf16 inputs: exact products, f32 accumulate);
    # bound_mixed_ms is the earlier bound with P V at the f32 peak (P is
    # f32 by definition), bound_f32_ms both in f32.  The kernel runs P V
    # twice (P_hi + P_lo): tc_flops_split is 1.5x the band's flops,
    # tc_flops_tiles what its tiles issue, masked keys and idle rows
    # included.  The library yardstick is scaled_dot_product_attention
    # with the same boolean band mask (timed only; the port never calls it)
    from repro_torch.kernels.flash_attention import (TC_TILES, tc_tile_flops,
                                                     tc_visits)
    B, S, H, Hkv, hd, win = 2, 4096, 16, 1, 256, 2048
    g = torch.Generator(device="cuda").manual_seed(31)
    q = torch.randn((B, S, H, hd), generator=g, device="cuda").bfloat16()
    k = torch.randn((B, S, Hkv, hd), generator=g, device="cuda").bfloat16()
    v = torch.randn((B, S, Hkv, hd), generator=g, device="cuda").bfloat16()
    pos = torch.arange(S, device="cuda")
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - win)
    pairs = int(band.sum())
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=band, enable_gqa=True).transpose(1, 2)

    got = ops.flash_attention(q, k, v, window=win, force="cuda")
    check(torch.allclose(sdpa().float(), got.float(), rtol=2e-2, atol=2e-2),
          "scaled_dot_product_attention yardstick disagrees")
    fl = {"ms": device_ms(torch, lambda: ops.flash_attention(
              q, k, v, window=win, force="cuda"), iters=10),
          "plain_ms": device_ms(torch, lambda: ops.flash_attention(
              q, k, v, window=win, force="ref"), iters=3),
          "library_ms": device_ms(torch, sdpa, iters=10),
          "call_ms": time_ms(torch, lambda: ops.flash_attention(
              q, k, v, window=win, force="cuda"), iters=5, reps=3),
          "cold_ms": cold_ms(torch, lambda: ops.flash_attention(
              q, k, v, window=win, force="cuda"), iters=10)}
    half = 2 * pairs * B * H * hd
    fbytes = 2 * (2 * B * S * H * hd + 2 * B * S * Hkv * hd)
    t_ops = 2 * half / ctx["peak_bf16"] * 1e3
    fb_ms = max(fbytes / bw * 1e3, t_ops)
    tiles_flops = tc_tile_flops(B, S, H, Hkv, hd, win)
    visits = tc_visits(B, S, H, Hkv, win)
    flash_detail = dict(
        fl, bound_ms=fb_ms,
        bound_mixed_ms=(half / ctx["peak_bf16"] + half / f32) * 1e3,
        bound_f32_ms=2 * half / f32 * 1e3, flops=2 * half,
        tc_flops_split=3 * half, tc_flops_tiles=tiles_flops,
        tc_flop_per_s_tiles=tiles_flops / (fl["ms"] * 1e-3),
        kv_tile_visits=visits,
        kv_tile_bytes=visits * 2 * TC_TILES[0][1] * hd * 2,
        bytes=fbytes, band_pairs=pairs, shape=[B, S, H, Hkv, hd],
        window=win,
        ms_by_tile={f"{bq}x{bk}": device_ms(
            torch, lambda bq=bq, bk=bk: ops.flash_attention(
                q, k, v, window=win, force="cuda", bq=bq, bk=bk), iters=10)
            for bq, bk in TC_TILES})
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:110",
        "launches": ctx["lm_launches"]["flash_attention"],
        "dense_launches": ctx["dense_launches"]["flash_attention"],
        "dense_by_config": ctx["dense_flash"],
        "regime_b_prefill_launches":
            ctx["regime_b_launches"]["flash_attention"],
        "moe_launches": ctx["moe_launches"]["flash_attention"],
        "vlm_launches": ctx["vlm_launches"]["flash_attention"],
        "ssm_launches": ctx["ssm_launches"]["flash_attention"],
        "encdec_launches": ctx["encdec_launches"]["flash_attention"],
        "family_by_config": {"deepseek-moe-16b": ctx["moe_flash"],
                             "qwen2-vl-7b": ctx["vlm_flash"],
                             "whisper-large-v3": ctx["encdec_flash"]},
        "max_abs_err": ctx["flash_err"][0], "ms": fl["ms"],
        "plain_ms": fl["plain_ms"], "bound_ms": fb_ms,
        "bound_by": "bytes" if fbytes / bw * 1e3 >= t_ops else "operations",
        "library_ms": fl["library_ms"],
        "library": "scaled_dot_product_attention(attn_mask=band, "
                   "enable_gqa=True)",
        "call_ms": fl["call_ms"], "cold_ms": fl["cold_ms"],
        "shape": [B, S, H, Hkv, hd],
        "window": win, "dtype": "bfloat16"})
    del q, k, v, qt, kt, vt, band

    # rglru at the model's shape (2, 4096, 4096) f32: a and b read once,
    # h written once, 2 flops per element.  No single PyTorch call
    # computes a linear recurrence: library_ms is null
    n = 2 * 4096 * 4096
    a = torch.rand((2, 4096, 4096), generator=g, device="cuda")
    b = torch.randn((2, 4096, 4096), generator=g, device="cuda")
    rg = {"ms": device_ms(torch, lambda: ops.rglru(a, b, force="cuda")),
          "plain_ms": device_ms(torch, lambda: ops.rglru(a, b, force="ref"),
                                iters=2),
          "call_ms": time_ms(torch, lambda: ops.rglru(a, b, force="cuda")),
          "cold_ms": cold_ms(torch, lambda: ops.rglru(a, b, force="cuda"))}
    rb_ms, rb_by = bound(3 * n * 4, 2 * n)
    rglru_detail = dict(rg, bound_ms=rb_ms, bound_by=rb_by,
                        shape=[2, 4096, 4096],
                        ms_by_steps_ahead={st: device_ms(
                            torch, lambda st=st: ops.rglru(
                                a, b, force="cuda", bs=st), iters=10)
                            for st in (1, 4, 8, 16, 32)},
                        ms_by_block={bw_: device_ms(
                            torch, lambda bw_=bw_: ops.rglru(
                                a, b, force="cuda", bw=bw_), iters=10)
                            for bw_ in (32, 64, 256)})
    kernels.append({
        "name": "rglru", "route": "cuda",
        "source": "src/repro_torch/csrc/rglru.cu",
        "replaces": "src/repro/kernels/rglru.py:55",
        "launches": ctx["lm_launches"]["rglru"],
        "max_abs_err": ctx["rglru_err"], "ms": rg["ms"],
        "plain_ms": rg["plain_ms"], "bound_ms": rb_ms, "bound_by": rb_by,
        "library_ms": None,
        "library": "none: no single PyTorch call computes the recurrence",
        "call_ms": rg["call_ms"], "cold_ms": rg["cold_ms"],
        "shape": [2, 4096, 4096],
        "dtype": "float32"})
    del a, b
    emit("timings", card=ctx["smi"], gossip_gather_by_shape=gather_shapes,
         flash_attention=flash_detail, rglru=rglru_detail,
         gossip_scatter_by_shape=per_shape,
         pushsum_mix_by_shape=pushsum_shapes,
         topk_gather_by_shape=topk_shapes,
         round_profile=profile_rounds(ctx),
         round_profile_sampled=profile_rounds(ctx, frac=0.25),
         round_profile_codec=profile_rounds(ctx, rounds=1, codec="topk"),
         head_gather_matmul_by_batch=per_b,
         note="topk_gather's library_ms is two calls (dense decode by "
              "index_put_, then torch.sparse.mm); "
              "ms/plain_ms/library_ms: device time per call summed over "
              "the kernels each puts on the card (torch.profiler, 50 "
              "calls; where its windows kept losing events, CUDA events "
              "around calls queued behind a spin kernel, listed in "
              "profiler.device_ms_by_cuda_events); *call_ms: median of CUDA-event windows of "
              "back-to-back calls, host time included; inputs warm in L2; "
              "bound_ms from the published peaks of the named card",
         profiler={"pad_s": PROFILE_PAD_S, "attempts": PROFILE_ATTEMPTS,
                   "empty_windows": list(PROFILER_MISSES),
                   "device_ms_by_cuda_events": list(DEVICE_MS_FALLBACKS),
                   "launch_floor_ms": floor_ms,
                   "launch_floor_queued_ms": queued_floor_ms})
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

    def run():
        s = state
        for r in range(1, rounds + 1):
            s = one_round(s, r)

    prof, events, wall_ms = profiled(torch, run, cpu=True)
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
                         "compress", "baselines", "async", "analysis", "obs",
                         "checkpoint", "serve", "lm", "dense",
                         "regime_b", "moe", "vlm", "ssm", "encdec"}}
    for phase in only:
        missing = needs.get(phase, set()) - wanted
        if missing:
            ap.error(f"phase {phase} needs {sorted(missing)}")
    fns = {"device": phase_device, "build": phase_build,
           "kernels": phase_kernels, "train": phase_train,
           "parity": phase_parity, "sampled": phase_sampled,
           "kernel_mix": phase_kernel_mix, "compress": phase_compress,
           "baselines": phase_baselines, "async": phase_async,
           "analysis": phase_analysis,
           "obs": phase_obs, "checkpoint": phase_checkpoint,
           "serve": phase_serve, "lm": phase_lm, "dense": phase_dense,
           "regime_b": phase_regime_b, "moe": phase_moe, "vlm": phase_vlm,
           "ssm": phase_ssm, "encdec": phase_encdec,
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
    print(f"# profiler: {len(PROFILER_MISSES)} windows empty or short of "
          f"events; {len(DEVICE_MS_FALLBACKS)} device_ms timings by CUDA "
          f"events", file=sys.stderr)
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
