"""Build the CUDA sources under `repro_torch/csrc/` at first use.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc`
into its own shared library, which is loaded with `ctypes` (no PyTorch
headers, so a build takes seconds).  Libraries land in `build/repro_torch/`
at the root of the checkout, named by a hash of the source and the flags,
so an edited source rebuilds and an unchanged one is reused.  Nothing is
compiled when a module is imported: `load` runs inside the first launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# -Xptxas=-v adds each kernel's register / shared-memory use to the log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
SOURCES = ("gossip_gather", "gossip_scatter", "head_gather", "pushsum_mix",
           "topk_gather")

_LIBS: dict = {}        # name -> loaded ctypes.CDLL (one load per process)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin: "
                       "the port's CUDA kernels are built from "
                       f"{CSRC} at first use and need the CUDA toolkit")


def artifact(name: str) -> Path:
    """The shared library for csrc/<name>.cu (hash of source + flags)."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile every missing library in `names`, one nvcc per source, all
    started together.  -> {name: {"seconds": float, "log": str}} for the
    sources it compiled (cached ones are absent).  Raises with the
    compiler's output when a build fails."""
    todo = [n for n in names if not artifact(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = artifact(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    out, failed = {}, []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---"
                          f"\n{log}")
            continue
        os.replace(tmp, artifact(name))     # atomic: no half-written .so
        out[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(artifact(name)))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a nonzero cudaGetLastError() returned by a C entry."""
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
