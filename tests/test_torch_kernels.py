"""Port kernels on the CPU: the plain versions of `gossip_gather` and
`head_gather_matmul` against the JAX reference (its jnp oracle and its
Pallas kernel in interpret mode), the `ops` dispatch rules, the build's
error path, and the port's independence from JAX.

The CUDA kernels themselves run only on a GPU; `chip_smoke.py` holds them
against these plain versions on the card."""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.gossip_gather import gossip_gather_pallas
from repro.kernels.head_gather import head_gather_matmul_pallas
from repro_torch.core import gossip as tgossip
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.gossip_gather import gossip_gather_cuda
from repro_torch.kernels.gossip_scatter import gossip_scatter_cuda
from repro_torch.kernels.head_gather import head_gather_matmul_cuda
from repro_torch.kernels.pushsum_mix import pushsum_mix_cuda

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
_DT = {"float32": (torch.float32, jnp.float32),
       "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _to_np(t):
    return t.to(torch.float32).numpy()


def _gather_inputs(m, k, d, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, m, size=(m, k)).astype(np.int32)
    if k > 1:
        idx[:, 1] = idx[:, 0]                # repeated neighbor ids
    w = rng.random((m, k)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    U = rng.standard_normal((m, d)).astype(np.float32)
    return idx, w, U


# ---------------------------------------------------------------------------
# gossip_gather
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("d", [1, 5, 513])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gossip_gather_plain_matches_reference(k, d, dtype):
    # f32: the reference sums the k terms in an einsum, the port in j order
    # with each product rounded -> a few ulp: rtol/atol 1e-6.  bf16: both
    # accumulate in f32 and round once to bf16, and an ulp-level f32
    # difference can flip that rounding -> one bf16 ulp: rtol/atol 8e-3
    tdt, jdt = _DT[dtype]
    idx, w, U = _gather_inputs(13, k, d, seed=k * 1000 + d)
    Ut = torch.as_tensor(U).to(tdt)
    Uj = jnp.asarray(U).astype(jdt)
    got = tref.gossip_gather_ref(torch.as_tensor(idx), torch.as_tensor(w), Ut)
    assert got.dtype == tdt and got.shape == (13, d)
    tol = 1e-6 if dtype == "float32" else 8e-3
    for want in (jref.gossip_gather_ref(jnp.asarray(idx), jnp.asarray(w), Uj),
                 gossip_gather_pallas(jnp.asarray(idx), jnp.asarray(w), Uj,
                                      interpret=True)):
        np.testing.assert_allclose(_to_np(got),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=tol, atol=tol)
    if dtype == "float32":
        # the plain version is the port's mix_rows, bit for bit
        assert torch.equal(got, tgossip.mix_rows(torch.as_tensor(idx),
                                                 torch.as_tensor(w), Ut))


# ---------------------------------------------------------------------------
# head_gather_matmul
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,d,n", [(5, 7, 3), (9, 64, 130)])
@pytest.mark.parametrize("hdtype", ["float32", "bfloat16"])
def test_head_gather_plain_matches_reference(B, d, n, hdtype):
    # f32 accumulate on both sides over the d-long dot, summed in another
    # order: rtol/atol 1e-5 (inputs are exactly representable in bf16 after
    # the cast both sides share)
    m = 6
    rng = np.random.default_rng(B * 100 + n)
    uid = rng.integers(0, m, size=(B,)).astype(np.int32)
    uid[-1] = uid[0]                         # repeated users
    H = rng.standard_normal((B, d)).astype(np.float32)
    W = rng.standard_normal((m, d, n)).astype(np.float32)
    b = rng.standard_normal((m, n)).astype(np.float32)
    tdt, jdt = _DT[hdtype]
    got = tref.head_gather_matmul_ref(torch.as_tensor(uid),
                                      torch.as_tensor(H).to(tdt),
                                      torch.as_tensor(W), torch.as_tensor(b))
    assert got.dtype == torch.float32 and got.shape == (B, n)
    args = (jnp.asarray(uid), jnp.asarray(H).astype(jdt), jnp.asarray(W),
            jnp.asarray(b))
    for want in (jref.head_gather_matmul_ref(*args),
                 head_gather_matmul_pallas(*args, interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
def test_ops_dispatch_rules_on_cpu():
    idx, w, U = (torch.as_tensor(a) for a in _gather_inputs(5, 2, 16, 0))
    before = ops.launch_counts()
    # auto on a CPU tensor takes the plain path (and launches nothing)
    assert torch.equal(ops.gossip_gather(idx, w, U),
                       tref.gossip_gather_ref(idx, w, U))
    assert torch.equal(ops.gossip_gather(idx, w, U, force="ref"),
                       tref.gossip_gather_ref(idx, w, U))
    assert ops.launch_counts() == before
    # force="cuda" on a CPU tensor raises: there is no interpret mode
    with pytest.raises(ValueError, match="force='cuda'"):
        ops.gossip_gather(idx, w, U, force="cuda")
    uid = torch.tensor([0, 1, 1], dtype=torch.int32)
    H, W, b = torch.ones(3, 4), torch.ones(2, 4, 3), torch.zeros(2, 3)
    with pytest.raises(ValueError, match="force='cuda'"):
        ops.head_gather_matmul(uid, H, W, b, force="cuda")
    with pytest.raises(ValueError, match="force"):
        ops.gossip_gather(idx, w, U, force="pallas")
    P = torch.full((5, 5), 0.2)
    rows = torch.tensor([1, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="force='cuda'"):
        ops.pushsum_mix(P, U, force="cuda")
    with pytest.raises(ValueError, match="force='cuda'"):
        ops.gossip_scatter(rows, U[:2], U.clone(), force="cuda")
    assert torch.equal(ops.pushsum_mix(P, U), tref.pushsum_mix_ref(P, U))
    assert ops.launch_counts() == before
    # the kernel wrappers refuse CPU tensors outright
    with pytest.raises(ValueError, match="CUDA tensors"):
        gossip_gather_cuda(idx, w, U)
    with pytest.raises(ValueError, match="CUDA tensors"):
        head_gather_matmul_cuda(uid, H, W, b)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pushsum_mix_cuda(P, U)
    with pytest.raises(ValueError, match="CUDA tensors"):
        gossip_scatter_cuda(rows, U[:2], U)
    # every kernel ops dispatches to is built from its own source
    assert set(ops.KERNELS) == {"gossip_gather", "gossip_scatter",
                                "head_gather_matmul", "pushsum_mix",
                                "topk_gather"}
    assert set(_build.SOURCES) == {"gossip_gather", "gossip_scatter",
                                   "head_gather", "pushsum_mix",
                                   "topk_gather"}


@pytest.mark.parametrize("op,knob", [("gossip_gather", "block_d"),
                                     ("gossip_scatter", "block_d"),
                                     ("head_gather_matmul", "block_n")])
@pytest.mark.parametrize("force", ["auto", "ref"])
def test_kernel_knobs_raise_on_plain_dispatch(op, knob, force):
    if op == "gossip_gather":
        args = tuple(torch.as_tensor(a) for a in _gather_inputs(5, 2, 16, 0))
    elif op == "gossip_scatter":
        args = (torch.tensor([0, 2], dtype=torch.int32), torch.ones(2, 3),
                torch.zeros(4, 3))
    else:
        args = (torch.tensor([0, 1], dtype=torch.int32), torch.ones(2, 4),
                torch.ones(2, 4, 3), torch.zeros(2, 3))
    with pytest.raises(ValueError, match=knob):
        getattr(ops, op)(*args, force=force, **{knob: 256})


def test_build_raises_with_compiler_output(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: fake compiler refused' >&2\n"
                    "exit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="fake compiler refused"):
        _build.build(("gossip_gather",))
    assert _build.artifact("gossip_gather").name.startswith("gossip_gather-")
    assert not _build.artifact("gossip_gather").exists()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_port_imports_no_jax():
    # every module of the port imports without bringing in jax or repro
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for mod in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(mod.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'repro' or n.startswith('repro.'))\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_port_sources_import_no_jax_or_reference():
    # no import statement of the port or of chip_smoke.py names jax or the
    # JAX package `repro` (repro_torch is the port itself)
    import re
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    bad = [f"{f.relative_to(REPO)}:{i}: {line.strip()}" for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if pat.match(line)]
    assert len(files) > 30 and not bad, bad
