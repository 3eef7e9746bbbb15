"""Build and load the port's hand-written CUDA kernels.

Every `*.cu` file in the package's `csrc/` is compiled by `nvcc` for Hopper
(`sm_90a`), one `nvcc` process per source, all started together, and the
objects are linked into ONE shared library with a plain C interface, which
is loaded with `ctypes` (no PyTorch headers, so the build takes seconds, not
minutes).
The library goes to `build/torch_kernels/` at the repository root and its file
name carries a hash of the sources and flags, so a stale library is never
loaded. Nothing is built at import time: the first kernel launch builds.

C interface (every pointer and the stream are `void*`, ints are `int`, each
function returns `cudaGetLastError()` after its launch):

  lvr_encoder_attention(q, k, v, out, B, S, H, D, scale, stream)
  lvr_flash_attention(q, k, v, out, lse, slopes, B, Sq, Skv, H, KV, D,
                      kv_len, causal, scale, stream)
  lvr_flash_attention_block_rows() -> the query rows a block of the last
                      forward launched by `lvr_flash_attention` took
  lvr_decode_attention(q, k, v, mask, out, B, T, H, KV, D, scale, stream)
  lvr_decode_attention_int8(q, k, v, k_scale, v_scale, mask, out, B, T, H,
                            KV, D, scale, stream)
  lvr_flash_attention_bwd_dq(q, k, v, out, dout, lse, delta, dq, slopes, B,
                             Sq, Skv, H, KV, D, kv_len, causal, scale,
                             stream)
(`out`: the forward's O; kernel 5 writes δ = rowsum(dO·O) into `delta`)
  lvr_flash_attention_bwd_dkv(q, k, v, dout, lse, delta, dk, dv, slopes, B,
                              Sq, Skv, H, KV, D, kv_len, causal, scale,
                              stream)
(`slopes`: fp32 [B, H] ALiBi slopes, or NULL for no bias)
  lvr_a_score(target, anchor, target_mask, anchor_mask, partial_sum,
              partial_count, out, N, St, Sa, D, dtype, vec, stream)
  lvr_a_score_tf32(target, anchor, target_mask, anchor_mask, row_max, out, N,
                   St, Sa, D, stream)
  lvr_int4_matmul(x, q4, scale, out, M, K, N, groups, stream)
  lvr_int4_matmul_dx(dy, q4, scale, dx, M, K, N, groups, stream)
  lvr_error_string(err) -> const char*
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-lineinfo", "-Xcompiler",
              "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "lvr_encoder_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    "lvr_flash_attention": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _I, _F, _P),
    "lvr_decode_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    "lvr_decode_attention_int8": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                  _I, _I, _F, _P),
    "lvr_flash_attention_bwd_dq": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                   _I, _I, _I, _I, _I, _I, _I, _F, _P),
    "lvr_flash_attention_bwd_dkv": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                    _I, _I, _I, _I, _I, _I, _I, _F, _P),
    "lvr_a_score": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "lvr_a_score_tf32": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "lvr_int4_matmul": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "lvr_int4_matmul_dx": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "lvr_flash_attention_block_rows": (),
}


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"liblvr_kernels_{digest.hexdigest()[:16]}.so"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from csrc/ at "
                       "first use")


def build() -> Path:
    """Compile csrc/*.cu into the hashed library unless it already exists:
    one `nvcc -c` per source in parallel, then one link. Raises RuntimeError
    with nvcc's stderr on failure."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs, objects = [], []
        for src in sources():
            objects.append(os.path.join(tmp, src.stem + ".o"))
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", objects[-1], str(src)]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed = []
        for cmd, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): "
                              f"{' '.join(cmd)}\n{err}")
        if failed:
            raise RuntimeError("\n".join(failed))
        lib = os.path.join(tmp, out.name)
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", lib, *objects]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}): "
                               f"{' '.join(cmd)}\n{res.stderr}")
        os.replace(lib, out)        # atomic: a reader never sees half a file
    return out


def ptxas_report(source: str) -> str:
    """What `nvcc -Xptxas -v` says of one source's kernels (registers,
    shared memory, spills), compiled with the library's flags."""
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
               os.path.join(tmp, "report.o"), str(CSRC_DIR / source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}): "
                           f"{' '.join(cmd)}\n{res.stderr}")
    return res.stderr


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.lvr_error_string.argtypes = [ctypes.c_int]
    lib.lvr_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = library().lvr_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def check_inputs(name: str, tensors: dict, head_dim: int,
                 head_dims: tuple = (64, 128)) -> None:
    """What every attention kernel requires of its bf16 operands: one CUDA
    device, contiguous, 16-byte aligned, a head size in `head_dims`."""
    device = next(iter(tensors.values())).device
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: {arg} must be bfloat16 on CUDA, "
                             f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")
    if head_dim not in head_dims:
        raise ValueError(f"{name}: head_dim {head_dim} not in {head_dims}")


def forbid_grad(name: str, *tensors) -> None:
    """A forward-only kernel's wrapper refuses to run where autograd would
    need its gradient: its result would carry no `grad_fn` and cut the
    graph without an error."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is forward-only: call it under torch.no_grad() or on "
            f"inputs that do not require grad")


def stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
