"""Build, load and launch the port's CUDA kernels.

The sources in ``csrc/`` are CUDA C++ with a plain ``extern "C"`` interface
and include no PyTorch header. They are compiled by one ``nvcc`` call into a
shared library for Hopper (``sm_90a``) at first use and loaded with
``ctypes``; that takes seconds, where a build through PyTorch's extension
headers takes minutes. The library is named by a hash of the sources and
flags, built in a fresh temporary directory and moved into place, so a
half-built file or a library of other sources is never loaded.

Each kernel's wrapper lives beside its plain PyTorch version (ops/ssd.py,
ops/scan.py) and adds one to its entry of ``launch_counts`` where it
launches the kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "launch_counts",
           "reset_launch_counts", "build", "library", "dtype_code", "check",
           "stream_of", "row_stride"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# dtype codes of the C interface (csrc/common.cuh vetk::DType).
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

launch_counts: dict[str, int] = {"ssd_shared": 0, "fused_bidir_ssm": 0}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_SIGNATURES = {
    # dtype, x, dt, A, B, C, y, states, decay, b, L, H, P, N, ldx, ldb, ldc,
    # reverse, stream
    "vetk_ssd_shared": [_I] + [_P] * 8 + [_I] * 5 + [_L] * 3 + [_I, _P],
    # dtype, u, gate, cw, cb, wx, wdt, bdt, dtbf, dtbb, Af, Ab, Df, Db, y,
    # B, L, D, N, K, dt_rank, ldu, ldg, blocks, stream
    "vetk_fused_bissm": [_I] + [_P] * 14 + [_I] * 6 + [_L] * 2 + [_I, _P],
    "vetk_ssd_chunk": [],
}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build(ptxas_verbose: bool = False) -> tuple[Path, str]:
    """Compile every ``csrc/*.cu`` in one ``nvcc`` call. Returns the
    library's path and the compiler's output (with ``ptxas_verbose``, the
    registers, shared memory and spills of each kernel). An up-to-date
    library is reused unless ``ptxas_verbose`` asks for the compiler's
    report."""
    so = BUILD_DIR / f"libvetk_{_digest()}.so"
    if so.exists() and not ptxas_verbose:
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_DIR))
    try:
        out = tmp / "lib.so"
        cmd = [_nvcc(), *NVCC_FLAGS,
               *(["-Xptxas", "-v"] if ptxas_verbose else []),
               "-o", str(out), *map(str, _sources())]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc exited {proc.returncode}:\n{log}")
        os.replace(out, so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return so, log


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            so, _ = build()
            lib = ctypes.CDLL(str(so))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.vetk_error_string.argtypes = [ctypes.c_int]
            lib.vetk_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def dtype_code(t: torch.Tensor) -> int:
    code = _DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"kernel takes float32, bfloat16 or float16, not {t.dtype}")
    return code


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err:
        msg = library().vetk_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def row_stride(t: torch.Tensor, name: str) -> int:
    """Row stride of a (b, L, C) operand whose last dim is dense and whose
    b*L rows are evenly strided (a column slice of a wider tensor
    qualifies); raises otherwise."""
    b, L = t.shape[0], t.shape[1]
    ld = t.stride(1) if L > 1 else t.stride(0)
    if t.stride(-1) != 1 or (b > 1 and t.stride(0) != L * ld):
        raise ValueError(f"{name}: rows must be evenly strided with a dense "
                         f"last dim, got strides {t.stride()}")
    return ld
