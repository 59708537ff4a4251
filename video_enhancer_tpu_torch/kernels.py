"""Build, load and launch the port's CUDA kernels.

The sources in ``csrc/`` are CUDA C++ with a plain ``extern "C"`` interface
and include no PyTorch header. At first use each is compiled for Hopper
(``sm_90a``) by its own ``nvcc`` process, all started together, and one
more ``nvcc`` call links the objects into a shared library loaded with
``ctypes``; that takes seconds, where a build through PyTorch's extension
headers takes minutes. The library is named by a hash of the sources and
flags, built in a fresh temporary directory and moved into place, so a
half-built file or a library of other sources is never loaded.

Each kernel's wrapper lives beside its plain PyTorch version (ops/ssd.py,
ops/scan.py, ops/attention.py, ops/conv.py) and adds one to its entry of
``launch_counts`` where it launches the kernel, and nowhere else.
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

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "LINK_FLAGS", "KERNEL_DTYPES",
           "launch_counts", "reset_launch_counts", "library_path", "build",
           "library", "dtype_code", "check", "stream_of", "sm_count",
           "row_stride", "seq_strides"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

# dtype codes of the C interface (csrc/common.cuh vetk::DType).
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
KERNEL_DTYPES = tuple(_DTYPE_CODES)

launch_counts: dict[str, int] = {"ssd_shared": 0, "fused_bidir_ssm": 0,
                                 "flash_attention": 0, "window_attention": 0,
                                 "selective_scan_bidir": 0,
                                 "selective_scan_short": 0,
                                 "selective_scan_short_nostate": 0,
                                 "selective_scan_long": 0,
                                 "selective_scan_bidir_shared": 0,
                                 "dwconv_silu": 0}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
_SIGNATURES = {
    # dtype, x, dt, A, B, C, y, states, decay, b, L, H, P, N, ldx, ldb, ldc,
    # reverse, chunks a run, stream
    "vetk_ssd_shared": [_I] + [_P] * 8 + [_I] * 5 + [_L] * 3 + [_I, _I, _P],
    # H, P
    "vetk_ssd_tc_smem": [_I, _I],
    # dtype, u, gate, cw, cb, wx, wdt, bdt, dtbf, dtbb, Af, Ab, Df, Db, y,
    # B, L, D, N, K, dt_rank, ldu, ldg, weight dtypes, instance, warps,
    # blocks, stream
    "vetk_fused_bissm": [_I] + [_P] * 14 + [_I] * 6 + [_L] * 2 + [_I] * 4
    + [_P],
    # dtype, instance
    "vetk_fused_bissm_regs": [_I, _I],
    # dtype, instance, L, D, warps
    "vetk_fused_bissm_smem": [_I] * 5,
    "vetk_ssd_chunk": [],
    # dtype, q, k, v, o, B, H, Lq, Lk, Dh, scale, (batch, head, row) strides
    # of q, k, v and o, TMA dimension orders, stream
    "vetk_flash_attention": [_I] + [_P] * 4 + [_I] * 5 + [_F] + [_L] * 12
    + [_I, _P],
    # padded head width
    "vetk_flash_smem": [_I],
    # head width
    "vetk_window_attention_smem": [_I],
    # dtype, q, k, v, bias, o, nW, H, N, Dh, scale, (window, head, row)
    # strides of q, k, v and o, windows a block, vec, stream
    "vetk_window_attention": [_I] + [_P] * 5 + [_I] * 4 + [_F] + [_L] * 12
    + [_I, _I, _P],
    # dtype, x, dt, A, B, C, D, h0, y, h_last, B, L, D, N, strides,
    # sequences a block (0: the walking kernel), persistent blocks (row 8
    # at N > 8), stream
    "vetk_selective_scan_short": [_I] + [_P] * 9 + [_I] * 4 + [_P, _I, _I, _P],
    # dtype, L, D, N, sequences a block
    "vetk_selective_scan_short_smem": [_I] * 5,
    # dtype, (x, dt, A, B, C, D) forward and backward, yf, yb, B, L, D, N,
    # strides forward and backward, sequences a block (0: the walking
    # kernel), shared, stream
    "vetk_selective_scan_bidir": [_I] + [_P] * 14 + [_I] * 4 + [_P] * 2
    + [_I, _I, _P],
    # dtype, L, D, N, sequences a block, shared
    "vetk_selective_scan_bidir_smem": [_I] * 6,
    # dtype, x, dt, A, B, C, D, h0, y, h_last, states, sumdt, B, L, D, N,
    # strides, stream
    "vetk_selective_scan_long": [_I] + [_P] * 11 + [_I] * 4 + [_P, _P],
    "vetk_selective_scan_chunk": [],
    # dtype, u, dtf, dtb, Af, Ab, B, C, Df, Db, y, workspace, B, L, D, N,
    # strides (u, dtf, dtb, B, C), sequences a block (0: the register or
    # workspace kernel), stream
    "vetk_selective_scan_bidir_shared": [_I] + [_P] * 11 + [_I] * 4
    + [_P, _I, _P],
    # dtype, L, D, N, sequences a block
    "vetk_selective_scan_bidir_shared_smem": [_I] * 5,
    "vetk_selective_scan_shared_max_l": [],
    # dtype, x, w, bias, y, B, L, C, K, ld, vec, channels a slab, runs,
    # grid, stream
    "vetk_dwconv_silu": [_I] + [_P] * 4 + [_I] * 4 + [_L] + [_I] * 4 + [_P],
    # dtype, channels a slab, K, runs
    "vetk_dwconv_silu_smem": [_I] * 4,
    "vetk_dwconv_silu_max_k": [],
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _run(procs: list[tuple[str, subprocess.Popen]]) -> str:
    """Wait for every ``nvcc`` process; raise with the output of the first
    that failed."""
    logs, failed = [], None
    for what, proc in procs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc ({what}) exited {proc.returncode}:\n{out}"
    if failed:
        raise RuntimeError(failed)
    return "".join(logs)


def library_path() -> Path:
    """Where the library of the current sources and flags is (or will be)
    built; a later start that finds it there loads it without a build."""
    return BUILD_DIR / f"libvetk_{_digest()}.so"


def build(ptxas_verbose: bool = False) -> tuple[Path, str]:
    """Compile every ``csrc/*.cu``, each by its own ``nvcc`` process, all
    started together, and link them into one library. Returns the
    library's path and the compiler's output (with ``ptxas_verbose``, the
    registers, shared memory and spills of each kernel). An up-to-date
    library is reused unless ``ptxas_verbose`` asks for the compiler's
    report."""
    so = library_path()
    if so.exists() and not ptxas_verbose:
        return so, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_DIR))
    nvcc = _nvcc()
    try:
        objs, procs = [], []
        for src in _sources():
            obj = tmp / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS,
                   *(["-Xptxas", "-v"] if ptxas_verbose else []),
                   "-c", "-o", str(obj), str(src)]
            procs.append((src.name, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
            objs.append(str(obj))
        log = _run(procs)
        out = tmp / "lib.so"
        log += _run([("link", subprocess.Popen(
            [nvcc, *LINK_FLAGS, "-o", str(out), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))])
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


_sm_counts: dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device, asked once."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sm_counts[index]


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


def seq_strides(*named: tuple[torch.Tensor, str]) -> ctypes.Array:
    """The batch and step strides, in elements, of (b, L, C) operands whose
    last dim is dense, packed for a kernel's ``const long*`` argument;
    raises for an operand whose last dim is strided."""
    vals = []
    for t, name in named:
        if t.ndim != 3 or (t.stride(2) != 1 and t.shape[2] > 1):
            raise ValueError(f"{name}: expected (b, L, C) with a dense last "
                             f"dim, got shape {tuple(t.shape)} strides "
                             f"{t.stride()}")
        vals += [t.stride(0), t.stride(1)]
    return (ctypes.c_long * len(vals))(*vals)
