"""The port's Mamba-1 selective scans against the JAX package, on the CPU.

The JAX side runs its Pallas kernels in interpret mode (TPU kernel rows
6-9: ``selective_scan_bidir``, ``selective_scan_pallas_short`` with and
without state, ``selective_scan_pallas``); the port's wrappers take their
plain versions for CPU tensors (the sequential scan for rows 6-8, the
associative scan for row 9), which are what the CUDA kernels are held
against on the card. Shapes have a ragged batch (300 against the TPU
kernels' block of 256), lengths that are not powers of two and a nonzero
h0. Tolerance 1e-4 absolute in fp32 (orders of sums differ), for y of
order 1 and states of order 1.

The plain versions compute their exps with torch's CPU exp, which calls
MKL's vector math; the port sets that up on one thread when it is imported
(``video_enhancer_tpu_torch/__init__.py``), since a first call from
several threads at once can return some threads' chunks off by ~1e-4.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_enhancer_tpu.ops import scan as jscan
from video_enhancer_tpu_torch.ops import scan as tscan

TOL = 1e-4


def _inputs(B, L, D, N, seed, state=True):
    g = np.random.default_rng(seed)
    f32 = np.float32
    a = dict(x=g.standard_normal((B, L, D)).astype(f32),
             dt=g.uniform(0.01, 0.3, (B, L, D)).astype(f32),
             A=-g.uniform(0.1, 1.0, (D, N)).astype(f32),
             B=g.standard_normal((B, L, N)).astype(f32),
             C=g.standard_normal((B, L, N)).astype(f32),
             D=g.standard_normal(D).astype(f32))
    if state:
        a["h0"] = g.standard_normal((B, D, N)).astype(f32)
    return a


ORDER = ("x", "dt", "A", "B", "C", "D")


def _j(a):
    return [jnp.asarray(a[k]) for k in ORDER]


def _t(a):
    return [torch.from_numpy(a[k]) for k in ORDER]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("B,L,D,N", [(300, 8, 16, 4), (300, 7, 16, 8),
                                     (5, 13, 24, 16)])
def test_short_scan_with_state_matches_pallas(B, L, D, N):
    """Row 7 (``_scan_short_kernel``): y and h_last from a nonzero h0."""
    a = _inputs(B, L, D, N, seed=B + L)
    want_y, want_h = jscan.selective_scan_pallas_short(
        *_j(a), h0=jnp.asarray(a["h0"]), interpret=True)
    got_y, got_h = tscan.selective_scan_pallas_short(
        *_t(a), h0=torch.from_numpy(a["h0"]))
    _close(got_y, want_y)
    _close(got_h, want_h)
    # h0 moves the output well beyond the tolerance, so a kernel that
    # ignores it fails the same comparison on the card
    y0, h_zero = tscan.selective_scan_pallas_short(*_t(a))
    assert (y0 - got_y).abs().max().item() > 100 * TOL
    assert (h_zero - got_h).abs().max().item() > 100 * TOL


@pytest.mark.parametrize("B", [300, 3000])
def test_short_scan_port_is_the_same_at_any_thread_count(B):
    """The port's row-7 plain version gives the same bits at 1, 3 and 8
    torch threads (3000 sequences pass torch's grain and split across the
    threads), so the comparison above cannot depend on a worker's thread
    count."""
    a = _inputs(B, 8, 16, 4, seed=B + 8)
    before = torch.get_num_threads()
    outs = []
    try:
        for n in (1, 3, 8):
            torch.set_num_threads(n)
            outs.append(tscan.selective_scan_pallas_short(
                *_t(a), h0=torch.from_numpy(a["h0"])))
    finally:
        torch.set_num_threads(before)
    for y, h in outs[1:]:
        assert torch.equal(y, outs[0][0]) and torch.equal(h, outs[0][1])


# A fresh interpreter's first exp over 19,200 elements (row 7's decays at
# (300, 16, 4)), split over eight threads, after importing the port.
_FIRST_EXP = """
import sys
sys.path.insert(0, sys.argv[1])
import video_enhancer_tpu_torch  # noqa: F401
import numpy as np
import torch
torch.set_num_threads(8)
z = -np.random.default_rng(308).uniform(0.001, 0.3, (300, 16, 4))
z = z.astype(np.float32)
e = torch.exp(torch.from_numpy(z)).double().numpy()
print(np.abs(e / np.exp(z.astype(np.float64)) - 1).max())
"""


def test_first_parallel_exp_after_importing_the_port_is_exact():
    """The cause of the row-7 comparison's rare failure: the first call of
    torch's CPU exp, made by several threads at once, could return some
    threads' chunks off by ~1e-4 relative (in about one fresh process in
    ten under load). Eight fresh interpreters at once, each importing the
    port and then making that call, all get exps within 1e-6 of float64."""
    root = str(Path(__file__).resolve().parents[1])
    procs = [subprocess.Popen([sys.executable, "-c", _FIRST_EXP, root],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(8)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        assert float(out) <= 1e-6


@pytest.mark.parametrize("B,L,D,N", [(300, 8, 16, 4), (1100, 5, 8, 16)])
def test_short_scan_without_state_matches_pallas(B, L, D, N):
    """Row 8 (``_scan_short_kernel_nostate``): zero state in, none out."""
    a = _inputs(B, L, D, N, seed=B + N, state=False)
    want_y, want_h = jscan.selective_scan_pallas_short(
        *_j(a), need_state=False, interpret=True)
    got_y, got_h = tscan.selective_scan_pallas_short(*_t(a),
                                                     need_state=False)
    assert want_h is None and got_h is None
    _close(got_y, want_y)


@pytest.mark.parametrize("B,L,D,N", [(300, 8, 16, 4), (7, 11, 32, 16)])
def test_bidir_scan_matches_pallas(B, L, D, N):
    """Row 6 (``_scan_bidir_kernel``): independent forward and backward
    streams."""
    f = _inputs(B, L, D, N, seed=L, state=False)
    b = _inputs(B, L, D, N, seed=L + 1, state=False)
    want = jscan.selective_scan_bidir(*_j(f), *_j(b), interpret=True)
    got = tscan.selective_scan_bidir(*_t(f), *_t(b))
    for g_, w_ in zip(got, want):
        _close(g_, w_)


def test_bidir_shared_matches_jax():
    """``selective_scan_bidir_shared`` with u, B and C shared: ``"bidir"``
    against JAX's, and ``"bmajor"`` (row 10) against it too, since both
    compute yf + yb."""
    a = _inputs(300, 7, 16, 4, seed=3, state=False)
    dtb = np.random.default_rng(4).uniform(0.01, 0.3, (300, 7, 16)).astype(
        np.float32)
    Ab = -np.random.default_rng(5).uniform(0.1, 1.0, (16, 4)).astype(
        np.float32)
    Db = np.random.default_rng(6).standard_normal(16).astype(np.float32)
    args = (a["x"], a["dt"], dtb, a["A"], Ab, a["B"], a["C"], a["D"], Db)
    want = jscan.selective_scan_bidir_shared(*map(jnp.asarray, args),
                                             interpret=True, impl="bidir")
    got = tscan.selective_scan_bidir_shared(*map(torch.from_numpy, args))
    _close(got, want)
    _close(tscan.selective_scan_bidir_shared(*map(torch.from_numpy, args),
                                             impl="bmajor"), want)
    with pytest.raises(ValueError, match="unknown impl"):
        tscan.selective_scan_bidir_shared(*map(torch.from_numpy, args),
                                          impl="time_major")


@pytest.mark.parametrize("L", [1, 7, 16, 33])
def test_bidir_shared_bmajor_matches_pallas(L):
    """Row 10 (``_scan_bidir_shared_kernel``) in interpret mode: a ragged
    batch (100 against the TPU kernel's block of 64), L from 1 to one
    above the CUDA kernel's register bound (32, past which it takes its
    fp32 workspace), B and C column slices of one projection."""
    B, D, N = 100, 16, 4
    a = _inputs(B, L, D, N, seed=L, state=False)
    g = np.random.default_rng(L + 1)
    dtb = g.uniform(0.01, 0.3, (B, L, D)).astype(np.float32)
    Ab = -g.uniform(0.1, 1.0, (D, N)).astype(np.float32)
    Db = g.standard_normal(D).astype(np.float32)
    proj = g.standard_normal((B, L, 3 + 2 * N)).astype(np.float32)
    Bm, Cm = proj[..., 3:3 + N], proj[..., 3 + N:]
    args = (a["x"], a["dt"], dtb, a["A"], Ab, Bm, Cm, a["D"], Db)
    want = jscan.selective_scan_bidir_shared(*map(jnp.asarray, args),
                                             interpret=True, impl="bmajor")
    tp = torch.from_numpy(proj)
    targs = [torch.from_numpy(v) for v in args]
    targs[5], targs[6] = tp[..., 3:3 + N], tp[..., 3 + N:]
    got = tscan.selective_scan_bidir_shared(*targs, impl="bmajor")
    assert got.shape == (B, L, D) and not targs[5].is_contiguous()
    _close(got, want)
    _close(tscan.selective_scan_bidir_shared_plain(*targs), want)


def test_bidir_shared_bmajor_matches_pallas_at_fast_mamba_vsr_layout():
    """Row 10 in interpret mode at fast_mamba_vsr's layout, cut in B and D:
    N 8, L 16, B and C the 8-wide column slices of one x_proj output after
    a dt_rank of 3 (19 wide), a ragged batch (70 against the TPU kernel's
    block of 64)."""
    B, L, D, N, rank = 70, 16, 24, 8, 3
    a = _inputs(B, L, D, N, seed=8, state=False)
    g = np.random.default_rng(9)
    dtb = g.uniform(0.01, 0.3, (B, L, D)).astype(np.float32)
    Ab = -g.uniform(0.1, 1.0, (D, N)).astype(np.float32)
    Db = g.standard_normal(D).astype(np.float32)
    proj = g.standard_normal((B, L, rank + 2 * N)).astype(np.float32)
    Bm, Cm = proj[..., rank:rank + N], proj[..., rank + N:]
    args = (a["x"], a["dt"], dtb, a["A"], Ab, Bm, Cm, a["D"], Db)
    want = jscan.selective_scan_bidir_shared(*map(jnp.asarray, args),
                                             interpret=True, impl="bmajor")
    tp = torch.from_numpy(proj)
    targs = [torch.from_numpy(v) for v in args]
    targs[5], targs[6] = tp[..., rank:rank + N], tp[..., rank + N:]
    got = tscan.selective_scan_bidir_shared(*targs, impl="bmajor")
    assert got.shape == (B, L, D) and targs[5].stride(1) == rank + 2 * N
    _close(got, want)


@pytest.mark.parametrize("B,L,D,N,state", [(2, 100, 16, 4, True),
                                           (3, 257, 8, 16, False)])
def test_long_scan_matches_pallas(B, L, D, N, state):
    """Row 9 (``_scan_kernel``): L > 32, chunked on the TPU with the state
    carried across chunks; the port's plain version is the associative
    scan."""
    a = _inputs(B, L, D, N, seed=L, state=state)
    h0 = a.get("h0")
    want_y, want_h = jscan.selective_scan_pallas(
        *_j(a), h0=None if h0 is None else jnp.asarray(h0), interpret=True)
    got_y, got_h = tscan.selective_scan_pallas(
        *_t(a), h0=None if h0 is None else torch.from_numpy(h0))
    _close(got_y, want_y)
    _close(got_h, want_h)


@pytest.mark.parametrize("L", [1, 70])
def test_assoc_equals_ref(L):
    a = _inputs(3, L, 8, 4, seed=L)
    h0 = torch.from_numpy(a["h0"])
    y1, h1 = tscan.selective_scan_assoc(*_t(a), h0=h0)
    y2, h2 = tscan.selective_scan_ref(*_t(a), h0=h0)
    _close(y1, y2)
    _close(h1, h2)


def test_plain_ref_matches_jax_ref_with_state_and_bf16():
    """The sequential plain scan against JAX's ``selective_scan_ref``: fp32
    state, y in x's dtype."""
    a = _inputs(4, 9, 8, 4, seed=9)
    want_y, want_h = jscan.selective_scan_ref(*_j(a),
                                              h0=jnp.asarray(a["h0"]))
    got_y, got_h = tscan.selective_scan_ref(*_t(a),
                                            h0=torch.from_numpy(a["h0"]))
    _close(got_y, want_y)
    _close(got_h, want_h)
    t = _t(a)
    y16, h16 = tscan.selective_scan_ref(*(v.bfloat16() if i in (0, 1, 3, 4)
                                          else v for i, v in enumerate(t)))
    assert y16.dtype == torch.bfloat16 and h16.dtype == torch.float32


def test_chunked_scan_equals_one_scan():
    a = _inputs(2, 40, 8, 4, seed=40, state=False)
    y1, h1 = tscan.chunked_selective_scan(*_t(a), chunk=16)
    y2, h2 = tscan.selective_scan(*_t(a))
    _close(y1, y2)
    _close(h1, h2)
    want_y, want_h = jscan.chunked_selective_scan(*_j(a), chunk=16)
    _close(y1, want_y)
    _close(h1, want_h)


@pytest.mark.parametrize("B,L,on_card,impl", [
    (1024, 32, True, "pallas_short"), (1023, 32, True, "ref"),
    (4096, 33, True, "pallas"), (2, 33, True, "pallas"),
    (4096, 8, False, "ref"), (2, 100, False, "assoc")])
def test_dispatch_rule(B, L, on_card, impl):
    """JAX's rule (ops/scan.py:615-624), "on the TPU" read as "a CUDA
    tensor"."""
    assert tscan._auto_impl(B, L, on_card) == impl


def test_dispatch_runs_the_chosen_form(monkeypatch):
    calls = []
    for name in ("selective_scan_ref", "selective_scan_assoc"):
        real = getattr(tscan, name)
        monkeypatch.setattr(tscan, name, lambda *a, _n=name, _r=real, **k:
                            calls.append(_n) or _r(*a, **k))
    tscan.selective_scan(*_t(_inputs(2, 8, 4, 4, 0, state=False)))
    tscan.selective_scan(*_t(_inputs(2, 40, 4, 4, 0, state=False)))
    assert calls == ["selective_scan_ref", "selective_scan_assoc"]
