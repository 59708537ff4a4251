"""The port's ssd_shared against the JAX package's SSD kernels, on the CPU.

The JAX side runs its Pallas kernels in interpret mode: the whole-batch
kernel (``_ssd_shared_pallas_batched_impl``, TPU kernel #1) and the
(batch, chunk)-grid kernel (``_ssd_shared_pallas_impl``, #2). On a CPU
tensor the port's kernel wrapper takes its plain version, which is what
these tests hold. Tolerance 1e-4 absolute on O(1) outputs, fp32.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_enhancer_tpu.ops import ssd as jssd
from video_enhancer_tpu_torch import kernels
from video_enhancer_tpu_torch.ops import ssd as tssd

TOL = 1e-4

SHAPES = [  # b, L, H, P, N, chunk
    (2, 200, 2, 32, 8, 64),     # ragged last chunk
    (1, 128, 1, 64, 16, 32),
    (3, 50, 2, 16, 4, 256),     # one chunk shorter than the chunk size
]


def _inputs(b, L, H, P, N, seed=0):
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, L, H, P), dtype=np.float32)
    dt = r.uniform(0.001, 0.2, (b, L, H)).astype(np.float32)
    A = -r.uniform(0.2, 2.0, H).astype(np.float32)
    Bm = r.standard_normal((b, L, N), dtype=np.float32)
    Cm = r.standard_normal((b, L, N), dtype=np.float32)
    return x, dt, A, Bm, Cm


def _port(args, **kw):
    return tssd.ssd_shared_kernel(*(torch.from_numpy(a) for a in args), **kw)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("impl", ["batched", "grid"])
@pytest.mark.parametrize("shape", SHAPES)
def test_matches_pallas_kernel_interpret(shape, impl, reverse):
    b, L, H, P, N, chunk = shape
    args = _inputs(b, L, H, P, N, seed=L)
    x, dt, A, Bm, Cm = (jnp.asarray(a) for a in args)
    fn = (jssd._ssd_shared_pallas_batched_impl if impl == "batched"
          else jssd._ssd_shared_pallas_impl)
    want = fn(x.reshape(b, L, H * P), dt, A, Bm, Cm, heads=H, chunk=chunk,
              reverse=reverse, interpret=True).reshape(b, L, H, P)
    got = _port(args, chunk=chunk, reverse=reverse)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("reverse", [False, True])
def test_matches_sequential_reference(reverse):
    b, L, H, P, N = 2, 150, 2, 8, 4
    args = _inputs(b, L, H, P, N, seed=3)
    flip = (lambda a: a[:, ::-1].copy()) if reverse else (lambda a: a)
    x, dt, A, Bm, Cm = args
    Bh = np.broadcast_to(flip(Bm)[:, :, None], (b, L, H, N))
    Ch = np.broadcast_to(flip(Cm)[:, :, None], (b, L, H, N))
    want, _ = jssd.ssd_ref(jnp.asarray(flip(x)), jnp.asarray(flip(dt)),
                           jnp.asarray(A), jnp.asarray(Bh), jnp.asarray(Ch))
    got = _port(args, chunk=32, reverse=reverse)
    np.testing.assert_allclose(got.numpy(), flip(np.asarray(want)), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("chunk", [8, 64])
def test_result_does_not_depend_on_chunk(chunk):
    """The CUDA kernel uses its own chunk length; the chunked form is exact
    for any chunking up to rounding."""
    args = [torch.from_numpy(a) for a in _inputs(2, 300, 2, 16, 8, seed=5)]
    ref = tssd.ssd_shared_plain(*args, chunk=256)
    got = tssd.ssd_shared_plain(*args, chunk=chunk)
    torch.testing.assert_close(got, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_public_api_matches_jax(dtype):
    """ssd_shared with the kernel asked for, against the JAX package's
    ssd_shared(use_pallas=True) (interpret mode on the CPU)."""
    args = _inputs(2, 96, 2, 32, 8, seed=7)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    x, dt, A, Bm, Cm = (jnp.asarray(a) for a in args)
    want = jssd.ssd_shared(x.astype(jdt), dt, A, Bm.astype(jdt),
                           Cm.astype(jdt), chunk=32, use_pallas=True)
    t = [torch.from_numpy(a) for a in args]
    got = tssd.ssd_shared(t[0].to(dtype), t[1], t[2], t[3].to(dtype),
                          t[4].to(dtype), chunk=32, use_kernel=True)
    assert got.dtype == dtype
    tol = TOL if dtype == torch.float32 else 5e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol * max(1.0, float(jnp.abs(want).max())),
                               rtol=0)


def test_cpu_tensor_takes_plain_and_counts_nothing():
    kernels.reset_launch_counts()
    args = [torch.from_numpy(a).bfloat16() for a in _inputs(1, 40, 1, 8, 4)]
    args[1], args[2] = args[1].float(), args[2].float()
    y = tssd.ssd_shared(*args)          # half precision: the kernel's path
    torch.testing.assert_close(
        y, tssd.ssd_shared_plain(*args), atol=0, rtol=0)
    assert kernels.launch_counts["ssd_shared"] == 0


def test_other_devices_raise():
    args = [torch.empty(s, device="meta") for s in
            [(1, 8, 1, 4), (1, 8, 1), (1,), (1, 8, 2), (1, 8, 2)]]
    with pytest.raises(ValueError, match="no kernel"):
        tssd.ssd_shared_kernel(*args)
