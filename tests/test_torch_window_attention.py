"""The port's windowed attention (the plain version, and the CUDA kernel's
wrapper on the CPU) against the JAX package's ``window_attention``, whose
Pallas kernel runs here in interpret mode.

Seeded numpy inputs go to both. Tolerance 1e-5 absolute in fp32 (logits of
order 10 summed in another order); 2e-2 relative in bf16 against the JAX
package's ``attention_ref`` with the bias, the form rvrt runs off the TPU.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_enhancer_tpu.ops.attention import attention_ref as j_ref
from video_enhancer_tpu.ops.attention import window_attention as j_window
from video_enhancer_tpu_torch import kernels
from video_enhancer_tpu_torch.ops.attention import (window_attention,
                                                    window_attention_plain)

TOL = 1e-5


def _inputs(nW, H, N, Dh, seed):
    g = np.random.default_rng(seed)
    q, k, v = (g.standard_normal((nW, H, N, Dh)).astype(np.float32)
               for _ in range(3))
    bias = (g.standard_normal((H, N, N)) * 0.5).astype(np.float32)
    return q, k, v, bias


@pytest.mark.parametrize("nW,H,N,Dh", [(6, 4, 128, 16), (5, 3, 40, 8),
                                       (2, 2, 128, 64)])
def test_plain_matches_jax_interpret_kernel(nW, H, N, Dh):
    q, k, v, bias = _inputs(nW, H, N, Dh, seed=nW + N)
    want = np.asarray(j_window(*(jnp.asarray(a) for a in (q, k, v, bias)),
                               interpret=True))
    args = [torch.from_numpy(a) for a in (q, k, v, bias)]
    got = window_attention_plain(*args)
    assert got.shape == (nW, H, N, Dh) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    before = dict(kernels.launch_counts)
    np.testing.assert_array_equal(window_attention(*args).numpy(),
                                  got.numpy())
    assert kernels.launch_counts == before        # the CPU launches nothing


def test_scale_matches_jax():
    q, k, v, bias = _inputs(3, 2, 32, 16, seed=1)
    want = np.asarray(j_window(*(jnp.asarray(a) for a in (q, k, v, bias)),
                               scale=0.1, interpret=True))
    got = window_attention(*(torch.from_numpy(a) for a in (q, k, v, bias)),
                           scale=0.1)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_split_projection_views_match_contiguous():
    """q, k and v as rvrt hands them over: (nW, H, N, Dh) views of the
    column slices of one (nW, N, 3 H Dh) projection."""
    g = np.random.default_rng(2)
    nW, H, N, Dh = 4, 4, 128, 16
    qkv = torch.from_numpy(g.standard_normal((nW, N, 3 * H * Dh))
                           .astype(np.float32))
    bias = torch.from_numpy(g.standard_normal((H, N, N)).astype(np.float32))
    q, k, v = (t.reshape(nW, N, H, Dh).transpose(1, 2)
               for t in qkv.chunk(3, dim=-1))
    got = window_attention(q, k, v, bias)
    want = window_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            bias)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


def test_bf16_matches_jax_ref():
    q, k, v, bias = _inputs(4, 4, 128, 16, seed=3)
    want = np.asarray(j_ref(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                            bias=jnp.asarray(bias, jnp.bfloat16)[None]),
                      dtype=np.float32)
    args = [torch.from_numpy(a).bfloat16() for a in (q, k, v, bias)]
    got = window_attention(*args)
    assert got.dtype == torch.bfloat16
    rel = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert rel <= 2e-2


def test_other_devices_raise():
    q = torch.empty((2, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        window_attention(q, q, q, torch.empty((2, 8, 8), device="meta"))
