"""The port's attention (plain form, the flash kernel's wrapper on the CPU,
the dispatcher) against the JAX package's, on the CPU.

The JAX side runs its Pallas flash kernel in interpret mode with blocks of
16-64, as tests/test_ops_attention.py does, and its ``attention_ref``. Seeded
numpy inputs go to both. Tolerance 2e-5 absolute in fp32, the JAX tests'
own bound for the flash kernel against its reference (sums in another
order); 2e-2 relative in bf16 (its rounding).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_enhancer_tpu.ops.attention import attention as j_attention
from video_enhancer_tpu.ops.attention import attention_ref as j_ref
from video_enhancer_tpu.ops.attention import flash_attention as j_flash
from video_enhancer_tpu_torch import kernels
from video_enhancer_tpu_torch.ops.attention import (attention, attention_ref,
                                                    flash_attention)

TOL = 2e-5


def _qkv(B, H, Lq, Lk, Dh, seed):
    g = np.random.default_rng(seed)
    return [g.standard_normal((B, H, n, Dh)).astype(np.float32)
            for n in (Lq, Lk, Lk)]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("B,H,Lq,Lk,Dh,block", [
    (1, 2, 37, 53, 16, 16),
    (2, 1, 64, 300, 64, 64),
    (1, 2, 300, 96, 128, 32),
])
def test_plain_and_wrapper_match_jax_flash(B, H, Lq, Lk, Dh, block):
    """Ragged Lq != Lk against the Pallas kernel (interpret mode) and the
    JAX reference; on the CPU the wrapper is the plain form."""
    q, k, v = _qkv(B, H, Lq, Lk, Dh, seed=Lq + Dh)
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              block_q=block, block_k=block, interpret=True))
    ref = np.asarray(j_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    kernels.reset_launch_counts()
    for fn in (attention_ref, flash_attention, attention):
        got = fn(*_t(q, k, v)).numpy()
        assert got.shape == (B, H, Lq, Dh)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
        np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    assert kernels.launch_counts["flash_attention"] == 0


def test_scale_and_bias_match_jax():
    q, k, v = _qkv(2, 3, 40, 24, 32, seed=5)
    bias = np.random.default_rng(6).standard_normal((1, 3, 40, 24)).astype(
        np.float32)
    want = np.asarray(j_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), bias=jnp.asarray(bias),
                                  scale=0.3))
    got = attention(*_t(q, k, v), bias=torch.from_numpy(bias), scale=0.3)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    want = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              scale=0.3, block_q=16, block_k=16,
                              interpret=True))
    got = flash_attention(*_t(q, k, v), scale=0.3)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_strided_views_match_contiguous():
    """The views ditvr hands over (column slices of a qkv projection seen
    as (B, H, L, Dh)) give what contiguous copies give."""
    g = np.random.default_rng(7)
    B, L, H, Dh = 2, 260, 2, 16
    qkv = torch.from_numpy(g.standard_normal((B, L, 3 * H * Dh)).astype(
        np.float32))
    q, k, v = (z.reshape(B, L, H, Dh).transpose(1, 2)
               for z in qkv.chunk(3, dim=-1))
    assert not q.is_contiguous()
    want = j_ref(*(jnp.asarray(z.contiguous().numpy()) for z in (q, k, v)))
    got = attention(q, k, v)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


def test_bf16_matches_jax_ref():
    """Half precision: fp32 logits, probabilities rounded to bf16, fp32
    sums, as the JAX reference."""
    q, k, v = _qkv(1, 2, 48, 80, 64, seed=8)
    bf = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(j_ref(*bf).astype(jnp.float32))
    got = attention_ref(*(t.bfloat16() for t in _t(q, k, v)))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= 2e-2


@pytest.mark.parametrize("Lq,Lk,use_kernel,flash", [
    (256, 256, None, False),     # CPU tensor: plain form
    (256, 256, True, True),      # asked for: the wrapper (plain on CPU)
    (255, 300, True, False),     # too short for the kernel
    (300, 300, False, False),
])
def test_dispatch_rule(monkeypatch, Lq, Lk, use_kernel, flash):
    """The dispatcher takes the wrapper only without bias and with Lq, Lk
    >= 256, and on the CPU only when asked to."""
    import video_enhancer_tpu_torch.ops.attention as att

    calls = []
    monkeypatch.setattr(att, "flash_attention",
                        lambda *a, **kw: calls.append(1) or
                        att.attention_ref(*a, **kw))
    q, k, v = _t(*_qkv(1, 1, Lq, Lk, 16, seed=1))
    att.attention(q, k, v, use_kernel=use_kernel)
    att.attention(q, k, v, bias=torch.zeros(()), use_kernel=use_kernel)
    assert len(calls) == (1 if flash else 0)
