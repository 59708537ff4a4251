"""TPU kernel row 11 (``_dwconv_silu_kernel``) against the JAX package, on
the CPU: the port's ``depthwise_conv1d_silu`` (its plain version for a CPU
tensor, which the CUDA kernel is held against on the card) against the
Pallas kernel in interpret mode, ``bissd_apply(conv_impl="pallas")`` with
JAX-initialised parameters carried across, and vsrm with the conv swapped
on both sides (``bissd_apply`` rebound in each package's model module, as
the JAX package's ``scripts/ab_bissd_conv.py`` does) on the bundled
weights. Tolerance 1e-5 absolute, fp32: the same fp32 sums in another
order.
"""

from __future__ import annotations

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_enhancer_tpu.models import vsrm as jvsrm
from video_enhancer_tpu.nn import ssm as jssm
from video_enhancer_tpu.ops import conv as jconv
from video_enhancer_tpu.runtime.weights import flatten_params, unflatten_into
from video_enhancer_tpu_torch.models import vsrm as tvsrm
from video_enhancer_tpu_torch.nn import ssm as tssm
from video_enhancer_tpu_torch.ops import conv as tconv
from video_enhancer_tpu_torch.runtime.registry import load_params
from video_enhancer_tpu_torch.runtime.weights import params_from_jax

TOL = 1e-5
NPZ = (Path(__file__).resolve().parents[1] / "video_enhancer_tpu" / "weights"
       / "vsrm_4x.npz")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("L,K,strided", [(70, 5, False), (64, 4, False),
                                         (37, 3, False), (70, 5, True)])
def test_plain_matches_pallas_kernel(L, K, strided):
    """Chunk-boundary halos (chunk 32), ragged tails, the asymmetric SAME
    padding of an even K, and x as a column slice of a wider tensor (rows
    strided, as bissd hands the kernel a slice of in_proj's output)."""
    g = np.random.default_rng(L + K)
    C = 16
    wide = g.standard_normal((3, L, C + 7)).astype(np.float32)
    x = wide[..., 3:3 + C] if strided else np.ascontiguousarray(
        wide[..., :C])
    w = (g.standard_normal((K, 1, C)) * 0.4).astype(np.float32)
    b = (g.standard_normal(C) * 0.1).astype(np.float32)
    want = jconv._dwconv_silu_impl(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b), chunk=32, interpret=True)
    xt = torch.from_numpy(wide)[..., 3:3 + C] if strided else \
        torch.from_numpy(x)
    assert xt.is_contiguous() != strided
    got = tconv.depthwise_conv1d_silu(
        xt, torch.from_numpy(w).permute(2, 1, 0).contiguous(),
        torch.from_numpy(b))
    assert got.shape == (3, L, C) and got.dtype == torch.float32
    _close(got, want)


def test_bissd_pallas_conv_matches_jax():
    """``bissd_apply(conv_impl="pallas")`` against JAX's, and against the
    port's grouped path (the same function in fp32)."""
    jp = jssm.bissd_init(jax.random.PRNGKey(3), 16, state_dim=8,
                         head_dim=16)
    x = np.random.default_rng(3).standard_normal((2, 40, 16)).astype(
        np.float32)
    want = jssm.bissd_apply(jp, jnp.asarray(x), chunk=16, conv_impl="pallas")
    tp = params_from_jax({k: np.asarray(v)
                          for k, v in flatten_params(jp).items()})
    xt = torch.from_numpy(x)
    got = tssm.bissd_apply(tp, xt, chunk=16, conv_impl="pallas")
    _close(got, want)
    _close(tssm.bissd_apply(tp, xt, chunk=16), got)
    with pytest.raises(ValueError, match="unknown conv_impl"):
        tssm.bissd_apply(tp, xt, chunk=16, conv_impl="unrolled")


def test_vsrm_with_the_pallas_conv_matches_jax(monkeypatch):
    """vsrm on the bundled weights with every block's spatial SSD on the
    conv kernel's counterpart, in both packages."""
    monkeypatch.setattr(jvsrm, "bissd_apply", functools.partial(
        jvsrm.bissd_apply, conv_impl="pallas"))
    monkeypatch.setattr(tvsrm, "bissd_apply", functools.partial(
        tvsrm.bissd_apply, conv_impl="pallas"))
    # the checkpoint fills every leaf, so the init's shapes suffice
    shapes = jax.eval_shape(lambda: jvsrm.init(
        jax.random.PRNGKey(0), dim=64, num_blocks=6, scale=4)[0])
    jp, _, skipped = unflatten_into(shapes, dict(np.load(NPZ)))
    assert not skipped
    clip = np.random.default_rng(5).random((1, 3, 24, 32, 3),
                                           dtype=np.float32)
    want = np.asarray(jax.jit(functools.partial(jvsrm.apply, scale=4))(
        jp, jnp.asarray(clip)))
    with torch.inference_mode():
        got = tvsrm.apply(load_params("vsrm"), torch.from_numpy(clip),
                          scale=4)
    assert got.shape == (1, 3, 96, 128, 3)
    _close(got, want)
