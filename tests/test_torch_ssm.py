"""The port's Mamba-1 layers against the JAX package, on the CPU: ``ssm_apply``
in both directions, ``bimamba_apply`` on short and long sequences,
``bissm_apply(impl="composed")``, and ``depthwise_conv1d``'s explicit
padding. Parameters come from the JAX package's own init, carried across by
the port's checkpoint converter (``runtime/weights.py``). On the CPU the
port's scans take their plain versions, as JAX's do off the TPU (the
sequential scan for L <= 32, the associative scan above). Tolerance 1e-4
absolute, fp32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_enhancer_tpu.nn import ssm as jssm
from video_enhancer_tpu.ops import conv as jconv
from video_enhancer_tpu.runtime.weights import flatten_params
from video_enhancer_tpu_torch.nn import ssm as tssm
from video_enhancer_tpu_torch.ops import conv as tconv
from video_enhancer_tpu_torch.runtime.weights import params_from_jax

TOL = 1e-4


def _convert(jp):
    return params_from_jax({k: np.asarray(v)
                            for k, v in flatten_params(jp).items()})


def _x(B, L, dim, seed):
    return np.random.default_rng(seed).standard_normal((B, L, dim)).astype(
        np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


def test_params_carry_across_in_the_port_layout():
    """``ssm_init``'s conv_w (K, 1, C) becomes Conv1d's (C, 1, K), dense
    weights (in, out) become (out, in); dt_bias, A_log and D stay; bimamba
    keeps its fwd / bwd / fuse nesting; the port's own init has the same
    shapes."""
    jp = jssm.bimamba_init(jax.random.PRNGKey(0), 16, state_dim=8,
                           conv_kernel=4)
    tp = _convert(jp)
    mine = tssm.bimamba_init(torch.Generator().manual_seed(0), 16,
                             state_dim=8, conv_kernel=4)
    assert set(tp) == set(mine) == {"fwd", "bwd", "fuse"}
    for d in ("fwd", "bwd"):
        j, t = jp[d], tp[d]
        np.testing.assert_array_equal(
            t["conv_w"].numpy(), np.transpose(np.asarray(j["conv_w"]),
                                              (2, 1, 0)))
        np.testing.assert_array_equal(t["in_proj"]["w"].numpy(),
                                      np.asarray(j["in_proj"]["w"]).T)
        for k in ("dt_bias", "A_log", "D", "conv_b"):
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
        for k, v in t.items():
            want = mine[d][k]
            if isinstance(v, dict):
                assert {kk: tuple(vv.shape) for kk, vv in v.items()} == \
                    {kk: tuple(vv.shape) for kk, vv in want.items()}, k
            else:
                assert v.shape == want.shape, k
    assert tuple(tp["fuse"]["w"].shape) == (16, 32)


@pytest.mark.parametrize("padding", ["SAME", ((3, 0),), ((0, 3),), ((1, 2),)])
def test_depthwise_conv1d_padding_matches_jax(padding):
    g = np.random.default_rng(1)
    x = g.standard_normal((2, 9, 6)).astype(np.float32)
    w = g.standard_normal((4, 1, 6)).astype(np.float32)
    b = g.standard_normal(6).astype(np.float32)
    want = jconv.depthwise_conv1d(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b), padding=padding)
    got = tconv.depthwise_conv1d(torch.from_numpy(x),
                                 torch.from_numpy(w).permute(2, 1, 0),
                                 torch.from_numpy(b), padding=padding)
    _close(got, want)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("L", [7, 45])
def test_ssm_apply_matches_jax(reverse, L):
    jp = jssm.ssm_init(jax.random.PRNGKey(L), 16, state_dim=8)
    x = _x(3, L, 16, seed=L + reverse)
    want = jssm.ssm_apply(jp, jnp.asarray(x), reverse=reverse)
    got = tssm.ssm_apply(_convert(jp), torch.from_numpy(x), reverse=reverse)
    _close(got, want)


@pytest.mark.parametrize("L", [7, 40])
def test_bimamba_apply_matches_jax(L):
    jp = jssm.bimamba_init(jax.random.PRNGKey(L), 16)
    x = _x(4, L, 16, seed=L)
    want = jssm.bimamba_apply(jp, jnp.asarray(x))
    got = tssm.bimamba_apply(_convert(jp), torch.from_numpy(x))
    _close(got, want)


@pytest.mark.parametrize("dim,L", [(16, 7), (32, 16)])
def test_bissm_composed_matches_jax_and_fused(dim, L):
    """``bissm_apply(impl="composed")`` against JAX's composed path, and
    against the port's fused path (its plain version on the CPU)."""
    jp = jssm.bissm_init(jax.random.PRNGKey(dim), dim, state_dim=4)
    x = _x(5, L, dim, seed=dim)
    want = jssm.bissm_apply(jp, jnp.asarray(x), impl="composed")
    tp = _convert(jp)
    got = tssm.bissm_apply(tp, torch.from_numpy(x), impl="composed")
    _close(got, want)
    for impl in ("fused", "plain"):
        _close(tssm.bissm_apply(tp, torch.from_numpy(x), impl=impl), want)
    with pytest.raises(ValueError, match="unknown impl"):
        tssm.bissm_apply(tp, torch.from_numpy(x), impl="bmajor")
