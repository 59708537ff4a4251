"""The port's fused bidirectional SSM and the two SSM layers of VSRM against
the JAX package, on the CPU.

The JAX side runs the fused Pallas kernel (``fused_bidir_ssm(...,
interpret=True)``, TPU kernel #3) and ``bissd_apply(use_pallas=True)`` (the
SSD kernel in interpret mode). Parameters come from the JAX package's own
init, converted by the port's checkpoint converter. Tolerance 1e-4
absolute, fp32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_enhancer_tpu.nn import ssm as jssm
from video_enhancer_tpu.ops import scan as jscan
from video_enhancer_tpu.runtime.weights import flatten_params
from video_enhancer_tpu_torch.nn import ssm as tssm
from video_enhancer_tpu_torch.ops import scan as tscan
from video_enhancer_tpu_torch.runtime.weights import params_from_jax

TOL = 1e-4


def _fused_args(B, L, D, N, K, r, seed=0):
    g = np.random.default_rng(seed)

    def rnd(*shape, scale=1.0):
        return (g.standard_normal(shape) * scale).astype(np.float32)

    return dict(u=rnd(B, L, D), gate=rnd(B, L, D), cw=rnd(K, 1, D, scale=0.3),
                cb=rnd(D, scale=0.1), wx=rnd(D, r + 2 * N, scale=0.2),
                wdt=rnd(r, D, scale=0.2), bdt=rnd(D, scale=0.1),
                dtbf=rnd(D, scale=0.1), dtbb=rnd(D, scale=0.1),
                Af=-np.exp(rnd(D, N, scale=0.3)),
                Ab=-np.exp(rnd(D, N, scale=0.3)), Df=rnd(D), Db=rnd(D))


def _port_fused_args(a):
    """JAX layouts -> the port's: cw (K,1,D)->(D,1,K), wx (D,R)->(R,D),
    wdt (r,D)->(D,r)."""
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    t["cw"] = t["cw"].permute(2, 1, 0).contiguous()
    t["wx"] = t["wx"].t().contiguous()
    t["wdt"] = t["wdt"].t().contiguous()
    return t


ORDER = ("u", "gate", "cw", "cb", "wx", "wdt", "bdt", "dtbf", "dtbb", "Af",
         "Ab", "Df", "Db")


@pytest.mark.parametrize("B,L,D,N,K,r", [(12, 7, 16, 4, 5, 2),
                                         (12, 7, 16, 4, 4, 2),
                                         (9, 3, 32, 8, 5, 4)])
def test_fused_matches_pallas_kernel_interpret(B, L, D, N, K, r):
    a = _fused_args(B, L, D, N, K, r, seed=B + L + K)
    want = jscan.fused_bidir_ssm(*(jnp.asarray(a[k]) for k in ORDER), r,
                                 interpret=True)
    t = _port_fused_args(a)
    got = tscan.fused_bidir_ssm(*(t[k] for k in ORDER), r)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("reverse", [False, True])
def test_selective_scan_matches_reference(reverse):
    g = np.random.default_rng(11)
    B, L, D, N = 5, 6, 8, 4
    x = g.standard_normal((B, L, D)).astype(np.float32)
    dt = g.uniform(0.01, 0.5, (B, L, D)).astype(np.float32)
    A = -g.uniform(0.1, 2.0, (D, N)).astype(np.float32)
    Bm, Cm = (g.standard_normal((B, L, N)).astype(np.float32) for _ in "BC")
    Dv = g.standard_normal(D).astype(np.float32)
    flip = (lambda v: v[:, ::-1].copy()) if reverse else (lambda v: v)
    want, _ = jscan.selective_scan_ref(*(jnp.asarray(flip(v))
                                         for v in (x, dt)), jnp.asarray(A),
                                       *(jnp.asarray(flip(v))
                                         for v in (Bm, Cm)), jnp.asarray(Dv))
    got, _ = tscan.selective_scan_plain(
        *(torch.from_numpy(v) for v in (x, dt, A, Bm, Cm, Dv)),
        reverse=reverse)
    np.testing.assert_allclose(got.numpy(), flip(np.asarray(want)), atol=TOL,
                               rtol=0)


def _convert(jp):
    flat = {k: np.asarray(v) for k, v in flatten_params(jp).items()}
    return params_from_jax(flat)


@pytest.mark.parametrize("dim", [16, 32])
def test_bissm_apply_matches_jax(dim):
    jp = jssm.bissm_init(jax.random.PRNGKey(dim), dim, state_dim=4)
    x = np.random.default_rng(dim).standard_normal((6, 7, dim)).astype(
        np.float32)
    want = jssm.bissm_apply(jp, jnp.asarray(x), interpret=True)
    got = tssm.bissm_apply(_convert(jp), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("dim,state_dim,L", [(32, 16, 100), (64, 8, 70)])
def test_bissd_apply_matches_jax(dim, state_dim, L):
    jp = jssm.bissd_init(jax.random.PRNGKey(dim), dim, state_dim=state_dim,
                         head_dim=64)
    x = np.random.default_rng(L).standard_normal((2, L, dim)).astype(
        np.float32)
    want = jssm.bissd_apply(jp, jnp.asarray(x), chunk=32, use_pallas=True)
    tp = _convert(jp)
    for use_kernel in (True, False):
        got = tssm.bissd_apply(tp, torch.from_numpy(x), chunk=32,
                               use_kernel=use_kernel)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=0)
