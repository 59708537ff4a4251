"""The port's analytic FLOP records and its timing helper against the JAX
package's, on the CPU.

For each of the eight JAX wrappers that record FLOPs (flash and window
attention, four selective scans, the fused bidirectional SSM and the SSD
on its kernel path), the port's count around one call on CPU tensors
equals JAX's ``accounting()`` around ``jax.jit(f).lower(...)`` on the same
shapes (exact: both are sums of the same products of ints). So do the
counts of tiny vsrm and fast_mamba_vsr forwards, with JAX's SSD on its
kernel path (``use_pallas=True``, its TPU rule for bf16 input), the path
the port's models take. ``device_time_per_call`` runs on the CPU with the
JAX test's scenario, its floor at the H100's peak.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_enhancer_tpu.models import fast_mamba_vsr as jfmv
from video_enhancer_tpu.models import vsrm as jvsrm
from video_enhancer_tpu.nn import ssm as jssm
from video_enhancer_tpu.ops import attention as jattn
from video_enhancer_tpu.ops import scan as jscan
from video_enhancer_tpu.ops import ssd as jssd
from video_enhancer_tpu.utils import flops as jflops
from video_enhancer_tpu_torch.models import fast_mamba_vsr as tfmv
from video_enhancer_tpu_torch.models import vsrm as tvsrm
from video_enhancer_tpu_torch.ops import attention as tattn
from video_enhancer_tpu_torch.ops import scan as tscan
from video_enhancer_tpu_torch.ops import ssd as tssd
from video_enhancer_tpu_torch.utils import flops as tflops
from video_enhancer_tpu_torch.utils.timing import (H100_BF16_PEAK_FLOPS,
                                                   device_time_per_call)


@pytest.mark.parametrize("mod", [tflops, jflops], ids=["torch", "jax"])
def test_record_scopes_nest_as_in_jax(mod):
    mod.record(123.0)                  # outside a scope: a no-op
    with mod.accounting() as acc:
        mod.record(2.0)
        with mod.accounting() as inner:
            mod.record(5.0)
        assert inner[0] == 5.0
    assert acc[0] == 2.0               # the inner scope did not leak out


def _rnd(g, *shape, lo=None):
    if lo is not None:
        return g.uniform(lo, 0.3, shape).astype(np.float32)
    return g.standard_normal(shape).astype(np.float32)


def _attention(g):
    q, k, v = _rnd(g, 2, 2, 40, 16), _rnd(g, 2, 2, 56, 16), _rnd(g, 2, 2, 56,
                                                                  16)
    return ((lambda *a: jattn.flash_attention(*a)),
            (lambda *a: tattn.flash_attention(*a)), [q, k, v])


def _window(g):
    a = [_rnd(g, 3, 2, 32, 8) for _ in range(3)] + [_rnd(g, 2, 32, 32)]
    return ((lambda *a: jattn.window_attention(*a)),
            (lambda *a: tattn.window_attention(*a)), a)


def _scan(g, B=12, L=6, D=8, N=4):
    return [_rnd(g, B, L, D), _rnd(g, B, L, D, lo=0.01),
            -np.abs(_rnd(g, D, N)) - 0.1, _rnd(g, B, L, N), _rnd(g, B, L, N),
            _rnd(g, D)]


def _short(g):
    return ((lambda *a: jscan.selective_scan_pallas_short(
                *a, need_state=False)[0]),
            (lambda *a: tscan.selective_scan_pallas_short(
                *a, need_state=False)[0]), _scan(g))


def _long(g):
    return ((lambda *a: jscan.selective_scan_pallas(*a)[0]),
            (lambda *a: tscan.selective_scan_pallas(*a)[0]), _scan(g, L=40))


def _bidir(g):
    return ((lambda *a: jscan.selective_scan_bidir(*a)[0]),
            (lambda *a: tscan.selective_scan_bidir(*a)[0]),
            _scan(g) + _scan(g))


def _shared(impl):
    def make(g):
        x, dtf, Af, Bm, Cm, Df = _scan(g)
        args = [x, dtf, _rnd(g, *dtf.shape, lo=0.01), Af, Af * 0.5, Bm, Cm,
                Df, -Df]
        return ((lambda *a: jscan.selective_scan_bidir_shared(
                    *a, impl=impl)),
                (lambda *a: tscan.selective_scan_bidir_shared(*a, impl=impl)),
                args)
    return make


# (B, L, D, N, K, dt_rank); JAX's layouts: cw (K, 1, D), wx (D, R), wdt
# (r, D); the port's: cw (D, 1, K), wx (R, D), wdt (D, r)
FUSED = (9, 5, 16, 4, 5, 2)


def _fused(g):
    B, L, D, N, K, r = FUSED
    j = [_rnd(g, B, L, D), _rnd(g, B, L, D), _rnd(g, K, 1, D), _rnd(g, D),
         _rnd(g, D, r + 2 * N), _rnd(g, r, D), _rnd(g, D), _rnd(g, D),
         _rnd(g, D), -np.abs(_rnd(g, D, N)) - 0.1,
         -np.abs(_rnd(g, D, N)) - 0.1, _rnd(g, D), _rnd(g, D)]
    port = {2: lambda w: w.permute(2, 1, 0), 4: lambda w: w.t(),
            5: lambda w: w.t()}

    def tfused(*a):
        a = [port.get(i, lambda w: w)(t).contiguous() for i, t in
             enumerate(a)]
        return tscan.fused_bidir_ssm(*a, r)
    return (lambda *a: jscan.fused_bidir_ssm(*a, r)), tfused, j


def _ssd(use):
    def make(g):
        b, L, H, P, N = 2, 40, 2, 8, 4
        args = [_rnd(g, b, L, H, P), _rnd(g, b, L, H, lo=0.01),
                -np.abs(_rnd(g, H)) - 0.1, _rnd(g, b, L, N), _rnd(g, b, L, N)]
        return ((lambda *a: jssd.ssd_shared(*a, chunk=16, use_pallas=use)),
                (lambda *a: tssd.ssd_shared(*a, chunk=16, use_kernel=use)),
                args)
    return make


SITES = {"flash_attention": _attention, "window_attention": _window,
         "selective_scan_pallas_short": _short,
         "selective_scan_pallas": _long, "selective_scan_bidir": _bidir,
         "selective_scan_bidir_shared:bmajor": _shared("bmajor"),
         "selective_scan_bidir_shared:bidir": _shared("bidir"),
         "fused_bidir_ssm": _fused, "ssd_shared:kernel": _ssd(True),
         "ssd_shared:plain": _ssd(False)}


@pytest.mark.parametrize("site", sorted(SITES))
def test_each_site_records_what_jax_records(site):
    jfn, tfn, args = SITES[site](np.random.default_rng(len(site)))
    with jflops.accounting() as want:
        jax.jit(jfn).lower(*(jnp.asarray(a) for a in args))
    with tflops.accounting() as got:
        tfn(*(torch.from_numpy(a) for a in args))
    assert got[0] == want[0]
    # the SSD records only on its kernel path, in both packages
    assert (want[0] > 0) == (site != "ssd_shared:plain")


def _jax_count(fn, init, clip):
    """JAX's count while lowering ``fn(params, clip)``, its parameters
    traced with ``jax.eval_shape`` (no eager init)."""
    params = jax.eval_shape(lambda k: init(k)[0], jax.random.PRNGKey(0))
    with jflops.accounting() as acc:
        jax.jit(fn).lower(params, jax.ShapeDtypeStruct(clip, jnp.float32))
    return acc[0]


def test_tiny_models_record_what_jax_records(monkeypatch):
    """vsrm (2 SSD scans and a fused SSM a block) and fast_mamba_vsr (a
    fused SSM a layer) at the validation widths."""
    monkeypatch.setattr(jvsrm, "bissd_apply", functools.partial(
        jssm.bissd_apply, use_pallas=True))
    clip = (1, 2, 16, 16, 3)
    gen = torch.Generator().manual_seed(0)
    cases = [
        (lambda k: jvsrm.init(k, dim=8, num_blocks=1, heads=2),
         lambda p, x: jvsrm.apply(p, x, scale=4, heads=2),
         tvsrm.init(gen, dim=8, num_blocks=1),
         lambda p, x: tvsrm.apply(p, x, scale=4, heads=2)),
        (lambda k: jfmv.init(k, dim=8, num_layers=1),
         lambda p, x: jfmv.apply(p, x, scale=4),
         tfmv.init(gen, dim=8, num_layers=1),
         lambda p, x: tfmv.apply(p, x, scale=4)),
    ]
    for jinit, jfn, tparams, tfn in cases:
        want = _jax_count(jfn, jinit, clip)
        with tflops.accounting() as got, torch.inference_mode():
            tfn(tparams, torch.zeros(clip))
        assert got[0] == want > 0


def test_timing_estimator_is_sane_on_cpu():
    """A positive finite slope, and never more than the H100's peak for
    the FLOPs it is told of (the JAX test's scenario, with the port's
    ceiling)."""
    a = torch.ones((256, 256))

    def f(a):
        return a @ a

    sec = device_time_per_call(f, a, n_small=2, n_large=6, repeats=2)
    assert np.isfinite(sec) and sec > 0
    huge = 1e18
    sec2 = device_time_per_call(f, a, n_small=2, n_large=6, repeats=2,
                                max_flops=huge)
    assert sec2 >= huge / H100_BF16_PEAK_FLOPS
    assert H100_BF16_PEAK_FLOPS == 989e12
