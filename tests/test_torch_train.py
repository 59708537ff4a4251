"""The port's training against the JAX package's, on the CPU: the losses,
the eight differentiable kernel wrappers, the optimizer, the train step,
checkpoints and the npz export.

Tolerances: the losses 1e-7 absolute; each gradient of the eight wrappers
within 1e-5 of max(1, its max abs) of ``jax.grad`` through JAX's custom
VJPs (whose forward runs its Pallas kernel in interpret mode, or the
reference off the TPU; the backward is the reference in both packages);
the optimizer 1e-6 absolute after each of 3 steps, on both sides of the
clip; tiny vsrm's step-1 gradients before the clip within ``GRAD_TOL`` of
the largest gradient's max abs and ``LEAF_TOL`` of each leaf's own, the
losses of steps 1 and 2 within 1e-5 and the parameters after two steps
within 4 x lr (Adam's first steps move a weight by about lr x sign(g), so a
gradient near zero may flip sign on rounding alone; the optimizer alone is
held to 1e-6); the exported parameters applied by JAX within 1e-5 of the
port's output. fp32 throughout.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from video_enhancer_tpu.models import fast_mamba_vsr as jfmv
from video_enhancer_tpu.models import rvrt as jrvrt
from video_enhancer_tpu.models import upscaler as jup
from video_enhancer_tpu.models import vsrm as jvsrm
from video_enhancer_tpu.ops import attention as jattn
from video_enhancer_tpu.ops import conv as jconv
from video_enhancer_tpu.ops import scan as jscan
from video_enhancer_tpu.ops import ssd as jssd
from video_enhancer_tpu.parallel.mesh import make_mesh as jmake_mesh
from video_enhancer_tpu.runtime.weights import flatten_params as jflatten
from video_enhancer_tpu.runtime.weights import try_load_params as jtry_load
from video_enhancer_tpu.train import losses as jlosses
from video_enhancer_tpu.train import step as jstep
from video_enhancer_tpu_torch.models import fast_mamba_vsr as tfmv
from video_enhancer_tpu_torch.models import rvrt as trvrt
from video_enhancer_tpu_torch.models import upscaler as tup
from video_enhancer_tpu_torch.models import vsrm as tvsrm
from video_enhancer_tpu_torch.ops import attention as tattn
from video_enhancer_tpu_torch.ops import conv as tconv
from video_enhancer_tpu_torch.ops import scan as tscan
from video_enhancer_tpu_torch.ops import ssd as tssd
from video_enhancer_tpu_torch.parallel.mesh import local_mesh
from video_enhancer_tpu_torch.runtime.weights import (convert_array,
                                                      flatten_params,
                                                      params_from_jax,
                                                      save_params,
                                                      to_jax_layout,
                                                      try_load_params)
from video_enhancer_tpu_torch.train import checkpoint as tckpt
from video_enhancer_tpu_torch.train import losses as tlosses
from video_enhancer_tpu_torch.train import step as tstep

F32 = np.float32
# tiny vsrm's step-1 gradients, port against JAX: measured 2.1e-5 of the
# largest leaf's max abs, and 2.7e-5 of a leaf's own max at worst
# (blocks.0.spatial_ssm.norm_scale), alike at 1 and 4 torch threads
# (scripts/port_grad_floor.py, which prints these readings).
# Perturbing the port's own parameters by half an ulp (a relative 6e-8
# normal draw, four seeds) moves its own gradients by 1.3e-5 to 4.1e-5 of
# the largest max, and by 1.7e-5 to 2.9e-4 of a leaf's own max
# (blocks.0.spatial_ssm.dt_bias_f), so no pair of fp32 implementations that
# sum in different orders agrees to 1e-5 of each leaf's max. The bounds sit
# just above that floor: GRAD_TOL of the largest max and LEAF_TOL of each
# leaf's own. A wrong gradient (such as the warp's at a zero flow before
# its tie rules matched JAX's: 0.8 of the offset conv's) reads orders of
# magnitude beyond them.
GRAD_TOL = 5e-5
LEAF_TOL = 1e-3


# --- losses -----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (2, 3, 8, 8, 3),
                                   (2, 1, 8, 8, 3)])
def test_losses_match_jax(shape):
    g = np.random.default_rng(0)
    pred, target = g.random(shape, F32), g.random(shape, F32)
    names = ["charbonnier_loss", "vsr_loss"]
    if shape[1] > 1:
        names.append("temporal_loss")
    for name in names:
        want = float(getattr(jlosses, name)(jnp.asarray(pred),
                                            jnp.asarray(target)))
        got = getattr(tlosses, name)(torch.from_numpy(pred),
                                     torch.from_numpy(target)).item()
        assert abs(got - want) <= 1e-7, (name, got, want)


# --- the eight differentiable kernel wrappers --------------------------------

def _scan_args(g, B=64, L=8, D=16, N=4):
    """x, dt, A, B, C, D of a Mamba-1 scan (JAX's and the port's layout)."""
    return [g.standard_normal((B, L, D)).astype(F32),
            g.uniform(0.05, 0.4, (B, L, D)).astype(F32),
            -g.uniform(0.5, 2.0, (D, N)).astype(F32),
            g.standard_normal((B, L, N)).astype(F32),
            g.standard_normal((B, L, N)).astype(F32),
            g.standard_normal(D).astype(F32)]


def _vjp_case(name, g):
    """(JAX's function, the port's, inputs in JAX's layouts, the key of each
    input for ``convert_array`` / ``to_jax_layout``, or None)."""
    if name.startswith("ssd"):
        rev = name.endswith("reverse")
        args = [g.standard_normal((2, 24, 2, 4)).astype(F32),
                g.uniform(0.01, 0.2, (2, 24, 2)).astype(F32),
                -g.uniform(0.5, 2.0, 2).astype(F32),
                g.standard_normal((2, 24, 4)).astype(F32),
                g.standard_normal((2, 24, 4)).astype(F32)]
        return (lambda *a: jssd.ssd_shared(*a, chunk=8, reverse=rev,
                                           use_pallas=True),
                lambda *a: tssd.ssd_shared(*a, chunk=8, reverse=rev,
                                           use_kernel=True), args, None)
    if name == "fused_bidir_ssm":
        B, L, D, N, K, r = 6, 5, 8, 4, 5, 2
        args = [g.standard_normal((B, L, D)).astype(F32),
                g.standard_normal((B, L, D)).astype(F32),
                (g.standard_normal((K, 1, D)) * 0.3).astype(F32),
                (g.standard_normal(D) * 0.1).astype(F32),
                (g.standard_normal((D, r + 2 * N)) * 0.3).astype(F32),
                (g.standard_normal((r, D)) * 0.3).astype(F32),
                *[(g.standard_normal(D) * 0.1 - c).astype(F32)
                  for c in (0.0, 2.0, 2.0)],
                -g.uniform(0.5, 2.0, (D, N)).astype(F32),
                -g.uniform(0.5, 2.0, (D, N)).astype(F32),
                g.standard_normal(D).astype(F32),
                g.standard_normal(D).astype(F32)]
        keys = [None, None, "m.conv_w", None, "x_proj.w", "dt_proj.w"] + \
            [None] * 7
        return (lambda *a: jscan.fused_bidir_ssm(*a, dt_rank=r),
                lambda *a: tscan.fused_bidir_ssm(*a, dt_rank=r), args, keys)
    if name == "flash_attention":
        args = [g.standard_normal((1, 2, 16, 8)).astype(F32) for _ in "qkv"]
        return jattn.attention, tattn.flash_attention, args, None
    if name == "window_attention":
        args = [g.standard_normal((4, 2, 16, 8)).astype(F32) for _ in "qkv"]
        args.append((g.standard_normal((2, 16, 16)) * 0.3).astype(F32))
        return (lambda *a: jattn.window_attention_diffable(*a, 8 ** -0.5),
                lambda *a: tattn.window_attention(*a, scale=8 ** -0.5), args,
                None)
    if name == "selective_scan_short_nostate":
        return (lambda *a: jscan.selective_scan_pallas_short(
                    *a, need_state=False)[0],
                lambda *a: tscan.selective_scan_pallas_short(
                    *a, need_state=False)[0], _scan_args(g), None)
    if name == "selective_scan_bidir":
        return (jscan.selective_scan_bidir, tscan.selective_scan_bidir,
                _scan_args(g) + _scan_args(g), None)
    if name == "selective_scan_bidir_shared":
        u, dtf, Af, Bm, Cm, Df = _scan_args(g)
        _, dtb, Ab, _, _, Db = _scan_args(g)
        return (lambda *a: jscan.selective_scan_bidir_shared(*a,
                                                             impl="bmajor"),
                lambda *a: tscan.selective_scan_bidir_shared(*a,
                                                             impl="bmajor"),
                [u, dtf, dtb, Af, Ab, Bm, Cm, Df, Db], None)
    assert name == "dwconv_silu"
    args = [g.standard_normal((2, 12, 8)).astype(F32),
            (g.standard_normal((4, 1, 8)) * 0.5).astype(F32),
            (g.standard_normal(8) * 0.1).astype(F32)]
    return (jconv.depthwise_conv1d_silu, tconv.depthwise_conv1d_silu, args,
            [None, "m.conv_w", None])


VJP_CASES = ["ssd_shared", "ssd_shared reverse", "fused_bidir_ssm",
             "flash_attention", "window_attention",
             "selective_scan_short_nostate", "selective_scan_bidir",
             "selective_scan_bidir_shared", "dwconv_silu"]


@pytest.mark.parametrize("name", VJP_CASES)
def test_kernel_wrapper_gradients_match_jax(name):
    g = np.random.default_rng(VJP_CASES.index(name))
    jfn, tfn, args, keys = _vjp_case(name, g)
    keys = keys or [None] * len(args)
    outs = jax.eval_shape(jfn, *map(jnp.asarray, args))
    single = not isinstance(outs, tuple)
    outs = (outs,) if single else outs
    gys = [g.standard_normal(o.shape).astype(F32) for o in outs]

    def loss(*a):
        ys = jfn(*a)
        ys = (ys,) if single else ys
        return sum(jnp.sum(y * gy) for y, gy in zip(ys, gys))

    with jax.default_matmul_precision("highest"):
        want = jax.jit(jax.grad(loss, argnums=tuple(range(len(args)))))(
            *map(jnp.asarray, args))
    xs = [convert_array(k, a) if k else torch.from_numpy(a.copy())
          for k, a in zip(keys, args)]
    xs = [x.requires_grad_() for x in xs]
    ys = tfn(*xs)
    ys = (ys,) if single else ys
    assert all(y.grad_fn is not None for y in ys)
    got = torch.autograd.grad(ys, xs, [torch.from_numpy(gy) for gy in gys])
    for k, a, w in zip(keys, got, want):
        a = to_jax_layout(k, a) if k else a.numpy()
        w = np.asarray(w)
        np.testing.assert_allclose(a, w, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(w).max()))


def test_wrappers_skip_the_function_without_grad():
    """Under no_grad, or with no input that requires grad, the wrapper's
    output is its plain output with no graph (serving pays nothing); under
    grad the plain form's gradients come back in the inputs' dtypes."""
    g = np.random.default_rng(0)
    x, dt, A, Bm, Cm, D = (torch.from_numpy(a) for a in _scan_args(g))
    y = tscan.selective_scan_pallas_short(x, dt, A, Bm, Cm, D,
                                          need_state=False)[0]
    assert y.grad_fn is None
    x16 = x.to(torch.bfloat16).requires_grad_()
    with torch.no_grad():
        assert tscan.selective_scan_pallas_short(
            x16, dt.bfloat16(), A, Bm.bfloat16(), Cm.bfloat16(), D,
            need_state=False)[0].grad_fn is None
    y = tscan.selective_scan_pallas_short(x16, dt.bfloat16(), A,
                                          Bm.bfloat16(), Cm.bfloat16(), D,
                                          need_state=False)[0]
    (gx,) = torch.autograd.grad(y.float().sum(), [x16])
    assert gx.dtype == torch.bfloat16 and gx.shape == x16.shape


# --- the optimizer ---------------------------------------------------------

@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["below_clip",
                                                     "above_clip"])
def test_optimizer_matches_optax(scale):
    """3 steps of ``make_optimizer()`` against optax's chain on the same
    parameters and gradients; the gradients' global norm below 1 (no clip)
    or above (clipped every step)."""
    g = np.random.default_rng(1)
    shapes = [(4, 3), (5,), (2, 3, 2)]
    params = [g.standard_normal(s).astype(F32) for s in shapes]
    grads = [[(g.standard_normal(s) * scale).astype(F32) for s in shapes]
             for _ in range(3)]
    norms = [math.sqrt(sum(float((a * a).sum()) for a in gs)) for gs in grads]
    assert all((n < 1) == (scale < 1) for n in norms)
    jopt = jstep.make_optimizer()
    jp = [jnp.asarray(p) for p in params]
    js = jopt.init(jp)
    topt = tstep.make_optimizer()
    tp = [torch.from_numpy(p.copy()) for p in params]
    ts = topt.init(tp)
    for gs in grads:
        upd, js = jopt.update([jnp.asarray(a) for a in gs], js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = topt.update([torch.from_numpy(a) for a in gs], ts, tp)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6)
    assert int(ts["count"]) == 3


# --- the train step --------------------------------------------------------

def _jit_init(init, seed, **kw):
    return jax.jit(lambda k: init(k, **kw)[0])(jax.random.PRNGKey(seed))


def _live(params, keys, seed):
    """JAX params with the zero-initialised convs ``keys`` drawn live."""
    for i, k in enumerate(keys):
        params[k]["w"] = jax.random.normal(jax.random.PRNGKey(seed + i),
                                           params[k]["w"].shape) * 0.05
    return params


def _port(jp):
    return params_from_jax({k: np.asarray(v) for k, v in jflatten(jp).items()})


@pytest.fixture(scope="module")
def vsrm_steps():
    """Tiny vsrm (dim 16, 1 block, x2) with live head and offset convs: JAX's
    step-1 gradients and two steps of its ``make_train_step`` on one
    batch."""
    jp = _live(_jit_init(jvsrm.init, 0, dim=16, num_blocks=1, scale=2),
               ("head", "offset"), 10)
    g = np.random.default_rng(2)
    batch = {"lr": g.random((2, 3, 8, 8, 3), F32),
             "hr": g.random((2, 3, 16, 16, 3), F32)}

    def apply(p, clip):
        return jvsrm.apply(p, clip, scale=2)

    with jax.default_matmul_precision("highest"):
        loss1, grads = jax.jit(jax.value_and_grad(
            lambda p, lr, hr: jlosses.vsr_loss(apply(p, lr), hr)))(
                jp, jnp.asarray(batch["lr"]), jnp.asarray(batch["hr"]))
        mesh = jmake_mesh()
        init_state, train_step, shard_batch = jstep.make_train_step(
            apply, jstep.make_optimizer(), mesh)
        with mesh:
            # placed as the step's outputs are, so that its second call
            # reuses the first one's compile
            state = jax.device_put(init_state(jp), NamedSharding(mesh, P()))
            b = shard_batch({k: jnp.asarray(v) for k, v in batch.items()})
            losses = []
            for _ in range(2):
                state, m = train_step(state, b)
                losses.append(float(m["loss"]))
    return {"params": jp, "batch": batch, "loss1": float(loss1),
            "grads": {k: np.asarray(v) for k, v in jflatten(grads).items()},
            "losses": losses,
            "after": {k: np.asarray(v)
                      for k, v in jflatten(state.params).items()}}


def test_train_step_matches_jax(vsrm_steps):
    ref = vsrm_steps
    params = _port(ref["params"])
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}

    def apply(p, clip):
        return tvsrm.apply(p, clip, scale=2)

    init_state, train_step, shard_batch = tstep.make_train_step(
        apply, tstep.make_optimizer(), local_mesh("cpu"))
    state = init_state(params)
    leaves = tstep.tree_leaves(state.params)
    loss = tlosses.vsr_loss(apply(state.params, batch["lr"]), batch["hr"])
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - ref["loss1"]) <= 1e-5
    keys = list(flatten_params(state.params))
    assert sorted(keys) == sorted(ref["grads"])
    top = max(np.abs(w).max() for w in ref["grads"].values())
    for k, gt in zip(keys, grads):
        want = ref["grads"][k]
        err = np.abs(to_jax_layout(k, gt) - want).max()
        own = np.abs(want).max()
        assert err <= GRAD_TOL * top and err <= LEAF_TOL * own, (
            k, err, own, top)
    b = shard_batch(ref["batch"])
    losses = []
    for _ in range(2):
        state, m = train_step(state, b)
        losses.append(m["loss"].item())
    assert m["loss"].ndim == 0 and int(state.step) == 2
    np.testing.assert_allclose(losses, ref["losses"], rtol=0, atol=1e-5)
    for k, v in flatten_params(state.params).items():
        assert v.requires_grad and v.is_leaf
        np.testing.assert_allclose(to_jax_layout(k, v), ref["after"][k],
                                   rtol=0, atol=4 * 2e-4, err_msg=k)


def _upscaler_step(lr=2e-4, features=8, s2d=2):
    params = tup.init(torch.Generator().manual_seed(0), features=features,
                      depth=1, s2d=s2d, scale=2)

    def apply_clip(p, clip):
        b, t = clip.shape[:2]
        out = tup.apply(p, clip.reshape((b * t,) + clip.shape[2:]), scale=2,
                        s2d=s2d)
        return out.reshape((b, t) + out.shape[1:])

    return params, tstep.make_train_step(
        apply_clip, tstep.make_optimizer(lr=lr), local_mesh("cpu"))


def test_training_step_reduces_loss():
    """The JAX package's scenario (tests/test_parity_extras.py): a few steps
    on a fixed batch reduce the loss."""
    params, (init_state, train_step, shard_batch) = _upscaler_step(
        lr=1e-3, features=16)
    hr = np.random.default_rng(0).random((2, 2, 32, 32, 3), F32)
    batch = shard_batch({"lr": hr[:, :, ::2, ::2], "hr": hr})
    state, losses = init_state(params), []
    for _ in range(8):
        state, m = train_step(state, batch)
        losses.append(m["loss"].item())
    assert losses[-1] < losses[0], losses


def test_train_step_after_a_served_forward():
    """A forward under ``inference_mode`` (as every handler serves) caches
    resize matrices that a later train step of the same shapes reuses; the
    cache holds normal tensors, so the step can save them for backward."""
    params = tfmv.init(torch.Generator().manual_seed(0), dim=8, num_layers=1,
                       scale=2)
    clip = torch.rand((1, 2, 8, 8, 3), generator=torch.Generator()
                      .manual_seed(1))
    with torch.inference_mode():
        tfmv.apply(params, clip, scale=2)
    init_state, train_step, shard_batch = tstep.make_train_step(
        lambda p, x: tfmv.apply(p, x, scale=2), tstep.make_optimizer(),
        local_mesh("cpu"))
    state, m = train_step(init_state(params), shard_batch(
        {"lr": clip, "hr": torch.rand((1, 2, 16, 16, 3))}))
    assert int(state.step) == 1 and torch.isfinite(m["loss"])


def test_loss_with_lr_keyword_gets_the_input_clip():
    params, _ = _upscaler_step()
    seen = {}

    def loss_fn(pred, hr, lr):
        seen["lr"] = lr
        return tlosses.vsr_loss(pred, hr)

    init_state, train_step, shard_batch = tstep.make_train_step(
        lambda p, c: c.repeat_interleave(2, 2).repeat_interleave(2, 3) * p,
        tstep.make_optimizer(), local_mesh("cpu"), loss_fn=loss_fn)
    batch = shard_batch({"lr": torch.ones(1, 2, 4, 4, 3),
                         "hr": torch.ones(1, 2, 8, 8, 3)})
    train_step(init_state(torch.tensor(0.5)), batch)
    assert seen["lr"] is batch["lr"]


# --- checkpoints and the export --------------------------------------------

def test_checkpoint_roundtrip_resume_and_keep(tmp_path):
    """The JAX package's roundtrip scenario (tests/test_parity_extras.py); a
    resume equals the straight run bit for bit; the three newest kept."""
    params, (init_state, train_step, shard_batch) = _upscaler_step()
    batch = shard_batch({"lr": torch.ones(1, 2, 8, 8, 3),
                         "hr": torch.ones(1, 2, 16, 16, 3)})
    ck = tmp_path / "ck"
    assert tckpt.latest_step(ck) is None
    assert tckpt.restore_checkpoint(ck, init_state(params)) is None
    state, _ = train_step(init_state(params), batch)
    assert tckpt.save_checkpoint(ck, state) == 1
    restored = tckpt.restore_checkpoint(ck, init_state(params))
    assert restored is not None and int(restored.step) == 1
    for a, b in zip(tstep.tree_leaves(state.params),
                    tstep.tree_leaves(restored.params)):
        assert torch.equal(a, b) and b.requires_grad
    straight, resumed = state, restored
    for step in range(2, 6):
        straight, _ = train_step(straight, batch)
        resumed, _ = train_step(resumed, batch)
        tckpt.save_checkpoint(ck, resumed)
    for t in ("params", "opt_state"):
        for a, b in zip(tstep.tree_leaves(getattr(straight, t)),
                        tstep.tree_leaves(getattr(resumed, t))):
            assert torch.equal(a, b)
    assert sorted(p.name for p in ck.iterdir()) == ["3", "4", "5"]
    assert tckpt.latest_step(ck) == 5


def _exported(name):
    """(the port's seeded params with live zero-init layers, JAX's init
    shapes, JAX's apply, the port's apply) of a tiny model."""
    gen = torch.Generator().manual_seed(3)
    if name == "vsrm":
        p = tvsrm.init(gen, dim=16, num_blocks=1, scale=2)
        shapes = jax.eval_shape(lambda: jvsrm.init(
            jax.random.PRNGKey(0), dim=16, num_blocks=1, scale=2)[0])
        live, jf = ("head", "offset"), (lambda q, x: jvsrm.apply(q, x,
                                                                 scale=2))
        tf = lambda q, x: tvsrm.apply(q, x, scale=2)         # noqa: E731
    elif name == "fast_mamba_vsr":
        p = tfmv.init(gen, dim=8, num_layers=2, scale=2)
        shapes = jax.eval_shape(lambda: jfmv.init(
            jax.random.PRNGKey(0), dim=8, num_layers=2, scale=2)[0])
        live, jf = ("head", "temporal"), (lambda q, x: jfmv.apply(q, x,
                                                                  scale=2))
        tf = lambda q, x: tfmv.apply(q, x, scale=2)          # noqa: E731
    elif name == "rvrt":
        p = trvrt.init(gen, dim=16, depth=2, heads=2, scale=2)
        shapes = jax.eval_shape(lambda: jrvrt.init(
            jax.random.PRNGKey(0), dim=16, depth=2, heads=2, scale=2)[0])
        live = ("head",)
        jf = lambda q, x: jrvrt.apply(q, x, scale=2, heads=2)  # noqa: E731
        tf = lambda q, x: trvrt.apply(q, x, scale=2, heads=2)  # noqa: E731
    else:
        p = tup.init(gen, features=8, depth=1, s2d=2, scale=2)
        shapes = jax.eval_shape(lambda: jup.init(
            jax.random.PRNGKey(0), features=8, depth=1, s2d=2, scale=2)[0])
        live = ("head",)
        jf = lambda q, x: jup.apply(q, x[0], scale=2, s2d=2)[None]  # noqa
        tf = lambda q, x: tup.apply(q, x[0], scale=2, s2d=2)[None]  # noqa
    for k in live:
        p[k]["w"] = torch.randn(p[k]["w"].shape, generator=gen) * 0.05
    return p, shapes, jf, tf


def _shape_leaves(tree, prefix=""):
    """JAX's ``flatten_params`` keys of a tree of shapes."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _shape_leaves(sub, f"{prefix}{key}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _shape_leaves(sub, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("name", ["vsrm", "fast_mamba_vsr", "rvrt",
                                  "cnn_upscaler"])
def test_export_loads_into_jax(name, tmp_path):
    """The port's ``export_params`` of a trained state has exactly JAX's keys
    and shapes; JAX's ``try_load_params`` loads it and JAX's apply on it
    equals the port's; the port's ``try_load_params`` reads it back."""
    p, shapes, jf, tf = _exported(name)
    init_state, _, _ = tstep.make_train_step(tf, tstep.make_optimizer(),
                                             local_mesh("cpu"))
    path = tckpt.export_params(tmp_path / f"{name}.npz", init_state(p))
    flat = dict(np.load(path))
    want = {k: tuple(v.shape) for k, v in _shape_leaves(shapes).items()}
    assert {k: v.shape for k, v in flat.items()} == want
    jp = jtry_load(path, shapes)
    assert jp is not None
    clip = np.random.default_rng(4).random((1, 4, 16, 16, 3), F32)
    with jax.default_matmul_precision("highest"):
        y_j = np.asarray(jax.jit(jf)(jp, jnp.asarray(clip)))
    with torch.no_grad():
        y_t = tf(p, torch.from_numpy(clip)).numpy()
    np.testing.assert_allclose(y_t, y_j, rtol=0, atol=1e-5)
    zeros = tstep.tree_unflatten(p, [torch.zeros_like(t)
                                     for t in tstep.tree_leaves(p)])
    back = flatten_params(try_load_params(path, zeros))
    for k, v in flatten_params(p).items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("op", ["flow_warp_local", "clip"])
def test_subgradients_at_ties_match_jax(op):
    """Where JAX's gradient depends on its subgradient at a tie: vsrm's
    sub-pixel warp at a zero flow (its offset conv starts at zero) and the
    models' final clip at pixels exactly on a bound."""
    from video_enhancer_tpu.ops.warp import flow_warp_local as jwarp
    from video_enhancer_tpu_torch.nn import clip
    from video_enhancer_tpu_torch.ops.warp import flow_warp_local as twarp

    g = np.random.default_rng(6)
    if op == "flow_warp_local":
        args = [g.random((2, 5, 6, 3), F32), np.zeros((2, 5, 6, 2), F32)]
        args[1][0, 1] = [[0.25, -1.0]] * 6
        jfn, tfn = jwarp, twarp
    else:
        x = g.choice(np.array([-0.5, 0.0, 0.3, 1.0, 1.5], F32), (4, 5))
        args = [x]
        jfn, tfn = (lambda a: jnp.clip(a, 0.0, 1.0)), (lambda a: clip(a, 0.0,
                                                                   1.0))
    gy = g.standard_normal(args[0].shape).astype(F32)
    want = jax.jit(jax.grad(lambda *a: jnp.sum(jfn(*a) * gy),
                            argnums=tuple(range(len(args)))))(
        *map(jnp.asarray, args))
    xs = [torch.from_numpy(a.copy()).requires_grad_() for a in args]
    got = torch.autograd.grad((tfn(*xs) * torch.from_numpy(gy)).sum(), xs)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("op", ["flow_warp_local", "clip"])
def test_tie_rules_leave_the_served_values(op):
    """The warp and the clip give the same values bit for bit where
    autograd records them (JAX's tie rules) and where it does not (the
    served form, one clamp), and JAX's values within 1e-6."""
    from video_enhancer_tpu.ops.warp import flow_warp_local as jwarp
    from video_enhancer_tpu_torch.nn import clip
    from video_enhancer_tpu_torch.ops.warp import flow_warp_local as twarp

    g = np.random.default_rng(7)
    if op == "flow_warp_local":
        args = [g.random((2, 5, 6, 3), F32),
                g.choice(np.array([-1.5, -1.0, -0.25, 0.0, 0.5, 1.0], F32),
                         (2, 5, 6, 2))]
        jfn, tfn = jwarp, twarp
    else:
        args = [g.choice(np.array([-0.5, 0.0, 0.3, 1.0, 1.5], F32), (4, 5))]
        jfn, tfn = (lambda a: jnp.clip(a, 0.0, 1.0)), (lambda a: clip(a, 0.0,
                                                                   1.0))
    with torch.inference_mode():
        served = tfn(*(torch.from_numpy(a) for a in args))
    with torch.enable_grad():
        recorded = tfn(*(torch.from_numpy(a).requires_grad_() for a in args))
    assert recorded.grad_fn is not None
    assert torch.equal(served, recorded.detach())
    np.testing.assert_allclose(served.numpy(), np.asarray(jfn(*args)),
                               rtol=0, atol=1e-6)


def test_save_params_inverts_convert_array(tmp_path):
    """Each layout rule of ``convert_array`` and its inverse, key by key."""
    g = np.random.default_rng(5)
    flat = {"a.conv_w": g.random((4, 1, 6), F32),
            "b.w": g.random((1, 3, 3, 2, 5), F32),
            "c.w": g.random((3, 3, 2, 5), F32), "d.w": g.random((4, 7), F32),
            "e.scale": g.random(7, F32), "f.b": g.random(5, F32)}
    path = save_params(tmp_path / "sub" / "p.npz", params_from_jax(flat))
    back = dict(np.load(path))
    assert back.keys() == flat.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v)
