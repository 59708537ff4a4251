"""The port's meshes on ``torch.distributed`` against the JAX package's
``shard_map`` on the 8-device CPU mesh.

The time axis at two shards: each of its tests starts two ranks of a gloo
group, and at two shards every function meets both a global edge and an
interior boundary. The halo-approximate mesh path at a (data 1, time 2,
space 2) mesh: one launch of four ranks runs every check of it (the row
halo exchange, the three halo factories, the handler's mesh in fp32, the
registry's handler on a policy mesh). Ranks are fresh interpreters in which
JAX, OpenCV, PyYAML and the JAX package cannot be imported, one thread
each, a ``file://`` store under the test's temporary directory, every
collective bounded by a 120 s timeout and each process by 180 s; they get
seeded inputs and JAX-initialised parameters through ``.npz`` files, and
what each rank returns is compared with JAX's sharded functions and with
the port's single-device forms. Tolerances: 1e-5 absolute for the
exchanges, scans, layers, halo factories and vsrm, 1e-4 for
fast_mamba_vsr and its handler (the JAX package's own bounds,
tests/test_temporal_parallel.py), fp32; the registry's bf16 handler is
held to JAX's bound for the halo approximation, mean < 0.05. The
factories' shape checks run in this process against JAX's, with no ranks.
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from video_enhancer_tpu.models import fast_mamba_vsr as jfmv
from video_enhancer_tpu.models import vsrm as jvsrm
from video_enhancer_tpu.nn import ssm as jssm
from video_enhancer_tpu.parallel import inference as jinf
from video_enhancer_tpu.parallel import spatial as jspatial
from video_enhancer_tpu.parallel import temporal as jtemp
from video_enhancer_tpu.parallel.mesh import make_mesh as jmake_mesh
from video_enhancer_tpu.runtime.weights import flatten_params, unflatten_into
from video_enhancer_tpu_torch.models import fast_mamba_vsr as tfmv
from video_enhancer_tpu_torch.models import vsrm as tvsrm
from video_enhancer_tpu_torch.nn import ssm as tssm
from video_enhancer_tpu_torch.runtime.weights import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
RANKS = 2
TIMEOUT_S = 180

# A module set to None in sys.modules cannot be imported: the ranks run
# with JAX, OpenCV, PyYAML and the JAX package unavailable.
RANK = r"""
import sys
sys.path.insert(0, sys.argv[1])
for name in ("jax", "jaxlib", "cv2", "yaml", "video_enhancer_tpu"):
    sys.modules[name] = None
import numpy as np
import torch
torch.set_num_threads(1)
from video_enhancer_tpu_torch.parallel.mesh import make_mesh
from video_enhancer_tpu_torch.runtime.weights import params_from_jax

rank, store, work, what = int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
axis = make_mesh(time=%d, rank=rank, init_file=store, device="cpu",
                 timeout_s=120)
data = dict(np.load(f"{work}/inputs.npz"))
t = {k: torch.from_numpy(v) for k, v in data.items() if "." not in k}
params = params_from_jax({k: v for k, v in data.items() if "." in k})
n, idx = axis.size, axis.index


def local(a):
    s = a.shape[1] // n
    return a[:, idx * s:(idx + 1) * s]


def whole(a):
    return axis.all_gather(a, dim=1, tiled=True).numpy()


out = {}
try:
    if what == "primitives":
        from video_enhancer_tpu_torch.nn.ssm import (bimamba_apply_sharded,
                                                     bissm_apply_sharded)
        from video_enhancer_tpu_torch.parallel.temporal import (
            halo_exchange_time, make_temporal_scan, temporal_parallel_scan)
        for edge in ("replicate", "zero"):
            out[f"halo_{edge}"] = whole(
                halo_exchange_time(local(t["clip"]), 2, axis, edge=edge))
        args = [local(t[k]) for k in ("x", "dt")] + [t["A"]] + \
            [local(t[k]) for k in ("B", "C")] + [t["D"]]
        for rev in (False, True):
            out[f"scan_{rev}"] = whole(
                temporal_parallel_scan(*args, axis, reverse=rev))
        out["scan_whole"] = make_temporal_scan(axis)(
            *(t[k] for k in ("x", "dt", "A", "B", "C", "D"))).numpy()
        out["bimamba"] = whole(bimamba_apply_sharded(params["bimamba"],
                                                     local(t["seq"]), axis))
        out["bissm"] = whole(bissm_apply_sharded(params["bissm"],
                                                 local(t["seq"]), axis))
    else:
        from video_enhancer_tpu_torch.parallel.inference import (
            make_exact_sharded_fmv, make_exact_sharded_vsrm)
        make = (make_exact_sharded_fmv if what == "fmv"
                else make_exact_sharded_vsrm)
        fn = make(axis, scale=2)
        out["y"] = fn(params, t["clip"]).numpy()
        try:
            fn(params, t["clip"][:, :7])
        except ValueError as e:
            out["refused"] = np.array("not divisible" in str(e))
finally:
    axis.destroy()
np.savez(f"{work}/out_{rank}.npz", **out)
""" % RANKS


def _run_ranks(work: Path, what: str, arrays: dict, script: str = RANK,
               ranks: int = RANKS) -> list[dict]:
    """Every rank's outputs (each holds the whole result)."""
    np.savez(work / "inputs.npz", **arrays)
    store = work / "store"
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(ROOT), str(r), str(store),
         str(work), what], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env={**os.environ, "OMP_NUM_THREADS": "1"})
        for r in range(ranks)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return [dict(np.load(work / f"out_{r}.npz")) for r in range(ranks)]


def _flat(prefix: str, jp) -> dict:
    return {f"{prefix}{k}": np.asarray(v)
            for k, v in flatten_params(jp).items()}


def _port(jp):
    return params_from_jax(_flat("", jp))


def _sharded(fn):
    """``fn`` under shard_map over a two-shard time mesh: params and
    unsharded operands replicated, (B, T, ...) operands split along T."""
    mesh = jmake_mesh(time=RANKS)
    seq = P(None, "time")

    def run(*args, specs):
        f = shard_map(fn, mesh=mesh, in_specs=specs, out_specs=seq)
        with mesh:
            return np.asarray(jax.jit(f)(*args))

    return run


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=0)


def test_halo_scans_and_sharded_layers_match_jax(tmp_path, cpu_mesh_devices):
    """``halo_exchange_time`` with both edges, ``temporal_parallel_scan`` in
    both directions, ``make_temporal_scan``, ``bimamba_apply_sharded`` and
    ``bissm_apply_sharded``."""
    g = np.random.default_rng(0)
    f32 = np.float32
    B, L, D, N, dim = 3, 8, 4, 4, 8
    a = dict(clip=g.standard_normal((2, 8, 3, 2)).astype(f32),
             x=g.standard_normal((B, L, D)).astype(f32),
             dt=g.uniform(0.05, 0.5, (B, L, D)).astype(f32),
             A=-g.uniform(0.1, 1.0, (D, N)).astype(f32),
             B=g.standard_normal((B, L, N)).astype(f32),
             C=g.standard_normal((B, L, N)).astype(f32),
             D=g.standard_normal(D).astype(f32),
             seq=g.standard_normal((5, L, dim)).astype(f32))
    jb = jssm.bimamba_init(jax.random.PRNGKey(1), dim, state_dim=4)
    jq = jssm.bissm_init(jax.random.PRNGKey(2), dim, state_dim=4)
    outs = _run_ranks(tmp_path, "primitives",
                      {**a, **_flat("bimamba.", jb), **_flat("bissm.", jq)})
    j = {k: jnp.asarray(v) for k, v in a.items()}
    seq, rep = P(None, "time"), P()

    want = {}
    for edge in ("replicate", "zero"):
        want[f"halo_{edge}"] = _sharded(functools.partial(
            jtemp.halo_exchange_time, halo=2, edge=edge))(
                j["clip"], specs=(seq,))
    for rev in (False, True):
        want[f"scan_{rev}"] = _sharded(functools.partial(
            jtemp.temporal_parallel_scan, reverse=rev))(
                j["x"], j["dt"], j["A"], j["B"], j["C"], j["D"],
                specs=(seq, seq, rep, seq, seq, rep))
    want["scan_whole"] = want["scan_False"]
    want["bimamba"] = _sharded(jssm.bimamba_apply_sharded)(
        jb, j["seq"], specs=(rep, seq))
    want["bissm"] = _sharded(jssm.bissm_apply_sharded)(
        jq, j["seq"], specs=(rep, seq))
    for out in outs:
        assert set(out) == set(want)
        for k, v in want.items():
            _close(out[k], v, 1e-5)
    # and the sharded forms against the port's unsharded ones
    xs = torch.from_numpy(a["seq"])
    _close(outs[0]["bimamba"], tssm.bimamba_apply(_port(jb), xs), 1e-5)
    _close(outs[0]["bissm"], tssm.bissm_apply(_port(jq), xs), 1e-5)


def test_exact_sharded_fmv_matches_jax(tmp_path, cpu_mesh_devices):
    """``make_exact_sharded_fmv`` at dim 8, 2 layers, with live head and
    temporal weights, on a (1, 8, 16, 16, 3) clip."""
    params, _ = jfmv.init(jax.random.PRNGKey(3), dim=8, num_layers=2,
                          scale=2)
    params["head"]["w"] = jax.random.normal(
        jax.random.PRNGKey(4), params["head"]["w"].shape) * 0.05
    params["temporal"]["w"] = jax.random.normal(
        jax.random.PRNGKey(5), params["temporal"]["w"].shape) * 0.05
    clip = np.random.default_rng(2).random((1, 8, 16, 16, 3), np.float32)
    outs = _run_ranks(tmp_path, "fmv", {"clip": clip,
                                        **_flat("", params)})
    mesh = jmake_mesh(time=RANKS)
    with mesh:
        want = np.asarray(jinf.make_exact_sharded_fmv(mesh, scale=2)(
            params, jnp.asarray(clip)))
    single = tfmv.apply(_port(params), torch.from_numpy(clip), scale=2)
    for out in outs:
        _close(out["y"], want, 1e-4)
        _close(out["y"], single, 1e-4)
        assert bool(out["refused"])


def test_exact_sharded_vsrm_matches_jax(tmp_path, cpu_mesh_devices):
    """``make_exact_sharded_vsrm`` at dim 16, 2 blocks, with live head and
    offset weights, on a (1, 8, 8, 8, 3) clip."""
    params, _ = jvsrm.init(jax.random.PRNGKey(0), dim=16, num_blocks=2,
                           scale=2)
    for i, k in enumerate(("head", "offset")):
        params[k]["w"] = jax.random.normal(
            jax.random.PRNGKey(10 + i), params[k]["w"].shape) * 0.05
    clip = np.array(jax.random.uniform(jax.random.PRNGKey(1),
                                       (1, 8, 8, 8, 3)))
    outs = _run_ranks(tmp_path, "vsrm", {"clip": clip,
                                         **_flat("", params)})
    mesh = jmake_mesh(time=RANKS)
    with mesh:
        want = np.asarray(jinf.make_exact_sharded_vsrm(mesh, scale=2)(
            params, jnp.asarray(clip)))
    single = tvsrm.apply(_port(params), torch.from_numpy(clip), scale=2)
    for out in outs:
        _close(out["y"], want, 1e-5)
        _close(out["y"], single, 1e-5)
        assert bool(out["refused"])


# The halo-approximate mesh path at (data 1, time 2, space 2).
MESH = (1, 2, 2)

# The toy clip model of the halo checks, in both frameworks: a 3-tap
# stencil over T and one over H (zero padding), tanh, and a nearest x2
# upscale of H and W, so that the frame and row halos and the edge
# replication all show in the output.
TOY_SCALE = 2

MESH_RANK = r"""
import copy
import sys
sys.path.insert(0, sys.argv[1])
for name in ("jax", "jaxlib", "cv2", "yaml", "video_enhancer_tpu"):
    sys.modules[name] = None
import numpy as np
import torch
torch.set_num_threads(1)
from video_enhancer_tpu_torch.config import MeshConfig, Policy
from video_enhancer_tpu_torch.parallel.inference import (
    make_mesh_sharded_clip_fn, make_sharded_clip_fn)
from video_enhancer_tpu_torch.parallel.mesh import make_mesh
from video_enhancer_tpu_torch.parallel.spatial import (
    halo_exchange_space, make_spatially_sharded_clip_fn)
from video_enhancer_tpu_torch.models import fast_mamba_vsr
from video_enhancer_tpu_torch.runtime import registry
from video_enhancer_tpu_torch.runtime.calibration import calibrate_vsr
from video_enhancer_tpu_torch.runtime.vsr_handler import VSRHandler

rank, store, work = int(sys.argv[2]), sys.argv[3], sys.argv[4]
mesh = make_mesh(*%r, rank=rank, init_file=store, device="cpu",
                 timeout_s=120)
t = {k: torch.from_numpy(v) for k, v in np.load(f"{work}/inputs.npz").items()}


def toy(w, c):
    zt, zh = torch.zeros_like(c[:, :1]), torch.zeros_like(c[:, :, :1])
    pt, ph = torch.cat([zt, c, zt], 1), torch.cat([zh, c, zh], 2)
    y = torch.tanh(w[0] * c + w[1] * (pt[:, :-2] + pt[:, 2:])
                   + w[2] * (ph[:, :, :-2] + ph[:, :, 2:]))
    return y.repeat_interleave(%d, 2).repeat_interleave(%d, 3)


out = {"coords": np.array([mesh.axis(a).index
                           for a in ("data", "time", "space")]),
       "shape": np.array([mesh.shape[a] for a in ("data", "time", "space")])}
try:
    w, clip = t["w"], t["clip"]
    space = mesh.axis("space")
    out["halo_space"] = space.all_gather(halo_exchange_space(
        space.shard(clip, 2), 2, space), dim=2, tiled=True).numpy()
    out["spatial"] = make_spatially_sharded_clip_fn(
        toy, mesh, halo=2, scale=%d)(w, clip).numpy()
    out["sharded"] = make_sharded_clip_fn(toy, mesh, halo=1)(w, clip).numpy()
    out["mesh"] = make_mesh_sharded_clip_fn(
        toy, mesh, halo_t=1, halo_s=2, scale=%d)(w, clip).numpy()

    fmv = t["fmv_clip"]
    apply = calibrate_vsr("fast_mamba_vsr",
                          lambda p, x: fast_mamba_vsr.apply(p, x, scale=4))
    h = VSRHandler("fast_mamba_vsr", apply,
                   registry.load_params("fast_mamba_vsr"), scale=4, chunk=16,
                   overlap=2, dtype=torch.float32, device="cpu", mesh=mesh)
    out["handler"] = h.process_clip(fmv).numpy()
    single = copy.copy(h)
    single._sharded = None
    out["handler_single"] = single.process_clip(fmv).numpy()
    # T = 3 does not split over time: the handler serves it unsharded
    out["handler_t3"] = h.process_clip(fmv[:3]).numpy()
    out["single_t3"] = single.process_clip(fmv[:3]).numpy()

    policy = Policy(mesh=MeshConfig(*%r))
    rh = registry.build_handler("fast_mamba_vsr", policy, device="cpu")
    out["registry_mesh"] = np.array(
        [rh.mesh.shape[a] for a in ("data", "time", "space")])
    out["registry_cached"] = np.array(
        registry.build_handler("fast_mamba_vsr", policy, device="cpu") is rh
        and registry.build_handler("fast_mamba_vsr", device="cpu").mesh
        is None)
    out["registry"] = rh.process_clip(fmv).numpy()
    rs = copy.copy(rh)
    rs._sharded = None
    out["registry_single"] = rs.process_clip(fmv).numpy()
finally:
    mesh.destroy()
np.savez(f"{work}/out_{rank}.npz", **out)
""" % (MESH, TOY_SCALE, TOY_SCALE, TOY_SCALE, TOY_SCALE, MESH)


def _jtoy(w, c):
    pt = jnp.pad(c, ((0, 0), (1, 1), (0, 0), (0, 0), (0, 0)))
    ph = jnp.pad(c, ((0, 0), (0, 0), (1, 1), (0, 0), (0, 0)))
    y = jnp.tanh(w[0] * c + w[1] * (pt[:, :-2] + pt[:, 2:])
                 + w[2] * (ph[:, :, :-2] + ph[:, :, 2:]))
    return jnp.repeat(jnp.repeat(y, TOY_SCALE, axis=2), TOY_SCALE, axis=3)


def _jax_fmv_handler(mesh):
    """JAX's fast_mamba_vsr handler on the bundled weights, in fp32."""
    from video_enhancer_tpu.runtime import calibration as jcal
    from video_enhancer_tpu.runtime.vsr_handler import VSRHandler as JHandler

    npz = ROOT / "video_enhancer_tpu" / "weights" / "fast_mamba_vsr_4x.npz"
    shapes = jax.eval_shape(lambda: jfmv.init(
        jax.random.PRNGKey(0), dim=48, num_layers=8, scale=4)[0])
    jp, _, skipped = unflatten_into(shapes, dict(np.load(npz)))
    assert not skipped
    return JHandler("fast_mamba_vsr", jcal.calibrate_vsr(
        "fast_mamba_vsr", lambda p, x: jfmv.apply(p, x, scale=4)), jp,
        scale=4, chunk=16, overlap=2, compute_dtype=jnp.float32, mesh=mesh)


def test_mesh_path_matches_jax(tmp_path, cpu_mesh_devices):
    """At four ranks on a (1, 2, 2) mesh: ``halo_exchange_space``,
    ``make_spatially_sharded_clip_fn``, ``make_sharded_clip_fn`` and
    ``make_mesh_sharded_clip_fn`` on the toy model against JAX's under
    ``shard_map``; ``VSRHandler(mesh=...)`` on fast_mamba_vsr's bundled
    weights in fp32 against JAX's sharded handler (and a clip whose T does
    not split, served unsharded); the handler the registry builds from a
    policy with that mesh (cached, on the mesh) against its own unsharded
    output."""
    g = np.random.default_rng(8)
    a = dict(w=np.array([0.9, 0.3, -0.4], np.float32),
             clip=g.standard_normal((2, 4, 16, 6, 3)).astype(np.float32),
             fmv_clip=g.random((4, 32, 16, 3), dtype=np.float32))
    outs = _run_ranks(tmp_path, "mesh", a, script=MESH_RANK, ranks=4)

    mesh = jmake_mesh(*MESH)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    band = P(None, None, "space")
    f = shard_map(functools.partial(jspatial.halo_exchange_space, halo=2),
                  mesh=mesh, in_specs=(band,), out_specs=band)
    with mesh:
        want = {
            "halo_space": np.asarray(jax.jit(f)(j["clip"])),
            "spatial": jspatial.make_spatially_sharded_clip_fn(
                _jtoy, mesh, halo=2, scale=TOY_SCALE)(j["w"], j["clip"]),
            "sharded": jinf.make_sharded_clip_fn(_jtoy, mesh, halo=1)(
                j["w"], j["clip"]),
            "mesh": jinf.make_mesh_sharded_clip_fn(
                _jtoy, mesh, halo_t=1, halo_s=2, scale=TOY_SCALE)(
                    j["w"], j["clip"]),
        }
        jh = _jax_fmv_handler(mesh)
        want_handler = np.asarray(jh.process_clip(j["fmv_clip"]))
    # the halos change the output: the toy differs unsharded
    assert np.abs(np.asarray(want["mesh"]) - np.asarray(
        _jtoy(j["w"], j["clip"]))).max() > 0.01
    for r, out in enumerate(outs):
        assert list(out["coords"]) == list(np.unravel_index(r, MESH))
        assert list(out["shape"]) == list(MESH)
        for k, v in want.items():
            _close(out[k], v, 1e-5)
        _close(out["handler"], want_handler, 1e-4)
        _close(out["handler_t3"], out["single_t3"], 0.0)
        assert list(out["registry_mesh"]) == list(MESH)
        assert bool(out["registry_cached"])
        assert np.abs(out["registry"] - out["registry_single"]).mean() < 0.05
    # the sharded handler is the halo approximation of the unsharded one
    assert np.abs(outs[0]["handler"] - outs[0]["handler_single"]).mean() \
        < 0.05


def _refusals(make_j, make_t, mesh_shape, clips):
    """The messages JAX's and the port's wrappers raise for each clip shape
    (the port's mesh is a stand-in with a shape: it checks before it
    exchanges anything)."""
    jfn = make_j(jmake_mesh(**mesh_shape))
    shape = {"data": 1, "time": 1, "space": 1, **mesh_shape}
    tfn = make_t(types.SimpleNamespace(shape=shape))
    got = []
    for c in clips:
        msgs = []
        for fn, z in ((jfn, jnp.zeros(c)), (tfn, torch.zeros(c))):
            with pytest.raises(ValueError) as e:
                fn({}, z)
            msgs.append(str(e.value))
        got.append(msgs)
    return got


@pytest.mark.parametrize("kind", ["sharded", "spatial", "mesh"])
def test_halo_factories_refuse_as_jax_does(kind, cpu_mesh_devices):
    """Non-divisible T or H, and a shard smaller than its halo: the same
    ValueError and message as JAX (tests/test_temporal_parallel.py:133-147,
    184-197)."""
    from video_enhancer_tpu_torch.parallel import inference as tinf
    from video_enhancer_tpu_torch.parallel import spatial as tspatial

    ident = lambda p, c: c                                   # noqa: E731
    if kind == "sharded":
        cases = _refusals(
            lambda m: jinf.make_sharded_clip_fn(ident, m, halo=2),
            lambda m: tinf.make_sharded_clip_fn(ident, m, halo=2),
            {"time": 4}, [(1, 7, 4, 4, 3), (1, 4, 4, 4, 3)])
    elif kind == "spatial":
        cases = _refusals(
            lambda m: jspatial.make_spatially_sharded_clip_fn(ident, m,
                                                              halo=4),
            lambda m: tspatial.make_spatially_sharded_clip_fn(ident, m,
                                                              halo=4),
            {"space": 4}, [(1, 2, 30, 8, 3), (1, 2, 8, 8, 3)])
    else:
        cases = _refusals(
            lambda m: jinf.make_mesh_sharded_clip_fn(ident, m, halo_t=2,
                                                     halo_s=8),
            lambda m: tinf.make_mesh_sharded_clip_fn(ident, m, halo_t=2,
                                                     halo_s=8),
            {"time": 2, "space": 2},
            [(1, 5, 32, 4, 3), (1, 2, 32, 4, 3), (1, 4, 8, 4, 3)])
    for jmsg, tmsg in cases:
        assert tmsg == jmsg


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 32])
def test_factor_devices_matches_jax(n):
    """``factor_devices`` splits ranks over (data, time, space) as JAX's
    does; a count that is not a power of 2 is refused."""
    from video_enhancer_tpu.parallel.mesh import factor_devices as jfactor
    from video_enhancer_tpu_torch.parallel.mesh import factor_devices

    assert factor_devices(n) == jfactor(n)
    with pytest.raises(ValueError, match="power of 2"):
        factor_devices(n + 1 if n > 1 else 3)
