"""The port's time axis on ``torch.distributed`` against the JAX package's
``shard_map`` on the 8-device CPU mesh, at two shards.

Each test starts two ranks of a gloo group (fresh interpreters in which JAX,
OpenCV, PyYAML and the JAX package cannot be imported, one thread each, a ``file://`` store under the test's temporary
directory, every collective bounded by a 120 s timeout and each process by
180 s), feeds them seeded inputs and JAX-initialised parameters through
``.npz`` files, and compares what both ranks return with JAX's sharded
functions (``make_mesh(time=2)``) and with the port's single-device forms.
At two shards every function meets both a global edge and an interior
boundary. Tolerances: 1e-5 absolute for the exchanges, scans, layers and
vsrm, 1e-4 for fast_mamba_vsr (the JAX package's own bounds,
tests/test_temporal_parallel.py), fp32.
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from video_enhancer_tpu.models import fast_mamba_vsr as jfmv
from video_enhancer_tpu.models import vsrm as jvsrm
from video_enhancer_tpu.nn import ssm as jssm
from video_enhancer_tpu.parallel import inference as jinf
from video_enhancer_tpu.parallel import temporal as jtemp
from video_enhancer_tpu.parallel.mesh import make_mesh as jmake_mesh
from video_enhancer_tpu.runtime.weights import flatten_params
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


def _run_ranks(work: Path, what: str, arrays: dict) -> list[dict]:
    """Both ranks' outputs (each holds the whole result)."""
    np.savez(work / "inputs.npz", **arrays)
    store = work / "store"
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(ROOT), str(r), str(store), str(work),
         what], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"}) for r in range(RANKS)]
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
    return [dict(np.load(work / f"out_{r}.npz")) for r in range(RANKS)]


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
