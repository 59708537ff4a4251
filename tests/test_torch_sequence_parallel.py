"""The port's sequence parallelism and parameter sharding on
``torch.distributed`` against the JAX package's ``shard_map`` on the
8-device CPU mesh.

Three launches of ranks on the harness of tests/test_torch_parallel.py
(fresh interpreters in which JAX, OpenCV, PyYAML and the JAX package cannot
be imported, one thread each, gloo through a ``file://`` store, every
collective bounded by 120 s and each process by 180 s), each run once for
the tests that read it:

1. four ranks on a time axis: ``ppermute`` both ways, ``psum`` and
   ``pmax``; ``ring_attention``; ``sharded_attention`` on the ring and on
   gathered K/V (bound 1e-5, JAX's own, tests/test_temporal_parallel.py);
2. two ranks on a time axis: ``ssd_parallel_scan`` both ways and
   ``bissd_apply_sharded`` (1e-4), ``make_exact_sharded_fmv`` on the ssd
   mixer (1e-4), sharded ``group_norm_apply`` and ``unet_apply``,
   ``make_exact_sharded_seedvr2`` at base 8 and
   ``make_exact_sharded_ditvr`` at dim 32, depth 2, heads 2 (1e-5), each
   held to JAX's sharded output and to the port's single-device form;
3. two ranks on a data axis: ``make_sharded_ditvr`` at the small preset on
   JAX's parameters against JAX's ``make_sharded_ditvr`` (1e-5; JAX's
   bound in tests/test_parallel.py is finiteness), and ``init_sharded``'s
   shards against the one-rank init.

With no ranks: ``make_fsdp_shardings`` against JAX's ``PartitionSpec`` on
the 3b tree, and the size presets' trees against JAX's (shapes only, on
the meta device and through ``jax.eval_shape``). Parameters are
JAX-initialised and fed through ``params_from_jax``; everything is fp32.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from test_torch_parallel import _close, _flat, _port, _run_ranks
from video_enhancer_tpu.models import diffusion as jdiff
from video_enhancer_tpu.models import ditvr as jditvr
from video_enhancer_tpu.models import fast_mamba_vsr as jfmv
from video_enhancer_tpu.models import seedvr2 as jseedvr2
from video_enhancer_tpu.models import seedvr2_sizes as jsizes
from video_enhancer_tpu.nn import core as jcore
from video_enhancer_tpu.nn import ssm as jssm
from video_enhancer_tpu.ops import ring as jring
from video_enhancer_tpu.parallel import inference as jinf
from video_enhancer_tpu.parallel import model_parallel as jmp
from video_enhancer_tpu.parallel import temporal as jtemp
from video_enhancer_tpu.parallel.mesh import make_mesh as jmake_mesh
from video_enhancer_tpu_torch.models import diffusion as tdiff
from video_enhancer_tpu_torch.models import ditvr as tditvr
from video_enhancer_tpu_torch.models import fast_mamba_vsr as tfmv
from video_enhancer_tpu_torch.models import seedvr2 as tseedvr2
from video_enhancer_tpu_torch.models import seedvr2_sizes as tsizes
from video_enhancer_tpu_torch.nn import core as tcore
from video_enhancer_tpu_torch.nn import ssm as tssm
from video_enhancer_tpu_torch.ops.attention import attention_ref
from video_enhancer_tpu_torch.ops.ssd import ssd_shared
from video_enhancer_tpu_torch.parallel.model_parallel import \
    make_fsdp_shardings
from video_enhancer_tpu_torch.runtime.weights import flatten_params

RANK = r"""
import sys
sys.path.insert(0, sys.argv[1])
for name in ("jax", "jaxlib", "cv2", "yaml", "video_enhancer_tpu"):
    sys.modules[name] = None
import numpy as np
import torch
torch.set_num_threads(1)
from video_enhancer_tpu_torch.parallel.mesh import make_mesh
from video_enhancer_tpu_torch.runtime.weights import (flatten_params,
                                                      params_from_jax)

rank, store, work, what = int(sys.argv[2]), *sys.argv[3:6]
shape = {"collectives": dict(time=4), "models": dict(time=2),
         "fsdp": dict(data=2)}[what]
mesh = make_mesh(**shape, rank=rank, init_file=store, device="cpu",
                 timeout_s=120)
axis = mesh.axis("data" if what == "fsdp" else "time")
data = dict(np.load(f"{work}/inputs.npz"))
t = {k: torch.from_numpy(v) for k, v in data.items() if "." not in k}
params = params_from_jax({k: v for k, v in data.items() if "." in k})
n, idx = axis.size, axis.index


def local(a, dim=1):
    return axis.shard(a, dim)


def whole(a, dim=1):
    return axis.all_gather(a, dim=dim, tiled=True).numpy()


out = {}
try:
    if what == "collectives":
        from video_enhancer_tpu_torch.ops.ring import (ring_attention,
                                                       sharded_attention)
        col = local(t["col"])
        for s in (1, -1):
            out[f"ppermute_{s}"] = whole(axis.ppermute(col, s))
        out["psum"] = axis.psum(col).numpy()
        out["pmax"] = axis.pmax(col).numpy()
        q, k, v = (local(t[z], 2) for z in ("q", "k", "v"))
        out["ring"] = whole(ring_attention(q, k, v, axis), 2)
        q, k, v = (local(t[z]) for z in ("sq", "sk", "sv"))
        for m in (1, 10**9):
            out[f"sharded_{m}"] = whole(sharded_attention(
                q, k, v, 4, axis, min_ring_tokens=m))
    elif what == "models":
        from video_enhancer_tpu_torch.models import diffusion, seedvr2
        from video_enhancer_tpu_torch.nn.core import group_norm_apply
        from video_enhancer_tpu_torch.nn.ssm import bissd_apply_sharded
        from video_enhancer_tpu_torch.parallel.inference import (
            make_exact_sharded_ditvr, make_exact_sharded_fmv,
            make_exact_sharded_seedvr2)
        from video_enhancer_tpu_torch.parallel.temporal import (
            ssd_parallel_scan)
        args = [local(t[k]) for k in ("x", "dt")] + [t["A"]] + \
            [local(t[k]) for k in ("B", "C")]
        for rev in (False, True):
            out[f"ssd_{rev}"] = whole(ssd_parallel_scan(
                *args, axis, chunk=8, reverse=rev))
        out["bissd"] = whole(bissd_apply_sharded(params["bissd"],
                                                 local(t["seq"]), axis))
        out["fmv"] = make_exact_sharded_fmv(axis, scale=2)(
            params["fmv"], t["clip"]).numpy()
        out["group_norm"] = whole(group_norm_apply(
            params["gn"], local(t["gx"]), 8, axis=axis))
        out["unet"] = whole(diffusion.unet_apply(
            params["unet"], local(t["ux"]), t["ut"], time_axis=axis))
        out["seedvr2"] = make_exact_sharded_seedvr2(axis)(
            params["seedvr2"], t["clip"]).numpy()
        out["ditvr"] = make_exact_sharded_ditvr(axis, heads=2)(
            params["ditvr"], t["dclip"]).numpy()
    else:
        from video_enhancer_tpu_torch.models import ditvr
        from video_enhancer_tpu_torch.parallel.model_parallel import (
            init_sharded, make_sharded_ditvr)
        shards, fn = make_sharded_ditvr(mesh, preset="small",
                                        min_bytes=1 << 18,
                                        params=params["ditvr"])
        out["y"] = fn(shards, t["clip"]).numpy()
        out["qkv_shard"] = np.array(shards["blocks"][0]["qkv"]["w"].shape)
        gen = torch.Generator().manual_seed(5)
        mine, splits = init_sharded(ditvr.init, gen, axis, min_bytes=1 << 16,
                                    dim=128, depth=2)
        flat_s = flatten_params(splits)
        for key, v in flatten_params(mine).items():
            d = flat_s[key]
            out[f"init.{key}"] = (v.numpy() if d is None
                                  else whole(v.contiguous(), d))
            out[f"split.{key}"] = np.array(-1 if d is None else d)
finally:
    mesh.destroy()
np.savez(f"{work}/out_{rank}.npz", **out)
"""


def _jsharded(fn, n, *args, specs, out_specs=P(None, "time"),
              check_vma=True):
    """``fn`` under ``shard_map`` on an ``n``-shard time mesh, jitted."""
    mesh = jmake_mesh(time=n)
    f = shard_map(fn, mesh=mesh, in_specs=specs, out_specs=out_specs,
                  check_vma=check_vma)
    with mesh:
        return np.asarray(jax.jit(f)(*args))


def _launch(factory, what, arrays, ranks):
    work = factory.mktemp(what)
    return _run_ranks(work, what, arrays, script=RANK, ranks=ranks), arrays


# --- launch 1: collectives and attention, four ranks ----------------------

@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    g = np.random.default_rng(0)
    f32 = np.float32
    a = dict(col=g.standard_normal((3, 8)).astype(f32),
             **{z: g.standard_normal((2, 3, 64, 16)).astype(f32)
                for z in ("q", "k", "v")},
             **{z: g.standard_normal((1, 128, 32)).astype(f32)
                for z in ("sq", "sk", "sv")})
    return _launch(tmp_path_factory, "collectives", a, 4)


def test_ppermute_psum_pmax_match_jax(collectives, cpu_mesh_devices):
    outs, a = collectives
    n, seq = 4, P(None, "time")
    for s in (1, -1):
        perm = [(i, (i + s) % n) for i in range(n)]
        want = _jsharded(lambda x: jax.lax.ppermute(x, "time", perm), n,
                         a["col"], specs=(seq,))
        for out in outs:
            _close(out[f"ppermute_{s}"], want, 1e-5)
        np.testing.assert_array_equal(want, np.roll(
            a["col"].reshape(3, n, 2), s, axis=1).reshape(3, 8))
    for name, op in (("psum", jax.lax.psum), ("pmax", jax.lax.pmax)):
        want = _jsharded(lambda x: op(x, "time"), n, a["col"], specs=(seq,),
                         out_specs=P())
        for out in outs:
            _close(out[name], want, 1e-5)


def test_ring_attention_matches_jax(collectives, cpu_mesh_devices):
    outs, a = collectives
    spec = P(None, None, "time", None)
    q, k, v = (jnp.asarray(a[z]) for z in ("q", "k", "v"))
    want = _jsharded(functools.partial(jring.ring_attention,
                                       axis_name="time"), 4, q, k, v,
                     specs=(spec,) * 3, out_specs=spec)
    ref = attention_ref(*(torch.from_numpy(a[z]) for z in ("q", "k", "v")))
    for out in outs:
        _close(out["ring"], want, 1e-5)
        _close(out["ring"], ref, 1e-5)


@pytest.mark.parametrize("min_ring", [1, 10**9])
def test_sharded_attention_matches_jax(collectives, min_ring,
                                       cpu_mesh_devices):
    """The ring (every length takes it at 1) and gathered K/V (none does
    at 10**9)."""
    outs, a = collectives
    spec = P(None, "time", None)
    want = _jsharded(functools.partial(
        jring.sharded_attention, heads=4, axis_name="time",
        min_ring_tokens=min_ring), 4,
        *(jnp.asarray(a[z]) for z in ("sq", "sk", "sv")),
        specs=(spec,) * 3, out_specs=spec, check_vma=False)
    for out in outs:
        _close(out[f"sharded_{min_ring}"], want, 1e-5)


# --- launch 2: the sharded models, two ranks -------------------------------

def _jit_init(init, seed, **kw):
    """``init``'s parameters, traced once (eager random inits dispatch op
    by op)."""
    return jax.jit(lambda k: init(k, **kw)[0])(jax.random.PRNGKey(seed))


def _filled(shapes, seed):
    """Seeded values in a tree of JAX's shapes: norm scales 1 + 0.1 N, biases
    0.05 N, weights N / sqrt(fan-in) (JAX's layouts put the output last)."""
    g = np.random.default_rng(seed)

    def leaf(path, a):
        z = g.standard_normal(a.shape).astype(np.float32)
        if path.endswith("scale"):
            return 1.0 + 0.1 * z
        if len(a.shape) < 2:
            return 0.05 * z
        return z / np.sqrt(math.prod(a.shape[:-1]))

    return jax.tree_util.tree_map_with_path(
        lambda p, a: leaf(jax.tree_util.keystr(p), a), shapes)


def _jax_params():
    """The parameters of launch 2 in JAX's trees: fast_mamba_vsr's, the
    bissd layer's and ditvr's from JAX's inits (fast_mamba_vsr's zero-init
    head and temporal conv made live); seedvr2's (base 8) traced with
    ``jax.eval_shape`` and filled from a seed, since its init takes 14 s
    traced and 37 s eagerly on the CPU and leaves zero the layers that
    carry the sharded paths (each resblock's second conv, the attention
    projections, the UNet's last conv, the fuse conv); its UNet is the
    one ``unet_apply`` runs."""
    fmv = _jit_init(jfmv.init, 3, dim=8, num_layers=2, scale=2,
                    temporal_mixer="ssd")
    for i, k in enumerate(("head", "temporal")):
        fmv[k]["w"] = jax.random.normal(jax.random.PRNGKey(4 + i),
                                        fmv[k]["w"].shape) * 0.05
    seedvr2 = _filled(jax.eval_shape(lambda: jseedvr2.init(
        jax.random.PRNGKey(0), base_channels=8)[0]), 6)
    return {
        "bissd": jssm.bissd_init(jax.random.PRNGKey(1), 8, state_dim=4,
                                 head_dim=8),
        "fmv": fmv,
        "gn": {"scale": jax.random.normal(jax.random.PRNGKey(8), (16,)),
               "bias": jax.random.normal(jax.random.PRNGKey(9), (16,))},
        "unet": seedvr2["unet"],
        "seedvr2": seedvr2,
        "ditvr": _jit_init(jditvr.init, 0, dim=32, depth=2, heads=2),
    }


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    g = np.random.default_rng(1)
    f32 = np.float32
    B, L, H, Pd, N = 2, 32, 2, 4, 3
    a = dict(x=g.standard_normal((B, L, H, Pd)).astype(f32),
             dt=np.log1p(np.exp(0.5 * g.standard_normal((B, L, H)))
                         ).astype(f32),
             A=-np.exp(0.3 * g.standard_normal(H)).astype(f32),
             B=g.standard_normal((B, L, N)).astype(f32),
             C=g.standard_normal((B, L, N)).astype(f32),
             seq=g.standard_normal((5, 8, 8)).astype(f32),
             clip=g.random((1, 8, 16, 16, 3), dtype=f32),
             gx=g.standard_normal((2, 8, 4, 4, 16)).astype(f32),
             ux=g.standard_normal((1, 8, 8, 8, 6)).astype(f32),
             ut=np.array([250.5], f32),
             dclip=g.random((1, 8, 8, 8, 3), dtype=f32))
    jp = _jax_params()
    flat = {k: v for name, tree in jp.items()
            for k, v in _flat(f"{name}.", tree).items()}
    outs, _ = _launch(tmp_path_factory, "models", {**a, **flat}, 2)
    return outs, a, jp


def _both(outs, key, want, single, tol):
    for out in outs:
        _close(out[key], want, tol)
        _close(out[key], single, tol)


@pytest.mark.parametrize("rev", [False, True])
def test_ssd_parallel_scan_matches_jax(models, rev, cpu_mesh_devices):
    outs, a, _ = models
    seq, rep = P(None, "time"), P()
    args = [jnp.asarray(a[k]) for k in ("x", "dt", "A", "B", "C")]
    want = _jsharded(functools.partial(jtemp.ssd_parallel_scan, chunk=8,
                                       reverse=rev), 2, *args,
                     specs=(seq, seq, rep, seq, seq))
    single = ssd_shared(*(torch.from_numpy(a[k])
                          for k in ("x", "dt", "A", "B", "C")),
                        chunk=8, reverse=rev)
    _both(outs, f"ssd_{rev}", want, single, 1e-4)


def test_bissd_apply_sharded_matches_jax(models, cpu_mesh_devices):
    outs, a, jp = models
    want = _jsharded(jssm.bissd_apply_sharded, 2, jp["bissd"],
                     jnp.asarray(a["seq"]), specs=(P(), P(None, "time")))
    single = tssm.bissd_apply(_port(jp["bissd"]), torch.from_numpy(a["seq"]))
    _both(outs, "bissd", want, single, 1e-4)


def test_exact_sharded_fmv_ssd_mixer_matches_jax(models, cpu_mesh_devices):
    outs, a, jp = models
    mesh = jmake_mesh(time=2)
    with mesh:
        want = np.asarray(jinf.make_exact_sharded_fmv(mesh, scale=2)(
            jp["fmv"], jnp.asarray(a["clip"])))
    single = tfmv.apply(_port(jp["fmv"]), torch.from_numpy(a["clip"]),
                        scale=2)
    _both(outs, "fmv", want, single, 1e-4)


def test_sharded_group_norm_matches_jax(models, cpu_mesh_devices):
    outs, a, jp = models
    want = _jsharded(functools.partial(jcore.group_norm_apply, groups=8,
                                       axis_name="time"), 2, jp["gn"],
                     jnp.asarray(a["gx"]), specs=(P(), P(None, "time")))
    single = tcore.group_norm_apply(_port(jp["gn"]),
                                    torch.from_numpy(a["gx"]), 8)
    _both(outs, "group_norm", want, single, 1e-5)


def test_sharded_unet_matches_jax(models, cpu_mesh_devices):
    outs, a, jp = models
    want = _jsharded(functools.partial(jdiff.unet_apply, time_axis="time"),
                     2, jp["unet"], jnp.asarray(a["ux"]),
                     jnp.asarray(a["ut"]),
                     specs=(P(), P(None, "time"), P()))
    single = tdiff.unet_apply(_port(jp["unet"]), torch.from_numpy(a["ux"]),
                              torch.from_numpy(a["ut"]))
    _both(outs, "unet", want, single, 1e-5)


def test_exact_sharded_seedvr2_matches_jax(models, cpu_mesh_devices):
    outs, a, jp = models
    mesh = jmake_mesh(time=2)
    with mesh:
        want = np.asarray(jinf.make_exact_sharded_seedvr2(mesh)(
            jp["seedvr2"], jnp.asarray(a["clip"])))
    single = tseedvr2.apply(_port(jp["seedvr2"]), torch.from_numpy(a["clip"]))
    _both(outs, "seedvr2", want, single, 1e-5)


def test_exact_sharded_ditvr_matches_jax(models, cpu_mesh_devices):
    outs, a, jp = models
    mesh = jmake_mesh(time=2)
    with mesh:
        want = np.asarray(jinf.make_exact_sharded_ditvr(mesh, heads=2)(
            jp["ditvr"], jnp.asarray(a["dclip"])))
    single = tditvr.apply(_port(jp["ditvr"]), torch.from_numpy(a["dclip"]),
                          heads=2)
    _both(outs, "ditvr", want, single, 1e-5)


# --- launch 3: FSDP, two ranks on a data axis ------------------------------

@pytest.fixture(scope="module")
def fsdp(tmp_path_factory):
    mesh = jmake_mesh(data=2)
    jparams, jfn = jmp.make_sharded_ditvr(mesh, preset="small",
                                          min_bytes=1 << 18)
    clip = np.random.default_rng(2).random((1, 2, 32, 32, 3),
                                           dtype=np.float32)
    with mesh:
        want = np.asarray(jfn(jparams, jnp.asarray(clip)))
    flat = _flat("ditvr.", jparams)
    outs, _ = _launch(tmp_path_factory, "fsdp", {"clip": clip, **flat}, 2)
    return outs, want, flat


def test_sharded_ditvr_matches_jax(fsdp, cpu_mesh_devices):
    """The small preset's forward on JAX's parameters; each rank's qkv
    (port layout (3 * 384, 384)) is half of it."""
    outs, want, flat = fsdp
    whole = flat["ditvr.blocks.0.qkv.w"].shape[::-1]
    for out in outs:
        _close(out["y"], want, 1e-5)
        assert math.prod(out["qkv_shard"]) * 2 == math.prod(whole)
        assert list(out["qkv_shard"]) == [whole[0] // 2, whole[1]]


def test_init_sharded_concatenates_to_one_rank_init(fsdp):
    """The shards of ``init_sharded`` at two ranks, gathered along their
    splits, equal the one-rank init from the same seed; the large weights
    are split, the small ones whole."""
    outs = fsdp[0]
    want = flatten_params(tditvr.init(torch.Generator().manual_seed(5),
                                      dim=128, depth=2))
    for out in outs:
        got = {k[5:]: v for k, v in out.items() if k.startswith("init.")}
        assert got.keys() == want.keys()
        for key, val in want.items():
            np.testing.assert_array_equal(got[key], val.numpy())
        split = {k[6:]: int(v) for k, v in out.items()
                 if k.startswith("split.")}
        assert split["blocks.0.qkv.w"] == 0
        assert split["blocks.0.mlp.fc2.w"] == 1
        assert split["blocks.0.norm1.scale"] == -1


# --- no ranks --------------------------------------------------------------

def _shape_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _shape_leaves(sub, f"{prefix}{key}.").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _shape_leaves(sub, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def test_fsdp_shardings_match_jax_on_3b():
    """The split of every leaf of the 3b tree (JAX's layout, shapes from
    ``jax.eval_shape``) over 8 ranks is the dimension JAX's
    ``PartitionSpec`` names."""
    cfg = jditvr.SIZE_PRESETS["3b"]
    shapes = jax.eval_shape(lambda: jditvr.init(jax.random.PRNGKey(0),
                                                **cfg)[0])
    specs = jmp.make_fsdp_shardings(shapes, jmake_mesh(data=8))
    got = _shape_leaves(make_fsdp_shardings(shapes, 8))
    want = {k: next((d for d, a in enumerate(s.spec) if a == "data"), None)
            for k, s in _shape_leaves(specs).items()}
    assert got == want
    # adaln, qkv, proj and the MLP's two layers of each block, and deg_mlp's
    # second layer
    assert sum(d is not None for d in got.values()) == 5 * cfg["depth"] + 1


@pytest.mark.parametrize("size", ["small", "base", "3b", "7b"])
def test_seedvr2_sizes_match_jax(size):
    """Keys, shapes (a dense layer's ``w`` transposed to Linear's layout)
    and meta of each preset's tree, on the meta device."""
    with torch.device("meta"):
        params, meta, apply = tsizes.make_seedvr2(size)
    jmeta = {}

    def jinit():
        p, m, _ = jsizes.make_seedvr2(size)
        jmeta.update(m)
        return p

    jshapes = jax.eval_shape(jinit)
    got = {k: tuple(v.shape) for k, v in flatten_params(params).items()}
    want = {k: (tuple(v.shape)[::-1] if k.endswith(".w") else tuple(v.shape))
            for k, v in _shape_leaves(jshapes).items()}
    assert got == want
    assert meta == jmeta and meta["preset"] == size
    assert callable(apply)


class _OneRank:
    """A time axis of one rank with no process group: every collective is
    the identity (all_gather stacks, or with ``tiled`` returns its input)."""

    size, index = 1, 0

    @staticmethod
    def all_gather(t, dim=0, tiled=False):
        return t if tiled else t[None]


def test_bissd_rounds_its_conv_weight_as_jax_in_both_forms():
    """JAX rounds the depthwise conv's weight to x's dtype in ``bissd_apply``
    and in ``bissd_apply_sharded`` (nn/ssm.py:331, :385); so does the port,
    so that on one rank the two forms agree to the bit for bf16 input with
    fp32 parameters."""
    p = tssm.bissd_init(torch.Generator().manual_seed(0), 16, state_dim=8,
                        head_dim=16)
    x = torch.randn((64, 16, 16), generator=torch.Generator().manual_seed(1)
                    ).to(torch.bfloat16)
    got = tssm.bissd_apply_sharded(p, x, _OneRank(), chunk=256,
                                   use_kernel=False)
    want = tssm.bissd_apply(p, x, use_kernel=False)
    assert torch.equal(got, want)


def test_bissd_sharded_hands_the_kernel_evenly_strided_rows(monkeypatch):
    """The halo's trim leaves x, B and C as rows the SSD kernel can read
    (``kernels.row_stride``: evenly strided, dense last dim), as the
    wrapper checks on the card before it launches."""
    from video_enhancer_tpu_torch import kernels
    from video_enhancer_tpu_torch.parallel import temporal

    seen = []
    real = temporal.ssd_shared

    def checked(x, dt, A, Bm, Cm, **kw):
        seen.append([kernels.row_stride(t, n) for t, n in
                     ((x.flatten(2), "x"), (Bm, "Bm"), (Cm, "Cm"))])
        return real(x, dt, A, Bm, Cm, **kw)

    monkeypatch.setattr(temporal, "ssd_shared", checked)
    p = tssm.bissd_init(torch.Generator().manual_seed(0), 16, state_dim=8,
                        head_dim=16)
    x = torch.randn((4, 8, 16), generator=torch.Generator().manual_seed(1))
    tssm.bissd_apply_sharded(p, x, _OneRank())
    assert len(seen) == 2
