"""Multi-rank dry run: a train step and every sharded path of the port on a
``data x time x space`` mesh, each exact path checked against one device.

Counterpart of video_enhancer_tpu/parallel/dryrun.py, in its order:

1. a fast_mamba_vsr train step (dim 8, 2 layers, scale 2, the plain forms
   as JAX's ``scan_impl="ref"``) on the ``factor_devices(n)`` mesh, B over
   ``data`` (train/step.py: the ranks on a time or space line repeat their
   data shard's step);
2. FSDP ditvr at the small preset, one forward over a flat data axis of
   every rank;
3. the exact T-sharded vsrm, fast_mamba_vsr, seedvr2 and ditvr against the
   single-device forward on random clips, within 1e-4; where a model's
   head starts at zero (vsrm's head and offset conv, fast_mamba_vsr's head
   and temporal conv) it is drawn live, so that the comparison is not of
   two bicubic upscales;
4. the T-sharded bissm against the fused kernel (on the card the CUDA
   kernel, on the CPU its plain version);
5. fast_mamba_vsr's SSD-mixer preset T-sharded;
6. the counterpart of "the 3b preset lowers under FSDP": the 3b parameter
   shapes on the ``meta`` device, their FSDP split and the parameter count;
   nothing is allocated.

Each rank runs ``run_dryrun(mesh)``; rank 0 prints JAX's ``dryrun ok: ...``
lines. On the card everything runs in fp32 with TF32 off.

    python -m video_enhancer_tpu_torch.parallel.dryrun --ranks N [--device cpu]

starts N ranks (one in this process; more as child processes meeting
through a ``file://`` store): gloo on the CPU, NCCL on the card.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..device import full_fp32
from ..models import ditvr, seedvr2, vsrm
from ..models import fast_mamba_vsr as fmv
from ..nn.ssm import bissm_apply, bissm_apply_sharded, bissm_init
from ..train.step import make_optimizer, make_train_step, tree_leaves
from .inference import (make_exact_sharded_ditvr, make_exact_sharded_fmv,
                        make_exact_sharded_seedvr2, make_exact_sharded_vsrm)
from .mesh import (AXES, Mesh, factor_devices, launch_ranks, make_mesh,
                   mesh_on_group)
from .model_parallel import make_fsdp_shardings, make_sharded_ditvr

__all__ = ["run_dryrun"]

TOL = 1e-4
TIMEOUT_S = 600


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _to(tree, device):
    return [_to(v, device) for v in tree] if isinstance(tree, list) else (
        {k: _to(v, device) for k, v in tree.items()}
        if isinstance(tree, dict) else tree.to(device))


def _live(params: dict, keys, seed: int) -> dict:
    """``params`` with the zero-initialised convs ``keys`` drawn live."""
    g = _gen(seed)
    for k in keys:
        params[k]["w"] = torch.randn(params[k]["w"].shape, generator=g) * 0.05
    return params


def _fail(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun: {what}")


def run_dryrun(mesh: Mesh) -> None:
    """Every check above on ``mesh`` (parallel/mesh.py), called by each of
    its ranks; raises on the first that fails."""
    with full_fp32():
        _run(mesh)


def _run(mesh: Mesh) -> None:
    data, time_, space = (mesh.shape[a] for a in AXES)
    n, dev = mesh.num_devices, mesh.device
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    say(f"mesh: data={data} time={time_} space={space}")

    scale = 2
    params = fmv.init(_gen(0), dim=8, num_layers=2, scale=scale)

    def apply_clip(p, clip):
        return fmv.apply(p, clip, scale=scale, kernels=False)

    init_state, train_step, shard_batch = make_train_step(
        apply_clip, make_optimizer(), mesh)
    state = init_state(params)
    # tiny but shardable shapes: B, T, H divisible by their mesh axes (and
    # by the model's pooling)
    b, t, h, w = data * 2, time_ * 2, max(space, 2) * 16, 16
    batch = shard_batch({
        "lr": torch.zeros((b, t, h, w, 3)),
        "hr": torch.zeros((b, t, h * scale, w * scale, 3))})
    state, metrics = train_step(state, batch)
    loss, step = float(metrics["loss"]), int(state.step)
    say(f"dryrun ok: devices={n} flagship=fast_mamba_vsr step={step} "
        f"loss={loss:.5f}", flush=True)
    _fail(step == 1, f"step {step} after one train step")

    with torch.no_grad():
        _forwards(mesh, say)


def _forwards(mesh: Mesh, say) -> None:
    time_, n, dev = mesh.shape["time"], mesh.num_devices, mesh.device

    # FSDP: ditvr's parameters split over a flat axis of every rank
    fsdp = mesh if mesh.shape["data"] == n else mesh_on_group(data=n,
                                                               device=dev)
    shards, fn = make_sharded_ditvr(fsdp, preset="small", min_bytes=1 << 18)
    out = fn(shards, torch.zeros((1, 2, 16, 16, 3), device=dev))
    _fail(tuple(out.shape) == (1, 2, 16, 16, 3),
          f"fsdp ditvr-small output {tuple(out.shape)}")
    del shards, fn, out
    say(f"dryrun ok: fsdp ditvr-small forward over {n} shards", flush=True)

    t = time_ * 2

    def check(name, params, sharded_fn, single_fn, clip):
        params, clip = _to(params, dev), clip.to(dev)
        out_s = sharded_fn(params, clip)
        out_1 = single_fn(params, clip)
        _fail(out_s.shape == out_1.shape,
              f"{name}: {tuple(out_s.shape)} against {tuple(out_1.shape)}")
        delta = (out_s - out_1).abs().max().item()
        _fail(delta < TOL, f"{name}: sharded vs single max|d|={delta}")
        say(f"dryrun ok: exact T-sharded {name} max|Δ|={delta:.2e}",
            flush=True)

    clip = torch.rand((1, t, 8, 8, 3), generator=_gen(7))
    check("vsrm", _live(vsrm.init(_gen(0), dim=16, num_blocks=1, scale=2),
                        ("head", "offset"), 20),
          make_exact_sharded_vsrm(mesh, scale=2),
          lambda p, x: vsrm.apply(p, x, scale=2, kernels=False), clip)
    check("fast_mamba_vsr",
          _live(fmv.init(_gen(1), dim=8, num_layers=2, scale=2),
                ("head", "temporal"), 21),
          make_exact_sharded_fmv(mesh, scale=2),
          lambda p, x: fmv.apply(p, x, scale=2, kernels=False), clip)
    check("seedvr2", seedvr2.init(_gen(2), base_channels=8),
          make_exact_sharded_seedvr2(mesh), seedvr2.apply,
          torch.rand((1, t, 16, 16, 3), generator=_gen(7)))
    check("ditvr", ditvr.init(_gen(3), dim=32, depth=1),
          make_exact_sharded_ditvr(mesh, heads=2),
          lambda p, x: ditvr.apply(p, x, heads=2),
          torch.rand((1, t, 16, 16, 3), generator=_gen(7)))

    # the T-sharded prefix-combine against the fused kernel's forward
    bp = _to(bissm_init(_gen(11), dim=8, state_dim=4), dev)
    xseq = torch.randn((4, t, 8), generator=_gen(12)).to(dev)
    y_sharded = mesh.all_gather(
        bissm_apply_sharded(bp, mesh.axis("time").shard(xseq, 1), mesh),
        dim=1, tiled=True)
    y_kernel = bissm_apply(bp, xseq, impl="fused")
    d = (y_sharded - y_kernel).abs().max().item()
    _fail(d < TOL, f"sharded vs fused kernel max|d|={d}")
    form = "the CUDA kernel" if dev.type == "cuda" else "its plain version"
    say(f"dryrun ok: T-sharded bissm vs fused kernel ({form}) "
        f"max|Δ|={d:.2e}", flush=True)

    check("fast_mamba_vsr[ssd mixer]",
          _live(fmv.init(_gen(13), dim=8, num_layers=2, scale=2,
                         temporal_mixer="ssd"), ("head", "temporal"), 22),
          make_exact_sharded_fmv(mesh, scale=2),
          lambda p, x: fmv.apply(p, x, scale=2, kernels=False), clip)

    # the 3b preset under FSDP: shapes on the meta device, their split
    cfg = ditvr.SIZE_PRESETS["3b"]
    with torch.device("meta"):
        shapes = ditvr.init(torch.Generator(), dim=cfg["dim"],
                            depth=cfg["depth"])
    splits = tree_leaves(make_fsdp_shardings(shapes, n, min_bytes=1 << 20))
    n_params = sum(a.numel() for a in tree_leaves(shapes))
    say(f"dryrun ok: ditvr-3b ({n_params / 1e9:.2f}B params) splits under "
        f"FSDP over {n} shards ({sum(s is not None for s in splits)} leaves "
        f"split; meta device, nothing allocated)", flush=True)


def _rank_main(args) -> None:
    mesh = make_mesh(*factor_devices(args.ranks), rank=args.rank,
                     init_file=args.init_file, device=args.device,
                     timeout_s=TIMEOUT_S)
    try:
        run_dryrun(mesh)
    finally:
        mesh.destroy()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ranks", type=int, default=1)
    p.add_argument("--device", default=None,
                   help="cpu for gloo ranks on the CPU (default: the card)")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--init-file", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    factor_devices(args.ranks)        # a power of 2, or raise
    if args.rank is not None or args.ranks == 1:
        args.rank = args.rank or 0
        _rank_main(args)
        return 0
    argv = ["--ranks", str(args.ranks)]
    if args.device:
        argv += ["--device", args.device]
    return launch_ranks(__spec__.name, argv, args.ranks, TIMEOUT_S)


if __name__ == "__main__":
    sys.exit(main())
