"""The training CLI: the counterpart of video_enhancer_tpu/train/cli.py.

``python -m video_enhancer_tpu_torch.train.cli --model cnn_upscaler --steps
200`` trains a model on synthetic degradation pairs (``train/data.py``)
with the port's train step (``train/step.py``: optax's global-norm clip
and AdamW), checkpoints with ``--ckpt-dir`` (resumed from the newest one)
and exports the flat ``.npz`` of inference weights with ``--export``. It
takes the JAX package's flags and prints its JSON lines (``{"step",
"loss", "sec_per_step"}`` every ``--log-every`` steps, ``{"final_loss",
"first_loss"}`` at the end), and one more line, ``{"timing": ...}``: the
data thread's seconds per batch and the step loop's wait for a batch.

It runs on the card unless ``--device cpu`` (or ``--platform cpu``, or
``$VETPU_PLATFORM``) asks for the CPU; ``--device`` wins over
``--platform``. Training runs in fp32 with TF32 off (``device.full_fp32``).
``--mesh-data/-time/-space`` with a product above 1 starts that many ranks
as child processes meeting through a ``file://`` store (gloo on the CPU,
NCCL on the cards); rank 0 prints, saves and exports.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

__all__ = ["build_model", "main", "MODELS"]

MODELS = ("cnn_upscaler", "fast_mamba_vsr", "vsrm", "realesrgan", "seedvr2",
          "ditvr", "rvrt", "rife")

#: model -> calibration wrapper kind (runtime/calibration.py). seedvr2 is
#: absent: its strength lives inside models/seedvr2.apply already.
_CAL_KIND = {
    "cnn_upscaler": "vsr", "fast_mamba_vsr": "vsr", "vsrm": "vsr",
    "realesrgan": "vsr", "rvrt": "vsr", "ditvr": "restore", "rife": "interp",
}
TIMEOUT_S = 3600


def _through_calibration(name: str, cal_name: str, apply_clip, interp_fn):
    """The training apply wrapped with the served calibrated output
    strength of ``cal_name``: ``s * model(x) + (1 - s) * fallback(x)``, so
    the loss optimizes what serving and the eval gates measure."""
    from ..runtime import calibration as cal

    kind = _CAL_KIND.get(name)
    if kind == "interp":
        mid_fn = cal.calibrate_interp(cal_name, interp_fn)

        def apply_pair_clip(p, clip):
            return mid_fn(p, clip[:, 0], clip[:, 1])[:, None]

        return apply_pair_clip
    if kind == "restore":
        return cal.calibrate_restore(cal_name, apply_clip)
    if kind == "vsr":
        return cal.calibrate_vsr(cal_name, apply_clip)
    return apply_clip


def _per_frame(apply_frames, scale: int):
    """A clip apply from a frame apply: ``(B, T, ...)`` folded into B."""
    def apply_clip(p, clip):
        b, t = clip.shape[:2]
        out = apply_frames(p, clip.reshape((b * t,) + clip.shape[2:]),
                           scale=scale)
        return out.reshape((b, t) + out.shape[1:])

    return apply_clip


def build_model(name: str, scale: int, dim: int | None = None,
                layers: int | None = None, heads: int | None = None,
                temporal_mixer: str = "ssm", cal_name: str | None = None,
                seed: int = 0):
    """``(params, apply_clip)`` of a trainable model at the JAX package's
    default widths (``dim`` / ``layers`` / ``heads`` override them), the
    parameters random from ``seed`` (fp32, CPU). ``cal_name`` trains
    through that name's served calibrated strength; None the raw output."""
    gen = torch.Generator().manual_seed(seed)

    def wrap(apply_clip, interp_fn=None):
        if cal_name is None:
            return apply_clip
        return _through_calibration(name, cal_name, apply_clip, interp_fn)

    if name == "cnn_upscaler":
        from ..models import upscaler

        params = upscaler.init(gen, features=dim or 128, scale=scale, s2d=4)
        return params, wrap(_per_frame(
            lambda p, f, scale: upscaler.apply(p, f, scale=scale, s2d=4),
            scale))
    if name == "fast_mamba_vsr":
        from ..models import fast_mamba_vsr as m

        params = m.init(gen, dim=dim or 48, num_layers=layers or 8,
                        scale=scale, temporal_mixer=temporal_mixer)
        return params, wrap(lambda p, c: m.apply(p, c, scale=scale))
    if name == "vsrm":
        from ..models import vsrm as m

        params = m.init(gen, dim=dim or 64, num_blocks=layers or 6,
                        scale=scale)
        return params, wrap(lambda p, c: m.apply(p, c, scale=scale))
    if name == "realesrgan":
        from ..models import realesrgan as m

        params = m.init(gen, features=dim or 64, num_blocks=layers or 6)
        return params, wrap(_per_frame(m.apply, scale))
    if name == "seedvr2":
        from ..models import seedvr2 as m

        params = m.init(gen, base_channels=dim or 32)
        return params, lambda p, c: m.apply(p, c)
    if name == "ditvr":
        from ..models import ditvr as m

        # heads is a layout knob (dh = dim / heads); the shapes stay
        h = heads or 6
        params = m.init(gen, dim=dim or 384, depth=layers or 8)
        return params, wrap(lambda p, c: m.apply(p, c, heads=h))
    if name == "rvrt":
        from ..models import rvrt as m

        params = m.init(gen, dim=dim or 64, depth=layers or 4, scale=scale)
        return params, wrap(lambda p, c: m.apply(p, c, scale=scale))
    if name == "rife":
        from ..models import rife as m

        params = m.init(gen, dim=dim or 32, levels=layers or 3)

        def apply_pair_clip(p, clip):
            # the two end frames -> the midpoint as a clip of one frame
            return m.interpolate_pair(p, clip[:, 0], clip[:, 1])[:, None]

        return params, wrap(apply_pair_clip, interp_fn=m.interpolate_pair)
    raise SystemExit(f"unsupported trainable model: {name}")


class _Timed:
    """An iterator's seconds per item, measured where it is produced."""

    def __init__(self, it):
        self.it, self.seconds, self.count = it, 0.0, 0

    def __iter__(self):
        while True:
            t0 = time.perf_counter()
            item = next(self.it)
            self.seconds += time.perf_counter() - t0
            self.count += 1
            yield item


def _prefetch(it, depth: int = 2):
    """The host batch generator in a daemon thread, so that making a batch
    (numpy: blurs, resamples, JPEG and WebP round trips) overlaps the
    device step; a generator failure is raised to the consumer."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # surface generator failures
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if isinstance(item, BaseException):
            raise item
        yield item


_BANKS: dict = {}


def _content(args) -> np.ndarray:
    """The source frames: ``--source``'s video or a synthetic bank (kept
    for the process: a resumed run in the same process reuses it)."""
    key = (args.source, args.content, args.crop)
    if key not in _BANKS:
        _BANKS.clear()
        _BANKS[key] = _make_content(args)
    return _BANKS[key]


def _make_content(args) -> np.ndarray:
    if args.source:
        from ..io.video import read_video

        return read_video(args.source)
    from ..io.demo import make_demo_frames

    size = (args.crop * 2, args.crop * 2)
    if args.content == "demo":
        return make_demo_frames(64, size)
    from .data import make_train_frames

    # the mixed bank: the demo generator and one clip per content / motion
    # mode of make_train_frames, two seeds each
    return np.concatenate(
        [make_demo_frames(64, size)]
        + [make_train_frames(48, size, seed=s, mode=s % 5)
           for s in range(1, 11)], axis=0)


def _penalized_loss(model: str, lam: float):
    """The correction-magnitude penalty: the loss plus ``lam`` times the
    mean square of the served output's distance from the model's non-ML
    fallback (bicubic, the input, or the pair's average per kind)."""
    from ..ops.resize import resize
    from .losses import vsr_loss

    kind = _CAL_KIND.get(model, "vsr")

    def fallback(lr_clip, pred):
        if kind == "restore":
            return lr_clip
        if kind == "interp":
            return torch.mean(lr_clip, dim=1, keepdim=True)
        base = resize(lr_clip, (pred.shape[-3], pred.shape[-2]))
        return torch.clamp(base, 0.0, 1.0)

    def penalized_loss(pred, hr, lr):
        base = fallback(lr, pred).to(pred.dtype)
        return vsr_loss(pred, hr) + lam * torch.mean((pred - base) ** 2)

    return penalized_loss


def _train(args, mesh) -> int:
    from .checkpoint import export_params, restore_checkpoint, save_checkpoint
    from .data import pair_iterator, triplet_iterator
    from .step import make_optimizer, make_train_step

    lead = mesh.rank == 0

    def say(*a, **kw):
        if lead:
            print(*a, **kw, flush=True)

    frames = _content(args)
    params, apply_clip = build_model(
        args.model, args.scale, dim=args.dim, layers=args.layers,
        heads=args.heads, temporal_mixer=args.temporal_mixer,
        cal_name=args.through_calibration)
    if args.init_npz:
        from ..runtime.weights import try_load_params

        warm = try_load_params(args.init_npz, params)
        if warm is not None:
            params = warm
            say(f"warm-started from {args.init_npz}")
        else:
            say(f"warm-start failed for {args.init_npz}; random init")
    step_kw = {}
    if args.correction_penalty > 0.0:
        step_kw["loss_fn"] = _penalized_loss(args.model,
                                             float(args.correction_penalty))
    init_state, train_step, shard_batch = make_train_step(
        apply_clip, make_optimizer(lr=args.lr), mesh, **step_kw)

    if args.model == "rife":
        it = triplet_iterator(frames, args.batch, args.crop)
    else:
        it = pair_iterator(frames, args.batch, args.clip_len, args.crop,
                           args.scale)
    data = _Timed(it)
    it = _prefetch(iter(data), depth=2)
    state = init_state(params)
    if args.ckpt_dir:
        restored = restore_checkpoint(args.ckpt_dir, state)
        if restored is not None:
            state = restored
            say(f"resumed from step {int(state.step)}")
    t0 = time.time()
    wait = 0.0
    losses, pending = [], []
    start = int(state.step)
    # device losses are fetched only at log points: the loop does not
    # wait for the device between steps
    for i in range(start, args.steps):
        tw = time.perf_counter()
        batch = next(it)
        wait += time.perf_counter() - tw
        state, metrics = train_step(state, shard_batch(batch))
        pending.append(metrics["loss"])
        if (i + 1) % args.log_every == 0:
            fetched = [float(v) for v in pending]
            losses.extend(fetched)
            pending = []
            say(json.dumps({
                "step": i + 1, "loss": round(sum(fetched) / len(fetched), 5),
                "sec_per_step": round((time.time() - t0)
                                      / max(i + 1 - start, 1), 3)}))
        if (args.time_budget_s is not None
                and time.time() - t0 > args.time_budget_s):
            say(f"time budget {args.time_budget_s}s reached at step {i + 1}; "
                f"stopping early")
            break
    losses.extend(float(v) for v in pending)
    steps_run = max(len(losses), 1)
    if args.ckpt_dir and lead:
        step = save_checkpoint(args.ckpt_dir, state)
        say(f"checkpoint saved at step {step}")
    if args.export and lead:
        say(f"weights exported to {export_params(args.export, state)}")
    if losses:
        say(json.dumps({"final_loss": round(losses[-1], 5),
                        "first_loss": round(losses[0], 5)}))
    say(json.dumps({"timing": {
        "steps": len(losses),
        "sec_per_step": round((time.time() - t0) / steps_run, 4),
        "data_sec_per_batch": round(data.seconds / max(data.count, 1), 4),
        "wait_sec_per_step": round(wait / steps_run, 4)}}))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="cnn_upscaler", choices=MODELS)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--clip-len", type=int, default=4)
    p.add_argument("--crop", type=int, default=128)
    p.add_argument("--scale", type=int, default=2)
    p.add_argument("--dim", type=int, default=None)
    p.add_argument("--layers", type=int, default=None)
    p.add_argument("--heads", type=int, default=None)
    p.add_argument("--temporal-mixer", default="ssm", choices=["ssm", "ssd"],
                   help="fast_mamba_vsr only: temporal layer family")
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--source", default=None,
                   help="video file for training frames (default: synthetic)")
    p.add_argument("--content", default="mixed", choices=["mixed", "demo"],
                   help="synthetic content bank (mixed = demo + the five "
                        "make_train_frames processes)")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--init-npz", default=None,
                   help="warm-start weights from an exported npz")
    p.add_argument("--export", default=None, help="final npz weights path")
    p.add_argument("--mesh-data", type=int, default=1)
    p.add_argument("--mesh-time", type=int, default=1)
    p.add_argument("--mesh-space", type=int, default=1)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--through-calibration", default=None, metavar="NAME",
                   help="train through the served calibrated output "
                        "strength of this model name (runtime/"
                        "calibration.py); default: the raw model output")
    p.add_argument("--correction-penalty", type=float, default=0.0,
                   metavar="LAMBDA",
                   help="L2 penalty on the served output's distance from "
                        "the model's non-ML fallback")
    p.add_argument("--time-budget-s", type=float, default=None,
                   help="stop cleanly after this many seconds (checkpoint "
                        "and export still run)")
    p.add_argument("--platform", default=None,
                   help="cpu or gpu/cuda, as $VETPU_PLATFORM")
    p.add_argument("--device", default=None,
                   help="cpu or cuda; wins over --platform (default: the "
                        "card)")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--init-file", default=None, help=argparse.SUPPRESS)
    argv = list(sys.argv[1:] if argv is None else argv)
    args = p.parse_args(argv)

    from ..device import full_fp32, platform_device, resolve_device
    from ..parallel.mesh import launch_ranks, local_mesh, make_mesh

    device = args.device or (platform_device(args.platform)
                             if args.platform else None)
    device = resolve_device(device)
    n = args.mesh_data * args.mesh_time * args.mesh_space
    if n > 1 and args.rank is None:
        return launch_ranks(__spec__.name, argv, n, TIMEOUT_S)
    if n > 1:
        mesh = make_mesh(args.mesh_data, args.mesh_time, args.mesh_space,
                         rank=args.rank, init_file=args.init_file,
                         device=device, timeout_s=TIMEOUT_S)
    else:
        mesh = local_mesh(device)
    try:
        with full_fp32():
            return _train(args, mesh)
    finally:
        if n > 1:
            mesh.destroy()


if __name__ == "__main__":
    raise SystemExit(main())
