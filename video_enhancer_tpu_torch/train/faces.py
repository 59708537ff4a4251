"""Face-restorer training on procedural face crops: the counterpart of
video_enhancer_tpu/train/faces.py.

Procedural faces (a skin-tone ellipse, eyes, brows, mouth and nose of
random geometry, a lighting gradient, background clutter), drawn with
``ops/cvhost.py`` as OpenCV draws them, are degraded by a blur ->
down/up -> noise ladder, and the residual UNet of
``runtime/face_handler.py`` learns to invert it with optax's Adam
(``train/step.py`` ``AdamW`` without clip or decay). The RNG draws are the
JAX package's, so a seed gives the same crops.

    python -m video_enhancer_tpu_torch.train.faces --steps 800 \\
        [--export face_restorer.npz] [--device cpu]

The export defaults to ``face_restorer.npz`` in the current directory:
the bundled weights under ``video_enhancer_tpu/weights/`` are never
written.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device import full_fp32, platform_device, resolve_device
from ..ops import cvhost
from .face_detector import _sample_skin
from .step import make_adam_step, tree_leaves, tree_unflatten

__all__ = ["FACE_SIZE", "make_face_crops", "degrade_faces", "train", "main"]

FACE_SIZE = 128


def make_face_crops(n: int, size: int = FACE_SIZE, seed: int = 0
                    ) -> np.ndarray:
    """(n, size, size, 3) float32 procedural face crops in [0, 1]."""
    rng = np.random.default_rng(seed)
    out = np.empty((n, size, size, 3), np.float32)
    for i in range(n):
        img = np.empty((size, size, 3), np.float32)
        # background: a soft two-colour gradient and clutter rectangles
        c0 = rng.uniform(0.1, 0.9, 3)
        c1 = rng.uniform(0.1, 0.9, 3)
        ramp = np.linspace(0, 1, size, dtype=np.float32)[:, None, None]
        img[:] = c0 * (1 - ramp) + c1 * ramp
        for _ in range(rng.integers(1, 4)):
            x0, y0 = rng.integers(0, size - 8, 2)
            w, h = rng.integers(8, size // 2, 2)
            img[y0:y0 + h, x0:x0 + w] = rng.uniform(0, 1, 3)

        # head: a skin-tone ellipse over the detector's skin bands
        skin = _sample_skin(rng)
        cx = size // 2 + int(rng.integers(-8, 9))
        cy = size // 2 + int(rng.integers(-8, 9))
        ax = int(size * rng.uniform(0.28, 0.38))
        ay = int(size * rng.uniform(0.34, 0.45))
        tilt = float(rng.uniform(-12, 12))
        cvhost.ellipse(img, (cx, cy), (ax, ay), tilt, 0, 360,
                       skin.tolist(), -1)
        # hair cap
        hair = rng.uniform(0.02, 0.4, 3).tolist()
        cvhost.ellipse(img, (cx, cy - ay // 2), (ax, ay // 2), tilt, 180,
                       360, hair, -1)

        eye_dy = int(ay * 0.15)
        eye_dx = int(ax * 0.45)
        er = max(int(ax * rng.uniform(0.12, 0.18)), 2)
        iris = rng.uniform(0.05, 0.5, 3).tolist()
        for sx in (-1, 1):
            ex, ey = cx + sx * eye_dx, cy - eye_dy
            cvhost.ellipse(img, (ex, ey), (er, max(er // 2, 1)), tilt, 0,
                           360, (0.95, 0.95, 0.95), -1)
            cvhost.circle(img, (ex, ey), max(er // 2, 1), iris, -1)
            cvhost.circle(img, (ex, ey), max(er // 4, 1),
                          (0.02, 0.02, 0.02), -1)
            # brow
            cvhost.ellipse(img, (ex, ey - er - 2),
                           (er + 2, max(er // 3, 1)), tilt, 180, 360, hair,
                           2)
        # nose
        cvhost.line(img, (cx, cy - eye_dy // 2),
                    (cx + int(ax * 0.08), cy + int(ay * 0.15)),
                    (skin * 0.8).tolist(), 2)
        # mouth
        mw = int(ax * rng.uniform(0.35, 0.55))
        cvhost.ellipse(img, (cx, cy + int(ay * 0.45)), (mw, max(mw // 3, 2)),
                       tilt, 0, 180, (rng.uniform(0.4, 0.8), 0.15, 0.2), -1)

        # lighting gradient and mild texture
        light = 1.0 + 0.25 * (np.linspace(-1, 1, size)[None, :, None]
                              * rng.uniform(-1, 1))
        img = img * light + rng.normal(0, 0.01, img.shape)
        out[i] = np.clip(img, 0.0, 1.0)
    return out


def degrade_faces(crops: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """The face degradation ladder: blur -> down/up -> noise."""
    out = np.empty_like(crops)
    for i, img in enumerate(crops):
        sigma = rng.uniform(0.6, 3.0)
        f = cvhost.gaussian_blur(img, 9, sigma)
        s = rng.uniform(0.25, 0.8)
        h, w = img.shape[:2]
        small = cvhost.resize(f, (max(int(w * s), 8), max(int(h * s), 8)),
                              interpolation=cvhost.INTER_AREA)
        f = cvhost.resize(small, (w, h), interpolation=cvhost.INTER_LINEAR)
        f = f + rng.normal(0, rng.uniform(0.005, 0.05), f.shape)
        out[i] = np.clip(f, 0.0, 1.0)
    return out


def restorer_loss(p, deg, clean):
    from ..runtime.face_handler import _face_net_apply

    out = _face_net_apply(p, deg)
    return torch.mean(torch.sqrt((out - clean) ** 2 + 1e-6))


def train(steps: int = 800, batch: int = 16, lr: float = 2e-4,
          seed: int = 0, device=None, params=None, log_every: int = 100):
    """The restorer's parameters after ``steps`` Adam steps (random from
    ``seed`` unless ``params`` is given), on ``device``."""
    from ..runtime.face_handler import _face_net_init

    dev = resolve_device(device)
    if params is None:
        params = _face_net_init(torch.Generator().manual_seed(seed))
    params = tree_unflatten(params, [p.detach().to(dev, torch.float32)
                                     for p in tree_leaves(params)])
    init, step = make_adam_step(restorer_loss, lr)
    opt_state = init(params)
    rng = np.random.default_rng(seed)
    with full_fp32():
        for i in range(steps):
            clean = make_face_crops(batch, seed=1000 + i)
            deg = degrade_faces(clean, rng)
            params, opt_state, loss = step(
                params, opt_state, torch.from_numpy(deg).to(dev),
                torch.from_numpy(clean).to(dev))
            if (i + 1) % log_every == 0:
                print(f"step {i + 1}: loss {float(loss):.4f}", flush=True)
    return params


def held_out(params, device=None) -> tuple[float, float]:
    """(restored, degraded) PSNR in dB on 16 held-out crops."""
    from ..runtime.face_handler import _face_net_apply
    from ..utils.metrics import psnr

    dev = resolve_device(device)
    clean = torch.from_numpy(make_face_crops(16, seed=999_999)).to(dev)
    deg = torch.from_numpy(degrade_faces(clean.cpu().numpy(),
                                         np.random.default_rng(123))).to(dev)
    with torch.inference_mode(), full_fp32():
        out = _face_net_apply(params, deg)
    return float(psnr(out, clean)), float(psnr(deg, clean))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=800)
    p.add_argument("--export", default="face_restorer.npz")
    p.add_argument("--platform", default=None)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    from ..runtime.weights import save_params

    device = resolve_device(args.device or (
        platform_device(args.platform) if args.platform else None))
    params = train(steps=args.steps, device=device)
    p_out, p_in = held_out(params, device)
    print(f"held-out: restored {p_out:.2f} dB vs degraded {p_in:.2f} dB")
    save_params(args.export, params)
    print(f"exported to {args.export}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
