"""The calibrated perceptual metric (LPIPS stand-in): the metric part of
the JAX package's train/lpips.py.

A small conv feature net, trained in the JAX package with a margin
ranking loss on synthetic distortion ladders; the port loads its bundled
weights (``weights/lpips_proxy.npz``, read-only) into ``feat_init``'s
template and evaluates the distance in torch on the caller's device.
``distort`` and the ladders use ``ops/cvhost.py`` in place of OpenCV.
``train`` retrains it with optax's Adam on the temperature-scaled ranking
loss, and

    python -m video_enhancer_tpu_torch.train.lpips --steps 400 \
        [--export lpips_proxy.npz] [--device cpu]

prints the held-out severity Spearman and exports ``{"layers": ...}``;
the export defaults to ``lpips_proxy.npz`` in the current directory, and
the bundled weights under ``video_enhancer_tpu/weights/`` are never
written.
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np
import torch

from .. import nn
from ..device import full_fp32, platform_device, resolve_device
from ..ops import cvhost
from ..runtime.vsr_handler import cast_params
from ..runtime.weights import try_load_params
from .step import make_adam_step

__all__ = ["feat_init", "feat_apply", "lpips_distance", "load_proxy",
           "DISTORTIONS", "distort", "make_rank_batch", "spearman",
           "severity_ladder_corr", "rank_loss", "train", "main",
           "PROXY_NPZ"]

PROXY_NPZ = (pathlib.Path(__file__).resolve().parents[2]
             / "video_enhancer_tpu" / "weights" / "lpips_proxy.npz")


def feat_init(gen: torch.Generator, widths=(16, 24, 32)) -> list:
    params = []
    cin = 3
    for w in widths:
        params.append(nn.conv2d_init(gen, 3, 3, cin, w))
        cin = w
    return params


def feat_apply(params: list, x: torch.Tensor) -> list:
    """x (B, H, W, 3) -> the list of stride-2 feature maps."""
    feats = []
    h = x
    for p in params:
        h = torch.relu(nn.conv2d_apply(p, h, stride=2))
        feats.append(h)
    return feats


def lpips_distance(params: list, a: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """Mean squared difference of channel-normalized features, averaged
    over layers, positions and two image scales (full and half). a, b:
    (B, H, W, 3); returns (B,)."""
    def norm(z):
        zf = z.float()
        return zf * torch.rsqrt(torch.sum(zf * zf, dim=-1, keepdim=True)
                                + 1e-8)

    def pool2(z):
        bs, h, w, c = z.shape
        z = z[:, :h // 2 * 2, :w // 2 * 2]          # tolerate odd sizes
        return z.reshape(bs, h // 2, 2, w // 2, 2, c).mean(dim=(2, 4))

    total = torch.zeros(a.shape[0], dtype=torch.float32, device=a.device)
    n_terms = 0
    for xa, xb in ((a, b), (pool2(a), pool2(b))):
        for fa, fb in zip(feat_apply(params, xa), feat_apply(params, xb)):
            d = norm(fa) - norm(fb)
            total = total + torch.mean(d * d, dim=(1, 2, 3))
            n_terms += 1
    return total / n_terms


def load_proxy(device=None) -> list | None:
    """The bundled proxy's layers on ``device`` (fp32), or None when the
    npz is missing or loads nothing."""
    loaded = try_load_params(PROXY_NPZ,
                             {"layers": feat_init(torch.Generator())})
    if loaded is None:
        return None
    return cast_params(loaded["layers"], torch.float32,
                       resolve_device(device))


DISTORTIONS = ("blur", "noise", "jpegish", "downup")


def distort(img: np.ndarray, kind: str, severity: float,
            rng: np.random.Generator) -> np.ndarray:
    """severity in [0, 1] -> a progressively worse version of img (H, W,
    3)."""
    out = img.astype(np.float32)
    if kind == "blur":
        out = cvhost.gaussian_blur(out, 9, 0.3 + 4.0 * severity)
    elif kind == "noise":
        out = out + rng.normal(0, 0.02 + 0.25 * severity,
                               out.shape).astype(np.float32)
    elif kind == "jpegish":
        f = max(1.0 - 0.8 * severity, 0.15)
        h, w = out.shape[:2]
        small = cvhost.resize(out, (max(int(w * f), 4), max(int(h * f), 4)))
        out = cvhost.resize(small, (w, h),
                            interpolation=cvhost.INTER_NEAREST)
    elif kind == "downup":
        f = max(1.0 - 0.75 * severity, 0.2)
        h, w = out.shape[:2]
        small = cvhost.resize(out, (max(int(w * f), 4), max(int(h * f), 4)),
                              interpolation=cvhost.INTER_AREA)
        out = cvhost.resize(small, (w, h), interpolation=cvhost.INTER_LINEAR)
    return np.clip(out, 0.0, 1.0)


def make_rank_batch(frames: np.ndarray, batch: int, crop: int, seed: int):
    """(ref, milder, worse) triplets with a random distortion type."""
    rng = np.random.default_rng(seed)
    n, H, W, _ = frames.shape
    ref = np.empty((batch, crop, crop, 3), np.float32)
    mild = np.empty_like(ref)
    worse = np.empty_like(ref)
    for i in range(batch):
        f = frames[rng.integers(0, n)]
        y = rng.integers(0, max(H - crop, 1))
        x = rng.integers(0, max(W - crop, 1))
        patch = f[y:y + crop, x:x + crop].astype(np.float32)
        if patch.max() > 1.5:
            patch = patch / 255.0
        kind = DISTORTIONS[rng.integers(0, len(DISTORTIONS))]
        s1 = rng.uniform(0.05, 0.5)
        s2 = s1 + rng.uniform(0.2, 0.5)
        ref[i] = patch
        mild[i] = distort(patch, kind, s1, rng)
        worse[i] = distort(patch, kind, min(s2, 1.0), rng)
    return ref, mild, worse


def spearman(a, b) -> float:
    """Spearman rank correlation, no scipy."""
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra * ra).sum() * (rb * rb).sum())
    return float((ra * rb).sum() / (denom + 1e-12))


def severity_ladder_corr(params: list, frames: np.ndarray, crop: int = 96,
                         n_ladders: int = 12, steps: int = 8,
                         seed: int = 12345, device=None) -> float:
    """Mean Spearman correlation between the metric's distance and the
    true quality order (by PSNR) over held-out distortion ladders, with
    the distances computed on ``device`` (``params``' device by
    default)."""
    dev = (params[0]["w"].device if device is None
           else resolve_device(device))
    rng = np.random.default_rng(seed)
    corrs = []
    n, H, W, _ = frames.shape
    sevs = np.linspace(0.05, 1.0, steps)
    for _ in range(n_ladders):
        f = frames[rng.integers(0, n)]
        y = rng.integers(0, max(H - crop, 1))
        x = rng.integers(0, max(W - crop, 1))
        patch = f[y:y + crop, x:x + crop].astype(np.float32)
        if patch.max() > 1.5:
            patch = patch / 255.0
        kind = DISTORTIONS[rng.integers(0, len(DISTORTIONS))]
        ladder = np.stack([distort(patch, kind, s, rng) for s in sevs])
        refs = np.broadcast_to(patch, ladder.shape)
        with torch.inference_mode():
            d = lpips_distance(
                params, torch.from_numpy(np.ascontiguousarray(refs)).to(dev),
                torch.from_numpy(ladder).to(dev)).cpu().numpy()
        mse = ((ladder - refs) ** 2).mean(axis=(1, 2, 3))
        quality = -10.0 * np.log10(mse + 1e-12)  # PSNR
        corrs.append(spearman(d, -quality))
    return float(np.mean(corrs))


def rank_loss(p, ref, mild, worse):
    """The temperature-scaled ranking loss: the milder distortion must
    score closer (raw distances are O(1e-3), hence the scale)."""
    d_mild = lpips_distance(p, ref, mild)
    d_worse = lpips_distance(p, ref, worse)
    return torch.mean(torch.nn.functional.softplus(80.0 * (d_mild - d_worse)
                                                   + 1.0))


def train(steps: int = 400, batch: int = 16, crop: int = 96,
          lr: float = 1e-3, seed: int = 0, device=None, params=None,
          log_every: int = 50):
    """``(layers, frames)``: the proxy after ``steps`` Adam steps on the
    demo frames' ranking batches (random from ``seed`` unless ``params``
    is given), on ``device``."""
    from ..io.demo import make_demo_frames

    dev = resolve_device(device)
    frames = make_demo_frames(32, (192, 192))
    if params is None:
        params = feat_init(torch.Generator().manual_seed(seed))
    params = [{k: v.detach().to(dev, torch.float32) for k, v in layer.items()}
              for layer in params]
    init, step = make_adam_step(rank_loss, lr)
    opt_state = init(params)
    with full_fp32():
        for i in range(steps):
            batch_np = make_rank_batch(frames, batch, crop, seed=i)
            params, opt_state, loss = step(
                params, opt_state,
                *(torch.from_numpy(a).to(dev) for a in batch_np))
            if (i + 1) % log_every == 0:
                print(f"step {i + 1}: rank loss {float(loss):.4f}",
                      flush=True)
    return params, frames


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Train the LPIPS proxy.")
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--export", default="lpips_proxy.npz")
    p.add_argument("--platform", default=None)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    from ..runtime.weights import save_params

    device = resolve_device(args.device or (
        platform_device(args.platform) if args.platform else None))
    params, frames = train(steps=args.steps, device=device)
    with full_fp32():
        corr = severity_ladder_corr(params, frames)
    print(f"held-out severity Spearman: {corr:.3f}")
    save_params(args.export, {"layers": params})
    print(f"exported to {args.export}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
