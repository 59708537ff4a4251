"""Face-detector training on procedural scenes: the counterpart of
video_enhancer_tpu/train/face_detector.py.

Cluttered backgrounds with 0-3 procedural faces at random scales and
places, and skin-coloured featureless distractors, drawn with
``ops/cvhost.py`` as OpenCV draws them. Targets follow CenterNet: a
Gaussian-splat centre heatmap with the penalty-reduced focal loss, and L1
on log-size and centre offset at positive cells. The net is
``analysis/face_net.py``'s, trained with optax's Adam. ``make_alt_face_
scenes`` is the structurally different held-out family. The RNG draws are
the JAX package's, so a seed gives the same scenes.

    python -m video_enhancer_tpu_torch.train.face_detector --steps 1200 \\
        [--export face_detector.npz] [--device cpu]

The export defaults to ``face_detector.npz`` in the current directory:
the bundled weights under ``video_enhancer_tpu/weights/`` are never
written.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..analysis.face_net import GRID, INPUT_SIZE, STRIDE
from ..device import full_fp32, platform_device, resolve_device
from ..io.jpeg import jpeg_roundtrip
from ..ops import cvhost
from .step import make_adam_step, tree_leaves, tree_unflatten

__all__ = ["SKIN_BANDS", "make_face_scenes", "make_alt_face_scenes",
           "encode_targets", "evaluate", "detector_loss", "train", "main"]

# skin-tone bands (RGB multiplier ranges) for training and the validity
# strata
SKIN_BANDS = {
    "light": ((0.70, 0.95), (0.52, 0.75), (0.42, 0.65)),
    "medium": ((0.45, 0.72), (0.32, 0.55), (0.22, 0.45)),
    "deep": ((0.18, 0.45), (0.12, 0.34), (0.08, 0.28)),
}


def _sample_skin(rng, skin_band=None):
    if skin_band is None:
        # training default: a band uniformly, then uniformly within it
        skin_band = ("light", "medium", "deep")[int(rng.integers(0, 3))]
    (r0, r1), (g0, g1), (b0, b1) = SKIN_BANDS[skin_band]
    return np.array([rng.uniform(r0, r1), rng.uniform(g0, g1),
                     rng.uniform(b0, b1)], np.float32)


def _draw_face(img, rng, cx, cy, ax, ay, skin_band=None, occlude=False):
    """Draw one procedural face; returns its (x, y, w, h) box."""
    skin = _sample_skin(rng, skin_band)
    tilt = float(rng.uniform(-12, 12))
    cvhost.ellipse(img, (cx, cy), (ax, ay), tilt, 0, 360, skin.tolist(), -1)
    hair = rng.uniform(0.02, 0.4, 3).tolist()
    cvhost.ellipse(img, (cx, cy - ay // 2), (ax, ay // 2), tilt, 180, 360,
                   hair, -1)
    eye_dy, eye_dx = int(ay * 0.15), int(ax * 0.45)
    er = max(int(ax * rng.uniform(0.12, 0.18)), 1)
    iris = rng.uniform(0.05, 0.5, 3).tolist()
    for sx in (-1, 1):
        ex, ey = cx + sx * eye_dx, cy - eye_dy
        cvhost.ellipse(img, (ex, ey), (er, max(er // 2, 1)), tilt, 0, 360,
                       (0.95, 0.95, 0.95), -1)
        cvhost.circle(img, (ex, ey), max(er // 2, 1), iris, -1)
    cvhost.line(img, (cx, cy - eye_dy // 2),
                (cx + max(int(ax * 0.08), 1), cy + int(ay * 0.15)),
                (skin * 0.8).tolist(), 1)
    mw = max(int(ax * rng.uniform(0.35, 0.55)), 2)
    cvhost.ellipse(img, (cx, cy + int(ay * 0.45)), (mw, max(mw // 3, 1)),
                   tilt, 0, 180, (float(rng.uniform(0.4, 0.8)), 0.15, 0.2),
                   -1)
    if occlude:
        # a partial occluder over up to ~35% of the face
        oc = rng.uniform(0.1, 0.9, 3).tolist()
        side = int(rng.integers(0, 3))
        ow = max(int(2 * ax * rng.uniform(0.2, 0.35)), 2)
        if side == 0:   # a vertical bar across one side
            x0 = cx + int(rng.choice((-1, 1)) * ax * 0.5)
            cvhost.rectangle(img, (x0 - ow // 2, cy - ay),
                             (x0 + ow // 2, cy + ay), oc, -1)
        elif side == 1:  # a lower-face mask
            cvhost.rectangle(img, (cx - ax, cy + int(ay * 0.15)),
                             (cx + ax, cy + int(ay * 0.7)), oc, -1)
        else:            # a corner blob
            cvhost.circle(img, (cx + int(ax * 0.6), cy - int(ay * 0.6)),
                          max(int(ax * 0.45), 2), oc, -1)
    return (cx - ax, cy - ay, 2 * ax, 2 * ay)


def make_face_scenes(n: int, size: int = INPUT_SIZE, seed: int = 0,
                     skin_band: str | None = None,
                     scale_range: tuple[float, float] = (0.09, 0.3),
                     occlude_prob: float = 0.0):
    """(imgs (n, size, size, 3) float32, a box list per image).
    ``skin_band`` pins the faces to one band, ``scale_range`` bounds the
    face half-height as a fraction of the image, ``occlude_prob`` occludes
    that share of the faces."""
    rng = np.random.default_rng(seed)
    imgs = np.empty((n, size, size, 3), np.float32)
    all_boxes = []
    for i in range(n):
        img = np.empty((size, size, 3), np.float32)
        c0, c1 = rng.uniform(0.1, 0.9, 3), rng.uniform(0.1, 0.9, 3)
        ramp = np.linspace(0, 1, size, dtype=np.float32)[:, None, None]
        img[:] = c0 * (1 - ramp) + c1 * ramp
        for _ in range(rng.integers(1, 5)):
            x0, y0 = rng.integers(0, size - 8, 2)
            w, h = rng.integers(8, size // 2, 2)
            img[y0:y0 + h, x0:x0 + w] = rng.uniform(0, 1, 3)
        # skin-coloured featureless distractors
        for _ in range(rng.integers(0, 3)):
            dc = (float(rng.uniform(0.55, 0.95)),
                  float(rng.uniform(0.4, 0.75)),
                  float(rng.uniform(0.3, 0.65)))
            dx = int(rng.integers(8, size - 8))
            dy = int(rng.integers(8, size - 8))
            da = int(rng.integers(4, size // 4))
            if rng.random() < 0.5:
                cvhost.ellipse(img, (dx, dy),
                               (da, int(da * rng.uniform(0.5, 2.0)) + 1),
                               float(rng.uniform(0, 180)), 0, 360, dc, -1)
            else:
                cvhost.rectangle(img, (dx - da, dy - da), (dx + da, dy + da),
                                 dc, -1)

        boxes = []
        for _ in range(int(rng.integers(0, 4))):
            ay = int(size * rng.uniform(*scale_range))
            ax = max(int(ay * rng.uniform(0.7, 0.9)), 3)
            cx = int(rng.integers(ax + 1, size - ax - 1))
            cy = int(rng.integers(ay + 1, size - ay - 1))
            cand = (cx - ax, cy - ay, 2 * ax, 2 * ay)
            if any(_iou(cand, b) > 0.2 for b in boxes):
                continue
            boxes.append(_draw_face(
                img, rng, cx, cy, ax, ay, skin_band=skin_band,
                occlude=bool(rng.random() < occlude_prob)))

        # photometric jitter and degradations
        img = img * (1.0 + 0.25 * np.linspace(-1, 1, size)[None, :, None]
                     * rng.uniform(-1, 1))
        if rng.random() < 0.5:
            img = cvhost.gaussian_blur(img.astype(np.float32), 5,
                                       rng.uniform(0.3, 1.5))
        img = img + rng.normal(0, rng.uniform(0.005, 0.04), img.shape)
        imgs[i] = np.clip(img, 0.0, 1.0)
        all_boxes.append(boxes)
    return imgs, all_boxes


def _draw_alt_face(img, rng, cx, cy, ax, ay, skin_band=None,
                   occlude=False):
    """The held-out face compositor: a polygonal jaw, asymmetric 3/4-pose
    features, eyebrows, a nose shadow, ears and glasses; the same skin
    bands."""
    skin = _sample_skin(rng, skin_band)
    pose = float(rng.uniform(-0.35, 0.35))     # lateral feature shift
    # polygonal head: an 8-point jawline with a chin vertex
    angs = np.linspace(-np.pi / 2, 3 * np.pi / 2, 9)[:-1]
    rx = ax * (1.0 + rng.uniform(-0.08, 0.08, angs.size))
    ry = ay * (1.0 + rng.uniform(-0.08, 0.08, angs.size))
    pts = np.stack([cx + rx * np.cos(angs) * (1 + 0.2 * np.sin(angs)),
                    cy + ry * np.sin(angs)], axis=1)
    pts[0, 1] += ay * 0.15  # chin point
    cvhost.fill_poly(img, [pts.astype(np.int32)], skin.tolist())
    # radial shading
    shade = (skin * rng.uniform(0.6, 0.85)).tolist()
    cvhost.ellipse(img, (int(cx + pose * ax), cy), (int(ax * 0.35), ay),
                   0, 60, 300, shade, max(int(ax * 0.12), 1))
    # ears
    for sx in (-1, 1):
        cvhost.ellipse(img, (cx + sx * int(ax * 0.98), cy),
                       (max(int(ax * 0.14), 1), max(int(ay * 0.22), 1)),
                       0, 0, 360, (skin * 0.9).tolist(), -1)
    eye_dx = int(ax * 0.42)
    eye_y = cy - int(ay * 0.18)
    er = max(int(ax * rng.uniform(0.10, 0.16)), 1)
    iris = rng.uniform(0.05, 0.45, 3).tolist()
    brow = (skin * 0.35).tolist()
    for sx in (-1, 1):
        ex = cx + int(sx * eye_dx + pose * ax * 0.5)
        # almond eye: a filled triangle
        eye_pts = np.array([[ex - er * 2, eye_y], [ex + er * 2, eye_y],
                            [ex, eye_y + er]], np.int32)
        cvhost.fill_poly(img, [eye_pts], (0.92, 0.92, 0.9))
        cvhost.circle(img, (ex, eye_y), max(er // 2, 1), iris, -1)
        # eyebrow
        cvhost.line(img, (ex - er * 2, eye_y - er * 2),
                    (ex + er * 2, eye_y - er * 2
                     - int(er * rng.uniform(0, 1))),
                    brow, max(er // 2, 1))
    if rng.random() < 0.3:  # glasses
        gl = rng.uniform(0.05, 0.3, 3).tolist()
        for sx in (-1, 1):
            cvhost.circle(img, (cx + int(sx * eye_dx + pose * ax * 0.5),
                                eye_y), er * 2, gl, 1)
        cvhost.line(img, (cx - eye_dx + er * 2, eye_y),
                    (cx + eye_dx - er * 2, eye_y), gl, 1)
    # nose: a shaded triangle
    nx = cx + int(pose * ax * 0.7)
    nose = np.array([[nx, cy - int(ay * 0.1)],
                     [nx - max(int(ax * 0.12), 1), cy + int(ay * 0.22)],
                     [nx + max(int(ax * 0.16), 1), cy + int(ay * 0.22)]],
                    np.int32)
    cvhost.fill_poly(img, [nose], (skin * 0.8).tolist())
    # lips: a thin rectangle
    lw = max(int(ax * rng.uniform(0.3, 0.5)), 2)
    ly = cy + int(ay * 0.5)
    lip = (float(rng.uniform(0.45, 0.75)), 0.2, 0.25)
    cvhost.rectangle(img,
                     (cx - lw + int(pose * ax * 0.5), ly - max(lw // 6, 1)),
                     (cx + lw + int(pose * ax * 0.5), ly + max(lw // 6, 1)),
                     lip, -1)
    if rng.random() < 0.35:  # stubble on the lower face
        ys = slice(max(cy, 0), min(cy + ay, img.shape[0]))
        xs = slice(max(cx - ax, 0), min(cx + ax, img.shape[1]))
        patch = img[ys, xs]
        patch -= (rng.random(patch.shape[:2])[..., None] < 0.25) \
            * rng.uniform(0.05, 0.18)
    if occlude:
        oc = rng.uniform(0.1, 0.9, 3).tolist()
        if rng.random() < 0.5:  # a diagonal bar
            p0 = (cx - ax, cy + int(rng.integers(-ay, ay)))
            p1 = (cx + ax, cy + int(rng.integers(-ay, ay)))
            cvhost.line(img, p0, p1, oc, max(int(ay * 0.4), 2))
        else:  # a hood: the top arc filled
            cvhost.ellipse(img, (cx, cy - int(ay * 0.3)),
                           (int(ax * 1.05), int(ay * 0.8)), 0, 180, 360,
                           oc, -1)
    return (cx - ax, cy - ay, 2 * ax, 2 * ay)


def make_alt_face_scenes(n: int, size: int = INPUT_SIZE, seed: int = 0,
                         skin_band: str | None = None,
                         scale_range: tuple[float, float] = (0.09, 0.3),
                         occlude_prob: float = 0.0):
    """The held-out scene family: the alt compositor on low-frequency
    noise with line clutter, then motion blur, a gamma shift and JPEG.
    ``make_face_scenes``'s return contract."""
    rng = np.random.default_rng(seed ^ 0x5EED_FACE)
    imgs = np.empty((n, size, size, 3), np.float32)
    all_boxes = []
    for i in range(n):
        small = rng.random((6, 6, 3)).astype(np.float32)
        img = np.ascontiguousarray(cvhost.resize(
            small, (size, size), interpolation=cvhost.INTER_CUBIC))
        img = np.clip(img, 0, 1)
        for _ in range(int(rng.integers(2, 7))):  # line clutter
            p0 = tuple(int(v) for v in rng.integers(0, size, 2))
            p1 = tuple(int(v) for v in rng.integers(0, size, 2))
            cvhost.line(img, p0, p1, rng.uniform(0, 1, 3).tolist(),
                        int(rng.integers(1, 4)))
        # skin-coloured polygon distractors
        for _ in range(int(rng.integers(0, 3))):
            dc = (float(rng.uniform(0.5, 0.95)),
                  float(rng.uniform(0.35, 0.7)),
                  float(rng.uniform(0.25, 0.6)))
            ctr = rng.integers(12, size - 12, 2)
            verts = ctr + rng.integers(-14, 15, (5, 2))
            cvhost.fill_poly(img, [verts.astype(np.int32)], dc)

        boxes = []
        for _ in range(int(rng.integers(0, 4))):
            ay = int(size * rng.uniform(*scale_range))
            ax = max(int(ay * rng.uniform(0.65, 0.95)), 3)
            cx = int(rng.integers(ax + 1, size - ax - 1))
            cy = int(rng.integers(ay + 1, size - ay - 1))
            cand = (cx - ax, cy - ay, 2 * ax, 2 * ay)
            if any(_iou(cand, b) > 0.2 for b in boxes):
                continue
            boxes.append(_draw_alt_face(
                img, rng, cx, cy, ax, ay, skin_band=skin_band,
                occlude=bool(rng.random() < occlude_prob)))

        # directional motion blur, a JPEG re-encode, a gamma shift
        if rng.random() < 0.5:
            k = int(rng.integers(3, 8))
            kern = np.zeros((k, k), np.float32)
            kern[k // 2] = 1.0 / k
            ang = float(rng.uniform(0, 180))
            rot = cvhost.rotation_matrix_2d((k / 2 - 0.5, k / 2 - 0.5), ang,
                                            1)
            kern = cvhost.warp_affine(kern, rot, (k, k), border="constant")
            kern /= max(kern.sum(), 1e-6)
            img = cvhost.filter2d(img, kern)
        img = np.clip(img, 0, 1) ** float(rng.uniform(0.8, 1.25))
        if rng.random() < 0.6:
            q = int(rng.integers(40, 90))
            # the JAX package encodes the RGB frame as cv2's BGR
            u8 = np.ascontiguousarray((img * 255).astype(np.uint8)[:, :, ::-1])
            img = jpeg_roundtrip(u8, q)[:, :, ::-1].astype(np.float32) / 255.0
        imgs[i] = np.clip(img, 0.0, 1.0)
        all_boxes.append(boxes)
    return imgs, all_boxes


def _iou(a, b) -> float:
    ax, ay, aw, ah = a
    bx, by, bw, bh = b
    x1, y1 = max(ax, bx), max(ay, by)
    x2, y2 = min(ax + aw, bx + bw), min(ay + ah, by + bh)
    inter = max(x2 - x1, 0) * max(y2 - y1, 0)
    union = aw * ah + bw * bh - inter
    return inter / union if union > 0 else 0.0


def encode_targets(boxes_per_img, batch: int) -> tuple:
    """CenterNet targets: heatmap (B, G, G), regression (B, G, G, 4), mask
    (B, G, G)."""
    heat = np.zeros((batch, GRID, GRID), np.float32)
    reg = np.zeros((batch, GRID, GRID, 4), np.float32)
    mask = np.zeros((batch, GRID, GRID), np.float32)
    gy_idx, gx_idx = np.mgrid[0:GRID, 0:GRID]
    for b, boxes in enumerate(boxes_per_img):
        for (x, y, w, h) in boxes:
            cx, cy = (x + w / 2) / STRIDE, (y + h / 2) / STRIDE
            gx, gy = min(int(cx), GRID - 1), min(int(cy), GRID - 1)
            sigma = max(min(w, h) / STRIDE / 3.0, 0.7)
            splat = np.exp(-((gx_idx - cx) ** 2 + (gy_idx - cy) ** 2)
                           / (2 * sigma * sigma)).astype(np.float32)
            heat[b] = np.maximum(heat[b], splat)
            reg[b, gy, gx] = (np.log(max(w / STRIDE, 1e-3)),
                              np.log(max(h / STRIDE, 1e-3)),
                              cx - gx, cy - gy)
            mask[b, gy, gx] = 1.0
            heat[b, gy, gx] = 1.0
    return heat, reg, mask


def evaluate(params, n: int = 64, seed: int = 424_242,
             iou_thresh: float = 0.5, detect_fn=None,
             generator: str = "train", device=None,
             **scene_kw) -> tuple[float, float]:
    """(recall, precision) at IoU 0.5 over held-out scenes. ``detect_fn
    (frame_u8) -> boxes`` replaces the net; ``generator`` is ``train``
    (``make_face_scenes``) or ``alt`` (``make_alt_face_scenes``);
    ``scene_kw`` goes to the scene maker."""
    from ..analysis import face_net

    if detect_fn is None:
        dev = params["head"]["w"].device if device is None else device

        def detect_fn(frame):
            return face_net.detect(params, frame, device=dev)
    scenes = {"train": make_face_scenes,
              "alt": make_alt_face_scenes}[generator]
    imgs, gt = scenes(n, seed=seed, **scene_kw)
    tp = fp = fn = 0
    for i in range(n):
        frame = (imgs[i] * 255).astype(np.uint8)
        det = detect_fn(frame)
        matched = set()
        for d in det:
            hit = None
            for j, g in enumerate(gt[i]):
                if j not in matched and _iou(d, g) >= iou_thresh:
                    hit = j
                    break
            if hit is None:
                fp += 1
            else:
                matched.add(hit)
                tp += 1
        fn += len(gt[i]) - len(matched)
    return tp / max(tp + fn, 1), tp / max(tp + fp, 1)


def detector_loss(p, imgs, heat, reg, mask):
    """The penalty-reduced focal loss on the heatmap plus L1 on the
    regression at the positive cells, per positive cell."""
    from ..analysis import face_net

    out = face_net.apply(p, imgs)
    prob = torch.clamp(torch.sigmoid(out[..., 0]), 1e-5, 1.0 - 1e-5)
    pos = (heat >= 1.0 - 1e-6).float()
    pos_loss = -pos * ((1 - prob) ** 2) * torch.log(prob)
    neg_loss = -(1 - pos) * ((1 - heat) ** 4) * (prob ** 2) \
        * torch.log(1 - prob)
    n_pos = torch.clamp(pos.sum(), min=1.0)
    l_heat = (pos_loss.sum() + neg_loss.sum()) / n_pos
    l_reg = (torch.abs(out[..., 1:5] - reg).sum(-1) * mask).sum() / n_pos
    return l_heat + l_reg


def train(steps: int = 1200, batch: int = 16, lr: float = 3e-4,
          seed: int = 0, device=None, params=None, log_every: int = 100):
    """The detector's parameters after ``steps`` Adam steps (random from
    ``seed`` unless ``params`` is given), on ``device``."""
    from ..analysis import face_net

    dev = resolve_device(device)
    if params is None:
        params = face_net.init(torch.Generator().manual_seed(seed))
    params = tree_unflatten(params, [p.detach().to(dev, torch.float32)
                                     for p in tree_leaves(params)])
    init, step = make_adam_step(detector_loss, lr)
    opt_state = init(params)
    with full_fp32():
        for i in range(steps):
            imgs, boxes = make_face_scenes(batch, seed=10_000 + i)
            targets = encode_targets(boxes, batch)
            params, opt_state, loss = step(
                params, opt_state, torch.from_numpy(imgs).to(dev),
                *(torch.from_numpy(t).to(dev) for t in targets))
            if (i + 1) % log_every == 0:
                print(f"step {i + 1}: loss {float(loss):.4f}", flush=True)
    return params


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=1200)
    p.add_argument("--export", default="face_detector.npz")
    p.add_argument("--platform", default=None)
    p.add_argument("--device", default=None)
    p.add_argument("--eval-n", type=int, default=64,
                   help="held-out scenes for the recall / precision")
    args = p.parse_args(argv)
    from ..runtime.weights import save_params

    device = resolve_device(args.device or (
        platform_device(args.platform) if args.platform else None))
    params = train(steps=args.steps, device=device)
    recall, precision = evaluate(params, n=args.eval_n)
    print(f"held-out IoU@0.5: recall {recall:.3f} precision {precision:.3f}")
    save_params(args.export, params)
    print(f"exported to {args.export}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
