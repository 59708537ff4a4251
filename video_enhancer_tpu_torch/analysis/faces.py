"""Face detection: a first-hit chain of detectors, and the router's face
prominence.

Counterpart of video_enhancer_tpu/analysis/faces.py. The chain:

1. the bundled neural detector (analysis/face_net.py,
   ``weights/face_detector.npz``), on ``device``;
2. where it finds nothing (no detection, not "no faces": small faces vanish
   on its 128x128 input), the skin-tone blob heuristic: cv2's YCrCb (ops/
   color.py) inside the Chai & Ngan window, a 5x5 closing twice (ops/
   imgproc.py), both on ``device``, then the connected components on the
   host, kept by area, aspect and fill.

The JAX chain's first tier, ``cv2.FaceDetectorYN`` over an ONNX model named
by ``FACE_DETECTOR_ONNX``, needs OpenCV, which the card's machine does not
have: the port behaves as the JAX package does when that tier cannot be
created (its ``_yn_failed``), so it detects with the two tiers above and
``face_chain_trusted`` ignores ``FACE_DETECTOR_ONNX``. A neural detector
whose weights are missing or cannot be read is skipped, as in JAX.

``face_area_ratio`` is the router's ``face_prominence``: the mean over
``frames[::max(len // 4, 1)]`` of the boxes' area over the frame's.
``face_chain_trusted`` reads ``docs/FACE_VALIDITY.json``: the chain is
trusted when its ``chain_min_recall`` is at least 0.5 (a missing or
unreadable report is not trusted).

Every frame costs the host a copy back: the net's 16x16 head output, and,
where the net finds nothing, the closed skin mask.
"""

from __future__ import annotations

import functools
import json
import logging
from pathlib import Path

import numpy as np
import torch

from ..device import resolve_device
from ..ops.color import rgb_to_ycrcb
from ..ops.imgproc import connected_components, morph_close
from . import face_net

log = logging.getLogger(__name__)

__all__ = ["detect_faces", "face_area_ratio", "face_chain_trusted",
           "skin_blob_faces", "nn_detector"]

_ROOT = Path(__file__).resolve().parents[2]
WEIGHTS_DIR = _ROOT / "video_enhancer_tpu" / "weights"
DETECTOR_WEIGHTS = WEIGHTS_DIR / "face_detector.npz"
VALIDITY_REPORT = _ROOT / "docs" / "FACE_VALIDITY.json"
TRUST_FLOOR = 0.5


@functools.lru_cache(maxsize=4)
def nn_detector(device: torch.device) -> dict | None:
    """The bundled detector's parameters on ``device``; None when the file
    is missing or matches nothing (the chain then skips the tier)."""
    from ..runtime.weights import try_load_params

    if not DETECTOR_WEIGHTS.exists():
        return None
    params = try_load_params(DETECTOR_WEIGHTS,
                             face_net.init(torch.Generator().manual_seed(0)))
    if params is None:
        return None
    return {k: {n: t.to(device) for n, t in v.items()}
            for k, v in params.items()}


def skin_blob_faces(frame, device: torch.device
                    ) -> list[tuple[int, int, int, int]]:
    """Boxes of skin-toned blobs of a uint8 RGB frame (the JAX package's
    ``_skin_blob_faces``)."""
    h, w = frame.shape[:2]
    ycc = rgb_to_ycrcb(torch.as_tensor(frame).to(device))
    y, cr, cb = ycc.unbind(-1)
    mask = ((cr > 133) & (cr < 173) & (cb > 77) & (cb < 127) & (y > 40)
            ).to(torch.uint8) * 255
    n, stats = connected_components(morph_close(mask).cpu().numpy())
    boxes = []
    min_area = max((h * w) // 400, 36)
    for i in range(1, n):
        x, y0, bw, bh, area = stats[i]
        if area < min_area:
            continue
        aspect = bw / max(bh, 1)
        fill = area / max(bw * bh, 1)
        if 0.4 <= aspect <= 1.6 and fill > 0.4:
            boxes.append((int(x), int(y0), int(bw), int(bh)))
    return boxes


def detect_faces(frame,
                 device: str | torch.device | None = None
                 ) -> list[tuple[int, int, int, int]]:
    """``(x, y, w, h)`` boxes of the faces in a uint8 RGB ``(H, W, 3)``
    frame (numpy or a tensor): the neural detector's, or where it finds
    none, the skin blobs'."""
    dev = resolve_device(device)
    params = nn_detector(dev)
    if params is not None:
        try:
            boxes = face_net.detect(params, frame, device=dev)
        except Exception:  # a failed tier is skipped, as in JAX
            log.warning("the neural face detector failed", exc_info=True)
            boxes = None
        if boxes:
            return boxes
    return skin_blob_faces(frame, dev)


def face_area_ratio(frames, max_samples: int = 4,
                    device: str | torch.device | None = None) -> float:
    """Mean face-area ratio over ``frames[::max(len // max_samples, 1)]``
    of uint8 ``(T, H, W, 3)`` frames (numpy or a tensor)."""
    dev = resolve_device(device)
    step = max(len(frames) // max_samples, 1)
    ratios = []
    for f in frames[::step]:
        area = sum(w * h for (_, _, w, h) in detect_faces(f, dev))
        ratios.append(area / (f.shape[0] * f.shape[1]))
    return float(np.mean(ratios)) if ratios else 0.0


@functools.cache
def _chain_min_recall() -> float:
    try:
        return float(json.loads(VALIDITY_REPORT.read_text())
                     ["chain_min_recall"])
    except Exception:  # a missing or unreadable report is not trusted
        return -1.0


def face_chain_trusted(floor: float = TRUST_FLOOR) -> bool:
    """Whether the chain's committed validity report clears ``floor``
    (worst-stratum recall)."""
    return _chain_min_recall() >= floor
