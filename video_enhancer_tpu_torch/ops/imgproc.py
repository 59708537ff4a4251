"""OpenCV's image filters that the quality scores and the skin-blob face
detector read, without OpenCV.

- ``laplacian``: ``cv2.Laplacian(img, cv2.CV_32F)`` (ksize 1, the 4-neighbour
  stencil) with reflect-101 borders, in fp32 on the image's device; the
  quality gate of scale-1 models (runtime/vsr_handler.py) and the face
  quality score (runtime/face_handler.py) take its variance.
- ``morph_close``: ``cv2.morphologyEx(mask, MORPH_CLOSE, ones((k, k)),
  iterations=n)``: n dilations, then n erosions, each a k x k max-pool on the
  mask's device, with borders that never win (-inf for a dilation, +inf for
  an erosion: cv2's default border value for both).
- ``connected_components``: ``cv2.connectedComponentsWithStats(mask)`` at
  8-connectivity, on the host (``scipy.ndimage.label``). cv2 5 scans the
  image in 2x2 blocks, two rows at a time, and numbers a component when it
  meets its first block; the four pixels of a block are 8-connected to each
  other, so a block belongs to one component at most. The labels are
  therefore numbered in the raster order of each component's first block,
  which is not scipy's raster order of its first pixel, and are renumbered
  so. Stats rows are ``(x, y, w, h, area)``, row 0 the background's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["laplacian", "morph_close", "connected_components"]


def laplacian(img: torch.Tensor) -> torch.Tensor:
    """cv2's ``Laplacian(img, CV_32F)`` (ksize 1) of ``(H, W)`` fp32:
    ``up + down + left + right - 4 centre``, reflect-101 borders."""
    p = F.pad(img.float()[None, None], (1, 1, 1, 1), mode="reflect")[0, 0]
    return (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
            - 4.0 * p[1:-1, 1:-1])


def morph_close(mask: torch.Tensor, ksize: int = 5,
                iterations: int = 2) -> torch.Tensor:
    """cv2's ``MORPH_CLOSE`` of ``(H, W)`` by a ``ksize`` square of ones,
    ``iterations`` times; the mask's dtype is kept."""
    x = mask.float()[None, None]
    pad = ksize // 2
    for _ in range(iterations):          # max-pool pads with -inf
        x = F.max_pool2d(x, ksize, stride=1, padding=pad)
    for _ in range(iterations):
        x = -F.max_pool2d(-x, ksize, stride=1, padding=pad)
    return x[0, 0].to(mask.dtype)


def connected_components(mask: np.ndarray) -> tuple[int, np.ndarray]:
    """``n, _, stats, _ = cv2.connectedComponentsWithStats(mask)`` of a
    ``(H, W)`` array (nonzero is foreground), 8-connectivity: the number of
    labels with the background and the int32 ``(n, 5)`` stats ``(x, y, w,
    h, area)`` in cv2's order of labels."""
    from scipy import ndimage

    fg = np.asarray(mask) != 0
    h, w = fg.shape
    labels, n = ndimage.label(fg, structure=np.ones((3, 3), bool))
    stats = np.zeros((n + 1, 5), np.int32)
    bg = ~fg
    if bg.any():
        ys, xs = np.nonzero(bg)
        stats[0] = (xs.min(), ys.min(), xs.max() - xs.min() + 1,
                    ys.max() - ys.min() + 1, ys.size)
    if n == 0:
        return 1, stats
    ys, xs = np.nonzero(labels)
    lab = labels[ys, xs]
    block = (ys // 2) * ((w + 1) // 2) + xs // 2
    first = np.full(n + 1, np.iinfo(np.int64).max)
    np.minimum.at(first, lab, block)
    order = np.argsort(first[1:], kind="stable") + 1   # scipy label -> rank
    area = np.bincount(lab, minlength=n + 1)
    for i, sl in enumerate(ndimage.find_objects(labels), start=1):
        y, x = sl
        stats[i] = (x.start, y.start, x.stop - x.start, y.stop - y.start,
                    area[i])
    stats[1:] = stats[order]
    return n + 1, stats
