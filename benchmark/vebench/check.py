"""How ``correct`` is decided: the program's delivered frames against the
plain reference, recomputed from the same input frames.

After the window has closed and the program is freed, a sample of the
windows the program delivered in full is drawn from the seed (always the
first window of a clip and its padded tail where they were delivered).
The reference runs each of them from the input frames through its own
windows, tiles, ramp blend, model, calibrated blend and uint8 rounding, in
float32 with TF32 off, and every output frame of those windows is compared
with the program's, pixel by pixel, in units of one 8-bit level (LSB):

- ``mean_lsb``: the mean absolute difference over all sampled pixels;
- ``frame_mean_lsb``: the largest mean absolute difference of one frame;
- ``max_lsb``: the widest difference of one pixel;
- ``share_ge4``: the share of pixels that differ by 4 or more.

The configuration's ``limits`` name the numbers compared and their
limits; a frame that is due and never delivered also makes a run not
correct.
"""

from __future__ import annotations

import numpy as np
import torch

NUMBERS = ("mean_lsb", "frame_mean_lsb", "max_lsb", "share_ge4")


class Tally:
    """The compared numbers over the frames added to it."""

    def __init__(self):
        self.sum = 0.0
        self.count = 0
        self.ge4 = 0
        self.max = 0
        self.frame_max = 0.0
        self.frames = 0

    def add(self, ref_u8: torch.Tensor, got_u8: torch.Tensor) -> None:
        d = (ref_u8.int() - got_u8.to(ref_u8.device).int()).abs()
        per_frame = d.flatten(1).double().mean(1)
        self.sum += float(d.double().sum())
        self.count += d.numel()
        self.ge4 += int((d >= 4).sum())
        self.max = max(self.max, int(d.max()))
        self.frame_max = max(self.frame_max, float(per_frame.max()))
        self.frames += d.shape[0]

    def numbers(self) -> dict:
        n = max(self.count, 1)
        return {"mean_lsb": self.sum / n, "frame_mean_lsb": self.frame_max,
                "max_lsb": float(self.max), "share_ge4": self.ge4 / n}


def reference_window(ref, params, frames_u8: np.ndarray, window, ops,
                     config: dict, context, device) -> torch.Tensor:
    """The reference's uint8 output frames of one window (its emitted
    frames, in order)."""
    import plain

    start, idx, emitted = window
    clip = torch.from_numpy(frames_u8[idx]).to(device).float() / 255.0
    with torch.no_grad(), plain.full_fp32():
        out = plain.run_window(
            lambda b: ref.forward(params, b, ops, context), clip,
            scale=config["scale"], tile=config["tile"],
            tile_overlap=config["tile_overlap"])
    return plain.to_u8(out[[f - start for f in emitted]])


def judge(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= v for k, v in limits.items())
