#!/usr/bin/env python3
"""The flash-attention kernel (TPU kernel row 4) and the fused bidirectional
SSM (row 3) of the PyTorch/CUDA port at the paths' shapes, for an A/B of
two checkouts in one call.

    python3 scripts/torch_profile_kernels.py [--root DIR] [--tag NAME]

Imports ``chip_smoke`` and ``video_enhancer_tpu_torch`` from ``--root``
(this checkout by default), builds the kernels with ``ptxas -v`` and
prints the registers and shared memory of these two sources' kernels.
Then each case: the kernel against its plain version (max |kernel -
plain| / max |plain|, held to ``chip_smoke.TOL``), and the median
CUDA-event time of 10 runs after 3 warm-ups; beside flash at ditvr's
shape, ``scaled_dot_product_attention`` on the same inputs. Cases: flash
in bf16 at ditvr's shape (B 2, H 3, L 10080, Dh 128, views of one qkv
projection) and at ragged lengths; the fused SSM in fp32 and bf16 at
vsrm's (57600, 7, 128, N 4) and fast_mamba_vsr's (57600, 16, 96, N 8)
shapes. The last line is one JSON object: the tag, the card, each case's
ms and error.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
ap.add_argument("--tag", default="")
args = ap.parse_args()
sys.path.insert(0, str(Path(args.root).resolve()))

import chip_smoke  # noqa: E402
from video_enhancer_tpu_torch import kernels  # noqa: E402
from video_enhancer_tpu_torch.ops.attention import (attention_ref,  # noqa: E402
                                                    flash_attention)
from video_enhancer_tpu_torch.ops.scan import (  # noqa: E402
    fused_bidir_ssm_kernel, fused_bidir_ssm_plain)

FLASH_CASES = [dict(B=2, H=3, Lq=10080, Lk=10080, Dh=128),
               dict(B=2, H=3, Lq=300, Lk=1000, Dh=128),
               dict(B=2, H=3, Lq=129, Lk=1000, Dh=48)]
FUSED_CASES = [("vsrm", chip_smoke.BISSM_SHAPE),
               ("fast_mamba_vsr", chip_smoke.BISSM_FMV_SHAPE)]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_profile_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    smi = chip_smoke.nvidia_smi()
    _, log = kernels.build(ptxas_verbose=True)
    src = None
    for line in log.splitlines():
        if "Compiling entry" in line:
            src = ("flash" if "flash" in line else
                   "fused" if "fused_bissm" in line else None)
        if src and any(w in line for w in ("Compiling entry", "Used", "spill")):
            print(f"  ptxas {src}: {line.strip()}")
    kernels.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out, ok = {}, True
    with torch.inference_mode():
        for ci, shp in enumerate(FLASH_CASES):
            gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 2
                                                             + ci)
            q, k, v = chip_smoke._flash_inputs(torch.bfloat16, gen, **shp)
            got = flash_attention(q, k, v)
            ref = attention_ref(q, k, v)
            torch.cuda.synchronize()
            err, rel = chip_smoke.rel_err(got, ref)
            ms = chip_smoke.time_ms(lambda: flash_attention(q, k, v))
            key = "flash {B}x{H} {Lq}x{Lk} Dh{Dh}".format(**shp)
            rec = {"ms": ms, "rel": rel, "max_abs_err": err}
            if ci == 0:
                sdpa = torch.nn.functional.scaled_dot_product_attention
                rec["sdpa_ms"] = chip_smoke.time_ms(lambda: sdpa(q, k, v))
            good = rel <= chip_smoke.TOL[("flash_attention", "bfloat16")]
            ok &= good and bool(torch.isfinite(got.float()).all())
            print(f"{key} bf16: {rec} {'ok' if good else 'FAILED'}",
                  flush=True)
            out[key] = rec
            del q, k, v, got, ref
        for name, shape in FUSED_CASES:
            for dtype in (torch.float32, torch.bfloat16):
                gen = torch.Generator(device="cuda").manual_seed(
                    chip_smoke.SEED + 1)
                a = chip_smoke._bissm_inputs(dtype, gen, shape)
                got = fused_bidir_ssm_kernel(*a)
                ref = fused_bidir_ssm_plain(*a)
                torch.cuda.synchronize()
                err, rel = chip_smoke.rel_err(got, ref)
                ms = chip_smoke.time_ms(lambda: fused_bidir_ssm_kernel(*a))
                dt = str(dtype).split(".")[1]
                good = rel <= chip_smoke.TOL[("fused_bidir_ssm", dt)]
                ok &= good and bool(torch.isfinite(got.float()).all())
                key = f"fused {name} {dt}"
                out[key] = {"ms": ms, "rel": rel, "max_abs_err": err}
                print(f"{key}: {out[key]} {'ok' if good else 'FAILED'}",
                      flush=True)
                del a, got, ref
    print(json.dumps({"tag": args.tag, "device": smi, "ok": ok,
                      "cases": out}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
