#!/usr/bin/env python3
"""Interleaved A/B timing of the port's implementation switches inside the
full models, on the card.

    python3 scripts/torch_ab_harness.py fused_bissm|bissd_conv [rounds]

The counterpart of the JAX package's ``scripts/ab_harness.py`` and
``scripts/ab_bissd_conv.py``, with their experiments and shapes:

- ``fused_bissm``: the temporal bissm composed (conv, x_proj, dt_proj as
  PyTorch ops around one bidirectional scan kernel) against fused (one
  kernel for the whole interior), in fast_mamba_vsr (dim 48, 8 layers, 1 x
  8 x 180 x 320) and vsrm (dim 64, 6 blocks, 1 x 7 x 180 x 320);
- ``bissd_conv``: vsrm's spatial SSD with its depthwise conv as PyTorch's
  grouped conv and then SiLU, against the conv kernel
  (``conv_impl="pallas"``, csrc/dwconv_silu.cu).

Each variant is selected as the JAX scripts select it, by rebinding the
model module's ``bissm_apply`` / ``bissd_apply`` (the port's models pass
``impl`` themselves, so the rebound ``bissm_apply`` forces it). Models are
seeded random inits in bf16 (every floating leaf; the JAX scripts keep 1-D
leaves in fp32), inputs seeded uniform bf16. One round times each variant
in turn, ``CALLS`` forward calls between two CUDA events after a warm-up;
rounds alternate which variant goes first. Prints each round, the launches
of one call of each variant, the medians in ms per call, the card's name
and power limit, and as its last line one JSON object.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from video_enhancer_tpu_torch import kernels  # noqa: E402
from video_enhancer_tpu_torch.models import fast_mamba_vsr, vsrm  # noqa: E402
from video_enhancer_tpu_torch.runtime.vsr_handler import cast_params  # noqa: E402

CALLS, WARMUP = 5, 2
SEED = 0


def _model(name: str):
    """The forward call of a seeded model in bf16 on the card."""
    gen = torch.Generator().manual_seed(SEED)
    if name == "fmv":
        params = fast_mamba_vsr.init(gen, dim=48, num_layers=8, scale=4)
        shape, mod = (1, 8, 180, 320, 3), fast_mamba_vsr
    else:
        params = vsrm.init(gen, dim=64, num_blocks=6, scale=4)
        shape, mod = (1, 7, 180, 320, 3), vsrm
    p = cast_params(params, torch.bfloat16, "cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    x = torch.rand(shape, generator=g, device="cuda").bfloat16()
    return lambda: mod.apply(p, x, scale=4)


_ORIG = {"bissm": vsrm.bissm_apply, "bissd": vsrm.bissd_apply}


def _variants(exp: str) -> tuple[list[str], dict]:
    """The models of an experiment and its variants, each a function that
    rebinds the models' module attributes."""
    def bissm(impl):
        def forced(p, x, **_):
            return _ORIG["bissm"](p, x, impl=impl)

        def activate():
            fast_mamba_vsr.bissm_apply = forced
            vsrm.bissm_apply = forced
        return activate

    def bissd(conv_impl):
        def activate():
            vsrm.bissd_apply = functools.partial(_ORIG["bissd"],
                                                 conv_impl=conv_impl)
        return activate

    if exp == "fused_bissm":
        return ["fmv", "vsrm"], {"composed": bissm("composed"),
                                 "fused": bissm("fused")}
    if exp == "bissd_conv":
        return ["vsrm"], {"grouped": bissd("grouped"),
                          "pallas": bissd("pallas")}
    raise SystemExit(f"unknown experiment {exp!r}: fused_bissm | bissd_conv")


def _restore() -> None:
    fast_mamba_vsr.bissm_apply = _ORIG["bissm"]
    vsrm.bissm_apply = _ORIG["bissm"]
    vsrm.bissd_apply = _ORIG["bissd"]


def _ms(fn) -> float:
    """ms per call of ``CALLS`` calls between two CUDA events."""
    for _ in range(WARMUP):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CALLS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / CALLS


def _launches(fn) -> dict:
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    fn()
    torch.cuda.synchronize()
    return {k: v for k, v in kernels.launch_counts.items() if v}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_ab_harness: no CUDA device; this run needs the card",
              file=sys.stderr)
        return 1
    exp = sys.argv[1] if len(sys.argv) > 1 else "fused_bissm"
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 6
    models, variants = _variants(exp)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    result = {"experiment": exp, "device": torch.cuda.get_device_name(0),
              "nvidia_smi": smi, "calls": CALLS, "rounds": rounds,
              "median_ms": {}, "launches": {}}
    try:
        with torch.inference_mode():
            for model in models:
                fwd = _model(model)
                times = {name: [] for name in variants}
                for name, activate in variants.items():
                    activate()
                    launched = _launches(fwd)
                    result["launches"][f"{model}:{name}"] = launched
                    print(f"{model} {name}: launches of one call {launched}",
                          flush=True)
                order = list(variants)
                for r in range(rounds):
                    for name in (order if r % 2 == 0 else order[::-1]):
                        variants[name]()
                        ms = _ms(fwd)
                        times[name].append(ms)
                        print(f"{model} {name} round {r}: {ms:.3f} ms",
                              flush=True)
                for name, ts in times.items():
                    med = statistics.median(ts)
                    result["median_ms"][f"{model}:{name}"] = med
                    print(f"{model} {name} MEDIAN: {med:.3f} ms (n={len(ts)};"
                          f" min {min(ts):.3f}, max {max(ts):.3f})",
                          flush=True)
                del fwd
                torch.cuda.empty_cache()
    finally:
        _restore()
    print(smi)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
