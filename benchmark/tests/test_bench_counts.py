"""The frozen kernel counts against the port's recorded counts, and the
totals of a window at the shapes PERF.md gives (vsrm 7 x 180x320:
4.403e11 in the kernels; ditvr 8 x 180x320: 2.497e12)."""

from __future__ import annotations

import pytest
import torch

from vebench import counting, manifest

KERNELS = manifest.all_counts()


def _count(name, h, w, context=None):
    m = manifest.load()
    cfg = manifest.config(m, name)
    ref = manifest.reference(name)
    return counting.count(ref, ref.load(cfg, "cpu"), cfg, h, w, context,
                          KERNELS)


def _kernel_flops(c):
    return sum(KERNELS[k].flops(s) for k, s in c.kernel_calls)


def test_window_totals_at_the_recorded_shapes():
    v = _count("vsrm-x4", 180, 320)
    assert v.calls_per_window == 1 and len(v.kernel_calls) == 18
    assert _kernel_flops(v) == pytest.approx(4.403e11, rel=1e-4)
    d = _count("ditvr-restore", 180, 320,
               {"degradation_scores": [0, 0, 0], "degradation_type": 0})
    assert [k for k, _ in d.kernel_calls] == ["flash_attn"] * 8
    assert _kernel_flops(d) == pytest.approx(2.497e12, rel=1e-4)
    d720 = _count("ditvr-restore", 720, 1280,
                  {"degradation_scores": [0, 0, 0], "degradation_type": 0})
    assert d720.shape == (4, 8, 224, 224, 3) and d720.calls_per_window == 7
    assert d720.kernel_calls[0] == ("flash_attn", (4, 3, 12544, 128, 12544))


def test_frozen_formulas_equal_the_ports():
    from video_enhancer_tpu_torch.ops.scan import fused_flops
    from video_enhancer_tpu_torch.ops.ssd import ssd_flops

    v = _count("vsrm-x4", 270, 480)
    for k, s in v.kernel_calls:
        if k == "ssd_shared":
            assert KERNELS[k].flops(s) == ssd_flops(*s)
        else:
            assert KERNELS[k].flops(s) == fused_flops(*s)
    assert KERNELS["flash_attn"].flops((4, 3, 12544, 128, 12544)) == (
        4.0 * 4 * 3 * 12544 * 12544 * 128)


def test_frozen_counts_equal_the_ports_records_in_a_served_call():
    """The port's accounting of a vsrm call at a small shape on the CPU
    (its kernel wrappers record as they dispatch to their plain forms)
    equals the frozen formulas at the shapes the reference records."""
    from video_enhancer_tpu_torch.models import vsrm
    from video_enhancer_tpu_torch.runtime.registry import load_params
    from video_enhancer_tpu_torch.utils.flops import accounting

    clip = torch.rand(1, 7, 16, 24, 3)
    with accounting() as acc, torch.no_grad():
        vsrm.apply(load_params("vsrm"), clip)
    assert acc[0] == pytest.approx(_kernel_flops(_count("vsrm-x4", 16, 24)),
                                   rel=1e-12)
