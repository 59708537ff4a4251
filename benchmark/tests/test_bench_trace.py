"""The metric arithmetic on a synthetic profiler trace."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
from torch.autograd import DeviceType

from vebench import counting, drive, manifest, peaks, trace


class Event:
    def __init__(self, name, start, dur, device=False, cid=0, link=0):
        # cid: the event's own id (a device event's: its runtime call's);
        # link: the host operation or range a device event was launched in
        self._v = (name, start, dur, device, cid, link)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return DeviceType.CUDA if self._v[3] else DeviceType.CPU

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[0].startswith("bench.")


def fake_profile(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


MS = 1_000_000      # ns


def synthetic():
    """A 100 ms window: two model calls (ranges at 10-30 and 50-70 ms on
    the host), each launching a flash kernel of 15 ms (through its runtime
    call alone, as a kernel launched through ctypes is linked, its id
    also that of an operation outside) and an SSD kernel of 5 ms; outside
    them a copy of 4 ms and a blend of 6 ms; the host waits in a
    synchronize during the longest gap."""
    ev = [Event("bench.window", 0, 100 * MS, cid=1),
          Event("bench.apply_fn", 10 * MS, 20 * MS, cid=2),
          Event("bench.apply_fn", 50 * MS, 20 * MS, cid=3),
          Event("aten::copy_", 2 * MS, 1 * MS, cid=4),
          Event("aten::add_", 80 * MS, 1 * MS, cid=5),
          Event("cudaStreamSynchronize", 85 * MS, 14 * MS, cid=6)]
    for i, t in enumerate((12, 52)):
        link = 2 + i
        ev.append(Event("cudaLaunchKernel", (t - 1) * MS, MS // 10,
                        cid=4 + i))
        ev.append(Event("void vetk::flash_fwd_wgmma<bf16, 128>", t * MS,
                        15 * MS, True, cid=4 + i))
        ev.append(Event("void vetk::ssd_run_kernel<bf16, false>",
                        (t + 15) * MS, 5 * MS, True, link=link))
    ev.append(Event("Memcpy HtoD (Pageable -> Device)", 3 * MS, 4 * MS,
                    True, link=4))
    ev.append(Event("elementwise_kernel", 81 * MS, 6 * MS, True, link=5))
    # the device's copy of a host range, which is no device work
    ev.append(Event("bench.apply_fn", 12 * MS, 20 * MS, True))
    return trace.reduce(fake_profile(ev))


def test_reduce_busy_gaps_and_launch_sides():
    t = synthetic()
    assert t.window_s == pytest.approx(0.1)
    assert t.busy_s == pytest.approx(0.05)       # 2 x 20 + 4 + 6 ms
    assert t.outside_apply_s == pytest.approx(0.010)
    assert t.op_seconds(("flash_fwd",)) == (pytest.approx(0.030), 2)
    assert t.op_seconds(("ssd_run_kernel",)) == (pytest.approx(0.010), 2)
    assert t.unlinked == 0
    assert sum(t.gaps.values()) == pytest.approx(0.05)
    assert t.gaps["cudaStreamSynchronize"] == pytest.approx(0.013)
    b = t.breakdown()
    assert b["device_ops"][0] == ["void vetk::flash_fwd_wgmma<bf16, 128>",
                                  pytest.approx(0.030)]
    assert len(b["idle_gaps"]) <= 10


def _run(t):
    shapes = [("flash_attn", (4, 3, 12544, 128, 12544)),
              ("ssd_shared", (7, 57600, 2, 64, 16, 256))]
    count = counting.CallCount((1, 7, 16, 16, 3), 1, 2.0e12, shapes)
    d = drive.Delivery(t0=0.0, seconds=0.1, frames=8, t_last=0.1)
    return SimpleNamespace(trace=t, calls=2, count=count, itemsize=2,
                           kernels=manifest.all_counts(), delivery=d)


def test_readers_on_the_synthetic_trace():
    run = _run(synthetic())

    def read(name):
        return manifest.reader(name)(run)

    assert read("device_idle_share.batch") == pytest.approx(0.5)
    assert read("model_mfu.batch") == pytest.approx(
        100 * 2 * 2.0e12 / (0.1 * peaks.FLOPS["bf16"]))
    assert read("handler_device_ms_per_frame.batch") == pytest.approx(10 / 8)
    flash = 4.0 * 4 * 3 * 12544 * 12544 * 128
    assert read("flash_attn_roofline") == pytest.approx(
        100 * 2 * flash / peaks.FLOPS["bf16"] / 0.030)
    ssd_bytes = 7 * 57600 * (2 * 2 * 64 * 2 + 2 * 16 * 2 + 2 * 4)
    assert read("ssd_shared_roofline") == pytest.approx(
        100 * 2 * ssd_bytes / peaks.HBM_BYTES_PER_S / 0.010)
    assert read("fused_bissm_roofline") is None     # not in the call


def test_stream_readers():
    n = 10
    due = np.arange(n) * 0.1
    taken = due + np.array([0, 0, 0, 0, 0.05, 0, 0, 0, 0, 0.2])
    out = taken + 0.3
    d = drive.Delivery(t0=0.0, seconds=1.0, frames=n, t_last=out[-1],
                       due=due, taken=taken, out=out)
    windows = [(0, [0, 1, 2, 3], [0, 1, 2, 3]), (2, [2, 3, 4, 5], [4, 5]),
               (4, [4, 5, 6, 7], [6, 7]), (6, [6, 7, 8, 9], [8, 9])]
    run = SimpleNamespace(delivery=d, windows=windows)
    lat = manifest.reader("frame_latency_p95_ms")(run)
    assert lat == pytest.approx(np.percentile((out - due) * 1e3, 95))
    lag = manifest.reader("input_lag_ms_p95.stream")(run)
    assert lag == pytest.approx(np.percentile((taken - due) * 1e3, 95))
    svc = manifest.reader("window_service_ms_p50.stream")(run)
    assert svc == pytest.approx(300.0)
    d.out[9] = np.nan
    assert manifest.reader("frame_latency_p95_ms")(run) >= 300.0
