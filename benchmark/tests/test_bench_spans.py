"""The program's spans in a synthetic profiler trace: the device's idle put
down to the innermost span, split where a gap crosses spans and given to
the benchmark's ranges where no span is under way; each instance's self
time and launched device time; trace.py's numbers unchanged by the spans;
and one traced window of a tiny cell through ``idle_split.py``."""

from __future__ import annotations

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from vebench import spans, trace

MS = 1_000_000      # ns


class Event:
    def __init__(self, name, start, end, device=False, cid=0, link=0,
                 thread=1):
        self._v = (name, start * MS, (end - start) * MS, device, cid, link,
                   thread)

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

    def start_thread_id(self):
        return self._v[6]

    def is_user_annotation(self):
        return ":" in self._v[0] and "::" not in self._v[0] or \
            self._v[0].startswith("bench.")


def profile_of(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def host_and_device():
    """A 100 ms window, a ``bench.next`` over 0-96 ms, one handler window:
    an upload whose copy runs on the device at 9-13 ms, a model call
    (20-60) whose kernel, launched through its runtime call alone, runs at
    25-45, the rounding's kernel at 64-70, the download's copy at 80-90."""
    return [
        Event("bench.window", 0, 100, cid=1),
        Event("bench.next", 0, 96, cid=2),
        Event("bench.apply_fn", 21, 59, cid=3),
        Event("aten::copy_", 8, 9, cid=10),
        Event("cudaLaunchKernel", 24, 24.1, cid=11),
        Event("aten::round", 63, 63.5, cid=12),
        Event("aten::copy_", 71, 91, cid=13),
        Event("Memcpy HtoD (Pageable -> Device)", 9, 13, True, link=10),
        Event("void vetk::flash_fwd_wgmma<bf16, 128>", 25, 45, True, cid=11),
        Event("elementwise_kernel", 64, 70, True, link=12),
        Event("Memcpy DtoH (Device -> Pageable)", 80, 90, True, link=13),
        Event("bench.apply_fn", 21, 59, True),   # the device's copy
    ]


def program():
    """The spans, and one on another thread that must take nothing."""
    return [
        Event("pipeline:assemble", 1, 5),
        Event("vsr_handler:window", 6, 95),
        Event("vsr_handler:upload", 7, 12),
        Event("vsr_handler:model", 20, 60),
        Event("vsr_handler:round", 62, 66),
        Event("vsr_handler:download", 70, 94),
        Event("pipeline:assemble", 30, 50, thread=2),
    ]


def test_idle_goes_to_the_innermost_span_split_at_its_edges():
    sp = spans.reduce(profile_of(host_and_device() + program()))
    got = {s.name: s for s in sp.instances}
    assert [s.name for s in sp.instances] == [
        "pipeline:assemble", "vsr_handler:window", "vsr_handler:upload",
        "vsr_handler:model", "vsr_handler:round", "vsr_handler:download"]
    # gaps 0-9, 13-25, 45-64 (across model, window and round), 70-80 and
    # 90-100 (download, window, bench.next, then no range but the window)
    idle = {"pipeline:assemble": 4, "vsr_handler:window": 11,
            "vsr_handler:upload": 2, "vsr_handler:model": 20,
            "vsr_handler:round": 2, "vsr_handler:download": 14}
    for name, ms in idle.items():
        assert got[name].idle_s == pytest.approx(ms / 1e3), name
    assert sp.rest == {"bench.next": pytest.approx(0.003),
                       "bench.window": pytest.approx(0.004)}
    t = trace.reduce(profile_of(host_and_device() + program()))
    assert sp.total_idle_s() == pytest.approx(t.window_s - t.busy_s)


def test_instances_self_time_launches_and_parents():
    sp = spans.reduce(profile_of(host_and_device() + program()))
    got = {s.name: s for s in sp.instances}
    win = got["vsr_handler:window"]
    assert (win.start_s, win.dur_s) == (pytest.approx(0.006),
                                        pytest.approx(0.089))
    assert win.self_s == pytest.approx(0.089 - 0.005 - 0.040 - 0.004
                                       - 0.024)
    assert got["vsr_handler:model"].self_s == pytest.approx(0.040)
    device = {"vsr_handler:upload": 4, "vsr_handler:model": 20,
              "vsr_handler:round": 6, "vsr_handler:download": 10,
              "vsr_handler:window": 0, "pipeline:assemble": 0}
    for name, ms in device.items():
        assert got[name].device_s == pytest.approx(ms / 1e3), name
    parents = [s.parent for s in sp.instances]
    assert parents == [-1, -1, 1, 1, 1, 1]
    assert sp.within(3, "vsr_handler:model")
    assert not sp.within(2, "vsr_handler:model")
    assert sp.inclusive("idle_s")[1] == pytest.approx(0.049)


def test_handler_quantities_add_up_to_the_idle_share():
    events = host_and_device() + program()
    sp = spans.reduce(profile_of(events))
    t = trace.reduce(profile_of(events))
    handler = spans.handler_idle_share(sp, t.window_s)
    model = spans.model_call_idle_share(sp, t.window_s)
    assert handler == pytest.approx(0.33)
    assert model == pytest.approx(0.20)
    rest = sum(sp.rest.values()) / t.window_s
    assert handler + model + rest == pytest.approx(1 - t.busy_s / t.window_s)
    assert spans.window_idle_ms_p50(sp) == pytest.approx(49.0)
    assert spans.handler_window_ms_p50(sp) == pytest.approx(89.0)


def test_without_program_spans_the_quantities_are_absent():
    sp = spans.reduce(profile_of(host_and_device()))
    assert sp.instances == []
    assert sum(sp.rest.values()) == pytest.approx(0.060)
    assert spans.handler_idle_share(sp, 0.1) is None
    assert spans.model_call_idle_share(sp, 0.1) is None
    assert spans.window_idle_ms_p50(sp) is None
    assert spans.handler_window_ms_p50(sp) is None


def test_trace_fields_are_the_same_with_and_without_program_ranges():
    bare = trace.reduce(profile_of(host_and_device()))
    spanned = trace.reduce(profile_of(host_and_device() + program()))
    for name in ("busy_s", "window_s", "ops", "outside_apply_s", "unlinked"):
        assert getattr(spanned, name) == getattr(bare, name), name
    assert sum(spanned.gaps.values()) == pytest.approx(
        sum(bare.gaps.values()))
    # a gap is now named by the span the host was in, where no operation
    # was under way at its middle
    assert "vsr_handler:model" not in bare.gaps
    assert set(spanned.gaps) - set(bare.gaps) <= {
        s.name() for s in program()}


@pytest.mark.parametrize("intervals,want", [
    ([(0, 10, "a"), (2, 4, "b"), (4, 6, "c")],
     [(0, 2, "a"), (2, 4, "b"), (4, 6, "c"), (6, 10, "a")]),
    ([(0, 10, "a"), (0, 10, "b"), (12, 13, "c")],
     [(0, 10, "b"), (12, 13, "c")]),
    ([], []),
])
def test_innermost_stretches(intervals, want):
    assert spans._innermost(intervals) == want


def test_a_tiny_cell_traced_through_idle_split(tiny_root):
    code = (f"import sys\nsys.path.insert(0, "
            f"{str(tiny_root / 'benchmark')!r})\nimport idle_split\n"
            f"sys.exit(idle_split.main(['--workload', 'vsrm-x4.batch-270p',"
            f" '--seed', '2147483999', '--seconds', '2'], device='cpu'))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tiny_root,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["windows"] > 0
    assert line["spans"]["vsr_handler:model"]["n"] == line["model_calls"]
    assert line["spans"]["vsr_handler:download"]["n"] == line["windows"]
    assert line["handler_window_ms_p50"] > 0
    assert line["idle_put_down_s"] == pytest.approx(
        line["window_s"] - line["busy_s"])
