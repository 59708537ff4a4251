"""The port's policy file reader, ``load_policy`` and ``default_policy``
against PyYAML and the JAX package's, on the CPU.

The reader (``config/yaml_subset.py``) must give what ``yaml.safe_load``
gives on the committed ``policy_v1.yaml`` and on changed copies, and raise
on what lies outside its subset. ``load_policy`` must equal the JAX
package's field by field on each copy (its lists in ``extra`` as tuples,
the port's one difference kept on purpose), raise the same ValueError for
a missing latency budget, and ``default_policy()`` must load the file that
``$VETPU_POLICY`` names. The routing plans for fixed degradation scores
(the scorer and the face detector replaced on both sides) must be equal
under each copy. Values compare exactly.
"""

from __future__ import annotations

import dataclasses
import types
from pathlib import Path

import numpy as np
import pytest
import yaml

from video_enhancer_tpu.analysis import router as jrouter
from video_enhancer_tpu.config import load_policy as j_load_policy
from video_enhancer_tpu_torch import config as tconfig
from video_enhancer_tpu_torch.analysis import router as trouter
from video_enhancer_tpu_torch.config import yaml_subset

ROOT = Path(__file__).resolve().parents[1]
COMMITTED = (ROOT / "video_enhancer_tpu" / "config" / "policy_v1.yaml"
             ).read_text()


def _edit(old: str, new: str) -> str:
    assert COMMITTED.count(old) == 1, old
    return COMMITTED.replace(old, new)


# each a changed copy of the committed file, as a deployment would write it
COPIES = {
    "committed": COMMITTED,
    "threshold": _edit("  compression: 0.6\n", "  compression: 0.75\n"),
    "budget": _edit("max_ms_per_frame: 500,", "max_ms_per_frame: 250.5,"),
    "mesh": _edit("mesh:\n  data: 1\n  time: 1\n",
                  "mesh:\n  data: 1\n  time: 2\n"),
    "vsrm_off": _edit("  vsrm:\n    license: apache-2.0\n    enabled: true",
                      "  vsrm:\n    license: apache-2.0\n    enabled: false"),
    "extra": _edit("extra: { base_channels: 32, channel_mult: [1, 2, 4], "
                   "timestep: 500 }",
                   "extra: {base_channels: 32, channel_mult: [1, 2, 4],\n"
                   "           timestep: 500, quality_threshold: 0.9,}"),
    "quoted": _edit('version: "1.0-tpu"',
                    "version: 'site''s 2.0'   # a comment after a scalar\n"
                    "# a comment line\n").replace(
        "  realesrgan:\n    license: bsd-3-clause",
        '  "realesrgan":\n    license: "bsd-3-clause"  # quoted'),
}
NO_BUDGET = _edit(
    "  flexible:   { max_ms_per_frame: 10000, max_memory_gb: 24, "
    "max_resolution: [4320, 7680] }\n", "")


@pytest.mark.parametrize("name", sorted(COPIES))
def test_reader_equals_safe_load(name):
    text = COPIES[name]
    assert yaml_subset.loads(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "a: &anchor 1\nb: *anchor\n",        # anchor and alias
    "a:\n\tb: 1\n",                       # a tab
    "a: !!str 1\n",                       # a tag
    "a:\n  - 1\n",                        # a block sequence
    "a: |\n  text\n",                     # a block scalar
    "a: one\n  two\n",                    # a plain scalar over two lines
    "a: 0x1f\n",                          # an int form PyYAML reads
])
def test_reader_refuses_what_lies_outside_its_subset(text):
    with pytest.raises(yaml_subset.YAMLSubsetError, match="line [12]"):
        yaml_subset.loads(text)


def _entry(e) -> dict:
    d = dataclasses.asdict(e)
    d["extra"] = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in d["extra"].items()}
    return d


def _assert_same_policy(t, j):
    assert t.version == j.version
    for part in ("thresholds", "quality_gates", "defaults", "mesh"):
        assert dataclasses.asdict(getattr(t, part)) == dataclasses.asdict(
            getattr(j, part)), part
    assert {k: dataclasses.asdict(v) for k, v in t.latency_budgets.items()} \
        == {k: dataclasses.asdict(v) for k, v in j.latency_budgets.items()}
    assert list(t.models) == list(j.models)
    for name in j.models:
        assert _entry(t.models[name]) == _entry(j.models[name]), name
    assert t.enabled_models() == j.enabled_models()
    assert t.mesh.num_devices == j.mesh.num_devices


@pytest.fixture
def policy_file(tmp_path, monkeypatch):
    monkeypatch.setenv("VSRM_DIR", str(tmp_path / "vsrm_weights"))

    def write(name: str) -> Path:
        path = tmp_path / f"{name}.yaml"
        path.write_text(COPIES[name] if name in COPIES else NO_BUDGET)
        return path
    return write


@pytest.mark.parametrize("name", sorted(COPIES))
def test_load_policy_equals_jax(policy_file, name):
    path = policy_file(name)
    t, j = tconfig.load_policy(path), j_load_policy(path)
    _assert_same_policy(t, j)
    assert t.models["vsrm"].weights_path.endswith("vsrm_weights")


def test_missing_budget_raises_as_in_jax(policy_file):
    path = policy_file("no_budget")
    with pytest.raises(ValueError, match="'flexible'") as want:
        j_load_policy(path)
    with pytest.raises(ValueError) as got:
        tconfig.load_policy(path)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["committed", "vsrm_off", "mesh"])
def test_default_policy_honours_vetpu_policy(policy_file, monkeypatch, name):
    monkeypatch.setenv("VETPU_POLICY", str(policy_file(name)))
    _assert_same_policy(tconfig.default_policy(),
                        j_load_policy(policy_file(name)))
    monkeypatch.delenv("VETPU_POLICY")
    _assert_same_policy(tconfig.default_policy(),
                        j_load_policy(ROOT / "video_enhancer_tpu" / "config"
                                      / "policy_v1.yaml"))


def test_builtin_entries_are_the_committed_file():
    """``MODELS`` and ``Policy()`` come from the port's copy of the file,
    which is the JAX package's file."""
    assert (ROOT / "video_enhancer_tpu_torch" / "config" /
            "policy_v1.yaml").read_text() == COMMITTED
    j = j_load_policy(ROOT / "video_enhancer_tpu" / "config" /
                      "policy_v1.yaml")
    assert set(tconfig.MODELS) == set(tconfig.SERVED) <= set(j.models)
    for name, entry in tconfig.MODELS.items():
        assert _entry(entry) == _entry(dataclasses.replace(
            j.models[name], weights_path=None)), name


SCORES = {  # fixed degradation scores, each driving one branch
    "clean": dict(compression=0.2, motion_blur=0.1, low_light=0.1,
                  noise=0.2, temporal_inconsistency=0.3),
    "blocky": dict(compression=0.7, motion_blur=0.1, low_light=0.1,
                   noise=0.5, temporal_inconsistency=0.6),
    "moving": dict(compression=0.3, motion_blur=0.2, low_light=0.7,
                   noise=0.3, temporal_inconsistency=0.2,
                   motion_complexity=0.8),
    "unknown": dict(compression=0.58, motion_blur=0.55, low_light=0.59,
                    noise=0.57, temporal_inconsistency=0.9),
}


def _fixed(scores: dict):
    full = {"scene_change_ratio": 0.0, "motion_complexity": 0.1,
            "brightness": 0.5, "contrast": 0.2, **scores}
    return lambda clip: dict(full)


@pytest.mark.parametrize("name", sorted(COPIES))
@pytest.mark.parametrize("case", sorted(SCORES))
@pytest.mark.parametrize("latency_class", ["standard", "strict"])
def test_routing_plans_equal_jax_under_each_copy(policy_file, monkeypatch,
                                                 name, case, latency_class):
    path = policy_file(name)
    frames = np.full((4, 16, 16, 3), 128, np.uint8)
    meta = types.SimpleNamespace(height=16, width=16, fps=24.0,
                                 frame_count=4)
    for mod in (jrouter, trouter):
        monkeypatch.setattr(mod, "degradation_scores", _fixed(SCORES[case]))
    monkeypatch.setattr(jrouter, "_detect_faces_ratio", lambda f: 0.0)
    monkeypatch.setattr(trouter, "_detect_faces_ratio", lambda f, d: 0.0)
    monkeypatch.setattr(jrouter, "get_video_metadata", lambda p: meta)
    monkeypatch.setattr(jrouter, "sample_frames",
                        lambda p, num_samples=12: frames)
    want = jrouter.DegradationRouter(j_load_policy(path)).analyze_and_route(
        "mem", latency_class=latency_class)
    got = trouter.DegradationRouter(tconfig.load_policy(path)).analyze_frames(
        frames, fps=24.0, frame_count=4, latency_class=latency_class,
        device="cpu")
    for plan in (want, got):
        plan.pop("analysis_time_sec")
    assert got == want
    if name == "vsrm_off":
        assert want["expert_routing"]["primary_model"] != "vsrm"
