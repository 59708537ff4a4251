"""The routing and execution policy of the port, read from a YAML file.

Counterpart of video_enhancer_tpu/config/__init__.py and types.py.
``policy_v1.yaml`` beside this module is the port's copy of the JAX
package's policy file; ``load_policy(path)`` reads such a file into the
typed tree with the JAX package's checks (a missing latency budget raises
ValueError) and ``default_policy()`` loads the file ``$VETPU_POLICY``
names, else the committed copy. The card's machine has no PyYAML, so the
files are read by ``yaml_subset`` (the subset a policy file uses; anything
else raises, naming the line).

As in the JAX package's ``_parse_models``, a set ``weights_env`` variable
becomes the entry's ``weights_path``. The JAX package caches its default
policy for the life of the process (``lru_cache``); the port reads
``$VETPU_POLICY`` and each ``weights_env`` again at every
``default_policy()`` (and ``Policy()``), so a variable set later in the
process is not ignored. The committed file is read once, at import: the
defaults of ``Policy()`` and ``MODELS`` (the entries of the models the
port serves, without the variables) come from it.

Lists in an entry's ``extra`` are kept as tuples (``channel_mult``,
``patch``), where the JAX package keeps the lists YAML gives.
"""

from __future__ import annotations

import dataclasses
import enum
import os
from pathlib import Path
from typing import Any, Mapping

from .yaml_subset import YAMLSubsetError, load_file

__all__ = ["LatencyClass", "ModelKind", "DegradationThresholds", "LatencyBudget",
           "PipelineDefaults", "MeshConfig", "ModelEntry", "QualityGates",
           "Policy", "MODELS", "SERVED", "DEFAULT_POLICY_PATH",
           "YAMLSubsetError", "load_policy", "default_policy"]

DEFAULT_POLICY_PATH = Path(__file__).resolve().parent / "policy_v1.yaml"

# the models the port serves (the policy names rife and face_expert too:
# their stages run on request, not through the registry)
SERVED = ("vsrm", "fast_mamba_vsr", "fast_mamba_vsr_ssd", "seedvr2", "ditvr",
          "rvrt", "realesrgan", "realesrgan_fast", "cnn_upscaler", "bicubic")


class LatencyClass(str, enum.Enum):
    STRICT = "strict"
    STANDARD = "standard"
    FLEXIBLE = "flexible"


class ModelKind(str, enum.Enum):
    VSRM = "vsrm"
    SEEDVR2 = "seedvr2"
    DITVR = "ditvr"
    FAST_MAMBA_VSR = "fast_mamba_vsr"
    RVRT = "rvrt"
    REALESRGAN = "realesrgan"
    CNN_UPSCALER = "cnn_upscaler"
    BICUBIC = "bicubic"


@dataclasses.dataclass(frozen=True)
class DegradationThresholds:
    compression: float = 0.6
    motion_blur: float = 0.5
    low_light: float = 0.6
    noise: float = 0.4
    face_prominence: float = 0.03
    motion_complexity: float = 0.7
    unknown_degradation: float = 0.6


@dataclasses.dataclass(frozen=True)
class LatencyBudget:
    max_ms_per_frame: float
    max_memory_gb: float
    max_resolution: tuple[int, int]  # (H, W)


@dataclasses.dataclass(frozen=True)
class PipelineDefaults:
    latency_class: LatencyClass = LatencyClass.STANDARD
    allow_diffusion: bool = True
    allow_zero_shot: bool = True
    license_mode: str = "permissive"
    enable_face_expert: bool = False
    enable_hfr: bool = False
    enable_temporal_smoothing: bool = False
    output_codec: str = "mp4v"
    compute_dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """The serving mesh: ranks along ``data`` (clip batch), ``time`` (frame
    halos) and ``space`` (row halos); runtime/registry.py builds it when a
    process group of that many ranks is up."""

    data: int = 1
    time: int = 1
    space: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.time * self.space


@dataclasses.dataclass(frozen=True)
class ModelEntry:
    """One model of the policy, with the JAX package's fields and defaults.
    Window and stride drive vsrm, seedvr2, ditvr and rvrt; chunk and
    overlap drive fast_mamba_vsr and fast_mamba_vsr_ssd; realesrgan and
    realesrgan_fast run chunks of 4 frames with no overlap, as the JAX
    registry builds them."""

    name: str
    license: str = "apache-2.0"
    enabled: bool = True
    weights_path: str | None = None
    weights_env: str | None = None
    scale: int = 4
    window: int = 7
    stride: int = 3
    chunk: int = 16
    overlap: int = 2
    tile: int = 512
    tile_overlap: int = 32
    extra: Mapping[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class QualityGates:
    """Minimum acceptable output quality (``quality_gates``, read by the
    quality agent)."""

    min_psnr: float = 25.0
    min_ssim: float = 0.8
    min_vmaf: float = 70.0
    escalate_on_failure: bool = True


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def _parse_models(raw: Mapping[str, Any],
                  env: bool = True) -> dict[str, ModelEntry]:
    """The JAX package's ``_parse_models``: each entry with its defaults;
    with ``env`` a set ``weights_env`` variable wins over the policy's
    ``weights_path``."""
    models = {}
    for name, m in raw.items():
        m = dict(m or {})
        weights_env = m.get("weights_env")
        weights_path = m.get("weights_path")
        if env and weights_env and os.environ.get(weights_env):
            weights_path = os.environ[weights_env]
        models[name] = ModelEntry(
            name=name,
            license=m.get("license", "apache-2.0"),
            enabled=bool(m.get("enabled", True)),
            weights_path=weights_path,
            weights_env=weights_env,
            scale=int(m.get("scale", 4)),
            window=int(m.get("window", 7)),
            stride=int(m.get("stride", 3)),
            chunk=int(m.get("chunk", 16)),
            overlap=int(m.get("overlap", 2)),
            tile=int(m.get("tile", 512)),
            tile_overlap=int(m.get("tile_overlap", 32)),
            extra={k: _tuples(v) for k, v in dict(m.get("extra", {})).items()},
        )
    return models


def _budgets(raw: Mapping[str, Any]) -> dict[str, LatencyBudget]:
    budgets = {}
    for name, b in raw.get("latency_budgets", {}).items():
        budgets[name] = LatencyBudget(
            max_ms_per_frame=float(b["max_ms_per_frame"]),
            max_memory_gb=float(b["max_memory_gb"]),
            max_resolution=tuple(b["max_resolution"]))
    for lc in LatencyClass:
        if lc.value not in budgets:
            raise ValueError(f"policy missing latency budget for {lc.value!r}")
    return budgets


def _defaults(raw: Mapping[str, Any]) -> PipelineDefaults:
    d = dict(raw.get("defaults", {}))
    if "latency_class" in d:
        d["latency_class"] = LatencyClass(d["latency_class"])
    return PipelineDefaults(**d)


_COMMITTED = load_file(DEFAULT_POLICY_PATH)
MODELS: dict[str, ModelEntry] = {
    name: entry for name, entry in
    _parse_models(_COMMITTED.get("models", {}), env=False).items()
    if name in SERVED}


@dataclasses.dataclass(frozen=True)
class Policy:
    """The typed policy tree (the JAX package's ``Policy``). Made with no
    arguments it holds the committed file's values, each ``weights_env``
    read at that moment."""

    thresholds: DegradationThresholds = dataclasses.field(
        default_factory=lambda: DegradationThresholds(
            **_COMMITTED.get("degradation_thresholds", {})))
    latency_budgets: Mapping[str, LatencyBudget] = dataclasses.field(
        default_factory=lambda: _budgets(_COMMITTED))
    defaults: PipelineDefaults = dataclasses.field(
        default_factory=lambda: _defaults(_COMMITTED))
    mesh: MeshConfig = dataclasses.field(
        default_factory=lambda: MeshConfig(**_COMMITTED.get("mesh", {})))
    models: Mapping[str, ModelEntry] = dataclasses.field(
        default_factory=lambda: _parse_models(_COMMITTED.get("models", {})))
    quality_gates: QualityGates = dataclasses.field(
        default_factory=lambda: QualityGates(
            **_COMMITTED.get("quality_gates", {})))
    version: str = str(_COMMITTED.get("version", "unknown"))

    @property
    def enabled(self) -> dict[str, bool]:
        """``enabled`` of every model of the policy, served by the port or
        not."""
        return {name: m.enabled for name, m in self.models.items()}

    def enabled_models(self) -> list[str]:
        return [m.name for m in self.models.values() if m.enabled]

    def budget(self, latency_class: LatencyClass | str) -> LatencyBudget:
        key = (latency_class.value if isinstance(latency_class, LatencyClass)
               else str(latency_class))
        return self.latency_budgets[key]


def load_policy(path: str | os.PathLike | None = None) -> Policy:
    """The policy file at ``path`` (else ``$VETPU_POLICY``, else the
    committed copy) as the typed tree, checked as the JAX package's
    ``load_policy`` checks it."""
    path = Path(path or os.environ.get("VETPU_POLICY", DEFAULT_POLICY_PATH))
    raw = load_file(path) or {}
    return Policy(
        version=str(raw.get("version", "unknown")),
        thresholds=DegradationThresholds(
            **raw.get("degradation_thresholds", {})),
        latency_budgets=_budgets(raw),
        quality_gates=QualityGates(**raw.get("quality_gates", {})),
        models=_parse_models(raw.get("models", {})),
        defaults=_defaults(raw),
        mesh=MeshConfig(**raw.get("mesh", {})))


def default_policy() -> Policy:
    """``load_policy()`` of ``$VETPU_POLICY`` when it is set, else the
    committed file's policy; both read the variables at each call."""
    if os.environ.get("VETPU_POLICY"):
        return load_policy()
    return Policy()
