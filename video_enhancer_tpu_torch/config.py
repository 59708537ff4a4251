"""The routing policy of the port: a Python copy of what the auto route reads
from video_enhancer_tpu/config/policy_v1.yaml.

The card's machine has no PyYAML, so the port reads no YAML: the values
below are copied from the policy file and held against the JAX package's
``default_policy()`` by the tests. They are the degradation thresholds
(:7-14), the latency budgets (:16-19), the pipeline defaults (:27-36), the
serving mesh (:38-41), the entries of the models the port serves (vsrm
:44-53, fast_mamba_vsr :54-63, fast_mamba_vsr_ssd :64-78, seedvr2 :79-88,
ditvr :89-101, rvrt :102-108, realesrgan :109-115, realesrgan_fast
:116-125, cnn_upscaler :126-130, bicubic :131-134) and the ``enabled``
flag of every model of the policy, ``face_expert`` (:140-143, off) among
them: as in the JAX package, nothing reads more of that entry (the face
stage runs when ``enable_face_expert`` asks for it,
runtime/face_handler.py). ``LatencyClass`` is video_enhancer_tpu/config/types.py:19-23 and
``MeshConfig`` :90-106.

As in the JAX package's ``load_policy`` (config/__init__.py:50-61), a set
``weights_env`` variable becomes the entry's ``weights_path`` when a policy
is made (``default_policy()`` or ``Policy()``).
"""

from __future__ import annotations

import dataclasses
import enum
import os
from typing import Any, Mapping

__all__ = ["LatencyClass", "DegradationThresholds", "LatencyBudget",
           "PipelineDefaults", "MeshConfig", "ModelEntry", "QualityGates",
           "Policy", "MODELS", "ENABLED", "default_policy"]


class LatencyClass(str, enum.Enum):
    STRICT = "strict"
    STANDARD = "standard"
    FLEXIBLE = "flexible"


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
    """One served model: the fields (and defaults) of the JAX package's
    ``ModelEntry`` that the port reads; ``enabled`` lives in ``ENABLED``.
    Window and stride drive vsrm, seedvr2, ditvr and rvrt; chunk and
    overlap drive fast_mamba_vsr and fast_mamba_vsr_ssd; realesrgan and
    realesrgan_fast run chunks of 4 frames with no overlap, as the JAX
    registry builds them."""

    name: str
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


THRESHOLDS = DegradationThresholds()

LATENCY_BUDGETS: dict[str, LatencyBudget] = {
    "strict": LatencyBudget(500.0, 8.0, (1080, 1920)),
    "standard": LatencyBudget(2000.0, 16.0, (2160, 3840)),
    "flexible": LatencyBudget(10000.0, 24.0, (4320, 7680)),
}

DEFAULTS = PipelineDefaults()

MODELS: dict[str, ModelEntry] = {
    "vsrm": ModelEntry(
        "vsrm", weights_env="VSRM_DIR", scale=4, window=7, stride=3,
        tile=512, tile_overlap=32, extra={"dim": 64, "num_blocks": 6}),
    "fast_mamba_vsr": ModelEntry(
        "fast_mamba_vsr", weights_env="FAST_MAMBA_VSR_DIR", scale=4,
        chunk=16, overlap=2, tile=512, tile_overlap=32,
        extra={"dim": 48, "num_layers": 8}),
    "fast_mamba_vsr_ssd": ModelEntry(
        "fast_mamba_vsr_ssd", scale=4, chunk=16, overlap=2, tile=512,
        tile_overlap=32,
        extra={"dim": 48, "num_layers": 8, "temporal_mixer": "ssd"}),
    "seedvr2": ModelEntry(
        "seedvr2", weights_env="SEEDVR2_3B_DIR", scale=1, window=8, stride=6,
        tile=448, tile_overlap=32,
        extra={"base_channels": 32, "channel_mult": (1, 2, 4),
               "timestep": 500}),
    "ditvr": ModelEntry(
        "ditvr", weights_env="DITVR_DIR", scale=1, window=8, stride=6,
        tile=224, tile_overlap=16,
        extra={"dim": 384, "depth": 8, "heads": 3, "patch": (2, 4, 4)}),
    "rvrt": ModelEntry("rvrt", scale=4, window=7, stride=3,
                       extra={"dim": 64}),
    "realesrgan": ModelEntry("realesrgan", scale=4, tile=512, tile_overlap=32,
                             extra={"num_blocks": 6, "features": 64}),
    "realesrgan_fast": ModelEntry("realesrgan_fast", scale=4, tile=512,
                                  tile_overlap=32,
                                  extra={"num_blocks": 3, "features": 64}),
    "cnn_upscaler": ModelEntry("cnn_upscaler", scale=2,
                               extra={"features": 32}),
    "bicubic": ModelEntry("bicubic", scale=2),
}

# ``enabled`` of every model of the policy, served by the port or not
ENABLED: dict[str, bool] = {
    "vsrm": True, "fast_mamba_vsr": True, "fast_mamba_vsr_ssd": False,
    "seedvr2": True, "ditvr": True, "rvrt": True, "realesrgan": True,
    "realesrgan_fast": True, "cnn_upscaler": True, "bicubic": True,
    "rife": True, "face_expert": False,
}


def _models_from_env() -> dict[str, ModelEntry]:
    """``MODELS`` with each set ``weights_env`` variable as the entry's
    ``weights_path``: the variable wins over the policy's path."""
    out = {}
    for name, entry in MODELS.items():
        env = entry.weights_env and os.environ.get(entry.weights_env)
        out[name] = (dataclasses.replace(entry, weights_path=env) if env
                     else entry)
    return out


@dataclasses.dataclass(frozen=True)
class QualityGates:
    """Minimum acceptable output quality (policy_v1.yaml ``quality_gates``,
    read by the quality agent)."""

    min_psnr: float = 25.0
    min_ssim: float = 0.8
    min_vmaf: float = 70.0
    escalate_on_failure: bool = True


@dataclasses.dataclass(frozen=True)
class Policy:
    """The parts of the JAX package's ``Policy`` that the auto route reads."""

    thresholds: DegradationThresholds = THRESHOLDS
    latency_budgets: Mapping[str, LatencyBudget] = dataclasses.field(
        default_factory=lambda: dict(LATENCY_BUDGETS))
    defaults: PipelineDefaults = DEFAULTS
    mesh: MeshConfig = MeshConfig()
    models: Mapping[str, ModelEntry] = dataclasses.field(
        default_factory=_models_from_env)
    enabled: Mapping[str, bool] = dataclasses.field(
        default_factory=lambda: dict(ENABLED))
    quality_gates: QualityGates = QualityGates()

    def enabled_models(self) -> list[str]:
        return [name for name, on in self.enabled.items() if on]

    def budget(self, latency_class: LatencyClass | str) -> LatencyBudget:
        key = (latency_class.value if isinstance(latency_class, LatencyClass)
               else str(latency_class))
        return self.latency_budgets[key]


def default_policy() -> Policy:
    return Policy()
