"""The ``time`` axis of a mesh as a ``torch.distributed`` process group.

Counterpart of video_enhancer_tpu/parallel/mesh.py ``make_mesh(time=n)``
(:14-22). A JAX mesh axis is a set of devices inside one program, and code
under ``shard_map`` asks it for its size and position
(``jax.lax.axis_size``, ``axis_index``) and gathers over it. Here each
shard is a process: ``TimeAxis`` gives the group's size and this process's
index and gathers over the group. CPU tensors go through gloo, CUDA tensors
through NCCL (one card per rank). The group meets through a ``file://``
store, so no network port is picked.
"""

from __future__ import annotations

import datetime
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["TimeAxis", "make_mesh"]


class TimeAxis:
    """This process's view of the time axis (the default process group):
    ``size`` shards, this one at ``index``; ``device`` is where its tensors
    live."""

    def __init__(self, device: torch.device):
        self.device = device

    @property
    def size(self) -> int:
        return dist.get_world_size()

    @property
    def index(self) -> int:
        return dist.get_rank()

    def all_gather(self, t: torch.Tensor, dim: int = 0,
                   tiled: bool = False) -> torch.Tensor:
        """Every shard's ``t`` in rank order: stacked along a new leading
        axis, or with ``tiled`` concatenated along ``dim`` (as
        ``jax.lax.all_gather``)."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t)
        return torch.cat(parts, dim=dim) if tiled else torch.stack(parts)

    def destroy(self) -> None:
        """Tear the process group down."""
        dist.destroy_process_group()


def make_mesh(time: int = 1, rank: int = 0,
              init_file: str | Path | None = None,
              device: str | torch.device | None = None,
              timeout_s: float = 180.0) -> TimeAxis:
    """Join the time axis as shard ``rank`` of ``time``: starts the default
    process group through the file store ``init_file`` (every rank passes
    the same path, under a temporary directory; a fresh one is made when
    ``time`` is 1 and none is given). ``device``: the card (NCCL, device
    ``rank`` modulo the cards) unless ``"cpu"`` (gloo). A collective that
    waits longer than ``timeout_s`` fails."""
    dev = resolve_device(device)
    if init_file is None:
        if time != 1:
            raise ValueError("init_file is needed when time > 1")
        init_file = Path(tempfile.mkdtemp(prefix="time-axis-")) / "store"
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=Path(init_file).resolve().as_uri(), world_size=time,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return TimeAxis(dev)
