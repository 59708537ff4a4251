"""A ``data x time x space`` mesh as ``torch.distributed`` process groups.

Counterpart of video_enhancer_tpu/parallel/mesh.py ``make_mesh`` (:14-22)
and ``factor_devices`` (:25-40). A JAX mesh axis is a set of devices inside
one program, and code under ``shard_map`` asks it for its size and position
(``jax.lax.axis_size``, ``axis_index``) and gathers over it. Here each
device is a process (a rank): rank r sits at ``np.unravel_index(r, (data,
time, space))``, JAX's layout, and each ``Axis`` gives the size of its
line of ranks, this rank's index on it and gathers over it (a process
group per line). CPU tensors go through gloo, CUDA tensors through NCCL
(one card per rank). The group meets through a ``file://`` store, so no
network port is picked.

Besides ``all_gather``, an axis has JAX's other collectives over a named
axis: ``psum`` and ``pmax`` (an all-reduce on its group) and ``ppermute``
(a ring rotation, every rank's send and receive posted together with
``batch_isend_irecv``, so that neither gloo nor NCCL can deadlock on their
order). A ``Mesh`` passed where a time axis is expected acts as its time
axis (its ``size``, ``index`` and collectives are the time axis's), so the
exact time-sharded factories and the time-axis functions take either.

JAX's ``clip_sharding``, ``frame_sharding`` and ``replicated`` (:40-52)
are ``NamedSharding``s, which tell XLA how to lay a global array over the
devices. Here each rank holds its own block, so their counterparts take
the global tensor and return what this rank holds of it under that
placement: a clip's B over data, T over time and H over space; a frame
batch's B over data and time together (data major) and H over space; a
replicated tensor whole.
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

__all__ = ["AXES", "Axis", "TimeAxis", "Mesh", "make_mesh", "mesh_on_group",
           "launch_ranks", "local_mesh", "factor_devices", "halo_exchange",
           "clip_sharding", "frame_sharding", "replicated"]

AXES = ("data", "time", "space")


class Axis:
    """This rank's line along one mesh axis: ``size`` ranks, this one at
    ``index``, gathering over ``group`` (None: the default group, when the
    axis spans every rank); ``device`` is where its tensors live."""

    def __init__(self, size: int, index: int, group, device: torch.device):
        self.size, self.index, self.group = size, index, group
        self.device = device

    def shard(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of ``t`` along ``dim``, split evenly over the
        axis."""
        n = t.shape[dim] // self.size
        return t.narrow(dim, self.index * n, n)

    def all_gather(self, t: torch.Tensor, dim: int = 0,
                   tiled: bool = False) -> torch.Tensor:
        """Every rank's ``t`` in axis order: stacked along a new leading
        axis, or with ``tiled`` concatenated along ``dim`` (as
        ``jax.lax.all_gather``)."""
        if self.size == 1:
            parts = [t]
        else:
            t = t.contiguous()
            parts = [torch.empty_like(t) for _ in range(self.size)]
            dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=dim) if tiled else torch.stack(parts)

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        if self.size == 1:
            return t
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=op, group=self.group)
        return out

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise sum of every rank's ``t`` (``jax.lax.psum``)."""
        return self._reduce(t, dist.ReduceOp.SUM)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of every rank's ``t`` (``jax.lax.pmax``)."""
        return self._reduce(t, dist.ReduceOp.MAX)

    def _global(self, index: int) -> int:
        """The default group's rank of the rank at ``index`` on this axis."""
        if self.group is None:
            return index
        return dist.get_global_rank(self.group, index)

    def ppermute(self, t: torch.Tensor, shift: int = 1) -> torch.Tensor:
        """Rotate around the ring: this rank sends ``t`` to the rank
        ``shift`` places on and returns what the rank ``shift`` places back
        sent (``jax.lax.ppermute`` with ``[(i, (i + shift) % n)]``). At one
        rank, ``t`` itself."""
        n = self.size
        if n == 1:
            return t
        t = t.contiguous()
        out = torch.empty_like(t)
        to = self._global((self.index + shift) % n)
        frm = self._global((self.index - shift) % n)
        ops = [dist.P2POp(dist.isend, t, to, self.group),
               dist.P2POp(dist.irecv, out, frm, self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return out


# The time axis of the exact time-sharded inference is an Axis (or a Mesh,
# which acts as its time axis).
TimeAxis = Axis


class Mesh:
    """This rank's view of a ``data x time x space`` mesh: ``shape`` maps
    each axis name to its size (as a JAX mesh's ``shape``), ``axis(name)``
    gives this rank's line along it."""

    def __init__(self, axes: dict[str, Axis], rank: int,
                 device: torch.device):
        self.axes, self.rank, self.device = axes, rank, device
        self.shape = {name: axes[name].size for name in AXES}

    @property
    def num_devices(self) -> int:
        """Ranks in the mesh (a JAX mesh's ``devices.size``)."""
        return int(np.prod(list(self.shape.values())))

    def axis(self, name: str) -> Axis:
        return self.axes[name]

    @property
    def size(self) -> int:
        return self.axes["time"].size

    @property
    def index(self) -> int:
        return self.axes["time"].index

    def all_gather(self, t: torch.Tensor, dim: int = 0,
                   tiled: bool = False) -> torch.Tensor:
        return self.axes["time"].all_gather(t, dim=dim, tiled=tiled)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        return self.axes["time"].psum(t)

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        return self.axes["time"].pmax(t)

    def ppermute(self, t: torch.Tensor, shift: int = 1) -> torch.Tensor:
        return self.axes["time"].ppermute(t, shift)

    def destroy(self) -> None:
        """Tear down the default process group, and with it every axis's."""
        dist.destroy_process_group()


def mesh_on_group(data: int = 1, time: int = 1, space: int = 1,
                  device: str | torch.device | None = None) -> Mesh:
    """A mesh over the initialised default process group, which must have
    ``data * time * space`` ranks. Every rank calls it, in the same order
    with respect to other group creations: it creates one group per line
    of each axis (an axis that spans every rank uses the default group)."""
    dims = (data, time, space)
    world, rank = dist.get_world_size(), dist.get_rank()
    if int(np.prod(dims)) != world:
        raise ValueError(f"mesh {dims} needs {int(np.prod(dims))} ranks, the "
                         f"process group has {world}")
    dev = resolve_device(device)
    grid = np.arange(world).reshape(dims)
    coords = np.unravel_index(rank, dims)
    axes = {}
    for a, name in enumerate(AXES):
        group = None
        if dims[a] != world:
            # the lines along axis a: every other coordinate fixed
            lines = np.moveaxis(grid, a, -1).reshape(-1, dims[a])
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if rank in line:
                    group = g
        axes[name] = Axis(dims[a], int(coords[a]), group, dev)
    return Mesh(axes, rank, dev)


def local_mesh(device: str | torch.device | None = None) -> Mesh:
    """A one-rank mesh with no process group: every axis of size 1 on
    ``device`` (the card unless ``"cpu"``), each collective the identity.
    What ``make_mesh()`` gives at one rank, without starting a group."""
    dev = resolve_device(device)
    return Mesh({name: Axis(1, 0, None, dev) for name in AXES}, 0, dev)


def make_mesh(data: int = 1, time: int = 1, space: int = 1, rank: int = 0,
              init_file: str | Path | None = None,
              device: str | torch.device | None = None,
              timeout_s: float = 180.0) -> Mesh:
    """Join the mesh as ``rank`` of ``data * time * space``: starts the
    default process group through the file store ``init_file`` (every rank
    passes the same path, under a temporary directory; a fresh one is made
    for a one-rank mesh when none is given) and builds the axes
    (``mesh_on_group``). ``device``: the card (NCCL, device ``rank`` modulo
    the cards) unless ``"cpu"`` (gloo). A collective that waits longer than
    ``timeout_s`` fails. ``make_mesh(time=n, rank=r, ...)`` is the time axis
    of the exact time-sharded inference."""
    n = data * time * space
    dev = resolve_device(device)
    if init_file is None:
        if n != 1:
            raise ValueError("init_file is needed for a mesh of more than "
                             "one rank")
        init_file = Path(tempfile.mkdtemp(prefix="mesh-")) / "store"
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=Path(init_file).resolve().as_uri(), world_size=n,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return mesh_on_group(data, time, space, dev)


def factor_devices(n: int) -> tuple[int, int, int]:
    """Split ``n`` ranks over (data, time, space) as evenly as possible,
    doubling data, time and space in turn (``n`` a power of 2)."""
    data = time = space = 1
    axis = 0
    while data * time * space < n:
        if axis % 3 == 0:
            data *= 2
        elif axis % 3 == 1:
            time *= 2
        else:
            space *= 2
        axis += 1
    if data * time * space != n:
        raise ValueError(f"n={n} must be a power of 2")
    return data, time, space


def _block(t: torch.Tensor, dim: int, size: int, index: int
           ) -> torch.Tensor:
    """Block ``index`` of ``size`` equal blocks of ``t`` along ``dim``."""
    if t.shape[dim] % size:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not divide "
                         f"into {size} blocks")
    n = t.shape[dim] // size
    return t.narrow(dim, index * n, n)


def clip_sharding(mesh: Mesh, clip: torch.Tensor) -> torch.Tensor:
    """This rank's block of a ``(B, T, H, W, C)`` clip: B over data, T over
    time, H over space (``P("data", "time", "space", None, None)``)."""
    for dim, name in enumerate(AXES):
        ax = mesh.axis(name)
        clip = _block(clip, dim, ax.size, ax.index)
    return clip


def frame_sharding(mesh: Mesh, frames: torch.Tensor) -> torch.Tensor:
    """This rank's block of a ``(B, H, W, C)`` frame batch: B over data and
    time together, data major, H over space (``P(("data", "time"),
    "space", None, None)``)."""
    d, t, s = (mesh.axis(name) for name in AXES)
    frames = _block(frames, 0, d.size * t.size, d.index * t.size + t.index)
    return _block(frames, 1, s.size, s.index)


def replicated(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """What every rank holds of a replicated tensor: all of it (``P()``)."""
    return t


def halo_exchange(x: torch.Tensor, halo: int, axis, dim: int,
                  edge: str = "replicate") -> torch.Tensor:
    """Pad this rank's shard along ``dim`` with ``halo`` boundary slices of
    its neighbours on ``axis``: the previous rank's last ``halo``, x, the
    next rank's first. At the ends of the axis ``edge="replicate"`` repeats
    the boundary slice and ``"zero"`` inserts zeros. JAX sends the blocks
    around a ring (``ppermute``); here every rank gathers all boundary
    blocks and takes its neighbours'."""
    n, idx = axis.size, axis.index
    t = x.shape[dim]
    left, right = x.narrow(dim, 0, halo), x.narrow(dim, t - halo, halo)
    blocks = axis.all_gather(torch.stack([left, right]))     # (n, 2, ...)
    if idx == 0:
        from_left = (torch.zeros_like(left) if edge == "zero"
                     else x.narrow(dim, 0, 1).expand_as(left))
    else:
        from_left = blocks[idx - 1, 1]
    if idx == n - 1:
        from_right = (torch.zeros_like(right) if edge == "zero"
                      else x.narrow(dim, t - 1, 1).expand_as(right))
    else:
        from_right = blocks[idx + 1, 0]
    return torch.cat([from_left, x, from_right], dim=dim)


def launch_ranks(module: str, argv: list[str], n: int,
                 timeout_s: float) -> int:
    """Run ``python -m module *argv --init-file F --rank r`` for each of
    ``n`` ranks as child processes meeting through the ``file://`` store F
    (each joins with ``make_mesh(..., rank=r, init_file=F)``), print rank
    0's output (and the first other failed rank's to stderr); 1 if any
    rank failed."""
    with tempfile.TemporaryDirectory(prefix="ranks-") as d:
        env = dict(os.environ)
        env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1)
                                                  // n)))
        cmd = [sys.executable, "-m", module, *argv, "--init-file",
               f"{d}/store"]
        procs = [subprocess.Popen(cmd + ["--rank", str(r)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  cwd=Path(__file__).resolve().parents[2],
                                  env=env) for r in range(n)]
        logs = []
        try:
            for proc in procs:
                logs.append(proc.communicate(timeout=timeout_s)[0])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    print(logs[0], end="")
    failed = [r for r, proc in enumerate(procs) if proc.returncode]
    if failed and failed[0]:
        print(logs[failed[0]], end="", file=sys.stderr)
    return 1 if failed else 0
