"""Training checkpoints with ``torch.save``, and the npz export for
inference.

Counterpart of video_enhancer_tpu/train/checkpoint.py, which saves the
whole ``TrainState`` with orbax (not on the card's machine). Here
``save_checkpoint`` writes ``<dir>/<step>/state.pt`` holding the
parameters, the optimizer state and the step: to a temporary directory
first, renamed into place, so a cut save never looks like a checkpoint.
The three newest steps are kept (orbax's ``max_to_keep=3``).
``restore_checkpoint`` loads the newest with ``weights_only=True`` onto
the template's device, and ``export_params`` writes the flat ``.npz`` in
the JAX package's keys and layouts that either package's
``try_load_params`` reads. Every rank of a mesh holds the same state: save
from one.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from pathlib import Path

import torch

from ..runtime.weights import save_params
from .step import TrainState, tree_leaves, tree_unflatten

__all__ = ["save_checkpoint", "restore_checkpoint", "export_params",
           "latest_step"]

_FILE = "state.pt"
MAX_TO_KEEP = 3


def _steps(ckpt_dir: Path) -> list[int]:
    if not ckpt_dir.is_dir():
        return []
    return sorted(int(d.name) for d in ckpt_dir.iterdir()
                  if d.name.isdigit() and (d / _FILE).is_file())


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cpu(v) for v in tree]
    return tree.detach().cpu()


def save_checkpoint(ckpt_dir: str | Path, state: TrainState) -> int:
    """Save ``state`` under its step; returns the step."""
    ckpt_dir = Path(ckpt_dir).resolve()
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    step = int(state.step)
    tmp = Path(tempfile.mkdtemp(prefix=f".{step}-", dir=ckpt_dir))
    try:
        torch.save({"params": _cpu(state.params),
                    "opt_state": _cpu(state.opt_state),
                    "step": _cpu(state.step)}, tmp / _FILE)
        final = ckpt_dir / str(step)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for old in _steps(ckpt_dir)[:-MAX_TO_KEEP]:
        shutil.rmtree(ckpt_dir / str(old))
    return step


def latest_step(ckpt_dir: str | Path) -> int | None:
    """The newest saved step, or None when there is none."""
    steps = _steps(Path(ckpt_dir).resolve())
    return steps[-1] if steps else None


def _like(template, loaded, device, what: str):
    """``loaded``'s leaves in ``template``'s structure, each checked against
    its template leaf's shape, on ``device`` in the template leaf's dtype."""
    want, got = tree_leaves(template), tree_leaves(loaded)
    if len(want) != len(got) or any(tuple(a.shape) != tuple(b.shape)
                                    for a, b in zip(want, got)):
        raise ValueError(f"checkpoint {what} do not match the template")
    return tree_unflatten(template, [b.to(device, a.dtype)
                                     for a, b in zip(want, got)])


def restore_checkpoint(ckpt_dir: str | Path,
                       template: TrainState) -> TrainState | None:
    """The newest checkpoint in ``template``'s structure and on its device,
    or None when there is none."""
    step = latest_step(ckpt_dir)
    if step is None:
        return None
    path = Path(ckpt_dir).resolve() / str(step) / _FILE
    saved = torch.load(path, map_location="cpu", weights_only=True)
    device = template.step.device
    params = _like(template.params, saved["params"], device, "parameters")
    params = tree_unflatten(params, [p.requires_grad_()
                                     for p in tree_leaves(params)])
    return TrainState(
        params=params,
        opt_state=_like(template.opt_state, saved["opt_state"], device,
                        "optimizer state"),
        step=saved["step"].to(device, template.step.dtype))


def export_params(path: str | Path, state: TrainState) -> str:
    """Write the parameters as the flat ``.npz`` of inference weights (the
    JAX package's keys and layouts, ``runtime.weights.save_params``)."""
    return save_params(path, state.params)
