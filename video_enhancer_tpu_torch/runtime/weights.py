"""Checkpoints of the JAX package, carried across to the port's layouts.

The JAX package stores parameters as flat dotted keys in ``.npz`` files
(``blocks.0.spatial_ssm.in_proj.w``, video_enhancer_tpu/runtime/weights.py
:24-34) in its own layouts: dense ``w (in, out)``, conv ``w (kt, kh, kw,
Cin, Cout)``, depthwise ``conv_w (K, 1, C)``. ``params_from_jax`` turns
such a flat dict into the port's nested parameters in PyTorch's layouts,
and ``load_into`` fills a template leniently, by path and shape, as the JAX
package's ``unflatten_into`` does (:37-63): what matches is taken,
everything else keeps its initialisation.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

log = logging.getLogger(__name__)

__all__ = ["convert_array", "params_from_jax", "flatten_params",
           "load_into", "read_npz"]


def convert_array(key: str, arr: np.ndarray) -> torch.Tensor:
    """One JAX-layout array -> PyTorch's layout, by its key and rank."""
    leaf = key.rpartition(".")[2]
    t = torch.from_numpy(np.array(arr, dtype=np.float32, copy=True))
    if leaf == "conv_w" and t.ndim == 3:      # (K, 1, C) -> Conv1d (C, 1, K)
        return t.permute(2, 1, 0).contiguous()
    if leaf == "w" and t.ndim == 5:           # (kt,kh,kw,Cin,Cout) -> Conv3d
        return t.permute(4, 3, 0, 1, 2).contiguous()
    if leaf == "w" and t.ndim == 2:           # (in, out) -> Linear (out, in)
        return t.t().contiguous()
    return t


def _nest(flat: dict) -> dict:
    root: dict = {}
    for key, val in flat.items():
        parts = key.split(".")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val
    return _lists(root)


def _lists(node):
    """Dicts keyed 0..n-1 become lists (the JAX pytrees' block lists)."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out) and \
            sorted(int(k) for k in out) == list(range(len(out))):
        return [out[str(i)] for i in range(len(out))]
    return out


def params_from_jax(flat: dict[str, np.ndarray]) -> dict:
    """Flat dotted JAX-layout arrays -> nested port parameters."""
    return _nest({k: convert_array(k, v) for k, v in flat.items()})


def flatten_params(params, prefix: str = "") -> dict[str, torch.Tensor]:
    flat = {}
    if isinstance(params, dict):
        for k, v in params.items():
            flat.update(flatten_params(v, f"{prefix}{k}."))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            flat.update(flatten_params(v, f"{prefix}{i}."))
    else:
        flat[prefix[:-1]] = params
    return flat


def load_into(template, params) -> tuple[dict, list[str], list[str]]:
    """Fill ``template`` with the leaves of ``params`` that match its paths
    and shapes. Returns (filled, matched keys, skipped keys)."""
    flat = flatten_params(params)
    matched, skipped = [], []

    def fill(node, prefix=""):
        if isinstance(node, dict):
            return {k: fill(v, f"{prefix}{k}.") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [fill(v, f"{prefix}{i}.") for i, v in enumerate(node)]
        key = prefix[:-1]
        src = flat.get(key)
        if src is not None and tuple(src.shape) == tuple(node.shape):
            matched.append(key)
            return src.to(node.dtype)
        skipped.append(key)
        return node

    out = fill(template)
    log.info("checkpoint: matched %d keys, kept init for %d",
             len(matched), len(skipped))
    total = len(matched) + len(skipped)
    if flat and total and len(matched) < total / 2:
        log.warning("checkpoint: only %d/%d target leaves matched (unmatched "
                    "e.g. %s)", len(matched), total, skipped[:5])
    return out, matched, skipped


def read_npz(path: str | Path) -> dict[str, np.ndarray]:
    """A flat ``.npz`` checkpoint; a directory means its first ``*.npz``."""
    p = Path(path)
    if p.is_dir():
        npzs = sorted(p.glob("*.npz"))
        if not npzs:
            raise FileNotFoundError(f"no .npz checkpoint in {p}")
        p = npzs[0]
    with np.load(p, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}
