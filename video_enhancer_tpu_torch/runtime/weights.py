"""Checkpoints of the JAX package, carried across to the port's layouts.

The JAX package stores parameters as flat dotted keys in ``.npz`` files
(``blocks.0.spatial_ssm.in_proj.w``, video_enhancer_tpu/runtime/weights.py
:24-34) in its own layouts: dense ``w (in, out)``, conv ``w (kt, kh, kw,
Cin, Cout)`` or ``(kh, kw, Cin, Cout)``, depthwise ``conv_w (K, 1, C)``;
other arrays (embeddings, prototypes, norms, biases) as they are. ``params_from_jax`` turns
such a flat dict into the port's nested parameters in PyTorch's layouts,
and ``load_into`` fills a template leniently, by path and shape, as the JAX
package's ``unflatten_into`` does (:37-63): what matches is taken,
everything else keeps its initialisation. ``try_load_params`` is one link
of the JAX package's weight-resolution chain (:108-132): a ``.npz`` or a
PyTorch ``.pt``/``.pth`` state dict (``convert_torch_state_dict``, :87-105),
or a directory holding one, loaded into a template, or None when the file
is missing, unreadable or matches no key. ``save_params`` writes the port's
parameters back as such a flat ``.npz``, in the JAX package's keys and
layouts (``to_jax_layout`` inverts ``convert_array`` rule by rule), so that
both packages' ``try_load_params`` load what the port exports.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

log = logging.getLogger(__name__)

__all__ = ["convert_array", "to_jax_layout", "params_from_jax",
           "flatten_params", "load_into", "read_npz", "save_params",
           "convert_torch_state_dict", "try_load_params"]


def convert_array(key: str, arr: np.ndarray) -> torch.Tensor:
    """One JAX-layout array -> PyTorch's layout, by its key and rank."""
    leaf = key.rpartition(".")[2]
    t = torch.from_numpy(np.array(arr, dtype=np.float32, copy=True))
    if leaf == "conv_w" and t.ndim == 3:      # (K, 1, C) -> Conv1d (C, 1, K)
        return t.permute(2, 1, 0).contiguous()
    if leaf == "w" and t.ndim == 5:           # (kt,kh,kw,Cin,Cout) -> Conv3d
        return t.permute(4, 3, 0, 1, 2).contiguous()
    if leaf == "w" and t.ndim == 4:           # (kh,kw,Cin,Cout) -> Conv2d
        return t.permute(3, 2, 0, 1).contiguous()
    if leaf == "w" and t.ndim == 2:           # (in, out) -> Linear (out, in)
        return t.t().contiguous()
    return t


def to_jax_layout(key: str, t: torch.Tensor) -> np.ndarray:
    """One port-layout tensor -> the JAX package's layout, by its key and
    rank: the inverse of ``convert_array``. Floating tensors come back as
    fp32."""
    leaf = key.rpartition(".")[2]
    t = t.detach().cpu()
    if t.is_floating_point():
        t = t.float()
    if leaf == "conv_w" and t.ndim == 3:      # Conv1d (C, 1, K) -> (K, 1, C)
        t = t.permute(2, 1, 0)
    elif leaf == "w" and t.ndim == 5:         # Conv3d -> (kt,kh,kw,Cin,Cout)
        t = t.permute(2, 3, 4, 1, 0)
    elif leaf == "w" and t.ndim == 4:         # Conv2d -> (kh,kw,Cin,Cout)
        t = t.permute(2, 3, 1, 0)
    elif leaf == "w" and t.ndim == 2:         # Linear (out, in) -> (in, out)
        t = t.t()
    return np.ascontiguousarray(t.numpy())


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


def save_params(path: str | Path, params) -> str:
    """Write ``params`` as a flat ``.npz`` in the JAX package's keys and
    layouts (its ``save_params``, video_enhancer_tpu/runtime/weights.py
    :66-70): the parent directory is made, numpy adds ``.npz`` to a path
    without it. Returns the path as given."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **{k: to_jax_layout(k, v)
                      for k, v in flatten_params(params).items()})
    return str(path)


def convert_torch_state_dict(state_dict) -> dict[str, np.ndarray]:
    """A PyTorch state dict -> the JAX package's flat keys and layouts:
    Linear ``weight (out, in)`` -> ``w (in, out)``, ConvNd ``weight (out, in,
    *k)`` -> ``w (*k, in, out)``; ``bias`` under both ``b`` and ``bias``, a
    1-D ``weight`` under both ``scale`` and ``w`` (the lenient load matches
    by key and shape)."""
    flat = {}
    for name, t in state_dict.items():
        arr = np.asarray(t.detach().cpu().numpy() if hasattr(t, "detach")
                         else t)
        base, _, leaf = name.rpartition(".")
        if leaf == "weight":
            if arr.ndim == 2:
                flat[f"{base}.w"] = arr.T
            elif arr.ndim == 3:
                flat[f"{base}.w"] = arr.transpose(2, 1, 0)
            elif arr.ndim == 4:
                flat[f"{base}.w"] = arr.transpose(2, 3, 1, 0)
            elif arr.ndim == 5:
                flat[f"{base}.w"] = arr.transpose(2, 3, 4, 1, 0)
            elif arr.ndim == 1:
                flat[f"{base}.scale"] = arr
                flat[f"{base}.w"] = arr
            else:
                flat[f"{base}.w"] = arr
        elif leaf == "bias":
            flat[f"{base}.b"] = arr
            flat[f"{base}.bias"] = arr
        else:
            flat[name] = arr
    return flat


def try_load_params(path, template):
    """``template`` filled from the checkpoint at ``path`` (a ``.npz``, a
    ``.pt``/``.pth`` state dict, or a directory: its first ``.npz``, else its
    first ``.pt``/``.pth``); None when there is no such file, it cannot be
    read, or none of its keys matches."""
    p = Path(path)
    try:
        if p.is_dir():
            npzs = sorted(p.glob("*.npz"))
            pts = sorted(list(p.glob("*.pt")) + list(p.glob("*.pth")))
            p = npzs[0] if npzs else (pts[0] if pts else p)
        if not p.is_file():
            return None
        if p.suffix == ".npz":
            flat = read_npz(p)
        elif p.suffix in (".pt", ".pth"):
            sd = torch.load(str(p), map_location="cpu", weights_only=True)
            if isinstance(sd, dict) and "state_dict" in sd:
                sd = sd["state_dict"]
            flat = convert_torch_state_dict(sd)
        else:
            return None
        out, matched, _ = load_into(template, params_from_jax(flat))
        return out if matched else None
    except Exception as e:  # an unreadable file is a missing link
        log.warning("weight load failed for %s: %s", path, e)
        return None
