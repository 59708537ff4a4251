"""Plain PyTorch forms shared by the references: layers, the SSD and
selective scans, attention, the cubic resize, the local warp, the
streaming handler's windows, tiles and ramp blend, and the checkpoint
reader.

A frozen copy of the served program's plain forms, written again here so
that the yardstick does not move when the program does. It imports no
module of the program and takes nothing the program made: it reads the
checkpoint itself and recomputes everything from the frames the harness
hands it.

Every product goes through an ``Ops`` object, which says how it is
computed:

- ``"fp32"``: in float32 with TF32 off (the reference);
- ``"fp8"``: the control, the step below the served bfloat16: every
  tensor that the served program holds in bfloat16 (the model's input,
  weights and activations at each product, its output, the cubic base and
  the calibrated blend) held in float8 e4m3 instead, each rounded with a
  per-tensor scale, the arithmetic inside an operation in float32;
- ``"fp8_products"``: the second control, the step a faster program
  would take first: only the operands of the learned products (the
  linears and the convs) rounded to float8 e4m3, everything else in
  float32;
- ``"count"``: on the ``meta`` device, no arithmetic; the calls that the
  program serves on its hand-written kernels are recorded with their
  shapes (``Ops.calls``) and return empty tensors, so that
  ``FlopCounterMode`` sees only the products the program runs as library
  calls.
"""

from __future__ import annotations

import contextlib
import math
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

MODES = ("fp32", "fp8", "fp8_products", "count")
_FP8_MAX = 448.0                     # largest finite float8 e4m3 value


@contextlib.contextmanager
def full_fp32():
    """cuBLAS and cuDNN in full float32 within (no TF32)."""
    mm = torch.backends.cuda.matmul.allow_tf32
    conv = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = conv


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with its absolute maximum scaled to the
    format's largest value, returned in float32."""
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / _FP8_MAX, torch.ones_like(amax))
    return (t.float() / scale).to(torch.float8_e4m3fn).float() * scale


class Ops:
    """The products of one reference pass, in one of ``MODES``."""

    def __init__(self, mode: str = "fp32"):
        if mode not in MODES:
            raise ValueError(f"mode {mode!r}: one of {MODES}")
        self.mode = mode
        self.calls: list[tuple[str, tuple]] = []

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the pass holds a tensor between operations."""
        return fp8_round(t) if self.mode == "fp8" else t

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as a learned product (a linear or a conv) reads it."""
        return fp8_round(t) if self.mode in ("fp8", "fp8_products") else t

    def linear(self, x, w, b=None):
        return self.q(F.linear(self.operand(x), self.operand(w), b))

    def conv_frames(self, x, w, b):
        """SAME conv of ``x (N, H, W, Cin)`` with ``w (Cout, Cin, kh, kw)``
        (odd kernels, stride 1)."""
        kh, kw = w.shape[-2:]
        out = F.conv2d(self.operand(x.permute(0, 3, 1, 2)),
                       self.operand(w), b, padding=(kh // 2, kw // 2))
        return self.q(out.permute(0, 2, 3, 1))

    def attention(self, q, k, v, block: int = 2048):
        """Softmax attention of ``(B, H, L, Dh)``: on the program's flash
        kernel when L >= 256, as its dispatcher rules; here in blocks of
        ``block`` queries."""
        if self.mode == "count":
            if q.shape[2] >= 256 and k.shape[2] >= 256:
                self.calls.append(("flash_attn", tuple(q.shape)
                                   + (k.shape[2],)))
                return torch.empty_like(q)
            block = q.shape[2]
        scale = q.shape[-1] ** -0.5
        kq, vq = self.q(k), self.q(v)
        outs = []
        for s in range(0, q.shape[2], block):
            logits = torch.matmul(self.q(q[:, :, s:s + block]),
                                  kq.transpose(-1, -2)) * scale
            probs = torch.softmax(logits, dim=-1)
            outs.append(torch.matmul(self.q(probs), vq))
        return self.q(torch.cat(outs, dim=2))

    def ssd_shared(self, x, dt, A, Bm, Cm, chunk: int, reverse: bool):
        """The SSD scan, B/C shared by the heads (the program's kernel
        ``ssd_shared`` in half precision)."""
        if self.mode == "count":
            self.calls.append(("ssd_shared", tuple(x.shape) + (Bm.shape[-1],
                                                              chunk)))
            return torch.empty_like(x)
        if reverse:
            def flip(t):
                return torch.flip(t, dims=(1,))
            return flip(ssd_chunked(flip(x), flip(dt), A, flip(Bm), flip(Cm),
                                    chunk))
        return ssd_chunked(x, dt, A, Bm, Cm, chunk)

    def fused_bissm(self, u_pre, gate, p, dt_rank: int):
        """The bidirectional shared-stream SSM's interior (the program's
        kernel ``fused_bidir_ssm``)."""
        if self.mode == "count":
            self.calls.append(("fused_bissm", tuple(u_pre.shape)
                               + (p["A_log_f"].shape[1],
                                  p["conv_w"].shape[-1], dt_rank)))
            return torch.empty_like(u_pre)
        Af, Ab = -torch.exp(p["A_log_f"]), -torch.exp(p["A_log_b"])
        N = Af.shape[1]
        u = F.silu(depthwise_conv1d(u_pre, p["conv_w"], p["conv_b"]))
        proj = self.linear(u, p["x_proj"]["w"])
        Bm = proj[..., dt_rank:dt_rank + N]
        Cm = proj[..., dt_rank + N:]
        dtp = self.linear(proj[..., :dt_rank], p["dt_proj"]["w"],
                          p["dt_proj"]["b"])
        y = (selective_scan(u, F.softplus(dtp + p["dt_bias_f"]), Af, Bm, Cm,
                            p["D_f"])
             + selective_scan(u, F.softplus(dtp + p["dt_bias_b"]), Ab, Bm,
                              Cm, p["D_b"], reverse=True))
        return y * F.silu(gate)


def depthwise_conv1d(x, w, b):
    """SAME depthwise conv over ``x (B, L, C)`` with ``w (C, 1, K)``."""
    k = w.shape[-1]
    lo = (k - 1) // 2
    xi = F.pad(x.transpose(1, 2), (lo, k - 1 - lo))
    return F.conv1d(xi, w, b, groups=x.shape[-1]).transpose(1, 2)


def ssd_chunk_size(L: int, target: int) -> int:
    c = 1
    while c * 2 <= min(L, target):
        c *= 2
    return c


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """The SSD recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T``,
    ``y_t = C_t^T h_t`` in its chunked matrix form, float32 throughout.
    x ``(b, L, H, P)``, dt ``(b, L, H)``, A ``(H,)``, Bm, Cm ``(b, L, N)``."""
    b, L, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, ssd_chunk_size(L, chunk))
    pad = (-L) % Q
    if pad:
        def pad_l(t):
            return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
        x, dt, Bm, Cm = pad_l(x), pad_l(dt), pad_l(Bm), pad_l(Cm)
    K = (L + pad) // Q

    def hm(t):
        return t.reshape(b, K, Q, *t.shape[2:]).transpose(2, 3)

    xc, dtc = hm(x), hm(dt)
    Bc = Bm.reshape(b, K, 1, Q, N)
    Cc = Cm.reshape(b, K, 1, Q, N)
    g = torch.cumsum(dtc * A[:, None], dim=3)                # (b,K,H,Q)
    G = g[..., -1]
    xdt = xc * dtc[..., None]
    CB = torch.matmul(Cc, Bc.transpose(-1, -2))              # (b,K,1,Q,Q)
    ldiff = g[..., :, None] - g[..., None, :]
    mask = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    W = CB * torch.exp(ldiff.masked_fill(~mask, float("-inf")))
    y = torch.matmul(W, xdt)
    Bg = Bc * torch.exp(G[..., None] - g)[..., None]
    S_chunk = torch.matmul(Bg.transpose(-1, -2), xdt)        # (b,K,H,N,P)
    decay = torch.exp(G)
    run = torch.zeros_like(S_chunk[:, 0])
    S_prev = []
    for k in range(K):
        S_prev.append(run)
        run = decay[:, k, :, None, None] * run + S_chunk[:, k]
    S_prev = torch.stack(S_prev, dim=1)
    y = y + torch.matmul(Cc * torch.exp(g)[..., None], S_prev)
    return y.transpose(2, 3).reshape(b, K * Q, H, P)[:, :L]


def selective_scan(x, dt, A, Bm, Cm, D, reverse: bool = False):
    """The Mamba-1 recurrence, walked step by step: x, dt ``(B, L, D)``, A
    ``(D, N)``, Bm, Cm ``(B, L, N)``, D ``(D,)``; plus the D skip."""
    Bsz, L, Dd = x.shape
    h = torch.zeros((Bsz, Dd, A.shape[1]), dtype=x.dtype, device=x.device)
    ys: list = [None] * L
    for t in (range(L - 1, -1, -1) if reverse else range(L)):
        dtt = dt[:, t, :, None]
        h = torch.exp(dtt * A) * h + dtt * Bm[:, t, None, :] * x[:, t, :, None]
        ys[t] = (h * Cm[:, t, None, :]).sum(-1)
    return torch.stack(ys, dim=1) + x * D


def layer_norm(p, x, eps: float = 1e-5):
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps)


def gelu(x):
    return F.gelu(x, approximate="tanh")


def sinusoidal_embedding(t, dim: int, max_period: float = 10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[..., None] * freqs
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    return F.pad(emb, (0, 1)) if dim % 2 else emb


def _cubic(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    x = np.abs(x)
    x2, x3 = x * x, x * x * x
    return np.where(x <= 1.0, (a + 2.0) * x3 - (a + 3.0) * x2 + 1.0,
                    np.where(x < 2.0, a * x3 - 5.0 * a * x2 + 8.0 * a * x
                             - 4.0 * a, 0.0))


def cubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """The ``(n_out, n_in)`` Keys cubic (a = -0.75) operator for an
    upscale: half-pixel centres, the borders replicated, rows normalised."""
    scale = n_in / n_out
    i = np.arange(n_out, dtype=np.float64)
    x = (i + 0.5) * scale - 0.5
    j0 = np.floor(x - 2.0).astype(np.int64) + 1
    taps = j0[:, None] + np.arange(5)[None, :]
    wts = _cubic(x[:, None] - taps)
    w = np.zeros((n_out, n_in), dtype=np.float64)
    np.add.at(w, (np.repeat(i.astype(np.int64), 5),
                  np.clip(taps, 0, n_in - 1).ravel()), wts.ravel())
    w /= w.sum(axis=1, keepdims=True)
    return w.astype(np.float32)


def resize_cubic(img, out_hw):
    """Cubic upscale of ``(..., H, W, C)`` to ``out_hw``, two products."""
    h, w = img.shape[-3], img.shape[-2]
    if (h, w) == tuple(out_hw):
        return img
    wh = torch.from_numpy(cubic_matrix(h, out_hw[0])).to(img.device)
    ww = torch.from_numpy(cubic_matrix(w, out_hw[1])).to(img.device)
    x = torch.einsum("oh,...hwc->...owc", wh, img)
    return torch.einsum("ow,...hwc->...hoc", ww, x)


def pixel_shuffle(x, s: int):
    """``(..., H, W, C*s*s) -> (..., H*s, W*s, C)``, channels as (c, s, s)."""
    *lead, h, w, c = x.shape
    x = x.reshape(*lead, h, w, c // (s * s), s, s)
    nd = x.ndim
    perm = tuple(range(nd - 5)) + (nd - 5, nd - 2, nd - 4, nd - 1, nd - 3)
    return x.permute(perm).reshape(*lead, h * s, w * s, c // (s * s))


def _shift(a, s: int, dim: int):
    if s == 0:
        return a
    n = a.shape[dim]
    idx = torch.clamp(torch.arange(n, device=a.device) + s, 0, n - 1)
    return a.index_select(dim, idx)


def flow_warp_local(img, flow):
    """Bilinear backward warp of ``img (..., H, W, C)`` by a flow (dy, dx)
    under one pixel, borders replicated: the 3x3 neighbourhood weighted by
    tents."""
    dy, dx = flow[..., 0:1], flow[..., 1:2]
    h_ax, w_ax = img.ndim - 3, img.ndim - 2
    out = torch.zeros_like(img)
    for sy in (-1, 0, 1):
        wy = torch.clamp(1.0 - torch.abs(dy - sy), min=0.0)
        row = _shift(img, sy, h_ax)
        for sx in (-1, 0, 1):
            wx = torch.clamp(1.0 - torch.abs(dx - sx), min=0.0)
            out = out + wy * wx * _shift(row, sx, w_ax)
    return out


# -- checkpoints -------------------------------------------------------------

def _layout(key: str, a: np.ndarray) -> torch.Tensor:
    """One array of the checkpoint (dense ``(in, out)``, conv ``(kt, kh,
    kw, Cin, Cout)``, depthwise ``(K, 1, C)``) in PyTorch's layout."""
    leaf = key.rpartition(".")[2]
    t = torch.from_numpy(np.array(a, dtype=np.float32, copy=True))
    if leaf == "conv_w" and t.ndim == 3:
        return t.permute(2, 1, 0).contiguous()
    if leaf == "w" and t.ndim == 5:
        return t.permute(4, 3, 0, 1, 2).contiguous()
    if leaf == "w" and t.ndim == 2:
        return t.t().contiguous()
    return t


def _lists(node):
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out


def load_checkpoint(path: str | Path, device) -> dict:
    """The flat dotted ``.npz`` as nested float32 tensors on ``device``."""
    root: dict = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            node = root
            *parents, leaf = key.split(".")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = _layout(key, z[key]).to(device)
    return _lists(root)


def check_sizes(config: dict, found: dict) -> None:
    """Raise where the configuration's ``sizes`` depart from ``found``,
    the sizes a reference reads off the checkpoint it loaded."""
    gone = {k: (v, found.get(k)) for k, v in config["sizes"].items()
            if found.get(k) != v}
    if gone or set(found) - set(config["sizes"]):
        raise ValueError(f"{config['checkpoint']}: sizes (configuration, "
                         f"checkpoint) {gone}, not in the configuration: "
                         f"{sorted(set(found) - set(config['sizes']))}")


def to_device(params, device):
    if isinstance(params, dict):
        return {k: to_device(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [to_device(v, device) for v in params]
    return params.to(device)


# -- the streaming handler ---------------------------------------------------

def windows(n_frames: int, window: int, stride: int):
    """The handler's windows over a clip of ``n_frames``: ``(start,
    frame indices (padded by repeating the last), emitted indices)``. A
    window emits its frames from ``window - stride`` on (all of them for
    the first), up to its real frames."""
    overlap = window - stride
    out, buf, start = [], [], 0

    def emit(idx, valid):
        begin = overlap if start > 0 else 0
        out.append((start, idx + [idx[-1]] * (window - valid),
                    list(range(start + begin, start + min(valid, window)))))

    for i in range(n_frames):
        buf.append(i)
        if len(buf) == window:
            emit(buf, window)
            buf = buf[stride:] if window > stride else []
            start += stride
    if buf:
        emit(buf, len(buf))
    return out


def tile_origins(h: int, w: int, tile: int, overlap: int):
    step = tile - overlap
    ys = sorted({min(y, max(h - tile, 0))
                 for y in range(0, max(h - overlap, 1), step)})
    xs = sorted({min(x, max(w - tile, 0))
                 for x in range(0, max(w - overlap, 1), step)})
    return [(y, x) for y in ys for x in xs]


def _ramp(n: int, overlap: int) -> np.ndarray:
    r = np.ones(n, dtype=np.float32)
    if overlap > 0:
        lin = np.linspace(0.0, 1.0, overlap + 2, dtype=np.float32)[1:-1]
        r[:overlap] = lin
        r[-overlap:] = lin[::-1]
    return r


def run_window(model, clip, *, scale: int, tile: int, tile_overlap: int,
               group: int = 4):
    """The handler's ``process_clip`` of a window ``(T, H, W, 3)`` in [0,
    1]: whole when the frame fits a tile, else tiles of ``tile`` in groups
    of ``group``, blended back with separable ramps. ``model`` maps
    ``(B, T, h, w, 3) -> (B, T, s h, s w, 3)``."""
    t, h, w, _ = clip.shape
    if max(h, w) <= tile:
        return model(clip[None])[0]
    origins = tile_origins(h, w, tile, tile_overlap)
    canvas = torch.zeros((t, h * scale, w * scale, 3), device=clip.device)
    weight = torch.zeros((h * scale, w * scale, 1), device=clip.device)
    for i in range(0, len(origins), group):
        part = origins[i:i + group]
        outs = model(torch.stack([clip[:, y:y + tile, x:x + tile]
                                  for y, x in part]))
        for (y, x), o in zip(part, outs):
            th, tw = o.shape[1], o.shape[2]
            wmap = torch.from_numpy(
                _ramp(th, tile_overlap * scale)[:, None]
                * _ramp(tw, tile_overlap * scale)[None, :])[..., None].to(
                    clip.device)
            ys, xs = y * scale, x * scale
            canvas[:, ys:ys + th, xs:xs + tw] += o * wmap
            weight[ys:ys + th, xs:xs + tw] += wmap
    return canvas / torch.clamp(weight, min=1e-8)


def to_u8(out: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(out * 255.0), 0, 255).to(torch.uint8)
