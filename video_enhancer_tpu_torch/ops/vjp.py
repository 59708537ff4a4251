"""A kernel forward with a plain backward: the port's counterpart of the
JAX package's ``jax.custom_vjp`` around each Pallas kernel (ops/ssd.py
:418-442, ops/scan.py :278-298, :479-504, :764-787, :998-1017,
ops/attention.py :165-182, :282-303, ops/conv.py :252-268).

A hand-written kernel launched over ``ctypes`` returns a tensor that
autograd knows nothing of. ``kernel_vjp(name, cuda, plain, *args, **kw)``
is each kernel wrapper's dispatch: ``cuda`` (the launch) for a CUDA
tensor, ``plain`` for a CPU tensor, ValueError for another device. When
grad mode is on and an input requires grad, it runs inside an
``autograd.Function`` that saves the inputs as given (JAX's residuals). Its
backward re-runs ``plain`` on detached copies under autograd and returns
the gradients of the inputs that need one, each in its input's dtype and
shape, and None for every other argument. No backward is a kernel, as in
JAX, and the backward records no FLOPs (utils/flops.py); it runs inside a
profiler range ``vjp:<plain version's name>``, so that a trace gives the
plain backward's device time by kernel row. With grad mode off
(``torch.inference_mode``, ``no_grad``) or no input requiring grad, the
launch or the plain version is called directly: serving pays nothing.
"""

from __future__ import annotations

import torch

from ..utils.flops import accounting

__all__ = ["wants_grad", "kernel_vjp"]


def wants_grad(*args) -> bool:
    """Grad mode is on and a tensor among ``args`` requires grad."""
    return torch.is_grad_enabled() and any(
        isinstance(a, torch.Tensor) and a.requires_grad for a in args)


class _KernelVJP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, launch, plain, kw, *args):
        ctx.plain, ctx.kw = plain, kw
        ctx.save_for_backward(*args)
        return launch(*args, **kw)

    @staticmethod
    def backward(ctx, *grads):
        args = [t.detach().requires_grad_(need) for t, need in
                zip(ctx.saved_tensors, ctx.needs_input_grad[3:])]
        wrt = [i for i, t in enumerate(args) if t.requires_grad]
        result: list = [None] * len(args)
        if wrt:
            with torch.profiler.record_function(
                    f"vjp:{ctx.plain.__name__}"), torch.enable_grad(), \
                    accounting():
                out = ctx.plain(*args, **ctx.kw)
                # an output none of the inputs reaches takes no gradient
                pairs = [(o, g) for o, g in zip(
                    out if isinstance(out, tuple) else (out,), grads)
                    if o.requires_grad]
                got = torch.autograd.grad([o for o, _ in pairs],
                                          [args[i] for i in wrt],
                                          [g for _, g in pairs],
                                          allow_unused=True)
            for i, g in zip(wrt, got):
                result[i] = g
        return (None, None, None, *result)


def kernel_vjp(name: str, cuda, plain, *args, **kw):
    """``cuda(*args, **kw)`` if the first argument is a CUDA tensor,
    ``plain(*args, **kw)`` if it is a CPU one (the two take the same
    arguments and give the same outputs), differentiable through ``plain``
    when ``wants_grad(*args)``. ``args`` are tensors; ``kw`` holds the
    static arguments, which get no gradient."""
    device = args[0].device
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: no kernel for device {device}")
    launch = cuda if device.type == "cuda" else plain
    if not wants_grad(*args):
        return launch(*args, **kw)
    return _KernelVJP.apply(launch, plain, kw, *args)
