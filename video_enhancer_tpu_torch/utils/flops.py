"""Analytic FLOP accounting for the port's hand-written kernels.

Counterpart of video_enhancer_tpu/utils/flops.py. The count of a whole
step has two parts. ``torch.utils.flop_counter.FlopCounterMode`` counts
the products PyTorch runs itself (the counterpart of XLA's cost analysis),
but it cannot see a kernel launched through ``ctypes`` (csrc/, via
kernels.py), just as XLA counts a ``pallas_call`` as zero. So each kernel
wrapper whose JAX counterpart records its analytic FLOPs calls
:func:`record` with the same count, under the same condition, and

    with accounting() as acc:
        y = model(x)
    total = flop_counter_total + acc[0]

gives a step's FLOPs. The wrappers run in eager mode, once per call, so
the recorded count is the count of this run's calls (the JAX package
records while tracing, where the two agree because no model calls a
kernel under ``vmap`` or ``lax.scan``).

Counting convention: 1 MAC = 2 FLOPs; transcendentals (exp) = 1.
"""

from __future__ import annotations

import contextlib

__all__ = ["accounting", "record"]

_acc: list[float] | None = None


def record(n: float) -> None:
    """Add ``n`` analytic FLOPs to the active accounting scope (no-op when
    no scope is active: the served path pays one comparison)."""
    if _acc is not None:
        _acc[0] += float(n)


@contextlib.contextmanager
def accounting():
    """Collect the analytic FLOPs the kernel wrappers record inside the
    ``with`` body. Yields a one-element list; ``acc[0]`` is the total. An
    inner scope's records stay out of the outer one, as in the JAX
    package."""
    global _acc
    prev = _acc
    _acc = acc = [0.0]
    try:
        yield acc
    finally:
        _acc = prev
