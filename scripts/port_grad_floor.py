#!/usr/bin/env python3
"""Tiny vsrm's step-1 gradients, the port against the JAX package, beside
the port's own rounding floor, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/port_grad_floor.py [--seeds 4]

Takes the case of ``tests/test_torch_train.py::test_train_step_matches_jax``
(tiny vsrm, dim 16, 1 block, x2, live head and offset convs; JAX's
gradients from its ``vsrm_steps`` fixture) and prints: the port's largest
gradient error against JAX as a share of the largest leaf's max abs, and
the worst leaves as a share of their own max abs; then, for each seed, how
far the port's own gradients move when every parameter is perturbed by
half an ulp (times 1 + 6e-8 N(0, 1)), in the same two measures; then the
port against JAX again at 1 and 4 torch threads. The floor is what two
fp32 implementations that sum in different orders can be expected to
differ by; ``GRAD_TOL`` and ``LEAF_TOL`` in the test sit just above it.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import tests.test_torch_train as T  # noqa: E402
from video_enhancer_tpu_torch.models import vsrm  # noqa: E402


def _grads(ref: dict, params) -> dict:
    init_state, _, _ = T.tstep.make_train_step(
        lambda p, c: vsrm.apply(p, c, scale=2), T.tstep.make_optimizer(),
        T.local_mesh("cpu"))
    state = init_state(params)
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    loss = T.tlosses.vsr_loss(vsrm.apply(state.params, batch["lr"], scale=2),
                              batch["hr"])
    g = torch.autograd.grad(loss, T.tstep.tree_leaves(state.params))
    return {k: T.to_jax_layout(k, x)
            for k, x in zip(T.flatten_params(state.params), g)}


def _shares(got: dict, want: dict, top: float) -> tuple[float, list]:
    err = {k: np.abs(got[k] - want[k]).max() for k in want}
    own = {k: float(err[k] / max(np.abs(want[k]).max(), 1e-30))
           for k in want}
    worst = sorted(own.items(), key=lambda kv: -kv[1])[:3]
    return float(max(err.values()) / top), [(k, f"{v:.2e}") for k, v in worst]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=4)
    args = ap.parse_args()
    fixture = T.vsrm_steps
    ref = getattr(fixture, "__pytest_wrapped__", None)
    ref = (ref.obj if ref else fixture.__wrapped__)()
    top = max(np.abs(w).max() for w in ref["grads"].values())
    params = T._port(ref["params"])
    g0 = _grads(ref, params)
    of_top, worst = _shares(g0, ref["grads"], top)
    print(f"port vs JAX: {of_top:.2e} of the largest leaf's max; worst "
          f"leaves, of their own max: {worst}")
    for seed in range(args.seeds):
        gen = torch.Generator().manual_seed(seed)
        moved = T.tstep.tree_unflatten(params, [
            p * (1 + 6e-8 * torch.randn(p.shape, generator=gen))
            for p in T.tstep.tree_leaves(params)])
        of_top, worst = _shares(_grads(ref, moved), g0, top)
        print(f"half-ulp perturbation, seed {seed}: {of_top:.2e} of the "
              f"largest leaf's max; worst leaves, of their own max: {worst}")
    for threads in (1, 4):
        torch.set_num_threads(threads)
        of_top, worst = _shares(_grads(ref, params), ref["grads"], top)
        print(f"port vs JAX at {threads} torch threads: {of_top:.2e} of the "
              f"largest; worst leaf {worst[0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
