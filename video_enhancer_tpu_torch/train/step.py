"""The train step: a loss, its gradients, optax's global-norm clip and
AdamW, on a ``data x time x space`` mesh.

Counterpart of video_enhancer_tpu/train/step.py. JAX jits one program over
the mesh and lets XLA partition it from the batch's sharding. Here each
rank is a process (parallel/mesh.py) and runs the step itself:

- ``shard_batch`` gives each rank its block of B on ``data``, whole in T
  and H. ``apply_fn`` is an arbitrary function of a clip, which XLA can
  partition and the port cannot, so the ranks on a ``time`` or ``space``
  line repeat their data shard's step;
- the gradients are the global batch's mean: each rank's local mean
  times its share (1 / data), summed over ``data`` (one all-reduce, the
  loss with them), before the clip's global norm is taken. So the loss and
  the updated parameters equal a single rank's on the whole batch, up to
  the order of sums. One rank moves the batch to its device.

``make_optimizer`` is ``optax.chain(clip_by_global_norm(1.0), adamw(lr,
weight_decay=wd))`` written to optax's formulas (optax 0.2:
``_clipping.clip_by_global_norm``, ``transform.scale_by_adam``,
``add_decayed_weights``, ``scale_by_learning_rate``, ``apply_updates``):
with g the global norm of the gradients, each is kept if g < 1 and scaled
by ``1.0 / g`` otherwise (no epsilon; ``clip_grad_norm_`` adds 1e-6);
then mu = 0.1 g + 0.9 mu, nu = 0.001 g^2 + 0.999 nu, bias-corrected by
1 - b^count in fp32, the update mu_hat / (sqrt(nu_hat) + 1e-8) plus the
weight decay times the parameter (every parameter: optax's ``mask=None``),
times -lr, added to the parameter. No step syncs with the host: the loss
comes back as a 0-d tensor on the device. Each part of a step runs in a
profiler range (``train_step:forward``, ``:backward``, ``:all_reduce``,
``:optimizer``) that a trace reads.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable

import torch
from torch.profiler import record_function

from .losses import vsr_loss

__all__ = ["TrainState", "AdamW", "make_optimizer", "make_train_step",
           "make_adam_step", "tree_leaves", "tree_unflatten"]


@dataclasses.dataclass
class TrainState:
    """``params``: a tree (dicts and lists) of fp32 leaf tensors that
    require grad; ``opt_state``: the optimizer's (``AdamW.init``); ``step``:
    a 0-d int32 tensor on the device."""
    params: Any
    opt_state: Any
    step: torch.Tensor


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts and lists, depth first in key order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """``tree``'s structure with ``leaves`` (in ``tree_leaves`` order)."""
    it = iter(leaves)

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [fill(v) for v in node]
        return next(it)

    return fill(tree)


# optax's defaults, which the JAX package's chain keeps
# (``optax.adamw``: b1 0.9, b2 0.999, eps 1e-8, eps_root 0;
# ``clip_by_global_norm(1.0)`` in train/step.py:44-48)
B1, B2, EPS, MAX_NORM = 0.9, 0.999, 1e-8, 1.0


class AdamW:
    """optax's ``chain(clip_by_global_norm(MAX_NORM), adamw(lr, B1, B2, EPS,
    eps_root=0, weight_decay))`` on lists of leaves (module docstring).
    ``max_norm=None`` drops the clip: with ``weight_decay=0`` that is
    ``optax.adam(lr)``, the small trainers' optimizer."""

    def __init__(self, lr: float = 2e-4, weight_decay: float = 1e-4,
                 max_norm: float | None = MAX_NORM):
        self.lr, self.weight_decay = lr, weight_decay
        self.max_norm = max_norm

    def init(self, leaves: list) -> dict:
        """``count`` (0-d int32), ``mu`` and ``nu`` (zeros like each leaf)."""
        def zeros():
            return [torch.zeros_like(p, memory_format=torch.contiguous_format)
                    for p in leaves]

        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=leaves[0].device),
                "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def update(self, grads: list, state: dict, leaves: list):
        """The new leaves and optimizer state after one step on ``grads``,
        in multi-tensor ops (a handful of launches for any number of
        leaves)."""
        if self.max_norm is not None:
            g_norm = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(grads)))
            clip = torch.where(g_norm < self.max_norm, 1.0,
                               self.max_norm / g_norm)
            grads = torch._foreach_mul(grads, clip)
        count = state["count"] + 1
        bc1 = 1 - torch.pow(B1, count.float())
        bc2 = 1 - torch.pow(B2, count.float())
        mu = torch._foreach_add(torch._foreach_mul(grads, 1 - B1),
                                torch._foreach_mul(state["mu"], B1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - B2),
            torch._foreach_mul(state["nu"], B2))
        den = torch._foreach_add(torch._foreach_sqrt(
            torch._foreach_div(nu, bc2)), EPS)
        upd = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        upd = torch._foreach_add(upd, torch._foreach_mul(
            leaves, self.weight_decay))
        new = torch._foreach_add(leaves, torch._foreach_mul(upd, -self.lr))
        return new, {"count": count, "mu": mu, "nu": nu}


def make_optimizer(lr: float = 2e-4, weight_decay: float = 1e-4) -> AdamW:
    """The JAX package's optimizer (train/step.py:44-48)."""
    return AdamW(lr=lr, weight_decay=weight_decay)


def make_train_step(apply_fn: Callable, optimizer: AdamW, mesh,
                    batch_spec=("data", "time", "space", None, None),
                    loss_fn: Callable = vsr_loss):
    """``(init_state, train_step, shard_batch)`` on ``mesh``
    (parallel/mesh.py: ``make_mesh`` or ``local_mesh``).

    ``apply_fn(params, lr_clip) -> sr_clip``; batches are dicts with ``lr``
    and ``hr`` clips ``(B, T, H, W, C)``. ``batch_spec`` names each batch
    dimension's mesh axis; the one named ``data`` is split over the data
    axis, the others stay whole (module docstring). A ``loss_fn`` that
    declares an ``lr`` keyword also receives the input clip (JAX's
    train/cli.py correction-magnitude penalty needs it)."""
    data = mesh.axis("data")
    device = mesh.device
    bdim = list(batch_spec).index("data") if "data" in batch_spec else None
    wants_lr = "lr" in inspect.signature(loss_fn).parameters

    def init_state(params) -> TrainState:
        params = tree_unflatten(params, [
            p.detach().to(device, torch.float32).clone().requires_grad_()
            for p in tree_leaves(params)])
        return TrainState(params=params,
                          opt_state=optimizer.init(tree_leaves(params)),
                          step=torch.zeros((), dtype=torch.int32,
                                           device=device))

    def train_step(state: TrainState, batch: dict):
        leaves = tree_leaves(state.params)
        with torch.enable_grad():
            with record_function("train_step:forward"):
                pred = apply_fn(state.params, batch["lr"])
                loss = (loss_fn(pred, batch["hr"], lr=batch["lr"])
                        if wants_lr else loss_fn(pred, batch["hr"]))
            with record_function("train_step:backward"):
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        loss = loss.detach()
        if data.size > 1:
            with record_function("train_step:all_reduce"):
                flat = data.psum(torch.cat([g.reshape(-1) for g in grads]
                                           + [loss.reshape(1)]) / data.size)
            *parts, loss = flat.split([g.numel() for g in grads] + [1])
            grads = [f.view_as(g) for f, g in zip(parts, grads)]
            loss = loss[0]
        with record_function("train_step:optimizer"):
            new, opt_state = optimizer.update(grads, state.opt_state, leaves)
        params = tree_unflatten(state.params,
                                [p.requires_grad_() for p in new])
        return (TrainState(params=params, opt_state=opt_state,
                           step=state.step + 1), {"loss": loss})

    def shard_batch(batch: dict) -> dict:
        """Each array (numpy or torch) on the mesh's device, this rank's
        block of its ``data`` dimension."""
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v).to(device)
            if bdim is not None and data.size > 1:
                if t.shape[bdim] % data.size:
                    raise ValueError(f"{k}: dimension {bdim} of "
                                     f"{t.shape[bdim]} is not divisible by "
                                     f"data={data.size}")
                t = data.shard(t, bdim).contiguous()
            out[k] = t
        return out

    return init_state, train_step, shard_batch


def make_adam_step(loss_fn: Callable, lr: float):
    """``(init, step)`` of a small trainer on one device:
    ``step(params, opt_state, *batch) -> (params, opt_state, loss)``, the
    gradients of ``loss_fn(params, *batch)`` applied with optax's
    ``adam(lr)`` (``AdamW`` without clip or decay); ``init(params)`` makes
    the optimizer state."""
    opt = AdamW(lr=lr, weight_decay=0.0, max_norm=None)

    def init(params):
        return opt.init(tree_leaves(params))

    def step(params, opt_state, *batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        tree = tree_unflatten(params, leaves)
        with torch.enable_grad():
            loss = loss_fn(tree, *batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        new, opt_state = opt.update(grads, opt_state, leaves)
        return tree_unflatten(params, new), opt_state, loss.detach()

    return init, step
