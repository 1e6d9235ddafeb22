"""AdamW with decoupled weight decay, global-norm clipping, a cosine schedule
with warmup, a gradient-compression knob and microbatched gradient
accumulation: ``repro.models.optim`` over the port's parameter trees.

Parameters, gradients and both moments are nested dictionaries (and, for a
mixed layer pattern, lists) of tensors with the JAX package's names and
stacked (L, ...) layer leaves.  Updates happen in place, under
``torch.no_grad()``: :func:`adamw_update` writes the new parameters and
moments into the tensors it is given and advances ``state.step``, and
returns them.  The arithmetic is the reference's, step by step, in fp32:

* ``grad_allreduce_dtype`` rounds each gradient through that type and back
  (the reference casts before its data-parallel mean), before the norm;
* the global norm clips with ``min(1, clip / (norm + 1e-9))``;
* bias correction at the incremented step;
* weight decay on every leaf with ``ndim >= 2``.  The stacked layer leaves
  keep that rule as the reference has it: a uniform stack's norm scales
  (L, d) and qkv biases (L, H, D) are decayed, a mixed stack's per-layer
  norm scales (d,) are not.

:func:`make_train_step` accumulates the gradients of the microbatches in
each parameter's ``.grad`` in place, so that no second parameter-sized
buffer exists; a stacked leaf is handed to the model as per-layer leaves
whose ``.grad`` are views of the stacked ``.grad`` (see
:func:`value_and_grad`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional, Tuple

import torch

PyTree = Any


@dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    grad_allreduce_dtype: Optional[str] = "bfloat16"


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: PyTree          # first moment  (param-shaped, fp32)
    nu: PyTree          # second moment (param-shaped, fp32)


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping its dictionaries and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree: PyTree) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    else:
        yield tree


def init_adamw(params: PyTree) -> AdamWState:
    """Step 0 and fp32 zero moments beside each parameter."""
    device = next(tree_leaves(params)).device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def cosine_lr(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warmup over ``warmup_steps``, then a cosine from ``lr`` down to
    ``min_lr_ratio * lr`` at ``total_steps``; fp32, on ``step``'s device."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    progress = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * progress))
    scale = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * scale


def global_norm(tree: PyTree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params: PyTree, grads: PyTree, state: AdamWState
                 ) -> Tuple[PyTree, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place: ``params``, ``state.mu``, ``state.nu`` and
    ``state.step`` are updated and returned; fp32 ``grads`` are used as
    scratch (rounded and clipped in place).  Returns (params, state,
    {"grad_norm", "lr"}), the norm before clipping."""
    gs = []
    for g in tree_leaves(grads):
        g = g if g.dtype == torch.float32 else g.float()
        if cfg.grad_allreduce_dtype:
            g.copy_(g.to(getattr(torch, cfg.grad_allreduce_dtype)))
        gs.append(g)
    gnorm = global_norm(gs)
    clip = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-9), max=1.0)
    state.step.add_(1)
    b1, b2 = cfg.betas
    step = state.step.float()
    bc1 = 1.0 - b1 ** step
    bc2 = 1.0 - b2 ** step
    lr = cosine_lr(cfg, state.step)
    for p, g, m, v in zip(tree_leaves(params), gs, tree_leaves(state.mu),
                          tree_leaves(state.nu)):
        # the reference's expressions in its order of operations, with at
        # most two parameter-sized temporaries alive at once
        g.mul_(clip)
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g.mul(1 - b2).mul_(g))
        delta = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        if p.ndim >= 2:  # decay matrices only (standard practice), as the reference
            delta.add_(p.float() * cfg.weight_decay)
        delta.mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_(p.float() - delta)
    return params, state, {"grad_norm": gnorm, "lr": lr}


# --------------------------------------------------------------------------
def _zero_grads(params: PyTree) -> None:
    """Give every parameter a zeroed ``.grad`` (allocated once, then reused)."""
    for p in tree_leaves(params):
        p.requires_grad_(True)
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        else:
            p.grad.zero_()


def _layer_leaves(params: PyTree, stacked) -> PyTree:
    """``params`` with each stacked subtree in ``stacked`` (leaves (L, ...))
    replaced by a list of L per-layer dictionaries of leaf views, whose
    ``.grad`` are the matching views of the stacked ``.grad``.  Autograd then
    adds each layer's gradient into the stacked ``.grad`` in place, where
    indexing the stacked leaf would build a zero-filled stacked-size gradient
    for every layer."""
    def view(p, i):
        leaf = p.detach()[i].requires_grad_(True)
        leaf.grad = p.grad[i]
        return leaf

    out = dict(params)
    for key in stacked:
        n = next(tree_leaves(params[key])).shape[0]
        out[key] = [tree_map(lambda p, i=i: view(p, i), params[key]) for i in range(n)]
    return out


def value_and_grad(model, params: PyTree, batch: Dict[str, torch.Tensor], *,
                   microbatches: int = 1, remat: bool = True, force: Optional[str] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], PyTree]:
    """The loss, metrics and gradients of ``model.train_loss`` on ``batch``,
    the gradients left in each parameter's ``.grad`` (zeroed first) and
    returned as a tree.  With ``microbatches > 1`` the batch's leading axis
    is split and the microbatches' gradients accumulate in place, then are
    divided by the count; the loss is the mean of the microbatch losses and
    the metrics are {"loss"} alone, as in the reference."""
    B = next(iter(batch.values())).shape[0]
    if B % microbatches:
        raise ValueError(f"a batch of {B} does not split into {microbatches} microbatches")
    _zero_grads(params)
    views = _layer_leaves(params, model.stacked)
    if microbatches == 1:
        loss, metrics = model.train_loss(views, batch, remat=remat, force=force)
        loss.backward()
        loss = loss.detach()
    else:
        n = B // microbatches
        loss = 0.0
        for i in range(microbatches):
            mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            l_mb, _ = model.train_loss(views, mb, remat=remat, force=force)
            l_mb.backward()
            loss = loss + l_mb.detach()
        loss = loss / microbatches
        for p in tree_leaves(params):
            p.grad.div_(microbatches)
        metrics = {"loss": loss}
    return loss, metrics, tree_map(lambda p: p.grad, params)


def make_train_step(model, opt_cfg: OptimizerConfig, *, microbatches: int = 1,
                    remat: bool = True):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: :func:`value_and_grad`, then :func:`adamw_update` in place;
    the metrics are the loss's and the optimizer's (``grad_norm``, ``lr``)."""

    def train_step(params, opt_state, batch):
        _, metrics, grads = value_and_grad(model, params, batch, microbatches=microbatches,
                                           remat=remat)
        params, opt_state, opt_metrics = adamw_update(opt_cfg, params, grads, opt_state)
        return params, opt_state, dict(metrics, **opt_metrics)

    return train_step
