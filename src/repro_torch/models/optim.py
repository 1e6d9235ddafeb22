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

On the ranks of a ("data", "model") or ("pod", "data", "model") mesh (a
:class:`Sharding`, which ``launch.mesh.train_sharding`` builds; "data"
below is the batch axes, flattened pod-major on a pod mesh) the step is
the reference's ``train_4k`` program: each rank holds its blocks of the parameters and of
both moments by the "train" rules, runs its block of each microbatch's
rows, and hands the model each leaf cut over "data" as a
``layers.DataBlock``, which the model gathers where a layer uses it (FSDP);
every rank ends with the loss of all the rows, the gradient of a gathered
leaf is summed over "data" into the rank's block by the gather's
reduce-scatter, every other leaf's is summed over "data" after the
backward pass, and the norm that clips counts each element of the whole
tree once.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from . import layers as L

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


@dataclass(frozen=True)
class Sharding:
    """How one rank of a ("data", "model") or ("pod", "data", "model") mesh
    holds a parameter tree for training: ``dims``, a tree shaped like the
    parameters, gives each leaf's dimension (from the right) cut over the
    batch axes ("data", or ("pod", "data") pod-major), or None where the
    rank holds it whole over them; ``replicas`` the number of ranks that
    hold the same block of it; ``group`` is the rank's process group of the
    batch axes, ``rank`` its coordinate on them and ``size`` their size.  The
    "model" cut needs nothing here: the layers read it from the blocks'
    shapes."""

    dims: PyTree
    replicas: PyTree
    group: Any
    rank: int
    size: int

    def global_norm(self, grads) -> torch.Tensor:
        """The norm of the whole tree of which ``grads`` (in the order of
        the parameters' leaves) are this rank's blocks: each block's squares
        over the ranks that hold it, summed over every rank."""
        sq = torch.sum(torch.stack([torch.sum(torch.square(g.float())) / r for g, r in
                                    zip(grads, tree_leaves(self.replicas))]))
        dist.all_reduce(sq)
        L.record_collective("all-reduce", sq)
        return torch.sqrt(sq)


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
def adamw_update(cfg: OptimizerConfig, params: PyTree, grads: PyTree, state: AdamWState,
                 sharding: Optional[Sharding] = None
                 ) -> Tuple[PyTree, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place: ``params``, ``state.mu``, ``state.nu`` and
    ``state.step`` are updated and returned; fp32 ``grads`` are used as
    scratch (rounded and clipped in place).  Returns (params, state,
    {"grad_norm", "lr"}), the norm before clipping: on a rank of a mesh
    (``sharding``) the whole tree's, of which every leaf here is a block."""
    gs = []
    for g in tree_leaves(grads):
        g = g if g.dtype == torch.float32 else g.float()
        if cfg.grad_allreduce_dtype:
            g.copy_(g.to(getattr(torch, cfg.grad_allreduce_dtype)))
        gs.append(g)
    gnorm = global_norm(gs) if sharding is None else sharding.global_norm(gs)
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


def _layer_leaves(params: PyTree, stacked, sharding: Optional[Sharding] = None) -> PyTree:
    """``params`` with each stacked subtree in ``stacked`` (leaves (L, ...))
    replaced by a list of L per-layer dictionaries of leaf views, whose
    ``.grad`` are the matching views of the stacked ``.grad``.  Autograd then
    adds each layer's gradient into the stacked ``.grad`` in place, where
    indexing the stacked leaf would build a zero-filled stacked-size gradient
    for every layer.  With more than one "data" rank, each leaf (or layer's
    view) cut over "data" is wrapped in a ``layers.DataBlock``, which the
    model gathers where it uses it."""
    def view(p, i):
        leaf = p.detach()[i].requires_grad_(True)
        leaf.grad = p.grad[i]
        return leaf

    out = dict(params)
    for key in stacked:
        n = next(tree_leaves(params[key])).shape[0]
        out[key] = [tree_map(lambda p, i=i: view(p, i), params[key]) for i in range(n)]
    if sharding is None or sharding.size == 1:
        return out

    def wrap(leaf, dim):
        return leaf if dim is None else L.DataBlock(leaf, dim, sharding.group)

    return {key: ([tree_map(wrap, layer, sharding.dims[key]) for layer in sub]
                  if key in stacked else tree_map(wrap, sub, sharding.dims[key]))
            for key, sub in out.items()}


def _reduce_over_data(params: PyTree, sharding: Sharding, rows_cut: bool) -> None:
    """After the backward pass on a rank with more than one "data" rank:
    every leaf whole over "data" has its gradient summed over the ranks (a
    leaf cut over "data" was summed into the rank's block by its gathers'
    reduce-scatters).  Where the rows were not cut, every rank ran all of
    them and so holds the whole gradient, and each sum is divided by the
    ranks."""
    for p, dim in zip(tree_leaves(params), tree_leaves(sharding.dims)):
        if dim is None:
            L.REDUCED["replicated"] += (2 * (sharding.size - 1) * p.grad.numel()
                                        * p.grad.element_size() // sharding.size)
            dist.all_reduce(p.grad, group=sharding.group)
            L.record_collective("all-reduce", p.grad)
        if not rows_cut:
            p.grad.div_(sharding.size)


def value_and_grad(model, params: PyTree, batch: Dict[str, torch.Tensor], *,
                   microbatches: int = 1, remat: bool = True, force: Optional[str] = None,
                   sharding: Optional[Sharding] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], PyTree]:
    """The loss, metrics and gradients of ``model.train_loss`` on ``batch``,
    the gradients left in each parameter's ``.grad`` (zeroed first) and
    returned as a tree.  With ``microbatches > 1`` the batch's leading axis
    is split and the microbatches' gradients accumulate in place, then are
    divided by the count; the loss is the mean of the microbatch losses and
    the metrics are {"loss"} alone, as in the reference.

    On a rank of a mesh (``sharding``; ``params`` its blocks, ``batch`` the
    whole batch) with D "data" ranks, the reference splits the batch into
    microbatches and then spreads each microbatch's rows over "data": rank d
    runs block d of each microbatch's rows, where D divides them (the
    ``batch_shardings`` rule), else all of them.  The loss is every row's
    on every rank (``layers.split_rows``) and the gradients are the whole
    tree's, in the rank's blocks (:func:`_reduce_over_data`).  An MoE with
    ``moe_impl="a2a"`` over more than one "data" rank raises
    ``NotImplementedError`` (ROADMAP F7)."""
    B = next(iter(batch.values())).shape[0]
    if B % microbatches:
        raise ValueError(f"a batch of {B} does not split into {microbatches} microbatches")
    n = B // microbatches
    D = 1 if sharding is None else sharding.size
    cfg = model.cfg
    if D > 1 and cfg.moe is not None and cfg.moe_impl == "a2a":
        raise NotImplementedError(
            "training moe_impl='a2a' over more than one 'data' rank: the reference's auxiliary "
            "loss there is one shard's statistic (out_specs=P()), which has no one value to "
            "match (ROADMAP Queue C, F7); train with moe_impl='ragged'")
    rows_cut = D > 1 and n % D == 0
    k = n // D if rows_cut else n
    first = sharding.rank * k if rows_cut else 0
    _zero_grads(params)
    views = _layer_leaves(params, model.stacked, sharding)
    with L.split_rows(sharding.group if rows_cut else None):
        if microbatches == 1:
            mb = {key: v[first:first + k] for key, v in batch.items()}
            loss, metrics = model.train_loss(views, mb, remat=remat, force=force)
            loss.backward()
            loss = loss.detach()
        else:
            loss = 0.0
            for i in range(microbatches):
                mb = {key: v[i * n + first:i * n + first + k] for key, v in batch.items()}
                l_mb, _ = model.train_loss(views, mb, remat=remat, force=force)
                l_mb.backward()
                loss = loss + l_mb.detach()
            loss = loss / microbatches
            metrics = {"loss": loss}
    if D > 1:
        _reduce_over_data(params, sharding, rows_cut)
    if microbatches > 1:
        for p in tree_leaves(params):
            p.grad.div_(microbatches)
    return loss, metrics, tree_map(lambda p: p.grad, params)


def make_train_step(model, opt_cfg: OptimizerConfig, *, microbatches: int = 1,
                    remat: bool = True, sharding: Optional[Sharding] = None):
    """``train_step(params, opt_state, batch, on_grads=None) -> (params,
    opt_state, metrics)``: :func:`value_and_grad`, then :func:`adamw_update`
    in place; the metrics are the loss's and the optimizer's (``grad_norm``,
    ``lr``).  ``on_grads``, if given, is called with the gradients before the
    optimizer rounds and clips them in place.  On a rank of a mesh
    (``sharding``), its blocks of the parameters and moments, and the whole
    batch."""

    def train_step(params, opt_state, batch, on_grads: Optional[Callable] = None):
        _, metrics, grads = value_and_grad(model, params, batch, microbatches=microbatches,
                                           remat=remat, sharding=sharding)
        if on_grads is not None:
            on_grads(grads)
        params, opt_state, opt_metrics = adamw_update(opt_cfg, params, grads, opt_state,
                                                      sharding)
        return params, opt_state, dict(metrics, **opt_metrics)

    return train_step
