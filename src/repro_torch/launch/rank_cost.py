"""One rank's cost on the meta device: the port's counterpart of
``repro.launch.hlo_cost``.

The reference's dry-run compiles each cell for its production mesh, and
``hlo_cost.analyze_hlo`` walks the partitioned program, which is one
device's: its FLOPs and its collective census (each collective's result
bytes and one op a call, by kind, weighted by the trip counts of the loops
around it).  The port has no partitioner: its ranks issue their
collectives themselves (``models.layers``, ``models.optim``).  So this
module runs one rank's program, the one ``launch.parallel`` (serving) or
``launch.train`` (training) runs on that rank, on the meta device at that
rank's blocks, inside a stand-in process group of the mesh's full size
(:func:`stand_in`: torch's ``fake`` backend, whose collectives return at
once and touch no data), and records:

* its product FLOPs (:class:`ProductCounter`: ``FlopCounterMode``'s
  formulas for ``mm``, ``bmm``, convolutions and attention, and
  ``dryrun.grouped_mm_flops`` for the grouped products);
* every collective it issues (``layers.record_collective``) by
  ``hlo_cost``'s five kinds, under its convention: the result bytes of
  each op and one op a call.

What differs from ``hlo_cost``:

* an eager program has no loops to weight: the FLOP counter and the
  recorder see every iteration as it runs, so the census has no
  ``while_loops`` and no ``unknown_trip_loops``;
* the FLOPs are the products alone: ``hlo_cost`` also counts one FLOP an
  element of every elementwise op and of every reduction;
* no traffic (``bytes_accessed``): on the meta device the plain versions of
  the kernels run, whose intermediates are not what the kernels move;
* the collectives are the port's, which are not XLA's: the port's Megatron
  reduce sums in fp32 (``layers._reduce_partial``), twice the bytes of a
  bf16 all-reduce, and it gathers what a rank attends over where XLA may
  move other tensors;
* an MoE whose experts' d lies over the batch axes gathers only the
  experts some token chose (``layers.gather_experts``); the meta device
  routes nothing, so the census gathers every expert, as a prefill's tokens
  choose and the reference gathers at every step, unless it is given the
  counts that a real run recorded (``kept``), as the checks against real
  ranks give it.  The grouped products count every row they are given, a
  capacity-bounded buffer's empty slots and the pairs of other ranks'
  experts included; on a real rank the plain loop computes the routed rows
  alone.

The recorder counts on every run, the real ranks' too (``launch.parallel``
and ``launch.train`` keep each step's census), so a census is held exactly
against what real ranks issue (``tests/test_torch_serve_mesh.py``,
``test_torch_seq_shard.py``, ``test_torch_train_mesh.py``; on the card,
``chip_smoke.py`` phases 31, 33 and 36).

:func:`cell_census` is what the dry-run writes for a cell
(``launch.dryrun.run_cell``): the rank at coordinate 0 on every axis and,
for each axis, the rank at its last coordinate with the others at 0
(:func:`sampled_coords`), where uneven cuts land (whisper's 1500 frames, a
block of the sequence that a query does not reach); the cell's per-device
figures are those of the rank with the most FLOPs.  The whole batch of a
cell is given to every rank, which takes its rows as the launchers do
(``mesh.batch_rows``; a training step's ``value_and_grad``).  A decode
cell's token is the cache's last position, S − 1, a prefill's tokens start
at 0: values a rank would otherwise read on the host, which the meta
device does not hold.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.models import layers
from repro_torch.models.optim import OptimizerConfig, init_adamw, make_train_step
from repro_torch.models.transformer import build_model

from . import mesh, ranks
from .dryrun import grouped_mm_flops

META = torch.device("meta")
KINDS = layers.COLLECTIVE_KINDS


# FlopCounterMode's formulas by op, and the grouped product's
FLOP_FORMULAS = dict(flop_registry)
FLOP_FORMULAS[torch.ops.aten._grouped_mm] = (
    lambda a, b, *args, out_val=None, **kwargs: grouped_mm_flops(a.shape, b.shape))
_KINDS: Dict[Any, tuple] = {}
_PLAIN = (bool, int, float, str, type(None), torch.dtype, torch.device, torch.layout,
          torch.memory_format)


def _kind(func) -> tuple:
    """(whether ``func`` has a decomposition that ``FlopCounterMode`` would
    run, whether it returns a view or writes an argument: in place,
    ``out=``, a collective)."""
    if func not in _KINDS:
        schema = func._schema
        key = torch._C.DispatchKey.CompositeImplicitAutograd
        _KINDS[func] = (
            func is not torch.ops.prim.device.default
            and (key in func.py_kernels
                 or torch._C._dispatch_has_kernel_for_dispatch_key(func.name(), key)),
            any(r.alias_info is not None for r in schema.returns)
            or any(a.alias_info is not None and a.alias_info.is_write for a in schema.arguments))
    return _KINDS[func]


class _Unkeyed(Exception):
    pass


def _key(x):
    """A hashable key of an op's argument: a meta tensor's shape, strides,
    type and offset, or a plain value; raises ``_Unkeyed`` for anything
    else (a tensor off the meta device)."""
    if isinstance(x, torch.Tensor):
        if not x.is_meta:
            raise _Unkeyed
        return (x.size(), x.stride(), x.dtype, x.storage_offset())
    if isinstance(x, (list, tuple)):
        return tuple([_key(v) for v in x])
    if isinstance(x, _PLAIN):
        return (type(x), x)
    raise _Unkeyed


def _spec(out):
    if isinstance(out, torch.Tensor):
        return (tuple(out.shape), out.stride(), out.dtype) if out.is_meta else None
    if isinstance(out, (list, tuple)):
        specs = [_spec(o) for o in out]
        return None if any(s is None for s in specs) else (type(out), specs)
    return None


def _made(spec):
    if isinstance(spec[0], tuple):
        return torch.empty_strided(spec[0], spec[1], dtype=spec[2], device=META)
    return spec[0](_made(s) for s in spec[1])


class ProductCounter(TorchDispatchMode):
    """The product FLOPs of the ops run inside a ``with`` block
    (``get_total_flops()``): ``FlopCounterMode``'s count (its formulas,
    :data:`FLOP_FORMULAS`, and its decompositions) without its per-module
    bookkeeping.  On the meta device an op without a formula that returns
    new tensors (no view, nothing written) and takes only meta tensors and
    plain values runs once for each key of its inputs' shapes, strides,
    types and values: a repeat gets fresh meta tensors of the first
    outputs' shapes, strides and types, all the meta device would give it.
    A program's layers and microbatches repeat the same ops on the same
    shapes, and the meta device's shape functions, most of them Python,
    are what a meta run spends its time in."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.outputs: Dict[Any, Any] = {}

    def get_total_flops(self) -> int:
        return self.total

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        formula = FLOP_FORMULAS.get(func._overloadpacket)
        if formula is not None:
            out = func(*args, **kwargs)
            self.total += formula(*args, **kwargs, out_val=out)
            return out
        decomposes, writes = _kind(func)
        if decomposes:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        if writes:
            return func(*args, **kwargs)
        try:
            key = (func, _key(args), _key(tuple(sorted(kwargs.items()))) if kwargs else ())
        except _Unkeyed:
            return func(*args, **kwargs)
        spec = self.outputs.get(key)
        if spec is not None:
            return _made(spec)
        out = func(*args, **kwargs)
        spec = _spec(out)
        if spec is not None:
            self.outputs[key] = spec
        return out


def sampled_coords(axes: mesh.MeshAxes) -> List[Dict[str, int]]:
    """The coordinates of the ranks a cell's census runs: 0 on every axis,
    then for each axis of more than one rank its last coordinate with the
    others at 0."""
    zero = {a: 0 for a in axes.names}
    return [zero] + [dict(zero, **{a: axes.sizes[a] - 1}) for a in axes.names
                     if axes.sizes[a] > 1]


def rank_of(axes: mesh.MeshAxes, coords: Dict[str, int]) -> int:
    """The rank at ``coords`` of a device mesh over ``axes``: row-major in
    the axes' order, as ``init_device_mesh`` lays the ranks out."""
    rank = 0
    for a in axes.names:
        rank = rank * axes.sizes[a] + coords.get(a, 0)
    return rank


@contextlib.contextmanager
def stand_in(axes: mesh.MeshAxes, rank: int):
    """This process as ``rank`` of a stand-in group of the mesh's size
    (torch's ``fake`` backend: every collective returns at once and touches
    no data), and the ambient device mesh over it (``mesh.device_mesh``,
    its device type "cpu"; the tensors are the meta device's) while the
    block runs; the group is destroyed after.  A process has one default
    group: raises if it already has one."""
    import torch.distributed as dist
    # registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a census needs this process's default group, which it already has")
    world = 1
    for a in axes.names:
        world *= axes.sizes[a]
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        dm = mesh.device_mesh(axes, "cpu")
        with mesh.use_mesh(dm):
            yield dm
    finally:
        dist.destroy_process_group()


def measure(run: Callable[[], Any]) -> Dict:
    """``run()`` once with the recorder reset: {"flops": its product FLOPs,
    "bytes_by_op": {kind: result bytes}, "ops_by_op": {kind: ops}}."""
    layers.COLLECTIVES.clear()
    with ProductCounter() as counter:
        run()
    return dict(layers.collective_census(), flops=counter.get_total_flops())


def serve_program(cfg, batch: int, cache_size: int, lengths: Sequence[int], *, start: int = 0,
                  dtype=torch.bfloat16, seq_shard: bool = False, frames: int = 0,
                  kept: Optional[Sequence[int]] = None) -> List[Dict]:
    """A serving rank's steps on the meta device, under the ambient mesh
    (:func:`stand_in`): its blocks of ``cfg``'s weights
    (``ranks.rank_params``), its rows of a batch of ``batch``
    (``mesh.batch_rows``) and its blocks of a cache of ``cache_size``
    positions (``init_cache(..., params=)``, ``seq_shard`` the reference's
    ``kv_seq_shard``), then one step a length of ``lengths``: a prefill of
    that many tokens (with ``frames`` frame embeddings a row on the first,
    an encoder-decoder's or a frontend's), or a decode where it is 1,
    positions counted from ``start``.  ``kept`` replays how many experts
    each gather of the experts' d took (``layers.EXPERTS_REPLAY``).
    Returns each step's :func:`measure`."""
    model = build_model(cfg)
    params = ranks.rank_params(model, META, dtype)
    rows = mesh.batch_rows(batch)
    n = rows.stop - rows.start
    extra = {"enc_frames": frames} if frames and cfg.is_enc_dec else {}
    cache = model.init_cache(batch, cache_size, dtype, META, params=params,
                             seq_shard=seq_shard, **extra)
    slots = torch.arange(n, device=META)
    out, pos = [], start
    layers.EXPERTS_REPLAY[:] = list(kept or ())
    try:
        with torch.no_grad():
            for i, T in enumerate(lengths):
                fe = frames if i == 0 else 0
                tokens = torch.empty((n, T), dtype=torch.int64, device=META)
                if T == 1 and not fe:
                    out.append(measure(lambda: model.decode_slots(params, cache, tokens, slots,
                                                                  at=[pos] * n)))
                else:
                    inputs = {"tokens": tokens}
                    if fe:
                        inputs["frontend_embeds"] = torch.empty((n, fe, cfg.d_model), dtype=dtype,
                                                                device=META)
                    out.append(measure(lambda: model.prefill(params, inputs, cache, start=pos)))
                pos += T + (fe if not cfg.is_enc_dec else 0)
    finally:
        layers.EXPERTS_REPLAY.clear()
    return out


def train_program(cfg, batch: Dict[str, torch.Tensor], microbatches: int, *,
                  dtype=torch.bfloat16) -> Dict:
    """A training rank's step on the meta device, under the ambient mesh
    (:func:`stand_in`): its blocks of the parameters in ``dtype`` and of
    the AdamW moments by the "train" rules (``train.rank_model``,
    ``ranks.rank_params``), one step of ``make_train_step`` with remat over
    ``microbatches`` on ``batch`` (every row: the rank takes its own).
    Returns its :func:`measure`."""
    from .train import rank_model
    model, sharding = rank_model(cfg, layers.ambient_mesh())
    params = ranks.rank_params(model, META, dtype, mode="train")
    step = make_train_step(model, OptimizerConfig(), microbatches=microbatches, remat=True,
                           sharding=sharding)
    return measure(lambda: step(params, init_adamw(params), batch))


def census(axes: mesh.MeshAxes, coords: Dict[str, int], program: Callable[[], Any]):
    """``program()`` (:func:`serve_program`, :func:`train_program`) as the
    rank at ``coords`` of a stand-in group over ``axes``: what it returns."""
    with stand_in(axes, rank_of(axes, coords)):
        return program()


def cell_program(cell) -> Callable[[], Dict]:
    """The program of a dry-run cell (``specs.build_cell``) on one rank,
    for :func:`census`: its entry once, as the cell runs it on one device."""
    from .specs import TRAIN_MICROBATCHES
    cfg, shape = cell.model_cfg, cell.shape
    B, S = shape.global_batch, shape.seq_len
    if cell.entry == "train_step":
        return lambda: train_program(cfg, cell.args[2], TRAIN_MICROBATCHES.get(cell.arch, 8))
    if cell.entry == "prefill":
        F = cfg.frontend_tokens if cfg.frontend else 0
        return lambda: serve_program(cfg, B, S, [S - F], frames=F)[0]
    return lambda: serve_program(cfg, B, S, [1], start=S - 1,
                                 seq_shard="kv_seq_shard" in cell.opts)[0]


def cell_census(cell) -> Dict:
    """The census of a dry-run cell at its mesh: {"ranks": [{"coords",
    "rank", "flops", "bytes_by_op", "ops_by_op", "total_bytes",
    "total_ops"}] of :func:`sampled_coords`, "flops" and "collectives" (its
    "bytes_by_op", "total_bytes", "total_ops") of the rank with the most
    FLOPs}."""
    axes = cell.axes
    out = []
    for coords in sampled_coords(axes):
        rec = census(axes, coords, cell_program(cell))
        out.append(dict(rec, coords=coords, rank=rank_of(axes, coords),
                        total_bytes=sum(rec["bytes_by_op"].values()),
                        total_ops=sum(rec["ops_by_op"].values())))
    top = max(out, key=lambda r: r["flops"])
    return {"ranks": out, "flops": top["flops"],
            "collectives": {k: top[k] for k in ("bytes_by_op", "total_bytes", "total_ops")}}
