"""Partitioning rules for every architecture: ``repro.launch.mesh`` without JAX.

The reference's production meshes are (16, 16) with axes ("data", "model")
and (2, 16, 16) with ("pod", "data", "model").  Its sharding table is
name-based with a divisibility fallback: a dimension is sharded only when
the axes' sizes divide it; otherwise the rule falls through to the next
candidate dimension, or to replication.

* **TP ("model")**: attention heads (head_dim where the head count does
  not divide, e.g. whisper's 8 heads or recurrentgemma's 10), FFN width,
  the MoE expert axis (dbrx's 16 experts, qwen3's 128; mixtral's 8 falls
  back to the expert FFN width), the vocab of the embeddings, the SSD inner
  width.
* **FSDP ("data" [+ "pod"])**, training only: a parameter dimension over
  the batch axes.  Serving replicates dense weights across "data" but keeps
  MoE expert tensors data-sharded.
* **Batch ("pod" + "data")**: token batches, KV caches, recurrent states; a
  batch the batch axes do not divide shards the KV sequence over "data"
  instead (context-parallel decode).

Every rule is right-aligned on the trailing dimensions, so one table serves
stacked (L, ...) parameters, per-layer lists and cache trees.

A spec here is a tuple with one entry per dimension: ``None``, an axis
name, or a tuple of axis names, the entries of the reference's
``PartitionSpec``.  :class:`MeshAxes` is built from axis names and sizes;
there are no devices.  ``make_production_mesh`` and the ``NamedSharding``
trees are left out, since nothing here holds 256 devices: the dry-run
(:mod:`repro_torch.launch.dryrun`) divides each leaf's shape by the axes
its spec names instead (:func:`shard_shape`, :func:`shard_bytes`).

Real ranks: :func:`device_mesh` builds a ``torch.distributed`` device mesh
with the axes of a :class:`MeshAxes` over the default process group, which
the caller has initialised with the backend of its choice, and
:func:`use_mesh` makes it the ambient mesh (the reference's ``with mesh:``),
which :func:`ambient_mesh` returns (its ``_ambient_mesh``) and the
expert-parallel MoE reads; the three live with the MoE in
:mod:`repro_torch.models.layers`, runtime state the model reads, and are
re-exported here.  :func:`shard_params` cuts a whole parameter
tree into one rank's: every leaf that :func:`param_specs` in "serve" mode
places on "model" at a ("data", "model") mesh of (1, tp), cut to the rank's
block of :func:`shard_shape` by its "model" coordinate, every other leaf
whole.  That is Megatron's tensor parallelism for the dense layers (the
attention's heads, or head_dim where the heads do not split, the MLP's F,
the RG-LRU's width, the vocabulary of the embeddings), which
``models.layers`` runs on the blocks; the SSD's packed ``w_in`` columns
and its ``w_out`` rows (K3 on each rank's heads); and the MoE's experts,
or their FFN width where the experts do not divide.  Each block is the
contiguous one the reference's ``NamedSharding`` puts on that device, so
where a packed axis mixes what a rank needs from several blocks (the
SSD's [z | x | B | C | dt], the experts' [gate | up]) the layers exchange
columns over "model" (``layers._fetch_columns``), a cost the rules name
and ``layers.GATHERED`` counts.  :func:`build_params` makes the same tree
leaf by leaf from a seed, so that a rank never holds more than its blocks
and one whole leaf.  A placement that no layer runs (:func:`model_placements`)
raises, naming the leaf, and so do ``shard_params`` and ``build_params``.

Serving on a mesh with batch axes (("data", "model") of (D, M), or
("pod", "data", "model") of (P, D, M)): the serve rules' only "data"
placement of a parameter is the MoE experts' d (``moe_data``: ``w_in``'s
dimension -2, ``w_out``'s -1), over the batch axes ("pod", "data"), which
a rank holds its block of at its coordinate on them, pod-major as the
reference's ``PartitionSpec(("pod", "data"))`` orders them
(``layers.batch_coordinate``); the MoE layer gathers the experts over those
ranks where it runs them.  Every other leaf is whole over the batch axes.
:func:`shard_cache` cuts a cache tree to a rank's blocks by the cache rules
at its batch: its rows over the batch axes where they divide the batch,
else its block of the KV sequence over "data" (context-parallel decode);
with ``seq_shard`` (the reference's ``kv_seq_shard``) also the KV sequence
over "model" where the rows are cut.  ``init_cache(..., params=)`` under
such a mesh allocates only those blocks, and :func:`seq_blocks` says which
block of the sequence (and of an encoder-decoder's frames) a rank holds.

Training (``mode="train"`` of the three, on a ("data", "model") mesh of
(D, M), or a ("pod", "data", "model") mesh of (P, D, M)): each leaf also
has its FSDP dimension, which the "train" rules place on the batch axes
("data", or ("pod", "data"): a dimension D divides but P·D does not stays
whole), and rank (d, m) holds block d (pod-major over the batch axes) of
the "model" block m, the block the reference's ``NamedSharding`` puts on
that device;
:func:`train_sharding` describes how a rank holds the tree for
``models.optim`` (which gathers each such leaf over "data" where a layer
uses it), and :func:`whole_leaves` puts the ranks' blocks back together.

The tree walkers (:func:`param_specs`, :func:`cache_specs`,
:func:`batch_specs`) take the port's nested dicts and lists of tensors and
name each leaf as the reference's ``_leaf_name`` does: keys and list
indices joined by "/".
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch

from repro_torch.models.layers import (BATCH_DIM, ambient_mesh, batch_coordinate, batch_group,
                                      data_coordinate, model_coordinate, on_init, use_mesh)

__all__ = ["MeshAxes", "Spec", "param_specs", "cache_specs", "batch_specs", "leaves_with_names",
           "named_specs", "shard_shape", "shard_bytes", "device_mesh", "use_mesh", "ambient_mesh",
           "model_placements", "shard_params", "build_params", "train_sharding", "whole_leaves",
           "model_coordinate", "data_coordinate", "batch_coordinate", "shard_cache",
           "batch_rows", "mesh_axes", "seq_blocks"]

Spec = Tuple[Any, ...]


class MeshAxes:
    """Axis names and sizes of a mesh (the pod axis optional)."""

    def __init__(self, names: Sequence[str], sizes: Sequence[int]):
        if len(names) != len(sizes):
            raise ValueError(f"{len(names)} axis names for {len(sizes)} sizes")
        self.names = tuple(names)
        self.sizes = dict(zip(self.names, (int(n) for n in sizes)))
        self.model = "model" if "model" in self.names else None
        self.data = "data" if "data" in self.names else None
        self.pod = "pod" if "pod" in self.names else None

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in (self.pod, self.data) if a)

    def batch_size(self) -> int:
        n = 1
        for a in self.batch_axes:
            n *= self.sizes[a]
        return n

    def model_size(self) -> int:
        return self.sizes.get("model", 1)


def _divides(dim: int, n: int) -> bool:
    return n > 0 and dim % n == 0


class _SpecBuilder:
    """Builds a spec right-aligned on a concrete shape, assigning each mesh
    axis at most once and only onto evenly divisible dimensions."""

    def __init__(self, shape: Sequence[int], ax: MeshAxes):
        self.shape = tuple(shape)
        self.ax = ax
        self.spec: list = [None] * len(shape)
        self.used: set = set()

    def try_assign(self, pos: int, axis) -> bool:
        """pos: negative index from the right.  axis: name or tuple."""
        if axis is None:
            return False
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        axes = tuple(a for a in axes if a and a not in self.used)
        if not axes:
            return False
        idx = len(self.shape) + pos
        if idx < 0 or self.spec[idx] is not None:
            return False
        total = 1
        for a in axes:
            total *= self.ax.sizes[a]
        if not _divides(self.shape[idx], total):
            return False
        self.spec[idx] = axes[0] if len(axes) == 1 else axes
        self.used.update(axes)
        return True

    def first(self, candidates) -> None:
        """Assign the first workable (pos, axis) candidate."""
        for pos, axis in candidates:
            if self.try_assign(pos, axis):
                return

    def build(self) -> Spec:
        return tuple(self.spec)


# --------------------------------------------------------------------------
# parameter rules
# --------------------------------------------------------------------------

def _param_spec(name: str, shape: Tuple[int, ...], ax: MeshAxes, mode: str) -> Spec:
    """mode: 'train' (FSDP over batch axes) or 'serve' (dense replicated)."""
    b = _SpecBuilder(shape, ax)
    model = ax.model
    fsdp = ax.batch_axes if mode == "train" else ()
    fsdp = fsdp if fsdp else None
    leaf = name.rsplit("/", 1)[-1]
    nd = len(shape)

    is_moe = "/moe/" in name or name.endswith(("moe/w_in", "moe/w_out"))
    moe_data = ax.batch_axes or None      # MoE experts: data-shard even in serve

    if leaf in ("embed", "unembed"):
        # embed (V, d) / unembed (d, V): shard vocab over model, other over fsdp
        vpos = -2 if leaf == "embed" else -1
        dpos = -1 if leaf == "embed" else -2
        b.first([(vpos, model)])
        b.first([(dpos, fsdp)])
    elif leaf == "pos_embed":
        pass  # replicate
    elif leaf in ("wq", "wk", "wv"):       # (d, H, Dh)
        b.first([(-2, model), (-1, model)])
        b.first([(-3, fsdp)])
    elif leaf == "wo" and nd >= 3 and "attn" in name:   # (H, Dh, d)
        b.first([(-3, model), (-2, model)])
        b.first([(-1, fsdp)])
    elif leaf in ("wi", "wg"):             # (d, F)
        b.first([(-1, model)])
        b.first([(-2, fsdp)])
    elif leaf == "wo":                     # mlp (F, d)
        b.first([(-2, model)])
        b.first([(-1, fsdp)])
    elif leaf == "router":                 # (d, E)
        b.first([(-2, fsdp)])
    elif leaf == "w_in" and is_moe:        # (E, d, n*ff)
        if not b.try_assign(-3, model):    # EP when expert count divides
            b.first([(-1, model)])
        b.first([(-2, moe_data)])
    elif leaf == "w_out" and is_moe:       # (E, ff, d)
        if not b.try_assign(-3, model):
            b.first([(-2, model)])
        b.first([(-1, moe_data)])
    elif leaf == "w_in":                   # ssd (d, X)
        b.first([(-1, model)])
        b.first([(-2, fsdp)])
    elif leaf == "w_out":                  # ssd/rglru (w, d)
        b.first([(-2, model)])
        b.first([(-1, fsdp)])
    elif leaf in ("w_x", "w_gate_in"):     # rglru (d, w)
        b.first([(-1, model)])
        b.first([(-2, fsdp)])
    elif leaf in ("w_a", "w_i"):           # rglru gates (w, w)
        b.first([(-1, model)])
        b.first([(-2, fsdp)])
    # conv kernels, norms, biases, Λ/A_log/D/dt_bias: replicated
    return b.build()


# --------------------------------------------------------------------------
# cache rules
# --------------------------------------------------------------------------

def _cache_spec(name: str, shape: Tuple[int, ...], ax: MeshAxes,
                *, shard_batch: bool, seq_shard: bool = False) -> Spec:
    b = _SpecBuilder(shape, ax)
    model = ax.model
    batch = ax.batch_axes or None
    leaf = name.rsplit("/", 1)[-1]
    if leaf in ("k", "v", "cross_k", "cross_v"):   # (..., B, S, H, D)
        if shard_batch:
            b.first([(-4, batch)])
        else:
            b.first([(-3, ax.data)])               # context parallel on seq
        if seq_shard:
            # decode contexts sharded over "model" on the sequence dim: the
            # score contraction stays local per S-shard, and only the
            # softmax statistics and the (B, H, D) partial sums cross chips
            b.first([(-3, model)])
        b.first([(-2, model), (-1, model)])
    elif leaf == "kv_pos":                          # (..., B, S)
        if shard_batch:
            b.first([(-2, batch)])
        else:
            b.first([(-1, ax.data)])
        if seq_shard:
            b.first([(-1, model)])
    elif leaf == "state" and len(shape) >= 4:       # ssd (..., B, H, N, P)
        if shard_batch:
            b.first([(-4, batch)])
        b.first([(-3, model)])
    elif leaf == "state":                           # rglru (..., B, W)
        if shard_batch:
            b.first([(-2, batch)])
        b.first([(-1, model)])
    elif leaf == "conv":                            # (..., B, K-1, C)
        if shard_batch:
            b.first([(-3, batch)])
        b.first([(-1, model)])
    elif leaf == "cache_len":                       # (B,)
        if shard_batch:
            b.first([(-1, batch)])
    return b.build()


# --------------------------------------------------------------------------
# batch (token input) rule
# --------------------------------------------------------------------------

def _batch_spec(shape: Tuple[int, ...], ax: MeshAxes, *, shard_batch: bool) -> Spec:
    """tokens/labels (B, S); frontend_embeds (B, F, d); positions (B, S):
    the leading (batch) dimension over the batch axes, where they divide it."""
    b = _SpecBuilder(shape, ax)
    if shard_batch and len(shape) >= 1:
        b.try_assign(-len(shape), ax.batch_axes)
    return b.build()


# --------------------------------------------------------------------------
# tree walkers over the port's nested dicts and lists
# --------------------------------------------------------------------------

def leaves_with_names(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(name, leaf) for every array leaf of ``tree`` (anything with a
    ``.shape``), depth first: dict keys and list or tuple indices joined by
    "/", as the reference's ``_leaf_name`` names a JAX tree's paths.  Other
    leaves (the port's host-side ints, such as whisper's ``cross_frames``)
    are skipped."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        if hasattr(tree, "shape"):
            yield prefix, tree
        return
    for key, sub in items:
        yield from leaves_with_names(sub, f"{prefix}/{key}" if prefix else str(key))


def _map_named(tree: Any, fn, prefix: str = "") -> Any:
    """``tree`` with ``fn(name, leaf)`` at each array leaf and None at any
    other leaf."""
    if isinstance(tree, dict):
        return {k: _map_named(v, fn, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_named(v, fn, f"{prefix}/{i}" if prefix else str(i))
               for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn(prefix, tree) if hasattr(tree, "shape") else None


def param_specs(params: Any, axes: MeshAxes, mode: str = "train") -> Any:
    """The spec of every parameter, in a tree shaped like ``params``."""
    if mode not in ("train", "serve"):
        raise ValueError(f"mode must be 'train' or 'serve', got {mode!r}")
    return _map_named(params, lambda name, leaf: _param_spec(name, tuple(leaf.shape), axes, mode))


def cache_specs(cache: Any, axes: MeshAxes, *, batch: int, seq_shard: bool = False) -> Any:
    """The spec of every cache leaf, in a tree shaped like ``cache``: rows
    over the batch axes where they divide ``batch``, else the sequence over
    "data"; ``seq_shard`` also shards the KV sequence over "model".  An
    encoder-decoder's ``cross_k``/``cross_v`` are placed as the reference
    places its own, which hold the ``cross_frames`` frames unpadded: the
    port pads them to whole pages of K2 (whisper's 1500 to 1504), and the
    rules read the reference's shape (1504 divides by 8 and 16, 1500 does
    not)."""
    shard_batch = _divides(batch, axes.batch_size())
    frames = cache.get("cross_frames") if isinstance(cache, dict) else None

    def spec(name, leaf):
        shape = tuple(leaf.shape)
        if frames is not None and name.rsplit("/", 1)[-1] in ("cross_k", "cross_v"):
            shape = shape[:-3] + (frames,) + shape[-2:]
        return _cache_spec(name, shape, axes, shard_batch=shard_batch, seq_shard=seq_shard)

    return _map_named(cache, spec)


def batch_specs(batch_tree: Any, axes: MeshAxes, *, batch: int) -> Any:
    """The spec of every input of a batch (tokens, labels, frontend
    embeddings, positions)."""
    shard_batch = _divides(batch, axes.batch_size())
    return _map_named(batch_tree, lambda _, leaf: _batch_spec(
        tuple(leaf.shape), axes, shard_batch=shard_batch))


# --------------------------------------------------------------------------
# per-device shapes of a placement
# --------------------------------------------------------------------------

def named_specs(specs: Any, prefix: str = "") -> Dict[str, Spec]:
    """{leaf name: spec} of a tree of specs, the names
    :func:`leaves_with_names` gives the tree it was made from (a spec is a
    tuple of entries, not a subtree)."""
    if isinstance(specs, dict):
        items = specs.items()
    elif isinstance(specs, list):
        items = enumerate(specs)
    else:
        return {prefix: specs}
    out: Dict[str, Spec] = {}
    for key, sub in items:
        out.update(named_specs(sub, f"{prefix}/{key}" if prefix else str(key)))
    return out


def shard_shape(shape: Sequence[int], spec: Spec, axes: MeshAxes) -> Tuple[int, ...]:
    """One device's block of a leaf of ``shape`` placed by ``spec``: each
    dimension divided by the sizes of the axes its entry names (the
    reference's ``NamedSharding.shard_shape``; the rules only name axes
    that divide)."""
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        names = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        n = 1
        for a in names:
            n *= axes.sizes[a]
        if dim % n:
            raise ValueError(f"{tuple(shape)} does not split by {spec} on {axes.sizes}")
        out.append(dim // n)
    return tuple(out)


def shard_bytes(tree: Any, specs: Any, axes: MeshAxes) -> int:
    """The bytes one device holds of ``tree`` placed by ``specs`` (a tree of
    the same shape, as the walkers return it): every array leaf's
    :func:`shard_shape` times its element size."""
    if isinstance(tree, dict):
        return sum(shard_bytes(v, specs[k], axes) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(shard_bytes(v, s, axes) for v, s in zip(tree, specs))
    if not hasattr(tree, "shape"):
        return 0
    n = 1
    for d in shard_shape(tuple(tree.shape), specs, axes):
        n *= d
    return n * tree.element_size()


# --------------------------------------------------------------------------
# real ranks: a torch.distributed device mesh and one rank's weights
# --------------------------------------------------------------------------

def device_mesh(axes: MeshAxes, device_type: str = "cuda"):
    """A ``torch.distributed.device_mesh.DeviceMesh`` with the axes of
    ``axes`` in their order (("data", "model") or ("pod", "data", "model")),
    over the default process group, which must hold their product of ranks.
    ``device_type`` is always explicit: ``"cuda"`` on the card, ``"cpu"``
    only when the caller asks for it; the group's backend is whatever the
    caller initialised it with."""
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh(device_type, tuple(axes.sizes[a] for a in axes.names),
                          mesh_dim_names=axes.names)
    if axes.pod:
        # the batch axes' group, pod-major, made here by every rank at once
        dm["pod", "data"]._flatten(BATCH_DIM)
    return dm


def mesh_axes(mesh) -> MeshAxes:
    """The :class:`MeshAxes` of a device mesh (its names and sizes)."""
    names = tuple(mesh.mesh_dim_names)
    return MeshAxes(names, [mesh[a].size() for a in names])


# (parent/leaf) -> {the dimension, from the right, of the leaf's block that
# the port's layers run on a "model" rank: what it is} (``models.layers``:
# attn_qkv, attn_out and AttnHeads, mlp, embed, unembed, rglru, the SSD's
# _ssd_in, moe and moe_a2a); an encoder's, a decoder's and a cross
# attention's leaves alike
_HEADS = {-2: "heads", -1: "head_dim"}
_WIDTH = {-1: "width"}
EXECUTED = {"embed": {-2: "vocabulary"}, "unembed": {-1: "vocabulary"},
            "attn/wq": _HEADS, "attn/wk": _HEADS, "attn/wv": _HEADS,
            "attn/wo": {-3: "heads", -2: "head_dim"},
            "mlp/wi": {-1: "F"}, "mlp/wg": {-1: "F"}, "mlp/wo": {-2: "F"},
            "rglru/w_x": _WIDTH, "rglru/w_gate_in": _WIDTH, "rglru/w_a": _WIDTH,
            "rglru/w_i": _WIDTH, "rglru/w_out": {-2: "width"},
            "ssd/w_in": {-1: "packed columns"}, "ssd/w_out": {-2: "heads' channels"},
            "moe/w_in": {-3: "experts", -1: "FFN width"},
            "moe/w_out": {-3: "experts", -2: "FFN width"}}
# (wq, wk, wv, wo) dimensions an attention block runs with: whole; everything
# on heads; q and o on heads, k and v on head_dim; everything on head_dim
ATTENTION_SPLITS = {(None, None, None, None), (-2, -2, -2, -3), (-2, -1, -1, -3),
                    (-1, -1, -1, -2)}


def _role(name: str) -> str:
    parts = name.split("/")
    return parts[-1] if parts[-1] in ("embed", "unembed") else "/".join(parts[-2:])


def _model_dim(spec: Spec, ndim: int) -> Optional[int]:
    """The dimension, from the right, that ``spec`` places on "model"."""
    for i, entry in enumerate(spec):
        names = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        if "model" in names:
            return i - ndim
    return None


# (parent/leaf) of the leaves a training rank may hold a "data" block of:
# every leaf the layers run a "model" block of, and the router, all gathered
# where they are used (``models.layers.gathered``: a block's leaves in
# ``transformer._train_stack``, the embeddings in ``train_loss``)
GATHERED_OVER_DATA = frozenset(EXECUTED) | {"moe/router"}


def _data_dim(spec: Spec, ndim: int) -> Optional[int]:
    """The dimension, from the right, that ``spec`` places on "data"."""
    for i, entry in enumerate(spec):
        names = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        if "data" in names:
            return i - ndim
    return None


# (parent/leaf) of the leaves a serving rank may hold a block of over the
# batch axes: the MoE's experts, whose d the serve rules place there
# (``moe_data``), gathered where the MoE runs them (``layers.moe``)
SERVED_OVER_DATA = frozenset({"moe/w_in", "moe/w_out"})


def model_placements(params: Any, tp: int, mode: str = "serve", data: Optional[int] = None,
                     pod: int = 1) -> Dict[str, Any]:
    """{leaf name: the dimension, from the right, that a rank of ``tp``
    "model" ranks holds its block of, or None where it holds the leaf
    whole} for every leaf of ``params``: where the serve rules
    (:func:`param_specs` at a ("data", "model") mesh of (1, ``tp``)) place
    the leaf on "model", that dimension, which a layer of the port runs a
    block of (``EXECUTED``): the attention's projections on heads or
    head_dim, in the combinations the rules make (``ATTENTION_SPLITS``), an
    encoder's, decoder's and cross attention's as a decoder's; the MLP's F;
    the RG-LRU's width; the SSD's packed ``w_in`` columns and ``w_out``
    rows; the vocabulary; the experts, or their FFN width where the experts
    do not divide.  Every other leaf is whole.

    A placement that no layer runs raises ``ValueError``, naming the leaf
    and the rule: nothing is kept whole against the rules.

    With ``data``, the rules are read at a mesh of (``data``, ``tp``), or
    of (``pod``, ``data``, ``tp``) with a "pod" axis, and each leaf has a
    pair: (its "model" dimension, as above, which the "train" rules place
    as the serve rules do; its dimension over the batch axes ("pod",
    "data"), or None), each from the right.  A rank gathers such a block
    over the batch axes where a layer uses it: in "train" mode the FSDP cut
    of most leaves (``GATHERED_OVER_DATA``), in "serve" mode the MoE
    experts' d alone (``SERVED_OVER_DATA``).  "train" mode always gives
    pairs, at a "data" size of 1 without ``data``."""
    if mode not in ("train", "serve"):
        raise ValueError(f"mode must be 'train' or 'serve', got {mode!r}")
    pairs = mode == "train" or data is not None
    data = 1 if data is None else data
    axes = (MeshAxes(("pod", "data", "model"), (pod, data, tp)) if pod > 1
            else MeshAxes(("data", "model"), (data, tp)))
    over_data = GATHERED_OVER_DATA if mode == "train" else SERVED_OVER_DATA
    dims: Dict[str, Any] = {}
    for name, leaf in leaves_with_names(params):
        shape = tuple(leaf.shape)
        spec = _param_spec(name, shape, axes, mode)
        dim = _model_dim(spec, len(shape))
        role = _role(name)
        run = EXECUTED.get(role, {})
        if dim is not None and dim not in run:
            what = ("no layer of the port runs a block of this leaf" if not run else
                    "the port runs its block on " + " or ".join(
                        f"{v} (dimension {k})" for k, v in run.items()) + " only")
            raise ValueError(f"{name} {shape}: the {mode} rules (launch.mesh._param_spec) "
                             f"place dimension {dim} on 'model' at {tp} ranks, and {what}")
        dims[name] = dim
        if pairs:
            ddim = _data_dim(spec, len(shape))
            if ddim is not None and role not in over_data:
                raise ValueError(f"{name} {shape}: the {mode} rules (launch.mesh._param_spec) "
                                 f"place dimension {ddim} on 'data' at {pod * data} ranks, and "
                                 "no layer of the port gathers this leaf over 'data'")
            dims[name] = (dim, ddim)
    model_dim = (lambda n: dims[n][0]) if pairs else dims.get
    for name in [n for n in dims if n.endswith("attn/wq")]:
        split = tuple(model_dim(name[:-2] + w) for w in ("wq", "wk", "wv", "wo"))
        if split not in ATTENTION_SPLITS:
            raise ValueError(f"{name[:-3]}: the {mode} rules place wq, wk, wv, wo on dimensions "
                             f"{split} at {tp} ranks, a split no attention layer of the port runs")
    return dims


def _block(leaf, cuts, whole=None):
    """The block of ``leaf`` that ``cuts``, (dimension from the right or
    None, coordinate, size) each, keep (a copy, so the whole leaf can be
    freed), or the leaf itself where no cut places it or it is a block
    already (its shape is not ``whole``)."""
    cuts = [(dim, i, n) for dim, i, n in cuts if dim is not None and n > 1]
    if not cuts or (whole is not None and tuple(leaf.shape) != tuple(whole)):
        return leaf
    for dim, i, n in cuts:
        size = leaf.shape[dim] // n
        leaf = leaf.narrow(leaf.dim() + dim, i * size, size)
    return leaf.clone()


def _coordinates(mesh, mode: str) -> Tuple[int, int, int, int]:
    """(m, "model" size, d, D) of a rank of ``mesh`` (the ambient mesh by
    default): d is its coordinate on the batch axes, of D ranks (pod-major:
    ``layers.batch_coordinate``), over which the serve rules place the
    experts' d and the train rules FSDP."""
    mesh = ambient_mesh() if mesh is None else mesh
    return model_coordinate(mesh) + batch_coordinate(mesh)


def _cuts(params: Any, coords, mode: str) -> Dict[str, list]:
    """{leaf name: the cuts of :func:`_block`} of the rank at ``coords``
    (:func:`_coordinates`) in ``mode``, from the whole tree ``params``
    (:func:`model_placements`, which raises for a placement the port does
    not run; the batch axes' size D alone decides where the rules place a
    leaf on them, so a pod mesh is read as D "data" ranks)."""
    m, tp, d, D = coords
    dims = model_placements(params, tp, mode, D)
    return {name: [(mdim, m, tp), (ddim, d, D)] for name, (mdim, ddim) in dims.items()}


def _walk(tree, fn, prefix=""):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, f"{prefix}/{k}" if prefix else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree) if hasattr(tree, "shape") else tree


def shard_params(params: Any, mesh=None, mode: str = "serve") -> Any:
    """One rank's tree of a whole parameter tree: each leaf that the serve
    rules place on "model" (:func:`model_placements`, which raises for a
    placement the port does not run) cut into the "model" size's equal
    blocks on that dimension and the block of this rank's "model"
    coordinate kept (a copy, so the whole tree can be freed); on a mesh
    with batch axes the MoE experts' d is cut again by the rank's batch
    coordinate; every other leaf is the whole leaf itself.  ``mesh``
    defaults to the ambient mesh; with one rank the tree is returned as it
    is.  ``mode="train"`` cuts each leaf that the "train" rules place on
    "data" by the rank's "data" coordinate.  Each block is the one the
    reference's ``NamedSharding`` puts on that device (:func:`shard_shape`
    of the mode's specs)."""
    coords = _coordinates(mesh, mode)
    if coords[1] == coords[3] == 1:
        return params
    cuts = _cuts(params, coords, mode)
    return _walk(params, lambda name, leaf: _block(leaf, cuts[name]))


def build_params(model, generator: torch.Generator, dtype=torch.float32, device=None,
                 mesh=None, mode: str = "serve") -> Any:
    """``shard_params(model.init(generator, dtype, device), mesh, mode)``
    without the whole tree: the tree is first built on the meta device,
    which gives each leaf's name in the order ``model.init`` draws them and
    each placement (raising as :func:`model_placements` does); then each
    leaf is drawn whole from ``generator``, exactly as ``model.init`` draws
    it, and replaced by this rank's block at once (``layers.on_init``), so
    that the rank's peak is its blocks and one whole leaf."""
    coords = _coordinates(mesh, mode)
    if coords[1] == coords[3] == 1:
        return model.init(generator, dtype, device)
    drawn = []
    with use_mesh(None), on_init(lambda t: drawn.append(t) or t):
        meta = model.init(torch.Generator().manual_seed(0), dtype, device="meta")
    cuts = _cuts(meta, coords, mode)
    whole = {name: leaf.shape for name, leaf in leaves_with_names(meta)}
    names = {id(leaf): name for name, leaf in leaves_with_names(meta)}
    order = iter([names.get(id(t)) for t in drawn])
    del meta, drawn

    def keep(t):
        name = next(order)
        return t if name is None else _block(t, cuts[name])

    with on_init(keep):
        params = model.init(generator, dtype, device)
    # a leaf that is not drawn (a norm, a bias) is cut here, if placed
    return _walk(params, lambda name, leaf: _block(leaf, cuts[name], whole[name]))


def shard_cache(cache: Any, mesh=None, *, batch: int, whole: Any = None,
                seq_shard: bool = False) -> Any:
    """One rank's blocks of a cache tree by the cache rules
    (:func:`cache_specs` at ``batch`` rows) at the axes of ``mesh`` (the
    ambient mesh by default): each dimension that a leaf's spec places on
    axes is cut into as many equal blocks as they have ranks, and the block
    at the rank's coordinate on them is kept (pod-major on ("pod",
    "data")).  That is its rows over the batch axes where they divide
    ``batch``, else its block of the KV sequence over "data"
    (context-parallel decode, the rest of the cache whole over the batch
    axes), and its "model" blocks: with ``seq_shard`` (the reference's
    ``kv_seq_shard``), where the batch axes divide ``batch``, the KV
    sequence over "model" and the heads whole.  The specs are read from ``whole`` (the
    whole tree, ``cache`` itself by default; the meta device will do), and
    a dimension of ``cache`` already smaller than ``whole``'s (a rank's
    heads, as ``init_cache(..., params=)`` cuts them) is kept as it is.
    A cut leaf is a copy (a meta leaf stays on the meta device)."""
    mesh = ambient_mesh() if mesh is None else mesh
    axes = mesh_axes(mesh)
    coord = {a: mesh[a].get_local_rank() for a in axes.names}
    whole = cache if whole is None else whole
    spec_of = named_specs(cache_specs(whole, axes, batch=batch, seq_shard=seq_shard))
    whole_shape = {name: tuple(leaf.shape) for name, leaf in leaves_with_names(whole)}

    def cut(name, leaf):
        out = leaf
        for i, entry in enumerate(spec_of[name]):
            if entry is None or out.shape[i] != whole_shape[name][i]:
                continue
            k, n = 0, 1
            for a in (entry,) if isinstance(entry, str) else entry:
                k, n = k * axes.sizes[a] + coord[a], n * axes.sizes[a]
            out = out.narrow(i, k * (out.shape[i] // n), out.shape[i] // n)
        if out is leaf:
            return leaf
        # a meta block needs no copy (and a meta copy of a view costs seconds of imports)
        return torch.empty(out.shape, dtype=out.dtype, device="meta") if out.is_meta else out.clone()

    return _walk(cache, cut)


def seq_blocks(whole: Any, axes: MeshAxes, coords: Dict[str, int], *, batch: int,
               seq_shard: bool = False) -> Dict[str, Any]:
    """The blocks of the sequence that the rank at ``coords`` ({axis: its
    coordinate}) holds of a cache tree ``whole`` (the meta device will do)
    by the cache rules at ``batch`` rows: {"seq_block": the attention
    layers' KV slots, "cross_block": an encoder-decoder's frames}, each a
    ``models.transformer.SeqBlock`` over the axis that the rules place the
    slot dimension on ("data" for context parallelism, "model" under
    ``seq_shard``), and only where one of more than one rank does.  Raises
    unless a block is a whole number of K2's pages, naming the leaf:
    whisper's frames, padded to 1504, split so over 2 ranks (752 slots,
    where the reference's 1500 give 750), not over 4 (376)."""
    from repro_torch.models.transformer import PAGE_SIZE, SeqBlock
    spec_of = named_specs(cache_specs(whole, axes, batch=batch, seq_shard=seq_shard))
    out: Dict[str, Any] = {}
    for name, leaf in leaves_with_names(whole):
        kind = name.rsplit("/", 1)[-1]
        axis = spec_of[name][leaf.dim() - 3] if kind in ("k", "cross_k") else None
        if axis is None or axes.sizes[axis] == 1:
            continue
        S, n = leaf.shape[-3], axes.sizes[axis]
        if S % n or (S // n) % PAGE_SIZE:
            raise ValueError(f"{name} {tuple(leaf.shape)}: a block of {S / n:g} of {S} slots a "
                             f"rank over {axis!r} is not a whole number of K2's pages of "
                             f"{PAGE_SIZE}")
        key = "cross_block" if kind == "cross_k" else "seq_block"
        block = SeqBlock(coords.get(axis, 0), n, S, axis)
        if out.setdefault(key, block) != block:
            raise ValueError(f"{name}: the attention layers' caches are cut unlike {out[key]}")
    return out


def batch_rows(batch: int, mesh=None) -> slice:
    """The rows of a batch of ``batch`` rows that a serving rank of
    ``mesh`` (the ambient mesh by default) is given: its block over the
    batch axes where they divide the batch (its rows of the cache, by the
    cache rules), else every row (its block of the KV sequence)."""
    i, n = batch_coordinate(ambient_mesh() if mesh is None else mesh)
    if batch % n:
        return slice(0, batch)
    return slice(i * batch // n, (i + 1) * batch // n)


def whole_leaves(params: Any, data: int, tp: int, blocks: Sequence[Any],
                 pod: int = 1) -> Dict[str, Any]:
    """{leaf name: the whole leaf} put together from ``blocks``, the trees
    that :func:`shard_params` in "train" mode gives the ranks of a (``data``,
    ``tp``) mesh, or of a (``pod``, ``data``, ``tp``) one, in rank order
    (d·tp + m, d counted pod-major over the batch axes), placed as the whole
    tree ``params`` (the meta device will do) says: each batch row's "model"
    blocks along the "model" dimension, then the rows along the FSDP
    dimension."""
    data *= pod
    dims = model_placements(params, tp, "train", data)
    trees = [dict(leaves_with_names(t)) for t in blocks]
    out = {}
    for name, (mdim, ddim) in dims.items():
        rows = [trees[d * tp][name] if mdim is None else
                torch.cat([trees[d * tp + m][name] for m in range(tp)], mdim)
                for d in range(data)]
        out[name] = rows[0] if ddim is None else torch.cat(rows, ddim)
    return out


def train_sharding(params: Any, mesh):
    """The ``models.optim.Sharding`` of a rank of ``mesh`` (a device mesh
    with "data" and "model" axes, or "pod", "data" and "model") training
    the model whose whole tree is ``params`` (the meta device will do):
    each leaf's FSDP dimension by the "train" rules, over the batch axes
    (("pod", "data") flattened pod-major on a pod mesh, the group
    ``device_mesh`` makes), and how many ranks hold each of its blocks (the
    batch axes' size where it is whole over them, times the "model" size
    where it is whole over "model"), for the norm that clips."""
    from repro_torch.models.optim import Sharding
    m, tp = model_coordinate(mesh)
    d, D = batch_coordinate(mesh)
    dims = model_placements(params, tp, "train", D)
    replicas = {name: (tp if mdim is None else 1) * (D if ddim is None else 1)
                for name, (mdim, ddim) in dims.items()}
    return Sharding(dims=_walk(params, lambda name, _: dims[name][1]),
                    replicas=_walk(params, lambda name, _: replicas[name]),
                    group=batch_group(mesh) if D > 1 else None, rank=d, size=D)
