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
``models.layers`` runs on the blocks, and the expert-parallel MoE's experts.
:func:`build_params` makes the same tree leaf by leaf from a seed, so that a
rank never holds more than its blocks and one whole leaf.  Where the rules
place a leaf on a dimension no layer runs a block of (the SSD's leaves, the
experts' fallback to their FFN width), :func:`model_placements` decides by
what the ranks are for.  A tree with MoE experts is served expert-parallel:
such a leaf stays whole on every rank, as the experts that do not divide
stay whole for the dropless fallback.  A dense tree has the ranks for
tensor parallelism alone, so there it raises, and so do ``shard_params``
and ``build_params``.  The "data" entries the serve rules give the MoE's
experts are not executed: each data rank keeps them whole.

The tree walkers (:func:`param_specs`, :func:`cache_specs`,
:func:`batch_specs`) take the port's nested dicts and lists of tensors and
name each leaf as the reference's ``_leaf_name`` does: keys and list
indices joined by "/".
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch

from repro_torch.models.layers import ambient_mesh, model_coordinate, on_init, use_mesh

__all__ = ["MeshAxes", "Spec", "param_specs", "cache_specs", "batch_specs", "leaves_with_names",
           "named_specs", "shard_shape", "shard_bytes", "device_mesh", "use_mesh", "ambient_mesh",
           "model_placements", "shard_params", "build_params",
           "model_coordinate"]

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
    "data"; ``seq_shard`` also shards the KV sequence over "model"."""
    shard_batch = _divides(batch, axes.batch_size())
    return _map_named(cache, lambda name, leaf: _cache_spec(
        name, tuple(leaf.shape), axes, shard_batch=shard_batch, seq_shard=seq_shard))


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
    return init_device_mesh(device_type, tuple(axes.sizes[a] for a in axes.names),
                            mesh_dim_names=axes.names)


# (parent/leaf) -> {the dimension, from the right, of the leaf's block that
# the port's layers run on a "model" rank: what it is} (``models.layers``:
# attn_qkv, attn_out and AttnHeads, mlp, embed, unembed, rglru, moe_a2a); an
# encoder's, a decoder's and a cross attention's leaves alike
_HEADS = {-2: "heads", -1: "head_dim"}
_WIDTH = {-1: "width"}
EXECUTED = {"embed": {-2: "vocabulary"}, "unembed": {-1: "vocabulary"},
            "attn/wq": _HEADS, "attn/wk": _HEADS, "attn/wv": _HEADS,
            "attn/wo": {-3: "heads", -2: "head_dim"},
            "mlp/wi": {-1: "F"}, "mlp/wg": {-1: "F"}, "mlp/wo": {-2: "F"},
            "rglru/w_x": _WIDTH, "rglru/w_gate_in": _WIDTH, "rglru/w_a": _WIDTH,
            "rglru/w_i": _WIDTH, "rglru/w_out": {-2: "width"},
            "moe/w_in": {-3: "experts"}, "moe/w_out": {-3: "experts"}}
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


def model_placements(params: Any, tp: int) -> Dict[str, Optional[int]]:
    """{leaf name: the dimension, from the right, that a rank of ``tp``
    "model" ranks holds its block of, or None where it holds the leaf
    whole} for every leaf of ``params``: where the serve rules
    (:func:`param_specs` at a ("data", "model") mesh of (1, ``tp``)) place
    the leaf on "model" and a layer of the port runs that block
    (``EXECUTED``): the attention's projections on heads or head_dim, in
    the combinations the rules make (``ATTENTION_SPLITS``), an encoder's,
    decoder's and cross attention's as a decoder's; the MLP's F; the
    RG-LRU's width; the vocabulary; the experts.

    Where the rules place a leaf that no layer runs a block of, a tree with
    MoE experts (served expert-parallel) keeps the leaf whole on every rank
    (experts that do not divide, on their FFN width, for the dropless
    fallback); a tree without (whose ranks are for tensor parallelism
    alone: the SSD's leaves) raises ``ValueError``, naming the leaf and the
    rule."""
    axes = MeshAxes(("data", "model"), (1, tp))
    leaves = list(leaves_with_names(params))
    experts = any(_role(name) == "moe/w_in" for name, _ in leaves)
    dims: Dict[str, Optional[int]] = {}
    for name, leaf in leaves:
        shape = tuple(leaf.shape)
        dim = _model_dim(_param_spec(name, shape, axes, "serve"), len(shape))
        run = EXECUTED.get(_role(name), {})
        if dim is not None and dim not in run:
            if not experts:
                what = ("no layer of the port runs a block of this leaf" if not run else
                        "the port runs its block on " + " or ".join(
                            f"{v} (dimension {k})" for k, v in run.items()) + " only")
                raise ValueError(f"{name} {shape}: the serve rules (launch.mesh._param_spec) "
                                 f"place dimension {dim} on 'model' at {tp} ranks, and {what}")
            dim = None                          # whole, as expert parallelism runs it
        dims[name] = dim
    for name in [n for n in dims if n.endswith("attn/wq")]:
        split = tuple(dims[name[:-2] + w] for w in ("wq", "wk", "wv", "wo"))
        if split not in ATTENTION_SPLITS:
            raise ValueError(f"{name[:-3]}: the serve rules place wq, wk, wv, wo on dimensions "
                             f"{split} at {tp} ranks, a split no attention layer of the port runs")
    return dims


def _block(leaf, dim: Optional[int], m: int, tp: int, whole=None):
    """Rank m's block of ``leaf`` along ``dim`` (a copy, so the whole leaf
    can be freed), or the leaf itself where it is not placed or is a block
    already (its shape is not ``whole``)."""
    if dim is None or (whole is not None and tuple(leaf.shape) != tuple(whole)):
        return leaf
    n = leaf.shape[dim] // tp
    return leaf.narrow(leaf.dim() + dim, m * n, n).clone()


def _walk(tree, fn, prefix=""):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, f"{prefix}/{k}" if prefix else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree) if hasattr(tree, "shape") else tree


def shard_params(params: Any, mesh=None) -> Any:
    """One rank's tree of a whole parameter tree: each leaf that the serve
    rules place on "model" (:func:`model_placements`, which raises for a
    placement the port does not run) cut into the "model" size's equal
    blocks on that dimension and the block of this rank's "model"
    coordinate kept (a copy, so the whole tree can be freed); every other
    leaf is the whole leaf itself.  ``mesh`` defaults to the ambient mesh;
    with one "model" rank the tree is returned as it is."""
    m, tp = model_coordinate(ambient_mesh() if mesh is None else mesh)
    if tp == 1:
        return params
    dims = model_placements(params, tp)
    return _walk(params, lambda name, leaf: _block(leaf, dims[name], m, tp))


def build_params(model, generator: torch.Generator, dtype=torch.float32, device=None,
                 mesh=None) -> Any:
    """``shard_params(model.init(generator, dtype, device), mesh)`` without
    the whole tree: the tree is first built on the meta device, which gives
    each leaf's name in the order ``model.init`` draws them and each
    placement (raising as :func:`model_placements` does); then each leaf is
    drawn whole from ``generator``, exactly as ``model.init`` draws it, and
    replaced by this rank's block at once (``layers.on_init``), so that the
    rank's peak is its blocks and one whole leaf."""
    m, tp = model_coordinate(ambient_mesh() if mesh is None else mesh)
    if tp == 1:
        return model.init(generator, dtype, device)
    drawn = []
    with use_mesh(None), on_init(lambda t: drawn.append(t) or t):
        meta = model.init(torch.Generator().manual_seed(0), dtype, device="meta")
    whole = {name: leaf.shape for name, leaf in leaves_with_names(meta)}
    names = {id(leaf): name for name, leaf in leaves_with_names(meta)}
    order = iter([names.get(id(t)) for t in drawn])
    dims = model_placements(meta, tp)
    del meta, drawn

    def keep(t):
        name = next(order)
        return t if name is None else _block(t, dims[name], m, tp)

    with on_init(keep):
        params = model.init(generator, dtype, device)
    # a leaf that is not drawn (a norm, a bias) is cut here, if placed
    return _walk(params, lambda name, leaf: _block(leaf, dims[name], m, tp, whole[name]))
