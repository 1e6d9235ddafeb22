"""The port's partitioning rules (``repro_torch.launch.mesh``) against the
reference's (``repro.launch.mesh``), leaf by leaf.

For all 13 configs, at the reference's production axis sizes, (data 16,
model 16) and (pod 2, data 16, model 16): every parameter's spec in train
and serve mode, and every cache leaf's spec with the batch sharded and not,
the KV sequence over "model" and not, against the reference's
``PartitionSpec`` on the same (name, shape) list, taken from the reference
model's full-size abstract trees.  The reference's rules read only
``mesh.axis_names`` and ``mesh.devices.shape``, so a stand-in mesh with a
numpy array of that shape serves, without 512 devices.  Then the port's
tree walkers on each reduced config's own params and cache: they name the
leaves as the reference's tree, and give each leaf the reference's spec.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, PAPER_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced_config as jax_reduced_config
from repro.launch import mesh as jmesh
from repro.models.transformer import build_model as jax_build_model
from repro_torch.configs import get_reduced_config
from repro_torch.launch import mesh
from repro_torch.models.transformer import build_model

torch.set_num_threads(2)    # the suite runs in several workers at once

ALL_IDS = list(ARCH_IDS) + list(PAPER_ARCH_IDS)
# the reference's production meshes (``make_production_mesh``)
PRODUCTION = {"single_pod": (("data", "model"), (16, 16)),
              "multi_pod": (("pod", "data", "model"), (2, 16, 16))}
AXES = list(PRODUCTION)
CACHE_BATCH, CACHE_LEN = 32, 2048


class _StandInMesh:
    """What the reference's ``MeshAxes`` reads of a ``jax.sharding.Mesh``."""

    def __init__(self, names, sizes):
        self.axis_names = tuple(names)
        self.devices = np.zeros(sizes, dtype=np.int8)


def _axes(which):
    names, sizes = PRODUCTION[which]
    return mesh.MeshAxes(names, sizes), jmesh.MeshAxes(_StandInMesh(names, sizes))


@functools.cache
def _ref_leaves(arch, what, reduced=False):
    """(name, shape) of every leaf of the reference model's abstract params
    or cache, full size or reduced."""
    cfg = (jax_reduced_config if reduced else jax_get_config)(arch)
    model = jax_build_model(cfg)
    if what == "params":
        tree = model.abstract_params(jnp.bfloat16)
    else:
        tree = model.abstract_cache(2 if reduced else CACHE_BATCH, 64 if reduced else CACHE_LEN,
                                    jnp.bfloat16)
    return tuple((jmesh._leaf_name(path), tuple(leaf.shape))
                 for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0])


def _named_specs(tree, specs, prefix=""):
    """{name: spec} over the array leaves of ``tree``, read from ``specs``
    (the walkers' output) at the same keys: the spec tree has the shape of
    the tree it was made from."""
    if isinstance(tree, dict):
        assert isinstance(specs, dict) and specs.keys() == tree.keys()
        items = [(k, tree[k], specs[k]) for k in tree]
    elif isinstance(tree, (list, tuple)):
        assert type(specs) is type(tree) and len(specs) == len(tree)
        items = list(zip(range(len(tree)), tree, specs))
    else:
        return {prefix: specs} if hasattr(tree, "shape") else {}
    out = {}
    for key, sub, spec in items:
        out.update(_named_specs(sub, spec, f"{prefix}/{key}" if prefix else str(key)))
    return out


@pytest.mark.parametrize("which", AXES)
def test_mesh_axes_match_the_reference(which):
    ax, ref = _axes(which)
    assert ax.sizes == ref.sizes and ax.batch_axes == ref.batch_axes
    assert (ax.model, ax.data, ax.pod) == (ref.model, ref.data, ref.pod)
    assert ax.batch_size() == ref.batch_size() and ax.model_size() == ref.model_size()


@pytest.mark.parametrize("which", AXES)
@pytest.mark.parametrize("arch", ALL_IDS)
def test_param_specs_match_the_reference(arch, which):
    ax, ref_ax = _axes(which)
    leaves = _ref_leaves(arch, "params")
    assert leaves
    for mode in ("train", "serve"):
        for name, shape in leaves:
            exp = tuple(jmesh._param_spec(name, shape, ref_ax, mode))
            assert mesh._param_spec(name, shape, ax, mode) == exp, (arch, mode, name, shape)


@pytest.mark.parametrize("which", AXES)
@pytest.mark.parametrize("arch", ALL_IDS)
def test_cache_specs_match_the_reference(arch, which):
    ax, ref_ax = _axes(which)
    leaves = _ref_leaves(arch, "cache")
    assert leaves
    for shard_batch in (False, True):
        for seq_shard in (False, True):
            for name, shape in leaves:
                exp = tuple(jmesh._cache_spec(name, shape, ref_ax, shard_batch=shard_batch,
                                              seq_shard=seq_shard))
                got = mesh._cache_spec(name, shape, ax, shard_batch=shard_batch,
                                       seq_shard=seq_shard)
                assert got == exp, (arch, shard_batch, seq_shard, name, shape)


@pytest.mark.parametrize("arch", ALL_IDS)
def test_tree_walkers_on_the_port_trees(arch):
    """The reduced model's own params and cache: the walkers name every
    leaf as the reference's tree does and give it the reference's spec, at
    both axis sets, in both modes, and for a batch the batch axes divide
    and one they do not."""
    model = build_model(get_reduced_config(arch))
    params = model.init(torch.Generator().manual_seed(0), torch.float32, device="cpu")
    cache = model.init_cache(2, 64, torch.float32, device="cpu")
    for tree, what in ((params, "params"), (cache, "cache")):
        ref = dict(_ref_leaves(arch, what, reduced=True))
        names = {name: tuple(leaf.shape) for name, leaf in mesh.leaves_with_names(tree)}
        assert names == ref
    for which in AXES:
        ax, ref_ax = _axes(which)
        for mode in ("train", "serve"):
            specs = _named_specs(params, mesh.param_specs(params, ax, mode))
            for name, shape in _ref_leaves(arch, "params", reduced=True):
                assert specs[name] == tuple(jmesh._param_spec(name, shape, ref_ax, mode))
        for batch in (2, ax.batch_size()):
            shard_batch = batch % ax.batch_size() == 0
            specs = _named_specs(cache, mesh.cache_specs(cache, ax, batch=batch))
            for name, shape in _ref_leaves(arch, "cache", reduced=True):
                assert specs[name] == tuple(jmesh._cache_spec(name, shape, ref_ax,
                                                              shard_batch=shard_batch))


@pytest.mark.parametrize("which", AXES)
def test_batch_specs_match_the_reference(which):
    """Tokens, labels and frontend embeddings at a batch the batch axes
    divide and at ones they do not, against the body of the reference's
    ``batch_shardings`` run on its own ``_SpecBuilder`` (the function itself
    wants a real mesh for its ``NamedSharding``)."""
    ax, ref_ax = _axes(which)
    for B in (ax.batch_size(), 8, 1):
        shapes = {"tokens": (B, 128), "labels": (B, 128), "frontend_embeds": (B, 64, 32)}
        got = mesh.batch_specs({k: torch.empty(s, device="meta") for k, s in shapes.items()},
                               ax, batch=B)
        shard = B % ref_ax.batch_size() == 0
        for k, s in shapes.items():
            b = jmesh._SpecBuilder(s, ref_ax)
            if shard:
                b.try_assign(-len(s), ref_ax.batch_axes)
            assert got[k] == tuple(b.build())
        assert (got["tokens"][0] is not None) == shard


def test_mesh_axes_refuse_mismatched_sizes():
    with pytest.raises(ValueError, match="axis names"):
        mesh.MeshAxes(("data", "model"), (16,))
    with pytest.raises(ValueError, match="mode"):
        mesh.param_specs({}, mesh.MeshAxes(("data", "model"), (16, 16)), "infer")


# the reference's decode cells (``repro.configs.SHAPES``): (batch, sequence)
DECODE_CELLS = {"decode_32k": (128, 32_768), "long_500k": (1, 524_288)}


def _ref_dims(spec, ndim):
    """(the dimension, from the right, a reference spec places on "model",
    the one it places on "data"), None where it places none."""
    dims = []
    for axis in ("model", "data"):
        hit = [i - ndim for i, entry in enumerate(spec) if entry is not None
               and axis in ((entry,) if isinstance(entry, str) else tuple(entry))]
        dims.append(hit[0] if hit else None)
    return tuple(dims)


@pytest.mark.parametrize("which", AXES)
@pytest.mark.parametrize("arch", ALL_IDS)
def test_serve_placements_and_cache_blocks_at_a_mesh(arch, which):
    """The full config on the meta device at the production meshes:
    ``model_placements(..., "serve", data=, pod=)`` gives every leaf the
    (model, data) dimensions of the reference's serve spec (the MoE
    experts' d over the batch axes, nothing else there); each decode cell's
    cache (``decode_32k``, and ``long_500k`` where the config takes it) is
    cut by ``shard_cache``, and by ``init_cache`` under the mesh, to the
    block of the reference's cache spec on the last device: rows over the
    batch axes, or the KV sequence over "data" (a ``SeqBlock``)."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import SeqBlock
    from test_torch_serve_mesh import _Coords
    ax, ref_ax = _axes(which)
    names, sizes = PRODUCTION[which]
    cfg = get_config(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), torch.bfloat16, "meta")
    dims = mesh.model_placements(params, ax.model_size(), "serve", ax.sizes["data"],
                                 ax.sizes.get("pod", 1))
    for name, leaf in mesh.leaves_with_names(params):
        spec = jmesh._param_spec(name, tuple(leaf.shape), ref_ax, "serve")
        assert dims[name] == _ref_dims(tuple(spec), leaf.dim()), (arch, name)
        assert dims[name][1] is None or name.endswith(("moe/w_in", "moe/w_out")), name
    last = _Coords(names, sizes, {a: n - 1 for a, n in zip(names, sizes)})
    cells = [c for c in DECODE_CELLS if c != "long_500k" or cfg.supports_long_context()]
    for cell in cells:
        B, S = DECODE_CELLS[cell]
        whole = model.init_cache(B, S, torch.bfloat16, "meta")
        block = dict(mesh.leaves_with_names(mesh.shard_cache(whole, last, batch=B)))
        with mesh.use_mesh(last):
            held = model.init_cache(B, S, torch.bfloat16, "meta")
        shard_batch = B % ref_ax.batch_size() == 0
        for name, leaf in mesh.leaves_with_names(whole):
            spec = jmesh._cache_spec(name, tuple(leaf.shape), ref_ax, shard_batch=shard_batch)
            exp = mesh.shard_shape(tuple(leaf.shape), tuple(spec), ax)
            assert tuple(block[name].shape) == exp, (cell, name)
            assert tuple(dict(mesh.leaves_with_names(held))[name].shape) == exp, (cell, name)
        seq = held.get("seq_block")
        assert (seq is not None) == (not shard_batch and model.has_attn), cell
        if seq is not None:
            assert seq == SeqBlock(ax.sizes["data"] - 1, ax.sizes["data"], seq.whole)


@pytest.mark.parametrize("which", AXES)
@pytest.mark.parametrize("arch", ALL_IDS)
def test_seq_shard_cache_blocks_at_a_mesh(arch, which):
    """``kv_seq_shard`` at the production meshes, for each decode cell the
    config takes: the port's ``cache_specs(..., seq_shard=True)`` of its
    full-size cache are the reference's ``cache_shardings`` specs (its
    ``_cache_spec`` of every leaf of its abstract cache at the cell, the
    batch sharded where the batch axes divide it) leaf for leaf; on the
    last device ``shard_cache`` and ``init_cache(..., seq_shard=True)``
    under the mesh give the block of that spec, with a ``SeqBlock`` over
    "model" where the batch axes divide the batch (``decode_32k``: every
    KV head whole) and over "data" where they do not (``long_500k``, the
    "model" cut falling to the heads).  Whisper's cross cache is placed by
    the reference's unpadded 1500 frames, which 16 ranks do not divide: on
    head_dim, as the reference places it, though the port's padded 1504
    would divide."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import SeqBlock
    from test_torch_serve_mesh import _Coords
    ax, ref_ax = _axes(which)
    names, sizes = PRODUCTION[which]
    cfg = get_config(arch)
    model = build_model(cfg)
    jmodel = jax_build_model(jax_get_config(arch))
    last = _Coords(names, sizes, {a: n - 1 for a, n in zip(names, sizes)})
    cells = [c for c in DECODE_CELLS if c != "long_500k" or cfg.supports_long_context()]
    for cell in cells:
        B, S = DECODE_CELLS[cell]
        shard_batch = B % ref_ax.batch_size() == 0
        whole = model.init_cache(B, S, torch.bfloat16, "meta")
        got = _named_specs(whole, mesh.cache_specs(whole, ax, batch=B, seq_shard=True))
        ref = {jmesh._leaf_name(path): tuple(jmesh._cache_spec(
                   jmesh._leaf_name(path), tuple(leaf.shape), ref_ax, shard_batch=shard_batch,
                   seq_shard=True))
               for path, leaf in jax.tree_util.tree_flatten_with_path(
                   jmodel.abstract_cache(B, S, jnp.bfloat16))[0]}
        assert got == ref, (arch, cell)
        block = dict(mesh.leaves_with_names(
            mesh.shard_cache(whole, last, batch=B, seq_shard=True)))
        with mesh.use_mesh(last):
            held = model.init_cache(B, S, torch.bfloat16, "meta", seq_shard=True)
        for name, leaf in mesh.leaves_with_names(whole):
            exp = mesh.shard_shape(tuple(leaf.shape), ref[name], ax)
            if name.startswith("cross_"):
                assert ref[name][-3] is None and ref[name][-1] == "model", ref[name]
            assert tuple(block[name].shape) == exp, (cell, name)
            assert tuple(dict(mesh.leaves_with_names(held))[name].shape) == exp, (cell, name)
        seq = held.get("seq_block")
        assert (seq is not None) == model.has_attn, cell
        if seq is not None:
            axis = "model" if shard_batch else "data"
            assert seq == SeqBlock(sizes[names.index(axis)] - 1, sizes[names.index(axis)],
                                   seq.whole, axis), cell
