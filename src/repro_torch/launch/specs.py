"""The dry-run's cells on the meta device: ``repro.launch.specs`` without JAX.

One cell is an (architecture, shape, mesh) triple.  :func:`build_cell`
builds the full config's parameters (bf16, as the reference's abstract
tree), the AdamW moments, the cache and the batch as tensors on the
``meta`` device, which have shapes and types and no storage, together with
each tree's placement from :mod:`repro_torch.launch.mesh` (``param_specs``,
``cache_specs``, ``batch_specs``) on a :class:`~repro_torch.launch.mesh.MeshAxes`
of the mesh's axis names and sizes.  No device and no process group is
needed, as the reference needs none of its 512 placeholder devices' memory.

The cell's ``run`` calls its entry once on those tensors and returns the
entry's outputs: ``train_step`` (the trainer's ``make_train_step`` with the
reference's microbatches and remat), ``prefill`` (into an empty cache) or
``serve_step`` (one decode against a cache of the shape's length).  The
meta device runs every op's shape function and no arithmetic, so the port's
plain versions run where the card would run its kernels, as the reference's
dry-run lowers its plain attention and not Pallas.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import SHAPES, ShapeSpec, get_config
from repro_torch.models.config import ModelConfig
from repro_torch.models.optim import OptimizerConfig, init_adamw, make_train_step
from repro_torch.models.transformer import build_model

from .mesh import MeshAxes, batch_specs, cache_specs, param_specs

META = torch.device("meta")

# microbatch counts keyed by arch family size (activation-memory control),
# the reference's
TRAIN_MICROBATCHES: Dict[str, int] = {
    "qwen2_5_3b": 8,
    "granite_3_8b": 8,
    "granite_8b": 8,
    "olmo_1b": 4,
    "llava_next_mistral_7b": 8,
    "dbrx_132b": 16,
    "mixtral_8x7b": 8,
    "recurrentgemma_2b": 8,
    "whisper_base": 4,
    "mamba2_370m": 4,
    "llama3_8b": 8,
    "llama3_70b": 16,
    "qwen3_30b_a3b": 8,
}

# the reference's hillclimb knobs (``repro.launch.specs.build_cell``)
OPTS = ("kv_seq_shard", "moe_a2a", "scores_bf16", "kv_defer_append")


@dataclass
class Cell:
    arch: str
    shape: ShapeSpec
    entry: str                        # train_step | prefill | serve_step
    run: Callable[[], Any]            # the entry once on ``args``; its outputs
    args: Tuple[Any, ...]             # trees of meta tensors
    arg_specs: Tuple[Any, ...]        # their placements, tree for tree
    out_specs: Callable[[Any], Any]   # the placements of ``run``'s outputs
    axes: MeshAxes
    model_cfg: ModelConfig
    tokens_per_step: int              # new tokens processed per call
    opts: Tuple[str, ...] = ()


def _frontend(cfg: ModelConfig, batch: int) -> Optional[torch.Tensor]:
    if cfg.frontend is None:
        return None
    return torch.empty((batch, cfg.frontend_tokens, cfg.d_model), dtype=torch.bfloat16,
                       device=META)


def _tokens(batch: int, length: int) -> torch.Tensor:
    return torch.empty((batch, length), dtype=torch.int32, device=META)


def logits_spec(batch: int, vocab: int, axes: MeshAxes):
    """The port's placement of (B, V) logits: rows over the batch axes
    where they divide B, the vocabulary over "model" where it divides V
    (the unembedding's vocabulary placement)."""
    rows = axes.batch_axes if axes.batch_axes and batch % axes.batch_size() == 0 else None
    if rows is not None and len(rows) == 1:
        rows = rows[0]
    cols = "model" if axes.model and vocab % axes.model_size() == 0 else None
    return (rows, cols)


def abstract_params(model, dtype=torch.bfloat16):
    """``model``'s parameter tree on the meta device in ``dtype`` (fp32
    where the reference keeps fp32 whatever the type)."""
    return model.init(torch.Generator().manual_seed(0), dtype, device=META)


def build_cell(arch: str, shape_name: str, axes: MeshAxes, opts: Tuple[str, ...] = ()) -> Cell:
    """``opts`` are the reference's knobs:

    * ``kv_seq_shard``    — decode cells: the KV sequence over "model";
    * ``moe_a2a``         — MoE blocks through ``layers.moe_a2a``, which
      without ranks (as here) is the dropless MoE, as the reference's
      without a mesh;
    * ``scores_bf16``     — the config's ``attn_scores_dtype``, which the
      port's attention does not read (its softmax is fp32);
    * ``kv_defer_append`` — ``kv_append="defer"``.
    """
    opts = tuple(opts)
    unknown = set(opts) - set(OPTS)
    if unknown:
        raise ValueError(f"unknown opts {sorted(unknown)}; known: {OPTS}")
    cfg = get_config(arch)
    if "scores_bf16" in opts:
        cfg = cfg.replace(attn_scores_dtype="bfloat16")
    if "moe_a2a" in opts and cfg.moe is not None:
        cfg = cfg.replace(moe_impl="a2a")
    if "kv_defer_append" in opts:
        cfg = cfg.replace(kv_append="defer")
    shape = SHAPES[shape_name]
    model = build_model(cfg)
    params = abstract_params(model)
    B, S = shape.global_batch, shape.seq_len
    text_len = S - (cfg.frontend_tokens if cfg.frontend else 0)
    common = dict(arch=arch, shape=shape, axes=axes, model_cfg=cfg, opts=opts)

    if shape.kind == "train":
        p_specs = param_specs(params, axes, "train")
        opt = init_adamw(params)
        o_specs = type(opt)(step=(), mu=p_specs, nu=p_specs)
        batch: Dict[str, Any] = {"tokens": _tokens(B, text_len), "labels": _tokens(B, text_len)}
        fe = _frontend(cfg, B)
        if fe is not None:
            batch["frontend_embeds"] = fe
        step = make_train_step(model, OptimizerConfig(),
                               microbatches=TRAIN_MICROBATCHES.get(arch, 8), remat=True)
        return Cell(entry="train_step", run=lambda: step(params, opt, batch),
                    args=(params, opt, batch),
                    arg_specs=(p_specs, o_specs, batch_specs(batch, axes, batch=B)),
                    out_specs=lambda out: (p_specs, o_specs, {k: () for k in out[2]}),
                    tokens_per_step=B * S, **common)

    # serving entries share params in "serve" mode
    p_specs = param_specs(params, axes, "serve")
    cache = model.init_cache(B, S, torch.bfloat16, META)
    l_spec = logits_spec(B, cfg.vocab_size, axes)

    if shape.kind == "prefill":
        c_specs = cache_specs(cache, axes, batch=B)
        inputs: Dict[str, Any] = {"tokens": _tokens(B, text_len)}
        fe = _frontend(cfg, B)
        if fe is not None:
            inputs["frontend_embeds"] = fe
        return Cell(entry="prefill",
                    run=lambda: model.prefill(params, inputs, cache, start=0),
                    args=(params, inputs, cache),
                    arg_specs=(p_specs, batch_specs(inputs, axes, batch=B), c_specs),
                    out_specs=lambda out: (l_spec, c_specs),
                    tokens_per_step=B * S, **common)

    # decode: one new token against a cache of length S
    c_specs = cache_specs(cache, axes, batch=B, seq_shard="kv_seq_shard" in opts)
    tokens = _tokens(B, 1)
    return Cell(entry="serve_step", run=lambda: model.decode_step(params, cache, tokens),
                args=(params, cache, tokens),
                arg_specs=(p_specs, c_specs, batch_specs(tokens, axes, batch=B)),
                out_specs=lambda out: (l_spec, c_specs),
                tokens_per_step=B, **common)
