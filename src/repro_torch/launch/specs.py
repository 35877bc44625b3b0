"""Input stand-ins for every step the dry run traces (the reference's
``launch/specs.py``).

The reference builds ``jax.ShapeDtypeStruct``s that carry their sharding
and lowers the jitted step against them.  The port's stand-ins are
tensors on the ``meta`` device (shapes and types, no storage): each is
what the port's train, prefill or serve step takes on one rank of the
mesh, with a :class:`~repro_torch.launch.mesh.NamedSharding` tree beside
it from which the global shape follows (``sharding.local_shape(global) ==
tensor.shape``):

* parameters, AdamW state and the decode cache: this rank's blocks
  (``shardings_for(mesh, param_specs(cfg))``, ``opt_shardings``,
  ``cache_pspecs``);
* the batch, the prompt's tokens and the frontend embeddings: the global
  tensors, which every rank passes and the step cuts (their sharding is
  the replicated one);
* the AdamW step counter and decode's ``pos``: real 0-d int32 CPU tensors,
  since the update and the decode step read them on the host.

One function per shape kind:

* ``train``   -> ``(params, opt_state, batch)`` for ``make_train_step``;
* ``prefill`` -> ``(params, tokens[, prefix_embeds])`` for ``prefill``;
* ``decode``  -> ``(params, tokens, pos, cache)`` for ``make_serve_step``.

Each returns ``(args, shardings)``, two tuples of the same structure.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.launch.mesh import NamedSharding
from repro_torch.models.frontends import frontend_embed_shape
from repro_torch.models.lm import (cache_shape, param_count, param_shapes,
                                   tree_map)
from repro_torch.serve.decode import cache_pspecs
from repro_torch.train.step import opt_shardings, param_specs, shardings_for

META = torch.device("meta")


def _meta(shape, sharding: NamedSharding, dtype) -> torch.Tensor:
    return torch.empty(sharding.local_shape(shape), dtype=dtype,
                       device=META)


def _replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def dp_size(mesh) -> int:
    """The data-parallel extent: the sizes of ``pod`` and ``data``."""
    return math.prod(mesh.axis_size(a) for a in ("pod", "data"))


def pick_microbatches(cfg, case, mesh) -> int:
    """Memory-driven default: big models accumulate more; the microbatch
    stays divisible by the data-parallel extent."""
    if case.kind != "train":
        return 1
    n = param_count(cfg)
    preferred = 16 if n > 100e9 else 8 if n > 5e9 else 4
    max_mb = max(case.global_batch // dp_size(mesh), 1)
    return max(min(preferred, max_mb), 1)


def param_sds(cfg, mesh, dtype: Optional[torch.dtype] = None):
    """``(params, shardings)``: this rank's blocks of ``cfg``'s parameters
    as meta tensors (float32 leaves cast to ``dtype`` when given)."""
    sh = shardings_for(mesh, param_specs(cfg))
    params = tree_map(
        lambda p, s: _meta(p.shape, s, dtype if dtype is not None
                           and p.dtype == torch.float32 else p.dtype),
        param_shapes(cfg), sh)
    return params, sh


def _tok_len(cfg, seq_len: int) -> int:
    return seq_len - (cfg.frontend_len if cfg.frontend else 0)


def train_input_specs(cfg, case, mesh) -> Tuple[tuple, tuple]:
    """``((params, opt_state, batch), shardings)`` for ``make_train_step``
    on ``mesh``: float32 blocks of the parameters and of AdamW's ``mu``
    and ``nu``, the step counter on the host, the global batch."""
    params, psh = param_sds(cfg, mesh)
    osh = opt_shardings(mesh, psh)
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32, device=META)
    opt = {"mu": tree_map(f32, params), "nu": tree_map(f32, params),
           "step": torch.zeros((), dtype=torch.int32)}
    b, tok_len = case.global_batch, _tok_len(cfg, case.seq_len)
    rep = _replicated(mesh)
    batch: Dict[str, Any] = {
        "tokens": torch.empty((b, tok_len), dtype=torch.int32, device=META),
        "labels": torch.empty((b, tok_len), dtype=torch.int32, device=META)}
    bsh = {"tokens": rep, "labels": rep}
    if cfg.frontend is not None:
        batch["prefix_embeds"] = frontend_embed_shape(cfg, b)
        bsh["prefix_embeds"] = rep
    return (params, opt, batch), (psh, osh, bsh)


def prefill_input_specs(cfg, case, mesh) -> Tuple[tuple, tuple]:
    """``((params, tokens[, prefix_embeds]), shardings)`` for the prefill
    step: bfloat16 blocks of the parameters (inference carries no float32
    masters) and the global prompt."""
    params, psh = param_sds(cfg, mesh, dtype=torch.bfloat16)
    rep = _replicated(mesh)
    toks = torch.empty((case.global_batch, _tok_len(cfg, case.seq_len)),
                       dtype=torch.int32, device=META)
    args, shs = [params, toks], [psh, rep]
    if cfg.frontend is not None:
        args.append(frontend_embed_shape(cfg, case.global_batch))
        shs.append(rep)
    return tuple(args), tuple(shs)


def decode_input_specs(cfg, case, mesh) -> Tuple[tuple, tuple]:
    """``((params, tokens, pos, cache), shardings)`` for the serve step:
    bfloat16 parameter blocks, the global ``[B, 1]`` tokens, ``pos`` on
    the host, and this rank's blocks of a KV/state cache of ``seq_len``
    positions."""
    params, psh = param_sds(cfg, mesh, dtype=torch.bfloat16)
    b = case.global_batch
    rep = _replicated(mesh)
    toks = torch.empty((b, 1), dtype=torch.int32, device=META)
    pos = torch.zeros((), dtype=torch.int32)
    csh = shardings_for(mesh, cache_pspecs(cfg, mesh, b))
    cache = {name: _meta(shape, csh[name], dt) for name, (shape, dt)
             in cache_shape(cfg, b, case.seq_len, torch.bfloat16).items()}
    return (params, toks, pos, cache), (psh, rep, rep, csh)
