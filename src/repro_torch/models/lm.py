"""Decoder LM assembly: init, forward, prefill, decode step — all 10 families.

Structure, as the reference's ``models/lm.py``: embedding -> ``num_layers``
blocks -> final norm -> untied LM head.  Block internals by family:

* ``dense`` / ``vlm`` / ``audio``: GQA attention + MLP variant;
* ``moe``: GQA attention + routed experts (+ shared experts);
* ``ssm``: RWKV6 time-mix + RWKV channel-mix;
* ``hybrid``: parallel attention (SWA) + mamba heads, then MLP.

``vlm``/``audio`` take precomputed frontend embeddings (the stub), projected
and prepended to the token embeddings.

Layer parameters are stacked ``[L, ...]`` like the reference's, and the
layers run in a Python loop over them (the reference's ``lax.scan`` only
matters to a compiler); with ``cfg.remat`` each layer of
:func:`forward_hidden` runs under non-reentrant
``torch.utils.checkpoint``, as the reference's ``jax.checkpoint`` with
nothing saveable.  ``params["layers"]`` may also be a list of per-layer
trees (the training step passes views of the stacks, each with its own
gradient).  On the sliding-window configs (H2O-Danube3-4B, Hymba-1.5B) a
prompt longer than ``query_chunk + window`` takes the banded branch of
:func:`layers.attention`: the K7 kernel, with its backward kernel under
autograd.  :func:`decode_step` updates the cache it is given in place and
returns it.  :func:`lm_loss` is the next-token cross-entropy, chunked over
the sequence under checkpoint when ``cfg.loss_seq_chunk`` divides it.

``mesh=`` (an :class:`~repro_torch.launch.mesh.LMMesh`) runs
:func:`lm_loss`, :func:`prefill` and :func:`decode_step` on this rank's
blocks of the parameters (placed by their specs) and its rows of the batch:
attention and the MLP tensor-parallel (see :mod:`layers`; where ``model``
does not divide the heads, attention runs whole on every rank of it, its
weights gathered at the start of the layer, except in decode, whose
sequence-split cache takes any head count), the embedding a vocab-parallel
lookup, the loss a vocab-parallel cross-entropy normalised by the token
count over every batch shard, and every other weight of a layer (SSM,
experts, router) gathered whole at the start of its layer and run whole on
every rank.  With ``mesh=None`` or a one-rank mesh none of this runs.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.launch.mesh import NamedSharding, sharded
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S

Params = Dict[str, Any]

ATTENTION_FAMILIES = ("dense", "vlm", "audio", "moe", "hybrid")


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of nested dicts of the same structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {name: tree_map(fn, *(t[name] for t in trees))
                for name in first}
    return fn(*trees)


def tree_leaves(tree, prefix: str = ""):
    """``(path, leaf)`` pairs of a nested dict, paths joined with ``/``."""
    if isinstance(tree, dict):
        for name, value in tree.items():
            yield from tree_leaves(value, f"{prefix}/{name}")
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _layer_init(cfg, generator: torch.Generator, device) -> Tuple[Params,
                                                                  Params]:
    params: Params = {}
    specs: Params = {}
    hd = cfg.resolved_head_dim
    params["ln1"], specs["ln1"] = L.rmsnorm_init(cfg.d_model, device=device)
    params["ln2"], specs["ln2"] = L.rmsnorm_init(cfg.d_model, device=device)
    if cfg.family in ATTENTION_FAMILIES:
        params["attn"], specs["attn"] = L.attention_init(
            generator, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, hd,
            cfg.qkv_bias, device=device)
    if cfg.family in ("dense", "vlm", "audio", "hybrid"):
        params["mlp"], specs["mlp"] = L.mlp_init(
            generator, cfg.d_model, cfg.d_ff, cfg.activation, device=device)
    if cfg.family == "moe":
        params["moe"], specs["moe"] = M.moe_init(
            generator, cfg.d_model, cfg.d_ff, cfg.num_experts,
            cfg.num_shared_experts, cfg.activation, device=device)
    if cfg.family == "ssm":
        params["tmix"], specs["tmix"] = S.rwkv6_init(
            generator, cfg.d_model, cfg.rwkv_num_heads, cfg.rwkv_head_dim,
            device=device)
        params["cmix"], specs["cmix"] = S.rwkv_cmix_init(
            generator, cfg.d_model, cfg.d_ff, device=device)
    if cfg.family == "hybrid":
        params["mamba"], specs["mamba"] = S.mamba_init(
            generator, cfg.d_model, cfg.num_heads * hd, cfg.ssm_state,
            device=device)
    return params, specs


#: Layer subtrees that run tensor-parallel on a mesh (``layers.attention``
#: and ``layers.mlp``); the rest of a layer runs whole on every rank.
TP_SUBTREES = ("attn", "mlp")


def _attn_mesh(cfg, mesh):
    """The mesh attention runs tensor-parallel on: ``mesh``, or ``None``
    where ``model`` does not divide the heads (:func:`layers.heads_split`:
    the layer's attention then runs whole on every rank)."""
    if mesh is None or L.heads_split(cfg.num_heads, cfg.num_kv_heads, mesh):
        return mesh
    return None


def _whole(cfg, params: Params, mesh, decode: bool = False) -> Params:
    """Layer ``params`` with every subtree outside :data:`TP_SUBTREES`
    (and ``attn`` where :func:`_attn_mesh` runs it whole, but for
    ``decode``, whose attention reads this rank's columns either way)
    gathered whole over the axes its specs cut (no-op without a mesh)."""
    if mesh is None:
        return params
    split = set(TP_SUBTREES)
    if not decode and _attn_mesh(cfg, mesh) is None:
        split.discard("attn")
    specs = param_specs(cfg)["layers"]        # specs [L, ...]: skip the L
    return {name: (sub if name in split else tree_map(
        lambda w, spec: L.gather_whole(w, spec[1:], mesh), sub,
        specs[name])) for name, sub in params.items()}


def init_params(cfg, generator: torch.Generator, *, device=None,
                shardings=None) -> Tuple[Params, Params]:
    """``(params, specs)``: the reference's tree, shapes and ``U(-scale,
    scale)`` scales, float32, layer parameters stacked ``[L, ...]``, drawn
    from ``generator`` (on its device) and placed on ``device`` (``None``:
    the card; ``"meta"``: shapes only).  Layers are drawn one at a time
    into the stacked tensors, so the peak is the model plus one layer.

    ``shardings`` (``train.step.shardings_for``'s tree): each leaf is this
    rank's block of the same draw, cut as it is drawn, so the peak is this
    rank's blocks plus one whole layer."""
    dev = resolve_device(device)
    cut = ((lambda t, sh: sh.shard(t)) if shardings is not None
           else (lambda t, sh: t))
    scale = (3.0 / cfg.d_model) ** 0.5
    params: Params = {
        "embed": L._uniform(generator, (cfg.padded_vocab, cfg.d_model),
                            scale, device=dev),
        "lm_head": L._uniform(generator, (cfg.d_model, cfg.padded_vocab),
                              scale, device=dev),
    }
    specs: Params = {"embed": ("model", "data"), "lm_head": ("data", "model")}
    params["ln_f"], specs["ln_f"] = L.rmsnorm_init(cfg.d_model, device=dev)
    if shardings is not None:
        for name in ("embed", "lm_head", "ln_f"):
            params[name] = tree_map(cut, params[name], shardings[name])

    layer, layer_specs = _layer_init(cfg, generator, dev)
    # each layer's block: the stacked leaf's placement without its L axis
    # (without shardings ``cut`` ignores the tree it is handed)
    per_layer = (tree_map(lambda s: NamedSharding(s.mesh, s.spec[1:]),
                          shardings["layers"]) if shardings is not None
                 else layer)
    stacked = tree_map(lambda p, s: torch.empty(
        (cfg.num_layers, *cut(p, s).shape), dtype=p.dtype, device=p.device),
        layer, per_layer)
    for i in range(cfg.num_layers):
        if i:
            layer, _ = _layer_init(cfg, generator, dev)
        tree_map(lambda dst, src, s: dst[i].copy_(cut(src, s)), stacked,
                 layer, per_layer)
    del layer
    params["layers"] = stacked
    specs["layers"] = tree_map(lambda spec: (None, *spec), layer_specs)

    if cfg.frontend is not None:
        params["frontend_proj"] = cut(L._uniform(
            generator, (cfg.d_model, cfg.d_model), scale, device=dev),
            shardings and shardings["frontend_proj"])
        specs["frontend_proj"] = ("data", "model")
    return params, specs


@functools.lru_cache(maxsize=None)
def param_specs(cfg) -> Params:
    """The partition-spec tree of ``cfg``'s parameters (from the reduced
    structural twin on the ``meta`` device: specs depend only on the
    tree's structure).  Shared between calls: do not modify it."""
    _, specs = init_params(cfg.reduced(), torch.Generator(), device="meta")
    return specs


def cast_params(params: Params, dtype: torch.dtype) -> Params:
    """float32 leaves cast to ``dtype`` (others kept), as the reference's
    serving launcher does once; the input's float32 leaves are dropped from
    ``params`` as they are cast, so the peak is one leaf above the model."""
    out: Params = {}
    for name in list(params):
        value = params.pop(name)
        if isinstance(value, dict):
            out[name] = cast_params(value, dtype)
        else:
            out[name] = (value.to(dtype) if value.dtype == torch.float32
                         else value)
    return out


def param_shapes(cfg) -> Params:
    """The parameter tree on the ``meta`` device (no allocation)."""
    return init_params(cfg, torch.Generator(), device="meta")[0]


def param_count(cfg) -> int:
    return sum(math.prod(p.shape) for _, p in tree_leaves(param_shapes(cfg)))


def active_param_count(cfg) -> int:
    """MoE: routed experts count at top_k/E; everything else fully."""
    total = 0
    for path, leaf in tree_leaves(param_shapes(cfg)):
        n = math.prod(leaf.shape)
        if "/moe/w" in path:  # routed expert tensors [L, E, ...]
            n = n * cfg.top_k // max(cfg.num_experts, 1)
        total += n
    return total


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _attn_kwargs(cfg) -> dict:
    return dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                sliding_window=cfg.sliding_window)


def _moe(cfg, params: Params, h: torch.Tensor):
    return M.moe(params, h, num_experts=cfg.num_experts, top_k=cfg.top_k,
                 num_shared=cfg.num_shared_experts, dispatch=cfg.moe_dispatch,
                 capacity_factor=cfg.capacity_factor,
                 ep_pins=cfg.moe_ep_pins)


def check_moe_mesh(cfg, mesh) -> None:
    """Raise for what the port does not run on ``mesh``: an MoE layer
    whose batch is split (the reference's capacity and load-balance terms
    are over the whole batch; expert parallelism is ROADMAP.md queue 3a)."""
    if cfg.family == "moe" and any(L.axis_size(mesh, a) > 1
                                   for a in L.BATCH):
        raise NotImplementedError(
            f"{cfg.name}: MoE layers over a split batch are not ported "
            f"(capacity and aux loss are over the whole batch; expert "
            f"parallelism is ROADMAP.md queue 3a); use a mesh whose pod and "
            f"data axes have one rank")


def _block(cfg, params: Params, x: torch.Tensor, positions: torch.Tensor,
           with_state: bool = True, mesh=None
           ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """One decoder block over a whole sequence: ``(x, aux_loss, state)``,
    ``state`` holding the roped ``k``/``v`` and the SSM states that
    :func:`prefill` turns into this layer's decode cache (empty without
    ``with_state``, as the reference's ``_block_train``)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    state: Dict[str, torch.Tensor] = {}
    params = _whole(cfg, params, mesh)
    h = L.rmsnorm(params["ln1"], x)
    if cfg.family in ATTENTION_FAMILIES:
        attn = L.attention(
            params["attn"], h, positions, query_chunk=cfg.attn_query_chunk,
            swa_banded=cfg.swa_banded, return_kv=with_state,
            mesh=_attn_mesh(cfg, mesh), **_attn_kwargs(cfg))
        if with_state:
            attn_out, state["k"], state["v"] = attn
        else:
            attn_out = attn
    if cfg.family == "ssm":
        tout = S.rwkv6_block(
            params["tmix"], h, num_heads=cfg.rwkv_num_heads,
            head_dim=cfg.rwkv_head_dim, chunk=cfg.ssm_chunk,
            return_state=with_state)
        if with_state:
            tout, (state["xprev_t"], state["wkv"]) = tout
        x = x + tout
    elif cfg.family == "hybrid":
        mout = S.mamba_block(params["mamba"], h, chunk=cfg.ssm_chunk,
                             return_state=with_state)
        if with_state:
            mout, state["h"] = mout
        x = x + 0.5 * (attn_out + mout)   # parallel heads, mean-fused
    elif cfg.family in ATTENTION_FAMILIES:
        x = x + attn_out
    else:
        raise ValueError(cfg.family)

    h2 = L.rmsnorm(params["ln2"], x)
    if cfg.family == "moe":
        out, aux = _moe(cfg, params["moe"], h2)
        x = x + out
    elif cfg.family == "ssm":
        cout = S.rwkv_cmix(params["cmix"], h2, return_state=with_state)
        if with_state:
            cout, state["xprev_c"] = cout
        x = x + cout
    else:
        x = x + L.mlp(params["mlp"], h2, cfg.activation, mesh)
    return x, aux, state


def _layer(params: Params, i: int) -> Params:
    """Layer ``i``'s tree: a slice of each stacked leaf, or entry ``i`` of
    a list of per-layer trees."""
    layers = params["layers"]
    if isinstance(layers, (list, tuple)):
        return layers[i]
    return tree_map(lambda p: p[i], layers)


def _embed(params: Params, cfg, tokens: torch.Tensor,
           prefix_embeds: Optional[torch.Tensor],
           dtype: torch.dtype, mesh=None) -> torch.Tensor:
    """Token embeddings, with the projected frontend prefix in front.
    ``F.embedding``: its backward sums each id's rows in a fixed order on
    the card, where indexing's scatter-add would add in atomic order.

    On a mesh the table is placed ``(model, data)``: its ``data`` blocks
    are gathered in ``dtype`` (the reference casts before it indexes), each
    rank looks up the ids in its vocabulary rows, zeros the others, and the
    rows are summed over ``model``."""
    proj = params.get("frontend_proj")
    if mesh is None:
        x = F.embedding(tokens.long(), params["embed"]).to(dtype)
    else:
        x = _token_rows(params, tokens, dtype, mesh)
        if proj is not None:
            proj = L.gather_whole(proj, ("data", "model"), mesh)
    if cfg.frontend is not None:
        assert prefix_embeds is not None, f"{cfg.name} needs frontend stub"
        pre = prefix_embeds.to(dtype) @ proj.to(dtype)
        x = torch.cat([pre, x], dim=1)
    return x


def _token_rows(params: Params, tokens: torch.Tensor, dtype: torch.dtype,
                mesh) -> torch.Tensor:
    """The vocab-parallel lookup of :func:`_embed` on a mesh."""
    table = L.gather(params["embed"].to(dtype), mesh, L.FSDP, 1)
    n = table.shape[0]
    ids = tokens.long() - mesh.coord(L.TP) * n
    mine = ((ids >= 0) & (ids < n))[..., None]
    x = torch.where(mine, F.embedding(ids.clamp(0, n - 1), table), 0.0)
    return L.from_tp(x, mesh)


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device)[None].expand(
        b, s)


def _block_train(cfg, params: Params, x: torch.Tensor,
                 positions: torch.Tensor, mesh=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder block for :func:`forward_hidden`: ``(x, aux_loss)``."""
    x, aux, _ = _block(cfg, params, x, positions, with_state=False,
                       mesh=mesh)
    return x, aux


def forward_hidden(params: Params, cfg, tokens: torch.Tensor,
                   prefix_embeds: Optional[torch.Tensor] = None,
                   dtype: torch.dtype = torch.bfloat16, mesh=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backbone forward: ``(final-norm hidden [B,S,D], aux loss)``.  With
    ``cfg.remat`` and autograd recording, each layer runs under
    non-reentrant checkpoint: its activations are recomputed in the
    backward (K7 launches twice a layer; on a mesh the layer's gathers run
    again too)."""
    mesh = sharded(mesh)
    x = _embed(params, cfg, tokens, prefix_embeds, dtype, mesh)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.num_layers):
        body = functools.partial(_block_train, cfg, _layer(params, i),
                                 mesh=mesh)
        if remat:
            x, a = checkpoint(body, x, positions, use_reentrant=False)
        else:
            x, a = body(x, positions)
        aux = aux + a
    return L.rmsnorm(params["ln_f"], x), aux


def forward(params: Params, cfg, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None,
            dtype: torch.dtype = torch.bfloat16
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training/prefill forward. tokens: ``[B, S_tok]``; returns
    ``(logits [B, S, padded_vocab], aux)``."""
    x, aux = forward_hidden(params, cfg, tokens, prefix_embeds, dtype)
    return x @ params["lm_head"].to(dtype), aux


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

def _ce_terms(cfg, head: torch.Tensor, hidden: torch.Tensor,
              labels: torch.Tensor, mesh=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sum NLL, token count)`` for one hidden chunk ``[B, s, D]``; the
    vocabulary's padding columns are masked to -1e30, labels < 0 count
    nothing.

    On a mesh ``head`` is this rank's vocabulary columns (``V / tp``) and
    the cross-entropy is vocab-parallel: the row maxima gathered over
    ``model`` (so a NaN on any rank stays NaN), the sum-exp and the
    label's logit (from the rank that holds it) summed over ``model``."""
    logits = (hidden @ head).float()
    n = logits.shape[-1]
    lo = 0 if mesh is None else mesh.coord(L.TP) * n
    if cfg.padded_vocab != cfg.vocab_size:   # mask vocab padding columns
        pad_mask = torch.arange(lo, lo + n,
                                device=logits.device) < cfg.vocab_size
        logits = torch.where(pad_mask, logits, -1e30)
    mask = (labels >= 0).float()
    if L.axis_size(mesh, L.TP) == 1:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            labels.clamp(min=0).long()[..., None])[..., 0]
        return ((logz - gold) * mask).sum(), mask.sum()
    top = mesh.all_gather(logits.detach().amax(dim=-1)[None], L.TP)
    top = top.amax(dim=0)
    sumexp = L.from_tp(torch.exp(logits - top[..., None]).sum(dim=-1), mesh)
    logz = top + torch.log(sumexp)
    ids = labels.clamp(min=0).long() - lo
    mine = (ids >= 0) & (ids < n)
    gold = torch.gather(logits, -1, ids.clamp(0, n - 1)[..., None])[..., 0]
    gold = L.from_tp(torch.where(mine, gold, 0.0), mesh)
    return ((logz - gold) * mask).sum(), mask.sum()


def lm_loss(params: Params, cfg, batch: Dict[str, torch.Tensor],
            dtype: torch.dtype = torch.bfloat16, mesh=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE (+ 0.01 aux): ``(total, {"loss", "aux",
    "ntokens"})``.  batch: ``tokens [B, S]``, ``labels [B, S]`` (-1 =
    masked), optional ``prefix_embeds [B, Lf, D]``.

    ``cfg.loss_seq_chunk``: when it divides S (and is smaller), the ``[B,
    S, V]`` float32 logits are never materialized: the CE runs one
    sequence chunk at a time under checkpoint, its logits recomputed in
    the backward.

    On ``mesh`` the batch is this rank's rows; the loss (and ``"ntokens"``)
    are the whole batch's: the NLL sum over every batch shard divided by
    the token count over every batch shard, so shards with more masked
    labels weigh no more.  Each rank's gradient is that of its own NLL
    term over the global count."""
    mesh = sharded(mesh)
    check_moe_mesh(cfg, mesh)
    hidden, aux = forward_hidden(params, cfg, batch["tokens"],
                                 batch.get("prefix_embeds"), dtype=dtype,
                                 mesh=mesh)
    if cfg.frontend is not None:   # prefix positions predict nothing
        hidden = hidden[:, cfg.frontend_len:]
    labels = batch["labels"]
    head = L.gather_in(params["lm_head"], dtype, mesh)
    hidden = L.to_tp(hidden, mesh)

    ck = cfg.loss_seq_chunk
    s = hidden.shape[1]
    if ck and s % ck == 0 and s > ck:
        terms = functools.partial(_ce_terms, cfg, mesh=mesh)
        nll_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
        count = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for i in range(0, s, ck):
            h, lab = hidden[:, i:i + ck], labels[:, i:i + ck]
            if torch.is_grad_enabled():
                nll, cnt = checkpoint(terms, head, h, lab,
                                      use_reentrant=False)
            else:
                nll, cnt = terms(head, h, lab)
            nll_sum, count = nll_sum + nll, count + cnt
    else:
        nll_sum, count = _ce_terms(cfg, head, hidden, labels, mesh)

    count = mesh.all_reduce(count, L.BATCH) if mesh is not None else count
    loss = L.psum(nll_sum / torch.clamp(count, min=1.0), mesh, L.BATCH)
    total = loss + 0.01 * aux
    return total, {"loss": loss, "aux": aux, "ntokens": count}


# ---------------------------------------------------------------------------
# prefill: forward + cache emission
# ---------------------------------------------------------------------------

def _emit_kv_cache(k: torch.Tensor, cache_len: int) -> torch.Tensor:
    """Ring-align prefill K (or V) ``[B, S, H, hd]`` into a ``[B,
    cache_len, ...]`` decode cache: position p lives at slot p % cache_len."""
    s = k.shape[1]
    if cache_len >= s:  # identity slots, zero-pad the unwritten tail
        pad = k.new_zeros((k.shape[0], cache_len - s, *k.shape[2:]))
        return torch.cat([k, pad], dim=1)
    tail = k[:, s - cache_len:]          # positions s-cache_len .. s-1
    return torch.roll(tail, s % cache_len, dims=1)


def prefill(params: Params, cfg, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None,
            dtype: torch.dtype = torch.bfloat16,
            cache_len: Optional[int] = None, mesh=None,
            cache_sh: Optional[Dict[str, Any]] = None):
    """Inference prefill: consume the prompt, return ``(last-position
    logits [B, 1, V], stacked decode caches sized for cache_len total
    positions)``.  Only the final position's logits are computed.

    On ``mesh``, as :func:`decode_step`: ``tokens`` (and
    ``prefix_embeds``) are this rank's rows, ``params`` this rank's blocks,
    the blocks run as in :func:`forward_hidden`, and the returned caches
    are this rank's blocks placed by ``cache_sh`` (``{name:
    NamedSharding}`` from ``serve.decode.cache_pspecs``); the logits are
    this rank's rows over the whole padded vocabulary."""
    mesh = sharded(mesh)
    if mesh is not None:
        check_moe_mesh(cfg, mesh)
    x = _embed(params, cfg, tokens, prefix_embeds, dtype, mesh)
    b, s, _ = x.shape
    if cache_len is None:
        cache_len = s
    positions = _positions(b, s, x.device)
    win = min(cache_len, cfg.sliding_window or cache_len)
    # what a block returns whole (attention run whole, the SSM states) is
    # cut to this rank's block over ``model``; the rows are this rank's
    whole = set() if mesh is None else {"wkv", "h", "xprev_t", "xprev_c"}
    if mesh is not None and _attn_mesh(cfg, mesh) is None:
        whole |= {"k", "v"}
    cut = {} if mesh is None else {
        name: NamedSharding(mesh, tuple(a if a == L.TP else None
                                        for a in sh.spec[1:]))
        for name, sh in cache_sh.items() if name in whole}
    caches = []
    for i in range(cfg.num_layers):
        x, _, cache = _block(cfg, _layer(params, i), x, positions,
                             mesh=mesh)
        for name in ("k", "v"):
            if name in cache:
                cache[name] = _emit_kv_cache(cache[name], win)
        layer = {}
        for name, c in cache.items():
            c = cut[name].shard(c) if name in cut else c
            layer[name] = c if c.dtype == torch.float32 else c.to(dtype)
        caches.append(layer)
    cache = tree_map(lambda *cs: torch.stack(cs), *caches)
    del caches
    x = L.rmsnorm(params["ln_f"], x[:, -1:])
    logits = x @ L.gather_in(params["lm_head"], dtype, mesh)
    if mesh is not None:
        logits = mesh.all_gather(logits, L.TP, dim=2)
    return logits, cache


# ---------------------------------------------------------------------------
# decode: cache init + one-token step
# ---------------------------------------------------------------------------

def cache_shape(cfg, batch: int, seq_len: int,
                dtype: torch.dtype = torch.bfloat16
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """``{name: (shape, dtype)}`` of the stacked KV/state cache."""
    hd = cfg.resolved_head_dim
    n = cfg.num_layers
    shapes: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
    if cfg.family in ATTENTION_FAMILIES:
        s_cache = min(seq_len, cfg.sliding_window or seq_len)
        shape = (n, batch, s_cache, cfg.num_kv_heads, hd)
        shapes["k"] = (shape, dtype)
        shapes["v"] = (shape, dtype)
    if cfg.family == "ssm":
        h, k = cfg.rwkv_num_heads, cfg.rwkv_head_dim
        shapes["wkv"] = ((n, batch, h, k, k), torch.float32)
        shapes["xprev_t"] = ((n, batch, 1, cfg.d_model), dtype)
        shapes["xprev_c"] = ((n, batch, 1, cfg.d_model), dtype)
    if cfg.family == "hybrid":
        shapes["h"] = ((n, batch, cfg.num_heads * hd, cfg.ssm_state),
                       torch.float32)
    return shapes


def init_cache(cfg, batch: int, seq_len: int,
               dtype: torch.dtype = torch.bfloat16, *,
               device=None) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {name: torch.zeros(shape, dtype=dt, device=dev)
            for name, (shape, dt) in cache_shape(cfg, batch, seq_len,
                                                 dtype).items()}


def _block_decode(cfg, params: Params, x: torch.Tensor, pos: int,
                  cache: Dict[str, torch.Tensor], mesh=None):
    new_cache: Dict[str, torch.Tensor] = {}
    params = _whole(cfg, params, mesh, decode=True)
    h = L.rmsnorm(params["ln1"], x)
    if cfg.family in ATTENTION_FAMILIES:
        attn_out, new_cache["k"], new_cache["v"] = L.attention_decode(
            params["attn"], h, pos, cache["k"], cache["v"], mesh=mesh,
            **_attn_kwargs(cfg))
    if cfg.family == "ssm":
        tout, (xp, wkv) = S.rwkv6_block(
            params["tmix"], h, num_heads=cfg.rwkv_num_heads,
            head_dim=cfg.rwkv_head_dim, use_chunked=False,
            x_prev=cache["xprev_t"], state=cache["wkv"], return_state=True)
        new_cache["wkv"], new_cache["xprev_t"] = wkv, xp
        x = x + tout
    elif cfg.family == "hybrid":
        mout, new_cache["h"] = S.mamba_block(
            params["mamba"], h, use_chunked=False, state=cache["h"],
            return_state=True)
        x = x + 0.5 * (attn_out + mout)
    else:
        x = x + attn_out

    h2 = L.rmsnorm(params["ln2"], x)
    if cfg.family == "moe":
        out, _ = _moe(cfg, params["moe"], h2)
        x = x + out
    elif cfg.family == "ssm":
        cout, new_cache["xprev_c"] = S.rwkv_cmix(
            params["cmix"], h2, x_prev=cache["xprev_c"], return_state=True)
        x = x + cout
    else:
        x = x + L.mlp(params["mlp"], h2, cfg.activation, mesh)
    return x, new_cache


def decode_step(params: Params, cfg, tokens: torch.Tensor, pos: int,
                cache: Dict[str, torch.Tensor],
                dtype: torch.dtype = torch.bfloat16, mesh=None,
                cache_sh: Optional[Dict[str, Any]] = None):
    """One-token decode. tokens: ``[B, 1]``; pos: an int (batch-synced).
    Updates ``cache`` (stacked ``[L, ...]``) in place and returns
    ``(logits [B, 1, V], cache)``.

    On ``mesh``: ``tokens`` are this rank's rows, ``cache`` this rank's
    blocks placed by ``cache_sh`` (``{name: NamedSharding}``, from
    ``serve.decode.cache_pspecs``), and the logits are this rank's rows
    over the whole padded vocabulary.  The SSM states (``wkv``, ``h``)
    are gathered whole over ``model`` for their layer's step and cut back
    after it; the KV caches stay this rank's (see
    :func:`layers.attention_decode`)."""
    mesh = sharded(mesh)
    trivial = mesh is None
    if trivial:
        x = params["embed"][tokens.long()].to(dtype)
    else:
        x = _token_rows(params, tokens, dtype, mesh)
    states = {} if trivial else {
        name: NamedSharding(mesh, tuple(a if a == L.TP else None
                                        for a in sh.spec[1:]))
        for name, sh in cache_sh.items() if name not in ("k", "v")}
    for i in range(cfg.num_layers):
        layer_cache = {name: c[i] for name, c in cache.items()}
        work = {name: states[name].gather(c) if name in states else c
                for name, c in layer_cache.items()}
        x, new = _block_decode(cfg, _layer(params, i), x, int(pos), work,
                               mesh)
        for name, value in new.items():
            if name in states:
                value = states[name].shard(value)
            if value is not layer_cache[name]:
                layer_cache[name].copy_(value)
    x = L.rmsnorm(params["ln_f"], x)
    logits = x @ L.gather_in(params["lm_head"], dtype, mesh)
    if not trivial:
        logits = mesh.all_gather(logits, L.TP, dim=2)
    return logits, cache


# ---------------------------------------------------------------------------
# the model as a module
# ---------------------------------------------------------------------------

class _ParamTree(torch.nn.Module):
    """A nested parameter dict as a module tree; its parameters require
    grad (the banded attention's K7 kernels have a backward)."""

    def __init__(self, tree: Params):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, _ParamTree(value))
            else:
                self.register_parameter(name, torch.nn.Parameter(value))

    def tree(self) -> Params:
        out: Params = dict(self.named_parameters(recurse=False))
        out.update((name, child.tree())
                   for name, child in self.named_children())
        return out


class DecoderLM(torch.nn.Module):
    """A decoder LM holding its weights; its methods call :func:`forward`
    (differentiable in the weights), :func:`prefill` and
    :func:`decode_step` (both under ``torch.no_grad``) on them.  Build with
    :meth:`from_config` (weights drawn from a generator) or from a
    parameter tree (e.g. ``interop.lm_params_from_arrays``)."""

    def __init__(self, cfg, params: Params):
        super().__init__()
        self.cfg = cfg
        self.weights = _ParamTree(params)

    @classmethod
    def from_config(cls, cfg, generator: torch.Generator, *, device=None,
                    dtype: Optional[torch.dtype] = None) -> "DecoderLM":
        """Weights from :func:`init_params`, cast once to ``dtype`` when
        given (float32 leaves only)."""
        params, _ = init_params(cfg, generator, device=device)
        if dtype is not None:
            params = cast_params(params, dtype)
        return cls(cfg, params)

    def params(self) -> Params:
        return self.weights.tree()

    def forward(self, tokens: torch.Tensor,
                prefix_embeds: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.bfloat16):
        return forward(self.params(), self.cfg, tokens, prefix_embeds, dtype)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor,
                prefix_embeds: Optional[torch.Tensor] = None,
                dtype: torch.dtype = torch.bfloat16,
                cache_len: Optional[int] = None):
        return prefill(self.params(), self.cfg, tokens, prefix_embeds, dtype,
                       cache_len)

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, pos: int,
                    cache: Dict[str, torch.Tensor],
                    dtype: torch.dtype = torch.bfloat16):
        return decode_step(self.params(), self.cfg, tokens, pos, cache, dtype)

    def init_cache(self, batch: int, seq_len: int,
                   dtype: torch.dtype = torch.bfloat16):
        device = self.weights.tree()["embed"].device
        return init_cache(self.cfg, batch, seq_len, dtype, device=device)
