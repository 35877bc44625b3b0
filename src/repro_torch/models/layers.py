"""Transformer building blocks: norms, RoPE, GQA attention, MLP variants.

Pure-function style, as the reference's ``models/layers.py``: parameters
are nested dicts of tensors, every block is ``apply(params, x, ...) -> y``,
and initialisers return ``(params, specs)`` where ``specs`` names each
weight's sharding axes as a plain tuple.  Weights are drawn from an
explicit ``torch.Generator``; the tests carry the reference's weights in
through :mod:`repro_torch.interop` instead.

On an :class:`~repro_torch.launch.mesh.LMMesh` (``mesh=``) each rank holds
its block of every weight, as ``specs`` place it, and the blocks run what
GSPMD derives from the reference's pins:

* **FSDP over ``data``**: :func:`gather_in`/:func:`gather_out` all-gather a
  weight's ``data`` blocks right before its matmul (in the activations'
  dtype); the gradient of the gathered weight is summed over ``data`` and
  cut back to this rank's block (a reduce-scatter);
* **tensor parallelism over ``model``**: :func:`attention` runs this rank's
  block of query heads (:func:`head_block`: ``ceil(H / tp)`` a rank, as
  GSPMD pads the heads, the even split where ``model`` divides them) and
  the KV heads they read (Q/K/V column-parallel, ``wo`` row-parallel),
  :func:`mlp` its ``d_ff / tp`` columns; the input passes through
  :func:`to_tp` (identity, gradient summed over ``model``) and the
  row-parallel output through :func:`from_tp` (summed over ``model``,
  gradient passed through): Megatron's f/g pair.  A weight whose stored
  block is not the rank's heads (KV heads that ``model`` does not divide,
  query heads that it does not divide) is gathered whole over ``model``
  and narrowed to them (:func:`tp_cols`, :func:`tp_rows`), its gradient
  summed over ``model`` and cut back to the stored block.  The SSM blocks
  of :mod:`~repro_torch.models.ssm` split the same way over their heads
  and channels.

With ``mesh=None``, or a mesh whose axes are all of size 1, none of this
runs: no collective and no copy.  :func:`maybe_constrain` stays the
identity (the placements above are explicit), and its call sites keep
their specs.  The banded branch of :func:`attention` runs the K7 kernel
(:func:`repro_torch.kernels.flash_swa.ops.flash_swa_gqa`) on the rank's own
heads, where the reference computes the same band in jnp.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_swa.ops import flash_swa_gqa

Params = Dict[str, Any]

# Sharding axis names (the reference's mesh): "data" = FSDP axis, "model" =
# tensor-parallel axis, "pod" only shards the batch.
FSDP = "data"
TP = "model"
BATCH = ("pod", "data")


def maybe_constrain(x: torch.Tensor, *spec) -> torch.Tensor:
    """The reference pins ``x`` to the ambient mesh; the port places its
    tensors explicitly (see the module's docstring), so this is the
    identity (``spec`` is kept for the call sites)."""
    del spec
    return x


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis`` on ``mesh`` (1 without a mesh)."""
    return 1 if mesh is None else mesh.axis_size(axis)


class _Gather(torch.autograd.Function):
    """All-gather over ``axis`` along ``dim``.  Backward: on a batch axis
    (``pod``/``data``: the ranks' gradients differ), or with ``summed``
    (a weight gathered whole over ``model`` of which each rank reads its
    own part), the sum over the axis, this rank's block of it (a
    reduce-scatter); otherwise, on ``model`` (the ranks compute the same
    thing), this rank's block alone."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim, summed):
        ctx.mesh, ctx.axis, ctx.dim, ctx.summed = mesh, axis, dim, summed
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.mesh, ctx.axis, ctx.dim
        if axis in BATCH or ctx.summed:
            return mesh.reduce_scatter(g, axis, dim), None, None, None, None
        n = g.shape[dim] // mesh.axis_size(axis)
        return g.narrow(dim, mesh.coord(axis) * n, n), None, None, None, None


def gather(x: torch.Tensor, mesh, axis: str, dim: int,
           summed: bool = False) -> torch.Tensor:
    """:class:`_Gather` where ``axis`` has more than one rank, else ``x``."""
    if axis_size(mesh, axis) == 1:
        return x
    return _Gather.apply(x, mesh, axis, dim, summed)


class _ToTP(torch.autograd.Function):
    """Megatron's f: identity; the gradient summed over ``model``."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, TP), None


class _Sum(torch.autograd.Function):
    """The sum over ``axes``; the gradient passed through (Megatron's g
    over ``model``).  Right where what follows is the same on every rank
    of ``axes``, so each rank needs only its own term's gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh.all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """:class:`_Sum` over the axes of ``axes`` that have more than one
    rank; ``x`` where there are none."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    axes = tuple(a for a in axes if axis_size(mesh, a) > 1)
    return _Sum.apply(x, mesh, axes) if axes else x


def to_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """The input of column-parallel matmuls (f)."""
    return x if axis_size(mesh, TP) == 1 else _ToTP.apply(x, mesh)


def from_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of row-parallel partial outputs (g)."""
    return psum(x, mesh, TP)


def gather_whole(w: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """``w``'s blocks gathered over every axis ``spec`` cuts it on: the
    whole weight, for code that runs it whole on every rank."""
    for i, axes in enumerate(spec):
        for a in reversed((axes,) if isinstance(axes, str) else axes or ()):
            w = gather(w, mesh, a, i)
    return w


def heads_split(num_heads: int, num_kv_heads: int, mesh) -> bool:
    """Whether ``model`` divides both head counts: each rank's stored
    blocks of ``wq``/``wk``/``wv``/``wo`` are then its own heads, and the
    KV cache is cut over the KV heads (``serve.decode.cache_pspecs``)."""
    tp = axis_size(mesh, TP)
    return num_heads % tp == 0 and num_kv_heads % tp == 0


def head_block(num_heads: int, mesh) -> Tuple[int, int]:
    """This rank's heads ``[start, stop)`` of ``num_heads`` split over
    ``model``: blocks of ``c = ceil(H / tp)`` in rank order, GSPMD's
    padding of ``H`` to ``c tp`` heads without computing the padded ones
    (25 heads on 4: 7, 7, 7, 4; on 16: twelve ranks of 2, one of 1, three
    of none).  Where ``model`` divides ``H`` it is the even split."""
    tp = axis_size(mesh, TP)
    if tp == 1:
        return 0, num_heads
    c = -(-num_heads // tp)
    rank = mesh.coord(TP)
    return min(num_heads, rank * c), min(num_heads, (rank + 1) * c)


@dataclasses.dataclass(frozen=True)
class HeadBlock:
    """Attention's heads on this rank: query heads ``[q0, q1)``
    (:func:`head_block`) and the KV heads ``[k0, k1)`` they read (query
    head ``h`` reads KV head ``h // (H / Hkv)``).  ``q_stored`` / ``kv_stored``:
    whether ``model`` divides the query / KV heads, so that the stored
    blocks of ``wq``, ``bq``, ``wo`` / ``wk``, ``wv``, ``bk``, ``bv`` are
    exactly these heads (else they are gathered whole over ``model`` and
    narrowed).  ``counts``: how many of the block's query heads each of
    its KV heads serves, in order."""

    q0: int
    q1: int
    k0: int
    k1: int
    q_stored: bool
    kv_stored: bool
    counts: Tuple[int, ...]

    @property
    def groups(self) -> Optional[int]:
        """The local GQA group where every KV head serves as many query
        heads (1 without heads), else ``None``: K/V are then repeated to
        one head per query head (:func:`_per_query`)."""
        if not self.counts:
            return 1
        return self.counts[0] if len(set(self.counts)) == 1 else None


def attn_block(num_heads: int, num_kv_heads: int, mesh) -> HeadBlock:
    """:class:`HeadBlock` of this rank of ``mesh``."""
    q0, q1 = head_block(num_heads, mesh)
    group = num_heads // num_kv_heads
    k0, k1 = q0 // group, -(-q1 // group)
    counts = tuple(min(q1, (j + 1) * group) - max(q0, j * group)
                   for j in range(k0, k1))
    tp = axis_size(mesh, TP)
    return HeadBlock(q0, q1, k0, k1, num_heads % tp == 0,
                     num_kv_heads % tp == 0, counts)


def local_heads(num_heads: int, num_kv_heads: int, mesh) -> Tuple[int, int]:
    """This rank's query head count and that of the KV heads they read
    (``H / tp`` and ``Hkv / tp`` where ``model`` divides both)."""
    blk = attn_block(num_heads, num_kv_heads, mesh)
    return blk.q1 - blk.q0, blk.k1 - blk.k0


def tp_cols(w: torch.Tensor, dtype: torch.dtype, mesh, lo: int, hi: int,
            stored: bool) -> torch.Tensor:
    """Columns ``lo:hi`` of the whole ``w`` in ``dtype``, ``w`` an ``[in,
    out]`` matrix placed ``(FSDP, TP)`` or a vector placed ``(TP,)``:
    where ``stored`` they are this rank's block (gathered over ``data``
    only, :func:`gather_in`); else ``w`` is gathered whole over ``model``,
    its gradient summed over ``model`` and cut back to this rank's block,
    and narrowed."""
    if w.dim() == 1:
        if stored:
            return w.to(dtype)
        return gather(w.to(dtype), mesh, TP, 0, summed=True)[lo:hi]
    if stored:
        return gather_in(w, dtype, mesh)
    return gather(gather_in(w, dtype, mesh), mesh, TP, 1,
                  summed=True)[:, lo:hi]


def tp_rows(w: torch.Tensor, dtype: torch.dtype, mesh, lo: int, hi: int,
            stored: bool) -> torch.Tensor:
    """Rows ``lo:hi`` of the whole ``w`` placed ``(TP, FSDP)``, as
    :func:`tp_cols` takes columns."""
    if stored:
        return gather_out(w, dtype, mesh)
    return gather(gather_out(w, dtype, mesh), mesh, TP, 0,
                  summed=True)[lo:hi]


def _uniform(generator: torch.Generator, shape: Tuple[int, ...],
             scale: float, dtype: torch.dtype = torch.float32,
             device=None) -> torch.Tensor:
    """U(-scale, scale) drawn from ``generator`` (on its device), then moved
    to ``device`` (``None``: where the generator is).  On the ``meta``
    device nothing is drawn (shapes only, for parameter counts)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    u = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device)
    u = u * (2.0 * scale) - scale
    return u if device is None else u.to(device)


def gather_in(w: torch.Tensor, dtype: torch.dtype,
              mesh=None) -> torch.Tensor:
    """ZeRO-3 gather-at-use of an ``[in, out]`` matrix placed ``(FSDP,
    TP)``: in the activations' dtype, its ``data`` blocks all-gathered
    right before the matmul (the reference pins ``(None, TP)`` there)."""
    return maybe_constrain(gather(w.to(dtype), mesh, FSDP, 0), None, TP)


def gather_out(w: torch.Tensor, dtype: torch.dtype,
               mesh=None) -> torch.Tensor:
    """Same for ``[in, out]`` matrices placed ``(TP, FSDP)``."""
    return maybe_constrain(gather(w.to(dtype), mesh, FSDP, 1), TP, None)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, *, device=None):
    return ({"scale": torch.ones((d,), dtype=torch.float32, device=device)},
            {"scale": (None,)})


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * params["scale"]
    return out.to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: ``[B, S, H, hd]``; positions: ``[B, S]`` (int).  Rotates the
    first half of the head dimension against the second (not interleaved
    pairs), as the reference does."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)           # [hd/2]
    angles = positions[..., None].float() * freqs            # [B,S,hd/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention (full / sliding-window, optional QKV bias, KV cache decode)
# ---------------------------------------------------------------------------

def attention_init(generator: torch.Generator, d_model: int, num_heads: int,
                   num_kv_heads: int, head_dim: int, qkv_bias: bool, *,
                   device=None):
    scale = (3.0 / d_model) ** 0.5
    draw = lambda shape: _uniform(generator, shape, scale, device=device)
    params = {
        "wq": draw((d_model, num_heads * head_dim)),
        "wk": draw((d_model, num_kv_heads * head_dim)),
        "wv": draw((d_model, num_kv_heads * head_dim)),
        "wo": draw((num_heads * head_dim, d_model)),
    }
    specs = {"wq": (FSDP, TP), "wk": (FSDP, TP), "wv": (FSDP, TP),
             "wo": (TP, FSDP)}
    if qkv_bias:
        dev = params["wq"].device
        for name, width in (("bq", num_heads), ("bk", num_kv_heads),
                            ("bv", num_kv_heads)):
            params[name] = torch.zeros((width * head_dim,),
                                       dtype=torch.float32, device=dev)
            specs[name] = (TP,)
    return params, specs


def _proj(params: Params, x: torch.Tensor, mesh=None):
    """``x`` through ``wq``/``wk``/``wv`` (and their biases), this rank's
    columns: ``[B, S, width / tp]`` each."""
    q = x @ gather_in(params["wq"], x.dtype, mesh)
    k = x @ gather_in(params["wk"], x.dtype, mesh)
    v = x @ gather_in(params["wv"], x.dtype, mesh)
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    return q, k, v


def _qkv_block(params: Params, x: torch.Tensor, blk: HeadBlock,
               num_kv_heads: int, head_dim: int, all_kv: bool, mesh):
    """Q of the block's query heads ``[B, S, q1 - q0, hd]`` and K/V of the
    KV heads they read, or of every KV head with ``all_kv`` where the
    stored blocks are not the block's (prefill's cache needs them all)."""
    b, s, _ = x.shape
    hd = head_dim
    kv_lo, kv_hi = ((0, num_kv_heads) if all_kv and not blk.kv_stored
                    else (blk.k0, blk.k1))
    cols = {"q": (blk.q0 * hd, blk.q1 * hd, blk.q_stored),
            "k": (kv_lo * hd, kv_hi * hd, blk.kv_stored),
            "v": (kv_lo * hd, kv_hi * hd, blk.kv_stored)}
    out = [x @ tp_cols(params[f"w{n}"], x.dtype, mesh, *cols[n])
           for n in "qkv"]
    if "bq" in params:
        out = [t + tp_cols(params[f"b{n}"], x.dtype, mesh, *cols[n])
               for t, n in zip(out, "qkv")]
    return tuple(t.reshape(b, s, t.shape[-1] // hd, hd) for t in out)


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    return k if groups == 1 else k.repeat_interleave(groups, dim=2)


def _per_query(k: torch.Tensor, blk: HeadBlock) -> torch.Tensor:
    """``k`` ``[B, S, k1 - k0, hd]`` with one head per query head of the
    block, as the reference repeats it: each KV head copied as many times
    as it serves query heads (expanded copies, whose backward sums them
    in order)."""
    if blk.groups is not None:
        return _repeat_kv(k, blk.groups)
    b, s, _, hd = k.shape
    return torch.cat([k[:, :, j:j + 1].expand(b, s, n, hd)
                      for j, n in enumerate(blk.counts)], dim=2)


_NEG = -1e30


def _attend(q, k, v, qpos, kpos, scale, sliding_window):
    """Masked softmax attention core. q: ``[B,Sq,H,hd]``, k/v:
    ``[B,Sk,H,hd]``; materialises the ``[B, H, Sq, Sk]`` scores."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    i = qpos[:, None, :, None]
    j = kpos[:, None, None, :]
    mask = j <= i
    if sliding_window is not None:
        mask = mask & (j > i - sliding_window)
    logits = torch.where(mask, logits, _NEG)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention(params: Params, x: torch.Tensor, positions: torch.Tensor, *,
              num_heads: int, num_kv_heads: int, head_dim: int,
              rope_theta: float, sliding_window: Optional[int] = None,
              query_chunk: Optional[int] = None, swa_banded: bool = False,
              return_kv: bool = False, mesh=None,
              unroll_chunks: bool = False):
    """Training/prefill causal self-attention. x: ``[B, S, D]``.

    Three branches, on the reference's conditions:

    * full: one ``[B, H, S, S]`` score block (``query_chunk`` unset or
      ``S <= query_chunk``);
    * query-chunked: one ``[B, H, qc, S]`` block at a time;
    * banded (``swa_banded`` and ``sliding_window`` and ``query_chunk``,
      ``S > query_chunk + sliding_window``): each query chunk against its
      window band only — the K7 kernel
      (``flash_swa_gqa(q, k, v, window=sliding_window, qc=query_chunk)``),
      which assumes positions 0..S-1, as ``forward`` and ``prefill`` pass.

    ``return_kv`` also returns the roped ``(k, v)`` (``[B, S, Hkv, hd]``)
    for prefill cache emission.

    On ``mesh`` every branch runs this rank's :class:`HeadBlock`
    (``num_heads`` and ``num_kv_heads`` are the model's): its query heads
    against the KV heads they read, K7 on the local GQA group where it is
    uniform, else on K/V repeated to one head per query head, as the
    reference repeats them.  A rank without heads runs the same operations
    on empty tensors and launches no kernel.  The block's output times
    ``wo``'s rows of its heads is this rank's partial sum, summed over
    ``model``.  ``return_kv`` returns this rank's KV heads where ``model``
    divides them, else every KV head (the sequence-split cache keeps its
    ring slots of all of them).

    ``unroll_chunks`` is there for name parity with the reference only,
    where it switches between a ``lax.scan`` over the query chunks and an
    unrolled loop (for its cost analysis).  No code of the port passes it,
    and it changes nothing: the port's chunk loop is a Python loop, always
    unrolled.
    """
    del unroll_chunks
    b, s, _ = x.shape
    blk = attn_block(num_heads, num_kv_heads, mesh)
    x = to_tp(x, mesh)
    q, k, v = _qkv_block(params, x, blk, num_kv_heads, head_dim, return_kv,
                         mesh)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    cache_kv = (k, v)
    if k.shape[2] != blk.k1 - blk.k0:       # every KV head: keep the block's
        k, v = k[:, :, blk.k0:blk.k1], v[:, :, blk.k0:blk.k1]
    scale = head_dim ** -0.5

    banded = (swa_banded and sliding_window is not None
              and query_chunk is not None
              and s > query_chunk + sliding_window)
    if banded:
        if blk.groups is None:
            k, v = _per_query(k, blk), _per_query(v, blk)
        out = flash_swa_gqa(q, k, v, window=sliding_window, qc=query_chunk)
    else:
        kk = _per_query(k, blk)
        vv = _per_query(v, blk)
        if query_chunk is None or s <= query_chunk:
            out = _attend(q, kk, vv, positions, positions, scale,
                          sliding_window)
        else:
            assert s % query_chunk == 0, (s, query_chunk)
            out = torch.cat([
                _attend(q[:, i:i + query_chunk], kk, vv,
                        positions[:, i:i + query_chunk], positions, scale,
                        sliding_window)
                for i in range(0, s, query_chunk)], dim=1)

    lo, hi = blk.q0 * head_dim, blk.q1 * head_dim
    wo = tp_rows(params["wo"], x.dtype, mesh, lo, hi, blk.q_stored)
    out = from_tp(out.reshape(b, s, hi - lo) @ wo, mesh)
    if return_kv:
        return (out, *cache_kv)
    return out


def attention_decode(params: Params, x: torch.Tensor, pos: int,
                     cache_k: torch.Tensor, cache_v: torch.Tensor, *,
                     num_heads: int, num_kv_heads: int, head_dim: int,
                     rope_theta: float, sliding_window: Optional[int] = None,
                     mesh=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode step with a static-length KV cache.

    x: ``[B, 1, D]``; pos: the current position (an int, the same for the
    batch); cache_k/v: ``[B, S_cache, Hkv, hd]``, a ring buffer indexed by
    ``pos % S_cache`` (for SWA the caller sizes it ``min(S, window)``).
    Writes this position's k/v into the caches **in place** (the reference
    returns new arrays) and returns ``(out [B, 1, D], cache_k, cache_v)``.

    On ``mesh`` the caches are this rank's block, placed as
    ``serve.decode.cache_pspecs`` says: this rank's ``Hkv / tp`` KV heads
    when ``model`` divides them (the heads run as in :func:`attention`), or
    else this rank's ``S_cache / tp`` ring slots of every head, which
    :func:`_decode_seq_split` attends to with the flash-decode combine.
    """
    if axis_size(mesh, TP) > 1 and num_kv_heads % axis_size(mesh, TP):
        return _decode_seq_split(params, x, pos, cache_k, cache_v,
                                 num_heads=num_heads,
                                 num_kv_heads=num_kv_heads,
                                 head_dim=head_dim, rope_theta=rope_theta,
                                 mesh=mesh)
    b = x.shape[0]
    s_cache = cache_k.shape[1]
    pos = int(pos)
    blk = attn_block(num_heads, num_kv_heads, mesh)
    q, k, v = _qkv_block(params, x, blk, num_kv_heads, head_dim, False, mesh)
    num_heads, num_kv_heads = q.shape[2], k.shape[2]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)

    slot = pos % s_cache
    cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v[:, 0].to(cache_v.dtype)

    groups = num_heads // num_kv_heads
    kk = _repeat_kv(cache_k.to(x.dtype), groups)          # [B, Sc, H, hd]
    vv = _repeat_kv(cache_v.to(x.dtype), groups)
    scale = head_dim ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kk).float() * scale
    logits = torch.where(_written(pos, s_cache, 0, s_cache, x.device),
                         logits, _NEG)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vv)
    out = from_tp(out.reshape(b, 1, num_heads * head_dim) @ gather_out(
        params["wo"], x.dtype, mesh), mesh)
    return out, cache_k, cache_v


def _written(pos: int, s_cache: int, first: int, n: int,
             device) -> torch.Tensor:
    """``[1, 1, 1, n]``: whether ring slots ``first .. first + n - 1`` of
    ``s_cache`` hold a position yet.  Slot j holds absolute position
    ``pos - ((pos - j) mod s_cache)``: valid once written (>= 0); with SWA
    the cache is at most the window."""
    jslots = torch.arange(first, first + n, device=device)
    abs_pos = pos - torch.remainder(pos - jslots + s_cache, s_cache)
    return (abs_pos >= 0)[None, None, None, :]


def _decode_seq_split(params: Params, x: torch.Tensor, pos: int,
                      cache_k: torch.Tensor, cache_v: torch.Tensor, *,
                      num_heads: int, num_kv_heads: int, head_dim: int,
                      rope_theta: float, mesh):
    """:func:`attention_decode` when ``model`` does not divide the KV heads
    (GLM-4-9B's 2 on a wider axis): the caches hold this rank's ring slots
    of every head.  The token's Q/K/V columns are gathered over ``model``
    (every head), K/V land in the rank that holds slot ``pos % S_cache``,
    and each rank attends every query head to its slots.  The flash-decode
    combine joins them: the global max (the ranks' maxima gathered, so a
    NaN on any rank stays), then the rescaled sum-exp and weighted values
    summed over ``model``.  After it every rank holds every head's output
    ``[B, 1, N = H hd]``: rank ``r`` projects its columns ``[r N / tp, (r
    + 1) N / tp)`` with its stored rows of ``wo`` (gathered over ``data``
    only, whatever the head count) and the partials are summed over
    ``model``, so no weight is gathered over ``model``."""
    b = x.shape[0]
    pos = int(pos)
    tp, rank = mesh.axis_size(TP), mesh.coord(TP)
    n_loc = cache_k.shape[1]
    s_cache = n_loc * tp
    q, k, v = (mesh.all_gather(t, TP, dim=2) for t in _proj(params, x, mesh))
    q = q.reshape(b, 1, num_heads, head_dim)
    k = k.reshape(b, 1, num_kv_heads, head_dim)
    v = v.reshape(b, 1, num_kv_heads, head_dim)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)

    slot = pos % s_cache
    if slot // n_loc == rank:
        cache_k[:, slot - rank * n_loc] = k[:, 0].to(cache_k.dtype)
        cache_v[:, slot - rank * n_loc] = v[:, 0].to(cache_v.dtype)

    groups = num_heads // num_kv_heads
    kk = _repeat_kv(cache_k.to(x.dtype), groups)        # [B, n_loc, H, hd]
    vv = _repeat_kv(cache_v.to(x.dtype), groups)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kk).float() * (
        head_dim ** -0.5)
    logits = torch.where(_written(pos, s_cache, rank * n_loc, n_loc,
                                  x.device), logits, _NEG)
    top = mesh.all_gather(logits.amax(dim=-1, keepdim=True)[None], TP)
    p = torch.exp(logits - top.amax(dim=0))                  # [B, H, 1, n]
    part = torch.cat([torch.einsum("bhqk,bkhd->bhqd", p, vv.float()),
                      p.sum(dim=-1, keepdim=True)], dim=-1)
    part = mesh.all_reduce(part, TP)
    out = (part[..., :head_dim] / part[..., head_dim:]).to(x.dtype)
    cols = num_heads * head_dim // tp
    out = out.transpose(1, 2).reshape(b, 1, num_heads * head_dim)
    out = out[..., rank * cols:(rank + 1) * cols].contiguous()
    out = from_tp(out @ gather_out(params["wo"], x.dtype, mesh), mesh)
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------

def mlp_init(generator: torch.Generator, d_model: int, d_ff: int,
             activation: str, *, device=None):
    scale = (3.0 / d_model) ** 0.5
    fscale = (3.0 / d_ff) ** 0.5
    draw = lambda shape, sc: _uniform(generator, shape, sc, device=device)
    params = {"w1": draw((d_model, d_ff), scale)}
    specs = {"w1": (FSDP, TP)}
    if activation == "silu_glu":
        params["w3"] = draw((d_model, d_ff), scale)
        specs["w3"] = (FSDP, TP)
    params["w2"] = draw((d_ff, d_model), fscale)
    specs["w2"] = (TP, FSDP)
    return params, specs


def mlp(params: Params, x: torch.Tensor, activation: str,
        mesh=None) -> torch.Tensor:
    """The MLP; on ``mesh`` this rank's ``d_ff / tp`` columns, the output
    summed over ``model``."""
    x = to_tp(x, mesh)
    w1 = gather_in(params["w1"], x.dtype, mesh)
    if activation == "silu_glu":
        h = F.silu(x @ w1) * (x @ gather_in(params["w3"], x.dtype, mesh))
    elif activation == "sq_relu":
        h = torch.square(F.relu(x @ w1))
    elif activation == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ w1, approximate="tanh")
    else:
        raise ValueError(activation)
    return from_tp(h @ gather_out(params["w2"], x.dtype, mesh), mesh)
