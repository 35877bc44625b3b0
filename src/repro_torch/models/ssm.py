"""Attention-free sequence mixers: RWKV6 ("Finch") and a Mamba-lite SSM.

Both are diagonal-decay linear recurrences over an outer-product state
``S_t = diag(w_t) S_{t-1} + k_t (x) v_t``; RWKV6's decay ``w_t`` is
data-dependent and its readout uses a per-channel bonus ``u``; Mamba reads
out on the state side.  As in the reference, each recurrence has a plain
sequential scan (``*_scan``, the oracle and the decode path) and a chunked
3-pass form (``*_chunked``): (A) per-chunk local state contributions with
decay ratios <= 1, (B) a scan over the ``S/C`` chunk states, (C) per-chunk
readout scans of length ``C`` over all chunks at once.  No kernel is
involved: the scans are Python loops over batched tensor ops.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (FSDP, TP, _uniform, gather_in,
                                       gather_out)

Params = Dict[str, Any]


def _chunk_len(s: int, chunk: int) -> int:
    """The reference's chunk fallback: the largest divisor of ``s`` not
    above ``chunk`` (1 when ``s < chunk``)."""
    if s % chunk == 0:
        return chunk
    return 1 if s < chunk else next(c for c in range(chunk, 0, -1)
                                    if s % c == 0)


# ---------------------------------------------------------------------------
# Core recurrences: oracle scan + chunked 3-pass
# ---------------------------------------------------------------------------

def wkv_scan(r, k, v, logw, u, s0=None):
    """Oracle RWKV6 recurrence.

    r, k, logw: ``[B,S,H,K]``; v: ``[B,S,H,V]``; u: ``[H,K]``.
    ``out_t = r_t . (S_{t-1} + diag(u) k_t (x) v_t)``;
    ``S_t = diag(w_t) S_{t-1} + k_t (x) v_t``.
    Returns ``(out [B,S,H,V], S_final [B,H,K,V])``.
    """
    b, s, h, kk = k.shape
    vv = v.shape[-1]
    S = (torch.zeros((b, h, kk, vv), dtype=torch.float32, device=k.device)
         if s0 is None else s0.float())
    r, k, v, logw = r.float(), k.float(), v.float(), logw.float()
    outs = []
    for t in range(s):
        kv = torch.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                                 S + u[None, :, :, None] * kv))
        S = torch.exp(logw[:, t])[..., None] * S + kv
    out = (torch.stack(outs, dim=1) if outs
           else torch.zeros((b, 0, h, vv), device=k.device))
    return out, S


def wkv_chunked(r, k, v, logw, u, s0=None, *, chunk: int = 64):
    """Chunked 3-pass RWKV6 recurrence; equals :func:`wkv_scan`."""
    b, s, h, kk = k.shape
    vv = v.shape[-1]
    if s0 is None:
        s0 = torch.zeros((b, h, kk, vv), dtype=torch.float32,
                         device=k.device)
    chunk = _chunk_len(s, chunk)
    nc = s // chunk
    rc = r.reshape(b, nc, chunk, h, kk).float()
    kc = k.reshape(b, nc, chunk, h, kk).float()
    vc = v.reshape(b, nc, chunk, h, vv).float()
    lw = logw.reshape(b, nc, chunk, h, kk).float()

    # pass A: per-chunk totals (parallel over chunks)
    lw_cum = torch.cumsum(lw, dim=2)                   # logW_{1..t}
    lw_tot = lw_cum[:, :, -1:]                         # logW_{1..C}
    decay_after = torch.exp(lw_tot - lw_cum)           # prod_{u>s} w_u <= 1
    contrib = torch.einsum("bnchk,bnchv->bnhkv", kc * decay_after, vc)
    w_total = torch.exp(lw_tot[:, :, 0])               # [B,NC,H,K]

    # pass B: chunk-start states
    S = s0.float()
    starts = []
    for n in range(nc):
        starts.append(S)
        S = w_total[:, n][..., None] * S + contrib[:, n]
    S = torch.stack(starts, dim=1)                     # [B,NC,H,K,V]

    # pass C: per-chunk readout, all chunks at once
    outs = []
    for t in range(chunk):
        kv = torch.einsum("bnhk,bnhv->bnhkv", kc[:, :, t], vc[:, :, t])
        outs.append(torch.einsum("bnhk,bnhkv->bnhv", rc[:, :, t],
                                 S + u[None, None, :, :, None] * kv))
        S = torch.exp(lw[:, :, t])[..., None] * S + kv
    out = torch.stack(outs, dim=2).reshape(b, s, h, vv)
    return out, S[:, -1]


def ssm_scan(a, bx, c, h0=None):
    """Oracle Mamba-style recurrence.

    a (decay, in (0, 1]): ``[B,S,D,N]``; bx (input): ``[B,S,D,N]``;
    c: ``[B,S,N]``.  ``h_t = a_t * h_{t-1} + bx_t``;
    ``y_t = sum_n h_t[d, n] c_t[n]``.  Returns ``(y [B,S,D], h [B,D,N])``.
    """
    b, s, d, n = a.shape
    h = (torch.zeros((b, d, n), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    a, bx, c = a.float(), bx.float(), c.float()
    ys = []
    for t in range(s):
        h = a[:, t] * h + bx[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, c[:, t]))
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((b, 0, d), device=a.device))
    return y, h


def ssm_chunked(a, bx, c, h0=None, *, chunk: int = 64):
    """Chunked 3-pass Mamba recurrence; equals :func:`ssm_scan`."""
    b, s, d, n = a.shape
    if h0 is None:
        h0 = torch.zeros((b, d, n), dtype=torch.float32, device=a.device)
    chunk = _chunk_len(s, chunk)
    nc = s // chunk
    la = torch.log(torch.clamp(a.reshape(b, nc, chunk, d, n).float(),
                               min=1e-38))
    bxc = bx.reshape(b, nc, chunk, d, n).float()
    cc = c.reshape(b, nc, chunk, n).float()

    la_cum = torch.cumsum(la, dim=2)
    la_tot = la_cum[:, :, -1:]
    decay_after = torch.exp(la_tot - la_cum)
    contrib = torch.sum(bxc * decay_after, dim=2)      # [B,NC,D,N]
    a_total = torch.exp(la_tot[:, :, 0])

    h = h0.float()
    starts = []
    for i in range(nc):
        starts.append(h)
        h = a_total[:, i] * h + contrib[:, i]
    h = torch.stack(starts, dim=1)                     # [B,NC,D,N]

    ea = torch.exp(la)
    ys = []
    for t in range(chunk):
        h = ea[:, :, t] * h + bxc[:, :, t]
        ys.append(torch.einsum("bcdn,bcn->bcd", h, cc[:, :, t]))
    y = torch.stack(ys, dim=2).reshape(b, s, d)
    return y, h[:, -1]


# ---------------------------------------------------------------------------
# RWKV6 block
# ---------------------------------------------------------------------------

def rwkv6_init(generator: torch.Generator, d_model: int, num_heads: int,
               head_dim: int, *, device=None):
    scale = (3.0 / d_model) ** 0.5
    hk = num_heads * head_dim
    draw = lambda shape, sc: _uniform(generator, shape, sc, device=device)
    params = {
        "mu": draw((5, d_model), 0.5) + 0.5,              # token-shift lerps
        "wr": draw((d_model, hk), scale),
        "wk": draw((d_model, hk), scale),
        "wv": draw((d_model, hk), scale),
        "wg": draw((d_model, hk), scale),
        "wdecay": draw((d_model, hk), scale * 0.1),
    }
    dev = params["wr"].device
    params["decay_base"] = torch.full((num_heads, head_dim), -0.5,
                                      dtype=torch.float32, device=dev)
    params["bonus_u"] = draw((num_heads, head_dim), 0.5)
    params["wo"] = draw((hk, d_model), (3.0 / hk) ** 0.5)
    params["ln_x"] = torch.ones((hk,), dtype=torch.float32, device=dev)
    specs = {
        "mu": (None, None), "wr": (FSDP, TP), "wk": (FSDP, TP),
        "wv": (FSDP, TP), "wg": (FSDP, TP), "wdecay": (FSDP, TP),
        "decay_base": (None, None), "bonus_u": (None, None),
        "wo": (TP, FSDP), "ln_x": (TP,),
    }
    return params, specs


def _shifted(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """The token before each position: ``x_prev`` ``[B,1,D]`` (the token
    before this window, zeros at sequence start), then ``x[:, :-1]``."""
    return torch.cat([x_prev.to(x.dtype), x[:, :-1]], dim=1)


def _rwkv6_inputs(params, x, x_prev, num_heads, head_dim):
    """Token-shift lerp + projections.  x: ``[B,S,D]``."""
    b, s, _ = x.shape
    shifted = _shifted(x, x_prev)
    mu = params["mu"].to(x.dtype)
    mix = [x + (shifted - x) * mu[i] for i in range(5)]

    def proj(m, w):
        return (m @ gather_in(params[w], x.dtype)).reshape(
            b, s, num_heads, head_dim)

    r, k, v, g = (proj(mix[0], "wr"), proj(mix[1], "wk"), proj(mix[2], "wv"),
                  proj(mix[3], "wg"))
    # Finch data-dependent decay: logw in (-inf, 0)
    wraw = (mix[4] @ params["wdecay"].to(x.dtype)).reshape(
        b, s, num_heads, head_dim)
    logw = -torch.exp(torch.clamp(params["decay_base"][None, None].float()
                                  + wraw.float(), -8.0, 6.0))
    return r, k, v, g, logw


def rwkv6_block(params: Params, x: torch.Tensor, *, num_heads: int,
                head_dim: int, chunk: int = 64, use_chunked: bool = True,
                x_prev=None, state=None, return_state: bool = False):
    """RWKV6 time-mix block. x: ``[B,S,D]`` -> ``[B,S,D]``; with
    ``return_state`` also ``(last token [B,1,D], wkv state [B,H,K,K])``."""
    b, s, d = x.shape
    if x_prev is None:
        x_prev = torch.zeros((b, 1, d), dtype=x.dtype, device=x.device)
    r, k, v, g, logw = _rwkv6_inputs(params, x, x_prev, num_heads, head_dim)
    u = params["bonus_u"].float()
    if use_chunked:
        out, s_fin = wkv_chunked(r, k, v, logw, u, s0=state, chunk=chunk)
    else:
        out, s_fin = wkv_scan(r, k, v, logw, u, s0=state)
    # per-head group norm + silu gate
    hk = num_heads * head_dim
    out = out.reshape(b, s, num_heads, head_dim)
    mean = out.mean(-1, keepdim=True)
    var = out.var(-1, keepdim=True, correction=0)
    out = (out - mean) * torch.rsqrt(var + 1e-5)
    out = out.reshape(b, s, hk) * params["ln_x"].float()
    out = out.to(x.dtype) * F.silu(g.reshape(b, s, hk))
    y = out @ gather_out(params["wo"], x.dtype)
    if return_state:
        return y, (x[:, -1:], s_fin)
    return y


def rwkv_cmix_init(generator: torch.Generator, d_model: int, d_ff: int, *,
                   device=None):
    scale = (3.0 / d_model) ** 0.5
    draw = lambda shape, sc: _uniform(generator, shape, sc, device=device)
    params = {
        "mu": draw((2, d_model), 0.5) + 0.5,
        "wr": draw((d_model, d_model), scale),
        "wk": draw((d_model, d_ff), scale),
        "wv": draw((d_ff, d_model), (3.0 / d_ff) ** 0.5),
    }
    specs = {"mu": (None, None), "wr": (FSDP, TP), "wk": (FSDP, TP),
             "wv": (TP, FSDP)}
    return params, specs


def rwkv_cmix(params: Params, x: torch.Tensor, x_prev=None,
              return_state: bool = False):
    """RWKV6 channel-mix: token-shifted squared-ReLU gated MLP."""
    b, s, d = x.shape
    if x_prev is None:
        x_prev = torch.zeros((b, 1, d), dtype=x.dtype, device=x.device)
    shifted = _shifted(x, x_prev)
    mu = params["mu"].to(x.dtype)
    xk = x + (shifted - x) * mu[0]
    xr = x + (shifted - x) * mu[1]
    k = torch.square(F.relu(xk @ gather_in(params["wk"], x.dtype)))
    out = torch.sigmoid(xr @ gather_in(params["wr"], x.dtype)) * (
        k @ gather_out(params["wv"], x.dtype))
    if return_state:
        return out, x[:, -1:]
    return out


# ---------------------------------------------------------------------------
# Mamba-lite block (hymba's SSM heads)
# ---------------------------------------------------------------------------

def mamba_init(generator: torch.Generator, d_model: int, d_inner: int,
               d_state: int, *, device=None):
    scale = (3.0 / d_model) ** 0.5
    draw = lambda shape, sc: _uniform(generator, shape, sc, device=device)
    params = {
        "win": draw((d_model, d_inner), scale),
        "wg": draw((d_model, d_inner), scale),
        "wdt": draw((d_model, d_inner), scale * 0.1),
        "wb": draw((d_model, d_state), scale),
        "wc": draw((d_model, d_state), scale),
    }
    dev = params["win"].device
    a_log = torch.log(torch.linspace(1.0, float(d_state), d_state,
                                     dtype=torch.float32, device=dev))
    params["a_log"] = a_log[None, :] * torch.ones(
        (d_inner, 1), dtype=torch.float32, device=dev)
    params["dskip"] = torch.ones((d_inner,), dtype=torch.float32, device=dev)
    params["wo"] = draw((d_inner, d_model), (3.0 / d_inner) ** 0.5)
    specs = {
        "win": (FSDP, TP), "wg": (FSDP, TP), "wdt": (FSDP, TP),
        "wb": (FSDP, None), "wc": (FSDP, None), "a_log": (TP, None),
        "dskip": (TP,), "wo": (TP, FSDP),
    }
    return params, specs


def mamba_block(params: Params, x: torch.Tensor, *, chunk: int = 64,
                use_chunked: bool = True, state=None,
                return_state: bool = False):
    """Selective-SSM block. x: ``[B,S,D]`` -> ``[B,S,D]``; with
    ``return_state`` also the state ``[B, D_inner, N]``."""
    xin = x @ gather_in(params["win"], x.dtype)                # [B,S,Di]
    gate = F.silu(x @ gather_in(params["wg"], x.dtype))
    dt = F.softplus(x @ gather_in(params["wdt"], x.dtype)).float()
    bmat = (x @ params["wb"].to(x.dtype)).float()              # [B,S,N]
    cmat = (x @ params["wc"].to(x.dtype)).float()              # [B,S,N]
    a = torch.exp(-torch.exp(params["a_log"])[None, None]
                  * dt[..., None])                             # [B,S,Di,N]
    bx = (dt * xin.float())[..., None] * bmat[:, :, None, :]
    if use_chunked:
        y, h_fin = ssm_chunked(a, bx, cmat, h0=state, chunk=chunk)
    else:
        y, h_fin = ssm_scan(a, bx, cmat, h0=state)
    y = y.to(x.dtype) + xin * params["dskip"].to(x.dtype)
    y = (y * gate) @ gather_out(params["wo"], x.dtype)
    if return_state:
        return y, h_fin
    return y
