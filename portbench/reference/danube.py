"""A plain float32 decoder of the Danube shape, its loss, gradients and
AdamW: the reference that a training cell's ``correct`` is held to.

Each layer is pre-norm: RMSNorm, grouped-query attention over a sliding
window with rotary positions (the first half of each head rotated against
the second), a residual add, RMSNorm, a SiLU-gated MLP, a residual add;
then a final RMSNorm and an untied output head.  A position ``i`` attends
to the keys ``j`` with ``i - window < j <= i``.  The loss is the mean
next-token cross-entropy over the labels that are not -1, a microbatch at
a time, the microbatches' losses and gradients averaged.  AdamW follows
the traffic's optimizer: global-norm clipping, bias-corrected moments,
decoupled weight decay on every leaf of two or more dimensions in the
stacked tree (the layers' norm scales included, as the port's tree has
them), a linear warmup.

Attention runs a block of queries at a time against its band of keys, and
each layer and each block is recomputed in the backward (checkpoints), so
the reference fits beside its own float32 state.  Every matrix product
goes through ``mm``: ``torch.matmul`` with TF32 off for the reference, or
:func:`fp8_mm` for the control, which computes each product from its
operands rounded to float8 (e4m3, one scale a tensor) in the forward and
in the backward.  Plain PyTorch only: nothing of the port is imported.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Mm = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

#: Queries a block of the banded attention.
QUERY_BLOCK = 512
#: Positions a block of the cross-entropy.
LOSS_BLOCK = 2048


def _q8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude at 448), back in float32."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _q8(a), _q8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, grad):
        qa, qb = ctx.saved_tensors
        qg = _q8(grad)
        return qg @ qb.mT, qa.mT @ qg


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _Fp8Matmul.apply(a, b)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """``x`` ``[S, heads, hd]`` at positions ``0..S-1``."""
    s, _, hd = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    angles = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(angles)[:, None], torch.sin(angles)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _band_block(q, k, v, i0: int, j0: int, window: int, mm: Mm):
    """Queries ``i0..`` (``q [b, H, hd]``) against keys ``j0..`` (``k``/``v``
    ``[kb, H, hd]``): ``[b, H hd]``."""
    b, h, hd = q.shape
    scores = mm(q.transpose(0, 1), k.permute(1, 2, 0)) * hd ** -0.5
    i = torch.arange(i0, i0 + b, device=q.device)[:, None]
    j = torch.arange(j0, j0 + k.shape[0], device=q.device)[None]
    keep = (j <= i) & (j > i - window)
    probs = torch.softmax(scores.masked_fill(~keep, float("-inf")), dim=-1)
    return mm(probs, v.transpose(0, 1)).transpose(0, 1).reshape(b, h * hd)


def attention(q, k, v, window: int, mm: Mm) -> torch.Tensor:
    """``q [S, H, hd]``, ``k``/``v [S, Hkv, hd]`` -> ``[S, H hd]``; query
    head ``h`` reads key head ``h // (H / Hkv)``."""
    s, h, _ = q.shape
    groups = h // k.shape[1]
    k = k.repeat_interleave(groups, dim=1)
    v = v.repeat_interleave(groups, dim=1)
    out = []
    for i0 in range(0, s, QUERY_BLOCK):
        i1 = min(s, i0 + QUERY_BLOCK)
        j0 = max(0, i0 - window + 1)
        out.append(checkpoint(_band_block, q[i0:i1], k[j0:i1], v[j0:i1],
                              i0, j0, window, mm, use_reentrant=False))
    return torch.cat(out)


def layer(p: Dict[str, torch.Tensor], x: torch.Tensor, model: dict,
          mm: Mm) -> torch.Tensor:
    s = x.shape[0]
    H, Hkv, hd = model["num_heads"], model["num_kv_heads"], model["head_dim"]
    eps, theta = model["rms_eps"], model["rope_theta"]
    h = rmsnorm(x, p["ln1/scale"], eps)
    q = rope(mm(h, p["attn/wq"]).view(s, H, hd), theta)
    k = rope(mm(h, p["attn/wk"]).view(s, Hkv, hd), theta)
    v = mm(h, p["attn/wv"]).view(s, Hkv, hd)
    x = x + mm(attention(q, k, v, model["sliding_window"], mm),
               p["attn/wo"])
    h = rmsnorm(x, p["ln2/scale"], eps)
    return x + mm(F.silu(mm(h, p["mlp/w1"])) * mm(h, p["mlp/w3"]),
                  p["mlp/w2"])


def _nll(h, head, labels, mm: Mm):
    logits = mm(h, head)
    gold = logits.gather(-1, labels.clamp(min=0).long()[:, None])[:, 0]
    return ((torch.logsumexp(logits, -1) - gold) * (labels >= 0)).sum()


class Decoder:
    """The reference's state: per-layer float32 views of the weights it is
    handed (updated in place), and AdamW's moments."""

    def __init__(self, weights: Dict, model: dict, optimizer: dict,
                 mm: Mm = torch.matmul):
        self.model, self.opt, self.mm = model, optimizer, mm
        self.leaves: Dict[str, List[torch.Tensor]] = {}
        self.stacked: Dict[str, torch.Tensor] = {}
        self.gbuf: Dict[str, torch.Tensor] = {}
        for path, t in _leaves(weights):
            self.stacked[path] = t
            self.gbuf[path] = g = torch.zeros_like(t)
            stacked = path.startswith("layers/")
            parts = zip(t.unbind(0), g.unbind(0)) if stacked else [(t, g)]
            self.leaves[path] = []
            for w, wg in parts:
                # a leaf whose gradient autograd adds into its slice of the
                # stacked buffer, in place
                w.requires_grad_()
                w.grad = wg
                self.leaves[path].append(w)
        self.m = {p: torch.zeros_like(t) for p, t in self.stacked.items()}
        self.v = {p: torch.zeros_like(t) for p, t in self.stacked.items()}
        self.step_count = 0

    def _layer_params(self, i: int) -> Dict[str, torch.Tensor]:
        return {path[len("layers/"):]: ws[i] for path, ws in
                self.leaves.items() if path.startswith("layers/")}

    def row_nll(self, tokens: torch.Tensor, labels: torch.Tensor):
        """The summed NLL of one row ``[S]``, a graph to differentiate."""
        x = F.embedding(tokens.long(), self.leaves["embed"][0])
        for i in range(self.model["num_layers"]):
            x = checkpoint(layer, self._layer_params(i), x, self.model,
                           self.mm, use_reentrant=False)
        h = rmsnorm(x, self.leaves["ln_f/scale"][0], self.model["rms_eps"])
        head = self.leaves["lm_head"][0]
        total = h.new_zeros(())
        for c in range(0, h.shape[0], LOSS_BLOCK):
            total = total + checkpoint(_nll, h[c:c + LOSS_BLOCK], head,
                                       labels[c:c + LOSS_BLOCK], self.mm,
                                       use_reentrant=False)
        return total

    def loss_and_grads(self, batch: Dict[str, torch.Tensor],
                       microbatches: int) -> float:
        """Accumulate the batch's mean microbatch loss's gradient into the
        leaves' ``.grad``; returns that loss."""
        rows = batch["tokens"].shape[0]
        per = rows // microbatches
        losses = []
        for mb in range(microbatches):
            sl = slice(mb * per, (mb + 1) * per)
            count = float((batch["labels"][sl] >= 0).sum().clamp(min=1))
            nll = 0.0
            for r in range(sl.start, sl.stop):
                part = self.row_nll(batch["tokens"][r], batch["labels"][r])
                (part / (count * microbatches)).backward()
                nll += float(part.detach())
            losses.append(nll / count)
        return sum(losses) / microbatches

    def lr(self, step: int) -> float:
        o = self.opt
        if step < o["warmup_steps"]:
            return o["lr"] * step / max(o["warmup_steps"], 1)
        prog = min(max((step - o["warmup_steps"])
                       / max(o["total_steps"] - o["warmup_steps"], 1), 0.0),
                   1.0)
        return (o["min_lr_frac"] * o["lr"] + (1 - o["min_lr_frac"]) * o["lr"]
                * 0.5 * (1 + math.cos(math.pi * prog)))

    @torch.no_grad()
    def adamw(self) -> Dict[str, float]:
        """One update from the accumulated gradients, which it uses as
        scratch and then clears; returns each leaf's gradient norm as the
        update took it (after clipping)."""
        o = self.opt
        self.step_count += 1
        t = self.step_count
        norm = math.sqrt(sum(float(g.double().square().sum())
                             for g in self.gbuf.values()))
        scale = min(1.0, o["clip_norm"] / max(norm, 1e-9))
        lr = self.lr(t)
        bc1, bc2 = 1 - o["beta1"] ** t, 1 - o["beta2"] ** t
        norms = {}
        for path, p in self.stacked.items():
            g, m, v = self.gbuf[path], self.m[path], self.v[path]
            g.mul_(scale)
            norms[path] = float(g.double().norm())
            m.mul_(o["beta1"]).add_(g, alpha=1 - o["beta1"])
            v.mul_(o["beta2"]).addcmul_(g, g, value=1 - o["beta2"])
            # the update (m / bc1) / (sqrt(v / bc2) + eps), built in g
            torch.div(v, bc2, out=g)
            g.sqrt_().add_(o["eps"])
            torch.div(m, g, out=g)
            g.div_(bc1)
            if p.ndim >= 2:
                g.add_(p, alpha=o["weight_decay"])
            p.sub_(g, alpha=lr)
            g.zero_()
        return norms


def _leaves(tree, prefix: str = ""):
    for name, value in tree.items():
        path = f"{prefix}/{name}" if prefix else name
        if isinstance(value, dict):
            yield from _leaves(value, path)
        else:
            yield path, value
