"""Port parity: K7's gradient on the CPU — the plain backward
(``flash_swa_bwd_plain``), the autograd function that ``flash_swa_gqa``
goes through, and the banded attention's gradient against JAX's gradient
of the reference's banded ``attention`` (``repro.models.layers``, imported
through ``_torch_parity.reference_modules``).

Tolerances: 1e-5 of the largest entry (plus 1e-5 relative) between the
plain backward and autograd through the plain forward in float32 (the
same function, sums in another order); for bfloat16 inputs the plain
backward returns bf16, held to the float32 gradient on the same
bf16-rounded inputs at rtol 1e-2 (the output's bf16 rounding, 2^-9) and
1e-2 of the largest entry (its D pass, ``sum(dout * out)``, reads the
forward's bf16-rounded output: an error of about sqrt(hd) 2^-9 there,
measured 2.2e-3 of the largest entry at hd 16); the whole attention's
gradients against JAX's at 2e-5 of each leaf's largest entry in float32.

Last, a CPU model of the tensor-core backward's rounding
(``csrc/flash_swa_bwd_mma.cu``) against the float32 plain backward at the
card's bf16 limits (rtol 1e-2, atol 1e-3 of max(1, max|want|)): with ``P``
and ``dS`` split into bf16 halves it meets them at Danube's heads; with
either rounded to bf16 alone it misses them.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_swa import kernel as FK
from repro_torch.kernels.flash_swa.ops import BandedAttention, flash_swa_gqa
from repro_torch.models import layers as TL

from _torch_parity import np_of, reference_modules

#: (S, H, Hkv, hd, window, qc): GQA 2:1 and 3:1, window == qc, window ==
#: S, window 1 (each query sees itself), S == qc + window + qc, Hkv == H.
SHAPES = [(32, 4, 2, 16, 8, 8), (48, 6, 2, 8, 16, 8), (16, 2, 1, 8, 16, 16),
          (16, 2, 1, 8, 1, 1), (24, 3, 1, 12, 8, 8), (32, 4, 4, 16, 8, 8)]
F32_TOL = 1e-5


def _draw(shape, dtype, seed):
    S, H, Hkv, hd, _, _ = shape
    gen = torch.Generator().manual_seed(seed)
    q, k, v, dout = (torch.randn(2, S, heads, hd, generator=gen).to(dtype)
                     for heads in (H, Hkv, Hkv, H))
    return q, k, v, dout


def _close(got, want, rtol, atol_frac):
    want = want.float()
    torch.testing.assert_close(
        got.float(), want, rtol=rtol,
        atol=atol_frac * max(1.0, float(want.abs().max())))


def _autograd_plain(q, k, v, dout, window, qc):
    leaves = [t.detach().float().requires_grad_() for t in (q, k, v)]
    out = FK.flash_swa_plain(*leaves, window=window, qc=qc)
    return torch.autograd.grad(out, leaves, dout.float())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_backward_matches_autograd_f32(shape):
    S, H, Hkv, hd, window, qc = shape
    q, k, v, dout = _draw(shape, torch.float32, S + H)
    out, lse = FK.flash_swa(q, k, v, window=window, qc=qc, return_lse=True)
    assert lse.shape == (2, H, S) and lse.dtype == torch.float32
    got = FK.flash_swa_bwd(q, k, v, out, lse, dout, window=window, qc=qc)
    want = _autograd_plain(q, k, v, dout, window, qc)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.shape == t.shape and g.dtype == torch.float32
        _close(g, w, F32_TOL, F32_TOL)


@pytest.mark.parametrize("shape", SHAPES[:3], ids=str)
def test_plain_backward_bf16(shape):
    S, H, Hkv, hd, window, qc = shape
    q, k, v, dout = _draw(shape, torch.bfloat16, S + hd)
    out, lse = FK.flash_swa(q, k, v, window=window, qc=qc, return_lse=True)
    got = FK.flash_swa_bwd(q, k, v, out, lse, dout, window=window, qc=qc)
    want = _autograd_plain(q, k, v, dout, window, qc)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        _close(g, w, 1e-2, 1e-2)


def test_lse_is_the_row_logsumexp():
    S, H, Hkv, hd, window, qc = SHAPES[0]
    q, k, v, _ = _draw(SHAPES[0], torch.float32, 7)
    _, lse = FK.flash_swa(q, k, v, window=window, qc=qc, return_lse=True)
    kk, i = k.repeat_interleave(H // Hkv, dim=2), torch.arange(S)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kk) * hd ** -0.5
    band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    want = torch.logsumexp(torch.where(band, logits, -1e30), dim=-1)
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_function_matches_autograd_of_plain(shape):
    S, H, Hkv, hd, window, qc = shape
    q, k, v, dout = _draw(shape, torch.float32, S + Hkv)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_swa_gqa(*leaves, window=window, qc=qc)
    assert isinstance(out.grad_fn, BandedAttention._backward_cls)
    got = torch.autograd.grad(out, leaves, dout)
    for g, w in zip(got, _autograd_plain(q, k, v, dout, window, qc)):
        _close(g, w, F32_TOL, F32_TOL)


def test_no_graph_without_grad():
    S, H, Hkv, hd, window, qc = SHAPES[0]
    q, k, v, _ = _draw(SHAPES[0], torch.float32, 3)
    assert flash_swa_gqa(q, k, v, window=window, qc=qc).grad_fn is None
    leaves = [t.requires_grad_() for t in (q, k, v)]
    with torch.no_grad():
        assert flash_swa_gqa(*leaves, window=window, qc=qc).grad_fn is None
    # only k needs a gradient: the function still runs, q/v get none
    k2 = k.detach().clone().requires_grad_()
    out = flash_swa_gqa(q.detach(), k2, v.detach(), window=window, qc=qc)
    out.sum().backward()
    assert k2.grad is not None and bool(torch.isfinite(k2.grad).all())


# ---------------------------------------------------------------------------
# against JAX's gradient of the reference's banded attention
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    with reference_modules("repro.models.layers") as (layers,):
        yield layers


#: (S, heads, kv heads, head_dim, window, query chunk), each banded (S >
#: qc + window): GQA 2:1, window == qc, window 2 qc, Hkv == H.
ATTN_CASES = [(32, 4, 2, 16, 8, 8), (48, 4, 1, 8, 8, 8),
              (40, 2, 2, 16, 16, 8)]


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_banded_attention_grads_match_reference(ref, case):
    import jax
    S, H, Hkv, hd, window, qc = case
    d_model = 32
    kw = dict(num_heads=H, num_kv_heads=Hkv, head_dim=hd, rope_theta=1e4,
              sliding_window=window, query_chunk=qc, swa_banded=True)
    jparams, _ = ref.attention_init(jax.random.PRNGKey(S), d_model, H, Hkv,
                                    hd, False)
    jparams = {n: np.asarray(p) for n, p in jparams.items()}
    rng = np.random.default_rng(S + H)
    x = rng.standard_normal((2, S, d_model)).astype(np.float32)
    cot = rng.standard_normal((2, S, d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))

    def jloss(p, xx):
        return (ref.attention(p, xx, pos, **kw) * cot).sum()

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jparams, x)

    params = {n: torch.from_numpy(p.copy()).requires_grad_()
              for n, p in jparams.items()}
    xt = torch.from_numpy(x.copy()).requires_grad_()
    out = TL.attention(params, xt, torch.from_numpy(pos.copy()), **kw)
    assert isinstance(out.grad_fn, torch.autograd.graph.Node)
    (out * torch.from_numpy(cot)).sum().backward()
    for name, leaf in params.items():
        want = np.asarray(jgp[name])
        np.testing.assert_allclose(np_of(leaf.grad), want, rtol=0,
                                   atol=2e-5 * np.abs(want).max(),
                                   err_msg=name)
    want = np.asarray(jgx)
    np.testing.assert_allclose(np_of(xt.grad), want, rtol=0,
                               atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_a_rank_without_heads_launches_and_tallies_nothing(device):
    """``H = Hkv = 0`` (a rank of ``model`` that holds no head): the
    forward and the autograd backward give empty tensors of the operands'
    shapes, launch nothing and tally nothing on ``meta``, and the
    gradient still reaches every operand (so that the ranks' collectives
    in the backward line up); one query head and no KV head raises."""
    from repro_torch.kernels import tally
    S, _, _, hd, window, qc = SHAPES[0]
    q, k, v = (torch.zeros((2, S, 0, hd), device=device).requires_grad_()
               for _ in range(3))
    before = dict(FK.LAUNCHES)
    tally.reset()
    out = flash_swa_gqa(q, k, v, window=window, qc=qc)
    assert out.shape == q.shape and out.device.type == device
    grads = torch.autograd.grad(out, (q, k, v), torch.zeros_like(out))
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    assert FK.LAUNCHES == before and tally.TALLY["calls"] == {}
    with pytest.raises(ValueError, match="multiple"):
        FK.flash_swa(torch.zeros((2, S, 1, hd)), torch.zeros((2, S, 0, hd)),
                     torch.zeros((2, S, 0, hd)), window=window, qc=qc)


def test_backward_wrapper_takes_plain_version_only_on_cpu():
    S, H, Hkv, hd, window, qc = SHAPES[0]
    q, k, v, dout = _draw(SHAPES[0], torch.float32, 9)
    out, lse = FK.flash_swa(q, k, v, window=window, qc=qc, return_lse=True)
    before = dict(FK.LAUNCHES)
    FK.flash_swa_bwd(q, k, v, out, lse, dout, window=window, qc=qc)
    assert FK.LAUNCHES == before
    # meta tensors (the dry run): empty gradients of the kernel's shapes,
    # no launch, ``10 hd H pairs`` flop tallied
    from repro_torch.kernels import tally
    tally.reset()
    meta = [t.to("meta") for t in (q, k, v, out, lse, dout)]
    grads = FK.flash_swa_bwd(*meta, window=window, qc=qc)
    assert [(g.device.type, g.shape) for g in grads] == [
        ("meta", t.shape) for t in (q, k, v)]
    assert FK.LAUNCHES == before
    assert tally.TALLY["flops"] == (10 * hd * H * q.shape[0]
                                    * tally.band_pairs(S, window))
    with pytest.raises(ValueError, match="lse"):
        FK.flash_swa_bwd(q, k, v, out, lse[:, :1], dout, window=window,
                         qc=qc)


# ---------------------------------------------------------------------------
# The tensor-core backward's rounding (csrc/flash_swa_bwd_mma.cu), modelled
# on the CPU.
# ---------------------------------------------------------------------------

#: (S, H, Hkv, hd, window, qc, seed): Danube's heads (32/8 of 120) at S
#: 1,024 under windows of 512 and 1,024, and at S 2,048 under 1,024.
BWD_MMA_CASES = [(1024, 32, 8, 120, 512, 128, 6),
                 (1024, 32, 8, 120, 1024, 256, 8),
                 (2048, 32, 8, 120, 1024, 256, 6)]
#: The card's check of the bf16 backward against the float32 plain version
#: (``chip_smoke.BWD_TOL_BF16``, ``tests/test_torch_cuda.py::
#: SWA_BWD_TOL``): ``|got - want| <= rtol |want| + atol max(1, max|want|)``.
BWD_BF16_RTOL, BWD_BF16_ATOL = 1e-2, 1e-3


def _bf16(t):
    return t.bfloat16().float()


def _halves(t, split):
    """``t`` as the kernel feeds it to the tensor cores: ``bf16(t)`` and,
    with ``split``, ``bf16(t - bf16(t))``."""
    hi = _bf16(t)
    return (hi, _bf16(t - hi)) if split else (hi,)


def _tensor_core_bwd_model(q, k, v, out, lse, dout, window, qc, *, split_p,
                           split_ds):
    """The tensor-core backward's arithmetic on bf16-valued float32
    inputs: ``S = Q K^T`` and ``dP = dO V^T`` in float32 (bf16 products are
    exact), ``P = exp2(S scale log2 e - lse log2 e)`` in the band, ``dS = P
    (dP - D)``; ``P`` goes to ``P^T dO`` and ``dS`` to ``dS K`` and ``dS^T
    Q`` as bf16 halves (:func:`_halves`), accumulated in float32; scale is
    applied to the dq and dk sums, and the outputs are rounded to bf16
    once.  The kernel's tiles change only the order of float32 sums."""
    b, s, h, hd = q.shape
    groups = h // k.shape[2]
    kk, vv = (t.repeat_interleave(groups, dim=2) for t in (k, v))
    scale, log2e = hd ** -0.5, 1.4426950408889634
    dsum = (dout * out).sum(-1).transpose(1, 2)
    dq = torch.empty(q.shape)
    dk, dv = torch.zeros(b, s, h, hd), torch.zeros(b, s, h, hd)
    for i in range(s // qc):
        rows, start, band, mask = FK._band(i, s, window, qc, q.device)
        keys = slice(start, start + band)
        qb, dob, kb, vb = q[:, rows], dout[:, rows], kk[:, keys], vv[:, keys]
        logits = torch.einsum("bqhd,bkhd->bhqk", qb, kb)
        p = torch.where(mask, torch.exp2(logits * (scale * log2e)
                                         - lse[:, :, rows, None] * log2e),
                        0.0)
        dp = torch.einsum("bqhd,bkhd->bhqk", dob, vb)
        ds = p * (dp - dsum[:, :, rows, None])
        dq[:, rows] = sum(torch.einsum("bhqk,bkhd->bqhd", x, kb)
                          for x in _halves(ds, split_ds)) * scale
        dk[:, keys] += sum(torch.einsum("bhqk,bqhd->bkhd", x, qb)
                           for x in _halves(ds, split_ds))
        dv[:, keys] += sum(torch.einsum("bhqk,bqhd->bkhd", x, dob)
                           for x in _halves(p, split_p))
    dk = dk.view(b, s, -1, groups, hd).sum(3) * scale
    dv = dv.view(b, s, -1, groups, hd).sum(3)
    return _bf16(dq), _bf16(dk), _bf16(dv)


@functools.lru_cache(maxsize=None)
def _bwd_model_inputs(case):
    """bf16-valued ``(q, k, v, out, lse, dout)`` (``out`` rounded to bf16,
    as the forward writes it) and the float32 plain backward on them."""
    S, H, Hkv, hd, window, qc, seed = case
    rng = np.random.default_rng(seed)
    q, k, v, dout = (_bf16(torch.from_numpy(
        rng.standard_normal((1, S, n, hd)).astype(np.float32)))
        for n in (H, Hkv, Hkv, H))
    out, lse = FK.flash_swa(q, k, v, window=window, qc=qc, return_lse=True)
    inputs = (q, k, v, _bf16(out), lse, dout)
    return inputs, FK.flash_swa_bwd_plain(*inputs, window=window, qc=qc)


def _bwd_model_misses(case, split_p, split_ds):
    """Elements of (dq, dk, dv) outside the card's check: the model against
    the float32 plain backward on the same inputs."""
    inputs, want = _bwd_model_inputs(case)
    window, qc = case[4], case[5]
    got = _tensor_core_bwd_model(*inputs, window, qc, split_p=split_p,
                                 split_ds=split_ds)
    return tuple(
        int(((g - w).abs() > BWD_BF16_RTOL * w.abs() + BWD_BF16_ATOL
             * max(1.0, float(w.abs().max()))).sum())
        for g, w in zip(got, want))


@pytest.mark.parametrize("case", BWD_MMA_CASES, ids=str)
def test_tensor_core_bwd_rounding_meets_the_bf16_check(case):
    """The kernel's choice: both P and dS split into bf16 halves."""
    assert _bwd_model_misses(case, True, True) == (0, 0, 0)


@pytest.mark.parametrize("unsplit", ["P", "dS"])
def test_unsplit_rounding_misses_the_bf16_check(unsplit):
    """Why the kernel splits both: with either of P or dS rounded to bf16
    alone, the gradients it feeds (dv for P; dq and dk for dS) leave
    elements outside the check's limits.  dS misses on each of these
    draws, P on two of the three (one element of dv each, near the start
    of the sequence, where single terms of P are large): rare enough to
    pass some draws, often enough to fail the card's check now and
    then."""
    split_p, split_ds = unsplit != "P", unsplit != "dS"
    misses = [_bwd_model_misses(case, split_p, split_ds)
              for case in BWD_MMA_CASES]
    fed = [2] if unsplit == "P" else [0, 1]
    assert sum(m[i] for m in misses for i in fed) > 0
    assert all(m[i] == 0 for m in misses for i in {0, 1, 2} - set(fed))
