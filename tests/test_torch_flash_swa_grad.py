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
"""
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


def test_backward_wrapper_takes_plain_version_only_on_cpu():
    S, H, Hkv, hd, window, qc = SHAPES[0]
    q, k, v, dout = _draw(SHAPES[0], torch.float32, 9)
    out, lse = FK.flash_swa(q, k, v, window=window, qc=qc, return_lse=True)
    before = dict(FK.LAUNCHES)
    FK.flash_swa_bwd(q, k, v, out, lse, dout, window=window, qc=qc)
    assert FK.LAUNCHES == before
    meta = [t.to("meta") for t in (q, k, v, out, lse, dout)]
    with pytest.raises(ValueError, match="device"):
        FK.flash_swa_bwd(*meta, window=window, qc=qc)
    with pytest.raises(ValueError, match="lse"):
        FK.flash_swa_bwd(q, k, v, out, lse[:, :1], dout, window=window,
                         qc=qc)
