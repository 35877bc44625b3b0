"""Port parity: banded sliding-window attention (K7) against the live JAX
reference.

``repro.kernels.flash_swa.ops`` (the Pallas kernel, run in interpret mode)
and ``ref`` are imported through ``_torch_parity.reference_modules``.  On
CPU tensors the port's wrapper runs its plain version (one query chunk
against its band at a time).  Cases: the reference's own
(``tests/test_flash_swa.py``), plus head_dim 120 (H2O-Danube3-4B) and 24,
and GQA 4:1 and 5:1.  Tolerances: 2e-5 in float32; 3e-2 for bfloat16
inputs against the float32 oracle, as the reference's test.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_swa import kernel as TK
from repro_torch.kernels.flash_swa import ops as TO
from repro_torch.kernels.flash_swa import ref as TR
from repro_torch.models import layers as TL

from _torch_parity import np_of, reference_modules

F32_TOL = 2e-5
BF16_TOL = 3e-2

#: (S, H, Hkv, hd, window, qc): the reference's five cases, then head_dim
#: 120 and 24, and GQA 4:1 and 5:1.
CASES = [
    (64, 2, 2, 16, 16, 8),
    (128, 1, 1, 32, 32, 16),
    (64, 3, 3, 16, 64, 8),       # window == S (full causal)
    (256, 2, 2, 8, 32, 32),      # window == qc (narrowest band)
    (96, 2, 2, 16, 48, 16),      # non-power-of-two S
    (128, 2, 2, 120, 32, 16),    # Danube's head_dim
    (64, 2, 2, 24, 16, 8),
    (64, 8, 2, 16, 32, 8),       # GQA 4:1 (Danube's 32:8)
    (64, 5, 1, 16, 16, 16),      # GQA 5:1 (Hymba's 25:5)
]


@pytest.fixture(scope="module")
def ref():
    with reference_modules("repro.kernels.flash_swa.ops",
                           "repro.kernels.flash_swa.ref",
                           "repro.models.layers") as modules:
        yield modules


def _rand(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _qkv(S, H, Hkv, hd, seed=1, batch=2):
    return (_rand((batch, S, H, hd), seed), _rand((batch, S, Hkv, hd),
                                                  seed + 1),
            _rand((batch, S, Hkv, hd), seed + 2))


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(np.asarray(np_of(got), np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_oracle_matches_reference(ref, case):
    S, H, Hkv, hd, window, _ = case
    q, k, v = _qkv(S, H, H, hd)
    want = ref[1].swa_attention_ref(q, k, v, window=window)
    got = TR.swa_attention_ref(*map(torch.from_numpy, (q, k, v)),
                               window=window)
    _close(got, want)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_gqa_matches_reference_kernel(ref, case):
    """The port's flash_swa_gqa (plain K7 on the CPU) against the
    reference's Pallas kernel in interpret mode and the oracle."""
    S, H, Hkv, hd, window, qc = case
    q, k, v = _qkv(S, H, Hkv, hd)
    want = ref[0].flash_swa_gqa(q, k, v, window=window, qc=qc)
    before = dict(TK.LAUNCHES)
    got = TO.flash_swa_gqa(*map(torch.from_numpy, (q, k, v)), window=window,
                           qc=qc)
    assert TK.LAUNCHES == before
    assert got.shape == (2, S, H, hd) and got.dtype == torch.float32
    _close(got, want)
    groups = H // Hkv
    oracle = ref[1].swa_attention_ref(q, np.repeat(k, groups, 2),
                                      np.repeat(v, groups, 2), window=window)
    _close(got, oracle)


@pytest.mark.parametrize("case", [c for c in CASES if c[1] == c[2]], ids=str)
def test_same_heads_matches_reference_kernel(ref, case):
    S, H, _, hd, window, qc = case
    q, k, v = _qkv(S, H, H, hd, seed=4)
    want = ref[0].flash_swa(q, k, v, window=window, qc=qc)
    got = TO.flash_swa(*map(torch.from_numpy, (q, k, v)), window=window,
                       qc=qc)
    _close(got, want)


@pytest.mark.parametrize("hd", [16, 120])
def test_bf16_inputs_against_f32_oracle(ref, hd):
    import jax.numpy as jnp
    q, k, v = _qkv(64, 2, 2, hd, seed=7, batch=1)
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = TK.flash_swa(qb, kb, vb, window=16, qc=8)
    assert got.dtype == torch.bfloat16
    f32 = [np.asarray(t.float().numpy()) for t in (qb, kb, vb)]
    want = ref[1].swa_attention_ref(*f32, window=16)
    _close(got.float(), want, BF16_TOL)
    ref_bf16 = ref[0].flash_swa(*(jnp.asarray(a, jnp.bfloat16) for a in f32),
                                window=16, qc=8)
    _close(got.float(), np.asarray(ref_bf16, np.float32), BF16_TOL)


def test_matches_model_attend(ref):
    """K7 == the model's masked-softmax SWA core (the reference's and the
    port's ``_attend``)."""
    q, k, v = _qkv(32, 2, 2, 8, seed=10, batch=1)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32)[None], (1, 32))
    want = ref[2]._attend(q, k, v, pos, pos, 8 ** -0.5, 8)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tpos = torch.from_numpy(np.array(pos))
    port_attend = TL._attend(tq, tk, tv, tpos, tpos, 8 ** -0.5, 8)
    got = TO.flash_swa(tq, tk, tv, window=8, qc=8)
    _close(port_attend, want)
    _close(got, want)


def test_plain_version_never_builds_full_scores(monkeypatch):
    """The plain K7 scores one [B, H, qc, qc + window] band at a time."""
    seen = []
    real = torch.einsum

    def spy(eq, *ops):
        out = real(eq, *ops)
        seen.append(tuple(out.shape))
        return out

    monkeypatch.setattr(torch, "einsum", spy)
    q, k, v = (torch.from_numpy(a) for a in _qkv(256, 2, 2, 8, batch=1))
    TK.flash_swa_plain(q, k, v, window=32, qc=16)
    scores = [s for s in seen if len(s) == 4 and s[1] == 2]
    assert scores and all(s[2:] == (16, 48) for s in scores)


@pytest.mark.parametrize("bad", [
    dict(shape=(1, 60, 2, 8), window=16, qc=8),     # S % qc
    dict(shape=(1, 64, 2, 8), window=12, qc=8),     # window % qc
])
def test_reference_assertions(bad):
    q = torch.zeros(bad["shape"])
    with pytest.raises(ValueError, match="multiples of qc"):
        TK.flash_swa(q, q, q, window=bad["window"], qc=bad["qc"])


def test_operand_checks():
    q = torch.zeros((1, 16, 4, 8))
    with pytest.raises(ValueError, match="multiple of 3 KV heads"):
        TK.flash_swa(q, torch.zeros((1, 16, 3, 8)), torch.zeros((1, 16, 3, 8)),
                     window=8, qc=8)
    with pytest.raises(TypeError, match="bfloat16"):
        TK.flash_swa(q, q.to(torch.bfloat16), q, window=8, qc=8)
    with pytest.raises(ValueError, match="contiguous"):
        TK.flash_swa(q.transpose(1, 2), q, q, window=8, qc=8)
    with pytest.raises(ValueError, match="KV heads"):
        TO.flash_swa(q, q[:, :, :2].contiguous(), q[:, :, :2].contiguous(),
                     window=8, qc=8)
