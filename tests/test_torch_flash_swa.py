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


# ---------------------------------------------------------------------------
# The tensor-core K7's rounding (csrc/flash_swa_mma.cu), modelled on the CPU.
# ---------------------------------------------------------------------------

#: (S, H, Hkv, hd, window): the check's shapes at S 2,048 — Danube's heads
#: of 120 with GQA 4:1 under a 1,024 window, the same under a 32 window, and
#: heads of 64.
MMA_CASES = [(2048, 8, 2, 120, 1024), (2048, 8, 2, 120, 32),
             (2048, 8, 2, 64, 1024)]


def _tensor_core_model(q, k, v, window, *, split):
    """The tensor-core kernel's arithmetic on bf16-valued float32 inputs:
    128-row query tiles walk the 64-row KV tiles of their band with an
    online base-2 softmax in float32 (the reference's -1e30 fill); ``P``
    goes to ``P V`` as ``bf16(P) + bf16(P - bf16(P))`` (``split``) or as
    ``bf16(P)`` alone, with float32 accumulation; the output is rounded to
    bf16 once."""
    B, S, H, hd = q.shape
    groups = H // k.shape[2]
    kk, vv = (t.repeat_interleave(groups, dim=2) for t in (k, v))
    scale = hd ** -0.5 * 1.4426950408889634
    bf = lambda t: t.bfloat16().float()
    out = torch.empty_like(q)
    for q0 in range(0, S, 128):
        rows = torch.arange(q0, min(q0 + 128, S))
        qb = q[:, q0:q0 + 128]
        m = torch.full((B, H, len(rows)), -1e30)
        l = torch.zeros((B, H, len(rows)))
        acc = torch.zeros((B, H, len(rows), hd))
        for kt in range(max(0, q0 - window + 1) // 64 * 64, int(rows[-1]) + 1,
                        64):
            cols = torch.arange(kt, min(kt + 64, S))
            s = torch.einsum("bqhd,bkhd->bhqk", qb, kk[:, kt:kt + 64]) * scale
            valid = ((cols[None, :] <= rows[:, None])
                     & (cols[None, :] > rows[:, None] - window))
            s = torch.where(valid, s, torch.tensor(-1e30))
            mx = torch.maximum(m, s.amax(-1))
            corr = torch.exp2(m - mx)
            p = torch.exp2(s - mx[..., None])
            l = l * corr + p.sum(-1)
            vb = vv[:, kt:kt + 64]
            hi = bf(p)
            pv = torch.einsum("bhqk,bkhd->bhqd", hi, vb)
            if split:
                pv = pv + torch.einsum("bhqk,bkhd->bhqd", bf(p - hi), vb)
            acc = acc * corr[..., None] + pv
            m = mx
        res = acc / torch.clamp(l, min=1e-30)[..., None]
        out[:, q0:q0 + 128] = bf(res.permute(0, 2, 1, 3))
    return out


def _mma_model_error(case, split):
    """Elements outside |got - want| <= 1e-4 + 1e-2 |want| (the card
    check, tests/test_torch_cuda.py), with want the float32 plain version
    on the same bf16-rounded inputs."""
    S, H, Hkv, hd, window = case
    q, k, v = (torch.from_numpy(a).bfloat16().float()
               for a in _qkv(S, H, Hkv, hd, seed=S + hd + window, batch=1))
    got = _tensor_core_model(q, k, v, window, split=split)
    want = TK.flash_swa_plain(q, k, v, window=window, qc=32)
    return int(((got - want).abs() > 1e-4 + 1e-2 * want.abs()).sum())


@pytest.mark.parametrize("case", MMA_CASES, ids=str)
def test_tensor_core_rounding_meets_the_bf16_check(case):
    assert _mma_model_error(case, split=True) == 0


@pytest.mark.parametrize("case", MMA_CASES, ids=str)
def test_bf16_probabilities_alone_miss_the_bf16_check(case):
    """Why the kernel splits P: rounding it to bf16 alone leaves elements
    outside the check's limits."""
    assert _mma_model_error(case, split=False) > 0


# ---------------------------------------------------------------------------
# The routes between K7's kernels, their counters and sources, and the flop
# the wgmma kernels execute (csrc/flash_swa_wgmma.cu,
# csrc/flash_swa_bwd_wgmma.cu).
# ---------------------------------------------------------------------------

#: (dtype, head_dim, forward route, backward route): bf16 heads up to 128
#: that are a multiple of 8 (TMA's 16-byte row strides) take the wgmma
#: kernels, the other bf16 heads up to 128 the mma.sync kernels, float32
#: and wider bf16 heads the CUDA-core kernels.
ROUTES = [
    (torch.bfloat16, 8, "flash_swa_wgmma", "flash_swa_bwd_wgmma"),
    (torch.bfloat16, 64, "flash_swa_wgmma", "flash_swa_bwd_wgmma"),
    (torch.bfloat16, 120, "flash_swa_wgmma", "flash_swa_bwd_wgmma"),
    (torch.bfloat16, 128, "flash_swa_wgmma", "flash_swa_bwd_wgmma"),
    (torch.bfloat16, 100, "flash_swa_mma", "flash_swa_bwd_mma"),
    (torch.bfloat16, 20, "flash_swa_mma", "flash_swa_bwd_mma"),
    (torch.bfloat16, 127, "flash_swa_mma", "flash_swa_bwd_mma"),
    (torch.bfloat16, 136, "flash_swa", "flash_swa_bwd"),
    (torch.bfloat16, 256, "flash_swa", "flash_swa_bwd"),
    (torch.float32, 64, "flash_swa", "flash_swa_bwd"),
    (torch.float32, 120, "flash_swa", "flash_swa_bwd"),
    (torch.float32, 256, "flash_swa", "flash_swa_bwd"),
]


@pytest.mark.parametrize("dtype,hd,fwd,bwd", ROUTES, ids=str)
def test_routes_by_dtype_and_head_width(dtype, hd, fwd, bwd):
    assert TK.kernel_for(dtype, hd) == fwd
    assert TK.bwd_kernel_for(dtype, hd) == bwd


@pytest.mark.parametrize("route", ["flash_swa_wgmma", "flash_swa_bwd_wgmma"])
def test_alignment_never_changes_the_route(route):
    """The route is a function of dtype and head width alone; an operand
    off 16-byte alignment is copied to an aligned base for the wgmma
    kernels (TMA reads aligned bases only), and the copy is counted."""
    import inspect
    assert list(inspect.signature(TK.kernel_for).parameters) == [
        "dtype", "head_dim"]
    assert list(inspect.signature(TK.bwd_kernel_for).parameters) == [
        "dtype", "head_dim"]
    TK.reset_launch_counts()
    flat = torch.randn(1 + 4 * 8 * 64).to(torch.bfloat16)
    aligned = flat[8:8 + 3 * 8 * 64].view(1, 3, 8, 64)
    assert aligned.data_ptr() % 16 == 0
    assert TK._aligned(aligned, route) is aligned
    assert TK.COPIES[route] == 0
    off = flat[1:1 + 3 * 8 * 64].view(1, 3, 8, 64)
    assert off.data_ptr() % 16 != 0
    copy = TK._aligned(off, route)
    assert copy.data_ptr() % 16 == 0 and torch.equal(copy, off)
    assert TK.COPIES[route] == 1
    TK.reset_launch_counts()
    assert TK.COPIES[route] == 0


def test_launch_and_copy_counters():
    """Every route has its counter; ``flash_swa`` and ``flash_swa_bwd``
    count every launch beside them; the CPU runs the plain versions and
    counts nothing."""
    assert set(TK.LAUNCHES) == {"flash_swa", "flash_swa_wgmma",
                                "flash_swa_mma", "flash_swa_bwd",
                                "flash_swa_bwd_wgmma", "flash_swa_bwd_mma"}
    assert set(TK.COPIES) == {"flash_swa_wgmma", "flash_swa_bwd_wgmma"}
    for dtype, hd, fwd, bwd in ROUTES:
        assert fwd in TK.LAUNCHES and bwd in TK.LAUNCHES
    TK.reset_launch_counts()
    q, k, v = (torch.from_numpy(t).to(torch.bfloat16)
               for t in _qkv(64, 4, 2, 64))
    out, lse = TK.flash_swa(q, k, v, window=32, qc=16, return_lse=True)
    TK.flash_swa_bwd(q, k, v, out, lse, out, window=32, qc=16)
    assert set(TK.LAUNCHES.values()) == {0}
    assert set(TK.COPIES.values()) == {0}


def test_sources_include_the_wgmma_kernels_and_headers():
    from repro_torch.kernels import _build
    names = {p.name for p in TK.SOURCES}
    assert {"flash_swa_wgmma.cu", "flash_swa_bwd_wgmma.cu"} <= names
    for source in TK.SOURCES:
        if source.stem.endswith("wgmma"):
            assert {"tma.cuh", "wgmma.cuh"} <= {
                h.name for h in _build.included_headers(source)}


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_counts", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_wgmma_executed_flop_against_a_hand_count():
    """``chip_smoke``'s count of the flop the wgmma kernels execute, at S
    300, window 100, 2 heads of 120 (padded to 128 for Q K^T; 120 wide for
    the products that write a head).  Forward: 128-row query tiles against
    128-row KV tiles, 1 + 2 + 2 = 5 tiles.  Backward: the dq kernel's
    128-row query tiles against 64-row KV tiles, 2 + 4 + 3 = 9; the dk/dv
    kernel's 128-row key tiles (kt 0, 128, 256) against query tiles of 64
    (4 + 3 + 1), its two warpgroups' 64 key rows passing over the tiles
    without a pair of the band: 6 + 5 + 1 = 12 warpgroup steps."""
    C = _chip_smoke()
    fwd_tile = 2 * 128 * 128 * 128 + 2 * (2 * 128 * 128 * 120)
    assert C.wgmma_executed_flop(300, 100, 2, 120) == 2 * 5 * fwd_tile
    dq_tile = 2 * (2 * 128 * 64 * 128) + 2 * (2 * 128 * 64 * 120)
    kv_step = 2 * (2 * 64 * 64 * 128) + 4 * (2 * 64 * 64 * 120)
    assert C.bwd_wgmma_executed_flop(300, 100, 2, 120) == 2 * (
        9 * dq_tile + 12 * kv_step)
    # heads of 64: one 64-column box, products 64 wide; window past S is S
    assert C.wgmma_executed_flop(64, 1000, 1, 64) == (
        2 * 128 * 128 * 64 + 2 * (2 * 128 * 128 * 64))


def _in_band(queries, keys, window):
    return (keys <= queries) & (keys > queries - window)


@pytest.mark.parametrize("window", [1, 40, 64, 100, 128, 200, 1024])
@pytest.mark.parametrize("s", [1, 64, 100, 128, 200, 257, 300, 520])
def test_wgmma_walks_cover_the_band_once(s, window):
    """``kernel.wgmma_band_walk`` (the forward's and the dq kernel's walk)
    and ``wgmma_dkdv_walk`` against brute force: every (query, key) pair of
    the band lies in exactly one tile a kernel computes, a tile is masked
    for a warpgroup's 64 rows exactly where one of its pairs lies outside
    the band (or, for dk/dv, past S), and a dk/dv warpgroup passes over
    exactly the query tiles without a pair of the band."""
    w = min(window, s)          # what the wrapper passes
    q = np.arange(s)[:, None]
    band = _in_band(q, q.T, w)
    rows = np.arange(TK.WGMMA_ROWS)
    for rows_q, rows_kv in ((TK.WGMMA_FWD_Q, TK.WGMMA_FWD_KV),
                            (TK.WGMMA_DQ_Q, TK.WGMMA_DQ_KV)):
        cover = np.zeros((s, s), np.int64)
        for q0 in range(0, s, rows_q):
            walk = TK.wgmma_band_walk(q0, s, w, rows_q, rows_kv)
            for kt, masked in walk:
                assert kt % rows_kv == 0
                keys = np.arange(kt, kt + rows_kv)[None, :]
                assert masked == tuple(
                    not _in_band(r0 + rows[:, None], keys, w).all()
                    for r0 in range(q0, q0 + rows_q, TK.WGMMA_ROWS))
                cover[q0:q0 + rows_q, kt:kt + rows_kv] += 1
        assert cover.max() <= 1 and (cover[band] == 1).all(), (rows_q,
                                                               rows_kv)
    cover = np.zeros((s, s), np.int64)
    for kt in range(0, s, TK.WGMMA_DKDV_KV):
        for qs, states in TK.wgmma_dkdv_walk(kt, s, w):
            queries = qs + np.arange(TK.WGMMA_DKDV_Q)[:, None]
            want = []
            for kr0 in range(kt, kt + TK.WGMMA_DKDV_KV, TK.WGMMA_ROWS):
                pairs = _in_band(queries, kr0 + rows[None, :], w) & (
                    queries < s)
                want.append("skip" if not pairs.any() else
                            "whole" if pairs.all() else "masked")
                if want[-1] != "skip":
                    cover[qs:qs + TK.WGMMA_DKDV_Q,
                          kr0:kr0 + TK.WGMMA_ROWS] += 1
            assert states == tuple(want), (kt, qs)
    assert cover.max() <= 1 and (cover[band] == 1).all()
