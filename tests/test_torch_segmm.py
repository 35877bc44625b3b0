"""Port parity: the segmented matmul (K5/K6 plain versions, ``ref.py``,
``ops.py``) against the live JAX reference.

The reference's segmm runs in Pallas interpret mode, imported through the
batching-table swap of ``_torch_parity``.  Tolerances: bitwise on
integer-valued data (every sum exact in float32), rtol/atol 1e-4 on real
data and 5e-2 for bfloat16 (the reference's own, ``tests/test_kernels.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import ExecutionPath, Schedule
from repro_torch.core.autotune import Plan
from repro_torch.kernels.segmm import kernel as TK
from repro_torch.kernels.segmm import ops as TO
from repro_torch.kernels.segmm import ref as TR

from _torch_parity import assert_bitwise, np_of, reference_modules
from _torch_parity import isolated_autotune_cache  # noqa: F401 (autouse)

#: The reference's shape cases (T, K, N, E, bm, bn, bk), plus bm = 8 (the
#: wavefront level GEMM's default).
CASES = [
    (256, 64, 64, 4, 32, 32, 32),
    (300, 64, 96, 5, 32, 96, 64),
    (64, 128, 128, 8, 64, 128, 128),
    (512, 32, 32, 1, 128, 32, 32),
    (100, 48, 80, 16, 16, 16, 16),
    (200, 128, 128, 3, 8, 128, 512),
]
POLICY_PATHS = [(s, p) for s in TO.SCHEDULE_POLICIES
                for p in ("pure", "native")]


@pytest.fixture(scope="module")
def ref():
    with reference_modules("repro.kernels.segmm.ops",
                           "repro.kernels.segmm.ref",
                           "repro.kernels.segmm.kernel") as modules:
        yield modules


@pytest.fixture
def autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "at.json"))
    monkeypatch.delenv("REPRO_AUTOTUNE_MEASURE", raising=False)


def _data(T, K, N, E, *, integer: bool, seed: int = 0, experts=None):
    rng = np.random.default_rng(seed + T + E)
    draw = ((lambda shape: rng.integers(-3, 4, shape)) if integer
            else rng.standard_normal)
    tokens = draw((T, K)).astype(np.float32)
    eot = (rng.integers(0, E, T) if experts is None
           else np.asarray(experts)).astype(np.int32)
    rhs = draw((E, K, N)).astype(np.float32)
    return tokens, eot, rhs


def _ref_gmm(ref, tokens, eot, rhs, **kw):
    import jax.numpy as jnp
    ops, _, _ = ref
    return np.asarray(ops.grouped_matmul(
        jnp.asarray(tokens), jnp.asarray(eot), jnp.asarray(rhs), **kw))


def _port_gmm(tokens, eot, rhs, **kw):
    return TO.grouped_matmul(torch.from_numpy(tokens),
                             torch.from_numpy(eot), torch.from_numpy(rhs),
                             **kw)


class TestGroupedMatmul:
    @pytest.mark.parametrize("schedule,path", POLICY_PATHS)
    @pytest.mark.parametrize("case", CASES, ids=str)
    def test_integer_valued_bitwise(self, ref, case, schedule, path):
        T, K, N, E, bm, bn, bk = case
        tokens, eot, rhs = _data(T, K, N, E, integer=True)
        kw = dict(num_experts=E, bm=bm, bn=bn, bk=bk, schedule=schedule,
                  execution_path=path)
        want = _ref_gmm(ref, tokens, eot, rhs, **kw)
        got = _port_gmm(tokens, eot, rhs, **kw)
        assert got.dtype == torch.float32 and got.shape == (T, N)
        assert_bitwise(got, want, f"{schedule}/{path}")

    @pytest.mark.parametrize("case", CASES, ids=str)
    def test_real_valued(self, ref, case):
        T, K, N, E, bm, bn, bk = case
        tokens, eot, rhs = _data(T, K, N, E, integer=False)
        want = np.asarray(ref[1].grouped_matmul_ref(tokens, eot, rhs))
        base = _port_gmm(tokens, eot, rhs, num_experts=E, bm=bm, bn=bn,
                         bk=bk)
        np.testing.assert_allclose(np_of(base), want, rtol=1e-4, atol=1e-4)
        for schedule, path in POLICY_PATHS:
            got = _port_gmm(tokens, eot, rhs, num_experts=E, bm=bm, bn=bn,
                            bk=bk, schedule=schedule, execution_path=path)
            np.testing.assert_allclose(np_of(got), np_of(base), rtol=1e-4,
                                       atol=1e-4)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_dtypes(self, ref, dtype):
        import jax.numpy as jnp
        tokens, eot, rhs = _data(96, 32, 32, 4, integer=False, seed=5)
        t = torch.from_numpy(tokens).to(dtype)
        r = torch.from_numpy(rhs).to(dtype)
        want = ref[1].grouped_matmul_ref(
            jnp.asarray(t.float().numpy()), jnp.asarray(eot),
            jnp.asarray(r.float().numpy()))
        tol = 5e-2 if dtype == torch.bfloat16 else 1e-4
        for schedule, path in POLICY_PATHS:
            got = TO.grouped_matmul(t, torch.from_numpy(eot), r,
                                    num_experts=4, bm=32, bn=32, bk=32,
                                    schedule=schedule, execution_path=path)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(np_of(got), np.asarray(want),
                                       rtol=tol, atol=tol)

    @pytest.mark.parametrize("routing", ["collapsed", "skewed", "uniform"])
    def test_auto_picks_the_reference_policy(self, ref, autotune_cache,
                                             routing):
        import jax.numpy as jnp
        T, E = 512, 16
        rng = np.random.default_rng(3)
        eot = {"collapsed": np.full(T, 3),
               "skewed": np.minimum(rng.zipf(1.5, T) - 1, E - 1),
               "uniform": rng.integers(0, E, T)}[routing].astype(np.int32)
        want = ref[0].resolve_schedule(jnp.asarray(eot), E, measure=False)
        assert TO.resolve_schedule(torch.from_numpy(eot), E) == want
        tokens, _, rhs = _data(T, 32, 32, E, integer=True)
        assert_bitwise(
            _port_gmm(tokens, eot, rhs, num_experts=E, bm=32, bn=32, bk=32,
                      schedule="auto"),
            _ref_gmm(ref, tokens, eot, rhs, num_experts=E, bm=32, bn=32,
                     bk=32, schedule="auto", measure=False))

    def test_collapsed_routing(self, ref):
        tokens, eot, rhs = _data(128, 32, 48, 8, integer=True,
                                 experts=np.full(128, 3))
        for schedule, path in POLICY_PATHS:
            kw = dict(num_experts=8, bm=32, bn=48, bk=32, schedule=schedule,
                      execution_path=path)
            assert_bitwise(_port_gmm(tokens, eot, rhs, **kw),
                           _ref_gmm(ref, tokens, eot, rhs, **kw))

    def test_unknown_policy_raises(self):
        tokens, eot, rhs = _data(8, 8, 8, 2, integer=True)
        with pytest.raises(ValueError, match="unknown segmm schedule"):
            _port_gmm(tokens, eot, rhs, num_experts=2, bm=8,
                      schedule="round_robin")


class TestLevelGroupedMatmul:
    @pytest.mark.parametrize("plan", [
        Plan(Schedule.CHUNKED, ExecutionPath.NATIVE),
        Plan(Schedule.CHUNKED, ExecutionPath.PURE),
        Plan(Schedule.MERGE_PATH, ExecutionPath.NATIVE), None])
    def test_plan_routing(self, ref, plan):
        import jax.numpy as jnp
        from repro.core import ExecutionPath as JPath, Schedule as JSched
        from repro.core.autotune import Plan as JPlan
        tokens, ops, rhs = _data(77, 16, 16, 3, integer=True)
        jplan = None if plan is None else JPlan(JSched(plan.schedule.value),
                                                JPath(plan.path.value))
        if plan is not None:
            assert TO.plan_policy(plan) == ref[0].plan_policy(jplan)
        want = ref[0].level_grouped_matmul(
            jnp.asarray(tokens), jnp.asarray(ops), jnp.asarray(rhs),
            num_ops=3, plan=jplan)
        got = TO.level_grouped_matmul(torch.from_numpy(tokens),
                                      torch.from_numpy(ops),
                                      torch.from_numpy(rhs), num_ops=3,
                                      plan=plan)
        assert_bitwise(got, want)


class TestKernelsPlainVersions:
    """K5/K6 wrappers on CPU tensors run their plain versions."""

    @pytest.mark.parametrize("bm", [8, 32])
    def test_k5_against_reference_kernel(self, ref, bm):
        import jax.numpy as jnp
        rng = np.random.default_rng(bm)
        nblk, K, N, E = 6, 32, 64, 3
        lhs = rng.integers(-3, 4, (nblk * bm, K)).astype(np.float32)
        rhs = rng.integers(-3, 4, (E, K, N)).astype(np.float32)
        be = np.array([0, 0, 2, 1, 2, 2], np.int32)
        want = ref[2].segmented_matmul(jnp.asarray(lhs), jnp.asarray(rhs),
                                       jnp.asarray(be), bm=bm, bn=32, bk=16)
        got = TK.segmented_matmul(torch.from_numpy(lhs),
                                  torch.from_numpy(rhs),
                                  torch.from_numpy(be), bm=bm, bn=32, bk=16)
        assert_bitwise(got, want)
        assert_bitwise(got, ref[1].segmented_matmul_ref(
            jnp.asarray(lhs), jnp.asarray(rhs), jnp.asarray(be), bm=bm))
        assert_bitwise(TR.segmented_matmul_ref(
            torch.from_numpy(lhs), torch.from_numpy(rhs),
            torch.from_numpy(be), bm=bm), want)

    def test_k6_walks_the_queue_in_place(self, ref):
        import jax.numpy as jnp
        rng = np.random.default_rng(4)
        bm, nblk, K, N, E = 16, 7, 32, 32, 4
        lhs = rng.integers(-3, 4, (nblk * bm, K)).astype(np.float32)
        rhs = rng.integers(-3, 4, (E, K, N)).astype(np.float32)
        be = np.array([0, 1, 1, 3, 2, 2, 3], np.int32)
        # two queues popping every block once; slot 7 is past queue 1's end
        chunks = np.array([6, 2, 0, 5, 1, 3, 4, 0], np.int32)
        counts = np.array([4, 3], np.int32)
        args = (lhs, rhs, be, chunks, counts)
        want = ref[2].segmented_matmul_chunked(
            *map(jnp.asarray, args), bm=bm, bn=32, bk=32, max_chunks=4)
        got = TK.segmented_matmul_chunked(
            *map(torch.from_numpy, args), bm=bm, bn=32, bk=32, max_chunks=4)
        assert_bitwise(got, want)
        assert_bitwise(got, TK.segmented_matmul(
            *map(torch.from_numpy, args[:3]), bm=bm, bn=32, bk=32))

    def test_unpopped_blocks_and_bad_experts_are_zero(self):
        lhs = torch.ones((4 * 8, 8))
        rhs = torch.ones((2, 8, 8))
        be = torch.tensor([0, 1, 5, -1], dtype=torch.int32)
        out = TK.segmented_matmul(lhs, rhs, be, bm=8)
        assert (out[:16] == 8).all() and (out[16:] == 0).all()
        chunked = TK.segmented_matmul_chunked(
            lhs, rhs, be, torch.tensor([1, 0], dtype=torch.int32),
            torch.tensor([1], dtype=torch.int32), bm=8, max_chunks=2)
        assert (chunked[8:16] == 8).all() and (chunked[:8] == 0).all()

    @pytest.mark.parametrize("shapes,kw,match", [
        (((30, 8), (2, 8, 8), 3), dict(bm=8), "multiple of bm"),
        (((32, 12), (2, 12, 8), 4), dict(bm=8, bk=8), "multiples of bk"),
        (((32, 8), (2, 8, 12), 4), dict(bm=8, bn=8), "multiples of bk"),
        (((32, 8), (2, 4, 8), 4), dict(bm=8), "depth"),
        (((32, 8), (2, 8, 8), 3), dict(bm=8), "block_expert has"),
    ])
    def test_reference_assertions(self, shapes, kw, match):
        (m, k), rshape, nblk = shapes
        with pytest.raises(ValueError, match=match):
            TK.segmented_matmul(torch.zeros(m, k), torch.zeros(rshape),
                                torch.zeros(nblk, dtype=torch.int32), **kw)

    def test_bk_bn_clamp_to_the_operand(self):
        lhs = torch.ones((16, 24))
        rhs = torch.ones((1, 24, 40))
        be = torch.zeros(2, dtype=torch.int32)
        out = TK.segmented_matmul(lhs, rhs, be, bm=8, bn=128, bk=512)
        assert out.shape == (16, 40) and (out == 24).all()


def test_grouped_matmul_oracle_matches_reference(ref):
    tokens, eot, rhs = _data(50, 16, 24, 5, integer=True)
    assert_bitwise(TR.grouped_matmul_ref(torch.from_numpy(tokens),
                                         torch.from_numpy(eot),
                                         torch.from_numpy(rhs)),
                   np.asarray(ref[1].grouped_matmul_ref(tokens, eot, rhs)))


class TestLaunchGeometry:
    """K5/K6 launch geometry (plain Python: no card needed) at the smoke
    run's shapes, against an H100's 132 SMs and a smaller card's 58."""

    #: (atoms, experts, bm, N) of the MoE's w1 and w2 GEMMs (4,096 tokens x
    #: top-8 over 64 experts, bm 128, N 1,024 / 2,048) and the forest's
    #: level GEMM (438,443 nodes, 2 ops, bm 8, N 128).
    SHAPES = {"moe_w1": (4096 * 8, 64, 128, 1024),
              "moe_w2": (4096 * 8, 64, 128, 2048),
              "forest_level": (438_443, 2, 8, 128)}

    @classmethod
    def _queue(cls, shape):
        """The native chunked_lpt queue ``segmm_operands`` lays out for
        ``shape``; the queue does not depend on K, so tokens are 1 wide."""
        rng = np.random.default_rng(0)
        atoms, experts, bm, n_dim = cls.SHAPES[shape]
        eot = torch.from_numpy(rng.integers(0, experts, atoms))
        ops = TO.segmm_operands(torch.zeros((atoms, 1)), eot,
                                num_experts=experts, bm=bm,
                                schedule="chunked_lpt", path="native")
        _, counts, cmax = ops.queue
        return ops.num_blocks, counts.tolist(), cmax, bm, n_dim

    @pytest.mark.parametrize("sms", [132, 58])
    @pytest.mark.parametrize("shape", sorted(SHAPES))
    def test_team_pops_every_slot_once(self, shape, sms):
        nblk, counts, cmax, bm, n_dim = self._queue(shape)
        num_physical, tiles = len(counts), TK.column_tiles(n_dim)
        team, ctas = TK.queues_grid(num_physical, cmax, bm, n_dim)
        assert 1 <= team <= cmax
        assert ctas == num_physical * team * tiles
        assert sms <= ctas <= TK.MAX_GRID
        popped = {}
        for cta in range(ctas):
            q, tile, slots = TK.queue_pops(
                cta, num_physical=num_physical, n_tiles=tiles,
                counts=counts, max_chunks=cmax, bm=bm)
            assert slots == sorted(slots)
            assert len(slots) <= TK.block_group(bm)
            for s in slots:
                key = (q, tile, s)
                assert key not in popped, key
                popped[key] = cta
        want = {(q, tile, s) for q in range(num_physical)
                for tile in range(tiles) for s in range(counts[q])}
        assert set(popped) == want
        assert sum(counts) == nblk

    @pytest.mark.parametrize("shape", sorted(SHAPES))
    def test_k5_grid(self, shape):
        nblk, _, _, bm, n_dim = self._queue(shape)
        grid = TK.blocks_grid(nblk, bm, n_dim)
        group = TK.block_group(bm)
        assert 132 <= grid <= TK.MAX_GRID
        assert (grid // TK.column_tiles(n_dim) - 1) * group < nblk <= (
            grid // TK.column_tiles(n_dim)) * group

    @pytest.mark.parametrize("bm,group", [(8, 16), (16, 8), (32, 4),
                                          (100, 1), (128, 1), (256, 1)])
    def test_block_group_fills_one_tile(self, bm, group):
        assert TK.block_group(bm) == group
        assert bm * group <= TK.TILE_M or group == 1

    @pytest.mark.parametrize("num_physical,cmax,bm,n_dim,team,ctas", [
        (8, 40, 128, 1024, 40, 2560),     # MoE w1: one M-block per CTA
        (8, 41, 128, 2048, 41, 5248),
        (8, 6851, 8, 128, 429, 3432),     # the forest: 16 M-blocks per CTA
        (8, 16, 8, 130, 1, 16),           # a team of one, two N tiles
        (8, 17, 8, 128, 2, 16),
        (4, 3, 256, 100, 3, 12),          # N below one tile
        (0, 1, 8, 128, 1, 0),             # no queues: no CTA
    ])
    def test_queues_grid(self, num_physical, cmax, bm, n_dim, team, ctas):
        assert TK.queue_team(cmax, bm) == team
        assert TK.queues_grid(num_physical, cmax, bm, n_dim) == (team, ctas)
