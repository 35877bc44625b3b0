"""Port parity: the roofline (``launch/roofline.py``).

The six cases of ``tests/test_roofline.py`` run through the port on the
same inputs: the HLO text parser and its ring factors, unit composition,
terms and bottleneck (at the port's H100 constants), ``model_flops``; then
the same ring factors applied to a mesh's collective record
(``stats_wire_bytes``), here recorded by real collectives on a one-rank
gloo group and against the HLO parse of the same calls.
"""
import numpy as np
import pytest

from repro_torch.configs import SHAPES
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import CollectiveStats

from _torch_parity import reference_modules

HLO_SNIPPET = """
ENTRY main {
  %ar = f32[128,1024]{1,0} all-reduce(f32[128,1024]{1,0} %x), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag = bf16[64,4096]{1,0} all-gather(bf16[4,4096]{1,0} %y), replica_groups=[16,16]<=[256], dimensions={0}
  %rs = f32[8,32]{1,0} reduce-scatter(f32[64,32]{1,0} %z), replica_groups={{0,1,2,3,4,5,6,7}}, to_apply=%add
  %a2a = s32[16,16]{1,0} all-to-all(s32[16,16]{1,0} %w), replica_groups={{0,1}}
  %cp = f32[100]{0} collective-permute(f32[100]{0} %v), source_target_pairs={{0,1}}
  %ars = (f32[10]{0}, f32[10]{0}) all-reduce-start(f32[10]{0} %p, f32[10]{0} %q), replica_groups={{0,1,2,3}}
}
"""


@pytest.fixture(scope="module")
def ref():
    with reference_modules("repro.launch.roofline",
                           "repro.configs") as modules:
        yield dict(zip(("roofline", "configs"), modules))


class TestCollectiveParse:
    def test_wire_bytes(self, ref):
        wire = RL.collective_wire_bytes(HLO_SNIPPET, 256)
        assert wire == ref["roofline"].collective_wire_bytes(HLO_SNIPPET,
                                                             256)
        ar_single = 2 * 128 * 1024 * 4 * 3 / 4
        ar_start = 2 * (10 * 4 * 2) * 3 / 4
        np.testing.assert_allclose(wire["all-reduce"], ar_single + ar_start)
        np.testing.assert_allclose(wire["all-gather"],
                                   64 * 4096 * 2 * 15 / 16)
        np.testing.assert_allclose(wire["reduce-scatter"],
                                   8 * 32 * 4 * 8 * 7 / 8)
        np.testing.assert_allclose(wire["all-to-all"], 16 * 16 * 4 * 1 / 2)
        np.testing.assert_allclose(wire["collective-permute"], 400)

    def test_no_collectives(self):
        wire = RL.collective_wire_bytes("%x = f32[8]{0} add(%a, %b)", 8)
        assert sum(wire.values()) == 0


class TestCompose:
    def _m(self, mod, flops, by=0.0, wire=0.0):
        kinds = {k: 0.0 for k in RL.KINDS}
        kinds["all-reduce"] = wire
        return mod.CellMetrics(flops=flops, hbm_bytes=by, wire_bytes=wire,
                               wire_by_kind=kinds)

    def test_layer_extrapolation(self, ref):
        rest, layer = 100.0, 10.0
        u1, u2 = self._m(RL, rest + layer), self._m(RL, rest + 2 * layer)
        total = RL.compose(u1, u2, num_layers=24, n_micro=4)
        assert total.flops == 4 * (rest + 24 * layer)
        r1 = self._m(ref["roofline"], rest + layer, 7.0, 3.0)
        r2 = self._m(ref["roofline"], rest + 2 * layer, 9.0, 5.0)
        want = ref["roofline"].compose(r1, r2, num_layers=24, n_micro=4)
        got = RL.compose(self._m(RL, rest + layer, 7.0, 3.0),
                         self._m(RL, rest + 2 * layer, 9.0, 5.0),
                         num_layers=24, n_micro=4)
        assert (got.flops, got.hbm_bytes, got.wire_bytes) == (
            want.flops, want.hbm_bytes, want.wire_bytes)
        assert got.wire_by_kind == want.wire_by_kind

    def test_terms_and_bottleneck(self):
        """The reference test's metrics, at the H100 constants."""
        m = RL.CellMetrics(flops=197e12, hbm_bytes=819e9 * 2,
                           wire_bytes=50e9,
                           wire_by_kind={"all-reduce": 50e9,
                                         "all-gather": 0,
                                         "reduce-scatter": 0,
                                         "all-to-all": 0,
                                         "collective-permute": 0})
        t = m.terms()
        np.testing.assert_allclose(t["compute_s"], 197e12 / 989e12)
        np.testing.assert_allclose(t["memory_s"], 819e9 * 2 / 3.35e12)
        np.testing.assert_allclose(t["collective_s"], 50e9 / 450e9)
        assert m.bottleneck() == "memory_s"
        assert (RL.PEAK_FLOPS_BF16, RL.HBM_BW, RL.LINK_BW) == (
            989e12, 3.35e12, 450e9)


class TestModelFlops:
    def test_train_6nd(self, ref):
        assert RL.model_flops(None, SHAPES["train_4k"], 10**9) == (
            6.0 * 10**9 * 256 * 4096)
        for name in SHAPES:
            assert RL.model_flops(None, SHAPES[name], 7 * 10**8) == \
                ref["roofline"].model_flops(None, ref["configs"].SHAPES[name],
                                            7 * 10**8)

    def test_decode_is_per_token(self):
        assert RL.model_flops(None, SHAPES["decode_32k"], 10**9) == (
            2.0 * 10**9 * 128)


def test_stats_wire_bytes_apply_the_ring_factors():
    """The snippet's collectives as a mesh records them (bytes each call
    returned, by kind and group size): the same wire bytes as the HLO
    parse, plus the port's broadcast at one hop."""
    stats = CollectiveStats()
    for kind, n, nbytes in (("all-reduce", 4, 128 * 1024 * 4),
                            ("all-gather", 16, 64 * 4096 * 2),
                            ("reduce-scatter", 8, 8 * 32 * 4),
                            ("all-to-all", 2, 16 * 16 * 4),
                            ("collective-permute", 2, 400),
                            ("all-reduce", 4, 2 * 10 * 4)):
        stats.record(kind, n, nbytes, 0.0)
    assert stats.calls == 6
    assert stats.kinds[("all-reduce", 4)][:2] == [2, 128 * 1024 * 4 + 80]
    wire = RL.stats_wire_bytes(stats)
    want = RL.collective_wire_bytes(HLO_SNIPPET, 256)
    for k in RL.KINDS:
        np.testing.assert_allclose(wire[k], want[k], err_msg=k)
    assert wire["broadcast"] == 0
    stats.record("broadcast", 4, 1000, 0.0)
    stats.record("all-gather", 1, 1000, 0.0)        # one rank: no wire
    assert RL.stats_wire_bytes(stats.kinds)["broadcast"] == 1000
    m = RL.unit_metrics(5.0, 6.0, stats)
    assert m.wire_bytes == sum(RL.stats_wire_bytes(stats).values())
    with pytest.raises(ValueError, match="kind"):
        stats.record("gather", 2, 1, 0.0)
    stats.reset()
    assert (stats.calls, stats.bytes, stats.kinds) == (0, 0, {})


def test_mesh_records_by_kind():
    """A two-axis mesh of one rank: nothing is sent, nothing recorded; the
    pipeline's hop returns zeros and the broadcast its operand."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1, 1), ("pod", "data"), device="cpu")
    x = torch.ones(3)
    assert torch.equal(mesh.axis("pod").shift(x), torch.zeros(3))
    assert mesh.axis("pod").broadcast(x, 0) is x
    assert mesh.stats.kinds == {} and mesh.stats.calls == 0
    with pytest.raises(ValueError, match="no axis"):
        mesh.axis("model")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_mesh((2, 2), ("pod", "data"), device="cpu")
    with pytest.raises(ValueError, match="distinct"):
        make_mesh((1, 1), ("pod", "pod"), device="cpu")
