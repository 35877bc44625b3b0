"""Port parity: the port's copy of the configs against the live reference
``repro.configs`` (framework-free data: every field must be equal)."""
import dataclasses

import pytest

import repro_torch.configs as TC
from repro_torch.configs import base as TB


@pytest.fixture(scope="module")
def jc():
    import repro.configs
    return repro.configs


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("arch", TB.ARCH_IDS)
def test_every_field_of_every_config(jc, arch):
    got, want = TC.get_config(arch), jc.get_config(arch)
    assert _fields(got) == _fields(want)
    assert got.resolved_head_dim == want.resolved_head_dim
    assert got.padded_vocab == want.padded_vocab
    if got.d_model % got.rwkv_head_dim == 0:
        assert got.rwkv_num_heads == want.rwkv_num_heads
    assert _fields(got.reduced()) == _fields(want.reduced())
    assert _fields(got.reduced(num_layers=3, d_ff=48)) == _fields(
        want.reduced(num_layers=3, d_ff=48))
    assert [(n, c.__dict__) for n, c in TC.cells_for(got)] == [
        (n, c.__dict__) for n, c in jc.cells_for(want)]


def test_registries(jc):
    assert TC.ARCH_IDS == jc.ARCH_IDS
    assert TC.SUBQUADRATIC == jc.SUBQUADRATIC
    assert {k: v.__dict__ for k, v in TC.SHAPES.items()} == {
        k: v.__dict__ for k, v in jc.SHAPES.items()}
    assert [c.name for c in TC.all_configs()] == [
        c.name for c in jc.all_configs()]
    assert [f.name for f in dataclasses.fields(TC.ModelConfig)] == [
        f.name for f in dataclasses.fields(jc.ModelConfig)]


def test_dashed_names_resolve():
    assert TC.get_config("olmoe-1b-7b") is TC.get_config("olmoe_1b_7b")
    assert type(TC.get_config("qwen15_05b")) is TC.ModelConfig
