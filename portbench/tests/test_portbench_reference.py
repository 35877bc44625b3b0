"""The plain references agree with the port's CPU path at a small size,
and import nothing of the port."""
from __future__ import annotations

import ast

import pytest
import torch

from _portbench import ROOT, small_run, spec

REFERENCE = sorted((ROOT / "portbench" / "reference").glob("*.py"))


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom)
                 else [])
        for name in names:
            assert name.split(".")[0] in {"__future__", "math", "typing",
                                          "torch"}, (path.name, name)


def test_round_tf32_keeps_ten_mantissa_bits():
    from portbench.reference.pagerank import round_tf32
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      1.0 + 2 ** -12, 0.0, 3e-30], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, 1.0, 0.0],
                        dtype=torch.float32)
    assert torch.equal(round_tf32(x)[:6], want)
    assert float(round_tf32(x)[6]) == pytest.approx(3e-30, rel=2 ** -10)


def test_pagerank_reference_agrees_with_the_ports_cpu_path():
    from repro_torch.sparse import graph as G
    from repro_torch.sparse.formats import CSR
    from portbench.reference import pagerank as ref
    g = spec.generator("kronecker").make(
        {"scale": 9, "edge_factor": 16, "initiator": [0.57, 0.19, 0.19, 0.05],
         "graph_seed": 27491095}, 3, "cpu")
    V, E = g["num_vertices"], g["num_edges"]
    graph = G.Graph(CSR(g["row_offsets"], g["col_indices"], torch.ones(E),
                        (V, V), E))
    got = G.pagerank(graph, damping=0.85, num_iters=20, tol=0.0)
    want = ref.pagerank(g["row_offsets"], g["col_indices"], damping=0.85,
                        num_iters=20)
    assert ref.rank_gap(got, want) < 1e-5
    assert abs(float(want.sum()) - 1.0) < 1e-12
    control = ref.pagerank_tf32(g["row_offsets"], g["col_indices"],
                                damping=0.85, num_iters=20)
    assert ref.rank_gap(control, want) > 10 * ref.rank_gap(got, want)


def test_decoder_reference_follows_the_ports_float32_steps():
    """The port's step in float32 against the reference: three losses,
    first gradients and changes all but equal."""
    result = small_run("danube_train_8k")
    assert result["correct"]
    for name, check in result["checks"].items():
        assert check["value"] < 1e-5, (name, check)
