"""The inputs the benchmark makes from a seed: the Kronecker graph, the
decoder's weights and the training batches."""
from __future__ import annotations

import pytest
import torch

from _portbench import spec

KRON = {"scale": 8, "edge_factor": 16, "initiator": [0.57, 0.19, 0.19, 0.05],
        "graph_seed": 27491095}


def _edges(g) -> set:
    offsets = g["row_offsets"].tolist()
    cols = g["col_indices"].tolist()
    return {(u, cols[e]) for u in range(len(offsets) - 1)
            for e in range(offsets[u], offsets[u + 1])}


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11, 3 * 10 ** 9])
def test_kronecker_is_a_simple_symmetric_graph_fixed_by_its_seed(seed):
    make = spec.generator("kronecker").make
    g = make(KRON, seed, "cpu")
    again = make(KRON, seed, "cpu")
    assert torch.equal(g["row_offsets"], again["row_offsets"])
    assert torch.equal(g["col_indices"], again["col_indices"])
    V, E = g["num_vertices"], g["num_edges"]
    assert V == 256 and g["edge_tuples"] == 16 * 256
    assert g["row_offsets"].dtype == g["col_indices"].dtype == torch.int32
    assert int(g["row_offsets"][-1]) == E
    edges = _edges(g)
    assert len(edges) == E                       # no duplicates
    assert all(u != v for u, v in edges)         # no self-loops
    assert all((v, u) in edges for u, v in edges)  # symmetric
    offsets = g["row_offsets"].tolist()
    for u in range(V):                           # rows sorted
        row = g["col_indices"][offsets[u]:offsets[u + 1]]
        assert bool((row[1:] > row[:-1]).all())


def test_kronecker_seeds_differ_and_keep_the_skew():
    make = spec.generator("kronecker").make
    a, b = make(KRON, 1, "cpu"), make(KRON, 2, "cpu")
    assert not torch.equal(a["col_indices"][:100], b["col_indices"][:100])
    deg = (a["row_offsets"][1:] - a["row_offsets"][:-1]).float()
    assert float(deg.max()) > 8 * float(deg[deg > 0].mean())
    uniform = make(dict(KRON, initiator=[0.25] * 4), 1, "cpu")
    udeg = (uniform["row_offsets"][1:] - uniform["row_offsets"][:-1]).float()
    assert float(udeg.max()) < float(deg.max())


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_kronecker_graph_seed_keeps_the_offsets_and_moves_the_columns(seed):
    make = spec.generator("kronecker").make
    base = spec.generator("kronecker").draw(KRON, KRON["graph_seed"], "cpu")
    g = make(KRON, seed, "cpu")
    assert torch.equal(g["row_offsets"], base["row_offsets"])
    assert torch.equal(g["row_offsets"], make(KRON, seed + 1,
                                              "cpu")["row_offsets"])
    assert not torch.equal(g["col_indices"], base["col_indices"])
    assert torch.equal(g["col_indices"], make(KRON, seed, "cpu")[
        "col_indices"])
    edges, base_edges = _edges(g), _edges(base)
    assert len(edges) == g["num_edges"] == base["num_edges"]
    assert all(u != v and (v, u) in edges for u, v in edges)
    offsets = g["row_offsets"].tolist()
    for u in range(g["num_vertices"]):           # rows sorted
        row = g["col_indices"][offsets[u]:offsets[u + 1]]
        assert bool((row[1:] > row[:-1]).all())
    # relabelled, each vertex onto one of its degree: the degrees at both
    # ends of the edges are those of the drawn graph
    deg = g["row_offsets"].diff().tolist()
    assert sorted((deg[u], deg[v]) for u, v in edges) == sorted(
        (deg[u], deg[v]) for u, v in base_edges)


def test_decoder_weights_are_fixed_by_the_seed_leaf_by_leaf():
    from _portbench import TINY_MODEL
    W = spec.generator("lm_weights")
    tree = W.make(TINY_MODEL, 3, "cpu")
    paths = [p for p, _ in W.leaves(tree)]
    assert paths == [p for p, _, _, _ in W.layout(TINY_MODEL)]
    for path, t in W.leaves(tree):
        assert torch.equal(t, W.leaf(TINY_MODEL, 3, path, "cpu"))
    wq = tree["layers"]["attn"]["wq"]
    assert wq.shape == (2, 64, 64) and float(wq.abs().max()) <= (3 / 64) ** .5
    assert not torch.equal(wq, W.make(TINY_MODEL, 4, "cpu")["layers"]["attn"]
                           ["wq"])
    assert bool((tree["layers"]["ln1"]["scale"] == 1).all())


def test_batches_are_the_ports_synthetic_batches():
    from repro_torch.data.synthetic import DataConfig, batch_at
    B = spec.generator("lm_batches")
    for seed, step in ((0, 0), (5, 3), (2 ** 31 + 3, 7)):
        ours = B.batch_at(seed, step, batch=2, seq_len=96, vocab=300,
                          mean_doc_len=16, zipf_alpha=1.1, device="cpu")
        port = batch_at(DataConfig(seed=seed, vocab_size=300, seq_len=96,
                                   global_batch=2, mean_doc_len=16), step,
                        device="cpu")
        assert torch.equal(ours["tokens"], port["tokens"])
        assert torch.equal(ours["labels"], port["labels"])
