"""Operations and bytes of the work the cells time, from their shapes."""
from __future__ import annotations


def padded_vocab(model: dict) -> int:
    """The port pads its embedding and head tables to a multiple of 256."""
    return -(-int(model["vocab_size"]) // 256) * 256


def lm_params(model: dict) -> int:
    """Parameters of a dense decoder: untied embedding and head, per layer
    two norm scales, the four attention matrices and a gated MLP."""
    D, F, hd = model["d_model"], model["d_ff"], model["head_dim"]
    H, Hkv, L = model["num_heads"], model["num_kv_heads"], model["num_layers"]
    layer = 2 * D + D * H * hd + 2 * D * Hkv * hd + H * hd * D + 3 * D * F
    return 2 * padded_vocab(model) * D + D + L * layer


def band_pairs(seq_len: int, window: int) -> int:
    """(query, key) pairs of causal attention over a sliding window:
    position ``i`` reads ``min(i + 1, window)`` keys."""
    w = min(window, seq_len)
    return w * (w + 1) // 2 + (seq_len - w) * w


def lm_step_flop(model: dict, batch: int, seq_len: int) -> int:
    """Model flop of a training step: ``6 N`` a token, ``N`` the parameters
    less the embedding table, plus ``12 L H hd`` a (query, key) pair of
    every sequence (recomputation not counted)."""
    n = lm_params(model) - padded_vocab(model) * model["d_model"]
    pairs = band_pairs(seq_len, model["sliding_window"])
    return (6 * n * batch * seq_len + 12 * model["num_layers"]
            * model["num_heads"] * model["head_dim"] * pairs * batch)


def k7_fwd_flop(model: dict, seq_len: int) -> int:
    """Flop of one K7 launch over one sequence: ``4 hd H`` a pair."""
    return (4 * model["head_dim"] * model["num_heads"]
            * band_pairs(seq_len, model["sliding_window"]))


def k7_bwd_flop(model: dict, seq_len: int) -> int:
    """Flop of K7's backward over one sequence: ``10 hd H`` a pair."""
    return (10 * model["head_dim"] * model["num_heads"]
            * band_pairs(seq_len, model["sliding_window"]))


def pagerank_iteration_bytes(V: int, E: int) -> int:
    """Least bytes of a pull PageRank iteration: offsets and columns read
    once, the previous ranks, out-degrees and new ranks once each."""
    return 4 * (V + 1) + 4 * E + 12 * V


def k2_advance_bytes(V: int, E: int) -> int:
    """Least bytes of K2 and its fixup over a full pull advance: each
    edge's value and destination read once, each vertex's sum written."""
    return 8 * E + 4 * V
