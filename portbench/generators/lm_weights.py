"""A decoder's float32 master weights, drawn on the device from a seed.

The tree is the port's layout (``repro_torch.models.lm``): ``embed [V,
D]``, ``lm_head [D, V]``, ``ln_f/scale [D]``, and under ``layers`` each
layer's leaves stacked ``[L, ...]``: ``ln1``/``ln2`` scales, ``attn``
``wq [D, H hd]``, ``wk``/``wv [D, Hkv hd]``, ``wo [H hd, D]``, and ``mlp``
``w1``/``w3 [D, F]``, ``w2 [F, D]``.  Matrices are ``U(-s, s)`` with ``s =
sqrt(3 / fan_in)`` (the port's initializer's scales), norm scales are 1.

Each leaf is one ``torch.rand`` call from a generator of its own, seeded
from ``(seed, leaf)``: a few large calls, and any single leaf can be drawn
again (:func:`leaf`) to compare a trained leaf with where it started.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

#: (path, shape of one layer or of the whole leaf, fan-in, stacked)
Layout = List[Tuple[str, Tuple[int, ...], int, bool]]


def layout(model: dict) -> Layout:
    D, F = int(model["d_model"]), int(model["d_ff"])
    hd = int(model["head_dim"])
    H, Hkv = int(model["num_heads"]), int(model["num_kv_heads"])
    V = -(-int(model["vocab_size"]) // 256) * 256   # the port pads to 256
    return [
        ("embed", (V, D), D, False),
        ("lm_head", (D, V), D, False),
        ("ln_f/scale", (D,), 0, False),
        ("layers/ln1/scale", (D,), 0, True),
        ("layers/ln2/scale", (D,), 0, True),
        ("layers/attn/wq", (D, H * hd), D, True),
        ("layers/attn/wk", (D, Hkv * hd), D, True),
        ("layers/attn/wv", (D, Hkv * hd), D, True),
        ("layers/attn/wo", (H * hd, D), D, True),
        ("layers/mlp/w1", (D, F), D, True),
        ("layers/mlp/w3", (D, F), D, True),
        ("layers/mlp/w2", (F, D), F, True),
    ]


def _mix(seed: int, index: int) -> int:
    return (int(seed) * 0x9E3779B97F4A7C15 + (index + 1) * 0xBF58476D1CE4E5B9
            ) % (1 << 63)


def leaf(model: dict, seed: int, path: str, device) -> torch.Tensor:
    """Leaf ``path`` as :func:`make` draws it."""
    L = int(model["num_layers"])
    for index, (name, shape, fan_in, stacked) in enumerate(layout(model)):
        if name != path:
            continue
        full = (L, *shape) if stacked else shape
        if not fan_in:
            return torch.ones(full, dtype=torch.float32, device=device)
        gen = torch.Generator(device=device).manual_seed(_mix(seed, index))
        scale = (3.0 / fan_in) ** 0.5
        out = torch.rand(full, generator=gen, dtype=torch.float32,
                         device=device)
        return out.mul_(2.0 * scale).sub_(scale)
    raise KeyError(path)


def make(model: dict, seed: int, device) -> Dict:
    """The whole tree, nested as the port nests it."""
    tree: Dict = {}
    for path, _, _, _ in layout(model):
        *parents, name = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf(model, seed, path, device)
    return tree


def leaves(tree, prefix: str = ""):
    """``(path, tensor)`` of a nested tree, in its order."""
    for name, value in tree.items():
        path = f"{prefix}/{name}" if prefix else name
        if isinstance(value, dict):
            yield from leaves(value, path)
        else:
            yield path, value
