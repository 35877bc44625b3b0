#!/usr/bin/env python3
"""Time K5/K6 (``segmented_matmul``/``segmented_matmul_chunked``) on one
CUDA card at the main paths' shapes, for the port whose sources are under
``--src``.

Builds ``chip_smoke``'s MoE layer (OLMoE-1B-7B width, one 4,096-token
sequence, skew-0 routing) and SST-scale forest, and times K5 and K6 with
``chip_smoke.time_segmm_case`` (CUDA events, beside the bound, the plain
version and ``torch.bmm``) at five shapes:

* ``moe w1``: the layer's w1 GEMM in float32 (32,768 atoms, 64 experts,
  K 2,048, N 1,024; the CUDA-core routine);
* ``forest level``: the TreeLSTM's level GEMM in float32 (``bm = 8``,
  K = N = 128);
* ``moe w1 bf16``: the w1 GEMM with tokens and w1 cast to bf16 (``bm =
  128``: the wgmma route);
* ``forest level bf16``: the level GEMM with its operands cast to bf16
  (``bm = 8``: the mma.sync route);
* ``rank bf16``: the atoms of that routing on experts 0-31 against their
  bf16 w1, the shape of one rank of ``chip_smoke``'s ``(2, 2)`` MoE mesh
  (half the experts, ~16,400 atoms).

``--src`` may point at another checkout's ``src`` (for instance a parent
commit unpacked with ``git archive``), so two versions are timed in one
call, on one card.  Exits 2 without a card.

    python3 tools/time_segmm.py [--src DIR] [--seed N]
"""
from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--src", default=str(ROOT / "src"),
                        help="the port's source root (holds repro_torch)")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("time_segmm: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    import repro_torch
    from repro_torch.kernels.segmm import kernel as SK
    from repro_torch.kernels.segmm import ops as SO

    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.log(f"port: {pathlib.Path(repro_torch.__file__).parent}, "
                   f"segmm source {SK.CSRC / 'segmm.cu'}")
    chip_smoke.phase_card()
    moe = chip_smoke.phase_moe_data(args.seed)
    forest = chip_smoke.phase_forest_data(args.seed)
    cases = chip_smoke.segmm_cases(moe, forest, args.seed)
    del moe, forest
    _, tokens, experts, w1, num_experts, bm = cases[2]
    half = num_experts // 2
    mine = experts < half
    cases.append(("rank bf16", tokens[mine], experts[mine], w1[:half],
                  half, bm))
    for name, tokens, experts, rhs, num_experts, bm in cases:
        o5, o6 = (SO.segmm_operands(tokens, experts, num_experts=num_experts,
                                    bm=bm, schedule=schedule, path=path)
                  for schedule, path in (("group_mapped", "pure"),
                                         ("chunked_lpt", "native")))
        chip_smoke.time_segmm_case(name, tokens, experts, rhs, bm, o5, o6)
        del o5, o6
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
