#!/usr/bin/env python3
"""Time the ordered float sums of the graph and forest paths on one CUDA
card, for the port whose sources are under ``--src``.

At three shapes of the main paths it times, on real partials,
``core.execute.fixup_partials`` as the port runs it and
``core.segops.ordered_sum`` over the same bins (a stable sort of the bins'
tile ids, then the sorted kernel): PageRank's fixup (one column of the
soc-LiveJournal1-scale graph's ``chunked_lpt`` plan, as ``chip_smoke.py``
builds it), the served stream's fixup (8 lanes of the same plan) and the
forest combine's fixup (128 columns, one level of the SST-scale forest's
``chunked_lpt`` plan).  CUDA events, mean of 10 calls after 2 warm-up
calls.  ``--src`` may point at another checkout's ``src`` (for instance a
parent commit unpacked with ``git archive``), so two versions are timed in
one call, on one card.  Exits 2 without a card.

    python3 tools/time_ordered_sums.py [--src DIR] [--seed N]
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
        print("time_ordered_sums: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    import repro_torch
    from repro_torch.core import execute as E
    from repro_torch.core import segops
    from repro_torch.sparse import build_advance
    from repro_torch.sparse.wavefront import pack_forest

    cs.log(f"port: {pathlib.Path(repro_torch.__file__).parent}")
    _, sms = cs.phase_card()
    num_blocks = cs.BLOCKS_PER_SM * sms
    _, g, _, _ = cs.phase_data(args.seed, num_blocks)
    plan = build_advance(g, schedule="chunked_lpt", num_blocks=num_blocks,
                         path="native")
    forest = cs.phase_forest_data(args.seed)
    fplan = cs.forest_k2_operands(forest, pack_forest(forest["trees"]).dag,
                                  args.seed)[0]
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 40)
    cases = []
    for name, p, width in (("PageRank's fixup", plan, None),
                           ("serving fixup, 8 lanes", plan, 8),
                           ("forest combine fixup", fplan, 128)):
        spec, part = p.spec, p.part
        local_tiles = E._window_sizes(spec, part)[1]
        shape = (part.num_blocks, local_tiles) + (
            () if width is None else (width,))
        cases.append((name, spec, part, local_tiles,
                      torch.randn(shape, generator=gen, device="cuda")))
    for name, spec, part, local_tiles, partials in cases:
        gtid = part.tile_starts[:-1, None].long() + torch.arange(
            local_tiles, device="cuda")[None, :]
        ids = torch.where(gtid < spec.num_tiles, gtid,
                          spec.num_tiles).reshape(-1)
        flat = partials.reshape((ids.shape[0],) + tuple(partials.shape[2:]))
        fixup = cs.cuda_ms(lambda: E.fixup_partials(spec, part, partials,
                                                    local_tiles))
        ordered = cs.cuda_ms(lambda: segops.ordered_sum(
            flat, ids, spec.num_tiles + 1))
        cs.log(f"ordered sums [{name}: {tuple(partials.shape)} partials "
               f"into {spec.num_tiles} tiles]: fixup_partials {fixup:.4f} "
               f"ms; ordered_sum over the same bins (stable sort + sorted "
               f"kernel) {ordered:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
