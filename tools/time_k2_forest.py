#!/usr/bin/env python3
"""Time K2 (``chunk_walk_tiles``) at the TreeLSTM forest's shapes on one
CUDA card, for the port whose sources are under ``--src``.

Builds the SST-scale forest of ``chip_smoke.phase_forest_data`` and runs
``chip_smoke.phase_k2_forest`` on one level of its ``chunked_lpt`` plan:
the one-column launch of the in-degree update and the 128-column launch of
a level's combine, each against its plain version and beside its byte
bound and ``index_add_``, then the ordered sums of the level: the
combine's fixup (``segment_sum_fixup``) and the pure path's partial sums
(``segment_sum_sorted``); a port without ``segment_sum_fixup`` skips them
(``tools/time_ordered_sums.py`` times the sums of two versions).
``--per-column`` times the combine as 128 one-column launches instead,
for a port whose K2 takes one column.  ``--src`` may point at another
checkout's ``src`` (for instance a parent commit unpacked with ``git
archive``), so two versions are timed in one call, on one card.  Exits 2
without a card.

    python3 tools/time_k2_forest.py [--src DIR] [--per-column] [--seed N]
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
    parser.add_argument("--per-column", action="store_true",
                        help="time the combine as 128 one-column launches "
                             "(a port whose K2 takes one column)")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("time_k2_forest: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    import repro_torch
    from repro_torch.sparse.wavefront import pack_forest

    chip_smoke.log(f"port: {pathlib.Path(repro_torch.__file__).parent}")
    chip_smoke.phase_card()
    forest = chip_smoke.phase_forest_data(args.seed)
    dag = pack_forest(forest["trees"]).dag
    chip_smoke.phase_k2_forest(forest, dag, args.seed,
                               per_column=args.per_column)
    return 0


if __name__ == "__main__":
    sys.exit(main())
