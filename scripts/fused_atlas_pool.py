#!/usr/bin/env python3
"""The fused prepare at configuration 5's atlas size on one NVIDIA GPU.

    python3 scripts/fused_atlas_pool.py [--cells N] [--share S]

Prepares a float32 DensityEstimator (5,000 landmarks) on chip_smoke.py's
1M x 50 atlas cells (``atlas_cells``, seed 0) three times: the lazy chain
(the fused prepare off), then the fused prepare twice.  At this size an
(n, k) factor passes ``fused.GRAPH_MEMORY_SHARE`` of the card's memory, so
the fused stages run eagerly and keep no graph; ``--share`` sets that
share (``--share 1`` captures: the first fused prepare runs the stages
eagerly, captures them as CUDA graphs and replays them once against the
eager run, the second replays).  Prints, as one JSON line, each prepare's
seconds and peak allocated bytes (in all, and above what was allocated
as it began), whether the stages were captured, the
stage graphs' nodes, capture seconds and memory-pool bytes, and whether
the second fused prepare equals the lazy one bit for bit (the script
fails where it does not).  At this size k-means runs on a uniform
subsample of 200,000 cells.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import torch

    if not torch.cuda.is_available():
        print("fused_atlas_pool: no CUDA device is available.", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser()
    parser.add_argument("--cells", type=int, default=None)
    parser.add_argument("--share", type=float, default=None)
    args = parser.parse_args()

    import chip_smoke
    import mellon_tpu_torch as mt
    from mellon_tpu_torch.models import fused

    if args.share is not None:
        fused.GRAPH_MEMORY_SHARE = args.share
    n = args.cells or chip_smoke.ATLAS_CELLS
    x = chip_smoke.atlas_cells(n, chip_smoke.ATLAS_DIMS, chip_smoke.ATLAS_SEED)

    def make():
        return mt.DensityEstimator(n_landmarks=chip_smoke.ATLAS_LANDMARKS, device=chip_smoke.DEVICE)

    stats, prepared = {}, {}
    for label, enabled in (("lazy", False), ("first", True), ("second", True)):
        # the peak above what was allocated before the prepare (the lazy
        # estimator, kept for the comparison, holds its L meanwhile)
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        est, seconds = chip_smoke.fused_prepare(fused, make, (x,), enabled)
        stats[label] = {"seconds": seconds, "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
                        "peak_above_start_bytes": torch.cuda.max_memory_allocated() - start}
        if label != "first":
            prepared[label] = est
        del est
    pools = chip_smoke.graph_pool_bytes(fused)
    stats["graphs"] = [dict(g, pool_bytes=pools.get(g["slot"])) for g in fused.graph_stats()]
    differ = [name for name in chip_smoke.FUSED_FIELDS["density"]
              if not chip_smoke.same_bits(getattr(prepared["second"], name),
                                          getattr(prepared["lazy"], name))]
    stats.update(cells=[n, chip_smoke.ATLAS_DIMS], device=torch.cuda.get_device_name(0),
                 graph_memory_share=fused.GRAPH_MEMORY_SHARE,
                 captured=bool(fused._GRAPHS),
                 landmarks_kept=int(prepared["second"].landmarks.shape[0]),
                 bit_identical=not differ)
    print(json.dumps(stats), flush=True)
    if differ:
        raise AssertionError(f"the second fused atlas prepare differs from the lazy one in {differ}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
