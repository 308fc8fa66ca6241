"""Config-2 through the routed mesh driver on ONE device.

Same workload as tools/bench_config2.py (8 x 5.8 Mbp bins, 150bp PE,
e <= 3%, IBF routing) but mapped via parallel/dream_mesh.MeshDreamMapper on
a single-device (data=1, bin=1) mesh: classify -> capacity-route -> map all
8 bins in ONE dispatch per batch, instead of 8 padded mega-chunk dispatches.
Device rows per batch drop from ~16.8 rows/read (per-bin 131072-row padding)
to ~2.6 rows/read (r_cap-compacted).

Run on the real chip: python tools/bench_config2_mesh.py [n_pairs] [r_cap]
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent.parent))
sys.path.insert(0, str(Path(__file__).parent))

from bench_config2 import BINS, LD, LL, build_or_load, make_pairs  # noqa: E402


def main():
    import jax

    from dream_yara_tpu.cli.common import enable_compile_cache

    enable_compile_cache()

    from dream_yara_tpu.parallel.dream_mesh import (MeshDreamMapper,
                                                    mesh_dream_sam,
                                                    mesh_dream_stream)
    from dream_yara_tpu.utils.options import MapperOptions
    from dream_yara_tpu.utils.timer import StageTimers

    n_pairs = int(sys.argv[1]) if len(sys.argv) > 1 else 250_000
    # default: the mapper's own shared slot-pool sizing (flat_step); an
    # explicit 2nd arg overrides (the old 40_960 per-bin figure would force
    # drain passes under the pool layout)
    r_cap = int(sys.argv[2]) if len(sys.argv) > 2 else None
    batch_pairs = min(125_000, n_pairs)
    genomes, index = build_or_load()
    opts = MapperOptions(error_rate=0.03, library_length=LL,
                         library_deviation=LD, secondary_matches="tag")

    rng = np.random.default_rng(7)
    print(f"[c2m] devices: {jax.devices()}", file=sys.stderr)
    mapper = MeshDreamMapper(index, opts, n_devices=1, r_cap=r_cap)
    print(f"[c2m] mesh {dict(mapper.mesh.shape)}, r_cap={r_cap}",
          file=sys.stderr)

    t0 = time.time()
    warm = make_pairs(genomes, index.stores, batch_pairs, rng)
    mesh_dream_sam(mapper, warm, header=False)
    print(f"[c2m] warmup: {time.time() - t0:.1f}s", file=sys.stderr)
    # second warm batch absorbs the cap auto-tuner's tuned-shape compile
    # (it engages only after the first batch's observed demands)
    t0 = time.time()
    mesh_dream_sam(mapper, warm, header=False)
    print(f"[c2m] warmup(tuned caps): {time.time() - t0:.1f}s",
          file=sys.stderr)

    batches = [make_pairs(genomes, index.stores, batch_pairs, rng)
               for _ in range(n_pairs // batch_pairs)]
    total_reads = 2 * n_pairs
    # median of 5 timed passes: single samples are not comparable
    passes = int(sys.argv[3]) if len(sys.argv) > 3 else 5
    rps_all = []
    for pi in range(passes):
        timers = StageTimers()
        stats: dict = {}
        t0 = time.time()
        n_rec = 0
        for sam in mesh_dream_stream(mapper, batches, timers=timers,
                                     stats=stats):
            n_rec += sum(1 for l in sam.splitlines()
                         if l and not l.startswith(b"@"))
        dt = time.time() - t0
        assert n_rec >= total_reads
        rps_all.append(total_reads / dt)
        print(f"[c2m] pass {pi}: {rps_all[-1]:.0f} reads/s", file=sys.stderr)
        if pi == 0:
            print(timers.report(), file=sys.stderr)
            print(f"[c2m] fallback diag: "
                  f"{getattr(mapper, 'fallback_diag', {})}", file=sys.stderr)
            mapped = stats.get("mapped", 0)
            pp = stats.get("proper_pairs", 0)
            print(f"[c2m] mapped {mapped}/{total_reads} "
                  f"({100 * mapped / total_reads:.2f}%), proper pairs {pp} "
                  f"({200 * pp / total_reads:.2f}%)", file=sys.stderr)
    rps = float(np.median(rps_all))
    print(json.dumps({
        "metric": "config2 PE reads/sec/chip (mesh-routed, 150bp, 8 bins)",
        "value": round(rps, 1),
        "unit": "reads/s",
        "vs_baseline": round(rps / 50_000.0, 3),
        "passes": [round(r, 1) for r in rps_all],
    }))


if __name__ == "__main__":
    main()
