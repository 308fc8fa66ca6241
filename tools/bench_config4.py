"""Config-4 at paper scale: rebuild 4 of 64 bins + filter update + remap.

BASELINE.json config 4 is "rebuild 4/64 bins, remap 1M reads" — the titular
DREAM property (reference src/d_update_filter.cpp updateFilter [U]): an
update costs O(changed bins) + O(filter), not O(database). Round-2 numbers
were an 8 x 1.5 Mbp toy; this measures the real geometry: the config-3
database (64 x 32 Mbp, tools/bench_config3.py cache) with 4 bins replaced.

Reports:
  - per-bin FM rebuild wall (x4, parallel like the indexer -t path)
  - filter column clear + re-insert wall (O(filter), not O(db))
  - extrapolated full-DB rebuild wall (64-bin build, measured per-bin x 64)
  - remap of 1M reads on the updated DB + spot-check that reads planted in
    the NEW bin content map there

Run AFTER tools/bench_config3.py --build-only:
  python tools/bench_config4.py [n_reads]
"""

from __future__ import annotations

import json
import sys
import time
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent.parent))
sys.path.insert(0, str(Path(__file__).parent))

from bench_config3 import BIN_BP, BINS, CACHE, READ_LEN, make_reads  # noqa: E402

REPLACED = [3, 17, 42, 63]


def _rebuild_bin(b: int) -> float:
    """New genome for bin b -> FM rebuild (the indexer --bin-id path)."""
    from dream_yara_tpu.index.fmindex import FMIndex
    from dream_yara_tpu.io.seqstore import SeqStore

    rng = np.random.default_rng(9000 + b)
    g = rng.integers(0, 4, BIN_BP, dtype=np.int8)
    st = SeqStore.from_seqs([f"chr{b}"], [g])
    t0 = time.time()
    fm = FMIndex.build(st.text, sample_rate=16, prefix_q=10)
    dt = time.time() - t0
    st.save(CACHE / f"new_{b:04d}.store.npz")
    fm.save(CACHE / f"new_{b:04d}.fm.npz")
    return dt


def main():
    from dream_yara_tpu.index.fmindex import FMIndex
    from dream_yara_tpu.index.ibf import InterleavedBloomFilter
    from dream_yara_tpu.io.seqstore import SeqStore

    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    if not (CACHE / "filter.npz").exists():
        sys.exit("run tools/bench_config3.py --build-only first")

    # --- 1. rebuild 4 bins (parallel, like indexer -t 4) ------------------
    t0 = time.time()
    # spawn: workers build on the host and must never inherit a JAX backend
    with ProcessPoolExecutor(
            max_workers=4,
            mp_context=multiprocessing.get_context("spawn")) as ex:
        per_bin = list(ex.map(_rebuild_bin, REPLACED))
    t_rebuild = time.time() - t0
    print(f"[c4] rebuild {len(REPLACED)} x {BIN_BP/1e6:.0f} Mbp bins: "
          f"{t_rebuild:.0f}s wall (per-bin {[f'{d:.0f}s' for d in per_bin]})",
          file=sys.stderr)

    # --- 2. filter update: clear columns + re-insert (O(filter)) ----------
    filt = InterleavedBloomFilter.load(CACHE / "filter.npz")
    new_stores = {b: SeqStore.load(CACHE / f"new_{b:04d}.store.npz")
                  for b in REPLACED}
    t0 = time.time()
    filt.clear_bins(REPLACED)
    t_clear = time.time() - t0
    t0 = time.time()
    for b in REPLACED:
        filt.add_kmers(new_stores[b].text[:-1], b)
    t_insert = time.time() - t0
    print(f"[c4] filter update: clear {t_clear:.1f}s + insert {t_insert:.1f}s "
          f"(filter {filt.words.nbytes/2**30:.2f} GiB stays in place)",
          file=sys.stderr)

    # --- 3. remap on the updated DB ---------------------------------------
    import jax

    from dream_yara_tpu.cli.common import enable_compile_cache

    enable_compile_cache()
    from dream_yara_tpu.parallel.dream_mesh import (MeshDreamMapper,
                                                    mesh_dream_stream)
    from dream_yara_tpu.pipeline.dis_mapper import DreamIndex
    from dream_yara_tpu.utils.options import MapperOptions
    from dream_yara_tpu.utils.timer import StageTimers

    stores = [new_stores[b] if b in new_stores
              else SeqStore.load(CACHE / f"{b:04d}.store.npz")
              for b in range(BINS)]
    fms = [FMIndex.load(CACHE / (f"new_{b:04d}.fm.npz" if b in new_stores
                                 else f"{b:04d}.fm.npz"))
           for b in range(BINS)]
    index = DreamIndex(stores, fms, filt, "bloom")
    mapper = MeshDreamMapper(index, MapperOptions(error_rate=0.03), lean=True)

    rng = np.random.default_rng(11)
    batches = [make_reads(stores, min(250_000, n_reads - i), rng)
               for i in range(0, n_reads, 250_000)]
    timers = StageTimers()
    # warm on the REAL batch shape: a toy-shape warmup would push the real
    # shape's compile into the timed run (same fix as bench_config3).
    warm = make_reads(stores, min(250_000, n_reads), rng)
    t0 = time.time()
    _ = b"".join(mesh_dream_stream(mapper, iter([warm]), timers=timers))
    print(f"[c4] warmup(compile): {time.time() - t0:.1f}s", file=sys.stderr)

    stats = {}
    t0 = time.time()
    out = b"".join(mesh_dream_stream(mapper, iter(batches), timers=timers,
                                     stats=stats))
    t_remap = time.time() - t0
    n_map = sum(1 for l in out.splitlines()
                if l and not l.startswith(b"@")
                and int(l.split(b"\t", 3)[1]) & 4 == 0)
    print(f"[c4] remap {n_reads} reads: {t_remap:.1f}s "
          f"({n_reads/t_remap:.0f} reads/s), mapped {n_map}", file=sys.stderr)

    # spot-check: reads planted in a REPLACED bin's new content map there
    probe = make_reads({b: stores[b] for b in range(BINS)}
                       if isinstance(stores, dict) else stores, 2048,
                       np.random.default_rng(5))
    sam = b"".join(mesh_dream_stream(mapper, iter([probe]), timers=timers))
    ok_new = sum(1 for l in sam.splitlines()
                 if l and not l.startswith(b"@")
                 and l.split(b"\t", 3)[2] in
                 {f"chr{b}".encode() for b in REPLACED}
                 and int(l.split(b"\t", 3)[1]) & 4 == 0)
    print(f"[c4] probe: {ok_new} reads mapped into replaced bins "
          f"(expect ~{2048 * len(REPLACED) // BINS})", file=sys.stderr)

    t_update_total = t_rebuild + t_clear + t_insert
    # A full rebuild pays ALL 64 FM builds AND a full filter build; the
    # measured full-DB build wall (tools/bench_config3.py --build-only,
    # same geometry, 4-way-parallel FM builds + full IBF insert) was
    # 1015 s on this host — use the conservatively scaled components:
    t_full_fm = float(np.median(per_bin)) * BINS / 4   # 4-way parallel
    t_full_filter = t_insert * BINS / len(REPLACED)    # O(db) insert
    t_full_est = t_full_fm + t_full_filter
    print(json.dumps({
        "metric": "config4 update-4-of-64-bins wall (32 Mbp bins)",
        "value": round(t_update_total, 1), "unit": "s",
        "rebuild_s": round(t_rebuild, 1),
        "filter_clear_s": round(t_clear, 2),
        "filter_insert_s": round(t_insert, 2),
        "full_rebuild_est_s": round(t_full_est, 1),
        "full_rebuild_fm_s": round(t_full_fm, 1),
        "full_rebuild_filter_s": round(t_full_filter, 1),
        "speedup_vs_full": round(t_full_est / t_update_total, 2),
        "remap_reads_per_s": round(n_reads / t_remap, 1),
    }))


if __name__ == "__main__":
    main()
