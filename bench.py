"""Benchmark: config-1 style workload (BASELINE.json) on one GPU.

E. coli-scale single bin (4.6 Mbp), 100k x 100bp reads with <= 3 errors,
single-end, full pipeline (device map + host rank/cigar/SAM). Prints ONE
JSON line: {"metric", "value", "unit", "vs_baseline"}.

vs_baseline: the reference's own numbers are unavailable offline
(BASELINE.md — the paper reports order 10^4-10^5 reads/s on a 32-thread Xeon
server [L]); we normalize against the nominal 50_000 reads/s midpoint of that
range so the ratio is meaningful-ish across rounds.

Fails when JAX finds no GPU: a CPU number is never printed under this
metric's name.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

NOMINAL_REFERENCE_READS_PER_S = 50_000.0

GENOME_LEN = 4_600_000
N_READS = 262_144            # generated read pool (cached on disk)
BATCH = 65_536               # one 131072-row device dispatch per batch
# Each timed pass streams the pool TILE times (32 batches, 2M reads): with
# only 4 batches the pipeline-fill/drain edges dominate and the measured
# rate lands ~40% under steady state (441k vs 277k median on the same
# code/day). Device+host work is identical per batch — tiling just
# amortizes the edges, it caches nothing across batches.
TILE = 8
READ_LEN = 100
ERROR_RATE = 0.03
CACHE = Path(__file__).parent / ".bench_cache"


def build_or_load_db():
    from dream_yara_tpu.index.fmindex import FMIndex
    from dream_yara_tpu.io.seqstore import SeqStore

    CACHE.mkdir(exist_ok=True)
    store_p = CACHE / "store.npz"
    fm_p = CACHE / "fm.npz"
    if store_p.exists() and fm_p.exists():
        return SeqStore.load(store_p), FMIndex.load(fm_p)
    rng = np.random.default_rng(12345)
    genome = rng.integers(0, 4, GENOME_LEN).astype(np.int8)
    store = SeqStore.from_seqs(["ecoli_sim"], [genome])
    t0 = time.time()
    fm = FMIndex.build(store.text)
    print(f"[bench] index build: {time.time() - t0:.1f}s", file=sys.stderr)
    store.save(store_p)
    fm.save(fm_p)
    return store, fm


def make_reads(store, n_reads):
    from dream_yara_tpu.io.readstore import ReadBatch
    from dream_yara_tpu.utils.alphabet import revcomp

    rng = np.random.default_rng(999)
    text = store.text
    pos = rng.integers(0, GENOME_LEN - READ_LEN, size=n_reads)
    reads = []
    for i in range(n_reads):
        r = text[pos[i] : pos[i] + READ_LEN].copy()
        for _ in range(int(rng.integers(0, 4))):  # 0-3 substitutions
            j = int(rng.integers(0, READ_LEN))
            r[j] = (r[j] + int(rng.integers(1, 4))) % 4
        if i % 2:
            r = revcomp(r)
        reads.append(r)
    return ReadBatch.from_reads([f"r{i}" for i in range(n_reads)], reads)


def main():
    from dream_yara_tpu.pipeline.dis_mapper import (
        DreamIndex, dream_map_sam, dream_map_stream)
    from dream_yara_tpu.utils.options import MapperOptions
    from dream_yara_tpu.utils.timer import StageTimers

    import jax

    from dream_yara_tpu.cli.common import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        sys.exit(f"[bench] no GPU: JAX devices are {jax.devices()}")
    enable_compile_cache()

    store, fm = build_or_load_db()
    full = make_reads(store, N_READS)
    batches = []
    for b0 in range(0, N_READS, BATCH):
        ids = np.arange(b0, b0 + BATCH)
        n = full.n_reads
        batches.append(type(full)(
            names=[full.names[i] for i in ids],
            seqs=full.seqs[np.concatenate([ids, n + ids])],
            lengths=full.lengths[ids],
            quals=[full.quals[i] for i in ids], paired=False))
    batches = [batches[i % len(batches)] for i in range(TILE * len(batches))]
    n_total = len(batches) * BATCH
    warm = make_reads(store, BATCH)
    index = DreamIndex([store], [fm], None, "none")
    opts = MapperOptions(error_rate=ERROR_RATE, secondary_matches="tag")

    print(f"[bench] devices: {jax.devices()}", file=sys.stderr)
    t0 = time.time()
    dream_map_sam(index, warm, opts, header=False)
    print(f"[bench] warmup (compile): {time.time() - t0:.1f}s", file=sys.stderr)

    def run_pass(rep_label):
        timers = StageTimers()
        t0 = time.time()
        n_lines = 0
        for sam in dream_map_stream(index, iter(batches), opts, timers=timers):
            # cheap record-count sanity floor: splitlines() over ~0.5 GB of
            # SAM text cost ~1s INSIDE the timed pass; newline counting is
            # ~50 ms (headers only add a few lines, records may exceed
            # n_total via secondaries — the assert is a floor either way)
            n_lines += sam.count(b"\n")
        dt = time.time() - t0
        assert n_lines >= n_total
        print(f"[bench] pass {rep_label}: {n_total} reads in {dt:.2f}s",
              file=sys.stderr)
        print(timers.report(), file=sys.stderr)
        return dt

    # Steady-state warmup: one compile-warmup batch is not enough to reach
    # steady state. Run UNTIMED passes until two consecutive walls agree
    # within 10% (cap 5), THEN time 5 and report the median (reference discipline: Timer<> reports steady-stage
    # wall times, src/misc_timer.h [U]).
    prev = run_pass("warm0")
    for w in range(1, 5):
        cur = run_pass(f"warm{w}")
        if abs(cur - prev) <= 0.10 * min(cur, prev):
            break
        prev = cur

    # five timed passes, report the MEDIAN: a best-of headline would ride
    # run-to-run noise instead of the code
    dts = [run_pass(rep) for rep in range(5)]
    dt = sorted(dts)[len(dts) // 2]
    rps = n_total / dt

    rec = {
        "metric": "reads/sec/chip (100bp Illumina, e<=3%)",
        "value": round(rps, 1),
        "unit": "reads/s",
        "vs_baseline": round(rps / NOMINAL_REFERENCE_READS_PER_S, 3),
        # vs_baseline is a NORMALIZATION, not a measured reference run: the
        # reference binary is unbuildable offline, so the divisor is the
        # nominal 50k reads/s midpoint of the paper's 10^4-10^5 range.
        "baseline_note": "normalized vs nominal 50k reads/s (paper midpoint);"
                         " reference binary not measured in this environment",
        "timed_passes_s": [round(x, 2) for x in dts],
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
    }
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
