"""Config-5: metagenomic skew — 256 small bins, power-law read routing.

BASELINE.json row 5 shape scaled to one device: 256 bins of
~0.4 Mbp (100 Mbp total database, RefSeq-microbe sized bins), 100bp SE reads
whose source bin follows a Zipf-like power law (the defining property of
metagenomic samples: a few dominant organisms + a long tail). Measures
reads/s plus ROUTING SKEW TOLERANCE: drain passes, route-overflow rate, and
host-fallback fraction from MeshDreamMapper.fallback_diag — with r_cap
auto-tuning warming up across batches.

Run: python tools/bench_config5.py [n_reads] [n_bins]
CPU smoke: JAX_PLATFORMS=cpu python tools/bench_config5.py 2000 32
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent.parent))

BIN_BP = 400_000
READ_LEN = 100
CACHE = Path(__file__).parent.parent / ".bench_cache" / "config5"


def build_or_load(n_bins: int):
    from dream_yara_tpu.index.fmindex import FMIndex
    from dream_yara_tpu.index.ibf import InterleavedBloomFilter
    from dream_yara_tpu.io.seqstore import SeqStore
    from dream_yara_tpu.pipeline.dis_mapper import DreamIndex

    CACHE.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(52)
    genomes, stores, fms = [], [], []
    t0 = time.time()
    for b in range(n_bins):
        g = rng.integers(0, 4, BIN_BP).astype(np.int8)
        genomes.append(g)
        sp = CACHE / f"{b:04d}.store.npz"
        fp = CACHE / f"{b:04d}.fm.npz"
        if sp.exists() and fp.exists():
            stores.append(SeqStore.load(sp))
            fms.append(FMIndex.load(fp))
        else:
            st = SeqStore.from_seqs([f"g{b:04d}"], [g])
            fm = FMIndex.build(st.text)
            st.save(sp)
            fm.save(fp)
            stores.append(st)
            fms.append(fm)
    fpth = CACHE / "filter.npz"
    if fpth.exists():
        filt = InterleavedBloomFilter.load(fpth)
    else:
        # per-bin slice must hold ~BIN_BP k-mers at ~12 bits/kmer; the IBF
        # interleaves one bit per PADDED bin per row, so total bits scale
        # with bins_padded (n_rows = size_bits // bins_padded)
        bins_padded = ((n_bins + 63) // 64) * 64
        filt = InterleavedBloomFilter.create(
            n_bins, size_bits=12 * BIN_BP * bins_padded, n_hashes=3, k=19)
        for b, g in enumerate(genomes):
            filt.add_kmers(g, b)
        filt.save(fpth)
    print(f"[c5] db: {n_bins} bins x {BIN_BP/1e6:.1f} Mbp in "
          f"{time.time()-t0:.1f}s", file=sys.stderr)
    return genomes, DreamIndex(stores, fms, filt, "bloom")


def make_batch(genomes, n_reads, rng):
    """Zipf-weighted source bins: bin rank r gets weight 1/(r+1)."""
    from dream_yara_tpu.io.readstore import ReadBatch
    from dream_yara_tpu.utils.alphabet import revcomp

    B = len(genomes)
    w = 1.0 / np.arange(1, B + 1)
    w /= w.sum()
    srcs = rng.choice(B, size=n_reads, p=w)
    names, reads = [], []
    for i, b in enumerate(srcs):
        p = int(rng.integers(0, BIN_BP - READ_LEN - 1))
        r = genomes[b][p : p + READ_LEN].copy()
        for _ in range(int(rng.integers(0, 4))):
            j = int(rng.integers(0, READ_LEN))
            r[j] = (r[j] + 1 + int(rng.integers(0, 3))) % 4
        if i % 2:
            r = revcomp(r)
        names.append(f"r{i}b{b}")
        reads.append(r)
    return ReadBatch.from_reads(names, reads)


def main():
    import jax

    from dream_yara_tpu.cli.common import enable_compile_cache

    enable_compile_cache()

    from dream_yara_tpu.parallel.dream_mesh import (MeshDreamMapper,
                                                    mesh_dream_stream)
    from dream_yara_tpu.utils.options import MapperOptions
    from dream_yara_tpu.utils.timer import StageTimers

    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 200_000
    n_bins = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    batch_reads = min(50_000, n_reads)
    genomes, index = build_or_load(n_bins)
    opts = MapperOptions(error_rate=0.03)
    rng = np.random.default_rng(11)

    print(f"[c5] devices: {jax.devices()}", file=sys.stderr)
    mapper = MeshDreamMapper(index, opts, n_devices=1)
    warm = make_batch(genomes, batch_reads, rng)
    t0 = time.time()
    next(iter(mesh_dream_stream(mapper, [warm])))
    print(f"[c5] warmup: {time.time()-t0:.1f}s  diag={mapper.fallback_diag}",
          file=sys.stderr)
    # second warm batch absorbs the cap auto-tuner's tuned-shape compile
    t0 = time.time()
    next(iter(mesh_dream_stream(mapper, [warm])))
    print(f"[c5] warmup(tuned caps): {time.time()-t0:.1f}s", file=sys.stderr)

    batches = [make_batch(genomes, batch_reads, rng)
               for _ in range(max(1, n_reads // batch_reads))]
    total = batch_reads * len(batches)
    # median of 5 timed passes
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
        rps_all.append(total / (time.time() - t0))
        print(f"[c5] pass {pi}: {rps_all[-1]:.0f} reads/s", file=sys.stderr)
        if pi == 0:
            print(timers.report(), file=sys.stderr)
            print(f"[c5] mapped {stats.get('mapped', '?')} of {total}",
                  file=sys.stderr)
    diag = mapper.fallback_diag
    skew_fallback = diag["route_ovf"] / max(diag["routed"], 1)
    print(json.dumps({
        "metric": "config5 reads/sec/chip (256-bin Zipf metagenome)",
        "value": round(float(np.median(rps_all)), 1), "unit": "reads/s",
        "n_bins": n_bins, "drain_passes": diag["drain_passes"],
        "route_overflow_frac": round(skew_fallback, 5),
        "tuned_r_cap": getattr(mapper, "_tuned_r_cap", 0),
        "passes": [round(r, 1) for r in rps_all]}))


if __name__ == "__main__":
    main()
