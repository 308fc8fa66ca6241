"""Config-3-scale benchmark: GRCh38-class database on ONE chip.

BASELINE.json config 3 is GRCh38 in 64 bins on a multi-chip slice; this
measures the same DATABASE SCALE on one device: 64 bins x 32 Mbp (2.05 Gbp
total, the paper's B=64 geometry), sampled SA rate 8 (DY_C3_RATE), prefix_q=10, blocked+canonical IBF at
~12 bits/kmer, lean device set (no bwt/occ upload). 1M SE 100bp reads,
e<=3%.

Build: python tools/bench_config3.py --build-only   (CPU, ~25 min, cached)
Run:   python tools/bench_config3.py [n_reads]
"""

from __future__ import annotations

import json
import os
import sys
import time
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent.parent))

BINS = 64
BIN_BP = 32_000_000
# sampled-SA rate: 8 halves the locate LF walk of rate 16 for ~+0.5 GiB
# residency (ROADMAP S3: A/B full SA on the card)
RATE = int(os.environ.get("DY_C3_RATE", "8"))
# minimizer window (0/19 = all k-mers). w=24 selects ~2/7 of the k-mers
# (2.3x fewer classify row gathers) while the
# CALIBRATED slack table keeps the routing threshold at ~4 of ~24
# minimizers at e=3 (w=26 collapses to 1 — index/minimizer_calib.py)
WINDOW = int(os.environ.get("DY_C3_WINDOW", "0"))
READ_LEN = 100
CACHE = Path(__file__).parent.parent / ".bench_cache" / "config3"


def _fm_path(b: int) -> "Path":
    # rate-16 keeps the legacy name (shared with tools/bench_config4.py);
    # other rates get their own artifact so A/Bs don't clobber the cache
    return CACHE / (f"{b:04d}.fm.npz" if RATE == 16
                    else f"{b:04d}.fm_r{RATE}.npz")


def _build_bin(b: int) -> str:
    from dream_yara_tpu.index.fmindex import FMIndex
    from dream_yara_tpu.io.seqstore import SeqStore

    sp = CACHE / f"{b:04d}.store.npz"
    fp = _fm_path(b)
    if sp.exists() and fp.exists():
        return f"bin {b}: cached"
    rng = np.random.default_rng(1000 + b)
    g = rng.integers(0, 4, BIN_BP, dtype=np.int8)
    st = SeqStore.from_seqs([f"chr{b}"], [g])
    t0 = time.time()
    fm = FMIndex.build(st.text, sample_rate=RATE, prefix_q=10)
    if not sp.exists():
        st.save(sp)
    fm.save(fp)
    return f"bin {b}: built in {time.time() - t0:.0f}s (rate {RATE})"


def build_or_load(jobs: int = 4):
    from dream_yara_tpu.index.fmindex import FMIndex
    from dream_yara_tpu.index.ibf import InterleavedBloomFilter
    from dream_yara_tpu.io.seqstore import SeqStore
    from dream_yara_tpu.pipeline.dis_mapper import DreamIndex

    CACHE.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    todo = [b for b in range(BINS) if not _fm_path(b).exists()]
    if todo:
        # spawn: workers build on the host and must never inherit a JAX
        # backend
        with ProcessPoolExecutor(
                max_workers=jobs,
                mp_context=multiprocessing.get_context("spawn")) as ex:
            for msg in ex.map(_build_bin, todo):
                print(f"[c3] {msg}", file=sys.stderr)
    stores = [SeqStore.load(CACHE / f"{b:04d}.store.npz") for b in range(BINS)]
    fms = [FMIndex.load(_fm_path(b)) for b in range(BINS)]

    fpth = CACHE / ("filter.npz" if WINDOW <= 19 else f"filter_w{WINDOW}.npz")
    if fpth.exists():
        filt = InterleavedBloomFilter.load(fpth)
        if filt.window > filt.k and filt.slack_table is None:
            # stale pre-calibration cache: recalibrate in place so the A/B
            # never silently measures the collapsed-heuristic mode
            filt.calibrate(e_max=6, trials=4000, q=1e-4, read_lens=(100,))
            filt.save(fpth)
            print(f"[c3] recalibrated stale minimizer artifact: "
                  f"{filt.slack_table.tolist()}", file=sys.stderr)
    else:
        # ~12 bits per INSERTED canonical k-mer per bin (winnowing selects
        # ~2/(w-k+2) of them, shrinking the filter the same factor);
        # 64 bins -> bins_padded 64
        n_ins = (2 * BIN_BP // (WINDOW - 19 + 2) if WINDOW > 19 else BIN_BP)
        filt = InterleavedBloomFilter.create(
            BINS, size_bits=12 * n_ins * 64, n_hashes=3, k=19, window=WINDOW)
        tF = time.time()
        from concurrent.futures import ThreadPoolExecutor

        def insert(b):
            filt.add_kmers(stores[b].text[:-1], b)
            return b

        with ThreadPoolExecutor(max_workers=jobs) as ex:
            for b in ex.map(insert, range(BINS)):
                if b % 16 == 15:
                    print(f"[c3] filter: {b + 1}/{BINS} bins", file=sys.stderr)
        if WINDOW > 19:
            # q=1e-4 with 4000 trials = observed-max slack: the benchmark
            # claims mapped_frac, so spend a tick of selectivity on safety
            filt.calibrate(e_max=6, trials=4000, q=1e-4, read_lens=(100,))
            print(f"[c3] slack table: {filt.slack_table.tolist()}",
                  file=sys.stderr)
        filt.save(fpth)
        print(f"[c3] filter built in {time.time() - tF:.0f}s "
              f"({filt.words.nbytes >> 20} MiB)", file=sys.stderr)
    print(f"[c3] db ready: {BINS} x {BIN_BP/1e6:.0f} Mbp "
          f"(blocked={filt.blocked}) in {time.time() - t0:.0f}s",
          file=sys.stderr)
    return stores, fms, DreamIndex(stores, fms, filt, "bloom")


def make_reads(stores, n_reads, rng):
    from dream_yara_tpu.io.readstore import ReadBatch

    b_of = rng.integers(0, BINS, n_reads)
    p = rng.integers(0, BIN_BP - READ_LEN - 1, n_reads)
    m = np.empty((n_reads, READ_LEN), dtype=np.int8)
    win = np.arange(READ_LEN)
    for b in range(BINS):
        sel = np.flatnonzero(b_of == b)
        m[sel] = stores[b].text[p[sel, None] + win[None, :]]
    nsub = rng.integers(0, 4, n_reads)
    for s in range(1, 4):
        rows = np.flatnonzero(nsub >= s)
        cols = rng.integers(0, READ_LEN, len(rows))
        m[rows, cols] = (m[rows, cols] + rng.integers(1, 4, len(rows))) % 4
    flip = rng.random(n_reads) < 0.5
    m[flip] = np.where(m[flip, ::-1] < 4, 3 - m[flip, ::-1], m[flip, ::-1])
    return ReadBatch.from_dense(
        [f"r{i}" for i in range(n_reads)], m,
        np.full(n_reads, READ_LEN, dtype=np.int32))


def main():
    build_only = "--build-only" in sys.argv
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    n_reads = int(args[0]) if args else 1_000_000

    stores, fms, index = build_or_load()
    if build_only:
        return

    import jax

    from dream_yara_tpu.cli.common import enable_compile_cache

    enable_compile_cache()

    from dream_yara_tpu.parallel.dream_mesh import (MeshDreamMapper,
                                                    mesh_dream_stream)
    from dream_yara_tpu.utils.options import MapperOptions
    from dream_yara_tpu.utils.timer import StageTimers

    rng = np.random.default_rng(7)
    rp = CACHE / f"reads_{n_reads}.npz"
    if rp.exists():
        print(f"[c3] loading cached reads", file=sys.stderr)
        from dream_yara_tpu.io.readstore import ReadBatch

        z = np.load(rp)
        batches = []
        for bi in range(int(z["n_batches"])):
            m = z[f"b{bi}"]
            batches.append(ReadBatch.from_dense(
                [f"r{i}" for i in range(m.shape[0])], m,
                np.full(m.shape[0], READ_LEN, dtype=np.int32)))
    else:
        print(f"[c3] generating {n_reads} reads", file=sys.stderr)
        batches = [make_reads(stores, min(250_000, n_reads - i), rng)
                   for i in range(0, n_reads, 250_000)]
        np.savez(rp, n_batches=len(batches),
                 **{f"b{bi}": np.asarray(b.seqs[:b.n_reads])
                    for bi, b in enumerate(batches)})
    opts = MapperOptions(error_rate=0.03)
    timers = StageTimers()
    mapper = MeshDreamMapper(index, opts, lean=True)
    print(f"[c3] mesh {dict(mapper.mesh.shape)}, devices "
          f"{[str(d) for d in jax.devices()]}", file=sys.stderr)

    # warmup on the FIRST REAL batch: compiles the exact production shape
    # (a tiny 4096-read warmup paid a full multi-minute remote compile for
    # a shape used exactly once, and pass 0 then recompiled at 250k anyway)
    t0 = time.time()
    _ = b"".join(mesh_dream_stream(mapper, iter(batches[:1]), timers=timers))
    print(f"[c3] warmup(compile): {time.time() - t0:.1f}s", file=sys.stderr)
    # second warm batch: the cap auto-tuner engages AFTER the first batch's
    # demands are observed, so the tuned-shape compile must land here, not
    # in timed pass 0
    t0 = time.time()
    _ = b"".join(mesh_dream_stream(mapper, iter(batches[:1]), timers=timers))
    print(f"[c3] warmup(tuned caps): {time.time() - t0:.1f}s", file=sys.stderr)

    # median of N timed passes
    passes = int(args[1]) if len(args) > 1 else 3
    rps_all, n_map, n_rec = [], 0, 0
    for pi in range(passes):
        stats = {}
        timers = StageTimers()
        t0 = time.time()
        out = b"".join(mesh_dream_stream(mapper, iter(batches), timers=timers,
                                        stats=stats))
        rps_all.append(n_reads / (time.time() - t0))
        print(f"[c3] pass {pi}: {rps_all[-1]:.0f} reads/s", file=sys.stderr)
        if pi == 0:
            n_rec = sum(1 for l in out.splitlines()
                        if l and not l.startswith(b"@"))
            n_map = sum(1 for l in out.splitlines()
                        if l and not l.startswith(b"@")
                        and int(l.split(b"\t", 3)[1]) & 4 == 0)
            print(timers.report(), file=sys.stderr)
            print(f"[c3] diag: {mapper.fallback_diag}", file=sys.stderr)
            print(f"[c3] mapped {n_map}/{n_rec}", file=sys.stderr)
    print(json.dumps({
        "metric": "config3-scale reads/sec/chip (2 Gbp, 64 bins, 100bp)",
        "value": round(float(np.median(rps_all)), 1), "unit": "reads/s",
        "mapped_frac": round(n_map / max(n_rec, 1), 4),
        "n_bins": BINS, "db_bp": BINS * BIN_BP,
        "passes": [round(r, 1) for r in rps_all],
    }))


if __name__ == "__main__":
    main()
