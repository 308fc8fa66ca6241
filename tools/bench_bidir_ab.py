"""Bidirectional-backend end-to-end A/B on a repeat-rich workload.

The search-scheme backend (index/bifm.py + ops/bidir_search.py) only runs
in the repetitive re-seed strata, and uniform-random benchmark genomes
(configs 1-5) almost never trigger those — a kernel-level 1.8x that no
sanctioned config executes is shelf-ware (round-4 verdict missing #4).
This bench builds the workload the backend exists for: one repeat-rich bin
(utils/simulate.repeat_rich_genome — diverged interspersed families +
tandem arrays) with HALF the reads drawn from repeat copies, so the exact
seeds of those reads overflow and the budget-1/2 strata carry real weight.

Measures median-of-N end-to-end reads/s and the repetitive-stage seconds
for DY_SEED_BACKEND=enum vs bidir on the same DB/reads, and prints one
JSON line with both. Run on the real chip:

  python tools/bench_bidir_ab.py [n_reads=200000] [passes=5]
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent.parent))

# 32 Mbp: the 64 Mbp variant compiled to 15.87G of 15.75G HBM on the
# single-chip full-table path (single-bin map step + repetitive strata
# buffers) — the A/B is about the repetitive-stage backends, which scale
# with the read mix, not the genome
GENOME_LEN = 32_000_000
READ_LEN = 100
CACHE = Path(__file__).parent.parent / ".bench_cache" / "bidir_ab"


def build_or_load():
    from dream_yara_tpu.index.bifm import build_reverse_fused
    from dream_yara_tpu.index.fmindex import FMIndex
    from dream_yara_tpu.io.seqstore import SeqStore
    from dream_yara_tpu.utils.simulate import repeat_rich_genome

    CACHE.mkdir(parents=True, exist_ok=True)
    sp, fp, rp, ap = (CACHE / "store.npz", CACHE / "fm.npz",
                      CACHE / "rfm.npz", CACHE / "ann.npz")
    if all(p.exists() for p in (sp, fp, rp, ap)):
        st = SeqStore.load(sp)
        fm = FMIndex.load(fp)
        rfused = np.load(rp)["rfused"]
        z = np.load(ap)
        regions = list(map(tuple, z["regions"]))
        return st, fm, rfused, regions
    rng = np.random.default_rng(42)
    t0 = time.time()
    # ~1.5% of the genome in ~300bp diverged Alu-like copies + tandems:
    # enough repeat mass that half the reads can be drawn from copies
    g, ann = repeat_rich_genome(rng, GENOME_LEN,
                                alu_count=GENOME_LEN // 20_000,
                                tandem_loci=GENOME_LEN // 500_000,
                                n_runs=GENOME_LEN // 2_000_000)
    print(f"[bidir-ab] genome: {time.time() - t0:.0f}s", file=sys.stderr)
    st = SeqStore.from_seqs(["rich"], [g])
    t0 = time.time()
    fm = FMIndex.build(st.text, sample_rate=8, prefix_q=10)
    print(f"[bidir-ab] fm: {time.time() - t0:.0f}s", file=sys.stderr)
    t0 = time.time()
    rfused, _ = build_reverse_fused(st.text)
    print(f"[bidir-ab] reverse fused rows: {time.time() - t0:.0f}s",
          file=sys.stderr)
    st.save(sp)
    fm.save(fp)
    np.savez(rp, rfused=rfused)
    regions = ann["alu"] + ann["tandem"]
    np.savez(ap, regions=np.asarray(regions, np.int64))
    return st, fm, rfused, regions


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    n_reads = int(args[0]) if args else 200_000
    passes = int(args[1]) if len(args) > 1 else 5
    build_only = "--build-only" in sys.argv

    st, fm, rfused, regions = build_or_load()
    if build_only:
        return

    import jax

    from dream_yara_tpu.cli.common import enable_compile_cache

    enable_compile_cache()

    from dream_yara_tpu.io.readstore import ReadBatch
    from dream_yara_tpu.pipeline.dis_mapper import (DreamIndex,
                                                    dream_map_stream)
    from dream_yara_tpu.utils.options import MapperOptions
    from dream_yara_tpu.utils.simulate import sample_reads
    from dream_yara_tpu.utils.timer import StageTimers

    rng = np.random.default_rng(7)
    reads, truth = sample_reads(rng, np.asarray(st.text[:-1]), n_reads,
                                read_len=READ_LEN, n_sub=2, regions=regions)
    batch_n = 25_000
    batches = []
    for i in range(0, n_reads, batch_n):
        sub = reads[i : i + batch_n]
        batches.append(ReadBatch.from_reads(
            [f"r{j}" for j in range(len(sub))], sub))
    opts = MapperOptions(error_rate=0.03)
    print(f"[bidir-ab] devices: {jax.devices()}", file=sys.stderr)

    results = {}
    # 2x2: backend x indels. With -i on (the product default) the 1-edit
    # stratum keeps enumeration (search schemes are substitution-only) and
    # bidir only accelerates stratum 2; with -i off both strata are
    # bidir-eligible. The indels-on/off delta of the repetitive stage is
    # also the measured indel-stratum share the round-4 verdict asked for.
    for mode, indels in (("enum", True), ("bidir", True),
                         ("enum", False), ("bidir", False)):
        opts = MapperOptions(error_rate=0.03, indels=indels)
        os.environ["DY_SEED_BACKEND"] = mode
        index = DreamIndex([st], [fm], None, "none",
                           rfused={0: rfused} if mode == "bidir" else {})
        # warmup/compile pass
        t0 = time.time()
        stats: dict = {}
        for _ in dream_map_stream(index, iter(batches[:2]), opts,
                                  stats=stats):
            pass
        print(f"[bidir-ab] {mode} warmup: {time.time() - t0:.1f}s",
              file=sys.stderr)
        dts, rep_s = [], []
        for p in range(passes):
            timers = StageTimers()
            stats = {}
            t0 = time.time()
            for _ in dream_map_stream(index, iter(batches), opts,
                                      timers=timers, stats=stats):
                pass
            dts.append(time.time() - t0)
            rep = timers.totals.get("repetitive re-seed (device)", 0.0)
            rep_s.append(rep)
            print(f"[bidir-ab] {mode} pass {p}: {dts[-1]:.2f}s "
                  f"(repetitive {rep:.2f}s) mapped "
                  f"{stats.get('mapped')}/{stats.get('reads')}",
                  file=sys.stderr)
        med = sorted(dts)[len(dts) // 2]
        results[f"{mode}{'_i' if indels else ''}"] = {
            "reads_per_s": round(n_reads / med, 1),
            "pass_s": [round(x, 2) for x in dts],
            "repetitive_stage_s_median": round(sorted(rep_s)[len(rep_s) // 2], 2),
            "mapped": stats.get("mapped"),
        }
    os.environ.pop("DY_SEED_BACKEND", None)
    print(json.dumps({
        "metric": "bidir-vs-enum repeat-rich reads/s/chip",
        "genome_bp": GENOME_LEN, "n_reads": n_reads,
        **results,
        "bidir_speedup_indels_on": round(
            results["bidir_i"]["reads_per_s"]
            / max(results["enum_i"]["reads_per_s"], 1e-9), 3),
        "bidir_speedup_hamming": round(
            results["bidir"]["reads_per_s"]
            / max(results["enum"]["reads_per_s"], 1e-9), 3),
        "indel_stratum_extra_s": round(
            results["enum_i"]["repetitive_stage_s_median"]
            - results["enum"]["repetitive_stage_s_median"], 2),
    }))


if __name__ == "__main__":
    main()
