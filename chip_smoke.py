"""Smoke run of the DREAM mapping path on one GPU (or four, with --four).

The workload is BASELINE.json config 2, "Human chr21 split into 8 bins, 1M
paired-end 150bp reads, one host", generated from --seed because nothing can
be downloaded: a ~40 Mbp reference (chr21's non-N length) with repeat
content from utils/simulate.py in 8 bins, 250k single-end 100 bp reads and
250k 2x150 bp pairs at <= 3% error, all with recorded origins. The database
is built with the indexer and build-filter CLIs (k=19, 2^31-bit IBF as in
tools/bench_config2.py) and reported as set-up.

Phases, each printing its own lines:
  1. device: a GPU or exit; the card's name and power limit; native libs;
  2. kernel: the Triton banded-verify kernel against ops/verify.py at
     L=100/E=3 and L=150/E=4, 2^17 and 2^20 candidates, exact equality on
     dist, begin and end (all values are integers), with both times;
  3. main path: the mapper CLI, default path and --mesh, SE and PE, SAM and
     BAM: identical SAM from both paths, planted-truth and proper-pair
     floors, a valid BAM, and a subsample equal to the golden model;
  4. --four (only with that option, and then alone): the --mesh (data, bin)
     mesh over 4 GPUs and the multi-host path as 4 processes, one per GPU,
     both byte-identical to a one-GPU run of the same data.

The last stdout line is {"ok": true, "device": {...}}. Any failed check
raises, so the script exits non-zero and prints no result.

Usage: python chip_smoke.py [--seed N] [--workdir DIR] [--four]
"""

from __future__ import annotations

import argparse
import functools
import gzip
import json
import os
import socket
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

BINS = 8
BIN_LEN = 5_000_000
N_SE, SE_LEN = 250_000, 100
N_PE, PE_LEN = 250_000, 150
N_FOUR = 50_000               # SE reads and pairs of the --four phase
LL, LD = 350, 80
ERROR_RATE = 0.03
KERNEL_SHAPES = [(100, 3), (150, 4)]
KERNEL_SIZES = [1 << 17, 1 << 20]
GOLDEN_SE, GOLDEN_PE = 256, 128


def log(msg: str):
    print(msg, flush=True)


def require_gpu(count: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU, JAX devices are {devs}")
    if len(devs) < count:
        sys.exit(f"chip_smoke: needs {count} GPUs, JAX has {len(devs)}")
    return devs


def gpu_name_and_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def phase_device(count: int):
    from dream_yara_tpu.cli.common import enable_compile_cache
    from dream_yara_tpu.native import build as native

    devs = require_gpu(count)
    log(f"[device] {len(devs)} x {devs[0].device_kind} "
        f"(platform {devs[0].platform})")
    log(f"[device] compile cache: {enable_compile_cache()}")
    for name in native.LIBS:
        if native.build(name) is None:
            raise RuntimeError(f"native library {name} did not build")
    log(f"[device] native libraries built: {', '.join(native.LIBS)}")
    return devs


# ---------------------------------------------------------------- kernel

def _median_ms(f, *args, reps: int = 10) -> float:
    import jax

    jax.block_until_ready(f(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def _verify_case(rng, L: int, E: int, C: int):
    """Candidates over a random 8 Mbp text: 70% planted reads with ~2%
    substitutions, 30% random reads (true negatives), 10% shorter lanes."""
    n = 8_000_000
    text = rng.integers(0, 4, n).astype(np.int8)
    anch = rng.integers(E, n - L - E - 1, C).astype(np.int32)
    reads = text[anch[:, None] + np.arange(L)[None, :]]
    m = rng.random(reads.shape) < 0.02
    reads[m] = (reads[m] + rng.integers(1, 4, int(m.sum()))) % 4
    neg = rng.random(C) < 0.3
    reads[neg] = rng.integers(0, 4, (int(neg.sum()), L))
    lens = np.full(C, L, np.int32)
    lens[rng.random(C) < 0.1] = L - 7
    return text, anch, reads, lens


def phase_kernel(rng, gpu_line: str):
    import jax
    import jax.numpy as jnp

    from dream_yara_tpu.ops.pallas_verify import banded_dp_pallas
    from dream_yara_tpu.ops.verify import (banded_dp, gather_windows,
                                           local_tblock_fetch)

    for L, E in KERNEL_SHAPES:
        for C in KERNEL_SIZES:
            text, anch, reads, lens = (jnp.asarray(x) for x in
                                       _verify_case(rng, L, E, C))
            rows = jnp.arange(C, dtype=jnp.int32)

            @jax.jit
            def gather(text, anch, reads, rows):
                fetch = local_tblock_fetch(text, L, E)
                return (gather_windows(anch, L, E, fetch).T,
                        jnp.take(reads, rows, axis=0).T)

            dp_xla = jax.jit(functools.partial(banded_dp, max_err=E))
            dp_kernel = jax.jit(functools.partial(banded_dp_pallas,
                                                  max_err=E))
            wT, rT = gather(text, anch, reads, rows)
            want = dp_xla(wT, rT, anch, lens)
            got = dp_kernel(wT, rT, anch, lens)
            for x, y, name in zip(want, got, ("dist", "begin", "end")):
                if not bool(jnp.array_equal(x, y)):
                    bad = int(jnp.sum(x != y))
                    raise AssertionError(f"kernel != XLA on {name}: {bad} "
                                         f"of {C} lanes (L={L}, E={E})")
            t_gather = _median_ms(gather, text, anch, reads, rows)
            t_xla = _median_ms(dp_xla, wT, rT, anch, lens)
            t_kernel = _median_ms(dp_kernel, wT, rT, anch, lens)
            log(f"[kernel] L={L} E={E} C={C}: equal on all lanes; DP "
                f"kernel {t_kernel:.3f} ms, XLA {t_xla:.3f} ms "
                f"({t_xla / t_kernel:.1f}x); window gather {t_gather:.3f} "
                f"ms [{gpu_line}]")


# ------------------------------------------------------------ data + db

def _rc(m: np.ndarray) -> np.ndarray:
    return np.where(m < 4, 3 - m, m)[:, ::-1]


def _substitute(rng, m: np.ndarray, max_subs: np.ndarray):
    n, L = m.shape
    k = rng.integers(0, max_subs + 1)
    for s in range(int(max_subs.max())):
        rows = np.flatnonzero(k > s)
        cols = rng.integers(0, L, len(rows))
        m[rows, cols] = (m[rows, cols] + rng.integers(1, 4, len(rows))) % 4


def _draw_positions(rng, genomes, n: int, span: int):
    """Per-read (bin, start) with an N-free window of `span` bases."""
    b = rng.integers(0, len(genomes), n)
    p = np.zeros(n, np.int64)
    for g_id, g in enumerate(genomes):
        cn = np.concatenate([[0], np.cumsum(g == 4)])
        todo = np.flatnonzero(b == g_id)
        while len(todo):
            q = rng.integers(0, len(g) - span, len(todo))
            ok = cn[q + span] == cn[q]
            p[todo[ok]] = q[ok]
            todo = todo[~ok]
    return b, p


def simulate_se(rng, genomes, n: int, L: int):
    """SE reads at <= 3% error: up to floor(0.03 L) edits, 20% of reads
    with one indel in the middle third; half reverse-complemented. Truth
    is (bin, leftmost position, strand)."""
    b, p = _draw_positions(rng, genomes, n, L + 1)
    kind = rng.choice(3, n, p=[0.8, 0.1, 0.1])       # none / del / ins
    at = rng.integers(L // 3, 2 * L // 3, n)
    j = np.arange(L)[None, :]
    idx = p[:, None] + j
    idx += (kind[:, None] == 1) & (j >= at[:, None])
    idx -= (kind[:, None] == 2) & (j > at[:, None])
    m = np.empty((n, L), np.int8)
    for g_id, g in enumerate(genomes):
        sel = b == g_id
        m[sel] = g[idx[sel]]
    ins = np.flatnonzero(kind == 2)
    m[ins, at[ins]] = rng.integers(0, 4, len(ins))
    e = int(L * ERROR_RATE)
    _substitute(rng, m, np.where(kind > 0, e - 1, e))
    strand = rng.random(n) < 0.5
    m[strand] = _rc(m[strand])
    return m, (b, p, strand)


def simulate_pe(rng, genomes, n: int, L: int):
    """FR pairs, fragment LL +- (LD - 10), up to floor(0.03 L)
    substitutions per mate. Truth is (bin, mate-1 position)."""
    t = rng.integers(LL - LD + 10, LL + LD - 10, n)
    b, p = _draw_positions(rng, genomes, n, LL + LD)
    j = np.arange(L)[None, :]
    m1 = np.empty((n, L), np.int8)
    m2 = np.empty((n, L), np.int8)
    for g_id, g in enumerate(genomes):
        sel = np.flatnonzero(b == g_id)
        m1[sel] = g[p[sel, None] + j]
        m2[sel] = _rc(g[(p[sel] + t[sel] - L)[:, None] + j])
    e = np.full(n, int(L * ERROR_RATE))
    _substitute(rng, m1, e)
    _substitute(rng, m2, e)
    return m1, m2, (b, p)


def write_fastq(path: Path, prefix: str, m: np.ndarray):
    from dream_yara_tpu.utils.alphabet import code_to_ascii

    seqs = code_to_ascii(m)
    qual = b"I" * m.shape[1]
    with open(path, "wb") as f:
        for i in range(len(m)):
            f.write(b"@%s%d\n%s\n+\n%s\n" % (prefix.encode(), i,
                                             seqs[i].tobytes(), qual))


def make_workload(work: Path, seed: int, n_se: int, n_pe: int):
    from dream_yara_tpu.io.fasta import write_fasta
    from dream_yara_tpu.utils.simulate import repeat_rich_genome

    rng = np.random.default_rng(seed)
    t0 = time.time()
    genomes = [repeat_rich_genome(rng, BIN_LEN)[0] for _ in range(BINS)]
    fastas = []
    for b, g in enumerate(genomes):
        fastas.append(work / f"bin_{b:02d}.fa")
        write_fasta(fastas[-1], [f"chr21sim_b{b}"], [g])
    se, se_truth = simulate_se(rng, genomes, n_se, SE_LEN)
    m1, m2, pe_truth = simulate_pe(rng, genomes, n_pe, PE_LEN)
    write_fastq(work / "se.fq", "s", se)
    write_fastq(work / "pe_1.fq", "p", m1)
    write_fastq(work / "pe_2.fq", "p", m2)
    log(f"[setup] {BINS} bins x {BIN_LEN} bp, {n_se} SE x {SE_LEN} bp, "
        f"{n_pe} pairs x 2x{PE_LEN} bp generated in {time.time() - t0:.1f}s "
        f"(seed {seed})")
    return fastas, se, se_truth, (m1, m2), pe_truth


def build_db(work: Path, fastas, hbm_gb: str | None = None) -> Path:
    """Build through the indexer and build-filter CLIs; `hbm_gb` keeps the
    indexer off the device (the --four parent must not hold the GPUs)."""
    from dream_yara_tpu.cli import build_filter, indexer

    db = work / "db"
    t0 = time.time()
    indexer.main([*map(str, fastas), "-o", str(db), "-t", "4",
                  *(["--hbm-gb", hbm_gb] if hbm_gb else [])])
    t1 = time.time()
    build_filter.main([*map(str, fastas), "-o", str(db), "-bs", "2g",
                       "-k", "19", "-t", "4"])
    log(f"[setup] database: indexer {t1 - t0:.1f}s, build-filter "
        f"{time.time() - t1:.1f}s")
    return db


# ------------------------------------------------------------ main path

def sam_records(path: Path) -> list[list[bytes]]:
    return [l.split(b"\t") for l in path.read_bytes().splitlines()
            if l and not l.startswith(b"@")]


def sam_without_pg(path: Path) -> bytes:
    """The SAM minus its @PG line, whose CL field records the command line
    (which differs between --mesh and the default path)."""
    return b"\n".join(l for l in path.read_bytes().split(b"\n")
                      if not l.startswith(b"@PG"))


def check_identical(a: Path, b: Path, what: str):
    if sam_without_pg(a) != sam_without_pg(b):
        ra, rb = sam_records(a), sam_records(b)
        diff = sum(x != y for x, y in zip(ra, rb)) + abs(len(ra) - len(rb))
        raise AssertionError(f"{what}: {a.name} and {b.name} differ in "
                             f"{diff} records")
    log(f"[check] {what}: {a.name} == {b.name} byte for byte "
        f"({len(sam_records(a))} records, @PG CL aside)")


def check_se_truth(path: Path, truth):
    b, p, strand = truth
    recs = [r for r in sam_records(path) if not int(r[1]) & 0x900]
    assert len(recs) == len(p), (len(recs), len(p))
    mapped = correct = 0
    for r in recs:
        i = int(r[0][1:])
        flag = int(r[1])
        if flag & 0x4:
            continue
        mapped += 1
        correct += (r[2] == b"chr21sim_b%d" % b[i] and int(r[3]) == p[i] + 1
                    and bool(flag & 0x10) == bool(strand[i]))
    n = len(p)
    log(f"[check] SE planted truth: mapped {mapped}/{n} "
        f"({100 * mapped / n:.2f}%), at true contig+pos+strand {correct} "
        f"({100 * correct / max(mapped, 1):.2f}% of mapped)")
    assert mapped >= 0.99 * n, "fewer than 99% of planted SE reads mapped"
    assert correct >= 0.98 * mapped, "fewer than 98% at their true position"


def check_pe_truth(path: Path, truth):
    b, p = truth
    n = len(p)
    mapped = correct = proper = 0
    for r in sam_records(path):
        flag = int(r[1])
        if flag & 0x900 or not flag & 0x40:
            continue
        i = int(r[0][1:])
        proper += bool(flag & 0x2)
        if not flag & 0x4:
            mapped += 1
            correct += (r[2] == b"chr21sim_b%d" % b[i]
                        and int(r[3]) == p[i] + 1)
    log(f"[check] PE planted truth: mate-1 mapped {mapped}/{n}, at true "
        f"contig+pos {correct}, proper pairs {proper} "
        f"({100 * proper / n:.2f}%)")
    assert mapped >= 0.99 * n, "fewer than 99% of mate-1 reads mapped"
    assert correct >= 0.98 * mapped, "fewer than 98% at their true position"
    assert proper >= 0.97 * n, "fewer than 97% proper pairs"


def check_bam(path: Path, n_records: int):
    """BGZF container, BAM magic, header with @SQ lines, and as many
    alignment records as the SAM of the same run."""
    raw = path.read_bytes()
    assert raw[:2] == b"\x1f\x8b", "not BGZF"
    inner = gzip.decompress(raw)
    assert inner[:4] == b"BAM\x01", "not BAM"
    (l_text,) = struct.unpack_from("<i", inner, 4)
    assert b"@SQ" in inner[8 : 8 + l_text]
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", inner, off)
    off += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", inner, off)
        off += 4 + l_name + 4
    recs = 0
    while off < len(inner):
        (block,) = struct.unpack_from("<i", inner, off)
        off += 4 + block
        recs += 1
    assert off == len(inner) and recs == n_records, (recs, n_records)
    log(f"[check] BAM {path.name}: valid, {recs} records")


def run_mapper(args: list[str], n_reads: int, label: str) -> float:
    from dream_yara_tpu.cli import mapper_cli

    t0 = time.perf_counter()
    mapper_cli.main(args)
    dt = time.perf_counter() - t0
    log(f"[map] {label}: {n_reads} reads in {dt:.2f}s "
        f"({n_reads / dt:.0f} reads/s, index load and any compile included)")
    return dt


def phase_main(work: Path, db: Path, se_truth, pe_truth, n_se: int,
               n_pe: int) -> dict:
    import jax

    se = [str(db), str(work / "se.fq"), "-e", str(ERROR_RATE),
          "-rb", str(n_se)]
    pe = [str(db), str(work / "pe_1.fq"), str(work / "pe_2.fq"), "-e",
          str(ERROR_RATE), "-ll", str(LL), "-ld", str(LD), "-rb",
          str(2 * n_pe)]
    out = lambda name: ["-o", str(work / name)]
    times = {}
    run_mapper(se + out("se.sam"), n_se, "SE default path, first run")
    times["se"] = run_mapper(se + out("se.sam") + ["-v"], n_se,
                             "SE default path, warm")
    run_mapper(se + out("se.bam"), n_se, "SE default path, BAM")
    run_mapper(se + out("se_mesh.sam") + ["--mesh"], n_se,
               "SE --mesh, first run")
    times["se_mesh"] = run_mapper(se + out("se_mesh.sam") + ["--mesh", "-v"],
                                  n_se, "SE --mesh, warm")
    run_mapper(pe + out("pe.sam"), 2 * n_pe, "PE default path, first run")
    times["pe"] = run_mapper(pe + out("pe.sam") + ["-v"], 2 * n_pe,
                             "PE default path, warm")
    run_mapper(pe + out("pe_mesh.sam") + ["--mesh"], 2 * n_pe,
               "PE --mesh, first run")
    check_identical(work / "se.sam", work / "se_mesh.sam", "SE default vs mesh")
    check_identical(work / "pe.sam", work / "pe_mesh.sam", "PE default vs mesh")
    check_se_truth(work / "se.sam", se_truth)
    check_pe_truth(work / "pe.sam", pe_truth)
    check_bam(work / "se.bam", len(sam_records(work / "se.sam")))
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    log(f"[map] warm reads/s: SE {n_se / times['se']:.0f}, SE --mesh "
        f"{n_se / times['se_mesh']:.0f}, PE {2 * n_pe / times['pe']:.0f}; "
        f"peak_bytes_in_use {peak}")
    return times


def phase_golden(db: Path, se: np.ndarray, se_truth, pe, pe_truth):
    """A subsample of bin 0 mapped by the device path against bin 0 alone
    equals the golden scalar model: every match (dist, begin, end, strand),
    the c1/c2 counts, and for pairs the primary, proper flag and TLEN. Both
    enumerate every match (sensitivity "full"; the default "high" caps the
    matches of reads in tandem arrays, which the golden model does not)."""
    from dream_yara_tpu.golden.golden_mapper import (golden_map_pe,
                                                     golden_map_se)
    from dream_yara_tpu.index.fmindex import FMIndex
    from dream_yara_tpu.io.readstore import ReadBatch
    from dream_yara_tpu.io.seqstore import SeqStore
    from dream_yara_tpu.pipeline.dis_mapper import bin_file
    from dream_yara_tpu.pipeline.mapper import map_paired_bin, map_single_bin
    from dream_yara_tpu.utils.options import MapperOptions

    store = SeqStore.load(bin_file(db, 0, "store"))
    fm = FMIndex.load(bin_file(db, 0, "fm"))

    def same(ranked, golden, rid):
        m = ranked.matches
        got = [(int(m.dist[i]), int(m.begin[i]), int(m.end[i]),
                int(m.strand[i])) for i in np.flatnonzero(m.read_id == rid)]
        assert got == golden[rid].matches, (rid, got, golden[rid].matches)
        assert int(ranked.c1[rid]) == golden[rid].c1, rid
        assert int(ranked.c2[rid]) == golden[rid].c2, rid

    ids = np.flatnonzero(se_truth[0] == 0)[:GOLDEN_SE]
    batch = ReadBatch.from_reads([f"s{i}" for i in ids], list(se[ids]))
    opts = MapperOptions(error_rate=ERROR_RATE, sensitivity="full")
    ranked, _, _ = map_single_bin(store, fm, batch, opts)
    golden = golden_map_se(store, fm, batch, error_rate=ERROR_RATE)
    for rid in range(batch.n_reads):
        same(ranked, golden, rid)
    log(f"[golden] {len(ids)} SE reads of bin 0: device matches == golden")

    m1, m2 = pe
    ids = np.flatnonzero(pe_truth[0] == 0)[:GOLDEN_PE]
    batch = ReadBatch.from_reads([f"p{i}" for i in ids] * 2,
                                 list(m1[ids]) + list(m2[ids]), paired=True)
    opts = MapperOptions(error_rate=ERROR_RATE, library_length=LL,
                         library_deviation=LD, sensitivity="full")
    ranked, _, _, pi = map_paired_bin(store, fm, batch, opts)
    g_reads, g_prim, g_proper, g_tlen = golden_map_pe(
        store, fm, batch, error_rate=ERROR_RATE, library_length=LL,
        library_deviation=LD)
    m = ranked.matches
    for rid in range(batch.n_reads):
        same(ranked, g_reads, rid)
        assert bool(pi.proper[rid]) == g_proper[rid], rid
        assert int(pi.tlen[rid]) == g_tlen[rid], rid
        k = int(pi.primary_idx[rid])
        want = g_prim[rid]
        assert (k < 0 if want is None else
                (int(m.dist[k]), int(m.begin[k]), int(m.end[k]),
                 int(m.strand[k])) == want), rid
    log(f"[golden] {len(ids)} pairs of bin 0: device matches, primaries, "
        f"proper flags and TLEN == golden")


# ------------------------------------------------------------- --four

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _mapper_cmd(db: Path, reads: list[Path], out: Path, extra=()):
    return [sys.executable, "-m", "dream_yara_tpu.cli.mapper_cli", str(db),
            *map(str, reads), "-o", str(out), "-e", str(ERROR_RATE),
            "-ll", str(LL), "-ld", str(LD), "-rb", str(2 * N_FOUR), *extra]


def _run(cmds: list[list[str]], env: dict, label: str):
    """Run commands concurrently (one per GPU when several), fail on any
    non-zero exit."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for c in cmds]
    outs = [p.communicate(timeout=900) for p in procs]
    for p, (so, se) in zip(procs, outs):
        if p.returncode:
            raise RuntimeError(f"{label}: exit {p.returncode}\n"
                               f"{se.decode()[-4000:]}")
    log(f"[four] {label}: {time.perf_counter() - t0:.1f}s")


def phase_four(work: Path, seed: int):
    """One process per GPU at a time: the parent holds no device memory
    (XLA_PYTHON_CLIENT_PREALLOCATE=false is set before JAX starts)."""
    from dream_yara_tpu.parallel.multihost import local_gpu_count

    fastas, *_ = make_workload(work, seed, N_FOUR, N_FOUR)
    db = build_db(work, fastas, hbm_gb="64")
    env = {k: v for k, v in os.environ.items()
           if k != "XLA_PYTHON_CLIENT_PREALLOCATE"}
    env["PYTHONPATH"] = str(ROOT)
    log(f"[four] local GPUs seen by the launcher: {local_gpu_count()}")
    for reads, tag in (([work / "se.fq"], "se"),
                       ([work / "pe_1.fq", work / "pe_2.fq"], "pe")):
        one = work / f"{tag}_one.sam"
        _run([_mapper_cmd(db, reads, one)],
             {**env, "CUDA_VISIBLE_DEVICES": "0"}, f"{tag} one GPU")
        mesh = work / f"{tag}_mesh4.sam"
        _run([_mapper_cmd(db, reads, mesh, ["--mesh"])], env,
             f"{tag} --mesh over 4 GPUs")
        check_identical(one, mesh, f"{tag.upper()} one GPU vs 4-GPU mesh")
        mh = work / f"{tag}_mh4.sam"
        port = _free_port()
        _run([_mapper_cmd(db, reads, mh,
                          ["--coordinator", f"localhost:{port}",
                           "--num-processes", "4", "--process-id", str(i)])
              for i in range(4)], env, f"{tag} multi-host, 4 processes")
        check_identical(one, mh, f"{tag.upper()} one GPU vs 4-process "
                                 f"multi-host")


# ------------------------------------------------------------------ main

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=2024)
    ap.add_argument("--workdir", default=None,
                    help="directory for the generated data (default: a new "
                         "temporary directory)")
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU phase")
    a = ap.parse_args(argv)
    work = Path(a.workdir or tempfile.mkdtemp(prefix="chip_smoke_"))
    work.mkdir(parents=True, exist_ok=True)
    count = 4 if a.four else 1
    if a.four:
        os.environ["XLA_PYTHON_CLIENT_PREALLOCATE"] = "false"
    t0 = time.time()
    devs = phase_device(count)
    gpu_line = gpu_name_and_power()
    log(f"[device] nvidia-smi: {gpu_line}")
    if a.four:
        phase_four(work, a.seed)
    else:
        phase_kernel(np.random.default_rng(a.seed), gpu_line.splitlines()[0])
        fastas, se, se_truth, pe, pe_truth = make_workload(
            work, a.seed, N_SE, N_PE)
        db = build_db(work, fastas)
        phase_main(work, db, se_truth, pe_truth, N_SE, N_PE)
        phase_golden(db, se, se_truth, pe, pe_truth)
    log(f"[done] all phases passed in {time.time() - t0:.0f}s")
    print(gpu_line)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
