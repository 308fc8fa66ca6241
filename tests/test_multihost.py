"""Multi-host validation (SURVEY.md §5.8, BASELINE config 3): 2 jax
processes x 4 virtual CPU devices each, per-process bin-shard loading,
cross-host merge — SAM byte-identical to the single-process pipeline."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dream_yara_tpu.index.fmindex import FMIndex
from dream_yara_tpu.index.ibf import InterleavedBloomFilter
from dream_yara_tpu.io.readstore import ReadBatch
from dream_yara_tpu.io.seqstore import SeqStore
from dream_yara_tpu.pipeline.dis_mapper import DreamIndex, dream_map_sam
from dream_yara_tpu.utils.alphabet import revcomp
from dream_yara_tpu.utils.options import MapperOptions
from tests.conftest import mutate, random_text

REPO = Path(__file__).parent.parent


def _write_db(tmp, rng, B=4, glen=5000, sample_rate=1):
    import json

    genomes = [random_text(rng, glen) for _ in range(B)]
    stores = [SeqStore.from_seqs([f"g{b}"], [genomes[b]]) for b in range(B)]
    fms = [FMIndex.build(st.text, sample_rate=sample_rate) for st in stores]
    filt = InterleavedBloomFilter.create(B, size_bits=1 << 22, n_hashes=3, k=19)
    (tmp / "db" / "bins").mkdir(parents=True)
    for b in range(B):
        stores[b].save(tmp / "db" / "bins" / f"{b:04d}.store.npz")
        fms[b].save(tmp / "db" / "bins" / f"{b:04d}.fm.npz")
        filt.add_kmers(genomes[b], b)
    filt.save(tmp / "db" / "db.filter")
    (tmp / "db" / "meta.json").write_text(json.dumps({"n_bins": B}))
    return genomes, DreamIndex(stores, fms, filt, "bloom")


def _write_fastq(path, names, reads):
    with open(path, "w") as f:
        for nm, r in zip(names, reads):
            s = "".join("ACGTN"[c] for c in r)
            f.write(f"@{nm}\n{s}\n+\n{'I' * len(s)}\n")


@pytest.mark.slow
def test_two_process_sam_identical(tmp_path):
    rng = np.random.default_rng(42)
    genomes, index = _write_db(tmp_path, rng)
    names, reads = [], []
    for b, g in enumerate(genomes):
        for i in range(5):
            p = int(rng.integers(0, len(g) - 100))
            r = mutate(rng, g[p : p + 100].copy(), n_sub=1)
            if (b + i) % 2:
                r = revcomp(r)
            names.append(f"b{b}r{i}")
            reads.append(r)
    _write_fastq(tmp_path / "reads.fq", names, reads)

    # reference: single-process DREAM pipeline on the same DB
    batch = ReadBatch.from_reads(names, reads)
    opts = MapperOptions(error_rate=0.03)
    ref = dream_map_sam(index, batch, opts, cmdline="multihost_demo").decode()

    env = {**os.environ,
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    port = 12397
    procs = []
    for pid in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / "tools" / "multihost_demo.py"),
             str(pid), "2", str(port), str(tmp_path / "db"),
             str(tmp_path / "reads.fq"), str(tmp_path / "out.sam")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-3000:]
    sam = (tmp_path / "out.sam").read_text()
    assert sam == ref, "2-process SAM differs from single-process"
    # each process really loaded only its own bins
    err0 = outs[0][1].decode()
    err1 = outs[1][1].decode()
    assert "my_bins=[0, 1]" in err0 and "my_bins=[2, 3]" in err1


@pytest.mark.slow
def test_two_process_sampled_sa_identical(tmp_path):
    """Sampled-SA bins (rate 4) across 2 processes: shard shapes derive
    from max_n, so processes with different local bins stay consistent;
    SAM byte-identical to single-process."""
    rng = np.random.default_rng(43)
    genomes, index = _write_db(tmp_path, rng, sample_rate=4)
    names, reads = [], []
    for b, g in enumerate(genomes):
        for i in range(4):
            p = int(rng.integers(0, len(g) - 100))
            r = mutate(rng, g[p : p + 100].copy(), n_sub=1)
            if (b + i) % 2:
                r = revcomp(r)
            names.append(f"b{b}r{i}")
            reads.append(r)
    _write_fastq(tmp_path / "reads.fq", names, reads)
    batch = ReadBatch.from_reads(names, reads)
    opts = MapperOptions(error_rate=0.03)
    ref = dream_map_sam(index, batch, opts, cmdline="multihost_demo").decode()

    env = {**os.environ,
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    port = 12431
    procs = []
    for pid in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / "tools" / "multihost_demo.py"),
             str(pid), "2", str(port), str(tmp_path / "db"),
             str(tmp_path / "reads.fq"), str(tmp_path / "out.sam")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-3000:]
    sam = (tmp_path / "out.sam").read_text()
    assert sam == ref, "2-process sampled-SA SAM differs from single-process"


def _launch(nprocs, port, db, reads, out, extra=(), local_devices=4,
            timeout=600, wait=True):
    env = {**os.environ,
           "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS":
               f"--xla_force_host_platform_device_count={local_devices}"}
    procs = []
    for pid in range(nprocs):
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / "tools" / "multihost_demo.py"),
             str(pid), str(nprocs), str(port), str(db), str(reads),
             str(out), *map(str, extra)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    if not wait:
        return procs
    outs = [p.communicate(timeout=timeout) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-3000:]
    return outs


def _mk_reads(rng, genomes, n_per_bin=4):
    names, reads = [], []
    for b, g in enumerate(genomes):
        for i in range(n_per_bin):
            p = int(rng.integers(0, len(g) - 100))
            r = mutate(rng, g[p : p + 100].copy(), n_sub=1)
            if (b + i) % 2:
                r = revcomp(r)
            names.append(f"b{b}r{i}")
            reads.append(r)
    return names, reads


@pytest.mark.slow
def test_four_process_uneven_bins(tmp_path):
    """6 bins over 4 processes: hosts 0-2 own two bins, host 3 owns NONE
    (the padded bin range is empty) — the mesh program, collectives and
    merge must all tolerate a bin-less host; SAM byte-identical to
    single-process (VERDICT r2 weak #5: never >2 processes, even bins
    only)."""
    rng = np.random.default_rng(44)
    genomes, index = _write_db(tmp_path, rng, B=6, glen=3000)
    names, reads = _mk_reads(rng, genomes, n_per_bin=3)
    _write_fastq(tmp_path / "reads.fq", names, reads)
    batch = ReadBatch.from_reads(names, reads)
    ref = dream_map_sam(index, batch, MapperOptions(error_rate=0.03),
                        cmdline="multihost_demo").decode()
    outs = _launch(4, 12511, tmp_path / "db", tmp_path / "reads.fq",
                   tmp_path / "out.sam", local_devices=1)
    sam = (tmp_path / "out.sam").read_text()
    assert sam == ref, "4-process uneven-bin SAM differs from single-process"
    assert "my_bins=[4, 5]" in outs[2][1].decode()
    assert "my_bins=[]" in outs[3][1].decode()


@pytest.mark.slow
def test_eight_process_option_matrix(tmp_path):
    """8 processes x 1 device, 8 bins, with non-default reporting options
    (-sm record -s 1): the merged, replicated ranking must produce the
    same secondary records and strata widening as single-process."""
    rng = np.random.default_rng(45)
    genomes, index = _write_db(tmp_path, rng, B=8, glen=2500)
    names, reads = _mk_reads(rng, genomes, n_per_bin=2)
    _write_fastq(tmp_path / "reads.fq", names, reads)
    batch = ReadBatch.from_reads(names, reads)
    opts = MapperOptions(error_rate=0.03, secondary_matches="record",
                         strata_count=1)
    ref = dream_map_sam(index, batch, opts, cmdline="multihost_demo").decode()
    _launch(8, 12547, tmp_path / "db", tmp_path / "reads.fq",
            tmp_path / "out.sam", extra=["--sm", "record", "-s", "1"],
            local_devices=1)
    sam = (tmp_path / "out.sam").read_text()
    if sam != ref:
        from dream_yara_tpu.io.samdiff import diff_sam

        raise AssertionError("8-process differs:\n"
                             + diff_sam(sam, ref).report("8proc", "single"))


@pytest.mark.slow
def test_kill_one_process_and_restart(tmp_path):
    """Compose multihost with io/shards.py (VERDICT r2 weak #5: the two
    features were never composed): process 1 is killed after the first
    of three batches commits; the survivor is reaped; restarting the full
    set resumes past the committed shard and the final SAM is
    byte-identical to an uninterrupted single-process run."""
    import json

    rng = np.random.default_rng(46)
    genomes, index = _write_db(tmp_path, rng, B=4, glen=3000)
    names, reads = _mk_reads(rng, genomes, n_per_bin=6)   # 24 reads
    _write_fastq(tmp_path / "reads.fq", names, reads)
    shard_dir = tmp_path / "shards"

    # reference: one uninterrupted single-process run over the same batches
    batch_size = 8
    refs = []
    all_batch = ReadBatch.from_reads(names, reads)
    from dream_yara_tpu.pipeline.writer import sam_header
    ref_head = "\n".join(sam_header(index.contigs, "multihost_demo")) + "\n"
    for s in range(0, 24, batch_size):
        b = ReadBatch.from_reads(names[s : s + batch_size],
                                 reads[s : s + batch_size])
        refs.append(dream_map_sam(index, b, MapperOptions(error_rate=0.03),
                                  cmdline="multihost_demo", header=False
                                  ).decode())
    ref = ref_head + "".join(refs)

    # run 1: pid 1 dies after batch 0 commits; pid 0 hangs on the next
    # collective and is reaped by the harness
    procs = _launch(2, 12593, tmp_path / "db", tmp_path / "reads.fq",
                    tmp_path / "out.sam",
                    extra=["--batch-size", batch_size, "--shards", shard_dir,
                           "--crash-after", 1, "--crash-pid", 1],
                    local_devices=2, wait=False)
    rc1 = procs[1].wait(timeout=600)
    assert rc1 == 17, "injected crash must exit 17"
    try:
        procs[0].communicate(timeout=30)
    except subprocess.TimeoutExpired:
        procs[0].kill()
        procs[0].communicate()
    man = json.loads((shard_dir / "manifest.json").read_text())
    assert len(man["shards"]) >= 1, "batch 0 must be committed pre-crash"
    n_committed = len(man["shards"])

    # restart: resumes past committed shards, finishes, finalizes
    outs = _launch(2, 12601, tmp_path / "db", tmp_path / "reads.fq",
                   tmp_path / "out.sam",
                   extra=["--batch-size", batch_size, "--shards", shard_dir],
                   local_devices=2)
    man2 = json.loads((shard_dir / "manifest.json").read_text())
    assert len(man2["shards"]) == 3
    assert man2["shards"][: n_committed] == man["shards"][: n_committed]
    sam = (tmp_path / "out.sam").read_text()
    assert sam == ref, "resumed multihost SAM differs from uninterrupted run"
