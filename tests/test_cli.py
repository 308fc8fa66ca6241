"""End-to-end CLI flow: indexer -> build-filter -> mapper -> update-filter
(the reference's app-level golden-test style, SURVEY.md §4)."""

import numpy as np
import pytest

from dream_yara_tpu.cli import build_filter, indexer, mapper_cli, update_filter
from dream_yara_tpu.io.fasta import write_fasta
from dream_yara_tpu.utils.alphabet import decode
from tests.conftest import random_text


@pytest.fixture
def toy_db(tmp_path, rng):
    B = 3
    genomes = [random_text(rng, 5000) for _ in range(B)]
    bin_dir = tmp_path / "bins_fa"
    bin_dir.mkdir()
    for b, g in enumerate(genomes):
        write_fasta(bin_dir / f"bin{b}.fa", [f"g{b}"], [g])
    db = tmp_path / "db"
    indexer.main(["--bins-dir", str(bin_dir), "-o", str(db)])
    build_filter.main(["--bins-dir", str(bin_dir), "-o", str(db),
                       "-bs", "4m", "-k", "19"])
    return tmp_path, genomes, bin_dir, db


def write_reads(path, genomes, rng, n_per_bin=4, read_len=100):
    truth = []
    with open(path, "wb") as fh:
        for b, g in enumerate(genomes):
            for i in range(n_per_bin):
                p = int(rng.integers(0, len(g) - read_len))
                fh.write(b"@b%dr%d\n" % (b, i)
                         + decode(g[p : p + read_len]).encode()
                         + b"\n+\n" + b"I" * read_len + b"\n")
                truth.append((b, p))
    return truth


def test_cli_full_flow(toy_db, rng, capsys):
    tmp_path, genomes, bin_dir, db = toy_db
    fq = tmp_path / "reads.fq"
    truth = write_reads(fq, genomes, rng)
    out = tmp_path / "out.sam"
    mapper_cli.main([str(db), str(fq), "-o", str(out), "-e", "0.03"])
    lines = out.read_text().strip().split("\n")
    recs = {l.split("\t")[0]: l.split("\t") for l in lines if not l.startswith("@")}
    assert len(recs) == len(truth)
    for i, (b, p) in enumerate(truth):
        r = recs[f"b{b}r{i % 4}"]
        assert r[2] == f"g{b}"
        assert int(r[3]) == p + 1
        assert r[5] == "100M"
        assert int(r[4]) == 40

    # dynamic update: replace bin 1
    new_g = random_text(rng, 5000)
    nf = tmp_path / "new1.fa"
    write_fasta(nf, ["g1"], [new_g])
    indexer.main([str(nf), "-o", str(db), "--bin-id", "1"])
    update_filter.main([str(nf), "-b", "1", "-o", str(db)])
    fq2 = tmp_path / "reads2.fq"
    p = 777
    with open(fq2, "wb") as fh:
        fh.write(b"@nr\n" + decode(new_g[p : p + 100]).encode()
                 + b"\n+\n" + b"I" * 100 + b"\n")
    out2 = tmp_path / "out2.sam"
    mapper_cli.main([str(db), str(fq2), "-o", str(out2), "-e", "0.03"])
    rec = [l.split("\t") for l in out2.read_text().strip().split("\n")
           if not l.startswith("@")][0]
    assert rec[2] == "g1" and int(rec[3]) == p + 1


def test_cli_pe_flow(toy_db, rng):
    from dream_yara_tpu.utils.alphabet import revcomp

    tmp_path, genomes, bin_dir, db = toy_db
    fq1, fq2 = tmp_path / "r1.fq", tmp_path / "r2.fq"
    g = genomes[0]
    with open(fq1, "wb") as f1, open(fq2, "wb") as f2:
        for i in range(4):
            p = int(rng.integers(0, len(g) - 400))
            t = 300
            f1.write(b"@pr%d\n" % i + decode(g[p : p + 100]).encode()
                     + b"\n+\n" + b"I" * 100 + b"\n")
            f2.write(b"@pr%d\n" % i
                     + decode(revcomp(g[p + t - 100 : p + t])).encode()
                     + b"\n+\n" + b"I" * 100 + b"\n")
    out = tmp_path / "pe.sam"
    mapper_cli.main([str(db), str(fq1), str(fq2), "-o", str(out),
                     "-e", "0.03", "-ll", "300", "-ld", "50"])
    recs = [l.split("\t") for l in out.read_text().strip().split("\n")
            if not l.startswith("@")]
    assert len(recs) == 8
    assert all(int(r[1]) & 0x1 for r in recs)
    assert all(int(r[1]) & 0x2 for r in recs), [r[1] for r in recs]
    tl = {r[0]: abs(int(r[8])) for r in recs}
    assert all(v == 300 for v in tl.values())


def test_indexer_auto_sample_rate(tmp_path, rng):
    """The default must never build artifacts the flagship config cannot
    load. Auto rate = smallest of (1,8,16,32) whose whole-DB footprint
    fits half of the device-memory budget; tiny DBs keep the full SA;
    --bin-id rebuilds inherit the DB's existing rate from meta.json."""
    import json

    from dream_yara_tpu.cli.indexer import auto_sample_rate
    from dream_yara_tpu.index.fmindex import FMIndex

    # pure rule: small DB -> full SA; paper-geometry 2 Gbp -> sampled
    assert auto_sample_rate(5_000_000, 16.0) == 1
    assert auto_sample_rate(2_050_000_000, 16.0) == 8
    assert auto_sample_rate(60_000_000_000, 16.0) == 32  # refuse-path scale
    assert auto_sample_rate(2_050_000_000, None) == 1     # no known budget

    # end-to-end: explicit rate recorded in meta; --bin-id inherits it
    g = random_text(rng, 4000)
    fa = tmp_path / "b0.fa"
    write_fasta(fa, ["g0"], [g])
    db = tmp_path / "db"
    indexer.main([str(fa), "-o", str(db), "--sample-rate", "4"])
    assert json.loads((db / "meta.json").read_text())["sample_rate"] == 4
    g2 = random_text(rng, 4000)
    fa2 = tmp_path / "b0_new.fa"
    write_fasta(fa2, ["g0"], [g2])
    indexer.main([str(fa2), "-o", str(db), "--bin-id", "0"])
    fm = FMIndex.load(db / "bins" / "0000.fm.npz")
    assert fm.sample_rate == 4
