"""Single-bin SE pipeline vs the golden scalar model (SURVEY.md §4.1/§4.2)."""

import numpy as np
import pytest

from dream_yara_tpu.golden.golden_mapper import golden_map_se
from dream_yara_tpu.index.fmindex import FMIndex
from dream_yara_tpu.io.readstore import ReadBatch
from dream_yara_tpu.io.seqstore import SeqStore
from dream_yara_tpu.pipeline import map_single_bin, single_bin_sam
from dream_yara_tpu.pipeline.mapq import compute_mapq
from dream_yara_tpu.utils.alphabet import revcomp
from dream_yara_tpu.utils.options import MapperOptions
from tests.conftest import mutate, random_text


def make_case(rng, genome_len=6000, n_reads=40, read_len=80, planted_errors=2,
              n_contigs=2):
    splits = sorted(rng.integers(500, genome_len - 500, n_contigs - 1).tolist())
    genome = random_text(rng, genome_len)
    bounds = [0, *splits, genome_len]
    seqs = [genome[bounds[i] : bounds[i + 1]] for i in range(n_contigs)]
    store = SeqStore.from_seqs([f"c{i}" for i in range(n_contigs)], seqs)
    fm = FMIndex.build(store.text)

    names, reads = [], []
    for i in range(n_reads):
        # sample from the sentinel-separated text, avoiding boundaries
        while True:
            p = int(rng.integers(0, len(store.text) - read_len))
            window = store.text[p : p + read_len]
            if (window < 4).all():
                break
        r = window.copy()
        if planted_errors:
            r = mutate(rng, r, n_sub=int(rng.integers(0, planted_errors + 1)))
        if rng.random() < 0.5:
            r = revcomp(r)
        names.append(f"r{i}")
        reads.append(r)
    # a couple of unmappable reads
    names += ["junk0", "junk1"]
    reads += [random_text(rng, read_len), random_text(rng, read_len)]
    batch = ReadBatch.from_reads(names, reads)
    return store, fm, batch


@pytest.mark.parametrize("seed", [0, 1])
def test_pipeline_matches_golden(seed):
    rng = np.random.default_rng(seed)
    store, fm, batch = make_case(rng)
    opts = MapperOptions(error_rate=0.05, strata_count=0)
    ranked, cigars, contigs = map_single_bin(store, fm, batch, opts)
    golden = golden_map_se(store, fm, batch, error_rate=0.05, strata_count=0)

    m = ranked.matches
    for rid in range(batch.n_reads):
        g = golden[rid]
        idx = np.flatnonzero(m.read_id == rid)
        got = [(int(m.dist[i]), int(m.begin[i]), int(m.end[i]), int(m.strand[i]))
               for i in idx]
        want = [(d, b, e, s) for (d, b, e, s) in g.matches]
        assert got == want, f"read {rid}: {got} != {want}"
        assert int(ranked.c1[rid]) == g.c1
        assert int(ranked.c2[rid]) == g.c2
    mapq = compute_mapq(ranked.c1, ranked.c2)
    for rid in range(batch.n_reads):
        assert int(mapq[rid]) == golden[rid].mapq


def test_cigar_consistency():
    """Every CIGAR must replay to (read_len, span_len, NM)."""
    rng = np.random.default_rng(2)
    store, fm, batch = make_case(rng, planted_errors=3)
    opts = MapperOptions(error_rate=0.05)
    ranked, cigars, contigs = map_single_bin(store, fm, batch, opts)
    m = ranked.matches
    import re
    for i in range(len(m)):
        ops = re.findall(r"(\d+)([MID])", cigars[i])
        assert "".join(f"{c}{o}" for c, o in ops) == cigars[i]
        read_len = sum(int(c) for c, o in ops if o in "MI")
        span_len = sum(int(c) for c, o in ops if o in "MD")
        assert read_len == int(batch.lengths[m.read_id[i]])
        assert span_len == int(m.end[i] - m.begin[i])
        # replay cost: mismatches within M runs + I + D == NM
        row = int(m.read_id[i]) + int(m.strand[i]) * batch.n_reads
        read = batch.seqs[row, : read_len]
        span = store.text[m.begin[i] : m.end[i]]
        rpos = spos = cost = 0
        for c, o in ops:
            c = int(c)
            if o == "M":
                a, b = read[rpos : rpos + c], span[spos : spos + c]
                cost += int(((a != b) | (a >= 4) | (b >= 4)).sum())
                rpos += c; spos += c
            elif o == "I":
                cost += c; rpos += c
            else:
                cost += c; spos += c
        assert cost == int(m.dist[i]), f"match {i}: cigar {cigars[i]}"


def test_sam_output_shape():
    rng = np.random.default_rng(3)
    store, fm, batch = make_case(rng, n_reads=10)
    opts = MapperOptions(error_rate=0.05, secondary_matches="tag")
    sam = single_bin_sam(store, fm, batch, opts, cmdline="test").decode()
    lines = sam.strip().split("\n")
    header = [l for l in lines if l.startswith("@")]
    records = [l for l in lines if not l.startswith("@")]
    assert header[0].startswith("@HD")
    assert sum(1 for l in header if l.startswith("@SQ")) == store.n_contigs
    assert len(records) == batch.n_reads  # one line per read in tag mode
    for rec in records:
        f = rec.split("\t")
        assert len(f) >= 11
        flag = int(f[1])
        if flag & 0x4:
            assert f[2] == "*" and f[5] == "*"
        else:
            assert f[2] in store.names
            assert int(f[3]) >= 1
            assert any(t.startswith("NM:i:") for t in f[11:])


def test_sam_secondary_records_mode():
    rng = np.random.default_rng(4)
    # duplicated genome -> multi-mapping reads
    seg = random_text(rng, 700)
    store = SeqStore.from_seqs(["c0", "c1"], [seg, seg.copy()])
    fm = FMIndex.build(store.text)
    reads = [seg[100:180].copy() for _ in range(3)]
    batch = ReadBatch.from_reads(["a", "b", "c"], reads)
    opts = MapperOptions(error_rate=0.05, secondary_matches="record")
    sam = single_bin_sam(store, fm, batch, opts).decode()
    records = [l for l in sam.strip().split("\n") if not l.startswith("@")]
    # each read maps to both copies: 1 primary + 1 secondary
    assert len(records) == 6
    sec = [r for r in records if int(r.split("\t")[1]) & 0x100]
    assert len(sec) == 3
    # multi-mapping -> mapq 3 on primary
    prim = [r for r in records if not int(r.split("\t")[1]) & 0x100]
    assert all(int(r.split("\t")[4]) == 3 for r in prim)


def test_sampled_sa_pipeline_identical():
    """sample_rate=8 must produce byte-identical results to the full SA."""
    rng = np.random.default_rng(9)
    store, fm, batch = make_case(rng, n_reads=25)
    fm8 = fm.subsample_sa(8)
    opts = MapperOptions(error_rate=0.05)
    sam_full = single_bin_sam(store, fm, batch, opts)
    sam_samp = single_bin_sam(store, fm8, batch, opts)
    assert sam_full == sam_samp


@pytest.mark.parametrize("strata", [1, 2])
def test_strata_count_matches_golden(strata):
    """-s strata reporting window vs the golden model."""
    rng = np.random.default_rng(12)
    # duplicated segment => co- and sub-optimal matches exist
    seg = random_text(rng, 800)
    seg2 = seg.copy()
    seg2[::97] = (seg2[::97] + 1) % 4       # a slightly diverged copy
    store = SeqStore.from_seqs(["a", "b"], [np.concatenate([random_text(rng, 1500), seg]),
                                            np.concatenate([seg2, random_text(rng, 1200)])])
    fm = FMIndex.build(store.text)
    reads = [seg[i * 60 : i * 60 + 80].copy() for i in range(8)]
    batch = ReadBatch.from_reads([f"r{i}" for i in range(8)], reads)
    opts = MapperOptions(error_rate=0.05, strata_count=strata)
    ranked, cigars, contigs = map_single_bin(store, fm, batch, opts)
    golden = golden_map_se(store, fm, batch, error_rate=0.05, strata_count=strata)
    m = ranked.matches
    for rid in range(batch.n_reads):
        got = [(int(m.dist[i]), int(m.begin[i]), int(m.end[i]), int(m.strand[i]))
               for i in np.flatnonzero(m.read_id == rid)]
        want = golden[rid].matches
        assert got == want, rid
        assert int(ranked.c1[rid]) == golden[rid].c1
        assert int(ranked.c2[rid]) == golden[rid].c2


def test_dense_reverify_subchunks(monkeypatch):
    """Compaction spill -> dense re-verify path: the all-slots program now
    runs in bounded sub-chunks (the whole-chunk variant compiles to many GB
    of temporaries at 131k-row shapes on multi-10-Mbp bins). Force a spill with tandem-repeat reads and a tiny sub-chunk
    size, and require the exact same matches as the default path."""
    import dream_yara_tpu.pipeline.mapper as mapper_mod
    from dream_yara_tpu.pipeline.mapper import BinMapper

    rng = np.random.default_rng(123)
    unit = rng.integers(0, 4, 50).astype(np.int8)
    genome = np.concatenate([np.tile(unit, 50),
                             rng.integers(0, 4, 3000).astype(np.int8)])
    store = SeqStore.from_seqs(["tand"], [genome])
    fm = FMIndex.build(store.text)
    reads = [np.tile(unit, 3)[:100].copy() for _ in range(700)]
    reads += [genome[i * 3 : i * 3 + 100].copy() for i in range(300)]
    batch = ReadBatch.from_reads([f"r{i}" for i in range(len(reads))], reads)
    opts = MapperOptions(error_rate=0.03, sensitivity="full")

    bm = BinMapper(store, fm, opts)
    m_ref = bm.map_batch(batch)
    assert bm.timers.totals.get("dense re-verify (device)", 0) > 0, \
        "workload must actually spill the verify compaction"

    monkeypatch.setattr(mapper_mod.BinMapper, "DENSE_HALF", 256)
    bm2 = BinMapper(store, fm, opts)
    m_sub = bm2.map_batch(batch)
    assert bm2.timers.totals.get("dense re-verify (device)", 0) > 0
    key = lambda m: sorted(zip(m.read_id.tolist(), m.strand.tolist(),
                               m.begin.tolist(), m.end.tolist(),
                               m.dist.tolist()))
    assert key(m_sub) == key(m_ref)
