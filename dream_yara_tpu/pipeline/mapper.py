"""Single-bin mapper orchestration — analog of reference src/mapper.h Mapper /
mapReads [U] for the one-bin case (the DREAM multi-bin driver builds on this,
parallel/ + dis_mapper).

Host loop: pad the batch into fixed-size chunks (one XLA compile per shape),
run the jitted map step per chunk, spill overflowing seeds to a host fallback
(completeness: fixed device capacity never drops matches, SURVEY.md §7 hard
part 3), then dedup/rank/CIGAR/SAM on host.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..index.fmindex import FMIndex
from ..io.readstore import ReadBatch
from ..io.seqstore import SeqStore
from ..ops.device_index import DeviceFM
from ..utils.options import MapperOptions
from ..utils.timer import StageTimers
from .cigar import compute_cigars
from .map_step import MapStepOut, max_seed_len_static, single_bin_map_step, verify_positions
from .matches import Matches, Ranked, build_matches, dedup_matches, rank_matches
from .seeding import max_errors_for_batch, rate_to_ppm
from .writer import GlobalContigs, sam_header, write_se_records

CHUNK_SIZES = (2048, 16384, 131072)
                             # seq-row chunk shapes (bounded compile set);
                             # large chunks amortize the per-dispatch floor,
                             # small ones serve little per-bin read subsets
FALLBACK_PAD = 4096          # fixed shape for overflow-verify calls


class BinMapper:
    """Maps read batches against ONE bin (local coordinates)."""

    def __init__(self, store: SeqStore, fm: FMIndex, opts: MapperOptions,
                 timers: StageTimers | None = None, dev: DeviceFM | None = None,
                 prefix_q: int | None = None, sample_rate: int | None = None,
                 rfused: "np.ndarray | None" = None):
        """`dev` lets callers that already hold the bin's index on device
        (e.g. the mesh driver's DeviceFMSet) pass an on-device view instead
        of re-uploading from the host. `prefix_q` /
        `sample_rate` must then describe THAT layout (a stacked set uses the
        common q / rate over bins, which can differ from this bin's own).
        `rfused`: reverse-text fused rank rows (index/bifm.py) — enables the
        bidirectional search-scheme seed backend."""
        self.store = store
        self.fm = fm
        self.opts = opts
        self.dev = (DeviceFM.from_host(fm, store.text, rfused=rfused)
                    if dev is None else dev)
        self.prefix_q = fm.prefix_q if prefix_q is None else prefix_q
        self.sample_rate = fm.sample_rate if sample_rate is None else sample_rate
        self.timers = timers or StageTimers()
        from .map_step import verify_uses_kernel
        self.use_pallas = verify_uses_kernel()

    def map_batch(self, batch: ReadBatch, capacity: int = 8) -> Matches:
        """All matches (bin-local global-text coords)."""
        return self.map_batch_async(batch, capacity)()

    def map_batch_async(self, batch: ReadBatch, capacity: int = 8):
        """Dispatch the batch's device work NOW (uploads + map-step compute
        queued async), return a drain() closure that blocks, fetches and
        post-processes. Callers that dispatch batch i+1 before draining
        batch i hide the fixed per-transfer cost under batch i's
        compute (the device edition of the reference's prefetched reader,
        SURVEY.md §2.10 pipeline-parallelism row)."""
        opts = self.opts
        rate_ppm = rate_to_ppm(opts.error_rate)
        n = batch.n_reads
        L = batch.max_len
        max_err = max(1, max_errors_for_batch(L, opts.error_rate))
        max_slen = max_seed_len_static(L, rate_ppm)
        ns = max_err + 1

        # pick the smallest chunk shape that fits the batch (bounded compile set)
        chunk_rows = CHUNK_SIZES[-1]
        for cs in CHUNK_SIZES:
            if 2 * n <= cs:
                chunk_rows = cs
                break
        half = chunk_rows // 2
        # global verify budget: kept candidates from the whole chunk are
        # compacted into one buffer of ~1 lane per seq row (clean reads use
        # ~0.5, repetitive ones many) — 4x fewer verify lanes AND 4x fewer
        # fetched bytes than the per-row scheme; spills re-run densely
        compact_cap = chunk_rows

        from .map_step import (pack_reads_fwd, single_bin_map_step_packed,
                               unbundle_out)

        prefix_q = self.prefix_q if self.dev.pfx_lo is not None else 0
        # gather-free seed-char fast path (see map_step.uniform_len_ok)
        from .map_step import uniform_len_ok
        uniform_len = uniform_len_ok(batch.lengths, L, rate_ppm, max_err)
        step_kw = dict(rate_ppm=rate_ppm, max_errors=max_err,
                       capacity=capacity, max_slen=max_slen,
                       prefix_q=prefix_q, use_pallas=self.use_pallas,
                       sample_rate=self.sample_rate, uniform_len=uniform_len)

        # launch all chunks first (async dispatch), then drain results.
        # uploads are 2-bit-packed fwd rows (~9x smaller); rc rows are
        # rebuilt on device.
        pending = []
        from ..ops.readpack import pack_blob_with_lengths

        for c0 in range(0, n, half):
            ids = np.arange(c0, min(c0 + half, n))
            lens_c = np.zeros(half, dtype=np.int32)
            lens_c[: len(ids)] = batch.lengths[ids]
            blob = jnp.asarray(pack_blob_with_lengths(
                batch.seqs[ids], lens_c, half, L))
            with self.timers.stage("seed+search+verify (device)"):
                out = single_bin_map_step_packed(
                    self.dev, blob, half=half, L=L, compact_cap=compact_cap,
                    **step_kw)
            pending.append((out, ids, blob, lens_c))

        def drain():
            return self._drain_pending(pending, batch, n, half, chunk_rows, L,
                                       max_err, rate_ppm, step_kw)
        return drain

    def _drain_pending(self, pending, batch, n, half, chunk_rows, L,
                       max_err, rate_ppm, step_kw) -> Matches:
        from concurrent.futures import ThreadPoolExecutor

        from .map_step import single_bin_map_step_packed, unbundle_out

        def full_reads(ids):
            reads_c = np.full((chunk_rows, L), 4, dtype=np.int8)
            reads_c[: len(ids)] = batch.seqs[ids]
            reads_c[half : half + len(ids)] = batch.seqs[n + ids]
            return reads_c

        # ONE fetch per chunk for all per-candidate outputs + scalars; the
        # (S,) seed-interval arrays stay on device unless overflow occurred.
        # Fetches run on a worker thread so chunk i+1's device-wait + d2h
        # overlaps chunk i's host post-processing below.
        fetch_pool = ThreadPoolExecutor(max_workers=1)
        futs = [fetch_pool.submit(np.asarray, p[0][0]) for p in pending]

        parts: list[Matches] = []
        for (out, ids, dev_in, lens_c), fut in zip(pending, futs):
            _bundle_dev, s_lo, s_hi, ovf, m_st = out
            with self.timers.stage("device wait+fetch"):
                bundle = fut.result()
            with self.timers.stage("collect matches (host)"):
                out = unbundle_out(bundle, s_lo, s_hi, ovf, m_st,
                                   L, max_err, chunk_rows)
            if int(out.n_spilled) > 0:
                # compaction spilled: redo this chunk verifying every slot,
                # in BOUNDED sub-chunks — verify_capacity=None lights up
                # R2*ns*capacity lanes, and at the 131k-row chunk shape on a
                # multi-10-Mbp bin that compiles to many GB of temporaries.
                # Matches replace the
                # compacted (incomplete) set; the seed/overflow arrays of
                # the compacted run stay valid (the seed stage is identical
                # per read and chunking-independent).
                with self.timers.stage("dense re-verify (device)"):
                    parts.extend(self._dense_reverify(
                        batch, ids, n, L, max_err, step_kw))
            else:
                with self.timers.stage("collect matches (host)"):
                    m = build_matches(out.row, out.begin, out.end, out.dist,
                                      out.ok, n_reads=half)
                    m = self._remap_chunk(m, ids, half, n)
                    parts.append(m)

            if int(out.overflow_total) > 0 and self.opts.sensitivity != "low":
                # sensitivity low: capacity-capped hits only — overflowing
                # (hyper-repetitive) locations are dropped, the fastest mode
                # (reference -y low analog [U])
                out = out._replace(seed_lo=np.asarray(out.seed_lo),
                                   seed_hi=np.asarray(out.seed_hi),
                                   overflow=np.asarray(out.overflow),
                                   m_start=np.asarray(out.m_start))
                reads_c = full_reads(ids)
                if self.opts.sensitivity == "full":
                    # complete: expand every spilled SA interval on host
                    with self.timers.stage("overflow fallback"):
                        parts.append(self._overflow_pass(
                            out, reads_c, lens_c, ids, half, n, max_err, rate_ppm))
                else:
                    # classifier path: re-seed repetitive rows with longer
                    # Hamming<=1 seeds (reference mapper_classifier.h [U])
                    with self.timers.stage("repetitive re-seed (device)"):
                        parts.append(self._repetitive_pass(
                            out, reads_c, lens_c, ids, half, n, max_err, rate_ppm))

        fetch_pool.shutdown(wait=False)
        # NOTE: dedup happens in map_single_bin AFTER the cross-contig filter,
        # so a dropped boundary-crossing match can never shadow a real one.
        return Matches.concat(parts)

    DENSE_HALF = 8192  # dense re-verify sub-chunk reads: 2*8192*ns*capacity
                       # lanes ~= 0.5M keeps the all-slots program's HBM
                       # footprint bounded regardless of the batch chunking

    def _dense_reverify(self, batch, ids, n, L, max_err, step_kw):
        """Re-map the chunk's reads with every slot verified (no compaction),
        in fixed-size sub-chunks. Output is identical to a whole-chunk dense
        pass: seeding, per-row dedup and verification are all row-local."""
        from ..ops.readpack import pack_blob_with_lengths
        from .map_step import single_bin_map_step_packed, unbundle_out

        sub_half = self.DENSE_HALF
        parts = []
        for s0 in range(0, len(ids), sub_half):
            sids = ids[s0 : s0 + sub_half]
            lens_s = np.zeros(sub_half, dtype=np.int32)
            lens_s[: len(sids)] = batch.lengths[sids]
            blob = jnp.asarray(pack_blob_with_lengths(
                batch.seqs[sids], lens_s, sub_half, L))
            bundle, s_lo, s_hi, ovf, m_st = single_bin_map_step_packed(
                self.dev, blob, half=sub_half, L=L, verify_capacity=None,
                **step_kw)
            o = unbundle_out(np.asarray(bundle), s_lo, s_hi, ovf, m_st,
                             L, max_err, 2 * sub_half)
            m = build_matches(o.row, o.begin, o.end, o.dist, o.ok,
                              n_reads=sub_half)
            parts.append(self._remap_chunk(m, sids, sub_half, n))
        return parts

    def _remap_chunk(self, m: Matches, ids: np.ndarray, half: int, n: int) -> Matches:
        """Chunk-local read ids/strands -> batch ids."""
        keep = m.read_id < len(ids)
        m = m.take(keep)
        m.read_id = ids[m.read_id].astype(np.int32)
        return m

    REP_PAD = 1024  # fixed row-group shape for the repetitive re-seed step

    REP1_T = 32  # stratum-1 window truncation (layout lanes ~ 8*t)
    REP2_T = 16  # stratum-2 truncation: 9*C(t,2) layouts must stay affordable

    def _seed_backend(self, rows_np, lens_c, rate_ppm, budget, indels,
                      t_max) -> str:
        """Pick the approximate-seed backend for one repetitive stratum.

        'bidir' (search schemes on the bidirectional index,
        ops/bidir_search.py) requires: the reverse rank rows on device, a
        substitution-only stratum, and FULL seed windows (every candidate
        row's seed length >= t_max — the scheme lane tables are laid out
        on the uniform m-grid). Anything else keeps the dense enumeration.
        DY_SEED_BACKEND=enum|bidir|auto overrides opts.seed_backend.
        """
        import os

        mode = os.environ.get("DY_SEED_BACKEND",
                              getattr(self.opts, "seed_backend", "auto"))
        if mode == "enum" or self.dev.rfused is None or indels \
                or len(rows_np) == 0:
            return "enum"
        l = lens_c[rows_np % lens_c.shape[0]].astype(np.int64)
        e = (l * rate_ppm) // 10_000
        ns2 = (e + budget + 1) // (budget + 1)
        slen = np.where(ns2 > 0, l // np.maximum(ns2, 1), 0)
        return "bidir" if (slen >= t_max).all() else "enum"

    def _repetitive_pass(self, out: MapStepOut, reads_c, lens_c, ids, half, n,
                         max_err, rate_ppm) -> Matches:
        """Device re-seed of rows whose exact seeds overflowed (sensitivity
        high/low). Stratum 1: ceil((E+1)/2) long seeds with <=1 edit
        (substitutions; +indels when -i on). Stratum 2 (reference
        findSeeds<2> analog): rows STILL without a match after stratum 1
        get ceil((E+1)/3) seeds searched with <=2 substitutions."""
        from .map_step import max_rep_seed_len_static, repetitive_map_step

        ns = max_err + 1
        R2 = reads_c.shape[0]
        rep_rows = np.flatnonzero(
            np.asarray(out.overflow).reshape(R2, ns).sum(axis=1) > 0
        ).astype(np.int32)
        if len(rep_rows) == 0:
            return Matches.concat([])
        msl = max_rep_seed_len_static(reads_c.shape[1], rate_ppm)
        reads_j = jnp.asarray(reads_c)
        lens_j = jnp.asarray(lens_c)

        def run(rows_np, budget, indels, t_max):
            backend = self._seed_backend(rows_np, lens_c, rate_ppm,
                                         budget, indels, t_max)
            parts, matched = [], np.zeros(0, dtype=np.int64)
            for b0 in range(0, len(rows_np), self.REP_PAD):
                rb = rows_np[b0 : b0 + self.REP_PAD]
                padn = self.REP_PAD - len(rb)
                mask = np.concatenate([np.ones(len(rb), bool),
                                       np.zeros(padn, bool)])
                rb = np.concatenate([rb, np.zeros(padn, np.int32)])
                row, beg, end, dist, ok, _sp = repetitive_map_step(
                    self.dev, reads_j, lens_j, jnp.asarray(rb),
                    jnp.asarray(mask), rate_ppm=rate_ppm, max_errors=max_err,
                    capacity=4, max_slen_rep=t_max,
                    use_pallas=self.use_pallas, budget=budget, indels=indels,
                    backend=backend)
                row, ok = np.asarray(row), np.asarray(ok)
                matched = np.union1d(matched, row[ok])
                m = build_matches(row, np.asarray(beg), np.asarray(end),
                                  np.asarray(dist), ok, n_reads=half)
                parts.append(self._remap_chunk(m, ids, half, n))
            return parts, matched

        parts, matched = run(rep_rows, budget=1, indels=self.opts.indels,
                             t_max=min(msl, self.REP1_T))
        # stratum 2: rows the 1-edit stratum could not place at all
        rows2 = np.setdiff1d(rep_rows, matched).astype(np.int32)
        if len(rows2):
            p2, _ = run(rows2, budget=2, indels=False,
                        t_max=min(msl, self.REP2_T))
            parts += p2
        return Matches.concat(parts)

    def _overflow_pass(self, out: MapStepOut, reads_c, lens_c, ids, half, n,
                       max_err, rate_ppm) -> Matches:
        """Verify seed hits beyond device capacity (host expansion, device verify)."""
        over_seeds = np.flatnonzero(out.overflow > 0)
        rows_l, anchors_l = [], []
        ns = max_err + 1
        sa = self.fm.sa
        cap = out.seed_hi - out.seed_lo - out.overflow  # == device capacity where overflowed
        for s in over_seeds:
            lo, hi = int(out.seed_lo[s]) + int(cap[s]), int(out.seed_hi[s])
            row = s // ns
            l = int(lens_c[row % half]) if row % half < len(ids) else 0
            if l == 0:
                continue
            # true start of the matched part, as reported by the device search
            start = int(out.m_start[s])
            if self.fm.sample_rate > 1:
                pos = np.array([self.fm.locate(r) for r in range(lo, hi)],
                               dtype=np.int64)
            else:
                pos = sa[lo:hi].astype(np.int64)
            rows_l.append(np.full(len(pos), row, dtype=np.int32))
            anchors_l.append((pos - start).astype(np.int32))
        if not rows_l:
            return Matches.concat([])
        rows = np.concatenate(rows_l)
        anchors = np.concatenate(anchors_l)
        parts = []
        for b0 in range(0, len(rows), FALLBACK_PAD):
            rb = rows[b0 : b0 + FALLBACK_PAD]
            ab = anchors[b0 : b0 + FALLBACK_PAD]
            padn = FALLBACK_PAD - len(rb)
            mask = np.concatenate([np.ones(len(rb), bool), np.zeros(padn, bool)])
            rb = np.concatenate([rb, np.zeros(padn, np.int32)])
            ab = np.concatenate([ab, np.zeros(padn, np.int32)])
            dist, beg, end = verify_positions(
                self.dev, jnp.asarray(reads_c), jnp.asarray(lens_c),
                jnp.asarray(rb), jnp.asarray(ab), jnp.asarray(mask),
                max_errors=max_err)
            dist, beg, end = np.asarray(dist), np.asarray(beg), np.asarray(end)
            budget = (lens_c[np.clip(rb, 0, 2 * half - 1) % half] * rate_ppm) // 10_000
            ok = mask & (dist <= budget) & (beg >= 0) & (end <= self.fm.n)
            m = build_matches(rb, beg, end, dist, ok, n_reads=half)
            parts.append(self._remap_chunk(m, ids, half, n))
        return Matches.concat(parts)


def map_single_bin(store: SeqStore, fm: FMIndex, batch: ReadBatch,
                   opts: MapperOptions, rfused: np.ndarray | None = None
                   ) -> tuple[Ranked, list[str], GlobalContigs]:
    """Full single-bin SE pipeline: matches -> contig filter -> rank -> CIGARs."""
    mapper = BinMapper(store, fm, opts, rfused=rfused)
    m = mapper.map_batch(batch)

    contigs = GlobalContigs.from_stores([store])
    ok = contigs.same_contig_span(m.begin, m.end)
    m = dedup_matches(m.take(ok))

    ranked = rank_matches(m, batch.n_reads, strata_count=opts.strata_count)

    max_err = max(1, max_errors_for_batch(batch.max_len, opts.error_rate))
    rows = (ranked.matches.read_id +
            ranked.matches.strand.astype(np.int32) * batch.n_reads)
    cigars = compute_cigars(store.text, batch.seqs, rows,
                            batch.lengths[ranked.matches.read_id],
                            ranked.matches.begin, ranked.matches.end, max_err,
                            dists=ranked.matches.dist)
    return ranked, cigars, contigs


def single_bin_sam(store: SeqStore, fm: FMIndex, batch: ReadBatch,
                   opts: MapperOptions, cmdline: str = "") -> bytes:
    if batch.paired:
        return paired_bin_sam(store, fm, batch, opts, cmdline)
    ranked, cigars, contigs = map_single_bin(store, fm, batch, opts)
    return (("\n".join(sam_header(contigs, cmdline,
                                   read_group=opts.read_group or None))
             + "\n").encode()
            + write_se_records(batch, contigs, ranked, cigars,
                               read_group=opts.read_group or None,
                               secondary_mode=opts.secondary_matches))


def rescue_mates(mapper: BinMapper, batch: ReadBatch, ranked: Ranked,
                 opts: MapperOptions, max_err: int, rate_ppm: int) -> Matches:
    """Mate rescue: verify unmapped mates in the insert window around their
    mapped partner (reference mapper_verifier.h [U], SURVEY.md §3.5)."""
    from .pairs import rescue_candidates

    cands = rescue_candidates(ranked, batch.n_reads, batch.lengths,
                              opts.library_length, opts.library_deviation,
                              band=max_err)
    if len(cands.rows) == 0:
        return Matches.concat([])
    n = batch.n_reads
    parts = []
    reads_j = jnp.asarray(batch.seqs)
    lens_j = jnp.asarray(batch.lengths)
    for b0 in range(0, len(cands.rows), FALLBACK_PAD):
        rb = cands.rows[b0 : b0 + FALLBACK_PAD]
        # single-bin path: global == bin-local coords, safe to narrow (the FM
        # index itself is int32); multi-bin callers subtract the bin start
        # from the int64 global anchors first (_rescue_global)
        ab = cands.anchors[b0 : b0 + FALLBACK_PAD].astype(np.int32)
        padn = FALLBACK_PAD - len(rb)
        mask = np.concatenate([np.ones(len(rb), bool), np.zeros(padn, bool)])
        rb = np.concatenate([rb, np.zeros(padn, np.int32)])
        ab = np.concatenate([ab, np.zeros(padn, np.int32)])
        dist, beg, end = verify_positions(
            mapper.dev, reads_j, lens_j, jnp.asarray(rb), jnp.asarray(ab),
            jnp.asarray(mask), max_errors=max_err)
        dist, beg, end = np.asarray(dist), np.asarray(beg), np.asarray(end)
        budget = (batch.lengths[rb % n] * rate_ppm) // 10_000
        ok = mask & (dist <= budget) & (beg >= 0) & (end <= mapper.fm.n)
        parts.append(build_matches(rb, beg, end, dist, ok, n_reads=n))
    return Matches.concat(parts)


def map_paired_bin(store: SeqStore, fm: FMIndex, batch: ReadBatch,
                   opts: MapperOptions):
    """Full single-bin PE pipeline: map both mates, rescue, pair, CIGARs."""
    from .pairs import select_pairs

    mapper = BinMapper(store, fm, opts)
    m = mapper.map_batch(batch)
    contigs = GlobalContigs.from_stores([store])
    rate_ppm = rate_to_ppm(opts.error_rate)
    max_err = max(1, max_errors_for_batch(batch.max_len, opts.error_rate))

    def finish(mm: Matches) -> Ranked:
        ok = contigs.same_contig_span(mm.begin, mm.end)
        return rank_matches(dedup_matches(mm.take(ok)), batch.n_reads,
                            strata_count=opts.strata_count)

    ranked = finish(m)
    if opts.rescue:
        rescued = rescue_mates(mapper, batch, ranked, opts, max_err, rate_ppm)
        if len(rescued):
            ranked = finish(Matches.concat([m, rescued]))

    pair_info = select_pairs(ranked, batch.n_reads, contigs,
                             opts.library_length, opts.library_deviation)
    rows = (ranked.matches.read_id +
            ranked.matches.strand.astype(np.int32) * batch.n_reads)
    cigars = compute_cigars(store.text, batch.seqs, rows,
                            batch.lengths[ranked.matches.read_id],
                            ranked.matches.begin, ranked.matches.end, max_err,
                            dists=ranked.matches.dist)
    return ranked, cigars, contigs, pair_info


def paired_bin_sam(store: SeqStore, fm: FMIndex, batch: ReadBatch,
                   opts: MapperOptions, cmdline: str = "") -> bytes:
    from .writer import write_pe_records

    ranked, cigars, contigs, pair_info = map_paired_bin(store, fm, batch, opts)
    return (("\n".join(sam_header(contigs, cmdline,
                                   read_group=opts.read_group or None))
             + "\n").encode()
            + write_pe_records(batch, contigs, ranked, cigars, pair_info,
                               read_group=opts.read_group or None,
                               secondary_mode=opts.secondary_matches))
