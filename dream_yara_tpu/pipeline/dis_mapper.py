"""DREAM orchestration: IBF routing + per-bin mapping + global merge.

Reference analog: src/d_mapper.h runDisMapper/_mapReadsImpl + DisOptions [U]
(SURVEY.md §2.2, §3.1): load the filter, classify reads to candidate bins,
map each bin's read subset with the Yara core, copy matches back with the
bin's contig offset, then globally rank/pair/align/write.

Single-host edition: bins loop on one device (the mesh-sharded edition lives
in parallel/dist_mapper.py and reuses these stages shard-locally).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import jax.numpy as jnp

from ..index.fmindex import FMIndex
from ..index.ibf import InterleavedBloomFilter
from ..index.kdx import DirectKmerFilter
from ..io.readstore import ReadBatch
from ..io.seqstore import SeqStore
from ..utils.options import MapperOptions
from ..utils.timer import StageTimers
from .cigar import compute_cigars
from .mapper import BinMapper, FALLBACK_PAD
from .map_step import verify_positions
from .matches import Matches, Ranked, build_matches, dedup_matches, rank_matches
from .pairs import rescue_candidates, select_pairs
from .seeding import max_errors_for_batch, rate_to_ppm
from .writer import GlobalContigs, sam_header, write_pe_records, write_se_records

import threading as _threading

# finisher-pool threads (dream_map_stream) share the caller's stats dict
_STATS_LOCK = _threading.Lock()

IBF_READS = 32768  # reads per device IBF classify call


def bin_file(db_dir, bin_id: int, kind: str) -> Path:
    """Zero-padded per-bin artifact path (reference appendFileName [U])."""
    return Path(db_dir) / "bins" / f"{bin_id:04d}.{kind}.npz"


class DreamIndex:
    """All per-bin artifacts + the prefilter, loaded from a database dir."""

    def __init__(self, stores: list[SeqStore], fms: list[FMIndex], filt,
                 filter_type: str = "bloom",
                 rfused: dict[int, np.ndarray] | None = None):
        self.stores = stores
        self.fms = fms
        self.filter = filt
        self.filter_type = filter_type if filt is not None else "none"
        self.contigs = GlobalContigs.from_stores(stores)
        self.global_text = np.concatenate([st.text for st in stores])
        self._bin_mappers: dict[int, BinMapper] = {}
        # per-bin reverse-text rank rows (indexer --bidir sidecars)
        self.rfused = rfused or {}

    @property
    def n_bins(self) -> int:
        return len(self.stores)

    @classmethod
    def load(cls, db_dir, filter_type: str = "bloom") -> "DreamIndex":
        db_dir = Path(db_dir)
        meta = json.loads((db_dir / "meta.json").read_text())
        stores, fms, rfused = [], [], {}
        for b in range(meta["n_bins"]):
            stores.append(SeqStore.load(bin_file(db_dir, b, "store")))
            fms.append(FMIndex.load(bin_file(db_dir, b, "fm")))
            rp = bin_file(db_dir, b, "rfm")
            if rp.exists():
                rf = np.load(rp)["rfused"]
                # a stale sidecar (text changed without --bidir rebuild)
                # must not poison the search-scheme backend
                if rf.shape[0] == fms[-1].bwt_blocks.shape[0] + 1:
                    rfused[b] = rf
                else:
                    import sys as _sys
                    print(f"[dream] ignoring stale bidir sidecar {rp}",
                          file=_sys.stderr)
        filt = None
        if filter_type == "bloom" and (db_dir / "db.filter.npz").exists():
            filt = InterleavedBloomFilter.load(db_dir / "db.filter")
        elif filter_type == "kmer_direct" and (db_dir / "db.kdx.npz").exists():
            filt = DirectKmerFilter.load(db_dir / "db.kdx")
        return cls(stores, fms, filt, filter_type, rfused=rfused)

    def bin_mapper(self, b: int, opts: MapperOptions,
                   timers: StageTimers | None = None,
                   dev_factory=None, prefix_q: int | None = None,
                   sample_rate: int | None = None) -> BinMapper:
        """`dev_factory` (returning an on-device DeviceFM view, e.g. a
        DeviceFMSet.bin(b) slice) is called only on first construction — it
        spares the host->device upload when the caller already holds the whole
        database on device."""
        if b not in self._bin_mappers:
            self._bin_mappers[b] = BinMapper(self.stores[b], self.fms[b], opts,
                                             timers=timers,
                                             dev=dev_factory() if dev_factory
                                             else None,
                                             prefix_q=prefix_q,
                                             sample_rate=sample_rate,
                                             rfused=self.rfused.get(b))
        bm = self._bin_mappers[b]
        if timers is not None:
            bm.timers = timers
        return bm


def classify_reads(index: DreamIndex, batch: ReadBatch, opts: MapperOptions,
                   timers: StageTimers | None = None) -> np.ndarray:
    """Candidate bin mask per read: (n_reads, n_bins) bool.

    Reference clasifyLoadedReads [U] (sic): one filter query per read
    orientation; a read routes to a bin if EITHER orientation passes the
    k-mer-lemma threshold. filter_type none -> all bins.
    """
    n = batch.n_reads
    B = index.n_bins
    if index.filter_type == "none" or index.filter is None:
        return np.ones((n, B), dtype=bool)
    filt = index.filter
    rate_ppm = rate_to_ppm(opts.error_rate)
    # drop all-padding filter words (gathers pay per word; B<=32 bins only
    # ever consult word 0) — except in blocked mode, where trimming would
    # change the 128-word block geometry the filter was built with
    canonical = bool(getattr(filt, "canonical", 0))
    blocked = bool(getattr(filt, "blocked", 0))
    if blocked:
        # host-side block-row layout: a device reshape of (n_rows, 2)
        # words can relayout via a padded tiled copy at scale
        from ..ops.ibf_query import host_block_rows

        w_np, block_s = host_block_rows(filt.words, B)
        words = jnp.asarray(w_np)
    else:
        block_s = 0
        words = jnp.asarray(
            np.asarray(filt.words)[:, :max(1, (B + 31) // 32)])
    L = batch.max_len
    from ..ops.ibf_query import ibf_classify_packed
    from ..ops.readpack import pack_blob_with_lengths

    slack = getattr(filt, "slack_table", None)
    slack_j = jnp.asarray(np.asarray(slack, np.int32)) if slack is not None \
        else None
    mask = np.zeros((n, B), dtype=bool)
    shifts = np.arange(32, dtype=np.uint32)
    for c0 in range(0, n, IBF_READS):
        ids = np.arange(c0, min(c0 + IBF_READS, n))
        lens = np.zeros(IBF_READS, dtype=np.int32)
        lens[: len(ids)] = batch.lengths[ids]
        blob = pack_blob_with_lengths(batch.seqs[ids], lens, IBF_READS, L)
        cw = np.asarray(ibf_classify_packed(
            words, jnp.asarray(blob), slack_j, half=IBF_READS,
            L=L, k=filt.k, n_hashes=filt.n_hashes, rate_ppm=rate_ppm,
            window=getattr(filt, "window", 0), canonical=canonical,
            blocked=blocked, direct=bool(getattr(filt, "direct", 0)),
            n_bins=B, block_s=block_s))
        bits = ((cw[:, :, None] >> shifts) & 1).astype(bool)
        mask[ids] = bits.reshape(IBF_READS, -1)[: len(ids), :B]
    return mask


def _sub_batch(batch: ReadBatch, ids: np.ndarray) -> ReadBatch:
    n = batch.n_reads
    return ReadBatch(
        names=[batch.names[i] for i in ids],
        seqs=batch.seqs[np.concatenate([ids, n + ids])],
        lengths=batch.lengths[ids],
        quals=[batch.quals[i] for i in ids],
        paired=False,
    )


def dis_map_batch(index: DreamIndex, batch: ReadBatch, opts: MapperOptions,
                  timers: StageTimers | None = None) -> Matches:
    """Matches in GLOBAL coordinates across all candidate bins."""
    return dis_map_batch_async(index, batch, opts, timers)()


def dis_map_batch_async(index: DreamIndex, batch: ReadBatch,
                        opts: MapperOptions,
                        timers: StageTimers | None = None):
    """Dispatch all per-bin device work for the batch (async), return a
    drain() closure producing the merged global Matches. Dispatching batch
    i+1 before draining batch i hides its host->device upload (fixed
    per-transfer cost) under batch i's compute."""
    timers = timers or StageTimers()
    with timers.stage("ibf classify"):
        routing = classify_reads(index, batch, opts, timers)
    drains: list[tuple[int, np.ndarray, object]] = []
    for b in range(index.n_bins):
        ids = np.flatnonzero(routing[:, b])
        if len(ids) == 0:
            continue
        with timers.stage("per-bin subset prep (host)"):
            sub = _sub_batch(batch, ids)
            bm = index.bin_mapper(b, opts, timers)
        drains.append((b, ids, bm.map_batch_async(sub)))

    def drain() -> Matches:
        parts: list[Matches] = []
        for b, ids, d in drains:
            m = d()
            # copyMatches [U]: bin-local -> global coords + batch read ids
            off = int(index.contigs.bin_starts[b])
            m.begin += off
            m.end += off
            m.read_id = ids[m.read_id].astype(np.int32)
            parts.append(m)
        return Matches.concat(parts)

    return drain


def _rescue_global(index: DreamIndex, batch: ReadBatch, ranked: Ranked,
                   opts: MapperOptions, max_err: int, rate_ppm: int) -> Matches:
    """Mate rescue with bin-aware anchors (window may be in any bin)."""
    cands = rescue_candidates(ranked, batch.n_reads, batch.lengths,
                              opts.library_length, opts.library_deviation,
                              band=max_err)
    if len(cands.rows) == 0:
        return Matches.concat([])
    bin_of = np.searchsorted(index.contigs.bin_starts, cands.anchors,
                             side="right") - 1
    bin_of = np.clip(bin_of, 0, index.n_bins - 1)
    parts = []
    n = batch.n_reads
    reads_j = jnp.asarray(batch.seqs)
    lens_j = jnp.asarray(batch.lengths)
    for b in np.unique(bin_of):
        sel = bin_of == b
        rows = cands.rows[sel]
        anchors = (cands.anchors[sel]
                   - int(index.contigs.bin_starts[b])).astype(np.int32)
        bm = index.bin_mapper(int(b), opts)
        for b0 in range(0, len(rows), FALLBACK_PAD):
            rb = rows[b0 : b0 + FALLBACK_PAD]
            ab = anchors[b0 : b0 + FALLBACK_PAD]
            padn = FALLBACK_PAD - len(rb)
            mask = np.concatenate([np.ones(len(rb), bool), np.zeros(padn, bool)])
            rb = np.concatenate([rb, np.zeros(padn, np.int32)])
            ab = np.concatenate([ab, np.zeros(padn, np.int32)])
            dist, beg, end = verify_positions(
                bm.dev, reads_j, lens_j, jnp.asarray(rb), jnp.asarray(ab),
                jnp.asarray(mask), max_errors=max_err)
            dist, beg, end = np.asarray(dist), np.asarray(beg), np.asarray(end)
            budget = (batch.lengths[rb % n] * rate_ppm) // 10_000
            ok = mask & (dist <= budget) & (beg >= 0) & (end <= bm.fm.n)
            mm = build_matches(rb, beg, end, dist, ok, n_reads=n)
            off = int(index.contigs.bin_starts[b])
            mm.begin += off
            mm.end += off
            parts.append(mm)
    return Matches.concat(parts)


def dream_map_stream(index: DreamIndex, batches, opts: MapperOptions,
                     cmdline: str = "", timers: StageTimers | None = None,
                     stats: dict | None = None, header: bool = True):
    """Yield SAM text per batch, overlapping device mapping of batch i+1 with
    host post-processing of batch i (two-stage pipeline; the batch-scale
    analog of the reference's prefetched reader, SURVEY.md §2.10 pipeline
    parallelism row). The FASTQ reader itself prefetches a further batch, so
    steady state runs parse / device map / host finish concurrently.

    Host finishing (rank/dedup, CIGARs, SAM bytes) additionally runs on an
    ORDERED pool of DY_FINISH_WORKERS threads (default 2): once the device
    wall fell below the host-finish wall (config-1 after round 3), serial
    finishing became the throughput ceiling; the numpy/native stages drop
    the GIL, so two batches' finishes genuinely overlap. Output order and
    byte content are unchanged — futures are yielded strictly in batch
    order.
    """
    import os
    import threading
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor
    from queue import Queue

    timers = timers or StageTimers()
    n_fin = max(1, int(os.environ.get("DY_FINISH_WORKERS", "2")))
    q: Queue = Queue(maxsize=n_fin)
    sentinel = object()
    err: list[BaseException] = []

    def device_worker():
        # dispatch-ahead double buffering: batch i+1's uploads + compute
        # are queued on the device BEFORE batch i's results are drained,
        # so the fixed per-transfer cost rides under compute
        prev = None
        try:
            for batch in batches:
                cur = (batch, dis_map_batch_async(index, batch, opts, timers))
                if prev is not None:
                    p, prev = prev, None
                    q.put((p[0], p[1]()))
                prev = cur
        except BaseException as e:
            err.append(e)
        finally:
            if prev is not None:
                # a reader/dispatch error must not drop the completed
                # in-flight batch: drain and deliver it first
                try:
                    q.put((prev[0], prev[1]()))
                except BaseException as e:
                    if not err:
                        err.append(e)
            q.put(sentinel)

    t = threading.Thread(target=device_worker, daemon=True)
    t.start()
    first = header
    if n_fin == 1:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            batch, m = item
            yield _finish_batch(index, batch, m, opts, cmdline, timers,
                                header=first, stats=stats)
            first = False
        return
    ex = ThreadPoolExecutor(max_workers=n_fin)
    pending: deque = deque()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                break
            batch, m = item
            pending.append(ex.submit(_finish_batch, index, batch, m, opts,
                                     cmdline, timers, first, stats))
            first = False
            while len(pending) >= n_fin:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()
        if err:
            raise err[0]
    finally:
        ex.shutdown(wait=True)


def dream_map_sam(index: DreamIndex, batch: ReadBatch, opts: MapperOptions,
                  cmdline: str = "", timers: StageTimers | None = None,
                  header: bool = True, stats: dict | None = None) -> str:
    """Full DREAM pipeline for one batch -> SAM text.

    `stats` (reference appendStats [U], SURVEY.md §5.5): accumulates
    reads/mapped/unique/multi/proper-pair counts across batches.
    """
    timers = timers or StageTimers()
    m = dis_map_batch(index, batch, opts, timers)
    return _finish_batch(index, batch, m, opts, cmdline, timers, header, stats)


def _finish_batch(index: DreamIndex, batch: ReadBatch, m: Matches,
                  opts: MapperOptions, cmdline: str, timers: StageTimers,
                  header: bool, stats: dict | None) -> bytes:
    rate_ppm = rate_to_ppm(opts.error_rate)
    max_err = max(1, max_errors_for_batch(batch.max_len, opts.error_rate))

    def finish(mm: Matches) -> Ranked:
        ok = index.contigs.same_contig_span(mm.begin, mm.end)
        return rank_matches(dedup_matches(mm.take(ok)), batch.n_reads,
                            strata_count=opts.strata_count)

    with timers.stage("rank/dedup (host)"):
        ranked = finish(m)
    if batch.paired and opts.rescue:
        with timers.stage("mate rescue"):
            rescued = _rescue_global(index, batch, ranked, opts, max_err, rate_ppm)
            if len(rescued):
                ranked = finish(Matches.concat([m, rescued]))

    with timers.stage("cigar (host)"):
        rows = (ranked.matches.read_id +
                ranked.matches.strand.astype(np.int32) * batch.n_reads)
        cigars = compute_cigars(index.global_text, batch.seqs, rows,
                                batch.lengths[ranked.matches.read_id],
                                ranked.matches.begin, ranked.matches.end, max_err,
                            dists=ranked.matches.dist)

    pair_info = None
    if batch.paired:
        with timers.stage("select pairs (host)"):
            pair_info = select_pairs(ranked, batch.n_reads, index.contigs,
                                     opts.library_length,
                                     opts.library_deviation)
    with timers.stage("sam write (host)"):
        head = (("\n".join(sam_header(index.contigs, cmdline,
                                       read_group=opts.read_group or None))
                 + "\n").encode() if header else b"")
        if batch.paired:
            body = write_pe_records(batch, index.contigs, ranked, cigars,
                                    pair_info,
                                    read_group=opts.read_group or None,
                                    secondary_mode=opts.secondary_matches)
        else:
            body = write_se_records(batch, index.contigs, ranked, cigars,
                                    read_group=opts.read_group or None,
                                    secondary_mode=opts.secondary_matches)

    if stats is not None:
        with _STATS_LOCK:   # finisher-pool threads share this dict
            stats["reads"] = stats.get("reads", 0) + batch.n_reads
            mapped = int((ranked.c1 > 0).sum())
            stats["mapped"] = stats.get("mapped", 0) + mapped
            stats["unique"] = stats.get("unique", 0) + int(
                ((ranked.c1 == 1) & (ranked.c2 == 0)).sum())
            if pair_info is not None:
                stats["proper_pairs"] = stats.get("proper_pairs", 0) + int(
                    pair_info.proper.sum()) // 2
    return head + body
