"""Multi-host DREAM runtime: jax.distributed + per-host bin-shard loading +
cross-host merge (SURVEY.md §5.8; BASELINE configs 3/5).

The reference has NO distributed runtime — its multi-node story is manual
bin placement plus offline SAM merge. Here distribution is first-class:

  * one `jax.distributed` runtime; the mesh's 'bin' axis is laid out across
    processes, so each host loads ONLY its own bins' index artifacts
    (SeqStore.load_meta supplies the light global contig table to everyone);
  * the sharded classify->route->map step from parallel/dist_mapper runs
    SPMD across all hosts (same program as single-host);
  * matches, fallback results, and per-bin CIGAR strings merge across hosts
    with `process_allgather` (collectives — not filesystem merges);
    ranking/pairing/MAPQ then run replicated on the deterministic global
    match table, and process 0 emits the SAM.

Validated with the multiprocess CPU backend (2 processes x 4 virtual
devices, tools/multihost_demo.py + tests/test_multihost.py) and with one
process per GPU on a 4-GPU host (chip_smoke.py --four).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..io.readstore import ReadBatch
from ..io.seqstore import SeqStore
from ..index.fmindex import FMIndex
from ..index.ibf import InterleavedBloomFilter
from ..index.kdx import DirectKmerFilter
from ..ops.device_index import DeviceFMSet
from ..pipeline.dis_mapper import bin_file, _sub_batch
from ..pipeline.map_step import max_seed_len_static, verify_uses_kernel
from ..pipeline.matches import Matches, dedup_matches, rank_matches
from ..pipeline.seeding import max_errors_for_batch, rate_to_ppm
from ..pipeline.writer import GlobalContigs
from ..utils.options import MapperOptions
from ..utils.timer import StageTimers
from .dist_mapper import (MeshMapOut, build_mesh_dream_step,
                          decode_flat_device, decode_routing, pack_batch_blob)


def local_gpu_count() -> int:
    """GPUs this process could open, counted without initializing JAX:
    CUDA_VISIBLE_DEVICES when set, else the driver's /dev/nvidiaN nodes."""
    import glob
    import os
    import re

    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    if vis is not None:
        return len([v for v in vis.split(",") if v.strip()])
    return len([p for p in glob.glob("/dev/nvidia*")
                if re.fullmatch(r"/dev/nvidia\d+", p)])


def init_multihost(coordinator: str, num_processes: int, process_id: int):
    """Join the jax.distributed runtime with explicit coordinates.

    One process per GPU: when the process count equals the local GPU count
    (all processes on one host), each process takes only GPU `process_id`
    — otherwise every process would open every card and reserve its
    memory."""
    local_device_ids = None
    if num_processes == local_gpu_count():
        local_device_ids = [process_id]
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)


def make_multihost_mesh() -> Mesh:
    """(data, bin) mesh with the 'bin' axis laid out ACROSS processes, so a
    bin shard lives entirely on one host and that host alone needs its
    artifacts. Data axis = the local devices of each host."""
    procs = jax.process_count()
    local = jax.local_device_count()
    devs = np.empty((local, procs), dtype=object)
    by_proc: dict[int, list] = {}
    for d in jax.devices():
        by_proc.setdefault(d.process_index, []).append(d)
    for p, ds in by_proc.items():
        for i, d in enumerate(sorted(ds, key=lambda x: x.id)):
            devs[i, p] = d
    return Mesh(devs, ("data", "bin"))


def _allgather_concat(arr: np.ndarray) -> np.ndarray:
    """Concatenate per-process variable-length 1-D arrays over all hosts."""
    from jax.experimental import multihost_utils as mh

    lens = mh.process_allgather(np.array([len(arr)], dtype=np.int64))
    lens = np.asarray(lens).reshape(-1)
    m = int(lens.max()) if len(lens) else 0
    if m == 0:
        return arr[:0]
    pad = np.zeros(m, dtype=arr.dtype)
    pad[: len(arr)] = arr
    gathered = np.asarray(mh.process_allgather(pad))  # (procs, m)
    return np.concatenate([gathered[p, : lens[p]] for p in range(len(lens))])


def allgather_matches(m: Matches) -> Matches:
    return Matches(
        read_id=_allgather_concat(m.read_id),
        strand=_allgather_concat(m.strand),
        begin=_allgather_concat(m.begin),
        end=_allgather_concat(m.end),
        dist=_allgather_concat(m.dist),
    )


class MultiHostDreamMapper:
    """DREAM mapping across hosts; each host owns a contiguous bin range."""

    def __init__(self, db_dir, opts: MapperOptions, filter_type: str = "bloom",
                 r_cap: int | None = None):
        self.opts = opts
        db_dir = Path(db_dir)
        meta = json.loads((db_dir / "meta.json").read_text())
        self.n_bins = meta["n_bins"]
        self.mesh = make_multihost_mesh()
        self.bin_ax = self.mesh.shape["bin"]
        self.data_ax = self.mesh.shape["data"]
        self.pid = jax.process_index()
        self.B = ((self.n_bins + self.bin_ax - 1) // self.bin_ax) * self.bin_ax
        self.B_loc = self.B // self.bin_ax
        self.r_cap_arg = r_cap
        self.use_pallas = verify_uses_kernel()

        # light global contig table from metadata only (every host)
        names, lengths, starts, bin_starts = [], [], [], [0]
        pos = 0
        for b in range(self.n_bins):
            nm, offs, lens, tlen = SeqStore.load_meta(
                bin_file(db_dir, b, "store"))
            names.extend(nm)
            lengths.extend(np.asarray(lens).tolist())
            starts.extend((np.asarray(offs) + pos).tolist())
            pos += tlen
            bin_starts.append(pos)
        while len(bin_starts) <= self.B:
            bin_starts.append(pos)
        self.contigs = GlobalContigs(
            names=names, lengths=np.array(lengths, dtype=np.int64),
            starts=np.array(starts, dtype=np.int64),
            bin_starts=np.array(bin_starts, dtype=np.int64))

        # heavy artifacts: ONLY this host's bins
        self.my_bins = [b for b in range(self.pid * self.B_loc,
                                         min((self.pid + 1) * self.B_loc,
                                             self.n_bins))]
        self.stores = {b: SeqStore.load(bin_file(db_dir, b, "store"))
                       for b in self.my_bins}
        self.fms = {b: FMIndex.load(bin_file(db_dir, b, "fm"))
                    for b in self.my_bins}
        # bidirectional sidecars (indexer --bidir): per-bin reverse rank
        # rows for the search-scheme seed backend, same as DreamIndex.load
        self.rfused = {}
        for b in self.my_bins:
            rp = bin_file(db_dir, b, "rfm")
            if rp.exists():
                rf = np.load(rp)["rfused"]
                if rf.shape[0] == self.fms[b].bwt_blocks.shape[0] + 1:
                    self.rfused[b] = rf   # stale sidecars are ignored
        # globally consistent pad sizes + a single SA sample rate (shard
        # shapes must match across processes; DeviceFMSet.build_np derives
        # the sampled-layout sizes from max_n, so any uniform rate works)
        from jax.experimental import multihost_utils as mh
        # a host whose padded bin range is EMPTY (uneven bins-per-host,
        # n_bins % processes != 0) must not constrain the global layout:
        # it sends sentinels (-1) that the agreement below ignores
        local_max = max((fm.n for fm in self.fms.values()), default=0)
        local_q = min((fm.prefix_q for fm in self.fms.values()), default=-1)
        local_rates = {fm.sample_rate for fm in self.fms.values()}
        assert len(local_rates) <= 1, "bins must share one SA sample rate"
        maxes = np.asarray(mh.process_allgather(
            np.array([local_max, local_q,
                      local_rates.pop() if local_rates else -1],
                     dtype=np.int64)))
        max_n = int(maxes[:, 0].max())
        qs = maxes[maxes[:, 1] >= 0, 1]
        self.prefix_q = (int(qs.min()) if len(qs) and (qs > 0).all() else 0)
        rates = set(maxes[maxes[:, 2] >= 0, 2].tolist()) or {1}
        assert len(rates) == 1, \
            f"every host must load bins of ONE sample rate, got {rates}"
        self.sample_rate = int(rates.pop())

        fms_l = [self.fms[b] for b in self.my_bins]
        texts_l = [self.stores[b].text for b in self.my_bins]
        if self.prefix_q:
            for fm, t in zip(fms_l, texts_l):
                if fm.prefix_q != self.prefix_q:
                    fm.build_prefix_table(t, self.prefix_q)
        arrs = DeviceFMSet.build_np(fms_l, texts_l, pad_bins_to=self.B_loc,
                                    max_n=max_n, prefix_q=self.prefix_q,
                                    sample_rate=self.sample_rate)
        if not self.prefix_q:
            arrs["pfx_lo"] = arrs["pfx_hi"] = None

        def put_bin_sharded(x):
            if x is None:
                return None
            sh = NamedSharding(self.mesh, P("bin"))
            return jax.make_array_from_process_local_data(
                sh, x, (self.B,) + x.shape[1:])
        self.fmset = DeviceFMSet(**{k: put_bin_sharded(v)
                                    for k, v in arrs.items()})

        # prefilter: replicated (every host loads the same file)
        self.filter = None
        self.filter_type = "none"
        if filter_type == "bloom" and (db_dir / "db.filter.npz").exists():
            self.filter = InterleavedBloomFilter.load(db_dir / "db.filter")
            self.filter_type = "bloom"
        elif filter_type == "kmer_direct" and (db_dir / "db.kdx.npz").exists():
            self.filter = DirectKmerFilter.load(db_dir / "db.kdx")
            self.filter_type = "kmer_direct"
        if self.filter is not None:
            sh = NamedSharding(self.mesh, P())
            # drop all-padding words (see dream_mesh: gathers pay per
            # word); blocked filters keep their full width
            self.blocked = bool(getattr(self.filter, "blocked", 0))
            wd_need = (self.filter.words.shape[1] if self.blocked
                       else max(1, (self.B + 31) // 32))
            w = np.asarray(self.filter.words)[:, :wd_need]
            self.filter_words = jax.make_array_from_process_local_data(
                sh, w, w.shape)
            self.k, self.n_hashes = self.filter.k, self.filter.n_hashes
            self.window = getattr(self.filter, "window", 0)
            self.canonical = bool(getattr(self.filter, "canonical", 0))
            self.direct = bool(getattr(self.filter, "direct", 0))
            self.slack_table = getattr(self.filter, "slack_table", None)
        else:
            sh = NamedSharding(self.mesh, P())
            self.filter_words = jax.make_array_from_process_local_data(
                sh, np.zeros((1, 2), np.uint32), (1, 2))
            self.k = self.n_hashes = self.window = 0
            self.canonical = self.blocked = self.direct = False
            self.slack_table = None
        self._steps: dict = {}
        self._bin_mappers: dict = {}

    # --- step construction -------------------------------------------------

    POOL_MAX = 1 << 19   # meta row field bound (dist_mapper.META_ROW_BITS)

    def _r_cap(self, half_loc: int) -> int:
        """Per-device shared slot-pool capacity (see dream_mesh._r_cap)."""
        if self.r_cap_arg is not None:
            return min(self.r_cap_arg, self.POOL_MAX)
        if self.filter is None:
            return min(half_loc * self.B_loc, self.POOL_MAX)
        return min(self.POOL_MAX,
                   max(256, min(2 * half_loc,
                                (2 * half_loc + self.bin_ax - 1)
                                // self.bin_ax)))

    def _step(self, half_loc, L, r_cap, rate_ppm, max_err, max_slen):
        key = (half_loc, L, r_cap, rate_ppm, max_err)
        if key not in self._steps:
            self._steps[key] = build_mesh_dream_step(
                self.mesh, half_loc=half_loc, L=L, B=self.B, r_cap=r_cap,
                rate_ppm=rate_ppm, max_errors=max_err, capacity=8,
                max_slen=max_slen, prefix_q=self.prefix_q,
                sample_rate=self.sample_rate,
                use_pallas=self.use_pallas, k=self.k,
                n_hashes=self.n_hashes, window=self.window,
                use_filter=self.filter is not None,
                canonical=self.canonical, blocked=self.blocked,
                direct=self.direct, slack_table=self.slack_table)
        return self._steps[key]

    def _bin_mapper(self, b: int):
        if b not in self._bin_mappers:
            from ..pipeline.mapper import BinMapper
            self._bin_mappers[b] = BinMapper(self.stores[b], self.fms[b],
                                             self.opts,
                                             rfused=self.rfused.get(b))
        return self._bin_mappers[b]

    # --- mapping -----------------------------------------------------------

    def map_batch(self, batch: ReadBatch,
                  timers: StageTimers | None = None) -> Matches:
        """Global int64-coordinate matches, identical on every host."""
        timers = timers or StageTimers()
        opts = self.opts
        n = batch.n_reads
        L = batch.max_len
        rate_ppm = rate_to_ppm(opts.error_rate)
        max_err = max(1, max_errors_for_batch(L, opts.error_rate))
        max_slen = max_seed_len_static(L, rate_ppm)

        blob, half_loc = pack_batch_blob(batch.seqs[:n], batch.lengths,
                                         self.data_ax, L)
        r_cap = self._r_cap(half_loc)
        step = self._step(half_loc, L, r_cap, rate_ppm, max_err, max_slen)

        sh = NamedSharding(self.mesh, P("data"))
        blob_g = jax.make_array_from_process_local_data(sh, blob, blob.shape)
        with timers.stage("mesh map (device)"):
            out = step(self.fmset, self.filter_words, blob_g)
            # each host needs only ITS bins' output shards (bin axis is
            # laid out across processes) + the replicated routing bits —
            # no cross-host transfer of raw match buffers
            from jax.experimental import multihost_utils as mh
            specs = MeshMapOut(
                begin=P("bin", "data"), end=P("bin", "data"),
                meta=P("bin", "data"), overflow_total=P("bin", "data"),
                n_spilled=P("bin", "data"), route_overflow=P("bin", "data"),
                route_words=P("data"), ovf_rows=P("bin", "data"),
                v_need=P("bin", "data"), loc_need=P("bin", "data"))
            out = MeshMapOut(*(np.asarray(
                mh.global_array_to_host_local_array(x, self.mesh, sp))
                for x, sp in zip(out, specs)))

        routing = decode_routing(out.route_words, n, self.B)
        local_parts: list[Matches] = []
        sens = opts.sensitivity
        bin_starts = self.contigs.bin_starts
        # this process holds exactly ONE bin-shard row of the flat-pool
        # output (bin axis spans processes); decode each data shard and
        # re-map spill / seed-overflow / pool-overflow pairs on ITS bins'
        # single-chip path (other hosts contribute nothing for them)
        fb_by_bin: dict[int, list] = {}
        for d in range(self.data_ax):
            with timers.stage("mesh collect (host)"):
                m, fb, lo_pairs, spilled = decode_flat_device(
                    out, 0, d, routing, half_loc, self.B_loc, r_cap, sens,
                    bin_col0=self.pid * self.B_loc)
            if spilled:
                with timers.stage("mesh spill fallback (host)"):
                    for b in self.my_bins:
                        sub = routing[d * half_loc :
                                      min((d + 1) * half_loc, n), b]
                        ids = np.flatnonzero(sub) + d * half_loc
                        if len(ids):
                            self._host_fallback(batch, b, ids,
                                                int(bin_starts[b]),
                                                local_parts)
                continue
            for reads_p, bins_p in (fb, lo_pairs):
                for b_loc in np.unique(bins_p):
                    b = self.pid * self.B_loc + int(b_loc)
                    fb_by_bin.setdefault(b, []).append(
                        reads_p[bins_p == b_loc])
            if m is not None:
                bin_g = self.pid * self.B_loc + m["bin_local"]
                off = bin_starts[np.minimum(bin_g, len(bin_starts) - 1)]
                local_parts.append(Matches(
                    read_id=m["read_id"].astype(np.int32),
                    strand=m["strand"],
                    begin=m["begin"] + off,
                    end=m["end"] + off,
                    dist=m["dist"]))
        for b, idss in sorted(fb_by_bin.items()):
            if b >= self.n_bins:
                continue
            ids = np.unique(np.concatenate(idss))
            with timers.stage("mesh overflow fallback (host)"):
                self._host_fallback(batch, b, ids, int(bin_starts[b]),
                                    local_parts)
        with timers.stage("cross-host merge"):
            return allgather_matches(Matches.concat(local_parts))

    def _host_fallback(self, batch: ReadBatch, b: int, ids: np.ndarray,
                       off: int, parts: list[Matches]) -> None:
        """Re-map a read subset of bin b through the exact single-chip path."""
        bm = self._bin_mapper(b)
        m = bm.map_batch(_sub_batch(batch, ids))
        m.begin += off
        m.end += off
        m.read_id = ids[m.read_id].astype(np.int32)
        parts.append(m)

    # --- finishing (replicated ranking, owner-computed CIGARs) -------------

    def map_sam(self, batch: ReadBatch, cmdline: str = "",
                timers: StageTimers | None = None, header: bool = True,
                stats: dict | None = None) -> bytes | None:
        """Full pipeline; returns SAM bytes on process 0, None elsewhere."""
        from ..pipeline.cigar import compute_cigars
        from ..pipeline.pairs import select_pairs
        from ..pipeline.writer import (sam_header, write_pe_records,
                                       write_se_records)

        timers = timers or StageTimers()
        opts = self.opts
        m = self.map_batch(batch, timers)
        rate_ppm = rate_to_ppm(opts.error_rate)
        max_err = max(1, max_errors_for_batch(batch.max_len, opts.error_rate))

        def finish(mm: Matches):
            ok = self.contigs.same_contig_span(mm.begin, mm.end)
            return rank_matches(dedup_matches(mm.take(ok)), batch.n_reads,
                                strata_count=opts.strata_count)

        with timers.stage("rank/dedup (host)"):
            ranked = finish(m)
        if batch.paired and opts.rescue:
            with timers.stage("mate rescue (multi-host)"):
                rescued = self._rescue_multihost(batch, ranked, max_err,
                                                 rate_ppm)
                if len(rescued):
                    ranked = finish(Matches.concat([m, rescued]))

        with timers.stage("cigar (owner hosts)"):
            cigars = self._cigars_multihost(batch, ranked, max_err)

        pair_info = None
        with timers.stage("sam write (host 0)"):
            if batch.paired:
                pair_info = select_pairs(ranked, batch.n_reads, self.contigs,
                                         opts.library_length,
                                         opts.library_deviation)
            if jax.process_index() != 0:
                return None
            head = (("\n".join(sam_header(self.contigs, cmdline,
                                           read_group=(self.opts.read_group
                                                       or None))) + "\n"
                     ).encode() if header else b"")
            if batch.paired:
                body = write_pe_records(batch, self.contigs, ranked,
                                        cigars, pair_info,
                                        read_group=(self.opts.read_group
                                                    or None),
                                        secondary_mode=opts.secondary_matches)
            else:
                body = write_se_records(batch, self.contigs, ranked,
                                        cigars,
                                        read_group=(self.opts.read_group
                                                    or None),
                                        secondary_mode=opts.secondary_matches)
        if stats is not None:
            stats["reads"] = stats.get("reads", 0) + batch.n_reads
            stats["mapped"] = stats.get("mapped", 0) + int((ranked.c1 > 0).sum())
        return head + body

    def _bin_of(self, gpos: np.ndarray) -> np.ndarray:
        b = np.searchsorted(self.contigs.bin_starts, gpos, side="right") - 1
        return np.clip(b, 0, self.B - 1)

    def _rescue_multihost(self, batch, ranked, max_err, rate_ppm) -> Matches:
        """Each host verifies the rescue anchors that land in ITS bins;
        results merge with an allgather (same candidate set everywhere, so
        the merged result is deterministic)."""
        from ..pipeline.map_step import verify_positions
        from ..pipeline.mapper import FALLBACK_PAD
        from ..pipeline.matches import build_matches
        from ..pipeline.pairs import rescue_candidates

        opts = self.opts
        cands = rescue_candidates(ranked, batch.n_reads, batch.lengths,
                                  opts.library_length, opts.library_deviation,
                                  band=max_err)
        parts: list[Matches] = []
        if len(cands.rows):
            bin_of = self._bin_of(cands.anchors)
            n = batch.n_reads
            reads_j = jnp.asarray(batch.seqs)
            lens_j = jnp.asarray(batch.lengths)
            for b in np.unique(bin_of):
                if int(b) not in self.stores:
                    continue
                sel = bin_of == b
                rows = cands.rows[sel]
                anchors = (cands.anchors[sel]
                           - int(self.contigs.bin_starts[b])).astype(np.int32)
                bm = self._bin_mapper(int(b))
                off = int(self.contigs.bin_starts[b])
                for b0 in range(0, len(rows), FALLBACK_PAD):
                    rb = rows[b0 : b0 + FALLBACK_PAD]
                    ab = anchors[b0 : b0 + FALLBACK_PAD]
                    padn = FALLBACK_PAD - len(rb)
                    mask = np.concatenate([np.ones(len(rb), bool),
                                           np.zeros(padn, bool)])
                    rb = np.concatenate([rb, np.zeros(padn, np.int32)])
                    ab = np.concatenate([ab, np.zeros(padn, np.int32)])
                    dist, beg, end = verify_positions(
                        bm.dev, reads_j, lens_j, jnp.asarray(rb),
                        jnp.asarray(ab), jnp.asarray(mask), max_errors=max_err)
                    dist = np.asarray(dist)
                    beg, end = np.asarray(beg), np.asarray(end)
                    budget = (batch.lengths[rb % n] * rate_ppm) // 10_000
                    okm = mask & (dist <= budget) & (beg >= 0) & (end <= bm.fm.n)
                    mm = build_matches(rb, beg, end, dist, okm, n_reads=n)
                    mm.begin += off
                    mm.end += off
                    parts.append(mm)
        return allgather_matches(Matches.concat(parts))

    def _cigars_multihost(self, batch, ranked, max_err) -> list[str]:
        """CIGARs need the bin text: computed by each bin's owner, merged by
        (match-row-index, packed string) allgather."""
        from ..pipeline.cigar import compute_cigars

        mm = ranked.matches
        bin_of = self._bin_of(mm.begin)
        idx_l, cig_l = [], []
        for b in self.my_bins:
            sel = np.flatnonzero(bin_of == b)
            if len(sel) == 0:
                continue
            st = self.stores[b]
            off = int(self.contigs.bin_starts[b])
            rows = (mm.read_id[sel]
                    + mm.strand[sel].astype(np.int32) * batch.n_reads)
            cigs = compute_cigars(st.text, batch.seqs, rows,
                                  batch.lengths[mm.read_id[sel]],
                                  mm.begin[sel] - off, mm.end[sel] - off,
                                  max_err, dists=mm.dist[sel])
            idx_l.append(sel.astype(np.int64))
            cig_l.extend(cigs)
        idx = (np.concatenate(idx_l) if idx_l
               else np.zeros(0, dtype=np.int64))
        # pack strings: lengths + byte stream, both allgathered
        lens = np.array([len(c) for c in cig_l], dtype=np.int64)
        blob = np.frombuffer("".join(cig_l).encode(), dtype=np.uint8)
        g_idx = _allgather_concat(idx)
        g_lens = _allgather_concat(lens)
        g_blob = _allgather_concat(blob)
        cigars = [""] * len(mm)
        pos = 0
        for i, l in zip(g_idx, g_lens):
            cigars[int(i)] = g_blob[pos : pos + int(l)].tobytes().decode()
            pos += int(l)
        return cigars
