"""Mesh DREAM driver: the multi-device edition of pipeline/dis_mapper.py.

Host orchestration around parallel/dist_mapper.build_mesh_dream_step:
upload packed read shards, run classify->route->map on the (data, bin) mesh,
decode the fixed-shape match buffers, and re-map any (bin, reads) subset
whose fixed capacities overflowed through the exact single-chip BinMapper —
so the merged match set (and therefore the SAM bytes, after the canonical
rank/dedup) is identical to the single-device DREAM pipeline for any mesh
shape (SURVEY.md §4.4 determinism requirement; reference d_mapper.h merges
per-bin matches into one store the same way [U]).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..io.readstore import ReadBatch
from ..ops.device_index import DeviceFMSet
from ..pipeline.dis_mapper import DreamIndex, _finish_batch, _sub_batch
from ..pipeline.map_step import max_seed_len_static, verify_uses_kernel
from ..pipeline.matches import Matches
from ..pipeline.seeding import max_errors_for_batch, rate_to_ppm
from ..utils.options import MapperOptions
from ..utils.timer import StageTimers
from .dist_mapper import (META_ROW_MASK, MeshMapOut, build_mesh_dream_step,
                          decode_flat_device, decode_routing, pack_batch_blob,
                          pack_route_words, shard_db)
from .mesh import make_mesh


class MeshDreamMapper:
    """Maps batches against all bins on a (data, bin) device mesh."""

    def __init__(self, index: DreamIndex, opts: MapperOptions,
                 mesh=None, n_devices: int | None = None,
                 r_cap: int | None = None, use_pallas: bool | None = None,
                 lean: bool = False):
        self.index = index
        self.opts = opts
        self.mesh = mesh or make_mesh(n_devices, n_bins=index.n_bins)
        self.bin_ax = self.mesh.shape["bin"]
        self.data_ax = self.mesh.shape["data"]
        self.B = ((index.n_bins + self.bin_ax - 1) // self.bin_ax) * self.bin_ax
        self.r_cap_arg = r_cap
        self.use_pallas = (verify_uses_kernel() if use_pallas is None
                           else use_pallas)

        fms = list(index.fms)
        texts = [st.text for st in index.stores]
        # pad to the bin axis with empty bins (n=0: searches return empty)
        # lean=True drops bwt/occ from the device set (the flat step never
        # reads them) — ~1.2 bytes/char of HBM back on Gbp-scale databases
        host_set = DeviceFMSet.from_host(fms, texts, pad_bins_to=self.B,
                                         lean=lean)
        self.fmset = shard_db(self.mesh, host_set)
        self.prefix_q = host_set.prefix_q
        self.sample_rate = fms[0].sample_rate if fms else 1

        self.use_filter = (index.filter_type != "none"
                           and index.filter is not None)
        if self.use_filter:
            # drop all-padding words: every hash-row gather pays per word,
            # and a B<=32-bin database only ever consults word 0. Blocked
            # filters keep their full width (block geometry is built-in).
            self.blocked = bool(getattr(index.filter, "blocked", 0))
            if self.blocked:
                # block-row layout (n_blocks, S*wdc), reshaped on HOST: a
                # device-side reshape of an (n_rows, 2) filter relayouts
                # through a 64x-padded tiled copy (config-3 compile OOM)
                from ..ops.ibf_query import host_block_rows

                words, self.block_s = host_block_rows(
                    index.filter.words, self.B)
            else:
                self.block_s = 0
                wd_need = max(1, (self.B + 31) // 32)
                words = np.asarray(index.filter.words)[:, :wd_need]
            self.filter_words = jax.device_put(
                jnp.asarray(words),
                jax.sharding.NamedSharding(self.mesh,
                                           jax.sharding.PartitionSpec()))
            self.k = index.filter.k
            self.n_hashes = index.filter.n_hashes
            self.window = getattr(index.filter, "window", 0)
            self.canonical = bool(getattr(index.filter, "canonical", 0))
            self.direct = bool(getattr(index.filter, "direct", 0))
            self.slack_table = getattr(index.filter, "slack_table", None)
        else:
            self.filter_words = jnp.zeros((1, 2), dtype=jnp.uint32)
            self.block_s = 0
            self.k = self.n_hashes = self.window = 0
            self.canonical = self.blocked = self.direct = False
            self.slack_table = None
        self._steps: dict = {}

    POOL_MAX = 1 << 19   # meta row field bound (dist_mapper.META_ROW_BITS)

    def _r_cap(self, half_loc: int) -> int:
        """Per-device SHARED slot-pool capacity (see flat_step.slot_pool):
        expected routed pairs ~ half_loc * (1 + IBF FP) / bin_ax, so 2x the
        read shard (split over the bin axis) absorbs any routing skew —
        unlike the old per-bin capacity, a hot bin just uses more of the
        pool. Overflow drains through extra mesh passes (never dropped);
        >= 2 drains in a batch auto-grows the pool for later batches."""
        if self.r_cap_arg is not None:
            return min(self.r_cap_arg, self.POOL_MAX)
        # ~1 route/read + IBF FPs in practice; 1.25x headroom — a tighter
        # pool shrinks every downstream buffer (verify lanes, d2h fetch),
        # and a genuinely multi-routed workload drains + auto-grows
        base = max(256, min(2 * half_loc,
                            (5 * half_loc // 4 + self.bin_ax - 1)
                            // self.bin_ax))
        if not self.use_filter:
            # no prefilter: every read maps against every local bin
            base = min(half_loc * ((self.B + self.bin_ax - 1) // self.bin_ax),
                       self.POOL_MAX)
        return min(self.POOL_MAX,
                   max(base, getattr(self, "_tuned_r_cap", 0)))

    def _step(self, half_loc: int, L: int, r_cap: int, rate_ppm: int,
              max_err: int, max_slen: int, uniform_len: bool = False,
              cap2l: float | None = None, cap2v_f: float | None = None,
              route_override: bool = False):
        key = (half_loc, L, r_cap, rate_ppm, max_err, uniform_len,
               cap2l, cap2v_f, route_override)
        if key not in self._steps:
            self._steps[key] = build_mesh_dream_step(
                self.mesh, half_loc=half_loc, L=L, B=self.B, r_cap=r_cap,
                rate_ppm=rate_ppm, max_errors=max_err, capacity=8,
                max_slen=max_slen, prefix_q=self.prefix_q,
                sample_rate=self.sample_rate, use_pallas=self.use_pallas,
                k=self.k, n_hashes=self.n_hashes, window=self.window,
                use_filter=self.use_filter, uniform_len=uniform_len,
                route_override=route_override, canonical=self.canonical,
                blocked=self.blocked, direct=self.direct,
                block_s=self.block_s, slack_table=self.slack_table,
                cap2l=cap2l, cap2v_f=cap2v_f)
        return self._steps[key]

    # --- locate/verify lane-cap auto-tuning --------------------------------
    #
    # The sampled-SA LF walk costs sample_rate-1 row-gather iterations PER
    # STATIC LANE (loc_cap = cap2l * t_cap lanes walked whether valid or
    # not), and the verify budget (cap2v = cap2v_f * t_cap) sizes both the
    # DP lanes and the begin/end/meta d2h fetch. The conservative defaults
    # (DY_CAP2L=4.0, DY_CAP2V=1.25) pay for worst-case demand every batch;
    # the true demands come back with every mesh pass (MeshMapOut
    # v_need/loc_need), so after the first batch the caps shrink to
    # margin * observed-max (quantized to limit recompiles; monotone grow
    # if a later batch demands more — an undersized batch still completes
    # through the overflow/spill fallbacks, it just costs time). Explicit
    # DY_CAP2L / DY_CAP2V env pins a knob; DY_TUNE_CAPS=0 disables tuning.
    _Q = 0.25                   # cap quantum (recompile-churn limiter)
    _MARGIN_L = 1.3             # loc overspill -> per-pair host fallback
    _MARGIN_V = 1.5             # verify spill -> whole-device re-map (dear)

    def _caps(self) -> tuple[float, float]:
        import os

        def _default(env, dflt):
            v = os.environ.get(env)
            return (float(v) if v is not None else dflt), v is not None

        cap2l, l_fixed = _default("DY_CAP2L", 4.0)
        cap2v, v_fixed = _default("DY_CAP2V", 1.25)
        if os.environ.get("DY_TUNE_CAPS", "1") == "0":
            return cap2l, cap2v

        def _quant(x, lo, hi):
            q = -(-x // self._Q) * self._Q          # round UP to quantum
            return float(min(hi, max(lo, q)))

        if not l_fixed and getattr(self, "_seen_loc_f", None) is not None:
            cap2l = _quant(self._MARGIN_L * self._seen_loc_f, self._Q, cap2l)
        if not v_fixed and getattr(self, "_seen_v_f", None) is not None:
            cap2v = _quant(self._MARGIN_V * self._seen_v_f, self._Q, cap2v)
        return cap2l, cap2v

    def _observe_demand(self, out, r_cap: int):
        t = float(max(r_cap, 1))
        lf = float(np.max(out.loc_need)) / t
        vf = float(np.max(out.v_need)) / t
        self._seen_loc_f = max(getattr(self, "_seen_loc_f", 0.0) or 0.0, lf)
        self._seen_v_f = max(getattr(self, "_seen_v_f", 0.0) or 0.0, vf)
        d = getattr(self, "fallback_diag", None)
        if d is not None:      # bench visibility: observed demand ratios
            d["loc_f"] = round(self._seen_loc_f, 3)
            d["v_f"] = round(self._seen_v_f, 3)

    def map_batch(self, batch: ReadBatch,
                  timers: StageTimers | None = None) -> Matches:
        """All matches in GLOBAL int64 coordinates (like dis_map_batch)."""
        return self.map_batch_async(batch, timers)()

    def map_batch_async(self, batch: ReadBatch,
                        timers: StageTimers | None = None):
        """Dispatch the mesh step NOW (async), return a drain() closure that
        fetches + collects. Dispatch-ahead callers hide batch i+1's shard
        uploads under batch i's mesh compute (see dis_map_batch_async)."""
        timers = timers or StageTimers()
        n = batch.n_reads
        L = batch.max_len
        rate_ppm = rate_to_ppm(self.opts.error_rate)
        max_err = max(1, max_errors_for_batch(L, self.opts.error_rate))
        max_slen = max_seed_len_static(L, rate_ppm)

        blob, half_loc = pack_batch_blob(batch.seqs[:n], batch.lengths,
                                         self.data_ax, L)
        r_cap = self._r_cap(half_loc)
        from ..pipeline.map_step import uniform_len_ok
        uniform_len = uniform_len_ok(batch.lengths, L, rate_ppm, max_err)
        cap2l, cap2v_f = self._caps()
        step_key = (half_loc, L, r_cap, rate_ppm, max_err, max_slen,
                    uniform_len, cap2l, cap2v_f)
        step = self._step(*step_key)
        with timers.stage("mesh map (device)"):
            out_dev: MeshMapOut = step(self.fmset, self.filter_words,
                                       jnp.asarray(blob))
        return lambda: self._collect(batch, out_dev, n, half_loc, r_cap,
                                     timers, blob=blob, step_key=step_key)

    MAX_DRAIN = 6  # extra mesh passes for route-capacity overflow before
                   # falling back to the single-chip path (config-5 skew)

    def _collect(self, batch: ReadBatch, out_dev: MeshMapOut, n: int,
                 half_loc: int, r_cap: int, timers: StageTimers,
                 blob: np.ndarray | None = None,
                 step_key: tuple | None = None) -> Matches:
        index = self.index
        parts: list[Matches] = []
        # diagnostics: why reads fell back (route-cap vs seed-capacity vs
        # verify-lane spill), accumulated across batches for the bench report
        diag = self.fallback_diag = getattr(
            self, "fallback_diag",
            {"spill_bins": 0, "route_ovf": 0, "seed_ovf": 0, "routed": 0,
             "drain_passes": 0})
        diag.setdefault("drain_passes", 0)

        n_pad = self.data_ax * half_loc
        drains = 0
        while True:
            with timers.stage("mesh fetch (device wait)"):
                out = MeshMapOut(*(np.asarray(x) for x in out_dev))
            routing = decode_routing(out.route_words, n, self.B)
            if drains == 0:          # drain passes re-route the SAME pairs:
                diag["routed"] += int(routing.sum())   # count each pair once
            # cap auto-tuner input: observe EVERY pass (drain passes too —
            # a drain whose demand chronically exceeded a tuned cap would
            # otherwise spill forever without the monotone growth)
            self._observe_demand(out, r_cap)
            leftover = self._process_out(batch, out, routing, n, half_loc,
                                         r_cap, n_pad, parts, timers, diag,
                                         count_ovf=(drains == 0))
            if not leftover.any():
                break
            if blob is None or step_key is None or drains >= self.MAX_DRAIN:
                # exhausted drain budget: exact single-chip re-map of the rest
                for b in np.flatnonzero(leftover[:n].any(axis=0)):
                    if b >= index.n_bins:      # padding bins: no reads/index
                        continue
                    ids = np.flatnonzero(leftover[:n, b])
                    with timers.stage("mesh overflow fallback (host)"):
                        self._fallback(batch, b, ids,
                                       int(index.contigs.bin_starts[b]),
                                       parts, timers)
                break
            # capacity drain: re-submit ONLY the leftover (read, bin) pairs
            # through the same compiled mesh step with a routing override —
            # hot-bin overflow costs extra device passes, not host re-maps
            drains += 1
            diag["drain_passes"] += 1
            words = pack_route_words(leftover, self.B)
            step_ov = self._step(*step_key, route_override=True)
            with timers.stage("mesh map (device)"):
                out_dev = step_ov(self.fmset, self.filter_words,
                                  jnp.asarray(blob), jnp.asarray(words))
        if drains >= 2 and self.r_cap_arg is None:
            # persistent overflow: grow the default pool for later batches
            # (one recompile; growth is monotone, capped by the meta field)
            self._tuned_r_cap = min(self.POOL_MAX,
                                    max(getattr(self, "_tuned_r_cap", 0),
                                        2 * r_cap))
        return Matches.concat(parts)

    def _process_out(self, batch, out: MeshMapOut, routing, n, half_loc,
                     r_cap, n_pad, parts, timers, diag, count_ovf=True):
        """Decode one mesh pass (flat slot-pool layout, decode_flat_device);
        returns the (n_pad, B) leftover routing of pairs beyond each
        device's pool (drained through an override pass)."""
        index = self.index
        B_loc = self.B // self.bin_ax
        sens = self.opts.sensitivity
        bin_starts = index.contigs.bin_starts
        leftover = np.zeros((n_pad, self.B), dtype=bool)
        fb_by_bin: dict[int, list] = {}
        for j in range(self.bin_ax):
            for d in range(self.data_ax):
                with timers.stage("mesh collect (host)"):
                    m, fb, lo_pairs, spilled = decode_flat_device(
                        out, j, d, routing, half_loc, B_loc, r_cap, sens)
                if spilled:
                    diag["spill_bins"] += 1
                    # verify-lane compaction spilled (rare at ~2 lanes per
                    # slot row): re-map this device's routed pairs through
                    # the exact single-chip path (never silent drops)
                    with timers.stage("mesh spill fallback (host)"):
                        for lb in range(B_loc):
                            b = j * B_loc + lb
                            if b >= index.n_bins:
                                continue
                            sub = routing[d * half_loc :
                                          min((d + 1) * half_loc, n), b]
                            ids = np.flatnonzero(sub) + d * half_loc
                            if len(ids):
                                self._fallback(batch, b, ids,
                                               int(bin_starts[b]), parts,
                                               timers)
                    continue
                lr, lb_ = lo_pairs
                if len(lr):
                    leftover[lr, j * B_loc + lb_] = True
                    if count_ovf:    # unique pairs: first pass only
                        diag["route_ovf"] += len(lr)
                # surgical per-(read, bin) fallback for seed-hit overflow:
                # the exhaustive single-chip re-map replaces the pair's pool
                # matches (already dropped by the decoder), preserving
                # byte-equality with the single-device DREAM pipeline
                fr, fbin = fb
                for b_loc in np.unique(fbin):
                    b = j * B_loc + int(b_loc)
                    ids = fr[fbin == b_loc]
                    diag["seed_ovf"] += len(ids)
                    fb_by_bin.setdefault(b, []).append(ids)
                if m is not None:
                    bin_g = j * B_loc + m["bin_local"]
                    off = bin_starts[np.minimum(bin_g,
                                                len(bin_starts) - 1)]
                    parts.append(Matches(
                        read_id=m["read_id"].astype(np.int32),
                        strand=m["strand"],
                        begin=m["begin"] + off,
                        end=m["end"] + off,
                        dist=m["dist"]))
        for b, idss in sorted(fb_by_bin.items()):
            ids = np.unique(np.concatenate(idss))
            with timers.stage("mesh overflow fallback (host)"):
                self._fallback(batch, b, ids, int(bin_starts[b]), parts,
                               timers)
        return leftover

    def _fallback(self, batch: ReadBatch, b: int, ids: np.ndarray, off: int,
                  parts: list[Matches], timers: StageTimers) -> None:
        """Re-map a read subset of bin b through the exact single-chip path.

        The BinMapper reuses this mapper's resident DeviceFMSet (an on-device
        slice, moved to device 0 once per bin device-to-device) instead of
        re-uploading the bin index from the host; since every view
        shares the set's padded shape, ONE XLA compile serves all bins."""
        dev_view = lambda: jax.tree.map(
            lambda x: jax.device_put(x, jax.devices()[0]), self.fmset.bin(b))
        bm = self.index.bin_mapper(b, self.opts, timers, dev_factory=dev_view,
                                   prefix_q=self.prefix_q,
                                   sample_rate=self.sample_rate)
        m = bm.map_batch(_sub_batch(batch, ids))
        m.begin += off
        m.end += off
        m.read_id = ids[m.read_id].astype(np.int32)
        parts.append(m)


def mesh_dream_sam(mapper: MeshDreamMapper, batch: ReadBatch,
                   cmdline: str = "", timers: StageTimers | None = None,
                   header: bool = True, stats: dict | None = None) -> bytes:
    """Full mesh DREAM pipeline -> SAM bytes (same finishing stages as the
    single-device dream_map_sam: rank/dedup, PE rescue, CIGAR, writer)."""
    timers = timers or StageTimers()
    m = mapper.map_batch(batch, timers)
    return _finish_batch(mapper.index, batch, m, mapper.opts, cmdline, timers,
                         header, stats)


def mesh_dream_stream(mapper: MeshDreamMapper, batches,
                      cmdline: str = "", timers: StageTimers | None = None,
                      stats: dict | None = None):
    """Yield SAM text per batch, overlapping the mesh device step of batch
    i+1 with host finishing (rank/dedup, rescue, CIGAR, SAM) of batch i —
    the mesh edition of pipeline/dis_mapper.dream_map_stream (SURVEY.md
    §2.10 pipeline-parallelism row). A worker thread drives uploads +
    mesh dispatch + collect; the main thread consumes finished match sets.
    Queue(maxsize=1) bounds device-side lookahead to one in-flight batch."""
    import threading
    from queue import Queue

    timers = timers or StageTimers()
    q: Queue = Queue(maxsize=1)
    sentinel = object()
    err: list[BaseException] = []

    def device_worker():
        # dispatch-ahead: queue batch i+1's uploads + mesh compute before
        # draining batch i (see dis_mapper.dream_map_stream)
        prev = None
        try:
            for batch in batches:
                cur = (batch, mapper.map_batch_async(batch, timers))
                if prev is not None:
                    p, prev = prev, None
                    q.put((p[0], p[1]()))
                prev = cur
        except BaseException as e:
            err.append(e)
        finally:
            if prev is not None:
                try:
                    q.put((prev[0], prev[1]()))
                except BaseException as e:
                    if not err:
                        err.append(e)
            q.put(sentinel)

    t = threading.Thread(target=device_worker, daemon=True)
    t.start()
    first = True
    while True:
        item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        batch, m = item
        yield _finish_batch(mapper.index, batch, m, mapper.opts, cmdline,
                            timers, header=first, stats=stats)
        first = False
