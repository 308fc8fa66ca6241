"""Mesh-sharded DREAM mapping step: classify -> route -> map, one XLA program.

Device-native replacement for the reference's process-level distribution
(SURVEY.md §2.10, §5.8: the reference farms bins out at the file level and
merges SAM offline; here the bin axis is a first-class mesh axis). Device
(i, j) of the (data, bin) mesh holds read-shard i and bin-shard j:

  1. classify: the replicated IBF is queried for shard i's reads (identical
     bit-for-bit to the single-chip classifier, ops/ibf_query.py); the
     (reads, bins) candidate mask is computed once per data shard.
  2. route: ALL of the device's routed (read, bin) pairs compact into ONE
     shared t_cap-slot pool (cumsum + scatter, no sort; bin-major order) —
     MoE-style capacity routing over a SHARED pool, so slot work scales
     with total routed pairs, independent of per-bin skew (config 5).
     Pairs beyond the pool are counted (route_overflow) and drained through
     an extra mesh pass with an explicit routing override.
  3. map: the pool maps in ONE fused program over the flattened multi-bin
     index space (pipeline/flat_step.py) with full single-chip parity
     (fused rank rows, q-mer prefix table, sampled SA via fused-row LF
     walks, global verify-lane compaction) — no per-bin lax.scan, so the
     pass stays dense at any bin count.

Every fixed-capacity truncation is COUNTED and surfaced (route_overflow,
seed overflow_total, verify n_spilled); the host driver drains pool
overflow through override passes and re-maps seed-overflow/spill pairs
through the exact single-chip BinMapper, so the merged match set is
byte-identical to the single-device DREAM pipeline for any mesh shape —
fixed capacities never silently drop matches (docs/OUTPUT_CONTRACT.md).

Outputs stay BIN-LOCAL int32 coordinates; the host applies the int64 global
bin offset (databases can exceed 2^31 bp in aggregate).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.device_index import DeviceFM, DeviceFMSet
from ..ops.ibf_query import classify_thresholds, ibf_bin_counts
from ..ops.readpack import pack_blob_with_lengths, unpack_blob, unpack_reads


class MeshMapOut(NamedTuple):
    """Per-DEVICE flat-pool outputs; leading axis is the bin-SHARD axis.

    Each (bin-shard j, data-shard d) device compacts its routed (read, bin)
    pairs into one shared t_cap-slot pool (pipeline/flat_step.slot_pool) and
    maps them in ONE fused program; slot order is deterministic (bin-major
    cumsum), so the host reconstructs slot -> (read, bin) from the routing
    bits alone (decode_flat_device)."""

    begin: jnp.ndarray        # (bin_ax, D*cap2v) int32 BIN-LOCAL begin
    end: jnp.ndarray          # (bin_ax, D*cap2v) int32 BIN-LOCAL end
    meta: jnp.ndarray         # (bin_ax, D*cap2v) int32: row | dist<<20 | ok<<31
    overflow_total: jnp.ndarray  # (bin_ax, D) int32 seed-hit overflow
    n_spilled: jnp.ndarray    # (bin_ax, D) int32 verify-lane spills
    route_overflow: jnp.ndarray  # (bin_ax, D) int32 pairs beyond t_cap
    route_words: jnp.ndarray  # (n_pad, ceil(Bp/32)) uint32 routing bits
    ovf_rows: jnp.ndarray     # (bin_ax, D*2*t_cap) bool: seed-hit overflow per
                              # SLOT ROW ([t_cap fwd | t_cap rc]) — lets the
                              # host fall back per (read, bin) pair
    v_need: jnp.ndarray       # (bin_ax, D) int32 true verify-lane demand
    loc_need: jnp.ndarray     # (bin_ax, D) int32 true locate-lane demand
                              # (cap auto-tuner inputs; see dream_mesh)


META_ROW_BITS = 20            # flat slot rows: up to 2*t_cap < 2^20
META_ROW_MASK = (1 << META_ROW_BITS) - 1
META_DIST_SHIFT = META_ROW_BITS
META_OK_SHIFT = 31


def routing_from_counts(counts, n_sel, lengths2, k: int, window: int,
                        rate_ppm: int, half: int, slack_table=None):
    """Routing threshold (k-mer lemma, or the calibrated/heuristic minimizer
    bound when window > k) + orientation OR — identical to the single-chip
    classifier (ops/ibf_query.ibf_classify_packed)."""
    thr = classify_thresholds(lengths2, n_sel, k, window, rate_ppm,
                              slack_table)
    mask = counts >= thr[:, None]
    return mask[:half] | mask[half:]                       # (half, Bp)


def build_mesh_dream_step(mesh: Mesh, *, half_loc: int, L: int, B: int,
                          r_cap: int, rate_ppm: int, max_errors: int,
                          capacity: int, max_slen: int, prefix_q: int,
                          sample_rate: int, use_pallas: bool,
                          k: int = 0, n_hashes: int = 0, window: int = 0,
                          use_filter: bool = True, uniform_len: bool = False,
                          route_override: bool = False,
                          canonical: bool = False, blocked: bool = False,
                          direct: bool = False, block_s: int = 0,
                          slack_table=None, cap2l: float | None = None,
                          cap2v_f: float | None = None):
    """Jitted sharded step: (fmset, filter_words, blob[, route_words])
    -> MeshMapOut.

    fmset: DeviceFMSet, axis 0 sharded over 'bin' (B divisible by the bin
    axis); filter_words replicated; blob = concatenated per-data-shard
    pack_blob_with_lengths uploads, sharded over 'data'.

    `r_cap` is the per-device SHARED slot-pool capacity (t_cap): all routed
    (read, bin) pairs of a device compact into one pool
    (pipeline/flat_step.slot_pool) and map in ONE fused program — no per-bin
    lax.scan, no per-bin slot quantization, so skewed databases (config 5)
    cost work proportional to TOTAL routed pairs, not B * hottest_bin.

    `route_override=True` compiles a variant taking an explicit
    (n_pad, ceil(B/32)) uint32 routing-bit input instead of the IBF
    classify — the capacity-drain path: pairs beyond the pool re-submit
    through the SAME mesh step with only the leftover pairs routed, so
    overflow costs extra device passes, not host single-chip re-maps.
    """
    from ..pipeline.flat_step import flat_map_step, slot_pool

    data_ax = mesh.shape["data"]
    bin_ax = mesh.shape["bin"]
    assert B % bin_ax == 0, "pad bins to a multiple of the bin axis"
    assert r_cap <= (1 << (META_ROW_BITS - 1)), \
        "slot pool exceeds the meta row field"
    B_loc = B // bin_ax
    t_cap = r_cap
    import os

    # global verify budget as a multiple of the slot pool: 1.25 is
    # spill-free on configs 2/5 with fewer verify lanes and a smaller
    # begin/end/meta fetch than 2.0. Spills drain via the host fallback, so
    # a workload that exceeds the budget loses speed, never matches;
    # DY_CAP2V overrides.
    if cap2v_f is None:
        cap2v_f = float(os.environ.get("DY_CAP2V", "1.25"))
    cap2v = max(8, int(cap2v_f * t_cap))
    Wb_in = (B + 31) // 32
    # calibrated minimizer slack (tiny, replicated as a jit constant)
    slack_j = (jnp.asarray(np.asarray(slack_table, np.int32))
               if slack_table is not None else None)

    def local_step(fmset: DeviceFMSet, filter_words, blob, route_in):
        packed, nmask, lengths = unpack_blob(blob, half_loc, L)
        reads = unpack_reads(packed, nmask, lengths, L)    # (2*half_loc, L)
        lengths2 = jnp.concatenate([lengths, lengths])

        if route_override:
            bits = ((route_in[:, :, None]
                     >> jnp.arange(32, dtype=jnp.uint32)[None, None, :]) & 1)
            cand = bits.reshape(half_loc, Wb_in * 32)[:, :B].astype(bool)
            cand = cand & (lengths > 0)[:, None]
        elif use_filter and canonical:
            # canonical filters cover both orientations from forward rows:
            # half the hash-row gathers, no orientation OR
            counts, n_sel = ibf_bin_counts(filter_words, reads[:half_loc],
                                           lengths, k, n_hashes, window,
                                           canonical=True, blocked=blocked,
                                           n_bins=B, block_s=block_s)
            thr = classify_thresholds(lengths, n_sel, k, window, rate_ppm,
                                      slack_j)
            cand = (counts >= thr[:, None])[:, :B]
        elif use_filter:
            counts, n_sel = ibf_bin_counts(filter_words, reads, lengths2, k,
                                           n_hashes, window, blocked=blocked,
                                           direct=direct, n_bins=B,
                                           block_s=block_s)
            cand = routing_from_counts(counts, n_sel, lengths2, k, window,
                                       rate_ppm, half_loc, slack_j)
            cand = cand[:, :B]
        else:
            cand = jnp.broadcast_to((lengths > 0)[:, None], (half_loc, B))

        # routing bits for the host (fallback bookkeeping) — bit-packed
        Wb = (B + 31) // 32
        cb = jnp.pad(cand, ((0, 0), (0, Wb * 32 - B)))
        route_words = (cb.reshape(half_loc, Wb, 32).astype(jnp.uint32)
                       << jnp.arange(32, dtype=jnp.uint32)[None, None, :]).sum(
                           axis=2, dtype=jnp.uint32)

        base = jax.lax.axis_index("bin") * B_loc
        local_cols = jax.lax.dynamic_slice_in_dim(cand, base, B_loc, axis=1)

        read_slot, bin_slot, valid, route_ovf = slot_pool(local_cols, t_cap)
        out = flat_map_step(
            fmset, reads, lengths, read_slot, bin_slot, valid,
            half_loc=half_loc, rate_ppm=rate_ppm, max_errors=max_errors,
            capacity=capacity, max_slen=max_slen, prefix_q=prefix_q,
            compact_cap=cap2v, uniform_len=uniform_len,
            sample_rate=sample_rate, use_pallas=use_pallas, cap2l=cap2l)
        meta = (out.row
                | (jnp.clip(out.dist, 0, 31) << META_DIST_SHIFT)
                | (out.ok.astype(jnp.int32) << META_OK_SHIFT))
        # per slot-row seed overflow (seeds are (2T, ns) row-major)
        ovf_row = out.overflow.reshape(2 * t_cap, -1).sum(axis=1) > 0
        one = lambda x: jnp.asarray(x, jnp.int32).reshape(1, 1)
        return MeshMapOut(
            begin=out.begin[None, :], end=out.end[None, :],
            meta=meta[None, :],
            overflow_total=one(out.overflow_total),
            n_spilled=one(out.n_spilled),
            route_overflow=one(route_ovf), route_words=route_words,
            ovf_rows=ovf_row[None, :],
            v_need=one(out.v_need), loc_need=one(out.loc_need))

    fm_specs = DeviceFM(
        bwt_blocks=P("bin"), occ=P("bin"), counts=P("bin"), sa=P("bin"),
        text=P("bin"), n=P("bin"),
        pfx_lo=None if prefix_q == 0 else P("bin"),
        pfx_hi=None if prefix_q == 0 else P("bin"),
        fused=P("bin"),
        sa_mark_bits=None if sample_rate == 1 else P("bin"),
        sa_rank_ck=None if sample_rate == 1 else P("bin"))
    fmset_spec = DeviceFMSet(
        bwt_blocks=fm_specs.bwt_blocks, occ=fm_specs.occ,
        counts=fm_specs.counts, sa=fm_specs.sa, text=fm_specs.text,
        n=fm_specs.n, pfx_lo=fm_specs.pfx_lo, pfx_hi=fm_specs.pfx_hi,
        fused=fm_specs.fused, sa_mark_bits=fm_specs.sa_mark_bits,
        sa_rank_ck=fm_specs.sa_rank_ck)

    out_specs = MeshMapOut(
        begin=P("bin", "data"), end=P("bin", "data"),
        meta=P("bin", "data"), overflow_total=P("bin", "data"),
        n_spilled=P("bin", "data"), route_overflow=P("bin", "data"),
        route_words=P("data"), ovf_rows=P("bin", "data"),
        v_need=P("bin", "data"), loc_need=P("bin", "data"))
    if route_override:
        sharded = jax.shard_map(
            local_step, mesh=mesh,
            in_specs=(fmset_spec, P(), P("data"), P("data")),
            out_specs=out_specs, check_vma=False)
    else:
        sharded = jax.shard_map(
            lambda fmset_, fw_, blob_: local_step(fmset_, fw_, blob_, None),
            mesh=mesh, in_specs=(fmset_spec, P(), P("data")),
            out_specs=out_specs, check_vma=False)
    return jax.jit(sharded)


def shard_db(mesh: Mesh, fmset: DeviceFMSet):
    """Place the stacked DB on the mesh ('bin'-sharded, replicated over 'data')."""
    put = lambda x: jax.device_put(x, NamedSharding(mesh, P("bin")))
    return DeviceFMSet(*(None if getattr(fmset, f) is None
                         else put(getattr(fmset, f))
                         for f in fmset._fields))


def pack_batch_blob(seqs_fwd: np.ndarray, lengths: np.ndarray,
                    data_ax: int, L: int):
    """Per-data-shard packed uploads, concatenated so axis 0 shards evenly.

    seqs_fwd: (n, L) forward rows only. Returns (blob, half_loc): reads are
    padded with length-0 rows to data_ax * half_loc; global read id of
    (shard d, slot s) = d * half_loc + s.
    """
    n = len(lengths)
    half_loc = (n + data_ax - 1) // data_ax
    blobs = []
    for d in range(data_ax):
        ids = np.arange(d * half_loc, min((d + 1) * half_loc, n))
        lens = np.zeros(half_loc, dtype=np.int32)
        lens[: len(ids)] = lengths[ids]
        blobs.append(pack_blob_with_lengths(seqs_fwd[ids], lens, half_loc, L))
    return np.concatenate(blobs), half_loc


def decode_flat_device(out: "MeshMapOut", jrow: int, d: int,
                       routing: np.ndarray, half_loc: int, B_loc: int,
                       t_cap: int, sens: str, bin_col0: int | None = None):
    """Decode one (bin-shard j, data-shard d) device's flat-pool output.

    Slot order is the device's deterministic bin-major cumsum
    (pipeline/flat_step.slot_pool), reconstructed here from the routing
    bits — no slot arrays are fetched.

    Returns (m, fb_pairs, leftover_pairs, spilled):
      m: dict of match arrays (read_id, bin_local, strand, begin, end, dist)
         with bin_local in [0, B_loc) — caller adds the shard's bin base and
         per-match global offsets; None when the device found nothing.
      fb_pairs: (reads, bins_local) whose seed hits overflowed `capacity`
         (exhaustive re-map needed); their pool matches are ALREADY dropped.
      leftover_pairs: (reads, bins_local) beyond the pool (drain pass).
      spilled: verify-lane compaction spilled — caller must re-map ALL of
         this device's routed pairs (m is then None).
    """
    if bin_col0 is None:
        bin_col0 = jrow * B_loc   # single-process layout: row j = shard j
    n = routing.shape[0]
    r0 = d * half_loc
    rsub = np.zeros((half_loc, B_loc), dtype=bool)
    rows = routing[r0 : min(r0 + half_loc, n)]
    rsub[: rows.shape[0]] = rows[:, bin_col0 : bin_col0 + B_loc]
    src = np.flatnonzero(rsub.T.reshape(-1))          # bin-major slot order
    slots, leftover_src = src[:t_cap], src[t_cap:]
    bin_l = (slots // half_loc).astype(np.int64)
    read_l = (slots % half_loc).astype(np.int64)
    leftover_pairs = (r0 + leftover_src % half_loc,
                      leftover_src // half_loc)
    n_slots = len(slots)

    if int(out.n_spilled[jrow, d]) > 0:
        return None, (np.zeros(0, np.int64), np.zeros(0, np.int64)), \
            leftover_pairs, True

    # per-pair seed-capacity overflow -> exhaustive re-map of those pairs.
    # ovf_rows strides by SEQ ROWS (2*t_cap per data shard); meta/begin/end
    # stride by VERIFY LANES (cap2v per shard, = 2*t_cap only at the default
    # DY_CAP2V factor) — derive cap2v from the array shape, never assume.
    r2 = 2 * t_cap
    ovf = out.ovf_rows[jrow, d * r2 : (d + 1) * r2]
    slot_ovf = (ovf[:t_cap] | ovf[t_cap:])[:n_slots]
    if sens == "low":
        slot_ovf = np.zeros(n_slots, dtype=bool)
    fb_pairs = (r0 + read_l[slot_ovf], bin_l[slot_ovf])

    n_data = out.ovf_rows.shape[1] // r2
    cap2 = out.meta.shape[1] // n_data
    meta = out.meta[jrow, d * cap2 : (d + 1) * cap2].view(np.uint32)
    ok = (meta >> META_OK_SHIFT) > 0
    if not ok.any():
        return None, fb_pairs, leftover_pairs, False
    meta = meta[ok]
    row = (meta & META_ROW_MASK).astype(np.int64)
    dist = ((meta >> META_DIST_SHIFT) & 31).astype(np.int32)
    slot = row % t_cap
    strand = (row // t_cap).astype(np.int8)
    keep = slot < n_slots
    if slot_ovf.any():
        keep &= ~np.where(keep, slot_ovf[np.minimum(slot, n_slots - 1)],
                          False)
    m = dict(
        read_id=(r0 + read_l[np.minimum(slot, n_slots - 1)])[keep],
        bin_local=bin_l[np.minimum(slot, n_slots - 1)][keep],
        strand=strand[keep],
        begin=out.begin[jrow, d * cap2 : (d + 1) * cap2][ok][keep].astype(np.int64),
        end=out.end[jrow, d * cap2 : (d + 1) * cap2][ok][keep].astype(np.int64),
        dist=dist[keep])
    return m, fb_pairs, leftover_pairs, False


def pack_route_words(routing: np.ndarray, B: int) -> np.ndarray:
    """(n_pad, B) bool -> (n_pad, ceil(B/32)) uint32 (inverse of
    decode_routing) — the route-override input of the capacity-drain pass."""
    n_pad = routing.shape[0]
    Wb = (B + 31) // 32
    rb = np.zeros((n_pad, Wb * 32), dtype=bool)
    rb[:, :B] = routing[:, :B]
    return (rb.reshape(n_pad, Wb, 32).astype(np.uint32)
            << np.arange(32, dtype=np.uint32)[None, None, :]).sum(
                axis=2, dtype=np.uint32)


def decode_routing(route_words: np.ndarray, n: int, B: int) -> np.ndarray:
    """(n_pad, Wb) uint32 -> (n, B) bool candidate mask."""
    bits = ((route_words[:, :, None]
             >> np.arange(32, dtype=np.uint32)[None, None, :]) & 1)
    return bits.reshape(route_words.shape[0], -1)[:n, :B].astype(bool)
