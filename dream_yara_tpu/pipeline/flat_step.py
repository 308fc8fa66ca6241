"""Flat multi-bin map step: ONE dense XLA program over a shared slot pool.

The DREAM mesh step originally lax.scan'ned the single-bin map step over
each device's local bins. That design has two structural costs that config-5
(256 skewed bins) exposed brutally:

  * the scan SERIALIZES hundreds of tiny map steps — at 256 bins the pass is
    launch-latency-bound (sequential little ops), the device nearly idle;
  * every bin gets the same fixed r_cap read slots, so slot work scales with
    B * max_bin_load — a single hot bin inflates EVERY bin's padding.

Replacement: compact all routed (read, bin) pairs of a device into
ONE shared slot pool (bin-major order, cumsum + scatter, no sort) and run a
single map step over the flattened multi-bin index space. Every table row
fetch simply adds the slot's bin offset — fused rank rows, counts, q-mer
prefix rows, 8-wide SA rows and 128-wide text blocks are all (B, rows, W)
stacks gathered at bin*rows + local_row via the FetchHooks seams. Slot work
now scales with TOTAL ROUTED PAIRS, independent of skew, and the whole pass
is one dense batch (full vector width, no sequential bin loop).

Slot rows are laid out [T fwd | T rc]; seeds inherit the single-bin layout,
so MapStepOut decoding matches the single-bin conventions with
row -> (slot = row % T, strand = row // T).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..ops.device_index import DeviceFMSet
from .map_step import FetchHooks, MapStepOut


def slot_pool(cand_local: jnp.ndarray, t_cap: int):
    """Compact routed (read, bin) pairs into t_cap shared slots.

    cand_local: (n_loc, B_loc) bool routing for THIS device's reads x bins.
    Bin-major order (all of bin 0's reads, then bin 1's, ...) so table
    fetches of neighbouring slots share bins. Returns
    (read_slot, bin_slot, valid, n_overflow): (t_cap,) arrays + scalar count
    of pairs beyond t_cap (the host re-submits them in a drain pass; order
    is deterministic, so the host reconstructs slot assignment exactly).
    """
    n_loc, B_loc = cand_local.shape
    from .map_step import flat_cumsum

    flat = cand_local.T.reshape(-1)                 # bin-major
    pos = flat_cumsum(flat.astype(jnp.int32)) - 1
    total = jnp.where(flat.shape[0] > 0, pos[-1] + 1, 0)
    dst = jnp.where(flat & (pos < t_cap), pos, t_cap)
    src = jnp.zeros(t_cap + 1, jnp.int32).at[dst].set(
        jnp.arange(flat.shape[0], dtype=jnp.int32))[:t_cap]
    valid = jnp.arange(t_cap, dtype=jnp.int32) < jnp.minimum(total, t_cap)
    return src % n_loc, src // n_loc, valid, jnp.maximum(total - t_cap, 0)


def flat_map_step(fmset: DeviceFMSet, reads2: jnp.ndarray, lengths2: jnp.ndarray,
                  read_slot, bin_slot, valid, *,
                  half_loc: int, rate_ppm: int, max_errors: int,
                  capacity: int, max_slen: int, prefix_q: int,
                  compact_cap: int | None, uniform_len: bool,
                  sample_rate: int = 1, use_pallas: bool = False,
                  stop_after: str | None = None,
                  cap2l: float | None = None) -> MapStepOut:
    """Map every slot against its own bin in one fused program.

    fmset: stacked per-bin tables (this device's LOCAL bins, axis 0);
    reads2: (2*half_loc, L) fwd+rc rows of this device's read shard;
    lengths2: (half_loc,) read lengths; slot arrays from slot_pool.
    """
    B, nb1 = fmset.fused.shape[0], fmset.fused.shape[1]
    # text geometry from the TEXT stack: fmset.sa is shorter than the text
    # under a sampled SA (sample_rate > 1)
    n_text = fmset.text.shape[1]
    max_sa = fmset.sa.shape[1]
    T = read_slot.shape[0]

    sub_fwd = jnp.take(reads2, read_slot, axis=0)
    sub_rc = jnp.take(reads2, half_loc + read_slot, axis=0)
    sub_reads = jnp.concatenate([sub_fwd, sub_rc], axis=0)      # (2T, L)
    dead = jnp.where(valid, jnp.int8(0), jnp.int8(4))[:, None]
    sub_reads = jnp.where(jnp.tile(dead, (2, 1)) == 4, jnp.int8(4), sub_reads)
    sub_lens = jnp.where(valid, jnp.take(lengths2, read_slot), 0)

    ns = max_errors + 1
    bin_row = jnp.tile(bin_slot, 2)                             # (2T,)
    bin_seed = jnp.repeat(bin_row, ns)                          # (S,)

    # flat table views: row index = bin * rows_per_bin + local_row
    fused_flat = fmset.fused.reshape(B * nb1, -1)
    counts_flat = fmset.counts.reshape(-1)                      # (B*(SIGMA+1),)
    nsig = fmset.counts.shape[1]
    pad8 = (-max_sa) % 8
    sa_p = jnp.pad(fmset.sa, ((0, 0), (0, pad8)))
    nrl = (max_sa + pad8) // 8
    sa8_flat = sa_p.reshape(B * nrl, 8)
    pad128 = (-n_text) % 128
    tb_p = jnp.pad(fmset.text, ((0, 0), (0, pad128)),
                   constant_values=jnp.int8(7))   # BWT_PAD mismatches all
    ntb = (n_text + pad128) // 128
    tb_flat = tb_p.reshape(B * ntb, 128)
    pfx_flat = None
    if prefix_q > 0 and fmset.pfx_lo is not None:
        pfx_flat = jnp.stack([fmset.pfx_lo, fmset.pfx_hi],
                             axis=2).reshape(B * 4 ** prefix_q, 2)

    bin_seed2 = jnp.tile(bin_seed, 2)
    hooks = FetchHooks(
        rank_rows=lambda b: jnp.take(fused_flat, bin_seed2 * nb1 + b, axis=0),
        pfx=(None if pfx_flat is None else
             lambda m: jnp.take(pfx_flat, bin_seed * (4 ** prefix_q) + m,
                                axis=0)),
        sa_rows=lambda r: jnp.take(sa8_flat, bin_seed * nrl + r, axis=0),
        n_sa_rows=nrl,
        tblocks=None)   # installed per-lane below (needs compaction's vrow)
    n_seed = jnp.take(fmset.n, bin_seed)
    counts_fetch = lambda c: jnp.take(counts_flat, bin_seed * nsig + c)

    return _flat_core(fmset, sub_reads, sub_lens, bin_slot, rate_ppm,
                      max_errors, capacity, max_slen, compact_cap, prefix_q,
                      uniform_len, hooks, n_seed, counts_fetch, tb_flat, ntb,
                      sample_rate, bin_seed, fused_flat, counts_flat, nb1,
                      nsig, use_pallas, stop_after, cap2l)


def _flat_core(fmset, reads, lengths, bin_slot, rate_ppm, max_errors,
               capacity, max_slen, compact_cap, prefix_q, uniform_len,
               hooks, n_seed, counts_fetch, tb_flat, ntb,
               sample_rate, bin_seed, fused_flat, counts_flat, nb1,
               nsig, use_pallas=False, stop_after=None,
               cap2l: float | None = None) -> MapStepOut:
    """Mirror of map_step._map_step_core with per-seed bins (full SA only).

    stop_after: profiling-only early return ('search' | 'locate' | 'compact')
    — returns the partial arrays instead of MapStepOut so tools/
    profile_flat_step.py can attribute stage costs by difference. The
    product paths never set it."""
    from ..ops.backward_search import gather_hits, seed_search
    from ..ops.verify import banded_verify
    from .map_step import (_uniform_seed_chars, global_compact,
                           pairwise_dedup, seed_stop_depth)
    from .seeding import errors_for, make_seeds

    R2, L = reads.shape
    rows, starts, slens = make_seeds(lengths, R2, rate_ppm, max_errors)
    t_stop = seed_stop_depth(prefix_q)
    slens_eff = jnp.minimum(slens, t_stop)
    starts_eff = starts + (slens - slens_eff)
    msl_eff = min(max_slen, t_stop)
    chars_fe = (_uniform_seed_chars(reads, L, rate_ppm, max_errors, t_stop,
                                    msl_eff)
                if uniform_len else None)
    lo, hi, m_start = seed_search(
        None, None, None, n_seed, reads, rows, starts_eff, slens_eff,
        msl_eff, prefix_q=prefix_q, chars_fe=chars_fe,
        rank_row_fetch=hooks.rank_rows, pfx_fetch=hooks.pfx,
        counts_fetch=counts_fetch)
    starts = m_start
    if stop_after == "search":
        return lo, hi, m_start
    if sample_rate > 1:
        # sampled SA: fetch SA row ids, then walk LF to marked rows via the
        # fused-row hook locate (ops/locate.locate_sampled_fused)
        from ..ops.backward_search import gather_hit_rows
        from ..ops.locate import locate_sampled_fused

        sa_rows, hmask, overflow = gather_hit_rows(lo, hi, capacity)
        # Compact valid lanes BEFORE the LF walk: the walk costs
        # sample_rate-1 fori iterations of row gathers PER LANE, and only a
        # few percent of the S*capacity lanes are real hits (on the 64x32
        # Mbp config-3 DB, walking all 20M lanes took most of the step).
        # Valid lanes of a seed-row are a contiguous
        # prefix (gather_hit_rows mask = lane < cnt), so the row-start
        # scatter + cumulative-max fill from global_compact applies
        # directly; dropped lanes (pool overflow) are folded into the
        # per-seed `overflow` so the host re-maps those reads exactly.
        import os as _os

        from .map_step import flat_cumsum
        S = lo.shape[0]
        if cap2l is None:
            cap2l = float(_os.environ.get("DY_CAP2L", "4.0"))
        loc_cap = max(8, int(cap2l * (R2 // 2)))
        cnt = jnp.clip(hi - lo, 0, capacity).astype(jnp.int32)
        incl = flat_cumsum(cnt)
        loc_need = incl[-1] if S > 0 else jnp.int32(0)
        off = incl - cnt
        overflow = overflow + (incl > loc_cap).astype(overflow.dtype)
        dst = jnp.where((cnt > 0) & (off < loc_cap), off, loc_cap)
        row_start = jnp.zeros(loc_cap, jnp.int32).at[dst].set(
            jnp.arange(S, dtype=jnp.int32), mode="drop",
            unique_indices=True)
        rowp = jax.lax.associative_scan(jnp.maximum, row_start)
        slot_i = jnp.arange(loc_cap, dtype=jnp.int32)
        lane = slot_i - jnp.take(off, rowp)
        src = jnp.clip(rowp * capacity + lane, 0, S * capacity - 1)
        total = jnp.minimum(incl[-1] if S > 0 else jnp.int32(0), loc_cap)
        valid_c = slot_i < total
        rows_c = jnp.take(sa_rows.reshape(-1), src)
        bin_c = jnp.take(bin_seed, rowp)
        ngrp = fmset.sa_mark_bits.shape[1]                 # 4-word groups/bin
        mark4 = fmset.sa_mark_bits.reshape(-1, 4)          # bitcast: merges
        # leading dims of the (B, ngrp, 4) argument (device_index.py layout
        # note — a minor-dim-splitting reshape here OOM'd config-3)
        nck = fmset.sa_rank_ck.shape[1]
        ck_flat = fmset.sa_rank_ck.reshape(-1)
        max_sa = fmset.sa.shape[1]
        sa_flat = fmset.sa.reshape(-1)
        pos_c = locate_sampled_fused(
            row_fetch=lambda b: jnp.take(fused_flat, bin_c * nb1 + b, axis=0),
            counts_fetch=lambda c: jnp.take(counts_flat, bin_c * nsig + c),
            mark_words_fetch=lambda g: jnp.take(
                mark4, jnp.clip(bin_c * ngrp + g, 0,
                                mark4.shape[0] - 1), axis=0),
            ck_fetch=lambda g: jnp.take(
                ck_flat, jnp.clip(bin_c * nck + g, 0, ck_flat.shape[0] - 1)),
            sample_fetch=lambda i: jnp.take(
                sa_flat, jnp.clip(bin_c * max_sa + i, 0,
                                  sa_flat.shape[0] - 1)),
            rows=rows_c, sample_rate=sample_rate, valid=valid_c)
        # scatter located positions back into the dense (S, capacity) lane
        # layout (dedup/anchor math below is lane-indexed); lanes that
        # did not fit loc_cap are invalidated here AND counted in
        # `overflow` above, so the exhaustive host fallback re-maps them
        pos = jnp.zeros(S * capacity, jnp.int32).at[
            jnp.where(valid_c, src, S * capacity)].set(
                pos_c, mode="drop", unique_indices=True)
        pos = pos.reshape(S, capacity)
        lane_pos = off[:, None] + jnp.arange(capacity, dtype=jnp.int32)[None, :]
        hmask = hmask & (lane_pos < loc_cap)
    else:
        loc_need = jnp.int32(0)
        pos, hmask, overflow = gather_hits(None, lo, hi, capacity,
                                           sa_row_fetch=hooks.sa_rows,
                                           n_sa_rows=hooks.n_sa_rows)

    ns = max_errors + 1
    if stop_after == "locate":
        return pos, hmask
    A = (pos - starts[:, None]).reshape(R2, ns * capacity)
    V = hmask.reshape(R2, ns * capacity)
    row_ids = jnp.arange(R2, dtype=jnp.int32)
    if stop_after == "reshape":
        return A, V
    keep2 = pairwise_dedup(A, V)
    if stop_after == "dedup":
        return keep2
    if stop_after in ("flatten", "cumsum", "scatter"):
        # inline mirror of global_compact's row-start stages, for stage
        # attribution only (DY_PFS_STAGES in tools/profile_flat_step.py)
        from .map_step import flat_cumsum
        cnt = keep2.sum(axis=1, dtype=jnp.int32)
        incl = flat_cumsum(cnt)
        off = incl - cnt
        if stop_after == "flatten":                   # row counts + offsets
            return cnt, off, incl[-1]
        dst = jnp.where((cnt > 0) & (off < compact_cap), off, compact_cap)
        starts = jnp.zeros(compact_cap, jnp.int32).at[dst].set(
            jnp.arange(A.shape[0], dtype=jnp.int32), mode="drop",
            unique_indices=True)
        rowp = jax.lax.associative_scan(jnp.maximum, starts)
        if stop_after == "cumsum":                    # start scatter + fill
            return rowp, incl[-1]
        return global_compact(A, keep2, row_ids, compact_cap)[:2]
    vrow, vanch, keep, n_spilled = global_compact(A, keep2, row_ids,
                                                  compact_cap)
    if stop_after == "compact":
        return vrow, vanch, keep

    # verify: per-lane bin offsets for the text-block fetch + bounds
    bin_lane = jnp.take(jnp.tile(bin_slot, 2), vrow)
    n_lane = jnp.take(fmset.n, bin_lane)

    def tb_fetch(brow):
        bad = (brow < 0) | (brow >= ntb)
        r = jnp.take(tb_flat, jnp.clip(bin_lane * ntb + brow,
                                       0, tb_flat.shape[0] - 1), axis=0)
        return jnp.where(bad[:, None], jnp.int8(7), r)

    n_reads = lengths.shape[0]
    lrow = jnp.take(lengths, vrow % n_reads).astype(jnp.int32)
    if use_pallas:
        # register-resident DP kernel; the window fetch stays in XLA via
        # the same stacked-table hook
        from ..ops.pallas_verify import banded_verify_pallas_hooked

        dist, beg, end = banded_verify_pallas_hooked(
            vanch, reads, vrow, lrow, max_err=max_errors,
            tblock_fetch=tb_fetch)
    else:
        dist, beg, end = banded_verify(None, vanch, reads, vrow, lrow,
                                       max_err=max_errors,
                                       tblock_fetch=tb_fetch)
    budget = errors_for(lrow, rate_ppm)
    ok = keep & (dist <= budget) & (beg >= 0) & (end <= n_lane)
    return MapStepOut(row=vrow, begin=beg, end=end, dist=dist, ok=ok,
                      seed_lo=lo, seed_hi=hi, overflow=overflow,
                      m_start=m_start,
                      overflow_total=overflow.sum(dtype=jnp.int32),
                      n_spilled=n_spilled,
                      # true demands for the host cap auto-tuner: verify
                      # lanes wanted = used (keep) + spilled; locate lanes
                      # wanted = unclipped cumsum total
                      v_need=n_spilled + keep.sum(dtype=jnp.int32),
                      loc_need=loc_need)
