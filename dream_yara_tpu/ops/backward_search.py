"""Batched exact backward search of seeds in one bin's FM-index.

Reference analog: multi-pattern exact search in src/mapper_filter.h findSeeds<0>
via SeqAn FM iterators [U]. Lockstep: all S seeds advance in lockstep through
a fixed-trip-count fori_loop over seed length; each step issues 2S rank queries
as one batched gather (lo and hi bounds fused into a single (2S,) rank call so
the BWT row gathers coalesce). Dead seeds (empty interval / invalid) are
carried along — branchless, as XLA wants.

Seeds are searched back-to-front (backward search matches the suffix first).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .rank import rank


def backward_search(bwt_blocks, occ, counts, n,
                    seeds: jnp.ndarray, valid: jnp.ndarray | None = None):
    """Exact SA intervals for fixed-length seeds.

    seeds: (S, L) int8 codes; valid: (S,) bool (False => returns empty interval).
    Returns (lo, hi): each (S,) int32, interval [lo, hi) of exact matches.
    """
    S, L = seeds.shape
    lo0 = jnp.zeros(S, dtype=jnp.int32)
    hi0 = jnp.full(S, n, dtype=jnp.int32)
    if valid is not None:
        hi0 = jnp.where(valid, hi0, 0)

    def step(t, carry):
        lo, hi = carry
        c = jax.lax.dynamic_slice_in_dim(seeds, L - 1 - t, 1, axis=1)[:, 0]
        c32 = c.astype(jnp.int32)
        bounds = jnp.concatenate([lo, hi])
        ranks = rank(bwt_blocks, occ, jnp.tile(c32, 2), bounds)
        cc = jnp.take(counts, c32)
        nlo = cc + ranks[:S]
        nhi = cc + ranks[S:]
        # keep empty intervals empty (rank is monotone so nlo<=nhi holds anyway)
        alive = lo < hi
        return jnp.where(alive, nlo, lo), jnp.where(alive, nhi, lo)

    lo, hi = jax.lax.fori_loop(0, L, step, (lo0, hi0))
    return lo, hi


def seed_search(bwt_blocks, occ, counts, n, reads: jnp.ndarray,
                rows: jnp.ndarray, starts: jnp.ndarray, slens: jnp.ndarray,
                max_seed_len: int,
                pfx_lo=None, pfx_hi=None, prefix_q: int = 0, fused=None,
                chars_fe: jnp.ndarray | None = None,
                rank_row_fetch=None, pfx_fetch=None, counts_fetch=None):
    """Exact backward search of variable-length seeds cut from the read matrix.

    reads: (R2, L) int8; rows/starts/slens: (S,) int32 — seed s is
    reads[rows[s], starts[s] : starts[s]+slens[s]]. max_seed_len bounds the
    fori_loop trip count (static). slens == 0 marks invalid seeds -> empty
    interval. Seeds advance in lockstep back-to-front; seeds shorter than
    max_seed_len finish early and freeze (branchless masking).

    With a q-mer prefix table (pfx_lo/pfx_hi, index/fmindex.py), seeds whose
    last q chars are pure ACGT start q steps in via one table gather —
    replacing 2*q rank gathers per seed (the dominant cost). Seeds ineligible
    for the jump (N in the last q chars) may not finish within the shared trip
    budget; their interval is then the exact interval of the last
    `matched_len` chars — a superset whose spurious anchors the banded
    verifier rejects. The returned m_start reports the true start of the
    matched part per seed so anchors stay exact either way.

    `chars_fe` (optional, (S, max_seed_len) int8): seed chars indexed FROM THE
    SEED'S END — chars_fe[s, j] = reads[rows[s], starts[s] + slens[s] - 1 - j]
    (pad 4 past slens[s]). When the caller can build it WITHOUT gathers
    (uniform read lengths => static per-seed windows, map_step), passing it
    replaces every per-trip read-matrix char gather with static/contiguous
    column slices.

    Returns (lo, hi, m_start): each (S,) int32.
    """
    S = rows.shape[0]
    L = reads.shape[1]
    flat = reads.reshape(-1)
    lo0 = jnp.zeros(S, dtype=jnp.int32)
    # n may be a scalar (one bin) or an (S,) per-seed vector (the flat
    # multi-bin step, pipeline/flat_step.py)
    n_vec = jnp.broadcast_to(jnp.asarray(n, dtype=jnp.int32), (S,))
    hi0 = jnp.where(slens > 0, n_vec, 0)
    consumed0 = jnp.zeros(S, dtype=jnp.int32)
    trips = max_seed_len

    use_tab = prefix_q > 0 and (pfx_lo is not None or pfx_fetch is not None)
    if use_tab:
        q = prefix_q
        m_idx = jnp.zeros(S, dtype=jnp.int32)
        ok_tab = slens >= q
        for t in range(q):
            if chars_fe is not None:
                # char at position starts+slens-q+t == from-end index q-1-t
                # (clamped for tiny seed windows: those seeds fail slens >= q
                # and read pad chars (4), so ok_tab stays false either way)
                c = chars_fe[:, min(q - 1 - t, chars_fe.shape[1] - 1)].astype(jnp.int32)
            else:
                idx = starts + slens - q + t
                c = jnp.take(flat, rows * L + jnp.clip(idx, 0, L - 1)).astype(jnp.int32)
            ok_tab = ok_tab & (c < 4)
            m_idx = (m_idx << 2) | (c & 3)
        # ONE (4^q, 2) row gather instead of two element gathers into the
        # big tables. `pfx_fetch` overrides for mesh-sharded tables
        # (parallel/sharded_fm.py).
        if pfx_fetch is not None:
            t_both = pfx_fetch(m_idx)
        else:
            t_both = jnp.take(jnp.stack([pfx_lo, pfx_hi], axis=1), m_idx,
                              axis=0)
        t_lo, t_hi = t_both[:, 0], t_both[:, 1]
        lo0 = jnp.where(ok_tab, t_lo, lo0)
        hi0 = jnp.where(ok_tab, t_hi, hi0)
        consumed0 = jnp.where(ok_tab, q, 0)
        # adaptive trip count: table-eligible seeds only need
        # max_seed_len - q more steps. Seeds that cannot jump (N in the
        # last q chars, or shorter than q) need up to max_seed_len — but
        # they are rare, so that extension runs under a lax.cond only when
        # such a seed exists in the batch (each trip is 2S rank gathers,
        # the dominant search cost).
        trips = max(max_seed_len - q, 1)
        extra_trips = max_seed_len - trips
        need_extra = jnp.any((slens > 0) & ~ok_tab & (slens > trips))

    def step(t, carry):
        lo, hi = carry
        tt = t + consumed0
        active = tt < slens
        if chars_fe is not None:
            # from-end index tt = t (+ q where the table jump consumed q
            # chars): two contiguous dynamic column slices + select, no gather
            ca = jax.lax.dynamic_slice_in_dim(chars_fe, t, 1, axis=1)[:, 0]
            if use_tab:
                cb = jax.lax.dynamic_slice_in_dim(
                    chars_fe, t + prefix_q, 1, axis=1)[:, 0]
                c = jnp.where(consumed0 > 0, cb, ca).astype(jnp.int32)
            else:
                c = ca.astype(jnp.int32)
        else:
            idx = starts + slens - 1 - tt
            c = jnp.take(flat, rows * L + jnp.clip(idx, 0, L - 1)).astype(jnp.int32)
        bounds = jnp.concatenate([lo, hi])
        if fused is not None or rank_row_fetch is not None:
            from .rank import rank_fused
            ranks = rank_fused(fused, jnp.tile(c, 2), bounds,
                               row_fetch=rank_row_fetch)
        else:
            ranks = rank(bwt_blocks, occ, jnp.tile(c, 2), bounds)
        cc = jnp.take(counts, c) if counts_fetch is None else counts_fetch(c)
        nlo = cc + ranks[:S]
        nhi = cc + ranks[S:]
        upd = active & (lo < hi)
        return jnp.where(upd, nlo, lo), jnp.where(upd, nhi, hi)

    lo, hi = jax.lax.fori_loop(0, trips, step, (lo0, hi0))
    trips_taken = jnp.int32(trips)
    if use_tab and extra_trips > 0:
        lo, hi = jax.lax.cond(
            need_extra,
            lambda c: jax.lax.fori_loop(trips, trips + extra_trips, step, c),
            lambda c: c, (lo, hi))
        trips_taken = jnp.where(need_extra, trips + extra_trips, trips)
    matched = consumed0 + jnp.minimum(
        jnp.maximum(slens - consumed0, 0), trips_taken)
    m_start = starts + slens - matched
    return lo, jnp.maximum(lo, hi), m_start


def gather_hit_rows(lo: jnp.ndarray, hi: jnp.ndarray, capacity: int):
    """Like gather_hits but returns SA ROW indices (sampled-SA mode: the
    caller locates them via ops.locate.locate_sampled_packed)."""
    offs = jnp.arange(capacity, dtype=jnp.int32)
    rows = lo[:, None] + offs[None, :]
    mask = rows < hi[:, None]
    overflow = jnp.maximum(hi - lo - capacity, 0)
    return jnp.where(mask, rows, 0), mask, overflow


def gather_hits(sa: jnp.ndarray, lo: jnp.ndarray, hi: jnp.ndarray, capacity: int,
                sa_row_fetch=None, n_sa_rows: int | None = None):
    """Expand SA intervals into text positions with a per-seed capacity.

    The hits of one seed are CONSECUTIVE SA entries lo..lo+capacity-1, so
    instead of S*capacity element gathers this fetches the few 8-wide SA rows
    covering the span (gathers cost per INDEX, not per byte) and aligns with
    a log-shift roll cascade — the same trick as the verify window fetch.

    `sa_row_fetch(r) -> (S, 8)` + `n_sa_rows` override the local row gather
    (mesh-sharded SA, parallel/sharded_fm.py).

    Returns (positions, mask, overflow):
      positions: (S, capacity) int32 text positions (garbage where ~mask)
      mask:      (S, capacity) bool — hit j of seed s is real
      overflow:  (S,) int32 — hits beyond capacity (must be reprocessed by the
                 caller to preserve all-mapping completeness; SURVEY.md §7
                 "ragged routing under fixed-capacity buffers")
    """
    S = lo.shape[0]
    W = 8
    offs = jnp.arange(capacity, dtype=jnp.int32)
    mask = (lo[:, None] + offs[None, :]) < hi[:, None]
    if sa_row_fetch is None:
        n_sa = sa.shape[0]
        nrows = (n_sa + W - 1) // W
        sa8 = jnp.pad(sa, (0, nrows * W - n_sa)).reshape(nrows, W)
        sa_row_fetch = lambda r: jnp.take(sa8, r, axis=0)
    else:
        assert n_sa_rows is not None
        nrows = n_sa_rows
    k_rows = (capacity + 2 * W - 2) // W          # rows covering lo..lo+cap-1
    r0 = lo >> 3
    cat = jnp.concatenate(
        [sa_row_fetch(jnp.clip(r0 + j, 0, nrows - 1))
         for j in range(k_rows)], axis=1)          # (S, k_rows*W)
    sh = lo & (W - 1)
    for b in (4, 2, 1):                            # align start to column 0
        cat = jnp.where((sh & b)[:, None] != 0, jnp.roll(cat, -b, axis=1), cat)
    positions = cat[:, :capacity]
    overflow = jnp.maximum(hi - lo - capacity, 0)
    return positions, mask, overflow
