"""Single-bin device mapping step: seed -> search -> locate -> dedup -> verify.

This is the jitted hot path (reference _mapReadsImpl, SURVEY.md §3.1, stages
collectSeeds/findSeeds/extendHits fused into one XLA program). All shapes are
static: R2 seq rows x NS seeds x CAP hits; dead lanes are masked, never
branched on. Host-side post-processing (match table, ranking, SAM) lives in
pipeline/matches.py.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.backward_search import gather_hit_rows, gather_hits, seed_search
from ..ops.device_index import DeviceFM
from ..ops.verify import banded_verify
from ..ops.readpack import (pack_blob_with_lengths, pack_reads_fwd,
                            unpack_blob, unpack_reads)
from .seeding import errors_for, make_seeds


class FetchHooks(NamedTuple):
    """Injectable table-row fetchers for mesh-sharded big-bin indexes
    (parallel/sharded_fm.py, SURVEY.md §5.7). Each replaces the
    corresponding local device-memory gather in the map step; `None` fields
    keep the local path. Sharded mode requires sample_rate == 1 (the SA is
    sharded instead of sampled); the verify kernel works with hooks too
    (the hook's gathers run in XLA ahead of the kernel)."""

    rank_rows: object = None    # (b:(Q,)int32) -> (Q, 24) fused rank rows
    pfx: object = None          # (m:(S,)int32) -> (S, 2) q-mer intervals
    sa_rows: object = None      # (r:(S,)int32) -> (S, 8) SA rows
    n_sa_rows: int | None = None
    tblocks: object = None      # (brow:(C,)int32) -> (C, 128) text blocks


class MapStepOut(NamedTuple):
    row: jnp.ndarray       # (Cv,) int32 seq row (garbage where ~ok)
    begin: jnp.ndarray     # (Cv,) int32 global text begin
    end: jnp.ndarray       # (Cv,) int32 global text end (exclusive)
    dist: jnp.ndarray      # (Cv,) int32 edit distance
    ok: jnp.ndarray        # (Cv,) bool
    seed_lo: jnp.ndarray   # (S,) int32 — SA interval for overflow fallback
    seed_hi: jnp.ndarray   # (S,) int32
    overflow: jnp.ndarray  # (S,) int32 hits beyond capacity per seed
    m_start: jnp.ndarray   # (S,) int32 true read-index start of the matched
                           # part (differs from the nominal seed start for
                           # table-ineligible seeds that hit the trip budget)
    overflow_total: jnp.ndarray  # () int32 — fetch the (S,) arrays only if > 0
    n_spilled: jnp.ndarray     # () int32 candidates dropped by per-row
                               # compaction; > 0 => host re-runs the chunk
                               # densely to preserve completeness
    # true (unclipped) lane DEMANDS, for the host cap auto-tuner
    # (dream_mesh): verify lanes wanted by global_compact and locate lanes
    # wanted by the sampled-SA walk. 0 where the path did not run.
    v_need: jnp.ndarray = 0    # () int32
    loc_need: jnp.ndarray = 0  # () int32


def max_seed_len_static(max_len: int, rate_ppm: int) -> int:
    """Static bound on seed length over all read lengths <= max_len."""
    best = 1
    for l in range(1, max_len + 1):
        e = (l * rate_ppm) // 10_000
        best = max(best, l // (e + 1))
    return best


def max_rep_seed_len_static(max_len: int, rate_ppm: int) -> int:
    """Static bound on the LONG seeds of the repetitive path (s'=ceil((E+1)/2))."""
    best = 1
    for l in range(1, max_len + 1):
        e = (l * rate_ppm) // 10_000
        best = max(best, l // max(1, (e + 2) // 2))
    return best




def seed_stop_depth(prefix_q: int) -> int:
    """Truncated-search depth: a seed's LAST t_stop chars are enough to make
    the SA interval tiny (expected spurious hits ~ n/4^t_stop per seed); the
    banded verifier rejects any false anchor, so truncation costs zero
    sensitivity while cutting most rank iterations."""
    return prefix_q + 5 if prefix_q > 0 else 16


@functools.partial(
    jax.jit, static_argnames=("rate_ppm", "max_errors", "capacity", "max_slen",
                              "verify_capacity", "compact_cap", "prefix_q",
                              "use_pallas", "sample_rate", "uniform_len"))
def single_bin_map_step(fm: DeviceFM, reads: jnp.ndarray, lengths: jnp.ndarray,
                        *, rate_ppm: int, max_errors: int, capacity: int,
                        max_slen: int,
                        verify_capacity: int | None = None,
                        compact_cap: int | None = None,
                        prefix_q: int = 0,
                        use_pallas: bool = False,
                        sample_rate: int = 1,
                        uniform_len: bool = False) -> MapStepOut:
    return _map_step_core(fm, reads, lengths, rate_ppm, max_errors, capacity,
                          max_slen, verify_capacity, compact_cap, prefix_q,
                          use_pallas, sample_rate, uniform_len)


@functools.partial(
    jax.jit, static_argnames=("half", "L", "rate_ppm", "max_errors", "capacity",
                              "max_slen", "verify_capacity", "compact_cap",
                              "prefix_q", "use_pallas", "sample_rate",
                              "uniform_len"))
def single_bin_map_step_packed(fm: DeviceFM, blob: jnp.ndarray,
                               *, half: int, L: int, rate_ppm: int, max_errors: int,
                               capacity: int, max_slen: int,
                               verify_capacity: int | None = None,
                               compact_cap: int | None = None,
                               prefix_q: int = 0,
                               use_pallas: bool = False,
                               sample_rate: int = 1,
                               uniform_len: bool = False) -> MapStepOut:
    """Packed-upload entry (see pack_reads_fwd): unpacks reads on device.

    Returns (bundle, seed_lo, seed_hi, overflow): every per-candidate output
    plus the two scalars concatenated into ONE int32 array, so a chunk
    needs one device->host fetch instead of seven. Unpack with
    unbundle_out; the seed-interval arrays stay on device until an overflow
    makes them needed.
    """
    packed, nmask, lengths = unpack_blob(blob, half, L)
    reads = unpack_reads(packed, nmask, lengths, L)
    out = _map_step_core(fm, reads, lengths, rate_ppm, max_errors, capacity,
                         max_slen, verify_capacity, compact_cap, prefix_q,
                         use_pallas, sample_rate, uniform_len)
    if _meta_packable(L, max_errors, half * 2):
        # bit-pack (row, dist, end-begin, ok) into one int32 next to begin:
        # halves the fetched bytes
        delta = jnp.clip(out.end - out.begin, 0, 255)
        meta = (out.row | (jnp.clip(out.dist, 0, 31) << 18) | (delta << 23)
                | (out.ok.astype(jnp.int32) << 31))
        bundle = jnp.concatenate([
            out.begin, meta, out.overflow_total[None], out.n_spilled[None]])
    else:
        bundle = jnp.concatenate([
            out.row, out.begin, out.end, out.dist, out.ok.astype(jnp.int32),
            out.overflow_total[None], out.n_spilled[None]])
    return bundle, out.seed_lo, out.seed_hi, out.overflow, out.m_start


def _meta_packable(L: int, max_errors: int, R2: int) -> bool:
    return L + 2 * max_errors < 256 and R2 <= (1 << 18) and max_errors <= 31


def unbundle_out(bundle: np.ndarray, seed_lo, seed_hi, overflow, m_start,
                 L: int, max_errors: int, R2: int) -> MapStepOut:
    """Host-side inverse of the packed entry's bundling."""
    if _meta_packable(L, max_errors, R2):
        cv = (len(bundle) - 2) // 2
        begin = bundle[:cv]
        meta = bundle[cv : 2 * cv].view(np.uint32)
        row = (meta & 0x3FFFF).astype(np.int32)
        dist = ((meta >> 18) & 31).astype(np.int32)
        end = begin + ((meta >> 23) & 255).astype(np.int32)
        ok = (meta >> 31) > 0
        return MapStepOut(row=row, begin=begin, end=end, dist=dist, ok=ok,
                          seed_lo=seed_lo, seed_hi=seed_hi, overflow=overflow,
                          m_start=m_start, overflow_total=bundle[2 * cv],
                          n_spilled=bundle[2 * cv + 1])
    cv = (len(bundle) - 2) // 5
    f = lambda i: bundle[i * cv : (i + 1) * cv]
    return MapStepOut(row=f(0), begin=f(1), end=f(2), dist=f(3),
                      ok=f(4).astype(bool), seed_lo=seed_lo, seed_hi=seed_hi,
                      overflow=overflow, m_start=m_start,
                      overflow_total=bundle[5 * cv],
                      n_spilled=bundle[5 * cv + 1])


def uniform_len_ok(lengths, L: int, rate_ppm: int, max_errors: int) -> bool:
    """Host-side eligibility for the gather-free seed-char fast path: every
    read has length exactly L AND the static error budget equals L's own
    (see _uniform_seed_chars). ALL callers must use this one predicate — a
    drifted copy could enable the fast path on ineligible batches and break
    the byte-equality contract."""
    return (bool(np.all(np.asarray(lengths) == L))
            and (L * rate_ppm) // 10_000 == max_errors)


def _uniform_seed_chars(reads, L, rate_ppm, max_errors, t_stop, msl_eff):
    """Gather-free seed-char matrix for UNIFORM-length batches.

    When every (non-padding) read in the chunk has length exactly L and the
    batch error budget equals floor(L * rate) (the caller asserts both before
    setting uniform_len), the pigeonhole seed windows are the same static
    slices of the read matrix for every row: seed k covers
    [k*slen, (k+1)*slen), truncated to its last slen_eff chars. The whole
    (S, msl_eff) chars-from-end matrix is then ns static column slices +
    flips — replacing ~(prefix_q + trips) * S int8 flat gathers per chunk.

    Padding rows (length 0) get garbage chars here; their seeds carry
    slens == 0, so seed_search masks them (ok_tab false, active false) —
    value-exact with the gather path.
    """
    R2 = reads.shape[0]
    ns = max_errors + 1
    slen = L // ns
    slen_eff = min(slen, t_stop)
    cols = []
    for k in range(ns):
        a = k * slen + (slen - slen_eff)
        w = jax.lax.slice_in_dim(reads, a, a + slen_eff, axis=1)
        w = jnp.flip(w, axis=1)                      # chars-from-end order
        if slen_eff < msl_eff:
            w = jnp.pad(w, ((0, 0), (0, msl_eff - slen_eff)),
                        constant_values=np.int8(4))
        cols.append(w)
    return jnp.stack(cols, axis=1).reshape(R2 * ns, msl_eff)


def _map_step_core(fm, reads, lengths, rate_ppm, max_errors, capacity,
                   max_slen, verify_capacity, compact_cap, prefix_q,
                   use_pallas, sample_rate, uniform_len=False,
                   hooks: FetchHooks | None = None) -> MapStepOut:
    R2, L = reads.shape
    n_reads = lengths.shape[0]
    if hooks is None:
        hooks = FetchHooks()
    else:
        assert sample_rate == 1, "sharded big-bin mode requires a full SA"

    rows, starts, slens = make_seeds(lengths, R2, rate_ppm, max_errors)
    # truncated search: match only each seed's last t_stop chars (see
    # seed_stop_depth); the read-start anchor math shifts accordingly
    t_stop = seed_stop_depth(prefix_q)
    slens_eff = jnp.minimum(slens, t_stop)
    starts_eff = starts + (slens - slens_eff)
    msl_eff = min(max_slen, t_stop)
    chars_fe = (_uniform_seed_chars(reads, L, rate_ppm, max_errors, t_stop,
                                    msl_eff)
                if uniform_len else None)
    lo, hi, m_start = seed_search(fm.bwt_blocks, fm.occ, fm.counts, fm.n,
                                  reads, rows, starts_eff, slens_eff,
                                  msl_eff,
                                  pfx_lo=fm.pfx_lo, pfx_hi=fm.pfx_hi,
                                  prefix_q=prefix_q, fused=fm.fused,
                                  chars_fe=chars_fe,
                                  rank_row_fetch=hooks.rank_rows,
                                  pfx_fetch=hooks.pfx)
    starts = m_start  # anchors below = hit pos - true start of matched part
    if sample_rate > 1:
        # sampled SA: fetch row ids, then walk LF to marked rows. The walk
        # MUST run on the fused rank rows, not raw bwt_blocks/occ: a lean
        # DeviceFMSet slice (parallel/dream_mesh.py fallback path) carries
        # only 1-block placeholders for those — the raw-rank walk then
        # located only directly-marked rows (~1/rate of hits) and the
        # mesh seed-overflow fallback silently lost the rest of its
        # matches (found at DY_CAP2L=2.0 on config-3: 67% mapped).
        from ..ops.locate import locate_sampled_fused

        sa_rows, hmask, overflow = gather_hit_rows(lo, hi, capacity)
        mark4 = fm.sa_mark_bits.reshape(-1, 4)
        pos = locate_sampled_fused(
            row_fetch=lambda b: jnp.take(fm.fused, b, axis=0),
            counts_fetch=lambda c: jnp.take(fm.counts, c),
            mark_words_fetch=lambda g: jnp.take(
                mark4, jnp.clip(g, 0, mark4.shape[0] - 1), axis=0),
            ck_fetch=lambda g: jnp.take(
                fm.sa_rank_ck, jnp.clip(g, 0, fm.sa_rank_ck.shape[0] - 1)),
            sample_fetch=lambda i: jnp.take(
                fm.sa, jnp.clip(i, 0, fm.sa.shape[0] - 1)),
            rows=sa_rows.reshape(-1), sample_rate=sample_rate,
            valid=hmask.reshape(-1)).reshape(sa_rows.shape)
    else:
        pos, hmask, overflow = gather_hits(fm.sa, lo, hi, capacity,
                                           sa_row_fetch=hooks.sa_rows,
                                           n_sa_rows=hooks.n_sa_rows)

    ns = max_errors + 1
    A = (pos - starts[:, None]).reshape(R2, ns * capacity)
    V = hmask.reshape(R2, ns * capacity)
    row_ids = jnp.arange(R2, dtype=jnp.int32)
    if compact_cap is not None:
        keep2 = pairwise_dedup(A, V)
        vrow, vanch, keep, n_spilled = global_compact(A, keep2, row_ids,
                                                      compact_cap)
    else:
        vrow, vanch, keep, n_spilled = dedup_compact(A, V, row_ids,
                                                     verify_capacity)
    dist, beg, end, ok = verify_candidates(
        fm, reads, lengths, vrow, vanch, keep, rate_ppm, max_errors,
        use_pallas=use_pallas, tblock_fetch=hooks.tblocks)
    return MapStepOut(row=vrow, begin=beg, end=end, dist=dist, ok=ok,
                      seed_lo=lo, seed_hi=hi, overflow=overflow, m_start=m_start,
                      overflow_total=overflow.sum(dtype=jnp.int32),
                      n_spilled=n_spilled)


def pairwise_dedup(A, V):
    """keep mask after removing duplicate anchors WITHIN each row — SORT-FREE
    (slots is small, so an O(slots^2) pairwise compare on the minor axis is
    plain elementwise work)."""
    R, slots = A.shape
    # dup[r, j] = exists k < j with V[r, k] and A[r, k] == A[r, j]
    PAIR_BLOCK = 64
    if slots <= PAIR_BLOCK:
        earlier = jnp.tril(jnp.ones((slots, slots), bool), k=-1)
        eq = A[:, :, None] == A[:, None, :]
        dup = (eq & V[:, None, :] & earlier[None, :, :]).any(axis=2)
        return V & ~dup
    # wide slot counts (the edit-layout repetitive path): a fori_loop over
    # j-blocks keeps ONE (R, PB, slots) buffer live instead of slots/PB of
    # them — unrolled chunking compiled to multi-GiB temporaries at
    # config-2 shapes
    PB = 32
    nb = (slots + PB - 1) // PB
    pad = nb * PB - slots
    Ap = jnp.pad(A, ((0, 0), (0, pad)))

    def blk(i, dup):
        j0 = i * PB
        Aj = jax.lax.dynamic_slice_in_dim(Ap, j0, PB, axis=1)   # (R, PB)
        eq = Aj[:, :, None] == A[:, None, :]                    # (R, PB, slots)
        kle = (jnp.arange(slots, dtype=jnp.int32)[None, None, :]
               < (j0 + jnp.arange(PB, dtype=jnp.int32))[None, :, None])
        d = (eq & V[:, None, :] & kle).any(axis=2)              # (R, PB)
        return jax.lax.dynamic_update_slice(dup, d, (0, j0))

    dup = jax.lax.fori_loop(0, nb, blk,
                            jnp.zeros((R, nb * PB), bool))[:, :slots]
    return V & ~dup


def flat_cumsum(x: jnp.ndarray) -> jnp.ndarray:
    """Hierarchical 1-D int cumsum: 2-D row-wise prefix + row offsets.

    Exact same values as jnp.cumsum; whether the split still beats a flat
    cumsum on the GPU is not measured.
    """
    n = x.shape[0]
    C = 4096
    if n <= 2 * C:
        return jnp.cumsum(x)
    M = (n + C - 1) // C
    x2 = jnp.pad(x, (0, M * C - n)).reshape(M, C)
    within = jnp.cumsum(x2, axis=1)
    rows = jnp.concatenate([jnp.zeros(1, x.dtype),
                            jnp.cumsum(within[:, -1])[:-1]])
    return (within + rows[:, None]).reshape(-1)[:n]


def global_compact(A, V, row_ids, cap2: int):
    """Cross-row compaction of kept lanes into one fixed global budget.

    Unlike dedup_compact's per-row selection, the budget is shared over the
    whole chunk: a repetitive read may use many verify lanes while clean
    reads use one, so the common case fits cap2 ~= 1 lane/seq-row. The
    compaction is a cumsum (position of each kept lane) + scatter — no sort.
    Lanes beyond cap2 are counted in n_spilled (host re-runs densely,
    completeness never lost).

    A, V: (R, slots); row_ids: (R,). Returns (vrow, vanch, keep2, n_spilled)
    with (cap2,) shapes.

    Implementation: ROW-START scatter + prefix-max fill + within-row rank
    select. Instead of scattering all R*slots lanes (the dropped ones
    colliding on a dump slot, XLA's non-unique scatter path), only the <=R
    row start positions are scattered (unique indices, mode='drop') and
    each output slot's row is rebuilt by a cumulative-max scan. Output is
    bit-identical to the full scatter, including the zeroed tail beyond
    `total`.
    """
    R, slots = A.shape
    cnt = V.sum(axis=1, dtype=jnp.int32)                   # (R,)
    incl = flat_cumsum(cnt)
    off = incl - cnt                                       # exclusive cumsum
    # R is a static positive cap everywhere today; keep the zero-row case
    # well-defined rather than indexing incl[-1] on an empty array
    total = incl[-1] if R > 0 else jnp.int32(0)
    # row starts: each row with kept lanes writes its INDEX at its first
    # output position; indices are unique, spilled rows go out of bounds
    dst = jnp.where((cnt > 0) & (off < cap2), off, cap2)   # cap2 = oob drop
    starts = jnp.zeros(cap2, jnp.int32).at[dst].set(
        jnp.arange(R, dtype=jnp.int32), mode="drop", unique_indices=True)
    rowp = jax.lax.associative_scan(jnp.maximum, starts)   # fill the gaps
    # rank of each output slot within its row, then pick that kept lane
    j = jnp.arange(cap2, dtype=jnp.int32) - jnp.take(off, rowp)
    keepr = jnp.take(V, rowp, axis=0)                      # (cap2, slots)
    within = jnp.cumsum(keepr, axis=1, dtype=jnp.int32)
    hit = (within == (j[:, None] + 1)) & keepr
    slot = jnp.argmax(hit, axis=1).astype(jnp.int32)
    vanch = jnp.take_along_axis(jnp.take(A, rowp, axis=0),
                                slot[:, None], axis=1)[:, 0]
    keep2 = jnp.arange(cap2, dtype=jnp.int32) < jnp.minimum(total, cap2)
    vrow = jnp.where(keep2, jnp.take(row_ids, rowp), 0)
    n_spilled = jnp.maximum(total - cap2, 0)
    return vrow, jnp.where(keep2, vanch, 0), keep2, n_spilled


def dedup_compact(A, V, row_ids, verify_capacity: int | None):
    """Per-row anchor dedup + compaction — SORT-FREE.

    Duplicate (row, anchor) pairs can only occur WITHIN a seq row (the E+1
    seeds of one read all hit the same diagonal). Dedup is an O(slots^2)
    pairwise compare on the minor axis (slots is small) and compaction is a
    kv-step argmax-selection loop — both plain elementwise work, no sort. Spilled candidates are counted so the host can re-run
    densely (completeness never lost). For wide slot counts (the repetitive
    path) a chunked pairwise pass bounds the (R, s, s) tensor.

    A, V: (R, slots) anchors + validity; row_ids: (R,) seq-row id per row.
    Returns (vrow, vanch, keep) flattened (R*kv,) + n_spilled scalar.
    """
    R, slots = A.shape
    keep2 = pairwise_dedup(A, V)
    kept_before = keep2.sum(dtype=jnp.int32)

    if verify_capacity is not None and verify_capacity < slots:
        kv = verify_capacity
        picked_a, picked_k = [], []
        kw = keep2
        col = jnp.arange(slots, dtype=jnp.int32)[None, :]
        for _ in range(kv):
            idx = jnp.argmax(kw, axis=1)                      # first kept slot
            got = jnp.take_along_axis(kw, idx[:, None], axis=1)[:, 0]
            a = jnp.take_along_axis(A, idx[:, None], axis=1)[:, 0]
            picked_a.append(jnp.where(got, a, 0))
            picked_k.append(got)
            kw = kw & (col != idx[:, None])
        Am = jnp.stack(picked_a, axis=1)                      # (R, kv)
        keep2 = jnp.stack(picked_k, axis=1)
    else:
        kv = slots
        Am = jnp.where(keep2, A, 0)
    n_spilled = kept_before - keep2.sum(dtype=jnp.int32)

    keep = keep2.reshape(-1)
    vrow = jnp.repeat(row_ids, kv)
    vanch = Am.reshape(-1)
    return (jnp.where(keep, vrow, 0), jnp.where(keep, vanch, 0),
            keep, n_spilled)


def verify_uses_kernel() -> bool:
    """Which banded-verify edition the first device's platform runs: the
    Triton kernel (ops/pallas_verify.py) on "gpu", the XLA DP
    (ops/verify.py) on "cpu". Any other platform has no verified edition
    and is refused."""
    platform = jax.devices()[0].platform
    if platform == "gpu":
        return True
    if platform == "cpu":
        return False
    raise RuntimeError(f"no banded-verify edition for platform {platform!r}"
                       " (supported: gpu, cpu)")


def verify_candidates(fm: DeviceFM, reads, lengths, vrow, vanch, keep,
                      rate_ppm: int, max_errors: int, use_pallas: bool = False,
                      tblock_fetch=None):
    n_reads = lengths.shape[0]
    lrow = jnp.take(lengths, vrow % n_reads).astype(jnp.int32)
    if use_pallas and tblock_fetch is None:
        from ..ops.pallas_verify import banded_verify_pallas

        dist, beg, end = banded_verify_pallas(
            fm.text, vanch, reads, vrow, lrow, max_err=max_errors)
    elif use_pallas:
        # sharded/stacked text: the hook's gathers (incl. any psum over
        # text shards) run in XLA; only the DP enters the kernel
        from ..ops.pallas_verify import banded_verify_pallas_hooked

        dist, beg, end = banded_verify_pallas_hooked(
            vanch, reads, vrow, lrow, max_err=max_errors,
            tblock_fetch=tblock_fetch)
    else:
        dist, beg, end = banded_verify(fm.text, vanch, reads, vrow, lrow,
                                       max_err=max_errors,
                                       tblock_fetch=tblock_fetch)
    budget = errors_for(lrow, rate_ppm)
    ok = keep & (dist <= budget) & (beg >= 0) & (end <= fm.n)
    return dist, beg, end, ok


@functools.partial(
    jax.jit, static_argnames=("rate_ppm", "max_errors", "capacity",
                              "max_slen_rep", "verify_capacity", "use_pallas",
                              "budget", "indels", "backend"))
def repetitive_map_step(fm: DeviceFM, reads: jnp.ndarray, lengths: jnp.ndarray,
                        rep_rows: jnp.ndarray, rep_mask: jnp.ndarray,
                        *, rate_ppm: int, max_errors: int, capacity: int,
                        max_slen_rep: int, verify_capacity: int = 8,
                        use_pallas: bool = False, budget: int = 1,
                        indels: bool = False, backend: str = "enum"):
    """Re-seed repetitive rows with fewer/longer approximate seeds.

    The classifier path (reference mapper_classifier.h + findSeeds<1|2>
    [U]): rows whose exact seeds overflowed capacity get
    s' = ceil((E+1)/(budget+1)) seeds of length l // s', searched with up
    to `budget` edits via dense layout enumeration
    (ops/approx_search.seed_search_edits); pigeonhole keeps the stratum
    covered (s' seeds x (budget+1) > E). `indels` additionally enumerates
    one-indel layouts (beyond reference Hamming parity).

    rep_rows: (K,) seq-row ids; rep_mask: (K,) bool.
    Returns (row, begin, end, dist, ok, n_spilled).
    """
    from ..ops.approx_search import seed_search_edits

    K = rep_rows.shape[0]
    n_reads = lengths.shape[0]

    l = jnp.take(lengths, rep_rows % n_reads).astype(jnp.int32)
    l = jnp.where(rep_mask, l, 0)
    e = errors_for(l, rate_ppm).astype(jnp.int32)
    ns2 = (e + budget + 1) // (budget + 1)          # ceil((E+1)/(budget+1))
    ns2_max = (max_errors + budget + 1) // (budget + 1)

    rows_s = jnp.repeat(rep_rows, ns2_max)
    sidx = jnp.tile(jnp.arange(ns2_max, dtype=jnp.int32), K)
    l_s = jnp.repeat(l, ns2_max)
    ns2_s = jnp.repeat(ns2, ns2_max)
    slen = jnp.where(ns2_s > 0, l_s // jnp.maximum(ns2_s, 1), 0)
    valid_s = sidx < ns2_s
    starts = sidx * slen
    slens = jnp.where(valid_s, slen, 0)

    if backend == "bidir":
        # search-scheme backend on the bidirectional index (subs only;
        # the caller guarantees full windows and rfused availability —
        # pipeline/mapper.py BinMapper._bidir_ok)
        from ..ops.bidir_search import bidir_seed_search

        lo, hi, lvalid, w_start = bidir_seed_search(
            fm.fused, fm.counts, fm.rfused, fm.counts, fm.n, reads,
            rows_s, starts, slens, max_slen_rep, budget=budget)
    else:
        lo, hi, lvalid, w_start = seed_search_edits(
            fm.bwt_blocks, fm.occ, fm.counts, fm.n, reads,
            rows_s, starts, slens, max_slen_rep, budget=budget,
            indels=indels, fused=fm.fused)
    hi = jnp.where(lvalid, hi, lo)

    S = rows_s.shape[0]
    NL = lo.shape[1]
    pos, hmask, _ov = gather_hits(fm.sa, lo.reshape(-1), hi.reshape(-1),
                                  capacity)

    # anchor = window begin in text; indel layouts shift the window END by
    # +-1, absorbed by the verifier's band
    A = pos - jnp.repeat(w_start, NL)[:, None]                # (S*NL, cap)
    slots = ns2_max * NL * capacity
    A = A.reshape(K, slots)
    V = hmask.reshape(K, slots)
    vrow, vanch, keep, n_spilled = dedup_compact(
        A, V, jnp.where(rep_mask, rep_rows, 0), verify_capacity)
    dist, beg, end, ok = verify_candidates(
        fm, reads, lengths, vrow, vanch, keep, rate_ppm, max_errors,
        use_pallas=use_pallas)
    return vrow, beg, end, dist, ok, n_spilled


@functools.partial(jax.jit, static_argnames=("max_errors",))
def verify_positions(fm: DeviceFM, reads, lengths, rows, anchors, mask,
                     *, max_errors: int):
    """Verify explicit (row, anchor) candidates (overflow fallback / rescue)."""
    n_reads = lengths.shape[0]
    vrow = jnp.where(mask, rows, 0)
    lrow = jnp.take(lengths, vrow % n_reads).astype(jnp.int32)
    dist, beg, end = banded_verify(fm.text, jnp.where(mask, anchors, 0),
                                   reads, vrow, lrow, max_err=max_errors)
    return dist, beg, end
