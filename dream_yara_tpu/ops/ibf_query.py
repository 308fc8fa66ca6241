"""Device IBF query — HOT LOOP 1 (SURVEY.md §3.1 whichBins).

Reference analog: src/d_bloom_filter.h whichBins [U]: per k-mer, AND the
n_hashes rows, accumulate per-bin counters, threshold by the k-mer lemma.
Lockstep: all reads x k-mers x hashes evaluated at once — hash arithmetic is
uint32 elementwise math (identical bit-for-bit to index/hashing.py, tested), row
fetches are batched gathers of whole uint32 rows, bit unpack + count is a
broadcast shift-and-mask summed over the k-mer axis.

Minimizer mode (window w > k, reference build_filter's optional winnowing
[U,M]): the same leftmost-min-key selection as the host builder picks ~2/(w-k+2)
of the k-mers; selected k-mers are COMPACTED per read (cumsum+scatter, no
sort) before the row gathers, cutting the gather count ~(w-k)/2-fold — the
round-1 "IBF classify gather wall" fix. The routing threshold switches to the
probabilistic minimizer bound (index/ibf.py minimizer_threshold).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..index.hashing import HASH_SEEDS, MIX_MULT


def _fmix32(h):
    h ^= h >> 16
    h = h * jnp.uint32(0x85EBCA6B)
    h ^= h >> 13
    h = h * jnp.uint32(0xC2B2AE35)
    h ^= h >> 16
    return h


def kmer_windows_dev(reads: jnp.ndarray, lengths: jnp.ndarray, k: int,
                     canonical: bool = False):
    """Packed k-mer windows of each read row. reads: (R, L) int8.

    Returns (lo, hi, valid): (R, L-k+1) each; valid masks windows containing
    N/pad or beyond the read length. `canonical=True` returns the
    strand-canonical min(fwd, revcomp) packing (index/hashing.py
    canonical_windows, bit-identical) — the filter-build convention that
    lets classify hash only forward rows.
    """
    R, L = reads.shape
    m = L - k + 1
    codes = reads.astype(jnp.uint32)
    lo = jnp.zeros((R, m), dtype=jnp.uint32)
    hi = jnp.zeros((R, m), dtype=jnp.uint32)
    for t in range(min(k, 16)):
        lo = lo | ((codes[:, t : m + t] & 3) << (2 * t))
    for t in range(16, k):
        hi = hi | ((codes[:, t : m + t] & 3) << (2 * (t - 16)))
    if canonical:
        comp = jnp.uint32(3) - (codes & 3)
        lo_r = jnp.zeros((R, m), dtype=jnp.uint32)
        hi_r = jnp.zeros((R, m), dtype=jnp.uint32)
        for t in range(min(k, 16)):
            lo_r = lo_r | (comp[:, k - 1 - t : k - 1 - t + m] << (2 * t))
        for t in range(16, k):
            hi_r = hi_r | (comp[:, k - 1 - t : k - 1 - t + m]
                           << (2 * (t - 16)))
        swap = (hi_r < hi) | ((hi_r == hi) & (lo_r < lo))
        lo = jnp.where(swap, lo_r, lo)
        hi = jnp.where(swap, hi_r, hi)
    bad = (reads >= 4).astype(jnp.int32)
    cbad = jnp.cumsum(bad, axis=1)
    cbad = jnp.concatenate([jnp.zeros((R, 1), jnp.int32), cbad], axis=1)
    no_n = (cbad[:, k:] - cbad[:, :-k]) == 0
    pos_ok = (jnp.arange(m, dtype=jnp.int32)[None, :] + k) <= lengths[:, None]
    return lo, hi, no_n & pos_ok


def minimizer_select_dev(mix: jnp.ndarray, valid: jnp.ndarray,
                         lengths: jnp.ndarray, w: int, k: int) -> jnp.ndarray:
    """Device winnowing — bit-identical to index/hashing.minimizer_select.

    mix: (R, m) uint32 pre-seed k-mer values; key = fmix32(mix); a position
    is selected iff it is the strict leftmost minimum of some w-window of
    the READ (rows are padded to L, so per-row window-start validity comes
    from `lengths`; reads shorter than w get the host's single-window
    semantics via window 0).
    """
    R, m = mix.shape
    W0 = w - k + 1
    if W0 <= 1:
        return valid
    key = jnp.where(valid, _fmix32(mix), jnp.uint32(0xFFFFFFFF))
    n_win = m - W0 + 1
    if n_win <= 0:
        n_win = 1
        key = jnp.pad(key, ((0, 0), (0, W0 - m)),
                      constant_values=0xFFFFFFFF)
    # per-read window count: length - w + 1 full windows; a shorter read
    # keeps window 0 alone (== the host's single-window branch)
    n_win_r = jnp.maximum(lengths - w + 1, 1)[:, None]
    # per-window leftmost argmin (strict < keeps the leftmost tie)
    bk = key[:, :n_win]
    bp = jnp.broadcast_to(jnp.arange(n_win, dtype=jnp.int32)[None, :],
                          (R, n_win))
    for d in range(1, W0):
        kd = key[:, d : d + n_win]
        better = kd < bk
        bk = jnp.where(better, kd, bk)
        bp = jnp.where(better,
                       jnp.arange(n_win, dtype=jnp.int32)[None, :] + d, bp)
    # selected[pos] = exists VALID window j in [pos-W0+1, pos], argmin == pos
    pos = jnp.arange(m, dtype=jnp.int32)[None, :]
    sel = jnp.zeros((R, m), dtype=bool)
    for d in range(W0):
        jpad = jnp.pad(bp, ((0, 0), (0, max(m - n_win, 0))),
                       constant_values=-1)[:, :m]
        shifted = jnp.roll(jpad, d, axis=1)
        hit = ((shifted == pos) & (pos - d >= 0)
               & (pos - d < jnp.minimum(n_win_r, n_win)))
        sel = sel | hit
    return sel & valid


def host_block_rows(words, n_bins: int = 0):
    """Host-side block-row layout for the device: slice the counted words
    and reshape (n_rows, Wd) -> (n_blocks, S*wdc) with numpy BEFORE upload.

    A device-side reshape of an (n_rows, 2)-shaped filter can force a
    relayout copy whose tiled form pads the tiny minor dim many times over
    (a compile-time OOM for a multi-GB filter). The (n_blocks, 128) layout
    is dense-minor and uploads/gathers with zero padding. Returns
    (rows, block_s) where block_s = S is the probe count per block that
    _count_rows_blocked needs for the in-block hash math."""
    import numpy as np

    from ..index.hashing import BLOCK_WORDS

    words = np.asarray(words)
    n_rows, Wd = words.shape
    S = BLOCK_WORDS // Wd
    wdc = min(Wd, max(1, (n_bins + 31) // 32)) if n_bins > 0 else Wd
    n_blocks = n_rows // S
    rows = np.ascontiguousarray(words[:, :wdc]).reshape(n_blocks, S * wdc)
    return rows, S


def _count_rows_blocked(filter_words, mixf, lanes_valid, n_hashes: int,
                        wd_count: int | None = None, block_s: int = 0):
    """Blocked-layout counts: all n_hashes probes of a window live in ONE
    512 B block (row ids block*S + p_j — bit-identical to index/
    hashing.ibf_blocked_rows), fetched with ONE block-row gather per
    window + an elementwise one-hot probe select, instead of n_hashes
    single-word gathers (checksum-identical).

    Gathering the full 512 B row for the WHOLE batch at once materializes
    a ~16 GiB temporary at config-2 shapes; this chunks the window axis
    (lax.map) so the materialized rows stay ~1 GiB, and gathers only the
    counted words (wd_count) of each row.

    wd_count: count only the first wd_count words per row (the words that
    hold real bins — the artifact pads bins to 64, so a B<=32 filter
    carries an always-zero second word). Row GEOMETRY always uses the
    artifact's full words-per-row.

    block_s > 0: filter_words is ALREADY the (n_blocks, S*wdc) block-row
    layout from host_block_rows (S = block_s) — the required form at scale;
    the in-program reshape below can relayout through a padded tiled copy
    when Wd is tiny."""
    from ..index.hashing import BLOCK_WORDS

    if block_s > 0:
        S = block_s
        n_blocks, sw = filter_words.shape
        wdc = sw // S
        rows = filter_words
    else:
        n_rows, Wd = filter_words.shape
        S = BLOCK_WORDS // Wd
        n_blocks = n_rows // S
        wdc = Wd if wd_count is None else min(wd_count, Wd)
        # (n_blocks, S, wdc) row-major: probe p's word w sits at p*wdc + w
        rows = (filter_words[:, :wdc] if wdc < Wd else filter_words)
        rows = rows.reshape(n_blocks, S * wdc)
    R, M = lanes_valid.shape

    # chunk so the gathered (c*M, S*wdc) uint32 rows stay ~<= 1 GiB
    lane_budget = (1 << 28) // (S * wdc)
    c = max(1, min(R, lane_budget // max(M, 1)))
    n_chunks = -(-R // c)
    pad = n_chunks * c - R
    mix2 = mixf.reshape(R, M)
    if pad:
        mix2 = jnp.pad(mix2, ((0, pad), (0, 0)))
        lanes_valid = jnp.pad(lanes_valid, ((0, pad), (0, 0)))

    def one_chunk(args):
        mixc, vc = args                                   # (c, M)
        mf = mixc.reshape(-1)
        v0 = _fmix32(mf ^ jnp.uint32(HASH_SEEDS[0]))
        block = (v0 & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32) \
            % jnp.int32(n_blocks)
        v1 = _fmix32(mf ^ jnp.uint32(HASH_SEEDS[1]))
        base = v1 & jnp.uint32(S - 1)
        stride = ((v1 >> jnp.uint32(8)) & jnp.uint32(S - 1)) | jnp.uint32(1)
        br = jnp.take(rows, block, axis=0)                # (c*M, S*wdc)
        iota = jnp.arange(S * wdc, dtype=jnp.uint32)[None, :]
        anded = None
        for j in range(n_hashes):
            pj = (base + jnp.uint32(j) * stride) & jnp.uint32(S - 1)
            sel = (iota // jnp.uint32(wdc)) == pj[:, None]
            gw = jnp.where(sel, br, jnp.uint32(0))
            gw = gw.reshape(-1, S, wdc).sum(axis=1, dtype=jnp.uint32)
            anded = gw if anded is None else (anded & gw)
        anded = jnp.where(vc.reshape(-1)[:, None], anded, jnp.uint32(0))
        shifts = jnp.arange(32, dtype=jnp.uint32)
        bits = ((anded[:, :, None] >> shifts) & 1).astype(jnp.int32)
        return bits.reshape(c, M, wdc * 32).sum(axis=1)   # (c, wdc*32)

    if n_chunks == 1:
        counts = one_chunk((mix2, lanes_valid))
    else:
        counts = jax.lax.map(
            one_chunk, (mix2.reshape(n_chunks, c, M),
                        lanes_valid.reshape(n_chunks, c, M))).reshape(
                            n_chunks * c, wdc * 32)
    return counts[:R].reshape(R, wdc, 32)


def _count_rows(filter_words, rows_by_hash, lanes_valid):
    """AND the hash rows per lane and unpack to per-bin counts.

    rows_by_hash: per-hash FLAT (R*M,) int32 row ids; lanes_valid: (R, M)
    bool; returns (R, Wd, 32). Every tensor here is 1-D or has a >=32 minor
    axis: a (R, M, h, ...) layout with the tiny hash minor axis can be
    padded by the compiler's tiling into a many-times-larger gather
    operand. 1-D tensors lay out densely.
    """
    R, M = lanes_valid.shape
    Wd = filter_words.shape[1]
    vflat = lanes_valid.reshape(-1)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    outs = []
    for w in range(Wd):
        anded = None
        for rj in rows_by_hash:
            gw = jnp.take(filter_words[:, w], rj)          # (R*M,) 1-D
            anded = gw if anded is None else (anded & gw)
        anded = jnp.where(vflat, anded, jnp.uint32(0)).reshape(R, M)
        bits = ((anded[:, :, None] >> shifts) & 1).astype(jnp.int32)
        outs.append(bits.sum(axis=1, dtype=jnp.int32))     # (R, 32)
    return jnp.stack(outs, axis=1)                         # (R, Wd, 32)


def ibf_bin_counts(filter_words: jnp.ndarray, reads: jnp.ndarray,
                   lengths: jnp.ndarray, k: int, n_hashes: int,
                   window: int = 0, canonical: bool = False,
                   blocked: bool = False,
                   direct: bool = False,
                   n_bins: int = 0,
                   block_s: int = 0) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Per-bin (selected-)k-mer hit counts for each read row.

    filter_words: (n_rows, Wd) uint32; reads: (R, L) int8. Returns
    (counts, n_sel): counts (R, Wc*32) int32 over padded bins; n_sel (R,)
    = number of counted k-mers (for the minimizer threshold). blocked=True
    uses the cache-blocked probe layout (all probes of a window in one
    512 B block). n_bins > 0 restricts blocked counting to the words that
    hold real bins (Wc = ceil(n_bins/32), else the artifact's full Wd) —
    classic-layout callers slice filter_words themselves instead (the row
    ids there don't depend on words-per-row)."""
    n_rows = filter_words.shape[0]
    R = reads.shape[0]
    lo, hi, valid = kmer_windows_dev(reads, lengths, k,
                                     canonical=canonical)      # (R, m)
    mix = lo ^ (hi * jnp.uint32(MIX_MULT))
    if window > k:
        valid = minimizer_select_dev(mix, valid, lengths, window, k)
        # compact selected k-mers (sparse ~2/(w-k+2)) before the row
        # gathers — the gathers cost per index, so this is the win
        m = mix.shape[1]
        W0 = window - k + 1
        cap = max(8, (2 * m) // max(W0, 1) + 8)
        pos = jnp.cumsum(valid.astype(jnp.int32), axis=1) - 1
        dst = jnp.where(valid & (pos < cap), pos, cap)
        rix = jnp.broadcast_to(jnp.arange(R)[:, None], dst.shape)
        z = jnp.zeros((R, cap + 1), jnp.uint32)
        cmix = z.at[rix, dst].set(jnp.where(valid, mix, jnp.uint32(0)))[:, :cap]
        total = jnp.minimum(pos[:, -1] + 1, cap)
        lanes_valid = jnp.arange(cap, dtype=jnp.int32)[None, :] < total[:, None]
        mix, valid, n_sel = cmix, lanes_valid, total
    else:
        n_sel = valid.sum(axis=1, dtype=jnp.int32)
    # per-hash FLAT row ids (bit-identical math to index/hashing.py); the
    # hash axis stays a Python loop so no tensor carries it as a tiny
    # minor dimension
    mixf = mix.reshape(-1)                                     # (R*m,)
    if blocked:
        wd_count = (None if block_s > 0 else
                    (min(filter_words.shape[1], max(1, (n_bins + 31) // 32))
                     if n_bins > 0 else None))
        counts = _count_rows_blocked(filter_words, mixf, valid, n_hashes,
                                     wd_count, block_s=block_s)
        return counts.reshape(R, -1), n_sel
    if direct:
        # direct-addressing filter (index/kdx.py): the row IS the packed
        # k-mer value (k <= 13 so lo == mix fits the table); no hashing
        rows_by_hash = [mixf.astype(jnp.int32)]
        counts = _count_rows(filter_words, rows_by_hash, valid)
        return counts.reshape(R, -1), n_sel
    rows_by_hash = []
    for j in range(n_hashes):
        vj = _fmix32(mixf ^ jnp.uint32(HASH_SEEDS[j]))
        rows_by_hash.append(
            (vj & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32) % jnp.int32(n_rows))
    counts = _count_rows(filter_words, rows_by_hash, valid)    # (R, Wd, 32)
    return counts.reshape(R, -1), n_sel


def classify_thresholds(lengths2, n_sel, k: int, window: int, rate_ppm: int,
                        slack_table=None):
    """Per-row routing threshold: k-mer lemma, or the minimizer bound when
    window > k — the CALIBRATED slack table when the filter artifact
    carries one (index/minimizer_calib.py, ~2x tighter), else the 2D
    heuristic (index/ibf.minimizer_threshold). Past the table's last entry
    the slack extrapolates with the heuristic's per-error step
    (conservative, never unsafe)."""
    e = (lengths2 * jnp.int32(rate_ppm)) // 10_000
    if window > k:
        W0 = max(window - k + 1, 1)
        D = -(-k // W0) + 2
        if slack_table is not None:
            e_max = slack_table.shape[0] - 1
            slack = (jnp.take(slack_table.astype(jnp.int32),
                              jnp.clip(e, 0, e_max))
                     + jnp.maximum(e - e_max, 0) * 2 * D)
            return jnp.maximum(n_sel - slack, 1)
        return jnp.maximum(n_sel - e * 2 * D, 1)
    return jnp.maximum((lengths2 - k + 1) - k * e, 1)


def ibf_candidates(filter_words, reads, lengths, k, n_hashes, thresholds,
                   window: int = 0):
    """Candidate (read, bin) mask: counts >= per-read threshold."""
    counts, _ = ibf_bin_counts(filter_words, reads, lengths, k, n_hashes,
                               window)
    return counts >= thresholds[:, None]


@functools.partial(jax.jit,
                   static_argnames=("half", "L", "k", "n_hashes", "rate_ppm",
                                    "window", "canonical", "blocked",
                                    "direct", "n_bins", "block_s"))
def ibf_classify_packed(filter_words, blob, slack_table=None, *, half: int,
                        L: int, k: int, n_hashes: int, rate_ppm: int,
                        window: int = 0, canonical: bool = False,
                        blocked: bool = False, direct: bool = False,
                        n_bins: int = 0, block_s: int = 0):
    """Whole-batch classification from packed uploads: unpack fwd+rc rows on
    device, count (selected) k-mers per bin, threshold, OR the two
    orientations, and bit-pack the (reads, bins) candidate mask so the
    device->host fetch is one small array (SURVEY.md §3.1 HOT LOOP 1)."""
    from .readpack import unpack_blob, unpack_fwd, unpack_reads

    packed, nmask, lengths = unpack_blob(blob, half, L)
    if canonical:
        # canonical values cover both orientations: hash forward rows only
        # (and skip the revcomp log-roll reconstruction entirely)
        fwd = unpack_fwd(packed, nmask, lengths, L)           # (half, L)
        counts, n_sel = ibf_bin_counts(filter_words, fwd, lengths,
                                       k, n_hashes, window, canonical=True,
                                       blocked=blocked, n_bins=n_bins,
                                       block_s=block_s)
        thr = classify_thresholds(lengths, n_sel, k, window, rate_ppm,
                                  slack_table)
        cand = counts >= thr[:, None]                         # (half, Bp)
    else:
        reads = unpack_reads(packed, nmask, lengths, L)       # (R2, L)
        lengths2 = jnp.concatenate([lengths, lengths])
        counts, n_sel = ibf_bin_counts(filter_words, reads, lengths2, k,
                                       n_hashes, window, blocked=blocked,
                                       direct=direct, n_bins=n_bins,
                                       block_s=block_s)
        thr = classify_thresholds(lengths2, n_sel, k, window, rate_ppm,
                                  slack_table)
        mask = counts >= thr[:, None]
        cand = mask[:half] | mask[half:]                      # (half, Bp)
    w = cand.shape[1] // 32
    bits = cand.reshape(half, w, 32).astype(jnp.uint32)
    words = (bits << jnp.arange(32, dtype=jnp.uint32)[None, None, :]).sum(
        axis=2, dtype=jnp.uint32)
    return words                                              # (half, Bp/32)
