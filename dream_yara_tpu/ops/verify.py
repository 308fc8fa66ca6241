"""Banded edit-distance verification of candidate locations (HOT LOOP 3).

Reference analog: banded Myers bit-vector DP in src/find_extender.h /
find_verifier.h [U]. Instead of Myers' word-parallel bit tricks (great on
scalar CPUs, a poor fit for wide vector lanes), we run a
*banded Levenshtein DP over the anti-band axis*, vectorized across candidates:

  state D[c, d] = min edits aligning read_c[0:j] to window ending at diagonal
  offset d (d in [0, 2E], band width W = 2E+1), stored as a (C, W) int32 array.
  One fori_loop step per read position j: a (C, W) compare + two shifted mins +
  a log2(W)-step min-plus prefix scan for the in-row (insertion) dependency.
  All candidates advance in lockstep; begin positions are carried through the
  DP so no traceback pass is needed for POS.

Semantics (the verification truth, docs/OUTPUT_CONTRACT.md): edit distance of
the ENTIRE read against text window [anchor-E, anchor+len+E); N and sentinel
(codes >= 4) mismatch everything, so alignments never silently match padding,
Ns, or contig boundaries.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

INF = 1 << 20  # plain int: a module-level jnp scalar would initialize the
               # XLA backend at import, breaking jax.distributed.initialize


def local_tblock_fetch(text: jnp.ndarray, L: int, E: int):
    """Block fetcher over one bin's local text: guard-padded 128-char block
    rows (one leading and enough trailing blocks of code 6, which
    mismatches everything), so out-of-text positions need no mask."""
    n_wblocks = (L + 2 * E + 127) // 128 + 1
    n = text.shape[0]
    nb = (n + 127) // 128
    padded = jnp.full(128 + (nb + n_wblocks + 1) * 128, 6, dtype=jnp.int8)
    padded = jax.lax.dynamic_update_slice(padded, text.astype(jnp.int8), (128,))
    tblocks = padded.reshape(-1, 128)
    return lambda r: jnp.take(tblocks, r + 1, axis=0)


def gather_windows(anchors: jnp.ndarray, L: int, E: int,
                   tblock_fetch) -> jnp.ndarray:
    """(C, L+2E) int8 text windows [anchor-E, anchor+L+E) per candidate.

    The windows are fetched as whole 128-char block rows (few gather
    indices) and aligned with a 7-step log-shift (uniform rolls + selects),
    not as an elementwise (C, L+2E) gather.
    """
    WLEN = L + 2 * E
    n_wblocks = (WLEN + 127) // 128 + 1
    a0 = anchors - E                               # >= -E > -128 always
    brow = a0 >> 7
    rows2 = jnp.concatenate([tblock_fetch(brow + i) for i in range(n_wblocks)],
                            axis=1)                # (C, n_wblocks*128)
    shift = a0 & 127
    for b in range(7):                             # align: left-shift by (a0 & 127)
        k = 1 << b
        rolled = jnp.concatenate([rows2[:, k:], rows2[:, :k]], axis=1)
        rows2 = jnp.where(((shift >> b) & 1)[:, None] == 1, rolled, rows2)
    return rows2[:, :WLEN]


def banded_verify(text: jnp.ndarray, anchors: jnp.ndarray, reads: jnp.ndarray,
                  read_rows: jnp.ndarray, lengths: jnp.ndarray, max_err: int,
                  tblock_fetch=None):
    """Verify candidates (read placed at text position `anchor` +- max_err).

    text: (n,) int8 bin text; anchors: (C,) int32 claimed begin positions;
    reads: (R2, L) int8 padded read matrix; read_rows: (C,) int32 row per
    candidate; lengths: (C,) int32; max_err: static band radius E.

    `tblock_fetch(brow) -> (C, 128)` overrides the local text-block gather
    (stacked per-bin tables, pipeline/flat_step.py; mesh-sharded text,
    parallel/sharded_fm.py); it must return rows of codes >= 4 for
    out-of-range block indices (brow < 0 or past the text end) and the
    final partial block padded likewise.

    Returns (dist, begin, end): (C,) int32 each — best whole-read edit
    distance within the band, and its text begin/end (end exclusive).
    Candidates whose optimum leaves the band report dist >= INF/2.
    """
    L = reads.shape[1]
    E = int(max_err)
    # LAYOUT: candidates on the minor axis — state arrays are (W, C), so
    # every elementwise op runs over the long candidate axis.
    rT = jnp.take(reads, read_rows, axis=0).T                      # (L, C)
    if tblock_fetch is None:
        tblock_fetch = local_tblock_fetch(text, L, E)
    wT = gather_windows(anchors, L, E, tblock_fetch).T             # (L+2E, C)
    return banded_dp(wT, rT, anchors, lengths, E)


def banded_dp(wT: jnp.ndarray, rT: jnp.ndarray, anchors: jnp.ndarray,
              lengths: jnp.ndarray, max_err: int):
    """The DP alone, on gathered operands: wT (L+2E, C) int8 transposed
    text windows, rT (L, C) int8 transposed reads. Returns (dist, begin,
    end) as banded_verify does."""
    L, C = rT.shape
    E = int(max_err)
    W = 2 * E + 1
    d_off = jnp.arange(W, dtype=jnp.int32)

    # D[d,c]: edits for read[0:j] vs window[0:j+d]; S[d,c]: window offset
    # where that alignment begins (free leading text = semi-global in text).
    D0 = jnp.zeros((W, C), dtype=jnp.int32)
    S0 = jnp.broadcast_to(d_off[:, None], (W, C)).astype(jnp.int32)
    best0 = jnp.full(C, INF, dtype=jnp.int32)
    bbeg0 = jnp.zeros(C, dtype=jnp.int32)
    bend0 = jnp.zeros(C, dtype=jnp.int32)

    def shift_up(a, fill):     # a[d] <- a[d+1]
        return jnp.concatenate([a[1:], jnp.full((1, C), fill, a.dtype)], axis=0)

    def shift_down(a, k, fill):
        return jnp.concatenate([jnp.full((k, C), fill, a.dtype), a[:-k]], axis=0)

    def step(j, carry):
        D, S, best, bbeg, bend = carry
        wchars = jax.lax.dynamic_slice_in_dim(wT, j, W, axis=0)        # (W, C)
        rchar = jax.lax.dynamic_slice_in_dim(rT, j, 1, axis=0)         # (1, C)
        sub = ((rchar != wchars) | (rchar >= 4) | (wchars >= 4)).astype(jnp.int32)

        diag = D + sub
        up_D = shift_up(D, INF) + 1            # read-gap (deletion in read)
        up_S = shift_up(S, 0)
        take_up = up_D < diag
        nD = jnp.where(take_up, up_D, diag)
        nS = jnp.where(take_up, up_S, S)
        # in-row insertion dependency: nD[d] = min_{d'<=d} nD[d'] + (d-d'),
        # resolved as a min-plus prefix scan by doubling along the band axis.
        k = 1
        while k < W:
            cand = shift_down(nD, k, INF) + k
            candS = shift_down(nS, k, 0)
            take = cand < nD
            nD = jnp.where(take, cand, nD)
            nS = jnp.where(take, candS, nS)
            k *= 2

        done = (j + 1) == lengths                                      # (C,)
        row_best = jnp.min(nD, axis=0)
        d_best = jnp.argmin(nD, axis=0).astype(jnp.int32)              # smallest d wins ties
        s_best = jnp.take_along_axis(nS, d_best[None, :], axis=0)[0]
        best = jnp.where(done, row_best, best)
        bbeg = jnp.where(done, anchors - E + s_best, bbeg)
        bend = jnp.where(done, anchors - E + (j + 1) + d_best, bend)
        return nD, nS, best, bbeg, bend

    _, _, best, bbeg, bend = jax.lax.fori_loop(
        0, L, step, (D0, S0, best0, bbeg0, bend0))
    return best, bbeg, bend
