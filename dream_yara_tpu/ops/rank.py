"""Batched FM rank queries — the innermost device op of seed search.

Reference analog: SeqAn rank-dictionary getRank inside backward search
(HOT LOOP 2 in SURVEY.md §3.1). Design: a rank query is ONE row
gather from the (n_blocks, 128) int8 BWT block matrix plus one row gather from
the occ checkpoint table, then a 128-char compare-and-count in vector code — no
data-dependent branching, fully batched over queries.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..index.fmindex import BLOCK

_LOG2_BLOCK = 7
assert BLOCK == 1 << _LOG2_BLOCK


def rank(bwt_blocks: jnp.ndarray, occ: jnp.ndarray,
         c: jnp.ndarray, i: jnp.ndarray) -> jnp.ndarray:
    """occurrences of symbol c[q] in bwt[0 : i[q]) for each query q.

    bwt_blocks: (n_blocks, 128) int8; occ: (n_blocks+1, SIGMA) int32;
    c, i: (Q,) int32. Returns (Q,) int32.
    """
    b = i >> _LOG2_BLOCK
    r = i & (BLOCK - 1)
    rows = jnp.take(bwt_blocks, b, axis=0)              # (Q, 128)
    base = jnp.take(occ, b, axis=0)                     # (Q, SIGMA)
    base = jnp.take_along_axis(base, c[:, None], axis=1)[:, 0]
    pos = jnp.arange(BLOCK, dtype=jnp.int32)
    within = ((rows == c[:, None].astype(jnp.int8)) &
              (pos[None, :] < r[:, None])).sum(axis=1, dtype=jnp.int32)
    return base + within


def lf_step(bwt_blocks, occ, counts, c, i):
    """LF mapping: row of the suffix preceded by c: counts[c] + rank(c, i)."""
    return jnp.take(counts, c) + rank(bwt_blocks, occ, c, i)


def build_fused_rank_rows(bwt_blocks: "np.ndarray", occ: "np.ndarray"):
    """Host-side: fuse occ checkpoints + 4-bit-packed BWT chars into one
    int32 row per block: cols 0..5 = occ counts, cols 6..21 = 128 chars
    (8 per word, low nibble first), cols 22..23 pad.

    Rationale: the plain rank issues THREE gathers per query (bwt row, occ row, take_along on the occ row). One fused row
    serves the whole query; the occ column select becomes compare-selects.
    """
    import numpy as np

    nb = bwt_blocks.shape[0]
    fused = np.zeros((nb + 1, 24), dtype=np.int32)
    fused[: occ.shape[0], :6] = occ[: nb + 1]
    if occ.shape[0] < nb + 1:
        fused[occ.shape[0] :, :6] = occ[-1]
    chars = bwt_blocks.astype(np.uint32).reshape(nb, 16, 8)
    shifts = (np.arange(8, dtype=np.uint32) * 4)[None, None, :]
    words = (chars << shifts).sum(axis=2, dtype=np.uint32)
    fused[:nb, 6:22] = words.astype(np.int32, casting="unsafe")
    # pad block decodes to char 0; rank beyond n never consults it in-block
    return fused


def rank_fused(fused: jnp.ndarray, c: jnp.ndarray, i: jnp.ndarray,
               row_fetch=None) -> jnp.ndarray:
    """rank via ONE row gather from the fused table (see build_fused_rank_rows).

    `row_fetch(b) -> (Q, 24)` overrides the local table gather — the
    mesh-sharded big-bin path (parallel/sharded_fm.py) fetches rows from the
    owning shard via masked local gather + psum over the shard axis."""
    b = i >> _LOG2_BLOCK
    r = i & (BLOCK - 1)
    row = (jnp.take(fused, b, axis=0) if row_fetch is None
           else row_fetch(b))                           # (Q, 24) — one gather
    return rank_fused_rows(row, c, r)


def rank_fused_rows(row: jnp.ndarray, c: jnp.ndarray, r: jnp.ndarray) -> jnp.ndarray:
    """Decode fused rank rows: row (Q, 24), symbol c (Q,), in-block pos r (Q,)."""
    base = jnp.zeros(c.shape, dtype=jnp.int32)
    for j in range(6):
        base = base + jnp.where(c == j, row[:, j], 0)
    words = row[:, 6:22].astype(jnp.uint32)             # (Q, 16)
    nib = (jnp.arange(8, dtype=jnp.uint32) * 4)[None, None, :]
    chars = ((words[:, :, None] >> nib) & 7).reshape(c.shape[0], BLOCK)
    pos = jnp.arange(BLOCK, dtype=jnp.int32)
    within = ((chars == c[:, None].astype(jnp.uint32)) &
              (pos[None, :] < r[:, None])).sum(axis=1, dtype=jnp.int32)
    return base + within


# --- all-symbol rank (bidirectional FM extension, index/bifm.py) ----------

def decode_fused_row_np(row: "np.ndarray"):
    """Host decode of ONE fused row: (occ base (SIGMA,) int32, chars (128,))."""
    import numpy as np

    base = row[:6].copy()
    words = row[6:22].astype(np.uint32)
    nib = (np.arange(8, dtype=np.uint32) * 4)[None, :]
    chars = ((words[:, None] >> nib) & 7).reshape(BLOCK)
    return base, chars


def rank_all_fused_rows(row: jnp.ndarray, r: jnp.ndarray) -> jnp.ndarray:
    """occ counts of ALL six symbols at in-block pos r: row (Q, 24) -> (Q, 6).

    Same two-gather budget as a plain rank query (the caller fetched `row`);
    the extra work is five more vector compare-counts over the decoded block —
    this is what makes bidirectional interval tracking gather-neutral."""
    words = row[:, 6:22].astype(jnp.uint32)             # (Q, 16)
    nib = (jnp.arange(8, dtype=jnp.uint32) * 4)[None, None, :]
    chars = ((words[:, :, None] >> nib) & 7).reshape(row.shape[0], BLOCK)
    pos = jnp.arange(BLOCK, dtype=jnp.int32)
    inpos = pos[None, :] < r[:, None]                   # (Q, 128)
    within = jnp.stack(
        [((chars == s) & inpos).sum(axis=1, dtype=jnp.int32)
         for s in range(6)], axis=1)                    # (Q, 6)
    return row[:, :6] + within
