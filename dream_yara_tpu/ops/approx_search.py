"""Approximate seed search (<=2 edits) — the repetitive-read path.

Reference analog: src/mapper_filter.h findSeeds<1|2> via SeqAn multiple
backtracking, driven by the read classifier (src/mapper_classifier.h [U]):
reads whose exact seeds hit too many locations are re-seeded with FEWER,
LONGER seeds searched with up to one substitution — pigeonhole still covers
the error budget (s' = ceil((E+1)/2) seeds, some seed has <= floor(E/s') <= 1
error) while long seeds collapse the hit explosion on repeats.

Lockstep backtracking: the reference's bounded DFS becomes a dense layout
enumeration — every explicit placement of <= budget edits in the seed's
matched window is one lane of a (seeds, layouts) matrix, all advanced in a
single lockstep backward loop (no data-dependent control flow). See
seed_search_edits.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .rank import rank


# --- generalized edit-layout search (findSeeds<1|2> analog) ---------------

def _layout_tables(m: int, budget: int, indels: bool):
    """Static layout metadata for seeds truncated to m chars.

    A layout is one explicit placement of edits in the matched window:
      kind 0: exact
      kind 1: substitution at p1 with replacement offset o1 in {1,2,3}
              (char = (seed[p1] + o1) % 4)
      kind 2: deletion of seed char p1 (matched text is m-1 long)
      kind 3: insertion of char c1 in {0..3} before seed position p1
              (matched text is m+1 long)
      kind 4: two substitutions p1 < p2, offsets o1, o2  [budget 2]

    The reference's findSeeds uses Hamming distance (substitutions only)
    [U]; kinds 2/3 extend it to one indel, closing the documented
    repetitive-indel sensitivity gap. Budget-2 enumerates substitution
    pairs (Hamming<=2, reference parity); indel pairs are left to the
    banded verifier's band.
    """
    import numpy as np

    kinds, p1s, a1s, p2s, a2s = [0], [0], [0], [0], [0]
    for p in range(m):
        for o in (1, 2, 3):
            kinds.append(1); p1s.append(p); a1s.append(o)
            p2s.append(0); a2s.append(0)
    if indels:
        for p in range(m):
            kinds.append(2); p1s.append(p); a1s.append(0)
            p2s.append(0); a2s.append(0)
        for p in range(1, m):          # interior gaps only
            for c in range(4):
                kinds.append(3); p1s.append(p); a1s.append(c)
                p2s.append(0); a2s.append(0)
    if budget >= 2:
        for p1 in range(m):
            for p2 in range(p1 + 1, m):
                for o1 in (1, 2, 3):
                    for o2 in (1, 2, 3):
                        kinds.append(4); p1s.append(p1); a1s.append(o1)
                        p2s.append(p2); a2s.append(o2)
    f = lambda x: np.asarray(x, dtype=np.int32)
    return f(kinds), f(p1s), f(a1s), f(p2s), f(a2s)


def seed_search_edits(bwt_blocks, occ, counts, n, reads, rows, starts, slens,
                      max_slen: int, *, budget: int = 1,
                      indels: bool = False, fused=None):
    """SA intervals of every <=budget-edit layout of each seed's last
    min(slens, max_slen) chars, all advanced in ONE lockstep backward loop.

    Lockstep: the reference's bounded DFS becomes a dense (S, NL) lane
    matrix — NL static layouts per seed, each lane's character sequence
    derived arithmetically from (kind, p1, a1, p2, a2), no data-dependent
    control flow. Truncation (max_slen ~ t_stop) is what makes NL affordable
    (budget 2: 9*C(m,2)+3m+1 lanes); truncated layouts yield superset
    intervals whose false anchors the banded verifier rejects, exactly like
    the exact path.

    Returns (lo, hi, valid, m_start): (S, NL) intervals + validity, and
    (S,) m_start = read index where each seed's matched window begins
    (anchor = text_pos - m_start; indel layouts shift text length by +-1,
    absorbed by the verifier's band).
    """
    import numpy as np

    S = rows.shape[0]
    L = reads.shape[1]
    m = int(max_slen)
    flat = reads.reshape(-1)

    kinds_np, p1_np, a1_np, p2_np, a2_np = _layout_tables(m, budget, indels)
    NL = len(kinds_np)
    kind = jnp.asarray(kinds_np)[None, :]
    p1 = jnp.asarray(p1_np)[None, :]
    a1 = jnp.asarray(a1_np)[None, :]
    p2 = jnp.asarray(p2_np)[None, :]
    a2 = jnp.asarray(a2_np)[None, :]

    eff = jnp.minimum(slens, m)                       # matched window length
    w_start = starts + slens - eff                    # window begin in read
    # layout positions are relative to the WINDOW (0 = window start)
    lane_len = eff[:, None] + jnp.where(kind == 2, -1,
                                        jnp.where(kind == 3, 1, 0))
    # layouts whose edit positions fall outside a short window are
    # duplicates of smaller layouts — mask them (p >= eff)
    lvalid = ((slens > 0)[:, None]
              & (p1 < jnp.maximum(eff[:, None], 1))
              & ((kind != 4) | (p2 < eff[:, None]))
              & ((kind != 3) | (p1 < eff[:, None])))  # gap strictly interior

    lo = jnp.zeros((S, NL), dtype=jnp.int32)
    hi = jnp.where(lvalid, jnp.full((S, NL), n, dtype=jnp.int32), 0)

    def step(t, carry):
        lo, hi = carry
        active = t < lane_len                          # (S, NL)
        # window-relative read index consumed at step t, per lane kind:
        #   exact/sub: eff-1-t
        #   del at p1: skip p1 -> idx = eff-1-t for t < eff-1-p1 else eff-2-t
        #   ins at p1: idx = eff-1-t for t < eff-p1; t == eff-p1 consumes the
        #              inserted char; later steps idx = eff-t
        base = eff[:, None] - 1 - t
        idx = jnp.where(kind == 2,
                        jnp.where(t < eff[:, None] - 1 - p1, base, base - 1),
                        jnp.where(kind == 3,
                                  jnp.where(t < eff[:, None] - p1, base,
                                            base + 1),
                                  base))
        is_ins_step = (kind == 3) & (t == eff[:, None] - p1)
        ridx = w_start[:, None] + idx
        c = jnp.take(flat, rows[:, None] * L
                     + jnp.clip(ridx, 0, L - 1)).astype(jnp.int32)
        # substitutions only replace real ACGT chars (N stays literal, as
        # in the exact path; the layout then degenerates to a duplicate of
        # the exact layout — harmless)
        acgt = c < 4
        c = jnp.where((kind == 1) & (idx == p1) & acgt, (c + a1) % 4, c)
        c = jnp.where((kind == 4) & (idx == p1) & acgt, (c + a1) % 4, c)
        c = jnp.where((kind == 4) & (idx == p2) & acgt, (c + a2) % 4, c)
        c = jnp.where(is_ins_step, a1, c)

        cf = c.reshape(-1)
        lof = lo.reshape(-1)
        hif = hi.reshape(-1)
        bounds = jnp.concatenate([lof, hif])
        if fused is not None:
            from .rank import rank_fused
            ranks = rank_fused(fused, jnp.tile(cf, 2), bounds)
        else:
            ranks = rank(bwt_blocks, occ, jnp.tile(cf, 2), bounds)
        cc = jnp.take(counts, cf)
        Q = S * NL
        nlo = (cc + ranks[:Q]).reshape(S, NL)
        nhi = (cc + ranks[Q:]).reshape(S, NL)
        upd = active & (lo < hi)
        return jnp.where(upd, nlo, lo), jnp.where(upd, nhi, hi)

    lo, hi = jax.lax.fori_loop(0, m + (1 if indels else 0), step, (lo, hi))
    hi = jnp.maximum(lo, hi)
    valid = lvalid & (lo < hi) & (lane_len > 0)
    return lo, hi, valid, w_start
