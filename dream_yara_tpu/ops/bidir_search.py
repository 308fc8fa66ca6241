"""Search-scheme approximate seed search on the bidirectional FM-index.

Reference analog: SeqAn's bidirectional index search (optimum search
schemes, Kianfar et al.; `find(bidirIter, pattern, errors)` [U]) — the
"bidirectional, SeqAn-style" half of the north-star's per-bin index. The
unidirectional dense enumeration (ops/approx_search.seed_search_edits)
walks EVERY error layout over the full window; schemes instead walk each
scheme's exact part ONCE per seed and fork error-layout lanes only over
the remaining parts, and the middle-exact scheme (one error on each side
of an exact core) is unreachable without extend_right at all.

Shape: each scheme is a pair of lockstep fori_loops — a shared
phase over (S,) states for the exact part, then a lane phase over
(S, NL_scheme) states — no data-dependent control flow, mirroring
seed_search_edits' dense style.  Bidirectional state (l, h, lr, hr) costs
the same TWO row gathers per step as a plain rank query (fused rows carry
all-symbol occ; ops/rank.rank_all_fused_rows), so the saving is real:
for budget 2 at m=18 the schemes issue ~1.6x fewer gather-pairs per seed
than the 1432-lane enumeration.

Coverage (Hamming, reference findSeeds parity — substitutions only):
  budget 1, parts A=[0,hm) B=[hm,m):
    S1  B exact (backward, shared) -> 1 sub in A        covers (1,0)
    S2  A exact (forward, shared)  -> <=1 sub in B      covers (0,0),(0,1)
  budget 2, parts A=[0,am) B=[am,bm) C=[bm,m):
    S1  C exact -> <=2 subs in A+B (backward)           covers (*,*,0)
    S2  A exact -> subs in B+C, >=1 in C (forward)      covers (0,*,>=1)
    S3  B exact -> exactly 1 sub in A, then 1 in C      covers (1,0,1)
  Every distribution of <=budget errors over the parts is covered exactly
  once — the lane tables are disjoint by construction, so no duplicate
  intervals are emitted beyond what enumeration itself would.

Uniform-window contract: lanes are laid out on the m-grid (am, bm static),
so only seeds whose matched window is exactly m chars (eff == m) are
searched; shorter seeds come out invalid.  The caller selects this backend
only when every seed window is full-length (fixed-length read batches —
the product case); ragged batches keep the enumeration backend.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .rank import rank_fused  # noqa: F401
from ..index.fmindex import BLOCK

_LOG2_BLOCK = 7


def _ext_core(fused, counts, lo, hi, c):
    """Shared core: new (lo, hi) for symbol c plus the smaller-symbol
    occ delta between the two rows.

    Cost parity with a plain rank step: ONE fused row gather over the
    concatenated (lo, hi) queries, and per row just TWO compare-counts
    over the decoded block (== c for the interval, < c for the reverse
    realignment) — the first cut computed all six symbols' occ (6
    compare-counts), which threw away the step-count advantage over
    enumeration; this version keeps it. BWT pad decodes to 7,
    which is neither == nor < any real symbol code."""
    shape = lo.shape
    cf = c.reshape(-1)
    Q = cf.shape[0]
    bounds = jnp.concatenate([lo.reshape(-1), hi.reshape(-1)])
    row = jnp.take(fused, bounds >> _LOG2_BLOCK, axis=0)   # (2Q, 24) 1 gather
    r = bounds & 127
    c2 = jnp.tile(cf, 2)
    words = row[:, 6:22].astype(jnp.uint32)                # (2Q, 16)
    nib = (jnp.arange(8, dtype=jnp.uint32) * 4)[None, None, :]
    chars = ((words[:, :, None] >> nib) & 7).reshape(2 * Q, BLOCK)
    inpos = jnp.arange(BLOCK, dtype=jnp.int32)[None, :] < r[:, None]
    cc = c2[:, None].astype(jnp.uint32)
    occ_c = ((chars == cc) & inpos).sum(axis=1, dtype=jnp.int32)
    occ_lt = ((chars < cc) & inpos).sum(axis=1, dtype=jnp.int32)
    base_c = jnp.zeros(2 * Q, jnp.int32)
    base_lt = jnp.zeros(2 * Q, jnp.int32)
    for j in range(6):
        base_c = base_c + jnp.where(c2 == j, row[:, j], 0)
        base_lt = base_lt + jnp.where(c2 > j, row[:, j], 0)
    rank_c = base_c + occ_c
    rank_lt = base_lt + occ_lt
    cbase = jnp.take(counts, cf)
    nlo = cbase + rank_c[:Q]
    nhi = cbase + rank_c[Q:]
    less = rank_lt[Q:] - rank_lt[:Q]
    return nlo.reshape(shape), nhi.reshape(shape), less.reshape(shape)


def extend_left(fused, counts, l, h, lr, hr, c):
    """Batched bidirectional extendLeft (index/bifm.py semantics)."""
    nl, nh, less = _ext_core(fused, counts, l, h, c)
    nlr = lr + less
    return nl, nh, nlr, nlr + (nh - nl)


def extend_right(rfused, rcounts, l, h, lr, hr, c):
    """Batched bidirectional extendRight via the reverse-text rank rows."""
    nlr, nhr, less = _ext_core(rfused, rcounts, lr, hr, c)
    nl = l + less
    return nl, nl + (nhr - nlr), nlr, nhr


def _sub_tables_budget2(m: int):
    """Static lane tables on the m-grid. Returns per-scheme numpy arrays."""
    am, bm = m // 3, (2 * m) // 3
    # S1: <=2 subs in [0, bm)
    p1, o1, p2, o2 = [0], [0], [0], [0]          # exact lane
    for p in range(bm):
        for o in (1, 2, 3):
            p1.append(p); o1.append(o); p2.append(p); o2.append(0)
    for a in range(bm):
        for b in range(a + 1, bm):
            for oa in (1, 2, 3):
                for ob in (1, 2, 3):
                    p1.append(a); o1.append(oa); p2.append(b); o2.append(ob)
    s1 = tuple(np.asarray(x, np.int32) for x in (p1, o1, p2, o2))
    # S2: subs in [am, m), p2 in [bm, m) (>=1 in C); singles are (p,p)
    p1, o1, p2, o2 = [], [], [], []
    for p in range(bm, m):
        for o in (1, 2, 3):
            p1.append(p); o1.append(o); p2.append(p); o2.append(0)
    for a in range(am, m):
        for b in range(max(a + 1, bm), m):
            for oa in (1, 2, 3):
                for ob in (1, 2, 3):
                    p1.append(a); o1.append(oa); p2.append(b); o2.append(ob)
    s2 = tuple(np.asarray(x, np.int32) for x in (p1, o1, p2, o2))
    # S3: one sub in A (pa, oa) x one sub in C (pc, oc)
    pa, oa = [], []
    for p in range(am):
        for o in (1, 2, 3):
            pa.append(p); oa.append(o)
    pc, oc = [], []
    for p in range(bm, m):
        for o in (1, 2, 3):
            pc.append(p); oc.append(o)
    s3a = (np.asarray(pa, np.int32), np.asarray(oa, np.int32))
    s3c = (np.asarray(pc, np.int32), np.asarray(oc, np.int32))
    return am, bm, s1, s2, s3a, s3c


def _sub_tables_budget1(m: int):
    hm = m // 2
    p1, o1 = [], []
    for p in range(hm):
        for o in (1, 2, 3):
            p1.append(p); o1.append(o)
    s1 = (np.asarray(p1, np.int32), np.asarray(o1, np.int32))
    p2, o2 = [0], [0]                            # exact lane
    for p in range(hm, m):
        for o in (1, 2, 3):
            p2.append(p); o2.append(o)
    s2 = (np.asarray(p2, np.int32), np.asarray(o2, np.int32))
    return hm, s1, s2


def bidir_seed_search(fused, counts, rfused, rcounts, n, reads, rows,
                      starts, slens, max_slen: int, *, budget: int = 1):
    """SA intervals (FORWARD index) of every <=budget-substitution layout
    of each seed's last `max_slen` chars, via shared-prefix search schemes.

    Same contract as approx_search.seed_search_edits (Hamming kinds):
    returns (lo, hi, valid, w_start) with lo/hi (S, NL_total) int32.
    Seeds whose window is shorter than max_slen come out invalid — the
    caller guarantees full windows when selecting this backend.
    """
    S = rows.shape[0]
    L = reads.shape[1]
    m = int(max_slen)
    flat = reads.reshape(-1)
    full = (slens >= m)                                   # (S,) uniform gate
    w_start = starts + slens - jnp.minimum(slens, m)

    def wchar(pos):
        """Window char at window position `pos` (may be (S,) or (S, NL))."""
        ridx = (w_start[:, None] + pos) if pos.ndim == 2 else (w_start + pos)
        if pos.ndim == 1:
            g = rows * L + jnp.clip(ridx, 0, L - 1)
        else:
            g = rows[:, None] * L + jnp.clip(ridx, 0, L - 1)
        return jnp.take(flat, g).astype(jnp.int32)

    def subbed(c, pos, p, off):
        """Apply substitution offset `off` where pos == p (ACGT only)."""
        return jnp.where((pos == p) & (c < 4), (c + off) % 4, c)

    nfull = jnp.asarray(n, jnp.int32)
    init = lambda shape: (jnp.zeros(shape, jnp.int32),
                          jnp.where(jnp.broadcast_to(full if len(shape) == 1
                                                     else full[:, None],
                                    shape), nfull, 0).astype(jnp.int32))

    def back_walk(lo, hi, steps, posfn, charfn):
        """Backward (extend-left, forward-interval-only) lockstep walk."""
        def step(t, carry):
            lo, hi = carry
            pos = posfn(t)
            c = charfn(t, pos)
            bounds = jnp.concatenate([lo.reshape(-1), hi.reshape(-1)])
            cf = c.reshape(-1)
            ranks = rank_fused(fused, jnp.tile(cf, 2), bounds)
            Q = cf.shape[0]
            cc = jnp.take(counts, cf)
            nlo = (cc + ranks[:Q]).reshape(lo.shape)
            nhi = (cc + ranks[Q:]).reshape(lo.shape)
            upd = (pos >= 0) & (lo < hi)
            return jnp.where(upd, nlo, lo), jnp.where(upd, nhi, hi)
        return jax.lax.fori_loop(0, steps, step, (lo, hi))

    def bi_walk(state, steps, posfn, charfn, direction):
        """Bidirectional lockstep walk keeping (l, h, lr, hr) in sync."""
        ext = extend_left if direction == "left" else extend_right
        tabs = ((fused, counts) if direction == "left"
                else (rfused, rcounts))
        def step(t, st):
            l, h, lr, hr = st
            pos = posfn(t)
            c = charfn(t, pos)
            nl, nh, nlr, nhr = ext(tabs[0], tabs[1], l, h, lr, hr, c)
            upd = (pos >= 0) & (l < h)
            return (jnp.where(upd, nl, l), jnp.where(upd, nh, h),
                    jnp.where(upd, nlr, lr), jnp.where(upd, nhr, hr))
        return jax.lax.fori_loop(0, steps, step, state)

    outs = []
    if budget == 1:
        hm, (p1, o1), (p2, o2) = _sub_tables_budget1(m)
        # --- S1: shared backward walk of B=[hm, m), then 1 sub in A ------
        slo, shi = init((S,))
        slo, shi = back_walk(slo, shi, m - hm,
                             lambda t: jnp.where(full, m - 1 - t, -1),
                             lambda t, pos: wchar(pos))
        NL1 = len(p1)
        P1 = jnp.asarray(p1)[None, :]
        O1 = jnp.asarray(o1)[None, :]
        llo = jnp.broadcast_to(slo[:, None], (S, NL1))
        lhi = jnp.broadcast_to(shi[:, None], (S, NL1))
        llo, lhi = back_walk(
            llo, lhi, hm,
            lambda t: jnp.where(full[:, None], hm - 1 - t,
                                -1) * jnp.ones((1, NL1), jnp.int32),
            lambda t, pos: subbed(wchar(pos), pos, P1, O1))
        outs.append((llo, lhi, jnp.broadcast_to(full[:, None], (S, NL1))))
        # --- S2: shared forward walk of A=[0, hm), then <=1 sub in B -----
        l0, h0 = init((S,))
        st = bi_walk((l0, h0, l0, h0), hm,
                     lambda t: jnp.where(full, t, -1),
                     lambda t, pos: wchar(pos), "right")
        NL2 = len(p2)
        P2 = jnp.asarray(p2)[None, :]
        O2 = jnp.asarray(o2)[None, :]
        lst = tuple(jnp.broadcast_to(x[:, None], (S, NL2)) for x in st)
        lst = bi_walk(lst, m - hm,
                      lambda t: jnp.where(full[:, None], hm + t,
                                          -1) * jnp.ones((1, NL2), jnp.int32),
                      lambda t, pos: subbed(wchar(pos), pos, P2, O2),
                      "right")
        outs.append((lst[0], lst[1],
                     jnp.broadcast_to(full[:, None], (S, NL2))))
    elif budget == 2:
        am, bm, s1, s2, (pa, oa), (pc, oc) = _sub_tables_budget2(m)
        # --- S1: shared backward C=[bm, m), then <=2 subs in [0, bm) -----
        slo, shi = init((S,))
        slo, shi = back_walk(slo, shi, m - bm,
                             lambda t: jnp.where(full, m - 1 - t, -1),
                             lambda t, pos: wchar(pos))
        NL1 = len(s1[0])
        P1a = jnp.asarray(s1[0])[None, :]
        O1a = jnp.asarray(s1[1])[None, :]
        P1b = jnp.asarray(s1[2])[None, :]
        O1b = jnp.asarray(s1[3])[None, :]
        llo = jnp.broadcast_to(slo[:, None], (S, NL1))
        lhi = jnp.broadcast_to(shi[:, None], (S, NL1))
        llo, lhi = back_walk(
            llo, lhi, bm,
            lambda t: jnp.where(full[:, None], bm - 1 - t,
                                -1) * jnp.ones((1, NL1), jnp.int32),
            lambda t, pos: subbed(subbed(wchar(pos), pos, P1a, O1a),
                                  pos, P1b, O1b))
        outs.append((llo, lhi, jnp.broadcast_to(full[:, None], (S, NL1))))
        # --- S2: shared forward A=[0, am), subs in [am, m), >=1 in C -----
        l0, h0 = init((S,))
        st = bi_walk((l0, h0, l0, h0), am,
                     lambda t: jnp.where(full, t, -1),
                     lambda t, pos: wchar(pos), "right")
        NL2 = len(s2[0])
        P2a = jnp.asarray(s2[0])[None, :]
        O2a = jnp.asarray(s2[1])[None, :]
        P2b = jnp.asarray(s2[2])[None, :]
        O2b = jnp.asarray(s2[3])[None, :]
        lst = tuple(jnp.broadcast_to(x[:, None], (S, NL2)) for x in st)
        lst = bi_walk(lst, m - am,
                      lambda t: jnp.where(full[:, None], am + t,
                                          -1) * jnp.ones((1, NL2), jnp.int32),
                      lambda t, pos: subbed(subbed(wchar(pos), pos, P2a, O2a),
                                            pos, P2b, O2b),
                      "right")
        outs.append((lst[0], lst[1],
                     jnp.broadcast_to(full[:, None], (S, NL2))))
        # --- S3: shared left walk of B=[am, bm); 1 sub in A; 1 sub in C --
        l0, h0 = init((S,))
        st = bi_walk((l0, h0, l0, h0), bm - am,
                     lambda t: jnp.where(full, bm - 1 - t, -1),
                     lambda t, pos: wchar(pos), "left")
        NA = len(pa)
        PA = jnp.asarray(pa)[None, :]
        OA = jnp.asarray(oa)[None, :]
        ast = tuple(jnp.broadcast_to(x[:, None], (S, NA)) for x in st)
        ast = bi_walk(ast, am,
                      lambda t: jnp.where(full[:, None], am - 1 - t,
                                          -1) * jnp.ones((1, NA), jnp.int32),
                      lambda t, pos: subbed(wchar(pos), pos, PA, OA),
                      "left")
        NC = len(pc)
        PC = jnp.asarray(pc)[None, None, :]
        OC = jnp.asarray(oc)[None, None, :]
        cst = tuple(jnp.broadcast_to(x[:, :, None],
                                     (S, NA, NC)).reshape(S, NA * NC)
                    for x in ast)
        PCf = jnp.broadcast_to(PC, (1, NA, NC)).reshape(1, NA * NC)
        OCf = jnp.broadcast_to(OC, (1, NA, NC)).reshape(1, NA * NC)
        cst = bi_walk(cst, m - bm,
                      lambda t: jnp.where(full[:, None], bm + t, -1)
                      * jnp.ones((1, NA * NC), jnp.int32),
                      lambda t, pos: subbed(wchar(pos), pos, PCf, OCf),
                      "right")
        outs.append((cst[0], cst[1],
                     jnp.broadcast_to(full[:, None], (S, NA * NC))))
    else:
        raise ValueError(f"budget {budget} not supported (1 or 2)")

    lo = jnp.concatenate([o[0] for o in outs], axis=1)
    hi = jnp.concatenate([o[1] for o in outs], axis=1)
    lvalid = jnp.concatenate([o[2] for o in outs], axis=1)
    hi = jnp.maximum(lo, hi)
    valid = lvalid & (lo < hi) & (slens > 0)[:, None]
    return lo, hi, valid, w_start
