"""Bidirectional FM-index — synchronized forward/reverse intervals.

Reference analog: the SeqAn-style bidirectional FM-index named by the
project north-star ("per-bin FM-index (bidirectional, SeqAn-style)
exact/approximate seed search", BASELINE.json:north_star); in SeqAn it is
`Index<T, BidirectionalIndex<FMIndex<>>>` with `extendLeft`/`extendRight`
iterators (include/seqan/index/index_bifm.h [U]).

Design (Lam et al. 2009 / SeqAn): keep TWO rank structures — the forward
text's (already built for every bin) and the REVERSED text's — and track a
pattern P as a 4-tuple (l, h, lr, hr): (l, h) = SA-interval of P in the
forward index, (lr, hr) = SA-interval of reverse(P) in the reverse index,
always with h - l == hr - lr (occurrence counts of P in T and of rev(P) in
rev(T) are equal).  Extending P by one char on the LEFT is a plain backward
step on the forward index; the reverse interval is realigned with the
smaller-symbol occ delta:

    extend_left(c):  l'  = C[c] + Occ(c, l)        (forward index)
                     h'  = C[c] + Occ(c, h)
                     lr' = lr + sum_{b<c} (Occ(b, h) - Occ(b, l))
                     hr' = lr' + (h' - l')

extend_right is the mirror image on the reverse index.  The smaller-symbol
sum uses the CODE order (A,C,G,T,N,$ = 0..5) because that is the order the
suffix array sorts by.

Cost model: one extension needs occ counts for ALL six symbols at
two rows — which the fused rank-row layout (ops/rank.py
build_fused_rank_rows) already delivers in the SAME two row gathers a plain
rank query pays.  Bidirectional state is therefore gather-neutral; only the
in-block vector compare-count runs per-symbol.  The payoff is the search-scheme
approximate seed search (ops/bidir_search.py): the exact scheme part is
walked ONCE per seed and shared by every error-layout lane, and the
middle-part scheme (error left AND right of an exact core) is impossible
unidirectionally.

The reverse structure stores only fused rank rows + C table (~0.75 B/char):
locate always happens through the forward index's SA, so the reverse SA is
discarded after its BWT is built.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..utils.alphabet import SENTINEL, SIGMA
from .fmindex import BLOCK, FMIndex


def build_reverse_fused(text: np.ndarray,
                        tmp_dir: str | None = None
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Fused rank rows + C table of reverse(text).

    Returns (rfused (n_blocks+1, 24) int32, rcounts (SIGMA+1,) int32).
    The C table of the reversed text equals the forward one (same symbol
    multiset), but is returned explicitly to keep callers honest.
    """
    from ..ops.rank import build_fused_rank_rows

    text = np.asarray(text, dtype=np.int8)
    if len(text) == 0 or text[-1] != SENTINEL:
        raise ValueError("reverse index expects sentinel-terminated FM text")
    # Reverse the text BODY and re-terminate: rev(T) itself would start with
    # the sentinel and end without one, breaking the BWT wrap convention
    # (the sa==0 row's BWT char must be the terminator, not a real base) —
    # that produced phantom occurrences in backward steps.  With this
    # layout, "char preceding rev(P)" in the reverse index is exactly
    # "char following P" in the forward text, with contig ends mapping to
    # the sentinel in BOTH directions — the extend_left/extend_right
    # realignment sums rely on that correspondence.
    rtext = np.empty_like(text)
    rtext[:-1] = text[:-1][::-1]
    rtext[-1] = SENTINEL
    # prefix_q=2 keeps the throwaway prefix table negligible; the reverse
    # SA itself is dropped — only the BWT-derived rank rows survive.
    rfm = FMIndex.build(rtext, sample_rate=1, tmp_dir=tmp_dir, prefix_q=2)
    return build_fused_rank_rows(rfm.bwt_blocks, rfm.occ), rfm.counts.copy()


@dataclass
class BiFMIndex:
    """Forward FMIndex (with SA — locate runs here) + reverse rank rows."""

    fm: FMIndex
    rfused: np.ndarray      # (n_blocks + 1, 24) int32 fused rows of rev text
    rcounts: np.ndarray     # (SIGMA + 1,) int32

    @classmethod
    def build(cls, text: np.ndarray, **fm_kwargs) -> "BiFMIndex":
        fm = FMIndex.build(text, **fm_kwargs)
        rfused, rcounts = build_reverse_fused(
            text, tmp_dir=fm_kwargs.get("tmp_dir"))
        return cls(fm=fm, rfused=rfused, rcounts=rcounts)

    @classmethod
    def from_fm(cls, fm: FMIndex, text: np.ndarray,
                tmp_dir: str | None = None) -> "BiFMIndex":
        rfused, rcounts = build_reverse_fused(text, tmp_dir=tmp_dir)
        return cls(fm=fm, rfused=rfused, rcounts=rcounts)

    # --- host reference ops (NumPy oracle for the JAX path) --------------

    def start(self) -> tuple[int, int, int, int]:
        """State of the empty pattern: full range in both indexes."""
        return 0, self.fm.n, 0, self.fm.n

    def _occ_all_fwd(self, i: int) -> np.ndarray:
        return np.array([self.fm._rank_np(c, np.array([i]))[0]
                         for c in range(SIGMA)], dtype=np.int64)

    def _occ_all_rev(self, i: int) -> np.ndarray:
        from ..ops.rank import decode_fused_row_np

        b, r = i // BLOCK, i % BLOCK
        base, chars = decode_fused_row_np(self.rfused[b])
        within = np.array([(chars[:r] == c).sum() for c in range(SIGMA)])
        return base.astype(np.int64) + within

    def extend_left(self, state, c: int):
        l, h, lr, hr = state
        ol, oh = self._occ_all_fwd(l), self._occ_all_fwd(h)
        nl = int(self.fm.counts[c] + ol[c])
        nh = int(self.fm.counts[c] + oh[c])
        nlr = int(lr + (oh[:c] - ol[:c]).sum())
        return nl, nh, nlr, nlr + (nh - nl)

    def extend_right(self, state, c: int):
        l, h, lr, hr = state
        ol, oh = self._occ_all_rev(lr), self._occ_all_rev(hr)
        nlr = int(self.rcounts[c] + ol[c])
        nhr = int(self.rcounts[c] + oh[c])
        nl = int(l + (oh[:c] - ol[:c]).sum())
        return nl, nl + (nhr - nlr), nlr, nhr

    def search(self, pattern: np.ndarray, order: str = "left") -> tuple:
        """Match `pattern` one char at a time; order 'left' consumes it
        right-to-left via extend_left, 'right' left-to-right via
        extend_right. Returns the final (l, h, lr, hr)."""
        st = self.start()
        if order == "left":
            for c in pattern[::-1]:
                st = self.extend_left(st, int(c))
                if st[0] >= st[1]:
                    break
        else:
            for c in pattern:
                st = self.extend_right(st, int(c))
                if st[0] >= st[1]:
                    break
        return st

    # --- persistence (sidecar next to the forward .fm.npz) ---------------

    @staticmethod
    def sidecar_path(fm_path) -> Path:
        p = Path(fm_path)
        name = p.name
        if name.endswith(".fm.npz"):
            name = name[: -len(".fm.npz")] + ".rfm.npz"
        else:
            name = p.stem + ".rfm.npz"
        return p.with_name(name)

    def save(self, fm_path) -> None:
        """Save the forward index to fm_path and the reverse rank rows to
        the `.rfm.npz` sidecar the mapper probes for."""
        self.fm.save(fm_path)
        np.savez(self.sidecar_path(fm_path), rfused=self.rfused,
                 rcounts=self.rcounts)

    @classmethod
    def load(cls, fm_path) -> "BiFMIndex":
        fm = FMIndex.load(fm_path)
        z = np.load(cls.sidecar_path(fm_path))
        return cls(fm=fm, rfused=z["rfused"], rcounts=z["rcounts"])
