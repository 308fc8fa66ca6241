"""Device-resident index containers (pytrees of jnp arrays).

One DeviceFM per bin; DeviceFMSet stacks B bins with per-bin padding so the
whole database is a single pytree whose leading axis can be sharded over the
mesh 'bin' axis (SURVEY.md §2.10 "database/bin parallelism").
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..index.fmindex import BLOCK, BWT_PAD, FMIndex


class DeviceFM(NamedTuple):
    """FM-index + text of one bin, device layout (see index/fmindex.py)."""

    bwt_blocks: jnp.ndarray  # (n_blocks, 128) int8
    occ: jnp.ndarray         # (n_blocks + 1, SIGMA) int32
    counts: jnp.ndarray      # (SIGMA + 1,) int32
    sa: jnp.ndarray          # (n,) int32 (full SA; sampled mode adds fields later)
    text: jnp.ndarray        # (n,) int8 — verification windows gather from this
    n: jnp.ndarray           # () int32 text length
    pfx_lo: jnp.ndarray | None = None  # (4^q,) int32 q-mer interval table
    pfx_hi: jnp.ndarray | None = None
    # sampled-SA mode (sample_rate > 1): `sa` holds only the sampled values;
    # locate walks LF to a marked row (ops/locate.py). Packed layout costs
    # ~n/6 bytes vs 4n for the full SA (the HBM lever for big bins, §5.7).
    sa_mark_bits: jnp.ndarray | None = None  # (ceil(n/32),) uint32 mark bitmap
    sa_rank_ck: jnp.ndarray | None = None    # (ceil(n/128)+1,) int32 mark-rank checkpoints
    fused: jnp.ndarray | None = None         # (n_blocks+1, 24) int32 fused rank rows
    # bidirectional mode (index/bifm.py): fused rank rows of the REVERSED
    # text. The reverse C table equals `counts` (same symbol multiset), so
    # only the rows ship. Enables the search-scheme approximate seed
    # backend (ops/bidir_search.py).
    rfused: jnp.ndarray | None = None        # (n_blocks+1, 24) int32

    @classmethod
    def from_host(cls, fm: FMIndex, text: np.ndarray,
                  rfused: np.ndarray | None = None) -> "DeviceFM":
        from .rank import build_fused_rank_rows
        mark_bits = rank_ck = None
        if fm.sample_rate > 1:
            # host FMIndex stores the packed device layout directly
            mark_bits, rank_ck = fm.sa_mark_bits, fm.sa_rank_ck
        return cls(
            bwt_blocks=jnp.asarray(fm.bwt_blocks),
            occ=jnp.asarray(fm.occ),
            counts=jnp.asarray(fm.counts),
            sa=jnp.asarray(fm.sa),
            text=jnp.asarray(text, dtype=jnp.int8),
            n=jnp.asarray(fm.n, dtype=jnp.int32),
            pfx_lo=None if fm.pfx_lo is None else jnp.asarray(fm.pfx_lo),
            pfx_hi=None if fm.pfx_hi is None else jnp.asarray(fm.pfx_hi),
            sa_mark_bits=None if mark_bits is None else jnp.asarray(mark_bits),
            sa_rank_ck=None if rank_ck is None else jnp.asarray(rank_ck),
            fused=jnp.asarray(build_fused_rank_rows(fm.bwt_blocks, fm.occ)),
            rfused=None if rfused is None else jnp.asarray(rfused),
        )


class DeviceFMSet(NamedTuple):
    """B bins stacked with padding to the largest bin; axis 0 is shardable.

    Padding convention: bwt blocks padded with BWT_PAD, occ rows repeat the
    final checkpoint (rank beyond n is constant), sa/text padded with 0 /
    BWT_PAD, `n` carries each bin's true length so searches stay exact.
    """

    bwt_blocks: jnp.ndarray  # (B, max_blocks, 128) int8
    occ: jnp.ndarray         # (B, max_blocks + 1, SIGMA) int32
    counts: jnp.ndarray      # (B, SIGMA + 1) int32
    sa: jnp.ndarray          # (B, max_n) int32 (full or sampled values)
    text: jnp.ndarray        # (B, max_n) int8
    n: jnp.ndarray           # (B,) int32
    pfx_lo: jnp.ndarray | None = None  # (B, 4^q) int32, common q (prefix_q)
    pfx_hi: jnp.ndarray | None = None
    fused: jnp.ndarray | None = None   # (B, max_blocks+1, 24) int32 fused rank rows
    # sampled-SA mode (uniform sample_rate over all bins, else full SA).
    # Mark bits are stored pre-grouped as (B, nw/4, 4): the flat step's
    # fused locate gathers 4-word rows, and building that view in-program
    # from a (B, nw) argument splits the minor dim — a reshape a tiled
    # memory layout can materialize with the 4-wide minor dim padded many
    # times over. A leading-dim merge of this layout is a free bitcast,
    # like `fused`.
    sa_mark_bits: jnp.ndarray | None = None  # (B, nw/4, 4) uint32
    sa_rank_ck: jnp.ndarray | None = None    # (B, nck+1) int32

    @property
    def n_bins(self) -> int:
        return self.bwt_blocks.shape[0]

    @classmethod
    def from_host(cls, fms: list[FMIndex], texts: list[np.ndarray],
                  pad_bins_to: int | None = None,
                  max_n: int | None = None,
                  lean: bool = False) -> "DeviceFMSet":
        arrs = cls.build_np(fms, texts, pad_bins_to, max_n, lean=lean)
        return cls(**{k: None if v is None else jnp.asarray(v)
                      for k, v in arrs.items()})

    @classmethod
    def build_np(cls, fms: list[FMIndex], texts: list[np.ndarray],
                 pad_bins_to: int | None = None,
                 max_n: int | None = None, lean: bool = False,
                 prefix_q: int | None = None,
                 sample_rate: int | None = None) -> dict:
        """NumPy field dict (multi-host loaders assemble global arrays from
        these per-process shards; `max_n` forces the pad size so every
        process builds identically-shaped shards).

        `prefix_q` / `sample_rate` override the locally-derived layout
        parameters — multi-host loaders pass the globally-agreed values so
        a process whose bin range is EMPTY (uneven bins-per-host padding)
        still builds shard shapes identical to every other process's.

        lean=True keeps only what the FLAT mesh step consumes — fused rank
        rows, counts, SA (+marks), text, prefix tables — and replaces
        bwt_blocks/occ with 1-block placeholders. Saves ~1.2 bytes/char of
        HBM on big databases (the flat step's rank queries and fused-row
        locate never touch them)."""
        from ..index.fmindex import SIGMA
        from .rank import build_fused_rank_rows

        B = len(fms)
        if B == 0 and (max_n is None or pad_bins_to is None):
            raise ValueError("empty bin list needs explicit max_n and "
                             "pad_bins_to (multi-host shard-shape parity)")
        max_n = max_n or max(fm.n for fm in fms)
        max_blocks = (max_n + BLOCK - 1) // BLOCK
        Bp = pad_bins_to or B

        blk_keep = 1 if lean else max_blocks
        bwt = np.full((Bp, blk_keep, BLOCK), BWT_PAD, dtype=np.int8)
        occ = np.zeros((Bp, blk_keep + 1,
                        fms[0].occ.shape[1] if B else SIGMA),
                       dtype=np.int32)
        counts = np.zeros((Bp, fms[0].counts.shape[0] if B else SIGMA + 1),
                          dtype=np.int32)
        n = np.zeros(Bp, dtype=np.int32)
        text = np.full((Bp, max_n), BWT_PAD, dtype=np.int8)

        # sampled mode only when every bin shares one rate (mixed-rate DBs
        # fall back to the full-SA layout built by the indexer)
        if sample_rate is not None:
            rate = sample_rate
        else:
            rates = {fm.sample_rate for fm in fms}
            rate = rates.pop() if len(rates) == 1 else 1
        sampled = rate > 1
        # shapes derive from max_n (not local maxima) so multi-host
        # processes with different local bins build identical shard shapes
        max_sa = ((max_n + rate - 1) // rate if sampled else max_n)
        sa = np.zeros((Bp, max_sa), dtype=np.int32)
        mark_bits = rank_ck = None

        # common prefix-table depth: the smallest q over bins (rebuild where
        # a bin was built at a different q); 0 disables the table
        if prefix_q is not None:
            q = prefix_q
        else:
            qs = [fm.prefix_q for fm in fms]
            q = min(qs) if B and all(q > 0 for q in qs) else 0
        pfx_lo = pfx_hi = None
        if q > 0:
            pfx_lo = np.zeros((Bp, 4 ** q), dtype=np.int32)
            pfx_hi = np.zeros((Bp, 4 ** q), dtype=np.int32)

        fused_rows = np.zeros((Bp, max_blocks + 1, 24), dtype=np.int32)
        for b, (fm, t) in enumerate(zip(fms, texts)):
            nb = fm.bwt_blocks.shape[0]
            if not lean:
                bwt[b, :nb] = fm.bwt_blocks
                occ[b, : nb + 1] = fm.occ
                occ[b, nb + 1 :] = fm.occ[-1]  # rank constant past text end
            counts[b] = fm.counts
            sa[b, : len(fm.sa)] = fm.sa
            text[b, : fm.n] = t
            n[b] = fm.n
            fb = build_fused_rank_rows(fm.bwt_blocks, fm.occ)
            fused_rows[b, : fb.shape[0]] = fb
            fused_rows[b, fb.shape[0] :] = fb[-1]
            if q > 0:
                if fm.prefix_q != q:
                    fm.build_prefix_table(t, q)
                pfx_lo[b] = fm.pfx_lo
                pfx_hi[b] = fm.pfx_hi

        if sampled:
            # host FMIndex stores the packed device layout directly;
            # deterministic target sizes (multi-host shard-shape parity)
            nw = ((max_n + 31) // 32 + 3) // 4 * 4
            nck = (max_n + 127) // 128 + 1
            mark_bits = np.zeros((Bp, nw // 4, 4), dtype=np.uint32)
            rank_ck = np.zeros((Bp, nck), dtype=np.int32)
            for b, fm in enumerate(fms):
                mark_bits[b].reshape(-1)[: len(fm.sa_mark_bits)] = \
                    fm.sa_mark_bits
                rank_ck[b, : len(fm.sa_rank_ck)] = fm.sa_rank_ck
                rank_ck[b, len(fm.sa_rank_ck) :] = fm.sa_rank_ck[-1]

        return dict(bwt_blocks=bwt, occ=occ, counts=counts, sa=sa,
                    text=text, n=n, pfx_lo=pfx_lo, pfx_hi=pfx_hi,
                    fused=fused_rows, sa_mark_bits=mark_bits,
                    sa_rank_ck=rank_ck)

    @property
    def prefix_q(self) -> int:
        if self.pfx_lo is None:
            return 0
        q = 0
        size = self.pfx_lo.shape[1]
        while 4 ** q < size:
            q += 1
        return q

    def bin(self, b: int) -> DeviceFM:
        g = lambda f: None if getattr(self, f) is None else getattr(self, f)[b]
        mb = g("sa_mark_bits")
        return DeviceFM(bwt_blocks=self.bwt_blocks[b], occ=self.occ[b],
                        counts=self.counts[b], sa=self.sa[b],
                        text=self.text[b], n=self.n[b],
                        pfx_lo=g("pfx_lo"), pfx_hi=g("pfx_hi"),
                        sa_mark_bits=None if mb is None else mb.reshape(-1),
                        sa_rank_ck=g("sa_rank_ck"), fused=g("fused"))
