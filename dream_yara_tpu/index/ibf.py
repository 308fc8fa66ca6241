"""Interleaved Bloom Filter — THE DREAM data structure (SURVEY.md §2.6).

Analog of reference src/d_bloom_filter.h SeqAnBloomFilter [U]. Layout matches
the reference's interleaving (BASELINE.json "IBF bitvector layout"): one flat
bit space of n_rows * bins_padded bits; hash h_j(kmer) selects a ROW; within a
row there is one bit per bin. Bit index = hash * bins_padded + bin_id.

Device-first storage: uint32 word matrix `words` of shape (n_rows, bins_padded/32)
— a device query gathers whole rows (one per hash), ANDs them across hashes,
and unpacks bits to per-bin counters (ops/ibf_query.py). bins_padded is rounded
to a multiple of 64 like the reference [U].

Dynamic update (reference src/d_update_filter.cpp [U]): clear_bins() zeroes one
bin's bit column across all rows — O(filter), not O(database) — then k-mers of
the replacement sequences are re-inserted.

Strand convention: forward k-mers of the bin sequences are inserted; the mapper
queries each read AND its reverse complement and unions the candidate bins
(reference queries both orientations since mapping is strand-symmetric [U,M]).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .hashing import kmer_windows, ibf_rows


@dataclass
class InterleavedBloomFilter:
    bins: int
    n_rows: int
    n_hashes: int
    k: int
    words: np.ndarray  # (n_rows, bins_padded // 32) uint32
    window: int = 0    # minimizer window w (> k enables winnowing; 0/k = all
                       # k-mers). Reference build_filter's optional minimizer
                       # mode [U,M]: both build AND query select minimizers
                       # with the same rule, so membership tests line up.
    canonical: int = 0 # 1 = strand-canonical k-mers (min(fwd, revcomp)):
                       # one inserted value covers both orientations, so the
                       # classifier hashes only forward read rows — half the
                       # row gathers of the classic forward-insert layout
                       # (hashing.canonical_windows). The default for new
                       # filters; 0 keeps compatibility with old artifacts.
    blocked: int = 0   # 1 = cache-blocked layout: a k-mer's n_hashes probe
                       # rows all live in ONE 128-word block, so the device
                       # classifier gathers a single 512 B block row per
                       # window instead of n_hashes scattered words
                       # (hashing.ibf_blocked_rows). Default for new
                       # filters with <= 512 bins;
                       # 0 = classic layout (old artifacts, or > 512 bins).
    slack_table: np.ndarray | None = None
                       # minimizer-mode routing slack per error count,
                       # Monte-Carlo'd at build time with device counting
                       # semantics (index/minimizer_calib.py): threshold
                       # t(e) = n_minis - slack_table[e]. Stored IN the
                       # artifact so every classify path (host oracle,
                       # single-chip, mesh, multihost) uses the same
                       # calibrated bound; None = fall back to the loose
                       # 2D heuristic (minimizer_threshold).

    def __post_init__(self):
        if self.window < self.k:
            self.window = self.k

    @property
    def bins_padded(self) -> int:
        return self.words.shape[1] * 32

    @classmethod
    def create(cls, bins: int, size_bits: int, n_hashes: int = 3, k: int = 19,
               window: int = 0, canonical: bool = True,
               blocked: bool | None = None):
        from .hashing import BLOCK_WORDS

        bins_padded = ((bins + 63) // 64) * 64
        wd = bins_padded // 32
        n_rows = max(1, size_bits // bins_padded)
        if blocked is None:
            # blocked needs >= n_hashes+1 sub-rows per 128-word block
            blocked = BLOCK_WORDS // wd >= 8
        if blocked:
            S = BLOCK_WORDS // wd
            n_rows = max(S, (n_rows // S) * S)   # whole blocks
        words = np.zeros((n_rows, wd), dtype=np.uint32)
        return cls(bins=bins, n_rows=n_rows, n_hashes=n_hashes, k=k,
                   words=words, window=window, canonical=int(canonical),
                   blocked=int(blocked))

    def _rows(self, lo, hi):
        if self.blocked:
            from .hashing import ibf_blocked_rows

            return ibf_blocked_rows(lo, hi, self.n_hashes, self.n_rows,
                                    self.words.shape[1])
        return ibf_rows(lo, hi, self.n_hashes, self.n_rows)

    # --- build / update (host, offline path) ---

    def add_kmers(self, codes: np.ndarray, bin_id: int):
        """Insert the selected k-mers of one sequence into bin_id's column
        (all valid k-mers, or only window minimizers when window > k)."""
        lo, hi, valid = self._windows(codes)
        if self.window > self.k:
            from .hashing import minimizer_select

            valid = minimizer_select(lo, hi, valid, self.window, self.k)
        if not valid.any():
            return
        rows = self._rows(lo[valid], hi[valid]).reshape(-1)
        word, bit = divmod(bin_id, 32)
        try:
            from ..native import scatter
            if scatter.available():
                scatter.scatter_or(self.words, rows, word, 1 << bit)
                return
        except ImportError:
            pass
        np.bitwise_or.at(self.words[:, word], rows, np.uint32(1 << bit))

    def clear_bins(self, bin_ids):
        """Zero the bit columns of the given bins across all rows (O(filter))."""
        for b in bin_ids:
            word, bit = divmod(int(b), 32)
            self.words[:, word] &= np.uint32(~np.uint32(1 << bit))

    # --- query (host oracle; device version in ops/ibf_query.py) ---

    def _windows(self, codes):
        if self.canonical:
            from .hashing import canonical_windows

            return canonical_windows(codes, self.k)
        return kmer_windows(codes, self.k)

    def bin_counts(self, codes: np.ndarray) -> np.ndarray:
        """Per-bin count of (selected) k-mers of `codes` present in each bin."""
        lo, hi, valid = self._windows(codes)
        if self.window > self.k:
            from .hashing import minimizer_select

            valid = minimizer_select(lo, hi, valid, self.window, self.k)
        counts = np.zeros(self.bins, dtype=np.int32)
        if not valid.any():
            return counts
        rows = self._rows(lo[valid], hi[valid])
        row_words = self.words[rows]                  # (nk, h, W)
        anded = row_words[:, 0]
        for j in range(1, self.n_hashes):
            anded = anded & row_words[:, j]           # (nk, W)
        shifts = np.arange(32, dtype=np.uint32)
        bits = (anded[:, :, None] >> shifts) & 1      # (nk, W, 32)
        counts_padded = bits.sum(axis=0).reshape(-1)  # (bins_padded,)
        return counts_padded[: self.bins].astype(np.int32)

    def which_bins(self, codes: np.ndarray, threshold: int) -> np.ndarray:
        """Bin ids whose count >= threshold (k-mer counting lemma, §2.6)."""
        return np.nonzero(self.bin_counts(codes) >= threshold)[0]

    @staticmethod
    def threshold(read_len: int, k: int, errors: int) -> int:
        """k-mer lemma: t = (l - k + 1) - k*e, floored at 1."""
        return max(1, (read_len - k + 1) - k * errors)

    def n_minimizers(self, codes: np.ndarray) -> int:
        """Selected k-mer count of one sequence (for minimizer thresholds)."""
        lo, hi, valid = self._windows(codes)
        if self.window > self.k:
            from .hashing import minimizer_select

            valid = minimizer_select(lo, hi, valid, self.window, self.k)
        return int(valid.sum())

    @staticmethod
    def minimizer_threshold(n_minis: int, k: int, w: int, errors: int) -> int:
        """Minimizer-mode routing threshold: t = n_minis - e * 2D with
        D = ceil(k / (w-k+1)) + 2. Each error both DESTROYS up to ~D genome
        minimizers (it invalidates the k k-mers covering it — about k/W0
        window-groups — and can reshuffle the selection at both flanks) and
        CREATES up to ~D new read minimizers that are absent from the filter
        but counted in n_minis; both effects widen the count deficit, hence
        the symmetric 2D slack. (t = n_minis - e*D lost ~0.1% of true routes
        on 150bp e=3% reads; every miss becomes a mate-rescue device sweep,
        far costlier than the FP routes the extra slack admits.)

        Unlike the k-mer lemma this bound is PROBABILISTIC (a pathological
        error placement can destroy more minimizers than D — the hard
        no-false-negative guarantee requires w == k); FP routing is
        controlled by filter sizing (bits/kmer), not the threshold.
        See docs/OUTPUT_CONTRACT.md."""
        W0 = max(w - k + 1, 1)
        D = -(-k // W0) + 2
        return max(1, n_minis - errors * 2 * D)

    def routing_threshold(self, n_minis: int, errors: int) -> int:
        """Minimizer-mode threshold from the calibrated slack table when the
        artifact carries one (build_filter computes it; ~2x tighter than
        the 2D heuristic), else the heuristic. Past the table's last entry
        the slack extrapolates with the heuristic's per-error 2D step —
        conservative, never unsafe."""
        if self.slack_table is None or len(self.slack_table) == 0:
            return self.minimizer_threshold(n_minis, self.k, self.window,
                                            errors)
        e_max = len(self.slack_table) - 1
        W0 = max(self.window - self.k + 1, 1)
        D = -(-self.k // W0) + 2
        slack = (int(self.slack_table[min(errors, e_max)])
                 + max(errors - e_max, 0) * 2 * D)
        return max(1, n_minis - slack)

    def calibrate(self, e_max: int = 12, trials: int = 2000,
                  q: float = 1e-3, read_lens=(100, 150, 250), seed: int = 0):
        """Monte-Carlo the slack table for this filter's (k, w) and store it
        in the artifact (index/minimizer_calib.py). No-op when w == k (the
        k-mer lemma is exact there)."""
        if self.window <= self.k:
            return
        from .minimizer_calib import calibrate_slack_table

        self.slack_table = calibrate_slack_table(
            self.k, self.window, read_lens=read_lens, e_max=e_max,
            trials=trials, q=q, seed=seed,
            canonical=bool(self.canonical))

    # --- serialization ---

    def save(self, path):
        extra = {}
        if self.slack_table is not None:
            extra["slack_table"] = np.asarray(self.slack_table, np.int32)
        np.savez(path, bins=self.bins, n_rows=self.n_rows,
                 n_hashes=self.n_hashes, k=self.k, words=self.words,
                 window=self.window, canonical=self.canonical,
                 blocked=self.blocked, **extra)

    @classmethod
    def load(cls, path) -> "InterleavedBloomFilter":
        path = str(path)
        if not path.endswith(".npz"):
            path += ".npz"
        z = np.load(path)
        return cls(bins=int(z["bins"]), n_rows=int(z["n_rows"]),
                   n_hashes=int(z["n_hashes"]), k=int(z["k"]), words=z["words"],
                   window=int(z["window"]) if "window" in z.files else 0,
                   canonical=(int(z["canonical"])
                              if "canonical" in z.files else 0),
                   blocked=int(z["blocked"]) if "blocked" in z.files else 0,
                   slack_table=(z["slack_table"]
                                if "slack_table" in z.files else None))
