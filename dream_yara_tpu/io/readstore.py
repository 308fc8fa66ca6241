"""Device-ready read batches.

Device-first layout (vs. reference src/bits_reads.h ragged StringSet [U]): reads
are padded into a dense (n_seqs, max_len) int8 matrix with a length vector —
static shapes for XLA. Sequence-id arithmetic reproduces the reference layout
[fwd mates1 | fwd mates2 | rc mates1 | rc mates2] (bits_reads.h getReadSeqId /
getMateSeqId [U]): for n logical reads there are 2n sequence rows; row i is the
forward strand of read i for i<n and the reverse complement of read i-n
otherwise. Pads use code N (4) so they never exact-match the FM text.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.alphabet import N, _COMPLEMENT, revcomp


@dataclass
class ReadBatch:
    names: list[str]
    seqs: np.ndarray      # (2n, max_len) int8, rows n..2n-1 are revcomp of 0..n-1
    lengths: np.ndarray   # (n,) int32
    quals: list[bytes]
    paired: bool          # if True: reads [0, n/2) are mates1, [n/2, n) mates2

    @property
    def n_reads(self) -> int:
        return len(self.lengths)

    @property
    def max_len(self) -> int:
        return self.seqs.shape[1]

    def mate_id(self, read_id: int) -> int:
        """Reference getMateId arithmetic [U]: mates are offset by n/2."""
        half = self.n_reads // 2
        return read_id + half if read_id < half else read_id - half

    def seq_row(self, read_id: int, reverse: bool) -> int:
        return read_id + self.n_reads if reverse else read_id

    @classmethod
    def from_dense(cls, names, seqs: np.ndarray, lengths: np.ndarray,
                   quals=None, paired=False) -> "ReadBatch":
        """From an already-dense (n, L) int8 matrix (native parser path):
        builds the rc rows vectorized (per-row mirror up to each length)."""
        n, L = seqs.shape
        j = np.arange(L)
        src = lengths[:, None] - 1 - j[None, :]
        valid = src >= 0
        src = np.where(valid, src, j)
        rc = _COMPLEMENT[np.take_along_axis(seqs, src, axis=1)]
        rc = np.where(valid, rc, np.int8(N)).astype(np.int8)
        mat = np.concatenate([seqs, rc])
        if quals is None:
            quals = [b"I" * int(l) for l in lengths]
        return cls(names=list(names), seqs=mat,
                   lengths=lengths.astype(np.int32), quals=quals, paired=paired)

    @classmethod
    def from_reads(cls, names, seqs, quals=None, paired=False, pad_to=None) -> "ReadBatch":
        n = len(seqs)
        lengths = np.array([len(s) for s in seqs], dtype=np.int32)
        max_len = int(lengths.max()) if n else 0
        if pad_to is not None:
            max_len = max(max_len, pad_to)
        mat = np.full((2 * n, max_len), N, dtype=np.int8)
        for i, s in enumerate(seqs):
            mat[i, : len(s)] = s
            mat[n + i, : len(s)] = revcomp(np.asarray(s, dtype=np.int8))
        if quals is None:
            quals = [b"I" * int(l) for l in lengths]
        return cls(names=list(names), seqs=mat, lengths=lengths, quals=list(quals),
                   paired=paired)
