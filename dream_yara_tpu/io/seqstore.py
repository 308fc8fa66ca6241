"""Contig store: concatenated reference sequences for one bin.

Analog of reference src/store_seqs.h SeqStore [U]: loads fasta, holds the
concatenated contig text, names, lengths; (de)serializes; translates global
position <-> (contig id, local position).

Device-first layout: one flat int8 code array `text` = contig0 $ contig1 $ ... $
(SENTINEL-separated and -terminated, so FM-index matches can never span
contigs), plus int64 `offsets` (start of each contig in `text`). The FM text is
exactly this array; verification windows index it directly.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..utils.alphabet import SENTINEL
from .fasta import read_fasta


@dataclass
class SeqStore:
    names: list[str]
    text: np.ndarray       # (total+n_contigs,) int8: contigs separated/terminated by SENTINEL
    offsets: np.ndarray    # (n_contigs,) int64 start positions in `text`
    lengths: np.ndarray    # (n_contigs,) int64

    @property
    def n_contigs(self) -> int:
        return len(self.names)

    @classmethod
    def from_seqs(cls, names, seqs) -> "SeqStore":
        lengths = np.array([len(s) for s in seqs], dtype=np.int64)
        offsets = np.zeros(len(seqs), dtype=np.int64)
        total = int(lengths.sum()) + len(seqs)
        text = np.empty(total, dtype=np.int8)
        pos = 0
        for i, s in enumerate(seqs):
            offsets[i] = pos
            text[pos : pos + len(s)] = s
            text[pos + len(s)] = SENTINEL
            pos += len(s) + 1
        return cls(names=list(names), text=text, offsets=offsets, lengths=lengths)

    @classmethod
    def from_fasta(cls, path) -> "SeqStore":
        names, seqs = read_fasta(path)
        return cls.from_seqs(names, seqs)

    def global_to_local(self, pos: int) -> tuple[int, int]:
        """Global text position -> (contig id, local position)."""
        cid = int(np.searchsorted(self.offsets, pos, side="right")) - 1
        return cid, int(pos - self.offsets[cid])

    def contig_of(self, positions: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.offsets, positions, side="right") - 1

    def save(self, path):
        np.savez(path, names=np.array(self.names), text=self.text,
                 offsets=self.offsets, lengths=self.lengths)

    @classmethod
    def load_meta(cls, path):
        """Contig metadata WITHOUT the text payload (np.load is lazy per
        array): (names, offsets, lengths, text_len). Multi-host mappers use
        this to build the global contig table while loading heavy per-bin
        arrays only for locally-owned bins (SURVEY.md §5.8)."""
        path = str(path)
        if not path.endswith(".npz"):
            path += ".npz"
        z = np.load(path)
        lengths = z["lengths"]
        text_len = int(lengths.sum()) + len(lengths)  # + sentinel per contig
        return ([str(x) for x in z["names"]], z["offsets"], lengths, text_len)

    @classmethod
    def load(cls, path) -> "SeqStore":
        path = str(path)
        if not path.endswith(".npz"):
            path += ".npz"
        z = np.load(path, allow_pickle=False)
        return cls(names=[str(x) for x in z["names"]], text=z["text"],
                   offsets=z["offsets"], lengths=z["lengths"])
