"""Dna5 alphabet codes and bit packing.

Device-first layout decision (vs. reference `src/basic_alphabet.h` SeqAn Dna5 [U]):
sequences live as flat int8 code arrays (A=0, C=1, G=2, T=3, N=4) on host and
device. The FM-index text additionally uses SENTINEL=5 as the contig separator /
terminator, so rank structures run over a 6-symbol alphabet whose occ tables are
int32 block checkpoints (see index/fmindex.py). 2-bit packing is provided for
k-mer hashing and compact storage of N-free regions.
"""

from __future__ import annotations

import numpy as np

A, C, G, T, N = 0, 1, 2, 3, 4
SENTINEL = 5          # contig separator in FM text; never matches any read char
SIGMA = 6             # FM text alphabet size (A,C,G,T,N,$)

_ASCII = np.full(256, N, dtype=np.int8)
for i, ch in enumerate("ACGT"):
    _ASCII[ord(ch)] = i
    _ASCII[ord(ch.lower())] = i
# IUPAC ambiguity codes and everything else map to N (reference folds them to N
# on Dna5 conversion as well [U]).

_CODE2ASCII = np.frombuffer(b"ACGTN$", dtype=np.uint8).copy()

_COMPLEMENT = np.array([T, G, C, A, N, SENTINEL], dtype=np.int8)


def ascii_to_code(buf: np.ndarray) -> np.ndarray:
    """uint8 ASCII array -> int8 codes."""
    return _ASCII[buf]


def code_to_ascii(codes: np.ndarray) -> np.ndarray:
    return _CODE2ASCII[codes]


def encode(s: str) -> np.ndarray:
    return ascii_to_code(np.frombuffer(s.encode(), dtype=np.uint8))


def decode(codes: np.ndarray) -> str:
    return code_to_ascii(np.asarray(codes, dtype=np.int8)).tobytes().decode()


def complement(codes: np.ndarray) -> np.ndarray:
    return _COMPLEMENT[codes]


def revcomp(codes: np.ndarray) -> np.ndarray:
    return _COMPLEMENT[codes][::-1]


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """Pack codes (N treated as A) into uint32 words, 16 bases per word, LSB first.

    Length is padded with A. Used for compact k-mer extraction; callers that
    care about N must mask separately.
    """
    codes = np.asarray(codes, dtype=np.int64) & 3
    n = len(codes)
    nwords = (n + 15) // 16
    padded = np.zeros(nwords * 16, dtype=np.int64)
    padded[:n] = codes
    padded = padded.reshape(nwords, 16)
    shifts = (np.arange(16, dtype=np.int64) * 2)[None, :]
    return (padded << shifts).sum(axis=1).astype(np.uint32, casting="unsafe")


def unpack_2bit(words: np.ndarray, n: int) -> np.ndarray:
    words = np.asarray(words, dtype=np.uint32)
    shifts = (np.arange(16, dtype=np.uint32) * 2)[None, :]
    codes = ((words[:, None] >> shifts) & 3).reshape(-1)
    return codes[:n].astype(np.int8)
