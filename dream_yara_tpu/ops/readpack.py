"""Read-matrix packing for host->device transfer (shared by the map step
and the IBF classifier).

Packed fwd rows are ~9x smaller than the raw (R2, L) int8 read matrix (2 bits/base + N bitmask, half the rows — the
rc rows are recomputed on device by unpack_reads with a flip + log-roll).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def pack_reads_fwd(seqs_fwd: np.ndarray, half: int, L: int,
                   packed_out: np.ndarray | None = None,
                   nmask_out: np.ndarray | None = None):
    """Host-side: 2-bit-pack forward read rows + N bitmask for upload.

    Packed fwd rows are ~9x smaller than the raw (R2, L) int8 read matrix
    (2 bits/base, half the rows — the rc rows are recomputed on device by
    unpack_reads).

    Dispatches to the native C++ packer (native/readpack.cpp, ~20ms vs
    ~1.6s numpy at 250k x 150bp — the numpy edition's uint32 temporaries
    dominated mesh dispatch wall time); the numpy path below is the oracle.
    packed_out/nmask_out let callers pack straight into a blob slice.
    """
    k = seqs_fwd.shape[0]
    Wp = (L + 15) // 16
    Wn = (L + 31) // 32
    try:
        from ..native import readpack as _native
    except ImportError:
        _native = None
    if _native is not None and _native.available():
        if packed_out is None:
            packed_out = np.empty((half, Wp), dtype=np.uint32)
        if nmask_out is None:
            nmask_out = np.empty((half, Wn), dtype=np.uint32)
        _native.pack_reads(seqs_fwd, half, L, packed_out, nmask_out)
        return packed_out, nmask_out
    codes = np.zeros((half, Wp * 16), dtype=np.uint32)
    isn = np.zeros((half, Wn * 32), dtype=np.uint32)
    codes[:k, :L] = (seqs_fwd & 3).astype(np.uint32)
    isn[:k, :L] = (seqs_fwd >= 4).astype(np.uint32)
    isn[k:, :] = 1
    isn[:, L:] = 1
    sh2 = (np.arange(16, dtype=np.uint32) * 2)[None, None, :]
    packed = (codes.reshape(half, Wp, 16) << sh2).sum(axis=2, dtype=np.uint32)
    sh1 = np.arange(32, dtype=np.uint32)[None, None, :]
    nmask = (isn.reshape(half, Wn, 32) << sh1).sum(axis=2, dtype=np.uint32)
    # mirror the native branch: each output buffer is optional independently
    if packed_out is not None:
        packed_out[:] = packed
        packed = packed_out
    if nmask_out is not None:
        nmask_out[:] = nmask
        nmask = nmask_out
    return packed, nmask


def unpack_fwd(packed: jnp.ndarray, nmask: jnp.ndarray,
               lengths: jnp.ndarray, L: int) -> jnp.ndarray:
    """Forward rows only: (half, L) int8, pads/N = 4. Bit-identical to
    unpack_reads(...)[:half] without the revcomp log-roll — canonical-mode
    classify needs only forward rows (canonical k-mers cover both strands),
    and the roll is ~log2(L) whole-matrix selects of wasted work there."""
    half = packed.shape[0]
    sh2 = (jnp.arange(16, dtype=jnp.uint32) * 2)[None, None, :]
    chars = ((packed[:, :, None] >> sh2) & 3).reshape(half, -1)[:, :L]
    sh1 = jnp.arange(32, dtype=jnp.uint32)[None, None, :]
    isn = ((nmask[:, :, None] >> sh1) & 1).reshape(half, -1)[:, :L]
    j = jnp.arange(L, dtype=jnp.int32)[None, :]
    return jnp.where((isn == 1) | (j >= lengths[:, None]),
                     jnp.uint32(4), chars).astype(jnp.int8)


def unpack_reads(packed: jnp.ndarray, nmask: jnp.ndarray,
                 lengths: jnp.ndarray, L: int) -> jnp.ndarray:
    """Device-side inverse of pack_reads_fwd: (R2, L) int8 rows
    [fwd | revcomp] matching ReadBatch layout (pads = N)."""
    half = packed.shape[0]
    fwd = unpack_fwd(packed, nmask, lengths, L)
    j = jnp.arange(L, dtype=jnp.int32)[None, :]

    # rc row: complement(reverse(fwd)) left-rolled by (L - l), pads N
    flip = fwd[:, ::-1]
    compf = jnp.where(flip < 4, 3 - flip, flip)
    shift = (L - lengths).astype(jnp.int32)
    rolled = compf
    k = 1
    while k < L:
        cand = jnp.concatenate([rolled[:, k:], rolled[:, :k]], axis=1)
        rolled = jnp.where(((shift // k) % 2)[:, None] == 1, cand, rolled)
        k *= 2
    rc = jnp.where(j < lengths[:, None], rolled, jnp.int8(4))
    return jnp.concatenate([fwd, rc], axis=0)


def pack_blob_with_lengths(seqs_fwd: np.ndarray, lengths: np.ndarray,
                           half: int, L: int) -> np.ndarray:
    """One contiguous uint32 upload: [packed | nmask | lengths-as-uint32].

    Each host->device transfer pays a fixed cost, so the three packed
    arrays ship as a single blob; unpack_blob splits it on device. The
    packers fill blob slices directly (no concatenate copy)."""
    Wp = (L + 15) // 16
    Wn = (L + 31) // 32
    nl = len(lengths)
    blob = np.empty(half * (Wp + Wn) + nl, dtype=np.uint32)
    pack_reads_fwd(seqs_fwd, half, L,
                   packed_out=blob[: half * Wp].reshape(half, Wp),
                   nmask_out=blob[half * Wp : half * (Wp + Wn)].reshape(half, Wn))
    blob[half * (Wp + Wn) :] = lengths.astype(np.int32).view(np.uint32)
    return blob


def unpack_blob(blob: jnp.ndarray, half: int, L: int):
    """Device-side split of pack_blob_with_lengths output."""
    Wp = (L + 15) // 16
    Wn = (L + 31) // 32
    packed = blob[: half * Wp].reshape(half, Wp)
    nmask = blob[half * Wp : half * (Wp + Wn)].reshape(half, Wn)
    lengths = blob[half * (Wp + Wn) :].astype(jnp.int32)
    return packed, nmask, lengths
