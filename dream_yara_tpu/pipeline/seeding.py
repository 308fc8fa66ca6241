"""Seed cutting — analog of reference src/mapper_collector.h collectSeeds [U].

Pigeonhole seeding (SURVEY.md §2.3): a read with error budget E is cut into
E+1 disjoint seeds; any alignment with <= E errors contains >= 1 exact seed
(disjointness suffices — coverage of the tail is not required). Seed length =
len // (E+1), seed s starts at s * slen.

Device-first: seed descriptors are computed *inside jit* from the device length
vector — (rows, starts, slens) arrays of static size R2 * (E_max+1), with
slens == 0 marking seeds beyond a read's own budget. Error budgets use integer
arithmetic (rate expressed in 1/10000ths) so host and device agree exactly.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

RATE_DENOM = 10_000


def errors_for(lengths, rate_ppm: int):
    """Per-read error budget floor(len * rate), rate in 1/10000ths."""
    return (lengths * rate_ppm) // RATE_DENOM


def rate_to_ppm(error_rate: float) -> int:
    return int(round(error_rate * RATE_DENOM))


def make_seeds(lengths: jnp.ndarray, n_rows: int, rate_ppm: int, max_errors: int):
    """Seed descriptors for all seq rows (fwd + rc).

    lengths: (n,) int32 — per logical read; row r's read is r % n.
    Returns (rows, starts, slens): (S,) int32 each, S = n_rows * (max_errors+1).
    """
    n = lengths.shape[0]
    ns = max_errors + 1
    rows = jnp.repeat(jnp.arange(n_rows, dtype=jnp.int32), ns)
    sidx = jnp.tile(jnp.arange(ns, dtype=jnp.int32), n_rows)
    l = jnp.take(lengths, rows % n).astype(jnp.int32)
    e = errors_for(l, rate_ppm).astype(jnp.int32)
    nseeds = e + 1
    slen = l // nseeds
    valid = sidx < nseeds
    starts = sidx * slen
    slens = jnp.where(valid, slen, 0)
    return rows, starts, slens


def max_errors_for_batch(max_len: int, error_rate: float) -> int:
    return int(np.floor(max_len * error_rate))
