"""Pallas (Triton route) kernel for the banded-verification DP (HOT LOOP 3).

The XLA edition (ops/verify.py) runs the L-step DP as a fori_loop whose
(W, C) carries go through device memory on every step, as a handful of small
kernels per step. Here one program owns a tile of TILE candidates, one per
lane, runs all L steps in registers and writes only (dist, begin, end).

Layout:
  * the band is W = 2E+1 Python-unrolled (TILE,) int32 vectors, so the
    "shift by one diagonal" of the XLA edition is a renaming, not a copy;
  * the window chars of step j are rows j .. j+W-1 of the transposed
    (WLEN, C) int8 windows; they slide by one row per step, so each step
    loads exactly one new window row and one read row;
  * codes >= 4 (N, sentinel, padding) are remapped on load to -1 (text) and
    -2 (read), so a substitution is a single `!=` and such codes still
    mismatch everything, as in ops/verify.py.

Tie-breaking is lane-for-lane identical to ops/verify.py: the same up-move
rule, the same k = 1, 2, 4, ... doubling scan for the in-row insertion
dependency (a sequential chain over d can pick another begin under ties),
and a strict-< argmin that keeps the smallest d. Every value is an int32, so
the two editions are compared with exact equality.

The text-window gather (128-char block rows + 7-step log-shift alignment)
stays in XLA: its `tblock_fetch` hook carries the stacked per-bin tables of
the flat step and the sharded-text psum (ops/verify.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

from .verify import gather_windows, local_tblock_fetch

# On an H100, tiles of 64-512 candidates on 2-8 warps timed within 10% of
# each other at 2^20 candidates (L=100 and 150); 128 on 4 warps is kept.
TILE = 128
NUM_WARPS = 4
NUM_STAGES = 1   # the step loop carries registers, no shared-memory ring


def _dp_kernel(wT_ref, rT_ref, anch_ref, len_ref, dist_ref, beg_ref, end_ref,
               *, L: int, E: int):
    W = 2 * E + 1
    INF = 1 << 20
    lens = len_ref[...]
    anch = anch_ref[...]
    zero = jnp.zeros_like(lens)

    def text_row(i):
        w = wT_ref[i, :].astype(jnp.int32)
        return jnp.where(w >= 4, -1, w)

    D0 = tuple(zero for _ in range(W))
    S0 = tuple(zero + d for d in range(W))
    win0 = tuple(text_row(d) for d in range(W - 1))

    def step(j, carry):
        D, S, win, best, bbeg, bend = carry
        wch = win + (text_row(j + W - 1),)
        r = rT_ref[j, :].astype(jnp.int32)
        r = jnp.where(r >= 4, -2, r)

        # diagonal move, then the read-gap move from diagonal d+1
        nD, nS = [], []
        for d in range(W):
            diag = D[d] + (r != wch[d]).astype(jnp.int32)
            if d + 1 < W:
                up = D[d + 1] + 1
                take = up < diag
                nD.append(jnp.where(take, up, diag))
                nS.append(jnp.where(take, S[d + 1], S[d]))
            else:
                nD.append(diag)
                nS.append(S[d])
        # in-row insertion dependency: min-plus prefix scan by doubling,
        # each round reading only the previous round's values
        k = 1
        while k < W:
            pD, pS = nD, nS
            nD, nS = list(pD[:k]), list(pS[:k])
            for d in range(k, W):
                cand = pD[d - k] + k
                take = cand < pD[d]
                nD.append(jnp.where(take, cand, pD[d]))
                nS.append(jnp.where(take, pS[d - k], pS[d]))
            k *= 2

        done = (j + 1) == lens
        row_best, d_best, s_best = nD[0], zero, nS[0]
        for d in range(1, W):
            better = nD[d] < row_best
            row_best = jnp.where(better, nD[d], row_best)
            d_best = jnp.where(better, d, d_best)
            s_best = jnp.where(better, nS[d], s_best)
        best = jnp.where(done, row_best, best)
        bbeg = jnp.where(done, anch - E + s_best, bbeg)
        bend = jnp.where(done, anch - E + (j + 1) + d_best, bend)
        return tuple(nD), tuple(nS), wch[1:], best, bbeg, bend

    _, _, _, best, bbeg, bend = jax.lax.fori_loop(
        0, L, step, (D0, S0, win0, zero + INF, zero, zero))
    dist_ref[...] = best
    beg_ref[...] = bbeg
    end_ref[...] = bend


def banded_dp_pallas(wT, rT, anchors, lengths, *, max_err: int,
                     interpret: bool = False):
    """The DP alone: wT (L+2E, C) int8 transposed text windows, rT (L, C)
    int8 transposed reads, anchors / lengths (C,) int32. Candidates are
    padded to a tile multiple here; padded lanes have length 0 and report
    (INF, 0, 0), as ops/verify.py does for such lanes."""
    L, C = rT.shape
    E = int(max_err)
    Cp = -(-C // TILE) * TILE
    pad = Cp - C
    if pad:
        wT = jnp.pad(wT, ((0, 0), (0, pad)))
        rT = jnp.pad(rT, ((0, 0), (0, pad)))
        anchors = jnp.pad(anchors, (0, pad))
        lengths = jnp.pad(lengths, (0, pad))
    col = lambda i: (0, i)
    lane = lambda i: (i,)
    vec = pl.BlockSpec((TILE,), lane)
    dist, beg, end = pl.pallas_call(
        functools.partial(_dp_kernel, L=L, E=E),
        grid=(Cp // TILE,),
        in_specs=[pl.BlockSpec((wT.shape[0], TILE), col),
                  pl.BlockSpec((L, TILE), col), vec, vec],
        out_specs=[vec, vec, vec],
        out_shape=[jax.ShapeDtypeStruct((Cp,), jnp.int32)] * 3,
        backend="triton",
        compiler_params=pltr.CompilerParams(num_warps=NUM_WARPS,
                                            num_stages=NUM_STAGES),
        interpret=interpret,
        name="banded_verify_dp",
    )(wT, rT, anchors.astype(jnp.int32), lengths.astype(jnp.int32))
    return dist[:C], beg[:C], end[:C]


def banded_verify_pallas_hooked(anchors, reads, read_rows, lengths,
                                *, max_err: int, tblock_fetch,
                                interpret: bool = False):
    """Kernel edition of ops.verify.banded_verify with an injected text-block
    fetcher, for the multi-bin flat step (pipeline/flat_step.py): the hook
    contract is banded_verify's. Not jitted: a function-valued argument
    cannot cross a jit boundary, so call it inside the enclosing trace."""
    E = int(max_err)
    L = reads.shape[1]
    wT = gather_windows(anchors, L, E, tblock_fetch).T       # (L+2E, C)
    rT = jnp.take(reads, read_rows, axis=0).T                # (L, C)
    return banded_dp_pallas(wT, rT, anchors, lengths, max_err=E,
                            interpret=interpret)


@functools.partial(jax.jit, static_argnames=("max_err", "interpret"))
def banded_verify_pallas(text, anchors, reads, read_rows, lengths,
                         *, max_err: int, interpret: bool = False):
    """Drop-in replacement for ops.verify.banded_verify (same contract) on
    one bin's local text."""
    return banded_verify_pallas_hooked(
        anchors, reads, read_rows, lengths, max_err=max_err,
        tblock_fetch=local_tblock_fetch(text, reads.shape[1], int(max_err)),
        interpret=interpret)
