"""Mesh-sharded FM index: map against bins LARGER than one device's HBM.

Reference analog: SURVEY.md §5.7 — the reference caps bins at what one
process's RAM holds; the DREAM answer to bigger references is more bins.
On a device mesh the natural alternative is to shard ONE bin's tables over a mesh
axis and let XLA collectives assemble rows on demand:

  * every device holds a contiguous ROW RANGE of each table — fused rank
    rows (24 int32/block), 8-wide SA rows, 128-wide text blocks, and the
    (4^q, 2) q-mer prefix table;
  * queries are replicated over the shard axis; a row fetch is a masked
    LOCAL gather (devices return 0 for rows they don't own) followed by a
    `psum` over the axis — one all-reduce per fetch wave;
  * all other compute (seeding, interval updates, dedup/compaction, the
    banded verify DP) is replicated: it is small next to the tables, and
    replication keeps the math identical to the single-device map step,
    so the outputs are BIT-IDENTICAL (tests/test_sharded_fm.py).

Per-device memory for a bin of n bp: ~(24/128 + 4 + 1) * n / K bytes plus
the prefix table slice, so K devices hold a bin K times larger than one
device's memory. Throughput trades one psum per fetch wave; the shard axis
should stay within a host's device interconnect.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..index.fmindex import FMIndex
from ..ops.device_index import DeviceFM
from ..pipeline.map_step import FetchHooks, MapStepOut, _map_step_core


class ShardedBinDB(NamedTuple):
    """Host-stacked sharded tables; leading axis K is the shard axis."""

    fused: np.ndarray    # (K, nbl, 24) int32 fused rank rows
    sa8: np.ndarray      # (K, nrl, 8) int32 SA rows
    tb: np.ndarray       # (K, ntl, 128) int8 text blocks (pad = 6)
    pfx2: np.ndarray | None  # (K, npl, 2) int32 q-mer intervals
    counts: np.ndarray   # (SIGMA + 1,) int32
    n: int
    prefix_q: int
    K: int


def _split_rows(arr: np.ndarray, K: int, pad_value) -> np.ndarray:
    rows = arr.shape[0]
    per = (rows + K - 1) // K
    pad = np.full((K * per - rows,) + arr.shape[1:], pad_value, arr.dtype)
    return np.concatenate([arr, pad]).reshape((K, per) + arr.shape[1:])


def build_sharded_db(fm: FMIndex, text: np.ndarray, K: int) -> ShardedBinDB:
    """Split one bin's device tables into K contiguous row ranges."""
    from ..ops.rank import build_fused_rank_rows

    assert fm.sample_rate == 1, "sharded big-bin mode shards the full SA"
    n = fm.n
    fused = build_fused_rank_rows(fm.bwt_blocks, fm.occ)      # (nb+1, 24)
    nrows = (n + 7) // 8
    sa8 = np.zeros((nrows * 8,), np.int32)
    sa8[:n] = fm.sa
    sa8 = sa8.reshape(nrows, 8)
    ntb = (n + 127) // 128
    tb = np.full((ntb * 128,), 6, np.int8)                    # pad = sentinel 6
    tb[:n] = text
    tb = tb.reshape(ntb, 128)
    pfx2 = None
    if fm.prefix_q:
        pfx2 = np.stack([fm.pfx_lo, fm.pfx_hi], axis=1)       # (4^q, 2)
    return ShardedBinDB(
        fused=_split_rows(fused, K, 0),
        sa8=_split_rows(sa8, K, 0),
        tb=_split_rows(tb, K, np.int8(6)),
        pfx2=None if pfx2 is None else _split_rows(pfx2, K, 0),
        counts=fm.counts.copy(), n=n,
        prefix_q=fm.prefix_q, K=K)


def put_sharded(mesh: Mesh, db: ShardedBinDB, axis: str = "shard"):
    """Device-put the stacked tables, leading axis sharded over `axis`."""
    put = lambda x: jax.device_put(jnp.asarray(x),
                                   NamedSharding(mesh, P(axis)))
    rep = lambda x: jax.device_put(jnp.asarray(x), NamedSharding(mesh, P()))
    return dict(fused=put(db.fused), sa8=put(db.sa8), tb=put(db.tb),
                pfx2=None if db.pfx2 is None else put(db.pfx2),
                counts=rep(db.counts),
                n=rep(np.int32(db.n)))


def _psum_row_fetch(tab_loc: jnp.ndarray, axis: str, fill=None,
                    n_valid: int | None = None):
    """rows-by-global-index fetch: masked local gather + psum over `axis`.

    tab_loc: (rows_loc, W) this shard's slice. Out-of-range global indices
    return `fill` (e.g. 6-rows for text blocks) when given, else garbage the
    caller must mask."""
    rows_loc = tab_loc.shape[0]
    def fetch(gidx):
        d = jax.lax.axis_index(axis)
        loc = gidx - d * rows_loc
        ok = (loc >= 0) & (loc < rows_loc)
        r = jnp.take(tab_loc, jnp.clip(loc, 0, rows_loc - 1), axis=0)
        r = jnp.where(ok[:, None], r, 0).astype(jnp.int32)
        r = jax.lax.psum(r, axis)
        if fill is not None:
            bad = (gidx < 0) | (gidx >= n_valid)
            r = jnp.where(bad[:, None], fill, r)
        return r
    return fetch


def build_sharded_map_step(mesh: Mesh, axis: str = "shard", *,
                           rate_ppm: int, max_errors: int, capacity: int,
                           max_slen: int, prefix_q: int,
                           compact_cap: int | None = None,
                           verify_capacity: int | None = None,
                           uniform_len: bool = False):
    """Jitted (db_dev, reads, lengths) -> MapStepOut over the shard axis.

    reads/lengths are replicated (every shard maps the whole chunk); the
    output is replicated too — identical on every device by construction."""

    def local_step(fused, sa8, tb, pfx2, counts, n, reads, lengths):
        # shard_map keeps the sharded leading axis as size 1 — drop it
        fused, sa8, tb = fused[0], sa8[0], tb[0]
        pfx2 = None if pfx2 is None else pfx2[0]
        ntb_true = tb.shape[0] * mesh.shape[axis]   # padded rows are 6-filled
        hooks = FetchHooks(
            rank_rows=_psum_row_fetch(fused, axis),
            pfx=None if pfx2 is None else _psum_row_fetch(pfx2, axis),
            sa_rows=_psum_row_fetch(sa8, axis),
            n_sa_rows=sa8.shape[0] * mesh.shape[axis],
            tblocks=_psum_row_fetch(tb, axis, fill=jnp.int32(6),
                                    n_valid=ntb_true))
        fm = DeviceFM(bwt_blocks=None, occ=None, counts=counts, sa=None,
                      text=None, n=n, pfx_lo=None, pfx_hi=None, fused=None)
        return _map_step_core(fm, reads, lengths, rate_ppm, max_errors,
                              capacity, max_slen, verify_capacity,
                              compact_cap, prefix_q, False, 1,
                              uniform_len, hooks=hooks)

    def step(db_dev, reads, lengths):
        sharded = jax.shard_map(
            local_step, mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis),
                      None if db_dev["pfx2"] is None else P(axis),
                      P(), P(), P(), P()),
            out_specs=MapStepOut(*(P() for _ in MapStepOut._fields)),
            check_vma=False)
        return sharded(db_dev["fused"], db_dev["sa8"], db_dev["tb"],
                       db_dev["pfx2"], db_dev["counts"], db_dev["n"],
                       reads, lengths)
    return jax.jit(step)


class ShardedBinMapper:
    """BinMapper twin for ONE bin sharded over a mesh axis (SURVEY §5.7).

    Bit-identical to pipeline.mapper.BinMapper for sensitivity='full'
    (tests/test_sharded_fm.py). For 'high', capacity-overflowed seeds take
    the FULL-style exhaustive host expansion here instead of BinMapper's
    repetitive re-seed stratum, so this mapper can return a SUPERSET of
    BinMapper's matches on hyper-repetitive reads (never fewer)."""

    def __init__(self, fm: FMIndex, text: np.ndarray, mesh: Mesh,
                 axis: str = "shard", opts=None):
        from ..utils.options import MapperOptions

        self.fm = fm
        self.text = text
        self.mesh = mesh
        self.axis = axis
        self.opts = opts or MapperOptions()
        self.K = mesh.shape[axis]
        self.db = build_sharded_db(fm, text, self.K)
        self.dev = put_sharded(mesh, self.db, axis)
        self._steps: dict = {}

    def _step(self, **kw):
        key = tuple(sorted(kw.items()))
        if key not in self._steps:
            self._steps[key] = build_sharded_map_step(self.mesh, self.axis,
                                                      **kw)
        return self._steps[key]

    def map_batch(self, batch, capacity: int = 8):
        from ..pipeline.map_step import max_seed_len_static
        from ..pipeline.matches import Matches, build_matches
        from ..pipeline.seeding import max_errors_for_batch, rate_to_ppm
        from ..golden.golden_mapper import golden_verify

        opts = self.opts
        rate_ppm = rate_to_ppm(opts.error_rate)
        n = batch.n_reads
        L = batch.max_len
        max_err = max(1, max_errors_for_batch(L, opts.error_rate))
        max_slen = max_seed_len_static(L, rate_ppm)
        R2 = 2 * n
        from ..pipeline.map_step import uniform_len_ok
        uniform_len = uniform_len_ok(batch.lengths, L, rate_ppm, max_err)

        step = self._step(rate_ppm=rate_ppm, max_errors=max_err,
                          capacity=capacity, max_slen=max_slen,
                          prefix_q=self.db.prefix_q, compact_cap=R2,
                          uniform_len=uniform_len)
        out: MapStepOut = step(self.dev, jnp.asarray(batch.seqs),
                               jnp.asarray(batch.lengths))
        out = MapStepOut(*(np.asarray(x) for x in out))
        if int(out.n_spilled) > 0:   # dense re-verify (rare)
            step_d = self._step(rate_ppm=rate_ppm, max_errors=max_err,
                                capacity=capacity, max_slen=max_slen,
                                prefix_q=self.db.prefix_q,
                                verify_capacity=None,
                                uniform_len=uniform_len)
            out = MapStepOut(*(np.asarray(x) for x in
                               step_d(self.dev, jnp.asarray(batch.seqs),
                                      jnp.asarray(batch.lengths))))
        parts = [build_matches(out.row, out.begin, out.end, out.dist, out.ok,
                               n_reads=n)]
        if int(out.overflow_total) > 0 and opts.sensitivity != "low":
            # host expansion of spilled SA intervals (completeness)
            ns = max_err + 1
            cap = out.seed_hi - out.seed_lo - out.overflow
            rid, beg_l, end_l, dist_l = [], [], [], []
            for s in np.flatnonzero(out.overflow > 0):
                row = s // ns
                l = int(batch.lengths[row % n])
                if l == 0:
                    continue
                start = int(out.m_start[s])
                for r in range(int(out.seed_lo[s]) + int(cap[s]),
                               int(out.seed_hi[s])):
                    anchor = int(self.fm.sa[r]) - start
                    d, b, e = golden_verify(self.text, anchor,
                                            batch.seqs[row], max_err)
                    budget = (l * rate_ppm) // 10_000
                    if d <= budget and b >= 0 and e <= self.fm.n:
                        rid.append(row); beg_l.append(b); end_l.append(e)
                        dist_l.append(d)
            if rid:
                parts.append(build_matches(
                    np.asarray(rid, np.int32), np.asarray(beg_l, np.int64),
                    np.asarray(end_l, np.int64), np.asarray(dist_l, np.int32),
                    np.ones(len(rid), bool), n_reads=n))
        return Matches.concat(parts)
