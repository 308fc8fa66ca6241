"""Microprofile the FLAT mesh map step at config-2 shapes: stage costs.

Builds the config-2 DB (8 x 5.8 Mbp bins), routes one 250k-read PE batch,
then times partial pipelines of pipeline/flat_step on the real device:
classify / slot-gather / +search / +hits / +dedup+compact / +verify.
Run: python tools/profile_flat_step.py [n_reads]
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent.parent))
sys.path.insert(0, str(Path(__file__).parent))


def main():
    import jax
    import jax.numpy as jnp

    from dream_yara_tpu.cli.common import enable_compile_cache

    enable_compile_cache()

    from bench_config2 import LD, LL, build_or_load, make_pairs
    from dream_yara_tpu.ops.device_index import DeviceFMSet
    from dream_yara_tpu.ops.ibf_query import ibf_bin_counts
    from dream_yara_tpu.parallel.dist_mapper import routing_from_counts
    from dream_yara_tpu.pipeline.flat_step import flat_map_step, slot_pool
    from dream_yara_tpu.pipeline.map_step import (max_seed_len_static,
                                                  uniform_len_ok)
    from dream_yara_tpu.pipeline.seeding import (max_errors_for_batch,
                                                 rate_to_ppm)
    from dream_yara_tpu.ops.readpack import (pack_blob_with_lengths,
                                             unpack_blob, unpack_reads)

    n_pairs = (int(sys.argv[1]) if len(sys.argv) > 1 else 250_000) // 2
    genomes, index = build_or_load()
    rng = np.random.default_rng(7)
    batch = make_pairs(genomes, index.stores, n_pairs, rng)
    n, L = batch.n_reads, batch.max_len
    rate_ppm = rate_to_ppm(0.03)
    max_err = max(1, max_errors_for_batch(L, 0.03))
    max_slen = max_seed_len_static(L, rate_ppm)
    uniform = uniform_len_ok(batch.lengths, L, rate_ppm, max_err)
    B = index.n_bins
    fmset = DeviceFMSet.from_host(list(index.fms),
                                  [st.text for st in index.stores])
    prefix_q = fmset.prefix_q
    filt = index.filter
    wd_need = (filt.words.shape[1] if getattr(filt, "blocked", 0)
               else max(1, (B + 31) // 32))
    fw = jnp.asarray(np.asarray(filt.words)[:, :wd_need])
    k, nh, w = filt.k, filt.n_hashes, getattr(filt, "window", 0)
    canonical = bool(getattr(filt, "canonical", 0))
    blocked = bool(getattr(filt, "blocked", 0))

    half = n
    t_cap = max(256, 5 * half // 4)
    blob = jnp.asarray(pack_blob_with_lengths(batch.seqs[:n], batch.lengths,
                                              half, L))
    print(f"[pfs] n={n} L={L} max_err={max_err} t_cap={t_cap} "
          f"uniform={uniform} prefix_q={prefix_q} canonical={canonical} "
          f"blocked={blocked} Wd={fw.shape[1]}", file=sys.stderr)

    from dream_yara_tpu.ops.ibf_query import classify_thresholds

    def stage_classify(fmset_, fw_, blob_):
        packed, nmask, lengths = unpack_blob(blob_, half, L)
        reads = unpack_reads(packed, nmask, lengths, L)
        if canonical:
            counts, n_sel = ibf_bin_counts(fw_, reads[:half], lengths, k,
                                           nh, w, canonical=True,
                                           blocked=blocked, n_bins=B)
            thr = classify_thresholds(lengths, n_sel, k, w, rate_ppm)
            cand = (counts >= thr[:, None])[:, :B]
        else:
            lengths2 = jnp.concatenate([lengths, lengths])
            counts, n_sel = ibf_bin_counts(fw_, reads, lengths2, k, nh, w,
                                           blocked=blocked, n_bins=B)
            cand = routing_from_counts(counts, n_sel, lengths2, k, w,
                                       rate_ppm, half)[:, :B]
        return reads, lengths, cand

    def stage_pool(fmset_, fw_, blob_):
        reads, lengths, cand = stage_classify(fmset_, fw_, blob_)
        rs, bs, valid, ovf = slot_pool(cand, t_cap)
        return reads, lengths, rs, bs, valid

    import os
    from dream_yara_tpu.pipeline.map_step import verify_uses_kernel

    use_pallas = verify_uses_kernel()
    cap2v = float(os.environ.get("DY_CAP2V", "1.25"))
    compact_cap = max(8, int(cap2v * t_cap))

    def stage_full(fmset_, fw_, blob_):
        reads, lengths, rs, bs, valid = stage_pool(fmset_, fw_, blob_)
        out = flat_map_step(fmset_, reads, lengths, rs, bs, valid,
                            half_loc=half, rate_ppm=rate_ppm,
                            max_errors=max_err, capacity=8,
                            max_slen=max_slen, prefix_q=prefix_q,
                            compact_cap=compact_cap, uniform_len=uniform,
                            use_pallas=use_pallas)
        return out

    def timed(fn, name):
        f = jax.jit(fn)
        tc0 = time.time()
        r = jax.tree.leaves(f(fmset, fw, blob))[0]
        _ = np.asarray(jnp.sum(jnp.asarray(r, jnp.int32)[:1]))
        print(f"[pfs] {name}: compile+1st {time.time()-tc0:.1f}s",
              file=sys.stderr)
        ts = []
        for _i in range(3):
            t0 = time.time()
            r = jax.tree.leaves(f(fmset, fw, blob))[0]
            _ = np.asarray(jnp.sum(jnp.asarray(r, jnp.int32)[:1]))
            ts.append(time.time() - t0)
        print(f"[pfs] {name}: {sorted(ts)[1]*1e3:8.1f} ms", file=sys.stderr)

    def stage_stop(which):
        def fn(fmset_, fw_, blob_):
            reads, lengths, rs, bs, valid = stage_pool(fmset_, fw_, blob_)
            return flat_map_step(fmset_, reads, lengths, rs, bs, valid,
                                 half_loc=half, rate_ppm=rate_ppm,
                                 max_errors=max_err, capacity=8,
                                 max_slen=max_slen, prefix_q=prefix_q,
                                 compact_cap=compact_cap,
                                 uniform_len=uniform, stop_after=which)
        return fn

    timed(stage_classify, "classify          ")
    timed(stage_pool, "classify+pool     ")
    print(f"[pfs] use_pallas={use_pallas} cap2v={cap2v} "
          f"compact_cap={compact_cap}", file=sys.stderr)
    stages = os.environ.get(
        "DY_PFS_STAGES", "search,locate,compact").split(",")
    for st in stages:
        if st:
            timed(stage_stop(st), f"+{st:17s}")
    timed(stage_full, "FULL (=+verify)   ")


if __name__ == "__main__":
    main()
