"""Minimizer slack calibration (index/minimizer_calib.py) + threshold wiring.

The calibrated slack must be sound (0 at e=0, bounded by the k-mer lemma at
w==k), use DEVICE counting semantics (per selected window occurrence — the
round-4 advisor finding: set-granularity counting under-estimated slack for
destroyed duplicated keys), and be strictly tighter than the retired 2D
heuristic at the config shapes where the heuristic collapsed (BASELINE.md
row 2). The table rides in the filter artifact and drives every classify
path."""

import numpy as np

from dream_yara_tpu.index.ibf import InterleavedBloomFilter
from dream_yara_tpu.index.minimizer_calib import (calibrate_slack_table,
                                                  device_slack_samples)


def test_zero_errors_zero_slack(rng):
    # every read window is a genome window, so error-free selected read
    # minimizers are all genome-selected (with >= w flanking context)
    s = device_slack_samples(rng, L=80, k=19, w=26, e=0, trials=50)
    assert s.max() == 0


def test_w_equals_k_obeys_kmer_lemma(rng):
    # w == k selects every k-mer; e substitutions destroy at most e*k
    k, e = 11, 2
    s = device_slack_samples(rng, L=60, k=k, w=k, e=e, trials=50)
    assert s.max() <= e * k


def test_calibrated_tighter_than_heuristic(rng):
    # the retired config-2 shape: 150bp reads, e=5 — the 2D heuristic's
    # slack (50) exceeds the typical minimizer count (~29), collapsing the
    # threshold to the floor; the measured tail must come in far below it
    L, k, w, e = 150, 19, 26, 5
    s = device_slack_samples(rng, L=L, k=k, w=w, e=e, trials=60)
    m = L - k + 1
    heur_slack = m - InterleavedBloomFilter.minimizer_threshold(m, k, w, e)
    p = int(np.quantile(s, 0.999, method="higher"))
    assert p < heur_slack
    assert p <= 30  # measured ~24; leave a determinism margin


def test_device_count_semantics_duplicates(rng):
    # a read whose selected minimizers contain a DUPLICATED destroyed key
    # must charge slack once per occurrence. Construct it directly: genome
    # keys {A}, read occurrences [X, X, A] (X destroyed, duplicated).
    # Set-granularity slack = 3 - 1 - (3 - 2) = 1; device slack = 2.
    from dream_yara_tpu.index import minimizer_calib as mc

    orig = mc._selected_occurrences
    seq = [([("g", 0), ("a", 0)], 2),          # genome context: keys g, a
           ([("x", 0), ("x", 0), ("a", 0)], 3)]  # read occurrences

    def fake(codes, k, w, canonical=True):
        return seq.pop(0)

    mc._selected_occurrences = fake
    try:
        s = mc.device_slack_samples(np.random.default_rng(0), L=10, k=3,
                                    w=5, e=1, trials=1)
    finally:
        mc._selected_occurrences = orig
    assert s[0] == 2


def test_table_monotone_and_stored(tmp_path, rng):
    table = calibrate_slack_table(19, 26, read_lens=(60,), e_max=3,
                                  trials=40, seed=1)
    assert table[0] == 0
    assert (np.diff(table) >= 0).all()
    filt = InterleavedBloomFilter.create(bins=4, size_bits=1 << 22,
                                         k=19, window=26)
    filt.slack_table = table
    filt.save(tmp_path / "f.npz")
    f2 = InterleavedBloomFilter.load(tmp_path / "f.npz")
    assert np.array_equal(f2.slack_table, table)
    # routing_threshold prefers the table and extrapolates past its end
    t_in = f2.routing_threshold(20, 2)
    assert t_in == max(1, 20 - int(table[2]))
    W0 = 26 - 19 + 1
    D = -(-19 // W0) + 2
    t_out = f2.routing_threshold(20, 5)
    assert t_out == max(1, 20 - int(table[3]) - 2 * 2 * D)
    # without a table: the heuristic
    filt.slack_table = None
    assert filt.routing_threshold(20, 2) == \
        InterleavedBloomFilter.minimizer_threshold(20, 19, 26, 2)


def test_device_classifier_uses_table(rng):
    """classify_thresholds must consume the per-row table exactly."""
    import jax.numpy as jnp

    from dream_yara_tpu.ops.ibf_query import classify_thresholds

    k, w = 19, 26
    table = np.array([0, 7, 12, 16], np.int32)
    lengths = jnp.array([100, 150, 300], jnp.int32)
    n_sel = jnp.array([20, 29, 58], jnp.int32)
    rate_ppm = 300  # 3%: e = 3, 4, 9
    thr = np.asarray(classify_thresholds(lengths, n_sel, k, w, rate_ppm,
                                         jnp.asarray(table)))
    W0 = w - k + 1
    D = -(-k // W0) + 2
    assert thr[0] == 20 - 16
    assert thr[1] == 29 - 16 - 1 * 2 * D   # e=4: one past the table
    assert thr[2] == max(1, 58 - 16 - 6 * 2 * D)
