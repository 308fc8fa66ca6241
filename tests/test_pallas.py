"""Triton verify kernel == XLA verify (Pallas interpret mode on the CPU).

Every value of the DP is an int32, so the two editions must agree exactly:
dist, begin and end on every lane, including `begin` where several begins
tie (the tandem-repeat candidates below). The compiled kernel is compared
at full widths on the GPU by chip_smoke.py.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from dream_yara_tpu.ops.pallas_verify import (TILE, banded_verify_pallas,
                                              banded_verify_pallas_hooked)
from dream_yara_tpu.ops.verify import banded_verify
from tests.conftest import mutate, random_text

# (read length L, band radius E, candidates C); no C is a TILE multiple
SHAPES = [(80, 4, 600), (100, 3, 300), (150, 4, 333)]


def _tandem(n, unit=(0, 1, 2)):
    return np.resize(np.array(unit, np.int8), n)


def _text_with_repeats(rng, n):
    """Random text with a tandem repeat and a homopolymer run: reads from
    there align equally well at several begins inside the band."""
    t = random_text(rng, n)
    t[1000:1600] = _tandem(600)
    t[2000:2300] = 3
    t[-1] = 5
    return t


def _reads_at(rng, text, anchors, L, C):
    reads = np.full((C, L), 4, np.int8)
    lens = np.zeros(C, np.int32)
    for i in range(C):
        a = max(int(anchors[i]), 0)
        m = int(rng.integers(L - 12, L - 2))
        r = mutate(rng, text[a : a + m].copy(),
                   n_sub=int(rng.integers(0, 3)),
                   n_ins=int(rng.integers(0, 2)),
                   n_del=int(rng.integers(0, 2)))[:L]
        reads[i, : len(r)] = r
        lens[i] = len(r)
    return reads, lens


def _assert_equal(a, b):
    for x, y, name in zip(a, b, ["dist", "begin", "end"]):
        assert np.array_equal(np.asarray(x), np.asarray(y)), name


@pytest.mark.parametrize("L,E,C", SHAPES)
def test_pallas_verify_equals_xla(rng, L, E, C):
    assert C % TILE
    n = 5000
    text = _text_with_repeats(rng, n)
    anchors = rng.integers(0, n - L, C).astype(np.int32)
    anchors[: C // 4] = rng.integers(1000, 1600 - L, C // 4)   # tandem ties
    anchors[C // 4 : C // 4 + 20] = rng.integers(2000 - L // 2, 2300, 20)
    # text edges: windows that start before 0 and run past the end
    anchors[-6:] = [0, 1, 2, n - L, n - L // 2, n - 3]
    reads, lens = _reads_at(rng, text, anchors, L, C)
    lens[-8] = 0                                               # dead lane
    rows = np.arange(C, dtype=np.int32)
    args = (jnp.asarray(text), jnp.asarray(anchors), jnp.asarray(reads),
            jnp.asarray(rows), jnp.asarray(lens))
    a = banded_verify(*args, max_err=E)
    b = banded_verify_pallas(*args, max_err=E, interpret=True)
    _assert_equal(a, b)
    # the tandem lanes do hold ties: shifting the anchor by the repeat
    # period keeps the distance
    shifted = banded_verify(args[0], args[1] + 3, *args[2:], max_err=E)
    tie = np.asarray(shifted[0])[: C // 4] == np.asarray(a[0])[: C // 4]
    assert tie.mean() > 0.5


@pytest.mark.parametrize("L,E,C", SHAPES)
def test_pallas_hooked_verify_equals_xla_multibin(rng, L, E, C):
    """The flat-step (multi-bin) edition: both verifiers consume the SAME
    stacked per-bin text-block hook (bin_lane * ntb + brow addressing, OOB
    rows -> mismatch code) and must agree lane-for-lane."""
    B = 3
    texts = [_text_with_repeats(rng, 2700 + 128 * b) for b in range(B)]
    n_text = max(len(t) for t in texts)
    pad128 = (-n_text) % 128
    tb = np.full((B, n_text + pad128), 7, np.int8)
    for b, t in enumerate(texts):
        tb[b, : len(t)] = t
    ntb = (n_text + pad128) // 128
    tb_flat = jnp.asarray(tb.reshape(B * ntb, 128))

    bin_lane = rng.integers(0, B, C).astype(np.int32)
    anchors = np.array([rng.integers(0, len(texts[b]) - L) for b in bin_lane],
                       np.int32)
    anchors[: C // 4] = rng.integers(1000, 1600 - L, C // 4)
    # some lanes anchored at text edges (negative / past-end brows)
    anchors[:5] = [0, 1, len(texts[0]) - 10, 3, 2]
    bin_lane[:5] = [0, 1, 0, 2, 1]
    reads = np.full((C, L), 4, np.int8)
    lens = np.zeros(C, np.int32)
    for b in range(B):
        sel = np.flatnonzero(bin_lane == b)
        reads[sel], lens[sel] = _reads_at(rng, texts[b], anchors[sel], L,
                                          len(sel))
    bl = jnp.asarray(bin_lane)

    def tb_fetch(brow):
        bad = (brow < 0) | (brow >= ntb)
        r = jnp.take(tb_flat, jnp.clip(bl * ntb + brow, 0,
                                       tb_flat.shape[0] - 1), axis=0)
        return jnp.where(bad[:, None], jnp.int8(7), r)

    rows = jnp.arange(C, dtype=jnp.int32)
    a = banded_verify(None, jnp.asarray(anchors), jnp.asarray(reads), rows,
                      jnp.asarray(lens), max_err=E, tblock_fetch=tb_fetch)
    b = banded_verify_pallas_hooked(
        jnp.asarray(anchors), jnp.asarray(reads), rows, jnp.asarray(lens),
        max_err=E, tblock_fetch=tb_fetch, interpret=True)
    _assert_equal(a, b)


class _FakeDevice:
    def __init__(self, platform, stats=None):
        self.platform = platform
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("platform,kernel",
                         [("cpu", False), ("gpu", True), ("rocm", None),
                          ("metal", None)])
def test_verify_kernel_choice(monkeypatch, platform, kernel):
    """gpu -> Triton kernel, cpu -> XLA DP, anything else is refused."""
    import jax

    from dream_yara_tpu.pipeline.map_step import verify_uses_kernel

    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeDevice(platform)])
    if kernel is None:
        with pytest.raises(RuntimeError, match=platform):
            verify_uses_kernel()
    else:
        assert verify_uses_kernel() is kernel


def test_compile_cache_env_dir(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: used as is, nothing set in code."""
    import jax

    from dream_yara_tpu.cli.common import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_checkout_dir(monkeypatch):
    """Unset: <checkout>/.jax_cache, a path .gitignore lists."""
    import jax

    from dream_yara_tpu.cli.common import CHECKOUT, enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = enable_compile_cache()
        assert path == str(CHECKOUT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert ".jax_cache/" in (CHECKOUT / ".gitignore").read_text().split()


@pytest.mark.parametrize("bytes_limit,flag,builds", [
    (None, None, True),            # no stats, no flag: no budget applies
    (None, "1e-6", False),         # the flag's budget applies on the CPU
    (1000, None, False),           # budget from the device's memory stats
    (1000, "1", True),             # the flag overrides the device
])
def test_indexer_device_memory_budget(monkeypatch, tmp_path, rng, capsys,
                                      bytes_limit, flag, builds):
    import jax

    from dream_yara_tpu.cli import indexer
    from dream_yara_tpu.io.fasta import write_fasta

    stats = None if bytes_limit is None else {"bytes_limit": bytes_limit}
    monkeypatch.setattr(jax, "devices",
                        lambda *a: [_FakeDevice("cpu", stats)])
    fa = tmp_path / "b0.fa"
    write_fasta(fa, ["g0"], [random_text(rng, 4000)])
    argv = [str(fa), "-o", str(tmp_path / "db")]
    if flag is not None:
        argv += ["--hbm-gb", flag]
    if builds:
        indexer.main(argv)
        assert (tmp_path / "db" / "meta.json").exists()
    else:
        with pytest.raises(SystemExit, match="device memory"):
            indexer.main(argv)
    err = capsys.readouterr().err
    if builds and bytes_limit is None and flag is None:
        assert "no memory stats" in err
