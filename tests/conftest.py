"""Test config: run JAX on a virtual 8-device CPU mesh (SURVEY.md §4.3).

Must set env before jax is imported anywhere.
"""

import os

# The tests run on the CPU backend, also on a machine with a GPU: the
# runtime config override below pins it even if jax was imported earlier.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def random_text(rng, n, n_rate=0.0):
    """Random DNA codes with optional N fraction."""
    t = rng.integers(0, 4, size=n).astype(np.int8)
    if n_rate > 0:
        t[rng.random(n) < n_rate] = 4
    return t


def mutate(rng, read, n_sub=0, n_ins=0, n_del=0):
    """Apply random edits to a code array; returns new array."""
    read = list(np.asarray(read))
    for _ in range(n_sub):
        i = rng.integers(0, len(read))
        read[i] = (read[i] + rng.integers(1, 4)) % 4
    for _ in range(n_ins):
        i = rng.integers(0, len(read) + 1)
        read.insert(i, rng.integers(0, 4))
    for _ in range(n_del):
        i = rng.integers(0, len(read))
        del read[i]
    return np.array(read, dtype=np.int8)
