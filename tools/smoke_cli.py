"""End-to-end CLI smoke: indexer -> build-filter -> mapper (SE + PE, SAM +
BAM) on a toy 2-bin database. Exercises the same four console entry points a
user drives (SURVEY.md §2.1), asserting every planted read maps.

Runs on the CPU backend only (it pins jax_platforms=cpu before any device
use); chip_smoke.py drives the same entry points on the GPU.
Usage: python tools/smoke_cli.py
"""

from __future__ import annotations

import gzip
import struct
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).parent.parent))

import jax

jax.config.update("jax_platforms", "cpu")

COMP = {"A": "T", "C": "G", "G": "C", "T": "A"}


def _rc(s: str) -> str:
    return "".join(COMP[c] for c in reversed(s))


def main():
    from dream_yara_tpu.cli.build_filter import main as build_filter
    from dream_yara_tpu.cli.indexer import main as indexer
    from dream_yara_tpu.cli.mapper_cli import main as mapper

    rng = np.random.default_rng(11)
    acgt = np.array(list("ACGT"))
    tmp = Path(tempfile.mkdtemp(prefix="dy_smoke_"))
    genomes = ["".join(acgt[rng.integers(0, 4, n)]) for n in (3001, 5000)]
    for b, g in enumerate(genomes):
        (tmp / f"bin_{b:05d}.fasta").write_text(f">g{b}\n{g}\n")

    n_per, L, tl = 16, 100, 260
    r1, r2 = [], []
    for b, g in enumerate(genomes):
        for i in range(n_per):
            p = int(rng.integers(0, len(g) - tl - 1))
            r1.append((f"b{b}_{i}", g[p : p + L]))
            r2.append((f"b{b}_{i}", _rc(g[p + tl - L : p + tl])))
    for fn, recs in (("r1.fq", r1), ("r2.fq", r2)):
        with open(tmp / fn, "w") as f:
            for name, s in recs:
                f.write(f"@{name}\n{s}\n+\n{'I' * len(s)}\n")

    bins = sorted(str(p) for p in tmp.glob("bin_*.fasta"))
    db = str(tmp / "db")
    indexer([*bins, "-o", db])
    build_filter([*bins, "-o", db, "-bs", "4m"])

    # SE SAM
    mapper([db, str(tmp / "r1.fq"), "-o", str(tmp / "se.sam")])
    se = (tmp / "se.sam").read_text().splitlines()
    recs = [l for l in se if l and not l.startswith("@")]
    mapped = [l for l in recs if int(l.split("\t")[1]) & 4 == 0]
    assert len(mapped) == 2 * n_per, (len(mapped), len(recs))

    # PE SAM with proper pairs
    mapper([db, str(tmp / "r1.fq"), str(tmp / "r2.fq"),
            "-ll", str(tl), "-ld", "100", "-o", str(tmp / "pe.sam")])
    pe = [l for l in (tmp / "pe.sam").read_text().splitlines()
          if l and not l.startswith("@")]
    proper = [l for l in pe if int(l.split("\t")[1]) & 2]
    assert len(pe) == 4 * n_per and len(proper) == 4 * n_per, (
        len(pe), len(proper))

    # BAM output: BGZF magic + gunzip-able + BAM1 magic
    mapper([db, str(tmp / "r1.fq"), "-o", str(tmp / "se.bam")])
    raw = (tmp / "se.bam").read_bytes()
    assert raw[:2] == b"\x1f\x8b", "not BGZF"
    inner = gzip.decompress(raw)
    assert inner[:4] == b"BAM\x01", "not BAM"
    (l_text,) = struct.unpack("<i", inner[4:8])
    assert b"@SQ" in inner[8 : 8 + l_text]

    print(f"[smoke-cli] OK: {len(mapped)} SE mapped, {len(proper)} PE proper, "
          f"BAM round-trip valid ({tmp})")


if __name__ == "__main__":
    main()
