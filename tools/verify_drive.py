"""Drive the product surface end-to-end (the /verify recipe, scripted).

Builds a toy 2-bin DB with the CLI tools, maps SE and PE reads through the
mapper CLI, and sanity-checks the SAM output (all planted reads mapped,
proper pairs found, long contig names formatted). Runs on the CPU backend
with the persistent compile cache so re-runs are fast.

Usage: python tools/verify_drive.py [workdir]
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from pathlib import Path


def main():
    work = Path(sys.argv[1]) if len(sys.argv) > 1 else Path(
        tempfile.mkdtemp(prefix="dyv_"))
    work.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    import numpy as np
    rng = np.random.default_rng(7)

    (work / "db").mkdir(exist_ok=True)
    longname = "contig_" + "x" * 700
    genomes = []
    for b in range(2):
        g = rng.integers(0, 4, 50000)
        genomes.append(g)
        seq = "".join("ACGT"[c] for c in g)
        name = longname if b == 0 else f"g{b}"
        (work / f"bin{b}.fna").write_text(f">{name}\n{seq}\n")

    def reads_from(g, n, rc=False):
        out = []
        comp = {0: 3, 1: 2, 2: 1, 3: 0}
        for i in range(n):
            p = int(rng.integers(0, len(g) - 400))
            r = list(g[p : p + 100])
            r2 = [comp[c] for c in reversed(g[p + 200 : p + 300])]
            out.append(("".join("ACGT"[c] for c in r),
                        "".join("ACGT"[c] for c in r2)))
        return out

    se = reads_from(genomes[0], 30) + reads_from(genomes[1], 30)
    with open(work / "se.fq", "w") as f:
        for i, (r, _) in enumerate(se):
            f.write(f"@s{i}\n{r}\n+\n{'I' * len(r)}\n")
    with open(work / "pe1.fq", "w") as f1, open(work / "pe2.fq", "w") as f2:
        for i, (r1, r2) in enumerate(se):
            f1.write(f"@p{i}\n{r1}\n+\n{'I' * len(r1)}\n")
            f2.write(f"@p{i}\n{r2}\n+\n{'I' * len(r2)}\n")

    def run(*args):
        subprocess.run(list(args), check=True, env=env, cwd=work)

    run("dream-yara-tpu-indexer", "-t", "2", "-o", "db",
        "bin0.fna", "bin1.fna")
    run("dream-yara-tpu-build-filter", "-o", "db", "-bs", "4m",
        "bin0.fna", "bin1.fna")
    run("dream-yara-tpu-mapper", "-o", "se.sam", "db", "se.fq")
    run("dream-yara-tpu-mapper", "-o", "pe.sam", "-ll", "300", "-ld", "60",
        "db", "pe1.fq", "pe2.fq")

    se_sam = (work / "se.sam").read_text()
    recs = [l.split("\t") for l in se_sam.splitlines()
            if l and not l.startswith("@")]
    mapped = [r for r in recs if int(r[1]) & 4 == 0]
    assert len(recs) == 60, len(recs)
    assert len(mapped) == 60, f"only {len(mapped)}/60 SE mapped"
    assert any(r[2] == longname for r in mapped), "long contig name lost"

    pe_sam = (work / "pe.sam").read_text()
    precs = [l.split("\t") for l in pe_sam.splitlines()
             if l and not l.startswith("@")]
    proper = [r for r in precs if int(r[1]) & 2]
    assert len(precs) == 120, len(precs)
    assert len(proper) >= 110, f"only {len(proper)}/120 proper-paired"
    tlens = {abs(int(r[8])) for r in proper}
    assert all(240 <= t <= 360 for t in tlens), sorted(tlens)[:5]
    print(f"VERIFY OK ({work}): 60/60 SE mapped, {len(proper)}/120 proper "
          f"pairs, TLENs within library window, long RNAME intact")


if __name__ == "__main__":
    main()
