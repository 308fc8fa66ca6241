"""Shared CLI helpers (analog of reference src/d_misc_options.h [U])."""

from __future__ import annotations

import sys
from pathlib import Path

FASTA_EXTS = (".fa", ".fna", ".fasta", ".fa.gz", ".fna.gz", ".fasta.gz")


def expand_bin_paths(bins: list[str], bins_dir: str | None) -> list[Path]:
    """Bin fasta list from explicit paths or a directory (sorted — bin order
    is the filename sort order, reference getFilesInDir [U])."""
    if bins_dir:
        paths = sorted(p for p in Path(bins_dir).iterdir()
                       if p.name.endswith(FASTA_EXTS))
        if not paths:
            sys.exit(f"error: no fasta files found in {bins_dir}")
        return paths
    return [Path(b) for b in bins]


def parse_size(s: str) -> int:
    """'4g' / '512m' / '65536' -> bits (reference --bloom-size spelling [U])."""
    s = s.strip().lower()
    mult = 1
    if s and s[-1] in "kmg":
        mult = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}[s[-1]]
        s = s[:-1]
    return int(float(s) * mult)


CHECKOUT = Path(__file__).resolve().parents[2]


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
    is set here; otherwise the cache lives at <checkout>/.jax_cache (a fixed
    path, so repeated runs find their entries again)."""
    import os

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    import jax

    path = str(CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def cli_guard(main_fn):
    """Convert common user errors into clean messages + exit 2 (no traceback)."""
    import functools

    @functools.wraps(main_fn)
    def wrapper(argv=None):
        try:
            return main_fn(argv)
        except FileNotFoundError as e:
            sys.exit(f"error: file not found: {e.filename or e}")
        except (ValueError, KeyError) as e:
            sys.exit(f"error: {e}")
        except KeyboardInterrupt:
            sys.exit(130)

    return wrapper


class _SamOut:
    def __init__(self, f, close):
        self.f, self._close = f, close

    def write_sam(self, text: str | bytes):
        # the underlying stream is always binary; accept str like BamWriter
        self.f.write(text.encode() if isinstance(text, str) else text)

    def close(self):
        if self._close:
            self.f.close()


def open_output(path: str):
    """SAM text to stdout/file, or BAM/BGZF when the path ends with .bam
    (reference BamFileOut chooses the format by extension [U])."""
    if path in ("-", ""):
        return _SamOut(sys.stdout.buffer, close=False)
    if path.endswith(".bam"):
        from ..io.bam import BamWriter

        return BamWriter(open(path, "wb"))
    return _SamOut(open(path, "wb"), close=True)
