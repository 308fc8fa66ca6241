"""dream-yara-tpu-mapper — map reads against the DREAM database.

Analog of reference src/d_mapper.cpp [U] (SURVEY.md §2.1/§3.1). Flag surface
mirrors the reference spellings (SURVEY.md §5.6): -e/--error-rate,
-s/--strata-count, -y/--sensitivity, -sm/--secondary-matches,
-ll/--library-length, -ld/--library-deviation, -t/--threads,
-rb/--reads-batch, -ft/--filter-type, -o/--output-file, -v/--verbose.
"""

from __future__ import annotations

import argparse

from .common import cli_guard as __cli_guard
import sys
import time


@__cli_guard
def main(argv=None):
    p = argparse.ArgumentParser(
        prog="dream-yara-tpu-mapper",
        description="DREAM read mapper on a JAX device (SE or PE).")
    p.add_argument("db_dir", help="database directory from the indexer")
    p.add_argument("reads", help="FASTQ (optionally .gz)")
    p.add_argument("reads2", nargs="?", default=None, help="mate FASTQ (PE mode)")
    p.add_argument("-o", "--output-file", default="-")
    p.add_argument("-e", "--error-rate", type=float, default=0.05,
                   help="max errors as fraction of read length")
    p.add_argument("-s", "--strata-count", type=int, default=0)
    p.add_argument("-y", "--sensitivity", default="high",
                   choices=["low", "high", "full"])
    p.add_argument("-rg", "--read-group", default="",
                   help="@RG ID; per-record RG:Z tag when set")
    p.add_argument("-sm", "--secondary-matches", default="tag",
                   choices=["tag", "record", "omit"])
    p.add_argument("-i", "--indels", default="on", choices=["on", "off"])
    p.add_argument("-ll", "--library-length", type=int, default=200)
    p.add_argument("-ld", "--library-deviation", type=int, default=100)
    p.add_argument("--no-rescue", action="store_true")
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-rb", "--reads-batch", type=int, default=100_000)
    p.add_argument("-ft", "--filter-type", default="bloom",
                   choices=["bloom", "kmer_direct", "none"])
    p.add_argument("--output-shards", default=None, metavar="DIR",
                   help="crash-safe mode: write one idempotent SAM shard per "
                        "batch into DIR (atomic rename + manifest); "
                        "re-running the same command resumes after the last "
                        "committed shard and then assembles -o from the "
                        "shards (io/shards.py, failure recovery)")
    p.add_argument("-v", "--verbose", action="count", default=0)
    # distributed runtime (SURVEY.md §5.8): --mesh runs the (data, bin)
    # device mesh on all local devices; the coordinator flags join a
    # multi-host jax.distributed run (bins sharded across hosts, SAM from
    # process 0)
    p.add_argument("--mesh", action="store_true",
                   help="map on the multi-device (data, bin) mesh")
    p.add_argument("--coordinator", default=None,
                   help="host:port of jax.distributed process 0")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    a = p.parse_args(argv)

    from .common import enable_compile_cache

    enable_compile_cache()

    if a.coordinator is not None:
        from ..parallel.multihost import init_multihost
        init_multihost(a.coordinator, a.num_processes, a.process_id)

    from ..io.fastq import FastqBatchReader
    from ..pipeline.dis_mapper import DreamIndex, dream_map_sam
    from ..utils.options import MapperOptions
    from ..utils.timer import StageTimers

    opts = MapperOptions(
        error_rate=a.error_rate, strata_count=a.strata_count,
        sensitivity=a.sensitivity, secondary_matches=a.secondary_matches,
        indels=a.indels == "on", library_length=a.library_length,
        library_deviation=a.library_deviation, rescue=not a.no_rescue,
        threads=a.threads, reads_batch=a.reads_batch,
        filter_type=a.filter_type, output_file=a.output_file,
        read_group=a.read_group, verbose=a.verbose)

    t0 = time.time()
    timers = StageTimers()
    if a.coordinator is not None:
        from ..parallel.multihost import MultiHostDreamMapper

        mh = MultiHostDreamMapper(a.db_dir, opts, filter_type=a.filter_type)
        timers.add("load index (bin shard)", time.time() - t0)
        from .common import open_output

        reader = FastqBatchReader(a.reads, a.reads2, batch_size=a.reads_batch)
        out = open_output(a.output_file)
        stats = {}
        header = True
        t0 = time.time()
        for batch in reader:
            sam = mh.map_sam(batch, cmdline=" ".join(sys.argv[1:]),
                             timers=timers, header=header, stats=stats)
            header = False
            if sam is not None:
                out.write_sam(sam)
        out.close()
        dt = time.time() - t0
        n_reads = stats.get("reads", 0)
        print(f"[mapper p{a.process_id}] {n_reads} reads in {dt:.1f}s "
              f"({n_reads / max(dt, 1e-9):.0f} reads/s)", file=sys.stderr)
        if a.verbose:
            print(timers.report(), file=sys.stderr)
        return

    index = DreamIndex.load(a.db_dir, filter_type=a.filter_type)
    timers.add("load index", time.time() - t0)
    if a.mesh:
        import jax

        from ..parallel.dream_mesh import MeshDreamMapper, mesh_dream_sam

        from .common import open_output

        mm = MeshDreamMapper(index, opts)
        reader = FastqBatchReader(a.reads, a.reads2, batch_size=a.reads_batch)
        stats = {}
        t0 = time.time()
        if a.output_shards:
            from ..io.shards import drive_sharded_stream
            from ..pipeline.writer import sam_header

            cmdline = " ".join(argv if argv is not None else sys.argv[1:])
            text = drive_sharded_stream(
                reader, a.output_shards,
                "\n".join(sam_header(index.contigs, cmdline,
                                      read_group=opts.read_group or None))
                + "\n",
                lambda bs: (mesh_dream_sam(mm, b, timers=timers, header=False,
                                           stats=stats) for b in bs),
                a.output_file)
            if text is not None:
                sys.stdout.buffer.write(text)
        else:
            cmdline = " ".join(argv if argv is not None else sys.argv[1:])
            out = open_output(a.output_file)
            header = True
            for batch in reader:
                out.write_sam(mesh_dream_sam(mm, batch, timers=timers,
                                             header=header, stats=stats,
                                             cmdline=cmdline))
                header = False
            out.close()
        dt = time.time() - t0
        n_reads = stats.get("reads", 0)
        print(f"[mapper mesh={dict(mm.mesh.shape)}] {n_reads} reads in "
              f"{dt:.1f}s ({n_reads / max(dt, 1e-9):.0f} reads/s)",
              file=sys.stderr)
        if a.verbose:
            print(timers.report(), file=sys.stderr)
        return

    from .common import open_output

    reader = FastqBatchReader(a.reads, a.reads2, batch_size=a.reads_batch)
    n_reads = 0
    stats: dict = {}
    t0 = time.time()
    cmdline = " ".join(argv if argv is not None else sys.argv[1:])
    from ..pipeline.dis_mapper import dream_map_stream

    if a.output_shards:
        # crash-safe sharded mode (SURVEY §5.3): per-batch atomic shards +
        # manifest; resume skips committed input and finalize assembles -o
        from ..io.shards import drive_sharded_stream
        from ..pipeline.writer import sam_header

        text = drive_sharded_stream(
            reader, a.output_shards,
            "\n".join(sam_header(index.contigs, cmdline,
                                      read_group=opts.read_group or None))
                + "\n",
            lambda bs: dream_map_stream(index, bs, opts, cmdline=cmdline,
                                        timers=timers, stats=stats,
                                        header=False),
            a.output_file)
        if text is not None:
            sys.stdout.buffer.write(text)
        n_reads = stats.get("reads", 0)
    else:
        out = open_output(a.output_file)

        def counted():
            nonlocal n_reads
            for batch in reader:
                yield batch

        try:
            for i, sam in enumerate(dream_map_stream(
                    index, counted(), opts, cmdline=cmdline, timers=timers,
                    stats=stats)):
                out.write_sam(sam)
                n_reads = stats.get("reads", 0)
                if a.verbose:
                    print(f"[mapper] batch {i} done "
                          f"({n_reads / (time.time() - t0):.0f} reads/s cum)",
                          file=sys.stderr)
        finally:
            out.close()
    dt = time.time() - t0
    # final stats block (reference appendStats / --verbose report [U])
    mapped = stats.get("mapped", 0)
    unique = stats.get("unique", 0)
    print(f"[mapper] {n_reads} reads in {dt:.1f}s "
          f"({n_reads / max(dt, 1e-9):.0f} reads/s)", file=sys.stderr)
    if n_reads:
        line = (f"[mapper] mapped: {mapped} ({100.0 * mapped / n_reads:.2f}%)  "
                f"unique: {unique} ({100.0 * unique / n_reads:.2f}%)")
        if "proper_pairs" in stats:
            pp = stats["proper_pairs"]
            line += f"  proper pairs: {pp} ({200.0 * pp / n_reads:.2f}%)"
        print(line, file=sys.stderr)
    if a.verbose:
        print(timers.report(), file=sys.stderr)


if __name__ == "__main__":
    main()
