"""dream_yara_tpu — accelerator-native distributed short-read DNA mapper.

A from-scratch rebuild of the capabilities of DREAM-Yara (temehi/dream_yara;
see SURVEY.md): an Interleaved Bloom Filter prefilter routes read batches to
partitioned reference bins; per-bin FM-index seed search and banded Myers
edit-distance verification run as JAX/Pallas kernels on the device; bins are sharded
over a `jax.sharding.Mesh` with capacity-bucketed routing and collective match
merge; output is SAM (flags, CIGAR, MAPQ, NM) per the contract in
docs/OUTPUT_CONTRACT.md, and single bins can be rebuilt without touching the
rest of the database.

Layer map (device-native analog of SURVEY.md §1):
  utils/     — alphabet codes, 2-bit packing, timers, options      (ref: src/basic_alphabet.h, misc_*.h [U])
  io/        — FASTA/FASTQ/SAM codecs, contig + read stores        (ref: src/store_seqs.h, bits_reads.h, file_pair.h [U])
  index/     — suffix array, BWT/FM occ tables, IBF, kdx filter    (ref: SeqAn FMIndex, src/d_bloom_filter.h [U])
  ops/       — device kernels: rank/backward-search, Myers, IBF    (ref: hot loops in mapper_filter.h / find_extender.h [U])
  pipeline/  — mapper stages: seed, extend, rank, pair, SAM write  (ref: src/mapper_*.h [U])
  parallel/  — mesh, bin routing, match merge collectives          (ref: none — OpenMP in reference; SURVEY.md §2.10)
  golden/    — pure-NumPy oracle of the whole pipeline             (test strategy, SURVEY.md §4)
  cli/       — the four tools: indexer, build_filter, update_filter, mapper
  native/    — C++ components (SA-IS suffix sort, FASTQ codec) via ctypes
"""

__version__ = "0.1.0"
