"""Option structs shared by the CLI tools.

Reproduces the reference mapper flag surface (SURVEY.md §5.6; reference
`src/misc_options.h` Options / `src/d_mapper.h` DisOptions [U]). Flag names in
cli/ mirror the reference spellings (-e/--error-rate, -y/--sensitivity, ...).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class MapperOptions:
    # Yara core options (reference Options [U])
    error_rate: float = 0.05          # -e  : max edit distance as fraction of read length
    strata_count: int = 0             # -s  : report matches within best+s error strata (0 = best stratum only; all-mapping within strata)
    sensitivity: str = "high"         # -y  : low|high|full — seeding schedule
    indels: bool = True               # -i  : allow indels (off => Hamming only)
    secondary_matches: str = "tag"    # -sm : tag|record|omit — how co-optimal matches are reported
    read_group: str = ""              # -rg : @RG ID + per-record RG:Z tag [U,M]
    library_length: int = 200         # -ll : PE expected insert size
    library_deviation: int = 100      # -ld : PE insert size deviation
    rescue: bool = True               # mate rescue on/off
    threads: int = 1                  # -t  : host-side worker threads
    reads_batch: int = 100_000        # -rb : reads per device batch
    verbose: int = 0                  # -v
    # DREAM options (reference DisOptions [U])
    number_of_bins: int = 1           # -b
    filter_type: str = "bloom"        # -ft : bloom|kmer_direct|none
    filter_file: str = ""             # -fi
    output_file: str = "-"            # -o
    # device-path options (no reference analog)
    devices: str = "auto"             # mesh spec, e.g. "auto", "cpu:8"
    bin_capacity_factor: float = 2.0  # routing capacity factor (parallel/routing.py)
    # approximate-seed backend: auto|enum|bidir. 'bidir' = search schemes on
    # the bidirectional index (needs the .rfm.npz sidecar, indexer --bidir);
    # 'auto' picks bidir when the sidecar is loaded and the batch qualifies
    # (full windows, substitution strata). DY_SEED_BACKEND overrides.
    seed_backend: str = "auto"

    def errors_for(self, read_len: int) -> int:
        """Error budget for a read: floor(len * rate), reference getReadErrors [U]."""
        return int(read_len * self.error_rate)
