#!/usr/bin/env python3
"""cProfile of the port's bucket-table build
(salmon_tpu_torch/index/hashtable.py::build_hash_table) over random keys.

    python3 perf_tools/profile_table_build.py [--keys 4000000] [--seed 0]
                                              [--plain]

Draws --keys unique random 62-bit keys from --seed, each with 1-4
occurrence records (a CSR of offsets), builds the table once under
cProfile and prints its seconds with the cumulative seconds of the
build's leading functions: the placement (the native table_place, or
with --plain its numpy version, whose _rank_in_bucket leads it) and the
fingerprint-shadow resolution's first_match, which both versions run in
numpy. The times are the host's CPU that runs the script.
"""

from __future__ import annotations

import argparse
import cProfile
import os
import pstats
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from salmon_tpu_torch.index import hashtable, native_kmers  # noqa: E402

FUNCS = ("build_hash_table", "table_place", "_place_keys_numpy",
         "_rank_in_bucket", "first_match")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--keys", type=int, default=4_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plain", action="store_true",
                    help="place with the numpy version, as before the "
                         "native library")
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    keys = np.unique(rng.integers(0, 1 << 62, args.keys, dtype=np.int64)
                     .astype(np.uint64))
    counts = rng.integers(1, 5, keys.size)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    if args.plain:
        def place(keys_u64, cnt, n_buckets):
            hi, lo = hashtable.split_u64(keys_u64)
            mask = np.uint32(n_buckets - 1)
            return hashtable._place_keys_numpy(
                (hashtable.mix32(hi, lo) & mask).astype(np.int64),
                (hashtable.mix32b(hi, lo) & mask).astype(np.int64), cnt,
                n_buckets)
        native_kmers.table_place = place
    else:
        native_kmers.table_place(keys[:8], counts[:8], 64)  # build, load
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    hashtable.build_hash_table(keys, occ_offsets=offsets)
    prof.disable()
    wall = time.perf_counter() - t0
    stats = pstats.Stats(prof).stats
    cum = {}
    for (_, _, name), (_, _, _, ct, _) in stats.items():
        if name in FUNCS or (name == "place" and args.plain):
            cum[name] = cum.get(name, 0.0) + ct
    print(f"{keys.size} keys, {'numpy' if args.plain else 'native'} "
          f"placement: build_hash_table {wall!r} s (profiled)")
    for name, sec in sorted(cum.items(), key=lambda kv: -kv[1]):
        print(f"  {name}: {sec!r} s cumulative")
    return 0


if __name__ == "__main__":
    sys.exit(main())
