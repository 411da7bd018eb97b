"""Human-scale mapping accuracy: map the harness cache's truth-labelled
reads (names encode readnum:txp:fragstart:fraglen) against the
200,000-transcript synthetic index and report the fraction of mapped
fragments whose eq-class label set holds the true transcript.

Counterpart of scripts/check_hs_accuracy.py.

Usage: python -m salmon_tpu_torch.scripts.check_hs_accuracy [N_BATCHES]
Env: BENCH_CACHE (hs_idx and reads), BENCH_BATCH (rows a batch, 4096).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from salmon_tpu_torch.scripts import cache_dir, require_device


def main(argv=None, device="cuda") -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    device = require_device(device, "check_hs_accuracy")

    from salmon_tpu_torch.constants import DEFAULTS
    from salmon_tpu_torch.index.builder import load_index
    from salmon_tpu_torch.io.fastq import iter_paired_chunks
    from salmon_tpu_torch.mapping.pipeline import (MapperConfig,
                                                   device_index_tensors,
                                                   map_paired_batch)
    from salmon_tpu_torch.models.fld import FragmentLengthDistribution
    from salmon_tpu_torch.utils import libformat

    cache = cache_dir()
    n_batches = int(argv[0]) if argv else 4
    R = int(os.environ.get("BENCH_BATCH", 4096))
    idx_dir = os.path.join(cache, "hs_idx")
    r1 = os.path.join(cache, "reads_1.fastq")
    r2 = os.path.join(cache, "reads_2.fastq")
    t0 = time.time()
    idx = load_index(idx_dir)
    print(f"# index: {idx.num_targets} txps, "
          f"{idx.kmers.shape[0] / 1e6:.0f}M kmers, "
          f"loaded {time.time() - t0:.0f}s", file=sys.stderr, flush=True)
    name_to_id = {nm: i for i, nm in enumerate(idx.names)}

    cfg = MapperConfig.from_index(idx)
    dev = device_index_tensors(idx, device)
    fld = FragmentLengthDistribution(max_val=DEFAULTS.max_frag_length)
    fld_logpmf = torch.as_tensor(fld.log_pmf(), dtype=torch.float32,
                                 device=device)
    fmt = libformat.parse_library_format("IU")
    cp = torch.as_tensor(libformat.paired_compat_table(fmt), device=device)
    co = torch.as_tensor(libformat.orphan_compat_table(fmt), device=device)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    n_frag = n_hit = n_mapped = 0
    chunks = iter_paired_chunks([r1], [r2], R, DEFAULTS.max_read_len,
                                want_names=True)
    t0 = time.time()
    for bi, chunk in enumerate(chunks):
        if bi >= n_batches:
            break
        batch = {"codes_l": put(chunk.left.codes),
                 "lengths_l": put(chunk.left.lengths),
                 "codes_r": put(chunk.right.codes),
                 "lengths_r": put(chunk.right.lengths)}
        out = map_paired_batch(batch, dev, cfg, fld_logpmf, cp, co)
        eq = out["eq_txp"].cpu().numpy()
        names = chunk.left.names
        for r in range(chunk.n_valid):
            true_t = name_to_id.get(
                names[r].decode().split(":")[1], -1)
            labels = eq[r][eq[r] < 2**31 - 1]
            n_frag += 1
            if labels.size:
                n_mapped += 1
                n_hit += bool((labels == true_t).any())
        print(f"# batch {bi}: cum mapped {n_mapped}/{n_frag}, "
              f"true-in-labelset {n_hit}/{n_mapped} "
              f"({time.time() - t0:.0f}s)", file=sys.stderr, flush=True)
    print({"fragments": n_frag,
           "mapped_frac": round(n_mapped / max(n_frag, 1), 4),
           "true_in_labels_frac": round(n_hit / max(n_mapped, 1), 4)},
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
