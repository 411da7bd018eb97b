#!/usr/bin/env python3
"""Sparse seed candidates of the port against the JAX package's on the
5,000-transcript / 200,000-pair set of chip_smoke.py, on the CPU.

    python tools/sparse_parity_5k.py --work-dir DIR [--batches 2]

DIR is a tools/jax_reference_5k.py work directory (its syn/ set and
syn/jax_idx index; run that tool first). For the first --batches
batches of 4,096 pairs, both packages' _seed_candidates with
sparse_seed=True run on the same index and reads; the script prints, per
batch, read end and candidate field, how many entries differ (0
everywhere when the flows agree element for element).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work-dir", required=True)
    ap.add_argument("--batches", type=int, default=2)
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch
    from salmon_tpu.index import builder as jb
    from salmon_tpu.mapping import pipeline as jpipe
    from salmon_tpu_torch.index import builder as tb
    from salmon_tpu_torch.io.fastq import iter_paired_chunks
    from salmon_tpu_torch.mapping import pipeline as tpipe

    syn = os.path.join(args.work_dir, "syn")
    idx = os.path.join(syn, "jax_idx")
    jidx, tidx = jb.load_index(idx), tb.load_index(idx)
    jdev = jpipe.device_index_arrays(jidx)
    tdev = tpipe.device_index_tensors(tidx, device="cpu")
    jcfg = jpipe.MapperConfig.from_index(jidx, sparse_seed=True)
    tcfg = tpipe.MapperConfig.from_index(tidx, sparse_seed=True)
    jseed = jax.jit(jpipe._seed_candidates, static_argnums=(3,))
    chunks = iter_paired_chunks([os.path.join(syn, "reads_1.fastq")],
                                [os.path.join(syn, "reads_2.fastq")],
                                4096, 256)
    for b, chunk in zip(range(args.batches), chunks):
        ends = [chunk.left.codes, chunk.right.codes]
        lens = [chunk.left.lengths, chunk.right.lengths]
        want = jseed([jnp.asarray(e) for e in ends],
                     [jnp.asarray(n) for n in lens], jdev, jcfg)
        got = tpipe._seed_candidates([torch.from_numpy(e) for e in ends],
                                     [torch.from_numpy(n) for n in lens],
                                     tdev, tcfg)
        for e in range(2):
            fields = {k: got[e][0][k].numpy() for k in
                      ("txp", "is_fw", "score", "min_diag", "valid")}
            fields["start"] = got[e][1].numpy()
            wanted = dict(want[e][0], start=want[e][1])
            print(json.dumps({"batch": b, "end": e, "differ": {
                k: int((np.asarray(wanted[k]).astype(np.int64)
                        != v.astype(np.int64)).sum())
                for k, v in fields.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
