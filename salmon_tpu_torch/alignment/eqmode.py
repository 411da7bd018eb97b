"""Eq-class input quantification mode (`quant -e <eqclasses>`).

Counterpart of salmon_tpu/alignment/eqmode.py (reference
processEqClasses / EqClassInfo / runSingleEndEqClasses,
src/alignment/SalmonQuantifyAlignments.cpp:1408-1510, and
salmon::utils::readEquivCounts). Re-quantifies from a dumped
eq_classes.txt(.gz) (written by --dumpEq/--dumpEqWeights) without
re-mapping: the parse is on the host, the EM on `device`.
"""

from __future__ import annotations

import gzip
import logging
import os
import time

import numpy as np

from salmon_tpu_torch.inference.eqclasses import PackedEqClasses

logger = logging.getLogger("salmon_tpu_torch")


def read_eq_classes(path: str):
    """Parse an eq_classes.txt(.gz) file.

    Returns (names, eff_lens_or_None, PackedEqClasses). Lines per class:
      group_size  txp_ids...  [aux_weights...]  count
    Effective lengths arrive as trailing `name  efflen` pairs after the
    class section (the reference layout, SalmonUtils.cpp:1095-1106);
    the legacy header extension (`name\\tefflen` on the name lines) is
    also read.
    """
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        n_txps = int(fh.readline())
        n_classes = int(fh.readline())
        names, eff = [], []
        name_to_i = {}
        for i in range(n_txps):
            parts = fh.readline().rstrip("\n").split("\t")
            names.append(parts[0])
            name_to_i[parts[0]] = i
            if len(parts) > 1:  # legacy header-extension efflens
                eff.append(float(parts[1]))
        labels_l, weights_l, counts_l, sizes_l = [], [], [], []
        for _ in range(n_classes):
            f = fh.readline().split()
            sz = int(f[0])
            ids = np.array(f[1:1 + sz], dtype=np.int32)
            rest = f[1 + sz:]
            if len(rest) == sz + 1:  # weights present
                w = np.array(rest[:sz], dtype=np.float64)
                count = float(rest[sz])
            elif len(rest) == 1:
                w = np.full(sz, 1.0 / sz)
                count = float(rest[0])
            else:
                raise ValueError(
                    f"malformed eq-class line (size {sz}, "
                    f"{len(rest)} trailing fields)")
            labels_l.append(ids)
            weights_l.append(w)
            counts_l.append(count)
            sizes_l.append(sz)
        # trailing effective-length section: `name efflen` pairs
        trail = np.full(n_txps, np.nan)
        n_trail = 0
        for line in fh:
            f = line.split()
            if len(f) != 2:
                continue
            i = name_to_i.get(f[0])
            if i is not None:
                trail[i] = float(f[1])
                n_trail += 1
        if n_trail == n_txps:
            eff = list(trail)
    sizes = np.array(sizes_l, dtype=np.int32)
    offsets = np.zeros(sizes.shape[0] + 1, dtype=np.int64)
    offsets[1:] = np.cumsum(sizes)
    eq = PackedEqClasses(
        labels=(np.concatenate(labels_l).astype(np.int32)
                if labels_l else np.zeros(0, np.int32)),
        weights=(np.concatenate(weights_l) if weights_l
                 else np.zeros(0)),
        offsets=offsets,
        counts=np.array(counts_l, dtype=np.float64),
        class_sizes=sizes)
    return names, (np.array(eff) if len(eff) == n_txps else None), eq


def quantify_eqclasses(args, opts, cmd_args, device) -> int:
    """CLI entry for `-e`: inference-only re-quantification, the EM on
    `device`."""
    from salmon_tpu_torch.inference import em as em_mod
    from salmon_tpu_torch.io import writers

    path = args.eqclasses
    if os.path.isdir(path):
        for cand in ("eq_classes.txt.gz", "eq_classes.txt",
                     os.path.join("aux_info", "eq_classes.txt.gz"),
                     os.path.join("aux_info", "eq_classes.txt")):
            p = os.path.join(path, cand)
            if os.path.exists(p):
                path = p
                break
    if not os.path.exists(path):
        logger.error("eq-class file not found at %s", args.eqclasses)
        return 1
    names, eff, eq = read_eq_classes(path)
    logger.info("Found total %d eqclasses and %d transcripts",
                eq.num_classes, len(names))
    n = len(names)
    if eff is None:
        logger.warning("No effective lens found in the eqclass file; "
                       "using 100 (uniform-prior mode)")
        eff = np.full(n, 100.0)

    emc = em_mod.EMConfig(
        use_vbem=opts.use_vb_opt and not opts.use_em,
        vb_prior=opts.vb_prior,
        per_transcript_prior=opts.per_transcript_prior,
        rel_diff_tolerance=opts.relative_diff_tolerance,
        max_iterations=opts.max_em_iterations,
        min_iterations=opts.min_em_iterations)
    # reference forces uniform init in eq-class mode (:1420-1424)
    t_em = time.perf_counter()
    res = em_mod.optimize(eq, n, eff, config=emc, init_uniform=True,
                          device=device)
    clocks = {"em_seconds": time.perf_counter() - t_em,
              **em_mod.loop_clocks([res])}
    logger.info("eq-class mode clocks (s): %s", clocks,
                extra={"clocks": clocks})
    counts = res["alphas"]

    out = args.output
    writers.write_quant_sf(out, names, eff.astype(np.int64), eff, counts,
                           sig_digits=opts.sig_digits)
    writers.write_cmd_info(out, cmd_args)
    writers.write_meta_info(out, opts.aux_dir, {
        "opt_type": "vb" if emc.use_vbem else "em",
        "mapping_type": "eqclass",
        "num_valid_targets": n,
        "num_eq_classes": eq.num_classes,
        "num_processed": int(eq.counts.sum()),
        "num_mapped": int(eq.counts.sum()),
        "percent_mapped": 100.0,
        "num_em_iterations": res["iterations"],
        "em_converged": res["converged"],
    })
    if args.geneMap:
        from salmon_tpu_torch.utils.genemap import aggregate_quant_sf
        aggregate_quant_sf(os.path.join(out, "quant.sf"), args.geneMap)
    logger.info("eq-class quantification written to %s", out)
    return 0
