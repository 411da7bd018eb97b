"""The comparison that decides `correct`.

Numbers (each against its limit in workloads/<cell>.json; lower is
better for all):
  map_answer_mismatch share of the sampled fragments (whole batches of
                      the window, drawn from the seed) whose answer from
                      the batch step differs from the plain reference's:
                      another label (the set of transcripts), or, for a
                      label of several transcripts, a normalised weight
                      off by more than the configuration's tolerance
                      from exp(-score_exp * (best - score)) normalised
                      (a family's placements share coordinates, so the
                      fragment-length factor is the same and cancels)
  eq_class_gap        the eq classes the program hands its first EM
                      against the reference's, counted from every
                      batch's labels as the batch step emitted them
                      (transcripts and range-factorisation bins):
                      (sum of |count gaps| + sum of |weight-sum gaps|)
                      / (sum of counts + weight sums), 1 where the
                      classes differ in their labels
  efflen_gap          largest relative gap between the effective
                      lengths the first EM was given and the reference's
                      from the program's fragment-length pmf
  em_numreads_gap     largest over the EM runs of sum |port - ref| /
                      sum ref of the estimated counts, the reference
                      VBEM run on the reference's eq classes with the
                      program's effective lengths and online estimate
                      for the same number of iterations (at least the
                      configuration's minimum)
The program's fragment-length pmf and online estimate are inputs of the
reference here, not judged by it. The control (`control=True`) puts the
reference in the program's place at the precision below the
configuration's: the eq classes summed in float32 (float64), a label's
weights, effective lengths and EM in bfloat16 (float32); and runs the
program with its hard filter on (a guarantee of selective alignment
broken) for the labels.

The program is read at two boundaries, by name (observe.Taps):
EquivalenceClassAccumulator.add_batch and inference.em.optimize. Where
either reads nothing, its numbers are missing and `correct` is false.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from qbench.reference import em as ref_em
from qbench.reference import eqclasses as ref_eq
from qbench.reference import mapping as ref_map

INVALID = 0x7FFFFFFF


def port_label(row: np.ndarray, to_ref: np.ndarray) -> tuple:
    ids = row[row != INVALID]
    return tuple(sorted(int(to_ref[i]) for i in ids))


def ref_weights(scores, score_exp: float, dtype=torch.float64) -> np.ndarray:
    """A label's weights by the reference, exp(-score_exp * (best -
    score)) normalised, computed in `dtype`."""
    s = torch.as_tensor(np.asarray(scores, np.float64), dtype=dtype)
    w = torch.exp(-score_exp * (s.max() - s))
    return (w / w.sum()).to(torch.float64).numpy()


def answer_mismatch(taps, pool, txome, names, params, device, log,
                    control: bool = False) -> float:
    """Share of the captured batches' fragments whose answer differs from
    the reference's: another label, or, for a label of several
    transcripts, a normalised weight off by more than
    params["weight_tolerance"]. Under the control the weights judged are
    the reference's own in bfloat16."""
    ref_index = {txome.name(i): i for i in range(txome.n)}
    to_ref = np.array([ref_index.get(n, -1) for n in names], np.int64)
    R = pool.batch
    rows, port, port_w = [], [], []
    for b in sorted(taps.batches):
        m = b % pool.members
        eq_txp, eq_w = taps.batches[b]
        for r in range(eq_txp.shape[0]):
            rows.append(m * R + r)
            port.append(port_label(eq_txp[r], to_ref))
            ok = eq_txp[r] != INVALID
            order = np.argsort(to_ref[eq_txp[r][ok]])
            w = eq_w[r][ok][order].astype(np.float64)
            port_w.append(w / w.sum() if w.size else w)
    if not rows:
        return float("nan")
    rows = np.array(rows)
    t0 = time.perf_counter()
    ref, ref_scores, summary = ref_map.reference_labels(
        pool.r1[rows], pool.r2[rows], txome, params, device)
    lack = extra = weights = 0
    for p, r, w, sc in zip(port, ref, port_w, ref_scores):
        if p != r:
            lack += bool(set(r) - set(p))
            extra += bool(set(p) - set(r))
        elif len(r) > 1:
            want = ref_weights(sc, params["score_exp"])
            got = (ref_weights(sc, params["score_exp"], torch.bfloat16)
                   if control else w)
            weights += bool(np.max(np.abs(got - want))
                            > params["weight_tolerance"])
    n = len(rows)
    diff = sum(p != r for p, r in zip(port, ref)) + weights
    log(f"labels: {n} fragments, {diff} differ: {lack} lack a reference "
        f"transcript, {extra} hold one the reference does not, {weights} "
        f"agree but weigh otherwise; {sum(1 for r in ref if r)} mapped by "
        f"the reference, {sum(1 for p in port if p)} by the program; "
        f"reference {time.perf_counter() - t0:.1f} s {summary}")
    return diff / n


def eq_and_em_gaps(taps, pmf, lengths_of_port, params, device,
                   control: bool, log) -> dict:
    """eq_class_gap, efflen_gap and em_numreads_gap of the captured EM
    runs; the reference's eq classes are counted from every batch's
    labels, and its VBEM runs on them."""
    if not taps.ems:
        return {}
    t0 = time.perf_counter()
    ref_cls = ref_eq.aggregate(taps.labels, device, torch.float64)
    first = taps.ems[0]
    eq = first["eq"]
    port_eq = ((eq.labels, eq.offsets, eq.counts, eq.weights) if not control
               else ref_eq.to_packed(ref_eq.aggregate(
                   taps.labels, device, torch.float32)))
    eq_gap = ref_eq.class_gap(port_eq, ref_cls)
    log(f"eq classes: {ref_cls[1].shape[0]} by the reference from "
        f"{int(ref_cls[1].sum())} fragments of {len(taps.labels)} batches, "
        f"{eq.num_classes} by the program; gap {eq_gap!r}; reference "
        f"{time.perf_counter() - t0:.1f} s")
    dt_answer = torch.bfloat16 if control else None
    eff_ref = ref_em.effective_lengths(lengths_of_port, pmf)
    eff_ans = (ref_em.effective_lengths(lengths_of_port, pmf, dt_answer)
               if control else first["eff_lens"])
    eff_gap = float(np.max(np.abs(eff_ans - eff_ref)
                           / np.maximum(eff_ref, 1.0)))
    labels, offsets, counts, weights = ref_eq.to_packed(ref_cls)
    gaps = []
    for run in taps.ems:
        kw = run["kw"]
        args = (labels, offsets, counts, weights, run["eff_lens"],
                kw["online_mass"], kw["total_mapped"],
                max(run["iterations"], params["min_iterations"]), params)
        t0 = time.perf_counter()
        ref = ref_em.vbem(*args, device=device, dtype=torch.float64)
        ans = (ref_em.vbem(*args, device=device, dtype=dt_answer)
               if control else run["alphas"])
        gap = float(np.abs(ans - ref).sum() / max(ref.sum(), 1e-30))
        gaps.append(gap)
        log(f"em: {run['eq'].num_classes} classes, {run['iterations']} "
            f"iterations, gap {gap!r}; reference "
            f"{time.perf_counter() - t0:.1f} s")
    return {"eq_class_gap": eq_gap, "efflen_gap": eff_gap,
            "em_numreads_gap": max(gaps)}
