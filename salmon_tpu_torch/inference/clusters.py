"""ClusterForest-equivalent alpha normalization (host side).

The reference walks multimap-connected transcript clusters and projects
each transcript's online-mass-proportional share of the cluster's
fragment count into the polytope [uniqueCounts, totalCounts]
(normalizeAlphas, src/util/SalmonUtils.cpp:462-529; ClusterForest,
include/salmon/internal/quant/ClusterForest.hpp:15-100; the eXpress
projection loop, include/salmon/internal/quant/TranscriptCluster.hpp:
46-103). The result seeds the offline EM (alphas[i] = projectedCounts,
src/inference/CollapsedEMOptimizer.cpp:778-780).

Batch re-expression: the reference builds the forest online with a
mutex-guarded union-find fed by every fragment's alignment set. The
same partition is recoverable exactly from the finished equivalence
classes (every fragment's transcript set IS an eq-class label), so we
compute connected components once, on host, from the CSR label arrays
— no per-fragment synchronization anywhere.
"""

from __future__ import annotations

import numpy as np

from .eqclasses import PackedEqClasses

# reference approxEqual epsilon (SalmonMath.hpp:44,51)
_EPSILON = 0.375e-10
_MAX_ROUNDS = 5000  # TranscriptCluster.hpp:97


def unique_total_counts(eq: PackedEqClasses, num_txps: int):
    """Per-transcript unique / total fragment counts from eq classes
    (Transcript::uniqueCount / totalCount: a fragment is unique when its
    label set is a single transcript). Range-factorized strata of the
    same transcript set are independent classes, which sums the same
    fragments the reference's per-fragment counters do."""
    uniq = np.zeros(num_txps, np.float64)
    total = np.zeros(num_txps, np.float64)
    sizes = eq.class_sizes.astype(np.int64)
    seg = np.repeat(np.arange(eq.num_classes), sizes)
    per_entry_count = eq.counts[seg]
    np.add.at(total, eq.labels, per_entry_count)
    single = sizes == 1
    if single.any():
        lab1 = eq.labels[eq.offsets[:-1][single]]
        np.add.at(uniq, lab1, eq.counts[single])
    return uniq, total


def cluster_ids(eq: PackedEqClasses, num_txps: int) -> np.ndarray:
    """Connected components over transcripts sharing an eq class
    (ClusterForest::mergeClusters semantics). Returns (num_txps,) int32
    component ids; unclustered transcripts get singleton components."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    sizes = eq.class_sizes.astype(np.int64)
    multi = sizes > 1
    if not multi.any():
        return np.arange(num_txps, dtype=np.int32)
    # edges: first member of each class -> every other member
    seg = np.repeat(np.arange(eq.num_classes), sizes)
    first = eq.labels[eq.offsets[:-1]][seg]
    other = eq.labels
    keep = first != other
    rows = first[keep].astype(np.int64)
    cols = other[keep].astype(np.int64)
    g = coo_matrix((np.ones(rows.shape[0], np.int8), (rows, cols)),
                   shape=(num_txps, num_txps))
    _, comp = connected_components(g, directed=False)
    return comp.astype(np.int32)


def _project_to_polytope(projected, lo, hi, ccount, comp):
    """Vectorized eXpress projection (TranscriptCluster::projectToPolytope)
    run simultaneously for every cluster that needs it. `comp` maps each
    active transcript to a dense cluster slot; sticky bound flags and the
    unbound==0 reset follow the reference loop exactly."""
    ncl = int(ccount.shape[0])
    bound = np.zeros(projected.shape[0], bool)
    for _ in range(_MAX_ROUNDS):
        over = projected > hi
        under = projected < lo
        projected = np.where(over, hi, np.where(under, lo, projected))
        bound |= over | under
        bsum = np.bincount(comp, projected * bound, minlength=ncl)
        usum = np.bincount(comp, projected * ~bound, minlength=ncl)
        done = np.abs((bsum + usum) - ccount) <= _EPSILON
        if done.all():
            break
        # unbound mass exhausted: unbind everything and keep projecting
        reset = (~done) & (usum == 0)
        if reset.any():
            rmask = reset[comp]
            bound &= ~rmask
            usum = np.where(reset, bsum, usum)
            bsum = np.where(reset, 0.0, bsum)
        norm = np.where(~done & (usum > 0),
                        (ccount - bsum) / np.where(usum > 0, usum, 1.0),
                        1.0)
        projected = np.where(bound, projected, projected * norm[comp])
    return projected


def normalize_alphas(eq: PackedEqClasses, num_txps: int,
                     online_mass: np.ndarray) -> np.ndarray:
    """normalizeAlphas (SalmonUtils.cpp:462-529): distribute each
    cluster's fragment count over its members proportionally to online
    mass, then project into [uniqueCounts, totalCounts] where the
    proportional share leaves the polytope. Returns projectedCounts —
    the EM initialization (CollapsedEMOptimizer.cpp:778-780)."""
    if eq.num_classes == 0 or num_txps == 0:
        return np.zeros(num_txps, np.float64)
    mass = np.asarray(online_mass, np.float64)
    comp = cluster_ids(eq, num_txps)
    ncl = int(comp.max()) + 1
    # cluster fragment count (TranscriptCluster::numHits): every
    # fragment increments exactly one cluster
    first_member = eq.labels[eq.offsets[:-1]]
    ccount = np.bincount(comp[first_member], eq.counts, minlength=ncl)
    cmass = np.bincount(comp, mass, minlength=ncl)
    frac = np.where((mass > 0) & (cmass[comp] > 0),
                    mass / np.where(cmass[comp] > 0, cmass[comp], 1.0),
                    0.0)
    projected = frac * ccount[comp]

    uniq, total = unique_total_counts(eq, num_txps)
    csize = np.bincount(comp, minlength=ncl)
    needs = (projected > total) | (projected < uniq)
    needs_cluster = np.zeros(ncl, bool)
    np.logical_or.at(needs_cluster, comp, needs)
    needs_cluster &= csize > 1
    sel = needs_cluster[comp]
    if sel.any():
        # densify the selected clusters for the projection loop
        sel_comp = comp[sel]
        uniq_cl = np.unique(sel_comp)
        remap = np.zeros(ncl, np.int64)
        remap[uniq_cl] = np.arange(uniq_cl.shape[0])
        projected[sel] = _project_to_polytope(
            projected[sel], uniq[sel], total[sel], ccount[uniq_cl],
            remap[sel_comp])
    return projected
