"""The synthetic transcriptome a configuration fixes, and its cache.

Two models, which a configuration's "transcriptome" names:
`make_gene_txome`, genes whose isoforms share exons, from the gene
statistics the configuration gives (transcripts a gene, exons a gene,
exon lengths by place, exon skipping); and `make_paralog_txome`, a
frozen copy of the repository's generator (lognormal lengths, paralog
families of 2-5 members that diverge by ~2 %). Neither imports the
program, so a later change to the program cannot move the yardstick.

`ensure_cache` writes, once per checkout and transcriptome (through
`build_cache`, in a process of its own):
  txome.npz   the concatenated base codes, offsets and lengths (the raw
              data the reference reads);
  index/      the program's index, built by the program's own CLI from
              a FASTA that is deleted afterwards.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _lognormal(rng, median_mean, n):
    """n draws of a lognormal given by its (median, mean)."""
    median, mean = median_mean
    sigma = float(np.sqrt(2.0 * np.log(mean / median)))
    return rng.lognormal(np.log(median), sigma, n)


def make_gene_txome(n_txps, seed, txps_per_gene, exons_per_gene, first_exon,
               internal_exon, last_exon, inclusion, min_len, exon_min):
    """(names, list of uint8 code arrays): genes whose isoforms share
    exons, until n_txps transcripts.

    A gene has max(1, round(lognormal)) exons (exons_per_gene: its
    (median, mean)), each a random sequence whose length is lognormal
    by its place (first, internal, last exon: (median, mean) each, at
    least exon_min bases), and geometric(1 / txps_per_gene) distinct
    isoforms. The first isoform holds every exon whole; each other
    keeps each internal exon with probability `inclusion` (exon
    skipping) and may start later in its first exon and end earlier in
    its last (alternative start and polyadenylation sites, up to half
    of the exon each). An isoform shorter than min_len is drawn again;
    a gene gives up on isoforms it cannot make distinct in 8 draws
    each."""
    rng = np.random.default_rng(seed)
    seqs, names = [], []
    while len(seqs) < n_txps:
        n_ex = max(1, int(round(_lognormal(rng, exons_per_gene, 1)[0])))
        lens = _lognormal(rng, internal_exon, n_ex)
        lens[0] = _lognormal(rng, first_exon, 1)[0]
        if n_ex > 1:
            lens[-1] = _lognormal(rng, last_exon, 1)[0]
        lens = np.maximum(lens.astype(np.int64), exon_min)
        exons = [rng.integers(0, 4, int(n)).astype(np.uint8) for n in lens]
        want = min(int(rng.geometric(1.0 / txps_per_gene)),
                   n_txps - len(seqs))
        seen = set()
        for draw in range(8 * want):
            if len(seen) == want:
                break
            if not seen:
                keep, lo, hi = tuple(range(n_ex)), 0, int(lens[-1])
            else:
                inner = [e for e in range(1, n_ex - 1)
                         if rng.random() < inclusion]
                keep = tuple([0] + inner + ([n_ex - 1] if n_ex > 1 else []))
                lo = int(rng.integers(0, lens[0] // 2 + 1))
                hi = int(lens[-1] - rng.integers(0, lens[-1] // 2 + 1))
            if (keep, lo, hi) in seen:
                continue
            parts = [exons[e] for e in keep]
            if len(parts) == 1:
                parts = [parts[0][lo:hi]]
            else:
                parts[0] = parts[0][lo:]
                parts[-1] = parts[-1][:hi]
            s = np.concatenate(parts)
            if s.shape[0] < min_len:
                continue
            seen.add((keep, lo, hi))
            names.append(f"SYNT{len(seqs):06d}")
            seqs.append(s)
    return names, seqs


def make_paralog_txome(n_txps, seed=7, paralog_frac=0.2, len_mu=7.2,
                       len_sigma=0.75, len_min=300, len_max=20000,
                       divergence=0.02, fam_max=5):
    """(names, list of uint8 code arrays): lognormal lengths, paralog
    families of 2 to fam_max members that diverge by `divergence`; a
    frozen copy of the repository's human-scale generator
    (scripts/make_synthetic_txome.py)."""
    rng = np.random.default_rng(seed)
    lens = np.clip(rng.lognormal(len_mu, len_sigma, n_txps).astype(np.int64),
                   len_min, len_max)
    seqs = []
    names = []
    i = 0
    while i < n_txps:
        fam = 1
        if rng.random() < paralog_frac:
            fam = int(rng.integers(2, fam_max + 1))
        fam = min(fam, n_txps - i)
        base = rng.integers(0, 4, int(lens[i])).astype(np.uint8)
        for j in range(fam):
            s = base[:int(lens[i + j])].copy()
            if s.shape[0] < lens[i + j]:
                s = np.concatenate([s, rng.integers(
                    0, 4, int(lens[i + j]) - s.shape[0]).astype(np.uint8)])
            # paralogs diverge ~2%
            if j > 0:
                nmut = max(1, int(divergence * s.shape[0]))
                at = rng.integers(0, s.shape[0], nmut)
                s[at] = (s[at] + rng.integers(1, 4, nmut)) % 4
            seqs.append(s)
            names.append(f"SYNT{i + j:06d}")
        i += fam
    return names, seqs


def clipped_lengths(codes: np.ndarray, offsets: np.ndarray,
                    min_tail: int) -> np.ndarray:
    """Each transcript's length less a trailing run of A (code 0) of
    min_tail bases or more, which a salmon index clips by default."""
    lens = np.diff(offsets)
    ends = offsets[1:]
    cand = np.ones(lens.shape[0], bool)
    for j in range(1, min_tail + 1):
        cand &= (lens >= j) & (codes[np.maximum(ends - j, 0)] == 0)
    out = lens.copy()
    for t in np.nonzero(cand)[0]:
        i = ends[t]
        while i > offsets[t] and codes[i - 1] == 0:
            i -= 1
        out[t] = i - offsets[t]
    return out


class Txome:
    """Concatenated codes (uint8), offsets (n+1,) int64 and lengths
    (n,): with `polya_clip`, each transcript's length without a
    trailing poly-A run of that many bases or more (the bases stay in
    `codes`, past the transcript's end)."""

    def __init__(self, codes, offsets, polya_clip: int = 0):
        self.codes = codes
        self.offsets = offsets
        self.lengths = (clipped_lengths(codes, offsets, polya_clip)
                        if polya_clip else np.diff(offsets))

    @property
    def n(self) -> int:
        return self.lengths.shape[0]

    def name(self, i: int) -> str:
        return f"SYNT{i:06d}"

    @staticmethod
    def load(path: str, polya_clip: int = 0) -> "Txome":
        z = np.load(path)
        return Txome(z["codes"], z["offsets"], polya_clip)


def txome_key(spec: dict) -> str:
    blob = json.dumps(spec, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:12]


def _generate(spec: dict):
    """The transcriptome of a configuration's "transcriptome" spec: its
    "model" is "genes" (make_gene_txome's arguments) or "paralogs"."""
    kw = {k: v for k, v in spec.items() if k != "model"}
    if spec["model"] == "genes":
        return make_gene_txome(**kw)
    return make_paralog_txome(
        kw["n_txps"], seed=kw["seed"], paralog_frac=kw["paralog_frac"],
        len_mu=kw["len_lognormal"][0], len_sigma=kw["len_lognormal"][1],
        len_min=kw["len_clip"][0], len_max=kw["len_clip"][1],
        divergence=kw["divergence"], fam_max=kw["family_max"])


def write_fasta(path: str, names, seqs) -> None:
    with open(path, "wb") as fh:
        for nm, s in zip(names, seqs):
            fh.write(b">" + nm.encode() + b"\n")
            b = BASES[s].tobytes()
            fh.write(b"\n".join(b[i:i + 80] for i in range(0, len(b), 80)))
            fh.write(b"\n")


def ensure_cache(cache_root: str, spec: dict, k: int, log) -> tuple:
    """(txome npz path, index dir), made on first use by `build_cache` in
    a process of its own (so that no run's peak RSS holds the
    generator's), which builds the index with `python -m
    salmon_tpu_torch index` in another that sees no GPU; a finished
    index directory carries a `done` marker."""
    d = os.path.join(cache_root, f"txome-{txome_key(spec)}")
    npz = os.path.join(d, "txome.npz")
    idx = os.path.join(d, f"index-k{k}")
    if os.path.exists(os.path.join(idx, "done")) and os.path.exists(npz):
        return npz, idx
    import salmon_tpu_torch
    roots = {os.path.dirname(os.path.dirname(os.path.abspath(f)))
             for f in (salmon_tpu_torch.__file__, __file__)}
    env = dict(os.environ, SALMON_NO_VERSION_CHECK="1",
               CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = os.pathsep.join(
        sorted(roots) + [env.get("PYTHONPATH", "")])
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "qbench.lib.txome", d,
                    json.dumps(spec), str(k)], env=env, check=True,
                   stdout=2)
    log(f"transcriptome and index built in {time.perf_counter() - t0:.1f} s")
    return npz, idx


def build_cache(d: str, spec: dict, k: int) -> None:
    os.makedirs(d, exist_ok=True)
    npz = os.path.join(d, "txome.npz")
    idx = os.path.join(d, f"index-k{k}")
    names, seqs = _generate(spec)
    lens = np.array([s.shape[0] for s in seqs], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    np.savez(npz + ".partial.npz", codes=np.concatenate(seqs),
             offsets=offsets)
    os.replace(npz + ".partial.npz", npz)
    fa = os.path.join(d, "txome.fa")
    write_fasta(fa, names, seqs)
    del seqs
    part = idx + ".partial"
    shutil.rmtree(part, ignore_errors=True)
    t1 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "salmon_tpu_torch", "index",
                    "-t", fa, "-i", part, "-k", str(k), "-p", "4"],
                   check=True, stdout=2)
    with open(os.path.join(part, "done"), "w") as fh:
        fh.write("ok\n")
    shutil.rmtree(idx, ignore_errors=True)
    os.replace(part, idx)
    os.remove(fa)
    print(f"# {len(names)} transcripts, {int(lens.sum())} bases; index "
          f"built in {time.perf_counter() - t1:.1f} s", file=sys.stderr)


if __name__ == "__main__":
    build_cache(sys.argv[1], json.loads(sys.argv[2]), int(sys.argv[3]))
