"""The one read generator: a traffic mix is a JSON file of parameters.

Keys of a mix (qbench/traffic/<mix>.json):
  pool_pairs        fragments in the pool, rounded up to whole batches;
                    the stream cycles the pool
  read_len          bases per mate
  frag_mean, frag_sd, frag_min
                    fragment lengths N(mean, sd), clipped to
                    [frag_min, transcript length] and truncated to int
  error_rate        per-base substitution rate of each mate
  expression_sigma, expression_seed, min_txp_len
                    transcript weights lognormal(0, sigma) x length,
                    zero below min_txp_len; drawn from expression_seed,
                    so that every run's seed draws from one profile
  offtarget_share   share of fragments drawn from a background sequence
                    that is not in the index
  offtarget_bases, offtarget_seed
                    the background sequence's length and seed

The fragment model is the repository's generator's
(scripts/make_synthetic_txome.py make_reads), vectorised: mate 1 is the
transcript's forward strand at the fragment start, mate 2 the reverse
complement of its end, and each base of each mate is substituted with
probability error_rate (the original draws a binomial count of
positions with replacement; both give a binomial number of errors).
"""

from __future__ import annotations

import dataclasses
import os
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
NAME_DIGITS = 10


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """A generator for (seed, stream); any whole number is a seed."""
    return np.random.default_rng(
        np.random.SeedSequence([seed % (1 << 64), seed < 0, stream]))


@dataclasses.dataclass
class Pool:
    r1: np.ndarray          # (n, read_len) uint8 codes, mate 1
    r2: np.ndarray          # (n, read_len) uint8 codes, mate 2
    batch: int              # fragments per gzip member (= per batch)

    @property
    def n(self) -> int:
        return self.r1.shape[0]

    @property
    def members(self) -> int:
        return self.n // self.batch


def expression(txome, mix: dict) -> np.ndarray:
    rng = np.random.default_rng(mix["expression_seed"])
    lens = txome.lengths.astype(np.float64)
    p = np.where(lens >= mix["min_txp_len"], lens, 0.0)
    expr = rng.lognormal(0, mix["expression_sigma"], txome.n) * p
    return expr / expr.sum()


def _fragments(rng, seq, off, lens, picks, mix):
    rl = mix["read_len"]
    L = lens[picks]
    fl = np.clip(rng.normal(mix["frag_mean"], mix["frag_sd"], picks.shape[0]),
                 mix["frag_min"], L).astype(np.int64)
    st = rng.integers(0, L - fl + 1)
    cols = np.arange(rl, dtype=np.int64)
    left = seq[(off[picks] + st)[:, None] + cols]
    right = 3 - seq[(off[picks] + st + fl - rl)[:, None] + cols][:, ::-1]
    return left, np.ascontiguousarray(right)


def _mutate(rng, r: np.ndarray, rate: float) -> None:
    hit = rng.random(r.shape) < rate
    r[hit] = (r[hit] + rng.integers(1, 4, int(hit.sum()))) % 4


def make_pool(txome, mix: dict, seed: int, batch: int) -> Pool:
    """The pool of `seed`: fragments in stream order."""
    n = -(-int(mix["pool_pairs"]) // batch) * batch
    rng = seed_rng(seed, 1)
    off_n = int(round(n * float(mix.get("offtarget_share", 0.0))))
    on = rng.permutation(n) >= off_n      # which slots are on target
    n_on = int(on.sum())
    rl = mix["read_len"]
    r1 = np.empty((n, rl), np.uint8)
    r2 = np.empty((n, rl), np.uint8)
    picks = rng.choice(txome.n, size=n_on, p=expression(txome, mix))
    r1[on], r2[on] = _fragments(rng, txome.codes, txome.offsets[:-1],
                                txome.lengths, picks, mix)
    if off_n:
        bg = np.random.default_rng(mix["offtarget_seed"]).integers(
            0, 4, int(mix["offtarget_bases"])).astype(np.uint8)
        r1[~on], r2[~on] = _fragments(
            rng, bg, np.zeros(1, np.int64), np.array([bg.shape[0]]),
            np.zeros(off_n, np.int64), mix)
    _mutate(rng, r1, mix["error_rate"])
    _mutate(rng, r2, mix["error_rate"])
    return Pool(r1, r2, batch)


def fastq_bytes(codes: np.ndarray, first: int) -> bytes:
    """Uncompressed FASTQ of `codes` ((n, L) uint8), records named by
    their stream index from `first`, all of one fixed layout."""
    n, L = codes.shape
    rec = 1 + NAME_DIGITS + 1 + L + 3 + L + 1
    out = np.empty((n, rec), np.uint8)
    out[:, 0] = ord("@")
    idx = np.arange(first, first + n, dtype=np.int64)
    for j in range(NAME_DIGITS):
        out[:, NAME_DIGITS - j] = 48 + (idx // 10 ** j) % 10
    c = NAME_DIGITS + 1
    out[:, c] = 10
    out[:, c + 1:c + 1 + L] = BASES[codes]
    c += 1 + L
    out[:, c:c + 3] = np.frombuffer(b"\n+\n", np.uint8)
    out[:, c + 3:c + 3 + L] = ord("I")
    out[:, -1] = 10
    return out.tobytes()


def _gzip_member(raw: bytes) -> bytes:
    z = zlib.compressobj(1, zlib.DEFLATED, 31)
    return z.compress(raw) + z.flush()


def gzip_members(pool: Pool, mate: int, threads: int = 4) -> list:
    """One gzip member per batch of the pool, for mate 1 or 2."""
    codes = pool.r1 if mate == 1 else pool.r2
    B = pool.batch

    def one(m):
        return _gzip_member(fastq_bytes(codes[m * B:(m + 1) * B], m * B))

    with ThreadPoolExecutor(max_workers=max(1, min(threads,
                                                   os.cpu_count() or 1))) as ex:
        return list(ex.map(one, range(pool.members)))
