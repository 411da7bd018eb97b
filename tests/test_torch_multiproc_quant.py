"""The port's CLI under a multi-process launch on the CPU (gloo), on the
sample pairs (10,000):

- `quant --indexShards 2` on 2 ranks: quant.sf within the golden
  tolerance (rtol 5e-3 / atol 0.5) of the JAX CLI's in-process
  --indexShards 2 run, and eq classes (labels and counts) equal to the
  port's single-rank sparse run (the sharded seeding equals the sparse
  flow's; with one reads group the steps are the single run's);
- the same on a table-less copy of the index: equal to the
  table-bearing sharded run, where one rank alone raises; and on the
  table-less index of the port's own partitioned build: equal to the
  copy's run, and raising alone too;
- `python -m salmon_tpu_torch.parallel.launch`: data-parallel
  --seqBias --gcBias on 2 ranks, from 3 unequal input files (each rank
  streams its own, the ends agreed by the has-data vote), against the
  single-rank run (NumReads within 1.0, effective lengths within 0.5,
  as tests/test_multihost.py holds the JAX package), every fragment
  processed once, each rank writing its own unmapped names;
- --indexShards 2 in one process raises JAX's ValueError; the
  multi-process chunk policy, and 2 ranks whose chunks differ in width
  at a step give the single-rank run's eq classes.
"""

import dataclasses
import gzip
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_parallel import run_ranks
from test_torch_quant import assert_quant_sf_close

from salmon_tpu import cli as jcli
from salmon_tpu_torch import cli
from salmon_tpu_torch import quant as tquant
from salmon_tpu_torch.index import builder as tbuilder
from salmon_tpu_torch.index.builder import load_index, save_index
from salmon_tpu_torch.io import fastq as tfastq
from salmon_tpu_torch.io.writers import read_quant_sf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
R1, R2 = (os.path.join(DATA, f"reads_{i}.fastq") for i in (1, 2))
READS = ["-1", R1, "-2", R2]


def _quant(argv, device="cpu"):
    assert cli.main(["quant", *argv, "-q"], device=device) == 0


def _cli_worker(world, runs):
    torch.set_num_threads(1)
    for argv in runs:
        _quant(argv)


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """(index, table-less copy of it, table-less index of the port's
    partitioned build), all saved by the port, k 31."""
    base = tmp_path_factory.mktemp("idx")
    idx, tl, ptl = (str(base / n) for n in ("idx", "tl", "ptl"))
    fasta = os.path.join(DATA, "transcripts.fasta")
    assert cli.main(["index", "-t", fasta, "-i", idx, "-k", "31"]) == 0
    save_index(dataclasses.replace(load_index(idx), table=None), tl)
    assert load_index(tl).table is None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbuilder, "TABLE_DIRECT_MAX_KEYS", 0)
        save_index(tbuilder.build_index(fasta, k=31, partition_bits=2), ptl)
    assert load_index(ptl).info["requires_shards"]
    return idx, tl, ptl


@pytest.fixture(scope="module")
def runs(indexes, tmp_path_factory):
    """Output directories: 2-rank runs (sharded, sharded table-less) and
    the single-rank references."""
    idx, tl, ptl = indexes
    base = tmp_path_factory.mktemp("runs")
    out = {n: str(base / n) for n in ("sh2", "sh2_tl", "sh2_ptl", "sparse",
                                      "bias")}
    run_ranks(_cli_worker, 2, [
        ["-i", i, "-l", "IU", *READS, "--indexShards", "2", "--dumpEq",
         "-o", out[name]]
        for name, i in (("sh2", idx), ("sh2_tl", tl), ("sh2_ptl", ptl))])
    mp = pytest.MonkeyPatch()
    mp.setenv("SALMON_TPU_SPARSE_SEED", "1")
    try:
        _quant(["-i", idx, "-l", "IU", *READS, "--dumpEq", "-o",
                out["sparse"]])
    finally:
        mp.undo()
    _quant(["-i", idx, "-l", "IU", *READS, "--seqBias", "--gcBias", "-o",
            out["bias"]])
    return out


def _lines(path):
    with open(path) as fh:
        return fh.readlines()


def _eq_lines(out):
    with gzip.open(os.path.join(out, "aux_info", "eq_classes.txt.gz"),
                   "rt") as fh:
        return fh.readlines()


def _meta(out):
    with open(os.path.join(out, "aux_info", "meta_info.json")) as fh:
        return json.load(fh)


def test_sharded_quant_matches_jax_sharded_run(indexes, runs,
                                               tmp_path):
    jout = str(tmp_path / "jax")
    assert jcli.main(["quant", "-i", indexes[0], "-l", "IU", *READS,
                      "--indexShards", "2", "-q", "--no-version-check",
                      "-o", jout]) == 0
    assert_quant_sf_close(_lines(os.path.join(runs["sh2"], "quant.sf")),
                          _lines(os.path.join(jout, "quant.sf")))
    meta, jmeta = _meta(runs["sh2"]), _meta(jout)
    for key in ("num_processed", "num_mapped", "library_types"):
        assert meta[key] == jmeta[key], key
    assert meta["num_processed"] == 10000


def test_sharded_quant_equals_single_rank_sparse(runs):
    got, want = _eq_lines(runs["sh2"]), _eq_lines(runs["sparse"])
    assert len(got) > 40 and got == want
    assert_quant_sf_close(_lines(os.path.join(runs["sh2"], "quant.sf")),
                          _lines(os.path.join(runs["sparse"], "quant.sf")))


def test_tableless_index(indexes, runs, tmp_path):
    """Without shards a table-less index raises JAX's ValueError; with
    --indexShards 2 it quantifies exactly as the table-bearing index."""
    with pytest.raises(ValueError, match="--indexShards"):
        _quant(["-i", indexes[1], "-l", "IU", *READS, "-o",
                str(tmp_path / "q")])
    assert _eq_lines(runs["sh2_tl"]) == _eq_lines(runs["sh2"])
    assert _lines(os.path.join(runs["sh2_tl"], "quant.sf")) == \
        _lines(os.path.join(runs["sh2"], "quant.sf"))


def test_partitioned_tableless_index(indexes, runs, tmp_path):
    """The port's own partitioned table-less index (unaligned CSR, no
    pad plane) raises JAX's ValueError without shards, and under
    --indexShards 2 quantifies exactly as the table-less copy."""
    with pytest.raises(ValueError, match="--indexShards"):
        _quant(["-i", indexes[2], "-l", "IU", *READS, "-o",
                str(tmp_path / "q")])
    assert _eq_lines(runs["sh2_ptl"]) == _eq_lines(runs["sh2_tl"])
    assert _lines(os.path.join(runs["sh2_ptl"], "quant.sf")) == \
        _lines(os.path.join(runs["sh2_tl"], "quant.sf"))


def test_index_shards_need_as_many_processes(indexes, tmp_path):
    with pytest.raises(ValueError, match="1 devices not divisible by 2 "
                                         "index shards"):
        _quant(["-i", indexes[0], "-l", "IU", *READS, "--indexShards", "2",
                "-o", str(tmp_path / "q")])


def _assert_close_to_single(got_dir, want_dir, d_reads, d_eff=None):
    a, b = read_quant_sf(os.path.join(want_dir, "quant.sf")), \
        read_quant_sf(os.path.join(got_dir, "quant.sf"))
    assert a["Name"] == b["Name"]
    d = np.abs(np.asarray(a["NumReads"]) - np.asarray(b["NumReads"])).max()
    assert d <= d_reads, d
    if d_eff is not None:
        de = np.abs(np.asarray(a["EffectiveLength"], float)
                    - np.asarray(b["EffectiveLength"], float)).max()
        assert de <= d_eff, de
    assert _meta(got_dir)["num_processed"] == 10000


def _split_fastq(src, dst, sizes):
    with open(src) as fh:
        recs = fh.read().splitlines()
    paths, at = [], 0
    for j, n in enumerate(sizes):
        p = f"{dst}_{j}.fastq"
        with open(p, "w") as fh:
            fh.write("\n".join(recs[4 * at:4 * (at + n)]) + "\n")
        paths.append(p)
        at += n
    return paths


def test_launcher_data_parallel_bias_matches_single_rank(indexes, runs,
                                                        tmp_path):
    sizes = [4000, 3500, 2500]
    r1s = _split_fastq(R1, str(tmp_path / "r1"), sizes)
    r2s = _split_fastq(R2, str(tmp_path / "r2"), sizes)
    out = str(tmp_path / "q")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    proc = subprocess.run(
        [sys.executable, "-m", "salmon_tpu_torch.parallel.launch",
         "--nprocs", "2", "--device", "cpu", "--", "quant", "-i",
         indexes[0], "-l", "IU", "-1", *r1s, "-2", *r2s, "--seqBias",
         "--gcBias", "--writeUnmappedNames", "-o", out, "-q"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "reads group 1 streams 1 input files" in proc.stderr
    _assert_close_to_single(out, runs["bias"], 1.0, 0.5)
    meta = _meta(out)
    assert meta["seq_bias_correct"] and meta["gc_bias_correct"]
    assert {"unmapped_names.txt.0", "unmapped_names.txt.1"} <= \
        set(os.listdir(os.path.join(out, "aux_info")))


def test_group_chunks_of_a_shared_stream():
    """Group g maps the g-th chunk of every n_groups (the stream packs
    only those; the others come as None); the missing tail chunk is an
    empty one (no collective on a shared stream)."""
    streams = (["a", None, "c"], [None, "b", None])
    got = [list(tquant._group_chunks(iter(streams[g]), g, 2, False,
                                     lambda: "-")) for g in (0, 1)]
    assert got == [["a", "c"], ["b", "-"]]
    empty = tquant._empty_chunk(True, 8, 64, True)
    assert empty.n_valid == 0 and empty.left.codes.shape == (8, 64)
    assert not empty.left.lengths.any() and empty.left.names == []
    picked = list(tfastq.iter_paired_chunks([R1], [R2], 4096, 256,
                                            pick=lambda i: i % 2 == 1))
    assert picked[0] is None and picked[2] is None
    assert picked[1].left.n_valid == 4096


def _write_pairs(path1, path2, n, read_len, seed):
    """n read pairs of read_len bases drawn from the sample transcripts
    (inward mates of 150-300-base fragments), from a seeded generator."""
    with open(os.path.join(DATA, "transcripts.fasta")) as fh:
        txps = [b.split("\n", 1)[1].replace("\n", "")
                for b in fh.read().split(">")[1:]]
    txps = [t for t in txps if len(t) >= 300]
    comp = str.maketrans("ACGT", "TGCA")
    rng = np.random.default_rng(seed)
    with open(path1, "w") as f1, open(path2, "w") as f2:
        for i in range(n):
            t = txps[rng.integers(len(txps))]
            flen = int(rng.integers(150, 301))
            p = int(rng.integers(0, len(t) - flen + 1))
            frag = t[p:p + flen]
            right = frag[-read_len:].translate(comp)[::-1]
            q = "I" * read_len
            f1.write(f"@s{i}/1\n{frag[:read_len]}\n+\n{q}\n")
            f2.write(f"@s{i}/2\n{right}\n+\n{q}\n")


def test_groups_with_chunks_of_different_widths(indexes, tmp_path):
    """2 data-parallel ranks streaming their own files, whose chunks
    differ in width at the same step (64 columns for the sample's 50-base
    reads, 96 for 80-base reads; then 64 against an empty chunk), give
    the eq classes of the single-rank run of the same files."""
    r1s = _split_fastq(R1, str(tmp_path / "a1"), [5000])
    r2s = _split_fastq(R2, str(tmp_path / "a2"), [5000])
    b1, b2 = str(tmp_path / "b_1.fastq"), str(tmp_path / "b_2.fastq")
    _write_pairs(b1, b2, 3000, 80, seed=7)
    assert [c.left.codes.shape[1] for c in tfastq.iter_paired_chunks(
        [r1s[0], b1], [r2s[0], b2], 4096, 256)] == [64, 96]
    argv = ["-i", indexes[0], "-l", "IU", "-1", r1s[0], b1, "-2", r2s[0],
            b2, "--dumpEq"]
    two, one = str(tmp_path / "two"), str(tmp_path / "one")
    run_ranks(_cli_worker, 2, [[*argv, "-o", two]])
    _quant([*argv, "-o", one])
    assert _meta(two)["num_processed"] == 8000
    got, want = sorted(_eq_lines(two)), sorted(_eq_lines(one))
    assert len(got) > 40 and got == want
