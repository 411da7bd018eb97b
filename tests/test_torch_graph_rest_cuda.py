"""The last compiled programs on the card: the `-a` error model's five
steps, the --indexShards map step (two graphs around the hit all-gather,
2 ranks sharing the card over gloo) and config 5's B1 and B2, each
through its CUDA graphs against its eager body (`*_impl`) on the same
inputs, with the checks of salmon_tpu_torch/scripts/bench_graph_rest.py:
the error model's keys and log-likelihoods exactly, the sharded step's
integer outputs and config 5's eq classes exactly; counts within rtol
1e-5 or the rounding of a float32 sum of their terms in another order,
masses and weights within rtol 1e-5 or twice what two eager runs differ
by where that is more (float index_add_ adds in no fixed order on the
card). A capture that fails raises, naming the step's signature.
Every test here needs an NVIDIA GPU and skips without one; the file
imports nothing of JAX, so it runs on a GPU machine that has none:

    python -m pytest --noconftest -m cuda tests/test_torch_graph_rest_cuda.py
"""

import os

import pytest
import torch
import torch.multiprocessing as mp

from salmon_tpu_torch.alignment import errormodel_device as emd
from salmon_tpu_torch.alignment.bamio import write_bam
from salmon_tpu_torch.index import builder as tb
from salmon_tpu_torch.io.fasta import load_transcripts
from salmon_tpu_torch.parallel import distributed
from salmon_tpu_torch.parallel.launch import free_port
from salmon_tpu_torch.scripts import bench_graph_rest as rest
from salmon_tpu_torch.scripts import demo_config5_quant as demo
from salmon_tpu_torch.utils.graphcache import GraphCache

DATA = os.path.join(os.path.dirname(__file__), "data")
FASTA = os.path.join(DATA, "transcripts.fasta")
READS = tuple(os.path.join(DATA, f"reads_{i}.fastq") for i in (1, 2))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU mode "
                    "(python3 chip_smoke.py also runs these steps on the "
                    "card)")
    return torch.device("cuda")


def truth_bam(path: str) -> None:
    """The sample pairs at their true transcript and positions (from the
    read names), as a paired BAM."""
    records, _ = load_transcripts(FASTA, noclip_polya=True)
    tid = {r.name: i for i, r in enumerate(records)}
    with open(READS[0]) as f1, open(READS[1]) as f2:
        l1, l2 = f1.read().split("\n"), f2.read().split("\n")
    recs = []
    for i in range(0, len(l1) - 3, 4):
        name = l1[i][1:].split()[0]
        _, txp, pos, fend = name.split(":")
        rid, pos, fend = tid[txp], int(pos), int(fend)
        s1, s2 = l1[i + 1].strip(), l2[i + 1].strip()
        tlen, p2 = fend - pos + 1, fend - len(s2) + 1
        recs.append(dict(name=name, refid=rid, pos=pos,
                         flag=0x1 | 0x40 | 0x20, cigar=f"{len(s1)}M",
                         seq=s1, mate_refid=rid, mate_pos=p2, tlen=tlen))
        recs.append(dict(name=name, refid=rid, pos=p2,
                         flag=0x1 | 0x80 | 0x10, cigar=f"{len(s2)}M",
                         seq=s2, mate_refid=rid, mate_pos=pos, tlen=-tlen))
    write_bam(path, [r.name for r in records],
              [r.seq_codes.shape[0] for r in records], recs)


@pytest.mark.cuda
def test_error_model_graphs_match_eager(cuda, tmp_path):
    bam = str(tmp_path / "truth.bam")
    truth_bam(bam)
    got = rest.errmodel_check(bam, FASTA, cuda, n=4, batch_records=4000)
    # five steps' outputs compared on each of 4 batches (the per-mate
    # likelihood twice), every step captured and replayed
    assert got["exact_outputs"] == 4 * 4
    g = got["graphs"]
    assert g["captures"] == g["signatures"] == 6 and g["replays"] >= 6 * 3
    assert set(got["max_rel_diff"]) == {
        "update_keys", "update_keys_eager", "count_update",
        "count_update_eager"}


def _rank(rank, port, index_dir, out_dir):
    os.environ.update({distributed.ENV_COORD: f"127.0.0.1:{port}",
                       distributed.ENV_NPROC: "2",
                       distributed.ENV_PID: str(rank)})
    world = distributed.init_from_env(torch.device("cuda", 0))
    rec = rest.sharded_check(world, tb.load_index(index_dir), *READS)
    torch.save(rec, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.mark.cuda
def test_sharded_step_graphs_match_eager(cuda, tmp_path):
    idx = str(tmp_path / "idx")
    tb.save_index(tb.build_index(FASTA, k=25), idx)
    mp.start_processes(_rank, args=(free_port(), idx, str(tmp_path)),
                       nprocs=2, join=True, start_method="spawn")
    for r in range(2):
        rec = torch.load(str(tmp_path / f"rank{r}.pt"))
        assert rec["max_float_rel_diff"] <= max(
            rest.RTOL, 2 * rec["max_float_rel_diff_eager"])
        g = rec["graphs"]
        # A and B: captured once each, replayed from the second batch
        assert (g["signatures"], g["captures"]) == (2, 2)
        assert g["replays"] == 2 * (rec["batches"] - 1)


@pytest.mark.cuda
def test_config5_graphs_match_eager(cuda, tmp_path, monkeypatch):
    monkeypatch.setattr(tb, "TABLE_DIRECT_MAX_KEYS", 1)
    idx = str(tmp_path / "tl")
    tb.save_index(tb.build_index(FASTA, k=25, partition_bits=2), idx)
    monkeypatch.setattr(demo, "R", 4096)          # three batches
    rec = rest.config5_run(idx, *READS, 20_000, cuda)
    assert rec["check"]["n_frags"] == 10_000
    c = rec["check"]
    assert c["eq_weights_rel_diff"] <= max(
        rest.RTOL, 2 * c["eq_weights_eager_rel_diff"])
    g = rec["graph"]
    assert g["b1"]["captures"] == 2 and g["b2"]["captures"] == 1
    assert g["b2"]["replays"] == 2


@pytest.mark.cuda
def test_a_failed_capture_raises_naming_the_step(cuda):
    cache = GraphCache()
    x = torch.arange(8, device=cuda)

    def masked(t):
        return t[t > 3]          # a shape from the data: a host sync

    emd.compiled_step(cache, "masked", masked, [x])
    with pytest.raises(RuntimeError, match="error model masked"):
        emd.compiled_step(cache, "masked", masked, [x])
