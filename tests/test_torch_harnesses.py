"""The throughput harnesses: the port's salmon_tpu_torch.scripts.{quant_window,
bench_multihost, bench_alignment_mode} on the CPU, and every new script's
refusal to run without a GPU unless asked for the CPU.

- quant_window on the sample pairs through a wrapper that runs the port's
  CLI on the CPU (--salmon): the JAX harness's six keys, exit code 0 and
  every fragment counted with --progressUpdateMs 0; then a window cut
  short, timed out.
- bench_multihost --procs 1,2 --devices-per-proc 1 (CPU ranks) on the
  sample: the JAX harness's report keys, the same fragments at 1 and 2
  processes, the 2-process quant.sf within rtol 1e-3 / atol 0.5 of the
  1-process one.
- bench_alignment_mode: the BAM byte-equal to the JAX script's at REPS 1;
  its quant.sf on the CPU within rtol 5e-3 / atol 0.5 of the JAX
  package's quantify_alignments on the same BAM; the JSON line's keys.
"""

import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch

from salmon_tpu_torch import cli
from salmon_tpu_torch.io.writers import read_quant_sf
from salmon_tpu_torch.scripts import (bench_alignment_mode, bench_multihost,
                                      quant_window, sim_gcbias,
                                      sim_paralog_gate, sim_posbias,
                                      sim_rescue_recall, sim_seqbias)

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
DATA = os.path.join(HERE, "data")
R1, R2 = (os.path.join(DATA, f"reads_{i}.fastq") for i in (1, 2))
N_PAIRS = 10_000          # the sample's pairs
QW_KEYS = {"command", "timed_out", "elapsed_seconds", "processed_fragments",
           "fragments_per_second", "exit_code"}
MH_KEYS = {"metric", "devices_per_proc", "virtual_cpu_mesh", "procs",
           "frags_per_s", "wall_s", "efficiency_vs_1", "note"}
# the ranks' clocks that bench_multihost's report adds to the JAX keys
RANK_CLOCKS = ("index_load_seconds", "read_seconds", "map_seconds",
               "em_seconds")

# the port's CLI on the CPU, as a command for quant_window's --salmon
WRAPPER = """#!{python}
import sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(2)
from salmon_tpu_torch import cli
sys.exit(cli.main(sys.argv[1:], device="cpu"))
"""


@pytest.fixture(scope="module")
def sample_index(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("harness_idx") / "idx")
    assert cli.main(["index", "-t", os.path.join(DATA, "transcripts.fasta"),
                     "-i", d, "-k", "31", "--no-version-check"]) == 0
    return d


@pytest.fixture(scope="module")
def cpu_salmon(tmp_path_factory):
    path = tmp_path_factory.mktemp("wrapper") / "salmon_cpu"
    path.write_text(WRAPPER.format(python=sys.executable, repo=REPO))
    path.chmod(0o755)
    return str(path)


def _quant_window(argv, tmp_path):
    out = str(tmp_path / "qw.json")
    assert quant_window.main(["--json-out", out, *argv]) == 0
    with open(out) as fh:
        return json.load(fh)


def test_quant_window_counts_every_fragment(sample_index, cpu_salmon,
                                            tmp_path):
    out_dir = str(tmp_path / "qw_out")
    res = _quant_window(["--salmon", cpu_salmon, "--index", sample_index,
                         "-1", R1, "-2", R2, "--seconds", "300", "--out-dir",
                         out_dir, "--", "--progressUpdateMs", "0"], tmp_path)
    assert set(res) == QW_KEYS
    assert res["exit_code"] == 0 and not res["timed_out"]
    with open(os.path.join(out_dir, "aux_info", "meta_info.json")) as fh:
        meta = json.load(fh)
    assert res["processed_fragments"] == meta["num_processed"] == N_PAIRS
    assert res["fragments_per_second"] == pytest.approx(
        N_PAIRS / res["elapsed_seconds"])
    assert res["command"][:2] == [cpu_salmon, "quant"]
    assert res["command"][-2:] == ["--progressUpdateMs", "0"]
    assert os.path.exists(os.path.join(out_dir, "quant.sf"))


def test_quant_window_cut_short(sample_index, cpu_salmon, tmp_path):
    res = _quant_window(["--salmon", cpu_salmon, "--index", sample_index,
                         "-1", R1, "-2", R2, "--seconds", "1", "--out-dir",
                         str(tmp_path / "qw_out")], tmp_path)
    assert set(res) == QW_KEYS
    assert res["timed_out"]
    assert res["exit_code"] != 0
    assert 0 <= res["processed_fragments"] < N_PAIRS
    assert res["elapsed_seconds"] >= 1


def test_bench_multihost_cpu_ranks(monkeypatch, capsys, tmp_path):
    """--procs 1,2 --devices-per-proc 1: CPU ranks through the port's
    launcher, on the sample (the index from the port's own `index`)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    kept = {}
    run_one = bench_multihost.run_one

    def keep(nprocs, *args):
        rec = run_one(nprocs, *args)
        kept[nprocs] = rec, read_quant_sf(os.path.join(args[2], "quant.sf"))
        return rec

    monkeypatch.setattr(bench_multihost, "run_one", keep)
    assert bench_multihost.main(["--procs", "1,2", "--devices-per-proc",
                                 "1"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(report) == MH_KEYS | {"rank_clocks"}
    assert report["procs"] == [1, 2]
    for n, clocks in zip((1, 2), report["rank_clocks"]):
        for k in RANK_CLOCKS + (("eq_allgather_seconds",) if n > 1 else ()):
            assert len(clocks[k]) == n and min(clocks[k]) >= 0, (n, k)
        assert clocks["map_seconds"] == sorted(clocks["map_seconds"])
    assert report["devices_per_proc"] == 1 and report["virtual_cpu_mesh"]
    assert report["efficiency_vs_1"][0] == 1.0
    assert all(r > 0 for r in report["frags_per_s"])
    assert [kept[n][0]["frags"] for n in (1, 2)] == [N_PAIRS, N_PAIRS]
    for n in (1, 2):
        assert report["frags_per_s"][n - 1] == kept[n][0]["frags_per_s"]
    one, two = kept[1][1], kept[2][1]
    assert one["Name"] == two["Name"]
    np.testing.assert_allclose(two["NumReads"], one["NumReads"], rtol=1e-3,
                               atol=0.5)
    np.testing.assert_allclose(two["TPM"], one["TPM"], rtol=1e-3, atol=0.5)


@pytest.fixture(scope="module")
def alignment_bench(tmp_path_factory):
    """The BAM at REPS 1 written by both scripts, and the port's bench on
    the CPU (its quant.sf in tmp/quant)."""
    ns = runpy.run_path(os.path.join(REPO, "scripts",
                                     "bench_alignment_mode.py"),
                        run_name="not_main")
    base = tmp_path_factory.mktemp("abench")
    jax_bam = str(base / "jax.bam")
    n_jax = ns["build_bam"](jax_bam, 1)
    port_dir = str(base / "port")
    os.makedirs(port_dir)
    rec = bench_alignment_mode.bench(1, port_dir, "cpu")
    return {"jax_bam": jax_bam, "n_jax": n_jax, "rec": rec,
            "port_dir": port_dir, "base": str(base)}


def test_alignment_bench_bam_byte_equal(alignment_bench):
    with open(alignment_bench["jax_bam"], "rb") as fa, \
            open(os.path.join(alignment_bench["port_dir"], "bench.bam"),
                 "rb") as fb:
        ja, pb = fa.read(), fb.read()
    assert len(ja) > 0 and ja == pb
    rec = alignment_bench["rec"]
    assert alignment_bench["n_jax"] == rec["n_frags"] == N_PAIRS
    assert rec["n_records"] == 2 * N_PAIRS
    assert rec["value"] > 0 and rec["reader_rec_per_s"] > 0


def test_alignment_bench_quant_matches_jax(alignment_bench):
    """The port's quantify_alignments (the bench's run) against the JAX
    package's on the same BAM, with the JAX script's arguments."""
    from salmon_tpu.alignment.quant import quantify_alignments
    from salmon_tpu.constants import SalmonDefaults
    out = os.path.join(alignment_bench["base"], "jax_quant")
    args = bench_alignment_mode.quant_args(alignment_bench["jax_bam"], out)
    assert quantify_alignments(args, SalmonDefaults(),
                               cmd_args={"bench": True}) == 0
    want = read_quant_sf(os.path.join(out, "quant.sf"))
    got = read_quant_sf(os.path.join(alignment_bench["port_dir"], "quant",
                                     "quant.sf"))
    assert got["Name"] == want["Name"]
    for col in ("NumReads", "TPM", "EffectiveLength"):
        np.testing.assert_allclose(got[col], want[col], rtol=5e-3, atol=0.5,
                                   err_msg=col)
    assert abs(got["NumReads"].sum() - N_PAIRS) <= 0.01 * N_PAIRS


def test_alignment_bench_main_prints_the_jax_line(monkeypatch, capsys,
                                                  tmp_path):
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    assert bench_alignment_mode.main(["1"], device="cpu") == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rec) == {"metric", "value", "reader_rec_per_s"}
    assert rec["metric"] == "alignment-mode frags/s"
    assert rec["value"] > 0 and rec["reader_rec_per_s"] > 0


# ---------------------------------------------------------------------------
# no CUDA
# ---------------------------------------------------------------------------

NEEDS_CUDA = [
    (sim_seqbias, []), (sim_gcbias, []), (sim_posbias, []),
    (sim_paralog_gate, []), (sim_rescue_recall, []),
    (bench_alignment_mode, ["1"]),
    # the subprocess harnesses: the default command, GPU ranks
    (quant_window, ["--index", "idx", "-1", R1, "-2", R2]),
    (bench_multihost, ["--procs", "1"]),
]


@pytest.mark.parametrize("mod,argv", NEEDS_CUDA,
                         ids=[m.__name__.rsplit(".", 1)[1]
                              for m, _ in NEEDS_CUDA])
def test_new_scripts_need_cuda(mod, argv, monkeypatch, tmp_path):
    """No CPU fallback: without a CUDA device each script raises before it
    writes or starts anything, unless the caller asks for the CPU
    (device="cpu", quant_window's --salmon, bench_multihost's
    --devices-per-proc N > 0)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(argv)
    assert os.listdir(tmp_path) == []
