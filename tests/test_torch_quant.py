"""End to end: the port's CLI on tests/data against the golden fixture
and against the JAX package's CLI in the other mapping modes
(single-end -r, --recoverOrphans, another --bandwidth, bias correction,
--auxTargetFile, bootstraps), the index handed over from the JAX
package and the port's independence from JAX. (--indexShards and
table-less indexes: tests/test_torch_multiproc_quant.py.)

The golden tolerances are tests/test_golden.py's: quant.sf columns
within rtol 5e-3 / atol 0.5, lib_format_counts field for field. The
same tolerance holds the port's quant.sf to the JAX CLI's: the two
differ only through the tie order of ROADMAP queue 3, which gives ~15 %
of the sample fragments another best transcript of equal score (and
moves the FLD mean by 0.09). That reaches the observed bias
histograms: --seqBias/--gcBias contexts of tied paralogs are mostly the
same bases, so those bins move by a few counts and quant.sf stays
within the golden tolerance; --posBias bins a fragment by its
transcript's length class and relative position, so the tie order
moves ~1 % of the positional mass between bins and the correction
lands elsewhere on 15 transcripts (test_cli_pos_bias_matches_jax).
"""

import gzip
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from salmon_tpu import cli as jcli
from salmon_tpu.index import builder as jb
from salmon_tpu_torch import cli
from salmon_tpu_torch.io import writers

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
GOLDEN = os.path.join(DATA, "golden")
READS = ["-1", os.path.join(DATA, "reads_1.fastq"),
         "-2", os.path.join(DATA, "reads_2.fastq")]
FORMAT_KEYS = ("expected_format", "num_compatible_fragments",
               "num_assigned_fragments", "ISF", "ISR", "OSF", "OSR", "MSF",
               "MSR")


def _parse_sf(lines):
    rows = {}
    for ln in lines[1:]:
        f = ln.rstrip("\n").split("\t")
        if len(f) >= 5:
            rows[f[0]] = (float(f[2]), float(f[3]), float(f[4]))
    return rows


def assert_quant_sf_close(got_lines, want_lines):
    got, want = _parse_sf(got_lines), _parse_sf(want_lines)
    assert set(got) == set(want)
    w = np.array([want[k] for k in sorted(want)])
    g = np.array([got[k] for k in sorted(want)])
    np.testing.assert_allclose(g, w, rtol=5e-3, atol=0.5)


def assert_golden(out_dir: str):
    with gzip.open(os.path.join(GOLDEN, "quant.sf.gz"), "rt") as fh:
        want = fh.readlines()
    with open(os.path.join(out_dir, "quant.sf")) as fh:
        assert_quant_sf_close(fh.readlines(), want)
    with open(os.path.join(GOLDEN, "lib_format_counts.json")) as fh:
        want_fmt = json.load(fh)
    with open(os.path.join(out_dir, "lib_format_counts.json")) as fh:
        got_fmt = json.load(fh)
    for k in FORMAT_KEYS:
        assert got_fmt[k] == want_fmt[k], k


@pytest.fixture(scope="module")
def port_index(tmp_path_factory):
    idx = str(tmp_path_factory.mktemp("torch_idx") / "idx")
    assert cli.main(["index", "-t", os.path.join(DATA, "transcripts.fasta"),
                     "-i", idx, "-k", "31"]) == 0
    return idx


def test_cli_quant_matches_golden(port_index, tmp_path):
    out = str(tmp_path / "quant")
    assert cli.main(["quant", "-i", port_index, "-l", "IU", *READS,
                     "-o", out, "-q"], device="cpu") == 0
    assert_golden(out)
    with open(os.path.join(out, "aux_info", "meta_info.json")) as fh:
        meta = json.load(fh)
    assert meta["num_processed"] == 10000
    assert meta["library_types"] == ["IU"]
    with open(os.path.join(out, "cmd_info.json")) as fh:
        assert json.load(fh)["libType"] == "IU"


def test_cli_quant_on_jax_built_index(tmp_path):
    """An index written by the JAX package quantifies the same."""
    idx = str(tmp_path / "jax_idx")
    jb.save_index(jb.build_index(os.path.join(DATA, "transcripts.fasta"),
                                 k=31), idx)
    out = str(tmp_path / "quant")
    assert cli.main(["quant", "-i", idx, "-l", "IU", *READS, "-o", out,
                     "-q"], device="cpu") == 0
    assert_golden(out)


# test_port_runs_without_jax: one case a command or a short group of
# commands, each in a subprocess of its own with jax and salmon_tpu
# unimportable and two threads (torch's threads oversubscribe next to
# other test workers), under a limit sized to its work. IDX is the
# module's port-built index, OUT the case's output prefix.
NO_JAX_CASES = {
    "index-paired": (150, """
idx = OUT + "_idx"
assert cli.main(["index", "-t", FASTA, "-i", idx, "-k", "31"]) == 0
assert cli.main(["quant", "-i", idx, "-l", "A", *READS, "-o", OUT,
                 "-q"], device="cpu") == 0
"""),
    "single-end": (120, """
assert cli.main(["quant", "-i", IDX, "-l", "A", "-r", READS[1], "-o", OUT,
                 "-q"], device="cpu") == 0
"""),
    "rescue": (150, """
assert cli.main(["quant", "-i", IDX, "-l", "IU", *READS,
                 "--recoverOrphans", "-o", OUT, "-q"], device="cpu") == 0
"""),
    "bias-gibbs": (240, """
assert cli.main(["quant", "-i", IDX, "-l", "IU", *READS, "--seqBias",
                 "--gcBias", "--posBias", "--numGibbsSamples", "2",
                 "--thinningFactor", "2", "-o", OUT, "-q"],
                device="cpu") == 0
"""),
    "bootstraps": (150, """
assert cli.main(["quant", "-i", IDX, "-l", "IU", *READS,
                 "--numBootstraps", "2", "-o", OUT, "-q"],
                device="cpu") == 0
"""),
    "sparse-side-outputs-quantmerge": (180, """
os.environ["SALMON_TPU_SPARSE_SEED"] = "1"
assert cli.main(["quant", "-i", IDX, "-l", "IU", *READS,
                 "--writeMappings", OUT + ".sam", "--writeUnmappedNames",
                 "--writeOrphanLinks", "-o", OUT, "-q"], device="cpu") == 0
del os.environ["SALMON_TPU_SPARSE_SEED"]
assert cli.main(["quantmerge", "--quants", OUT, OUT, "--names", "a", "b",
                 "-o", OUT + "_merged.tsv"]) == 0
"""),
    "alignment-eq": (90, """
from salmon_tpu_torch.alignment.bamio import write_bam
from salmon_tpu_torch.io.fasta import load_transcripts
recs, _ = load_transcripts(FASTA, noclip_polya=True)
codes = recs[0].seq_codes
bam = OUT + "_aln.bam"
write_bam(bam, [r.name for r in recs], [len(r.seq_codes) for r in recs],
          [dict(name=f"r{i}", refid=0, pos=i, flag=0, cigar="50M",
                seq="".join("ACGTN"[c] for c in codes[i:i + 50]),
                tags={"AS": 100}) for i in range(200)])
assert cli.main(["quant", "-t", FASTA, "-l", "A", "-a", bam, "--dumpEq",
                 "-o", OUT + "_aln", "-q"], device="cpu") == 0
assert cli.main(["quant", "-e", OUT + "_aln", "-o", OUT, "-q"],
                device="cpu") == 0
"""),
    "bench": (90, """
os.environ.update(BENCH_FAST="1", BENCH_BATCH="64", BENCH_PAIRS="128")
from salmon_tpu_torch import bench
assert bench.main([], device="cpu") == 0
"""),
    "partitioned-tableless": (90, """
import numpy as np
from salmon_tpu_torch.index import builder
builder.TABLE_DIRECT_MAX_KEYS = 0
idx = builder.build_index(FASTA, k=31, partition_bits=2)
assert idx.table is None and idx.info["requires_shards"]
builder.save_index(idx, OUT + "_idx")
back = builder.load_index(OUT + "_idx")
for f in ("kmers", "occ_offsets", "occ_txp", "occ_pf", "occ_counts"):
    np.testing.assert_array_equal(getattr(back, f), getattr(idx, f))
try:
    cli.main(["quant", "-i", OUT + "_idx", "-l", "IU", *READS, "-o", OUT,
              "-q"], device="cpu")
    raise AssertionError("a table-less index quantified without shards")
except ValueError as e:
    assert "--indexShards" in str(e), e
"""),
}


@pytest.mark.parametrize("case", sorted(NO_JAX_CASES))
def test_port_runs_without_jax(port_index, tmp_path, case):
    """With jax and salmon_tpu unimportable, the port imports and runs
    one command or short group: index + paired quant, single-end, the
    rescue, bias correction with Gibbs draws, bootstraps, the sparse
    seed flow with the side outputs and quantmerge, alignment mode (-a)
    with eq-class mode (-e), the partitioned table-less build with
    its save/load round trip (which quant refuses without shards), and
    the benchmark harness (salmon_tpu_torch.bench) on the CPU."""
    limit, body = NO_JAX_CASES[case]
    out = str(tmp_path / "quant")
    script = f"""
import os
import sys
sys.modules["jax"] = None
sys.modules["salmon_tpu"] = None
sys.path.insert(0, {REPO!r})
import torch
torch.set_num_threads(2)
from salmon_tpu_torch import cli
IDX, OUT = {port_index!r}, {out!r}
FASTA = {os.path.join(DATA, 'transcripts.fasta')!r}
READS = {READS!r}
{body}
assert not any(m == "jax" or m.startswith(("jax.", "salmon_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
"""
    env = dict(os.environ, PYTHONPATH="", OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=limit)
    assert proc.returncode == 0, proc.stderr[-3000:]
    if case == "index-paired":
        with open(tmp_path / "quant" / "lib_format_counts.json") as fh:
            assert json.load(fh)["expected_format"] == "IU"


def test_no_jax_imports_in_the_port():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|salmon_tpu)(\s|\.|,|$)")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, names in os.walk(os.path.join(REPO, "salmon_tpu_torch")):
        if "_build" in dirs:
            dirs.remove("_build")     # build output, not the package
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    # the multi-process modules and the scripts (config 5, human scale,
    # the throughput harnesses, the truth simulations) included
    ported_scripts = ("scripts/__init__.py", "scripts/demo_config5_quant.py",
               "scripts/build_genome_scale_index.py",
               "scripts/check_hs_accuracy.py", "scripts/eval_hs_accuracy.py",
               "scripts/quant_window.py", "scripts/bench_multihost.py",
               "scripts/bench_alignment_mode.py", "scripts/sim_seqbias.py",
               "scripts/sim_gcbias.py", "scripts/sim_posbias.py",
               "scripts/sim_paralog_gate.py", "scripts/sim_rescue_recall.py")
    for mod in ("parallel/distributed.py", "parallel/quant_step.py",
                "parallel/sharded.py", "parallel/em.py", "parallel/launch.py",
                "index/shard.py", "index/kmer_enum.py", *ported_scripts):
        assert os.path.join(REPO, "salmon_tpu_torch", mod) in files, mod
    # nor does it load, build or name the JAX package's native library
    # (the port builds its own from salmon_tpu_torch/csrc), or read the
    # JAX package's -a device switches
    native = re.compile(r"\bnative/|\bnative\.build|libsalmontpu|"
                        r"SALMON_TPU_ALIGN_DEVICE|SALMON_TPU_HOST_ERRMODEL")
    bad = []
    for path in files:
        with open(path) as fh:
            bad += [f"{path}:{i}: {ln.strip()}"
                    for i, ln in enumerate(fh, 1)
                    if pattern.match(ln) or native.search(ln)]
    # the scripts start no process of the JAX package either (its CLI
    # or a module of it run with -m)
    jax_prog = re.compile(r"[\"']salmon_tpu(\.[a-z_.]+)?[\"']")
    for mod in ported_scripts:
        path = os.path.join(REPO, "salmon_tpu_torch", mod)
        with open(path) as fh:
            bad += [f"{path}:{i}: {ln.strip()}"
                    for i, ln in enumerate(fh, 1) if jax_prog.search(ln)]
    assert not bad, bad
    from salmon_tpu_torch import _native
    assert _native.CSRC == os.path.join(REPO, "salmon_tpu_torch", "csrc")
    assert _native.BUILD == os.path.join(REPO, "salmon_tpu_torch", "_build")
    assert all(os.path.exists(os.path.join(_native.CSRC, src))
               for src in _native.SOURCES)


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A compile that fails raises RuntimeError with the compiler's log,
    at the entry points too: no numpy fallback. The compiler is given
    only the sources under salmon_tpu_torch/csrc."""
    from salmon_tpu_torch import _native
    from salmon_tpu_torch.index import native_kmers
    from salmon_tpu_torch.io import fastq

    args = tmp_path / "args.txt"
    cxx = tmp_path / "failing-g++"
    cxx.write_text(f"#!/bin/sh\necho \"$@\" > {args}\n"
                   "echo 'error: no such compiler' >&2\nexit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setattr(_native, "_cxx", lambda: str(cxx))
    monkeypatch.setattr(_native, "BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(_native, "_loaded", {})
    with pytest.raises(RuntimeError, match="no such compiler"):
        _native.lib()
    srcs = [a for a in args.read_text().split() if a.endswith(".cpp")]
    assert srcs == [os.path.join(REPO, "salmon_tpu_torch", "csrc", s)
                    for s in _native.SOURCES]
    with pytest.raises(RuntimeError, match="no such compiler"):
        native_kmers.oct_align_pads(np.ones(4, np.int64), 8)
    with pytest.raises(RuntimeError, match="no such compiler"):
        list(fastq.iter_paired_chunks([READS[1]], [READS[3]], 64, 128))
    assert not os.listdir(tmp_path / "build")


def test_cli_quant_needs_cuda_by_default(port_index, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: quant would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["quant", "-i", port_index, "-l", "IU", *READS,
                  "-o", str(tmp_path / "q"), "-q"])


@pytest.mark.parametrize("argv", [
    ["-a", "x.bam", "-t", os.path.join(DATA, "transcripts.fasta")],
    ["-e", "eqdir"],
], ids=["alignment-mode", "eq-mode"])
def test_alignment_and_eq_modes_need_cuda_by_default(tmp_path, argv):
    """-a and -e run on the CUDA device unless the caller asks for the
    CPU; without one they raise before reading any input."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: quant would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["quant", *argv, "-l", "A", "-o", str(tmp_path / "q"),
                  "-q"])


# --auxTargetFile: one name of the index and one it lacks
AUX_TARGETS = "NM_014620\nNOT_IN_THE_INDEX\n"
MODES = {
    "single-end": ["-l", "A", "-r", os.path.join(DATA, "reads_1.fastq")],
    "recoverOrphans": ["-l", "IU", *READS, "--recoverOrphans"],
    "bandwidth-25": ["-l", "IU", *READS, "--bandwidth", "25"],
    "seqBias-gcBias": ["-l", "IU", *READS, "--seqBias", "--gcBias"],
    "auxTargetFile": ["-l", "IU", *READS, "--seqBias", "--gcBias",
                      "--auxTargetFile"],
    "numBootstraps-8": ["-l", "IU", *READS, "--numBootstraps", "8"],
}


@pytest.fixture(scope="module")
def jax_index(tmp_path_factory):
    idx = str(tmp_path_factory.mktemp("jax_idx") / "idx")
    jb.save_index(jb.build_index(os.path.join(DATA, "transcripts.fasta"),
                                 k=31), idx)
    return idx


@pytest.fixture(scope="module")
def cli_runs(jax_index, tmp_path_factory):
    """run(mode, flags) -> {"port": out_dir, "jax": out_dir}: both CLIs
    on one index, each mode run once per module."""
    done = {}

    def run(mode, flags=None):
        if mode not in done:
            base = tmp_path_factory.mktemp(mode)
            argv = list(MODES[mode] if flags is None else flags)
            if argv[-1] == "--auxTargetFile":
                (base / "aux.txt").write_text(AUX_TARGETS)
                argv.append(str(base / "aux.txt"))
            outs = {}
            for name, main, kw in (("port", cli.main, {"device": "cpu"}),
                                   ("jax", jcli.main, {})):
                outs[name] = str(base / name)
                assert main(["quant", "-i", jax_index, *argv, "-q",
                             "--no-version-check", "-o", outs[name]],
                            **kw) == 0
            done[mode] = outs
        return done[mode]
    return run


@pytest.mark.parametrize("mode", sorted(MODES))
def test_cli_quant_matches_jax_cli(cli_runs, mode):
    """Both CLIs on one index, in a mapping mode beyond the golden
    fixture's: quant.sf within the golden tolerance, the mapping
    counters, the bias and sampling meta keys and library-format counts
    equal."""
    outs = cli_runs(mode)
    files = {}
    for name, out in outs.items():
        with open(os.path.join(out, "quant.sf")) as fh:
            sf = fh.readlines()
        with open(os.path.join(out, "aux_info", "meta_info.json")) as fh:
            meta = json.load(fh)
        with open(os.path.join(out, "lib_format_counts.json")) as fh:
            fmt = json.load(fh)
        files[name] = (sf, meta, fmt)
    (sf, meta, fmt), (jsf, jmeta, jfmt) = files["port"], files["jax"]
    assert_quant_sf_close(sf, jsf)
    for key in ("num_processed", "num_mapped", "num_orphans_rescued",
                "library_types", "num_decoy_fragments", "seq_bias_correct",
                "gc_bias_correct", "pos_bias_correct", "pos_bias_mode",
                "samp_type", "num_bootstraps"):
        assert meta[key] == jmeta[key], key
    assert fmt == jfmt
    if mode == "single-end":
        assert meta["library_types"] in (["U"], ["SF"], ["SR"])
        assert set(fmt) >= {"SF", "SR"} and "ISF" not in fmt


def _aux_files(out):
    return sorted(os.listdir(os.path.join(out, "aux_info")))


def _matrix(out, name):
    return writers.read_matrix_gz(os.path.join(out, "aux_info", name))


@pytest.mark.parametrize("mode", ["seqBias-gcBias", "auxTargetFile"])
def test_cli_bias_dumps_match_jax(cli_runs, mode):
    """The same aux_info files. Observed histograms count the same
    fragments (equal totals); the tie order moves a bin by at most 0.1 %
    of the total (3 of 10,000 fragments in obs_gc, 2 of 89,685 windows in
    obs5_seq). Expected tables follow the alphas, which the tie order
    moves by up to 1e-3: within 2e-3 of each table's largest entry. The
    EM ran the bias minimum of 100 iterations."""
    outs = cli_runs(mode)
    assert _aux_files(outs["port"]) == _aux_files(outs["jax"])
    names = [n for n in _aux_files(outs["jax"])
             if n.startswith(("obs5_", "obs3_", "obs_", "exp5_", "exp3_",
                              "exp_"))]
    assert len(names) == 6, names
    for name in names:
        got, want = _matrix(outs["port"], name), _matrix(outs["jax"], name)
        assert got.shape == want.shape, name
        if name.startswith("obs"):
            assert got.sum() == want.sum() > 0, name
            assert np.abs(got - want).max() <= 1e-3 * want.sum(), name
        else:
            np.testing.assert_allclose(got, want, rtol=0, err_msg=name,
                                       atol=2e-3 * np.abs(want).max())
    with open(os.path.join(outs["port"], "aux_info",
                           "meta_info.json")) as fh:
        assert json.load(fh)["num_em_iterations"] >= 100


def test_cli_aux_target_ids_match_jax(cli_runs):
    """--auxTargetFile: the same aux_target_ids.json, and the named
    transcript keeps its uncorrected effective length (the plain run's)
    where the bias run without the file moves it."""
    outs = cli_runs("auxTargetFile")
    docs = []
    for out in outs.values():
        with open(os.path.join(out, "aux_info", "aux_target_ids.json")) as fh:
            docs.append(json.load(fh))
    assert docs[0] == docs[1] and len(docs[0]["aux_target_ids"]) == 1
    sf = {}
    for name, out in (("aux", outs["port"]),
                      ("plain", cli_runs("numBootstraps-8")["port"]),
                      ("bias", cli_runs("seqBias-gcBias")["port"])):
        with open(os.path.join(out, "quant.sf")) as fh:
            sf[name] = _parse_sf(fh.readlines())
    # the pass carries lengths in float32: 1.2e-4 at ~2,000 bases, which
    # can move quant.sf's last printed digit
    eff = {k: v["NM_014620"][0] for k, v in sf.items()}
    assert abs(eff["aux"] - eff["plain"]) <= 2e-3, eff
    assert abs(eff["bias"] - eff["plain"]) > 1.0, eff


def test_cli_pos_bias_matches_jax(cli_runs):
    """--posBias: the tie order of ROADMAP queue 3 gives ~15 % of the
    sample fragments another best transcript, often a paralog of
    another length class, so the positional bins differ by up to ~1 %
    of the mass (113 of 10,000) and quant.sf cannot be held to the
    golden tolerance. Held instead: the same files and meta keys, equal
    observed totals, each observed bin within 2 % of the total, expected
    tables within 1e-2 of their largest entry, and both runs at
    tests/test_bias.py's accuracy gate against the truth (Spearman >=
    0.80 on this noise-dominated sample)."""
    from scipy.stats import spearmanr

    outs = cli_runs("posBias", ["-l", "IU", *READS, "--posBias"])
    assert _aux_files(outs["port"]) == _aux_files(outs["jax"])
    metas = []
    for out in outs.values():
        with open(os.path.join(out, "aux_info", "meta_info.json")) as fh:
            metas.append(json.load(fh))
    for key in ("pos_bias_correct", "pos_bias_mode", "seq_bias_correct",
                "num_mapped"):
        assert metas[0][key] == metas[1][key], key
    for name in ("obs5_pos.gz", "obs3_pos.gz", "exp5_pos.gz",
                 "exp3_pos.gz"):
        got, want = _matrix(outs["port"], name), _matrix(outs["jax"], name)
        if name.startswith("obs"):
            assert got.sum() == want.sum() > 0
            assert np.abs(got - want).max() <= 0.02 * want.sum(), name
        else:
            np.testing.assert_allclose(got, want, rtol=0, err_msg=name,
                                       atol=1e-2 * np.abs(want).max())
    truth = {}
    with open(READS[1]) as fh:
        for i, ln in enumerate(fh):
            if i % 4 == 0:
                t = ln[1:].split(":")[1]
                truth[t] = truth.get(t, 0) + 1
    for out in outs.values():
        with open(os.path.join(out, "quant.sf")) as fh:
            rows = _parse_sf(fh.readlines())
        rho = spearmanr([truth.get(n, 0) for n in rows],
                        [rows[n][2] for n in rows]).statistic
        assert rho >= 0.80, (out, rho)


def test_cli_bootstraps_match_jax(cli_runs):
    """--numBootstraps 8: both packages resample the class counts with
    the same numpy call over equal eq classes (ROADMAP queue 3), so the
    replicates differ only by the EM's float32 order and the effective
    lengths' FLD drift (<= 2e-4 relative): within the golden tolerance,
    with the same names and shape."""
    outs = cli_runs("numBootstraps-8")
    (names, got), (jnames, want) = (writers.read_bootstraps(o)
                                    for o in (outs["port"], outs["jax"]))
    assert names == jnames and got.shape == want.shape == (8, len(names))
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=0.5)

