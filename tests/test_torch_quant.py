"""End to end: the port's CLI on tests/data against the golden fixture
and against the JAX package's CLI in the other mapping modes
(single-end -r, --recoverOrphans, another --bandwidth), the index
handed over from the JAX package, the port's independence from JAX,
and the options it does not have yet.

The golden tolerances are tests/test_golden.py's: quant.sf columns
within rtol 5e-3 / atol 0.5, lib_format_counts field for field. The
same tolerance holds the port's quant.sf to the JAX CLI's: the two
differ only through the tie order of ROADMAP queue 3.
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


def test_port_runs_without_jax(tmp_path):
    """With jax unimportable, the port imports and runs index + quant,
    paired, single-end and with the rescue."""
    script = f"""
import sys
sys.modules["jax"] = None
sys.modules["salmon_tpu"] = None
sys.path.insert(0, {REPO!r})
from salmon_tpu_torch import cli
idx, out = {str(tmp_path / 'idx')!r}, {str(tmp_path / 'quant')!r}
assert cli.main(["index", "-t", {os.path.join(DATA, 'transcripts.fasta')!r},
                 "-i", idx, "-k", "31"]) == 0
assert cli.main(["quant", "-i", idx, "-l", "A", *{READS!r}, "-o", out,
                 "-q"], device="cpu") == 0
assert cli.main(["quant", "-i", idx, "-l", "A", "-r", {READS[1]!r}, "-o",
                 out + "_se", "-q"], device="cpu") == 0
assert cli.main(["quant", "-i", idx, "-l", "IU", *{READS!r},
                 "--recoverOrphans", "-o", out + "_rescue", "-q"],
                device="cpu") == 0
assert not any(m == "jax" or m.startswith(("jax.", "salmon_tpu."))
               for m in sys.modules if sys.modules[m] is not None)
"""
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
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
    bad = []
    for path in files:
        with open(path) as fh:
            bad += [f"{path}:{i}: {ln.strip()}"
                    for i, ln in enumerate(fh, 1) if pattern.match(ln)]
    assert not bad, bad


def test_cli_quant_needs_cuda_by_default(port_index, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: quant would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["quant", "-i", port_index, "-l", "IU", *READS,
                  "-o", str(tmp_path / "q"), "-q"])


MODES = {
    "single-end": ["-l", "A", "-r", os.path.join(DATA, "reads_1.fastq")],
    "recoverOrphans": ["-l", "IU", *READS, "--recoverOrphans"],
    "bandwidth-25": ["-l", "IU", *READS, "--bandwidth", "25"],
}


@pytest.fixture(scope="module")
def jax_index(tmp_path_factory):
    idx = str(tmp_path_factory.mktemp("jax_idx") / "idx")
    jb.save_index(jb.build_index(os.path.join(DATA, "transcripts.fasta"),
                                 k=31), idx)
    return idx


@pytest.mark.parametrize("mode", sorted(MODES))
def test_cli_quant_matches_jax_cli(jax_index, tmp_path, mode):
    """Both CLIs on one index, in a mapping mode beyond the golden
    fixture's: quant.sf within the golden tolerance, the mapping
    counters and library-format counts equal."""
    flags = [*MODES[mode], "-q", "--no-version-check"]
    outs = {}
    for name, main, kw in (("port", cli.main, {"device": "cpu"}),
                           ("jax", jcli.main, {})):
        outs[name] = str(tmp_path / name)
        assert main(["quant", "-i", jax_index, *flags, "-o", outs[name]],
                    **kw) == 0
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
                "library_types", "num_decoy_fragments"):
        assert meta[key] == jmeta[key], key
    assert fmt == jfmt
    if mode == "single-end":
        assert meta["library_types"] in (["U"], ["SF"], ["SR"])
        assert set(fmt) >= {"SF", "SR"} and "ISF" not in fmt


UNPORTED = [
    (["--numBootstraps", "2"], {}),
    (["--numGibbsSamples", "2"], {}),
    (["--seqBias"], {}),
    (["--gcBias"], {}),
    (["--indexShards", "2"], {}),
    (["--writeMappings", "out.sam"], {}),
    (["--writeUnmappedNames"], {}),
    (["--writeOrphanLinks"], {}),
    ([], {"SALMON_TPU_SPARSE_SEED": "1"}),
    ([], {"SALMON_TPU_ROWPOOL": "64"}),
]


@pytest.mark.parametrize("flags,env", UNPORTED,
                         ids=[" ".join(f) or next(iter(e))
                              for f, e in UNPORTED])
def test_unported_options_raise(port_index, tmp_path, monkeypatch, flags,
                                env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(["quant", "-i", port_index, "-l", "IU", *READS, *flags,
                  "-o", str(tmp_path / "q"), "-q"], device="cpu")


@pytest.mark.parametrize("argv", [
    ["quant", "-a", "x.bam", "-t", "t.fa", "-l", "A", "-o", "q"],
    ["quant", "-e", "eqdir", "-l", "A", "-o", "q"],
    ["quantmerge", "--quants", "a", "b", "-o", "m.tsv"],
], ids=["alignment-mode", "eq-mode", "quantmerge"])
def test_unported_commands_raise(argv):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(argv, device="cpu")
