"""Mapping mode's side outputs, quantmerge and the small commands of the
port's CLI against the JAX package's CLI, on the sample reads.

The side outputs meet the tie order of ROADMAP queue 3: a fragment's
SAM records come from its best joined hit, the first after
mapping.pair's ranking by pair score, an unstable sort in the JAX
package; orphan links list each end's orphan hits in the order of
pair.py:162's ranking, also unstable there. So:

- SAM headers are byte-equal, every mapped fragment has as many
  records in both, and the records of fragments whose two best joined
  hits do not tie on score are byte-equal;
- orphan-link lines come in the same order (fragment order), each the
  same multisets of `txp,pos` fields left and right of its ':';
- unmapped_names.txt depends only on which fragments map, which is
  equal: byte-equal, and naming the all-N fragments of the reads;
- quantmerge runs on the host and is byte-equal for every column, with
  --names, --missing and --genes (rolled up through the gene map that
  cmd_info.json names).

Single-end --writeMappings raises KeyError in the JAX package (its
single-end batches carry no best hit); the port refuses it.
"""

import collections
import json
import os
import shutil

import numpy as np
import pytest
import test_torch_pipeline as ttp
import torch

from salmon_tpu import cli as jcli
from salmon_tpu.index import builder as jb
from salmon_tpu_torch import cli
from salmon_tpu_torch.index import builder as tb
from salmon_tpu_torch.io.fastq import iter_paired_chunks
from salmon_tpu_torch.mapping import pipeline as tpipe

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")
READS_1 = os.path.join(DATA, "reads_1.fastq")
READS = ["-1", READS_1, "-2", os.path.join(DATA, "reads_2.fastq")]
SIDE_FLAGS = ["--writeUnmappedNames", "--writeOrphanLinks"]


N_ALL_N = 200   # fragments whose two ends are all N (every 50th)


@pytest.fixture(scope="module")
def swapped_reads(tmp_path_factory):
    """The sample pairs with the right mates of every 8th fragment and
    its fifth neighbour swapped: those fragments have no concordant pair,
    so their ends map as orphans and show in orphan_links.txt. Both ends
    of every 50th fragment, from the 4th, are all N: those map nowhere
    and show in unmapped_names.txt."""
    base = tmp_path_factory.mktemp("swapped")
    args = []
    for flag, src in (("-1", READS_1), ("-2", READS[3])):
        with open(src) as fh:
            lines = fh.read().splitlines(keepends=True)
        recs = [lines[i:i + 4] for i in range(0, len(lines), 4)]
        if flag == "-2":
            for i in range(0, len(recs) - 5, 8):
                recs[i][1], recs[i + 5][1] = recs[i + 5][1], recs[i][1]
        for r in recs[3::50]:
            r[1] = "N" * (len(r[1]) - 1) + "\n"
        path = base / os.path.basename(src)
        path.write_text("".join("".join(r) for r in recs))
        args += [flag, str(path)]
    return args


@pytest.fixture(scope="module")
def jax_index(tmp_path_factory):
    idx = str(tmp_path_factory.mktemp("jax_idx") / "idx")
    jb.save_index(jb.build_index(os.path.join(DATA, "transcripts.fasta"),
                                 k=31), idx)
    return idx


@pytest.fixture(scope="module")
def side_runs(jax_index, swapped_reads, tmp_path_factory):
    """Both CLIs on swapped_reads, -l IU with --writeMappings FILE
    --writeUnmappedNames --writeOrphanLinks; the port's run also with
    --profileDir."""
    base = tmp_path_factory.mktemp("side")
    outs = {}
    for name, main, kw in (("port", cli.main, {"device": "cpu"}),
                           ("jax", jcli.main, {})):
        out = str(base / name)
        extra = (["--profileDir", str(base / "profile")]
                 if name == "port" else [])
        assert main(["quant", "-i", jax_index, "-l", "IU", *swapped_reads,
                     "-q", "--no-version-check", "--writeMappings",
                     str(base / f"{name}.sam"), *SIDE_FLAGS, *extra,
                     "-o", out], **kw) == 0
        outs[name] = out
    outs["sam"] = {n: str(base / f"{n}.sam") for n in ("port", "jax")}
    outs["profile"] = str(base / "profile")
    outs["reads"] = swapped_reads
    return outs


def _read(path):
    with open(path) as fh:
        return fh.read()


def tied_fragments(reads) -> set:
    """Names of the fragments whose two best joined hits tie on score
    (the port's seeds and join, whose scores equal the JAX package's)."""
    idx = tb.build_index(os.path.join(DATA, "transcripts.fasta"), k=31)
    dev = tpipe.device_index_tensors(idx, device="cpu")
    cfg = tpipe.MapperConfig.from_index(idx)
    tied = set()
    for chunk in iter_paired_chunks([reads[1]], [reads[3]], 2048, 256,
                                    want_names=True):
        batch = {"codes_l": torch.from_numpy(chunk.left.codes),
                 "lengths_l": torch.from_numpy(chunk.left.lengths),
                 "codes_r": torch.from_numpy(chunk.right.codes),
                 "lengths_r": torch.from_numpy(chunk.right.lengths)}
        rows = ttp.tied_top_rows(batch, dev, cfg)[:chunk.n_valid]
        tied.update(n.decode() for n, t in zip(chunk.left.names, rows) if t)
    return tied


def test_sam_matches_jax_cli(side_runs):
    port, want = (_read(side_runs["sam"][n]).splitlines(keepends=True)
                  for n in ("port", "jax"))
    head = [ln for ln in want if ln.startswith("@")]
    assert head and port[:len(head)] == head
    assert head[0] == "@HD\tVN:1.0\tSO:unknown\n" and len(head) == 17

    def by_fragment(lines):
        recs = collections.defaultdict(list)
        for ln in lines:
            if not ln.startswith("@"):
                recs[ln.split("\t", 1)[0]].append(ln)
        return recs

    got, exp = by_fragment(port), by_fragment(want)
    assert set(got) == set(exp) and len(exp) > 9000
    tied = tied_fragments(side_runs["reads"])
    assert 1000 < len(tied) < len(exp) / 2
    n_diff = 0
    for name, recs in exp.items():
        assert len(got[name]) == len(recs), name
        if name not in tied:
            assert got[name] == recs, name
        n_diff += got[name] != recs
    assert n_diff <= len(tied)
    # paired records: both mates, flags 0x1|0x2, mate fields cross-linked;
    # a quarter of the fragments lost their mate to the swap
    two = [r for r in got.values() if len(r) == 2]
    assert 0.7 * len(got) < len(two) < 0.8 * len(got)
    f1, f2 = (ln.rstrip("\n").split("\t") for ln in two[0])
    assert int(f1[1]) & 0x3 == int(f2[1]) & 0x3 == 0x3
    assert (f1[3], f1[7]) == (f2[7], f2[3])


def test_sequence_text_matches_jax():
    """The SAM writer's bases: the port's decode_seq / revcomp_codes
    equal the JAX package's, and the writer's batch decoding equals them
    row by row (invalid bases and padding included)."""
    from salmon_tpu.utils import dna as jdna
    from salmon_tpu_torch.quant import _seq_text
    from salmon_tpu_torch.utils import dna as tdna
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 5, (40, 64)).astype(np.uint8)
    lens = rng.integers(0, 65, 40).astype(np.int32)
    text = _seq_text(codes, lens)
    for r in range(40):
        row = codes[r, :lens[r]]
        assert tdna.decode_seq(row) == jdna.decode_seq(row)
        np.testing.assert_array_equal(tdna.revcomp_codes(row),
                                      jdna.revcomp_codes(row))
        assert text(r, False) == jdna.decode_seq(row)
        assert text(r, True) == jdna.decode_seq(jdna.revcomp_codes(row))


def test_unmapped_names_byte_equal(side_runs):
    port, want = (_read(os.path.join(side_runs[n], "aux_info",
                                     "unmapped_names.txt"))
                  for n in ("port", "jax"))
    lines = port.splitlines()
    # the all-N fragments, and only they, are named
    with open(side_runs["reads"][1]) as fh:
        heads = fh.read().splitlines()[::4]
    all_n = [h[1:].split()[0] + " u" for h in heads[3::50]]
    assert len(all_n) == N_ALL_N and lines == all_n
    assert port == want
    with open(os.path.join(side_runs["port"], "aux_info",
                           "meta_info.json")) as fh:
        meta = json.load(fh)
    assert len(lines) == meta["num_processed"] - meta["num_mapped"]


def test_orphan_links_match_jax_cli(side_runs):
    port, want = (_read(os.path.join(side_runs[n], "aux_info",
                                     "orphan_links.txt")).splitlines()
                  for n in ("port", "jax"))
    assert len(port) == len(want) > 1000

    def fields(line):
        left, right = line.split(":")
        return (collections.Counter(left.split("\t")),
                collections.Counter(right.split("\t")))

    for g, w in zip(port, want):
        assert fields(g) == fields(w), (g, w)


def test_profile_dir_writes_a_trace(side_runs):
    names = os.listdir(side_runs["profile"])
    assert len(names) == 1 and names[0].endswith(".pt.trace.json")
    path = os.path.join(side_runs["profile"], names[0])
    assert os.path.getsize(path) > 0
    with open(path) as fh:
        trace = json.load(fh)
    ops = {e.get("name") for e in trace["traceEvents"]}
    # the mapping's sorts and gathers ran under it
    assert "aten::argsort" in ops and "aten::index" in ops


def test_write_mappings_to_stdout(side_runs, jax_index, tmp_path, capsys):
    """`--writeMappings` without a file (or `-`) streams the same SAM to
    standard output."""
    assert cli.main(["quant", "-i", jax_index, "-l", "IU",
                     *side_runs["reads"], "-q",
                     "--writeMappings", "-o", str(tmp_path / "q")],
                    device="cpu") == 0
    assert capsys.readouterr().out == _read(side_runs["sam"]["port"])


def test_single_end_write_mappings(jax_index, tmp_path):
    """Single-end --writeMappings has no reference: the JAX CLI raises
    KeyError (its single-end batches carry no best hit), and the port
    refuses the flag before it maps or writes anything, naming its
    ROADMAP item."""
    argv = ["quant", "-i", jax_index, "-l", "A", "-r", READS_1, "-q",
            "--no-version-check", "--writeUnmappedNames", "--writeMappings"]
    with pytest.raises(KeyError, match="best_txp"):
        jcli.main([*argv, str(tmp_path / "jax.sam"), "-o",
                   str(tmp_path / "jax")])
    with pytest.raises(NotImplementedError, match="ROADMAP queue 3"):
        cli.main([*argv, str(tmp_path / "port.sam"), "-o",
                  str(tmp_path / "port")], device="cpu")
    assert not (tmp_path / "port.sam").exists()
    assert not (tmp_path / "port" / "aux_info" /
                "unmapped_names.txt").exists()


@pytest.fixture(scope="module")
def merge_inputs(side_runs, tmp_path_factory):
    """Three samples: the two CLIs' runs and a copy of the JAX run's
    quant.sf without its first 4 transcripts (for --missing); each with
    a cmd_info.json naming a gene map of pairs of transcripts."""
    base = tmp_path_factory.mktemp("merge")
    sf = _read(os.path.join(side_runs["jax"], "quant.sf")).splitlines(
        keepends=True)
    txps = [ln.split("\t")[0] for ln in sf[1:]]
    gene_map = str(base / "genes.tsv")
    with open(gene_map, "w") as fh:
        fh.writelines(f"{t}\tG{i // 2}\n" for i, t in enumerate(txps))
    samples = []
    for name, rows in (("a", None), ("b", None), ("c", sf[:1] + sf[5:])):
        d = base / name
        d.mkdir()
        src = side_runs["port" if name == "a" else "jax"]
        if rows is None:
            shutil.copy(os.path.join(src, "quant.sf"), d / "quant.sf")
        else:
            (d / "quant.sf").write_text("".join(rows))
        (d / "cmd_info.json").write_text(json.dumps({"geneMap": gene_map}))
        samples.append(str(d))
    return base, samples


MERGES = {
    "TPM": ["-c", "TPM"], "NumReads": ["-c", "NumReads"],
    "len": ["-c", "len"], "elen": ["-c", "elen"],
    "names": ["--names", "x", "y", "z"],
    "missing": ["-c", "numreads", "--missing", "none"],
    "genes": ["--genes", "-c", "tpm"],
}


@pytest.mark.parametrize("case", sorted(MERGES))
def test_quantmerge_byte_equal(merge_inputs, tmp_path, case):
    base, samples = merge_inputs
    outs = {}
    for name, main in (("port", cli.main), ("jax", jcli.main)):
        # each CLI on its own copy: --genes writes quant.genes.sf
        quants = []
        for s in samples:
            quants.append(str(tmp_path / name / os.path.basename(s)))
            shutil.copytree(s, quants[-1])
        outs[name] = str(tmp_path / f"{name}.tsv")
        assert main(["quantmerge", "--no-version-check", "--quants",
                     *quants, *MERGES[case], "-o", outs[name]]) == 0
    got, want = _read(outs["port"]), _read(outs["jax"])
    assert got == want
    rows = got.splitlines()
    assert rows[0] == "Name\t" + "\t".join(
        ["x", "y", "z"] if case == "names" else ["a", "b", "c"])
    assert len(rows) == 1 + (8 if case == "genes" else 15)
    if case == "missing":
        assert sum(r.endswith("\tnone") for r in rows) == 4


def test_quantmerge_missing_sample(tmp_path):
    """A sample without the file asked for fails in both CLIs."""
    (tmp_path / "empty").mkdir()
    for main in (cli.main, jcli.main):
        assert main(["quantmerge", "--no-version-check", "--quants",
                     str(tmp_path / "empty"), "-o",
                     str(tmp_path / "m.tsv")]) == 1


def test_alevin_and_swim_match_jax_cli(capsys):
    outs = {}
    for cmd, code in (("alevin", 1), ("swim", 0)):
        res = []
        for main in (cli.main, jcli.main):
            assert main([cmd]) == code
            res.append(capsys.readouterr())
        assert res[0] == res[1]
        outs[cmd] = res[0]
    assert "alevin-fry" in outs["alevin"].err and not outs["alevin"].out
    assert "><(((" in outs["swim"].out and not outs["swim"].err


def test_version_check_switches(monkeypatch, capsys):
    """The port checks the version as the JAX CLI does: skipped with
    --no-version-check, with SALMON_NO_VERSION_CHECK 1/TRUE/T and for
    alevin, else its message goes to standard error. The check itself
    is replaced here: no request leaves the machine."""
    calls = []

    def fake_message(timeout_s: float = 2.0) -> str:
        calls.append(timeout_s)
        return "Version Info: checked\n"

    monkeypatch.setattr(cli, "_version_message", fake_message)
    ap = cli.build_parser()
    for env, argv, skip in (
            ("1", ["quantmerge", "--quants", "q", "-o", "o"], True),
            ("true", ["quantmerge", "--quants", "q", "-o", "o"], True),
            ("T", ["quantmerge", "--quants", "q", "-o", "o"], True),
            ("", ["quantmerge", "--quants", "q", "-o", "o"], False),
            ("0", ["quantmerge", "--no-version-check", "--quants", "q",
                   "-o", "o"], True),
            ("", ["alevin"], True)):
        monkeypatch.setenv("SALMON_NO_VERSION_CHECK", env)
        assert cli._skip_version_check(ap.parse_args(argv)) is skip
    monkeypatch.setenv("SALMON_NO_VERSION_CHECK", "0")
    assert cli.main(["quantmerge", "--quants", "missing_dir", "-o",
                     "unused.tsv"]) == 1
    assert calls == [2.0]
    assert "Version Info: checked" in capsys.readouterr().err
    monkeypatch.setenv("SALMON_NO_VERSION_CHECK", "1")
    assert cli.main(["swim"]) == 0
    assert calls == [2.0]
