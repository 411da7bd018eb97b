"""Eq-class mode (`quant -e`) and --geneMap: the port against the JAX
package.

read_eq_classes must parse a --dumpEq and a --dumpEqWeights file into
the same fields. Both CLIs' `-e` on one dump run the same EM from a
uniform start over the same classes in float32, whose sums go in
another order: quant.sf within rtol 1e-4 / atol 1e-3 (quant.sf prints
NumReads to 1e-3), num_em_iterations equal. The gene-level rollup is
float64 host code in both: quant.genes.sf equal to the last printed
digit on one quant.sf; through the two CLIs in mapping mode the gene
file inherits quant.sf's golden tolerance (rtol 5e-3 / atol 0.5, the
tie order of ROADMAP queue 3).
"""

import json
import os

import numpy as np
import pytest
import torch

from salmon_tpu import cli as jcli
from salmon_tpu.alignment import eqmode as jeq
from salmon_tpu.utils import genemap as jgm
from salmon_tpu_torch import cli
from salmon_tpu_torch.alignment import eqmode as teq
from salmon_tpu_torch.inference.eqclasses import PackedEqClasses
from salmon_tpu_torch.io import writers
from salmon_tpu_torch.utils import genemap as tgm

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
READS = ["-1", os.path.join(DATA, "reads_1.fastq"),
         "-2", os.path.join(DATA, "reads_2.fastq")]
EQ_FIELDS = ("labels", "weights", "offsets", "counts", "class_sizes")


def _txp_names():
    with open(os.path.join(DATA, "transcripts.fasta")) as fh:
        return [ln[1:].split()[0] for ln in fh if ln.startswith(">")]


def _write_gene_maps(d):
    """A TSV and a GTF mapping the sample transcripts onto 5 genes; the
    last transcript is left out of both (it becomes its own gene)."""
    names = _txp_names()
    genes = {nm: f"GENE{i % 5}" for i, nm in enumerate(names[:-1])}
    tsv, gtf = os.path.join(d, "t2g.tsv"), os.path.join(d, "genes.gtf")
    with open(tsv, "w") as fh:
        fh.writelines(f"{t}\t{g}\n" for t, g in genes.items())
    with open(gtf, "w") as fh:
        fh.write("# sample annotation\n")
        for t, g in genes.items():
            fh.write(f"chr1\ttest\texon\t1\t100\t.\t+\t.\tgene_id \"{g}\"; "
                     f"transcript_id \"{t}\";\n")
    return {"tsv": tsv, "gtf": gtf}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs' paired mapping-mode quant of the sample reads with
    --dumpEqWeights and --geneMap (the TSV), on one JAX-built index."""
    from salmon_tpu.index import builder as jb
    base = tmp_path_factory.mktemp("eqmode")
    idx = str(base / "idx")
    jb.save_index(jb.build_index(os.path.join(DATA, "transcripts.fasta"),
                                 k=31), idx)
    maps = _write_gene_maps(str(base))
    outs = {}
    for name, main, kw in (("port", cli.main, {"device": "cpu"}),
                           ("jax", jcli.main, {})):
        outs[name] = str(base / name)
        assert main(["quant", "-i", idx, "-l", "IU", *READS,
                     "--dumpEqWeights", "--geneMap", maps["tsv"], "-q",
                     "--no-version-check", "-o", outs[name]], **kw) == 0
    return outs, maps, base


def _assert_eq_equal(got, want):
    (gn, ge, gq), (wn, we, wq) = got, want
    assert gn == wn
    if we is None:
        assert ge is None
    else:
        np.testing.assert_array_equal(ge, we)
    for f in EQ_FIELDS:
        np.testing.assert_array_equal(getattr(gq, f), getattr(wq, f), f)


def test_read_eq_classes_dump_weights(runs):
    outs, _, _ = runs
    path = os.path.join(outs["port"], "aux_info", "eq_classes.txt.gz")
    got = teq.read_eq_classes(path)
    assert got[2].num_classes > 0 and got[1] is not None
    _assert_eq_equal(got, jeq.read_eq_classes(path))


@pytest.mark.parametrize("weights", [False, True],
                         ids=["dumpEq", "dumpEqWeights"])
def test_read_eq_classes_written_dumps(tmp_path, weights):
    """Random classes written by the port's --dumpEq writer, with and
    without weights, parse alike in both packages."""
    rng = np.random.default_rng(4)
    sizes = rng.integers(1, 5, 200).astype(np.int32)
    labels = np.concatenate([np.sort(rng.choice(30, s, replace=False))
                             for s in sizes]).astype(np.int32)
    w = rng.random(labels.shape[0])
    eq = PackedEqClasses(
        labels=labels, weights=w,
        offsets=np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64),
        counts=rng.integers(1, 100, 200).astype(np.float64),
        class_sizes=sizes)
    names = [f"T{i}" for i in range(30)]
    writers.write_eq_classes(str(tmp_path), "aux", names, eq,
                             dump_weights=weights,
                             eff_lens=rng.random(30) * 1000)
    path = str(tmp_path / "aux" / "eq_classes.txt.gz")
    got = teq.read_eq_classes(path)
    _assert_eq_equal(got, jeq.read_eq_classes(path))
    np.testing.assert_array_equal(got[2].labels, labels)


@pytest.mark.parametrize("mode", ["vbem", "em", "geneMap"])
def test_cli_eqmode_matches_jax(runs, mode):
    outs, maps, base = runs
    flags = {"vbem": [], "em": ["--useEM"],
             "geneMap": ["--geneMap", maps["gtf"]]}[mode]
    res = {}
    for name, main, kw in (("port", cli.main, {"device": "cpu"}),
                           ("jax", jcli.main, {})):
        out = str(base / f"e_{name}_{mode}")
        assert main(["quant", "-e", outs["port"], "-l", "A", *flags, "-q",
                     "--no-version-check", "-o", out], **kw) == 0
        sf = writers.read_quant_sf(os.path.join(out, "quant.sf"))
        with open(os.path.join(out, "aux_info", "meta_info.json")) as fh:
            meta = json.load(fh)
        res[name] = (sf, meta, out)
    (sf, meta, out), (jsf, jmeta, jout) = res["port"], res["jax"]
    assert sf["Name"] == jsf["Name"]
    for col in ("Length", "EffectiveLength", "TPM", "NumReads"):
        np.testing.assert_allclose(sf[col], jsf[col], rtol=1e-4, atol=1e-3,
                                   err_msg=col)
    assert meta["num_em_iterations"] == jmeta["num_em_iterations"]
    assert set(meta) == set(jmeta)
    for key in ("mapping_type", "opt_type", "num_eq_classes",
                "num_processed", "num_mapped", "em_converged"):
        assert meta[key] == jmeta[key], key
    assert meta["mapping_type"] == "eqclass"
    if "--geneMap" in flags:
        g, j = (writers.read_quant_sf(os.path.join(d, "quant.genes.sf"))
                for d in (out, jout))
        assert g["Name"] == j["Name"] and len(g["Name"]) == 6
        np.testing.assert_allclose(g["NumReads"], j["NumReads"], rtol=1e-4,
                                   atol=1e-3)


@pytest.mark.parametrize("kind", ["tsv", "gtf"])
def test_aggregate_quant_sf_matches_jax(runs, tmp_path, kind):
    """The rollup of one quant.sf: quant.genes.sf equal to the JAX
    package's, byte for byte."""
    outs, maps, _ = runs
    sf = os.path.join(outs["port"], "quant.sf")
    for name, fn in (("port", tgm.aggregate_quant_sf),
                     ("jax", jgm.aggregate_quant_sf)):
        d = tmp_path / name
        d.mkdir()
        (d / "quant.sf").write_text(open(sf).read())
        fn(str(d / "quant.sf"), maps[kind])
    assert (tmp_path / "port" / "quant.genes.sf").read_text() == \
        (tmp_path / "jax" / "quant.genes.sf").read_text()
    assert tgm.load_gene_map(maps[kind]) == jgm.load_gene_map(maps[kind])


def test_cli_gene_map_in_mapping_mode(runs):
    """--geneMap after mapping-mode quant in both CLIs: the same genes,
    totals within quant.sf's golden tolerance."""
    outs, _, _ = runs
    g, j = (writers.read_quant_sf(os.path.join(outs[k], "quant.genes.sf"))
            for k in ("port", "jax"))
    assert g["Name"] == j["Name"] and len(g["Name"]) == 6
    np.testing.assert_allclose(g["NumReads"], j["NumReads"], rtol=5e-3,
                               atol=0.5)
    np.testing.assert_allclose(g["TPM"], j["TPM"], rtol=5e-3, atol=0.5)
    assert g["NumReads"].sum() == pytest.approx(10000, abs=1.0)
