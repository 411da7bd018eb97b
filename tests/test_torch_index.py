"""Index parity between the JAX package and the PyTorch port.

The port keeps its own copy of the host-side index code (numpy only, no
native library). Its build must give the same arrays as the JAX
package's, each package must load the other's saved index, and the
port's device tensors must be bit-equal to the JAX package's device
arrays. All comparisons are exact: these are integer planes.
"""

import json
import os

import numpy as np
import pytest
import torch

from salmon_tpu.index import builder as jb
from salmon_tpu.mapping import align as jalign
from salmon_tpu.mapping import pipeline as jpipe
from salmon_tpu_torch.index import builder as tb
from salmon_tpu_torch.mapping import align as talign
from salmon_tpu_torch.mapping import pipeline as tpipe

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(__file__), "data")
FASTA = os.path.join(DATA, "transcripts.fasta")

ARRAYS = ("lengths", "complete_lengths", "kmers", "occ_offsets", "occ_txp",
          "occ_pf", "seq_codes", "seq_offsets", "occ_counts")


def assert_same_index(a, b):
    assert a.k == b.k
    assert list(a.names) == list(b.names)
    assert a.first_decoy_index == b.first_decoy_index
    for name in ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)),
                                      err_msg=name)
    assert (a.occ_true_counts is None) == (b.occ_true_counts is None)
    np.testing.assert_array_equal(a.table.rows, b.table.rows)
    assert a.table.n_slots == b.table.n_slots
    assert a.table.max_probes == b.table.max_probes
    for key in ("k", "num_kmers", "num_occurrences", "occ_oct_aligned",
                "table_inline_singles", "index_format_version"):
        assert a.info.get(key) == b.info.get(key), key


@pytest.fixture(scope="module", params=[25, 31], ids=["k25", "k31"])
def both_built(request):
    k = request.param
    return jb.build_index(FASTA, k=k), tb.build_index(FASTA, k=k)


def test_build_index_matches(both_built):
    assert_same_index(*both_built)


def test_build_index_pruned_matches():
    """--maxOccsKept prunes the CSR the same way in both packages."""
    assert_same_index(jb.build_index(FASTA, k=31, max_occs_kept=2),
                      tb.build_index(FASTA, k=31, max_occs_kept=2))


def test_each_package_loads_the_others_index(both_built, tmp_path):
    jidx, tidx = both_built
    jdir, tdir = str(tmp_path / "jax_idx"), str(tmp_path / "torch_idx")
    jb.save_index(jidx, jdir)
    tb.save_index(tidx, tdir)
    assert_same_index(tb.load_index(jdir), jidx)
    assert_same_index(jb.load_index(tdir), tidx)
    assert_same_index(tb.load_index(tdir), jb.load_index(jdir))


def test_v4_layout_loads_the_same(both_built, tmp_path):
    """A v4 directory (one raw .npy per plane, pos and fwd apart), as
    older JAX-package builds wrote it, loads the same in both packages."""
    jidx, _ = both_built
    d = tmp_path / "v4_idx"
    d.mkdir()
    planes = {name: getattr(jidx, name) for name in (
        "lengths", "complete_lengths", "kmers", "occ_offsets", "occ_txp",
        "seq_codes", "seq_offsets")}
    pf = np.asarray(jidx.occ_pf)
    planes.update(occ_pos=pf >> 1, occ_fwd=(pf & 1).astype(np.uint8),
                  table_rows=jidx.table.rows)
    for name, arr in planes.items():
        np.save(d / f"{name}.npy", np.asarray(arr))
    meta = dict(jidx.info, index_format_version=4, k=jidx.k,
                first_decoy_index=jidx.first_decoy_index,
                table_n_slots=jidx.table.n_slots,
                table_max_probes=jidx.table.max_probes)
    (d / "info.json").write_text(json.dumps(meta, default=str))
    (d / "ref_names.txt").write_text("\n".join(jidx.names) + "\n")
    got = tb.load_index(str(d))
    assert_same_index(got, jb.load_index(str(d)))
    # v4 keeps no count plane (counts come from the padded offsets), so
    # it is held to the built index through what the mapper reads
    want = jpipe.device_index_arrays(jidx)
    for name, t in tpipe.device_index_tensors(got, device="cpu").items():
        np.testing.assert_array_equal(t.numpy().view(want[name].dtype),
                                      np.asarray(want[name]), err_msg=name)


def test_device_index_tensors_bit_equal(both_built):
    jidx, tidx = both_built
    want = jpipe.device_index_arrays(jidx)
    got = tpipe.device_index_tensors(tidx, device="cpu")
    for name in ("tab_rows", "occ_oct", "txp_lens", "seq_off"):
        w = np.asarray(want[name])
        g = got[name].numpy()
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    # seq4 is carried as int32 bit patterns of the uint32 words
    w = np.asarray(want["seq4"])
    assert got["seq4"].dtype == torch.int32
    np.testing.assert_array_equal(got["seq4"].numpy().view(np.uint32), w)


def test_pack_seq4_matches_with_n_fill():
    """N bases pack as the position-derived base (i & 3) in both."""
    rng = np.random.default_rng(41)
    seq = rng.integers(0, 5, 5000).astype(np.uint8)
    for lead in (256, tpipe._SEQ4_SHIFT):
        w_j, s_j = jalign.pack_seq4(seq, lead_pad=lead)
        w_t, s_t = talign.pack_seq4(seq, lead_pad=lead)
        assert s_j == s_t
        np.testing.assert_array_equal(w_t, w_j)
