"""The port's index sharding (salmon_tpu_torch/index/shard.py) against
the JAX package's: owners, the in-RAM shard planes (all shards, or one
shard built alone, as a rank builds its own), the streamed planes of a
saved table-less index, and the mapper configuration of a table-less
index. All exact."""

import dataclasses
import os

import numpy as np
import pytest

from salmon_tpu.index import builder as jbuilder
from salmon_tpu.index import shard as jshard
from salmon_tpu.mapping.pipeline import MapperConfig as JMapperConfig
from salmon_tpu_torch.constants import SalmonDefaults
from salmon_tpu_torch.index import shard
from salmon_tpu_torch.index.builder import build_index, load_index
from salmon_tpu_torch.mapping.pipeline import MapperConfig

FASTA = os.path.join(os.path.dirname(__file__), "data", "transcripts.fasta")


@pytest.fixture(scope="module")
def indexes():
    """(port index, JAX index) of the sample transcripts, k = 25."""
    return build_index(FASTA, k=25), jbuilder.build_index(FASTA, k=25)


@pytest.fixture(scope="module")
def tableless_dir(tmp_path_factory):
    """A table-less, pruned index saved by the JAX package's partitioned
    build (the genome-scale layout, forced at toy scale as
    tests/test_sharded_index.py does)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jbuilder, "TABLE_DIRECT_MAX_KEYS", 1)
    try:
        idx = jbuilder.build_index(FASTA, k=25, partition_bits=2,
                                   max_occs_kept=4)
    finally:
        mp.undo()
    assert idx.table is None
    d = str(tmp_path_factory.mktemp("tl") / "idx")
    jbuilder.save_index(idx, d)
    return d


@pytest.mark.parametrize("bits", [0, 1, 2, 3])
def test_shard_owner_matches_jax(bits):
    rng = np.random.default_rng(bits)
    hi = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    lo = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(shard.shard_owner(hi, lo, bits),
                                  jshard.shard_owner(hi, lo, bits))


@pytest.mark.parametrize("n_shards", [2, 4])
def test_shard_index_arrays_matches_jax(indexes, n_shards):
    port_idx, jax_idx = indexes
    got = shard.shard_index_arrays(port_idx, n_shards)
    want = jshard.shard_index_arrays(jax_idx, n_shards)
    for f in ("n_shards", "shard_bits", "n_slots", "n_evicted"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.tab_rows, want.tab_rows)
    np.testing.assert_array_equal(got.occ_oct, want.occ_oct)
    assert got.shards == tuple(range(n_shards))


@pytest.mark.parametrize("n_shards", [2, 4])
def test_one_shard_alone_equals_its_row(indexes, n_shards):
    """A shard built alone (a rank's own) has the common slot count and
    the planes of its row of the JAX package's full build; its
    occurrence plane is only as long as the shard needs."""
    port_idx, jax_idx = indexes
    want = jshard.shard_index_arrays(jax_idx, n_shards)
    for s in range(n_shards):
        got = shard.shard_index_arrays(port_idx, n_shards, shards=[s])
        assert got.n_slots == want.n_slots and got.shards == (s,)
        np.testing.assert_array_equal(got.tab_rows[0], want.tab_rows[s])
        n = got.occ_oct.shape[1]
        np.testing.assert_array_equal(got.occ_oct[0], want.occ_oct[s, :n])
        assert not want.occ_oct[s, n:].any()


@pytest.mark.parametrize("n_shards", [2, 4])
def test_iter_shard_arrays_matches_jax(tableless_dir, n_shards):
    got = list(shard.iter_shard_arrays(tableless_dir, n_shards,
                                       load_factor=0.5,
                                       max_load_factor=0.62))
    want = list(jshard.iter_shard_arrays(tableless_dir, n_shards,
                                         load_factor=0.5,
                                         max_load_factor=0.62))
    assert [s for s, _, _ in got] == list(range(n_shards))
    for (s, meta, g), (ws, wmeta, w) in zip(got, want):
        assert s == ws and meta == wmeta
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    # one shard alone, as a rank streams it
    (s, _, alone), = shard.iter_shard_arrays(
        tableless_dir, n_shards, load_factor=0.5, max_load_factor=0.62,
        shards=[n_shards - 1])
    for k in alone:
        np.testing.assert_array_equal(alone[k], want[-1][2][k], err_msg=k)


def test_tableless_index_shards_like_jax(tableless_dir):
    """The port loads the JAX package's table-less index and shards it
    as the JAX package does."""
    got = shard.shard_index_arrays(load_index(tableless_dir), 2)
    want = jshard.shard_index_arrays(jbuilder.load_index(tableless_dir), 2)
    assert got.n_slots == want.n_slots
    np.testing.assert_array_equal(got.tab_rows, want.tab_rows)
    np.testing.assert_array_equal(got.occ_oct, want.occ_oct)


def test_non_power_of_two_shards_raise(indexes):
    with pytest.raises(ValueError, match="power of two"):
        shard.shard_index_arrays(indexes[0], 3)


def test_tableless_config_matches_jax(indexes):
    """Without a table MapperConfig.from_index raises JAX's ValueError;
    with allow_no_table it has JAX's fields (n_slots 0, max_probes 16)."""
    port_idx, jax_idx = indexes
    p_tl = dataclasses.replace(port_idx, table=None)
    j_tl = dataclasses.replace(jax_idx, table=None)
    for opts in (SalmonDefaults(), dataclasses.replace(SalmonDefaults(),
                                                       sparse_seed=True)):
        with pytest.raises(ValueError, match="--indexShards"):
            MapperConfig.from_index(p_tl, opts)
    got = MapperConfig.from_index(p_tl, allow_no_table=True)
    want = JMapperConfig.from_index(j_tl, allow_no_table=True)
    assert (got.n_slots, got.max_probes) == (0, 16)
    common = {f.name for f in dataclasses.fields(want)} & {
        f.name for f in dataclasses.fields(got)}
    assert {f: getattr(got, f) for f in common} == \
        {f: getattr(want, f) for f in common}
