"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here needs an NVIDIA GPU and skips without one.
The file imports nothing of JAX, so it also runs on a GPU machine that
has no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(--noconftest leaves out tests/conftest.py, which sets up JAX for the
other test files.) Banded-DP scores are small integer sums in float32,
and the kernel computes them in int32, so kernel and plain version must
agree exactly.
"""

import numpy as np
import pytest
import torch

from salmon_tpu_torch.mapping import align
from salmon_tpu_torch.mapping.pipeline import _SEQ4_SHIFT

MA, MP, GO, GE = 2.0, -4.0, 6.0, 2.0
# the main DP's band (15), narrower and wider ones, the rescue band (80)
# and the widest the kernel takes (127); 0, 1, 16, 31 and 32 put B = 2 bw
# + 1 at the edges of the kernel's cells per lane (C) and lanes (G)
BANDWIDTHS = [0, 1, 7, 15, 16, 31, 32, 40, 80, 127]
MODES = [dict(), dict(softclip=True), dict(softclip_overhangs=True),
         dict(softclip=True, softclip_overhangs=True)]
MODE_IDS = ["plain", "softclip", "overhangs", "softclip+overhangs"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU "
                    "mode (python3 chip_smoke.py also runs it on the card)")
    return torch.device("cuda")


def dp_problems(seed: int, off_dtype, dev, bw=15, n_txps=30, L=128,
                P=2000):
    """Banded-DP arguments for P problems over random transcripts with N
    bases: ragged reads left- or flip-aligned, the first quarter placed
    near where its read row came from (within 3 bases, at most the band;
    for bands of 40 and more within 3/4 of the band, at most 60 as the
    rescue places mates), the rest at random reference starts on, near
    and off the transcript ends, reading rows
    shared between problems (two ids out of range, which clip). Returns
    (args, kwargs) of banded_scores_indexed."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(150, 1500, n_txps)
    off = np.concatenate([[0], np.cumsum(lens)])
    seq = rng.integers(0, 4, off[-1]).astype(np.uint8)
    seq[rng.random(seq.shape[0]) < 0.005] = 4
    words, _ = align.pack_seq4(seq, lead_pad=_SEQ4_SHIFT)
    NR = P // 4
    reads = rng.integers(0, 4, (NR, L)).astype(np.uint8)
    reads[rng.random((NR, L)) < 0.02] = 4
    t = rng.integers(0, n_txps, P)
    ids = np.concatenate([np.arange(NR), rng.integers(0, NR, P - NR)])
    ids = ids.astype(np.int32)
    rl = rng.integers(30, L + 1, P).astype(np.int32)
    rs = np.where(rng.random(P) < 0.5, L - rl, 0).astype(np.int32)
    rb = rng.integers(-60, 1500, P).astype(np.int32)
    for p in range(NR):
        b = int(rng.integers(0, max(lens[t[p]] - rl[p], 1)))
        src = seq[off[t[p]] + b: off[t[p]] + b + rl[p]]
        reads[ids[p], rs[p]:rs[p] + src.shape[0]] = src
        jitter = min(3, bw) if bw < 40 else min(60, 3 * bw // 4)
        rb[p] = b - rs[p] + int(rng.integers(-jitter, jitter + 1))
    ids[-2:] = (-1, NR)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    args = (put(reads), put(ids), put(rl), put(rb),
            put(lens[t].astype(np.int32)), None, put(off[t].astype(off_dtype)),
            bw, MA, MP, GO, GE)
    kwargs = dict(seq_words=put(words.view(np.int32)),
                  seq_words_shift=_SEQ4_SHIFT, read_starts=put(rs))
    return args, kwargs


@pytest.mark.cuda
@pytest.mark.parametrize("off_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("bw", BANDWIDTHS)
def test_banded_dp_kernel_matches_plain(cuda, bw, mode, off_dtype):
    args, kwargs = dp_problems(11 + bw, off_dtype, cuda, bw=bw)
    kwargs.update(mode)
    before = align.BANDED_DP.by_shape.get(bw, 0)
    got = align.banded_scores_indexed(*args, **kwargs)
    want = align._banded_scores_plain(*args, **kwargs)
    torch.cuda.synchronize()
    assert align.BANDED_DP.by_shape[bw] == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    assert (want > 0).float().mean().item() > 0.2   # a quarter align


@pytest.mark.cuda
def test_banded_dp_kernel_rejects_what_it_does_not_take(cuda):
    args, kwargs = dp_problems(12, np.int32, cuda, P=64)
    before = align.BANDED_DP.launches
    limit = align.MAX_KERNEL_BANDWIDTH
    with pytest.raises(ValueError, match=f"0 to {limit}, not {limit + 1}"):
        align.banded_scores_indexed(*args[:7], limit + 1, *args[8:],
                                    **kwargs)
    with pytest.raises(TypeError, match="read_ids"):
        align.banded_scores_indexed(args[0], args[1].long(), *args[2:],
                                    **kwargs)
    with pytest.raises(ValueError, match="read_lens"):
        align.banded_scores_indexed(*args[:2], args[2][:-1], *args[3:],
                                    **kwargs)
    assert align.BANDED_DP.launches == before


@pytest.mark.cuda
def test_banded_dp_kernel_refuses_non_integer_scores(cuda):
    """The kernel's cells are int32: a fractional score (--ma 2.5) or one
    of magnitude 2^20 or more is refused before any launch."""
    args, kwargs = dp_problems(13, np.int32, cuda, P=64)
    before = align.BANDED_DP.launches
    with pytest.raises(ValueError, match="integer scores"):
        align.banded_scores_indexed(*args[:8], 2.5, *args[9:], **kwargs)
    with pytest.raises(ValueError, match=str(2 ** 20)):
        align.banded_scores_indexed(*args[:11], float(2 ** 20), **kwargs)
    assert align.BANDED_DP.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["paired", "single", "rescue", "sparse"])
def test_graph_step_matches_eager(cuda, mode):
    """map_paired_batch / map_single_batch through their CUDA graph
    against the eager map_*_batch_impl on the sample reads, 4 batches of
    1,024 whose reads and FLD differ (the first runs eagerly, the second
    captures, every one after replays): every output key bit-equal but
    txp_mass (float32 index_add_, its atomic adds in another order on
    every run; rtol 1e-5), banded_dp counted as eagerly, one capture and
    3 replays (scripts/bench_graph_step.run_mode checks all of it)."""
    import os

    from salmon_tpu_torch.index.builder import build_index
    from salmon_tpu_torch.mapping import pipeline
    from salmon_tpu_torch.scripts import bench_graph_step as bgs
    from salmon_tpu_torch.utils import libformat

    data = os.path.join(os.path.dirname(__file__), "data")
    idx = build_index(os.path.join(data, "transcripts.fasta"), k=31)
    batches = bgs.load_batches(os.path.join(data, "reads_1.fastq"),
                               os.path.join(data, "reads_2.fastq"), 1024, 4,
                               cuda)
    fmt = libformat.parse_library_format("IU")
    compat = tuple(torch.as_tensor(t, device=cuda) for t in (
        libformat.paired_compat_table(fmt),
        libformat.orphan_compat_table(fmt)))
    flds = bgs.fld_inputs(batches, pipeline.device_index_tensors(idx, cuda),
                          pipeline.MapperConfig.from_index(idx), compat,
                          cuda)
    assert not torch.equal(flds[1]["logpmf"], flds[2]["logpmf"])
    rec = bgs.run_mode(mode, idx, batches, flds, cuda)
    assert rec["counters"] == {"eager": 1, "captures": 1, "replays": 3}
    assert rec["mapped_fraction"] > 0.9
