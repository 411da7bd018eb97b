"""Posterior-sampled BAM output (`--sampleOut` / `--sampleUnaligned`).

Host copy of salmon_tpu/alignment/sampler.py (reference
salmon::sampler::sampleLibrary, include/salmon/internal/alignment/
Sampler.hpp:342, called from SalmonQuantifyAlignments.cpp:1317): after
quantification, re-walk the alignments and emit one record per
fragment, sampled from its alignments with probability proportional to
the final posterior (abundance x alignment weight). Output:
postSample.bam in the output directory.
"""

from __future__ import annotations

import struct

import numpy as np

from salmon_tpu_torch.alignment.bamio import _bgzf_block, bam_header, pack_seq4

# base code 0..4 (A C G T N) -> 4-bit BAM code; anything else is N
_CODE4_OF_BASE = np.full(256, 15, dtype=np.uint8)
_CODE4_OF_BASE[:5] = (1, 2, 4, 8, 15)


class BamWriter:
    """Streaming BGZF/BAM writer."""

    def __init__(self, path: str, ref_names, ref_lens):
        self._fh = open(path, "wb")
        self._buf = bam_header(ref_names, ref_lens)
        self._maybe_flush()

    def _maybe_flush(self, force=False):
        while len(self._buf) >= 60000 or (force and self._buf):
            chunk = bytes(self._buf[:60000])
            del self._buf[:60000]
            self._fh.write(_bgzf_block(chunk))

    def add_record(self, name: bytes, refid: int, pos: int, flag: int,
                   mapq: int, cigar_ops, cigar_lens, seq_codes,
                   mate_refid: int = -1, mate_pos: int = -1,
                   tlen: int = 0, zw: float | None = None):
        nameb = bytes(name) + b"\0"
        lseq = int(seq_codes.shape[0])
        s4 = pack_seq4(_CODE4_OF_BASE[np.asarray(seq_codes, np.uint8)])
        qual = b"\xff" * lseq
        tags = b"ZWf" + struct.pack("<f", float(zw)) if zw is not None \
            else b""
        n_cig = len(cigar_ops)
        rec = struct.pack(
            "<iiBBHHHiiii", int(refid), int(pos), len(nameb), int(mapq),
            0, n_cig, int(flag), lseq, int(mate_refid), int(mate_pos),
            int(tlen))
        rec += nameb
        rec += b"".join(struct.pack("<I", (int(cl) << 4) | int(co))
                        for co, cl in zip(cigar_ops, cigar_lens))
        rec += s4 + qual + tags
        self._buf += struct.pack("<i", len(rec)) + rec
        self._maybe_flush()

    def close(self):
        self._maybe_flush(force=True)
        self._fh.write(_bgzf_block(b""))
        self._fh.close()


def sample_fragments(rng, fid, weights):
    """One sampled alignment index per fragment.

    fid: (n,) sorted fragment ids; weights: (n,) linear posterior
    weights. Returns indices into the flat arrays, one per fragment.
    """
    order = np.argsort(fid, kind="stable")
    f_s = fid[order]
    w_s = np.maximum(weights[order], 0.0)
    starts = np.concatenate([[0], np.nonzero(f_s[1:] != f_s[:-1])[0] + 1])
    counts = np.diff(np.concatenate([starts, [f_s.shape[0]]]))
    tot = np.add.reduceat(w_s, starts)
    cum = np.cumsum(w_s)
    cum_before = np.concatenate([[0], cum])[starts]
    u = rng.random(starts.shape[0]) * np.maximum(tot, 1e-300)
    targets = cum_before + u
    pick = np.searchsorted(cum, targets, side="left")
    pick = np.minimum(pick, starts + counts - 1)
    return order[pick]
