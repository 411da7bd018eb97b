"""What the harness reads from the program while it runs.

- `LogTap`: a logging handler on the program's logger. It keeps every
  clocks record (`extra={"clocks": ...}`) and the time and fragment
  count of every per-batch progress record (the regex is a frozen copy
  of the port's quant_window's), and calls back on each batch, which is
  how the window opens and closes.
- `Taps`: wrappers around two calls at layer boundaries, installed for
  one run and removed after it: the eq-class accumulator's add_batch
  (the batch step's per-fragment labels as the host receives them: the
  rows of the sampled batches are copied whole, and every batch's
  mapped fragments are kept as flat arrays, the input of the
  reference's eq classes) and the EM's optimize (its inputs and its
  answer). They read what passes and change nothing.
"""

from __future__ import annotations

import logging
import re
import time

import numpy as np

PROCESSED_RE = re.compile(r"processed\s+([0-9,]+)\s+fragments",
                          re.IGNORECASE)
LOGGER = "salmon_tpu_torch"
INVALID = 0x7FFFFFFF


class LogTap(logging.Handler):
    def __init__(self, on_batch=None):
        super().__init__(level=logging.INFO)
        self.clocks = {}
        self.progress = []        # (perf_counter, fragments processed)
        self.on_batch = on_batch

    def emit(self, record: logging.LogRecord) -> None:
        t = time.perf_counter()
        clocks = getattr(record, "clocks", None)
        if clocks:
            self.clocks.update(clocks)
            return
        m = PROCESSED_RE.search(record.getMessage())
        if m:
            frags = int(m.group(1).replace(",", ""))
            self.progress.append((t, frags))
            if self.on_batch is not None:
                self.on_batch(len(self.progress), t, frags)

    def install(self):
        lg = logging.getLogger(LOGGER)
        self._level = lg.level
        lg.setLevel(logging.INFO)
        lg.addHandler(self)
        return self

    def remove(self) -> None:
        lg = logging.getLogger(LOGGER)
        lg.removeHandler(self)
        lg.setLevel(self._level)


def flat_labels(eq_txp, eq_weight, eq_bins) -> tuple:
    """(sizes, transcripts, weights, bins or None) of a batch's mapped
    fragments, flat; labels are left-packed and padded with INVALID."""
    ok = eq_txp != INVALID
    rows = ok[:, 0]
    w = int(np.count_nonzero(ok.any(axis=0)))
    ok = ok[rows, :w]
    sizes = ok.sum(axis=1).astype(np.uint8)
    return (sizes, eq_txp[rows, :w][ok], eq_weight[rows, :w][ok],
            None if eq_bins is None else eq_bins[rows, :w][ok])


class Taps:
    """`want(batch_index)` says which batches' label rows to keep. With
    `spans`, the FASTQ reader's chunks and the eq accumulation run inside
    profiler ranges ("qbench: FASTQ read", "qbench: eq accumulation"), so
    that a trace can name the host's work in the device's idle gaps."""

    def __init__(self, want, spans: bool = False):
        self.want = want
        self.spans = spans
        self.batches = {}         # batch index -> (eq_txp, eq_weight)
        self.labels = []          # every batch: (sizes, txp, weight, bins)
        self.ems = []             # one dict per optimize call
        self.n_batches = 0
        self._undo = []

    def install(self):
        from torch.profiler import record_function

        from salmon_tpu_torch import quant
        from salmon_tpu_torch.inference import em as em_mod
        from salmon_tpu_torch.inference import eqclasses

        acc_cls = eqclasses.EquivalenceClassAccumulator
        add_batch = acc_cls.add_batch
        optimize = em_mod.optimize
        taps = self

        def tapped_add_batch(self, eq_txp, eq_weight, eq_bins=None):
            b = taps.n_batches
            taps.n_batches += 1
            if taps.want(b):
                taps.batches[b] = (np.array(eq_txp), np.array(eq_weight))
            taps.labels.append(flat_labels(eq_txp, eq_weight, eq_bins))
            if not taps.spans:
                return add_batch(self, eq_txp, eq_weight, eq_bins)
            with record_function("qbench: eq accumulation"):
                return add_batch(self, eq_txp, eq_weight, eq_bins)

        def tapped_optimize(eq, num_txps, eff_lens, *args, **kw):
            res = optimize(eq, num_txps, eff_lens, *args, **kw)
            taps.ems.append({"eq": eq, "num_txps": num_txps,
                             "eff_lens": np.array(eff_lens, np.float64),
                             "args": args, "kw": kw,
                             "alphas": np.array(res["alphas"]),
                             "iterations": int(res["iterations"])})
            return res

        acc_cls.add_batch = tapped_add_batch
        em_mod.optimize = tapped_optimize
        self._undo = [(acc_cls, "add_batch", add_batch),
                      (em_mod, "optimize", optimize)]
        if self.spans:
            chunks = quant.iter_paired_chunks

            def traced_chunks(*a, **kw):
                it = chunks(*a, **kw)
                while True:
                    with record_function("qbench: FASTQ read"):
                        try:
                            c = next(it)
                        except StopIteration:
                            return
                    yield c

            quant.iter_paired_chunks = traced_chunks
            self._undo.append((quant, "iter_paired_chunks", chunks))
        return self

    def remove(self) -> None:
        for obj, name, orig in self._undo:
            setattr(obj, name, orig)
        self._undo = []
