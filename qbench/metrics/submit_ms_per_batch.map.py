"""The program's quant.submit spans (the FLD snapshot, the batch's
copies to the card and the batch step's launch, to its return) of the
window's batches per batch, ms."""

from qbench.metrics._program_spans import per_batch_ms


def read(run):
    return per_batch_ms(run, "quant.submit")
