"""The program's quant.wait spans (the host blocked on the first copy
of a batch's outputs, until the card has finished the batch) of the
window's batches per batch, ms."""

from qbench.metrics._program_spans import per_batch_ms


def read(run):
    return per_batch_ms(run, "quant.wait")
