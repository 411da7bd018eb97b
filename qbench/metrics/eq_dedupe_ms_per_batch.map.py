"""The program's eq.dedupe spans (each batch's dedupe of its label rows
in the eq-class accumulator) of the window's batches per batch, ms."""

from qbench.metrics._program_spans import per_batch_ms


def read(run):
    return per_batch_ms(run, "eq.dedupe")
