"""The program's eq.merge spans (the accumulator's periodic collapse of
its buffered tables) of the window's batches per batch, ms; 0 where no
merge fell in the window."""

from qbench.metrics._program_spans import per_batch_ms


def read(run):
    return per_batch_ms(run, "eq.merge")
