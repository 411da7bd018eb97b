"""The program's consume clock (copies back, FLD, counters, less the eq
accumulation) per batch, ms."""


def read(run):
    return run.per_batch("consume_seconds")
