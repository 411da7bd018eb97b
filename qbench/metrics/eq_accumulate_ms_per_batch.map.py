"""The program's eq-class accumulation clock per batch, ms."""


def read(run):
    return run.per_batch("eq_accumulate_seconds")
