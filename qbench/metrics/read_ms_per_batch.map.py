"""The program's read clock (FASTQ read, parse and pack) per batch, ms."""


def read(run):
    return run.per_batch("read_seconds")
