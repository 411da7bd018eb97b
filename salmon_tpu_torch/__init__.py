"""salmon_tpu_torch — the PyTorch/CUDA port of salmon_tpu.

Runs `index` and paired-end mapping-mode `quant` with the same flags and
output files as the JAX package (`python -m salmon_tpu`), on an NVIDIA
Hopper GPU. Host-side modules (index build and disk format, FASTQ
parsing, eq-class accumulation, writers) are the package's own copies;
the per-batch mapping pipeline and the EM are torch; the banded-DP
validation is a hand-written CUDA kernel (csrc/banded_dp.cu). The port
imports neither jax nor salmon_tpu.
"""

__version__ = "0.1.0"
