"""Multi-process execution of the port: one process per device.

Counterpart of salmon_tpu/parallel. `distributed` joins the process
group and holds the host collectives, `quant_step` the merge of a
batch's statistics over the ranks, `sharded` the sharded-index mapping
(--indexShards), `em` the eq-class-sharded EM, and `launch` starts the
processes of a run on one machine.
"""
