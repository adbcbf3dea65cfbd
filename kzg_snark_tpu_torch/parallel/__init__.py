"""Multi-device layer: the counterpart of ``kzg_snark_tpu/parallel/`` on
``torch.distributed`` (one process a device; NCCL between GPUs, gloo on
the CPU)."""
