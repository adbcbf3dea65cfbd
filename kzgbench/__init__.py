"""The benchmark of the PyTorch + CUDA port (``kzg_snark_tpu_torch``):
batched KZG commit-and-open on one H100.  ``python3 -m kzgbench.run`` runs
one cell of ``BENCHMARK.json``; see ``kzgbench/harness.py``."""
