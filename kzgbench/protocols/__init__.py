"""The program's side of each protocol: the only modules of the benchmark
that import the port (``kzg_snark_tpu_torch``).  A configuration names its
protocol; ``protocols/<protocol>.py`` defines ``Cell``."""
