"""cell_proofs_ms (KZG device layer): device ms a traced batch of every
kernel and torch op launched in the ``cell_proofs`` span, the whole
``compute_cells_and_kzg_proofs`` call: the extension, FK20's column
transforms, its two grouped MSMs and the affine conversion of the
proofs."""

from . import span_device_ms


def read(record):
    return span_device_ms(record, "cell_proofs")
