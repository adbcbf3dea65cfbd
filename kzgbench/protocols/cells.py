"""PeerDAS cells and cell proofs through the port (EIP-7594
``compute_cells_and_kzg_proofs`` for a batch of blobs), beside each blob's
commitment.

A batch: the iNTT of every blob (values at the domain's points, natural
order) to coefficients; one k-set MSM over the n SRS points for the
commitments; then, in the harness's ``cell_proofs`` span,
``KZG.compute_cells_and_kzg_proofs`` on those coefficients: the extension
to 2n values in the cells' order (``CellsDeviceCore.eval_dev``, the port's
``fk20.extend`` span) and every cell's proof by FK20 (the columns'
transforms, one grouped MSM for all cells and blobs, the G1 transform as a
second grouped MSM, the proofs to affine ints); then the cells to the specs' bytes
(``cells_to_bytes``: the byte order on the card, one read) and the points
compressed on the host.
"""

from __future__ import annotations

from kzg_snark_tpu_torch.ops.fk20 import cells_to_bytes

from ..plain.cells import cell_width
from ..plain.curves import compress
from .common import PortCell


class Cell(PortCell):
    def __init__(self, config, *args):
        super().__init__(config, *args)
        self.width = min(config["field_elements_per_cell"], cell_width(self.n))
        # The FK20 core of the KZG's device SRS (its set-up table is built
        # here); its ``eval_dev`` produces the cells' values.
        self.core = self.kzg.cells_core(self.n, self.width)

    def msm_calls(self) -> list:
        return [(self.n, self.batch)]

    def run_batch(self, slot: int) -> dict:
        k, curve = self.batch, self.curve
        coeffs = self.coefficients(slot)
        commitments = self.commit(coeffs, k, "commit.polys")
        with self.span("cell_proofs"):
            cells, proofs = self.kzg.compute_cells_and_kzg_proofs(
                self.pool[slot], cell_width=self.width, coeffs=coeffs)
        with self.span("host.results"):
            evaluations = cells_to_bytes(cells)
            flat = [P for row in proofs for P in row]
            encoded = [compress(P, curve) for P in commitments + flat]
        return {"commitments": commitments, "evaluations": evaluations,
                "proofs": flat, "proof_bytes": encoded}
