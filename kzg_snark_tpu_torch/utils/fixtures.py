"""Matrix containers for R1CS instances over a host field.

The port's copy of ``DenseMatrix`` and ``SparseMatrix`` from the JAX
package's ``utils/fixtures.py`` (the pickle loaders are not carried over).
``SparseMatrix.scale_column`` walks one column's entries through a column
index instead of every entry, so the Marlin indexer's per-column scaling
costs O(nnz) in all rather than O(n nnz); the values are the same.
"""

from __future__ import annotations

from typing import Sequence

from ..ops.host.field import FieldElement


class DenseMatrix:
    """Dense matrix over a host field; mirrors the slice of Sage's matrix
    API the reference uses (nrows/ncols at marlin/encoder.py:37, ``.T`` and
    column scaling at marlin/indexer.py:48-52, ``nonzero_positions`` at
    marlin/encoder.py:106, matvec at marlin/encoder.py:204-207)."""

    def __init__(self, field: type[FieldElement], rows: Sequence[Sequence]):
        self.field = field
        self.rows = [[e if isinstance(e, FieldElement) else field(e) for e in row]
                     for row in rows]

    def nrows(self) -> int:
        return len(self.rows)

    def ncols(self) -> int:
        return len(self.rows[0]) if self.rows else 0

    def __getitem__(self, ij):
        i, j = ij
        return self.rows[i][j]

    def nonzero_positions(self) -> list[tuple[int, int]]:
        """Row-major sorted nonzero positions (Sage default ordering)."""
        return [(i, j)
                for i, row in enumerate(self.rows)
                for j, e in enumerate(row)
                if e.n != 0]

    @property
    def T(self) -> "DenseMatrix":
        return DenseMatrix(self.field,
                           [[self.rows[i][j] for i in range(self.nrows())]
                            for j in range(self.ncols())])

    def scale_column(self, j: int, c) -> None:
        for row in self.rows:
            row[j] = row[j] * c

    def matvec(self, v: Sequence) -> list:
        out = []
        for row in self.rows:
            acc = self.field(0)
            for e, x in zip(row, v):
                if e.n != 0:
                    acc = acc + e * x
            out.append(acc)
        return out

    def __eq__(self, other):
        return isinstance(other, DenseMatrix) and self.rows == other.rows


class SparseMatrix:
    """Sparse matrix over a host field with the same API slice as
    :class:`DenseMatrix` (nrows/ncols, ``[i, j]``, row-major sorted
    ``nonzero_positions``, ``.T``, ``scale_column``, ``matvec``).

    The at-scale R1CS container: a dense n x n of host field elements is
    O(n^2) Python objects, while Marlin's encoder/indexer/prover only ever
    touch the nonzeros (``models/marlin/encoder.py``, ``indexer.py``).  Used by the
    synthetic-circuit scale tests and available to users building big
    instances (the reference's Sage matrices are dense, but nothing in the
    protocol requires that)."""

    def __init__(self, field: type[FieldElement], nrows: int, ncols: int,
                 entries: dict | None = None):
        self.field = field
        self._nrows = nrows
        self._ncols = ncols
        self.entries: dict = {}
        for (i, j), e in (entries or {}).items():
            e = e if isinstance(e, FieldElement) else field(e)
            if e.n != 0:
                self.entries[(i, j)] = e
        self._cols: dict | None = None   # column -> row indices

    def nrows(self) -> int:
        return self._nrows

    def ncols(self) -> int:
        return self._ncols

    def __getitem__(self, ij):
        return self.entries.get(tuple(ij), self.field(0))

    def nonzero_positions(self) -> list[tuple[int, int]]:
        return sorted(self.entries.keys())

    @property
    def T(self) -> "SparseMatrix":
        return SparseMatrix(
            self.field, self._ncols, self._nrows,
            {(j, i): e for (i, j), e in self.entries.items()})

    def scale_column(self, j: int, c) -> None:
        if self._cols is None:
            self._cols = {}
            for (i, jj) in self.entries:
                self._cols.setdefault(jj, []).append(i)
        for i in self._cols.get(j, ()):
            self.entries[(i, j)] = self.entries[(i, j)] * c

    def matvec(self, v: Sequence) -> list:
        out = [self.field(0)] * self._nrows
        for (i, j), e in self.entries.items():
            out[i] = out[i] + e * v[j]
        return out


def synthetic_r1cs(n: int, seed: int = 808):
    """The satisfied synthetic R1CS of the JAX package's Marlin scale test
    (``tests/test_marlin_device_scale.py``): row i enforces
    (z_i + z_{i+1 mod n}) z_i = c_i with A[i, i] = A[i, i+1 mod n] = 1
    (nnz(A) = 2n), B = I and C = diag(z_i + z_{i+1 mod n}), z_0 = 1 and
    the rest drawn from ``random.Random(seed)``.  Returns (A, B, C, z)."""
    import random

    from ..ops.host.field import scalar_field

    Fr = scalar_field("bn254")
    rng = random.Random(seed)
    z = [Fr(1)] + [Fr(rng.randrange(1, Fr.modulus)) for _ in range(n - 1)]
    A_ent, B_ent, C_ent = {}, {}, {}
    for i in range(n):
        A_ent[(i, i)] = Fr(1)
        A_ent[(i, (i + 1) % n)] = A_ent.get((i, (i + 1) % n), Fr(0)) + Fr(1)
        B_ent[(i, i)] = Fr(1)
        C_ent[(i, i)] = z[i] + z[(i + 1) % n]
    return (SparseMatrix(Fr, n, n, A_ent), SparseMatrix(Fr, n, n, B_ent),
            SparseMatrix(Fr, n, n, C_ent), z)
