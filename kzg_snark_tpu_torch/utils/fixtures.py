"""R1CS and PLONK instances over a host field, and their Sage-free loaders.

The port's copy of the JAX package's ``utils/fixtures.py``: the matrix
containers ``DenseMatrix`` and ``SparseMatrix``, the instances
``R1CSInstance`` and ``PlonkInstance`` with ``check_satisfied``, and
``load_r1cs`` / ``load_plonk`` for the reference's two SageMath pickles
(``R1CS_INSTANCE.pkl``: dense matrices A, B, C over GF(r) and the
assignment z; ``PLONK_ARITHMETIZATION_INSTANCE.pkl``: five selector lists,
a wire permutation and the wire values).  Unpickling needs Sage's
reconstruction hooks; ``_SageShimUnpickler`` maps exactly the callables
the two files reference (``sage.rings.integer.make_integer``, a base-32
string; ``integer_mod.Mod``; ``matrix0.unpickle``, a flat row-major entry
list; free-module elements) and returns inert tokens for Sage's parent
and factory plumbing.

``SparseMatrix.scale_column`` walks one column's entries through a column
index instead of every entry, so the Marlin indexer's per-column scaling
costs O(nnz) in all rather than O(n nnz); the values are the same.
``synthetic_r1cs`` builds the satisfied synthetic circuit of the scale
tests over either curve's scalar field.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass
from typing import Sequence

from ..ops.host.field import FieldElement, scalar_field


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


@dataclass
class R1CSInstance:
    """R1CS fixture: A z (.) B z == C z with z = (x || w)."""
    A: DenseMatrix
    B: DenseMatrix
    C: DenseMatrix
    z: list

    def check_satisfied(self) -> bool:
        az = self.A.matvec(self.z)
        bz = self.B.matvec(self.z)
        cz = self.C.matvec(self.z)
        return all(a * b == c for a, b, c in zip(az, bz, cz))


@dataclass
class PlonkInstance:
    """PLONK arithmetization fixture (selectors, wire permutation, witness)."""
    qM: list
    qL: list
    qR: list
    qO: list
    qC: list
    perm: list[int]
    w: list

    def check_satisfied(self) -> bool:
        n = len(self.qM)
        a, b, c = self.w[:n], self.w[n:2 * n], self.w[2 * n:3 * n]
        gates_ok = all(
            (self.qM[i] * a[i] * b[i] + self.qL[i] * a[i] + self.qR[i] * b[i]
             + self.qO[i] * c[i] + self.qC[i]) == 0
            for i in range(5, n)  # gates 0-4 are public-input gates (qL=1)
        )
        copies_ok = all(self.w[self.perm[i]] == self.w[i]
                        for i in range(3 * n))
        return gates_ok and copies_ok


class _Token:
    """Inert stand-in for Sage parent/factory objects we don't need."""

    def __init__(self, name):
        self.name = name

    def __call__(self, *args, **kwargs):
        return _Token(f"{self.name}()")

    def __repr__(self):
        return f"<sage-token {self.name}>"


class _SageShimUnpickler(pickle.Unpickler):
    """Maps the Sage globals in the fixtures to minimal reconstructors."""

    MATRIX_MARKER = "__shim_matrix__"

    def find_class(self, module, name):
        full = f"{module}.{name}"
        if full == "sage.rings.integer.make_integer":
            return lambda s: int(s, 32)  # Sage stores Integers in base 32
        if full == "sage.rings.finite_rings.integer_mod.Mod":
            return lambda value, modulus, parent=None: value % modulus
        if full == ("sage.modules.free_module_element."
                    "make_FreeModuleElement_generic_dense_v1"):
            return lambda parent, entries, degree, is_mutable: list(entries)
        if full == "sage.matrix.matrix0.unpickle":
            # (cls, parent, mutability, cache, data, version); data is the
            # flat row-major entry list of python ints (already Mod-reduced).
            def unpickle_matrix(cls, parent, mutability, cache, data, version):
                return (self.MATRIX_MARKER, list(data))
            return unpickle_matrix
        return _Token(full)


def _as_field_list(values, field) -> list:
    return [v if isinstance(v, FieldElement) else field(v) for v in values]


def load_r1cs(path: str, curve_type: str = "bn254") -> R1CSInstance:
    field = scalar_field(curve_type)
    with open(path, "rb") as f:
        raw = _SageShimUnpickler(f).load()
    mats = {}
    for key in ("A", "B", "C"):
        marker, flat = raw[key]
        if marker != _SageShimUnpickler.MATRIX_MARKER:
            raise ValueError(f"{path}: {key} is not a Sage matrix")
        n = int(round(len(flat) ** 0.5))
        if n * n != len(flat):
            raise ValueError(f"{path}: {key} is not a square dense matrix")
        mats[key] = DenseMatrix(field,
                                [flat[i * n:(i + 1) * n] for i in range(n)])
    z = _as_field_list(raw["z"], field)
    return R1CSInstance(mats["A"], mats["B"], mats["C"], z)


def load_plonk(path: str, curve_type: str = "bn254") -> PlonkInstance:
    field = scalar_field(curve_type)
    with open(path, "rb") as f:
        raw = _SageShimUnpickler(f).load()
    return PlonkInstance(
        qM=_as_field_list(raw["qM"], field),
        qL=_as_field_list(raw["qL"], field),
        qR=_as_field_list(raw["qR"], field),
        qO=_as_field_list(raw["qO"], field),
        qC=_as_field_list(raw["qC"], field),
        perm=[int(i) for i in raw["perm"]],
        w=_as_field_list(raw["w"], field),
    )


def synthetic_r1cs(n: int, seed: int = 808, curve_type: str = "bn254"):
    """The satisfied synthetic R1CS of the JAX package's Marlin scale test
    (``tests/test_marlin_device_scale.py``) over ``curve_type``'s scalar
    field: row i enforces (z_i + z_{i+1 mod n}) z_i = c_i with A[i, i] =
    A[i, i+1 mod n] = 1 (nnz(A) = 2n), B = I and C = diag(z_i + z_{i+1 mod
    n}), z_0 = 1 and the rest drawn from ``random.Random(seed)``.  Returns
    (A, B, C, z)."""
    import random

    Fr = scalar_field(curve_type)
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
