"""The port's fixture loaders against the JAX package's.

The test writes its own small Sage-shaped pickles: a dense R1CS and a
PLONK arithmetization whose integers, residues, matrices and vectors
pickle through the Sage globals the reference's files reference
(``make_integer`` base-32 strings, ``integer_mod.Mod``,
``matrix0.unpickle``, ``make_FreeModuleElement_generic_dense_v1``) and
Sage parents that the shim turns into inert tokens.  Both packages'
``load_r1cs`` / ``load_plonk`` read them, at both curves' scalar fields,
and give the same values (compared through ``utils/convert.to_plain``);
``check_satisfied`` holds, and fails once a wire value is changed.  The
port's ``synthetic_r1cs`` takes the curve.
"""

import pickle
import sys
import types

import pytest

from kzg_snark_tpu.utils import fixtures as jax_fixtures
from kzg_snark_tpu_torch.ops.host.field import scalar_field
from kzg_snark_tpu_torch.utils import fixtures
from kzg_snark_tpu_torch.utils.convert import to_plain

CURVES = ("bn254", "bls12_381")


def _base32(v: int) -> str:
    digits = "0123456789abcdefghijklmnopqrstuv"
    out = ""
    while True:
        v, d = divmod(v, 32)
        out = digits[d] + out
        if v == 0:
            return out


class _Sage:
    """Stand-ins that pickle through the Sage globals of the reference's
    fixtures; ``install`` registers those globals under their Sage module
    paths for the duration of a test."""

    PATHS = {
        "integer": "sage.rings.integer.make_integer",
        "mod": "sage.rings.finite_rings.integer_mod.Mod",
        "matrix": "sage.matrix.matrix0.unpickle",
        "vector": "sage.modules.free_module_element."
                  "make_FreeModuleElement_generic_dense_v1",
        "ring": "sage.rings.finite_rings.integer_mod_ring.IntegerModRing",
        "space": "sage.matrix.matrix_space.MatrixSpace",
        "matrix_cls": "sage.matrix.matrix_modn_dense_double."
                      "Matrix_modn_dense_double",
    }

    def __init__(self, monkeypatch, modulus: int):
        self.modulus = modulus
        self.g = {}
        for key, path in self.PATHS.items():
            module, name = path.rsplit(".", 1)
            parts = module.split(".")
            for i in range(1, len(parts) + 1):
                mod_name = ".".join(parts[:i])
                if mod_name not in sys.modules:
                    monkeypatch.setitem(sys.modules, mod_name,
                                        types.ModuleType(mod_name))
            glob = type(name, (), {"__module__": module,
                                   "__qualname__": name})
            monkeypatch.setattr(sys.modules[module], name, glob,
                                raising=False)
            self.g[key] = glob

    def reduced(self, key, *args):
        outer = self

        class Obj:
            def __reduce__(self):
                return outer.g[key], args
        return Obj()

    def integer(self, v: int):
        return self.reduced("integer", _base32(v))

    def ring(self):
        return self.reduced("ring", self.integer(self.modulus))

    def mod(self, v: int):
        return self.reduced("mod", self.integer(v % self.modulus),
                            self.integer(self.modulus), self.ring())

    def matrix(self, rows):
        n = len(rows)
        parent = self.reduced("space", self.ring(), n, n, False)
        return self.reduced("matrix", self.g["matrix_cls"], parent, True, {},
                            [self.mod(v) for row in rows for v in row], 0)

    def vector(self, values):
        return self.reduced("vector", self.ring(),
                            [self.mod(v) for v in values], len(values), True)


def _r1cs_raw(sage: _Sage, bad: bool):
    """z = (1, 3, 5, 15): 3 * 5 = 15, 1 * 15 = 15, (3 + 5) * 1 = 3 + 5 and
    a zero row."""
    A = [[0, 1, 0, 0], [1, 0, 0, 0], [0, 1, 1, 0], [0, 0, 0, 0]]
    B = [[0, 0, 1, 0], [0, 0, 0, 1], [1, 0, 0, 0], [0, 0, 0, 0]]
    C = [[0, 0, 0, 1], [0, 0, 0, 1], [0, 1, 1, 0], [0, 0, 0, 0]]
    z = [1, 3, 5, 16 if bad else 15]
    return {"A": sage.matrix(A), "B": sage.matrix(B), "C": sage.matrix(C),
            "z": sage.vector(z)}


def _plonk_raw(sage: _Sage, bad: bool):
    """Eight gates: five public-input gates (qL = 1), then a b = c."""
    n, r = 8, sage.modulus
    a = [i + 2 for i in range(n)]
    b = [i + 3 for i in range(n)]
    c = [x * y for x, y in zip(a, b)]
    if bad:
        c[6] += 1
    one = [1] * n
    return {"qM": [sage.mod(v) for v in [0] * 5 + [1] * 3],
            "qL": [sage.mod(v) for v in [1] * 5 + [0] * 3],
            "qR": [sage.mod(0) for _ in range(n)],
            "qO": [sage.mod(v) for v in [0] * 5 + [r - 1] * 3],
            "qC": [sage.mod(-v) for v in a[:5]] + [sage.mod(0)] * 3,
            "perm": [sage.integer(i) for i in range(3 * n)],
            "w": sage.vector(a + b + c),
            "extra": sage.vector(one)}


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("bad", [False, True])
def test_load_r1cs_matches_jax(tmp_path, monkeypatch, curve, bad):
    sage = _Sage(monkeypatch, scalar_field(curve).modulus)
    path = tmp_path / "R1CS_INSTANCE.pkl"
    path.write_bytes(pickle.dumps(_r1cs_raw(sage, bad), protocol=2))
    port = fixtures.load_r1cs(str(path), curve)
    ref = jax_fixtures.load_r1cs(str(path), curve)
    for m in ("A", "B", "C"):
        assert to_plain(getattr(port, m).rows) == \
            to_plain(getattr(ref, m).rows)
    assert to_plain(port.z) == to_plain(ref.z) == (1, 3, 5, 16 if bad
                                                   else 15)
    assert port.check_satisfied() is ref.check_satisfied() is (not bad)
    assert type(port.z[0]) is scalar_field(curve)


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("bad", [False, True])
def test_load_plonk_matches_jax(tmp_path, monkeypatch, curve, bad):
    sage = _Sage(monkeypatch, scalar_field(curve).modulus)
    path = tmp_path / "PLONK_ARITHMETIZATION_INSTANCE.pkl"
    path.write_bytes(pickle.dumps(_plonk_raw(sage, bad), protocol=2))
    port = fixtures.load_plonk(str(path), curve)
    ref = jax_fixtures.load_plonk(str(path), curve)
    for name in ("qM", "qL", "qR", "qO", "qC", "perm", "w"):
        assert to_plain(getattr(port, name)) == to_plain(getattr(ref, name))
    assert port.perm == list(range(24))
    assert port.check_satisfied() is ref.check_satisfied() is (not bad)


def test_shim_refuses_a_non_square_matrix(tmp_path, monkeypatch):
    sage = _Sage(monkeypatch, scalar_field("bn254").modulus)
    raw = _r1cs_raw(sage, False)
    raw["B"] = sage.reduced("matrix", sage.g["matrix_cls"], None, True, {},
                            [sage.mod(1)] * 6, 0)
    path = tmp_path / "bad.pkl"
    path.write_bytes(pickle.dumps(raw, protocol=2))
    with pytest.raises(ValueError, match="B is not a square dense matrix"):
        fixtures.load_r1cs(str(path))


@pytest.mark.parametrize("curve", CURVES)
def test_synthetic_r1cs_takes_the_curve(curve):
    A, B, C, z = fixtures.synthetic_r1cs(8, curve_type=curve)
    Fr = scalar_field(curve)
    assert type(z[0]) is Fr and len(A.nonzero_positions()) == 16
    inst = fixtures.R1CSInstance(A, B, C, z)
    assert inst.check_satisfied()
    if curve == "bn254":
        assert to_plain(z) == to_plain(fixtures.synthetic_r1cs(8)[3])
