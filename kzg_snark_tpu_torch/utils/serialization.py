"""Persistence for SRS, index keys and proofs: index a circuit once, load it
many times.

The port's counterpart of the JAX package's ``utils/serialization.py``, in
the same file formats, so a file written by either package loads in the
other:

* SRS and index keys: one ``.npz`` each.  ``header`` holds the UTF-8 JSON
  header (curve, metadata, the structure of the keys); every list of
  integers is an (N, 32) uint8 array of big-endian rows, named ``g1_x`` /
  ``g1_y`` for an SRS and ``arr0``, ``arr1``, ... in the order the encoder
  meets them for index keys.
* Proofs: JSON, points as ``{"__point__": [x, y, z]}`` projective integer
  triples, field elements as ``{"__fr__": int}``.

The 32-byte rows hold BN254's 254-bit coordinates, not BLS12-381's 381-bit
ones, so the SRS and index-key formats are BN254-only until both packages
change them: ``save_srs`` and ``save_index_keys`` refuse another curve with
a ValueError that names it.  Proofs, in JSON, have no such limit.

Everything round-trips through canonical integers.  A ``DeviceSRS`` is
converted to affine integers in one ``CurveOps.to_affine_ints`` call over
all its points (one batched inversion); loading with ``device=True`` (the
default for a ``backend="cuda"`` KZG) puts the SRS back on ``kzg.device``
as a ``DeviceSRS``, so loaded keys go straight to the device provers.
Entries of an ipk whose key starts with ``_`` (the provers' cached device
tensors, ``_device_cache``) are derived data and are not saved.
"""

from __future__ import annotations

import json

import numpy as np


ROW_BYTES = 32


def _check_rows_fit(kzg) -> None:
    """Refuse a curve whose base-field coordinates overflow a row."""
    bits = type(kzg.G1[0]).modulus.bit_length()
    if bits > 8 * ROW_BYTES:
        raise ValueError(
            f"{kzg.curve_type}: {bits}-bit coordinates do not fit the "
            f"{ROW_BYTES}-byte rows of the SRS and index-key format, which "
            "is BN254-only")


def _ints_to_array(values) -> np.ndarray:
    """ints -> (N, 32) uint8 big-endian rows."""
    values = list(values)
    return np.frombuffer(
        b"".join(int(v).to_bytes(ROW_BYTES, "big") for v in values),
        dtype=np.uint8).reshape(len(values), ROW_BYTES).copy()


def _array_to_ints(arr) -> list[int]:
    return [int.from_bytes(bytes(row), "big") for row in arr]


def _header(data) -> dict:
    return json.loads(bytes(data["header"]).decode())


def _srs_affine(ck) -> list:
    """Affine int pairs of a host projective list or a DeviceSRS."""
    from ..ops.host import curve as pc
    from ..ops.srs import DeviceSRS

    if isinstance(ck, DeviceSRS):
        return ck._curve.to_affine_ints(ck.points)
    return [(int(a[0]), int(a[1])) for a in map(pc.normalize, ck)]


def _srs_from_ints(kzg, xs, ys, device: bool):
    """A DeviceSRS on ``kzg.device``, or a host projective list."""
    if device:
        from ..ops.msm import msm_context
        from ..ops.srs import DeviceSRS
        curve = msm_context(kzg.curve_type, kzg.device).curve
        return DeviceSRS(kzg.curve_type, curve.from_affine_ints(xs, ys))
    Fp = type(kzg.G1[0])
    return [(Fp(x), Fp(y), Fp(1)) for x, y in zip(xs, ys)]


def _use_device(kzg, device: bool | None) -> bool:
    return kzg.backend == "cuda" if device is None else device


def save_srs(path: str, kzg, ck, rk) -> None:
    """Persist (ck, rk).  ck may be a host list of projective tuples or a
    DeviceSRS; stored as affine coordinate integers either way."""
    from ..ops.host import curve as pc

    _check_rows_fit(kzg)
    affs = _srs_affine(ck)
    rk_aff = pc.normalize(rk)
    header = {
        "curve_type": kzg.curve_type,
        "max_degree": len(affs) - 1,
        "rk": [[rk_aff[0].c0, rk_aff[0].c1], [rk_aff[1].c0, rk_aff[1].c1]],
    }
    np.savez_compressed(
        path,
        header=np.frombuffer(json.dumps(header).encode(), dtype=np.uint8),
        g1_x=_ints_to_array([a[0] for a in affs]),
        g1_y=_ints_to_array([a[1] for a in affs]),
    )


def load_srs(path: str, kzg, device: bool | None = None):
    """Load (ck, rk).  device=True returns a DeviceSRS on ``kzg.device``
    (the default for backend="cuda" KZG instances), else a host
    projective list."""
    data = np.load(path)
    header = _header(data)
    if header["curve_type"] != kzg.curve_type:
        raise ValueError(f"{path}: an SRS of {header['curve_type']}, not "
                         f"{kzg.curve_type}")
    rk_raw = header["rk"]
    rk = (kzg._Fq2(*rk_raw[0]), kzg._Fq2(*rk_raw[1]), kzg._Fq2.one())
    ck = _srs_from_ints(kzg, _array_to_ints(data["g1_x"]),
                        _array_to_ints(data["g1_y"]), _use_device(kzg, device))
    return ck, rk


def save_proof(path: str, proof: dict) -> None:
    """Persist a Marlin or PLONK proof dict (commitments as projective int
    triples, field elements as ints)."""
    from ..ops.host.field import FieldElement

    def encode(obj):
        if isinstance(obj, dict):
            return {k: encode(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [encode(v) for v in obj]
        if isinstance(obj, tuple):  # projective point
            return {"__point__": [int(c) for c in obj]}
        if isinstance(obj, (FieldElement, int)):
            return {"__fr__": int(obj)}
        raise TypeError(f"unsupported proof element: {type(obj)}")

    with open(path, "w") as f:
        json.dump(encode(proof), f)


def load_proof(path: str, kzg) -> dict:
    Fp = type(kzg.G1[0])
    Fr = kzg.Fq

    def decode(obj):
        if isinstance(obj, dict):
            if "__point__" in obj:
                return tuple(Fp(c) for c in obj["__point__"])
            if "__fr__" in obj:
                return Fr(obj["__fr__"])
            return {k: decode(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [decode(v) for v in obj]
        raise TypeError(f"unsupported proof element: {type(obj)}")

    with open(path) as f:
        return decode(json.load(f))


def save_index_keys(path: str, kzg, ipk: dict, ivk: dict) -> None:
    """Persist either protocol's (ipk, ivk) as one ``.npz``.

    Covers every value type the Marlin and PLONK indexers emit: the SRS
    ``ck`` (host list or DeviceSRS), the G2 ``rk``, index polynomials
    (canonical coefficient arrays), G1 commitments, subgroup element lists,
    vanishing polynomials, sigma_star, the R1CS matrices and scalar
    metadata."""
    from ..ops.host import curve as pc
    from ..ops.host.field import FieldElement
    from ..ops.host.poly import Poly
    from ..ops.srs import DeviceSRS
    from .fixtures import DenseMatrix, SparseMatrix

    _check_rows_fit(kzg)
    arrays: dict[str, np.ndarray] = {}

    def hoist(values) -> str:
        key = f"arr{len(arrays)}"
        arrays[key] = _ints_to_array(values)
        return key

    def enc_coord(c):
        """Fq or Fq2 coordinate -> int or [int, int]."""
        if hasattr(c, "c0"):
            return [int(c.c0), int(c.c1)]
        return int(c)

    def enc_srs(ck):
        affs = _srs_affine(ck)
        return {"__srs__": {"x": hoist([a[0] for a in affs]),
                            "y": hoist([a[1] for a in affs])}}

    def encode(obj):
        if isinstance(obj, DeviceSRS):
            return enc_srs(obj)
        if isinstance(obj, Poly):
            return {"__poly__": hoist([int(c) for c in obj.list()])}
        if isinstance(obj, FieldElement):
            return {"__fr__": int(obj)}
        if isinstance(obj, (DenseMatrix, SparseMatrix)):
            pos = obj.nonzero_positions()
            return {"__matrix__": {
                "nrows": obj.nrows(), "ncols": obj.ncols(),
                "dense": isinstance(obj, DenseMatrix),
                "ij": [[i, j] for i, j in pos],
                "vals": hoist([int(obj[i, j]) for i, j in pos])}}
        if isinstance(obj, tuple):          # projective point (G1 or G2)
            norm = pc.normalize(obj)
            if norm is None:
                return {"__point__": None}
            return {"__point__": [enc_coord(norm[0]), enc_coord(norm[1])]}
        if isinstance(obj, list):
            if obj and all(isinstance(v, FieldElement) for v in obj):
                return {"__frs__": hoist([int(v) for v in obj])}
            if obj and all(isinstance(v, tuple) for v in obj):
                return enc_srs(obj)         # host ck: projective G1 points
            return [encode(v) for v in obj]
        if isinstance(obj, dict):
            return {k: encode(v) for k, v in obj.items()
                    if not k.startswith("_")}
        if isinstance(obj, (int, bool, str)) or obj is None:
            return obj
        raise TypeError(f"unsupported index-key element: {type(obj)}")

    header = {
        "curve_type": kzg.curve_type,
        "ipk": encode(ipk),
        "ivk": encode(ivk),
    }
    np.savez_compressed(
        path,
        header=np.frombuffer(json.dumps(header).encode(), dtype=np.uint8),
        **arrays)


def load_index_keys(path: str, kzg, device: bool | None = None):
    """Load (ipk, ivk) saved by :func:`save_index_keys` (by either package)
    into ``kzg``'s field and curve types.  ``device`` picks the ``ck``
    flavor as in :func:`load_srs` (None: a DeviceSRS for backend="cuda"),
    so the keys go to the device provers as they are."""
    from ..ops.host.poly import Poly
    from .fixtures import DenseMatrix, SparseMatrix

    data = np.load(path)
    header = _header(data)
    if header["curve_type"] != kzg.curve_type:
        raise ValueError(f"{path}: keys of {header['curve_type']}, not "
                         f"{kzg.curve_type}")
    device = _use_device(kzg, device)
    Fp = type(kzg.G1[0])
    Fr = kzg.Fq

    def ints(key):
        return _array_to_ints(data[key])

    def dec_coord(c):
        if isinstance(c, list):
            return kzg._Fq2(c[0], c[1])
        return Fp(c)

    def decode(obj):
        if isinstance(obj, list):
            return [decode(v) for v in obj]
        if not isinstance(obj, dict):
            return obj
        if "__srs__" in obj:
            return _srs_from_ints(kzg, ints(obj["__srs__"]["x"]),
                                  ints(obj["__srs__"]["y"]), device)
        if "__poly__" in obj:
            return Poly(Fr, [Fr(c) for c in ints(obj["__poly__"])])
        if "__fr__" in obj:
            return Fr(obj["__fr__"])
        if "__frs__" in obj:
            return [Fr(v) for v in ints(obj["__frs__"])]
        if "__matrix__" in obj:
            m = obj["__matrix__"]
            entries = {(i, j): Fr(v)
                       for (i, j), v in zip(m["ij"], ints(m["vals"]))}
            if m["dense"]:
                return DenseMatrix(Fr, [[entries.get((i, j), Fr(0))
                                         for j in range(m["ncols"])]
                                        for i in range(m["nrows"])])
            return SparseMatrix(Fr, m["nrows"], m["ncols"], entries)
        if "__point__" in obj:
            if obj["__point__"] is None:
                return kzg.Z1        # identity (e.g. a zero-poly commit)
            cx, cy = (dec_coord(c) for c in obj["__point__"])
            if isinstance(obj["__point__"][0], list):   # G2 (Fq2)
                return (cx, cy, kzg._Fq2.one())
            return (cx, cy, Fp(1))
        return {k: decode(v) for k, v in obj.items()}

    return decode(header["ipk"]), decode(header["ivk"])
