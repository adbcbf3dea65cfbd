"""BN254 / BLS12-381 curve constants.

The reference (``kzg.py:26-37``) selects between py_ecc's
``optimized_bn128`` and ``optimized_bls12_381`` backends.  This module pins the
same curves' parameters as plain integers so every layer (host compat math,
device limb kernels) derives from one source of truth.
"""

# --------------------------------------------------------------------------
# BN254 (a.k.a. bn128 / alt_bn128).
# --------------------------------------------------------------------------

# Base field modulus p (coordinates of curve points).
BN254_P = 21888242871839275222246405745257275088696311157297823662689037894645226208583

# Scalar field modulus r == group order (the "curve_order" of py_ecc, and the
# field GF(curve_order) the reference builds at kzg.py:52).
BN254_R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# BN parameter t:  p(t) = 36t^4 + 36t^3 + 24t^2 + 6t + 1.
BN254_T = 4965661367192848881

# Optimal-ate Miller loop count 6t + 2.
BN254_ATE_LOOP = 6 * BN254_T + 2  # == 29793968203157093288

# Curve equation y^2 = x^3 + 3 over Fp.
BN254_B = 3

# G1 generator (affine).
BN254_G1 = (1, 2)

# G2 generator (affine, over Fq2 = Fp[u]/(u^2+1), coordinates as (c0, c1)).
BN254_G2_X = (
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
)
BN254_G2_Y = (
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)

# Non-residue xi = 9 + u defining the sextic twist  E'/Fq2: y^2 = x^3 + 3/xi.
BN254_XI = (9, 1)

# Fr multiplicative group: r - 1 = 2^28 * odd.  Generator of Fr*.
BN254_FR_GEN = 5
BN254_FR_TWO_ADICITY = 28

# --------------------------------------------------------------------------
# BLS12-381 (the reference's alternative curve, kzg.py:31-35).
# --------------------------------------------------------------------------

BLS12_381_P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
BLS12_381_R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
BLS12_381_X = -0xD201000000010000  # BLS parameter (negative)
BLS12_381_B = 4
BLS12_381_G1 = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)
BLS12_381_G2_X = (
    0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
    0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
)
BLS12_381_G2_Y = (
    0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
    0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
)
BLS12_381_XI = (1, 1)  # non-residue (1 + u) for the BLS12-381 M-type twist
BLS12_381_FR_GEN = 7
BLS12_381_FR_TWO_ADICITY = 32

# --------------------------------------------------------------------------
# 16-bit limb layout (the port's kernels use 8 or 12 x 32-bit limbs of the
# same Montgomery integers, ops/limbs.py).
#
# 256-bit field elements are represented as NUM_LIMBS little-endian limbs of
# LIMB_BITS bits each, held in uint32 lanes.  16-bit limbs keep single
# products (< 2^32) exactly representable in uint32 and let schoolbook column
# accumulations (split into 16-bit halves) stay far below 2^32.
# --------------------------------------------------------------------------
LIMB_BITS = 16
NUM_LIMBS = 16  # 16 x 16 = 256 bits
LIMB_MASK = (1 << LIMB_BITS) - 1


def to_limbs(x: int, num_limbs: int = NUM_LIMBS) -> list[int]:
    """Split a non-negative int into little-endian LIMB_BITS-bit limbs."""
    return [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(num_limbs)]


def from_limbs(limbs) -> int:
    """Inverse of :func:`to_limbs`."""
    acc = 0
    for i, limb in enumerate(limbs):
        acc |= int(limb) << (LIMB_BITS * i)
    return acc
