// BN254 optimal-ate pairing, native host implementation.
//
// The framework keeps its verifier on host (O(1) pairings,
// SURVEY.md §3.5); this library is the native muscle behind it — the role
// Sage's C backends (FLINT/Pari) play for the reference implementation.
// Exposed via a tiny C ABI consumed through ctypes
// (utils/native.py); the pure-Python tower in
// ops/host/pairing.py remains the oracle and fallback.
//
// Field tower: Fq2 = Fq[u]/(u^2+1); Fq6 = Fq2[v]/(v^3 - (9+u));
// Fq12 = Fq6[w]/(w^2 - v).  Miller loop over 6t+2 with affine line
// evaluations after untwisting G2 points into E(Fq12); final exponentiation
// (p^12-1)/r via the easy part (Frobenius) and a direct (p^4-p^2+1)/r power.
//
// Build: g++ -O2 -fPIC -shared -o libbn254.so bn254_pairing.cpp

#include <cstdint>
#include <cstring>

typedef unsigned __int128 u128;
typedef uint64_t u64;

// ---------------------------------------------------------------- Fq ----
static const u64 P[4] = {
    0x3C208C16D87CFD47ull, 0x97816A916871CA8Dull,
    0xB85045B68181585Dull, 0x30644E72E131A029ull};
// -p^{-1} mod 2^64
static u64 P_INV;
// R^2 mod p (computed at init)
static u64 R2[4];

struct Fq { u64 v[4]; };

static inline bool geq(const u64 a[4], const u64 b[4]) {
  for (int i = 3; i >= 0; --i) {
    if (a[i] != b[i]) return a[i] > b[i];
  }
  return true;
}

static inline void sub_nored(u64 r[4], const u64 a[4], const u64 b[4]) {
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a[i] - b[i] - borrow;
    r[i] = (u64)d;
    borrow = (d >> 64) & 1;
  }
}

static inline void fq_add(Fq &r, const Fq &a, const Fq &b) {
  u128 carry = 0;
  u64 t[4];
  for (int i = 0; i < 4; ++i) {
    u128 s = (u128)a.v[i] + b.v[i] + carry;
    t[i] = (u64)s;
    carry = s >> 64;
  }
  if (carry || geq(t, P)) {
    u64 q[4];
    sub_nored(q, t, P);
    memcpy(r.v, q, 32);
  } else {
    memcpy(r.v, t, 32);
  }
}

static inline void fq_sub(Fq &r, const Fq &a, const Fq &b) {
  u128 borrow = 0;
  u64 t[4];
  for (int i = 0; i < 4; ++i) {
    u128 d = (u128)a.v[i] - b.v[i] - borrow;
    t[i] = (u64)d;
    borrow = (d >> 64) & 1;
  }
  if (borrow) {
    u128 carry = 0;
    for (int i = 0; i < 4; ++i) {
      u128 s = (u128)t[i] + P[i] + carry;
      t[i] = (u64)s;
      carry = s >> 64;
    }
  }
  memcpy(r.v, t, 32);
}

// CIOS Montgomery multiplication.
static inline void fq_mul(Fq &r, const Fq &a, const Fq &b) {
  u64 t[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    u128 carry = 0;
    for (int j = 0; j < 4; ++j) {
      u128 s = (u128)t[j] + (u128)a.v[i] * b.v[j] + carry;
      t[j] = (u64)s;
      carry = s >> 64;
    }
    u128 s = (u128)t[4] + carry;
    t[4] = (u64)s;
    t[5] = (u64)(s >> 64);

    u64 m = t[0] * P_INV;
    carry = ((u128)t[0] + (u128)m * P[0]) >> 64;
    for (int j = 1; j < 4; ++j) {
      u128 s2 = (u128)t[j] + (u128)m * P[j] + carry;
      t[j - 1] = (u64)s2;
      carry = s2 >> 64;
    }
    u128 s3 = (u128)t[4] + carry;
    t[3] = (u64)s3;
    t[4] = t[5] + (u64)(s3 >> 64);
    t[5] = 0;
  }
  if (t[4] || geq(t, P)) {
    u64 q[4];
    sub_nored(q, t, P);
    memcpy(r.v, q, 32);
  } else {
    memcpy(r.v, t, 32);
  }
}

static inline void fq_sqr(Fq &r, const Fq &a) { fq_mul(r, a, a); }

static Fq FQ_ZERO, FQ_ONE;  // FQ_ONE = R mod p (set at init)

static inline bool fq_is_zero(const Fq &a) {
  return !(a.v[0] | a.v[1] | a.v[2] | a.v[3]);
}

static inline void fq_neg(Fq &r, const Fq &a) {
  if (fq_is_zero(a)) { r = a; return; }
  sub_nored(r.v, P, a.v);
}

static void fq_pow(Fq &r, const Fq &a, const u64 e[4]) {
  Fq result = FQ_ONE, base = a;
  for (int limb = 0; limb < 4; ++limb) {
    u64 bits = e[limb];
    for (int i = 0; i < 64; ++i) {
      if (bits & 1) fq_mul(result, result, base);
      fq_sqr(base, base);
      bits >>= 1;
    }
  }
  r = result;
}

static void fq_inv(Fq &r, const Fq &a) {
  // Fermat: a^(p-2); P[0] >= 2 so no borrow.
  u64 e[4] = {P[0] - 2, P[1], P[2], P[3]};
  fq_pow(r, a, e);
}

// --------------------------------------------------------------- Fq2 ----
struct Fq2 { Fq c0, c1; };

static Fq2 FQ2_ZERO, FQ2_ONE, XI;  // XI = 9 + u

static inline void fq2_add(Fq2 &r, const Fq2 &a, const Fq2 &b) {
  fq_add(r.c0, a.c0, b.c0);
  fq_add(r.c1, a.c1, b.c1);
}
static inline void fq2_sub(Fq2 &r, const Fq2 &a, const Fq2 &b) {
  fq_sub(r.c0, a.c0, b.c0);
  fq_sub(r.c1, a.c1, b.c1);
}
static inline void fq2_neg(Fq2 &r, const Fq2 &a) {
  fq_neg(r.c0, a.c0);
  fq_neg(r.c1, a.c1);
}
static inline void fq2_mul(Fq2 &r, const Fq2 &a, const Fq2 &b) {
  Fq t0, t1, s0, s1, u;
  fq_mul(t0, a.c0, b.c0);
  fq_mul(t1, a.c1, b.c1);
  fq_add(s0, a.c0, a.c1);
  fq_add(s1, b.c0, b.c1);
  fq_mul(u, s0, s1);
  Fq r0, r1;
  fq_sub(r0, t0, t1);          // u^2 = -1
  fq_sub(u, u, t0);
  fq_sub(r1, u, t1);
  r.c0 = r0;
  r.c1 = r1;
}
static inline void fq2_sqr(Fq2 &r, const Fq2 &a) { fq2_mul(r, a, a); }
static inline void fq2_conj(Fq2 &r, const Fq2 &a) {
  r.c0 = a.c0;
  fq_neg(r.c1, a.c1);
}
static inline bool fq2_is_zero(const Fq2 &a) {
  return fq_is_zero(a.c0) && fq_is_zero(a.c1);
}
static inline void fq2_inv(Fq2 &r, const Fq2 &a) {
  Fq n0, n1, norm, ninv;
  fq_sqr(n0, a.c0);
  fq_sqr(n1, a.c1);
  fq_add(norm, n0, n1);
  fq_inv(ninv, norm);
  Fq r1;
  fq_mul(r.c0, a.c0, ninv);
  fq_mul(r1, a.c1, ninv);
  fq_neg(r.c1, r1);
}
static inline void fq2_mul_xi(Fq2 &r, const Fq2 &a) { fq2_mul(r, a, XI); }

// --------------------------------------------------------------- Fq6 ----
struct Fq6 { Fq2 c0, c1, c2; };

static inline void fq6_add(Fq6 &r, const Fq6 &a, const Fq6 &b) {
  fq2_add(r.c0, a.c0, b.c0);
  fq2_add(r.c1, a.c1, b.c1);
  fq2_add(r.c2, a.c2, b.c2);
}
static inline void fq6_sub(Fq6 &r, const Fq6 &a, const Fq6 &b) {
  fq2_sub(r.c0, a.c0, b.c0);
  fq2_sub(r.c1, a.c1, b.c1);
  fq2_sub(r.c2, a.c2, b.c2);
}
static inline void fq6_neg(Fq6 &r, const Fq6 &a) {
  fq2_neg(r.c0, a.c0);
  fq2_neg(r.c1, a.c1);
  fq2_neg(r.c2, a.c2);
}
static void fq6_mul(Fq6 &r, const Fq6 &a, const Fq6 &b) {
  Fq2 t0, t1, t2, s, u, w;
  fq2_mul(t0, a.c0, b.c0);
  fq2_mul(t1, a.c1, b.c1);
  fq2_mul(t2, a.c2, b.c2);
  Fq6 out;
  // c0 = t0 + xi*((a1+a2)(b1+b2) - t1 - t2)
  Fq2 a12, b12;
  fq2_add(a12, a.c1, a.c2);
  fq2_add(b12, b.c1, b.c2);
  fq2_mul(s, a12, b12);
  fq2_sub(s, s, t1);
  fq2_sub(s, s, t2);
  fq2_mul_xi(s, s);
  fq2_add(out.c0, t0, s);
  // c1 = (a0+a1)(b0+b1) - t0 - t1 + xi*t2
  Fq2 a01, b01;
  fq2_add(a01, a.c0, a.c1);
  fq2_add(b01, b.c0, b.c1);
  fq2_mul(u, a01, b01);
  fq2_sub(u, u, t0);
  fq2_sub(u, u, t1);
  Fq2 xt2;
  fq2_mul_xi(xt2, t2);
  fq2_add(out.c1, u, xt2);
  // c2 = (a0+a2)(b0+b2) - t0 - t2 + t1
  Fq2 a02, b02;
  fq2_add(a02, a.c0, a.c2);
  fq2_add(b02, b.c0, b.c2);
  fq2_mul(w, a02, b02);
  fq2_sub(w, w, t0);
  fq2_sub(w, w, t2);
  fq2_add(out.c2, w, t1);
  r = out;
}
static inline void fq6_mul_v(Fq6 &r, const Fq6 &a) {
  // (c0,c1,c2) -> (xi*c2, c0, c1)
  Fq2 t;
  fq2_mul_xi(t, a.c2);
  Fq6 out;
  out.c0 = t;
  out.c1 = a.c0;
  out.c2 = a.c1;
  r = out;
}
static void fq6_inv(Fq6 &r, const Fq6 &a) {
  Fq2 t0, t1, t2, s0, s1, s2, denom, dinv;
  fq2_sqr(t0, a.c0);
  Fq2 bc;
  fq2_mul(bc, a.c1, a.c2);
  fq2_mul_xi(s0, bc);
  fq2_sub(t0, t0, s0);                 // A = a^2 - xi b c
  fq2_sqr(s1, a.c2);
  fq2_mul_xi(s1, s1);
  Fq2 ab;
  fq2_mul(ab, a.c0, a.c1);
  fq2_sub(t1, s1, ab);                 // B = xi c^2 - a b
  fq2_sqr(s2, a.c1);
  Fq2 ac;
  fq2_mul(ac, a.c0, a.c2);
  fq2_sub(t2, s2, ac);                 // C = b^2 - a c
  // denom = a*A + xi*(b*C + c*B)
  Fq2 bC, cB, sum;
  fq2_mul(bC, a.c1, t2);
  fq2_mul(cB, a.c2, t1);
  fq2_add(sum, bC, cB);
  fq2_mul_xi(sum, sum);
  Fq2 aA;
  fq2_mul(aA, a.c0, t0);
  fq2_add(denom, aA, sum);
  fq2_inv(dinv, denom);
  fq2_mul(r.c0, t0, dinv);
  fq2_mul(r.c1, t1, dinv);
  fq2_mul(r.c2, t2, dinv);
}

// -------------------------------------------------------------- Fq12 ----
struct Fq12 { Fq6 c0, c1; };

static inline void fq12_add(Fq12 &r, const Fq12 &a, const Fq12 &b) {
  fq6_add(r.c0, a.c0, b.c0);
  fq6_add(r.c1, a.c1, b.c1);
}
static inline void fq12_sub(Fq12 &r, const Fq12 &a, const Fq12 &b) {
  fq6_sub(r.c0, a.c0, b.c0);
  fq6_sub(r.c1, a.c1, b.c1);
}
static void fq12_mul(Fq12 &r, const Fq12 &a, const Fq12 &b) {
  Fq6 t0, t1, s, u;
  fq6_mul(t0, a.c0, b.c0);
  fq6_mul(t1, a.c1, b.c1);
  Fq6 a01, b01;
  fq6_add(a01, a.c0, a.c1);
  fq6_add(b01, b.c0, b.c1);
  fq6_mul(s, a01, b01);
  fq6_sub(s, s, t0);
  fq6_sub(s, s, t1);
  fq6_mul_v(u, t1);               // w^2 = v
  fq6_add(r.c0, t0, u);
  r.c1 = s;
}
static inline void fq12_sqr(Fq12 &r, const Fq12 &a) { fq12_mul(r, a, a); }
static inline void fq12_conj(Fq12 &r, const Fq12 &a) {
  r.c0 = a.c0;
  fq6_neg(r.c1, a.c1);
}
static void fq12_inv(Fq12 &r, const Fq12 &a) {
  Fq6 t0, t1, denom, dinv;
  fq6_mul(t0, a.c0, a.c0);
  fq6_mul(t1, a.c1, a.c1);
  fq6_mul_v(t1, t1);
  fq6_sub(denom, t0, t1);
  fq6_inv(dinv, denom);
  fq6_mul(r.c0, a.c0, dinv);
  Fq6 n;
  fq6_mul(n, a.c1, dinv);
  fq6_neg(r.c1, n);
}

// Frobenius coefficients: FROB_V = xi^((p-1)/3), FROB_W = xi^((p-1)/6).
static Fq2 FROB_V, FROB_V2, FROB_W;

static void fq2_pow_bytes(Fq2 &r, const Fq2 &a, const u64 e[4]) {
  Fq2 result = FQ2_ONE, base = a;
  for (int limb = 0; limb < 4; ++limb) {
    u64 bits = e[limb];
    for (int i = 0; i < 64; ++i) {
      if (bits & 1) fq2_mul(result, result, base);
      fq2_sqr(base, base);
      bits >>= 1;
    }
  }
  r = result;
}

static void fq6_frob(Fq6 &r, const Fq6 &a) {
  fq2_conj(r.c0, a.c0);
  Fq2 t;
  fq2_conj(t, a.c1);
  fq2_mul(r.c1, t, FROB_V);
  fq2_conj(t, a.c2);
  fq2_mul(r.c2, t, FROB_V2);
}
static void fq12_frob(Fq12 &r, const Fq12 &a) {
  fq6_frob(r.c0, a.c0);
  Fq6 t;
  fq6_frob(t, a.c1);
  // multiply by FROB_W (an Fq2 scalar) componentwise
  fq2_mul(r.c1.c0, t.c0, FROB_W);
  fq2_mul(r.c1.c1, t.c1, FROB_W);
  fq2_mul(r.c1.c2, t.c2, FROB_W);
}

static bool fq12_eq(const Fq12 &a, const Fq12 &b) {
  return memcmp(&a, &b, sizeof(Fq12)) == 0;
}

// ------------------------------------------------------ pairing core ----
// Affine point in E(Fq12).
struct Pt12 { Fq12 x, y; bool inf; };

static void pt12_line(Fq12 &out, const Pt12 &p1, const Pt12 &p2,
                      const Pt12 &t) {
  // line through p1,p2 evaluated at t (vertical when x1==x2 && y1!=y2)
  Fq12 slope, num, den, tmp;
  bool same_x = fq12_eq(p1.x, p2.x);
  if (!same_x) {
    fq12_sub(num, p2.y, p1.y);
    fq12_sub(den, p2.x, p1.x);
  } else if (fq12_eq(p1.y, p2.y)) {
    Fq12 x2;
    fq12_sqr(x2, p1.x);
    Fq12 three_x2;
    fq12_add(three_x2, x2, x2);
    fq12_add(num, three_x2, x2);
    fq12_add(den, p1.y, p1.y);
  } else {
    fq12_sub(out, t.x, p1.x);
    return;
  }
  Fq12 dinv;
  fq12_inv(dinv, den);
  fq12_mul(slope, num, dinv);
  Fq12 dx, dy;
  fq12_sub(dx, t.x, p1.x);
  fq12_mul(tmp, slope, dx);
  fq12_sub(dy, t.y, p1.y);
  fq12_sub(out, tmp, dy);
}

static void pt12_add(Pt12 &r, const Pt12 &a, const Pt12 &b) {
  if (a.inf) { r = b; return; }
  if (b.inf) { r = a; return; }
  Fq12 slope, num, den, dinv;
  if (fq12_eq(a.x, b.x)) {
    if (!fq12_eq(a.y, b.y)) { r.inf = true; return; }
    Fq12 x2, t;
    fq12_sqr(x2, a.x);
    fq12_add(t, x2, x2);
    fq12_add(num, t, x2);
    fq12_add(den, a.y, a.y);
  } else {
    fq12_sub(num, b.y, a.y);
    fq12_sub(den, b.x, a.x);
  }
  fq12_inv(dinv, den);
  fq12_mul(slope, num, dinv);
  Fq12 s2, x3, y3, dx;
  fq12_sqr(s2, slope);
  fq12_sub(x3, s2, a.x);
  fq12_sub(x3, x3, b.x);
  fq12_sub(dx, a.x, x3);
  fq12_mul(y3, slope, dx);
  fq12_sub(y3, y3, a.y);
  r.x = x3;
  r.y = y3;
  r.inf = false;
}

static Fq12 FQ12_ZERO_SENTINEL;  // all-zero Fq12 (additive zero)

static inline void fq12_neg(Fq12 &r, const Fq12 &a) {
  fq12_sub(r, FQ12_ZERO_SENTINEL, a);
}

// ate loop count 6t+2 = 29793968203157093288 = 2^64 + ATE_LO (65 bits;
// value checked against python in tests/test_native_pairing.py).
static const u64 ATE_LO = 0x9D797039BE763BA8ull;

static void miller(Fq12 &f, const Pt12 &q, const Pt12 &p) {
  // bits of 6t+2, MSB-first, skipping the leading 1.
  // 6t+2 = 29793968203157093288; bit length 65.
  Fq12 line;
  Fq12 acc;
  // acc = 1
  memset(&acc, 0, sizeof(acc));
  acc.c0.c0.c0 = FQ_ONE;
  Pt12 t = q;
  for (int i = 63; i >= 0; --i) {
    fq12_sqr(acc, acc);
    pt12_line(line, t, t, p);
    fq12_mul(acc, acc, line);
    pt12_add(t, t, t);
    if ((ATE_LO >> i) & 1) {
      pt12_line(line, t, q, p);
      fq12_mul(acc, acc, line);
      pt12_add(t, t, q);
    }
  }
  // Frobenius correction lines: q1 = pi(q), nq2 = -pi^2(q)
  Pt12 q1, nq2;
  fq12_frob(q1.x, q.x);
  fq12_frob(q1.y, q.y);
  q1.inf = false;
  fq12_frob(nq2.x, q1.x);
  Fq12 y2;
  fq12_frob(y2, q1.y);
  fq12_neg(nq2.y, y2);
  nq2.inf = false;
  pt12_line(line, t, q1, p);
  fq12_mul(acc, acc, line);
  pt12_add(t, t, q1);
  pt12_line(line, t, nq2, p);
  fq12_mul(acc, acc, line);
  f = acc;
}

// final exponentiation: (p^12-1)/r = (p^6-1)(p^2+1) * (p^4-p^2+1)/r
// hard part exponent stored as 16 x 64-bit little-endian words (set at init
// from Python via bn254_set_hard_exp, or computed here).  We compute it in
// C++ using 1024-bit big arithmetic is overkill; instead the Python loader
// passes the hard exponent bytes once at init.
static u64 HARD_EXP[17];
static int HARD_EXP_WORDS = 0;

static void fq12_pow_words(Fq12 &r, const Fq12 &a, const u64 *e, int words) {
  Fq12 result;
  memset(&result, 0, sizeof(result));
  result.c0.c0.c0 = FQ_ONE;
  Fq12 base = a;
  for (int limb = 0; limb < words; ++limb) {
    u64 bits = e[limb];
    for (int i = 0; i < 64; ++i) {
      if (bits & 1) fq12_mul(result, result, base);
      fq12_sqr(base, base);
      bits >>= 1;
    }
  }
  r = result;
}

static void final_exp(Fq12 &r, const Fq12 &f) {
  Fq12 t0, t1, inv;
  fq12_conj(t0, f);
  fq12_inv(inv, f);
  fq12_mul(t0, t0, inv);                 // f^(p^6 - 1)
  Fq12 fr;
  fq12_frob(fr, t0);
  fq12_frob(fr, fr);
  fq12_mul(t1, fr, t0);                  // ^(p^2 + 1)
  fq12_pow_words(r, t1, HARD_EXP, HARD_EXP_WORDS);
}

// ------------------------------------------------------------- C ABI ----
static bool INITIALIZED = false;

static void bytes_to_fq(Fq &r, const uint8_t *be) {
  // 32 bytes big-endian canonical -> Montgomery
  Fq t;
  for (int i = 0; i < 4; ++i) {
    u64 w = 0;
    for (int j = 0; j < 8; ++j) w = (w << 8) | be[(3 - i) * 8 + j];
    t.v[i] = w;
  }
  Fq r2;
  memcpy(r2.v, R2, 32);
  fq_mul(r, t, r2);
}

static void fq_to_bytes(uint8_t *be, const Fq &a) {
  // Montgomery -> canonical big-endian
  Fq one;
  memset(&one, 0, sizeof(one));
  one.v[0] = 1;
  Fq t;
  fq_mul(t, a, one);  // multiply by plain 1 => divides by R
  for (int i = 0; i < 4; ++i) {
    u64 w = t.v[i];
    for (int j = 7; j >= 0; --j) {
      be[(3 - i) * 8 + (7 - j)] = (uint8_t)(w >> (8 * j));
    }
  }
}

extern "C" {

// hard_exp: little-endian 64-bit words of (p^4-p^2+1)/r; n <= 17
void bn254_init(const u64 *hard_exp, int words) {
  if (INITIALIZED) return;
  // P_INV = -p^{-1} mod 2^64 by Newton iteration
  u64 inv = 1;
  for (int i = 0; i < 6; ++i) inv *= 2 - P[0] * inv;
  P_INV = (u64)(0 - inv);

  memset(&FQ_ZERO, 0, sizeof(FQ_ZERO));
  // R mod p: compute 2^256 mod p by doubling 1, 256 times.
  Fq acc;
  memset(&acc, 0, sizeof(acc));
  acc.v[0] = 1;
  for (int i = 0; i < 256; ++i) fq_add(acc, acc, acc);
  // careful: fq_add works on Montgomery values but is representation
  // agnostic (pure mod-p add), so this is fine.
  FQ_ONE = acc;
  // R2 = 2^512 mod p: double 256 more times.
  for (int i = 0; i < 256; ++i) fq_add(acc, acc, acc);
  memcpy(R2, acc.v, 32);

  memset(&FQ2_ZERO, 0, sizeof(FQ2_ZERO));
  FQ2_ONE.c0 = FQ_ONE;
  FQ2_ONE.c1 = FQ_ZERO;
  // XI = 9 + u in Montgomery: 9*R = add ONE 9 times
  Fq nine = FQ_ZERO;
  for (int i = 0; i < 9; ++i) fq_add(nine, nine, FQ_ONE);
  XI.c0 = nine;
  XI.c1 = FQ_ONE;

  // FROB_V = XI^((p-1)/3); FROB_W = XI^((p-1)/6)
  // (p-1)/3 and (p-1)/6 as 4x64 LE words: compute from P.
  u64 pm1[4];
  memcpy(pm1, P, 32);
  pm1[0] -= 1;  // p is odd, no borrow
  // divide by 2: shift right
  u64 half[4];
  for (int i = 0; i < 4; ++i) {
    half[i] = (pm1[i] >> 1) | ((i < 3) ? (pm1[i + 1] << 63) : 0);
  }
  // divide pm1 by 3 (long division from the top)
  u64 third[4];
  {
    u128 rem = 0;
    for (int i = 3; i >= 0; --i) {
      u128 cur = (rem << 64) | pm1[i];
      third[i] = (u64)(cur / 3);
      rem = cur % 3;
    }
  }
  u64 sixth[4];
  {
    u128 rem = 0;
    for (int i = 3; i >= 0; --i) {
      u128 cur = (rem << 64) | half[i];
      sixth[i] = (u64)(cur / 3);
      rem = cur % 3;
    }
  }
  fq2_pow_bytes(FROB_V, XI, third);
  fq2_pow_bytes(FROB_W, XI, sixth);
  fq2_mul(FROB_V2, FROB_V, FROB_V);

  memset(&FQ12_ZERO_SENTINEL, 0, sizeof(FQ12_ZERO_SENTINEL));

  HARD_EXP_WORDS = words;
  for (int i = 0; i < words && i < 17; ++i) HARD_EXP[i] = hard_exp[i];
  INITIALIZED = true;
}

// Inputs: affine big-endian coordinates.
// g1: 64 bytes (x||y); g2: 128 bytes (x.c0||x.c1||y.c0||y.c1).
// An all-zero buffer denotes the identity.
// out: 12*32 bytes canonical Fq coefficients of e(Q, P) in tower order
// (c0.c0.c0, c0.c0.c1, c0.c1.c0, ..., c1.c2.c1).
static bool buf_is_zero(const uint8_t *b, int n) {
  for (int i = 0; i < n; ++i)
    if (b[i]) return false;
  return true;
}

void bn254_pairing(const uint8_t *g2, const uint8_t *g1, uint8_t *out) {
  Fq12 result;
  memset(&result, 0, sizeof(result));
  result.c0.c0.c0 = FQ_ONE;  // identity pairing value
  if (!buf_is_zero(g2, 128) && !buf_is_zero(g1, 64)) {
    Fq2 qx, qy;
    bytes_to_fq(qx.c0, g2);
    bytes_to_fq(qx.c1, g2 + 32);
    bytes_to_fq(qy.c0, g2 + 64);
    bytes_to_fq(qy.c1, g2 + 96);
    Fq px, py;
    bytes_to_fq(px, g1);
    bytes_to_fq(py, g1 + 32);

    // untwist: Qx * w^2 (= v coefficient), Qy * w^3 (= v*w coefficient)
    Pt12 q;
    memset(&q, 0, sizeof(q));
    q.x.c0.c1 = qx;   // x * v
    q.y.c1.c1 = qy;   // y * v * w
    q.inf = false;
    Pt12 pp;
    memset(&pp, 0, sizeof(pp));
    pp.x.c0.c0.c0 = px;
    pp.y.c0.c0.c0 = py;
    pp.inf = false;

    Fq12 f;
    miller(f, q, pp);
    final_exp(result, f);
  }
  // serialize
  const Fq *coeffs[12] = {
      &result.c0.c0.c0, &result.c0.c0.c1, &result.c0.c1.c0, &result.c0.c1.c1,
      &result.c0.c2.c0, &result.c0.c2.c1, &result.c1.c0.c0, &result.c1.c0.c1,
      &result.c1.c1.c0, &result.c1.c1.c1, &result.c1.c2.c0, &result.c1.c2.c1};
  for (int i = 0; i < 12; ++i) fq_to_bytes(out + 32 * i, *coeffs[i]);
}

// e(a2, a1) == e(b2, b1)?
int bn254_pairing_eq(const uint8_t *a2, const uint8_t *a1,
                     const uint8_t *b2, const uint8_t *b1) {
  uint8_t ea[384], eb[384];
  bn254_pairing(a2, a1, ea);
  bn254_pairing(b2, b1, eb);
  return memcmp(ea, eb, 384) == 0 ? 1 : 0;
}

}  // extern "C"
