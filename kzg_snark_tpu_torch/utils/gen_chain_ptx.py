"""Writes ``csrc/chain_ptx.cuh``: the carry-chain steps of the Montgomery
product and squaring (``csrc/chain.cuh``) in inline PTX for sm_90a.

    python -m kzg_snark_tpu_torch.utils.gen_chain_ptx        # rewrite
    python -m kzg_snark_tpu_torch.utils.gen_chain_ptx --check

The carry flag does not survive from one ``asm`` statement to the next,
so every step that carries is one ``asm volatile`` block: a carry leaves a
block only as a register (``addc.u32 k, 0, 0``) and enters the next by
``add.cc.u32 _, k, -1``.  The steps are unrolled for each limb count the
kernels are built at (8 and 12 words), and no block takes more than 30
operands.  Each step's meaning, and its portable C++ mirror, is in
``csrc/chain.cuh``; this file only spells the same steps in PTX.
"""

from __future__ import annotations

import os
import sys

WIDTHS = (8, 12)
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "chain_ptx.cuh")


class Block:
    """One ``asm volatile`` statement.  Operands are named by symbols
    (``t3``, ``a0``...) bound to C expressions; outputs ("=r", "+r") are
    numbered first, then inputs ("r")."""

    def __init__(self) -> None:
        self.operands: dict[str, tuple[str, str]] = {}
        self.locals: list[str] = []
        self.lines: list[str] = []

    def bind(self, sym: str, expr: str, mode: str) -> str:
        old = self.operands.get(sym)
        if old is not None and old[1] != mode:
            raise ValueError(f"{sym} bound as {old[1]} and {mode}")
        self.operands[sym] = (expr, mode)
        return "{" + sym + "}"

    def emit(self, line: str) -> None:
        self.lines.append(line)

    def render(self, indent: str = "  ") -> str:
        outs = [s for s, (_, m) in self.operands.items() if m != "r"]
        ins = [s for s, (_, m) in self.operands.items() if m == "r"]
        order = outs + ins
        if len(order) > 30:
            raise ValueError(f"{len(order)} operands in one asm block")
        num = {s: f"%{i}" for i, s in enumerate(order)}
        body = [line.format(**num) for line in self.lines]
        if self.locals:
            body = [f".reg .u32 {', '.join(self.locals)};"] + body
        text = [f'{indent}asm volatile(\n{indent}    "{{\\n\\t"']
        text += [f'{indent}    "{line}\\n\\t"' for line in body]
        text.append(f'{indent}    "}}"')

        def lst(syms):
            return ", ".join(f'"{self.operands[s][1]}"({self.operands[s][0]})'
                             for s in syms)
        text.append(f"{indent}    : {lst(outs)}")
        text.append(f"{indent}    : {lst(ins)});")
        return "\n".join(text)


def _in(block, name, k):
    return block.bind(f"{name}{k}", f"{name}[{k}]", "r")


def _w(block, arr, k, mode="+r"):
    return block.bind(f"{arr}{k}", f"{arr}[{k}]", mode)


def pairs(block: Block, dst: str, base: int, terms, first_in: bool = False,
          last_out: bool = True, addend=None) -> None:
    """A chain of (lo, hi) pairs: for each (x, y) of ``terms``, words
    dst[base + 2i] and dst[base + 2i + 1] take lo(x y) and hi(x y) plus
    the addend pair (dst's own words, or ``addend(i)`` giving two symbols
    or "0") and the carry; ptxas fuses each pair into one IMAD.WIDE.U32
    with carry.  ``first_in``: the first takes the carry flag set before;
    ``last_out``: the last leaves a carry."""
    for i, (x, y) in enumerate(terms):
        lo, hi = base + 2 * i, base + 2 * i + 1
        src = addend(i) if addend else None
        for half, k in (("lo", lo), ("hi", hi)):
            first = i == 0 and half == "lo" and not first_in
            last = i == len(terms) - 1 and half == "hi" and not last_out
            op = ("mad" if first else "madc") + f".{half}" + \
                ("" if last else ".cc") + ".u32"
            d = _w(block, dst, k, block.operands.get(f"{dst}{k}",
                                                     (None, "+r"))[1])
            c = d if src is None else src[0 if half == "lo" else 1]
            block.emit(f"{op} {d}, {x}, {y}, {c};")


def pm_shift_odd(W: int) -> list[Block]:
    """e[0] += o[1]; o = (o >> 64) + sum_{j odd} a_j b 2^(32 (j - 1)) + the
    carry of e[0] (at o[0], weight 2^32).  o is shifted in place: each
    word is read before it is written."""
    b = Block()
    bi = b.bind("b", "b", "r")
    b.emit(f"add.cc.u32 {_w(b, 'e', 0)}, {_w(b, 'e', 0)}, {_w(b, 'o', 1)};")
    for k in range(W):
        _w(b, "o", k)
    srcs = [(f"{{o{j + 2}}}", f"{{o{j + 3}}}") for j in range(0, W - 2, 2)]
    pairs(b, "o", 0, [(_in(b, "a", j), bi) for j in range(1, W, 2)],
          first_in=True, last_out=False,
          addend=lambda i: srcs[i] if i < len(srcs) else ("0", "0"))
    return [b]


def pm_even(W: int) -> list[Block]:
    """e += sum_{j even} a_j b 2^(32 j); its carry into o[W - 1]."""
    b = Block()
    bi = b.bind("b", "b", "r")
    pairs(b, "e", 0, [(_in(b, "a", j), bi) for j in range(0, W, 2)])
    b.emit(f"addc.u32 {_w(b, 'o', W - 1)}, {_w(b, 'o', W - 1)}, 0;")
    return [b]


def pm_reduce_odd(W: int) -> list[Block]:
    """o += sum_{j odd} m p_j 2^(32 (j - 1)); no carry leaves o."""
    b = Block()
    m = b.bind("m", "m", "r")
    pairs(b, "o", 0, [(m, _in(b, "p", j)) for j in range(1, W, 2)],
          last_out=False)
    return [b]


def pm_reduce_even(W: int) -> list[Block]:
    """e += sum_{j even} m p_j 2^(32 j); its carry into o[W - 1]."""
    b = Block()
    m = b.bind("m", "m", "r")
    pairs(b, "e", 0, [(m, _in(b, "p", j)) for j in range(0, W, 2)])
    b.emit(f"addc.u32 {_w(b, 'o', W - 1)}, {_w(b, 'o', W - 1)}, 0;")
    return [b]


def pm_merge(W: int) -> list[Block]:
    """e[0..W-1) += o[1..W); the carry into e[W - 1]."""
    b = Block()
    for j in range(W - 1):
        op = "add.cc.u32" if j == 0 else "addc.cc.u32"
        b.emit(f"{op} {_w(b, 'e', j)}, {_w(b, 'e', j)}, "
               f"{b.bind(f'o{j + 1}', f'o[{j + 1}]', 'r')};")
    b.emit(f"addc.u32 {_w(b, 'e', W - 1)}, {_w(b, 'e', W - 1)}, 0;")
    return [b]


def final_sub(W: int) -> list[Block]:
    b = Block()
    b.locals = [f"q_d{j}" for j in range(W)] + ["q_h"]
    for j in range(W):
        op = "sub.cc.u32" if j == 0 else "subc.cc.u32"
        b.emit(f"{op} q_d{j}, {_w(b, 't', j)}, {_in(b, 'p', j)};")
    b.emit(f"subc.u32 q_h, {b.bind(f't{W}', f't[{W}]', 'r')}, 0;")
    b.emit("{{ .reg .pred q_lt;")
    b.emit("setp.eq.u32 q_lt, q_h, 0xFFFFFFFF;")
    for j in range(W):
        b.emit(f"selp.u32 {_w(b, 't', j)}, {_w(b, 't', j)}, q_d{j}, q_lt;")
    b.emit("}}")
    return [b]


def row_chains(W: int, prods) -> list[Block]:
    """The products (pos, x, y) of one row of the squaring, x y at word
    ``pos`` of the 2W-word sum ce + 2^32 co + 2^(32 W) k: those at even
    words in one chain of ce pairs (pos, pos + 1), those at odd words in
    one chain of co pairs (pos - 1, pos).  Each chain's carry goes to k at
    its last word + 2 (k[x] is word W + x); at word 2W it is 0 and
    dropped."""
    blocks = []
    for parity, arr, off in ((0, "ce", 0), (1, "co", -1)):
        items = [it for it in prods if it[0] % 2 == parity]
        if not items:
            continue
        b = Block()
        carry = items[-1][0] + 2
        assert carry >= W
        pairs(b, arr, items[0][0] + off,
              [(x(b), y(b)) for _, x, y in items], last_out=carry < 2 * W)
        if carry < 2 * W:
            k = _w(b, "k", carry - W)
            b.emit(f"addc.u32 {k}, {k}, 0;")
        blocks.append(b)
    return blocks


def _sym(name, j=None):
    return lambda b: b.bind(name, name, "r") if j is None else _in(b, name, j)


def sq_products(W: int) -> list[Block]:
    """ce, co, k += a^2 as sum_i a_i v_i: row i takes the words j >= i of
    v_i = a_i 2^(32 i) + 2 sum_{j>i} a_j 2^(32 j), that is a_i, a_{i+1} << 1
    (the bit a_i >> 31 of 2a belongs to row i's own word) and a2_j (the
    words of 2a, a < 2^(32 W - 1)) for j >= i + 2."""
    blocks = []
    for i in range(W):
        ys = [_sym("a", i)]
        if i + 1 < W:
            ys.append(lambda b, j=i + 1: b.bind(f"s{j}", f"(a[{j}] << 1)",
                                                "r"))
        ys += [_sym("a2", j) for j in range(i + 2, W)]
        blocks += row_chains(W, [(2 * i + n, _sym("a", i), y)
                                 for n, y in enumerate(ys)])
    return blocks


def sq_redc(W: int) -> list[Block]:
    """Montgomery reduction of the 2W-word square in ce, co, k: for each
    word i, the true word w_i = ce[i] + co[i-1] + the carry kk out of word
    i - 1 (all words below are 0 mod 2^32 by then), m = w_i pinv, and m p
    added at words i..; then the words W..2W-1 of the three summed into
    ce[W..2W)."""
    blocks = []
    for i in range(W):
        b = Block()
        pinv = b.bind("pinv", "pinv", "r")
        m = b.bind("m", "m", "=r")
        if i == 0:
            b.emit(f"mul.lo.u32 {m}, {_in(b, 'ce', 0)}, {pinv};")
        else:
            b.locals = ["q_q", "q_w"]
            kk = b.bind("kk", "kk", "+r")
            lower = _in(b, "co", i - 2) if i >= 2 else "0"
            b.emit(f"add.cc.u32 q_q, {kk}, 0xFFFFFFFF;")
            b.emit(f"addc.cc.u32 q_q, {_in(b, 'ce', i - 1)}, {lower};")
            b.emit(f"addc.u32 {kk}, 0, 0;")
            b.emit(f"add.u32 q_w, {_in(b, 'ce', i)}, {_in(b, 'co', i - 1)};")
            b.emit(f"add.u32 q_w, q_w, {kk};")
            b.emit(f"mul.lo.u32 {m}, q_w, {pinv};")
        blocks.append(b)
        blocks += row_chains(W, [(i + j, _sym("m"), _sym("p", j))
                                 for j in range(W)])
    b = Block()
    b.locals = ["q_q"]
    kk = b.bind("kk", "kk", "+r")
    b.emit(f"add.cc.u32 q_q, {kk}, 0xFFFFFFFF;")
    b.emit(f"addc.cc.u32 q_q, {_in(b, 'ce', W - 1)}, {_in(b, 'co', W - 2)};")
    b.emit(f"addc.u32 {kk}, 0, 0;")
    blocks.append(b)
    for arr, off in (("co", W - 1), ("k", 0)):
        b = Block()
        if arr == "co":
            b.locals = ["q_q"]
            b.emit(f"add.cc.u32 q_q, {b.bind('kk', 'kk', 'r')}, 0xFFFFFFFF;")
        for j in range(W):
            first = j == 0 and arr == "k"
            op = ("add" if first else "addc") + \
                ("" if j == W - 1 else ".cc") + ".u32"
            d = _w(b, "ce", W + j)
            b.emit(f"{op} {d}, {d}, {_in(b, arr, off + j)};")
        blocks.append(b)
    return blocks


# step -> (C++ parameters, generator, local declarations)
STEPS = {
    "pm_shift_odd": ("uint32_t* e, uint32_t* o, const uint32_t* a, "
                     "uint32_t b", pm_shift_odd, ""),
    "pm_even": ("uint32_t* e, uint32_t* o, const uint32_t* a, uint32_t b",
                pm_even, ""),
    "pm_reduce_odd": ("uint32_t* o, const uint32_t* p, uint32_t m",
                      pm_reduce_odd, ""),
    "pm_reduce_even": ("uint32_t* e, uint32_t* o, const uint32_t* p, "
                       "uint32_t m", pm_reduce_even, ""),
    "pm_merge": ("uint32_t* e, const uint32_t* o", pm_merge, ""),
    "final_sub": ("uint32_t* t, const uint32_t* p", final_sub, ""),
    "sq_products": ("uint32_t* ce, uint32_t* co, uint32_t* k, "
                    "const uint32_t* a, const uint32_t* a2", sq_products, ""),
    "sq_redc": ("uint32_t* ce, uint32_t* co, uint32_t* k, const uint32_t* p, "
                "uint32_t pinv", sq_redc, "uint32_t kk = 0, m;"),
}

HEADER = """\
// Generated by kzg_snark_tpu_torch/utils/gen_chain_ptx.py; do not edit.
//
// The carry-chain steps of csrc/chain.cuh in inline PTX, one asm volatile
// block for each carry chain, unrolled at 8 and 12 words.  Device code
// only: chain.cuh takes these under __CUDA_ARCH__ and its C++ mirror
// elsewhere.
#pragma once

#include <stdint.h>

template <int W>
struct ChainPtx;
"""


def render() -> str:
    out = [HEADER]
    for W in WIDTHS:
        out.append(f"\ntemplate <>\nstruct ChainPtx<{W}> {{")
        for name, (params, gen, decl) in STEPS.items():
            out.append(f"  static __device__ __forceinline__ void {name}("
                       f"{params}) {{")
            if decl:
                out.append(f"    {decl}")
            for block in gen(W):
                out.append(block.render("    "))
            out.append("  }")
        out.append("};")
    return "\n".join(out) + "\n"


def main(argv: list[str]) -> int:
    text = render()
    if "--check" in argv:
        with open(OUT) as fh:
            same = fh.read() == text
        print("up to date" if same else f"{OUT} differs from the generator")
        return 0 if same else 1
    with open(OUT, "w") as fh:
        fh.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
