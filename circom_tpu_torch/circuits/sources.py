"""Circuit sources of the port's benchmark-class paths.

- BIGINT_DIV_SRC: a witness-dependent integer division and remainder
  (a copy of bench.py's BIGINT_DIV_SRC, the circomlib bigint-hint class);
  its plan runs the wide long division `idiv`.
- comparators_source(): LessThan(64), LessEqThan(64) and IsEqual() of two
  inputs a and b, and Num2Bits(64) of a + b, from the standard gadget
  library circuits/stdlib.circom: the range-check and comparator class
  that almost every circomlib circuit contains.  Num2Bits' constraint
  holds for a + b < 2^64.
- poseidon2_source(prime): the repository's generated Poseidon2 (t = 3).
- num2bits_source(n, copies): `copies` Num2Bits(n) of as many inputs,
  every bit a witness output; at n = 254 over bn128 the full-width bit
  decomposition, which the interpreter planner refuses (its register
  files exceed the JAX kernel's VMEM budget): one copy runs on the
  segments, four on two segments, sixteen on the per-op path.
- lessthan_source(n): LessThan(n) of a and b.
- mimc_source(n): circuits/mimc.circom with main MiMC7() (n = None) or
  MultiMiMC7(n), the multi-message hash that circomlib's
  EdDSAMiMCVerifier applies to its five inputs (BASELINE.json config 4).
- merkle_source(depth): circuits/poseidon.circom and merkle.circom with
  main MerkleInclusion(depth), a Poseidon2 hash a level and a Switcher on
  each path bit (config 5 at depth 32); its pathIndex inputs are bits, so
  input_range_hints puts them on the narrow lane.
- bigdiv_num2bits_source(): a \\ b and a % b, then Num2Bits(254) of the
  quotient, the range check a circomlib bigint circuit puts on its hint
  (idiv: the per-op path).
- segment_ops_source(bits): one circuit whose segment holds every op of
  the segmented backend (plan.KERNEL_OPS but idiv), with constant
  operands that have zero limbs and shift counts 0, 1, 15, 16, 17 and
  bits - 1; input c is a bit, so that its product by a constant is a
  plain product (mulp) at bn128 too, and a division at goldilocks gives
  its Montgomery products.
- random_r1cs(spec, ...): a random constraint system with satisfying
  witnesses, at any prime: rows of several terms with random
  coefficients, for the R1CS check at primes no circuit path reaches.
- kc_extreme_r1cs(spec, B): rows at the edge of the R1CS check kernel's
  accumulators (each coefficient class at its largest, 61 wide and 228
  small terms a row, a long row, empty matrices) and witnesses at -1.
- ks_tapes(): the small per-op tapes that the per-op kernel KS is held
  to at every field (tests/test_torch_scan.py's TAPES and pow_div:
  mixed wide and narrow ops, the wide shifts, the long division, K1d's
  wide ops, bigint-div + Num2Bits(254), 4 x Num2Bits(32), and powers and
  divisions by a witness).
"""

import random
from pathlib import Path

import numpy as np

from .gen_poseidon import generate

BIGINT_DIV_SRC = """
pragma circom 2.0.0;
template BigDiv() {
    // circomlib-style bigint hint: witness-dependent integer division
    // (RSA/ECDSA-class patterns); the in-kernel long-division loop
    // runs 254 shift/compare/subtract iterations per idiv
    signal input a;
    signal input b;
    signal output q;
    signal output r;
    q <-- a \\ b;
    r <-- a % b;
    a === q * b + r;
}
component main = BigDiv();
"""

COMPARATORS_MAIN = """
template Comparators64() {
    signal input a;
    signal input b;
    signal output lt;
    signal output le;
    signal output eq;
    signal output bits[64];
    component c_lt = LessThan(64);
    c_lt.in[0] <== a;
    c_lt.in[1] <== b;
    lt <== c_lt.out;
    component c_le = LessEqThan(64);
    c_le.in[0] <== a;
    c_le.in[1] <== b;
    le <== c_le.out;
    component c_eq = IsEqual();
    c_eq.in[0] <== a;
    c_eq.in[1] <== b;
    eq <== c_eq.out;
    component n2b = Num2Bits(64);
    n2b.in <== a + b;
    for (var i = 0; i < 64; i++) { bits[i] <== n2b.out[i]; }
}
component main = Comparators64();
"""


def comparators_source(stdlib=None):
    """The comparator circuit over the given stdlib text (default: the
    port's copy, circuits/stdlib.circom)."""
    if stdlib is None:
        stdlib = (Path(__file__).resolve().parent
                  / "stdlib.circom").read_text()
    return stdlib + COMPARATORS_MAIN


def _circuit(name):
    return (Path(__file__).resolve().parent / name).read_text()


def mimc_source(n=None):
    main = "MiMC7()" if n is None else f"MultiMiMC7({n})"
    return _circuit("mimc.circom") + f"\ncomponent main = {main};\n"


def merkle_source(depth):
    return (_circuit("poseidon.circom")
            + _circuit("merkle.circom").replace("pragma circom 2.0.0;", "")
            + f"\ncomponent main = MerkleInclusion({depth});\n")


def poseidon2_source(prime="bn128"):
    return generate((2,), prime=prime) + "\ncomponent main = Poseidon2();\n"


def comparator_inputs(B, seed, L):
    """Inputs a, b of the comparator circuit as uint32 limbs (2, L, B),
    with a + b < 2^64: the first lanes are edge pairs, then every fourth
    lane has a = b, every fourth a + b just below 2^64 (one operand near
    2^64, the other tiny), and the rest a random split of a random 64-bit
    sum, so that a < b and a > b both occur."""
    rng = np.random.default_rng(seed)
    top = np.uint64(2 ** 64 - 1)
    s = rng.integers(0, top, size=B, dtype=np.uint64, endpoint=True)
    a = rng.integers(0, s, dtype=np.uint64, endpoint=True)
    lane = np.arange(B)
    eq = lane % 4 == 0
    a[eq] = s[eq] // np.uint64(2)
    s[eq] = a[eq] * np.uint64(2)
    near = lane % 4 == 1
    s[near] = top - rng.integers(0, 1024, size=int(near.sum()),
                                 dtype=np.uint64)
    j = rng.integers(0, 4, size=int(near.sum()), dtype=np.uint64)
    a[near] = np.where(lane[near] % 8 == 1, s[near] - j, j)
    b = s - a
    edges = [(0, 0), (2 ** 64 - 1, 0), (0, 2 ** 64 - 1), (2 ** 63, 2 ** 63 - 1),
             (2 ** 63 - 1, 2 ** 63), (1, 0), (0, 1), (2 ** 32, 2 ** 32)]
    for k, (x, y) in enumerate(edges[:B]):
        a[k], b[k] = x, y
    out = np.zeros((2, L, B), np.uint32)
    for i in range(4):
        out[0, i] = (a >> np.uint64(16 * i)) & np.uint64(0xFFFF)
        out[1, i] = (b >> np.uint64(16 * i)) & np.uint64(0xFFFF)
    return out


def random_r1cs(spec, n_inputs, n_rows, terms, B, seed, classes=False):
    """A random constraint system over the field `spec` and B witnesses
    that satisfy it: (rows, their 16-bit limbs uint32 (n_wires,
    spec.n_limbs, B)).  Wire 0 is 1, wires 1 ..
    n_inputs random (the first lanes 0, 1 and p - 1), then one output
    wire a row.  Row r has up to `terms` nonzeros in A and in B over the
    wires before its output, coefficients random or 1 or p - 1 (with
    `classes`, drawn evenly from kernel KC's six classes: ±1, ±c with
    1 < c < 2^32 and ±c wider), and C = c_r·out_r + d_r·w_r; out_r is the
    value that satisfies it."""
    rng = random.Random(seed)
    p, L = spec.p, spec.n_limbs
    n_wires = 1 + n_inputs + n_rows
    z = [[1] * B] + [[rng.randrange(p) for _ in range(B)]
                     for _ in range(n_inputs)]
    for j, v in enumerate((0, 1, p - 1)[:min(B, n_inputs)]):
        z[1 + j][j] = v

    def coef():
        if classes:
            m = rng.choice((1, rng.randrange(2, 1 << 32),
                            rng.randrange(1 << 32, (p + 1) // 2)))
            return rng.choice((m, p - m))
        return rng.choice((1, p - 1, rng.randrange(1, p)))

    rows = []
    for r in range(n_rows):
        below = len(z)
        a, b = ({rng.randrange(below): coef()
                 for _ in range(rng.randint(1, terms))} for _ in range(2))
        c_out, w, d = rng.randrange(1, p), rng.randrange(below), coef()
        inv = pow(c_out, -1, p)
        out = []
        for lane in range(B):
            az = sum(k * z[i][lane] for i, k in a.items())
            bz = sum(k * z[i][lane] for i, k in b.items())
            out.append((az * bz - d * z[w][lane]) * inv % p)
        z.append(out)
        rows.append((a, b, {below: c_out, w: d}))
    limbs = np.zeros((n_wires, L, B), np.uint32)
    for i, col in enumerate(z):
        for lane, v in enumerate(col):
            for k in range(L):
                limbs[i, k, lane] = (v >> (16 * k)) & 0xFFFF
    return rows, limbs


def kc_extreme_r1cs(spec, B):
    """Rows at the edge of kernel KC's accumulators, over the field `spec`,
    and B witnesses: (rows, their 16-bit limbs uint32 (n_wires,
    spec.n_limbs, B)).  Each row has its own wires; its terms take each
    class's largest |c| (1, 2^32 - 1 and (p - 1)/2) in one sign or both:
    61 wide terms against 228 small ones, all positive, all negative and
    mixed, units, rows with an empty A, B or C, and a C of 4,096 small
    terms.  Each row's last C term, d·w, is chosen so that the row
    holds where every wire is -1 mod p.  Lane 0 holds p - 1 on every
    wire, lane 1 the largest k p - 1 below R (-1, not canonical: the
    check takes a wire mod p), lane 2 R - 1 on every wire; lane 3 + j
    sets a wire of row j % n_rows (of its C, or of its A where C is empty)
    to 0, so that the row fails."""
    p, L = spec.p, spec.n_limbs
    unit, small, wide = 1, (1 << 32) - 1, (p - 1) // 2
    n_wires = [0]

    def terms(m, n, signs):
        """{wire: coefficient} of n new wires, |c| = m, signs cycling
        through `signs` (+1 / -1)."""
        out = {}
        for k in range(n):
            n_wires[0] += 1
            out[n_wires[0] - 1] = m if signs[k % len(signs)] > 0 else p - m
        return out

    pos, neg, both = (1,), (-1,), (1, -1)
    shapes = [  # (A, B, C) of each row, each a list of (|c|, count, signs)
        ([(wide, 61, pos)], [(small, 228, pos)],
         [(wide, 61, pos), (small, 228, pos)]),
        ([(wide, 61, neg)], [(small, 228, neg)],
         [(wide, 61, neg), (small, 228, neg)]),
        ([(small, 228, both)], [(wide, 61, both)],
         [(wide, 20, both), (small, 100, both), (unit, 100, both)]),
        ([(wide, 20, both), (small, 60, both), (unit, 60, both)],
         [(unit, 1, neg)], [(unit, 228, both)]),
        ([], [(small, 228, pos)], [(unit, 2, both)]),
        ([(wide, 61, pos)], [], [(small, 228, neg)]),
        ([(unit, 2, both)], [(unit, 1, pos)], []),
        ([(unit, 1, pos)], [(small, 3, both)], [(small, 4096, pos)]),
    ]
    rows = []
    for shape in shapes:
        a, b, c = ({w: k for m, n, s in part for w, k in terms(m, n, s)
                    .items()} for part in shape)
        # every wire -1: A·B = sum_A · sum_B, C = -sum_C - d
        sa, sb, sc = (sum(m.values()) for m in (a, b, c))
        d = (-(sa * sb if a and b else 0) - sc) % p
        if c or d:
            c = {**c, n_wires[0]: d}
            n_wires[0] += 1
        rows.append((a, b, c))
    R = 1 << (16 * L)

    def limbs_of(v):
        return np.array([(v >> (16 * k)) & 0xFFFF for k in range(L)],
                        np.uint32)[:, None]

    z = np.empty((n_wires[0], L, B), np.uint32)
    z[...] = limbs_of(p - 1)
    for lane, v in enumerate([p - 1, (R - 1) // p * p - 1, R - 1][:B]):
        z[:, :, lane] = limbs_of(v)[:, 0]
    for lane in range(3, B):
        r = (lane - 3) % len(rows)
        z[next(iter(rows[r][2] or rows[r][0])), :, lane] = 0
    return rows, z


def _stdlib():
    return (Path(__file__).resolve().parent / "stdlib.circom").read_text()


def num2bits_source(n=254, copies=1, stdlib=None):
    """`copies` Num2Bits(n) of inputs a[0..copies-1]; outputs o[k][i]."""
    main = f"""
template Bits{copies}x{n}() {{
    signal input a[{copies}];
    signal output o[{copies}][{n}];
    component n2b[{copies}];
    for (var k = 0; k < {copies}; k++) {{
        n2b[k] = Num2Bits({n});
        n2b[k].in <== a[k];
        for (var i = 0; i < {n}; i++) {{ o[k][i] <== n2b[k].out[i]; }}
    }}
}}
component main = Bits{copies}x{n}();
"""
    return (stdlib or _stdlib()) + main


def lessthan_source(n=252, stdlib=None):
    main = f"""
template Lt{n}() {{
    signal input a;
    signal input b;
    signal output lt;
    component c = LessThan({n});
    c.in[0] <== a;
    c.in[1] <== b;
    lt <== c.out;
}}
component main = Lt{n}();
"""
    return (stdlib or _stdlib()) + main


BIGDIV_NUM2BITS_MAIN = """
template BigDivBits() {
    signal input a;
    signal input b;
    signal output q;
    signal output r;
    signal output bits[254];
    q <-- a \\ b;
    r <-- a % b;
    a === q * b + r;
    component n2b = Num2Bits(254);
    n2b.in <== q;
    for (var i = 0; i < 254; i++) { bits[i] <== n2b.out[i]; }
}
component main = BigDivBits();
"""


def bigdiv_num2bits_source(stdlib=None):
    return (stdlib or _stdlib()) + BIGDIV_NUM2BITS_MAIN


def segment_ops_source(bits, division=True):
    """Every op of the segmented backend in one circuit (see above);
    division=False leaves out the division (and so, at goldilocks, the
    Montgomery mul)."""
    ops = [
        "a * b", "a * 18446744073709551616",
        "c * 340282366920938463463374607431768211457", "a + b",
        "a + 340282366920938463463374607431768211456", "a - b",
        "65536 - a", "a ? b : c", "b ? 4294967296 : a", "a ? 0 : b",
        "a == b", "a != 65536", "a < b",
        "a <= 1606938044258990275541962092341162602522202993782792835301376",
        "a > b", "a >= b", "a && b", "a || 0", "!a", "a & b",
        "a & 0xFFFF00000000FFFF", "a | b", "a | 0x10000", "a ^ b",
        "a ^ 0xFFFF0000", "~a", "(a * b) * (a + 1)", "a * a", "a ** 5"]
    ops += [f"a {d} {k}" for d in (">>", "<<")
            for k in (0, 1, 15, 16, 17, bits - 1)]
    if bits <= 64 and division:
        # goldilocks' products are plain (mulp): its Montgomery mul is
        # in the inversion chain of a division (at bn128 a chain of 380
        # products, above the segments' MAX_COST)
        ops.append("a / b")
    body = "\n".join(f"  o[{i}] <-- {e};" for i, e in enumerate(ops))
    return f"""
pragma circom 2.0.0;
template SegmentOps() {{
  signal input a;
  signal input b;
  signal input c;
  signal output o[{len(ops)}];
  c * (c - 1) === 0;
{body}
  for (var i = 0; i < {len(ops)}; i++) {{ o[i] * 0 === 0; }}
}}
component main = SegmentOps();
"""


MIXED_SRC = """
pragma circom 2.0.0;
template T() {
  signal input a;
  signal input b;
  signal output o1;
  signal output o2;
  signal output o3;
  signal inter;
  inter <== a * b + 3;
  o1 <== inter * inter + a;
  o2 <-- a < b ? (a ^ b) + 5 : (a | b) - (a & b);
  o3 <-- (o2 != 0) ? a - inter : -b + inter;
  o2 * 0 === 0;
  o3 * 0 === 0;
}
component main = T();
"""

WIDE_SHIFTS_SRC = """
pragma circom 2.0.0;
template T() {
  signal input a;
  signal output o1;
  signal output o2;
  o1 <-- a >> 3;
  o2 <-- a << 5;
  o1 * 0 === 0;
  o2 * 0 === 0;
}
component main = T();
"""

WIDE_OPS_SRC = """
pragma circom 2.0.0;
template WideOps() {
  signal input a;
  signal input b;
  signal output o[12];
  o[0] <-- a << 5;
  o[1] <-- ~a;
  o[2] <-- a - 7;
  o[3] <-- !a;
  o[4] <-- a == b;
  o[5] <-- a <= b;
  o[6] <-- a > b;
  o[7] <-- a >= b;
  o[8] <-- a && b;
  o[9] <-- a || b;
  o[10] <-- a \\ b;
  o[11] <-- 7 - a;
  for (var i = 0; i < 12; i++) { o[i] * 0 === 0; }
}
component main = WideOps();
"""

POW_DIV_SRC = """
pragma circom 2.0.0;
template PowDiv() {
    signal input a;
    signal input b;
    signal output o[6];
    o[0] <-- a ** 5;
    o[1] <-- a / b;
    o[2] <-- a % b;
    o[3] <-- a ** 65537;
    o[4] <-- (a * b) ** 3;
    o[5] <-- a ** 2147483647;
}
component main = PowDiv();
"""


def ks_tapes(stdlib=None):
    """name -> source of the per-op tapes KS is held to at every field
    (see above); the second input of bigdiv, wide_ops, bigdiv_num2bits
    and pow_div divides."""
    return {"mixed": MIXED_SRC, "wide_shifts": WIDE_SHIFTS_SRC,
            "bigdiv": BIGINT_DIV_SRC, "wide_ops": WIDE_OPS_SRC,
            "bigdiv_num2bits": bigdiv_num2bits_source(stdlib),
            "num2bits32x4": num2bits_source(32, 4, stdlib),
            "pow_div": POW_DIV_SRC}
