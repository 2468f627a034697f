"""Value-range analysis over the witness tape: the narrow-lane planner.

Bit-blasted circuits (SHA-class) compute thousands of {0,1}-valued
signals with full prime-field arithmetic in the reference runtimes.  On
TPU that costs a 16-limb Montgomery multiply per bit gadget.  This pass
proves signed ranges for tape nodes; nodes whose values provably fit a
signed int32 (and all of whose consumers see exact ring arithmetic) can
execute on a NARROW int32 lane — one VPU op instead of ~2,500.

Soundness: a narrow value v (|v| < 2^31) represents the field element
v mod p.  Ring ops (+, -, *) commute with the ℤ→F_p homomorphism, so
computing them on ints is exact as long as results stay in range
(interval arithmetic proves it; int32 wraparound cannot occur for
proven-in-range results).  The circom signed comparison convention
(values > p/2 compare negative, modular_arithmetic.rs:155-165) makes
the signed int *be* the compared value, so comparisons are plain int
compares.  Bitwise ops and shifts require proven-nonnegative operands
(the canonical value equals the int).

Three hint sources narrow beyond pure dataflow:

* main-input hints derived from the circuit's OWN constraints — bit
  constraints x(x-1)=0 and Num2Bits-style decompositions
  (pipeline.input_range_hints; validated host-side by the CLI);
* `binary` / valued-`maxbit` signal TAGS recorded per tape node by the
  executor (tape.node_hints) — the author's range assertions, the
  same information the reference exports for downstream provers; a
  violated tag voids the contract (the reference documents tags as
  unchecked assertions);
* the GadgetSharpener below, which recovers exact {0,1} ranges of
  quadratic bit gadgets that interval arithmetic loses.
"""

NARROW_MAX = (1 << 31) - 1

# ops that may produce a narrow value (given narrow/eligible args)
_RING = {"add", "sub", "mul", "neg", "select"}
_BITS01 = {"eq", "neq", "lt", "le", "gt", "ge", "land", "lor", "lnot"}
_BITWISE = {"band", "bor", "bxor"}


class GadgetSharpener:
    """Exact-range refinement for quadratic bit gadgets.

    Interval arithmetic loses correlation between repeated operands:
    circomlib-style XOR/MAJ/CH gadgets (out = a*(1-2b-2c+4bc)+b+c-2bc)
    get hull (-2,3) although the value is always a bit — which poisons
    every downstream bound (bit*2^k weight products, AddModW sums).
    For each node built from ring ops whose transitive ATOM support
    (atoms = nodes with a proven width-<=1 range) has <= max_support
    elements, enumerate all atom assignments exactly (correlation
    preserved — a repeated atom is the same enumeration variable) and
    intersect the enumerated hull with the interval hull.  Sound: the
    true value is one of the enumerated ones whenever every atom's
    proven range holds.

    Call ``visit(i)`` right after the interval pass assigns rng[i], in
    topological order, so refinements feed downstream bounds in the
    same forward pass.  ``ring_muls``: plain-product opcode set ('mul'
    on the source tape, 'mulp' post-expansion — Montgomery 'mul' is
    NOT a ring op there).
    """

    def __init__(self, n, op_of, args_of, cval_of, rng, ring_muls,
                 max_support=6, max_abs=1 << 40):
        import numpy as np

        self.np = np
        self.op_of, self.args_of, self.cval_of = op_of, args_of, cval_of
        self.rng = rng
        self.ring = {"add", "sub", "neg"} | set(ring_muls)
        self.max_support = max_support
        self.max_abs = max_abs
        self.support = [None] * n   # sorted atom-id tuple, or None
        self.vec = [None] * n       # int64 values over the assignments
        # expansion index vectors keyed by the POSITION pattern of
        # s_from within s_to (node ids differ per gadget, positions
        # repeat constantly — SHA-class tapes hit this 340k+ times)
        self._expand_cache = {}

    def _as_atom(self, i):
        r = self.rng[i]
        if r is not None and r[1] - r[0] <= 1 \
                and abs(r[0]) < self.max_abs and abs(r[1]) < self.max_abs:
            self.support[i] = () if r[0] == r[1] else (i,)
            self.vec[i] = self.np.asarray(
                [r[0]] if r[0] == r[1] else [r[0], r[1]], self.np.int64)

    def _expand(self, v, s_from, s_to):
        if s_from == s_to:
            return v
        key = (tuple(s_to.index(a) for a in s_from), len(s_to))
        idx = self._expand_cache.get(key)
        if idx is None:
            np = self.np
            m = np.arange(1 << len(s_to))
            idx = np.zeros_like(m)
            for j, pos in enumerate(key[0]):
                idx |= ((m >> pos) & 1) << j
            self._expand_cache[key] = idx
        return v[idx]

    def visit(self, i):
        c = self.cval_of(i)
        if c is not None:
            if abs(c) < self.max_abs:
                self.support[i] = ()
                self.vec[i] = self.np.asarray([c], self.np.int64)
            return
        op = self.op_of(i)
        args = self.args_of(i)
        vec, support = self.vec, self.support
        if op not in self.ring or not args \
                or any(vec[x] is None for x in args):
            self._as_atom(i)
            return
        s = tuple(sorted(set().union(*(support[x] for x in args))))
        if len(s) > self.max_support:
            self._as_atom(i)
            return
        vs = [self._expand(vec[x], support[x], s) for x in args]
        if op == "add":
            v = vs[0] + vs[1]
        elif op == "sub":
            v = vs[0] - vs[1]
        elif op == "neg":
            v = -vs[0]
        else:
            v = vs[0] * vs[1]
        lo, hi = int(v.min()), int(v.max())
        if abs(lo) >= self.max_abs or abs(hi) >= self.max_abs:
            self._as_atom(i)
            return
        support[i], vec[i] = s, v
        r = self.rng[i]
        if r is not None:
            lo, hi = max(lo, r[0]), min(hi, r[1])
        if -NARROW_MAX <= lo and hi <= NARROW_MAX:
            self.rng[i] = (lo, hi)


def _hull(*ivs):
    return (min(lo for lo, _ in ivs), max(hi for _, hi in ivs))


def analyze_ranges(tape, input_ranges=None):
    """Per-node signed interval (lo, hi), or None (wide).

    ``input_ranges``: dict input_index -> (lo, hi) from signal tags.
    Ranges are *plain-value* semantics (the source tape, before any
    Montgomery domain assignment).
    """
    p = tape.p
    half = p >> 1
    bits = p.bit_length()
    mask = (1 << bits) - 1
    input_ranges = input_ranges or {}
    n = len(tape.ops)
    rng = [None] * n

    def ok(lo, hi):
        return -NARROW_MAX <= lo and hi <= NARROW_MAX

    def _tx(i):
        op = tape.ops[i]
        a = tape.args[i]
        imm = tape.imms[i]
        r = [rng[x] for x in a]
        if op == "const":
            v = imm
            s = v if v <= half else v - p
            if abs(s) <= NARROW_MAX:
                rng[i] = (s, s)
            return
        if op == "input":
            rng[i] = input_ranges.get(imm)
            return
        if op in _BITS01:
            rng[i] = (0, 1)
            return
        if op == "add" and None not in r:
            lo, hi = r[0][0] + r[1][0], r[0][1] + r[1][1]
            if ok(lo, hi):
                rng[i] = (lo, hi)
            return
        if op == "sub" and None not in r:
            lo, hi = r[0][0] - r[1][1], r[0][1] - r[1][0]
            if ok(lo, hi):
                rng[i] = (lo, hi)
            return
        if op == "neg" and r[0] is not None:
            lo, hi = -r[0][1], -r[0][0]
            if ok(lo, hi):
                rng[i] = (lo, hi)
            return
        if op == "mul" and None not in r:
            cs = [x * y for x in r[0] for y in r[1]]
            lo, hi = min(cs), max(cs)
            if ok(lo, hi):
                rng[i] = (lo, hi)
            return
        if op == "select" and r[1] is not None and r[2] is not None:
            # cond may be wide (nonzero test); result is the hull
            rng[i] = _hull(r[1], r[2])
            return
        if op == "band":
            # band with a small constant narrows a WIDE operand too:
            # the result is bounded by the constant's bit pattern
            bounds = []
            for x, rx in zip(a, r):
                if tape.ops[x] == "const":
                    bounds.append(tape.imms[x])
                elif rx is not None and rx[0] >= 0:
                    bounds.append(rx[1])
                else:
                    bounds.append(None)
            known = [b for b in bounds if b is not None]
            if known and min(known) <= NARROW_MAX:
                rng[i] = (0, min(known))
            return
        if op in ("bor", "bxor") and None not in r \
                and r[0][0] >= 0 and r[1][0] >= 0:
            hi = max(r[0][1], r[1][1])
            hi = (1 << hi.bit_length()) - 1
            if hi <= NARROW_MAX:
                rng[i] = (0, hi)
            return
        if op == "shr_k" and r[0] is not None and r[0][0] >= 0:
            rng[i] = (r[0][0] >> imm, r[0][1] >> imm)
            return
        if op == "shl_k" and r[0] is not None and r[0][0] >= 0:
            hi = r[0][1] << imm
            if hi <= NARROW_MAX and hi <= mask and hi < p:
                rng[i] = (r[0][0] << imm, hi)
            return
        if op == "idiv" and r[0] is not None and r[0][0] >= 0 \
                and r[1] is not None and r[1][0] >= 0:
            # quotient <= dividend; idiv(a, 0) = 0 on the batched path
            rng[i] = (0, r[0][1] // max(r[1][0], 1))
            return
        # everything else (div, pow, bnot, dynamic shifts, ...) is wide

    half_p = half
    sh = GadgetSharpener(
        n, lambda i: tape.ops[i], lambda i: tape.args[i],
        lambda i: ((tape.imms[i] if tape.imms[i] <= half_p
                    else tape.imms[i] - p)
                   if tape.ops[i] == "const" else None),
        rng, ring_muls={"mul"})
    # tag-asserted node ranges (executor._tag_range_hint): intersect
    # with the computed interval right after each node's transfer so
    # downstream bounds see the sharpened range in the same pass
    node_hints = getattr(tape, "node_hints", None) or {}
    for i in range(n):
        _tx(i)
        h = node_hints.get(i)
        if h is not None:
            r = rng[i]
            rng[i] = h if r is None else (max(r[0], h[0]),
                                          min(r[1], h[1]))
        sh.visit(i)

    return rng


def narrow_nodes(tape, input_ranges=None):
    """The set of node ids eligible for the narrow int32 lane.

    A node is narrow when its range is proven AND its op belongs to the
    narrow instruction set with compatibly-represented operands:

    * ring ops / shifts / bitwise: every non-const operand narrow
      (band also narrows wide operands against a small constant);
    * comparisons & booleans: always narrow results (operands may be
      wide — the kernel has wide-operand compare variants);
    * const operands must themselves fit int32 (range analysis already
      requires it via interval propagation, except band/select).
    """
    rng = analyze_ranges(tape, input_ranges)
    narrow = set()
    # NOTE: operand eligibility checks use MEMBERSHIP in `narrow`, not
    # rng: tag hints (tape.node_hints) can range a node whose op has
    # no narrow form (e.g. a tagged div output) — such a node's range
    # still sharpens downstream intervals, but it lives in the wide
    # register file, so no narrow op may consume it directly.
    for i in range(len(tape.ops)):
        if rng[i] is None:
            continue
        op = tape.ops[i]
        if op in ("const", "input"):
            narrow.add(i)
            continue
        if op in _BITS01:
            narrow.add(i)
            continue
        args = tape.args[i]
        if op == "band":
            # allowed: both narrow, or wide & small-const
            if all(x in narrow for x in args) or any(
                    tape.ops[x] == "const"
                    and tape.imms[x] <= NARROW_MAX for x in args):
                narrow.add(i)
            continue
        if op == "select":
            if all(x in narrow for x in args[1:]):
                narrow.add(i)  # cond handled wide or narrow in-kernel
            continue
        if op in ("add", "sub", "mul", "neg", "bor", "bxor",
                  "shl_k", "shr_k"):
            if all(x in narrow for x in args):
                narrow.add(i)
            continue
        if op == "idiv":
            # int32 division is only exact for NONNEG canonical
            # operands (analyze_ranges already requires that to
            # produce a range here)
            if all(x in narrow and rng[x][0] >= 0 for x in args):
                narrow.add(i)
            continue
    return narrow, rng
