"""Shared planning for the fused TPU backends.

Expands a jax_backend.DomainTape into a flat op list suitable for
straight-line limb kernels:

* `div` becomes Fermat inversion a^(p-2) as a static square-and-multiply
  mul chain (modular_arithmetic.rs `div` = mul by inverse);
* `pow_k` becomes a static mul chain;
* `neg` becomes `sub(0, a)`;
* `to_mont` / `from_mont` become muls by R^2 / 1 (zero limbs of the
  constant are skipped at kernel-emission time);
* ops whose operands are all constants fold on the host with reference
  semantics (Montgomery-domain muls fold as a*b*R^-1 on raw values,
  which is domain-correct);
* dead code is eliminated (witness outputs are the only roots).

Constants are tracked as *raw limb values* (already in the domain the
node carries), so downstream backends can inline them as immediates.
"""

from ..field.primes import LIMB_BITS, FieldSpec

MONT, NORM = 0, 1  # must match jax_backend.DomainTape


class UnsupportedTapeOp(NotImplementedError):
    pass


# ops that survive planning (everything else is expanded or folded)
KERNEL_OPS = {
    "mul", "mulp", "add", "sub", "select",
    "eq", "neq", "lt", "le", "gt", "ge",
    "land", "lor", "lnot",
    "band", "bor", "bxor", "bnot",
    "shl_k", "shr_k",
    "idiv",  # limb-level long division (backend/dynops.py contract)
}


class ExpandedTape:
    """Flat post-expansion program over raw limb values."""

    __slots__ = ("ops", "args", "imms", "kind", "cval", "iidx",
                 "out_ids", "live", "n_inputs", "L", "p", "R", "Rinv",
                 "narrow", "plain", "seed_rng")

    def __init__(self, dtape, spec: FieldSpec):
        from ..field.hostfield import HostField

        self.L = spec.n_limbs
        self.p = spec.p
        self.R = 1 << (LIMB_BITS * self.L)
        self.Rinv = pow(self.R, -1, self.p)
        self.n_inputs = dtape.n_inputs
        self.plain = getattr(dtape, "plain_field", False)
        hf = HostField(spec)

        ops, args, imms = [], [], []
        kind, cval, iidx, nrw = [], [], [], []
        const_ids, cse = {}, {}

        def push(op, a=(), imm=None, k="compute", v=None, ii=None,
                 narrow=False):
            nid = len(ops)
            ops.append(op)
            args.append(tuple(a))
            imms.append(imm)
            kind.append(k)
            cval.append(v)
            iidx.append(ii)
            nrw.append(narrow)
            return nid

        def const(v):
            v %= self.p
            hit = const_ids.get(v)
            if hit is None:
                hit = const_ids[v] = push("const", k="const", v=v)
            return hit

        def fold(op, vals, imm):
            if op == "mul":
                return (vals[0] * vals[1] * self.Rinv) % self.p
            if op == "mulp":
                return (vals[0] * vals[1]) % self.p
            if op == "add":
                return (vals[0] + vals[1]) % self.p
            if op == "sub":
                return (vals[0] - vals[1]) % self.p
            if op == "select":
                return vals[1] if vals[0] else vals[2]
            if op == "eq":
                return int(vals[0] == vals[1])
            if op == "neq":
                return int(vals[0] != vals[1])
            table = {
                "lt": hf.lesser, "le": hf.lesser_eq,
                "gt": hf.greater, "ge": hf.greater_eq,
                "land": hf.bool_and, "lor": hf.bool_or,
                "band": hf.bit_and, "bor": hf.bit_or, "bxor": hf.bit_xor,
            }
            if op in table:
                return table[op](vals[0], vals[1])
            if op == "idiv":
                # batched contract: idiv(a, 0) = 0 (dynops.py docstring)
                return vals[0] // vals[1] if vals[1] else 0
            if op == "lnot":
                return hf.bool_not(vals[0])
            if op == "bnot":
                return hf.complement(vals[0])
            if op == "shl_k":
                return hf.shift_l(vals[0], imm)
            if op == "shr_k":
                return hf.shift_r(vals[0], imm)
            raise UnsupportedTapeOp(op)

        def emit(op, a, imm=None, narrow=False):
            if all(kind[x] == "const" for x in a):
                return const(fold(op, [cval[x] for x in a], imm))
            key = (op, a, imm)
            hit = cse.get(key)
            if hit is None:
                hit = cse[key] = push(op, a, imm, narrow=narrow)
            return hit

        def mul_chain_pow(base, e):
            if e == 0:
                return const(self.R % self.p)  # one in Montgomery form
            acc = base
            for b in bin(e)[3:]:
                acc = emit("mul", (acc, acc))
                if b == "1":
                    acc = emit("mul", (acc, base))
            return acc

        new = {}
        for i, op in enumerate(dtape.ops):
            a = tuple(new[x] for x in dtape.args[i])
            imm = dtape.imms[i]
            if op == "const":
                v = imm if dtape.domains[i] != MONT \
                    else (imm * self.R) % self.p
                new[i] = const(v)
            elif op == "input":
                new[i] = push("input", imm=imm, k="input", ii=imm)
            elif op == "to_mont":
                new[i] = emit("mul", (a[0],
                                      const((self.R * self.R) % self.p)))
            elif op == "from_mont":
                new[i] = emit("mul", (a[0], const(1)))
            elif op == "neg":
                new[i] = emit("sub", (const(0), a[0]))
            elif op == "pow_k":
                new[i] = mul_chain_pow(a[0], imm)
            elif op == "div":
                inv = mul_chain_pow(a[1], self.p - 2)
                new[i] = emit("mul", (a[0], inv))
            elif op in KERNEL_OPS:
                new[i] = emit(op, a, imm, narrow=dtape.narrow[i])
            else:
                raise UnsupportedTapeOp(op)

        self.out_ids = [new[o] for o in dtape.outputs]
        # carry the tape-level intervals of identity-mapped NORM nodes
        # (DomainTape.node_rng) onto their post-expansion ids so
        # expanded_ranges can skip re-deriving them; cse collisions
        # intersect (both intervals bound the SAME value)
        self.seed_rng = {}
        for di, r in (getattr(dtape, "node_rng", None) or {}).items():
            xi = new.get(di)
            if xi is None or kind[xi] != "compute":
                continue
            if xi in self.seed_rng:
                prev = self.seed_rng[xi]
                if prev is not None and r is not None:
                    r = (max(prev[0], r[0]), min(prev[1], r[1]))
                elif r is None:
                    r = prev
            self.seed_rng[xi] = r
        live = [False] * len(ops)
        stack = list(self.out_ids)
        while stack:
            x = stack.pop()
            if live[x]:
                continue
            live[x] = True
            stack.extend(args[x])
        self.ops, self.args, self.imms = ops, args, imms
        self.kind, self.cval, self.iidx = kind, cval, iidx
        self.narrow = nrw
        self.live = live


NARROW_MAX = (1 << 31) - 1
_MISS = object()


def expanded_ranges(xt: "ExpandedTape", input_ranges=None):
    """Signed intervals over ExpandedTape nodes (None = wide/unknown).

    Mirrors backend/ranges.py on the post-expansion opset: Montgomery
    muls are wide by construction; `mulp` is a plain product.  Used by
    the interpreter to reassociate wide add trees into int32-safe
    narrow partial sums (bit-lincomb adders)."""
    input_ranges = input_ranges or {}
    p = xt.p
    half = p >> 1
    bits = p.bit_length()
    mask = (1 << bits) - 1
    n = len(xt.ops)
    rng = [None] * n

    def ok(lo, hi):
        return -NARROW_MAX <= lo and hi <= NARROW_MAX

    def _tx(i):
        k = xt.kind[i]
        if k == "const":
            v = xt.cval[i]
            s = v if v <= half else v - p
            if abs(s) <= NARROW_MAX:
                rng[i] = (s, s)
            return
        if k == "input":
            rng[i] = input_ranges.get(xt.iidx[i])
            return
        op = xt.ops[i]
        r = [rng[x] for x in xt.args[i]]
        imm = xt.imms[i]
        if op in ("eq", "neq", "lt", "le", "gt", "ge",
                  "land", "lor", "lnot"):
            rng[i] = (0, 1)
        elif op == "add" and None not in r:
            lo, hi = r[0][0] + r[1][0], r[0][1] + r[1][1]
            if ok(lo, hi):
                rng[i] = (lo, hi)
        elif op == "sub" and None not in r:
            lo, hi = r[0][0] - r[1][1], r[0][1] - r[1][0]
            if ok(lo, hi):
                rng[i] = (lo, hi)
        elif op == "mulp" and None not in r:
            cs = [x * y for x in r[0] for y in r[1]]
            lo, hi = min(cs), max(cs)
            if ok(lo, hi):
                rng[i] = (lo, hi)
        elif op == "select" and r[1] is not None and r[2] is not None:
            rng[i] = (min(r[1][0], r[2][0]), max(r[1][1], r[2][1]))
        elif op == "band":
            bounds = []
            for x, rx in zip(xt.args[i], r):
                if xt.kind[x] == "const":
                    bounds.append(xt.cval[x])
                elif rx is not None and rx[0] >= 0:
                    bounds.append(rx[1])
                else:
                    bounds.append(None)
            known = [b for b in bounds if b is not None]
            if known and min(known) <= NARROW_MAX:
                rng[i] = (0, min(known))
        elif op in ("bor", "bxor") and None not in r \
                and r[0][0] >= 0 and r[1][0] >= 0:
            hi = max(r[0][1], r[1][1])
            hi = (1 << hi.bit_length()) - 1
            if hi <= NARROW_MAX:
                rng[i] = (0, hi)
        elif op == "shr_k" and r[0] is not None and r[0][0] >= 0:
            rng[i] = (r[0][0] >> imm, r[0][1] >> imm)
        elif op == "shl_k" and r[0] is not None and r[0][0] >= 0:
            hi = r[0][1] << imm
            if hi <= NARROW_MAX and hi <= mask and hi < p:
                rng[i] = (r[0][0] << imm, hi)
        elif op == "idiv" and r[0] is not None and r[0][0] >= 0 \
                and r[1] is not None and r[1][0] >= 0:
            rng[i] = (0, r[0][1] // max(r[1][0], 1))

    from .ranges import GadgetSharpener
    sh = GadgetSharpener(
        n, lambda i: xt.ops[i], lambda i: xt.args[i],
        lambda i: ((xt.cval[i] if xt.cval[i] <= half
                    else xt.cval[i] - p)
                   if xt.kind[i] == "const" else None),
        rng, ring_muls={"mulp"})
    # nodes identity-mapped from the source tape carry the tape-level
    # analysis result (ranges.analyze_ranges + sharpener + tag hints —
    # a superset of the rules here), so their transfer AND sharpener
    # walk are skipped; width<=1 seeds still register as sharpener
    # atoms so synthesized ring gadgets over them keep sharpening
    # (dedup of the duplicated range analyses, ~7s on SHA-class)
    seed = getattr(xt, "seed_rng", None) or {}
    for i in range(n):
        s = seed.get(i, _MISS)
        if s is not _MISS:
            rng[i] = s
            sh._as_atom(i)
            continue
        _tx(i)
        sh.visit(i)
    return rng
