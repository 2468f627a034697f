"""Lowering of witness-dependent dynamic ops to TPU-executable form.

The reference's IR carries IntDiv / Mod / Pow / ShiftL / ShiftR as
first-class runtime operators executed by every emitted runtime
(compiler/src/intermediate_representation/compute_bucket.rs:7-34; the
WASM field library implements division and inverseMod at
code_producers/src/wasm_elements/bn128/fr-code.wat:3059).  Emitted
code runs them per-element on the CPU; the TPU-native design instead
REWRITES them into static, batch-uniform dataflow at compile time:

* ``pow`` (witness-dependent exponent) -> a square-and-multiply ladder
  over all p.bit_length() exponent bits, with ``select`` predication
  per bit.  Exact for any exponent in [0, p) (hostfield.pow reduces
  the exponent into the field first, same as modular_arithmetic.rs).

* ``shl`` / ``shr`` (witness-dependent shift amount) -> the reference
  wrap rule (a shift by k > p/2 is the opposite shift by p - k,
  modular_arithmetic.rs:111-136) followed by a staged barrel shifter
  over the shift amount's low bits, ``select`` per stage.  Right
  shifts stage exactly (composition of right shifts is a right
  shift); left shifts avoid the intermediate-reduction pitfall via
      (a << k) & mask  ==  (a - ((a >> s) << s)) * 2^k   (s = bits-k)
  where every factor is exact mod p.  Shift amounts >= p.bit_length()
  give 0, matching the reference.

* ``mod`` -> a - idiv(a, b) * b (exact: q*b <= a < p, so the plain
  field ops equal the integer ops).

* ``idiv`` stays primitive: backends execute limb-level binary long
  division (ops/jfield.py ``idiv``; the Pallas interpreter's ``idiv``
  opcode).  Division by zero: the host calculator raises (reference
  runtime semantics); the batched TPU path DEFINES idiv(a, 0) = 0 and
  therefore mod(a, 0) = a — a batch cannot abort per element, and the
  sanity checker reports any constraint such a value violates.

The pass is a tape-to-tape rewrite, so every backend (interpreter,
segments, scan, SSA) inherits the capability from the shared plan.
"""

from .tape import Tape

DYNAMIC_OPS = ("pow", "shl", "shr", "mod")


def lower_dynamic_ops(tape: Tape) -> Tape:
    """Rewrite pow/shl/shr/mod into primitive tape ops; idiv stays.

    Returns the input tape unchanged when nothing needs lowering.
    """
    present = set(tape.ops)
    if not any(op in present for op in DYNAMIC_OPS):
        return tape

    p = tape.p
    bits = p.bit_length()
    t = Tape(p)
    new = {}

    def _pow_dyn(base, e):
        """base ** e for a witness-dependent exponent in [0, p)."""
        one = t.const(1)
        acc = one
        for i in range(bits - 1, -1, -1):
            if acc is not one:  # first square of 1 is a no-op
                acc = t.emit("mul", acc, acc)
            b = t.emit("band", t.emit("shr_k", e, imm=i), one)
            acc = t.emit("select", b, t.emit("mul", acc, base), acc)
        return acc

    def _bits_of(v, n):
        one = t.const(1)
        return [t.emit("band", t.emit("shr_k", v, imm=j), one)
                for j in range(n)]

    def _dynshr(a, kb):
        """a >> k from k's bit decomposition (exact at every stage)."""
        for j, b in enumerate(kb):
            a = t.emit("select", b, t.emit("shr_k", a, imm=1 << j), a)
        return a

    def _pow2(kb):
        """2^k mod p from k's bit decomposition."""
        e = t.const(1)
        for j, b in enumerate(kb):
            e = t.emit("select", b,
                       t.emit("mul", e, t.const(pow(2, 1 << j, p))), e)
        return e

    def _shift_dyn(op, a, k):
        zero = t.const(0)
        # wrap: unsigned k > p/2  <=>  signed-convention k < 0
        w = t.emit("lt", k, zero)
        k2 = t.emit("select", w, t.emit("neg", k), k)  # magnitude <= p/2
        big = t.emit("ge", k2, t.const(bits))  # k2 <= p/2: signed-safe
        # only bits below bit_length(bits-1) matter once big is handled
        kb = _bits_of(k2, (bits - 1).bit_length())
        # right shift by k2 (exact staged composition)
        y = t.emit("select", big, zero, _dynshr(a, kb))
        # left shift by k2: low = a & ((1 << (bits-k2)) - 1) computed
        # as a - ((a >> s) << s) with s = bits - k2; then low * 2^k2
        # reduces mod p exactly once (reference: ((a << k) & mask) % p)
        s = t.emit("sub", t.const(bits), k2)
        sb = _bits_of(s, bits.bit_length())  # s may equal bits itself
        top = t.emit("mul", _dynshr(a, sb), _pow2(sb))
        low = t.emit("sub", a, top)
        x = t.emit("select", big, zero, t.emit("mul", low, _pow2(kb)))
        if op == "shl":
            return t.emit("select", w, y, x)
        return t.emit("select", w, x, y)

    for i, op in enumerate(tape.ops):
        a = [new[x] for x in tape.args[i]]
        imm = tape.imms[i]
        if op == "const":
            new[i] = t.const(imm)
        elif op == "input":
            new[i] = t.input(imm)
        elif op == "pow":
            new[i] = _pow_dyn(a[0], a[1])
        elif op in ("shl", "shr"):
            new[i] = _shift_dyn(op, a[0], a[1])
        elif op == "mod":
            q = t.emit("idiv", a[0], a[1])
            new[i] = t.emit("sub", a[0], t.emit("mul", q, a[1]))
        else:
            new[i] = t.emit(op, *a, imm=imm)

    t.n_inputs = max(t.n_inputs, tape.n_inputs)
    t.outputs = [new[o].id for o in tape.outputs]
    t.n_guards = tape.n_guards
    t.node_hints = {new[i].id: h for i, h in tape.node_hints.items()
                    if i in new}
    t.extern_calls = [
        {**call,
         "inputs": {name: [(tag, v if tag == "const" else new[v].id)
                           for (tag, v) in elems]
                    for name, elems in call["inputs"].items()}}
        for call in tape.extern_calls
    ]
    return t
