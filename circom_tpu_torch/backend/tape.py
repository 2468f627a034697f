"""Witness tape: straight-line SSA program of field ops.

This replaces the reference's WASM/C++ witness-code generation
(compiler/src/intermediate_representation, code_producers): because circom
rejects constraints/signals under unknown control flow
(type_analysis unknown_known_analysis) the whole witness computation
flattens at compile time into one dataflow DAG of field operations over the
input signals — the TPU-native form.  Data-dependent `?:`/if over witness
values become `select` nodes; data-dependent `while` loops unroll with
predication and a runtime guard (executor._exec_while_predicated);
witness-dependent pow/shl/shr/mod lower to primitive ops and idiv runs
as limb-level long division (backend/dynops.py).

Nodes are hash-consed (CSE).  Ops carry an optional static immediate
(shift amounts, exponents) so the JAX backend can specialize.
"""

from dataclasses import dataclass

# opcode -> arity (excluding immediates)
OPS = {
    "const": 0, "input": 0,
    "add": 2, "sub": 2, "mul": 2, "div": 2, "idiv": 2, "mod": 2,
    "pow": 2, "shl": 2, "shr": 2,
    "lt": 2, "le": 2, "gt": 2, "ge": 2, "eq": 2, "neq": 2,
    "land": 2, "lor": 2, "band": 2, "bor": 2, "bxor": 2,
    "neg": 1, "lnot": 1, "bnot": 1,
    "shl_k": 1, "shr_k": 1, "pow_k": 1,   # imm = static shift/exponent
    "select": 3,                           # (cond, if_true, if_false)
}


@dataclass(frozen=True, slots=True)
class TapeRef:
    id: int


class Tape:
    """SSA node list; node i: (op, operand ids tuple, imm)."""

    def __init__(self, p: int):
        self.p = p
        self.ops: list[str] = []
        self.args: list[tuple] = []
        self.imms: list = []
        self._cse: dict = {}
        self.n_inputs = 0
        self.outputs: list[int] = []     # node ids in witness order
        self.n_guards = 0    # trailing outputs = while-unroll guards
        # node id -> (lo, hi) signed range asserted by signal TAGS
        # (binary / valued maxbit, recorded by the executor); author
        # assertions, same contract as the reference's exported tags
        self.node_hints = {}
        # extern_c gates with registered host implementations: their
        # outputs are extra input SLOTS filled per batch column by
        # compute_extern_columns before the device program runs
        # (executor._apply_extern_tape records the recipes)
        self.extern_calls = []

    def __len__(self):
        return len(self.ops)

    def _push(self, op, args, imm=None) -> TapeRef:
        key = (op, args, imm)
        hit = self._cse.get(key)
        if hit is not None:
            return TapeRef(hit)
        nid = len(self.ops)
        self.ops.append(op)
        self.args.append(args)
        self.imms.append(imm)
        self._cse[key] = nid
        return TapeRef(nid)

    def const(self, value: int) -> TapeRef:
        return self._push("const", (), value % self.p)

    def input(self, index: int) -> TapeRef:
        self.n_inputs = max(self.n_inputs, index + 1)
        return self._push("input", (), index)

    def emit(self, op: str, *operands, imm=None) -> TapeRef:
        args = tuple(o.id for o in operands)
        assert len(args) == OPS[op], (op, args)
        return self._push(op, args, imm)

    def set_outputs(self, refs):
        self.outputs = [r.id for r in refs]

    def stats(self):
        from collections import Counter

        return dict(Counter(self.ops))


def compute_extern_columns(tape, cols, hf):
    """Fill the extern_c output input-slots for a whole batch.

    ``cols``: per-slot value columns covering at least the main inputs;
    extended IN PLACE (and returned) until every slot in
    ``tape.n_inputs`` has a column.  For each recorded extern call (in
    execution order, so chained gates see earlier outputs), the gate's
    input nodes are evaluated host-side with reference semantics over
    the needed subgraph only, and the registered implementation
    (circom_tpu.register_extern) supplies the output columns — the
    TPU-native analog of linking an external C implementation
    (c_code_generator.rs:514-545).
    """
    from ..compiler.executor import EXTERN_IMPLS

    if not tape.extern_calls:
        return cols
    B = len(cols[0]) if cols else 0
    # slot columns may pre-exist as empty lists (the CLI sizes cols to
    # n_inputs): initialize every output slot to a zero column
    for call in tape.extern_calls:
        for slots in call["out_slots"].values():
            for s in slots:
                while len(cols) <= s:
                    cols.append([])
                if not cols[s]:
                    cols[s] = [0] * B
    memo = {}

    def eval_node(nid, b):
        hit = memo.get((nid, b))
        if hit is not None:
            return hit
        # iterative DFS (hint subgraphs can be deep)
        stack = [nid]
        while stack:
            i = stack[-1]
            if (i, b) in memo:
                stack.pop()
                continue
            op = tape.ops[i]
            if op == "const":
                memo[(i, b)] = tape.imms[i]
                stack.pop()
                continue
            if op == "input":
                memo[(i, b)] = cols[tape.imms[i]][b] % hf.p
                stack.pop()
                continue
            pend = [x for x in tape.args[i] if (x, b) not in memo]
            if pend:
                stack.extend(pend)
                continue
            a = [memo[(x, b)] for x in tape.args[i]]
            imm = tape.imms[i]
            memo[(i, b)] = _HOST_EVAL[op](hf, a, imm)
            stack.pop()
        return memo[(nid, b)]

    for call in tape.extern_calls:
        impl = EXTERN_IMPLS.get(call["template"])
        if impl is None:
            raise NotImplementedError(
                f"extern_c template '{call['template']}' was compiled "
                "with a registered implementation that is no longer "
                "available")
        for b in range(B):
            in_vals = {}
            for name, elems in call["inputs"].items():
                vals = [v if tag == "const" else eval_node(v, b)
                        for (tag, v) in elems]
                in_vals[name] = vals[0] if len(vals) == 1 else vals
            outs = impl(list(call["params"]), in_vals)
            for name, slots in call["out_slots"].items():
                v = outs.get(name)
                if v is None:
                    raise NotImplementedError(
                        f"extern_c implementation of '{call['template']}'"
                        f" did not produce output '{name}'")
                vals = v if isinstance(v, (list, tuple)) else [v]
                for s, x in zip(slots, vals):
                    cols[s][b] = int(x) % hf.p
    return cols


_HOST_EVAL = {
    "add": lambda hf, a, k: hf.add(a[0], a[1]),
    "sub": lambda hf, a, k: hf.sub(a[0], a[1]),
    "mul": lambda hf, a, k: hf.mul(a[0], a[1]),
    "div": lambda hf, a, k: hf.div(a[0], a[1]),
    "idiv": lambda hf, a, k: hf.idiv(a[0], a[1]),
    "mod": lambda hf, a, k: hf.mod(a[0], a[1]),
    "pow": lambda hf, a, k: hf.pow(a[0], a[1]),
    "pow_k": lambda hf, a, k: hf.pow(a[0], k),
    "shl": lambda hf, a, k: hf.shift_l(a[0], a[1]),
    "shr": lambda hf, a, k: hf.shift_r(a[0], a[1]),
    "shl_k": lambda hf, a, k: hf.shift_l(a[0], k),
    "shr_k": lambda hf, a, k: hf.shift_r(a[0], k),
    "lt": lambda hf, a, k: hf.lesser(a[0], a[1]),
    "le": lambda hf, a, k: hf.lesser_eq(a[0], a[1]),
    "gt": lambda hf, a, k: hf.greater(a[0], a[1]),
    "ge": lambda hf, a, k: hf.greater_eq(a[0], a[1]),
    "eq": lambda hf, a, k: hf.eq(a[0], a[1]),
    "neq": lambda hf, a, k: hf.not_eq(a[0], a[1]),
    "land": lambda hf, a, k: hf.bool_and(a[0], a[1]),
    "lor": lambda hf, a, k: hf.bool_or(a[0], a[1]),
    "lnot": lambda hf, a, k: hf.bool_not(a[0]),
    "band": lambda hf, a, k: hf.bit_and(a[0], a[1]),
    "bor": lambda hf, a, k: hf.bit_or(a[0], a[1]),
    "bxor": lambda hf, a, k: hf.bit_xor(a[0], a[1]),
    "bnot": lambda hf, a, k: hf.complement(a[0]),
    "neg": lambda hf, a, k: hf.neg(a[0]),
    "select": lambda hf, a, k: a[1] if a[0] else a[2],
}
