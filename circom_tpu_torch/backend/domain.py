"""Domain assignment for the witness tape: which nodes run in Montgomery
form and which in canonical form, with the conversions between them.

Copied from the JAX package's backend (the DomainTape class and its
domain constants) without the JAX imports: the planner and both
executors of the port work from this tape.
"""

from .tape import Tape

MONT = 0
NORM = 1

_NORM_OPS = {
    "lt", "le", "gt", "ge", "eq", "neq", "land", "lor", "lnot",
    "band", "bor", "bxor", "bnot", "shl_k", "shr_k", "shl", "shr",
    "idiv", "mod",
}
_MONT_OPS = {"mul", "div", "pow_k", "pow"}


class DomainTape:
    """Tape after domain assignment: ops + per-node domain + conversions.

    ``narrow``: source-node ids proven int32-representable by
    backend/ranges.py — they are pinned to the canonical (NORM) domain
    so no Montgomery conversions are inserted around them, and their
    muls are flagged plain (executed on the narrow int32 lane by the
    interpreter backend)."""

    def __init__(self, tape: Tape, narrow=None, plain_field=False,
                 node_rng=None):
        self.src = tape
        self.ops = []
        self.args = []
        self.imms = []
        self.domains = []
        self.narrow = []
        self.n_inputs = tape.n_inputs
        self.outputs = []
        self.plain_field = plain_field
        # carried source-tape intervals for NORM-domain nodes keyed by
        # THIS tape's node ids — lets the planner skip its duplicate
        # range analysis on mapped nodes (the tape-level analysis in
        # backend/ranges.py subsumes the plan-level rules for them)
        self.node_rng = {}
        self._src_rng = node_rng
        self._build(tape, narrow or frozenset())
        self._src_rng = None

    def _build(self, tape: Tape, narrow_src):
        n = len(tape.ops)
        dom = [None] * n
        plain = set()
        for i in range(n):
            op = tape.ops[i]
            if self.plain_field:
                # goldilocks-class fields run every value in canonical
                # form: products fold instead of Montgomery-reducing
                # (ops/limb_emit.gl_mul), so conversions never pay off.
                # div/pow keep Montgomery islands (inversion chains are
                # rare; every backend handles them uniformly).
                if op == "const":
                    dom[i] = None
                elif op in ("div", "pow_k", "pow"):
                    dom[i] = MONT
                else:
                    dom[i] = NORM
                    if op == "mul":
                        plain.add(i)
                continue
            if op == "const":
                dom[i] = None  # materialized per use
            elif op == "input":
                dom[i] = NORM
            elif i in narrow_src:
                dom[i] = NORM  # narrow values live in canonical form
            elif op == "mul" and any(
                    tape.ops[a] == "const" for a in tape.args[i]) and all(
                    tape.ops[a] == "const" or a in narrow_src
                    for a in tape.args[i]):
                # narrow-value * wide-constant (bit-lincomb tails, e.g.
                # sum(bit*2^k) in SHA adders): a single plain montmul
                # with the constant pre-scaled by R beats
                # to_mont + Montgomery mul, and keeps the consuming add
                # chain in canonical form.
                dom[i] = NORM
                plain.add(i)
            elif op in _MONT_OPS:
                dom[i] = MONT
            elif op in _NORM_OPS:
                dom[i] = NORM
            else:  # flexible (add/sub/neg/select): majority, default MONT
                ds = [dom[a] for a in tape.args[i]]
                known = [d for d in ds if d is not None]
                if not known:
                    dom[i] = MONT
                else:
                    dom[i] = MONT if known.count(MONT) * 2 >= len(known) \
                        else NORM
        new_id = {}

        def emit(op, args, imm, domain, is_narrow=False):
            nid = len(self.ops)
            self.ops.append(op)
            self.args.append(tuple(args))
            self.imms.append(imm)
            self.domains.append(domain)
            self.narrow.append(is_narrow)
            return nid

        def get_in(src_id, want):
            d = dom[src_id]
            op = tape.ops[src_id]
            if op == "const":
                w = want if want is not None else NORM
                key = (src_id, w)
                if key not in new_id:
                    new_id[key] = emit("const", (), tape.imms[src_id], w)
                return new_id[key]
            if want is None or d == want:
                return new_id[(src_id, d)]
            key = (src_id, want)
            if key not in new_id:
                conv = "to_mont" if want == MONT else "from_mont"
                new_id[key] = emit(conv, (new_id[(src_id, d)],), None, want)
            return new_id[key]

        for i in range(n):
            op = tape.ops[i]
            if op == "const":
                continue
            if op == "input":
                new_id[(i, NORM)] = emit("input", (), tape.imms[i], NORM)
                continue
            is_nrw = i in narrow_src
            is_plain = is_nrw or i in plain
            if op == "select":
                c, a, b = tape.args[i]
                d = dom[i]
                args = (get_in(c, None), get_in(a, d), get_in(b, d))
            elif op in _MONT_OPS and not is_plain:
                args = tuple(get_in(a, MONT) for a in tape.args[i])
            elif op in _NORM_OPS or is_plain:
                args = tuple(get_in(a, NORM) for a in tape.args[i])
            else:
                d = dom[i]
                args = tuple(get_in(a, d) for a in tape.args[i])
            op_out = "mulp" if (op == "mul" and is_plain) else op
            nid = emit(op_out, args, tape.imms[i], dom[i], is_nrw)
            new_id[(i, dom[i])] = nid
            if dom[i] == NORM and self._src_rng is not None:
                # identity-mapped NORM node: its raw value IS the
                # logical value, so the tape-level interval (possibly
                # None = proven nothing) transfers verbatim; MONT
                # nodes and inserted conversions are NOT seeded so the
                # planner's view of them is unchanged
                self.node_rng[nid] = self._src_rng[i]

        for out in tape.outputs:
            self.outputs.append(get_in(out, NORM))
