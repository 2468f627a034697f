"""Constraint algebra: arithmetic expressions over signals, R1CS constraints,
and substitutions.

Python counterpart of the reference's circom_algebra/src/algebra.rs:
`ArithmeticExpression` closed under the circom operator set with degree
tracking (Number/Signal/Linear/Quadratic/NonQuadratic, algebra.rs:9-33),
`Constraint` A*B-C=0 (algebra.rs:1022-1230) and `Substitution`
(algebra.rs:835-1000).

Signals are identified by opaque hashable keys (the executor uses local
signal ids); the constant term lives under key ``CONST`` like the
reference's use of signal 0 as the constant wire.
"""

from ..field.hostfield import FieldArithmeticError, HostField

CONST = 0  # constant-wire key; real signals use ids >= 1


class NonQuadratic:
    """Marker for expressions beyond degree 2 (algebra.rs NonQuadratic)."""
    __slots__ = ()
    _inst = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self):
        return "NonQuadratic"


NQ = NonQuadratic()


class AExpr:
    """Arithmetic expression: dict-based linear/quadratic forms.

    kind: 'number' | 'signal' | 'linear' | 'quadratic'
    - number: c
    - signal: id
    - linear: coeffs {sig|CONST: coef}
    - quadratic: (a, b, c) dicts — value = (a·s)(b·s) + c·s
    NonQuadratic is represented by the NQ sentinel, not an AExpr.
    """

    __slots__ = ("kind", "c", "sig", "coeffs", "a", "b")

    def __init__(self, kind, c=0, sig=None, coeffs=None, a=None, b=None):
        self.kind = kind
        self.c = c
        self.sig = sig
        self.coeffs = coeffs
        self.a = a
        self.b = b

    # constructors ------------------------------------------------------
    @staticmethod
    def number(v):
        return AExpr("number", c=v)

    @staticmethod
    def signal(s):
        return AExpr("signal", sig=s)

    @staticmethod
    def linear(coeffs):
        return AExpr("linear", coeffs=coeffs)

    @staticmethod
    def quadratic(a, b, c):
        return AExpr("quadratic", a=a, b=b, c=c)

    def __repr__(self):
        if self.kind == "number":
            return f"#{self.c}"
        if self.kind == "signal":
            return f"s{self.sig}"
        if self.kind == "linear":
            return f"lin{self.coeffs}"
        return f"quad({self.a},{self.b},{self.c})"

    # predicates --------------------------------------------------------
    def is_number(self):
        return self.kind == "number"

    def value(self):
        assert self.kind == "number"
        return self.c

    def to_coeffs(self):
        """As a linear coefficient dict; only for degree <= 1."""
        if self.kind == "number":
            return {CONST: self.c}
        if self.kind == "signal":
            return {self.sig: 1}
        if self.kind == "linear":
            return dict(self.coeffs)
        raise ValueError("not linear")

    def signals(self):
        if self.kind == "signal":
            return {self.sig}
        if self.kind == "linear":
            return {k for k in self.coeffs if k != CONST}
        if self.kind == "quadratic":
            out = set()
            for d in (self.a, self.b, self.c):
                out |= {k for k in d if k != CONST}
            return out
        return set()


def _add_into(dst, src, hf: HostField):
    for k, v in src.items():
        nv = hf.add(dst.get(k, 0), v)
        if nv == 0:
            dst.pop(k, None)
        else:
            dst[k] = nv


def _scale(coeffs, k, hf: HostField):
    if k == 0:
        return {}
    return {s: hf.mul(v, k) for s, v in coeffs.items()}


def _norm(e):
    """Collapse degenerate dict forms to number/signal."""
    if isinstance(e, NonQuadratic):
        return e
    if e.kind == "linear":
        cs = e.coeffs
        if not cs:
            return AExpr.number(0)
        if len(cs) == 1:
            ((k, v),) = cs.items()
            if k == CONST:
                return AExpr.number(v)
            if v == 1:
                return AExpr.signal(k)
        return e
    if e.kind == "quadratic":
        if not e.a or not e.b:
            return _norm(AExpr.linear(dict(e.c)))
    return e


def add(l, r, hf: HostField):
    """algebra.rs:247-348 — quadratic+quadratic is non-quadratic."""
    if isinstance(l, NonQuadratic) or isinstance(r, NonQuadratic):
        return NQ
    if l.kind == "number" and r.kind == "number":
        return AExpr.number(hf.add(l.c, r.c))
    if l.kind == "quadratic" and r.kind == "quadratic":
        return NQ
    if l.kind == "quadratic" or r.kind == "quadratic":
        q, o = (l, r) if l.kind == "quadratic" else (r, l)
        c = dict(q.c)
        _add_into(c, o.to_coeffs(), hf)
        return _norm(AExpr.quadratic(dict(q.a), dict(q.b), c))
    coeffs = l.to_coeffs()
    _add_into(coeffs, r.to_coeffs(), hf)
    return _norm(AExpr.linear(coeffs))


def mul(l, r, hf: HostField):
    """algebra.rs:349-447 — quadratic*non-constant => NonQuadratic."""
    if isinstance(l, NonQuadratic) or isinstance(r, NonQuadratic):
        return NQ
    if l.kind == "number" and r.kind == "number":
        return AExpr.number(hf.mul(l.c, r.c))
    if l.kind == "number" or r.kind == "number":
        k, o = (l.c, r) if l.kind == "number" else (r.c, l)
        if o.kind == "quadratic":
            if k == 0:
                return AExpr.number(0)
            return _norm(
                AExpr.quadratic(
                    _scale(o.a, k, hf), dict(o.b), _scale(o.c, k, hf)
                )
            )
        return _norm(AExpr.linear(_scale(o.to_coeffs(), k, hf)))
    if l.kind == "quadratic" or r.kind == "quadratic":
        return NQ
    # linear * linear -> quadratic
    return _norm(AExpr.quadratic(l.to_coeffs(), r.to_coeffs(), {}))


def neg(e, hf: HostField):
    return mul(AExpr.number(hf.p - 1), e, hf)


def sub(l, r, hf: HostField):
    return add(l, neg(r, hf), hf)


class Constraint:
    """A*B - C = 0 over signal->coef dicts (algebra.rs:1022-1047)."""

    __slots__ = ("a", "b", "c")

    def __init__(self, a, b, c):
        self.a = a
        self.b = b
        self.c = c

    @staticmethod
    def from_aexpr(e, hf: HostField):
        """transform_expression_to_constraint_form (algebra.rs:113-138):
        expression e == 0 becomes A*B - C = 0."""
        if isinstance(e, NonQuadratic):
            return None
        if e.kind == "quadratic":
            return Constraint(
                dict(e.a), dict(e.b), _scale(e.c, hf.p - 1, hf)
            ).fixed(hf)
        return Constraint({}, {}, _scale(e.to_coeffs(), hf.p - 1, hf)).fixed(hf)

    def fixed(self, hf: HostField):
        """fix_constraint (algebra.rs:1155-1179): constant*B folds into C,
        empty sides normalize, remove zero coefs."""
        a, b, c = self.a, self.b, self.c
        for d in (a, b, c):
            for k in [k for k, v in d.items() if v == 0]:
                del d[k]
        if not a or not b:
            # A or B empty: product is 0
            a, b = {}, {}
        elif set(a) == {CONST} or set(b) == {CONST}:
            k_side, other = (a, b) if set(a) == {CONST} else (b, a)
            k = k_side[CONST]
            prod = _scale(other, k, hf)
            nc = _scale(prod, hf.p - 1, hf)
            _add_into(nc, c, hf)
            # keep as pure linear constraint in C
            a, b, c = {}, {}, nc
        self.a, self.b, self.c = a, b, c
        return self

    def is_empty(self):
        return not self.a and not self.b and not self.c

    def is_linear(self):
        return not self.a and not self.b

    def is_equality(self, hf: HostField):
        """C = s1 - s2 form (algebra.rs:1052-1076)."""
        if not self.is_linear() or len(self.c) != 2:
            return False
        (k1, v1), (k2, v2) = self.c.items()
        return k1 != CONST and k2 != CONST and hf.add(v1, v2) == 0

    def is_constant_equality(self):
        """signal_equals_constant (algebra.rs:1362-1372): k*s + c = 0 or
        k*s = 0."""
        if not self.is_linear():
            return False
        if CONST in self.c:
            return len(self.c) == 2
        return len(self.c) == 1

    def signals(self):
        out = set()
        for d in (self.a, self.b, self.c):
            out |= {k for k in d if k != CONST}
        return out

    def remap(self, mapping):
        """Renumber signals (apply_offset/apply_witness analog,
        algebra.rs:1217-1230)."""

        def m(d):
            return {
                (CONST if k == CONST else mapping[k]): v for k, v in d.items()
            }

        return Constraint(m(self.a), m(self.b), m(self.c))

    def apply_substitution(self, subst, hf: HostField):
        """Replace subst.signal by subst.expr in all three LCs
        (algebra.rs:1138-1154)."""
        for d in (self.a, self.b, self.c):
            if subst.signal in d:
                k = d.pop(subst.signal)
                _add_into(d, _scale(subst.coeffs, k, hf), hf)
        self.fixed(hf)
        return self

    def __repr__(self):
        return f"Constraint(A={self.a}, B={self.b}, C={self.c})"


class Substitution:
    """signal := linear expression (algebra.rs:835-1000)."""

    __slots__ = ("signal", "coeffs")

    def __init__(self, signal, coeffs):
        assert signal != CONST
        self.signal = signal
        self.coeffs = coeffs

    @staticmethod
    def from_constraint(constraint, signal, hf: HostField):
        """Solve a linear constraint for `signal`
        (algebra.rs clear_signal_from_linear)."""
        assert constraint.is_linear() and signal in constraint.c
        coef = constraint.c[signal]
        inv_neg = hf.neg(hf.inv(coef))
        coeffs = {
            k: hf.mul(v, inv_neg)
            for k, v in constraint.c.items()
            if k != signal
        }
        return Substitution(signal, coeffs)

    def apply_to_subst(self, other, hf: HostField):
        """Substitute self into other's rhs."""
        if self.signal in other.coeffs:
            k = other.coeffs.pop(self.signal)
            _add_into(other.coeffs, _scale(self.coeffs, k, hf), hf)

    def signals(self):
        return {k for k in self.coeffs if k != CONST}

    def __repr__(self):
        return f"{self.signal} := {self.coeffs}"
