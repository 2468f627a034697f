"""Static unknown/known dataflow analysis.

Clean-room implementation of the reference's compile-time known/unknown
pass (type_analysis/src/analyzers/unknown_known_analysis.rs): a 2-point
lattice Known < Unknown flows through each template/bus body, and
constructs that must be resolvable during the constraint-generation
phase are rejected when they can depend on signal values:

* array dimensions                          -> T20460 UnknownDimension
* component instantiations / their indices  -> T20461 UnknownTemplate
* signal stores through an unknown index
  into a component array                    -> T2O461-A (sic, reference
                                               error_code.rs:233)
* bus parameters                            -> T20467 UnknownBus
* tag value assignments                     -> T2062  NonValidTagAssignment
* `===`/`<==` with an unknown array index   -> T20462 NonQuadratic
* constraints under an unknown condition    -> T2005  UnreachableConstraints
* tag assignments under unknown condition   -> T2049  UnreachableTags
* signal/bus/component declarations under
  an unknown condition                      -> T2050  UnreachableSignals

Semantics mirrored from the reference:

* signals/buses read as Unknown; tag reads (signal.tag) as Known;
  component reads as Unknown; template parameters as Known arrays.
* array variables read as Known (per-element tracking is left to the
  executor, unknown_known_analysis.rs:30-37) but once an array's state
  becomes Unknown it stays Unknown.
* if/else merges environments with max(); while iterates to fixpoint
  (check_modified); when the condition is Unknown every variable
  modified inside turns Unknown.
"""

from ..frontend import ast as A
from ..utils.reports import Report, ReportCollection

KNOWN, UNKNOWN = 0, 1

_MSG = {
    "T20460": "The length of every array must be known during the "
              "constraint generation phase",
    "T20461": "Every component instantiation must be resolved during the "
              "constraint generation phase. This component declaration "
              "uses a value that can be unknown during the constraint "
              "generation phase.",
    "T2O461-A": "Assigments to signals within an unknown access to an "
                "array of components are not allowed",
    "T20467": "Parameters of a bus must be known during the constraint "
              "generation phase",
    "T2062": "Tags cannot be assigned to values that can be unknown "
             "during the constraint generation phase",
    "T20462": "Non-quadratic constraint was detected statically, using "
              "unknown index will cause the constraint to be "
              "non-quadratic",
    "T2005": "There are constraints depending on the value of the "
             "condition and it can be unknown during the constraint "
             "generation phase",
    "T2049": "There are tag assignments depending on the value of the "
             "condition and it can be unknown during the constraint "
             "generation phase",
    "T2050": "There are signal, bus or component declarations depending "
             "on the value of the condition and it can be unknown during "
             "the constraint generation phase",
}


class _Env:
    """vars: layered scopes of name -> [tag, is_array];
    signals: name -> bus type name or None; components: set of names."""

    def __init__(self):
        self.var_scopes = [{}]
        self.signals = {}
        self.components = set()

    def add_var(self, name, tag, is_array):
        self.var_scopes[-1][name] = [tag, is_array]

    def find_var(self, name):
        for sc in reversed(self.var_scopes):
            if name in sc:
                return sc[name]
        return None

    def push(self):
        self.var_scopes.append({})

    def pop(self):
        self.var_scopes.pop()

    def copy(self):
        e = _Env.__new__(_Env)
        e.var_scopes = [dict((k, list(v)) for k, v in sc.items())
                        for sc in self.var_scopes]
        e.signals = self.signals  # declaration sets are append-only
        e.components = self.components
        return e

    def merge_from(self, other):
        """Pointwise max over the variable lattice (branch join)."""
        for sc, so in zip(self.var_scopes, other.var_scopes):
            for k, v in sc.items():
                o = so.get(k)
                if o is not None and o[0] > v[0]:
                    v[0] = o[0]


class UnknownKnownAnalysis:
    """Run over every template and bus (check_types.rs:57-71 order)."""

    def __init__(self, archive):
        self.archive = archive
        self.reports = ReportCollection()
        self._bus_fields_memo = {}

    def error(self, code, meta):
        r = Report.error(_MSG[code], code)
        if meta is not None:
            r.add_primary(meta.file_id, meta.start, meta.end)
        self.reports.add(r)

    def run(self):
        # only definitions reachable from main: the reference prunes
        # unreached templates before the semantic analyses
        # (check_types.rs:57-71), so dead definitions never error
        from .reach import reachable_definitions

        reached = reachable_definitions(self.archive)
        for name, t in self.archive.templates.items():
            if name in reached:
                self._run_body(t.args, t.body)
        for name, b in self.archive.buses.items():
            if name in reached:
                self._run_body(b.args, b.body)
        return self.reports

    def _run_body(self, args, body):
        env = _Env()
        for arg in args:
            # most restrictive option: treat parameters as arrays
            env.add_var(arg, KNOWN, True)
        self._analyze(body, env)

    # -- helpers -----------------------------------------------------------
    def _bus_fields(self, bus_name):
        memo = self._bus_fields_memo.get(bus_name)
        if memo is not None:
            return memo
        fields = {}
        bus = self.archive.buses.get(bus_name)
        if bus is not None:
            def collect(s):
                if isinstance(s, A.Declaration):
                    if s.xtype.kind == "bus":
                        fields[s.name] = s.xtype.bus_name
                    elif s.xtype.kind == "signal":
                        fields[s.name] = None
                elif isinstance(s, (A.Block,)):
                    for st in s.stmts:
                        collect(st)
                elif isinstance(s, A.InitializationBlock):
                    for st in s.initializations:
                        collect(st)
            collect(bus.body)
        self._bus_fields_memo[bus_name] = fields
        return fields

    def _is_tag_access(self, base_bus, access):
        """True when the ComponentAccess chain ends at a tag (not a bus
        field).  Plain signals have no fields, so any member is a tag."""
        bus = base_bus
        for acc in access:
            if not isinstance(acc, A.ComponentAccess):
                continue
            if bus is None:
                return True
            fields = self._bus_fields(bus)
            if acc.name not in fields:
                return True
            bus = fields[acc.name]
        return False

    # -- expression lattice -------------------------------------------------
    def _tag(self, e, env):
        if isinstance(e, A.Number):
            return KNOWN
        if isinstance(e, A.Variable):
            v = env.find_var(e.name)
            if v is not None:
                return KNOWN if v[1] else v[0]
            if e.name in env.components:
                # component signal/tag read through the component
                return UNKNOWN
            if e.name in env.signals:
                if self._is_tag_access(env.signals[e.name], e.access):
                    return KNOWN  # tag values are compile-time data
                return UNKNOWN
            return KNOWN  # unresolved: symbol analysis reports it
        if isinstance(e, (A.ArrayInLine, A.Call, A.BusCall)):
            vals = e.values if isinstance(e, A.ArrayInLine) else e.args
            for v in vals:
                if self._tag(v, env) == UNKNOWN:
                    return UNKNOWN
            return KNOWN
        if isinstance(e, A.UniformArray):
            return max(self._tag(e.value, env), self._tag(e.dimension, env))
        if isinstance(e, A.TernarySwitch):
            return max(self._tag(e.cond, env), self._tag(e.if_true, env),
                       self._tag(e.if_false, env))
        if isinstance(e, A.Infix):
            return max(self._tag(e.lhe, env), self._tag(e.rhe, env))
        if isinstance(e, (A.Prefix, A.ParallelOp)):
            return self._tag(e.rhe, env)
        if isinstance(e, A.TupleExpr):
            for v in e.values:
                if self._tag(v, env) == UNKNOWN:
                    return UNKNOWN
            return KNOWN
        return KNOWN

    def _access_tag(self, access, env):
        for acc in access:
            if isinstance(acc, A.ArrayAccess):
                if self._tag(acc.expr, env) == UNKNOWN:
                    return UNKNOWN
        return KNOWN

    def _unknown_index(self, e, env):
        """Early static non-quadratic detection: an unknown array index
        anywhere inside a constrained expression."""
        if isinstance(e, A.Number):
            return False
        if isinstance(e, A.Variable):
            return self._access_tag(e.access, env) == UNKNOWN
        if isinstance(e, A.Infix):
            return (self._unknown_index(e.lhe, env)
                    or self._unknown_index(e.rhe, env))
        if isinstance(e, (A.Prefix, A.ParallelOp)):
            return self._unknown_index(e.rhe, env)
        if isinstance(e, A.TernarySwitch):
            return (self._unknown_index(e.cond, env)
                    or self._unknown_index(e.if_true, env)
                    or self._unknown_index(e.if_false, env))
        if isinstance(e, (A.Call, A.BusCall)):
            return any(self._unknown_index(x, env) for x in e.args)
        if isinstance(e, (A.ArrayInLine, A.TupleExpr)):
            return any(self._unknown_index(x, env) for x in e.values)
        if isinstance(e, A.UniformArray):
            return (self._unknown_index(e.value, env)
                    or self._unknown_index(e.dimension, env))
        return False

    # -- statements ----------------------------------------------------------
    def _analyze(self, s, env):
        """Returns (constraints_declared, tags_modified, signals_declared,
        modified_vars) and mutates env/reports."""
        if isinstance(s, A.Block):
            env.push()
            out = self._iterate(s.stmts, env)
            env.pop()
            return out
        if isinstance(s, A.InitializationBlock):
            return self._iterate(s.initializations, env)
        if isinstance(s, A.Declaration):
            kind = s.xtype.kind
            # dimension check covers EVERY non-anonymous declaration,
            # vars included (unknown_known_analysis.rs:136-150)
            if kind != "anonymous_component":
                for dim in s.dimensions:
                    if self._tag(dim, env) == UNKNOWN:
                        self.error("T20460", dim.meta)
            if kind == "var":
                env.add_var(s.name, KNOWN, len(s.dimensions) > 0)
                return (False, False, False, {s.name})
            if kind == "bus":
                env.signals[s.name] = s.xtype.bus_name
            elif kind == "signal":
                env.signals[s.name] = None
            else:  # component / anonymous_component
                env.components.add(s.name)
            return (False, False, True, set())
        if isinstance(s, A.Substitution):
            return self._substitution(s, env)
        if isinstance(s, A.UnderscoreSubstitution):
            if s.op == A.AssignOp.CONSTRAINT:
                if self._unknown_index(s.rhe, env):
                    self.error("T20462", s.rhe.meta)
                return (True, False, False, set())
            return (False, False, False, set())
        if isinstance(s, A.ConstraintEquality):
            if self._unknown_index(s.lhe, env):
                self.error("T20462", s.lhe.meta)
            if self._unknown_index(s.rhe, env):
                self.error("T20462", s.rhe.meta)
            return (True, False, False, set())
        if isinstance(s, A.IfThenElse):
            cond_tag = self._tag(s.cond, env)
            else_env = env.copy()
            c1, t1, g1, m1 = self._analyze(s.if_case, env)
            if s.else_case is not None:
                c2, t2, g2, m2 = self._analyze(s.else_case, else_env)
            else:
                c2, t2, g2, m2 = False, False, False, set()
            env.merge_from(else_env)
            cons, tags, sigs = c1 or c2, t1 or t2, g1 or g2
            modified = m1 | m2
            if cond_tag == UNKNOWN:
                for var in modified:
                    v = env.find_var(var)
                    if v is not None:
                        v[0] = UNKNOWN
                if cons:
                    self.error("T2005", s.cond.meta)
                if tags:
                    self.error("T2049", s.cond.meta)
                if sigs:
                    self.error("T2050", s.cond.meta)
            return (cons, tags, sigs, modified)
        if isinstance(s, A.While):
            # fixpoint: iterate while the loop body turns more variables
            # Unknown (check_modified, unknown_known_analysis.rs:447-466);
            # only the FINAL iteration's reports are kept — earlier
            # iterations re-analyze the same body and would duplicate
            # every error once per iteration
            while True:
                n_reports = len(self.reports.reports)
                before = env.copy()
                cons, tags, sigs, modified = self._analyze(s.stmt, env)
                changed = False
                for var in modified:
                    b = before.find_var(var)
                    f = env.find_var(var)
                    if b is not None and f is not None and b[0] != f[0]:
                        if f[0] == UNKNOWN:
                            changed = True
                        f[0] = max(b[0], f[0])
                if not changed:
                    break
                del self.reports.reports[n_reports:]
            cond_tag = self._tag(s.cond, env)
            if cond_tag == UNKNOWN:
                for var in modified:
                    v = env.find_var(var)
                    if v is not None:
                        v[0] = UNKNOWN
                if cons:
                    self.error("T2005", s.cond.meta)
                if tags:
                    self.error("T2049", s.cond.meta)
                if sigs:
                    self.error("T2050", s.cond.meta)
            return (cons, tags, sigs, modified)
        return (False, False, False, set())

    def _iterate(self, stmts, env):
        cons = tags = sigs = False
        modified = set()
        for st in stmts:
            c, t, g, m = self._analyze(st, env)
            cons, tags, sigs = cons or c, tags or t, sigs or g
            modified |= m
        return (cons, tags, sigs, modified)

    def _substitution(self, s, env):
        expr_tag = self._tag(s.rhe, env)
        access_tag = self._access_tag(s.access, env)
        has_comp_access = any(isinstance(a, A.ComponentAccess)
                              for a in s.access)
        v = env.find_var(s.var)
        if v is not None:
            # scalar vars always update; Unknown arrays stay Unknown
            if not v[1] or v[0] == KNOWN:
                v[0] = max(expr_tag, access_tag)
            return (False, False, False, {s.var})
        if s.var in env.components and not has_comp_access:
            # component instantiation
            if expr_tag == UNKNOWN:
                self.error("T20461", s.rhe.meta)
            if access_tag == UNKNOWN:
                self.error("T20461", s.meta)
            return (True, False, False, set())
        if s.var in env.signals and has_comp_access and \
                self._is_tag_access(env.signals[s.var], s.access):
            # tag value assignment
            if expr_tag == UNKNOWN:
                self.error("T2062", s.rhe.meta)
            if access_tag == UNKNOWN:
                self.error("T2062", s.meta)
            return (False, True, False, set())
        if s.var in env.signals and not has_comp_access \
                and env.signals[s.var] is not None:
            # whole-bus assignment
            cons = False
            if s.op == A.AssignOp.VAR and expr_tag == UNKNOWN:
                self.error("T20467", s.meta)
            if s.op == A.AssignOp.CONSTRAINT:
                cons = True
                if self._unknown_index(s.rhe, env):
                    self.error("T20462", s.rhe.meta)
                if access_tag == UNKNOWN:
                    self.error("T20462", s.meta)
            return (cons, False, False, set())
        # signal assignment (possibly through a component/bus field)
        cons = False
        if s.op == A.AssignOp.CONSTRAINT:
            cons = True
            if self._unknown_index(s.rhe, env):
                self.error("T20462", s.rhe.meta)
            if access_tag == UNKNOWN:
                self.error("T20462", s.meta)
        elif s.var in env.components:
            if access_tag == UNKNOWN:
                self.error("T2O461-A", s.meta)
        return (cons, False, False, set())


def unknown_known_analysis(archive):
    """Returns the ReportCollection (raises nothing); callers decide."""
    a = UnknownKnownAnalysis(archive)
    a.run()
    return a.reports
