"""Static dimension/type analysis over every reachable definition.

The reference runs a full type check over all template/function/bus
bodies — executed or not — before execution, batch-reporting every
error (type_analysis/src/analyzers/type_check.rs:83-1564).  This pass
mirrors its FoldedType discipline on dimension COUNTS (sizes are often
parameter-dependent and stay dynamic; counts are static):

  type := ('a', d)        arithmetic value with d array dimensions
        | ('t', name)     template instantiation
        | ('b', name, d)  bus (array of) instance
        | None            unknown (parameters, uninferable) — wildcard

Checks and reference codes (error_code.rs):
  T2044 MustBeSingleArithmetic  — operator operand / index / condition /
                                  array size / log / assert with dims>0
  T2028 InfixOperatorWithWrongTypes — template/bus operand in arithmetic
  T2032 InvalidArrayAccess      — more array accesses than dimensions
  T2019 NonCompatibleBranchTypes — ?: branches with different dims
  T2017 NonHomogeneousArray     — inline array with mixed element dims
  T2061 WrongTypesInAssignOperationDims — lhs/rhs dimension mismatch
  T2057 WrongTypesInAssignOperationTemplate — template value into a
                                  non-component lhs
  T2013 FunctionInconsistentTyping — returns with different dim counts
  T2046 MustBeSameDimension     — === sides with different dims
  T2051 MainComponentWithTags   — main's template has tagged inputs

Everything uncertain types to None and is skipped — no false positives
from parameter-dependent code.  Tag ACCESS legality stays with the tag
analysis; the executor keeps its dynamic checks as a second line.
"""

from ..frontend import ast as A
from ..utils.reports import Report, ReportCollection
from .reach import reachable_definitions

_MSG = {
    "T2004": "Unable to infer the type of this function",
    "T2044": "must be a single arithmetic expression",
    "T2025": "types can't be used as conditions",
    "T2027": "prefix operator with wrong types",
    "T2028": "infix operator with wrong types",
    "T2032": "array access does not match the dimensions of the expression",
    "T2019": "non compatible types in the branches of the expression",
    "T2017": "non homogeneous array",
    "T2061": "assignee and assigned types do not match",
    "T2057": "part of a component cannot be used as an assignee",
    "T2013": "function returns different types depending on the branch",
    "T2046": "operands must have the same dimension",
    "T2051": "the main component cannot have inputs with tags",
    # undeclared tag on a signal or (bus-)field, in BOTH the direct-
    # signal and through-component shapes: the reference constructs
    # only InvalidTagAccess here (type_check.rs:1145-1151, :1330;
    # InvalidSignalTagAccess T2047 / InvalidSignalAccessInBus BU04 are
    # mapped in error_code.rs but never built by type_check)
    "T2048": "Tag not found in signal: only accesses to tags that "
             "appear in the definition of the signal are allowed",
    "T2048-A": "the tags of an output signal cannot be modified "
               "outside its template",
    "T2048-B": "the tags of an input signal cannot be modified outside "
               "its template",
    "T2048-C": "the tags of an input signal cannot be accessed outside "
               "its template",
}


def _arith(d=0):
    return ("a", d)


class _Scope:
    def __init__(self, parent=None):
        self.names = {}
        self.parent = parent

    def find(self, name):
        s = self
        while s is not None:
            if name in s.names:
                return s.names[name]
            s = s.parent
        return None

    def declare(self, name, ty):
        self.names[name] = ty

    def assign_component(self, name, tmpl):
        """Record an inferred template name for a component symbol
        (component_type_inference.rs analog)."""
        s = self
        while s is not None:
            if name in s.names:
                kind, info = s.names[name]
                if kind == "component" and info.get("tmpl") is None:
                    info["tmpl"] = tmpl
                return
            s = s.parent


class TypeCheck:
    def __init__(self, archive):
        self.archive = archive
        self.reports = ReportCollection()
        self._fn_dims = {}      # function -> return dim count | None
        self._fn_busy = set()
        # functions whose return type is uninferable BECAUSE inference
        # hit unresolvable (mutual) recursion — the precise condition
        # under which the reference's type_given_function returns None
        # and the call site reports UnableToTypeFunction T2004
        # (type_check.rs:1441-1449)
        self._fn_rec = set()
        self._rec_hits = 0
        self._tmpl_io = {}      # template -> {signal: (dims, bus|None)}

    # -- reporting -------------------------------------------------------
    def error(self, code, meta):
        r = Report.error(_MSG[code], code)
        if meta is not None:
            r.add_primary(meta.file_id, meta.start, meta.end)
        self.reports.add(r)

    # -- entry -----------------------------------------------------------
    def run(self):
        reached = reachable_definitions(self.archive)
        for name, t in self.archive.templates.items():
            if name in reached:
                self._check_body(t.args, t.body, in_function=False)
        for name, f in self.archive.functions.items():
            if name in reached:
                self._check_function(name)
        for name, b in self.archive.buses.items():
            if name in reached:
                self._check_body(b.args, b.body, in_function=False)
        self._check_main()
        return self.reports

    def _check_main(self):
        call = self.archive.main.call
        if isinstance(call, A.Call):
            tmpl = self.archive.templates.get(call.id)
            if tmpl is not None and self._template_has_tagged_inputs(tmpl):
                self.error("T2051", call.meta)

    def _template_has_tagged_inputs(self, tmpl):
        found = [False]

        def scan(s):
            if isinstance(s, A.Declaration) \
                    and s.xtype.kind in ("signal", "bus") \
                    and s.xtype.signal_type == A.SignalType.INPUT \
                    and s.xtype.tags:
                found[0] = True
            elif isinstance(s, A.Block):
                for st in s.stmts:
                    scan(st)
            elif isinstance(s, A.InitializationBlock):
                for st in s.initializations:
                    scan(st)

        scan(tmpl.body)
        return found[0]

    # -- io table for component access ------------------------------------
    def _template_io(self, name):
        hit = self._tmpl_io.get(name)
        if hit is not None:
            return hit
        tmpl = self.archive.templates.get(name)
        io = {}
        if tmpl is not None:
            def scan(s):
                if isinstance(s, A.Declaration) \
                        and s.xtype.kind in ("signal", "bus"):
                    io[s.name] = (len(s.dimensions),
                                  s.xtype.bus_name or None,
                                  set(s.xtype.tags or ()),
                                  s.xtype.signal_type)
                elif isinstance(s, A.Block):
                    for st in s.stmts:
                        scan(st)
                elif isinstance(s, A.InitializationBlock):
                    for st in s.initializations:
                        scan(st)

            scan(tmpl.body)
        self._tmpl_io[name] = io
        return io

    def _bus_field(self, bus_name, field):
        """(dims, inner bus name | None, declared tags) of a bus
        field, or None if the bus declares no such field."""
        bus = self.archive.buses.get(bus_name)
        if bus is None:
            return None
        def scan(s):
            if isinstance(s, A.Declaration) and s.name == field:
                return (len(s.dimensions), s.xtype.bus_name or None,
                        set(s.xtype.tags or ()))
            if isinstance(s, A.Block):
                for st in s.stmts:
                    r = scan(st)
                    if r:
                        return r
            if isinstance(s, A.InitializationBlock):
                for st in s.initializations:
                    r = scan(st)
                    if r:
                        return r
            return None
        return scan(bus.body)

    # -- function return dims ---------------------------------------------
    def _function_dims(self, name):
        """Return dim count of a function, None if uninferable
        (type_given_function.rs analog, on counts only)."""
        if name in self._fn_dims:
            return self._fn_dims[name]
        if name in self._fn_busy:
            self._rec_hits += 1
            return None  # recursion
        f = self.archive.functions.get(name)
        if f is None:
            return None
        self._fn_busy.add(name)
        dims = []
        scope = _Scope()
        for a in f.args:
            scope.declare(a, None)

        def walk(s, sc):
            if isinstance(s, A.Return):
                t = self._type_expr(s.value, sc, quiet=True)
                dims.append(t[1] if t is not None and t[0] == "a"
                            else None)
            elif isinstance(s, A.Block):
                sc2 = _Scope(sc)
                for st in s.stmts:
                    walk(st, sc2)
            elif isinstance(s, A.InitializationBlock):
                for st in s.initializations:
                    walk(st, sc)
            elif isinstance(s, A.Declaration):
                sc.declare(s.name, ("var", {"dims": len(s.dimensions)}))
            elif isinstance(s, A.IfThenElse):
                walk(s.if_case, sc)
                if s.else_case is not None:
                    walk(s.else_case, sc)
            elif isinstance(s, A.While):
                walk(s.stmt, sc)

        rec_before = self._rec_hits
        walk(f.body, scope)
        self._fn_busy.discard(name)
        out = None
        known = [d for d in dims if d is not None]
        if known and all(d == known[0] for d in known):
            out = known[0]
        if out is None and self._rec_hits > rec_before:
            self._fn_rec.add(name)
        self._fn_dims[name] = out
        return out

    def _check_function(self, name):
        f = self.archive.functions[name]
        scope = _Scope()
        for a in f.args:
            scope.declare(a, None)
        rets = []
        self._check_stmt(f.body, scope, in_function=True, rets=rets)
        known = [d for d in rets if d is not None]
        if known and any(d != known[0] for d in known):
            self.error("T2013", f.meta)

    def _check_body(self, args, body, in_function):
        scope = _Scope()
        for a in args:
            scope.declare(a, None)
        self._check_stmt(body, scope, in_function=in_function, rets=[])

    # -- expression typing --------------------------------------------------
    def _type_expr(self, e, scope, quiet=False):
        """Returns a type or None; reports unless quiet."""
        def rep(code, meta):
            if not quiet:
                self.error(code, meta)

        if isinstance(e, A.Number):
            return _arith(0)
        if isinstance(e, A.Variable):
            return self._type_variable(e, scope, rep)
        if isinstance(e, (A.Infix, A.Prefix)):
            operands = [e.lhe, e.rhe] if isinstance(e, A.Infix) else [e.rhe]
            opc = "T2028" if isinstance(e, A.Infix) else "T2027"
            for x in operands:
                t = self._type_expr(x, scope, quiet)
                if t is None:
                    continue
                if t[0] != "a":
                    rep(opc, e.meta)
                elif t[1] != 0:
                    rep(opc, x.meta if hasattr(x, "meta") else e.meta)
            return _arith(0)
        if isinstance(e, A.TernarySwitch):
            tc = self._type_expr(e.cond, scope, quiet)
            if tc is not None and (tc[0] != "a" or tc[1] != 0):
                rep("T2025", e.cond.meta)
            t1 = self._type_expr(e.if_true, scope, quiet)
            t2 = self._type_expr(e.if_false, scope, quiet)
            if t1 is not None and t2 is not None and t1[0] == "a" \
                    and t2[0] == "a" and t1[1] != t2[1]:
                rep("T2019", e.meta)
            return t1 if t1 is not None else t2
        if isinstance(e, A.ParallelOp):
            return self._type_expr(e.rhe, scope, quiet)
        if isinstance(e, A.Call):
            for a in e.args:
                t = self._type_expr(a, scope, quiet)
                # args may be arrays (both functions and templates)
            if e.id in self.archive.templates:
                return ("t", e.id)
            if e.id in self.archive.functions:
                d = self._function_dims(e.id)
                if d is None and e.id in self._fn_rec:
                    rep("T2004", e.meta)
                return _arith(d) if d is not None else None
            return None
        if isinstance(e, A.BusCall):
            for a in e.args:
                self._type_expr(a, scope, quiet)
            return ("b", e.id, 0)
        if isinstance(e, A.ArrayInLine):
            dims = []
            for v in e.values:
                t = self._type_expr(v, scope, quiet)
                dims.append(t[1] if t is not None and t[0] == "a"
                            else None)
            known = [d for d in dims if d is not None]
            if known and any(d != known[0] for d in known):
                rep("T2017", e.meta)
                return None
            return _arith(known[0] + 1) if known else None
        if isinstance(e, A.UniformArray):
            td = self._type_expr(e.dimension, scope, quiet)
            if td is not None and (td[0] != "a" or td[1] != 0):
                rep("T2044", e.dimension.meta)
            t = self._type_expr(e.value, scope, quiet)
            if t is not None and t[0] == "a":
                return _arith(t[1] + 1)
            return None
        # AnonymousComp / TupleExpr are removed by the sugar pass
        return None

    def _type_variable(self, e, scope, rep, writing=False):
        sym = scope.find(e.name)
        if sym is None:
            return None
        kind, info = sym if isinstance(sym, tuple) else (None, None)
        if kind is None:
            return None  # parameter: wildcard

        # consume array accesses against available dims
        def eat_arrays(access, dims, i):
            n = 0
            while i < len(access) and isinstance(access[i], A.ArrayAccess):
                t = self._type_expr(access[i].expr, scope)
                if t is not None and (t[0] != "a" or t[1] != 0):
                    rep("T2044", access[i].expr.meta)
                n += 1
                i += 1
            if dims is not None and n > dims:
                rep("T2032", e.meta)
                return None, i
            return (dims - n if dims is not None else None), i

        i = 0
        access = e.access
        if kind == "var":
            d, i = eat_arrays(access, info["dims"], i)
            if i < len(access):
                # component-style access on an arithmetic value
                rep("T2032", e.meta)
                return None
            return _arith(d) if d is not None else None
        if kind == "signal":
            d, i = eat_arrays(access, info["dims"], i)
            bus = info.get("bus")
            cur_tags = info.get("tags", ())
            while i < len(access):
                acc = access[i]
                if isinstance(acc, A.ComponentAccess):
                    if bus:
                        fld = self._bus_field(bus, acc.name)
                        if fld is None:
                            # a tag on the bus wire/field: must be
                            # declared (InvalidSignalAccessInBus BU04
                            # otherwise)
                            if acc.name not in cur_tags:
                                rep("T2048", e.meta)
                                return None
                            return _arith(0)
                        d, bus, cur_tags = fld
                        i += 1
                        d, i = eat_arrays(access, d, i)
                        if d is None:
                            return None
                    else:
                        # tag access: the signal (or the bus field we
                        # descended into) must DECLARE the tag
                        # (InvalidSignalTagAccess T2047); scalar value
                        if acc.name not in cur_tags:
                            rep("T2048", e.meta)
                            return None
                        if i + 1 < len(access):
                            rep("T2032", e.meta)
                        return _arith(0)
                else:
                    i += 1  # array access handled by eat_arrays
            if bus:
                return ("b", bus, d) if d is not None else None
            return _arith(d) if d is not None else None
        if kind == "component":
            d, i = eat_arrays(access, info["dims"], i)
            if i >= len(access):
                return None  # bare component reference
            acc = access[i]
            if isinstance(acc, A.ComponentAccess):
                tmpl = info.get("tmpl")
                if tmpl is None:
                    return None
                io = self._template_io(tmpl)
                if acc.name not in io:
                    return None  # main-input tags etc.: leave dynamic
                sd, sbus, stags, sdir = io[acc.name]
                i += 1
                sd, i = eat_arrays(access, sd, i)
                if sd is None:
                    return None
                if i < len(access):
                    if sbus:
                        # nested bus access THROUGH the component
                        # boundary: re-dispatch through fields; an
                        # access that is neither a declared field nor
                        # a declared tag of the current bus/field is
                        # BU04 even in unexecuted branches
                        # (type_check.rs bus-field typing)
                        bus = sbus
                        d2 = sd
                        cur_tags = stags
                        while i < len(access):
                            a2 = access[i]
                            if not isinstance(a2, A.ComponentAccess):
                                return None
                            if bus:
                                fld = self._bus_field(bus, a2.name)
                                if fld is None:
                                    if a2.name not in cur_tags:
                                        rep("T2048", e.meta)
                                        return None
                                    return _arith(0)
                                d2, bus, cur_tags = fld
                                i += 1
                                d2, i = eat_arrays(access, d2, i)
                                if d2 is None:
                                    return None
                            else:
                                # tag access on the scalar field we
                                # descended into
                                if a2.name not in cur_tags:
                                    rep("T2048", e.meta)
                                    return None
                                return _arith(0)
                        return (("b", bus, d2) if bus
                                else _arith(d2))
                    # tag read on a subcomponent io signal: the tag
                    # must be declared (T2047 InvalidSignalTagAccess),
                    # and INPUT tags are not visible from outside
                    # (T2048-C, type_check.rs InputTagCannot...)
                    a2 = access[i]
                    if isinstance(a2, A.ComponentAccess):
                        if a2.name not in stags:
                            rep("T2048", e.meta)
                            return None
                        if writing:
                            # io tags are never writable from outside
                            rep("T2048-A"
                                if sdir == A.SignalType.OUTPUT
                                else "T2048-B", e.meta)
                            return None
                        if sdir == A.SignalType.INPUT:
                            rep("T2048-C", e.meta)
                            return None
                    return _arith(0)  # tag on io signal
                if sbus:
                    return ("b", sbus, sd)
                return _arith(sd)
            return None
        return None

    # -- statements ----------------------------------------------------------
    def _check_stmt(self, s, scope, in_function, rets):
        if isinstance(s, A.Block):
            sc = _Scope(scope)
            for st in s.stmts:
                self._check_stmt(st, sc, in_function, rets)
            return
        if isinstance(s, A.InitializationBlock):
            for st in s.initializations:
                self._check_stmt(st, scope, in_function, rets)
            return
        if isinstance(s, A.Declaration):
            for d in s.dimensions:
                t = self._type_expr(d, scope)
                if t is not None and (t[0] != "a" or t[1] != 0):
                    self.error("T2044", d.meta)
            kind = s.xtype.kind
            info = {"dims": len(s.dimensions),
                    "tags": set(s.xtype.tags or ())}
            if kind in ("component", "anonymous_component"):
                info["tmpl"] = None
                scope.declare(s.name, ("component", info))
            elif kind == "bus":
                info["bus"] = s.xtype.bus_name
                scope.declare(s.name, ("signal", info))
            elif kind == "signal":
                info["bus"] = None
                scope.declare(s.name, ("signal", info))
            else:
                scope.declare(s.name, ("var", info))
            return
        if isinstance(s, A.Substitution):
            self._check_substitution(s, scope)
            return
        if isinstance(s, A.UnderscoreSubstitution):
            self._type_expr(s.rhe, scope)
            return
        if isinstance(s, A.ConstraintEquality):
            t1 = self._type_expr(s.lhe, scope)
            t2 = self._type_expr(s.rhe, scope)
            d1 = t1[1] if t1 is not None and t1[0] == "a" else None
            d2 = t2[1] if t2 is not None and t2[0] == "a" else None
            if d1 is not None and d2 is not None and d1 != d2:
                self.error("T2046", s.meta)
            return
        if isinstance(s, A.IfThenElse):
            t = self._type_expr(s.cond, scope)
            if t is not None and (t[0] != "a" or t[1] != 0):
                self.error("T2025", s.cond.meta)
            self._check_stmt(s.if_case, scope, in_function, rets)
            if s.else_case is not None:
                self._check_stmt(s.else_case, scope, in_function, rets)
            return
        if isinstance(s, A.While):
            t = self._type_expr(s.cond, scope)
            if t is not None and (t[0] != "a" or t[1] != 0):
                self.error("T2025", s.cond.meta)
            self._check_stmt(s.stmt, scope, in_function, rets)
            return
        if isinstance(s, A.Return):
            t = self._type_expr(s.value, scope)
            rets.append(t[1] if t is not None and t[0] == "a" else None)
            return
        if isinstance(s, A.LogCall):
            for a in s.args:
                if isinstance(a, A.LogExp):
                    t = self._type_expr(a.expr, scope)
                    if t is not None and (t[0] != "a" or t[1] != 0):
                        self.error("T2044", a.expr.meta)
            return
        if isinstance(s, A.Assert):
            t = self._type_expr(s.arg, scope)
            if t is not None and (t[0] != "a" or t[1] != 0):
                self.error("T2044", s.arg.meta)
            return
        if isinstance(s, A.AnonymousCompStmt):
            self._type_expr(s.expr, scope)
            return
        # MultSubstitution removed by sugar

    def _check_substitution(self, s, scope):
        rt = self._type_expr(s.rhe, scope)
        sym = scope.find(s.var)
        # component inference + template-into-non-component
        if rt is not None and rt[0] == "t":
            if sym is not None and isinstance(sym, tuple):
                kind, info = sym
                if kind == "component":
                    scope.assign_component(s.var, rt[1])
                elif kind in ("var", "signal"):
                    self.error("T2057", s.meta)
            return
        # lhs dims after access
        if sym is None or not isinstance(sym, tuple):
            for acc in s.access:
                if isinstance(acc, A.ArrayAccess):
                    t = self._type_expr(acc.expr, scope)
                    if t is not None and (t[0] != "a" or t[1] != 0):
                        self.error("T2044", acc.expr.meta)
            return
        fake = A.Variable(meta=s.meta, name=s.var, access=s.access)
        lt = self._type_variable(fake, scope,
                                 lambda code, meta: self.error(code, meta),
                                 writing=True)
        ld = lt[1] if lt is not None and lt[0] == "a" else None
        rd = rt[1] if rt is not None and rt[0] == "a" else None
        if ld is not None and rd is not None and ld != rd:
            self.error("T2061", s.meta)


def check_types_static(archive):
    """Run the static dimension/type battery; returns ReportCollection."""
    return TypeCheck(archive).run()
