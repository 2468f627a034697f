"""Static analysis battery (type_analysis crate counterpart).

Implements the pre-execution checks of check_types
(type_analysis/src/check_types.rs:6-83) that are not naturally caught by
the abstract interpreter, each with stable codes and source spans:

* symbol analysis: undeclared symbols, unknown calls, arity mismatches
  (analyzers/symbol_analysis.rs);
* templates cannot return (analyzers/no_returns_in_template.rs);
* signals/components/constraints only in templates; functions are pure
  (analyzers/functions_free_of_template_elements.rs);
* all function paths return (analyzers/
  functions_all_paths_with_return_statement.rs);
* custom templates: no <--/<==/===, no subcomponents
  (analyzers/custom_gate_analysis.rs) and the custom_templates pragma
  requirement (parser/src/lib.rs:220-273);
* main's public list names input signals (type_check.rs main checks);
* bus bodies contain only declarations
  (analyzers/buses_free_of_invalid_statements.rs).

Scoping/known-unknown subtleties remain enforced dynamically by the
executor (which sees the actual instantiation).
"""

from ..frontend import ast as A
from ..utils.reports import Report, ReportCollection


class Analyzer:
    def __init__(self, archive):
        self.archive = archive
        self.reports = ReportCollection()

    def error(self, msg, code, meta=None):
        r = Report.error(msg, code)
        if meta is not None:
            r.add_primary(meta.file_id, meta.start, meta.end)
        self.reports.add(r)

    def run(self):
        for t in self.archive.templates.values():
            self.check_template(t)
        for f in self.archive.functions.values():
            self.check_function(f)
        for b in self.archive.buses.values():
            self.check_bus(b)
        self.check_main()
        if not self.reports.has_errors:
            # static dimension/type check over every reachable body,
            # executed or not (type_check.rs:83-1564 runs before the
            # semantic analyses)
            from .type_check import check_types_static

            self.reports.extend(check_types_static(self.archive))
        if not self.reports.has_errors:
            # static unknown/known dataflow (reference runs it after the
            # structural battery, check_types.rs:77-83)
            from .unknown_known import unknown_known_analysis

            self.reports.extend(unknown_known_analysis(self.archive))
        if self.reports.has_errors:
            raise self.reports
        return self.reports  # warnings only

    # -- helpers ---------------------------------------------------------
    def _walk_stmts(self, s, fn):
        fn(s)
        if isinstance(s, A.Block):
            for st in s.stmts:
                self._walk_stmts(st, fn)
        elif isinstance(s, A.InitializationBlock):
            for st in s.initializations:
                self._walk_stmts(st, fn)
        elif isinstance(s, A.IfThenElse):
            self._walk_stmts(s.if_case, fn)
            if s.else_case is not None:
                self._walk_stmts(s.else_case, fn)
        elif isinstance(s, A.While):
            self._walk_stmts(s.stmt, fn)

    def _walk_exprs_in(self, s, fn):
        def visit_e(e):
            fn(e)
            if isinstance(e, A.Infix):
                visit_e(e.lhe)
                visit_e(e.rhe)
            elif isinstance(e, A.Prefix):
                visit_e(e.rhe)
            elif isinstance(e, A.TernarySwitch):
                visit_e(e.cond)
                visit_e(e.if_true)
                visit_e(e.if_false)
            elif isinstance(e, A.ParallelOp):
                visit_e(e.rhe)
            elif isinstance(e, (A.ArrayInLine, A.TupleExpr)):
                for v in e.values:
                    visit_e(v)
            elif isinstance(e, A.UniformArray):
                visit_e(e.value)
                visit_e(e.dimension)
            elif isinstance(e, (A.Call, A.BusCall, A.AnonymousComp)):
                for a in getattr(e, "args", getattr(e, "params", [])):
                    visit_e(a)
            elif isinstance(e, A.Variable):
                for acc in e.access:
                    if isinstance(acc, A.ArrayAccess):
                        visit_e(acc.expr)

        def visit_s(st):
            if isinstance(st, A.Substitution):
                visit_e(st.rhe)
                for acc in st.access:
                    if isinstance(acc, A.ArrayAccess):
                        visit_e(acc.expr)
            elif isinstance(st, A.UnderscoreSubstitution):
                visit_e(st.rhe)
            elif isinstance(st, A.MultSubstitution):
                visit_e(st.lhe)
                visit_e(st.rhe)
            elif isinstance(st, A.ConstraintEquality):
                visit_e(st.lhe)
                visit_e(st.rhe)
            elif isinstance(st, (A.IfThenElse, A.While)):
                visit_e(st.cond)
            elif isinstance(st, A.Return):
                visit_e(st.value)
            elif isinstance(st, A.Assert):
                visit_e(st.arg)
            elif isinstance(st, A.Declaration):
                for d in st.dimensions:
                    visit_e(d)
            elif isinstance(st, A.LogCall):
                for a in st.args:
                    if isinstance(a, A.LogExp):
                        visit_e(a.expr)

        self._walk_stmts(s, visit_s)

    def _collect_declared(self, body, args):
        names = set(args)

        def fn(st):
            if isinstance(st, A.Declaration):
                names.add(st.name)
            elif isinstance(st, A.Substitution):
                pass

        self._walk_stmts(body, fn)
        return names

    # -- per-definition checks -------------------------------------------
    def check_calls(self, body, context):
        def fn(e):
            if isinstance(e, A.Call):
                if e.id in self.archive.functions:
                    fdef = self.archive.functions[e.id]
                    if len(e.args) != len(fdef.args):
                        self.error(
                            f"function {e.id} expects {len(fdef.args)} "
                            f"arguments, got {len(e.args)}", "T2012",
                            e.meta,
                        )
                elif e.id in self.archive.templates:
                    tdef = self.archive.templates[e.id]
                    if len(e.args) != len(tdef.args):
                        self.error(
                            f"template {e.id} expects {len(tdef.args)} "
                            f"parameters, got {len(e.args)}", "T2023",
                            e.meta,
                        )
                    if context == "function":
                        self.error(
                            "template call inside a function", "T2022",
                            e.meta,
                        )
                elif e.id not in self.archive.buses:
                    # UndefinedFunction (error_code.rs T2001): a call in
                    # expression position; unknown TEMPLATES surface at
                    # instantiation (T20461), bus calls resolve by the
                    # symbol table (same surface syntax)
                    self.error(
                        f"unknown function or template '{e.id}'", "T2001",
                        e.meta,
                    )
            elif isinstance(e, A.BusCall):
                if e.id not in self.archive.buses:
                    self.error(f"unknown bus '{e.id}'", "T2052", e.meta)

        self._walk_exprs_in(body, fn)

    def check_undeclared(self, defn, body, args):
        declared = self._collect_declared(body, args)
        known_globals = (set(self.archive.functions)
                        | set(self.archive.templates)
                        | set(self.archive.buses))

        def fn(e):
            if isinstance(e, A.Variable) and e.name != "_":
                if e.name not in declared and e.name not in known_globals:
                    # NonExistentSymbol (error_code.rs T2021)
                    self.error(
                        f"undeclared symbol '{e.name}'", "T2021", e.meta)

        self._walk_exprs_in(body, fn)

        def fs(st):
            if isinstance(st, A.Substitution) and st.var != "_":
                if st.var not in declared and st.var not in known_globals:
                    self.error(
                        f"undeclared symbol '{st.var}'", "T2021", st.meta)

        self._walk_stmts(body, fs)

    def check_template(self, t: A.Template):
        def fn(st):
            if isinstance(st, A.Return):
                # TemplateWithReturnStatement (error_code.rs T2024)
                self.error("templates cannot return a value", "T2024",
                           st.meta)

        self._walk_stmts(t.body, fn)
        self._check_signal_scope(t.body, in_while=False)
        self.check_calls(t.body, "template")
        self.check_undeclared(t, t.body, t.args)
        if t.is_custom_gate:
            self.check_custom_gate(t)

    def _check_signal_scope(self, s, in_while):
        """SignalOutsideOriginalScope (error_code.rs T2011,
        signal_declaration_analysis.rs:30-66): signal, bus and component
        declarations are allowed in the initial scope and inside `if`
        scopes, but never inside a `while` scope."""
        if isinstance(s, A.Declaration) and s.xtype.kind in (
                "signal", "bus", "component", "anonymous_component"):
            if in_while:
                self.error(
                    "Signal, bus or component declaration inside While "
                    "scope. Signals, buses and components can only be "
                    "defined in the initial scope or in If scopes with "
                    "known condition", "T2011", s.meta)
        elif isinstance(s, A.Block):
            for st in s.stmts:
                self._check_signal_scope(st, in_while)
        elif isinstance(s, A.InitializationBlock):
            for st in s.initializations:
                self._check_signal_scope(st, in_while)
        elif isinstance(s, A.IfThenElse):
            self._check_signal_scope(s.if_case, in_while)
            if s.else_case is not None:
                self._check_signal_scope(s.else_case, in_while)
        elif isinstance(s, A.While):
            self._check_signal_scope(s.stmt, True)

    def check_custom_gate(self, t: A.Template):
        # codes match custom_gate_analysis.rs + parser/lib.rs:131
        # (CG01 warning / CG02 constraint / CG03 subcomponent /
        #  CG04 pragma, error_code.rs:246-249)
        if not self.archive.custom_gates:
            self.error(
                f"custom template '{t.name}' requires "
                "`pragma custom_templates`", "CG04", t.meta,
            )

        # the reference's custom_gate_analysis returns Err(errors) and
        # DROPS the CG01 warnings when any CG02/CG03 error exists
        # (custom_gate_analysis.rs:137-151) — collect locally and only
        # publish the warnings on a clean walk
        cg_warnings = []
        had_error = [False]

        def fn(st):
            if isinstance(st, A.Declaration) and st.xtype.kind in (
                "component", "anonymous_component",
            ):
                had_error[0] = True
                self.error(
                    f"Component {st.name} declared in custom template "
                    f"{t.name}", "CG03", st.meta,
                )
            if (isinstance(st, A.Declaration)
                    and st.xtype.kind in ("signal", "bus")
                    and st.xtype.signal_type == A.SignalType.INTERMEDIATE):
                r = Report.warning(
                    f"Intermediate signal {st.name} declared in custom "
                    f"template {t.name}", "CG01")
                r.add_primary(st.meta.file_id, st.meta.start, st.meta.end)
                cg_warnings.append(r)
            if isinstance(st, A.Substitution) and st.op in (
                A.AssignOp.CONSTRAINT,
            ):
                had_error[0] = True
                self.error(
                    "Added constraint inside custom template "
                    "(use <-- in custom templates)", "CG02", st.meta,
                )
            if isinstance(st, A.ConstraintEquality):
                had_error[0] = True
                self.error(
                    "Added constraint inside custom template", "CG02",
                    st.meta)

        self._walk_stmts(t.body, fn)
        if not had_error[0]:
            for r in cg_warnings:
                self.reports.add(r)

    def check_function(self, f: A.Function):
        def fn(st):
            # ForbiddenDeclarationInFunction T2016 /
            # ConstraintGeneratorInFunction T2039 (error_code.rs)
            if isinstance(st, A.Declaration) and st.xtype.kind != "var":
                self.error(
                    "functions cannot declare signals, components or "
                    "buses", "T2016", st.meta,
                )
            if isinstance(st, A.Substitution) and st.op != A.AssignOp.VAR:
                self.error(
                    "functions cannot use signal assignment operators",
                    "T2039", st.meta,
                )
            if isinstance(st, A.ConstraintEquality):
                self.error("functions cannot declare constraints",
                           "T2039", st.meta)

        self._walk_stmts(f.body, fn)
        self.check_calls(f.body, "function")
        self.check_undeclared(f, f.body, f.args)
        if not self._all_paths_return(f.body):
            # FunctionPathWithoutReturn (error_code.rs T2014)
            self.error(
                f"all execution paths of function '{f.name}' must end "
                "with a return statement", "T2014", f.meta,
            )

    def _all_paths_return(self, s) -> bool:
        if isinstance(s, A.Return):
            return True
        if isinstance(s, A.Block):
            return any(self._all_paths_return(st) for st in s.stmts)
        if isinstance(s, A.IfThenElse):
            if s.else_case is None:
                return False
            return (self._all_paths_return(s.if_case)
                    and self._all_paths_return(s.else_case))
        return False

    def check_bus(self, b: A.BusDef):
        def fn(st):
            if isinstance(st, A.Declaration):
                if st.xtype.kind not in ("signal", "bus", "var"):
                    self.error(
                        "bus bodies may only declare signals and buses",
                        "T2037", st.meta,
                    )
                elif (st.xtype.kind == "signal"
                      and st.xtype.signal_type != A.SignalType.INTERMEDIATE):
                    self.error(
                        "bus fields cannot be input/output", "T2037",
                        st.meta,
                    )
            elif isinstance(st, (A.IfThenElse, A.While, A.Return,
                                 A.ConstraintEquality, A.LogCall,
                                 A.Assert)):
                self.error(
                    "invalid statement inside a bus body", "T2037",
                    st.meta,
                )

        self._walk_stmts(b.body, fn)

    def check_main(self):
        call = self.archive.main.call
        if isinstance(call, A.Call):
            if call.id not in self.archive.templates:
                self.error(
                    f"main component template '{call.id}' does not exist",
                    "T2002", call.meta,
                )
                return
            t = self.archive.templates[call.id]
            # public list entries must be input signals of main
            input_names = set()

            def fn(st):
                if (isinstance(st, A.Declaration)
                        and st.xtype.kind in ("signal", "bus")
                        and st.xtype.signal_type == A.SignalType.INPUT):
                    input_names.add(st.name)

            self._walk_stmts(t.body, fn)
            for name in self.archive.main.public:
                if name not in input_names:
                    self.error(
                        f"public list signal '{name}' is not an input of "
                        f"the main component", "T2009",
                    )


def analyse_program(archive):
    """check_types equivalent; raises ReportCollection on errors."""
    return Analyzer(archive).run()
