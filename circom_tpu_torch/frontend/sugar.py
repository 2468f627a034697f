"""Syntactic sugar removal: anonymous components and tuples.

Mirrors parser/src/syntax_sugar_remover.rs:

* `Template(p)(s...)` in an expression becomes a hidden component
  `{Template}_{line}_{offset}` declared at the top of the template body,
  instantiated + fed right before the enclosing statement, and the
  expression value is the output signal (or a tuple of outputs in
  declaration order) (syntax_sugar_remover.rs:283-520).
* Anonymous components inside while/for loops become component arrays
  indexed by a generated `anon_var_{line}_{offset}` counter
  (syntax_sugar_remover.rs While case).
* Tuple statements `(a, b) <== (x, y)` split into per-element
  substitutions; `_` elements become underscore substitutions.
* Misuse checks: anon in conditions/log/assert/===/functions/LHS, and
  `<--` with anonymous components, are errors.
"""

from . import ast as A
from .ast import (AnonymousComp, AnonymousCompStmt, ArrayAccess, Assert,
                  AssignOp, Block, BusDef, Call, ComponentAccess,
                  ConstraintEquality, Declaration, Function, IfThenElse,
                  InitializationBlock, Infix, LogCall, LogExp, Meta,
                  MultSubstitution, Number, ParallelOp, Prefix, Return,
                  Stmt, Substitution, Template, TernarySwitch, TupleExpr,
                  UnderscoreSubstitution, UniformArray, VarType, Variable,
                  While)
from ..utils.reports import Report


def _err(msg, meta=None, code="TAC01"):
    # AnonymousCompError TAC01 / TupleError TAC02 (error_code.rs:251-252)
    r = Report.error(msg, code)
    if meta is not None:
        r.add_primary(meta.file_id, meta.start, meta.end)
    return r


def contains_anon(e):
    if isinstance(e, AnonymousComp):
        return True
    if isinstance(e, (Infix,)):
        return contains_anon(e.lhe) or contains_anon(e.rhe)
    if isinstance(e, Prefix):
        return contains_anon(e.rhe)
    if isinstance(e, TernarySwitch):
        return (contains_anon(e.cond) or contains_anon(e.if_true)
                or contains_anon(e.if_false))
    if isinstance(e, ParallelOp):
        return contains_anon(e.rhe)
    if isinstance(e, (A.ArrayInLine, TupleExpr)):
        return any(contains_anon(v) for v in e.values)
    if isinstance(e, UniformArray):
        return contains_anon(e.value) or contains_anon(e.dimension)
    if isinstance(e, (Call, A.BusCall)):
        return any(contains_anon(a) for a in e.args)
    return False


def _template_io(template: Template):
    """(inputs, outputs) signal names in declaration order."""
    ins, outs = [], []

    def walk(s):
        if isinstance(s, Block):
            for st in s.stmts:
                walk(st)
        elif isinstance(s, InitializationBlock):
            for st in s.initializations:
                walk(st)
        elif isinstance(s, Declaration):
            if s.xtype.kind in ("signal", "bus"):
                if s.xtype.signal_type == A.SignalType.INPUT:
                    ins.append(s.name)
                elif s.xtype.signal_type == A.SignalType.OUTPUT:
                    outs.append(s.name)
        elif isinstance(s, IfThenElse):
            walk(s.if_case)
            if s.else_case:
                walk(s.else_case)
        elif isinstance(s, While):
            walk(s.stmt)

    walk(template.body)
    return ins, outs


class SugarRemover:
    def __init__(self, archive):
        self.archive = archive
        self.file_library = archive.file_library

    def line_of(self, meta: Meta):
        src = self.file_library.get_source(meta.file_id)
        return src.count("\n", 0, meta.start) + 1

    def apply(self):
        if isinstance(self.archive.main.call, AnonymousComp):
            raise _err("The main component cannot be an anonymous call")
        for t in self.archive.templates.values():
            body, comp_decs, var_decs, subs = self.rm_stmt(t.body, None)
            new_stmts = comp_decs + var_decs + subs
            assert isinstance(body, Block)
            body.stmts = new_stmts + body.stmts
            t.body = self.rm_tuples_stmt(body)
        for f in self.archive.functions.values():
            if self._stmt_has_anon(f.body):
                raise _err("Functions cannot contain anonymous components",
                           f.meta)
            f.body = self.rm_tuples_stmt(f.body)

    def _stmt_has_anon(self, s):
        found = False

        def walk(st):
            nonlocal found
            if isinstance(st, Block):
                for x in st.stmts:
                    walk(x)
            elif isinstance(st, InitializationBlock):
                for x in st.initializations:
                    walk(x)
            elif isinstance(st, IfThenElse):
                found |= contains_anon(st.cond)
                walk(st.if_case)
                if st.else_case:
                    walk(st.else_case)
            elif isinstance(st, While):
                found |= contains_anon(st.cond)
                walk(st.stmt)
            elif isinstance(st, (Substitution, UnderscoreSubstitution)):
                found |= contains_anon(st.rhe)
            elif isinstance(st, MultSubstitution):
                found |= contains_anon(st.lhe) or contains_anon(st.rhe)
            elif isinstance(st, ConstraintEquality):
                found |= contains_anon(st.lhe) or contains_anon(st.rhe)
            elif isinstance(st, Return):
                found |= contains_anon(st.value)
            elif isinstance(st, Assert):
                found |= contains_anon(st.arg)

        walk(s)
        return found

    # -- anonymous component removal ------------------------------------
    def rm_stmt(self, s, var_access):
        """-> (new_stmt, comp_decls, var_decls, loop_counter_inits)."""
        if isinstance(s, Block):
            new_stmts, comps, varss, subs = [], [], [], []
            for st in s.stmts:
                st2, c, v, su = self.rm_stmt(st, var_access)
                new_stmts.append(st2)
                comps += c
                varss += v
                subs += su
            return Block(s.meta, new_stmts), comps, varss, subs
        if isinstance(s, InitializationBlock):
            new_inits, comps, varss, subs = [], [], [], []
            for st in s.initializations:
                st2, c, v, su = self.rm_stmt(st, var_access)
                new_inits.append(st2)
                comps += c
                varss += v
                subs += su
            return (InitializationBlock(s.meta, s.xtype, new_inits),
                    comps, varss, subs)
        if isinstance(s, IfThenElse):
            if contains_anon(s.cond):
                raise _err("anonymous component inside a condition", s.meta)
            i2, c1, v1, s1 = self.rm_stmt(s.if_case, var_access)
            if s.else_case is None:
                return IfThenElse(s.meta, s.cond, i2, None), c1, v1, s1
            e2, c2, v2, s2 = self.rm_stmt(s.else_case, var_access)
            return (IfThenElse(s.meta, s.cond, i2, e2), c1 + c2, v1 + v2,
                    s1 + s2)
        if isinstance(s, While):
            if contains_anon(s.cond):
                raise _err("anonymous component inside a condition", s.meta)
            meta = s.meta
            ctr = f"anon_var_{self.line_of(meta)}_{meta.start}"
            ctr_var = Variable(meta, ctr, [])
            body, comps, varss, subs = self.rm_stmt(s.stmt, ctr_var)
            var_decls, subs_out = [], []
            if comps:
                var_decls.append(
                    Declaration(meta, VarType("var"), ctr, []))
                subs.append(Substitution(meta, ctr, [], AssignOp.VAR,
                                         Number(meta, 0)))
                var_decls += varss
                subs_out += subs
                inc = Substitution(
                    meta, ctr, [], AssignOp.VAR,
                    Infix(meta, ctr_var, A.ADD, Number(meta, 1)))
                body = Block(meta, [body, inc])
                return (While(meta, s.cond, body), comps, var_decls,
                        subs_out)
            return While(meta, s.cond, body), comps, varss, subs
        if isinstance(s, MultSubstitution):
            if contains_anon(s.lhe):
                raise _err("anonymous component on the left of an "
                           "assignment", s.meta)
            if contains_anon(s.rhe) and s.op == AssignOp.SIGNAL:
                raise _err("anonymous components only admit <==", s.meta)
            comps, stmts, rhe = self.rm_expr(s.rhe, var_access)
            new = MultSubstitution(s.meta, s.lhe, s.op, rhe)
            if stmts:
                return Block(s.meta, stmts + [new]), comps, [], []
            return new, comps, [], []
        if isinstance(s, Substitution):
            if contains_anon(s.rhe) and s.op == AssignOp.SIGNAL:
                raise _err("anonymous components only admit <==", s.meta)
            comps, stmts, rhe = self.rm_expr(s.rhe, var_access)
            new = Substitution(s.meta, s.var, s.access, s.op, rhe)
            if stmts:
                return Block(s.meta, stmts + [new]), comps, [], []
            return new, comps, [], []
        if isinstance(s, AnonymousCompStmt):
            # bare `Foo(a)(b);` — outputs discarded
            comps, stmts, rhe = self.rm_expr(s.expr, var_access)
            under = UnderscoreSubstitution(s.meta, AssignOp.CONSTRAINT, rhe)
            return Block(s.meta, stmts + [under]), comps, [], []
        if isinstance(s, ConstraintEquality):
            if contains_anon(s.lhe) or contains_anon(s.rhe):
                raise _err("anonymous component with operator ===", s.meta)
            return s, [], [], []
        if isinstance(s, LogCall):
            for a in s.args:
                if isinstance(a, LogExp) and contains_anon(a.expr):
                    raise _err("anonymous component inside log", s.meta)
            return s, [], [], []
        if isinstance(s, Assert):
            if contains_anon(s.arg):
                raise _err("anonymous component inside assert", s.meta)
            return s, [], [], []
        return s, [], [], []

    def rm_expr(self, e, var_access):
        """-> (comp_decls, pre_stmts, new_expr)."""
        if isinstance(e, AnonymousComp):
            return self._rm_anon(e, var_access)
        if isinstance(e, ParallelOp):
            if isinstance(e.rhe, AnonymousComp):
                inner = e.rhe
                inner.is_parallel = True
                return self._rm_anon(inner, var_access)
            return [], [], e
        if isinstance(e, (A.ArrayInLine, TupleExpr)):
            comps, stmts, vals = [], [], []
            for v in e.values:
                c, st, v2 = self.rm_expr(v, var_access)
                comps += c
                stmts += st
                vals.append(v2)
            cls = type(e)
            return comps, stmts, cls(e.meta, vals)
        if isinstance(e, Infix):
            c1, s1, l2 = self.rm_expr(e.lhe, var_access)
            c2, s2, r2 = self.rm_expr(e.rhe, var_access)
            return c1 + c2, s1 + s2, Infix(e.meta, l2, e.op, r2)
        if isinstance(e, Prefix):
            c, st, r2 = self.rm_expr(e.rhe, var_access)
            return c, st, Prefix(e.meta, e.op, r2)
        if isinstance(e, TernarySwitch):
            if contains_anon(e.cond):
                raise _err("anonymous component inside a condition", e.meta)
            c1, s1, t2 = self.rm_expr(e.if_true, var_access)
            c2, s2, f2 = self.rm_expr(e.if_false, var_access)
            return (c1 + c2, s1 + s2,
                    TernarySwitch(e.meta, e.cond, t2, f2))
        return [], [], e

    def _rm_anon(self, e: AnonymousComp, var_access):
        meta = e.meta
        tmpl = self.archive.templates.get(e.id)
        if tmpl is None:
            raise _err(f"the template {e.id} does not exist", meta)
        name = f"{e.id}_{self.line_of(meta)}_{meta.start}"
        decls = []
        if var_access is None:
            decls.append(Declaration(
                meta, VarType("component"), name, [], True))
        else:
            decls.append(Declaration(
                meta, VarType("anonymous_component"), name, [var_access],
                True))
        call = Call(meta, e.id, e.params)
        rhs = ParallelOp(meta, call) if e.is_parallel else call
        access0 = [] if var_access is None else [ArrayAccess(var_access)]
        stmts = [Substitution(meta, name, list(access0), AssignOp.VAR, rhs)]
        ins, outs = _template_io(tmpl)
        # pair inputs with argument expressions
        if e.names is not None:
            if len(e.names) != len(ins):
                raise _err("the number of template input signals must "
                           "coincide with the number of input parameters",
                           meta)
            pairs = {}
            for (op, nm), sig in zip(e.names, e.signals):
                if op != AssignOp.CONSTRAINT:
                    raise _err("anonymous components only admit <==", meta)
                if nm not in ins:
                    raise _err(f"template {e.id} has no input '{nm}'", meta)
                pairs[nm] = sig
            ordered = [(nm, pairs[nm]) for nm in sorted(pairs)]
        else:
            if len(e.signals) != len(ins):
                raise _err("the number of template input signals must "
                           "coincide with the number of input parameters",
                           meta)
            ordered = sorted(zip(ins, e.signals), key=lambda kv: kv[0])
        for (nm, sig_expr) in ordered:
            c2, st2, new_exp = self.rm_expr(sig_expr, var_access)
            decls += c2
            stmts += st2
            acc = list(access0) + [ComponentAccess(nm)]
            stmts.append(Substitution(meta, name, acc,
                                      AssignOp.CONSTRAINT, new_exp))
        out_exprs = []
        for o in outs:
            acc = list(access0) + [ComponentAccess(o)]
            out_exprs.append(Variable(meta, name, acc))
        if len(out_exprs) == 1:
            out = out_exprs[0]
        else:
            out = TupleExpr(meta, out_exprs)
        return decls, [Block(meta, stmts)], out

    # -- tuple removal ---------------------------------------------------
    def rm_tuples_stmt(self, s):
        if isinstance(s, Block):
            s.stmts = [self.rm_tuples_stmt(st) for st in s.stmts]
            return s
        if isinstance(s, InitializationBlock):
            s.initializations = [
                self.rm_tuples_stmt(st) for st in s.initializations]
            return s
        if isinstance(s, IfThenElse):
            s.if_case = self.rm_tuples_stmt(s.if_case)
            if s.else_case is not None:
                s.else_case = self.rm_tuples_stmt(s.else_case)
            return s
        if isinstance(s, While):
            s.stmt = self.rm_tuples_stmt(s.stmt)
            return s
        if isinstance(s, MultSubstitution):
            return self._rm_tuple_sub(s)
        return s

    def _rm_tuple_sub(self, s: MultSubstitution):
        meta = s.meta
        if not isinstance(s.lhe, TupleExpr):
            raise _err("invalid left side of a multi-assignment", meta,
                       code="TAC02")
        if not isinstance(s.rhe, TupleExpr):
            raise _err("the right side of a tuple assignment must be a "
                       "tuple (e.g. an anonymous component with several "
                       "outputs)", meta, code="TAC02")
        lhs, rhs = s.lhe.values, s.rhe.values
        if len(lhs) != len(rhs):
            raise _err(
                f"tuple arity mismatch: {len(lhs)} vs {len(rhs)}", meta,
                code="TAC02")
        stmts = []
        for tgt, src in zip(lhs, rhs):
            if isinstance(tgt, Variable) and tgt.name == "_":
                stmts.append(UnderscoreSubstitution(meta, s.op, src))
            elif isinstance(tgt, Variable):
                stmts.append(
                    Substitution(meta, tgt.name, tgt.access, s.op, src))
            else:
                raise _err("tuple elements must be variables or _", meta,
                           code="TAC02")
        return Block(meta, stmts)


def apply_syntactic_sugar(archive):
    SugarRemover(archive).apply()
