"""Recursive-descent parser for circom.

Grammar fidelity: statement/expression forms, the 14-tier precedence
ladder, declaration splitting and sugar (for->while, compound assigns,
++/--) follow the reference grammar (parser/src/lang.lalrpop) and
ast_shortcuts (program_structure/src/abstract_syntax_tree/
ast_shortcuts.rs:18-211).  Numbers are reduced into the field at parse
time (lang.lalrpop:760-764).

Error recovery: missing semicolons are recorded and parsing continues
(lang.lalrpop:29-32), so several errors can be reported in one run.
"""

from .ast import *
from .lexer import Token, preprocess, tokenize
from ..utils.reports import Report, ReportCollection

CMP_OPS = (EQ, NEQ, LT, GT, LEQ, GEQ)
# left-associative tiers, loosest first (lang.lalrpop:683-724)
INFIX_TIERS = [
    (BOOL_OR,),
    (BOOL_AND,),
    CMP_OPS,
    (BIT_OR,),
    (BIT_XOR,),
    (BIT_AND,),
    (SHL, SHR),
    (ADD, SUB),
    (MUL, DIV, INTDIV, MOD),
    (POW,),
]
ASSIGN_OPS = {"=": AssignOp.VAR, "<--": AssignOp.SIGNAL, "<==": AssignOp.CONSTRAINT}
COMPOUND_OPS = {
    "+=": ADD, "-=": SUB, "*=": MUL, "/=": DIV, "\\=": INTDIV, "%=": MOD,
    "<<=": SHL, ">>=": SHR, "&=": BIT_AND, "|=": BIT_OR, "^=": BIT_XOR,
    "**=": POW,
}


class Parser:
    def __init__(self, tokens, file_id: int, p: int, no_init: bool = False):
        self.toks = tokens
        self.i = 0
        self.file_id = file_id
        self.p = p
        self.no_init = no_init
        self.errors = ReportCollection()

    # -- token helpers -------------------------------------------------
    def peek(self, k=0) -> Token:
        j = min(self.i + k, len(self.toks) - 1)
        return self.toks[j]

    def at(self, *kinds) -> bool:
        return self.toks[self.i].kind in kinds

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def expect(self, kind, what="") -> Token:
        t = self.toks[self.i]
        if t.kind != kind:
            if kind == "id":
                # ExpectedIdentifier (error_code.rs P1015 / ast.rs:568)
                raise self.fail("An identifier is expected", t,
                                code="P1015")
            if kind == "str" and what == "include path":
                # UnrecognizedInclude (lang.lalrpop:73, P1009)
                raise self.fail("unrecognized argument in include "
                                "directive", t, code="P1009")
            raise self.fail(f"expected {what or kind!r}, found {t.kind!r}", t)
        return self.next()

    def expect_semi(self):
        """Missing-semicolon recovery (lang.lalrpop:29-32)."""
        if self.at(";"):
            self.next()
        else:
            t = self.peek()
            self.errors.add(
                Report.error("missing semicolon", "P1008").add_primary(
                    self.file_id, t.start, t.end
                )
            )

    def fail(self, msg, tok=None, code="P1012"):
        # P1012 = IllegalExpression, the reference's generic parse-error
        # code (parser_logic.rs:126)
        tok = tok or self.peek()
        rep = Report.error(msg, code).add_primary(self.file_id, tok.start, tok.end)
        self.errors.add(rep)
        return self.errors

    def meta(self, start_tok, end_tok=None) -> Meta:
        end = (end_tok or self.toks[max(self.i - 1, 0)]).end
        return Meta(self.file_id, start_tok.start, end)

    # -- file ----------------------------------------------------------
    def parse_file(self) -> FileAst:
        version = None
        custom_gates = False
        while self.at("pragma"):
            self.next()
            if self.at("circom"):
                self.next()
                if version is not None:
                    self.fail("multiple `pragma circom` in file",
                              code="P1013")
                if self.at("num"):
                    version = self.parse_version()
                else:
                    self.fail("unrecognized version", code="P1010")
                    while not self.at(";", "eof"):
                        self.next()
                self.expect_semi()
            elif self.at("custom_templates"):
                self.next()
                custom_gates = True
                self.expect_semi()
            else:
                self.fail("unrecognized pragma", code="P1011")
                while not self.at(";", "eof"):
                    self.next()
                self.expect_semi()
        includes = []
        while self.at("include"):
            self.next()
            includes.append(self.expect("str", "include path").value)
            self.expect_semi()
        definitions = []
        main = None
        while not self.at("eof"):
            if self.at("function", "template", "bus"):
                definitions.append(self.parse_definition())
            elif self.at("component") and self.peek(1).kind == "main":
                if main is not None:
                    self.fail("multiple main components in file",
                              code="P1002")
                main = self.parse_main_component()
            else:
                raise self.fail("expected definition or main component")
        if self.errors.reports:
            raise self.errors
        return FileAst(self.file_id, version, custom_gates, includes, definitions, main)

    def parse_version(self):
        maj = self.expect("num").value
        self.expect(".")
        mino = self.expect("num").value
        self.expect(".")
        pat = self.expect("num").value
        return (maj, mino, pat)

    def parse_main_component(self) -> MainComponent:
        self.expect("component")
        self.expect("main")
        public = []
        if self.at("{"):
            self.next()
            self.expect("public")
            self.expect("[")
            public = self.parse_identifier_list()
            self.expect("]")
            self.expect("}")
        self.expect("=")
        call = self.parse_expression()
        self.expect_semi()
        return MainComponent(public, call)

    def parse_identifier_list(self):
        ids = [self.expect("id").value]
        while self.at(","):
            self.next()
            ids.append(self.expect("id").value)
        return ids

    def parse_definition(self):
        start = self.peek()
        if self.at("function"):
            self.next()
            name = self.expect("id").value
            args = self.parse_arg_names()
            body = self.parse_block()
            return Function(self.meta(start), name, args, body)
        if self.at("template"):
            self.next()
            custom = bool(self.at("custom")) and (self.next() or True)
            extern_c = bool(self.at("extern_c")) and (self.next() or True)
            par = bool(self.at("parallel")) and (self.next() or True)
            name = self.expect("id").value
            args = self.parse_arg_names() if self.at("(") else []
            body = self.parse_block()
            return Template(self.meta(start), name, args, body, par, custom, extern_c)
        self.expect("bus")
        name = self.expect("id").value
        args = self.parse_arg_names() if self.at("(") else []
        body = self.parse_block()
        return BusDef(self.meta(start), name, args, body)

    def parse_arg_names(self):
        self.expect("(")
        if self.at(")"):
            self.next()
            return []
        ids = self.parse_identifier_list()
        self.expect(")")
        return ids

    # -- statements ----------------------------------------------------
    def parse_block(self) -> Block:
        start = self.expect("{")
        stmts = []
        while not self.at("}", "eof"):
            stmts.append(self.parse_block_statement())
        self.expect("}")
        return Block(self.meta(start), stmts)

    def is_declaration_start(self) -> bool:
        if self.at("var", "signal", "component", "input", "output"):
            # `component main` at file level never reaches here; inside a
            # body `component` always declares.
            return True
        # bus declaration: ID [ (args) ] [input|output] symbol...
        if self.at("id"):
            j = self.i + 1
            if self.toks[j].kind == "(":
                depth = 1
                j += 1
                while depth and self.toks[j].kind != "eof":
                    if self.toks[j].kind == "(":
                        depth += 1
                    elif self.toks[j].kind == ")":
                        depth -= 1
                    j += 1
            return self.toks[j].kind in ("id", "input", "output")
        return False

    def parse_block_statement(self) -> Stmt:
        if self.is_declaration_start():
            decl = self.parse_declaration()
            self.expect_semi()
            return decl
        return self.parse_statement()

    def parse_statement(self) -> Stmt:
        t = self.peek()
        if t.kind == "if":
            return self.parse_if()
        if t.kind == "while":
            self.next()
            self.expect("(")
            cond = self.parse_expression()
            self.expect(")")
            body = self.parse_statement()
            return While(self.meta(t), cond, body)
        if t.kind == "for":
            return self.parse_for()
        if t.kind == "return":
            self.next()
            value = self.parse_expression()
            self.expect_semi()
            return Return(self.meta(t), value)
        if t.kind == "log":
            self.next()
            self.expect("(")
            args = []
            if not self.at(")"):
                args.append(self.parse_log_argument())
                while self.at(","):
                    self.next()
                    args.append(self.parse_log_argument())
            self.expect(")")
            self.expect_semi()
            return LogCall(self.meta(t), args)
        if t.kind == "assert":
            self.next()
            self.expect("(")
            arg = self.parse_expression()
            self.expect(")")
            self.expect_semi()
            return Assert(self.meta(t), arg)
        if t.kind == "{":
            return self.parse_block()
        return self.parse_expression_statement()

    def parse_log_argument(self):
        if self.at("str"):
            return LogStr(self.next().value)
        return LogExp(self.parse_expression())

    def parse_if(self) -> Stmt:
        t = self.expect("if")
        self.expect("(")
        cond = self.parse_expression()
        self.expect(")")
        if_case = self.parse_statement()
        else_case = None
        if self.at("else"):
            self.next()
            else_case = self.parse_statement()
        return IfThenElse(self.meta(t), cond, if_case, else_case)

    def parse_for(self) -> Stmt:
        """for(init; cond; step) body  ->  { init; while(cond){ body; step } }
        (ast_shortcuts.rs:40-50)."""
        t = self.expect("for")
        self.expect("(")
        if self.is_declaration_start():
            init = self.parse_declaration()
        else:
            init = self.parse_substitution_only()
        self.expect_semi()
        cond = self.parse_expression()
        self.expect_semi()
        step = self.parse_substitution_only()
        self.expect(")")
        body = self.parse_statement()
        meta = self.meta(t)
        while_body = Block(meta, [body, step])
        return Block(meta, [init, While(meta, cond, while_body)])

    def parse_substitution_only(self) -> Stmt:
        """A substitution without trailing semicolon (for-loop init/step)."""
        stmt = self.parse_expression_led(require_semi=False, in_for=True)
        if not isinstance(stmt, (Substitution, MultSubstitution)):
            # ForStatementIllConstructed (error_code.rs T2035)
            self.fail("for statement is ill constructed: expected an "
                      "assignment", code="T2035")
        return stmt

    def parse_expression_statement(self) -> Stmt:
        return self.parse_expression_led(require_semi=True)

    def parse_expression_led(self, require_semi: bool,
                             in_for: bool = False) -> Stmt:
        start = self.peek()
        lhe = self.parse_expression()
        t = self.peek()
        if t.kind in ASSIGN_OPS:
            self.next()
            rhe = self.parse_expression()
            stmt = self.make_substitution(start, lhe, ASSIGN_OPS[t.kind], rhe)
        elif t.kind in ("-->", "==>"):
            self.next()
            op = AssignOp.SIGNAL if t.kind == "-->" else AssignOp.CONSTRAINT
            var = self.parse_expression()
            stmt = self.make_substitution(start, var, op, lhe)
        elif t.kind == "===":
            self.next()
            rhe = self.parse_expression()
            stmt = ConstraintEquality(self.meta(start), lhe, rhe)
        elif t.kind in COMPOUND_OPS:
            self.next()
            self.check_plain_variable(lhe, t)
            rhe = self.parse_expression()
            infix = Infix(self.meta(start), lhe, COMPOUND_OPS[t.kind], rhe)
            stmt = Substitution(self.meta(start), lhe.name, lhe.access, AssignOp.VAR, infix)
        elif t.kind in ("++", "--"):
            self.next()
            self.check_plain_variable(lhe, t)
            op = ADD if t.kind == "++" else SUB
            one = Number(self.meta(start), 1 % self.p)
            infix = Infix(self.meta(start), lhe, op, one)
            stmt = Substitution(self.meta(start), lhe.name, lhe.access, AssignOp.VAR, infix)
        elif isinstance(lhe, AnonymousComp):
            stmt = AnonymousCompStmt(self.meta(start), lhe)
        elif in_for:
            # ForStatementIllConstructed (error_code.rs T2035)
            raise self.fail("for statement is ill constructed: expected "
                            "an assignment", t, code="T2035")
        else:
            raise self.fail("illegal expression statement", t)
        if require_semi:
            self.expect_semi()
        return stmt

    def check_plain_variable(self, e, tok):
        if not isinstance(e, Variable):
            raise self.fail("operator requires a variable on the left", tok)

    def make_substitution(self, start, target, op, rhe) -> Stmt:
        if isinstance(target, Variable):
            return Substitution(self.meta(start), target.name, target.access, op, rhe)
        return MultSubstitution(self.meta(start), target, op, rhe)

    # -- declarations --------------------------------------------------
    def parse_declaration(self) -> Stmt:
        start = self.peek()
        if self.at("var"):
            self.next()
            xtype = VarType("var")
            return self.finish_declaration(start, xtype, AssignOp.VAR)
        if self.at("component"):
            self.next()
            xtype = VarType("component")
            return self.finish_declaration(start, xtype, AssignOp.VAR)
        if self.at("signal") or (
            self.at("input", "output") and self.peek(1).kind == "signal"
        ):
            xtype = self.parse_signal_header()
            return self.finish_declaration(start, xtype, None)
        # bus declaration (BusHeader, lang.lalrpop:194-240)
        st = SignalType.INTERMEDIATE
        if self.at("input", "output"):
            st = SignalType.INPUT if self.next().kind == "input" else SignalType.OUTPUT
            bus_name = self.expect("id").value
            bus_args = self.parse_call_args() if self.at("(") else []
        else:
            bus_name = self.expect("id").value
            bus_args = self.parse_call_args() if self.at("(") else []
            if self.at("input", "output"):
                st = (
                    SignalType.INPUT
                    if self.next().kind == "input"
                    else SignalType.OUTPUT
                )
        tags = self.parse_tags_list()
        xtype = VarType("bus", st, tuple(tags), bus_name)
        bus_call = BusCall(self.meta(start), bus_name, bus_args)
        return self.finish_bus_declaration(start, xtype, bus_call)

    def parse_signal_header(self) -> VarType:
        if self.at("signal"):
            self.next()
            st = SignalType.INTERMEDIATE
            if self.at("input", "output"):
                st = (
                    SignalType.INPUT
                    if self.next().kind == "input"
                    else SignalType.OUTPUT
                )
        else:
            st = SignalType.INPUT if self.next().kind == "input" else SignalType.OUTPUT
            self.expect("signal")
        tags = self.parse_tags_list()
        return VarType("signal", st, tuple(tags))

    def parse_tags_list(self):
        if not (self.at("{") and self.peek(1).kind == "id"):
            return []
        self.next()
        tags = self.parse_identifier_list()
        self.expect("}")
        return tags

    def parse_symbol(self, allow_init_ops):
        """IDENTIFIER dims* [op expr]  ->  (name, dims, op, init|None)"""
        name = self.expect("id").value
        dims = []
        while self.at("["):
            self.next()
            dims.append(self.parse_expression())
            self.expect("]")
        for opk in allow_init_ops:
            if self.at(opk):
                self.next()
                return (name, dims, ASSIGN_OPS[opk], self.parse_expression())
        return (name, dims, None, None)

    def finish_declaration(self, start, xtype, default_op) -> Stmt:
        """var/component/signal declarations incl. the tuple form
        (split per ast_shortcuts.rs:52-141)."""
        meta = self.meta(start)
        if self.at("(") :
            # tuple form: var (a, b) <== expr
            self.next()
            symbols = [self.parse_symbol(())]
            while self.at(","):
                self.next()
                symbols.append(self.parse_symbol(()))
            self.expect(")")
            init = None
            for opk in ("<==", "<--", "="):
                if self.at(opk):
                    self.next()
                    init = (ASSIGN_OPS[opk], self.parse_expression())
                    break
            return self.split_tuple_declaration(meta, xtype, symbols, init)
        init_ops = ("=",) if xtype.kind in ("var", "component") else ("<==", "<--")
        symbols = [self.parse_symbol(init_ops)]
        while self.at(","):
            self.next()
            symbols.append(self.parse_symbol(init_ops))
        # signals: mixing <== and <-- within one declaration is not grammatical
        ops_used = {op for (_, _, op, _) in symbols if op is not None}
        if len(ops_used) > 1:
            self.fail("cannot mix <== and <-- in one declaration")
        if xtype.kind in ("var", "component"):
            split_op = AssignOp.VAR
        else:
            split_op = ops_used.pop() if ops_used else AssignOp.CONSTRAINT
        return self.split_declaration(meta, xtype, symbols, split_op)

    def split_declaration(self, meta, xtype, symbols, op) -> Stmt:
        inits = []
        for (name, dims, _, init) in symbols:
            inits.append(Declaration(meta, xtype, name, dims))
            if (
                xtype.kind == "var"
                and (init is None or dims)
                and not self.no_init
            ):
                value = Number(meta, 0)
                for d in reversed(dims):
                    value = UniformArray(meta, value, d)
                inits.append(Substitution(meta, name, [], op, value))
            if init is not None:
                inits.append(Substitution(meta, name, [], op, init))
        return InitializationBlock(meta, xtype, inits)

    def split_tuple_declaration(self, meta, xtype, symbols, init) -> Stmt:
        inits = []
        values = []
        for (name, dims, _, _) in symbols:
            inits.append(Declaration(meta, xtype, name, dims))
            if (
                xtype.kind == "var"
                and (init is None or dims)
                and not self.no_init
            ):
                value = Number(meta, 0)
                for d in reversed(dims):
                    value = UniformArray(meta, value, d)
                inits.append(Substitution(meta, name, [], AssignOp.VAR, value))
            values.append(Variable(meta, name, []))
        if init is not None:
            op, expression = init
            if len(values) == 1:
                inits.append(Substitution(meta, values[0].name, [], op, expression))
            else:
                inits.append(
                    MultSubstitution(meta, TupleExpr(meta, values), op, expression)
                )
        return InitializationBlock(meta, xtype, inits)

    def finish_bus_declaration(self, start, xtype, bus_call) -> Stmt:
        """Bus declarations (split per ast_shortcuts.rs:145-211)."""
        meta = self.meta(start)
        symbols = [self.parse_symbol(("<==", "<--"))]
        while self.at(","):
            self.next()
            symbols.append(self.parse_symbol(("<==", "<--")))
        ops_used = {op for (_, _, op, _) in symbols if op is not None}
        if len(ops_used) > 1:
            self.fail("cannot mix <== and <-- in one declaration")
        op = ops_used.pop() if ops_used else AssignOp.CONSTRAINT
        inits = []
        for (name, dims, _, init) in symbols:
            inits.append(Declaration(meta, xtype, name, dims))
            value = bus_call
            for d in reversed(dims):
                value = UniformArray(meta, value, d)
            inits.append(Substitution(meta, name, [], AssignOp.VAR, value))
            if init is not None:
                inits.append(Substitution(meta, name, [], op, init))
        return InitializationBlock(meta, xtype, inits)

    # -- expressions ---------------------------------------------------
    def parse_expression(self) -> Expr:
        if self.at("parallel"):
            t = self.next()
            expr = self.parse_expression1()
            return ParallelOp(self.meta(t), expr)
        return self.parse_expression1()

    def parse_expression1(self) -> Expr:
        start = self.peek()
        cond = self.parse_tier(0)
        if self.at("?"):
            self.next()
            if_true = self.parse_tier(0)
            self.expect(":")
            if_false = self.parse_tier(0)
            return TernarySwitch(self.meta(start), cond, if_true, if_false)
        return cond

    def parse_tier(self, level: int) -> Expr:
        if level >= len(INFIX_TIERS):
            return self.parse_prefix()
        ops = INFIX_TIERS[level]
        start = self.peek()
        lhe = self.parse_tier(level + 1)
        while self.peek().kind in ops:
            op = self.next().kind
            rhe = self.parse_tier(level + 1)
            lhe = Infix(self.meta(start), lhe, op, rhe)
        return lhe

    def parse_prefix(self) -> Expr:
        t = self.peek()
        if t.kind in ("-", "!", "~"):
            self.next()
            rhe = self.parse_prefix()
            op = {"-": P_SUB, "!": P_NOT, "~": P_COMPLEMENT}[t.kind]
            return Prefix(self.meta(t), op, rhe)
        return self.parse_primary()

    def parse_call_args(self):
        self.expect("(")
        if self.at(")"):
            self.next()
            return []
        args = [self.parse_expression()]
        while self.at(","):
            self.next()
            args.append(self.parse_expression())
        self.expect(")")
        return args

    def parse_primary(self) -> Expr:
        t = self.peek()
        if t.kind == "id" and self.peek(1).kind == "(":
            self.next()
            params = self.parse_call_args()
            if self.at("("):
                signals, names = self.parse_anonymous_signals()
                return AnonymousComp(
                    self.meta(t), t.value, False, params, signals, names
                )
            return Call(self.meta(t), t.value, params)
        if t.kind == "id":
            self.next()
            access = []
            while True:
                if self.at("["):
                    self.next()
                    access.append(ArrayAccess(self.parse_expression()))
                    self.expect("]")
                elif self.at(".") and self.peek(1).kind == "id":
                    self.next()
                    access.append(ComponentAccess(self.next().value))
                else:
                    break
            return Variable(self.meta(t), t.value, access)
        if t.kind == "_":
            self.next()
            return Variable(self.meta(t), "_", [])
        if t.kind == "num":
            self.next()
            return Number(self.meta(t), t.value % self.p)
        if t.kind == "[":
            self.next()
            if self.at("]"):
                # EmptyArrayInlineDeclaration (error_code.rs T2026)
                raise self.fail("array declarations must be non-empty",
                                t, code="T2026")
            values = [self.parse_expression()]
            while self.at(","):
                self.next()
                values.append(self.parse_expression())
            self.expect("]")
            return ArrayInLine(self.meta(t), values)
        if t.kind == "(":
            self.next()
            first = self.parse_expression()
            if self.at(","):
                values = [first]
                while self.at(","):
                    self.next()
                    values.append(self.parse_expression())
                self.expect(")")
                return TupleExpr(self.meta(t), values)
            self.expect(")")
            return first
        raise self.fail(f"unexpected token {t.kind!r} in expression", t)

    def parse_anonymous_signals(self):
        """Second arg list of `Foo(p)(s)` — positional or named
        (lang.lalrpop:586-604)."""
        self.expect("(")
        if self.at(")"):
            self.next()
            return [], None
        named = self.at("id") and self.peek(1).kind in ("<==", "<--", "=")
        signals, names = [], [] if named else None
        while True:
            if named:
                name = self.expect("id").value
                opk = self.next().kind
                if opk not in ASSIGN_OPS:
                    raise self.fail("expected <==, <-- or = in named signal list")
                names.append((ASSIGN_OPS[opk], name))
            signals.append(self.parse_expression())
            if self.at(","):
                self.next()
                continue
            break
        self.expect(")")
        return signals, names


def parse_source(src: str, file_id: int, p: int, no_init: bool = False) -> FileAst:
    """Preprocess + tokenize + parse one file."""
    clean = preprocess(src, file_id)
    toks = tokenize(clean, file_id)
    return Parser(toks, file_id, p, no_init).parse_file()
