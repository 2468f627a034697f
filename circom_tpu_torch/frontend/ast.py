"""AST for the circom language.

Node inventory mirrors the reference's AST
(program_structure/src/abstract_syntax_tree/ast.rs:85-396): same statement,
expression, access and assign-op variants, so every construct the reference
front-end produces has a direct counterpart here.  Desugarings applied at
parse time (for->while, compound assigns, declaration splitting,
ast_shortcuts.rs:18-211) are reproduced in the parser.
"""

from dataclasses import dataclass, field
from enum import Enum
from typing import Optional


@dataclass(slots=True)
class Meta:
    file_id: int
    start: int
    end: int


class SignalType(Enum):
    INPUT = "input"
    OUTPUT = "output"
    INTERMEDIATE = "intermediate"


class AssignOp(Enum):
    VAR = "="            # AssignVar
    SIGNAL = "<--"       # AssignSignal
    CONSTRAINT = "<=="   # AssignConstraintSignal


# Infix opcodes, names as in ast.rs:368-390
MUL, DIV, ADD, SUB, POW, INTDIV, MOD = "*", "/", "+", "-", "**", "\\", "%"
SHL, SHR = "<<", ">>"
LEQ, GEQ, LT, GT, EQ, NEQ = "<=", ">=", "<", ">", "==", "!="
BOOL_OR, BOOL_AND = "||", "&&"
BIT_OR, BIT_AND, BIT_XOR = "|", "&", "^"
P_SUB, P_NOT, P_COMPLEMENT = "neg", "!", "~"


# ---------------------------------------------------------------------------
# variable types (ast.rs VariableType)
# ---------------------------------------------------------------------------
@dataclass(slots=True)
class VarType:
    kind: str                      # 'var' | 'signal' | 'component' | 'anonymous_component' | 'bus'
    signal_type: SignalType = SignalType.INTERMEDIATE
    tags: tuple = ()
    bus_name: str = ""             # for kind == 'bus'


# ---------------------------------------------------------------------------
# expressions
# ---------------------------------------------------------------------------
class Expr:
    __slots__ = ()


@dataclass(slots=True)
class Number(Expr):
    meta: Meta
    value: int                     # already reduced mod p (lang.lalrpop:760-764)


@dataclass(slots=True)
class ComponentAccess:
    name: str


@dataclass(slots=True)
class ArrayAccess:
    expr: Expr


@dataclass(slots=True)
class Variable(Expr):
    meta: Meta
    name: str
    access: list                   # of ComponentAccess | ArrayAccess


@dataclass(slots=True)
class Infix(Expr):
    meta: Meta
    lhe: Expr
    op: str
    rhe: Expr


@dataclass(slots=True)
class Prefix(Expr):
    meta: Meta
    op: str
    rhe: Expr


@dataclass(slots=True)
class TernarySwitch(Expr):         # InlineSwitchOp
    meta: Meta
    cond: Expr
    if_true: Expr
    if_false: Expr


@dataclass(slots=True)
class ParallelOp(Expr):
    meta: Meta
    rhe: Expr


@dataclass(slots=True)
class Call(Expr):
    meta: Meta
    id: str
    args: list


@dataclass(slots=True)
class BusCall(Expr):
    meta: Meta
    id: str
    args: list


@dataclass(slots=True)
class AnonymousComp(Expr):
    meta: Meta
    id: str
    is_parallel: bool
    params: list
    signals: list
    names: Optional[list]          # [(AssignOp, name)] when named-arg form


@dataclass(slots=True)
class ArrayInLine(Expr):
    meta: Meta
    values: list


@dataclass(slots=True)
class UniformArray(Expr):
    meta: Meta
    value: Expr
    dimension: Expr


@dataclass(slots=True)
class TupleExpr(Expr):
    meta: Meta
    values: list


# ---------------------------------------------------------------------------
# statements
# ---------------------------------------------------------------------------
class Stmt:
    __slots__ = ()


@dataclass(slots=True)
class IfThenElse(Stmt):
    meta: Meta
    cond: Expr
    if_case: Stmt
    else_case: Optional[Stmt]


@dataclass(slots=True)
class While(Stmt):
    meta: Meta
    cond: Expr
    stmt: Stmt


@dataclass(slots=True)
class Return(Stmt):
    meta: Meta
    value: Expr


@dataclass(slots=True)
class Declaration(Stmt):
    meta: Meta
    xtype: VarType
    name: str
    dimensions: list               # of Expr
    is_constant: bool = False


@dataclass(slots=True)
class InitializationBlock(Stmt):
    meta: Meta
    xtype: VarType
    initializations: list          # of Stmt


@dataclass(slots=True)
class Substitution(Stmt):
    meta: Meta
    var: str
    access: list
    op: AssignOp
    rhe: Expr


@dataclass(slots=True)
class MultSubstitution(Stmt):      # tuple / anonymous-comp LHS; removed by sugar pass
    meta: Meta
    lhe: Expr
    op: AssignOp
    rhe: Expr


@dataclass(slots=True)
class UnderscoreSubstitution(Stmt):
    meta: Meta
    op: AssignOp
    rhe: Expr


@dataclass(slots=True)
class ConstraintEquality(Stmt):
    meta: Meta
    lhe: Expr
    rhe: Expr


@dataclass(slots=True)
class LogStr:
    string: str


@dataclass(slots=True)
class LogExp:
    expr: Expr


@dataclass(slots=True)
class LogCall(Stmt):
    meta: Meta
    args: list                     # of LogStr | LogExp


@dataclass(slots=True)
class Assert(Stmt):
    meta: Meta
    arg: Expr


@dataclass(slots=True)
class Block(Stmt):
    meta: Meta
    stmts: list


@dataclass(slots=True)
class AnonymousCompStmt(Stmt):     # `Foo(a)(b);` as a bare statement
    meta: Meta
    expr: Expr


# ---------------------------------------------------------------------------
# definitions & file AST
# ---------------------------------------------------------------------------
@dataclass(slots=True)
class Template:
    meta: Meta
    name: str
    args: list
    body: Stmt
    parallel: bool = False
    is_custom_gate: bool = False
    is_extern_c: bool = False


@dataclass(slots=True)
class Function:
    meta: Meta
    name: str
    args: list
    body: Stmt


@dataclass(slots=True)
class BusDef:
    meta: Meta
    name: str
    args: list
    body: Stmt


@dataclass(slots=True)
class MainComponent:
    public: list
    call: Expr


@dataclass(slots=True)
class FileAst:
    file_id: int
    version: Optional[tuple]       # (major, minor, patch) from pragma
    custom_gates: bool
    includes: list
    definitions: list              # of Template | Function | BusDef
    main: Optional[MainComponent]
