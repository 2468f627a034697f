"""Circuit executor: abstract interpretation of the typed AST.

Python counterpart of the reference's constraint_generation/src/execute.rs
(4.4k LoC): one interpreter drives three value domains:

* ``constrain``  — inputs are symbolic; emits R1CS constraints, memoizes
  template instances by (template, params, input tags)
  (executed_program.rs:37-49), and builds the DAG with
  reference-identical signal numbering (executed_template.rs:246-362).
* ``hostwit``    — concrete Python-int inputs; computes every signal
  (the host witness calculator, semantics of the emitted WASM/C++
  runtimes incl. sanity checks).
* ``tape``       — inputs are tape refs; flattens the whole witness
  computation into a straight-line field-op tape for the TPU backend
  (replaces compiler/src/ + code_producers/ codegen).

Component protocol follows the reference: bodies execute at instantiation
time (inputs symbolic, execute.rs:1795-1875) in constrain mode, and at
last-input-assigned time in witness modes (the compile-time equivalent of
the inputCounter protocol, store_bucket.rs:660-780).
"""

from ..field.hostfield import FieldArithmeticError, HostField
from ..frontend import ast as A
from ..utils.reports import Report
from . import algebra as alg
from .algebra import AExpr, NQ, NonQuadratic
from .dag import DAG
from .values import (BusClosure, BusLayout, ComponentState, ExecError,
                     SignalDecl, Slice, TemplateClosure, err, indexed_names)
from ..backend.tape import Tape, TapeRef


class FunctionReturn(Exception):
    def __init__(self, value):
        self.value = value


# The tape-recipe codec (_record_tape_recipe/_replay_tape_recipe) encodes
# SignalDecl and ComponentState field-by-field.  If a slot is added to
# either class without teaching the codec about it, replayed instances
# would silently lack it (the round-3 `value_defined` trap) — fail loudly
# at import time instead.
_RECIPE_SIGNALDECL_SLOTS = frozenset((
    "name", "dims", "xtype", "tags", "tag_values", "slice", "assigned",
    "layout", "elem_names", "value_defined"))
_RECIPE_COMPONENTSTATE_SLOTS = frozenset((
    "template", "params", "is_parallel", "label", "node_id", "signals",
    "inputs_remaining", "executed", "instantiated", "input_tag_values",
    "child_instances", "meta_name", "pending_inputs", "is_anonymous"))
assert frozenset(SignalDecl.__slots__) == _RECIPE_SIGNALDECL_SLOTS, \
    "SignalDecl slots changed: update the tape-recipe codec " \
    "(_record_tape_recipe/_replay_tape_recipe) and this guard"
assert frozenset(ComponentState.__slots__) == _RECIPE_COMPONENTSTATE_SLOTS, \
    "ComponentState slots changed: update the tape-recipe codec " \
    "(_record_tape_recipe/_replay_tape_recipe) and this guard"


# extern_c custom-gate implementations: the TPU-native analog of the
# reference's external C linkage (templates-and-components.md:204-222).
# register_extern("A", fn) with fn(params, inputs) -> {output: value}.
EXTERN_IMPLS = {}


def register_extern(name, fn):
    EXTERN_IMPLS[name] = fn


class PendingBus:
    """Bus wire declared, awaiting its BusCall substitution for the layout
    (parser splits `Point p;` into Declaration + `p = Point()`)."""

    __slots__ = ("name", "dims", "xtype", "tags")

    def __init__(self, name, dims, xtype, tags):
        self.name = name
        self.dims = dims
        self.xtype = xtype
        self.tags = tags


# ---------------------------------------------------------------------------
# value domains
# ---------------------------------------------------------------------------
class ConstrainDomain:
    """Values are AExpr | NQ (algebra.rs ArithmeticExpression ops)."""

    def __init__(self, hf: HostField):
        self.hf = hf

    def const(self, v):
        return AExpr.number(v % self.hf.p)

    def known_int(self, v):
        if isinstance(v, AExpr) and v.is_number():
            return v.c
        return None

    def as_cond(self, v):
        k = self.known_int(v)
        return None if k is None else self.hf.as_bool(k)

    def values_equal(self, a, b):
        if isinstance(a, NonQuadratic) or isinstance(b, NonQuadratic):
            return False
        if a.kind != b.kind:
            return False
        if a.kind == "number":
            return a.c == b.c
        if a.kind == "signal":
            return a.sig == b.sig
        return False

    def select(self, cond, a, b):
        return a if self.values_equal(a, b) else NQ

    def infix(self, op, l, r, meta):
        hf = self.hf
        lk, rk = self.known_int(l), self.known_int(r)
        if lk is not None and rk is not None:
            try:
                return AExpr.number(_host_infix(hf, op, lk, rk))
            except FieldArithmeticError as e:
                raise err(str(e), "T3001", meta)
        if op == A.ADD:
            return alg.add(l, r, hf)
        if op == A.SUB:
            return alg.sub(l, r, hf)
        if op == A.MUL:
            return alg.mul(l, r, hf)
        if op == A.DIV and rk is not None:
            if rk == 0:
                raise err("division by zero", "T3001", meta)
            return alg.mul(l, AExpr.number(hf.inv(rk)), hf)
        return NQ  # any other op over unknowns is non-quadratic

    def prefix(self, op, v, meta):
        hf = self.hf
        k = self.known_int(v)
        if k is not None:
            return AExpr.number(_host_prefix(hf, op, k))
        if op == A.P_SUB:
            return alg.neg(v, hf)
        return NQ


class HostWitDomain:
    """Values are canonical Python ints; full reference arithmetic."""

    def __init__(self, hf: HostField):
        self.hf = hf

    def const(self, v):
        return v % self.hf.p

    def known_int(self, v):
        return v

    def as_cond(self, v):
        return self.hf.as_bool(v)

    def select(self, cond, a, b):
        return a if self.hf.as_bool(cond) else b

    def infix(self, op, l, r, meta):
        try:
            return _host_infix(self.hf, op, l, r)
        except FieldArithmeticError as e:
            raise err(str(e), "T3001", meta)

    def prefix(self, op, v, meta):
        return _host_prefix(self.hf, op, v)


class TapeDomain:
    """Values are int (compile-time-known) or TapeRef; ops fold or emit."""

    def __init__(self, hf: HostField, tape: Tape):
        self.hf = hf
        self.tape = tape

    def const(self, v):
        return v % self.hf.p

    def known_int(self, v):
        return v if isinstance(v, int) else None

    def as_cond(self, v):
        return self.hf.as_bool(v) if isinstance(v, int) else None

    def ref(self, v):
        return self.tape.const(v) if isinstance(v, int) else v

    def select(self, cond, a, b):
        if isinstance(a, int) and isinstance(b, int) and a == b:
            return a
        if isinstance(a, TapeRef) and isinstance(b, TapeRef) and a.id == b.id:
            return a
        if isinstance(cond, int):
            return a if self.hf.as_bool(cond) else b
        return self.tape.emit("select", self.ref(cond), self.ref(a), self.ref(b))

    def infix(self, op, l, r, meta):
        hf = self.hf
        if isinstance(l, int) and isinstance(r, int):
            try:
                return _host_infix(hf, op, l, r)
            except FieldArithmeticError as e:
                raise err(str(e), "T3001", meta)
        t = self.tape
        if op in (A.SHL, A.SHR):
            k = self.known_int(r)
            if k is not None:
                # wrap-normalize (modular_arithmetic.rs:111-136)
                opc = "shl_k" if op == A.SHL else "shr_k"
                if k > hf.half:
                    k = hf.p - k
                    opc = "shr_k" if opc == "shl_k" else "shl_k"
                if k >= hf.bits:
                    return 0
                return t.emit(opc, self.ref(l), imm=k)
            return t.emit("shl" if op == A.SHL else "shr", self.ref(l), self.ref(r))
        if op == A.POW:
            k = self.known_int(r)
            if k is not None:
                if k == 0:
                    return 1
                if k <= 64:  # lower small exponents to a multiply chain
                    base = self.ref(l)
                    acc = None
                    for bit in bin(k)[2:]:
                        acc = base if acc is None else t.emit("mul", acc, acc)
                        if bit == "1" and acc is not base:
                            acc = t.emit("mul", acc, base)
                    return acc
                return t.emit("pow_k", self.ref(l), imm=k)
            return t.emit("pow", self.ref(l), self.ref(r))
        if op == A.INTDIV:
            k = self.known_int(r)
            if k is not None and k > 0 and (k & (k - 1)) == 0:
                sh = k.bit_length() - 1
                return t.emit("shr_k", self.ref(l), imm=sh) if sh else l
            return t.emit("idiv", self.ref(l), self.ref(r))
        if op == A.MOD:
            k = self.known_int(r)
            if k is not None and k > 0 and (k & (k - 1)) == 0:
                return t.emit("band", self.ref(l), t.const(k - 1))
            return t.emit("mod", self.ref(l), self.ref(r))
        opc = _TAPE_OPC[op]
        return t.emit(opc, self.ref(l), self.ref(r))

    def prefix(self, op, v, meta):
        if isinstance(v, int):
            return _host_prefix(self.hf, op, v)
        opc = {"neg": "neg", A.P_NOT: "lnot", A.P_COMPLEMENT: "bnot"}[op]
        return self.tape.emit(opc, v)


_TAPE_OPC = {
    A.MUL: "mul", A.DIV: "div", A.ADD: "add", A.SUB: "sub",
    A.LEQ: "le", A.GEQ: "ge", A.LT: "lt", A.GT: "gt",
    A.EQ: "eq", A.NEQ: "neq", A.BOOL_OR: "lor", A.BOOL_AND: "land",
    A.BIT_OR: "bor", A.BIT_AND: "band", A.BIT_XOR: "bxor",
}


def _host_infix(hf: HostField, op, l, r):
    if op == A.MUL:
        return hf.mul(l, r)
    if op == A.ADD:
        return hf.add(l, r)
    if op == A.SUB:
        return hf.sub(l, r)
    if op == A.DIV:
        return hf.div(l, r)
    if op == A.POW:
        return hf.pow(l, r)
    if op == A.INTDIV:
        return hf.idiv(l, r)
    if op == A.MOD:
        return hf.mod(l, r)
    if op == A.SHL:
        return hf.shift_l(l, r)
    if op == A.SHR:
        return hf.shift_r(l, r)
    if op == A.LEQ:
        return hf.lesser_eq(l, r)
    if op == A.GEQ:
        return hf.greater_eq(l, r)
    if op == A.LT:
        return hf.lesser(l, r)
    if op == A.GT:
        return hf.greater(l, r)
    if op == A.EQ:
        return hf.eq(l, r)
    if op == A.NEQ:
        return hf.not_eq(l, r)
    if op == A.BOOL_OR:
        return hf.bool_or(l, r)
    if op == A.BOOL_AND:
        return hf.bool_and(l, r)
    if op == A.BIT_OR:
        return hf.bit_or(l, r)
    if op == A.BIT_AND:
        return hf.bit_and(l, r)
    if op == A.BIT_XOR:
        return hf.bit_xor(l, r)
    raise ValueError(f"unknown infix op {op}")


def _host_prefix(hf: HostField, op, v):
    if op == A.P_SUB:
        return hf.neg(v)
    if op == A.P_NOT:
        return hf.bool_not(v)
    if op == A.P_COMPLEMENT:
        return hf.complement(v)
    raise ValueError(f"unknown prefix op {op}")


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------
class InstanceBuilder:
    """Accumulates one template instance (ExecutedTemplate analog)."""

    __slots__ = ("template", "params", "wire_order", "constraints",
                 "connexions", "underscored", "components", "public_inputs",
                 "tag_exports")

    def __init__(self, template, params, public_inputs=()):
        self.template = template
        self.params = params
        self.wire_order = []       # SignalDecl in declaration order
        self.constraints = []      # over indexed names
        self.connexions = []       # (name, idx_tuple, label, node_id, is_parallel)
        self.underscored = []      # names
        self.components = []       # (name, dims)
        self.public_inputs = set(public_inputs)
        self.tag_exports = {}      # signal name -> {tag: value}


class Frame:
    __slots__ = ("kind", "scopes", "signals", "components", "builder",
                 "instance", "unknown_depth", "preset_inputs", "caller_meta",
                 "name", "preset_input_tags")

    def __init__(self, kind, name=""):
        self.kind = kind          # 'template' | 'function'
        self.name = name
        self.scopes = [{}]        # var name -> Slice
        self.signals = {}         # name -> SignalDecl
        self.components = {}      # name -> Slice of ComponentState|None
        self.builder = None       # InstanceBuilder (constrain)
        self.instance = None      # ComponentState (witness modes)
        self.unknown_depth = 0
        self.preset_inputs = None  # name -> Slice of values
        self.preset_input_tags = {}  # input name -> {tag: value}

    def declare_var(self, name, slc):
        self.scopes[-1][name] = slc

    def lookup_var(self, name):
        for s in reversed(self.scopes):
            if name in s:
                return s[name]
        return None


class Executor:
    def __init__(self, archive, mode: str, tape: Tape = None,
                 dag: DAG = None, memo: dict = None, sanity_check: int = 2,
                 log_sink=None, verbose: bool = False,
                 while_max_unroll: int = 64):
        from ..field.primes import FieldSpec

        self.archive = archive
        self.hf = HostField(FieldSpec(archive.prime, archive.field_p))
        self.mode = mode
        self.tape = tape
        if mode == "constrain":
            self.domain = ConstrainDomain(self.hf)
        elif mode == "hostwit":
            self.domain = HostWitDomain(self.hf)
        elif mode == "tape":
            self.domain = TapeDomain(self.hf, tape)
        else:
            raise ValueError(mode)
        self.dag = dag if dag is not None else DAG(archive.prime)
        self.memo = memo if memo is not None else {}
        self.sanity_check = sanity_check
        self.log_sink = log_sink if log_sink is not None else []
        self.verbose = verbose
        self.while_max_unroll = while_max_unroll
        self.tape_guards = []          # active-flags of unrolled whiles
        self.instances_by_path = {}    # witness modes: path -> ComponentState
        # tape mode: (node_id, const-input pattern) -> replayable recipe
        # (False = recorded as non-memoizable).  The tape analog of the
        # reference compiling each unique template instance ONCE
        # (executed_program.rs identify_node): identical instances fed
        # symbolic inputs emit identical SSA fragments, so the body is
        # interpreted once and replayed by node-id substitution after.
        self.tape_memo = {}
        self.bus_memo = {}             # (bus, params) -> BusLayout
        # per-component-instance record of which assignment SCOPES ran
        # the strict input-tag check: {id(cs): {sig: set(field_path)}}
        # — the analog of the reference's unassigned_tags drain
        # (component_representation.rs:17,719-723): a tag whose level
        # was never covered by an assignment is an unfulfilled
        # obligation even when every LEAF got assigned field-wise
        self._tag_cover = {}
        self.warnings = []

    # -- entry points ---------------------------------------------------
    def run_constrain(self):
        """Execute the main call -> populated DAG (pass 1)."""
        call = self.archive.main.call
        if not isinstance(call, A.Call):
            raise err("main component must be a template call", "T2063",
                      getattr(call, "meta", None))
        params = [self._expect_known_arg(
                      self._eval(a, self._dummy_frame()), a.meta)
                  for a in call.args]
        node_id = self.execute_template(
            call.id, params, {}, public=self.archive.main.public,
            meta=call.meta,
        )
        return node_id

    def run_witness(self, input_values: dict):
        """Execute main with concrete/tape inputs (pass 2).

        input_values: input signal name -> int | Slice | list (row-major).
        Returns the root ComponentState; instances_by_path maps DAG paths.
        """
        call = self.archive.main.call
        params = [self._expect_known_arg(self._eval(a, self._dummy_frame()))
                  for a in call.args]
        root = ComponentState()
        root.template = call.id
        root.params = params
        root.label = "main"
        key = self._memo_key(call.id, params, {})
        root.node_id = self.memo.get(key)
        self.instances_by_path["main"] = root
        self._run_witness_body(root, input_values, "main")
        return root

    def _dummy_frame(self):
        f = Frame("function", "<main>")
        return f

    def _expect_known_arg(self, v, meta=None):
        if isinstance(v, Slice):
            return Slice(v.dims,
                         [self._expect_known_arg(x, meta)
                          for x in v.values])
        if isinstance(v, (TemplateClosure, BusClosure)):
            # InvalidArgumentInCall (error_code.rs T2029)
            raise err("template or bus instances cannot be used as "
                      "arguments", "T2029", meta)
        k = self.domain.known_int(v)
        if k is None:
            raise err("main parameters must be constants", "T20464",
                      meta)
        return k

    # -- memoization key ------------------------------------------------
    def _memo_key(self, template, params, input_tags):
        def freeze(v):
            if isinstance(v, Slice):
                return (v.dims, tuple(freeze(x) for x in v.values))
            return v

        tag_key = tuple(sorted(
            (s, t, val) for s, tags in input_tags.items()
            for t, val in tags.items()
        ))
        return (template, tuple(freeze(p) for p in params), tag_key)

    # ==================================================================
    # pass 1: constrain-mode template execution
    # ==================================================================
    def execute_template(self, name, params, input_tags, public=(), meta=None):
        """Execute (or reuse) a template instance; returns DAG node id."""
        if name not in self.archive.templates:
            raise err(f"unknown template '{name}'", "T20461", meta)
        key = self._memo_key(name, params, input_tags)
        hit = self.memo.get(key)
        if hit is not None:
            return hit
        tmpl = self.archive.templates[name]
        if len(params) != len(tmpl.args):
            raise err(
                f"template {name} expects {len(tmpl.args)} parameters, "
                f"got {len(params)}", "T20465", meta,
            )
        frame = Frame("template", name)
        frame.builder = InstanceBuilder(name, params, public)
        frame.preset_input_tags = dict(input_tags)
        for argname, value in zip(tmpl.args, params):
            frame.declare_var(argname, _as_slice(self._to_domain(value)))
        self._exec_stmt(tmpl.body, frame)
        self._check_components_fed(frame, meta)
        node_id = self._insert_in_dag(frame, tmpl)
        self.memo[key] = node_id
        return node_id

    def _to_domain(self, v):
        if isinstance(v, Slice):
            return Slice(v.dims, [self._to_domain(x) for x in v.values])
        if isinstance(v, int):
            return self.domain.const(v)
        return v

    def _check_components_fed(self, frame, meta):
        for cname, cslice in frame.components.items():
            for cs in cslice.values:
                if cs is not None and cs.instantiated and cs.inputs_remaining > 0:
                    raise err(
                        f"component '{cname}' has unassigned inputs "
                        f"({cs.inputs_remaining} left)", "T20466", meta,
                    )

    def _insert_in_dag(self, frame, tmpl):
        """ExecutedTemplate::insert_in_dag (executed_template.rs:246-362):
        wires in outputs / public inputs / private inputs / intermediates
        order, then sorted connexion edges, then constraints."""
        b = frame.builder
        node_id = self.dag.add_node(
            tmpl.name, _flatten_params(b.params), tmpl.parallel,
            tmpl.is_custom_gate,
        )
        node = self.dag.nodes[node_id]
        node.id_to_elem = {}
        wires = b.wire_order

        def _add(w, adder):
            for j, n in enumerate(w.elem_names):
                sid = adder(n)
                node.id_to_elem[sid] = (w.name, j)

        for w in wires:
            if w.xtype == A.SignalType.OUTPUT:
                _add(w, node.add_output)
        for w in wires:
            if w.xtype == A.SignalType.INPUT and w.name in b.public_inputs:
                _add(w, lambda n: node.add_input(n, True))
        for w in wires:
            if w.xtype == A.SignalType.INPUT and w.name not in b.public_inputs:
                _add(w, lambda n: node.add_input(n, False))
        for w in wires:
            if w.xtype == A.SignalType.INTERMEDIATE:
                _add(w, node.add_intermediate)
        node.wire_info = [
            (w.name, w.dims, w.xtype, dict(w.tag_values), w.layout)
            for w in wires
        ]
        node.tag_exports = b.tag_exports
        # connexions sorted by (name, indices) (executed_template.rs:313-320)
        for (_cname, _idx, label, child_id, is_par) in sorted(
            b.connexions, key=lambda c: (c[0], c[1])
        ):
            self.dag.add_edge(child_id, label, is_par)
        node.number_of_subcomponents_indexes = sum(
            _size_of(dims) for (_n, dims) in b.components
        )
        corr = node.signal_correspondence
        for c in b.constraints:
            node.constraints.append(_map_constraint(c, corr))
        for uname in b.underscored:
            sid = corr.get(uname)
            if sid is not None:
                node.underscored_signals.append(sid)
        return node_id

    # ==================================================================
    # pass 2: witness-mode execution
    # ==================================================================
    def _apply_extern_impl(self, child, cs, impl, inputs):
        """extern_c linkage (reference templates-and-components.md:204-222,
        c_code_generator.rs:514): a registered host implementation is the
        authority for the gate's outputs.  ``impl(params, inputs) ->
        {output_name: int | flat list}`` with canonical ints."""
        in_vals = {}
        for name, slc in inputs.items():
            vals = list(slc.values)
            in_vals[name] = vals[0] if len(vals) == 1 else vals
        outs = impl(list(cs.params), in_vals)
        for name, v in outs.items():
            decl = child.signals.get(name)
            if decl is None or decl.xtype != A.SignalType.OUTPUT:
                raise err(
                    f"extern_c implementation of '{cs.template}' returned "
                    f"unknown output '{name}'", "T2038", None)
            vals = v if isinstance(v, (list, tuple)) else [v]
            if len(vals) != len(decl.slice.values):
                raise err(
                    f"extern_c output '{name}' size mismatch", "T2045",
                    None)
            decl.slice.values[:] = [int(x) % self.hf.p for x in vals]
            decl.assigned.values[:] = [True] * len(vals)

    def _apply_extern_tape(self, child, cs, inputs):
        """Tape-mode extern_c: the gate's outputs become fresh tape
        input slots, and the call recipe (input node ids per signal,
        output slot indices) is recorded in ``tape.extern_calls`` for
        the host-side splice at run time."""
        in_desc = {}
        for name, slc in inputs.items():
            elems = []
            for v in slc.values:
                if isinstance(v, int):
                    elems.append(("const", v))
                else:
                    elems.append(("node", v.id))
            in_desc[name] = elems
        out_slots = {}
        for name, decl in child.signals.items():
            if decl.xtype != A.SignalType.OUTPUT:
                continue
            slots = []
            for j in range(len(decl.slice.values)):
                idx = self.tape.n_inputs
                decl.slice.values[j] = self.tape.input(idx)
                decl.assigned.values[j] = True
                slots.append(idx)
            out_slots[name] = slots
        self.tape.extern_calls.append({
            "template": cs.template,
            "params": list(cs.params),
            "inputs": in_desc,
            "out_slots": out_slots,
        })

    def _run_witness_body(self, inst: ComponentState, input_values, path):
        tmpl = self.archive.templates[inst.template]
        frame = Frame("template", inst.template)
        frame.instance = inst
        frame.preset_inputs = self._prepare_inputs(inst, input_values, tmpl)
        if inst.node_id is not None:
            node = self.dag.nodes[inst.node_id]
            for (wname, _d, xtype, tagvals, _l) in node.wire_info:
                if xtype == A.SignalType.INPUT and tagvals:
                    frame.preset_input_tags[wname] = dict(tagvals)
        for argname, value in zip(tmpl.args, inst.params):
            frame.declare_var(argname, _as_slice(self._to_domain(value)))
        self._witness_path = path
        self._exec_stmt(tmpl.body, frame)
        inst.executed = True
        # expose declared signals on the instance for witness assembly
        inst.signals = frame.signals

    def _prepare_inputs(self, inst, input_values, tmpl):
        """Normalize user/parent input values to name -> Slice."""
        if input_values is None:
            return {}
        out = {}
        for name, v in input_values.items():
            if isinstance(v, Slice):
                out[name] = v
            elif isinstance(v, (list, tuple)):
                out[name] = _nested_to_slice(v)
            else:
                out[name] = Slice.scalar(v)
        return out

    # ==================================================================
    # statement execution
    # ==================================================================
    def _exec_stmt(self, s, frame):
        m = getattr(s, "meta", None)
        if type(s) is A.Block:
            frame.scopes.append({})
            try:
                for st in s.stmts:
                    self._exec_stmt(st, frame)
            finally:
                frame.scopes.pop()
        elif type(s) is A.InitializationBlock:
            for st in s.initializations:
                self._exec_stmt(st, frame)
        elif type(s) is A.Declaration:
            self._exec_declaration(s, frame)
        elif type(s) is A.Substitution:
            self._exec_substitution(s, frame)
        elif type(s) is A.ConstraintEquality:
            self._exec_constraint_eq(s, frame)
        elif type(s) is A.IfThenElse:
            self._exec_if(s, frame)
        elif type(s) is A.While:
            self._exec_while(s, frame)
        elif type(s) is A.Return:
            raise FunctionReturn(self._eval(s.value, frame))
        elif type(s) is A.LogCall:
            self._exec_log(s, frame)
        elif type(s) is A.Assert:
            self._exec_assert(s, frame)
        elif type(s) is A.MultSubstitution:
            raise err("tuples/anonymous components not yet desugared",
                      "TAC02", m)
        elif type(s) is A.AnonymousCompStmt:
            raise err("anonymous components not yet desugared", "TAC01", m)
        elif type(s) is A.UnderscoreSubstitution:
            parts = (s.rhe.values if isinstance(s.rhe, A.TupleExpr)
                     else [s.rhe])
            for part in parts:
                v = self._eval(part, frame)
                self._record_underscore(v, frame)
        else:
            raise err(f"unsupported statement {type(s).__name__}", "T2038", m)

    def _exec_declaration(self, s: A.Declaration, frame):
        kind = s.xtype.kind
        if kind == "anonymous_component":
            dims = []  # loop-counter dimension: sized on use
        else:
            dims = [self._index_value(self._eval(d, frame), d.meta,
                                      what="size")
                    for d in s.dimensions]
        for d in dims:
            if d > (1 << 32):
                # InvalidArraySize T2033 / InvalidArraySizeB T2053:
                # negative sizes arrive as huge canonical values
                raise err(
                    f"invalid array size (negative or too big: {d})",
                    "T2053" if kind == "bus" else "T2033", s.meta)
        if kind == "var":
            frame.declare_var(s.name, Slice.filled(dims, None))
            return
        if frame.kind != "template":
            raise err("signals/components only allowed in templates",
                      "T2016", s.meta)
        if frame.unknown_depth:
            raise err("declaration inside unknown condition", "T2050", s.meta)
        if kind == "signal":
            decl = SignalDecl(s.name, dims, s.xtype.signal_type, s.xtype.tags)
            if (s.xtype.signal_type == A.SignalType.INPUT
                    and s.name in frame.preset_input_tags):
                for t, v in frame.preset_input_tags[s.name].items():
                    if t in decl.tag_values:
                        decl.tag_values[t] = v
            frame.signals[s.name] = decl
            if frame.builder is not None:
                frame.builder.wire_order.append(decl)
            if (
                frame.instance is not None
                and s.xtype.signal_type == A.SignalType.INPUT
            ):
                self._install_input_values(s.name, decl, frame, s.meta)
            return
        if kind == "bus":
            frame.signals[s.name] = PendingBus(
                s.name, tuple(dims), s.xtype.signal_type, s.xtype.tags)
            return
        if kind == "component":
            frame.components[s.name] = Slice.filled(dims, None)
            if frame.builder is not None:
                frame.builder.components.append((s.name, tuple(dims)))
            return
        if kind == "anonymous_component":
            # dimension is the loop counter; sized dynamically
            from .values import DynamicComponentSlice

            frame.components[s.name] = DynamicComponentSlice()
            if frame.builder is not None:
                frame.builder.components.append((s.name, ()))
            return
        raise err(f"unsupported declaration kind '{kind}'", "T2038", s.meta)

    def _install_input_values(self, s_name, decl, frame, meta=None):
        """Witness modes: input wires get their values at declaration.
        Stored flat (leaf order); nested input lists are flattened."""
        preset = frame.preset_inputs or {}
        if s_name not in preset:
            raise err(f"missing value for input signal '{s_name}'",
                      "T3011", meta)
        src = preset[s_name]
        vals = list(src.values) if isinstance(src, Slice) else [src]
        if len(vals) != decl.total_size():
            raise err(
                f"input '{s_name}' size mismatch: expected "
                f"{decl.total_size()} elements, got {len(vals)}",
                "T2044", meta,
            )
        decl.slice = Slice((len(vals),), vals)
        decl.assigned = Slice((len(vals),), [True] * len(vals))

    # -- assignment ------------------------------------------------------
    def _exec_substitution(self, s: A.Substitution, frame):
        if s.var == "_":
            parts = (s.rhe.values if isinstance(s.rhe, A.TupleExpr)
                     else [s.rhe])
            for part in parts:
                v = self._eval(part, frame)
                self._record_underscore(v, frame)
            return
        target = self._resolve_symbol(s.var, frame, s.meta)
        if target[0] == "var":
            self._assign_var(s, frame)
        elif target[0] == "signal" and isinstance(target[1], PendingBus):
            if s.access or s.op != A.AssignOp.VAR:
                raise err(f"bus '{s.var}' used before its type is set",
                          "BU06", s.meta)
            v = self._eval(s.rhe, frame)
            if isinstance(v, BusClosure):
                self._complete_bus_decl(target[1], v, frame, s.meta)
            elif isinstance(v, Slice) and all(
                isinstance(x, BusClosure) for x in v.values
            ):
                # UniformArray of bus calls from declaration splitting
                self._complete_bus_decl(target[1], v.values[0], frame,
                                        s.meta)
            else:
                if isinstance(v, TemplateClosure):
                    # InvalidArgumentInBusInstantiationB (BU03)
                    raise err("buses cannot be assigned template calls",
                              "BU03", s.meta)
                raise err("bus must be initialized with a bus call",
                          "BU06", s.meta)
        elif target[0] == "signal":
            self._assign_signal(s, target[1], frame)
        elif target[0] == "component":
            self._assign_component(s, target[1], frame)
        else:
            raise err(f"cannot assign to '{s.var}'", "T2038", s.meta)

    def _resolve_symbol(self, name, frame, meta):
        if name in frame.signals:
            return ("signal", frame.signals[name])
        if name in frame.components:
            return ("component", frame.components[name])
        v = frame.lookup_var(name)
        if v is not None:
            return ("var", v)
        raise err(f"undeclared symbol '{name}'", "T2021", meta)

    def _bus_layout(self, name, params, meta):
        """Execute a bus body's declarations -> BusLayout (memoized by
        (bus, params), like ExecutedBus instances)."""
        def freeze(v):
            if isinstance(v, Slice):
                return (v.dims, tuple(freeze(x) for x in v.values))
            return v

        key = (name, tuple(freeze(x) for x in params))
        hit = self.bus_memo.get(key)
        if hit is not None:
            return hit
        bus = self.archive.buses.get(name)
        if bus is None:
            raise err(f"unknown bus '{name}'", "T20467", meta)
        if len(params) != len(bus.args):
            raise err(
                f"bus {name} expects {len(bus.args)} parameters, got "
                f"{len(params)}", "BU01", meta,
            )
        frame = Frame("function", name)
        for argname, value in zip(bus.args, params):
            frame.declare_var(argname, _as_slice(self._to_domain(value)))
        fields = []
        pending = {}
        field_tags = {}  # per-field declared tags (TagWire recursion)

        def walk(st):
            if isinstance(st, A.Block):
                for x in st.stmts:
                    walk(x)
            elif isinstance(st, A.InitializationBlock):
                for x in st.initializations:
                    walk(x)
            elif isinstance(st, A.Declaration):
                dims = [self._index_value(self._eval(d, frame), st.meta,
                                          what="size")
                        for d in st.dimensions]
                if st.xtype.tags:
                    field_tags[st.name] = tuple(st.xtype.tags)
                if st.xtype.kind == "signal":
                    fields.append((st.name, tuple(dims), None))
                elif st.xtype.kind == "bus":
                    pending[st.name] = tuple(dims)
                elif st.xtype.kind == "var":
                    frame.declare_var(st.name, Slice.filled(dims, None))
                else:
                    raise err("buses may only declare signals and buses",
                              "T2052", st.meta)
            elif isinstance(st, A.Substitution):
                v = self._eval(st.rhe, frame)
                if isinstance(v, BusClosure) and st.var in pending:
                    sub = self._bus_layout(v.name, v.params, st.meta)
                    fields.append((st.var, pending.pop(st.var), sub))
                elif st.var in pending:
                    raise err("bus field must be a bus call", "BU06",
                              st.meta)
                else:
                    slc = frame.lookup_var(st.var)
                    if slc is None:
                        raise err("buses may only declare signals and "
                                  "buses", "T2052", st.meta)
                    slc.set([], v, st.meta)
            elif isinstance(st, (A.While, A.IfThenElse)):
                raise err("control flow not supported in bus bodies",
                          "T2052", st.meta)

        walk(bus.body)
        layout = BusLayout(name, key[1], fields, field_tags)
        self.bus_memo[key] = layout
        return layout

    def _complete_bus_decl(self, pending: "PendingBus", closure: BusClosure,
                           frame, meta):
        layout = self._bus_layout(closure.name, closure.params, meta)
        decl = SignalDecl(pending.name, pending.dims, pending.xtype,
                          pending.tags, layout)
        if (pending.xtype == A.SignalType.INPUT
                and pending.name in frame.preset_input_tags):
            # caller-supplied tag values (wire-level AND dotted field
            # paths) preset the input bus's tags, like scalar signals
            for t, v in frame.preset_input_tags[pending.name].items():
                if t in decl.tag_values:
                    decl.tag_values[t] = v
        frame.signals[pending.name] = decl
        if frame.builder is not None:
            frame.builder.wire_order.append(decl)
        if (frame.instance is not None
                and pending.xtype == A.SignalType.INPUT):
            self._install_input_values(pending.name, decl, frame, meta)
        return decl

    def _resolve_wire(self, decl: SignalDecl, access, frame, meta,
                      start_i=0):
        """Resolve an access path on a (possibly bus) wire.

        Returns ('tag', tag_name) or ('range', start, count).
        """
        if not access and decl.layout is None and not decl.dims:
            return ("range", 0, 1)  # scalar signal, no access (common)
        i = start_i
        layout = decl.layout
        dims = list(decl.dims)
        unit = layout.size if layout is not None else 1
        start = 0
        fpath = []  # descended bus-field names (dotted tag paths)
        while True:
            idxs = []
            while i < len(access) and isinstance(access[i], A.ArrayAccess):
                idxs.append(self._index_value(
                    self._eval(access[i].expr, frame), meta))
                i += 1
            if len(idxs) > len(dims):
                raise err("too many array indices", "T2032", meta)
            for k, ix in enumerate(idxs):
                if not (0 <= ix < dims[k]):
                    raise err(
                        f"index {ix} out of bounds (size {dims[k]})",
                        "T3001", meta,
                    )
            stride = unit
            for d in dims[len(idxs):]:
                stride *= d
            # row-major offset of the partial index
            for k in range(len(idxs) - 1, -1, -1):
                start += idxs[k] * stride
                stride *= dims[k]
            dims = dims[len(idxs):]
            if i < len(access) and isinstance(access[i], A.ComponentAccess):
                fname = access[i].name
                if layout is not None and layout.field(fname) is not None:
                    if dims:
                        raise err(
                            "bus array must be fully indexed before field "
                            "access", "T2032", meta,
                        )
                    off, _n, fdims, fsub = layout.field(fname)
                    start += off
                    dims = list(fdims)
                    layout = fsub
                    unit = fsub.size if fsub is not None else 1
                    fpath.append(fname)
                    i += 1
                    continue
                tagpath = ".".join(fpath + [fname])
                if tagpath in decl.tag_values and i == len(access) - 1:
                    return ("tag", tagpath)
                raise err(
                    f"'{fname}' is not a field or tag of '{decl.name}'",
                    "BU04", meta,
                )
            break
        if i != len(access):
            raise err("unsupported access pattern", "T2032", meta)
        count = unit
        for d in dims:
            count *= d
        return ("range", start, count)

    def _assign_var(self, s, frame):
        if s.op != A.AssignOp.VAR:
            # WrongTypesInAssignOperationOperatorNoSignal (T2055)
            raise err("vars must be assigned with =, not <-- or <==",
                      "T2055", s.meta)
        slc = frame.lookup_var(s.var)
        idx_vals = []
        dynamic = False
        for a in s.access:
            if not isinstance(a, A.ArrayAccess):
                raise err("invalid access on var", "T2032", s.meta)
            v = self._scalar(self._eval(a.expr, frame), s.meta)
            idx_vals.append(v)
            if self.domain.known_int(v) is None:
                dynamic = True
        value = self._eval(s.rhe, frame)
        if not dynamic:
            slc.set([self.domain.known_int(v) for v in idx_vals], value,
                    s.meta)
            return
        # witness-dependent index: predicated write over every element
        # (the reference's generated code does runtime addressing;
        # compile-time flattening uses selects).  Sound under unknown
        # conditions too: the write becomes per-element selects on the
        # live frame, and the enclosing unknown-if / predicated-while
        # merge (_merge_scopes) conditions each changed element on the
        # branch's active flag — circomlib bigint hint loops write
        # d[i] with a data-dependent i inside data-dependent whiles.
        lin = self._linear_index(idx_vals, slc.dims, s.meta)
        if isinstance(value, Slice):
            raise err("dynamic-index array assignment must be scalar",
                      "T2044", s.meta)
        for j in range(slc.size()):
            old = slc.values[j]
            if old is None:
                continue
            cond = self.domain.infix(A.EQ, lin, self.domain.const(j),
                                     s.meta)
            slc.values[j] = self.domain.select(cond, value, old)

    def _linear_index(self, idx_vals, dims, meta):
        """Row-major flat index as a domain value (some indices unknown)."""
        if len(idx_vals) != len(dims):
            raise err("dynamic access must use all indices", "T2032", meta)
        strides = []
        s = 1
        for d in reversed(dims):
            strides.append(s)
            s *= d
        strides.reverse()
        acc = self.domain.const(0)
        for v, st in zip(idx_vals, strides):
            acc = self.domain.infix(
                A.ADD, acc,
                self.domain.infix(A.MUL, v, self.domain.const(st), meta),
                meta)
        return acc

    def _read_var_dynamic(self, slc, idx_vals, frame, meta):
        lin = self._linear_index(idx_vals, slc.dims, meta)
        vals = slc.values
        if any(x is None for x in vals):
            raise err("dynamic read of partially-unassigned array",
                      "T2003", meta)
        acc = vals[-1]
        for j in range(len(vals) - 2, -1, -1):
            cond = self.domain.infix(A.EQ, lin, self.domain.const(j), meta)
            acc = self.domain.select(cond, vals[j], acc)
        return acc

    @staticmethod
    def _tag_field_segments(decl, tag):
        """Leaf (start, count) ranges of the FIELD a dotted tag path
        lives on, across every array element of the wire; None for
        wire-level tags (no dot)."""
        if "." not in tag or decl.layout is None:
            return None
        segs = decl.layout.field_segments(tag.rsplit(".", 1)[0])
        if segs is None:
            return None
        unit = decl.layout.size
        n_elems = 1
        for d in decl.dims:
            n_elems *= d
        return [(e * unit + s, n)
                for e in range(n_elems) for (s, n) in segs]

    def _tag_is_init(self, decl, tag):
        """Has the field this tag path lives on been assigned before
        (per-field BusTagInfo.is_init analog)?  Wire-level tags gate on
        the whole wire."""
        segs = self._tag_field_segments(decl, tag)
        a = decl.assigned.values
        if segs is None:
            return any(a)
        return any(a[s + j] for (s, n) in segs for j in range(n))

    def _tag_remaining(self, decl, tag):
        """Unassigned leaf count of the tag path's field (per-field
        remaining_inserts analog, assignment_utils.rs:130-148)."""
        segs = self._tag_field_segments(decl, tag)
        a = decl.assigned.values
        if segs is None:
            return sum(1 for x in a if not x)
        return sum(1 for (s, n) in segs
                   for j in range(n) if not a[s + j])

    def _access_field_path(self, decl, access):
        """Dotted bus-field path named by an access chain's
        ComponentAccess prefix ("" when the whole wire is accessed)."""
        fpath = []
        layout = decl.layout
        for a in access:
            if isinstance(a, A.ComponentAccess):
                if layout is not None \
                        and layout.field(a.name) is not None:
                    layout = layout.field(a.name)[3]
                    fpath.append(a.name)
                else:
                    break
        return ".".join(fpath)

    def _source_tags(self, rhe, frame):
        """Tags carried by a DIRECT signal/bus-to-signal/bus assignment
        RHS (tags do not survive arithmetic; assignment_utils.rs
        semantics).  Returns {tag_or_dotted_path: value|None} rooted at
        the assigned value — a bus FIELD source re-roots its subtree
        ("sub.t" of the wire becomes "t" of the value) — or None."""
        if not isinstance(rhe, A.Variable):
            return None
        name = rhe.name
        decl = None
        rest = rhe.access
        is_output = False
        if name in frame.signals and not isinstance(
            frame.signals[name], PendingBus
        ):
            decl = frame.signals[name]
        elif name in frame.components:
            try:
                idxs0, sig, rest = self._component_access_split(
                    rhe.access, frame, rhe.meta)
            except ExecError:
                return None
            cs = frame.components[name].get(idxs0)
            if cs is None or isinstance(cs, Slice) or sig is None:
                return None
            decl = cs.signals.get(sig)
            is_output = True
        if decl is None:
            return None
        # field path accessed on the source (re-rooting prefix); a
        # terminal ComponentAccess that is a TAG read makes the RHS a
        # scalar constant, not a signal source
        fpath = []
        layout = decl.layout
        for a in rest or ():
            if isinstance(a, A.ComponentAccess):
                if layout is not None \
                        and layout.field(a.name) is not None:
                    layout = layout.field(a.name)[3]
                    fpath.append(a.name)
                else:
                    return None  # tag read (or invalid; checked later)
        prefix = ".".join(fpath)
        scope = prefix + "." if prefix else ""
        # compute_propagated_tags gating (assignment_utils.rs:30-45),
        # PER FIELD (compute_propagated_tags_bus recursion): while the
        # tag's own field still has unassigned positions, inherited
        # (undeclared) tags do NOT propagate and declared tags without
        # a user-fixed value propagate as valueless.  Subcomponent
        # outputs are exempt: the child has executed, its outputs are
        # complete.
        out = {}
        for t, v in decl.tag_values.items():
            if scope:
                if not t.startswith(scope):
                    continue
                key = t[len(scope):]
            else:
                key = t
            remaining = 0 if is_output else self._tag_remaining(decl, t)
            if t in decl.value_defined or remaining == 0:
                out[key] = v
            elif t in decl.tags:
                out[key] = None
        return out

    def _check_and_inherit_tags(self, decl, rhe, frame, meta,
                                strict=False, target_path=""):
        """Tag flow on assignment (assignment_utils.rs
        perform_tag_propagation + perform_tag_propagation_bus +
        component_representation.rs handle_tag_assignment_no_init/_init):

        * strict (component-input boundary): every DECLARED tag of the
          input — wire-level AND per bus field, recursively (dotted
          paths) — is a caller obligation: the assigned expression must
          carry it (AssignmentMissingTags); values are inherited on the
          first assignment and must match on later partial assignments
          (AssignmentTagInputTwice); undeclared extra tags are dropped
          at the boundary (inputs_tags holds declared tags only).
        * non-strict (a template's own signal): declared tags persist —
          the declaring template grants them; tags of a direct signal
          source are INHERITED even when undeclared (tags.md:38
          "the tags are always inherited"), with intersection semantics
          across partial array assignments ("only have a tag in case it
          inherits the tag in all positions").  A user-fixed tag value
          (`x.tag = v`) is never overwritten.

        `target_path` scopes the flow to one bus field's subtree when
        the assignment targets `wire.field...` — entries outside the
        subtree are untouched, and source tags are matched against the
        subtree re-rooted (the reference navigates TagWire.fields by
        the assigned signal's path, component_representation.rs:749-753).
        Per-entry is_init gating is per FIELD, from the field's own
        assigned leaves (per-field BusTagInfo.is_init analog).
        """
        src_tags = self._source_tags(rhe, frame)
        assigned = src_tags or {}
        scope = target_path + "." if target_path else ""

        def in_scope(t):
            return t.startswith(scope) if scope else True

        def rooted(t):
            return t[len(scope):] if scope else t

        if strict:
            for t in decl.tags:
                if not in_scope(t):
                    continue
                key = rooted(t)
                if key not in assigned:
                    raise err(
                        f"input '{decl.name}' requires tag '{t}' but the "
                        "assigned expression does not carry it", "T2040",
                        meta,
                    )
                if not self._tag_is_init(decl, t):
                    decl.tag_values[t] = assigned[key]
                elif decl.tag_values.get(t) != assigned.get(key):
                    raise err(
                        "tags required by an input signal must carry "
                        f"the same value in every assignment: input "
                        f"'{decl.name}' already has a different value "
                        f"for tag '{t}'", "T2040", meta,
                    )
            return
        if not decl.tag_values and not assigned:
            return
        new_vals = {}
        for t, v in decl.tag_values.items():
            if not in_scope(t):
                new_vals[t] = v           # outside the assigned subtree
                continue
            key = rooted(t)
            is_init = self._tag_is_init(decl, t)
            if t in decl.tags:            # declared: always kept
                if t in decl.value_defined:
                    new_vals[t] = v       # user-fixed value wins
                elif is_init:
                    new_vals[t] = v if (key in assigned
                                        and assigned[key] == v) else None
                else:
                    new_vals[t] = assigned.get(key)
            else:                         # inherited earlier: intersect
                if key in assigned and assigned[key] == v:
                    new_vals[t] = v
        for key, v in assigned.items():
            t = scope + key
            if t not in new_vals and not self._tag_is_init(decl, t):
                new_vals[t] = v           # first assignment inherits
        decl.tag_values = new_vals

    def _assign_signal(self, s, decl: SignalDecl, frame):
        res = self._resolve_wire(decl, s.access, frame, s.meta)
        if res[0] == "tag":
            self._assign_tag(s, decl, res[1], frame)
            return
        _kind, start, count = res
        if frame.unknown_depth:
            raise err("signal assignment inside unknown condition",
                      "T2050", s.meta)
        if s.op == A.AssignOp.VAR:
            raise err("signals must be assigned with <== or <--",
                      "T2054", s.meta)
        if decl.layout is None and not s.access \
                and isinstance(s.rhe, A.Variable) and not s.rhe.access:
            src = frame.signals.get(s.rhe.name)
            if src is not None \
                    and getattr(src, "layout", None) is not None:
                # WrongTypesInAssignOperationBus (error_code.rs T2059)
                raise err("cannot assign a bus to a signal", "T2059",
                          s.meta)
        if decl.layout is not None and not s.access \
                and isinstance(s.rhe, A.Variable) and not s.rhe.access:
            src = frame.signals.get(s.rhe.name)
            if src is not None \
                    and getattr(src, "layout", None) is not None \
                    and src.layout.bus_name != decl.layout.bus_name:
                # MustBeSameBus (error_code.rs BU05)
                raise err(
                    f"cannot assign a bus of type "
                    f"'{src.layout.bus_name}' to one of type "
                    f"'{decl.layout.bus_name}'", "BU05", s.meta)
        self._check_and_inherit_tags(
            decl, s.rhe, frame, s.meta,
            target_path=self._access_field_path(decl, s.access))
        value = self._eval(s.rhe, frame)
        self._store_signal_elements(decl, start, count, value, s.op, frame,
                                    s.meta, prefix="")

    def _assign_tag(self, s, decl, tag, frame):
        if tag not in decl.tag_values:
            raise err(f"signal '{decl.name}' has no tag '{tag}'",
                      "T2048", s.meta)
        v = self._eval(s.rhe, frame)
        k = self.domain.known_int(v)
        if k is None:
            raise err("tag values must be known constants", "T2062", s.meta)
        if self._tag_is_init(decl, tag):
            # per-field: fixing a FIELD tag is legal until that field
            # itself has an assigned leaf (BusTagInfo.is_init analog)
            raise err("tag assigned after signal assignment", "T2062", s.meta)
        decl.tag_values[tag] = k
        decl.value_defined.add(tag)
        if frame.builder is not None:
            frame.builder.tag_exports.setdefault(decl.name, {})[tag] = k

    def _store_signal_elements(self, decl, start, count, value, op, frame,
                               meta, prefix):
        """Assign a flat leaf range of a wire; emits constraints for <==
        in constrain mode."""
        names = decl.elem_names
        if isinstance(value, Slice):
            vals = value.values
            if len(vals) != count:
                raise err(
                    f"size mismatch assigning '{decl.name}': "
                    f"{len(vals)} values into {count} elements",
                    "T2045", meta,
                )
        else:
            if count != 1:
                raise err("assigning scalar to signal array", "T2045", meta)
            vals = [value]
        for j in range(count):
            if decl.assigned.values[start + j]:
                raise err(
                    f"signal '{names[start + j]}' already assigned",
                    "T2037", meta,
                )
            decl.assigned.values[start + j] = True
            decl.slice.values[start + j] = vals[j]
            if self.mode == "tape" and decl.tag_values \
                    and isinstance(vals[j], TapeRef):
                # binary / valued-maxbit tags narrow the stored tape
                # node: tags are the author's exported range assertions
                # (reference tags docs; wire_data.rs carries them for
                # downstream provers), the same contract under which
                # the reference's emitted runtimes compute
                hint = _tag_range_hint(decl.tag_values)
                if hint is not None:
                    nid = vals[j].id
                    old = self.tape.node_hints.get(nid)
                    self.tape.node_hints[nid] = hint if old is None \
                        else (max(old[0], hint[0]), min(old[1], hint[1]))
            if self.mode == "constrain" and op == A.AssignOp.CONSTRAINT:
                # reference convention: the constraint expression is
                # lhs - rhs (perform_assign builds signal - value), so
                # the quadratic negation lands on A and C = -linear —
                # reproduced byte-exactly by the docs' worked example
                # (constraints-json.md:49-96, tests/test_golden.py)
                qname = prefix + names[start + j]
                expr = alg.sub(AExpr.signal(qname), vals[j], self.hf)
                self._emit_constraint(expr, frame, meta)
        return count

    def _emit_constraint(self, expr, frame, meta):
        if isinstance(expr, NonQuadratic):
            raise err("non-quadratic constraint", "T20462", meta)
        c = alg.Constraint.from_aexpr(expr, self.hf)
        if c is None:
            raise err("non-quadratic constraint", "T20462", meta)
        if c.is_linear() and len(c.c) == 1 and alg.CONST in c.c:
            if c.c[alg.CONST] != 0:
                raise err("impossible constraint: nonzero constant = 0",
                          "T3001", meta)
            return
        frame.builder.constraints.append(c)

    # -- component assignment -------------------------------------------
    def _component_access_split(self, access, frame, meta):
        """Leading ArrayAccess* (component array index) + ComponentAccess
        (signal name) + rest."""
        idxs0 = []
        i = 0
        while i < len(access) and isinstance(access[i], A.ArrayAccess):
            idxs0.append(self._index_value(
                self._eval(access[i].expr, frame), meta))
            i += 1
        sig = None
        if i < len(access) and isinstance(access[i], A.ComponentAccess):
            sig = access[i].name
            i += 1
        return idxs0, sig, access[i:]

    def _assign_component(self, s, cslice, frame):
        idxs0, comp_sig, rest = self._component_access_split(
            s.access, frame, s.meta)
        if comp_sig is None:
            # instantiate: c[idxs] = Template(args)
            if frame.unknown_depth:
                raise err("component instantiation inside unknown condition",
                          "T2050", s.meta)
            value = self._eval(s.rhe, frame)
            if not isinstance(value, TemplateClosure):
                if isinstance(value, BusClosure):
                    # InvalidArgumentInBusInstantiationT (BU02)
                    raise err("components cannot be assigned bus calls",
                              "BU02", s.meta)
                if isinstance(value, Slice):
                    kinds = set(type(x).__name__ for x in value.values)
                    if "TemplateClosure" in kinds:
                        # WrongTypesInAssignOperationArrayTemplates T2056
                        raise err("arrays of template instances cannot "
                                  "be assigned (instantiate elements "
                                  "one by one)", "T2056", s.meta)
                    if "BusClosure" in kinds:
                        # WrongTypesInAssignOperationArrayBuses T2058
                        raise err("arrays of bus instances cannot be "
                                  "assigned here", "T2058", s.meta)
                raise err("component must be assigned a template call",
                          "T2O461-A", s.meta)
            self._instantiate(s.var, idxs0, value, cslice, frame, s.meta)
            return
        # input assignment: c[i].in[j] <== e
        cs = cslice.get(idxs0, s.meta)
        if isinstance(cs, Slice):
            raise err("component array used without index", "T2032", s.meta)
        if cs is None:
            raise err(
                f"component '{s.var}' used before instantiation",
                "T20466", s.meta,
            )
        if frame.unknown_depth:
            raise err("signal assignment inside unknown condition",
                      "T2050", s.meta)
        value = self._eval(s.rhe, frame)
        self._assign_component_input(cs, comp_sig, rest, value, s.op,
                                     frame, s.meta, rhe_ast=s.rhe)

    def _instantiate(self, cname, idxs, closure, cslice, frame, meta):
        cs = ComponentState()
        cs.template = closure.name
        cs.params = closure.params
        cs.is_parallel = closure.is_parallel
        cs.label = cname + "".join(f"[{i}]" for i in idxs)
        cs.meta_name = cname
        if cslice.get(idxs, meta) is not None:
            # AssigningAComponentTwice (error_code.rs T2036)
            raise err(f"component '{cs.label}' is already instantiated",
                      "T2036", meta)
        cslice.set(idxs, cs, meta)
        cs.instantiated = True
        tmpl = self.archive.templates.get(closure.name)
        if tmpl is None:
            raise err(f"unknown template '{closure.name}'", "T20461", meta)
        # templates whose inputs declare tags execute once the caller has
        # fed every input (tag values travel with the assignments and are
        # part of the memo key — ComponentRepresentation unassigned_tags /
        # is_ready_initialize semantics); untagged templates execute at
        # instantiation (execute.rs:1795-1875).
        if self.mode == "constrain":
            if self._template_input_tags(closure.name):
                cs.pending_inputs = [(cname, tuple(idxs), frame)]
                self._bind_component_io_from_scan(cs, closure, meta)
                if cs.inputs_remaining == 0:
                    self._finish_deferred_instantiation(cs, frame, meta)
                return
            node_id = self.execute_template(
                closure.name, closure.params, cs.input_tag_values, meta=meta,
            )
            cs.node_id = node_id
            self._bind_component_io(cs, node_id)
            frame.builder.connexions.append(
                (cname, tuple(idxs), cs.label, node_id, cs.is_parallel)
            )
            if cs.inputs_remaining == 0:
                cs.executed = True
        else:
            path = f"{self._witness_path}.{cs.label}"
            self.instances_by_path[path] = cs
            if frame.instance is not None:
                frame.instance.child_instances[cs.label] = cs
            if self._template_input_tags(closure.name):
                # tags arrive with the inputs; resolve the instance then
                self._bind_component_io_from_scan(cs, closure, meta)
                if cs.inputs_remaining == 0:
                    self._resolve_witness_node(cs, meta)
                    self._execute_child_witness(cs)
                return
            self._resolve_witness_node(cs, meta)
            self._bind_component_io(cs, cs.node_id)
            if cs.inputs_remaining == 0:
                self._execute_child_witness(cs)

    def _resolve_witness_node(self, cs, meta):
        key = self._memo_key(cs.template, cs.params, cs.input_tag_values)
        node_id = self.memo.get(key)
        if node_id is None:
            raise err(
                f"instance of '{cs.template}' absent from constraint "
                "pass (params/tags mismatch)", "T2038", meta,
            )
        cs.node_id = node_id

    def _template_input_tags(self, name):
        """True if any input of the template declares tags (cached)."""
        cache = getattr(self, "_tmpl_tag_cache", None)
        if cache is None:
            cache = self._tmpl_tag_cache = {}
        if name in cache:
            return cache[name]
        tmpl = self.archive.templates[name]
        found = False

        def walk(s):
            nonlocal found
            if isinstance(s, A.Block):
                for x in s.stmts:
                    walk(x)
            elif isinstance(s, A.InitializationBlock):
                for x in s.initializations:
                    walk(x)
            elif isinstance(s, A.Declaration):
                if (s.xtype.kind in ("signal", "bus")
                        and s.xtype.signal_type == A.SignalType.INPUT):
                    if s.xtype.tags:
                        found = True
                    elif s.xtype.kind == "bus":
                        # the bus TYPE may declare tags on its fields
                        # (recursively) — those are caller obligations
                        # too, so the instance must defer until inputs
                        # (with their TagWire values) arrive
                        if self._bus_type_has_tags(s.xtype.bus_name):
                            found = True
            elif isinstance(s, A.IfThenElse):
                walk(s.if_case)
                if s.else_case:
                    walk(s.else_case)
            elif isinstance(s, A.While):
                walk(s.stmt)

        walk(tmpl.body)
        cache[name] = found
        return found

    def _bus_type_has_tags(self, name, _seen=None):
        """Does a bus type (or any nested bus field type) declare tags
        on a field?  AST-level, parameter-independent, cached."""
        cache = getattr(self, "_bus_tag_cache", None)
        if cache is None:
            cache = self._bus_tag_cache = {}
        if name in cache:
            return cache[name]
        _seen = _seen or set()
        if name in _seen or name is None:
            return False
        _seen.add(name)
        bus = self.archive.buses.get(name)
        if bus is None:
            return False
        found = False

        def walk(s):
            nonlocal found
            if isinstance(s, A.Block):
                for x in s.stmts:
                    walk(x)
            elif isinstance(s, A.InitializationBlock):
                for x in s.initializations:
                    walk(x)
            elif isinstance(s, A.Declaration):
                if s.xtype.kind in ("signal", "bus"):
                    if s.xtype.tags:
                        found = True
                    elif s.xtype.kind == "bus" and self._bus_type_has_tags(
                            s.xtype.bus_name, _seen):
                        found = True

        walk(bus.body)
        cache[name] = found
        return found

    def _bind_component_io_from_scan(self, cs, closure, meta):
        """Bind the io wires of a deferred (tagged-input) component from a
        light scan of the template body: var tracking + declarations only
        (signal dims depend only on params/vars)."""
        tmpl = self.archive.templates[closure.name]
        frame = Frame("function", closure.name)
        for argname, value in zip(tmpl.args, closure.params):
            frame.declare_var(argname, _as_slice(self._to_domain(value)))
        wires = []
        pending_bus = {}  # io bus wires awaiting their BusCall

        def walk(s):
            if isinstance(s, A.Block):
                for x in s.stmts:
                    walk(x)
            elif isinstance(s, A.InitializationBlock):
                for x in s.initializations:
                    walk(x)
            elif isinstance(s, A.Declaration):
                if s.xtype.kind == "var":
                    dims = [self._index_value(self._eval(d, frame), s.meta,
                                              what="size")
                            for d in s.dimensions]
                    frame.declare_var(s.name, Slice.filled(dims, None))
                elif s.xtype.kind == "signal" and s.xtype.signal_type in (
                    A.SignalType.INPUT, A.SignalType.OUTPUT,
                ):
                    dims = [self._index_value(self._eval(d, frame), s.meta,
                                              what="size")
                            for d in s.dimensions]
                    wires.append((s.name, dims, s.xtype.signal_type,
                                  s.xtype.tags, None))
                elif s.xtype.kind == "bus" and s.xtype.signal_type in (
                    A.SignalType.INPUT, A.SignalType.OUTPUT,
                ):
                    # bus io: the layout resolves at the BusCall
                    # substitution the parser splits the declaration
                    # into (`p = Pt(...)`)
                    dims = [self._index_value(self._eval(d, frame), s.meta,
                                              what="size")
                            for d in s.dimensions]
                    pending_bus[s.name] = (dims, s.xtype.signal_type,
                                           s.xtype.tags)
            elif isinstance(s, A.Substitution):
                if s.var in pending_bus and not s.access:
                    v = self._eval(s.rhe, frame)
                    if isinstance(v, BusClosure):
                        dims, xtype, tags = pending_bus.pop(s.var)
                        layout = self._bus_layout(v.name, v.params, s.meta)
                        wires.append((s.var, dims, xtype, tags, layout))
                        return
                try:
                    target = frame.lookup_var(s.var)
                except Exception:
                    target = None
                if target is not None:
                    try:
                        self._assign_var(s, frame)
                    except ExecError:
                        pass
            elif isinstance(s, A.IfThenElse):
                cond = self.domain.as_cond(self._eval(s.cond, frame))
                if cond is True:
                    walk(s.if_case)
                elif cond is False and s.else_case is not None:
                    walk(s.else_case)
            elif isinstance(s, A.While):
                while True:
                    cond = self.domain.as_cond(self._eval(s.cond, frame))
                    if not cond:
                        break
                    walk(s.stmt)

        walk(tmpl.body)
        total_inputs = 0
        for (name, dims, xtype, tags, layout) in wires:
            decl = SignalDecl(name, dims, xtype, list(tags), layout)
            if xtype == A.SignalType.INPUT:
                total_inputs += decl.total_size()
            cs.signals[name] = decl
        cs.inputs_remaining = total_inputs

    def _finish_deferred_instantiation(self, cs, frame, meta):
        """All inputs (and hence tag values) known: execute + record."""
        node_id = self.execute_template(
            cs.template, cs.params, cs.input_tag_values, meta=meta,
        )
        cs.node_id = node_id
        # replace output decls with the node's (keeps exported tag values)
        node = self.dag.nodes[node_id]
        for (name, dims, xtype, tagvals, layout) in node.wire_info:
            if xtype == A.SignalType.OUTPUT:
                decl = SignalDecl(name, dims, xtype, list(tagvals), layout)
                decl.tag_values = dict(tagvals)
                cs.signals[name] = decl
        (cname, idxs, owner_frame) = cs.pending_inputs[0]
        owner_frame.builder.connexions.append(
            (cname, idxs, cs.label, node_id, cs.is_parallel)
        )
        cs.executed = True

    def _bind_component_io(self, cs: ComponentState, node_id):
        node = self.dag.nodes[node_id]
        total_inputs = 0
        for (name, dims, xtype, tagvals, layout) in node.wire_info:
            decl = SignalDecl(name, dims, xtype, list(tagvals), layout)
            decl.tag_values = dict(tagvals)
            if xtype == A.SignalType.INPUT:
                total_inputs += decl.total_size()
                cs.signals[name] = decl
            elif xtype == A.SignalType.OUTPUT:
                cs.signals[name] = decl
        cs.inputs_remaining = total_inputs

    def _assign_component_input(self, cs, sig_name, rest_access, value, op,
                                frame, meta, rhe_ast=None):
        decl = cs.signals.get(sig_name)
        if decl is not None and decl.xtype == A.SignalType.OUTPUT:
            res0 = self._resolve_wire(decl, rest_access, frame, meta)
            if res0[0] == "tag":
                # OutputTagCannotBeModifiedOutside (T2048-A)
                raise err(
                    "the tags of an output signal cannot be modified "
                    "outside its template", "T2048-A", meta)
        if decl is None or decl.xtype != A.SignalType.INPUT:
            raise err(
                f"'{sig_name}' is not an input of template {cs.template}",
                "T2046", meta,
            )
        prefix = cs.label + "."
        res = self._resolve_wire(decl, rest_access, frame, meta)
        if res[0] == "tag":
            # InputTagCannotBeModifiedOutside (T2048-B)
            raise err("the tags of an input signal cannot be modified "
                      "outside its template", "T2048-B", meta)
        if op == A.AssignOp.VAR:
            # the `=` operator is only legal for tag writes (caught
            # above with their own codes)
            raise err("component inputs need <== or <--", "T2054", meta)
        _k, start, count = res
        # tagged inputs: the assigned expression must carry the tags;
        # collected values become part of the instance identity.
        if decl.tags and rhe_ast is not None:
            tpath = self._access_field_path(decl, rest_access)
            self._check_and_inherit_tags(
                decl, rhe_ast, frame, meta, strict=True,
                target_path=tpath)
            cs.input_tag_values[sig_name] = dict(decl.tag_values)
            self._tag_cover.setdefault(id(cs), {}).setdefault(
                sig_name, set()).add(tpath)
        count = self._store_signal_elements(
            decl, start, count, value, op, frame, meta, prefix=prefix)
        cs.inputs_remaining -= count
        if cs.inputs_remaining == 0:
            if self.mode == "constrain":
                self._check_input_tags_covered(cs, meta)
            if self.mode == "constrain":
                if cs.node_id is None:
                    self._finish_deferred_instantiation(cs, frame, meta)
                else:
                    cs.executed = True  # body ran at instantiation
            else:
                if cs.node_id is None:
                    self._resolve_witness_node(cs, meta)
                self._execute_child_witness(cs)

    def _check_input_tags_covered(self, cs, meta):
        """Every declared tag of every input must have been within the
        scope of at least one strict tag check — a tagged input (or a
        bus with a wire-level tag) assigned only FIELD-WISE leaves the
        higher-level tag obligation unfulfilled, which the reference
        surfaces by never draining unassigned_tags
        (component_representation.rs:766-767, :719-723)."""
        cover = self._tag_cover.get(id(cs), {})
        for name, decl in cs.signals.items():
            if decl.xtype != A.SignalType.INPUT or not decl.tags:
                continue
            scopes = cover.get(name, set())
            for t in decl.tags:
                if not any(s == "" or t.startswith(s + ".")
                           for s in scopes):
                    raise err(
                        f"input '{decl.name}' declares tag '{t}' but "
                        "no assignment covered the tag's level (a "
                        "field-wise assignment cannot satisfy a "
                        "higher-level tag obligation)", "T2040", meta)

    def _execute_child_witness(self, cs: ComponentState):
        inputs = {
            name: decl.slice
            for name, decl in cs.signals.items()
            if decl.xtype == A.SignalType.INPUT
        }
        saved = self._witness_path
        path = f"{saved}.{cs.label}"
        tmpl = self.archive.templates.get(cs.template)
        impl = EXTERN_IMPLS.get(cs.template)
        is_extern = (impl is not None and tmpl is not None
                     and getattr(tmpl, "is_extern_c", False))
        key = flat_in = None
        if self.mode == "tape" and cs.node_id is not None \
                and not is_extern:
            flat_in = []
            for name in sorted(inputs):
                flat_in.extend(inputs[name].values)
            # The memo key must capture the call's full input PATTERN,
            # not just which positions are symbolic: a recorded recipe
            # bakes in which input positions share a TapeRef (the
            # recorder maps every position of an aliased ref onto the
            # first occurrence), so replaying it for a call with a
            # different aliasing pattern computes the wrong witness.
            # Canonical aliasing signature: each TapeRef position
            # becomes ("r", index-of-first-position-with-same-ref);
            # consts stay literal.  The reference never faces this
            # because it memoizes CODE per (template,params,tags)
            # (executed_program.rs:37-49) while wiring stays per-call
            # in Connexions (executed_template.rs:64-88).
            first_pos = {}
            ksig = []
            for k, v in enumerate(flat_in):
                if isinstance(v, TapeRef):
                    ksig.append(("r", first_pos.setdefault(v.id, k)))
                else:
                    ksig.append(v)
            key = (cs.node_id, tuple(ksig))
            rec = self.tape_memo.get(key)
            if rec is not None and rec is not False:
                child = self._replay_tape_recipe(rec, flat_in, path)
                self._splice_child(cs, child, path)
                return
        n_guards0 = len(self.tape_guards)
        n_hints0 = len(self.tape.node_hints) if self.mode == "tape" else 0
        n_logs0 = len(self.log_sink)
        child = ComponentState()
        child.template = cs.template
        child.params = cs.params
        child.label = cs.label
        child.node_id = cs.node_id
        self.instances_by_path[path] = child
        self._run_witness_body(child, inputs, path)
        if key is not None:
            rec = (False if len(self.log_sink) != n_logs0
                   else self._record_tape_recipe(
                       child, flat_in, n_guards0, n_hints0))
            self.tape_memo[key] = rec if rec is not None else False
        if is_extern:
            if self.mode == "hostwit":
                self._apply_extern_impl(child, cs, impl, inputs)
            elif self.mode == "tape":
                # a registered extern implementation is authoritative
                # for outputs (reference extern_c linkage,
                # c_code_generator.rs:514-545).  On the batched TPU
                # path its outputs become EXTRA TAPE INPUT slots: the
                # runner evaluates the gate's input nodes host-side
                # per batch column, calls the implementation, and
                # splices the output columns into the device inputs
                # (backend/tape.py compute_extern_columns)
                self._apply_extern_tape(child, cs, inputs)
        self._witness_path = saved
        self._splice_child(cs, child, path)

    def _splice_child(self, cs, child, path):
        # splice child's computed signals into the parent-facing state
        for name, decl in child.signals.items():
            cs.signals[name] = decl
        cs.executed = True
        cs.child_instances = child.child_instances
        self.instances_by_path[path] = child

    # -- tape-mode instance recipes --------------------------------------
    # A recipe re-expresses everything a child execution produced —
    # emitted SSA nodes, the instance subtree with its signal values,
    # while-unroll guards, tag range hints — relative to a symbol
    # alphabet: ("i", k) = k-th flat input ref, ("k", v) = field
    # constant v, ("n", j) = j-th recipe-internal node.  Replay
    # re-emits the nodes against fresh input refs (hash-consing dedups
    # anything structurally shared) and rebuilds the subtree, skipping
    # the abstract interpretation of the body entirely.

    def _record_tape_recipe(self, child, flat_in, n_guards0, n_hints0):
        """Symbolize the finished child execution, or None if a value
        outside the TapeRef/int/None alphabet appears (not replayable)."""
        tape = self.tape
        in_pos = {}
        for k, v in enumerate(flat_in):
            if isinstance(v, TapeRef):
                in_pos.setdefault(v.id, k)
        guards = self.tape_guards[n_guards0:]
        # roots: every ref in the subtree's signal slices + new guards
        roots = [g.id for g in guards if isinstance(g, TapeRef)]
        stack = [child]
        insts = []
        while stack:
            st = stack.pop()
            insts.append(st)
            for decl in st.signals.values():
                for v in decl.slice.values:
                    if isinstance(v, TapeRef):
                        roots.append(v.id)
                    elif v is not None and not isinstance(v, int):
                        return None
            stack.extend(st.child_instances.values())
        # closure down to {input refs, consts}; ids are SSA-ordered so
        # ascending id order is a topological order
        seen = set()
        work = roots[:]
        internal = []
        while work:
            nid = work.pop()
            if nid in seen or nid in in_pos:
                continue
            seen.add(nid)
            op = tape.ops[nid]
            if op == "const":
                continue
            if op == "input":
                return None  # foreign input leaked past the boundary
            internal.append(nid)
            work.extend(tape.args[nid])
        internal.sort()
        pos = {nid: j for j, nid in enumerate(internal)}

        def sym(nid):
            k = in_pos.get(nid)
            if k is not None:
                return ("i", k)
            if tape.ops[nid] == "const":
                return ("k", tape.imms[nid])
            return ("n", pos[nid])

        nodes = [(tape.ops[nid],
                  tuple(sym(a) for a in tape.args[nid]),
                  tape.imms[nid]) for nid in internal]
        hints = []
        for nid in list(tape.node_hints)[n_hints0:]:
            if nid in pos:
                hints.append((("n", pos[nid]), tape.node_hints[nid]))
        gsyms = [sym(g.id) if isinstance(g, TapeRef) else ("k", g)
                 for g in guards]

        def enc_val(v):
            return sym(v.id) if isinstance(v, TapeRef) else v

        def enc_inst(st):
            sigs = {}
            for name, d in st.signals.items():
                sigs[name] = (d.name, d.dims, d.xtype, tuple(d.tags),
                              dict(d.tag_values), d.layout, d.elem_names,
                              [enc_val(v) for v in d.slice.values],
                              list(d.assigned.values),
                              frozenset(d.value_defined))
            kids = {lbl: enc_inst(c)
                    for lbl, c in st.child_instances.items()}
            return (st.template, st.params, st.node_id, st.meta_name,
                    st.is_anonymous, st.input_tag_values, sigs, kids)

        return (nodes, hints, gsyms, enc_inst(child))

    def _replay_tape_recipe(self, rec, flat_in, path):
        nodes, hints, gsyms, inst_rec = rec
        tape = self.tape
        news = []

        def res(s):
            t, v = s
            if t == "i":
                return flat_in[v]
            if t == "k":
                return tape.const(v)
            return news[v]

        for op, argsyms, imm in nodes:
            news.append(tape._push(
                op, tuple(res(a).id for a in argsyms), imm))
        for s, hint in hints:
            nid = res(s).id
            old = tape.node_hints.get(nid)
            tape.node_hints[nid] = (hint if old is None else
                                    (max(old[0], hint[0]),
                                     min(old[1], hint[1])))
        for s in gsyms:
            self.tape_guards.append(res(s))

        def dec_val(e):
            return res(e) if isinstance(e, tuple) else e

        def dec_inst(r, label, ipath):
            (template, params, node_id, meta_name, is_anon,
             input_tag_values, sigs, kids) = r
            st = ComponentState()
            st.template = template
            st.params = params
            st.label = label
            st.node_id = node_id
            st.meta_name = meta_name
            st.is_anonymous = is_anon
            st.input_tag_values = dict(input_tag_values)
            st.executed = True
            st.instantiated = True
            for name, (dname, dims, xtype, tags, tag_values, layout,
                       elem_names, vals, assigned,
                       value_defined) in sigs.items():
                d = SignalDecl.__new__(SignalDecl)
                d.name = dname
                d.dims = dims
                d.xtype = xtype
                d.tags = list(tags)
                d.tag_values = dict(tag_values)
                d.value_defined = set(value_defined)
                d.layout = layout
                d.elem_names = elem_names
                n = len(vals)
                d.slice = Slice((n,), [dec_val(v) for v in vals])
                d.assigned = Slice((n,), list(assigned))
                st.signals[name] = d
            self.instances_by_path[ipath] = st
            for lbl, kr in kids.items():
                st.child_instances[lbl] = dec_inst(
                    kr, lbl, f"{ipath}.{lbl}")
            return st

        label = path.rsplit(".", 1)[-1]
        return dec_inst(inst_rec, label, path)

    def _record_underscore(self, v, frame):
        if self.mode == "constrain" and frame.builder is not None:
            vals = v.values if isinstance(v, Slice) else [v]
            for x in vals:
                if isinstance(x, AExpr):
                    for sig in x.signals():
                        frame.builder.underscored.append(sig)

    # -- constraint equality --------------------------------------------
    def _exec_constraint_eq(self, s: A.ConstraintEquality, frame):
        if frame.unknown_depth:
            raise err("=== inside unknown condition", "T2005", s.meta)
        l = self._eval(s.lhe, frame)
        r = self._eval(s.rhe, frame)
        lv = l.values if isinstance(l, Slice) else [l]
        rv = r.values if isinstance(r, Slice) else [r]
        ldims = l.dims if isinstance(l, Slice) else ()
        rdims = r.dims if isinstance(r, Slice) else ()
        if tuple(ldims) != tuple(rdims):
            raise err("=== dimension mismatch", "T2045", s.meta)
        for a, b in zip(lv, rv):
            if self.mode == "constrain":
                self._emit_constraint(alg.sub(a, b, self.hf), frame, s.meta)
            elif self.mode == "hostwit" and self.sanity_check >= 1:
                if (a - b) % self.hf.p != 0:
                    raise err(
                        f"=== check failed: {a} != {b}", "T3002", s.meta,
                    )

    # -- control flow ----------------------------------------------------
    def _exec_if(self, s: A.IfThenElse, frame):
        cond = self._eval(s.cond, frame)
        if isinstance(cond, Slice) and cond.dims:
            raise err("conditions must be single arithmetic expressions",
                      "T2025", s.cond.meta)
        cond = self._scalar(cond, s.cond.meta, "T2025")
        known = self.domain.as_cond(cond)
        if known is not None:
            if known:
                self._exec_stmt(s.if_case, frame)
            elif s.else_case is not None:
                self._exec_stmt(s.else_case, frame)
            return
        # unknown condition: fork vars, run both branches, merge
        self._exec_unknown_if(s, cond, frame)

    def _exec_unknown_if(self, s, cond, frame):
        snapshot = _snapshot_scopes(frame)
        frame.unknown_depth += 1
        try:
            self._exec_stmt(s.if_case, frame)
            then_state = _snapshot_scopes(frame)
            _restore_scopes(frame, snapshot)
            if s.else_case is not None:
                self._exec_stmt(s.else_case, frame)
            else_state = _snapshot_scopes(frame)
        finally:
            frame.unknown_depth -= 1
        merged = _merge_scopes(then_state, else_state, cond, self.domain)
        _restore_scopes(frame, merged)

    def _exec_while(self, s: A.While, frame):
        while True:
            cond = self._eval(s.cond, frame)
            if isinstance(cond, Slice):
                raise err("conditions must be single arithmetic "
                          "expressions", "T2025", s.cond.meta)
            known = self.domain.as_cond(cond)
            if known is None:
                if self.mode == "tape":
                    return self._exec_while_predicated(s, cond, frame)
                # constrain mode: execute once in unknown block; vars
                # touched become unknown (execute.rs conditional fork)
                snapshot = _snapshot_scopes(frame)
                frame.unknown_depth += 1
                try:
                    self._exec_stmt(s.stmt, frame)
                    after = _snapshot_scopes(frame)
                finally:
                    frame.unknown_depth -= 1
                merged = _merge_scopes(snapshot, after, cond, self.domain)
                _restore_scopes(frame, merged)
                return
            if not known:
                return
            self._exec_stmt(s.stmt, frame)

    def _exec_while_predicated(self, s: A.While, cond, frame):
        """Witness-dependent `while` on the tape path: predicated
        unrolling.  The reference's emitted runtimes execute
        data-dependent loops at runtime (intermediate_representation/
        loop_bucket.rs); the tape is straight-line, so each unrolled
        iteration executes under active_k = cond_0 && ... && cond_k
        with masked var updates (the unknown-if select merge), and the
        final `active` flag is recorded as a runtime GUARD: a nonzero
        guard means the loop needed more than `while_max_unroll`
        iterations for some batch element (silent truncation would
        otherwise produce a wrong witness).  Signals cannot be assigned
        under an unknown condition (unknown/known analysis), so only
        vars merge.

        When the condition contains a conjunct bounded by a monotone
        counter (`i < k` with known start/bound and unconditional
        positive increments — the common circomlib bigint pattern),
        the trip count is DERIVED and the loop unrolls exactly that
        many iterations with no guard."""
        derived = self._derive_trip_bound(s, frame)
        bound = self.while_max_unroll if derived is None \
            else min(derived, self.while_max_unroll)
        active = cond
        for _ in range(bound):
            snapshot = _snapshot_scopes(frame)
            frame.unknown_depth += 1
            try:
                self._exec_stmt(s.stmt, frame)
                after = _snapshot_scopes(frame)
            finally:
                frame.unknown_depth -= 1
            merged = _merge_scopes(after, snapshot, active, self.domain)
            _restore_scopes(frame, merged)
            cond2 = self._eval(s.cond, frame)
            active = self.domain.infix("&&", active, cond2, s.meta)
            if self.domain.as_cond(active) is False:
                return
        if derived is not None and derived <= self.while_max_unroll:
            # proof: any element active through `derived` iterations
            # has advanced its counter past the bound, so the counter
            # conjunct (and hence `active`) is false — no guard needed
            return
        self.tape_guards.append(active)

    def _derive_trip_bound(self, s: A.While, frame):
        """Static trip count from a counter-bounded conjunct, or None.

        Looks for a conjunct `i < K` / `i <= K` / `K > i` / `K >= i` of
        the loop condition where: `i` is a plain scalar var whose
        CURRENT value is a known integer; `K` evaluates to a known
        integer; and every assignment to `i` anywhere in the body is an
        UNCONDITIONAL top-level `i = i + c` (or `i += c` / `i++`, both
        already desugared to that form) with a known constant c > 0.
        Each iteration then advances `i` by the (summed) increment, so
        at most ceil((K - i0 [+1 for <=]) / inc) iterations can keep
        the conjunct true.  Values are compared via the signed
        convention; derivation bails if the counter walk could leave
        the signed-safe range (wraparound)."""
        half = self.hf.p >> 1

        def conjuncts(e):
            if isinstance(e, A.Infix) and e.op == A.BOOL_AND:
                yield from conjuncts(e.lhe)
                yield from conjuncts(e.rhe)
            else:
                yield e

        def plain_var(e):
            return e.name if isinstance(e, A.Variable) and not e.access \
                else None

        def signed(v):
            return v - self.hf.p if v > half else v

        def known(e):
            v = self.domain.known_int(self._eval(e, frame))
            return None if v is None else signed(v)

        def body_increment(name):
            """Summed per-iteration increment of var `name`, or None if
            any write is conditional/nested or not inc-by-positive-
            const.  Only top-level statements of the body block are
            unconditional; a write found deeper bails."""
            def nested_writes(st):
                if isinstance(st, A.Substitution) and st.var == name:
                    return True
                return any(nested_writes(c) for c in _child_stmts(st))

            top_writes = []
            body = s.stmt
            stmts = body.stmts if isinstance(body, A.Block) else [body]
            for st in stmts:
                if isinstance(st, A.Substitution) and st.var == name:
                    if st.access or st.op != A.AssignOp.VAR:
                        return None
                    top_writes.append(st)
                elif nested_writes(st):
                    return None
            if not top_writes:
                return None
            inc = 0
            for w in top_writes:
                r = w.rhe
                if not (isinstance(r, A.Infix) and r.op == A.ADD):
                    return None
                if plain_var(r.lhe) == name and isinstance(r.rhe, A.Number):
                    c = signed(r.rhe.value % self.hf.p)
                elif plain_var(r.rhe) == name \
                        and isinstance(r.lhe, A.Number):
                    c = signed(r.lhe.value % self.hf.p)
                else:
                    return None
                if c <= 0:
                    return None
                inc += c
            return inc

        best = None
        for part in conjuncts(s.cond):
            if not isinstance(part, A.Infix):
                continue
            if part.op in (A.LT, A.LEQ):
                v, bnd, le = plain_var(part.lhe), part.rhe, \
                    part.op == A.LEQ
            elif part.op in (A.GT, A.GEQ):
                v, bnd, le = plain_var(part.rhe), part.lhe, \
                    part.op == A.GEQ
            else:
                continue
            if v is None:
                continue
            slc = frame.lookup_var(v)
            if slc is None or slc.dims:
                continue
            cur = slc.values[0]
            ci = None if cur is None else self.domain.known_int(cur)
            i0 = None if ci is None else signed(ci)
            k = known(bnd)
            if i0 is None or k is None:
                continue
            inc = body_increment(v)
            if inc is None:
                continue
            span = k - i0 + (1 if le else 0)
            trips = max(0, -(-span // inc))
            # signed-safety: the counter must stay in the signed range
            # across the walk (no wraparound past p/2)
            if i0 + trips * inc > half:
                continue
            best = trips if best is None else min(best, trips)
        return best

    def _exec_log(self, s: A.LogCall, frame):
        parts = []
        for arg in s.args:
            if isinstance(arg, A.LogStr):
                parts.append(arg.string)
            else:
                v = self._eval(arg.expr, frame)
                k = self.domain.known_int(v)
                parts.append(str(k) if k is not None else "Unknown")
        line = " ".join(parts)
        self.log_sink.append(line)
        if self.verbose:
            # --verbose: known-value logs during constraint generation
            # (execute.rs:730-754 prints numbers, "Unknown" otherwise)
            print(line)

    def _exec_assert(self, s: A.Assert, frame):
        v = self._eval(s.arg, frame)
        known = self.domain.as_cond(v)
        if known is False:
            raise err("false assert reached", "T3001", s.meta)

    # ==================================================================
    # expression evaluation
    # ==================================================================
    def _eval(self, e, frame):
        if type(e) is A.Number:
            return self.domain.const(e.value)
        if type(e) is A.Variable:
            return self._eval_variable(e, frame)
        if type(e) is A.Infix:
            # InfixOperatorWithWrongTypes (T2028) / Prefix... (T2027)
            l = self._scalar(self._eval(e.lhe, frame), e.meta, "T2028")
            r = self._scalar(self._eval(e.rhe, frame), e.meta, "T2028")
            return self.domain.infix(e.op, l, r, e.meta)
        if type(e) is A.Prefix:
            v = self._scalar(self._eval(e.rhe, frame), e.meta, "T2027")
            return self.domain.prefix(e.op, v, e.meta)
        if type(e) is A.TernarySwitch:
            cond = self._scalar(self._eval(e.cond, frame), e.meta)
            known = self.domain.as_cond(cond)
            if known is not None:
                return self._eval(e.if_true if known else e.if_false, frame)
            a = self._scalar(self._eval(e.if_true, frame), e.meta)
            b = self._scalar(self._eval(e.if_false, frame), e.meta)
            return self.domain.select(cond, a, b)
        if type(e) is A.Call:
            return self._eval_call(e, frame)
        if type(e) is A.BusCall:
            params = [self._eval(a, frame) for a in e.args]
            known = [self._expect_known_arg(p) for p in params]
            return BusClosure(e.id, known)
        if type(e) is A.ArrayInLine:
            if not e.values:
                raise err("array declarations must be non-empty",
                          "T2026", e.meta)
            vals = [self._eval(v, frame) for v in e.values]
            if any(isinstance(v, (TemplateClosure, BusClosure))
                   for v in vals):
                # InvalidArrayType (error_code.rs T2034)
                raise err("arrays of templates or buses are not allowed",
                          "T2034", e.meta)
            return _stack_slices(vals, e.meta)
        if type(e) is A.UniformArray:
            v = self._eval(e.value, frame)
            n = self._index_value(self._eval(e.dimension, frame), e.meta,
                              what="size")
            vals = [v.copy() if isinstance(v, Slice) else v for _ in range(n)]
            return _stack_slices(vals, e.meta)
        if type(e) is A.ParallelOp:
            v = self._eval(e.rhe, frame)
            if isinstance(v, TemplateClosure):
                v.is_parallel = True
            return v
        if type(e) is A.TupleExpr:
            raise err("tuple in expression position (not yet desugared)",
                      "TAC02", e.meta)
        if type(e) is A.AnonymousComp:
            raise err("anonymous component (not yet desugared)", "TAC01",
                      e.meta)
        raise err(f"unsupported expression {type(e).__name__}", "T2038",
                  getattr(e, "meta", None))

    def _scalar(self, v, meta, code="T2044"):
        if isinstance(v, Slice):
            if v.dims:
                raise err("array used where scalar expected", code, meta)
            return v.values[0]
        if isinstance(v, TemplateClosure):
            raise err("template call used as value", "T2022", meta)
        return v

    def _index_value(self, v, meta, what="index"):
        v = self._scalar(v, meta)
        k = self.domain.known_int(v)
        if k is None:
            if what == "size":
                # NonConstantArrayLength (error_code.rs T20463)
                raise err("array length must be known at compile time",
                          "T20463", meta)
            # UnknownIndex (error_code.rs T2042)
            raise err("array index must be known at compile time",
                      "T2042", meta)
        return k

    def _eval_variable(self, e: A.Variable, frame):
        name = e.name
        if name in frame.signals:
            return self._read_signal(frame.signals[name], e, frame, prefix="")
        if name in frame.components:
            return self._read_component(e, frame)
        v = frame.lookup_var(name)
        if v is not None:
            idx_vals = []
            dynamic = False
            for a in e.access:
                if not isinstance(a, A.ArrayAccess):
                    raise err("invalid access on var", "T2032", e.meta)
                iv = self._scalar(self._eval(a.expr, frame), e.meta)
                idx_vals.append(iv)
                if self.domain.known_int(iv) is None:
                    dynamic = True
            if dynamic:
                return self._read_var_dynamic(v, idx_vals, frame, e.meta)
            idxs = [self.domain.known_int(iv) for iv in idx_vals]
            got = v.get(idxs, e.meta)
            if isinstance(got, Slice):
                return got
            if got is None:
                raise err(f"variable '{name}' used before assignment",
                          "T2003", e.meta)
            return got
        if name in self.archive.templates or name in self.archive.functions:
            raise err(f"'{name}' used as a value", "T2022", e.meta)
        raise err(f"undeclared symbol '{name}'", "T2021", e.meta)

    def _read_signal(self, decl, e, frame, prefix, access=None,
                     start_i=0):
        if isinstance(decl, PendingBus):
            raise err(f"bus '{decl.name}' used before initialization",
                      "BU06", e.meta)
        access = e.access if access is None else access
        # witness-dependent array index: select-chain read in the value
        # modes (the reference's generated code does runtime addressing,
        # load_bucket.rs; compile-time flattening uses selects);
        # conservative NonQuadratic in constrain mode — legal in `<--`,
        # rejected if it reaches a constraint (matches the static
        # unknown/known analysis' T20462).
        if (decl.layout is None and access and start_i == 0
                and all(isinstance(a, A.ArrayAccess) for a in access)
                and len(access) == len(decl.dims)):
            idx_vals = [self._scalar(self._eval(a.expr, frame), e.meta)
                        for a in access]
            if any(self.domain.known_int(v) is None for v in idx_vals):
                if self.mode == "constrain":
                    return NQ
                vals = decl.slice.values
                if any(x is None for x in vals):
                    raise err(
                        f"signal '{decl.name}' read before assignment",
                        "T2003", e.meta)
                lin = self._linear_index(idx_vals, decl.dims, e.meta)
                acc = vals[-1]
                for j in range(len(vals) - 2, -1, -1):
                    cond = self.domain.infix(A.EQ, lin,
                                             self.domain.const(j), e.meta)
                    acc = self.domain.select(cond, vals[j], acc)
                return acc
        res = self._resolve_wire(decl, access, frame, e.meta, start_i)
        if res[0] == "tag":
            if prefix and decl.xtype == A.SignalType.INPUT:
                # InputTagCannotBeAccessedOutside (T2048-C)
                raise err("the tags of an input signal cannot be "
                          "accessed outside its template", "T2048-C",
                          e.meta)
            tv = decl.tag_values[res[1]]
            if tv is None:
                # InvalidTagAccess (T2048)
                raise err(f"tag '{res[1]}' has no value", "T2048", e.meta)
            return self.domain.const(tv)
        _k, start, count = res
        if self.mode == "constrain":
            names = decl.elem_names
            if count == 1:
                return AExpr.signal(prefix + names[start])
            return Slice((count,), [
                AExpr.signal(prefix + names[start + j]) for j in range(count)
            ])
        vals = decl.slice.values[start:start + count]
        if any(x is None for x in vals):
            raise err(
                f"signal '{decl.name}' read before assignment",
                "T2005", e.meta,
            )
        return vals[0] if count == 1 else Slice((count,), list(vals))

    def _read_component(self, e: A.Variable, frame):
        idxs0, sig, rest = self._component_access_split(
            e.access, frame, e.meta)
        cslice = frame.components[e.name]
        cs = cslice.get(idxs0, e.meta)
        if isinstance(cs, Slice):
            raise err("component array used without full index", "T2032",
                      e.meta)
        if cs is None:
            raise err(f"component '{e.name}' used before instantiation",
                      "T2043", e.meta)
        if sig is None:
            raise err("component used as a value", "T2030", e.meta)
        decl = cs.signals.get(sig)
        if decl is None:
            raise err(f"'{sig}' is not a signal of template {cs.template}",
                      "T2016", e.meta)
        if decl.xtype == A.SignalType.OUTPUT and cs.inputs_remaining > 0:
            raise err(
                f"output '{sig}' of '{e.name}' read before all inputs are "
                "assigned", "T2046", e.meta,
            )
        if decl.xtype == A.SignalType.INPUT and self.mode == "constrain":
            raise err("subcomponent inputs cannot be read", "T2047", e.meta)
        return self._read_signal(decl, e, frame, prefix=cs.label + ".",
                                 access=rest)

    def _eval_call(self, e: A.Call, frame):
        if e.id in self.archive.functions:
            return self._call_function(e, frame)
        if e.id in self.archive.templates:
            params = [self._eval(a, frame) for a in e.args]
            known = [self._expect_known_arg(p, e.meta) for p in params]
            return TemplateClosure(e.id, known)
        if e.id in self.archive.buses:
            # bus calls are syntactically identical to template calls;
            # resolve by symbol table (type_reduction.rs analog)
            params = [self._eval(a, frame) for a in e.args]
            known = [self._expect_known_arg(p, e.meta) for p in params]
            return BusClosure(e.id, known)
        raise err(f"unknown function or template '{e.id}'", "T20461",
                  e.meta)

    def _call_function(self, e: A.Call, frame):
        fn = self.archive.functions[e.id]
        if len(e.args) != len(fn.args):
            raise err(
                f"function {e.id} expects {len(fn.args)} arguments, got "
                f"{len(e.args)}", "T2005", e.meta,
            )
        sub = Frame("function", e.id)
        sub.unknown_depth = frame.unknown_depth
        for name, argexpr in zip(fn.args, e.args):
            v = self._eval(argexpr, frame)
            sub.declare_var(name, _as_slice(v))
        try:
            self._exec_stmt(fn.body, sub)
        except FunctionReturn as r:
            return r.value
        raise err(f"function '{e.id}' ended without return", "T2015", e.meta)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def _as_slice(v):
    return v if isinstance(v, Slice) else Slice.scalar(v)


def _size_of(dims):
    n = 1
    for d in dims:
        n *= d
    return n


def _flatten_params(params):
    out = []
    for p in params:
        if isinstance(p, Slice):
            out.extend(p.values)
        else:
            out.append(p)
    return out


def _nested_to_slice(v):
    if not isinstance(v, (list, tuple)):
        return Slice.scalar(v)
    dims = []
    probe = v
    while isinstance(probe, (list, tuple)):
        dims.append(len(probe))
        probe = probe[0]
    flat = []

    def rec(x, depth):
        if depth == len(dims):
            flat.append(x)
            return
        for item in x:
            rec(item, depth + 1)

    rec(v, 0)
    return Slice(dims, flat)


def _stack_slices(vals, meta):
    if not vals:
        raise err("empty inline array", "T2019", meta)
    if isinstance(vals[0], Slice):
        dims = (len(vals),) + tuple(vals[0].dims)
        flat = []
        for v in vals:
            if not isinstance(v, Slice) or tuple(v.dims) != tuple(vals[0].dims):
                raise err("ragged inline array", "T2019", meta)
            flat.extend(v.values)
        return Slice(dims, flat)
    return Slice((len(vals),), list(vals))


def _map_constraint(c, corr):
    def m(d):
        out = {}
        for k, v in d.items():
            if k == alg.CONST:
                out[alg.CONST] = v
            else:
                out[corr[k]] = v
        return out

    return alg.Constraint(m(c.a), m(c.b), m(c.c))


def _tag_range_hint(tag_values):
    """Signed range asserted by a wire's tags, or None.

    `binary` (valueless, circomlib convention) asserts {0,1}; a valued
    `maxbit` tag asserts [0, 2^maxbit); only int32-useful widths are
    recorded (the narrow lane cannot exploit wider ones)."""
    if "binary" in tag_values:
        return (0, 1)
    v = tag_values.get("maxbit")
    if isinstance(v, int) and 0 <= v <= 31:
        return (0, (1 << v) - 1)
    return None


def _child_stmts(st):
    """Direct child statements (for nested-write detection)."""
    if isinstance(st, A.Block):
        return list(st.stmts)
    if isinstance(st, A.InitializationBlock):
        return list(st.initializations)
    if isinstance(st, A.IfThenElse):
        return [st.if_case] + (
            [st.else_case] if st.else_case is not None else [])
    if isinstance(st, A.While):
        return [st.stmt]
    return []


def _snapshot_scopes(frame):
    return [
        {k: (v.copy() if isinstance(v, Slice) else v) for k, v in scope.items()}
        for scope in frame.scopes
    ]


def _restore_scopes(frame, snapshot):
    frame.scopes = snapshot


def _merge_scopes(state_a, state_b, cond, domain):
    merged = []
    for sa, sb in zip(state_a, state_b):
        scope = {}
        for k in sa:
            va, vb = sa[k], sb.get(k)
            if vb is None:
                scope[k] = va
                continue
            if isinstance(va, Slice) and isinstance(vb, Slice):
                vals = []
                for x, y in zip(va.values, vb.values):
                    if x is None or y is None:
                        vals.append(x if y is None else y)
                    elif x is y:
                        vals.append(x)
                    else:
                        vals.append(domain.select(cond, x, y))
                scope[k] = Slice(va.dims, vals)
            else:
                scope[k] = va
        merged.append(scope)
    return merged
