"""Compilation pipeline: source -> archive -> DAG -> artifacts -> witness.

Drives the same sequence as the reference CLI (circom/src/main.rs:23-70):
parse -> analyse -> execute (constraints + instances) -> simplify
(O0/O1/O2, constraint_list crate) -> export, plus the TPU-specific
witness paths (host calculator / tape).
"""

import os

from ..frontend.archive import run_parser
from ..frontend import ast as A
from ..field.primes import PRIMES, field_spec
from ..field.hostfield import HostField
from ..utils.reports import Report, ReportCollection
from ..emit.binfmt import write_r1cs, write_wtns, field_size_bytes
from ..backend.tape import Tape
from .executor import Executor
from .dag import DAG
from .algebra import CONST
from .simplify import SimplifiedSystem, simplify


def _bit_constraint_signal(a, b, c, hf):
    """If A*B-C=0 involves exactly one signal x (plus the constant
    wire) and is equivalent to x*(x-1)=0, return x, else None.

    q(x) = (a1 x + a0)(b1 x + b0) - (c1 x + c0) with a1*b1 != 0 and
    q(0) = q(1) = 0 factors as a1*b1 * x * (x-1): roots exactly {0,1}.
    """
    sigs = set()
    for d in (a, b, c):
        for k in d:
            if k != CONST:
                sigs.add(k)
    if len(sigs) != 1:
        return None
    (x,) = sigs
    a1, a0 = a.get(x, 0), a.get(CONST, 0)
    b1, b0 = b.get(x, 0), b.get(CONST, 0)
    c1, c0 = c.get(x, 0), c.get(CONST, 0)
    if a1 == 0 or b1 == 0:
        return None
    p = hf.p
    if (a0 * b0 - c0) % p:
        return None
    if ((a1 + a0) * (b1 + b0) - c1 - c0) % p:
        return None
    return x


class CompiledCircuit:
    def __init__(self, archive, dag: DAG, memo, main_node_id,
                 simplification: str = "O1", rounds: int = 0,
                 parallel: bool = False, use_old_heuristics: bool = False):
        self.archive = archive
        self.dag = dag
        self.memo = memo
        self.main_node_id = main_node_id
        self.p = archive.field_p
        self.simplification = simplification
        self.hf = HostField(field_spec(archive.prime))
        if simplification == "O0":
            self.simplified = None
        else:
            if simplification == "O2" and rounds == 0:
                rounds = 1 << 30  # plain --O2: iterate to fixpoint
            self.simplified = simplify(dag, self.hf, simplification, rounds,
                                       parallel=parallel,
                                       use_old_heuristics=use_old_heuristics)

    # -- constraint artifacts -------------------------------------------
    def r1cs_rows(self):
        """Constraint rows over final wire ids."""
        if self.simplified is None:
            return [(c.a, c.b, c.c) for c in self.dag.global_constraints()]
        return self.simplified.remapped_rows()

    def counts(self):
        n_out, n_pub_in, n_prv_in = self.dag.public_info()
        if self.simplified is None:
            n_wires = self.dag.total_signals()
            labels = n_wires
            wire2label = list(range(n_wires))
        else:
            n_wires = self.simplified.no_wires()
            labels = self.simplified.n_labels
            wire2label = self.simplified.witness_as_vec()
        return {
            "n_wires": n_wires, "n_labels": labels,
            "n_pub_out": n_out, "n_pub_in": n_pub_in, "n_prv_in": n_prv_in,
            "wire2label": wire2label,
        }

    def write_r1cs(self, path):
        c = self.counts()
        custom = self.archive.custom_gates
        kw = {}
        if custom:
            kw["custom_gates_used"] = self._custom_gates_used()
            kw["custom_gates_applied"] = self._custom_gates_applied()
        write_r1cs(
            path, self.p, self.r1cs_rows(),
            c["n_wires"], c["n_pub_out"], c["n_pub_in"], c["n_prv_in"],
            c["n_labels"], wire2label=c["wire2label"], **kw,
        )

    def _custom_gates_used(self):
        out = []
        for node in self.dag.nodes:
            if node.is_custom_gate:
                name = node.template_name
                out.append((name, node.parameters))
        return out

    def _custom_gates_applied(self):
        order = [n.template_name for n in self.dag.nodes if n.is_custom_gate]
        out = []
        for _path, node, offset in self.dag.walk():
            if node.is_custom_gate:
                signals = [s + offset for s in node.ordered_signals]
                out.append((order.index(node.template_name), signals))
        return out

    def sym_lines(self):
        """`original,witness,node_id,symbol` lines
        (constraint_writers/src/sym_writer.rs:4-37)."""
        lines = []
        smap = None if self.simplified is None else self.simplified.signal_map
        for (gid, nid, name) in self.dag.sym_entries():
            wit = gid if smap is None else smap.get(gid, -1)
            lines.append(f"{gid},{wit},{nid},{name}")
        return lines

    def write_sym(self, path):
        with open(path, "w") as f:
            for line in self.sym_lines():
                f.write(line + "\n")

    # -- witness paths ---------------------------------------------------
    def witness_host(self, inputs: dict, sanity_check=2):
        """Reference-semantics host witness calculation -> canonical ints
        in final witness order."""
        ex = Executor(self.archive, "hostwit", dag=self.dag, memo=self.memo,
                      sanity_check=sanity_check)
        ex.run_witness(inputs)
        full = self._assemble(ex.instances_by_path, const_one=1)
        return self._select_witness(full)

    def _select_witness(self, full):
        if self.simplified is None:
            return full
        return [full[old] for old in self.simplified.witness_as_vec()]

    def build_tape(self, while_max_unroll: int = 64):
        """Flatten the witness computation to an SSA tape (TPU path).

        Tape outputs are the FINAL witness (simplification-compacted).
        ``while_max_unroll``: unroll bound for data-dependent while
        loops whose trip count cannot be derived statically (CLI
        --while_max_unroll; executor._exec_while_predicated).
        """
        tape = Tape(self.p)
        main_node = self.dag.nodes[self.main_node_id]
        inputs = {}
        idx = 0
        from .values import Slice

        for (name, dims, xtype, _tags, layout) in main_node.wire_info:
            if xtype == A.SignalType.INPUT:
                n = 1
                for d in dims:
                    n *= d
                if layout is not None:
                    n *= layout.size
                refs = [tape.input(idx + j) for j in range(n)]
                inputs[name] = Slice((n,), refs)
                idx += n
        ex = Executor(self.archive, "tape", tape=tape, dag=self.dag,
                      memo=self.memo, while_max_unroll=while_max_unroll)
        ex.run_witness(inputs)
        full = self._assemble(ex.instances_by_path, const_one=1)
        refs = self._select_witness(full)
        out_refs = [tape.const(r) if isinstance(r, int) else r for r in refs]
        tape.set_outputs(out_refs)
        if ex.tape_guards:
            # data-dependent while loops were unrolled with predication;
            # the summed active-flags ride as ONE trailing output the
            # runtime must verify is zero (nonzero = some batch element
            # needed more iterations than the unroll bound)
            g = ex.tape_guards[0]
            for x in ex.tape_guards[1:]:
                g = tape.emit("add", g, x)
            tape.outputs.append(g.id)
            tape.n_guards = 1
        return tape, self.input_layout()

    def input_layout(self):
        """[(input name, dims, flat offset)] for the main component."""
        main_node = self.dag.nodes[self.main_node_id]
        out = []
        off = 0
        for (name, dims, xtype, _tags, layout) in main_node.wire_info:
            if xtype == A.SignalType.INPUT:
                n = 1
                for d in dims:
                    n *= d
                if layout is not None:
                    n *= layout.size
                out.append((name, tuple(dims), off))
                off += n
        return out

    def input_range_hints(self):
        """{flat main-input index: (lo, hi)} proven by the constraint
        system itself: a main input x carrying a bit constraint
        x*(x-1) === 0 is {0,1} in every valid witness, so the narrow
        int32 lane may compute on it directly (backend/ranges.py).

        This is the automatic analog of the range information the
        reference exports through signal tags — main inputs cannot be
        tagged (type_check.rs:109 MainComponentWithTags), so the hints
        come from the constraints instead.  Sound under the same
        contract as the reference's emitted runtimes with asserts on
        (--sanity_check >= 1 validates every constraint on-device, so
        an out-of-range input fails loudly rather than silently
        diverging).
        """
        main_node = self.dag.nodes[self.main_node_id]
        elem_to_sid = {v: k for k, v in main_node.id_to_elem.items()}
        # flat input index -> global signal id (main is the walk root,
        # offset 0, so local ids ARE global ids)
        gid_of = []
        for (name, dims, xtype, _tags, layout) in main_node.wire_info:
            if xtype != A.SignalType.INPUT:
                continue
            n = 1
            for d in dims:
                n *= d
            if layout is not None:
                n *= layout.size
            for j in range(n):
                gid_of.append(elem_to_sid.get((name, j)))
        # final wire ids of those inputs
        smap = (None if self.simplified is None
                else self.simplified.signal_map)
        wire_of = [g if smap is None else smap.get(g) for g in gid_of]
        rows = self.r1cs_rows()
        bits = set()
        for (a, b, c) in rows:
            s = _bit_constraint_signal(a, b, c, self.hf)
            if s is not None:
                bits.add(s)
        hints = {flat: (0, 1) for flat, w in enumerate(wire_of)
                 if w is not None and w in bits}
        # Num2Bits-style decompositions: a LINEAR constraint tying one
        # non-bit wire w to bit-constrained wires,
        #   c_w*w + sum(c_j*b_j) + c0 = 0  =>  w = e + sum(d_j*b_j),
        # gives w the exact interval hull over b_j in {0,1} — e.g. a
        # byte-valued input checked by Num2Bits(8) proves (0, 255).
        # Sound for the same reason as the bit hints: the equation
        # holds in every VALID witness, and an int32 hull lies well
        # inside (-p/2, p/2) so the signed representative IS the value.
        NM = (1 << 31) - 1
        p = self.hf.p
        half = p >> 1

        def signed(v):
            return v - p if v > half else v

        deco = {}
        for (a, b, c) in rows:
            if a or b:
                continue
            others = [w for w in c if w != CONST and w not in bits]
            if len(others) != 1:
                continue
            w = others[0]
            try:
                inv = (-pow(c[w], -1, p)) % p
            except ValueError:
                continue
            lo = hi = signed((c.get(CONST, 0) * inv) % p)
            ok = True
            for bw, cv in c.items():
                if bw == CONST or bw == w:
                    continue
                s = signed((cv * inv) % p)
                if abs(s) > NM:
                    ok = False
                    break
                lo += min(0, s)
                hi += max(0, s)
            if not ok or lo < -NM or hi > NM:
                continue
            old = deco.get(w)
            deco[w] = (lo, hi) if old is None else (max(old[0], lo),
                                                    min(old[1], hi))
        for flat, w in enumerate(wire_of):
            if flat in hints or w is None or w not in deco:
                continue
            lo, hi = deco[w]
            if lo <= hi:
                hints[flat] = (lo, hi)
        return hints

    def _assemble(self, instances_by_path, const_one):
        """Collect witness values in O0 global order ([0]=1, then DFS)."""
        values = [const_one]
        for path, node, offset in self.dag.walk():
            inst = instances_by_path.get(path)
            if inst is None:
                raise Report.error(
                    f"no executed instance for {path}", "T2048")
            for local_id in node.local_signals_sorted():
                wire_name, flat_idx = node.id_to_elem[local_id]
                decl = inst.signals.get(wire_name)
                v = None if decl is None else decl.slice.values[flat_idx]
                if v is None:
                    v = 0  # unassigned signal defaults to 0 (wasm semantics)
                values.append(v)
        return values

    def witness_order_size(self):
        c = self.counts()
        return c["n_wires"]

    def inspect(self):
        """--inspect warnings (constraint_correctness_analysis.rs:73-173):
        local signals (CA01) and subcomponent io signals (CA02) that do
        not appear in any constraint of the (father) component; arrays
        group into one warning with examples; underscored signals count
        as used; one report per template name; custom gates skipped."""
        warnings = []
        visited = set()
        for node_id, node in enumerate(self.dag.nodes):
            if node.is_custom_gate or node.template_name in visited:
                continue
            visited.add(node.template_name)
            used = set(node.underscored_signals)
            for c in node.constraints:
                used |= c.signals()
            # reachable = own locals + direct subcomponent io
            reach_io = set()
            for edge in self.dag.adjacency[node_id]:
                child = self.dag.nodes[edge.goes_to]
                for sid in child.io_signals:
                    reach_io.add(edge.in_number + sid)
            groups = {}  # base name -> [is_local, [examples]]
            for name, s in sorted(node.signal_correspondence.items()):
                is_local = s in node.locals
                if not is_local and s not in reach_io:
                    continue  # nested subcomponent internals
                if s in used:
                    continue
                base = name.split("[")[0]
                g = groups.setdefault(base, [is_local, []])
                g[1].append(name)
            for base, (is_local, ex) in sorted(groups.items()):
                kind = ("Local signal" if is_local
                        else "Subcomponent input/output signal")
                suffix = ("" if is_local
                          else " of the father component")
                code = "CA01" if is_local else "CA02"
                if len(ex) == 1:
                    msg = (f'In template "{node.template_name}": {kind} '
                           f"{ex[0]} does not appear in any "
                           f"constraint{suffix}")
                    warnings.append(Report.warning(msg, code))
                else:
                    msg = (f'In template "{node.template_name}": Array '
                           f"of {kind.lower()}s {base} contains a total "
                           f"of {len(ex)} signals that do not appear in "
                           f"any constraint{suffix}")
                    r = Report.warning(msg, code)
                    r.add_note(f"For example: {ex[0]}, {ex[1]}.")
                    warnings.append(r)
        return warnings


def compile_circuit(path: str, prime: str = "bn128", link_libraries=(),
                    no_init: bool = False, simplification: str = "O1",
                    rounds: int = 0, parallel: bool = False,
                    use_old_heuristics: bool = False,
                    verbose: bool = False) -> CompiledCircuit:
    spec = field_spec(prime)
    archive, warnings = run_parser(
        path, spec.p, prime, link_libraries, no_init)
    from ..analysis.checks import analyse_program

    analyse_program(archive)
    ex = Executor(archive, "constrain", verbose=verbose)
    main_node_id = ex.run_constrain()
    return CompiledCircuit(archive, ex.dag, ex.memo, main_node_id,
                           simplification, rounds, parallel=parallel,
                           use_old_heuristics=use_old_heuristics)


def compile_source(source: str, prime: str = "bn128", tmpdir=None,
                   **kw) -> CompiledCircuit:
    """Convenience: compile from a source string (tests)."""
    import tempfile

    d = tmpdir or tempfile.mkdtemp(prefix="circom_tpu_")
    p = os.path.join(d, "main.circom")
    with open(p, "w") as f:
        f.write(source)
    return compile_circuit(p, prime=prime, **kw)
