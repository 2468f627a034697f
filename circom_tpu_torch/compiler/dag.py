"""Hierarchical constraint store (DAG of unique template instances).

Mirrors the reference dag crate (dag/src/lib.rs): one Node per unique
(template, parameters, tags) instance holding local signal numbering
(outputs first, then public inputs, private inputs, intermediates; ids
start at 1 — wire 0 is the constant; lib.rs:179-215), Edges carrying
signal-offset ranges into subtrees (lib.rs:330-371, appended in
(component-name, index) sorted order, executed_template.rs:313-328), and a
DFS Tree traversal that materializes global signal numbering by offsets
(lib.rs:21-86).  The O0 witness is [0] + DFS locals
(witness_producer.rs:3-19).
"""

from dataclasses import dataclass, field

from .algebra import CONST, Constraint


@dataclass
class Edge:
    label: str
    goes_to: int
    in_number: int
    out_number: int
    in_component_number: int
    out_component_number: int


class Node:
    def __init__(self, node_id, template_name, parameters, is_parallel,
                 is_custom_gate):
        self.id = node_id
        self.template_name = template_name
        self.parameters = parameters
        self.is_parallel = is_parallel
        self.is_custom_gate = is_custom_gate
        self.number_of_signals = 0      # own + absorbed subtree counts
        self.number_of_components = 1
        self.inputs_length = 0
        self.outputs_length = 0
        self.public_inputs_length = 0
        self.intermediates_length = 0
        self.signal_correspondence = {}  # indexed name -> local id
        self.ordered_signals = []        # custom-gate signal order
        self.locals = set()
        self.forbidden_if_main = {0}
        self.io_signals = []
        self.constraints = []            # over local ids
        self.underscored_signals = []
        self.has_parallel_sub_cmp = False
        self.number_of_subcomponents_indexes = 0

    # wire insertion (lib.rs:179-215) -----------------------------------
    def add_output(self, name):
        sid = self.number_of_signals + 1
        self.io_signals.append(sid)
        self.signal_correspondence[name] = sid
        self.forbidden_if_main.add(sid)
        self.locals.add(sid)
        self.number_of_signals += 1
        self.outputs_length += 1
        return sid

    def add_input(self, name, is_public):
        sid = self.number_of_signals + 1
        self.io_signals.append(sid)
        self.signal_correspondence[name] = sid
        self.locals.add(sid)
        self.number_of_signals += 1
        self.inputs_length += 1
        if is_public:
            self.public_inputs_length += 1
            self.forbidden_if_main.add(sid)
        return sid

    def add_intermediate(self, name):
        sid = self.number_of_signals + 1
        self.signal_correspondence[name] = sid
        self.locals.add(sid)
        self.number_of_signals += 1
        self.intermediates_length += 1
        return sid

    def is_local_signal(self, s):
        return s in self.locals

    def local_signals_sorted(self):
        return sorted(self.locals)


class DAG:
    def __init__(self, prime: str):
        self.prime = prime
        self.one_signal = 0
        self.nodes: list[Node] = []
        self.adjacency: list[list[Edge]] = []

    def main_id(self):
        return len(self.nodes) - 1

    def get_main(self) -> Node:
        return self.nodes[-1]

    def add_node(self, template_name, parameters, is_parallel, is_custom_gate):
        nid = len(self.nodes)
        self.nodes.append(
            Node(nid, template_name, parameters, is_parallel, is_custom_gate)
        )
        self.adjacency.append([])
        return nid

    def add_edge(self, to: int, label: str, is_parallel: bool) -> Edge:
        """Absorb a subcomponent's signal range into the current node
        (lib.rs:328-371)."""
        frm = self.main_id()
        assert to < frm
        node_f, node_t = self.nodes[frm], self.nodes[to]
        in_num = node_f.number_of_signals
        in_cmp = node_f.number_of_components
        out_num = in_num + node_t.number_of_signals
        out_cmp = in_cmp + node_t.number_of_components
        node_f.number_of_signals += node_t.number_of_signals
        node_f.number_of_components += node_t.number_of_components
        node_f.has_parallel_sub_cmp |= node_t.is_parallel or is_parallel
        edge = Edge(label, to, in_num, out_num, in_cmp, out_cmp)
        for signal, sid in node_t.signal_correspondence.items():
            if node_t.is_local_signal(sid):
                node_f.signal_correspondence[f"{label}.{signal}"] = in_num + sid
        self.adjacency[frm].append(edge)
        return edge

    # traversal ---------------------------------------------------------
    def walk(self):
        """DFS yielding (path, node, offset) with global numbering
        (Tree, lib.rs:21-86)."""

        def rec(path, node_id, offset):
            node = self.nodes[node_id]
            yield (path, node, offset)
            for e in self.adjacency[node_id]:
                yield from rec(f"{path}.{e.label}", e.goes_to, offset + e.in_number)

        yield from rec("main", self.main_id(), 0)

    def produce_witness(self):
        """O0 witness list (witness_producer.rs:3-19)."""
        witness = [0]
        for _path, node, offset in self.walk():
            for s in node.local_signals_sorted():
                witness.append(s + offset)
        return witness

    def global_constraints(self):
        """All constraints with global ids, DFS order (map_to_constraint_list
        analog)."""
        out = []
        for _path, node, offset in self.walk():
            for c in node.constraints:
                if not c.is_empty():
                    out.append(self._offset_constraint(c, offset))
        return out

    @staticmethod
    def _offset_constraint(c: Constraint, offset: int) -> Constraint:
        def m(d):
            return {(k if k == CONST else k + offset): v for k, v in d.items()}

        return Constraint(m(c.a), m(c.b), m(c.c))

    def total_signals(self):
        """Number of signals incl. the constant wire."""
        return self.get_main().number_of_signals + 1

    def public_info(self):
        """(n_pub_out, n_pub_in, n_prv_in) of the main node."""
        m = self.get_main()
        return m.outputs_length, m.public_inputs_length, \
            m.inputs_length - m.public_inputs_length

    def sym_entries(self):
        """(global_id, node_id, qualified_name) in .sym order
        (dag/src/sym_porting.rs: DFS, per node sorted local signals)."""
        out = []
        for path, node, offset in self.walk():
            inv = {}
            for name, sid in node.signal_correspondence.items():
                if node.is_local_signal(sid):
                    inv[sid] = name
            for s in node.local_signals_sorted():
                out.append((s + offset, node.id, f"{path}.{inv[s]}"))
        return out
