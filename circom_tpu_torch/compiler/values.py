"""Runtime value structures for the circuit executor.

Slice mirrors the reference's MemorySlice (program_structure/src/utils/
memory_slice.rs:23-48): an n-dimensional array value with `dims` (route)
and a flat row-major `values` store.  ComponentState mirrors
ComponentRepresentation (constraint_generation/src/environment_utils/
component_representation.rs): pending inputs, deferred execution,
output availability.
"""

from ..utils.reports import Report


class ExecError(Exception):
    """Wraps a Report raised during execution."""

    def __init__(self, report: Report):
        super().__init__(report.message)
        self.report = report


def err(message, code="T2000", meta=None):
    r = Report.error(message, code)
    if meta is not None:
        r.add_primary(meta.file_id, meta.start, meta.end)
    return ExecError(r)


class Slice:
    """Row-major n-dim store; dims == () is a scalar cell."""

    __slots__ = ("dims", "values")

    def __init__(self, dims, values):
        self.dims = tuple(dims)
        self.values = values  # flat list

    @staticmethod
    def scalar(v):
        return Slice((), [v])

    @staticmethod
    def filled(dims, fill):
        n = 1
        for d in dims:
            n *= d
        return Slice(dims, [fill] * n)

    def size(self):
        return len(self.values)

    def route_offset(self, idxs, meta=None):
        """Partial index -> (flat start, remaining dims)."""
        if not idxs:  # scalar / whole-slice access (the common case)
            return 0, self.dims
        if len(idxs) > len(self.dims):
            # InvalidArrayAccess (error_code.rs T2032)
            raise err("too many array indices", "T2032", meta)
        off = 0
        stride = self.size()
        for k, i in enumerate(idxs):
            d = self.dims[k]
            if not (0 <= i < d):
                # runtime out-of-bounds (reference RuntimeError T3001)
                raise err(
                    f"index {i} out of bounds for dimension of size {d}",
                    "T3001", meta,
                )
            stride //= d
            off += i * stride
        return off, self.dims[len(idxs):]

    def get(self, idxs, meta=None):
        """Full or partial access -> scalar value or sub-Slice."""
        off, rest = self.route_offset(idxs, meta)
        if not rest:
            return self.values[off]
        n = 1
        for d in rest:
            n *= d
        return Slice(rest, self.values[off:off + n])

    def set(self, idxs, value, meta=None):
        """Assign scalar or whole sub-slice at idxs."""
        off, rest = self.route_offset(idxs, meta)
        if not rest:
            if isinstance(value, Slice):
                if value.dims:
                    raise err("assigning array to scalar position", "T2019", meta)
                value = value.values[0]
            self.values[off] = value
        else:
            if not isinstance(value, Slice):
                raise err("assigning scalar to array position", "T2019", meta)
            if tuple(value.dims) != tuple(rest):
                raise err(
                    f"dimension mismatch in assignment: {value.dims} vs {rest}",
                    "T2019", meta,
                )
            n = value.size()
            self.values[off:off + n] = value.values
        return self

    def copy(self):
        return Slice(self.dims, list(self.values))

    def __repr__(self):
        return f"Slice{self.dims}{self.values!r}"


def indexed_names(base, dims):
    """Row-major element names: base, or base[0][1] style
    (matches the reference's generate_symbols naming)."""
    if not dims:
        return [base]
    out = []

    def rec(prefix, ds):
        if not ds:
            out.append(prefix)
            return
        for i in range(ds[0]):
            rec(f"{prefix}[{i}]", ds[1:])

    rec(base, list(dims))
    return out


class TemplateClosure:
    """Result of evaluating `Foo(params)` before component binding."""

    __slots__ = ("name", "params", "is_parallel")

    def __init__(self, name, params, is_parallel=False):
        self.name = name
        self.params = params  # list of int or Slice of int
        self.is_parallel = is_parallel


class BusLayout:
    """Field layout of one bus instance (ExecutedBus / BusInstance analog,
    compiler/src/hir/very_concrete_program.rs:139-144).

    fields: list of (name, dims, sub_layout_or_None) in declaration order.
    field_tags: {field_name: tuple of tag names declared on the field in
    the bus definition} — the declaration side of the reference's
    per-field TagWire recursion (execution_data/type_definitions.rs:21-23,
    assignment_utils.rs:130 perform_tag_propagation_bus).
    """

    __slots__ = ("bus_name", "params_key", "fields", "size", "_offsets",
                 "field_tags", "_segcache")

    def __init__(self, bus_name, params_key, fields, field_tags=None):
        self.bus_name = bus_name
        self.params_key = params_key
        self.fields = fields
        self.field_tags = field_tags or {}
        self._segcache = {}
        self._offsets = {}
        off = 0
        for (name, dims, sub) in fields:
            n = 1
            for d in dims:
                n *= d
            n *= sub.size if sub is not None else 1
            self._offsets[name] = (off, n)
            off += n
        self.size = off

    def field(self, name):
        for (fname, dims, sub) in self.fields:
            if fname == name:
                off, n = self._offsets[name]
                return off, n, dims, sub
        return None

    def leaf_suffixes(self):
        """Flat element suffixes (".x", ".v[0].y", ...) in layout order."""
        out = []
        for (fname, dims, sub) in self.fields:
            for iname in indexed_names(fname, dims):
                if sub is None:
                    out.append("." + iname)
                else:
                    out.extend("." + iname + s for s in sub.leaf_suffixes())
        return out

    def key(self):
        return (self.bus_name, self.params_key)

    def declared_tag_paths(self, prefix=""):
        """All declared field-tag paths of this layout, recursively,
        as dotted strings relative to the wire ("x.binary",
        "sub.y.maxbit") — the flattened form of the reference's
        per-field TagWire tree."""
        out = []
        for (fname, _dims, sub) in self.fields:
            for t in self.field_tags.get(fname, ()):
                out.append(prefix + fname + "." + t)
            if sub is not None:
                out.extend(sub.declared_tag_paths(prefix + fname + "."))
        return out

    def field_segments(self, path):
        """Leaf (offset, count) segments WITHIN ONE wire element for a
        dotted field path ("a" or "a.b").  A field nested under an
        arrayed bus field contributes one segment per element of that
        array — tags are per-field across all positions ("only have a
        tag in case it inherits the tag in all positions",
        assignment_utils.rs:50).  Returns None for an unknown path.
        Memoized: layouts are immutable and shared per bus instance,
        and per-field tag gating asks for the same path on every
        assignment of a bus-array wire."""
        hit = self._segcache.get(path, False)
        if hit is not False:
            return hit
        parts = path.split(".")
        layout = self
        base_offsets = [0]
        for k, fname in enumerate(parts):
            if layout is None:
                return None
            f = layout.field(fname)
            if f is None:
                return None
            off, n, dims, sub = f
            n_el = 1
            for d in dims:
                n_el *= d
            el_size = n // n_el if n_el else 0
            new_offsets = []
            for b in base_offsets:
                for e in range(n_el):
                    new_offsets.append(b + off + e * el_size)
            if k == len(parts) - 1:
                segs = [(b, el_size) for b in new_offsets]
                self._segcache[path] = segs
                return segs
            base_offsets = new_offsets
            layout = sub
        self._segcache[path] = None
        return None


class BusClosure:
    """Result of evaluating `BusName(params)` before wire binding."""

    __slots__ = ("name", "params")

    def __init__(self, name, params):
        self.name = name
        self.params = params


class SignalDecl:
    """Per-wire metadata within an instance (signal or bus wire)."""

    __slots__ = ("name", "dims", "xtype", "tags", "tag_values", "slice",
                 "assigned", "layout", "elem_names", "value_defined")

    def __init__(self, name, dims, xtype, tags, layout=None):
        self.name = name
        self.dims = tuple(dims)
        self.xtype = xtype              # SignalType
        self.tags = list(tags)
        # field tags declared in the bus definition enter the same
        # dicts under DOTTED paths ("x.binary") — the flattened form
        # of the reference's recursive TagWire (type_definitions.rs:
        # 21-23); all wire-level tag machinery (inherit/intersect/
        # strict-input checks/memo keys/recipe codec) then covers
        # fields for free
        if layout is not None:
            for pth in layout.declared_tag_paths():
                if pth not in self.tags:
                    self.tags.append(pth)
        self.tag_values = {t: None for t in self.tags}
        # tags whose value was fixed by the user (`x.tag = v`); such a
        # value is never overwritten by propagation
        # (assignment_utils.rs TagState.value_defined)
        self.value_defined = set()
        self.layout = layout            # BusLayout | None
        per = layout.size if layout is not None else 1
        n = per
        for d in dims:
            n *= d
        self.slice = Slice((n,), [None] * n)   # flat leaf values
        self.assigned = Slice((n,), [False] * n)
        if layout is None:
            self.elem_names = indexed_names(name, dims)
        else:
            suf = layout.leaf_suffixes()
            self.elem_names = [
                base + s for base in indexed_names(name, dims) for s in suf
            ]

    def total_size(self):
        return len(self.slice.values)

    def unassigned_count(self):
        return sum(1 for a in self.assigned.values if not a)


class DynamicComponentSlice:
    """Growable component store for anonymous components declared inside
    loops (VariableType::AnonymousComponent): sized by use, not by a
    declared dimension."""

    __slots__ = ("_store",)

    def __init__(self):
        self._store = {}

    @property
    def values(self):
        return list(self._store.values())

    @property
    def dims(self):
        return ("dyn",)

    def get(self, idxs, meta=None):
        return self._store.get(tuple(idxs))

    def set(self, idxs, value, meta=None):
        self._store[tuple(idxs)] = value
        return self


class ComponentState:
    """A subcomponent instance during execution."""

    __slots__ = (
        "template", "params", "is_parallel", "label", "node_id",
        "signals", "inputs_remaining", "executed", "instantiated",
        "input_tag_values", "child_instances", "meta_name", "pending_inputs",
        "is_anonymous",
    )

    def __init__(self):
        self.template = None
        self.params = None
        self.is_parallel = False
        self.label = None               # e.g. "c[0]" within parent
        self.node_id = None             # DAG node (constrain pass)
        self.signals = {}               # name -> SignalDecl (io of the child)
        self.inputs_remaining = 0
        self.executed = False
        self.instantiated = False
        self.input_tag_values = {}      # signal -> {tag: value}
        self.child_instances = {}       # label -> ComponentState (witness mode)
        self.meta_name = ""
        self.pending_inputs = []        # assigned before instantiation
        self.is_anonymous = False
