"""JSON input loading for witness generation.

Mirrors the host protocol of the reference calculators
(code_producers/src/wasm_elements/common/witness_calculator.js:278-330 and
c_elements/common/main.cpp:144-225): values may be numbers, decimal or
hex strings, booleans, or nested arrays; negative values reduce mod p.
Bus dot-path qualification ("p.x") arrives with bus support.
"""

import json

from ..utils.reports import Report


def _to_int(v, p):
    if isinstance(v, bool):
        return int(v) % p
    if isinstance(v, int):
        return v % p
    if isinstance(v, float):
        if v != int(v):
            raise Report.error(f"non-integer input value {v}", "T3010")
        return int(v) % p
    if isinstance(v, str):
        s = v.strip()
        try:
            return int(s, 16 if s.lower().startswith("0x") else 10) % p
        except ValueError:
            raise Report.error(f"cannot parse input value {v!r}", "T3010")
    raise Report.error(f"unsupported input value type {type(v).__name__}",
                      "T3010")


def _convert(v, p):
    if isinstance(v, list):
        return [_convert(x, p) for x in v]
    return _to_int(v, p)


def load_inputs(path_or_dict, p: int) -> dict:
    """input.json -> {signal name: int | nested lists of int}.

    Dot-qualified keys ("p.x", "p.y") are grouped under the bus wire name
    as a field dict (witness_calculator.js:278-330 qualification).
    """
    if isinstance(path_or_dict, dict):
        data = path_or_dict
    else:
        with open(path_or_dict) as f:
            data = json.load(f)
    if isinstance(data, list):
        # a batch file handed to the single-witness path: accept a
        # singleton, reject anything ambiguous (the reference's
        # witness_calculator takes exactly one input object)
        if len(data) == 1 and isinstance(data[0], dict):
            data = data[0]
        else:
            raise Report.error(
                "expected one JSON object of signal assignments; got a "
                f"list of {len(data)} (batch files go to --witness-tpu)",
                "T3010")
    out = {}
    for name, v in data.items():
        if "." in name:
            head, rest = name.split(".", 1)
            out.setdefault(head, {})[rest] = v
        else:
            out[name] = v

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return _convert(v, p)

    return {name: conv(v) for name, v in out.items()}


def flatten_bus_value(value, layout, p: int):
    """Nested dict/list bus value -> flat leaf list in layout order.

    Accepts: flat list (already leaf-ordered), or {field: value} dicts
    (values recursively lists / dicts / scalars).
    """
    if layout is None:
        return None
    if isinstance(value, list) and not any(
        isinstance(x, dict) for x in value
    ):
        # flat leaf list or array of per-bus values
        flat = []

        def walk(x):
            for item in x:
                if isinstance(item, list):
                    walk(item)
                else:
                    flat.append(item)

        walk(value)
        return flat
    if isinstance(value, dict):
        flat = []
        for (fname, dims, sub) in layout.fields:
            if fname not in value:
                raise Report.error(
                    f"missing bus field '{fname}'", "T3011")
            fv = value[fname]
            n = 1
            for d in dims:
                n *= d
            if sub is None:
                if isinstance(fv, list):
                    def walk2(x, acc):
                        for item in x:
                            if isinstance(item, list):
                                walk2(item, acc)
                            else:
                                acc.append(item)
                    acc = []
                    walk2(fv, acc)
                    flat.extend(acc)
                else:
                    flat.append(fv)
            else:
                if dims:
                    for elem in fv:
                        flat.extend(flatten_bus_value(elem, sub, p))
                else:
                    flat.extend(flatten_bus_value(fv, sub, p))
        return flat
    raise Report.error("cannot qualify bus input value", "T3011")


def prepare_main_inputs(cc, raw: dict) -> dict:
    """Normalize loaded inputs against the main component's wires:
    flattens bus values into leaf order; plain signals pass through."""
    from ..frontend import ast as A

    main_node = cc.dag.nodes[cc.main_node_id]
    out = dict(raw)
    for (name, dims, xtype, _tags, layout) in main_node.wire_info:
        if xtype != A.SignalType.INPUT or layout is None:
            continue
        if name in raw:
            v = raw[name]
            if dims and isinstance(v, list) and all(
                isinstance(x, dict) for x in v
            ):
                flat = []
                for elem in v:
                    flat.extend(flatten_bus_value(elem, layout, cc.p))
                out[name] = flat
            else:
                out[name] = flatten_bus_value(v, layout, cc.p)
    return out
