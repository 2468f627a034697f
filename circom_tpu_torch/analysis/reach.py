"""Reachable-definition computation.

The reference removes templates/functions/buses unreachable from main
before running the semantic analyses (type_analysis/src/check_types.rs:
57-71 builds the `reached` set and prunes), so errors in dead
definitions are never reported.  The static analyses here (unknown/
known, type_check) restrict themselves to the same set.
"""

import dataclasses

from ..frontend import ast as A


def reachable_definitions(archive):
    """Names of templates/functions/buses reachable from main's call."""
    names = set()
    pending = []

    def scan(node):
        if isinstance(node, (list, tuple)):
            for x in node:
                scan(x)
            return
        if not dataclasses.is_dataclass(node):
            return
        if isinstance(node, (A.Call, A.BusCall, A.AnonymousComp)):
            if node.id not in names:
                names.add(node.id)
                pending.append(node.id)
        for f in dataclasses.fields(node):
            if f.name == "meta":
                continue
            scan(getattr(node, f.name))

    scan(archive.main.call)
    while pending:
        nm = pending.pop()
        d = (archive.templates.get(nm) or archive.functions.get(nm)
             or archive.buses.get(nm))
        if d is not None:
            scan(d.body)
    return names
