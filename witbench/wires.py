"""The reference's signals in wire order, through the circuit's symbol table.

The compiler's symbol table (its .sym lines: `original,witness,node,name`)
names the signal behind each witness row; a row that simplification took
out has witness -1.  That is a table of names, not of values: nothing the
program computed.  A plain reference gives each signal under its name with
the indices taken out (`main.h[].sigma[].x2`) as an array whose leading
axes are those indices and whose last axis is the lane; `expected_rows`
reads each row's value out of it, so that the witness is held row by row
in wire order.
"""

import re

import numpy as np

INDEX = re.compile(r"\[(\d+)\]")


def wire_names(sym_lines, n_wires):
    """Each witness row's signal name (row 0, the constant one, None)."""
    names = [None] * n_wires
    for line in sym_lines:
        _, wit, _, name = line.split(",", 3)
        w = int(wit)
        if w >= 0:
            if names[w] is not None:
                raise ValueError(f"row {w} named twice: {names[w]}, {name}")
            names[w] = name
    missing = [w for w in range(1, n_wires) if names[w] is None]
    if missing:
        raise ValueError(f"{len(missing)} rows unnamed, the first {missing[0]}")
    return names


def key_of(name):
    """`main.h[3].sigma[7].x2` -> (`main.h[].sigma[].x2`, (3, 7))."""
    return INDEX.sub("[]", name), tuple(int(i) for i in INDEX.findall(name))


def expected_rows(signals, names, lanes):
    """An object array (rows, lanes) of each row's value by the reference
    (row 0: 1).  KeyError where the reference lacks a signal the circuit
    keeps: the reference must cover every row."""
    out = np.empty((len(names), lanes), dtype=object)
    out[0] = 1
    groups = {}
    for w, name in enumerate(names[1:], 1):
        key, idx = key_of(name)
        groups.setdefault(key, ([], []))
        groups[key][0].append(w)
        groups[key][1].append(idx)
    for key, (rows, idx) in groups.items():
        if key not in signals:
            raise KeyError(f"the reference has no signal {key}")
        arr = np.asarray(signals[key])
        at = tuple(np.array(i) for i in zip(*idx)) if idx[0] else ()
        vals = arr[at] if at else np.broadcast_to(arr, (len(rows), lanes))
        out[rows] = vals.astype(object)
    return out


def rows_of(keys, names):
    """The rows whose signal's key is one of `keys` (the outputs)."""
    return [w for w, n in enumerate(names) if n and key_of(n)[0] in keys]
