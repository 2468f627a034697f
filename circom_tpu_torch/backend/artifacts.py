"""Compiled-circuit artifacts: serialize/deserialize the witness program.

The TPU analog of the reference's .wasm/.dat outputs: the tape (SSA field
program), input layout, witness metadata and constraint system serialize
to a single JSON artifact that later runs without recompiling the circuit
(de-facto checkpoint, like the reference's mmap'd .dat —
code_producers/src/c_elements/common/main.cpp:22-120).
"""

import json

from ..field.primes import field_spec
from .tape import Tape


def save_program(cc, path, while_max_unroll: int = 64):
    tape, layout = cc.build_tape(while_max_unroll)
    c = cc.counts()
    data = {
        "format": "circom-tpu-program",
        "version": 2,
        "prime": cc.archive.prime,
        "tape": {
            "ops": tape.ops,
            "args": [list(a) for a in tape.args],
            "imms": tape.imms,
            "n_inputs": tape.n_inputs,
            "outputs": tape.outputs,
            # v2: while-unroll guards, tag range assertions, extern_c
            # splice recipes — a reloaded program must behave exactly
            # like a fresh compile
            "n_guards": tape.n_guards,
            "node_hints": [[i, lo, hi]
                           for i, (lo, hi) in tape.node_hints.items()],
            "extern_calls": tape.extern_calls,
        },
        # constraint-derived narrow-lane hints (bit constraints +
        # Num2Bits decompositions); not recomputable from the artifact
        "input_range_hints": [[i, lo, hi] for i, (lo, hi)
                              in cc.input_range_hints().items()],
        "input_layout": [[n, list(d), o] for (n, d, o) in layout],
        "counts": {k: v for k, v in c.items() if k != "wire2label"},
        "wire2label": c["wire2label"],
        "r1cs_rows": [
            [{str(k): str(v) for k, v in d.items()} for d in row]
            for row in cc.r1cs_rows()
        ],
    }
    with open(path, "w") as f:
        json.dump(data, f)


def load_program(path):
    """-> (tape, input_layout, meta) ready for WitnessProgram."""
    with open(path) as f:
        data = json.load(f)
    assert data["format"] == "circom-tpu-program"
    spec = field_spec(data["prime"])
    tape = Tape(spec.p)
    t = data["tape"]
    tape.ops = t["ops"]
    tape.args = [tuple(a) for a in t["args"]]
    tape.imms = t["imms"]
    tape.n_inputs = t["n_inputs"]
    tape.outputs = t["outputs"]
    tape.n_guards = t.get("n_guards", 0)
    tape.node_hints = {int(i): (lo, hi)
                       for (i, lo, hi) in t.get("node_hints", [])}
    tape.extern_calls = [
        {**call,
         "inputs": {nm: [tuple(e) for e in elems]
                    for nm, elems in call["inputs"].items()}}
        for call in t.get("extern_calls", [])
    ]
    layout = [(n, tuple(d), o) for (n, d, o) in data["input_layout"]]
    rows = [
        tuple({int(k): int(v) for k, v in d.items()} for d in row)
        for row in data["r1cs_rows"]
    ]
    meta = {"counts": data["counts"], "wire2label": data["wire2label"],
            "rows": rows, "prime": data["prime"],
            "input_range_hints": {
                int(i): (lo, hi)
                for (i, lo, hi) in data.get("input_range_hints", [])}}
    return tape, layout, meta
