"""JSON artifact writers: constraints.json and substitutions.json.

Formats follow constraint_writers/src/json_writer.rs: constraints as
triples of {signal: "coef"} maps keyed by wire id, substitutions as
{signal: {signal: "coef"}}.
"""

import json


def constraints_json(rows):
    """rows: iterable of (a, b, c) dicts -> json string."""
    out = []
    for (a, b, c) in rows:
        out.append([
            {str(k): str(v) for k, v in sorted(d.items())}
            for d in (a, b, c)
        ])
    return json.dumps({"constraints": out}, indent=1)


def substitutions_json(substitutions):
    """substitutions: {old_signal: {signal: coef}} -> json string.

    A BARE dictionary, exactly as the reference writes it
    (json_writer.rs:69-98 SubstitutionJSON emits `{ "sig" : {...}, ... }`
    with no wrapper key; worked example simplification-json.md:43-95)."""
    out = {}
    for s, coeffs in sorted(substitutions.items()):
        out[str(s)] = {str(k): str(v) for k, v in sorted(coeffs.items())}
    return json.dumps(out, indent=1)
