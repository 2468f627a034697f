"""Generate a MiMC7 hash circuit (x -> (x + k + c_i)^7, 91 rounds).

Same structure/cost as circomlib's mimc.circom (nonlinear x^7 S-box per
round); round constants are nothing-up-my-sleeve SHA256 derivations, so
values differ from circomlib's Keccak-derived constants but the workload
is identical.  Used for the EdDSA/MiMC BASELINE config (signature-style
nonlinear load).

Run: python -m circom_tpu.circuits.gen_mimc [out.circom]
"""

import hashlib
import sys

from ..field.primes import field_spec

P = field_spec("bn128").p
ROUNDS = 91


def constants():
    out = [0]
    for i in range(1, ROUNDS):
        h = hashlib.sha256(f"circom_tpu mimc7 {i}".encode()).digest()
        out.append(int.from_bytes(h, "big") % P)
    return out


def generate() -> str:
    C = constants()
    return f"""pragma circom 2.0.0;

function MIMC7_C(i) {{
    var c[{ROUNDS}] = [{", ".join(str(v) for v in C)}];
    return c[i];
}}

template MiMC7() {{
    signal input x_in;
    signal input k;
    signal output out;
    var nrounds = {ROUNDS};
    signal t2[nrounds];
    signal t4[nrounds];
    signal t6[nrounds];
    signal t7[nrounds - 1];
    var t;
    for (var i = 0; i < nrounds; i++) {{
        t = i == 0 ? x_in + k : t7[i - 1] + k + MIMC7_C(i);
        t2[i] <== t * t;
        t4[i] <== t2[i] * t2[i];
        t6[i] <== t4[i] * t2[i];
        if (i < nrounds - 1) {{
            t7[i] <== t6[i] * t;
        }} else {{
            out <== t6[i] * t + k;
        }}
    }}
}}

// Multi-message hash (Merkle-Damgard-ish chaining like circomlib MultiMiMC7)
template MultiMiMC7(n) {{
    signal input in[n];
    signal input k;
    signal output out;
    component mims[n];
    var r = k;
    signal rs[n + 1];
    rs[0] <== k;
    for (var i = 0; i < n; i++) {{
        mims[i] = MiMC7();
        mims[i].x_in <== in[i];
        mims[i].k <== rs[i];
        rs[i + 1] <== rs[i] + in[i] + mims[i].out;
    }}
    out <== rs[n];
}}
"""


def main():
    src = generate()
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            f.write(src)
    else:
        sys.stdout.write(src)


if __name__ == "__main__":
    main()
