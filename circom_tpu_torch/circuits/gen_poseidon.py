"""Generate a Poseidon hash circuit in circom.

Same shape/cost as circomlib's Poseidon (t = nInputs+1, 8 full + 57
partial rounds, x^5 S-box, MDS mix): 3 constraints per S-box.  Round
constants are nothing-up-my-sleeve values derived from SHA256("circom_tpu
poseidon", i) mod p; the MDS matrix is the Cauchy matrix 1/(x_i + y_j).
These differ from circomlib's Grain-LFSR constants, so hashes differ, but
witness-generation cost and constraint structure are identical — the
benchmark measures the same workload.

Run:  python -m circom_tpu.circuits.gen_poseidon [out.circom]
"""

import hashlib
import sys

from ..field.primes import field_spec

P = field_spec("bn128").p  # default; generate(prime=) overrides
N_ROUNDS_F = 8
N_ROUNDS_P = {2: 56, 3: 57, 4: 56, 5: 60, 6: 60, 7: 63, 8: 64, 9: 63}


def nuts(tag: str, i: int, p: int = None) -> int:
    h = hashlib.sha256(f"circom_tpu poseidon {tag} {i}".encode()).digest()
    return int.from_bytes(h, "big") % (p or P)


def round_constants(t: int, n_rounds: int, p: int = None):
    return [nuts(f"C t={t}", i, p) for i in range(n_rounds * t)]


def mds(t: int, p: int = None):
    p = p or P
    xs = [nuts(f"mds-x t={t}", i, p) for i in range(t)]
    ys = [nuts(f"mds-y t={t}", i, p) for i in range(t)]
    return [
        [pow((xs[i] + ys[j]) % p, -1, p) for j in range(t)] for i in range(t)
    ]


def fmt_array(vals):
    return "[" + ", ".join(str(v) for v in vals) + "]"


def generate(n_inputs_list=(2, 4), prime: str = "bn128") -> str:
    p = field_spec(prime).p
    parts = ["pragma circom 2.0.0;\n"]
    parts.append(
        """
template Sigma() {
    signal input in;
    signal output out;
    signal x2;
    signal x4;
    x2 <== in * in;
    x4 <== x2 * x2;
    out <== x4 * in;
}
"""
    )
    for n in n_inputs_list:
        t = n + 1
        nP = N_ROUNDS_P[n]
        total = N_ROUNDS_F + nP
        C = round_constants(t, total, p)
        M = mds(t, p)
        parts.append(f"""
function POS_C{t}(i) {{
    var c[{len(C)}] = {fmt_array(C)};
    return c[i];
}}

function POS_M{t}(i, j) {{
    var m[{t * t}] = {fmt_array([x for row in M for x in row])};
    return m[i * {t} + j];
}}

template Poseidon{n}() {{
    signal input inputs[{n}];
    signal output out;
    var t = {t};
    var nRoundsF = {N_ROUNDS_F};
    var nRoundsP = {nP};
    var state[{t}];
    state[0] = 0;
    for (var i = 0; i < {n}; i++) {{
        state[i + 1] = inputs[i];
    }}
    var nSigma = nRoundsF * t + nRoundsP;
    component sigma[nSigma];
    var s = 0;
    var newState[{t}];
    for (var r = 0; r < nRoundsF + nRoundsP; r++) {{
        // ark
        for (var i = 0; i < t; i++) {{
            state[i] = state[i] + POS_C{t}(r * t + i);
        }}
        // sbox: all lanes in full rounds, lane 0 in partial rounds
        var isFull = (r < nRoundsF \\ 2) || (r >= nRoundsF \\ 2 + nRoundsP);
        var nS = isFull == 1 ? t : 1;
        for (var i = 0; i < nS; i++) {{
            sigma[s] = Sigma();
            sigma[s].in <== state[i];
            state[i] = sigma[s].out;
            s++;
        }}
        // mix
        for (var i = 0; i < t; i++) {{
            newState[i] = 0;
            for (var j = 0; j < t; j++) {{
                newState[i] = newState[i] + POS_M{t}(i, j) * state[j];
            }}
        }}
        for (var i = 0; i < t; i++) {{
            state[i] = newState[i];
        }}
    }}
    out <== state[0];
}}
""")
    return "".join(parts)


def main():
    out = sys.argv[1] if len(sys.argv) > 1 else None
    src = generate()
    if out:
        with open(out, "w") as f:
            f.write(src)
    else:
        sys.stdout.write(src)


if __name__ == "__main__":
    main()
