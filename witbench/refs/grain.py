"""Poseidon's round constants and MDS matrix by the published procedure
(Grassi et al., "Poseidon", USENIX Security 2021, appendix: the Grain
LFSR of the reference script generate_parameters_grain.sage), which is
how circomlib's Poseidon constants were made.

The 80-bit state starts from the parameters (field 1 = prime, S-box 0 =
x^alpha, the field's bits, t, R_F, R_P) and thirty ones; 160 bits are
dropped; then bits come in pairs, the second kept only where the first
is 1.  A round constant is the next n bits, most significant first,
drawn again while it is not below p; the MDS matrix is the Cauchy matrix
1 / (x_i + y_j) of 2t further n-bit draws (reduced mod p, drawn again
while any two coincide or any sum is 0).  For t = 3, R_F = 8, R_P = 57 at
bn128 this gives circomlib's Poseidon(2): Poseidon([1, 2]) is
0x115cc0f5e7d690413df64c6b9662e9cf2a3617f2743245519e19607a4417189a, the
value circomlibjs's tests hold it to (witbench/tests/test_wb_reference.py).
"""

from functools import lru_cache


def _bits(n, t, r_f, r_p):
    head = (f"{1:02b}{0:04b}{n:012b}{t:012b}{r_f:010b}{r_p:010b}"
            + "1" * 30)
    seq = [int(b) for b in head]

    def step():
        b = seq[62] ^ seq[51] ^ seq[38] ^ seq[23] ^ seq[13] ^ seq[0]
        seq.pop(0)
        seq.append(b)
        return b

    for _ in range(160):
        step()
    while True:
        while step() == 0:
            step()
        yield step()


@lru_cache(maxsize=None)
def poseidon_params(p, t, r_f, r_p):
    """(round constants, (r_f + r_p) * t of them; MDS rows) for a state
    of t over the prime field of p."""
    n = p.bit_length()
    gen = _bits(n, t, r_f, r_p)

    def draw():
        v = 0
        for _ in range(n):
            v = v << 1 | next(gen)
        return v

    consts = []
    for _ in range((r_f + r_p) * t):
        v = draw()
        while v >= p:
            v = draw()
        consts.append(v)
    while True:
        r = [draw() % p for _ in range(2 * t)]
        xs, ys = r[:t], r[t:]
        if len(set(r)) == 2 * t and all((x + y) % p for x in xs for y in ys):
            break
    mds = tuple(tuple(pow(x + y, -1, p) for y in ys) for x in xs)
    return tuple(consts), mds
