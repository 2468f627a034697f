"""The port's native C++ calculator against the JAX package's.

circom_tpu_torch/native builds the same tapeval.cpp (a verbatim copy)
with the same g++ flags; its witnesses must equal the JAX package's
NativeCalculator and the host calculator on every case of
tests/test_native.py, the Merkle tape of tests/test_circuits.py and
SHA256 digests against hashlib.  Tolerance 0: these are field elements.
"""

import hashlib

import pytest

from circom_tpu.compiler.pipeline import compile_source as jax_compile
from circom_tpu.field.primes import field_spec as jax_field_spec
from circom_tpu.native import NativeCalculator as JaxNative
from circom_tpu_torch import native
from circom_tpu_torch.circuits import sha256_io
from circom_tpu_torch.circuits.sources import merkle_source
from circom_tpu_torch.compiler.pipeline import compile_source
from circom_tpu_torch.field.primes import field_spec
from circom_tpu_torch.native import NativeCalculator
import test_torch_shared as shared

P = field_spec("bn128").p
G = field_spec("goldilocks").p

# tests/test_native.py's seven cases: name -> (source, input rows, prime)
CASES = {
    "mul_add": ("""
pragma circom 2.0.0;
template T() {
    signal input a;
    signal input b;
    signal output o1;
    signal output o2;
    o1 <== a * b;
    o2 <== a + b * 3;
}
component main = T();
""", [[3, 4], [P - 1, P - 1], [0, 7]], "bn128"),
    "bit_ops_and_shifts": ("""
pragma circom 2.0.0;
template T(n) {
    signal input in;
    signal output out[n];
    var lc = 0;
    for (var i = 0; i < n; i++) {
        out[i] <-- (in >> i) & 1;
        out[i] * (out[i] - 1) === 0;
        lc += out[i] * 2 ** i;
    }
    lc === in;
}
component main = T(12);
""", [[0], [1], [0xABC], [4095]], "bn128"),
    "comparisons_select": ("""
pragma circom 2.0.0;
template T() {
    signal input a;
    signal input b;
    signal output out;
    out <-- a < b ? a : b;
    out === out;
}
component main = T();
""", [[3, 9], [9, 3], [P - 1, 2], [5, 5]], "bn128"),
    "division_ops": ("""
pragma circom 2.0.0;
template T() {
    signal input a;
    signal input b;
    signal output q;
    signal output r;
    signal output d;
    q <-- a \\ b;
    r <-- a % b;
    d <-- a / b;
    a === b * q + r;
    d * b === a;
}
component main = T();
""", [[47, 10], [100, 7], [5, 5]], "bn128"),
    "goldilocks": ("""
pragma circom 2.0.0;
template T() {
    signal input a;
    signal input b;
    signal output out;
    out <== a * b + 17;
}
component main = T();
""", [[3, 4], [G - 1, G - 2]], "goldilocks"),
    "dynamic_ops_lowered": ("""
pragma circom 2.0.0;
template T() {
    signal input a;
    signal input k;
    signal output o1;
    signal output o2;
    signal output o3;
    o1 <-- (a >> k) + (a << k);
    o2 <-- a ** k;
    o3 <-- (a \\ (k + 1)) + (a % (k + 1));
    o1*0 === 0; o2*0 === 0; o3*0 === 0;
}
component main = T();
""", [[123456, 7], [P - 2, 200], [5, P - 3], [9, 0], [P - 1, 254]],
        "bn128"),
    "narrow_idiv": ("""
pragma circom 2.0.0;
template T() {
    signal input a;
    signal output q;
    signal output r;
    var m = a & 65535;         // proven narrow
    q <-- m \\ 10;
    r <-- m % 10;
    q*0 === 0; r*0 === 0;
}
component main = T();
""", [[65535], [12345], [0], [99999999]], "bn128"),
}


def _input_map(layout, row):
    inputs = {}
    for (name, dims, off) in layout:
        n = 1
        for d in dims:
            n *= d
        vals = row[off:off + n]
        inputs[name] = vals if dims else vals[0]
    return inputs


@pytest.mark.parametrize("case", list(CASES))
def test_native_matches_jax_native_and_host(case):
    src, rows, prime = CASES[case]
    cc = compile_source(src, prime=prime)
    tape, layout = cc.build_tape()
    got = NativeCalculator(tape, field_spec(prime)).run(rows)
    ref_cc = jax_compile(src, prime=prime)
    ref = JaxNative(ref_cc.build_tape()[0], jax_field_spec(prime)).run(rows)
    assert got == ref
    for row, w in zip(rows, got):
        assert w == list(cc.witness_host(_input_map(layout, row)))


def test_library_is_built_in_the_build_directory():
    from circom_tpu_torch.utils.cache import build_dir

    native._build_lib()
    path = native.library_path()
    assert path.parent == build_dir() and path.exists()
    assert native.build() == 0.0     # found built: no second g++


def test_merkle_tape_vs_host():
    """MerkleInclusion(8) over Poseidon2: the tape on the native runtime
    equals the host calculator (tests/test_circuits.py:117-135)."""
    cc = compile_source(merkle_source(8))
    tape, layout = cc.build_tape()
    calc = NativeCalculator(tape, field_spec("bn128"),
                            input_ranges=cc.input_range_hints())
    ins = {"leaf": 41, "pathElements": [100 + i for i in range(8)],
           "pathIndex": [1, 0, 1, 1, 0, 0, 1, 0]}
    flat = []
    for (name, dims, off) in layout:
        v = ins[name]
        flat.extend(v if isinstance(v, list) else [v])
    got = calc.run([flat])[0]
    want = list(cc.witness_host(ins))
    assert got[:len(want)] == want


def test_sha256_tape_digests():
    """SHA256 tape digests on the native runtime against hashlib
    (tests/test_circuits.py:96-115)."""
    _cc, tape = shared.circuit(shared.sha256_source())
    calc = NativeCalculator(tape, field_spec("bn128"))
    msgs = [b"", b"abc", b"The quick brown fox jumps over the lazy d",
            b"x" * 55]
    bits = sha256_io.msgs_to_bits_batch(msgs)
    wits = calc.run([[int(v) for v in bits[:, j]] for j in range(len(msgs))])
    for j, m in enumerate(msgs):
        out = wits[j][1:257]
        digest = b"".join(
            sum(out[32 * k + i] << i for i in range(32)).to_bytes(4, "big")
            for k in range(8))
        assert digest == hashlib.sha256(m).digest(), m
