"""The roofline's counts, from the tape and the R1CS, held to values
reckoned by hand for two small circuits: c <== a * b; d <== c * a + 3,
and the same over inputs proven to be bits."""

import pytest

from witbench import roofline

SRC = """pragma circom 2.0.0;
template T() {
    signal input a;
    signal input b;
    signal output c;
    signal output d;
    c <== a * b;
    d <== c * a + 3;
}
component main = T();
"""


@pytest.fixture(scope="module")
def small():
    from circom_tpu_torch.compiler.pipeline import compile_source

    cc = compile_source(SRC)
    tape = cc.build_tape()[0]
    return tape, cc.r1cs_rows(), cc.p, cc.input_range_hints()


def test_counts_by_hand(small):
    tape, rows, p, hints = small
    counts = roofline.circuit_counts(tape, rows, p, hints)
    # two products of full bn128 elements (a and b carry no range): 8 x 8
    # word products each; two inputs of 254 bits; 32-byte elements;
    # witness 1, c, d, a, b; two constraints, each with A and B:
    # {a}{b}{c} and {c}{a}{d, -3 one}, seven terms of one-word
    # coefficients (-3 counted as 3): 7 x 8 + 2 x 64 word products; each
    # entry a one-byte column (5 rows) and a one-byte coefficient
    assert counts == {"run_products": 128, "input_bits": 508,
                      "elem_bytes": 32, "n_witness": 5,
                      "check_products": 7 * 8 + 2 * 64, "r1cs_bytes": 14}


BITS = """pragma circom 2.0.0;
template T() {
    signal input a;
    signal input b;
    signal output c;
    signal output d;
    a * (a - 1) === 0;
    b * (b - 1) === 0;
    c <== a * b;
    d <== (1 - 2 * a) * b;
}
component main = T();
"""


def test_products_of_proven_bits_count_one_word():
    from circom_tpu_torch.compiler.pipeline import compile_source

    cc = compile_source(BITS)
    tape = cc.build_tape()[0]
    hints = cc.input_range_hints()
    assert hints == {0: (0, 1), 1: (0, 1)}
    # a * b, 2 * a, and (1 - 2a) in [-1, 1] times b: one word product
    # each (the constraints' own a * (a - 1) no row depends on); with no
    # ranges a and b are full elements: 2 a is 8 words, the others 64
    assert roofline.tape_word_products(tape, cc.p, hints) == 3
    assert roofline.tape_word_products(tape, cc.p, {}) == 64 + 8 + 64


def test_work_and_least_time(small):
    tape, rows, p, hints = small
    counts = roofline.circuit_counts(tape, rows, p, hints)
    nbytes, ops = roofline.run_work(counts, 5 * 32, 1000)
    assert (nbytes, ops) == (1000 * (508 / 8 + 160), 128_000)
    nbytes, ops = roofline.check_work(counts, 1000)
    assert (nbytes, ops) == (1000 * 160 + 14, 184_000)
    t, bound = roofline.least_s(3.35e12, 1.0, 1e12)
    assert (t, bound) == (1.0, "bytes")
    t, bound = roofline.least_s(1.0, 2e12, 1e12)
    assert (t, bound) == (2.0, "ops")
