"""The segments' in-place route: each K4 kernel reads its operands where
they lie (the inputs, witness rows of earlier segments, crossing rows) and
writes its results into the witness and the crossing buffer
(SegmentedProgram._place, segment_ref, the generated source).

- Named cases of the placement, each run on the CPU route and held to
  the host calculator with every witness row written: crossing rows; a
  later segment reading a witness row back; constant and input witness
  rows (the fill: an input's in the kernel that reads it, loaded once);
  one result stored to several witness rows; a single segment; no
  segment at all.
- `_run`'s CPU route against the JAX SegmentedProgram in Pallas interpret
  mode at goldilocks (batch 3, run eagerly as tests/test_fused.py runs
  it) on the cross-boundary circuit read back from the witness.
- The op circuit and LessThan(n) on the segments at each of the eight
  `--prime` fields against the host calculator, edge inputs 0, 1, p - 1
  and p // 2.
- The generated source built by g++ for the host against the plain
  version, in place, at secq256r1 (tests/test_torch_segments.py holds
  bn128 and goldilocks).

Comparisons are exact: field elements are integers.
"""

import re
import shutil

import numpy as np
import pytest
import torch

from circom_tpu_torch.backend.segments import (UNWRITTEN, SegmentedProgram,
                                               segment_k4, segment_ref)
from circom_tpu_torch.backend.torch_backend import WitnessProgram
from circom_tpu_torch.circuits.sources import (lessthan_source,
                                               num2bits_source,
                                               segment_ops_source)
from circom_tpu_torch.compiler.pipeline import compile_source
from circom_tpu_torch.field.primes import PRIMES, field_spec
from test_torch_segments import (CROSS_SRC, as_ints, host_library, limbs,
                                 programs, ptr)

# y and d are one node (the same product): its result goes to two witness
# rows; k and m are one constant, two rows of the first kernel's fill; z
# is the input a, a row of that fill too
DUP_SRC = """
pragma circom 2.0.0;
template T() {
  signal input a;
  signal input b;
  signal output y;
  signal output z;
  signal output k;
  signal output m;
  signal output d;
  y <-- a * b;
  d <-- a * b;
  z <== a;
  k <== 7;
  m <== 7;
}
component main = T();
"""

# nothing to compute: the witness is the constant 1, an input and 3
NOSEG_SRC = """
pragma circom 2.0.0;
template T() {
  signal input a;
  signal output b;
  signal output k;
  b <== a;
  k <== 3;
}
component main = T();
"""


def program(src, prime, budget=None):
    """(compiled circuit, the segmented program on the CPU, cut at
    `budget` when given)."""
    cc = compile_source(src, prime=prime)
    hints = cc.input_range_hints()
    wp = WitnessProgram(cc.build_tape()[0], field_spec(prime), device="cpu",
                        mode="segments", input_ranges=hints)
    sp = wp.fused
    if budget is not None:
        sp = SegmentedProgram(wp.dt, field_spec(prime), "cpu", budget=budget)
    return cc, sp


def run_in_place(sp, x):
    """Every kernel of sp.kernels through the CPU route of segment_k4 on
    buffers filled with UNWRITTEN; asserts every witness row written and
    the result equal to _run's; returns the witness."""
    wit, cross = sp.buffers(x.shape[-1], UNWRITTEN)
    for s in range(len(sp.kernels)):
        segment_k4(sp, s, x, wit, cross)
    assert not bool((wit.view(torch.int32) == UNWRITTEN).any())
    assert torch.equal(sp._run(x).view(torch.int32), wit.view(torch.int32))
    return wit


def held_to_host(cc, sp, cols, names):
    """The in-place run on the input columns against the host calculator
    on every lane; names: the inputs' names, in order ("a[]": an input
    array of one)."""
    x = torch.from_numpy(limbs(cols, sp.L).view(np.int32)).view(torch.uint32)
    wit = as_ints(run_in_place(sp, x))
    for lane in range(len(cols[0])):
        ins = {n.rstrip("[]"): [c[lane]] if n.endswith("[]") else c[lane]
               for n, c in zip(names, cols)}
        host = list(cc.witness_host(ins))
        assert [row[lane] for row in wit] == host, lane


def edges(p):
    """The edge values 0, 1, p - 1, p // 2."""
    return [0, 1, p - 1, p // 2]


def pair_columns(values, n_inputs, B, seed, p, bits=()):
    """Input columns whose first lanes take every pair of `values` on the
    first two inputs, the rest random below p; inputs in `bits` are
    bits."""
    rng = np.random.default_rng(seed)
    cols = []
    for i in range(n_inputs):
        col = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(B)]
        k = len(values)
        for lane in range(min(B, k * k)):
            col[lane] = values[(lane // k ** min(i, 1)) % k]
        cols.append([lane % 2 for lane in range(B)] if i in bits else col)
    return cols


@pytest.mark.parametrize("name", ["ops", "cross"])
def test_crossing_rows(name):
    """At bn128 the op circuit cuts into two segments and the
    cross-boundary circuit (cut at 400 units) into thirteen; values that a
    later segment reads and no witness row holds (Montgomery forms, at
    bn128) travel in crossing rows, each written by one kernel and read
    by later ones."""
    src, budget = {"ops": (segment_ops_source(254), None),
                   "cross": (CROSS_SRC, 400)}[name]
    cc, sp = program(src, "bn128", budget)
    assert len(sp.segments) >= 2 and sp.n_cross > 0
    writer = {d[0]: s for s, kn in enumerate(sp.kernels) for d in kn.dst
              if d[0][0] == "c"}
    assert sorted(r for _b, r in writer) == list(range(sp.n_cross))
    read = [(s, r) for s, kn in enumerate(sp.kernels) for r in kn.src
            if r[0] == "c"]
    assert read and all(writer[r] < s for s, r in read)
    p = sp.field.p
    cols = pair_columns(edges(p), sp.n_inputs, 20, 51, p,
                        cc.input_range_hints())
    held_to_host(cc, sp, cols, ["a", "b", "c"][:sp.n_inputs] if name ==
                 "ops" else ["x"])


def test_later_segment_reads_a_witness_row_back():
    """The cross-boundary circuit at goldilocks cut at 400 units: its
    products are plain, so later segments read t[i] back from the witness
    rows the earlier segments wrote, and nothing is stored twice (no
    crossing row)."""
    cc, sp = program(CROSS_SRC, "goldilocks", budget=400)
    assert len(sp.segments) > 2 and sp.n_cross == 0
    written = {r: s for s, kn in enumerate(sp.kernels) for d in kn.dst
               for r in d}
    back = [(s, r) for s, kn in enumerate(sp.kernels) for r in kn.src
            if r[0] == "w"]
    assert back and all(written[r] < s for s, r in back)
    p = sp.field.p
    cols = pair_columns(edges(p), 1, 12, 52, p)
    held_to_host(cc, sp, cols, ["x"])


def test_constant_and_input_witness_rows():
    """Witness rows that are constants (the wire 1, k and m) or an input
    are written by the first kernel (its fill); one constant fills two
    rows."""
    cc, sp = program(DUP_SRC, "bn128")
    fill = sp.kernels[0].fill
    assert all(not kn.fill for kn in sp.kernels[1:])
    kinds = {tag for (tag, _v), _rows in fill}
    assert kinds == {"const", "x"}
    assert max(len(rows) for _d, rows in fill) == 2
    p = sp.field.p
    cols = pair_columns(edges(p), 2, 16, 53, p)
    held_to_host(cc, sp, cols, ["a", "b"])


def test_input_rows_written_where_the_input_is_read():
    """4 x Num2Bits(254) cuts into four kernels, the cuts inside a
    Num2Bits, so that a kernel reads one or two inputs: each input's
    witness row is written by the first kernel that reads the input, which
    loads each row it reads or copies once; the constant wire 1 stays with
    the first kernel.  The planner's segments carry no
    placement (stats() and the JAX parity read them)."""
    cc, sp = program(num2bits_source(254, 4), "bn128")
    assert len(sp.kernels) == len(sp.segments) > 1
    for s, kn in enumerate(sp.kernels):
        for (tag, v), _rows in kn.fill:
            if tag == "x":
                assert ("x", v) in kn.src
                assert all(("x", v) not in k.src for k in sp.kernels[:s])
    assert {v for kn in sp.kernels for (t, v), _r in kn.fill
            if t == "x"} == set(range(4))
    assert any(t == "const" for (t, _v), _r in sp.kernels[0].fill)
    assert not hasattr(sp.segments[0], "src")
    text = sp.source()
    for s in range(len(sp.kernels)):
        body = text.split(f"k4_seg{s}(const")[1].split("extern")[0]
        loads = re.findall(r"ld\((\w), (\d+), B\)", body)
        assert loads and len(loads) == len(set(loads)), s
    p = sp.field.p
    cols = pair_columns(edges(p), 4, 6, 59, p)
    x = torch.from_numpy(limbs(cols, sp.L).view(np.int32)).view(torch.uint32)
    wit = as_ints(run_in_place(sp, x))
    for lane in range(6):
        host = list(cc.witness_host({"a": [c[lane] for c in cols]}))
        assert [row[lane] for row in wit] == host, lane


def test_one_result_fills_several_witness_rows():
    """y and d name one node (the same product, one node after the
    expanded tape's common subexpressions): K4 stores it to both rows."""
    cc, sp = program(DUP_SRC, "bn128")
    multi = [d for kn in sp.kernels for d in kn.dst if len(d) > 1]
    assert multi and all(r[0] == "w" for d in multi for r in d)
    p = sp.field.p
    cols = pair_columns(edges(p), 2, 16, 54, p)
    held_to_host(cc, sp, cols, ["a", "b"])


def test_single_segment():
    """Num2Bits(254) at bn128 is one segment: no crossing row, its input
    read from the inputs, its bits and the constant and input rows written
    by one kernel."""
    cc, sp = program(num2bits_source(254, 1), "bn128")
    assert len(sp.segments) == len(sp.kernels) == 1 and sp.n_cross == 0
    assert sp.kernels[0].src == (("x", 0),)
    p = sp.field.p
    cols = pair_columns(edges(p) + [1 << 253], 1, 10, 55, p)
    held_to_host(cc, sp, cols, ["a[]"])


def test_no_segment():
    """A tape with nothing to compute has no segment; one kernel writes
    its constant and input rows (stats() still count no segment)."""
    cc, sp = program(NOSEG_SRC, "bn128")
    assert sp.segments == [] and sp.stats()["segments"] == 0
    assert len(sp.kernels) == 1 and not sp.kernels[0].instrs
    assert sp.kernels[0].fill
    p = sp.field.p
    held_to_host(cc, sp, [edges(p) + [12345]], ["a"])


def test_cross_read_back_matches_jax_interpret_goldilocks():
    """_run's CPU route on the cross-boundary circuit, read back from the
    witness, against the JAX K4 in Pallas interpret mode (batch 3)."""
    jseg, seg, _ = programs("cross", "goldilocks")
    assert any(r[0] == "w" for kn in seg.kernels for r in kn.src)
    p = seg.field.p
    cols = [[p - 1, p // 2, 7]]
    x = limbs(cols, 4)
    want = np.asarray(jseg._run(x))
    got = seg._run(x).view(torch.int32).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)


def lt_bits(prime):
    """LessThan(n)'s n at a field: circomlib's largest (252), or two
    below the field's bit width."""
    return min(252, field_spec(prime).p.bit_length() - 2)


@pytest.mark.parametrize("circuit", ["ops", "lt"])
@pytest.mark.parametrize("prime", list(PRIMES))
def test_segments_at_every_prime(prime, circuit):
    """The segments forced on the op circuit (every op a segment holds)
    and on LessThan(n) at each --prime field, every lane against the host
    calculator.  The op circuit's a and b take every pair of 0, 1, p - 1
    and p // 2 (b = 0 made 1 where the circuit divides by b: the host
    calculator refuses a / 0).  LessThan(n) is defined for inputs below
    2^n (the host calculator refuses the others at Num2Bits' ===), so
    its edges are 0, 1, 2^n - 1 and 2^(n - 1), the counterparts of p - 1
    and p // 2."""
    p = field_spec(prime).p
    bits = p.bit_length()
    if circuit == "ops":
        cc, sp = program(segment_ops_source(bits), prime)
        cols = pair_columns(edges(p), sp.n_inputs, 20, 56, p,
                            cc.input_range_hints())
        if bits <= 64:
            cols[1] = [v or 1 for v in cols[1]]
        names = ["a", "b", "c"]
    else:
        n = lt_bits(prime)
        cc, sp = program(lessthan_source(n), prime)
        cols = pair_columns([0, 1, (1 << n) - 1, 1 << (n - 1)], 2, 20, 57,
                            1 << n)
        names = ["a", "b"]
    assert sp.segments
    held_to_host(cc, sp, cols, names)


@pytest.mark.parametrize("name", ["ops", "cross"])
def test_generated_source_on_the_host_matches_plain_secq256r1(name,
                                                               tmp_path):
    """The generated kernels at secq256r1 (p just under 2^256), built by
    g++, against the plain version on the same in-place buffers."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the generated source for the host")
    _, seg, cc = programs(name, "secq256r1")
    lib = host_library(seg.source(), len(seg.kernels), tmp_path)
    p = seg.field.p
    B = 24
    cols = pair_columns(edges(p), seg.n_inputs, B, 58, p,
                        cc.input_range_hints())
    x = torch.from_numpy(limbs(cols, seg.L).view(np.int32)) \
        .view(torch.uint32)
    got, want = seg.buffers(B, UNWRITTEN), seg.buffers(B, UNWRITTEN)
    for s, sg in enumerate(seg.kernels):
        segment_ref(seg.field, sg, x, *want)
        getattr(lib, f"host_seg{s}")(ptr(x), ptr(got[0]), ptr(got[1]), B)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.view(torch.int32).numpy(),
                                          w.view(torch.int32).numpy(),
                                          err_msg=f"seg {s}")
