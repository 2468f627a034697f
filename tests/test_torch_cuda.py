"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked `cuda` and skips without a card.  The file
imports neither JAX nor circom_tpu, so it runs on the card's machine, where
JAX is not installed, with the JAX-forcing conftest left out:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Comparisons are exact (tolerance 0): field elements are integers.
"""

import ast
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from circom_tpu_torch.backend import checker as checker_mod
from circom_tpu_torch.backend.checker import R1CSChecker
from circom_tpu_torch.backend import interp
from circom_tpu_torch.backend.interp import (gather_n, gather_w, interp_k1,
                                             k1_plain, launch_gather_w,
                                             narrow_inputs, split_inputs)
from circom_tpu_torch.backend.ks import KsProgram
from circom_tpu_torch.backend.interp_ref import gather_n_rows, gather_rows
from circom_tpu_torch.backend.segments import (UNWRITTEN, SegmentedProgram,
                                               segment_k4, segment_ref)
from circom_tpu_torch.backend.torch_backend import WitnessProgram
from circom_tpu_torch.circuits import sha256_io
from circom_tpu_torch.circuits.gen_poseidon import generate
from circom_tpu_torch.circuits.sources import (BIGINT_DIV_SRC,
                                               bigdiv_num2bits_source,
                                               comparator_inputs,
                                               comparators_source,
                                               merkle_source,
                                               num2bits_source,
                                               poseidon2_source,
                                               random_r1cs,
                                               segment_ops_source)
from circom_tpu_torch.compiler.pipeline import compile_source
from circom_tpu_torch.convert import (K1C_OPCODES, K1D_OPCODES,
                                      input_rows, narrow_unit_arrays,
                                      plan_from_arrays, to_device,
                                      unit_arrays, unit_inputs)
from circom_tpu_torch.field.primes import (LIMB_BITS, PRIMES, FieldSpec,
                                         field_spec)
from circom_tpu_torch.ops import build
from circom_tpu_torch.ops import field_kernels as fk
from circom_tpu_torch.ops.field import TorchField, as_i64, mont_edge_values
from circom_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_int
import test_torch_shared as shared

pytestmark = pytest.mark.cuda
ROOT = Path(__file__).resolve().parents[1]
EDGE_COUNTS = (0, 1, 31, 32, 33, -1)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def canonical(rng, prime, shape):
    spec = field_spec(prime)
    L = spec.n_limbs
    top = spec.p >> (LIMB_BITS * (L - 1))
    x = rng.integers(0, 1 << 16, size=shape, dtype=np.uint32)
    x[..., L - 1, :] = rng.integers(0, top, size=x[..., L - 1, :].shape,
                                    dtype=np.uint32)
    return x


@pytest.fixture(scope="module")
def poseidon2():
    return compile_source(generate((2,)) + "\ncomponent main = Poseidon2();\n")


@pytest.mark.parametrize("prime", ["bn128", "goldilocks", "bls12381"])
@pytest.mark.parametrize("op", ["mont_mul", "add", "sub"])
def test_field_kernels_match_plain(card, prime, op):
    rng = np.random.default_rng(5)
    L = field_spec(prime).n_limbs
    tf = TorchField(field_spec(prime), card)
    a = to_device(canonical(rng, prime, (7, L, 1000)), card)
    b = to_device(canonical(rng, prime, (7, L, 1000)), card)
    c = to_device(canonical(rng, prime, (7, L, 1)), card)
    for y in (b, c):          # full and broadcast second operand
        got = getattr(fk, op)(tf, a, y)
        want = getattr(tf, op)(a, y)
        torch.cuda.synchronize()
        assert torch.equal(as_i64(got), as_i64(want))


@pytest.mark.parametrize("prime", ["secq256r1", "bn128", "goldilocks"])
def test_k5_edge_operands_match_plain(card, prime):
    """K5 on every pair of mont_edge_values (secq256r1's p lies just under
    R = 2^256: the edge of the conditional subtract), full and with each
    edge as a broadcast column, and at a lane count that is not a
    multiple of the block."""
    spec = field_spec(prime)
    L = spec.n_limbs
    tf = TorchField(spec, card)
    edges = mont_edge_values(spec)
    pairs = [(x, y) for x in edges for y in edges]
    a = to_device(ints_to_limbs([x for x, _ in pairs], L).T[None], card)
    b = to_device(ints_to_limbs([y for _, y in pairs], L).T[None], card)
    assert torch.equal(as_i64(fk.mont_mul(tf, a, b)),
                       as_i64(tf.mont_mul(a, b)))
    for y in edges:
        c = to_device(ints_to_limbs([y], L).T.copy(), card)      # (L, 1)
        assert torch.equal(as_i64(fk.mont_mul(tf, a, c)),
                           as_i64(tf.mont_mul(a, c)))
        assert torch.equal(as_i64(fk.mont_mul(tf, c, a)),
                           as_i64(tf.mont_mul(c, a)))


@pytest.mark.parametrize("n_rows, L, B, offset", [
    (40, 16, 1024, 0),      # 16 bytes a thread
    (40, 16, 4099, 0),      # rows of whole 16-byte units, B odd
    (9, 16, 4099, 1),       # a bank 4 bytes off 16-byte alignment
    (9, 3, 5, 0),           # rows of 15 words: 4 bytes a thread
    (6, 2, 2, 0),           # rows of one 16-byte unit
    (7, 4, 8192, 0)])
def test_k2_tail_shapes_match_plain(card, n_rows, L, B, offset):
    """K2 against the plain gather with 16 or 4 bytes a thread, for W = 0,
    1 and many rows, and into an output 4 bytes off 16-byte alignment."""
    rng = np.random.default_rng(25)
    words = rng.integers(0, 1 << 32, size=n_rows * L * B + offset,
                         dtype=np.uint32)
    bank = to_device(words, card)[offset:].view(n_rows, L, B)
    for W in (0, 1, 2 * n_rows):
        idx = to_device(rng.integers(0, n_rows, size=W).astype(np.int32),
                        card)
        got = gather_w(bank, idx)
        assert got.shape == (W, L, B)
        assert torch.equal(as_i64(got), as_i64(gather_rows(bank, idx)))
    out = torch.zeros(W * L * B + 1, dtype=torch.uint32, device=card)
    launch_gather_w(bank.contiguous(), idx, out[1:].view(W, L, B))
    assert torch.equal(as_i64(out[1:].view(W, L, B)),
                       as_i64(gather_rows(bank, idx)))
    with pytest.raises(IndexError):
        gather_w(bank, to_device(np.asarray([0, n_rows], np.int32), card))


def test_launch_on_a_second_card(card):
    """K2 on a tensor of cuda:1, launched while cuda:0 is the current
    device, gathers the right rows: every launch makes its tensors' card
    current (ops/build.launch).  Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    rng = np.random.default_rng(26)
    other = torch.device("cuda", 1)
    bank = to_device(rng.integers(0, 1 << 16, size=(8, 16, 4096),
                                  dtype=np.uint32), other)
    idx = to_device(np.arange(7, -1, -1, dtype=np.int32), other)
    with torch.cuda.device(0):
        got = gather_w(bank, idx)
    torch.cuda.synchronize(other)
    assert torch.equal(as_i64(got), as_i64(gather_rows(bank, idx)))


def test_main_path_gathers_make_no_index_sync(card, monkeypatch):
    """WitnessProgram's run (K1 and KW) and run_mixed (K1, K2 and K3)
    launch without the public wrappers' index check (a device-to-host
    sync), and still give the host calculator's witness."""
    cc = compile_source(comparators_source())
    spec = field_spec("bn128")
    prog = WitnessProgram(cc.build_tape()[0], spec, device=card,
                          input_ranges=cc.input_range_hints())

    def refuse(*args):
        raise AssertionError("an index check on the main path")

    monkeypatch.setattr(interp, "_check_index", refuse)
    x = comparator_inputs(300, 55, spec.n_limbs)
    build.reset_launches()
    wit = prog.run(x)
    prog.run_mixed(x)
    assert build.LAUNCHES["gather_w"] == 1 and build.LAUNCHES["gather_n"] == 1
    assert build.LAUNCHES["assemble"] == 1
    w = wit.view(torch.int32).cpu().numpy().view(np.uint32)
    for lane in (0, 299):
        ins = [limbs_to_int(x[i, :, lane]) for i in range(prog.n_inputs)]
        host = list(cc.witness_host({"a": ins[0], "b": ins[1]}))
        assert [limbs_to_int(w[i, :, lane]) for i in range(len(host))] == host


def kw_program(name, device, B):
    """(program, inputs) of a path whose full-limb witness KW assembles:
    SHA256 (narrow emissions), MerkleInclusion(32) (wide rows and the
    pathIndex bits), the comparators (both), over bn128 at B lanes."""
    spec = field_spec("bn128")
    rng = random.Random(B)
    src = {"sha256": shared.sha256_source(), "merkle32": merkle_source(32),
           "comparators": comparators_source()}[name]
    cc, _tape, prog = shared.program(src)
    prog = prog.for_device(device)
    hints = cc.input_range_hints()
    if name == "sha256":
        msgs = [bytes(rng.randrange(256) for _ in range(32))
                for _ in range(B)]
        x = sha256_io.input_rows(msgs, spec.n_limbs)
    elif name == "merkle32":
        cols = [[rng.randrange(2) if i in hints else rng.randrange(spec.p)
                 for _ in range(B)] for i in range(prog.n_inputs)]
        x = prog.encode_inputs(cols)
    else:
        x = comparator_inputs(B, 66, spec.n_limbs)
    return prog, x


@pytest.mark.parametrize("B", [301, 512])
@pytest.mark.parametrize("name", ["sha256", "merkle32", "comparators"])
def test_kw_matches_parts_route(card, name, B):
    """KW against its plain version, the parts route (K2, K3, the plain
    widening, index_put), on the same K1 banks, bit for bit, at a lane
    count that is not a multiple of 4 (4 bytes a thread) and one that is;
    a run launches K1 and KW and neither K2 nor K3, and gives KW's
    witness."""
    prog, x = kw_program(name, card, B)
    interp = prog.interp
    assert not interp._k2_whole
    inputs, x_w, _ = interp._inputs(x)
    bank, bank_n = interp_k1(interp.plan, prog.field, inputs)
    got = interp.assemble_kw(inputs, bank, bank_n)
    want = interp.assemble_parts(inputs, x_w, bank, bank_n)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    del want
    build.reset_launches()
    wit = prog.run(x)
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {**{k: 1 for k in interp.plan.parts},
                                    "assemble": 1}
    assert torch.equal(wit.view(torch.int32), got.view(torch.int32))


def test_kw_on_a_second_card(card):
    """KW on tensors of cuda:1, launched while cuda:0 is current, gives
    the CPU's witness (the parts route of the plain executor).  Needs two
    cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    prog, x = kw_program("comparators", "cpu", 300)
    other = prog.for_device(torch.device("cuda", 1))
    with torch.cuda.device(0):
        build.reset_launches()
        got = other.run(x)
    torch.cuda.synchronize(torch.device("cuda", 1))
    assert got.device == torch.device("cuda", 1)
    assert build.LAUNCHES["assemble"] == 1
    assert torch.equal(got.view(torch.int32).cpu(),
                       prog.run(x).view(torch.int32))


def test_k1a_and_k2_match_plain(card, poseidon2):
    prog = WitnessProgram(poseidon2.build_tape()[0], field_spec("bn128"),
                          device=card)
    plan = prog.interp.plan
    rng = np.random.default_rng(12)
    x = to_device(canonical(rng, "bn128",
                            (plan.n_input_rows, plan.L, 4096)), card)
    got, _ = interp_k1(plan, prog.field, x)
    want, _ = k1_plain(plan, prog.field, *split_inputs(plan, x))
    rows = torch.as_tensor(plan.emitted_rows(), device=card)
    assert torch.equal(as_i64(got)[rows], as_i64(want)[rows])
    idx = plan.dev["wd_src"]
    assert torch.equal(as_i64(gather_w(got, idx)),
                       as_i64(gather_rows(got, idx)))


@pytest.mark.parametrize("prime", sorted(
    ["bn128", "bls12381", "goldilocks", "grumpkin", "pallas", "vesta",
     "secq256r1", "bls12377"]))
def test_k1_dots_at_every_prime_match_plain_and_host(card, prime):
    """Poseidon2 at each --prime field (its lazy dots subtract p up to
    three times at secq256r1): K1 equals the plain executor on every
    emitted row of 1,024 lanes, the run passes the R1CS check, and the
    edge lanes and two random ones equal the host calculator."""
    spec = field_spec(prime)
    p, L = spec.p, spec.n_limbs
    cc = compile_source(poseidon2_source(prime), prime=prime)
    prog = WitnessProgram(cc.build_tape()[0], spec, device=card)
    plan = prog.interp.plan
    x = canonical(np.random.default_rng(19), prime, (2, L, 1024))
    edges = [(0, 0), (1, p - 1), (p - 1, p - 1), (p // 2, p // 2 + 1)]
    for j, pair in enumerate(edges):
        for i, v in enumerate(pair):
            x[i, :, j] = ints_to_limbs([v], L)[0]
    x = to_device(x, card)
    got, _ = interp_k1(plan, prog.field, x)
    want, _ = k1_plain(plan, prog.field, *split_inputs(plan, x))
    rows = torch.as_tensor(plan.emitted_rows(), device=card)
    assert torch.equal(as_i64(got)[rows], as_i64(want)[rows])
    wit = prog.run(x)
    checker = R1CSChecker(cc.r1cs_rows(), cc.counts()["n_wires"], spec,
                          device=card)
    assert bool(checker.check(wit).all())
    w = wit.view(torch.int32).cpu().numpy().view(np.uint32)
    xs = x.view(torch.int32).cpu().numpy().view(np.uint32)
    for lane in (0, 1, 2, 3, 500, 1023):
        ins = [limbs_to_int(xs[i, :, lane]) for i in range(2)]
        host = list(cc.witness_host({"inputs": ins}))
        assert [limbs_to_int(w[i, :, lane]) for i in range(len(host))] \
            == host, lane


def test_witness_program_and_checker(card, poseidon2):
    spec = field_spec("bn128")
    prog = WitnessProgram(poseidon2.build_tape()[0], spec, device=card)
    rng = np.random.default_rng(13)
    x = canonical(rng, "bn128", (prog.n_inputs, spec.n_limbs, 300))
    wit = prog.run(x)
    checker = R1CSChecker(poseidon2.r1cs_rows(),
                          poseidon2.counts()["n_wires"], spec, device=card,
                          lanes=128)
    ok, first_bad = checker.check_detailed(wit)
    assert bool(ok.all())
    bad = wit.clone()
    bad.view(torch.int32)[40, 0, 7] ^= 1
    ok_bad, _ = checker.check_detailed(bad)
    assert ok_bad.cpu().tolist() == [b != 7 for b in range(300)]
    w = wit.view(torch.int32).cpu().numpy().view(np.uint32)
    for lane in (0, 150, 299):
        ins = [limbs_to_int(x[i, :, lane]) for i in range(prog.n_inputs)]
        host = list(poseidon2.witness_host({"inputs": ins}))
        assert [limbs_to_int(w[i, :, lane]) for i in range(len(host))] == host


# the base field of BLS12-381, 381 bits: KC's 24-limb instantiation
BLS12381_Q = int(
    "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f6241eab"
    "fffeb153ffffb9feffffffffaaab", 16)


def kc_against_plain(checker, z):
    """KC's first violated row of each lane of z (uint32 (n_wires, L, b)
    on the card) equals the plain route's; returns it."""
    got = checker.first_violated(z)
    want = checker.first_violated_plain(z)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("prime", ["bn128", "goldilocks", "bls12381",
                                   "bls12381_base", "secq256r1"])
@pytest.mark.parametrize("b", [260, 1000])
def test_kc_matches_plain(card, monkeypatch, prime, b):
    """KC against the plain route on a random system with rows of up to 6
    terms a matrix, lanes corrupted at different wires, at 260 lanes (a
    SHA256 slice) and 1,000 (no multiple of 32), with one row a block and
    with several."""
    spec = FieldSpec(prime, BLS12381_Q) if prime == "bls12381_base" \
        else field_spec(prime)
    rows, z = random_r1cs(spec, 8, 40, 6, b, seed=b)
    for k, lane in enumerate(range(3, b, 37)):
        z[9 + k % 40, k % spec.n_limbs, lane] ^= 1 << (k % 16)
    checker = R1CSChecker(rows, z.shape[0], spec, device=card)
    zs = to_device(z, card)
    first = kc_against_plain(checker, zs)
    assert 0 < int((first < len(rows)).sum()) <= len(range(3, b, 37))
    assert len(set(first[first < len(rows)].tolist())) > 3
    ok, first_bad = checker.check_detailed(zs)
    assert torch.equal(ok, first == len(rows))
    assert torch.equal(first_bad, torch.where(ok, 0, first).long())
    monkeypatch.setattr(checker_mod, "KC_BLOCKS", 7)
    kc_against_plain(checker, zs)


def test_kc_on_poseidon2_slice(card, poseidon2):
    """KC on Poseidon2/bn128 witnesses at 8,192 lanes, the check's slice,
    with lanes corrupted at different wires; check_detailed launches KC
    once a slice, and neither K5 nor K6."""
    spec = field_spec("bn128")
    prog = WitnessProgram(poseidon2.build_tape()[0], spec, device=card)
    rng = np.random.default_rng(14)
    wit = prog.run(canonical(rng, "bn128", (prog.n_inputs, 16, 8192)))
    for wire, lane in ((3, 2), (40, 3), (150, 4), (322, 5), (100, 8191)):
        wit.view(torch.int32)[wire, 0, lane] ^= 1
    checker = R1CSChecker(poseidon2.r1cs_rows(),
                          poseidon2.counts()["n_wires"], spec, device=card,
                          lanes=4096)
    first = kc_against_plain(checker, wit)
    assert sorted(torch.nonzero(first < 320).flatten().tolist()) == \
        [2, 3, 4, 5, 8191]
    build.reset_launches()
    ok, _ = checker.check_detailed(wit)
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {"r1cs_check": 2}
    assert int((~ok).sum()) == 5


def random_int32(rng, shape):
    v = rng.integers(-2 ** 31, 2 ** 31, size=shape)
    v.reshape(-1)[:4] = (-2 ** 31, -1, 0, 2 ** 31 - 1)
    return v.astype(np.int32)


def k1_against_plain(plan, field, x, card):
    """K1 on the input rows x and the plain executor on their split: every
    emitted narrow bank row bit for bit."""
    x = to_device(x, card)
    _, got = interp_k1(plan, field, x)
    _, want = k1_plain(plan, field, *split_inputs(plan, x))
    rows = torch.as_tensor(plan.emitted_rows(narrow=True), device=card)
    assert len(rows)
    assert torch.equal(got[rows], want[rows])


def narrow_rows(plan, x_n):
    """Input rows (numpy) whose narrow inputs under the plan are x_n."""
    return input_rows(plan, np.zeros((0, plan.L, x_n.shape[1]), np.uint32),
                      x_n)


def test_k1b_unit_plan_matches_plain(card):
    """Every K1b opcode at the edge shift counts, one step each."""
    arrays, _cases = narrow_unit_arrays(16, EDGE_COUNTS)
    plan = plan_from_arrays(arrays, card)
    x = narrow_rows(plan, random_int32(np.random.default_rng(21), (2, 4096)))
    k1_against_plain(plan, TorchField(field_spec("bn128"), card), x, card)


@pytest.mark.parametrize("name", ["overwrite", "groups"])
def test_k1b_overwritten_constants_and_groups_match_plain(card, name):
    """Constant operands read before and after a step overwrites their
    register, across two chunks; a run read in groups of steps, cut where a
    step reads an earlier one's result; steps emitted to the dump row."""
    import test_torch_k1_host as unit

    arrays = {"overwrite": unit.overwrite_arrays(16),
              "groups": unit.groups_arrays(16)[0]}[name]
    plan = plan_from_arrays(arrays, card)
    x = narrow_rows(plan, random_int32(np.random.default_rng(22),
                                       (len(plan.nin_order), 4096)))
    k1_against_plain(plan, TorchField(field_spec("bn128"), card), x, card)


def word_src():
    """test_bitpack.WORD_SRC, read without importing that module (it
    imports the JAX package, which the card's machine lacks)."""
    tree = ast.parse((ROOT / "tests/test_bitpack.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "WORD_SRC":
            return ast.literal_eval(node.value)


@pytest.mark.parametrize("prime", ["goldilocks", "bn128"])
def test_k1b_word_circuit_matches_plain(card, prime):
    cc = compile_source(word_src(), prime=prime)
    spec = field_spec(prime)
    prog = WitnessProgram(cc.build_tape()[0], spec, device=card,
                          input_ranges=cc.input_range_hints())
    rng = np.random.default_rng(22)
    x = np.zeros((prog.n_inputs, 2, 2048), np.uint32)
    x[:, 0] = rng.integers(0, 2, size=(prog.n_inputs, 2048))
    k1_against_plain(prog.interp.plan, prog.field, x, card)


@pytest.mark.parametrize("limbs", [16, 4])
def test_k3_matches_plain(card, limbs):
    """Sources in the narrow bank and in the narrow inputs, raw rows and
    unpacked bits at the edge shift counts; input rows of 16 limbs and of
    4 (goldilocks' full-limb rows)."""
    rng = np.random.default_rng(23)
    B = 4099                       # not a multiple of 4: the scalar path
    for b in (B, 4096):
        bank_n = to_device(random_int32(rng, (40, b)), card)
        # nine narrow inputs in limbs 0 and 1 of rows of 12 input rows
        inputs = to_device(rng.integers(0, 1 << 16, size=(12, limbs, b),
                                        dtype=np.uint32), card)
        order = to_device(rng.permutation(12)[:9].astype(np.int32), card)
        src = to_device(rng.integers(0, 49, size=700).astype(np.int32),
                        card)
        shift = to_device(np.resize(np.asarray(EDGE_COUNTS, np.int32), 700),
                          card)
        got = gather_n(bank_n, inputs, order, src, shift)
        x_n = narrow_inputs(inputs, order)
        assert torch.equal(got, gather_n_rows(bank_n, x_n, src, shift))


def unit_rows(rng, n_rows, L, B):
    """Random 16-bit limbs (n_rows, L, B) whose limbs 0 and 1 give narrow
    values at the edges in the first lanes: bit 31 set (-2^31, -1), 0 and
    2^31 - 1; every limb above 1 nonzero."""
    x = rng.integers(1, 1 << 16, size=(n_rows, L, B), dtype=np.uint32)
    for j, v in enumerate((0x80000000, 0xFFFFFFFF, 0, 0x7FFFFFFF)):
        x[:, 0, j] = v & 0xFFFF
        if L > 1:
            x[:, 1, j] = v >> 16
    return x


@pytest.mark.parametrize("lin", ["L", 2, 1])
@pytest.mark.parametrize("prime", ["bn128", "goldilocks"])
def test_k1_k3_read_input_rows_match_split(card, prime, lin):
    """K1 and K3 read their inputs in the caller's rows (n_inputs, Lin, B)
    at Lin = L (the K1c/K1d unit plan: wide and narrow inputs), 2 and 1
    (the K1b unit plan, its narrow inputs at rows 3 and 1 of five), held
    against the plain split (split_inputs, narrow_inputs) and the plain
    executor and gather, bit for bit; limbs above 1 nonzero, narrow values
    with bit 31 set, and a lane count that is not a multiple of 4.  At
    L = 16 (bn128) and L = 4 (goldilocks: K1's <4, true, true>, where Lin
    = 2 and 1 are half and a quarter of a row)."""
    rng = np.random.default_rng(27)
    spec = field_spec(prime)
    L = spec.n_limbs
    field = TorchField(spec, card)
    if lin == "L":
        ops = K1D_OPCODES + (K1C_OPCODES if prime == "goldilocks"
                             else ("add",))
        arrays, _ = unit_arrays(spec.p, L, ops)
        x = input_rows(plan_from_arrays(arrays, "cpu"),
                       *unit_inputs(spec.p, L, 4099, 28))
        x[3:] = unit_rows(rng, 3, L, 4099)
    else:
        arrays, _ = narrow_unit_arrays(L, EDGE_COUNTS)
        arrays = dict(arrays, nin_of={3: 0, 1: 1})
        x = unit_rows(rng, 5, lin, 4099)
    plan = plan_from_arrays(arrays, card)
    k1_against_plain_both(plan, field, x, card)
    xs = to_device(x, card)
    _, bank_n = interp_k1(plan, field, xs)
    n_src = plan.n_bank_n_rows + len(plan.nin_order)
    src = to_device(rng.integers(0, n_src, size=300).astype(np.int32), card)
    shift = to_device(np.resize(np.asarray(EDGE_COUNTS, np.int32), 300),
                      card)
    order = plan.dev["nin_order"]
    got = gather_n(bank_n, xs, order, src, shift)
    want = gather_n_rows(bank_n, narrow_inputs(xs, order), src, shift)
    assert torch.equal(got, want)


def test_interpreter_runs_launch_only_their_kernels(card):
    """A run on the card is its kernels alone: SHA256's full-limb run (F)
    launches K1 and KW once each, its run_mixed (M) K1 and K3 (its wide
    gather has no rows, so no K2), and MerkleInclusion(4)'s run_mixed
    (wide and narrow inputs, the pathIndex bits) K1, K3 and K2; no other
    launch, and the outputs equal the CPU's."""
    prog, x = kw_program("sha256", card, 64)
    parts = {k: 1 for k in prog.interp.plan.parts}
    build.reset_launches()
    wit = prog.run(x)
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {**parts, "assemble": 1}
    plain = prog.for_device("cpu")
    assert torch.equal(wit.view(torch.int32).cpu(),
                       plain.run(x).view(torch.int32))
    assert not len(prog.interp.plan.wd_src)
    x2 = x[:, :2].copy()
    build.reset_launches()
    narrow, wide = prog.run_mixed(x2)
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {**parts, "gather_n": 1}
    want_n, _ = plain.run_mixed(x2)
    assert torch.equal(narrow.cpu(), want_n) and wide.shape[0] == 0
    cc = compile_source(merkle_source(4))
    hints = cc.input_range_hints()
    spec = field_spec("bn128")
    mk = WitnessProgram(cc.build_tape()[0], spec, device=card,
                        input_ranges=hints)
    p = mk.interp.plan
    assert p.win_order and p.nin_order and mk.interp._bank_only
    rng = random.Random(29)
    cols = [[rng.randrange(2) if i in hints else rng.randrange(spec.p)
             for _ in range(300)] for i in range(mk.n_inputs)]
    xm = mk.encode_inputs(cols)
    build.reset_launches()
    narrow, wide = mk.run_mixed(xm)
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {**{k: 1 for k in p.parts},
                                    "gather_n": 1, "gather_w": 1}
    want_n, want_w = mk.for_device("cpu").run_mixed(xm)
    assert torch.equal(narrow.cpu(), want_n)
    assert torch.equal(wide.view(torch.int32).cpu(),
                       want_w.view(torch.int32))


def same_outputs(got, want):
    """Whether two runs' (or run_mixed's) outputs are equal, bit for
    bit."""
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in pairs)


@pytest.mark.parametrize("view", ["limbs", "lanes"])
def test_strided_inputs_match_contiguous(card, view):
    """K1, K3 and KW read input row r at r * Lin * B: a strided view of
    the caller's rows on the card, x[:, :2] of SHA256's full-limb rows
    (limbs 2 and up random) or x[..., :b] of a batch twice as wide, gives
    the outputs of the same rows copied contiguous (which the tests above
    hold against the CPU): SHA256's run_mixed, and with "lanes" its run
    and MerkleInclusion(32)'s run and run_mixed (wide and narrow
    inputs)."""
    b = 96
    prog, x = kw_program("sha256", card, 2 * b)
    x[:, 2:] = np.random.default_rng(31).integers(
        0, 1 << 16, size=x[:, 2:].shape, dtype=np.uint32)
    cases = [(prog, x)]
    if view == "lanes":
        cases.append(kw_program("merkle32", card, 2 * b))
    for p, rows in cases:
        xc = to_device(rows, card)
        v = xc[:, :2] if view == "limbs" else xc[..., :b]
        assert not v.is_contiguous()
        want = v.contiguous()
        assert same_outputs(p.run_mixed(v), p.run_mixed(want))
        if view == "lanes":
            assert same_outputs(p.run(v), p.run(want))


def test_sha256_run_mixed_digests(card):
    prog = shared.program(shared.sha256_source())[2].for_device(card)
    rng = random.Random(24)
    msgs = [bytes(rng.randrange(256) for _ in range(32))
            for _ in range(1024)]
    narrow, _wide = prog.run_mixed(sha256_io.input_rows(msgs))
    digest = sha256_io.digest_bits_from_witness(narrow, prog.mixed_layout())
    assert np.array_equal(digest.cpu().numpy(),
                          sha256_io.digest_bits_batch(msgs))


@pytest.mark.parametrize("limbs", [2, 1])
def test_sha256_goldilocks_run_mixed(card, limbs):
    """SHA256 at goldilocks (L = 4) through run_mixed at 301 lanes (not a
    multiple of 4) from narrow rows of 2 and 1 limbs: one K1 and one K3
    launch and nothing else, every digest equal to hashlib's, K1 equal to
    its plain executor on every emitted row and K3 to gather_n_rows."""
    prog = shared.program(shared.sha256_source(), "goldilocks")[2] \
        .for_device(card)
    plan, field = prog.interp.plan, prog.field
    rng = random.Random(34)
    msgs = [bytes(rng.randrange(256) for _ in range(32))
            for _ in range(301)]
    x = sha256_io.input_rows(msgs, limbs)
    build.reset_launches()
    narrow, wide = prog.run_mixed(x)
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {**{k: 1 for k in plan.parts},
                                    "gather_n": 1}
    assert wide.shape == (0, 4, 301)
    digest = sha256_io.digest_bits_from_witness(narrow, prog.mixed_layout())
    assert np.array_equal(digest.cpu().numpy(),
                          sha256_io.digest_bits_batch(msgs))
    k1_against_plain(plan, field, x, card)
    xs = to_device(x, card)
    _, bank_n = interp_k1(plan, field, xs)
    order, src, shift = (plan.dev[k] for k in ("nin_order", "nw_src",
                                                "nw_shift"))
    assert torch.equal(gather_n(bank_n, xs, order, src, shift),
                       gather_n_rows(bank_n, narrow_inputs(xs, order), src,
                                     shift))


@pytest.mark.parametrize("prime", ["bn128", "goldilocks"])
def test_k1c_k1d_unit_plan_matches_plain(card, prime):
    """Every K1c/K1d opcode (goldilocks' products at goldilocks only), one
    step per case, on the edge operands: every emitted row of both banks
    bit for bit."""
    spec = field_spec(prime)
    L = spec.n_limbs
    ops = K1D_OPCODES + (K1C_OPCODES if prime == "goldilocks" else ("add",))
    arrays, _cases = unit_arrays(spec.p, L, ops)
    plan = plan_from_arrays(arrays, card)
    x = input_rows(plan, *unit_inputs(spec.p, L, 4096, 31))
    k1_against_plain_both(plan, TorchField(spec, card), x, card)


def k1_against_plain_both(plan, field, x, card):
    """K1 on the input rows x and the plain executor on their split: every
    emitted row of both banks bit for bit."""
    x = to_device(x, card)
    got_w, got_n = interp_k1(plan, field, x)
    want_w, want_n = k1_plain(plan, field, *split_inputs(plan, x))
    torch.cuda.synchronize()
    rows = torch.as_tensor(plan.emitted_rows(), device=card)
    rows_n = torch.as_tensor(plan.emitted_rows(narrow=True), device=card)
    assert len(rows) + len(rows_n)
    assert torch.equal(as_i64(got_w)[rows], as_i64(want_w)[rows])
    assert torch.equal(got_n[rows_n], want_n[rows_n])


def path_program(name, card):
    """(compiled circuit, WitnessProgram, inputs (n, L, B) numpy) of one of
    the paths K1c/K1d run, at a small batch."""
    prime = "goldilocks" if name == "poseidon2-goldilocks" else "bn128"
    spec = field_spec(prime)
    src = {"poseidon2-goldilocks": poseidon2_source("goldilocks"),
           "bigdiv-bn128": BIGINT_DIV_SRC,
           "cmp-bn128": comparators_source()}[name]
    cc = compile_source(src, prime=prime)
    prog = WitnessProgram(cc.build_tape()[0], spec, device=card,
                          input_ranges=cc.input_range_hints())
    rng = np.random.default_rng(32)
    B = 640
    if name == "cmp-bn128":
        x = comparator_inputs(B, 33, spec.n_limbs)
    else:
        x = canonical(rng, prime, (prog.n_inputs, spec.n_limbs, B))
        if name == "bigdiv-bn128":
            x[1, 0, :] |= 1        # a nonzero divisor
    return cc, prog, x


@pytest.mark.parametrize("name", ["poseidon2-goldilocks", "bigdiv-bn128",
                                  "cmp-bn128"])
def test_k1cd_path_matches_plain_host_and_r1cs(card, name):
    cc, prog, x = path_program(name, card)
    plan = prog.interp.plan
    k1_against_plain_both(plan, prog.field, x, card)
    wit = prog.run(x)
    checker = R1CSChecker(cc.r1cs_rows(), cc.counts()["n_wires"], prog.spec,
                          device=card, lanes=256)
    ok, _ = checker.check_detailed(wit)
    assert bool(ok.all())
    w = wit.view(torch.int32).cpu().numpy().view(np.uint32)
    for lane in (0, 1, 5, 321, 639):
        ins = [limbs_to_int(x[i, :, lane]) for i in range(prog.n_inputs)]
        raw = {"inputs": ins} if name.startswith("poseidon2") \
            else {"a": ins[0], "b": ins[1]}
        host = list(cc.witness_host(raw))
        assert [limbs_to_int(w[i, :, lane]) for i in range(len(host))] \
            == host


def k4_against_plain(prog, x):
    """Every kernel of a segmented program through K4 and through its plain
    version, in place, each on its own witness and crossing buffer, from
    the same inputs: after each segment every witness and crossing row
    bit for bit; at the end no witness row left unwritten."""
    sp = prog.fused
    B = x.shape[-1]
    got, want = sp.buffers(B, UNWRITTEN), sp.buffers(B, UNWRITTEN)
    for s, seg in enumerate(sp.kernels):
        segment_k4(sp, s, x, *got)
        segment_ref(sp.field, seg, x, *want)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32)), \
                f"segment {s}"
    assert not bool((got[0].view(torch.int32) == UNWRITTEN).any())


@pytest.mark.parametrize("prime", list(PRIMES))
def test_k4_op_circuit_matches_plain(card, prime):
    """Every op of the segmented backend (constants with zero limbs,
    shift counts 0, 1, 15, 16, 17, bits - 1) on edge operands, at a
    batch that is not a multiple of the block (the masked ragged edge)."""
    spec = field_spec(prime)
    cc = compile_source(segment_ops_source(spec.p.bit_length()), prime=prime)
    prog = WitnessProgram(cc.build_tape()[0], spec, device=card,
                          mode="segments",
                          input_ranges=cc.input_range_hints())
    p, B = spec.p, 4099
    edges = [0, 1, p - 1, p // 2, p // 2 + 1, 1 << 16]
    rng = random.Random(41)
    cols = [[rng.randrange(p) for _ in range(B)] for _ in range(3)]
    for lane in range(36):
        cols[0][lane], cols[1][lane] = edges[lane % 6], edges[lane // 6]
    cols[2] = [lane % 2 for lane in range(B)]
    x = to_device(prog.encode_inputs(cols), card)
    k4_against_plain(prog, x)
    w = prog.run(x).view(torch.int32).cpu().numpy().view(np.uint32)
    for lane in (7, 8, 40, B - 1):
        host = list(cc.witness_host({"a": cols[0][lane], "b": cols[1][lane],
                                     "c": cols[2][lane]}))
        assert [limbs_to_int(w[i, :, lane]) for i in range(len(host))] \
            == host


@pytest.mark.parametrize("copies", [1, 4])
def test_k4_num2bits254_matches_plain_host_and_r1cs(card, copies):
    """Num2Bits(254) over bn128 (one segment) and 4 x Num2Bits(254)
    (several segments, values crossing the boundaries) through K4."""
    cc = compile_source(num2bits_source(254, copies))
    spec = field_spec("bn128")
    prog = WitnessProgram(cc.build_tape()[0], spec, device=card)
    assert isinstance(prog.fused, SegmentedProgram)
    assert (len(prog.fused.segments) > 1) == (copies > 1)
    x = canonical(np.random.default_rng(42), "bn128", (copies, 16, 1000))
    x[:, :, 0] = 0
    x[:, 0, 1] = 1
    k4_against_plain(prog, to_device(x, card))
    build.reset_launches()
    wit = prog.run(x)
    torch.cuda.synchronize()
    # the run is K4 alone: one launch a segment, no copy or gather kernel
    assert dict(build.LAUNCHES) == {"k4": len(prog.fused.kernels)}
    checker = R1CSChecker(cc.r1cs_rows(), cc.counts()["n_wires"], spec,
                          device=card, lanes=256)
    assert bool(checker.check(wit).all())
    w = wit.view(torch.int32).cpu().numpy().view(np.uint32)
    for lane in (0, 1, 999):
        ins = [limbs_to_int(x[i, :, lane]) for i in range(copies)]
        host = list(cc.witness_host({"a": ins}))
        assert [limbs_to_int(w[i, :, lane]) for i in range(len(host))] \
            == host


def test_perop_bigdiv_num2bits_matches_host_and_r1cs(card):
    """The straight-line path on the card: one KS launch a run, no K5, no
    K6, no interpreter and no K4; bit for bit the per-node path on the
    card (K5, K6 and plain PyTorch)."""
    cc = compile_source(bigdiv_num2bits_source())
    spec = field_spec("bn128")
    prog = WitnessProgram(cc.build_tape()[0], spec, device=card)
    assert prog.fused is None and prog.perop is not None
    rng = random.Random(5)
    B = 512
    cols = [[rng.randrange(spec.p) for _ in range(B)],
            [rng.randrange(1, spec.p) for _ in range(B)]]
    cols[0][0], cols[1][1] = spec.p - 1, 1
    x = prog.encode_inputs(cols)
    build.reset_launches()
    wit = prog.run(x)
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {"scan": 1}
    assert torch.equal(wit.view(torch.int32),
                       prog.perop.run_nodes(x).view(torch.int32))
    checker = R1CSChecker(cc.r1cs_rows(), cc.counts()["n_wires"], spec,
                          device=card, lanes=256)
    assert bool(checker.check(wit).all())
    w = wit.view(torch.int32).cpu().numpy().view(np.uint32)
    for lane in (0, 1, 300):
        host = list(cc.witness_host({"a": cols[0][lane],
                                     "b": cols[1][lane]}))
        assert [limbs_to_int(w[i, :, lane]) for i in range(len(host))] \
            == host


POW_DIV_SRC = """
pragma circom 2.0.0;
template PowDiv() {
    signal input a;
    signal input b;
    signal output o[5];
    o[0] <-- a ** 5;
    o[1] <-- a / b;
    o[2] <-- a % b;
    o[3] <-- (a * b) ** 65537;
    o[4] <-- a ** 2147483647;
}
component main = PowDiv();
"""


# the kernels a scan run launched one a step before KS
STEP_KERNELS = ("gather_w", "mont_mul", "add", "sub")


@pytest.mark.parametrize("slots", (8, 64))
@pytest.mark.parametrize("circuit", ("bigdiv_num2bits", "pow_div"))
def test_scan_steps_match_plain(card, circuit, slots):
    """The scan executor on the card (one KS launch a run) against its
    plain version, the step loop on the CPU, over bn128: bigint-div +
    Num2Bits(254) (idiv, mod, products, shifts, ands, adds) and powers
    and a division (pow_k with per-slot exponents, div), lanes dividing
    by 0 included; no step kernel, no interpreter and no K4."""
    cc = compile_source(bigdiv_num2bits_source() if circuit ==
                        "bigdiv_num2bits" else POW_DIV_SRC)
    spec = field_spec("bn128")
    prog = WitnessProgram(cc.build_tape()[0], spec, device=card,
                          mode="scan", unroll_threshold=0, slots=slots)
    assert prog.scan is not None
    plain = prog.for_device("cpu")
    rng = random.Random(6)
    B = 300
    cols = [[rng.randrange(spec.p) for _ in range(B)],
            [rng.randrange(spec.p) for _ in range(B)]]
    cols[1][1] = 0
    x = prog.encode_inputs(cols)
    build.reset_launches()
    wit = prog.run(x)
    torch.cuda.synchronize()
    assert dict(build.LAUNCHES) == {"scan": 1}
    np.testing.assert_array_equal(
        wit.view(torch.int32).cpu().numpy(),
        plain.run(x).view(torch.int32).numpy())


@pytest.mark.parametrize("warps", (1, 4, 8, 16))
def test_ks_matches_loop_on_q(card, warps):
    """KS at 1, 4, 8 and 16 warps a block against the step loop on the
    card (K2, K5, K6), on 16 x Num2Bits(254)/bn128 (the loop over Q's 1,366
    steps of 8 slots) at 300 lanes, the edges 0, 1, p - 1 and 2^253 in the
    first lanes; then with a shared file of 1 register, the rest spilled;
    a run launches KS once and no step kernel."""
    cc = compile_source(num2bits_source(254, 16))
    spec = field_spec("bn128")
    prog = WitnessProgram(cc.build_tape()[0], spec, device=card)
    assert prog.scan is not None and prog.scan.sched.n_steps == 1366
    rng = random.Random(7)
    B = 300
    cols = [[rng.randrange(spec.p) for _ in range(B)]
            for _ in range(prog.n_inputs)]
    for i, col in enumerate(cols):
        col[:4] = [0, 1, spec.p - 1, 1 << 253][i % 4:] + \
            [0, 1, spec.p - 1, 1 << 253][:i % 4]
    x = to_device(prog.encode_inputs(cols), card)
    want = prog.scan.run_loop(x)
    got = prog.scan.run_ks(x, warps)
    assert prog.scan.ks.tables(warps).n_spill == 0
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    spilled = KsProgram(prog.dt, prog.field, budget=8 * 4 * 32)
    assert spilled.tables(warps).n_spill > 0
    assert torch.equal(spilled.run(x, warps).view(torch.int32),
                       want.view(torch.int32))
    build.reset_launches()
    prog.run(x)
    torch.cuda.synchronize()
    assert build.LAUNCHES["scan"] == 1
    assert not any(build.LAUNCHES[k] for k in STEP_KERNELS)


def test_build_generated_is_cached(card, monkeypatch):
    """A second build of the same generated text loads the library nvcc
    wrote the first time, without calling nvcc."""
    cc = compile_source(num2bits_source(254, 1))
    prog = WitnessProgram(cc.build_tape()[0], field_spec("bn128"),
                          device=card)
    text = prog.fused.source()
    build.build_generated(text, 1)
    name = build.generated_name(text)
    assert build.segment_library(name, 0).exists()
    build._libs.pop(name)

    def no_nvcc(*args, **kwargs):
        raise AssertionError("nvcc was called for a cached source")

    monkeypatch.setattr(build.subprocess, "run", no_nvcc)
    lib = build.build_generated(text, 1)
    assert lib is build._libs[name] and hasattr(lib, "ctpu_k4_seg0")
