"""K1 and K3 read the interpreter's inputs where the caller's rows lie.

A run hands K1 (ops/cuda/interp.cu) and K3 (ops/cuda/gather.cu) the input
rows uint32 (n_inputs, Lin, B) and the plan's win_order and nin_order:
wide input k is row win_order[k] (Lin = L), narrow input k is limb0 |
limb1 << 16 of row nin_order[k] (limb0 alone where Lin = 1).  On the CPU,
exactly:

- interp.cu and gather.cu built by g++ for the host (the builds of
  test_torch_k1_host.py and test_torch_assemble.py), called with the new
  input arguments (backend/interp.k1_args, ctpu_gather_n), against the
  plain split (TorchInterpreter._inputs: split_inputs, narrow_inputs) with
  interp_ref.run_plan or gather_n_rows, on named cases: Lin = L, 2 and 1;
  only wide inputs, only narrow ones, both, none; more input rows than the
  plan reads; narrow inputs with bit 31 set; limbs 2 and up not zero; a
  win_order and a nin_order that are not the identity.  The split itself
  is held against the bits computed here in numpy.
- the same inputs through the JAX package's split: its interpreter
  (InterpreterProgram._run and _run_mixed) in Pallas interpret mode at
  goldilocks, and its scan path at bn128 (in-range inputs there: the scan
  computes in the field), against the port's plain runs and the g++ K1
  and KW on the same rows.
- check_inputs' refusals, which read only shapes and the plan.
- kernel_ab's reading of another checkout's K1 and K3 interfaces, the
  length of each argument list it builds, and its refusal of interfaces
  older than 0844d12's.
"""

import random
import zlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from circom_tpu.backend.jax_backend import WitnessProgram as JaxProgram
from circom_tpu.compiler.pipeline import compile_source as jax_compile
from circom_tpu.field.primes import field_spec as jax_field_spec
import circom_tpu_torch.backend.interp as interp_mod
from circom_tpu_torch.backend.interp import (TorchInterpreter, check_inputs,
                                             interp_k1, k1_args,
                                             k1_file_shape, k1_plain,
                                             split_inputs)
from circom_tpu_torch.backend.interp_plan import (_NARROW_RESULT,
                                                  _OPERAND_FILES)
from circom_tpu_torch.backend.interp_ref import gather_n_rows
from circom_tpu_torch.backend.torch_backend import WitnessProgram
from circom_tpu_torch.compiler.pipeline import compile_source
from circom_tpu_torch.convert import (K1C_OPCODES, K1D_OPCODES, N_OPERANDS,
                                      narrow_unit_arrays, plan_from_arrays,
                                      unit_arrays, unit_inputs)
from circom_tpu_torch.field.primes import field_spec
from circom_tpu_torch.ops.field import TorchField
from circom_tpu_torch.ops.limbs import ints_to_limbs
from test_torch_assemble import host_kw, kwhost, u32  # noqa: F401
from test_torch_k1_host import k1host, u32_tensor  # noqa: F401

B = 8
# narrow values at the edges, in the first lanes: bit 31 set (-2^31, -1),
# 0, 2^31 - 1, 2^16 - 1 and 2^16 (a carry into limb 1)
NARROW_EDGES = (0x80000000, 0xFFFFFFFF, 0, 0x7FFFFFFF, 0xFFFF, 0x10000)

# a wide input a and b, three bit inputs s (the narrow lane), and their
# products, sums and a narrow product
INMIX_SRC = """
pragma circom 2.0.0;
template InMix() {
    signal input a;
    signal input s[3];
    signal input b;
    signal output o;
    signal output t;
    signal output u;
    signal output v;
    for (var i = 0; i < 3; i++) { s[i] * (s[i] - 1) === 0; }
    t <== s[0] * a;
    u <== s[0] + 2 * s[1] - 4 * s[2];
    v <== s[1] * s[2];
    o <== t * b + u;
}
component main = InMix();
"""


def narrow_limbs(rng, n_rows, lin, b):
    """Input rows (n_rows, lin, b) of random 16-bit limbs, none of them 0
    above limb 1, whose limbs 0 and 1 hold NARROW_EDGES in the first
    lanes."""
    x = rng.integers(1, 1 << 16, size=(n_rows, lin, b), dtype=np.uint32)
    for j, v in enumerate(NARROW_EDGES[:b]):
        x[:, 0, j] = v & 0xFFFF
        if lin > 1:
            x[:, 1, j] = v >> 16
    return x


def wide_only_ops():
    """The K1d opcodes (and add) whose operands all lie in the wide file
    and whose result is wide."""
    return tuple(op for op in K1D_OPCODES + ("add",)
                 if op not in _NARROW_RESULT
                 and "n" not in _OPERAND_FILES.get(op, "www")[:N_OPERANDS[op]])


def case(name):
    """(plan, field, input rows uint32 (n_inputs, Lin, B) numpy) of one
    named case, on the CPU.  Wide input rows hold canonical values (the
    unit plan's edges), narrow ones narrow_limbs."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    prime = "goldilocks" if name.endswith("goldilocks") else "bn128"
    spec = field_spec(prime)
    L = spec.n_limbs
    if name.startswith(("both", "wide-only", "permuted")):
        ops = (wide_only_ops() if name.startswith("wide-only") else
               K1D_OPCODES + (K1C_OPCODES if prime == "goldilocks"
                              else ("add",)))
        arrays, _ = unit_arrays(spec.p, L, ops)
        x_w, _ = unit_inputs(spec.p, L, B, 81)
        if name.startswith("wide-only"):
            arrays["nin_of"] = {}
            x = x_w
        elif name.startswith("permuted"):
            # wide inputs at rows 4, 0, 2, narrow at 5, 1, 3, of 8 rows
            arrays["win_of"] = {4: 0, 0: 1, 2: 2}
            arrays["nin_of"] = {5: 0, 1: 1, 3: 2}
            x = narrow_limbs(rng, 8, L, B)
            x[[4, 0, 2]] = x_w
        else:
            x = np.concatenate([x_w, narrow_limbs(rng, 3, L, B)])
    else:
        arrays, _ = narrow_unit_arrays(16, (0, 1, 31, 32, 33, -1))
        lin = {"narrow-L": 16, "narrow-2": 2, "narrow-1": 1,
               "narrow-permuted-2": 2, "no-inputs": 16}[name]
        if name == "narrow-permuted-2":
            arrays["nin_of"] = {3: 0, 1: 1}
        if name == "no-inputs":
            # both operands are constants: nothing is read from the rows
            arrays["nin_of"] = {}
            arrays["nmat_loads"] = [(0, -7), (1, 2 ** 31 - 1)]
        n_rows = {"narrow-permuted-2": 5, "no-inputs": 0}.get(name, 3)
        x = narrow_limbs(rng, n_rows, lin, B)
    return plan_from_arrays(arrays, "cpu"), TorchField(spec), x


CASES = ["both", "both-goldilocks", "wide-only", "permuted",
         "permuted-goldilocks", "narrow-L", "narrow-2", "narrow-1",
         "narrow-permuted-2", "no-inputs"]


def expected_split(plan, x):
    """The split computed in numpy: wide rows as they are, narrow values
    limb0 | limb1 << 16 in 32 bits (limb0 alone where Lin = 1)."""
    x = np.asarray(x, np.uint64)
    nin = np.asarray(plan.nin_order, np.int64)
    lo = x[nin, 0]
    v = lo | (x[nin, 1] << np.uint64(16)) if x.shape[1] > 1 else lo
    x_w = x[np.asarray(plan.win_order, np.int64)] if plan.win_order \
        else np.zeros((0, plan.L, x.shape[-1]))
    return (x_w.astype(np.uint32),
            (v & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32))


def host_k1(lib, plan, field, x):
    """K1 built by g++ on the input rows x (uint32 tensor): its banks,
    unwritten rows 0."""
    L, b = plan.L, x.shape[-1]
    rf = torch.zeros(k1_file_shape(plan, b), dtype=torch.int32)
    rf_n = torch.zeros((plan.n_nregs, b), dtype=torch.int32)
    bank = torch.zeros((plan.n_bank_rows, L, b), dtype=torch.int32)
    bank_n = torch.zeros((plan.n_bank_n_rows, b), dtype=torch.int32)
    assert lib.ctpu_interp_k1(*k1_args(
        plan, field, x, rf.view(torch.uint32), bank.view(torch.uint32),
        rf_n, bank_n, None)) == 0
    return bank.view(torch.uint32), bank_n


def test_cases_cover_the_named_edges():
    """The named cases hold every edge the loads must meet."""
    seen = set()
    for name in CASES:
        plan, _f, x = case(name)
        lin, n = x.shape[1], x.shape[0]
        seen.add(f"Lin={'L' if lin == plan.L else lin}")
        seen.add({(True, True): "both", (True, False): "wide only",
                  (False, True): "narrow only", (False, False): "none"}[
                      bool(plan.win_order), bool(plan.nin_order)])
        if n > plan.n_input_rows:
            seen.add("extra rows")
        if plan.win_order and plan.win_order != list(range(len(
                plan.win_order))):
            seen.add("win_order permuted")
        if plan.nin_order:
            _w, x_n = expected_split(plan, x)
            if (x_n < 0).any():
                seen.add("bit 31")
            if lin > 2 and x[plan.nin_order, 2:].all():
                seen.add("limbs 2+")
    assert seen == {"Lin=L", "Lin=2", "Lin=1", "both", "wide only",
                    "narrow only", "none", "extra rows",
                    "win_order permuted", "bit 31", "limbs 2+"}


@pytest.mark.parametrize("name", CASES)
def test_host_k1_reads_input_rows(k1host, name):
    """K1 by g++ on the rows equals the plain executor on the split, on
    every emitted row of both banks; the split equals numpy's bits."""
    plan, field, x = case(name)
    xs = u32_tensor(x)
    inputs, x_w, x_n = TorchInterpreter(plan, field)._inputs(xs)
    want_w, want_n = expected_split(plan, x)
    np.testing.assert_array_equal(u32(x_w), want_w)
    np.testing.assert_array_equal(x_n.numpy(), want_n)
    got_w, got_n = host_k1(k1host, plan, field, inputs)
    plain_w, plain_n = k1_plain(plan, field, x_w, x_n)
    rows = plan.emitted_rows()
    rows_n = plan.emitted_rows(narrow=True)
    assert len(rows) + len(rows_n)
    np.testing.assert_array_equal(u32(got_w)[rows], u32(plain_w)[rows])
    np.testing.assert_array_equal(got_n.numpy()[rows_n],
                                  plain_n.numpy()[rows_n])
    # interp_k1 on the CPU is the same plain route
    cpu_w, cpu_n = interp_k1(plan, field, xs)
    assert torch.equal(cpu_n, plain_n)
    assert torch.equal(cpu_w.view(torch.int32), plain_w.view(torch.int32))


@pytest.mark.parametrize("b", (3, 8))
@pytest.mark.parametrize("name", ["both", "narrow-2", "narrow-1",
                                  "narrow-permuted-2", "no-inputs"])
def test_host_k3_reads_input_rows(kwhost, name, b):
    """K3 by g++ reads its narrow input sources in the rows (4 and 16
    bytes a thread) and equals the plain gather over the split."""
    plan, _f, x = case(name)
    x = np.ascontiguousarray(x[..., :b])
    rng = np.random.default_rng(b)
    bank_n = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, size=(6, b))
                              .astype(np.int32))
    n_src = 6 + len(plan.nin_order)
    src = torch.from_numpy(np.concatenate([
        np.arange(n_src), rng.integers(0, n_src, size=20)]).astype(np.int32))
    shift = torch.from_numpy(np.resize(np.asarray([-1, 0, 1, 15, 16, 31],
                                                  np.int32), len(src)))
    xs = u32_tensor(x)
    _w, x_n = split_inputs(plan, xs)
    order = plan.dev["nin_order"]
    out = torch.empty((len(src), b), dtype=torch.int32)
    assert kwhost.ctpu_gather_n(bank_n.data_ptr(), 6, xs.data_ptr(),
                                x.shape[1], order.data_ptr(), src.data_ptr(),
                                shift.data_ptr(), out.data_ptr(), len(src),
                                b, None) == 0
    np.testing.assert_array_equal(
        out.numpy(), gather_n_rows(bank_n, x_n, src, shift).numpy())


def test_check_inputs_refusals():
    """check_inputs refuses too few rows, a Lin other than 1, 2 and L,
    narrow rows for wide inputs, and a dtype other than uint32; it takes
    extra rows and, where no input is wide, Lin 1 and 2."""
    plan, _f, x = case("both")
    xs = u32_tensor(x)
    check_inputs(plan, u32_tensor(np.concatenate([x, x])))
    for bad, match in ((xs[:5], "reads input row 5"),
                       (xs[:, :3], "input rows of 3 limbs"),
                       (xs[:, :2], "wide inputs need full-limb"),
                       (xs.view(torch.int32), "uint32")):
        with pytest.raises(ValueError, match=match):
            check_inputs(plan, bad)
    narrow, _f, xn = case("narrow-permuted-2")
    check_inputs(narrow, u32_tensor(xn))
    check_inputs(narrow, u32_tensor(xn[:, :1]))
    with pytest.raises(ValueError, match="reads input row 3"):
        check_inputs(narrow, u32_tensor(xn[:3]))


# -- the JAX package's split: its interpreter and its scan path -------------

def inmix_columns(p, b, edges):
    """Input columns of INMIX_SRC: a, s[0..2], b.  Wide values 0, 1, p - 1
    and p // 2 in the first lanes, then random; the bits random, or with
    `edges` NARROW_EDGES as raw 32-bit values (out of the bits' range: both
    interpreters' int32 lanes compute on them all the same)."""
    rng = random.Random(b)
    a = ([0, 1, p - 1, p // 2] + [rng.randrange(p) for _ in range(b)])[:b]
    bits = [[rng.randrange(2) for _ in range(b)] for _ in range(3)]
    if edges:
        for k in range(3):
            for j, v in enumerate(NARROW_EDGES[:b]):
                bits[k][(j + k) % b] = v
    return [a, *bits, a[1:] + a[:1]]


def inmix_rows(cols, L):
    return np.stack([ints_to_limbs(c, L).T.copy() for c in cols])


@pytest.fixture(scope="module")
def inmix_goldilocks():
    cc_j = jax_compile(INMIX_SRC, prime="goldilocks")
    tape_j, _ = cc_j.build_tape()
    jp = JaxProgram(tape_j, jax_field_spec("goldilocks"), unroll_threshold=0,
                    mode="interp", input_ranges=cc_j.input_range_hints())
    cc = compile_source(INMIX_SRC, prime="goldilocks")
    prog = WitnessProgram(cc.build_tape()[0], field_spec("goldilocks"),
                          device="cpu", input_ranges=cc.input_range_hints())
    return jp.fused, prog


@pytest.mark.parametrize("edges", (False, True))
def test_jax_interpreter_split_goldilocks(k1host, kwhost, inmix_goldilocks,
                                          edges):
    """At goldilocks the JAX interpreter, run eagerly in Pallas interpret
    mode on the same rows, gives the port's witness: the plain run and K1
    + KW by g++, whose K1 reads the rows where they lie (wide inputs at
    rows 0 and 4, narrow at 1-3), and run_mixed's narrow and wide rows;
    with `edges`, narrow inputs with bit 31 set."""
    fused, prog = inmix_goldilocks
    p = prog.spec.p
    interp = prog.interp
    assert interp.plan.win_order == [0, 4]
    assert interp.plan.nin_order == [1, 2, 3]
    x = inmix_rows(inmix_columns(p, 5, edges), 4)
    want = np.asarray(fused._run(x))
    np.testing.assert_array_equal(u32(prog.run(x)), want)
    bank, bank_n = host_k1(k1host, interp.plan, prog.field, u32_tensor(x))
    got = host_kw(kwhost, interp, u32_tensor(x), bank, bank_n)
    np.testing.assert_array_equal(u32(got), want)
    want_n, want_w = (np.asarray(a) for a in fused._run_mixed(x))
    got_n, got_w = prog.run_mixed(x)
    np.testing.assert_array_equal(got_n.numpy(), want_n)
    np.testing.assert_array_equal(u32(got_w), want_w)


# four bit inputs, all on the narrow lane: run_mixed takes rows of 1, 2 or
# L limbs
INBITS_SRC = """
pragma circom 2.0.0;
template InBits() {
    signal input s[4];
    signal output o[4];
    for (var i = 0; i < 4; i++) { s[i] * (s[i] - 1) === 0; }
    for (var i = 0; i < 4; i++) {
        o[i] <== s[i] + s[(i + 1) % 4] - 2 * s[i] * s[(i + 1) % 4];
    }
}
component main = InBits();
"""


@pytest.mark.parametrize("lin", (4, 2, 1))
def test_jax_run_mixed_split_goldilocks(k1host, kwhost, lin):
    """An all-narrow circuit at goldilocks: the JAX interpreter's
    run_mixed (Pallas interpret mode) on rows of `lin` limbs, narrow
    values with bit 31 set and limbs above 1 not zero, equals the port's
    run_mixed on the same rows, and K1 + K3 by g++ on them."""
    cc_j = jax_compile(INBITS_SRC, prime="goldilocks")
    tape_j, _ = cc_j.build_tape()
    fused = JaxProgram(tape_j, jax_field_spec("goldilocks"),
                       unroll_threshold=0, mode="interp",
                       input_ranges=cc_j.input_range_hints()).fused
    cc = compile_source(INBITS_SRC, prime="goldilocks")
    prog = WitnessProgram(cc.build_tape()[0], field_spec("goldilocks"),
                          device="cpu", input_ranges=cc.input_range_hints())
    plan = prog.interp.plan
    assert not plan.win_order and len(plan.nin_order) == 4
    x = narrow_limbs(np.random.default_rng(lin), 4, lin, 6)
    want_n, want_w = (np.asarray(a) for a in fused._run_mixed(x))
    got_n, got_w = prog.run_mixed(x)
    np.testing.assert_array_equal(got_n.numpy(), want_n)
    np.testing.assert_array_equal(u32(got_w), want_w)
    xs = u32_tensor(x)
    _bank, bank_n = host_k1(k1host, plan, prog.field, xs)
    src, shift = plan.dev["nw_src"], plan.dev["nw_shift"]
    out = torch.empty((len(src), 6), dtype=torch.int32)
    assert kwhost.ctpu_gather_n(bank_n.data_ptr(), plan.n_bank_n_rows,
                                xs.data_ptr(), lin,
                                plan.dev["nin_order"].data_ptr(),
                                src.data_ptr(), shift.data_ptr(),
                                out.data_ptr(), len(src), 6, None) == 0
    np.testing.assert_array_equal(out.numpy(), want_n)


@pytest.fixture(scope="module")
def inmix_bn128():
    cc_j = jax_compile(INMIX_SRC, prime="bn128")
    tape_j, _ = cc_j.build_tape()
    scan = JaxProgram(tape_j, jax_field_spec("bn128"), unroll_threshold=0,
                      mode="scan", input_ranges=cc_j.input_range_hints())
    cc = compile_source(INMIX_SRC, prime="bn128")
    prog = WitnessProgram(cc.build_tape()[0], field_spec("bn128"),
                          device="cpu", input_ranges=cc.input_range_hints())
    return scan, prog, cc


def test_jax_scan_split_bn128(k1host, kwhost, inmix_bn128):
    """At bn128 the JAX scan path on in-range rows (bits on the narrow
    lane) gives the port's witness: the plain run, K1 + KW by g++ on the
    rows, run_mixed's narrow and wide rows, and the host calculator."""
    scan, prog, cc = inmix_bn128
    p = prog.spec.p
    cols = inmix_columns(p, 4, edges=False)
    x = inmix_rows(cols, 16)
    want = np.asarray(scan.run(x))
    np.testing.assert_array_equal(u32(prog.run(x)), want)
    interp = prog.interp
    bank, bank_n = host_k1(k1host, interp.plan, prog.field, u32_tensor(x))
    got = host_kw(kwhost, interp, u32_tensor(x), bank, bank_n)
    np.testing.assert_array_equal(u32(got), want)
    n_idx, w_idx = prog.mixed_layout()
    got_n, got_w = prog.run_mixed(x)
    np.testing.assert_array_equal(u32(got_w), want[w_idx])
    for lane in range(4):
        host = list(cc.witness_host({"a": cols[0][lane],
                                     "s": [c[lane] for c in cols[1:4]],
                                     "b": cols[4][lane]}))
        w = [sum(int(want[i, k, lane]) << (16 * k) for k in range(16))
             for i in range(len(host))]
        assert w == host
        # a narrow row holds its value as a signed int32
        assert [int(v) % p for v in got_n[:, lane]] == [w[i] for i in n_idx]


# -- the card route on strided views of the caller's rows -----------------

def meta_inputs_seen(monkeypatch):
    """The card route on "meta" (nothing runs): K1, K3 and KW replaced by
    stand-ins that record (kernel, whether its input rows are contiguous,
    their shape); K2 and the launches do nothing."""
    seen = []

    def k1(plan, field, inputs):
        seen.append(("interp_k1", inputs.is_contiguous(),
                     tuple(inputs.shape)))
        B = inputs.shape[-1]
        return (torch.empty((plan.n_bank_rows, plan.L, B),
                            dtype=torch.uint32, device="meta"),
                torch.empty((plan.n_bank_n_rows, B), dtype=torch.int32,
                            device="meta"))

    def k3(bank_n, inputs, order, src, shift, out):
        seen.append(("gather_n", inputs.is_contiguous(),
                     tuple(inputs.shape)))

    def kw(field, tab, bank, bank_n, inputs, *rest):
        seen.append(("assemble", inputs.is_contiguous(),
                     tuple(inputs.shape)))
        return ()

    monkeypatch.setattr(interp_mod, "launch_k1", k1)
    monkeypatch.setattr(interp_mod, "launch_gather_n", k3)
    monkeypatch.setattr(interp_mod, "launch_gather_w", lambda *a: None)
    monkeypatch.setattr(interp_mod, "kw_args", kw)
    monkeypatch.setattr(interp_mod, "launch", lambda *a, **k: None)
    monkeypatch.setattr(interp_mod, "library",
                        lambda name: SimpleNamespace(ctpu_assemble=None))
    monkeypatch.setattr(interp_mod, "stream_ptr", lambda dev: None)
    return seen


@pytest.mark.parametrize("view", ["limbs", "lanes", "lanes-full"])
def test_card_route_hands_kernels_contiguous_rows(monkeypatch, view):
    """A strided view of the caller's input rows (x[:, :2] of 4-limb rows,
    x[..., :b] of a wider batch) reaches K1, K3 and KW on the card as
    contiguous rows of the view's shape: each reads input row r at r *
    Lin * B, so a view handed on as it lies would read the wrong rows.
    run_mixed for "limbs" and "lanes", run for "lanes-full"; "meta"
    stands in for the card."""
    seen = meta_inputs_seen(monkeypatch)
    cc = compile_source(INBITS_SRC, prime="goldilocks")
    prog = WitnessProgram(cc.build_tape()[0], field_spec("goldilocks"),
                          device="cpu", input_ranges=cc.input_range_hints())
    interp = prog.for_device("meta").interp
    whole = {"limbs": (4, 4, 8), "lanes": (4, 2, 16),
             "lanes-full": (4, 4, 16)}[view]
    x = torch.empty(whole, dtype=torch.uint32, device="meta")
    x = x[:, :2] if view == "limbs" else x[..., :8]
    assert not x.is_contiguous()
    if view == "lanes-full":
        interp._run(x)
    else:
        interp._run_mixed(x)
    names = [k for k, *_ in seen]
    assert names[0] == "interp_k1"
    assert ("gather_n" in names) == (view != "lanes-full")
    assert all(c and shape == tuple(x.shape) for _k, c, shape in seen), seen


# -- kernel_ab's reading of an other checkout's K1 and K3 -------------------

def _checkout(root, interp_head, gather_head):
    """A checkout at `root` whose interp.cu and gather.cu hold only the
    given entry points' parameter lists."""
    cuda = root / "circom_tpu_torch" / "ops" / "cuda"
    cuda.mkdir(parents=True)
    (cuda / "interp.cu").write_text(
        f'extern "C" int ctpu_interp_k1({interp_head}) {{\n}}\n')
    (cuda / "gather.cu").write_text(
        f'extern "C" int ctpu_gather_n({gather_head}) {{\n}}\n')
    return root


def test_kernel_ab_reads_each_k1_interface(tmp_path):
    """kernel_ab tells the other checkout's K1 and K3 apart by their entry
    points: this checkout's (the input rows) and the split inputs of
    0844d12 (35 arguments); it refuses the older K1 that takes the
    constant bank in limbs (36) as well; each argument list it builds has
    its signature's length."""
    from circom_tpu_torch import kernel_ab

    root = kernel_ab.ROOT
    assert kernel_ab.k1_interface(root) == "rows"
    assert kernel_ab.rows_k3(root)
    old_n = ("const int32_t* bank_n, long long n_bank_rows, "
             "const int32_t* x_n, const int32_t* src")
    split = _checkout(tmp_path / "split", "int L, long long B, "
                      "const uint32_t* x_w, int n_win, const int32_t* x_n, "
                      "const uint32_t* cbank_w", old_n)
    limbs = _checkout(tmp_path / "limbs", "int L, long long B, "
                      "const uint32_t* x_w, const uint32_t* cbank, "
                      "const uint32_t* cbank_w", old_n)
    assert kernel_ab.k1_interface(split) == "split"
    with pytest.raises(SystemExit, match="older than 0844d12"):
        kernel_ab.k1_interface(limbs)
    assert not kernel_ab.rows_k3(split)
    plan, field, x = case("both")
    xs = u32_tensor(x)
    x_w, x_n = split_inputs(plan, xs)
    bufs = (xs, xs, xs, xs)
    lengths = {"rows": len(k1_args(plan, field, xs, *bufs, None)),
               "split": len(kernel_ab.split_k1_args(plan, field, x_w, x_n,
                                                    *bufs, None))}
    assert lengths == {"rows": 37, "split": 35}
    assert {k: len(v[1]) for k, v in kernel_ab.K1_SIGNATURES.items()} == \
        lengths
    assert len(kernel_ab.SPLIT_K3["ctpu_gather_n"][1]) == 9


@pytest.mark.parametrize("name", ["check", "scan"])
def test_kernel_ab_refuses_older_kc_and_ks(tmp_path, name):
    """kernel_ab keeps no route older than 0844d12's: a KC over CSR
    columns (no entry streams, a_ent) or a KS over a register file in
    device memory (no n_smem) is refused before anything is built; this
    checkout's sources are taken."""
    from circom_tpu_torch import kernel_ab

    kernel_ab.refuse_older(kernel_ab.ROOT, ["interp", "check", "scan"])
    cuda = tmp_path / "circom_tpu_torch" / "ops" / "cuda"
    cuda.mkdir(parents=True)
    for other in ("check", "scan"):
        text = (kernel_ab.ROOT / "circom_tpu_torch" / "ops" / "cuda"
                / f"{other}.cu").read_text()
        if other == name:
            text = text.replace(kernel_ab.CURRENT_MARKS[name], "older")
        (cuda / f"{other}.cu").write_text(text)
    kernel_ab.refuse_older(tmp_path, ["interp"])
    with pytest.raises(SystemExit, match=f"{name}.cu of .* older"):
        kernel_ab.refuse_older(tmp_path, ["check", "scan"])
