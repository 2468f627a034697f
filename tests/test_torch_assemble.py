"""Kernel KW (ops/cuda/gather.cu), the interpreter's full-limb witness
assembled in one launch, on the CPU.

gather.cu is built by g++ for the host: the CUDA qualifiers defined away,
each launch a loop over the 2-D grid and the threads of a block.  KW is
called through the port's own argument list (backend/interp.kw_args) on
CPU tensors, with the interpreter's own table (`kw_table`), and its
witness is held to:

- the parts route (`TorchInterpreter.assemble_parts`: K2, K3, the plain
  widening and index_put), KW's plain version, on the same banks;
- the JAX package: its interpreter in interpret mode on test_bitpack's
  word circuits (goldilocks), its `_unpack_bits` and `_widen_narrow` on
  every narrow row of the synthetic plans; the host calculator at bn128
  (MerkleInclusion(4), the comparators); hashlib for SHA256's digests.

The plans: SHA256 (every row a narrow emission), MerkleInclusion(4)
(wide rows and the pathIndex bits), the comparators (wide and narrow),
hand-edited plans of Poseidon2/bn128 and the word circuit with every
wit_src kind interleaved in witness order (wide and narrow inputs,
constants), and synthetic plans with random banks: narrow values 0, 1,
2^31 - 1, -1, -2^31 and random ones, shifts -1, 0, 31, 32, 33, at L = 4
(goldilocks, and a 49-bit modulus whose negative widening carries into
the last limb), 16 (bn128) and 24 (the base field of BLS12-381), at
B = 1, 3, 4 and 5 lanes (4: 16 bytes a thread).  KW's table refuses a
row written twice or never and a source outside its tensor; on a device
other than the CPU ("meta" here) a run launches KW (K2 alone where the
witness is the wide bank's rows) and never takes the parts route.

Every comparison is exact (tolerance 0).
"""

import ctypes
import dataclasses
import random
import re
import shutil
import subprocess
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from circom_tpu.backend.interp import InterpreterProgram, _unpack_bits
from circom_tpu_torch.backend import interp as interp_mod
from circom_tpu_torch.backend.interp import (KW_BANK, KW_CONST, KW_INPUT,
                                             KW_NARROW, TorchInterpreter,
                                             interp_k1, kw_args, kw_table,
                                             narrow_inputs)
from circom_tpu_torch.backend.interp_ref import gather_n_rows, gather_rows
from circom_tpu_torch.backend.torch_backend import WitnessProgram
from circom_tpu_torch.circuits import sha256_io
from circom_tpu_torch.circuits.gen_poseidon import generate
from circom_tpu_torch.circuits.sources import (comparator_inputs,
                                               comparators_source,
                                               merkle_source)
from circom_tpu_torch.compiler.pipeline import compile_source
from circom_tpu_torch.convert import plan_from_arrays
from circom_tpu_torch.field.primes import FieldSpec, field_spec
from circom_tpu_torch.ops import build
from circom_tpu_torch.ops.field import TorchField
from circom_tpu_torch.ops.limbs import limbs_to_int
from circom_tpu_torch.utils.roofline import kw_bytes
from test_bitpack import WORD_SRC
from test_torch_narrow import packed  # noqa: F401  (a fixture)
import test_torch_shared as shared

ROOT = Path(__file__).resolve().parents[1]
# the base field of BLS12-381, 381 bits: 24 limbs
BLS12381_Q = int(
    "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f6241eab"
    "fffeb153ffffb9feffffffffaaab", 16)
# 2^48 + 2^16 + 1: limb 2 of p is 0, so p - 2^32 has 0xffff there and the
# widening of -1 carries from limb 0 into the last limb
P49 = (1 << 48) + (1 << 16) + 1
FIELDS = {"bn128": field_spec("bn128"), "goldilocks": field_spec("goldilocks"),
          "bls12381_q": FieldSpec("bls12381_q", BLS12381_Q),
          "p49": FieldSpec("p49", P49)}
NARROW_EDGES = (0, 1, 2 ** 31 - 1, -1, -2 ** 31)
SHIFTS = (-1, 0, 31, 32, 33)

# the CUDA names gather.cu uses, for g++: a launch runs every block of the
# 2-D grid and every thread of a block in turn
SHIM = """\
#pragma once
#include <cstdint>
#define __device__
#define __global__
#define __forceinline__ inline
#define __grid_constant__
#define __launch_bounds__(...)
struct int4 { int x, y, z, w; };
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return uint4{x, y, z, w};
}
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
static dim3 blockIdx, threadIdx, blockDim, gridDim;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class T> inline T __ldg(const T* p) { return *p; }
template <class K, class... A>
void host_launch(K kernel, dim3 grid, unsigned threads, A... args) {
  gridDim = grid;
  blockDim = dim3(threads);
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx)
      for (unsigned th = 0; th < threads; ++th) {
        blockIdx = dim3(bx, by);
        threadIdx = dim3(th);
        kernel(args...);
      }
}
"""


@pytest.fixture(scope="module")
def kwhost(tmp_path_factory):
    """gather.cu built by g++, entry points ctpu_assemble (KW),
    ctpu_gather_rows (K2) and ctpu_gather_n (K3) as on the card."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build gather.cu for the host")
    src = (ROOT / "circom_tpu_torch/ops/cuda/gather.cu").read_text()
    src, n = re.subn(r"([\w:]+<[^<>]*>)\s*<<<([^<>]+?), ([^<>]+?), 0, "
                     r"s>>>\(", r"host_launch(\1, \2, \3, ", src)
    assert n == 5    # K2 once, K3 and KW twice (16 and 4 bytes a thread)
    tmp = tmp_path_factory.mktemp("kwhost")
    (tmp / "cuda_runtime.h").write_text(SHIM)
    (tmp / "gather_host.cpp").write_text(src)
    so = tmp / "gather_host.so"
    r = subprocess.run(
        ["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-w", "-I",
         str(tmp), "-I", str(ROOT / "circom_tpu_torch/ops/cuda"), "-o",
         str(so), str(tmp / "gather_host.cpp")],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lib = ctypes.CDLL(str(so))
    for fn, (res, args) in build.SIGNATURES["gather"].items():
        getattr(lib, fn).restype = res
        getattr(lib, fn).argtypes = args
    return lib


def u32(t):
    return t.view(torch.int32).numpy().view(np.uint32)


def host_kw(lib, interp, inputs, bank, bank_n, rows="full"):
    """One host KW launch as TorchInterpreter.assemble_kw makes it on the
    card: the interpreter's table `rows`, its constants, on CPU tensors."""
    tab = interp._kw[rows]
    out = torch.empty((tab.shape[0], interp.plan.L, inputs.shape[-1]),
                      dtype=torch.uint32)
    rc = lib.ctpu_assemble(*kw_args(interp.field, tab, bank, bank_n,
                                    inputs.contiguous(),
                                    interp.plan.dev["consts"], out, None))
    assert rc == 0
    return out


def banks_and_both(lib, interp, x):
    """K1's banks on the plain executor, then (KW's witness, the parts
    route's) from them."""
    inputs, x_w, _ = interp._inputs(x)
    bank, bank_n = interp_k1(interp.plan, interp.field, inputs)
    got = host_kw(lib, interp, inputs, bank, bank_n)
    want = interp.assemble_parts(inputs, x_w, bank, bank_n)
    return u32(got), u32(want)


# -- the repository's circuits ---------------------------------------------

@pytest.fixture(scope="module")
def sha256():
    cc, _tape, prog = shared.program(shared.sha256_source())
    return cc, prog


@pytest.mark.parametrize("B", (3, 4))
def test_kw_sha256_matches_parts_and_hashlib(kwhost, sha256, B):
    _cc, prog = sha256
    rng = random.Random(B)
    msgs = [bytes(rng.randrange(256) for _ in range(32)) for _ in range(B)]
    x = sha256_io.input_rows(msgs, 16)
    got, want = banks_and_both(kwhost, prog.interp, x)
    np.testing.assert_array_equal(got, want)
    # witness rows 1..256 hold the digest's bits in limb 0
    assert not got[1:257, 1:].any()
    np.testing.assert_array_equal(got[1:257, 0],
                                  sha256_io.digest_bits_batch(msgs))


def input_map(layout, cols, lane):
    out = {}
    for name, dims, off in layout:
        n = int(np.prod(dims))
        vals = [cols[off + k][lane] for k in range(n)]
        out[name] = vals if dims else vals[0]
    return out


@pytest.mark.parametrize("B", (1, 5))
def test_kw_merkle4_matches_parts_and_host(kwhost, B):
    """MerkleInclusion(4): wide bank rows and the pathIndex bits' narrow
    rows."""
    cc = compile_source(merkle_source(4))
    tape, layout = cc.build_tape()
    hints = cc.input_range_hints()
    prog = WitnessProgram(tape, field_spec("bn128"), device="cpu",
                          input_ranges=hints)
    plan = prog.interp.plan
    assert len(plan.wd_idx) and len(plan.nw_idx)
    rng = random.Random(B + 10)
    cols = [[rng.randrange(2) if i in hints else rng.randrange(cc.p)
             for _ in range(B)] for i in range(tape.n_inputs)]
    got, want = banks_and_both(kwhost, prog.interp, prog.encode_inputs(cols))
    np.testing.assert_array_equal(got, want)
    for lane in range(B):
        host = list(cc.witness_host(input_map(layout, cols, lane)))
        assert [limbs_to_int(got[i, :, lane]) for i in range(len(host))] \
            == host


def test_kw_comparators_match_parts_and_host(kwhost):
    cc = compile_source(comparators_source())
    spec = field_spec("bn128")
    prog = WitnessProgram(cc.build_tape()[0], spec, device="cpu",
                          input_ranges=cc.input_range_hints())
    x = comparator_inputs(3, 61, spec.n_limbs)
    got, want = banks_and_both(kwhost, prog.interp, x)
    np.testing.assert_array_equal(got, want)
    for lane in range(3):
        ins = [limbs_to_int(x[i, :, lane]) for i in range(prog.n_inputs)]
        host = list(cc.witness_host({"a": ins[0], "b": ins[1]}))
        assert [limbs_to_int(got[i, :, lane]) for i in range(len(host))] \
            == host


@pytest.mark.parametrize("lanes", (8, 5))
def test_kw_word_circuits_match_jax_interpret(kwhost, packed, lanes):
    """test_bitpack's word circuits at goldilocks: KW's witness equals
    the JAX interpreter's (interpret mode) and the parts route's."""
    prog, _jp, x, _narrow, _wide, full = packed
    x = x[..., :lanes].copy()
    got, want = banks_and_both(kwhost, prog.interp, x)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, full[..., :lanes])


# -- hand-edited plans: every wit_src kind interleaved ----------------------

def edited(prog, edits):
    """The interpreter of prog's plan with wit_src rows replaced."""
    arrays = prog.plan.plan_arrays()
    arrays["wit_src"] = list(arrays["wit_src"])
    for w, src in edits.items():
        arrays["wit_src"][w] = src
    return TorchInterpreter(plan_from_arrays(arrays, "cpu"), prog.field)


def test_kw_hand_edited_wide_inputs_and_consts(kwhost):
    """Poseidon2/bn128 with wide input rows and constants among its bank
    rows: KW equals the parts route, in run's witness and run_mixed's
    wide rows."""
    spec = field_spec("bn128")
    cc = compile_source(generate((2,)) + "\ncomponent main = Poseidon2();\n")
    prog = WitnessProgram(cc.build_tape()[0], spec, device="cpu")
    consts = {2: 12345, 3: spec.p - 1, 5: 12345, 9: 0}
    interp = edited(prog, {1: ("input", 1), 4: ("input", 0), 7: ("input", 1),
                           **{w: ("const", v) for w, v in consts.items()}})
    kinds = interp._kw["full"][:, 0].tolist()
    assert {KW_BANK, KW_INPUT, KW_CONST} == set(kinds)
    rng = np.random.default_rng(17)
    cols = [[int(v) for v in rng.integers(0, 2 ** 62, size=3)]
            for _ in range(prog.n_inputs)]
    x = prog.encode_inputs(cols)
    inputs, x_w, _ = interp._inputs(x)
    bank, bank_n = interp_k1(interp.plan, interp.field, inputs)
    got = u32(host_kw(kwhost, interp, inputs, bank, bank_n))
    np.testing.assert_array_equal(
        got, u32(interp.assemble_parts(inputs, x_w, bank, bank_n)))
    np.testing.assert_array_equal(got[1], x[1])
    np.testing.assert_array_equal(got[4], x[0])
    for w, v in consts.items():
        assert [limbs_to_int(got[w, :, b]) for b in range(3)] == [v] * 3
    base = u32(prog.run(x))
    keep = [w for w in range(len(base)) if w not in (1, 2, 3, 4, 5, 7, 9)]
    np.testing.assert_array_equal(got[keep], base[keep])
    wide = host_kw(kwhost, interp, inputs, bank, bank_n, "wide")
    np.testing.assert_array_equal(u32(wide),
                                  u32(interp._wide_parts(bank, x_w, 3)))


def test_kw_hand_edited_narrow_inputs(kwhost):
    """The word circuit (goldilocks) with narrow input rows (their
    shift -1: the input's own limbs) and constants interleaved with its
    narrow emissions."""
    gspec = field_spec("goldilocks")
    pc = compile_source(WORD_SRC, prime="goldilocks")
    prog = WitnessProgram(pc.build_tape()[0], gspec, device="cpu",
                          input_ranges=pc.input_range_hints())
    interp = edited(prog, {4: ("input", 40), 6: ("const", 7),
                           8: ("input", 3), 11: ("const", gspec.p - 2)})
    plan = interp.plan
    tab = interp._kw["full"]
    assert {KW_NARROW, KW_INPUT, KW_CONST} <= set(tab[:, 0].tolist())
    assert (plan.nw_shift[plan.nw_src >= plan.n_bank_n_rows] == -1).all()
    rng = random.Random(5)
    for B in (1, 3, 5):
        cols = [[rng.randrange(2) for _ in range(B)]
                for _ in range(prog.n_inputs)]
        x = prog.encode_inputs(cols)
        got, want = banks_and_both(kwhost, interp, x)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[4], x[40])
        np.testing.assert_array_equal(got[8], x[3])
        assert [limbs_to_int(got[11, :, b]) for b in range(B)] == \
            [gspec.p - 2] * B
        base = u32(prog.run(x))
        keep = [w for w in range(len(base)) if w not in (4, 6, 8, 11)]
        np.testing.assert_array_equal(got[keep], base[keep])


# -- synthetic plans: random banks, every kind, edge values ------------------

def synthetic(spec, seed, K=6, KN=9, n_chunks=2, n_inputs=5, n_rows=60):
    """A plan without steps over (n_chunks * (K + 1))-row banks whose
    witness interleaves every wit_src kind: wide and narrow (raw and
    unpacked at SHIFTS and random shifts) emissions, wide and narrow
    inputs, constants; inputs 0-2 wide, 3-4 narrow."""
    L = spec.n_limbs
    rng = random.Random(seed)
    kinds = ["emit", "emitn", "emitb", "input_w", "input_n", "const"]
    wit_src = []
    for w in range(n_rows):
        k = kinds[w % len(kinds)] if w < 2 * len(kinds) else \
            rng.choice(kinds)
        c = rng.randrange(n_chunks)
        if k == "emit":
            wit_src.append(("emit", c, rng.randrange(K)))
        elif k == "emitn":
            wit_src.append(("emitn", c, rng.randrange(KN)))
        elif k == "emitb":
            s = SHIFTS[w % len(SHIFTS)] if w < 30 else rng.randrange(32)
            wit_src.append(("emitb", c, rng.randrange(KN), s))
        elif k == "input_w":
            wit_src.append(("input", rng.randrange(3)))
        elif k == "input_n":
            wit_src.append(("input", 3 + rng.randrange(n_inputs - 3)))
        else:
            wit_src.append(("const", rng.choice(
                [0, 1, spec.p - 1, spec.p // 2, rng.randrange(spec.p)])))
    arrays = {
        "table": np.zeros((1, 7), np.int32), "r_op": np.zeros(0, np.int32),
        "r_s0": np.zeros(1, np.int32),
        "rstarts": np.zeros(n_chunks + 1, np.int32),
        "cbank": np.zeros((1, L), np.int32),
        "mont_tab": np.zeros(n_chunks * (K + 1), np.int32),
        "mat_loads": [], "nmat_loads": [], "wit_src": wit_src,
        "win_of": {0: 0, 1: 1, 2: 2}, "nin_of": {3: 0, 4: 1}, "K": K,
        "KN": KN, "n_regs": 4, "n_nregs": 3, "n_chunks": n_chunks,
        "calls": [], "opset_n": [], "opset_w": []}
    return TorchInterpreter(plan_from_arrays(arrays, "cpu"),
                            TorchField(spec))


def synthetic_data(interp, B, seed):
    """(inputs, x_w, x_n, bank, bank_n): random 32-bit words in the wide
    bank and the inputs, the narrow edges and random values in the narrow
    bank (a different edge in lane 0 of each row, every edge in a row's
    first lanes where B allows)."""
    plan = interp.plan
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, size=(5, plan.L, B), dtype=np.uint32)
    inputs, x_w, x_n = interp._inputs(x)
    bank = torch.from_numpy(rng.integers(
        0, 1 << 32, size=(plan.n_bank_rows, plan.L, B),
        dtype=np.uint32).view(np.int32)).view(torch.uint32)
    v = rng.integers(-2 ** 31, 2 ** 31, size=(plan.n_bank_n_rows, B))
    for r in range(plan.n_bank_n_rows):
        for j in range(min(B, len(NARROW_EDGES))):
            v[r, j] = NARROW_EDGES[(r + j) % len(NARROW_EDGES)]
    bank_n = torch.from_numpy(v.astype(np.int32))
    return inputs, x_w, x_n, bank, bank_n


def jax_narrow_rows(plan, p, bank_n):
    """The JAX package's narrow witness rows: `_unpack_bits` of each
    narrow emission row, then `_widen_narrow` (n, L, B)."""
    em = plan.nw_src < plan.n_bank_n_rows
    rows = bank_n.numpy()[plan.nw_src[em]]
    bits = np.asarray(_unpack_bits(jnp.asarray(rows), plan.nw_shift[em]))
    fake = SimpleNamespace(L=plan.L, xt=SimpleNamespace(p=p))
    return plan.nw_idx[em], np.asarray(InterpreterProgram._widen_narrow(
        fake, jnp.asarray(bits)[:, None, :]))[:, :, 0, :], bits


@pytest.mark.parametrize("B", (1, 3, 4, 5))
@pytest.mark.parametrize("field", list(FIELDS))
def test_kw_synthetic_matches_parts_and_jax(kwhost, field, B):
    spec = FIELDS[field]
    interp = synthetic(spec, seed=B)
    data = synthetic_data(interp, B, seed=100 + B)
    inputs, x_w, _, bank, bank_n = data
    got = u32(host_kw(kwhost, interp, inputs, bank, bank_n))
    want = u32(interp.assemble_parts(inputs, x_w, bank, bank_n))
    np.testing.assert_array_equal(got, want)
    # the narrow rows: JAX's unpack and widening, and v mod p by hand
    pos, jax_rows, bits = jax_narrow_rows(interp.plan, spec.p, bank_n)
    np.testing.assert_array_equal(got[pos], jax_rows)
    for r, w in enumerate(pos):
        assert [limbs_to_int(got[w, :, b]) for b in range(B)] == \
            [int(v) % spec.p for v in bits[r]]
    # the wide rows of run_mixed
    wide = host_kw(kwhost, interp, inputs, bank, bank_n, "wide")
    np.testing.assert_array_equal(u32(wide),
                                  u32(interp._wide_parts(bank, x_w, B)))


def test_kw_widening_carries_into_the_last_limb(kwhost):
    """At p = 2^48 + 2^16 + 1 the widening of -1 carries from limb 0 to
    limb 3, and at goldilocks from limb 1 into limb 2: KW's limbs are
    p - 1's and those of v + p for the other edges."""
    for spec in (FIELDS["p49"], FIELDS["goldilocks"]):
        interp = synthetic(spec, seed=3)
        inputs, _x_w, _x_n, bank, bank_n = synthetic_data(interp, 5, 9)
        bank_n[:] = torch.tensor(NARROW_EDGES, dtype=torch.int32)
        got = u32(host_kw(kwhost, interp, inputs, bank, bank_n))
        plan = interp.plan
        raw = [w for w, s, sh in zip(plan.nw_idx, plan.nw_src,
                                     plan.nw_shift)
               if s < plan.n_bank_n_rows and sh < 0]
        assert raw
        for w in raw:
            assert [limbs_to_int(got[w, :, b]) for b in range(5)] == \
                [v % spec.p for v in NARROW_EDGES]
        if spec.p == P49:
            assert got[raw[0], :, 3].tolist() == [0, 1, 0, 1]


# -- KW's table --------------------------------------------------------------

def test_kw_table_kinds_and_sources():
    interp = synthetic(field_spec("bn128"), seed=1)
    plan, tab = interp.plan, kw_table(interp.plan)
    assert tab.dtype == np.int32 and tab.shape == (plan.n_witness, 4)
    for w, src in enumerate(plan_wit_src(plan)):
        kind, s, shift, zero = tab[w].tolist()
        assert zero == 0
        if src[0] == "emit":
            assert (kind, s) == (KW_BANK, src[1] * (plan.K + 1) + src[2])
        elif src[0] in ("emitn", "emitb"):
            assert (kind, s) == (KW_NARROW, src[1] * (plan.KN + 1) + src[2])
            assert shift == (src[3] if src[0] == "emitb" else -1)
        elif src[0] == "input":
            assert (kind, s, shift) == (KW_INPUT, src[1], 0)
        else:
            assert kind == KW_CONST
            assert limbs_to_int(plan.consts[s]) == src[1]


def plan_wit_src(plan):
    """wit_src back from a plan's split (synthetic plans: one chunk row
    per emission)."""
    out = [None] * plan.n_witness
    nin = {plan.n_bank_n_rows + k: i for k, i in enumerate(plan.nin_order)}
    win = {plan.n_bank_rows + k: i for k, i in enumerate(plan.win_order)}
    c0 = plan.n_bank_rows + max(len(plan.win_order), 1)
    for w, s, sh in zip(plan.nw_idx, plan.nw_src, plan.nw_shift):
        if s in nin:
            out[w] = ("input", nin[s])
        else:
            c, em = divmod(int(s), plan.KN + 1)
            out[w] = ("emitb", c, em, sh) if sh >= 0 else ("emitn", c, em)
    for w, s in zip(plan.wd_idx, plan.wd_src):
        if s < plan.n_bank_rows:
            out[w] = ("emit", *divmod(int(s), plan.K + 1))
        elif s in win:
            out[w] = ("input", win[s])
        else:
            out[w] = ("const", limbs_to_int(plan.consts[s - c0]))
    return out


def test_kw_table_refuses_rows_written_twice_or_never():
    plan = synthetic(field_spec("bn128"), seed=2).plan
    kw_table(plan)
    nw = plan.nw_idx.copy()
    nw[1] = nw[0]
    with pytest.raises(ValueError, match="witness row other than once"):
        kw_table(dataclasses.replace(plan, nw_idx=nw))
    wd = plan.wd_idx.copy()
    wd[0] = plan.n_witness
    with pytest.raises(ValueError, match="witness row other than once"):
        kw_table(dataclasses.replace(plan, wd_idx=wd))


@pytest.mark.parametrize("edit", ["wide_past_consts", "wide_negative",
                                  "empty_input_slot", "narrow_past_inputs",
                                  "narrow_negative"])
def test_kw_table_refuses_sources_out_of_range(edit):
    plan = synthetic(field_spec("bn128"), seed=4).plan
    wd, nw = plan.wd_src.copy(), plan.nw_src.copy()
    n_wide = plan.n_bank_rows + len(plan.win_order) + len(plan.consts)
    change = {}
    if edit == "wide_past_consts":
        wd[0] = n_wide
        change["wd_src"] = wd
    elif edit == "wide_negative":
        wd[0] = -1
        change["wd_src"] = wd
    elif edit == "empty_input_slot":
        # no wide inputs: wd_src's input slot is a row of zeros no plan
        # names
        wd = np.where(wd >= plan.n_bank_rows, 0, wd).astype(np.int32)
        wd[0] = plan.n_bank_rows
        change = {"wd_src": wd, "win_order": [], "consts": plan.consts[:0]}
    elif edit == "narrow_past_inputs":
        nw[0] = plan.n_bank_n_rows + len(plan.nin_order)
        change["nw_src"] = nw
    else:
        nw[0] = -1
        change["nw_src"] = nw
    with pytest.raises(ValueError, match="outside its tensor"):
        kw_table(dataclasses.replace(plan, **change))


def test_kw_refuses_too_few_inputs():
    interp = synthetic(field_spec("goldilocks"), seed=5)
    assert interp._kw_inputs == {"full": 5, "wide": 3}
    _i, _w, _n, bank, bank_n = synthetic_data(interp, 2, 1)
    with pytest.raises(ValueError, match="reads 5 input rows"):
        interp.assemble_kw(torch.zeros((4, 4, 2), dtype=torch.uint32), bank,
                           bank_n)


def test_kw_bytes_by_hand():
    """kw_bytes on a synthetic plan: the witness written, each distinct
    (kind, source) row read once, counted here from wit_src."""
    spec = field_spec("bn128")
    interp = synthetic(spec, seed=6)
    plan, L, B = interp.plan, spec.n_limbs, 7
    srcs = {s[:3] if s[0] == "emitb" else s for s in plan_wit_src(plan)}
    srcs = {("emitn",) + s[1:] if s[0] == "emitb" else s for s in srcs}
    lane = {"emit": L, "input": L, "emitn": 1, "const": 0}
    want = 4 * B * (L * plan.n_witness + sum(lane[s[0]] for s in srcs)) \
        + 4 * L * sum(1 for s in srcs if s[0] == "const")
    assert kw_bytes(plan, B) == want


# -- the gathers of the same source, K2 and K3, built by g++ -----------------

@pytest.mark.parametrize("B", (3, 8))
def test_host_k2_k3_match_plain(kwhost, B):
    rng = np.random.default_rng(B)
    bank = torch.from_numpy(rng.integers(0, 1 << 32, size=(9, 4, B),
                                         dtype=np.uint32).view(np.int32))
    idx = torch.from_numpy(rng.integers(0, 9, size=13).astype(np.int32))
    out = torch.empty((13, 4, B), dtype=torch.int32)
    assert kwhost.ctpu_gather_rows(bank.data_ptr(), idx.data_ptr(),
                                   out.data_ptr(), 4 * B, 13, None) == 0
    np.testing.assert_array_equal(out.numpy(),
                                  gather_rows(bank, idx).numpy())
    bank_n = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, size=(6, B))
                              .astype(np.int32))
    # the narrow inputs: limbs 0 and 1 of input rows 3 and 1 of five
    inputs = torch.from_numpy(rng.integers(0, 1 << 16, size=(5, 4, B),
                                           dtype=np.uint32).view(np.int32))
    inputs = inputs.view(torch.uint32)
    order = torch.tensor([3, 1], dtype=torch.int32)
    src = torch.from_numpy(rng.integers(0, 8, size=10).astype(np.int32))
    shift = torch.tensor(SHIFTS * 2, dtype=torch.int32)
    out_n = torch.empty((10, B), dtype=torch.int32)
    assert kwhost.ctpu_gather_n(bank_n.data_ptr(), 6, inputs.data_ptr(), 4,
                                order.data_ptr(), src.data_ptr(),
                                shift.data_ptr(), out_n.data_ptr(), 10, B,
                                None) == 0
    x_n = narrow_inputs(inputs, order)
    np.testing.assert_array_equal(
        out_n.numpy(), gather_n_rows(bank_n, x_n, src, shift).numpy())


# -- no fallback on another device --------------------------------------------

@pytest.fixture()
def meta_launches(monkeypatch):
    """Runs on "meta": K1 replaced by empty banks, every launch recorded
    by name (no kernel runs), the parts route refused."""
    names = []

    def k1(plan, field, inputs):
        B = inputs.shape[-1]
        return (torch.empty((plan.n_bank_rows, plan.L, B),
                            dtype=torch.uint32, device="meta"),
                torch.empty((plan.n_bank_n_rows, B), dtype=torch.int32,
                            device="meta"))

    def parts(*a, **k):
        raise AssertionError("the parts route ran")

    monkeypatch.setattr(interp_mod, "interp_k1", k1)
    monkeypatch.setattr(interp_mod, "stream_ptr", lambda dev: None)
    monkeypatch.setattr(interp_mod, "library", lambda name: SimpleNamespace(
        ctpu_assemble=None, ctpu_gather_rows=None, ctpu_gather_n=None))
    monkeypatch.setattr(interp_mod, "launch",
                        lambda name, fn, dev, *a, **k: names.append(name))
    monkeypatch.setattr(TorchInterpreter, "assemble_parts", parts)
    monkeypatch.setattr(TorchInterpreter, "_wide_parts", parts)
    return names


def test_kw_launches_on_another_device(meta_launches):
    """A run of a plan of several parts is K1 and one KW launch; a
    witness of the wide bank's rows alone (Poseidon2) is K2's gather; a
    mixed run whose wide rows name an input is KW."""
    spec = field_spec("bn128")
    cc = compile_source(comparators_source())
    prog = WitnessProgram(cc.build_tape()[0], spec, device="cpu",
                          input_ranges=cc.input_range_hints())
    twin = prog.for_device("meta")
    x = torch.zeros((prog.n_inputs, 16, 3), dtype=torch.uint32)
    w = twin.run(x)
    assert w.device.type == "meta" and tuple(w.shape) == \
        (prog.n_witness, 16, 3)
    assert meta_launches == ["assemble"]
    meta_launches.clear()
    pc = compile_source(generate((2,)) + "\ncomponent main = Poseidon2();\n")
    pos = WitnessProgram(pc.build_tape()[0], spec, device="cpu")
    pos.for_device("meta").run(torch.zeros((2, 16, 3), dtype=torch.uint32))
    assert meta_launches == ["gather_w"]
    meta_launches.clear()
    interp = edited(pos, {1: ("input", 1)})
    twin = TorchInterpreter(interp.plan.to("meta"),
                            TorchField(spec, "meta"))
    twin._run_mixed(torch.zeros((2, 16, 3), dtype=torch.uint32))
    assert meta_launches == ["assemble"]


def test_kw_never_falls_back(monkeypatch):
    """A library that fails to build raises: the run does not take the
    parts route."""
    cc = compile_source(merkle_source(4))
    prog = WitnessProgram(cc.build_tape()[0], field_spec("bn128"),
                          device="cpu", input_ranges=cc.input_range_hints())
    twin = prog.for_device("meta")

    def no_library(name):
        raise RuntimeError(f"nvcc failed on {name}.cu")

    def parts(*a, **k):
        raise AssertionError("the parts route ran")

    def k1(plan, field, inputs):
        B = inputs.shape[-1]
        return (torch.empty((plan.n_bank_rows, plan.L, B),
                            dtype=torch.uint32, device="meta"),
                torch.empty((plan.n_bank_n_rows, B), dtype=torch.int32,
                            device="meta"))

    monkeypatch.setattr(interp_mod, "library", no_library)
    monkeypatch.setattr(interp_mod, "interp_k1", k1)
    monkeypatch.setattr(TorchInterpreter, "assemble_parts", parts)
    x = torch.zeros((prog.n_inputs, 16, 2), dtype=torch.uint32)
    with pytest.raises(RuntimeError, match="nvcc failed on gather.cu"):
        twin.run(x)
