"""Time K1, K2, K5, KC, KS and K4 against the same kernels built from
another checkout.

    python -m circom_tpu_torch.kernel_ab --other DIR [--reps N]
        [--kernels k1,k2,k5,kc,ks,k4]

DIR is the root of another checkout of this repository, for example an
earlier commit unpacked with `git archive`.  Its
circom_tpu_torch/ops/cuda sources of the kernels --kernels asks for are
built beside this checkout's, with the same nvcc flags, all at once
(interp.cu alone takes about a minute of nvcc), and each library's entry
point is called through ctypes.  K2's and K5's entry points have the same
interface in both (the 32-bit K5's, with n0inv32).  The other K1's
interface is read off its interp.cu: where its entry point takes the
constant bank in limbs beside the words (`cbank`, the K1 whose wide file
was 16-bit limbs for K1c and K1d),

    ctpu_interp_k1(L, B, x_w, n_win, x_n, n_nin, table, grp, r_op, r_s0,
                   rstarts, n_chunks, cbank, cbank_w, mont_tab, mat_regs,
                   mat_limbs, n_mat, nmat_vals, nmat_regs, n_nmat, rf,
                   bank, K, rf_n, bank_n, KN, p_limbs, r2_limbs, n0inv32,
                   half_limbs, mask_limbs, q_limbs, bits, full, stream)

with rf (n_regs, L, B), it gets those 36 arguments; otherwise this
checkout's 35 (k1_args, the word file of k1_file_shape).  Both versions
run on the same inputs, must agree bit for bit, and are timed by CUDA
events around their bare launches (no checks, outputs allocated before),
in turns: other, this, this, other.

- K1 on five plans, every emitted row of both banks compared, with the
  32-bit products a lane of each: Poseidon2/bn128 (P, K1a) and
  SHA256/bn128 (M, K1b) at batch 65,536, Poseidon2/goldilocks (G, K1c)
  at 65,536 and at 16,384 (a quarter of the lanes: a time that hardly
  moves says each lane's chain of dependent steps, not the card's
  throughput, bounds K1), the stdlib comparators/bn128 (C, K1d) at
  65,536, bigint-div/bn128 (D, K1d's long division) at 8,192.
- K2 at Poseidon2/bn128's plan shape (the plan's wd_src over a random
  bank of (n_bank_rows, 16, 65,536)), beside `index_select` of the same
  rows into the same output.
- K5 at every shape that the R1CS check's plain route gives a Montgomery
  product, for Poseidon2/bn128 (P) at batch 65,536 and the SHA256 block
  over bn128 (F) at 8,192: the shapes K5 had on the check before kernel
  KC took the check over, recorded from the plain route itself, each
  distinct one timed on random canonical operands, and the K5 time of
  such a check is the sum over its products.
- KC (check.cu) on the R1CS check of Poseidon2/bn128 (P) at batch 65,536
  and of the full-limb SHA256 block over bn128 (F) at 8,192, each in one
  launch over the whole batch, lanes corrupted at different wires.  The
  other checkout's KC is taken to have the interface of the KC that ran
  a CIOS a nonzero over CSR columns with coefficients coeff·R^2 mod p in
  L/2 words (rebuilt here from the same rows, as its checker built
  them):

    ctpu_r1cs_check(L, z, b, a_ptr, a_col, a_coef, b_ptr, b_col, b_coef,
                    c_ptr, c_col, c_coef, n_rows, rows_per_chunk, p_limbs,
                    n0inv32, first, stream)

  Where the other check.cu takes this checkout's entry streams instead
  (its entry point names a_ent: a variant of this KC), it gets the same
  arguments as this one.  This checkout's KC runs through its checker's
  own arguments (kc_args).  The first violated rows of both must be
  identical.
- KS (scan.cu) on 16 x Num2Bits(254)/bn128 at batch 8,192 (Q) and
  65,536 (QS8, QS64: the scan's schedule at 8 and 64 slots), and on
  bigint-div + Num2Bits(254)/bn128 at 8,192 (O), this checkout's at
  every width of KS_WIDTHS over its own tables (backend/ks.py).  The
  other scan.cu is taken to have the interface of the KS whose register
  file was all in device memory, over the JAX schedule's tables (rebuilt
  here by a frozen copy of that KS's `ks_tables`, `old_ks_tables`):

    ctpu_scan(L, off, ent, n_steps, consts, x, rf, out, b, limbs,
              n0inv32, bits, warps, stream)

  with rf (n_regs, L/2, b), timed at 8 warps a block (its kept layout)
  and 1; where the other scan.cu takes `n_smem` (a variant of this KS),
  it gets this checkout's tables and arguments.  Every launch's witness
  equals this checkout's run, which equals the step loop's (Q, QS) or
  the per-node path's (O).
- K4 (generated per program) on the segmented paths Num2Bits(254)/bn128
  (S) and 4 x Num2Bits(254)/bn128 (S4) at batch 65,536: each checkout's
  own generator writes its source (a child process with only that
  checkout on its path), and nvcc builds a library a segment of both at
  once.  The other K4's interface is read off its source: the stacked
  one, `ctpu_k4_seg<s>(xin, xout, B, stream)` with xin (n_in, L, B) and
  xout (n_out, L, B), which runs the route it had (a frozen copy:
  `stacked_run`, each segment's inputs and then the witness assembled by
  torch.stack), or this checkout's in place,
  `ctpu_k4_seg<s>(x, w, c, B, stream)` over the inputs, the witness and
  the crossing buffer, which runs this checkout's route (a variant of
  this K4).  Both runs' witnesses must be equal bit for bit; the bare K4
  launches (all segments, buffers allocated before) and the whole runs
  are timed in turns, and each run's peak allocation read.

Prints a line for each measurement, the card's name and power limit, and
a JSON object as the last line.  Exits 1 without a card.
"""

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import numpy as np

from .backend.checker import (R1CSChecker, kc_args, kc_products,
                              kc_rows_per_chunk)
from .backend.interp import k1_args, k1_file_shape
from .backend.ks import KS_OPS, KS_WIDTHS, const_words, ks_args
from .backend.torch_backend import WitnessProgram
from .circuits import sha256_io
from .circuits.gen_poseidon import generate
from .circuits.sources import (BIGINT_DIV_SRC, bigdiv_num2bits_source,
                               comparator_inputs, comparators_source,
                               num2bits_source, poseidon2_source)
from .backend.interp_plan import _NARROW_RESULT, _OPERAND_FILES
from .convert import N_OPERANDS, OPCODES, to_device
from .compiler.pipeline import compile_source
from .field.primes import LIMB_BITS, field_spec
from .ops import build
from .ops.field import TorchField
from .ops.limbs import int_to_limbs, ints_to_limbs

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("interp", "gather", "field_ops")
_P, _I, _LL, _U32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                     ctypes.c_uint32)
_PU32 = ctypes.POINTER(ctypes.c_uint32)
# the other checkout's entry points where they differ from this one's:
# K1's with the constant bank in limbs, the CSR KC's, the KS over a
# register file in device memory
OTHER_SIGNATURES = dict(build.SIGNATURES, interp={"ctpu_interp_k1": (
    _I, [_I, _LL, _P, _I, _P, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P,
         _P, _I, _P, _P, _I, _P, _P, _I, _P, _P, _I, _PU32, _PU32, _U32,
         _PU32, _PU32, _PU32, _I, _I, _P])}, check={"ctpu_r1cs_check": (
             _I, [_I, _P, _LL, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL,
                  _LL, _PU32, _U32, _P, _P])}, scan={"ctpu_scan": (
                      _I, [_I, _P, _P, _I, _P, _P, _P, _P, _LL, _PU32, _U32,
                           _I, _I, _P])})


def _source(root, name):
    return (Path(root) / "circom_tpu_torch" / "ops" / "cuda"
            / f"{name}.cu").read_text()


def streams_kc(root):
    """Whether the check.cu of the checkout at `root` takes KC's entry
    streams (this checkout's interface), not CSR columns."""
    return "a_ent" in _source(root, "check")


def limbs_k1(root):
    """Whether the K1 of the checkout at `root` takes the constant bank in
    limbs beside the words (36 arguments), not this checkout's 35."""
    head = _source(root, "interp").split('extern "C" int ctpu_interp_k1')[1]
    return "cbank," in head.split("{")[0]


def shared_ks(root):
    """Whether the KS of the checkout at `root` takes this checkout's
    tables and interface (`n_smem`), not the device-memory file's."""
    return "n_smem" in _source(root, "scan")


# which other interfaces are this checkout's own
SAME_INTERFACE = {"check": streams_kc, "interp": lambda r: not limbs_k1(r),
                  "scan": shared_ks}


def build_libraries(other, names=NAMES):
    """{(tag, name): ctypes library}: "this" and "other" for each of
    `names`, one nvcc each, all at once, into ab/ of the build directory
    (utils/cache.py).  Prints each build's ptxas usage and wall time."""
    out_dir = build.build_dir() / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build.nvcc_path()
    todo = [(tag, root, name)
            for tag, root in (("this", ROOT), ("other", Path(other).resolve()))
            for name in names]

    def one(job):
        tag, root, name = job
        src_dir = root / "circom_tpu_torch" / "ops" / "cuda"
        so = out_dir / f"{tag}-{name}.so"
        t0 = time.perf_counter()
        r = subprocess.run(
            [nvcc, *build.NVCC_FLAGS, *build.source_flags(name), "-I",
             str(src_dir), "-o", str(so), str(src_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return so, r, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(todo)) as pool:
        done = list(pool.map(one, todo))
    libs = {}
    for (tag, root, name), (so, r, seconds) in zip(todo, done):
        if r.returncode:
            raise SystemExit(f"nvcc failed on the {tag} {name}.cu:\n"
                             f"{r.stdout}")
        print(f"  nvcc {tag} {name}.cu: {seconds:.1f} s")
        for line in r.stdout.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {tag} {name}: {line.strip()}")
        lib = ctypes.CDLL(str(so))
        same = SAME_INTERFACE.get(name, lambda r: True)
        sigs = (OTHER_SIGNATURES if tag == "other" and not same(root)
                else build.SIGNATURES)[name]
        for fn, (res, args) in sigs.items():
            getattr(lib, fn).restype = res
            getattr(lib, fn).argtypes = args
        libs[tag, name] = lib
    return libs


def time_ms(fn, reps):
    """Mean ms of fn() by CUDA events, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(fns, reps):
    """{name: [ms, ms]} of each fn, timed in the order given and then in
    the reverse order."""
    got = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        got[k].append(time_ms(fns[k], reps))
    return got


def checked(rc, what):
    if rc:
        raise SystemExit(f"{what}: CUDA launch failed (cudaError {rc})")


def canonical(gen, spec, shape, dev):
    """Random canonical field elements as uint32 limbs (..., L, B)."""
    x = torch.randint(0, 1 << LIMB_BITS, shape, generator=gen, device=dev,
                      dtype=torch.int32)
    top = spec.p >> (LIMB_BITS * (spec.n_limbs - 1))
    x[..., -1, :] %= top
    return x.view(torch.uint32)


def k1_products32(plan):
    """32x32->64-bit products a lane of the 32-bit K1: 2 N^2 a Montgomery
    product (mul, mul_r2, mul_c, mul_one), (n + 1) N^2 a dot of n terms,
    N^2 a goldilocks product (one 64x64-bit product) and a trailing REDC,
    N = L/2."""
    n2 = (plan.L // 2) ** 2
    per = {"mul": 2, "mul_r2": 2, "mul_c": 2, "mul_one": 2, "dot2_c": 3,
           "dot3_c": 4, "gmul": 1, "gmul_c": 1}
    steps = plan.table[:plan.n_steps, 0].tolist()
    emitted = plan.emitted_rows()
    return n2 * (sum(per.get(OPCODES[k], 0) for k in steps)
                 + int(plan.mont_tab[emitted].sum()))


def k1_file_bytes(plan, words):
    """Bytes of wide register-file traffic a lane of K1, counted from the
    plan with `words` 32-bit words a register (L/2 for the word file, L
    for a file of 16-bit limbs): each wide register operand read and each
    wide result written once; a shift reads two words an output word,
    select its test and the register it picks, nband_w one word (two
    limbs), the long division its divisor and one word a bit of p (16L
    bits counted)."""
    reads = writes = 0
    for k in plan.table[:plan.n_steps, 0].tolist():
        op = OPCODES[k]
        files = _OPERAND_FILES.get(op, "www")[:N_OPERANDS[op]]
        if op in ("shl_kw", "shr_kw", "select"):
            reads += 2 * words
        elif op == "nband_w":
            reads += 1 if words == plan.L // 2 else 2
        elif op == "idiv":
            reads += words + 16 * plan.L
        else:
            reads += words * files.count("w")
        writes += 0 if op in _NARROW_RESULT else words
    return 4 * (reads + writes)


# K1's plans and batches
K1_CASES = (("P", 65536), ("M", 65536), ("G", 65536), ("G", 16384),
            ("C", 65536), ("D", 8192))


def k1_case(name, dev, B):
    """(plan, field, wide inputs, narrow inputs) of K1_CASES' plan `name`
    at batch B."""
    prime = "goldilocks" if name == "G" else "bn128"
    spec = field_spec(prime)
    gen = torch.Generator(device=dev).manual_seed(13)
    if name == "M":
        cc = compile_source(
            (ROOT / "circom_tpu_torch/circuits/sha256.circom").read_text()
            + "\ncomponent main = Sha256Block();\n")
    else:
        cc = compile_source({"P": poseidon2_source(), "G": poseidon2_source(
            "goldilocks"), "C": comparators_source(),
            "D": BIGINT_DIV_SRC}[name], prime=prime)
    prog = WitnessProgram(cc.build_tape()[0], spec, device=dev,
                          input_ranges=cc.input_range_hints())
    if name == "M":
        rng = np.random.default_rng(14)
        msgs = [bytes(m) for m in rng.integers(0, 256, size=(B, 32),
                                               dtype=np.uint8)]
        x = to_device(sha256_io.input_rows(msgs), dev)
    elif name == "C":
        x = to_device(comparator_inputs(B, 15, spec.n_limbs), dev)
    else:
        x = canonical(gen, spec, (prog.n_inputs, spec.n_limbs, B), dev)
        if name == "D":
            x.view(torch.int32)[1, 0] |= 1     # a nonzero divisor
    _, x_w, x_n = prog.interp._inputs(x)
    return prog.interp.plan, prog.field, x_w.contiguous(), x_n.contiguous()


def other_k1_args(plan, field, x_w, x_n, rf, bank, rf_n, bank_n, stream):
    """The other K1's arguments (see the module's docstring); the constant
    bank in limbs is kept on the plan beside its other device tables."""
    d = plan.dev
    d.setdefault("cbank", to_device(plan.cbank, x_w.device))
    return (
        plan.L, x_w.shape[-1], x_w.data_ptr(), x_w.shape[0], x_n.data_ptr(),
        x_n.shape[0], d["table"].data_ptr(), d["grp"].data_ptr(),
        d["r_op"].data_ptr(), d["r_s0"].data_ptr(),
        d["rstarts"].data_ptr(), plan.n_chunks, d["cbank"].data_ptr(),
        d["cbank_w"].data_ptr(), d["mont_tab"].data_ptr(),
        d["mat_regs"].data_ptr(), d["mat_limbs"].data_ptr(),
        len(plan.mat_regs), d["nmat_vals"].data_ptr(),
        d["nmat_regs"].data_ptr(), len(plan.nmat_regs), rf.data_ptr(),
        bank.data_ptr(), plan.K, rf_n.data_ptr(), bank_n.data_ptr(), plan.KN,
        build.u32_array(field.p_list), build.u32_array(field.r2_list),
        field.n0inv32, build.u32_array(field.half_list),
        build.u32_array(field.mask_list), build.u32_array(field.q_list),
        field.p.bit_length(),
        int(bool({"interp_k1c", "interp_k1d"} & set(plan.parts))), stream)


def k1(libs, name, B, dev, reps, limbs):
    """K1 on plan `name` at batch B, this checkout's and the other's (with
    `limbs`, the interface that takes the constant bank in limbs), every
    emitted row compared, then timed in turns."""
    plan, field, x_w, x_n = k1_case(name, dev, B)
    stream = torch.cuda.current_stream(dev).cuda_stream
    outs, fns = {}, {}
    other = ((other_k1_args, (plan.n_regs, plan.L, B)) if limbs
             else (k1_args, k1_file_shape(plan, B)))
    for tag, make_args, rf_shape in (
            ("other", *other), ("this", k1_args, k1_file_shape(plan, B))):
        o = outs[tag] = {
            "rf": torch.empty(rf_shape, dtype=torch.uint32, device=dev),
            "bank": torch.empty((plan.n_bank_rows, plan.L, B),
                                dtype=torch.uint32, device=dev),
            "rf_n": torch.empty((plan.n_nregs, B), dtype=torch.int32,
                                device=dev),
            "bank_n": torch.empty((plan.n_bank_n_rows, B), dtype=torch.int32,
                                  device=dev)}
        args = make_args(plan, field, x_w, x_n, o["rf"], o["bank"], o["rf_n"],
                         o["bank_n"], stream)
        fns[tag] = (lambda lib=libs[tag, "interp"], args=args, tag=tag:
                    checked(lib.ctpu_interp_k1(*args), f"{tag} K1"))
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    rows = torch.as_tensor(plan.emitted_rows(), device=dev)
    rows_n = torch.as_tensor(plan.emitted_rows(narrow=True), device=dev)
    got, other = outs["this"], outs["other"]
    if not (torch.equal(got["bank"].view(torch.int32)[rows],
                        other["bank"].view(torch.int32)[rows])
            and torch.equal(got["bank_n"][rows_n], other["bank_n"][rows_n])):
        raise SystemExit(f"K1 {name}: this differs from other")
    ms = in_turns(fns, reps)
    products = k1_products32(plan)
    for tag, v in ms.items():
        print(f"  K1 {name} at {B} ({plan.n_steps} steps, parts "
              f"{', '.join(plan.parts)}) {tag}: {v[0]:.4f}, {v[1]:.4f} ms")
    traffic = k1_file_bytes(plan, plan.L // 2)
    print(f"  K1 {name}: {len(rows)} wide and {len(rows_n)} narrow emitted "
          f"rows bit-exact at batch {B}; {products} 32-bit products a lane; "
          f"wide file {plan.n_regs} registers, {traffic} bytes of its "
          f"traffic a lane ({traffic * B / 1e9:.2f} GB a launch; "
          f"{k1_file_bytes(plan, plan.L) * B / 1e9:.2f} GB as 16-bit limbs)")
    return {"plan": name, "steps": plan.n_steps, "batch": B,
            "n_regs": plan.n_regs, "file_bytes_per_lane": traffic,
            "emitted_rows": [len(rows), len(rows_n)],
            "products32_per_lane": products, "ms": ms}


def k2(libs, dev, reps):
    spec = field_spec("bn128")
    cc = compile_source(generate((2,)) + "\ncomponent main = Poseidon2();\n")
    plan = WitnessProgram(cc.build_tape()[0], spec, device=dev).interp.plan
    B, L = 65536, plan.L
    gen = torch.Generator(device=dev).manual_seed(11)
    bank = torch.randint(0, 1 << LIMB_BITS, (plan.n_bank_rows, L, B),
                         generator=gen, device=dev,
                         dtype=torch.int32).view(torch.uint32)
    idx = plan.dev["wd_src"]
    W = idx.shape[0]
    outs = {k: torch.empty((W, L, B), dtype=torch.uint32, device=dev)
            for k in ("other", "this", "index_select")}
    stream = torch.cuda.current_stream(dev).cuda_stream
    row = L * B
    idx_l = idx.to(torch.int64)
    def launch(tag):
        return lambda: checked(libs[tag, "gather"].ctpu_gather_rows(
            bank.data_ptr(), idx.data_ptr(), outs[tag].data_ptr(), row, W,
            stream), f"{tag} K2")

    fns = {"other": launch("other"), "this": launch("this"),
           "index_select": lambda: torch.index_select(
               bank.view(torch.int32), 0, idx_l,
               out=outs["index_select"].view(torch.int32))}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    for k in ("this", "index_select"):
        if not torch.equal(outs[k].view(torch.int32),
                           outs["other"].view(torch.int32)):
            raise SystemExit(f"K2: {k} differs from the other checkout's")
    ms = in_turns(fns, reps)
    nbytes = 2 * 4 * W * row
    for k, v in ms.items():
        print(f"  K2 {k}: {v[0]:.4f}, {v[1]:.4f} ms "
              f"({nbytes / (sum(v) / 2) / 1e6:.0f} GB/s)")
    return {"shape": [W, plan.n_bank_rows, L, B], "bytes": nbytes, "ms": ms}


def k5_launches(rows, n_wires, spec, dev, B):
    """Counter of (a shape, a strides, b strides) over the Montgomery
    products of the R1CS check's plain route (first_violated_plain) on a
    batch of B, each as K5 would be launched on it (the operands broadcast
    and reshaped to (N, L, B) as field_kernels does): recorded, not
    computed, since the shapes do not depend on the values."""
    seen = Counter()
    checker = R1CSChecker(rows, n_wires, spec, device=dev)
    field = checker.field

    def record(a, b):
        shape = torch.broadcast_shapes(a.shape, b.shape)
        N, L, Bs = int(np.prod(shape[:-2])), shape[-2], shape[-1]
        a3, b3 = (t.broadcast_to(shape).reshape(N, L, Bs) for t in (a, b))
        seen[(N, L, Bs), a3.stride(), b3.stride()] += 1
        return torch.zeros(shape, dtype=torch.uint32, device=a.device)

    field.mont_mul = record
    field.to_mont = lambda a: record(a, checker.R2)
    z = torch.zeros((n_wires, spec.n_limbs, 1), dtype=torch.uint32,
                    device=dev).expand(-1, -1, B)
    for zs in checker._slices(z):
        checker.first_violated_plain(zs)
    return seen


def k5(libs, name, rows, n_wires, B, dev, reps):
    spec = field_spec("bn128")
    field = TorchField(spec, dev)
    seen = k5_launches(rows, n_wires, spec, dev, B)
    gen = torch.Generator(device=dev).manual_seed(12)
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = build.u32_array(field.p_list)
    total = {"other": 0.0, "this": 0.0}
    shapes = []
    for (shape, sa, sb), count in sorted(seen.items()):
        def operand(strides):
            base = [1 if st == 0 else n for n, st in zip(shape, strides)]
            return canonical(gen, spec, base, dev).expand(shape)
        a, b = operand(sa), operand(sb)
        assert a.stride() == sa and b.stride() == sb, (a.stride(), sa)
        N, L, Bs = shape
        outs = {k: torch.empty(shape, dtype=torch.uint32, device=dev)
                for k in total}
        args = (0, L, a.data_ptr(), build.ll_array(sa), b.data_ptr(),
                build.ll_array(sb))
        fns = {tag: (lambda tag=tag: checked(
            libs[tag, "field_ops"].ctpu_field_elementwise(
                *args, outs[tag].data_ptr(), N, Bs, p, field.n0inv,
                field.n0inv32, stream), f"{tag} K5")) for tag in total}
        ms = in_turns(fns, reps)
        if not torch.equal(outs["this"].view(torch.int32),
                           outs["other"].view(torch.int32)):
            raise SystemExit(f"K5 {name} {shape}: the two versions differ")
        for k in total:
            total[k] += count * sum(ms[k]) / 2
        print(f"  K5 {name} {shape} x{count}, b strides {sb}: other "
              f"{ms['other'][0]:.4f}, {ms['other'][1]:.4f} ms; this "
              f"{ms['this'][0]:.4f}, {ms['this'][1]:.4f} ms")
        shapes.append({"shape": list(shape), "b_strides": list(sb),
                       "launches": count, "ms": ms})
        del a, b, outs
    print(f"  K5 over {name}'s check ({sum(seen.values())} launches): "
          f"other {total['other']:.3f} ms, this {total['this']:.3f} ms")
    return {"launches": sum(seen.values()), "total_ms": total,
            "shapes": shapes}


def csr_matrices(rows, spec, dev):
    """The CSR KC's matrices of `rows`, as its checker built them: a (ptr
    int32 (n_rows + 1), col int32 (nnz), coeff·R^2 mod p uint32 (nnz, L/2))
    triple a matrix, each row's nonzeros by column."""
    L, p = spec.n_limbs, spec.p
    R = 1 << (LIMB_BITS * L)
    out = []
    for mi in range(3):
        rws, cols, coefs = [], [], []
        for ri, row in enumerate(rows):
            for col, coef in sorted(row[mi].items()):
                rws.append(ri)
                cols.append(col)
                coefs.append(coef * R % p * R % p)
        ptr = np.zeros(len(rows) + 1, np.int32)
        np.cumsum(np.bincount(np.asarray(rws, np.int64),
                              minlength=len(rows)), out=ptr[1:])
        limbs = ints_to_limbs(coefs, L).reshape(-1, L)
        words = limbs[:, 0::2] | (limbs[:, 1::2] << 16)
        out.append(tuple(to_device(a, dev) for a in (
            ptr, np.asarray(cols, np.int32), np.ascontiguousarray(words))))
    return out


def kc_case(name, dev, B):
    """(rows, spec, witness with lanes corrupted) of KC's case `name`: P,
    Poseidon2/bn128, or F, the full-limb SHA256 block over bn128."""
    spec = field_spec("bn128")
    if name == "P":
        cc = compile_source(poseidon2_source())
        prog = WitnessProgram(cc.build_tape()[0], spec, device=dev)
        gen = torch.Generator(device=dev).manual_seed(16)
        x = canonical(gen, spec, (prog.n_inputs, spec.n_limbs, B), dev)
        corrupt = ((3, 2), (40, 3), (150, 4), (322, 5), (100, B - 1))
    else:
        cc = compile_source(
            (ROOT / "circom_tpu_torch/circuits/sha256.circom").read_text()
            + "\ncomponent main = Sha256Block();\n")
        prog = WitnessProgram(cc.build_tape()[0], spec, device=dev,
                              input_ranges=cc.input_range_hints())
        rng = np.random.default_rng(17)
        msgs = [bytes(m) for m in rng.integers(0, 256, size=(B, 32),
                                               dtype=np.uint8)]
        x = np.zeros((512, spec.n_limbs, B), np.uint32)
        x[:, 0, :] = sha256_io.msgs_to_bits_batch(msgs)
        x = to_device(x, dev)
        corrupt = ((600, 1), (5000, B // 2), (20000, B - 1), (27000, 7))
    wit = prog.run(x)
    for wire, lane in corrupt:
        wit.view(torch.int32)[wire, 0, lane] ^= 1
    return cc.r1cs_rows(), cc.counts()["n_wires"], spec, wit


def kc(libs, name, B, dev, reps, streams):
    """KC on case `name` at batch B in one launch, the other checkout's (the
    CSR KC's interface, or with `streams` this one's) and this one's:
    their first violated rows compared, then timed in turns."""
    rows, n_wires, spec, wit = kc_case(name, dev, B)
    checker = R1CSChecker(rows, n_wires, spec, device=dev)
    old = csr_matrices(rows, spec, dev)
    field, n = checker.field, checker.n_rows
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = build.u32_array(field.p_list)
    rpc = kc_rows_per_chunk(n, B)
    firsts = {k: torch.full((B,), n, dtype=torch.int32, device=dev)
              for k in ("other", "this")}
    this_args = kc_args(checker, wit, firsts["this"], stream)
    other_args = (kc_args(checker, wit, firsts["other"], stream) if streams
                  else (spec.n_limbs, wit.data_ptr(), B,
                        *[t.data_ptr() for m in old for t in m], n, rpc, p,
                        field.n0inv32, firsts["other"].data_ptr(), stream))
    fns = {
        "other": lambda: checked(libs["other", "check"].ctpu_r1cs_check(
            *other_args), "other KC"),
        "this": lambda: checked(libs["this", "check"].ctpu_r1cs_check(
            *this_args), "this KC")}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    want = firsts["other"]
    bad = int((want < n).sum())
    if not torch.equal(firsts["this"], want):
        raise SystemExit(f"KC {name}: this differs from the other checkout's")
    ms = in_turns(fns, reps)
    products = kc_products(rows, spec.p, spec.n_limbs)
    nnz = sum(len(r[m]) for r in rows for m in range(3))
    old_products = (nnz + n) * 2 * (spec.n_limbs // 2) ** 2
    for k, v in ms.items():
        print(f"  KC {name} at {B} ({n} rows, {nnz} nonzeros) {k}: "
              f"{v[0]:.4f}, {v[1]:.4f} ms")
    print(f"  KC {name}: first violated rows identical, {bad} lanes "
          f"flagged; {rpc} rows a block; 32-bit products a lane: "
          f"{products} by class, {old_products} as a CIOS a nonzero and a "
          "row")
    return {"batch": B, "rows": n, "nnz": nnz, "flagged": bad,
            "rows_per_chunk": rpc, "products_per_lane": products,
            "cios_products_per_lane": old_products, "ms": ms}


# KS's cases: (name, circuit, slots of the other KS's schedule, lanes)
KS_CASES = (("Q", "n2b254x16", 8, 8192), ("QS8", "n2b254x16", 8, 65536),
            ("QS64", "n2b254x16", 64, 65536),
            ("O", "bigdiv_n2b254", 8, 8192))
# the other KS's widths: a warp a slot (its kept layout), a thread a lane
OTHER_KS_WARPS = (8, 1)


def old_ks_tables(sched):
    """The tables of the KS whose register file was all in device memory,
    a frozen copy of its builder: (off int32 (n_steps + 1,), entries
    int32 (off[-1], 8)) from a scan Schedule; the first step
    the constants' and inputs' loads (imm: the constant's index; a: the
    input's), then each step's real slots, then the copied rows."""
    opc, a_i, b_i, c_i, o_i, w_i, imm = sched.tables
    trash, n_w = sched.n_regs - 1, sched.n_witness

    def entries(op, a=0, b=0, c=0, o=-1, w=-1, k=0):
        cols = np.broadcast_arrays(KS_OPS.index(op), a, b, c, o, w, k, 0)
        return np.stack(cols, -1).reshape(-1, 8).astype(np.int32)

    first = [entries("const", o=reg, k=k)
             for k, (reg, _v, _d) in enumerate(sched.const_loads)]
    first += [entries("input", a=idx, o=reg)
              for reg, idx in sched.input_loads]
    load = {reg: ("const", {"k": k})
            for k, (reg, _v, _d) in enumerate(sched.const_loads)}
    load.update({reg: ("input", {"a": idx})
                 for reg, idx in sched.input_loads})
    for reg, ws in sched.load_outputs:
        op, kw = load[reg]
        first.append(entries(op, w=np.asarray(ws), **kw))
    steps = [np.concatenate(first) if first else np.zeros((0, 8), np.int32)]
    for si in range(sched.n_steps):
        op = sched.branch_ops[opc[si]]
        n = int((o_i[si] != trash).sum())
        w = w_i[si, :n]
        cols = [t[si, :n] for t in (a_i, b_i, c_i)]
        steps.append(entries(op, *cols, o_i[si, :n], np.where(w == n_w, -1, w),
                             imm[si, :n]))
    if sched.out_dups:
        src, dst = np.asarray(sched.out_dups, np.int64).T
        steps.append(entries("dup", a=src, w=dst))
    off = np.cumsum([0] + [len(t) for t in steps]).astype(np.int32)
    return off, np.concatenate(steps)


def old_ks_args(scan, x, rf, out, warps, stream):
    """The other KS's arguments (see the module's docstring) for one run
    of ScanProgram `scan` on x into out, its register file rf; the tables
    on x's device in scan.old_ks (old_ks_tables' and the constants'
    words, const_loads in order)."""
    f, d = scan.field, scan.old_ks
    limbs = (f.p_list + f.r2_list + f.one_mont_list + f.half_list
             + f.mask_list)
    return (f.L, d["off"].data_ptr(), d["ent"].data_ptr(),
            len(d["off"]) - 1, d["consts"].data_ptr(), x.data_ptr(),
            rf.data_ptr(), out.data_ptr(), x.shape[-1],
            build.u32_array(limbs), f.n0inv32, f.p.bit_length(), warps,
            stream)


def ks_program(circuit, spec, dev, slots):
    """(a WitnessProgram of `circuit` at `slots` on the scan, and the
    program whose KS the path runs: the scan's, or for O the
    straight-line path's)."""
    src = (num2bits_source(254, 16) if circuit == "n2b254x16"
           else bigdiv_num2bits_source())
    tape = compile_source(src).build_tape()[0]
    scan = WitnessProgram(tape, spec, device=dev, slots=slots,
                          mode="scan", unroll_threshold=0)
    main = (scan if circuit == "n2b254x16"
            else WitnessProgram(tape, spec, device=dev))
    return scan, main


def ks(libs, dev, reps, same):
    """KS of both checkouts on every KS_CASES shape, this one's at every
    width of KS_WIDTHS, the other's at OTHER_KS_WARPS (or, with `same`,
    this one's interface, at KS_WIDTHS), in turns; {case: {"tag
    w<warps>": [ms, ms]}}."""
    spec = field_spec("bn128")
    L = spec.n_limbs
    gen = torch.Generator(device=dev).manual_seed(14)
    out = {}
    for name, circuit, slots, B in KS_CASES:
        scan_prog, prog = ks_program(circuit, spec, dev, slots)
        scan = scan_prog.scan
        this = (prog.scan or prog.perop).ks
        x = canonical(gen, spec, (prog.n_inputs, L, B), dev)
        if circuit != "n2b254x16":
            x.view(torch.int32)[1, 0] |= 1     # a nonzero divisor
        want = prog.run(x).view(torch.int32)
        plain = (scan.run_loop(x) if circuit == "n2b254x16"
                 else prog.perop.run_nodes(x))
        if not torch.equal(want, plain.view(torch.int32)):
            raise SystemExit(f"KS on {name} differs from its plain version")
        del plain
        got = torch.empty_like(want)
        stream = build.stream_ptr(dev)
        fns, keep = {}, []
        if not same:
            off, ent = old_ks_tables(scan.sched)
            words = const_words([(v, d) for _r, v, d in
                                 scan.sched.const_loads], scan.field)
            scan.old_ks = {"off": to_device(off, dev),
                           "ent": to_device(ent, dev),
                           "consts": to_device(np.ascontiguousarray(words),
                                               dev)}
        for tag in ("other", "this"):
            lib = libs[tag, "scan"]
            widths = (OTHER_KS_WARPS if tag == "other" and not same
                      else KS_WIDTHS)
            for warps in widths:
                if tag == "other" and not same:
                    rf = torch.empty((scan.sched.n_regs, L // 2, B),
                                     dtype=torch.int32, device=dev)
                    keep.append(rf)
                    args = old_ks_args(scan, x, rf, got, warps, stream)
                else:
                    d = this.device_tables(warps)
                    t = d["t"]
                    spill = (torch.empty((t.n_spill, L // 2, B),
                                         dtype=torch.int32, device=dev)
                             if t.n_spill else None)
                    keep.append(spill)
                    args = ks_args(this.field, d, x, spill, got, stream)
                fns[f"{tag} w{warps}"] = (
                    lambda lib=lib, args=args:
                    checked(lib.ctpu_scan(*args), "KS"))
        for k, fn in fns.items():
            got.zero_()
            fn()
            if not torch.equal(got, want):
                raise SystemExit(f"KS {k} on {name} differs from this "
                                 "checkout's run")
        t = in_turns(fns, reps if B == 8192 else max(2, reps // 4))
        out[name] = t
        for k, v in t.items():
            print(f"  KS {name} ({B} lanes) {k}: "
                  + ", ".join(f"{m:.4f}" for m in v) + " ms")
        del scan_prog, prog, scan, this, x, want, got, keep
        torch.cuda.empty_cache()
    return out


# K4's cases: (name, copies of Num2Bits(254)/bn128, batch)
K4_CASES = (("S", 1, 65536), ("S4", 4, 65536))

# run in a child process with one checkout on its path: that checkout's
# K4 source for argv[1] x Num2Bits(254)/bn128, written to argv[2]
K4_SOURCE = """
import sys
from circom_tpu_torch.backend.torch_backend import WitnessProgram
from circom_tpu_torch.circuits.sources import num2bits_source
from circom_tpu_torch.compiler.pipeline import compile_source
from circom_tpu_torch.field.primes import field_spec
cc = compile_source(num2bits_source(254, int(sys.argv[1])))
prog = WitnessProgram(cc.build_tape()[0], field_spec("bn128"), device="cpu")
open(sys.argv[2], "w").write(prog.fused.source())
"""


def k4_source(root, copies, path):
    """The K4 source that the checkout at `root` generates for `copies` x
    Num2Bits(254)/bn128, written to `path` by its own generator."""
    r = subprocess.run([sys.executable, "-c", K4_SOURCE, str(copies),
                        str(path)], cwd=root, capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=str(root)))
    if r.returncode:
        raise SystemExit(f"K4 source of {root}: {r.stderr[-2000:]}")
    return Path(path).read_text()


def k4_stacked(text):
    """Whether a generated K4 source has the stacked interface (two
    buffers: the segment's inputs and its outputs), not this checkout's
    in-place one (three: inputs, witness, crossing buffer)."""
    head = text.split('extern "C" int ctpu_k4_seg0(')[1].split(")")[0]
    return head.count("uint32_t*") == 2


def k4_segments(text):
    """[(ops, inputs, outputs)] of each segment, from a generated source's
    comments."""
    return [tuple(map(int, m)) for m in re.findall(
        r"// segment \d+: (\d+) ops, (\d+) inputs, (\d+) outputs", text)]


def build_k4(root, text, tag):
    """The entry points of a generated K4 source, built by nvcc against
    the headers of the checkout at `root`, a library a segment in
    parallel (-DK4_SEG=s), into ab/ of the build directory."""
    out_dir = build.build_dir() / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"{tag}.cu"
    src.write_text(text)
    n = len(re.findall(r'extern "C" int ctpu_k4_seg\d+\(', text))
    nvcc = build.nvcc_path()
    inc = Path(root) / "circom_tpu_torch" / "ops" / "cuda"

    def one(s):
        so = out_dir / f"{tag}-s{s}.so"
        r = subprocess.run([nvcc, *build.NVCC_FLAGS, f"-DK4_SEG={s}", "-I",
                            str(inc), "-o", str(so), str(src)],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
        if r.returncode:
            raise SystemExit(f"nvcc failed on {tag} segment {s}:\n{r.stdout}")
        return so

    with ThreadPoolExecutor(max_workers=n) as pool:
        sos = list(pool.map(one, range(n)))
    n_ptr = 2 if k4_stacked(text) else 3
    fns = []
    for s, so in enumerate(sos):
        fn = getattr(ctypes.CDLL(str(so)), f"ctpu_k4_seg{s}")
        fn.restype = _I
        fn.argtypes = [_P] * n_ptr + [_LL, _P]
        fns.append(fn)
    return fns


def stacked_run(sp, launch, x):
    """The segments' run over the stacked K4 interface, a frozen copy of
    the route it had: each segment's inputs stacked from input rows and
    earlier segments' outputs, a fresh output tensor a segment (launch(s,
    xin, out) runs segment s), then the witness stacked from the outputs,
    constant rows and input rows.  Returns (the witness, each segment's
    (inputs, outputs))."""
    xt, L = sp.xt, sp.L
    xi = x.view(torch.int32)
    B = x.shape[-1]
    vals, bufs = {}, []
    for s, seg in enumerate(sp.segments):
        parts = [xi[xt.iidx[a]] if xt.kind[a] == "input" else vals[a]
                 for a in seg.in_nodes]
        xin = torch.stack(parts) if parts else torch.zeros(
            (1, L, B), dtype=torch.int32, device=x.device)
        out = torch.empty((len(seg.out_nodes), L, B), dtype=torch.int32,
                          device=x.device)
        launch(s, xin, out)
        bufs.append((xin, out))
        for row, a in enumerate(seg.out_nodes):
            vals[a] = out[row]
    rows = []
    for nid in xt.out_ids:
        if xt.kind[nid] == "const":
            limb = torch.as_tensor(int_to_limbs(xt.cval[nid], L)
                                   .astype(np.int32), device=x.device)
            rows.append(limb[:, None].expand(L, B))
        elif xt.kind[nid] == "input":
            rows.append(xi[xt.iidx[nid]])
        else:
            rows.append(vals[nid])
    return torch.stack(rows).view(torch.uint32), bufs


def peak_gib(dev, fn):
    """GiB that fn() allocates at its peak beyond what was allocated
    before it."""
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn()
    torch.cuda.synchronize(dev)
    return (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30


def k4(other, dev, reps):
    """K4 of both checkouts on every K4_CASES program: both runs bit for
    bit, then in turns the bare K4 launches of a run (every segment, its
    buffers allocated before) and the whole runs, and each run's peak
    allocation; {case: {...}}."""
    from .backend.segments import launch_k4

    spec = field_spec("bn128")
    gen = torch.Generator(device=dev).manual_seed(17)
    stream = build.stream_ptr(dev)
    out_dir = build.build_dir() / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    progs, jobs = {}, []
    for name, copies, _B in K4_CASES:
        tape = compile_source(num2bits_source(254, copies)).build_tape()[0]
        prog = progs[name] = WitnessProgram(tape, spec, device=dev)
        text = k4_source(Path(other).resolve(), copies,
                         out_dir / f"other-{name}.txt")
        if k4_segments(text) != [(len(g.instrs), len(g.src),
                                  len(g.dst))
                                 for g in prog.fused.kernels]:
            raise SystemExit(f"K4 on {name}: the other checkout cuts "
                             "other segments")
        jobs.append((name, text))
    with ThreadPoolExecutor(len(jobs) + 1) as pool:
        mine = pool.submit(build.build_all, [
            (p.fused.source(), len(p.fused.kernels)) for p in progs.values()])
        theirs = {name: pool.submit(build_k4, other, text, f"k4-{name}")
                  for name, text in jobs}
        print(f"  this checkout's K4 built in {mine.result():.1f} s")
        theirs = {k: f.result() for k, f in theirs.items()}
    result = {}
    for (name, copies, B), (_n, text) in zip(K4_CASES, jobs):
        prog, fns = progs[name], theirs[name]
        sp = prog.fused
        stacked = k4_stacked(text)
        x = canonical(gen, spec, (copies, spec.n_limbs, B), dev)
        want = prog.run(x)
        if stacked:
            def launch(s, xin, o, fns=fns, B=B):
                checked(fns[s](xin.data_ptr(), o.data_ptr(), B, stream),
                        "K4")
            got, bufs = stacked_run(sp, launch, x)

            def other_run():
                return stacked_run(sp, launch, x)[0]

            def other_bare():
                for s, (xin, o) in enumerate(bufs):
                    launch(s, xin, o)
        else:
            wit_o = torch.empty_like(want)
            cross_o = torch.empty((sp.n_cross, sp.L, B), dtype=torch.uint32,
                                  device=dev)

            def other_bare():
                for s in range(len(fns)):
                    checked(fns[s](x.data_ptr(), wit_o.data_ptr(),
                                   cross_o.data_ptr(), B, stream), "K4")

            def other_run():
                wit = torch.empty_like(want)
                cross = torch.empty_like(cross_o)
                for s in range(len(fns)):
                    checked(fns[s](x.data_ptr(), wit.data_ptr(),
                                   cross.data_ptr(), B, stream), "K4")
                return wit
            got = other_run()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise SystemExit(f"K4 on {name}: the other checkout's witness "
                             "differs from this one's")
        del got
        wit, cross = torch.empty_like(want), torch.empty(
            (sp.n_cross, sp.L, B), dtype=torch.uint32, device=dev)

        def this_bare():
            for s in range(len(sp.kernels)):
                launch_k4(sp, s, x, wit, cross)
        this_bare()
        if not torch.equal(wit.view(torch.int32), want.view(torch.int32)):
            raise SystemExit(f"K4 on {name}: bare launches differ from the "
                             "run")
        del want
        bare = in_turns({"other": other_bare, "this": this_bare}, reps)
        runs = in_turns({"other": other_run, "this": lambda: prog.run(x)},
                        reps)
        peaks = {"other": peak_gib(dev, other_run),
                 "this": peak_gib(dev, lambda: prog.run(x))}
        result[name] = {"interface": "stacked" if stacked else "in place",
                        "segments": len(sp.kernels), "bare_ms": bare,
                        "run_ms": runs, "peak_gib": peaks}
        for what, t in (("bare K4", bare), ("run", runs)):
            for k, v in t.items():
                print(f"  K4 {name} ({B} lanes) {what} {k}: "
                      + ", ".join(f"{m:.4f}" for m in v) + " ms")
        print(f"  K4 {name} peak allocation of a run: other "
              f"{peaks['other']:.3f} GiB, this {peaks['this']:.3f} GiB")
        del x, wit, cross
        if stacked:
            del bufs
        torch.cuda.empty_cache()
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the checkout to compare with")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--kernels", default="k1,k2,k5,kc,ks,k4",
                    help="which comparisons to run, and so which sources "
                         "to build (default: all six)")
    args = ap.parse_args(argv)
    kernels = set(args.kernels.split(","))
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    names = [n for k, n in (("k1", "interp"), ("k2", "gather"),
                            ("k5", "field_ops"), ("kc", "check"),
                            ("ks", "scan")) if k in kernels]
    with ThreadPoolExecutor(1) as pool:
        # KC's witnesses and KS's reference run this checkout's kernels:
        # built beside
        fixed = (pool.submit(build.build_all) if kernels & {"kc", "ks"}
                 else None)
        libs = build_libraries(args.other, names) if names else {}
        if fixed is not None:
            print(f"  this checkout's kernels built in {fixed.result():.1f} s")
    result = {"card": card.strip()}
    if "k1" in kernels:
        limbs = limbs_k1(args.other)
        print(f"  the other K1 takes {36 if limbs else 35} arguments")
        for name, B in K1_CASES:
            result[f"k1_{name}_{B}"] = k1(libs, name, B, dev, args.reps,
                                          limbs)
            torch.cuda.empty_cache()
    if "k2" in kernels:
        result["k2"] = k2(libs, dev, args.reps)
        torch.cuda.empty_cache()
    if "k5" in kernels:
        pos = compile_source(generate((2,))
                             + "\ncomponent main = Poseidon2();\n")
        result["k5_P"] = k5(libs, "P", pos.r1cs_rows(),
                            pos.counts()["n_wires"], 65536, dev, args.reps)
        sha = compile_source(
            (ROOT / "circom_tpu_torch/circuits/sha256.circom").read_text()
            + "\ncomponent main = Sha256Block();\n")
        result["k5_F"] = k5(libs, "F", sha.r1cs_rows(),
                            sha.counts()["n_wires"], 8192, dev,
                            max(2, args.reps // 4))
    if "kc" in kernels:
        streams = streams_kc(args.other)
        result["kc_P"] = kc(libs, "P", 65536, dev, args.reps, streams)
        torch.cuda.empty_cache()
        result["kc_F"] = kc(libs, "F", 8192, dev, max(2, args.reps // 4),
                            streams)
        torch.cuda.empty_cache()
    if "ks" in kernels:
        result["ks"] = ks(libs, dev, args.reps, shared_ks(args.other))
    if "k4" in kernels:
        result["k4"] = k4(args.other, dev, args.reps)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
