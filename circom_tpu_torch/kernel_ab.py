"""Time K1, K3, K2, K5 and K6, KC, KS and K4 against the same kernels
built from another checkout.

    python -m circom_tpu_torch.kernel_ab --other DIR [--reps N]
        [--kernels k1,k3,k2,k5,kc,ks,k4]

DIR is the root of another checkout of this repository, for example an
earlier commit unpacked with `git archive`.  Its
circom_tpu_torch/ops/cuda sources of the kernels --kernels asks for are
built beside this checkout's, with the same nvcc flags, all at once
(interp.cu alone takes about a minute of nvcc), and each library's entry
point is called through ctypes.  K2's and K5/K6's entry points have the
same interface in both (the 32-bit K5's, with n0inv32).  The other K1's
interface is read off its interp.cu (k1_interface), by its arguments:
this checkout's 37 (k1_args: the caller's input rows, their limb count
and the plan's win_order and nin_order, read where they lie), or 0844d12's
35, the split inputs x_w (n_win, L, B) and x_n (n_nin, B) in place of
those (split_k1_args, a frozen copy of 0844d12's argument list), which
gets the split of the same input rows, made once before the launches.
The other K3 likewise takes the input rows or 0844d12's split x_n
(rows_k3).  KC, KS and K4 must take this checkout's interfaces, which
0844d12's already do: an older interface of any kernel asked for is
refused (refuse_older), so that no route older than the parent is kept
here.  Both versions run on the same inputs, must agree bit for bit, and
are timed by CUDA events around their bare launches (no checks, outputs
allocated before), in turns: other, this, this, other.

- K1 on five plans, every emitted row of both banks compared, with the
  32-bit products a lane of each: Poseidon2/bn128 (P, K1a) and
  SHA256/bn128 (M, K1b) at batch 65,536, Poseidon2/goldilocks (G, K1c)
  at 65,536 and at 16,384 (a quarter of the lanes: a time that hardly
  moves says each lane's chain of dependent steps, not the card's
  throughput, bounds K1), the stdlib comparators/bn128 (C, K1d) at
  65,536, bigint-div/bn128 (D, K1d's long division) at 8,192.
- With K1, where the other K1 takes the split inputs (35 arguments):
  the interpreter's whole run of SHA256/bn128, full limbs at 8,192 (F)
  and run_mixed at 65,536 (M), this checkout's (K1 and K3 reading the
  input rows where they lie, then KW, or K3) against the other's route
  (split_run, a frozen copy of 0844d12's: the split in plain PyTorch,
  K1 on it, then KW, or K3 on the split narrow inputs), both outputs bit
  for bit, the runs timed in turns by CUDA events and each run's peak
  allocation read.
- K3 at M's shape (SHA256/bn128's run_mixed at 65,536 lanes:
  27,369 rows, 512 narrow input rows of 2 limbs), its bare launch on the
  same K1 narrow bank, this checkout's reading the input rows and the
  other's on the split x_n where it takes that (made once before).
- K2 at Poseidon2/bn128's plan shape (the plan's wd_src over a random
  bank of (n_bank_rows, 16, 65,536)), beside `index_select` of the same
  rows into the same output.
- K5 and K6 (field_ops.cu) at the shapes where chip_smoke.py's phase 2
  holds them (no main path has launched either since KS took the per-op
  paths over): K5 on Poseidon2/bn128's check's widest matrix, (nnz, 16,
  8,192) by an (nnz, 16, 1) coefficient column, and K6's add and subtract
  on its (320, 16, 8,192) constraint rows.
- KC (check.cu) on the R1CS check of Poseidon2/bn128 (P) at batch 65,536
  and of the full-limb SHA256 block over bn128 (F) at 8,192, each in one
  launch over the whole batch, lanes corrupted at different wires, both
  through this checkout's checker's arguments (kc_args).  The first
  violated rows of both must be identical.
- KS (scan.cu) on 16 x Num2Bits(254)/bn128 at batch 8,192 (Q) and
  65,536 (QS8, QS64: the scan's schedule at 8 and 64 slots), and on
  bigint-div + Num2Bits(254)/bn128 at 8,192 (O), this checkout's at
  every width of KS_WIDTHS over its own tables (backend/ks.py), both
  through ks_args.  Every launch's witness equals this checkout's run,
  which equals the step loop's (Q, QS) or the per-node path's (O).
- K4 (generated per program) on the segmented paths Num2Bits(254)/bn128
  (S) and 4 x Num2Bits(254)/bn128 (S4), and on the op circuit (every op
  a segment holds; U at bn128, Ug at goldilocks), all at batch 65,536 on
  random canonical inputs: each checkout's own generator writes its
  source (a child process with only that checkout on its path), and nvcc
  builds a library a segment of both at once.  Both take the in-place
  interface, `ctpu_k4_seg<s>(x, w, c, B, stream)` over the inputs, the
  witness and the crossing buffer (the stacked one of two buffers, older
  than 0844d12, is refused: k4_stacked).  Both runs' witnesses must be
  equal bit for bit; the bare K4 launches (all segments, buffers
  allocated before) and the whole runs are timed in turns, and each
  run's peak allocation read.

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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import numpy as np

from .backend.checker import (R1CSChecker, kc_args, kc_products,
                              kc_rows_per_chunk)
from .backend.interp import (interp_k1, k1_args, k1_file_shape, kw_args,
                             narrow_inputs)
from .backend.ks import KS_WIDTHS, ks_args
from .backend.torch_backend import WitnessProgram
from .circuits import sha256_io
from .circuits.gen_poseidon import generate
from .circuits.sources import (BIGINT_DIV_SRC, bigdiv_num2bits_source,
                               comparator_inputs, comparators_source,
                               num2bits_source, poseidon2_source,
                               segment_ops_source)
from .backend.interp_plan import _NARROW_RESULT, _OPERAND_FILES
from .convert import N_OPERANDS, OPCODES, to_device
from .compiler.pipeline import compile_source
from .field.primes import LIMB_BITS, field_spec
from .ops import build
from .ops.field import TorchField, as_i64
from .ops.narrow import to_i32

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("interp", "gather", "field_ops")
_P, _I, _LL, _U32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                     ctypes.c_uint32)
_PU32 = ctypes.POINTER(ctypes.c_uint32)
# the other checkout's entry points where they differ from this one's:
# 0844d12's K1 on the split inputs (35 arguments) and K3 on the split
# narrow inputs
K1_SIGNATURES = {
    "rows": build.SIGNATURES["interp"]["ctpu_interp_k1"],
    "split": (_I, [_I, _LL, _P, _I, _P, _I, _P, _P, _P, _P, _P, _I, _P, _P,
                   _P, _P, _I, _P, _P, _I, _P, _P, _I, _P, _P, _I, _PU32,
                   _PU32, _U32, _PU32, _PU32, _PU32, _I, _I, _P])}
SPLIT_K3 = dict(build.SIGNATURES["gather"], ctpu_gather_n=(
    _I, [_P, _LL, _P, _P, _P, _P, _LL, _LL, _P]))


def _source(root, name):
    return (Path(root) / "circom_tpu_torch" / "ops" / "cuda"
            / f"{name}.cu").read_text()


def _head(root, name, fn):
    """The parameter list of entry point `fn` in the checkout's name.cu."""
    return _source(root, name).split(f'extern "C" int {fn}')[1].split("{")[0]


def k1_interface(root):
    """The interface of the K1 of the checkout at `root`: "rows" (this
    checkout's 37 arguments: the input rows and the plan's win_order and
    nin_order) or "split" (0844d12's 35: the split inputs x_w and x_n);
    an older one (the constant bank in limbs as well) is refused."""
    head = _head(root, "interp", "ctpu_interp_k1")
    if "win_order" in head:
        return "rows"
    if "cbank," in head:
        raise SystemExit(f"the K1 of {root} is older than 0844d12's")
    return "split"


def rows_k3(root):
    """Whether the K3 of the checkout at `root` reads its narrow inputs in
    the input rows (this checkout's interface), not the split x_n."""
    return "nin_order" in _head(root, "gather", "ctpu_gather_n")


# what this checkout's (and 0844d12's) KC and KS name in their sources:
# KC's entry streams, KS's shared-memory register file
CURRENT_MARKS = {"check": "a_ent", "scan": "n_smem"}


def refuse_older(root, names):
    """Raises SystemExit where the checkout at `root` has, for a source of
    `names`, a KC or KS older than 0844d12's (KC over CSR columns, KS over
    a register file in device memory): kernel_ab keeps no route older
    than the parent's."""
    for name, mark in CURRENT_MARKS.items():
        if name in names and mark not in _source(root, name):
            raise SystemExit(f"the {name}.cu of {root} is older than "
                             "0844d12's")


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
        sigs = build.SIGNATURES[name]
        if name == "gather" and tag == "other" and not rows_k3(root):
            sigs = SPLIT_K3
        if name == "interp":
            sigs = {"ctpu_interp_k1": K1_SIGNATURES[
                "rows" if tag == "this" else k1_interface(root)]}
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
    """(plan, field, input rows, their split: wide inputs, narrow inputs)
    of K1_CASES' plan `name` at batch B."""
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
    x, x_w, x_n = prog.interp._inputs(x)
    return (prog.interp.plan, prog.field, x.contiguous(), x_w.contiguous(),
            x_n.contiguous())


def split_k1_args(plan, field, x_w, x_n, rf, bank, rf_n, bank_n, stream):
    """The arguments of a K1 that takes the split inputs (35; a frozen
    copy of 0844d12's k1_args): wide inputs uint32 (n_win, L, B), narrow
    inputs int32 (n_nin, B), then this checkout's tables."""
    d = plan.dev
    return (
        plan.L, x_w.shape[-1], x_w.data_ptr(), x_w.shape[0], x_n.data_ptr(),
        x_n.shape[0], d["table"].data_ptr(), d["grp"].data_ptr(),
        d["r_op"].data_ptr(), d["r_s0"].data_ptr(),
        d["rstarts"].data_ptr(), plan.n_chunks, d["cbank_w"].data_ptr(),
        d["mont_tab"].data_ptr(), d["mat_regs"].data_ptr(),
        d["mat_limbs"].data_ptr(), len(plan.mat_regs),
        d["nmat_vals"].data_ptr(), d["nmat_regs"].data_ptr(),
        len(plan.nmat_regs), rf.data_ptr(), bank.data_ptr(), plan.K,
        rf_n.data_ptr(), bank_n.data_ptr(), plan.KN,
        build.u32_array(field.p_list), build.u32_array(field.r2_list),
        field.n0inv32, build.u32_array(field.half_list),
        build.u32_array(field.mask_list), build.u32_array(field.q_list),
        field.p.bit_length(),
        int(bool({"interp_k1c", "interp_k1d"} & set(plan.parts))), stream)


def k1(libs, name, B, dev, reps, iface):
    """K1 on plan `name` at batch B, this checkout's on the input rows and
    the other's of interface `iface` (k1_interface) on the rows or on
    their split, every emitted row compared, then timed in turns."""
    plan, field, x, x_w, x_n = k1_case(name, dev, B)
    stream = torch.cuda.current_stream(dev).cuda_stream
    outs, fns = {}, {}

    def rows_args(plan, field, _w, _n, *rest):
        return k1_args(plan, field, x, *rest)

    other = {"rows": rows_args, "split": split_k1_args}[iface]
    for tag, make_args in (("other", other), ("this", rows_args)):
        o = outs[tag] = {
            "rf": torch.empty(k1_file_shape(plan, B), dtype=torch.uint32,
                              device=dev),
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


def split_run(libs, prog, x, mixed, orders):
    """0844d12's interpreter run on the other checkout's K1, K2, K3 and KW
    (a frozen copy of its route): the input rows split in plain PyTorch
    (index_select of the wide rows; the narrow rows gathered, widened to
    int64, shifted, OR-ed and cast back to int32), K1 on the split, then
    KW, or K2 where the witness is the wide bank's rows (run); K3 on the
    split narrow inputs, then K2 or KW for the wide rows (run_mixed).
    orders: the plan's win_order and nin_order as int64 tensors on the
    card, as 0844d12 kept them."""
    interp, field = prog.interp, prog.field
    plan, dev = interp.plan, prog.device
    lin, B = x.shape[1], x.shape[-1]
    stream = torch.cuda.current_stream(dev).cuda_stream
    x_i = x.view(torch.int32)
    x_w = (x_i.index_select(0, orders[0]).view(torch.uint32)
           if plan.win_order else
           torch.empty((0, plan.L, B), dtype=torch.uint32, device=dev))
    if plan.nin_order:
        xs = as_i64(x_i.index_select(0, orders[1]).view(torch.uint32))
        x_n = to_i32(xs[:, 0] | (xs[:, 1] << 16) if lin > 1 else xs[:, 0])
    else:
        x_n = torch.empty((0, B), dtype=torch.int32, device=dev)
    rf = torch.empty(k1_file_shape(plan, B), dtype=torch.uint32, device=dev)
    rf_n = torch.empty((plan.n_nregs, B), dtype=torch.int32, device=dev)
    bank = torch.empty((plan.n_bank_rows, plan.L, B), dtype=torch.uint32,
                       device=dev)
    bank_n = torch.empty((plan.n_bank_n_rows, B), dtype=torch.int32,
                         device=dev)
    checked(libs["other", "interp"].ctpu_interp_k1(*split_k1_args(
        plan, field, x_w, x_n, rf, bank, rf_n, bank_n, stream)), "other K1")
    lib = libs["other", "gather"]

    def k2(idx):
        out = torch.empty((idx.shape[0], plan.L, B), dtype=torch.uint32,
                          device=dev)
        if out.numel():
            checked(lib.ctpu_gather_rows(bank.data_ptr(), idx.data_ptr(),
                                         out.data_ptr(), plan.L * B,
                                         idx.shape[0], stream), "other K2")
        return out

    def kw(rows):
        tab = interp._kw[rows]
        out = torch.empty((tab.shape[0], plan.L, B), dtype=torch.uint32,
                          device=dev)
        if out.numel():
            checked(lib.ctpu_assemble(*kw_args(
                field, tab, bank, bank_n, x, plan.dev["consts"], out,
                stream)), "other KW")
        return out

    if not mixed:
        return k2(plan.dev["wd_src"]) if interp._k2_whole else kw("full")
    src, shift = plan.dev["nw_src"], plan.dev["nw_shift"]
    narrow = torch.empty((src.shape[0], B), dtype=torch.int32, device=dev)
    if narrow.numel():
        checked(lib.ctpu_gather_n(bank_n.data_ptr(), bank_n.shape[0],
                                  x_n.data_ptr(), src.data_ptr(),
                                  shift.data_ptr(), narrow.data_ptr(),
                                  src.shape[0], B, stream), "other K3")
    return narrow, (k2(plan.dev["wd_src"]) if interp._bank_only
                    else kw("wide"))


def sha256_program(dev):
    """SHA256/bn128's WitnessProgram on `dev` (the interpreter's plan of M
    and F)."""
    cc = compile_source(
        (ROOT / "circom_tpu_torch/circuits/sha256.circom").read_text()
        + "\ncomponent main = Sha256Block();\n")
    return WitnessProgram(cc.build_tape()[0], field_spec("bn128"),
                          device=dev, input_ranges=cc.input_range_hints())


def k3(libs, dev, reps, rows):
    """K3 at M's shape (run_mixed of SHA256/bn128 at 65,536 lanes: 27,369
    rows from this checkout's K1 narrow bank and 512 narrow input rows of
    2 limbs), both checkouts' bare launches into outputs allocated before:
    this one's reading the input rows, the other's on the split x_n (made
    once before) or, with `rows`, on the input rows as well; both outputs
    bit for bit, then timed in turns."""
    prog = sha256_program(dev)
    plan, B = prog.interp.plan, 65536
    rng = np.random.default_rng(18)
    msgs = [bytes(m) for m in rng.integers(0, 256, size=(B, 32),
                                           dtype=np.uint8)]
    x = to_device(sha256_io.input_rows(msgs), dev)
    _bank, bank_n = interp_k1(plan, prog.field, x)
    del _bank
    order, src = plan.dev["nin_order"], plan.dev["nw_src"]
    shift = plan.dev["nw_shift"]
    x_n = narrow_inputs(x, order)
    W = src.shape[0]
    outs = {k: torch.empty((W, B), dtype=torch.int32, device=dev)
            for k in ("other", "this")}
    stream = torch.cuda.current_stream(dev).cuda_stream

    def row_args(out):
        return (bank_n.data_ptr(), bank_n.shape[0], x.data_ptr(),
                x.shape[1], order.data_ptr(), src.data_ptr(),
                shift.data_ptr(), out.data_ptr(), W, B, stream)

    args = {"this": row_args(outs["this"]),
            "other": row_args(outs["other"]) if rows else (
                bank_n.data_ptr(), bank_n.shape[0], x_n.data_ptr(),
                src.data_ptr(), shift.data_ptr(), outs["other"].data_ptr(),
                W, B, stream)}
    fns = {k: (lambda k=k: checked(libs[k, "gather"].ctpu_gather_n(
        *args[k]), f"{k} K3")) for k in ("other", "this")}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    if not torch.equal(outs["this"], outs["other"]):
        raise SystemExit("K3 on M: this differs from other")
    ms = in_turns(fns, reps)
    for k, v in ms.items():
        print(f"  K3 M at {B} ({W} rows, {len(plan.nin_order)} narrow input "
              f"rows of {x.shape[1]} limbs) {k}: {v[0]:.4f}, {v[1]:.4f} ms")
    return {"batch": B, "rows": W, "other_reads": "rows" if rows else "x_n",
            "ms": ms}


def interp_runs(libs, dev, reps):
    """The interpreter's whole run of SHA256/bn128, full limbs at 8,192
    (F) and run_mixed at 65,536 (M): this checkout's against the other's
    route (split_run), outputs bit for bit, both runs timed in turns by
    CUDA events and each run's peak allocation read."""
    spec = field_spec("bn128")
    prog = sha256_program(dev)
    plan = prog.interp.plan
    orders = [torch.as_tensor(o, dtype=torch.int64, device=dev)
              for o in (plan.win_order, plan.nin_order)]
    rng = np.random.default_rng(16)
    out = {}
    for name, B, lin, mixed in (("F", 8192, spec.n_limbs, False),
                                ("M", 65536, 2, True)):
        msgs = [bytes(m) for m in rng.integers(0, 256, size=(B, 32),
                                               dtype=np.uint8)]
        x = to_device(sha256_io.input_rows(msgs, lin), dev)
        fns = {"other": lambda: split_run(libs, prog, x, mixed, orders),
               "this": (lambda: prog.run_mixed(x)) if mixed
               else (lambda: prog.run(x))}
        got = {k: fn() for k, fn in fns.items()}
        torch.cuda.synchronize()
        pairs = zip(got["this"], got["other"]) if mixed \
            else [(got["this"], got["other"])]
        for a, b in pairs:
            if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                raise SystemExit(f"run {name}: this differs from other")
        del got
        ms = in_turns(fns, reps)
        peaks = {k: peak_gib(dev, fn) for k, fn in fns.items()}
        for k, v in ms.items():
            print(f"  run {name} at {B} ({'run_mixed' if mixed else 'run'}) "
                  f"{k}: {v[0]:.4f}, {v[1]:.4f} ms, peak {peaks[k]:.3f} GiB")
        out[name] = {"batch": B, "ms": ms, "peak_gib": peaks}
        del x
        torch.cuda.empty_cache()
    return out


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


# phase 2 of chip_smoke.py (phase_field), where K5 and K6 are still held
# since no main path launches them: Poseidon2/bn128's check's widest
# matrix (nnz rows) and its constraint rows, at CHECK_LANES lanes
K56_LANES = 8192


def k5(libs, dev, reps):
    """K5 and K6 at phase 2's shapes, each launch bit for bit against the
    other checkout's: K5 on (nnz, 16, 8,192) random canonical operands by
    an (nnz, 16, 1) coefficient column broadcast over the lanes, K6's add
    and subtract on two (n_rows, 16, 8,192), for Poseidon2/bn128's R1CS
    (nnz its widest matrix's entries, n_rows its constraints)."""
    spec = field_spec("bn128")
    field = TorchField(spec, dev)
    L, B = spec.n_limbs, K56_LANES
    rows = compile_source(poseidon2_source()).r1cs_rows()
    nnz = max(sum(len(r[m]) for r in rows) for m in range(3))
    gen = torch.Generator(device=dev).manual_seed(12)
    a = canonical(gen, spec, (nnz, L, B), dev)
    c = canonical(gen, spec, (nnz, L, 1), dev).expand(nnz, L, B)
    x = canonical(gen, spec, (len(rows), L, B), dev)
    y = canonical(gen, spec, (len(rows), L, B), dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = build.u32_array(field.p_list)
    out = {}
    for op, code, u, v in (("mont_mul", 0, a, c), ("add", 1, x, y),
                           ("sub", 2, x, y)):
        N = u.shape[0]
        outs = {k: torch.empty(u.shape, dtype=torch.uint32, device=dev)
                for k in ("other", "this")}
        args = (code, L, u.data_ptr(), build.ll_array(u.stride()),
                v.data_ptr(), build.ll_array(v.stride()))
        fns = {tag: (lambda tag=tag: checked(
            libs[tag, "field_ops"].ctpu_field_elementwise(
                *args, outs[tag].data_ptr(), N, B, p, field.n0inv,
                field.n0inv32, stream), f"{tag} {op}")) for tag in outs}
        ms = in_turns(fns, reps)
        if not torch.equal(outs["this"].view(torch.int32),
                           outs["other"].view(torch.int32)):
            raise SystemExit(f"{op} {tuple(u.shape)}: the two versions "
                             "differ")
        nbytes = 4 * L * (N * B * 3 if op != "mont_mul" else N * (2 * B + 1))
        for k, v2 in ms.items():
            print(f"  {'K5' if op == 'mont_mul' else 'K6 ' + op} "
                  f"{tuple(u.shape)} {k}: {v2[0]:.4f}, {v2[1]:.4f} ms "
                  f"({nbytes / (sum(v2) / 2) / 1e6:.0f} GB/s)")
        out[op] = {"shape": list(u.shape), "bytes": nbytes, "ms": ms}
        del outs
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
        x = to_device(sha256_io.input_rows(msgs, spec.n_limbs), dev)
        corrupt = ((600, 1), (5000, B // 2), (20000, B - 1), (27000, 7))
    wit = prog.run(x)
    for wire, lane in corrupt:
        wit.view(torch.int32)[wire, 0, lane] ^= 1
    return cc.r1cs_rows(), cc.counts()["n_wires"], spec, wit


def kc(libs, name, B, dev, reps):
    """KC on case `name` at batch B in one launch, the other checkout's and
    this one's: their first violated rows compared, then timed in
    turns."""
    rows, n_wires, spec, wit = kc_case(name, dev, B)
    checker = R1CSChecker(rows, n_wires, spec, device=dev)
    n = checker.n_rows
    stream = torch.cuda.current_stream(dev).cuda_stream
    rpc = kc_rows_per_chunk(n, B)
    firsts = {k: torch.full((B,), n, dtype=torch.int32, device=dev)
              for k in ("other", "this")}
    args = {k: kc_args(checker, wit, firsts[k], stream) for k in firsts}
    fns = {k: (lambda k=k: checked(libs[k, "check"].ctpu_r1cs_check(
        *args[k]), f"{k} KC")) for k in firsts}
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


def ks(libs, dev, reps):
    """KS of both checkouts on every KS_CASES shape at every width of
    KS_WIDTHS, in turns; {case: {"tag w<warps>": [ms, ms]}}."""
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
        for tag in ("other", "this"):
            lib = libs[tag, "scan"]
            for warps in KS_WIDTHS:
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


# K4's cases: (name, circuit: copies of Num2Bits(254) or "ops", the op
# circuit of every segment op, field, batch)
K4_CASES = (("S", 1, "bn128", 65536), ("S4", 4, "bn128", 65536),
            ("U", "ops", "bn128", 65536), ("Ug", "ops", "goldilocks", 65536))

# run in a child process with one checkout on its path: that checkout's
# K4 source for the circuit argv[1] (copies of Num2Bits(254), or "ops")
# at the field argv[2], on the segments, written to argv[3]
K4_SOURCE = """
import sys
from circom_tpu_torch.backend.torch_backend import WitnessProgram
from circom_tpu_torch.circuits.sources import (num2bits_source,
                                               segment_ops_source)
from circom_tpu_torch.compiler.pipeline import compile_source
from circom_tpu_torch.field.primes import field_spec
spec = field_spec(sys.argv[2])
cc = compile_source(segment_ops_source(spec.p.bit_length())
                    if sys.argv[1] == "ops"
                    else num2bits_source(254, int(sys.argv[1])),
                    prime=sys.argv[2])
prog = WitnessProgram(cc.build_tape()[0], spec, device="cpu",
                      mode="segments", input_ranges=cc.input_range_hints())
open(sys.argv[3], "w").write(prog.fused.source())
"""


def k4_program(circuit, prime, dev):
    """This checkout's segmented program of a K4 case, as K4_SOURCE
    builds the other's."""
    spec = field_spec(prime)
    cc = compile_source(
        segment_ops_source(spec.p.bit_length()) if circuit == "ops"
        else num2bits_source(254, circuit), prime=prime)
    return WitnessProgram(cc.build_tape()[0], spec, device=dev,
                          mode="segments",
                          input_ranges=cc.input_range_hints())


def k4_source(root, circuit, path, prime="bn128"):
    """The K4 source that the checkout at `root` generates for a circuit
    (copies of Num2Bits(254), or "ops") at `prime`, written to `path` by
    its own generator."""
    r = subprocess.run([sys.executable, "-c", K4_SOURCE, str(circuit),
                        prime, str(path)], cwd=root, capture_output=True,
                       text=True, env=dict(os.environ, PYTHONPATH=str(root)))
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
    """(the entry points of a generated K4 source, built by nvcc against
    the headers of the checkout at `root`, a library a segment in
    parallel (-DK4_SEG=s), into ab/ of the build directory; each
    segment's nvcc seconds and its kernel's registers as ptxas reports
    them)."""
    out_dir = build.build_dir() / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"{tag}.cu"
    src.write_text(text)
    n = len(re.findall(r'extern "C" int ctpu_k4_seg\d+\(', text))
    nvcc = build.nvcc_path()
    inc = Path(root) / "circom_tpu_torch" / "ops" / "cuda"

    def one(s):
        so = out_dir / f"{tag}-s{s}.so"
        t0 = time.perf_counter()
        r = subprocess.run([nvcc, *build.NVCC_FLAGS, f"-DK4_SEG={s}", "-I",
                            str(inc), "-o", str(so), str(src)],
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
        if r.returncode:
            raise SystemExit(f"nvcc failed on {tag} segment {s}:\n{r.stdout}")
        regs = re.findall(r"Compiling entry function '[^']*k4_seg[^']*'.*?"
                          r"Used (\d+) registers", r.stdout, flags=re.S)
        return so, {"nvcc_s": time.perf_counter() - t0,
                    "registers": int(regs[0]) if regs else None}

    with ThreadPoolExecutor(max_workers=n) as pool:
        built = list(pool.map(one, range(n)))
    fns = []
    for s, (so, _info) in enumerate(built):
        fn = getattr(ctypes.CDLL(str(so)), f"ctpu_k4_seg{s}")
        fn.restype = _I
        fn.argtypes = [_P] * 3 + [_LL, _P]
        fns.append(fn)
    return fns, [info for _so, info in built]


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

    gen = torch.Generator(device=dev).manual_seed(17)
    stream = build.stream_ptr(dev)
    out_dir = build.build_dir() / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    progs, jobs = {}, []
    for name, circuit, prime, _B in K4_CASES:
        prog = progs[name] = k4_program(circuit, prime, dev)
        text = k4_source(Path(other).resolve(), circuit,
                         out_dir / f"other-{name}.txt", prime)
        if k4_stacked(text):
            raise SystemExit(f"the K4 of {other} is older than 0844d12's")
        if k4_segments(text) != [(len(g.instrs), len(g.src),
                                  len(g.dst))
                                 for g in prog.fused.kernels]:
            raise SystemExit(f"K4 on {name}: the other checkout cuts "
                             "other segments")
        jobs.append((name, text))
    # both checkouts' sources built by build_k4 at once, a library a
    # segment, for their nvcc seconds and registers side by side; this
    # checkout's runs launch its own build (build_all, cached by text)
    with ThreadPoolExecutor(2 * len(jobs) + 1) as pool:
        mine = pool.submit(build.build_all, [
            (p.fused.source(), len(p.fused.kernels)) for p in progs.values()])
        theirs = {name: pool.submit(build_k4, other, text, f"k4-{name}")
                  for name, text in jobs}
        ours = {name: pool.submit(build_k4, ROOT, progs[name].fused.source(),
                                  f"k4-this-{name}") for name, _t in jobs}
        print(f"  this checkout's K4 built in {mine.result():.1f} s")
        theirs = {k: f.result() for k, f in theirs.items()}
        ours = {k: f.result()[1] for k, f in ours.items()}
    result = {}
    for (name, _circuit, _prime, B), (_n, text) in zip(K4_CASES, jobs):
        prog, (fns, their_info) = progs[name], theirs[name]
        for tag, info in (("other", their_info), ("this", ours[name])):
            print(f"  K4 {name} nvcc {tag}: " + ", ".join(
                f"segment {s} {g['nvcc_s']:.1f} s, {g['registers']} "
                "registers" for s, g in enumerate(info)))
        sp = prog.fused
        x = canonical(gen, prog.spec, (prog.n_inputs, sp.L, B), dev)
        want = prog.run(x)
        wit_o = torch.empty_like(want)
        cross_o = torch.empty((sp.n_cross, sp.L, B), dtype=torch.uint32,
                              device=dev)

        def other_bare(fns=fns, wit_o=wit_o, cross_o=cross_o, B=B):
            for s in range(len(fns)):
                checked(fns[s](x.data_ptr(), wit_o.data_ptr(),
                               cross_o.data_ptr(), B, stream), "K4")

        def other_run(fns=fns, want=want, cross_o=cross_o, B=B):
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
        result[name] = {"segments": len(sp.kernels), "bare_ms": bare,
                        "run_ms": runs, "peak_gib": peaks,
                        "nvcc": {"other": their_info, "this": ours[name]}}
        for what, t in (("bare K4", bare), ("run", runs)):
            for k, v in t.items():
                print(f"  K4 {name} ({B} lanes) {what} {k}: "
                      + ", ".join(f"{m:.4f}" for m in v) + " ms")
        print(f"  K4 {name} peak allocation of a run: other "
              f"{peaks['other']:.3f} GiB, this {peaks['this']:.3f} GiB")
        del x, wit, cross, wit_o, cross_o
        torch.cuda.empty_cache()
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the checkout to compare with")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--kernels", default="k1,k3,k2,k5,kc,ks,k4",
                    help="which comparisons to run, and so which sources "
                         "to build (default: all seven)")
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
    names = [n for k, n in (("k1", "interp"), ("k3", "gather"),
                            ("k2", "gather"),
                            ("k5", "field_ops"), ("kc", "check"),
                            ("ks", "scan")) if k in kernels]
    names = list(dict.fromkeys(names))
    if "k1" in kernels and "gather" not in names:
        names.append("gather")      # the whole runs' K2, K3 and KW
    refuse_older(args.other, names)
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
        iface = k1_interface(args.other)
        n_args = {"rows": 37, "split": 35}[iface]
        print(f"  the other K1 takes {n_args} arguments ({iface})")
        for name, B in K1_CASES:
            result[f"k1_{name}_{B}"] = k1(libs, name, B, dev, args.reps,
                                          iface)
            torch.cuda.empty_cache()
        if iface == "split" and not rows_k3(args.other):
            result["runs"] = interp_runs(libs, dev, max(2, args.reps // 2))
        else:
            print("  the whole runs need an other checkout whose K1 and K3 "
                  "take the split inputs")
    if "k3" in kernels:
        result["k3_M"] = k3(libs, dev, args.reps, rows_k3(args.other))
        torch.cuda.empty_cache()
    if "k2" in kernels:
        result["k2"] = k2(libs, dev, args.reps)
        torch.cuda.empty_cache()
    if "k5" in kernels:
        result["k5_k6"] = k5(libs, dev, args.reps)
        torch.cuda.empty_cache()
    if "kc" in kernels:
        result["kc_P"] = kc(libs, "P", 65536, dev, args.reps)
        torch.cuda.empty_cache()
        result["kc_F"] = kc(libs, "F", 8192, dev, max(2, args.reps // 4))
        torch.cuda.empty_cache()
    if "ks" in kernels:
        result["ks"] = ks(libs, dev, args.reps)
    if "k4" in kernels:
        result["k4"] = k4(args.other, dev, args.reps)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
