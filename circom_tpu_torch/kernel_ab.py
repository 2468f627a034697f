"""Time K2 and K5 against the same kernels built from another checkout.

    python -m circom_tpu_torch.kernel_ab --other DIR [--reps N]

DIR is the root of another checkout of this repository, for example an
earlier commit unpacked with `git archive`.  Its
circom_tpu_torch/ops/cuda/gather.cu and field_ops.cu are built beside
this checkout's, with the same nvcc flags, all four at once, and each
library's entry point is called through ctypes.  K2's entry point has
the same interface in both; the other checkout's K5 is taken to have the
16-bit K5's, without n0inv32:

    ctpu_field_elementwise(op, L, a, a_strides, b, b_strides, out, N, B,
                           p_limbs, n0inv, stream)

Both versions run on the same inputs, must agree bit for bit, and are
timed by CUDA events around their bare launches (no checks, outputs
allocated before), in turns: other, this, this, other.

- K2 at Poseidon2/bn128's plan shape (the plan's wd_src over a random
  bank of (n_bank_rows, 16, 65,536)), beside `index_select` of the same
  rows into the same output.
- K5 at every launch shape of one R1CS check of Poseidon2/bn128 (P) at
  batch 65,536 and of the SHA256 block over bn128 (F) at 8,192: the
  shapes are recorded from R1CSChecker.check itself, each distinct one
  timed on random canonical operands, and the check's K5 time is the sum
  over its launches.

Prints a line for each measurement, the card's name and power limit, and
a JSON object as the last line.  Exits 1 without a card.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

import torch

from .backend.checker import R1CSChecker
from .backend.torch_backend import WitnessProgram
from .circuits.gen_poseidon import generate
from .compiler.pipeline import compile_source
from .field.primes import LIMB_BITS, field_spec
from .ops import build
from .ops import field_kernels as fk
from .ops.field import TorchField

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("gather", "field_ops")
_P, _I, _LL, _U32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                     ctypes.c_uint32)
_PLL = ctypes.POINTER(ctypes.c_longlong)
_PU32 = ctypes.POINTER(ctypes.c_uint32)
OTHER_SIGNATURES = {
    "gather": build.SIGNATURES["gather"],
    "field_ops": {"ctpu_field_elementwise": (
        _I, [_I, _I, _P, _PLL, _P, _PLL, _P, _LL, _LL, _PU32, _U32, _P])},
}


def build_libraries(other):
    """{("this" | "other", name): ctypes library}, all four built by one
    nvcc each, at once, into circom_tpu_torch/_build/ab/."""
    out_dir = build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = build.nvcc_path()
    jobs = {}
    for tag, root in (("this", ROOT), ("other", Path(other).resolve())):
        src_dir = root / "circom_tpu_torch" / "ops" / "cuda"
        for name in NAMES:
            so = out_dir / f"{tag}-{name}.so"
            jobs[tag, name] = (so, subprocess.Popen(
                [nvcc, *build.NVCC_FLAGS, "-I", str(src_dir), "-o", str(so),
                 str(src_dir / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (tag, name), (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on the {tag} {name}.cu:\n{log}")
        for line in log.splitlines():
            if "registers" in line:
                print(f"  ptxas {tag} {name}: {line.strip()}")
        lib = ctypes.CDLL(str(so))
        sigs = (build.SIGNATURES if tag == "this" else OTHER_SIGNATURES)[name]
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
    """Counter of (a shape, a strides, b strides) over the K5 launches of
    one R1CSChecker.check of a batch of B, recorded at fk.launch without
    launching: K5's shapes do not depend on the values."""
    seen = Counter()
    real = fk.launch

    def record(name, field, a, b, out):
        if name == "mont_mul":
            seen[tuple(a.shape), a.stride(), b.stride()] += 1

    checker = R1CSChecker(rows, n_wires, spec, device=dev)
    z = torch.zeros((n_wires, spec.n_limbs, 1), dtype=torch.uint32,
                    device=dev).expand(-1, -1, B)
    fk.launch = record
    try:
        checker.check(z)
    finally:
        fk.launch = real
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
        fns = {
            "other": lambda: checked(libs["other", "field_ops"]
                                     .ctpu_field_elementwise(
                *args, outs["other"].data_ptr(), N, Bs, p, field.n0inv,
                stream), "other K5"),
            "this": lambda: checked(libs["this", "field_ops"]
                                    .ctpu_field_elementwise(
                *args, outs["this"].data_ptr(), N, Bs, p, field.n0inv,
                field.n0inv32, stream), "this K5"),
        }
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the checkout to compare with")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", torch.cuda.current_device())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    libs = build_libraries(args.other)
    result = {"card": card.strip(), "k2": k2(libs, dev, args.reps)}
    torch.cuda.empty_cache()
    pos = compile_source(generate((2,)) + "\ncomponent main = Poseidon2();\n")
    result["k5_P"] = k5(libs, "P", pos.r1cs_rows(),
                        pos.counts()["n_wires"], 65536, dev, args.reps)
    sha = compile_source(
        (ROOT / "circom_tpu_torch/circuits/sha256.circom").read_text()
        + "\ncomponent main = Sha256Block();\n")
    result["k5_F"] = k5(libs, "F", sha.r1cs_rows(),
                        sha.counts()["n_wires"], 8192, dev,
                        max(2, args.reps // 4))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
