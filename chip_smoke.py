"""Smoke test of the PyTorch/CUDA port on one card.

Builds the kernels from the sources in the checkout, holds every kernel
against its plain PyTorch version at the shapes of the main paths, drives
the main paths with the launch counts set to 0 just before each and read
just after, and runs the witness entry point on saved artifacts.  Any
mismatch exits non-zero.  The paths:

- Poseidon2 over bn128, batch 65,536: WitnessProgram.run, then the R1CS
  check of every lane (kernels K1a, K2, KC);
- SHA256 over bn128, batch 65,536: WitnessProgram.run_mixed, the mixed
  witness (K1b, K3), every lane's digest against hashlib;
- SHA256 over bn128, batch 8,192: the full-limb run and the R1CS check of
  every lane (K1b, KW, KC);
- bench_gpu.py's workloads in-process (phase BG): Poseidon2/bn128 at
  65,536, SHA256/bn128 run_mixed at 32,768, Poseidon2/goldilocks at 65,536
  and bigint-div/bn128 at 8,192 (K1a-K1d, K2, K3), each gated as the
  bench gates it, the CPU baseline, and the bench's record checked;
- Poseidon2 over goldilocks, batch 65,536: run and R1CS check (K1c with
  K1a, K2 and KC at L = 4);
- bigint-div over bn128, batch 8,192: run and R1CS check (K1d's long
  division);
- the stdlib comparators over bn128 (LessThan(64), LessEqThan(64),
  IsEqual() and Num2Bits(64)), batch 65,536: run and R1CS check (K1a,
  K1c, K1d, KW);
- the same comparators at each of the eight --prime fields, batch 65,536
  (phase P8): run (K1, KW), R1CS check of every lane, the edge lanes 0,
  1, p - 1 and p // 2 and random ones against the host calculator, K1
  against its plain executor on a slice; and, at the end of the smoke,
  Poseidon2 at the eight fields, batch 65,536 (K1, whose lazy dots
  subtract p up to three times at secq256r1, K2, KC: the same checks),
  MerkleInclusion(32) at goldilocks, secq256r1 and bls12381, batch
  16,384 (K1a-K1d in one launch, KW, KC; sampled lanes against the host
  and the native calculator; run_mixed, K1, K3 and K2, equal to run on
  every lane), SHA256 through the mixed path at the same three fields
  (phase P8n: run_mixed at 65,536, K1's narrow lane and K3, every digest
  against hashlib, K1 and K3 against their plain versions; the full-limb
  run and R1CS check at 8,192, K1, KW, KC, sampled lanes against the
  host and the native calculator, run_mixed's rows widened equal to
  run's), and KS on the scan tapes of circuits/sources.ks_tapes() at the
  eight fields, batch 8,192 (one launch a run, bit for bit against the
  step loop on the card; at goldilocks each tape's run and R1CS check
  timed end to end);
- Num2Bits(254) and 4 x Num2Bits(254) over bn128, batch 65,536, which
  the interpreter refuses: run on the segments (K4, one and four
  segments, each writing its rows of the witness in place) and R1CS
  check; a run's median ms, its peak allocation, and its device
  operations from the profiler, which must be each of K4's kernels once
  a run and nothing else;
- the op circuit (every op a segment holds) and LessThan(n) on the
  segments at each of the eight --prime fields, batch 65,536 (phase S8):
  run (K4) and R1CS check of every lane, the edge lanes and 16 more
  against the host calculator, K4 against its plain version on every
  segment, a run's median, idle share and profiled device operations,
  K4's time against its bounds, each segment's registers, spills and
  nvcc seconds;
- bigint-div + Num2Bits(254) of the quotient over bn128, batch 8,192,
  which both fused backends refuse: run straight-line (one launch of KS
  a run, no K5, K6 or plain field op) and R1CS check, bit for bit against
  the per-node path on the card (phase O);
- 16 x Num2Bits(254) over bn128 (9,415 ops, above the unroll threshold):
  on the scan executor (one launch of KS a run) at batch 8,192, bit for
  bit against the per-node path of the same tape, both timed; and at
  65,536 with 8 and 64 slots a step, every lane checked (phase QS); KS at
  every width timed and held bit for bit against the step loop and the
  per-node path on the card (phase KS);
- MultiMiMC7(5) over bn128, batch 65,536 (K2), and MerkleInclusion(32)
  over Poseidon2/bn128, batch 16,384 (K1a and K1b in one K1 launch, KW
  for its wide rows and pathIndex bits): run and R1CS check, sampled
  lanes against the host and the native calculator;
- the compile CLI (python -m circom_tpu_torch.cli --witness-gpu) on both
  circuits and on bigint-div + Num2Bits(254) (the scan), with --prime
  secq256r1 on Poseidon2, and with --prime goldilocks on Poseidon2 and
  MerkleInclusion(2) (phase CLg; each .wtns against the native and the
  host calculator's), each
  circuit's witness step also in this process (K2, KW or one KS launch,
  and the check), and the native calculator's witnesses/s on this host
  beside the card's (the CPU baseline);
- MerkleInclusion(32) over Poseidon2/bn128 at 65,536 witnesses split
  over four shards of 16,384 (parallel/mesh.py: cuda:0..3 where there
  are four cards, else four shards on cuda:0): every shard's witness,
  the R1CS check of every lane, sampled lanes of every shard against the
  native and the host calculator (phase MS);
- two coordinated processes (python -m circom_tpu_torch.parallel.multihost
  --spawn 2 --device cuda) on the scan, exact parity, an all-reduced
  verdict and one KS launch a shard (phase MH), and the entry points
  entry() and dryrun_multichip()
  (circom_tpu_torch/entry.py, phase GE).

Unit plans hold every K1b, K1c and K1d opcode at the edge operands
against its plain version, and K1 is held against the plain executor on
every path's full plan, K1 and K3 reading the caller's input rows where
they lie and their plain versions the split of the same rows (K3 also on
rows of 1, 2 and 16 limbs); each interpreter path (P, M, F, G, D, C, MM,
MK) prints a run's median ms, its peak allocation and its profiled
device operations, which must be its own kernels once a run (K1, then KW
or K2; M: K1 and K3) and nothing else; K4 is held against its plain
version on every segment of the segmented paths and on the op circuits
that reach every op a segment can hold, at every --prime field. KC, the
R1CS check of every path, is held against the check's plain route on
Poseidon2's 65,536 lanes and SHA256's 8,192 in one launch each, a SHA256
window read in place, random constraint systems at five fields and the
accumulators' worst-case rows (phase KC); every checked path's check is
one KC launch a batch (one a shard on the mesh) that copies nothing of
z. KW, the full-limb witness's assembly, is held against its plain
version (the parts route: K2, K3, the plain widening, index_put) on the
full-limb SHA256, comparators and MerkleInclusion(32) witnesses, and
timed against its byte bound beside that route (phase KW); a run of
those paths launches K1 and KW and neither K2 nor K3. Every path's
sampled lanes equal the host calculator.

    python3 chip_smoke.py            # needs a CUDA card
    python3 chip_smoke.py --rehearse # CPU, small batch, plain versions only;
                                     # exits 3 and prints no result
    python3 chip_smoke.py --multicard  # phases MS and MH alone, on every
                                       # card (a call on four cards)

The second-to-last line is the kernels JSON, the last line
{"ok": true, "device": {...}}.
"""

import argparse
import json
import os
import random
import re
import subprocess
import sys
import tempfile
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

try:
    import numpy as np
    import torch

    from circom_tpu_torch.backend.artifacts import save_program
    from circom_tpu_torch.backend.checker import (R1CSChecker, kc_args,
                                                  kc_products,
                                                  kc_rows_per_chunk)
    from circom_tpu_torch.backend.interp import (gather_n, gather_w,
                                                 interp_k1, k1_plain,
                                                 launch_gather_n,
                                                 launch_gather_w, launch_k1,
                                                 narrow_inputs, split_inputs)
    from circom_tpu_torch.backend.interp_ref import gather_n_rows, gather_rows
    from circom_tpu_torch.backend.ks import KS_WIDTHS, launch_scan
    from circom_tpu_torch.backend.torch_backend import WitnessProgram
    from circom_tpu_torch.circuits import sha256_io
    from circom_tpu_torch.backend.segments import (UNWRITTEN,
                                                   SegmentedProgram,
                                                   launch_k4, segment_k4,
                                                   segment_ref)
    from circom_tpu_torch.circuits.gen_poseidon import generate
    from circom_tpu_torch.circuits.sources import (BIGINT_DIV_SRC,
                                                   bigdiv_num2bits_source,
                                                   comparator_inputs,
                                                   comparators_source,
                                                   kc_extreme_r1cs, ks_tapes,
                                                   lessthan_source,
                                                   merkle_source, mimc_source,
                                                   num2bits_source,
                                                   poseidon2_source,
                                                   random_r1cs,
                                                   segment_ops_source)
    from circom_tpu_torch.compiler.pipeline import compile_source
    from circom_tpu_torch.convert import (K1B_OPCODES, K1C_OPCODES,
                                          K1D_OPCODES, input_rows,
                                          narrow_unit_arrays,
                                          plan_from_arrays, to_device,
                                          unit_arrays, unit_inputs,
                                          unit_shifts)
    from circom_tpu_torch.emit.binfmt import write_wtns
    from circom_tpu_torch.entry import dryrun_multichip, entry
    from circom_tpu_torch.witness import batch_witnesses
    from circom_tpu_torch.field.primes import FieldSpec, field_spec
    from circom_tpu_torch import native
    from circom_tpu_torch.native import NativeCalculator
    from circom_tpu_torch.ops import build
    from circom_tpu_torch.ops import field_kernels as fk
    from circom_tpu_torch.ops.field import (GOLDILOCKS_P, TorchField, as_i64,
                                            as_u32, mont_edge_values)
    from circom_tpu_torch.ops.limbs import (int_to_limbs, ints_to_limbs,
                                            limbs_to_int)
    from circom_tpu_torch.ops.narrow import NARROW_OPS, widen_narrow
    from circom_tpu_torch.parallel.mesh import (make_mesh, shard_checker,
                                                shard_program)
    from circom_tpu_torch.utils.profiling import (profile_breakdown,
                                                  sync_all, wall_ms)
    from circom_tpu_torch.utils.roofline import (HBM_BYTES_PER_S,
                                                 INT_OPS_PER_SM_CLOCK,
                                                 k1_ops, ks_bytes, ks_ops,
                                                 kw_bytes, lane_ops_per_s)

    import bench_gpu
except ImportError as e:
    print(f"chip_smoke: the port is not importable here ({e})",
          file=sys.stderr)
    sys.exit(2)

# The peak rate of 32-bit integer instructions, which main() reads off the
# card (utils/roofline.lane_ops_per_s).  Until then (and in a CPU
# rehearsal, which keeps no number), an H100 SXM's 132 SMs at 1,980 MHz.
LANE_OPS_PER_S = INT_OPS_PER_SM_CLOCK * 132 * 1980e6

BATCH = 65536
BIGDIV_BATCH = 8192     # bench.py's bigint-div batch
SHA_FULL_BATCH = 8192   # the full-limb SHA256 witness: 14.3 GB at 8,192
SHA_PLAIN_BATCH = 4096  # K1b and K3 against the plain versions, all rows
CHECK_LANES = 8192      # the plain route's window of Poseidon2's check
SAMPLE_LANES = 64
CHECK_RUNS = 7          # a check's host-clock median: of this many checks
SHA_HOST_LANES = 4      # the host calculator takes ~4 s a SHA256 lane
MM_BATCH = 65536
MK_BATCH = 16384        # a Merkle(32) lane holds ~1.4 MB: bank and witness
MK_HOST_LANES = 4       # the host calculator takes ~3 s a Merkle(32) lane
K1_PLAIN_LANES = 4096   # K1 against the plain executor on MM's and MK's plans
CLI_WITNESSES = 64
BASELINE_WITNESSES = 4096
BASELINE_REPS = 5       # the native calculator's runs; their median is kept
MS_SHARDS = 4           # phase MS: MerkleInclusion(32) at 4 x 16,384 lanes
MS_LANES = 16384
MH_TIMEOUT = 240        # seconds for phase MH's two processes
EDGE_COUNTS = (0, 1, 31, 32, 33, -1)
SEED = 7
# K5 and K6 sub: the R1CS check launched them before KC, and on the
# interpreter and segment paths nothing else does, so there they must not
# launch
K5_K6 = ("mont_mul", "sub")
# K2 and K3: a full-limb run whose witness KW assembles launches neither
KW_NEVER = ("gather_w", "gather_n")
KW_SOURCE = "circom_tpu_torch/ops/cuda/gather.cu"
KW_REPLACES = "circom_tpu/backend/interp.py:2200"
# the card's name and power limit (nvidia-smi), beside each new case of
# phase P8
CARD = "no card (a CPU rehearsal)"


T0 = time.perf_counter()


def say(*a):
    """Print a line at once; a phase's title with the script's seconds."""
    if a and str(a[0]).startswith("phase"):
        a = a + (f"[{time.perf_counter() - T0:.1f} s]",)
    print(*a, flush=True)


def time_ms(fn, reps=5):
    """Mean ms of fn() on the card (CUDA events, after one warm-up)."""
    fn()
    if not torch.cuda.is_available():
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bare(dev, launch, wrapper):
    """A kernel's bare launch (no checks, output given) on the card, or
    its wrapper, which runs the plain version, in a CPU rehearsal."""
    return launch if dev.type == "cuda" else wrapper


def bounds(nbytes, ops):
    """The least time of a kernel's work, ms: (its bytes over HBM3's rate,
    its 32-bit integer instructions over the card's peak rate)."""
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / LANE_OPS_PER_S * 1e3


def bound(nbytes, ops):
    t_bytes, t_ops = bounds(nbytes, ops)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def segments(dev):
    """The device memory segments PyTorch's caching allocator has
    allocated with cudaMalloc so far; 0 on the CPU."""
    if dev.type != "cuda":
        return 0
    return torch.cuda.memory_stats(dev).get("segment.all.allocated", 0)


def max_abs_err(x, y, rows=1024):
    """Largest |x - y| over integer tensors, taken in slices of `rows`
    rows so that the int64 copies stay small."""
    err = 0
    for s in range(0, x.shape[0], rows):
        d = (as_i64(x[s:s + rows]) - as_i64(y[s:s + rows])).abs()
        if d.numel():
            err = max(err, int(d.max()))
    return err


def canonical_np(rng, spec, shape):
    """Random canonical field elements as uint32 limbs (*shape[:-2], L, B),
    a numpy array: random 16-bit limbs below a top limb under p's."""
    L = spec.n_limbs
    top = spec.p >> (16 * (L - 1))
    x = rng.integers(0, 1 << 16, size=shape, dtype=np.uint32)
    x[..., L - 1, :] = rng.integers(0, top, size=x[..., L - 1, :].shape,
                                    dtype=np.uint32)
    return x


def canonical_limbs(rng, spec, shape, device):
    return to_device(canonical_np(rng, spec, shape), device)


def random_int32(rng, shape, device):
    v = rng.integers(-2 ** 31, 2 ** 31, size=shape)
    v.reshape(-1)[:4] = (-2 ** 31, -1, 0, 2 ** 31 - 1)
    return to_device(v.astype(np.int32), device)


class Report:
    def __init__(self):
        self.rows = {}

    def add(self, name, source, replaces, err, ms, plain_ms, nbytes, ops,
            library_ms=None, **extra):
        if err != 0:
            raise SystemExit(f"FAIL {name}: kernel differs from its plain "
                             f"version (max abs err {err})")
        b_ms, b_by = bound(nbytes, ops)
        t_bytes, t_ops = bounds(nbytes, ops)
        self.rows[name] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms,
            "bytes_bound_ms": t_bytes, "ops_bound_ms": t_ops, **extra}
        say(f"  {name}: bit-exact; {ms:.4f} ms (plain {plain_ms:.3f} ms, "
            f"bound {b_ms:.4f} ms by {b_by}; bytes {t_bytes:.4f}, "
            f"operations {t_ops:.4f}"
            + (f", library {library_ms:.4f} ms" if library_ms else "") + ")")


class Paths:
    """Launch counts of each main path, read around exactly its run."""

    def __init__(self, rehearse):
        self.rehearse = rehearse
        self.counts = {}

    def run(self, name, fn, must_launch, never=()):
        sync_all()
        build.reset_launches()
        out = fn()
        sync_all()
        self.counts[name] = dict(build.LAUNCHES)
        say(f"  launches on the {name} path: {self.counts[name]}")
        for k in must_launch:
            if not self.rehearse and self.counts[name].get(k, 0) == 0:
                raise SystemExit(f"FAIL: {k} was not launched on the {name} "
                                 "path")
        for k in never:
            if self.counts[name].get(k, 0):
                raise SystemExit(f"FAIL: {k} was launched on the {name} "
                                 "path")
        return out

    def of(self, kernel):
        return {p: c.get(kernel, 0) for p, c in self.counts.items()}


def k5_ops(L):
    """32-bit integer instructions of K5 an element, counted low: 2 N^2
    32x32->64-bit products of CIOS in N = L/2 words, two instructions
    each (the low and the high word); the carries' adds are not
    counted."""
    return 2 * 2 * (L // 2) ** 2


def edge_operands(spec, dev):
    """(every pair of mont_edge_values as (1, L, E^2) a and b, each edge
    as an (L, 1) column)."""
    L = spec.n_limbs
    edges = mont_edge_values(spec)
    pairs = [(x, y) for x in edges for y in edges]
    a = to_device(ints_to_limbs([x for x, _ in pairs], L).T[None], dev)
    b = to_device(ints_to_limbs([y for _, y in pairs], L).T[None], dev)
    cols = [to_device(ints_to_limbs([y], L).T.copy(), dev) for y in edges]
    return a, b, cols


def phase_field(rep, dev, nnz, n_rows, lanes):
    """K5 and K6 against TorchField at the shapes of the check's plain
    route (the plain versions of the per-op paths launch them on the
    card; no main path does), at
    goldilocks, bn128 and secq256r1 (p just under R = 2^256: the edge of
    the conditional subtract): random canonical operands, the edge
    operands of mont_edge_values (every pair, and each edge as a column
    on either side), and the per-op path's shapes: (L, B) against a
    constant column (L, 1) on either side (the R^2 and 1 of mul_norm,
    to_mont and from_mont, the 0 of neg) and against (L, B).  K5 is timed
    by CUDA events around its launch alone."""
    rng = np.random.default_rng(SEED)
    for prime in ("bn128", "goldilocks", "secq256r1"):
        spec = field_spec(prime)
        L = spec.n_limbs
        f = TorchField(spec, dev)
        a = canonical_limbs(rng, spec, (nnz, L, lanes), dev)
        c = canonical_limbs(rng, spec, (nnz, L, 1), dev)
        x = canonical_limbs(rng, spec, (n_rows, L, lanes), dev)
        y = canonical_limbs(rng, spec, (n_rows, L, lanes), dev)
        got = {"mont_mul": fk.mont_mul(f, a, c), "add": fk.add(f, x, y),
               "sub": fk.sub(f, x, y)}
        want = {"mont_mul": f.mont_mul(a, c), "add": f.add(x, y),
                "sub": f.sub(x, y)}
        sync_all()
        err = {name: max_abs_err(got[name], want[name]) for name in got}
        ea, eb, ecols = edge_operands(spec, dev)
        err["mont_mul"] = max([err["mont_mul"], max_abs_err(
            fk.mont_mul(f, ea, eb), f.mont_mul(ea, eb))]
            + [max_abs_err(fk.mont_mul(f, *o), f.mont_mul(*o))
               for k in ecols for o in ((ea, k), (k, ea))])
        if any(err.values()):
            raise SystemExit(f"FAIL K5/K6 at {prime}: max abs err {err}")
        say(f"  K5/K6 {prime}: mont_mul {tuple(a.shape)}x{tuple(c.shape)}, "
            f"add/sub {tuple(x.shape)} bit-exact; mont_mul on "
            f"{len(ecols)} edge operands, every pair and each as a column "
            "on either side, bit-exact")
        u = canonical_limbs(rng, spec, (L, lanes), dev)
        v = canonical_limbs(rng, spec, (L, lanes), dev)
        cols = [canonical_limbs(rng, spec, (L, 1), dev),
                as_u32(f.R2_limbs), as_u32(f.one_limbs),
                torch.zeros((L, 1), dtype=torch.uint32, device=dev)]
        cases = [("mont_mul", u, k) for k in cols] \
            + [("mont_mul", k, u) for k in cols] \
            + [("sub", k, u) for k in cols] \
            + [("add", u, v), ("sub", u, v), ("add", u, cols[0])]
        for name, a1, b1 in cases:
            e = max_abs_err(getattr(fk, name)(f, a1, b1),
                            getattr(f, name)(a1, b1))
            if e:
                raise SystemExit(f"FAIL K5/K6 at {prime}: {name} "
                                 f"{tuple(a1.shape)}, {tuple(b1.shape)}: "
                                 f"max abs err {e}")
        say(f"  K5/K6 {prime} at the per-op shapes: mont_mul (L, {lanes}) x "
            f"(L, 1) both ways, sub (L, 1) - (L, {lanes}), add/sub (L, "
            f"{lanes}) on random, R^2, 1 and 0 columns: bit-exact")
        if prime != "bn128":
            continue
        e_mm, e_xy = nnz * lanes, n_rows * lanes
        out = torch.empty_like(a)
        ms = time_ms(bare(dev, lambda: fk.launch(
            "mont_mul", f, a, c.broadcast_to(a.shape), out),
            lambda: fk.mont_mul(f, a, c)), reps=20)
        nbytes, ops = 4 * (2 * e_mm * L + nnz * L), k5_ops(L) * e_mm
        say(f"  K5 at {tuple(a.shape)}x{tuple(c.shape)}: {ms:.4f} ms, "
            f"{nbytes / ms / 1e6:.0f} GB/s, {ops / ms / 1e9:.2f} T lane "
            "operations/s")
        # no main path launches K5 or K6: every per-op run is one KS
        # launch, every check one KC launch
        rep.add("mont_mul", "circom_tpu_torch/ops/cuda/field_ops.cu",
                "circom_tpu/ops/pallas_field.py:94", err["mont_mul"], ms,
                time_ms(lambda: f.mont_mul(a, c), reps=2), nbytes, ops,
                on_path="phase 2 only")
        for name in ("add", "sub"):
            rep.add(name, "circom_tpu_torch/ops/cuda/field_ops.cu",
                    "circom_tpu/ops/pallas_field.py:140", err[name],
                    time_ms(lambda: getattr(fk, name)(f, x, y)),
                    time_ms(lambda: getattr(f, name)(x, y), reps=2),
                    4 * 3 * e_xy * L, 0, on_path="phase 2 only")


# the base field of BLS12-381, 381 bits: KC's 24-limb instantiation (the
# compiler's bls12381 is the 255-bit scalar field, 16 limbs)
BLS12381_Q = int(
    "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f6241eab"
    "fffeb153ffffb9feffffffffaaab", 16)


def kc_bare(checker, zs, first):
    """KC's launch alone on the window zs into `first` (no checks, not
    counted): the C call its wrapper makes."""
    def launch():
        fn = build.library("check").ctpu_r1cs_check
        build.check_launch(fn(*kc_args(checker, zs, first, build.stream_ptr(
            zs.device))), "r1cs_check")
    return launch


def kc_work(checker, rows, zs):
    """KC's least work on the window zs when every lane satisfies every
    row: (bytes: z's window read once, the matrices, `first` written;
    32-bit integer instructions, two a product: by coefficient class
    (checker.kc_products, check.cu's count); and the count of a kernel
    that runs a CIOS (k5_ops) a nonzero and a row)."""
    b, L = zs.shape[-1], checker.field.L
    mats = sum(t.numel() * t.element_size() for m in checker.kc for t in m)
    nnz = sum(len(m[1]) for m in checker.coo)
    return (zs.shape[0] * L * b * 4 + mats + 4 * b,
            2 * kc_products(rows, checker.spec.p, L) * b,
            (nnz + checker.n_rows) * k5_ops(L) * b)


def kc_bounds(nbytes, ops, cios_ops):
    """KC's bound (ms, by) from its class-aware count, and the operation
    bound of the CIOS-a-nonzero count beside it."""
    b_ms, b_by = bound(nbytes, ops)
    return b_ms, b_by, bounds(nbytes, cios_ops)[1]


def plain_first(checker, z):
    """first_violated_plain over z in the plain route's windows
    (checker.lanes): one window of a whole batch would take 16 bytes a
    limb-lane of the largest matrix."""
    return torch.cat([checker.first_violated_plain(
        z[..., s:s + checker.lanes].contiguous())
        for s in range(0, z.shape[-1], checker.lanes)])


def kc_err(checker, zs, n_bad, label):
    """KC (one launch, zs read in place) and the plain route on the window
    zs: the largest difference of their first violated rows, which must
    flag n_bad lanes."""
    got = checker.first_violated(zs)
    want = plain_first(checker, zs)
    sync_all()
    err = max_abs_err(got, want)
    flagged = int((want < checker.n_rows).sum())
    if err or flagged != n_bad:
        raise SystemExit(f"FAIL KC {label}: max abs err {err} against the "
                         f"plain route, {flagged} lanes flagged, not {n_bad}")
    return err


def one_launch(paths, name, dev, n):
    """A path's check must be n KC launches on a card: one a batch (a
    shard's)."""
    got = paths.counts[name].get("r1cs_check", 0)
    if dev.type == "cuda" and got != n:
        raise SystemExit(f"FAIL: {got} r1cs_check launches on the {name} "
                         f"path, not {n} (one a batch)")


def flip(z, corrupt):
    """Flip bit 0 of limb 0 of each (wire, lane) of z, in place (twice
    restores z)."""
    for wire, lane in corrupt:
        z.view(torch.int32)[wire, 0, lane] ^= 1


def phase_kc(rep, cc, prog, inputs, sizes):
    """Phase KC: KC against the plain route (first_violated_plain, in its
    windows) on the card, bit for bit: Poseidon2/bn128 witnesses at the
    whole batch in one launch, good and with five lanes corrupted at
    different wires; random systems (circuits/sources.random_r1cs, 40
    rows of up to 8 terms a matrix) at bn128, goldilocks (L = 4),
    bls12381, the base field of BLS12-381 (L = 24) and secq256r1 (p just
    under R), at each lane count of `sizes`, corrupted lanes among good
    ones, with random_r1cs' default coefficients and with KC's six classes
    drawn evenly; and kc_extreme_r1cs's rows, the accumulators' worst
    case, at each field.  KC is timed around its bare launch
    on the good Poseidon2 batch, where every lane checks every row, and
    the plain route on the same batch."""
    dev, spec = prog.device, prog.spec
    rows = cc.r1cs_rows()
    checker = R1CSChecker(rows, cc.counts()["n_wires"], spec, device=dev)
    wit = prog.run(inputs)
    B = wit.shape[-1]
    corrupt = ((3, 2), (40, 3), (150, 4), (322, 5), (100, B - 1))
    flip(wit, corrupt)
    err = kc_err(checker, wit, len(corrupt), "Poseidon2/bn128, corrupted")
    flip(wit, corrupt)
    first = torch.full((B,), checker.n_rows, dtype=torch.int32, device=dev)
    ms = time_ms(bare(dev, kc_bare(checker, wit, first),
                      lambda: checker.first_violated(wit)), reps=20)
    if int((first < checker.n_rows).sum()):
        raise SystemExit("FAIL KC: a good Poseidon2 lane flagged")
    plain_ms = time_ms(lambda: plain_first(checker, wit), reps=1)
    nbytes, ops, cios_ops = kc_work(checker, rows, wit)
    b_ms, b_by, cios_ms = kc_bounds(nbytes, ops, cios_ops)
    say(f"  KC on Poseidon2/bn128 at {tuple(wit.shape)}, one launch: "
        f"bit-exact, good and with {len(corrupt)} lanes corrupted; "
        f"{ms:.4f} ms a launch ({kc_rows_per_chunk(checker.n_rows, B)} rows "
        f"a block); bound {b_ms:.4f} ms by {b_by} ({ops // B} instructions "
        f"a lane by class; {cios_ops // B} and {cios_ms:.4f} ms as a CIOS "
        "a nonzero and a row)")
    del wit
    primes = [field_spec(n) for n in ("bn128", "goldilocks", "bls12381",
                                      "secq256r1")]
    primes.insert(3, FieldSpec("bls12381_base", BLS12381_Q))
    for k, sp in enumerate(primes):
        for classes in (False, True):
            for b in sizes:
                rows_k, z = random_r1cs(sp, 8, 40, 8, b, seed=SEED + 40 + k,
                                        classes=classes)
                bad_lanes = range(1, b, 37)
                for j, lane in enumerate(bad_lanes):
                    z[9 + j % 40, j % sp.n_limbs, lane] ^= 1 << (j % 16)
                chk = R1CSChecker(rows_k, z.shape[0], sp, device=dev)
                err = max(err, kc_err(chk, to_device(z, dev),
                                      len(bad_lanes),
                                      f"{sp.name} at {b} lanes"))
        rows_k, z = kc_extreme_r1cs(sp, sizes[0])
        chk = R1CSChecker(rows_k, z.shape[0], sp, device=dev)
        err = max(err, kc_err(chk, to_device(z, dev), sizes[0] - 2,
                              f"{sp.name}'s extreme rows"))
        say(f"  KC at {sp.name} (L = {sp.n_limbs}): 40 random rows (the "
            f"default coefficients, and the six classes) at "
            f"{', '.join(map(str, sizes))} lanes, corrupted lanes among "
            f"them, and the extreme rows at {sizes[0]} lanes, bit-exact")
    rep.add("r1cs_check", "circom_tpu_torch/ops/cuda/check.cu",
            "circom_tpu/backend/checker.py:97", err, ms, plain_ms, nbytes,
            ops, plan="Poseidon2/bn128", shape=[cc.counts()["n_wires"],
                                                spec.n_limbs, B],
            rows_per_chunk=kc_rows_per_chunk(checker.n_rows, B),
            cios_ops_bound_ms=cios_ms)


def phase_kc_sha(rep, checker, rows, wit):
    """Phase KC on SHA256's full-limb witness (phase D): KC over all its
    lanes in one launch against the plain route (in its 260-lane windows),
    with lanes corrupted (in place, then restored); and a window of
    checker.lanes lanes read in place (its batch stride passed) against
    the plain route on a contiguous copy of the same lanes.  KC is timed
    around its bare launch over the batch and over the window."""
    dev, B = wit.device, wit.shape[-1]
    corrupt = ((600, 1), (5000, B // 2), (20000, B - 1))
    flip(wit, corrupt)
    err = kc_err(checker, wit, len(corrupt), "SHA256, corrupted")
    b = min(checker.lanes, B)
    s0 = max(0, B // 2 - b // 2)
    win = wit[..., s0:s0 + b]
    got = checker.first_violated(win)
    want = checker.first_violated_plain(win.contiguous())
    sync_all()
    err = max(err, max_abs_err(got, want))
    n_bad = sum(s0 <= lane < s0 + b for _w, lane in corrupt)
    if err or int((want < checker.n_rows).sum()) != n_bad:
        raise SystemExit(f"FAIL KC on SHA256's window: max abs err {err}")
    flip(wit, corrupt)
    first = torch.full((B,), checker.n_rows, dtype=torch.int32, device=dev)
    ms = time_ms(bare(dev, kc_bare(checker, wit, first),
                      lambda: checker.first_violated(wit)), reps=5)
    win = wit[..., s0:s0 + b]
    first_w = torch.full((b,), checker.n_rows, dtype=torch.int32,
                         device=dev)
    win_ms = time_ms(bare(dev, kc_bare(checker, win, first_w),
                          lambda: checker.first_violated(win)), reps=10)
    if int((first < checker.n_rows).sum()) + int(
            (first_w < checker.n_rows).sum()):
        raise SystemExit("FAIL KC: a good SHA256 lane flagged")
    plain_ms = time_ms(lambda: checker.first_violated_plain(
        win.contiguous()), reps=1)
    nbytes, ops, cios_ops = kc_work(checker, rows, wit)
    b_ms, b_by, cios_ms = kc_bounds(nbytes, ops, cios_ops)
    w_ms, w_by, w_cios_ms = kc_bounds(*kc_work(checker, rows, win))
    rep.rows["r1cs_check"].update({
        "sha_shape": list(wit.shape), "sha_ms": ms, "sha_bound_ms": b_ms,
        "sha_bound_by": b_by, "sha_cios_ops_bound_ms": cios_ms,
        "sha_rows_per_chunk": kc_rows_per_chunk(checker.n_rows, B),
        "sha_window": [s0, b], "sha_window_ms": win_ms,
        "sha_window_plain_ms": plain_ms, "sha_window_bound_ms": w_ms,
        "sha_window_cios_ops_bound_ms": w_cios_ms})
    say(f"  KC on SHA256 {tuple(wit.shape)}, one launch: bit-exact, with "
        f"{len(corrupt)} lanes corrupted; {ms:.3f} ms (bound {b_ms:.4f} ms "
        f"by {b_by}, {ops // B} instructions a lane by class; {cios_ops // B}"
        f" and {cios_ms:.3f} ms as a CIOS a nonzero and a row); the window "
        f"[{s0}, {s0 + b}) read in place: bit-exact, {win_ms:.4f} ms (bound "
        f"{w_ms:.4f} ms by {w_by}; the plain route on its copy "
        f"{plain_ms:.1f} ms)")


def phase_gather(rep, plan, B, dev):
    """K2 against the plain gather: on a random bank of P's plan shape
    with the plan's indices (16 bytes a thread), at B - 3 lanes (rows not
    a multiple of 16 bytes: 4 bytes a thread), at W = 1, and on a bank 4
    bytes off 16-byte alignment (4 bytes a thread).  K2's launch and
    index_select of the same rows into the same output are timed by CUDA
    events, in turns."""
    rng = np.random.default_rng(SEED + 1)
    L = plan.L
    bank = to_device(rng.integers(0, 1 << 16, size=(plan.n_bank_rows, L, B),
                                  dtype=np.uint32), dev)
    idx = plan.dev["wd_src"]
    W = idx.shape[0]
    err = max_abs_err(gather_w(bank, idx), gather_rows(bank, idx))
    odd = bank[..., :max(B - 3, 1)].contiguous()
    b_m = min(1000, B - 1)
    flat = bank.view(-1)[1:1 + plan.n_bank_rows * L * b_m]
    cases = [(odd, idx), (bank, idx[:1]),
             (flat.view(plan.n_bank_rows, L, b_m), idx)]
    for bk, ix in cases:
        err = max(err, max_abs_err(gather_w(bk, ix), gather_rows(bk, ix)))
    del odd, flat
    say(f"  K2: {W} rows of {tuple(bank.shape)}, of {B - 3} lanes, 1 row, "
        f"and {W} rows of a misaligned bank: max abs err {err}")
    out = torch.empty((W, L, B), dtype=torch.uint32, device=dev)
    bank_i, out_i = bank.view(torch.int32), out.view(torch.int32)
    idx_l = idx.to(torch.int64)
    k2, sel = [], []
    for _ in range(2):
        k2.append(time_ms(bare(dev, lambda: launch_gather_w(bank, idx, out),
                               lambda: gather_w(bank, idx)), reps=20))
        sel.append(time_ms(lambda: torch.index_select(bank_i, 0, idx_l,
                                                      out=out_i), reps=20))
    nbytes = 4 * 2 * W * L * B
    ms, lib_ms = sum(k2) / 2, sum(sel) / 2
    # the card's practical copy rate: the same bytes as one contiguous copy
    copy_ms = time_ms(lambda: out.copy_(bank[:W]), reps=20)
    say(f"  K2 {k2[0]:.4f}, {k2[1]:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s); "
        f"index_select {sel[0]:.4f}, {sel[1]:.4f} ms, in turns; a "
        f"contiguous copy_ of the same bytes {copy_ms:.4f} ms "
        f"({nbytes / copy_ms / 1e6:.0f} GB/s)")
    rep.add("gather_w", "circom_tpu_torch/ops/cuda/gather.cu",
            "circom_tpu/backend/interp.py:2579", err, ms,
            time_ms(lambda: gather_rows(bank, idx)), nbytes, 0,
            library_ms=lib_ms, copy_ms=copy_ms)


def idle_of(profile):
    """The device's idle share of a run from profile_breakdown's (busy ms,
    wall ms, kernels, kernels by name)."""
    busy, ms, *_ = profile
    return round(max(0.0, 1 - busy / ms), 3)


def run_peak(dev, fn):
    """(fn()'s output, its ms by the host clock, the GiB it allocated at
    its peak beyond what was allocated before it; 0 on the CPU)."""
    if dev.type != "cuda":
        out, ms = wall_ms(fn)
        return out, ms, 0.0
    sync_all()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out, ms = wall_ms(fn)
    return out, ms, (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30


def phase_kw(prog, x, label):
    """Phase KW on one path's plan and inputs x: from the same K1 banks,
    KW's witness against its plain version, the parts route (K2, K3, the
    plain widening, index_put), bit for bit; KW's bare launch (output
    given) by CUDA events against its byte bound (utils/roofline.kw_bytes),
    the parts route's time, and index_select of as many bank rows into the
    same output for reference; then a run (K1 + KW, the path's) and K1
    followed by the parts route, each from the inputs: its ms and the
    memory it allocated at its peak.  Returns the numbers."""
    interp, dev, plan = prog.interp, prog.device, prog.interp.plan
    inputs, x_w, _ = interp._inputs(x)
    B = inputs.shape[-1]
    bank, bank_n = interp_k1(plan, prog.field, inputs)

    def parts():
        return interp.assemble_parts(inputs, x_w, bank, bank_n)

    got = bare(dev, lambda: interp.assemble_kw(inputs, bank, bank_n),
               parts)()
    want, first_parts_ms = wall_ms(parts)
    err = 0 if same_witness(got, want) else max(1, max_abs_err(got, want))
    del want
    kw_ms = time_ms(bare(dev, lambda: interp.assemble_kw(
        inputs, bank, bank_n, out=got), parts), reps=10)
    parts_ms = time_ms(parts, reps=3)
    W = got.shape[0]
    idx = torch.arange(W, device=dev) % bank.shape[0]
    bank_i, got_i = bank.view(torch.int32), got.view(torch.int32)
    sel_ms = time_ms(lambda: torch.index_select(bank_i, 0, idx, out=got_i),
                     reps=10)
    del got, bank, bank_n
    nbytes = kw_bytes(plan, B)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    say(f"  KW on {label}: {W} rows of ({plan.L}, {B}), max abs err {err} "
        f"against the parts route; KW {kw_ms:.4f} ms ({nbytes / 1e9:.3f} GB:"
        f" bound {t_bytes:.4f} ms, {t_bytes / kw_ms:.0%} of it); the parts "
        f"route {parts_ms:.3f} ms (first {first_parts_ms:.1f}); index_select"
        f" of {W} bank rows into the same output {sel_ms:.4f} ms")

    def parts_run():
        i, w, _ = interp._inputs(x)
        return interp.assemble_parts(i, w, *interp_k1(plan, prog.field, i))

    prog.run(x)
    _, run_ms, run_gib = run_peak(dev, lambda: prog.run(x))
    parts_run()
    _, old_ms, old_gib = run_peak(dev, parts_run)
    say(f"  {label} run: K1 + KW {run_ms:.2f} ms, allocating {run_gib:.2f} "
        f"GiB at its peak; the input split, K1 and the parts route "
        f"{old_ms:.2f} ms, {old_gib:.2f} GiB")
    return {"err": err, "ms": kw_ms, "plain_ms": parts_ms, "bytes": nbytes,
            "index_select_ms": sel_ms, "rows": W, "B": B, "run_ms": run_ms,
            "run_gib": run_gib, "parts_run_ms": old_ms,
            "parts_run_gib": old_gib}


def add_kw_row(rep, kw):
    """KW's row of the kernels line: F's shape first, MK's and C's beside
    it, the error the largest of the three."""
    f, mk, c = kw["sha256_full"], kw["merkle"], kw["comparators"]
    extra = {}
    for key, k in (("mk", mk), ("c", c)):
        extra.update({f"{key}_ms": k["ms"], f"{key}_plain_ms": k["plain_ms"],
                      f"{key}_bound_ms": bound(k["bytes"], 0)[0],
                      f"{key}_index_select_ms": k["index_select_ms"]})
    rep.add("assemble", KW_SOURCE, KW_REPLACES,
            max(k["err"] for k in (f, mk, c)), f["ms"], f["plain_ms"],
            f["bytes"], 0, plan="SHA256/bn128 full limbs",
            index_select_ms=f["index_select_ms"], **extra)


def k1_input_words(plan, lin):
    """The 32-bit words of input a lane that K1 must read: L a wide input,
    limbs 0 and 1 (limb 0 where Lin = 1) a narrow one."""
    return plan.L * len(plan.win_order) + min(lin, 2) * len(plan.nin_order)


def phase_interp(rep, prog, x):
    """K1a against the plain executor on the Poseidon2 plan, K1 reading
    the input rows x where they lie, the plain executor their split;
    emitted bank rows compared bit for bit after the trailing REDC."""
    plan, f = prog.interp.plan, prog.field
    B = x.shape[-1]
    got, _ = interp_k1(plan, f, x)
    (want, _), plain_ms = wall_ms(
        lambda: k1_plain(plan, f, *split_inputs(plan, x)))
    rows = torch.as_tensor(plan.emitted_rows(), device=x.device)
    err = max_abs_err(got.view(torch.int32).index_select(0, rows)
                      .view(torch.uint32), want.view(torch.int32)
                      .index_select(0, rows).view(torch.uint32))
    del want
    nbytes = 4 * B * (k1_input_words(plan, x.shape[1]) + plan.L * len(rows))
    rep.add("interp_k1a", "circom_tpu_torch/ops/cuda/interp.cu",
            "circom_tpu/backend/interp.py:2462", err,
            time_ms(lambda: interp_k1(plan, f, x), reps=3), plain_ms,
            nbytes, k1_ops(plan, f.p.bit_length()) * B,
            plan="Poseidon2/bn128")
    return got


def median_ms(fn, runs=CHECK_RUNS):
    """(median, least, most) ms of `runs` calls of fn by the host clock,
    one at a time."""
    ms = sorted(wall_ms(fn)[1] for _ in range(runs))
    return ms[len(ms) // 2], ms[0], ms[-1]


def witness_path(paths, name, cc, prog, inputs, must_launch, host_map,
                 never=(), n_lanes=SAMPLE_LANES, profile_check=False,
                 native=None, trace=None, rehearse=False):
    """One witness path: WitnessProgram.run at the inputs' batch, then the
    R1CS check of every lane (launch counts read around exactly this;
    kernels in `never` must not launch), a warm timed repeat, the check's
    median of CHECK_RUNS, and n_lanes sampled lanes against the host
    calculator (host_map: the lane's input ints -> the input map) and,
    given the circuit's NativeCalculator `native`, SAMPLE_LANES against
    it; with profile_check, where the check's device time goes (KC's
    share).  With `trace` (an interpreter path's label), interp_run's
    numbers ("trace"), then the check's median again: a profiler pass
    before a host-clock reading is seen in the two medians."""
    dev, spec = prog.device, prog.spec
    B = inputs.shape[-1]
    checker = R1CSChecker(cc.r1cs_rows(), cc.counts()["n_wires"], spec,
                          device=dev)

    def run_and_check():
        seg = segments(dev)
        wit, run_ms = wall_ms(lambda: prog.run(inputs))
        seg = segments(dev) - seg
        (ok, first_bad), check_ms = wall_ms(
            lambda: checker.check_detailed(wit))
        n_bad = int((~ok).sum())
        if n_bad:
            raise SystemExit(f"FAIL {name} R1CS check: {n_bad} of {B} lanes "
                             f"violate a constraint (first: "
                             f"{first_bad[~ok][:5].tolist()})")
        return wit, run_ms, check_ms, seg

    # the first run is the one counted; the second, warm, is timed, then
    # five more a run at a time without a check between them (each output
    # dropped at once), as bench_gpu.py times its runs
    paths.run(name, run_and_check, must_launch, never)
    one_launch(paths, name, dev, 1)
    wit, run_ms, check_ms, seg = run_and_check()
    again = sorted(wall_ms(lambda: prog.run(inputs))[1] for _ in range(5))
    check = median_ms(lambda: checker.check_detailed(wit))
    say(f"  witnesses: {tuple(wit.shape)} in {run_ms:.1f} ms "
        f"({B / run_ms * 1e3:.0f} witnesses/s, one run after a check; "
        f"{seg} device memory segments allocated in it); R1CS check of all "
        f"{B} lanes in {check_ms:.1f} ms, then {check[0]:.3f} ms (median of "
        f"{CHECK_RUNS}, {check[1]:.3f}-{check[2]:.3f}); then a run at a time "
        f"{again[2]:.3f} ms (median of 5, {again[0]:.3f}-{again[-1]:.3f})")
    out = {"run_ms": run_ms, "check_ms": check[0], "check_one_ms": check_ms}
    if profile_check and dev.type == "cuda":
        profile_check_breakdown(checker, wit, check_ms)
    if trace:
        out["trace"] = interp_run(prog, inputs, trace, rehearse)
        after = median_ms(lambda: checker.check_detailed(wit))
        say(f"  {trace}: R1CS check after the run's profiler pass "
            f"{after[0]:.3f} ms (median of {CHECK_RUNS}, "
            f"{after[1]:.3f}-{after[2]:.3f}), {check[0]:.3f} before it")
        out["check_after_trace_ms"] = after[0]
    native_lanes = SAMPLE_LANES if native else 0
    lanes = random.Random(SEED).sample(range(B),
                                       min(max(n_lanes, native_lanes), B))
    ins, got = lane_values(wit, inputs, lanes)
    check_host_lanes(cc, ins[:n_lanes], got, lanes, host_map, name)
    if native:
        want = native.run(ins[:native_lanes])
        for j, lane in enumerate(lanes[:native_lanes]):
            if got[j] != want[j][:len(got[j])]:
                raise SystemExit(f"FAIL {name} lane {lane}: witness differs "
                                 "from the native calculator")
        say(f"  {len(want)} sampled lanes equal the native calculator")
    return out


def poseidon2_path(paths, cc, spec, dev, B):
    """Poseidon2/bn128 witnesses at batch B, then the R1CS check of every
    lane; launch counts are read around exactly this."""
    prog = WitnessProgram(cc.build_tape()[0], spec, device=dev)
    rng = np.random.default_rng(SEED + 2)
    inputs = canonical_limbs(rng, spec, (prog.n_inputs, spec.n_limbs, B), dev)
    times = witness_path(paths, "poseidon2", cc, prog, inputs,
                         ("interp_k1a", "gather_w", "r1cs_check"),
                         lambda ins: {"inputs": ins}, never=K5_K6,
                         profile_check=True, trace="P",
                         rehearse=paths.rehearse)
    return prog, inputs, times


def phase_entry_point(cc, device, name, batch):
    """python -m circom_tpu_torch.witness on a saved artifact; the .wtns
    bytes must equal write_wtns of the host witness."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        art = os.path.join(tmp, f"{name}.tpu.json")
        save_program(cc, art)
        inp = os.path.join(tmp, "inputs.json")
        with open(inp, "w") as fh:
            json.dump(batch, fh)
        out = os.path.join(tmp, "out")
        r = subprocess.run([sys.executable, "-m", "circom_tpu_torch.witness",
                            art, inp, "-o", out, "--device", device],
                           cwd=ROOT, capture_output=True, text=True,
                           timeout=600)
        if r.returncode != 0:
            raise SystemExit(f"FAIL entry point on {name} (exit "
                             f"{r.returncode}):\n{r.stdout}\n{r.stderr}")
        for bi, raw in enumerate(batch):
            ref = os.path.join(tmp, f"ref.{bi}.wtns")
            write_wtns(ref, cc.p, list(cc.witness_host(raw)))
            with open(ref, "rb") as a, \
                    open(os.path.join(out, f"{name}.{bi}.wtns"), "rb") as b:
                if a.read() != b.read():
                    raise SystemExit(f"FAIL entry point on {name}: witness "
                                     f"{bi} .wtns differs from the host "
                                     "calculator's")
    say(f"  entry point: {len(batch)} {name} .wtns files equal the host "
        "calculator's")


def phase_narrow_units(dev, B):
    """Phase A: every K1b opcode at the edge shift counts (a unit plan,
    one step each, its narrow inputs read in two-limb input rows) and K3
    on random int32 values and on narrow inputs read in input rows of 1,
    2 and 16 limbs (limbs above 1 not zero), against ops/narrow.py, the
    plain split and the plain gather, bit for bit."""
    rng = np.random.default_rng(SEED + 4)
    arrays, cases = narrow_unit_arrays(16, EDGE_COUNTS)
    plan = plan_from_arrays(arrays, dev)
    f = TorchField(field_spec("bn128"), dev)
    x_n = random_int32(rng, (2, B), dev)
    x = to_device(input_rows(plan, np.zeros((0, 16, B), np.uint32),
                             x_n.cpu().numpy())[:, :2].copy(), dev)
    _, got = interp_k1(plan, f, x)
    a, b = as_i64(x_n)
    for t, (op, s) in enumerate(cases):
        want = NARROW_OPS[op](a, b, s)
        if not torch.equal(got[t].long(), want):
            raise SystemExit(f"FAIL K1b {op} by {s}: differs from "
                             "ops/narrow.py")
    say(f"  K1b: {len(K1B_OPCODES)} opcodes x shift counts {EDGE_COUNTS} "
        f"at batch {B} bit-exact")
    for b_ in (B, B + 3):   # vector and scalar paths of K3
        for lin in (2, 16, 1):
            bank_n = random_int32(rng, (300, b_), dev)
            xs = to_device(rng.integers(0, 1 << 16, size=(50, lin, b_),
                                        dtype=np.uint32), dev)
            order = to_device(rng.permutation(50)[:40].astype(np.int32), dev)
            src = to_device(rng.integers(0, 340, size=2000).astype(np.int32),
                            dev)
            shift = to_device(np.resize(np.asarray(EDGE_COUNTS, np.int32),
                                        2000), dev)
            x_n = narrow_inputs(xs, order)
            if not torch.equal(gather_n(bank_n, xs, order, src, shift),
                               gather_n_rows(bank_n, x_n, src, shift)):
                raise SystemExit(f"FAIL K3 at batch {b_}, {lin}-limb input "
                                 "rows: differs from the plain gather")
    say(f"  K3: 2,000 rows from bank and 40 narrow inputs read in input "
        f"rows of 2, 16 and 1 limbs, shifts {EDGE_COUNTS}, batch {B} and "
        f"{B + 3} bit-exact")


def phase_k1cd_units(dev, B):
    """Phase I: every K1c and K1d opcode, one step per case (bank row,
    shift count), on the edge operands of convert.unit_inputs, against the
    plain executor (ops/wide.py, ops/narrow.py), bit for bit: at bn128,
    and at goldilocks with its folded products."""
    err = 0
    for prime in ("bn128", "goldilocks"):
        spec = field_spec(prime)
        L = spec.n_limbs
        ops = K1D_OPCODES + (K1C_OPCODES if prime == "goldilocks"
                             else ("add",))
        arrays, cases = unit_arrays(spec.p, L, ops)
        plan = plan_from_arrays(arrays, dev)
        f = TorchField(spec, dev)
        x = to_device(input_rows(plan, *unit_inputs(spec.p, L, B, SEED + 8)),
                      dev)
        got_w, got_n = interp_k1(plan, f, x)
        want_w, want_n = k1_plain(plan, f, *split_inputs(plan, x))
        n_idx, w_idx = plan.nw_idx.tolist(), plan.wd_idx.tolist()
        for t, (op, aux) in enumerate(cases):
            if t in n_idx:
                r = int(plan.nw_src[n_idx.index(t)])
                e = max_abs_err(got_n[r:r + 1], want_n[r:r + 1])
            else:
                r = int(plan.wd_src[w_idx.index(t)])
                e = max_abs_err(got_w[r:r + 1], want_w[r:r + 1])
            if e:
                raise SystemExit(f"FAIL K1 {op} ({aux}) at {prime}: differs "
                                 f"from its plain version (max abs err {e})")
            err = max(err, e)
        say(f"  {prime}: {len(set(ops))} opcodes in {len(cases)} steps "
            f"(bank rows {len(arrays['cbank'])}, shift counts "
            f"{unit_shifts(L)}) at batch {B} bit-exact")
    return err


def phase_k1_path(prog, x, label):
    """Phase J: K1 against the plain executor on a path's full plan, every
    emitted row of both banks, and K1's time, plain time, bytes and
    operations at the path's batch."""
    plan, f = prog.interp.plan, prog.field
    dev = prog.device
    x, x_w, x_n = prog.interp._inputs(x)
    B = x.shape[-1]
    got_w, got_n = interp_k1(plan, f, x)
    (want_w, want_n), plain_ms = wall_ms(
        lambda: k1_plain(plan, f, x_w, x_n))
    rows = torch.as_tensor(plan.emitted_rows(), device=dev)
    rows_n = torch.as_tensor(plan.emitted_rows(narrow=True), device=dev)
    err = max(max_abs_err(got_w.view(torch.int32).index_select(0, rows)
                          .view(torch.uint32), want_w.index_select(0, rows)),
              max_abs_err(got_n.index_select(0, rows_n),
                          want_n.index_select(0, rows_n)))
    del got_w, got_n, want_w, want_n
    ms = time_ms(lambda: interp_k1(plan, f, x), reps=3)
    nbytes = 4 * B * (k1_input_words(plan, x.shape[1]) + plan.L * len(rows)
                      + len(rows_n))
    ops = k1_ops(plan, f.p.bit_length()) * B
    say(f"  K1 on the {label} plan ({plan.n_steps} steps, parts "
        f"{', '.join(plan.parts)}): {len(rows)} wide and {len(rows_n)} "
        f"narrow emitted rows at batch {B}, max abs err {err}; "
        f"{ms:.4f} ms (plain {plain_ms:.1f} ms; byte bound "
        f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms, operation bound "
        f"{ops / LANE_OPS_PER_S * 1e3:.4f} ms)")
    return err, ms, plain_ms, nbytes, ops


# phase P8: the eight fields that --prime takes
P8_PRIMES = ("bn128", "bls12381", "bls12377", "goldilocks", "grumpkin",
             "pallas", "vesta", "secq256r1")
P8_K1_LANES = 256       # K1 against the plain executor


def prime_inputs(spec, B, seed, dev, below=2 ** 63):
    """Two inputs as uint32 limbs (2, L, B) on dev: edge pairs in the
    first lanes (0, 1, p - 1 and p // 2 on both inputs, each pair's sum
    and differences inside the comparators' bits: p - 1 with 1, p // 2
    with p // 2 + 1), then random values below `below` (the comparators'
    2^63; Poseidon2 takes any canonical pair, below=None)."""
    p, L = spec.p, spec.n_limbs
    rng = np.random.default_rng(seed)
    if below is None:
        x = canonical_np(rng, spec, (2, L, B))
    else:
        ab = rng.integers(0, below, size=(2, B), dtype=np.uint64)
        x = np.zeros((2, L, B), np.uint32)
        for i in range(4):
            x[:, i] = (ab >> np.uint64(16 * i)) & np.uint64(0xFFFF)
    pairs = [(0, 0), (1, p - 1), (p - 1, 1), (p // 2, p // 2 + 1),
             (p // 2 + 1, p // 2), (1, 0) if below else (p - 1, p - 1)]
    for j, pair in enumerate(pairs[:B]):
        for i, v in enumerate(pair):
            x[i, :, j] = int_to_limbs(v, L)
    return to_device(x, dev)


# phase P8's interpreter circuits: name -> (path prefix, source at a
# field, the inputs' bound (prime_inputs), its map of a lane's inputs,
# lanes against the host, seed)
P8_CIRCUITS = {
    "comparators": ("p8", lambda prime: comparators_source(), 2 ** 63,
                    lambda v: {"a": v[0], "b": v[1]}, 16, SEED + 40),
    "Poseidon2": ("p8p", poseidon2_source, None,
                  lambda v: {"inputs": v}, 12, SEED + 50),
}


def phase_primes(paths, dev, B, b_k1, circuit):
    """Phase P8: the interpreter at each of the eight --prime fields.  A
    circuit of P8_CIRCUITS (the stdlib comparators, C's; Poseidon2, P's,
    whose lazy dots subtract p up to three times at secq256r1) compiled
    at the field runs at B lanes through WitnessProgram.run (K1, then KW
    or K2) and the R1CS check (KC), the launches counted around exactly
    that (path <prefix>_<field>); every lane passes the check; the edge
    lanes (0, 1, p - 1, p // 2) and random ones equal the host
    calculator, whose exact integers would catch a kernel and its plain
    version that agree on a wrong value; K1 equals its plain executor on
    every emitted row of a slice of b_k1 lanes; K1's wrapper is timed at
    B lanes.  Returns each field's run and check ms, the counted (first)
    ones and each warm, the median of CHECK_RUNS, and K1's ms."""
    prefix, source, below, host_map, n_host, seed = P8_CIRCUITS[circuit]
    out = {}
    for k, prime in enumerate(P8_PRIMES):
        spec = field_spec(prime)
        cc = compile_source(source(prime), prime=prime)
        prog = WitnessProgram(cc.build_tape()[0], spec, device=dev,
                              input_ranges=cc.input_range_hints())
        if prog.interp is None:
            raise SystemExit(f"FAIL P8 {circuit}/{prime}: the interpreter "
                             "planner refused it")
        plan, f = prog.interp.plan, prog.field
        x = prime_inputs(spec, B, seed + k, dev, below)
        checker = R1CSChecker(cc.r1cs_rows(), cc.counts()["n_wires"], spec,
                              device=dev)

        def run_and_check():
            wit, run_ms = wall_ms(lambda: prog.run(x))
            ok, check_ms = wall_ms(lambda: checker.check(wit))
            return wit, int((~ok).sum()), run_ms, check_ms

        path = f"{prefix}_{prime}"
        wit, n_bad, run_ms, check_ms = paths.run(
            path, run_and_check, must_launch(prog), never_launch(prog))
        one_launch(paths, path, dev, 1)
        if n_bad:
            raise SystemExit(f"FAIL P8 {circuit}/{prime}: {n_bad} of {B} "
                             "lanes violate a constraint")
        lanes = list(range(min(6, B))) + random.Random(SEED + k).sample(
            range(6, B), min(n_host, B) - min(6, B))
        ins, got = lane_values(wit, x, lanes)
        warm_run = median_ms(lambda: prog.run(x))
        warm_check = median_ms(lambda: checker.check(wit))
        del wit
        check_host_lanes(cc, ins, got, lanes, host_map,
                         f"P8 {circuit}/{prime}")
        k1_ms = time_ms(lambda: interp_k1(plan, f, x), reps=3)
        err = phase_k1_path(prog, x[..., :b_k1].contiguous(),
                            f"{circuit}/{prime}")[0]
        if err:
            raise SystemExit(f"FAIL P8 {circuit}/{prime}: K1 differs from "
                             f"its plain executor (max abs err {err})")
        subs = f.dot_subs
        say(f"  {circuit}/{prime} (L = {spec.n_limbs}; dot2_c, dot3_c "
            f"subtract p up to {subs[2]}, {subs[3]} times; parts "
            f"{', '.join(plan.parts)}): {B} lanes in {run_ms:.2f} ms, every "
            f"lane passes its check ({check_ms:.2f} ms); warm, medians of "
            f"{CHECK_RUNS}: run {warm_run[0]:.3f} ms ({warm_run[1]:.3f}-"
            f"{warm_run[2]:.3f}), check {warm_check[0]:.3f} ms "
            f"({warm_check[1]:.3f}-{warm_check[2]:.3f}); K1 {k1_ms:.4f} ms "
            f"(wrapper, mean of 3); {CARD}")
        out[prime] = {"L": spec.n_limbs, "first_run_ms": run_ms,
                      "first_check_ms": check_ms, "run_ms": warm_run[0],
                      "check_ms": warm_check[0], "k1_ms": k1_ms}
        del prog, x
    return out


P8_MERKLE_PRIMES = ("goldilocks", "secq256r1", "bls12381")
P8_MK_HOST_LANES = 2    # the host calculator takes ~3 s a Merkle(32) lane
P8_KS_LANES = 8192
# KS's tapes whose second input divides: lane 1 divides by 0
KS_DIVIDES = ("bigdiv", "wide_ops", "bigdiv_num2bits", "pow_div")
CL_PRIME = "secq256r1"
CL_PRIME_WITNESSES = 16


def phase_merkle_primes(paths, dev, B, rehearse):
    """Phase P8, MerkleInclusion(32) (K1a-K1d in one K1 launch, then KW)
    at goldilocks (L = 4), secq256r1 and bls12381, B lanes (random
    pathIndex bits a lane) through witness_path: run, the R1CS check of
    every lane (path p8m_<field>), P8_MK_HOST_LANES sampled lanes against
    the host calculator and SAMPLE_LANES against the native calculator;
    then run_mixed at B lanes (mixed_equals_run, path p8m_<field>_mixed:
    K1, K3 for the pathIndex bits, K2 or KW's wide table for the wide
    rows), equal to run's rows on every lane; K1's wrapper timed at B.  A
    CPU rehearsal runs MerkleInclusion(4)."""
    out = {}
    depth = 4 if rehearse else 32
    for k, prime in enumerate(P8_MERKLE_PRIMES):
        spec = field_spec(prime)
        cc = compile_source(merkle_source(depth), prime=prime)
        tape, layout = cc.build_tape()
        hints = cc.input_range_hints()
        prog = WitnessProgram(tape, spec, device=dev, input_ranges=hints)
        plan, f = prog.interp.plan, prog.field
        x = hinted_inputs(spec, prog.n_inputs, hints, B, SEED + 60 + k, dev)
        t = witness_path(paths, f"p8m_{prime}", cc, prog, x,
                         must_launch(prog), input_map(layout),
                         never=never_launch(prog), n_lanes=P8_MK_HOST_LANES,
                         native=NativeCalculator(tape, spec,
                                                 input_ranges=hints),
                         rehearse=rehearse)
        mixed_ms = mixed_equals_run(paths, f"p8m_{prime}_mixed", prog, x)
        k1_ms = time_ms(lambda: interp_k1(plan, f, x), reps=3)
        say(f"  MerkleInclusion({depth})/{prime} (L = {spec.n_limbs}, "
            f"{plan.n_steps} steps, parts {', '.join(plan.parts)}): {B} "
            f"lanes, run {t['run_ms']:.2f} ms, check {t['check_ms']:.3f} "
            f"ms (median of {CHECK_RUNS}); run_mixed {mixed_ms:.2f} ms "
            f"(first); K1 {k1_ms:.4f} ms (wrapper, mean of 3); {CARD}")
        out[prime] = {"L": spec.n_limbs, "lanes": B, "run_ms": t["run_ms"],
                      "check_ms": t["check_ms"], "mixed_ms": mixed_ms,
                      "k1_ms": k1_ms}
        del prog, x
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def mixed_kernels(prog):
    """The launches of one run_mixed of an interpreter program, each
    once: K1's parts, K3 where it has narrow rows, and for its wide rows
    K2 where they are bank rows, else KW's wide table (as interp_kernels
    names them in a trace)."""
    want = {p: 1 for p in prog.interp.plan.parts or ("interp_k1a",)}
    for kernel in interp_kernels(prog, True):
        if kernel != "interp_k1":
            want[kernel] = 1
    return want


def mixed_equals_run(paths, path, prog, x, x_mixed=None):
    """run_mixed on the input rows x_mixed (x where not given), its
    launches counted around exactly it as `path`: mixed_kernels(prog)
    exactly, K5, K6 never; then run on the full-limb rows x, and
    run_mixed's wide rows and its narrow rows widened (ops/narrow
    .widen_narrow, a negative int32 p - |v| over every limb) equal run's
    rows of mixed_layout() on every lane, a slice of rows at a time.
    Returns run_mixed's ms (its first run)."""
    dev, spec = prog.device, prog.spec
    want = mixed_kernels(prog)
    xm = x if x_mixed is None else x_mixed
    (narrow, wide), ms = wall_ms(lambda: paths.run(
        path, lambda: prog.run_mixed(xm), tuple(want), K5_K6))
    if dev.type == "cuda" and paths.counts[path] != want:
        raise SystemExit(f"FAIL {path}: run_mixed launched "
                         f"{paths.counts[path]}, not {want}")
    wit = prog.run(x)
    n_idx, w_idx = (torch.as_tensor(i, dtype=torch.int64, device=dev)
                    for i in prog.mixed_layout())
    step = 1024
    for s in range(0, len(w_idx), step):
        if not same_witness(wide[s:s + step],
                            wit.index_select(0, w_idx[s:s + step])):
            raise SystemExit(f"FAIL {path}: run_mixed's wide rows "
                             f"{s}-{s + step} differ from run's")
    for s in range(0, len(n_idx), step):
        if not same_witness(widen_narrow(narrow[s:s + step], spec.p,
                                         spec.n_limbs),
                            wit.index_select(0, n_idx[s:s + step])):
            raise SystemExit(f"FAIL {path}: run_mixed's narrow rows "
                             f"{s}-{s + step}, widened, differ from run's")
    say(f"  {path}: run_mixed launched {paths.counts[path]}; its "
        f"{len(w_idx)} wide rows and {len(n_idx)} narrow rows (widened) "
        f"equal run's on all {x.shape[-1]} lanes")
    return ms


# phase P8n: SHA256 through the mixed path at the fields that take K1
# instantiations no other phase gives a narrow plan: goldilocks' <4,
# true, true> and the counted dots' <16, false, true>
P8N_PRIMES = ("goldilocks", "secq256r1", "bls12381")
P8N_HOST_LANES = 2      # the host calculator takes ~4 s a SHA256 lane


def phase_sha_primes(paths, rep, dev, B, b_full, b_k1, rehearse):
    """Phase P8n: SHA256 (one block) through the mixed path at each field
    of P8N_PRIMES, compiled and planned at that field:
    - run_mixed at B lanes (path p8n_<field>_mixed): K1, whose narrow
      lane (K1b) runs every step, and K3, once each and nothing else (no
      wide row: no K2 or KW); every lane's digest against hashlib; the
      run's median, peak and traced device operations (interp_run); K1
      against its plain executor on every emitted narrow row of a slice
      of b_k1 lanes; K3 against gather_n_rows on every lane; both timed
      around their bare launches;
    - run at b_full lanes and the R1CS check (witness_path, path
      p8n_<field>: K1, KW, KC): every lane passing, P8N_HOST_LANES lanes
      against the host calculator, SAMPLE_LANES against the native one,
      the run traced; every lane's digest; run_mixed's rows at those
      lanes, widened, equal to run's (mixed_equals_run, path
      p8n_<field>_rows).
    The times go into the kernels line's interp_k1b and gather_n rows
    under "p8n".  Returns each field's numbers."""
    out = {}
    for k, prime in enumerate(P8N_PRIMES):
        t_phase = time.perf_counter()
        spec = field_spec(prime)
        cc = compile_source(bench_gpu.sha256_source(), prime=prime)
        tape, _ = cc.build_tape()
        prog = WitnessProgram(tape, spec, device=dev,
                              input_ranges=cc.input_range_hints())
        build_s = time.perf_counter() - t_phase
        plan, f = prog.interp.plan, prog.field
        label = f"SHA256/{prime}"
        n_idx, w_idx = prog.mixed_layout()
        if w_idx or plan.win_order or n_idx != list(range(prog.n_witness)):
            raise SystemExit(f"FAIL P8n {label}: the plan is not all narrow")
        say(f"  {label} (L = {spec.n_limbs}; compiled and planned in "
            f"{build_s:.1f} s: {plan.n_steps} steps, parts "
            f"{', '.join(plan.parts)}, {prog.n_witness} witness rows)")
        msgs = sha256_messages(B, SEED + 80 + k)
        x = to_device(sha256_io.input_rows(msgs), dev)
        path = f"p8n_{prime}_mixed"
        want = mixed_kernels(prog)
        narrow, wide = paths.run(path, lambda: prog.run_mixed(x),
                                 tuple(want), K5_K6)
        if dev.type == "cuda" and paths.counts[path] != want:
            raise SystemExit(f"FAIL P8n {label}: run_mixed launched "
                             f"{paths.counts[path]}, not {want}")
        got = sha256_io.digest_bits_from_witness(narrow, (n_idx, w_idx))
        n_bad = int((got != to_device(sha256_io.digest_bits_batch(msgs),
                                      dev)).any(dim=0).sum())
        if n_bad or wide.shape[0]:
            raise SystemExit(f"FAIL P8n {label}: {n_bad} of {B} digests "
                             f"differ from hashlib's ({wide.shape[0]} wide "
                             "rows)")
        say(f"  {label}: run_mixed, all {B} digests equal hashlib's")
        del narrow, wide, got
        mixed = interp_run(prog, x, f"P8n {label} mixed", rehearse,
                           mixed=True)
        # K1 against its plain executor on a slice, K3 against its plain
        # version on every lane, each timed around its bare launch
        rows_n = torch.as_tensor(plan.emitted_rows(narrow=True), device=dev)
        xs = x[..., :b_k1].contiguous()
        _, got_n = interp_k1(plan, f, xs)
        (_, want_n), k1_plain_ms = wall_ms(
            lambda: k1_plain(plan, f, *split_inputs(plan, xs)))
        err_k1 = max_abs_err(got_n[rows_n], want_n[rows_n])
        del got_n, want_n
        k1_ms = time_ms(bare(dev, lambda: launch_k1(plan, f, x),
                             lambda: interp_k1(plan, f, x)), reps=3)
        _, bank_n = interp_k1(plan, f, x)
        order, src, shift = (plan.dev[n] for n in ("nin_order", "nw_src",
                                                   "nw_shift"))
        got = gather_n(bank_n, x, order, src, shift)
        k3_ms = time_ms(bare(dev, lambda: launch_gather_n(
            bank_n, x, order, src, shift, got),
            lambda: gather_n(bank_n, x, order, src, shift)))
        want_g, k3_plain_ms = wall_ms(lambda: gather_n_rows(
            bank_n, narrow_inputs(x, order), src, shift))
        err_k3 = max_abs_err(got, want_g)
        del got, want_g, bank_n
        if err_k1 or err_k3:
            raise SystemExit(f"FAIL P8n {label}: K1 (max abs err {err_k1} "
                             f"on {b_k1} lanes) or K3 ({err_k3}) differs "
                             "from its plain version")
        say(f"  {label}: K1 equals its plain executor on {len(rows_n)} "
            f"emitted narrow rows of {xs.shape[-1]} lanes, K3 gather_n_rows "
            f"on all {B}; K1 {k1_ms:.4f} ms, K3 {k3_ms:.4f} ms (bare; "
            f"plain {k1_plain_ms:.1f} ms at {xs.shape[-1]} lanes, "
            f"{k3_plain_ms:.2f} ms)")
        del x, xs
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        # the full-limb run and the check at b_full lanes
        msgs = sha256_messages(b_full, SEED + 90 + k)
        xf = to_device(sha256_io.input_rows(msgs, spec.n_limbs), dev)
        hints = cc.input_range_hints()
        t = witness_path(paths, f"p8n_{prime}", cc, prog, xf,
                         must_launch(prog), lambda ins: {"in": ins},
                         never=never_launch(prog), n_lanes=P8N_HOST_LANES,
                         native=NativeCalculator(tape, spec,
                                                 input_ranges=hints),
                         trace=f"P8n {label} full", rehearse=rehearse)
        wit = prog.run(xf)
        bits = wit[1:257, 0].view(torch.int32)
        n_bad = int((bits != to_device(sha256_io.digest_bits_batch(msgs),
                                       dev)).any(dim=0).sum())
        del wit, bits
        if n_bad:
            raise SystemExit(f"FAIL P8n {label}: {n_bad} of {b_full} "
                             "digests of run differ from hashlib's")
        say(f"  {label}: run, all {b_full} digests equal hashlib's")
        mixed_equals_run(paths, f"p8n_{prime}_rows", prog, xf,
                         to_device(sha256_io.input_rows(msgs), dev))
        del xf
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t_phase = time.perf_counter() - t_phase
        row = {"L": spec.n_limbs, "mixed_ms": mixed["median_ms"],
               "mixed_peak_gib": mixed["peak_gib"],
               "mixed_idle": mixed.get("idle"),
               "run_ms": t["trace"]["median_ms"],
               "run_peak_gib": t["trace"]["peak_gib"],
               "check_ms": t["check_ms"], "k1_ms": k1_ms, "k3_ms": k3_ms,
               "k1_plain_ms": k1_plain_ms, "k3_plain_ms": k3_plain_ms,
               "build_s": build_s, "phase_s": t_phase}
        say(f"  {label}: run_mixed at {B} {row['mixed_ms']:.3f} ms (median "
            f"of 10, peak {row['mixed_peak_gib']:.3f} GiB); run at {b_full} "
            f"{row['run_ms']:.3f} ms (median of 10, peak "
            f"{row['run_peak_gib']:.3f} GiB), check {row['check_ms']:.3f} ms "
            f"(median of {CHECK_RUNS}); K1 {k1_ms:.4f} ms, K3 {k3_ms:.4f} ms "
            f"(bare); {t_phase:.1f} s; {CARD}")
        for name, ms in (("interp_k1b", k1_ms), ("gather_n", k3_ms)):
            if name in rep.rows:
                rep.rows[name].setdefault("p8n", {})[prime] = ms
        out[prime] = row
        del cc, tape, prog
    return out


def scan_end_to_end(cc, prog, x, wit):
    """A scan tape's run timed end to end beside KS's bare launch: the
    medians of CHECK_RUNS of WitnessProgram.run (one KS launch), of the
    R1CS check of its witness (one KC launch) and of the two together,
    each by the host clock a call at a time; and how many of the lanes
    fail a constraint (a lane dividing by 0, or p - 1 where a tape's
    constraints want less, may)."""
    checker = R1CSChecker(cc.r1cs_rows(), cc.counts()["n_wires"], prog.spec,
                          device=prog.device)

    def checked():
        return checker.check(prog.run(x))

    return {"run_median_ms": median_ms(lambda: prog.run(x))[0],
            "check_ms": median_ms(lambda: checker.check(wit))[0],
            "checked_ms": median_ms(checked)[0],
            "failing_lanes": int((~checker.check(wit)).sum())}


def phase_ks_primes(paths, dev, B):
    """Phase P8, KS: the tapes of circuits/sources.ks_tapes()
    (tests/test_torch_scan_kernel.py's, pow_div included) compiled at
    each of the eight --prime fields, on the scan (unroll_threshold=0, as
    every entry point), B lanes (lane 0 p - 1 on every field input, lane
    1 dividing by 0 where the tape divides, lanes 2 and 3 below 2^31,
    inside every tape's range checks): a run is one KS launch and none of
    SCAN_NEVER (path p8s_<field>_<tape>), bit for bit against the step
    loop on the card, lanes 2 and 3 against the host calculator (which
    stops at a failed constraint); the warm run and KS's bare launch
    timed, and at goldilocks each tape's run and R1CS check end to end
    (scan_end_to_end).  Returns each field's ms."""
    out = {}
    for k, prime in enumerate(P8_PRIMES):
        spec = field_spec(prime)
        row = out[prime] = {}
        for name, src in ks_tapes().items():
            cc = compile_source(src, prime=prime)
            tape, layout = cc.build_tape()
            hints = cc.input_range_hints()
            prog = WitnessProgram(tape, spec, device=dev, unroll_threshold=0,
                                  mode="scan", input_ranges=hints)
            if prog.scan is None:
                raise SystemExit(f"FAIL P8 KS {name}/{prime}: not on the "
                                 "scan")
            rng = random.Random(SEED + 70 + k)
            cols = [[rng.randint(*hints[i]) if i in hints
                     else rng.randrange(spec.p) for _ in range(B)]
                    for i in range(tape.n_inputs)]
            for i, c in enumerate(cols):
                if i not in hints:
                    c[0] = spec.p - 1
                    c[2:4] = [rng.randrange(1, 2 ** 31) for _ in c[2:4]]
            if name in KS_DIVIDES:
                cols[1][1] = 0
            x = to_device(prog.encode_inputs(cols), dev)
            path = f"p8s_{prime}_{name}"
            wit = paths.run(path, lambda: prog.run(x), ("scan",), SCAN_NEVER)
            if dev.type == "cuda" and paths.counts[path].get("scan") != 1:
                raise SystemExit(f"FAIL P8 KS {name}/{prime}: "
                                 f"{paths.counts[path]} launches, not one "
                                 "KS launch")
            want, loop_ms = wall_ms(lambda: prog.scan.run_loop(x))
            if not same_witness(wit, want):
                raise SystemExit(f"FAIL P8 KS {name}/{prime}: KS differs "
                                 "from the step loop")
            lanes = [2, 3]
            ins, got = lane_values(wit, x, lanes)
            for j, lane in enumerate(lanes):
                if got[j] != list(cc.witness_host(input_map(layout)(ins[j]))):
                    raise SystemExit(f"FAIL P8 KS {name}/{prime} lane {lane}: "
                                     "witness differs from the host "
                                     "calculator")
            del want
            run_ms = wall_ms(lambda: prog.run(x))[1]
            ks = prog.scan.ks
            ks_ms = None
            if dev.type == "cuda":
                d = ks.device_tables(ks.width(B))
                spill, buf = ks_buffers(ks, d["t"], B, dev)
                ks_ms = time_ms(lambda: launch_scan(ks.field, d, x, spill,
                                                    buf), reps=3)
                del spill, buf
            row[name] = {"run_ms": run_ms, "ks_ms": ks_ms,
                         "loop_ms": loop_ms,
                         "steps": prog.scan.sched.n_steps}
            if prime == "goldilocks":
                row[name].update(scan_end_to_end(cc, prog, x, wit))
            del prog, x, wit
        if prime == "goldilocks":
            say(f"  the goldilocks scan end to end ({B} lanes, medians of "
                f"{CHECK_RUNS}: WitnessProgram.run, the R1CS check (KC), "
                "run and check): " + ", ".join(
                    f"{name} {t['run_median_ms']:.3f}, {t['check_ms']:.3f}, "
                    f"{t['checked_ms']:.3f} ms ({t['failing_lanes']} lanes "
                    "fail a constraint)" for name, t in row.items())
                + f"; {CARD}")
        say(f"  KS at {prime} (L = {spec.n_limbs}, {B} lanes; one KS launch "
            "a run, bit for bit against the step loop, lanes 2 and 3 "
            "against the host): " + ", ".join(
                f"{name} run {t['run_ms']:.3f} ms, KS "
                + ("not measured" if t["ks_ms"] is None
                   else f"{t['ks_ms']:.4f} ms")
                + f", loop {t['loop_ms']:.1f} ms ({t['steps']} steps)"
                for name, t in row.items()) + f"; {CARD}")
    return out


def new_paths(paths, rep, dev, B, b_div, rehearse):
    """Phases F-K: the paths of K1c and K1d (Poseidon2/goldilocks at
    batch B, bigint-div/bn128 at b_div, the stdlib comparators/bn128 at
    B), K1 against its plain version on their plans and on unit plans of
    every K1c/K1d opcode, and the entry point on a goldilocks artifact."""
    out = {}
    gl = field_spec("goldilocks")
    cc_gl = compile_source(poseidon2_source("goldilocks"), prime="goldilocks")
    prog_gl = WitnessProgram(cc_gl.build_tape()[0], gl, device=dev)
    x_gl = canonical_limbs(np.random.default_rng(SEED + 9), gl,
                           (prog_gl.n_inputs, gl.n_limbs, B), dev)
    say(f"phase F: the Poseidon2/goldilocks path (batch {B})")
    out["poseidon2_gl"] = witness_path(
        paths, "poseidon2_gl", cc_gl, prog_gl, x_gl,
        ("interp_k1c", "interp_k1a", "gather_w", "r1cs_check"),
        lambda ins: {"inputs": ins}, never=K5_K6, trace="G",
        rehearse=rehearse)

    bn = field_spec("bn128")
    cc_bd = compile_source(BIGINT_DIV_SRC)
    prog_bd = WitnessProgram(cc_bd.build_tape()[0], bn, device=dev)
    rng = random.Random(5)        # bench.py's bigint-div inputs
    x_bd = to_device(prog_bd.encode_inputs(
        [[rng.randrange(bn.p) for _ in range(b_div)],
         [rng.randrange(1, bn.p) for _ in range(b_div)]]), dev)
    say(f"phase G: the bigint-div/bn128 path (batch {b_div})")
    out["bigdiv"] = witness_path(
        paths, "bigdiv", cc_bd, prog_bd, x_bd,
        ("interp_k1d", "interp_k1a", "gather_w", "r1cs_check"),
        lambda ins: {"a": ins[0], "b": ins[1]}, never=K5_K6, trace="D",
        rehearse=rehearse)

    cc_cmp = compile_source(comparators_source())
    prog_cmp = WitnessProgram(cc_cmp.build_tape()[0], bn, device=dev)
    x_cmp = to_device(comparator_inputs(B, SEED + 10, bn.n_limbs), dev)
    say(f"phase H: the stdlib comparators/bn128 path (batch {B})")
    out["comparators"] = witness_path(
        paths, "comparators", cc_cmp, prog_cmp, x_cmp,
        ("interp_k1d", "interp_k1c", "interp_k1a", "assemble", "r1cs_check"),
        lambda ins: {"a": ins[0], "b": ins[1]}, never=K5_K6 + KW_NEVER,
        trace="C", rehearse=rehearse)
    say("phase KW: KW against the parts route on C's witness")
    out["comparators"]["kw"] = phase_kw(prog_cmp, x_cmp, "comparators/bn128")

    say("phase I: K1c/K1d opcodes against ops/wide.py and ops/narrow.py")
    unit_err = phase_k1cd_units(dev, 400 if rehearse else 4096)
    say("phase J: K1 against the plain executor on the new paths' plans")
    k1 = {"poseidon2_gl": phase_k1_path(prog_gl, x_gl, "Poseidon2/goldilocks"),
          "bigdiv": phase_k1_path(prog_bd, x_bd, "bigint-div/bn128"),
          "comparators": phase_k1_path(prog_cmp, x_cmp,
                                       "comparators/bn128")}
    err, ms, plain_ms, nbytes, ops = k1["poseidon2_gl"]
    rep.add("interp_k1c", "circom_tpu_torch/ops/cuda/interp.cu",
            "circom_tpu/backend/interp.py:2462", max(err, unit_err), ms,
            plain_ms, nbytes, ops, plan="Poseidon2/goldilocks")
    err, ms, plain_ms, nbytes, ops = k1["comparators"]
    e_bd, ms_bd, plain_bd, nbytes_bd, ops_bd = k1["bigdiv"]
    rep.add("interp_k1d", "circom_tpu_torch/ops/cuda/interp.cu",
            "circom_tpu/backend/interp.py:2462", max(err, e_bd, unit_err),
            ms, plain_ms, nbytes, ops, plan="comparators/bn128",
            bigdiv_ms=ms_bd, bigdiv_plain_ms=plain_bd,
            bigdiv_bound_ms=bound(nbytes_bd, ops_bd)[0],
            bigdiv_bound_by=bound(nbytes_bd, ops_bd)[1],
            bigdiv_bytes_bound_ms=bounds(nbytes_bd, ops_bd)[0],
            bigdiv_ops_bound_ms=bounds(nbytes_bd, ops_bd)[1])
    out["k1"] = {name: v[1] for name, v in k1.items()}
    del prog_gl, x_gl, prog_bd, x_bd, prog_cmp, x_cmp

    say("phase K: the witness entry point (Poseidon2/goldilocks)")
    rng = random.Random(SEED + 11)
    phase_entry_point(cc_gl, dev.type, "posgl",
                      [{"inputs": [rng.randrange(gl.p), gl.p - 1 - k]}
                       for k in range(4)])
    return out


KS_SOURCE = "circom_tpu_torch/ops/cuda/scan.cu"
KS_REPLACES = "circom_tpu/backend/jax_backend.py:571"
# the kernels a scan run must not launch: K1's parts, K4, and the step
# loop's gathers, products, adds and subtracts (KS runs every step)
SCAN_NEVER = ("interp_k1a", "interp_k1b", "interp_k1c", "interp_k1d", "k4",
              "gather_w", "mont_mul", "add", "sub")
K4_SOURCE = "circom_tpu_torch/ops/segment_gen.py"
K4_REPLACES = "circom_tpu/backend/segments.py:242"


def k4_programs(dev):
    """The programs of the segmented paths, built before the kernels so
    that their generated K4 sources build in parallel with the fixed
    ones: name -> (compiled circuit, WitnessProgram); phase S8's, the op
    circuit and LessThan(lt_bits) forced onto the segments at each of
    P8_PRIMES, as s8_<circuit>_<field>."""
    progs = {}
    bn = field_spec("bn128")
    for name, src, prime in (
            ("n2b254", num2bits_source(254, 1), "bn128"),
            ("n2b254x4", num2bits_source(254, 4), "bn128"),
            ("ops_bn128", segment_ops_source(bn.p.bit_length()), "bn128"),
            ("ops_goldilocks", segment_ops_source(64), "goldilocks")):
        cc = compile_source(src, prime=prime)
        mode = "segments" if name.startswith("ops") else "auto"
        progs[name] = (cc, WitnessProgram(
            cc.build_tape()[0], field_spec(prime), device=dev, mode=mode,
            input_ranges=cc.input_range_hints()))
    for prime in P8_PRIMES:
        spec = field_spec(prime)
        for circuit, src in (
                ("ops", segment_ops_source(spec.p.bit_length())),
                ("lt", lessthan_source(lt_bits(prime)))):
            cc = compile_source(src, prime=prime)
            progs[f"s8_{circuit}_{prime}"] = (cc, WitnessProgram(
                cc.build_tape()[0], spec, device=dev, mode="segments",
                input_ranges=cc.input_range_hints()))
    return progs


def lt_bits(prime):
    """LessThan(n)'s n at a field: circomlib's largest (252), or two
    below the field's bit width."""
    return min(252, field_spec(prime).p.bit_length() - 2)


def edge_inputs(spec, n_inputs, B, seed, dev):
    """Random canonical inputs (n_inputs, L, B) whose first lanes hold the
    edges 0, 1, p - 1, 2^253 and 2^254 - 1 reduced mod p."""
    L, p = spec.n_limbs, spec.p
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 16, size=(n_inputs, L, B), dtype=np.uint32)
    x[:, L - 1] = rng.integers(0, p >> (16 * (L - 1)), size=(n_inputs, B),
                               dtype=np.uint32)
    for k, v in enumerate([0, 1, p - 1, 1 << 253, ((1 << 254) - 1) % p]):
        if k < B:
            x[:, :, k] = int_to_limbs(v, L)
    return to_device(x, dev)


def k4_ops(seg, field):
    """32-bit integer instructions of one segment a lane, counted low: K4
    computes in N = L/2 32-bit words, two instructions a 32x32->64-bit
    product (its low and its high word; the carries' adds not counted):
    N (N + nz) products a Montgomery product by a constant of nz nonzero
    words, 2 N^2 by a value; a plain product of two values two Montgomery
    products (the second by R^2), by a constant c one by c R mod p;
    goldilocks' 64x64-bit product N nz word products (nz = N for a value);
    N instructions for any other op."""
    N = field.L // 2
    goldilocks = field.p == GOLDILOCKS_P

    def nz(value):
        return sum(1 for i in range(N) if value >> (32 * i) & 0xFFFFFFFF)

    products = 0
    others = 0
    for op, descs, *_rest in seg.instrs:
        consts = [limbs_to_int(d[1]) for d in descs if d[0] == "const"]
        if op == "mulp" and goldilocks:
            products += N * (nz(consts[0]) if consts else N)
        elif op == "mulp":
            products += (N * (N + nz(consts[0] * 2 ** (16 * field.L)
                                     % field.p)) if consts else 4 * N * N)
        elif op == "mul":
            products += N * (N + nz(consts[0])) if consts else 2 * N * N
        else:
            others += N
    return 2 * products + others


def k4_rows(sp):
    """(rows K4 must move for a program: each input row it reads once and
    each witness row written once; rows its kernels move: each kernel's
    distinct rows read, its operands' and those its fill copies, and every
    row it stores; of these, crossing rows).  The rows moved beyond the
    first are the segments' own: an input or witness row read again by a
    later kernel, crossing rows written and read."""
    inputs, moved, cross = set(), 0, 0
    for kn in sp.kernels:
        reads = set(kn.src) | {r for r, _rows in kn.fill if r[0] == "x"}
        stores = [r for d in kn.dst for r in d] + [
            r for _v, rows in kn.fill for r in rows]
        inputs |= {r for r in reads if r[0] == "x"}
        moved += len(reads) + len(stores)
        cross += sum(1 for r in list(reads) + stores if r[0] == "c")
    return len(inputs) + sp.n_witness, moved, cross


def phase_k4_program(prog, x, label):
    """K4 against its plain version on every kernel of a program at the
    path's batch, in place: each segment launched on the inputs x and its
    own witness and crossing buffer (filled with UNWRITTEN), its plain
    version on another pair from the same history, every witness and
    crossing row compared after each segment, and no witness row left
    unwritten at the end; K4's time (the sum of its segments' bare
    launches on those buffers), the plain version's, the bytes the
    program must move (k4_rows: each input row read once, each witness row
    written once), the bytes its kernels move and the crossing rows'
    among them, and the operations."""
    sp, dev = prog.fused, prog.device
    x = x.contiguous()
    L, B = sp.L, x.shape[-1]
    got, want = sp.buffers(B, UNWRITTEN), sp.buffers(B, UNWRITTEN)
    err, ms, plain_ms, ops = 0, 0.0, 0.0, 0
    for s, seg in enumerate(sp.kernels):
        k4 = bare(dev, lambda: launch_k4(sp, s, x, *got),
                  lambda: segment_k4(sp, s, x, *got))
        k4()
        plain_ms += wall_ms(lambda: segment_ref(sp.field, seg, x, *want))[1]
        err = max([err] + [max_abs_err(g, w) for g, w in zip(got, want)])
        ms += time_ms(k4)
        ops += k4_ops(seg, sp.field) * B
    if bool((got[0].view(torch.int32) == UNWRITTEN).any()):
        raise SystemExit(f"FAIL K4 on {label}: a witness row was not "
                         "written")
    del got, want
    nbytes, moved, cross_bytes = (4 * L * B * n for n in k4_rows(sp))
    b_ms, b_by = bound(nbytes, ops)
    say(f"  K4 on {label} ({len(sp.kernels)} kernels, "
        f"{sp.stats()['nodes']} ops, {sp.n_cross} crossing rows) at batch "
        f"{B}, in place: every witness and crossing row, max abs err {err}; "
        f"{ms:.4f} ms (plain {plain_ms:.1f} ms; must move "
        f"{nbytes / 1e9:.4f} GB, its kernels move {moved / 1e9:.4f} GB, of "
        f"them {cross_bytes / 1e9:.4f} GB crossing rows; bound {b_ms:.4f} "
        f"ms by {b_by})")
    return err, ms, plain_ms, nbytes, ops, cross_bytes, moved


def segment_run(prog, x, label, rehearse, runs=10, trace=True):
    """A segmented path's run: its median ms over `runs` runs a run at a
    time, the memory it allocates at its peak beyond what was allocated
    before, and, with `trace`, its device operations (traced_ops), which
    must be each of K4's kernels once a run and nothing else, so that a
    trace that missed a kernel fails too; with the device's idle
    share."""
    dev = prog.device
    ms = sorted(wall_ms(lambda: prog.run(x))[1] for _ in range(runs))
    median = ms[len(ms) // 2]
    _, _, gib = run_peak(dev, lambda: prog.run(x))
    say(f"  {label} run: median {median:.3f} ms of {runs} "
        f"({ms[0]:.3f}-{ms[-1]:.3f}), {gib:.3f} GiB allocated at its peak")
    out = {"median_ms": median, "peak_gib": gib}
    if rehearse or not trace:
        return out
    n_k4 = len(prog.fused.kernels)
    profile, got = traced_ops(
        lambda: prog.run(x), median, label,
        {f"k4_seg{s}": 1.0 for s in range(n_k4)},
        lambda k: (lambda m: f"k4_seg{m.group(1)}" if m else k)(
            re.search(r"k4_seg(\d+)", k)),
        {"k4": n_k4})
    out.update(idle=idle_of(profile), device_ops=got)
    return out


# profile_breakdown's passes in traced_ops: a traced warm-up step and one
# step of TRACED_RUNS runs, TRACE_PAD s of host time around each step's
# runs, each pass at most TRACE_TRIES times.  The profiler keeps a kernel
# record only inside its window, placed by the host's clock; the dropped
# records came late in long processes and then in every pass (3 of S's
# 20 K4 records after ~470 s of smoke on an H100, none in other
# processes), as a drift of the card's timestamps against the host's
# would drop the runs nearest an edge: 0.1 s keeps them 100 ms inside,
# and each pass made again pads three times as long as the one before (4
# of S's 20 records were dropped in five passes at 0.1 s each, ~490 s
# into a smoke)
TRACED_RUNS = 20
TRACE_PAD = 0.1
TRACE_TRIES = 5


def traced_ops(fn, median, label, want, short, launches):
    """A run's device operations from one profiler step of TRACED_RUNS
    runs of fn (profile_breakdown, after its traced warm-up step), by
    short(kernel name): (the profile, {short name: count a run}).  They
    must be `want` exactly, each kernel of the path once a run and nothing
    else, or the phase fails.  The launch counts of the same pass must be
    `launches` ({LAUNCHES name: launches a run}) times its runs exactly.
    The profiler drops a kernel record now and then (on an H100: 3 of
    S's 20 K4 records in one pass; 1 of MK's 20 K1 and then of its 20 KW
    in two passes running); so where the launch counts are exact and
    the trace holds only the path's kernels but fewer of them than were
    launched, the pass is made again with three times the pad, up to
    TRACE_TRIES passes, and fails if none records every launch.  A
    foreign operation, a kernel recorded more often than launched, or
    launch counts off their mark fail at once."""
    for attempt in range(1, TRACE_TRIES + 1):
        sync_all()
        before = Counter(build.LAUNCHES)
        pad = TRACE_PAD * 3 ** (attempt - 1)
        profile = profile_breakdown(fn, median, reps=1, runs=TRACED_RUNS,
                                    pad=pad)
        launched = dict(Counter(build.LAUNCHES) - before)
        got = {}
        for k, (n, _t) in profile[3].items():
            got[short(k)] = got.get(short(k), 0) + n
        if got == want:
            return profile, got
        passes = 2 * TRACED_RUNS      # the warm-up step's and the traced
        exact = launched == {k: n * passes for k, n in launches.items()}
        dropped = (exact and set(got) <= set(want)
                   and all(n <= want[k] for k, n in got.items()))
        if not dropped or attempt == TRACE_TRIES:
            raise SystemExit(
                f"FAIL {label}: a run's device operations are {got}, not "
                f"its kernels once each: {want} (launch counts of "
                f"{passes} runs: {launched}; pass {attempt} of "
                f"{TRACE_TRIES})")
        say(f"  {label}: the profiler recorded {got} a run of the {want} "
            f"that the launch counts show ({launched} in {passes} runs, "
            f"{pad:g} s pads); tracing again")


# K1, KW, K2 and K3 by the names of their kernels in a profiler trace
INTERP_TRACE_NAMES = (("interp_k1_kernel", "interp_k1"),
                      ("assemble_kernel", "assemble"),
                      ("gather_rows_kernel", "gather_w"),
                      ("gather_n_kernel", "gather_n"))


def interp_kernels(prog, mixed):
    """The kernels an interpreter run launches, each once, and nothing
    else: K1, then K2 where the witness is the wide bank's rows in witness
    order, else KW (run); K1, K3, and K2 or KW for the wide rows, each
    where it has rows (run_mixed)."""
    interp, plan = prog.interp, prog.interp.plan
    if not mixed:
        return {"interp_k1": 1.0,
                "gather_w" if interp._k2_whole else "assemble": 1.0}
    want = {"interp_k1": 1.0}
    if len(plan.nw_src):
        want["gather_n"] = 1.0
    if len(plan.wd_src):
        want["gather_w" if interp._bank_only else "assemble"] = 1.0
    return want


def interp_run(prog, x, label, rehearse, mixed=False, runs=10):
    """An interpreter path's run (run_mixed where `mixed`) from input rows
    already on the device: its median ms over `runs` runs a run at a
    time, the memory it allocates at its peak beyond what was allocated
    before, and its device operations (traced_ops), which must be the
    path's own kernels once a run and nothing else (interp_kernels): no
    split of the inputs, copy or cast runs before K1 or between the
    kernels, and a trace that missed a kernel fails too; with the
    device's idle share.  A rehearsal runs once: its times are the plain
    versions' on the CPU."""
    dev = prog.device

    def fn():
        return prog.run_mixed(x) if mixed else prog.run(x)

    runs = 1 if rehearse else runs
    ms = sorted(wall_ms(fn)[1] for _ in range(runs))
    median = ms[len(ms) // 2]
    _, _, gib = run_peak(dev, fn)
    say(f"  {label} {'run_mixed' if mixed else 'run'}: median {median:.3f} "
        f"ms of {runs} ({ms[0]:.3f}-{ms[-1]:.3f}), {gib:.3f} GiB "
        "allocated at its peak")
    out = {"median_ms": median, "peak_gib": gib}
    if rehearse:
        return out
    plan = prog.interp.plan
    want = interp_kernels(prog, mixed)
    launches = {k: 1 for k in want if k != "interp_k1"}
    launches.update({p: 1 for p in plan.parts or ("interp_k1a",)})
    profile, got = traced_ops(
        fn, median, label, want,
        lambda k: next((s for pat, s in INTERP_TRACE_NAMES if pat in k), k),
        launches)
    say(f"  {label}: a run's device operations are its kernels alone, "
        f"{got}")
    out.update(idle=idle_of(profile), device_ops=got)
    return out


def check_summary(t):
    """witness_path's check numbers for a path's summary line."""
    return (f"{t['check_ms']:.3f} ms R1CS check (median of {CHECK_RUNS}; "
            f"{t['check_after_trace_ms']:.3f} after the run's profiler "
            "pass)")


def run_summary(trace):
    """interp_run's numbers for a path's summary line."""
    return (f"; a run's median {trace['median_ms']:.3f} ms, peak "
            f"{trace['peak_gib']:.3f} GiB"
            + (f", idle {trace['idle']}, device operations "
               f"{trace['device_ops']}" if "idle" in trace else ""))


def unit_columns(spec, n_inputs, hints, B, seed):
    """Input columns of the op circuits: every pair of the edges 0, 1,
    p - 1, p // 2, p // 2 + 1, 2^16 and 2^64 mod p on inputs a and b,
    then random values; the range-hinted c is a bit."""
    p = spec.p
    edges = [0, 1, p - 1, p // 2, p // 2 + 1, 1 << 16, (1 << 64) % p]
    rng = random.Random(seed)
    cols = []
    for i in range(n_inputs):
        col = [rng.randrange(p) for _ in range(B)]
        for lane in range(min(B, 49)):
            col[lane] = edges[(lane // 7 ** min(i, 1)) % 7]
        cols.append([lane % 2 for lane in range(B)] if i in hints else col)
    return cols


def phase_k4_units(progs, dev, B):
    """Phase U: K4 against its plain version on the op circuits (every op
    of the segmented backend, constants with zero limbs, shift counts 0,
    1, 15, 16, 17, bits - 1) at bn128 and goldilocks on edge operands,
    and 16 lanes of each against the host calculator."""
    err = 0
    for name in ("ops_bn128", "ops_goldilocks"):
        cc, prog = progs[name]
        cols = unit_columns(prog.spec, prog.n_inputs,
                            cc.input_range_hints(), B, SEED + 12)
        x = to_device(prog.encode_inputs(cols), dev)
        err = max(err, phase_k4_program(prog, x, name)[0])
        w = prog.run(x).view(torch.int32).cpu().numpy().view(np.uint32)
        lanes = [k for k in range(B) if cols[1][k]][:16]
        for lane in lanes:
            host = list(cc.witness_host({"a": cols[0][lane],
                                         "b": cols[1][lane],
                                         "c": cols[2][lane]}))
            if [limbs_to_int(w[i, :, lane]) for i in range(len(host))] \
                    != host:
                raise SystemExit(f"FAIL K4 {name} lane {lane}: witness "
                                 "differs from the host calculator")
        say(f"  {name}: {len(lanes)} lanes equal the host calculator")
    return err


S8_HOST_LANES = 16      # sampled lanes against the host, beside the edges
S8_EDGES = 16           # the first lanes: every pair of four edges


def s8_inputs(cc, prog, circuit, B, seed, dev):
    """Phase S8's inputs (n_inputs, L, B): random values, canonical for
    the op circuit and below 2^n for LessThan(n) (defined there); the
    first S8_EDGES lanes every pair of the edges on the first two inputs
    (test_segments_at_every_prime's: 0, 1, p - 1, p // 2; LessThan's 0, 1,
    2^n - 1, 2^(n - 1)); the range-hinted input (the op circuit's c) a
    bit; at a field of 64 bits no b = 0 (the op circuit divides by b
    there, and the host calculator refuses a / 0)."""
    spec = prog.spec
    p, L = spec.p, spec.n_limbs
    rng = np.random.default_rng(seed)
    x = canonical_np(rng, spec, (prog.n_inputs, L, B))
    if circuit == "lt":
        n = lt_bits(spec.name)
        x[:, n // 16 + 1:] = 0
        x[:, n // 16] &= np.uint32((1 << (n % 16)) - 1)
        edges = [0, 1, (1 << n) - 1, 1 << (n - 1)]
    else:
        edges = [0, 1, p - 1, p // 2]
    for lane in range(min(S8_EDGES, B)):
        x[0, :, lane] = int_to_limbs(edges[lane % 4], L)
        x[1, :, lane] = int_to_limbs(edges[lane // 4 % 4], L)
    for i in cc.input_range_hints():
        x[i] = 0
        x[i, 0] = np.arange(B) % 2
    if circuit == "ops" and p.bit_length() <= 64:
        x[1, 0, ~x[1].any(axis=0)] = 1
    return to_device(x, dev)


def k4_ptxas(lib):
    """ptxas' report of one segment's library (build.BUILD_LOG, -Xptxas
    -v): the registers of its k4_seg entry and the largest stack frame
    and spill (stores or loads, bytes) of any function in it; None where
    the library was not built in this run."""
    log = build.BUILD_LOG.get(lib)
    if log is None:
        return None
    out = {"registers": None, "stack": 0, "spill": 0}
    entry = False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = "k4_seg" in line
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out["stack"] = max(out["stack"], int(m[1]))
            out["spill"] = max(out["spill"], int(m[2]), int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out["registers"] = int(m[1])
            entry = False
    return out


def phase_segments_primes(paths, progs, dev, B, rehearse):
    """Phase S8: the segments at each of the eight --prime fields.  The op
    circuit (every op a segment holds) and LessThan(lt_bits) forced onto
    the segments (progs s8_<circuit>_<field>) run at B lanes through
    witness_path: a run and the R1CS check of every lane (KC), launches
    counted around exactly that (path s8_<circuit>_<field>: K4 and KC,
    nothing else), S8_HOST_LANES sampled lanes against the host
    calculator; then the S8_EDGES edge lanes against it; a run's median
    and peak (segment_run, untraced: in the first chip run of this phase
    the profiler dropped one of LessThan's 20 K4 records in every pass
    from the fourth field on, where the launch counts were exact); K4
    against its plain version on every segment at all B lanes, in place
    (phase_k4_program), its summed time by CUDA events against both
    bounds, and the idle share as 1 - that time over the run's median (a
    run's device work is its K4 launches: the launch counts, and S's and
    S4's traces); each segment's registers, stack, spills and nvcc
    seconds.  Returns the K4 max abs err and each case's numbers."""
    err, out = 0, {}
    t0 = time.perf_counter()
    interp = ("interp_k1a", "interp_k1b", "interp_k1c", "interp_k1d")
    for k, prime in enumerate(P8_PRIMES):
        for j, circuit in enumerate(("ops", "lt")):
            name = f"s8_{circuit}_{prime}"
            cc, prog = progs[name]
            x = s8_inputs(cc, prog, circuit, B, SEED + 80 + 2 * k + j, dev)
            names = ["a", "b", "c"][:prog.n_inputs]

            def host_map(ins):
                return dict(zip(names, ins))

            label = f"S8 {circuit}/{prime}"
            t = witness_path(paths, name, cc, prog, x, ("k4", "r1cs_check"),
                             host_map, never=interp + K5_K6 + KW_NEVER
                             + ("assemble", "scan"), n_lanes=S8_HOST_LANES)
            edges = list(range(min(S8_EDGES, B)))
            ins, got = lane_values(prog.run(x), x, edges)
            check_host_lanes(cc, ins, got, edges, host_map, label)
            t.update(segment_run(prog, x, label, rehearse, trace=False))
            e, ms, plain_ms, nbytes, ops, *_ = phase_k4_program(prog, x,
                                                                label)
            err = max(err, e)
            t["idle"] = None if rehearse else round(
                max(0.0, 1 - ms / t["median_ms"]), 3)
            lib = build.generated_name(prog.fused.source())
            segs = [{"nvcc_s": build.BUILD_SECONDS.get(f"{lib}-s{s}"),
                     **(k4_ptxas(f"{lib}-s{s}") or {})}
                    for s in range(len(prog.fused.kernels))]
            t_bytes, t_ops = bounds(nbytes, ops)
            t.update(L=prog.spec.n_limbs, k4_ms=ms, plain_ms=plain_ms,
                     bytes_bound_ms=t_bytes, ops_bound_ms=t_ops,
                     segments=segs)
            say(f"  {label} (L = {prog.spec.n_limbs}, "
                f"{len(prog.fused.kernels)} segments, {B} lanes): every lane "
                f"passes its check, {len(edges)} edge and "
                f"{S8_HOST_LANES} sampled lanes equal the host; run median "
                f"{t['median_ms']:.3f} ms, idle {t['idle']}; K4 "
                f"{ms:.4f} ms, bounds {t_bytes:.4f} (bytes), {t_ops:.4f} "
                f"(operations); segments " + "; ".join(
                    f"{g.get('registers')} registers, stack "
                    f"{g.get('stack')}, spill {g.get('spill')}, nvcc "
                    + ("cached" if g["nvcc_s"] is None
                       else f"{g['nvcc_s']:.1f} s") for g in segs)
                + f"; {CARD}")
            out[name] = t
            del x
    say(f"  phase S8: {len(out)} cases in {time.perf_counter() - t0:.1f} s")
    return err, out


def segment_perop_paths(paths, rep, progs, dev, B, b_div, b_qs, rehearse):
    """Phases S, S4, U, S8, O, Q, QS, KS and W: Num2Bits(254) and 4 x
    Num2Bits(254) over bn128 at batch B through the segments (K4), K4
    against its plain version on their segments and on the op circuits,
    the op circuit and LessThan on the segments at the eight --prime
    fields (phase_segments_primes),
    bigint-div + Num2Bits(254) over bn128 at batch b_div straight-line
    (one KS launch, bit for bit against the per-node path on the card),
    16 x Num2Bits(254) on the scan (scan_paths: one KS launch), and the
    entry point on a Num2Bits(254) artifact."""
    out = {}
    bn = field_spec("bn128")
    interp = ("interp_k1a", "interp_k1b", "interp_k1c", "interp_k1d")
    k4 = {}
    for name, label, seed in (("n2b254", "Num2Bits(254)/bn128", 13),
                              ("n2b254x4", "4 x Num2Bits(254)/bn128", 14)):
        cc, prog = progs[name]
        if not isinstance(prog.fused, SegmentedProgram):
            raise SystemExit(f"FAIL {label}: not on the segments")
        x = edge_inputs(bn, prog.n_inputs, B, SEED + seed, dev)
        say(f"phase {'S' if name == 'n2b254' else 'S4'}: the {label} path "
            f"(batch {B}, {prog.fused.stats()})")
        out[name] = witness_path(paths, name, cc, prog, x,
                                 ("k4", "r1cs_check"), lambda ins: {"a": ins},
                                 never=interp + K5_K6 + KW_NEVER
                                 + ("assemble", "scan"))
        out[name].update(segment_run(prog, x, label, rehearse))
        k4[name] = phase_k4_program(prog, x, label)
        del x
    say("phase U: K4 against its plain version on the op circuits")
    unit_err = phase_k4_units(progs, dev, 400 if rehearse else 4096)
    say(f"phase S8: the segments at the eight --prime fields (the op "
        f"circuit and LessThan, batch {B})")
    s8_err, out["s8"] = phase_segments_primes(paths, progs, dev, B,
                                               rehearse)
    (err, ms, plain_ms, nbytes, ops, cross_bytes, moved), s4 = (
        k4["n2b254"], k4["n2b254x4"])
    # nvcc's seconds a program: its segments' libraries, built in
    # parallel (the longest) and in all; null when a library was found
    # built in _build/ and not compiled in this run
    nvcc = {}
    for name, (_cc, prog) in progs.items():
        lib = build.generated_name(prog.fused.source())
        t = [build.BUILD_SECONDS.get(f"{lib}-s{s}")
             for s in range(len(prog.fused.kernels))]
        nvcc[name] = None if None in t else {"max_s": max(t),
                                             "sum_s": sum(t)}
    rep.add("k4", K4_SOURCE, K4_REPLACES, max(err, s4[0], unit_err, s8_err),
            ms,
            plain_ms, nbytes, ops, plan="Num2Bits(254)/bn128", s4_ms=s4[1],
            s4_plain_ms=s4[2], s4_bound_ms=bound(s4[3], s4[4])[0],
            s4_bound_by=bound(s4[3], s4[4])[1],
            s4_ops_bound_ms=bounds(s4[3], s4[4])[1], nvcc_s=nvcc,
            on_path="S, S4, S8", s8=out["s8"],
            cross_bytes=cross_bytes, s4_cross_bytes=s4[5],
            moved_bytes=moved, s4_moved_bytes=s4[6],
            run_median_ms=out["n2b254"]["median_ms"],
            run_peak_gib=out["n2b254"]["peak_gib"],
            s4_run_median_ms=out["n2b254x4"]["median_ms"],
            s4_run_peak_gib=out["n2b254x4"]["peak_gib"])
    out["k4"] = {"n2b254": ms, "n2b254x4": s4[1]}

    cc = compile_source(bigdiv_num2bits_source())
    prog = WitnessProgram(cc.build_tape()[0], bn, device=dev)
    if prog.perop is None:
        raise SystemExit("FAIL bigint-div + Num2Bits(254)/bn128: not on the "
                         "straight-line path")
    rng = random.Random(5)        # bench.py's bigint-div inputs
    x = to_device(prog.encode_inputs(
        [[rng.randrange(bn.p) for _ in range(b_div)],
         [rng.randrange(1, bn.p) for _ in range(b_div)]]), dev)
    ks = prog.perop.ks
    say(f"phase O: the bigint-div + Num2Bits(254)/bn128 path (batch "
        f"{b_div}, straight-line: {prog.perop.n_live()} live of "
        f"{len(prog.dt.ops)} nodes, unroll {prog.unroll}; one KS launch: "
        f"{ks_stats(ks, ks.width(b_div))})")
    out["bigdiv_bits"] = witness_path(
        paths, "bigdiv_bits", cc, prog, x, ("scan", "r1cs_check"),
        lambda ins: {"a": ins[0], "b": ins[1]}, never=SCAN_NEVER)
    wit = prog.run(x)
    oracle, node_ms = wall_ms(lambda: prog.perop.run_nodes(x))
    if not same_witness(wit, oracle):
        raise SystemExit("FAIL bigint-div + Num2Bits(254)/bn128: KS's "
                         "witness differs from the per-node path's")
    del wit, oracle
    ms = wall_ms(lambda: prog.run(x))[1]
    idle = None if rehearse else ks_idle_share(prog, x, ms)
    out["bigdiv_bits"].update(warm_ms=ms, idle=idle, per_node_ms=node_ms)
    say(f"  O: the run's witness equals the per-node path's bit for bit "
        f"(the per-node path {node_ms:.1f} ms); one-launch run "
        f"{ms:.3f} ms, idle share "
        + ("not measured" if idle is None else f"{idle:.3f}"))
    del prog, x
    out.update(scan_paths(paths, rep, dev, b_div, b_qs, rehearse))

    say("phase W: the witness entry point (Num2Bits(254)/bn128)")
    p = bn.p
    phase_entry_point(progs["n2b254"][0], dev.type, "n2b",
                      [{"a": [v]} for v in (0, 1, p - 1, 1 << 253,
                                            ((1 << 254) - 1) % p)])
    return out


def run_launches(prog, x):
    """(the witness, the launches of this one run by kernel, counts zeroed
    just before)."""
    sync_all()
    build.reset_launches()
    wit = prog.run(x)
    sync_all()
    return wit, dict(build.LAUNCHES)


def same_witness(a, b):
    """Two uint32 witnesses equal bit for bit (compared a row slice at a
    time through int32 views)."""
    if a.shape != b.shape:
        return False
    return all(torch.equal(a[s:s + 256].view(torch.int32),
                           b[s:s + 256].view(torch.int32))
               for s in range(0, a.shape[0], 256))


def ks_of(prog):
    """The KsProgram of a per-op program: its scan's or its straight-line
    path's."""
    return (prog.scan or prog.perop).ks


def ks_idle_share(prog, x, run_ms):
    """The device's idle share of a per-op run that took run_ms by the
    host clock.  The run is one KS launch, so the device is busy for that
    launch alone: timed here by CUDA events around the bare launch on the
    same tables and inputs.  (Within this long process the profiler
    recorded no KS kernel, where a process of its own recorded it.)"""
    ks = ks_of(prog)
    d = ks.device_tables(ks.width(x.shape[-1]))
    spill, out = ks_buffers(ks, d["t"], x.shape[-1], x.device)
    busy = time_ms(lambda: launch_scan(ks.field, d, x, spill, out), reps=3)
    return max(0.0, 1 - busy / run_ms)


def ks_stats(ks, warps):
    """A line of KS's tables at `warps` a block: live registers, shared
    bytes a block, spilled registers, steps."""
    t = ks.tables(warps)
    return (f"{warps} warps a block, {t.n_regs} registers ("
            f"{t.smem_bytes(ks.field.L)} shared bytes a block, "
            f"{t.n_spill} spilled), {t.n_steps} steps, {len(t.ent)} "
            "entries")


def phase_scan_kernels(rep, prog, B, key):
    """K2, K5 and K6 at the shapes a scan step of `prog` gives them, bit
    for bit against their plain versions on the same card tensors: K2
    gathers the S rows of the first add step's operands from a random
    register file (n_regs, L, B), made on the device, K6 adds and
    subtracts them, K5 multiplies them and scales them by R^2 (mul_norm's
    constant).  K2 is timed around its bare launch, as a step launches
    it, K5 and K6 around their wrappers; the kernel rows gain the step's
    shape, ms and bound under `key`."""
    dev, f, sched = prog.device, prog.field, prog.scan.sched
    L, S = f.L, sched.slots
    opc, a_i, b_i = sched.tables[:3]
    step = list(opc).index(sched.branch_ops.index("add"))
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    bank = torch.randint(0, 1 << 16, (sched.n_regs, L, B), generator=gen,
                         dtype=torch.int32, device=dev)
    bank[:, L - 1] = torch.randint(0, f.p >> (16 * (L - 1)),
                                   (sched.n_regs, B), generator=gen,
                                   dtype=torch.int32, device=dev)
    bank = bank.view(torch.uint32)
    ia, ib = (to_device(t[step], dev) for t in (a_i, b_i))
    a, b = gather_w(bank, ia), gather_w(bank, ib)
    err = max(max_abs_err(a, gather_rows(bank, ia)),
              max_abs_err(b, gather_rows(bank, ib)))
    r2 = as_u32(f.R2_limbs)
    out = torch.empty_like(a)
    cases = {"gather_w": (bare(dev, lambda: launch_gather_w(bank, ia, out),
                               lambda: gather_w(bank, ia)), None),
             "add": (lambda: fk.add(f, a, b), lambda: f.add(a, b)),
             "sub": (lambda: fk.sub(f, a, b), lambda: f.sub(a, b)),
             "mont_mul": (lambda: fk.mont_mul(f, a, b),
                          lambda: f.mont_mul(a, b))}
    err_r2 = max_abs_err(fk.mont_mul(f, a, r2), f.mont_mul(a, r2))
    # K2 reads each distinct row once (padding slots all read register
    # 0) and writes S; K5 and K6 read two (S, L, B) operands, write one
    row = 4 * L * B
    k2_bytes = row * (len(np.unique(a_i[step])) + S)
    for name, (kern, plain) in cases.items():
        e = err if plain is None else max_abs_err(kern(), plain())
        e = max(e, err_r2) if name == "mont_mul" else e
        if e:
            raise SystemExit(f"FAIL {name} at the scan step's shape: max "
                             f"abs err {e}")
        ms = time_ms(kern, reps=20)
        nbytes = k2_bytes if name == "gather_w" else 3 * S * row
        ops = k5_ops(L) * S * B if name == "mont_mul" else 0
        b_ms, b_by = bound(nbytes, ops)
        rep.rows[name].update({f"{key}_shape": [S, L, B],
                               f"{key}_ms": ms, f"{key}_bound_ms": b_ms,
                               f"{key}_bound_by": b_by})
        say(f"  {name} at the scan step's shape ({S}, {L}, {B}): bit-exact;"
            f" {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by})")
    del bank, a, b, out


def scan_paths(paths, rep, dev, b_q, b_qs, rehearse):
    """Phases Q, QS and KS: 16 x Num2Bits(254)/bn128, 9,415 ops, above
    both fused backends' limits and the default unroll threshold, so on
    the scan executor, as in the JAX package: one KS launch a run, never
    K1, K4 or the step loop's kernels (K2, K5, K6).  Q: at batch b_q,
    every lane through the R1CS check and 8 against the host calculator;
    its witness bit for bit against the per-node path of the same tape
    and inputs on the card (the straight-line program's plain version at
    unroll_threshold 2^30), both timed, with their launches, the scan's
    idle share; K2, K5 and K6 at a loop step's shape against their plain
    versions.  QS: at batch b_qs with 8 and 64 slots a step (the same KS
    tables), every lane checked, the two witnesses equal bit for bit, 4
    lanes against the host; run ms, witnesses/s, launches, idle share and
    peak memory.  KS: phase_ks."""
    bn = field_spec("bn128")
    never = SCAN_NEVER
    must = ("scan", "r1cs_check")
    host_map = (lambda ins: {"a": ins})
    cc = compile_source(num2bits_source(254, 16))
    tape = cc.build_tape()[0]
    prog = WitnessProgram(tape, bn, device=dev)
    if prog.scan is None:
        raise SystemExit("FAIL 16 x Num2Bits(254)/bn128: not on the scan")
    sched = prog.scan.sched
    x = edge_inputs(bn, prog.n_inputs, b_q, SEED + 15, dev)
    say(f"phase Q: the 16 x Num2Bits(254)/bn128 path (batch {b_q}, scan: "
        f"{len(prog.dt.ops)} nodes, {sched.n_witness} witness rows; KS "
        f"{ks_stats(prog.scan.ks, prog.scan.ks.width(b_q))}; the step loop "
        f"{sched.n_steps} steps of {sched.slots} slots, {sched.n_regs} "
        f"registers; unroll {prog.unroll})")
    out = {"n2b254x16": witness_path(paths, "n2b254x16", cc, prog, x, must,
                                     host_map, never=never, n_lanes=8)}
    phase_scan_kernels(rep, prog, b_q, "q_step")
    line = WitnessProgram(tape, bn, device=dev, unroll_threshold=1 << 30)
    if line.perop is None:
        raise SystemExit("FAIL 16 x Num2Bits(254)/bn128: no straight-line "
                         "program at unroll_threshold 2^30")
    wit, n_scan = run_launches(prog, x)
    sync_all()
    build.reset_launches()
    wit_line, node_ms = wall_ms(lambda: line.perop.run_nodes(x))
    n_line = dict(build.LAUNCHES)
    if not same_witness(wit, wit_line):
        raise SystemExit("FAIL 16 x Num2Bits(254)/bn128: the scan's witness "
                         "differs from the per-node path's")
    del wit, wit_line
    ms = wall_ms(lambda: prog.run(x))[1]     # the witness not kept
    q = {"scan": {"run_ms": ms, "launches": n_scan, "idle": (
             None if rehearse else ks_idle_share(prog, x, ms))},
         "per-node": {"run_ms": node_ms, "launches": n_line, "idle": None}}
    for label, t in q.items():
        rate = b_q / t["run_ms"] * 1e3
        say(f"  Q {label}: run {t['run_ms']:.1f} ms ({rate:.0f} "
            f"witnesses/s), launches {t['launches']}, idle share "
            + ("not measured" if t["idle"] is None else f"{t['idle']:.3f}"))
    say(f"  Q: the scan's witness equals the per-node path's bit for bit; "
        f"scan {q['per-node']['run_ms'] / q['scan']['run_ms']:.2f}x as "
        "fast")
    out["q_compare"] = q
    del prog, line, x
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    x = edge_inputs(bn, tape.n_inputs, b_qs, SEED + 21, dev)
    checker = R1CSChecker(cc.r1cs_rows(), cc.counts()["n_wires"], bn,
                          device=dev)
    first = None
    for slots in (8, 64):
        name = f"n2b254x16_s{slots}"
        prog = WitnessProgram(tape, bn, device=dev, slots=slots)
        sched, ks = prog.scan.sched, prog.scan.ks
        warps = ks.width(b_qs)
        spill_gb = ks.tables(warps).n_spill * 32 * b_qs / 1e9
        say(f"phase QS: the 16 x Num2Bits(254)/bn128 scan at batch {b_qs}, "
            f"{slots} slots (the loop's {sched.n_steps} steps; KS "
            f"{ks_stats(ks, warps)}: a spilled file of {spill_gb:.1f} GB "
            f"beside a {sched.n_witness * 64 * b_qs / 1e9:.1f} GB witness)")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

        def run_and_check():
            wit, ms = wall_ms(lambda: prog.run(x))
            ok, check_ms = wall_ms(lambda: checker.check(wit))
            n_bad = int((~ok).sum())
            if n_bad:
                raise SystemExit(f"FAIL QS at {slots} slots: {n_bad} of "
                                 f"{b_qs} lanes violate a constraint")
            return wit, ms, check_ms

        wit, ms, check_ms = paths.run(name, run_and_check, must, never)
        peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                if dev.type == "cuda" else None)
        if first is None:
            first = wit
            lanes = random.Random(SEED).sample(range(b_qs), min(4, b_qs))
            check_host_lanes(cc, *lane_values(wit, x, lanes), lanes,
                             host_map, "QS")
        elif not same_witness(first, wit):
            raise SystemExit("FAIL QS: the witness at 64 slots differs from "
                             "the one at 8")
        del wit
        warm = wall_ms(lambda: prog.run(x))[1]    # the witness not kept
        idle = None if rehearse else ks_idle_share(prog, x, warm)
        out[name] = {"run_ms": warm, "first_ms": ms, "check_ms": check_ms,
                     "idle": idle, "peak_gib": peak,
                     "launches": paths.counts[name]}
        say(f"  QS {slots} slots: run {warm:.1f} ms warm "
            f"({b_qs / warm * 1e3:.0f} witnesses/s), {ms:.1f} ms first; "
            f"R1CS check of all {b_qs} "
            f"lanes {check_ms:.1f} ms; idle share "
            + ("not measured" if idle is None else f"{idle:.3f}")
            + "; peak device memory "
            + ("not measured" if peak is None else f"{peak:.1f} GiB")
            + ("; the witness equals the one at 8 slots bit for bit"
               if slots != 8 else ""))
    del first, x
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    phase_scan_kernels(rep, prog, b_qs, "qs_step")
    del prog
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["ks"] = phase_ks(rep, tape, dev, b_q, b_qs, b_q, rehearse)
    return out


def ks_buffers(ks, t, B, dev):
    """KS's spilled file (n_spill, L/2, B), None when nothing spills, and
    witness (n_witness, L, B), uint32, as KsProgram.run allocates them."""
    L = ks.field.L
    spill = (torch.empty((t.n_spill, L // 2, B), dtype=torch.int32,
                         device=dev).view(torch.uint32) if t.n_spill
             else None)
    return spill, torch.empty((ks.n_witness, L, B), dtype=torch.int32,
                              device=dev)


def phase_ks(rep, tape, dev, b_q, b_qs, b_div, rehearse):
    """Phase KS: kernel KS on 16 x Num2Bits(254)/bn128 (Q's scan at b_q
    lanes, QS's at b_qs with 8 and 64 slots: the same KS tables) and on
    bigint-div + Num2Bits(254)/bn128 (O's straight-line path at b_div).
    At each width of KS_WIDTHS: the tables' live registers, shared bytes
    a block, spilled registers and steps; KS's bare launch timed and held
    bit for bit against the plain version on the card (the step loop, K2,
    K5, K6 and plain PyTorch, for Q and QS; the per-node path for O; each
    timed once a shape: KS's plain ms), against the compulsory bytes
    (ks_bytes: the inputs read once, the witness written once, and any
    spilled register's traffic) and the operations (ks_ops), the shared
    file's traffic beside.  Then the kept width's run
    (WitnessProgram.run) at each shape: launches, ms, idle share, and
    the device memory it allocates beyond its inputs.  KS's row: ms at Q
    with the kept width, every shape and width."""
    bn = field_spec("bn128")
    progs = {s: WitnessProgram(tape, bn, device=dev, slots=s) for s in (8, 64)}
    cc = compile_source(bigdiv_num2bits_source())
    progs["o"] = WitnessProgram(cc.build_tape()[0], bn, device=dev)
    say(f"phase KS: KS on Q's tape at {b_q} and {b_qs} lanes (8 and 64 "
        f"slots) and O's at {b_div}; widths {KS_WIDTHS} warps a block, "
        f"{ks_of(progs[8]).width(b_q)} kept on Q, "
        f"{ks_of(progs[8]).width(b_qs)} on QS, "
        f"{ks_of(progs['o']).width(b_div)} on O")
    cuda = dev.type == "cuda"
    res, want = {}, None
    for label, key, B in (("q", 8, b_q), ("qs8", 8, b_qs),
                          ("qs64", 64, b_qs), ("o", "o", b_div)):
        prog = progs[key]
        ks = ks_of(prog)
        if key == "o":
            rng = random.Random(5)
            x = to_device(prog.encode_inputs(
                [[rng.randrange(bn.p) for _ in range(B)],
                 [rng.randrange(1, bn.p) for _ in range(B)]]), dev)
        else:
            x = edge_inputs(bn, prog.n_inputs, B, SEED + 21, dev)
        row = res[label] = {"lanes": B, "kept_warps": ks.width(B)}
        if key != 64:
            # the plain version's second run is timed: its first loads
            # K2, K5 and K6
            want = None
            if cuda:
                torch.cuda.empty_cache()
            plain = (prog.perop.run_nodes if key == "o"
                     else prog.scan.run_loop)
            want = plain(x)
            want, row["plain_ms"] = wall_ms(lambda: plain(x))
        for warps in KS_WIDTHS:
            t = ks.tables(warps)
            by = ks_bytes(t, bn.n_limbs)
            ops = ks_ops(t, bn.p)
            bound_b = (by["compulsory"] + by["spill"]) * B
            t_bytes, t_ops = bounds(bound_b, ops * B)
            w = row[f"w{warps}"] = {
                "registers": t.n_regs, "smem_bytes": t.smem_bytes(bn.n_limbs),
                "spilled": t.n_spill, "steps": t.n_steps,
                "entries": len(t.ent), "bytes_bound_ms": t_bytes,
                "ops_bound_ms": t_ops,
                "shared_gb": by["shared"] * B / 1e9}
            if cuda:
                d = ks.device_tables(warps)
                spill, got = ks_buffers(ks, t, B, dev)
                w["ms"] = time_ms(lambda: launch_scan(ks.field, d, x, spill,
                                                      got),
                                  reps=5 if B <= b_q else 3)
                del spill
            else:
                w["ms"] = time_ms(lambda: prog.run(x), reps=1)
                got = prog.run(x)
            err = max_abs_err(got.view(torch.uint32), want)
            say(f"  KS {label} ({B} lanes), {ks_stats(ks, warps)}: "
                f"{w['ms']:.4f} ms, " + (f"max abs err {err}" if err else
                                         "bit-exact against the plain "
                                         "version")
                + f"; bounds: compulsory {t_bytes:.4f} ms, operations "
                f"{t_ops:.4f} ms; shared file {w['shared_gb']:.2f} GB")
            if err:
                raise SystemExit(f"FAIL KS on {label} at {warps} warps: "
                                 f"differs from its plain version")
            del got
            if cuda:
                torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        wit, n = run_launches(prog, x)
        row["alloc_gib"] = ((torch.cuda.max_memory_allocated(dev) - base)
                            / 2 ** 30 if cuda else None)
        del wit
        row["run_ms"] = wall_ms(lambda: prog.run(x))[1]
        row["launches"] = n
        row["idle"] = (None if rehearse else
                       ks_idle_share(prog, x, row["run_ms"]))
        kept = row[f"w{row['kept_warps']}"]
        row.update(ms=kept["ms"], comp_bound_ms=kept["bytes_bound_ms"],
                   ops_bound_ms=kept["ops_bound_ms"])
        say(f"  KS {label}: run {row['run_ms']:.3f} ms at {row['kept_warps']} "
            "warps, "
            f"launches {n}, idle share "
            + ("not measured" if row["idle"] is None
               else f"{row['idle']:.3f}")
            + ", allocates " + ("not measured" if row["alloc_gib"] is None
                                else f"{row['alloc_gib']:.2f} GiB")
            + (f"; the plain version {row['plain_ms']:.1f} ms"
               if "plain_ms" in row else ""))
        del x
    del want
    if cuda:
        torch.cuda.empty_cache()
    q = res["q"]
    t = ks_of(progs[8]).tables(q["kept_warps"])
    by = ks_bytes(t, bn.n_limbs)
    rep.add("scan", KS_SOURCE, KS_REPLACES, 0, q["ms"], q["plain_ms"],
            (by["compulsory"] + by["spill"]) * b_q, ks_ops(t, bn.p) * b_q,
            shared_gb=by["shared"] * b_q / 1e9, widths=list(KS_WIDTHS),
            kept_warps=q["kept_warps"], shapes=res,
            on_path="Q, QS8, QS64, O, CL, MH")
    return res


def lane_ints(a):
    """uint32 limb rows (rows, L, lanes), numpy -> each lane's ints, row r
    the sum of limb i << 16 i (limbs_to_int's value for 16-bit limbs,
    exact for any limb): the even limbs and the odd ones each read as one
    little-endian integer of 32-bit words, a row at a time (limbs_to_int
    a value took ~20 s for 64 lanes of SHA256's 27,369 rows)."""
    rows, L, _ = a.shape
    ne, no = 4 * ((L + 1) // 2), 4 * (L // 2)
    out = []
    for lane in np.ascontiguousarray(a.transpose(2, 0, 1), dtype="<u4"):
        ev, od = lane[:, 0::2].tobytes(), lane[:, 1::2].tobytes()
        out.append([int.from_bytes(ev[r * ne:(r + 1) * ne], "little")
                    + (int.from_bytes(od[r * no:(r + 1) * no], "little")
                       << 16) for r in range(rows)])
    return out


def lane_values(wit, x, lanes):
    """(each lane's input ints, each lane's witness ints) of `lanes`."""
    sel = torch.as_tensor(lanes, device=wit.device)
    return (lane_ints(t.view(torch.int32).index_select(2, sel).cpu().numpy()
                      .view(np.uint32)) for t in (x, wit))


def check_host_lanes(cc, ins, got, lanes, host_map, label):
    """The first len(ins) lanes' witness ints `got` equal the host
    calculator's on their inputs `ins`."""
    for j, lane in enumerate(lanes[:len(ins)]):
        if got[j] != list(cc.witness_host(host_map(ins[j]))):
            raise SystemExit(f"FAIL {label} lane {lane}: witness differs "
                             "from the host calculator")
    say(f"  {len(ins)} sampled lanes equal the host calculator")


def input_map(layout):
    """The input map of a lane's input ints, by the tape's input layout."""
    def to_map(ins):
        out = {}
        for name, dims, off in layout:
            n = int(np.prod(dims))
            out[name] = list(ins[off:off + n]) if dims else ins[off]
        return out
    return to_map


def hinted_inputs(spec, n_inputs, hints, B, seed, dev):
    """Random canonical inputs (n_inputs, L, B); the rows of range-hinted
    inputs (Merkle's pathIndex) hold random values inside their hints."""
    rng = np.random.default_rng(seed)
    x = canonical_np(rng, spec, (n_inputs, spec.n_limbs, B))
    for i, (lo, hi) in hints.items():
        x[i] = 0
        x[i, 0] = rng.integers(lo, hi + 1, size=B, dtype=np.uint32)
    return to_device(x, dev)


def must_launch(prog):
    """The kernels a run and R1CS check of an interpreter program launch,
    read off its plan: K1's parts, K2 where the witness is the wide
    bank's rows in witness order, else KW; KC (the check)."""
    interp = prog.interp
    return (*interp.plan.parts,
            "gather_w" if interp._k2_whole else "assemble", "r1cs_check")


def never_launch(prog):
    """The kernels such a run must not launch: K5 and K6, and K2 and K3
    where KW assembles the witness."""
    return K5_K6 + (() if prog.interp._k2_whole else KW_NEVER)


def mimc_merkle_paths(paths, dev, b_mm, b_mk, b_k1, rehearse):
    """Phases MM and MK: MultiMiMC7(5)/bn128 at batch b_mm and
    MerkleInclusion(32)/bn128 at b_mk (random pathIndex bits a lane),
    each through witness_path (run, R1CS check of every lane, sampled
    lanes against the host and the native calculator), then K1 against
    the plain executor on the path's plan at b_k1 lanes, every emitted
    row (MK's 14,055 steps take the plain executor about a minute on the
    card; a CPU rehearsal holds MerkleInclusion(4)'s plan, MK's opcodes
    at an eighth of its depth, instead).  Returns each path's compile,
    tape, input layout and hints, its WitnessProgram and
    NativeCalculator, times and batch."""
    bn = field_spec("bn128")
    out = {}
    for name, phase, label, src, B, n_host in (
            ("mimc", "MM", "MultiMiMC7(5)/bn128", mimc_source(5), b_mm,
             SAMPLE_LANES),
            ("merkle", "MK", "MerkleInclusion(32)/bn128", merkle_source(32),
             b_mk, MK_HOST_LANES)):
        t0 = time.perf_counter()
        cc = compile_source(src)
        tape, layout = cc.build_tape()
        hints = cc.input_range_hints()
        prog = WitnessProgram(tape, bn, device=dev, input_ranges=hints)
        calc = NativeCalculator(tape, bn, input_ranges=hints)
        plan = prog.interp.plan
        x = hinted_inputs(bn, prog.n_inputs, hints, B, SEED + 16 + len(out),
                          dev)
        say(f"phase {phase}: the {label} path (batch {B}; compiled and "
            f"planned in {time.perf_counter() - t0:.1f} s: {len(tape.ops)} "
            f"tape ops, {plan.n_steps} steps, parts {', '.join(plan.parts)}, "
            f"{prog.n_witness} witness rows ({len(plan.nw_src)} narrow), "
            f"{len(cc.r1cs_rows())} constraints)")
        t = witness_path(paths, name, cc, prog, x, must_launch(prog),
                         input_map(layout), never=never_launch(prog),
                         n_lanes=n_host, native=calc,
                         profile_check=name == "merkle", trace=phase,
                         rehearse=rehearse)
        if name == "merkle":
            say("phase KW: KW against the parts route on MK's witness")
            t["kw"] = phase_kw(prog, x, label)
        out[name] = dict(t, B=B, cc=cc, tape=tape, layout=layout,
                         hints=hints, calc=calc, label=label, prog=prog)
        if rehearse and name == "merkle":
            label = "MerkleInclusion(4)/bn128"
            cc4 = compile_source(merkle_source(4))
            prog = WitnessProgram(cc4.build_tape()[0], bn, device=dev,
                                  input_ranges=cc4.input_range_hints())
            x = hinted_inputs(bn, prog.n_inputs, cc4.input_range_hints(),
                              b_k1, SEED + 20, dev)
        err = phase_k1_path(prog, x[..., :b_k1].contiguous(), label)[0]
        if err:
            raise SystemExit(f"FAIL K1 on the {label} plan: max abs err "
                             f"{err}")
        del prog, x
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def random_row(rng, p, hints, n_inputs):
    """One lane's input ints: field elements, and values inside their
    hints for the range-hinted inputs."""
    return [rng.randint(*hints[i]) if i in hints else rng.randrange(p)
            for i in range(n_inputs)]


# the CLI's circuits: path name -> (file name, its source); MiMC and
# Merkle include the port's circuits, bigint-div + Num2Bits(254) holds the
# stdlib
CLI_CIRCUITS = {
    "mimc": ("mimc5", lambda: 'pragma circom 2.0.0;\ninclude "mimc.circom";'
             '\ncomponent main = MultiMiMC7(5);\n'),
    "merkle": ("merkle32", lambda: 'pragma circom 2.0.0;\ninclude '
               '"poseidon.circom";\ninclude "merkle.circom";\n'
               'component main = MerkleInclusion(32);\n'),
    "bigdiv_bits": ("bigdiv_bits", bigdiv_num2bits_source),
}


def cli_runs(mm):
    """phase_cli's circuits: MM's and MK's compiles, tapes and native
    calculators, and bigint-div + Num2Bits(254)/bn128's, whose tape the
    CLI's program (unroll_threshold=0) runs on the scan."""
    bn = field_spec("bn128")
    cc = compile_source(bigdiv_num2bits_source())
    tape, layout = cc.build_tape()
    hints = cc.input_range_hints()
    prog = WitnessProgram(tape, bn, device="cpu", unroll_threshold=0,
                          input_ranges=hints)
    if prog.scan is None:
        raise SystemExit("FAIL CLI: bigint-div + Num2Bits(254) is not on the "
                         "scan at unroll_threshold=0")
    say(f"  bigint-div + Num2Bits(254)/bn128 through the CLI: the scan, "
        f"{prog.scan.sched.n_steps} steps of {prog.scan.sched.slots} slots")
    return {**mm, "bigdiv_bits": dict(
        cc=cc, tape=tape, layout=layout, hints=hints, scan=True,
        calc=NativeCalculator(tape, bn, input_ranges=hints))}


def cli_witness_run(paths, name, cc, tape, hints, rows, nat, device,
                    prog=None):
    """The CLI's witness step in this process on the CLI's inputs: its
    program (cli.py's constructor call: unroll_threshold=0, the range
    hints; or `prog`, the same circuit's interpreter program, whose plan
    does not depend on the threshold) through witness.batch_witnesses at
    --sanity_check 2, counted
    as path cli_<name>_run: on the scan one KS launch and the R1CS check,
    none of SCAN_NEVER; on the interpreter must_launch's kernels (K1, K2
    or KW, the check), none of never_launch's; every witness equals the
    native calculator's."""
    if prog is None:
        prog = WitnessProgram(tape, field_spec("bn128"), device=device,
                              unroll_threshold=0, input_ranges=hints)
    if prog.interp is not None:
        must, never = must_launch(prog), never_launch(prog)
    else:
        must, never = ("scan", "r1cs_check"), SCAN_NEVER
    cols = [[r[i] for r in rows] for i in range(tape.n_inputs)]
    rows_r1cs, n_wires = cc.r1cs_rows(), cc.counts()["n_wires"]
    dec = paths.run(f"cli_{name}_run", lambda: batch_witnesses(
        prog, cols, rows_r1cs, n_wires, 2), must, never)
    if dec is None or any(dec[i][bi] != nat[bi][i]
                          for bi in range(len(rows))
                          for i in range(len(dec))):
        raise SystemExit(f"FAIL CLI on {name}: the witness step in process "
                         "differs from the native calculator")
    say(f"  CLI on {name}: its witness step in this process ({', '.join(must)}"
        f") equals the native calculator on {len(rows)} witnesses")


def phase_cli(paths, runs, device, n):
    """Phase CL: `python -m circom_tpu_torch.cli` in a subprocess on the
    circuits of CLI_CIRCUITS (MM's and MK's, which include the port's
    circuits, -l circom_tpu_torch/circuits, and bigint-div +
    Num2Bits(254), which the CLI runs on the scan) with --r1cs --sym
    --witness-gpu at n witnesses: the .r1cs must equal the port's own
    compile's, every .wtns write_wtns of the native calculator's witness,
    and the first .wtns files (all of those without range-hinted inputs,
    MK_HOST_LANES of Merkle's) that of the host calculator; a Merkle batch
    with a pathIndex of 2 must exit 1 with error[T3015].  The CLI's R1CS
    check (batch_witnesses at --sanity_check 2) is timed in this process
    on the same n witnesses, its launches counted (KC, never K5 or K6).
    Returns the check's ms a circuit."""
    lib = os.path.join(ROOT, "circom_tpu_torch", "circuits")
    bn = field_spec("bn128")      # the CLI's default prime
    check_ms = {}
    rng = random.Random(SEED + 18)
    for path, run in runs.items():
        name, source = CLI_CIRCUITS[path]
        cc, tape, hints = run["cc"], run["tape"], run["hints"]
        to_map = input_map(run["layout"])
        rows = [random_row(rng, cc.p, hints, tape.n_inputs)
                for _ in range(n)]
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            circ = os.path.join(tmp, f"{name}.circom")
            with open(circ, "w") as fh:
                fh.write(source())

            def cli(batch, out):
                inp = os.path.join(tmp, f"{out}.json")
                with open(inp, "w") as fh:
                    json.dump([to_map(r) for r in batch], fh)
                return wall_ms(lambda: subprocess.run(
                    [sys.executable, "-m", "circom_tpu_torch.cli", circ,
                     "-l", lib, "--r1cs", "--sym", "-o",
                     os.path.join(tmp, out), "--witness-gpu", inp,
                     "--device", device],
                    cwd=ROOT, capture_output=True, text=True, timeout=900))

            r, ms = cli(rows, "out")
            if r.returncode != 0:
                raise SystemExit(f"FAIL CLI on {name} (exit {r.returncode}):"
                                 f"\n{r.stdout}\n{r.stderr}")
            ref = os.path.join(tmp, "ref.r1cs")
            cc.write_r1cs(ref)
            with open(ref, "rb") as a, \
                    open(os.path.join(tmp, "out", f"{name}.r1cs"), "rb") as b:
                if a.read() != b.read():
                    raise SystemExit(f"FAIL CLI on {name}: .r1cs differs from "
                                     "the port's own compile")
            if not os.path.exists(os.path.join(tmp, "out", f"{name}.sym")):
                raise SystemExit(f"FAIL CLI on {name}: no .sym written")
            n_host = min(MK_HOST_LANES, n) if hints else n
            nat = run["calc"].run(rows)
            for bi, row in enumerate(rows):
                w = nat[bi][:len(nat[bi]) - tape.n_guards]
                if bi < n_host and w != list(cc.witness_host(to_map(row))):
                    raise SystemExit(f"FAIL CLI on {name}: the native and "
                                     f"the host witness {bi} differ")
                write_wtns(ref, cc.p, w)
                with open(ref, "rb") as a, open(os.path.join(
                        tmp, "out", f"{name}.{bi}.wtns"), "rb") as b:
                    if a.read() != b.read():
                        raise SystemExit(f"FAIL CLI on {name}: witness {bi} "
                                         ".wtns differs from the native "
                                         "calculator's")
            z = to_device(np.stack(
                [ints_to_limbs(w[:len(w) - tape.n_guards], bn.n_limbs)
                 for w in nat], axis=-1), device)
            checker = R1CSChecker(cc.r1cs_rows(), cc.counts()["n_wires"], bn,
                                  device=device)
            checker.check(z)
            ok, check_ms[name] = wall_ms(lambda: paths.run(
                f"cli_{name}", lambda: checker.check(z), ("r1cs_check",),
                K5_K6))
            if not bool(ok.all()):
                raise SystemExit(f"FAIL CLI on {name}: the R1CS check failed "
                                 "a witness")
            say(f"  CLI on {name}: exit 0 in {ms / 1e3:.1f} s; .r1cs equals "
                f"the port's compile, {n} .wtns equal the native "
                f"calculator's, {n_host} the host calculator's; the check "
                f"of the {n} witnesses {check_ms[name]:.2f} ms")
            cli_witness_run(paths, name, cc, tape, hints, rows, nat, device,
                            run.get("prog"))
            if not hints:
                continue
            bad = [list(rows[0]), list(rows[1])]
            bad[1][min(hints)] = 2
            r, _ = cli(bad, "bad")
            if r.returncode != 1 or "error[T3015]" not in r.stderr \
                    or os.path.exists(os.path.join(tmp, "bad",
                                                   f"{name}.0.wtns")):
                raise SystemExit(f"FAIL CLI on {name}: a pathIndex of 2 gave "
                                 f"exit {r.returncode}, not T3015:\n"
                                 f"{r.stderr}")
            say(f"  CLI on {name}: a pathIndex of 2 exits 1 with "
                "error[T3015], no .wtns written")
    return check_ms


# phase CL at another field: name -> (file name, source at a field)
CL_PRIME_CIRCUITS = {"Poseidon2": ("pos", poseidon2_source),
                     "MerkleInclusion(2)": ("merkle2",
                                            lambda _p: merkle_source(2))}


def phase_cli_prime(paths, device, n, prime=CL_PRIME,
                    circuits=("Poseidon2",)):
    """Phase CL at another field: `python -m circom_tpu_torch.cli` with
    --prime <prime> --sanity_check 2 --witness-gpu on each of `circuits`
    (CL_PRIME_CIRCUITS: Poseidon2, P's circuit at the field, whose lazy
    dots subtract p up to three times at secq256r1; MerkleInclusion(2),
    K1a-K1d and KW, its pathIndex bits range-hinted), n witnesses, the
    edge values (0, 1, p - 1, p // 2) first: exit 0 (its R1CS check of
    every witness passing) and every .wtns equal to write_wtns of the
    native calculator's witness and of the host calculator's; then each
    circuit's witness step in this process (cli_witness_run, path
    cli_<file>_<prime>_run) against the native calculator.  Returns the
    CLI's ms a circuit."""
    spec = field_spec(prime)
    p = spec.p
    edges = [0, 1, p - 1, p // 2]
    rng = random.Random(SEED + 19)
    out = {}
    for circuit in circuits:
        name, source = CL_PRIME_CIRCUITS[circuit]
        src = source(prime)
        cc = compile_source(src, prime=prime)
        tape, layout = cc.build_tape()
        hints = cc.input_range_hints()
        to_map = input_map(layout)
        rows = [random_row(rng, p, hints, tape.n_inputs) for _ in range(n)]
        for j, row in enumerate(rows[:len(edges)]):
            for i in range(len(row)):
                if i not in hints:
                    row[i] = edges[(i + j) % len(edges)]
        nat = NativeCalculator(tape, spec, input_ranges=hints).run(rows)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            circ = os.path.join(tmp, f"{name}.circom")
            with open(circ, "w") as fh:
                fh.write(src)
            inp = os.path.join(tmp, "inputs.json")
            with open(inp, "w") as fh:
                json.dump([to_map(r) for r in rows], fh)
            res = os.path.join(tmp, "out")
            r, ms = wall_ms(lambda: subprocess.run(
                [sys.executable, "-m", "circom_tpu_torch.cli", circ,
                 "--prime", prime, "--sanity_check", "2", "-o", res,
                 "--witness-gpu", inp, "--device", device],
                cwd=ROOT, capture_output=True, text=True, timeout=900))
            if r.returncode != 0:
                raise SystemExit(f"FAIL CLI --prime {prime} on {circuit} "
                                 f"(exit {r.returncode}):\n{r.stdout}\n"
                                 f"{r.stderr}")
            ref = os.path.join(tmp, "ref.wtns")
            for bi, row in enumerate(rows):
                w = nat[bi][:len(nat[bi]) - tape.n_guards]
                if w != list(cc.witness_host(to_map(row))):
                    raise SystemExit(f"FAIL CLI --prime {prime} on "
                                     f"{circuit}: the native and the host "
                                     f"witness {bi} differ")
                write_wtns(ref, cc.p, w)
                with open(ref, "rb") as a, \
                        open(os.path.join(res, f"{name}.{bi}.wtns"),
                             "rb") as b:
                    if a.read() != b.read():
                        raise SystemExit(f"FAIL CLI --prime {prime} on "
                                         f"{circuit}: witness {bi} .wtns "
                                         "differs from the native and the "
                                         "host calculator's")
        say(f"  CLI --prime {prime} on {circuit}: exit 0 in {ms / 1e3:.1f} "
            f"s, {n} .wtns equal the native and the host calculator's")
        prog = WitnessProgram(tape, spec, device=device, unroll_threshold=0,
                              input_ranges=hints)
        cli_witness_run(paths, f"{name}_{prime}", cc, tape, hints, rows,
                        nat, device, prog)
        out[circuit] = ms
    return out


def cpu_baseline(runs, n, reps=BASELINE_REPS):
    """The CPU baseline: the native calculator (tapeval.cpp, OpenMP over
    the batch) on n random witnesses of each of MM's and MK's circuits on
    this host, its witnesses/s (the median of `reps` run_raw calls after
    a warm-up of 64, their spread printed) beside the card's for the same
    circuit (the run, and the run with its R1CS check)."""
    bn = field_spec("bn128")
    threads = len(os.sched_getaffinity(0))
    omp = os.environ.get("OMP_NUM_THREADS")
    host = f"{native.cpu_model()}, {threads} threads" + (
        f" (OMP_NUM_THREADS={omp})" if omp else "")
    out = {}
    for name, t in runs.items():
        calc = t["calc"]
        rng = random.Random(SEED + 19)
        x = calc.encode_rows([random_row(rng, bn.p, t["hints"], calc.n_inputs)
                              for _ in range(n)])
        calc.run_raw(x[:64])
        secs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            calc.run_raw(x)
            secs.append(time.perf_counter() - t0)
        secs.sort()
        s = secs[len(secs) // 2]
        rate = n / s
        gpu = t["B"] / t["run_ms"] * 1e3
        checked = t["B"] / (t["run_ms"] + t["check_ms"]) * 1e3
        out[name] = rate
        say(f"CPU baseline, {t['label']}: NativeCalculator {rate:.0f} "
            f"witnesses/s (median of {reps} runs of {n} witnesses, "
            f"{s:.3f} s; runs {n / secs[-1]:.0f}-{n / secs[0]:.0f} "
            f"witnesses/s; {host}); the card {gpu:.0f} witnesses/s run "
            f"({gpu / rate:.1f}x), {checked:.0f} with the R1CS check "
            f"({checked / rate:.2f}x), batch {t['B']}")
    return out


def phase_mesh(paths, mk, lanes, rehearse):
    """Phase MS: MerkleInclusion(32)/bn128 at MS_SHARDS x `lanes`
    witnesses split over a mesh of MS_SHARDS shards (cuda:0..3 where the
    machine has four cards, else four shards one after another on cuda:0;
    [cpu] * 4 in a rehearsal), with MK's compile, program (copied to each
    card, not planned again) and NativeCalculator: shard_program, then
    shard_checker over every lane, each of which must pass (launch counts
    read around exactly this); in every shard SAMPLE_LANES sampled lanes
    against the native calculator and one against the host calculator;
    a warm step's witnesses/s and a warm check's time (and the host's
    time issuing it), each card's peak memory, and on several cards one
    shard's check alone on the first and the last card and a profile of
    the step (the shards overlap where the cards' busy time exceeds the
    wall time)."""
    prog, cc, calc = mk["prog"], mk["cc"], mk["calc"]
    if rehearse:
        devices = [torch.device("cpu")] * MS_SHARDS
    elif torch.cuda.device_count() >= MS_SHARDS:
        devices = [f"cuda:{k}" for k in range(MS_SHARDS)]
    else:
        devices = ["cuda:0"] * MS_SHARDS
    mesh = make_mesh(devices=devices)
    cards = sorted(set(mesh.devices), key=str)
    B = MS_SHARDS * lanes
    say(f"phase MS: the mesh, MerkleInclusion(32)/bn128 at batch {B} in "
        f"{MS_SHARDS} shards of {lanes} on "
        f"{', '.join(map(str, mesh.devices))} ({len(cards)} distinct "
        "device(s))")
    step = shard_program(prog, mesh)
    checker = R1CSChecker(cc.r1cs_rows(), cc.counts()["n_wires"],
                          prog.spec, device=mesh.devices[0])
    check = shard_checker(checker, mesh)
    x = hinted_inputs(prog.spec, prog.n_inputs, mk["hints"], B, SEED + 30,
                      mesh.devices[0])
    if not rehearse:
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)

    def run_and_check():
        shards, run_ms = wall_ms(lambda: step(x))
        ok, check_ms = wall_ms(lambda: check(shards))
        n_bad = int((~ok).sum())
        if n_bad:
            raise SystemExit(f"FAIL MS R1CS check: {n_bad} of {B} lanes "
                             "violate a constraint")
        return shards, run_ms, check_ms

    shards, run_ms, check_ms = paths.run("mesh", run_and_check,
                                         must_launch(prog),
                                         never_launch(prog))
    one_launch(paths, "mesh", mesh.devices[0], MS_SHARDS)
    peaks = {} if rehearse else {
        str(d): torch.cuda.max_memory_allocated(d) / 2 ** 30 for d in cards}
    say(f"  step {run_ms:.1f} ms ({B / run_ms * 1e3:.0f} witnesses/s, "
        f"first run); R1CS check of all {B} lanes {check_ms:.1f} ms, every "
        "lane passes; peak device memory "
        + (", ".join(f"{d} {g:.1f} GiB" for d, g in peaks.items())
           or "not measured (CPU)"))
    to_map = input_map(mk["layout"])
    rng = random.Random(SEED + 31)
    for k, shard in enumerate(shards):
        lanes_k = rng.sample(range(lanes), min(SAMPLE_LANES, lanes))
        w = shard.view(torch.int32).index_select(2, torch.as_tensor(
            lanes_k, device=shard.device)).cpu().numpy().view(np.uint32)
        xs = x.view(torch.int32).index_select(2, torch.as_tensor(
            [k * lanes + j for j in lanes_k], device=x.device)).cpu() \
            .numpy().view(np.uint32)
        ins, got = lane_ints(xs[:prog.n_inputs]), lane_ints(w)
        want = calc.run(ins)
        for j, lane in enumerate(lanes_k):
            if got[j] != want[j][:len(got[j])]:
                raise SystemExit(f"FAIL MS shard {k} lane {lane}: witness "
                                 "differs from the native calculator")
        if got[0] != list(cc.witness_host(to_map(ins[0]))):
            raise SystemExit(f"FAIL MS shard {k} lane {lanes_k[0]}: witness "
                             "differs from the host calculator")
    say(f"  in each of the {MS_SHARDS} shards {len(lanes_k)} sampled lanes "
        "equal the native calculator, one the host calculator")
    del shards
    warm_ms = warm_check_ms = None
    if not rehearse:
        shards, warm_ms = wall_ms(lambda: step(x))
        # the host's issue time beside the check's: equal where the host,
        # not the cards, bounds the check
        sync_all()
        t = time.perf_counter()
        ok = check(shards)
        issue_ms = (time.perf_counter() - t) * 1e3
        sync_all()
        warm_check_ms = (time.perf_counter() - t) * 1e3
        if not bool(ok.all()):
            raise SystemExit("FAIL MS: the warm R1CS check failed a lane")
        say(f"  warm step {warm_ms:.1f} ms ({B / warm_ms * 1e3:.0f} "
            f"witnesses/s), warm R1CS check {warm_check_ms:.1f} ms, "
            f"{issue_ms:.1f} ms of it issuing from the host")
        if len(cards) > 1:
            for k in (0, MS_SHARDS - 1):
                one = shard_checker(checker, make_mesh(
                    devices=[mesh.devices[k]]))
                _, ms = wall_ms(lambda: one(shards[k:k + 1]))
                say(f"  one shard's check alone on {mesh.devices[k]}: "
                    f"{ms:.1f} ms")
        del shards
        busy, ms, *_ = profile_breakdown(lambda: step(x), warm_ms, reps=1,
                                        aten=False)
        idle = round(max(0.0, 1 - busy / ms), 3) if len(cards) == 1 \
            else None
        if len(cards) > 1:
            say(f"  {len(cards)} cards busy {busy:.1f} ms in a {ms:.1f} ms "
                f"step: the shards overlap {busy / ms:.2f}-fold")
    return {"B": B, "run_ms": run_ms, "warm_ms": warm_ms,
            "check_ms": check_ms, "warm_check_ms": warm_check_ms,
            "peaks": peaks, "idle": None if rehearse else idle,
            "devices": [str(d) for d in mesh.devices]}


def phase_multihost(paths, device, rehearse):
    """Phase MH: python -m circom_tpu_torch.parallel.multihost --spawn 2
    in a subprocess: two coordinated processes, each splitting its slice
    over 4 shards on the scan, every lane against the host calculator,
    the verdict all-reduced; its artifact must say ok, checker_all_ok and
    exact parity.  Each process's launches (--launches) must hold one KS
    launch a shard, the R1CS check, and none of SCAN_NEVER; their sum is
    the path's count."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        out = os.path.join(tmp, "mp.json")
        counts = os.path.join(tmp, "launches")
        r, ms = wall_ms(lambda: subprocess.run(
            [sys.executable, "-m", "circom_tpu_torch.parallel.multihost",
             "--spawn", "2", "--device", device, "--out", out,
             "--launches", counts],
            cwd=ROOT, capture_output=True, text=True, timeout=MH_TIMEOUT))
        if r.returncode != 0:
            raise SystemExit(f"FAIL MH (exit {r.returncode}):\n"
                             f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
        with open(out) as fh:
            art = json.load(fh)
        per = []
        for pid in range(2):
            with open(f"{counts}.{pid}") as fh:
                per.append(json.load(fh))
    if not (art["ok"] and art["checker_all_ok"] and art["parity"] == "exact"
            and art["n_processes"] == 2
            and art["elements_checked_per_process"] * 2 == art["batch"]):
        raise SystemExit(f"FAIL MH: {art}")
    shards = art["devices_per_process"]
    for pid, c in enumerate(per):
        bad = [k for k in SCAN_NEVER if c.get(k)]
        if not rehearse and (c.get("scan") != shards or not c.get(
                "r1cs_check") or bad):
            raise SystemExit(f"FAIL MH: process {pid} launched {c}: not one "
                             f"KS launch a shard ({shards}) and the check, "
                             "or a kernel of the step loop")
    paths.counts["mh"] = {k: sum(c.get(k, 0) for c in per)
                          for k in set().union(*per)}
    say(f"  2 processes, {art['global_devices']} shards, batch "
        f"{art['batch']}, platform {art['platform']}: every lane equals the "
        f"host calculator, the all-ok verdict reduced; step "
        f"{art['step_seconds_first_call']} s (first call), command "
        f"{ms / 1e3:.1f} s; {art['mechanism']}; launches {per}")
    return ms


def phase_graft_entry(paths, device):
    """Phase GE: entry()'s function on its arguments (Poseidon2/bn128,
    batch 64; every lane against the host calculator), then
    dryrun_multichip(max(2, cards)); launch counts read around each."""
    fn, (x,) = entry(device)
    out = paths.run("entry", lambda: fn(x), ("interp_k1a", "gather_w"))
    cc = compile_source(poseidon2_source())
    w = out.view(torch.int32).cpu().numpy().view(np.uint32)
    xs = x.view(torch.int32).cpu().numpy().view(np.uint32)
    for j in range(w.shape[2]):
        ins = [limbs_to_int(xs[i, :, j]) for i in range(xs.shape[0])]
        if [limbs_to_int(w[i, :, j]) for i in range(w.shape[0])] != \
                list(cc.witness_host({"inputs": ins})):
            raise SystemExit(f"FAIL GE entry() lane {j}: witness differs "
                             "from the host calculator")
    say(f"  entry(): {tuple(out.shape)}, all {w.shape[2]} lanes equal the "
        "host calculator")
    n = max(2, torch.cuda.device_count())
    _, ms = wall_ms(lambda: paths.run(
        "dryrun", lambda: dryrun_multichip(n, device),
        ("interp_k1a", "interp_k1d", "gather_w", "gather_n", "r1cs_check"),
        K5_K6))
    say(f"  dryrun_multichip({n}) passed its three phases in {ms:.0f} ms")


def sha256_messages(B, seed):
    rng = np.random.default_rng(seed)
    return [bytes(m) for m in rng.integers(0, 256, size=(B, 32),
                                           dtype=np.uint8)]


def profile_check_breakdown(checker, wit, check_ms):
    """One warm R1CS check under the profiler: its device time by kernel,
    KC's (r1cs_check_kernel) among them; and the device memory the check
    allocates beyond the witness, which must stay under 256 bytes a lane
    (z is read in place: a contiguous copy of it would take
    n_wires · L · 4 bytes a lane)."""
    B = wit.shape[-1]
    sync_all()
    torch.cuda.reset_peak_memory_stats(wit.device)
    base = torch.cuda.memory_allocated(wit.device)
    checker.check_detailed(wit)
    sync_all()
    extra = torch.cuda.max_memory_allocated(wit.device) - base
    say(f"  the R1CS check allocates {extra} bytes beyond the witness "
        f"({extra / B:.1f} a lane; a copy of z would be "
        f"{wit.shape[0] * wit.shape[1] * 4} a lane)")
    if extra > 256 * B:
        raise SystemExit(f"FAIL: the R1CS check allocates {extra} bytes "
                         f"for {B} lanes: a copy of z")
    say("  the R1CS check:")
    # three checks a profiler step: traced one at a time, the kernels of
    # MK's one-launch check went unrecorded
    profile_breakdown(lambda: checker.check_detailed(wit), check_ms, reps=1,
                      aten=False, show=("r1cs_check_kernel",), runs=3)


def sha256_path(paths, cc, prog, dev, B):
    """Phase B: SHA256/bn128 mixed witnesses at batch B through
    run_mixed; every lane's digest against hashlib, sampled lanes against
    the host calculator."""
    msgs = sha256_messages(B, SEED + 5)
    x = to_device(sha256_io.input_rows(msgs), dev)
    want = to_device(sha256_io.digest_bits_batch(msgs), dev)
    layout = prog.mixed_layout()
    (narrow, _wide), first_ms = wall_ms(lambda: paths.run(
        "sha256_mixed", lambda: prog.run_mixed(x),
        ("interp_k1b", "gather_n")))
    got = sha256_io.digest_bits_from_witness(narrow, layout)
    n_bad = int((got != want).any(dim=0).sum())
    if n_bad:
        raise SystemExit(f"FAIL SHA256: {n_bad} of {B} digests differ from "
                         "hashlib's")
    say(f"  all {B} digests equal hashlib's (first run {first_ms:.1f} ms)")
    del got
    # the best of three warm runs: a run may allocate its 7.2 GB output
    # anew (on an H100 one such run took 59 ms, the profiled runs 9 ms)
    run_ms = min(wall_ms(lambda: prog.run_mixed(x))[1] for _ in range(3))
    say(f"  mixed witnesses: {tuple(narrow.shape)} int32 in {run_ms:.1f} ms "
        f"({B / run_ms * 1e3:.0f} mixed witnesses/s, best of 3 warm runs)")
    trace = interp_run(prog, x, "M", dev.type != "cuda", mixed=True)
    lanes = random.Random(SEED).sample(range(B), min(SHA_HOST_LANES, B))
    rows = narrow[:, torch.as_tensor(lanes, device=dev)].cpu().numpy()
    n_idx = layout[0]
    bits = sha256_io.msgs_to_bits_batch([msgs[j] for j in lanes])
    for j, lane in enumerate(lanes):
        host = list(cc.witness_host({"in": [int(v) for v in bits[:, j]]}))
        if any(int(rows[r, j]) % cc.p != host[w]
               for r, w in enumerate(n_idx)):
            raise SystemExit(f"FAIL SHA256 lane {lane}: witness differs "
                             "from the host calculator")
    say(f"  {len(lanes)} sampled lanes equal the host calculator")
    del narrow
    return x, run_ms, trace


def phase_sha_kernels(rep, prog, x, dev, B_cmp):
    """Phase C: K1b and K3 against their plain versions on the SHA256
    plan: every emitted narrow bank row and every gathered row at batch
    B_cmp, and the times of both at the main path's batch."""
    plan, f = prog.interp.plan, prog.field
    x, x_w, x_n = prog.interp._inputs(x)
    B = x.shape[-1]
    src, shift = plan.dev["nw_src"], plan.dev["nw_shift"]
    order = plan.dev["nin_order"]
    rows_n = torch.as_tensor(plan.emitted_rows(narrow=True), device=dev)
    # bit for bit on every emitted row, at B_cmp lanes: K1 and K3 on the
    # input rows, their plain versions on the split
    xs = x[..., :B_cmp].contiguous()
    xs_w, xs_n = split_inputs(plan, xs)
    _, bank_n = interp_k1(plan, f, xs)
    _, want_n = k1_plain(plan, f, xs_w, xs_n)
    err_k1 = max_abs_err(bank_n[rows_n], want_n[rows_n])
    err_k3 = max_abs_err(gather_n(bank_n, xs, order, src, shift),
                         gather_n_rows(bank_n, xs_n, src, shift))
    say(f"  K1b: {len(rows_n)} emitted narrow bank rows at batch {B_cmp}, "
        f"max abs err {err_k1}; K3: {len(src)} rows, max abs err {err_k3}")
    del bank_n, want_n
    # times at the main path's batch; the plain versions run once
    _, bank_n = interp_k1(plan, f, x)
    k1_ms = time_ms(lambda: interp_k1(plan, f, x), reps=3)
    (_, plain_n), k1_plain_ms = wall_ms(lambda: k1_plain(plan, f, x_w, x_n))
    err_full = max_abs_err(bank_n[rows_n], plain_n[rows_n])
    del plain_n
    say(f"  K1b at batch {B}: max abs err {err_full} on every emitted row")
    n_steps = plan.n_steps
    rep.add("interp_k1b", "circom_tpu_torch/ops/cuda/interp.cu",
            "circom_tpu/backend/interp.py:2462", max(err_k1, err_full),
            k1_ms, k1_plain_ms,
            4 * B * (k1_input_words(plan, x.shape[1]) + len(rows_n)),
            n_steps * B, plan="SHA256/bn128")
    got = gather_n(bank_n, x, order, src, shift)
    # K3's bare launch into `got` (the wrapper's index checks are
    # device-to-host syncs)
    k3_ms = time_ms(bare(dev, lambda: launch_gather_n(bank_n, x, order, src,
                                                      shift, got),
                         lambda: gather_n(bank_n, x, order, src, shift)))
    want, k3_plain_ms = wall_ms(
        lambda: gather_n_rows(bank_n, x_n, src, shift))
    err_full = max_abs_err(got, want)
    del got, want
    both = torch.cat([bank_n, x_n])
    src_l = src.to(torch.int64)
    sel_ms = time_ms(lambda: both.index_select(0, src_l))
    n_src = len(set(plan.nw_src.tolist()))
    W = len(src)
    say(f"  K3 at batch {B}: max abs err {err_full}; index_select of the "
        f"same {W} source rows (no unpack) {sel_ms:.4f} ms")
    rep.add("gather_n", "circom_tpu_torch/ops/cuda/gather.cu",
            "circom_tpu/backend/interp.py:2681", max(err_k3, err_full),
            k3_ms, k3_plain_ms, 4 * B * (W + n_src), 0,
            index_select_ms=sel_ms)
    return k1_ms, k3_ms


# bench_gpu.py's workloads and the kernels each must launch: K1's parts,
# K2 for a wide witness, K3 for SHA256's mixed one
BG_KERNELS = {"poseidon2": ("interp_k1a", "gather_w"),
              "sha256": ("interp_k1b", "gather_n"),
              "poseidon2_gl": ("interp_k1c", "interp_k1a", "gather_w"),
              "bigint_div": ("interp_k1d", "interp_k1a", "gather_w")}
BG_POSITIVE = ("value", "poseidon2_gpu_wit_s", "sha256_gpu_wit_s",
               "poseidon2_gl_gpu_wit_s", "bigint_div_gpu_wit_s",
               "vs_baseline", "vs_baseline_allcore", "sha256_vs_baseline",
               "poseidon2_gl_vs_baseline")


def phase_bench(paths, dev, sha, rehearse):
    """Phase BG: bench_gpu.py's workloads in-process, in its order
    (bench_gpu.run), each under Paths.run with its kernels in BG_KERNELS,
    the CPU baseline after Poseidon2 unless cached; SHA256 reuses phase
    B's compile and program (`sha`).  Its final record is printed and
    checked: every key and no other, not partial, every gate held; on the
    card, the card's name and every key of BG_POSITIVE above 0."""
    bench = bench_gpu.Bench(dev, bench_gpu.REHEARSE if rehearse
                            else bench_gpu.FULL, compiled={"sha256": sha})
    rc = bench_gpu.run(bench, under=lambda name, fn: paths.run(
        f"bg_{name}", fn, BG_KERNELS[name]))
    rec = bench.record(partial=False)
    say(f"  bench_gpu record: {json.dumps(rec)}")
    if rc:
        raise SystemExit("FAIL BG: a bench workload failed (its traceback "
                         "above)")
    odd = set(rec) ^ set(bench_gpu.RECORD_KEYS)
    if odd:
        raise SystemExit(f"FAIL BG: the record's keys differ from "
                         f"RECORD_KEYS: {odd}")
    if set(bench.gates) != set(BG_KERNELS):
        raise SystemExit(f"FAIL BG: gates held {sorted(bench.gates)}")
    for name, gate in bench.gates.items():
        say(f"  {name}: {gate}")
    if rehearse:
        return rec
    if rec["device"] != torch.cuda.get_device_name(0):
        raise SystemExit(f"FAIL BG: the record's device is {rec['device']}")
    bad = [k for k in BG_POSITIVE if not (rec[k] and rec[k] > 0)]
    if bad:
        raise SystemExit(f"FAIL BG: not above 0: {bad}")
    return rec


def sha256_full_path(paths, rep, cc, prog, spec, dev, B):
    """Phase D: the full-limb SHA256 witness at batch B and the R1CS check
    of every lane, one KC launch; then phase KC on that witness
    (phase_kc_sha)."""
    msgs = sha256_messages(B, SEED + 6)
    x = to_device(sha256_io.input_rows(msgs, spec.n_limbs), dev)
    checker = R1CSChecker(cc.r1cs_rows(), cc.counts()["n_wires"], spec,
                          device=dev)
    say(f"  the check: one KC launch over the batch (the plain route's "
        f"window {checker.lanes} lanes, max nnz "
        f"{max(len(c[0]) for c in checker.coo)})")

    def run_and_check():
        wit, run_ms = wall_ms(lambda: prog.run(x))
        (ok, first_bad), check_ms = wall_ms(
            lambda: checker.check_detailed(wit))
        n_bad = int((~ok).sum())
        if n_bad:
            raise SystemExit(f"FAIL SHA256 R1CS check: {n_bad} of {B} lanes "
                             f"violate a constraint (first: "
                             f"{first_bad[~ok][:5].tolist()})")
        return wit, run_ms, check_ms

    wit, run_ms, check_ms = paths.run(
        "sha256_full", run_and_check,
        ("interp_k1b", "assemble", "r1cs_check"), K5_K6 + KW_NEVER)
    one_launch(paths, "sha256_full", dev, 1)
    shape = tuple(wit.shape)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 \
        if dev.type == "cuda" else 0.0
    if dev.type == "cuda":
        profile_check_breakdown(checker, wit, check_ms)
    say(f"  full-limb witness {shape} in {run_ms:.1f} ms; R1CS check of all "
        f"{B} lanes in {check_ms:.1f} ms; peak device memory {peak:.1f} GiB")
    say("phase KC: KC against the plain route on SHA256's batch and a "
        "window of it")
    phase_kc_sha(rep, checker, cc.r1cs_rows(), wit)
    del wit
    trace = interp_run(prog, x, "F", dev.type != "cuda")
    say("phase KW: KW against the parts route on F's witness")
    kw = phase_kw(prog, x, "SHA256/bn128")
    return {"run_ms": run_ms, "check_ms": check_ms,
            "idle": trace.get("idle"), "peak_gib": peak, "kw": kw,
            "trace": trace}


def multicard(rehearse):
    """Phases MS and MH alone: MerkleInclusion(32)/bn128's program, its
    native calculator and the kernels built, then the mesh over MS_SHARDS
    shards (one a card where there are four) and the two coordinated
    processes (nccl where each has its card), each with its own checks."""
    if not rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cpu") if rehearse else torch.device("cuda", 0)
    if not rehearse:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        global CARD
        CARD = ", ".join(smi.stdout.strip().splitlines())
        say(CARD)
        say(f"build: {build.build_all():.1f} s")
    bn = field_spec("bn128")
    cc = compile_source(merkle_source(4 if rehearse else 32))
    tape, layout = cc.build_tape()
    hints = cc.input_range_hints()
    mk = {"prog": WitnessProgram(tape, bn, device=dev, input_ranges=hints),
          "cc": cc, "calc": NativeCalculator(tape, bn, input_ranges=hints),
          "hints": hints, "layout": layout}
    paths = Paths(rehearse)
    m = phase_mesh(paths, mk, 1 if rehearse else MS_LANES, rehearse)
    say("phase MH: two coordinated processes (parallel/multihost.py)")
    mh_ms = phase_multihost(paths, dev.type, rehearse)
    say(f"mesh path, MerkleInclusion(32)/bn128 in {MS_SHARDS} shards on "
        f"{', '.join(m['devices'])}: {m['run_ms']:.1f} ms step (first run), "
        f"warm {m['warm_ms']} ms, check {m['check_ms']:.1f} ms (warm "
        f"{m['warm_check_ms']}), peaks {m['peaks']}; two processes (MH) "
        f"{mh_ms / 1e3:.1f} s; {CARD}")
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="run every phase on the CPU with the plain "
                         "versions at batch 8, then exit 3 without a result")
    ap.add_argument("--multicard", action="store_true",
                    help="run phases MS and MH alone, on every card the "
                         "machine has (for a call on several cards), and "
                         "exit 0 without the kernels and ok lines")
    args = ap.parse_args()
    if args.multicard:
        return multicard(args.rehearse)
    if args.rehearse:
        dev, B, lanes = torch.device("cpu"), 8, 8
        b_full, b_cmp, b_div, b_qs = 4, 4, 8, 8
        b_mm, b_mk, b_k1, b_cli, b_base, b_ms = 8, 4, 4, 3, 64, 1
    else:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            return 1
        dev, B, lanes = torch.device("cuda", 0), BATCH, CHECK_LANES
        b_full, b_cmp = SHA_FULL_BATCH, SHA_PLAIN_BATCH
        b_div, b_qs = BIGDIV_BATCH, BATCH
        b_mm, b_mk, b_k1 = MM_BATCH, MK_BATCH, K1_PLAIN_LANES
        b_cli, b_base, b_ms = CLI_WITNESSES, BASELINE_WITNESSES, MS_LANES
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        card = smi.stdout.strip().splitlines()[0]
        global CARD
        CARD = card
        say(card)
        say(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
        global LANE_OPS_PER_S
        LANE_OPS_PER_S, sms, mhz = lane_ops_per_s(dev)
        say(f"operation bounds at {LANE_OPS_PER_S / 1e12:.3f} T 32-bit "
            f"integer instructions/s ({INT_OPS_PER_SM_CLOCK} a clock an SM "
            f"x {sms} SMs x {mhz:.0f} MHz)")
    progs = k4_programs(dev)
    if not args.rehearse:
        # the native calculator's g++ build beside the nvcc builds
        with ThreadPoolExecutor(1) as pool:
            gxx = pool.submit(native.build)
            secs = build.build_all(generated=[
                (prog.fused.source(), len(prog.fused.kernels))
                for _cc, prog in progs.values()])
            gxx_s = gxx.result()
        say(f"kernels built in {secs:.1f} s, in parallel; g++ of the native "
            f"calculator {gxx_s:.1f} s beside them")
        names = {f"{build.generated_name(prog.fused.source())}-s{s}":
                 f"{name} segment {s}" for name, (_cc, prog) in progs.items()
                 for s in range(len(prog.fused.kernels))}
        for lib, t in build.BUILD_SECONDS.items():
            say(f"  nvcc {names.get(lib, lib)} ({lib}): {t:.1f} s")
        for lib, log in build.BUILD_LOG.items():
            entry = ""
            for line in log.splitlines():
                if "Compiling entry function" in line:
                    entry = " " + line.split("'")[1][:60]
                if "registers" in line or "spill" in line:
                    say(f"  ptxas {names.get(lib, lib)}{entry}: "
                        f"{line.strip()}")
    t_all = time.perf_counter()
    spec = field_spec("bn128")
    cc = compile_source(generate((2,)) + "\ncomponent main = Poseidon2();\n")
    rows = cc.r1cs_rows()
    nnz = max(sum(len(r[m]) for r in rows) for m in range(3))
    rep = Report()
    paths = Paths(args.rehearse)

    say("phase 1: the Poseidon2 main path (Poseidon2/bn128, batch %d)" % B)
    prog, inputs, times = poseidon2_path(paths, cc, spec, dev, B)
    say("phase 2: K5/K6 against TorchField")
    phase_field(rep, dev, nnz, len(rows), lanes)
    say("phase 3: K2 against the plain gather")
    phase_gather(rep, prog.interp.plan, B, dev)
    say("phase 4: K1a against the plain executor")
    phase_interp(rep, prog, inputs)
    say("phase KC: KC against the plain route (the Poseidon2 batch, five "
        "fields)")
    phase_kc(rep, cc, prog, inputs, (9, 5) if args.rehearse else (1000, 260))
    del prog, inputs
    say("phase 5: the witness entry point (Poseidon2)")
    rng = random.Random(SEED + 3)
    phase_entry_point(cc, dev.type, "pos",
                      [{"inputs": [rng.randrange(cc.p), rng.randrange(cc.p)]}
                       for _ in range(4)])

    say("phase A: K1b opcodes and K3 against ops/narrow.py")
    phase_narrow_units(dev, B)
    t0 = time.perf_counter()
    sha = compile_source(
        open(os.path.join(ROOT, "circom_tpu_torch/circuits/sha256.circom"))
        .read() + "\ncomponent main = Sha256Block();\n")
    t1 = time.perf_counter()
    sha_prog = WitnessProgram(sha.build_tape()[0], spec, device=dev,
                              input_ranges=sha.input_range_hints())
    say(f"SHA256: compiled in {t1 - t0:.1f} s, planned in "
        f"{time.perf_counter() - t1:.1f} s")
    say(f"phase B: the SHA256 main path (SHA256/bn128 run_mixed, batch {B})")
    sha_x, sha_ms, sha_trace = sha256_path(paths, sha, sha_prog, dev, B)
    say("phase C: K1b and K3 against their plain versions (SHA256 plan)")
    k1b_ms, k3_ms = phase_sha_kernels(rep, sha_prog, sha_x, dev, b_cmp)
    del sha_x
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    say(f"phase D: the full-limb SHA256 witness and R1CS check (batch "
        f"{b_full})")
    full = sha256_full_path(paths, rep, sha, sha_prog, spec, dev, b_full)
    say("phase E: the witness entry point (SHA256)")
    msgs = sha256_messages(2, SEED + 7)
    bits = sha256_io.msgs_to_bits_batch(msgs)
    phase_entry_point(sha, dev.type, "sha",
                      [{"in": [int(v) for v in bits[:, j]]} for j in range(2)])
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    say("phase BG: bench_gpu.py's workloads (Poseidon2, SHA256 mixed, "
        "Poseidon2/goldilocks, bigint-div) and its record")
    t_bg = time.perf_counter()
    bg = phase_bench(paths, dev, (sha, sha_prog), args.rehearse)
    t_bg = time.perf_counter() - t_bg
    del sha_prog

    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_new = time.perf_counter()
    new = new_paths(paths, rep, dev, B, b_div, args.rehearse)
    say(f"phase P8: the interpreter at the eight --prime fields (the "
        f"comparators, batch {B})")
    t_p8 = time.perf_counter()
    b_k1p8 = 16 if args.rehearse else P8_K1_LANES
    p8 = phase_primes(paths, dev, B, b_k1p8, "comparators")
    t_p8 = time.perf_counter() - t_p8
    t_new = time.perf_counter() - t_new
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_seg = time.perf_counter()
    seg = segment_perop_paths(paths, rep, progs, dev, B, b_div, b_qs,
                              args.rehearse)
    t_seg = time.perf_counter() - t_seg
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_mm = time.perf_counter()
    mm = mimc_merkle_paths(paths, dev, b_mm, b_mk, b_k1, args.rehearse)
    say(f"phase CL: the compile CLI (--witness-gpu, {b_cli} witnesses a "
        "circuit)")
    cli_check = phase_cli(paths, cli_runs(mm), dev.type, b_cli)
    n_clp = 4 if args.rehearse else CL_PRIME_WITNESSES
    cl_prime_ms = phase_cli_prime(paths, dev.type, n_clp)["Poseidon2"]
    say(f"phase CLg: the compile CLI at --prime goldilocks ({n_clp} "
        "witnesses a circuit)")
    t_clg = time.perf_counter()
    clg = phase_cli_prime(paths, dev.type, n_clp, "goldilocks",
                          tuple(CL_PRIME_CIRCUITS))
    t_clg = time.perf_counter() - t_clg
    say(f"the CPU baseline ({b_base} witnesses a circuit)")
    cpu_baseline(mm, b_base)
    t_mm = time.perf_counter() - t_mm
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ms = time.perf_counter()
    mesh_t = phase_mesh(paths, mm["merkle"], b_ms, args.rehearse)
    del mm["merkle"]["prog"]
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    say("phase MH: two coordinated processes (parallel/multihost.py)")
    mh_ms = phase_multihost(paths, dev.type, args.rehearse)
    say("phase GE: the entry points (circom_tpu_torch/entry.py)")
    phase_graft_entry(paths, dev.type)
    t_ms = time.perf_counter() - t_ms

    # the rest of phase P8 comes last: before phase S it left the profiler
    # dropping 3 of S's 20 K4 records in every traced pass
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_p8x = time.perf_counter()
    say(f"phase P8: Poseidon2 at the eight --prime fields (batch {B})")
    p8p = phase_primes(paths, dev, B, b_k1p8, "Poseidon2")
    say(f"phase P8: MerkleInclusion(32) at {', '.join(P8_MERKLE_PRIMES)} "
        f"(batch {b_mk})")
    p8m = phase_merkle_primes(paths, dev, b_mk, args.rehearse)
    say(f"phase P8n: SHA256 through the mixed path at "
        f"{', '.join(P8N_PRIMES)} (run_mixed at batch {B}, run and check at "
        f"{b_full})")
    t_p8n = time.perf_counter()
    p8n = phase_sha_primes(paths, rep, dev, B, b_full, b_k1p8,
                           args.rehearse)
    t_p8n = time.perf_counter() - t_p8n
    b_ks = 8 if args.rehearse else P8_KS_LANES
    say(f"phase P8: KS on the scan tapes at the eight --prime fields (batch "
        f"{b_ks})")
    t_ks = time.perf_counter()
    p8s = phase_ks_primes(paths, dev, b_ks)
    t_ks = time.perf_counter() - t_ks
    t_p8x = time.perf_counter() - t_p8x

    kw = {"sha256_full": full["kw"], "merkle": mm["merkle"]["kw"],
          "comparators": new["comparators"]["kw"]}
    add_kw_row(rep, kw)
    for name, row in rep.rows.items():
        by_path = paths.of(name)
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
    say(f"Poseidon2 path: {times['run_ms']:.1f} ms witness run, "
        + check_summary(times) + f" (batch {B})"
        + run_summary(times["trace"]))
    say(f"SHA256 mixed path: {sha_ms:.1f} ms run_mixed, "
        f"{B / sha_ms * 1e3:.0f} mixed witnesses/s (batch {B}); K1b "
        f"{k1b_ms:.3f} ms, K3 {k3_ms:.3f} ms" + run_summary(sha_trace))
    say(f"SHA256 full path: {full['run_ms']:.1f} ms full-limb run, "
        f"{full['check_ms']:.1f} ms R1CS check (batch {b_full}); peak "
        f"{full['peak_gib']:.1f} GiB" + run_summary(full["trace"]))
    say("bench_gpu.py's workloads (phase BG): "
        + ", ".join(f"{k} {bg[k]}" for k in (
            "poseidon2_gpu_wit_s", "poseidon2_wall_wit_s",
            "poseidon2_device_ms_measured", "sha256_gpu_wit_s",
            "sha256_wall_wit_s", "sha256_device_ms_measured",
            "poseidon2_gl_gpu_wit_s", "bigint_div_gpu_wit_s", "vs_baseline",
            "vs_baseline_allcore", "sha256_vs_baseline",
            "poseidon2_gl_vs_baseline")))
    for name, label, b in (("poseidon2_gl", "Poseidon2/goldilocks", B),
                           ("bigdiv", "bigint-div/bn128", b_div),
                           ("comparators", "comparators/bn128", B)):
        t = new[name]
        say(f"{label} path: {t['run_ms']:.1f} ms witness run "
            f"({b / t['run_ms'] * 1e3:.0f} witnesses/s), "
            + check_summary(t) + f" (batch {b}); K1 "
            f"{new['k1'][name]:.3f} ms" + run_summary(t["trace"]))
    say(f"the interpreter at the eight --prime fields (phase P8: the "
        f"comparators {t_p8:.1f} s; Poseidon2, Merkle, SHA256 and KS's tapes "
        f"{t_p8x:.1f} s, KS's {t_ks:.1f} s of it): comparators " + ", ".join(
            f"{k} run {v['run_ms']:.3f} ms, check {v['check_ms']:.3f} ms "
            f"(first {v['first_run_ms']:.2f}, {v['first_check_ms']:.2f})"
            for k, v in p8.items()))
    say(f"Poseidon2 at the eight --prime fields (batch {B}; {CARD}): "
        + ", ".join(f"{k} (L = {v['L']}) run {v['run_ms']:.3f} ms, check "
                    f"{v['check_ms']:.3f} ms, K1 {v['k1_ms']:.4f} ms"
                    for k, v in p8p.items()))
    say(f"MerkleInclusion(32) at {', '.join(P8_MERKLE_PRIMES)} (batch {b_mk}; "
        f"{CARD}): " + ", ".join(
            f"{k} (L = {v['L']}) run {v['run_ms']:.2f} ms, check "
            f"{v['check_ms']:.3f} ms, run_mixed {v['mixed_ms']:.2f} ms "
            f"(first), K1 {v['k1_ms']:.3f} ms" for k, v in p8m.items()))
    say(f"SHA256 through the mixed path (phase P8n, {t_p8n:.1f} s; run_mixed "
        f"at {B}, run at {b_full}; {CARD}): " + ", ".join(
            f"{k} (L = {v['L']}) run_mixed {v['mixed_ms']:.3f} ms (peak "
            f"{v['mixed_peak_gib']:.3f} GiB, idle {v['mixed_idle']}), run "
            f"{v['run_ms']:.3f} ms (peak {v['run_peak_gib']:.3f} GiB), check "
            f"{v['check_ms']:.3f} ms, K1 {v['k1_ms']:.4f} ms, K3 "
            f"{v['k3_ms']:.4f} ms, {v['phase_s']:.1f} s"
            for k, v in p8n.items()))
    say(f"KS on the scan tapes (batch {b_ks}; {CARD}), the sum of the "
        "tapes' bare KS launches a field: " + ", ".join(
            f"{k} " + ("not measured" if any(
                t["ks_ms"] is None for t in v.values()) else
                f"{sum(t['ks_ms'] for t in v.values()):.4f} ms")
            for k, v in p8s.items()))
    say(f"the segments at the eight --prime fields (phase S8, batch {B}; "
        f"{CARD}): " + ", ".join(
            f"{k[3:]} run {v['median_ms']:.3f} ms (idle {v.get('idle')}), K4 "
            f"{v['k4_ms']:.4f} ms (bounds {v['bytes_bound_ms']:.4f} bytes, "
            f"{v['ops_bound_ms']:.4f} operations)"
            for k, v in seg["s8"].items()))
    say(f"the CLI at --prime {CL_PRIME} on Poseidon2: {cl_prime_ms / 1e3:.1f} "
        "s; at --prime goldilocks (phase CLg, "
        f"{t_clg:.1f} s): " + ", ".join(f"{k} {v / 1e3:.1f} s"
                                        for k, v in clg.items()))
    for name, label, b in (
            ("n2b254", "Num2Bits(254)/bn128 (segments)", B),
            ("n2b254x4", "4 x Num2Bits(254)/bn128 (segments)", B),
            ("bigdiv_bits", "bigint-div + Num2Bits(254)/bn128 "
             "(straight-line)", b_div),
            ("n2b254x16", "16 x Num2Bits(254)/bn128 (scan)", b_div)):
        t = seg[name]
        say(f"{label} path: {t['run_ms']:.1f} ms witness run "
            f"({b / t['run_ms'] * 1e3:.0f} witnesses/s), "
            f"{t['check_ms']:.1f} ms R1CS check (batch {b})"
            + (f"; K4 {seg['k4'][name]:.4f} ms, a run's median "
               f"{t['median_ms']:.3f} ms, peak {t['peak_gib']:.3f} GiB"
               if name in seg["k4"] else ""))
    q, o = seg["q_compare"], seg["bigdiv_bits"]
    say("16 x Num2Bits(254)/bn128 at batch %d: scan %.1f ms (idle %s), "
        "the per-node path %.1f ms" % (
            b_div, q["scan"]["run_ms"], q["scan"]["idle"],
            q["per-node"]["run_ms"]))
    say("bigint-div + Num2Bits(254)/bn128 at batch %d: one KS launch, run "
        "%.3f ms warm (idle %s), the per-node path %.1f ms" % (
            b_div, o["warm_ms"], o["idle"], o["per_node_ms"]))
    for slots in (8, 64):
        t = seg[f"n2b254x16_s{slots}"]
        say(f"16 x Num2Bits(254)/bn128 scan, {slots} slots: "
            f"{t['run_ms']:.1f} ms witness run ({b_qs / t['run_ms'] * 1e3:.0f}"
            f" witnesses/s), {t['check_ms']:.1f} ms R1CS check (batch "
            f"{b_qs}), idle {t['idle']}, peak {t['peak_gib']} GiB")
    for t in mm.values():
        say(f"{t['label']} path: {t['run_ms']:.1f} ms witness run "
            f"({t['B'] / t['run_ms'] * 1e3:.0f} witnesses/s), "
            + check_summary(t) + f" (batch {t['B']})"
            + run_summary(t["trace"]))
    for name, k in kw.items():
        say(f"KW on the {name} path (batch {k['B']}): {k['ms']:.4f} ms "
            f"(bound {bound(k['bytes'], 0)[0]:.4f} ms), the parts route "
            f"{k['plain_ms']:.3f} ms; run {k['run_ms']:.2f} ms allocating "
            f"{k['run_gib']:.2f} GiB at its peak, with the parts route "
            f"{k['parts_run_ms']:.2f} ms and {k['parts_run_gib']:.2f} GiB")
    m = mesh_t
    say(f"mesh path, MerkleInclusion(32)/bn128 in {MS_SHARDS} shards on "
        f"{', '.join(m['devices'])}: {m['run_ms']:.1f} ms step, first run "
        + (f"({m['B'] / m['warm_ms'] * 1e3:.0f} witnesses/s warm, "
           f"{m['warm_ms']:.1f} ms), " if m["warm_ms"] else "")
        + f"{m['check_ms']:.1f} ms R1CS check"
        + (f" ({m['warm_check_ms']:.1f} warm)" if m["warm_check_ms"]
           else "") + f" (batch {m['B']}); peak "
        + (", ".join(f"{d} {g:.1f} GiB" for d, g in m["peaks"].items())
           or "not measured")
        + f", idle {m['idle']}; two processes (MH) {mh_ms / 1e3:.1f} s")
    say(f"the CLI's R1CS check ({b_cli} witnesses): "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in cli_check.items()))
    say(f"smoke total {time.perf_counter() - t_all:.1f} s, phase BG "
        f"{t_bg:.1f} s, phases F-K "
        f"{t_new:.1f} s, phases S-W {t_seg:.1f} s, phases MM-CL and the "
        f"baseline {t_mm:.1f} s, phases MS-GE {t_ms:.1f} s, phase P8's "
        f"Poseidon2, Merkle, SHA256 and KS {t_p8x:.1f} s (P8n {t_p8n:.1f} "
        f"s), phase CLg {t_clg:.1f} s")
    if args.rehearse:
        print(json.dumps({"kernels": list(rep.rows.values())}),
              file=sys.stderr)
        print("rehearsal on the CPU: no result", file=sys.stderr)
        return 3
    say(card)     # again, so that the end of the output names the card
    print(json.dumps({"kernels": list(rep.rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
