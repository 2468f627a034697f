"""Smoke test of the PyTorch/CUDA port on one card.

Builds the kernels from the sources in the checkout, holds every kernel
against its plain PyTorch version at the shapes of the main path, drives
the main path (Poseidon2 over bn128, batch 65,536: witness program, R1CS
check) with the launch counts read around it, and runs the witness entry
point on a saved artifact.  Any mismatch exits non-zero.

    python3 chip_smoke.py            # needs a CUDA card
    python3 chip_smoke.py --rehearse # CPU, small batch, plain versions only;
                                     # exits 3 and prints no result

The second-to-last line is the kernels JSON, the last line
{"ok": true, "device": {...}}.
"""

import argparse
import json
import os
import random
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

try:
    import numpy as np
    import torch

    from circom_tpu_torch.backend.artifacts import save_program
    from circom_tpu_torch.backend.checker import R1CSChecker
    from circom_tpu_torch.backend.interp import gather_w, interp_k1a
    from circom_tpu_torch.backend.interp_ref import gather_rows, run_plan
    from circom_tpu_torch.backend.torch_backend import WitnessProgram
    from circom_tpu_torch.circuits.gen_poseidon import generate
    from circom_tpu_torch.compiler.pipeline import compile_source
    from circom_tpu_torch.convert import to_device
    from circom_tpu_torch.emit.binfmt import write_wtns
    from circom_tpu_torch.field.primes import field_spec
    from circom_tpu_torch.ops import build
    from circom_tpu_torch.ops import field_kernels as fk
    from circom_tpu_torch.ops.field import TorchField, as_i64
    from circom_tpu_torch.ops.limbs import limbs_to_int
except ImportError as e:
    print(f"chip_smoke: the port is not importable here ({e})",
          file=sys.stderr)
    sys.exit(2)

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the float32
# non-tensor rate taken as the rate of 32-bit integer lane operations (an
# upper bound: IMAD issues at half of it, so the true bound is higher)
HBM_BYTES_PER_S = 3.35e12
LANE_OPS_PER_S = 67e12

BATCH = 65536
CHECK_LANES = 8192     # R1CSChecker's batch slice
SAMPLE_LANES = 64
SEED = 7


def say(*a):
    print(*a, flush=True)


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


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


def bound(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / LANE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(x, y):
    d = (as_i64(x) - as_i64(y)).abs()
    return int(d.max()) if d.numel() else 0


def canonical_limbs(rng, spec, shape, device):
    """Random canonical field elements as uint32 limbs (*shape[:-2], L, B):
    random 16-bit limbs below a top limb under p's."""
    L = spec.n_limbs
    top = spec.p >> (16 * (L - 1))
    x = rng.integers(0, 1 << 16, size=shape, dtype=np.uint32)
    x[..., L - 1, :] = rng.integers(0, top, size=x[..., L - 1, :].shape,
                                    dtype=np.uint32)
    return to_device(x, device)


class Report:
    def __init__(self):
        self.rows = {}

    def add(self, name, source, replaces, err, ms, plain_ms, nbytes, ops,
            library_ms=None):
        if err != 0:
            raise SystemExit(f"FAIL {name}: kernel differs from its plain "
                             f"version (max abs err {err})")
        b_ms, b_by = bound(nbytes, ops)
        self.rows[name] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms}
        say(f"  {name}: bit-exact; {ms:.4f} ms (plain {plain_ms:.3f} ms, "
            f"bound {b_ms:.4f} ms by {b_by}"
            + (f", library {library_ms:.4f} ms" if library_ms else "") + ")")


def phase_field(rep, dev, nnz, n_rows, lanes):
    """K5 and K6 against TorchField at the checker's shapes."""
    rng = np.random.default_rng(SEED)
    for prime in ("bn128", "goldilocks"):
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
        sync()
        err = {name: max_abs_err(got[name], want[name]) for name in got}
        if any(err.values()):
            raise SystemExit(f"FAIL K5/K6 at {prime}: max abs err {err}")
        say(f"  K5/K6 {prime}: mont_mul {tuple(a.shape)}x{tuple(c.shape)}, "
            f"add/sub {tuple(x.shape)} bit-exact")
        if prime != "bn128":
            continue
        e_mm, e_xy = nnz * lanes, n_rows * lanes
        rep.add("mont_mul", "circom_tpu_torch/ops/cuda/field_ops.cu",
                "circom_tpu/ops/pallas_field.py:94", err["mont_mul"],
                time_ms(lambda: fk.mont_mul(f, a, c)),
                time_ms(lambda: f.mont_mul(a, c), reps=2),
                4 * (2 * e_mm * L + nnz * L), 2 * L * L * e_mm)
        for name in ("add", "sub"):
            rep.add(name, "circom_tpu_torch/ops/cuda/field_ops.cu",
                    "circom_tpu/ops/pallas_field.py:140", err[name],
                    time_ms(lambda: getattr(fk, name)(f, x, y)),
                    time_ms(lambda: getattr(f, name)(x, y), reps=2),
                    4 * 3 * e_xy * L, 0)


def phase_gather(rep, plan, B, dev):
    """K2 against the plain gather on a random bank of the plan's shape."""
    rng = np.random.default_rng(SEED + 1)
    L = plan.L
    bank = to_device(rng.integers(0, 1 << 16, size=(plan.n_bank_rows, L, B),
                                  dtype=np.uint32), dev)
    idx = plan.dev["wit_rows"]
    got = gather_w(bank, idx)
    err = max_abs_err(got, gather_rows(bank, idx))
    W = idx.shape[0]
    bank_i = bank.view(torch.int32)
    idx_l = idx.to(torch.int64)
    rep.add("gather_w", "circom_tpu_torch/ops/cuda/gather.cu",
            "circom_tpu/backend/interp.py:2579", err,
            time_ms(lambda: gather_w(bank, idx)),
            time_ms(lambda: gather_rows(bank, idx)),
            4 * 2 * W * L * B, 0,
            library_ms=time_ms(lambda: bank_i.index_select(0, idx_l)))


def k1a_ops(plan):
    """32-bit multiplies K1a does per lane: CIOS mul 2L^2, a dot of n
    terms (n+1)L^2, a trailing REDC L^2."""
    L2 = plan.L * plan.L
    per_op = {0: 0, 1: 2 * L2, 2: 2 * L2, 3: 0, 4: 3 * L2, 5: 4 * L2}
    ops = sum(per_op[int(o)] for o in plan.table[:, 0])
    return ops + int(plan.mont_tab.sum()) * L2


def phase_interp(rep, prog, x_w):
    """K1a against the plain executor on the Poseidon2 plan, written bank
    rows compared bit for bit after the trailing REDC."""
    plan, f = prog.interp.plan, prog.field
    B = x_w.shape[-1]
    got = interp_k1a(plan, f, x_w)
    t = time.perf_counter()
    want = run_plan(plan, f, as_i64(x_w))
    sync()
    plain_ms = (time.perf_counter() - t) * 1e3
    rows = torch.as_tensor(plan.written_rows(), device=x_w.device)
    err = max_abs_err(got.view(torch.int32).index_select(0, rows)
                      .view(torch.uint32), want.index_select(0, rows))
    del want
    nbytes = 4 * plan.L * B * (x_w.shape[0] + len(rows))
    rep.add("interp_k1a", "circom_tpu_torch/ops/cuda/interp.cu",
            "circom_tpu/backend/interp.py:2462", err,
            time_ms(lambda: interp_k1a(plan, f, x_w), reps=3), plain_ms,
            nbytes, k1a_ops(plan) * B)
    return got


def main_path(cc, spec, dev, B):
    """Poseidon2/bn128 witnesses at batch B, then the R1CS check of every
    lane; launch counts are read around exactly this."""
    prog = WitnessProgram(cc.build_tape()[0], spec, device=dev)
    rng = np.random.default_rng(SEED + 2)
    inputs = canonical_limbs(rng, spec, (prog.n_inputs, spec.n_limbs, B), dev)
    checker = R1CSChecker(cc.r1cs_rows(), cc.counts()["n_wires"], spec,
                          device=dev, lanes=CHECK_LANES)
    launches = None
    for _ in range(2):
        # the first run is the one counted; the second, warm, is timed
        sync()
        if launches is None:
            build.reset_launches()
        t0 = time.perf_counter()
        wit = prog.run(inputs)
        sync()
        t1 = time.perf_counter()
        ok, first_bad = checker.check_detailed(wit)
        sync()
        t2 = time.perf_counter()
        if launches is None:
            launches = dict(build.LAUNCHES)
        n_bad = int((~ok).sum())
        if n_bad:
            raise SystemExit(f"FAIL R1CS check: {n_bad} of {B} lanes violate "
                             f"a constraint (first: "
                             f"{first_bad[~ok][:5].tolist()})")
    say(f"  witnesses: {tuple(wit.shape)} in {(t1 - t0) * 1e3:.1f} ms "
        f"({B / (t1 - t0):.0f} witnesses/s); R1CS check of all {B} lanes "
        f"in {(t2 - t1) * 1e3:.1f} ms")
    # 64 sampled lanes against the host calculator
    lanes = random.Random(SEED).sample(range(B), min(SAMPLE_LANES, B))
    sel = torch.as_tensor(lanes, device=wit.device)
    w_np = wit.view(torch.int32).index_select(2, sel).cpu().numpy() \
        .view(np.uint32)
    x_np = inputs.view(torch.int32).index_select(2, sel).cpu().numpy() \
        .view(np.uint32)
    for j, lane in enumerate(lanes):
        ins = [limbs_to_int(x_np[i, :, j]) for i in range(prog.n_inputs)]
        host = list(cc.witness_host({"inputs": ins}))
        got = [limbs_to_int(w_np[i, :, j]) for i in range(w_np.shape[0])]
        if got != host:
            raise SystemExit(f"FAIL lane {lane}: witness differs from the "
                             "host calculator")
    say(f"  {len(lanes)} sampled lanes equal the host calculator")
    return prog, inputs, launches, {"run_ms": (t1 - t0) * 1e3,
                                    "check_ms": (t2 - t1) * 1e3}


def phase_entry_point(cc, device):
    """python -m circom_tpu_torch.witness on a saved artifact, 4 inputs;
    the .wtns bytes must equal write_wtns of the host witness."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        _entry_point_in(cc, device, tmp)
    say("  entry point: 4 .wtns files equal the host calculator's")


def _entry_point_in(cc, device, tmp):
    art = os.path.join(tmp, "pos.tpu.json")
    save_program(cc, art)
    rng = random.Random(SEED + 3)
    batch = [{"inputs": [rng.randrange(cc.p), rng.randrange(cc.p)]}
             for _ in range(4)]
    inp = os.path.join(tmp, "inputs.json")
    with open(inp, "w") as fh:
        json.dump(batch, fh)
    out = os.path.join(tmp, "out")
    r = subprocess.run([sys.executable, "-m", "circom_tpu_torch.witness", art,
                        inp, "-o", out, "--device", device], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise SystemExit(f"FAIL entry point (exit {r.returncode}):\n"
                         f"{r.stdout}\n{r.stderr}")
    for bi, raw in enumerate(batch):
        ref = os.path.join(tmp, f"ref.{bi}.wtns")
        write_wtns(ref, cc.p, list(cc.witness_host(raw)))
        with open(ref, "rb") as a, open(os.path.join(out, f"pos.{bi}.wtns"),
                                        "rb") as b:
            if a.read() != b.read():
                raise SystemExit(f"FAIL entry point: witness {bi} .wtns "
                                 "differs from the host calculator's")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="run every phase on the CPU with the plain "
                         "versions at batch 8, then exit 3 without a result")
    args = ap.parse_args()
    if args.rehearse:
        dev, B, lanes = torch.device("cpu"), 8, 8
    else:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            return 1
        dev, B, lanes = torch.device("cuda", 0), BATCH, CHECK_LANES
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        say(smi.stdout.strip().splitlines()[0])
        say(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
        secs = build.build_all()
        say(f"kernels built in {secs:.1f} s")
        for name, log in build.BUILD_LOG.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    say(f"  ptxas {name}: {line.strip()}")
    t_all = time.perf_counter()
    spec = field_spec("bn128")
    cc = compile_source(generate((2,)) + "\ncomponent main = Poseidon2();\n")
    rows = cc.r1cs_rows()
    nnz = max(sum(len(r[m]) for r in rows) for m in range(3))
    rep = Report()

    say("phase 1: the main path (Poseidon2/bn128, batch %d)" % B)
    prog, inputs, launches, times = main_path(cc, spec, dev, B)
    say(f"  launches on the main path: {launches}")
    for name in ("interp_k1a", "gather_w", "mont_mul", "sub"):
        if not args.rehearse and launches.get(name, 0) == 0:
            raise SystemExit(f"FAIL: {name} was not launched on the main "
                             "path")

    say("phase 2: K5/K6 against TorchField")
    phase_field(rep, dev, nnz, len(rows), lanes)
    say("phase 3: K2 against the plain gather")
    phase_gather(rep, prog.interp.plan, B, dev)
    say("phase 4: K1a against the plain executor")
    order = torch.as_tensor(prog.interp.plan.win_order, device=dev)
    phase_interp(rep, prog, gather_rows(inputs, order))
    del prog, inputs
    say("phase 5: the witness entry point")
    phase_entry_point(cc, dev.type)

    for name, row in rep.rows.items():
        row["launches"] = launches.get(name, 0)
    on_path = [r for n, r in rep.rows.items() if n != "add"]
    say(f"main path: {times['run_ms']:.1f} ms witness run, "
        f"{times['check_ms']:.1f} ms R1CS check; smoke total "
        f"{time.perf_counter() - t_all:.1f} s")
    # `add` (K6) is held against its plain version above but is not on
    # the main path: the checker subtracts and never adds
    say(json.dumps({"off_path_kernels": [rep.rows["add"]]}))
    if args.rehearse:
        print("rehearsal on the CPU: no result", file=sys.stderr)
        return 3
    print(json.dumps({"kernels": on_path}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
