"""Several coordinated processes, one batch: the split across processes.

The port of the JAX package's parallel/multihost.py on torch.distributed.
N processes form one process group over a TCP store; every process builds
the same program, encodes the same seeded global batch and runs only its
own slice, split over its own devices by parallel/mesh.py (no collective
on the witness path).  Each process checks every lane of its slice
against the host calculator; the checker's all-ok verdict, all-reduced
with MIN over the group, is the one collective.

    python -m circom_tpu_torch.parallel.multihost --spawn 2 --out mp.json \
        [--device cpu|cuda] [--local-devices 4]

spawns 2 workers on this host (each with a free port's address and a
wait limit) and writes, from process 0, an artifact with the JAX
module's keys.  `--launches PATH` has process k write the kernel
launches of its step and check (ops/build.py LAUNCHES) to PATH.k, a JSON
object.  `--local-devices` is the shards a process (the JAX
module's virtual devices a process).  The backend: gloo on the CPU; nccl
where each process has a card of its own; gloo over a CPU tensor where
processes share a card (NCCL refuses two ranks on one GPU).  Process k
takes cuda:(k % device_count).  One worker role on its own: omit --spawn
and pass --coordinator host:port, --nproc and --pid.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

SRC = """
pragma circom 2.0.0;
template Square() {
    signal input in;
    signal output out;
    out <== in * in;
}
template Chain(n) {
    signal input in;
    signal output out;
    component s[n];
    for (var i = 0; i < n; i++) {
        s[i] = Square();
        s[i].in <== i == 0 ? in : s[i-1].out;
    }
    out <== s[n-1].out;
}
component main = Chain(4);
"""
PER_DEVICE = 4          # lanes a shard
WAIT_SECONDS = 120      # the spawner's wait for its workers


def backend_for(device, nproc):
    """nccl where each process has a card of its own, else gloo."""
    import torch

    if device == "cuda" and torch.cuda.device_count() >= nproc:
        return "nccl"
    return "gloo"


def _worker(coordinator, nproc, pid, local_devices, out_path, prime,
            device, launches_path=""):
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..backend.checker import R1CSChecker
    from ..backend.torch_backend import WitnessProgram
    from ..compiler.pipeline import compile_source
    from ..field.primes import field_spec
    from ..ops import build
    from ..ops.limbs import limbs_to_int
    from ..utils.device import resolve_device
    from .mesh import make_mesh, shard_checker, shard_program

    if device == "cuda":
        dev = resolve_device(f"cuda:{pid % max(torch.cuda.device_count(), 1)}")
        torch.cuda.set_device(dev)
    else:
        dev = resolve_device(device)
    backend = backend_for(device, nproc)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=nproc, rank=pid)
    try:
        spec = field_spec(prime)
        cc = compile_source(SRC, prime=prime)
        tape, _ = cc.build_tape()
        prog = WitnessProgram(tape, spec, device=dev, unroll_threshold=0,
                              mode="scan")
        checker = R1CSChecker(cc.r1cs_rows(), cc.counts()["n_wires"], spec,
                              device=dev)

        # the same seeded global batch in every process; each runs only
        # its own slice, as each host loads its own inputs
        n_global = nproc * local_devices
        B = n_global * PER_DEVICE
        rng = np.random.default_rng(1234)
        values = [int(v) % spec.p for v in rng.integers(0, 1 << 62, size=B)]
        full = prog.encode_inputs([values])          # (n_in, L, B)
        lo = pid * local_devices * PER_DEVICE
        hi = lo + local_devices * PER_DEVICE
        local = full[:, :, lo:hi]

        mesh = make_mesh(devices=[dev] * local_devices)
        step = shard_program(prog, mesh)
        check = shard_checker(checker, mesh)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        build.reset_launches()
        t0 = time.time()
        out = step(local)
        ok_local = bool(check(out).all())
        if launches_path:
            Path(f"{launches_path}.{pid}").write_text(
                json.dumps(dict(build.LAUNCHES)))
        # nccl reduces a tensor on the process's card, gloo one on the CPU
        flag = torch.tensor([int(ok_local)], dtype=torch.int32,
                            device=dev if backend == "nccl" else "cpu")
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        ok = bool(flag.item())
        step_s = time.time() - t0

        # every lane of this process's slice against the host calculator
        n_checked = 0
        for k, shard in enumerate(out):
            data = shard.view(torch.int32).cpu().numpy().view(np.uint32)
            for j in range(data.shape[2]):
                g = lo + k * PER_DEVICE + j
                want = cc.witness_host({"in": values[g]})
                got = [limbs_to_int(data[i, :, j])
                       for i in range(data.shape[0])]
                if got != list(want):
                    raise SystemExit(f"process {pid}: witness {g} differs "
                                     "from the host calculator")
                n_checked += 1
        if n_checked != local_devices * PER_DEVICE:
            raise SystemExit(f"process {pid}: {n_checked} lanes checked")

        if pid == 0 and out_path:
            Path(out_path).write_text(json.dumps({
                "ok": ok,
                "n_processes": nproc,
                "devices_per_process": local_devices,
                "global_devices": n_global,
                "batch": B,
                "elements_checked_per_process": n_checked,
                "parity": "exact",
                "checker_all_ok": ok,
                "step_seconds_first_call": round(step_s, 3),
                "platform": "gpu" if dev.type == "cuda" else "cpu",
                "mechanism": f"torch.distributed over {backend} (TCP "
                             f"store); each process splits its slice "
                             f"over {local_devices} shards on {dev}; the "
                             f"checker's all-ok all-reduced (MIN) is the "
                             f"one cross-process collective",
            }, indent=1))
    finally:
        dist.destroy_process_group()


def _spawn(nproc, local_devices, out_path, prime, device, launches_path=""):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    coord = f"localhost:{port}"
    # the workers see the cards this process sees, no more
    env = dict(os.environ)
    root = Path(__file__).resolve().parents[2]
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root)] + [p for p in [env.get("PYTHONPATH")] if p])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "circom_tpu_torch.parallel.multihost",
         "--coordinator", coord, "--nproc", str(nproc), "--pid", str(pid),
         "--local-devices", str(local_devices),
         "--out", out_path if pid == 0 else "", "--prime", prime,
         "--device", device, "--launches", launches_path], env=env)
        for pid in range(nproc)]
    deadline = time.monotonic() + WAIT_SECONDS
    try:
        rcs = [p.wait(timeout=max(deadline - time.monotonic(), 0.1))
               for p in procs]
    except subprocess.TimeoutExpired:
        raise SystemExit(f"workers still running after {WAIT_SECONDS} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(rcs):
        raise SystemExit(f"worker exit codes: {rcs}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spawn", type=int, default=0,
                    help="spawn N coordinated worker processes")
    ap.add_argument("--coordinator", default="")
    ap.add_argument("--nproc", type=int, default=1)
    ap.add_argument("--pid", type=int, default=0)
    ap.add_argument("--local-devices", type=int, default=4,
                    help="shards a process")
    ap.add_argument("--out", default="")
    ap.add_argument("--prime", default="goldilocks")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--launches", default="",
                    help="process k writes its kernel launches to PATH.k")
    args = ap.parse_args(argv)
    if args.spawn:
        return _spawn(args.spawn, args.local_devices, args.out, args.prime,
                      args.device, args.launches)
    _worker(args.coordinator, args.nproc, args.pid, args.local_devices,
            args.out, args.prime, args.device, args.launches)
    return 0


if __name__ == "__main__":
    sys.exit(main())
