"""Entry points of the port, the counterpart of the JAX package's
root `__graft_entry__.py`.

    entry(device="cuda")            -> (run, (inputs,)): the flagship,
                                       Poseidon2/bn128 witnesses at batch 64
    dryrun_multichip(n, device=...) -> the step split over an n-device mesh
                                       (parallel/mesh.py), run once on small
                                       shapes in three phases

Both run on the card unless the caller passes device="cpu"; without a
card they raise.
"""

import functools
import random

import numpy as np
import torch

from .backend.checker import R1CSChecker
from .backend.tape import compute_extern_columns
from .backend.torch_backend import WitnessProgram
from .circuits.sources import poseidon2_source
from .compiler.executor import EXTERN_IMPLS, register_extern
from .compiler.pipeline import compile_source
from .convert import to_device
from .field.primes import field_spec
from .ops.limbs import ints_to_limbs, limbs_to_int
from .parallel.mesh import (gather, make_mesh, shard_checker, shard_program,
                            shard_program_mixed)
from .utils.device import resolve_device

# phase 2: the interpreter's mixed witness (bit-class rows narrow)
BITS_SRC = """
pragma circom 2.0.0;
template Bits() {
    signal input a[4];
    signal input b[4];
    signal output out[4];
    signal mid[4];
    var lc = 0;
    for (var k = 0; k < 4; k++) {
        a[k] * (a[k] - 1) === 0;
        b[k] * (b[k] - 1) === 0;
        mid[k] <== a[k] * b[k];
        lc += (a[k] + b[k] - 2*mid[k]) * 2 ** (k * 6);
    }
    signal bits[24];
    var acc = 0;
    for (var k = 0; k < 24; k++) {
        bits[k] <-- (lc >> k) & 1;
        bits[k] * (bits[k] - 1) === 0;
        acc += bits[k] * 2 ** k;
    }
    acc === lc;
    for (var k = 0; k < 4; k++) { out[k] <== bits[k * 6]; }
}
component main = Bits();
"""

# phase 3: an extern_c gate and a witness-dependent division
EXTERN_IDIV_SRC = """
pragma circom 2.0.6;
pragma custom_templates;

template custom extern_c Scale() {
    signal input in;
    signal output out;
    out <-- 3 * in;
}

template Main() {
    signal input a;
    signal input b;
    signal output q;
    signal output r;
    component s = Scale();
    s.in <== a;
    q <-- s.out \\ b;           // witness-dependent idiv
    r <-- s.out % b;            // witness-dependent mod
    s.out === q * b + r;
}
component main = Main();
"""


@functools.lru_cache(maxsize=None)
def _flagship(device):
    spec = field_spec("bn128")
    cc = compile_source(poseidon2_source())
    tape, _ = cc.build_tape()
    return cc, WitnessProgram(tape, spec, device=device,
                              unroll_threshold=0), spec


def _example_inputs(prog, batch):
    """The flagship's inputs, uint32 (n_inputs, L, batch) on the
    program's device, from random.Random(7) as the JAX entry makes
    them."""
    rng = random.Random(7)
    p = prog.spec.p
    cols = [[rng.randrange(p) for _ in range(batch)]
            for _ in range(prog.n_inputs)]
    return to_device(prog.encode_inputs(cols), prog.device)


def entry(device="cuda"):
    """(prog.run, (inputs,)): Poseidon2/bn128 witnesses of a batch of 64,
    the inputs a tensor on the device."""
    _cc, prog, _spec = _flagship(resolve_device(device))
    return prog.run, (_example_inputs(prog, 64),)


def _mesh(n_devices, device):
    """n_devices shards on `device`'s kind: the cards when there are
    enough, else cuda:0 .. repeated (said on one line); on the CPU
    [cpu] * n_devices."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return make_mesh(devices=[dev] * n_devices)
    count = torch.cuda.device_count()
    if n_devices <= count:
        return make_mesh(n_devices)
    cards = "cuda:0" if count == 1 else f"cuda:0..cuda:{count - 1}"
    print(f"dryrun_multichip: {n_devices} shards on {count} card(s); the "
          f"mesh repeats {cards}", flush=True)
    return make_mesh(devices=[f"cuda:{k % count}"
                              for k in range(n_devices)])


def dryrun_multichip(n_devices, device="cuda"):
    """The full step (witnesses and the Az∘Bz − Cz check) split over an
    n_devices mesh, run once on small shapes; then the interpreter's
    mixed witness and an idiv tape with an extern_c gate under the same
    mesh.  Raises AssertionError when a phase's result is wrong."""
    mesh = _mesh(n_devices, device)
    cc, prog, spec = _flagship(mesh.devices[0])
    checker = R1CSChecker(cc.r1cs_rows(), cc.dag.total_signals(), spec,
                          device=mesh.devices[0])
    batch = max(n_devices, 2) * 2
    wit = shard_program(prog, mesh)(_example_inputs(prog, batch))
    if not bool(shard_checker(checker, mesh)(wit).all()):
        raise AssertionError("R1CS check failed in the multichip dry run")
    _dryrun_fused_mixed(mesh, n_devices)
    _dryrun_dynops_extern(mesh, n_devices)


def _encode(cols, L):
    return np.stack([ints_to_limbs(c, L).T.copy() for c in cols])


def _dryrun_fused_mixed(mesh, n_devices):
    """Phase 2: the interpreter's mixed witness (goldilocks, the input
    range hints) split over the mesh; lanes 0 and B - 1 against the host
    calculator, every narrow and wide row."""
    spec = field_spec("goldilocks")
    cc = compile_source(BITS_SRC, prime="goldilocks")
    tape, _ = cc.build_tape()
    ranges = cc.input_range_hints()       # from the bit constraints
    if len(ranges) != tape.n_inputs:
        raise AssertionError("Bits: not every input is range-hinted")
    prog = WitnessProgram(tape, spec, device=mesh.devices[0],
                          unroll_threshold=0, mode="interp",
                          input_ranges=ranges)
    batch = max(n_devices, 2) * 2
    rng = random.Random(11)
    cols = [[rng.randrange(2) for _ in range(batch)] for _ in range(8)]
    nw, wd = gather(shard_program_mixed(prog, mesh)(
        _encode(cols, spec.n_limbs)))
    nw, wd = nw.numpy(), wd.view(torch.int32).numpy().view(np.uint32)
    nidx, widx = prog.mixed_layout()
    p = spec.p
    for j in (0, batch - 1):
        w = cc.witness_host({"a": [cols[k][j] for k in range(4)],
                             "b": [cols[k + 4][j] for k in range(4)]})
        for r, wi in enumerate(nidx):
            if int(nw[r, j]) % p != w[wi] % p:
                raise AssertionError(f"Bits lane {j}: narrow row {r}")
        for r, wi in enumerate(widx):
            if limbs_to_int(wd[r, :, j]) != w[wi]:
                raise AssertionError(f"Bits lane {j}: wide row {r}")


def _dryrun_dynops_extern(mesh, n_devices):
    """Phase 3: a witness-dependent idiv (the interpreter's long
    division) and an extern_c gate whose output columns the host fills
    before the split, under the same mesh; lanes 0 and B - 1 against the
    host calculator."""
    spec = field_spec("goldilocks")
    cc = compile_source(EXTERN_IDIV_SRC, prime="goldilocks")
    register_extern("Scale", lambda params, ins: {"out": 3 * ins["in"]})
    try:
        tape, _ = cc.build_tape()
        if len(tape.extern_calls) != 1 or "idiv" not in tape.ops:
            raise AssertionError("the extern call or the idiv is not on "
                                 "the tape")
        prog = WitnessProgram(tape, spec, device=mesh.devices[0],
                              unroll_threshold=0, mode="interp")
        batch = max(n_devices, 2) * 2
        rng = random.Random(5)
        p = spec.p
        cols = [[] for _ in range(tape.n_inputs)]
        cols[0] = [rng.randrange(1, p) for _ in range(batch)]
        cols[1] = [rng.randrange(1, 1 << 32) for _ in range(batch)]
        compute_extern_columns(tape, cols, cc.hf)
        out = gather(shard_program(prog, mesh)(_encode(cols, spec.n_limbs)))
        out = out.view(torch.int32).numpy().view(np.uint32)
        for j in (0, batch - 1):
            w = cc.witness_host({"a": cols[0][j], "b": cols[1][j]})
            got = [limbs_to_int(out[i, :, j]) for i in range(out.shape[0])]
            if got != list(w):
                raise AssertionError(f"idiv/extern lane {j} differs from "
                                     "the host calculator")
    finally:
        EXTERN_IMPLS.pop("Scale", None)
