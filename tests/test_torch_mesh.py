"""The port's batch split (circom_tpu_torch/parallel/mesh.py) against the
JAX package's (circom_tpu/parallel/mesh.py).

The JAX side runs on the eight virtual CPU devices that tests/conftest.py
forces; the port on make_mesh(devices=[cpu] * 8), each shard through the
plain versions of its kernels.  The same inputs, made from a seed, go
through both: sharded witnesses, mixed witnesses and checker verdicts must
be equal element by element (tolerance 0: field elements).  Also held: a
program's copy for another device reuses the host plan, and every kernel
wrapper launches with its tensors' device current (a stubbed
torch.cuda.device records it).
"""

import contextlib
import random
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from circom_tpu import register_extern as jax_register_extern
from circom_tpu.backend.checker import R1CSChecker as JaxChecker
from circom_tpu.backend.jax_backend import WitnessProgram as JaxProgram
from circom_tpu.backend.tape import compute_extern_columns as jax_extern_cols
from circom_tpu.compiler.executor import EXTERN_IMPLS as JAX_EXTERNS
from circom_tpu.compiler.pipeline import compile_source as jax_compile
from circom_tpu.field.primes import field_spec as jax_field_spec
from circom_tpu.parallel import mesh as jax_mesh
from circom_tpu_torch import register_extern
from circom_tpu_torch.backend import interp as interp_mod
from circom_tpu_torch.backend import segments as segments_mod
from circom_tpu_torch.backend import torch_backend
from circom_tpu_torch.backend.checker import R1CSChecker
from circom_tpu_torch.backend.tape import compute_extern_columns
from circom_tpu_torch.backend.torch_backend import WitnessProgram
from circom_tpu_torch.circuits.sources import merkle_source
from circom_tpu_torch.compiler.executor import EXTERN_IMPLS
from circom_tpu_torch.compiler.pipeline import compile_source
from circom_tpu_torch.entry import BITS_SRC, EXTERN_IDIV_SRC
from circom_tpu_torch.field.primes import field_spec
from circom_tpu_torch.ops import field_kernels as fk
from circom_tpu_torch.ops.field import TorchField
from circom_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_int
from circom_tpu_torch.parallel.mesh import (gather, make_mesh, shard_checker,
                                            shard_program,
                                            shard_program_mixed, split)

CHAIN3 = """
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
component main = Chain(3);
"""

T_SRC = """
pragma circom 2.0.0;
template T() { signal input a; signal input b; signal output o;
  o <== a * b + 3; }
component main = T();
"""

CPU8 = [torch.device("cpu")] * 8


def to_np(t):
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy().view(np.uint32)
    return t.numpy()


def encode(cols, L):
    return np.stack([ints_to_limbs(c, L).T.copy() for c in cols])


def jax_sharded(fn_or_prog, arr, out_specs=P(None, None, "batch")):
    """JAX's jit of fn with the batch axis sharded over the 8 devices."""
    mesh = jax_mesh.make_mesh(8)
    in_sh = NamedSharding(mesh, P(None, None, "batch"))
    fn = jax.jit(fn_or_prog, in_shardings=in_sh,
                 out_shardings=NamedSharding(mesh, out_specs))
    return fn(jax.device_put(arr, in_sh))


@pytest.fixture(scope="module")
def chain3():
    """Chain(3)/bn128: the JAX scan program and its checker, the inputs
    of a batch of 16 and JAX's sharded witness."""
    assert len(jax.devices()) == 8, "conftest should force 8 cpu devices"
    rng = np.random.default_rng(3)
    jcc = jax_compile(CHAIN3)
    jspec = jax_field_spec("bn128")
    jprog = JaxProgram(jcc.build_tape()[0], jspec, unroll_threshold=0)
    vals = [int(v) for v in rng.integers(1, 1 << 62, size=16)]
    arr = jprog.encode_inputs([vals])
    want = np.asarray(jax_sharded(jprog.jittable(), arr))
    jchk = JaxChecker(jcc.r1cs_rows(), jcc.dag.total_signals(), jspec)
    jok = np.asarray(jax_sharded(jchk.check, want, out_specs=P()))
    cc = compile_source(CHAIN3)
    checker = R1CSChecker(cc.r1cs_rows(), cc.dag.total_signals(),
                          field_spec("bn128"), device="cpu")
    return SimpleNamespace(cc=cc, arr=arr, vals=vals, want=want,
                           jchk=jchk, jok=jok, checker=checker)


@pytest.mark.parametrize("mode", ["scan", "interp"])
def test_chain_shards_equal_jax_and_check(chain3, mode):
    """(a) The port's shards, joined, equal JAX's sharded jittable()
    element by element, on its per-op (scan) path and its interpreter;
    every shard passes the check, as JAX's sharded checker says."""
    prog = WitnessProgram(chain3.cc.build_tape()[0], field_spec("bn128"),
                          device="cpu", mode=mode)
    mesh = make_mesh(devices=CPU8)
    shards = shard_program(prog, mesh)(chain3.arr)
    assert len(shards) == 8
    assert all(tuple(s.shape) == chain3.want.shape[:2] + (2,)
               for s in shards)
    assert np.array_equal(to_np(gather(shards)), chain3.want)
    ok = shard_checker(chain3.checker, mesh)(shards)
    assert ok.tolist() == chain3.jok.tolist() == [True] * 16


def test_corrupted_lane_fails_alone(chain3):
    """(b) One lane of one shard corrupted: False at that lane only, and
    the first violated constraint equals the JAX checker's."""
    p = field_spec("bn128").p
    bad = chain3.want.copy()
    lane = 11                                 # shard 5, its second lane
    v = (limbs_to_int(bad[2, :, lane]) + 1) % p
    bad[2, :, lane] = ints_to_limbs([v], 16)[0]
    mesh = make_mesh(devices=CPU8)
    shards = split(bad, mesh)
    ok = shard_checker(chain3.checker, mesh)(shards)
    jok, jfirst = chain3.jchk.check_detailed(bad)
    assert ok.tolist() == [j != lane for j in range(16)]
    assert ok.tolist() == np.asarray(jok).tolist()
    _, first = chain3.checker.for_device(mesh.devices[5]).check_detailed(
        shards[5])
    assert int(first[1]) == int(np.asarray(jfirst)[lane])


def test_check_takes_the_shards_slices_in_turns(chain3, monkeypatch):
    """The mesh's check launches slice s of every shard before slice
    s + 1 of any (a check of one lane a slice over two shards: lanes 0,
    8, 1, 9, ...), and its verdicts still equal JAX's, a corrupted lane
    included."""
    p = field_spec("bn128").p
    bad = chain3.want.copy()
    lane = 11
    v = (limbs_to_int(bad[2, :, lane]) + 1) % p
    bad[2, :, lane] = ints_to_limbs([v], 16)[0]
    checker = R1CSChecker(chain3.cc.r1cs_rows(),
                          chain3.cc.dag.total_signals(), field_spec("bn128"),
                          device="cpu", lanes=1)
    seen = []
    residual = R1CSChecker._residual

    def record(self, zs):
        seen.append(next(j for j in range(bad.shape[-1])
                         if np.array_equal(to_np(zs)[..., 0], bad[..., j])))
        return residual(self, zs)
    monkeypatch.setattr(R1CSChecker, "_residual", record)
    mesh = make_mesh(devices=[torch.device("cpu")] * 2)
    ok = shard_checker(checker, mesh)(split(bad, mesh))
    assert seen == [j for s in range(8) for j in (s, 8 + s)]
    jok, _ = chain3.jchk.check_detailed(bad)
    assert ok.tolist() == np.asarray(jok).tolist() == \
        [j != lane for j in range(16)]


def test_fused_interpreter_shards_equal_jax():
    """(c) test_shard_map_fused_interpreter's goldilocks T circuit: the
    port's shards equal JAX's shard_program(use_fused=True), the Pallas
    kernel in interpret mode, and the host calculator."""
    jcc = jax_compile(T_SRC, prime="goldilocks")
    jprog = JaxProgram(jcc.build_tape()[0], jax_field_spec("goldilocks"),
                       unroll_threshold=0)
    cols = [[(7 * i + k) % jprog.jf.p for i in range(16)] for k in (1, 2)]
    arr = encode(cols, 4)
    want = np.asarray(jax_mesh.shard_program(
        jprog, jax_mesh.make_mesh(8), use_fused=True)(arr))
    cc = compile_source(T_SRC, prime="goldilocks")
    prog = WitnessProgram(cc.build_tape()[0], field_spec("goldilocks"),
                          device="cpu")
    assert prog.interp is not None
    got = to_np(gather(shard_program(prog, make_mesh(devices=CPU8))(arr)))
    assert np.array_equal(got, want)
    for i in range(16):
        assert [limbs_to_int(got[j, :, i]) for j in range(got.shape[0])] \
            == list(cc.witness_host({"a": cols[0][i], "b": cols[1][i]}))


def test_mixed_shards_equal_jax():
    """(d) The Bits circuit's mixed witness: the port's
    shard_program_mixed equals JAX's, narrow and wide rows, and so does
    mixed_layout."""
    jcc = jax_compile(BITS_SRC, prime="goldilocks")
    jtape, _ = jcc.build_tape()
    jprog = JaxProgram(jtape, jax_field_spec("goldilocks"),
                       unroll_threshold=0, mode="interp",
                       input_ranges=jcc.input_range_hints())
    rng = random.Random(11)
    cols = [[rng.randrange(2) for _ in range(16)] for _ in range(8)]
    arr = encode(cols, 4)
    jnw, jwd = jax_mesh.shard_program_mixed(jprog, jax_mesh.make_mesh(8))(arr)
    cc = compile_source(BITS_SRC, prime="goldilocks")
    prog = WitnessProgram(cc.build_tape()[0], field_spec("goldilocks"),
                          device="cpu", mode="interp",
                          input_ranges=cc.input_range_hints())
    shards = shard_program_mixed(prog, make_mesh(devices=CPU8))(arr)
    assert all(nw.shape[-1] == 2 and wd.shape[-1] == 2 for nw, wd in shards)
    nw, wd = gather(shards)
    assert len(prog.mixed_layout()[0]) > 0, "no narrow rows"
    assert [list(x) for x in prog.mixed_layout()] == \
        [list(x) for x in jprog.mixed_layout()]
    assert np.array_equal(to_np(nw), np.asarray(jnw))
    assert np.array_equal(to_np(wd), np.asarray(jwd))


def test_idiv_extern_shards_equal_jax():
    """(e) The idiv + extern_c circuit: host-filled extern columns, then
    the split; the port's shards equal JAX's shard_program(use_fused=True)
    and the host calculator."""
    fn = lambda params, ins: {"out": 3 * ins["in"]}  # noqa: E731
    jax_register_extern("Scale", fn)
    register_extern("Scale", fn)
    try:
        jcc = jax_compile(EXTERN_IDIV_SRC, prime="goldilocks")
        jtape, _ = jcc.build_tape()
        jprog = JaxProgram(jtape, jax_field_spec("goldilocks"),
                           unroll_threshold=0, mode="interp")
        rng = random.Random(5)
        p = jprog.jf.p
        base = [[rng.randrange(1, p) for _ in range(16)],
                [rng.randrange(1, 1 << 32) for _ in range(16)]]
        jcols = [list(c) for c in base] + \
            [[] for _ in range(jtape.n_inputs - 2)]
        jax_extern_cols(jtape, jcols, jcc.hf)
        want = np.asarray(jax_mesh.shard_program(
            jprog, jax_mesh.make_mesh(8), use_fused=True)(encode(jcols, 4)))
        cc = compile_source(EXTERN_IDIV_SRC, prime="goldilocks")
        tape, _ = cc.build_tape()
        prog = WitnessProgram(tape, field_spec("goldilocks"), device="cpu",
                              mode="interp")
        cols = [list(c) for c in base] + \
            [[] for _ in range(tape.n_inputs - 2)]
        compute_extern_columns(tape, cols, cc.hf)
        assert cols == jcols
        got = to_np(gather(shard_program(prog, make_mesh(devices=CPU8))(
            encode(cols, 4))))
        assert np.array_equal(got, want)
        for j in (0, 15):
            w = cc.witness_host({"a": cols[0][j], "b": cols[1][j]})
            assert [limbs_to_int(got[i, :, j])
                    for i in range(got.shape[0])] == list(w)
    finally:
        JAX_EXTERNS.pop("Scale", None)
        EXTERN_IMPLS.pop("Scale", None)


def test_merkle_shards_equal_whole_run_and_host():
    """(f) MerkleInclusion(4)/bn128 over 4 CPU shards (K1a and K1b in one
    plan, K3 for the path bits) equals the unsharded run and the host
    calculator, and passes the sharded check."""
    cc = compile_source(merkle_source(4))
    tape, layout = cc.build_tape()
    hints = cc.input_range_hints()
    spec = field_spec("bn128")
    prog = WitnessProgram(tape, spec, device="cpu", input_ranges=hints)
    rng = random.Random(4)
    B = 4
    cols = [[rng.randrange(2) if i in hints else rng.randrange(spec.p)
             for _ in range(B)] for i in range(prog.n_inputs)]
    arr = prog.encode_inputs(cols)
    mesh = make_mesh(devices=[torch.device("cpu")] * 4)
    shards = shard_program(prog, mesh)(arr)
    got = to_np(gather(shards))
    assert np.array_equal(got, to_np(prog.run(arr)))
    checker = R1CSChecker(cc.r1cs_rows(), cc.counts()["n_wires"], spec,
                          device="cpu")
    assert shard_checker(checker, mesh)(shards).tolist() == [True] * B
    for j in range(B):
        ins = {}
        for name, dims, off in layout:
            n = int(np.prod(dims))
            v = [cols[off + k][j] for k in range(n)]
            ins[name] = v if dims else v[0]
        assert [limbs_to_int(got[i, :, j]) for i in range(got.shape[0])] \
            == list(cc.witness_host(ins))


def test_batch_not_a_multiple_of_the_mesh_raises(chain3):
    """(g) A batch of 10 over 8 shards raises ValueError; JAX's jit with
    that sharding refuses it too."""
    arr = chain3.arr[..., :10]
    prog = WitnessProgram(chain3.cc.build_tape()[0], field_spec("bn128"),
                          device="cpu", mode="scan")
    with pytest.raises(ValueError):
        shard_program(prog, make_mesh(devices=CPU8))(arr)
    jprog = JaxProgram(jax_compile(CHAIN3).build_tape()[0],
                       jax_field_spec("bn128"), unroll_threshold=0)
    with pytest.raises(ValueError):
        jax_sharded(jprog.jittable(), arr)


def test_make_mesh_needs_a_card(monkeypatch):
    """(h) make_mesh() without a card raises: no fallback to the CPU.
    An explicit device list, repeats allowed, is taken as it is."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(devices=["cuda:0"] * 4)
    mesh = make_mesh(devices=CPU8)
    assert len(mesh) == 8 and mesh.axis == "batch"
    assert len(make_mesh(3, devices=CPU8)) == 3


@pytest.mark.parametrize("mode", ["interp", "segments", "scan"])
def test_copy_for_another_device_plans_nothing(chain3, monkeypatch, mode):
    """(i) A program's copy for a second device ("meta" here) reuses the
    host tape and plan: with every planner stubbed to fail, the copy is
    made, holds the same host tables, its tensors on the new device, and
    is made once; the program's own device gives the program itself.
    The checker's copy carries its COO the same way."""
    prog = WitnessProgram(chain3.cc.build_tape()[0], field_spec("bn128"),
                          device="cpu", mode=mode)

    def refuse(*a, **k):
        raise AssertionError("planned again")
    for name in ("interp_plan", "domain_tape", "build_plan",
                 "plan_from_arrays", "InterpreterPlan", "SegmentedProgram",
                 "PerOpProgram", "lower_dynamic_ops"):
        monkeypatch.setattr(torch_backend, name, refuse)
    monkeypatch.setattr(segments_mod.SegmentedProgram, "_segment", refuse)
    meta = torch.device("meta")
    twin = prog.for_device("meta")
    assert twin is not prog and twin.device == meta
    assert twin.for_device("meta") is twin and prog.for_device(meta) is twin
    assert twin.for_device("cpu") is prog and prog.for_device("cpu") is prog
    assert twin.dt is prog.dt and twin.field.device == meta
    if mode == "interp":
        plan = twin.interp.plan
        assert plan.table is prog.interp.plan.table
        assert plan.device == meta
        assert all(t.device == meta for t in plan.dev.values())
        assert twin.interp._nw_src.device == meta
    elif mode == "segments":
        assert twin.fused.segments is prog.fused.segments
        assert twin.fused.device == meta
    else:
        assert twin.perop.order is prog.perop.order
        assert all(c.device == meta for c in twin.perop.consts.values())
    chk = chain3.checker.for_device("meta")
    assert chk.for_device("meta") is chk
    assert chain3.checker.for_device("cpu") is chain3.checker
    assert all(t.device == meta for m in chk.coo for t in m)


@pytest.fixture()
def launches(monkeypatch):
    """Stubs: torch.cuda.device records the device each launch enters,
    the libraries' entry points record the device current when called."""
    current, seen = [], []

    @contextlib.contextmanager
    def device(d):
        current.append(torch.device(d))
        try:
            yield
        finally:
            current.pop()

    class Lib:
        def __getattr__(self, name):
            def entry(*args):
                seen.append((name, current[-1] if current else None))
                return 0
            return entry
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(interp_mod, "library", lambda name: Lib())
    monkeypatch.setattr(fk, "library", lambda name: Lib())
    return SimpleNamespace(seen=seen, lib=Lib())


def test_every_launch_enters_its_tensors_device(chain3, launches):
    """Each wrapper's launch (K1, K2, K3, K5/K6, K4) runs with its
    tensors' device current: a launch on a card other than the current
    one would fail or run in the wrong context."""
    meta = torch.device("meta")
    spec = field_spec("bn128")
    prog = WitnessProgram(chain3.cc.build_tape()[0], spec, device="cpu",
                          mode="interp").for_device(meta)
    plan, field = prog.interp.plan, prog.field
    B = 4

    def u32(*shape):
        return torch.empty(shape, dtype=torch.uint32, device=meta)

    def i32(*shape):
        return torch.empty(shape, dtype=torch.int32, device=meta)
    interp_mod.launch_k1(plan, field, u32(plan.n_input_rows, 16, B))
    interp_mod.launch_gather_w(u32(5, 16, B), i32(3), u32(3, 16, B))
    interp_mod.launch_gather_n(i32(5, B), u32(2, 16, B), i32(1), i32(3),
                               i32(3), i32(3, B))
    fk.launch("mont_mul", TorchField(spec, meta), u32(2, 16, B),
              u32(2, 16, B), u32(2, 16, B))
    seg = WitnessProgram(chain3.cc.build_tape()[0], spec, device="cpu",
                         mode="segments").fused.for_field(
                             TorchField(spec, meta))
    seg._lib = launches.lib
    segments_mod.launch_k4(seg, 0, u32(seg.n_inputs, 16, B),
                           u32(seg.n_witness, 16, B), u32(seg.n_cross, 16, B))
    assert [name for name, _ in launches.seen] == [
        "ctpu_interp_k1", "ctpu_gather_rows", "ctpu_gather_n",
        "ctpu_field_elementwise", "ctpu_k4_seg0"]
    assert all(d == meta for _, d in launches.seen), launches.seen

