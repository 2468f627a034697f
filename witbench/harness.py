"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result line.

The traffic is a closed loop: one client issues batches back to back, each
batch of `lanes` input assignments from a pool of `pool` distinct batches
made on the device from the seed during set-up.  A batch starts when the
harness calls the cell's entry (WitnessProgram.run or .run_mixed, or the
mesh's shard_program step) and ends, in a checked cell, when the checker's
verdict for every lane is on the host, else when the witness is complete
on the card(s) after one synchronise.  The witness stays on the card.  In
each batch the harness keeps one lane's witness column, drawn from the
seed, on the card; after the window the plain reference judges a sample
of those drawn from the seed.

The numbers compared are counts of exact mismatches, each with the limit
0: `bad_outputs` (judged lanes whose output rows differ from the
reference's), `bad_rows` (witness rows, lane by lane, that differ from the
reference's value of the signal the circuit's symbol table puts there),
and in checked cells `verdict_false` (lanes of the window's batches the
checker rejected), `probe_missed` and `probe_false_alarms` (after the
window, the last batch's witness corrupted in a few lanes drawn from the
seed and checked again: corrupted lanes passed, clean lanes rejected).
"""

import contextlib
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from . import guard, manifest, prepare, roofline, wires
from . import trace as tracemod
from .refs import PRIMES

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = BENCH / ".cache"
WARMUP_BATCHES = 2
PROBE_LANES = 8
MAX_BATCHES = 200_000      # lanes drawn ahead for the window's batches


class Refused(Exception):
    """The run cannot give a result (no card, too few cards, JAX loaded):
    the message goes to standard error and the exit code is `code`."""

    def __init__(self, message, code):
        super().__init__(message)
        self.code = code


def set_caches():
    """Every build and kernel cache at a fixed path of the checkout.  The
    port builds its kernels in circom_tpu_torch/_build/ (its own fixed
    directory in the checkout); these are for PyTorch and Triton."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")


def card_index():
    """The host's index of the first card the run may use: the first entry
    of CUDA_VISIBLE_DEVICES, an index or a UUID (looked up with
    nvidia-smi), else 0."""
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")[0].strip()
    if first.isdigit():
        return int(first)
    if first:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=index,uuid",
                              "--format=csv,noheader"], capture_output=True,
                             text=True)
        for line in smi.stdout.splitlines():
            index, uuid = (x.strip() for x in line.split(",", 1))
            if uuid.startswith(first) or first.startswith(uuid):
                return int(index)
    return 0


def pin_to_one_core():
    """The run's process on one core of those it may use, the card's own
    (counted from the last: card 0 the last core, card 1 the one before),
    so that runs on different cards of one host take different cores, and
    PyTorch's host threads to one: the host's issue time is a share of a
    short batch, and a process that moves between cores, or threads that
    wait on one another, spread it from run to run.  Before CUDA starts,
    so that its threads keep to that core too."""
    import torch

    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {cores[-1 - card_index() % len(cores)]})
    torch.set_num_threads(1)


def lane_ints(a):
    """uint32 limb rows (rows, L, lanes), numpy -> each lane's ints, row r
    the sum of limb i << 16 i, exact for any limb: the even limbs and the
    odd ones each read as one little-endian integer of 32-bit words.
    (A copy of chip_smoke.py's lane_ints.)"""
    rows, L, _ = a.shape
    ne, no = 4 * ((L + 1) // 2), 4 * (L // 2)
    out = []
    for lane in np.ascontiguousarray(a.transpose(2, 0, 1), dtype="<u4"):
        ev, od = lane[:, 0::2].tobytes(), lane[:, 1::2].tobytes()
        out.append([int.from_bytes(ev[r * ne:(r + 1) * ne], "little")
                    + (int.from_bytes(od[r * no:(r + 1) * no], "little")
                       << 16) for r in range(rows)])
    return out


def i32(t):
    """A uint32 tensor's int32 view (PyTorch implements few operators for
    uint32)."""
    import torch

    return t.view(torch.int32)


def u32_np(t):
    return i32(t).cpu().numpy().view(np.uint32)


class Entry:
    """The cell's timed calls on its devices: `step(x)` issues a batch's
    witness, `check(out)` (checked cells) its verdicts, a bool tensor (B,)
    in batch order; `keep(out, i, slot)` gathers batch i's kept lane's
    witness column on the card into room reserved beforehand;
    `witness(kept)` turns it into the lane's values in witness order on
    the host."""

    def __init__(self, prepared, traffic, devices, lanes, lane_draw):
        import torch
        from circom_tpu_torch.parallel.mesh import (make_mesh, shard_checker,
                                                    shard_program)

        self.kind = traffic["entry"]
        self.checked = bool(traffic["check"])
        if self.kind not in ("run", "run_mixed", "mesh"):
            raise ValueError(f"no entry {self.kind!r}")
        if self.checked and self.kind == "run_mixed":
            raise ValueError("the checker reads the full-limb witness")
        self.devices = devices
        self.lanes = lanes
        prog, checker = prepared["program"], prepared["checker"]
        self.p = prog.spec.p
        self.L = prog.field.L
        n = len(devices) if self.kind == "mesh" else 1
        if lanes % n:
            raise ValueError(f"{lanes} lanes do not split over {n} shards")
        self.per_shard = lanes // n
        # batch i keeps lane lane_draw[i]: its shard, and its index there
        self.shard_of = lane_draw // self.per_shard
        self.local = [torch.as_tensor(lane_draw % self.per_shard,
                                      device=d) for d in devices[:n]]
        if self.kind == "mesh":
            mesh = make_mesh(devices=devices)
            self.step = shard_program(prog, mesh)
            self.check = shard_checker(checker, mesh) if self.checked \
                else None
            self.layout = None
        else:
            own = prog.for_device(devices[0])
            self.step = own.run if self.kind == "run" else own.run_mixed
            self.layout = own.mixed_layout() if self.kind == "run_mixed" \
                else None
            if self.checked:
                ck = checker.for_device(devices[0])
                self.check = lambda w: ck.check_detailed(w)[0]
            else:
                self.check = None
        self.n_witness = prog.n_witness

    def _sources(self, out, shard):
        """(tensor, batch dim) of each part of a batch's witness that a
        kept lane's column is taken from."""
        if self.kind == "run":
            return [(i32(out), 2)]
        if self.kind == "run_mixed":
            return [(out[0], 1), (i32(out[1]), 2)]
        return [(i32(out[shard]), 2)]

    def reserve(self, slots, out=None):
        """Room for `slots` kept columns on each shard's card, shaped after
        the batch `out` (or the last one given), so that keeping allocates
        nothing in the window (a new segment of the allocator's small pool
        stalled the host 30-130 ms every few batches)."""
        import torch

        if out is not None:
            self.parts = [[(t.shape[:d] + (1,) + t.shape[d + 1:], t.dtype,
                            t.device) for t, d in self._sources(out, s)]
                          for s in range(len(self.local))]
        self.slots = slots
        self.room = [[torch.empty((slots, *shape), dtype=dt, device=dev)
                      for shape, dt, dev in parts] for parts in self.parts]

    def keep(self, out, i, slot):
        """Batch i's kept lane's column into slot `slot` of the room."""
        import torch

        s = int(self.shard_of[i])
        idx = self.local[s][i:i + 1]
        return tuple(torch.index_select(t, d, idx, out=r[slot])
                     for (t, d), r in zip(self._sources(out, s),
                                          self.room[s]))

    def witness(self, kept):
        if self.kind != "run_mixed":
            return lane_ints(u32_np(kept[0]))[0]
        narrow, wide = kept
        values = [None] * self.n_witness
        for w, v in zip(self.layout[0], narrow[:, 0].cpu().tolist()):
            values[w] = v % self.p
        for w, v in zip(self.layout[1], lane_ints(u32_np(wide))[0]):
            values[w] = v
        return values

    def sync(self):
        import torch

        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)


def card_info(chips):
    """The card's name and power limit (nvidia-smi), for the log."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return [ln.strip() for ln in smi.stdout.splitlines()[:chips]]


def probe(entry, out, seed):
    """Corrupt the last batch's witness row 1 (limb 0, its low bit) in
    PROBE_LANES lanes drawn from the seed and check it again:
    (corrupted lanes that passed, clean lanes that were rejected)."""
    import torch

    rng = np.random.default_rng([seed, 13])
    bad = np.sort(rng.choice(entry.lanes, min(PROBE_LANES, entry.lanes),
                             replace=False))
    shards = out if entry.kind == "mesh" else (out,)
    for s, z in enumerate(shards):
        mine = bad[bad // entry.per_shard == s] % entry.per_shard
        if len(mine):
            v = z.view(torch.int32)
            idx = torch.as_tensor(mine, device=z.device)
            v[1, 0, idx] = v[1, 0, idx] ^ 1
    ok = entry.check(out).cpu().numpy()
    mask = np.zeros(entry.lanes, bool)
    mask[bad] = True
    return int(ok[mask].sum()), int((~ok[~mask]).sum())


def judge(ref, config, entry, kept, inputs, names, control=False):
    """The compared counts over the judged lanes.  The reference works out
    every signal of the circuit from the lanes' inputs alone; `names`, the
    circuit's symbol table, puts each at its witness row; each lane's
    witness is held to it row by row.  For the control, the control's
    output rows against the reference's."""
    params, p = config["params"], PRIMES[config["prime"]]
    if not inputs:
        return {"bad_outputs": 0, "bad_rows": 0}
    if control:
        want = ref.outputs(inputs, params, p)
        got = ref.control(inputs, params, p)
        return {"bad_outputs": sum(a != b for a, b in zip(got, want)),
                "bad_rows": 0}
    want = wires.expected_rows(ref.signals(inputs, params, p), names,
                               len(inputs))
    have = np.empty_like(want)
    for j, col in enumerate(kept):
        have[:, j] = entry.witness(col)
    wrong = np.not_equal(want, have).astype(bool)
    outs = wires.rows_of(ref.OUTPUT_KEYS, names)
    return {"bad_outputs": int(wrong[outs].any(axis=0).sum()),
            "bad_rows": int(wrong.sum())}


def run(cell, seed, seconds, trace, *, t_start, device="cuda",
        lanes=None, pool=None, batches=None, control=False, wrap=None,
        log=print):
    """One run of `cell` (manifest.Cell).  Returns the result dict, whose
    "compared" entry comes last.  device="cpu" runs the port's plain
    versions ([cpu] * chips for the mesh): a rehearsal, whose result has
    no device metric.  `lanes` and `pool` override the traffic's (a
    rehearsal's handful of lanes), and `batches` ends the window after so
    many batches (a test's); `wrap(entry)` may replace the entry's
    calls (a test's fault); `control` judges the control's outputs in
    place of the program's."""
    import torch

    traffic, config = cell.traffic, cell.config
    on_card = device == "cuda"
    if on_card:
        pin_to_one_core()
        if not torch.cuda.is_available():
            raise Refused("no CUDA card: torch.cuda.is_available() is "
                          "false", 2)
        if torch.cuda.device_count() < cell.chips:
            raise Refused(f"{cell.name} needs {cell.chips} cards, "
                          f"{torch.cuda.device_count()} present", 2)
        devices = [torch.device(f"cuda:{k}") for k in range(cell.chips)]
    else:
        devices = [torch.device("cpu")] * cell.chips
    lanes = lanes or traffic["lanes"]
    n_pool = pool or traffic["pool"]
    ref = manifest.reference(config)
    options = config.get("program", {})
    prepared, hit = prepare.load(ref.source(config["params"]),
                                 config["prime"], options)
    log(f"# {cell.name}: program {'read back' if hit else 'compiled'} "
        f"at {time.perf_counter() - t_start:.2f} s")
    rng = np.random.default_rng([seed, 7])
    draw = rng.integers(0, lanes, MAX_BATCHES)
    entry = Entry(prepared, traffic, devices, lanes, draw)
    if entry.p != PRIMES[config["prime"]]:
        raise ValueError(f"the program's field is not {config['prime']}'s")
    if wrap is not None:
        wrap(entry)
    gen = torch.Generator(device=devices[0])
    gen.manual_seed(seed)
    in_limbs = traffic.get("input_limbs") or entry.L
    inputs_pool = [ref.make_batch(gen, lanes, in_limbs, config["params"],
                                  entry.p, devices[0])
                   for _ in range(n_pool)]
    if on_card:
        for d in set(devices):
            torch.cuda.reset_peak_memory_stats(d)

    def annotate(name):
        if trace:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def batch(i, x, keep):
        with annotate("wb.run"):
            out = entry.step(x)
        ok = None
        if entry.checked:
            with annotate("wb.check"):
                ok = entry.check(out)
        with annotate("wb.keep"):
            k = entry.keep(out, i, len(keep)) if len(keep) < entry.slots \
                else None
        with annotate("wb.sync"):
            if ok is not None:
                n_false = int((~ok.cpu()).sum())
            else:
                entry.sync()
                n_false = 0
        if k is not None:
            keep.append(k)
        return out, n_false

    # every call the window makes, the kept lane's gather too: its kernel
    # loads at first use.  The room for the window's kept columns is sized
    # from the warm-up's fastest batch, half as many again
    out = entry.step(inputs_pool[0])
    entry.reserve(1, out)
    del out
    took = []
    for i in range(WARMUP_BATCHES):
        t = time.perf_counter()
        batch(i, inputs_pool[i % n_pool], [])
        took.append(time.perf_counter() - t)
    entry.reserve(batches + 1 if batches
                  else int(1.5 * seconds / min(took)) + 8)
    # one batch more with the room in place: the room may take a block
    # the allocator had cached for a batch's output, which the next batch
    # then allocates anew (60-120 ms in the window's first batch)
    batch(WARMUP_BATCHES, inputs_pool[WARMUP_BATCHES % n_pool], [])
    entry.sync()
    cards = card_info(cell.chips) if on_card else []
    for c in cards:
        log(f"# card: {c}")

    kept, which, lat, ends, n_false = [], [], [], [], 0
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_card else [])
        prof = profile(activities=acts)
        prof.__enter__()
        batch(0, inputs_pool[0], [])        # the tracer's own warm-up
        entry.sync()
        time.sleep(0.05)
    # the collector's pauses are the harness's own: none in the window
    gc.collect()
    gc.disable()
    setup_s = time.perf_counter() - t_start
    w0 = time.perf_counter()
    with annotate("wb.window"):
        i = 0
        while True:
            tb = time.perf_counter()
            out, f = batch(i, inputs_pool[i % n_pool], kept)
            te = time.perf_counter()
            lat.append(te - tb)
            ends.append(te - w0)
            which.append(i % n_pool)
            n_false += f
            i += 1
            if i >= (batches or MAX_BATCHES) or (
                    batches is None and te - w0 >= seconds):
                break
            del out
    window_s = time.perf_counter() - w0
    gc.enable()
    n_batches = i
    tr = None
    if trace:
        time.sleep(0.05)
        prof.__exit__(None, None, None)
        if on_card:
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                prof.export_chrome_trace(path)
                tr = tracemod.Trace(tracemod.load(path))
            finally:
                os.unlink(path)
        del prof
    entry.sync()
    peak = max(torch.cuda.max_memory_allocated(d) for d in set(devices)) \
        if on_card else None
    compared = {}
    if entry.checked:
        compared["verdict_false"] = n_false
        missed, alarms = probe(entry, out, seed)
        compared["probe_missed"] = missed
        compared["probe_false_alarms"] = alarms
    del out
    # batch j kept kept[j] (all of them, unless the window outran the room)
    n_kept = len(kept)
    n_judge = min(n_kept, traffic["judged"])
    pick = np.sort(np.random.default_rng([seed, 11]).choice(
        n_kept, n_judge, replace=False))
    cols = [kept[j] for j in pick]
    inputs = []
    for j in pick:
        lane = torch.as_tensor([int(draw[j])], device=devices[0])
        inputs.append(lane_ints(u32_np(i32(inputs_pool[which[j]]).index_select(
            2, lane)))[0])
    del inputs_pool, kept
    t_judge = time.perf_counter()
    counts = judge(ref, config, entry, cols, inputs,
                   prepared["wire_names"], control)
    compared = {**counts, **compared}
    log(f"# judged {n_judge} lanes in {time.perf_counter() - t_judge:.2f} s")

    ctx = SimpleNamespace(
        cell=cell, chips=cell.chips, lanes=lanes, n_batches=n_batches,
        window_s=window_s, latencies_s=lat, setup_s=setup_s, peak=peak,
        trace=tr, entry=entry, counts=prepared["counts"],
        n_inputs=prepared["n_inputs"], in_limbs=in_limbs,
        int_rate=roofline.int_ops_per_s(devices[0].index)
        if on_card and trace else None)
    metrics = {}
    if on_card:
        for m in (cell.per_layer if trace else cell.end_to_end):
            v = manifest.reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    failed = n_false + compared["bad_outputs"] + int(
        compared["bad_rows"] > 0)
    correct = n_judge > 0 and all(v <= 0 for v in compared.values())
    result = {"correct": correct, "attempted": n_batches * lanes,
              "failed": failed, "metrics": metrics}
    if on_card:
        result["device"] = {"platform": "gpu",
                            "kind": torch.cuda.get_device_name(0),
                            "count": cell.chips, "memory_peak_bytes": peak}
        if tr is not None:
            busy = tr.busy_s()
            result["device"]["busy_s"] = sum(busy.values()) / cell.chips
            result["device"]["window_s"] = tr.window_s
            result["breakdown"] = {"device_ops": tr.ops_by_name(),
                                   "idle_gaps": tr.idle_gaps()}
    result["card"] = cards
    result["batches"] = n_batches
    result["batch_ms"] = {"median": statistics.median(lat) * 1e3,
                          "mean": window_s / n_batches * 1e3,
                          "max": max(lat) * 1e3,
                          "slowest": [[j, lat[j] * 1e3, ends[j]] for j in
                                      sorted(range(n_batches),
                                             key=lambda j: -lat[j])[:5]]}
    result["kept"] = n_kept
    result["judged"] = n_judge
    result["compared"] = {k: {"value": v, "limit": 0}
                          for k, v in compared.items()}
    # last, in the process that prints the result: what it has loaded
    found = guard.forbidden_loaded(sys.modules)
    if found:
        raise Refused("modules of JAX or of the JAX package were loaded: "
                      + ", ".join(found), 4)
    return result


def compared_lines(result):
    return [f"compared {k} {v['value']} limit {v['limit']}"
            for k, v in result["compared"].items()]


def main(argv, t_start):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="judge the control's outputs (readings for the "
                    "limits; never a benchmark run)")
    ap.add_argument("--rehearse", action="store_true",
                    help="on the CPU at a handful of lanes, the port's "
                    "plain versions; no device metric; exits 3")
    a = ap.parse_args(argv)
    set_caches()
    cell = manifest.cell(ROOT / "BENCHMARK.json", a.workload)

    def log(*x):
        print(*x, file=sys.stderr, flush=True)

    try:
        if a.rehearse:
            result = run(cell, a.seed, a.seconds, a.trace, t_start=t_start,
                         device="cpu", lanes=cell.traffic["rehearse_lanes"],
                         pool=2, control=bool(a.control), log=log)
        else:
            result = run(cell, a.seed, a.seconds, a.trace, t_start=t_start,
                         control=bool(a.control), log=log)
    except Refused as e:
        log(f"witbench: {e}")
        return e.code
    for line in compared_lines(result):
        log(line)
    if a.rehearse:
        log("witbench: a rehearsal on the CPU; no result")
        print(json.dumps({"rehearsal": True, "correct": result["correct"],
                          "compared": result["compared"]}))
        return 3
    if a.control:
        log("witbench: the control's readings; no result")
        print(json.dumps({"control": True, "correct": result["correct"],
                          "compared": result["compared"]}))
        return 5
    print(json.dumps(result))
    return 0
