"""Standalone batched witness generator: artifact + inputs -> .wtns.

The port of the JAX package's `circom_tpu.witness`: it reads a compiled
program artifact (`<name>.tpu.json`, written by `save_program`), runs the
witness program on the card, checks the guards of unrolled while loops
(T3013) and, at --sanity_check >= 1, every witness against the R1CS
(T3012), then writes one .wtns file per witness:

    python -m circom_tpu_torch.witness circuit.tpu.json inputs.json -o out/

inputs.json is one input map or a list of maps (a batch).  --device cuda
is the default and needs a card; --device cpu runs the plain PyTorch
versions of the kernels.
"""

import argparse
import json
import os
import sys

import torch

from .backend.artifacts import load_program
from .backend.checker import R1CSChecker
from .backend.plan import UnsupportedTapeOp
from .backend.torch_backend import WitnessProgram
from .emit.binfmt import write_wtns
from .emit.inputs import load_inputs
from .field.hostfield import HostField
from .field.primes import field_spec
from .utils.reports import Report, ReportCollection


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="circom-tpu-torch-witness",
        description="batched witness generation from a compiled "
                    "circom-tpu program artifact, on PyTorch/CUDA")
    ap.add_argument("artifact", help="<name>.tpu.json")
    ap.add_argument("inputs", help="JSON input map or list of maps")
    ap.add_argument("-o", "--output", default=".")
    ap.add_argument("--sanity_check", type=int, default=2,
                    choices=[0, 1, 2, 3])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    tape, layout, meta = load_program(args.artifact)
    spec = field_spec(meta["prime"])
    hints = meta["input_range_hints"]
    with open(args.inputs) as f:
        batch_inputs = json.load(f)
    if isinstance(batch_inputs, dict):
        batch_inputs = [batch_inputs]

    try:
        cols = _batch_columns(spec.p, batch_inputs, layout, tape.n_inputs)
        _check_hinted_columns(cols, hints, spec.p, layout)
        if tape.extern_calls:
            from .backend.tape import compute_extern_columns

            compute_extern_columns(tape, cols, HostField(spec))
    except (Report, ReportCollection) as r:
        print(r.render(None), file=sys.stderr)
        print("previous errors were found", file=sys.stderr)
        return 1
    try:
        prog = WitnessProgram(tape, spec, device=args.device,
                              unroll_threshold=0, input_ranges=hints)
    except (RuntimeError, UnsupportedTapeOp) as e:
        # no card for --device cuda; every tape has a backend (interpreter,
        # segments, straight-line or scan), so UnsupportedTapeOp comes
        # only from a forced mode, which this entry point does not take
        print(f"error: {e}", file=sys.stderr)
        return 1

    decoded = batch_witnesses(prog, cols, meta["rows"],
                              meta["counts"]["n_wires"], args.sanity_check)
    if decoded is None:
        return 1
    name = os.path.splitext(
        os.path.basename(args.artifact))[0].removesuffix(".tpu")
    write_batch(args.output, name, spec.p, decoded, len(batch_inputs))
    print(f"{len(batch_inputs)} witnesses written to {args.output}")
    return 0


def batch_witnesses(prog, cols, rows, n_wires, sanity_check):
    """The witnesses of one batch of input columns, decoded [output][batch]
    into ints, or None after the errors were printed: T3013 when a guard of
    an unrolled while loop is nonzero in some witness, and, at
    sanity_check >= 1, T3012 for each witness (up to 10) that violates a
    constraint of the R1CS (rows, n_wires), checked on the program's
    device."""
    out = prog.run(prog.encode_inputs(cols))
    n_wit = prog.n_witness - prog.n_guards
    if prog.n_guards:
        if bool(torch.any(out[n_wit:].view(torch.int32) != 0)):
            print("error[T3013]: data-dependent while loop exceeded "
                  "the unroll bound for some witness (recompile with "
                  "a larger --while_max_unroll)", file=sys.stderr)
            return None
        out = out[:n_wit]
    if sanity_check >= 1:
        checker = R1CSChecker(rows, n_wires, prog.spec, device=prog.device)
        ok, first_bad = checker.check_detailed(out)
        ok = ok.cpu().numpy()
        if not ok.all():
            first_bad = first_bad.cpu().numpy()
            for bi in (~ok).nonzero()[0][:10]:
                print(f"error[T3012]: witness {bi} violates constraint "
                      f"{int(first_bad[bi])} (sanity check failed)",
                      file=sys.stderr)
            return None
    return prog.decode_outputs(out)


def write_batch(outdir, name, p, decoded, n):
    """<outdir>/<name>.<i>.wtns for each of the n witnesses of `decoded`
    ([output][batch] ints)."""
    os.makedirs(outdir, exist_ok=True)
    for bi in range(n):
        write_wtns(os.path.join(outdir, f"{name}.{bi}.wtns"), p,
                   [decoded[i][bi] for i in range(len(decoded))])


def _check_hinted_columns(cols, hints, p, layout):
    """Reject input values outside their proven range hints.

    `input_range_hints` narrows inputs whose bit constraints prove a
    range in every VALID witness; a violating input would make the
    int32 lane diverge from mod-p arithmetic.  Validation is host-side
    and unconditional (independent of --sanity_check)."""
    if not hints:
        return
    half = p >> 1

    def name_of(flat):
        for (nm, _dims, off) in reversed(layout):
            if off <= flat:
                return f"{nm}[{flat - off}]" if flat > off else nm
        return f"#{flat}"

    for idx, (lo, hi) in hints.items():
        for bi, v in enumerate(cols[idx]):
            s = v if v <= half else v - p
            if not (lo <= s <= hi):
                raise Report.error(
                    f"input '{name_of(idx)}' of witness {bi} is {s}, "
                    f"outside the range [{lo}, {hi}] required by its "
                    "constraints", "T3015")


def _batch_columns(p, batch_inputs, layout, n_inputs, main_meta=None):
    """Input columns [input][batch] of ints; T3011 for a missing input,
    its span the main component's call when `main_meta` gives it."""
    cols = [[] for _ in range(n_inputs)]
    for raw in batch_inputs:
        inputs = load_inputs(raw, p)
        flat = []
        for (name, dims, off) in layout:
            v = inputs.get(name)
            if v is None:
                r = Report.error(f"missing input '{name}'", "T3011")
                if main_meta is not None:
                    r.add_primary(main_meta.file_id, main_meta.start,
                                  main_meta.end)
                raise r
            if isinstance(v, list):
                def walk(x):
                    for item in x:
                        walk(item) if isinstance(item, list) else flat.append(item)
                walk(v)
            else:
                flat.append(v)
        for i, x in enumerate(flat):
            cols[i].append(x)
    return cols


if __name__ == "__main__":
    sys.exit(main())
