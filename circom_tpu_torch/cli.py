"""The command-line interface of the PyTorch/CUDA port.

The port of the JAX package's `circom_tpu/cli.py`, run as
`python -m circom_tpu_torch.cli`.  It mirrors the reference CLI surface
(circom/src/input_user.rs:397-585):

    python -m circom_tpu_torch.cli circuit.circom --r1cs --sym --json \\
        --O2 --prime bls12381 -l lib/ -o out/

plus the additions that replace --wasm/--c code generation:

    --tpu            serialize the compiled witness program (tape) artifact
                     (read by `python -m circom_tpu_torch.witness`)
    --witness input.json [--wtns out.wtns]
                     compute one witness with the host calculator
    --witness-gpu inputs.json [--device cuda|cpu]
                     run the batched witness program on the card (or, with
                     --device cpu, the plain PyTorch versions of its
                     kernels); --witness-tpu is another name of this flag

The compiler is the JAX package's, copied verbatim, so every host output
(.r1cs, .sym, _constraints.json, _substitutions.json, .tpu.json,
log_inputs.txt, .ir.txt) is byte for byte the JAX CLI's.

Exit code 0 on success, 1 on any reported error (main.rs:12-21).
"""

import argparse
import json
import os
import sys

from .compiler.pipeline import compile_circuit
from .compiler.values import ExecError
from .emit.binfmt import write_wtns
from .emit.inputs import load_inputs
from .emit.json_out import constraints_json, substitutions_json
from .field.primes import PRIMES, field_spec
from .utils.reports import Report, ReportCollection
from .witness import (_batch_columns, _check_hinted_columns, batch_witnesses,
                      write_batch)


def build_arg_parser():
    ap = argparse.ArgumentParser(
        prog="circom-tpu-torch",
        description="circom compiler & batched witness generator on "
                    "PyTorch/CUDA",
    )
    ap.add_argument("input", help="path to the .circom file")
    ap.add_argument("-o", "--output", default=".", help="output directory")
    ap.add_argument("--r1cs", action="store_true",
                    help="write <name>.r1cs")
    ap.add_argument("--sym", action="store_true", help="write <name>.sym")
    ap.add_argument("--json", action="store_true",
                    help="write <name>_constraints.json")
    ap.add_argument("--simplification_substitution", action="store_true",
                    help="write <name>_substitutions.json")
    ap.add_argument("--wasm", action="store_true",
                    help="(compat) accepted; the program artifact replaces "
                         "wasm")
    ap.add_argument("-c", "--c", dest="cgen", action="store_true",
                    help="(compat) accepted; the program artifact replaces "
                         "C++")
    ap.add_argument("--wat", action="store_true",
                    help="(compat) accepted; the serialized program "
                         "(--tpu) is the readable program form")
    ap.add_argument("--no_asm", action="store_true",
                    help="(compat) accepted no-op; there is no asm "
                         "backend to disable")
    ap.add_argument("--inputs", action="store_true",
                    help="(compat, hidden in the reference) write "
                         "log_inputs.txt with the main input layout")
    ap.add_argument("--irout", action="store_true",
                    help="(compat, hidden in the reference) dump the "
                         "witness tape IR as <name>.ir.txt")
    ap.add_argument("--tpu", action="store_true",
                    help="serialize the witness program artifact "
                         "(<name>.tpu.json)")
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--O0", action="store_true",
                       help="no simplification")
    group.add_argument("--O1", action="store_true",
                       help="signal/constant simplification (default)")
    group.add_argument("--O2", action="store_true",
                       help="full constraint simplification")
    ap.add_argument("--O2round", type=int, default=0, metavar="N",
                    help="--O2 with N simplification rounds")
    ap.add_argument("-p", "--prime", default="bn128",
                    choices=sorted(PRIMES.keys()))
    ap.add_argument("-l", dest="link_libraries", action="append",
                    default=[], metavar="DIR",
                    help="include search directory (repeatable)")
    ap.add_argument("--inspect", action="store_true",
                    help="extra constraint analysis warnings")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--no_init", action="store_true",
                    help="do not initialize vars to 0")
    ap.add_argument("--sanity_check", type=int, default=2, choices=[0, 1, 2, 3])
    ap.add_argument("--while_max_unroll", type=int, default=64,
                    metavar="N",
                    help="unroll bound for data-dependent while loops "
                         "on the batched witness path when the trip count "
                         "cannot be derived statically (T3013 fires if "
                         "a witness exceeds it)")
    ap.add_argument("--use_old_simplification_heuristics",
                    action="store_true")
    ap.add_argument("--parallel", action="store_true",
                    help="solve simplification clusters on a process pool "
                         "(reference: threadpool, "
                         "constraint_simplification.rs:198-327)")
    # witness generation
    ap.add_argument("--witness", metavar="INPUT_JSON",
                    help="compute a witness from input.json (host path)")
    ap.add_argument("--wtns", metavar="OUT_WTNS",
                    help="witness output path (default <name>.wtns)")
    ap.add_argument("--witness-gpu", "--witness-tpu", dest="witness_gpu",
                    metavar="INPUTS_JSON",
                    help="batched witnesses on the card (a JSON list of "
                         "input maps), one <name>.<i>.wtns each")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device of --witness-gpu: cuda (the default) needs "
                         "a card; cpu runs the kernels' plain versions")
    return ap


def main(argv=None):
    ap = build_arg_parser()
    args = ap.parse_args(argv)
    if args.witness_gpu:
        # no card for --device cuda: fail before anything is written
        from .utils.device import resolve_device

        try:
            device = resolve_device(args.device)
        except RuntimeError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    name = os.path.splitext(os.path.basename(args.input))[0]
    outdir = args.output
    os.makedirs(outdir, exist_ok=True)

    simpl = "O1"
    rounds = 0
    if args.O0:
        simpl = "O0"
    elif args.O2 or args.O2round:
        simpl = "O2"
        rounds = args.O2round or (1 << 30)  # --O2 iterates to fixpoint

    try:
        cc = compile_circuit(
            args.input, prime=args.prime,
            link_libraries=args.link_libraries, no_init=args.no_init,
            simplification=simpl, rounds=rounds, parallel=args.parallel,
            use_old_heuristics=args.use_old_simplification_heuristics,
            verbose=args.verbose,
        )
    except (Report, ReportCollection) as r:
        _print_reports(r, None)
        return 1
    except ExecError as e:
        _print_reports(e.report, None)
        return 1

    if args.inspect:
        for w in cc.inspect():
            print(w.render(cc.archive.file_library), file=sys.stderr)
    c = cc.counts()
    rows = cc.r1cs_rows()
    n_lin = sum(1 for (a, b, _c2) in rows if not a and not b)
    print(f"template instances: {len(cc.dag.nodes)}")
    print(f"non-linear constraints: {len(rows) - n_lin}")
    print(f"linear constraints: {n_lin}")
    print(f"public inputs: {c['n_pub_in']}")
    print(f"private inputs: {c['n_prv_in']}")
    print(f"public outputs: {c['n_pub_out']}")
    print(f"wires: {c['n_wires']}")
    print(f"labels: {c['n_labels']}")

    if args.r1cs:
        path = os.path.join(outdir, f"{name}.r1cs")
        cc.write_r1cs(path)
        print(f"written successfully: {path}")
    if args.sym:
        path = os.path.join(outdir, f"{name}.sym")
        cc.write_sym(path)
        print(f"written successfully: {path}")
    if args.json:
        path = os.path.join(outdir, f"{name}_constraints.json")
        with open(path, "w") as f:
            f.write(constraints_json(rows))
        print(f"written successfully: {path}")
    if args.simplification_substitution:
        path = os.path.join(outdir, f"{name}_substitutions.json")
        subs = {} if cc.simplified is None else cc.simplified.substitutions
        with open(path, "w") as f:
            f.write(substitutions_json(subs))
        print(f"written successfully: {path}")
    if args.tpu or args.wasm or args.cgen or args.wat:
        from .backend.artifacts import save_program

        path = os.path.join(outdir, f"{name}.tpu.json")
        save_program(cc, path, args.while_max_unroll)
        print(f"written successfully: {path}")
    if args.inputs:
        # reference hidden flag: log_inputs.txt (input_user.rs:397-585)
        tape, layout = cc.build_tape(args.while_max_unroll)
        path = os.path.join(outdir, "log_inputs.txt")
        with open(path, "w") as f:
            for (nm, dims, off) in layout:
                f.write(f"{nm} dims={list(dims)} offset={off}\n")
        print(f"written successfully: {path}")
    if args.irout:
        # reference hidden flag: IR dump — here the SSA witness tape
        tape, _ = cc.build_tape(args.while_max_unroll)
        path = os.path.join(outdir, f"{name}.ir.txt")
        with open(path, "w") as f:
            for i3 in range(len(tape.ops)):
                f.write(f"%{i3} = {tape.ops[i3]} "
                        f"{list(tape.args[i3])}"
                        f"{' imm=' + str(tape.imms[i3]) if tape.imms[i3] is not None else ''}\n")
            f.write(f"outputs: {tape.outputs}\n")
        print(f"written successfully: {path}")
    if args.cgen:
        # extern_c custom gates: the user links an external
        # implementation (reference c_code_generator.rs:514-545)
        for t in cc.archive.templates.values():
            if getattr(t, "is_extern_c", False):
                print(_extern_c_banner(t, args.prime))

    if args.witness:
        try:
            from .emit.inputs import prepare_main_inputs

            inputs = prepare_main_inputs(
                cc, load_inputs(args.witness, cc.p))
            w = cc.witness_host(inputs, sanity_check=args.sanity_check)
        except (Report, ReportCollection) as r:
            _print_reports(r, cc.archive.file_library)
            return 1
        except ExecError as e:
            _print_reports(e.report, cc.archive.file_library)
            return 1
        wtns = args.wtns or os.path.join(outdir, f"{name}.wtns")
        write_wtns(wtns, cc.p, w)
        print(f"witness written successfully: {wtns}")

    if args.witness_gpu:
        from .backend.torch_backend import WitnessProgram

        with open(args.witness_gpu) as f:
            batch_inputs = json.load(f)
        if isinstance(batch_inputs, dict):
            batch_inputs = [batch_inputs]
        tape, layout = cc.build_tape(args.while_max_unroll)
        # bit-constrained main inputs feed the narrow int32 lane
        # automatically (pipeline.input_range_hints)
        hints = cc.input_range_hints()
        try:
            cols = _batch_columns(
                cc.p, batch_inputs, layout, tape.n_inputs,
                main_meta=getattr(cc.archive.main.call, "meta", None))
            # hinted inputs are validated host-side unconditionally: the
            # narrow int32 lane is only sound for in-range values, and
            # with --sanity_check 0 the batched R1CS check that would
            # otherwise catch a violation is off; an out-of-range input
            # must fail loudly, never emit a wrong .wtns
            _check_hinted_columns(cols, hints, cc.p, layout)
            if tape.extern_calls:
                # extern_c gates with registered implementations:
                # evaluated host-side per batch column, their output
                # columns spliced into the device inputs
                from .backend.tape import compute_extern_columns

                compute_extern_columns(tape, cols, cc.hf)
        except (Report, ReportCollection) as r:
            _print_reports(r, cc.archive.file_library)
            return 1
        prog = WitnessProgram(tape, field_spec(args.prime), device=device,
                              unroll_threshold=0, input_ranges=hints)
        # guards of unrolled while loops (T3013) and, at --sanity_check
        # >= 1, the batched Az∘Bz−Cz check of every witness (T3012): the
        # equivalent of the reference's asserts injected into generated
        # runtimes (input_user.rs:514-520, store_bucket.rs:674-733)
        decoded = batch_witnesses(prog, cols, rows, c["n_wires"],
                                  args.sanity_check)
        if decoded is None:
            return 1
        write_batch(outdir, name, cc.p, decoded, len(batch_inputs))
        print(f"{len(batch_inputs)} witnesses written to {outdir}")
    return 0


def _extern_c_banner(tmpl, prime):
    """The reference's needs-to-be-implemented notice for extern_c custom
    gates (c_code_generator.rs:514-545): arguments first, then outputs,
    then inputs, each io signal with a size pointer."""
    from .frontend import ast as A

    elem = "uint64_t" if prime == "goldilocks" else "FrElement"
    params = [f"{elem}* {a} " for a in tmpl.args]
    outs, ins = [], []

    def collect(s):
        if isinstance(s, A.Declaration) and s.xtype.kind == "signal":
            if s.xtype.signal_type == A.SignalType.OUTPUT:
                outs.append(s.name)
            elif s.xtype.signal_type == A.SignalType.INPUT:
                ins.append(s.name)
        elif isinstance(s, A.Block):
            for st in s.stmts:
                collect(st)
        elif isinstance(s, A.InitializationBlock):
            for st in s.initializations:
                collect(st)

    collect(tmpl.body)
    for n in outs + ins:
        params.append(f"{elem}* {n} ")
        params.append(f"uint* size_{n} ")
    sig = f"void {tmpl.name}({','.join(params)});"
    return (f"*** The method {sig} generated by the custom gate "
            f"{tmpl.name} needs to be implemented ***\n")


def _print_reports(r, file_library):
    print(r.render(file_library), file=sys.stderr)
    print("previous errors were found", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
