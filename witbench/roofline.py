"""The card's peaks and the layers' least work, for the roofline shares.

Peaks (copied from the port's utils/roofline.py, which the benchmark does
not import): HBM3 at 3.35 TB/s (the H100 SXM data sheet), and 32-bit
integer instructions at 64 a clock on each SM (the CUDA C++ Programming
Guide's throughput table, compute capability 9.0) times the SMs times the
card's maximum SM clock.

Counts belong to a layer, not to a kernel, and come from the circuit (its
tape, its R1CS and its inputs' proven ranges), so that they read the same
whatever kernels do the work.  Each is the least the layer can do:

- bytes are each value's least bytes, not its storage: a field element
  ceil(bits(p) / 8) (32 at bn128, where a row of 16-bit limbs stores 64),
  a narrow row of run_mixed one bit (the least any value takes), an input
  proven to lie in [lo, hi] bits(hi - lo) bits;
- the witness program reads its inputs once and writes its witness rows
  once in the cell's layout (full elements, or run_mixed's narrow and
  wide rows); its integer work is, for each product of the tape, the
  32-bit word products of its operands' schoolbook multiply, the
  reduction not counted: 8 x 8 = 64 for two bn128 elements, 1 for two
  operands proven to fit a word (bits, small sums), their widths taken
  from signed intervals over the tape;
- the R1CS checker reads z once (full elements) and the R1CS's entries
  once (a column index of bits(n_wires) bits and the coefficient's least
  bytes, of the smaller of c and p - c); its integer work is, for each
  nonzero term, the word products of an element by the coefficient, and
  for each constraint with A and B the product A.B's.

A share is the least time, the larger of bytes over the bandwidth and
instructions over the instruction rate, over the measured time.
"""

import subprocess

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_SM_CLOCK = 64


def int_ops_per_s(device_index=0):
    """The card's peak rate of 32-bit integer instructions: its SMs times
    its maximum SM clock (MHz, nvidia-smi clocks.max.sm) times
    INT_OPS_PER_SM_CLOCK."""
    import torch

    smi = subprocess.run(
        ["nvidia-smi", f"--id={device_index}", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    mhz = float(smi.stdout.split()[0])
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return INT_OPS_PER_SM_CLOCK * sms * mhz * 1e6


def words(x):
    """32-bit words of a nonnegative integer (at least one)."""
    return max(1, -(-x.bit_length() // 32))


def tape_word_products(tape, p, hints):
    """The word products of the tape's `mul` nodes that a witness row
    depends on (not a constraint's own check), counted low: each
    operand's width from a signed interval (inputs from `hints`, {input:
    (lo, hi)}; any op this pass does not follow gives a one-word value,
    which counts lower still); an interval that reaches p/2 is a full
    element."""
    half, n = p // 2, words(p)
    iv = []

    def fit(lo, hi):
        return (lo, hi) if -half < lo and hi < half else None

    def width(r):
        return n if r is None else words(max(-r[0], r[1]))

    live = [False] * len(tape.ops)
    for o in tape.outputs:
        live[o] = True
    for i in range(len(tape.ops) - 1, -1, -1):
        if live[i]:
            for a in tape.args[i]:
                live[a] = True
    total = 0
    for op, args, imm, used in zip(tape.ops, tape.args, tape.imms, live):
        x = iv[args[0]] if args else None
        y = iv[args[1]] if len(args) > 1 else None
        if op == "input":
            r = hints.get(imm)
        elif op == "const":
            v = imm % p
            r = (v, v) if v <= half else (v - p, v - p)
        elif op in ("add", "sub"):
            if x is None or y is None:
                r = None
            elif op == "add":
                r = fit(x[0] + y[0], x[1] + y[1])
            else:
                r = fit(x[0] - y[1], x[1] - y[0])
        elif op == "neg":
            r = None if x is None else (-x[1], -x[0])
        elif op == "mul":
            total += used * width(x) * width(y)
            if x is None or y is None:
                r = None
            else:
                c = [a * b for a in x for b in y]
                r = fit(min(c), max(c))
        elif op == "shr_k":
            top = x[1] if x is not None and x[0] >= 0 else p - 1
            r = (0, top >> imm)
        elif op == "band":
            tops = [z[1] for z in (x, y) if z is not None and z[0] >= 0]
            r = (0, min(tops)) if tops else None
        else:
            r = (0, 1)
        iv.append(r)
    return total


def circuit_counts(tape, rows, p, hints):
    """What the layers need, counted from the tape, the R1CS and the
    inputs' ranges: a lane's word products and input bits, the element
    bytes, the witness rows, and the R1CS check's word products a lane
    and its entries' bytes."""
    elem = -(-p.bit_length() // 8)
    n_witness = len(tape.outputs)
    col = -(-n_witness.bit_length() // 8)
    terms = [c for row in rows for m in row for c in m.values()]
    coef = [min(c % p, p - c % p) for c in terms]
    n = words(p)
    return {"run_products": tape_word_products(tape, p, hints),
            "input_bits": sum(max(1, (hints[i][1] - hints[i][0])
                                  .bit_length()) if i in hints
                              else p.bit_length()
                              for i in range(tape.n_inputs)),
            "elem_bytes": elem,
            "n_witness": n_witness,
            "check_products": n * sum(words(c) for c in coef)
            + n * n * sum(bool(a and b) for a, b, _ in rows),
            "r1cs_bytes": sum(col + max(1, -(-c.bit_length() // 8))
                              for c in coef)}


def least_s(nbytes, ops, int_rate):
    """(least seconds, the bound that sets it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / int_rate
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "ops")


def run_work(counts, out_bytes, lanes):
    """(bytes, instructions) of a witness run of `lanes` lanes: its
    inputs' least bytes and out_bytes, a lane's witness rows at theirs."""
    return (lanes * (counts["input_bits"] / 8 + out_bytes),
            lanes * counts["run_products"])


def check_work(counts, lanes):
    """(bytes, instructions) of an R1CS check of `lanes` lanes: z read
    once, the entries once a check."""
    return (lanes * counts["n_witness"] * counts["elem_bytes"]
            + counts["r1cs_bytes"], lanes * counts["check_products"])
