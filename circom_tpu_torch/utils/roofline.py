"""The card's peaks and the kernels' counts, for the roofline.

One count for `chip_smoke.py` and `bench_gpu.py`: the bytes a second of
HBM3 and the 32-bit integer instructions a second of the card, what the
interpreter kernel K1 and the witness gathers need a lane (a witness),
counted from the plan, what the assembly kernel KW moves, counted from
its table, and what the per-op kernel KS needs a lane, counted from its
tables.
"""

import subprocess

import numpy as np
import torch

from ..backend.interp import (KW_BANK, KW_CONST, KW_INPUT, KW_NARROW,
                              kw_table)
from ..backend.interp_plan import _NARROW_RESULT as NARROW_RESULT
from ..backend.ks import KS_OPS, arity
from ..convert import OPCODES

# H100 SXM peak HBM3 bandwidth (NVIDIA data sheet), and the peak rate of
# 32-bit integer instructions, which lane_ops_per_s reads off the card: 64
# integer adds or multiply-adds a clock on each SM (the CUDA C++
# Programming Guide's throughput table, compute capability 9.0) x the SMs
# x the card's maximum SM clock.
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_SM_CLOCK = 64


def lane_ops_per_s(dev):
    """The card's peak rate of 32-bit integer instructions:
    INT_OPS_PER_SM_CLOCK x its SMs x its maximum SM clock (nvidia-smi
    clocks.max.sm, MHz)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True)
    mhz = float(smi.stdout.split()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return INT_OPS_PER_SM_CLOCK * sms * mhz * 1e6, sms, mhz


# 32x32->64-bit products of K1's product opcodes a lane, in units of N^2
# (N = L/2 words): a Montgomery product 2, a dot of n terms n + 1, a
# goldilocks product (one 64x64->128-bit product in N = 2 words) 1
_PRODUCTS_N2 = {"mul": 2, "mul_r2": 2, "mul_c": 2, "mul_one": 2,
                "dot2_c": 3, "dot3_c": 4, "gmul": 1, "gmul_c": 1}


def k1_ops(plan, bits):
    """32-bit integer instructions K1 executes a lane, counted low: two a
    32x32->64-bit product (the low and the high word) of the products,
    dots, goldilocks products and trailing REDCs (N^2 products each) in
    N = L/2 words; 4N a bit of p for the long division (shift, subtract,
    select, quotient); N for another wide step and 1 for a narrow one."""
    N = plan.L // 2
    products = int(plan.mont_tab.sum()) * N * N
    ops = 0
    for k in plan.table[:plan.n_steps, 0].tolist():
        op = OPCODES[k]
        if op in _PRODUCTS_N2:
            products += _PRODUCTS_N2[op] * N * N
        elif op == "idiv":
            ops += 4 * N * bits
        else:
            ops += 1 if op in NARROW_RESULT else N
    return 2 * products + ops


def witness_bytes(plan, mixed=False):
    """HBM bytes of an interpreter run a lane, each counted once: K1's
    emission write (the wide and narrow bank rows it stores), the witness
    gathers' read (K2's distinct wide source rows, K3's distinct narrow
    ones) and the witness write, 4 bytes a 16-bit limb and an int32 narrow
    row (the mixed witness, run_mixed) or L limbs a row (the full-limb
    witness, run).  The register file's traffic is not counted."""
    row = 4 * plan.L
    emitted = row * len(plan.emitted_rows()) \
        + 4 * len(plan.emitted_rows(narrow=True))
    read = row * len(set(plan.wd_src.tolist())) \
        + 4 * len(set(plan.nw_src.tolist()))
    if mixed:
        written = row * len(plan.wd_src) + 4 * len(plan.nw_src)
    else:
        written = row * plan.n_witness
    return emitted + read + written


def kw_bytes(plan, B):
    """KW's HBM bytes at B lanes, each counted once: the full-limb witness
    written (L 16-bit limbs a row and a lane) and each distinct source row
    of its table read (a wide bank or input row L limbs a lane, a narrow
    bank row one int32 a lane, a constant L limbs), 4 bytes a limb and an
    int32.  The table itself (16 bytes a row) is not counted."""
    L = plan.L
    src = {tuple(r) for r in kw_table(plan)[:, :2].tolist()}
    lane = {KW_BANK: L, KW_INPUT: L, KW_NARROW: 1, KW_CONST: 0}
    per_lane = L * plan.n_witness + sum(lane[k] for k, _ in src)
    consts = sum(L for k, _ in src if k == KW_CONST)
    return 4 * (B * per_lane + consts)


def ks_bytes(t, L):
    """KS's bytes a lane from its tables t (backend/ks.KsTables), 4 bytes
    a word and a limb: {"compulsory": the inputs read once (L 16-bit
    limbs each) and the witness written once (L a row); "spill": the
    accesses to spilled registers, which reach device memory (N = L/2
    words an operand read, a register written); "shared": the same
    accesses to the registers in shared memory, which stay on the SM}.
    The bound is compulsory + spill.  A shift or a long division reads its
    operand's N words in place; select its condition and one of its two
    values, counted as the first; constants (read-only cache) and a copied
    row's read are not counted."""
    N = L // 2
    op = np.asarray(KS_OPS)[t.ent[:, 0]]
    words = {"spill": 0, "shared": 0}

    def count(regs):
        regs = regs[regs >= 0]
        words["shared"] += N * int((regs < t.n_smem).sum())
        words["spill"] += N * int((regs >= t.n_smem).sum())

    for o in set(op.tolist()) - {"const", "input", "dup"}:
        e = t.ent[op == o]
        count(e[:, 1:1 + min(arity(o), 2)].reshape(-1))
    count(t.ent[:, 4])
    n_inputs = int((op == "input").sum())
    return {"compulsory": 4 * L * (n_inputs + t.n_witness),
            "spill": 4 * words["spill"], "shared": 4 * words["shared"]}


def ks_ops(t, p):
    """KS's 32-bit integer instructions a lane from its tables, counted
    low: two a 32x32->64-bit product, 2 N^2 products a Montgomery product
    (N = L/2 words): one for mul, to_mont and from_mont, two for mulp, 32
    squares and a product a set exponent bit for pow_k, p - 2's bits below
    its top (a square each, a product where set) and the last product for
    div; 4 N a bit of p for the long division of idiv and mod (mod adds
    two products and N); N for every other opcode, none for a load, a
    constant's row or a copied row."""
    bits = p.bit_length()
    N = -(-bits // 16) // 2
    mont = 4 * N * N
    e = p - 2
    div = (e.bit_length() - 1 + bin(e).count("1")) * mont
    fixed = {"mul": mont, "to_mont": mont, "from_mont": mont,
             "mulp": 2 * mont, "div": div, "idiv": 4 * N * bits,
             "mod": 4 * N * bits + 2 * mont + N,
             "const": 0, "input": 0, "dup": 0}
    ops = 0
    for code, imm in zip(t.ent[:, 0].tolist(), t.ent[:, 6].tolist()):
        o = KS_OPS[code]
        if o == "pow_k":
            ops += (32 + bin(imm & 0xFFFFFFFF).count("1")) * mont
        else:
            ops += fixed.get(o, N)
    return ops
