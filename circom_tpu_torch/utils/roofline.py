"""The card's peaks and the interpreter's counts, for the roofline.

One count for `chip_smoke.py` and `bench_gpu.py`: the bytes a second of
HBM3 and the 32-bit integer instructions a second of the card, and what
the interpreter kernel K1 and the witness gathers need a lane (a
witness), counted from the plan.
"""

import subprocess

import torch

from ..backend.interp_plan import _NARROW_RESULT as NARROW_RESULT
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
