"""kernel_ab.py's K4 case on the CPU: the parts that need no card.

- A checkout's own generator, run in a child process with only that
  checkout on its path (`k4_source`), writes the source this checkout's
  program generates, with the in-place interface and the planner's
  segment counts (`k4_stacked`, `k4_segments`); the stacked interface of
  the earlier K4 is told apart by its two buffers.
- The frozen stacked route (`stacked_run`), its launches replaced by the
  plain version over each segment's stacked inputs and outputs, gives
  the in-place route's witness bit for bit.

Comparisons are exact: field elements are integers.
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

from circom_tpu_torch import kernel_ab
from circom_tpu_torch.backend.segments import segment_ref
from circom_tpu_torch.backend.torch_backend import WitnessProgram
from circom_tpu_torch.circuits.sources import num2bits_source
from circom_tpu_torch.compiler.pipeline import compile_source
from circom_tpu_torch.field.primes import field_spec
from circom_tpu_torch.ops.limbs import ints_to_limbs

ROOT = Path(__file__).resolve().parents[1]

# the entry point of the stacked K4 (a segment's inputs -> its outputs)
STACKED_ENTRY = """
// segment 0: 508 ops, 1 inputs, 254 outputs
extern "C" int ctpu_k4_seg0(const uint32_t* xin, uint32_t* xout,
                               long long B, void* stream) {
"""


def n2b(copies):
    cc = compile_source(num2bits_source(254, copies))
    return WitnessProgram(cc.build_tape()[0], field_spec("bn128"),
                          device="cpu")


def test_k4_source_of_a_checkout(tmp_path):
    prog = n2b(1)
    text = kernel_ab.k4_source(ROOT, 1, tmp_path / "k4.txt")
    assert text == prog.fused.source()
    assert not kernel_ab.k4_stacked(text)
    assert kernel_ab.k4_segments(text) == [
        (len(g.instrs), len(g.src), len(g.dst))
        for g in prog.fused.kernels]
    assert kernel_ab.k4_stacked(STACKED_ENTRY)
    assert kernel_ab.k4_segments(STACKED_ENTRY) == [(508, 1, 254)]


def plain_launch(sp):
    """launch(s, xin, out) of the stacked interface by the plain version:
    segment s's operand k read from row k of xin, output k written to row
    k of out."""
    def launch(s, xin, out):
        seg = copy.copy(sp.kernels[s])
        seg.src = tuple(("x", k) for k in range(xin.shape[0]))
        seg.dst = tuple((("w", k),) for k in range(out.shape[0]))
        seg.fill = ()
        none = torch.empty((0,) + tuple(out.shape[1:]), dtype=torch.int32)
        segment_ref(sp.field, seg, xin, out, none)
    return launch


@pytest.mark.parametrize("copies", [1, 4])
def test_stacked_route_matches_the_in_place_route(copies):
    sp = n2b(copies).fused
    p = sp.field.p
    rng = np.random.default_rng(60 + copies)
    cols = [[0, 1, p - 1, p // 2] + [int.from_bytes(rng.bytes(32), "little")
                                     % p for _ in range(5)]
            for _ in range(copies)]
    x = torch.from_numpy(np.stack([ints_to_limbs(c, sp.L).T.copy()
                                   for c in cols]).view(np.int32)) \
        .view(torch.uint32)
    got, bufs = kernel_ab.stacked_run(sp, plain_launch(sp), x)
    assert len(bufs) == len(sp.segments)
    assert torch.equal(got.view(torch.int32), sp._run(x).view(torch.int32))
