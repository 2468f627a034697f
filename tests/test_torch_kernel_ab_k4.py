"""kernel_ab.py's K4 case on the CPU: the parts that need no card.

- A checkout's own generator, run in a child process with only that
  checkout on its path (`k4_source`), writes the source this checkout's
  program generates, with the in-place interface and the planner's
  segment counts (`k4_stacked`, `k4_segments`); the stacked interface of
  the earlier K4, which kernel_ab refuses, is told apart by its two
  buffers.

Comparisons are exact: field elements are integers.
"""

from pathlib import Path

from circom_tpu_torch import kernel_ab
from circom_tpu_torch.backend.torch_backend import WitnessProgram
from circom_tpu_torch.circuits.sources import num2bits_source
from circom_tpu_torch.compiler.pipeline import compile_source
from circom_tpu_torch.field.primes import field_spec

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
