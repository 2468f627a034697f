"""Prime fields supported by the framework.

Mirrors the reference's prime table (reference:
program_structure/src/utils/constants.rs:3-13 and
circom/src/input_user.rs:371-395): eight named primes selectable with
``--prime``.  We additionally record limb geometry used by the TPU backend
(base-2^16 limb planes, see circom_tpu/ops/limbs.py).
"""

from dataclasses import dataclass
from functools import lru_cache

PRIMES = {
    "bn128": 21888242871839275222246405745257275088548364400416034343698204186575808495617,
    "bls12381": 52435875175126190479447740508185965837690552500527637822603658699938581184513,
    "goldilocks": 18446744069414584321,
    "grumpkin": 21888242871839275222246405745257275088696311157297823662689037894645226208583,
    "pallas": 28948022309329048855892746252171976963363056481941560715954676764349967630337,
    "vesta": 28948022309329048855892746252171976963363056481941647379679742748393362948097,
    "secq256r1": 115792089210356248762697446949407573530086143415290314195533631308867097853951,
    "bls12377": 8444461749428370424248824938781546531375899335154063827935233455917409239041,
}

LIMB_BITS = 16  # base-2^16 limb planes for the TPU backend


@dataclass(frozen=True)
class FieldSpec:
    """Static description of one prime field."""

    name: str
    p: int

    @property
    def bits(self) -> int:
        """Bit length of p (used for shift/complement masking,
        reference: circom_algebra/src/modular_arithmetic.rs:17-23,94-109)."""
        return self.p.bit_length()

    @property
    def mask(self) -> int:
        """2**bits - 1."""
        return (1 << self.bits) - 1

    @property
    def half(self) -> int:
        """p // 2 — the signed-comparison pivot
        (reference: modular_arithmetic.rs:154-165)."""
        return self.p // 2

    @property
    def n_limbs(self) -> int:
        """Number of base-2^16 limbs for the TPU representation."""
        return -(-self.bits // LIMB_BITS)

    @property
    def n_bytes(self) -> int:
        """Field-element byte width in serialized artifacts:
        ceil(bits/64)*8, matching the reference's Fr_N64*8
        (code_producers/src/c_elements/common/main.cpp:306)."""
        return -(-self.bits // 64) * 8

    @property
    def n32(self) -> int:
        """ceil(bits/32) — wasm 32-bit word count
        (compiler/src/circuit_design/build.rs:227)."""
        return -(-self.bits // 32)


@lru_cache(maxsize=None)
def field_spec(name: str) -> FieldSpec:
    if name not in PRIMES:
        raise ValueError(
            f"unknown prime '{name}'; valid: {', '.join(sorted(PRIMES))}"
        )
    return FieldSpec(name, PRIMES[name])


DEFAULT_PRIME = "bn128"
