"""Host-side (Python int) field arithmetic — the compiler's oracle.

Semantics mirror the reference's BigInt layer
(circom_algebra/src/modular_arithmetic.rs) exactly, including its quirks:

* signed comparison convention: values in [p//2 + 1, p) compare as negative
  (modular_arithmetic.rs:154-213);
* shifts wrap: a shift amount k > p//2 becomes the opposite shift by p - k
  (modular_arithmetic.rs:111-136); left shifts mask to 2**p.bit_length() - 1;
* bitwise ops operate on the plain binary representation, then reduce mod p
  (modular_arithmetic.rs:94-145);
* integer division / modulo use the *unsigned* reduced representatives
  (modular_arithmetic.rs:48-62).

Everything here assumes canonical inputs in [0, p) — the executor maintains
that invariant — but reduces defensively where the reference does.
"""

from .primes import FieldSpec


class FieldArithmeticError(Exception):
    """Raised on division by zero or a non-invertible divisor
    (reference: modular_arithmetic.rs:4-7)."""


class HostField:
    """All circom operators over Python ints for one prime field."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self.p = spec.p
        self.bits = spec.bits
        self.mask = spec.mask
        self.half = spec.half  # p // 2

    # -- basic ring ops ---------------------------------------------------
    def reduce(self, a: int) -> int:
        return a % self.p

    def add(self, a: int, b: int) -> int:
        return (a + b) % self.p

    def sub(self, a: int, b: int) -> int:
        return (a - b) % self.p

    def mul(self, a: int, b: int) -> int:
        return (a * b) % self.p

    def neg(self, a: int) -> int:
        return (-a) % self.p

    def div(self, a: int, b: int) -> int:
        """Field division via modular inverse (modular_arithmetic.rs:41-47)."""
        try:
            inv = pow(b % self.p, -1, self.p)
        except ValueError:
            raise FieldArithmeticError("division by zero (no inverse)")
        return (a * inv) % self.p

    def inv(self, a: int) -> int:
        return self.div(1, a)

    def idiv(self, a: int, b: int) -> int:
        """Integer division of unsigned representatives
        (modular_arithmetic.rs:48-57)."""
        a, b = a % self.p, b % self.p
        if b == 0:
            raise FieldArithmeticError("integer division by zero")
        return a // b

    def mod(self, a: int, b: int) -> int:
        """a mod b over unsigned representatives (modular_arithmetic.rs:58-62)."""
        a, b = a % self.p, b % self.p
        if b == 0:
            raise FieldArithmeticError("modulo by zero")
        return a % b

    def pow(self, a: int, e: int) -> int:
        return pow(a % self.p, e % self.p if e >= 0 else e, self.p)

    def multi_inv(self, values):
        """Batch inversion, Montgomery's trick (modular_arithmetic.rs:71-91)."""
        partials = [1]
        for v in values:
            partials.append((partials[-1] * v) % self.p)
        inv = self.div(1, partials[-1])
        out = [0] * len(values)
        for i in range(len(values) - 1, -1, -1):
            out[i] = (partials[i] * inv) % self.p
            inv = (inv * values[i]) % self.p
        return out

    # -- bit ops ----------------------------------------------------------
    def complement(self, a: int) -> int:
        """Bitwise NOT over p.bit_length() bits, then mod p
        (modular_arithmetic.rs:94-109)."""
        return (self.mask ^ (a % self.p)) % self.p

    def shift_l(self, a: int, k: int) -> int:
        """Left shift with wraparound (modular_arithmetic.rs:111-123)."""
        if k <= self.half:
            if k >= self.bits:
                return 0
            return ((a << k) & self.mask) % self.p
        return self.shift_r(a, self.p - k)

    def shift_r(self, a: int, k: int) -> int:
        """Right shift with wraparound (modular_arithmetic.rs:124-136)."""
        if k <= self.half:
            if k >= self.bits:
                return 0
            return a >> k
        return self.shift_l(a, self.p - k)

    def bit_or(self, a: int, b: int) -> int:
        return (a | b) % self.p

    def bit_and(self, a: int, b: int) -> int:
        return (a & b) % self.p

    def bit_xor(self, a: int, b: int) -> int:
        return (a ^ b) % self.p

    # -- signed comparison convention --------------------------------------
    def to_signed(self, a: int) -> int:
        """Map [p//2+1, p) to negatives (modular_arithmetic.rs:154-164)."""
        a = a % self.p
        return a - self.p if a > self.half else a

    def as_bool(self, a: int) -> bool:
        return a % self.p != 0

    def normalize_bool(self, a: int) -> int:
        return 1 if self.as_bool(a) else 0

    def bool_not(self, a: int) -> int:
        return (self.normalize_bool(a) + 1) % 2

    def bool_and(self, a: int, b: int) -> int:
        return self.normalize_bool(a) * self.normalize_bool(b)

    def bool_or(self, a: int, b: int) -> int:
        na, nb = self.normalize_bool(a), self.normalize_bool(b)
        return (na + nb + na * nb) % 2

    def eq(self, a: int, b: int) -> int:
        return 1 if (a % self.p) == (b % self.p) else 0

    def not_eq(self, a: int, b: int) -> int:
        return 1 - self.eq(a, b)

    def lesser(self, a: int, b: int) -> int:
        return 1 if self.to_signed(a) < self.to_signed(b) else 0

    def lesser_eq(self, a: int, b: int) -> int:
        return 1 if self.to_signed(a) <= self.to_signed(b) else 0

    def greater(self, a: int, b: int) -> int:
        return 1 if self.to_signed(a) > self.to_signed(b) else 0

    def greater_eq(self, a: int, b: int) -> int:
        return 1 if self.to_signed(a) >= self.to_signed(b) else 0
