// The narrow int32 lane's arithmetic: the 13 opcodes of K1b, the narrow
// ones of K1d and the bit unpack of K3, with XLA's semantics where C++
// leaves the result undefined.
//
// The JAX interpreter kernel computes these ops with jnp on int32 (wrapping
// mod 2^32) and reads each shift count as uint32: a count >= 32, a negative
// one included, gives 0 for `<<` and for a logical `>>`, and the sign fill
// for an arithmetic `>>`.  In C++ signed overflow and such shifts are
// undefined, so everything here computes in uint32 and guards the count.
// The plain PyTorch versions are ops/narrow.py.
#pragma once

#include <cstdint>

namespace ctpu {

__device__ __forceinline__ uint32_t nshl32(uint32_t x, uint32_t s) {
  return s >= 32u ? 0u : x << s;
}

__device__ __forceinline__ uint32_t nshru32(uint32_t x, uint32_t s) {
  return s >= 32u ? 0u : x >> s;
}

__device__ __forceinline__ int32_t nshra32(int32_t x, uint32_t s) {
  return x >> (s >= 32u ? 31u : s);  // arithmetic shift in nvcc
}

// rotate right: (x >>u r) | (x << (32 - r)) under the count rule above, so
// r = 0 and r = 32 give x and r > 32 gives 0 (__funnelshift_r would mask
// the count to 5 bits and differ outside 1..31)
__device__ __forceinline__ uint32_t nrotr32(uint32_t x, uint32_t r) {
  return nshru32(x, r) | nshl32(x, 32u - r);
}

// jnp's int32 floor division a // b with the kernel's guard: 0 for b = 0.
// C's `/` truncates, so the quotient steps down when the remainder is
// nonzero and of the other sign than b; INT32_MIN / -1, undefined in C,
// wraps to INT32_MIN as in XLA.
__device__ __forceinline__ int32_t nidiv32(int32_t a, int32_t b) {
  if (b == 0) return 0;
  if (b == -1) return (int32_t)(0u - (uint32_t)a);
  const int32_t q = a / b, r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

// the bit unpack of the narrow witness gather: shift < 0 keeps the row,
// else (row >>u shift) & 1
__device__ __forceinline__ int32_t unpack_bit(int32_t v, int32_t shift) {
  return shift < 0 ? v : (int32_t)(nshru32((uint32_t)v, (uint32_t)shift) & 1u);
}

}  // namespace ctpu
