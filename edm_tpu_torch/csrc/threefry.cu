// Threefry-2x32 random bits on the card, for Hopper (sm_90a).
//
// The JAX hosts draw their thermostat normals and hill-acceptance uniforms
// with jax.random (edm_tpu/models/langevin.py:50-51,
// edm_tpu/models/coord_edm.py:135-137), which under
// jax_threefry_partitionable hashes the 64-bit counter i of every element
// (high word, low word) under the key with the 20-round Threefry-2x32 block
// function.  This kernel computes those blocks: thread i hashes counter i
// and writes the xor of the two output words (32-bit bits, `wide` = 0) or
// both words, high first (the two halves of 64-bit bits, `wide` = 1).  It
// replaces no TPU kernel: XLA computes the same chain there.  Its plain
// version is the numpy chain of ops/prng.py, and the two are bitwise equal.
//
// What bounds it: the bytes written (4 or 8 per element); the 20 rounds are
// ~100 integer operations per element, far under the card's integer rate.
// At the 2-D host's shapes (10,000 or 20,000 elements) it is one short
// launch, and its fixed cost is the time.  The key comes in as two kernel
// arguments, so nothing is copied to the card and nothing synchronizes.
//
// Plain C interface, loaded with ctypes; the launch goes on the caller's
// stream and the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TF_THREADS = 256;

__device__ __forceinline__ uint32_t tf_rotl(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}

// four rounds of mixing with the given rotations
#define TF_ROUNDS(a, b, c, d)    \
  x0 += x1;                      \
  x1 = tf_rotl(x1, a) ^ x0;      \
  x0 += x1;                      \
  x1 = tf_rotl(x1, b) ^ x0;      \
  x0 += x1;                      \
  x1 = tf_rotl(x1, c) ^ x0;      \
  x0 += x1;                      \
  x1 = tf_rotl(x1, d) ^ x0;

__global__ void __launch_bounds__(TF_THREADS)
tf_bits(uint32_t k0, uint32_t k1, long long n, int wide, uint32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * TF_THREADS + threadIdx.x;
  if (i >= n) return;
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = (uint32_t)((unsigned long long)i >> 32) + k0;
  uint32_t x1 = (uint32_t)i + k1;
  TF_ROUNDS(13, 15, 26, 6)
  x0 += k1;
  x1 += k2 + 1u;
  TF_ROUNDS(17, 29, 16, 24)
  x0 += k2;
  x1 += k0 + 2u;
  TF_ROUNDS(13, 15, 26, 6)
  x0 += k0;
  x1 += k1 + 3u;
  TF_ROUNDS(17, 29, 16, 24)
  x0 += k1;
  x1 += k2 + 4u;
  TF_ROUNDS(13, 15, 26, 6)
  x0 += k2;
  x1 += k0 + 5u;
  if (wide) {
    out[2 * i] = x0;
    out[2 * i + 1] = x1;
  } else {
    out[i] = x0 ^ x1;
  }
}

#undef TF_ROUNDS

}  // namespace

extern "C" {

// out: n uint32 (wide = 0) or 2n (wide = 1)
int threefry_bits_launch(unsigned k0, unsigned k1, long long n, int wide, void* out,
                         void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const long long blocks = (n + TF_THREADS - 1) / TF_THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  tf_bits<<<(unsigned)blocks, TF_THREADS, 0, (cudaStream_t)stream>>>(
      k0, k1, n, wide, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
