// Threefry-2x32 random bits on the card, for Hopper (sm_90a).
//
// The JAX hosts draw their thermostat normals and hill-acceptance uniforms
// with jax.random (edm_tpu/models/langevin.py:50-51,
// edm_tpu/models/coord_edm.py:135-137, edm_tpu/models/pair_edm.py:131-132),
// which under jax_threefry_partitionable hashes the 64-bit counter i of
// every element (high word, low word) under the key with the 20-round
// Threefry-2x32 block function.  Two kernels, neither a counterpart of a
// TPU kernel (XLA computes the same chain there); their plain versions are
// the numpy chain of ops/prng.py, and each is bitwise equal to it.
//
// tf_bits: thread i hashes counter i and writes the xor of the two output
// words (32-bit bits, `wide` = 0) or both words, high first (the two halves
// of 64-bit bits, `wide` = 1).
//
// tf_rows: the blocked pair host's per-row acceptance streams
// (edm_tpu/models/pair_edm_blocked.py:115-118): row r of the output is
// jax.random.uniform(fold_in(key, rows[r]), (n,)), where fold_in(key, d) is
// the block of the counter (0, d) under the key.  The row ids are a device
// array (pass 2's rows are computed on the card), so each thread folds its
// row in itself and then hashes its column under the row's key: one thread
// per output element, two blocks of 20 rounds.  It writes the uniform
// directly, by the mantissa trick: float32 takes the xor's top 23 bits,
// float64 the 64-bit word's top 52 (high word over low), under the
// exponent of 1.0, minus 1 (exact).
//
// What bounds them: the card's least time is the bytes written (4 or 8 per
// element), but each block is ~100 integer operations on the int32 pipes,
// at half the float32 rate.  At the 2-D host's shapes (10,000 or 20,000
// elements) tf_bits is one short launch and its fixed cost is the time.
// tf_rows hashes two blocks an element: at the blocked host's pass 1 (500
// rows x 10,000, 20 MB of float32, ~6 us of bytes) the integer rounds take
// ~38 us on an H100 (chip_smoke.py); a row key per block of threads
// instead of per thread would halve them.  The key comes in as two kernel
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

// the 20-round block function: (x0, x1) hashed in place under (k0, k1)
__device__ __forceinline__ void tf_block(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
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
}

__global__ void __launch_bounds__(TF_THREADS)
tf_bits(uint32_t k0, uint32_t k1, long long n, int wide, uint32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * TF_THREADS + threadIdx.x;
  if (i >= n) return;
  uint32_t x0 = (uint32_t)((unsigned long long)i >> 32);
  uint32_t x1 = (uint32_t)i;
  tf_block(k0, k1, x0, x1);
  if (wide) {
    out[2 * i] = x0;
    out[2 * i + 1] = x1;
  } else {
    out[i] = x0 ^ x1;
  }
}

// grid: x over the columns, y over the rows (strided when R > gridDim.y)
__global__ void __launch_bounds__(TF_THREADS)
tf_rows(uint32_t k0, uint32_t k1, const int* __restrict__ rows, int R, int n, int f64,
        void* __restrict__ out) {
  const int j = blockIdx.x * TF_THREADS + threadIdx.x;
  if (j >= n) return;
  for (int r = blockIdx.y; r < R; r += gridDim.y) {
    uint32_t r0 = 0u, r1 = (uint32_t)rows[r];
    tf_block(k0, k1, r0, r1);  // fold_in(key, rows[r])
    uint32_t x0 = 0u, x1 = (uint32_t)j;
    tf_block(r0, r1, x0, x1);
    const long long o = (long long)r * n + j;
    if (f64) {
      const unsigned long long w = ((unsigned long long)x0 << 32) | x1;
      static_cast<double*>(out)[o] =
          __longlong_as_double((long long)((w >> 12) | 0x3FF0000000000000ull)) - 1.0;
    } else {
      static_cast<float*>(out)[o] = __int_as_float((int)(((x0 ^ x1) >> 9) | 0x3F800000u)) - 1.0f;
    }
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

// rows: R int32 row ids on the card; out: R x n float32 (f64 = 0) or
// float64 (f64 = 1)
int threefry_rows_launch(unsigned k0, unsigned k1, const void* rows, int R, int n, int f64,
                         void* out, void* stream) {
  if (R < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (R == 0 || n == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((n + TF_THREADS - 1) / TF_THREADS), (unsigned)(R < 65535 ? R : 65535));
  tf_rows<<<grid, TF_THREADS, 0, (cudaStream_t)stream>>>(
      k0, k1, static_cast<const int*>(rows), R, n, f64, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
