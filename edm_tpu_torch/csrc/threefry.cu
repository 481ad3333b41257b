// Threefry-2x32 draws on the card, for Hopper (sm_90a).
//
// The JAX hosts draw their thermostat normals and hill-acceptance uniforms
// with jax.random (edm_tpu/models/langevin.py:50-51,
// edm_tpu/models/coord_edm.py:135-137, edm_tpu/models/pair_edm.py:131-132),
// which under jax_threefry_partitionable hashes the 64-bit counter i of
// every element (high word, low word) under the key with the 20-round
// Threefry-2x32 block function; the blocked pair host draws one stream a
// row, uniform(fold_in(key, row), (n,)) (edm_tpu/models/pair_edm_blocked.py:
// 115-118).  Under jit XLA computes each draw as one fusion: hash, mantissa
// and erfinv together.  Neither kernel here is the counterpart of a Pallas
// kernel; their plain versions are the numpy chain of ops/prng.py and the
// PyTorch ops it feeds, and each kernel is bitwise that chain (normals: the
// same steps, with CUDA's erfinv in place of PyTorch's CPU one).
//
// tf_bits: one draw of n elements under one key, templated on what it
// writes: the bits (the xor of the two output words, or both words, high
// first: the halves of 64-bit bits), a uniform on [0, 1) or a normal, in
// float32 or float64.  The uniform is the mantissa trick: float32 takes the
// xor's top 23 bits, float64 the 64-bit word's top 52 (high word over low),
// under the exponent of 1.0, minus 1 (exact).  The normal is JAX's
// _normal_real on that uniform f: u = max(lo, f span + lo), then
// sqrt(2) erfinv(u), each step rounded as PyTorch's elementwise kernels
// round it: lo = nextafter(-1, 0), span = 1 - lo and sqrt(2) come rounded
// to the type from the host, the product and the sum are two roundings
// (the build's -fmad=false keeps f span + lo from contracting into an
// FMA), and erfinv is CUDA's erfinvf / erfinv, which torch.erfinv calls on
// the card.  So a draw is one launch where the port used to spend the bits
// kernel and 4 to 13 elementwise launches.
//
// tf_rows: (R,) row ids, int32 or int64 (narrowed to 32 bits, as the plain
// version and fold_in take them) -> (R, n) uniforms; row r is
// uniform(fold_in(key, rows[r]), (n,)), fold_in(key, d) being the block of
// the counter (0, d) under the key.  The row ids are a device array (pass
// 2's rows are computed on the card), so the row keys are derived on the
// card: once a row and block, by the block's first threads into shared
// memory; every thread then hashes its columns under its row's key.  One
// block an element and one a row per block, where deriving the key a
// thread hashed two blocks an element.
//
// The launch shapes are ops/prng.py's plans (draw_plan, rows_plan), which
// the CPU tests enumerate; the launchers check them.  A thread writes a
// slot: 16 bytes with one vector store (4 float32 or uint32, 2 float64 or
// uint2), or one element.
// - tf_bits: slot q is elements [q vec, q vec + vec), the last one cut at n
//   and written with scalar stores.  vec is 1 below DRAW_VEC_MIN elements
//   (the thermostat's 20,000 or 30,000: a launch's fixed cost sets the
//   time, and a thread an element gives the most blocks), 16 bytes' worth
//   from there (the dense host's 10^6 uniforms).
// - tf_rows: a block is (tx slots) x (tr rows), tx tr = 256, tx the power
//   of two (4 to 256) that covers a row's slots, so a 448- or 864-column
//   row of the work-sharded host takes one block of 128 or 256 threads and
//   short rows share a block.  Row r's slots: slot 0 the columns before its
//   first 16-byte boundary (r n is its offset in the output), slots 1..nb
//   one vector each, slot nb + 1 the columns after the last whole vector;
//   so any n and any row alignment work, and n / vec + 2 slots cover a row.
//   The grid is x over slot tiles and y over row tiles, y strided past
//   65,535 tiles.
//
// What bounds them (chip_smoke.py counts it): a block is 72 integer
// operations (20 rounds of an add, a rotation, one funnel shift, and an
// xor; six key injections of two adds, the key's words and their counter
// sums taken once a key), at half the float32 rate on the int32 pipes.  At
// the blocked host's 500 x 10,000 that is ~0.011 ms against 0.006 ms for
// the 20 MB written: these are operation-bound.  On the H100 a blocked
// hill step's tf_rows launch takes ~1.9x that bound and the 10^6-uniform
// draw ~2x (PERF.md, section 6).  The key comes in as two kernel
// arguments, so nothing is copied to the card and nothing synchronizes.
//
// Plain C interface, loaded with ctypes; the launch goes on the caller's
// stream and the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TF_THREADS = 256;
constexpr int TF_MAX_ROWS = TF_THREADS / 4;  // tr at the narrowest tile, tx = 4

// what tf_bits writes (the wrapper's kind codes)
constexpr int TF_BITS = 0, TF_WIDE = 1, TF_UNIFORM = 2, TF_NORMAL = 3;

// a key's schedule: the word added to x0 and to x1 at each of the six
// injections (the parity word k0 ^ k1 ^ C and the counter sums k + i, once
// a key)
struct TfKey {
  uint32_t a0, a1, a2;
  uint32_t b0, b1, b2, b3, b4, b5;
};

__device__ __forceinline__ TfKey tf_key(uint32_t k0, uint32_t k1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  return {k0, k1, k2, k1, k2 + 1u, k0 + 2u, k1 + 3u, k2 + 4u, k0 + 5u};
}

// a rotation: one SHF
__device__ __forceinline__ uint32_t tf_rotl(uint32_t v, int r) {
  return __funnelshift_l(v, v, r);
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

// the 20-round block function: (x0, x1) hashed in place under the key
__device__ __forceinline__ void tf_block(const TfKey& K, uint32_t& x0, uint32_t& x1) {
  x0 += K.a0;
  x1 += K.b0;
  TF_ROUNDS(13, 15, 26, 6)
  x0 += K.a1;
  x1 += K.b1;
  TF_ROUNDS(17, 29, 16, 24)
  x0 += K.a2;
  x1 += K.b2;
  TF_ROUNDS(13, 15, 26, 6)
  x0 += K.a0;
  x1 += K.b3;
  TF_ROUNDS(17, 29, 16, 24)
  x0 += K.a1;
  x1 += K.b4;
  TF_ROUNDS(13, 15, 26, 6)
  x0 += K.a2;
  x1 += K.b5;
}

#undef TF_ROUNDS

// the mantissa trick on a block's words
__device__ __forceinline__ float tf_uniform(uint32_t x0, uint32_t x1, float) {
  return __int_as_float((int)(((x0 ^ x1) >> 9) | 0x3F800000u)) - 1.0f;
}

__device__ __forceinline__ double tf_uniform(uint32_t x0, uint32_t x1, double) {
  const unsigned long long w = ((unsigned long long)x0 << 32) | x1;
  return __longlong_as_double((long long)((w >> 12) | 0x3FF0000000000000ull)) - 1.0;
}

__device__ __forceinline__ float tf_erfinv(float u) { return erfinvf(u); }
__device__ __forceinline__ double tf_erfinv(double u) { return erfinv(u); }

template <int KIND, typename T>
struct DrawOut {
  using type = T;
};
template <typename T>
struct DrawOut<TF_BITS, T> {
  using type = uint32_t;
};
template <typename T>
struct DrawOut<TF_WIDE, T> {
  using type = uint2;
};

// element i of the draw
template <int KIND, typename T>
__device__ __forceinline__ typename DrawOut<KIND, T>::type tf_value(const TfKey& K, long long i,
                                                                    T lo, T span, T s2) {
  uint32_t x0 = (uint32_t)((unsigned long long)i >> 32), x1 = (uint32_t)i;
  tf_block(K, x0, x1);
  if constexpr (KIND == TF_BITS) {
    return x0 ^ x1;
  } else if constexpr (KIND == TF_WIDE) {
    return make_uint2(x0, x1);
  } else {
    const T f = tf_uniform(x0, x1, T());
    if constexpr (KIND == TF_UNIFORM) {
      return f;
    } else {
      const T p = f * span;  // exact: span rounds to 2 in both types
      const T v = p + lo;
      return s2 * tf_erfinv(v > lo ? v : lo);
    }
  }
}

// VEC elements of O make 16 bytes (or VEC = 1)
template <int KIND, typename T, int VEC>
__global__ void __launch_bounds__(TF_THREADS)
tf_bits(uint32_t k0, uint32_t k1, long long n, T lo, T span, T s2,
        typename DrawOut<KIND, T>::type* __restrict__ out) {
  using O = typename DrawOut<KIND, T>::type;
  const long long i0 = ((long long)blockIdx.x * TF_THREADS + threadIdx.x) * VEC;
  if (i0 >= n) return;
  const TfKey K = tf_key(k0, k1);
  if constexpr (VEC > 1) {
    if (i0 + VEC <= n) {
      alignas(16) O v[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = tf_value<KIND, T>(K, i0 + e, lo, span, s2);
      *reinterpret_cast<uint4*>(out + i0) = *reinterpret_cast<const uint4*>(v);
      return;
    }
  }
  for (long long i = i0; i < n && i < i0 + VEC; ++i) out[i] = tf_value<KIND, T>(K, i, lo, span, s2);
}

// the uniform of column j of a row under its key
template <typename T>
__device__ __forceinline__ T tf_col(const TfKey& K, int j) {
  uint32_t x0 = 0u, x1 = (uint32_t)j;
  tf_block(K, x0, x1);
  return tf_uniform(x0, x1, T());
}

// block (tx, tr); grid (slot tiles, row tiles)
template <typename Id, typename T>
__global__ void __launch_bounds__(TF_THREADS)
tf_rows(uint32_t k0, uint32_t k1, const Id* __restrict__ rows, long long R, int n,
        T* __restrict__ out) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ uint2 row_key[TF_MAX_ROWS];
  const int tr = blockDim.y;
  const int t = threadIdx.y * blockDim.x + threadIdx.x;
  const int s = blockIdx.x * blockDim.x + threadIdx.x;  // this thread's slot of its row
  const TfKey K = tf_key(k0, k1);
  for (long long r0 = (long long)blockIdx.y * tr; r0 < R; r0 += (long long)gridDim.y * tr) {
    if (t < tr && r0 + t < R) {
      uint32_t a = 0u, b = (uint32_t)rows[r0 + t];
      tf_block(K, a, b);  // fold_in(key, rows[r])
      row_key[t] = make_uint2(a, b);
    }
    __syncthreads();
    const long long r = r0 + threadIdx.y;
    const long long o = r * n;
    int h = (int)((VEC - (o & (VEC - 1))) & (VEC - 1));  // columns before the first boundary
    h = h < n ? h : n;
    const int nb = (n - h) / VEC;
    if (r < R && s <= nb + 1) {
      const uint2 rk = row_key[threadIdx.y];
      const TfKey RK = tf_key(rk.x, rk.y);
      T* row = out + o;
      if (s == 0) {
        for (int j = 0; j < h; ++j) row[j] = tf_col<T>(RK, j);
      } else if (s <= nb) {
        const int j0 = h + (s - 1) * VEC;
        alignas(16) T v[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[e] = tf_col<T>(RK, j0 + e);
        *reinterpret_cast<uint4*>(row + j0) = *reinterpret_cast<const uint4*>(v);
      } else {
        for (int j = h + nb * VEC; j < n; ++j) row[j] = tf_col<T>(RK, j);
      }
    }
    __syncthreads();  // row_key is rewritten by the next row tile
  }
}

template <int KIND, typename T>
cudaError_t draw_typed(uint32_t k0, uint32_t k1, long long n, double lo, double span, double s2,
                       long long blocks, int vec, void* out, cudaStream_t st) {
  using O = typename DrawOut<KIND, T>::type;
  O* o = static_cast<O*>(out);
  const unsigned g = (unsigned)blocks;
  if (vec == 1) {
    tf_bits<KIND, T, 1><<<g, TF_THREADS, 0, st>>>(k0, k1, n, (T)lo, (T)span, (T)s2, o);
  } else if (vec * sizeof(O) == 16) {
    constexpr int V = 16 / sizeof(O);
    tf_bits<KIND, T, V><<<g, TF_THREADS, 0, st>>>(k0, k1, n, (T)lo, (T)span, (T)s2, o);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// kind: 0 the bits' xor (n uint32), 1 both words (2n uint32), 2 uniforms, 3
// normals (n float32, or float64 with f64 = 1); lo, span, s2 the normal's
// constants rounded to the type; blocks and vec from ops/prng.draw_plan
int threefry_bits_launch(unsigned k0, unsigned k1, long long n, int kind, int f64, double lo,
                         double span, double s2, long long blocks, int vec, void* out,
                         void* stream) {
  if (n < 0 || vec < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  if (blocks < 1 || blocks > 0x7fffffffLL || blocks * TF_THREADS * vec < n
      || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  switch (kind) {
    case TF_BITS: e = draw_typed<TF_BITS, float>(k0, k1, n, 0, 0, 0, blocks, vec, out, st); break;
    case TF_WIDE: e = draw_typed<TF_WIDE, float>(k0, k1, n, 0, 0, 0, blocks, vec, out, st); break;
    case TF_UNIFORM:
      e = f64 ? draw_typed<TF_UNIFORM, double>(k0, k1, n, 0, 0, 0, blocks, vec, out, st)
              : draw_typed<TF_UNIFORM, float>(k0, k1, n, 0, 0, 0, blocks, vec, out, st);
      break;
    case TF_NORMAL:
      e = f64 ? draw_typed<TF_NORMAL, double>(k0, k1, n, lo, span, s2, blocks, vec, out, st)
              : draw_typed<TF_NORMAL, float>(k0, k1, n, lo, span, s2, blocks, vec, out, st);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// rows: R row ids on the card, int64 (ids64 = 1) or int32; out: R x n
// float32 (f64 = 0) or float64 (f64 = 1), 16-byte aligned; the grid
// (gx, gy) and block (tx, tr) from ops/prng.rows_plan
int threefry_rows_launch(unsigned k0, unsigned k1, const void* rows, int ids64, long long R, int n,
                         int f64, unsigned gx, unsigned gy, int tx, int tr, void* out,
                         void* stream) {
  if (R < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (R == 0 || n == 0) return (int)cudaSuccess;
  const long long slots = n / (f64 ? 2 : 4) + 2;
  if (tx < 1 || tr < 1 || tx * tr != TF_THREADS || tr > TF_MAX_ROWS || gy < 1 || gy > 65535
      || (long long)gx * tx < slots || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(gx, gy), block((unsigned)tx, (unsigned)tr);
  const cudaStream_t st = (cudaStream_t)stream;
  if (f64) {
    if (ids64)
      tf_rows<long long, double><<<grid, block, 0, st>>>(
          k0, k1, static_cast<const long long*>(rows), R, n, static_cast<double*>(out));
    else
      tf_rows<int, double><<<grid, block, 0, st>>>(
          k0, k1, static_cast<const int*>(rows), R, n, static_cast<double*>(out));
  } else {
    if (ids64)
      tf_rows<long long, float><<<grid, block, 0, st>>>(
          k0, k1, static_cast<const long long*>(rows), R, n, static_cast<float*>(out));
    else
      tf_rows<int, float><<<grid, block, 0, st>>>(
          k0, k1, static_cast<const int*>(rows), R, n, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
