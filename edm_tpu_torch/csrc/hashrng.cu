// The counter hash and pass 1 of the cell host's hill collections, for
// Hopper (sm_90a).
//
// The JAX hosts draw their hill-acceptance uniforms and the cell host's
// thermostat normals from a murmur3-finalizer counter hash
// (edm_tpu/ops/hashrng.py:53-68, uniform_rows_cols; :33-50,
// normal_rows_cols): draw (row, col) of a round is a hash of its two uint32
// seeds, the row and the column, in uint32 arithmetic.  XLA compiles it,
// and pass 1 of the hill collections that consumes it
// (edm_tpu/models/pair_edm_cells.py:1866-1900, p1_chunk of
// collect_hills_half; :2061-2090, the typed collect_hills), into one fused
// pass per chunk: no draw is written to memory.  None of the three kernels
// here is the counterpart of a Pallas kernel; their plain versions are
// ops/hashrng.py's int64 emulation of the hash (uniform_rows_cols_ref,
// normal_rows_cols_ref) and ops/collect.py's chunked pass 1
// (p1_counts_half_ref, p1_counts_typed_ref), on the same card.
//
// hash_rows (the kernels hash_uniforms and hash_normals): (R,) int64 row
// ids -> (R, n) draws, one thread per output element.  Uniforms are
// float(h) * 2^-32 (h rounded to the type, then an exact power-of-two
// scale).  Normals are Box-Muller over two column
// halves, as normal_rows_cols computes them: u1 the uniform of column j
// plus 2^-33, u2 that of column n + j, sqrt(-2 log u1) cos(2 pi u2), with
// the constants rounded to the type as PyTorch rounds a Python scalar and
// the libm calls (logf/sqrtf/cosf or log/sqrt/cos) that PyTorch's CUDA
// elementwise kernels make, without fast math.
//
// p1_count_half: pass 1 of the half-stencil collection.  One block per row
// cell of the candidate planes that ops/collect.py builds (_half_concat:
// (B, W = 14 cap), the cell's own slots first); a warp per slot row, its
// lanes over the W candidates.  A candidate is counted when both slots are
// occupied, it lies above the diagonal of the self block (w >= cap or
// w > r), and its minimum-image r^2 is below bmax^2; each such pair draws
// columns 2w and 2w + 1 of the row's global id and counts those below the
// threshold (every one when there is none).  Outputs: the per-row count
// and ncalls = 2 x the pairs, added once per block with an integer atomic
// (integers: the order of the sum changes nothing).
//
// p1_count_typed: pass 1 of the typed 27-stencil collection.  One block per
// cell, a warp per slot row, lanes over the 27 cap ordered candidates of
// stencil_neighbors: both atoms real (aid < n) and distinct, the type pair
// {t0, t1} as floats, r^2 below bmax^2, one draw (column w) per candidate;
// ncalls counts the candidates.
//
// Rounding.  r^2 is the plain version's, operation for operation: d =
// row - candidate, d - rint(d / L) * L with IEEE division (as
// torch.round(dd / box[c]) * box[c]), ((dx^2 + dy^2) + dz^2), and the
// library is built with -fmad=false, so no product is contracted into an
// add.  The comparisons take place in the planes' type: bmax^2 comes in as
// a double and is rounded to it, as PyTorch rounds the Python scalar, and
// the threshold is read from its device scalar (no host read).
//
// What bounds them.  hash_rows writes 4 or 8 bytes an element for ~12
// integer operations a hash (two for a normal, plus the three libm calls):
// at the thermostat's shapes (23,552 or 219,648 rows x 3) a launch's fixed
// cost is most of its time (1.8 and 5.0 us on an H100, chip_smoke.py).
// Pass 1 at the 100k cell reads ~13 bytes a candidate column of its planes
// (each column read again by the cell's 32 rows, from L1), computes r^2
// for the pairs of occupied slots (~2e7 at its occupancy; three IEEE
// divisions each) and hashes only the ~5.4e6 draws of the pairs within
// bmax; its bound is the bytes, 0.013 ms, and it takes 0.31 ms.  Nothing
// but the candidates' planes leaves registers; tiles of them in shared
// memory, which the rows of a cell would share, are a later step.
//
// Plain C interface, loaded with ctypes; the launches go on the caller's
// stream and each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HASH_THREADS = 256;
constexpr int P1_THREADS = 256;
constexpr int P1_WARPS = P1_THREADS / 32;
constexpr int STENCIL = 27;

__device__ __forceinline__ uint32_t counter_hash(uint32_t s0, uint32_t s1, uint32_t row,
                                                 uint32_t col) {
  uint32_t h = s0 + row * 0x9E3779B9u + col * 0x85EBCA6Bu;
  h ^= s1;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// float(h) * 2^-32: h rounded to the nearest value of the type, then exact
__device__ __forceinline__ void hash_uniform(uint32_t h, float& u) {
  u = __uint2float_rn(h) * 2.3283064365386963e-10f;
}
__device__ __forceinline__ void hash_uniform(uint32_t h, double& u) {
  u = __uint2double_rn(h) * 2.3283064365386963e-10;
}

template <typename T>
__device__ __forceinline__ T uniform_at(uint32_t s0, uint32_t s1, uint32_t row, uint32_t col) {
  T u;
  hash_uniform(counter_hash(s0, s1, row, col), u);
  return u;
}

// Box-Muller as normal_rows_cols: the scalars rounded to the type
__device__ __forceinline__ float box_muller(float u1, float u2) {
  const float r = sqrtf(-2.0f * logf(u1 + 1.16415321826934814453125e-10f));
  return r * cosf(static_cast<float>(2.0 * 3.14159265358979323846) * u2);
}
__device__ __forceinline__ double box_muller(double u1, double u2) {
  const double r = sqrt(-2.0 * log(u1 + 1.16415321826934814453125e-10));
  return r * cos((2.0 * 3.14159265358979323846) * u2);
}

__device__ __forceinline__ float round_even(float q) { return rintf(q); }
__device__ __forceinline__ double round_even(double q) { return rint(q); }

// the minimum image of d along a box edge L, squared
template <typename T>
__device__ __forceinline__ T image_sq(T d, T L) {
  const T w = d - round_even(d / L) * L;
  return w * w;
}

// draw i of the (R, n) output: its row rows[i / n] (mod 2^32), column i % n
template <typename T, bool NORMAL>
__device__ __forceinline__ void hash_rows(uint32_t s0, uint32_t s1,
                                          const long long* __restrict__ rows, long long total,
                                          int n, T* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * HASH_THREADS + threadIdx.x; i < total;
       i += (long long)gridDim.x * HASH_THREADS) {
    const long long r = i / n;
    const uint32_t j = (uint32_t)(i - r * n);
    const uint32_t row = (uint32_t)rows[r];  // mod 2^32, as rows.astype(uint32)
    if (NORMAL) {
      out[i] = box_muller(uniform_at<T>(s0, s1, row, j), uniform_at<T>(s0, s1, row, n + j));
    } else {
      out[i] = uniform_at<T>(s0, s1, row, j);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(HASH_THREADS)
hash_uniforms(uint32_t s0, uint32_t s1, const long long* __restrict__ rows, long long total,
              int n, T* __restrict__ out) {
  hash_rows<T, false>(s0, s1, rows, total, n, out);
}

template <typename T>
__global__ void __launch_bounds__(HASH_THREADS)
hash_normals(uint32_t s0, uint32_t s1, const long long* __restrict__ rows, long long total,
             int n, T* __restrict__ out) {
  hash_rows<T, true>(s0, s1, rows, total, n, out);
}

// a block's integer sum into *total (thread 0 adds it)
__device__ __forceinline__ void block_add(unsigned int v, unsigned long long scale,
                                          unsigned long long* total) {
  __shared__ unsigned int part[P1_WARPS];
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long s = 0;
    for (int w = 0; w < P1_WARPS; ++w) s += part[w];
    if (s) atomicAdd(total, scale * s);
  }
}

template <typename T>
__global__ void __launch_bounds__(P1_THREADS)
p1_count_half(const T* __restrict__ cx, const T* __restrict__ cy, const T* __restrict__ cz,
              const uint8_t* __restrict__ cm, const long long* __restrict__ gids,
              const T* __restrict__ box, T bmax2, const T* __restrict__ thresh, uint32_t s0,
              uint32_t s1, int cap, int W, long long* __restrict__ row_counts,
              unsigned long long* __restrict__ ncalls) {
  const long long base = (long long)blockIdx.x * W;
  const T Lx = box[0], Ly = box[1], Lz = box[2];
  const bool all = thresh == nullptr;
  const T th = all ? T(0) : *thresh;
  const int lane = threadIdx.x & 31;
  unsigned int n_ok = 0;
  for (int r = threadIdx.x >> 5; r < cap; r += P1_WARPS) {
    unsigned int cnt = 0;
    if (cm[base + r]) {
      const T xr = cx[base + r], yr = cy[base + r], zr = cz[base + r];
      const uint32_t row = (uint32_t)gids[(long long)blockIdx.x * cap + r];
      for (int w = lane; w < W; w += 32) {
        if (!cm[base + w] || (w < cap && w <= r)) continue;
        const T r2 = (image_sq(xr - cx[base + w], Lx) + image_sq(yr - cy[base + w], Ly)) +
                     image_sq(zr - cz[base + w], Lz);
        if (!(r2 < bmax2)) continue;
        ++n_ok;
        if (all) {
          cnt += 2;
        } else {
          cnt += uniform_at<T>(s0, s1, row, 2 * w) < th;
          cnt += uniform_at<T>(s0, s1, row, 2 * w + 1) < th;
        }
      }
    }
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if (lane == 0) row_counts[(long long)blockIdx.x * cap + r] = cnt;
  }
  block_add(n_ok, 2ull, ncalls);
}

template <typename T>
__global__ void __launch_bounds__(P1_THREADS)
p1_count_typed(const T* __restrict__ xs, const long long* __restrict__ aid,
               const T* __restrict__ ts, const long long* __restrict__ nbr,
               const T* __restrict__ box, T bmax2, const T* __restrict__ thresh, T t0, T t1,
               long long n_atoms, uint32_t s0, uint32_t s1, int cap,
               long long* __restrict__ row_counts, unsigned long long* __restrict__ ncalls) {
  __shared__ long long cells[STENCIL];
  if (threadIdx.x < STENCIL) {
    cells[threadIdx.x] = nbr[(long long)blockIdx.x * STENCIL + threadIdx.x];
  }
  __syncthreads();
  const T Lx = box[0], Ly = box[1], Lz = box[2];
  const bool all = thresh == nullptr;
  const T th = all ? T(0) : *thresh;
  const int lane = threadIdx.x & 31;
  const int W = STENCIL * cap;
  unsigned int n_ok = 0;
  for (int r = threadIdx.x >> 5; r < cap; r += P1_WARPS) {
    const long long slot = (long long)blockIdx.x * cap + r;
    const long long ai = aid[slot];
    unsigned int cnt = 0;
    if (ai < n_atoms) {
      const T xr = xs[3 * slot], yr = xs[3 * slot + 1], zr = xs[3 * slot + 2];
      const T ti = ts[slot];
      for (int w = lane; w < W; w += 32) {
        const int j = w / cap;
        const long long sw = cells[j] * cap + (w - j * cap);
        const long long aw = aid[sw];
        if (!(aw < n_atoms) || aw == ai) continue;
        const T tw = ts[sw];
        if (!((ti == t0 && tw == t1) || (ti == t1 && tw == t0))) continue;
        const T r2 = (image_sq(xr - xs[3 * sw], Lx) + image_sq(yr - xs[3 * sw + 1], Ly)) +
                     image_sq(zr - xs[3 * sw + 2], Lz);
        if (!(r2 < bmax2)) continue;
        ++n_ok;
        cnt += all ? 1u : (unsigned int)(uniform_at<T>(s0, s1, (uint32_t)slot, w) < th);
      }
    }
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if (lane == 0) row_counts[slot] = cnt;
  }
  block_add(n_ok, 1ull, ncalls);
}

int grid_of(long long total) {
  const long long blocks = (total + HASH_THREADS - 1) / HASH_THREADS;
  return (int)(blocks < 132LL * 64 ? blocks : 132LL * 64);  // grid-stride beyond
}

}  // namespace

extern "C" {

// rows: R int64 row ids on the card; out: R x n float32 (f64 = 0) or
// float64 (f64 = 1), uniforms (normal = 0) or normals (normal = 1)
int hash_rows_launch(unsigned s0, unsigned s1, const void* rows, long long R, int n, int normal,
                     int f64, void* out, void* stream) {
  if (R < 0 || n < 0) return (int)cudaErrorInvalidValue;
  const long long total = R * n;
  if (total == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long* r = static_cast<const long long*>(rows);
  const int g = grid_of(total);
  if (f64) {
    double* o = static_cast<double*>(out);
    if (normal) hash_normals<double><<<g, HASH_THREADS, 0, st>>>(s0, s1, r, total, n, o);
    else hash_uniforms<double><<<g, HASH_THREADS, 0, st>>>(s0, s1, r, total, n, o);
  } else {
    float* o = static_cast<float*>(out);
    if (normal) hash_normals<float><<<g, HASH_THREADS, 0, st>>>(s0, s1, r, total, n, o);
    else hash_uniforms<float><<<g, HASH_THREADS, 0, st>>>(s0, s1, r, total, n, o);
  }
  return (int)cudaGetLastError();
}

// cx, cy, cz: (B, W) planes of the type; cm (B, W) uint8 masks; gids (B cap)
// int64; box (3,) of the type; thresh a device scalar of the type or null;
// row_counts (B cap) int64; ncalls one int64, zeroed here
int p1_count_half_launch(const void* cx, const void* cy, const void* cz, const void* cm,
                         const void* gids, const void* box, double bmax2, const void* thresh,
                         unsigned s0, unsigned s1, int B, int cap, int W, int f64,
                         void* row_counts, void* ncalls, void* stream) {
  if (B < 0 || cap < 1 || W < cap) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(ncalls, 0, sizeof(long long), st);
  if (e != cudaSuccess || B == 0) return (int)e;
  const uint8_t* m = static_cast<const uint8_t*>(cm);
  const long long* g = static_cast<const long long*>(gids);
  long long* rc = static_cast<long long*>(row_counts);
  unsigned long long* nc = static_cast<unsigned long long*>(ncalls);
  if (f64) {
    p1_count_half<double><<<B, P1_THREADS, 0, st>>>(
        static_cast<const double*>(cx), static_cast<const double*>(cy),
        static_cast<const double*>(cz), m, g, static_cast<const double*>(box), bmax2,
        static_cast<const double*>(thresh), s0, s1, cap, W, rc, nc);
  } else {
    p1_count_half<float><<<B, P1_THREADS, 0, st>>>(
        static_cast<const float*>(cx), static_cast<const float*>(cy),
        static_cast<const float*>(cz), m, g, static_cast<const float*>(box), (float)bmax2,
        static_cast<const float*>(thresh), s0, s1, cap, W, rc, nc);
  }
  return (int)cudaGetLastError();
}

// xs (Cg, cap, 3) and ts (Cg, cap) of the type; aid (Cg cap) int64; nbr
// (C, 27) int64 stencil_neighbors; box, thresh as above; (t0, t1) the type
// pair; row_counts (C cap) int64; ncalls one int64, zeroed here
int p1_count_typed_launch(const void* xs, const void* aid, const void* ts, const void* nbr,
                          const void* box, double bmax2, const void* thresh, double t0, double t1,
                          long long n_atoms, unsigned s0, unsigned s1, int C, int cap, int f64,
                          void* row_counts, void* ncalls, void* stream) {
  if (C < 0 || cap < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(ncalls, 0, sizeof(long long), st);
  if (e != cudaSuccess || C == 0) return (int)e;
  const long long* a = static_cast<const long long*>(aid);
  const long long* nb = static_cast<const long long*>(nbr);
  long long* rc = static_cast<long long*>(row_counts);
  unsigned long long* nc = static_cast<unsigned long long*>(ncalls);
  if (f64) {
    p1_count_typed<double><<<C, P1_THREADS, 0, st>>>(
        static_cast<const double*>(xs), a, static_cast<const double*>(ts), nb,
        static_cast<const double*>(box), bmax2, static_cast<const double*>(thresh), t0, t1,
        n_atoms, s0, s1, cap, rc, nc);
  } else {
    p1_count_typed<float><<<C, P1_THREADS, 0, st>>>(
        static_cast<const float*>(xs), a, static_cast<const float*>(ts), nb,
        static_cast<const float*>(box), (float)bmax2, static_cast<const float*>(thresh),
        (float)t0, (float)t1, n_atoms, s0, s1, cap, rc, nc);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
