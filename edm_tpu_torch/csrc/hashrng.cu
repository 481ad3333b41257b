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
// ids -> (R, n) draws.  Uniforms are float(h) * 2^-32 (h rounded to the
// type, then an exact power-of-two scale).  Normals are Box-Muller over two
// column halves, as normal_rows_cols computes them: u1 the uniform of
// column j plus 2^-33, u2 that of column n + j, sqrt(-2 log u1) cos(2 pi
// u2), with the constants rounded to the type as PyTorch rounds a Python
// scalar and the libm calls (logf/sqrtf/cosf or log/sqrt/cos) that
// PyTorch's CUDA elementwise kernels make, without fast math.
//
// p1_count_half: pass 1 of the half-stencil collection, over a list of row
// cells (global ids: every cell, or a rank's owned box) of the slot
// lattice itself.  A candidate of a slot row is column w of its cell's 14
// cap candidates (the cell's own slots first, then its 13 HALF_OFFSETS
// neighbours', as ops/collect.half_planes orders them).  It counts when
// both slots are occupied, it lies above the diagonal of the self block
// (w >= cap or w > r), and its minimum-image r^2 is below bmax^2; each such
// pair draws columns 2w and 2w + 1 of the row's global id (cell cap + r)
// and counts those below the threshold (every one when there is none).
// Outputs: the per-row count and ncalls = 2 x the pairs.
//
// p1_count_typed: pass 1 of the typed 27-stencil collection, one block a
// cell: each ordered candidate of the 27 cap of stencil_neighbors with both
// atoms real (aid < n) and distinct, the type pair {t0, t1} (as floats) and
// r^2 below bmax^2 draws one uniform (column w); ncalls counts them.
//
// The design of hash_rows.  The hash of (row, col) is fin(s0 + row GOLD +
// col MUR1) in uint32 arithmetic, so the row term s0 + row GOLD is
// computed from the int64 id narrowed once, and the column term advances
// by MUR1 from one column to the next: no element pays a 64-bit division
// or a grid-stride loop (only a tile's base is 64-bit; the grid covers the
// tiles in one pass).  Three launch shapes, by n and R:
// - WIDE_ROWS (n > HASH_NARROW_MAX: pass 2's 2 x 14 cap = 896 or 27 cap =
//   864, a pass-1-width chunk): a warp a row, 8 rows a block.  The lanes
//   run along the columns, each writing VEC consecutive columns (4 floats,
//   2 doubles) with one 16-byte store; the columns before the row's first
//   16-byte boundary and those after its last take scalar stores, so any n
//   and any row's alignment work.
// - NARROW_ROWS (n <= 16, R >= 2^16: the 100k thermostat's 219,648 x 3): a
//   thread a row computes its n values into shared memory (n = 3 unrolled,
//   each Box-Muller stage over the three at once, so their libm chains
//   overlap), and the block's 128 n outputs, contiguous in the output, go
//   out with 16-byte stores (scalar ones for the tail).
// - BY_ELEMENT (n <= 16, R < 2^16: the 10k thermostat's 23,552 x 3): a
//   thread an element, its row i / n by a 32-bit multiply with the
//   launcher's multiplier, 128 / n whole rows a block, coalesced scalar
//   stores.  Below ~500 rows an SM a thread a row leaves too few threads to
//   hide the libm calls' latency: on the H100 it took 0.0022 ms a launch at
//   10k against 0.0018 by element, while by element took 0.0055 at 100k
//   against 0.0044 a row (PERF.md, section 6).
// A normal needs the uniforms of columns j and n + j: both come from the
// row term, the second's column term the first's plus n MUR1.  cosf (cos)
// is kept although its argument 2 pi u2 lies in [0, 2 pi), where its
// Payne-Hanek branch is never taken: it is what the plain version calls,
// and a reduction of our own could round differently.
//
// The design of pass 1 (both kernels).  A block a row cell (128 threads;
// typed 256) stages its 14 (27) candidate cells' slot blocks, each
// contiguous in the lattice (xyz and the mask; typed: xyz, aid and type),
// into shared memory with cp.async, in pieces: the launcher's plan
// (p1_plan) gives each piece as many whole cells as fit beside the rows,
// their counts and the hit queues (one piece, all 14 / 27 cells, up to cap
// 476 / 258 in float32 / float64 for the half kernel, 205 / 121 typed).
// Where not one whole cell fits beside all the rows, the rows are tiled
// too (rt at a time, the tile at most a quarter of the budget), and where
// not one fits beside a row tile, a piece is a run of ps slots of one cell
// (ps a multiple of 4): every cap the plain version takes has a plan.  For
// each row tile, the own cell's rows are compacted straight from the
// lattice (while the first piece's copies are in flight); a plan of one
// piece and one tile (every cap up to the limits above, the bench's 32
// included) runs the kernels' PIECES = false form instead, whose loops
// compile away and whose rows come from the staged own cell: the work of
// a kernel without pieces (the pieces' loop cost 19% at the 100k cell in a
// first version, PERF.md, section 6).  For each piece
// the block stages, compacts the candidates that can count into
// structure-of-arrays lists (x, y, z, column w), a warp a cell, a ballot
// and one shared atomic per 32 slots (the occupied slots; typed: the real
// slots of type t0 and of type t1, and the own cell's real rows of each
// type), and sweeps.  The sweep gives each thread one candidate and walks
// the rows, read as one broadcast struct a row, so no lane waits on an
// empty slot or a row of neither type (typed: rows of t0 against
// candidates of t1 and the reverse; one list when t0 == t1).  The test of
// a pair has no branch; a pair within bmax goes to its warp's queue (a
// ballot and a prefix count), and the queue is hashed 32 pairs at a time,
// so the hash never waits on the lanes whose pair missed (with no
// threshold, a warp sum a row instead).  Row counts are integer
// shared-memory adds, summed over the pieces, and ncalls one integer atomic
// a block: integers, so the order of the pieces, of the sums and of the
// lists changes nothing.
//
// Rounding.  r^2 is the plain version's, operation for operation: d =
// row - candidate, d - rint(d / L) * L with IEEE division (as
// torch.round(dd / box[c]) * box[c]), ((dx^2 + dy^2) + dz^2), and the
// library is built with -fmad=false, so no product is contracted into an
// add.  Where |d| <= L / 4 (L * 0.25 is exact) rint(d / L) is +-0 and the
// image is d itself, so the division is skipped: the same value.  A warp
// whose candidates are all within L / 4 of its rows' coordinate range on
// every axis (the rounded difference is monotone, so the range's two ends
// bound every row's) runs a loop with no minimum-image code at all.  The
// comparisons take place in the lattice's type: bmax^2 comes in as a
// double and is rounded to it, as PyTorch rounds the Python scalar, and
// the threshold is read from its device scalar (no host read).
//
// What bounds them.  hash_rows must write 4 or 8 bytes an element (and
// read 8 a row) for ~12 integer operations a hash (two for a normal, plus
// the three libm calls): by the count, bytes bind at every shape the main
// path gives it (pass 2's 2,048 x 896 uniforms, 7.3 MB, 2.2 us at 3.35
// TB/s).  The uniforms' design leaves each element one hash, its
// conversion and its share of a 16-byte store (3.1 us on the H100).  A
// normal's libm calls take ~150 instructions, which set the 100k
// thermostat's 219,648 x 3 normals (4.4 us, ~3 of them to issue); at the
// 10k thermostat's 23,552 x 3 a launch's fixed cost and one normal's
// latency are most of its 1.8 us.  Pass 1 must read the
// lattice once (16 bytes a slot; typed 24), the neighbour table and the
// cell list and write the row counts: 6 MB at the 100k cell, 1.8 us at
// 3.35 TB/s.  Its operations bind: ~12 a pair of occupied slots (~2e7 pairs
// at 100k), 4 more a component across a periodic face, and a hash for each
// of the ~5.6e6 draws of the pairs within bmax (~0.006 ms at 100k).  The
// kernels stay several times above that: the staging reads each cell's
// block once a neighbouring row cell (14 or 27 times, from L2; at caps
// past one piece, once a row tile and piece), and the sweep spends ~30
// instructions a (row, candidate) step on ~12 of arithmetic (PERF.md,
// section 6).
//
// Plain C interface, loaded with ctypes; the launches go on the caller's
// stream and each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <numeric>

namespace {

constexpr int HASH_WIDE_THREADS = 256;  // 8 warps, a row each
constexpr int HASH_NARROW_ROWS = 128;   // narrow rows: a block of 128 threads
constexpr int HASH_NARROW_MAX = 16;     // the widest row a thread computes alone
// narrow rows take a thread a row from this many rows on (~500 threads an
// SM), a thread an element below it
constexpr long long HASH_ROWWISE_MIN = 1 << 16;
// hash_rows' launch shapes (see the header)
enum HashShape { BY_ELEMENT, WIDE_ROWS, NARROW_ROWS };
constexpr int P1_HALF_THREADS = 128;
constexpr int P1_TYPED_THREADS = 256;
constexpr int HALF_CELLS = 14;    // the cell and its 13 HALF_OFFSETS neighbours
constexpr int STENCIL = 27;
constexpr int STENCIL_SELF = 13;  // the (0, 0, 0) column of stencil_neighbors
// a block's shared memory on sm_90 (232,448 bytes), less 1 KB for the
// kernels' static arrays: what a pass-1 plan may take dynamically
constexpr long long P1_SMEM_BUDGET = 232448 - 1024;

constexpr uint32_t GOLD = 0x9E3779B9u, MUR1 = 0x85EBCA6Bu, MUR2 = 0xC2B2AE35u;

// the finalizer of the counter hash, on t = s0 + row GOLD + col MUR1
__device__ __forceinline__ uint32_t hash_fin(uint32_t t, uint32_t s1) {
  uint32_t h = t ^ s1;
  h ^= h >> 16;
  h *= MUR1;
  h ^= h >> 13;
  h *= MUR2;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t counter_hash(uint32_t s0, uint32_t s1, uint32_t row,
                                                 uint32_t col) {
  return hash_fin(s0 + row * GOLD + col * MUR1, s1);
}

// float(h) * 2^-32: h rounded to the nearest value of the type, then exact
__device__ __forceinline__ void hash_uniform(uint32_t h, float& u) {
  u = __uint2float_rn(h) * 2.3283064365386963e-10f;
}
__device__ __forceinline__ void hash_uniform(uint32_t h, double& u) {
  u = __uint2double_rn(h) * 2.3283064365386963e-10;
}

template <typename T>
__device__ __forceinline__ T uniform_of(uint32_t t, uint32_t s1) {
  T u;
  hash_uniform(hash_fin(t, s1), u);
  return u;
}

template <typename T>
__device__ __forceinline__ T uniform_at(uint32_t s0, uint32_t s1, uint32_t row, uint32_t col) {
  T u;
  hash_uniform(counter_hash(s0, s1, row, col), u);
  return u;
}

// Box-Muller as normal_rows_cols, r(u1) cos(2 pi u2): the scalars rounded
// to the type
__device__ __forceinline__ float bm_radius(float u1) {
  return sqrtf(-2.0f * logf(u1 + 1.16415321826934814453125e-10f));
}
__device__ __forceinline__ double bm_radius(double u1) {
  return sqrt(-2.0 * log(u1 + 1.16415321826934814453125e-10));
}
__device__ __forceinline__ float bm_cos(float u2) {
  return cosf(static_cast<float>(2.0 * 3.14159265358979323846) * u2);
}
__device__ __forceinline__ double bm_cos(double u2) {
  return cos((2.0 * 3.14159265358979323846) * u2);
}
template <typename T>
__device__ __forceinline__ T box_muller(T u1, T u2) {
  return bm_radius(u1) * bm_cos(u2);
}

// the draw whose hash argument is t = (the row term) + (the column term):
// its uniform, or the normal of it and of the column n to its right (nm =
// n MUR1 further on)
template <typename T, bool NORMAL>
__device__ __forceinline__ T draw_at(uint32_t t, uint32_t nm, uint32_t s1) {
  if constexpr (NORMAL) return box_muller(uniform_of<T>(t, s1), uniform_of<T>(t + nm, s1));
  return uniform_of<T>(t, s1);
}

// 16 bytes of the type
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using V = float4;
  static constexpr int N = 4;
  __device__ __forceinline__ static V make(const float* x) {
    return make_float4(x[0], x[1], x[2], x[3]);
  }
};
template <>
struct Vec16<double> {
  using V = double2;
  static constexpr int N = 2;
  __device__ __forceinline__ static V make(const double* x) { return make_double2(x[0], x[1]); }
};

// WIDE_ROWS: warp w of block b draws row 8 b + w, its lanes along the
// columns (a run of VEC a lane, one 16-byte store; scalar stores before
// the row's first 16-byte boundary and after its last)
template <typename T, bool NORMAL>
__device__ __forceinline__ void hash_wide(uint32_t s0, uint32_t s1,
                                          const long long* __restrict__ rows, long long R, int n,
                                          T* __restrict__ out) {
  using V = typename Vec16<T>::V;
  constexpr int VEC = Vec16<T>::N;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (HASH_WIDE_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= R) return;
  const uint32_t rt = s0 + (uint32_t)rows[row] * GOLD;  // mod 2^32, as rows.astype(uint32)
  const uint32_t nm = (uint32_t)n * MUR1;
  T* o = out + row * n;
  const int lead = (int)((16u - ((uint32_t)reinterpret_cast<uintptr_t>(o) & 15u)) & 15u) /
                   (int)sizeof(T);
  const int head = lead < n ? lead : n;
  const int nv = (n - head) / VEC;
  if (lane < head) o[lane] = draw_at<T, NORMAL>(rt + (uint32_t)lane * MUR1, nm, s1);
  V* ov = reinterpret_cast<V*>(o + head);
  uint32_t t = rt + (uint32_t)(head + lane * VEC) * MUR1;
#pragma unroll 2
  for (int v = lane; v < nv; v += 32, t += 32u * VEC * MUR1) {
    T x[VEC];
    uint32_t c = t;
#pragma unroll
    for (int k = 0; k < VEC; ++k, c += MUR1) x[k] = draw_at<T, NORMAL>(c, nm, s1);
    ov[v] = Vec16<T>::make(x);
  }
  const int j = head + nv * VEC + lane;  // the tail: fewer than VEC columns
  if (j < n) o[j] = draw_at<T, NORMAL>(rt + (uint32_t)j * MUR1, nm, s1);
}

// a narrow row's n draws from its row term t into dst.  N > 0 (n = N):
// unrolled, each stage of Box-Muller over the N draws at once, so the N
// chains of libm calls overlap in one thread
template <typename T, bool NORMAL, int N>
__device__ __forceinline__ void row_draws(uint32_t t, uint32_t nm, uint32_t s1, int n, T* dst) {
  if constexpr (N > 0) {
    T u1[N], u2[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      u1[j] = uniform_of<T>(t + (uint32_t)j * MUR1, s1);
      if (NORMAL) u2[j] = uniform_of<T>(t + (uint32_t)j * MUR1 + nm, s1);
    }
    if constexpr (NORMAL) {
#pragma unroll
      for (int j = 0; j < N; ++j) u1[j] = bm_radius(u1[j]);
#pragma unroll
      for (int j = 0; j < N; ++j) u2[j] = bm_cos(u2[j]);
#pragma unroll
      for (int j = 0; j < N; ++j) u1[j] *= u2[j];
    }
#pragma unroll
    for (int j = 0; j < N; ++j) dst[j] = u1[j];
  } else {
#pragma unroll 4
    for (int j = 0; j < n; ++j, t += MUR1) dst[j] = draw_at<T, NORMAL>(t, nm, s1);
  }
}

// NARROW_ROWS: thread i of block b draws row 128 b + i into shared memory;
// the block's rows, contiguous in the output, go out in 16-byte stores
// where the output's alignment allows
template <typename T, bool NORMAL>
__device__ __forceinline__ void hash_narrow(uint32_t s0, uint32_t s1,
                                            const long long* __restrict__ rows, long long R, int n,
                                            T* __restrict__ out) {
  using V = typename Vec16<T>::V;
  constexpr int VEC = Vec16<T>::N;
  __shared__ __align__(16) T tile[HASH_NARROW_ROWS * HASH_NARROW_MAX];
  const long long r0 = (long long)blockIdx.x * HASH_NARROW_ROWS;  // the tile's base
  const int nr = R - r0 < HASH_NARROW_ROWS ? (int)(R - r0) : HASH_NARROW_ROWS;
  const uint32_t nm = (uint32_t)n * MUR1;
  if ((int)threadIdx.x < nr) {
    const uint32_t t = s0 + (uint32_t)rows[r0 + threadIdx.x] * GOLD;
    T* dst = tile + threadIdx.x * n;
    if (n == 3) row_draws<T, NORMAL, 3>(t, nm, s1, 3, dst);  // the thermostat
    else row_draws<T, NORMAL, 0>(t, nm, s1, n, dst);
  }
  __syncthreads();
  T* o = out + r0 * n;
  const int total = nr * n;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(o) & 15u) == 0) {
    done = total / VEC;
    const V* src = reinterpret_cast<const V*>(tile);
    for (int i = threadIdx.x; i < done; i += HASH_NARROW_ROWS) reinterpret_cast<V*>(o)[i] = src[i];
    done *= VEC;
  }
  for (int i = done + threadIdx.x; i < total; i += HASH_NARROW_ROWS) o[i] = tile[i];
}

// BY_ELEMENT: block b covers rows [rb b, rb (b + 1))
// (rb = 128 / n), contiguous in the output; thread i draws element i of
// them, its row i / n by the launcher's multiplier m = 2^16 / n + 1 (exact
// for i < 128, n <= 16)
template <typename T, bool NORMAL>
__device__ __forceinline__ void hash_elems(uint32_t s0, uint32_t s1,
                                           const long long* __restrict__ rows, long long R, int n,
                                           uint32_t m, T* __restrict__ out) {
  const int rb = HASH_NARROW_ROWS / n, i = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * rb;  // the block's base
  const int lr = (int)(((uint32_t)i * m) >> 16), j = i - lr * n;
  if (lr >= rb || r0 + lr >= R) return;
  const uint32_t t = s0 + (uint32_t)rows[r0 + lr] * GOLD + (uint32_t)j * MUR1;
  out[r0 * n + i] = draw_at<T, NORMAL>(t, (uint32_t)n * MUR1, s1);
}

// the two kernels, each in its shapes (the profiler names them
// hash_uniforms<...> and hash_normals<...>)
template <typename T, int SHAPE>
__global__ void __launch_bounds__(HASH_WIDE_THREADS)
hash_uniforms(uint32_t s0, uint32_t s1, const long long* __restrict__ rows, long long R, int n,
              uint32_t m, T* __restrict__ out) {
  if constexpr (SHAPE == WIDE_ROWS) hash_wide<T, false>(s0, s1, rows, R, n, out);
  else if constexpr (SHAPE == NARROW_ROWS) hash_narrow<T, false>(s0, s1, rows, R, n, out);
  else hash_elems<T, false>(s0, s1, rows, R, n, m, out);
}

template <typename T, int SHAPE>
__global__ void __launch_bounds__(HASH_WIDE_THREADS)
hash_normals(uint32_t s0, uint32_t s1, const long long* __restrict__ rows, long long R, int n,
             uint32_t m, T* __restrict__ out) {
  if constexpr (SHAPE == WIDE_ROWS) hash_wide<T, true>(s0, s1, rows, R, n, out);
  else if constexpr (SHAPE == NARROW_ROWS) hash_narrow<T, true>(s0, s1, rows, R, n, out);
  else hash_elems<T, true>(s0, s1, rows, R, n, m, out);
}

__device__ __forceinline__ float round_even(float q) { return rintf(q); }
__device__ __forceinline__ double round_even(double q) { return rint(q); }

__device__ __forceinline__ float abs_of(float v) { return fabsf(v); }
__device__ __forceinline__ double abs_of(double v) { return fabs(v); }
__device__ __forceinline__ float min_of(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double min_of(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float max_of(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_of(double a, double b) { return fmax(a, b); }

// a block's integer sum into *total (thread 0 adds it)
template <int NT>
__device__ __forceinline__ void block_add(unsigned int v, unsigned long long scale,
                                          unsigned long long* total) {
  __shared__ unsigned int part[NT / 32];
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long s = 0;
    for (int w = 0; w < NT / 32; ++w) s += part[w];
    if (s) atomicAdd(total, scale * s);
  }
}

// ---- pass 1: staging, compaction, sweep

// one asynchronous copy of `chunk` (16, 8 or 4) bytes, global to shared
__device__ __forceinline__ void cp_async(void* dst, const void* src, int chunk) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (chunk == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  } else if (chunk == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
  }
}

// the block's copies issued so far have landed (each thread waits for its
// own; the caller's __syncthreads makes them visible to all)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// the np sub-blocks of a piece, sub-block q (so[q] the lattice index of its
// first slot, ln[q] its slots) from src + so[q] * sb to dst + q * ps * sb
// (sb bytes a slot), in copies of `chunk` bytes spread over the block
// (PIECES false: every sub-block a whole cell, ln[q] = ps)
template <int NT, bool PIECES>
__device__ __forceinline__ void stage_piece(void* dst, const void* src, const long long* so,
                                            const int* ln, int np, int ps, int sb, int chunk) {
  unsigned char* d = static_cast<unsigned char*>(dst);
  const unsigned char* s = static_cast<const unsigned char*>(src);
  const int bytes = ps * sb, per = bytes / chunk;
  for (int i = threadIdx.x; i < np * per; i += NT) {
    const int q = i / per, k = (i - q * per) * chunk;
    if (!PIECES || k < ln[q] * sb) cp_async(d + q * bytes + k, s + so[q] * sb + k, chunk);
  }
}

// put(j, s, k) for each slot s < cap of the blocks j in [j0, j0 + n) with
// pred(j, s): a warp a block, a ballot per 32 slots, and one shared atomic
// on *counter a ballot gives its slots the places k = *counter + their
// rank.  Each place is taken once; the order is the warps' (the callers'
// sums do not depend on it).
template <int NT, class Pred, class Put>
__device__ __forceinline__ void compact_slots(int j0, int n, int cap, int* counter, Pred pred,
                                              Put put) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  for (int j = j0 + (threadIdx.x >> 5); j < j0 + n; j += NT / 32) {
    for (int s0 = 0; s0 < cap; s0 += 32) {
      const int s = s0 + lane;
      const bool p = s < cap && pred(j, s);
      const unsigned m = __ballot_sync(0xffffffffu, p);
      if (!m) continue;
      int base = 0;
      if (lane == 0) base = atomicAdd(counter, __popc(m));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (p) put(j, s, base + __popc(m & below));
    }
  }
}

// a pass-1 row in shared memory, read by a whole warp at once: its position,
// its slot r, its place c among the row tile's counts and (typed) its atom
// id
template <typename T>
struct __align__(16) P1Row {
  T x, y, z;
  int r, c;
  long long aid;
};

// the box edges and their quarters, in the type
template <typename T>
struct P1Box {
  T Lx, Ly, Lz, qx, qy, qz;
};

template <typename T>
__device__ __forceinline__ P1Box<T> p1_box(const T* box) {
  P1Box<T> g;
  g.Lx = box[0], g.Ly = box[1], g.Lz = box[2];
  g.qx = g.Lx * T(0.25), g.qy = g.Ly * T(0.25), g.qz = g.Lz * T(0.25);
  return g;
}

// the minimum image of d = row - candidate along an edge L, as the plain
// version rounds it: d - rint(d / L) * L
template <typename T>
__device__ __forceinline__ T image(T d, T L) {
  return d - round_even(d / L) * L;
}

// r^2 of a row and a candidate, each component as the plain version rounds
// it.  NEAR: every component lies within L / 4, where rint(d / L) is +-0
// and the image is d itself (the same value, no division).
template <bool NEAR, typename T>
__device__ __forceinline__ T pair_r2(const P1Row<T>& a, T x, T y, T z, const P1Box<T>& g) {
  T dx = a.x - x, dy = a.y - y, dz = a.z - z;
  if (!NEAR) {
    if (!(abs_of(dx) <= g.qx)) dx = image(dx, g.Lx);
    if (!(abs_of(dy) <= g.qy)) dy = image(dy, g.Ly);
    if (!(abs_of(dz) <= g.qz)) dz = image(dz, g.Lz);
  }
  return (dx * dx + dy * dy) + dz * dz;
}

// whether every row with coordinates in [lo, hi] lies within L / 4 of the
// candidate coordinate c: the rounded difference is monotone in the row's
// coordinate, so its two ends bound every row's
template <typename T>
__device__ __forceinline__ bool near_all(T lo, T hi, T c, T q) {
  return abs_of(lo - c) <= q && abs_of(hi - c) <= q;
}

// the half collection's candidates carry no key
struct NoKey {
  __device__ __forceinline__ long long operator()(int) const { return 0; }
};

constexpr int P1_QUEUE = 64;  // a warp's pending hits: < 32 carried + 32 new

// The rows [r0, r0 + nr) of `rows` against one candidate a thread (x, y, z,
// column w, key kb; `live` false past the list's end).  hit(row, r2, w, kb)
// says whether the pair counts, without a branch.  ALL: each hit adds
// `per` to its row (a warp sum a row, one shared add).  Else the hits queue
// per warp (a ballot, places by prefix count) and draw(a, b) runs on 32 of
// them at a time, so the hash never waits on the lanes whose pair missed.
// NEAR: no component needs its minimum image (see near_all).
template <bool NEAR, bool ALL, typename T, class Hit, class Draw>
__device__ __forceinline__ void sweep_rows(const P1Row<T>* rows, int r0, int nr, T x, T y, T z,
                                           int w, long long kb, int b, bool live,
                                           const P1Box<T>& g, unsigned int per, unsigned int* cnt,
                                           unsigned int* queue, int& pending,
                                           unsigned int& n_ok, Hit& hit, Draw& draw) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll 2
  for (int a = r0; a < r0 + nr; ++a) {
    const P1Row<T> ra = rows[a];
    const bool h = live & hit(ra, pair_r2<NEAR>(ra, x, y, z, g), w, kb);
    n_ok += h;
    if (ALL) {
      const unsigned c = __reduce_add_sync(0xffffffffu, h ? per : 0u);
      if (lane == 0 && c != 0) atomicAdd(&cnt[ra.c], c);
    } else {
      const unsigned m = __ballot_sync(0xffffffffu, h);
      if (m == 0) continue;
      if (h) queue[pending + __popc(m & below)] = ((unsigned)a << 16) | (unsigned)b;
      pending += __popc(m);
      if (pending >= 32) {
        __syncwarp();
        const unsigned e = queue[lane];
        draw(e >> 16, e & 0xffffu);
        __syncwarp();
        if (lane < pending - 32) queue[lane] = queue[lane + 32];
        pending -= 32;
        __syncwarp();
      }
    }
  }
}

// Rows [r0, r0 + nr) of `rows` against candidates [c0, c0 + nc) of the
// lists: each thread holds a candidate (its position, column w = lw[b] and
// key(w), read once) and walks the rows, so a warp reads a row once (one
// broadcast).  A warp whose candidates all lie within L / 4 of every row
// (the rows' coordinate range, near_all) takes the loop without the
// minimum-image test.  Returns this thread's hits.
template <int NT, bool ALL, typename T, class Key, class Hit, class Draw>
__device__ __forceinline__ unsigned int sweep(const P1Row<T>* rows, int r0, int nr, const T* lx,
                                              const T* ly, const T* lz, const int* lw, int c0,
                                              int nc, const P1Box<T>& g, unsigned int per,
                                              unsigned int* cnt, unsigned int* queue, Key& key,
                                              Hit& hit, Draw& draw) {
  const int lane = threadIdx.x & 31;
  unsigned int n_ok = 0;
  int pending = 0;
  if (nr <= 0 || nc <= 0) return 0;
  // the rows' coordinate range, per warp (NaN coordinates drop out of it
  // and fail every test either way)
  const P1Row<T>& first = rows[r0 + (lane < nr ? lane : 0)];
  T lo[3] = {first.x, first.y, first.z}, hi[3] = {first.x, first.y, first.z};
#pragma unroll 1
  for (int a = r0 + lane + 32; a < r0 + nr; a += 32) {
    const T v[3] = {rows[a].x, rows[a].y, rows[a].z};
    for (int c = 0; c < 3; ++c) lo[c] = min_of(lo[c], v[c]), hi[c] = max_of(hi[c], v[c]);
  }
  for (int o = 16; o > 0; o >>= 1) {
    for (int c = 0; c < 3; ++c) {
      lo[c] = min_of(lo[c], __shfl_xor_sync(0xffffffffu, lo[c], o));
      hi[c] = max_of(hi[c], __shfl_xor_sync(0xffffffffu, hi[c], o));
    }
  }
  for (int b0 = 0; b0 < nc; b0 += NT) {
    const bool live = b0 + (int)threadIdx.x < nc;
    if (!__any_sync(0xffffffffu, live)) break;  // the later passes have no lane either
    const int b = c0 + (live ? b0 + (int)threadIdx.x : 0);
    const T x = lx[b], y = ly[b], z = lz[b];
    const int w = lw[b];
    const long long kb = key(w);
    const bool near = !live || (near_all(lo[0], hi[0], x, g.qx) &&
                                near_all(lo[1], hi[1], y, g.qy) &&
                                near_all(lo[2], hi[2], z, g.qz));
    if (__all_sync(0xffffffffu, near)) {
      sweep_rows<true, ALL>(rows, r0, nr, x, y, z, w, kb, b, live, g, per, cnt, queue, pending,
                            n_ok, hit, draw);
    } else {
      sweep_rows<false, ALL>(rows, r0, nr, x, y, z, w, kb, b, live, g, per, cnt, queue, pending,
                             n_ok, hit, draw);
    }
  }
  if (!ALL) {
    __syncwarp();
    if (lane < pending) {
      const unsigned e = queue[lane];
      draw(e >> 16, e & 0xffffu);
    }
    __syncwarp();
  }
  return n_ok;
}

__host__ __device__ constexpr long long align16(long long b) { return (b + 15) & ~15LL; }

// p1_count_half's dynamic shared memory for a row tile of rt rows and a
// piece of pw candidate slots: the staged slot blocks (xyz, mask), the
// compacted candidate list (x, y, z, column w), the rows, their counts and
// the threads' hit queues, each region 16-byte aligned
struct HalfSmem {
  long long sx, sm, lx, ly, lz, lw, rows, cnt, queue, total;
  __host__ __device__ HalfSmem(int rt, int pw, int es) {
    const long long W = pw;
    const long long row = align16(3LL * es + 16);  // sizeof(P1Row<T>)
    long long o = 0;
    sx = o, o += align16(W * 3 * es);
    sm = o, o += align16(W * es);
    lx = o, o += align16(W * es);
    ly = o, o += align16(W * es);
    lz = o, o += align16(W * es);
    lw = o, o += align16(W * 4);
    rows = o, o += rt * row;
    cnt = o, o += align16((long long)rt * 4);
    queue = o, o += 4LL * P1_QUEUE * (P1_HALF_THREADS / 32);
    total = o;
  }
};

// p1_count_typed's: the staged slot blocks (xyz, aid, type), the two
// compacted candidate lists (x, y, z, column w; list 1 from the end), the
// rows (group 1 from the end), their counts and the hit queues
struct TypedSmem {
  long long sx, sa, st, lx, ly, lz, lw, rows, cnt, queue, total;
  __host__ __device__ TypedSmem(int rt, int pw, int es) {
    const long long W = pw;
    const long long row = align16(3LL * es + 16);
    long long o = 0;
    sx = o, o += align16(W * 3 * es);
    sa = o, o += align16(W * 8);
    st = o, o += align16(W * es);
    lx = o, o += align16(W * es);
    ly = o, o += align16(W * es);
    lz = o, o += align16(W * es);
    lw = o, o += align16(W * 4);
    rows = o, o += rt * row;
    cnt = o, o += align16((long long)rt * 4);
    queue = o, o += 4LL * P1_QUEUE * (P1_TYPED_THREADS / 32);
    total = o;
  }
};

// The piece plan of pass 1: the own cell's rows rt at a time; each
// candidate cell's cap slots in nsub sub-blocks of ps slots (ps = cap,
// nsub = 1: whole cells), pc sub-blocks a piece (pc = 1 when ps < cap), so
// piece p holds the sub-blocks [p pc, (p + 1) pc) of the cells in stencil
// order and its candidate columns are w0 + its staged index, w0 the
// column of its first slot.
struct P1Plan {
  int rt, ps, pc, nsub;
};

// the plan of a kernel with shared memory Smem over `ncells` candidate
// cells of `cap` slots of es-byte values: all the rows and the most whole
// cells a piece that fit the budget; else rows tiled (at most a quarter of
// the budget, a multiple of 32) and again the most whole cells; else that
// row tile and runs of ps slots, the most that fit (a multiple of 4)
template <class Smem>
P1Plan p1_plan(int cap, int ncells, int es) {
  auto fits = [&](int rt, int pw) { return Smem(rt, pw, es).total <= P1_SMEM_BUDGET; };
  int rq = 32;
  while (rq + 32 < cap && Smem(rq + 32, 0, es).total <= P1_SMEM_BUDGET / 4) rq += 32;
  const int tiles[2] = {cap, rq < cap ? rq : cap};
  for (const int rt : tiles) {
    for (int pc = ncells; pc >= 1; --pc) {
      if (fits(rt, pc * cap)) return {rt, cap, pc, 1};
    }
  }
  int ps = (cap - 1) & ~3;
  while (ps > 4 && !fits(tiles[1], ps)) ps -= 4;
  return {tiles[1], ps, 1, (cap + ps - 1) / ps};
}

// whether a plan is one piece and one row tile (the kernels' PIECES = false
// form)
bool one_piece(const P1Plan& P, int cap, int ncells) {
  return P.rt == cap && P.ps == cap && P.pc == ncells;
}

// piece p's sub-blocks: thread q < np of the block sets so[q] (the lattice
// index of its first slot: the cell cid(j) = cell_of(j), slot sb) and ln[q];
// returns np and sets w0
template <class CellOf>
__device__ __forceinline__ int piece_blocks(const P1Plan& P, int cap, int nq, int p,
                                            CellOf cell_of, long long* so, int* ln, int& w0) {
  const int q0 = p * P.pc;
  const int np = nq - q0 < P.pc ? nq - q0 : P.pc;
  if ((int)threadIdx.x < np) {
    const int q = q0 + threadIdx.x, j = q / P.nsub, sb = (q - j * P.nsub) * P.ps;
    so[threadIdx.x] = cell_of(j) * cap + sb;
    ln[threadIdx.x] = cap - sb < P.ps ? cap - sb : P.ps;
  }
  const int j0 = q0 / P.nsub;
  w0 = j0 * cap + (q0 - j0 * P.nsub) * P.ps;
  return np;
}

extern __shared__ __align__(16) unsigned char p1_smem[];

// xs (Cg, cap, 3) and mc (Cg, cap) of the type: the slot lattice; cells
// (B,) the row cells' global ids; nbr (C, 13) half_neighbors.  Block b: the
// rows of cell cells[b] against its own slots (columns 0..cap-1) and its
// 13 neighbours' (column j cap + s for neighbour j - 1's slot s), piece by
// piece of the plan P.  PIECES false: the plan is one piece and one row
// tile (every cap up to its limit), the loops run once and the rows come
// from the staged own cell, with nothing kept live for further pieces.
template <typename T, bool PIECES>
__global__ void __launch_bounds__(P1_HALF_THREADS)
p1_count_half(const T* __restrict__ xs, const T* __restrict__ mc,
              const long long* __restrict__ cells, const long long* __restrict__ nbr,
              const T* __restrict__ box, T bmax2, const T* __restrict__ thresh, uint32_t s0,
              uint32_t s1, int cap, P1Plan P, int chunk_x, int chunk_m,
              long long* __restrict__ row_counts, unsigned long long* __restrict__ ncalls) {
  constexpr int NT = P1_HALF_THREADS;
  __shared__ long long so[HALF_CELLS];
  __shared__ int ln[HALF_CELLS];
  __shared__ int n_list, n_rows;
  const P1Plan Q = PIECES ? P : P1Plan{cap, cap, HALF_CELLS, 1};
  const HalfSmem L(Q.rt, Q.pc * Q.ps, sizeof(T));
  T* sx = reinterpret_cast<T*>(p1_smem + L.sx);
  T* sm = reinterpret_cast<T*>(p1_smem + L.sm);
  T* lx = reinterpret_cast<T*>(p1_smem + L.lx);
  T* ly = reinterpret_cast<T*>(p1_smem + L.ly);
  T* lz = reinterpret_cast<T*>(p1_smem + L.lz);
  int* lw = reinterpret_cast<int*>(p1_smem + L.lw);
  P1Row<T>* rows = reinterpret_cast<P1Row<T>*>(p1_smem + L.rows);
  unsigned int* cnt = reinterpret_cast<unsigned int*>(p1_smem + L.cnt);
  unsigned int* queue = reinterpret_cast<unsigned int*>(p1_smem + L.queue);
  const long long cell = cells[blockIdx.x];
  auto cell_of = [&](int j) { return j == 0 ? cell : nbr[cell * 13 + j - 1]; };
  const P1Box<T> g = p1_box(box);
  const bool all = thresh == nullptr;
  const T th = all ? T(0) : *thresh;
  const int nq = HALF_CELLS * Q.nsub;
  const int n_pieces = PIECES ? (nq + Q.pc - 1) / Q.pc : 1;
  const int n_tiles = PIECES ? (cap + Q.rt - 1) / Q.rt : 1;
  unsigned int* wq = queue + (threadIdx.x >> 5) * P1_QUEUE;
  const NoKey no_key;
  unsigned int n_ok = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int r0 = t * Q.rt, nr = cap - r0 < Q.rt ? cap - r0 : Q.rt;
    for (int p = 0; p < n_pieces; ++p) {
      int w0;
      const int np = piece_blocks(Q, cap, nq, p, cell_of, so, ln, w0);
      if (threadIdx.x == 0) {
        n_list = 0;
        if (p == 0) n_rows = 0;
      }
      if (p == 0) {
        for (int r = threadIdx.x; r < nr; r += NT) cnt[r] = 0;
      }
      __syncthreads();
      stage_piece<NT, PIECES>(sx, xs, so, ln, np, Q.ps, 3 * sizeof(T), chunk_x);
      stage_piece<NT, PIECES>(sm, mc, so, ln, np, Q.ps, sizeof(T), chunk_m);
      // the tile's occupied rows: read from the lattice while the copies
      // fly; with one piece, from the staged own cell (sub-block 0)
      const T* rx = PIECES ? xs + (cell * cap + r0) * 3 : sx;
      const T* rm = PIECES ? mc + cell * cap + r0 : sm;
      auto occupied_row = [&](int, int s) { return rm[s] > T(0.5); };
      auto put_row = [&](int, int s, int k) {
        rows[k].x = rx[3 * s], rows[k].y = rx[3 * s + 1], rows[k].z = rx[3 * s + 2];
        rows[k].r = r0 + s, rows[k].c = s;
      };
      if (PIECES && p == 0) compact_slots<NT>(0, 1, nr, &n_rows, occupied_row, put_row);
      cp_async_wait_all();
      __syncthreads();
      // the piece's occupied slots as candidates
      auto occupied = [&](int q, int s) {
        return (!PIECES || s < ln[q]) && sm[q * Q.ps + s] > T(0.5);
      };
      auto put = [&](int q, int s, int k) {
        const int i = q * Q.ps + s;
        lx[k] = sx[3 * i], ly[k] = sx[3 * i + 1], lz[k] = sx[3 * i + 2], lw[k] = w0 + i;
      };
      compact_slots<NT>(0, np, Q.ps, &n_list, occupied, put);
      if (!PIECES) compact_slots<NT>(0, 1, nr, &n_rows, occupied_row, put_row);
      __syncthreads();
      // the self block strictly upper (w >= cap or w > r): each pair once
      auto hit = [&](const P1Row<T>& ra, T r2, int w, long long) {
        return ((w >= cap) | (w > ra.r)) & (r2 < bmax2);
      };
      auto draw = [&](int a, int b) {
        const P1Row<T>& ra = rows[a];
        const int w = lw[b];
        const uint32_t row = (uint32_t)(cell * cap + ra.r);
        const unsigned c = (uniform_at<T>(s0, s1, row, 2 * w) < th) +
                           (uniform_at<T>(s0, s1, row, 2 * w + 1) < th);
        if (c) atomicAdd(&cnt[ra.c], c);
      };
      if (all) {
        n_ok += sweep<NT, true>(rows, 0, n_rows, lx, ly, lz, lw, 0, n_list, g, 2u, cnt, wq,
                                no_key, hit, draw);
      } else {
        n_ok += sweep<NT, false>(rows, 0, n_rows, lx, ly, lz, lw, 0, n_list, g, 2u, cnt, wq,
                                 no_key, hit, draw);
      }
      // the piece's lists and the counts are read and written (one piece:
      // block_add's barrier)
      if (PIECES) __syncthreads();
    }
    if (!PIECES) block_add<NT>(n_ok, 2ull, ncalls);
    for (int r = threadIdx.x; r < nr; r += NT) {
      row_counts[(long long)blockIdx.x * cap + r0 + r] = cnt[r];
    }
  }
  if (PIECES) block_add<NT>(n_ok, 2ull, ncalls);
}

// xs (Cg, cap, 3) and ts (Cg, cap) of the type, aid (Cg cap) int64: the
// slot lattice; nbr (C, 27) stencil_neighbors (column STENCIL_SELF the
// cell itself).  Block c: the rows of cell c against its 27 cap ordered
// candidates, column w = j cap + s, piece by piece of the plan P (PIECES
// as p1_count_half).
template <typename T, bool PIECES>
__global__ void __launch_bounds__(P1_TYPED_THREADS)
p1_count_typed(const T* __restrict__ xs, const long long* __restrict__ aid,
               const T* __restrict__ ts, const long long* __restrict__ nbr,
               const T* __restrict__ box, T bmax2, const T* __restrict__ thresh, T t0, T t1,
               long long n_atoms, uint32_t s0, uint32_t s1, int cap, P1Plan P, int chunk_x,
               int chunk_a, int chunk_t, long long* __restrict__ row_counts,
               unsigned long long* __restrict__ ncalls) {
  constexpr int NT = P1_TYPED_THREADS;
  __shared__ long long so[STENCIL];
  __shared__ int ln[STENCIL];
  __shared__ int n0, n1, r0n, r1n;
  const P1Plan Q = PIECES ? P : P1Plan{cap, cap, STENCIL, 1};
  const int pw = Q.pc * Q.ps;
  const TypedSmem L(Q.rt, pw, sizeof(T));
  T* sx = reinterpret_cast<T*>(p1_smem + L.sx);
  long long* sa = reinterpret_cast<long long*>(p1_smem + L.sa);
  T* st = reinterpret_cast<T*>(p1_smem + L.st);
  T* lx = reinterpret_cast<T*>(p1_smem + L.lx);
  T* ly = reinterpret_cast<T*>(p1_smem + L.ly);
  T* lz = reinterpret_cast<T*>(p1_smem + L.lz);
  int* lw = reinterpret_cast<int*>(p1_smem + L.lw);
  P1Row<T>* rows = reinterpret_cast<P1Row<T>*>(p1_smem + L.rows);
  unsigned int* cnt = reinterpret_cast<unsigned int*>(p1_smem + L.cnt);
  unsigned int* queue = reinterpret_cast<unsigned int*>(p1_smem + L.queue);
  const long long cell = blockIdx.x;
  auto cell_of = [&](int j) { return nbr[cell * STENCIL + j]; };
  const P1Box<T> g = p1_box(box);
  const bool all = thresh == nullptr;
  const T th = all ? T(0) : *thresh;
  const bool one = t0 == t1;
  const int nq = STENCIL * Q.nsub;
  const int n_pieces = PIECES ? (nq + Q.pc - 1) / Q.pc : 1;
  const int n_tiles = PIECES ? (cap + Q.rt - 1) / Q.rt : 1;
  unsigned int* wq = queue + (threadIdx.x >> 5) * P1_QUEUE;
  unsigned int n_ok = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int r0 = t * Q.rt, nr = cap - r0 < Q.rt ? cap - r0 : Q.rt;
    for (int p = 0; p < n_pieces; ++p) {
      int w0;
      const int np = piece_blocks(Q, cap, nq, p, cell_of, so, ln, w0);
      if (threadIdx.x == 0) {
        n0 = 0, n1 = 0;
        if (p == 0) r0n = 0, r1n = 0;
      }
      if (p == 0) {
        for (int r = threadIdx.x; r < nr; r += NT) cnt[r] = 0;
      }
      __syncthreads();
      stage_piece<NT, PIECES>(sx, xs, so, ln, np, Q.ps, 3 * sizeof(T), chunk_x);
      stage_piece<NT, PIECES>(sa, aid, so, ln, np, Q.ps, 8, chunk_a);
      stage_piece<NT, PIECES>(st, ts, so, ln, np, Q.ps, sizeof(T), chunk_t);
      // the tile's real rows of type t0 (from the front) and t1 (from the
      // end): read from the lattice while the copies fly; with one piece,
      // from the staged own cell (sub-block STENCIL_SELF)
      const int own = STENCIL_SELF * cap;
      const T* rx = PIECES ? xs + (cell * cap + r0) * 3 : sx + 3 * own;
      const long long* ra_ = PIECES ? aid + cell * cap + r0 : sa + own;
      const T* rt_ = PIECES ? ts + cell * cap + r0 : st + own;
      auto row0 = [&](int, int s) { return ra_[s] < n_atoms && rt_[s] == t0; };
      auto row1 = [&](int, int s) { return !one && ra_[s] < n_atoms && rt_[s] == t1; };
      auto put_row = [&](int, int s, int k) {
        rows[k].x = rx[3 * s], rows[k].y = rx[3 * s + 1], rows[k].z = rx[3 * s + 2];
        rows[k].r = r0 + s, rows[k].c = s, rows[k].aid = ra_[s];
      };
      auto put_row_back = [&](int j, int s, int k) { put_row(j, s, Q.rt - 1 - k); };
      if (PIECES && p == 0) {
        compact_slots<NT>(0, 1, nr, &r0n, row0, put_row);
        compact_slots<NT>(0, 1, nr, &r1n, row1, put_row_back);
      }
      cp_async_wait_all();
      __syncthreads();
      // the piece's real candidates of type t0 (list 0, from the front) and,
      // unless t0 == t1, of type t1 (list 1, from the end)
      auto real = [&](int q, int s) {
        return (!PIECES || s < ln[q]) && sa[q * Q.ps + s] < n_atoms;
      };
      auto is0 = [&](int q, int s) { return real(q, s) && st[q * Q.ps + s] == t0; };
      auto is1 = [&](int q, int s) { return !one && real(q, s) && st[q * Q.ps + s] == t1; };
      auto put = [&](int q, int s, int k) {
        const int i = q * Q.ps + s;
        lx[k] = sx[3 * i], ly[k] = sx[3 * i + 1], lz[k] = sx[3 * i + 2], lw[k] = w0 + i;
      };
      auto put_back = [&](int q, int s, int k) { put(q, s, pw - 1 - k); };
      compact_slots<NT>(0, np, Q.ps, &n0, is0, put);
      compact_slots<NT>(0, np, Q.ps, &n1, is1, put_back);
      if (!PIECES) {
        compact_slots<NT>(0, 1, nr, &r0n, row0, put_row);
        compact_slots<NT>(0, 1, nr, &r1n, row1, put_row_back);
      }
      __syncthreads();
      // the type pair matches by construction and both atoms are real: a pair
      // counts when the atoms differ and lie within bmax
      auto key = [&](int w) { return sa[w - w0]; };  // the candidate's atom id
      auto hit = [&](const P1Row<T>& ra, T r2, int, long long ab) {
        return (r2 < bmax2) & (ab != ra.aid);
      };
      auto draw = [&](int a, int b) {
        const P1Row<T>& ra = rows[a];
        if (uniform_at<T>(s0, s1, (uint32_t)(cell * cap + ra.r), lw[b]) < th) {
          atomicAdd(&cnt[ra.c], 1u);
        }
      };
      // rows of t0 against candidates of t1 and the reverse; one list when t0 == t1
      const int c0 = one ? 0 : pw - n1, nc = one ? n0 : n1, r1 = one ? 0 : r1n;
      if (all) {
        n_ok += sweep<NT, true>(rows, 0, r0n, lx, ly, lz, lw, c0, nc, g, 1u, cnt, wq, key, hit,
                                draw);
        n_ok += sweep<NT, true>(rows, Q.rt - r1, r1, lx, ly, lz, lw, 0, n0, g, 1u, cnt, wq, key,
                                hit, draw);
      } else {
        n_ok += sweep<NT, false>(rows, 0, r0n, lx, ly, lz, lw, c0, nc, g, 1u, cnt, wq, key, hit,
                                 draw);
        n_ok += sweep<NT, false>(rows, Q.rt - r1, r1, lx, ly, lz, lw, 0, n0, g, 1u, cnt, wq,
                                 key, hit, draw);
      }
      // the piece's lists and the counts are read and written (one piece:
      // block_add's barrier)
      if (PIECES) __syncthreads();
    }
    if (!PIECES) block_add<NT>(n_ok, 1ull, ncalls);
    for (int r = threadIdx.x; r < nr; r += NT) row_counts[cell * cap + r0 + r] = cnt[r];
  }
  if (PIECES) block_add<NT>(n_ok, 1ull, ncalls);
}

// the widest of 16, 8 and 4 bytes that divides both the block size and the
// address (0: not even 4-byte aligned)
int chunk_of(const void* p, long long bytes) {
  const unsigned long long a = reinterpret_cast<unsigned long long>(p);
  for (int c = 16; c >= 4; c >>= 1) {
    if (bytes % c == 0 && a % c == 0) return c;
  }
  return 0;
}

// the copy size of a plane of sb bytes a slot under plan P: it must divide
// a cell's block and a sub-block (both multiples of gcd(cap, ps) slots)
int plane_chunk(const void* p, int cap, const P1Plan& P, int sb) {
  return chunk_of(p, (long long)std::gcd(cap, P.ps) * sb);
}

// dynamic shared memory above the default 48 KB needs the kernel's opt-in
// (a plan never asks for more than P1_SMEM_BUDGET)
template <typename K>
cudaError_t allow_smem(K kernel, long long bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// hash_rows in a shape: WIDE_ROWS 8 rows a block; NARROW_ROWS 128 rows;
// BY_ELEMENT 128 / n rows
template <typename T, int SHAPE>
void launch_hash(uint32_t s0, uint32_t s1, const long long* rows, long long R, int n, int normal,
                 T* out, cudaStream_t st) {
  const int per = SHAPE == WIDE_ROWS     ? HASH_WIDE_THREADS / 32
                  : SHAPE == NARROW_ROWS ? HASH_NARROW_ROWS
                                         : HASH_NARROW_ROWS / n;
  const unsigned blocks = (unsigned)((R + per - 1) / per);
  const int threads = SHAPE == WIDE_ROWS ? HASH_WIDE_THREADS : HASH_NARROW_ROWS;
  const uint32_t m = 65536u / (uint32_t)n + 1u;
  if (normal) hash_normals<T, SHAPE><<<blocks, threads, 0, st>>>(s0, s1, rows, R, n, m, out);
  else hash_uniforms<T, SHAPE><<<blocks, threads, 0, st>>>(s0, s1, rows, R, n, m, out);
}

// the shape by n and R (the header's "The design of hash_rows")
template <typename T>
cudaError_t hash_rows_typed(uint32_t s0, uint32_t s1, const long long* rows, long long R, int n,
                            int normal, void* out, cudaStream_t st) {
  T* o = static_cast<T*>(out);
  if (reinterpret_cast<uintptr_t>(o) % sizeof(T) != 0) return cudaErrorMisalignedAddress;
  if ((R + 7) / 8 > 0x7fffffffLL) return cudaErrorInvalidValue;  // the grid's x limit
  if (n > HASH_NARROW_MAX) launch_hash<T, WIDE_ROWS>(s0, s1, rows, R, n, normal, o, st);
  else if (R >= HASH_ROWWISE_MIN) launch_hash<T, NARROW_ROWS>(s0, s1, rows, R, n, normal, o, st);
  else launch_hash<T, BY_ELEMENT>(s0, s1, rows, R, n, normal, o, st);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// rows: R int64 row ids on the card; out: R x n float32 (f64 = 0) or
// float64 (f64 = 1), uniforms (normal = 0) or normals (normal = 1)
int hash_rows_launch(unsigned s0, unsigned s1, const void* rows, long long R, int n, int normal,
                     int f64, void* out, void* stream) {
  if (R < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (R == 0 || n == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long* r = static_cast<const long long*>(rows);
  const cudaError_t e = f64 ? hash_rows_typed<double>(s0, s1, r, R, n, normal, out, st)
                            : hash_rows_typed<float>(s0, s1, r, R, n, normal, out, st);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// xs (Cg, cap, 3) and mc (Cg, cap) of the type; cells (B,) int64 global
// cell ids; nbr (C, 13) int64 half_neighbors; box (3,) of the type; thresh
// a device scalar of the type or null; row_counts (B cap) int64; ncalls one
// int64, zeroed here
int p1_count_half_launch(const void* xs, const void* mc, const void* cells, const void* nbr,
                         const void* box, double bmax2, const void* thresh, unsigned s0,
                         unsigned s1, int B, int cap, int f64, void* row_counts, void* ncalls,
                         void* stream) {
  if (B < 0 || cap < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(ncalls, 0, sizeof(long long), st);
  if (e != cudaSuccess || B == 0) return (int)e;
  const int es = f64 ? 8 : 4;
  const P1Plan P = p1_plan<HalfSmem>(cap, HALF_CELLS, es);
  const long long smem = HalfSmem(P.rt, P.pc * P.ps, es).total;
  const int cx = plane_chunk(xs, cap, P, 3 * es), cm = plane_chunk(mc, cap, P, es);
  if (!cx || !cm) return (int)cudaErrorMisalignedAddress;
  const long long* c = static_cast<const long long*>(cells);
  const long long* nb = static_cast<const long long*>(nbr);
  long long* rc = static_cast<long long*>(row_counts);
  unsigned long long* nc = static_cast<unsigned long long*>(ncalls);
  const bool pieces = !one_piece(P, cap, HALF_CELLS);
  if (f64) {
    const auto k = pieces ? p1_count_half<double, true> : p1_count_half<double, false>;
    if ((e = allow_smem(k, smem)) != cudaSuccess) return (int)e;
    k<<<B, P1_HALF_THREADS, smem, st>>>(
        static_cast<const double*>(xs), static_cast<const double*>(mc), c, nb,
        static_cast<const double*>(box), bmax2, static_cast<const double*>(thresh), s0, s1, cap,
        P, cx, cm, rc, nc);
  } else {
    const auto k = pieces ? p1_count_half<float, true> : p1_count_half<float, false>;
    if ((e = allow_smem(k, smem)) != cudaSuccess) return (int)e;
    k<<<B, P1_HALF_THREADS, smem, st>>>(
        static_cast<const float*>(xs), static_cast<const float*>(mc), c, nb,
        static_cast<const float*>(box), (float)bmax2, static_cast<const float*>(thresh), s0, s1,
        cap, P, cx, cm, rc, nc);
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
  const int es = f64 ? 8 : 4;
  const P1Plan P = p1_plan<TypedSmem>(cap, STENCIL, es);
  const long long smem = TypedSmem(P.rt, P.pc * P.ps, es).total;
  const int cx = plane_chunk(xs, cap, P, 3 * es), ca = plane_chunk(aid, cap, P, 8),
            ct = plane_chunk(ts, cap, P, es);
  if (!cx || !ca || !ct) return (int)cudaErrorMisalignedAddress;
  const long long* a = static_cast<const long long*>(aid);
  const long long* nb = static_cast<const long long*>(nbr);
  long long* rc = static_cast<long long*>(row_counts);
  unsigned long long* nc = static_cast<unsigned long long*>(ncalls);
  const bool pieces = !one_piece(P, cap, STENCIL);
  if (f64) {
    const auto k = pieces ? p1_count_typed<double, true> : p1_count_typed<double, false>;
    if ((e = allow_smem(k, smem)) != cudaSuccess) return (int)e;
    k<<<C, P1_TYPED_THREADS, smem, st>>>(
        static_cast<const double*>(xs), a, static_cast<const double*>(ts), nb,
        static_cast<const double*>(box), bmax2, static_cast<const double*>(thresh), t0, t1,
        n_atoms, s0, s1, cap, P, cx, ca, ct, rc, nc);
  } else {
    const auto k = pieces ? p1_count_typed<float, true> : p1_count_typed<float, false>;
    if ((e = allow_smem(k, smem)) != cudaSuccess) return (int)e;
    k<<<C, P1_TYPED_THREADS, smem, st>>>(
        static_cast<const float*>(xs), a, static_cast<const float*>(ts), nb,
        static_cast<const float*>(box), (float)bmax2, static_cast<const float*>(thresh),
        (float)t0, (float)t1, n_atoms, s0, s1, cap, P, cx, ca, ct, rc, nc);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
