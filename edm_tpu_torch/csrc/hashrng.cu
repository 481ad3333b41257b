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
// The design (both).  A block a row cell (128 threads; typed 256) stages
// its 14 (27) candidate cells' slot blocks, each contiguous in the lattice
// (xyz and the mask; typed: xyz, aid and type), into shared memory once
// with cp.async.  It compacts the candidates that can count into
// structure-of-arrays lists (x, y, z, column w), a warp a cell, a ballot
// and one shared atomic per 32 slots: the occupied slots, and the own
// cell's as rows (typed: the real slots of type t0 and of type t1, and the
// own cell's real rows of each type).  The sweep gives each thread one
// candidate and walks the rows, read as one broadcast struct a row, so no
// lane waits on an empty slot or a row of neither type (typed: rows of t0
// against candidates of t1 and the reverse; one list when t0 == t1).  The
// test of a pair has no branch; a pair within bmax goes to its warp's queue
// (a ballot and a prefix count), and the queue is hashed 32 pairs at a
// time, so the hash never waits on the lanes whose pair missed (with no
// threshold, a warp sum a row instead).  Row counts are integer
// shared-memory adds and ncalls one integer atomic a block: integers, so
// the order of the sums and of the lists changes nothing.
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
// What bounds them.  hash_rows writes 4 or 8 bytes an element for ~12
// integer operations a hash (two for a normal, plus the three libm calls):
// at the thermostat's shapes (23,552 or 219,648 rows x 3) a launch's fixed
// cost is most of its time (1.8 and 5.0 us on an H100, chip_smoke.py).
// Pass 1 must read the lattice once (16 bytes a slot; typed 24), the
// neighbour table and the cell list and write the row counts: 6 MB at the
// 100k cell, 1.8 us at 3.35 TB/s.  Its operations bind: ~12 a pair of
// occupied slots (~2e7 pairs at 100k), 4 more a component across a
// periodic face, and a hash for each of the ~5.6e6 draws of the pairs
// within bmax (~0.006 ms at 100k).  The kernels stay several times above
// that: the staging reads each cell's block once a neighbouring row cell
// (14 or 27 times, from L2), and the sweep spends ~30 instructions a
// (row, candidate) step on ~12 of arithmetic (PERF.md, section 6).
//
// Plain C interface, loaded with ctypes; the launches go on the caller's
// stream and each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HASH_THREADS = 256;
constexpr int P1_HALF_THREADS = 128;
constexpr int P1_TYPED_THREADS = 256;
constexpr int HALF_CELLS = 14;    // the cell and its 13 HALF_OFFSETS neighbours
constexpr int STENCIL = 27;
constexpr int STENCIL_SELF = 13;  // the (0, 0, 0) column of stencil_neighbors
constexpr long long P1_MAX_SMEM = 232448;  // a block's shared memory on sm_90

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

__device__ __forceinline__ float abs_of(float v) { return fabsf(v); }
__device__ __forceinline__ double abs_of(double v) { return fabs(v); }
__device__ __forceinline__ float min_of(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double min_of(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float max_of(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_of(double a, double b) { return fmax(a, b); }

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

// n slot blocks of `bytes` each, block j from src + cells[j] * bytes to
// dst + j * bytes, in copies of `chunk` bytes spread over the block
template <int NT>
__device__ __forceinline__ void stage_blocks(void* dst, const void* src, const long long* cells,
                                             int n, int bytes, int chunk) {
  unsigned char* d = static_cast<unsigned char*>(dst);
  const unsigned char* s = static_cast<const unsigned char*>(src);
  const int per = bytes / chunk;
  for (int i = threadIdx.x; i < n * per; i += NT) {
    const int j = i / per, k = (i - j * per) * chunk;
    cp_async(d + (long long)j * bytes + k, s + cells[j] * bytes + k, chunk);
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
// its slot and (typed) its atom id
template <typename T>
struct __align__(16) P1Row {
  T x, y, z;
  int r;
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
      if (lane == 0 && c != 0) atomicAdd(&cnt[ra.r], c);
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

// p1_count_half's dynamic shared memory: the 14 staged slot blocks (xyz,
// mask), the compacted candidate list (x, y, z, column w), the rows, their
// counts and the threads' hit queues, each region 16-byte aligned
struct HalfSmem {
  long long sx, sm, lx, ly, lz, lw, rows, cnt, queue, total;
  __host__ __device__ HalfSmem(int cap, int es) {
    const long long W = (long long)HALF_CELLS * cap;
    const long long row = align16(3LL * es + 12);  // sizeof(P1Row<T>)
    long long o = 0;
    sx = o, o += align16(W * 3 * es);
    sm = o, o += align16(W * es);
    lx = o, o += align16(W * es);
    ly = o, o += align16(W * es);
    lz = o, o += align16(W * es);
    lw = o, o += align16(W * 4);
    rows = o, o += cap * row;
    cnt = o, o += align16((long long)cap * 4);
    queue = o, o += 4LL * P1_QUEUE * (P1_HALF_THREADS / 32);
    total = o;
  }
};

// p1_count_typed's: the 27 staged slot blocks (xyz, aid, type), the two
// compacted candidate lists (x, y, z, column w; list 1 from the end), the
// rows (group 1 from the end), their counts and the hit queues
struct TypedSmem {
  long long sx, sa, st, lx, ly, lz, lw, rows, cnt, queue, total;
  __host__ __device__ TypedSmem(int cap, int es) {
    const long long W = (long long)STENCIL * cap;
    const long long row = align16(3LL * es + 12);
    long long o = 0;
    sx = o, o += align16(W * 3 * es);
    sa = o, o += align16(W * 8);
    st = o, o += align16(W * es);
    lx = o, o += align16(W * es);
    ly = o, o += align16(W * es);
    lz = o, o += align16(W * es);
    lw = o, o += align16(W * 4);
    rows = o, o += cap * row;
    cnt = o, o += align16((long long)cap * 4);
    queue = o, o += 4LL * P1_QUEUE * (P1_TYPED_THREADS / 32);
    total = o;
  }
};

extern __shared__ __align__(16) unsigned char p1_smem[];

// xs (Cg, cap, 3) and mc (Cg, cap) of the type: the slot lattice; cells
// (B,) the row cells' global ids; nbr (C, 13) half_neighbors.  Block b: the
// rows of cell cells[b] against its own slots (columns 0..cap-1) and its
// 13 neighbours' (column j cap + s for neighbour j - 1's slot s).
template <typename T>
__global__ void __launch_bounds__(P1_HALF_THREADS)
p1_count_half(const T* __restrict__ xs, const T* __restrict__ mc,
              const long long* __restrict__ cells, const long long* __restrict__ nbr,
              const T* __restrict__ box, T bmax2, const T* __restrict__ thresh, uint32_t s0,
              uint32_t s1, int cap, int chunk_x, int chunk_m, long long* __restrict__ row_counts,
              unsigned long long* __restrict__ ncalls) {
  constexpr int NT = P1_HALF_THREADS;
  __shared__ long long cid[HALF_CELLS];
  __shared__ int n_list, n_rows;
  const HalfSmem L(cap, sizeof(T));
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
  if (threadIdx.x < HALF_CELLS) {
    cid[threadIdx.x] = threadIdx.x == 0 ? cell : nbr[cell * 13 + threadIdx.x - 1];
  }
  for (int r = threadIdx.x; r < cap; r += NT) cnt[r] = 0;
  if (threadIdx.x == 0) n_list = 0, n_rows = 0;
  __syncthreads();
  // the 14 slot blocks, once, asynchronously
  stage_blocks<NT>(sx, xs, cid, HALF_CELLS, 3 * cap * sizeof(T), chunk_x);
  stage_blocks<NT>(sm, mc, cid, HALF_CELLS, cap * sizeof(T), chunk_m);
  const P1Box<T> g = p1_box(box);
  const bool all = thresh == nullptr;
  const T th = all ? T(0) : *thresh;
  cp_async_wait_all();
  __syncthreads();
  // the occupied slots as candidates; the cell's own (block 0) also as rows
  auto occupied = [&](int j, int s) { return sm[j * cap + s] > T(0.5); };
  auto put = [&](int j, int s, int k) {
    const int w = j * cap + s;
    lx[k] = sx[3 * w], ly[k] = sx[3 * w + 1], lz[k] = sx[3 * w + 2], lw[k] = w;
  };
  auto put_row = [&](int, int s, int k) {
    rows[k].x = sx[3 * s], rows[k].y = sx[3 * s + 1], rows[k].z = sx[3 * s + 2], rows[k].r = s;
  };
  compact_slots<NT>(0, HALF_CELLS, cap, &n_list, occupied, put);
  compact_slots<NT>(0, 1, cap, &n_rows, occupied, put_row);
  __syncthreads();
  // the self block strictly upper (w >= cap or w > r): each pair once
  auto hit = [&](const P1Row<T>& ra, T r2, int w, long long) {
    return ((w >= cap) | (w > ra.r)) & (r2 < bmax2);
  };
  auto draw = [&](int a, int b) {
    const int r = rows[a].r, w = lw[b];
    const uint32_t row = (uint32_t)(cell * cap + r);
    const unsigned c = (uniform_at<T>(s0, s1, row, 2 * w) < th) +
                       (uniform_at<T>(s0, s1, row, 2 * w + 1) < th);
    if (c) atomicAdd(&cnt[r], c);
  };
  const NoKey no_key;
  unsigned int* wq = queue + (threadIdx.x >> 5) * P1_QUEUE;
  unsigned int n_ok;
  if (all) {
    n_ok = sweep<NT, true>(rows, 0, n_rows, lx, ly, lz, lw, 0, n_list, g, 2u, cnt, wq, no_key,
                           hit, draw);
  } else {
    n_ok = sweep<NT, false>(rows, 0, n_rows, lx, ly, lz, lw, 0, n_list, g, 2u, cnt, wq, no_key,
                            hit, draw);
  }
  block_add<NT>(n_ok, 2ull, ncalls);  // its __syncthreads also closes the sweep
  for (int r = threadIdx.x; r < cap; r += NT) {
    row_counts[(long long)blockIdx.x * cap + r] = cnt[r];
  }
}

// xs (Cg, cap, 3) and ts (Cg, cap) of the type, aid (Cg cap) int64: the
// slot lattice; nbr (C, 27) stencil_neighbors (column STENCIL_SELF the
// cell itself).  Block c: the rows of cell c against its 27 cap ordered
// candidates, column w = j cap + s.
template <typename T>
__global__ void __launch_bounds__(P1_TYPED_THREADS)
p1_count_typed(const T* __restrict__ xs, const long long* __restrict__ aid,
               const T* __restrict__ ts, const long long* __restrict__ nbr,
               const T* __restrict__ box, T bmax2, const T* __restrict__ thresh, T t0, T t1,
               long long n_atoms, uint32_t s0, uint32_t s1, int cap, int chunk_x, int chunk_a,
               int chunk_t, long long* __restrict__ row_counts,
               unsigned long long* __restrict__ ncalls) {
  constexpr int NT = P1_TYPED_THREADS;
  __shared__ long long cid[STENCIL];
  __shared__ int n0, n1, r0n, r1n;
  const TypedSmem L(cap, sizeof(T));
  const int W = STENCIL * cap;
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
  if (threadIdx.x < STENCIL) cid[threadIdx.x] = nbr[cell * STENCIL + threadIdx.x];
  for (int r = threadIdx.x; r < cap; r += NT) cnt[r] = 0;
  if (threadIdx.x == 0) n0 = 0, n1 = 0, r0n = 0, r1n = 0;
  __syncthreads();
  // the 27 slot blocks, once, asynchronously
  stage_blocks<NT>(sx, xs, cid, STENCIL, 3 * cap * sizeof(T), chunk_x);
  stage_blocks<NT>(sa, aid, cid, STENCIL, cap * 8, chunk_a);
  stage_blocks<NT>(st, ts, cid, STENCIL, cap * sizeof(T), chunk_t);
  const P1Box<T> g = p1_box(box);
  const bool all = thresh == nullptr;
  const T th = all ? T(0) : *thresh;
  const bool one = t0 == t1;
  cp_async_wait_all();
  __syncthreads();
  // real candidates of type t0 (list 0, from the front) and, unless t0 ==
  // t1, of type t1 (list 1, from the end); the own cell's real rows of type
  // t0 (group 0, from the front) and t1 (group 1, from the end)
  auto real = [&](int j, int s) { return sa[j * cap + s] < n_atoms; };
  auto is0 = [&](int j, int s) { return real(j, s) && st[j * cap + s] == t0; };
  auto is1 = [&](int j, int s) { return !one && real(j, s) && st[j * cap + s] == t1; };
  auto put = [&](int j, int s, int k) {
    const int w = j * cap + s;
    lx[k] = sx[3 * w], ly[k] = sx[3 * w + 1], lz[k] = sx[3 * w + 2], lw[k] = w;
  };
  auto put_row = [&](int j, int s, int k) {
    const int w = j * cap + s;
    rows[k].x = sx[3 * w], rows[k].y = sx[3 * w + 1], rows[k].z = sx[3 * w + 2];
    rows[k].r = s, rows[k].aid = sa[w];
  };
  auto put_back = [&](int j, int s, int k) { put(j, s, W - 1 - k); };
  auto put_row_back = [&](int j, int s, int k) { put_row(j, s, cap - 1 - k); };
  compact_slots<NT>(0, STENCIL, cap, &n0, is0, put);
  compact_slots<NT>(0, STENCIL, cap, &n1, is1, put_back);
  compact_slots<NT>(STENCIL_SELF, 1, cap, &r0n, is0, put_row);
  compact_slots<NT>(STENCIL_SELF, 1, cap, &r1n, is1, put_row_back);
  __syncthreads();
  // the type pair matches by construction and both atoms are real: a pair
  // counts when the atoms differ and lie within bmax
  auto key = [&](int w) { return sa[w]; };  // the candidate's atom id
  auto hit = [&](const P1Row<T>& ra, T r2, int, long long ab) {
    return (r2 < bmax2) & (ab != ra.aid);
  };
  auto draw = [&](int a, int b) {
    const int r = rows[a].r;
    if (uniform_at<T>(s0, s1, (uint32_t)(cell * cap + r), lw[b]) < th) atomicAdd(&cnt[r], 1u);
  };
  unsigned int* wq = queue + (threadIdx.x >> 5) * P1_QUEUE;
  // rows of t0 against candidates of t1 and the reverse; one list when t0 == t1
  const int c0 = one ? 0 : W - n1, nc = one ? n0 : n1, r1 = one ? 0 : r1n;
  unsigned int n_ok;
  if (all) {
    n_ok = sweep<NT, true>(rows, 0, r0n, lx, ly, lz, lw, c0, nc, g, 1u, cnt, wq, key, hit, draw);
    n_ok += sweep<NT, true>(rows, cap - r1, r1, lx, ly, lz, lw, 0, n0, g, 1u, cnt, wq, key, hit,
                            draw);
  } else {
    n_ok = sweep<NT, false>(rows, 0, r0n, lx, ly, lz, lw, c0, nc, g, 1u, cnt, wq, key, hit,
                            draw);
    n_ok += sweep<NT, false>(rows, cap - r1, r1, lx, ly, lz, lw, 0, n0, g, 1u, cnt, wq, key, hit,
                             draw);
  }
  block_add<NT>(n_ok, 1ull, ncalls);
  for (int r = threadIdx.x; r < cap; r += NT) {
    row_counts[cell * cap + r] = cnt[r];
  }
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

// dynamic shared memory above the default 48 KB needs the kernel's opt-in
template <typename K>
cudaError_t allow_smem(K kernel, long long bytes) {
  if (bytes > P1_MAX_SMEM) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
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
  const long long smem = HalfSmem(cap, es).total;
  const int cx = chunk_of(xs, 3LL * cap * es), cm = chunk_of(mc, (long long)cap * es);
  if (!cx || !cm) return (int)cudaErrorMisalignedAddress;
  const long long* c = static_cast<const long long*>(cells);
  const long long* nb = static_cast<const long long*>(nbr);
  long long* rc = static_cast<long long*>(row_counts);
  unsigned long long* nc = static_cast<unsigned long long*>(ncalls);
  if (f64) {
    if ((e = allow_smem(p1_count_half<double>, smem)) != cudaSuccess) return (int)e;
    p1_count_half<double><<<B, P1_HALF_THREADS, smem, st>>>(
        static_cast<const double*>(xs), static_cast<const double*>(mc), c, nb,
        static_cast<const double*>(box), bmax2, static_cast<const double*>(thresh), s0, s1, cap,
        cx, cm, rc, nc);
  } else {
    if ((e = allow_smem(p1_count_half<float>, smem)) != cudaSuccess) return (int)e;
    p1_count_half<float><<<B, P1_HALF_THREADS, smem, st>>>(
        static_cast<const float*>(xs), static_cast<const float*>(mc), c, nb,
        static_cast<const float*>(box), (float)bmax2, static_cast<const float*>(thresh), s0, s1,
        cap, cx, cm, rc, nc);
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
  const long long smem = TypedSmem(cap, es).total;
  const int cx = chunk_of(xs, 3LL * cap * es), ca = chunk_of(aid, 8LL * cap),
            ct = chunk_of(ts, (long long)cap * es);
  if (!cx || !ca || !ct) return (int)cudaErrorMisalignedAddress;
  const long long* a = static_cast<const long long*>(aid);
  const long long* nb = static_cast<const long long*>(nbr);
  long long* rc = static_cast<long long*>(row_counts);
  unsigned long long* nc = static_cast<unsigned long long*>(ncalls);
  if (f64) {
    if ((e = allow_smem(p1_count_typed<double>, smem)) != cudaSuccess) return (int)e;
    p1_count_typed<double><<<C, P1_TYPED_THREADS, smem, st>>>(
        static_cast<const double*>(xs), a, static_cast<const double*>(ts), nb,
        static_cast<const double*>(box), bmax2, static_cast<const double*>(thresh), t0, t1,
        n_atoms, s0, s1, cap, cx, ca, ct, rc, nc);
  } else {
    if ((e = allow_smem(p1_count_typed<float>, smem)) != cudaSuccess) return (int)e;
    p1_count_typed<float><<<C, P1_TYPED_THREADS, smem, st>>>(
        static_cast<const float*>(xs), a, static_cast<const float*>(ts), nb,
        static_cast<const float*>(box), (float)bmax2, static_cast<const float*>(thresh),
        (float)t0, (float)t1, n_atoms, s0, s1, cap, cx, ca, ct, rc, nc);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
