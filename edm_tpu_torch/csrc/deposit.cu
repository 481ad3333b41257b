// 1-D periodic Gaussian-hill deposition kernels, for Hopper (sm_90a).
//
// K4  windowed  replaces edm_tpu/ops/deposit_pallas.py
//     deposit_windowed_1d_pallas (_kernel_windowed): the route for periodic
//     grids of G >= 16384 points whose hill windows are narrow (W + 256 <
//     G/2), which includes the bench's 1e6-point grid.
// K5  dense  replaces deposit_pallas.py deposit_dense_1d_pallas (_kernel):
//     every grid point against every hill, the route when the windows are
//     wide (W + 256 >= G/2).
//
// Both take the raw hill centres x_j and heights h_j and compute, on the
// grid x_i = gmin + dx * i (i < G), with the centres remapped into the grid
// (c_j = GaussGrid.remap(x_j), see dep_remap), the periodic minimum image d
// of x_i - c_j, p = d / sigma and the support mask p^2 < GAUSS_SUPPORT:
//   values[i] += sum_j h_j e_ij,  derivs[i] += sum_j h_j (-(2/sigma) p e_ij),
//   e_ij = exp(-p^2) / (sqrt(pi) sigma),
//   bias_added[j] = h_j * (dx * sum_i e_ij).
// Each sum over hills runs inside the kernel, in hill order (the TPU K5
// takes it with a matrix product in its body; the TPU K4 read-modify-writes
// hill windows into resident delta planes, one hill after another).
//
// Scheme across blocks: DETERMINISTIC, no atomics.  The TPU K4's
// read-modify-write of overlapping hill windows is race-free only because a
// Pallas grid runs in order.  Here each K4 block OWNS a tile of grid points
// and writes values + dv and derivs + dd into fresh outputs, so every point
// is read once and written once.  K4's block first compacts, per chunk of
// 256 hills and in hill order, the hills whose reach (support radius plus
// slack, in whole points around the centre's point) meets its tile, so a
// point costs the ~2 hills that cover it, not H; the per-point support mask
// decides.  A listed hill's unit integral over the block goes to a compact
// scratch (H, T): its row holds only the T tiles a hill can reach, at column
// (tile - the hill's first tile) mod blocks.  A second pass (a warp per
// hill, lanes striding over the hill's columns, one fixed shuffle tree)
// sums them.  Both passes derive a hill's tiles from the same integer
// arithmetic (dep_hill_tiles), so the second reads exactly the columns the
// first wrote.  Repeated launches are bitwise equal.
//
// K5 splits the hills too: block (tile, chunk) takes one tile of points and
// one chunk of 32 hills, lists the chunk's hills that reach the tile (K4's
// arithmetic, a warp ballot), and writes its partial sums into fresh
// partial planes of its own (chunk, tile), its per-hill partial integrals
// into K4's compact (H, T) layout, and a flag saying whether it listed any
// hill.  A block that lists none writes only its flag.  A thread keeps one
// running integral per listed hill in registers; at the end each warp
// reduces the 32 of them across its lanes at once (five exchange-and-add
// steps, lane l ending with slot l's sum) and the warps' sums are added in
// warp order.  The finishing launch adds, per point, the flagged partials
// in chunk order and then the old grid, and sums each hill's partial
// integrals as K4's second pass does.  Repeated launches are bitwise equal.
//
// The TPU K4's 128-lane windows, margins and periodic fold-back are layout
// workarounds and are gone: positions come from the wrapped point index, so
// K4 differs from the TPU kernel's unwrapped-index positions by rounding
// only.  Where a hill's reach (2 reach + 2 points) and one tile fit in the
// grid, its support radius is under G/2 points, so one image per point
// suffices and the minimum image is two comparisons: where they could
// differ from floor(d / L + 1/2) the point is out of support.  Where they
// do not (dep_wide: a hill as wide as the period, which K5's route takes),
// a hill is listed on every tile and each point takes its minimum image by
// floor(d / L + 1/2), as the plain versions and the TPU K5 do (the WIDE
// forms of both kernels); any hill width works.
//
// What bounds them (times: device time per launch in a round's profile,
// chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W).  K4 at the bench shape
// (G = 1e6, H = 200, ~8,000 support points per hill) moves 16 MB (values and
// derivs read and written once): 0.0048 ms at 3.35 TB/s, against ~0.04
// GFLOP of hill terms.  A thread owns 4 neighbouring points and moves them
// as 16 bytes per plane; the old grid's loads are started before the hills
// are listed, so they are in flight during the hill arithmetic; a hill
// writes 8 or 9 partial integrals, not one per block, and a warp sums them;
// the wrapper passes the raw centres, so a round is two launches and no
// other PyTorch call.  0.0110 ms: the tile pass 0.0090 (1.8 TB/s), the
// integrals 0.0019 (0.0301 before the redesign: tile pass 0.0104, and
// 0.0196 for a thread per hill adding 977 per-block partials one after
// another).  Forcing 6 or 8 blocks per SM with __launch_bounds__ spills
// and reads 0.0115-0.0118 for the tile pass; the 64 registers it takes
// unforced (4 blocks per SM) are the fastest tried.
// K5 at G = 32,768 and H = 200 does G x H = 6.6 M point-hill distances:
// bound by operations (0.0013 ms).  Before its redesign it ran K4's body
// with every hill listed, one point a thread: 128 blocks (under one per
// SM), each thread through all 200 hills one after another with a
// five-shuffle warp sum per hill, 0.0392 ms.  The (tile, chunk) grid puts
// 448 blocks on the card at once, a block lists only the hills that reach
// its tile (~42% at this shape), and the per-hill warp sums become one
// 31-shuffle exchange per warp.  The terms are branch-free (a point out of
// support adds exact zeros) and multiply by 1/sigma, so a thread's points
// interleave.  Points per thread, measured (temporary builds, one process
// each, device us per round, tiles + finish): 1: 8.0 + 2.3, 2: 6.7 + 2.1,
// 4: 7.1 + 2.1.  On the way: the same grid with branches and a true
// division per term 11.7 + 3.5; with the 32 running integrals in local
// memory (a reduction loop whose bounds were not constants) 20-23 + 5-6.
//
// Plain C interface, loaded with ctypes; every launch goes on the caller's
// stream and the entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int DEP_THREADS = 256;
constexpr int DEP_WARPS = DEP_THREADS / 32;
constexpr int DEP_CHUNK = DEP_THREADS;  // hills listed per round
constexpr int K4_PPT = 4;  // neighbouring grid points per thread, windowed: 16-byte accesses
constexpr int K5_PPT = 2;  // neighbouring grid points per thread, dense (measured, below)
constexpr int K5_HC = 32;  // hills per chunk: one warp's ballot lists them
constexpr float SUPPORT = 8.0f;  // GAUSS_SUPPORT + 1e-12 rounded to f32

struct DepParams {
  float gmin, gmax, dx, L, sigma, inv_denom, k2;  // k2 = -(2 / sigma)
  float inv_sigma;  // 1 / sigma (K5 multiplies by it)
  int reach;  // support radius in whole grid points plus slack (the hill lists)
  int T;  // columns of a hill's row of partial integrals
};

// Whether a hill's reach, 2 reach + 2 points, together with one tile can
// span the whole grid (the route's tile, the grid's G points): then a hill
// is listed on every tile, and the points take the minimum image by
// floor(d / L + 1/2), as the plain versions do, since more than half the
// period may lie in a hill's support.
__host__ __device__ inline bool dep_wide(int reach, int tile, int G) {
  return 2L * reach + 2 + tile > G;
}

// The periodic minimum image of d = x_i - c_j (both in [gmin, gmax]).  With
// a support radius under L/2 (WIDE false) two comparisons suffice: where
// they could differ from floor(d / L + 1/2) the point is out of support.
template <bool WIDE>
__device__ __forceinline__ float dep_mimage(float dpd, float half_L, float L) {
  if (WIDE) return dpd - floorf(dpd / L + 0.5f) * L;
  return dpd >= half_L ? dpd - L : (dpd < -half_L ? dpd + L : dpd);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// GaussGrid.remap for a 1-D periodic grid and boundary, the same float32
// operations in the same order: x inside [gmin, gmax] stays, any other is
// wrapped by whole periods.
__device__ __forceinline__ float dep_remap(float x, const DepParams& p) {
  if (x < p.gmin || x > p.gmax) {
    const float Lg = p.gmax - p.gmin;
    x = x - Lg * floorf((x - p.gmin) / Lg);
  }
  return x;
}

// The tiles of `tile` points that the reach of a hill at the remapped
// centre c meets, as (first tile, count): the points ic - reach ..
// ic + 1 + reach around the centre's point ic, wrapped into [0, G); where
// the reach and a tile span the grid (dep_wide) every tile from tile 0,
// else the range never meets itself.  count <= T.
__device__ __forceinline__ int2 dep_hill_tiles(float c, const DepParams& p, int G, int tile,
                                               int n_blocks) {
  if (dep_wide(p.reach, tile, G)) return make_int2(0, min(n_blocks, p.T));
  int ic = (int)floorf((c - p.gmin) / p.dx) % G;
  if (ic < 0) ic += G;
  int lo = ic - p.reach, hi = ic + 1 + p.reach;
  if (lo < 0) lo += G;
  if (hi >= G) hi -= G;
  const int first = lo / tile;
  int count = hi / tile - first;
  if (count < 0) count += n_blocks;
  return make_int2(first, min(count + 1, p.T));
}

// A thread's PPT neighbouring points from i0 of a plane: 16 bytes at once
// when PPT is 4 and all four are on the grid (i0 is a multiple of 4 and the
// plane 16-byte aligned), else one by one, masked at the ragged end.
template <int PPT>
__device__ __forceinline__ void dep_load(const float* __restrict__ src, int i0, int G,
                                         float (&v)[PPT]) {
  if constexpr (PPT == 4) {
    if (i0 + 4 <= G) {
      const float4 w = *reinterpret_cast<const float4*>(src + i0);
      v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
      return;
    }
  }
#pragma unroll
  for (int q = 0; q < PPT; ++q) v[q] = i0 + q < G ? src[i0 + q] : 0.0f;
}

template <int PPT>
__device__ __forceinline__ void dep_store(float* __restrict__ dst, int i0, int G,
                                          const float (&v)[PPT]) {
  if constexpr (PPT == 4) {
    if (i0 + 4 <= G) {
      *reinterpret_cast<float4*>(dst + i0) = make_float4(v[0], v[1], v[2], v[3]);
      return;
    }
  }
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    if (i0 + q < G) dst[i0 + q] = v[q];
  }
}

// K4: one block per tile of PPT * DEP_THREADS points; thread t owns the PPT
// neighbouring points from tile start + PPT * t.  WIDE: dep_wide.
template <int PPT, bool WIDE>
__global__ void __launch_bounds__(DEP_THREADS)
dep_tiles(const float* __restrict__ values, const float* __restrict__ derivs,
          const float* __restrict__ centers, const float* __restrict__ heights,
          float* __restrict__ out_v, float* __restrict__ out_d, float* __restrict__ part,
          int H, int G, DepParams p) {
  __shared__ float sc[DEP_CHUNK], sh[DEP_CHUNK];
  __shared__ int sat[DEP_CHUNK];  // where in `part` a listed hill's integral goes
  __shared__ float red[DEP_WARPS][DEP_CHUNK];
  __shared__ int wcount[DEP_WARPS];

  constexpr int TILE = PPT * DEP_THREADS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = blockIdx.x * TILE + PPT * tid;
  // the old grid first: these loads are in flight while the hills are
  // listed and evaluated
  float ov[PPT], od[PPT];
  dep_load<PPT>(values, i0, G, ov);
  dep_load<PPT>(derivs, i0, G, od);
  float xx[PPT], dv[PPT], dd[PPT];
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    xx[q] = p.gmin + p.dx * (float)(i0 + q);
    dv[q] = 0.0f;
    dd[q] = 0.0f;
  }
  const float half_L = 0.5f * p.L;

  for (int h0 = 0; h0 < H; h0 += DEP_CHUNK) {
    // 1. list this chunk's hills that reach the tile, in hill order
    const int j = h0 + tid;
    bool take = j < H;
    float c = 0.0f, h = 0.0f;
    int col = blockIdx.x;
    if (take) {
      c = dep_remap(centers[j], p);
      h = heights[j];
      const int2 t = dep_hill_tiles(c, p, G, TILE, gridDim.x);
      col -= t.x;
      if (col < 0) col += gridDim.x;
      take = col < t.y;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, take);
    if (lane == 0) wcount[warp] = __popc(bal);
    __syncthreads();
    int off = 0, n = 0;
#pragma unroll
    for (int w = 0; w < DEP_WARPS; ++w) {
      off += (w < warp) ? wcount[w] : 0;
      n += wcount[w];
    }
    if (take) {
      const int slot = off + __popc(bal & ((1u << lane) - 1u));
      sc[slot] = c;
      sh[slot] = h;
      sat[slot] = j * p.T + col;
    }
    __syncthreads();

    // 2. the listed hills on the tile's points, in order
    for (int l = 0; l < n; ++l) {
      const float cl = sc[l], hl = sh[l];
      float s = 0.0f;
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        if (i0 + q >= G) continue;
        const float dpd = dep_mimage<WIDE>(xx[q] - cl, half_L, p.L);
        const float dp = dpd / p.sigma;
        const float dp2 = dp * dp;
        if (dp2 < SUPPORT) {
          const float e = expf(-dp2) * p.inv_denom;
          dv[q] += hl * e;
          dd[q] += hl * (p.k2 * dp * e);
          s += e;
        }
      }
      s = warp_sum(s);
      if (lane == 0) red[warp][l] = s;
    }
    __syncthreads();

    // 3. the block's unit integral of each listed hill, warps in order
    for (int l = tid; l < n; l += DEP_THREADS) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < DEP_WARPS; ++w) s += red[w][l];
      part[sat[l]] = s;
    }
    __syncthreads();  // the lists are rebuilt by the next chunk
  }

#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    ov[q] += dv[q];
    od[q] += dd[q];
  }
  dep_store<PPT>(out_v, i0, G, ov);
  dep_store<PPT>(out_d, i0, G, od);
}

// bias_added[j] = h_j * (dx * the sum of hill j's partial integrals): a warp
// per hill, lane l adds columns l, l + 32, ... of the hill's row in order,
// then one fixed shuffle tree.
__device__ __forceinline__ void dep_hill_integral(
    int j, int lane, const float* __restrict__ centers, const float* __restrict__ heights,
    const float* __restrict__ part, float* __restrict__ bias_added, int G, int tile,
    int n_blocks, const DepParams& p) {
  const int count = dep_hill_tiles(dep_remap(centers[j], p), p, G, tile, n_blocks).y;
  const float* row = part + (long)j * p.T;
  float s = 0.0f;
  for (int t = lane; t < count; t += 32) s += row[t];
  s = warp_sum(s);
  if (lane == 0) bias_added[j] = heights[j] * (s * p.dx);
}

__global__ void __launch_bounds__(DEP_THREADS)
dep_bias_added(const float* __restrict__ centers, const float* __restrict__ heights,
               const float* __restrict__ part, float* __restrict__ bias_added, int H, int G,
               int tile, int n_blocks, DepParams p) {
  const int j = blockIdx.x * DEP_WARPS + (threadIdx.x >> 5);
  if (j >= H) return;
  dep_hill_integral(j, threadIdx.x & 31, centers, heights, part, bias_added, G, tile, n_blocks,
                    p);
}

// One step of the exchange that reduces K5_HC running sums across a warp's
// lanes at once: a lane keeps the half of its first 2 HALF slots that its
// lane bit HALF selects and adds its partner's copy of them.  The slot
// indices are compile-time constants, so the sums stay in registers.
template <int HALF>
__device__ __forceinline__ void dep_exchange(float (&s)[K5_HC], int lane) {
  const bool up = (lane & HALF) != 0;
#pragma unroll
  for (int k = 0; k < HALF; ++k) {
    const float send = up ? s[k] : s[k + HALF];
    const float keep = up ? s[k + HALF] : s[k];
    s[k] = keep + __shfl_xor_sync(0xffffffffu, send, HALF);
  }
}

// K5, pass 1: block (tile, chunk); thread t owns the K5_PPT neighbouring
// points from tile start + K5_PPT * t.  Writes the block's partial planes
// (dv at planes + chunk * 2 Gp, dd Gp further), the listed hills' partial
// integrals, and live[chunk * tiles + tile].  WIDE: dep_wide.
template <bool WIDE>
__global__ void __launch_bounds__(DEP_THREADS)
dep_dense_tiles(const float* __restrict__ centers, const float* __restrict__ heights,
                float* __restrict__ part, float* __restrict__ planes, int* __restrict__ live,
                int H, int G, int Gp, DepParams p) {
  __shared__ float sc[K5_HC], sh[K5_HC];
  __shared__ int sat[K5_HC];
  __shared__ int sn;
  __shared__ float red[DEP_WARPS][K5_HC];

  constexpr int TILE = K5_PPT * DEP_THREADS;
  const int tile = blockIdx.x, chunk = blockIdx.y, n_tiles = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (warp == 0) {  // list the chunk's hills that reach the tile, in hill order
    const int j = chunk * K5_HC + lane;
    bool take = j < H;
    float c = 0.0f, h = 0.0f;
    int col = tile;
    if (take) {
      c = dep_remap(centers[j], p);
      h = heights[j];
      const int2 t = dep_hill_tiles(c, p, G, TILE, n_tiles);
      col -= t.x;
      if (col < 0) col += n_tiles;
      take = col < t.y;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, take);
    if (take) {
      const int slot = __popc(bal & ((1u << lane) - 1u));
      sc[slot] = c;
      sh[slot] = h;
      sat[slot] = j * p.T + col;
    }
    if (lane == 0) {
      sn = __popc(bal);
      live[chunk * n_tiles + tile] = bal != 0u;
    }
  }
  __syncthreads();
  const int n = sn;
  if (n == 0) return;

  const int i0 = tile * TILE + K5_PPT * tid;
  float xx[K5_PPT], dv[K5_PPT], dd[K5_PPT], s[K5_HC];
#pragma unroll
  for (int q = 0; q < K5_PPT; ++q) {
    xx[q] = p.gmin + p.dx * (float)(i0 + q);
    dv[q] = 0.0f;
    dd[q] = 0.0f;
  }
  const float half_L = 0.5f * p.L;
  // branch-free terms: a point out of support (or past the grid) adds exact
  // zeros, so the PPT chains of a hill interleave
#pragma unroll
  for (int l = 0; l < K5_HC; ++l) {
    s[l] = 0.0f;
    if (l < n) {  // the same n in every thread of the block
      const float cl = sc[l], hl = sh[l];
#pragma unroll
      for (int q = 0; q < K5_PPT; ++q) {
        const float dpd = dep_mimage<WIDE>(xx[q] - cl, half_L, p.L);
        const float dp = dpd * p.inv_sigma;
        const float dp2 = dp * dp;
        const float ex = expf(-dp2);
        const float e = (dp2 < SUPPORT && i0 + q < G) ? ex * p.inv_denom : 0.0f;
        dv[q] += hl * e;
        dd[q] += hl * (p.k2 * dp * e);
        s[l] += e;
      }
    }
  }
  // each warp's 32 running integrals across its lanes at once: lane l ends
  // with the warp's sum for slot l
  dep_exchange<16>(s, lane);
  dep_exchange<8>(s, lane);
  dep_exchange<4>(s, lane);
  dep_exchange<2>(s, lane);
  dep_exchange<1>(s, lane);
  red[warp][lane] = s[0];
  float* pv = planes + (long)chunk * 2 * Gp;
  dep_store<K5_PPT>(pv, i0, G, dv);
  dep_store<K5_PPT>(pv + Gp, i0, G, dd);
  __syncthreads();
  if (tid < n) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < DEP_WARPS; ++w) t += red[w][tid];
    part[sat[tid]] = t;
  }
}

// K5, pass 2: blocks below point_blocks finish a point a thread (the
// flagged partials in chunk order, then the old grid); the rest run a warp
// per hill for bias_added.
__global__ void __launch_bounds__(DEP_THREADS)
dep_dense_finish(const float* __restrict__ values, const float* __restrict__ derivs,
                 const float* __restrict__ centers, const float* __restrict__ heights,
                 const float* __restrict__ part, const float* __restrict__ planes,
                 const int* __restrict__ live, float* __restrict__ out_v,
                 float* __restrict__ out_d, float* __restrict__ bias_added, int H, int G, int Gp,
                 int n_tiles, int n_chunks, int point_blocks, DepParams p) {
  constexpr int TILE = K5_PPT * DEP_THREADS;
  if ((int)blockIdx.x >= point_blocks) {
    const int j = (blockIdx.x - point_blocks) * DEP_WARPS + (threadIdx.x >> 5);
    if (j < H)
      dep_hill_integral(j, threadIdx.x & 31, centers, heights, part, bias_added, G, TILE,
                        n_tiles, p);
    return;
  }
  const int i = blockIdx.x * DEP_THREADS + threadIdx.x;
  if (i >= G) return;
  const int tile = i / TILE;
  const float ov = values[i], od = derivs[i];
  float av = 0.0f, ad = 0.0f;
  // 8 chunks at a time: every flag and plane load of the group is issued
  // before the first add (a plane that its block did not write is read but
  // not added)
  constexpr int GROUP = 8;
  for (int c0 = 0; c0 < n_chunks; c0 += GROUP) {
    float v[GROUP], d[GROUP];
    bool f[GROUP];
#pragma unroll
    for (int k = 0; k < GROUP; ++k) {
      const int c = c0 + k < n_chunks ? c0 + k : 0;
      f[k] = c0 + k < n_chunks && live[c * n_tiles + tile];
      v[k] = planes[(long)c * 2 * Gp + i];
      d[k] = planes[(long)c * 2 * Gp + Gp + i];
    }
#pragma unroll
    for (int k = 0; k < GROUP; ++k) {
      av += f[k] ? v[k] : 0.0f;
      ad += f[k] ? d[k] : 0.0f;
    }
  }
  out_v[i] = ov + av;
  out_d[i] = od + ad;
}

// the K5 scratch: (H, T) partial integrals, then from a 16-byte boundary
// the (chunks, 2, Gp) partial planes, then (chunks, tiles) flags
struct DenseScratch {
  long part, planes, live, total;  // offsets and size, in floats
};

__host__ __device__ inline DenseScratch dense_scratch(int H, int G, int T) {
  constexpr int TILE = K5_PPT * DEP_THREADS;
  const long n_tiles = (G + TILE - 1) / TILE, n_chunks = (H + K5_HC - 1) / K5_HC;
  const long Gp = (G + 3) / 4 * 4;
  DenseScratch d;
  d.part = 0;
  d.planes = ((long)H * T + 3) / 4 * 4;
  d.live = d.planes + n_chunks * 2 * Gp;
  d.total = d.live + n_chunks * n_tiles;
  return d;
}

cudaError_t dep_windowed_launch(const float* values, const float* derivs, const float* centers,
                                const float* heights, float* out_v, float* out_d,
                                float* bias_added, float* part, int H, int G, const DepParams& p,
                                cudaStream_t st) {
  constexpr int TILE = K4_PPT * DEP_THREADS;
  const int n_blocks = (G + TILE - 1) / TILE;
  if (p.T < 1) return cudaErrorInvalidValue;
  auto kern = dep_wide(p.reach, TILE, G) ? dep_tiles<K4_PPT, true> : dep_tiles<K4_PPT, false>;
  kern<<<n_blocks, DEP_THREADS, 0, st>>>(values, derivs, centers, heights, out_v, out_d, part, H,
                                         G, p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || H == 0) return e;
  dep_bias_added<<<(H + DEP_WARPS - 1) / DEP_WARPS, DEP_THREADS, 0, st>>>(
      centers, heights, part, bias_added, H, G, TILE, n_blocks, p);
  return cudaGetLastError();
}

cudaError_t dep_dense_launch(const float* values, const float* derivs, const float* centers,
                             const float* heights, float* out_v, float* out_d,
                             float* bias_added, float* scratch, int H, int G,
                             const DepParams& p, cudaStream_t st) {
  constexpr int TILE = K5_PPT * DEP_THREADS;
  const int n_tiles = (G + TILE - 1) / TILE, n_chunks = (H + K5_HC - 1) / K5_HC;
  const int Gp = (G + 3) / 4 * 4;
  if (p.T < 1 || n_chunks > 65535) return cudaErrorInvalidValue;
  const DenseScratch d = dense_scratch(H, G, p.T);
  int* live = reinterpret_cast<int*>(scratch + d.live);
  if (H > 0) {
    auto kern = dep_wide(p.reach, TILE, G) ? dep_dense_tiles<true> : dep_dense_tiles<false>;
    kern<<<dim3(n_tiles, n_chunks), DEP_THREADS, 0, st>>>(
        centers, heights, scratch + d.part, scratch + d.planes, live, H, G, Gp, p);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const int point_blocks = (G + DEP_THREADS - 1) / DEP_THREADS;
  const int hill_blocks = (H + DEP_WARPS - 1) / DEP_WARPS;
  dep_dense_finish<<<point_blocks + hill_blocks, DEP_THREADS, 0, st>>>(
      values, derivs, centers, heights, scratch + d.part, scratch + d.planes, live, out_v,
      out_d, bias_added, H, G, Gp, n_tiles, n_chunks, point_blocks, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// grid points per block: the wrapper sizes a hill's row of partials with it
int edm_deposit_tile(int windowed) {
  return (windowed ? K4_PPT : K5_PPT) * DEP_THREADS;
}

// floats of scratch a launch takes: the (H, T) partial integrals, and for
// the dense route its partial planes and flags
long long edm_deposit_scratch(int windowed, int H, int G, int T) {
  return windowed ? (long long)H * T : (long long)dense_scratch(H, G, T).total;
}

// centers, heights: the raw hills (H,); geom = {gmin, gmax, dx, L, sigma,
// 1/(sqrt(pi) sigma), -(2/sigma)} (f32); reach: the support radius in whole
// points plus slack; T: the tiles a hill's reach can meet; scratch:
// edm_deposit_scratch floats, 16-byte aligned; values and derivs, old and
// new, 16-byte aligned
int deposit_1d_launch(const float* values, const float* derivs, const float* centers,
                      const float* heights, float* out_v, float* out_d, float* bias_added,
                      float* scratch, int H, int G, const float* geom, int reach, int T,
                      int windowed, void* stream) {
  if (G <= 0 || H < 0 || reach < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  DepParams p{geom[0], geom[1], geom[2], geom[3], geom[4], geom[5], geom[6],
              (float)(1.0 / (double)geom[4]), reach, T};
  cudaError_t e =
      windowed ? dep_windowed_launch(values, derivs, centers, heights, out_v, out_d,
                                     bias_added, scratch, H, G, p, st)
               : dep_dense_launch(values, derivs, centers, heights, out_v, out_d, bias_added,
                                  scratch, H, G, p, st);
  return (int)e;
}

}  // extern "C"
