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
// Both compute, for remapped hill centres c_j and heights h_j on the grid
// x_i = gmin + dx * i (i < G), with the periodic minimum image
// d = (x_i - c_j) - floor((x_i - c_j) / L + 1/2) L, p = d / sigma and the
// support mask p^2 < GAUSS_SUPPORT:
//   values[i] += sum_j h_j e_ij,  derivs[i] += sum_j h_j (-(2/sigma) p e_ij),
//   e_ij = exp(-p^2) / (sqrt(pi) sigma),
//   bias_added[j] = h_j * (dx * sum_i e_ij).
// Each sum over hills runs inside the kernel, in hill order (the TPU K5
// takes it with a matrix product in its body; the TPU K4 read-modify-writes
// hill windows into resident delta planes, one hill after another).
//
// Scheme across blocks: DETERMINISTIC, no atomics.  The TPU K4's
// read-modify-write of overlapping hill windows is race-free only because a
// Pallas grid runs in order.  Here each block OWNS a tile of grid points
// and writes values + dv and derivs + dd into fresh outputs, so every point
// is read once and written once.  K4's block first compacts, per chunk of
// 256 hills and in hill order, the hills whose support can reach its tile
// (a conservative test in index units; the per-point support mask decides),
// so a point costs the ~2 hills that cover it, not H.  K5 lists every hill.
// The per-hill unit integrals of a block go to a (blocks, H) scratch (0 for
// hills that miss the tile), summed over blocks in block order by a second
// pass.  Repeated launches are bitwise equal.
//
// The TPU K4's 128-lane windows, margins and periodic fold-back are layout
// workarounds and are gone: positions come from the wrapped point index, so
// K4 differs from the TPU kernel's unwrapped-index positions by rounding
// only.  The route guarantees W + 256 < G/2, so one image per point
// suffices.
//
// Bound: K4 at the bench shape (G = 1e6, H = 200, ~8,000 support points per
// hill) moves 16 MB (values and derivs read and written once): ~5 us at
// 3.35 TB/s, against ~0.05 GFLOP of hill terms.  K5 at G = 32,768 and
// H = 200 does G x H = 6.6 M point-hill distances: bound by operations.
//
// Plain C interface, loaded with ctypes; every launch goes on the caller's
// stream and the entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int DEP_THREADS = 256;
constexpr int DEP_WARPS = DEP_THREADS / 32;
constexpr int DEP_CHUNK = DEP_THREADS;  // hills listed per round
constexpr int K4_PPT = 4;  // grid points per thread, windowed
constexpr int K5_PPT = 1;  // grid points per thread, dense
constexpr float SUPPORT = 8.0f;  // GAUSS_SUPPORT + 1e-12 rounded to f32

struct DepParams {
  float gmin, dx, L, sigma, inv_denom, k2;  // k2 = -(2 / sigma)
  float reach;  // support radius in grid points plus slack (K4's list test)
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <bool WINDOWED, int PPT>
__global__ void __launch_bounds__(DEP_THREADS)
dep_tiles(const float* __restrict__ values, const float* __restrict__ derivs,
          const float* __restrict__ centers, const float* __restrict__ heights,
          float* __restrict__ out_v, float* __restrict__ out_d, float* __restrict__ part,
          int H, int G, DepParams p) {
  __shared__ float sc[DEP_CHUNK], sh[DEP_CHUNK];
  __shared__ int sid[DEP_CHUNK];
  __shared__ float red[DEP_WARPS][DEP_CHUNK];
  __shared__ int wcount[DEP_WARPS];

  constexpr int TILE = PPT * DEP_THREADS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = blockIdx.x * TILE;
  float xx[PPT], dv[PPT], dd[PPT];
  bool in[PPT];
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const int i = i0 + q * DEP_THREADS + tid;
    in[q] = i < G;
    xx[q] = p.gmin + p.dx * (float)i;
    dv[q] = 0.0f;
    dd[q] = 0.0f;
  }
  const float half_tile = 0.5f * (float)(TILE - 1);
  const float mid = (float)i0 + half_tile;

  for (int h0 = 0; h0 < H; h0 += DEP_CHUNK) {
    // 1. list this chunk's hills that may touch the tile, in hill order
    const int j = h0 + tid;
    bool take = j < H;
    float c = 0.0f, h = 0.0f;
    if (take) {
      c = centers[j];
      h = heights[j];
      if (WINDOWED) {
        float d = (c - p.gmin) / p.dx - mid;  // centre to tile middle, points
        d -= (float)G * floorf(d / (float)G + 0.5f);
        take = fabsf(d) <= half_tile + p.reach;
      }
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
      sid[slot] = j;
    } else if (j < H) {
      part[(long)blockIdx.x * H + j] = 0.0f;  // misses the tile
    }
    __syncthreads();

    // 2. the listed hills on the tile's points, in order
    for (int l = 0; l < n; ++l) {
      const float cl = sc[l], hl = sh[l];
      float s = 0.0f;
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        if (!in[q]) continue;
        float dpd = xx[q] - cl;
        dpd = dpd - floorf(dpd / p.L + 0.5f) * p.L;
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
      part[(long)blockIdx.x * H + sid[l]] = s;
    }
    __syncthreads();  // the lists are rebuilt by the next chunk
  }

#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    if (!in[q]) continue;
    const int i = i0 + q * DEP_THREADS + tid;
    out_v[i] = values[i] + dv[q];
    out_d[i] = derivs[i] + dd[q];
  }
}

// bias_added[j] = h_j * (dx * sum over blocks of part[b][j]), blocks in order
__global__ void dep_bias_added(const float* __restrict__ heights,
                               const float* __restrict__ part, float* __restrict__ bias_added,
                               int H, int n_blocks, float dx) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= H) return;
  float s = 0.0f;
  for (int b = 0; b < n_blocks; ++b) s += part[(long)b * H + j];
  bias_added[j] = heights[j] * (s * dx);
}

template <bool WINDOWED, int PPT>
cudaError_t dep_launch(const float* values, const float* derivs, const float* centers,
                       const float* heights, float* out_v, float* out_d, float* bias_added,
                       float* part, int H, int G, const DepParams& p, cudaStream_t st) {
  const int n_blocks = (G + PPT * DEP_THREADS - 1) / (PPT * DEP_THREADS);
  dep_tiles<WINDOWED, PPT><<<n_blocks, DEP_THREADS, 0, st>>>(values, derivs, centers, heights,
                                                             out_v, out_d, part, H, G, p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || H == 0) return e;
  dep_bias_added<<<(H + 255) / 256, 256, 0, st>>>(heights, part, bias_added, H, n_blocks, p.dx);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// grid points per block: the wrapper sizes the (blocks, H) partials with it
int edm_deposit_tile(int windowed) {
  return (windowed ? K4_PPT : K5_PPT) * DEP_THREADS;
}

// geom = {gmin, dx, L, sigma, 1/(sqrt(pi) sigma), -(2/sigma), reach} (f32);
// part: (ceil(G / tile), H) scratch
int deposit_1d_launch(const float* values, const float* derivs, const float* centers,
                      const float* heights, float* out_v, float* out_d, float* bias_added,
                      float* part, int H, int G, const float* geom, int windowed,
                      void* stream) {
  if (G <= 0 || H < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  DepParams p{geom[0], geom[1], geom[2], geom[3], geom[4], geom[5], geom[6]};
  cudaError_t e =
      windowed ? dep_launch<true, K4_PPT>(values, derivs, centers, heights, out_v, out_d,
                                          bias_added, part, H, G, p, st)
               : dep_launch<false, K5_PPT>(values, derivs, centers, heights, out_v, out_d,
                                           bias_added, part, H, G, p, st);
  return (int)e;
}

}  // extern "C"
