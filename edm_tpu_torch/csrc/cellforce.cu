// Cell-pair force kernels of the pairwise-EDM cell host, for Hopper (sm_90a).
//
// K1  cell_force_newton  replaces edm_tpu/ops/cellforce_pallas.py
//     cell_forces_pallas_newton_rescredit (_kernel_newton_rc with the
//     _hermite_val_der fetch).  Half-stencil Newton pass: each cell's k
//     slots are paired with its own k slots and with the k slots of its 13
//     lexicographically positive neighbour cells; per pair the minimum image,
//     truncated LJ and the CV bias derivative from the exact cubic-Hermite
//     table (the value too on energy steps).  Row sums go to the own rows,
//     Newton credits to the neighbours' rows.
//
//     Credits are DETERMINISTIC: the TPU kernel read-modify-writes its
//     neighbours' rows in place, which is race-free only because a Pallas
//     grid runs in order.  Here pass 1 (one block per cell) writes its own
//     row sums into f and its column sums into a per-offset credit scratch
//     (C, 13, k, 3); pass 2 (one thread per slot) subtracts the 13 incoming
//     credits in a fixed offset order.  No atomics: a run repeats bitwise.
//
//     Bound: at the 10k bench shape (729 cells x k = 24 rows x 14k = 336
//     candidates: 5.9 M pair evaluations, ~60 flops each) the pass is far
//     from the card's compute and memory limits; its cost is latency (one
//     wave of 729 small blocks, per-row reductions).  Measured 0.067 ms per
//     call at k = 24 (NVIDIA H100 80GB HBM3, 700 W).  The design keeps all
//     pair work in registers and shared memory: candidates are gathered
//     straight from the slot lattice (no (Cg, 39k) planar view in device
//     memory), the G x 4 Hermite table sits in shared memory and the fetch
//     is one indexed float4 load.
//
// K2  overflow_force  replaces edm_tpu/ops/cellforce_pallas.py
//     overflow_forces_pallas (_kernel_overflow).  Dense sweep of the
//     compacted tail atoms (slots >= kernel_cap) against every placed low
//     slot with K1's pair math.  Pass 1: one block per tile of 256
//     partners, one thread per partner; each thread owns its partner's
//     credit (no atomics) and the block writes per-tile partial tail-row
//     sums.  Pass 2: one block sums the tiles in a fixed order and adds the
//     tail-tail block (diagonal masked, `own` rows, energy halved).
//     Bound: 0.57 M pair evaluations at 10k (32 tail rows x 17,664
//     partners): latency, like K1.  Measured 0.041 ms per call (NVIDIA H100
//     80GB HBM3, 700 W).
//
// Plain C interface, loaded with ctypes; every launch goes on the caller's
// stream and each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int K1_THREADS = 128;
constexpr int K1_WARPS = K1_THREADS / 32;
constexpr int MAX_K = 64;
constexpr int MAX_W = 14 * MAX_K;
constexpr int MAX_COLS = (MAX_W + K1_THREADS - 1) / K1_THREADS;
constexpr int MAX_G = 1024;
constexpr int K2_THREADS = 256;
constexpr int K2_WARPS = K2_THREADS / 32;
constexpr int MAX_O = 128;

// HALF_OFFSETS order: the 13 offsets (dx, dy, dz) > (0, 0, 0) lexicographically
__constant__ int HALF_OFF[13][3] = {
    {0, 0, 1},   {0, 1, -1},  {0, 1, 0},  {0, 1, 1}, {1, -1, -1},
    {1, -1, 0},  {1, -1, 1},  {1, 0, -1}, {1, 0, 0}, {1, 0, 1},
    {1, 1, -1},  {1, 1, 0},   {1, 1, 1}};

struct PairParams {
  float L[3], iL[3];  // box and its f32 reciprocal (minimum image)
  float four_eps, sig2, rcut;  // LJ
  int G;  // Hermite table rows
  float glo, gdx, ghi, blo, bhi;  // lookup geometry (grid dtype, f32)
};

__device__ __forceinline__ float mimage(float d, float L, float iL) {
  return d - floorf(d * iL + 0.5f) * L;
}

// One unmasked pair (row atom a, partner b): g = force on a (the partner
// gets -g); val only when ENERGY.  Mirrors _kernel_newton_rc:604-654 and
// _hermite_val_der:224-274.
template <bool ENERGY>
__device__ __forceinline__ void pair_force(const PairParams& p, const float4* tab,
                                           float4 a, float4 b, float& gx, float& gy,
                                           float& gz, float& val) {
  float dx = mimage(a.x - b.x, p.L[0], p.iL[0]);
  float dy = mimage(a.y - b.y, p.L[1], p.iL[1]);
  float dz = mimage(a.z - b.z, p.L[2], p.iL[2]);
  float r2 = dx * dx + dy * dy + dz * dz;
  float r2s = fmaxf(r2, 1e-12f);
  float inv_r = rsqrtf(r2s);
  float r = r2s * inv_r;
  float inv_r2 = inv_r * inv_r;
  float fmag = 0.0f;
  if (r < p.rcut) {
    float sr2 = p.sig2 * inv_r2;
    float sr6 = sr2 * sr2 * sr2;
    fmag = p.four_eps * (12.0f * sr6 * sr6 - 6.0f * sr6) * inv_r2;
  }
  float der = 0.0f;
  val = 0.0f;
  if (r >= p.blo && r <= p.bhi && r >= p.glo && r < p.ghi) {
    float idxf = fminf(fmaxf(floorf((r - p.glo) / p.gdx), 0.0f), (float)(p.G - 1));
    float t = (r - p.glo - idxf * p.gdx) / p.gdx;
    float4 c = tab[(int)idxf];
    der = c.y + t * (c.z + t * c.w);
    if (ENERGY) {
      val = c.x + (t * p.gdx) * (c.y + t * (0.5f * c.z + (1.0f / 3.0f) * (t * c.w)));
    }
  }
  float f_over_r = fmag - der * inv_r;
  gx = f_over_r * dx;
  gy = f_over_r * dy;
  gz = f_over_r * dz;
}

__device__ __forceinline__ float warp_sum(float v) {
  // butterfly: every lane ends with the same sum, in a fixed order
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------- K1

template <bool ENERGY>
__global__ void __launch_bounds__(K1_THREADS)
k1_rows(const float* __restrict__ xs, const float* __restrict__ mc,
        const float* __restrict__ table, float* __restrict__ f,
        float* __restrict__ eb, float* __restrict__ cred, int cap, int k,
        int nx, int ny, int nz, PairParams p) {
  __shared__ float4 cand[MAX_W];  // x, y, z, mask: self block then 13 neighbours
  __shared__ float4 tab[MAX_G];
  __shared__ float red[K1_WARPS][MAX_K][4];

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int W = 14 * k;
  const int ix = c / (ny * nz), iy = (c / nz) % ny, iz = c % nz;

  for (int g = tid; g < p.G; g += K1_THREADS)
    tab[g] = reinterpret_cast<const float4*>(table)[g];
  for (int j = tid; j < W; j += K1_THREADS) {
    int cell = c, s = j;
    if (j >= k) {
      int o = (j - k) / k;
      s = (j - k) - o * k;
      cell = ((ix + HALF_OFF[o][0] + nx) % nx) * (ny * nz) +
             ((iy + HALF_OFF[o][1] + ny) % ny) * nz + ((iz + HALF_OFF[o][2] + nz) % nz);
    }
    const long slot = (long)cell * cap + s;
    cand[j] = make_float4(xs[3 * slot], xs[3 * slot + 1], xs[3 * slot + 2], mc[slot]);
  }
  __syncthreads();

  float cr[MAX_COLS][3];
#pragma unroll
  for (int q = 0; q < MAX_COLS; ++q) cr[q][0] = cr[q][1] = cr[q][2] = 0.0f;

  for (int i = 0; i < k; ++i) {
    const float4 a = cand[i];
    if (a.w <= 0.5f) continue;  // uniform across the block: empty row
    float rx = 0.0f, ry = 0.0f, rz = 0.0f, re = 0.0f;
#pragma unroll
    for (int q = 0; q < MAX_COLS; ++q) {
      const int j = tid + q * K1_THREADS;
      if (j < W && j != i) {
        const float4 b = cand[j];
        if (b.w > 0.5f) {
          float gx, gy, gz, val;
          pair_force<ENERGY>(p, tab, a, b, gx, gy, gz, val);
          rx += gx;
          ry += gy;
          rz += gz;
          if (ENERGY) re += (j < k) ? 0.5f * val : val;
          cr[q][0] += gx;
          cr[q][1] += gy;
          cr[q][2] += gz;
        }
      }
    }
    rx = warp_sum(rx);
    ry = warp_sum(ry);
    rz = warp_sum(rz);
    if (ENERGY) re = warp_sum(re);
    if (lane == 0) {
      red[warp][i][0] = rx;
      red[warp][i][1] = ry;
      red[warp][i][2] = rz;
      red[warp][i][3] = re;
    }
  }
  __syncthreads();

  if (tid < k) {
    const int i = tid;
    const long row = (long)c * cap + i;
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
    if (cand[i].w > 0.5f) {
#pragma unroll
      for (int w = 0; w < K1_WARPS; ++w) {
        s0 += red[w][i][0];
        s1 += red[w][i][1];
        s2 += red[w][i][2];
        s3 += red[w][i][3];
      }
    }
    f[3 * row] = s0;
    f[3 * row + 1] = s1;
    f[3 * row + 2] = s2;
    eb[(long)c * k + i] = ENERGY ? s3 : 0.0f;
  }
#pragma unroll
  for (int q = 0; q < MAX_COLS; ++q) {
    const int j = tid + q * K1_THREADS;
    if (j >= k && j < W) {
      float* dst = cred + ((long)c * 13 * k + (j - k)) * 3;  // [c][o][s][3]
      dst[0] = cr[q][0];
      dst[1] = cr[q][1];
      dst[2] = cr[q][2];
    }
  }
}

__global__ void k1_credits(float* __restrict__ f, const float* __restrict__ cred,
                           int C, int cap, int k, int nx, int ny, int nz) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= C * k) return;
  const int c = t / k, s = t - (t / k) * k;
  const int ix = c / (ny * nz), iy = (c / nz) % ny, iz = c % nz;
  const long row = (long)c * cap + s;
  float fx = f[3 * row], fy = f[3 * row + 1], fz = f[3 * row + 2];
  for (int o = 0; o < 13; ++o) {
    // the cell whose offset-o neighbour is c
    const int src = ((ix - HALF_OFF[o][0] + nx) % nx) * (ny * nz) +
                    ((iy - HALF_OFF[o][1] + ny) % ny) * nz + ((iz - HALF_OFF[o][2] + nz) % nz);
    const float* cv = cred + (((long)src * 13 + o) * k + s) * 3;
    fx -= cv[0];
    fy -= cv[1];
    fz -= cv[2];
  }
  f[3 * row] = fx;
  f[3 * row + 1] = fy;
  f[3 * row + 2] = fz;
}

// ---------------------------------------------------------------- K2

template <bool ENERGY>
__global__ void __launch_bounds__(K2_THREADS)
k2_partners(const float* __restrict__ xo, const float* __restrict__ xp,
            const float* __restrict__ table, float* __restrict__ fp,
            float* __restrict__ part, int O, int N, PairParams p) {
  __shared__ float4 rows[MAX_O];
  __shared__ float4 tab[MAX_G];
  __shared__ float red[K2_WARPS][MAX_O][4];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  for (int g = tid; g < p.G; g += K2_THREADS)
    tab[g] = reinterpret_cast<const float4*>(table)[g];
  for (int i = tid; i < O; i += K2_THREADS)
    rows[i] = make_float4(xo[i], xo[O + i], xo[2 * O + i], xo[3 * O + i]);
  __syncthreads();

  const int n = blockIdx.x * K2_THREADS + tid;
  float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (n < N) b = make_float4(xp[n], xp[N + n], xp[2 * N + n], xp[3 * N + n]);
  float cx = 0.0f, cy = 0.0f, cz = 0.0f;
  for (int i = 0; i < O; ++i) {
    const float4 a = rows[i];
    if (a.w <= 0.5f) continue;  // uniform: empty tail row
    float gx = 0.0f, gy = 0.0f, gz = 0.0f, val = 0.0f;
    if (b.w > 0.5f) {
      pair_force<ENERGY>(p, tab, a, b, gx, gy, gz, val);
      cx += gx;
      cy += gy;
      cz += gz;
    }
    gx = warp_sum(gx);
    gy = warp_sum(gy);
    gz = warp_sum(gz);
    if (ENERGY) val = warp_sum(val);
    if (lane == 0) {
      red[warp][i][0] = gx;
      red[warp][i][1] = gy;
      red[warp][i][2] = gz;
      red[warp][i][3] = val;
    }
  }
  if (n < N) {
    fp[n] = -cx;
    fp[N + n] = -cy;
    fp[2 * N + n] = -cz;
  }
  __syncthreads();
  for (int i = tid; i < O; i += K2_THREADS) {
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (rows[i].w > 0.5f) {
      for (int w = 0; w < K2_WARPS; ++w)
        for (int q = 0; q < 4; ++q) s[q] += red[w][i][q];
    }
    for (int q = 0; q < 4; ++q) part[((long)blockIdx.x * 4 + q) * O + i] = s[q];
  }
}

template <bool ENERGY>
__global__ void k2_finish(const float* __restrict__ xo, const float* __restrict__ table,
                          const float* __restrict__ part, float* __restrict__ fo,
                          int O, int n_tiles, PairParams p) {
  __shared__ float4 tab[MAX_G];
  for (int g = threadIdx.x; g < p.G; g += blockDim.x)
    tab[g] = reinterpret_cast<const float4*>(table)[g];
  __syncthreads();
  const int i = threadIdx.x;
  if (i >= O) return;
  const float4 a = make_float4(xo[i], xo[O + i], xo[2 * O + i], xo[3 * O + i]);
  const float own = xo[4 * O + i];
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (own > 0.5f) {  // tail-tail block: rows this device owns, both orders
    for (int j = 0; j < O; ++j) {
      const float4 b = make_float4(xo[j], xo[O + j], xo[2 * O + j], xo[3 * O + j]);
      if (j == i || b.w <= 0.5f) continue;
      float gx, gy, gz, val;
      pair_force<ENERGY>(p, tab, a, b, gx, gy, gz, val);
      s[0] += gx;
      s[1] += gy;
      s[2] += gz;
      s[3] += val;
    }
  }
  s[3] *= 0.5f;
  for (int t = 0; t < n_tiles; ++t)
    for (int q = 0; q < 4; ++q) s[q] += part[((long)t * 4 + q) * O + i];
  for (int q = 0; q < 4; ++q) fo[q * O + i] = (q == 3 && !ENERGY) ? 0.0f : s[q];
}

PairParams make_params(int G, float glo, float gdx, float ghi, float blo, float bhi,
                       const float* L, const float* iL, float four_eps, float sig2,
                       float rcut) {
  PairParams p;
  for (int d = 0; d < 3; ++d) {
    p.L[d] = L[d];
    p.iL[d] = iL[d];
  }
  p.four_eps = four_eps;
  p.sig2 = sig2;
  p.rcut = rcut;
  p.G = G;
  p.glo = glo;
  p.gdx = gdx;
  p.ghi = ghi;
  p.blo = blo;
  p.bhi = bhi;
  return p;
}

}  // namespace

extern "C" {

int edm_max_k() { return MAX_K; }
int edm_max_g() { return MAX_G; }
int edm_max_o() { return MAX_O; }
const char* edm_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// geom = {glo, gdx, ghi, blo, bhi}; lj = {four_eps, sig2, rcut};
// box = {Lx, Ly, Lz, 1/Lx, 1/Ly, 1/Lz} (all f32)
int cell_force_newton_launch(const float* xs, const float* mc, const float* table,
                             float* f, float* eb, float* cred, int C, int cap, int k,
                             int nx, int ny, int nz, int G, const float* geom,
                             const float* box, const float* lj, int energy,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  PairParams p = make_params(G, geom[0], geom[1], geom[2], geom[3], geom[4], box, box + 3,
                             lj[0], lj[1], lj[2]);
  if (energy)
    k1_rows<true><<<C, K1_THREADS, 0, st>>>(xs, mc, table, f, eb, cred, cap, k, nx, ny, nz, p);
  else
    k1_rows<false><<<C, K1_THREADS, 0, st>>>(xs, mc, table, f, eb, cred, cap, k, nx, ny, nz, p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n = C * k;
  k1_credits<<<(n + 255) / 256, 256, 0, st>>>(f, cred, C, cap, k, nx, ny, nz);
  return (int)cudaGetLastError();
}

int overflow_force_launch(const float* xo, const float* xp, const float* table, float* fo,
                          float* fp, float* part, int O, int N, int G, const float* geom,
                          const float* box, const float* lj, int energy, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  PairParams p = make_params(G, geom[0], geom[1], geom[2], geom[3], geom[4], box, box + 3,
                             lj[0], lj[1], lj[2]);
  const int n_tiles = (N + K2_THREADS - 1) / K2_THREADS;
  if (n_tiles > 0) {
    if (energy)
      k2_partners<true><<<n_tiles, K2_THREADS, 0, st>>>(xo, xp, table, fp, part, O, N, p);
    else
      k2_partners<false><<<n_tiles, K2_THREADS, 0, st>>>(xo, xp, table, fp, part, O, N, p);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = ((O + 31) / 32) * 32;
  if (energy)
    k2_finish<true><<<1, threads, 0, st>>>(xo, table, part, fo, O, n_tiles, p);
  else
    k2_finish<false><<<1, threads, 0, st>>>(xo, table, part, fo, O, n_tiles, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
