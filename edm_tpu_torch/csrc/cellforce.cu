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
// K3  the Chebyshev lookup replaces edm_tpu/ops/cellforce_pallas.py
//     _cheb_val_der (the pair_lookup="chebyshev" branch of K1 and K2): per
//     pair a Clenshaw chain of deg steps for dV/dr and, on energy steps, a
//     second one for V, on the panel's (P, deg+1) series.  Both kernels are
//     instantiated once per lookup (template parameter LOOK: HERMITE or
//     CHEB).  The value and derivative coefficients sit in shared memory;
//     the panel's coefficient is one indexed shared-memory load, which picks
//     exactly the value the TPU kernel's (P-1)-deep select chain picks.  The
//     chain is a runtime loop (deg is not a template parameter), so deg 64
//     costs no registers over deg 16.  Bound: at the bench table (deg 16,
//     P 4) a pair costs ~4 x 16 flops of Clenshaw against ~40 for the rest;
//     still latency-bound at 10k like the Hermite kernels.
//
// The rdf type-pair mask of K1 and K6 replaces cellforce_pallas.py
//     _cv_type_mask: with a slot type plane ts (Cg, cap) and a type pair
//     (ti, tj), the CV term of a pair is kept only for the unordered type
//     pair {ti, tj}; LJ sees every pair.  The candidate gather carries each
//     slot's type beside its mask (template parameter TYPED; the untyped
//     instantiations are unchanged).  Types are floats compared with ==.
//
// K6  cell_force_newton_planar  replaces cellforce_pallas.py
//     cell_forces_pallas_newton_planar (_kernel_newton): K1's row pass
//     launched on its own.  It returns the row sums (self block included),
//     the per-offset credit column sums (+, C x 13 x k x 3) and eb; the
//     caller subtracts the credits after 13 lattice rolls
//     (use_pallas="newton").  Same bound and design as K1's first pass;
//     device time ~0.036 ms per call at 10k, k = 32, energy off
//     (chip_smoke.py's profile of a stride cycle; NVIDIA H100 80GB HBM3,
//     700 W).
//
// K7  cell_force_full  replaces cellforce_pallas.py cell_forces_pallas
//     (_kernel): the legacy 27-stencil ordered-pair pass.  One block per
//     cell gathers the 27 neighbour cells' slots (x, y, z, mask) and slot
//     ids into shared memory (27 x cap <= 1728 entries: cap <= MAX_K);
//     each of the cell's rows is paired with every occupied candidate whose
//     slot id differs (the self pair), with the Chebyshev lookup, energy
//     always.  Row sums only: every pair is seen from both sides, so there
//     are no credits and eb is not halved (the caller takes 0.5 sum(eb)).
//     Bound: the function needs each unordered pair once, so its least
//     work is K1's at full cap with the value chain, 0.0043 ms at 10k with
//     the bench table; the kernel evaluates every pair twice and takes
//     ~0.100 ms of device time per call there (chip_smoke.py; NVIDIA H100
//     80GB HBM3, 700 W): like K1 it is latency-bound, one wave of 729
//     blocks of serial row loops.
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
constexpr int MAX_DEG = 64;  // Chebyshev degree (the JAX default 64)
constexpr int MAX_PANELS = 8;  // Chebyshev panels (the bench uses 4)
static_assert(2 * MAX_PANELS * (MAX_DEG + 1) <= 4 * MAX_G, "cheb table fits the table buffer");
constexpr int CHEB_F4 = (2 * MAX_PANELS * (MAX_DEG + 1) + 3) / 4;  // K7's table, in float4
constexpr int MAX_W27 = 27 * MAX_K;  // K7's candidate row

enum Lookup { HERMITE = 0, CHEB = 1 };

// HALF_OFFSETS order: the 13 offsets (dx, dy, dz) > (0, 0, 0) lexicographically
__constant__ int HALF_OFF[13][3] = {
    {0, 0, 1},   {0, 1, -1},  {0, 1, 0},  {0, 1, 1}, {1, -1, -1},
    {1, -1, 0},  {1, -1, 1},  {1, 0, -1}, {1, 0, 0}, {1, 0, 1},
    {1, 1, -1},  {1, 1, 0},   {1, 1, 1}};

struct PairParams {
  float L[3], iL[3];  // box and its f32 reciprocal (minimum image)
  float four_eps, sig2, rcut;  // LJ
  int G;  // Hermite table rows | Chebyshev panels P
  int degp;  // Chebyshev deg + 1 (0 for Hermite)
  // Hermite: glo, gdx, ghi, blo, bhi (grid dtype, f32)
  // Chebyshev: lo, hi, lo + hi, hi - lo, panel width (each rounded once)
  float g0, g1, g2, g3, g4;
};

// The lookup table in shared memory: Hermite G x float4 rows, or the
// Chebyshev value series (P x degp floats) followed by the derivative's.
__device__ __forceinline__ void load_table(float4* tab, const float* t1, const float* t2,
                                           const PairParams& p, int look) {
  if (look == HERMITE) {
    for (int g = threadIdx.x; g < p.G; g += blockDim.x)
      tab[g] = reinterpret_cast<const float4*>(t1)[g];
  } else {
    float* c = reinterpret_cast<float*>(tab);
    const int n = p.G * p.degp;
    for (int q = threadIdx.x; q < n; q += blockDim.x) {
      c[q] = t1[q];
      c[n + q] = t2[q];
    }
  }
}

__device__ __forceinline__ float mimage(float d, float L, float iL) {
  return d - floorf(d * iL + 0.5f) * L;
}

// Exact cubic-Hermite value and dV/dr (_hermite_val_der:224-274).
template <bool ENERGY>
__device__ __forceinline__ void hermite_val_der(const PairParams& p, const float4* tab,
                                                float r, float& der, float& val) {
  der = 0.0f;
  val = 0.0f;
  if (r >= p.g3 && r <= p.g4 && r >= p.g0 && r < p.g2) {
    float idxf = fminf(fmaxf(floorf((r - p.g0) / p.g1), 0.0f), (float)(p.G - 1));
    float t = (r - p.g0 - idxf * p.g1) / p.g1;
    float4 c = tab[(int)idxf];
    der = c.y + t * (c.z + t * c.w);
    if (ENERGY) {
      val = c.x + (t * p.g1) * (c.y + t * (0.5f * c.z + (1.0f / 3.0f) * (t * c.w)));
    }
  }
}

// Panelized Chebyshev value and dV/dr (_cheb_val_der:67-105), op for op:
// the mask is lo <= r <= hi; for P > 1 the panel index is clamped to
// [0, P-1] and t is not clipped.
template <bool ENERGY>
__device__ __forceinline__ void cheb_val_der(const PairParams& p, const float* tab,
                                             float r, float& der, float& val) {
  der = 0.0f;
  val = 0.0f;
  if (!(r >= p.g0 && r <= p.g1)) return;
  const float rc = fminf(fmaxf(r, p.g0), p.g1);
  float t;
  int base = 0;
  if (p.G == 1) {
    t = (2.0f * rc - p.g2) / p.g3;
  } else {
    const float pf = fminf(fmaxf(floorf((rc - p.g0) / p.g4), 0.0f), (float)(p.G - 1));
    t = (2.0f * (rc - p.g0 - pf * p.g4) - p.g4) / p.g4;
    base = (int)pf * p.degp;
  }
  const float* cv = tab + base;
  const float* cd = tab + p.G * p.degp + base;
  const float t2 = 2.0f * t;
  float b1 = 0.0f, b2 = 0.0f, d1 = 0.0f, d2 = 0.0f;
  for (int k = p.degp - 1; k > 0; --k) {
    if (ENERGY) {
      const float b0 = cv[k] + t2 * b1 - b2;
      b2 = b1;
      b1 = b0;
    }
    const float e0 = cd[k] + t2 * d1 - d2;
    d2 = d1;
    d1 = e0;
  }
  der = cd[0] + t * d1 - d2;
  if (ENERGY) val = cv[0] + t * b1 - b2;
}

// One unmasked pair (row atom a, partner b): g = force on a (the partner
// gets -g); val only when ENERGY.  cv false (a type pair other than the
// CV's) drops the bias term, not LJ.  Mirrors _kernel_newton_rc:604-654.
template <bool ENERGY, int LOOK>
__device__ __forceinline__ void pair_force(const PairParams& p, const float4* tab,
                                           float4 a, float4 b, bool cv, float& gx,
                                           float& gy, float& gz, float& val) {
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
  if (cv) {
    if (LOOK == CHEB)
      cheb_val_der<ENERGY>(p, reinterpret_cast<const float*>(tab), r, der, val);
    else
      hermite_val_der<ENERGY>(p, tab, r, der, val);
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

// types of a pair: the CV's unordered pair {ti, tj}
__device__ __forceinline__ bool type_pair_ok(float a, float b, float ti, float tj) {
  return (a == ti && b == tj) || (a == tj && b == ti);
}

template <bool ENERGY, int LOOK, bool TYPED>
__global__ void __launch_bounds__(K1_THREADS)
k1_rows(const float* __restrict__ xs, const float* __restrict__ mc,
        const float* __restrict__ ts, float ti, float tj,
        const float* __restrict__ t1, const float* __restrict__ t2, float* __restrict__ f,
        float* __restrict__ eb, float* __restrict__ cred, int cap, int k,
        int nx, int ny, int nz, PairParams p) {
  __shared__ float4 cand[MAX_W];  // x, y, z, mask: self block then 13 neighbours
  __shared__ float ctype[TYPED ? MAX_W : 1];  // slot types (TYPED)
  __shared__ float4 tab[MAX_G];
  __shared__ float red[K1_WARPS][MAX_K][4];

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int W = 14 * k;
  const int ix = c / (ny * nz), iy = (c / nz) % ny, iz = c % nz;

  load_table(tab, t1, t2, p, LOOK);
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
    if (TYPED) ctype[j] = ts[slot];
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
          const bool cv = !TYPED || type_pair_ok(ctype[i], ctype[j], ti, tj);
          float gx, gy, gz, val;
          pair_force<ENERGY, LOOK>(p, tab, a, b, cv, gx, gy, gz, val);
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

template <bool ENERGY, int LOOK>
__global__ void __launch_bounds__(K2_THREADS)
k2_partners(const float* __restrict__ xo, const float* __restrict__ xp,
            const float* __restrict__ t1, const float* __restrict__ t2,
            float* __restrict__ fp, float* __restrict__ part, int O, int N, PairParams p) {
  __shared__ float4 rows[MAX_O];
  __shared__ float4 tab[MAX_G];
  __shared__ float red[K2_WARPS][MAX_O][4];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  load_table(tab, t1, t2, p, LOOK);
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
      pair_force<ENERGY, LOOK>(p, tab, a, b, true, gx, gy, gz, val);
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

template <bool ENERGY, int LOOK>
__global__ void k2_finish(const float* __restrict__ xo, const float* __restrict__ t1,
                          const float* __restrict__ t2, const float* __restrict__ part,
                          float* __restrict__ fo, int O, int n_tiles, PairParams p) {
  __shared__ float4 tab[MAX_G];
  load_table(tab, t1, t2, p, LOOK);
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
      pair_force<ENERGY, LOOK>(p, tab, a, b, true, gx, gy, gz, val);
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

// ---------------------------------------------------------------- K7

// Ordered pairs over the whole 27-stencil: candidate o * cap + s is slot s
// of the cell at offset (o / 9 - 1, o / 3 % 3 - 1, o % 3 - 1), the
// CellSpec.stencil() order; the cell's own slots are offset 13.
__global__ void __launch_bounds__(K1_THREADS)
k7_rows(const float* __restrict__ xs, const float* __restrict__ mc,
        const float* __restrict__ sid, const float* __restrict__ t1,
        const float* __restrict__ t2, float* __restrict__ f, float* __restrict__ eb, int cap,
        int nx, int ny, int nz, PairParams p) {
  __shared__ float4 cand[MAX_W27];  // x, y, z, mask
  __shared__ float cid[MAX_W27];  // slot id of an occupied candidate, else -1
  __shared__ float4 tab[CHEB_F4];
  __shared__ float red[K1_WARPS][MAX_K][4];

  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int W = 27 * cap;
  const int ix = c / (ny * nz), iy = (c / nz) % ny, iz = c % nz;

  load_table(tab, t1, t2, p, CHEB);
  for (int j = tid; j < W; j += K1_THREADS) {
    const int o = j / cap, s = j - (j / cap) * cap;
    const int cell = ((ix + o / 9 - 1 + nx) % nx) * (ny * nz) +
                     ((iy + (o / 3) % 3 - 1 + ny) % ny) * nz + ((iz + o % 3 - 1 + nz) % nz);
    const long slot = (long)cell * cap + s;
    const float m = mc[slot];
    cand[j] = make_float4(xs[3 * slot], xs[3 * slot + 1], xs[3 * slot + 2], m);
    cid[j] = m > 0.5f ? sid[slot] : -1.0f;
  }
  __syncthreads();

  for (int i = 0; i < cap; ++i) {
    const float4 a = cand[13 * cap + i];
    if (a.w <= 0.5f) continue;  // uniform across the block: empty row
    const float ai = cid[13 * cap + i];
    float rx = 0.0f, ry = 0.0f, rz = 0.0f, re = 0.0f;
    for (int j = tid; j < W; j += K1_THREADS) {
      const float4 b = cand[j];
      if (b.w > 0.5f && fabsf(ai - cid[j]) >= 0.5f) {
        float gx, gy, gz, val;
        pair_force<true, CHEB>(p, tab, a, b, true, gx, gy, gz, val);
        rx += gx;
        ry += gy;
        rz += gz;
        re += val;
      }
    }
    rx = warp_sum(rx);
    ry = warp_sum(ry);
    rz = warp_sum(rz);
    re = warp_sum(re);
    if (lane == 0) {
      red[warp][i][0] = rx;
      red[warp][i][1] = ry;
      red[warp][i][2] = rz;
      red[warp][i][3] = re;
    }
  }
  __syncthreads();

  if (tid < cap) {
    const int i = tid;
    const long row = (long)c * cap + i;
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
    if (cand[13 * cap + i].w > 0.5f) {
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
    eb[row] = s3;
  }
}

PairParams make_params(int rows, int degp, const float* geom, const float* box,
                       const float* lj) {
  PairParams p;
  for (int d = 0; d < 3; ++d) {
    p.L[d] = box[d];
    p.iL[d] = box[3 + d];
  }
  p.four_eps = lj[0];
  p.sig2 = lj[1];
  p.rcut = lj[2];
  p.G = rows;
  p.degp = degp;
  p.g0 = geom[0];
  p.g1 = geom[1];
  p.g2 = geom[2];
  p.g3 = geom[3];
  p.g4 = geom[4];
  return p;
}

struct K1Args {
  const float *xs, *mc, *ts, *t1, *t2;
  float ti, tj;
  float *f, *eb, *cred;
  int C, cap, k, nx, ny, nz;
};

// K1 (credits applied by the second pass) or K6 (the row pass alone)
template <bool ENERGY, int LOOK, bool TYPED>
cudaError_t k1_launch(const K1Args& a, bool credits, const PairParams& p, cudaStream_t st) {
  k1_rows<ENERGY, LOOK, TYPED><<<a.C, K1_THREADS, 0, st>>>(
      a.xs, a.mc, a.ts, a.ti, a.tj, a.t1, a.t2, a.f, a.eb, a.cred, a.cap, a.k, a.nx, a.ny, a.nz,
      p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !credits) return e;
  const int n = a.C * a.k;
  k1_credits<<<(n + 255) / 256, 256, 0, st>>>(a.f, a.cred, a.C, a.cap, a.k, a.nx, a.ny, a.nz);
  return cudaGetLastError();
}

template <int LOOK, bool TYPED>
cudaError_t k1_energy(const K1Args& a, int energy, bool credits, const PairParams& p,
                      cudaStream_t st) {
  return energy ? k1_launch<true, LOOK, TYPED>(a, credits, p, st)
                : k1_launch<false, LOOK, TYPED>(a, credits, p, st);
}

cudaError_t k1_dispatch(const K1Args& a, int look, int energy, bool credits,
                        const PairParams& p, cudaStream_t st) {
  const bool typed = a.ts != nullptr;
  if (look == CHEB)
    return typed ? k1_energy<CHEB, true>(a, energy, credits, p, st)
                 : k1_energy<CHEB, false>(a, energy, credits, p, st);
  return typed ? k1_energy<HERMITE, true>(a, energy, credits, p, st)
               : k1_energy<HERMITE, false>(a, energy, credits, p, st);
}

template <bool ENERGY, int LOOK>
cudaError_t k2_launch(const float* xo, const float* xp, const float* t1, const float* t2,
                      float* fo, float* fp, float* part, int O, int N, const PairParams& p,
                      cudaStream_t st) {
  const int n_tiles = (N + K2_THREADS - 1) / K2_THREADS;
  if (n_tiles > 0) {
    k2_partners<ENERGY, LOOK><<<n_tiles, K2_THREADS, 0, st>>>(xo, xp, t1, t2, fp, part, O, N,
                                                              p);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const int threads = ((O + 31) / 32) * 32;
  k2_finish<ENERGY, LOOK><<<1, threads, 0, st>>>(xo, t1, t2, part, fo, O, n_tiles, p);
  return cudaGetLastError();
}

bool table_ok(int look, int rows, int degp) {
  if (look == HERMITE) return rows >= 1 && rows <= MAX_G;
  return look == CHEB && rows >= 1 && rows <= MAX_PANELS && degp >= 2 && degp <= MAX_DEG + 1;
}

}  // namespace

extern "C" {

int edm_max_k() { return MAX_K; }
int edm_max_g() { return MAX_G; }
int edm_max_o() { return MAX_O; }
int edm_max_deg() { return MAX_DEG; }
int edm_max_panels() { return MAX_PANELS; }
const char* edm_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// K1 (credits = 1: the credits applied by the second pass) or K6
// (credits = 0: the row pass alone; cred is returned to the caller).
// look: 0 Hermite (t1 = (G, 4) table, rows = G, degp unused) or 1 Chebyshev
// (t1 = cval, t2 = cder, (P, degp) each, rows = P); geom: 5 f32 constants
// (see PairParams); lj = {four_eps, sig2, rcut};
// box = {Lx, Ly, Lz, 1/Lx, 1/Ly, 1/Lz} (all f32); ts: the (Cg, cap) slot
// types and tpair = {ti, tj} for the typed CV, or null for none
int cell_force_newton_launch(const float* xs, const float* mc, float* f, float* eb,
                             float* cred, int C, int cap, int k, int nx, int ny, int nz,
                             int credits, const float* ts, const float* tpair, int look,
                             const float* t1, const float* t2, int rows, int degp,
                             const float* geom, const float* box, const float* lj, int energy,
                             void* stream) {
  if (!table_ok(look, rows, degp) || k < 1 || k > MAX_K) return (int)cudaErrorInvalidValue;
  K1Args a{xs, mc, ts, t1, t2, ts ? tpair[0] : 0.0f, ts ? tpair[1] : 0.0f,
           f, eb, cred, C, cap, k, nx, ny, nz};
  return (int)k1_dispatch(a, look, energy, credits != 0,
                          make_params(rows, degp, geom, box, lj), (cudaStream_t)stream);
}

// K7: Chebyshev only (look must be 1), energy always
int cell_force_full_launch(const float* xs, const float* mc, const float* sid, float* f,
                           float* eb, int C, int cap, int nx, int ny, int nz, int look,
                           const float* t1, const float* t2, int rows, int degp,
                           const float* geom, const float* box, const float* lj, void* stream) {
  if (look != CHEB || !table_ok(look, rows, degp) || cap < 1 || cap > MAX_K)
    return (int)cudaErrorInvalidValue;
  k7_rows<<<C, K1_THREADS, 0, (cudaStream_t)stream>>>(
      xs, mc, sid, t1, t2, f, eb, cap, nx, ny, nz, make_params(rows, degp, geom, box, lj));
  return (int)cudaGetLastError();
}

int overflow_force_launch(const float* xo, const float* xp, float* fo, float* fp, float* part,
                          int O, int N, int look, const float* t1, const float* t2, int rows,
                          int degp, const float* geom, const float* box, const float* lj,
                          int energy, void* stream) {
  if (!table_ok(look, rows, degp)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  PairParams p = make_params(rows, degp, geom, box, lj);
  cudaError_t e;
  if (look == CHEB)
    e = energy ? k2_launch<true, CHEB>(xo, xp, t1, t2, fo, fp, part, O, N, p, st)
               : k2_launch<false, CHEB>(xo, xp, t1, t2, fo, fp, part, O, N, p, st);
  else
    e = energy ? k2_launch<true, HERMITE>(xo, xp, t1, t2, fo, fp, part, O, N, p, st)
               : k2_launch<false, HERMITE>(xo, xp, t1, t2, fo, fp, part, O, N, p, st);
  return (int)e;
}

}  // extern "C"
