// Cell-pair force kernels of the pairwise-EDM cell host, for Hopper (sm_90a).
//
// Times below: device time per launch in the profile of a stride cycle of
// the 10,000-atom bench (729 cells of cap 32, 13.7 atoms per cell on
// average), chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W.  Bounds: the
// card's least time for the same work, each unordered pair once: r^2 for
// every occupied pair, the pair arithmetic and the lookup only for the
// pairs within reach of the cutoffs (chip_smoke.py:pair_counts).
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
//     grid runs in order.  Here the row pass k1_rows (one block per row
//     cell) writes its own row sums into f and its column sums into a
//     per-offset credit scratch (rows, 13, k, 3); the credit pass k1_credits
//     (one thread per element of f) subtracts the 13 incoming credits in a
//     fixed offset order.  No atomics: a run repeats bitwise.  The rows are
//     a row box: the whole lattice, or a slab rank's owned sub-box of its
//     halo window (the owned-row form, cellforce_pallas.py:684 row_box),
//     where the credit pass takes credits only from sources in the box.
//
//     What bounds it: not the card's arithmetic or memory rate (bound
//     0.0008 ms at k = 24) but warp operations executed per useful pair and the
//     fixed cost of a short kernel.  At 10k a cell meets 14k = 336 candidate
//     slots of which ~192 hold an atom, and only ~27 of those lie within
//     reach of a given row (the cells' edge is the cutoff, so most of the 14
//     cells' volume is beyond it); 729 blocks are one or two waves.  The
//     design (see k1_rows): gather by whole ballot words straight from the
//     slot lattice into registers (no staging, no index division); compact
//     the occupied candidates; a warp per occupied row, which first lists
//     the partners within reach (a distance test per candidate, 6.5 warp
//     iterations a row) and runs the full pair arithmetic only over that
//     list (1-2 iterations); one 6-shuffle reduction per row; credits by
//     plain adds into per-warp accumulators in shared memory, summed in
//     warp order; a credit pass with a thread per element, its 13 loads
//     independent; shared memory sized by k and the table (44 KB at k = 24
//     with the bench's 151-row table); the kernels write every output
//     element, so the wrappers fill nothing.  0.0204 ms, row pass 0.0175 +
//     credit pass 0.0032 (0.0371 before the redesign, when every lane
//     looped over all 336 slots row by row and four warps reduced each row).
//     Of the row pass at k = 32 (0.0190 ms), by cutting it short: launch
//     0.002, gather 0.0035, compaction 0.002, rows 0.0115, credit sums 0.002
//     (before the register gather); 4 to 16 warps a block and a register
//     cap for 5 blocks per SM all read the same within 10%.
//
// K2  overflow_force  replaces edm_tpu/ops/cellforce_pallas.py
//     overflow_forces_pallas (_kernel_overflow).  Sweep of the compacted
//     tail atoms (slots >= kernel_cap) against every placed low slot with
//     K1's pair math.
//
//     What bounds it: not the card's rates (bound 0.00015 ms, the 0.5 MB of
//     partners and credits) but latency, the fixed cost of two short
//     kernels (~0.85 us each in the profile), and work on pairs that
//     contribute nothing: of the 32 x 17,664 (tail row, partner) pairs at
//     10k usually 8 rows or fewer are live, and a tail atom has ~30 partners
//     within reach of the cutoffs.  The design: k2_partners, one block of
//     128 threads per tile of 128 partners (138 blocks at 10k, one wave of
//     the 132 SMs), compacts the live tail rows once; a thread holds its
//     partner and takes only the r^2 against each live row, keeping the rows
//     within reach as a bit mask; the pair arithmetic and the lookup run
//     only for rows that some lane of the warp reaches (r^2 <= r2_far:
//     beyond it both terms are exact zeros), two rows at a time so that
//     their dependent chains overlap, each summed over the lanes by one
//     fixed shuffle tree.  Rows no lane reaches cost nothing.  Each thread
//     owns its partner's credit (no atomics); the block writes its rows'
//     partial sums, warps in order.  The tail-tail block (rows with `own`
//     against the live rows, both orders, diagonal masked, energy halved) is
//     one more block of the same sweep, with the tail rows as its partners,
//     so k2_finish needs no table and no pair arithmetic: a warp per tail
//     row, lanes striding over the blocks' partials, one fixed shuffle tree.
//     Shared memory is dynamic, sized by O and the Chebyshev series (2.5 KB
//     at O = 32; the Hermite table is read in place, on a hit only).  fo and
//     fp are written whole.  0.0066 ms with the Hermite table (sweep 0.0046 +
//     finish 0.0020), 0.0069 with the Chebyshev one (0.0149 and 0.0179 before
//     the redesign, when every pair ran the whole pair arithmetic and every
//     row a shuffle reduction per warp).  Of the sweep, by cutting it short
//     on a 7-row tail (us, before the redesign's last steps): an empty
//     kernel 0.9, loads and compaction 1.0, the pair arithmetic on hits 1.3,
//     their sums 0.9.  Tried and dropped: the lanes with a hit adding into
//     the accumulator one after another (0.9 us against 0.3 for the tree);
//     four rows at a time (slower than two); the finish inside the sweep, by
//     the block that arrives last (a ticket: its fences and the serial finish
//     cost 3 us more than the second launch); one block for the finish.
//
// K3  the Chebyshev lookup replaces edm_tpu/ops/cellforce_pallas.py
//     _cheb_val_der (the pair_lookup="chebyshev" branch of K1 and K2): per
//     pair a Clenshaw chain of deg steps for dV/dr and, on energy steps, a
//     second one for V, on the panel's (P, deg+1) series.  The kernels are
//     instantiated once per lookup (template parameter LOOK: HERMITE or
//     CHEB).  The value and derivative coefficients sit in shared memory;
//     the panel's coefficient is one indexed shared-memory load, which picks
//     exactly the value the TPU kernel's (P-1)-deep select chain picks.  The
//     chain is a runtime loop (deg is not a template parameter), so deg 64
//     costs no registers over deg 16.  In K1 the chains run only over the
//     partners within reach: 0.0242 ms at the bench table (deg 16, P 4),
//     0.0038 over the Hermite form (0.0470 before the redesign; bound
//     0.0009).
//
// The rdf type-pair mask of K1 and K6 replaces cellforce_pallas.py
//     _cv_type_mask: with a slot type plane ts (Cg, cap) and a type pair
//     (ti, tj), the CV term of a pair is kept only for the unordered type
//     pair {ti, tj}; LJ sees every pair, so no candidate is dropped.  The
//     compacted candidates carry their types (template parameter TYPED).
//     Types are floats compared with ==.  0.0231 ms at k = 32 (0.0474
//     before; bound 0.0008).
//
// K6  cell_force_newton_planar  replaces cellforce_pallas.py
//     cell_forces_pallas_newton_planar (_kernel_newton): K1's row pass
//     launched on its own.  It returns the row sums (self block included),
//     the per-offset credit column sums (+, Cg x 13 x k x 3, zeros at empty
//     slots and pad cells) and eb; the caller subtracts the credits after
//     13 lattice rolls (use_pallas="newton").  0.0190 ms at k = 32, energy
//     off (0.0372 before; bound 0.0013, by bytes).
//
// K7  cell_force_full  replaces cellforce_pallas.py cell_forces_pallas
//     (_kernel): the legacy 27-stencil ordered-pair pass, each row's force
//     and eb summed over all its partners, the self pair masked by slot id.
//     With 3 or more cells per dimension the 27 cells are distinct, so the
//     only candidate with a row's id is the row itself and every unordered
//     pair appears once in the half-stencil.  K7 is therefore the shared
//     row pass at full cap with the Chebyshev value chain and a fourth
//     credit component (VCRED: each partner is credited the pair's value
//     beside its force; the self block takes the value whole), then the
//     credit pass, which subtracts the force credits and adds the value
//     credits in HALF_OFF order: each pair is evaluated once, where the
//     27-stencil body it replaces evaluated it from both sides.  0.0280 ms
//     (0.0952 before; bound 0.0012).
//
// Any shape.  The JAX kernels take any cell cap, any number of tail rows
// (a multiple of 8) and any Chebyshev table; only the Hermite table is
// bounded, at 1,024 rows, in both packages.  Here the shapes that fit a
// block's shared memory at once keep the forms above, and the others take
// their work in pieces (ops/cellforce.py:row_plan and k2_plan choose, the
// launchers check the plan against the shared memory it needs):
//   - the row pass (K1, K6, K7) up to k = SMALL_K with its table in shared
//     memory is k1_rows as above; past it k1_rows_pieces takes the 14
//     cells' candidates a piece of ballot words at a time (a piece's
//     compacted candidates and the warps' credit accumulators are what
//     grows with k: at k = 96 the whole row would take ~165 KB, at 128
//     ~220 KB) and the own cell's rows a tile of up to ROW_TILE at a time,
//     each row's sums kept in shared memory across the pieces and each
//     piece's credits flushed to the scratch, warps in order, before the
//     next; its distance sweep is culled by the bounding boxes of chunks
//     of its candidates (what bounds it and what the cull does: the note
//     before k1_rows_pieces);
//   - K2 takes the tail rows a tile of K2_THREADS at a time, a tile a row
//     of the grid: the tail-tail blocks become one a tile of tail rows as
//     partners, and with more than one row tile the partners' credits are
//     written per tile and added in tile order by k2_finish;
//   - a Chebyshev table past TABLE_SMEM_MAX (48 KB) is read from global
//     memory through the cache instead of shared memory (Lut).
// Every sum keeps a fixed order: the runs repeat bitwise.  The small forms
// run the code they ran before (in turns with it: within 2.3%); the pieces
// form's and the row tiles' times on the 32,000-atom liquid at cap 96 are in
// PERF.md, section 6 (K1 at k = 96 ~17x its bound).
//
// Plain C interface, loaded with ctypes; every launch goes on the caller's
// stream and each entry point returns the first launch error.

#include <cuda_runtime.h>
#include <cmath>

namespace {

constexpr int ROW_WARPS = 8;  // the row pass: each warp one live row at a time
constexpr int ROW_THREADS = 32 * ROW_WARPS;
constexpr int CREDIT_THREADS = 128;
constexpr int SMALL_K = 64;  // the row pass's small form: k <= 64, one piece
constexpr int SMALL_W = 14 * SMALL_K;
constexpr int MAX_SEG = SMALL_W / 32;  // ballot words of a small-form row: 14 cells x 64 slots
static_assert(SMALL_K == 64 && MAX_SEG % 4 == 0, "slot_pitch() is 32 or 64");
constexpr int MAX_G = 1024;  // Hermite table rows (the JAX kernels' own limit)
constexpr int K2_THREADS = 128;  // k2_partners' tile of partners, and of tail rows
constexpr int K2_WARPS = K2_THREADS / 32;
constexpr int K2_BATCH = 2;  // tail rows a warp evaluates together
constexpr int SMEM_MAX = 232448;  // a block's shared memory on Hopper (227 KB)
// a lookup table larger than this is read from global memory (through the
// cache) instead of shared memory
constexpr int TABLE_SMEM_MAX = 48 * 1024;
static_assert(SMALL_W < 32768, "compacted indices are int16");

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
  // a pair with r^2 above this lies beyond rcut and beyond the table, with a
  // margin over rsqrtf's rounding: LJ and the bias term are exact zeros
  float r2_far;
};

// The lookup table in shared memory: Hermite G x float4 rows, or the
// Chebyshev value series (P x degp floats) followed by the derivative's.
__host__ __device__ inline int table4(int look, int rows, int degp) {  // its float4 units
  return look == HERMITE ? rows : (2 * rows * degp + 3) / 4;
}

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

// Where a kernel reads its table: the Hermite rows, or the Chebyshev value
// and derivative series, in shared memory or (a table past TABLE_SMEM_MAX,
// and K2's Hermite table) in global memory.
struct Lut {
  const float4* herm;
  const float *cv, *cd;
};

// the table as load_table lays it out in shared memory
__device__ __forceinline__ Lut smem_lut(const float4* tab, const PairParams& p) {
  const float* c = reinterpret_cast<const float*>(tab);
  return Lut{tab, c, c + p.G * p.degp};
}

// the table where the caller passed it: t1 the Hermite rows or the value
// series, t2 the derivative series
__device__ __forceinline__ Lut global_lut(const float* t1, const float* t2) {
  return Lut{reinterpret_cast<const float4*>(t1), t1, t2};
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
// [0, P-1] and t is not clipped.  cvals / cders: the (P, degp) series.
template <bool ENERGY>
__device__ __forceinline__ void cheb_eval(const PairParams& p, const float* cvals,
                                          const float* cders, float r, float& der,
                                          float& val) {
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
  const float* cv = cvals + base;
  const float* cd = cders + base;
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

// Minimum-image displacement a - b and its r^2: the one place a pair's r^2
// is computed, so the row pass's reach test sees what pair_force sees.
__device__ __forceinline__ float pair_r2(const PairParams& p, float4 a, float4 b, float& dx,
                                         float& dy, float& dz) {
  dx = mimage(a.x - b.x, p.L[0], p.iL[0]);
  dy = mimage(a.y - b.y, p.L[1], p.iL[1]);
  dz = mimage(a.z - b.z, p.L[2], p.iL[2]);
  return dx * dx + dy * dy + dz * dz;
}

// One unmasked pair (row atom a, partner b): g = force on a (the partner
// gets -g); val only when ENERGY.  cv false (a type pair other than the
// CV's) drops the bias term, not LJ.  Mirrors _kernel_newton_rc:604-654.
template <bool ENERGY, int LOOK>
__device__ __forceinline__ void pair_force(const PairParams& p, const Lut& lut, float4 a,
                                           float4 b, bool cv, float& gx, float& gy, float& gz,
                                           float& val) {
  float dx, dy, dz;
  float r2 = pair_r2(p, a, b, dx, dy, dz);
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
      cheb_eval<ENERGY>(p, lut.cv, lut.cd, r, der, val);
    else
      hermite_val_der<ENERGY>(p, lut.herm, r, der, val);
  }
  float f_over_r = fmag - der * inv_r;
  gx = f_over_r * dx;
  gy = f_over_r * dy;
  gz = f_over_r * dz;
}

// ---------------------------------------------------------------- row pass

// types of a pair: the CV's unordered pair {ti, tj}
__device__ __forceinline__ bool type_pair_ok(float a, float b, float ti, float tj) {
  return (a == ti && b == tj) || (a == tj && b == ti);
}

// Sums of four values over the warp in 6 shuffles (a butterfly that halves
// the values it carries at its first two steps), in a fixed order: the
// totals of a, b, c and d end in lanes 0, 8, 16 and 24.
__device__ __forceinline__ float warp_sum4(float a, float b, float c, float d, int lane) {
  const bool h16 = lane & 16, h8 = lane & 8;
  float k0 = h16 ? c : a, k1 = h16 ? d : b;
  k0 += __shfl_xor_sync(0xffffffffu, h16 ? a : c, 16);
  k1 += __shfl_xor_sync(0xffffffffu, h16 ? b : d, 16);
  float v = h8 ? k1 : k0;
  v += __shfl_xor_sync(0xffffffffu, h8 ? k0 : k1, 8);
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct RowArgs {
  const float *xs, *mc, *ts, *t1, *t2;
  float ti, tj;
  float *f, *eb, *cred;
  int C, cap, k, nx, ny, nz;
  // the neighbour cells' candidate mask (mc for K6 and K7: one mask)
  const float* mcand;
  // the row box: the sub-box at (ox, oy, oz) of rx x ry x rz cells whose
  // R cells are the rows (the whole lattice but on a sharded host's owned
  // rows).  A proper sub-box's block b is its cell b, x-major; the whole
  // lattice's block b is cell b, pad cells (b >= C) included.  mc, eb and
  // cred are indexed by row, f by lattice cell.
  int ox, oy, oz, rx, ry, rz;
};

// The row pass's dynamic shared memory, in float4 units: the lookup table,
// the compacted candidates, the warps' credit accumulators, the compacted
// types, the ballot words with each slot's compacted index, and the warps'
// lists of partners in reach.
struct RowLayout {
  int tab4, cand4, acc4, type4, index4, near4;
  __host__ __device__ int total4() const {
    return tab4 + cand4 + acc4 + type4 + index4 + near4;
  }
};

// slots of a cell in the candidate row: k rounded up to whole ballot words
__host__ __device__ inline int slot_pitch(int k) { return k <= 32 ? 32 : 64; }

__host__ __device__ inline RowLayout row_layout(int k, int nc, bool typed, int look, int rows,
                                                int degp) {
  const int W = 14 * k;  // the most candidates a cell can meet
  RowLayout l;
  l.tab4 = table4(look, rows, degp);
  l.cand4 = W;
  l.acc4 = (ROW_WARPS * nc * 13 * k + 3) / 4;
  l.type4 = typed ? (W + 3) / 4 : 0;
  l.index4 = MAX_SEG / 4 + 14 * slot_pitch(k) / 8;  // uint32 ballots, int16 indices
  l.near4 = ROW_WARPS * ((W + 7) / 8);  // int16
  return l;
}

__device__ __forceinline__ int wrap(int v, int n) { return v < 0 ? v + n : (v >= n ? v - n : v); }

// The row pass of K1, K6 and K7: one block of ROW_WARPS warps per cell, pad
// cells included.
//
// Gather: the cell's k slots and the k slots of its 13 half-stencil
// neighbours, in HALF_OFF order.  Candidate j = o * pitch + slot (o = 0 the
// cell itself; pitch = 32 or 64, so that a ballot word never spans two
// cells and no index needs a division).  Each warp loads whole words of 32
// slots into registers and ballots their occupancy; after one barrier the
// occupied candidates are written, compacted in slot order (prefix counts
// over the ballot words), each with its index j.  The cell's own atoms
// come first and are the live rows.
//
// Pairs: warp w takes live rows w, w + ROW_WARPS, ...  For a row it first
// lists, in candidate order, the partners within reach (r^2 <= r2_far: most
// candidates of the 14 cells lie beyond both cutoffs, where LJ and the bias
// term are exact zeros), then its lanes stride over that list with the
// row's partial sums in registers and one warp_sum4 per row.  Newton
// credits go with plain adds into the warp's own accumulator
// [component][candidate]: within a row every partner belongs to one lane,
// and rows follow one another.  Afterwards the warps' accumulators are
// summed in warp order and written at the candidates' slot positions
// (empty slots 0) as cred[c][o][s][NC].  Nothing is atomic; the order is
// fixed.
//
// VCRED (K7): the value is credited too (NC = 4: each partner's column sum
// of V) and the self block takes V whole instead of halved.
//
// Masks: the own slots (the live rows and the self block) come from the
// row mask mc, the 13 neighbour cells' candidates from mcand.  Rows: the
// row box's cells (K1's owned-row pass, cellforce_pallas.py:577-595, when
// it is a sharded host's owned sub-box): block b maps to its lattice cell
// with the wrap taken per axis of the (window) lattice (nx, ny, nz), while
// the minimum image still uses the real box.
//
// Writes every row of f and eb of its cell (zeros at empty slots and at
// rows >= k) and, on a pad cell, zeros throughout.
template <bool ENERGY, int LOOK, bool TYPED, bool VCRED>
__global__ void __launch_bounds__(ROW_THREADS) k1_rows(RowArgs a, PairParams p) {
  extern __shared__ float4 smem[];
  constexpr int NC = VCRED ? 4 : 3;
  constexpr int ROUNDS = (MAX_SEG + ROW_WARPS - 1) / ROW_WARPS;
  const int k = a.k, cap = a.cap, W = 14 * k, NB = 13 * k;
  const int row = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  int c = row;  // the whole lattice: row b is cell b, pad cells included
  if (a.rx * a.ry * a.rz < a.C) {  // an owned sub-box: row b is its cell b
    const int bz = row % a.rz, by = (row / a.rz) % a.ry, bx = row / (a.ry * a.rz);
    c = ((a.ox + bx) % a.nx) * (a.ny * a.nz) + ((a.oy + by) % a.ny) * a.nz + (a.oz + bz) % a.nz;
  }
  float* f_cell = a.f + (long)c * cap * 3;
  float* eb_cell = a.eb + (long)row * k;
  float* cred_cell = a.cred + (long)row * NB * NC;
  if (c >= a.C) {  // a pad cell
    for (int i = tid; i < cap * 3; i += ROW_THREADS) f_cell[i] = 0.0f;
    for (int i = tid; i < k; i += ROW_THREADS) eb_cell[i] = 0.0f;
    for (int i = tid; i < NB * NC; i += ROW_THREADS) cred_cell[i] = 0.0f;
    return;
  }

  const RowLayout lay = row_layout(k, NC, TYPED, LOOK, p.G, p.degp);
  float4* tab = smem;
  float4* cand = tab + lay.tab4;  // x, y, z, candidate index (as bits)
  float* acc = reinterpret_cast<float*>(cand + lay.cand4);  // [warp][component][NB]
  float* ctype = acc + 4 * lay.acc4;
  unsigned* bal = reinterpret_cast<unsigned*>(ctype + 4 * lay.type4);
  short* qof = reinterpret_cast<short*>(bal + MAX_SEG);
  short* near = reinterpret_cast<short*>(bal + 4 * lay.index4) + warp * 8 * ((W + 7) / 8);

  // gather whole ballot words of candidate slots into registers
  load_table(tab, a.t1, a.t2, p, LOOK);
  const Lut lut = smem_lut(tab, p);
  const int pitch = slot_pitch(k), wsh = pitch >> 6, words = 1 << wsh;  // 1 or 2 words per cell
  const int n_seg = 14 * words;
  const int ix = c / (a.ny * a.nz), iy = (c / a.nz) % a.ny, iz = c % a.nz;
  float4 got[ROUNDS];  // x, y, z, type
#pragma unroll
  for (int i = 0; i < ROUNDS; ++i) {
    const int s = warp + i * ROW_WARPS;
    if (s < n_seg) {
      const int o = s >> wsh, sl = 32 * (s & (words - 1)) + lane;
      int cell = c;
      if (o > 0)
        cell = wrap(ix + HALF_OFF[o - 1][0], a.nx) * (a.ny * a.nz) +
               wrap(iy + HALF_OFF[o - 1][1], a.ny) * a.nz + wrap(iz + HALF_OFF[o - 1][2], a.nz);
      const long slot = (long)cell * cap + sl;
      bool live = false;
      if (sl < k) {
        live = (o == 0 ? a.mc[(long)row * cap + sl] : a.mcand[slot]) > 0.5f;
        got[i] = make_float4(a.xs[3 * slot], a.xs[3 * slot + 1], a.xs[3 * slot + 2],
                             TYPED ? a.ts[slot] : 0.0f);
      }
      const unsigned b = __ballot_sync(0xffffffffu, live);
      if (lane == 0) bal[s] = b;
    }
  }
  __syncthreads();

  // compact: candidate j goes to the count of occupied slots before it
  int n_live = 0, s0 = 0;
#pragma unroll
  for (int i = 0; i < ROUNDS; ++i) {
    const int s = warp + i * ROW_WARPS;
    if (s < n_seg) {
      for (; s0 < s; ++s0) n_live += __popc(bal[s0]);
      const unsigned b = bal[s];
      const int j = 32 * s + lane;
      int q = -1;
      if ((b >> lane) & 1u) {
        q = n_live + __popc(b & ((1u << lane) - 1u));
        if (TYPED) ctype[q] = got[i].w;
        cand[q] = make_float4(got[i].x, got[i].y, got[i].z, __int_as_float(j));
      }
      qof[j] = (short)q;
    }
  }
  for (; s0 < n_seg; ++s0) n_live += __popc(bal[s0]);
  int n_rows = __popc(bal[0]);  // the cell's own atoms: the compacted self block
  if (words == 2) n_rows += __popc(bal[1]);
  const int n_nb = n_live - n_rows;
  float* wacc = acc + warp * NC * NB;
  if (warp < n_rows) {
    for (int q = lane; q < n_nb; q += 32) {
#pragma unroll
      for (int d = 0; d < NC; ++d) wacc[d * NB + q] = 0.0f;
    }
  }
  __syncthreads();

  for (int r = warp; r < n_rows; r += ROW_WARPS) {
    const float4 ra = cand[r];
    int n_near = 0;  // the row's partners in reach, in candidate order
    for (int base = 0; base < n_live; base += 32) {
      const int q = base + lane;
      bool in = false;
      if (q < n_live && q != r) {
        float dx, dy, dz;
        in = pair_r2(p, ra, cand[q], dx, dy, dz) <= p.r2_far;
      }
      const unsigned m = __ballot_sync(0xffffffffu, in);
      if (in) near[n_near + __popc(m & ((1u << lane) - 1u))] = (short)q;
      n_near += __popc(m);
    }
    __syncwarp();
    float rx = 0.0f, ry = 0.0f, rz = 0.0f, re = 0.0f;
    for (int t = lane; t < n_near; t += 32) {
      const int q = near[t];
      const float4 b = cand[q];
      const bool cv = !TYPED || type_pair_ok(ctype[r], ctype[q], a.ti, a.tj);
      float gx, gy, gz, val;
      pair_force<ENERGY, LOOK>(p, lut, ra, b, cv, gx, gy, gz, val);
      rx += gx;
      ry += gy;
      rz += gz;
      if (q >= n_rows) {
        float* dst = wacc + (q - n_rows);
        dst[0] += gx;
        dst[NB] += gy;
        dst[2 * NB] += gz;
        if (VCRED) dst[3 * NB] += val;
        if (ENERGY) re += val;
      } else if (ENERGY) {
        re += VCRED ? val : 0.5f * val;
      }
    }
    // the next row rewrites the list, and another lane may credit a partner
    __syncwarp();
    const float tot = warp_sum4(rx, ry, rz, re, lane);
    const int i = __float_as_int(ra.w);  // the row's slot
    if (lane == 24) {
      eb_cell[i] = ENERGY ? tot : 0.0f;
    } else if ((lane & 7) == 0) {
      f_cell[3 * i + (lane >> 3)] = tot;
    }
  }
  __syncthreads();

  // credits at the candidates' slots: the warps' accumulators in warp order
  const int n_used = n_rows < ROW_WARPS ? n_rows : ROW_WARPS;
  for (int j = pitch + tid; j < 14 * pitch; j += ROW_THREADS) {
    const int sl = j & (pitch - 1);
    if (sl >= k) continue;
    const int q = qof[j];
    float s[NC];
#pragma unroll
    for (int d = 0; d < NC; ++d) s[d] = 0.0f;
    if (q >= 0) {
      for (int w = 0; w < n_used; ++w) {
#pragma unroll
        for (int d = 0; d < NC; ++d) s[d] += acc[(w * NC + d) * NB + q - n_rows];
      }
    }
    float* dst = cred_cell + (((j >> (5 + wsh)) - 1) * k + sl) * NC;
#pragma unroll
    for (int d = 0; d < NC; ++d) dst[d] = s[d];
  }
  for (int i = tid; i < cap; i += ROW_THREADS) {  // empty slots and rows >= k
    if (i >= k || qof[i] < 0) {
      f_cell[3 * i] = f_cell[3 * i + 1] = f_cell[3 * i + 2] = 0.0f;
      if (i < k) eb_cell[i] = 0.0f;
    }
  }
}

// The row pass's plan: the small form (k <= SMALL_K: the whole row in one
// piece, k1_rows) or the pieces form (k1_rows_pieces) with its piece and
// row tile; ops/cellforce.py:row_plan chooses it, the launcher checks it.
struct RowPlan {
  int small;  // 1: k1_rows
  int pww;  // ballot words (32 candidates each) a piece
  int rt;  // rows a tile
  int tsm;  // 1: the table in shared memory; 0: read from global memory
};

__host__ __device__ inline int cell_words(int k) { return (k + 31) >> 5; }  // ballot words a cell

// The pieces form (k1_rows_pieces): its blocks an SM (ops/cellforce.py's
// PIECE_BUDGET sizes its shared memory for three; its registers are capped
// to match, at 80), candidates a cull box (a chunk) and chunks a sweep step,
// the bits of a chunk's count beside its first candidate, the most ballot
// words a piece (a warp holds its words' candidates in registers over three
// rounds) and the most sub-cell bins a cell (2 x 2 x 2)
constexpr int PIECE_BLOCKS = 3;
constexpr int CHUNK = 8;
constexpr int STEP = 32 / CHUNK;
constexpr int CHUNK_BITS = 5, CHUNK_MASK = (1 << CHUNK_BITS) - 1;
constexpr int PIECE_WORDS = 3 * ROW_WARPS;
constexpr int PIECE_ROUNDS = PIECE_WORDS / ROW_WARPS;
constexpr int NKEY = 8;
static_assert(32 % CHUNK == 0 && CHUNK <= CHUNK_MASK, "chunks tile a warp; a count fits");

// The most chunks a piece of pww words holds: each of its cells (at most
// pww, at most 14) ends in one part-filled chunk
__host__ __device__ inline int max_chunks(int pww) {
  return 32 * pww / CHUNK + (pww < 14 ? pww : 14);
}

// The pieces form's dynamic shared memory, in float4 units: the lookup
// table (when in shared memory), a row tile's rows and their running sums
// (x, y, z, energy) and types, the own cell's ballot words, then a piece's
// compacted candidates and types, the warps' credit accumulators
// [warp][component][candidate], each slot's compacted index and the warps'
// lists of partners in reach (int16), the counting sort's offsets (int), the
// chunks' boxes (two float4 each: the centre with the chunk's first candidate
// << CHUNK_BITS | its count, and the half-widths), the warps' lists of the
// chunks in reach (int: first candidate << CHUNK_BITS | count) and the
// warps' counts of the cull (int64).
struct PieceLayout {
  int tab4, rows4, racc4, rtype4, obal4, cand4, ctype4, acc4, qof4, near4, scan4, box4, plist4,
      cnt4;
  __host__ __device__ int total4() const {
    return tab4 + rows4 + racc4 + rtype4 + obal4 + cand4 + ctype4 + acc4 + qof4 + near4 + scan4 +
           box4 + plist4 + cnt4;
  }
};

__host__ __device__ inline PieceLayout piece_layout(int k, int nc, bool typed, int look, int rows,
                                                    int degp, const RowPlan& pl) {
  const int PW = 32 * pl.pww, MC = max_chunks(pl.pww);
  PieceLayout l;
  l.tab4 = pl.tsm ? table4(look, rows, degp) : 0;
  l.rows4 = pl.rt;
  l.racc4 = pl.rt;
  l.rtype4 = typed ? (pl.rt + 3) / 4 : 0;
  l.obal4 = (cell_words(k) + 3) / 4;
  l.cand4 = PW;
  l.ctype4 = typed ? PW / 4 : 0;
  l.acc4 = ROW_WARPS * nc * PW / 4;
  l.qof4 = PW / 8;
  l.near4 = ROW_WARPS * PW / 8;
  l.scan4 = (NKEY * pl.pww + 2 + 3) / 4;
  l.box4 = 2 * MC;
  l.plist4 = (ROW_WARPS * MC + 3) / 4;
  l.cnt4 = ROW_WARPS * 3 * 8 / 16;
  return l;
}

// the lattice cell of a row block: the whole lattice's block b is cell b,
// a proper sub-box's block b its cell b, x-major
__device__ __forceinline__ int row_cell(const RowArgs& a, int row) {
  if (a.rx * a.ry * a.rz >= a.C) return row;
  const int bz = row % a.rz, by = (row / a.rz) % a.ry, bx = row / (a.ry * a.rz);
  return ((a.ox + bx) % a.nx) * (a.ny * a.nz) + ((a.oy + by) % a.ny) * a.nz + (a.oz + bz) % a.nz;
}

// Whether the cull's sort splits a cell along an axis (ops/cellforce.py:
// cull_bins): where a cell fills more than one chunk (k > CHUNK) and its
// edge L / n is at least half the reach; the split is at the cell's centre.
__device__ __forceinline__ bool bin_split(int k, float L, int n, float reach) {
  return k > CHUNK && 2.0f * (L / (float)n) >= reach;
}

// |minimum image of d| in a box test: the nearest image by a fused
// multiply-add (the boxes' slack covers its rounding)
__device__ __forceinline__ float cull_dist(float d, float L, float iL) {
  return fabsf(__fmaf_rn(-rintf(d * iL), L, d));
}

// A candidate's sub-cell bin: on each split axis (split: x, y, z the bits
// 4, 2, 1) the side of its cell's centre, (i + 1/2) L / n, it lies on by the
// minimum image, so an atom drifted out of its cell since the rebuild keeps
// the side it left by; x the high bit.  (i, j, l): the cell's coordinates.
__device__ __forceinline__ int bin_key(float4 b, int i, int j, int l, int split, const RowArgs& a,
                                       const PairParams& p) {
  const float v[3] = {b.x, b.y, b.z};
  const int ic[3] = {i, j, l}, n[3] = {a.nx, a.ny, a.nz};
  int key = 0;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float e = v[d] - ((float)ic[d] + 0.5f) * (p.L[d] / (float)n[d]);
    key = 2 * key + (((split >> (2 - d)) & 1) && __fmaf_rn(-rintf(e * p.iL[d]), p.L[d], e) > 0.0f);
  }
  return key;
}

// Whether a row at ra reaches chunk j's box (false for j >= n): the squared
// distance from the row to the box, by the minimum image, against r2_far;
// e: the chunk's first candidate << CHUNK_BITS | its count
__device__ __forceinline__ bool box_reach(const PairParams& p, const float4* box, float4 ra, int j,
                                          int n, int& e) {
  if (j >= n) return false;
  const float4 m = box[2 * j], h = box[2 * j + 1];
  e = __float_as_int(m.w);
  const float gx = fmaxf(cull_dist(ra.x - m.x, p.L[0], p.iL[0]) - h.x, 0.0f);
  const float gy = fmaxf(cull_dist(ra.y - m.y, p.L[1], p.iL[1]) - h.y, 0.0f);
  const float gz = fmaxf(cull_dist(ra.z - m.z, p.L[2], p.iL[2]) - h.z, 0.0f);
  return __fmaf_rn(gx, gx, __fmaf_rn(gy, gy, gz * gz)) <= p.r2_far;
}

// the compacted index of member i of the t-th chunk of a row's list (-1: none)
__device__ __forceinline__ int chunk_slot(const int* plist, int t, int i, int n_pass) {
  if (t >= n_pass) return -1;
  const int e = plist[t];
  return i < (e & CHUNK_MASK) ? (e >> CHUNK_BITS) + i : -1;
}

// whether candidate q (none: q < 0) is a partner of the row (slot rs) within
// reach, by k1_rows' test; j: its candidate index
__device__ __forceinline__ bool near_test(const PairParams& p, const float4* cand, float4 ra,
                                          int rs, int q, int& j) {
  j = 0;
  if (q < 0) return false;
  const float4 b = cand[q];
  j = __float_as_int(b.w);
  float dx, dy, dz;
  return j != rs && pair_r2(p, ra, b, dx, dy, dz) <= p.r2_far;
}

// The row pass at any k: k1_rows' work and outputs, its candidates and rows
// taken in pieces so that shared memory holds a bounded part of them, and
// each row's distance sweep culled by bounding boxes of its candidates.
//
// The candidates are the 14 cells' slots as ballot words, cell_words(k) a
// cell (word w: cell o = w / cell_words(k) in HALF_OFF order after the
// cell itself, slots 32 (w mod cell_words(k)) + lane; slots >= k are
// empty).  The own cell's occupied slots are the rows, compacted in slot
// order; a row tile of pl.rt of them at a time sits in shared memory with
// its running sums.  For each row tile the candidates are taken a piece of
// pl.pww words at a time:
//   - sort: a warp a word loads its occupied slots into registers and keys
//     each by its sub-cell bin (bin_key: the side of its cell's centre it
//     lies on, along each axis); one warp scans the (cell, bin, word) counts; each
//     candidate goes to its cell's, bin's and word's offset plus its rank
//     among the word's lanes of its bin: a counting sort in a fixed order,
//     no atomics.  qof maps each slot to its compacted index;
//   - chunks: each cell's part of the piece, so ordered, is cut into chunks
//     of CHUNK candidates; CHUNK lanes a chunk take its members' bounding box,
//     each member's minimum image from the first member's (so a chunk that
//     straddles the periodic boundary, or whose atoms drifted out of their
//     cell, stays small), kept as a centre and half-widths widened by
//     2^-12 of the box and the centre's magnitude (far above the rounding of
//     the few operations that place the box);
//   - rows: warp w takes rows w, w + ROW_WARPS, ... of the tile.  A row
//     first tests the chunks' boxes (the squared distance from the row to a
//     box, by the minimum image, against r2_far: a candidate that reaches the
//     row lies in a box that does) and lists the chunks that pass, then
//     sweeps only their candidates, CHUNK lanes a chunk, testing r^2 as
//     k1_rows does: the partners in reach are exactly those of a sweep over
//     every candidate, in candidate order.  Both loops take two independent
//     steps a trip, so that their load-to-ballot chains overlap.  It sums the
//     pair terms over its
//     lanes (one warp_sum4 a row and piece, added into the row's running
//     sums: every piece of a row is taken by the same warp, in order) and
//     credits the partners into its own accumulator.
// After each piece the warps' accumulators are summed in warp order and
// written at the piece's slots of the credit scratch (the first row tile
// writes every slot, empty ones 0; a later tile adds its credits to the
// occupied ones).  A candidate of the own cell (the self block) is no partner
// of itself (by slot) and is credited nothing; its value counts half
// (VCRED: whole).  After a row tile's last piece its rows' sums are written
// into f and eb.  No atomics but the counts: the order is fixed.
//
// What bounds it, at in.lj's shape (4,000,000 atoms, 41^3 cells of 4.097,
// k = 96, reach 4.0, pieces of 14 words; NVIDIA H100 80GB HBM3 at 700 W, one
// launch's device time): not the card's rates (the least time for its work,
// each unordered pair within reach once at 48 + 16 operations, is 0.43 ms)
// but instructions issued and their latency at three blocks of 8 warps an
// SM.  Before the cull, on the state 30 steps from the fcc lattice (by
// cutting the kernel short after each phase), it took 14.45 ms: loads,
// ballots and compaction 2.42, the distance sweep 6.98 (27 warp steps a
// row, 86% of the tests finding nothing), the pair arithmetic over the ~134
// partners a row finds 4.41, the credits 0.65.  There the cull keeps 38%
// of the r^2 tests (k1.tested / k1.unculled; 8 candidates a box, 2 x 2 x 2
// bins a cell): the sweep takes 3.44 ms (~12 steps a row) for 1.54 of box
// tests (two of 32 lanes a row and piece) and 0.33 of boxes, the sort what
// the compaction did, 12.9 ms in all (30x the bound).  On the liquid of the
// benchmark's window (800 steps in) the boxes of 8 are looser and it keeps
// 45%: 14.95 -> 13.97 ms (35x -> 32x the bound).  Boxes of 16 candidates
// cost fewer tests and more sweep steps (13.2 ms at the lattice-like state);
// a row's unrolled loops spill ~140 bytes at the 80-register cap, still
// faster than 128 registers at two blocks an SM (17.6 ms).
//
// cnt (null: nothing counted): each block adds, once, the r^2 tests a sweep
// over every occupied candidate would run (rows x candidates), those run
// (the candidates of the chunks that passed) and the unordered pairs found
// in reach (a self-block pair once).
//
// TSM: the table in shared memory, else read from global memory through
// the cache (a Chebyshev table past TABLE_SMEM_MAX); a template parameter,
// so that each form's loads are compiled for their memory.
template <bool ENERGY, int LOOK, bool TYPED, bool VCRED, bool TSM>
__global__ void __launch_bounds__(ROW_THREADS, PIECE_BLOCKS)
    k1_rows_pieces(RowArgs a, PairParams p, RowPlan pl, unsigned long long* cnt) {
  extern __shared__ float4 smem[];
  constexpr int NC = VCRED ? 4 : 3;
  const int k = a.k, cap = a.cap, NB = 13 * k;
  const int row = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int c = row_cell(a, row);
  float* f_cell = a.f + (long)c * cap * 3;
  float* eb_cell = a.eb + (long)row * k;
  float* cred_cell = a.cred + (long)row * NB * NC;
  if (c >= a.C) {  // a pad cell
    for (int i = tid; i < cap * 3; i += ROW_THREADS) f_cell[i] = 0.0f;
    for (int i = tid; i < k; i += ROW_THREADS) eb_cell[i] = 0.0f;
    for (int i = tid; i < NB * NC; i += ROW_THREADS) cred_cell[i] = 0.0f;
    return;
  }

  const int wpc = cell_words(k), n_words = 14 * wpc, PW = 32 * pl.pww, RT = pl.rt;
  const int MC = max_chunks(pl.pww);
  const int self_end = 32 * wpc;  // candidate indices below it are the own cell's slots
  const PieceLayout lay = piece_layout(k, NC, TYPED, LOOK, p.G, p.degp, pl);
  float4* tab = smem;
  float4* rows = tab + lay.tab4;  // x, y, z, slot (as bits)
  float4* racc = rows + lay.rows4;  // the rows' running sums: gx, gy, gz, val
  float* rtype = reinterpret_cast<float*>(racc + lay.racc4);
  unsigned* obal = reinterpret_cast<unsigned*>(rtype + 4 * lay.rtype4);
  float4* cand = reinterpret_cast<float4*>(obal + 4 * lay.obal4);  // x, y, z, index (as bits)
  float* ctype = reinterpret_cast<float*>(cand + lay.cand4);
  float* acc = ctype + 4 * lay.ctype4;  // [warp][component][PW]
  short* qof = reinterpret_cast<short*>(acc + 4 * lay.acc4);
  short* near = qof + 8 * lay.qof4 + warp * PW;
  int* scan = reinterpret_cast<int*>(qof + 8 * (lay.qof4 + lay.near4));
  float4* box = reinterpret_cast<float4*>(scan + 4 * lay.scan4);  // centre, half-widths
  int* plist = reinterpret_cast<int*>(box + lay.box4) + warp * MC;
  unsigned long long* wcnt = reinterpret_cast<unsigned long long*>(box + lay.box4 + lay.plist4);
  if (TSM) load_table(tab, a.t1, a.t2, p, LOOK);
  const Lut lut = TSM ? smem_lut(tab, p) : global_lut(a.t1, a.t2);
  unsigned n_unculled = 0, n_tested = 0, n_reach = 0;  // this warp's counts (cnt)

  // the rows' sums overwrite these at the end of their tile
  for (int i = tid; i < cap * 3; i += ROW_THREADS) f_cell[i] = 0.0f;
  for (int i = tid; i < k; i += ROW_THREADS) eb_cell[i] = 0.0f;
  for (int w = warp; w < wpc; w += ROW_WARPS) {
    const int sl = 32 * w + lane;
    const bool live = sl < k && a.mc[(long)row * cap + sl] > 0.5f;
    const unsigned b = __ballot_sync(0xffffffffu, live);
    if (lane == 0) obal[w] = b;
  }
  __syncthreads();
  int n_rows = 0;
  for (int w = 0; w < wpc; ++w) n_rows += __popc(obal[w]);
  if (n_rows == 0) {  // no rows: no credits
    for (int i = tid; i < NB * NC; i += ROW_THREADS) cred_cell[i] = 0.0f;
    return;
  }

  for (int rt0 = 0; rt0 < n_rows; rt0 += RT) {
    const int nr = min(RT, n_rows - rt0);
    // the tile's rows: the own cell's occupied slots of rank rt0 .. rt0 + nr
    for (int w = warp; w < wpc; w += ROW_WARPS) {
      int before = 0;
      for (int v = 0; v < w; ++v) before += __popc(obal[v]);
      const unsigned b = obal[w];
      if ((b >> lane) & 1u) {
        const int rk = before + __popc(b & below) - rt0;
        if (rk >= 0 && rk < nr) {
          const int sl = 32 * w + lane;
          const long slot = (long)c * cap + sl;
          rows[rk] = make_float4(a.xs[3 * slot], a.xs[3 * slot + 1], a.xs[3 * slot + 2],
                                 __int_as_float(sl));
          if (TYPED) rtype[rk] = a.ts[slot];
        }
      }
    }
    for (int i = tid; i < nr; i += ROW_THREADS) racc[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

    for (int w0 = 0; w0 < n_words; w0 += pl.pww) {
      const int nw = min(pl.pww, n_words - w0);
      // sort, 1: the piece's occupied slots into registers, each keyed by
      // its bin; the counts of each (word, bin) at the word's place in the
      // (cell, bin, word) order: cell o's words sa .. sb - 1 of the piece
      // take entries NKEY sa .. NKEY sb - 1, bin-major
      const float reach = sqrtf(p.r2_far);
      const int split = 4 * bin_split(k, p.L[0], a.nx, reach) +
                        2 * bin_split(k, p.L[1], a.ny, reach) + bin_split(k, p.L[2], a.nz, reach);
      const int ix = c / (a.ny * a.nz), iy = (c / a.nz) % a.ny, iz = c % a.nz;
      float4 got[PIECE_ROUNDS];
      int kr[PIECE_ROUNDS];  // bin << 8 | rank among the word's lanes of its bin; -1 empty
#pragma unroll
      for (int i = 0; i < PIECE_ROUNDS; ++i) {
        const int s = warp + i * ROW_WARPS;
        kr[i] = -1;
        if (s < nw) {
          const int w = w0 + s, o = w / wpc, sl = 32 * (w - o * wpc) + lane;
          int ci = ix, cj = iy, cl = iz;  // the words' cell: c's neighbour at HALF_OFF[o - 1]
          if (o > 0) {
            ci = wrap(ix + HALF_OFF[o - 1][0], a.nx);
            cj = wrap(iy + HALF_OFF[o - 1][1], a.ny);
            cl = wrap(iz + HALF_OFF[o - 1][2], a.nz);
          }
          bool live = false;
          int key = 0;
          if (sl < k) {
            const long slot = ((long)(ci * a.ny + cj) * a.nz + cl) * cap + sl;
            live = (o == 0 ? a.mc[(long)row * cap + sl] : a.mcand[slot]) > 0.5f;
            if (live) {
              got[i] = make_float4(a.xs[3 * slot], a.xs[3 * slot + 1], a.xs[3 * slot + 2],
                                   TYPED ? a.ts[slot] : 0.0f);
              key = bin_key(got[i], ci, cj, cl, split, a, p);
            }
          }
          int n_key = 0;
#pragma unroll
          for (int v = 0; v < NKEY; ++v) {
            const unsigned m = __ballot_sync(0xffffffffu, live && key == v);
            if (lane == v) n_key = __popc(m);
            if (live && key == v) kr[i] = (v << 8) | __popc(m & below);
          }
          const int sa = max(o * wpc, w0) - w0, sb = min((o + 1) * wpc, w0 + nw) - w0;
          if (lane < NKEY) scan[NKEY * sa + lane * (sb - sa) + s - sa] = n_key;
        }
      }
      __syncthreads();
      // sort, 2 (one warp): the offsets, an exclusive scan in that order,
      // its total (the piece's candidates) at NKEY nw; then each cell's
      // chunks, a lane a cell, and their count at NKEY pww + 1
      const int E = NKEY * nw;
      if (warp == 0) {
        const int per = (E + 31) / 32, i0 = min(E, lane * per), i1 = min(E, i0 + per);
        int sum = 0;
        for (int i = i0; i < i1; ++i) sum += scan[i];
        int run = sum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int t = __shfl_up_sync(0xffffffffu, run, o);
          if (lane >= o) run += t;
        }
        if (lane == 31) scan[E] = run;
        run -= sum;
        for (int i = i0; i < i1; ++i) {
          const int v = scan[i];
          scan[i] = run;
          run += v;
        }
        __syncwarp();
        const int oc0 = w0 / wpc, ncp = (w0 + nw - 1) / wpc - oc0 + 1;  // the piece's cells
        int start = 0, n_c = 0;
        if (lane < ncp) {
          const int o = oc0 + lane;
          const int sa = max(o * wpc, w0) - w0, sb = min((o + 1) * wpc, w0 + nw) - w0;
          start = scan[NKEY * sa];
          n_c = scan[NKEY * sb] - start;
        }
        const int n_ch = (n_c + CHUNK - 1) / CHUNK;
        int base = n_ch;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int t = __shfl_up_sync(0xffffffffu, base, o);
          if (lane >= o) base += t;
        }
        if (lane == 31) scan[NKEY * pl.pww + 1] = base;
        base -= n_ch;
        for (int j = 0; j < n_ch; ++j)
          reinterpret_cast<int*>(box + 2 * (base + j))[3] =
              ((start + CHUNK * j) << CHUNK_BITS) | min(CHUNK, n_c - CHUNK * j);
      }
      __syncthreads();
      // sort, 3: each candidate to its place
      const int n_live = scan[E], n_chunks = scan[NKEY * pl.pww + 1];
#pragma unroll
      for (int i = 0; i < PIECE_ROUNDS; ++i) {
        const int s = warp + i * ROW_WARPS;
        if (s < nw) {
          int q = -1;
          if (kr[i] >= 0) {
            const int w = w0 + s, o = w / wpc;
            const int sa = max(o * wpc, w0) - w0, sb = min((o + 1) * wpc, w0 + nw) - w0;
            q = scan[NKEY * sa + (kr[i] >> 8) * (sb - sa) + s - sa] + (kr[i] & 255);
            cand[q] = make_float4(got[i].x, got[i].y, got[i].z, __int_as_float(32 * w + lane));
            if (TYPED) ctype[q] = got[i].w;
          }
          qof[32 * s + lane] = (short)q;
        }
      }
      float* wacc = acc + warp * NC * PW;
      if (warp < nr) {
        for (int q = lane; q < n_live; q += 32) {
#pragma unroll
          for (int d = 0; d < NC; ++d) wacc[d * PW + q] = 0.0f;
        }
      }
      __syncthreads();
      // the chunks' boxes, CHUNK lanes a chunk: each member's minimum image
      // from the first member, their range over the chunk's lanes
      for (int j0 = warp * STEP; j0 < n_chunks; j0 += ROW_WARPS * STEP) {
        const int j = j0 + lane / CHUNK, i = lane % CHUNK;
        int e = 0;
        if (j < n_chunks) e = __float_as_int(box[2 * j].w);
        const bool mine = i < (e & CHUNK_MASK);
        const float4 b = cand[mine ? (e >> CHUNK_BITS) + i : 0];
        const int first = lane & ~(CHUNK - 1);
        const float4 b0 = make_float4(__shfl_sync(0xffffffffu, b.x, first),
                                      __shfl_sync(0xffffffffu, b.y, first),
                                      __shfl_sync(0xffffffffu, b.z, first), 0.0f);
        float d[3];
        pair_r2(p, b, b0, d[0], d[1], d[2]);
        float lo[3], hi[3];
#pragma unroll
        for (int x = 0; x < 3; ++x) lo[x] = hi[x] = mine ? d[x] : 0.0f;
#pragma unroll
        for (int o = 1; o < CHUNK; o <<= 1) {
#pragma unroll
          for (int x = 0; x < 3; ++x) {
            lo[x] = fminf(lo[x], __shfl_xor_sync(0xffffffffu, lo[x], o));
            hi[x] = fmaxf(hi[x], __shfl_xor_sync(0xffffffffu, hi[x], o));
          }
        }
        if (i == 0 && j < n_chunks) {
          const float cx = b0.x + 0.5f * (lo[0] + hi[0]), cy = b0.y + 0.5f * (lo[1] + hi[1]),
                      cz = b0.z + 0.5f * (lo[2] + hi[2]);
          constexpr float SLACK = 1.0f / 4096.0f;
          box[2 * j] = make_float4(cx, cy, cz, __int_as_float(e));
          box[2 * j + 1] = make_float4(0.5f * (hi[0] - lo[0]) + (p.L[0] + fabsf(cx)) * SLACK,
                                       0.5f * (hi[1] - lo[1]) + (p.L[1] + fabsf(cy)) * SLACK,
                                       0.5f * (hi[2] - lo[2]) + (p.L[2] + fabsf(cz)) * SLACK,
                                       0.0f);
        }
      }
      __syncthreads();

      for (int r = warp; r < nr; r += ROW_WARPS) {
        const float4 ra = rows[r];
        const int rs = __float_as_int(ra.w);
        // the chunks whose box the row reaches, in chunk order, 64 at a
        // time (two independent tests a lane)
        int n_pass = 0;
        for (int j0 = 0; j0 < n_chunks; j0 += 64) {
          int ea, eb;
          const bool ia = box_reach(p, box, ra, j0 + lane, n_chunks, ea);
          const bool ib = box_reach(p, box, ra, j0 + 32 + lane, n_chunks, eb);
          const unsigned ma = __ballot_sync(0xffffffffu, ia);
          if (ia) plist[n_pass + __popc(ma & below)] = ea;
          n_pass += __popc(ma);
          const unsigned mb = __ballot_sync(0xffffffffu, ib);
          if (ib) plist[n_pass + __popc(mb & below)] = eb;
          n_pass += __popc(mb);
        }
        __syncwarp();
        // the row's partners in reach, in candidate order: STEP chunks a
        // sweep step, CHUNK lanes a chunk, two steps at a time
        int n_near = 0;
        for (int t0 = 0; t0 < n_pass; t0 += 2 * STEP) {
          int ja, jb;
          const int qa = chunk_slot(plist, t0 + lane / CHUNK, lane % CHUNK, n_pass);
          const int qb = chunk_slot(plist, t0 + STEP + lane / CHUNK, lane % CHUNK, n_pass);
          const bool ia = near_test(p, cand, ra, rs, qa, ja);
          const bool ib = near_test(p, cand, ra, rs, qb, jb);
          const unsigned ma = __ballot_sync(0xffffffffu, ia);
          if (ia) near[n_near + __popc(ma & below)] = (short)qa;
          n_near += __popc(ma);
          const unsigned mb = __ballot_sync(0xffffffffu, ib);
          if (ib) near[n_near + __popc(mb & below)] = (short)qb;
          n_near += __popc(mb);
          if (cnt != nullptr) {
            n_tested += __popc(__ballot_sync(0xffffffffu, qa >= 0)) +
                        __popc(__ballot_sync(0xffffffffu, qb >= 0));
            n_reach += __popc(__ballot_sync(0xffffffffu, ia && (ja >= self_end || ja > rs))) +
                       __popc(__ballot_sync(0xffffffffu, ib && (jb >= self_end || jb > rs)));
          }
        }
        n_unculled += n_live;
        __syncwarp();
        float rx = 0.0f, ry = 0.0f, rz = 0.0f, re = 0.0f;
        for (int t = lane; t < n_near; t += 32) {
          const int q = near[t];
          const float4 b = cand[q];
          const bool cv = !TYPED || type_pair_ok(rtype[r], ctype[q], a.ti, a.tj);
          float gx, gy, gz, val;
          pair_force<ENERGY, LOOK>(p, lut, ra, b, cv, gx, gy, gz, val);
          rx += gx;
          ry += gy;
          rz += gz;
          if (__float_as_int(b.w) >= self_end) {
            float* dst = wacc + q;
            dst[0] += gx;
            dst[PW] += gy;
            dst[2 * PW] += gz;
            if (VCRED) dst[3 * PW] += val;
            if (ENERGY) re += val;
          } else if (ENERGY) {
            re += VCRED ? val : 0.5f * val;
          }
        }
        // the next row rewrites the lists, and another lane may credit a partner
        __syncwarp();
        const float tot = warp_sum4(rx, ry, rz, re, lane);
        if ((lane & 7) == 0) reinterpret_cast<float*>(racc + r)[lane >> 3] += tot;
      }
      __syncthreads();

      // the piece's credits at its neighbour slots: the warps' accumulators
      // in warp order
      const int n_used = nr < ROW_WARPS ? nr : ROW_WARPS;
      for (int j = tid; j < 32 * nw; j += ROW_THREADS) {
        const int w = w0 + (j >> 5), o = w / wpc, sl = 32 * (w - o * wpc) + (j & 31);
        if (o == 0 || sl >= k) continue;
        const int q = qof[j];
        float sum[NC];
#pragma unroll
        for (int d = 0; d < NC; ++d) sum[d] = 0.0f;
        if (q >= 0) {
          for (int v = 0; v < n_used; ++v) {
#pragma unroll
            for (int d = 0; d < NC; ++d) sum[d] += acc[(v * NC + d) * PW + q];
          }
        }
        float* dst = cred_cell + ((o - 1) * k + sl) * NC;
        if (rt0 == 0) {
#pragma unroll
          for (int d = 0; d < NC; ++d) dst[d] = sum[d];
        } else if (q >= 0) {
#pragma unroll
          for (int d = 0; d < NC; ++d) dst[d] += sum[d];
        }
      }
      __syncthreads();  // the next piece rewrites the lists
    }

    // the tile's rows
    for (int i = tid; i < nr; i += ROW_THREADS) {
      const float4 sum = racc[i];
      const int sl = __float_as_int(rows[i].w);
      f_cell[3 * sl] = sum.x;
      f_cell[3 * sl + 1] = sum.y;
      f_cell[3 * sl + 2] = sum.z;
      eb_cell[sl] = ENERGY ? sum.w : 0.0f;
    }
    __syncthreads();  // the next tile rewrites the rows
  }
  if (cnt != nullptr) {  // the block's counts, warps in order
    if (lane == 0) {
      wcnt[3 * warp] = n_unculled;
      wcnt[3 * warp + 1] = n_tested;
      wcnt[3 * warp + 2] = n_reach;
    }
    __syncthreads();
    if (tid < 3) {
      unsigned long long s = 0;
      for (int w = 0; w < ROW_WARPS; ++w) s += wcnt[3 * w + tid];
      atomicAdd(cnt + tid, s);
    }
  }
}

// The second pass of K1, one thread per element of the force planes f
// (Cg cells x cap x 3): a cell of the row box keeps its row sums, any other
// cell starts from 0; each then subtracts, in HALF_OFF order, the credits
// of its 13 source cells, an exact 0 for a source outside the row box (it
// has no rows): what the whole-lattice pass subtracts there, so the
// owned-row pass is bitwise the whole-lattice pass with the rows outside
// the box masked out.  Zeros at slots >= k and pad cells.
__global__ void __launch_bounds__(CREDIT_THREADS) k1_credits(RowArgs a, int Cg) {
  const long t = (long)blockIdx.x * CREDIT_THREADS + threadIdx.x;
  if (t >= (long)Cg * a.cap * 3) return;
  const int d = (int)(t % 3);
  const long slot = t / 3;
  const int c = (int)(slot / a.cap), s = (int)(slot - (long)c * a.cap);
  if (c >= a.C || s >= a.k) {
    a.f[t] = 0.0f;
    return;
  }
  const int nx = a.nx, ny = a.ny, nz = a.nz;
  const int ix = c / (ny * nz), iy = (c / nz) % ny, iz = c % nz;
  float inc[13];
#pragma unroll
  for (int o = 0; o < 13; ++o) {
    // the source cell whose offset-o neighbour is c, as a row of the box; a
    // source outside the box credits an exact 0 (its load, of row 0, is
    // discarded: unconditional, so that the 13 loads are all in flight)
    const int bx = wrap(ix - HALF_OFF[o][0], nx) - a.ox, by = wrap(iy - HALF_OFF[o][1], ny) - a.oy,
              bz = wrap(iz - HALF_OFF[o][2], nz) - a.oz;
    const bool in = bx >= 0 && bx < a.rx && by >= 0 && by < a.ry && bz >= 0 && bz < a.rz;
    const long src = in ? (bx * a.ry + by) * a.rz + bz : 0;
    const float cv = __ldg(a.cred + ((src * 13 + o) * a.k + s) * 3 + d);
    inc[o] = in ? cv : 0.0f;
  }
  const bool own = ix >= a.ox && ix < a.ox + a.rx && iy >= a.oy && iy < a.oy + a.ry &&
                   iz >= a.oz && iz < a.oz + a.rz;
  float v = own ? a.f[t] : 0.0f;
#pragma unroll
  for (int o = 0; o < 13; ++o) v -= inc[o];
  a.f[t] = v;
}

// The second pass of K7, one thread per slot and component (4: the value
// too): subtracts the slot's 13 incoming force credits in HALF_OFF order,
// adds the value credits onto eb.  The rows are the whole lattice.
__global__ void __launch_bounds__(CREDIT_THREADS) k7_credits(RowArgs a) {
  const int k = a.k, nx = a.nx, ny = a.ny, nz = a.nz;
  const int t = blockIdx.x * CREDIT_THREADS + threadIdx.x;
  if (t >= a.C * k * 4) return;
  const int d = t % 4, slot = t / 4;
  const int c = slot / k, s = slot - c * k;
  const int ix = c / (ny * nz), iy = (c / nz) % ny, iz = c % nz;
  float inc[13];
#pragma unroll
  for (int o = 0; o < 13; ++o) {
    // the cell whose offset-o neighbour is c
    const int src = wrap(ix - HALF_OFF[o][0], nx) * (ny * nz) + wrap(iy - HALF_OFF[o][1], ny) * nz +
                    wrap(iz - HALF_OFF[o][2], nz);
    inc[o] = __ldg(a.cred + (((long)src * 13 + o) * k + s) * 4 + d);
  }
  float* dst = d < 3 ? a.f + ((long)c * a.cap + s) * 3 + d : a.eb + slot;
  float v = *dst;
#pragma unroll
  for (int o = 0; o < 13; ++o) v = d < 3 ? v - inc[o] : v + inc[o];
  *dst = v;
}

// ---------------------------------------------------------------- K2

// K2's dynamic shared memory, in float4 units: the Chebyshev series (a
// Hermite table stays in global memory: a row of it is read only for a pair
// within reach, through the cache; so does a Chebyshev table past
// TABLE_SMEM_MAX), the tail rows a block works on, compacted (at most a
// row tile: K2_THREADS rows), and the warps' accumulators [warp][row].
struct K2Layout {
  int tab4, rows4, acc4;
  __host__ __device__ int total4() const { return tab4 + rows4 + acc4; }
};

__host__ __device__ inline K2Layout k2_layout(int O, int look, int rows, int degp, int tsm) {
  const int R = O < K2_THREADS ? O : K2_THREADS;
  return K2Layout{look == HERMITE || !tsm ? 0 : table4(look, rows, degp), R, K2_WARPS * R};
}

// K2's sweep, block (t, y): row tile y, the tail rows y K2_THREADS ..
// (y + 1) K2_THREADS - 1.  Block t < n_low takes the tile t of K2_THREADS
// low slots as its partners, a thread per partner, against the tile's live
// tail rows; a block t >= n_low is a tail-tail block: its partners are the
// tail rows of tile t - n_low themselves (the live ones count), its rows
// those with `own`, a row never paired with itself, the energy halved, no
// credit written (both orders are present).  A low block writes its
// partners' credits: fp (a masked partner's 0) when there is one row tile,
// else its tile's sums into fpart[y] for k2_finish to add in tile order.
// Either way a block writes, for each of its rows, the block's partial
// (gx, gy, gz, val) at part[t][row]; other rows' partials stay unwritten.
// TSM (Chebyshev only): the series in shared memory, else read from global
// memory; a template parameter, so that the loads are compiled for their
// memory.
template <bool ENERGY, int LOOK, bool TSM>
__global__ void __launch_bounds__(K2_THREADS)
k2_partners(const float* __restrict__ xo, const float* __restrict__ xp,
            const float* __restrict__ t1, const float* __restrict__ t2,
            float* __restrict__ fp, float* __restrict__ fpart, float4* __restrict__ part, int O,
            int N, int n_low, PairParams p) {
  extern __shared__ float4 smem[];
  __shared__ int wcount[K2_WARPS];
  const K2Layout lay = k2_layout(O, LOOK, p.G, p.degp, TSM);
  if (TSM) load_table(smem, t1, t2, p, LOOK);
  const Lut lut = TSM ? smem_lut(smem, p) : global_lut(t1, t2);
  float4* rows = smem + lay.tab4;  // the block's rows in row order: x, y, z, row (as bits)
  float4* acc = rows + lay.rows4;  // [warp][row]: gx, gy, gz, val

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const bool tail = (int)blockIdx.x >= n_low;
  const int r0 = blockIdx.y * K2_THREADS, nr = min(K2_THREADS, O - r0);
  const int n = (tail ? blockIdx.x - n_low : blockIdx.x) * K2_THREADS + tid;
  float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (tail) {
    if (n < O) b = make_float4(xo[n], xo[O + n], xo[2 * O + n], xo[3 * O + n]);
  } else if (n < N) {
    b = make_float4(xp[n], xp[N + n], xp[2 * N + n], xp[3 * N + n]);
  }

  // compact the block's tail rows, a thread per row of the tile
  bool mine_row = false;
  float4 a = b;
  if (tid < nr) {
    const int i = r0 + tid;
    mine_row = xo[(tail ? 4 : 3) * O + i] > 0.5f;
    a = make_float4(xo[i], xo[O + i], xo[2 * O + i], __int_as_float(i));
  }
  const unsigned bal = __ballot_sync(0xffffffffu, mine_row);
  if (lane == 0) wcount[warp] = __popc(bal);
  __syncthreads();
  int off = 0, n_rows = 0;
#pragma unroll
  for (int w = 0; w < K2_WARPS; ++w) {
    off += (w < warp) ? wcount[w] : 0;
    n_rows += wcount[w];
  }
  if (mine_row) rows[off + __popc(bal & ((1u << lane) - 1u))] = a;
  float4* wacc = acc + warp * lay.rows4;
  for (int q = lane; q < n_rows; q += 32) wacc[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();

  const bool placed = b.w > 0.5f;
  const int self = tail ? n : -1;  // the row this partner is, in a tail-tail block
  float cx = 0.0f, cy = 0.0f, cz = 0.0f;
  for (int q0 = 0; q0 < n_rows; q0 += 32) {
    // the rows within reach of this partner, 32 rows at a time
    const int nq = min(32, n_rows - q0);
    unsigned mine = 0;
    if (placed) {
#pragma unroll 4
      for (int q = 0; q < nq; ++q) {
        a = rows[q0 + q];
        float dx, dy, dz;
        if (pair_r2(p, a, b, dx, dy, dz) <= p.r2_far && __float_as_int(a.w) != self)
          mine |= 1u << q;
      }
    }
    // the rows some lane of the warp reaches, K2_BATCH at a time: their pair
    // terms are independent, so the batch's arithmetic overlaps
    unsigned any = __reduce_or_sync(0xffffffffu, mine);
    while (any) {
      int qs[K2_BATCH];
      float g[K2_BATCH][4];
#pragma unroll
      for (int u = 0; u < K2_BATCH; ++u) {
        qs[u] = any ? __ffs(any) - 1 : -1;
        any &= any - 1;
      }
#pragma unroll
      for (int u = 0; u < K2_BATCH; ++u) {
        const int q = max(qs[u], 0);
        pair_force<ENERGY, LOOK>(p, lut, rows[q0 + q], b, true, g[u][0], g[u][1], g[u][2],
                                 g[u][3]);
        if (qs[u] < 0 || !((mine >> q) & 1u)) g[u][0] = g[u][1] = g[u][2] = g[u][3] = 0.0f;
        if (tail) g[u][3] *= 0.5f;
      }
#pragma unroll
      for (int u = 0; u < K2_BATCH; ++u) {
        cx += g[u][0];
        cy += g[u][1];
        cz += g[u][2];
        // a warp meets a row once: its sum over the lanes, one fixed tree
        const float tot = warp_sum4(g[u][0], g[u][1], g[u][2], g[u][3], lane);
        if (qs[u] >= 0 && (lane & 7) == 0)
          reinterpret_cast<float*>(wacc + q0 + qs[u])[lane >> 3] = tot;
      }
    }
  }
  if (!tail && n < N) {
    if (gridDim.y == 1) {
      fp[n] = -cx;
      fp[N + n] = -cy;
      fp[2 * N + n] = -cz;
    } else {
      float* fq = fpart + (long)blockIdx.y * 3 * N;
      fq[n] = cx;
      fq[N + n] = cy;
      fq[2 * N + n] = cz;
    }
  }
  __syncthreads();
  for (int q = tid; q < n_rows; q += K2_THREADS) {  // the block's partials, warps in order
    float4 s = acc[q];
    for (int w = 1; w < K2_WARPS; ++w) {
      const float4 t = acc[w * lay.rows4 + q];
      s.x += t.x;
      s.y += t.y;
      s.z += t.z;
      s.w += t.w;
    }
    part[(long)blockIdx.x * O + __float_as_int(rows[q].w)] = s;
  }
}

// K2's finish.  Blocks below row_blocks: fo of tail row i, a warp per row,
// lanes striding over the blocks' partials: those of the n_low low tiles
// count for a live row, those of the tail-tail blocks (n_low .. n_all - 1)
// for a row with `own`; then one shuffle tree.  A partial that does not
// count may be unwritten: it is read and dropped.  Writes fo whole: zeros
// at rows that are neither live nor owned, and in the energy row when the
// sweep took no energy (its partials carry 0 there).  With n_rt > 1 row
// tiles the blocks from row_blocks on write fp, a thread an element: minus
// the tiles' credit sums added in tile order.
__global__ void __launch_bounds__(K2_THREADS)
k2_finish(const float* __restrict__ xo, const float4* __restrict__ part,
          const float* __restrict__ fpart, float* __restrict__ fo, float* __restrict__ fp, int O,
          int N, int n_low, int n_all, int row_blocks, int n_rt) {
  if ((int)blockIdx.x >= row_blocks) {
    const long t = (long)(blockIdx.x - row_blocks) * K2_THREADS + threadIdx.x;
    if (t >= 3L * N) return;
    float s = 0.0f;
    for (int y = 0; y < n_rt; ++y) s += fpart[(long)y * 3 * N + t];
    fp[t] = -s;
    return;
  }
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * K2_WARPS + (threadIdx.x >> 5);
  if (i >= O) return;
  const bool live = xo[3 * O + i] > 0.5f, own = xo[4 * O + i] > 0.5f;
  float sx = 0.0f, sy = 0.0f, sz = 0.0f, sv = 0.0f;
  for (int t = lane; t < n_all; t += 32) {
    const float4 v = part[(long)t * O + i];
    if (t < n_low ? live : own) {
      sx += v.x;
      sy += v.y;
      sz += v.z;
      sv += v.w;
    }
  }
  const float tot = warp_sum4(sx, sy, sz, sv, lane);
  if ((lane & 7) == 0) fo[(lane >> 3) * O + i] = tot;
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
  const double hi = degp > 0 ? p.g1 : fmin(p.g2, p.g4);  // Chebyshev hi | Hermite ghi, bhi
  const double far = fmax((double)p.rcut, hi);
  p.r2_far = (float)(far * far * (1.0 + 1e-5));
  return p;
}

// The shared memory of a row-pass plan, in bytes, or -1 when the plan is
// no valid one: the small form needs k <= SMALL_K and the table in shared
// memory; the pieces form a piece of 1 to 14 cell_words(k) words, at most
// PIECE_WORDS, and a row tile of 1 to k rows; either must fit SMEM_MAX.
int row_bytes(int k, int nc, bool typed, int look, int rows, int degp, const RowPlan& pl) {
  long bytes;
  if (pl.small) {
    if (k > SMALL_K || !pl.tsm) return -1;
    bytes = 16L * row_layout(k, nc, typed, look, rows, degp).total4();
  } else {
    if (pl.pww < 1 || pl.pww > 14 * cell_words(k) || pl.pww > PIECE_WORDS || pl.rt < 1 ||
        pl.rt > k ||
        (look == HERMITE && !pl.tsm))
      return -1;
    bytes = 16L * piece_layout(k, nc, typed, look, rows, degp, pl).total4();
  }
  return bytes <= SMEM_MAX ? (int)bytes : -1;
}

// raise a kernel's dynamic shared memory limit above the 48 KB default
template <class Kern>
cudaError_t smem_limit(Kern kern, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The row pass by the plan's form, one block per row (the row box's R
// cells, then the pad cells up to n_rows), then (credits) the second pass:
// k1_credits over the Cg cells of f, or k7_credits with the value.  cnt:
// the pieces form's counts of its cull (k1_rows_pieces), or null.
template <bool ENERGY, int LOOK, bool TYPED, bool VCRED>
cudaError_t row_launch(const RowArgs& a, int Cg, int n_rows, bool credits, const PairParams& p,
                       const RowPlan& pl, unsigned long long* cnt, cudaStream_t st) {
  const int bytes = row_bytes(a.k, VCRED ? 4 : 3, TYPED, LOOK, p.G, p.degp, pl);
  if (bytes < 0) return cudaErrorInvalidValue;
  if (pl.small) {
    auto kern = k1_rows<ENERGY, LOOK, TYPED, VCRED>;
    cudaError_t e = smem_limit(kern, bytes);
    if (e != cudaSuccess) return e;
    kern<<<n_rows, ROW_THREADS, bytes, st>>>(a, p);
  } else {
    // a Hermite table (at most 16 KB) is always in shared memory
    auto kern = k1_rows_pieces<ENERGY, LOOK, TYPED, VCRED, true>;
    if constexpr (LOOK == CHEB) {
      if (!pl.tsm) kern = k1_rows_pieces<ENERGY, LOOK, TYPED, VCRED, false>;
    }
    cudaError_t e = smem_limit(kern, bytes);
    if (e != cudaSuccess) return e;
    kern<<<n_rows, ROW_THREADS, bytes, st>>>(a, p, pl, cnt);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !credits) return e;
  if (VCRED) {
    const long n = (long)a.C * a.k * 4;
    k7_credits<<<(unsigned)((n + CREDIT_THREADS - 1) / CREDIT_THREADS), CREDIT_THREADS, 0, st>>>(
        a);
  } else {
    const long n = (long)Cg * a.cap * 3;
    k1_credits<<<(unsigned)((n + CREDIT_THREADS - 1) / CREDIT_THREADS), CREDIT_THREADS, 0, st>>>(
        a, Cg);
  }
  return cudaGetLastError();
}

template <int LOOK, bool TYPED>
cudaError_t k1_energy(const RowArgs& a, int Cg, int n_rows, int energy, bool credits,
                      const PairParams& p, const RowPlan& pl, unsigned long long* cnt,
                      cudaStream_t st) {
  return energy ? row_launch<true, LOOK, TYPED, false>(a, Cg, n_rows, credits, p, pl, cnt, st)
                : row_launch<false, LOOK, TYPED, false>(a, Cg, n_rows, credits, p, pl, cnt, st);
}

cudaError_t k1_dispatch(const RowArgs& a, int Cg, int n_rows, int look, int energy, bool credits,
                        const PairParams& p, const RowPlan& pl, unsigned long long* cnt,
                        cudaStream_t st) {
  const bool typed = a.ts != nullptr;
  if (look == CHEB)
    return typed ? k1_energy<CHEB, true>(a, Cg, n_rows, energy, credits, p, pl, cnt, st)
                 : k1_energy<CHEB, false>(a, Cg, n_rows, energy, credits, p, pl, cnt, st);
  return typed ? k1_energy<HERMITE, true>(a, Cg, n_rows, energy, credits, p, pl, cnt, st)
               : k1_energy<HERMITE, false>(a, Cg, n_rows, energy, credits, p, pl, cnt, st);
}

// K2's tiles: n_low of the N low slots, and as many of the O tail rows as
// tail-tail partners and as row tiles
inline int k2_tiles(int n) { return (n + K2_THREADS - 1) / K2_THREADS; }

// The sweep over the low tiles and the tail-tail blocks, each row tile a
// row of the grid, then the finish.
template <bool ENERGY, int LOOK>
cudaError_t k2_launch(const float* xo, const float* xp, const float* t1, const float* t2,
                      float* fo, float* fp, float* fpart, float4* part, int O, int N, int tsm,
                      int bytes, const PairParams& p, cudaStream_t st) {
  const int n_low = k2_tiles(N), n_tail = k2_tiles(O);  // n_tail: row tiles too
  // a Hermite table is always read from global memory
  auto kern = k2_partners<ENERGY, LOOK, false>;
  if constexpr (LOOK == CHEB) {
    if (tsm) kern = k2_partners<ENERGY, LOOK, true>;
  }
  cudaError_t e = smem_limit(kern, bytes);
  if (e != cudaSuccess) return e;
  kern<<<dim3(n_low + n_tail, n_tail), K2_THREADS, bytes, st>>>(xo, xp, t1, t2, fp, fpart, part, O,
                                                              N, n_low, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int row_blocks = (O + K2_WARPS - 1) / K2_WARPS;
  const int fp_blocks = n_tail > 1 ? (int)((3L * N + K2_THREADS - 1) / K2_THREADS) : 0;
  k2_finish<<<row_blocks + fp_blocks, K2_THREADS, 0, st>>>(xo, part, fpart, fo, fp, O, N, n_low,
                                                            n_low + n_tail, row_blocks, n_tail);
  return cudaGetLastError();
}

bool table_ok(int look, int rows, int degp) {
  if (look == HERMITE) return rows >= 1 && rows <= MAX_G;
  return look == CHEB && rows >= 1 && degp >= 2;
}

}  // namespace

extern "C" {

int edm_max_g() { return MAX_G; }
int edm_k2_tile() { return K2_THREADS; }  // partners (and tail rows) a tile: sizes K2's scratch
const char* edm_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// K1 (credits = 1: the credits applied by the second pass) or K6
// (credits = 0: the row pass alone; cred is returned to the caller).
// mc masks the rows and the self block, mcand (Cg, cap) the 13 neighbour
// cells' candidates.  The rows: the row box {ox, oy, oz, rx, ry, rz}, which
// lies inside the (nx, ny, nz) lattice, and n_rows the rows of mc, eb
// (n_rows, k) and cred (n_rows, 13, k, 3): either R = rx * ry * rz (K1's
// owned-row form, credits only) or, when the box is the whole lattice, Cg
// (the pad cells' rows written zeros).  f (Cg, cap, 3), eb and cred are
// written whole: no fill is needed beforehand.
// look: 0 Hermite (t1 = (G, 4) table, rows = G, degp unused) or 1 Chebyshev
// (t1 = cval, t2 = cder, (P, degp) each, rows = P); geom: 5 f32 constants
// (see PairParams); lj = {four_eps, sig2, rcut};
// box = {Lx, Ly, Lz, 1/Lx, 1/Ly, 1/Lz} (all f32); ts: the (Cg, cap) slot
// types and tpair = {ti, tj} for the typed CV, or null for none; plan =
// {small, piece words, row tile, table in shared memory}
// (ops/cellforce.py:row_plan), checked by row_bytes; cnt: null, or three
// int64 to which the pieces form adds the r^2 tests an unculled sweep would
// run, those it ran and the unordered pairs in reach (k1_rows_pieces)
int cell_force_newton_launch(const float* xs, const float* mc, const float* mcand, float* f,
                             float* eb, float* cred, int C, int Cg, int cap, int k, int nx,
                             int ny, int nz, int credits, int ox, int oy, int oz, int rx, int ry,
                             int rz, int n_rows, const float* ts, const float* tpair, int small,
                             int pww, int rt, int tsm, int look, const float* t1, const float* t2,
                             int rows, int degp, const float* geom, const float* box,
                             const float* lj, int energy, void* cnt, void* stream) {
  if (!table_ok(look, rows, degp) || k < 1 || k > cap || Cg < C)
    return (int)cudaErrorInvalidValue;
  const int o[3] = {ox, oy, oz}, r[3] = {rx, ry, rz}, n[3] = {nx, ny, nz};
  for (int d = 0; d < 3; ++d)
    if (o[d] < 0 || r[d] < 1 || o[d] + r[d] > n[d]) return (int)cudaErrorInvalidValue;
  const int R = rx * ry * rz;
  if (!(n_rows == R && credits) && !(R == C && n_rows == Cg)) return (int)cudaErrorInvalidValue;
  RowArgs a{xs, mc, ts, t1, t2, ts ? tpair[0] : 0.0f, ts ? tpair[1] : 0.0f,
            f, eb, cred, C, cap, k, nx, ny, nz, mcand, ox, oy, oz, rx, ry, rz};
  return (int)k1_dispatch(a, Cg, n_rows, look, energy, credits != 0,
                          make_params(rows, degp, geom, box, lj), RowPlan{small, pww, rt, tsm},
                          (unsigned long long*)cnt, (cudaStream_t)stream);
}

// K7: the row pass at full cap with the value credited too, then the second
// pass; Chebyshev only (look must be 1), energy always.  f (Cg, cap, 3),
// eb (Cg, cap) and the scratch cred (Cg, 13, cap, 4) are written whole;
// plan and cnt as for K1 (at k = cap, four components).
int cell_force_full_launch(const float* xs, const float* mc, float* f, float* eb, float* cred,
                           int C, int Cg, int cap, int nx, int ny, int nz, int small, int pww,
                           int rt, int tsm, int look, const float* t1, const float* t2, int rows,
                           int degp, const float* geom, const float* box, const float* lj,
                           void* cnt, void* stream) {
  if (look != CHEB || !table_ok(look, rows, degp) || cap < 1 || Cg < C)
    return (int)cudaErrorInvalidValue;
  RowArgs a{xs, mc, nullptr, t1, t2, 0.0f, 0.0f, f, eb, cred, C, cap, cap, nx, ny, nz,
            mc, 0, 0, 0, nx, ny, nz};
  return (int)row_launch<true, CHEB, false, true>(a, Cg, Cg, true,
                                                  make_params(rows, degp, geom, box, lj),
                                                  RowPlan{small, pww, rt, tsm},
                                                  (unsigned long long*)cnt, (cudaStream_t)stream);
}

// K2.  xo (5, O): x, y, z, mask, own; xp (4, N): x, y, z, mask; fo (4, O) and
// fp (3, N) are written whole; part: the (ceil(N / edm_k2_tile()) +
// ceil(O / edm_k2_tile()), O, 4) scratch, 16-byte aligned; fpart: with more
// than one row tile (O > edm_k2_tile()) the (ceil(O / edm_k2_tile()), 3, N)
// scratch, else unused; tsm: a Chebyshev table in shared memory
// (ops/cellforce.py:k2_plan), checked against its size
int overflow_force_launch(const float* xo, const float* xp, float* fo, float* fp, float* part_,
                          float* fpart, int O, int N, int tsm, int look, const float* t1,
                          const float* t2, int rows, int degp, const float* geom,
                          const float* box, const float* lj, int energy, void* stream) {
  if (!table_ok(look, rows, degp) || O < 1 || N < 0 || k2_tiles(O) > 65535)
    return (int)cudaErrorInvalidValue;
  if (tsm && (look != CHEB || 16 * table4(look, rows, degp) > TABLE_SMEM_MAX))
    return (int)cudaErrorInvalidValue;
  const int bytes = 16 * k2_layout(O, look, rows, degp, tsm).total4();
  cudaStream_t st = (cudaStream_t)stream;
  PairParams p = make_params(rows, degp, geom, box, lj);
  float4* part = reinterpret_cast<float4*>(part_);
  cudaError_t e;
  if (look == CHEB)
    e = energy ? k2_launch<true, CHEB>(xo, xp, t1, t2, fo, fp, fpart, part, O, N, tsm, bytes, p,
                                       st)
               : k2_launch<false, CHEB>(xo, xp, t1, t2, fo, fp, fpart, part, O, N, tsm, bytes, p,
                                        st);
  else
    e = energy ? k2_launch<true, HERMITE>(xo, xp, t1, t2, fo, fp, fpart, part, O, N, tsm, bytes,
                                          p, st)
               : k2_launch<false, HERMITE>(xo, xp, t1, t2, fo, fp, fpart, part, O, N, tsm, bytes,
                                           p, st);
  return (int)e;
}

}  // extern "C"
