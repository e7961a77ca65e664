// Cell-pair interaction engine for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_pair_kernel` in
// src/repro/kernels/cell_pair/cell_pair.py (launched by `cell_pair_pallas`,
// driven by `apply_kernel_pallas`). For every home slot i of a cell it sums
// a pair body over the cell's K*cc pre-gathered candidates j (K = 3^DIM,
// periodic shift already applied to the candidates):
//
//     ok   = mi & mj & r2 < rc2 & r2 > 1e-12     (self-exclusion by r2, as
//                                                 in the Pallas kernel)
//     out  = sum_j body(dx, r2, wi, wj)          fp32 accumulation
//
// A radial output emits sum_j mag * dx_d per component, a scalar output
// sum_j v. The kernel is templated on the body functor, on DIM, and on the
// number of per-particle float props; a body declares how many radial and
// scalar outputs it has. Each workload is one functor and one C entry per
// DIM: LJ (MD, paper §4.1), SPH (§4.2) and the DEM normal contact (§4.5);
// the SPH and DEM entries below carry their own notes.
//
// Design (a simple, correct first version):
//   * one thread block per home cell, cc rounded up to a warp multiple
//     (64 threads for cc = 48); thread t owns home slot t;
//   * the cell's K*cc candidates (position, mask, props) are staged in
//     shared memory, (DIM + 1 + NPROP) floats each: 1296 * 16 B = 20.7 KB
//     for MD (cc = 48, K = 27, no props);
//   * each thread loops over the candidates, skips masked pairs before the
//     body is evaluated (so the FILL sentinel never forms an inf or NaN),
//     and accumulates in fp32 registers;
//   * dx and r2 are computed with explicitly rounded operations
//     (__fmul_rn/__fadd_rn, never contracted into an FMA) in the same order
//     as the plain PyTorch version, so the cutoff and self-exclusion tests
//     decide every pair identically on both paths;
//   * a block whose home cell holds no particle writes zeros and exits
//     after one vote (__syncthreads_or), before staging anything;
//   * the grid covers C cells exactly; no padding to a block multiple.
//
// What bounds the LJ form on the H100: memory. At the MD size (216,000 particles,
// 12,167 cells, cc = 48, K = 27) the inputs are nbr_x 12,167 * 1296 * 3 *
// 4 B = 189 MB, nbr_mask 16 MB, cell_x and out 7 MB each: about 220 MB, or
// 66 us at 3.35 TB/s. The arithmetic is about 1.0e8 candidate tests and
// 1.5e7 in-cutoff LJ evaluations, near 1 GFLOP, 16 us at 67 TFLOP/s fp32.
// The K-fold candidate pre-gather (each position is written 27 times by
// the gather and read 27 times here) is the cost; reading candidates
// through the neighbourhood table inside the kernel would remove it and is
// left to a later change, which keeps these inputs for now.
//
// Measured on an H100 80GB HBM3 (700 W) at that size: about 1.24 ms, 19x
// the bytes bound. This simple form is limited by instruction issue and
// shared-memory latency, not by memory: every lane walks all K*cc
// candidates (about 63% of them empty slots), in-cutoff lanes diverge
// through two IEEE divisions, and 64-thread blocks with ~18 busy lanes
// leave few warps to hide latency. Compacting the valid candidates at
// staging and giving a block more home slots are the first remedies.

#include <cuda_runtime.h>

namespace {

// Lennard-Jones force body (src/repro/apps/md.py `lj_pair_body`):
//   r2s = max(r2, 1e-12); inv = sigma^2 / r2s;
//   mag = 24 eps (2 inv^6 - inv^3) / r2s;  output "f" = Radial(mag).
// params: sigma^2, 24 * epsilon.
struct LJBody {
  static constexpr int N_RADIAL = 1;
  static constexpr int N_SCALAR = 0;
  float s2;     // sigma^2
  float eps24;  // 24 * epsilon

  __device__ __forceinline__ void operator()(const float* /*dx*/, float r2,
                                             const float* /*wi*/,
                                             const float* /*wj*/,
                                             float* radial,
                                             float* /*scalar*/) const {
    const float r2s = fmaxf(r2, 1e-12f);
    const float inv = s2 / r2s;
    const float inv3 = inv * inv * inv;
    radial[0] = eps24 * (2.0f * inv3 * inv3 - inv3) / r2s;
  }
};

// Weakly-compressible SPH body (src/repro/apps/sph.py `sph_pair_body`;
// plain version repro_torch/apps/sph.py `SPHPairBody`): cubic-spline
// gradient, Tait pressure, Monaghan viscosity on approaching pairs.
// Props (NPROP = DIM + 1): v_0 .. v_{DIM-1}, rho. Outputs: radial "a",
// scalar "drho". params, in this order: h, 1/h, alpha_d, -0.75 alpha_d,
// 1/rho0, gamma, b_eos, eta2, -alpha c_sound, -m, m.
//
// Every operation is the plain version's, in its order, with explicit
// IEEE rounding (no FMA contraction): the Tait term b_eos((rho/rho0)^7 - 1)
// cancels near rho0, so a last-ulp difference in the power would come
// back about 40x larger. The power is powf, which is what torch.pow(t, g)
// runs on the card for a float exponent other than 2, 3, -2, +-0.5, -1
// (aten/src/ATen/native/cuda/PowKernel.cu: std::pow(float, float)); the
// plain version takes rho/rho0 as rho * (1/rho0), so both round alike.
// The q <= 1, q <= 2 and vr < 0 branches are selects: the body only runs
// on pairs that passed the mask, and neither branch can form a NaN there.
template <int DIM>
struct SPHBody {
  static constexpr int N_RADIAL = 1;
  static constexpr int N_SCALAR = 1;
  float h, inv_h, alpha_d, c_w2, inv_rho0, gamma, b_eos, eta2, visc, neg_m,
      m;

  __device__ __forceinline__ float eos(float rho) const {
    return __fmul_rn(b_eos,
                     __fsub_rn(powf(__fmul_rn(rho, inv_rho0), gamma), 1.0f));
  }

  __device__ __forceinline__ void operator()(const float* dx, float r2,
                                             const float* wi,
                                             const float* wj, float* radial,
                                             float* scalar) const {
    const float r = __fsqrt_rn(fmaxf(r2, 1e-12f));
    const float q = __fmul_rn(r, inv_h);
    const float w1 = __fmul_rn(
        alpha_d,
        __fadd_rn(__fmul_rn(-3.0f, q), __fmul_rn(__fmul_rn(2.25f, q), q)));
    const float s = __fsub_rn(2.0f, q);
    const float w2 = __fmul_rn(c_w2, __fmul_rn(s, s));
    const float dwdq = q <= 1.0f ? w1 : (q <= 2.0f ? w2 : 0.0f);
    const float gw = __fdiv_rn(dwdq, __fmul_rn(h, r));   // gradW = gw * dx
    const float rho_i = wi[DIM];
    const float rho_j = wj[DIM];
    float vr = __fmul_rn(__fsub_rn(wi[0], wj[0]), dx[0]);  // (vi - vj).dx
#pragma unroll
    for (int d = 1; d < DIM; ++d)
      vr = __fadd_rn(vr, __fmul_rn(__fsub_rn(wi[d], wj[d]), dx[d]));
    const float mu = __fdiv_rn(__fmul_rn(h, vr), __fadd_rn(r2, eta2));
    const float rho_bar = __fmul_rn(0.5f, __fadd_rn(rho_i, rho_j));
    const float pi_visc =
        vr < 0.0f ? __fdiv_rn(__fmul_rn(visc, mu), rho_bar) : 0.0f;
    const float coef = __fadd_rn(
        __fadd_rn(__fdiv_rn(eos(rho_i), fmaxf(__fmul_rn(rho_i, rho_i), 1e-6f)),
                  __fdiv_rn(eos(rho_j),
                            fmaxf(__fmul_rn(rho_j, rho_j), 1e-6f))),
        pi_visc);
    radial[0] = __fmul_rn(__fmul_rn(neg_m, coef), gw);
    scalar[0] = __fmul_rn(__fmul_rn(m, vr), gw);
  }
};

// Hertzian normal contact body (src/repro/apps/dem.py `dem_normal_body`;
// plain version repro_torch/apps/dem.py `DEMNormalBody`), DIM 3:
//   r = sqrt(max(r2, 1e-12)); delta = 2R - r;
//   hertz = sqrt(max(delta, 0) / 2R);  vr = (v_i - v_j).dx;
//   mag = hertz (kn delta - gamma_n m_eff vr / r) / r;
//   output "f" = Radial(delta > 0 ? mag : 0).
// Props (NPROP = 3): v. params: 2R, 1/(2R), kn, gamma_n * m_eff. Rounded
// as the plain version rounds, so delta > 0 decides every pair alike.
struct DEMNormalBody {
  static constexpr int N_RADIAL = 1;
  static constexpr int N_SCALAR = 0;
  float two_R, inv_two_R, kn, gn_meff;

  __device__ __forceinline__ void operator()(const float* dx, float r2,
                                             const float* wi,
                                             const float* wj, float* radial,
                                             float* /*scalar*/) const {
    const float r = __fsqrt_rn(fmaxf(r2, 1e-12f));
    const float delta = __fsub_rn(two_R, r);
    const float hertz = __fsqrt_rn(__fmul_rn(fmaxf(delta, 0.0f), inv_two_R));
    float vr = __fmul_rn(__fsub_rn(wi[0], wj[0]), dx[0]);
#pragma unroll
    for (int d = 1; d < 3; ++d)
      vr = __fadd_rn(vr, __fmul_rn(__fsub_rn(wi[d], wj[d]), dx[d]));
    const float mag = __fdiv_rn(
        __fmul_rn(hertz, __fsub_rn(__fmul_rn(kn, delta),
                                   __fdiv_rn(__fmul_rn(gn_meff, vr), r))),
        r);
    radial[0] = delta > 0.0f ? mag : 0.0f;
  }
};

template <int N>
struct AtLeastOne {
  static constexpr int value = N > 0 ? N : 1;
};

template <class Body, int DIM, int NPROP>
__global__ void cell_pair_kernel(
    const float* __restrict__ cell_x,      // (C, cc, DIM)
    const float* __restrict__ nbr_x,       // (C, kcc, DIM)
    const bool* __restrict__ cell_mask,    // (C, cc)
    const bool* __restrict__ nbr_mask,     // (C, kcc)
    const float* __restrict__ props_i,     // (C, cc, NPROP), unused if 0
    const float* __restrict__ props_j,     // (C, kcc, NPROP), unused if 0
    float* __restrict__ out_radial,        // (N_RADIAL, C, cc, DIM)
    float* __restrict__ out_scalar,        // (N_SCALAR, C, cc)
    int C, int cc, int kcc, float rc2, Body body) {
  constexpr int S = DIM + 1 + NPROP;       // floats per staged candidate
  constexpr int NP = AtLeastOne<NPROP>::value;
  constexpr int NR = AtLeastOne<Body::N_RADIAL>::value;
  constexpr int NS = AtLeastOne<Body::N_SCALAR>::value;
  extern __shared__ float s_cand[];

  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const size_t slot = static_cast<size_t>(c) * cc + t;
  const size_t n_slots = static_cast<size_t>(C) * cc;
  const bool home = t < cc && cell_mask[slot];

  float acc_r[NR][DIM];
  float acc_s[NS];
#pragma unroll
  for (int k = 0; k < NR; ++k)
#pragma unroll
    for (int d = 0; d < DIM; ++d) acc_r[k][d] = 0.0f;
#pragma unroll
  for (int k = 0; k < NS; ++k) acc_s[k] = 0.0f;

  // A cell with no particle stages nothing and writes zeros (most cells
  // of the SPH tank's air and of the DEM box are empty).
  if (__syncthreads_or(home)) {
    const float* nx = nbr_x + static_cast<size_t>(c) * kcc * DIM;
    for (int i = t; i < kcc * DIM; i += blockDim.x)
      s_cand[(i / DIM) * S + (i % DIM)] = nx[i];
    const bool* nm = nbr_mask + static_cast<size_t>(c) * kcc;
    for (int j = t; j < kcc; j += blockDim.x)
      s_cand[j * S + DIM] = nm[j] ? 1.0f : 0.0f;
    if (NPROP > 0) {
      const float* pj = props_j + static_cast<size_t>(c) * kcc * NPROP;
      for (int i = t; i < kcc * NPROP; i += blockDim.x)
        s_cand[(i / NP) * S + DIM + 1 + (i % NP)] = pj[i];
    }
    __syncthreads();

    if (home) {
      float xi[DIM];
#pragma unroll
      for (int d = 0; d < DIM; ++d) xi[d] = cell_x[slot * DIM + d];
      float wi[NP];
#pragma unroll
      for (int p = 0; p < NPROP; ++p) wi[p] = props_i[slot * NPROP + p];
      for (int j = 0; j < kcc; ++j) {
        const float* cj = s_cand + j * S;
        if (cj[DIM] == 0.0f) continue;
        float dx[DIM];
        float r2 = 0.0f;
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          dx[d] = __fsub_rn(xi[d], cj[d]);
          const float sq = __fmul_rn(dx[d], dx[d]);
          r2 = d == 0 ? sq : __fadd_rn(r2, sq);
        }
        if (!(r2 < rc2 && r2 > 1e-12f)) continue;
        float rad[NR];
        float sca[NS];
        body(dx, r2, wi, cj + DIM + 1, rad, sca);
#pragma unroll
        for (int k = 0; k < Body::N_RADIAL; ++k)
#pragma unroll
          for (int d = 0; d < DIM; ++d) acc_r[k][d] += rad[k] * dx[d];
#pragma unroll
        for (int k = 0; k < Body::N_SCALAR; ++k) acc_s[k] += sca[k];
      }
    }
  }
  if (t >= cc) return;

#pragma unroll
  for (int k = 0; k < Body::N_RADIAL; ++k)
#pragma unroll
    for (int d = 0; d < DIM; ++d)
      out_radial[(k * n_slots + slot) * DIM + d] = acc_r[k][d];
#pragma unroll
  for (int k = 0; k < Body::N_SCALAR; ++k)
    out_scalar[k * n_slots + slot] = acc_s[k];
}

template <class Body, int DIM, int NPROP>
int launch(const void* cell_x, const void* nbr_x, const void* cell_mask,
           const void* nbr_mask, const void* props_i, const void* props_j,
           void* out_radial, void* out_scalar, int C, int cc, int kcc,
           float rc2, Body body, void* stream) {
  constexpr int S = DIM + 1 + NPROP;
  const int threads = ((cc + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(kcc) * S * sizeof(float);
  auto kern = cell_pair_kernel<Body, DIM, NPROP>;
  if (smem > 48 * 1024) {
    // above 48 KB only as opted-in dynamic shared memory; this fails
    // past the card's 227 KB per block, and the caller raises
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (C > 0) {
    kern<<<C, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(cell_x), static_cast<const float*>(nbr_x),
        static_cast<const bool*>(cell_mask),
        static_cast<const bool*>(nbr_mask),
        static_cast<const float*>(props_i),
        static_cast<const float*>(props_j),
        static_cast<float*>(out_radial), static_cast<float*>(out_scalar), C,
        cc, kcc, rc2, body);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int DIM>
SPHBody<DIM> sph_body(const float* p) {
  return SPHBody<DIM>{p[0], p[1], p[2], p[3], p[4], p[5],
                      p[6], p[7], p[8], p[9], p[10]};
}

}  // namespace

// C entries, one per (body, DIM), fp32. Every entry takes the same
// arguments: the tiles (cell_x, nbr_x, cell_mask, nbr_mask), the packed
// props (C, cc, NPROP) / (C, kcc, NPROP) or null, the outputs
// out_radial (C, cc, DIM) and out_scalar (C, cc) or null, the sizes, the
// squared cutoff, the body's float params (a host array, in the order its
// functor lists) and the stream. Each returns cudaGetLastError() after the
// launch (or the error of the shared-memory opt-in).
#define CELL_PAIR_ARGS                                                     \
  const void *cell_x, const void *nbr_x, const void *cell_mask,            \
      const void *nbr_mask, const void *props_i, const void *props_j,      \
      void *out_radial, void *out_scalar, int C, int cc, int kcc,          \
      float rc2, const float *params, void *stream
#define CELL_PAIR_PASS                                                     \
  cell_x, nbr_x, cell_mask, nbr_mask, props_i, props_j, out_radial,        \
      out_scalar, C, cc, kcc, rc2

extern "C" {

// LJ forces: DIM 3, no props, out_radial "f".
int cell_pair_lj_f32_d3(CELL_PAIR_ARGS) {
  return launch<LJBody, 3, 0>(CELL_PAIR_PASS, LJBody{params[0], params[1]},
                              stream);
}

// SPH rates, 2-D: NPROP 3 (v, rho), out_radial "a", out_scalar "drho".
//
// Replaces `_pair_kernel` (src/repro/kernels/cell_pair/cell_pair.py) run
// with `sph_pair_body`. At the 2-D check size (dp 0.04 in a 1.0 x 0.5
// tank, 642 particles, 14 x 7 cells, cc 64, K = 9) the bound is launch
// latency; the entry exists for the 2-D dam break and its tests.
int cell_pair_sph_f32_d2(CELL_PAIR_ARGS) {
  return launch<SPHBody<2>, 2, 3>(CELL_PAIR_PASS, sph_body<2>(params),
                                  stream);
}

// SPH rates, 3-D: NPROP 4 (v, rho), out_radial "a", out_scalar "drho".
//
// Replaces `_pair_kernel` run with `sph_pair_body`, dim 3. At the card
// size (dp 0.006 in a 1.6 x 0.67 x 0.4 tank, 570,248 particles, 76 x 32 x
// 19 = 46,208 cells, cc 128, K = 27, so 3,456 candidates per cell) the
// tiles are 4.9 GB, but a kernel needs only each slot's mask and the
// data of the valid slots, and writes a and drho once: 925 MB, 0.276 ms
// at 3.35 TB/s (10 steps after the dam's release). The arithmetic is
// 7.6e8 candidate tests (8 flops) and 8.3e7 in-cutoff evaluations (55,
// powf and divisions counted as one): 1.1e10 flops, 0.16 ms at 67
// TFLOP/s. Memory binds it.
//
// The simple design: one block per home cell (128 threads, one per home
// slot); the cell's 3,456 candidates staged in shared memory at 8 floats
// each, 110.6 KB, so the launch opts in above 48 KB and two blocks share
// an SM; each thread walks every candidate, skips empty slots and pairs
// outside the cutoff before the body, and sums in fp32 registers. Most
// slots of a 128-slot cell are empty (12 particles per cell on average),
// and a cell with no particle exits after one vote.
//
// Measured on an H100 80GB HBM3 (700 W) at that size: 28.2 ms, 102x the
// bound, and 156x faster than the plain version. Every home lane walks
// all 3,456 candidates (valid ones are about a third in the fluid), and
// the in-cutoff body (two powf, six IEEE divisions) diverges across the
// lanes; 8 warps an SM hide little latency.
int cell_pair_sph_f32_d3(CELL_PAIR_ARGS) {
  return launch<SPHBody<3>, 3, 4>(CELL_PAIR_PASS, sph_body<3>(params),
                                  stream);
}

// DEM normal forces: DIM 3, NPROP 3 (v), out_radial "f".
//
// Replaces `_pair_kernel` run with `dem_normal_body`. At the card size
// (the default avalanche scaled 2x per axis: 72,030 grains, 120 x 42 x 45
// = 226,800 cells, cc 24, K = 27, 648 candidates per cell) the masks
// (152 MB, nearly all false), the valid slots' data and the output come
// to 337 MB, 0.10 ms at 3.35 TB/s; 3.9e6 tests and 4.2e5 evaluations
// are 4.3e7 flops. Memory binds it.
// The design is the SPH one with 32-thread blocks and 7 floats a
// candidate (18.1 KB); 0.3 grains per cell on average, so most blocks
// exit after the vote. Measured on an H100 80GB HBM3 (700 W): 2.59 ms,
// 26x the bound: the 226,800 blocks, a fifth of them busy, each with one
// warp, are short of warps and of work.
int cell_pair_dem_f32_d3(CELL_PAIR_ARGS) {
  return launch<DEMNormalBody, 3, 3>(
      CELL_PAIR_PASS, DEMNormalBody{params[0], params[1], params[2],
                                    params[3]},
      stream);
}

}  // extern "C"
