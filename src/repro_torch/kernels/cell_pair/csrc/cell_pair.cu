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
// scalar outputs it has. Each workload is one functor: LJ (MD, paper
// §4.1), SPH (§4.2) and the DEM normal contact (§4.5); each has one C
// entry per DIM and precision, `cell_pair_<kind>_<prec>_d<DIM>`. The SPH
// and DEM entries below carry their own notes.
//
// Precisions (the Pallas kernel's `precision`, cell_pair.py:109-160):
//   f32         every operation in fp32;
//   bf16x       geometry (dx, r2, the ok mask) in fp32; the body sees bf16
//               operands (dx, r2 and the props, each rounded to nearest)
//               and rounds every operation's result to bf16, as PyTorch's
//               bf16 elementwise ops do (compute in fp32, round the
//               result); a radial output takes bf16(mag * dx_bf16); the
//               per-slot sums are fp32;
//   bf16x_<o>   (`bf16x:<o>`) the body under both precisions, output o
//               taking the bf16 evaluation and the others the fp32 one
//               (SPH: bf16x_drho, its documented mixed form, and bf16x_a).
// Each functor is written once, templated on its operand type (F32 or
// BF16 below), so the two precisions share every line of the physics.
// The bf16x forms read the same fp32 tiles (rounding at use), so their
// bytes bound is the fp32 form's. Measured on an H100 80GB HBM3 (700 W)
// at the main paths' sizes: LJ 1.67 ms (1.33x fp32), SPH 38.8 ms (1.38x),
// SPH bf16x_drho 34.9 ms (1.24x: nvcc drops each evaluation's unused
// output), DEM 2.63 ms (1.01x).
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// Operand types of a body evaluation. r() rounds an fp32 value to the type
// (ties to even, as PyTorch's float -> bfloat16 conversion); term() is a
// radial output's per-pair term, mag * dx, in the type (fp32: left to the
// accumulation, which nvcc may fuse into an FMA).
struct F32 {
  static constexpr bool kBF16 = false;
  __device__ __forceinline__ static float r(float x) { return x; }
  __device__ __forceinline__ static float term(float mag, float dx) {
    return mag * dx;
  }
};

struct BF16 {
  static constexpr bool kBF16 = true;
  __device__ __forceinline__ static float r(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  __device__ __forceinline__ static float term(float mag, float dx) {
    return r(__fmul_rn(mag, dx));
  }
};

// A body's arithmetic as PyTorch runs it on tensors of operand type P: the
// operation in fp32 with IEEE rounding (never contracted into an FMA), the
// result rounded to P. Rounding here and not through cuda_bf16.h's
// __nv_bfloat16 operators: on sm_90 those add in bf16 directly and can
// round a tie otherwise than float-then-round. A param (a Python number
// in the plain version) enters as P::r(param): rounded to bf16 first, as
// JAX's weak typing rounds it in repro's bodies and as the plain version
// does by making it a 0-d bf16 tensor (repro_torch/core/interactions.py
// `weak`; tests/test_torch_gpu.py pins PyTorch's side of this).
template <class P>
struct Ops {
  __device__ __forceinline__ static float mul(float a, float b) {
    return P::r(__fmul_rn(a, b));
  }
  __device__ __forceinline__ static float div(float a, float b) {
    return P::r(__fdiv_rn(a, b));
  }
  __device__ __forceinline__ static float add(float a, float b) {
    return P::r(__fadd_rn(a, b));
  }
  __device__ __forceinline__ static float sub(float a, float b) {
    return P::r(__fsub_rn(a, b));
  }
  __device__ __forceinline__ static float sqrt(float a) {
    return P::r(__fsqrt_rn(a));
  }
  __device__ __forceinline__ static float max(float a, float b) {
    return P::r(fmaxf(a, b));          // torch.clamp(a, min=b)
  }
  __device__ __forceinline__ static float pow(float a, float b) {
    return P::r(powf(a, b));
  }
  // a / s for a param s (`div_scalar` in the plain version): fp32 takes
  // the product with the reciprocal inv_s, as PyTorch's card kernel does
  // for a Python divisor; bf16 the true division by s rounded, as repro.
  __device__ __forceinline__ static float div_scalar(float a, float s,
                                                     float inv_s) {
    return P::kBF16 ? div(a, P::r(s)) : mul(a, inv_s);
  }
};

// The body interface: operator()(dx, r2, wi, wj, radial, scalar) takes
// the fp32 geometry and the fp32 props of one pair that passed the mask,
// and writes radial[k * DIM + d] (the per-pair term of radial output k)
// and scalar[k].

// Lennard-Jones force body (src/repro/apps/md.py `lj_pair_body`; plain
// version repro_torch/apps/md.py `LJPairBody`):
//   r2s = max(r2, 1e-12); inv = sigma^2 / r2s;
//   mag = 24 eps (2 inv^3 inv^3 - inv^3) / r2s;  output "f" = Radial(mag).
// params: sigma^2 (a tensor filled with it: rounded to P), 24 * epsilon.
template <class P>
struct LJBody {
  static constexpr int DIM = 3;
  static constexpr int N_RADIAL = 1;
  static constexpr int N_SCALAR = 0;
  float s2;     // sigma^2
  float eps24;  // 24 * epsilon

  static LJBody from(const float* p) { return LJBody{p[0], p[1]}; }

  __device__ __forceinline__ void operator()(const float* dx, float r2,
                                             const float* /*wi*/,
                                             const float* /*wj*/,
                                             float* radial,
                                             float* /*scalar*/) const {
    using O = Ops<P>;
    const float r2s = O::max(P::r(r2), 1e-12f);
    const float inv = O::div(P::r(s2), r2s);
    const float inv3 = O::mul(O::mul(inv, inv), inv);
    const float mag = O::div(
        O::mul(P::r(eps24), O::sub(O::mul(O::mul(2.0f, inv3), inv3), inv3)),
        r2s);
#pragma unroll
    for (int d = 0; d < DIM; ++d) radial[d] = P::term(mag, P::r(dx[d]));
  }
};

// Weakly-compressible SPH body (src/repro/apps/sph.py `sph_pair_body`;
// plain version repro_torch/apps/sph.py `SPHPairBody`): cubic-spline
// gradient, Tait pressure, Monaghan viscosity on approaching pairs.
// Props (NPROP = DIM + 1): v_0 .. v_{DIM-1}, rho. Outputs: radial "a",
// scalar "drho". params, in this order: h, 1/h, alpha_d, -0.75 alpha_d,
// rho0, 1/rho0, gamma, b_eos, eta2, -alpha c_sound, -m, m.
//
// Every operation is the plain version's, in its order: the Tait term
// b_eos((rho/rho0)^7 - 1) cancels near rho0, so a last-ulp difference in
// the power would come back about 40x larger. The power is powf, which is
// what torch.pow(t, g) runs on the card for a float exponent other than
// 2, 3, -2, +-0.5, -1 (aten/src/ATen/native/cuda/PowKernel.cu: std::pow of
// floats, for a bf16 tensor too, with the exponent cast to the tensor's
// type); in fp32 the plain version takes rho/rho0 as rho * (1/rho0), so
// both round alike. The q <= 1, q <= 2 and vr < 0 branches are selects: the body only
// runs on pairs that passed the mask, and neither branch can form a NaN
// there.
template <class P, int DIM_>
struct SPHBody {
  static constexpr int DIM = DIM_;
  static constexpr int N_RADIAL = 1;
  static constexpr int N_SCALAR = 1;
  float h, inv_h, alpha_d, c_w2, rho0, inv_rho0, gamma, b_eos, eta2, visc,
      neg_m, m;

  static SPHBody from(const float* p) {
    return SPHBody{p[0], p[1], p[2], p[3], p[4],  p[5],
                   p[6], p[7], p[8], p[9], p[10], p[11]};
  }

  __device__ __forceinline__ float eos(float rho) const {
    using O = Ops<P>;
    return O::mul(
        P::r(b_eos),
        O::sub(O::pow(O::div_scalar(rho, rho0, inv_rho0), P::r(gamma)), 1.0f));
  }

  __device__ __forceinline__ void operator()(const float* dx_in, float r2_in,
                                             const float* wi_in,
                                             const float* wj_in,
                                             float* radial,
                                             float* scalar) const {
    using O = Ops<P>;
    float dx[DIM], wi[DIM + 1], wj[DIM + 1];
#pragma unroll
    for (int d = 0; d < DIM; ++d) dx[d] = P::r(dx_in[d]);
#pragma unroll
    for (int k = 0; k <= DIM; ++k) {
      wi[k] = P::r(wi_in[k]);
      wj[k] = P::r(wj_in[k]);
    }
    const float r2 = P::r(r2_in);
    const float r = O::sqrt(O::max(r2, 1e-12f));
    const float q = O::div_scalar(r, h, inv_h);
    const float w1 = O::mul(
        P::r(alpha_d), O::add(O::mul(-3.0f, q), O::mul(O::mul(2.25f, q), q)));
    const float s = O::sub(2.0f, q);
    const float w2 = O::mul(P::r(c_w2), O::mul(s, s));
    const float dwdq = q <= 1.0f ? w1 : (q <= 2.0f ? w2 : 0.0f);
    const float gw = O::div(dwdq, O::mul(P::r(h), r));   // gradW = gw * dx
    const float rho_i = wi[DIM];
    const float rho_j = wj[DIM];
    float vr = O::mul(O::sub(wi[0], wj[0]), dx[0]);     // (vi - vj).dx
#pragma unroll
    for (int d = 1; d < DIM; ++d)
      vr = O::add(vr, O::mul(O::sub(wi[d], wj[d]), dx[d]));
    const float mu = O::div(O::mul(P::r(h), vr), O::add(r2, P::r(eta2)));
    const float rho_bar = O::mul(0.5f, O::add(rho_i, rho_j));
    const float pi_visc =
        vr < 0.0f ? O::div(O::mul(P::r(visc), mu), rho_bar) : 0.0f;
    const float coef = O::add(
        O::add(O::div(eos(rho_i), O::max(O::mul(rho_i, rho_i), 1e-6f)),
               O::div(eos(rho_j), O::max(O::mul(rho_j, rho_j), 1e-6f))),
        pi_visc);
    const float mag = O::mul(O::mul(P::r(neg_m), coef), gw);
#pragma unroll
    for (int d = 0; d < DIM; ++d) radial[d] = P::term(mag, dx[d]);
    scalar[0] = O::mul(O::mul(P::r(m), vr), gw);
  }
};

// Hertzian normal contact body (src/repro/apps/dem.py `dem_normal_body`;
// plain version repro_torch/apps/dem.py `DEMNormalBody`), DIM 3:
//   r = sqrt(max(r2, 1e-12)); delta = 2R - r;
//   hertz = sqrt(max(delta, 0) / 2R);  vr = (v_i - v_j).dx;
//   mag = hertz (kn delta - gamma_n m_eff vr / r) / r;
//   output "f" = Radial(delta > 0 ? mag : 0).
// Props (NPROP = 3): v. params: 2R, 1/(2R), kn, gamma_n * m_eff. Rounded
// as the plain version rounds, so delta > 0 decides every pair alike; in
// bf16 that is repro's rounding of 2R to bf16 (2R = 0.12 becomes
// 0.1201...), which the overlap 2R - r, small beside 2R, feels strongly.
template <class P>
struct DEMNormalBody {
  static constexpr int DIM = 3;
  static constexpr int N_RADIAL = 1;
  static constexpr int N_SCALAR = 0;
  float two_R, inv_two_R, kn, gn_meff;

  static DEMNormalBody from(const float* p) {
    return DEMNormalBody{p[0], p[1], p[2], p[3]};
  }

  __device__ __forceinline__ void operator()(const float* dx_in, float r2,
                                             const float* wi_in,
                                             const float* wj_in,
                                             float* radial,
                                             float* /*scalar*/) const {
    using O = Ops<P>;
    float dx[DIM], wi[DIM], wj[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      dx[d] = P::r(dx_in[d]);
      wi[d] = P::r(wi_in[d]);
      wj[d] = P::r(wj_in[d]);
    }
    const float r = O::sqrt(O::max(P::r(r2), 1e-12f));
    const float delta = O::sub(P::r(two_R), r);
    const float hertz =
        O::sqrt(O::div_scalar(O::max(delta, 0.0f), two_R, inv_two_R));
    float vr = O::mul(O::sub(wi[0], wj[0]), dx[0]);
#pragma unroll
    for (int d = 1; d < DIM; ++d)
      vr = O::add(vr, O::mul(O::sub(wi[d], wj[d]), dx[d]));
    const float mag = O::div(
        O::mul(hertz, O::sub(O::mul(P::r(kn), delta),
                             O::div(O::mul(P::r(gn_meff), vr), r))),
        r);
    const float f = delta > 0.0f ? mag : 0.0f;
#pragma unroll
    for (int d = 0; d < DIM; ++d) radial[d] = P::term(f, dx[d]);
  }
};

// `bf16x:<names>`: the body evaluated under both precisions, each output
// taking its own (B32 and B16 are one functor at F32 and at BF16).
// RAD16 / SCA16: the radial / scalar outputs take the bf16 evaluation.
template <class B32, class B16, bool RAD16, bool SCA16>
struct MixedBody {
  static constexpr int DIM = B32::DIM;
  static constexpr int N_RADIAL = B32::N_RADIAL;
  static constexpr int N_SCALAR = B32::N_SCALAR;
  B32 f32;
  B16 bf16;

  static MixedBody from(const float* p) {
    return MixedBody{B32::from(p), B16::from(p)};
  }

  __device__ __forceinline__ void operator()(const float* dx, float r2,
                                             const float* wi,
                                             const float* wj, float* radial,
                                             float* scalar) const {
    float rad16[N_RADIAL * DIM], sca16[N_SCALAR > 0 ? N_SCALAR : 1];
    f32(dx, r2, wi, wj, radial, scalar);
    bf16(dx, r2, wi, wj, rad16, sca16);
    if (RAD16) {
#pragma unroll
      for (int i = 0; i < N_RADIAL * DIM; ++i) radial[i] = rad16[i];
    }
    if (SCA16) {
#pragma unroll
      for (int i = 0; i < N_SCALAR; ++i) scalar[i] = sca16[i];
    }
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
  static_assert(Body::DIM == DIM, "the body is built for another DIM");
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
        float rad[NR * DIM];
        float sca[NS];
        body(dx, r2, wi, cj + DIM + 1, rad, sca);
#pragma unroll
        for (int k = 0; k < Body::N_RADIAL; ++k)
#pragma unroll
          for (int d = 0; d < DIM; ++d) acc_r[k][d] += rad[k * DIM + d];
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

template <class Body, int NPROP>
int launch(const void* cell_x, const void* nbr_x, const void* cell_mask,
           const void* nbr_mask, const void* props_i, const void* props_j,
           void* out_radial, void* out_scalar, int C, int cc, int kcc,
           float rc2, const float* params, void* stream) {
  constexpr int DIM = Body::DIM;
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
        cc, kcc, rc2, Body::from(params));
  }
  return static_cast<int>(cudaGetLastError());
}

template <int DIM>
using SPH32 = SPHBody<F32, DIM>;
template <int DIM>
using SPH16 = SPHBody<BF16, DIM>;

}  // namespace

// C entries, one per (body, precision, DIM). Every entry takes the same
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
      out_scalar, C, cc, kcc, rc2, params, stream

extern "C" {

// LJ forces: DIM 3, no props, out_radial "f"; fp32 and bf16x.
int cell_pair_lj_f32_d3(CELL_PAIR_ARGS) {
  return launch<LJBody<F32>, 0>(CELL_PAIR_PASS);
}

int cell_pair_lj_bf16x_d3(CELL_PAIR_ARGS) {
  return launch<LJBody<BF16>, 0>(CELL_PAIR_PASS);
}

// SPH rates, 2-D: NPROP 3 (v, rho), out_radial "a", out_scalar "drho".
//
// Replaces `_pair_kernel` (src/repro/kernels/cell_pair/cell_pair.py) run
// with `sph_pair_body`. At the 2-D check size (dp 0.04 in a 1.0 x 0.5
// tank, 642 particles, 14 x 7 cells, cc 64, K = 9) the bound is launch
// latency; the entry exists for the 2-D dam break and its tests.
int cell_pair_sph_f32_d2(CELL_PAIR_ARGS) {
  return launch<SPH32<2>, 3>(CELL_PAIR_PASS);
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
  return launch<SPH32<3>, 4>(CELL_PAIR_PASS);
}

// SPH under bf16x (both outputs from the bf16 evaluation), bf16x:drho
// (drho bf16, a fp32) and bf16x:a (a bf16, drho fp32), 2-D and 3-D. The
// mixed forms evaluate the body twice per pair.
int cell_pair_sph_bf16x_d2(CELL_PAIR_ARGS) {
  return launch<SPH16<2>, 3>(CELL_PAIR_PASS);
}

int cell_pair_sph_bf16x_d3(CELL_PAIR_ARGS) {
  return launch<SPH16<3>, 4>(CELL_PAIR_PASS);
}

int cell_pair_sph_bf16x_drho_d2(CELL_PAIR_ARGS) {
  return launch<MixedBody<SPH32<2>, SPH16<2>, false, true>, 3>(
      CELL_PAIR_PASS);
}

int cell_pair_sph_bf16x_drho_d3(CELL_PAIR_ARGS) {
  return launch<MixedBody<SPH32<3>, SPH16<3>, false, true>, 4>(
      CELL_PAIR_PASS);
}

int cell_pair_sph_bf16x_a_d2(CELL_PAIR_ARGS) {
  return launch<MixedBody<SPH32<2>, SPH16<2>, true, false>, 3>(
      CELL_PAIR_PASS);
}

int cell_pair_sph_bf16x_a_d3(CELL_PAIR_ARGS) {
  return launch<MixedBody<SPH32<3>, SPH16<3>, true, false>, 4>(
      CELL_PAIR_PASS);
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
  return launch<DEMNormalBody<F32>, 3>(CELL_PAIR_PASS);
}

int cell_pair_dem_bf16x_d3(CELL_PAIR_ARGS) {
  return launch<DEMNormalBody<BF16>, 3>(CELL_PAIR_PASS);
}

}  // extern "C"
