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
// The engine (staging, compaction, chunking, the fp32 reduction, the
// launch and the CELL_PAIR_ENTRY macro) is in cell_pair_engine.cuh, with
// the notes on its design and its measurements; this file holds the three
// hand-written functors and their C entries.

#include "cell_pair_engine.cuh"

namespace {

// Lennard-Jones force body (src/repro/apps/md.py `lj_pair_body`; plain
// version repro_torch/apps/md.py `LJPairBody`):
//   r2s = max(r2, 1e-12); inv = sigma^2 / r2s;
//   mag = 24 eps (2 inv^3 inv^3 - inv^3) / r2s;  output "f" = Radial(mag).
// params: sigma^2 (a tensor filled with it: rounded to P), 24 * epsilon.
template <class P, int DIM_>
struct LJBody {
  static constexpr int DIM = DIM_;
  static constexpr int N_RADIAL = 1;
  static constexpr int N_SCALAR = 0;
  float s2;     // sigma^2
  float eps24;  // 24 * epsilon

  static constexpr int N_HOOK = 0;

  static LJBody from(const float* p) { return LJBody{p[0], p[1]}; }

  __device__ __forceinline__ void hook(const float* /*w*/,
                                       float* /*h*/) const {}

  __device__ __forceinline__ void operator()(const float* dx, float r2,
                                             const float* /*wi*/,
                                             const float* /*wj*/,
                                             const float* /*hi*/,
                                             const float* /*hj*/,
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
// there. The Tait term eos(rho) / max(rho^2, 1e-6) of each side depends
// on that particle only: it is the body's one per-particle term (hook),
// formed from the rounded rho by the same operations as the plain
// version's per-pair expression, so it is bit-equal to it.
template <class P, int DIM_>
struct SPHBody {
  static constexpr int DIM = DIM_;
  static constexpr int N_RADIAL = 1;
  static constexpr int N_SCALAR = 1;
  float h, inv_h, alpha_d, c_w2, rho0, inv_rho0, gamma, b_eos, eta2, visc,
      neg_m, m;

  static constexpr int N_HOOK = 1;

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

  // w: v_0 .. v_{DIM-1}, rho -> h[0] = eos(rho) / max(rho^2, 1e-6)
  __device__ __forceinline__ void hook(const float* w, float* h) const {
    using O = Ops<P>;
    const float rho = P::r(w[DIM]);
    h[0] = O::div(eos(rho), O::max(O::mul(rho, rho), 1e-6f));
  }

  __device__ __forceinline__ void operator()(const float* dx_in, float r2_in,
                                             const float* wi_in,
                                             const float* wj_in,
                                             const float* hi,
                                             const float* hj,
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
    const float coef = O::add(O::add(hi[0], hj[0]), pi_visc);
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

  static constexpr int N_HOOK = 0;

  static DEMNormalBody from(const float* p) {
    return DEMNormalBody{p[0], p[1], p[2], p[3]};
  }

  __device__ __forceinline__ void hook(const float* /*w*/,
                                       float* /*h*/) const {}

  __device__ __forceinline__ void operator()(const float* dx_in, float r2,
                                             const float* wi_in,
                                             const float* wj_in,
                                             const float* /*hi*/,
                                             const float* /*hj*/,
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

template <int DIM>
using LJ32 = LJBody<F32, DIM>;
template <int DIM>
using LJ16 = LJBody<BF16, DIM>;
template <int DIM>
using SPH32 = SPHBody<F32, DIM>;
template <int DIM>
using SPH16 = SPHBody<BF16, DIM>;
template <int DIM>
using SPHDrho = MixedBody<SPH32<DIM>, SPH16<DIM>, 0u, 1u>;
template <int DIM>
using SPHAcc = MixedBody<SPH32<DIM>, SPH16<DIM>, 1u, 0u>;

}  // namespace

extern "C" {

// LJ forces: DIM 2 and 3, no props, out_radial "f"; fp32 and bf16x.
CELL_PAIR_ENTRY(cell_pair_lj_f32_d3, LJ32<3>, 0)
CELL_PAIR_ENTRY(cell_pair_lj_bf16x_d3, LJ16<3>, 0)
CELL_PAIR_ENTRY(cell_pair_lj_f32_d2, LJ32<2>, 0)
CELL_PAIR_ENTRY(cell_pair_lj_bf16x_d2, LJ16<2>, 0)

// SPH rates, 2-D: NPROP 3 (v, rho), out_radial "a", out_scalar "drho".
//
// Replaces `_pair_kernel` (src/repro/kernels/cell_pair/cell_pair.py) run
// with `sph_pair_body`. At the 2-D check size (dp 0.04 in a 1.0 x 0.5
// tank, 642 particles, 14 x 7 cells, cc 64, K = 9) the bound is launch
// latency; the entry exists for the 2-D dam break and its tests.
CELL_PAIR_ENTRY(cell_pair_sph_f32_d2, SPH32<2>, 3)

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
// TFLOP/s. Memory binds the function; instruction issue binds the
// kernel.
//
// The first version (one block per cell staging all 3,456 candidates,
// 110.6 KB; every lane walking all of them; two powf and six divisions
// per in-cutoff pair) took 28.2 ms on an H100 80GB HBM3 (700 W), 102x the
// bound. This design, per fluid cell of ~43 particles: blocks of 128
// threads, tiles of 256 candidates, chunks of up to 512 rows of 9 floats
// (18 KB, so ten blocks, 40 warps, share an SM, as many as the registers
// allow), about 1,160 valid candidates staged with their Tait term, and
// 43 home lanes walking them and evaluating ~146 in-cutoff pairs each.
// Measured on an H100 80GB HBM3 (700 W): 3.29 ms, 12x the bound.
CELL_PAIR_ENTRY(cell_pair_sph_f32_d3, SPH32<3>, 4)

// SPH under bf16x (both outputs from the bf16 evaluation), bf16x:drho
// (drho bf16, a fp32) and bf16x:a (a bf16, drho fp32), 2-D and 3-D. The
// mixed forms evaluate the body twice per pair and stage both
// precisions' Tait terms.
CELL_PAIR_ENTRY(cell_pair_sph_bf16x_d2, SPH16<2>, 3)
CELL_PAIR_ENTRY(cell_pair_sph_bf16x_d3, SPH16<3>, 4)
CELL_PAIR_ENTRY(cell_pair_sph_bf16x_drho_d2, SPHDrho<2>, 3)
CELL_PAIR_ENTRY(cell_pair_sph_bf16x_drho_d3, SPHDrho<3>, 4)
CELL_PAIR_ENTRY(cell_pair_sph_bf16x_a_d2, SPHAcc<2>, 3)
CELL_PAIR_ENTRY(cell_pair_sph_bf16x_a_d3, SPHAcc<3>, 4)

// DEM normal forces: DIM 3, NPROP 3 (v), out_radial "f".
//
// Replaces `_pair_kernel` run with `dem_normal_body`. At the card size
// (the default avalanche scaled 2x per axis: 72,030 grains, 120 x 42 x 45
// = 226,800 cells, cc 24, K = 27, 648 candidates per cell) the masks
// (152 MB, nearly all false), the valid slots' data and the output come
// to 337 MB, 0.10 ms at 3.35 TB/s; 3.9e6 tests and 4.2e5 evaluations
// are 4.3e7 flops. Memory binds it.
// The design is the SPH one with 32-thread blocks, tiles of 128
// candidates and chunks of 256 rows of 7 floats; 0.3 grains per cell on
// average, so most blocks exit after the vote. The first version took
// 2.59 ms on an H100 80GB HBM3 (700 W), 26x the bound: the 226,800
// blocks, a fifth of them busy, each with one warp, are short of warps
// and of work. This design: 0.423 ms there (bf16x 0.482), 4.2x the
// bound, on the same H100.
CELL_PAIR_ENTRY(cell_pair_dem_f32_d3, DEMNormalBody<F32>, 3)
CELL_PAIR_ENTRY(cell_pair_dem_bf16x_d3, DEMNormalBody<BF16>, 3)

}  // extern "C"
