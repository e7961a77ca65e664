#pragma once

// The cell-pair engine for Hopper (sm_90a): everything of the B1 kernel
// but its pair bodies. A source includes this header, defines its body
// functors (the interface below) in an anonymous namespace and names one C
// entry per (functor, precision, DIM) with CELL_PAIR_ENTRY or
// CELL_PAIR_ENTRY_FIT (the register budget, below):
// csrc/cell_pair.cu for the hand-written LJ, SPH and DEM functors, and the
// sources that kernels/cell_pair/codegen.py writes for a pair body traced
// from its plain PyTorch form.
//
// Outside nvcc (no __CUDACC__) only the operand types, Ops<P>, Int,
// MixedBody and the pair walk's lane map (lane_of, stripes,
// reduce_stripes) are defined, so that a host compiler can evaluate a
// functor and check the lane map against a small shim of the CUDA
// intrinsics (tests/cell_pair_host_shim.h).
//
// Design (redesigned for the card; the first version staged all K*cc
// candidates of a cell and let every home lane walk all of them):
//   * one thread block per home cell, cc rounded up to a warp multiple
//     (64 threads for cc = 48, 128 for cc = 128); a cell with no particle
//     writes zeros and exits after one vote (__syncthreads_or), before
//     reading any candidate;
//   * compacted staging: the block reads the candidates' masks a tile at a
//     time (rep x blockDim candidates, rep = 4, 2 or 1: the most whose
//     chunk, below, stays within 20 KB), and a stable block-wide prefix (warp
//     ballots, __popc, one shared count per warp and sub-tile) gives each
//     valid candidate its row in shared memory. Only valid candidates are
//     read from HBM and staged: position, props and the functor's
//     per-particle terms (below), DIM + NPROP + N_HOOK floats, padded to an
//     odd count so that the rows a warp writes at once fall in distinct
//     banks;
//   * fixed-size chunks: rows accumulate until the next tile might not fit
//     a chunk of 2 x tile rows (512 for SPH at cc 128 and for MD), then
//     the block evaluates the chunk and starts the next one. Shared memory
//     no longer grows with K*cc: any cc up to the 1,024 home slots of a
//     block launches (d3 SPH at cc 1,024: 2,048 rows, 74 KB);
//   * per-particle terms: a functor may declare N_HOOK floats that depend
//     on one particle only (SPH: the Tait term eos(rho) / max(rho^2, 1e-6),
//     once per precision it evaluates). They are formed once per staged
//     candidate and once per home slot, by the same explicitly rounded
//     operations as before, so the pair body sees bit-equal values;
//   * the striped pair walk: the vote's warp ballots also compact the
//     cell's n_home valid home slots, in slot order, to h = 0 .. n_home - 1
//     (a map from h to slot in shared memory; the cell list need not fill
//     a prefix), and each home gets G = min(32, blockDim / n_home) lanes
//     (lane_of): lane t serves home t / G and walks rows t % G, +G, +2G,
//     ... of every chunk, tests the cutoff and evaluates the body on the
//     rows inside it. The lanes of one stripe read one row (a broadcast);
//     a warp reads at most G <= 32 consecutive rows, in distinct banks as
//     the row stride is odd. After the last chunk each lane leaves its
//     partial sums in shared memory (the chunk's rows, sized for the
//     body's outputs too) and each home's stripe-0 lane adds stripes 1 ..
//     G - 1 onto its own, in that order (reduce_stripes). G depends on the
//     cell's home count and the block size only, so a cell's outputs are
//     the same bits in the fleet's folded launch and in a cells= subset as
//     in its own launch. With G = 1 (more homes than half the block) a
//     home's sum runs in candidate order, as in the first version;
//   * dx and r2 are computed with explicitly rounded operations
//     (__fmul_rn/__fadd_rn, never contracted into an FMA) in the same order
//     as the plain PyTorch version, so the cutoff and self-exclusion tests
//     decide every pair identically on both paths;
//   * the register budget follows the launch: every entry has the kernel
//     bounded to 1,024 threads (WIDE_THREADS), where ptxas holds a thread
//     to 64 registers; an entry named with CELL_PAIR_ENTRY_FIT(..., FIT)
//     also has one bounded to 256 threads (FIT_THREADS; up to 255
//     registers) or, FIT 1-4, to (256 threads, FIT blocks an SM), a cap of
//     255, 128, 80 or 64 registers, which its launches take wherever the
//     plan's block fits it (cc <= 256). ptxas allocates registers
//     otherwise under each form, even at one cap, and each entry's bound is
//     the one that timed best (cell_pair.cu, codegen.entry_bound; PERF.md,
//     tools/b1_ab.py). More registers did not pay for the widest body
//     (phase 22a's 37 sums a lane, 200-428 B spilled a thread at 64
//     registers): at 80 and 120 registers it lost more to occupancy than
//     it saved in spills. <entry>_attrs reports the registers, the local
//     (spill) bytes and the bound of the instantiation a launch takes.
//
// What bounds the LJ form on the H100: memory. At the MD size (216,000 particles,
// 12,167 cells, cc = 48, K = 27) a kernel needs both masks whole and the
// data of the valid slots only, and writes the forces once: 0.0286 ms at
// 3.35 TB/s (chip_smoke.py's count). The arithmetic is about 1.0e8
// candidate tests and 1.5e7 in-cutoff LJ evaluations, near 1 GFLOP, 16 us
// at 67 TFLOP/s fp32. The K-fold candidate pre-gather (each position is
// written 27 times by the gather and read 27 times here) costs more than
// the kernel; reading candidates through the neighbourhood table inside
// the kernel would remove it and is left to a later change.
//
// The first version took 1.26 ms for LJ, 28.2 ms for SPH and 2.59 ms for
// DEM on an H100 80GB HBM3 (700 W), 44x, 102x and 26x their bounds: every
// home lane walked all K*cc candidates (two thirds of them empty slots),
// the in-cutoff body ran for a warp whenever one lane passed, SPH formed
// its two Tait terms (two powf, two divisions) for every pair, and SPH's
// 110.6 KB of staged candidates left two blocks, 8 warps, on an SM.
// Prediction for this design, written before its first timed run: SPH
// 2-5 ms (about 9e8 warp instructions: 2.5e7 warp steps of the scan and
// 8.3e7 pairs evaluated through the lists at ~70% lane use), LJ 0.5-0.9
// ms, DEM 2.0-2.6 ms (most of its 226,800 blocks hold no grain and exit
// after the vote, as before), the bf16x forms about 1.3x their fp32 times.
// Measured (chip_smoke.py phases 2 and 6, H100 80GB HBM3, 700 W; each
// output bit-equal to the first version's): LJ 0.481 ms (bf16x 1.007),
// SPH 3.29 ms (bf16x 6.65, bf16x:drho 6.17), DEM 0.423 ms (bf16x 0.482),
// 17x, 12x and 4.2x their bounds. The SPH kernel spends 0.43 ms staging,
// 0.60 more scanning (a variant with a trivial body) and the rest, 2.2
// ms, in the in-cutoff body; DEM's 0.33 ms of staging is mostly reading
// its 152 MB of masks.
//
// Tried and dropped, measured on an H100 80GB HBM3 (700 W) against this
// form in one run: per-lane lists of in-cutoff rows (each warp scanning a
// chunk in lock step, every lane appending its in-cutoff rows to a
// 32-entry list in shared memory, the warp evaluating the lists when one
// is full), so that the body runs on in-cutoff pairs only. It kept the
// summation order but was slower for SPH (6.20 against 5.24 ms; bf16x
// 9.86 against 9.45, bf16x:drho 9.18 against 8.74) and for LJ (0.663
// against 0.474), faster only for LJ bf16x (0.840 against 1.017) and DEM
// (0.466 against 0.479): the lanes' lists differ in length, and the list
// reads hit shared-memory banks at random, so divergence is not what
// bounds the body here.
//
// The striped walk replaced one lane per home slot (thread t walking for
// slot t, the other lanes idle). Of the walking warps' lanes, one lane per
// slot kept busy 20% at 2-D MD's ~6.5 particles a cell, 56% at 3-D MD's
// ~18, 70% in the SPH tank and 5% in DEM's sparse box; striped, 97%, 87%,
// 90% and 100% (chip_smoke.py's lane shares). Measured with
// tools/b1_ab.py against the one-lane walk, in turns on the same tiles, on
// an H100 80GB HBM3 at 700 W: 2-D LJ 0.102 ms against 0.214 (bf16x 0.125
// against 0.435), LJ 0.267 against 0.484 (bf16x 0.488 against 1.016), the
// generated Gaussian body 0.231 against 0.402, SPH 2.27 against 3.20
// (bf16x 4.70 against 6.60, bf16x:drho 4.27 against 6.06), DEM 0.367
// against 0.416 (bf16x 0.384 against 0.471). The outputs differ from the
// one-lane walk's in the fp32 summation order only (max rel 4e-6). That
// order now follows the positions of all the valid candidates in a tile,
// not only of those inside the cutoff: two tiles of a cell that differ in
// an out-of-range candidate may sum in different orders (the slab step's
// combine, core/simulation.py, takes each cell's sums from one tile).
//
// ptxas holds the 2-D LJ entries to 32 registers (64 warps an SM) and
// spills 11-12 values around the staging loop, none inside the pair walk
// (a 48-byte stack frame; the one-lane walk had 32 bytes). Kept: a variant
// that ptxas compiled at 52 registers without spills (the home slot as a
// 32-bit index) ran 2-D LJ 2% slower in the same call, and the other
// entries have no frame.

#ifdef __CUDACC__
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#endif

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

  // The ops below serve the functors generated from a traced body
  // (codegen.py); each is what PyTorch's card kernel computes for the aten
  // op named, in fp32 opmath, with the result rounded to P.
  __device__ __forceinline__ static float cvt(float a) {   // _to_copy
    return P::r(a);
  }
  __device__ __forceinline__ static float neg(float a) { return -a; }
  __device__ __forceinline__ static float abs(float a) { return fabsf(a); }
  __device__ __forceinline__ static float exp(float a) {
    return P::r(expf(a));
  }
  __device__ __forceinline__ static float log(float a) {
    return P::r(logf(a));
  }
  __device__ __forceinline__ static float rsqrt(float a) {
    return P::r(rsqrtf(a));
  }
  __device__ __forceinline__ static float recip(float a) {   // reciprocal
    return P::r(__fdiv_rn(1.0f, a));
  }
  // pow(a, -2): c10's 1.0 / (a * a), with a * a rounded to P
  __device__ __forceinline__ static float pow_m2(float a) {
    return recip(mul(a, a));
  }
  // add.Tensor with an alpha other than +-1: a + alpha * b, contracted
  __device__ __forceinline__ static float add_alpha(float a, float b,
                                                    float alpha) {
    return P::r(__fmaf_rn(alpha, b, a));
  }
  // clamp / clamp_min / clamp_max / maximum / minimum propagate a NaN
  __device__ __forceinline__ static float clamp_min(float a, float lo) {
    return a != a ? a : fmaxf(a, lo);
  }
  __device__ __forceinline__ static float clamp_max(float a, float hi) {
    return a != a ? a : fminf(a, hi);
  }
  __device__ __forceinline__ static float maximum(float a, float b) {
    return a != a ? a : (b != b ? b : fmaxf(a, b));
  }
  __device__ __forceinline__ static float minimum(float a, float b) {
    return a != a ? a : (b != b ? b : fminf(a, b));
  }
  // ATen's CUDA unary ops take the CUDA math library's function of the
  // fp32 operand (a bf16 one converted), the result rounded to P once
  __device__ __forceinline__ static float tanh(float a) {
    return P::r(tanhf(a));
  }
  __device__ __forceinline__ static float sin(float a) {
    return P::r(sinf(a));
  }
  __device__ __forceinline__ static float cos(float a) {
    return P::r(cosf(a));
  }
  __device__ __forceinline__ static float erf(float a) {
    return P::r(erff(a));
  }
  __device__ __forceinline__ static float erfc(float a) {
    return P::r(erfcf(a));
  }
  __device__ __forceinline__ static float log1p(float a) {
    return P::r(log1pf(a));
  }
  __device__ __forceinline__ static float expm1(float a) {
    return P::r(expm1f(a));
  }
  __device__ __forceinline__ static float atan2(float a, float b) {
    return P::r(atan2f(a, b));
  }
  // floor, ceil, round and trunc of a P value are P values; round is
  // std::nearbyint (ties to even)
  __device__ __forceinline__ static float floor(float a) { return floorf(a); }
  __device__ __forceinline__ static float ceil(float a) { return ceilf(a); }
  __device__ __forceinline__ static float round(float a) { return rintf(a); }
  __device__ __forceinline__ static float trunc(float a) { return truncf(a); }
  // sign_kernel_cuda: (0 < a) - (a < 0), so sign(NaN) and sign(-0) are 0
  __device__ __forceinline__ static float sign(float a) {
    return static_cast<float>((0.0f < a) - (a < 0.0f));
  }
  // sigmoid_kernel_cuda: 1 / (1 + exp(-a)) in fp32
  __device__ __forceinline__ static float sigmoid(float a) {
    return P::r(__fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-a))));
  }
  __device__ __forceinline__ static float tan(float a) {
    return P::r(tanf(a));
  }
  __device__ __forceinline__ static float asin(float a) {
    return P::r(asinf(a));
  }
  __device__ __forceinline__ static float acos(float a) {
    return P::r(acosf(a));
  }
  __device__ __forceinline__ static float atan(float a) {
    return P::r(atanf(a));
  }
  __device__ __forceinline__ static float sinh(float a) {
    return P::r(sinhf(a));
  }
  __device__ __forceinline__ static float cosh(float a) {
    return P::r(coshf(a));
  }
  __device__ __forceinline__ static float asinh(float a) {
    return P::r(asinhf(a));
  }
  __device__ __forceinline__ static float acosh(float a) {
    return P::r(acoshf(a));
  }
  __device__ __forceinline__ static float atanh(float a) {
    return P::r(atanhf(a));
  }
  __device__ __forceinline__ static float log2(float a) {
    return P::r(log2f(a));
  }
  __device__ __forceinline__ static float exp2(float a) {
    return P::r(exp2f(a));
  }
  __device__ __forceinline__ static float log10(float a) {
    return P::r(log10f(a));
  }
  __device__ __forceinline__ static float lgamma(float a) {
    return P::r(lgammaf(a));
  }
  __device__ __forceinline__ static float hypot(float a, float b) {
    return P::r(hypotf(a, b));
  }
  // copysign and fmod of two P values are P values (fmod is exact)
  __device__ __forceinline__ static float copysign(float a, float b) {
    return copysignf(a, b);
  }
  __device__ __forceinline__ static float fmod(float a, float b) {
    return fmodf(a, b);
  }
  // remainder_kernel_cuda: fmod, then + b where its sign differs from b's
  __device__ __forceinline__ static float remainder(float a, float b) {
    const float m = fmodf(a, b);
    return m != 0.0f && ((b < 0.0f) != (m < 0.0f)) ? P::r(__fadd_rn(m, b))
                                                     : m;
  }
  // c10::div_floor_floating after its quotient q = (a - fmod(a, b)) / b
  // (fp32, unrounded: c10's BFloat16 minus a float is a float): one less
  // where the fmod's sign differs from b's, floored into P, plus one where
  // the floor fell more than a half below; a zero quotient takes the sign
  // of a / b (s)
  __device__ __forceinline__ static float floor_tail(float q, float m,
                                                     float b, float s) {
    if (m != 0.0f && ((b < 0.0f) != (m < 0.0f))) q = __fsub_rn(q, 1.0f);
    if (q == 0.0f) return copysignf(0.0f, s);
    float fl = P::r(floorf(q));
    if (__fsub_rn(q, fl) > 0.5f) fl = P::r(__fadd_rn(fl, 1.0f));
    return fl;
  }
  // floor_divide / div(rounding_mode="floor") of two tensors
  // (div_floor_kernel_cuda: c10::div_floor_floating)
  __device__ __forceinline__ static float floor_div(float a, float b) {
    if (b == 0.0f) return P::r(__fdiv_rn(a, b));
    const float m = fmodf(a, b);
    return floor_tail(__fdiv_rn(__fsub_rn(a, m), b), m, b, __fdiv_rn(a, b));
  }
  // the same by a number b != 0 (a CPU scalar): div_floor_kernel_cuda
  // multiplies by its fp32 reciprocal inv_b in place of dividing
  __device__ __forceinline__ static float floor_div_s(float a, float b,
                                                      float inv_b) {
    const float m = fmodf(a, b);
    return floor_tail(__fmul_rn(__fsub_rn(a, m), inv_b), m, b,
                      __fmul_rn(a, inv_b));
  }
  // div(rounding_mode="trunc"): trunc of a / b rounded to P (c10's
  // BFloat16 / BFloat16 is a BFloat16); by a number, trunc(a * inv_b)
  __device__ __forceinline__ static float div_trunc(float a, float b) {
    return truncf(P::r(__fdiv_rn(a, b)));
  }
  __device__ __forceinline__ static float div_trunc_s(float a, float inv_b) {
    return P::r(truncf(__fmul_rn(a, inv_b)));
  }
  // round(decimals=d) as round_decimals_kernel_cuda computes it in the
  // tensor's type: t = 10^|d| rounded to P, nearbyint(a * t) / t for d > 0
  // and nearbyint(a / t) * t for d < 0, where the product and the quotient
  // of two P values are rounded to P (c10's BFloat16 operators) and the
  // result is rounded to P
  __device__ __forceinline__ static float round_dec(float a, float t) {
    return P::r(__fdiv_rn(rintf(mul(a, t)), t));
  }
  __device__ __forceinline__ static float round_dec_neg(float a, float t) {
    return P::r(__fmul_rn(rintf(div(a, t)), t));
  }
};

// A generated body's integer arithmetic, as PyTorch's int32 kernels do it:
// add, sub, mul and neg wrap (two's complement, through unsigned), floor
// division and remainder round towards minus infinity (c10's
// div_floor_integer, remainder_kernel_cuda; a divisor of -1 cannot
// overflow), and a narrower dtype's result is wrapped to it where it is
// formed (codegen.py). An integer prop travels through the staged fp32
// rows as its int32 value's bits and is read back with __float_as_int.
struct Int {
  __host__ __device__ __forceinline__ static int add(int a, int b) {
    return static_cast<int>(static_cast<unsigned>(a) +
                            static_cast<unsigned>(b));
  }
  __host__ __device__ __forceinline__ static int sub(int a, int b) {
    return static_cast<int>(static_cast<unsigned>(a) -
                            static_cast<unsigned>(b));
  }
  __host__ __device__ __forceinline__ static int mul(int a, int b) {
    return static_cast<int>(static_cast<unsigned>(a) *
                            static_cast<unsigned>(b));
  }
  __host__ __device__ __forceinline__ static int neg(int a) {
    return sub(0, a);
  }
  __host__ __device__ __forceinline__ static int abs(int a) {
    return a < 0 ? neg(a) : a;
  }
  __host__ __device__ __forceinline__ static int sign(int a) {
    return (0 < a) - (a < 0);
  }
  __host__ __device__ __forceinline__ static int div_trunc(int a, int b) {
    return b == -1 ? neg(a) : a / b;
  }
  __host__ __device__ __forceinline__ static int floor_div(int a, int b) {
    if (b == -1) return neg(a);
    const int q = a / b;
    return ((a < 0) != (b < 0)) && a % b != 0 ? q - 1 : q;
  }
  __host__ __device__ __forceinline__ static int rem(int a, int b) {
    if (b == -1) return 0;
    const int r = a % b;
    return r != 0 && ((r < 0) != (b < 0)) ? r + b : r;
  }
  // fmod: the remainder of the truncating division
  __host__ __device__ __forceinline__ static int fmod(int a, int b) {
    return b == -1 ? 0 : a % b;
  }
  // ATen's powi: square and multiply, wrapping; a negative exponent gives
  // 1 for a == 1, +-1 for a == -1 and 0 for any other a
  __host__ __device__ __forceinline__ static int pow(int a, int b) {
    if (b < 0) return a == 1 ? 1 : (a == -1 ? ((b & 1) ? -1 : 1) : 0);
    int r = 1;
    for (; b; b /= 2) {
      if (b & 1) r = mul(r, a);
      a = mul(a, a);
    }
    return r;
  }
  // a table index: negative counts from the end, as in PyTorch; one out
  // of range is clamped to it (PyTorch raises there)
  __host__ __device__ __forceinline__ static int at(int i, int n) {
    i = i < 0 ? i + n : i;
    return i < 0 ? 0 : (i >= n ? n - 1 : i);
  }
};

// The body interface: operator()(dx, r2, wi, wj, hi, hj, radial, scalar)
// takes the fp32 geometry and the fp32 props of one pair that passed the
// mask, with each side's per-particle terms hi / hj, and writes
// radial[k * DIM + d] (the per-pair term of radial output k) and
// scalar[k]. N_HOOK is the number of per-particle terms and hook(w, h)
// forms them from one particle's props (the kernel calls it once per
// staged candidate and once per home slot); a body without any declares
// N_HOOK = 0 and an empty hook.

// `bf16x:<names>`: the body evaluated under both precisions, each output
// taking its own (B32 and B16 are one functor at F32 and at BF16).
// Bit k of RAD16 / SCA16: radial / scalar output k takes the bf16
// evaluation. The per-particle terms are both functors', fp32 first.
template <class B32, class B16, unsigned RAD16, unsigned SCA16>
struct MixedBody {
  static constexpr int DIM = B32::DIM;
  static constexpr int N_RADIAL = B32::N_RADIAL;
  static constexpr int N_SCALAR = B32::N_SCALAR;
  static constexpr int N_HOOK = B32::N_HOOK + B16::N_HOOK;
  B32 f32;
  B16 bf16;

  static MixedBody from(const float* p) {
    return MixedBody{B32::from(p), B16::from(p)};
  }

  __device__ __forceinline__ void hook(const float* w, float* h) const {
    f32.hook(w, h);
    bf16.hook(w, h + B32::N_HOOK);
  }

  __device__ __forceinline__ void operator()(const float* dx, float r2,
                                             const float* wi,
                                             const float* wj,
                                             const float* hi,
                                             const float* hj, float* radial,
                                             float* scalar) const {
    float rad16[N_RADIAL > 0 ? N_RADIAL * DIM : 1],
        sca16[N_SCALAR > 0 ? N_SCALAR : 1];
    f32(dx, r2, wi, wj, hi, hj, radial, scalar);
    bf16(dx, r2, wi, wj, hi + B32::N_HOOK, hj + B32::N_HOOK, rad16, sca16);
#pragma unroll
    for (int i = 0; i < N_RADIAL * DIM; ++i)
      if (RAD16 >> (i / DIM) & 1u) radial[i] = rad16[i];
#pragma unroll
    for (int i = 0; i < N_SCALAR; ++i)
      if (SCA16 >> i & 1u) scalar[i] = sca16[i];
  }
};

// The pair walk's lane map. A block of `threads` lanes serves a cell's
// n_home >= 1 valid home slots, compacted in slot order to h = 0 ..
// n_home - 1, with G stripes each: lane t takes home h = t / G and stripe
// s = t % G, and walks rows s, s + G, s + 2G, ... of every chunk; a lane
// with h >= n_home walks nothing. G depends on the cell's home count and
// the block size only, so a cell's outputs are the same bits in any launch
// that holds it (the fleet's folded launch, a cells= subset).
struct Lane {
  int h, s, G;
};

__host__ __device__ __forceinline__ int stripes(int n_home, int threads) {
  const int g = threads / n_home;
  return g < 32 ? g : 32;
}

__host__ __device__ __forceinline__ Lane lane_of(int n_home, int threads,
                                                 int t) {
  const int G = stripes(n_home, threads);
  return Lane{t / G, t % G, G};
}

// The lane that holds stripe s of home h.
__host__ __device__ __forceinline__ int stripe_lane(int h, int s, int G) {
  return h * G + s;
}

// Home h's reduction, run by its stripe-0 lane on its own sums: add(lane)
// for the lanes of stripes 1 .. G - 1, in that order.
#ifdef __CUDACC__
#pragma nv_exec_check_disable    // the kernel passes a device lambda
#endif
template <class Add>
__host__ __device__ __forceinline__ void reduce_stripes(int h, int G,
                                                        Add add) {
  for (int s = 1; s < G; ++s) add(stripe_lane(h, s, G));
}

#ifdef __CUDACC__

template <int N>
struct AtLeastOne {
  static constexpr int value = N > 0 ? N : 1;
};

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_REP = 4;     // sub-tiles of blockDim candidates per tile
// A chunk's rows stay within this many bytes of shared memory unless a
// tile of one sub-tile (blockDim candidates) needs more, so that several
// blocks share an SM.
constexpr size_t CHUNK_BYTES = 20 * 1024;

// Floats per staged row: position, props, per-particle terms; padded to
// an odd count so that the rows that the lanes of a warp stage at once
// fall in distinct banks.
template <class Body, int NPROP>
struct Row {
  static constexpr int S = (Body::DIM + NPROP + Body::N_HOOK) | 1;
};

// Floats of the shared area that holds, in turn, the home map, a chunk's
// rows and the lanes' partial sums (one per output float and lane).
template <class Body, int NPROP>
__host__ __device__ __forceinline__ size_t rows_floats(int chunk,
                                                       int threads) {
  constexpr int NOUT = Body::N_RADIAL * Body::DIM + Body::N_SCALAR;
  const size_t rows = static_cast<size_t>(chunk) * Row<Body, NPROP>::S;
  const size_t parts = static_cast<size_t>(threads) * NOUT;
  return rows > parts ? rows : parts;
}

// The launch geometry of a cell capacity cc: threads, sub-tiles per tile
// (the most, up to MAX_REP, whose chunk of 2 x tile rows fits
// CHUNK_BYTES), chunk rows and dynamic shared memory.
struct Plan {
  int threads, rep, chunk;
  size_t smem;
};

template <class Body, int NPROP>
Plan plan_for(int cc) {
  Plan p;
  p.threads = ((cc + 31) / 32) * 32;
  constexpr size_t row_bytes = sizeof(float) * Row<Body, NPROP>::S;
  p.rep = MAX_REP;
  while (p.rep > 1 && 2 * p.rep * p.threads * row_bytes > CHUNK_BYTES)
    p.rep /= 2;
  p.chunk = 2 * p.rep * p.threads;
  const int warps = p.threads / 32;
  p.smem = sizeof(float) * rows_floats<Body, NPROP>(p.chunk, p.threads)
           + sizeof(int) * 2 * MAX_REP * warps;
  return p;
}

// Writes one slot's sums (the zeros of a slot that holds no particle).
template <class Body, int NR, int NS>
__device__ __forceinline__ void store(float* __restrict__ out_radial,
                                      float* __restrict__ out_scalar,
                                      size_t n_slots, size_t slot,
                                      const float (&acc_r)[NR][Body::DIM],
                                      const float (&acc_s)[NS]) {
#pragma unroll
  for (int k = 0; k < Body::N_RADIAL; ++k)
#pragma unroll
    for (int d = 0; d < Body::DIM; ++d)
      out_radial[(k * n_slots + slot) * Body::DIM + d] = acc_r[k][d];
#pragma unroll
  for (int k = 0; k < Body::N_SCALAR; ++k)
    out_scalar[k * n_slots + slot] = acc_s[k];
}

// dx = xi - xj and r2 with explicitly rounded operations, in the plain
// version's order.
template <int DIM>
__device__ __forceinline__ float geometry(const float* xi, const float* xj,
                                          float* dx) {
  float r2 = 0.0f;
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    dx[d] = __fsub_rn(xi[d], xj[d]);
    const float sq = __fmul_rn(dx[d], dx[d]);
    r2 = d == 0 ? sq : __fadd_rn(r2, sq);
  }
  return r2;
}

// The kernel's thread bounds (the register budget, above).
constexpr int WIDE_THREADS = 1024;
constexpr int FIT_THREADS = 256;

// One block's work: the cell blockIdx.x. The kernels below differ only in
// their __launch_bounds__.
template <class Body, int DIM, int NPROP>
__device__ __forceinline__ void cell_pair_block(
    const float* __restrict__ cell_x,      // (C, cc, DIM)
    const float* __restrict__ nbr_x,       // (C, kcc, DIM)
    const bool* __restrict__ cell_mask,    // (C, cc)
    const bool* __restrict__ nbr_mask,     // (C, kcc)
    const float* __restrict__ props_i,     // (C, cc, NPROP), unused if 0
    const float* __restrict__ props_j,     // (C, kcc, NPROP), unused if 0
    float* __restrict__ out_radial,        // (N_RADIAL, C, cc, DIM)
    float* __restrict__ out_scalar,        // (N_SCALAR, C, cc)
    int C, int cc, int kcc, float rc2, Body body, int rep, int chunk) {
  static_assert(Body::DIM == DIM, "the body is built for another DIM");
  constexpr int S = Row<Body, NPROP>::S;
  constexpr int NH = Body::N_HOOK;
  constexpr int NP = AtLeastOne<NPROP>::value;
  constexpr int NHP = AtLeastOne<NH>::value;
  constexpr int NR = AtLeastOne<Body::N_RADIAL>::value;
  constexpr int NS = AtLeastOne<Body::N_SCALAR>::value;
  extern __shared__ float smem[];

  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int warps = T / 32, warp = t / 32, lane = t % 32;
  // the home map, then a chunk's rows (chunk x S), then the partial sums
  float* s_rows = smem;
  int* s_cnt = reinterpret_cast<int*>(
      smem + rows_floats<Body, NPROP>(chunk, T));
  const size_t cell0 = static_cast<size_t>(c) * cc;
  const size_t n_slots = static_cast<size_t>(C) * cc;
  const bool home = t < cc && cell_mask[cell0 + t];
  const unsigned below = (1u << lane) - 1u;

  float acc_r[NR][DIM];
  float acc_s[NS];
#pragma unroll
  for (int k = 0; k < NR; ++k)
#pragma unroll
    for (int d = 0; d < DIM; ++d) acc_r[k][d] = 0.0f;
#pragma unroll
  for (int k = 0; k < NS; ++k) acc_s[k] = 0.0f;

  // A slot without a particle gets zeros, and a cell with no particle
  // reads no candidate (most cells of the SPH tank's air and of the DEM
  // box are empty).
  const unsigned home_bits = __ballot_sync(FULL, home);
  if (lane == 0) s_cnt[warp] = __popc(home_bits);
  if (t < cc && !home)
    store<Body>(out_radial, out_scalar, n_slots, cell0 + t, acc_r, acc_s);
  if (!__syncthreads_or(home)) return;

  // -- the valid homes, compacted in slot order, and this lane's one ------
  int n_home = 0, h0 = 0;
  for (int w = 0; w < warps; ++w) {
    if (w == warp) h0 = n_home;
    n_home += s_cnt[w];
  }
  int* s_home = reinterpret_cast<int*>(s_rows);
  if (home) s_home[h0 + __popc(home_bits & below)] = t;
  __syncthreads();
  const Lane L = lane_of(n_home, T, t);
  const bool walks = L.h < n_home;
  // read before the first tile's __syncthreads, after which rows are written
  const size_t slot = cell0 + (walks ? s_home[L.h] : 0);
  {  // the staging and the walk, chunk by chunk
    float xi[DIM], wi[NP], hi[NHP];
#pragma unroll
    for (int d = 0; d < DIM; ++d)
      xi[d] = walks ? cell_x[slot * DIM + d] : 0.0f;
#pragma unroll
    for (int p = 0; p < NPROP; ++p)
      wi[p] = walks ? props_i[slot * NPROP + p] : 0.0f;
    if (walks) body.hook(wi, hi);
    const bool* nm = nbr_mask + static_cast<size_t>(c) * kcc;
    const size_t cand0 = static_cast<size_t>(c) * kcc;

    int n = 0, parity = 0;
    const int tile = rep * T;
    for (int base = 0; base < kcc; base += tile) {
      // -- stable compaction of this tile's valid candidates -------------
      bool v[MAX_REP];
      int pre[MAX_REP];
      int* cnt = s_cnt + parity * MAX_REP * warps;
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r) {
        const int j = base + r * T + t;
        v[r] = r < rep && j < kcc && nm[j];
      }
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r) {
        if (r >= rep) break;
        const unsigned b = __ballot_sync(FULL, v[r]);
        pre[r] = __popc(b & below);
        if (lane == 0) cnt[r * warps + warp] = __popc(b);
      }
      __syncthreads();
      int total = 0;
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r) {
        if (r >= rep) break;
        for (int w = 0; w < warps; ++w) {
          if (w == warp) pre[r] += n + total;
          total += cnt[r * warps + w];
        }
      }
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r) {
        if (r >= rep || !v[r]) continue;
        const size_t j = cand0 + base + r * T + t;
        float* row = s_rows + pre[r] * S;
#pragma unroll
        for (int d = 0; d < DIM; ++d) row[d] = nbr_x[j * DIM + d];
        float wj[NP];
#pragma unroll
        for (int p = 0; p < NPROP; ++p) {
          wj[p] = props_j[j * NPROP + p];
          row[DIM + p] = wj[p];
        }
        if (NH > 0) body.hook(wj, row + DIM + NPROP);
      }
      n += total;
      parity ^= 1;
      if (n <= chunk - tile && base + tile < kcc) continue;

      // -- the chunk: each lane walks its home's stripe, in row order ----
      __syncthreads();
      if (walks) {
        for (int jj = L.s; jj < n; jj += L.G) {
          const float* cj = s_rows + jj * S;
          float dx[DIM];
          const float r2 = geometry<DIM>(xi, cj, dx);
          if (!(r2 < rc2 && r2 > 1e-12f)) continue;
          float rad[NR * DIM];
          float sca[NS];
          body(dx, r2, wi, cj + DIM, hi, cj + DIM + NPROP, rad, sca);
#pragma unroll
          for (int q = 0; q < Body::N_RADIAL; ++q)
#pragma unroll
            for (int d = 0; d < DIM; ++d) acc_r[q][d] += rad[q * DIM + d];
#pragma unroll
          for (int q = 0; q < Body::N_SCALAR; ++q) acc_s[q] += sca[q];
        }
      }
      __syncthreads();
      n = 0;
    }
  }

  // -- each home's G partial sums, added in stripe order (G = 1: the
  // lane's own sums, as walked) ---------------------------------------------
  if (L.G > 1) {
    // the last chunk ended with __syncthreads: its rows are free
    float* s_part = s_rows;                                 // NOUT x T
#pragma unroll
    for (int k = 0; k < Body::N_RADIAL; ++k)
#pragma unroll
      for (int d = 0; d < DIM; ++d) s_part[(k * DIM + d) * T + t] = acc_r[k][d];
#pragma unroll
    for (int k = 0; k < Body::N_SCALAR; ++k)
      s_part[(Body::N_RADIAL * DIM + k) * T + t] = acc_s[k];
    __syncthreads();
    if (walks && L.s == 0) {
      reduce_stripes(L.h, L.G, [&](int lane_s) {
        const float* p = s_part + lane_s;
#pragma unroll
        for (int k = 0; k < Body::N_RADIAL; ++k)
#pragma unroll
          for (int d = 0; d < DIM; ++d) acc_r[k][d] += p[(k * DIM + d) * T];
#pragma unroll
        for (int k = 0; k < Body::N_SCALAR; ++k)
          acc_s[k] += p[(Body::N_RADIAL * DIM + k) * T];
      });
    }
  }
  if (walks && L.s == 0)
    store<Body>(out_radial, out_scalar, n_slots, slot, acc_r, acc_s);
}

#define CELL_PAIR_KERNEL_ARGS                                              \
  const float *__restrict__ cell_x, const float *__restrict__ nbr_x,       \
      const bool *__restrict__ cell_mask, const bool *__restrict__ nbr_mask, \
      const float *__restrict__ props_i, const float *__restrict__ props_j, \
      float *__restrict__ out_radial, float *__restrict__ out_scalar, int C, \
      int cc, int kcc, float rc2, Body body, int rep, int chunk
#define CELL_PAIR_KERNEL_PASS                                              \
  cell_x, nbr_x, cell_mask, nbr_mask, props_i, props_j, out_radial,        \
      out_scalar, C, cc, kcc, rc2, body, rep, chunk

// At most MAXT threads a block; ptxas picks the registers a thread within
// 65536 / MAXT (64 at WIDE_THREADS, 255 at FIT_THREADS).
template <class Body, int DIM, int NPROP, int MAXT>
__global__ void __launch_bounds__(MAXT)
    cell_pair_kernel(CELL_PAIR_KERNEL_ARGS) {
  cell_pair_block<Body, DIM, NPROP>(CELL_PAIR_KERNEL_PASS);
}

// At most MAXT threads a block and MINB blocks of them resident on an SM:
// at most 65536 / (MAXT MINB) registers a thread (255, 128, 80, 64 for
// MINB 1-4 at FIT_THREADS). ptxas allocates otherwise than under MAXT
// alone, even where the cap is the same (PERF.md).
template <class Body, int DIM, int NPROP, int MAXT, int MINB>
__global__ void __launch_bounds__(MAXT, MINB)
    cell_pair_kernel_blocks(CELL_PAIR_KERNEL_ARGS) {
  cell_pair_block<Body, DIM, NPROP>(CELL_PAIR_KERNEL_PASS);
}

// The instantiation a launch of `threads` threads takes and its bound
// (threads, blocks; blocks 0: none given). FIT < 0: the wide kernel
// (WIDE_THREADS) alone; FIT 0: the one bounded to FIT_THREADS, FIT 1-4:
// to (FIT_THREADS, FIT), where the block fits it, else the wide one.
template <class Body, int NPROP, int FIT>
auto kernel_for(int threads, int (&bound)[2]) {
  constexpr int DIM = Body::DIM;
  if constexpr (FIT == 0) {
    if (threads <= FIT_THREADS) {
      bound[0] = FIT_THREADS, bound[1] = 0;
      return cell_pair_kernel<Body, DIM, NPROP, FIT_THREADS>;
    }
  } else if constexpr (FIT > 0) {
    if (threads <= FIT_THREADS) {
      bound[0] = FIT_THREADS, bound[1] = FIT;
      return cell_pair_kernel_blocks<Body, DIM, NPROP, FIT_THREADS, FIT>;
    }
  }
  bound[0] = WIDE_THREADS, bound[1] = 0;
  return cell_pair_kernel<Body, DIM, NPROP, WIDE_THREADS>;
}

template <class Body, int NPROP, int FIT>
int launch(const void* cell_x, const void* nbr_x, const void* cell_mask,
           const void* nbr_mask, const void* props_i, const void* props_j,
           void* out_radial, void* out_scalar, int C, int cc, int kcc,
           float rc2, const float* params, void* stream) {
  const Plan p = plan_for<Body, NPROP>(cc);
  int bound[2];
  auto kern = kernel_for<Body, NPROP, FIT>(p.threads, bound);
  if (p.smem > 48 * 1024) {
    // above 48 KB only as opted-in dynamic shared memory
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(p.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (C > 0) {
    kern<<<C, p.threads, p.smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(cell_x), static_cast<const float*>(nbr_x),
        static_cast<const bool*>(cell_mask),
        static_cast<const bool*>(nbr_mask),
        static_cast<const float*>(props_i),
        static_cast<const float*>(props_j),
        static_cast<float*>(out_radial), static_cast<float*>(out_scalar), C,
        cc, kcc, rc2, Body::from(params), p.rep, p.chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

template <class Body, int NPROP>
int plan_entry(int cc, int* out) {
  if (cc < 1 || cc > 1024) return 1;   // cudaErrorInvalidValue
  const Plan p = plan_for<Body, NPROP>(cc);
  out[0] = p.threads;
  out[1] = p.rep * p.threads;
  out[2] = p.chunk;
  out[3] = static_cast<int>(p.smem);
  return 0;
}

template <class Body, int NPROP, int FIT>
int attrs_entry(int cc, int* out) {
  if (cc < 1 || cc > 1024) return 1;   // cudaErrorInvalidValue
  const Plan p = plan_for<Body, NPROP>(cc);
  int bound[2];
  auto kern = kernel_for<Body, NPROP, FIT>(p.threads, bound);
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kern);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = bound[0];
  out[3] = bound[1];
  return 0;
}

#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__

// C entries, one per (body, precision, DIM). Every entry takes the same
// arguments: the tiles (cell_x, nbr_x, cell_mask, nbr_mask), the packed
// props (C, cc, NPROP) / (C, kcc, NPROP) or null, the outputs
// out_radial (N_RADIAL, C, cc, DIM) and out_scalar (N_SCALAR, C, cc) or
// null, the sizes, the
// squared cutoff, the body's float params (a host array, in the order its
// functor lists) and the stream. Each returns cudaGetLastError() after the
// launch (or the error of the shared-memory opt-in). Beside each, <entry>_plan(cc, out)
// writes the launch geometry for a cell capacity cc: threads per block,
// candidates per staging tile, rows per chunk, dynamic shared-memory bytes;
// and <entry>_attrs(cc, out) the instantiation that a launch at cc takes:
// its registers a thread, its local (spill) bytes a thread and its bound
// (threads, blocks; 0 blocks: none given). CELL_PAIR_ENTRY_FIT(..., FIT)
// names an entry whose launches take the kernel bounded to FIT_THREADS
// (FIT 0) or to (FIT_THREADS, FIT blocks) (FIT 1-4) where the block fits
// it, CELL_PAIR_ENTRY one that keeps the wide bound (FIT -1).
#define CELL_PAIR_ARGS                                                     \
  const void *cell_x, const void *nbr_x, const void *cell_mask,            \
      const void *nbr_mask, const void *props_i, const void *props_j,      \
      void *out_radial, void *out_scalar, int C, int cc, int kcc,          \
      float rc2, const float *params, void *stream
#define CELL_PAIR_PASS                                                     \
  cell_x, nbr_x, cell_mask, nbr_mask, props_i, props_j, out_radial,        \
      out_scalar, C, cc, kcc, rc2, params, stream
#define CELL_PAIR_ENTRY_FIT(NAME, BODY, NPROP, FIT)                        \
  int NAME(CELL_PAIR_ARGS) {                                               \
    return launch<BODY, NPROP, FIT>(CELL_PAIR_PASS);                       \
  }                                                                        \
  int NAME##_plan(int cc, int *out) { return plan_entry<BODY, NPROP>(cc, out); } \
  int NAME##_attrs(int cc, int *out) {                                     \
    return attrs_entry<BODY, NPROP, FIT>(cc, out);                         \
  }
#define CELL_PAIR_ENTRY(NAME, BODY, NPROP) \
  CELL_PAIR_ENTRY_FIT(NAME, BODY, NPROP, -1)

#endif  // __CUDACC__
