// A host stand-in for the CUDA intrinsics that the cell-pair engine's
// operand types and Ops<P> use (src/repro_torch/kernels/cell_pair/csrc/
// cell_pair_engine.cuh), so that g++ can evaluate a body functor pair by
// pair: __device__ and __forceinline__ are empty, the __f*_rn operations
// are plain IEEE float operations (g++ on x86-64 neither contracts nor
// widens them), and bfloat16 rounds to nearest even. Included before the
// engine header (tests/test_torch_pair_codegen.py).
#pragma once

#include <math.h>

#include <cmath>
#include <cstdint>
#include <cstring>

#define __device__
#define __host__
#define __forceinline__ inline

struct __nv_bfloat16 {
  uint16_t bits;
};

inline __nv_bfloat16 __float2bfloat16_rn(float x) {
  uint32_t u;
  std::memcpy(&u, &x, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {uint16_t((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {uint16_t(u >> 16)};
}

inline float __bfloat162float(__nv_bfloat16 h) {
  uint32_t u = uint32_t(h.bits) << 16;
  float x;
  std::memcpy(&x, &u, 4);
  return x;
}

inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
inline float rsqrtf(float a) { return 1.0f / std::sqrt(a); }
