// Fused Gray-Scott step for Hopper (sm_90a): the periodic 7-point
// Laplacian of both species, the u v^2 reaction, the feed and kill terms
// and the explicit-Euler update, in one pass over the two fields.
//
// Replaces the Pallas TPU kernel `_kernel` in
// src/repro/kernels/stencil7/stencil7.py (launched by `gray_scott_step`).
// It computes that function, not its blocking: the Pallas kernel passes
// each field three times with (i-1, i, i+1) block maps to assemble its x
// halo in VMEM; here every thread reads its own neighbours.
//
//   lap(f) = ((-6 f + f[i-1] + f[i+1] + f[j-1] + f[j+1] + f[k-1] + f[k+1])
//             * inv_h2                    (periodic wrap on every axis)
//   u' = u + dt (Du lap(u) - u v v + F (1 - u))
//   v' = v + dt (Dv lap(v) + u v v - (F + k) v)
//
// Every operation is the plain PyTorch version's (kernels/stencil7/ref.py),
// in its order and rounded as PyTorch rounds it: __fmul_rn / __fadd_rn /
// __fsub_rn, so nvcc contracts nothing into an FMA (PyTorch's own add and
// sub, a + alpha b with alpha = +-1, round like one add). Each constant is
// the float of the Python double that PyTorch's scalar op takes, and F + k
// is summed in double on the host. The kernel and the plain version agree
// bit for bit.
//
// The fields may be float32, bfloat16 or float16 (the Pallas kernel
// computes in the fields' dtype and writes it): one kernel templated on
// the element type. As PyTorch's CUDA elementwise ops do for the two
// 16-bit types, each operation loads its operands to fp32, computes in
// fp32 (a Python number stays fp32) and rounds its result to the element
// type (Elem<T>::r), so the 16-bit forms too equal the plain version run
// on the card bit for bit. They move half the bytes: 0.040 ms at 256^3
// and 3.35 TB/s.
//
// The 16-bit forms are bound by those roundings, not by memory: a node
// rounds 31 results, one cvt.rn.bf16.f32 (f16) each, and the card issues
// conversions at a quarter of the fp32 rate. One node a thread took
// 0.1492 ms in bf16 and 0.1466 in fp16 at 256^3, slower than fp32's
// 0.1173 (H100 80GB HBM3, 700 W; PERF.md). So where nz is even and the
// pointers 4-byte aligned, a thread takes two adjacent nodes along z
// (gray_scott_pairs): the same operations in the same order on each, each
// rounding of the two results one packed conversion (cvt.rn.bf16x2.f32,
// f16x2), and the pair's loads and stores 32-bit words (its own z
// neighbours are each other's centres). Measured so (chip_smoke.py phase
// 22b, the two forms in turns in one process, same card): bf16 0.1092 ms
// against the one-node form's 0.1479, fp16 0.0977 against 0.1448; still
// 2.4-2.7x the bound.
//
// Design (a simple, correct first version): one thread per node, 32 x 8
// thread blocks along (z, y), one grid row of blocks per x plane; the
// seven u and seven v loads go through the read-only path (__ldg), and
// neighbour reuse comes from L1 and L2 (a few 256^2 x 4 B planes of each
// field fit many times in the 50 MB L2). The results go to fresh outputs.
//
// What bounds it on the H100: memory. At the paper's 256^3 nodes one step
// reads u and v and writes u' and v': 4 x 256^3 x 4 B = 268 MB, 0.080 ms
// at 3.35 TB/s; its ~31 flops a node are 5.2e8 flops, 0.008 ms at
// 67 TFLOP/s fp32. Measured on an H100 80GB HBM3 (700 W): 0.118 ms, 1.47x
// the bound (2.28 TB/s); 5000 steps take 0.59 s.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// An element type: load as fp32, round an fp32 result to the type (as an
// fp32 value), store.
template <class T>
struct Elem;

template <>
struct Elem<float> {
  __device__ __forceinline__ static float load(const float* p) {
    return __ldg(p);
  }
  __device__ __forceinline__ static float r(float x) { return x; }
  __device__ __forceinline__ static float store(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  __device__ __forceinline__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(__ldg(p));
  }
  __device__ __forceinline__ static float r(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  __device__ __forceinline__ static __nv_bfloat16 store(float x) {
    return __float2bfloat16_rn(x);
  }
};

template <>
struct Elem<__half> {
  __device__ __forceinline__ static float load(const __half* p) {
    return __half2float(__ldg(p));
  }
  __device__ __forceinline__ static float r(float x) {
    return __half2float(__float2half_rn(x));
  }
  __device__ __forceinline__ static __half store(float x) {
    return __float2half_rn(x);
  }
};

// The packed form of a 16-bit element type: two adjacent elements as a
// float2, rounded and stored with one conversion.
template <class T>
struct Pair;

template <>
struct Pair<__nv_bfloat16> {
  using V = __nv_bfloat162;
  __device__ __forceinline__ static float2 load(const __nv_bfloat16* p) {
    return __bfloat1622float2(__ldg(reinterpret_cast<const V*>(p)));
  }
  __device__ __forceinline__ static float2 r(float2 x) {
    return __bfloat1622float2(__float22bfloat162_rn(x));
  }
  __device__ __forceinline__ static V store(float2 x) {
    return __float22bfloat162_rn(x);
  }
};

template <>
struct Pair<__half> {
  using V = __half2;
  __device__ __forceinline__ static float2 load(const __half* p) {
    return __half22float2(__ldg(reinterpret_cast<const V*>(p)));
  }
  __device__ __forceinline__ static float2 r(float2 x) {
    return __half22float2(__float22half2_rn(x));
  }
  __device__ __forceinline__ static V store(float2 x) {
    return __float22half2_rn(x);
  }
};

// fp32 arithmetic on both lanes of a pair, each IEEE-rounded
__device__ __forceinline__ float2 add2(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}
__device__ __forceinline__ float2 sub2(float2 a, float2 b) {
  return make_float2(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y));
}
__device__ __forceinline__ float2 mul2(float2 a, float2 b) {
  return make_float2(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y));
}
__device__ __forceinline__ float2 scale2(float s, float2 a) {
  return make_float2(__fmul_rn(s, a.x), __fmul_rn(s, a.y));
}

struct Coefs {
  float Du, Dv, F, Fk, dt, inv_h2;
};

template <class T>
__device__ __forceinline__ float lap7(const T* __restrict__ f, float c,
                                      size_t xm, size_t xp, size_t ym,
                                      size_t yp, size_t zm, size_t zp,
                                      float inv_h2) {
  using E = Elem<T>;
  float o = E::r(__fmul_rn(-6.0f, c));
  o = E::r(__fadd_rn(o, E::load(f + xm)));
  o = E::r(__fadd_rn(o, E::load(f + xp)));
  o = E::r(__fadd_rn(o, E::load(f + ym)));
  o = E::r(__fadd_rn(o, E::load(f + yp)));
  o = E::r(__fadd_rn(o, E::load(f + zm)));
  o = E::r(__fadd_rn(o, E::load(f + zp)));
  return E::r(__fmul_rn(o, inv_h2));
}

template <class T>
__global__ void gray_scott_step_kernel(const T* __restrict__ u,
                                       const T* __restrict__ v,
                                       T* __restrict__ un,
                                       T* __restrict__ vn, int nx, int ny,
                                       int nz, Coefs c) {
  using E = Elem<T>;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int i = blockIdx.z;
  if (k >= nz || j >= ny) return;
  const size_t plane = static_cast<size_t>(ny) * nz;
  const size_t row = static_cast<size_t>(j) * nz;
  const size_t x0 = static_cast<size_t>(i) * plane;
  const size_t at = x0 + row + k;
  // roll(f, +1) reads index - 1, roll(f, -1) index + 1, both wrapped
  const size_t xm = static_cast<size_t>(i == 0 ? nx - 1 : i - 1) * plane
                    + row + k;
  const size_t xp = static_cast<size_t>(i == nx - 1 ? 0 : i + 1) * plane
                    + row + k;
  const size_t ym = x0 + static_cast<size_t>(j == 0 ? ny - 1 : j - 1) * nz
                    + k;
  const size_t yp = x0 + static_cast<size_t>(j == ny - 1 ? 0 : j + 1) * nz
                    + k;
  const size_t zm = x0 + row + (k == 0 ? nz - 1 : k - 1);
  const size_t zp = x0 + row + (k == nz - 1 ? 0 : k + 1);

  const float uc = E::load(u + at);
  const float vc = E::load(v + at);
  const float lu = lap7(u, uc, xm, xp, ym, yp, zm, zp, c.inv_h2);
  const float lv = lap7(v, vc, xm, xp, ym, yp, zm, zp, c.inv_h2);
  const float uvv = E::r(__fmul_rn(E::r(__fmul_rn(uc, vc)), vc));
  // u + dt (Du lap(u) - uvv + F (1 - u))
  const float du = E::r(__fadd_rn(
      E::r(__fsub_rn(E::r(__fmul_rn(c.Du, lu)), uvv)),
      E::r(__fmul_rn(c.F, E::r(__fsub_rn(1.0f, uc))))));
  // v + dt (Dv lap(v) + uvv - (F + k) v)
  const float dv = E::r(__fsub_rn(E::r(__fadd_rn(E::r(__fmul_rn(c.Dv, lv)),
                                                 uvv)),
                                  E::r(__fmul_rn(c.Fk, vc))));
  un[at] = E::store(__fadd_rn(uc, E::r(__fmul_rn(c.dt, du))));
  vn[at] = E::store(__fadd_rn(vc, E::r(__fmul_rn(c.dt, dv))));
}

// The 7-point Laplacian of nodes (k, k + 1) of a 16-bit field, each sum
// in the one-node order; zm and zp are node k's z - 1 and node k + 1's
// z + 1 neighbours (the other two are the pair's own centres).
template <class T>
__device__ __forceinline__ float2 lap7_pair(const T* __restrict__ f,
                                            float2 c, size_t xm, size_t xp,
                                            size_t ym, size_t yp, size_t zm,
                                            size_t zp, float inv_h2) {
  using E = Pair<T>;
  float2 o = E::r(scale2(-6.0f, c));
  o = E::r(add2(o, E::load(f + xm)));
  o = E::r(add2(o, E::load(f + xp)));
  o = E::r(add2(o, E::load(f + ym)));
  o = E::r(add2(o, E::load(f + yp)));
  o = E::r(add2(o, make_float2(Elem<T>::load(f + zm), c.x)));
  o = E::r(add2(o, make_float2(c.y, Elem<T>::load(f + zp))));
  return E::r(scale2(inv_h2, o));
}

// Two adjacent nodes (k, k + 1), k even, per thread: nz even, 16-bit T.
template <class T>
__global__ void gray_scott_pairs(const T* __restrict__ u,
                                 const T* __restrict__ v, T* __restrict__ un,
                                 T* __restrict__ vn, int nx, int ny, int nz,
                                 Coefs c) {
  using E = Pair<T>;
  const int k = 2 * (blockIdx.x * blockDim.x + threadIdx.x);
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  const int i = blockIdx.z;
  if (k >= nz || j >= ny) return;
  const size_t plane = static_cast<size_t>(ny) * nz;
  const size_t row = static_cast<size_t>(j) * nz;
  const size_t x0 = static_cast<size_t>(i) * plane;
  const size_t at = x0 + row + k;
  const size_t xm = static_cast<size_t>(i == 0 ? nx - 1 : i - 1) * plane
                    + row + k;
  const size_t xp = static_cast<size_t>(i == nx - 1 ? 0 : i + 1) * plane
                    + row + k;
  const size_t ym = x0 + static_cast<size_t>(j == 0 ? ny - 1 : j - 1) * nz
                    + k;
  const size_t yp = x0 + static_cast<size_t>(j == ny - 1 ? 0 : j + 1) * nz
                    + k;
  const size_t zm = x0 + row + (k == 0 ? nz - 1 : k - 1);
  const size_t zp = x0 + row + (k + 2 == nz ? 0 : k + 2);

  const float2 uc = E::load(u + at);
  const float2 vc = E::load(v + at);
  const float2 lu = lap7_pair(u, uc, xm, xp, ym, yp, zm, zp, c.inv_h2);
  const float2 lv = lap7_pair(v, vc, xm, xp, ym, yp, zm, zp, c.inv_h2);
  const float2 uvv = E::r(mul2(E::r(mul2(uc, vc)), vc));
  const float2 du = E::r(add2(
      E::r(sub2(E::r(scale2(c.Du, lu)), uvv)),
      E::r(scale2(c.F, E::r(sub2(make_float2(1.0f, 1.0f), uc))))));
  const float2 dv = E::r(sub2(E::r(add2(E::r(scale2(c.Dv, lv)), uvv)),
                              E::r(scale2(c.Fk, vc))));
  *reinterpret_cast<typename E::V*>(un + at) =
      E::store(add2(uc, E::r(scale2(c.dt, du))));
  *reinterpret_cast<typename E::V*>(vn + at) =
      E::store(add2(vc, E::r(scale2(c.dt, dv))));
}

template <class T>
bool paired(const void* const (&p)[4], int nz) {
  if (sizeof(T) != 2 || nz % 2) return false;
  for (const void* q : p)
    if (reinterpret_cast<uintptr_t>(q) % 4) return false;
  return true;
}

template <class T>
int launch(const void* u, const void* v, void* un, void* vn, int nx, int ny,
           int nz, const Coefs& c, void* stream) {
  if (nx < 1 || ny < 1 || nz < 1 || nx > 65535 || ny > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(32, 8);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto *pu = static_cast<const T*>(u), *pv = static_cast<const T*>(v);
  auto *pun = static_cast<T*>(un), *pvn = static_cast<T*>(vn);
  if constexpr (sizeof(T) == 2) {
    if (paired<T>({u, v, un, vn}, nz)) {
      const dim3 grid((nz / 2 + 31) / 32, (ny + 7) / 8, nx);
      gray_scott_pairs<T><<<grid, block, 0, s>>>(pu, pv, pun, pvn, nx, ny,
                                                 nz, c);
      return static_cast<int>(cudaGetLastError());
    }
  }
  const dim3 grid((nz + 31) / 32, (ny + 7) / 8, nx);
  gray_scott_step_kernel<T><<<grid, block, 0, s>>>(pu, pv, pun, pvn, nx, ny,
                                                   nz, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One step: u, v (nx, ny, nz), C order, of the entry's element type ->
// un, vn (fresh buffers of it). nx and ny <= 65535 (grid z and y). Fk is
// F + k summed in double on the host. Returns cudaGetLastError() after
// the launch.
#define GRAY_SCOTT_ENTRY(NAME, T)                                            \
  int NAME(const void* u, const void* v, void* un, void* vn, int nx, int ny, \
           int nz, float Du, float Dv, float F, float Fk, float dt,          \
           float inv_h2, void* stream) {                                     \
    return launch<T>(u, v, un, vn, nx, ny, nz,                               \
                     Coefs{Du, Dv, F, Fk, dt, inv_h2}, stream);              \
  }

GRAY_SCOTT_ENTRY(gray_scott_step_f32, float)
GRAY_SCOTT_ENTRY(gray_scott_step_bf16, __nv_bfloat16)
GRAY_SCOTT_ENTRY(gray_scott_step_f16, __half)

}  // extern "C"
