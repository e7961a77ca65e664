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
// 16-bit types, the plain version loads each operation's operands to fp32,
// computes in fp32 (a Python number stays fp32) and rounds the result to
// the element type. The one-node form does just that (Elem<T>::r).
//
// fp32 (gray_scott_step_kernel<float>): one thread per node, 32 x 8
// thread blocks along (z, y), one grid row of blocks per x plane; the
// seven u and seven v loads go through the read-only path (__ldg), and
// neighbour reuse comes from L1 and L2. Bound by memory: at the paper's
// 256^3 nodes one step reads u and v and writes u' and v', 4 x 256^3 x
// 4 B = 268 MB, 0.080 ms at 3.35 TB/s; its ~31 flops a node are 5.2e8
// flops, 0.008 ms at 67 TFLOP/s fp32. Measured on an H100 80GB HBM3
// (700 W): 0.117 ms, 1.46x the bound; 5000 steps take 0.59 s.
//
// The 16-bit forms move half the bytes (0.040 ms at 256^3). Rounding 31
// fp32 results a node to the type would bound them by conversions, which
// the card issues at a fraction of the fp32 rate. In 23 of the 31
// operations both operands are already of the element type: the -6 c and
// the six adds of each Laplacian, u v and (u v) v, 1 - u, the two sums
// inside du and dv, and the two final adds. For +, - and x of two p-bit
// values, one rounding of the exact result equals the fp32 result rounded
// again (Figueroa 1995: fp32's 24 bits >= 2p + 2), so these take the
// card's packed 16-bit instructions (add/sub/mul.rn.bf16x2, .f16x2;
// Word<T>): one instruction for two nodes and no conversion. The 8
// products by an fp32 constant (Du, Dv, F, F + k, dt, inv_h2 twice) stay
// fp32 with one packed conversion (scale). Outputs stay bit-equal to the
// plain version on the card; a pair's conversions (SASS F2FP) are 8.
//
// The layout (gray_scott_march; nz % 4 == 0, 8-byte aligned fields, under
// 2^31 nodes): a block of 32 x 4 threads owns a (4, 128) tile of (y, z)
// and marches along a run of 4 x planes, each thread on four adjacent z
// nodes as one 8-byte word a field. A thread keeps planes x - 1, x and
// x + 1 of its own nodes in registers, so a word is read from memory as
// a centre; plane x's words go to shared memory for the rows above and
// below, the z neighbours across words come by shuffle, and only the
// tile's edge threads read beyond it (y halo rows, one element at each z
// end). Other shapes take two nodes a thread (gray_scott_pairs; nz even,
// 4-byte aligned; the same packed arithmetic) or one
// (gray_scott_step_kernel), with the same bits.
//
// What bounds the march: it reads each byte from memory once, at nearly
// the rate two plain copy_ calls of the same fields reach, then
// instruction issue (offsets are 32-bit and the centre loads
// unconditional for that reason). Measured on an H100 80GB HBM3 (700 W)
// at 256^3 with tools/b2_ab.py, in turns with the two-node form that
// rounds every op in fp32 (PERF.md's B2 rows, the final tree's run):
// bf16 0.0567 ms against 0.1096, fp16 0.0564 against 0.0982; 1.41x the
// bytes bound, 1.10x the two copies.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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

// Two adjacent 16-bit elements as one 32-bit word, the lower-indexed one
// in the low half, and the arithmetic on both at once. add, sub and mul
// are the card's packed 16-bit instructions with an explicit .rn, which
// ptxas never contracts into an fma: each rounds the exact result once.
// For +, - and x of two p-bit values, that equals rounding to fp32 first
// (p' = 24 >= 2p + 2, for bf16 p = 8, for fp16 p = 11) and then to the
// type, as the plain version does. scale multiplies by an fp32 constant
// that the plain version takes unrounded: in fp32 on each half, then one
// packed conversion.
template <class T>
struct Word;

#define GRAY_SCOTT_PACKED_OP(NAME, PTX)                                    \
  __device__ __forceinline__ static uint32_t NAME(uint32_t a, uint32_t b) { \
    uint32_t d;                                                            \
    asm(PTX " %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));                    \
    return d;                                                              \
  }

template <>
struct Word<__nv_bfloat16> {
  using V = __nv_bfloat162;
  static constexpr uint32_t kMinus6 = 0xC0C0C0C0u;  // bf16 -6.0, twice
  static constexpr uint32_t kOne = 0x3F803F80u;     // bf16 1.0, twice
  GRAY_SCOTT_PACKED_OP(add, "add.rn.bf16x2")
  GRAY_SCOTT_PACKED_OP(sub, "sub.rn.bf16x2")
  GRAY_SCOTT_PACKED_OP(mul, "mul.rn.bf16x2")
  __device__ __forceinline__ static float2 unpack(uint32_t w) {
    V h;
    memcpy(&h, &w, 4);
    return __bfloat1622float2(h);
  }
  __device__ __forceinline__ static uint32_t pack(float2 x) {
    const V h = __float22bfloat162_rn(x);
    uint32_t w;
    memcpy(&w, &h, 4);
    return w;
  }
};

template <>
struct Word<__half> {
  using V = __half2;
  static constexpr uint32_t kMinus6 = 0xC600C600u;  // fp16 -6.0, twice
  static constexpr uint32_t kOne = 0x3C003C00u;     // fp16 1.0, twice
  GRAY_SCOTT_PACKED_OP(add, "add.rn.f16x2")
  GRAY_SCOTT_PACKED_OP(sub, "sub.rn.f16x2")
  GRAY_SCOTT_PACKED_OP(mul, "mul.rn.f16x2")
  __device__ __forceinline__ static float2 unpack(uint32_t w) {
    V h;
    memcpy(&h, &w, 4);
    return __half22float2(h);
  }
  __device__ __forceinline__ static uint32_t pack(float2 x) {
    const V h = __float22half2_rn(x);
    uint32_t w;
    memcpy(&w, &h, 4);
    return w;
  }
};

#undef GRAY_SCOTT_PACKED_OP

template <class T>
__device__ __forceinline__ uint32_t scale(float s, uint32_t w) {
  const float2 x = Word<T>::unpack(w);
  return Word<T>::pack(make_float2(__fmul_rn(s, x.x), __fmul_rn(s, x.y)));
}

// The words of (z - 1) and (z + 1) neighbours of two nodes: `lo`'s
// high half and `hi`'s low half, as one word.
__device__ __forceinline__ uint32_t straddle(uint32_t lo, uint32_t hi) {
  return (lo >> 16) | (hi << 16);
}

__device__ __forceinline__ uint32_t ld_word(const void* p) {
  return __ldg(static_cast<const unsigned int*>(p));
}
__device__ __forceinline__ uint32_t ld_half(const void* p) {
  return __ldg(static_cast<const unsigned short*>(p));
}

// The 7-point Laplacian of two nodes in the plain version's order: -6 c,
// then + x - 1, x + 1, y - 1, y + 1, z - 1, z + 1, then x inv_h2.
template <class T>
__device__ __forceinline__ uint32_t lap_word(uint32_t c, uint32_t xm,
                                             uint32_t xp, uint32_t ym,
                                             uint32_t yp, uint32_t zm,
                                             uint32_t zp, float inv_h2) {
  using W = Word<T>;
  uint32_t o = W::mul(W::kMinus6, c);
  o = W::add(o, xm);
  o = W::add(o, xp);
  o = W::add(o, ym);
  o = W::add(o, yp);
  o = W::add(o, zm);
  o = W::add(o, zp);
  return scale<T>(inv_h2, o);
}

// The reaction and the Euler update of two nodes, op for op the plain
// version's: u + dt (Du lap(u) - uvv + F (1 - u)) and
// v + dt (Dv lap(v) + uvv - (F + k) v), uvv = (u v) v.
template <class T>
__device__ __forceinline__ void react_word(uint32_t uc, uint32_t vc,
                                           uint32_t lu, uint32_t lv,
                                           const Coefs& c, uint32_t& un,
                                           uint32_t& vn) {
  using W = Word<T>;
  const uint32_t uvv = W::mul(W::mul(uc, vc), vc);
  const uint32_t du = W::add(W::sub(scale<T>(c.Du, lu), uvv),
                             scale<T>(c.F, W::sub(W::kOne, uc)));
  const uint32_t dv = W::sub(W::add(scale<T>(c.Dv, lv), uvv),
                             scale<T>(c.Fk, vc));
  un = W::add(uc, scale<T>(c.dt, du));
  vn = W::add(vc, scale<T>(c.dt, dv));
}

// Two adjacent nodes (k, k + 1), k even, per thread, 32 x 8 blocks along
// (z, y), one grid row of blocks per x plane: nz even, pointers 4-byte
// aligned, 16-bit T. The fallback of gray_scott_march.
template <class T>
__global__ void gray_scott_pairs(const T* __restrict__ u,
                                 const T* __restrict__ v, T* __restrict__ un,
                                 T* __restrict__ vn, int nx, int ny, int nz,
                                 Coefs c) {
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

  const uint32_t uc = ld_word(u + at), vc = ld_word(v + at);
  // node k's z - 1 and node k + 1's z + 1 are loaded; the other two are
  // the pair's own centres
  const uint32_t lu = lap_word<T>(
      uc, ld_word(u + xm), ld_word(u + xp), ld_word(u + ym), ld_word(u + yp),
      ld_half(u + zm) | (uc << 16), (uc >> 16) | (ld_half(u + zp) << 16),
      c.inv_h2);
  const uint32_t lv = lap_word<T>(
      vc, ld_word(v + xm), ld_word(v + xp), ld_word(v + ym), ld_word(v + yp),
      ld_half(v + zm) | (vc << 16), (vc >> 16) | (ld_half(v + zp) << 16),
      c.inv_h2);
  uint32_t uo, vo;
  react_word<T>(uc, vc, lu, lv, c, uo, vo);
  *reinterpret_cast<uint32_t*>(un + at) = uo;
  *reinterpret_cast<uint32_t*>(vn + at) = vo;
}

// Four adjacent nodes of both fields: one 8-byte word each.
struct Quad {
  uint2 u, v;
};

// What a thread at the tile's edge reads beyond it: the y - 1 (top row)
// and y + 1 (last row) words, and the z - 1 (lane 0, low half) and
// z + 1 (last lane, high half) elements.
struct Edge {
  uint2 um, up, vm, vp;
  uint32_t uz, vz;
};

__device__ __forceinline__ uint2 ld_quad(const void* p) {
  return __ldg(static_cast<const uint2*>(p));
}

// The march's tile rows and run of x planes a block.
constexpr int kMarchRows = 4;
constexpr int kMarchRun = 4;

// A block of 32 x kMarchRows threads owns a (kMarchRows, 128) tile of
// (y, z) and marches along a run of kMarchRun x planes; a thread takes
// four adjacent z nodes as one 8-byte word per field. Planes x - 1, x and
// x + 1 of a thread's own nodes stay in registers (x + 2 loading while x
// is computed); plane x's words go to shared memory (two buffers, one
// barrier a plane), where the rows above and below read their y
// neighbours; the z neighbours across words come from the next lanes by
// shuffle. Only the tile's edge threads read beyond it. The loop is bound
// by instruction issue, so offsets are 32-bit (fields under 2^31 nodes)
// and the threads past the field's end load their last row's and lane's
// words instead of branching. nz % 4 == 0, pointers 8-byte aligned,
// 16-bit T.
template <class T>
__global__ void __launch_bounds__(32 * kMarchRows)
    gray_scott_march(const T* __restrict__ u, const T* __restrict__ v,
                     T* __restrict__ un, T* __restrict__ vn, int nx, int ny,
                     int nz, Coefs c) {
  __shared__ uint2 tile[2][2][kMarchRows][32];  // [buffer][field][row][lane]
  const int lane = threadIdx.x, ty = threadIdx.y;
  const int w0 = blockIdx.x * 32, j0 = blockIdx.y * kMarchRows;
  const int last_lane = min(32, nz / 4 - w0) - 1;
  const int last_row = min(kMarchRows, ny - j0) - 1;
  const bool active = lane <= last_lane && ty <= last_row;
  const bool top = ty == 0, bottom = ty == last_row;
  const bool left = lane == 0, right = lane == last_lane;
  const int j = j0 + min(ty, last_row), k = 4 * (w0 + min(lane, last_lane));
  const int plane = ny * nz;
  const int at = j * nz + k;
  const int at_ym = (j == 0 ? ny - 1 : j - 1) * nz + k;
  const int at_yp = (j + 1 == ny ? 0 : j + 1) * nz + k;
  const int at_zm = j * nz + (k == 0 ? nz : k) - 1;
  const int at_zp = j * nz + (k + 4 == nz ? 0 : k + 4);

  auto centre = [&](int x) {
    const int o = x * plane + at;
    return Quad{ld_quad(u + o), ld_quad(v + o)};
  };
  auto edge = [&](int x, Edge& e) {
    const int o = x * plane;
    if (top) {
      e.um = ld_quad(u + (o + at_ym));
      e.vm = ld_quad(v + (o + at_ym));
    }
    if (bottom) {
      e.up = ld_quad(u + (o + at_yp));
      e.vp = ld_quad(v + (o + at_yp));
    }
    if (left) {
      e.uz = ld_half(u + (o + at_zm));
      e.vz = ld_half(v + (o + at_zm));
    }
    if (right) {
      e.uz = (left ? e.uz : 0u) | ld_half(u + (o + at_zp)) << 16;
      e.vz = (left ? e.vz : 0u) | ld_half(v + (o + at_zp)) << 16;
    }
  };

  const int xa = blockIdx.z * kMarchRun, xb = min(xa + kMarchRun, nx);
  Quad qm = centre(xa == 0 ? nx - 1 : xa - 1), qc = centre(xa),
       qp = centre(xa + 1 == nx ? 0 : xa + 1), qn = qp;
  Edge e, en;
  edge(xa, e);
  for (int x = xa; x < xb; ++x) {
    if (x + 1 < xb) {
      qn = centre(x + 2 == nx ? 0 : x + 2);
      edge(x + 1, en);
    }
    uint2(*buf)[kMarchRows][32] = tile[(x - xa) & 1];
    buf[0][ty][lane] = qc.u;
    buf[1][ty][lane] = qc.v;
    __syncthreads();
    // the left lane's last element and the right lane's first
    uint32_t uzm = __shfl_up_sync(0xFFFFFFFFu, qc.u.y, 1) >> 16;
    uint32_t vzm = __shfl_up_sync(0xFFFFFFFFu, qc.v.y, 1) >> 16;
    uint32_t uzp = __shfl_down_sync(0xFFFFFFFFu, qc.u.x, 1) & 0xFFFFu;
    uint32_t vzp = __shfl_down_sync(0xFFFFFFFFu, qc.v.x, 1) & 0xFFFFu;
    if (left) {
      uzm = e.uz & 0xFFFFu;
      vzm = e.vz & 0xFFFFu;
    }
    if (right) {
      uzp = e.uz >> 16;
      vzp = e.vz >> 16;
    }
    if (active) {
      const uint2 uym = top ? e.um : buf[0][ty - 1][lane];
      const uint2 vym = top ? e.vm : buf[1][ty - 1][lane];
      const uint2 uyp = bottom ? e.up : buf[0][ty + 1][lane];
      const uint2 vyp = bottom ? e.vp : buf[1][ty + 1][lane];
      const uint32_t umid = straddle(qc.u.x, qc.u.y);
      const uint32_t vmid = straddle(qc.v.x, qc.v.y);
      const uint32_t lu0 = lap_word<T>(qc.u.x, qm.u.x, qp.u.x, uym.x, uyp.x,
                                       uzm | (qc.u.x << 16), umid, c.inv_h2);
      const uint32_t lu1 = lap_word<T>(qc.u.y, qm.u.y, qp.u.y, uym.y, uyp.y,
                                       umid, (qc.u.y >> 16) | (uzp << 16),
                                       c.inv_h2);
      const uint32_t lv0 = lap_word<T>(qc.v.x, qm.v.x, qp.v.x, vym.x, vyp.x,
                                       vzm | (qc.v.x << 16), vmid, c.inv_h2);
      const uint32_t lv1 = lap_word<T>(qc.v.y, qm.v.y, qp.v.y, vym.y, vyp.y,
                                       vmid, (qc.v.y >> 16) | (vzp << 16),
                                       c.inv_h2);
      uint2 uo, vo;
      react_word<T>(qc.u.x, qc.v.x, lu0, lv0, c, uo.x, vo.x);
      react_word<T>(qc.u.y, qc.v.y, lu1, lv1, c, uo.y, vo.y);
      const int o = x * plane + at;
      *reinterpret_cast<uint2*>(un + o) = uo;
      *reinterpret_cast<uint2*>(vn + o) = vo;
    }
    qm = qc;
    qc = qp;
    qp = qn;
    e = en;
  }
}

template <class T>
bool aligned(const void* const (&p)[4], int nz, int n) {
  if (sizeof(T) != 2 || nz % n) return false;
  for (const void* q : p)
    if (reinterpret_cast<uintptr_t>(q) % (2 * n)) return false;
  return true;
}

// Whether the march takes the fields: nz % 4 == 0, 8-byte aligned, fewer
// than 2^31 nodes (32-bit offsets).
template <class T>
bool marches(const void* const (&p)[4], int nx, int ny, int nz) {
  return static_cast<long long>(nx) * ny * nz < (1LL << 31)
         && aligned<T>(p, nz, 4);
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
    if (marches<T>({u, v, un, vn}, nx, ny, nz)) {
      const dim3 grid((nz / 4 + 31) / 32, (ny + kMarchRows - 1) / kMarchRows,
                      (nx + kMarchRun - 1) / kMarchRun);
      gray_scott_march<T><<<grid, dim3(32, kMarchRows), 0, s>>>(
          pu, pv, pun, pvn, nx, ny, nz, c);
      return static_cast<int>(cudaGetLastError());
    }
    if (aligned<T>({u, v, un, vn}, nz, 2)) {
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
