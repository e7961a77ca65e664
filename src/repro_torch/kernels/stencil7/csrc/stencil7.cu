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

#include <cuda_runtime.h>

namespace {

struct Coefs {
  float Du, Dv, F, Fk, dt, inv_h2;
};

__device__ __forceinline__ float lap7(const float* __restrict__ f, float c,
                                      size_t xm, size_t xp, size_t ym,
                                      size_t yp, size_t zm, size_t zp,
                                      float inv_h2) {
  float o = __fmul_rn(-6.0f, c);
  o = __fadd_rn(o, __ldg(f + xm));
  o = __fadd_rn(o, __ldg(f + xp));
  o = __fadd_rn(o, __ldg(f + ym));
  o = __fadd_rn(o, __ldg(f + yp));
  o = __fadd_rn(o, __ldg(f + zm));
  o = __fadd_rn(o, __ldg(f + zp));
  return __fmul_rn(o, inv_h2);
}

__global__ void gray_scott_step_kernel(const float* __restrict__ u,
                                       const float* __restrict__ v,
                                       float* __restrict__ un,
                                       float* __restrict__ vn, int nx,
                                       int ny, int nz, Coefs c) {
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

  const float uc = __ldg(u + at);
  const float vc = __ldg(v + at);
  const float lu = lap7(u, uc, xm, xp, ym, yp, zm, zp, c.inv_h2);
  const float lv = lap7(v, vc, xm, xp, ym, yp, zm, zp, c.inv_h2);
  const float uvv = __fmul_rn(__fmul_rn(uc, vc), vc);
  const float du = __fadd_rn(__fsub_rn(__fmul_rn(c.Du, lu), uvv),
                             __fmul_rn(c.F, __fsub_rn(1.0f, uc)));
  const float dv = __fsub_rn(__fadd_rn(__fmul_rn(c.Dv, lv), uvv),
                             __fmul_rn(c.Fk, vc));
  un[at] = __fadd_rn(uc, __fmul_rn(c.dt, du));
  vn[at] = __fadd_rn(vc, __fmul_rn(c.dt, dv));
}

}  // namespace

extern "C" {

// One step: u, v (nx, ny, nz) float32, C order -> un, vn (fresh buffers).
// nx and ny <= 65535 (grid z and y). Fk is F + k summed in double on the
// host. Returns cudaGetLastError() after the launch.
int gray_scott_step_f32(const void* u, const void* v, void* un, void* vn,
                        int nx, int ny, int nz, float Du, float Dv, float F,
                        float Fk, float dt, float inv_h2, void* stream) {
  if (nx < 1 || ny < 1 || nz < 1 || nx > 65535 || ny > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(32, 8);
  const dim3 grid((nz + 31) / 32, (ny + 7) / 8, nx);
  gray_scott_step_kernel<<<grid, block, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(v),
      static_cast<float*>(un), static_cast<float*>(vn), nx, ny, nz,
      Coefs{Du, Dv, F, Fk, dt, inv_h2});
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
