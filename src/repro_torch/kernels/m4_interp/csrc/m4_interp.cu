// M'4 particle-mesh interpolation for Hopper (sm_90a): P2M as an owner
// gather and the fused M2P gather, over particles pre-bucketed into
// interpolation cells of cb mesh nodes per axis.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/m4_interp/
// m4_interp.py: `_p2m_kernel` (launched by `p2m_cells`) and `_m2p_kernel`
// (launched by `m2p_cells`). Both are periodic-only, in two precisions:
// fp32 (entries m4_p2m_f32, m4_m2p_f32) and bf16x (m4_p2m_bf16x,
// m4_m2p_bf16x: the Pallas kernels' `precision="bf16x"`, `:86` and
// `:170`). Under bf16x each weight and each value operand is rounded to
// bf16 before its product, which is then exact in fp32; the sums stay
// fp32, as the plain versions' bf16-rounded fp32 `bmm` computes them.
// The operands stay fp32 in memory and are rounded where they are used,
// so the bytes bound is fp32's; measured on an H100 80GB HBM3 (700 W) at
// the VIC size below, P2M 158 ms (1.04x fp32) and M2P 65 ms (0.97x).
//
//   P2M  field[node] = sum over the 3^DIM neighbour buckets b, slots s:
//          mask_s * prod_d M'4((node_d - x_sd - shift_bd) / h_d) * val_s
//        shift_bd = -L_d if the unwrapped neighbour cell is < 0, +L_d if it
//        is >= grid_d, else 0 (the periodic image of a wrapped bucket).
//   M2P  out[slot] = mask * sum over the 3^DIM neighbour field blocks, nodes:
//          prod_d M'4((x_d - node_d) / h_d) * F[node]
//        node_d = ((cell_d + off_d) * cb + i) * h_d + lo_d from the
//        UNWRAPPED block index; F is read from the wrapped block.
//
// Each node (P2M) and each slot (M2P) has one owner thread, so there are
// no atomics and the summation order is fixed: the offsets are walked in
// itertools.product((-1, 0, 1), repeat=DIM) order, every one of them every
// time. On a grid with fewer than 3 cells along an axis two offsets fetch
// the same bucket, each with its own image; deduplicating would drop one.
// Empty slots hold a real particle's position (the bucketing clamps the
// sentinel to a real index), so slots are weighted by the mask and the
// position is never tested.
//
// Design (a simple, correct first version):
//   * P2M: one block per interpolation cell, one thread per node of its
//     cb^DIM patch (64 for cb = 4, DIM = 3), C fp32 accumulators in
//     registers. Per offset the block stages the neighbour bucket's values
//     (cc x C) and its per-axis weights (DIM x cb x cc, mask folded into
//     axis 0; the weights of a slot along one axis depend only on the
//     node's index along that axis) in shared memory; each thread then
//     walks the cc slots and forms the weight as a product of DIM staged
//     factors.
//   * M2P: one block per bucket, one thread per slot (cc rounded up to a
//     warp multiple). Per offset the block stages the wrapped neighbour
//     field block (cb^DIM x C) in shared memory; each thread computes its
//     DIM x cb per-axis weights and sums over the nodes with a nonzero
//     product, skipping an axis index as soon as its factor is zero.
//   * node - x - shift and the divisions by h are explicitly rounded fp32
//     (__fmul_rn/__fadd_rn/__fsub_rn, IEEE division), in the order of the
//     plain PyTorch versions, so positions round the same way on both
//     paths. h and L come in as float32 of the same doubles (L/n) that the
//     plain versions use.
//
// What bounds it on the H100: memory. At the one-card VIC size (800 x 200
// x 200 nodes, cb = 4, 500,000 cells x 128 slots) one P2M pass reads
// cell_x (768 MB), cell_val (768 MB, C = 3) and cell_mask (64 MB) and
// writes the field (384 MB): about 0.59 ms at 3.35 TB/s. One M2P pass
// (C = 6) reads the field (768 MB), cell_x and the mask, and writes
// 1.54 GB of per-slot values: about 0.93 ms. The in-support arithmetic is
// 64 particle-node pairs per particle, about 2e9 pairs, under 0.3 ms at
// 67 TFLOP/s fp32. This first version does not reach those bounds: each
// P2M thread walks all 27 x cc staged slots although only particles within
// 2h of its node contribute, and each M2P thread evaluates its weights
// per offset; both re-read every bucket or field block 27 times through
// L2. Its measured times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// Round to the nearest bf16 (ties to even) and back: what PyTorch's
// `.to(torch.bfloat16).to(torch.float32)` gives.
template <bool BF16>
__device__ __forceinline__ float operand(float x) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

constexpr int MAX_CB = 8;

struct Geom {
  int grid[3];   // interpolation cells per axis
  int n[3];      // mesh nodes per axis (cb * grid)
  int cb;        // nodes per cell per axis
  float lo[3];
  float h[3];
  float L[3];
};

// M'4 weight, each operation rounded as the plain version's
// (core/interp.py `m4_prime`) with no FMA contraction, so the two paths
// form equal fp32 weights and, under bf16x, round them to equal bf16 ones.
__device__ __forceinline__ float m4(float s) {
  s = fabsf(s);
  if (s < 1.0f) {
    const float s2 = __fmul_rn(s, s);
    return __fadd_rn(__fsub_rn(1.0f, __fmul_rn(2.5f, s2)),
                     __fmul_rn(1.5f, __fmul_rn(s2, s)));
  }
  if (s < 2.0f) {
    const float t = __fsub_rn(2.0f, s);
    return __fmul_rn(__fmul_rn(0.5f, __fmul_rn(t, t)), __fsub_rn(1.0f, s));
  }
  return 0.0f;
}

template <int DIM>
struct Pow3 {
  static constexpr int value = 3 * Pow3<DIM - 1>::value;
};
template <>
struct Pow3<0> {
  static constexpr int value = 1;
};

// Offset o of itertools.product((-1, 0, 1), repeat=DIM) along axis d.
template <int DIM>
__device__ __forceinline__ int offset_of(int o, int d) {
  int div = 1;
  for (int e = DIM - 1; e > d; --e) div *= 3;
  return (o / div) % 3 - 1;
}

__device__ __forceinline__ int wrap(int c, int g) {
  const int r = c % g;
  return r < 0 ? r + g : r;
}

template <int DIM, int C, bool BF16>
__global__ void m4_p2m_kernel(const float* __restrict__ cell_x,   // (cells, cc, DIM)
                              const float* __restrict__ cell_val, // (cells, cc, C)
                              const bool* __restrict__ cell_mask, // (cells, cc)
                              float* __restrict__ out,            // shape + (C,)
                              Geom g, int cc) {
  extern __shared__ float smem[];
  const int cb = g.cb;
  const int ccp = cc + 1;              // padded weight row: no bank clash
  float* s_val = smem;                 // cc * C
  float* s_w = smem + cc * C;          // DIM * cb * ccp

  int home[DIM];
  int node[DIM];
  {
    int rem = blockIdx.x;
    for (int d = DIM - 1; d >= 0; --d) {
      home[d] = rem % g.grid[d];
      rem /= g.grid[d];
    }
    rem = threadIdx.x;
    for (int d = DIM - 1; d >= 0; --d) {
      node[d] = rem % cb;
      rem /= cb;
    }
  }

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;

  for (int o = 0; o < Pow3<DIM>::value; ++o) {
    int nb = 0;
    float shift[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      const int cell = home[d] + offset_of<DIM>(o, d);
      shift[d] = cell < 0 ? -g.L[d] : (cell >= g.grid[d] ? g.L[d] : 0.0f);
      nb = nb * g.grid[d] + wrap(cell, g.grid[d]);
    }
    const size_t base = static_cast<size_t>(nb) * cc;
    __syncthreads();                   // the previous offset's readers
    for (int i = threadIdx.x; i < cc * C; i += blockDim.x)
      s_val[i] = operand<BF16>(cell_val[base * C + i]);
    for (int i = threadIdx.x; i < DIM * cb * cc; i += blockDim.x) {
      const int s = i % cc;
      const int k = (i / cc) % cb;
      const int d = i / (cc * cb);
      const float nx = __fadd_rn(
          __fmul_rn(static_cast<float>(home[d] * cb + k), g.h[d]), g.lo[d]);
      const float xs = cell_x[(base + s) * DIM + d];
      float w = m4(__fsub_rn(__fsub_rn(nx, xs), shift[d]) / g.h[d]);
      if (d == 0 && !cell_mask[base + s]) w = 0.0f;
      s_w[(d * cb + k) * ccp + s] = w;
    }
    __syncthreads();
    for (int s = 0; s < cc; ++s) {
      float w = s_w[node[0] * ccp + s];
#pragma unroll
      for (int d = 1; d < DIM; ++d) w *= s_w[(d * cb + node[d]) * ccp + s];
      if (w == 0.0f) continue;
      w = operand<BF16>(w);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] += w * s_val[s * C + c];
    }
  }

  size_t flat = 0;
#pragma unroll
  for (int d = 0; d < DIM; ++d) flat = flat * g.n[d] + home[d] * cb + node[d];
#pragma unroll
  for (int c = 0; c < C; ++c) out[flat * C + c] = acc[c];
}

template <int DIM, int C, bool BF16>
__global__ void m4_m2p_kernel(const float* __restrict__ field,     // shape + (C,)
                              const float* __restrict__ cell_x,    // (cells, cc, DIM)
                              const bool* __restrict__ cell_mask,  // (cells, cc)
                              float* __restrict__ out,             // (cells, cc, C)
                              Geom g, int cc) {
  extern __shared__ float s_f[];       // cb^DIM * C
  const int cb = g.cb;
  int npatch = 1;
  for (int d = 0; d < DIM; ++d) npatch *= cb;

  int home[DIM];
  {
    int rem = blockIdx.x;
    for (int d = DIM - 1; d >= 0; --d) {
      home[d] = rem % g.grid[d];
      rem /= g.grid[d];
    }
  }
  const int t = threadIdx.x;
  const size_t slot = static_cast<size_t>(blockIdx.x) * cc + t;
  const bool mine = t < cc && cell_mask[slot];
  float x[DIM];
#pragma unroll
  for (int d = 0; d < DIM; ++d) x[d] = mine ? cell_x[slot * DIM + d] : 0.0f;

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;

  for (int o = 0; o < Pow3<DIM>::value; ++o) {
    int cell[DIM];
    int blk[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      cell[d] = home[d] + offset_of<DIM>(o, d);
      blk[d] = wrap(cell[d], g.grid[d]);
    }
    __syncthreads();                   // the previous offset's readers
    for (int i = t; i < npatch * C; i += blockDim.x) {
      const int c = i % C;
      int rem = i / C;
      int k[DIM];
      for (int d = DIM - 1; d >= 0; --d) {
        k[d] = rem % cb;
        rem /= cb;
      }
      size_t flat = 0;
      for (int d = 0; d < DIM; ++d)
        flat = flat * g.n[d] + blk[d] * cb + k[d];
      s_f[i] = operand<BF16>(field[flat * C + c]);
    }
    __syncthreads();
    if (!mine) continue;
    float w[DIM][MAX_CB];
#pragma unroll
    for (int d = 0; d < DIM; ++d)
      for (int k = 0; k < cb; ++k) {
        const float nx = __fadd_rn(
            __fmul_rn(static_cast<float>(cell[d] * cb + k), g.h[d]), g.lo[d]);
        w[d][k] = m4(__fsub_rn(x[d], nx) / g.h[d]);
      }
    if (DIM == 3) {
      for (int i0 = 0; i0 < cb; ++i0) {
        const float w0 = w[0][i0];
        if (w0 == 0.0f) continue;
        for (int i1 = 0; i1 < cb; ++i1) {
          const float w01 = w0 * w[1][i1];
          if (w01 == 0.0f) continue;
          for (int i2 = 0; i2 < cb; ++i2) {
            float ww = w01 * w[DIM - 1][i2];
            if (ww == 0.0f) continue;
            ww = operand<BF16>(ww);
            const float* f = s_f + ((i0 * cb + i1) * cb + i2) * C;
#pragma unroll
            for (int c = 0; c < C; ++c) acc[c] += ww * f[c];
          }
        }
      }
    } else {
      for (int i0 = 0; i0 < cb; ++i0) {
        const float w0 = w[0][i0];
        if (w0 == 0.0f) continue;
        for (int i1 = 0; i1 < cb; ++i1) {
          float ww = w0 * w[DIM - 1][i1];
          if (ww == 0.0f) continue;
          ww = operand<BF16>(ww);
          const float* f = s_f + (i0 * cb + i1) * C;
#pragma unroll
          for (int c = 0; c < C; ++c) acc[c] += ww * f[c];
        }
      }
    }
  }
  if (t < cc) {
#pragma unroll
    for (int c = 0; c < C; ++c) out[slot * C + c] = mine ? acc[c] : 0.0f;
  }
}

template <class Kernel>
int set_smem(Kernel kern, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <int DIM, int C, bool BF16>
int launch_p2m(const void* cell_x, const void* cell_val,
               const void* cell_mask, void* out, const Geom& g, int cc,
               int n_cells, cudaStream_t stream) {
  int threads = 1;
  for (int d = 0; d < DIM; ++d) threads *= g.cb;
  const size_t smem =
      (static_cast<size_t>(cc) * C +
       static_cast<size_t>(DIM) * g.cb * (cc + 1)) * sizeof(float);
  auto kern = m4_p2m_kernel<DIM, C, BF16>;
  const int e = set_smem(kern, smem);
  if (e != 0) return e;
  if (n_cells > 0)
    kern<<<n_cells, threads, smem, stream>>>(
        static_cast<const float*>(cell_x), static_cast<const float*>(cell_val),
        static_cast<const bool*>(cell_mask), static_cast<float*>(out), g, cc);
  return static_cast<int>(cudaGetLastError());
}

template <int DIM, int C, bool BF16>
int launch_m2p(const void* field, const void* cell_x, const void* cell_mask,
               void* out, const Geom& g, int cc, int n_cells,
               cudaStream_t stream) {
  int npatch = 1;
  for (int d = 0; d < DIM; ++d) npatch *= g.cb;
  const int threads = ((cc + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(npatch) * C * sizeof(float);
  auto kern = m4_m2p_kernel<DIM, C, BF16>;
  const int e = set_smem(kern, smem);
  if (e != 0) return e;
  if (n_cells > 0)
    kern<<<n_cells, threads, smem, stream>>>(
        static_cast<const float*>(field), static_cast<const float*>(cell_x),
        static_cast<const bool*>(cell_mask), static_cast<float*>(out), g, cc);
  return static_cast<int>(cudaGetLastError());
}

Geom make_geom(int dim, int g0, int g1, int g2, int cb, float lo0, float lo1,
               float lo2, float h0, float h1, float h2, float L0, float L1,
               float L2) {
  Geom g;
  const int gs[3] = {g0, g1, g2};
  const float los[3] = {lo0, lo1, lo2};
  const float hs[3] = {h0, h1, h2};
  const float Ls[3] = {L0, L1, L2};
  for (int d = 0; d < 3; ++d) {
    g.grid[d] = d < dim ? gs[d] : 1;
    g.n[d] = g.grid[d] * cb;
    g.lo[d] = los[d];
    g.h[d] = hs[d];
    g.L[d] = Ls[d];
  }
  g.cb = cb;
  return g;
}

constexpr int kBadArgs = 1;  // cudaErrorInvalidValue

}  // namespace

#define M4_DISPATCH(FN, B, DIM_, C_, ...)                      \
  switch ((DIM_) * 16 + (C_)) {                                \
    case 2 * 16 + 1: return FN<2, 1, B>(__VA_ARGS__);          \
    case 2 * 16 + 2: return FN<2, 2, B>(__VA_ARGS__);          \
    case 2 * 16 + 3: return FN<2, 3, B>(__VA_ARGS__);          \
    case 2 * 16 + 4: return FN<2, 4, B>(__VA_ARGS__);          \
    case 2 * 16 + 5: return FN<2, 5, B>(__VA_ARGS__);          \
    case 2 * 16 + 6: return FN<2, 6, B>(__VA_ARGS__);          \
    case 2 * 16 + 7: return FN<2, 7, B>(__VA_ARGS__);          \
    case 2 * 16 + 8: return FN<2, 8, B>(__VA_ARGS__);          \
    case 3 * 16 + 1: return FN<3, 1, B>(__VA_ARGS__);          \
    case 3 * 16 + 2: return FN<3, 2, B>(__VA_ARGS__);          \
    case 3 * 16 + 3: return FN<3, 3, B>(__VA_ARGS__);          \
    case 3 * 16 + 4: return FN<3, 4, B>(__VA_ARGS__);          \
    case 3 * 16 + 5: return FN<3, 5, B>(__VA_ARGS__);          \
    case 3 * 16 + 6: return FN<3, 6, B>(__VA_ARGS__);          \
    case 3 * 16 + 7: return FN<3, 7, B>(__VA_ARGS__);          \
    case 3 * 16 + 8: return FN<3, 8, B>(__VA_ARGS__);          \
    default: return kBadArgs;                                  \
  }

// The four entries take the same arguments. The geometry: dim 2 or 3,
// C 1..8 channels, cells per axis g0..g2, cb 2..8 nodes per cell per axis,
// and lo, h, L per axis (float32 of the plain versions' doubles); cc the
// bucket capacity; the stream. Each returns cudaGetLastError() after the
// launch.
#define M4_ARGS                                                        \
  int dim, int n_ch, int g0, int g1, int g2, int cb, float lo0, float lo1, \
      float lo2, float h0, float h1, float h2, float L0, float L1,        \
      float L2, int cc, void *stream

namespace {

template <bool BF16>
int p2m_entry(const void* cell_x, const void* cell_val, const void* cell_mask,
              void* out, M4_ARGS) {
  if (cb < 2 || cb > MAX_CB || cc < 1) return kBadArgs;
  const Geom g = make_geom(dim, g0, g1, g2, cb, lo0, lo1, lo2, h0, h1, h2, L0,
                           L1, L2);
  const int n_cells = g.grid[0] * g.grid[1] * g.grid[2];
  M4_DISPATCH(launch_p2m, BF16, dim, n_ch, cell_x, cell_val, cell_mask, out,
              g, cc, n_cells, static_cast<cudaStream_t>(stream))
}

template <bool BF16>
int m2p_entry(const void* field, const void* cell_x, const void* cell_mask,
              void* out, M4_ARGS) {
  if (cb < 2 || cb > MAX_CB || cc < 1 || cc > 1024) return kBadArgs;
  const Geom g = make_geom(dim, g0, g1, g2, cb, lo0, lo1, lo2, h0, h1, h2, L0,
                           L1, L2);
  const int n_cells = g.grid[0] * g.grid[1] * g.grid[2];
  M4_DISPATCH(launch_m2p, BF16, dim, n_ch, field, cell_x, cell_mask, out, g,
              cc, n_cells, static_cast<cudaStream_t>(stream))
}

}  // namespace

#define M4_PASS \
  dim, n_ch, g0, g1, g2, cb, lo0, lo1, lo2, h0, h1, h2, L0, L1, L2, cc, stream

extern "C" {

// P2M: cell_x (cells, cc, dim), cell_val (cells, cc, C), cell_mask
// (cells, cc) -> out, the mesh (cb*grid..., C); cb^dim <= 1024.
int m4_p2m_f32(const void* cell_x, const void* cell_val, const void* cell_mask,
               void* out, M4_ARGS) {
  return p2m_entry<false>(cell_x, cell_val, cell_mask, out, M4_PASS);
}

int m4_p2m_bf16x(const void* cell_x, const void* cell_val,
                 const void* cell_mask, void* out, M4_ARGS) {
  return p2m_entry<true>(cell_x, cell_val, cell_mask, out, M4_PASS);
}

// Fused M2P: field (cb*grid..., C), cell_x (cells, cc, dim), cell_mask
// (cells, cc) -> out (cells, cc, C); masked slots read 0; cc <= 1024.
int m4_m2p_f32(const void* field, const void* cell_x, const void* cell_mask,
               void* out, M4_ARGS) {
  return m2p_entry<false>(field, cell_x, cell_mask, out, M4_PASS);
}

int m4_m2p_bf16x(const void* field, const void* cell_x, const void* cell_mask,
                 void* out, M4_ARGS) {
  return m2p_entry<true>(field, cell_x, cell_mask, out, M4_PASS);
}

}  // extern "C"
