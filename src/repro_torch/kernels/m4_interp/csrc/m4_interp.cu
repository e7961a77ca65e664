// M'4 particle-mesh interpolation for Hopper (sm_90a): P2M as a
// shared-memory patch scatter and the fused M2P gather, over particles
// pre-bucketed into interpolation cells of cb mesh nodes per axis.
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
// the VIC size below, the owner-gather P2M 158 ms (1.04x fp32) and M2P
// 65 ms (0.97x).
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
// M2P gives each slot one owner thread, so it needs no atomics and its
// summation order is fixed: the offsets are walked in
// itertools.product((-1, 0, 1), repeat=DIM) order, every one of them every
// time. On a grid with fewer than 3 cells along an axis two offsets fetch
// the same bucket, each with its own image; deduplicating would drop one.
// P2M sums each node's contributions with shared-memory atomics, in an
// order that changes from run to run: its fp32 result agrees with the
// plain version's to the summation order (1e-5 relative), and two runs may
// differ in the last bits. Empty slots hold a real particle's position
// (the bucketing clamps the sentinel to a real index), so slots are
// weighted by the mask and the position is never tested.
//
// Design:
//   * P2M (redesigned for the card): the work follows the particles'
//     support instead of the node x staged-slot product. A block of 256
//     threads owns a patch of T^DIM interpolation cells and keeps its
//     nodes' sums in shared memory; T is the largest (<= 16) whose padded
//     sums and the warps' tables fit 64 KB (T = 3 at cb 4, C 3, DIM 3:
//     25 KB of sums, 19 KB of tables). Each warp streams the slots of
//     its share of the patch's cells and of the one-cell band around
//     them (the only buckets whose particles reach the patch: a particle
//     reaches nodes floor((x-lo)/h) - 1 .. + 2), 32 at a time. A valid
//     particle that reaches the patch forms its 4 weights per axis once,
//     keeping those of owned nodes in cells within one of its bucket
//     along that axis (the owner gather's pairs, images included), and
//     goes to the warp's table. The warp then adds its table's particles
//     one at a time, a lane per (node, channel) term, with shared-memory
//     atomicAdd: the 32 lanes of one add hit 32 distinct nodes, in 32
//     distinct banks (the patch's row and plane strides are padded so).
//     Each owned node is written to HBM once; there are no global
//     atomics and no limit on the bucket capacity.
//     What holds it back: fp32 atomicAdd on shared memory is a
//     compare-and-swap loop on the H100 (SASS ATOMS.CAST.SPIN), so the
//     adds (64 x C per particle) take most of the time, and the band
//     re-reads each bucket (T+2)^DIM / T^DIM times (4.6x at T = 3). A
//     warp-level gather (each lane summing a column of its table's node
//     box in registers, one add per node) was tried and ran slower: it
//     tests every table particle against every column. An atomic-free
//     gather from particles binned by base node is the next step.
//   * M2P (a simple, correct first version): one block per bucket, one
//     thread per slot (cc rounded up to a warp multiple). Per offset the
//     block stages the wrapped neighbour field block (cb^DIM x C) in
//     shared memory; each thread computes its DIM x cb per-axis weights
//     and sums over the nodes with a nonzero product, skipping an axis
//     index as soon as its factor is zero.
//   * node - x - shift and the divisions by h are explicitly rounded fp32
//     (__fmul_rn/__fadd_rn/__fsub_rn, IEEE division), in the order of the
//     plain PyTorch versions, so positions round the same way on both
//     paths and every fp32 and bf16x weight rounds as the plain version's.
//     h and L come in as float32 of the same doubles (L/n) that the plain
//     versions use.
//
// What bounds it on the H100: memory. At the one-card VIC size (800 x 200
// x 200 nodes, cb = 4, 500,000 cells x 128 slots) one P2M pass reads
// the mask, the valid slots' positions and values and writes the field:
// 0.363 ms at 3.35 TB/s (chip_smoke.py's count). One M2P pass (C = 6)
// reads the field (768 MB), cell_x and the mask, and writes 1.54 GB of
// per-slot values: 0.82 ms. The in-support arithmetic is 64
// particle-node pairs per particle, about 2e9 pairs, under 0.3 ms at
// 67 TFLOP/s fp32. The owner-gather P2M took 151.09 ms there (every
// thread walked 27 x 128 staged slots, ~3.7% of which contribute).
// Prediction for the patch scatter, written before its first timed run:
// 3-6 ms, bound by the shared-memory atomics (3.2e7 particles x 64 nodes
// x 3 channels, ~6e9 atomics, ~1 ms at one atomic per bank per clock on
// 132 SMs, times bank and address conflicts) and by reading each bucket
// 3.4 times through L2. Measured (chip_smoke.py phase 4, H100 80GB HBM3,
// 700 W): a thread per particle with 4^DIM x C atomics each, 39.0 ms;
// this lane-per-term form, 11.25 ms (PERF.md). M2P walks 27 field
// blocks per slot; its measured times are in PERF.md.

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

// P2M: a block of P2M_THREADS owns a patch of up to T^DIM interpolation
// cells (fewer at the grid's far edge) and keeps its nodes' sums in shared
// memory. Its warps stream 32-slot chunks of the patch's cells and of the
// one-cell band around it (each band cell with its own periodic image).
// Per chunk, each lane takes one slot: a valid particle whose support
// meets the patch forms its 4 weights per axis once, keeping those of
// owned nodes in cells within one of its bucket along that axis (exactly
// the (node, bucket) pairs of the owner gather over 3^DIM offsets, so a
// bucket that two offsets fetch, on an axis of fewer than 3 cells, counts
// once per image), and writes them to the warp's table. Then the warp
// adds the table's particles one at a time, one (node, channel) term per
// lane, with shared-memory atomicAdd: the 32 lanes of an add hit 32
// distinct nodes, and the patch's row and plane strides are padded so
// that they hit 32 distinct banks (fp32 atomicAdd on shared memory is a
// compare-and-swap loop on the H100, so a conflict costs a retry).
constexpr int P2M_THREADS = 256;
constexpr int P2M_WARPS = P2M_THREADS / 32;
constexpr size_t P2M_SMEM_BUDGET = 64 * 1024;
constexpr int P2M_MAX_T = 16;
constexpr int TAB_LD = 33;             // table field stride: no bank clash

struct Patch {
  int T;          // cells per patch side
  int stride[3];  // words between nodes along each axis (padded)
  int words;      // words of the node sums
};

// Fields of a warp's table, TAB_LD words apart, one column per particle:
// the 4 weights per axis, the patch-local first node per axis, the values.
template <int DIM, int C>
struct Table {
  static constexpr int W = 0, J = 4 * DIM, V = 5 * DIM, FIELDS = 5 * DIM + C;
};

template <int DIM, int C, bool BF16>
__global__ void __launch_bounds__(P2M_THREADS)
    m4_p2m_kernel(const float* __restrict__ cell_x,    // (cells, cc, DIM)
                  const float* __restrict__ cell_val,  // (cells, cc, C)
                  const bool* __restrict__ cell_mask,  // (cells, cc)
                  float* __restrict__ out,             // shape + (C,)
                  Geom g, int cc, Patch pt) {
  using TB = Table<DIM, C>;
  extern __shared__ float acc[];       // the patch's node sums, padded
  const int cb = g.cb, T = pt.T;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* tab = acc + pt.words + warp * TB::FIELDS * TAB_LD;
  int p0[DIM], tn[DIM], band[DIM];
  {
    int rem = blockIdx.x;
#pragma unroll
    for (int d = DIM - 1; d >= 0; --d) {
      const int np = (g.grid[d] + T - 1) / T;
      p0[d] = (rem % np) * T;
      rem /= np;
      tn[d] = min(T, g.grid[d] - p0[d]);
      band[d] = tn[d] + 2;
    }
  }
  int n_band = 1, n_nodes = 1;
#pragma unroll
  for (int d = 0; d < DIM; ++d) {
    n_band *= band[d];
    n_nodes *= tn[d] * cb;
  }
  for (int i = threadIdx.x; i < pt.words; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();

  // each warp takes every P2M_WARPS-th band cell, 32 slots at a time
  for (int cell = warp; cell < n_band; cell += P2M_WARPS) {
    int u[DIM];
    {
      int rem = cell;
#pragma unroll
      for (int d = DIM - 1; d >= 0; --d) {
        u[d] = p0[d] - 1 + rem % band[d];
        rem /= band[d];
      }
    }
    int nb = 0;
    float shift[DIM];
    int lo_n[DIM], hi_n[DIM];
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      shift[d] = u[d] < 0 ? -g.L[d] : (u[d] >= g.grid[d] ? g.L[d] : 0.0f);
      nb = nb * g.grid[d] + wrap(u[d], g.grid[d]);
      // owned nodes in cells within one of u along d
      lo_n[d] = max(p0[d], u[d] - 1) * cb;
      hi_n[d] = min(p0[d] + tn[d], u[d] + 2) * cb;
    }
    for (int s0 = 0; s0 < cc; s0 += 32) {
      // -- each lane: one slot; a particle that reaches the patch -> table
      const int s = s0 + lane;
      const size_t slot = static_cast<size_t>(nb) * cc + s;
      bool reach = s < cc && cell_mask[slot];
      if (__ballot_sync(0xffffffffu, reach) == 0) continue;  // none valid
      float xs[DIM];
      int j0[DIM];
#pragma unroll
      for (int d = 0; d < DIM; ++d) {
        // candidates: the image's base node - 1 .. + 2 (M'4's support),
        // kept where the node is owned and its cell within one of u
        xs[d] = reach ? cell_x[slot * DIM + d] : 0.0f;
        j0[d] = static_cast<int>(floorf(__fsub_rn(
                    __fadd_rn(xs[d], shift[d]), g.lo[d]) / g.h[d])) - 1;
        reach &= j0[d] + 3 >= lo_n[d] && j0[d] < hi_n[d];
      }
      float w[DIM][4];
      if (reach) {
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
          bool any = false;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = j0[d] + k;
            float wk = 0.0f;
            if (j >= lo_n[d] && j < hi_n[d]) {
              const float nx = __fadd_rn(
                  __fmul_rn(static_cast<float>(j), g.h[d]), g.lo[d]);
              wk = m4(__fsub_rn(__fsub_rn(nx, xs[d]), shift[d]) / g.h[d]);
            }
            w[d][k] = wk;
            any |= wk != 0.0f;
          }
          reach &= any;
        }
      }
      const unsigned in_tab = __ballot_sync(0xffffffffu, reach);
      const int n_tab = __popc(in_tab);
      if (reach) {
        float* col = tab + __popc(in_tab & ((1u << lane) - 1));
#pragma unroll
        for (int d = 0; d < DIM; ++d) {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            col[(TB::W + 4 * d + k) * TAB_LD] = w[d][k];
          col[(TB::J + d) * TAB_LD] = __int_as_float(j0[d] - p0[d] * cb);
        }
#pragma unroll
        for (int c = 0; c < C; ++c)
          col[(TB::V + c) * TAB_LD] = operand<BF16>(cell_val[slot * C + c]);
      }
      __syncwarp();

      // -- the warp: each table particle's 4^DIM x C terms, a lane per node
      if constexpr (DIM == 3) {
        const int kh = lane >> 4, k1 = (lane >> 2) & 3, k2 = lane & 3;
        for (int q = 0; q < n_tab; ++q) {
          const float* col = tab + q;
          const float w1 = col[(TB::W + 4 + k1) * TAB_LD];
          const float w2 = col[(TB::W + 8 + k2) * TAB_LD];
          const int base =
              (__float_as_int(col[(TB::J + 1) * TAB_LD]) + k1) *
                  pt.stride[1] +
              (__float_as_int(col[(TB::J + 2) * TAB_LD]) + k2) * C;
          const int b0 = __float_as_int(col[TB::J * TAB_LD]);
#pragma unroll
          for (int pass = 0; pass < 2; ++pass) {
            const int k0 = kh + 2 * pass;
            float ww =
                __fmul_rn(__fmul_rn(col[(TB::W + k0) * TAB_LD], w1), w2);
            if (ww == 0.0f) continue;
            ww = operand<BF16>(ww);
            float* a = acc + (b0 + k0) * pt.stride[0] + base;
#pragma unroll
            for (int c = 0; c < C; ++c)
              atomicAdd(a + c, __fmul_rn(ww, col[(TB::V + c) * TAB_LD]));
          }
        }
      } else {
        const int sub = lane >> 4, k0 = (lane >> 2) & 3, k1 = lane & 3;
        for (int q = sub; q < n_tab + sub; q += 2) {
          if (q >= n_tab) continue;
          const float* col = tab + q;
          float ww = __fmul_rn(col[(TB::W + k0) * TAB_LD],
                               col[(TB::W + 4 + k1) * TAB_LD]);
          if (ww == 0.0f) continue;
          ww = operand<BF16>(ww);
          float* a =
              acc +
              (__float_as_int(col[TB::J * TAB_LD]) + k0) * pt.stride[0] +
              (__float_as_int(col[(TB::J + 1) * TAB_LD]) + k1) * C;
#pragma unroll
          for (int c = 0; c < C; ++c)
            atomicAdd(a + c, __fmul_rn(ww, col[(TB::V + c) * TAB_LD]));
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // each owned node written once, the innermost axis contiguous
  for (int i = threadIdx.x; i < n_nodes * C; i += blockDim.x) {
    int rem = i / C;
    int l[DIM];
#pragma unroll
    for (int d = DIM - 1; d >= 0; --d) {
      l[d] = rem % (tn[d] * cb);
      rem /= tn[d] * cb;
    }
    size_t flat = 0;
    int a = i % C;
#pragma unroll
    for (int d = 0; d < DIM; ++d) {
      flat = flat * g.n[d] + p0[d] * cb + l[d];
      a += l[d] * (d == DIM - 1 ? C : pt.stride[d]);
    }
    out[flat * C + i % C] = acc[a];
  }
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

// The patch: the largest side T (up to P2M_MAX_T, and no larger than the
// grid's longest axis) whose padded node sums and the warps' tables fit
// P2M_SMEM_BUDGET. The row (and, at DIM 3, plane) stride is padded so
// that the nodes a warp's atomics hit at once, 4 along the last axis x 4
// along the one before (x 2 before that at DIM 3), fall in distinct
// banks, or as few shared banks as a pad of under 32 words allows. The
// search depends only on (DIM, C, cb, grid); the last geometry's patch is
// kept, so a run's repeated launches search once.
template <int DIM, int C>
size_t p2m_patch(const Geom& g, Patch* pt) {
  static int key[4] = {0, 0, 0, 0};
  static Patch kept;
  static size_t kept_bytes = 0;
  if (kept_bytes != 0 && key[0] == g.cb && key[1] == g.grid[0] &&
      key[2] == g.grid[1] && key[3] == g.grid[2]) {
    *pt = kept;
    return kept_bytes;
  }
  int longest = 1;
  for (int d = 0; d < DIM; ++d)
    longest = g.grid[d] > longest ? g.grid[d] : longest;
  auto clash = [](int R, int P) {
    int hits[32] = {0}, worst = 0;
    for (int a = 0; a < (DIM == 3 ? 2 : 1); ++a)
      for (int b = 0; b < 4; ++b)
        for (int k = 0; k < 4; ++k) {
          const int bank = (a * P + b * R + k * C) % 32;
          worst = ++hits[bank] > worst ? hits[bank] : worst;
        }
    return worst;
  };
  const size_t tables =
      sizeof(float) * P2M_WARPS * Table<DIM, C>::FIELDS * TAB_LD;
  size_t best = 0;
  for (int t = 1; t <= P2M_MAX_T && t <= longest; ++t) {
    int ext[DIM];
    for (int d = 0; d < DIM; ++d)
      ext[d] = (t < g.grid[d] ? t : g.grid[d]) * g.cb;
    Patch p{t, {0, 0, 0}, 0};
    int fewest = 33;
    for (int pr = 0; pr < 32; ++pr) {
      const int R = ext[DIM - 1] * C + pr;
      for (int pp = 0; pp < (DIM == 3 ? 32 : 1); ++pp) {
        const int P = DIM == 3 ? ext[1] * R + pp : 0;
        const int worst = clash(R, P);
        const int words = DIM == 3 ? ext[0] * P : ext[0] * R;
        if (worst < fewest || (worst == fewest && words < p.words)) {
          fewest = worst;
          p.words = words;
          p.stride[DIM - 1] = C;
          p.stride[DIM - 2] = R;
          if (DIM == 3) p.stride[0] = P;
        }
      }
    }
    const size_t bytes = sizeof(float) * p.words + tables;
    if (t > 1 && bytes > P2M_SMEM_BUDGET) break;
    *pt = p;
    best = bytes;
  }
  kept = *pt;
  kept_bytes = best;
  key[0] = g.cb;
  key[1] = g.grid[0];
  key[2] = g.grid[1];
  key[3] = g.grid[2];
  return best;
}

template <int DIM, int C, bool BF16>
int launch_p2m(const void* cell_x, const void* cell_val,
               const void* cell_mask, void* out, const Geom& g, int cc,
               int n_cells, cudaStream_t stream) {
  Patch pt;
  const size_t smem = p2m_patch<DIM, C>(g, &pt);
  int blocks = 1;
  for (int d = 0; d < DIM; ++d) blocks *= (g.grid[d] + pt.T - 1) / pt.T;
  auto kern = m4_p2m_kernel<DIM, C, BF16>;
  const int e = set_smem(kern, smem);
  if (e != 0) return e;
  if (n_cells > 0)
    kern<<<blocks, P2M_THREADS, smem, stream>>>(
        static_cast<const float*>(cell_x), static_cast<const float*>(cell_val),
        static_cast<const bool*>(cell_mask), static_cast<float*>(out), g, cc,
        pt);
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
// (cells, cc) -> out, the mesh (cb*grid..., C); any cc >= 1.
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
