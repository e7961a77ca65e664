// GQA flash attention, causal or not, forward only, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` in
// src/repro/kernels/flash_attention/flash_attention.py (launched by
// `flash_attention`, reached through `ops.mha`). It computes that function:
//
//   s    = (q . k^T) * (1/sqrt(hd))                  fp32 (inputs cast)
//   s    = NEG_INF = -1e30 where kpos > q_off + qpos (causal; both from 0)
//   m, l, acc: the online softmax over key tiles, fp32
//   acc += exp(s - m) . v                           p and v in fp32
//   o    = acc / max(l, 1e-30)                       in q's type
//
// with the KV head h / rep for query head h (K and V are never repeated).
// The mask is aligned to the START, as the Pallas kernel's: query i sees
// keys 0..i whatever Sk is, which is the prefill's attention over a deeper
// zeroed cache (repro's oracle `attention_ref` aligns it to the end; the
// two agree only at Sq == Sk). q_off shifts the query rows' positions:
// row i sits at position q_off + i, so a causal call on rows [q_off,
// q_off + Sq) of a longer sequence sees what those rows see in the whole
// call (the sequence-parallel prefill's rows; 0 everywhere else). Both
// forms take any Sq and Sk (the ragged
// edge is masked inside), causal or not, any rep, hd a multiple of 8 up
// to 256, and strided q, k, v (the head axis contiguous, every other
// stride a multiple of 8 elements, 16-byte aligned pointers); o has q's
// strides. Each block walks the key tiles 0 .. the last one its causal
// mask leaves visible (the loop replaces the Pallas kernel's `pl.when`),
// so the zeroed cache tail beyond the prompt is never read, and the
// heaviest causal query tiles are scheduled first.
//
// bf16 (flash_attention_bf16, the serve path's form): tensor cores.
//   * q.k^T runs as bf16 wgmma (m64n64k16, fp32 accumulate). A product of
//     two bf16 values is exact in fp32, so this is the function up to the
//     summation order.
//   * p stays fp32 (repro casts v to fp32). It is split into three bf16
//     terms, p1 = bf16(p), p2 = bf16(p - p1), p3 = bf16(p - p1 - p2), and
//     p.v runs as three wgmmas against the same V tile with A from
//     registers (the RS form; the accumulator layout of q.k^T is the A
//     layout of p.v). v is exact in bf16 and p1 + p2 + p3 == p exactly for
//     every p >= ~2^-100 (below that a term is under fp32's resolution
//     next to l >= 1), so this too is the function up to the summation
//     order (`ref.split_bf16x3` is the same split in PyTorch).
//   * Q, K and V tiles come in by TMA (cp.async.bulk.tensor, 4-D tensor
//     maps over the strided (B, H, S, hd) views, built on the host with
//     the driver's cuTensorMapEncodeTiled, fetched through the runtime's
//     cudaGetDriverEntryPoint so that nothing links libcuda), 64 rows x
//     64 columns per 128-byte-swizzled box, the ragged edge and the columns past hd zero-filled by the
//     hardware (which also pads the product depth to 16). One producer
//     warp keeps a two-stage K/V ring in flight on mbarriers; two consumer
//     warpgroups (one for hd > 128, for registers) each own 64 query rows
//     of the block's 128 and share every K/V tile. A warpgroup whose rows
//     see none of the block's last tile waits for it and releases it.
//   * Cost: 8 hd tensor-core operations per visible pair (2 hd for q.k^T,
//     3 x 2 hd for p.v) against the function's 4 hd; p.v runs in 64-column
//     chunks of hd (zero columns past hd).
//
// fp32 (flash_attention_f32): the same pipeline on three exact bf16 terms
// of every operand.
//   * A split pass (split_planes, launched by the same entry) writes q, k
//     and v once each as three bf16 planes, x1 = bf16(x), x2 = bf16(x -
//     x1), x3 = bf16(x - x1 - x2), into the caller's scratch (3 (|q| + |k|
//     + |v|) bf16 elements). x1 + x2 + x3 == x for every normal x: fp32's
//     24-bit significand fits in three 8-bit ones. The main kernel
//     (flash_attention_split3) loads the planes by TMA as the bf16 form
//     loads q, k and v; p is split in registers as there.
//   * q.k^T and p.v each sum the six products x_a . y_b of order a + b <=
//     2 of the terms, on bf16 wgmma (each product exact in fp32). The
//     dropped x2 y3, x3 y2 and x3 y3 are under ~2^-24 |x y|, so this is
//     the fp32 function up to the summation order; with only the three of
//     order <= 1 it is not (ref.flash_attention_ref(split_terms=3), the
//     control that chip_smoke.py holds the kernel's error under).
//   * The tensor core's fp32 accumulation is not IEEE's. Modelled as one
//     truncation per 16 products (tools/b5_fp32_accum_model.py), a tile's
//     p.v issued into the running output is 2.18e-05 of plain away, over
//     fp32's 1e-5. So the products go smallest first (q1 k1 last, after
//     every correction over the whole depth), and each tile's p.v, one
//     64-column box at a time, goes into a fresh accumulator that fp32
//     adds then fold into the output (1.23e-06 in the model).
//   * Shared memory is the limit: a plane of one 64-row tile is 8 KB per
//     64 columns of hd. Each consumer warpgroup keeps its three Q planes;
//     a ring of slots holds the K and V tiles in turn (K0, V0, K1, ...),
//     and a K slot is released as soon as its q.k^T is read. Per hd
//     bucket (with_shape): hd <= 64 two warpgroups, Q 48 KB + 4 slots of
//     24 KB; <= 128 two, Q 96 KB + 2 slots of 48 KB; <= 192 one, Q 72 KB +
//     2 slots of 72 KB; <= 256 one, Q 96 KB + 1 slot of 96 KB (K and V
//     through one slot, their loads not overlapped with the products).
//   * Cost: 24 hd tensor-core operations per visible pair (6 x 2 hd for
//     q.k^T, 6 x 2 hd for p.v) against the function's 4 hd.
//
// What bounds it on the H100: operations. At the prefill's shapes (B 4,
// H 48 over K 4, Sq 2048, Sk 2176, hd 128) the visible (q, k) pairs are
// B.H.sum_i(i+1) = 4.03e8, 4.hd operations each: 2.06e11, 0.21 ms at
// 989 TFLOP/s bf16; its bytes (q, the visible k and v prefix once per KV
// head, o) are 1.3e8 B in bf16, 0.04 ms at 3.35 TB/s, and 4.4e8 B in fp32,
// 0.13 ms. The bf16 design's own floor (8 hd per pair) is ~0.42 ms, the
// fp32 design's (24 hd) ~1.25 ms. Measured on an H100 80GB HBM3 (700 W)
// at those shapes (chip_smoke.py phase 10a): the first version (SIMT for
// both types) 7.70 ms in bf16 and 7.87 ms in fp32; PyTorch's SDPA 0.37 ms
// for the same bf16 call. Prediction for the bf16 design, written before
// its first timed run: 1.0-2.0 ms (the 64 x 64 wgmmas at ~40-50% of the
// bf16 peak, the softmax and the p split not overlapped with the tensor
// cores within a warpgroup, only across the two). Measured: 1.24 ms
// (chip_smoke.py phase 10a; PERF.md), 3.0x the design's floor, 3.3x
// SDPA. What holds it back: inside a warpgroup the softmax and the split
// run between the two products. Issuing the next tile's q.k^T and
// softmax beside this tile's p.v needs a second score tile in registers;
// under the 168-register cap that ptxas gives two consumer warpgroups it
// spilled and ran slower, so it is not taken here. The fp32 design,
// predicted at 2.4-4.0 ms, measured 2.4584 and 2.4484 ms beside the SIMT
// kernel's 7.8236 and 7.7321 in one process (H100 80GB HBM3, 700 W;
// PERF.md): 51% of its floor, where SDPA's fp32 call took 22.2554 ms.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, h, s;  // element strides of axes 0-2; axis 3 is contiguous
};

}  // namespace

// ---------------------------------------------------------------------------
// wgmma and TMA: the shared pieces and the bf16 form
// ---------------------------------------------------------------------------

namespace hopper {

constexpr int ROWS = 64;                // query rows per warpgroup; keys
                                        // per tile
constexpr int COLS = 64;                // hd columns per 128-byte box
constexpr int CHUNK = ROWS * COLS * 2;  // bytes of one bf16 box
constexpr int STAGES = 2;               // K/V ring depth

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Spins on the barrier's phase; a phase that never completes (a fault in
// the pipeline) traps after ~2^28 tries instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// One 64 x 64 box of a 4-D tensor map into shared memory; `c` are the
// coordinates in the map's dimension order, innermost first.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         const int (&c)[4], uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c[0]), "r"(c[1]), "r"(c[2]),
      "r"(c[3]), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (>> 4), layout 1 (128B swizzle).
// Every box starts 1024-byte aligned, so the base offset is 0.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// K-major (rows of 64 contiguous columns; q and k): 8-row groups 1024 B
// apart, the leading offset unused by a swizzled K-major operand.
__device__ __forceinline__ uint64_t desc_k(const void* p) {
  return desc(p, 16, 1024);
}

// MN-major (v as the K x N operand of p.v: keys down, hd across): 8-key
// groups 1024 B apart; one 64-column box per instruction, so the leading
// (N) offset is never stepped.
__device__ __forceinline__ uint64_t desc_mn(const void* p) {
  return desc(p, 1024, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (m64 x n64 fp32, in registers) (+)= A (m64 x k16) . B (k16 x n64), A
// and B from shared-memory descriptors; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A . B with A (m64 x k16 bf16) from registers, B an MN-major
// shared-memory descriptor.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16;
}

// The map's dimensions 1..3 hold the logical axes ax[0..2] (0 = s,
// 1 = head, 2 = batch), ordered by stride; dimension 0 is hd.
struct Order {
  int ax[3];
};

__device__ __forceinline__ void coords(int (&c)[4], const Order& o, int col,
                                       int s, int h, int b) {
  const int by_axis[3] = {s, h, b};
  c[0] = col;
#pragma unroll
  for (int i = 0; i < 3; ++i) c[i + 1] = by_axis[o.ax[i]];
}

// NC: 64-column boxes of hd (hd <= 64 NC); NWG: consumer warpgroups.
// A consumer warpgroup's work on one tile: q.k^T into sc, the online
// softmax on sc in place, p split into the A fragments of p.v, then p.v.

// sc = q.k^T of the K tile at sk (asynchronous: one wgmma group).
__device__ __forceinline__ void issue_qk(float (&sc)[32], const uint8_t* q,
                                         const uint8_t* sk, int ksteps) {
#pragma unroll
  for (int r = 0; r < 32; ++r) sc[r] = 0.0f;
  fence_regs(sc);
  wgmma_fence();
  for (int kk = 0; kk < ksteps; ++kk) {
    const int off = (kk >> 2) * CHUNK + (kk & 3) * 32;
    wgmma_ss(sc, desc_k(q + off), desc_k(sk + off), kk > 0);
  }
  wgmma_commit();
}

// Scale, mask and the online softmax of the tile of keys k0.. on sc, in
// place: sc becomes p = exp(s - m); l takes the tile's row sums; corr is
// the factor that rescales the earlier tiles' acc. Rows r0 and r0 + 8
// (half 0 and 1).
__device__ __forceinline__ void softmax(float (&sc)[32], float (&m)[2],
                                        float (&l)[2], float (&corr)[2],
                                        int k0, int r0, int wq0, int lane,
                                        int Sk, int causal, float scale) {
  const bool masked = k0 + ROWS > Sk || (causal && k0 + ROWS - 1 > wq0);
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const int half = (r >> 1) & 1;
    float x = sc[r] * scale;
    if (masked) {
      const int kpos = k0 + (r >> 2) * 8 + (lane & 3) * 2 + (r & 1);
      if (kpos >= Sk || (causal && kpos > r0 + 8 * half)) x = NEG_INF;
    }
    sc[r] = x;
    mx[half] = fmaxf(mx[half], x);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    corr[i] = expf(m[i] - m_new);
    m[i] = m_new;
  }
  float rs[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    sc[r] = expf(sc[r] - m[(r >> 1) & 1]);
    rs[(r >> 1) & 1] += sc[r];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
    l[i] = l[i] * corr[i] + rs[i];
  }
}

// x as three bf16 terms, t[0] = bf16(x), t[1] = bf16(x - t[0]), t[2] =
// bf16(x - t[0] - t[1]), each difference exact in fp32 (ref.split_bf16x3).
__device__ __forceinline__ void split3(float x, __nv_bfloat16 (&t)[3]) {
  t[0] = __float2bfloat16_rn(x);
  const float rem = __fsub_rn(x, __bfloat162float(t[0]));
  t[1] = __float2bfloat16_rn(rem);
  t[2] = __float2bfloat16_rn(__fsub_rn(rem, __bfloat162float(t[1])));
}

// p split into three bf16 terms, packed as the A fragments of the four
// 16-key steps of p.v: pa[term][step][reg].
__device__ __forceinline__ void split(const float (&p)[32],
                                      uint32_t (&pa)[3][4][4]) {
#pragma unroll
  for (int r = 0; r < 32; r += 2) {
    __nv_bfloat16 t[2][3];
    split3(p[r], t[0]);
    split3(p[r + 1], t[1]);
#pragma unroll
    for (int term = 0; term < 3; ++term)
      pa[term][r >> 3][(r >> 1) & 3] = pack(t[0][term], t[1][term]);
  }
}

// acc += p . v of the V tile at sv (asynchronous: one wgmma group).
template <int NC>
__device__ __forceinline__ void issue_pv(float (&acc)[NC][32],
                                         const uint32_t (&pa)[3][4][4],
                                         const uint8_t* sv) {
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NC; ++j) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = desc_mn(sv + j * CHUNK + kk * 16 * 128);
#pragma unroll
      for (int term = 2; term >= 0; --term)
        wgmma_rs(acc[j], pa[term][kk], dv);
    }
  }
  wgmma_commit();
}

// Threads: NWG consumer warpgroups and one producer warp, of which one
// thread issues the loads.
template <int NC, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
    flash_attention_wgmma(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          __nv_bfloat16* __restrict__ o, Strides so,
                          Order oq, Order ok, Order ov, int rep, int Sq,
                          int Sk, int hd, int causal, int q_off,
                          float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sK = sQ + NWG * NC * CHUNK;
  uint8_t* sV = sK + STAGES * NC * CHUNK;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + STAGES * NC * CHUNK);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * (NWG * ROWS);
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / rep;
  const int k_end = causal ? min(Sk, q_off + q0 + NWG * ROWS) : Sk;
  const int n_tiles = (k_end + ROWS - 1) / ROWS;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, NWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NWG * 128) {  // the producer warp: one thread issues the TMA
    if (tid == NWG * 128) {
      int c[4];
      mbar_expect_tx(q_full, NWG * NC * CHUNK);
      for (int w = 0; w < NWG; ++w)
        for (int j = 0; j < NC; ++j) {
          coords(c, oq, j * COLS, q0 + w * ROWS, h, b);
          tma_load(sQ + (w * NC + j) * CHUNK, &tq, c, q_full);
        }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(empty + s, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(k_full + s, NC * CHUNK);
        for (int j = 0; j < NC; ++j) {
          coords(c, ok, j * COLS, t * ROWS, kvh, b);
          tma_load(sK + (s * NC + j) * CHUNK, &tk, c, k_full + s);
        }
        mbar_expect_tx(v_full + s, NC * CHUNK);
        for (int j = 0; j < NC; ++j) {
          coords(c, ov, j * COLS, t * ROWS, kvh, b);
          tma_load(sV + (s * NC + j) * CHUNK, &tv, c, v_full + s);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows wq0 .. wq0 + 63; this thread's two rows
  // are r0 and r0 + 8 (the wgmma accumulator layout)
  const int wg = tid / 128, lane = tid % 32;
  const int wq0 = q0 + wg * ROWS;
  const int r0 = wq0 + (tid % 128) / 32 * 16 + lane / 4;
  const int my_end =
      wq0 >= Sq ? 0 : (causal ? min(Sk, q_off + wq0 + ROWS) : Sk);
  const int my_tiles = (my_end + ROWS - 1) / ROWS;
  const int ksteps = (hd + 15) / 16;
  const uint8_t* myQ = sQ + wg * NC * CHUNK;

  float acc[NC][32];
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[j][r] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};

  float sc[32], corr[2];
  uint32_t pa[3][4][4];
  mbar_wait(q_full, 0);
  for (int t = 0; t < my_tiles; ++t) {
    const int s = t % STAGES, ph = (t / STAGES) & 1;
    mbar_wait(k_full + s, ph);
    issue_qk(sc, myQ, sK + s * NC * CHUNK, ksteps);
    wgmma_wait();
    fence_regs(sc);
    softmax(sc, m, l, corr, t * ROWS, q_off + r0, q_off + wq0, lane, Sk,
            causal, scale);
    split(sc, pa);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
#pragma unroll
      for (int r = 0; r < 32; ++r) acc[j][r] *= corr[(r >> 1) & 1];
      fence_regs(acc[j]);
    }
    mbar_wait(v_full + s, ph);
    issue_pv(acc, pa, sV + s * NC * CHUNK);
    wgmma_wait();
#pragma unroll
    for (int j = 0; j < NC; ++j) fence_regs(acc[j]);
    mbar_arrive(empty + s);
  }
  for (int t = my_tiles; t < n_tiles; ++t) {  // tiles no row here sees
    const int s = t % STAGES, ph = (t / STAGES) & 1;
    mbar_wait(k_full + s, ph);
    mbar_wait(v_full + s, ph);
    mbar_arrive(empty + s);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qpos = r0 + 8 * half;
    if (qpos >= Sq) continue;
    const float den = fmaxf(l[half], 1e-30f);
    __nv_bfloat16* orow = o + b * so.b + h * so.h + qpos * so.s;
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int col = j * COLS + g * 8 + (lane & 3) * 2;
        if (col < hd)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(acc[j][4 * g + 2 * half] / den,
                                    acc[j][4 * g + 2 * half + 1] / den);
      }
  }
}

// The driver's cuTensorMapEncodeTiled, fetched once through the runtime
// (null if the driver does not offer it).
using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// A tensor map over the strided (B, n_heads, S, hd) view at `ptr`: hd
// innermost, then the other three axes by stride; 64 x 64 boxes with the
// 128-byte swizzle, out-of-bounds elements read as zeros.
CUresult make_map(CUtensorMap* map, Order* order, const void* ptr, int B,
                  int n_heads, int S, int hd, const Strides& st) {
  const long long dims[3] = {S, n_heads, B};
  const long long strides[3] = {st.s, st.h, st.b};
  int ax[3] = {0, 1, 2};
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (strides[ax[j]] < strides[ax[i]]) {
        const int tmp = ax[i];
        ax[i] = ax[j];
        ax[j] = tmp;
      }
  cuuint64_t gdim[4] = {static_cast<cuuint64_t>(hd), 0, 0, 0};
  cuuint64_t gstride[3];
  cuuint32_t box[4] = {COLS, 1, 1, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    order->ax[i] = ax[i];
    gdim[i + 1] = static_cast<cuuint64_t>(dims[ax[i]]);
    gstride[i] = static_cast<cuuint64_t>(strides[ax[i]]) * 2;
    if (ax[i] == 0) box[i + 1] = ROWS;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  return encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), gdim,
      gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// A refused tensor map returns kMapError + its CUresult.
constexpr int kMapError = 10000;

template <int NC, int NWG>
int launch_nc(const void* q, const void* k, const void* v, void* o, int B,
              int H, int K, int Sq, int Sk, int hd, int causal, int q_off,
              float scale, const Strides* st, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  Order oq, ok, ov;
  CUresult r = make_map(&tq, &oq, q, B, H, Sq, hd, st[0]);
  if (r == CUDA_SUCCESS) r = make_map(&tk, &ok, k, B, K, Sk, hd, st[1]);
  if (r == CUDA_SUCCESS) r = make_map(&tv, &ov, v, B, K, Sk, hd, st[2]);
  if (r != CUDA_SUCCESS) return kMapError + static_cast<int>(r);
  const size_t smem = static_cast<size_t>(NWG + 2 * STAGES) * NC * CHUNK +
                      (1 + 3 * STAGES) * sizeof(uint64_t) + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma<NC, NWG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + NWG * ROWS - 1) / (NWG * ROWS), H, B);
  flash_attention_wgmma<NC, NWG><<<grid, NWG * 128 + 32, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), st[3], oq, ok, ov, H / K,
      Sq, Sk, hd, causal, q_off, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int K, int Sq, int Sk, int hd, int causal, int q_off,
           float scale, const Strides* st, cudaStream_t s) {
  if (hd <= 64)
    return launch_nc<1, 2>(q, k, v, o, B, H, K, Sq, Sk, hd, causal, q_off,
                           scale, st, s);
  if (hd <= 128)
    return launch_nc<2, 2>(q, k, v, o, B, H, K, Sq, Sk, hd, causal, q_off,
                           scale, st, s);
  if (hd <= 192)
    return launch_nc<3, 1>(q, k, v, o, B, H, K, Sq, Sk, hd, causal, q_off,
                           scale, st, s);
  return launch_nc<4, 1>(q, k, v, o, B, H, K, Sq, Sk, hd, causal, q_off,
                         scale, st, s);
}

// ---------------------------------------------------------------------------
// fp32: three exact bf16 terms of q, k and v on wgmma
// ---------------------------------------------------------------------------

constexpr int PLANES = 3;  // bf16 terms of each fp32 operand

// The split pass: x (B, n, S, hd) fp32, strided with the head axis
// contiguous, into three contiguous bf16 planes (B, n, S, hd), plane t at
// out + t * plane, by split3. One thread per 8 elements of a row; grid
// (ceil(S hd / 8 / 256), n, B).
__global__ void __launch_bounds__(256)
    split_planes(const float* __restrict__ x, __nv_bfloat16* __restrict__ out,
                 int n, int S, int hd, Strides st, long long plane) {
  const int per_row = hd / 8;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S * per_row) return;
  const int s = i / per_row, d = (i - s * per_row) * 8;
  const int h = blockIdx.y, b = blockIdx.z;
  const float4* src = reinterpret_cast<const float4*>(
      x + b * st.b + h * st.h + s * st.s + d);
  const float4 lo = __ldg(src), hi = __ldg(src + 1);
  const float e[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  uint32_t w[PLANES][4];
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    __nv_bfloat16 t[2][3];
    split3(e[j], t[0]);
    split3(e[j + 1], t[1]);
#pragma unroll
    for (int term = 0; term < PLANES; ++term)
      w[term][j / 2] = pack(t[0][term], t[1][term]);
  }
  __nv_bfloat16* dst =
      out + ((static_cast<long long>(b) * n + h) * S + s) * hd + d;
#pragma unroll
  for (int term = 0; term < PLANES; ++term)
    *reinterpret_cast<uint4*>(dst + term * plane) =
        make_uint4(w[term][0], w[term][1], w[term][2], w[term][3]);
}

// The six products x_a . y_b of order a + b <= 2, smallest first:
// t = 0..5 is (a, b) = (2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0).
__device__ __forceinline__ int term_order(int t) {
  return t < 3 ? 2 : t < 5 ? 1 : 0;
}
__device__ __forceinline__ int term_b(int t) {
  return t < 3 ? t : t < 5 ? t - 3 : 0;
}

// sc = q.k^T of one 64-key tile from the six products of the planes at q
// (this warpgroup's Q planes) and k (the slot's K planes), each plane NC
// boxes, in term order: every correction over the whole depth, then
// q1.k1 (one wgmma group).
template <int NC>
__device__ __forceinline__ void issue_qk3(float (&sc)[32], const uint8_t* q,
                                          const uint8_t* k, int ksteps) {
  constexpr int PLANE = NC * CHUNK;
#pragma unroll
  for (int r = 0; r < 32; ++r) sc[r] = 0.0f;
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < 6; ++t) {
    const int b = term_b(t), a = term_order(t) - b;
    for (int kk = 0; kk < ksteps; ++kk) {
      const int off = (kk >> 2) * CHUNK + (kk & 3) * 32;
      wgmma_ss(sc, desc_k(q + a * PLANE + off), desc_k(k + b * PLANE + off),
               t > 0 || kk > 0);
    }
  }
  wgmma_commit();
}

// d = p.v over the 64 columns of box j of the slot's V planes at v, from
// the six products of p's terms (pa) and v's planes, in term order, into
// a fresh accumulator (one wgmma group).
template <int NC>
__device__ __forceinline__ void issue_pv3(float (&d)[32],
                                          const uint32_t (&pa)[3][4][4],
                                          const uint8_t* v, int j) {
  constexpr int PLANE = NC * CHUNK;
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < 6; ++t) {
    const int b = term_b(t), a = term_order(t) - b;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(d, pa[a][kk], desc_mn(v + b * PLANE + j * CHUNK + kk * 16 * 128),
               t > 0 || kk > 0);
  }
  wgmma_commit();
}

// The PLANES x NC boxes of rows row0.. of one (head, batch row) of a
// planes map into dst ([plane][box]); plane t is batch row t * B + b.
__device__ __forceinline__ void load_planes(uint8_t* dst,
                                            const CUtensorMap* map,
                                            const Order& o, int nc, int row0,
                                            int h, int b, int B,
                                            uint64_t* bar) {
  int c[4];
  for (int t = 0; t < PLANES; ++t)
    for (int j = 0; j < nc; ++j) {
      coords(c, o, j * COLS, row0, h, t * B + b);
      tma_load(dst + (t * nc + j) * CHUNK, map, c, bar);
    }
}

// NC: 64-column boxes of hd; NWG: consumer warpgroups; SLOTS: the ring of
// shared-memory slots, each the PLANES x NC boxes of one K or one V tile.
// The producer fills the slots in the order K0, V0, K1, V1, ...; a
// consumer releases a K slot as soon as its q.k^T is read.
template <int NC, int NWG, int SLOTS>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
    flash_attention_split3(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           float* __restrict__ o, Strides so, Order oq,
                           Order ok, Order ov, int B, int rep, int Sq, int Sk,
                           int hd, int causal, int q_off, float scale) {
  constexpr int PLANE = NC * CHUNK, SLOT = PLANES * PLANE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sKV = sQ + NWG * SLOT;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sKV + SLOTS * SLOT);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + SLOTS;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * (NWG * ROWS);
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / rep;
  const int k_end = causal ? min(Sk, q_off + q0 + NWG * ROWS) : Sk;
  const int n_items = 2 * ((k_end + ROWS - 1) / ROWS);  // K and V tiles
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, NWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NWG * 128) {  // the producer warp: one thread issues the TMA
    if (tid == NWG * 128) {
      mbar_expect_tx(q_full, NWG * SLOT);
      for (int w = 0; w < NWG; ++w)
        load_planes(sQ + w * SLOT, &tq, oq, NC, q0 + w * ROWS, h, b, B,
                    q_full);
      for (int i = 0; i < n_items; ++i) {
        const int s = i % SLOTS;
        mbar_wait(empty + s, ((i / SLOTS) & 1) ^ 1);
        mbar_expect_tx(full + s, SLOT);
        if (i & 1)
          load_planes(sKV + s * SLOT, &tv, ov, NC, (i >> 1) * ROWS, kvh, b, B,
                      full + s);
        else
          load_planes(sKV + s * SLOT, &tk, ok, NC, (i >> 1) * ROWS, kvh, b, B,
                      full + s);
      }
    }
    return;
  }

  // a consumer warpgroup: rows wq0 .. wq0 + 63; this thread's two rows
  // are r0 and r0 + 8 (the wgmma accumulator layout)
  const int wg = tid / 128, lane = tid % 32;
  const int wq0 = q0 + wg * ROWS;
  const int r0 = wq0 + (tid % 128) / 32 * 16 + lane / 4;
  const int my_end =
      wq0 >= Sq ? 0 : (causal ? min(Sk, q_off + wq0 + ROWS) : Sk);
  const int my_items = 2 * ((my_end + ROWS - 1) / ROWS);
  const int ksteps = (hd + 15) / 16;
  const uint8_t* myQ = sQ + wg * SLOT;

  float acc[NC][32];
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[j][r] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};

  // sc holds the scores, then each box's p.v
  float sc[32], corr[2];
  uint32_t pa[3][4][4];
  mbar_wait(q_full, 0);
  for (int i = 0; i < my_items; i += 2) {
    int s = i % SLOTS;
    mbar_wait(full + s, (i / SLOTS) & 1);
    issue_qk3<NC>(sc, myQ, sKV + s * SLOT, ksteps);
    wgmma_wait();
    fence_regs(sc);
    mbar_arrive(empty + s);
    softmax(sc, m, l, corr, (i >> 1) * ROWS, q_off + r0, q_off + wq0, lane,
            Sk, causal, scale);
    split(sc, pa);
    s = (i + 1) % SLOTS;
    mbar_wait(full + s, ((i + 1) / SLOTS) & 1);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      issue_pv3<NC>(sc, pa, sKV + s * SLOT, j);
      wgmma_wait();
      fence_regs(sc);
#pragma unroll
      for (int r = 0; r < 32; ++r)
        acc[j][r] = acc[j][r] * corr[(r >> 1) & 1] + sc[r];
    }
    mbar_arrive(empty + s);
  }
  for (int i = my_items; i < n_items; ++i) {  // tiles no row here sees
    const int s = i % SLOTS;
    mbar_wait(full + s, (i / SLOTS) & 1);
    mbar_arrive(empty + s);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qpos = r0 + 8 * half;
    if (qpos >= Sq) continue;
    const float den = fmaxf(l[half], 1e-30f);
    float* orow = o + b * so.b + h * so.h + qpos * so.s;
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int col = j * COLS + g * 8 + (lane & 3) * 2;
        if (col < hd)
          *reinterpret_cast<float2*>(orow + col) =
              make_float2(acc[j][4 * g + 2 * half] / den,
                          acc[j][4 * g + 2 * half + 1] / den);
      }
  }
}

// x's planes into `planes` (the split pass, one launch), then its tensor
// map over them as (PLANES B, n, S, hd).
int split_and_map(CUtensorMap* map, Order* order, const void* x,
                  __nv_bfloat16* planes, int B, int n, int S, int hd,
                  const Strides& st, cudaStream_t stream) {
  const long long plane = static_cast<long long>(B) * n * S * hd;
  const dim3 grid((S * (hd / 8) + 255) / 256, n, B);
  split_planes<<<grid, 256, 0, stream>>>(static_cast<const float*>(x),
                                         planes, n, S, hd, st, plane);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides dense{static_cast<long long>(n) * S * hd,
                      static_cast<long long>(S) * hd, hd};
  const CUresult r =
      make_map(map, order, planes, PLANES * B, n, S, hd, dense);
  return r == CUDA_SUCCESS ? 0 : kMapError + static_cast<int>(r);
}

// One hd bucket's shape: NC 64-column boxes of hd, NWG consumer
// warpgroups, a ring of SLOTS slots; its threads and dynamic shared memory.
template <int NC_, int NWG_, int SLOTS_>
struct Shape {
  static constexpr int NC = NC_, NWG = NWG_, SLOTS = SLOTS_;
  static constexpr int THREADS = NWG * 128 + 32;
  static constexpr size_t SMEM =
      static_cast<size_t>(NWG + SLOTS) * PLANES * NC * CHUNK +
      (1 + 2 * SLOTS) * sizeof(uint64_t) + 1024;
};

// f(shape) for the shape of hd's bucket: every consumer warpgroup's Q
// planes and the K/V ring within the 227 KB a block may use.
template <class F>
int with_shape(int hd, F&& f) {
  if (hd <= 64) return f(Shape<1, 2, 4>());   // Q 48 KB + 4 slots of 24 KB
  if (hd <= 128) return f(Shape<2, 2, 2>());  // Q 96 KB + 2 slots of 48 KB
  if (hd <= 192) return f(Shape<3, 1, 2>());  // Q 72 KB + 2 slots of 72 KB
  return f(Shape<4, 1, 1>());  // Q 96 KB + 1 slot of 96 KB: K, V in turn
}

template <class S>
int launch_split3(const void* q, const void* k, const void* v, void* o,
                  void* work, int B, int H, int K, int Sq, int Sk, int hd,
                  int causal, int q_off, float scale, const Strides* st,
                  cudaStream_t stream) {
  __nv_bfloat16* wq = static_cast<__nv_bfloat16*>(work);
  __nv_bfloat16* wk = wq + PLANES * static_cast<long long>(B) * H * Sq * hd;
  __nv_bfloat16* wv = wk + PLANES * static_cast<long long>(B) * K * Sk * hd;
  CUtensorMap tq, tk, tv;
  Order oq, ok, ov;
  int err = split_and_map(&tq, &oq, q, wq, B, H, Sq, hd, st[0], stream);
  if (!err) err = split_and_map(&tk, &ok, k, wk, B, K, Sk, hd, st[1], stream);
  if (!err) err = split_and_map(&tv, &ov, v, wv, B, K, Sk, hd, st[2], stream);
  if (err) return err;
  auto* kernel = flash_attention_split3<S::NC, S::NWG, S::SLOTS>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::SMEM));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((Sq + S::NWG * ROWS - 1) / (S::NWG * ROWS), H, B);
  kernel<<<grid, S::THREADS, S::SMEM, stream>>>(
      tq, tk, tv, static_cast<float*>(o), st[3], oq, ok, ov, B, H / K, Sq,
      Sk, hd, causal, q_off, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hopper

namespace {

// strides: 12 element strides, (b, h, s) of q, k, v and o in that order
int check_args(int B, int H, int K, int Sq, int Sk, int hd, int q_off) {
  if (B < 1 || H < 1 || K < 1 || H % K != 0 || Sq < 1 || Sk < 1 ||
      q_off < 0 || hd < 8 || hd > 256 || hd % 8 != 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

void unpack(const long long* st, Strides (&out)[4]) {
  for (int i = 0; i < 4; ++i) out[i] = Strides{st[3 * i], st[3 * i + 1],
                                               st[3 * i + 2]};
}

}  // namespace

extern "C" {

// q (B, H, Sq, hd), k and v (B, K, Sk, hd), o like q; one dtype for all
// four. strides: 12 element strides, (b, h, s) of q, k, v and o in that
// order; the head axis is contiguous, every stride a multiple of 8 and
// every pointer 16-byte aligned (the wrapper checks). 8 <= hd <= 256,
// hd % 8 == 0, H % K == 0; q_off >= 0 is query row 0's position for the
// causal mask. fp32 also takes work, the scratch of the split planes
// (3 (B H Sq + 2 B K Sk) hd bf16 elements, 16-byte aligned). Returns
// cudaGetLastError() after the launch (or the error of a refused argument
// or attribute; 10000 + the CUresult of a refused tensor map).
int flash_attention_f32(const void* q, const void* k, const void* v,
                        void* o, void* work, int B, int H, int K, int Sq,
                        int Sk, int hd, int causal, int q_off, float scale,
                        const long long* strides, void* stream) {
  if (const int e = check_args(B, H, K, Sq, Sk, hd, q_off)) return e;
  Strides st[4];
  unpack(strides, st);
  return hopper::with_shape(hd, [&](auto shape) {
    return hopper::launch_split3<decltype(shape)>(
        q, k, v, o, work, B, H, K, Sq, Sk, hd, causal, q_off, scale, st,
        static_cast<cudaStream_t>(stream));
  });
}

// The fp32 form's launch plan for head dim hd: out[0..4] = threads per
// block, consumer warpgroups, K/V ring slots, 64-column boxes of hd,
// dynamic shared-memory bytes. Returns the error of a refused hd.
int flash_attention_f32_plan(int hd, int* out) {
  if (const int e = check_args(1, 1, 1, 1, 1, hd, 0)) return e;
  return hopper::with_shape(hd, [&](auto shape) {
    using S = decltype(shape);
    const int plan[5] = {S::THREADS, S::NWG, S::SLOTS, S::NC,
                         static_cast<int>(S::SMEM)};
    for (int i = 0; i < 5; ++i) out[i] = plan[i];
    return 0;
  });
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, int B, int H, int K, int Sq, int Sk,
                         int hd, int causal, int q_off, float scale,
                         const long long* strides, void* stream) {
  if (const int e = check_args(B, H, K, Sq, Sk, hd, q_off)) return e;
  Strides st[4];
  unpack(strides, st);
  return hopper::launch(q, k, v, o, B, H, K, Sq, Sk, hd, causal, q_off,
                        scale, st, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
