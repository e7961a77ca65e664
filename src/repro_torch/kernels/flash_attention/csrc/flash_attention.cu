// Causal GQA flash attention, forward only, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` in
// src/repro/kernels/flash_attention/flash_attention.py (launched by
// `flash_attention`, reached through `ops.mha`). It computes that function:
//
//   s    = (q . k^T) * (1/sqrt(hd))                  fp32 (inputs cast)
//   s    = NEG_INF = -1e30 where kpos > qpos         (causal; both from 0)
//   m, l, acc: the online softmax over key tiles, fp32
//   acc += exp(s - m) . v                           p and v in fp32
//   o    = acc / max(l, 1e-30)                       in q's type
//
// with the KV head h / rep for query head h (K and V are never repeated).
// The mask is aligned to the START, as the Pallas kernel's: query i sees
// keys 0..i whatever Sk is, which is the prefill's attention over a deeper
// zeroed cache (repro's oracle `attention_ref` aligns it to the end; the
// two agree only at Sq == Sk).
//
// Design (a simple, correct first version; the TPU grid is not carried
// over): one block of 256 threads per (64-row query tile, head, batch
// row), heaviest causal tiles scheduled first. The block stages its query
// tile in shared memory as fp32 once, then walks the key tiles 0 .. the
// last one the causal mask leaves visible (the loop replaces the Pallas
// kernel's `pl.when(run)`, and the zeroed cache tail beyond the prompt is
// never read). Per 64-key tile: K staged in shared memory, each thread
// forms a 4 x 4 patch of scores with fp32 FMAs over float4 reads (rows
// padded by 4 floats, so the reads are conflict-free), the row max and
// sum go through 16-lane shuffles, p goes to shared memory, V is staged
// into the K buffer, and each thread accumulates p . v for its 4 rows x
// 4*NJ columns in registers. Ragged Sq and Sk are masked in the kernel:
// keys beyond Sk score NEG_INF and read as zeros, rows beyond Sq are not
// written. Inputs are read with 16-byte vector loads, so the wrapper
// requires the head axis contiguous, every other stride a multiple of 8
// elements and 16-byte aligned base pointers.
//
// What bounds it on the H100: operations. At the prefill's shapes (B 4,
// H 48 over K 4, Sq 2048, Sk 2176, hd 128) the visible (q, k) pairs are
// B.H.sum_i(i+1) = 4.03e8, 4.hd operations each: 2.06e11, 0.21 ms at
// 989 TFLOP/s bf16; its bytes (q, the visible k and v prefix once per KV
// head, o) are 1.3e8 B in bf16, 0.04 ms at 3.35 TB/s. This version runs
// both products on the fp32 pipes (67 TFLOP/s), so it cannot come nearer
// than ~3 ms; tensor-core products (wgmma for q.k^T, whose bf16 products
// are exact in fp32; p.v needs fp32 p) are later work. Measured on an
// H100 80GB HBM3 (700 W) at those shapes (chip_smoke.py phase 10a):
// 7.70 ms in bf16 and 7.87 ms in fp32 (~26.5 TFLOP/s), 37x the bound;
// PyTorch's SDPA takes 0.37 ms for the same bf16 call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per tile
constexpr int THREADS = 256;   // 16 x 16: ty picks rows, tx columns
constexpr int PAD = 4;         // floats of padding per staged row
constexpr int LDP = BK + PAD;  // row stride of the p tile
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, h, s;  // element strides of axes 0-2; axis 3 is contiguous
};

// 8 consecutive elements (16 B of bf16, 32 B of fp32) as fp32
__device__ __forceinline__ void load8(const float* p, float4& a, float4& b) {
  a = __ldg(reinterpret_cast<const float4*>(p));
  b = __ldg(reinterpret_cast<const float4*>(p) + 1);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float4& a,
                                      float4& b) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 x = __bfloat1622float2(h[0]), y = __bfloat1622float2(h[1]);
  const float2 z = __bfloat1622float2(h[2]), w = __bfloat1622float2(h[3]);
  a = make_float4(x.x, x.y, y.x, y.y);
  b = make_float4(z.x, z.y, w.x, w.y);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// rows [row0, row0 + 64) of a (rows, hd) matrix with row stride `ld`
// into shared memory as fp32 (row stride hd + PAD); rows >= n as zeros
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, long long ld,
                                      int row0, int n, int hd) {
  const int ldq = hd + PAD;
  const int chunks = hd / 8;
  for (int c = threadIdx.x; c < 64 * chunks; c += THREADS) {
    const int r = c / chunks;
    const int d = (c - r * chunks) * 8;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (row0 + r < n) load8(src + (row0 + r) * ld + d, a, b);
    float4* out = reinterpret_cast<float4*>(dst + r * ldq + d);
    out[0] = a;
    out[1] = b;
  }
}

__device__ __forceinline__ float row_max16(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// NJ: float4 column groups per thread; columns 4 tx + 64 j (j < NJ), so
// hd <= 64 NJ
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           int rep, int Sq, int Sk, int hd, int causal,
                           float scale, Strides sq, Strides sk, Strides sv,
                           Strides so) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldq = hd + PAD;
  float* Qs = smem;              // BQ x ldq
  float* KVs = Qs + BQ * ldq;    // BK x ldq: the K tile, then the V tile
  float* Ps = KVs + BK * ldq;    // BQ x LDP

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / rep;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;

  stage(Qs, qb, sq.s, q0, Sq, hd);

  float m[4], l[4], acc[4][NJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  // the last key the causal mask leaves visible to this tile is q0 + 63
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // Q staged; the previous tile's p and V reads done
    stage(KVs, kb, sk.s, k0, Sk, hd);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * ldq + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(KVs + (tx + 16 * j) * ldq + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < Sk && (!causal || kpos <= qpos);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[r * LDP + tx + 16 * j] = p;
        rs += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] *= corr;
    }
    __syncthreads();  // every K read done, every p written
    stage(KVs, vb, sv.s, k0, Sk, hd);
    __syncthreads();

    for (int c = 0; c < BK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * LDP + c);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = 4 * tx + 64 * j;
        if (d < hd) {
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const float4 vv =
                *reinterpret_cast<const float4*>(KVs + (c + cc) * ldq + d);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float p = cc == 0   ? pv[i].x
                              : cc == 1 ? pv[i].y
                              : cc == 2 ? pv[i].z
                                        : pv[i].w;
              acc[i][j][0] = fmaf(p, vv.x, acc[i][j][0]);
              acc[i][j][1] = fmaf(p, vv.y, acc[i][j][1]);
              acc[i][j][2] = fmaf(p, vv.z, acc[i][j][2]);
              acc[i][j][3] = fmaf(p, vv.w, acc[i][j][3]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + b * so.b + h * so.h + qpos * so.s;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = 4 * tx + 64 * j;
      if (d < hd) {
#pragma unroll
        for (int e = 0; e < 4; ++e) store(orow + d + e, acc[i][j][e] / den);
      }
    }
  }
}

size_t smem_bytes(int hd) {
  return sizeof(float) *
         (static_cast<size_t>(BQ + BK) * (hd + PAD) + BQ * LDP);
}

template <typename T, int NJ>
int launch_nj(const void* q, const void* k, const void* v, void* o, int B,
              int H, int K, int Sq, int Sk, int hd, int causal, float scale,
              Strides sq, Strides sk, Strides sv, Strides so,
              cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, NJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T, NJ><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H / K, Sq, Sk, hd,
      causal, scale, sq, sk, sv, so);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int K, int Sq, int Sk, int hd, int causal, float scale,
           const long long* st, void* stream) {
  if (B < 1 || H < 1 || K < 1 || H % K != 0 || Sq < 1 || Sk < 1 ||
      hd < 8 || hd > 256 || hd % 8 != 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]};
  const Strides sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 64)
    return launch_nj<T, 1>(q, k, v, o, B, H, K, Sq, Sk, hd, causal, scale,
                           sq, sk, sv, so, s);
  if (hd <= 128)
    return launch_nj<T, 2>(q, k, v, o, B, H, K, Sq, Sk, hd, causal, scale,
                           sq, sk, sv, so, s);
  return launch_nj<T, 4>(q, k, v, o, B, H, K, Sq, Sk, hd, causal, scale, sq,
                         sk, sv, so, s);
}

}  // namespace

extern "C" {

// q (B, H, Sq, hd), k and v (B, K, Sk, hd), o like q; one dtype for all
// four (fp32 or bf16). strides: 12 element strides, (b, h, s) of q, k, v
// and o in that order; the head axis is contiguous, every stride a
// multiple of 8 and every pointer 16-byte aligned (the wrapper checks).
// 8 <= hd <= 256, hd % 8 == 0, H % K == 0. Returns cudaGetLastError()
// after the launch (or the error of a refused argument or attribute).
int flash_attention_f32(const void* q, const void* k, const void* v,
                        void* o, int B, int H, int K, int Sq, int Sk, int hd,
                        int causal, float scale, const long long* strides,
                        void* stream) {
  return launch<float>(q, k, v, o, B, H, K, Sq, Sk, hd, causal, scale,
                       strides, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, int B, int H, int K, int Sq, int Sk,
                         int hd, int causal, float scale,
                         const long long* strides, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, H, K, Sq, Sk, hd, causal,
                               scale, strides, stream);
}

}  // extern "C"
