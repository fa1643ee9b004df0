// FlashAttention-2 forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:_fwd_kernel (entry
// flash_attention_fwd): causal and/or sliding-window attention with GQA over
// q (B,S,H,hd), k/v (B,S,Kv,hd), f32 online-softmax carry (acc, m, l), a
// ragged sequence tail and a guard for key blocks a row cannot see.
//
// What bounds it on this card: operations (4*S^2*hd per head, half of that
// under a causal mask) once S is a few hundred; at short S the bytes of q, k,
// v and out.  This first kernel does its two products with f32 FMAs on the
// CUDA cores, for f32 and bf16 inputs alike (f32 inputs must not go through
// TF32), so it sits far from the bf16 tensor-core bound; mma/wgmma is the
// next step for the bf16 path.
//
// What the design does about it: the TPU form pads S, transposes to
// (B*H, Sp, hd) and puts the kv blocks on a sequential grid axis with the
// carry in scratch.  Here a block owns 64 query rows of one (batch, head) and
// loops over the key blocks itself, so the carry lives in registers and
// nothing crosses blocks.  The (B,S,H,hd) layout is read through its strides
// (kv head = h / rep, no transpose, no repeat); K and V tiles are staged in
// shared memory as f32; key blocks wholly above the diagonal or wholly
// outside the window are never visited; the ragged tail is masked in the
// kernel (kpos < S on keys, qpos < S on the store) with no padded copy.
// 256 threads form a 16x16 grid: thread (ty, tx) owns score rows ty+16*i and
// columns tx+16*j (interleaved, so padded shared rows are read without bank
// conflicts), row statistics are reduced by shuffles over the 16 tx lanes,
// and probabilities go through shared memory (aliased over the K tile) for
// the second product.  At hd=128 the tiles take 98 KB, above the 48 KB
// static limit, so shared memory is dynamic and opted in with
// cudaFuncSetAttribute; the launch is followed by cudaGetLastError.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPS = kBK + 1;   // row stride of the probability tile

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int VEC = 4;  // elements per 16-byte load
  static __device__ __forceinline__ void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  static __device__ __forceinline__ float store(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int VEC = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16(x);
  }
};

template <int HD>
struct Tiles {
  static constexpr int QS = HD + 4;  // padded row stride of the Q and K tiles
  static constexpr int kRegion =
      (kBK * QS > kBQ * kPS) ? kBK * QS : kBQ * kPS;  // K tile, then P tile
  static constexpr int kFloats = kBQ * QS + kRegion + kBK * HD;
  static constexpr int kBytes = kFloats * static_cast<int>(sizeof(float));
};

// Stage `rows` x HD elements starting at sequence position pos0 into shared
// memory as f32 (rows at positions >= S are zero), scaled by `scale`.
template <typename T, int HD>
__device__ __forceinline__ void stage_tile(const T* __restrict__ base,
                                           long long stride_s, int pos0,
                                           int S, float scale,
                                           float* __restrict__ dst,
                                           int dst_stride, int tid) {
  constexpr int VEC = Elem<T>::VEC;
  constexpr int CPR = HD / VEC;  // 16-byte chunks per row
  for (int idx = tid; idx < kBK * CPR; idx += kThreads) {
    const int row = idx / CPR;
    const int c = idx % CPR;
    float f[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) f[e] = 0.f;
    const int pos = pos0 + row;
    if (pos < S) {
      Elem<T>::load(base + pos * stride_s + c * VEC, f);
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] *= scale;
    }
    float* d = dst + row * dst_stride + c * VEC;
#pragma unroll
    for (int e = 0; e < VEC; e += 4)
      *reinterpret_cast<float4*>(d + e) =
          make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int H,
                 int rep, int n_qb, long long q_sb, long long q_ss,
                 long long q_sh, long long k_sb, long long k_ss,
                 long long k_sh, long long v_sb, long long v_ss,
                 long long v_sh, long long o_sb, long long o_ss,
                 long long o_sh, float sm_scale, int causal, int window) {
  static_assert(kBQ == kBK, "stage_tile stages kBK rows for Q as well");
  constexpr int QS = Tiles<HD>::QS;
  constexpr int DPT = HD / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * QS;
  float* Ps = Ks;  // aliases the K tile once the scores are in registers
  float* Vs = Ks + Tiles<HD>::kRegion;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  // the last (heaviest, under a causal mask) query blocks are scheduled first
  const int qb = n_qb - 1 - static_cast<int>(blockIdx.x % n_qb);
  const int bh = blockIdx.x / n_qb;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / rep;
  const int q0 = qb * kBQ;

  const T* qbase = q + b * q_sb + h * q_sh;
  const T* kbase = k + b * k_sb + kvh * k_sh;
  const T* vbase = v + b * v_sb + kvh * v_sh;

  stage_tile<T, HD>(qbase, q_ss, q0, S, sm_scale, Qs, QS, tid);

  float acc[4][DPT];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPT; ++e) acc[i][e] = 0.f;
  }

  // key blocks this query block can see
  int kb_lo = 0;
  int kb_hi = (S + kBK - 1) / kBK;
  if (causal) {
    const int q_last = min(q0 + kBQ, S) - 1;
    kb_hi = min(kb_hi, q_last / kBK + 1);
  }
  if (window > 0) {
    const int k_first = q0 - window + 1;
    if (k_first > 0) kb_lo = k_first / kBK;
  }

  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();  // the previous tile's P and V are consumed
    stage_tile<T, HD>(kbase, k_ss, k0, S, 1.f, Ks, QS, tid);
    stage_tile<T, HD>(vbase, v_ss, k0, S, 1.f, Vs, HD, tid);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * QS + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * QS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sc[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y +
                      qv[i].z * kv[j].z + qv[i].w * kv[j].w;
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool ok[4];
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < S;
        if (causal) ok[j] = ok[j] && (kpos <= qpos);
        if (window > 0) ok[j] = ok[j] && (kpos > qpos - window);
        if (ok[j]) row_max = fmaxf(row_max, sc[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, o));
      const float m_new = fmaxf(m[i], row_max);
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        row_sum += p[i][j];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, o);
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < DPT; ++e) acc[i][e] *= alpha;
    }

    __syncthreads();  // every thread is done reading the K tile
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(ty + 16 * i) * kPS + tx + 16 * j] = p[i][j];
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * kPS + j];
      if constexpr (DPT % 4 == 0) {
#pragma unroll
        for (int c = 0; c < DPT / 4; ++c) {
          const float4 vv =
              *reinterpret_cast<const float4*>(Vs + j * HD + c * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][c * 4 + 0] += pv[i] * vv.x;
            acc[i][c * 4 + 1] += pv[i] * vv.y;
            acc[i][c * 4 + 2] += pv[i] * vv.z;
            acc[i][c * 4 + 3] += pv[i] * vv.w;
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < DPT; ++e) {
          const float vv = Vs[j * HD + tx * DPT + e];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][e] += pv[i] * vv;
        }
      }
    }
  }

  T* obase = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos < S) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int e = 0; e < DPT; ++e) {
        const int d = (DPT % 4 == 0) ? (e / 4) * 64 + tx * 4 + (e % 4)
                                     : tx * DPT + e;
        obase[qpos * o_ss + d] = Elem<T>::store(acc[i][e] / denom);
      }
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, int rep, const long long* st, float sm_scale,
           int causal, int window, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, HD>;
  constexpr int bytes = Tiles<HD>::kBytes;
  // opt in to more than 48 KB of dynamic shared memory (per device, cheap)
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qb = (S + kBQ - 1) / kBQ;
  const long long n_blocks = static_cast<long long>(n_qb) * B * H;
  if (n_blocks > 2147483647LL) return -1;
  kern<<<static_cast<unsigned>(n_blocks), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, rep, n_qb, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], sm_scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* out,
              int B, int S, int H, int rep, const long long* st,
              float sm_scale, int causal, int window, cudaStream_t stream) {
#define FLASH_ARGS q, k, v, out, B, S, H, rep, st, sm_scale, causal, window, stream
  switch (hd) {
    case 16: return launch<T, 16>(FLASH_ARGS);
    case 32: return launch<T, 32>(FLASH_ARGS);
    case 64: return launch<T, 64>(FLASH_ARGS);
    case 128: return launch<T, 128>(FLASH_ARGS);
    default: return -1;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// shape the kernel does not take.  Strides are in elements, (batch, seq,
// head) for each of q, k, v, out; the hd axis is dense.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, int B, int S,
    int H, int Kv, int hd, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, float sm_scale, int causal, int window, int is_bf16,
    void* stream_ptr) {
  if (B <= 0 || S <= 0 || Kv <= 0 || H % Kv != 0 || window < 0) return -1;
  const int rep = H / Kv;
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (is_bf16) return launch_hd<__nv_bfloat16>(hd, FLASH_ARGS);
  return launch_hd<float>(hd, FLASH_ARGS);
}
