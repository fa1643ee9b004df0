// Ragged paged-attention decode for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py:_decode_kernel
// (entry paged_attention_fwd): one query token per sequence attends over the
// sequence's KV pages in a pool (n_pages, page_size, 2*Kv, hd) whose fused
// head axis interleaves K and V ([k0, v0, k1, v1, ...]), through a block
// table (S, max_pages) and per-sequence lengths, with an online softmax
// across pages and GQA by rep = H / Kv query heads per kv head.
//
// What bounds it on this card: bytes.  Every K and V row of every live
// position is read once from device memory and used for 2*rep*hd
// multiply-adds — far below the ~295 flop/byte at which the tensor cores
// would matter — so the least time is (KV bytes read) / (memory rate).
//
// What the design does about it: the TPU form runs one program per sequence
// behind a ring of page DMAs.  Here a block is one (sequence, kv head) pair
// (S*Kv blocks fill the SMs), a *thread group* of hd*sizeof(T)/16 lanes owns
// one position at a time and reads its K row and its V row as one 16-byte
// load per lane, and each group keeps kUnroll independent positions (K and V
// rows both) in flight so the loads overlap.  The longest sequence's block is
// the critical path (there is no split over the sequence yet), so a block has
// 256 threads: 16 groups at hd=128 in bf16, 32 iterations at 2048 positions.  A score is a lane-partial dot product finished by
// warp shuffles inside the group.  Every group keeps its own online-softmax
// state (m, l, acc) in f32 registers; groups are combined once, through
// shared memory, at the end.  A block reads tables[s, j] only for
// j < ceil(length / page_size): positions >= length are never loaded (their
// probability is a selected 0), so the trash page and unowned pages cannot
// reach the output.  K and V rows of one kv head are strided by 2*Kv*hd
// elements inside a page; all offsets come from the strides passed in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;

template <typename T>
struct Vec16;  // one 16-byte load of T, widened to float

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  using Raw = float4;
  static __device__ __forceinline__ Raw load_raw(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void widen(const Raw& v, float* out) {
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  static __device__ __forceinline__ float store(float x) { return x; }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  using Raw = uint4;
  static __device__ __forceinline__ Raw load_raw(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ void widen(const Raw& raw, float* out) {
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

// T: element type; HD: head dim; R: query heads of the kv group handled per
// pass (rep is covered in ceil(rep / R) passes, heads past rep masked).
template <typename T, int HD, int R>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ pool,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int rep, int page_size, int max_pages,
                    long long q_ss, long long q_sh, long long p_sp,
                    long long p_st, long long p_sh, long long o_ss,
                    long long o_sh, float sm_scale) {
  constexpr int VEC = Vec16<T>::N;
  constexpr int TG = HD / VEC;       // lanes that share one position
  constexpr int NG = kThreads / TG;  // thread groups in the block
  static_assert(TG >= 1 && TG <= 32 && (TG & (TG - 1)) == 0, "group size");

  __shared__ float s_acc[NG][R][HD];
  __shared__ float s_m[NG][R];
  __shared__ float s_l[NG][R];

  const int s = blockIdx.x;
  const int g = blockIdx.y;
  const int tid = threadIdx.x;
  const int gid = tid / TG;
  const int lane = tid % TG;
  // a length past the table's reach would index the table out of bounds
  const int length = min(lengths[s], max_pages * page_size);
  const int* table = tables + static_cast<long long>(s) * max_pages;
  const int n_iter = (length + NG * kUnroll - 1) / (NG * kUnroll);

  for (int r0 = 0; r0 < rep; r0 += R) {
    float qf[R][VEC];
    float acc[R][VEC];
    float m[R], l[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) { acc[i][e] = 0.f; qf[i][e] = 0.f; }
      if (r0 + i < rep) {
        const int h = g * rep + r0 + i;
        Vec16<T>::widen(
            Vec16<T>::load_raw(q + s * q_ss + h * q_sh + lane * VEC), qf[i]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) qf[i][e] *= sm_scale;
      }
    }

    for (int it = 0; it < n_iter; ++it) {
      const int base = it * NG * kUnroll;
      bool valid[kUnroll];
      typename Vec16<T>::Raw vraw[kUnroll];  // V rows, in flight early
      float sc[R][kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = base + u * NG + gid;
        valid[u] = t < length;
        float kf[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[e] = 0.f;
        if (valid[u]) {
          const int page = table[t / page_size];
          const int off = t % page_size;
          const T* kp = pool + page * p_sp + off * p_st + (2 * g) * p_sh +
                        lane * VEC;
          Vec16<T>::widen(Vec16<T>::load_raw(kp), kf);
          vraw[u] = Vec16<T>::load_raw(kp + p_sh);
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) d += qf[i][e] * kf[e];
          sc[i][u] = d;
        }
      }
      // finish the dot products across the group's lanes (uniform trip
      // count: every lane of the warp reaches every shuffle)
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
          for (int o = TG / 2; o > 0; o >>= 1)
            sc[i][u] += __shfl_xor_sync(0xffffffffu, sc[i][u], o);
        }
      }
      float p[R][kUnroll];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float m_new = m[i];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (valid[u]) m_new = fmaxf(m_new, sc[i][u]);
        const float alpha = expf(m[i] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          p[i][u] = valid[u] ? expf(sc[i][u] - m_new) : 0.f;
          psum += p[i][u];
        }
        l[i] = l[i] * alpha + psum;
        m[i] = m_new;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[i][e] *= alpha;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (valid[u]) {
          float vf[VEC];
          Vec16<T>::widen(vraw[u], vf);
#pragma unroll
          for (int i = 0; i < R; ++i) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[i][e] += p[i][u] * vf[e];
          }
        }
      }
    }

    // combine the groups' partial softmax states
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (lane == 0) {
        s_m[gid][i] = m[i];
        s_l[gid][i] = l[i];
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) s_acc[gid][i][lane * VEC + e] = acc[i][e];
    }
    __syncthreads();
    for (int idx = tid; idx < R * HD; idx += kThreads) {
      const int i = idx / HD;
      const int d = idx % HD;
      if (r0 + i < rep) {
        float mx = kNegInf;
        for (int gg = 0; gg < NG; ++gg) mx = fmaxf(mx, s_m[gg][i]);
        float lsum = 0.f, a = 0.f;
        for (int gg = 0; gg < NG; ++gg) {
          const float w = expf(s_m[gg][i] - mx);
          lsum += s_l[gg][i] * w;
          a += s_acc[gg][i][d] * w;
        }
        const int h = g * rep + r0 + i;
        out[s * o_ss + h * o_sh + d] =
            Vec16<T>::store(a / fmaxf(lsum, 1e-30f));
      }
    }
    __syncthreads();
  }
}

template <typename T, int HD, int R>
int launch(const void* q, const void* pool, const int* tables,
           const int* lengths, void* out, int S, int Kv, int rep,
           int page_size, int max_pages, long long q_ss, long long q_sh,
           long long p_sp, long long p_st, long long p_sh, long long o_ss,
           long long o_sh, float sm_scale, cudaStream_t stream) {
  const dim3 grid(S, Kv);
  paged_decode_kernel<T, HD, R><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool), tables, lengths,
      static_cast<T*>(out), rep, page_size, max_pages, q_ss, q_sh, p_sp, p_st,
      p_sh, o_ss, o_sh, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_rep(const void* q, const void* pool, const int* tables,
               const int* lengths, void* out, int S, int Kv, int rep,
               int page_size, int max_pages, long long q_ss, long long q_sh,
               long long p_sp, long long p_st, long long p_sh, long long o_ss,
               long long o_sh, float sm_scale, cudaStream_t stream) {
#define PAGED_ARGS                                                          \
  q, pool, tables, lengths, out, S, Kv, rep, page_size, max_pages, q_ss,    \
      q_sh, p_sp, p_st, p_sh, o_ss, o_sh, sm_scale, stream
  if (rep == 1) return launch<T, HD, 1>(PAGED_ARGS);
  if (rep == 2) return launch<T, HD, 2>(PAGED_ARGS);
  return launch<T, HD, 4>(PAGED_ARGS);
}

template <typename T>
int launch_hd(int hd, const void* q, const void* pool, const int* tables,
              const int* lengths, void* out, int S, int Kv, int rep,
              int page_size, int max_pages, long long q_ss, long long q_sh,
              long long p_sp, long long p_st, long long p_sh, long long o_ss,
              long long o_sh, float sm_scale, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_rep<T, 16>(PAGED_ARGS);
    case 32: return launch_rep<T, 32>(PAGED_ARGS);
    case 64: return launch_rep<T, 64>(PAGED_ARGS);
    case 128: return launch_rep<T, 128>(PAGED_ARGS);
    default: return -1;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// shape the kernel does not take.  Strides are in elements.
extern "C" int paged_attention_decode(
    const void* q, const void* pool, const void* tables_ptr,
    const void* lengths_ptr, void* out, int S, int H, int Kv, int hd,
    int page_size, int max_pages,
    long long q_ss, long long q_sh, long long p_sp, long long p_st,
    long long p_sh, long long o_ss, long long o_sh, float sm_scale,
    int is_bf16, void* stream_ptr) {
  if (S <= 0 || Kv <= 0 || H % Kv != 0 || page_size <= 0 || max_pages <= 0 ||
      Kv > 65535)
    return -1;
  const int rep = H / Kv;
  const int* tables = static_cast<const int*>(tables_ptr);
  const int* lengths = static_cast<const int*>(lengths_ptr);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (is_bf16) return launch_hd<__nv_bfloat16>(hd, PAGED_ARGS);
  return launch_hd<float>(hd, PAGED_ARGS);
}
