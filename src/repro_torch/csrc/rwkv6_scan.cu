// Chunked WKV-6 scan (RWKV-6 "Finch" time mix) for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py:_wkv_kernel (entry
// rwkv6_scan_fwd).  Per (batch, head) and chunk of L <= 64 steps, with
// lw = log(max(w, 1e-12)) and cl its running sum over the chunk (inclusive):
//   r_d = r * exp(cl - lw),  k_d = k * exp(min(-cl, 30))
//   y   = tril_strict(r_d k_d^T) v + r_d S + sum(r * u * k) v
//   S  <- exp(dl)^T * S + k_end^T v,  dl = cl[L-1],  k_end = k * exp(min(dl - cl, 30))
// with the reference's clip constant, floor and order of rescaling.  Inputs
// and outputs are f32; every product is an f32 FMA on the CUDA cores (no
// TF32: the reference's tolerance for the scan is 1e-3, and TF32's ~1e-3
// relative error on each product would use it up).
//
// What bounds it on this card, at the serving path's prefill shape B=1,
// T=1024, H=64, dh=64, chunk 64: 85,999,616 bytes (r, k, v, w read, u and s0
// read, y and S_T written) take 25.7 us at 3.35 TB/s; 1,602,224,128
// operations (B*H*T*2*dh*(L - 1 + 2*dh): the strictly causal scores and
// scores @ v over L*(L-1)/2 pairs, 2*dh each, and r_d @ S and the state
// update, 2*L*dh*dh each a chunk) take 23.9 us at the 67 TFLOP/s f32
// CUDA-core peak (H100 SXM data sheet).  So it is bound by the bytes, with
// the operations close behind (93% of the bytes' time): f32 FMAs on the CUDA
// cores could reach the bound only if no product were done twice and they
// overlapped the loads fully; tensor cores (TF32 or split bf16 with an
// argued tolerance) would leave room for both, and are a later step.
//
// What the design does about it: the TPU form transposes to (B*H, T, dh) and
// walks the chunks on a sequential grid axis with S in VMEM scratch.  Here a
// loop over chunks inside one block takes the place of that axis, S stays in
// shared memory, and r, k, v, w, y are read and written straight from the
// (B,T,H,dh) layout through their strides (no transpose).  The value columns
// of S are independent (y[:, e] needs only S[:, e] and v[:, e], and so does
// the update of S[:, e]), so the grid is (B*H, dh/16): each block owns 16
// value columns of one head.  That gives 256 blocks at B=1, H=64 (against 64
// with one block a head on 132 SMs) without any cross-block reduction, at the
// cost of recomputing the L x L scores in each column tile — about 1.75x the
// FMAs of one block a head at dh=64, traded for 4x the blocks in flight.
// Within a chunk: the running log-decay sum is one thread per key channel;
// the scores are a 16x16 thread grid, each thread 4x4 entries at rows ty+16i,
// columns tx+16j (padded rows read without bank conflicts); y and the state
// update are one value column a thread.  Rows past a ragged chunk's end are
// staged as zeros and never stored.  At dh=64 the tiles take 75.5 KB, above
// the 48 KB static limit, so shared memory is dynamic and opted in with
// cudaFuncSetAttribute; the launch is followed by cudaGetLastError.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kClip = 30.f;     // exponent clip of the 1/decay rescale
constexpr float kFloor = 1e-12f;  // w floor before the log
constexpr int kMaxL = 64;         // longest chunk
constexpr int kCT = 16;           // value columns a block owns
constexpr int kThreads = 256;     // 16 x 16

// (batch, time, head) strides in elements of r, k, v, w and y, in that order
struct Strides {
  long long b[5], t[5], h[5];
};

template <int DH>
struct Smem {
  static constexpr int RS = DH + 1;     // padded row stride of L x DH tiles
  static constexpr int SS = kMaxL + 1;  // padded row stride of the scores
  static constexpr int kFloats =
      3 * kMaxL * RS   // r -> r_d;  k -> k_d;  w -> cl -> k_end
      + kMaxL * SS     // strictly lower scores
      + kMaxL * kCT    // v, this block's columns
      + DH * kCT       // S, this block's columns
      + kMaxL          // bonus sum(r * u * k) a row
      + DH             // u of this head
      + DH;            // exp(dl), the chunk's total decay a key channel
  static constexpr int kBytes = kFloats * static_cast<int>(sizeof(float));
};

// Stage rows [t0, t0 + L) of one head of a (B,T,H,DH) tensor into a padded
// kMaxL x DH tile (rows >= L are zero).
template <int DH>
__device__ __forceinline__ void stage(const float* __restrict__ base,
                                      long long st, int t0, int L,
                                      float* __restrict__ dst, int tid) {
  constexpr int C4 = DH / 4;  // 16-byte chunks a row
  for (int idx = tid; idx < kMaxL * C4; idx += kThreads) {
    const int row = idx / C4;
    const int c = (idx % C4) * 4;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < L)
      f = *reinterpret_cast<const float4*>(base + (t0 + row) * st + c);
    float* d = dst + row * Smem<DH>::RS + c;
    d[0] = f.x; d[1] = f.y; d[2] = f.z; d[3] = f.w;
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ sT, int T, int H,
            int L, Strides st) {
  constexpr int RS = Smem<DH>::RS;
  constexpr int SS = Smem<DH>::SS;
  extern __shared__ __align__(16) float smem[];
  float* Rs = smem;               // r, then r_d
  float* Ks = Rs + kMaxL * RS;    // k, then k_d
  float* Ws = Ks + kMaxL * RS;    // w, then cl, then k_end
  float* Ps = Ws + kMaxL * RS;    // scores
  float* Vs = Ps + kMaxL * SS;    // v columns
  float* Ss = Vs + kMaxL * kCT;   // S columns
  float* bonus = Ss + DH * kCT;
  float* us = bonus + kMaxL;
  float* decay = us + DH;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int e0 = blockIdx.y * kCT;

  const float* rb = r + b * st.b[0] + h * st.h[0];
  const float* kb = k + b * st.b[1] + h * st.h[1];
  const float* vb = v + b * st.b[2] + h * st.h[2] + e0;
  const float* wb = w + b * st.b[3] + h * st.h[3];
  float* yb = y + b * st.b[4] + h * st.h[4] + e0;
  const long long s_off = static_cast<long long>(bh) * DH * DH + e0;

  for (int i = tid; i < DH; i += kThreads) us[i] = u[h * DH + i];
  for (int idx = tid; idx < DH * kCT; idx += kThreads) {
    const int d = idx / kCT;
    const int e = idx % kCT;
    Ss[d * kCT + e] = s0[s_off + d * DH + e];
  }

  const int n_chunks = T / L;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * L;
    stage<DH>(rb, st.t[0], t0, L, Rs, tid);
    stage<DH>(kb, st.t[1], t0, L, Ks, tid);
    stage<DH>(wb, st.t[3], t0, L, Ws, tid);
    for (int idx = tid; idx < kMaxL * kCT; idx += kThreads) {
      const int row = idx / kCT;
      const int e = idx % kCT;
      Vs[idx] = row < L ? vb[(t0 + row) * st.t[2] + e] : 0.f;
    }
    __syncthreads();  // tiles staged (and, at c = 0, u and S)

    // bonus sum(r * u * k) over the key channels, one thread a row
    if (tid < L) {
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d)
        acc += (Rs[tid * RS + d] * us[d]) * Ks[tid * RS + d];
      bonus[tid] = acc;
    }
    __syncthreads();  // raw r and k are consumed

    // running log-decay sum along time, one thread a key channel
    if (tid < DH) {
      const int d = tid;
      float cl = 0.f;
      for (int t = 0; t < L; ++t) {
        const float lw = logf(fmaxf(Ws[t * RS + d], kFloor));
        cl += lw;
        Rs[t * RS + d] *= expf(cl - lw);
        Ws[t * RS + d] = cl;
      }
      const float dl = cl;
      decay[d] = expf(dl);
      for (int t = 0; t < L; ++t) {
        const float c_t = Ws[t * RS + d];
        const float kk = Ks[t * RS + d];
        Ks[t * RS + d] = kk * expf(fminf(-c_t, kClip));
        Ws[t * RS + d] = kk * expf(fminf(dl - c_t, kClip));
      }
    }
    __syncthreads();  // r_d, k_d, k_end, decay ready

    // strictly causal scores r_d k_d^T (rows and columns >= L are zero)
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DH; ++d) {
        float a[4], bk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Rs[(ty + 16 * i) * RS + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * RS + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * bk[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int li = ty + 16 * i;
          const int mi = tx + 16 * j;
          Ps[li * SS + mi] = li > mi ? acc[i][j] : 0.f;
        }
    }
    __syncthreads();  // scores ready

    // y = scores @ v + r_d @ S + bonus * v, one value column a thread
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int li = ty + 16 * i;
      if (li < L) {
        float sv = 0.f;
        for (int m = 0; m < L; ++m) sv += Ps[li * SS + m] * Vs[m * kCT + tx];
        float rs = 0.f;
#pragma unroll 8
        for (int d = 0; d < DH; ++d) rs += Rs[li * RS + d] * Ss[d * kCT + tx];
        yb[(t0 + li) * st.t[4] + tx] =
            (sv + rs) + bonus[li] * Vs[li * kCT + tx];
      }
    }
    __syncthreads();  // every read of the old S is done

    // S <- exp(dl)^T * S + k_end^T v, one (key channel, value column) a
    // thread and pass
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = ty + 16 * i;
      if (d < DH) {
        float kv = 0.f;
        for (int t = 0; t < L; ++t) kv += Ws[t * RS + d] * Vs[t * kCT + tx];
        Ss[d * kCT + tx] = decay[d] * Ss[d * kCT + tx] + kv;
      }
    }
    __syncthreads();  // S updated; the tiles may be overwritten
  }

  for (int idx = tid; idx < DH * kCT; idx += kThreads) {
    const int d = idx / kCT;
    const int e = idx % kCT;
    sT[s_off + d * DH + e] = Ss[d * kCT + e];
  }
}

template <int DH>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* y, float* sT, int B,
           int T, int H, int L, const Strides& st, cudaStream_t stream) {
  auto kern = wkv6_kernel<DH>;
  constexpr int bytes = Smem<DH>::kBytes;
  // opt in to more than 48 KB of dynamic shared memory (per device, cheap)
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_bh = static_cast<long long>(B) * H;
  if (n_bh > 2147483647LL) return -1;
  const dim3 grid(static_cast<unsigned>(n_bh), DH / kCT);
  kern<<<grid, kThreads, bytes, stream>>>(r, k, v, w, u, s0, y, sT, T, H, L,
                                          st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched), or -1 for a
// shape the kernel does not take.  r, k, v, w, y are (B,T,H,dh) with a dense
// dh axis, rows 16-byte aligned, and (batch, time, head) strides in
// elements; u (H,dh) and s0, sT (B,H,dh,dh) are dense.  The chunk is
// 1..64 steps and divides T.
extern "C" int rwkv6_scan_fwd(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* s0, void* y, void* sT, int B, int T, int H,
    int dh, int chunk, long long r_sb, long long r_st, long long r_sh,
    long long k_sb, long long k_st, long long k_sh, long long v_sb,
    long long v_st, long long v_sh, long long w_sb, long long w_st,
    long long w_sh, long long y_sb, long long y_st, long long y_sh,
    void* stream_ptr) {
  if (B <= 0 || T <= 0 || H <= 0 || chunk < 1 || chunk > kMaxL ||
      T % chunk != 0)
    return -1;
  const Strides st = {{r_sb, k_sb, v_sb, w_sb, y_sb},
                      {r_st, k_st, v_st, w_st, y_st},
                      {r_sh, k_sh, v_sh, w_sh, y_sh}};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define WKV_ARGS                                                          \
  static_cast<const float*>(r), static_cast<const float*>(k),             \
      static_cast<const float*>(v), static_cast<const float*>(w),         \
      static_cast<const float*>(u), static_cast<const float*>(s0),        \
      static_cast<float*>(y), static_cast<float*>(sT), B, T, H, chunk, st, \
      stream
  switch (dh) {
    case 16: return launch<16>(WKV_ARGS);
    case 32: return launch<32>(WKV_ARGS);
    case 64: return launch<64>(WKV_ARGS);
    default: return -1;
  }
#undef WKV_ARGS
}
