// Chunked WKV-6 scan (RWKV-6 "Finch" time mix) for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py:_wkv_kernel (entry
// rwkv6_scan_fwd).  Per (batch, head) and chunk of L <= 64 steps, with
// lw = log(max(w, 1e-12)) and cl its running sum over the chunk (inclusive):
//   r_d = r * exp(cl - lw),  k_d = k * exp(min(-cl, 30))
//   y   = tril_strict(r_d k_d^T) v + r_d S + sum(r * u * k) v
//   S  <- exp(dl)^T * S + k_end^T v,  dl = cl[L-1],  k_end = k * exp(min(dl - cl, 30))
// with the reference's clip constant, floor and order of rescaling (r_d and
// k_d are formed and multiplied, never the pairwise exp(cl_l - cl_m): where
// -cl > 30 the clip saturates k_d and the pairwise form would differ).
// Inputs and outputs are f32.  Two kernels share the chunk loop and the
// scan: at dh 64, the serving path's head size, the products run on the
// tensor cores as wgmma in 3xTF32 (tc::wkv6_tc_kernel, below); at dh 16 and
// 32 they are f32 FMAs on the CUDA cores (wkv6_kernel).  Plain TF32 or
// bf16 products would use up the scan's tolerance of 1e-3; 3xTF32 on
// mma.sync m16n8k8 was right but slower than the CUDA cores on this card.
//
// What bounds it on this card, at the serving path's prefill shape B=1,
// T=1024, H=64, dh=64, chunk 64: 85,999,616 bytes (r, k, v, w read, u and s0
// read, y and S_T written) take 25.7 us at 3.35 TB/s; 1,602,224,128
// operations (B*H*T*2*dh*(L - 1 + 2*dh): the strictly causal scores and
// scores @ v over L*(L-1)/2 pairs, 2*dh each, and r_d @ S and the state
// update, 2*L*dh*dh each a chunk) take 23.9 us at the 67 TFLOP/s f32
// CUDA-core peak (H100 SXM data sheet).  Neither is reached: the chunks of
// a head run in order, so the time is one block's walk over its 16 chunks,
// and what matters is how few cycles a chunk takes on one SM.  On the
// CUDA cores the products take half of them, bound by shared-memory
// bandwidth (every operand of a register tile is read from shared memory
// once a step); on the tensor cores they take about a third, and the
// latency-bound log-decay scan and exponentials take most of the rest.
//
// What the design does about it (the CUDA-core kernel; the tensor-core
// one keeps its grid, block, scan and chunk loop).  The TPU form walks the
// chunks on a sequential grid axis with S in VMEM scratch; here a loop
// over chunks inside one block takes its place, S stays in shared memory,
// and r, k, v, w, y are read and written straight from the (B,T,H,dh)
// layout through their strides.  The value columns of S are independent,
// so the grid is (B*H, dh/32): a block of 512 threads owns 32 value
// columns of one head (128 blocks at B=1, H=64: one a SM).  The decays
// and the L x L scores are computed by both column blocks of a head (the
// price of 128 blocks instead of 64).  A chunk is
// four phases between barriers:
//   * the running log-decay sum is a two-level scan: each thread takes one
//     key channel and a segment of 64*dh/512 steps (8 at dh=64), sums its
//     segment in registers, and adds the totals of the segments before it
//     (left to right) after one barrier, so dl equals cl[L-1] bit for bit;
//     the bonus is 8 threads a row with a shuffle reduction;
//   * the same threads then form r_d, k_d and k_end for their elements;
//   * the products, an 8 x 4 register tile a thread (8 + 4 floats read
//     for 32 FMAs a step), each product on warps of its own: r_d @ S (64
//     tiles), the next S = exp(dl)^T S + k_end^T v into the second of two S
//     buffers (64 tiles), the 72 score tiles that hold some l > m; the
//     remaining warps issue the next chunk's loads (cp.async, 16 bytes a
//     thread, into the second of two stages), so the threads that stall on
//     the copy queue are ones with nothing else to do;
//   * scores @ v (only m < l) on all threads, each tile's m range cut in
//     four, the partial sums handed over through shared memory; then y.
// Rows past a ragged chunk's end are zero-filled (their lw is taken as 0,
// so the running sum stays at dl) and never stored.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kClip = 30.f;     // exponent clip of the 1/decay rescale
constexpr float kFloor = 1e-12f;  // w floor before the log
constexpr int kMaxL = 64;         // longest chunk
constexpr int kThreads = 512;
constexpr int kPS = kMaxL + 4;    // padded row stride of d-major tiles
// 8 x 4 score tiles (8 rows l, 4 columns m) holding some l > m: row block
// bi of 8 rows has 2 bi + 2 of them
constexpr int kScoreTiles = 72;

constexpr int round32(int n) { return (n + 31) / 32 * 32; }

// (batch, time, head) strides in elements of r, k, v, w and y, in that order
struct Strides {
  long long b[5], t[5], h[5];
};

template <int DH>
struct Cfg {
  static constexpr int CT = DH < 32 ? DH : 32;      // value columns a block
  static constexpr int SEG = kMaxL * DH / kThreads; // scan steps a thread
  static constexpr int NSEG = kMaxL / SEG;          // segments a channel
  static constexpr int KS = DH + 4;                 // row stride of k_end
  static constexpr int RAW = 3 * kMaxL * DH + kMaxL * CT;  // r, k, w; v
  static constexpr int kFloats =
      2 * RAW              // two stages of the raw tiles
      + 2 * DH * kPS       // r_d, k_d, d-major
      + kMaxL * kPS        // strictly causal scores, [m][l]
      + kMaxL * KS         // k_end, [t][d]
      + 2 * DH * CT        // S, this block's columns, two buffers
      + kMaxL * CT         // r_d @ S [l][e]
      + NSEG * DH          // segment sums of lw
      + kMaxL + DH + DH;   // bonus, u, exp(dl)
  static constexpr int kBytes = kFloats * static_cast<int>(sizeof(float));
  static_assert(SEG >= 2 && kMaxL % SEG == 0, "scan segments");
  static_assert(2 * DH * kPS + kMaxL * KS >= 3 * kMaxL * CT,
                "room for three partial sums of scores @ v");
  // the products' 8 x 4 tiles, each product on whole warps of its own:
  // r_d @ S from thread 0, the next S from OS, the scores from OP; threads
  // from FREE on load the next chunk
  static constexpr int NYT = (kMaxL / 8) * (CT / 4);
  static constexpr int NST = (DH / 8) * (CT / 4);
  static constexpr int OS = round32(NYT);
  static constexpr int OP = OS + round32(NST);
  static constexpr int FREE = round32(OP + kScoreTiles);
  static_assert(FREE <= kThreads - 64, "two warps left for the loads");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared.b64 [%0], 1;\n" ::"r"(smem_u32(bar)));
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// One tile of the tensor map (columns c0.., head h, rows t0.., batch b)
// into shared memory, counted against the barrier's expected bytes
__device__ __forceinline__ void tma_tile(float* dst, const CUtensorMap& map,
                                         int c0, int h, int t0, int b,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(h), "r"(t0),
      "r"(b), "r"(smem_u32(bar))
      : "memory");
}

// the four tensor maps of a launch: r, k, w (rows of dh) and v (rows of
// this block's CT columns), each (dh, H, T, B) with a box of one head's L
// rows
struct Maps {
  CUtensorMap r, k, w, v;
};

// Copy rows [t0, t0 + L) of COLS floats (16-byte aligned, row stride st)
// into a dense kMaxL x COLS tile; rows >= L are zero-filled from row t0.
// Thread i of n copies the 16-byte pieces i, i + n, ...
template <int COLS>
__device__ __forceinline__ void stage(const float* base, long long st,
                                      int t0, int L, float* dst, int i,
                                      int n) {
  constexpr int CPR = COLS / 4;
  for (int idx = i; idx < kMaxL * CPR; idx += n) {
    const int row = idx / CPR;
    const int c = (idx % CPR) * 4;
    const bool ok = row < L;
    cp_async16(dst + row * COLS + c,
               base + static_cast<long long>(t0 + (ok ? row : 0)) * st + c,
               ok);
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const float4 f = reinterpret_cast<const float4*>(p)[j];
      v[4 * j] = f.x; v[4 * j + 1] = f.y; v[4 * j + 2] = f.z;
      v[4 * j + 3] = f.w;
    }
  } else if constexpr (N == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x; v[1] = f.y;
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = p[j];
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
      reinterpret_cast<float4*>(p)[j] =
          make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) p[j] = v[j];
  }
}

// acc[i][j] += a[i] * b[j] for one step of a product's sum, a and b four
// consecutive floats in shared memory (16-byte aligned)
__device__ __forceinline__ void tile_fma(float (&acc)[4][4], const float* a,
                                         const float* b) {
  const float4 x = *reinterpret_cast<const float4*>(a);
  const float4 z = *reinterpret_cast<const float4*>(b);
  const float xa[4] = {x.x, x.y, x.z, x.w};
  const float zb[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] += xa[i] * zb[j];
}

__device__ __forceinline__ void tile_zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// acc[i][j] = sum over k < K of A[k][i] B[k][j] for an M x N register
// tile: A and B are k-major in shared memory (row strides lda, ldb,
// pointing at the tile's first column); a step reads M + N floats for M * N
// FMAs
template <int M, int N>
__device__ __forceinline__ void tile_mm(float (&acc)[M][N], const float* A,
                                        int lda, const float* B, int ldb,
                                        int K) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < K; ++kk) {
    float a[M], b[N];
    load_vec<M>(A + kk * lda, a);
    load_vec<N>(B + kk * ldb, b);
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) acc[i][j] += a[i] * b[j];
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ sT, int T, int H,
            int L, Strides st) {
  using C = Cfg<DH>;
  constexpr int CT = C::CT, SEG = C::SEG, NSEG = C::NSEG, KS = C::KS;
  constexpr int CQ = CT / 4;             // 4-column tiles across CT
  constexpr int NY = 16 * CQ;            // y tiles (4 x 4)
  extern __shared__ __align__(16) float smem[];
  float* raw0 = smem;                    // stages of r, k, w (L x DH), v
  float* RdT = raw0 + 2 * C::RAW;        // r_d [d][t]
  float* KdT = RdT + DH * kPS;           // k_d [d][t]
  float* Ke = KdT + DH * kPS;            // k_end [t][d]
  float* PT = Ke + kMaxL * KS;           // scores [m][l], zero for l <= m
  float* Sb = PT + kMaxL * kPS;          // S [d][e], two buffers
  float* Ys = Sb + 2 * DH * CT;          // r_d @ S [l][e]
  float* tot = Ys + kMaxL * CT;          // lw summed a segment [seg][d]
  float* bonus = tot + NSEG * DH;
  float* us = bonus + kMaxL;
  float* decay = us + DH;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int e0 = blockIdx.y * CT;

  const float* rb = r + b * st.b[0] + h * st.h[0];
  const float* kb = k + b * st.b[1] + h * st.h[1];
  const float* vb = v + b * st.b[2] + h * st.h[2] + e0;
  const float* wb = w + b * st.b[3] + h * st.h[3];
  float* yb = y + b * st.b[4] + h * st.h[4] + e0;
  const long long s_off = static_cast<long long>(bh) * DH * DH + e0;

  // a chunk's tiles: r, k, w (kMaxL x DH) and v (kMaxL x CT), copied by
  // threads [first, kThreads)
  auto stage_all = [&](int t0, float* raw, int first) {
    const int i = tid - first, n = kThreads - first;
    stage<DH>(rb, st.t[0], t0, L, raw, i, n);
    stage<DH>(kb, st.t[1], t0, L, raw + kMaxL * DH, i, n);
    stage<DH>(wb, st.t[3], t0, L, raw + 2 * kMaxL * DH, i, n);
    stage<CT>(vb, st.t[2], t0, L, raw + 3 * kMaxL * DH, i, n);
  };
  stage_all(0, raw0, 0);
  cp_async_commit();
  for (int i = tid; i < DH; i += kThreads) us[i] = u[h * DH + i];
  for (int idx = tid; idx < DH * CT; idx += kThreads) {
    const int d = idx / CT;
    const int e = idx % CT;
    Sb[idx] = s0[s_off + d * DH + e];
  }

  // decay scan: key channel dch, steps [T0, T0 + SEG)
  const int dch = tid % DH;
  const int seg = tid / DH;
  const int T0 = seg * SEG;
  // scores @ v: a 4 x 4 tile of y (rows 4 yr.., columns 4 yc..) a thread
  // and quarter of the block; a warp's row tiles are 4 apart, so every
  // warp's causal loop runs about as long
  const int g = (tid % NY) / CQ;
  const int yc = tid % CQ;
  const int yr = (g % 4) * 4 + g / 4;
  const bool is_y = tid < NY;

  int cur = 0;                           // S buffer read this chunk
  const int n_chunks = T / L;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * L;
    const float* Rr = raw0 + (c & 1) * C::RAW;
    const float* Kr = Rr + kMaxL * DH;
    const float* Wr = Kr + kMaxL * DH;
    const float* Vr = Wr + kMaxL * DH;
    cp_async_wait<0>();
    __syncthreads();  // this chunk's tiles landed; last chunk's reads done

    // log decays and their running sum inside the segment; the bonus
    float lw[SEG], pre[SEG];
    {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < SEG; ++i) {
        const int t = T0 + i;
        lw[i] = t < L ? logf(fmaxf(Wr[t * DH + dch], kFloor)) : 0.f;
        acc += lw[i];
        pre[i] = acc;
      }
      tot[seg * DH + dch] = acc;
    }
    {
      constexpr int DP = DH / 8;  // key channels a thread, 8 threads a row
      const int row = tid >> 3;
      const int d0 = (tid & 7) * DP;
      float rr[DP], kk[DP], uu[DP];
      load_vec<DP>(Rr + row * DH + d0, rr);
      load_vec<DP>(Kr + row * DH + d0, kk);
      load_vec<DP>(us + d0, uu);
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < DP; ++j) s += (rr[j] * uu[j]) * kk[j];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      if ((tid & 7) == 0) bonus[row] = s;
    }
    __syncthreads();  // segment sums and bonus ready

    // cl = the segments before, left to right, + the running sum; dl is the
    // same left-to-right sum over all segments, so dl == cl[L - 1]
    {
      float off = 0.f;
      for (int s = 0; s < seg; ++s) off += tot[s * DH + dch];
      float dl = off;
      for (int s = seg; s < NSEG; ++s) dl += tot[s * DH + dch];
      float rd[SEG], kd[SEG];
#pragma unroll
      for (int i = 0; i < SEG; ++i) {
        const int t = T0 + i;
        const float cl = off + pre[i];
        const float kv = Kr[t * DH + dch];
        rd[i] = Rr[t * DH + dch] * expf(cl - lw[i]);
        kd[i] = kv * expf(fminf(-cl, kClip));
        Ke[t * KS + dch] = kv * expf(fminf(dl - cl, kClip));
      }
      store_vec<SEG>(RdT + dch * kPS + T0, rd);
      store_vec<SEG>(KdT + dch * kPS + T0, kd);
      if (seg == 0) decay[dch] = expf(dl);
    }
    __syncthreads();  // r_d, k_d, k_end, exp(dl) ready
    // the next chunk's tiles, into the stage the last chunk read, from the
    // threads that have no product tile: a thread that issues cp.async
    // stalls while the copies queue, so the issue is kept off the others
    if (tid >= C::FREE && c + 1 < n_chunks)
      stage_all(t0 + L, raw0 + ((c + 1) & 1) * C::RAW, C::FREE);
    cp_async_commit();

    // the products, an 8 x 4 register tile a thread (8 + 4 floats read
    // for 32 FMAs a step), each product on warps of its own
    const float* S = Sb + cur * DH * CT;
    float* Sn = Sb + (cur ^ 1) * DH * CT;
    if (tid < C::NYT) {                  // r_d @ S -> Ys
      const int bi = tid / CQ, bj = tid % CQ;
      float acc[8][4];
      tile_mm<8, 4>(acc, RdT + 8 * bi, kPS, S + 4 * bj, CT, DH);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        store_vec<4>(Ys + (8 * bi + i) * CT + 4 * bj, acc[i]);
    } else if (tid >= C::OS && tid < C::OS + C::NST) {
      // S' = exp(dl)^T * S + k_end^T v
      const int qs = tid - C::OS;
      const int bi = qs / CQ, bj = qs % CQ;
      float acc[8][4];
      tile_mm<8, 4>(acc, Ke + 8 * bi, KS, Vr + 4 * bj, CT, L);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int d = 8 * bi + i;
        float old[4], out[4];
        load_vec<4>(S + d * CT + 4 * bj, old);
#pragma unroll
        for (int j = 0; j < 4; ++j) out[j] = decay[d] * old[j] + acc[i][j];
        store_vec<4>(Sn + d * CT + 4 * bj, out);
      }
    } else if (tid >= C::OP && tid < C::OP + kScoreTiles) {
      // strictly causal scores r_d k_d^T, row block bi of 8 rows l holds
      // the 2 bi + 2 column tiles of 4 columns m with some l > m
      const int qp = tid - C::OP;
      int bi = 0;
      while ((bi + 1) * (bi + 2) <= qp) ++bi;
      const int bj = qp - bi * (bi + 1);
      float acc[8][4];
      tile_mm<8, 4>(acc, RdT + 8 * bi, kPS, KdT + 4 * bj, kPS, DH);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = 4 * bj + j;
        float out[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) out[i] = 8 * bi + i > m ? acc[i][j] : 0.f;
        store_vec<8>(PT + m * kPS + 8 * bi, out);
      }
    }
    __syncthreads();  // scores and the next S ready
    cur ^= 1;

    // scores @ v over m < 4 * yr + 4, cut into four equal ranges, one a
    // quarter of the block (part 0 is the threads that hold r_d @ S); parts
    // 1-3 hand their sums over through the r_d, k_d and k_end tiles (free
    // by now, and contiguous: at least 3 x 64 x CT floats)
    {
      const int part = tid / NY;
      const int n_m = yr + 1;                 // (4 yr + 4) / 4 steps a part
      float yi[4][4];
      tile_zero(yi);
      if (part < 4) {
#pragma unroll 4
        for (int m = part * n_m; m < (part + 1) * n_m; ++m)
          tile_fma(yi, PT + m * kPS + 4 * yr, Vr + m * CT + 4 * yc);
        if (part > 0) {
          float* red = RdT + (part - 1) * kMaxL * CT;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            store_vec<4>(red + (4 * yr + i) * CT + 4 * yc, yi[i]);
        }
      }
      __syncthreads();  // the partial sums of scores @ v are written
      if (is_y) {
        // y = (scores @ v + r_d @ S) + bonus * v
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = 4 * yr + i;
          float p1[4], p2[4], p3[4], ys[4], vv[4], out[4];
          load_vec<4>(Ys + l * CT + 4 * yc, ys);
          load_vec<4>(RdT + l * CT + 4 * yc, p1);
          load_vec<4>(RdT + kMaxL * CT + l * CT + 4 * yc, p2);
          load_vec<4>(RdT + 2 * kMaxL * CT + l * CT + 4 * yc, p3);
          load_vec<4>(Vr + l * CT + 4 * yc, vv);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            out[j] = (((yi[i][j] + p1[j]) + (p2[j] + p3[j])) + ys[j]) +
                     bonus[l] * vv[j];
          if (l < L) store_vec<4>(yb + (t0 + l) * st.t[4] + 4 * yc, out);
        }
      }
    }
  }

  const float* S = Sb + cur * DH * CT;
  for (int idx = tid; idx < DH * CT; idx += kThreads) {
    const int d = idx / CT;
    const int e = idx % CT;
    sT[s_off + d * DH + e] = S[idx];
  }
}

// ---------------------------------------------------------------------------
// dh = 64, the serving path's head size: the products on the tensor cores
// ---------------------------------------------------------------------------
//
// Same chunk loop and the same scan as above, but r_d @ S, k_end^T v, the
// scores and scores @ v are wgmma m64nNk8 in 3xTF32: each f32 operand x is
// split into hi = tf32(x) (rounded to nearest) and lo = x - hi, and a
// product is a_lo b_hi + a_hi b_lo + a_hi b_hi, accumulated in f32 (a_lo
// b_lo, ~2^-23 of it, is left out; cutting hi instead of rounding it went
// over 1e-3 on outputs of ~400 with decays near 1).  Each product's A
// operand is read from shared memory into registers and split there; its
// B operand lies in shared memory as two tiles (hi, lo) in wgmma's K-major
// 128-byte-swizzled layout: k_d [m][d] (written by the exponentials), v^T
// [e][t] (written when the chunk lands) and S^T [e][d] (written by the
// state update for the next chunk).  One warpgroup a product: r_d @ S,
// the next S, the scores; scores @ v follows on the first, beside the
// state update's writes.  A chunk's r, k, w, v arrive as four bulk tensor
// copies issued by one thread (rows padded to 68 floats, so the A
// fragments read without bank conflicts), and r_d and k_end are written
// over r and k.

namespace tc {

constexpr int DH = 64;
constexpr int CT = 32;
constexpr int RS = DH + 4;                        // row stride of r, k, w
constexpr int SS = CT + 4;                        // row stride of S
constexpr int STAGE = 3 * kMaxL * RS + kMaxL * CT;
constexpr int SEG = kMaxL * DH / kThreads;        // 8 scan steps a thread
constexpr int NSEG = kMaxL / SEG;
// K-major swizzled tiles of 64 tf32 a row (two 128-byte atoms along K)
constexpr int KD_BYTES = kMaxL * 256;             // k_d [m][d]
constexpr int VT_BYTES = CT * 256;                // v^T [e][t]
constexpr int ST_BYTES = CT * 256;                // S^T [e][d]
constexpr int kTileBytes = 2 * (KD_BYTES + VT_BYTES + ST_BYTES);
constexpr int kFloats = 2 * STAGE + kMaxL * RS + DH * SS + NSEG * DH +
                        kMaxL + DH + DH + 4;      // ..., 2 mbarriers
constexpr int kBytes = 1024 + kTileBytes + kFloats * 4;

// byte offset of element (n, k) in an N-row tile: row n of 64 tf32 as two
// 128-byte atoms (k / 32), 16-byte chunks XOR-swizzled by n % 8
template <int N>
__device__ __forceinline__ uint32_t sw(int n, int k) {
  return (k >> 5) * (N * 128) + n * 128 +
         ((((k & 31) >> 2) ^ (n & 7)) << 4) + (k & 3) * 4;
}

// descriptor of k-step ks (8 tf32 = 32 bytes) of an N-row tile: 8-row
// groups 1024 bytes apart, 128-byte swizzle
template <int N>
__device__ __forceinline__ uint64_t desc(uint32_t tile, int ks) {
  const uint32_t a = tile + (ks >> 2) * (N * 128) + (ks & 3) * 32;
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// lo goes to the tensor cores as f32 bits, of which they read the top 19:
// cutting it loses 2^-11 of lo, which is at most 2^-12 of x
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// x split into the hi and lo tiles at byte offset off
__device__ __forceinline__ void put_split(unsigned char* hi, unsigned char* lo,
                                          uint32_t off, float x) {
  uint32_t h, l;
  split(x, h, l);
  *reinterpret_cast<uint32_t*>(hi + off) = h;
  *reinterpret_cast<uint32_t*>(lo + off) = l;
}

// the A fragments of k-steps [0, KS) for this warp's 16 rows m0.., split:
// from a row-major source X[m][k] (kmaj = false) or a k-major one X[k][m]
template <int KS>
__device__ __forceinline__ void a_frags(const float* X, int ld, bool kmaj,
                                        int m0, uint32_t (&hi)[KS][4],
                                        uint32_t (&lo)[KS][4]) {
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = m0 + g + 8 * (q & 1);
      const int kk = 8 * ks + t + 4 * (q >> 1);
      split(kmaj ? X[kk * ld + m] : X[m * ld + kk], hi[ks][q], lo[ks][q]);
    }
}

__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (m64n32 f32, the first 16 a thread) += a (4 tf32 registers) * b
__device__ __forceinline__ void mma_n32(float (&d)[32], const uint32_t (&a)[4],
                                        uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// d (m64n64 f32, 32 a thread) += a * b
__device__ __forceinline__ void mma_n64(float (&d)[32], const uint32_t (&a)[4],
                                        uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// acc += X (A, this warp's 16 rows from m0) @ B, K = 64 in two halves of
// four k-steps (their A fragments loaded and split before the wgmmas
// issue), 3xTF32; B's hi and lo tiles have N rows
template <int N>
__device__ __forceinline__ void product(float (&acc)[32], const float* X,
                                        int ld, bool kmaj, int m0,
                                        uint32_t bhi, uint32_t blo) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t ah[4][4], al[4][4];
    a_frags<4>(kmaj ? X + 32 * half * ld : X + 32 * half, ld, kmaj, m0, ah,
               al);
    wg_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ks = 4 * half + j;
      if constexpr (N == 32) {
        mma_n32(acc, al[j], desc<N>(bhi, ks));
        mma_n32(acc, ah[j], desc<N>(blo, ks));
        mma_n32(acc, ah[j], desc<N>(bhi, ks));
      } else {
        mma_n64(acc, al[j], desc<N>(bhi, ks));
        mma_n64(acc, ah[j], desc<N>(blo, ks));
        mma_n64(acc, ah[j], desc<N>(bhi, ks));
      }
    }
    wg_commit_wait();
  }
}

__global__ void __launch_bounds__(kThreads, 1)
wkv6_tc_kernel(const float* __restrict__ u, const float* __restrict__ s0,
               float* __restrict__ y, float* __restrict__ sT, int T, int H,
               int L, long long y_sb, long long y_st, long long y_sh,
               const __grid_constant__ Maps maps) {
  extern __shared__ __align__(16) float tsm[];
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(tsm));
  const uint32_t tiles = (base + 1023u) & ~1023u;
  unsigned char* tp = reinterpret_cast<unsigned char*>(tsm) + (tiles - base);
  unsigned char* kd_hi = tp;
  unsigned char* kd_lo = kd_hi + KD_BYTES;
  unsigned char* vt_hi = kd_lo + KD_BYTES;
  unsigned char* vt_lo = vt_hi + VT_BYTES;
  unsigned char* st_hi = vt_lo + VT_BYTES;
  unsigned char* st_lo = st_hi + ST_BYTES;
  const uint32_t KdH = tiles, KdL = KdH + KD_BYTES, VtH = KdL + KD_BYTES,
                 VtL = VtH + VT_BYTES, StH = VtL + VT_BYTES,
                 StL = StH + ST_BYTES;
  float* stage0 = reinterpret_cast<float*>(tp + kTileBytes);
  float* P = stage0 + 2 * STAGE;           // scores [l][m], zero for l <= m
  float* S = P + kMaxL * RS;               // S [d][e], f32
  float* tot = S + DH * SS;
  float* bonus = tot + NSEG * DH;
  float* us = bonus + kMaxL;
  float* decay = us + DH;
  uint64_t* bars = reinterpret_cast<uint64_t*>(decay + DH);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wg = warp >> 2;                // warpgroup
  const int m0 = 16 * (warp & 3);          // this warp's rows of a product
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int e0 = blockIdx.y * CT;
  float* yb = y + b * y_sb + h * y_sh + e0;
  const long long s_off = static_cast<long long>(bh) * DH * DH + e0;

  // chunk c's r, k, w (rows of 64, padded to RS with zeros) and v: four
  // bulk tensor copies from one thread, counted on the stage's barrier
  auto stage_all = [&](int c) {
    float* stg = stage0 + (c & 1) * STAGE;
    uint64_t* bar = &bars[c & 1];
    fence_async();
    mbar_expect(bar, 4u * L * (3 * RS + CT));
    tma_tile(stg, maps.r, 0, h, c * L, b, bar);
    tma_tile(stg + kMaxL * RS, maps.k, 0, h, c * L, b, bar);
    tma_tile(stg + 2 * kMaxL * RS, maps.w, 0, h, c * L, b, bar);
    tma_tile(stg + 3 * kMaxL * RS, maps.v, e0, h, c * L, b, bar);
  };
  // rows past a ragged chunk's end stay zero in both stages
  for (int idx = tid; idx < 2 * STAGE; idx += kThreads) {
    const int off = idx % STAGE;
    const int row = off < 3 * kMaxL * RS ? (off % (kMaxL * RS)) / RS
                                         : (off - 3 * kMaxL * RS) / CT;
    if (row >= L) stage0[idx] = 0.f;
  }
  for (int i = tid; i < DH; i += kThreads) us[i] = u[h * DH + i];
  for (int idx = tid; idx < DH * CT; idx += kThreads) {
    const int d = idx / CT;
    const int e = idx % CT;
    const float x = s0[s_off + d * DH + e];
    S[d * SS + e] = x;
    put_split(st_hi, st_lo, sw<CT>(e, d), x);
  }
  if (tid == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_async();
  __syncthreads();  // barriers, zeros, S^T ready
  if (tid == 0) stage_all(0);

  const int dch = tid % DH;
  const int seg = tid / DH;
  const int T0 = seg * SEG;

  const int n_chunks = T / L;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * L;
    float* Rr = stage0 + (c & 1) * STAGE;  // r, then r_d
    float* Kr = Rr + kMaxL * RS;           // k, then k_end
    const float* Wr = Kr + kMaxL * RS;
    const float* Vr = Wr + kMaxL * RS;
    mbar_wait(&bars[c & 1], (c >> 1) & 1);
    __syncthreads();  // this chunk's tiles landed; last chunk's reads done
    if (tid == 0 && c + 1 < n_chunks) stage_all(c + 1);

    // log decays and their running sum inside the segment; the bonus; v^T
    float lw[SEG], pre[SEG];
    {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < SEG; ++i) {
        const int t = T0 + i;
        lw[i] = t < L ? logf(fmaxf(Wr[t * RS + dch], kFloor)) : 0.f;
        acc += lw[i];
        pre[i] = acc;
      }
      tot[seg * DH + dch] = acc;
    }
    {
      const int row = tid >> 3;
      const int d0 = (tid & 7) * 8;
      float rr[8], kk[8], uu[8];
      load_vec<8>(Rr + row * RS + d0, rr);
      load_vec<8>(Kr + row * RS + d0, kk);
      load_vec<8>(us + d0, uu);
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) s += (rr[j] * uu[j]) * kk[j];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      if ((tid & 7) == 0) bonus[row] = s;
    }
#pragma unroll
    for (int i = 0; i < kMaxL * CT / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int t = idx / CT;
      const int e = idx % CT;
      put_split(vt_hi, vt_lo, sw<CT>(e, t), Vr[t * CT + e]);
    }
    fence_async();
    __syncthreads();  // segment sums, bonus and v^T ready

    // cl = the segments before, left to right, + the running sum; dl the
    // same sum over all segments, so dl == cl[L - 1].  r_d and k_end go
    // over r and k, k_d into its split tiles
    {
      float off = 0.f;
      for (int s = 0; s < seg; ++s) off += tot[s * DH + dch];
      float dl = off;
      for (int s = seg; s < NSEG; ++s) dl += tot[s * DH + dch];
#pragma unroll
      for (int i = 0; i < SEG; ++i) {
        const int t = T0 + i;
        const float cl = off + pre[i];
        const float kv = Kr[t * RS + dch];
        Rr[t * RS + dch] *= expf(cl - lw[i]);
        Kr[t * RS + dch] = kv * expf(fminf(dl - cl, kClip));
        put_split(kd_hi, kd_lo, sw<kMaxL>(t, dch),
                  kv * expf(fminf(-cl, kClip)));
      }
      if (seg == 0) decay[dch] = expf(dl);
    }
    fence_async();
    __syncthreads();  // r_d, k_end, k_d, exp(dl) ready

    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    if (wg == 0) {                       // r_d @ S
      product<CT>(acc, Rr, RS, false, m0, StH, StL);
    } else if (wg == 1) {                // k_end^T v
      product<CT>(acc, Kr, RS, true, m0, VtH, VtL);
    } else if (wg == 2) {                // the strictly causal scores
      product<kMaxL>(acc, Rr, RS, false, m0, KdH, KdL);
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        const int l = m0 + g + 8 * ((q >> 1) & 1);
        const int m = 8 * (q >> 2) + 2 * t4 + (q & 1);
        P[l * RS + m] = l > m ? acc[q] : 0.f;
      }
    }
    __syncthreads();  // every product has read its operands; scores ready

    if (wg == 0) {   // y = (r_d @ S + scores @ v) + bonus * v
      product<CT>(acc, P, RS, false, m0, VtH, VtL);
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int l = m0 + g + 8 * ((q >> 1) & 1);
        const int e = 8 * (q >> 2) + 2 * t4 + (q & 1);
        if (l < L)
          yb[(t0 + l) * y_st + e] = acc[q] + bonus[l] * Vr[l * CT + e];
      }
    } else if (wg == 1) {                // S <- exp(dl)^T * S + k_end^T v
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int d = m0 + g + 8 * ((q >> 1) & 1);
        const int e = 8 * (q >> 2) + 2 * t4 + (q & 1);
        const float x = decay[d] * S[d * SS + e] + acc[q];
        S[d * SS + e] = x;
        put_split(st_hi, st_lo, sw<CT>(e, d), x);
      }
      fence_async();
    }
  }
  __syncthreads();  // the last state is written

  for (int idx = tid; idx < DH * CT; idx += kThreads) {
    const int d = idx / CT;
    const int e = idx % CT;
    sT[s_off + d * DH + e] = S[d * SS + e];
  }
}

}  // namespace tc

// A tensor map over one (B,T,H,dh) tensor, dims ordered (dh, H, T, B) so
// the strides grow, with a box of `cols` columns of one head's L rows.  The
// driver's encoder is reached through the runtime, so nothing links
// against libcuda.  Returns 0, a cudaError_t, or -2 if the encoder refuses.
int encode_map(CUtensorMap* map, const float* base, int dh, int cols, int B,
               int T, int H, int L, long long sb, long long st_, long long sh) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return -2;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 4,
                                 static_cast<cuuint64_t>(st_) * 4,
                                 static_cast<cuuint64_t>(sb) * 4};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1,
                             static_cast<cuuint32_t>(L), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : -2;
}

// the kernel and its shared memory for a head dim: dh 64 on the tensor
// cores, dh 16 and 32 on the CUDA cores
template <int DH>
struct Pick {
  static auto kern() { return wkv6_kernel<DH>; }
  static constexpr int bytes = Cfg<DH>::kBytes;
};
template <>
struct Pick<64> {
  static auto kern() { return tc::wkv6_tc_kernel; }
  static constexpr int bytes = tc::kBytes;
};

template <int DH>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* y, float* sT, int B,
           int T, int H, int L, const Strides& st, cudaStream_t stream) {
  auto kern = Pick<DH>::kern();
  constexpr int bytes = Pick<DH>::bytes;
  // opt in to more than 48 KB of dynamic shared memory (per device, cheap)
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_bh = static_cast<long long>(B) * H;
  if (n_bh > 2147483647LL) return -1;
  const dim3 grid(static_cast<unsigned>(n_bh), DH / Cfg<DH>::CT);
  if constexpr (DH == 64) {
    Maps maps;
    CUtensorMap* dst[4] = {&maps.r, &maps.k, &maps.w, &maps.v};
    const float* src[4] = {r, k, w, v};
    const int which[4] = {0, 1, 3, 2};   // their (b, t, h) strides in st
    for (int a = 0; a < 4; ++a) {
      const int code = encode_map(dst[a], src[a], DH, a < 3 ? tc::RS : tc::CT,
                                  B, T, H, L, st.b[which[a]], st.t[which[a]],
                                  st.h[which[a]]);
      if (code != 0) return code;
    }
    kern<<<grid, kThreads, bytes, stream>>>(u, s0, y, sT, T, H, L, st.b[4],
                                            st.t[4], st.h[4], maps);
  } else {
    kern<<<grid, kThreads, bytes, stream>>>(r, k, v, w, u, s0, y, sT, T, H,
                                            L, st);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int info(int* out) {
  auto kern = Pick<DH>::kern();
  constexpr int bytes = Pick<DH>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kern);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                        kThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);  // spills and stack
  out[2] = bytes;                                  // dynamic shared memory
  out[3] = blocks;                                 // resident a SM
  out[4] = kThreads;
  return 0;
}

}  // namespace

// What the compiler and the card make of the kernel for one head dim:
// out[0..4] = registers a thread, local memory a thread in bytes, dynamic
// shared memory a block in bytes, blocks resident a SM, threads a block.
// Returns a cudaError_t (0 = filled in), or -1 for a head dim it lacks.
extern "C" int rwkv6_scan_info(int dh, void* out) {
  int* o = static_cast<int*>(out);
  switch (dh) {
    case 16: return info<16>(o);
    case 32: return info<32>(o);
    case 64: return info<64>(o);
    default: return -1;
  }
}

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

