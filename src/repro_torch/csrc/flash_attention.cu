// FlashAttention-2 forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:_fwd_kernel (entry
// flash_attention_fwd): causal and/or sliding-window attention with GQA over
// q (B,S,H,hd), k/v (B,S,Kv,hd), f32 online-softmax carry (acc, m, l), a
// ragged sequence tail and a guard for key blocks a row cannot see.
//
// What bounds it on this card: at the serve path's shapes (bf16, hd 128,
// S up to 1024) the bytes of q, k, v and out (read and written once) and
// the 4*S^2*hd operations a head (half of them under a causal mask) take
// about the same least time, 5 us at S = 1024 -- but only on the tensor
// cores: on the CUDA cores the same operations take 15x longer.  Between
// the two products sits the softmax, which the tensor cores cannot do, and
// each K/V tile is read once per 64-row query block, from L2.  So the bf16
// path runs both products as wgmma, keeps P in registers, loads the next
// tile while the present one is multiplied, and relies on two blocks per SM
// to overlap one block's softmax with the other's products.
//
// What the design does about it (both paths): the TPU form pads S,
// transposes to (B*H, Sp, hd) and puts the kv blocks on a sequential grid
// axis with the carry in scratch.  Here a block owns 64 query rows of one
// (batch, head) and loops over the key blocks itself, so the carry lives in
// registers and nothing crosses blocks.  The (B,S,H,hd) layout is read
// through its strides (kv head = h / rep, no transpose, no repeat); key
// blocks wholly above the diagonal or wholly outside the window are never
// visited; the ragged tail is masked in the kernel (kpos < S on keys, qpos <
// S on the store) with no padded copy; masked scores are *selected* to
// probability 0.  Blocks are issued heaviest (last query block) first.
//
// bf16 (flash_fwd_bf16_kernel, FlashAttention-2's design on Hopper's
// warpgroup products): a block is one warpgroup, 4 warps of 16 query rows.
// Q (64 x hd) and a 2-stage ring of K and V tiles (64 x hd each) stay bf16
// in shared memory in wgmma's swizzled canonical layout (128-, 64- or
// 32-byte swizzle by hd), filled by cp.async.cg (16 bytes a thread; the
// zero-fill form for rows past S, sourced from row 0 of the same head) and
// ordered by commit_group / wait_group, so tile j+1 loads while tile j is
// multiplied; a fence.proxy.async hands the tiles to the tensor cores.
// S = Q K^T is wgmma m64n64k16 with both operands read from shared memory
// through descriptors (K-major); the online softmax runs on the f32 score
// accumulators in registers (row max over the 4 lanes of a quad by
// shuffles; exp2 with sm_scale * log2(e) applied to the f32 scores -- Q is
// never scaled before rounding); O += P V is wgmma m64n<hd>k16 with P from
// registers -- the m64n64 f32 accumulator is, pair for pair, the A
// fragment of the next product, packed to bf16x2 -- and V read MN-major
// (the transpose bit).  P is rounded to bf16 for the second product (as
// SDPA does); the row sum l is taken from the f32 P.  At hd=128 the five
// tiles take 81 KB (dynamic shared memory, opted in with
// cudaFuncSetAttribute), so two blocks fit on an SM.  When the whole grid
// is resident at once, every other wave of blocks runs lightest first, so
// that an SM holding one of the heaviest causal blocks also holds one of
// the lightest.
//
// f32 (flash_fwd_f32_kernel): f32 inputs must not go through TF32, so the
// products are f32 FMAs on the CUDA cores.  256 threads form a 16x16 grid:
// thread (ty, tx) owns score rows ty+16*i and columns tx+16*j, K and V
// tiles are staged in shared memory as f32, row statistics are reduced by
// shuffles over the 16 tx lanes, and probabilities go through shared memory
// (aliased over the K tile) for the second product; 98 KB of tiles at
// hd=128.  Every launch is followed by cudaGetLastError.
//
// Head dim 120 (H2O-Danube3-4B): wgmma's K step is 16 elements and the
// 128-byte swizzle cuts a row into atoms of 64, so a 120-wide tile has no
// legal layout.  Both paths keep their tiles 128 columns wide in shared
// memory only (Pad<HD>): a row's 15 chunks of 16 bytes are loaded (240
// bytes; the (B,S,H,hd) strides keep every row 16-byte aligned) and its
// 16th is zeroed once at block start and never written again (loading it
// as cp.async's zero-fill form instead was slower on an H100 80GB HBM3 at
// 700 W: 0.787 against 0.640 ms at Danube's prefill shape, with hd 128 at
// 0.49 ms in both runs).  Q K^T sums eight K steps of which the last
// half-step adds zeros, O += P V runs at n128 (its
// columns 120..127 come out zero) and only 120 columns are stored.  No
// padded copy exists in device memory; sm_scale is the caller's
// (120^-0.5).  The f32 path stages the same zero columns and gives each
// thread 8 output columns, of which it stores those below 120.  Shared
// memory at hd 120 is hd 128's: two bf16 blocks still fit an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile

// The width of a head's tiles in shared memory: a head dim past 64 that is
// not a whole number of 64-element swizzle atoms (120) is padded to the
// next one (128) with zero columns; 16, 32, 64 and 128 are their own width.
template <int HD>
struct Pad {
  static_assert(HD % 8 == 0, "rows are loaded in chunks of 16 bytes");
  static constexpr int P = HD > 64 ? (HD + 63) / 64 * 64 : HD;
};

// ---------------------------------------------------------------------------
// f32: FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;  // 16 x 16
constexpr int kPS = kBK + 1;   // row stride of the probability tile

template <int HD>
struct Tiles {
  static constexpr int QS = HD + 4;  // padded row stride of the Q and K tiles
  static constexpr int kRegion =
      (kBK * QS > kBQ * kPS) ? kBK * QS : kBQ * kPS;  // K tile, then P tile
  static constexpr int kFloats = kBQ * QS + kRegion + kBK * HD;
  static constexpr int kBytes = kFloats * static_cast<int>(sizeof(float));
};

// Stage kBK x HP floats starting at sequence position pos0 into shared
// memory (rows at positions >= S and columns >= HD are zero), scaled by
// `scale`.
template <int HD, int HP>
__device__ __forceinline__ void stage_tile(const float* __restrict__ base,
                                           long long stride_s, int pos0,
                                           int S, float scale,
                                           float* __restrict__ dst,
                                           int dst_stride, int tid) {
  constexpr int CPR = HP / 4;  // 16-byte chunks per row
  for (int idx = tid; idx < kBK * CPR; idx += kThreads) {
    const int row = idx / CPR;
    const int c = idx % CPR;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    const int pos = pos0 + row;
    if (pos < S && c < HD / 4) {
      f = *reinterpret_cast<const float4*>(base + pos * stride_s + c * 4);
      f.x *= scale; f.y *= scale; f.z *= scale; f.w *= scale;
    }
    *reinterpret_cast<float4*>(dst + row * dst_stride + c * 4) = f;
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int S, int H, int rep, int n_qb, long long q_sb,
                     long long q_ss, long long q_sh, long long k_sb,
                     long long k_ss, long long k_sh, long long v_sb,
                     long long v_ss, long long v_sh, long long o_sb,
                     long long o_ss, long long o_sh, float sm_scale,
                     int causal, int window) {
  static_assert(kBQ == kBK, "stage_tile stages kBK rows for Q as well");
  constexpr int HP = Pad<HD>::P;  // tile width (zero columns past HD)
  constexpr int QS = Tiles<HP>::QS;
  constexpr int DPT = HP / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * QS;
  float* Ps = Ks;  // aliases the K tile once the scores are in registers
  float* Vs = Ks + Tiles<HP>::kRegion;

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

  const float* qbase = q + b * q_sb + h * q_sh;
  const float* kbase = k + b * k_sb + kvh * k_sh;
  const float* vbase = v + b * v_sb + kvh * v_sh;

  stage_tile<HD, HP>(qbase, q_ss, q0, S, sm_scale, Qs, QS, tid);

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
    stage_tile<HD, HP>(kbase, k_ss, k0, S, 1.f, Ks, QS, tid);
    stage_tile<HD, HP>(vbase, v_ss, k0, S, 1.f, Vs, HP, tid);
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
              *reinterpret_cast<const float4*>(Vs + j * HP + c * 64 + tx * 4);
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
          const float vv = Vs[j * HP + tx * DPT + e];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][e] += pv[i] * vv;
        }
      }
    }
  }

  float* obase = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos < S) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int e = 0; e < DPT; ++e) {
        const int d = (DPT % 4 == 0) ? (e / 4) * 64 + tx * 4 + (e % 4)
                                     : tx * DPT + e;
        if (HP == HD || d < HD) obase[qpos * o_ss + d] = acc[i][e] / denom;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma on the tensor cores, cp.async ring
// ---------------------------------------------------------------------------

constexpr int kThreadsBf16 = 128;  // one warpgroup: 4 warps of 16 query rows

// A shared tile of 64 rows x HD bf16 in wgmma's canonical swizzled layout.
// A row is cut into atoms of W = min(HD, 64) elements (R = 2W bytes); the
// tile holds its atoms one after another, each 64 rows of R bytes, and the
// 16-byte chunks of a row are XOR-swizzled by address bits 7.. (CUTLASS's
// Swizzle<B,4,3>, B = log2(R / 16)): the 128-, 64- or 32-byte swizzle the
// descriptors name.  Q and K are read K-major (hd contiguous), V MN-major
// (its hd is the product's N): one layout serves both.
template <int HD>
struct Swz {
  static constexpr int W = HD < 64 ? HD : 64;  // elements in an atom's row
  static constexpr int R = 2 * W;              // bytes in an atom's row
  static constexpr int kBits = R == 128 ? 3 : (R == 64 ? 2 : 1);
  static constexpr int kLayout = R == 128 ? 1 : (R == 64 ? 2 : 3);
  static constexpr int kAtomBytes = kBK * R;
  static constexpr int kTileBytes = kBK * HD * 2;
  // byte offset in the tile of 16-byte chunk c (of HD / 8) of row `row`
  static __device__ __forceinline__ uint32_t chunk(int row, int c) {
    const uint32_t off =
        (c / (W / 8)) * kAtomBytes + row * R + (c % (W / 8)) * 16;
    return off ^ (((off >> 7) & ((1u << kBits) - 1u)) << 4);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a masked score: -inf, so that exp2(-inf - m) is exactly 0
__device__ __forceinline__ float masked() {
  return -__int_as_float(0x7f800000);
}

// wgmma's shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle mode (1: 128 B, 2: 64 B,
// 3: 32 B)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// k-step kk (16 elements of hd) of a K-major tile (Q, K): 8-row groups
// 8R bytes apart; a step inside an atom moves the start by 32 bytes
template <int HD>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int kk) {
  using L = Swz<HD>;
  return gmma_desc(tile + (kk * 16 / L::W) * L::kAtomBytes +
                       (kk * 16 % L::W) * 2,
                   16, 8 * L::R, L::kLayout);
}

// k-step kk (16 keys) of the MN-major V tile: 8-key groups 8R bytes apart
// (stride offset), hd atoms kAtomBytes apart (leading offset)
template <int HD>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int kk) {
  using L = Swz<HD>;
  return gmma_desc(tile + kk * 16 * L::R, L::kAtomBytes, 8 * L::R,
                   L::kLayout);
}

// Copy 64 rows x HD bf16 starting at sequence position pos0 into a tile
// HP wide with cp.async; rows at positions >= S are zero-filled (src size
// 0) from the head's row 0, so no address past the tensor is formed.  The
// chunks of columns HD..HP-1 are never written (zero_pad zeroes them).
template <int HD, int HP>
__device__ __forceinline__ void load_tile(const __nv_bfloat16* base,
                                          long long stride_s, int pos0,
                                          int S, uint32_t dst, int tid) {
  constexpr int CPR = HD / 8;  // 16-byte chunks per row
  constexpr int N = kBK * CPR;
#pragma unroll
  for (int it = 0; it < (N + kThreadsBf16 - 1) / kThreadsBf16; ++it) {
    const int idx = tid + it * kThreadsBf16;
    if (N % kThreadsBf16 != 0 && idx >= N) break;
    const int row = idx / CPR;
    const int c = idx % CPR;
    const int pos = pos0 + row;
    const bool ok = pos < S;
    const __nv_bfloat16* src = base + (ok ? pos * stride_s : 0LL) + c * 8;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     dst + Swz<HP>::chunk(row, c)),
                 "l"(src), "r"(ok ? 16 : 0));
  }
}

// Zero the chunks of columns HD..HP-1 in every row of n consecutive tiles
// (once, at block start: no load writes them).
template <int HD, int HP>
__device__ __forceinline__ void zero_pad(uint32_t tiles, int n, int tid) {
  constexpr int PC = (HP - HD) / 8;  // pad chunks a row
  if constexpr (PC > 0) {
    for (int idx = tid; idx < n * kBK * PC; idx += kThreadsBf16) {
      const int t = idx / (kBK * PC);
      const int row = idx / PC % kBK;
      const int c = HD / 8 + idx % PC;
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                       tiles + t * Swz<HP>::kTileBytes + Swz<HP>::chunk(row, c)),
                   "r"(0u), "r"(0u), "r"(0u), "r"(0u)
                   : "memory");
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of wgmma's accumulators
// across the asynchronous instructions
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (m64n64 f32) += A (descriptor, K-major) * B (descriptor, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,"
      "%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (m64nN f32) += A (registers, bf16) * B (descriptor, MN-major)
template <int N>
struct WgmmaRS;

template <>
struct WgmmaRS<16> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7}, "
        "{%8,%9,%10,%11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRS<32> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,"
        "%8,%9,%10,%11,%12,%13,%14,%15}, "
        "{%16,%17,%18,%19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRS<64> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,"
        "%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,"
        "%24,%25,%26,%27,%28,%29,%30,%31}, "
        "{%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct WgmmaRS<128> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0,%1,%2,%3,%4,%5,%6,%7,"
        "%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,"
        "%24,%25,%26,%27,%28,%29,%30,%31,"
        "%32,%33,%34,%35,%36,%37,%38,%39,"
        "%40,%41,%42,%43,%44,%45,%46,%47,"
        "%48,%49,%50,%51,%52,%53,%54,%55,"
        "%56,%57,%58,%59,%60,%61,%62,%63}, "
        "{%64,%65,%66,%67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};


__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in bits 0-15
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(kThreadsBf16, 2)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out, int S, int H, int rep,
                      int n_qb, int n_bh, int wave, long long q_sb,
                      long long q_ss, long long q_sh, long long k_sb,
                      long long k_ss, long long k_sh, long long v_sb,
                      long long v_ss, long long v_sh, long long o_sb,
                      long long o_ss, long long o_sh, float scale_log2,
                      int causal, int window) {
  constexpr int HP = Pad<HD>::P;  // tile width (zero columns past HD)
  constexpr int TILE = Swz<HP>::kTileBytes;
  constexpr int NT = kBK / 8;  // 8-key chunks of S
  constexpr int DT = HP / 8;   // 8-column chunks of O (DS = HD / 8 stored)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // tiles start on 1024-byte boundaries, as the swizzle patterns need
  const uint32_t Qs = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t Ks = Qs + TILE;      // stages 0, 1
  const uint32_t Vs = Ks + 2 * TILE;  // stages 0, 1

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // rank 0 is the heaviest block under a causal mask (the last query block
  // of each (batch, head)).  When the whole grid is resident at once, SM j
  // is handed blocks j, j + wave, ... (wave = the SM count; 0 otherwise):
  // odd waves run lightest first, so that an SM holding one of the heaviest
  // blocks also holds one of the lightest
  int r = static_cast<int>(blockIdx.x);
  if (wave > 0 && (r / wave) % 2 == 1) {
    const int w0 = r - r % wave;
    r = w0 + min(wave, static_cast<int>(gridDim.x) - w0) - 1 - (r - w0);
  }
  const int qb = n_qb - 1 - r / n_bh;
  const int bh = r % n_bh;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / rep;
  const int q0 = qb * kBQ;

  const __nv_bfloat16* qbase = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kbase = k + b * k_sb + kvh * k_sh;
  const __nv_bfloat16* vbase = v + b * v_sb + kvh * v_sh;

  // key blocks this query block can see (never empty: q0 < S)
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

  zero_pad<HD, HP>(Qs, 5, tid);  // Q, K and V stages are consecutive
  load_tile<HD, HP>(qbase, q_ss, q0, S, Qs, tid);
  load_tile<HD, HP>(kbase, k_ss, kb_lo * kBK, S, Ks, tid);
  load_tile<HD, HP>(vbase, v_ss, kb_lo * kBK, S, Vs, tid);
  cp_async_commit();

  // accumulator layout (per warp, as mma.sync's m16n8): element 4 j + e is
  // row r_lo + 8 (e / 2), column 8 j + c_in + (e % 2)
  const int r_lo = q0 + warp * 16 + lane / 4;
  const int c_in = 2 * (lane % 4);
  float o[4 * DT];
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share; summed over the quad
#pragma unroll
  for (int i = 0; i < 4 * DT; ++i) o[i] = 0.f;

  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int stage = (kb - kb_lo) & 1;
    const int k0 = kb * kBK;
    if (kb + 1 < kb_hi) {  // the next tile goes into the other stage
      load_tile<HD, HP>(kbase, k_ss, k0 + kBK, S, Ks + (stage ^ 1) * TILE,
                        tid);
      load_tile<HD, HP>(vbase, v_ss, k0 + kBK, S, Vs + (stage ^ 1) * TILE,
                        tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // cp.async (and zero_pad's stores) wrote through the generic proxy;
    // wgmma reads through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // this stage (and, the first time, Q) has landed

    // S = Q K^T: 64 rows x 64 keys, both operands from shared memory
    float s[4 * NT];
#pragma unroll
    for (int i = 0; i < 4 * NT; ++i) s[i] = 0.f;
    fence_regs<4 * NT>(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HP / 16; ++kk)
      wgmma_ss_n64(s, desc_k_major<HP>(Qs, kk),
                   desc_k_major<HP>(Ks + stage * TILE, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<4 * NT>(s);

    // scale in f32 (log2 domain); masked entries become -inf, so that
    // exp2(-inf - m) selects probability 0 exactly (m >= -1e30 is finite)
    const bool need_mask = (k0 + kBK > S) || (causal && k0 + kBK - 1 > q0) ||
                           (window > 0 && k0 <= q0 + kBQ - 1 - window);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float t = s[4 * j + e] * scale_log2;
        if (need_mask) {
          const int qpos = r_lo + (e / 2) * 8;
          const int kpos = k0 + j * 8 + c_in + (e % 2);
          bool ok = kpos < S;
          if (causal) ok = ok && (kpos <= qpos);
          if (window > 0) ok = ok && (kpos > qpos - window);
          if (!ok) t = masked();
        }
        s[4 * j + e] = t;
      }

#pragma unroll
    for (int i = 0; i < 2; ++i) {  // rows r_lo + 8 i
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        row_max =
            fmaxf(row_max, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
      row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
      row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 2));
      const float m_new = fmaxf(m[i], row_max);
      const float alpha = exp2f(m[i] - m_new);
      m[i] = m_new;
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[4 * j + 2 * i] = exp2f(s[4 * j + 2 * i] - m_new);
        s[4 * j + 2 * i + 1] = exp2f(s[4 * j + 2 * i + 1] - m_new);
        row_sum += s[4 * j + 2 * i] + s[4 * j + 2 * i + 1];
      }
      l[i] = l[i] * alpha + row_sum;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        o[4 * d + 2 * i] *= alpha;
        o[4 * d + 2 * i + 1] *= alpha;
      }
    }

    // O += P V: P's accumulator chunks 2kk, 2kk+1 are, pair for pair, the
    // register A fragment of one m64nHPk16 over those 16 keys
    uint32_t pa[NT / 2][4];
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    fence_regs<4 * DT>(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk)
      WgmmaRS<HP>::run(o, pa[kk], desc_mn_major<HP>(Vs + stage * TILE, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<4 * DT>(o);
    __syncthreads();  // this stage is consumed before it is refilled
  }

  __nv_bfloat16* obase = out + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float row_sum = l[i];
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 1);
    row_sum += __shfl_xor_sync(0xffffffffu, row_sum, 2);
    const float denom = fmaxf(row_sum, 1e-30f);
    const int qpos = r_lo + 8 * i;
    if (qpos < S) {
#pragma unroll
      for (int d = 0; d < HD / 8; ++d)
        *reinterpret_cast<__nv_bfloat162*>(obase + qpos * o_ss + d * 8 +
                                           c_in) =
            __floats2bfloat162_rn(o[4 * d + 2 * i] / denom,
                                  o[4 * d + 2 * i + 1] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// opt in to more than 48 KB of dynamic shared memory (per device, cheap)
template <typename K>
cudaError_t opt_in(K kern, int bytes) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int S, int H, int rep, const long long* st, float sm_scale,
               int causal, int window, cudaStream_t stream) {
  auto kern = flash_fwd_f32_kernel<HD>;
  constexpr int bytes = Tiles<Pad<HD>::P>::kBytes;
  const cudaError_t err = opt_in(kern, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qb = (S + kBQ - 1) / kBQ;
  const long long n_blocks = static_cast<long long>(n_qb) * B * H;
  if (n_blocks > 2147483647LL) return -1;
  kern<<<static_cast<unsigned>(n_blocks), kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, H, rep, n_qb,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], sm_scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int S, int H, int rep, const long long* st,
                float sm_scale, int causal, int window, cudaStream_t stream) {
  auto kern = flash_fwd_bf16_kernel<HD>;
  // five tiles (Q; K and V in two stages), aligned up to 1024 bytes
  constexpr int bytes = 5 * Swz<Pad<HD>::P>::kTileBytes + 1024;
  const cudaError_t err = opt_in(kern, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qb = (S + kBQ - 1) / kBQ;
  const long long n_bh = static_cast<long long>(B) * H;
  const long long n_blocks = n_bh * n_qb;
  if (n_blocks > 2147483647LL) return -1;
  // the SMs and the blocks each holds at once (asked once per device)
  static int dev_seen = -1, n_sm = 0, per_sm = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev != dev_seen) {
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kThreadsBf16, bytes);
    if (e == cudaSuccess) dev_seen = dev;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int wave =
      n_blocks <= static_cast<long long>(n_sm) * per_sm ? n_sm : 0;
  const float log2e = 1.4426950408889634f;
  kern<<<static_cast<unsigned>(n_blocks), kThreadsBf16, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      S, H, rep, n_qb, static_cast<int>(n_bh), wave, st[0], st[1], st[2],
      st[3],
      st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      sm_scale * log2e, causal, window);
  return static_cast<int>(cudaGetLastError());
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
#define FLASH_ARGS q, k, v, out, B, S, H, rep, st, sm_scale, causal, window, stream
#define FLASH_HD(launch)                         \
  switch (hd) {                                  \
    case 16: return launch<16>(FLASH_ARGS);      \
    case 32: return launch<32>(FLASH_ARGS);      \
    case 64: return launch<64>(FLASH_ARGS);      \
    case 120: return launch<120>(FLASH_ARGS);    \
    case 128: return launch<128>(FLASH_ARGS);    \
    default: return -1;                          \
  }
  if (is_bf16) {
    FLASH_HD(launch_bf16)
  }
  FLASH_HD(launch_f32)
#undef FLASH_HD
#undef FLASH_ARGS
}
