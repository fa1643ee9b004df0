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
// would matter — so the least time is (KV bytes read) / (memory rate), and
// the whole design is about keeping the memory busy.  Two things stop a
// one-block-per-(sequence, kv head) walk from doing so: the longest
// sequence's block is the critical path while blocks of short sequences
// leave their SMs idle, and every position's K/V address waits on a table
// entry read from device memory, so each step pays two dependent round
// trips with nothing in flight across steps.
//
// What the design does about it (flash-decoding with a page ring):
//  * The sequence is split over blocks.  paged_decode_split_kernel runs a
//    grid (n_split, Kv * n_pass, S); a block covers `span` pages of one
//    (sequence, kv head) and the query heads [r0, r0 + R) of its group (rep
//    is covered in n_pass = ceil(rep / R) passes, heads past rep masked).
//    A block whose split starts at or past ceil(length / page_size)
//    returns at once.  The wrapper picks span from static sizes only.
//  * The block reads its slice of the block table into shared memory once,
//    before any K/V load, so no K/V address waits on device memory.
//  * K/V come through a ring of `slots` tiles in shared memory, filled with
//    16-byte cp.async.cg copies, one commit group a tile: tiles k+1 ..
//    k+slots-1 are in flight while tile k's scores and p.v run, and tile k's
//    slot is refilled once its compute is done — the reference's DMA
//    schedule.  A tile is one page's K and V rows of the kv head (for head
//    g, fused heads 2g and 2g+1: page_size runs of 2*hd elements, one every
//    2*Kv*hd), or a part of a page where one page would not fit.  slots is
//    buffer_depth where that many tiles fit in the block's shared memory,
//    else as many as fit (at least one), and at most 8.
//  * Compute is on the CUDA cores: a thread group of hd*sizeof(T)/16 lanes
//    owns one position at a time (a 16-byte shared-memory read each of K
//    and V), a score is a lane-partial dot product finished by warp
//    shuffles, and every group keeps its own online-softmax state
//    (m, l, acc) in f32 registers; the groups are merged in a fixed order
//    through shared memory (reusing the ring) into the split's partial
//    state, written in f32 to scratch (S, H, n_split, hd + 2): acc, m, l.
//  * paged_decode_combine_kernel, grid (ceil(H / heads a block), S), merges
//    the live splits of each (sequence, head) in split order with
//    exp(m_i - m) weights and writes the output in q's dtype.  No atomics:
//    two calls on the same inputs give bit-identical outputs.
//
// Masking: a block reads tables[s, j] only for j < ceil(length / page_size)
// and copies only rows of positions < length; positions at or past length
// are neither loaded nor weighted (their probability is a selected 0), so
// the trash page, unowned pages and the tail of the last page cannot reach
// the output, and an empty split writes nothing.  Lengths past the table's
// reach are clamped to max_pages * page_size.  Strides are in elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;          // split kernel
constexpr int kCombineThreads = 128;   // combine kernel (heads of hd lanes)
constexpr int kCombineBatch = 8;       // splits whose loads it issues at once
constexpr int kMaxSlots = 8;           // cp.async.wait_group takes a constant
constexpr int kMaxSmem = 232448;       // dynamic shared memory a block can use

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wait until at most n of this thread's newest commit groups are pending
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// what the host fixes for one call (by value: the kernel's parameter space)
struct Geo {
  int H, rep, n_pass, page_size, max_pages, span, n_split, tile, slots;
  int region_bytes;     // ring (or, after the loop, the group merge) bytes
  long long q_ss, q_sh, p_sp, p_st, p_sh;
  float sm_scale;
};

template <typename T, int HD>
struct Shape {
  static constexpr int VEC = Vec16<T>::N;
  static constexpr int TG = HD / VEC;          // lanes that share a position
  static constexpr int NG = kThreads / TG;     // thread groups in the block
  static constexpr int UNR = NG >= 16 ? 1 : 16 / NG;  // positions a group
  //                                                     takes per step
  static constexpr int CPR = 2 * HD / VEC;     // 16-byte chunks of a
  //                                              position's K and V rows
  static constexpr int RSTEP = kThreads / CPR; // rows the block copies at
  //                                              once (a thread: one chunk)
  static_assert(TG >= 1 && TG <= 32 && (TG & (TG - 1)) == 0, "group size");
  static_assert(kThreads % CPR == 0, "a copy step is whole rows");
};

// (tile k of the split) -> its page within the split, first position
// within the page, and the number of its rows that lie before length
struct TileAt {
  int pj, off, rows;
  __device__ __forceinline__ TileAt(int k, int tpp, int tile, int ps, int p0,
                                    int length) {
    pj = k / tpp;
    off = (k - pj * tpp) * tile;
    rows = min(min(tile, ps - off), length - ((p0 + pj) * ps + off));
  }
};

template <typename T, int HD, int R>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ pool,
                          const int* __restrict__ tables,
                          const int* __restrict__ lengths,
                          float* __restrict__ part, const Geo geo) {
  using Sh = Shape<T, HD>;
  constexpr int VEC = Sh::VEC, TG = Sh::TG, NG = Sh::NG, UNR = Sh::UNR;
  constexpr int CPR = Sh::CPR, RSTEP = Sh::RSTEP, ROW = 2 * HD;
  extern __shared__ __align__(16) unsigned char smem[];

  const int split = blockIdx.x;
  const int g = blockIdx.y / geo.n_pass;
  const int r0 = (blockIdx.y % geo.n_pass) * R;
  const int s = blockIdx.z;
  const int ps = geo.page_size;
  // a length past the table's reach would index the table out of bounds
  const int length = max(0, min(lengths[s], geo.max_pages * ps));
  const int n_pages = (length + ps - 1) / ps;
  const int p0 = split * geo.span;
  if (p0 >= n_pages) return;          // an empty split writes nothing
  const int p1 = min(p0 + geo.span, n_pages);
  const int tile = geo.tile;
  const int tpp = (ps + tile - 1) / tile;          // tiles a page
  const int last = min(p1 * ps, length) - (p1 - 1) * ps;   // in [1, ps]
  const int n_tiles = (p1 - 1 - p0) * tpp + (last + tile - 1) / tile;

  const int tid = threadIdx.x;
  const int gid = tid / TG;
  const int lane = tid % TG;
  T* ring = reinterpret_cast<T*>(smem);
  int* s_tbl = reinterpret_cast<int*>(smem + geo.region_bytes);
  const int slot_elems = tile * ROW;

  // the split's slice of the block table, once, before any K/V load
  const int* table = tables + static_cast<long long>(s) * geo.max_pages;
  for (int i = tid; i < p1 - p0; i += kThreads) s_tbl[i] = table[p0 + i];
  __syncthreads();

  // this thread's chunk of every copied row: rows row0, row0 + RSTEP, ...,
  // 16-byte chunk `chunk` of each (of K's row if chunk < hd / VEC, else of
  // V's)
  const int row0 = tid / CPR;
  const int chunk = tid % CPR;
  const int half = chunk / (HD / VEC);
  const int e0 = (chunk - half * (HD / VEC)) * VEC;
  const T* head = pool + (2 * g + half) * geo.p_sh + e0;   // kv head g
  const int dst0 = row0 * ROW + half * HD + e0;
  auto issue = [&](int k, int slot) {
    const TileAt at(k, tpp, tile, ps, p0, length);
    const T* src = head + static_cast<long long>(s_tbl[at.pj]) * geo.p_sp +
                   (at.off + row0) * geo.p_st;
    T* dst = ring + slot * slot_elems + dst0;
    for (int row = row0; row < at.rows; row += RSTEP) {
      cp_async16(dst, src);
      dst += RSTEP * ROW;
      src += RSTEP * geo.p_st;
    }
  };

  float qf[R][VEC];
  float acc[R][VEC];
  float m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) { acc[i][e] = 0.f; qf[i][e] = 0.f; }
    if (r0 + i < geo.rep) {
      const int h = g * geo.rep + r0 + i;
      Vec16<T>::widen(
          Vec16<T>::load_raw(q + s * geo.q_ss + h * geo.q_sh + lane * VEC),
          qf[i]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) qf[i][e] *= geo.sm_scale;
    }
  }

  // warm-up: fill the ring (one commit group a slot, empty past the end, so
  // that group k is always the k-th committed)
  const int slots = geo.slots;
  for (int k = 0; k < slots; ++k) {
    if (k < n_tiles) issue(k, k);
    cp_async_commit();
  }

  for (int k = 0; k < n_tiles; ++k) {
    cp_async_wait_pending(slots - 1);     // this thread's copies of tile k
    __syncthreads();                      // everyone's copies of tile k
    const int slot = k % slots;
    const int rows = TileAt(k, tpp, tile, ps, p0, length).rows;
    const T* tb = ring + slot * slot_elems;
    // uniform trip count over the block: every lane reaches every shuffle
    for (int t0 = 0; t0 < rows; t0 += NG * UNR) {
      bool valid[UNR];
      typename Vec16<T>::Raw vraw[UNR];
      float sc[R][UNR];
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        const int t = t0 + u * NG + gid;
        valid[u] = t < rows;
        float kf[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[e] = 0.f;
        if (valid[u]) {
          const T* rp = tb + t * ROW + lane * VEC;
          Vec16<T>::widen(Vec16<T>::load_raw(rp), kf);
          vraw[u] = Vec16<T>::load_raw(rp + HD);
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) d += qf[i][e] * kf[e];
          sc[i][u] = d;
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
#pragma unroll
          for (int o = TG / 2; o > 0; o >>= 1)
            sc[i][u] += __shfl_xor_sync(0xffffffffu, sc[i][u], o);
        }
      }
      float p[R][UNR];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        float m_new = m[i];
#pragma unroll
        for (int u = 0; u < UNR; ++u)
          if (valid[u]) m_new = fmaxf(m_new, sc[i][u]);
        const float alpha = expf(m[i] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int u = 0; u < UNR; ++u) {
          p[i][u] = valid[u] ? expf(sc[i][u] - m_new) : 0.f;
          psum += p[i][u];
        }
        l[i] = l[i] * alpha + psum;
        m[i] = m_new;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[i][e] *= alpha;
      }
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
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
    __syncthreads();                      // everyone is done with the slot
    if (k + slots < n_tiles) issue(k + slots, slot);
    cp_async_commit();
  }

  // merge the groups' states in group order, in the ring's memory (no copy
  // is pending: every tile's group was waited for, later groups are empty)
  float* s_acc = reinterpret_cast<float*>(smem);     // [NG][R][HD]
  float* s_m = s_acc + NG * R * HD;                  // [NG][R]
  float* s_l = s_m + NG * R;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (lane == 0) {
      s_m[gid * R + i] = m[i];
      s_l[gid * R + i] = l[i];
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      s_acc[(gid * R + i) * HD + lane * VEC + e] = acc[i][e];
  }
  __syncthreads();
  for (int idx = tid; idx < R * HD; idx += kThreads) {
    const int i = idx / HD;
    const int d = idx % HD;
    if (r0 + i >= geo.rep) continue;
    float mx = kNegInf;
    for (int gg = 0; gg < NG; ++gg) mx = fmaxf(mx, s_m[gg * R + i]);
    float lsum = 0.f, a = 0.f;
    for (int gg = 0; gg < NG; ++gg) {
      const float w = expf(s_m[gg * R + i] - mx);
      lsum += s_l[gg * R + i] * w;
      a += s_acc[(gg * R + i) * HD + d] * w;
    }
    float* dst = part + ((static_cast<long long>(s) * geo.H + g * geo.rep +
                          r0 + i) * geo.n_split + split) * (HD + 2);
    dst[d] = a;
    if (d == 0) {
      dst[HD] = mx;
      dst[HD + 1] = lsum;
    }
  }
}

// one thread per (head, d): the live splits of (s, h), in split order; the
// loads of kCombineBatch splits are issued together (they come from L2,
// and a serial chain of them is what such a small kernel waits on)
template <typename T, int HD>
__global__ void __launch_bounds__(kCombineThreads)
paged_decode_combine_kernel(const float* __restrict__ part,
                            const int* __restrict__ lengths,
                            T* __restrict__ out, int H, int page_size,
                            int max_pages, int span, int n_split,
                            long long o_ss, long long o_sh) {
  constexpr int PER = kCombineThreads / HD;      // heads a block
  const int h = blockIdx.x * PER + threadIdx.x / HD;
  const int d = threadIdx.x % HD;
  const int s = blockIdx.y;
  if (h >= H) return;
  const int length = max(0, min(lengths[s], max_pages * page_size));
  const int n_live = ((length + page_size - 1) / page_size + span - 1) / span;
  const float* src = part + (static_cast<long long>(s) * H + h) * n_split *
                                (HD + 2);
  constexpr int B = kCombineBatch;
  float mx = kNegInf;
  for (int i0 = 0; i0 < n_live; i0 += B) {
    float mb[B];
#pragma unroll
    for (int j = 0; j < B; ++j)
      mb[j] = i0 + j < n_live ? src[(i0 + j) * (HD + 2) + HD] : kNegInf;
#pragma unroll
    for (int j = 0; j < B; ++j) mx = fmaxf(mx, mb[j]);
  }
  float lsum = 0.f, a = 0.f;
  for (int i0 = 0; i0 < n_live; i0 += B) {
    float mb[B], lb[B], ab[B];
#pragma unroll
    for (int j = 0; j < B; ++j) {
      const bool live = i0 + j < n_live;
      const float* split = src + (i0 + j) * (HD + 2);
      mb[j] = live ? split[HD] : kNegInf;
      lb[j] = live ? split[HD + 1] : 0.f;
      ab[j] = live ? split[d] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < B; ++j) {
      if (i0 + j < n_live) {
        const float w = expf(mb[j] - mx);
        lsum += lb[j] * w;
        a += ab[j] * w;
      }
    }
  }
  out[s * o_ss + h * o_sh + d] = Vec16<T>::store(a / fmaxf(lsum, 1e-30f));
}

struct Call {
  const void* q;
  const void* pool;
  const int* tables;
  const int* lengths;
  void* out;
  float* part;
  int S, Kv;
  long long o_ss, o_sh;
  cudaStream_t stream;
};

template <typename T, int HD, int R>
int launch(const Call& c, Geo geo) {
  using Sh = Shape<T, HD>;
  geo.n_pass = (geo.rep + R - 1) / R;
  if (static_cast<long long>(c.Kv) * geo.n_pass > 65535) return -1;
  const long long ring = static_cast<long long>(geo.slots) * geo.tile * 2 *
                         HD * static_cast<long long>(sizeof(T));
  const long long merge = (static_cast<long long>(Sh::NG) * R * HD +
                           2LL * Sh::NG * R) * 4;
  const long long region = ((ring > merge ? ring : merge) + 15) / 16 * 16;
  const long long bytes = region + 4LL * geo.span;
  if (bytes > kMaxSmem) return -1;
  geo.region_bytes = static_cast<int>(region);
  auto kern = paged_decode_split_kernel<T, HD, R>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(geo.n_split, c.Kv * geo.n_pass, c.S);
  kern<<<grid, kThreads, static_cast<size_t>(bytes), c.stream>>>(
      static_cast<const T*>(c.q), static_cast<const T*>(c.pool), c.tables,
      c.lengths, c.part, geo);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int PER = kCombineThreads / HD;
  const dim3 cgrid((geo.H + PER - 1) / PER, c.S);
  paged_decode_combine_kernel<T, HD><<<cgrid, PER * HD, 0, c.stream>>>(
      c.part, c.lengths, static_cast<T*>(c.out), geo.H,
      geo.page_size, geo.max_pages, geo.span, geo.n_split, c.o_ss, c.o_sh);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_rep(const Call& c, const Geo& geo) {
  if (geo.rep == 1) return launch<T, HD, 1>(c, geo);
  if (geo.rep == 2) return launch<T, HD, 2>(c, geo);
  return launch<T, HD, 4>(c, geo);
}

template <typename T>
int launch_hd(int hd, const Call& c, const Geo& geo) {
  switch (hd) {
    case 16: return launch_rep<T, 16>(c, geo);
    case 32: return launch_rep<T, 32>(c, geo);
    case 64: return launch_rep<T, 64>(c, geo);
    case 128: return launch_rep<T, 128>(c, geo);
    default: return -1;
  }
}

}  // namespace

// Launches the split kernel and then the combine kernel on the stream.
// part (S, H, n_split, hd + 2) is f32 scratch the caller allocates (a
// split's acc, then its m and l); span pages a split, n_split =
// ceil(max_pages / span), tile positions a ring slot (<= page_size), slots
// ring slots (1..8).  Returns cudaGetLastError() after the launches (0 =
// launched), or -1 for a shape the kernel does not take.
extern "C" int paged_attention_decode(
    const void* q, const void* pool, const void* tables_ptr,
    const void* lengths_ptr, void* out, void* part, int S, int H, int Kv,
    int hd, int page_size, int max_pages, int span, int n_split, int tile,
    int slots,
    long long q_ss, long long q_sh, long long p_sp, long long p_st,
    long long p_sh, long long o_ss, long long o_sh, float sm_scale,
    int is_bf16, void* stream_ptr) {
  if (S <= 0 || S > 65535 || Kv <= 0 || H % Kv != 0 || page_size <= 0 ||
      max_pages <= 0 ||
      static_cast<long long>(max_pages) * page_size > 2147483647LL ||
      span <= 0 || n_split != (max_pages + span - 1) / span || tile <= 0 ||
      tile > page_size || slots <= 0 || slots > kMaxSlots)
    return -1;
  Geo geo;
  geo.H = H;
  geo.rep = H / Kv;
  geo.n_pass = 1;
  geo.page_size = page_size;
  geo.max_pages = max_pages;
  geo.span = span;
  geo.n_split = n_split;
  geo.tile = tile;
  geo.slots = slots;
  geo.region_bytes = 0;
  geo.q_ss = q_ss;
  geo.q_sh = q_sh;
  geo.p_sp = p_sp;
  geo.p_st = p_st;
  geo.p_sh = p_sh;
  geo.sm_scale = sm_scale;
  const Call c{q, pool, static_cast<const int*>(tables_ptr),
               static_cast<const int*>(lengths_ptr), out,
               static_cast<float*>(part), S, Kv, o_ss, o_sh,
               static_cast<cudaStream_t>(stream_ptr)};
  if (is_bf16) return launch_hd<__nv_bfloat16>(hd, c, geo);
  return launch_hd<float>(hd, c, geo);
}
