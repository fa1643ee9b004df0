// Rowwise symmetric int8 quantize (K3a) and dequantize (K3b) for Hopper
// (sm_90a), plain C interface.
//
// Replaces the TPU kernels src/repro/kernels/quant.py:_quant_kernel (entry
// quantize_int8) and _dequant_kernel (entry dequantize_int8).  Per row of
// x (N, C), f32 or bf16 (read as f32):
//   scale = max(max|x|, 1e-12) * f32(1/127)
//   q     = clip(rint(x / scale), -127, 127)            (int8, half to even)
//   x'    = f32(q) * scale                              (f32, or bf16 RNE)
// The result must be bit-equal to the reference, so x / scale is an IEEE
// division (no fast math, never x * (1/scale)) and rintf rounds half to
// even like jnp.round.  The scale is a product with the f32 reciprocal of
// 127 because that is what the reference computes: XLA rewrites the
// division by the constant 127 into that product, in the Pallas kernel and
// in its jnp path under jit alike (an eager jnp division differs from it by
// one ulp in about 4% of rows).
//
// What bounds it on this card: bytes.  At the training path's shape
// (4, 67,108,864) f32, K3a must read x once and write q and the scales:
// 1,342,177,296 bytes, 0.40 ms at 3.35 TB/s; K3b reads q and the scales and
// writes f32: the same bytes and time.  Neither does any arithmetic worth
// counting (a compare, a division and a round an element).
//
// What the design does about it: the main path's rows are few and very long
// (4 or 16 rows of 67M elements), so one block a row, the TPU kernel's
// (block_rows, C) tile, would light 4 to 16 of 132 SMs.  Each row is cut into
// tiles of kTile elements instead, one block a tile.  The row's max|x| needs
// every tile, and blocks run in no order, so K3a is two passes: pass 1 folds
// each tile's max into amax[row] with atomicMax on the float's bits (exact:
// the values are >= 0, where the bit patterns order like the floats, and max
// does not depend on the order of the folds); pass 2 re-reads x and writes q
// and the scale.  Reading x twice puts K3a at >= 1.8x its bound at best (2.2
// of the 1.34 GB); a one-pass form for rows short enough to keep in shared
// memory is a later step.  Loads and stores are 16 bytes a thread where the
// row's width and the pointers allow it (the wrapper decides: `vec`), else
// one element a thread.  Reference tests' short rows ((300, 256) and
// the like) take the same kernels with one tile a row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kTile = 8192;        // elements of a row a block owns
constexpr float kFloor = 1e-12f;
constexpr float kInv127 = 1.0f / 127.0f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ int8_t quant_one(float v, float s) {
  const float r = rintf(v / s);
  return static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
}

// elements of one 16-byte load of the input type
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int n = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int n = 8; };

// n consecutive elements as f32, from a 16-byte aligned address
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out);
template <>
__device__ __forceinline__ void load_vec<float>(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16>(
    const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(h[i]);
}

__device__ __forceinline__ float block_max(float m) {
  __shared__ float warp_max[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < kThreads / 32 ? warp_max[threadIdx.x] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  return m;
}

// pass 1 of K3a: max |x| of one tile, folded into amax_bits[row]
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
absmax_kernel(const T* __restrict__ x, unsigned int* __restrict__ amax_bits,
              long long C, long long tiles) {
  const long long row = blockIdx.x / tiles;
  const long long start = (blockIdx.x % tiles) * kTile;
  const long long end = start + kTile < C ? start + kTile : C;
  const T* xr = x + row * C;
  float m = 0.f;
  if constexpr (VEC) {
    constexpr int n = Vec<T>::n;
    for (long long i = start + static_cast<long long>(threadIdx.x) * n;
         i < end; i += static_cast<long long>(kThreads) * n) {
      float v[n];
      load_vec<T>(xr + i, v);
#pragma unroll
      for (int j = 0; j < n; ++j) m = fmaxf(m, fabsf(v[j]));
    }
  } else {
    for (long long i = start + threadIdx.x; i < end; i += kThreads)
      m = fmaxf(m, fabsf(to_f32(xr[i])));
  }
  m = block_max(m);
  if (threadIdx.x == 0) atomicMax(amax_bits + row, __float_as_uint(m));
}

// pass 2 of K3a: q of one tile; the row's first tile writes its scale
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
quant_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
             float* __restrict__ scale,
             const unsigned int* __restrict__ amax_bits, long long C,
             long long tiles) {
  const long long row = blockIdx.x / tiles;
  const long long tile = blockIdx.x % tiles;
  const long long start = tile * kTile;
  const long long end = start + kTile < C ? start + kTile : C;
  const float s = fmaxf(__uint_as_float(amax_bits[row]), kFloor) * kInv127;
  if (tile == 0 && threadIdx.x == 0) scale[row] = s;
  const T* xr = x + row * C;
  int8_t* qr = q + row * C;
  if constexpr (VEC) {
    constexpr int n = Vec<T>::n;
    for (long long i = start + static_cast<long long>(threadIdx.x) * n;
         i < end; i += static_cast<long long>(kThreads) * n) {
      float v[n];
      load_vec<T>(xr + i, v);
      alignas(8) int8_t o[n];
#pragma unroll
      for (int j = 0; j < n; ++j) o[j] = quant_one(v[j], s);
      if constexpr (n == 4)
        *reinterpret_cast<char4*>(qr + i) = *reinterpret_cast<char4*>(o);
      else
        *reinterpret_cast<uint2*>(qr + i) = *reinterpret_cast<uint2*>(o);
    }
  } else {
    for (long long i = start + threadIdx.x; i < end; i += kThreads)
      qr[i] = quant_one(to_f32(xr[i]), s);
  }
}

// K3b: out = f32(q) * scale[row], stored as OutT
template <typename OutT, bool VEC>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
               OutT* __restrict__ out, long long C, long long tiles) {
  const long long row = blockIdx.x / tiles;
  const long long start = (blockIdx.x % tiles) * kTile;
  const long long end = start + kTile < C ? start + kTile : C;
  const float s = scale[row];
  const int8_t* qr = q + row * C;
  OutT* orow = out + row * C;
  if constexpr (VEC) {
    constexpr int n = Vec<OutT>::n;     // 16 bytes of output a thread
    for (long long i = start + static_cast<long long>(threadIdx.x) * n;
         i < end; i += static_cast<long long>(kThreads) * n) {
      alignas(8) int8_t c[n];
      if constexpr (n == 4)
        *reinterpret_cast<char4*>(c) = *reinterpret_cast<const char4*>(qr + i);
      else
        *reinterpret_cast<uint2*>(c) = *reinterpret_cast<const uint2*>(qr + i);
      alignas(16) OutT o[n];
#pragma unroll
      for (int j = 0; j < n; ++j) store(o + j, static_cast<float>(c[j]) * s);
      *reinterpret_cast<uint4*>(orow + i) = *reinterpret_cast<uint4*>(o);
    }
  } else {
    for (long long i = start + threadIdx.x; i < end; i += kThreads)
      store(orow + i, static_cast<float>(qr[i]) * s);
  }
}

bool grid_of(long long N, long long C, long long* tiles, unsigned* blocks) {
  if (N <= 0 || C <= 0) return false;
  *tiles = (C + kTile - 1) / kTile;
  const long long total = N * *tiles;
  if (total > 2147483647LL) return false;
  *blocks = static_cast<unsigned>(total);
  return true;
}

template <typename T, bool VEC>
int quantize(const void* x, void* q, void* scale, void* amax, long long N,
             long long C, cudaStream_t stream) {
  long long tiles;
  unsigned blocks;
  if (!grid_of(N, C, &tiles, &blocks)) return -1;
  unsigned int* bits = static_cast<unsigned int*>(amax);
  cudaError_t err = cudaMemsetAsync(bits, 0, N * sizeof(unsigned int),
                                    stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  absmax_kernel<T, VEC><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), bits, C, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  quant_kernel<T, VEC><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(scale), bits, C, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT, bool VEC>
int dequantize(const void* q, const void* scale, void* out, long long N,
               long long C, cudaStream_t stream) {
  long long tiles;
  unsigned blocks;
  if (!grid_of(N, C, &tiles, &blocks)) return -1;
  dequant_kernel<OutT, VEC><<<blocks, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scale),
      static_cast<OutT*>(out), C, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K3a.  x (N, C) f32 or bf16 (is_bf16), dense; q (N, C) int8 and scale
// (N,) f32 out; amax (N,) 4-byte scratch, zeroed here.  vec = 1 takes
// 16-byte loads: C must be a multiple of 4 (f32) or 8 (bf16) and x, q
// 16-byte aligned (the wrapper checks).  Returns cudaGetLastError() after
// the launches (0 = launched), or -1 for a shape the kernels do not take.
extern "C" int quantize_int8(const void* x, void* q, void* scale, void* amax,
                             long long N, long long C, int is_bf16, int vec,
                             void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (is_bf16)
    return vec ? quantize<__nv_bfloat16, true>(x, q, scale, amax, N, C, stream)
               : quantize<__nv_bfloat16, false>(x, q, scale, amax, N, C,
                                                stream);
  return vec ? quantize<float, true>(x, q, scale, amax, N, C, stream)
             : quantize<float, false>(x, q, scale, amax, N, C, stream);
}

// K3b.  q (N, C) int8 and scale (N,) f32, dense; out (N, C) f32 or bf16
// (out_bf16).  vec = 1 takes 16-byte stores: C a multiple of 4 (f32) or 8
// (bf16), q and out 16-byte aligned.  Returns as quantize_int8.
extern "C" int dequantize_int8(const void* q, const void* scale, void* out,
                               long long N, long long C, int out_bf16,
                               int vec, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (out_bf16)
    return vec ? dequantize<__nv_bfloat16, true>(q, scale, out, N, C, stream)
               : dequantize<__nv_bfloat16, false>(q, scale, out, N, C,
                                                  stream);
  return vec ? dequantize<float, true>(q, scale, out, N, C, stream)
             : dequantize<float, false>(q, scale, out, N, C, stream);
}
