// A device-side spin for degraded-fabric injection, plain C interface.
//
// The counterpart of the reference's _burn (src/repro/fabric/inject.py:59),
// an XLA while_loop of `iters` trips of v = v * 1.000000119 + 1e-9 in f32
// seeded at 1.  It is not a TPU kernel and replaces none: it delays the
// work queued behind it on its stream, so a fabric condition can hold a
// bucket's chain back by a calibrated time (fabric/inject.py).
//
// One thread does the trips in order; each depends on the last, so the
// loop runs at one multiply and one add of latency a trip.  The multiply
// and the add round separately (__fmul_rn, __fadd_rn: no contraction into
// an FMA), as the plain loop on the host computes them, so `sink` holds
// the same f32 value bit for bit.  `sink` is a scratch float of the
// caller's; nothing else is read or written, so the burn is value-neutral
// by construction, and the store of v keeps the compiler from removing
// the loop.

#include <cuda_runtime.h>

namespace {

__global__ void burn_kernel(float* sink, long long iters) {
  float v = 1.0f;
  for (long long i = 0; i < iters; ++i)
    v = __fadd_rn(__fmul_rn(v, 1.000000119f), 1e-9f);
  *sink = v;
}

}  // namespace

extern "C" int fabric_burn(void* sink, long long iters, void* stream_ptr) {
  if (iters < 0) return -1;
  burn_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<float*>(sink), iters);
  return static_cast<int>(cudaGetLastError());
}
