// The three-piece bf16 split of an fp32 tensor: p0 = bf16(g), p1 =
// bf16(p0 - g), p2 = bf16((p0 - g) - p1), the differences in fp32, so that
// g == (p0 - p1) - p2 bit for bit over fp32's normal range (each difference
// is exact: 24 significand bits are three times 8; taking p0 - g, and not
// g - p0, keeps the sign of a zero). The plain version is
// kernels/ref.py::split3_bf16_ref.
//
// Replaces no TPU kernel. The JAX package's training head is one fp32
// product (repro/models/common.py chunked_xent); the port runs the head's
// fp32 products on bf16 tensor cores (models/common.py bf16_exact_mm), and
// their backward needs the fp32 logit gradient as three exact bf16 pieces.
// In plain tensor code the split is five elementwise passes over the
// gradient; this is one.
//
// What bounds it on an H100: bytes. Each fp32 value is read once (4 bytes)
// and its three pieces written once (6 bytes): at the training cell's chunk
// (2,048 rows of a 151,936 vocab) 3.1 GB, 0.93 ms at 3.35 TB/s.
//
// Design, for bandwidth. The output is (3, n), the pieces each contiguous.
// A thread takes kVec consecutive values: two 16-byte loads and a 16-byte
// store a piece for kVec = 8 (n a multiple of 8 and 16-byte aligned bases),
// one value for kVec = 1. Persistent blocks walk tiles of kThreads * kVec
// values (tile t = blockIdx.x, + gridDim.x, ...), so every value is
// written by one thread once. No arithmetic but three roundings and two
// exact subtractions; nothing to reduce.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attrs.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void split_one(float x, __nv_bfloat16* p0,
                                          __nv_bfloat16* p1,
                                          __nv_bfloat16* p2) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(x);
  const float r = __bfloat162float(hi) - x;          // exact
  const __nv_bfloat16 mid = __float2bfloat16_rn(r);
  *p0 = hi;
  *p1 = mid;
  *p2 = __float2bfloat16_rn(r - __bfloat162float(mid));   // exact
}

template <int kVec>
__global__ void __launch_bounds__(kThreads)
    split3_kernel(const float* __restrict__ g, __nv_bfloat16* __restrict__ out,
                  long long n) {
  const long long tiles = (n + kThreads * kVec - 1) / (kThreads * kVec);
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long i = (t * kThreads + threadIdx.x) * kVec;
    if (i >= n) continue;
    if constexpr (kVec == 8) {
      const float4 a = *reinterpret_cast<const float4*>(g + i);
      const float4 b = *reinterpret_cast<const float4*>(g + i + 4);
      const float x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      __align__(16) __nv_bfloat16 p[3][8];
#pragma unroll
      for (int j = 0; j < 8; ++j) split_one(x[j], &p[0][j], &p[1][j], &p[2][j]);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        *reinterpret_cast<uint4*>(out + k * n + i) =
            *reinterpret_cast<const uint4*>(p[k]);
    } else {
      split_one(g[i], out + i, out + n + i, out + 2 * n + i);
    }
  }
}

}  // namespace

// g: n fp32 values; out: (3, n) bf16. vec: 1 for 8 values a thread (n a
// multiple of 8, both bases 16-byte aligned), 0 for one. blocks: the
// persistent grid (kernels/split3.py::launch_plan).
extern "C" int repro_split3_bf16(const void* g, void* out, long long n,
                                 int vec, int blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* gp = static_cast<const float*>(g);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out);
  if (vec) {
    if (n % 8) return cudaErrorInvalidValue;
    split3_kernel<8><<<blocks, kThreads, 0, st>>>(gp, op, n);
  } else {
    split3_kernel<1><<<blocks, kThreads, 0, st>>>(gp, op, n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_attrs_split3(int i, int* out, char* label, int cap) {
  switch (i) {
    case 0:
      return repro_attrs::query(&split3_kernel<8>, "split3[vec]|float32|8",
                                out, label, cap);
    case 1:
      return repro_attrs::query(&split3_kernel<1>, "split3[scalar]|float32|1",
                                out, label, cap);
    default:
      return -1;
  }
}
