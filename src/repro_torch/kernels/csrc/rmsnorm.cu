// RMSNorm over the last axis: fp32 mean of squares, x * rsqrt(var + eps),
// times the scale, in one of two epilogues.
//
// Replaces: src/repro/kernels/rmsnorm.py::rmsnorm (its body at :11-15), and
// on the port's paths every model norm region (repro/models/common.py
// rms_norm, through apply_norm and the Mamba-2 block's gated norm).
//
// Epilogues (the template parameter kModel):
//   tpu    y * scale in fp32 and one rounding to x's dtype: the TPU kernel's
//          function (rmsnorm.py:14-15).
//   model  the model's rounding points (models/common.py:82-85): round
//          x * rsqrt(var + eps) to x's dtype, multiply by the scale rounded
//          to x's dtype, round again. Every model call site uses it, so the
//          port's bf16 token streams keep the JAX package's numerics.
// In fp32 the two compute the same thing.
//
// What bounds it on an H100: bytes. Each row is read once and written once
// and the scale is shared (L2-resident): at the mamba2-780m prefill step
// (2048 rows of 1536, bf16) 12.6 MB, about 3.8 us at 3.35 TB/s. At decode
// (8 rows) the launch sets the pace.
//
// Design. One block per row, as many threads as the row has 16-byte
// vectors (a multiple of 32, at most 512), each holding NV of them in
// registers (NV = 1 up to 4096 bf16 values, at most kNV), so x is read from
// device memory once. NV is a template parameter picked at launch: the
// registers a thread holds are allocated for the largest row it could
// take, and a fixed kNV would cap the blocks an SM runs at once. 16-byte
// loads and stores (8 bf16 or 4 fp32 values) where the width allows; a
// width that is not a multiple of the vector (rows then start unaligned)
// takes the scalar path, kNV values a thread. The sum of squares is fp32,
// reduced by warp shuffles and then across warps in shared memory; one
// rsqrt per row, then the epilogue on the values in registers.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kNV = 8;   // the most vectors of a row a thread holds

// the sum of v over the block; blockDim.x is a multiple of 32
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x / 32) ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

// V values per access: 16 / sizeof(T) (one 16-byte vector) or 1 (scalar)
template <typename T, int V> struct Pack {
  float v[V];
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (V * sizeof(T) == 16) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int q = 0; q < V; ++q) v[q] = to_f(e[q]);
    } else {
#pragma unroll
      for (int q = 0; q < V; ++q) v[q] = to_f(p[q]);
    }
  }
  __device__ __forceinline__ void store(T* p) const {
    if constexpr (V * sizeof(T) == 16) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int q = 0; q < V; ++q) e[q] = from_f<T>(v[q]);
      *reinterpret_cast<uint4*>(p) = raw;
    } else {
#pragma unroll
      for (int q = 0; q < V; ++q) p[q] = from_f<T>(v[q]);
    }
  }
};

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

template <typename T, typename TS, int V, int NV, bool kModel>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_kernel(const T* __restrict__ x, const TS* __restrict__ scale,
                   T* __restrict__ y, int d, float eps) {
  __shared__ float red[33];
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  const int nvec = d / V;
  Pack<T, V> pk[NV];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = threadIdx.x + i * blockDim.x;
    if (j < nvec) {
      pk[i].load(xr + j * V);
#pragma unroll
      for (int q = 0; q < V; ++q) ss = fmaf(pk[i].v[q], pk[i].v[q], ss);
    }
  }
  const float r = rsqrtf(block_sum(ss, red) / static_cast<float>(d) + eps);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = threadIdx.x + i * blockDim.x;
    if (j < nvec) {
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const float s = to_f(__ldg(scale + j * V + q));
        if constexpr (kModel)
          pk[i].v[q] = round_to<T>(pk[i].v[q] * r) * round_to<T>(s);
        else
          pk[i].v[q] = pk[i].v[q] * r * s;
      }
      pk[i].store(yr + j * V);
    }
  }
}

template <typename T, typename TS, int V, int NV>
cudaError_t launch_nv(const void* x, const void* scale, void* y, int rows,
                      int d, float eps, int epilogue, int threads,
                      cudaStream_t stream) {
  auto kern = epilogue == 1 ? rmsnorm_kernel<T, TS, V, NV, true>
                            : rmsnorm_kernel<T, TS, V, NV, false>;
  kern<<<static_cast<unsigned>(rows), threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const TS*>(scale),
      static_cast<T*>(y), d, eps);
  return cudaGetLastError();
}

template <typename T, typename TS, int V>
cudaError_t launch(const void* x, const void* scale, void* y, int rows,
                   int d, float eps, int epilogue, cudaStream_t st) {
  const int nvec = d / V;
  int threads = (nvec + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (threads < 32) threads = 32;
  const int need = (nvec + threads - 1) / threads;   // vectors a thread
  if (need > kNV) return cudaErrorInvalidValue;
  if constexpr (V == 1) {
    return launch_nv<T, TS, 1, kNV>(x, scale, y, rows, d, eps, epilogue,
                                    threads, st);
  } else {
    if (need == 1)
      return launch_nv<T, TS, V, 1>(x, scale, y, rows, d, eps, epilogue,
                                    threads, st);
    if (need == 2)
      return launch_nv<T, TS, V, 2>(x, scale, y, rows, d, eps, epilogue,
                                    threads, st);
    if (need <= 4)
      return launch_nv<T, TS, V, 4>(x, scale, y, rows, d, eps, epilogue,
                                    threads, st);
    return launch_nv<T, TS, V, kNV>(x, scale, y, rows, d, eps, epilogue,
                                    threads, st);
  }
}

template <typename T, typename TS>
cudaError_t dispatch_vec(const void* x, const void* scale, void* y, int rows,
                         int d, float eps, int epilogue, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = d % V == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (vec) return launch<T, TS, V>(x, scale, y, rows, d, eps, epilogue, st);
  return launch<T, TS, 1>(x, scale, y, rows, d, eps, epilogue, st);
}

}  // namespace

// x, y: (rows, d) contiguous; scale: (d,) contiguous. xdtype: 0 = fp32,
// 1 = bf16; sdtype: 0 = fp32, 1 = x's dtype (bf16); epilogue: 0 = tpu,
// 1 = model. d is at most 512 * 8 vectors (16 bytes each, or one element
// when d is not a multiple of the vector). Returns the launch's CUDA error.
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* y,
                             int rows, int d, float eps, int xdtype,
                             int sdtype, int epilogue, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (xdtype == 1) {
    if (sdtype == 1)
      return dispatch_vec<__nv_bfloat16, __nv_bfloat16>(x, scale, y, rows, d,
                                                        eps, epilogue, st);
    return dispatch_vec<__nv_bfloat16, float>(x, scale, y, rows, d, eps,
                                              epilogue, st);
  }
  if (sdtype == 1) return cudaErrorInvalidValue;   // fp32 x, bf16 scale
  return dispatch_vec<float, float>(x, scale, y, rows, d, eps, epilogue, st);
}
