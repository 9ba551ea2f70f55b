// Top-k combine: out[t] = sum_j w[t, j] * rows[t, j, :], fp32 sum, output
// in the rows' dtype.
//
// Replaces: src/repro/kernels/topk_combine.py::topk_combine (the MoE layer's
// layer-1 consumer, every MoE layer through routing.combine).
//
// What bounds it on an H100: bytes, T*k*d*2 + T*k*4 + T*d*2 for bf16 rows.
// At decode (T = 8, k = 4, d = 2048) that is about 0.2 MB, so the launch
// sets the pace; at a 2048-token prefill step it is about 42 MB, about 13 us
// at 3.35 TB/s.
//
// Design. One block per token row (and per 2048-column slab of wider rows);
// each thread owns 16 contiguous bytes of the output row, reads the k
// matching 16-byte pieces of the expert rows, sums them in fp32 in k order
// and writes once. Every input byte is read once, with 16-byte loads
// whenever the row width allows.
#include "common.cuh"

using namespace repro;

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    topk_combine_kernel(const T* __restrict__ rows,
                        const float* __restrict__ w, T* __restrict__ out,
                        int k, int d) {
  constexpr int V = 16 / sizeof(T);
  const long long t = blockIdx.x;
  const T* rt = rows + t * k * d;
  const float* wt = w + t * k;
  T* ot = out + t * d;
  const bool vec = (d % V) == 0 &&
                   (reinterpret_cast<uintptr_t>(rows) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) % 16) == 0;
  if (vec) {
    for (int c = (blockIdx.y * kThreads + threadIdx.x) * V; c < d;
         c += gridDim.y * kThreads * V) {
      float acc[V];
#pragma unroll
      for (int q = 0; q < V; ++q) acc[q] = 0.f;
      for (int j = 0; j < k; ++j) {
        const float wj = wt[j];
        const uint4 raw = __ldg(
            reinterpret_cast<const uint4*>(rt + static_cast<long long>(j) * d + c));
        const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int q = 0; q < V; ++q) acc[q] = fmaf(wj, to_f(v[q]), acc[q]);
      }
      uint4 o;
      T* ov = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int q = 0; q < V; ++q) ov[q] = from_f<T>(acc[q]);
      *reinterpret_cast<uint4*>(ot + c) = o;
    }
  } else {
    for (int c = blockIdx.y * kThreads + threadIdx.x; c < d;
         c += gridDim.y * kThreads) {
      float acc = 0.f;
      for (int j = 0; j < k; ++j)
        acc = fmaf(wt[j], to_f(rt[static_cast<long long>(j) * d + c]), acc);
      ot[c] = from_f<T>(acc);
    }
  }
}

template <typename T>
cudaError_t launch(const void* rows, const void* w, void* out, int T_, int k,
                   int d, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int slabs = (d + kThreads * V - 1) / (kThreads * V);
  const dim3 grid(static_cast<unsigned>(T_), static_cast<unsigned>(slabs));
  topk_combine_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(rows), static_cast<const float*>(w),
      static_cast<T*>(out), k, d);
  return cudaGetLastError();
}

}  // namespace

// rows: (T, k, d) contiguous; w: (T, k) fp32 contiguous; out: (T, d)
// contiguous. dtype 0 = fp32, 1 = bf16. Returns the launch's CUDA error.
extern "C" int repro_topk_combine(const void* rows, const void* w, void* out,
                                  int T, int k, int d, int dtype,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<__nv_bfloat16>(rows, w, out, T, k, d, st);
  return launch<float>(rows, w, out, T, k, d, st);
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
