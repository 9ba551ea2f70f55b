// Top-k combine: out[t] = sum_j w[t, j] * rows[t, j, :], summed in fp32 in
// j order, output in the rows' dtype.
//
// Replaces: src/repro/kernels/topk_combine.py::topk_combine (the MoE layer's
// layer-1 consumer, every MoE layer through routing.combine).
//
// What bounds it on an H100: bytes, T*k*d*2 + T*k*4 + T*d*2 for bf16 rows.
// At a 2048-token prefill step (k 4, d 2048) that is about 42 MB, about
// 12.5 us at 3.35 TB/s; at decode (T = 8) about 0.2 MB, so a launch and one
// round trip to device memory set the pace.
//
// Design. A thread owns `per` 16-byte pieces of one output row (pieces
// blockDim apart, so a warp's loads are contiguous). The kernel is
// instantiated for k = 2, 4 and 8 (every arch's top-k but k = 1 and 6): the
// k weights go into registers once, and all per x k 16-byte loads of a
// thread are issued before its first product, so each thread keeps up to
// 16 loads in flight where a runtime loop over k kept one. Other k take a
// generic instance with a loop. The launch (kernels/topk_combine.py
// launch_plan) gives each thread two pieces at k = 2 on large inputs, and
// spreads a row over several blocks when T is small (decode), so more SMs
// issue loads. Each sum is a rounded product, then a rounded add, in j
// order (no fused multiply-add): the bits of the plain j-order sum
// (ref.topk_combine_ordered). Every input byte is read once.
#include "common.cuh"
#include "attrs.cuh"

using namespace repro;

namespace {

template <typename T, int K, int PER>
__global__ void topk_combine_vec(const T* __restrict__ rows,
                                 const float* __restrict__ w,
                                 T* __restrict__ out, int k, int d,
                                 int span) {
  constexpr int V = 16 / sizeof(T);
  const long long t = blockIdx.x;
  const int np = d / V;
  const int c0 = blockIdx.y * span + threadIdx.x;
  const T* rt = rows + t * k * d;
  T* ot = out + t * d;
  if constexpr (K > 0) {
    float wr[K];
#pragma unroll
    for (int j = 0; j < K; ++j) wr[j] = __ldg(w + t * K + j);
    uint4 raw[PER][K];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = c0 + i * blockDim.x;
      if (c < np)
#pragma unroll
        for (int j = 0; j < K; ++j)
          raw[i][j] = __ldg(reinterpret_cast<const uint4*>(
              rt + static_cast<long long>(j) * d + c * V));
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = c0 + i * blockDim.x;
      if (c >= np) continue;
      float acc[V];
#pragma unroll
      for (int q = 0; q < V; ++q) acc[q] = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const T* v = reinterpret_cast<const T*>(&raw[i][j]);
#pragma unroll
        for (int q = 0; q < V; ++q)
          acc[q] = __fadd_rn(acc[q], __fmul_rn(wr[j], to_f(v[q])));
      }
      uint4 o;
      T* ov = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int q = 0; q < V; ++q) ov[q] = from_f<T>(acc[q]);
      *reinterpret_cast<uint4*>(ot + c * V) = o;
    }
  } else {
    const float* wt = w + t * k;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = c0 + i * blockDim.x;
      if (c >= np) continue;
      float acc[V];
#pragma unroll
      for (int q = 0; q < V; ++q) acc[q] = 0.f;
      for (int j = 0; j < k; ++j) {
        const float wj = __ldg(wt + j);
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
            rt + static_cast<long long>(j) * d + c * V));
        const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int q = 0; q < V; ++q)
          acc[q] = __fadd_rn(acc[q], __fmul_rn(wj, to_f(v[q])));
      }
      uint4 o;
      T* ov = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int q = 0; q < V; ++q) ov[q] = from_f<T>(acc[q]);
      *reinterpret_cast<uint4*>(ot + c * V) = o;
    }
  }
}

// rows whose width or base rules out 16-byte pieces: one element a piece
template <typename T>
__global__ void topk_combine_scalar(const T* __restrict__ rows,
                                    const float* __restrict__ w,
                                    T* __restrict__ out, int k, int d,
                                    int per, int span) {
  const long long t = blockIdx.x;
  const T* rt = rows + t * k * d;
  const float* wt = w + t * k;
  for (int i = 0; i < per; ++i) {
    const int c = blockIdx.y * span + threadIdx.x + i * blockDim.x;
    if (c >= d) return;
    float acc = 0.f;
    for (int j = 0; j < k; ++j) {
      const float v = to_f(rt[static_cast<long long>(j) * d + c]);
      acc = __fadd_rn(acc, __fmul_rn(wt[j], v));
    }
    out[t * d + c] = from_f<T>(acc);
  }
}

template <typename T, int K, int PER>
void launch_vec(const void* rows, const void* w, void* out, int k, int d,
                dim3 grid, int threads, int span, cudaStream_t stream) {
  topk_combine_vec<T, K, PER><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(rows), static_cast<const float*>(w),
      static_cast<T*>(out), k, d, span);
}

// the instances the plan asks for: k = 2, 4, 8 or generic at one piece a
// thread; k = 2 or generic (k = 1) at two
template <typename T>
void by_k(const void* rows, const void* w, void* out, int k, int d, int per,
          dim3 grid, int threads, int span, cudaStream_t stream) {
  if (per == 2) {
    if (k == 2)
      return launch_vec<T, 2, 2>(rows, w, out, k, d, grid, threads, span,
                                 stream);
    return launch_vec<T, 0, 2>(rows, w, out, k, d, grid, threads, span,
                               stream);
  }
  switch (k) {
    case 2: return launch_vec<T, 2, 1>(rows, w, out, k, d, grid, threads,
                                       span, stream);
    case 4: return launch_vec<T, 4, 1>(rows, w, out, k, d, grid, threads,
                                       span, stream);
    case 8: return launch_vec<T, 8, 1>(rows, w, out, k, d, grid, threads,
                                       span, stream);
    default: return launch_vec<T, 0, 1>(rows, w, out, k, d, grid, threads,
                                        span, stream);
  }
}

template <typename T>
cudaError_t launch(const void* rows, const void* w, void* out, int T_, int k,
                   int d, int vec, int threads, int per, int col_blocks,
                   cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(T_),
                  static_cast<unsigned>(col_blocks));
  const int span = threads * per;
  if (!vec) {
    topk_combine_scalar<T><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(rows), static_cast<const float*>(w),
        static_cast<T*>(out), k, d, per, span);
  } else if (per == 1 || per == 2) {
    by_k<T>(rows, w, out, k, d, per, grid, threads, span, stream);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// rows: (T, k, d) contiguous; w: (T, k) fp32 contiguous; out: (T, d)
// contiguous. dtype 0 = fp32, 1 = bf16. vec: 16-byte pieces (d a multiple
// of 16 bytes' elements, rows and out 16-byte aligned), else one element a
// piece; threads per block, pieces per thread (per: 1 or 2 with vec) and
// blocks per row as kernels/topk_combine.py launch_plan gives them.
// Returns the launch's CUDA error.
extern "C" int repro_topk_combine(const void* rows, const void* w, void* out,
                                  int T, int k, int d, int dtype, int vec,
                                  int threads, int per, int col_blocks,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(rows, w, out, T, k, d, vec, threads, per,
                                 col_blocks, st);
  return launch<float>(rows, w, out, T, k, d, vec, threads, per, col_blocks,
                       st);
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The attributes of every kernel instance this file launches (attrs.cuh).
extern "C" int repro_attrs_topk_combine(int i, int* out, char* label, int cap) {
  switch (i) {
    case 0:
      return repro_attrs::query(&topk_combine_vec<float, 2, 2>,
                                 "topk_combine[2]|float32|K 2, PER 2", out,
                                 label, cap);
    case 1:
      return repro_attrs::query(&topk_combine_vec<float, 0, 2>,
                                 "topk_combine[generic]|float32|K 0, PER 2", out,
                                 label, cap);
    case 2:
      return repro_attrs::query(&topk_combine_vec<float, 2, 1>,
                                 "topk_combine[2]|float32|K 2, PER 1", out,
                                 label, cap);
    case 3:
      return repro_attrs::query(&topk_combine_vec<float, 4, 1>,
                                 "topk_combine[4]|float32|K 4, PER 1", out,
                                 label, cap);
    case 4:
      return repro_attrs::query(&topk_combine_vec<float, 8, 1>,
                                 "topk_combine[8]|float32|K 8, PER 1", out,
                                 label, cap);
    case 5:
      return repro_attrs::query(&topk_combine_vec<float, 0, 1>,
                                 "topk_combine[generic]|float32|K 0, PER 1", out,
                                 label, cap);
    case 6:
      return repro_attrs::query(&topk_combine_vec<__nv_bfloat16, 2, 2>,
                                 "topk_combine[2]|bfloat16|K 2, PER 2", out,
                                 label, cap);
    case 7:
      return repro_attrs::query(&topk_combine_vec<__nv_bfloat16, 0, 2>,
                                 "topk_combine[generic]|bfloat16|K 0, PER 2", out,
                                 label, cap);
    case 8:
      return repro_attrs::query(&topk_combine_vec<__nv_bfloat16, 2, 1>,
                                 "topk_combine[2]|bfloat16|K 2, PER 1", out,
                                 label, cap);
    case 9:
      return repro_attrs::query(&topk_combine_vec<__nv_bfloat16, 4, 1>,
                                 "topk_combine[4]|bfloat16|K 4, PER 1", out,
                                 label, cap);
    case 10:
      return repro_attrs::query(&topk_combine_vec<__nv_bfloat16, 8, 1>,
                                 "topk_combine[8]|bfloat16|K 8, PER 1", out,
                                 label, cap);
    case 11:
      return repro_attrs::query(&topk_combine_vec<__nv_bfloat16, 0, 1>,
                                 "topk_combine[generic]|bfloat16|K 0, PER 1", out,
                                 label, cap);
    case 12:
      return repro_attrs::query(&topk_combine_scalar<float>,
                                 "topk_combine[generic]|float32|scalar", out,
                                 label, cap);
    case 13:
      return repro_attrs::query(&topk_combine_scalar<__nv_bfloat16>,
                                 "topk_combine[generic]|bfloat16|scalar", out,
                                 label, cap);
    default:
      return -1;
  }
}
