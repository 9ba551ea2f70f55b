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
// and the scale is shared: at the mamba2-780m prefill step (2048 rows of
// 1536, bf16) 12.6 MB, about 3.8 us at 3.35 TB/s. At decode (8 rows) the
// launch and one round trip to device memory set the pace.
//
// Design, for bandwidth. A row belongs to one warp, or to 2-16 warps for
// the widest rows (a "row group"; kernels/rmsnorm.py::launch_plan picks
// the warps per row so that a lane holds at most 8 vectors, NV, a template
// parameter), and a block holds several row groups. The blocks are
// persistent: the grid is capped near 32 resident warps per SM and each
// row group strides over the rows. A lane holds its vectors of the row as
// they were loaded (16-byte vectors of 8 bf16 or 4 fp32 values, or single
// values for a width that is not a multiple of the vector), and issues the
// loads of its next row before the reduction and the stores of the current
// one, so each lane keeps up to 2 NV vectors in flight. The scale is read
// once per block, as 16-byte vectors, into shared memory in the epilogue's
// form (fp32; rounded to x's dtype for the model epilogue). The sum of
// squares is fp32, per lane in vector order, then a warp-shuffle
// butterfly; a row of several warps adds its warps' sums in warp order
// through shared memory behind a named barrier of its own warps (no block
// barrier in the row loop). The reduction order is fixed by the width, so
// two calls give the same bits.
#include <type_traits>

#include "attrs.cuh"
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;

// V values of T as one load: a 16-byte vector or (V == 1) one value
template <typename T, int V> struct Pack {
  static constexpr bool kVec = V * sizeof(T) == 16;
  using Raw = typename std::conditional<kVec, uint4, T>::type;
  Raw raw;
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kVec)
      raw = __ldg(reinterpret_cast<const uint4*>(p));
    else
      raw = p[0];
  }
  __device__ __forceinline__ float at(int q) const {
    if constexpr (kVec)
      return to_f(reinterpret_cast<const T*>(&raw)[q]);
    else
      return to_f(raw);
  }
};

template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// V scale values at p, as fp32: 16-byte vectors where V values fill whole
// vectors, else one at a time
template <typename TS, int V>
__device__ __forceinline__ void load_scale(const TS* p, float (&s)[V]) {
  if constexpr ((V * sizeof(TS)) % 16 == 0) {
    constexpr int per = 16 / sizeof(TS);
#pragma unroll
    for (int c = 0; c < V / per; ++c) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p) + c);
      const TS* e = reinterpret_cast<const TS*>(&raw);
#pragma unroll
      for (int q = 0; q < per; ++q) s[c * per + q] = to_f(e[q]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < V; ++q) s[q] = to_f(p[q]);
  }
}

// a barrier among the n threads (whole warps) of named barrier `id`
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

template <typename T, typename TS, int V, int NV, bool kModel,
          bool kRegScale>
__global__ void __launch_bounds__(kMaxThreads)
    rmsnorm_kernel(const T* __restrict__ x, const TS* __restrict__ scale,
                   T* __restrict__ y, int rows, int d, float eps, int wpr) {
  extern __shared__ float sc[];            // d values: the epilogue's scale
  __shared__ float red[2][kMaxWarps];      // multi-warp rows, by row parity
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = warp / wpr, groups = blockDim.x / (32 * wpr);
  const int gl = (warp % wpr) * 32 + lane;  // this lane's first vector
  const int span = 32 * wpr;                // vectors between a lane's
  const int nvec = d / V;
  const long long step = static_cast<long long>(gridDim.x) * groups;
  long long row = static_cast<long long>(blockIdx.x) * groups + group;

  Pack<T, V> cur[NV], nxt[NV];
  if (row < rows) {
    const T* xr = x + row * d;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (gl + i * span < nvec) cur[i].load(xr + (gl + i * span) * V);
  }
  // the scale, while the first row is in flight: kRegScale (a block of
  // one row) each lane its own vectors, into registers, rounded for the
  // model epilogue where they are used (rounding them here made an 8-row
  // call slower on an H100); else once per block into shared
  // memory in the epilogue's form, where a thread takes at most NV vectors
  // (blockDim.x >= 32 wpr) and issues all their loads before the first
  // store, so the block pays one round trip
  float sr[kRegScale ? NV : 1][V];
  if constexpr (kRegScale) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (gl + i * span < nvec)
        load_scale<TS, V>(scale + (gl + i * span) * V, sr[i]);
  } else {
    float s[NV][V];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = threadIdx.x + i * blockDim.x;
      if (j < nvec) load_scale<TS, V>(scale + j * V, s[i]);
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = threadIdx.x + i * blockDim.x;
      if (j < nvec) {
#pragma unroll
        for (int q = 0; q < V; ++q)
          sc[j * V + q] = kModel ? round_to<T>(s[i][q]) : s[i][q];
      }
    }
    __syncthreads();
  }

  for (int it = 0; row < rows; row += step, ++it) {
    // the next row's loads go out before this row's reduction and stores
    const long long next = row + step;
    if (next < rows) {
      const T* xn = x + next * d;
#pragma unroll
      for (int i = 0; i < NV; ++i)
        if (gl + i * span < nvec) nxt[i].load(xn + (gl + i * span) * V);
    }
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (gl + i * span < nvec) {
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const float v = cur[i].at(q);
          ss = fmaf(v, v, ss);
        }
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (wpr > 1) {
      float* part = red[it & 1] + group * wpr;
      if (lane == 0) part[warp % wpr] = ss;
      bar_sync(1 + group, span);
      ss = 0.f;
      for (int k = 0; k < wpr; ++k) ss += part[k];
    }
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    T* yr = y + row * d;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = gl + i * span;
      if (j < nvec) {
        Pack<T, V> o;
        T* e = reinterpret_cast<T*>(&o.raw);
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const float v = cur[i].at(q);
          float s;
          if constexpr (kRegScale)
            s = kModel ? round_to<T>(sr[i][q]) : sr[i][q];
          else
            s = sc[j * V + q];
          e[q] = from_f<T>(kModel ? round_to<T>(v * r) * s : v * r * s);
        }
        *reinterpret_cast<typename Pack<T, V>::Raw*>(yr + j * V) = o.raw;
      }
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) cur[i] = nxt[i];
  }
}

template <typename T, typename TS, int V, int NV, bool kRegScale>
cudaError_t launch_nv(const void* x, const void* scale, void* y, int rows,
                      int d, float eps, int epilogue, int wpr, int groups,
                      int blocks, cudaStream_t stream) {
  auto kern = epilogue == 1 ? rmsnorm_kernel<T, TS, V, NV, true, kRegScale>
                            : rmsnorm_kernel<T, TS, V, NV, false, kRegScale>;
  const size_t smem = kRegScale ? 0 : static_cast<size_t>(d) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kern<<<static_cast<unsigned>(blocks), 32 * wpr * groups, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const TS*>(scale),
      static_cast<T*>(y), rows, d, eps, wpr);
  return cudaGetLastError();
}

template <typename T, typename TS, int V>
cudaError_t launch(const void* x, const void* scale, void* y, int rows,
                   int d, float eps, int epilogue, int wpr, int nv,
                   int groups, int blocks, int reg_scale, cudaStream_t st) {
  // the scale in registers only for a block of one row of at most 2
  // vectors a lane (the plan's few-rows case)
  if (reg_scale)
    return nv == 1 ? launch_nv<T, TS, V, 1, true>(x, scale, y, rows, d, eps,
                                                  epilogue, wpr, groups,
                                                  blocks, st)
                   : launch_nv<T, TS, V, 2, true>(x, scale, y, rows, d, eps,
                                                  epilogue, wpr, groups,
                                                  blocks, st);
  switch (nv) {
    case 1:
      return launch_nv<T, TS, V, 1, false>(x, scale, y, rows, d, eps,
                                           epilogue, wpr, groups, blocks, st);
    case 2:
      return launch_nv<T, TS, V, 2, false>(x, scale, y, rows, d, eps,
                                           epilogue, wpr, groups, blocks, st);
    case 4:
      return launch_nv<T, TS, V, 4, false>(x, scale, y, rows, d, eps,
                                           epilogue, wpr, groups, blocks, st);
    case 6:
      return launch_nv<T, TS, V, 6, false>(x, scale, y, rows, d, eps,
                                           epilogue, wpr, groups, blocks, st);
    default:
      return launch_nv<T, TS, V, 8, false>(x, scale, y, rows, d, eps,
                                           epilogue, wpr, groups, blocks, st);
  }
}

template <typename T, typename TS>
cudaError_t dispatch_vec(const void* x, const void* scale, void* y, int rows,
                         int d, float eps, int epilogue, int vec, int wpr,
                         int nv, int groups, int blocks, int reg_scale,
                         cudaStream_t st) {
  constexpr int VV = 16 / sizeof(T);
  const int V = vec ? VV : 1;
  // the plan must cover the row and fit a block
  const bool wpr_ok = wpr == 1 || wpr == 2 || wpr == 4 || wpr == 8 ||
                      wpr == 16;
  const bool nv_ok = nv == 1 || nv == 2 || nv == 4 || nv == 6 || nv == 8;
  if (!wpr_ok || !nv_ok || groups < 1 || blocks < 1 ||
      (reg_scale && (nv > 2 || groups != 1 ||
                     static_cast<long long>(blocks) < rows)) ||
      32 * wpr * groups > kMaxThreads || d % V != 0 ||
      static_cast<long long>(nv) * 32 * wpr * V < d ||
      (vec && (reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
               reinterpret_cast<uintptr_t>(y) % 16 != 0 ||
               reinterpret_cast<uintptr_t>(scale) % 16 != 0)))
    return cudaErrorInvalidValue;
  if (vec)
    return launch<T, TS, VV>(x, scale, y, rows, d, eps, epilogue, wpr, nv,
                             groups, blocks, reg_scale, st);
  return launch<T, TS, 1>(x, scale, y, rows, d, eps, epilogue, wpr, nv,
                          groups, blocks, reg_scale, st);
}

}  // namespace

// x, y: (rows, d) contiguous; scale: (d,) contiguous. xdtype: 0 = fp32,
// 1 = bf16; sdtype: 0 = fp32, 1 = x's dtype (bf16); epilogue: 0 = tpu,
// 1 = model. The launch plan (kernels/rmsnorm.py::launch_plan): vec 1 for
// 16-byte vectors (d a multiple of the vector, x, y and scale 16-byte
// aligned), 0 for single values; wpr warps per row (1, 2, 4, 8 or 16); nv
// vectors (or values) per lane (1, 2, 4, 6 or 8); groups rows per block;
// blocks the persistent grid; reg_scale 1 for the scale in registers (a
// block per row, nv <= 2), 0 for shared memory. Returns the launch's CUDA
// error.
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* y,
                             int rows, int d, float eps, int xdtype,
                             int sdtype, int epilogue, int vec, int wpr,
                             int nv, int groups, int blocks, int reg_scale,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (xdtype == 1) {
    if (sdtype == 1)
      return dispatch_vec<__nv_bfloat16, __nv_bfloat16>(
          x, scale, y, rows, d, eps, epilogue, vec, wpr, nv, groups, blocks,
          reg_scale, st);
    return dispatch_vec<__nv_bfloat16, float>(x, scale, y, rows, d, eps,
                                              epilogue, vec, wpr, nv, groups,
                                              blocks, reg_scale, st);
  }
  if (sdtype == 1) return cudaErrorInvalidValue;   // fp32 x, bf16 scale
  return dispatch_vec<float, float>(x, scale, y, rows, d, eps, epilogue, vec,
                                    wpr, nv, groups, blocks, reg_scale, st);
}

namespace {

const char* dtype_name(float) { return "float32"; }
const char* dtype_name(__nv_bfloat16) { return "bfloat16"; }

template <typename T, typename TS, int V, int NV, bool kModel, bool kRegScale>
int rmsnorm_attrs(int* out, char* label, int cap) {
  char text[128];
  snprintf(text, sizeof(text), "rmsnorm|%s|scale %s, V %d, NV %d, %s, %s",
           dtype_name(T()), dtype_name(TS()), V, NV,
           kModel ? "model" : "tpu", kRegScale ? "scale in registers"
                                               : "scale in shared memory");
  return repro_attrs::query(&rmsnorm_kernel<T, TS, V, NV, kModel, kRegScale>,
                            text, out, label, cap);
}

using AttrsFn = int (*)(int*, char*, int);
constexpr int kPerVector = 14;   // launch_nv's instances at one (T, TS, V)

// the instances launch() reaches at one (T, TS, V): the scale in registers
// at NV 1 and 2, in shared memory at NV 1, 2, 4, 6 and 8, both epilogues
template <typename T, typename TS, int V>
int rmsnorm_attrs_at(int i, int* out, char* label, int cap) {
  static const AttrsFn fns[kPerVector] = {
      rmsnorm_attrs<T, TS, V, 1, true, true>,
      rmsnorm_attrs<T, TS, V, 1, false, true>,
      rmsnorm_attrs<T, TS, V, 2, true, true>,
      rmsnorm_attrs<T, TS, V, 2, false, true>,
      rmsnorm_attrs<T, TS, V, 1, true, false>,
      rmsnorm_attrs<T, TS, V, 1, false, false>,
      rmsnorm_attrs<T, TS, V, 2, true, false>,
      rmsnorm_attrs<T, TS, V, 2, false, false>,
      rmsnorm_attrs<T, TS, V, 4, true, false>,
      rmsnorm_attrs<T, TS, V, 4, false, false>,
      rmsnorm_attrs<T, TS, V, 6, true, false>,
      rmsnorm_attrs<T, TS, V, 6, false, false>,
      rmsnorm_attrs<T, TS, V, 8, true, false>,
      rmsnorm_attrs<T, TS, V, 8, false, false>};
  return fns[i](out, label, cap);
}

}  // namespace

// The attributes of every kernel instance this file launches (attrs.cuh):
// dispatch_vec's (T, TS) pairs, each at the 16-byte vector and at V 1.
extern "C" int repro_attrs_rmsnorm(int i, int* out, char* label, int cap) {
  using bf16 = __nv_bfloat16;
  if (i < 0 || i >= 6 * kPerVector) return -1;
  const int j = i % kPerVector;
  switch (i / kPerVector) {
    case 0: return rmsnorm_attrs_at<bf16, bf16, 8>(j, out, label, cap);
    case 1: return rmsnorm_attrs_at<bf16, bf16, 1>(j, out, label, cap);
    case 2: return rmsnorm_attrs_at<bf16, float, 8>(j, out, label, cap);
    case 3: return rmsnorm_attrs_at<bf16, float, 1>(j, out, label, cap);
    case 4: return rmsnorm_attrs_at<float, float, 4>(j, out, label, cap);
    default: return rmsnorm_attrs_at<float, float, 1>(j, out, label, cap);
  }
}
