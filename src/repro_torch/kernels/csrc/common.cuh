// Shared pieces of the port's hand-written Hopper kernels: type conversion,
// the expert MLP's activations, a zero-filling global->shared tile copy and
// a block-wide (BM x BN) fp32 accumulator tile.
//
// Every kernel here runs 256 threads (8 warps) per block. The accumulator is
// specialised per element type: bf16 tiles go through the tensor cores with
// WMMA 16x16x16 fragments (fp32 accumulation); fp32 tiles use plain FMAs so
// an fp32 product stays exact fp32 (no TF32). WMMA and the FMA path read the
// same row-major shared-memory tiles, so each kernel body is written once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace repro {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, like astype
}

constexpr size_t align128(size_t b) { return (b + 127) / 128 * 128; }

// gelu with the tanh approximation (jax.nn.gelu's default)
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(k * (x + 0.044715f * x * x * x)));
}

// d gelu_tanh / dx: the derivative JAX's autodiff takes of jax.nn.gelu
__device__ __forceinline__ float gelu_tanh_grad(float x) {
  const float k = 0.7978845608028654f;
  const float t = tanhf(k * (x + 0.044715f * x * x * x));
  return 0.5f * (1.f + t) +
         0.5f * x * (1.f - t * t) * k * (1.f + 3.f * 0.044715f * x * x);
}

enum Act { kSwiglu = 0, kGeglu = 1, kGelu = 2, kRelu2 = 3 };

// models/common.activate on fp32 pre-activations; gate is ignored by the
// non-GLU activations
__device__ __forceinline__ float activate(int act, float g, float u) {
  switch (act) {
    case kSwiglu: return g / (1.f + expf(-g)) * u;
    case kGeglu: return gelu_tanh(g) * u;
    case kGelu: return gelu_tanh(u);
    default: {
      const float r = fmaxf(u, 0.f);
      return r * r;
    }
  }
}

// The activation's VJP in fp32: (dg, du) for h = activate(act, g, u) and the
// cotangent dh; dg = 0 for the non-GLU activations
__device__ __forceinline__ void activate_vjp(int act, float g, float u,
                                             float dh, float& dg, float& du) {
  switch (act) {
    case kSwiglu: {
      const float s = 1.f / (1.f + expf(-g));
      dg = dh * u * s * (1.f + g * (1.f - s));
      du = dh * g * s;
      break;
    }
    case kGeglu:
      dg = dh * u * gelu_tanh_grad(g);
      du = dh * gelu_tanh(g);
      break;
    case kGelu:
      dg = 0.f;
      du = dh * gelu_tanh_grad(u);
      break;
    default:
      dg = 0.f;
      du = dh * 2.f * fmaxf(u, 0.f);
  }
}

// Copy a ROWS x COLS tile of a row-major global matrix (leading dimension
// ldg elements, unit column stride) into shared memory (leading dimension
// lds), zero-filling rows >= rows_valid and columns >= cols_valid: the
// kernels mask ragged edges here instead of padding their operands. Whole
// tiles whose rows start 16-byte aligned move as 16-byte vectors.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(T* s, int lds, const T* g,
                                          long long ldg, int rows_valid,
                                          int cols_valid) {
  constexpr int V = 16 / sizeof(T);
  static_assert(COLS % V == 0, "tile width must hold whole 16-byte vectors");
  const bool vec = cols_valid >= COLS && (ldg % V) == 0 &&
                   (reinterpret_cast<uintptr_t>(g) % 16) == 0;
  if (vec) {
    constexpr int CV = COLS / V;
    for (int i = threadIdx.x; i < ROWS * CV; i += kThreads) {
      const int r = i / CV, c = (i % CV) * V;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows_valid)
        v = __ldg(reinterpret_cast<const uint4*>(g + r * ldg + c));
      *reinterpret_cast<uint4*>(s + r * lds + c) = v;
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += kThreads) {
      const int r = i / COLS, c = i % COLS;
      s[r * lds + c] = (r < rows_valid && c < cols_valid) ? g[r * ldg + c]
                                                          : from_f<T>(0.f);
    }
  }
}

// A BM x BN fp32 accumulator spread over the block. mma() adds
// A (BM x K) . B (K x BN), both row-major in shared memory; store() writes
// the sums row-major to fp32 shared memory.
template <typename T, int BM, int BN> struct Acc;

template <int BM, int BN> struct Acc<__nv_bfloat16, BM, BN> {
  static constexpr int FN = BN / 16, NFRAG = (BM / 16) * FN;
  static constexpr int PER = (NFRAG + 7) / 8;  // fragments per warp
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> c[PER];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < PER; ++i) nvcuda::wmma::fill_fragment(c[i], 0.f);
  }

  // A (BM x K) and B (K x BN) in shared memory, row-major by default;
  // AT / BT read A / B column-major (A(r, k) = A[k * lda + r], B(k, n) =
  // B[n * ldb + k]): a transposed operand in its stored layout, no copy
  template <bool AT = false, bool BT = false>
  __device__ void mma(const __nv_bfloat16* A, int lda, const __nv_bfloat16* B,
                      int ldb, int K) {
    using namespace nvcuda;
    using LA = typename std::conditional<AT, wmma::col_major,
                                         wmma::row_major>::type;
    using LB = typename std::conditional<BT, wmma::col_major,
                                         wmma::row_major>::type;
    const int w = threadIdx.x / 32;
    for (int k = 0; k < K; k += 16) {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int f = w + 8 * i;
        if (f < NFRAG) {  // warp-uniform
          const int fm = f / FN, fn = f % FN;
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LA> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LB> b;
          wmma::load_matrix_sync(
              a, AT ? A + k * lda + fm * 16 : A + fm * 16 * lda + k, lda);
          wmma::load_matrix_sync(
              b, BT ? B + fn * 16 * ldb + k : B + k * ldb + fn * 16, ldb);
          wmma::mma_sync(c[i], a, b, c[i]);
        }
      }
    }
  }

  // the sums from a row-major fp32 matrix (shared or device memory) whose
  // tile lies wholly inside it
  __device__ void load(const float* S, int lds) {
    const int w = threadIdx.x / 32;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int f = w + 8 * i;
      if (f < NFRAG) {
        const int fm = f / FN, fn = f % FN;
        nvcuda::wmma::load_matrix_sync(c[i], S + fm * 16 * lds + fn * 16,
                                       lds, nvcuda::wmma::mem_row_major);
      }
    }
  }

  // f(c, a.c, b.c) on matching elements, each by reference
  template <typename F> __device__ void zip(Acc& a, Acc& b, F f) {
#pragma unroll
    for (int i = 0; i < PER; ++i)
#pragma unroll
      for (int j = 0; j < c[i].num_elements; ++j)
        f(c[i].x[j], a.c[i].x[j], b.c[i].x[j]);
  }

  // c = f(other.c, c) elementwise: two accumulators of the same shape hold
  // matching elements at matching fragment positions
  template <typename F> __device__ void combine(const Acc& other, F f) {
#pragma unroll
    for (int i = 0; i < PER; ++i)
#pragma unroll
      for (int j = 0; j < c[i].num_elements; ++j)
        c[i].x[j] = f(other.c[i].x[j], c[i].x[j]);
  }

  __device__ void store(float* S, int lds) const {
    const int w = threadIdx.x / 32;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int f = w + 8 * i;
      if (f < NFRAG) {
        const int fm = f / FN, fn = f % FN;
        nvcuda::wmma::store_matrix_sync(S + fm * 16 * lds + fn * 16, c[i],
                                        lds, nvcuda::wmma::mem_row_major);
      }
    }
  }
};

template <int BM, int BN> struct Acc<float, BM, BN> {
  static constexpr int PER = (BM * BN + kThreads - 1) / kThreads;
  float c[PER];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < PER; ++i) c[i] = 0.f;
  }

  template <bool AT = false, bool BT = false>
  __device__ void mma(const float* A, int lda, const float* B, int ldb,
                      int K) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = threadIdx.x + kThreads * i;
      if (idx < BM * BN) {
        const int r = idx / BN, n = idx % BN;
        float s = c[i];
        for (int k = 0; k < K; ++k)
          s = fmaf(AT ? A[k * lda + r] : A[r * lda + k],
                   BT ? B[n * ldb + k] : B[k * ldb + n], s);
        c[i] = s;
      }
    }
  }

  __device__ void load(const float* S, int lds) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = threadIdx.x + kThreads * i;
      if (idx < BM * BN) c[i] = S[(idx / BN) * lds + idx % BN];
    }
  }

  template <typename F> __device__ void zip(Acc& a, Acc& b, F f) {
#pragma unroll
    for (int i = 0; i < PER; ++i) f(c[i], a.c[i], b.c[i]);
  }

  template <typename F> __device__ void combine(const Acc& other, F f) {
#pragma unroll
    for (int i = 0; i < PER; ++i) c[i] = f(other.c[i], c[i]);
  }

  __device__ void store(float* S, int lds) const {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = threadIdx.x + kThreads * i;
      if (idx < BM * BN) S[(idx / BN) * lds + idx % BN] = c[i];
    }
  }
};

// A register-tiled product over the block, in fp32 FMAs (an fp32 product
// stays exact fp32, and bf16 factors are exact in fp32): thread t owns the
// outputs (rg + RG * i, cg + CG * j), i < TM, j < TN, with cg = t % CG,
// rg = t / CG, RG = kThreads / CG, and adds sum_k A(r, k) * B(k, c) to
// acc[i][j], where A(r, k) = A[r * a_r + k * a_k] and
// B(k, c) = B[k * b_k + c * b_c] lie in shared memory. Interleaved rows and
// columns put a warp's B reads on neighbouring addresses.
template <int TM, int TN, int CG, typename TA, typename TB>
__device__ __forceinline__ void fma_tile(float (&acc)[TM][TN], const TA* A,
                                         int a_r, int a_k, const TB* B,
                                         int b_k, int b_c, int K) {
  constexpr int RG = kThreads / CG;
  static_assert(kThreads % CG == 0, "column groups must tile the block");
  const TA* a = A + (threadIdx.x / CG) * a_r;
  const TB* b = B + (threadIdx.x % CG) * b_c;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = to_f(a[i * RG * a_r + k * a_k]);
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = to_f(b[k * b_k + j * CG * b_c]);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Output tile coordinates of a linear block id. The TPU kernels' grid order
// becomes this linearisation: expert_major puts the N tile innermost (an
// expert's tiles are issued together), n_major puts it outermost (column
// block 0 of every expert is issued first). Blocks run in parallel on the
// GPU, so the order only sets issue order, not completion order.
struct Tile {
  int e, m, n;
};

__device__ __forceinline__ Tile tile_of(long long id, int E, int MT, int NT,
                                        int order) {
  Tile t;
  if (order == 0) {  // expert_major: (E, Mt, Nt)
    t.n = static_cast<int>(id % NT);
    t.m = static_cast<int>((id / NT) % MT);
    t.e = static_cast<int>(id / (static_cast<long long>(NT) * MT));
  } else {  // n_major: (Nt, E, Mt)
    t.m = static_cast<int>(id % MT);
    t.e = static_cast<int>((id / MT) % E);
    t.n = static_cast<int>(id / (static_cast<long long>(MT) * E));
  }
  return t;
}

// Stage the accumulator through shared memory (the caller has synchronised
// after its last use of `smem`) and write the valid part of the tile to
// out[e] (R x N, row-major), cast to T. Ends synchronised, so `smem` may be
// reused at once.
template <typename T, int BM, int BN, typename AccT>
__device__ __forceinline__ void store_tile(const AccT& acc, unsigned char* smem,
                                           T* out, int e, int R, int N, int m0,
                                           int n0) {
  constexpr int LDO = BN + 4;
  float* os = reinterpret_cast<float*>(smem);
  acc.store(os, LDO);
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
    const int r = i / BN, c = i % BN;
    if (m0 + r < R && n0 + c < N)
      out[(static_cast<long long>(e) * R + m0 + r) * N + n0 + c] =
          from_f<T>(os[r * LDO + c]);
  }
  __syncthreads();
}

template <int BM, int BN> constexpr size_t out_stage_bytes() {
  return align128(sizeof(float) * BM * (BN + 4));
}

// The split-f kernels' second pass: out[row, n] = sum over the NF f-chunk
// planes of part[fc, row, n] (each plane rows x N), summed in f-chunk order
// (deterministic, no atomics) and cast to T. One block per (row, slab of
// kSlab columns); order 0 (expert_major) puts rows outermost, 1 (n_major)
// column slabs.
constexpr int kSlab = 1024;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sum_partials_kernel(const float* __restrict__ part, T* __restrict__ out,
                        int rows, int N, int NF, int order) {
  const int slabs = (N + kSlab - 1) / kSlab;
  const long long id = blockIdx.x;
  long long row;
  int sb;
  if (order == 0) {
    row = id / slabs;
    sb = static_cast<int>(id % slabs);
  } else {
    sb = static_cast<int>(id / rows);
    row = id % rows;
  }
  const long long plane = static_cast<long long>(rows) * N;
  for (int c = sb * kSlab + threadIdx.x; c < min(N, (sb + 1) * kSlab);
       c += kThreads) {
    const float* p = part + row * N + c;
    float s = 0.f;
    for (int fc = 0; fc < NF; ++fc) s += p[fc * plane];
    out[row * N + c] = from_f<T>(s);
  }
}

template <typename T>
cudaError_t sum_partials(const float* part, T* out, int rows, int N, int NF,
                         int order, cudaStream_t stream) {
  const long long blocks =
      static_cast<long long>(rows) * ((N + kSlab - 1) / kSlab);
  sum_partials_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                           stream>>>(part, out, rows, N, NF, order);
  return cudaGetLastError();
}

}  // namespace repro
