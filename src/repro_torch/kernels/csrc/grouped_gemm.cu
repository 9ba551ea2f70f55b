// Grouped GEMM: out[e] = lhs[e] . rhs[e] for every local expert, fp32
// accumulation, output in the input dtype.
//
// Replaces: src/repro/kernels/grouped_gemm.py::grouped_gemm (the "pallas"
// GroupGEMM backend, with its expert_major and n_major traversal orders).
//
// What bounds it on an H100: at the prefill shapes of qwen2-moe-2.7b,
// (64, 160, 2048) . (64, 2048, 1408) and (64, 160, 1408) . (64, 1408, 2048),
// the weight operand's bytes (369 MB, about 110 us at 3.35 TB/s) against
// 59 GFLOP (about 60 us at 989 TFLOP/s): bytes. At decode (M = 4) the bytes
// bound it by far.
//
// Design. The TPU kernel walks a sequential grid and carries its fp32
// accumulator across the K grid axis in VMEM scratch (grouped_gemm.py:33-46).
// Here one block owns one (expert, M tile, N tile) output tile and runs the
// K loop inside the block, accumulating in registers (WMMA bf16 fragments or
// fp32 FMAs). `order` is the blockIdx -> tile linearisation (common.cuh
// tile_of): n_major issues column block 0 of every expert first. On the GPU
// blocks run in parallel, so it sets issue order only. Ragged M, N and K are
// zero-filled on load and masked on store instead of padded
// (grouped_gemm_padded pads them); the rhs may be a column slice.
#include "common.cuh"
#include "attrs.cuh"

using namespace repro;

namespace {

constexpr int BK = 64;

template <typename T, int BM, int BN> struct GemmSmem {
  static constexpr int LDA = BK + 8, LDB = BN + 8;
  static constexpr size_t A = 0;
  static constexpr size_t B = A + align128(sizeof(T) * BM * LDA);
  static constexpr size_t LOOP = B + align128(sizeof(T) * BK * LDB);
  static constexpr size_t OUT = out_stage_bytes<BM, BN>();
  static constexpr size_t BYTES = LOOP > OUT ? LOOP : OUT;
};

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kThreads)
    grouped_gemm_kernel(const T* __restrict__ lhs, long long sle,
                        long long slm, const T* __restrict__ rhs,
                        long long sre, long long srk, T* __restrict__ out,
                        int E, int M, int K, int N, int order) {
  using L = GemmSmem<T, BM, BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* as = reinterpret_cast<T*>(smem + L::A);
  T* bs = reinterpret_cast<T*>(smem + L::B);

  const int MT = (M + BM - 1) / BM, NT = (N + BN - 1) / BN;
  const Tile t = tile_of(blockIdx.x, E, MT, NT, order);
  const int m0 = t.m * BM, n0 = t.n * BN;
  const T* le = lhs + t.e * sle + m0 * slm;
  const T* re = rhs + t.e * sre + n0;

  Acc<T, BM, BN> acc;
  acc.zero();
  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile<T, BM, BK>(as, L::LDA, le + k0, slm, M - m0, K - k0);
    load_tile<T, BK, BN>(bs, L::LDB, re + k0 * srk, srk, K - k0, N - n0);
    __syncthreads();
    acc.mma(as, L::LDA, bs, L::LDB, BK);
    __syncthreads();
  }
  store_tile<T, BM, BN>(acc, smem, out, t.e, M, N, m0, n0);
}

template <typename T, int BM, int BN>
cudaError_t launch(const void* lhs, long long sle, long long slm,
                   const void* rhs, long long sre, long long srk, void* out,
                   int E, int M, int K, int N, int order,
                   cudaStream_t stream) {
  using L = GemmSmem<T, BM, BN>;
  auto kern = grouped_gemm_kernel<T, BM, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::BYTES));
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>(E) * ((M + BM - 1) / BM) *
                          ((N + BN - 1) / BN);
  kern<<<static_cast<unsigned>(tiles), kThreads, L::BYTES, stream>>>(
      static_cast<const T*>(lhs), sle, slm, static_cast<const T*>(rhs), sre,
      srk, static_cast<T*>(out), E, M, K, N, order);
  return cudaGetLastError();
}

}  // namespace

// lhs: (E, M, K) with strides (sle, slm, 1); rhs: (E, K, N) with strides
// (sre, srk, 1); out: (E, M, N) contiguous. dtype 0 = fp32, 1 = bf16;
// order 0 = expert_major, 1 = n_major. Returns the launch's CUDA error.
extern "C" int repro_grouped_gemm(const void* lhs, long long sle,
                                  long long slm, const void* rhs,
                                  long long sre, long long srk, void* out,
                                  int E, int M, int K, int N, int order,
                                  int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, 64, 128>(lhs, sle, slm, rhs, sre, srk, out,
                                          E, M, K, N, order, st);
  return launch<float, 64, 64>(lhs, sle, slm, rhs, sre, srk, out, E, M, K, N,
                               order, st);
}

// The attributes of every kernel instance this file launches (attrs.cuh).
extern "C" int repro_attrs_grouped_gemm(int i, int* out, char* label, int cap) {
  switch (i) {
    case 0:
      return repro_attrs::query(&grouped_gemm_kernel<float, 64, 64>,
                                 "grouped_gemm[general]/expert_major,grouped_gemm[general]/n_major|float32|BM 64, BN 64", out,
                                 label, cap);
    case 1:
      return repro_attrs::query(&grouped_gemm_kernel<__nv_bfloat16, 64, 128>,
                                 "grouped_gemm[general]/expert_major,grouped_gemm[general]/n_major|bfloat16|BM 64, BN 128", out,
                                 label, cap);
    default:
      return -1;
  }
}
