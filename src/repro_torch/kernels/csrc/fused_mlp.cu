// Fused expert MLP: out[e] = act(x[e] . Wg[e], x[e] . Wu[e]).astype(in) . Wd[e]
//
// Replaces: src/repro/kernels/fused_mlp.py::fused_mlp (the "pallas_fused"
// GroupGEMM backend, forward). The hidden activations never get a device
// memory address: each f-chunk of the hidden lives in shared memory only.
//
// What bounds it on an H100: at decode (R = 4 rows per expert, 64 experts,
// d = 2048, f = 1408, N = 2048) the bytes of the three weight tensors,
// 3 * 64 * 2048 * 1408 * 2 B = 1.1 GB, about 330 us at 3.35 TB/s; at a
// 2048-token prefill step (R = 160) the 177 GFLOP of the three products are
// still under that (about 179 us at 989 TFLOP/s), so the weights' bytes bound
// both shapes.
//
// Design: split-f. The TPU kernel holds a full-width (bm, N) fp32
// accumulator and the whole (bm, d) x tile in 32 MiB of VMEM. Neither fits a
// Hopper block (227 KB of shared memory). One block per (expert, M tile,
// f-chunk of BFS = 128 hidden columns):
//   GEMM1 over d in BK = 64 slices -> fp32 gate/up in registers ->
//   activation in fp32 on the accumulator fragments -> cast to the input
//   dtype (the TPU kernel's h.astype, fused_mlp.py:81) -> the (BM, BFS)
//   hidden chunk staged in shared memory ->
//   for every N tile: h_chunk . Wd[f-chunk, N tile] in fp32 registers,
//   written as an fp32 partial (f-chunk, e, R, N).
// A second pass sums the f/BFS partials of each output element in a fixed
// order (deterministic, no atomics) and casts to the input dtype.
// So each weight element is read once per M tile and nothing is recomputed;
// the cost is the partials' extra bytes, 2 * (f / BFS) * E * R * N * 4:
// 46 MB at decode (R = 4, next to 1.1 GB of weights) and 1.85 GB at a
// 2048-token prefill step (R = 160). The M tiles of one (expert, f-chunk)
// are issued next to each other, so their repeated weight reads mostly hit
// L2. bf16 tiles use WMMA tensor-core fragments, fp32 tiles plain FMAs (an
// fp32 product stays exact fp32). Ragged R, d, f and N are zero-filled on
// load and masked on store; w_down may be a column slice (its own row
// stride). `order` is the reduce pass's traversal: n_major issues column
// slab 0 of every expert first. Blocks run in parallel on the GPU, so it
// sets issue order only.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int BFS = 128;  // hidden columns per block (f-chunk)
constexpr int BK = 64;    // d slice of GEMM1, f slice of GEMM2

template <typename T, int BM, int BN> struct FusedSmem {
  static constexpr int LDX = BK + 8, LDW = BFS + 8, LDD = BN + 8, LDH = BFS + 8;
  static constexpr int LDF = BFS + 4;  // fp32 hidden staging
  static constexpr size_t X = 0;
  static constexpr size_t G = X + align128(sizeof(T) * BM * LDX);
  static constexpr size_t U = G + align128(sizeof(T) * BK * LDW);
  static constexpr size_t F = U + align128(sizeof(T) * BK * LDW);
  static constexpr size_t H = F + align128(sizeof(float) * BM * LDF);
  static constexpr size_t D = H + align128(sizeof(T) * BM * LDH);
  static constexpr size_t BYTES = D + align128(sizeof(T) * BK * LDD);
  // the output tile is staged in the (then idle) gate/up tiles
  static_assert(out_stage_bytes<BM, BN>() <= F - G, "staging does not fit");
};

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kThreads)
    fused_mlp_partial_kernel(const T* __restrict__ x, long long sxe,
                             long long sxr, const T* __restrict__ wg,
                             const T* __restrict__ wu, long long swe,
                             long long swk, const T* __restrict__ wd,
                             long long sde, long long sdf,
                             float* __restrict__ part, int E, int R, int d,
                             int f, int N, int act) {
  using L = FusedSmem<T, BM, BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem + L::X);
  T* gs = reinterpret_cast<T*>(smem + L::G);
  T* us = reinterpret_cast<T*>(smem + L::U);
  float* fs = reinterpret_cast<float*>(smem + L::F);
  T* hs = reinterpret_cast<T*>(smem + L::H);
  T* ds = reinterpret_cast<T*>(smem + L::D);

  // (expert, f-chunk, M tile), M tile fastest
  const int MT = (R + BM - 1) / BM, NF = (f + BFS - 1) / BFS;
  const long long id = blockIdx.x;
  const int m = static_cast<int>(id % MT);
  const int fc = static_cast<int>((id / MT) % NF);
  const int e = static_cast<int>(id / (static_cast<long long>(MT) * NF));
  const int m0 = m * BM, f0 = fc * BFS;
  const bool glu = wg != nullptr;
  const T* xe = x + e * sxe + m0 * sxr;
  const T* wge = glu ? wg + e * swe + f0 : nullptr;
  const T* wue = wu + e * swe + f0;
  const T* wde = wd + e * sde + f0 * sdf;

  // ---- GEMM1 + activation: the (BM, BFS) hidden chunk ----------------------
  Acc<T, BM, BFS> ag, au;
  ag.zero();
  au.zero();
  for (int k0 = 0; k0 < d; k0 += BK) {
    load_tile<T, BM, BK>(xs, L::LDX, xe + k0, sxr, R - m0, d - k0);
    if (glu)
      load_tile<T, BK, BFS>(gs, L::LDW, wge + k0 * swk, swk, d - k0, f - f0);
    load_tile<T, BK, BFS>(us, L::LDW, wue + k0 * swk, swk, d - k0, f - f0);
    __syncthreads();
    if (glu) ag.mma(xs, L::LDX, gs, L::LDW, BK);
    au.mma(xs, L::LDX, us, L::LDW, BK);
    __syncthreads();
  }
  // zero-filled f columns give act(0, 0) = 0 for every activation, and
  // their Wd rows are zero-filled too
  au.combine(ag, [act](float g, float u) { return activate(act, g, u); });
  au.store(fs, L::LDF);
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BFS; i += kThreads) {
    const int r = i / BFS, c = i % BFS;
    hs[r * L::LDH + c] = from_f<T>(fs[r * L::LDF + c]);
  }
  __syncthreads();

  // ---- GEMM2 per N tile: fp32 partials of this f-chunk ---------------------
  float* pe = part + static_cast<long long>(fc) * E * R * N;
  for (int n0 = 0; n0 < N; n0 += BN) {
    Acc<T, BM, BN> acc;
    acc.zero();
    for (int k0 = 0; k0 < BFS; k0 += BK) {
      load_tile<T, BK, BN>(ds, L::LDD, wde + k0 * sdf + n0, sdf,
                           f - f0 - k0, N - n0);
      __syncthreads();
      acc.mma(hs + k0, L::LDH, ds, L::LDD, BK);
      __syncthreads();
    }
    store_tile<float, BM, BN>(acc, smem + L::G, pe, e, R, N, m0, n0);
  }
}

template <typename T, int BM, int BN>
cudaError_t launch(const void* x, long long sxe, long long sxr,
                   const void* wg, const void* wu, long long swe,
                   long long swk, const void* wd, long long sde,
                   long long sdf, void* part, void* out, int E, int R, int d,
                   int f, int N, int act, int order, cudaStream_t stream) {
  using L = FusedSmem<T, BM, BN>;
  auto kern = fused_mlp_partial_kernel<T, BM, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::BYTES));
  if (err != cudaSuccess) return err;
  const int NF = (f + BFS - 1) / BFS;
  const long long blocks =
      static_cast<long long>(E) * NF * ((R + BM - 1) / BM);
  kern<<<static_cast<unsigned>(blocks), kThreads, L::BYTES, stream>>>(
      static_cast<const T*>(x), sxe, sxr, static_cast<const T*>(wg),
      static_cast<const T*>(wu), swe, swk, static_cast<const T*>(wd), sde,
      sdf, static_cast<float*>(part), E, R, d, f, N, act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_partials<T>(static_cast<const float*>(part), static_cast<T*>(out),
                         E * R, N, NF, order, stream);
}

}  // namespace

extern "C" int repro_fused_mlp_chunk() { return BFS; }

// x: (E, R, d) with strides (sxe, sxr, 1); wg/wu: (E, d, f) with strides
// (swe, swk, 1), wg null for non-GLU activations; wd: (E, f, N) with strides
// (sde, sdf, 1), possibly a column slice; part: fp32 scratch of
// ceil(f / repro_fused_mlp_chunk()) * E * R * N elements; out: (E, R, N)
// contiguous. dtype 0 = fp32, 1 = bf16; order 0 = expert_major,
// 1 = n_major. Returns the CUDA error of the launches (0 = success).
extern "C" int repro_fused_mlp(const void* x, long long sxe, long long sxr,
                               const void* wg, const void* wu, long long swe,
                               long long swk, const void* wd, long long sde,
                               long long sdf, void* part, void* out, int E,
                               int R, int d, int f, int N, int act, int order,
                               int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (R <= 16)
      return launch<__nv_bfloat16, 16, 256>(x, sxe, sxr, wg, wu, swe, swk,
                                            wd, sde, sdf, part, out, E, R, d,
                                            f, N, act, order, st);
    return launch<__nv_bfloat16, 32, 256>(x, sxe, sxr, wg, wu, swe, swk, wd,
                                          sde, sdf, part, out, E, R, d, f, N,
                                          act, order, st);
  }
  if (R <= 16)
    return launch<float, 16, 128>(x, sxe, sxr, wg, wu, swe, swk, wd, sde,
                                  sdf, part, out, E, R, d, f, N, act, order,
                                  st);
  return launch<float, 32, 128>(x, sxe, sxr, wg, wu, swe, swk, wd, sde, sdf,
                                part, out, E, R, d, f, N, act, order, st);
}
