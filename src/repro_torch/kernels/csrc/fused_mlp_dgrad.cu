// Fused expert-MLP dgrad: dX[e] = dup . Wu[e]^T + dgate . Wg[e]^T, where
// (dgate, dup) = VJP of the activation at (x . Wg, x . Wu) for the cotangent
// dh = (dY . Wd[e]^T).astype(in).
//
// Replaces: src/repro/kernels/fused_mlp.py::fused_mlp_dgrad (the backward of
// the "pallas_fused" GroupGEMM backend, called per column block by
// core/transport._mlp_bwd). The hidden is recomputed and never gets a device
// memory address.
//
// What bounds it on an H100: at the training shape of qwen2-moe-2.7b (E = 64
// experts, R = 320 rows, d = N = 2048, f = 1408) the five products the
// interface forces (gate, up, dh, and the two transposed products) are
// 10 * E * R * d * f = 5.9e11 FLOP, about 0.60 ms at 989 TFLOP/s, against
// 1.36 GB of operands (about 0.41 ms at 3.35 TB/s): operations.
//
// Design: split-f, like the forward (csrc/fused_mlp.cu). The TPU kernel keeps
// a (bm, d) fp32 dX accumulator in VMEM across its f-chunk grid axis; on
// Hopper blocks run in parallel, so one block per (expert, M tile of BM rows,
// f-chunk of BFS = 128 hidden columns):
//   gate/up = x . Wg/Wu[:, fc] over d, and dh = dY . Wd[fc, :]^T over N, all
//   three in fp32 registers (WMMA bf16 fragments or fp32 FMAs) ->
//   dh rounded to the input dtype (fused_mlp.py:213) -> the activation's VJP
//   in fp32 on the fragments -> dup/dgate cast to the input dtype into
//   shared memory ->
//   for every BD-wide tile of d: dup . Wu[d tile, fc]^T + dgate . Wg^T,
//   written as an fp32 partial (f-chunk, e, R, d).
// A second pass (common.cuh sum_partials) adds the f/BFS partials of each
// dX element in f-chunk order (deterministic, no atomics) and casts. The
// transposed operands (Wd[fc, :]^T, Wu/Wg[:, fc]^T) are read in their stored
// layouts as column-major WMMA fragments: no transposed copy. The cost of the
// split is the partials' bytes, 2 * (f / BFS) * E * R * d * 4: 3.7 GB at the
// training shape. Ragged R, d, f and N are zero-filled on load and masked on
// store; w_down and dY may be column slices (their own row strides).
#include "common.cuh"
#include "attrs.cuh"

using namespace repro;

namespace {

constexpr int BM = 32;    // rows per block
constexpr int BFS = 128;  // hidden columns per block (f-chunk)
constexpr int BK = 64;    // depth of every product slice
constexpr int BD = 128;   // dX columns per output tile

template <typename T> struct DgradSmem {
  static constexpr int LDA = BK + 8;   // x and dY slices (BM x BK)
  static constexpr int LDW = BFS + 8;  // Wg/Wu slices (BK x BFS), GEMM1
  static constexpr int LDT = BK + 8;   // stored-layout slices read
                                       // transposed: Wd (BFS x BK), Wu/Wg
                                       // (BD x BK)
  static constexpr int LDH = BFS + 8;  // dup/dgate (BM x BFS)
  static constexpr int LDF = BFS + 4;  // fp32 staging
  // phases 1-2 (GEMM1 and dh)
  static constexpr size_t X = 0;
  static constexpr size_t G = X + align128(sizeof(T) * BM * LDA);
  static constexpr size_t U = G + align128(sizeof(T) * BK * LDW);
  static constexpr size_t Y = U + align128(sizeof(T) * BK * LDW);
  static constexpr size_t D = Y + align128(sizeof(T) * BM * LDA);
  static constexpr size_t P12 = D + align128(sizeof(T) * BFS * LDT);
  // phase 3 (dX tiles) reuses the phase 1-2 space
  static constexpr size_t WU = 0;
  static constexpr size_t WG = WU + align128(sizeof(T) * BD * LDT);
  static constexpr size_t OUT = WG + align128(sizeof(T) * BD * LDT);
  static constexpr size_t P3 = OUT + out_stage_bytes<BM, BD>();
  static constexpr size_t LOOP = P12 > P3 ? P12 : P3;
  // kept across the phases
  static constexpr size_t F = LOOP;
  static constexpr size_t DU = F + align128(sizeof(float) * BM * LDF);
  static constexpr size_t DG = DU + align128(sizeof(T) * BM * LDH);
  static constexpr size_t BYTES = DG + align128(sizeof(T) * BM * LDH);
};

// fp32 accumulator -> the input dtype, row-major in shared memory, through
// the fp32 staging tile
template <typename T, typename AccT>
__device__ __forceinline__ void stage_cast(const AccT& acc, float* fs, int ldf,
                                           T* dst, int ldd) {
  acc.store(fs, ldf);
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BFS; i += kThreads) {
    const int r = i / BFS, c = i % BFS;
    dst[r * ldd + c] = from_f<T>(fs[r * ldf + c]);
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_mlp_dgrad_partial_kernel(
        const T* __restrict__ x, long long sxe, long long sxr,
        const T* __restrict__ wg, const T* __restrict__ wu, long long swe,
        long long swk, const T* __restrict__ wd, long long sde, long long sdf,
        const T* __restrict__ dy, long long sye, long long syr,
        float* __restrict__ part, int E, int R, int d, int f, int N,
        int act) {
  using L = DgradSmem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem + L::X);
  T* gs = reinterpret_cast<T*>(smem + L::G);
  T* us = reinterpret_cast<T*>(smem + L::U);
  T* ys = reinterpret_cast<T*>(smem + L::Y);
  T* ds = reinterpret_cast<T*>(smem + L::D);
  T* wus = reinterpret_cast<T*>(smem + L::WU);
  T* wgs = reinterpret_cast<T*>(smem + L::WG);
  float* fs = reinterpret_cast<float*>(smem + L::F);
  T* dus = reinterpret_cast<T*>(smem + L::DU);
  T* dgs = reinterpret_cast<T*>(smem + L::DG);

  // (expert, f-chunk, M tile), M tile fastest
  const int MT = (R + BM - 1) / BM, NF = (f + BFS - 1) / BFS;
  const long long id = blockIdx.x;
  const int m = static_cast<int>(id % MT);
  const int fc = static_cast<int>((id / MT) % NF);
  const int e = static_cast<int>(id / (static_cast<long long>(MT) * NF));
  const int m0 = m * BM, f0 = fc * BFS;
  const bool glu = wg != nullptr;
  const T* xe = x + e * sxe + m0 * sxr;
  const T* ye = dy + e * sye + m0 * syr;
  const T* wge = glu ? wg + e * swe + f0 : nullptr;
  const T* wue = wu + e * swe + f0;
  const T* wde = wd + e * sde + f0 * sdf;

  // ---- phase 1: gate/up over d ---------------------------------------------
  Acc<T, BM, BFS> ag, au, adh;
  ag.zero();
  au.zero();
  adh.zero();
  for (int k0 = 0; k0 < d; k0 += BK) {
    load_tile<T, BM, BK>(xs, L::LDA, xe + k0, sxr, R - m0, d - k0);
    if (glu)
      load_tile<T, BK, BFS>(gs, L::LDW, wge + k0 * swk, swk, d - k0, f - f0);
    load_tile<T, BK, BFS>(us, L::LDW, wue + k0 * swk, swk, d - k0, f - f0);
    __syncthreads();
    if (glu) ag.mma(xs, L::LDA, gs, L::LDW, BK);
    au.mma(xs, L::LDA, us, L::LDW, BK);
    __syncthreads();
  }
  // ---- phase 2: dh = dY . Wd[fc, :]^T over N -------------------------------
  for (int n0 = 0; n0 < N; n0 += BK) {
    load_tile<T, BM, BK>(ys, L::LDA, ye + n0, syr, R - m0, N - n0);
    load_tile<T, BFS, BK>(ds, L::LDT, wde + n0, sdf, f - f0, N - n0);
    __syncthreads();
    adh.template mma<false, true>(ys, L::LDA, ds, L::LDT, BK);
    __syncthreads();
  }
  // the activation's VJP: dgate into ag, dup into au. Zero-filled rows and f
  // columns have g = u = dh = 0 and give zeros.
  au.zip(ag, adh, [act](float& u, float& g, float& dh) {
    const float dhr = to_f(from_f<T>(dh));  // dh.astype(in), fused_mlp.py:213
    float dg, du;
    activate_vjp(act, g, u, dhr, dg, du);
    g = dg;
    u = du;
  });
  stage_cast<T>(au, fs, L::LDF, dus, L::LDH);
  if (glu) stage_cast<T>(ag, fs, L::LDF, dgs, L::LDH);

  // ---- phase 3: dX partial of this f-chunk, per BD-wide tile of d ----------
  float* pe = part + static_cast<long long>(fc) * E * R * d;
  for (int d0 = 0; d0 < d; d0 += BD) {
    Acc<T, BM, BD> acc;
    acc.zero();
    for (int k0 = 0; k0 < BFS; k0 += BK) {
      // Wu[d0:d0+BD, f0+k0:f0+k0+BK] in its stored layout: B = its transpose
      load_tile<T, BD, BK>(wus, L::LDT, wue + d0 * swk + k0, swk, d - d0,
                           f - f0 - k0);
      if (glu)
        load_tile<T, BD, BK>(wgs, L::LDT, wge + d0 * swk + k0, swk, d - d0,
                             f - f0 - k0);
      __syncthreads();
      acc.template mma<false, true>(dus + k0, L::LDH, wus, L::LDT, BK);
      if (glu)
        acc.template mma<false, true>(dgs + k0, L::LDH, wgs, L::LDT, BK);
      __syncthreads();
    }
    store_tile<float, BM, BD>(acc, smem + L::OUT, pe, e, R, d, m0, d0);
  }
}

template <typename T>
cudaError_t launch(const void* x, long long sxe, long long sxr, const void* wg,
                   const void* wu, long long swe, long long swk,
                   const void* wd, long long sde, long long sdf,
                   const void* dy, long long sye, long long syr, void* part,
                   void* out, int E, int R, int d, int f, int N, int act,
                   cudaStream_t stream) {
  using L = DgradSmem<T>;
  auto kern = fused_mlp_dgrad_partial_kernel<T>;
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
      sdf, static_cast<const T*>(dy), sye, syr, static_cast<float*>(part), E,
      R, d, f, N, act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return sum_partials<T>(static_cast<const float*>(part), static_cast<T*>(out),
                         E * R, d, NF, 0, stream);
}

}  // namespace

extern "C" int repro_fused_mlp_dgrad_chunk() { return BFS; }

// x: (E, R, d) with strides (sxe, sxr, 1); wg/wu: (E, d, f) with strides
// (swe, swk, 1), wg null for non-GLU activations; wd: (E, f, N) with strides
// (sde, sdf, 1) and dy: (E, R, N) with strides (sye, syr, 1), either possibly
// a column slice; part: fp32 scratch of
// ceil(f / repro_fused_mlp_dgrad_chunk()) * E * R * d elements; out: dX
// (E, R, d) contiguous. dtype 0 = fp32, 1 = bf16. Returns the CUDA error of
// the launches (0 = success).
extern "C" int repro_fused_mlp_dgrad(
    const void* x, long long sxe, long long sxr, const void* wg,
    const void* wu, long long swe, long long swk, const void* wd,
    long long sde, long long sdf, const void* dy, long long sye,
    long long syr, void* part, void* out, int E, int R, int d, int f, int N,
    int act, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, sxe, sxr, wg, wu, swe, swk, wd, sde, sdf,
                                 dy, sye, syr, part, out, E, R, d, f, N, act,
                                 st);
  return launch<float>(x, sxe, sxr, wg, wu, swe, swk, wd, sde, sdf, dy, sye,
                       syr, part, out, E, R, d, f, N, act, st);
}

// The attributes of every kernel instance this file launches (attrs.cuh).
extern "C" int repro_attrs_fused_mlp_dgrad(int i, int* out, char* label, int cap) {
  switch (i) {
    case 0:
      return repro_attrs::query(&fused_mlp_dgrad_partial_kernel<float>,
                                 "fused_mlp_dgrad[general]/partial|float32|", out,
                                 label, cap);
    case 1:
      return repro_attrs::query(&fused_mlp_dgrad_partial_kernel<__nv_bfloat16>,
                                 "fused_mlp_dgrad[general]/partial|bfloat16|", out,
                                 label, cap);
    case 2:
      return repro_attrs::query(&sum_partials_kernel<float>,
                                 "fused_mlp_dgrad[general]/sum_partials|float32|out float32", out,
                                 label, cap);
    case 3:
      return repro_attrs::query(&sum_partials_kernel<__nv_bfloat16>,
                                 "fused_mlp_dgrad[general]/sum_partials|float32|out bfloat16", out,
                                 label, cap);
    default:
      return -1;
  }
}
