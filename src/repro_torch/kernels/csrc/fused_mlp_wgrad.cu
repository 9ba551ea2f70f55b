// Fused expert-MLP wgrad: dWd[e] = h^T . dY, dWu[e] = x^T . dup,
// dWg[e] = x^T . dgate, with h = activate(x . Wg, x . Wu).astype(in) and
// (dgate, dup) the activation's VJP for dh = (dY . Wd[e]^T).astype(in).
//
// Replaces: src/repro/kernels/fused_mlp.py::fused_mlp_wgrad (the backward of
// the "pallas_fused" GroupGEMM backend, called per column block by
// core/transport._mlp_bwd). The hidden is recomputed and never gets a device
// memory address. With a column-sliced w_down/dY the dWd block is that
// column block and dWu/dWg are the block's partials.
//
// What bounds it on an H100: at the training shape of qwen2-moe-2.7b (E = 64,
// R = 320, d = N = 2048, f = 1408) the six products (gate, up, dh and the
// three weight gradients) are 12 * E * R * d * f = 7.1e11 FLOP, about
// 0.72 ms at 989 TFLOP/s, against 2.38 GB of operands and outputs (about
// 0.71 ms at 3.35 TB/s): operations, by a hair.
//
// Design (a), block-owned fp32 accumulators in device memory. The three
// outputs are reductions over the rows; the TPU kernel carries (d, bf) x 2 +
// (bf, N) fp32 accumulators in VMEM across its row-tile grid axis, 12 MB at
// bf = 512, which no Hopper block can hold. One block per (expert, f-chunk of
// BFS = 64 hidden columns) loops over the row tiles of BM = 64 rows. For each
// tile it recomputes gate/up (over d) and dh (over N) in fp32 registers,
// applies the activation and its VJP on the fragments, keeps h/dup/dgate in
// the input dtype in shared memory, and then adds h^T . dY and
// x^T . dup/dgate, one BO-wide output tile at a time, into fp32 slices that
// belong to this block alone (no atomics; the row tiles add in a fixed order,
// so the sums are deterministic). The first tile starts from zero instead of
// reading the slices; the last writes the output cast to its dtype instead of
// the slices. So a shape with R <= BM never touches the scratch, and
// otherwise the cost is the scratch traffic,
// 2 * (ceil(R / BM) - 1) * (2d + N) * f * E * 4 bytes: 9.2 GB at the training
// shape. The alternative, one block per output tile with the accumulator in
// registers, recomputes the hidden d / tile times. Ragged R, d, f and N are
// zero-filled on load and masked on the final store (the scratch is padded to
// whole tiles); w_down and dY may be column slices.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int BM = 64;   // rows per tile of the reduction
constexpr int BFS = 64;  // hidden columns per block (f-chunk)
constexpr int BK = 64;   // depth of the gate/up and dh slices
constexpr int BO = 64;   // output tile: dWd columns, dWu/dWg rows

template <typename T> struct WgradSmem {
  static constexpr int LDA = BK + 8;   // x and dY slices (BM x BK / BM x BO)
  static constexpr int LDW = BFS + 8;  // Wg/Wu slices (BK x BFS)
  static constexpr int LDT = BK + 8;   // Wd slice (BFS x BK), read transposed
  static constexpr int LDH = BFS + 8;  // h, dup, dgate (BM x BFS)
  static constexpr int LDF = BFS + 4;  // fp32 staging
  static constexpr size_t X = 0;
  static constexpr size_t G = X + align128(sizeof(T) * BM * LDA);
  static constexpr size_t U = G + align128(sizeof(T) * BK * LDW);
  static constexpr size_t Y = U + align128(sizeof(T) * BK * LDW);
  static constexpr size_t D = Y + align128(sizeof(T) * BM * LDA);
  static constexpr size_t F = D + align128(sizeof(T) * BFS * LDT);
  static constexpr size_t H = F + align128(sizeof(float) * BM * LDF);
  static constexpr size_t DU = H + align128(sizeof(T) * BM * LDH);
  static constexpr size_t DG = DU + align128(sizeof(T) * BM * LDH);
  static constexpr size_t BYTES = DG + align128(sizeof(T) * BM * LDH);
  // the output tiles are staged in the (then idle) gate/up slices
  static_assert(out_stage_bytes<BFS, BO>() <= Y - G, "staging does not fit");
  static_assert(out_stage_bytes<BO, BFS>() <= Y - G, "staging does not fit");
};

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

// acc += A^T . B for one output tile whose fp32 running sum lives at `run`
// (leading dimension ldr, whole tiles): zero on the first row tile, cast and
// written (masked) to out[e] (rows x cols, row-major) on the last.
template <typename T, int TM, int TN>
__device__ __forceinline__ void accumulate_tile(
    const T* at, int lda, const T* b, int ldb, float* run, int ldr,
    bool first, bool last, unsigned char* stage, T* out, int e, int rows,
    int cols, int r0, int c0) {
  Acc<T, TM, TN> acc;
  if (first)
    acc.zero();
  else
    acc.load(run, ldr);
  acc.template mma<true, false>(at, lda, b, ldb, BM);
  if (last) {
    store_tile<T, TM, TN>(acc, stage, out, e, rows, cols, r0, c0);
  } else {
    acc.store(run, ldr);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_mlp_wgrad_kernel(
        const T* __restrict__ x, long long sxe, long long sxr,
        const T* __restrict__ wg, const T* __restrict__ wu, long long swe,
        long long swk, const T* __restrict__ wd, long long sde, long long sdf,
        const T* __restrict__ dy, long long sye, long long syr,
        float* __restrict__ run_g, float* __restrict__ run_u,
        float* __restrict__ run_d, T* __restrict__ dwg, T* __restrict__ dwu,
        T* __restrict__ dwd, int E, int R, int d, int f, int N, int act) {
  using L = WgradSmem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem + L::X);
  T* gs = reinterpret_cast<T*>(smem + L::G);
  T* us = reinterpret_cast<T*>(smem + L::U);
  T* ys = reinterpret_cast<T*>(smem + L::Y);
  T* ds = reinterpret_cast<T*>(smem + L::D);
  float* fs = reinterpret_cast<float*>(smem + L::F);
  T* hs = reinterpret_cast<T*>(smem + L::H);
  T* dus = reinterpret_cast<T*>(smem + L::DU);
  T* dgs = reinterpret_cast<T*>(smem + L::DG);
  unsigned char* stage = smem + L::G;

  const int NF = (f + BFS - 1) / BFS;
  const int fc = static_cast<int>(blockIdx.x % NF);
  const int e = static_cast<int>(blockIdx.x / NF);
  const int f0 = fc * BFS;
  // padded scratch: run_d (E, NF * BFS, Np), run_u/run_g (E, Dp, NF * BFS)
  const int Fp = NF * BFS;
  const int Np = (N + BO - 1) / BO * BO, Dp = (d + BO - 1) / BO * BO;
  const bool glu = wg != nullptr;
  const T* wge = glu ? wg + e * swe + f0 : nullptr;
  const T* wue = wu + e * swe + f0;
  const T* wde = wd + e * sde + f0 * sdf;
  float* rde = run_d + (static_cast<long long>(e) * Fp + f0) * Np;
  float* rue = run_u + static_cast<long long>(e) * Dp * Fp + f0;
  float* rge = glu ? run_g + static_cast<long long>(e) * Dp * Fp + f0
                   : nullptr;

  for (int m0 = 0; m0 < R; m0 += BM) {
    const bool first = m0 == 0, last = m0 + BM >= R;
    const T* xe = x + e * sxe + m0 * sxr;
    const T* ye = dy + e * sye + m0 * syr;

    // ---- recompute gate/up over d and dh over N for this row tile --------
    Acc<T, BM, BFS> ag, au, adh;
    ag.zero();
    au.zero();
    adh.zero();
    for (int k0 = 0; k0 < d; k0 += BK) {
      load_tile<T, BM, BK>(xs, L::LDA, xe + k0, sxr, R - m0, d - k0);
      if (glu)
        load_tile<T, BK, BFS>(gs, L::LDW, wge + k0 * swk, swk, d - k0,
                              f - f0);
      load_tile<T, BK, BFS>(us, L::LDW, wue + k0 * swk, swk, d - k0, f - f0);
      __syncthreads();
      if (glu) ag.mma(xs, L::LDA, gs, L::LDW, BK);
      au.mma(xs, L::LDA, us, L::LDW, BK);
      __syncthreads();
    }
    for (int n0 = 0; n0 < N; n0 += BK) {
      load_tile<T, BM, BK>(ys, L::LDA, ye + n0, syr, R - m0, N - n0);
      load_tile<T, BFS, BK>(ds, L::LDT, wde + n0, sdf, f - f0, N - n0);
      __syncthreads();
      adh.template mma<false, true>(ys, L::LDA, ds, L::LDT, BK);
      __syncthreads();
    }
    // h into adh, dgate into ag, dup into au; zero-filled rows and f columns
    // give zeros
    au.zip(ag, adh, [act](float& u, float& g, float& dh) {
      const float dhr = to_f(from_f<T>(dh));  // fused_mlp.py:304
      float dg, du;
      activate_vjp(act, g, u, dhr, dg, du);
      dh = activate(act, g, u);
      g = dg;
      u = du;
    });
    stage_cast<T>(adh, fs, L::LDF, hs, L::LDH);   // h.astype(in)
    stage_cast<T>(au, fs, L::LDF, dus, L::LDH);
    if (glu) stage_cast<T>(ag, fs, L::LDF, dgs, L::LDH);

    // ---- dWd[fc, :] += h^T . dY, one BO-wide column tile at a time -------
    for (int n0 = 0; n0 < N; n0 += BO) {
      load_tile<T, BM, BO>(ys, L::LDA, ye + n0, syr, R - m0, N - n0);
      __syncthreads();
      accumulate_tile<T, BFS, BO>(hs, L::LDH, ys, L::LDA, rde + n0, Np, first,
                                  last, stage, dwd, e, f, N, f0, n0);
      __syncthreads();
    }
    // ---- dWu/dWg[:, fc] += x^T . dup/dgate, one BO-row tile at a time ----
    for (int d0 = 0; d0 < d; d0 += BO) {
      load_tile<T, BM, BO>(xs, L::LDA, xe + d0, sxr, R - m0, d - d0);
      __syncthreads();
      accumulate_tile<T, BO, BFS>(xs, L::LDA, dus, L::LDH,
                                  rue + static_cast<long long>(d0) * Fp, Fp,
                                  first, last, stage, dwu, e, d, f, d0, f0);
      __syncthreads();
      if (glu) {
        accumulate_tile<T, BO, BFS>(xs, L::LDA, dgs, L::LDH,
                                    rge + static_cast<long long>(d0) * Fp, Fp,
                                    first, last, stage, dwg, e, d, f, d0, f0);
        __syncthreads();
      }
    }
  }
}

}  // namespace

// which = 0, 1, 2: the row tile BM, the f-chunk BFS, the output tile BO
extern "C" int repro_fused_mlp_wgrad_tile(int which) {
  return which == 0 ? BM : which == 1 ? BFS : BO;
}

// x: (E, R, d) with strides (sxe, sxr, 1); wg/wu: (E, d, f) with strides
// (swe, swk, 1), wg null for non-GLU activations; wd: (E, f, N) with strides
// (sde, sdf, 1) and dy: (E, R, N) with strides (sye, syr, 1), either possibly
// a column slice. run_d: fp32 scratch (E, Fp, Np) and run_u/run_g (E, Dp, Fp)
// with Fp, Np, Dp = f, N, d rounded up to the tiles of
// repro_fused_mlp_wgrad_tile (run_g null with wg); unused when R <= BM.
// dwg/dwu: (E, d, f), dwd: (E, f, N), contiguous (dwg null with wg).
// dtype 0 = fp32, 1 = bf16. Returns the CUDA error of the launch.
extern "C" int repro_fused_mlp_wgrad(
    const void* x, long long sxe, long long sxr, const void* wg,
    const void* wu, long long swe, long long swk, const void* wd,
    long long sde, long long sdf, const void* dy, long long sye,
    long long syr, void* run_g, void* run_u, void* run_d, void* dwg,
    void* dwu, void* dwd, int E, int R, int d, int f, int N, int act,
    int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>(E * ((f + BFS - 1) / BFS));
  cudaError_t err;
  if (dtype == 1) {
    using T = __nv_bfloat16;
    auto kern = fused_mlp_wgrad_kernel<T>;
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(WgradSmem<T>::BYTES));
    if (err != cudaSuccess) return err;
    kern<<<blocks, kThreads, WgradSmem<T>::BYTES, st>>>(
        static_cast<const T*>(x), sxe, sxr, static_cast<const T*>(wg),
        static_cast<const T*>(wu), swe, swk, static_cast<const T*>(wd), sde,
        sdf, static_cast<const T*>(dy), sye, syr, static_cast<float*>(run_g),
        static_cast<float*>(run_u), static_cast<float*>(run_d),
        static_cast<T*>(dwg), static_cast<T*>(dwu), static_cast<T*>(dwd), E,
        R, d, f, N, act);
  } else {
    auto kern = fused_mlp_wgrad_kernel<float>;
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(WgradSmem<float>::BYTES));
    if (err != cudaSuccess) return err;
    kern<<<blocks, kThreads, WgradSmem<float>::BYTES, st>>>(
        static_cast<const float*>(x), sxe, sxr, static_cast<const float*>(wg),
        static_cast<const float*>(wu), swe, swk,
        static_cast<const float*>(wd), sde, sdf,
        static_cast<const float*>(dy), sye, syr, static_cast<float*>(run_g),
        static_cast<float*>(run_u), static_cast<float*>(run_d),
        static_cast<float*>(dwg), static_cast<float*>(dwu),
        static_cast<float*>(dwd), E, R, d, f, N, act);
  }
  return cudaGetLastError();
}
