// Fused expert-MLP dgrad on Hopper's wgmma, the bf16 path of
// dX[e] = dup . Wu[e]^T + dgate . Wg[e]^T, where (dgate, dup) is the
// activation's VJP at (x . Wg, x . Wu) for the cotangent
// dh = (dY . Wd[e]^T).astype(bf16), both rounded to bf16.
//
// Replaces: src/repro/kernels/fused_mlp.py::fused_mlp_dgrad (the backward
// of the "pallas_fused" GroupGEMM backend, called per column block by
// core/transport._mlp_bwd), for bf16 operands with 16-byte aligned bases
// and row strides and d, f, N multiples of 8 (every main-path call). fp32
// and other shapes run the general kernel in fused_mlp_dgrad.cu. With a
// column-sliced w_down/dY, dX is that column block's part.
//
// What bounds it on an H100: at qwen2-moe-2.7b's train shape (E = 64,
// R = 320, d = N = 2048, f = 1408) the five products the interface forces
// (gate, up, dh, and the two transposed products) are
// 10 * E * R * d * f = 5.9e11 FLOP, about 0.60 ms at 989 TFLOP/s, against
// 1.36 GB of operands (0.41 ms at 3.35 TB/s): operations.
//
// Why dup and dgate go through device memory. The TPU kernel keeps a
// (bm, d) fp32 dX sum in VMEM across its f-chunk axis; no SM holds the
// full-width sum beside the recompute's tiles, and the general kernel
// writes one fp32 dX partial of width d per 128 hidden columns and sums
// them in a second pass: 11 planes, 1.85 GB at the train shape. Here the
// recompute writes dup (and dgate) once in bf16, E * R * f * 2 B each
// (115 MB for both at the train shape), and one product reads them back
// with its sums in registers. Two launches:
//   1. recompute (fused_mlp_recompute.cuh, shared with the wgrad kernel,
//      without its h plane);
//   2. dX = [dup | dgate] . [Wu | Wg]^T, one product over K = f (2f for
//      GLU activations): dup is stored (R, f) and Wu (d, f), so A and B
//      are both K-major (f contiguous). Persistent blocks, one per SM,
//      walk output tiles of 128 rows x 256 columns of d (expert-major, d
//      tiles innermost, so the blocks running together share their A and
//      B slices in L2); two consumer warpgroups take 64 rows each, one
//      producer thread issues the TMA copies into a ring of 3 stages
//      (hopper.cuh). A warpgroup whose 64 rows all lie past R issues no
//      wgmma. Each sum is written once, cast to bf16, through shared-memory
//      staging in 16-byte vectors.
// Ragged R, d and f arrive as zeros from TMA and are masked on store. No
// reduce pass and no atomics: two calls give the same bits.
#include "fused_mlp_recompute.cuh"
#include "attrs.cuh"

namespace {

constexpr int TM = 64;                   // output rows per warpgroup
constexpr int TN = 256;                  // output columns of a tile
constexpr int SLOT2 = 6 * PANEL;         // A (2 panels of 64 rows), B (256)
constexpr int STAGES2 = 3;
// output staging per consumer warpgroup: 64 rows of 256 bf16, padded by
// 16 bytes (conflict-free fragment writes)
constexpr int OUT_LD = TN * 2 + 16;
constexpr int OUT_STAGE = 64 * OUT_LD;
constexpr size_t SMEM2 =
    1024 + STAGES2 * SLOT2 + 2 * OUT_STAGE + kBarBytes;
static_assert(SMEM2 <= 232448, "over the 227 KB a block may use");

// dX (E, R, d) contiguous; A1/B1 = dup/Wu, A2/B2 = dgate/Wg (GLU only)
template <bool GLU>
__global__ void __launch_bounds__(3 * kWarpgroup, 1)
    dgrad_product_kernel(const __grid_constant__ CUtensorMap tm_a1,
                         const __grid_constant__ CUtensorMap tm_b1,
                         const __grid_constant__ CUtensorMap tm_a2,
                         const __grid_constant__ CUtensorMap tm_b2,
                         bf16* __restrict__ dx, int E, int R, int d, int f) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  Ring ring{base, SLOT2, base + STAGES2 * SLOT2 + 2 * OUT_STAGE, STAGES2};
  if (threadIdx.x == 0) ring.init(2 * kWarpgroup);
  __syncthreads();
  const int NT = (d + TN - 1) / TN, MT = (R + 2 * TM - 1) / (2 * TM);
  const long long tiles = static_cast<long long>(E) * MT * NT;
  const int kf = (f + BK - 1) / BK, nk = GLU ? 2 * kf : kf;

  if (threadIdx.x >= 2 * kWarpgroup) {
    // one thread issues the TMA copies (rows past R, columns past d and
    // the f tail arrive as zeros)
    if (threadIdx.x != 2 * kWarpgroup) return;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int nn = static_cast<int>(t % NT) * TN;
      const int mm = static_cast<int>((t / NT) % MT) * 2 * TM;
      const int e = static_cast<int>(t / (static_cast<long long>(NT) * MT));
      for (int kb = 0; kb < nk; ++kb) {
        const bool second = GLU && kb >= kf;
        const int k0 = (second ? kb - kf : kb) * BK;
        ring.acquire();
        const uint32_t slot = ring.slot(), bar = ring.full();
        mbar_expect_tx(bar, SLOT2);
        for (int q = 0; q < 2; ++q)
          tma_load(slot + q * PANEL, second ? &tm_a2 : &tm_a1, bar, k0,
                   mm + 64 * q, e);
        // 256 rows of d by 64 of f in one box: K-major B, 8-row groups
        // 1024 B apart
        tma_load(slot + 2 * PANEL, second ? &tm_b2 : &tm_b1, bar, k0, nn, e);
        ring.next();
      }
    }
  } else {
    const int wg = threadIdx.x / kWarpgroup;  // this warpgroup's 64 rows
    unsigned char* out = smem_raw + (base - raw) + STAGES2 * SLOT2 +
                         wg * OUT_STAGE;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int nn = static_cast<int>(t % NT) * TN;
      const int mm = static_cast<int>((t / NT) % MT) * 2 * TM + wg * TM;
      const int e = static_cast<int>(t / (static_cast<long long>(NT) * MT));
      const bool active = mm < R;
      float c[TN / 2];
      zero(c);
      uint32_t held = 0;  // the empty barrier of the stage still in use
      for (int kb = 0; kb < nk; ++kb) {
        ring.wait();
        if (active) {
          const uint32_t slot = ring.slot();
          fence_regs(c);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            wgmma_m64n256<0, 0>(c, desc_k(slot + wg * PANEL + kk * 32),
                                desc_k(slot + 2 * PANEL + kk * 32), 1);
          wgmma_commit();
          wgmma_wait<1>();
          fence_regs(c);
        }
        if (held) mbar_arrive(held);
        held = ring.empty();
        ring.next();
      }
      wgmma_wait<0>();
      fence_regs(c);
      if (held) mbar_arrive(held);
      if (!active) continue;
      // the sums in bf16 through shared memory, then out in 16-byte
      // vectors, a warp writing whole rows
#pragma unroll
      for (int i = 0; i < TN / 2; i += 2)
        store_pair(reinterpret_cast<bf16*>(out + frag_row(i) * OUT_LD) +
                       frag_col(i),
                   c[i], c[i + 1]);
      bar_sync(2 + wg, kWarpgroup);
      for (int q = threadIdx.x % kWarpgroup; q < 64 * 32; q += kWarpgroup) {
        const int r = q / 32, ch = q % 32;  // 32 chunks of 8 per row
        const int col = nn + ch * 8;
        if (mm + r < R && col < d)
          *reinterpret_cast<uint4*>(
              dx + (static_cast<long long>(e) * R + mm + r) * d + col) =
              *reinterpret_cast<const uint4*>(out + r * OUT_LD + ch * 16);
      }
      bar_sync(2 + wg, kWarpgroup);  // staging free for the next tile
    }
  }
}

}  // namespace

// bf16 only. x: (E, R, d) with strides (sxe, sxr, 1); wg/wu: (E, d, f)
// with strides (swe, swk, 1), wg null for non-GLU activations; wd:
// (E, f, N) with strides (sde, sdf, 1) and dy: (E, R, N) with strides
// (sye, syr, 1), either possibly a column slice; every base 16-byte
// aligned, every stride and d, f, N multiples of 8. scratch: bf16
// (2, E, R, f) (dup, dgate; (1, E, R, f) with wg null). dx: (E, R, d)
// contiguous. Returns the CUDA error of the launches (0 = success).
extern "C" int repro_fused_mlp_dgrad_hopper(
    const void* x, long long sxe, long long sxr, const void* wg,
    const void* wu, long long swe, long long swk, const void* wd,
    long long sde, long long sdf, const void* dy, long long sye,
    long long syr, void* scratch, void* dx, int E, int R, int d, int f,
    int N, int act, void* stream) {
  if (R <= 0 || d <= 0 || f <= 0 || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool glu = wg != nullptr;
  bf16* dus = static_cast<bf16*>(scratch);
  bf16* dgs = glu ? dus + static_cast<long long>(E) * R * f : nullptr;
  Operands ops;
  CUtensorMap tdu, tdg, tbu, tbg;
  cudaError_t err = operand_maps(&ops, x, sxe, sxr, wg, wu, swe, swk, wd,
                                 sde, sdf, dy, sye, syr, E, R, d, f, N);
  // the product's operands, (f, rows, experts): dup/dgate in 64-row boxes,
  // Wu/Wg in 256-row boxes
  const long long rf = static_cast<long long>(R) * f;
  if (err == cudaSuccess) err = tensor_map(&tdu, dus, f, R, E, f, rf);
  if (err == cudaSuccess) err = tensor_map(&tbu, wu, f, d, E, swk, swe, TN);
  if (err == cudaSuccess && glu) err = tensor_map(&tdg, dgs, f, R, E, f, rf);
  if (err == cudaSuccess && glu)
    err = tensor_map(&tbg, wg, f, d, E, swk, swe, TN);
  if (err != cudaSuccess) return err;
  if (!glu) {
    tdg = tdu;
    tbg = tbu;
  }
  err = launch_recompute(ops, glu, nullptr, dus, dgs, E, R, d, f, N, act,
                         st);
  if (err != cudaSuccess) return err;
  auto kern = glu ? dgrad_product_kernel<true> : dgrad_product_kernel<false>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SMEM2));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>(E) *
                          ((R + 2 * TM - 1) / (2 * TM)) * ((d + TN - 1) / TN);
  const long long blocks = tiles < sms ? tiles : sms;
  kern<<<static_cast<unsigned>(blocks), 3 * kWarpgroup, SMEM2, st>>>(
      tdu, tbu, tdg, tbg, static_cast<bf16*>(dx), E, R, d, f);
  return cudaGetLastError();
}

// The attributes of every kernel instance this file launches (attrs.cuh).
extern "C" int repro_attrs_fused_mlp_dgrad_hopper(int i, int* out, char* label, int cap) {
  switch (i) {
    case 0:
      return repro_attrs::query(&recompute_kernel<true>,
                                 "fused_mlp_dgrad[wgmma]/recompute|bfloat16|GLU", out,
                                 label, cap);
    case 1:
      return repro_attrs::query(&recompute_kernel<false>,
                                 "fused_mlp_dgrad[wgmma]/recompute|bfloat16|no GLU", out,
                                 label, cap);
    case 2:
      return repro_attrs::query(&dgrad_product_kernel<true>,
                                 "fused_mlp_dgrad[wgmma]/product|bfloat16|GLU", out,
                                 label, cap);
    case 3:
      return repro_attrs::query(&dgrad_product_kernel<false>,
                                 "fused_mlp_dgrad[wgmma]/product|bfloat16|no GLU", out,
                                 label, cap);
    default:
      return -1;
  }
}
