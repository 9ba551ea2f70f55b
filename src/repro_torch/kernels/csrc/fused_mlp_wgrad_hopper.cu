// Fused expert-MLP wgrad on Hopper's wgmma, the bf16 path of
// dWd[e] = h^T . dY, dWu[e] = x^T . dup, dWg[e] = x^T . dgate, with
// h = activate(x . Wg, x . Wu).astype(bf16) and (dgate, dup) the
// activation's VJP for dh = (dY . Wd[e]^T).astype(bf16), both rounded to
// bf16.
//
// Replaces: src/repro/kernels/fused_mlp.py::fused_mlp_wgrad (the backward
// of the "pallas_fused" GroupGEMM backend), for bf16 operands with 16-byte
// aligned bases and row strides and d, f, N multiples of 8 (every
// main-path call). fp32 and other shapes run the general kernel in
// fused_mlp_wgrad.cu. With a column-sliced w_down/dY, dWd is that column
// block and dWu/dWg are the block's partials.
//
// What bounds it on an H100: at qwen2-moe-2.7b's train shape (E = 64,
// R = 320, d = N = 2048, f = 1408) the six products are 7.1e11 FLOP, about
// 0.72 ms at 989 TFLOP/s, beside 2.4 GB of operands and outputs (0.71 ms at
// 3.35 TB/s): operations, by a hair.
//
// Why the hidden goes through device memory here. The outputs are sums
// over the rows. The TPU kernel carries (d, bf) x 2 + (bf, N) fp32 sums in
// VMEM across its row-tile axis, 12 MB, which no SM holds; the general
// kernel keeps them as fp32 running sums in device memory and reads and
// writes them once per row tile, 17.7 GB of traffic at the train shape
// (2 * (ceil(R / 64) - 1) * (2d + N) * f * E * 4 B). Here the recomputed
// h, dup and dgate are written once in bf16, 3 * E * R * f * 2 B = 173 MB
// at the train shape, and read back by products whose sums stay in
// registers. Two passes:
//   1. recompute (fused_mlp_recompute.cuh, shared with the dgrad kernel):
//      one block per (expert, 64-row M tile, 128-column f tile), each of
//      two consumer warpgroups on 64 of the columns: gate, up (over d: x
//      slices K-major, Wg/Wu slices MN-major) and dh (over N: dY slices
//      K-major, Wd slices K-major) in three m64n64 fp32 accumulators; dh
//      rounded to bf16 (fused_mlp.py:304), the activation and its VJP in
//      fp32, h, dup and dgate cast to bf16 and written to the scratch (the
//      same rounding points as the general kernel);
//   2. products, one launch for dWd = h^T . dY (output tiles of 128 x 256)
//      and one for dWu = x^T . dup with dWg = x^T . dgate in the same tile
//      (128 x 128 each, x^T loaded once), each over all R rows in slices of
//      64; A and B are both MN-major (the rows are K), each sum is written
//      once, cast to bf16. Any R works; nothing is summed across blocks.
// Both kernels run a producer warpgroup, of which one thread issues the
// TMA copies into a ring of 5 and 3 stages (hopper.cuh), beside two
// consumer warpgroups (wgmma), which keep one stage's wgmmas in flight
// while the next lands; the products' blocks are
// persistent, one per SM, each walking many output tiles. Ragged R, d,
// f and N arrive as zeros from TMA and are masked on store. No atomics: two
// calls give the same bits.
#include "fused_mlp_recompute.cuh"
#include "attrs.cuh"

namespace {

constexpr int TM = 64;   // output rows of the products per warpgroup
constexpr int SLOT2 = 6 * PANEL;         // A^T (2), B1 (4) | B1, B2 (2)
constexpr int STAGES2 = 3;
// the products' output staging, per consumer warpgroup: 64 rows of 256
// bf16, padded by 16 bytes (conflict-free fragment writes)
constexpr int OUT_LD = 256 * 2 + 16;
constexpr int OUT_STAGE = 64 * OUT_LD;
constexpr size_t SMEM2 =
    1024 + STAGES2 * SLOT2 + 2 * OUT_STAGE + kBarBytes;
static_assert(SMEM2 <= 232448, "over the 227 KB a block may use");

// ---- launch 2: C1 (and C2) = A^T . B1 (and B2), K = the R rows ------------
// A: (E, R, M) with strides (sae, sar, 1); B1/B2: (E, R, Nc) with strides
// (sbe, sbr, 1); C1/C2: (E, M, Nc) contiguous; B2/C2 only with TWO.
struct Product {
  bf16* c1;
  bf16* c2;
  int M, Nc;
};

// output tile columns: 256 for one product, 128 each for two (a consumer
// thread holds 128 fp32 sums either way)
template <bool TWO>
__host__ __device__ constexpr int tile_n() {
  return TWO ? 128 : 256;
}

// Persistent: each block walks the output tiles blockIdx.x, + gridDim.x,
// ... (expert-major, N tiles innermost, so the blocks running together
// share their A and B slices in L2). An output tile is 128 rows, 64 per
// consumer warpgroup; both read the same B slices, so each weight-gradient
// element costs half the loads of a 64-row tile. K = R is short (5 stages
// at the train shape), so the producer runs on into the next tile's stages
// while the consumers write the last tile's sums.
template <bool TWO>
__global__ void __launch_bounds__(3 * kWarpgroup, 1)
    wgrad_product_kernel(const __grid_constant__ CUtensorMap tm_a,
                         const __grid_constant__ CUtensorMap tm_b1,
                         const __grid_constant__ CUtensorMap tm_b2,
                         const Product p, int E, int R) {
  constexpr int TNB = tile_n<TWO>();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  Ring ring{base, SLOT2, base + STAGES2 * SLOT2 + 2 * OUT_STAGE, STAGES2};
  if (threadIdx.x == 0) ring.init(2 * kWarpgroup);
  __syncthreads();
  const int NT = (p.Nc + TNB - 1) / TNB, MT = (p.M + 2 * TM - 1) / (2 * TM);
  const long long tiles = static_cast<long long>(E) * MT * NT;
  const int kr = (R + BK - 1) / BK;

  if (threadIdx.x >= 2 * kWarpgroup) {
    // one thread issues the TMA copies (rows past R and columns past M, Nc
    // arrive as zeros)
    if (threadIdx.x != 2 * kWarpgroup) return;
    const uint32_t bytes = 6 * PANEL;  // A^T (2 panels), B (4)
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int nn = static_cast<int>(t % NT) * TNB;
      const int mm = static_cast<int>((t / NT) % MT) * 2 * TM;
      const int e = static_cast<int>(t / (static_cast<long long>(NT) * MT));
      for (int kb = 0; kb < kr; ++kb) {
        const int r0 = kb * BK;
        ring.acquire();
        const uint32_t slot = ring.slot(), bar = ring.full();
        mbar_expect_tx(bar, bytes);
        for (int q = 0; q < 2; ++q)
          tma_load(slot + q * PANEL, &tm_a, bar, mm + 64 * q, r0, e);
        if constexpr (TWO) {
          for (int q = 0; q < 2; ++q) {
            tma_load(slot + (2 + q) * PANEL, &tm_b1, bar, nn + 64 * q, r0, e);
            tma_load(slot + (4 + q) * PANEL, &tm_b2, bar, nn + 64 * q, r0, e);
          }
        } else {
          for (int q = 0; q < 4; ++q)
            tma_load(slot + (2 + q) * PANEL, &tm_b1, bar, nn + 64 * q, r0, e);
        }
        ring.next();
      }
    }
  } else {
    const int wg = threadIdx.x / kWarpgroup;  // this warpgroup's 64 rows
    unsigned char* out = smem_raw + (base - raw) + STAGES2 * SLOT2 +
                         wg * OUT_STAGE;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int nn = static_cast<int>(t % NT) * TNB;
      const int mm = static_cast<int>((t / NT) % MT) * 2 * TM + wg * TM;
      const int e = static_cast<int>(t / (static_cast<long long>(NT) * MT));
      float c1[TNB / 2], c2[TWO ? 64 : 1];
      zero(c1);
      zero(c2);
      uint32_t held = 0;
      for (int kb = 0; kb < kr; ++kb) {
        ring.wait();
        const uint32_t slot = ring.slot();
        fence_regs(c1);
        if (TWO) fence_regs(c2);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t da = desc_mn(slot + wg * PANEL + kk * 2048, PANEL);
          const uint64_t db = desc_mn(slot + 2 * PANEL + kk * 2048, PANEL);
          if constexpr (TWO) {
            wgmma_m64n128<1, 1>(c1, da, db, 1);
            wgmma_m64n128<1, 1>(
                c2, da, desc_mn(slot + 4 * PANEL + kk * 2048, PANEL), 1);
          } else {
            wgmma_m64n256<1, 1>(c1, da, db, 1);
          }
        }
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(c1);
        if (TWO) fence_regs(c2);
        if (held) mbar_arrive(held);
        held = ring.empty();
        ring.next();
      }
      wgmma_wait<0>();
      fence_regs(c1);
      if (TWO) fence_regs(c2);
      if (held) mbar_arrive(held);
      // the sums in bf16 through shared memory (C1 in columns 0..TNB-1 of
      // the staging rows, C2 in 128..255), then out in 16-byte vectors,
      // a warp writing whole rows
#pragma unroll
      for (int i = 0; i < TNB / 2; i += 2) {
        const int r = frag_row(i), c = frag_col(i);
        store_pair(reinterpret_cast<bf16*>(out + r * OUT_LD) + c, c1[i],
                   c1[i + 1]);
        if constexpr (TWO)
          store_pair(reinterpret_cast<bf16*>(out + r * OUT_LD) + 128 + c,
                     c2[i], c2[i + 1]);
      }
      bar_sync(2 + wg, kWarpgroup);
      for (int q = threadIdx.x % kWarpgroup; q < 64 * 32; q += kWarpgroup) {
        const int r = q / 32, ch = q % 32;  // 32 chunks of 8 per row
        const int c = nn + (TWO ? ch % 16 : ch) * 8;
        if (mm + r < p.M && c < p.Nc) {
          bf16* dst = (TWO && ch >= 16 ? p.c2 : p.c1) +
                      (static_cast<long long>(e) * p.M + mm + r) * p.Nc + c;
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(out + r * OUT_LD + ch * 16);
        }
      }
      bar_sync(2 + wg, kWarpgroup);  // staging free for the next tile
    }
  }
}

template <bool TWO>
cudaError_t launch_product(const CUtensorMap& a, const CUtensorMap& b1,
                           const CUtensorMap& b2, const Product& p, int E,
                           int R, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_product_kernel<TWO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM2));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long tiles = static_cast<long long>(E) *
                          ((p.M + 2 * TM - 1) / (2 * TM)) *
                          ((p.Nc + tile_n<TWO>() - 1) / tile_n<TWO>());
  const long long blocks = tiles < sms ? tiles : sms;
  wgrad_product_kernel<TWO>
      <<<static_cast<unsigned>(blocks), 3 * kWarpgroup, SMEM2, st>>>(
          a, b1, b2, p, E, R);
  return cudaGetLastError();
}

}  // namespace

// bf16 only. x: (E, R, d) with strides (sxe, sxr, 1); wg/wu: (E, d, f)
// with strides (swe, swk, 1), wg null for non-GLU activations; wd:
// (E, f, N) with strides (sde, sdf, 1) and dy: (E, R, N) with strides
// (sye, syr, 1), either possibly a column slice; every base 16-byte
// aligned, every stride and d, f, N multiples of 8. scratch: bf16
// (3, E, R, f) (h, dup, dgate; (2, E, R, f) with wg null). dwg/dwu:
// (E, d, f), dwd: (E, f, N), contiguous (dwg null with wg). Returns the
// CUDA error of the launches (0 = success).
extern "C" int repro_fused_mlp_wgrad_hopper(
    const void* x, long long sxe, long long sxr, const void* wg,
    const void* wu, long long swe, long long swk, const void* wd,
    long long sde, long long sdf, const void* dy, long long sye,
    long long syr, void* scratch, void* dwg, void* dwu, void* dwd, int E,
    int R, int d, int f, int N, int act, void* stream) {
  if (R <= 0 || d <= 0 || f <= 0 || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool glu = wg != nullptr;
  bf16* hs = static_cast<bf16*>(scratch);
  const long long plane = static_cast<long long>(E) * R * f;
  bf16* dus = hs + plane;
  bf16* dgs = glu ? hs + 2 * plane : nullptr;
  // tensor maps: operands and scratch planes as (columns, rows, experts)
  Operands ops;
  CUtensorMap th, tdu, tdg;
  cudaError_t err = operand_maps(&ops, x, sxe, sxr, wg, wu, swe, swk, wd,
                                 sde, sdf, dy, sye, syr, E, R, d, f, N);
  const long long rf = static_cast<long long>(R) * f;
  if (err == cudaSuccess) err = tensor_map(&th, hs, f, R, E, f, rf);
  if (err == cudaSuccess) err = tensor_map(&tdu, dus, f, R, E, f, rf);
  if (err == cudaSuccess && glu) err = tensor_map(&tdg, dgs, f, R, E, f, rf);
  if (err != cudaSuccess) return err;
  if (!glu) tdg = tdu;
  err = launch_recompute(ops, glu, hs, dus, dgs, E, R, d, f, N, act, st);
  if (err != cudaSuccess) return err;
  // dWd = h^T . dY, then dWu = x^T . dup with dWg = x^T . dgate
  const Product pd{static_cast<bf16*>(dwd), nullptr, f, N};
  err = launch_product<false>(th, ops.y, ops.y, pd, E, R, st);
  if (err != cudaSuccess) return err;
  const Product pu{static_cast<bf16*>(dwu), static_cast<bf16*>(dwg), d, f};
  return glu ? launch_product<true>(ops.x, tdu, tdg, pu, E, R, st)
             : launch_product<false>(ops.x, tdu, tdu, pu, E, R, st);
}

// The attributes of every kernel instance this file launches (attrs.cuh).
extern "C" int repro_attrs_fused_mlp_wgrad_hopper(int i, int* out, char* label, int cap) {
  switch (i) {
    case 0:
      return repro_attrs::query(&recompute_kernel<true>,
                                 "fused_mlp_wgrad[wgmma]/recompute|bfloat16|GLU", out,
                                 label, cap);
    case 1:
      return repro_attrs::query(&recompute_kernel<false>,
                                 "fused_mlp_wgrad[wgmma]/recompute|bfloat16|no GLU", out,
                                 label, cap);
    case 2:
      return repro_attrs::query(&wgrad_product_kernel<true>,
                                 "fused_mlp_wgrad[wgmma]/dw_down,fused_mlp_wgrad[wgmma]/dw_up_gate|bfloat16|two outputs", out,
                                 label, cap);
    case 3:
      return repro_attrs::query(&wgrad_product_kernel<false>,
                                 "fused_mlp_wgrad[wgmma]/dw_down,fused_mlp_wgrad[wgmma]/dw_up_gate|bfloat16|one output", out,
                                 label, cap);
    default:
      return -1;
  }
}
