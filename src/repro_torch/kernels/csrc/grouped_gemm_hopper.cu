// Grouped GEMM on Hopper's wgmma, the bf16 path of
// out[e] = lhs[e] . rhs[e] for every local expert, fp32 sums, bf16 output.
//
// Replaces: src/repro/kernels/grouped_gemm.py::grouped_gemm (the "pallas"
// GroupGEMM backend, with its expert_major and n_major traversal orders),
// for bf16 operands with 16-byte aligned bases and strides and K, N
// multiples of 8 (every main-path call: gemm1 x . w_up / x . w_gate, gemm2
// h . w_down and its column blocks). fp32 and other shapes run the general
// kernel in grouped_gemm.cu.
//
// What bounds it on an H100: the weight operand's bytes. At qwen2-moe-
// 2.7b's prefill step (64, 160, 2048) . (64, 2048, 1408) the rhs is 369 MB,
// about 0.11 ms at 3.35 TB/s, against 59 GFLOP (0.06 ms at 989 TFLOP/s);
// at decode (M = 4) the bytes bound it by far. So the design streams every
// rhs byte from device memory once, at full bandwidth: the general kernel
// fetched each rhs tile once per 64-row M tile (three times at M = 160),
// through registers, with no overlap of loads and products.
//
// Design. Persistent blocks, one per SM (the grid is the SM count, or the
// tile count if smaller), walk the output tiles in the `order`
// linearisation (common.cuh tile_of), so n_major still issues column block
// 0 of every expert first. A tile is one expert's BN output columns and
// every row of that expert up to 256 (a larger M is cut into 256-row
// tiles): each rhs byte then leaves device memory once per 256 rows. The
// block is three warpgroups. One thread of the third issues the TMA copies
// into a ring of stages (hopper.cuh Ring, 3-d tensor maps): per 64-deep K
// slice, the tile's lhs rows as K-major panels of 64 rows (only the
// fragments that hold rows below M) and its rhs columns as MN-major panels
// of 64 columns (N contiguous, as fused_mlp_hopper.cu reads w_up; a column
// block of w_down brings its own row stride in the tensor map). The lhs
// copies ask L2 to keep their lines (evict_last: every N tile of the
// expert reads them again) and the rhs copies to drop theirs first
// (evict_first: read once). As many stages as fit the 227 KB a block may
// use, at most 8: 5 at decode, 4 at M = 160. The two consumer warpgroups
// take BN / 2 columns each over all the tile's rows, one m64 fp32
// accumulator per fragment in registers (the fragment count is a template
// parameter, so every wgmma is issued without a branch; setmaxnreg moves
// the producer warpgroup's registers to them), and hand a stage back once
// only the newest stage's wgmmas may still run (wait_group 1). Each output
// element is written once, cast to bf16, from the registers. While the
// consumers store one tile the producer already fills the ring with the
// next tile's stages.
//
// BN is 256 when the tile has at most three fragments (M <= 192, every
// main-path call: three m64n128 sums, 192 registers a thread) and 128 at
// four. The wider tile reads 512 contiguous bytes of each rhs row per
// block where 128 columns read 256, which matters under n_major, whose
// neighbouring blocks work on other experts and so read other rows; it
// also halves the lhs re-reads. It was the faster of the two at every
// main-path shape on an H100.
//
// Ragged M, N and K arrive as zeros from TMA (fragments and column panels
// wholly past M or N are not loaded, and issue no wgmma) and are masked on
// store; at decode (M = 4) the fragment's rows past M are zero-filled and
// never stored. Every tile sums K in one fixed order, whatever the order
// of the tiles or the number of SMs: the bits do not depend on `order`,
// and two calls give the same bits.
#include "common.cuh"
#include "hopper.cuh"

using namespace repro;
using namespace repro::hopper;

namespace {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;                  // depth of a ring stage
constexpr int FRAG = 64;                // rows of an m64 fragment
constexpr int MAX_FRAGS = 4;            // fragments of a tile
constexpr int BM = FRAG * MAX_FRAGS;    // rows of a tile
constexpr int PANEL = 64 * 128;         // 64 rows of 128 bytes
constexpr int SMEM_MAX = 232448;        // what a block may use

struct TileGeom {
  int e, m0, n0;  // expert, first row, first column of the tile
  int fa;         // fragments holding rows below M
  int nb;         // 64-column panels holding columns below N (1 or 2)
};

template <int BN>
__device__ __forceinline__ TileGeom geom(long long t, int E, int M, int N,
                                         int order) {
  const int MT = (M + BM - 1) / BM, NT = (N + BN - 1) / BN;
  const Tile tl = tile_of(t, E, MT, NT, order);
  TileGeom g;
  g.e = tl.e;
  g.m0 = tl.m * BM;
  g.n0 = tl.n * BN;
  g.fa = min(MAX_FRAGS, (M - g.m0 + FRAG - 1) / FRAG);
  g.nb = min(BN / 64, (N - g.n0 + 63) / 64);
  return g;
}

// d (64 x WN) += A . B for WN = 64 or 128 columns, B MN-major
template <int WN>
__device__ __forceinline__ void wgmma_n(float (&d)[WN / 2], uint64_t da,
                                        uint64_t db) {
  if constexpr (WN == 64)
    wgmma_m64n64<0, 1>(d, da, db, 1);
  else
    wgmma_m64n128<0, 1>(d, da, db, 1);
}

// TMA copy with an L2 eviction policy (createpolicy): the lhs, read again
// by every N tile of its expert, is kept (evict_last); the rhs, read once,
// goes first (evict_first)
__device__ __forceinline__ void tma_load_hint(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int c0, int c1,
                                              int c2, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.L2::cache_hint [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "l"(policy)
      : "memory");
}

// One tile of a consumer warpgroup with FA fragments: its WN = BN / 2
// columns of every fragment's rows over the whole K loop, then the bf16
// stores.
template <int FA, int BN>
__device__ __forceinline__ void consume_tile(Ring& ring, const TileGeom& g,
                                             int frags, int kt, int w,
                                             bf16* __restrict__ out, int M,
                                             int N) {
  constexpr int WN = BN / 2;
  const bool active = WN * w < N - g.n0;  // columns of w reach below N
  float acc[FA][WN / 2];
#pragma unroll
  for (int f = 0; f < FA; ++f) zero(acc[f]);
  uint32_t held = 0;  // the empty barrier of the stage still in use
  for (int kb = 0; kb < kt; ++kb) {
    ring.wait();
    if (active) {
      const uint32_t slot = ring.slot();
#pragma unroll
      for (int f = 0; f < FA; ++f) fence_regs(acc[f]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = desc_mn(
            slot + (frags + WN / 64 * w) * PANEL + kk * 2048, PANEL);
#pragma unroll
        for (int f = 0; f < FA; ++f)
          wgmma_n<WN>(acc[f], desc_k(slot + f * PANEL + kk * 32), db);
      }
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int f = 0; f < FA; ++f) fence_regs(acc[f]);
    }
    if (held) mbar_arrive(held);
    held = ring.empty();
    ring.next();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int f = 0; f < FA; ++f) fence_regs(acc[f]);
  if (held) mbar_arrive(held);
  if (!active) return;
  bf16* oe = out + static_cast<long long>(g.e) * M * N;
  const int n0 = g.n0 + WN * w;
#pragma unroll
  for (int f = 0; f < FA; ++f) {
#pragma unroll
    for (int i = 0; i < WN / 2; i += 2) {
      const int r = g.m0 + FRAG * f + frag_row(i), c = n0 + frag_col(i);
      if (r < M && c < N)
        *reinterpret_cast<__nv_bfloat162*>(oe + static_cast<long long>(r) * N +
                                           c) =
            __floats2bfloat162_rn(acc[f][i], acc[f][i + 1]);
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(3 * kWarpgroup, 1)
    grouped_gemm_hopper_kernel(const __grid_constant__ CUtensorMap tm_l,
                               const __grid_constant__ CUtensorMap tm_r,
                               bf16* __restrict__ out, int E, int M, int K,
                               int N, int order, int frags, int nst) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t slot_bytes = (frags + BN / 64) * PANEL;
  Ring ring{base, slot_bytes, base + nst * slot_bytes, nst};
  if (threadIdx.x == 0) ring.init(2 * kWarpgroup);
  __syncthreads();
  const long long tiles = static_cast<long long>(E) * ((M + BM - 1) / BM) *
                          ((N + BN - 1) / BN);
  const int kt = (K + BK - 1) / BK;

  if (threadIdx.x >= 2 * kWarpgroup) {
    // ---- producer: hands its registers to the consumers; one thread
    // issues the stages' TMA copies, in the consumers' order (K, M and N
    // tails arrive as zeros)
    setmaxnreg_dec<40>();
    if (threadIdx.x != 2 * kWarpgroup) return;
    uint64_t keep, stream;
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
                 : "=l"(keep));
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                 : "=l"(stream));
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const TileGeom g = geom<BN>(t, E, M, N, order);
      const uint32_t bytes = (g.fa + g.nb) * PANEL;
      for (int kb = 0; kb < kt; ++kb) {
        const int k0 = kb * BK;
        ring.acquire();
        const uint32_t slot = ring.slot(), bar = ring.full();
        mbar_expect_tx(bar, bytes);
        for (int f = 0; f < g.fa; ++f)
          tma_load_hint(slot + f * PANEL, &tm_l, bar, k0, g.m0 + FRAG * f,
                        g.e, keep);
        for (int p = 0; p < g.nb; ++p)
          tma_load_hint(slot + (frags + p) * PANEL, &tm_r, bar,
                        g.n0 + 64 * p, k0, g.e, stream);
        ring.next();
      }
    }
  } else {
    // ---- consumers: warpgroup w on columns [n0 + w BN / 2, n0 + (w + 1)
    // BN / 2) of every fragment
    setmaxnreg_inc<232>();
    const int w = threadIdx.x / kWarpgroup;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const TileGeom g = geom<BN>(t, E, M, N, order);
      switch (g.fa) {
        case 1:
          consume_tile<1, BN>(ring, g, frags, kt, w, out, M, N);
          break;
        case 2:
          consume_tile<2, BN>(ring, g, frags, kt, w, out, M, N);
          break;
        case 3:
          consume_tile<3, BN>(ring, g, frags, kt, w, out, M, N);
          break;
        default:
          // 256 columns hold at most three fragments' sums in registers
          if constexpr (BN == 128)
            consume_tile<4, BN>(ring, g, frags, kt, w, out, M, N);
          break;
      }
    }
  }
}

template <int BN>
cudaError_t launch(const CUtensorMap& tl, const CUtensorMap& tr, void* out,
                   int E, int M, int K, int N, int order, int frags,
                   int stages, int blocks, cudaStream_t stream) {
  const size_t smem = 1024 +
                      static_cast<size_t>(stages) * (frags + BN / 64) * PANEL +
                      kBarBytes;
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  auto kern = grouped_gemm_hopper_kernel<BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<static_cast<unsigned>(blocks), 3 * kWarpgroup, smem, stream>>>(
      tl, tr, static_cast<bf16*>(out), E, M, K, N, order, frags, stages);
  return cudaGetLastError();
}

}  // namespace

// bf16 only. lhs: (E, M, K) with strides (sle, slm, 1); rhs: (E, K, N)
// with strides (sre, srk, 1), possibly a column slice; every base 16-byte
// aligned, every stride and K, N multiples of 8. out: (E, M, N)
// contiguous. order 0 = expert_major, 1 = n_major. The launch
// (kernels/grouped_gemm.py hopper_plan): bn, the tile's columns (256 when
// the sums of at most three fragments fit the registers, else 128);
// frags, the m64 fragments a stage holds lhs panels for, min(4,
// ceil(M / 64)); stages, the ring's depth; blocks, the persistent grid.
// Returns the launch's CUDA error (0 = success).
extern "C" int repro_grouped_gemm_hopper(const void* lhs, long long sle,
                                         long long slm, const void* rhs,
                                         long long sre, long long srk,
                                         void* out, int E, int M, int K,
                                         int N, int order, int bn, int frags,
                                         int stages, int blocks,
                                         void* stream) {
  const int need = M > BM ? MAX_FRAGS : (M + FRAG - 1) / FRAG;
  if (E <= 0 || M <= 0 || K <= 0 || N <= 0 || frags < need ||
      frags > (bn == 256 ? 3 : MAX_FRAGS) || (bn != 128 && bn != 256) ||
      stages < 2 || stages > kMaxStages || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tl, tr;
  cudaError_t err = tensor_map(&tl, lhs, K, M, E, slm, sle);
  if (err == cudaSuccess) err = tensor_map(&tr, rhs, N, K, E, srk, sre);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn == 256)
    return launch<256>(tl, tr, out, E, M, K, N, order, frags, stages, blocks,
                       st);
  return launch<128>(tl, tr, out, E, M, K, N, order, frags, stages, blocks,
                     st);
}
