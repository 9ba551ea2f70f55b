// The recompute launch shared by the fused expert-MLP backward kernels on
// Hopper (fused_mlp_dgrad_hopper.cu, fused_mlp_wgrad_hopper.cu): per
// (expert, 64-row M tile, 128-column f tile), gate = x . Wg and up = x . Wu
// over d and dh = dY . Wd^T over N on wgmma, dh rounded to bf16
// (src/repro/kernels/fused_mlp.py:213 and :304), the activation and its VJP
// in fp32, and h (wgrad only), dup and dgate written once in bf16 to
// (E, R, f) scratch planes: the rounding points of the TPU kernel and of
// the general kernels (dup.astype(x.dtype) before the transposed products).
//
// One block per tile, each of two consumer warpgroups on 64 of the tile's
// 128 f columns (two independent chains of wgmmas; the x and dY slices
// loaded once for both); one producer thread issues the TMA copies into a
// ring of 5 stages (hopper.cuh). Out-of-bounds rows and columns arrive as
// zeros and are masked on store.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro;
using namespace repro::hopper;
using bf16 = __nv_bfloat16;

constexpr int BM = 64;   // rows of a recompute tile
constexpr int BF = 128;  // hidden columns of a recompute tile
constexpr int BK = 64;   // depth of a ring stage
constexpr int PANEL = 64 * 128;          // 64 rows of 128 bytes
constexpr int SLOT1 = 5 * PANEL;         // x, Wg (2), Wu (2) | dY, Wd (2)
constexpr int STAGES1 = 5;
constexpr size_t SMEM1 = 1024 + STAGES1 * SLOT1 + kBarBytes;

__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The operands' tensor maps, as (columns, rows, experts): x (d, R, E), Wg
// and Wu (f, d, E) in 64-row boxes, Wd (N, f, E) in 128-row boxes (the
// product's K-major B), dY (N, R, E). Wg is Wu's map for non-GLU
// activations (never read).
struct Operands {
  CUtensorMap x, g, u, d, y;
};

inline cudaError_t operand_maps(Operands* m, const void* x, long long sxe,
                                long long sxr, const void* wg, const void* wu,
                                long long swe, long long swk, const void* wd,
                                long long sde, long long sdf, const void* dy,
                                long long sye, long long syr, int E, int R,
                                int d, int f, int N) {
  cudaError_t err = tensor_map(&m->x, x, d, R, E, sxr, sxe);
  if (err == cudaSuccess) err = tensor_map(&m->u, wu, f, d, E, swk, swe);
  if (err == cudaSuccess)
    err = wg != nullptr ? tensor_map(&m->g, wg, f, d, E, swk, swe)
                        : tensor_map(&m->g, wu, f, d, E, swk, swe);
  if (err == cudaSuccess) err = tensor_map(&m->d, wd, N, f, E, sdf, sde, 128);
  if (err == cudaSuccess) err = tensor_map(&m->y, dy, N, R, E, syr, sye);
  return err;
}

template <bool GLU>
__global__ void __launch_bounds__(3 * kWarpgroup, 1)
    recompute_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_g,
                     const __grid_constant__ CUtensorMap tm_u,
                     const __grid_constant__ CUtensorMap tm_d,
                     const __grid_constant__ CUtensorMap tm_y,
                     bf16* __restrict__ hs, bf16* __restrict__ dus,
                     bf16* __restrict__ dgs, int E, int R, int d, int f,
                     int N, int act) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  Ring ring{base, SLOT1, base + STAGES1 * SLOT1, STAGES1};
  if (threadIdx.x == 0) ring.init(2 * kWarpgroup);
  __syncthreads();
  const int MT = (R + BM - 1) / BM, FT = (f + BF - 1) / BF;
  const int fb = static_cast<int>(blockIdx.x % FT);
  const int m = static_cast<int>((blockIdx.x / FT) % MT);
  const int e = static_cast<int>(blockIdx.x / (FT * MT));
  const int m0 = m * BM, f0 = fb * BF;
  const int kd = (d + BK - 1) / BK, kn = (N + BK - 1) / BK;

  if (threadIdx.x >= 2 * kWarpgroup) {
    // one thread issues the TMA copies (out-of-bounds rows and columns
    // arrive as zeros)
    if (threadIdx.x != 2 * kWarpgroup) return;
    for (int kb = 0; kb < kd; ++kb) {
      const int k0 = kb * BK;
      ring.acquire();
      const uint32_t slot = ring.slot(), bar = ring.full();
      mbar_expect_tx(bar, (GLU ? 5 : 3) * PANEL);
      tma_load(slot, &tm_x, bar, k0, m0, e);
      for (int p = 0; p < 2; ++p) {
        if (GLU)
          tma_load(slot + (1 + p) * PANEL, &tm_g, bar, f0 + 64 * p, k0, e);
        tma_load(slot + (3 + p) * PANEL, &tm_u, bar, f0 + 64 * p, k0, e);
      }
      ring.next();
    }
    for (int nb = 0; nb < kn; ++nb) {
      const int n0 = nb * BK;
      ring.acquire();
      const uint32_t slot = ring.slot(), bar = ring.full();
      mbar_expect_tx(bar, 3 * PANEL);
      tma_load(slot, &tm_y, bar, n0, m0, e);
      // Wd rows f0.. (the product's N) by columns n0.. (its K): K-major B,
      // 128 rows of 128 bytes, the second warpgroup's half 8 KB in
      tma_load(slot + PANEL, &tm_d, bar, n0, f0, e);
      ring.next();
    }
  } else {
    // one stage's wgmmas stay in flight while the next stage lands
    const int w = threadIdx.x / kWarpgroup;
    float g[32], u[32], dh[32];
    zero(g);
    zero(u);
    zero(dh);
    uint32_t held = 0;  // the empty barrier of the stage still in use
    for (int kb = 0; kb < kd; ++kb) {
      ring.wait();
      const uint32_t slot = ring.slot();
      fence_regs(g);
      fence_regs(u);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = desc_k(slot + kk * 32);
        if (GLU)
          wgmma_m64n64<0, 1>(
              g, da, desc_mn(slot + (1 + w) * PANEL + kk * 2048, PANEL), 1);
        wgmma_m64n64<0, 1>(
            u, da, desc_mn(slot + (3 + w) * PANEL + kk * 2048, PANEL), 1);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(g);
      fence_regs(u);
      if (held) mbar_arrive(held);
      held = ring.empty();
      ring.next();
    }
    // gate and up complete before dh's wgmmas start on other registers
    wgmma_wait<0>();
    fence_regs(g);
    fence_regs(u);
    for (int nb = 0; nb < kn; ++nb) {
      ring.wait();
      const uint32_t slot = ring.slot();
      fence_regs(dh);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_m64n64<0, 0>(dh, desc_k(slot + kk * 32),
                           desc_k(slot + PANEL + w * PANEL + kk * 32), 1);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(dh);
      if (held) mbar_arrive(held);
      held = ring.empty();
      ring.next();
    }
    wgmma_wait<0>();
    fence_regs(dh);
    if (held) mbar_arrive(held);
    // the VJP on the registers; zero-filled rows and columns are masked
    const int fw0 = f0 + w * 64;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int r = m0 + frag_row(i), c = fw0 + frag_col(i);
      if (r < R && c < f) {
        float h[2], du[2], dg[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float dhr = __bfloat162float(__float2bfloat16(dh[i + j]));
          activate_vjp(act, g[i + j], u[i + j], dhr, dg[j], du[j]);
          h[j] = activate(act, g[i + j], u[i + j]);
        }
        const long long o = (static_cast<long long>(e) * R + r) * f + c;
        if (hs != nullptr) store_pair(hs + o, h[0], h[1]);
        store_pair(dus + o, du[0], du[1]);
        if (GLU) store_pair(dgs + o, dg[0], dg[1]);
      }
    }
  }
}

// The recompute over every (expert, M tile, f tile); hs null skips h.
inline cudaError_t launch_recompute(const Operands& m, bool glu, bf16* hs,
                                    bf16* dus, bf16* dgs, int E, int R,
                                    int d, int f, int N, int act,
                                    cudaStream_t st) {
  auto kern = glu ? recompute_kernel<true> : recompute_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM1));
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(E) * ((R + BM - 1) / BM) *
                           ((f + BF - 1) / BF);
  kern<<<static_cast<unsigned>(blocks), 3 * kWarpgroup, SMEM1, st>>>(
      m.x, m.g, m.u, m.d, m.y, hs, dus, dgs, E, R, d, f, N, act);
  return cudaGetLastError();
}

}  // namespace
