// Fused expert MLP on Hopper's wgmma, the bf16 path of
// out[e] = act(x[e] . Wg[e], x[e] . Wu[e]).astype(bf16) . Wd[e]
//
// Replaces: src/repro/kernels/fused_mlp.py::fused_mlp (the "pallas_fused"
// GroupGEMM backend, forward), for bf16 operands with 16-byte aligned
// bases and row strides and d, f, N multiples of 8 (every main-path call).
// fp32 and other shapes run the general kernel in fused_mlp.cu. The hidden
// never gets a device-memory address (the TPU kernel's point,
// fused_mlp.py:1-12) and is rounded to bf16 before the second product
// (fused_mlp.py:81).
//
// What bounds it on an H100: the three weight tensors' bytes, 1.1 GB for
// qwen2-moe-2.7b (E = 64, d = N = 2048, f = 1408), about 0.33 ms at
// 3.35 TB/s, at decode (R = 4) and at a 2048-token prefill (R = 160, 177
// GFLOP = 0.18 ms at 989 TFLOP/s); at the train shape (R = 320) the
// products and the bytes are about equal.
//
// Design: split-f with few splits. A (64, N) fp32 sum at N = 2048 needs
// 512 KB, more than an SM holds, and recomputing the hidden per N tile
// multiplies GEMM1's work by N / 256. So one block per (expert, 64-row M
// tile, f-split of F_s hidden columns), F_s a multiple of 128 and at most
// 768, chosen by the wrapper (kernels/fused_mlp.py::fused_mlp_plan):
//   phase A, per 128-column sub-chunk of the split: gate and up over d
//     (x slices K-major, Wg/Wu slices MN-major, streamed through the
//     ring), the activation in fp32 on the registers, the result cast to
//     bf16 into the split's hidden, which stays in shared memory (64 x F_s
//     bf16, at most 96 KB);
//   phase B, per 256-column N tile: hidden (K-major A, from shared memory)
//     . Wd[split rows, N tile] (MN-major B, streamed), written as the
//     split's fp32 partial plane.
// A reduce pass (sum_splits_kernel, 16-byte vectors) then adds the
// S = ceil(f / F_s) planes in split order (deterministic, no atomics) and
// casts to bf16. The general kernel writes f / 128 planes: at the prefill
// shape 11 planes (1.85 GB of traffic) against 2 here (336 MB); at
// jamba-v0.1-52b's expert width (f = 14336) 112 against 19.
//
// The block is three warpgroups. One thread of the third issues the TMA
// copies into a ring of 40 KB stages (hopper.cuh), in the order the
// consumers take them: phase A's (sub-chunk, d slice) stages, then phase
// B's (N tile, f slice) ones. The first two consume: both on the same 64
// rows, each on half the columns (64 of a sub-chunk: gate and up in two
// m64n64 fp32 accumulators; 128 of an N tile: one m64n128), so two
// independent chains of wgmmas keep the tensor cores busy, and each keeps
// one stage's wgmmas in flight while the next lands (wait_group 1).
// Shared memory: the split's hidden (F_s / 64 panels of 8 KB) and as many
// ring stages as fit beside it (3 at F_s = 768, 5 at 128), one block per
// SM. Ragged R, d, f and N arrive as zeros from TMA (act(0, 0) = 0 for
// every activation, so padded hidden columns are 0) and are masked on
// store; w_down may be a column slice (its own row stride). `order` sets
// the issue order of the (expert, M tile, split) blocks as
// common.cuh::tile_of does, and the reduce pass's traversal.
#include "common.cuh"
#include "hopper.cuh"
#include "attrs.cuh"

using namespace repro;
using namespace repro::hopper;

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;      // rows per block (both consumer warpgroups)
constexpr int BK = 64;      // depth of a ring stage (d slice, f slice)
constexpr int FC = 128;     // hidden columns per phase-A sub-chunk
constexpr int BN = 256;     // output columns per phase-B tile
constexpr int FS_MAX = 768; // hidden columns a block keeps
constexpr int PANEL = 64 * 128;   // 64 rows of 128 bytes
constexpr int SLOT = 5 * PANEL;   // x + Wg (2) + Wu (2) | Wd (4)
constexpr int SMEM_MAX = 232448;  // what a block may use

// the ring takes what the split's hidden leaves: 5 stages at F_s = 128,
// 4 up to 512, 3 at 640 and 768
__host__ __device__ constexpr int stages_for(int fs) {
  return (SMEM_MAX - 1024 - kBarBytes - fs / 64 * PANEL) / SLOT < kMaxStages
             ? (SMEM_MAX - 1024 - kBarBytes - fs / 64 * PANEL) / SLOT
             : kMaxStages;
}

constexpr size_t smem_for(int fs) {
  return 1024 + static_cast<size_t>(stages_for(fs)) * SLOT +
         fs / 64 * PANEL + kBarBytes;
}
static_assert(stages_for(FS_MAX) >= 3, "the ring needs 3 stages");

template <bool GLU>
__global__ void __launch_bounds__(3 * kWarpgroup, 1)
    fused_mlp_hopper_kernel(const __grid_constant__ CUtensorMap tm_x,
                            const __grid_constant__ CUtensorMap tm_g,
                            const __grid_constant__ CUtensorMap tm_u,
                            const __grid_constant__ CUtensorMap tm_d,
                            float* __restrict__ part, int E, int R, int d,
                            int f, int N, int act, int fs, int S, int order) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int nst = stages_for(fs);
  const uint32_t hid = base + nst * SLOT;
  unsigned char* hid_ptr = smem_raw + (hid - raw);
  Ring ring{base, SLOT, hid + fs / 64 * PANEL, nst};

  const int MT = (R + BM - 1) / BM;
  const Tile tl = tile_of(blockIdx.x, E, MT, S, order);
  const int e = tl.e, m0 = tl.m * BM, s = tl.n, f0 = s * fs;
  const int fw = min(fs, f - f0);  // this split's hidden columns
  const int nsub = (fw + FC - 1) / FC, kd = (d + BK - 1) / BK;
  const int kf = (fw + BK - 1) / BK, nt = (N + BN - 1) / BN;

  if (threadIdx.x == 0) ring.init(2 * kWarpgroup);
  __syncthreads();

  if (threadIdx.x >= 2 * kWarpgroup) {
    // ---- producer: one thread issues the stages' TMA copies, in the
    // consumers' order (rows past R and columns past d, f, N arrive as
    // zeros). Wd's rows are cut at the split's end by the k loop.
    if (threadIdx.x != 2 * kWarpgroup) return;
    const uint32_t a_bytes = (GLU ? 5 : 3) * PANEL, b_bytes = 4 * PANEL;
    for (int sub = 0; sub < nsub; ++sub) {
      const int fc0 = f0 + sub * FC;
      for (int kb = 0; kb < kd; ++kb) {
        const int k0 = kb * BK;
        ring.acquire();
        const uint32_t slot = ring.slot(), bar = ring.full();
        mbar_expect_tx(bar, a_bytes);
        tma_load(slot, &tm_x, bar, k0, m0, e);
        for (int p = 0; p < 2; ++p) {
          if (GLU)
            tma_load(slot + (1 + p) * PANEL, &tm_g, bar, fc0 + 64 * p, k0, e);
          tma_load(slot + (3 + p) * PANEL, &tm_u, bar, fc0 + 64 * p, k0, e);
        }
        ring.next();
      }
    }
    for (int n = 0; n < nt; ++n) {
      const int n0 = n * BN;
      for (int kb = 0; kb < kf; ++kb) {
        const int k0 = kb * BK;
        ring.acquire();
        const uint32_t slot = ring.slot(), bar = ring.full();
        mbar_expect_tx(bar, b_bytes);
        for (int p = 0; p < 4; ++p)
          tma_load(slot + p * PANEL, &tm_d, bar, n0 + 64 * p, f0 + k0, e);
        ring.next();
      }
    }
  } else {
    // ---- consumers: two warpgroups on the same 64 rows, each on its half
    // of the columns (64 of a sub-chunk, 128 of an N tile), so two
    // independent chains of wgmmas keep the tensor cores busy. Each
    // stage's wgmmas are committed as a group; the stage before it is
    // handed back once only the newest group may still run (wait_group 1).
    const int w = threadIdx.x / kWarpgroup;
    // ---- phase A: the split's hidden --------------------------------------
    for (int sub = 0; sub < nsub; ++sub) {
      float g[32], u[32];
      zero(g);
      zero(u);
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
      wgmma_wait<0>();
      fence_regs(g);
      fence_regs(u);
      if (held) mbar_arrive(held);
      // the activation in fp32, then h.astype(bf16) into this warpgroup's
      // hidden panel
      unsigned char* panel = hid_ptr + (sub * 2 + w) * PANEL;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = frag_row(i), c = frag_col(i);
        const __nv_bfloat162 h = __floats2bfloat162_rn(
            activate(act, g[i], u[i]), activate(act, g[i + 1], u[i + 1]));
        *reinterpret_cast<__nv_bfloat162*>(panel + swz(r, c / 8) +
                                           (c % 8) * 2) = h;
      }
    }
    fence_proxy_async();
    bar_sync(1, 2 * kWarpgroup);  // the whole hidden written before phase B

    // ---- phase B: one fp32 partial plane per split -------------------------
    for (int n = 0; n < nt; ++n) {
      const int n0 = n * BN + w * (BN / 2);
      float acc[64];
      zero(acc);
      uint32_t held = 0;
      for (int kb = 0; kb < kf; ++kb) {
        ring.wait();
        const uint32_t slot = ring.slot();
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_m64n128<0, 1>(
              acc, desc_k(hid + kb * PANEL + kk * 32),
              desc_mn(slot + 2 * w * PANEL + kk * 2048, PANEL), 1);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(acc);
        if (held) mbar_arrive(held);
        held = ring.empty();
        ring.next();
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (held) mbar_arrive(held);
      float* pe = part + (static_cast<long long>(s) * E + e) * R * N;
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int r = m0 + frag_row(i), c = n0 + frag_col(i);
        if (r < R && c < N)
          *reinterpret_cast<float2*>(pe + static_cast<long long>(r) * N + c) =
              make_float2(acc[i], acc[i + 1]);
      }
    }
  }
}

// The reduce pass: out[row, c..c+7] = sum over the S split planes of
// part[s, row, c..c+7] (each plane rows x N, N a multiple of 8), added in
// split order (deterministic) and cast to bf16; one thread per 8 columns,
// 16-byte loads and stores. order 0 (expert_major) walks rows outermost,
// 1 (n_major) slabs of 1024 columns outermost.
__global__ void __launch_bounds__(256)
    sum_splits_kernel(const float* __restrict__ part, bf16* __restrict__ out,
                      long long rows, int N, int S, int order) {
  const long long t = blockIdx.x * 256ll + threadIdx.x;
  const int C8 = N / 8;
  long long row;
  int c;
  if (order == 0) {
    row = t / C8;
    c = static_cast<int>(t % C8);
  } else {
    const long long per = rows * 128;
    const long long rem = t % per;
    row = rem / 128;
    c = static_cast<int>(t / per) * 128 + static_cast<int>(rem % 128);
    if (c >= C8) return;
  }
  if (row >= rows) return;
  const long long plane = rows * N, o = row * N + c * 8;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int sp = 0; sp < S; ++sp) {
    const float4* q = reinterpret_cast<const float4*>(part + sp * plane + o);
    const float4 a = __ldg(q), b = __ldg(q + 1);
    acc[0] += a.x;
    acc[1] += a.y;
    acc[2] += a.z;
    acc[3] += a.w;
    acc[4] += b.x;
    acc[5] += b.y;
    acc[6] += b.z;
    acc[7] += b.w;
  }
  __align__(16) __nv_bfloat162 v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
  *reinterpret_cast<uint4*>(out + o) = *reinterpret_cast<const uint4*>(v);
}

}  // namespace

// bf16 only. x: (E, R, d) with strides (sxe, sxr, 1); wg/wu: (E, d, f)
// with strides (swe, swk, 1), wg null for non-GLU activations; wd:
// (E, f, N) with strides (sde, sdf, 1), possibly a column slice; every
// base 16-byte aligned, every stride and d, f, N multiples of 8. fs: the
// split's hidden columns, a multiple of 128 up to 768; part: fp32 scratch
// of ceil(f / fs) * E * R * N elements; out: (E, R, N) contiguous.
// order 0 = expert_major, 1 = n_major. Returns the CUDA error of the
// launches (0 = success).
extern "C" int repro_fused_mlp_hopper(const void* x, long long sxe,
                                      long long sxr, const void* wg,
                                      const void* wu, long long swe,
                                      long long swk, const void* wd,
                                      long long sde, long long sdf,
                                      void* part, void* out, int E, int R,
                                      int d, int f, int N, int act, int order,
                                      int fs, void* stream) {
  if (fs <= 0 || fs % FC != 0 || fs > FS_MAX || d <= 0 || f <= 0 || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap tx, tg, tu, td;
  cudaError_t err = tensor_map(&tx, x, d, R, E, sxr, sxe);
  if (err == cudaSuccess) err = tensor_map(&tu, wu, f, d, E, swk, swe);
  if (err == cudaSuccess && wg != nullptr)
    err = tensor_map(&tg, wg, f, d, E, swk, swe);
  if (err == cudaSuccess) err = tensor_map(&td, wd, N, f, E, sdf, sde);
  if (err != cudaSuccess) return err;
  if (wg == nullptr) tg = tu;
  auto kern = wg != nullptr ? fused_mlp_hopper_kernel<true>
                            : fused_mlp_hopper_kernel<false>;
  const size_t smem = smem_for(fs);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int S = (f + fs - 1) / fs;
  const long long blocks =
      static_cast<long long>(E) * ((R + BM - 1) / BM) * S;
  kern<<<static_cast<unsigned>(blocks), 3 * kWarpgroup, smem, st>>>(
      tx, tg, tu, td, static_cast<float*>(part), E, R, d, f, N, act, fs, S,
      order);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long rows = static_cast<long long>(E) * R;
  const long long threads =
      order == 0 ? rows * (N / 8) : rows * 128 * ((N / 8 + 127) / 128);
  sum_splits_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0,
                      st>>>(static_cast<const float*>(part),
                            static_cast<bf16*>(out), rows, N, S, order);
  return cudaGetLastError();
}

// The attributes of every kernel instance this file launches (attrs.cuh).
extern "C" int repro_attrs_fused_mlp_hopper(int i, int* out, char* label, int cap) {
  switch (i) {
    case 0:
      return repro_attrs::query(&fused_mlp_hopper_kernel<true>,
                                 "fused_mlp[wgmma]/expert_major,fused_mlp[wgmma]/n_major|bfloat16|GLU", out,
                                 label, cap);
    case 1:
      return repro_attrs::query(&fused_mlp_hopper_kernel<false>,
                                 "fused_mlp[wgmma]/expert_major,fused_mlp[wgmma]/n_major|bfloat16|no GLU", out,
                                 label, cap);
    case 2:
      return repro_attrs::query(&sum_splits_kernel,
                                 "fused_mlp[wgmma]/sum_splits|float32|", out,
                                 label, cap);
    default:
      return -1;
  }
}
