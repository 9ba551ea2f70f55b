// Flash attention on Hopper's wgmma, the bf16 path: causal (or full) GQA
// attention with an online softmax, head_dim 64 or 128. Scores,
// probabilities and the running (max, sum, acc) are fp32; only the output
// is rounded to bf16.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention, the
// __fusable__flash region of repro/models/blocks.py::_attn_core, which the
// port's training forward reaches through blocks.attn_apply, for bf16
// q, k, v with 16-byte aligned bases and strides that are multiples of 8
// elements. fp32 and other head widths run the general kernel in
// flash_attention.cu.
//
// What bounds it on an H100: at the qwen2-moe-2.7b train shape (B 4,
// Hq = Hkv = 16, S 1024, hd 128, causal) the bytes of q, k, v and the
// output, 4 x 16.8 MB = 67 MB, about 20 us at 3.35 TB/s, against about 17
// GFLOP of QK^T and PV over the causal half, about 17 us at 989 TFLOP/s
// (the three-term P below makes PV three times its work: 34 GFLOP in all).
//
// Design. One block per (b * Hq + h, 128-row q tile), the longest causal
// rows issued first; two consumer warpgroups take 64 q rows each and one
// producer thread issues the TMA copies. q, k and v arrive as transposed
// views of the model's (B, S, H, hd) tensors, read through 4-d tensor maps
// (hd, S, H, B). Q is loaded once; K and V tiles of 64 keys stream through
// a ring of 4 stages (hopper.cuh) up to the diagonal, and a warpgroup
// issues no wgmma for a tile whose keys all lie past its last query
// (flash_attention.py:36-38 skips such tiles). Per kv tile and warpgroup:
//   S = Q . K^T              wgmma m64n64, both operands K-major (hd
//                            contiguous), fp32 sums
//   S / sqrt(hd), masked     causal keys past the query get -1e30 (the TPU
//                            kernel's NEG_INF), keys past Sk (zero-filled
//                            by TMA) get -inf; the scale and log2(e) are
//                            one multiply, and exp2 takes exp's place
//   online softmax           in registers on the accumulator fragment: a
//                            row is held by a quad of threads (__shfl_xor
//                            1 and 2); m, l and the correction in fp32
//   acc = acc * corr + P . V on the tensor cores: V is an MN-major B
//                            operand (keys are K, hd contiguous). P stays
//                            as exact as fp32: P = P_hi + P_mid + P_lo,
//                            each the bf16 of what the terms before it
//                            left, three wgmmas into one fp32
//                            accumulator; the products of bf16 values are
//                            exact, so P is carried to about 2^-26
//                            relative. Each tile's P . V starts from zero
//                            and joins acc in an fp32 fma, rounded to
//                            nearest, so the tensor cores' own sums stay
//                            within one tile. With two terms (2^-17)
//                            and the tensor cores' sum running over all
//                            tiles, a first version's max error against
//                            the plain version reached 4x the fp32-P
//                            kernel's on the card; this one flips the
//                            bf16 rounding of fewer outputs than that
//                            kernel does. P goes to
//                            wgmma from registers: the S accumulator's
//                            fragment, rounded in pairs, is the register
//                            A operand (hopper.cuh). The accumulator, the
//                            tile's sum and the three terms need more
//                            registers than an even split of the SM
//                            gives; the producer warpgroup hands its
//                            registers to the consumers (setmaxnreg).
// At the end out = acc / max(l, 1e-30), rounded to bf16 once, staged in the
// warpgroup's own Q rows and written in 16-byte vectors. GQA: q head h
// reads kv head h / (Hq / Hkv) through the tensor map's index, with no
// repeated copy. No atomics: two calls give the same bits.
#include "common.cuh"
#include "hopper.cuh"

using namespace repro;
using namespace repro::hopper;

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 128;            // query rows per block, 64 per warpgroup
constexpr int BKV = 64;            // keys per kv tile
constexpr int STAGES = 4;
constexpr float kMasked = -1e30f;  // the TPU kernel's NEG_INF

template <int HD> struct FlashLayout {
  static constexpr int P = HD / 64;            // 64-column panels of hd
  static constexpr int Q_PANEL = BQ * 128;     // 128 rows of 128 bytes
  static constexpr int KV_PANEL = BKV * 128;   // 64 rows of 128 bytes
  static constexpr int Q_BYTES = P * Q_PANEL;
  static constexpr int KV_BYTES = P * KV_PANEL;
  static constexpr int SLOT = 2 * KV_BYTES;    // K, then V
  static constexpr size_t SMEM =
      1024 + Q_BYTES + STAGES * SLOT + kBarBytes + 16;
  static_assert(SMEM <= 232448, "over the 227 KB a block may use");
};

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// t = the bf16 pairs of p, and p -= what t holds
__device__ __forceinline__ void split_term(float (&p)[32], uint32_t (&t)[16]) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    t[i / 2] = pack_bf16(p[i], p[i + 1]);
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&t[i / 2]);
    p[i] -= __low2float(v);
    p[i + 1] -= __high2float(v);
  }
}

// o (+)= T . V over the tile's 64 keys, T a term of P in registers, V at
// v (MN-major: 64-column panels of hd, `panel` bytes apart); accumulate 0
// overwrites o with the first product
template <int HD>
__device__ __forceinline__ void pv_term(float (&o)[HD / 2],
                                        const uint32_t (&t)[16], uint32_t v,
                                        uint32_t panel, int accumulate) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
    const uint32_t a[4] = {t[4 * kk], t[4 * kk + 1], t[4 * kk + 2],
                           t[4 * kk + 3]};
    const uint64_t dv = desc_mn(v + kk * 2048, panel);
    if constexpr (HD == 64)
      wgmma_m64n64_ra<1>(o, a, dv, accumulate || kk > 0);
    else
      wgmma_m64n128_ra<1>(o, a, dv, accumulate || kk > 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(3 * kWarpgroup, 1)
    flash_hopper_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        bf16* __restrict__ o, int Hq, int Hkv, int Sq,
                        int Sk, int causal, float scale_log2) {
  using L = FlashLayout<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_base = base, kv_base = base + L::Q_BYTES;
  const uint32_t bars = kv_base + STAGES * L::SLOT;
  const uint32_t q_bar = bars + kBarBytes;
  Ring ring{kv_base, L::SLOT, bars, STAGES};
  if (threadIdx.x == 0) {
    ring.init(2 * kWarpgroup);
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  const int nq = (Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.y)) * BQ;
  const int h = blockIdx.x % Hq, b = blockIdx.x / Hq;
  const int hk = h / (Hq / Hkv);
  const int kv_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int n_kv = (kv_end + BKV - 1) / BKV;

  if (threadIdx.x >= 2 * kWarpgroup) {
    // the producer warpgroup hands its registers to the consumers; one
    // thread issues the TMA copies (rows past Sq and Sk arrive as zeros)
    setmaxnreg_dec<24>();
    if (threadIdx.x == 2 * kWarpgroup) {
      mbar_expect_tx(q_bar, L::Q_BYTES);
      for (int p = 0; p < L::P; ++p)
        tma_load(q_base + p * L::Q_PANEL, &tm_q, q_bar, 64 * p, q0, h, b);
      for (int t = 0; t < n_kv; ++t) {
        ring.acquire();
        const uint32_t slot = ring.slot(), bar = ring.full();
        mbar_expect_tx(bar, L::SLOT);
        for (int p = 0; p < L::P; ++p) {
          tma_load(slot + p * L::KV_PANEL, &tm_k, bar, 64 * p, t * BKV, hk,
                   b);
          tma_load(slot + L::KV_BYTES + p * L::KV_PANEL, &tm_v, bar, 64 * p,
                   t * BKV, hk, b);
        }
        ring.next();
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int w = threadIdx.x / kWarpgroup;
    const int qw0 = q0 + w * 64;  // this warpgroup's first query row
    // the two rows this thread holds: frag_row(0) and frag_row(2)
    const int r0 = qw0 + frag_row(0);
    float acc[HD / 2];
    zero(acc);
    float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
    mbar_wait(q_bar, 0);
    for (int t = 0; t < n_kv; ++t) {
      const int k0 = t * BKV;
      ring.wait();
      const uint32_t slot = ring.slot();
      // nothing to do when this warpgroup's rows all lie past Sq, or
      // (causal) every key of the tile lies past its last query
      if (qw0 < Sq && !(causal && k0 > qw0 + 63)) {
        float s[32];
        fence_regs(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t off = (kk % 4) * 32;
          wgmma_m64n64<0, 0>(
              s,
              desc_k(q_base + (kk / 4) * L::Q_PANEL +
                     w * (L::Q_PANEL / 2) + off),
              desc_k(slot + (kk / 4) * L::KV_PANEL + off), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        // scale and mask; element i belongs to row r0 + 8 * ((i / 2) % 2)
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int j = (i / 2) % 2;
          const int key = k0 + frag_col(i);
          float v = s[i] * scale_log2;
          if (key >= Sk)
            v = -INFINITY;
          else if (causal && key > r0 + 8 * j)
            v = kMasked;
          s[i] = v;
          mx[j] = fmaxf(mx[j], v);
        }
        float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
          mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
          const float m_new = fmaxf(m[j], mx[j]);
          corr[j] = exp2f(m[j] - m_new);
          m[j] = m_new;
        }
        // P in place of the scores, its row sums, and its three bf16
        // terms: each the bf16 of what the terms before it left
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          s[i] = exp2f(s[i] - m[(i / 2) % 2]);
          sum[(i / 2) % 2] += s[i];
        }
        uint32_t hi[16], mid[16], lo[16];
        split_term(s, hi);
        split_term(s, mid);
        split_term(s, lo);
        // tile = P_lo . V + P_mid . V + P_hi . V in a fresh accumulator, 4
        // wgmmas of 16 keys per term (register A: the fragment of S
        // columns 16k .. 16k + 15 is a[4k .. 4k + 3]), smallest term first
        float tile[HD / 2];
        fence_regs(tile);
        wgmma_fence();
        pv_term<HD>(tile, lo, slot + L::KV_BYTES, L::KV_PANEL, 0);
        pv_term<HD>(tile, mid, slot + L::KV_BYTES, L::KV_PANEL, 1);
        pv_term<HD>(tile, hi, slot + L::KV_BYTES, L::KV_PANEL, 1);
        wgmma_commit();
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          sum[j] += __shfl_xor_sync(0xffffffffu, sum[j], 1);
          sum[j] += __shfl_xor_sync(0xffffffffu, sum[j], 2);
          l[j] = l[j] * corr[j] + sum[j];
        }
        wgmma_wait<0>();
        fence_regs(tile);
        fence_regs(hi);
        fence_regs(mid);
        fence_regs(lo);
        // acc = acc * corr + tile in fp32, rounded to nearest: the tensor
        // cores' sums never run across tiles
#pragma unroll
        for (int i = 0; i < HD / 2; ++i)
          acc[i] = fmaf(acc[i], corr[(i / 2) % 2], tile[i]);
      }
      mbar_arrive(ring.empty());
      ring.next();
    }
    if (qw0 < Sq) {
      // out = acc / max(l, 1e-30) in bf16, staged in this warpgroup's own
      // Q rows (the same swizzled panels), then out in 16-byte vectors
      unsigned char* qs = smem_raw + (q_base - raw) + w * (L::Q_PANEL / 2);
      const float inv[2] = {1.f / fmaxf(l[0], 1e-30f),
                            1.f / fmaxf(l[1], 1e-30f)};
#pragma unroll
      for (int i = 0; i < HD / 2; i += 2) {
        const int r = frag_row(i), c = frag_col(i), j = (i / 2) % 2;
        *reinterpret_cast<uint32_t*>(qs + (c / 64) * L::Q_PANEL +
                                     swz(r, (c % 64) / 8) + (c % 8) * 2) =
            pack_bf16(acc[i] * inv[j], acc[i + 1] * inv[j]);
      }
      bar_sync(1 + w, kWarpgroup);
      constexpr int CH = HD / 8;  // 16-byte chunks per row
      for (int q = threadIdx.x % kWarpgroup; q < 64 * CH; q += kWarpgroup) {
        const int r = q / CH, ch = q % CH;
        if (qw0 + r < Sq)
          *reinterpret_cast<uint4*>(
              o + ((static_cast<long long>(b) * Sq + qw0 + r) * Hq + h) *
                      HD +
              ch * 8) =
              *reinterpret_cast<const uint4*>(qs + (ch / 8) * L::Q_PANEL +
                                              swz(r, ch % 8));
      }
    }
  }
}

template <int HD>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, void* o, int B, int Hq, int Hkv,
                   int Sq, int Sk, int causal, cudaStream_t st) {
  using L = FlashLayout<HD>;
  auto kern = flash_hopper_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::SMEM));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(B * Hq),
                  static_cast<unsigned>((Sq + BQ - 1) / BQ));
  kern<<<grid, 3 * kWarpgroup, L::SMEM, st>>>(
      tq, tk, tv, static_cast<bf16*>(o), Hq, Hkv, Sq, Sk, causal,
      1.4426950408889634f / sqrtf(static_cast<float>(HD)));
  return cudaGetLastError();
}

}  // namespace

// bf16 only. q: (B, Sq, Hq, hd) through strides (sqb, sqs, sqh, 1); k/v:
// (B, Sk, Hkv, hd) through theirs; every base 16-byte aligned, every stride
// a multiple of 8; hd 64 or 128; Hq a multiple of Hkv. o: (B, Sq, Hq, hd)
// contiguous. causal compares positions from 0 of queries and keys.
// Returns the launch's CUDA error.
extern "C" int repro_flash_attention_hopper(
    const void* q, long long sqb, long long sqs, long long sqh,
    const void* k, long long skb, long long sks, long long skh,
    const void* v, long long svb, long long svs, long long svh, void* o,
    int B, int Hq, int Hkv, int Sq, int Sk, int hd, int causal,
    void* stream) {
  if ((hd != 64 && hd != 128) || Sq <= 0 || Sk <= 0 || Hkv <= 0 ||
      Hq % Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // (hd, S, H, B) maps: 128-row boxes of q, 64-row boxes of k and v
  CUtensorMap tq, tk, tv;
  cudaError_t err = tensor_map(&tq, q, hd, Sq, Hq, B, sqs, sqh, sqb, BQ);
  if (err == cudaSuccess)
    err = tensor_map(&tk, k, hd, Sk, Hkv, B, sks, skh, skb, BKV);
  if (err == cudaSuccess)
    err = tensor_map(&tv, v, hd, Sk, Hkv, B, svs, svh, svb, BKV);
  if (err != cudaSuccess) return err;
  if (hd == 64) return launch<64>(tq, tk, tv, o, B, Hq, Hkv, Sq, Sk, causal, st);
  return launch<128>(tq, tk, tv, o, B, Hq, Hkv, Sq, Sk, causal, st);
}
