// Flash attention: causal (or full) GQA attention with an online softmax.
// Scores, probabilities and the running (max, sum, acc) are fp32; only the
// output is rounded to the input dtype.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention, the
// __fusable__flash region of repro/models/blocks.py::_attn_core, which the
// port's training forward reaches through blocks.attn_apply.
//
// What bounds it on an H100: at the qwen2-moe-2.7b train shape (B 4,
// Hq = Hkv = 16, S 1024, hd 128, bf16, causal) the bytes of q, k, v and the
// output, 4 x 16.8 MB = 67 MB, about 20 us at 3.35 TB/s, against about 17
// GFLOP of QK^T and PV over the causal half, about 17 us at 989 TFLOP/s.
//
// Design. One block per (64-row q tile, b * Hq + h); the longest causal
// rows are issued first. The block keeps its q tile in shared memory and
// walks the kv tiles of 64 keys up to the diagonal (tiles past it are
// skipped, as flash_attention.py:36-38 skips them). Per kv tile:
//   S = q . k^T            bf16 WMMA with fp32 accumulation (the products
//                          of bf16 values are exact), plain FMAs for fp32
//   S / sqrt(hd), masked   causal keys past the query get -1e30 (the TPU
//                          kernel's value), keys past Sk get -inf
//   online softmax         4 threads per row: m, l and the correction
//                          exp(m_old - m_new) in fp32
//   acc = acc * corr + P . v   fp32 FMAs, P kept in fp32 (no bf16 rounding)
// and at the end out = acc / max(l, 1e-30). GQA: q head h reads kv head
// h / (Hq / Hkv) through the index, with no repeated copy. q, k and v are
// read in the model's (B, S, H, hd) layout through their strides; a
// head_dim below 64 or 128 is zero-filled in shared memory.
#include "common.cuh"
#include "attrs.cuh"

using namespace repro;

namespace {

constexpr int BQ = 64;             // query rows per block
constexpr int BKV = 64;            // keys per kv tile
constexpr float kMasked = -1e30f;  // the TPU kernel's NEG_INF

template <typename T, int HD> struct FlashSmem {
  static constexpr int LD = HD + 8;     // q/k/v tiles (WMMA: multiple of 8)
  static constexpr int LDS = BKV + 4;   // fp32 scores, then probabilities
  static constexpr size_t Q = 0;
  static constexpr size_t K = Q + align128(sizeof(T) * BQ * LD);
  static constexpr size_t V = K + align128(sizeof(T) * BKV * LD);
  static constexpr size_t S = V + align128(sizeof(T) * BKV * LD);
  static constexpr size_t ROW = S + align128(sizeof(float) * BQ * LDS);
  static constexpr size_t BYTES = ROW + align128(sizeof(float) * 3 * BQ);
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, long long sqb, long long sqs,
                 long long sqh, const T* __restrict__ k, long long skb,
                 long long sks, long long skh, const T* __restrict__ v,
                 long long svb, long long svs, long long svh,
                 T* __restrict__ o, int Hq, int Hkv, int Sq, int Sk, int hd,
                 int causal, float sqrt_hd) {
  using L = FlashSmem<T, HD>;
  static_assert(kThreads == 4 * BQ, "the softmax runs 4 threads per row");
  constexpr int CG = HD / 4, TN = 4, RG = kThreads / CG, TM = BQ / RG;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem + L::Q);
  T* ks = reinterpret_cast<T*>(smem + L::K);
  T* vs = reinterpret_cast<T*>(smem + L::V);
  float* ss = reinterpret_cast<float*>(smem + L::S);
  float* m_s = reinterpret_cast<float*>(smem + L::ROW);
  float* l_s = m_s + BQ;
  float* c_s = l_s + BQ;

  const int nq = (Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int h = blockIdx.y % Hq;
  const long long b = blockIdx.y / Hq;
  const int hk = h / (Hq / Hkv);
  const T* kb = k + b * skb + hk * skh;
  const T* vb = v + b * svb + hk * svh;

  load_tile<T, BQ, HD>(qs, L::LD, q + b * sqb + h * sqh + q0 * sqs, sqs,
                       Sq - q0, hd);
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    m_s[r] = kMasked;
    l_s[r] = 0.f;
  }
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int kv_end = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    load_tile<T, BKV, HD>(ks, L::LD, kb + k0 * sks, sks, Sk - k0, hd);
    load_tile<T, BKV, HD>(vs, L::LD, vb + k0 * svs, svs, Sk - k0, hd);
    __syncthreads();
    {
      Acc<T, BQ, BKV> s;
      s.zero();
      s.template mma<false, true>(qs, L::LD, ks, L::LD, HD);
      s.store(ss, L::LDS);
    }
    __syncthreads();
    {  // online softmax: row r, columns part * 16 .. part * 16 + 15
      const int r = threadIdx.x / 4, part = threadIdx.x % 4;
      float* sr = ss + r * L::LDS + part * 16;
      const int qpos = q0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int kpos = k0 + part * 16 + c;
        float s = sr[c] / sqrt_hd;
        if (kpos >= Sk)
          s = -INFINITY;
        else if (causal && kpos > qpos)
          s = kMasked;
        sr[c] = s;
        mx = fmaxf(mx, s);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(sr[c] - m_new);
        sr[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_old - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
        c_s[r] = corr;
      }
    }
    __syncthreads();
    const int rg = threadIdx.x / CG;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float corr = c_s[rg + RG * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] *= corr;
    }
    fma_tile<TM, TN, CG>(acc, ss, L::LDS, 1, vs, L::LD, 1, BKV);
    __syncthreads();
  }

  const int rg = threadIdx.x / CG, cg = threadIdx.x % CG;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = rg + RG * i;
    if (q0 + r >= Sq) continue;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
    T* orow = o + ((b * Sq + q0 + r) * Hq + h) * static_cast<long long>(hd);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = cg + CG * j;
      if (c < hd) orow[c] = from_f<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, long long sqb, long long sqs, long long sqh,
                   const void* k, long long skb, long long sks, long long skh,
                   const void* v, long long svb, long long svs, long long svh,
                   void* o, int B, int Hq, int Hkv, int Sq, int Sk, int hd,
                   int causal, cudaStream_t stream) {
  using L = FlashSmem<T, HD>;
  auto kern = flash_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::BYTES));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((Sq + BQ - 1) / BQ),
                  static_cast<unsigned>(B * Hq));
  kern<<<grid, kThreads, L::BYTES, stream>>>(
      static_cast<const T*>(q), sqb, sqs, sqh, static_cast<const T*>(k), skb,
      sks, skh, static_cast<const T*>(v), svb, svs, svh, static_cast<T*>(o),
      Hq, Hkv, Sq, Sk, hd, causal, sqrtf(static_cast<float>(hd)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, long long sqb, long long sqs,
                     long long sqh, const void* k, long long skb,
                     long long sks, long long skh, const void* v,
                     long long svb, long long svs, long long svh, void* o,
                     int B, int Hq, int Hkv, int Sq, int Sk, int hd,
                     int causal, cudaStream_t st) {
  if (hd <= 64)
    return launch<T, 64>(q, sqb, sqs, sqh, k, skb, sks, skh, v, svb, svs, svh,
                         o, B, Hq, Hkv, Sq, Sk, hd, causal, st);
  return launch<T, 128>(q, sqb, sqs, sqh, k, skb, sks, skh, v, svb, svs, svh,
                        o, B, Hq, Hkv, Sq, Sk, hd, causal, st);
}

}  // namespace

// q: (B, Sq, Hq, hd) through strides (sqb, sqs, sqh, 1); k/v: (B, Sk, Hkv,
// hd) through theirs; o: (B, Sq, Hq, hd) contiguous. hd <= 128, Hq a
// multiple of Hkv. causal compares positions from 0 of queries and keys.
// dtype 0 = fp32, 1 = bf16. Returns the launch's CUDA error.
extern "C" int repro_flash_attention(const void* q, long long sqb,
                                     long long sqs, long long sqh,
                                     const void* k, long long skb,
                                     long long sks, long long skh,
                                     const void* v, long long svb,
                                     long long svs, long long svh, void* o,
                                     int B, int Hq, int Hkv, int Sq, int Sk,
                                     int hd, int causal, int dtype,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, sqb, sqs, sqh, k, skb, sks, skh, v, svb,
                                   svs, svh, o, B, Hq, Hkv, Sq, Sk, hd, causal,
                                   st);
  return dispatch<float>(q, sqb, sqs, sqh, k, skb, sks, skh, v, svb, svs, svh,
                         o, B, Hq, Hkv, Sq, Sk, hd, causal, st);
}

// The attributes of every kernel instance this file launches (attrs.cuh).
extern "C" int repro_attrs_flash_attention(int i, int* out, char* label, int cap) {
  switch (i) {
    case 0:
      return repro_attrs::query(&flash_kernel<float, 64>,
                                 "flash_attention[general]|float32|HD 64", out,
                                 label, cap);
    case 1:
      return repro_attrs::query(&flash_kernel<float, 128>,
                                 "flash_attention[general]|float32|HD 128", out,
                                 label, cap);
    case 2:
      return repro_attrs::query(&flash_kernel<__nv_bfloat16, 64>,
                                 "flash_attention[general]|bfloat16|HD 64", out,
                                 label, cap);
    case 3:
      return repro_attrs::query(&flash_kernel<__nv_bfloat16, 128>,
                                 "flash_attention[general]|bfloat16|HD 128", out,
                                 label, cap);
    default:
      return -1;
  }
}
