// Mamba-2 SSD (state-space duality) forward: y, from a zero or a given
// initial state, and optionally the final state.
//
// Replaces: src/repro/kernels/ssd.py::ssd_forward (zero state, y only), the
// __fusable__ssd region of repro/models/ssm.py::ssm_forward, which the port
// reaches through models/ssm.ssm_forward: the training forward (h0 = None,
// y only) and the serving chunks (h0 = the cached state, h_final kept:
// repro/models/ssm.py:180-188, ssd_chunked's h0 and scan carry).
//
// What bounds it on an H100: at the mamba2-780m train shape (B 4, S 2048,
// nh 48, hd 64, d_state 128, bf16 x/B/C) the products, all fp32 as the TPU
// kernel computes them: per (batch, head, chunk of 64) the (Q, Q) . (Q, hd)
// intra-chunk product and the two (Q, ds) . (ds, hd) state products, with
// C . B^T shared by the heads, about 16 GFLOP, about 0.24 ms at 67 TFLOP/s
// fp32; the bytes (x, dt, B, C read once, y written once, about 105 MB) take
// about 31 us. A state read and written adds 2 x 4 x nh x ds x hd bytes
// per batch row (1.5 MB each way at mamba2-780m's width).
//
// Design. The TPU kernel's grid (B * nh, NC) runs the chunks in order and
// carries the state h (ds, hd) in VMEM. Here one block per (b, head) loops
// over the chunks itself and keeps h in fp32 in shared memory
// (128 x 64 x 4 = 32 KB). At the model's chunk of 256 the (Q, Q) tiles
// alone would be 256 KB in fp32, more than a block's shared memory, so the
// kernel runs its own chunk of 64 (the result is chunk-invariant up to
// rounding; repro/kernels/ops.py's default is 64 too). Per chunk:
//   load x, dt, B, C        (zero-filled past S, d_state and head_dim: a
//                            zero dt is an identity step)
//   xd = x * dt, cum = cumsum(dt * A)
//   M = (C . B^T) * exp(cum_i - cum_j) on the causal triangle
//   y = M . xd + exp(cum) * (C . h) + D * x          -> written once
//   h = h * exp(total) + (B * exp(total - cum))^T . xd
// h starts from h0 (B, nh, ds, hd) fp32 when given, else from zeros, and is
// written to h_final (the same layout) after the last chunk when asked. A
// ragged tail's zero dt keeps h, so h_final is the state after step S - 1.
// B and C are shared by all heads (one group) and are read as (B, S, ds)
// through the index, with no per-head broadcast. Every product is fp32 FMAs
// in registers over shared-memory tiles (fma_tile in common.cuh).
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kQ = 64;     // the kernel's chunk
constexpr int kDS = 128;   // d_state held in shared memory
constexpr int kHD = 64;    // head_dim held in shared memory

struct SsdSmem {
  static constexpr int LDH = kHD;        // state h (kDS x kHD)
  static constexpr int LDX = kHD;        // x and xd (kQ x kHD)
  static constexpr int LDB = kDS + 1;    // B and C (kQ x kDS); odd, so a
                                         // warp's column reads spread banks
  static constexpr int LDM = kQ + 1;     // (C . B^T) * L (kQ x kQ)
  static constexpr size_t H = 0;
  static constexpr size_t X = H + align128(sizeof(float) * kDS * LDH);
  static constexpr size_t XD = X + align128(sizeof(float) * kQ * LDX);
  static constexpr size_t B = XD + align128(sizeof(float) * kQ * LDX);
  static constexpr size_t C = B + align128(sizeof(float) * kQ * LDB);
  static constexpr size_t M = C + align128(sizeof(float) * kQ * LDB);
  static constexpr size_t DT = M + align128(sizeof(float) * kQ * LDM);
  static constexpr size_t CUM = DT + align128(sizeof(float) * kQ);
  static constexpr size_t BYTES = CUM + align128(sizeof(float) * kQ);
};

template <typename TX, typename TB>
__global__ void __launch_bounds__(kThreads)
    ssd_kernel(const TX* __restrict__ x, long long sxb, long long sxs,
               long long sxh, const float* __restrict__ dt, long long sdb,
               long long sds, long long sdh, const float* __restrict__ A,
               const TB* __restrict__ Bm, long long sbb, long long sbs,
               const TB* __restrict__ Cm, long long scb, long long scs,
               const float* __restrict__ D, TX* __restrict__ y,
               const float* __restrict__ h0, float* __restrict__ hf, int S,
               int nh, int hd, int ds) {
  using L = SsdSmem;
  extern __shared__ __align__(128) unsigned char smem[];
  float* hs = reinterpret_cast<float*>(smem + L::H);
  float* xs = reinterpret_cast<float*>(smem + L::X);
  float* xds = reinterpret_cast<float*>(smem + L::XD);
  float* bs = reinterpret_cast<float*>(smem + L::B);
  float* cs = reinterpret_cast<float*>(smem + L::C);
  float* ms = reinterpret_cast<float*>(smem + L::M);
  float* dts = reinterpret_cast<float*>(smem + L::DT);
  float* cum = reinterpret_cast<float*>(smem + L::CUM);

  const long long b = blockIdx.x / nh;
  const int h = blockIdx.x % nh;
  const float a = A[h], d_skip = D[h];
  const TX* xb = x + b * sxb + h * sxh;
  const float* dtb = dt + b * sdb + h * sdh;
  const TB* bb = Bm + b * sbb;
  const TB* cb = Cm + b * scb;
  const long long ys = static_cast<long long>(nh) * hd;   // y's row stride
  TX* yb = y + (b * S * nh + h) * static_cast<long long>(hd);
  const int cg = threadIdx.x % 16, rg = threadIdx.x / 16;

  const long long hoff = (b * nh + h) * static_cast<long long>(ds) * hd;
  for (int i = threadIdx.x; i < kDS * L::LDH; i += kThreads) {
    const int r = i / L::LDH, c = i % L::LDH;
    hs[i] = (h0 != nullptr && r < ds && c < hd) ? h0[hoff + r * hd + c] : 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += kQ) {
    const int n = min(kQ, S - t0);
    for (int i = threadIdx.x; i < kQ * kHD; i += kThreads) {
      const int r = i / kHD, c = i % kHD;
      xs[r * L::LDX + c] =
          (r < n && c < hd) ? to_f(xb[(t0 + r) * sxs + c]) : 0.f;
    }
    for (int i = threadIdx.x; i < kQ * kDS; i += kThreads) {
      const int r = i / kDS, c = i % kDS;
      const bool ok = r < n && c < ds;
      bs[r * L::LDB + c] = ok ? to_f(bb[(t0 + r) * sbs + c]) : 0.f;
      cs[r * L::LDB + c] = ok ? to_f(cb[(t0 + r) * scs + c]) : 0.f;
    }
    for (int r = threadIdx.x; r < kQ; r += kThreads)
      dts[r] = r < n ? dtb[(t0 + r) * sds] : 0.f;
    __syncthreads();
    for (int i = threadIdx.x; i < kQ * kHD; i += kThreads)
      xds[i] = xs[i] * dts[i / kHD];
    if (threadIdx.x == 0) {
      // the rounded product, then the sum, in order: the plain version's
      // dt * A and cumsum. A fused multiply-add here would move cum by an
      // ulp per step, and exp(cum_i - cum_j) amplifies that on the long
      // decays of a chunk (y of tens: errors past 1e-4 in fp32).
      float c = 0.f;
      for (int r = 0; r < kQ; ++r) {
        c = __fadd_rn(c, __fmul_rn(dts[r], a));
        cum[r] = c;
      }
    }
    __syncthreads();

    {  // M = (C . B^T) * L, L[i, j] = exp(cum_i - cum_j) for i >= j
      float acc[4][4] = {};
      fma_tile<4, 4, 16>(acc, cs, L::LDB, 1, bs, 1, L::LDB, kDS);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = rg + 16 * i, c = cg + 16 * j;
          ms[r * L::LDM + c] =
              r >= c ? acc[i][j] * expf(cum[r] - cum[c]) : 0.f;
        }
    }
    __syncthreads();

    {  // y = M . xd + exp(cum) * (C . h) + D * x
      float yi[4][4] = {}, yh[4][4] = {};
      fma_tile<4, 4, 16>(yi, ms, L::LDM, 1, xds, L::LDX, 1, kQ);
      fma_tile<4, 4, 16>(yh, cs, L::LDB, 1, hs, L::LDH, 1, kDS);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg + 16 * i;
        if (r >= n) continue;
        const float e = expf(cum[r]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = cg + 16 * j;
          if (c < hd)
            yb[(t0 + r) * ys + c] = from_f<TX>(
                yi[i][j] + e * yh[i][j] + d_skip * xs[r * L::LDX + c]);
        }
      }
    }
    __syncthreads();

    const float total = cum[kQ - 1];   // dt = 0 past S keeps cum flat
    for (int i = threadIdx.x; i < kQ * kDS; i += kThreads) {
      const int r = i / kDS, c = i % kDS;
      bs[r * L::LDB + c] *= expf(total - cum[r]);
    }
    __syncthreads();

    {  // h = h * exp(total) + (B * decay_to_end)^T . xd
      float acc[8][4] = {};
      fma_tile<8, 4, 16>(acc, bs, 1, L::LDB, xds, L::LDX, 1, kQ);
      const float dec = expf(total);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* hp = hs + (rg + 16 * i) * L::LDH + cg + 16 * j;
          *hp = *hp * dec + acc[i][j];
        }
    }
    __syncthreads();
  }
  if (hf != nullptr)
    for (int i = threadIdx.x; i < ds * hd; i += kThreads)
      hf[hoff + i] = hs[(i / hd) * L::LDH + i % hd];
}

template <typename TX, typename TB>
cudaError_t launch(const void* x, long long sxb, long long sxs, long long sxh,
                   const void* dt, long long sdb, long long sds,
                   long long sdh, const void* A, const void* Bm,
                   long long sbb, long long sbs, const void* Cm,
                   long long scb, long long scs, const void* D, void* y,
                   const void* h0, void* hf, int B, int S, int nh, int hd,
                   int ds, cudaStream_t stream) {
  auto kern = ssd_kernel<TX, TB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SsdSmem::BYTES));
  if (err != cudaSuccess) return err;
  kern<<<static_cast<unsigned>(B * nh), kThreads, SsdSmem::BYTES, stream>>>(
      static_cast<const TX*>(x), sxb, sxs, sxh, static_cast<const float*>(dt),
      sdb, sds, sdh, static_cast<const float*>(A),
      static_cast<const TB*>(Bm), sbb, sbs, static_cast<const TB*>(Cm), scb,
      scs, static_cast<const float*>(D), static_cast<TX*>(y),
      static_cast<const float*>(h0), static_cast<float*>(hf), S, nh, hd, ds);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t dispatch_bc(const void* x, long long sxb, long long sxs,
                        long long sxh, const void* dt, long long sdb,
                        long long sds, long long sdh, const void* A,
                        const void* Bm, long long sbb, long long sbs,
                        const void* Cm, long long scb, long long scs,
                        const void* D, void* y, const void* h0, void* hf,
                        int B, int S, int nh, int hd, int ds, int bcdtype,
                        cudaStream_t st) {
  if (bcdtype == 1)
    return launch<TX, __nv_bfloat16>(x, sxb, sxs, sxh, dt, sdb, sds, sdh, A,
                                     Bm, sbb, sbs, Cm, scb, scs, D, y, h0, hf,
                                     B, S, nh, hd, ds, st);
  return launch<TX, float>(x, sxb, sxs, sxh, dt, sdb, sds, sdh, A, Bm, sbb,
                           sbs, Cm, scb, scs, D, y, h0, hf, B, S, nh, hd, ds,
                           st);
}

}  // namespace

// x: (B, S, nh, hd) through strides (sxb, sxs, sxh, 1); dt: (B, S, nh) fp32
// through (sdb, sds, sdh); A, D: (nh,) fp32; Bm/Cm: (B, S, ds) through
// (sbb, sbs, 1) / (scb, scs, 1); y: (B, S, nh, hd) contiguous; h0 (or
// null: a zero state) and hf (or null: not written): (B, nh, ds, hd) fp32
// contiguous. ds <= 128, hd <= 64. xdtype / bcdtype: 0 = fp32, 1 = bf16
// (x; B and C). Returns the launch's CUDA error.
extern "C" int repro_ssd_forward(const void* x, long long sxb, long long sxs,
                                 long long sxh, const void* dt, long long sdb,
                                 long long sds, long long sdh, const void* A,
                                 const void* Bm, long long sbb, long long sbs,
                                 const void* Cm, long long scb, long long scs,
                                 const void* D, void* y, const void* h0,
                                 void* hf, int B, int S, int nh, int hd,
                                 int ds, int xdtype, int bcdtype,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (xdtype == 1)
    return dispatch_bc<__nv_bfloat16>(x, sxb, sxs, sxh, dt, sdb, sds, sdh, A,
                                      Bm, sbb, sbs, Cm, scb, scs, D, y, h0,
                                      hf, B, S, nh, hd, ds, bcdtype, st);
  return dispatch_bc<float>(x, sxb, sxs, sxh, dt, sdb, sds, sdh, A, Bm, sbb,
                            sbs, Cm, scb, scs, D, y, h0, hf, B, S, nh, hd,
                            ds, bcdtype, st);
}
