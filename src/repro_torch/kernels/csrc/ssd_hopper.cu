// Mamba-2 SSD forward on the tensor cores (bf16 x, B and C): y from a zero
// or a given initial state, and optionally the final state.
//
// Replaces: src/repro/kernels/ssd.py::ssd_forward (the chunked SSD scan),
// with the port's state form (h0 in, h_final out) that the serving chunks
// use; the plain versions are kernels/ref.ssd_chunked_ref and ssd_state_ref.
// csrc/ssd.cu stays the general path (fp32 operands, other widths).
//
// What bounds it on an H100: at the mamba2-780m train shape (B 4, S 2048,
// nh 48, hd 64, d_state 128) the bytes are about 105 MB (31 us at 3.35
// TB/s); the products, done as below, are about 40 GFLOP of bf16 tensor-core
// work (41 us at 989 TFLOP/s). The general kernel runs one block per
// (batch, head), 192 blocks of 147 KB on 132 SMs, walks 32 chunks with six
// barriers each, and does every product in fp32 FMAs.
//
// Design. The head dim's columns are independent: y[..., c] and h[:, c]
// depend on x[..., c] alone, while C.B^T, the decays and cum are shared. So
// one block of four warps owns a (batch, head, slab of kP = 32
// columns) triple and walks its chunks of Q = 64 in order, with its slice of
// the state (ds x kP fp32) in registers: no chunk state goes through device
// memory and no block waits on another; the mamba2 train shape has 384
// blocks. B and C are read by every head and slab of a batch row
// and come from L2. Per chunk:
//   the chunk landed (cp.async; chunk c+1's B, x slab and dt, in a second
//   stage, are in flight while chunk c computes, and its C from the
//   chunk's second barrier on; rows past S zero-filled);
//   one warp runs the cumsum of dt * A in the plain version's order (a
//   rounded product, then a sequential fp32 sum: exp(cum_i - cum_j)
//   amplifies an ulp moved by a reordered scan) while the warps compute
//   C.h_prev and C.B^T for their 16 rows on the tensor cores;
//   a barrier; M = C.B^T * exp(cum_i - cum_j) * dt_j on i >= j, in the
//   registers that hold C.B^T (the m16n8 accumulator of two column tiles is
//   the A operand of one k16 step), then y = M.x + exp(cum) * C.h_prev +
//   D * x, written once;
//   h = h * exp(total) + B^T.(exp(total - cum) * (x * dt)), into registers,
//   and its bf16 terms to shared memory for the next chunk's C.h.
// The rows a warp owns alternate by chunk (w, then 3 - w), so the causal
// triangle's heavy rows do not always land on one SM sub-partition.
//
// Precision: one exact bf16 operand per product. x, B and C are bf16 and go
// in as they are; every fp32 factor (dt, the decays, L, h) is on the other
// operand, split into kTerms bf16 terms (hi = bf16(v), lo = bf16(v - hi)),
// and the products are summed in fp32. Two terms carry 16 of fp32's 24 bits
// (they leave at most 2^-18 of the operand): far under y's bf16 rounding
// (2^-9), so the kernel's rule against the fp64 oracle over 8 draws
// (kernels/ssd.py ORACLE_*: y's max error within 2x the general kernel's,
// its rel L2 within 1.1x; h_final's rel L2 within 2^-16) holds with them.
// One term puts an error of y's own rounding size into every product: its
// emulation (ref.ssd_split_ref) gives y about 1.4x the general kernel's rel
// L2 and h_final about 2^-9, and fails the rule. So two, the fewest. C.B^T
// is exact bf16 products summed in fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include "attrs.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kQ = 64;        // the chunk (kernels/ssd.py CHUNK)
constexpr int kWarps = 4;     // one per 16 rows of the chunk
constexpr int kBlock = kWarps * 32;
constexpr int kMaxKs = 8;     // d_state up to 128: k16 steps over the state
constexpr int kTerms = 2;     // bf16 terms of each fp32 operand
constexpr int kP = 32;        // the slab: head_dim columns per block
static_assert(kQ == 64, "the cumsum's two shuffle rounds");

// Shared memory, in bytes from the start (every offset 128-byte aligned):
// C (kQ x ds, rows padded by 16 bytes so ldmatrix reads eight rows without
// bank conflicts; one buffer: it is read before the chunk's second barrier
// and refilled after it), two stages of {B (as C), x (kQ x kP, padded), dt
// (kQ)}, the state's bf16 terms (ds x kP each, padded), cum, the decays to
// the chunk's end and exp(cum).
struct Layout {
  int lds, ldx;                 // row strides in elements
  int b, x, dt, stage;          // within a stage
  int c, s0, h, cum, dec, ecum, bytes;
};

__host__ __device__ constexpr int al128(int b) { return (b + 127) / 128 * 128; }

__host__ __device__ inline Layout layout(int ds) {
  Layout L{};
  L.lds = ds + 8;
  L.ldx = kP + 8;
  L.b = 0;
  L.x = al128(kQ * L.lds * 2);
  L.dt = L.x + al128(kQ * L.ldx * 2);
  L.stage = L.dt + al128(kQ * 4);
  L.c = 0;
  L.s0 = al128(kQ * L.lds * 2);
  L.h = L.s0 + 2 * L.stage;
  L.cum = L.h + kTerms * al128(ds * L.ldx * 2);
  L.dec = L.cum + al128(kQ * 4);
  L.ecum = L.dec + al128(kQ * 4);
  L.bytes = L.ecum + al128(kQ * 4);
  return L;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, zero-filled when !ok (src is then not
// read)
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16 x 8, fp32) += a (16 x 16, bf16) . b (16 x 8, bf16)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// the kTerms bf16 terms of the pair (u, v) (u in the low half): term i is
// bf16 of what the terms before it left; each remainder is exact in fp32
__device__ __forceinline__ void split(float u, float v,
                                      uint32_t (&t)[kTerms]) {
#pragma unroll
  for (int i = 0; i < kTerms; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(u, v);
    t[i] = bits(p);
    u = __fsub_rn(u, __low2float(p));
    v = __fsub_rn(v, __high2float(p));
  }
}

__global__ void __launch_bounds__(kBlock)
    ssd_hopper_kernel(const bf16* __restrict__ x, long long sxb,
                      long long sxs, long long sxh,
                      const float* __restrict__ dt, long long sdb,
                      long long sds, long long sdh,
                      const float* __restrict__ A,
                      const bf16* __restrict__ Bm, long long sbb,
                      long long sbs, const bf16* __restrict__ Cm,
                      long long scb, long long scs,
                      const float* __restrict__ D, bf16* __restrict__ y,
                      const float* __restrict__ h0, float* __restrict__ hf,
                      int S, int nh, int hd, int ds) {
  constexpr int NP = kP / 8;    // n8 tiles of the slab
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(ds);
  const uint32_t sbase = smem_u32(smem);
  float* cum = reinterpret_cast<float*>(smem + L.cum);
  float* dec = reinterpret_cast<float*>(smem + L.dec);
  float* ecum = reinterpret_cast<float*>(smem + L.ecum);

  const int slabs = hd / kP;
  const int p0 = (blockIdx.x % slabs) * kP;
  const int h = (blockIdx.x / slabs) % nh;
  const long long b = blockIdx.x / (slabs * nh);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;     // fragment row, column pair
  const int nks = ds / 16;
  const float a = A[h], dskip = D[h];
  const bf16* xb = x + b * sxb + h * sxh + p0;
  const float* dtb = dt + b * sdb + h * sdh;
  const bf16* bb = Bm + b * sbb;
  const bf16* cb = Cm + b * scb;
  const long long ys = static_cast<long long>(nh) * hd;   // y's row stride
  bf16* yb = y + (b * S * nh + h) * static_cast<long long>(hd) + p0;
  const int nc = (S + kQ - 1) / kQ;

  // A (kQ x ds) tile of chunk c from a row-strided bf16 matrix into
  // shared memory at dst: this thread's 16-byte pieces are kBlock apart;
  // (r, k) advances by whole rows and pieces, no division in the loop
  const int cpr = ds / 8, rstep = kBlock / cpr, kstep = kBlock % cpr;
  auto load_rows = [&](uint32_t dst, const bf16* src, long long stride,
                       int c) {
    int r = threadIdx.x / cpr, k = threadIdx.x % cpr;
    const int t0 = c * kQ;
    for (int i = threadIdx.x; i < kQ * cpr; i += kBlock) {
      const bool ok = t0 + r < S;
      cp16(dst + (r * L.lds + 8 * k) * 2,
           src + (ok ? t0 + r : 0) * stride + 8 * k, ok);
      r += rstep;
      k += kstep;
      if (k >= cpr) {
        k -= cpr;
        ++r;
      }
    }
  };
  // chunk c's B, x slab and dt into stage st
  auto load_stage = [&](int c, int st) {
    const int t0 = c * kQ;
    const uint32_t base = sbase + L.s0 + st * L.stage;
    load_rows(base + L.b, bb, sbs, c);
    for (int i = threadIdx.x; i < kQ * NP; i += kBlock) {
      const int r = i / NP, k = i % NP;
      const bool ok = t0 + r < S;
      cp16(base + L.x + (r * L.ldx + 8 * k) * 2,
           xb + (ok ? t0 + r : 0) * sxs + 8 * k, ok);
    }
    if (threadIdx.x < kQ) {
      const int r = threadIdx.x;
      const bool ok = t0 + r < S;
      cp4(base + L.dt + 4 * r, dtb + (ok ? t0 + r : 0) * sds, ok);
    }
  };
  load_rows(sbase + L.c, cb, scs, 0);
  load_stage(0, 0);
  cp_commit();

  // the state: warp w owns the m16 tiles w and w + 4 of its ds rows, as
  // m16n8 accumulators over the slab's columns
  float hreg[2][NP][4];
  const long long hoff = (b * nh + h) * static_cast<long long>(ds) * hd + p0;
  auto store_terms = [&]() {   // h's bf16 terms, for the next C . h
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int s0 = 16 * (warp + 4 * mt);
      if (s0 >= ds) continue;
#pragma unroll
      for (int n = 0; n < NP; ++n)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t t[kTerms];
          split(hreg[mt][n][2 * half], hreg[mt][n][2 * half + 1], t);
          const int off = ((s0 + g + 8 * half) * L.ldx + 8 * n + 2 * q) * 2;
#pragma unroll
          for (int i = 0; i < kTerms; ++i)
            *reinterpret_cast<uint32_t*>(
                smem + L.h + i * al128(ds * L.ldx * 2) + off) = t[i];
        }
    }
  };
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int s0 = 16 * (warp + 4 * mt);
#pragma unroll
    for (int n = 0; n < NP; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float2 v = make_float2(0.f, 0.f);
        if (h0 != nullptr && s0 < ds)
          v = *reinterpret_cast<const float2*>(
              h0 + hoff + (s0 + g + 8 * half) * static_cast<long long>(hd) +
              8 * n + 2 * q);
        hreg[mt][n][2 * half] = v.x;
        hreg[mt][n][2 * half + 1] = v.y;
      }
  }
  store_terms();

  for (int c = 0; c < nc; ++c) {
    const int st = c & 1;
    cp_wait_all();
    __syncthreads();   // chunk c landed; chunk c - 1 is done by every warp
    if (c + 1 < nc) {
      load_stage(c + 1, st ^ 1);
      cp_commit();
    }
    const uint32_t sC = sbase + L.c;
    const uint32_t sB = sbase + L.s0 + st * L.stage + L.b;
    const uint32_t sX = sbase + L.s0 + st * L.stage + L.x;
    const float* dts =
        reinterpret_cast<const float*>(smem + L.s0 + st * L.stage + L.dt);
    const bf16* xs =
        reinterpret_cast<const bf16*>(smem + L.s0 + st * L.stage + L.x);
    const int tile = (c & 1) ? kWarps - 1 - warp : warp;
    const int i0 = 16 * tile;

    if (tile == 0) {   // the lightest rows: this warp also runs the cumsum
      // the rounded products dt * A in parallel, then one sequential fp32
      // sum that every lane runs over the shuffled products; lane r % 32
      // keeps cum_r
      const float v0 = __fmul_rn(dts[lane], a);
      const float v1 = __fmul_rn(dts[lane + 32], a);
      float sum = 0.f, c0 = 0.f, c1 = 0.f;
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        sum = __fadd_rn(sum, __shfl_sync(0xffffffffu, v0, r));
        if (lane == r) c0 = sum;
      }
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        sum = __fadd_rn(sum, __shfl_sync(0xffffffffu, v1, r));
        if (lane == r) c1 = sum;
      }
      cum[lane] = c0;
      cum[lane + 32] = c1;
      dec[lane] = expf(sum - c0);
      dec[lane + 32] = expf(sum - c1);
      ecum[lane] = expf(c0);
      ecum[lane + 32] = expf(c1);
    }

    // C . h_prev over the slab (h's terms in shared memory) and C . B^T for
    // the columns j < i0 + 16 (the causal triangle's tiles): per k16 step
    // of the state, every fragment is loaded before the products
    float yh[NP][4] = {};
    float cbv[2 * kWarps][4] = {};
#pragma unroll
    for (int k = 0; k < kMaxKs; ++k) {
      if (k >= nks) continue;
      uint32_t ca[4], hb[kTerms][NP / 2][4], bf[kWarps][4];
      ldsm4(ca, sC + ((i0 + lane % 16) * L.lds + 16 * k + 8 * (lane / 16)) * 2);
#pragma unroll
      for (int i = 0; i < kTerms; ++i)
#pragma unroll
        for (int n = 0; n < NP; n += 2)
          ldsm4t(hb[i][n / 2], sbase + L.h + i * al128(ds * L.ldx * 2) +
                                   ((16 * k + lane % 16) * L.ldx + 8 * n +
                                    8 * (lane / 16)) * 2);
#pragma unroll
      for (int jp = 0; jp < kWarps; ++jp)
        if (jp <= tile)
          ldsm4(bf[jp], sB + ((16 * jp + lane % 8 + 8 * (lane / 16)) * L.lds +
                              16 * k + 8 * ((lane / 8) % 2)) * 2);
#pragma unroll
      for (int jp = 0; jp < kWarps; ++jp)
        if (jp <= tile) {
          mma(cbv[2 * jp], ca, bf[jp][0], bf[jp][1]);
          mma(cbv[2 * jp + 1], ca, bf[jp][2], bf[jp][3]);
        }
#pragma unroll
      for (int i = 0; i < kTerms; ++i)
#pragma unroll
        for (int n = 0; n < NP; n += 2) {
          mma(yh[n], ca, hb[i][n / 2][0], hb[i][n / 2][1]);
          mma(yh[n + 1], ca, hb[i][n / 2][2], hb[i][n / 2][3]);
        }
    }
    __syncthreads();   // cum, dec, ecum of this chunk; C read by all warps
    if (c + 1 < nc) {  // the next chunk's C into the one C buffer
      load_rows(sbase + L.c, cb, scs, c + 1);
      cp_commit();
    }

    // M = C.B^T * exp(cum_i - cum_j) * dt_j (i >= j), its terms as the A
    // operand of y_intra = M . x (for every column tile first, then the
    // products, one accumulator per term)
    const int r0 = i0 + g, r1 = r0 + 8;
    const float cr0 = cum[r0], cr1 = cum[r1];
    uint32_t at[kWarps][kTerms][4];
#pragma unroll
    for (int jp = 0; jp < kWarps; ++jp) {
      if (jp > tile) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {   // rows r0, r1
          float m[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = 16 * jp + 8 * half + 2 * q + e;
            const int r = rr ? r1 : r0;
            m[e] = r >= j ? cbv[2 * jp + half][2 * rr + e] *
                                expf((rr ? cr1 : cr0) - cum[j]) * dts[j]
                          : 0.f;
          }
          uint32_t t[kTerms];
          split(m[0], m[1], t);
#pragma unroll
          for (int i = 0; i < kTerms; ++i) at[jp][i][2 * half + rr] = t[i];
        }
    }
    float yi[kTerms][NP][4] = {};
#pragma unroll
    for (int jp = 0; jp < kWarps; ++jp) {
      if (jp > tile) continue;
      uint32_t xf[NP / 2][4];
#pragma unroll
      for (int n = 0; n < NP; n += 2)
        ldsm4t(xf[n / 2], sX + ((16 * jp + lane % 16) * L.ldx + 8 * n +
                                8 * (lane / 16)) * 2);
#pragma unroll
      for (int i = 0; i < kTerms; ++i)
#pragma unroll
        for (int n = 0; n < NP; n += 2) {
          mma(yi[i][n], at[jp][i], xf[n / 2][0], xf[n / 2][1]);
          mma(yi[i][n + 1], at[jp][i], xf[n / 2][2], xf[n / 2][3]);
        }
    }

    // y = M . x + exp(cum) * (C . h_prev) + D * x, rows past S dropped
    const int nvalid = min(kQ, S - c * kQ);
    const long long t0 = static_cast<long long>(c) * kQ;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r1 : r0;
      if (r >= nvalid) continue;
      const float e = ecum[r];
#pragma unroll
      for (int n = 0; n < NP; ++n) {
        const int col = 8 * n + 2 * q;
        const __nv_bfloat162 xv =
            *reinterpret_cast<const __nv_bfloat162*>(xs + r * L.ldx + col);
        float i0v = yi[0][n][2 * half], i1v = yi[0][n][2 * half + 1];
#pragma unroll
        for (int i = 1; i < kTerms; ++i) {
          i0v += yi[i][n][2 * half];
          i1v += yi[i][n][2 * half + 1];
        }
        const float v0 = i0v + e * yh[n][2 * half] + dskip * __low2float(xv);
        const float v1 =
            i1v + e * yh[n][2 * half + 1] + dskip * __high2float(xv);
        *reinterpret_cast<__nv_bfloat162*>(yb + (t0 + r) * ys + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }

    // h = h * exp(total) + B^T . W, W = (x * dt) * exp(total - cum): W's
    // terms as the B operand, B^T's A fragments by transposed loads
    // (x's B fragments, by the transposed loads of M . x, sit where W's
    // go)
    float sacc[2][NP][4] = {};
#pragma unroll
    for (int kj = 0; kj < kQ / 16; ++kj) {
      uint32_t xf[NP][2], ba[2][4];
#pragma unroll
      for (int n = 0; n < NP; n += 2) {
        uint32_t r4[4];
        ldsm4t(r4, sX + ((16 * kj + lane % 16) * L.ldx + 8 * n +
                         8 * (lane / 16)) * 2);
        xf[n][0] = r4[0];
        xf[n][1] = r4[1];
        xf[n + 1][0] = r4[2];
        xf[n + 1][1] = r4[3];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        if (16 * (warp + 4 * mt) < ds)
          ldsm4t(ba[mt], sB + ((16 * kj + lane % 8 + 8 * (lane / 16)) * L.lds +
                               16 * (warp + 4 * mt) + 8 * ((lane / 8) % 2)) *
                                  2);
      uint32_t wb[NP][kTerms][2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = 16 * kj + 8 * half + 2 * q;
        const float w0 = dts[j], w1 = dts[j + 1];
        const float d0 = dec[j], d1 = dec[j + 1];
#pragma unroll
        for (int n = 0; n < NP; ++n) {
          const __nv_bfloat162 xv =
              *reinterpret_cast<const __nv_bfloat162*>(&xf[n][half]);
          uint32_t t[kTerms];
          split(__fmul_rn(__fmul_rn(__low2float(xv), w0), d0),
                __fmul_rn(__fmul_rn(__high2float(xv), w1), d1), t);
#pragma unroll
          for (int i = 0; i < kTerms; ++i) wb[n][i][half] = t[i];
        }
      }
#pragma unroll
      for (int i = 0; i < kTerms; ++i)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          if (16 * (warp + 4 * mt) < ds)
#pragma unroll
            for (int n = 0; n < NP; ++n)
              mma(sacc[mt][n], ba[mt], wb[n][i][0], wb[n][i][1]);
    }
    const float etot = expf(cum[kQ - 1]);   // dt = 0 past S keeps cum flat
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int n = 0; n < NP; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          hreg[mt][n][e] = hreg[mt][n][e] * etot + sacc[mt][n][e];
    store_terms();   // read after the next chunk's first barrier
  }

  if (hf != nullptr) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int s0 = 16 * (warp + 4 * mt);
      if (s0 >= ds) continue;
#pragma unroll
      for (int n = 0; n < NP; ++n)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<float2*>(
              hf + hoff + (s0 + g + 8 * half) * static_cast<long long>(hd) +
              8 * n + 2 * q) =
              make_float2(hreg[mt][n][2 * half], hreg[mt][n][2 * half + 1]);
    }
  }
}

cudaError_t launch(const void* x, long long sxb, long long sxs, long long sxh,
                   const void* dt, long long sdb, long long sds,
                   long long sdh, const void* A, const void* Bm,
                   long long sbb, long long sbs, const void* Cm,
                   long long scb, long long scs, const void* D, void* y,
                   const void* h0, void* hf, int B, int S, int nh, int hd,
                   int ds, cudaStream_t stream) {
  auto kern = ssd_hopper_kernel;
  const int bytes = layout(ds).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(B) * nh * (hd / kP);
  kern<<<static_cast<unsigned>(blocks), kBlock, bytes, stream>>>(
      static_cast<const bf16*>(x), sxb, sxs, sxh,
      static_cast<const float*>(dt), sdb, sds, sdh,
      static_cast<const float*>(A), static_cast<const bf16*>(Bm), sbb, sbs,
      static_cast<const bf16*>(Cm), scb, scs, static_cast<const float*>(D),
      static_cast<bf16*>(y), static_cast<const float*>(h0),
      static_cast<float*>(hf), S, nh, hd, ds);
  return cudaGetLastError();
}

}  // namespace

// x: (B, S, nh, hd) bf16 through strides (sxb, sxs, sxh, 1); dt: (B, S, nh)
// fp32 through (sdb, sds, sdh); A, D: (nh,) fp32; Bm/Cm: (B, S, ds) bf16
// through (sbb, sbs, 1) / (scb, scs, 1); y: (B, S, nh, hd) bf16 contiguous;
// h0 (or null: a zero state) and hf (or null: not written): (B, nh, ds, hd)
// fp32 contiguous. x, Bm and Cm 16-byte aligned with strides that are
// multiples of 8; ds a multiple of 16 up to 128; hd a multiple of the slab
// (32). Returns the launch's CUDA error.
extern "C" int repro_ssd_forward_hopper(
    const void* x, long long sxb, long long sxs, long long sxh,
    const void* dt, long long sdb, long long sds, long long sdh,
    const void* A, const void* Bm, long long sbb, long long sbs,
    const void* Cm, long long scb, long long scs, const void* D, void* y,
    const void* h0, void* hf, int B, int S, int nh, int hd, int ds,
    void* stream) {
  if (hd % kP) return static_cast<int>(cudaErrorInvalidValue);
  return launch(x, sxb, sxs, sxh, dt, sdb, sds, sdh, A, Bm, sbb, sbs, Cm,
                scb, scs, D, y, h0, hf, B, S, nh, hd, ds,
                static_cast<cudaStream_t>(stream));
}

// The attributes of every kernel instance this file launches (attrs.cuh).
extern "C" int repro_attrs_ssd_hopper(int i, int* out, char* label, int cap) {
  switch (i) {
    case 0:
      return repro_attrs::query(&ssd_hopper_kernel,
                                 "ssd_forward[mma]|bfloat16|", out,
                                 label, cap);
    default:
      return -1;
  }
}
