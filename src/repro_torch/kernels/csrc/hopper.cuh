// Hopper building blocks of the port's wgmma kernels (fused_mlp_hopper.cu,
// fused_mlp_dgrad_hopper.cu, fused_mlp_wgrad_hopper.cu,
// flash_attention_hopper.cu): an mbarrier-driven ring of shared-memory
// stages fed by TMA, the 3-d and 4-d tensor maps TMA reads through, the
// 128-byte swizzled layout that wgmma reads, its matrix descriptors, and
// wgmma.mma_async (bf16 in, fp32 sums) at m64n64k16, m64n128k16 and
// m64n256k16 with A in shared memory, and at m64n64k16 and m64n128k16
// with A in registers.
//
// Why TMA and not cp.async. Both were built, and on an H100 the cp.async
// version of each kernel was the slower one at every main-path shape:
// a producer warpgroup spends an instruction stream on every 16-byte chunk
// (address, predicate, copy) and keeps few bytes in flight. A TMA copy is
// one instruction from one thread for a whole 64 x 64 panel, swizzled and
// zero-filled past the tensor's edges by the hardware, so a ragged M
// tile, an f or N tail and a column block of w_down (its own row stride)
// cost nothing extra. Its price is a tensor map per (pointer, shape,
// strides), encoded on the host by cuTensorMapEncodeTiled; serving decode
// is host-bound, so tensor_map() caches the maps, and a call whose
// operands were seen before encodes nothing. TMA asks for 16-byte aligned
// bases and strides; the wrapper sends other calls to the general kernels.
//
// Layout. A tile of ROWS x COLS bf16 is stored as COLS / 64 panels; panel
// p holds columns [64p, 64p + 64) as ROWS rows of 128 bytes, and 16-byte
// chunk c of row r sits at chunk c ^ (r % 8) (the 128-byte swizzle, the
// same function of the address bits that wgmma applies; every panel
// starts 1024-byte aligned). The same store serves both majors:
//   K-major operand (rows = M or N, columns = K): 8-row groups 1024 B
//     apart (SBO); the k16 step moves the start address by 32 B inside
//     the swizzled row;
//   MN-major operand (rows = K, columns = M or N): 8-row groups of K
//     1024 B apart (SBO), panels of 64 M/N columns ROWS * 128 B apart
//     (LBO); the k16 step moves the start address by 2048 B.
// wgmma's transpose bits (for 16-bit types only) say which: 0 K-major,
// 1 MN-major.
//
// Accumulator fragment of m64nNk16 (fp32): thread t of the warpgroup holds
// d[i], i < N / 2, at row 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2)
// and column 8 * (i / 4) + 2 * (t % 4) + i % 2. A register A operand of
// m64nNk16 (bf16) is four 32-bit registers a[j], each two bf16 of
// consecutive columns, at the rows and columns of d[2j], d[2j + 1] of a
// 64 x 16 accumulator: so accumulator elements 8k .. 8k + 7, rounded to
// bf16 in pairs, are the A operand of the k16 step over columns
// [16k, 16k + 16).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace repro {
namespace hopper {

constexpr int kWarpgroup = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

// Wait until the phase of parity `parity` has completed (a fresh barrier
// counts its phase of parity 1 as completed).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- registers ---------------------------------------------------------------

// a warpgroup's registers per thread, lowered (producers) or raised
// (consumers); the kernel's warpgroups take these in one if/else that never
// joins again, or the compiler ignores them
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- proxies and barriers -------------------------------------------------

// generic-proxy shared-memory writes (by threads) before reads by
// wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier among `n` threads (whole warps) on hardware barrier `id` (0 is
// __syncthreads')
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---- TMA --------------------------------------------------------------------

// one arrival that also announces `bytes` of TMA data for the phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// The box at (c0, c1, c2) of a 3-d tensor map into shared memory at dst,
// counted on the mbarrier at bar. Out-of-bounds elements are zero-filled
// (and counted).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// the same for the box at (c0, c1, c2, c3) of a 4-d tensor map
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// Host: the tensor map of a 3-d or 4-d bf16 tensor (dims[0] innermost;
// strides[i] in elements between steps of dims[i + 1], multiples of 8;
// base 16-byte aligned) for boxes of 64 x `rows` (x 1 x 1) in the 128-byte
// swizzle, i.e. one panel of the layout above. cuTensorMapEncodeTiled is
// looked up through the runtime's entry-point query, so the library links
// without -lcuda. Maps are cached by (pointer, rank, shape, strides, rows):
// a call with operands seen before encodes nothing.
struct MapKey {
  const void* p;
  int rank, rows;
  long long dims[4], strides[3];
  bool operator==(const MapKey& o) const {
    if (p != o.p || rank != o.rank || rows != o.rows) return false;
    for (int i = 0; i < rank; ++i)
      if (dims[i] != o.dims[i] || (i > 0 && strides[i - 1] != o.strides[i - 1]))
        return false;
    return true;
  }
};

inline cudaError_t encode_map(CUtensorMap* out, const MapKey& key) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);
  constexpr int kCache = 64;
  static std::mutex mu;
  static MapKey keys[kCache];
  static CUtensorMap maps[kCache];
  static int used = 0, next = 0;
  static Encode encode = nullptr;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (keys[i] == key) {
      *out = maps[i];
      return cudaSuccess;
    }
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &q);
    if (err != cudaSuccess) return err;
    if (fn == nullptr || q != cudaDriverEntryPointSuccess)
      return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<Encode>(fn);
  }
  cuuint64_t dims[4], strides[3];
  for (int i = 0; i < key.rank; ++i) {
    dims[i] = static_cast<cuuint64_t>(key.dims[i]);
    if (i > 0) strides[i - 1] = static_cast<cuuint64_t>(key.strides[i - 1]) * 2;
  }
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(key.rows), 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  CUtensorMap m;
  if (encode(&m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             static_cast<cuuint32_t>(key.rank), const_cast<void*>(key.p),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const int slot = used < kCache ? used++ : (next++ % kCache);
  keys[slot] = key;
  maps[slot] = m;
  *out = m;
  return cudaSuccess;
}

// (n0, n1, n2) with strides s1, s2
inline cudaError_t tensor_map(CUtensorMap* out, const void* p, long long n0,
                              long long n1, long long n2, long long s1,
                              long long s2, int rows = 64) {
  return encode_map(out, MapKey{p, 3, rows, {n0, n1, n2, 1}, {s1, s2, 0}});
}

// (n0, n1, n2, n3) with strides s1, s2, s3
inline cudaError_t tensor_map(CUtensorMap* out, const void* p, long long n0,
                              long long n1, long long n2, long long n3,
                              long long s1, long long s2, long long s3,
                              int rows) {
  return encode_map(out, MapKey{p, 4, rows, {n0, n1, n2, n3}, {s1, s2, s3}});
}

// ---- the ring ---------------------------------------------------------------

// A ring of n shared-memory stages of `slot` bytes at `base`, with a "full"
// and an "empty" mbarrier per stage at `bars` (full[i] at bars + 8i,
// empty[i] at bars + 8 (kMaxStages + i)). Producer and consumers each keep
// a copy and walk the same sequence of stages:
//   producer (one thread): acquire() (the stage is free), mbar_expect_tx
//     on full() with the stage's bytes, the TMA copies, next();
//   consumers: wait() (the stage has landed), wgmma on slot(), then an
//     arrival on the stage's empty barrier once its wgmmas have finished.
constexpr int kMaxStages = 8;

struct Ring {
  uint32_t base, slot_bytes, bars;
  int n;
  int st = 0;
  uint32_t ph = 0;

  __device__ uint32_t slot() const { return base + st * slot_bytes; }
  __device__ uint32_t full() const { return bars + 8 * st; }
  __device__ uint32_t empty() const { return bars + 8 * (kMaxStages + st); }
  __device__ void next() {
    if (++st == n) {
      st = 0;
      ph ^= 1;
    }
  }
  // one thread, then a block barrier: the producer's expect_tx fills a
  // stage (with the bytes), `consumers` threads release it
  __device__ void init(int consumers) const {
    for (int i = 0; i < n; ++i) {
      mbar_init(bars + 8 * i, 1);
      mbar_init(bars + 8 * (kMaxStages + i), consumers);
    }
    mbar_fence_init();
  }
  __device__ void acquire() const { mbar_wait(empty(), ph ^ 1); }
  // TMA (the async proxy) filled the stage and wgmma reads it: no fence
  __device__ void wait() const { mbar_wait(full(), ph); }
};

constexpr int kBarBytes = 2 * kMaxStages * 8;

// ---- the swizzled layout ---------------------------------------------------

// byte offset of 16-byte chunk c (0..7) of row r in a panel of 128-byte rows
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

// ---- wgmma -----------------------------------------------------------------

// Matrix descriptor of a 128-byte swizzled operand at shared address addr:
// LBO (bytes) between 64-column panels (MN-major; 16 for K-major, where it
// is unused), SBO 1024 bytes between 8-row groups.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return desc(addr, 16);
}

__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t panel) {
  return desc(addr, panel);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator accesses across an
// asynchronous wgmma
template <int NR>
__device__ __forceinline__ void fence_regs(float (&d)[NR]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int NR>
__device__ __forceinline__ void zero(float (&d)[NR]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) d[i] = 0.f;
}

// d (64 x N, fp32) += A (64 x 16) . B (16 x N), both bf16 in shared memory
// behind the descriptors; TA / TB: 0 K-major, 1 MN-major. accumulate == 0
// overwrites d.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,\n"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,\n"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,\n"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,\n"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,\n"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,\n"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,\n"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,\n"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,\n"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,\n"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,\n"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// d (64 x N, fp32) += A (64 x 16, bf16, four registers a[0..3] of this
// thread, see the note) . B (16 x N, bf16 in shared memory behind the
// descriptor); TB: 0 K-major, 1 MN-major. The hardware reads a[] after the
// instruction issues: keep them live (fence_regs) until wgmma_wait.
template <int TB>
__device__ __forceinline__ void wgmma_m64n64_ra(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,\n"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_m64n128_ra(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,\n"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,\n"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,\n"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate),
        "n"(TB));
}

template <int NR>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[NR]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// row and column of accumulator element i of this thread (see the note)
__device__ __forceinline__ int frag_row(int i) {
  const int t = threadIdx.x % kWarpgroup;
  return 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2);
}

__device__ __forceinline__ int frag_col(int i) {
  return 8 * (i / 4) + 2 * (threadIdx.x % 4) + i % 2;
}

}  // namespace hopper
}  // namespace repro
