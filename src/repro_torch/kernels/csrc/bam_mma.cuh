// Hopper tile helpers for the port's BAM kernels, written as inline PTX
// for sm_90a (no library headers): 16-byte cp.async copies of bf16 tiles
// into shared memory in the 128-byte swizzle, the wgmma shared-memory
// descriptors that name that layout, the warpgroup's fence / commit /
// wait, the two wgmma shapes the BAM kernels issue (K1's S and P·V, K2's
// S, dP and dS·K, K3's S^T, dP^T, P^T·dO and dS^T·Q), the conversion of
// an f32 accumulator fragment into bf16 A-operand registers split into a
// high and a low part, and exp2.
//
// Tile layout. A [ROWS][HD] bf16 tile (one row per q or key, hd
// contiguous) is stored as HP / 64 column blocks of 64 elements (128
// bytes a row), each [ROWS][64], where HP = padded_hd(HD): HD itself at
// 64, 128 and 256, and 128 at HD 80, whose block 0 is full and block 1
// holds 16 real columns (chunks 8 and 9) and 48 zeros (chunks 10-15,
// written by cp.async with no global read). Inside a block, 16-byte
// chunk c of row r sits at chunk c ^ (r % 8) of its 128-byte row. That is
// the 128-byte swizzle, applied by the hardware on address bits [4, 7)
// xor [7, 10), so every block starts on a 1024-byte boundary. The same
// bytes serve as a K-major operand (the reduction runs over hd: Q and K
// in K1's S, Q, dO, K and V in K2's S and dP, K, V, Q and dO in K3's
// S^T and dP^T; HD / 16 k16 steps, 5 at HD 80, since the zero tail adds
// nothing) and as an MN-major one (the reduction runs over the tile's
// rows, N = HP, or a 128-column half of it: V in K1's P·V, K in K2's
// dS·K, dO and Q in K3's P^T·dO and dS^T·Q; the padded columns of the
// result are never stored).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// The (type, head size) pairs that kernel KERNEL (1, 2 or 3: K1, K2,
// K3) runs on its wgmma body: bf16 at hd 64, 80, 128 and 256 for K1 and
// K3, bf16 at 64 and 128 for K2. Every other pair their entry points
// take (f32 at every size; K2 in bf16 at 80 and 256) runs the SIMT
// body: f32 FMAs out of padded shared memory.
template <int KERNEL, typename T, int HD>
constexpr bool wgmma_body() {
  return std::is_same<T, __nv_bfloat16>::value &&
         (HD == 64 || HD == 128 ||
          (KERNEL != 2 && (HD == 80 || HD == 256)));
}

// the head size of the shared-memory layout above: 80 pads to 128
__host__ __device__ constexpr int padded_hd(int hd) {
  return hd == 80 ? 128 : hd;
}

// The shared memory one block may take on an H100 (227 KB)
constexpr size_t MAX_BLOCK_SMEM = 232448;

// 2^x, flushing results below 2^-126 to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
// (src need not be a valid address then)
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// waits until at most N of this thread's committed cp.async groups are
// still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// orders this thread's generic-proxy writes to shared memory (cp.async
// included) before later reads of the same bytes by wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// byte offset of 16-byte chunk c (8 elements) of row r in a swizzled
// [ROWS][HD] tile
template <int ROWS>
__device__ __forceinline__ uint32_t sw128_offset(int r, int c) {
  return (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// Rows t0 .. t0 + ROWS of a bf16 matrix of HD columns whose row t starts
// at src + t * row_stride (elements), into the swizzled [ROWS][HP] tile
// at dst (HP = padded_hd(HD)), by NT threads; rows at or past T, and the
// padded columns HD .. HP, are written as zeros and read from nowhere.
// Thread tid always copies chunk tid % (HP / 8) of rows tid / (HP / 8) +
// NT / (HP / 8) * i.
template <int ROWS, int HD, int NT>
__device__ __forceinline__ void cp_async_tile(uint32_t dst,
                                              const __nv_bfloat16* src,
                                              int t0, int T,
                                              size_t row_stride, int tid) {
  constexpr int CPR = padded_hd(HD) / 8;   // 16-byte chunks per row
  constexpr int RPP = NT / CPR;            // rows per pass
  static_assert(NT % CPR == 0 && ROWS % RPP == 0, "tile shape");
  const int c = tid % CPR, r0 = tid / CPR;
  const bool real = CPR == HD / 8 || c < HD / 8;
  const __nv_bfloat16* g =
      src + (size_t)(t0 + r0) * row_stride + (real ? c * 8 : 0);
  const size_t pass = (size_t)RPP * row_stride;
  // with whole groups of 8 rows a pass, a chunk's swizzle is the same in
  // every pass
  constexpr bool SAME = RPP % 8 == 0;
  if constexpr (SAME) dst += sw128_offset<ROWS>(r0, c);
#pragma unroll
  for (int i = 0; i < ROWS / RPP; ++i, g += pass) {   // g past T is not read
    const int r = r0 + i * RPP;
    cp_async_16(SAME ? dst + i * RPP * 128 : dst + sw128_offset<ROWS>(r, c),
                g, real && t0 + r < T ? 16 : 0);
  }
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address,
// leading byte offset (MN-major: from one 64-element column block to the
// next; unused K-major) and stride byte offset (from one group of 8
// rows to the next), each in 16-byte units; layout type 1 in bits 62-63
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}

// desc + off, computed where it is used: the add is opaque to the
// compiler, which would otherwise hoist every k step's descriptor of a
// tile that stays put (K3's K and V) out of the loop into registers
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t off) {
  asm volatile("add.s64 %0, %0, %1;" : "+l"(desc) : "l"((uint64_t)off));
  return desc;
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

// Keeps the compiler from moving ordinary reads or writes of these
// registers across a wgmma fence, issue or wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// D[64][32] (+)= A[64][16] B[16][32], both operands in shared memory,
// both K-major; f32 accumulate. Thread t holds rows 16 (t / 32) + (t % 32)
// / 4 (+ 8) and columns 8 j + 2 (t % 4) (+ 1): d[4 j + 2 i + u] is row
// +8i, column 8 j + 2 (t % 4) + u.
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D[64][N] += A[64][16] B[16][N], A from registers (a: the A fragment of
// a k16 step, see split_a), B in shared memory MN-major (N contiguous);
// f32 accumulate, D in the layout above.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The 8 accumulator values p[0..8) of one k16 step (16 keys: columns
// 16 k .. 16 k + 16 of an m64n32 fragment, p = &d[8 k]) as A registers
// of that step, each value split into hi = bf16(p) and lo = bf16(p -
// hi): hi + lo keeps ~16 bits of p, so hi·B + lo·B on the tensor cores
// gives p·B at near f32 precision. The accumulator's column pairs are
// the A fragment's, so no data moves between threads.
__device__ __forceinline__ void split_a(const float* p, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(p[2 * i], p[2 * i + 1]);
    const float2 hf = __bfloat1622float2(h);
    hi[i] = bf16x2_bits(h);
    lo[i] = bf16x2_bits(
        __floats2bfloat162_rn(p[2 * i] - hf.x, p[2 * i + 1] - hf.y));
  }
}

}  // namespace
