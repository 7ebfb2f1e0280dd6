// BAM flash-attention forward (K1) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/bam_attention.py::
// bam_flash_attention: its dense grid (_bam_fwd_kernel :151, pallas_call
// :474; _fwd_accumulate, _fwd_finish, mask _mask_tile) and its block_map
// grid (_bam_fwd_kernel_sparse :176, pallas_call :526), in the modes
// "out", "residual" and "stats".
//
// What bounds it on this card: at the main path's shapes (hd 128, T in
// the thousands, 16-32 query heads) attention does 4·hd FLOPs per allowed
// (query, key) pair, two products, on O(T·H·hd) bytes: ~1000 FLOPs per
// byte at T = 2000, far above the H100's ~295, so it is bound by
// operations, 989 TFLOP/s of bf16 tensor cores.
//
// bf16 at hd 64, 80, 128 and 256 (the wgmma body): one warpgroup of 128
// threads owns a 64-row q tile of one head, which is wgmma's M, and
// loops over 32-key tiles with the online-softmax state (m, l) and the
// f32 output tile in registers.
//  - hd 80 runs on bam_mma.cuh's layout padded to 128: chunks 10-15 of
//    each Q, K and V row are zeros written by cp.async with no global
//    read, S takes 5 k16 steps (the zero tail adds nothing), P·V runs at
//    N 128 (the hd 128 body's registers and shared memory) and only the
//    80 real columns are stored.
//  - hd 256: S is 16 k16 steps over four column blocks; P·V is one
//    m64n256k16 per k16 step, so a thread holds 128 output values, the
//    two S tiles (32) and the split P (16): ptxas fits them in one
//    warpgroup at 224 registers, no spill. Q 32 KB and two buffers each
//    of K and V (64 KB), ~97 KB a block: two blocks an SM.
// Blocks run in parallel, so nothing is carried between them (the TPU
// grid carried VMEM scratch across its sequential k axis). The grid runs
// heads fastest and the last q tiles first: a causal mask gives those
// the most keys, and a block shares its SM with one that has fewer (on
// an H100 at the CP share, K1 stats went from 0.149 to 0.116 ms).
//  - S = Q·K^T is wgmma m64n32k16 with Q and K in shared memory
//    (bam_mma.cuh layout, 128-byte swizzle), hd / 16 steps; bf16 products
//    are exact and sum in f32, so S differs from the TPU kernel's f32 dot
//    only in the order of the sum.
//  - Mask, softcap and softmax run in registers on the accumulator
//    fragment: a thread holds 2 rows x 8 keys, evaluates bam_mask.cuh's
//    rule (split into its query and key parts) for exactly those pairs
//    from its rows' bits (registers) and the tile's (shared memory),
//    reduces rows over the 4 lanes of a quad, and selects p = 0 on a
//    masked pair. An empty row so gives exactly lse = -1e30, out = 0; in
//    stats m = -1e30, l = 0, acc = 0. A tile whose every pair is allowed
//    skips the mask. exp is ex2.approx of (s c - m) log2 e, c = scale.
//  - O += P·V is wgmma m64n{hd}k16 with P from registers and V (the same
//    swizzled [keys][hd] tile, read MN-major) in shared memory. The TPU
//    kernel multiplies p by v in f32, and so does the plain version. P
//    rounded once to bf16 (2^-9 relative) leaves the output 13x over the
//    one-bf16-ulp check at T = 2000 (10.7x in stats mode); split as
//    P_hi = bf16(P), P_lo = bf16(P - P_hi), with P_hi·V + P_lo·V on the
//    tensor cores, it keeps ~16 bits and the worst |d|/tol is 0.90 (the
//    final rounding's tie), 0.019 in stats (float64 emulation on the CPU
//    at T = 2000, 4 heads; tests/test_torch_k1_split.py holds the same
//    arithmetic at small sizes). The price is a third product: 1.5x a
//    plain flash step's tensor-core operations.
//  - Tile cost: 64 x 32 is the block map's tile (K2/K3 and the wrapper's
//    check_block_map share it), so S is only n32 wide and every 32 keys
//    pay a softmax pass, a barrier, two wgmma waits and the copies' issue
//    (~700-1000 instructions a warp): at these shapes the kernel is bound
//    by instruction issue, not by the tensor cores. Step j issues
//    S(j + 1), then P(j)·V(j), and runs the softmax of S(j + 1) while
//    P(j)·V(j) computes; no wgmma stays in flight across steps (ptxas
//    then keeps the wgmmas unserialized). Q 16 KB and two buffers each of
//    K and V (16 KB a pair at hd 128), ~51 KB a block: three blocks an SM
//    (registers), so the CP share's 256 blocks run in one wave.
//  - Loads run ahead: before the loop the block decides which tiles to
//    compute from bits alone (each warp takes a tile, one key per lane,
//    against a summary of its 64 rows: samples, mask bits, text
//    positions, modality ids; sound, never dropping a tile with an
//    allowed pair, and marking a tile full only where every row allows
//    every key) and lists them, so a skipped tile costs no K/V load; K,
//    its bits and V of the tiles ahead then arrive by 16-byte cp.async
//    while the current one computes. Keys past Tk are zero-filled, and
//    their bits 0 mask them.
//  - Both grids run this loop body in the same tile order; the
//    compacted grid (COMPACT) only walks its CSR row (below) instead of
//    every k tile. A tile that the summary keeps but no pair of which is
//    allowed is an exact no-op (alpha = 1, p = 0), so for a map that
//    covers the mask K1c writes dense K1's bits.
//
// The SIMT body (float32 at every head size) keeps the first design
// unchanged: f32 FMAs out of padded shared memory, two threads per q
// row, a block-wide skip of a tile with no allowed pair. At hd 256 a
// thread keeps 128 output columns in registers and a block takes
// 140,288 bytes of shared memory (one block an SM).
//
// The compacted grid (COMPACT = true) replaces the Pallas kernel's
// block_map path (the (q_blk, k_blk, first, last, active) scalar-prefetch
// steps). The host turns the map's q-major steps into CSR rows
// (core/bam.py::block_csr): the block of q tile i walks k tiles
// tile_idx[tile_ptr[i] .. tile_ptr[i+1]) instead of all of them,
// ascending, so K and V of a tile outside the map are never read. An
// empty row writes the empty-row conventions (out 0, lse -1e30; stats
// -1e30, 0, 0).
//
// The "stats" mode (context parallelism combines chunks of keys) stops
// before the normalisation: the epilogue writes the f32 accumulator
// acc = sum exp(s - m) V in the layout [B,H,Tq,hd], and m and l [B,H,Tq].
// Masked pairs select p = 0 and leave m at NEG_INF, so a row with no
// allowed key in this chunk gives exactly m = -1e30, l = 0, acc = 0,
// which the cross-chunk combine weighs by exp(-1e30 - m) = 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "bam_mask.cuh"
#include "bam_mma.cuh"
#include "bam_tiles.cuh"

namespace {

constexpr int BQ = 64;     // q rows per block
constexpr int BK = 32;     // keys per tile
constexpr int NT = 128;    // threads per block: one warpgroup
constexpr int JN = BK / 2; // f32: scores per thread per tile

// SIMT body: two threads per q row, f32 FMAs.
// STATS = false: out is T [B,Tq,H,hd], lse f32 [B,H,Tq] or null.
// STATS = true: out is f32 acc [B,H,Tq,hd], lse receives m, lsum l.
// COMPACT = true: walk the k tiles of CSR row blockIdx.x of (tile_ptr
// [nq+1], tile_idx) only; COMPACT = false: every k tile (both null).
template <typename T, int HD, bool STATS, bool COMPACT>
__global__ void __launch_bounds__(NT)
bam_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ qbits,
               const int* __restrict__ kbits, const int* __restrict__ qpos,
               const int* __restrict__ kpos, void* __restrict__ out,
               float* __restrict__ lse, float* __restrict__ lsum,
               const int* __restrict__ tile_ptr,
               const int* __restrict__ tile_idx, int Tq, int Tk, int H,
               int Hkv, float scale, float softcap, int window) {
  static_assert(HD % 2 == 0, "two threads split a row's columns");
  constexpr int LD = HD + 1;
  constexpr int NC = HD / 2;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;              // [BQ][LD]
  float* sK = sQ + BQ * LD;      // [BK][LD]
  float* sV = sK + BK * LD;      // [BK][LD]
  float* sP = sV + BK * LD;      // [BQ][BK + 1]
  int* sKb = reinterpret_cast<int*>(sP + BQ * (BK + 1));  // [BK]
  int* sKp = sKb + BK;                                    // [BK]

  const int tid = threadIdx.x;
  const int r = tid >> 1, half = tid & 1;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);

  for (int i = tid; i < BQ * HD; i += NT) {
    const int row = i / HD, d = i % HD, t = q0 + row;
    sQ[row * LD + d] =
        t < Tq ? to_f(q[((size_t)(b * Tq + t) * H + h) * HD + d]) : 0.f;
  }
  const int tq = q0 + r;
  const unsigned qb = tq < Tq ? (unsigned)qbits[(size_t)b * Tq + tq] : 0u;
  const int qp = tq < Tq ? qpos[(size_t)b * Tq + tq] : -1;

  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;
  float m = NEG_INF, l = 0.f;

  // the k tiles this block visits, ascending: all of them, or its CSR
  // row of the block map
  int it_beg = 0, it_end = (Tk + BK - 1) / BK;
  if constexpr (COMPACT) {
    it_beg = tile_ptr[blockIdx.x];
    it_end = tile_ptr[blockIdx.x + 1];
  }
  for (int it = it_beg; it < it_end; ++it) {
    const int k0 = (COMPACT ? tile_idx[it] : it) * BK;
    for (int i = tid; i < BK * HD; i += NT) {
      const int row = i / HD, d = i % HD, t = k0 + row;
      const size_t off = ((size_t)(b * Tk + t) * Hkv + hk) * HD + d;
      sK[row * LD + d] = t < Tk ? to_f(k[off]) : 0.f;
      sV[row * LD + d] = t < Tk ? to_f(v[off]) : 0.f;
    }
    if (tid < BK) {
      const int t = k0 + tid;
      sKb[tid] = t < Tk ? kbits[(size_t)b * Tk + t] : 0;
      sKp[tid] = t < Tk ? kpos[(size_t)b * Tk + t] : -1;
    }
    __syncthreads();

    unsigned ok = 0;
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      const int jj = half * JN + j;
      if (allowed(qb, (unsigned)sKb[jj], qp, sKp[jj], window)) ok |= 1u << j;
    }
    // block skip: a fully masked tile costs no product (the barrier also
    // orders this tile's reads before the next tile's loads)
    if (!__syncthreads_or(ok != 0u)) continue;

    float s[JN];
#pragma unroll
    for (int j = 0; j < JN; ++j) s[j] = 0.f;
    const float* qrow = sQ + r * LD;
    const float* krow = sK + half * JN * LD;
    for (int d = 0; d < HD; ++d) {
      const float qv = qrow[d];
#pragma unroll
      for (int j = 0; j < JN; ++j) s[j] = fmaf(qv, krow[j * LD + d], s[j]);
    }
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      float x = s[j] * scale;
      if (softcap != 0.f) x = tanhf(x / softcap) * softcap;
      x = ((ok >> j) & 1u) ? x : NEG_INF;
      s[j] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      const float p = ((ok >> j) & 1u) ? expf(s[j] - m_new) : 0.f;
      sP[r * (BK + 1) + half * JN + j] = p;
      ps += p;
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    l = l * alpha + ps;
    m = m_new;
    __syncthreads();

#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] *= alpha;
    for (int j = 0; j < BK; ++j) {
      const float p = sP[r * (BK + 1) + j];
      const float* vrow = sV + j * LD + half;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c] = fmaf(p, vrow[2 * c], acc[c]);
    }
    __syncthreads();
  }

  if (tq >= Tq) return;
  const size_t row = ((size_t)b * H + h) * Tq + tq;  // [B,H,Tq] index
  if constexpr (STATS) {
    float* arow = static_cast<float*>(out) + row * HD + half;
#pragma unroll
    for (int c = 0; c < NC; ++c) arow[2 * c] = acc[c];
    if (half == 0) {
      lse[row] = m;
      lsum[row] = l;
    }
  } else {
    const float inv = l > 0.f ? 1.f / fmaxf(l, 1e-30f) : 0.f;
    T* orow = static_cast<T*>(out) + ((size_t)(b * Tq + tq) * H + h) * HD +
              half;
#pragma unroll
    for (int c = 0; c < NC; ++c) store(orow + 2 * c, acc[c] * inv);
    if (lse != nullptr && half == 0)
      lse[row] = l > 0.f ? m + logf(fmaxf(l, 1e-30f)) : NEG_INF;
  }
}

template <typename T, int HD, bool STATS, bool COMPACT>
int launch(const void* q, const void* k, const void* v, const int* qb,
           const int* kb, const int* qp, const int* kp, void* out,
           float* lse, float* lsum, const int* tile_ptr,
           const int* tile_idx, int B, int Tq, int Tk, int H, int Hkv,
           float scale, float softcap, int window, cudaStream_t stream) {
  constexpr int LD = HD + 1;
  constexpr size_t smem =
      sizeof(float) * (BQ * LD + 2 * BK * LD + BQ * (BK + 1)) +
      sizeof(int) * 2 * BK;
  static_assert(smem <= MAX_BLOCK_SMEM,
                "K1's SIMT body does not fit a block's shared memory");
  auto kern = bam_fwd_kernel<T, HD, STATS, COMPACT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), qb, kb, qp, kp, out, lse, lsum, tile_ptr,
      tile_idx, Tq, Tk, H, Hkv, scale, softcap, window);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: wgmma on swizzled shared-memory tiles (see the note at the top)
// ---------------------------------------------------------------------------

// shared memory of the bf16 kernel: Q, two K tiles with their keys'
// bits and positions, two V tiles, the rows' summary, two bits per k
// tile (compute it; every pair allowed), the list of tiles to compute,
// and room to align the tiles to 1024 bytes
constexpr int NBUF = 2;   // buffers each of K (with its bits) and V

template <int HD>
size_t mma_smem(int Tk) {
  constexpr int HP = padded_hd(HD);
  const int nk = (Tk + BK - 1) / BK;
  return 1024 + BQ * HP * 2 + 2 * NBUF * BK * HP * 2 +
         NBUF * 2 * BK * sizeof(int) + 32 * sizeof(int) +
         2 * ((nk + 31) / 32) * sizeof(unsigned) + (nk + 1) * sizeof(int);
}

template <typename T, int HD, bool STATS, bool COMPACT>
__global__ void __launch_bounds__(NT)
bam_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ qbits,
                   const int* __restrict__ kbits,
                   const int* __restrict__ qpos,
                   const int* __restrict__ kpos, void* __restrict__ out,
                   float* __restrict__ lse, float* __restrict__ lsum,
                   const int* __restrict__ tile_ptr,
                   const int* __restrict__ tile_idx, int Tq, int Tk, int H,
                   int Hkv, float scale, float softcap, int window) {
  static_assert(std::is_same<T, __nv_bfloat16>::value, "bf16 only");
  constexpr int HP = padded_hd(HD); // head size of the tile layout
  constexpr int QB = BQ * HP * 2;   // bytes of the Q tile
  constexpr int KB = BK * HP * 2;   // bytes of one K (or V) tile
  constexpr int NO = HP / 2;        // output values per thread
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sQ = smem_u32(sm);                 // [BQ][HP] swizzled
  const uint32_t sK = sQ + QB;                      // NBUF x [BK][HP]
  const uint32_t sV = sK + NBUF * KB;               // NBUF x [BK][HP]
  int* sBits = reinterpret_cast<int*>(sm + QB + 2 * NBUF * KB);
  int* sSum = sBits + NBUF * 2 * BK;                // [4 warps][8]
  unsigned* sAct = reinterpret_cast<unsigned*>(sSum + 32);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  // heads vary fastest and the last q tiles come first: under a causal
  // mask they see the most keys, and blocks i and i + (number of SMs),
  // which tend to share an SM, pair a long q tile with a short one
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * BQ;
  const int h = blockIdx.x, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const T* qbase = q + ((size_t)b * Tq * H + h) * HD;
  const T* kbase = k + ((size_t)b * Tk * Hkv + hk) * HD;
  const T* vbase = v + ((size_t)b * Tk * Hkv + hk) * HD;
  const int* kb_row = kbits + (size_t)b * Tk;
  const int* kp_row = kpos + (size_t)b * Tk;

  // this thread's two rows of the accumulator fragments, and their part
  // of the mask rule
  const int tq0 = q0 + warp * 16 + g, tq1 = tq0 + 8;
  const QueryRule qr0 = query_rule(
      tq0 < Tq ? (unsigned)qbits[(size_t)b * Tq + tq0] : 0u,
      tq0 < Tq ? qpos[(size_t)b * Tq + tq0] : -1, window);
  const QueryRule qr1 = query_rule(
      tq1 < Tq ? (unsigned)qbits[(size_t)b * Tq + tq1] : 0u,
      tq1 < Tq ? qpos[(size_t)b * Tq + tq1] : -1, window);

  // the k tiles this block may visit, ascending: entry e is k tile e, or
  // the e-th of its CSR row of the block map
  int e_beg = 0, n_ent = (Tk + BK - 1) / BK;
  if constexpr (COMPACT) {
    e_beg = tile_ptr[qt];
    n_ent = tile_ptr[qt + 1] - e_beg;
  }
  const int n_words = (n_ent + 31) / 32;
  int* sList = reinterpret_cast<int*>(sAct + 2 * n_words);  // [count, tiles]
  auto tile_of = [&](int e) { return COMPACT ? tile_idx[e_beg + e] : e; };

  // 1. the rows' summary; 2. which entries to compute, and which need
  // no mask, from bits alone, listed ascending: tile index, and bit 31
  // set where no mask is needed (bam_tiles.cuh)
  for (int i = tid; i < 2 * n_words; i += NT) sAct[i] = 0u;
  const RowsSummary rs = summarize_rows(qbits + (size_t)b * Tq,
                                        qpos + (size_t)b * Tq, q0, Tq, sSum,
                                        tid);
  list_tiles(rs, n_ent, tile_of, kb_row, kp_row, Tk, window, sAct, sList,
             tid);
  const int n_tiles = sList[0];
  const int* tiles = sList + 1;

  // 3. the computed tiles j = 0, 1, ... Step j: wait for K(j + 1),
  // bits(j + 1) and V(j); load K(j + 2), bits(j + 2) and V(j + 1); issue
  // S(j + 1) = Q K(j + 1)^T, then O = alpha O + P(j) V(j) on the tensor
  // cores, and run the softmax of S(j + 1) while P(j) V(j) computes; wait
  // for it. No wgmma is in flight across steps. K and its bits, and V,
  // take two buffers each: buffer j % 2 holds tile j.
  auto load_k = [&](int tile, int st) {
    const int k0 = (tile & ITEM_TILE) * BK;
    cp_async_tile<BK, HD, NT>(sK + st * KB, kbase, k0, Tk, (size_t)Hkv * HD,
                              tid);
    if (tid < 2 * BK) {   // bits of the tile's keys, then their positions
      const int t = k0 + (tid & (BK - 1));
      const int* src = (tid < BK ? kb_row : kp_row) + (t < Tk ? t : 0);
      cp_async_4(smem_u32(sBits + st * 2 * BK + tid), src, t < Tk ? 4 : 0);
    }
  };
  auto load_v = [&](int tile, int st) {
    cp_async_tile<BK, HD, NT>(sV + st * KB, vbase,
                              (tile & ITEM_TILE) * BK, Tk,
                              (size_t)Hkv * HD, tid);
  };
  // wgmma descriptors of Q and of each K and V buffer; a k16 step moves
  // the start address (16-byte units) by a constant
  const uint64_t dQ = sw128_desc(sQ, 16, 1024);
  const uint64_t dK[2] = {sw128_desc(sK, 16, 1024),
                          sw128_desc(sK + KB, 16, 1024)};
  const uint64_t dV[2] = {sw128_desc(sV, BK * 128, 1024),
                          sw128_desc(sV + KB, BK * 128, 1024)};
  // S = Q K^T from K buffer st: hd / 16 steps of m64n32k16 (16 hd values,
  // 32 bytes, a step; a column block of 64 values every 4 steps)
  auto issue_s = [&](float (&d)[16], int st) {
    fence_regs(d);
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;
      wgmma_m64n32k16_ss(d, dQ + (((kk >> 2) * (BQ * 128) + off) >> 4),
                         dK[st] + (((kk >> 2) * (BK * 128) + off) >> 4),
                         kk > 0);
    }
    wgmma_commit();
  };

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float sc[16], sn[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) sc[i] = sn[i] = 0.f;
  uint32_t ahi[2][4], alo[2][4];
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float alpha0 = 1.f, alpha1 = 1.f;

  // mask, softcap and the online softmax of the S tile of a tile (keys'
  // bits in K buffer st) on the fragment: s[4 c + 2 i + u] is row tq_i,
  // key 8 c + 2 tig + u of the tile, and becomes p. The logit is x = s *
  // scale (or softcap tanh(s scale / softcap)); p = exp(x - m) is
  // exp2(s c log2 e - m log2 e) with c = scale folded in (c = 1 under a
  // softcap). A tile that every row sees whole takes no mask; elsewhere
  // masked pairs select p = 0 and leave m at -1e30. Sets alpha, the
  // rescale of O.
  auto softmax = [&](float (&sx)[16], int st, auto full_tag) {
    constexpr bool FULL = decltype(full_tag)::value;
    bool ok[16];
    if constexpr (!FULL) {
      const int* kb_s = sBits + st * 2 * BK;
      fragment_mask(ok, qr0, qr1, kb_s, kb_s + BK, tig);
    }
    float c = scale;
    if (softcap != 0.f) {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        sx[i] = tanhf(sx[i] * scale / softcap) * softcap;
      c = 1.f;
    }
    if constexpr (!FULL) {
#pragma unroll
      for (int i = 0; i < 16; ++i) sx[i] = ok[i] ? sx[i] : NEG_INF;
    }
    // row maxima and sums as trees over a row's 8 values (i & 2 picks
    // the row)
    auto row_tree = [&](int r, auto op) {
      float t[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        t[c] = op(sx[4 * c + 2 * r], sx[4 * c + 2 * r + 1]);
      return op(op(t[0], t[1]), op(t[2], t[3]));
    };
    auto fmax2 = [](float a, float b) { return fmaxf(a, b); };
    auto add2 = [](float a, float b) { return a + b; };
    float mx0 = row_tree(0, fmax2), mx1 = row_tree(1, fmax2);
#pragma unroll
    for (int d = 1; d < 4; d <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, d));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, d));
    }
    // c > 0 keeps the order; a row with no allowed key keeps -1e30
    const float mn0 = fmaxf(m0, mx0 == NEG_INF ? NEG_INF : mx0 * c);
    const float mn1 = fmaxf(m1, mx1 == NEG_INF ? NEG_INF : mx1 * c);
    alpha0 = ex2((m0 - mn0) * LOG2E);
    alpha1 = ex2((m1 - mn1) * LOG2E);
    const float cl = c * LOG2E, nb0 = -mn0 * LOG2E, nb1 = -mn1 * LOG2E;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float p = ex2(fmaf(sx[i], cl, (i & 2) ? nb1 : nb0));
      if constexpr (FULL)
        sx[i] = p;
      else
        sx[i] = ok[i] ? p : 0.f;
    }
    float ps0 = row_tree(0, add2), ps1 = row_tree(1, add2);
#pragma unroll
    for (int d = 1; d < 4; d <<= 1) {
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, d);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, d);
    }
    l0 = l0 * alpha0 + ps0;
    l1 = l1 * alpha1 + ps1;
    m0 = mn0;
    m1 = mn1;
  };
  auto softmax_of = [&](float (&sx)[16], int tile, int st) {
    if (tile < 0)   // bit 31: every pair allowed
      softmax(sx, st, std::true_type{});
    else
      softmax(sx, st, std::false_type{});
  };

  // step j, buffer parity P = j % 2: P(j) is in cur; S(j + 1) goes to nxt
  auto step = [&](int j, float (&cur)[16], float (&nxt)[16], auto par) {
    constexpr int P = decltype(par)::value;
    // K(j + 1), bits(j + 1) and V(j) have landed; every thread is done
    // with K(j), bits(j) (S(j), its softmax) and V(j - 1) (P(j - 1) V(j - 1))
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    if (j + 2 < n_tiles) load_k(tiles[j + 2], P);
    if (j + 1 < n_tiles) load_v(tiles[j + 1], 1 - P);
    cp_async_commit();
    // S(j + 1); the last step issues it too, on whatever K buffer 1 - P
    // holds, and drops it, so that every step has the same wgmma groups
    issue_s(nxt, 1 - P);

    // O = alpha O + P_hi V + P_lo V: two k16 steps of 16 keys; V is the
    // swizzled tile read MN-major (next 64 hd values: 32 rows x 128 bytes
    // on; next 8 keys: 1024 bytes on)
    if (alpha0 != 1.f || alpha1 != 1.f) {
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] *= (i & 2) ? alpha1 : alpha0;
    }
    split_a(cur, ahi[0], alo[0]);
    split_a(cur + 8, ahi[1], alo[1]);
    fence_regs(o);
    fence_regs(ahi[0]);
    fence_regs(ahi[1]);
    fence_regs(alo[0]);
    fence_regs(alo[1]);
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint64_t dv = dV[P] + ((kk * 16 * 128) >> 4);
      wgmma_rs<HP>(o, ahi[kk], dv);
      wgmma_rs<HP>(o, alo[kk], dv);
    }
    wgmma_commit();

    wgmma_wait<1>();   // S(j + 1) done; P(j) V(j) runs on
    fence_regs(nxt);
    if (j + 1 < n_tiles) softmax_of(nxt, tiles[j + 1], 1 - P);
    wgmma_wait<0>();
    fence_regs(o);
  };

  if (n_tiles > 0) {
    cp_async_tile<BQ, HD, NT>(sQ, qbase, q0, Tq, (size_t)H * HD, tid);
    load_k(tiles[0], 0);
    load_v(tiles[0], 0);
    if (n_tiles > 1) load_k(tiles[1], 1);
  }
  cp_async_commit();
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();
  if (n_tiles > 0) {
    issue_s(sc, 0);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax_of(sc, tiles[0], 0);
  }
  // two steps a turn, so that S(j + 1) lands where P(j + 1) is read
  for (int j = 0; j < n_tiles; j += 2) {
    step(j, sc, sn, std::integral_constant<int, 0>{});
    if (j + 1 >= n_tiles) break;
    step(j + 1, sn, sc, std::integral_constant<int, 1>{});
  }
  cp_async_wait_all();

  // 4. epilogue: o[4 c + 2 i + u] is row tq_i, column 8 c + 2 tig + u;
  // the columns past HD (hd 80's padding) are not stored
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tq = i ? tq1 : tq0;
    const float m = i ? m1 : m0, l = i ? l1 : l0;
    if (tq >= Tq) continue;
    const size_t row = ((size_t)b * H + h) * Tq + tq;  // [B,H,Tq] index
    if constexpr (STATS) {
      float* arow = static_cast<float*>(out) + row * HD + 2 * tig;
#pragma unroll
      for (int c = 0; c < HD / 8; ++c)
        *reinterpret_cast<float2*>(arow + 8 * c) =
            make_float2(o[4 * c + 2 * i], o[4 * c + 2 * i + 1]);
      if (tig == 0) {
        lse[row] = m;
        lsum[row] = l;
      }
    } else {
      const float inv = l > 0.f ? 1.f / fmaxf(l, 1e-30f) : 0.f;
      T* orow = static_cast<T*>(out) + ((size_t)(b * Tq + tq) * H + h) * HD +
                2 * tig;
#pragma unroll
      for (int c = 0; c < HD / 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) =
            __floats2bfloat162_rn(o[4 * c + 2 * i] * inv,
                                  o[4 * c + 2 * i + 1] * inv);
      if (lse != nullptr && tig == 0)
        lse[row] = l > 0.f ? m + logf(fmaxf(l, 1e-30f)) : NEG_INF;
    }
  }
}

template <typename T, int HD, bool STATS, bool COMPACT>
int launch_mma(const void* q, const void* k, const void* v, const int* qb,
               const int* kb, const int* qp, const int* kp, void* out,
               float* lse, float* lsum, const int* tile_ptr,
               const int* tile_idx, int B, int Tq, int Tk, int H, int Hkv,
               float scale, float softcap, int window, cudaStream_t stream) {
  const size_t smem = mma_smem<HD>(Tk);
  auto kern = bam_fwd_mma_kernel<T, HD, STATS, COMPACT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, (Tq + BQ - 1) / BQ, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), qb, kb, qp, kp, out, lse, lsum, tile_ptr,
      tile_idx, Tq, Tk, H, Hkv, scale, softcap, window);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int dispatch(const void* q, const void* k, const void* v, const int* qb,
             const int* kb, const int* qp, const int* kp, void* out,
             float* lse, float* lsum, const int* tile_ptr,
             const int* tile_idx, int B, int Tq, int Tk, int H, int Hkv,
             float scale, float softcap, int window, cudaStream_t stream) {
#define BAM_FWD_LAUNCH(STATS, COMPACT)                                       \
  {                                                                          \
    if constexpr (!wgmma_body<T, HD>())                                      \
      return launch<T, HD, STATS, COMPACT>(q, k, v, qb, kb, qp, kp, out,     \
                                           lse, lsum, tile_ptr, tile_idx, B, \
                                           Tq, Tk, H, Hkv, scale, softcap,   \
                                           window, stream);                  \
    else                                                                     \
      return launch_mma<T, HD, STATS, COMPACT>(                              \
          q, k, v, qb, kb, qp, kp, out, lse, lsum, tile_ptr, tile_idx, B,    \
          Tq, Tk, H, Hkv, scale, softcap, window, stream);                   \
  }
  if (lsum != nullptr) {
    if (tile_ptr != nullptr) BAM_FWD_LAUNCH(true, true);
    BAM_FWD_LAUNCH(true, false);
  }
  if (tile_ptr != nullptr) BAM_FWD_LAUNCH(false, true);
  BAM_FWD_LAUNCH(false, false);
#undef BAM_FWD_LAUNCH
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd 64, 80, 128 or 256 (bf16 on the
// wgmma body, f32 on the SIMT body; any other hd returns
// cudaErrorInvalidValue). q [B,Tq,H,hd], k/v [B,Tk,Hkv,hd],
// all contiguous; bits/pos int32 [B,T]. With lsum null ("out" and
// "residual"): out [B,Tq,H,hd] in q's type, lse f32 [B,H,Tq] or null.
// With lsum set ("stats"): out f32 [B,H,Tq,hd] (acc), lse f32 [B,H,Tq]
// receives m and lsum l. With tile_ptr set, the compacted grid: int32
// CSR rows tile_ptr [ceil(Tq/64)+1] and tile_idx (k tiles of 32 keys,
// ascending per row); both null for the dense grid. bf16 q, k and v
// must start on 16 bytes (16-byte cp.async rows), else
// cudaErrorMisalignedAddress. Returns cudaGetLastError() after the
// launch.
extern "C" int bam_fwd(const void* q, const void* k, const void* v,
                       const void* q_bits, const void* kv_bits,
                       const void* q_pos, const void* kv_pos, void* out,
                       void* lse, void* lsum, const void* tile_ptr,
                       const void* tile_idx, int B, int Tq, int Tk, int H,
                       int Hkv, int hd, int dtype, float scale,
                       float softcap, int window, void* stream) {
  const int* qb = static_cast<const int*>(q_bits);
  const int* kb = static_cast<const int*>(kv_bits);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  const int* tp = static_cast<const int*>(tile_ptr);
  const int* ti = static_cast<const int*>(tile_idx);
  float* ls = static_cast<float*>(lse);
  float* lt = static_cast<float*>(lsum);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 &&
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
#define BAM_FWD_CASE(TYPE, HD)                                              \
  return dispatch<TYPE, HD>(q, k, v, qb, kb, qp, kp, out, ls, lt, tp, ti,  \
                            B, Tq, Tk, H, Hkv, scale, softcap, window, st)
  if (dtype == 0 && hd == 64) BAM_FWD_CASE(float, 64);
  if (dtype == 0 && hd == 80) BAM_FWD_CASE(float, 80);
  if (dtype == 0 && hd == 128) BAM_FWD_CASE(float, 128);
  if (dtype == 0 && hd == 256) BAM_FWD_CASE(float, 256);
  if (dtype == 1 && hd == 64) BAM_FWD_CASE(__nv_bfloat16, 64);
  if (dtype == 1 && hd == 80) BAM_FWD_CASE(__nv_bfloat16, 80);
  if (dtype == 1 && hd == 128) BAM_FWD_CASE(__nv_bfloat16, 128);
  if (dtype == 1 && hd == 256) BAM_FWD_CASE(__nv_bfloat16, 256);
#undef BAM_FWD_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* bam_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
