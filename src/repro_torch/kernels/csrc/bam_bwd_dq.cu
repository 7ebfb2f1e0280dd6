// BAM flash-attention backward, dQ half (K2), for Hopper, sm_90a.
//
// Replaces the dQ pallas_call of the Pallas TPU kernel
// repro/kernels/bam_attention.py::bam_flash_attention_bwd on its dense
// grid (_bam_bwd_dq_kernel :566, _recompute_p_ds, mask _mask_tile) and on
// its block_map grid (_bam_bwd_dq_kernel_sparse, pallas_call :652).
//
// What bounds it on this card: per allowed (query, key) pair it does
// three hd-long products (S = Q·K, dP = dO·V, dQ += dS·K) on O(T·H·hd)
// bytes, far above the H100's ~295 operations per byte at the train
// path's T = 1600, so it is bound by operations, 989 TFLOP/s of bf16
// tensor cores.
//
// bf16 at hd 64 and 128 (the wgmma body): K1's design (bam_fwd.cu) with
// the backward's arithmetic. One warpgroup of 128 threads owns a 64-row
// q tile of one head, which is wgmma's M, and loops over 32-key tiles
// with the f32 dQ tile in registers; the grid runs heads fastest and the
// last q tiles first, so a long causal q tile shares its SM with a short
// one.
//  - S = Q·K^T and dP = dO·V^T are wgmma m64n32k16 with Q and dO
//    resident and K and V in shared memory (bam_mma.cuh's 128-byte
//    swizzle), hd / 16 steps each: bf16 products are exact and sum in
//    f32, so both differ from the TPU kernel's f32 dots only in order.
//  - P = exp(s·scale - lse) (ex2.approx, lse folded in per row) and dS =
//    P (dP - delta), times 1 - (x/cap)^2 of the capped logit x under a
//    softcap, run in f32 on the accumulator fragments (2 rows x 8 keys a
//    thread). A masked pair selects dS = 0, never multiplies by the
//    mask, so an empty row (lse = -1e30, where exp overflows) gives dQ
//    = 0 exactly; a tile every row sees whole skips the mask.
//  - dQ += dS·K is wgmma m64n{hd}k16 with dS from registers and K (the
//    same swizzled [keys][hd] tile, read MN-major) in shared memory. The
//    TPU kernel multiplies f32 dS by K; dS rounded once to bf16 leaves dQ
//    8-14x over the one-bf16-ulp check, so dS is split as dS_hi =
//    bf16(dS), dS_lo = bf16(dS - dS_hi) and both parts are multiplied
//    (worst |d|/tol 0.028 by the CPU emulation in
//    tests/test_torch_bwd_split.py): four products a tile where a plain
//    flash backward has three.
//  - Step j issues S(j + 1) and dP(j + 1), then dQ += dS(j)·K(j), and
//    computes dS(j + 1) while the latter runs; no wgmma stays in flight
//    across steps. K(j) is read while S(j + 1) reads K(j + 1) and K(j +
//    2) lands, so K (with its keys' bits) takes three buffers, V two.
//    Q, dO, 3 K and 2 V tiles: ~75 KB a block at hd 128.
//  - Before the loop the block lists the tiles to compute from bits alone
//    (bam_tiles.cuh: the rows' summary against each tile's keys), so a
//    skipped tile costs no load, and marks the tiles that need no mask.
//    Keys past Tk are zero-filled and their bits 0 mask them.
//  - The compacted grid walks its CSR row (below) through the same loop
//    body in the same order; a tile the summary keeps but no pair of
//    which is allowed adds exact zeros, so for a map that covers the mask
//    K2c writes dense K2's bits.
//
// The SIMT body (float32, and bf16 at hd 80 and 256, where no wgmma body
// is built yet; bf16 converted to f32 on load, dQ rounded once on store)
// keeps the first design unchanged: f32 FMAs out of padded shared
// memory. At hd 256 a thread keeps 128 dQ columns in registers and a
// block takes 206,080 bytes of shared memory (one block an SM). One
// block owns one (64-row q tile, q
// head, batch row) and loops over all 32-key tiles of K/V, keeping its
// dQ rows in registers; two threads share a q row, each computing 16 of
// the tile's 32 (S, dP) pairs and owning every second dQ column; a tile
// with no allowed pair is skipped before any product; delta =
// rowsum(dO·O) comes in precomputed (f32 [B,H,Tq]). Ragged Tq and Tk are
// masked here: rows and keys past the end load as zeros with bits 0.
// GQA reads K/V head h / (H / Hkv).
//
// The compacted grid (COMPACT = true) replaces the dQ pallas_call of the
// Pallas kernel's block_map path: the block of q tile i walks only the k
// tiles of CSR row i of the map's q-major list (core/bam.py::block_csr),
// ascending, so for a map that covers the mask dQ is the dense kernel's
// to the bit, and a row with no active tile writes dQ = 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bam_mask.cuh"
#include "bam_mma.cuh"
#include "bam_tiles.cuh"

namespace {

constexpr int BQ = 64;     // q rows per block
constexpr int BK = 32;     // keys per tile
constexpr int NT = 128;    // threads per block (f32: two per q row)
constexpr int JN = BK / 2; // pairs per thread per tile

// SIMT body: two threads per q row, f32 FMAs.
// COMPACT = true: walk the k tiles of CSR row blockIdx.x of (tile_ptr
// [nq+1], tile_idx) only; COMPACT = false: every k tile (both null).
template <typename T, int HD, bool COMPACT>
__global__ void __launch_bounds__(NT)
bam_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const int* __restrict__ qbits, const int* __restrict__ kbits,
                  const int* __restrict__ qpos, const int* __restrict__ kpos,
                  T* __restrict__ dq, const int* __restrict__ tile_ptr,
                  const int* __restrict__ tile_idx, int Tq, int Tk, int H,
                  int Hkv, float scale, float softcap, int window) {
  static_assert(HD % 2 == 0, "two threads split a row's columns");
  constexpr int LD = HD + 1;
  constexpr int NC = HD / 2;  // dQ columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;              // [BQ][LD]
  float* sDO = sQ + BQ * LD;     // [BQ][LD]
  float* sK = sDO + BQ * LD;     // [BK][LD]
  float* sV = sK + BK * LD;      // [BK][LD]
  float* sDS = sV + BK * LD;     // [BQ][BK + 1]
  int* sKb = reinterpret_cast<int*>(sDS + BQ * (BK + 1));  // [BK]
  int* sKp = sKb + BK;                                      // [BK]

  const int tid = threadIdx.x;
  const int r = tid >> 1, half = tid & 1;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);

  for (int i = tid; i < BQ * HD; i += NT) {
    const int row = i / HD, d = i % HD, t = q0 + row;
    const size_t off = ((size_t)(b * Tq + t) * H + h) * HD + d;
    sQ[row * LD + d] = t < Tq ? to_f(q[off]) : 0.f;
    sDO[row * LD + d] = t < Tq ? to_f(dout[off]) : 0.f;
  }
  const int tq = q0 + r;
  const bool live = tq < Tq;
  const unsigned qb = live ? (unsigned)qbits[(size_t)b * Tq + tq] : 0u;
  const int qp = live ? qpos[(size_t)b * Tq + tq] : -1;
  const size_t row_off = ((size_t)b * H + h) * Tq + tq;
  const float row_lse = live ? lse[row_off] : 0.f;
  const float row_delta = live ? delta[row_off] : 0.f;

  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;

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

    float s[JN], dp[JN];
#pragma unroll
    for (int j = 0; j < JN; ++j) s[j] = dp[j] = 0.f;
    const float* qrow = sQ + r * LD;
    const float* dorow = sDO + r * LD;
    const float* krow = sK + half * JN * LD;
    const float* vrow = sV + half * JN * LD;
    for (int d = 0; d < HD; ++d) {
      const float qv = qrow[d], gv = dorow[d];
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        s[j] = fmaf(qv, krow[j * LD + d], s[j]);
        dp[j] = fmaf(gv, vrow[j * LD + d], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      float x = s[j] * scale, chain = 1.f;
      if (softcap != 0.f) {
        x = tanhf(x / softcap) * softcap;
        chain = 1.f - (x / softcap) * (x / softcap);
      }
      float ds = 0.f;
      if ((ok >> j) & 1u) ds = expf(x - row_lse) * (dp[j] - row_delta) * chain;
      sDS[r * (BK + 1) + half * JN + j] = ds;
    }
    __syncthreads();

    for (int j = 0; j < BK; ++j) {
      const float g = sDS[r * (BK + 1) + j];
      const float* kj = sK + j * LD + half;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c] = fmaf(g, kj[2 * c], acc[c]);
    }
    __syncthreads();
  }

  if (!live) return;
  T* out = dq + ((size_t)(b * Tq + tq) * H + h) * HD + half;
#pragma unroll
  for (int c = 0; c < NC; ++c) store(out + 2 * c, acc[c] * scale);
}

template <typename T, int HD, bool COMPACT>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, const int* qb,
           const int* kb, const int* qp, const int* kp, void* dq,
           const int* tile_ptr, const int* tile_idx, int B, int Tq, int Tk,
           int H, int Hkv, float scale, float softcap, int window,
           cudaStream_t stream) {
  constexpr int LD = HD + 1;
  constexpr size_t smem =
      sizeof(float) * (2 * BQ * LD + 2 * BK * LD + BQ * (BK + 1)) +
      sizeof(int) * 2 * BK;
  static_assert(smem <= MAX_BLOCK_SMEM,
                "K2's SIMT body does not fit a block's shared memory");
  auto kern = bam_bwd_dq_kernel<T, HD, COMPACT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, qb,
      kb, qp, kp, static_cast<T*>(dq), tile_ptr, tile_idx, Tq, Tk, H, Hkv,
      scale, softcap, window);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: wgmma on swizzled shared-memory tiles (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int NKB = 3;   // K buffers, each with its keys' bits and positions
constexpr int NVB = 2;   // V buffers

// shared memory of the bf16 kernel: Q, dO, the K and V buffers, the
// keys' bits, the rows' summary, two bits per k tile (compute it; every
// pair allowed), the list of tiles to compute, and room to align the
// tiles to 1024 bytes
template <int HD>
size_t mma_smem(int Tk) {
  const int nk = (Tk + BK - 1) / BK;
  return 1024 + 2 * BQ * HD * 2 + (NKB + NVB) * BK * HD * 2 +
         NKB * 2 * BK * sizeof(int) + 32 * sizeof(int) +
         2 * ((nk + 31) / 32) * sizeof(unsigned) + (nk + 1) * sizeof(int);
}

template <int HD, bool COMPACT>
__global__ void __launch_bounds__(NT)
bam_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ qbits,
                      const int* __restrict__ kbits,
                      const int* __restrict__ qpos,
                      const int* __restrict__ kpos,
                      __nv_bfloat16* __restrict__ dq,
                      const int* __restrict__ tile_ptr,
                      const int* __restrict__ tile_idx, int Tq, int Tk,
                      int H, int Hkv, float scale, float softcap,
                      int window) {
  constexpr int QB = BQ * HD * 2;   // bytes of the Q (or dO) tile
  constexpr int KB = BK * HD * 2;   // bytes of one K (or V) tile
  constexpr int NO = HD / 2;        // dQ values per thread
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sQ = smem_u32(sm);                 // [BQ][HD] swizzled
  const uint32_t sDO = sQ + QB;                     // [BQ][HD]
  const uint32_t sK = sDO + QB;                     // NKB x [BK][HD]
  const uint32_t sV = sK + NKB * KB;                // NVB x [BK][HD]
  int* sBits = reinterpret_cast<int*>(sm + 2 * QB + (NKB + NVB) * KB);
  int* sSum = sBits + NKB * 2 * BK;                 // [4 warps][8]
  unsigned* sAct = reinterpret_cast<unsigned*>(sSum + 32);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  // heads vary fastest and the last q tiles come first (as in K1)
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * BQ;
  const int h = blockIdx.x, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t qoff = ((size_t)b * Tq * H + h) * HD;
  const __nv_bfloat16* kbase = k + ((size_t)b * Tk * Hkv + hk) * HD;
  const __nv_bfloat16* vbase = v + ((size_t)b * Tk * Hkv + hk) * HD;
  const int* kb_row = kbits + (size_t)b * Tk;
  const int* kp_row = kpos + (size_t)b * Tk;

  // this thread's two rows of the accumulator fragments: their part of
  // the mask rule, -lse log2 e and delta
  const int tq0 = q0 + warp * 16 + g, tq1 = tq0 + 8;
  const QueryRule qr0 = query_rule(
      tq0 < Tq ? (unsigned)qbits[(size_t)b * Tq + tq0] : 0u,
      tq0 < Tq ? qpos[(size_t)b * Tq + tq0] : -1, window);
  const QueryRule qr1 = query_rule(
      tq1 < Tq ? (unsigned)qbits[(size_t)b * Tq + tq1] : 0u,
      tq1 < Tq ? qpos[(size_t)b * Tq + tq1] : -1, window);
  const size_t row0 = ((size_t)b * H + h) * Tq + tq0;  // [B,H,Tq] index
  const float nb0 = tq0 < Tq ? -lse[row0] * LOG2E : 0.f;
  const float nb1 = tq1 < Tq ? -lse[row0 + 8] * LOG2E : 0.f;
  const float dl0 = tq0 < Tq ? delta[row0] : 0.f;
  const float dl1 = tq1 < Tq ? delta[row0 + 8] : 0.f;

  // the k tiles this block may visit, ascending: entry e is k tile e, or
  // the e-th of its CSR row of the block map; those to compute, listed
  // from bits alone (bam_tiles.cuh)
  int e_beg = 0, n_ent = (Tk + BK - 1) / BK;
  if constexpr (COMPACT) {
    e_beg = tile_ptr[qt];
    n_ent = tile_ptr[qt + 1] - e_beg;
  }
  const int n_words = (n_ent + 31) / 32;
  int* sList = reinterpret_cast<int*>(sAct + 2 * n_words);  // [count, tiles]
  auto tile_of = [&](int e) { return COMPACT ? tile_idx[e_beg + e] : e; };
  for (int i = tid; i < 2 * n_words; i += NT) sAct[i] = 0u;
  const RowsSummary rs = summarize_rows(qbits + (size_t)b * Tq,
                                        qpos + (size_t)b * Tq, q0, Tq, sSum,
                                        tid);
  list_tiles(rs, n_ent, tile_of, kb_row, kp_row, Tk, window, sAct, sList,
             tid);
  const int n_tiles = sList[0];
  const int* tiles = sList + 1;

  auto load_k = [&](int tile, int st) {   // K and its keys' bits
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
    cp_async_tile<BK, HD, NT>(sV + st * KB, vbase, (tile & ITEM_TILE) * BK,
                              Tk, (size_t)Hkv * HD, tid);
  };
  // wgmma descriptors: Q and dO as A, K and V as K-major B (S, dP), K as
  // MN-major B (dS·K: next 64 hd values 32 rows x 128 bytes on, next 8
  // keys 1024 bytes on); a k16 step moves the start address by a constant
  const uint64_t dQa = sw128_desc(sQ, 16, 1024);
  const uint64_t dDOa = sw128_desc(sDO, 16, 1024);
  auto issue_sdp = [&](float (&s)[16], float (&dp)[16], int kst, int vst) {
    const uint64_t dk = sw128_desc(sK + kst * KB, 16, 1024);
    const uint64_t dv = sw128_desc(sV + vst * KB, 16, 1024);
    fence_regs(s);
    fence_regs(dp);
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t oa = (kk >> 2) * (BQ * 128) + (kk & 3) * 32;
      const uint32_t ob = (kk >> 2) * (BK * 128) + (kk & 3) * 32;
      wgmma_m64n32k16_ss(s, dQa + (oa >> 4), dk + (ob >> 4), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t oa = (kk >> 2) * (BQ * 128) + (kk & 3) * 32;
      const uint32_t ob = (kk >> 2) * (BK * 128) + (kk & 3) * 32;
      wgmma_m64n32k16_ss(dp, dDOa + (oa >> 4), dv + (ob >> 4), kk > 0);
    }
    wgmma_commit();
  };

  // dS of a tile (keys' bits in K buffer st) on the fragments, into s:
  // s[4 c + 2 i + u] is row tq_i, key 8 c + 2 tig + u of the tile. The
  // logit is x = s scale (or cap tanh(s scale / cap)); p = exp(x - lse)
  // is exp2(x' log2 e - lse log2 e) with the scale folded into x'.
  auto grad = [&](float (&s)[16], const float (&dp)[16], int st,
                  auto full_tag) {
    constexpr bool FULL = decltype(full_tag)::value;
    bool ok[16];
    if constexpr (!FULL) {
      const int* kb_s = sBits + st * 2 * BK;
      fragment_mask(ok, qr0, qr1, kb_s, kb_s + BK, tig);
    }
    if (softcap != 0.f) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float x = tanhf(s[i] * scale / softcap) * softcap;
        const float t = x / softcap;
        const float p = ex2(fmaf(x, LOG2E, (i & 2) ? nb1 : nb0));
        const float ds = p * (dp[i] - ((i & 2) ? dl1 : dl0)) * (1.f - t * t);
        s[i] = (FULL || ok[i]) ? ds : 0.f;
      }
    } else {
      const float cl = scale * LOG2E;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float p = ex2(fmaf(s[i], cl, (i & 2) ? nb1 : nb0));
        const float ds = p * (dp[i] - ((i & 2) ? dl1 : dl0));
        s[i] = (FULL || ok[i]) ? ds : 0.f;
      }
    }
  };
  auto grad_of = [&](float (&s)[16], const float (&dp)[16], int tile,
                     int st) {
    if (tile < 0)   // bit 31: every pair allowed
      grad(s, dp, st, std::true_type{});
    else
      grad(s, dp, st, std::false_type{});
  };

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float sa[16], pa[16], sb[16], pb[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) sa[i] = pa[i] = sb[i] = pb[i] = 0.f;
  uint32_t ahi[2][4], alo[2][4];

  // step j: dS(j) is in cur; S(j + 1) and dP(j + 1) go to nxt and dpn.
  // K(j) sits in buffer j % 3 (bits too), V(j) in j % 2.
  auto step = [&](int j, float (&cur)[16], float (&nxt)[16],
                  float (&dpn)[16]) {
    // K(j + 1), its bits and V(j + 1) have landed; every thread is done
    // with K(j - 1) (dS(j - 1)·K(j - 1)), bits(j) and V(j) (dP(j))
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    if (j + 2 < n_tiles) {
      load_k(tiles[j + 2], (j + 2) % NKB);
      load_v(tiles[j + 2], (j + 2) % NVB);
    }
    cp_async_commit();
    // S(j + 1), dP(j + 1); the last step issues them too, on whatever
    // the buffers hold, and drops them, so every step has the same groups
    issue_sdp(nxt, dpn, (j + 1) % NKB, (j + 1) % NVB);

    // dQ += dS_hi K + dS_lo K: two k16 steps of 16 keys
    split_a(cur, ahi[0], alo[0]);
    split_a(cur + 8, ahi[1], alo[1]);
    fence_regs(acc);
    fence_regs(ahi[0]);
    fence_regs(ahi[1]);
    fence_regs(alo[0]);
    fence_regs(alo[1]);
    __syncwarp();
    wgmma_fence();
    const uint64_t dkt = sw128_desc(sK + (j % NKB) * KB, BK * 128, 1024);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint64_t d = dkt + ((kk * 16 * 128) >> 4);
      wgmma_rs<HD>(acc, ahi[kk], d);
      wgmma_rs<HD>(acc, alo[kk], d);
    }
    wgmma_commit();

    wgmma_wait<1>();   // S(j + 1), dP(j + 1) done; dS(j)·K(j) runs on
    fence_regs(nxt);
    fence_regs(dpn);
    if (j + 1 < n_tiles) grad_of(nxt, dpn, tiles[j + 1], (j + 1) % NKB);
    wgmma_wait<0>();
    fence_regs(acc);
  };

  if (n_tiles > 0) {
    cp_async_tile<BQ, HD, NT>(sQ, q + qoff, q0, Tq, (size_t)H * HD, tid);
    cp_async_tile<BQ, HD, NT>(sDO, dout + qoff, q0, Tq, (size_t)H * HD,
                              tid);
    load_k(tiles[0], 0);
    load_v(tiles[0], 0);
    if (n_tiles > 1) {
      load_k(tiles[1], 1);
      load_v(tiles[1], 1);
    }
  }
  cp_async_commit();
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();
  if (n_tiles > 0) {
    issue_sdp(sa, pa, 0, 0);
    wgmma_wait<0>();
    fence_regs(sa);
    fence_regs(pa);
    grad_of(sa, pa, tiles[0], 0);
  }
  // two steps a turn, so that S(j + 1) lands where dS(j + 1) is read
  for (int j = 0; j < n_tiles; j += 2) {
    step(j, sa, sb, pb);
    if (j + 1 >= n_tiles) break;
    step(j + 1, sb, sa, pa);
  }
  cp_async_wait_all();

  // epilogue: acc[4 c + 2 i + u] is row tq_i, column 8 c + 2 tig + u
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tq = i ? tq1 : tq0;
    if (tq >= Tq) continue;
    __nv_bfloat16* orow = dq + ((size_t)(b * Tq + tq) * H + h) * HD + 2 * tig;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) =
          __floats2bfloat162_rn(acc[4 * c + 2 * i] * scale,
                                acc[4 * c + 2 * i + 1] * scale);
  }
}

template <int HD, bool COMPACT>
int launch_mma(const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* delta,
               const int* qb, const int* kb, const int* qp, const int* kp,
               void* dq, const int* tile_ptr, const int* tile_idx, int B,
               int Tq, int Tk, int H, int Hkv, float scale, float softcap,
               int window, cudaStream_t stream) {
  using T = __nv_bfloat16;
  const size_t smem = mma_smem<HD>(Tk);
  auto kern = bam_bwd_dq_mma_kernel<HD, COMPACT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, (Tq + BQ - 1) / BQ, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, qb,
      kb, qp, kp, static_cast<T*>(dq), tile_ptr, tile_idx, Tq, Tk, H, Hkv,
      scale, softcap, window);
  return (int)cudaGetLastError();
}

template <typename T, int HD, bool COMPACT>
int dispatch(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, const int* qb,
             const int* kb, const int* qp, const int* kp, void* dq,
             const int* tile_ptr, const int* tile_idx, int B, int Tq, int Tk,
             int H, int Hkv, float scale, float softcap, int window,
             cudaStream_t stream) {
  if constexpr (!wgmma_body<2, T, HD>())
    return launch<T, HD, COMPACT>(q, k, v, dout, lse, delta, qb, kb, qp, kp,
                                  dq, tile_ptr, tile_idx, B, Tq, Tk, H, Hkv,
                                  scale, softcap, window, stream);
  else
    return launch_mma<HD, COMPACT>(q, k, v, dout, lse, delta, qb, kb, qp, kp,
                                   dq, tile_ptr, tile_idx, B, Tq, Tk, H, Hkv,
                                   scale, softcap, window, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; hd 64, 80, 128 or 256 (bf16 at 64 and
// 128 on the wgmma body, the rest on the SIMT body; any other hd returns
// cudaErrorInvalidValue). q/dout/dq [B,Tq,H,hd], k/v
// [B,Tk,Hkv,hd], all contiguous; lse/delta f32 [B,H,Tq]; bits/pos int32
// [B,T]. With tile_ptr set, the compacted grid: int32 CSR rows tile_ptr
// [ceil(Tq/64)+1] and tile_idx (k tiles of 32 keys, ascending per row);
// both null for the dense grid. bf16 q, k, v and dout must start on 16
// bytes (16-byte cp.async rows), else cudaErrorMisalignedAddress.
// Returns cudaGetLastError() after the launch.
extern "C" int bam_bwd_dq(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, const void* q_bits,
                          const void* kv_bits, const void* q_pos,
                          const void* kv_pos, void* dq,
                          const void* tile_ptr, const void* tile_idx, int B,
                          int Tq, int Tk, int H, int Hkv, int hd, int dtype,
                          float scale, float softcap, int window,
                          void* stream) {
  const float* ls = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* qb = static_cast<const int*>(q_bits);
  const int* kb = static_cast<const int*>(kv_bits);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  const int* tp = static_cast<const int*>(tile_ptr);
  const int* ti = static_cast<const int*>(tile_idx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 &&
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) %
              16 != 0)
    return (int)cudaErrorMisalignedAddress;
#define BAM_DQ_CASE(TYPE, HD)                                                 \
  return tp != nullptr                                                        \
             ? dispatch<TYPE, HD, true>(q, k, v, dout, ls, dl, qb, kb, qp,    \
                                        kp, dq, tp, ti, B, Tq, Tk, H, Hkv,    \
                                        scale, softcap, window, st)           \
             : dispatch<TYPE, HD, false>(q, k, v, dout, ls, dl, qb, kb, qp,   \
                                         kp, dq, nullptr, nullptr, B, Tq, Tk, \
                                         H, Hkv, scale, softcap, window, st)
  if (dtype == 0 && hd == 64) BAM_DQ_CASE(float, 64);
  if (dtype == 0 && hd == 80) BAM_DQ_CASE(float, 80);
  if (dtype == 0 && hd == 128) BAM_DQ_CASE(float, 128);
  if (dtype == 0 && hd == 256) BAM_DQ_CASE(float, 256);
  if (dtype == 1 && hd == 64) BAM_DQ_CASE(__nv_bfloat16, 64);
  if (dtype == 1 && hd == 80) BAM_DQ_CASE(__nv_bfloat16, 80);
  if (dtype == 1 && hd == 128) BAM_DQ_CASE(__nv_bfloat16, 128);
  if (dtype == 1 && hd == 256) BAM_DQ_CASE(__nv_bfloat16, 256);
#undef BAM_DQ_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* bam_bwd_dq_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
