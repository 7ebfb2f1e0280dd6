// BAM flash-attention backward, dK/dV half (K3), for Hopper, sm_90a.
//
// Replaces the dK/dV pallas_call of the Pallas TPU kernel
// repro/kernels/bam_attention.py::bam_flash_attention_bwd on its dense
// (transposed) grid (_bam_bwd_dkv_kernel :599, _dkv_accumulate,
// _recompute_p_ds, mask _mask_tile) and the GQA fold after it, and on
// its block_map grid (_bam_bwd_dkv_kernel_sparse, pallas_call :667).
//
// What bounds it on this card: per allowed (query, key) pair it does
// four hd-long products (S = Q·K, dP = dO·V, dV += P·dO, dK += dS·Q) on
// O(T·H·hd) bytes, so at the train path's T = 1600 it is bound by
// operations, 989 TFLOP/s of bf16 tensor cores.
//
// Both types fold GQA inside the kernel: a block owns keys of one KV
// head and loops over the H / Hkv query heads that share it, in a fixed
// order, keeping dK and dV in registers. No atomics: dK / dV are the
// same bits from run to run (the TPU kernel wrote per-q-head f32 and
// summed outside). P is recomputed as exp(s - lse) and selected to 0 on
// masked pairs (an empty row's lse is -1e30, where exp overflows), so
// such rows add nothing; dS = P (dP - delta), times 1 - (x/cap)^2 of
// the capped logit x under a softcap. The mask decides which q tiles to
// skip, never position alone, because a modality's queries attend both
// ways within their stream. Ragged Tq and Tk load as zeros with bits 0.
//
// bf16 at hd 64, 80, 128 and 256 (the wgmma body): K2's design
// transposed, keys as wgmma's M. One warpgroup of 128 threads (two at hd
// 256, below) owns 64 keys (two of the block map's 32-key columns) of one
// KV head and loops over its query heads and, for each, over 32-row q
// tiles:
//  - S^T = K·Q^T and dP^T = V·dO^T are wgmma m64n32k16 with K and V
//    resident and the q tile's Q and dO in shared memory (bam_mma.cuh's
//    128-byte swizzle), loaded by cp.async with the rows' bits,
//    positions, lse and delta (per column of the fragment now).
//  - P^T and dS^T run in f32 on the fragments (2 keys x 8 q rows a
//    thread), masked per pair by bam_mask.cuh's rule split into its key
//    part (registers) and query part (shared memory); a tile every key
//    allows whole skips the mask.
//  - dV += P^T·dO and dK += dS^T·Q are wgmma m64n{hd}k16 with the A
//    operand from registers and dO and Q (the same swizzled [rows][hd]
//    tiles, read MN-major) in shared memory. The TPU kernel multiplies
//    f32 P and dS; rounded once to bf16 they leave dV 8-44x and dK
//    10-26x over the one-bf16-ulp check, so both are split as x_hi =
//    bf16(x), x_lo = bf16(x - x_hi) (worst |d|/tol 0.049 and 0.039 by
//    the CPU emulation in tests/test_torch_bwd_split.py): six products a
//    tile where a plain flash backward has four.
//  - Step j issues S^T(j + 1) and dP^T(j + 1), then the products of j,
//    and computes P^T(j + 1), dS^T(j + 1) while those run (as K2 does);
//    no wgmma stays in flight across steps. Step j's tile is read by its
//    products while S^T(j + 1) reads the next and step j + 2's lands, so
//    Q and dO take three buffers each: ~83 KB a block at hd 128. The
//    split fragments of j take the place of its S^T / dP^T, so dK and dV
//    (128 f32 a thread at hd 128), two tiles' S^T / dP^T and the
//    fragments fit one warpgroup: ptxas gives 255 registers and no spill
//    (on an H100 this overlap took K3 from 0.239 to 0.217 ms at the vlm
//    layout; this body takes its warp index without hd 256's
//    warpgroup split, which spilled 16 bytes). Two blocks share an SM. The grid runs KV heads fastest and
//    the first keys first: under a causal mask those see the most q
//    rows, and blocks i and i + (number of SMs), which tend to share an
//    SM, pair a long block with a short one.
//  - hd 80 runs on bam_mma.cuh's layout padded to 128: chunks 10-15 of
//    each K, V, Q and dO row are zeros written by cp.async with no
//    global read, S^T and dP^T take 5 k16 steps each (the zero tail adds
//    nothing), the products run at N 128 on the padded tiles (the hd 128
//    body's 255 registers and ~83 KB), and only the 80 real columns of
//    dK and dV are stored.
//  - hd 256 (two consumer warpgroups, 256 threads): dK and
//    dV of 64 keys x 256 columns are 256 f32 a thread in one warpgroup,
//    which cannot fit. Warpgroup w owns columns [128 w, 128 w + 128) of
//    both, 128 accumulators a thread, the hd 128 body's budget, and
//    computes S^T and dP^T whole itself (16 + 16 k16 steps over all 256
//    columns), so the two warpgroups share nothing but the tiles and the
//    block's barriers, and each key's sums run in the same order as in
//    one warpgroup: dK and dV keep the same bits from run to run, with no
//    atomics. The price is S^T and dP^T twice (8 products a tile where
//    the split needs 6). Two passes (dV, then dK) would hold 128
//    accumulators in one warpgroup too, but compute S^T twice all the
//    same, read Q twice, and run 128 threads an SM, against 256 here.
//    K and V resident (64 KB) and three buffers each of Q and dO (96
//    KB): ~163 KB, one block an SM (registers: 256 x 255). Here the
//    products of step j finish before P^T(j + 1) and dS^T(j + 1) are
//    computed: with their A fragments (32 registers) live beside that
//    arithmetic ptxas spills, without the overlap it spills nothing (on
//    an H100 it ran 0.718 ms at gemma2-9b's heads, T 2048, against 0.739
//    with the overlap and a 52-byte spill). The K and V descriptors of each k16 step are
//    formed where they are used (bam_mma.cuh::desc_add): hoisted out of
//    the loop, all 32 of them add to the spill.
//  - Before the loop the block lists the q tiles to compute from bits
//    alone (bam_tiles.cuh: the keys' summary against each tile's rows),
//    so a skipped tile costs no load.
//  - The compacted grid walks one row of a 64-key CSR (core/bam.py::
//    block_csr, k64_ptr / k64_rows: the ascending union of the two
//    columns' q blocks, each entry 4 q block + a flag per 32-key half),
//    each q block as two 32-row tiles. A warp whose half's column does
//    not list the q block masks all its pairs there, so a pruned map
//    drops them as the plain version does. A tile the summary keeps but
//    no pair of which is allowed adds exact zeros, so for a map that
//    covers the mask K3c writes dense K3's bits.
//
// The SIMT body (float32 at every head size) keeps the first design
// unchanged: f32 FMAs out of padded shared memory. At hd 256 a thread
// keeps 64 columns each of dK and dV in registers and a block takes
// 140,544 bytes of shared memory. One block owns one (32-key tile, KV
// head, batch row); four threads share a key: in the score phase each computes
// the (S, dP) pairs of 8 of the tile's 32 q rows; in the product phase
// each owns every fourth dK and dV column. A q tile with no allowed pair
// for this key tile is skipped after reading only its bits and
// positions. Its compacted grid walks the 64-row q blocks of CSR row j
// of the map's k-major list (core/bam.py::block_csr, k_ptr / k_rows),
// each as two of its own 32-row q tiles (a second tile past Tq has bits
// 0 and is skipped), for every query head of its KV head, so for a map
// that covers the mask dK/dV are the dense kernel's to the bit, and a k
// tile with no active q block writes 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bam_mask.cuh"
#include "bam_mma.cuh"
#include "bam_tiles.cuh"

namespace {

constexpr int BK = 32;      // f32: keys per block
constexpr int BQ = 32;      // q rows per inner tile
constexpr int NT = 128;     // threads per block (f32: four per key)
constexpr int IR = BQ / 4;  // q rows per thread in the score phase
constexpr int MAP_BQ = 64;  // q rows per block of the block map

// SIMT body: four threads per key, f32 FMAs.
// COMPACT = true: walk the q blocks of CSR row blockIdx.x of (tile_ptr
// [nk+1], tile_idx) only, MAP_BQ / BQ tiles each; COMPACT = false: every
// q tile (both null).
template <typename T, int HD, bool COMPACT>
__global__ void __launch_bounds__(NT)
bam_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   const int* __restrict__ qbits,
                   const int* __restrict__ kbits,
                   const int* __restrict__ qpos, const int* __restrict__ kpos,
                   T* __restrict__ dk, T* __restrict__ dv,
                   const int* __restrict__ tile_ptr,
                   const int* __restrict__ tile_idx, int Tq, int Tk, int H,
                   int Hkv, float scale, float softcap, int window) {
  static_assert(MAP_BQ % BQ == 0, "a map q block is whole q tiles");
  static_assert(HD % 4 == 0, "four threads split a key's columns");
  constexpr int SUB = MAP_BQ / BQ;
  constexpr int LD = HD + 1;
  constexpr int NC = HD / 4;  // dK and dV columns per thread
  extern __shared__ float smem[];
  float* sK = smem;               // [BK][LD]
  float* sV = sK + BK * LD;       // [BK][LD]
  float* sQ = sV + BK * LD;       // [BQ][LD]
  float* sDO = sQ + BQ * LD;      // [BQ][LD]
  float* sP = sDO + BQ * LD;      // [BQ][BK + 1]
  float* sDS = sP + BQ * (BK + 1);  // [BQ][BK + 1]
  float* sLse = sDS + BQ * (BK + 1);  // [BQ]
  float* sDelta = sLse + BQ;          // [BQ]
  int* sQb = reinterpret_cast<int*>(sDelta + BQ);  // [BQ]
  int* sQp = sQb + BQ;                              // [BQ]

  const int tid = threadIdx.x;
  const int j = tid >> 2, quarter = tid & 3;
  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int n_rep = H / Hkv;

  for (int i = tid; i < BK * HD; i += NT) {
    const int row = i / HD, d = i % HD, t = k0 + row;
    const size_t off = ((size_t)(b * Tk + t) * Hkv + hk) * HD + d;
    sK[row * LD + d] = t < Tk ? to_f(k[off]) : 0.f;
    sV[row * LD + d] = t < Tk ? to_f(v[off]) : 0.f;
  }
  const int tk = k0 + j;
  const bool live = tk < Tk;
  const unsigned kb = live ? (unsigned)kbits[(size_t)b * Tk + tk] : 0u;
  const int kp = live ? kpos[(size_t)b * Tk + tk] : -1;

  float adk[NC], adv[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) adk[c] = adv[c] = 0.f;

  // the q tiles this block visits, ascending: all of them, or SUB per q
  // block of its CSR row of the block map
  int it_beg = 0, it_end = (Tq + BQ - 1) / BQ;
  if constexpr (COMPACT) {
    it_beg = SUB * tile_ptr[blockIdx.x];
    it_end = SUB * tile_ptr[blockIdx.x + 1];
  }
  for (int rep = 0; rep < n_rep; ++rep) {
    const int h = hk * n_rep + rep;
    for (int it = it_beg; it < it_end; ++it) {
      const int q0 = COMPACT ? tile_idx[it / SUB] * MAP_BQ + (it % SUB) * BQ
                             : it * BQ;
      if (tid < BQ) {
        const int t = q0 + tid;
        const size_t row_off = ((size_t)b * H + h) * Tq + t;
        sQb[tid] = t < Tq ? qbits[(size_t)b * Tq + t] : 0;
        sQp[tid] = t < Tq ? qpos[(size_t)b * Tq + t] : -1;
        sLse[tid] = t < Tq ? lse[row_off] : 0.f;
        sDelta[tid] = t < Tq ? delta[row_off] : 0.f;
      }
      __syncthreads();
      unsigned ok = 0;
#pragma unroll
      for (int i = 0; i < IR; ++i) {
        const int row = quarter + 4 * i;
        if (allowed((unsigned)sQb[row], kb, sQp[row], kp, window))
          ok |= 1u << i;
      }
      // block skip: a q tile with no allowed pair is not even loaded
      // (the barrier also orders this tile's reads before the next
      // tile's writes)
      if (!__syncthreads_or(ok != 0u)) continue;

      for (int i = tid; i < BQ * HD; i += NT) {
        const int row = i / HD, d = i % HD, t = q0 + row;
        const size_t off = ((size_t)(b * Tq + t) * H + h) * HD + d;
        sQ[row * LD + d] = t < Tq ? to_f(q[off]) : 0.f;
        sDO[row * LD + d] = t < Tq ? to_f(dout[off]) : 0.f;
      }
      __syncthreads();

      float s[IR], dp[IR];
#pragma unroll
      for (int i = 0; i < IR; ++i) s[i] = dp[i] = 0.f;
      const float* krow = sK + j * LD;
      const float* vrow = sV + j * LD;
      for (int d = 0; d < HD; ++d) {
        const float kv = krow[d], vv = vrow[d];
#pragma unroll
        for (int i = 0; i < IR; ++i) {
          const int row = quarter + 4 * i;
          s[i] = fmaf(sQ[row * LD + d], kv, s[i]);
          dp[i] = fmaf(sDO[row * LD + d], vv, dp[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < IR; ++i) {
        const int row = quarter + 4 * i;
        float x = s[i] * scale, chain = 1.f;
        if (softcap != 0.f) {
          x = tanhf(x / softcap) * softcap;
          chain = 1.f - (x / softcap) * (x / softcap);
        }
        float p = 0.f, ds = 0.f;
        if ((ok >> i) & 1u) {
          p = expf(x - sLse[row]);
          ds = p * (dp[i] - sDelta[row]) * chain;
        }
        sP[row * (BK + 1) + j] = p;
        sDS[row * (BK + 1) + j] = ds;
      }
      __syncthreads();

      for (int i = 0; i < BQ; ++i) {
        const float p = sP[i * (BK + 1) + j];
        const float ds = sDS[i * (BK + 1) + j];
        const float* qi = sQ + i * LD + quarter;
        const float* gi = sDO + i * LD + quarter;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          adv[c] = fmaf(p, gi[4 * c], adv[c]);
          adk[c] = fmaf(ds, qi[4 * c], adk[c]);
        }
      }
      __syncthreads();
    }
  }

  if (!live) return;
  const size_t off = ((size_t)(b * Tk + tk) * Hkv + hk) * HD + quarter;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    store(dk + off + 4 * c, adk[c] * scale);
    store(dv + off + 4 * c, adv[c]);
  }
}

template <typename T, int HD, bool COMPACT>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, const int* qb,
           const int* kb, const int* qp, const int* kp, void* dk, void* dv,
           const int* tile_ptr, const int* tile_idx, int B, int Tq, int Tk,
           int H, int Hkv, float scale, float softcap, int window,
           cudaStream_t stream) {
  constexpr int LD = HD + 1;
  constexpr size_t smem =
      sizeof(float) * (2 * BK * LD + 2 * BQ * LD + 2 * BQ * (BK + 1) +
                       2 * BQ) +
      sizeof(int) * 2 * BQ;
  static_assert(smem <= MAX_BLOCK_SMEM,
                "K3's SIMT body does not fit a block's shared memory");
  auto kern = bam_bwd_dkv_kernel<T, HD, COMPACT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tk + BK - 1) / BK, Hkv, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, qb,
      kb, qp, kp, static_cast<T*>(dk), static_cast<T*>(dv), tile_ptr,
      tile_idx, Tq, Tk, H, Hkv, scale, softcap, window);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: wgmma on swizzled shared-memory tiles (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int MMA_BK = 64;   // keys per block: wgmma's M
constexpr int NQB = 3;       // buffers each of Q and dO, with their rows

// consumer warpgroups of the bf16 kernel: two at hd 256, each owning 128
// of dK's and dV's columns
__host__ __device__ constexpr int mma_wgs(int hd) {
  return hd == 256 ? 2 : 1;
}

// shared memory of the bf16 kernel: K, V, the Q and dO buffers, the
// rows' bits, positions, lse and delta per buffer, the keys' summary,
// two bits per candidate q tile (compute it; every pair allowed), the
// list of tiles to compute, and room to align the tiles to 1024 bytes
template <int HD>
size_t mma_dkv_smem(int Tq) {
  constexpr int HP = padded_hd(HD);
  const int nq = 2 * ((Tq + MAP_BQ - 1) / MAP_BQ);   // candidate q tiles
  return 1024 + 2 * MMA_BK * HP * 2 + 2 * NQB * BQ * HP * 2 +
         NQB * 4 * BQ * sizeof(int) + mma_wgs(HD) * 32 * sizeof(int) +
         2 * ((nq + 31) / 32) * sizeof(unsigned) + (nq + 1) * sizeof(int);
}

// COMPACT = true: walk row blockIdx.y of the 64-key CSR (tile_ptr
// [ceil(Tk/64)+1], tile_idx: 4 q block + half flags); COMPACT = false:
// every q tile (both null).
template <int HD, bool COMPACT>
__global__ void __launch_bounds__(NT * mma_wgs(HD))
bam_bwd_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const __nv_bfloat16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const int* __restrict__ qbits,
                       const int* __restrict__ kbits,
                       const int* __restrict__ qpos,
                       const int* __restrict__ kpos,
                       __nv_bfloat16* __restrict__ dk,
                       __nv_bfloat16* __restrict__ dv,
                       const int* __restrict__ tile_ptr,
                       const int* __restrict__ tile_idx, int Tq, int Tk,
                       int H, int Hkv, float scale, float softcap,
                       int window) {
  static_assert(MAP_BQ == 2 * BQ, "a map q block is two q tiles");
  constexpr int HP = padded_hd(HD);     // head size of the tile layout
  constexpr int NWG = mma_wgs(HD);      // warpgroups
  constexpr int MT = NT * NWG;          // threads
  constexpr int HN = HP / NWG;          // dK (and dV) columns a warpgroup
  constexpr int KT = MMA_BK * HP * 2;   // bytes of the K (or V) tile
  constexpr int QT = BQ * HP * 2;       // bytes of one Q (or dO) tile
  constexpr int NO = HN / 2;            // dK (and dV) values per thread
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sK = smem_u32(sm);        // [MMA_BK][HP] swizzled
  const uint32_t sV = sK + KT;             // [MMA_BK][HP]
  const uint32_t sQ = sV + KT;             // NQB x [BQ][HP]
  const uint32_t sDO = sQ + NQB * QT;      // NQB x [BQ][HP]
  // per buffer: the rows' bits, positions, lse and delta, [4][BQ]
  int* sRows = reinterpret_cast<int*>(sm + 2 * KT + 2 * NQB * QT);
  int* sSum = sRows + NQB * 4 * BQ;        // [4 NWG warps][8]
  unsigned* sAct = reinterpret_cast<unsigned*>(sSum + NWG * 32);

  // warp: the warp within its warpgroup wg, which owns dK's and dV's
  // columns [wg HN, wg HN + HN); both warpgroups compute the same S^T,
  // dP^T, P^T and dS^T
  const int tid = threadIdx.x, wg = NWG == 1 ? 0 : tid / NT;
  const int warp = (NWG == 1 ? tid : tid % NT) >> 5;
  const int lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int kt = blockIdx.y, k0 = kt * MMA_BK;
  const int hk = blockIdx.x, b = blockIdx.z;
  const int n_rep = H / Hkv;
  const int* qb_row = qbits + (size_t)b * Tq;
  const int* qp_row = qpos + (size_t)b * Tq;

  // this thread's two keys (rows of the accumulator fragments) and their
  // part of the mask rule
  const int tk0 = k0 + warp * 16 + g, tk1 = tk0 + 8;
  const KeyRule kr0 = key_rule(
      tk0 < Tk ? (unsigned)kbits[(size_t)b * Tk + tk0] : 0u,
      tk0 < Tk ? kpos[(size_t)b * Tk + tk0] : -1);
  const KeyRule kr1 = key_rule(
      tk1 < Tk ? (unsigned)kbits[(size_t)b * Tk + tk1] : 0u,
      tk1 < Tk ? kpos[(size_t)b * Tk + tk1] : -1);

  // the q tiles this block may visit, ascending: entry e is q tile e
  // (both halves listed), or tile e % 2 of the (e / 2)-th q block of its
  // CSR row with that entry's half flags; those to compute, listed from
  // bits alone (bam_tiles.cuh)
  int e_beg = 0, n_ent = (Tq + BQ - 1) / BQ;
  if constexpr (COMPACT) {
    e_beg = tile_ptr[kt];
    n_ent = 2 * (tile_ptr[kt + 1] - e_beg);
  }
  const int n_words = (n_ent + 31) / 32;
  int* sList = reinterpret_cast<int*>(sAct + 2 * n_words);  // [count, tiles]
  auto item_of = [&](int e) {
    if constexpr (COMPACT) {
      const int ent = tile_idx[e_beg + (e >> 1)];
      return (2 * (ent >> 2) + (e & 1)) | ((ent & 3) << 28);
    } else {
      return e | (3 << 28);
    }
  };
  for (int i = tid; i < 2 * n_words; i += MT) sAct[i] = 0u;
  const KeysSummary ks = summarize_keys(kbits + (size_t)b * Tk,
                                        kpos + (size_t)b * Tk, k0, Tk, sSum,
                                        tid);
  list_tiles<4 * NWG>(ks, n_ent, item_of, qb_row, qp_row, Tq, window, sAct,
                      sList, tid);
  const int n_tiles = sList[0];
  const int* items = sList + 1;
  const int n_steps = n_rep * n_tiles;   // (query head, q tile), in order

  // Q, dO and the rows' bits, positions, lse and delta of step s
  auto load_q = [&](int s, int st) {
    const int rep = s / n_tiles;
    const int h = hk * n_rep + rep;
    const int q0 = (items[s - rep * n_tiles] & ITEM_TILE) * BQ;
    const size_t qoff = ((size_t)b * Tq * H + h) * HD;
    cp_async_tile<BQ, HD, MT>(sQ + st * QT, q + qoff, q0, Tq, (size_t)H * HD,
                              tid);
    cp_async_tile<BQ, HD, MT>(sDO + st * QT, dout + qoff, q0, Tq,
                              (size_t)H * HD, tid);
    if (NWG == 1 || tid < NT) {   // one value a thread, warp w its w-th row
      const int t = q0 + lane;
      const size_t row = ((size_t)b * H + h) * Tq + t;
      const void* src = warp == 0   ? static_cast<const void*>(qb_row + t)
                        : warp == 1 ? static_cast<const void*>(qp_row + t)
                        : warp == 2 ? static_cast<const void*>(lse + row)
                                    : static_cast<const void*>(delta + row);
      cp_async_4(smem_u32(sRows + st * 4 * BQ + tid), t < Tq ? src : qb_row,
                 t < Tq ? 4 : 0);
    }
  };
  // wgmma descriptors: K and V as A; Q and dO as K-major B (S^T, dP^T)
  // and MN-major B (dS^T·Q, P^T·dO: next 64 hd values 32 rows x 128
  // bytes on, next 8 q rows 1024 bytes on)
  const uint64_t dKa = sw128_desc(sK, 16, 1024);
  const uint64_t dVa = sw128_desc(sV, 16, 1024);

  // P^T and dS^T of a tile (rows in buffer st) on the fragments, into pf
  // and df (S^T and dP^T on entry): pf[4 c + 2 i + u] is key tk_i, q row
  // 8 c + 2 tig + u of the tile. Masked pairs (and, on the compacted
  // grid, every pair of a warp whose 32-key half does not list the q
  // block) select 0.
  auto grad = [&](float (&pf)[16], float (&df)[16], int item, int st,
                  auto full_tag) {
    constexpr bool FULL = decltype(full_tag)::value;
    const int* rows = sRows + st * 4 * BQ;
    bool ok[16];
    if constexpr (!FULL) {
      fragment_mask_t(ok, kr0, kr1, rows, rows + BQ, window, tig);
      if (!((item >> (28 + (warp >> 1))) & 1)) {
#pragma unroll
        for (int i = 0; i < 16; ++i) ok[i] = false;
      }
    }
    const float* ls = reinterpret_cast<const float*>(rows + 2 * BQ);
    const float* dl = reinterpret_cast<const float*>(rows + 3 * BQ);
    float nb[8], dlt[8];   // column 2 c + u: q row 8 c + 2 tig + u
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * c + 2 * tig);
      const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * c + 2 * tig);
      nb[2 * c] = -l2.x * LOG2E;
      nb[2 * c + 1] = -l2.y * LOG2E;
      dlt[2 * c] = d2.x;
      dlt[2 * c + 1] = d2.y;
    }
    if (softcap != 0.f) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int col = 2 * (i >> 2) + (i & 1);
        const float x = tanhf(pf[i] * scale / softcap) * softcap;
        const float t = x / softcap;
        const float p = ex2(fmaf(x, LOG2E, nb[col]));
        const float ds = p * (df[i] - dlt[col]) * (1.f - t * t);
        pf[i] = (FULL || ok[i]) ? p : 0.f;
        df[i] = (FULL || ok[i]) ? ds : 0.f;
      }
    } else {
      const float cl = scale * LOG2E;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int col = 2 * (i >> 2) + (i & 1);
        const float p = ex2(fmaf(pf[i], cl, nb[col]));
        const float ds = p * (df[i] - dlt[col]);
        pf[i] = (FULL || ok[i]) ? p : 0.f;
        df[i] = (FULL || ok[i]) ? ds : 0.f;
      }
    }
  };

  // S^T = K Q^T and dP^T = V dO^T of the q tile in buffer st
  auto issue_sdp = [&](float (&sp)[16], float (&sd)[16], int st) {
    const uint64_t dq_k = sw128_desc(sQ + st * QT, 16, 1024);
    const uint64_t ddo_k = sw128_desc(sDO + st * QT, 16, 1024);
    fence_regs(sp);
    fence_regs(sd);
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t oa = (kk >> 2) * (MMA_BK * 128) + (kk & 3) * 32;
      const uint32_t ob = (kk >> 2) * (BQ * 128) + (kk & 3) * 32;
      wgmma_m64n32k16_ss(sp, desc_add(dKa, oa >> 4), dq_k + (ob >> 4), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t oa = (kk >> 2) * (MMA_BK * 128) + (kk & 3) * 32;
      const uint32_t ob = (kk >> 2) * (BQ * 128) + (kk & 3) * 32;
      wgmma_m64n32k16_ss(sd, desc_add(dVa, oa >> 4), ddo_k + (ob >> 4), kk > 0);
    }
    wgmma_commit();
  };
  auto grad_of = [&](float (&pf)[16], float (&df)[16], int s, int st) {
    const int item = items[s % n_tiles];
    if (item < 0 && ((item >> 28) & 3) == 3)   // every pair allowed
      grad(pf, df, item, st, std::true_type{});
    else
      grad(pf, df, item, st, std::false_type{});
  };

  float adk[NO], adv[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) adk[i] = adv[i] = 0.f;
  float pa[16], da[16], pb[16], db[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) pa[i] = da[i] = pb[i] = db[i] = 0.f;
  uint32_t phi[2][4], plo[2][4], shi[2][4], slo[2][4];

  // step j: P^T(j), dS^T(j) are in (cp, cd); S^T(j + 1), dP^T(j + 1) go
  // to (np, nd). Step j's q tile sits in buffer j % 3: it is read by the
  // products of j while S^T(j + 1) reads buffer (j + 1) % 3 and step j +
  // 2's tile lands in the third.
  auto step = [&](int j, float (&cp)[16], float (&cd)[16], float (&np)[16],
                  float (&nd)[16]) {
    // step j + 1's tile has landed; every thread is done with buffer
    // (j + 2) % 3 (the products of j - 1)
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    if (j + 2 < n_steps) load_q(j + 2, (j + 2) % NQB);
    cp_async_commit();
    // S^T(j + 1), dP^T(j + 1); the last step issues them too, on
    // whatever the buffer holds, and drops them, so every step has the
    // same wgmma groups
    issue_sdp(np, nd, (j + 1) % NQB);

    // dV += P^T_hi dO + P^T_lo dO, dK += dS^T_hi Q + dS^T_lo Q: two k16
    // steps of 16 q rows
    split_a(cp, phi[0], plo[0]);
    split_a(cp + 8, phi[1], plo[1]);
    split_a(cd, shi[0], slo[0]);
    split_a(cd + 8, shi[1], slo[1]);
    fence_regs(adk);
    fence_regs(adv);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      fence_regs(phi[kk]);
      fence_regs(plo[kk]);
      fence_regs(shi[kk]);
      fence_regs(slo[kk]);
    }
    __syncwarp();
    wgmma_fence();
    const int st = j % NQB;
    // this warpgroup's columns start HN / 64 column blocks into the tile
    const uint32_t cols = st * QT + wg * (HN / 64) * (BQ * 128);
    const uint64_t ddo_n = sw128_desc(sDO + cols, BQ * 128, 1024);
    const uint64_t dq_n = sw128_desc(sQ + cols, BQ * 128, 1024);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint32_t o = (kk * 16 * 128) >> 4;
      wgmma_rs<HN>(adv, phi[kk], ddo_n + o);
      wgmma_rs<HN>(adv, plo[kk], ddo_n + o);
      wgmma_rs<HN>(adk, shi[kk], dq_n + o);
      wgmma_rs<HN>(adk, slo[kk], dq_n + o);
    }
    wgmma_commit();

    // S^T(j + 1), dP^T(j + 1) done; the products run on beside the
    // gradient's arithmetic, except at hd 256, where their A registers
    // beside it would not fit: there they finish first
    if constexpr (NWG == 1)
      wgmma_wait<1>();
    else
      wgmma_wait<0>();
    fence_regs(np);
    fence_regs(nd);
    if (j + 1 < n_steps) grad_of(np, nd, j + 1, (j + 1) % NQB);
    wgmma_wait<0>();
    fence_regs(adk);
    fence_regs(adv);
  };

  if (n_steps > 0) {
    cp_async_tile<MMA_BK, HD, MT>(sK, k + ((size_t)b * Tk * Hkv + hk) * HD,
                                  k0, Tk, (size_t)Hkv * HD, tid);
    cp_async_tile<MMA_BK, HD, MT>(sV, v + ((size_t)b * Tk * Hkv + hk) * HD,
                                  k0, Tk, (size_t)Hkv * HD, tid);
    load_q(0, 0);
    if (n_steps > 1) load_q(1, 1);
  }
  cp_async_commit();
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();
  if (n_steps > 0) {
    issue_sdp(pa, da, 0);
    wgmma_wait<0>();
    fence_regs(pa);
    fence_regs(da);
    grad_of(pa, da, 0, 0);
  }
  // two steps a turn, so that S^T(j + 1) lands where step j + 1 reads it
  for (int j = 0; j < n_steps; j += 2) {
    step(j, pa, da, pb, db);
    if (j + 1 >= n_steps) break;
    step(j + 1, pb, db, pa, da);
  }
  cp_async_wait_all();

  // epilogue: adk[4 c + 2 i + u] is key tk_i, column wg HN + 8 c + 2 tig
  // + u; the columns past HD (hd 80's padding) are not stored
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tk = i ? tk1 : tk0;
    if (tk >= Tk) continue;
    const size_t off =
        ((size_t)(b * Tk + tk) * Hkv + hk) * HD + wg * HN + 2 * tig;
#pragma unroll
    for (int c = 0; c < (HN < HD ? HN : HD) / 8; ++c) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * c) =
          __floats2bfloat162_rn(adk[4 * c + 2 * i] * scale,
                                adk[4 * c + 2 * i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * c) =
          __floats2bfloat162_rn(adv[4 * c + 2 * i], adv[4 * c + 2 * i + 1]);
    }
  }
}

template <int HD, bool COMPACT>
int launch_mma(const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* delta,
               const int* qb, const int* kb, const int* qp, const int* kp,
               void* dk, void* dv, const int* tile_ptr, const int* tile_idx,
               int B, int Tq, int Tk, int H, int Hkv, float scale,
               float softcap, int window, cudaStream_t stream) {
  using T = __nv_bfloat16;
  const size_t smem = mma_dkv_smem<HD>(Tq);
  auto kern = bam_bwd_dkv_mma_kernel<HD, COMPACT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hkv, (Tk + MMA_BK - 1) / MMA_BK, B);
  kern<<<grid, NT * mma_wgs(HD), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, qb,
      kb, qp, kp, static_cast<T*>(dk), static_cast<T*>(dv), tile_ptr,
      tile_idx, Tq, Tk, H, Hkv, scale, softcap, window);
  return (int)cudaGetLastError();
}

template <typename T, int HD, bool COMPACT>
int dispatch(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, const int* qb,
             const int* kb, const int* qp, const int* kp, void* dk, void* dv,
             const int* tile_ptr, const int* tile_idx, int B, int Tq, int Tk,
             int H, int Hkv, float scale, float softcap, int window,
             cudaStream_t stream) {
  if constexpr (!wgmma_body<T, HD>())
    return launch<T, HD, COMPACT>(q, k, v, dout, lse, delta, qb, kb, qp, kp,
                                  dk, dv, tile_ptr, tile_idx, B, Tq, Tk, H,
                                  Hkv, scale, softcap, window, stream);
  else
    return launch_mma<HD, COMPACT>(q, k, v, dout, lse, delta, qb, kb, qp, kp,
                                   dk, dv, tile_ptr, tile_idx, B, Tq, Tk, H,
                                   Hkv, scale, softcap, window, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/dout [B,Tq,H,hd], k/v/dk/dv
// [B,Tk,Hkv,hd], all contiguous; lse/delta f32 [B,H,Tq]; bits/pos int32
// [B,T]; hd 64, 80, 128 or 256 (bf16 on the wgmma body, f32 on the SIMT
// body; any other hd returns cudaErrorInvalidValue).
// dK/dV come out folded over the H / Hkv query heads of each KV head.
// With tile_ptr set, the compacted grid: int32 CSR rows (q blocks of 64
// rows, ascending per row), for the SIMT body the map's k-major list
// (core/bam.py::block_csr k_ptr [ceil(Tk/32)+1], k_rows), for the wgmma
// body its 64-key list (k64_ptr [ceil(Tk/64)+1], k64_rows: 4 q block +
// half flags); both null for the dense grid. bf16 q, k, v and dout must start
// on 16 bytes (16-byte cp.async rows), else cudaErrorMisalignedAddress.
// Returns cudaGetLastError() after the launch.
extern "C" int bam_bwd_dkv(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, const void* q_bits,
                           const void* kv_bits, const void* q_pos,
                           const void* kv_pos, void* dk, void* dv,
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
#define BAM_DKV_CASE(TYPE, HD)                                                \
  return tp != nullptr                                                        \
             ? dispatch<TYPE, HD, true>(q, k, v, dout, ls, dl, qb, kb, qp,    \
                                        kp, dk, dv, tp, ti, B, Tq, Tk, H,     \
                                        Hkv, scale, softcap, window, st)      \
             : dispatch<TYPE, HD, false>(q, k, v, dout, ls, dl, qb, kb, qp,   \
                                         kp, dk, dv, nullptr, nullptr, B, Tq, \
                                         Tk, H, Hkv, scale, softcap, window,  \
                                         st)
  if (dtype == 0 && hd == 64) BAM_DKV_CASE(float, 64);
  if (dtype == 0 && hd == 80) BAM_DKV_CASE(float, 80);
  if (dtype == 0 && hd == 128) BAM_DKV_CASE(float, 128);
  if (dtype == 0 && hd == 256) BAM_DKV_CASE(float, 256);
  if (dtype == 1 && hd == 64) BAM_DKV_CASE(__nv_bfloat16, 64);
  if (dtype == 1 && hd == 80) BAM_DKV_CASE(__nv_bfloat16, 80);
  if (dtype == 1 && hd == 128) BAM_DKV_CASE(__nv_bfloat16, 128);
  if (dtype == 1 && hd == 256) BAM_DKV_CASE(__nv_bfloat16, 256);
#undef BAM_DKV_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* bam_bwd_dkv_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
