// BAM flash-attention backward, dK/dV half (K3), for Hopper, sm_90a.
//
// Replaces the dK/dV pallas_call of the Pallas TPU kernel
// repro/kernels/bam_attention.py::bam_flash_attention_bwd on its dense
// (transposed) grid (_bam_bwd_dkv_kernel, _dkv_accumulate,
// _recompute_p_ds, mask _mask_tile), and the GQA fold after it.
//
// What bounds it on this card: per allowed (query, key) pair it does
// four hd-long products (S = Q·K, dP = dO·V, dV += P·dO, dK += dS·Q) on
// O(T·H·hd) bytes, so at the train path's T = 1600 it is bound by
// operations. Plain f32 FMAs out of shared memory, as K1 and K2; the
// tensor cores are a later change.
//
// Design. One block owns one (32-key tile, KV head, batch row) and loops
// over the H / Hkv query heads that share its KV head and over all
// 32-row q tiles of each, keeping dK and dV of its keys in registers. So
// GQA is folded inside the kernel in a fixed order: no atomics, and dK /
// dV are the same bits from run to run (the TPU kernel wrote per-q-head
// f32 and summed outside). P is recomputed as exp(s - lse) and selected
// to 0 on masked pairs (an empty row's lse is -1e30, where exp
// overflows), so such rows add nothing. dS = P (dP - delta), times
// 1 - (s/cap)^2 of the capped score under a softcap. A q tile with no
// allowed pair for this key tile is skipped after reading only its bits
// and positions: the mask decides, never position alone, because a
// modality's queries attend both ways within their stream. Four threads
// share a key: in the score phase each computes the (S, dP) pairs of 8
// of the tile's 32 q rows; in the product phase each owns every fourth
// dK and dV column. Ragged Tq and Tk load as zeros with bits 0.
//
// The compacted grid (COMPACT = true) replaces the dK/dV pallas_call of
// the Pallas kernel's block_map path (_bam_bwd_dkv_kernel_sparse): the
// block of k tile j walks only the 64-row q blocks of CSR row j of the
// map's k-major list (core/bam.py::block_csr), ascending, each as two of
// its own 32-row q tiles (a second tile past Tq has bits 0 and is
// skipped), for every query head of its KV head. The same loop body and
// in-tile skip run, so for a map that covers the mask dK/dV are the dense
// kernel's to the bit, and a k tile with no active q block writes 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bam_mask.cuh"

namespace {

constexpr int BK = 32;      // keys per block
constexpr int BQ = 32;      // q rows per inner tile
constexpr int NT = 128;     // threads per block: four per key
constexpr int IR = BQ / 4;  // q rows per thread in the score phase
constexpr int MAP_BQ = 64;  // q rows per block of the block map

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
  const size_t smem =
      sizeof(float) * (2 * BK * LD + 2 * BQ * LD + 2 * BQ * (BK + 1) +
                       2 * BQ) +
      sizeof(int) * 2 * BQ;
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/dout [B,Tq,H,hd], k/v/dk/dv
// [B,Tk,Hkv,hd], all contiguous; lse/delta f32 [B,H,Tq]; bits/pos int32
// [B,T]. dK/dV come out folded over the H / Hkv query heads of each KV
// head. With tile_ptr set, the compacted grid: int32 CSR rows tile_ptr
// [ceil(Tk/32)+1] and tile_idx (q blocks of 64 rows, ascending per row);
// both null for the dense grid. Returns cudaGetLastError() after the
// launch.
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
#define BAM_DKV_CASE(TYPE, HD)                                                \
  return tp != nullptr                                                        \
             ? launch<TYPE, HD, true>(q, k, v, dout, ls, dl, qb, kb, qp, kp,  \
                                      dk, dv, tp, ti, B, Tq, Tk, H, Hkv,      \
                                      scale, softcap, window, st)             \
             : launch<TYPE, HD, false>(q, k, v, dout, ls, dl, qb, kb, qp, kp, \
                                       dk, dv, nullptr, nullptr, B, Tq, Tk,   \
                                       H, Hkv, scale, softcap, window, st)
  if (dtype == 0 && hd == 64) BAM_DKV_CASE(float, 64);
  if (dtype == 0 && hd == 128) BAM_DKV_CASE(float, 128);
  if (dtype == 1 && hd == 64) BAM_DKV_CASE(__nv_bfloat16, 64);
  if (dtype == 1 && hd == 128) BAM_DKV_CASE(__nv_bfloat16, 128);
#undef BAM_DKV_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* bam_bwd_dkv_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
