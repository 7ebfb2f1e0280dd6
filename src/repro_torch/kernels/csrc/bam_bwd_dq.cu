// BAM flash-attention backward, dQ half (K2), for Hopper, sm_90a.
//
// Replaces the dQ pallas_call of the Pallas TPU kernel
// repro/kernels/bam_attention.py::bam_flash_attention_bwd on its dense
// grid (_bam_bwd_dq_kernel, _recompute_p_ds, mask _mask_tile).
//
// What bounds it on this card: per allowed (query, key) pair it does
// three hd-long products (S = Q·K, dP = dO·V, dQ += dS·K) on O(T·H·hd)
// bytes, far above the H100's ~295 operations per byte at the train
// path's T = 1600, so it is bound by operations. Like K1 it computes
// with plain f32 FMAs out of shared memory (no tensor cores), well
// below the bf16 tensor-core roofline; wgmma/TMA is a later change.
//
// Design. One block owns one (64-row q tile, q head, batch row) and
// loops over all 32-key tiles of K/V, keeping its dQ rows in registers
// (the TPU grid carried a VMEM scratch across its sequential k axis).
// P is recomputed as exp(s - lse) from the forward's lse; a masked pair
// is selected to 0, never multiplied by the mask, so an empty row
// (lse = -1e30, where exp(s - lse) overflows) gives dQ = 0 exactly.
// dS = P (dP - delta), times 1 - (s/cap)^2 of the capped score under a
// softcap; delta = rowsum(dO·O) comes in precomputed (f32 [B,H,Tq]).
// A tile with no allowed pair is skipped before any product; the mask
// is evaluated per pair from the int32 bitfields and positions
// (bam_mask.cuh), so the dense both-way modality blocks are never
// skipped by position alone. Two threads share a q row: each computes
// 16 of the tile's 32 (S, dP) pairs and owns every second dQ column.
// Ragged Tq and Tk are masked here: rows and keys past the end load as
// zeros with bits 0. GQA reads K/V head h / (H / Hkv).
//
// The compacted grid (COMPACT = true) replaces the dQ pallas_call of the
// Pallas kernel's block_map path (_bam_bwd_dq_kernel_sparse): the block
// of q tile i walks only the k tiles of CSR row i of the map's q-major
// list (core/bam.py::block_csr), ascending, through the same loop body
// and in-tile skip, so for a map that covers the mask dQ is the dense
// kernel's to the bit, and a row with no active tile writes dQ = 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bam_mask.cuh"

namespace {

constexpr int BQ = 64;     // q rows per block
constexpr int BK = 32;     // keys per tile
constexpr int NT = 128;    // threads per block: two per q row
constexpr int JN = BK / 2; // pairs per thread per tile

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
  const size_t smem =
      sizeof(float) * (2 * BQ * LD + 2 * BK * LD + BQ * (BK + 1)) +
      sizeof(int) * 2 * BK;
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/dout/dq [B,Tq,H,hd], k/v
// [B,Tk,Hkv,hd], all contiguous; lse/delta f32 [B,H,Tq]; bits/pos int32
// [B,T]. With tile_ptr set, the compacted grid: int32 CSR rows tile_ptr
// [ceil(Tq/64)+1] and tile_idx (k tiles of 32 keys, ascending per row);
// both null for the dense grid. Returns cudaGetLastError() after the
// launch.
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
#define BAM_DQ_CASE(TYPE, HD)                                                 \
  return tp != nullptr                                                        \
             ? launch<TYPE, HD, true>(q, k, v, dout, ls, dl, qb, kb, qp, kp,  \
                                      dq, tp, ti, B, Tq, Tk, H, Hkv, scale,   \
                                      softcap, window, st)                    \
             : launch<TYPE, HD, false>(q, k, v, dout, ls, dl, qb, kb, qp, kp, \
                                       dq, nullptr, nullptr, B, Tq, Tk, H,    \
                                       Hkv, scale, softcap, window, st)
  if (dtype == 0 && hd == 64) BAM_DQ_CASE(float, 64);
  if (dtype == 0 && hd == 128) BAM_DQ_CASE(float, 128);
  if (dtype == 1 && hd == 64) BAM_DQ_CASE(__nv_bfloat16, 64);
  if (dtype == 1 && hd == 128) BAM_DQ_CASE(__nv_bfloat16, 128);
#undef BAM_DQ_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* bam_bwd_dq_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
