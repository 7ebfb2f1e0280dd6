// BAM flash-attention forward (K1) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/bam_attention.py::
// bam_flash_attention on its dense grid (_bam_fwd_kernel, _fwd_accumulate,
// _fwd_finish, mask _mask_tile), modes "out", "residual" and "stats".
//
// What bounds it on this card: at the serving path's shapes (hd = 128,
// T in the thousands) attention does ~2·T·T·hd·H multiply-adds on
// O(T·H·hd) bytes, far above the H100's ~295 operations per byte, so it
// is bound by operations. This first version computes with plain f32
// FMAs out of shared memory (no tensor cores), so it runs well below the
// bf16 tensor-core roofline; wgmma/TMA is a later change.
//
// Design. One block owns one (64-row q tile, q head, batch row) and loops
// over all 32-key tiles of K/V, keeping the online-softmax state (m, l)
// and the output row in registers: blocks run in parallel, so nothing is
// carried between them (the TPU grid carried VMEM scratch across its
// sequential k axis). The [64, 32] mask tile is evaluated from the four
// int32 bitfield/position vectors; a tile with no allowed pair is skipped
// before any product (block_skip=True on the TPU), which drops about half
// the tiles in causal prefill. GQA reads K/V head h / (H / Hkv). Two
// threads share a q row: each computes 16 of the tile's 32 scores and
// owns every second output column (interleaved to keep shared-memory
// reads free of bank conflicts). Rows padded with 1 float in shared
// memory for the same reason. Accumulation is f32; NEG_INF = -1e30 is the
// masked-score sentinel, and rows with l == 0 give out = 0 and
// lse = -1e30. The mask rule is bam_mask.cuh's.
//
// The compacted grid (COMPACT = true) replaces the Pallas kernel's
// block_map path (_bam_fwd_kernel_sparse, pallas_call with the
// (q_blk, k_blk, first, last, active) scalar-prefetch steps). The host
// turns the map's q-major steps into CSR rows (core/bam.py::block_csr):
// the block of q tile i walks k tiles tile_idx[tile_ptr[i] ..
// tile_ptr[i+1]) instead of all of them, ascending, through the same loop
// body, so K and V of a tile outside the map are never read. The in-tile
// skip stays (is_active & any(allowed) on the TPU), so for a map that
// covers the mask the block accumulates exactly the dense kernel's tiles
// in the same order and writes the same bits. An empty row writes the
// empty-row conventions (out 0, lse -1e30; stats -1e30, 0, 0).
//
// The "stats" mode (context parallelism combines chunks of keys) stops
// before the normalisation: the epilogue writes the f32 accumulator
// acc = sum exp(s - m) V in the layout [B,H,Tq,hd], and m and l [B,H,Tq].
// Masked pairs select p = 0 and leave m at NEG_INF, so a row with no
// allowed key in this chunk gives exactly m = -1e30, l = 0, acc = 0,
// which the cross-chunk combine weighs by exp(-1e30 - m) = 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bam_mask.cuh"

namespace {

constexpr int BQ = 64;     // q rows per block
constexpr int BK = 32;     // keys per tile
constexpr int NT = 128;    // threads per block: two per q row
constexpr int JN = BK / 2; // scores per thread per tile

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
  const size_t smem =
      sizeof(float) * (BQ * LD + 2 * BK * LD + BQ * (BK + 1)) +
      sizeof(int) * 2 * BK;
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

template <typename T, int HD>
int dispatch(const void* q, const void* k, const void* v, const int* qb,
             const int* kb, const int* qp, const int* kp, void* out,
             float* lse, float* lsum, const int* tile_ptr,
             const int* tile_idx, int B, int Tq, int Tk, int H, int Hkv,
             float scale, float softcap, int window, cudaStream_t stream) {
#define BAM_FWD_LAUNCH(STATS, COMPACT)                                      \
  return launch<T, HD, STATS, COMPACT>(q, k, v, qb, kb, qp, kp, out, lse,   \
                                       lsum, tile_ptr, tile_idx, B, Tq, Tk, \
                                       H, Hkv, scale, softcap, window,      \
                                       stream)
  if (lsum != nullptr) {
    if (tile_ptr != nullptr) BAM_FWD_LAUNCH(true, true);
    BAM_FWD_LAUNCH(true, false);
  }
  if (tile_ptr != nullptr) BAM_FWD_LAUNCH(false, true);
  BAM_FWD_LAUNCH(false, false);
#undef BAM_FWD_LAUNCH
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q [B,Tq,H,hd], k/v [B,Tk,Hkv,hd],
// all contiguous; bits/pos int32 [B,T]. With lsum null ("out" and
// "residual"): out [B,Tq,H,hd] in q's type, lse f32 [B,H,Tq] or null.
// With lsum set ("stats"): out f32 [B,H,Tq,hd] (acc), lse f32 [B,H,Tq]
// receives m and lsum l. With tile_ptr set, the compacted grid: int32
// CSR rows tile_ptr [ceil(Tq/64)+1] and tile_idx (k tiles of 32 keys,
// ascending per row); both null for the dense grid. Returns
// cudaGetLastError() after the launch.
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
#define BAM_FWD_CASE(TYPE, HD)                                              \
  return dispatch<TYPE, HD>(q, k, v, qb, kb, qp, kp, out, ls, lt, tp, ti,  \
                            B, Tq, Tk, H, Hkv, scale, softcap, window, st)
  if (dtype == 0 && hd == 64) BAM_FWD_CASE(float, 64);
  if (dtype == 0 && hd == 128) BAM_FWD_CASE(float, 128);
  if (dtype == 1 && hd == 64) BAM_FWD_CASE(__nv_bfloat16, 64);
  if (dtype == 1 && hd == 128) BAM_FWD_CASE(__nv_bfloat16, 128);
#undef BAM_FWD_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* bam_fwd_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
