// Paged single-query BAM flash decode (K4) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_decode.py::
// paged_decode_attention (_paged_decode_kernel and its index maps).
//
// What bounds it on this card: one query token per request row against
// that row's resident K/V pages. Each page is used for n_rep query heads
// only, ~2·n_rep flops per byte read, far below the H100's ~295
// operations per byte, so it is bound by the bytes of the pages it reads.
//
// Design. The TPU kernel walked a flattened (req, page, first, last,
// active) step list in order, carrying softmax scratch from step to step.
// Here the wrapper turns the active steps into CSR form (row_ptr[B+1],
// pages[]) and one block owns one (batch row, KV head): it walks that
// row's active pages itself, four pages per iteration, so each K/V page
// is read from device memory once for its whole GQA group of n_rep query
// heads (one warp per query head). Within a staged chunk each lane
// computes whole scores for its own keys (lane, lane + 32, ...), so the
// chunk's scores come out in parallel; one warp reduction per chunk gives
// the online softmax's max and sum, and each lane then accumulates hd/32
// output columns over the chunk's keys. Keys the bitfields forbid get
// p = 0 (pages the query cannot reach never reach the kernel; a reachable
// page fully masked for this layer's window costs no arithmetic). A row
// with no active page writes exact zeros. Pages are read with 16-byte loads (pool rows are hd-aligned).
// The mask rule is bam_mask.cuh's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bam_mask.cuh"

namespace {

constexpr int PAGES = 4;  // pages staged in shared memory per iteration

// 16 bytes of T (4 floats or 8 bf16) -> floats in shared memory
__device__ __forceinline__ void unpack16(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void unpack16(const __nv_bfloat16* src, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}

template <typename T, int HD>
__global__ void paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ kpages,
    const T* __restrict__ vpages, const int* __restrict__ qbits,
    const int* __restrict__ qpos, const int* __restrict__ kvbits,
    const int* __restrict__ kvpos, const int* __restrict__ row_ptr,
    const int* __restrict__ pages, T* __restrict__ out, int H, int Hkv,
    int ps, float scale, float softcap, int window) {
  constexpr int NV = HD / 32;
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int VPR = HD / VEC;         // 16-byte loads per K/V row
  // K row stride: 8 lanes reading float4s of 8 different rows hit 8
  // different 4-bank groups
  constexpr int KLD = HD + 4;
  extern __shared__ float smem[];
  const int chunk = PAGES * ps;
  const int nwarps = blockDim.x >> 5;
  float* sK = smem;                      // [chunk][KLD]
  float* sV = sK + chunk * KLD;          // [chunk][HD]
  float* sQ = sV + chunk * HD;           // [nwarps][HD]
  float* sP = sQ + nwarps * HD;          // [nwarps][chunk] scores, then p
  int* sOk = reinterpret_cast<int*>(sP + nwarps * chunk);  // [chunk]

  const int b = blockIdx.x, g = blockIdx.y;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int h = g * (H / Hkv) + warp;
  float* qw = sQ + warp * HD;
  float* pw = sP + warp * chunk;
  for (int d = lane; d < HD; d += 32)
    qw[d] = to_f(q[((size_t)b * H + h) * HD + d]);

  float acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = 0.f;
  const unsigned qb = (unsigned)qbits[b];
  const int qp = qpos[b];
  float m = NEG_INF, l = 0.f;

  const int s1 = row_ptr[b + 1];
  for (int s = row_ptr[b]; s < s1; s += PAGES) {
    const int np = min(PAGES, s1 - s), n = np * ps;
    __syncthreads();  // the previous chunk is no longer read
    int any = 0;
    for (int p = 0; p < np; ++p) {
      const size_t first = (size_t)pages[s + p] * ps;  // first slot of page
      for (int j = tid; j < ps; j += nthreads) {
        const int ok = allowed(qb, (unsigned)kvbits[first + j], qp,
                               kvpos[first + j], window);
        sOk[p * ps + j] = ok;
        any |= ok;
      }
      // 16-byte loads: VPR vectors per (slot, head) row of hd values
      for (int e = tid; e < ps * VPR; e += nthreads) {
        const int j = e / VPR, c = (e % VPR) * VEC;
        const size_t off = ((first + j) * Hkv + g) * HD + c;
        unpack16(kpages + off, sK + (p * ps + j) * KLD + c);
        unpack16(vpages + off, sV + (p * ps + j) * HD + c);
      }
    }
    if (!__syncthreads_or(any)) continue;

    // scores: each lane owns keys lane, lane + 32, ... of the chunk
    const float4* q4 = reinterpret_cast<const float4*>(qw);
    float mx = NEG_INF;
    for (int j = lane; j < n; j += 32) {
      float x = NEG_INF;
      if (sOk[j]) {
        const float4* k4 = reinterpret_cast<const float4*>(sK + j * KLD);
        float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
#pragma unroll
        for (int c = 0; c < HD / 4; ++c) {
          const float4 a = k4[c], w = q4[c];
          d0 = fmaf(a.x, w.x, d0);
          d1 = fmaf(a.y, w.y, d1);
          d2 = fmaf(a.z, w.z, d2);
          d3 = fmaf(a.w, w.w, d3);
        }
        x = ((d0 + d1) + (d2 + d3)) * scale;
        if (softcap != 0.f) x = tanhf(x / softcap) * softcap;
      }
      pw[j] = x;
      mx = fmaxf(mx, x);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = sOk[j] ? expf(pw[j] - m_new) : 0.f;
      pw[j] = p;
      psum += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, o);
    // every lane takes lane 0's sum, so the softmax state is uniform
    l = l * alpha + __shfl_sync(0xffffffffu, psum, 0);
    m = m_new;
    __syncwarp();  // this warp's p row is written
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[i] *= alpha;
    for (int j = 0; j < n; ++j) {
      const float p = pw[j];
      const float* vr = sV + j * HD + lane;
#pragma unroll
      for (int i = 0; i < NV; ++i) acc[i] = fmaf(p, vr[32 * i], acc[i]);
    }
  }

  const float inv = l > 0.f ? 1.f / fmaxf(l, 1e-30f) : 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    store(out + ((size_t)b * H + h) * HD + lane + 32 * i, acc[i] * inv);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const int* qb,
           const int* qp, const int* kb, const int* kp, const int* row_ptr,
           const int* pages, void* out, int B, int H, int Hkv, int ps,
           float scale, float softcap, int window, cudaStream_t stream) {
  const int chunk = PAGES * ps, nwarps = H / Hkv;
  const size_t smem =
      sizeof(float) * ((size_t)chunk * (2 * HD + 4) + nwarps * (HD + chunk)) +
      sizeof(int) * chunk;
  auto kern = paged_decode_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, Hkv);
  kern<<<grid, 32 * nwarps, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), qb, qp, kb, kp, row_ptr, pages,
      static_cast<T*>(out), H, Hkv, ps, scale, softcap, window);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/out [B,H,hd]; k/v pages
// [P,page_size,Hkv,hd]; q bits/pos int32 [B]; kv bits/pos int32
// [P,page_size]; row_ptr int32 [B+1]; pages int32 [row_ptr[B]]. All
// contiguous. Returns cudaGetLastError() after the launch.
extern "C" int paged_decode(const void* q, const void* k_pages,
                            const void* v_pages, const void* q_bits,
                            const void* q_pos, const void* kv_bits,
                            const void* kv_pos, const void* row_ptr,
                            const void* pages, void* out, int B, int H,
                            int Hkv, int page_size, int hd, int dtype,
                            float scale, float softcap, int window,
                            void* stream) {
  const int* qb = static_cast<const int*>(q_bits);
  const int* qp = static_cast<const int*>(q_pos);
  const int* kb = static_cast<const int*>(kv_bits);
  const int* kp = static_cast<const int*>(kv_pos);
  const int* rp = static_cast<const int*>(row_ptr);
  const int* pg = static_cast<const int*>(pages);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PAGED_CASE(TYPE, HD)                                                  \
  return launch<TYPE, HD>(q, k_pages, v_pages, qb, qp, kb, kp, rp, pg, out,   \
                          B, H, Hkv, page_size, scale, softcap, window, st)
  if (dtype == 0 && hd == 64) PAGED_CASE(float, 64);
  if (dtype == 0 && hd == 128) PAGED_CASE(float, 128);
  if (dtype == 1 && hd == 64) PAGED_CASE(__nv_bfloat16, 64);
  if (dtype == 1 && hd == 128) PAGED_CASE(__nv_bfloat16, 128);
#undef PAGED_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_decode_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
