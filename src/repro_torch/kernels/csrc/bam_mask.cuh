// Device helpers shared by the port's BAM kernels (bam_fwd.cu,
// paged_decode.cu): the mask rule of repro_torch.core.bam.allowed_mask
// for one (query, key) pair, and conversions between the element type
// and the f32 the kernels compute in. Bitfields arrive as int32 and are
// read as unsigned.
#pragma once

#include <cuda_bf16.h>

namespace {

constexpr float NEG_INF = -1e30f;  // masked-score sentinel, empty-row lse

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ bool allowed(unsigned qb, unsigned kb, int qp,
                                        int kp, int window) {
  if (qb == 0u || kb == 0u) return false;
  if (((qb >> 23) & 0xFFu) != ((kb >> 23) & 0xFFu)) return false;
  const unsigned km = (kb >> 16) & 0x7Fu;
  if (km >= 16u || !(((qb & 0xFFFFu) >> km) & 1u)) return false;
  const unsigned qm = (qb >> 16) & 0x7Fu;
  if (qm == 0u) return kp <= qp && (window == 0 || qp - kp < window);
  return km == qm;
}

}  // namespace
