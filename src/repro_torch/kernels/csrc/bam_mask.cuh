// Device helpers shared by the port's BAM kernels (bam_fwd.cu,
// bam_bwd_dq.cu, bam_bwd_dkv.cu, paged_decode.cu): the mask rule of
// repro_torch.core.bam.allowed_mask for one (query, key) pair, and
// conversions between the element type and the f32 the kernels compute
// in. Bitfields arrive as int32 and are read as unsigned.
#pragma once

#include <cuda_bf16.h>
#include <limits.h>

namespace {

constexpr float NEG_INF = -1e30f;  // masked-score sentinel, empty-row lse

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// The mask rule, split into what depends on the query and what on the
// key so that a kernel testing many pairs of a few rows computes each
// part once. A text row keeps its attends-set and the position interval
// [lo, hi] of its keys (causal, and the window); a modality row keeps
// only its own modality's bit, if it attends it, and no position bound;
// a padding row keeps no bit. A key keeps its own modality's bit (none
// for padding or a modality >= 16). A pair is allowed when the bits
// meet within one sample and the key's position is in the interval.
struct QueryRule {
  unsigned inst, sel;
  int lo, hi;
};
struct KeyRule {
  unsigned inst, bit;
  int pos;
};

__device__ __forceinline__ QueryRule query_rule(unsigned qb, int qp,
                                                int window) {
  const unsigned qm = (qb >> 16) & 0x7Fu;
  QueryRule r{(qb >> 23) & 0xFFu, qb & 0xFFFFu, INT_MIN, INT_MAX};
  if (qb == 0u) {
    r.sel = 0u;
  } else if (qm == 0u) {
    r.hi = qp;
    if (window != 0) r.lo = qp - window + 1;
  } else {
    r.sel &= qm < 16u ? 1u << qm : 0u;
  }
  return r;
}

__device__ __forceinline__ KeyRule key_rule(unsigned kb, int kp) {
  const unsigned km = (kb >> 16) & 0x7Fu;
  return KeyRule{(kb >> 23) & 0xFFu,
                 (kb != 0u && km < 16u) ? 1u << km : 0u, kp};
}

__device__ __forceinline__ bool pair_allowed(const QueryRule& q,
                                             const KeyRule& k) {
  return (q.sel & k.bit) != 0u && q.inst == k.inst && k.pos <= q.hi &&
         k.pos >= q.lo;
}

__device__ __forceinline__ bool allowed(unsigned qb, unsigned kb, int qp,
                                        int kp, int window) {
  return pair_allowed(query_rule(qb, qp, window), key_rule(kb, kp));
}

}  // namespace
