// Which tiles a block of the port's bf16 BAM kernels computes, decided
// from bits alone before any K/V (or Q/dO) load: a summary of the
// block's own 64 rows (K1, K2: q rows) or 64 keys (K3), tested against
// each candidate tile's 32 keys (or q rows), one per lane of a warp.
// The tests are sound: a tile with an allowed pair is never dropped,
// and a tile is marked full only where every pair of it is allowed, so
// a kernel may skip the mask there.
#pragma once

#include <limits.h>

#include "bam_mask.cuh"

namespace {

// list items: the tile index in the low 28 bits; bits 28-29 are the
// compacted K3's per-half flags; bit 31 marks a full tile
constexpr int ITEM_TILE = 0x0FFFFFFF;

// The block's 64 q rows, merged: samples [smin, smax], the OR and the
// AND of their attends-sets, the modality ids of modality rows (mset),
// the positions [pmin, pmax] of text rows (pmax < pmin if none), the
// range of own-modality ids, and whether every row is a token (t < Tq,
// bits != 0). maybe() holds for every key some row allows (see
// allowed()), so a tile whose 32 keys all fail it has no allowed pair;
// every() holds only for a key that every row allows, so a tile whose
// 32 keys all pass it needs no mask.
struct RowsSummary {
  unsigned smin, smax, qor, qand, mset, qm_min, qm_max;
  int pmin, pmax;
  bool all_valid;

  __device__ __forceinline__ bool maybe(unsigned kb, int kp,
                                        int window) const {
    if (kb == 0u) return false;
    const unsigned ks = (kb >> 23) & 0xFFu, km = (kb >> 16) & 0x7Fu;
    if (ks < smin || ks > smax || km >= 16u || !((qor >> km) & 1u))
      return false;
    if ((mset >> km) & 1u) return true;
    return pmin <= pmax && kp <= pmax && (window == 0 || pmin - kp < window);
  }

  __device__ __forceinline__ bool every(unsigned kb, int kp,
                                        int window) const {
    if (!all_valid || kb == 0u || smin != smax) return false;
    const unsigned ks = (kb >> 23) & 0xFFu, km = (kb >> 16) & 0x7Fu;
    if (ks != smin || km >= 16u || !((qand >> km) & 1u)) return false;
    if (qm_max == 0u)   // all text rows
      return kp <= pmin && (window == 0 || pmax - kp < window);
    return qm_min == qm_max && km == qm_min;
  }
};

// RowsSummary of rows t0 .. t0 + 64 of (bits, pos) [T], rows at or past
// T counting as padding, by 128 threads (warps 0 and 1 hold one row per
// lane); sSum: [4 warps][8] ints. Ends with a barrier.
__device__ __forceinline__ RowsSummary summarize_rows(const int* bits,
                                                      const int* pos,
                                                      int t0, int T,
                                                      int* sSum, int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  {
    unsigned smin = 0xFFu, smax = 0u, qor = 0u, qand = ~0u, mset = 0u;
    unsigned qm_min = ~0u, qm_max = 0u;
    int pmin = INT_MAX, pmax = INT_MIN;
    const int t = t0 + tid;
    const unsigned qb = (tid < 64 && t < T) ? (unsigned)bits[t] : 0u;
    if (qb != 0u) {
      const unsigned qm = (qb >> 16) & 0x7Fu;
      smin = smax = (qb >> 23) & 0xFFu;
      qor = qand = qb & 0xFFFFu;
      qm_min = qm_max = qm;
      if (qm == 0u)
        pmin = pmax = pos[t];
      else if (qm < 16u)
        mset = 1u << qm;
    } else if (tid < 64) {
      qand = 0u;
    }
    const unsigned all_valid =
        __reduce_and_sync(0xffffffffu, (tid >= 64 || qb != 0u) ? 1u : 0u);
    smin = __reduce_min_sync(0xffffffffu, smin);
    smax = __reduce_max_sync(0xffffffffu, smax);
    qor = __reduce_or_sync(0xffffffffu, qor | (mset << 16));
    qand = __reduce_and_sync(0xffffffffu, qand);
    qm_min = __reduce_min_sync(0xffffffffu, qm_min);
    qm_max = __reduce_max_sync(0xffffffffu, qm_max);
    pmin = __reduce_min_sync(0xffffffffu, pmin);
    pmax = __reduce_max_sync(0xffffffffu, pmax);
    if (lane == 0) {
      int* w = sSum + warp * 8;
      w[0] = (int)(smin | (smax << 8));
      w[1] = (int)qor;
      w[2] = (int)qand;
      w[3] = (int)qm_min;
      w[4] = (int)qm_max;
      w[5] = pmin;
      w[6] = pmax;
      w[7] = (int)all_valid;
    }
  }
  __syncthreads();
  RowsSummary rs{0xFFu, 0u, 0u, ~0u, 0u, ~0u, 0u, INT_MAX, INT_MIN, true};
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const int* ws = sSum + w * 8;
    rs.smin = min(rs.smin, (unsigned)ws[0] & 0xFFu);
    rs.smax = max(rs.smax, (unsigned)ws[0] >> 8);
    rs.qor |= (unsigned)ws[1] & 0xFFFFu;
    rs.mset |= (unsigned)ws[1] >> 16;
    rs.qand &= (unsigned)ws[2];
    rs.qm_min = min(rs.qm_min, (unsigned)ws[3]);
    rs.qm_max = max(rs.qm_max, (unsigned)ws[4]);
    rs.pmin = min(rs.pmin, ws[5]);
    rs.pmax = max(rs.pmax, ws[6]);
    rs.all_valid = rs.all_valid && ws[7] != 0;
  }
  return rs;
}

// The block's 64 keys, merged: samples [smin, smax], the OR of their
// modality bits (kor; a key is valid when its bits are nonzero and its
// modality below 16, and only valid keys count), their positions [pmin,
// pmax], and whether every key is valid. maybe() holds for every q row
// some key allows; every() only for a row that allows every key.
struct KeysSummary {
  unsigned smin, smax, kor;
  int pmin, pmax;
  bool all_valid;

  __device__ __forceinline__ bool maybe(unsigned qb, int qp,
                                        int window) const {
    if (qb == 0u) return false;
    const QueryRule r = query_rule(qb, qp, window);
    return r.inst >= smin && r.inst <= smax && (r.sel & kor) != 0u &&
           pmin <= r.hi && pmax >= r.lo;
  }

  __device__ __forceinline__ bool every(unsigned qb, int qp,
                                        int window) const {
    if (!all_valid || qb == 0u || smin != smax) return false;
    const QueryRule r = query_rule(qb, qp, window);
    return r.inst == smin && (kor & ~r.sel) == 0u && pmax <= r.hi &&
           pmin >= r.lo;
  }
};

// KeysSummary of keys t0 .. t0 + 64 of (bits, pos) [T], keys at or past
// T counting as padding, by 128 threads or more (warps 0 and 1 hold one
// key per lane; the others add nothing); sSum: [warps][8] ints. Ends
// with a barrier.
__device__ __forceinline__ KeysSummary summarize_keys(const int* bits,
                                                      const int* pos,
                                                      int t0, int T,
                                                      int* sSum, int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  {
    const int t = t0 + tid;
    const unsigned kb = (tid < 64 && t < T) ? (unsigned)bits[t] : 0u;
    const KeyRule kr = key_rule(kb, kb != 0u ? pos[t] : 0);
    const bool valid = kr.bit != 0u;
    const unsigned all_valid =
        __reduce_and_sync(0xffffffffu, (tid >= 64 || valid) ? 1u : 0u);
    const unsigned smin =
        __reduce_min_sync(0xffffffffu, valid ? kr.inst : 0xFFu);
    const unsigned smax = __reduce_max_sync(0xffffffffu, valid ? kr.inst : 0u);
    const unsigned kor = __reduce_or_sync(0xffffffffu, kr.bit);
    const int pmin = __reduce_min_sync(0xffffffffu, valid ? kr.pos : INT_MAX);
    const int pmax = __reduce_max_sync(0xffffffffu, valid ? kr.pos : INT_MIN);
    if (lane == 0) {
      int* w = sSum + warp * 8;
      w[0] = (int)(smin | (smax << 8));
      w[1] = (int)kor;
      w[2] = pmin;
      w[3] = pmax;
      w[4] = (int)all_valid;
    }
  }
  __syncthreads();
  KeysSummary ks{0xFFu, 0u, 0u, INT_MAX, INT_MIN, true};
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const int* ws = sSum + w * 8;
    ks.smin = min(ks.smin, (unsigned)ws[0] & 0xFFu);
    ks.smax = max(ks.smax, (unsigned)ws[0] >> 8);
    ks.kor |= (unsigned)ws[1];
    ks.pmin = min(ks.pmin, ws[2]);
    ks.pmax = max(ks.pmax, ws[3]);
    ks.all_valid = ks.all_valid && ws[4] != 0;
  }
  return ks;
}

// The mask of an m64n32 accumulator fragment whose rows are q rows (K1,
// K2; bam_mma.cuh layout): ok[4 c + 2 i + u] for the thread's row i
// (rule qr0 or qr1) and key 8 c + 2 tig + u of the tile, whose bits and
// positions are kb_s and kp_s [32] in shared memory.
__device__ __forceinline__ void fragment_mask(bool (&ok)[16],
                                              const QueryRule& qr0,
                                              const QueryRule& qr1,
                                              const int* kb_s,
                                              const int* kp_s, int tig) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int2 kb2 = *reinterpret_cast<const int2*>(kb_s + c * 8 + 2 * tig);
    const int2 kp2 = *reinterpret_cast<const int2*>(kp_s + c * 8 + 2 * tig);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const KeyRule kr = key_rule((unsigned)(u ? kb2.y : kb2.x),
                                  u ? kp2.y : kp2.x);
      ok[4 * c + u] = pair_allowed(qr0, kr);
      ok[4 * c + 2 + u] = pair_allowed(qr1, kr);
    }
  }
}

// The same for a fragment whose rows are keys (K3): ok[4 c + 2 i + u]
// for the thread's key i (rule kr0 or kr1) and q row 8 c + 2 tig + u of
// the tile, whose bits and positions are qb_s and qp_s [32].
__device__ __forceinline__ void fragment_mask_t(bool (&ok)[16],
                                                const KeyRule& kr0,
                                                const KeyRule& kr1,
                                                const int* qb_s,
                                                const int* qp_s, int window,
                                                int tig) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int2 qb2 = *reinterpret_cast<const int2*>(qb_s + c * 8 + 2 * tig);
    const int2 qp2 = *reinterpret_cast<const int2*>(qp_s + c * 8 + 2 * tig);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const QueryRule qr = query_rule((unsigned)(u ? qb2.y : qb2.x),
                                      u ? qp2.y : qp2.x, window);
      ok[4 * c + u] = pair_allowed(qr, kr0);
      ok[4 * c + 2 + u] = pair_allowed(qr, kr1);
    }
  }
}

// The tiles to compute, ascending, by the block's NW warps: entry e in
// [0, n_ent) is the list item item_of(e), naming the 32-row tile item &
// ITEM_TILE of (bits, pos) [T] (rows at or past T are padding). Warp w
// tests entries w, w + NW, ..., one row per lane, sixteen entries' loads
// in flight: the entry is kept where test.maybe holds for some row, and
// marked full (bit 31) where test.every holds for all. Writes sList[0]
// = count, then the kept items; sAct holds 2 * ceil(n_ent / 32) words,
// zeroed by the caller before a barrier. Ends with a barrier.
template <int NW = 4, class Test, class ItemOf>
__device__ __forceinline__ void list_tiles(const Test& test, int n_ent,
                                           ItemOf item_of, const int* bits,
                                           const int* pos, int T, int window,
                                           unsigned* sAct, int* sList,
                                           int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  const int n_words = (n_ent + 31) / 32;
  unsigned* sFull = sAct + n_words;
  constexpr int SCAN = 16;
  for (int e0 = warp; e0 < n_ent; e0 += SCAN * NW) {
    unsigned bv[SCAN];
    int pv[SCAN];
#pragma unroll
    for (int u = 0; u < SCAN; ++u) {
      const int e = e0 + u * NW;
      const int t = e < n_ent ? (item_of(e) & ITEM_TILE) * 32 + lane : T;
      bv[u] = t < T ? (unsigned)bits[t] : 0u;
      pv[u] = t < T ? pos[t] : 0;
    }
#pragma unroll
    for (int u = 0; u < SCAN; ++u) {
      const int e = e0 + u * NW;
      const bool any = __any_sync(0xffffffffu, test.maybe(bv[u], pv[u],
                                                          window));
      const bool all = __all_sync(0xffffffffu, test.every(bv[u], pv[u],
                                                          window));
      if (any && lane == 0) atomicOr(&sAct[e >> 5], 1u << (e & 31));
      if (all && lane == 0) atomicOr(&sFull[e >> 5], 1u << (e & 31));
    }
  }
  __syncthreads();
  if (warp == 0) {
    int count = 0;
    for (int w = 0; w < n_words; ++w) {
      const unsigned act = sAct[w], full = sFull[w];
      if ((act >> lane) & 1u)
        sList[1 + count + __popc(act & ((1u << lane) - 1u))] =
            item_of(w * 32 + lane) | (int)(((full >> lane) & 1u) << 31);
      count += __popc(act);
    }
    if (lane == 0) sList[0] = count;
  }
  __syncthreads();
}

}  // namespace
