// Paged single-query BAM flash decode (K4) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_decode.py::
// paged_decode_attention (_paged_decode_kernel and its index maps).
//
// What bounds it on this card: one query token per request row against
// that row's resident K/V pages. Each page is used for n_rep query heads
// only, ~2·n_rep flops per byte read, far below the H100's ~295
// operations per byte, so it is bound by the bytes of the pages it reads.
// At 3.35 TB/s that asks for ~16-25 KB in flight on every one of the 132
// SMs, so what matters is how many SMs stream pages and how deep.
//
// Design (flash-decoding). The TPU kernel walked a flattened (req, page,
// first, last, active) step list in order, carrying softmax scratch from
// step to step. Here the wrapper turns the active steps into CSR form and
// cuts each row's pages into splits of whole stages, no split across a
// row (kernels/paged_decode.py::decode_steps, sized for ~3 blocks per SM
// with at least 2 stages a split). One block owns one (split, KV head)
// and all n_rep query heads of its GQA group, one warp per query head,
// so each page is read from device memory once per group.
//
// - Pages stream through a ring of 3 stages in shared memory, each stage
//   32 keys (32 / page_size pages) of K, V and the slots' bits and
//   positions, copied by cp.async 16-byte (K/V) and 4-byte (bits/pos)
//   copies; each thread copies one page of a stage and loads that page's
//   id a stage ahead, so no copy waits on an id. K/V stay in their own
//   type there (bf16 or f32) and are converted in registers. While a
//   block computes on stage s, stages s+1 and s+2 are in flight (32 KB
//   of bf16 K/V at hd 128, page size 16); one barrier per stage.
// - Scores: each lane owns whole keys of the stage (lane, lane + 32, ...),
//   dotting its K row with the warp's query held in shared memory in f32;
//   rows are padded by 16 bytes so that the 8 lanes of a phase hit 8
//   different 4-bank groups. Keys the bitfields forbid get p = 0 by a
//   select (the mask rule is bam_mask.cuh's); a stage with no allowed key
//   for a head costs that warp no softmax and no P·V.
// - P·V: a lane owns one 16-byte column chunk of V (two, 32 chunks
//   apart, where a row has 64: f32 at hd 256) and 32 / (chunks per row)
//   keys go at once, so the serial chain over a stage's keys is 2 (bf16
//   hd 128) to 4 (bf16 hd 64) times shorter than one key per step; the
//   key groups' sums meet once per block by warp shuffles.
// - Partials and combine. A row with one split normalises and writes its
//   output directly. Otherwise each block writes its unnormalised (m, l,
//   acc[hd]) in f32 to scratch the wrapper allocates, and takes a ticket
//   from an int counter per (row, KV head); the block that arrives last
//   gathers the row's partials into its idle ring by cp.async and merges
//   them in ascending split order, weights exp(m - M) against the
//   splits' max M (so the bits never depend on which block was last,
//   and no float atomics are used), writes the output, and resets the
//   counter to 0 for the next layer's call. The counters are B x Hkv
//   zeros in the tensor that carries the tick's work list, so calls that
//   share them run one after another on one stream, and a new tick (or a
//   CUDA graph holding its own) starts from fresh zeros. The route costs
//   no second launch: a fence and an atomic per block, and one block's
//   pass over its row's partials. A split with no allowed key gives m = -1e30, l = 0, acc =
//   0, which the merge weighs by exp(-1e30 - M) = 0, never NaN. Rows
//   with no active page get blocks of their own that write exact zeros.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bam_mask.cuh"
#include "bam_mma.cuh"

namespace {

constexpr int STAGES = 3;              // ring slots
constexpr int STAGE_KEYS = 32;         // keys a stage holds (page size <= 32);
                                       // paged_decode.py plans whole stages
constexpr int MAX_PAGE = 64;           // the largest page size taken
constexpr int MAX_REP = 32;            // query heads per KV head: one warp each
constexpr int MAX_SMEM = 232448 - 64;  // 227 KB, less the static flag

template <typename T, int HD>
struct Layout {
  static constexpr int VEC = 16 / sizeof(T);       // elements in 16 bytes
  static constexpr int LPR = HD / VEC;             // 16-byte chunks a row
  static constexpr int LANES = LPR < 32 ? LPR : 32;  // lanes a row spans
  static constexpr int CPL = LPR / LANES;          // chunks a lane holds
  static constexpr int G = 32 / LANES;             // keys of one P·V step
  static constexpr int ROW = HD * sizeof(T) + 16;  // padded row, bytes
  static_assert(LPR % LANES == 0 && 32 % LANES == 0,
                "a row's 16-byte chunks must tile a warp");
};

// What each instantiation takes: pages of up to PAGE slots and up to REP
// query heads per KV head (a block has 32 REP threads at most). At hd 256
// a 64-slot page (one stage of 64 keys) would not fit three stages in
// shared memory, so pages stop at a stage's 32 keys; and a lane holds
// twice the columns, which at 1024 threads (64 registers a thread)
// spills, so hd 256 takes 16 heads: 512 threads, up to 128 registers.
template <typename T, int HD>
struct Caps {
  static constexpr int PAGE = HD <= 128 ? MAX_PAGE : STAGE_KEYS;
  static constexpr int REP = HD <= 128 ? MAX_REP : 16;
};

constexpr __host__ __device__ int round16(int x) { return (x + 15) & ~15; }

// K rows, V rows, then bits and positions of n keys
template <typename T, int HD>
constexpr __host__ __device__ int stage_bytes(int n) {
  return round16(2 * n * Layout<T, HD>::ROW + 2 * n * (int)sizeof(int));
}

// the warps' queries [n_rep][HD] and probabilities [n_rep][n] in f32
template <int HD>
constexpr __host__ __device__ int head_bytes(int n_rep, int n) {
  return n_rep * HD * (int)sizeof(float) +
         round16(n_rep * n * (int)sizeof(float));
}

// The ring's STAGES stages fit for every input an instantiation takes:
// a stage holds max(page size, STAGE_KEYS) keys. The largest are f32 at
// hd 128, 32 query heads a KV head and 64-slot pages, one page a stage
// (24576 + 3 x 68096 = 228864 B); f32 at hd 256, 16 heads and 32-key
// stages (18432 + 3 x 66816 = 218880 B); bf16 at hd 256 (18432 + 3 x
// 34048 = 120576 B).
template <typename T, int HD>
constexpr int ring_bytes() {
  constexpr int n = Caps<T, HD>::PAGE > STAGE_KEYS ? Caps<T, HD>::PAGE
                                                    : STAGE_KEYS;
  return head_bytes<HD>(Caps<T, HD>::REP, n) + STAGES * stage_bytes<T, HD>(n);
}
static_assert(ring_bytes<float, 64>() <= MAX_SMEM &&
                  ring_bytes<float, 128>() <= MAX_SMEM &&
                  ring_bytes<__nv_bfloat16, 64>() <= MAX_SMEM &&
                  ring_bytes<__nv_bfloat16, 128>() <= MAX_SMEM,
              "K4's ring does not fit in shared memory at hd 64 or 128");
static_assert(ring_bytes<float, 256>() <= MAX_SMEM,
              "K4's ring does not fit in shared memory: f32, hd 256");
static_assert(ring_bytes<__nv_bfloat16, 256>() <= MAX_SMEM,
              "K4's ring does not fit in shared memory: bf16, hd 256");

// 16 bytes of T in shared memory -> floats in registers
__device__ __forceinline__ void unpack(const float* s, float (&f)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(s);
  f[0] = a.x;
  f[1] = a.y;
  f[2] = a.z;
  f[3] = a.w;
}
__device__ __forceinline__ void unpack(const __nv_bfloat16* s, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(s);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 -> f32 is a 16-bit shift
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// 16 bytes of T from floats (rounded to nearest even for bf16)
__device__ __forceinline__ void pack_store(float* d, const float (&f)[4]) {
  *reinterpret_cast<float4*>(d) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void pack_store(__nv_bfloat16* d,
                                           const float (&f)[8]) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(d) = u;
}

template <int N>
__device__ __forceinline__ void store_f32(float* d, const float (&f)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(d + i) =
        make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
}

struct Params {
  const void* q;          // [B, H, HD]
  const void* k;          // [P, ps, Hkv, HD]
  const void* v;
  const int* q_bits;      // [B]
  const int* q_pos;
  const int* kv_bits;     // [P, ps]
  const int* kv_pos;
  const int* pages;       // the active pages, row by row (CSR)
  const int* split_ptr;   // [B + 1]: row b's splits are [split_ptr[b], +1)
  const int* splits;      // [S][3]: (row, first index into pages, count)
  const int* empty;       // [E]: rows with no active page
  void* out;              // [B, H, HD]
  float* part_acc;        // [S, H, HD] unnormalised partials
  float2* part_ml;        // [S, H] (m, l)
  int* tickets;           // [B * Hkv], 0 between calls
  int H, Hkv, ps, sp, n_splits;
  float scale, softcap;
  int window;
};

// one warp per query head of the group; one block an SM is enough, so at
// 512 threads (hd 256) a thread may hold up to 128 registers
template <typename T, int HD>
__global__ void __launch_bounds__(32 * Caps<T, HD>::REP, 1)
    paged_decode_kernel(const Params p) {
  using L = Layout<T, HD>;
  constexpr int VEC = L::VEC, LPR = L::LPR, G = L::G, ROW = L::ROW;
  constexpr int LANES = L::LANES, CPL = L::CPL;
  // chunks of a K row in flight in the score loop: 8, or 4 where a row
  // has 64 (f32 at hd 256), to keep that instantiation's registers low
  constexpr int SCORE_UNROLL = LPR > 32 ? 4 : 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;

  const int g = blockIdx.x % p.Hkv, w = blockIdx.x / p.Hkv;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n_rep = p.H / p.Hkv, h = g * n_rep + warp;
  T* out = static_cast<T*>(p.out);
  if (w >= p.n_splits) {  // a row with no active page: exact zeros
    T* o = out + ((size_t)p.empty[w - p.n_splits] * p.H + h) * HD;
    for (int d = lane; d < HD; d += 32) store(o + d, 0.f);
    return;
  }
  const int b = p.splits[3 * w], first = p.splits[3 * w + 1];
  const int count = p.splits[3 * w + 2];
  const int s0 = p.split_ptr[b], ns = p.split_ptr[b + 1] - s0;
  const int ps = p.ps, n_max = p.sp * ps;
  const int stage_b = stage_bytes<T, HD>(n_max);
  float* sQ = reinterpret_cast<float*>(smem);  // [n_rep][HD]
  float* sP = sQ + n_rep * HD;                 // [n_rep][n_max]
  unsigned char* ring = smem + head_bytes<HD>(n_rep, n_max);
  const size_t slot_stride = (size_t)p.Hkv * HD;  // elements slot to slot
  const T* K = static_cast<const T*>(p.k) + g * HD;
  const T* V = static_cast<const T*>(p.v) + g * HD;

  // Each thread copies one page of a stage (tpp threads a page; a
  // stage's sp pages never outnumber the block's threads) and loads
  // that page's id one stage ahead, so no copy waits on an id.
  const int n_stages = (count + p.sp - 1) / p.sp;
  const int tpp = nthreads / p.sp, mine = tid / tpp, e0 = tid % tpp;
  auto page_id = [&](int s) {  // -1: no page of stage s for this thread
    const int i = s * p.sp + mine;
    return mine < p.sp && s < n_stages && i < count
               ? __ldg(p.pages + first + i) : -1;
  };
  // the thread's page of stage s into ring slot s % STAGES
  auto load_stage = [&](int s, int id) {
    if (id < 0) return;
    unsigned char* base = ring + (s % STAGES) * stage_b;
    const uint32_t dk = smem_u32(base) + mine * ps * ROW;
    const uint32_t dv = dk + n_max * ROW;
    const uint32_t db = smem_u32(base) + 2 * n_max * ROW + 4 * mine * ps;
    const size_t slot0 = (size_t)id * ps;
    for (int e = e0; e < ps * LPR; e += tpp) {
      const int j = e / LPR, c = e % LPR;
      const size_t off = (slot0 + j) * slot_stride + c * VEC;
      cp_async_16(dk + j * ROW + c * 16, K + off, 16);
      cp_async_16(dv + j * ROW + c * 16, V + off, 16);
    }
    for (int j = e0; j < ps; j += tpp) {
      cp_async_4(db + 4 * j, p.kv_bits + slot0 + j, 4);
      cp_async_4(db + 4 * (n_max + j), p.kv_pos + slot0 + j, 4);
    }
  };

  for (int s = 0; s < STAGES - 1; ++s) {
    load_stage(s, page_id(s));
    cp_async_commit();  // empty groups keep the count uniform
  }
  int next_id = page_id(STAGES - 1);
  float* qw = sQ + warp * HD;
  const T* qh = static_cast<const T*>(p.q) + ((size_t)b * p.H + h) * HD;
  for (int d = lane; d < HD; d += 32) qw[d] = to_f(qh[d]);
  const QueryRule qr =
      query_rule((unsigned)p.q_bits[b], p.q_pos[b], p.window);
  float* pw = sP + warp * n_max;
  // P·V: key group, first chunk (a lane's chunks are LANES apart)
  const int kg = lane / LANES, c = lane % LANES;

  float m = NEG_INF, l = 0.f;  // l: this lane's keys' share
  float acc[CPL][VEC];
#pragma unroll
  for (int u = 0; u < CPL; ++u)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[u][i] = 0.f;
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait_group<STAGES - 2>();  // this thread's copies of stage s
    // everyone's copies of stage s are in, and every warp is done with
    // the slot that stage s + STAGES - 1 refills
    __syncthreads();
    load_stage(s + STAGES - 1, next_id);
    cp_async_commit();
    next_id = page_id(s + STAGES);

    const unsigned char* base = ring + (s % STAGES) * stage_b;
    const int* sb = reinterpret_cast<const int*>(base + 2 * n_max * ROW);
    const int n = min(p.sp, count - s * p.sp) * ps;
    // scores; a forbidden key keeps exactly -1e30, which no allowed
    // score reaches
    float mx = NEG_INF;
    for (int j = lane; j < n; j += 32) {
      float x = NEG_INF;
      if (pair_allowed(qr, key_rule((unsigned)sb[j], sb[n_max + j]))) {
        const T* kr = reinterpret_cast<const T*>(base + j * ROW);
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll (SCORE_UNROLL)
        for (int cc = 0; cc < LPR; ++cc) {
          float kf[VEC];
          unpack(kr + cc * VEC, kf);
          const float4* q4 = reinterpret_cast<const float4*>(qw + cc * VEC);
#pragma unroll
          for (int i = 0; i < VEC / 4; ++i) {
            const float4 a = q4[i];
            d[0] = fmaf(kf[4 * i], a.x, d[0]);
            d[1] = fmaf(kf[4 * i + 1], a.y, d[1]);
            d[2] = fmaf(kf[4 * i + 2], a.z, d[2]);
            d[3] = fmaf(kf[4 * i + 3], a.w, d[3]);
          }
        }
        x = ((d[0] + d[1]) + (d[2] + d[3])) * p.scale;
        if (p.softcap != 0.f) x = tanhf(x / p.softcap) * p.softcap;
      }
      pw[j] = x;
      mx = fmaxf(mx, x);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (mx == NEG_INF) continue;  // no allowed key for this head here

    const float m_new = fmaxf(m, mx), alpha = expf(m - m_new);
    float ls = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float x = pw[j];
      const float e = x == NEG_INF ? 0.f : expf(x - m_new);
      pw[j] = e;
      ls += e;
    }
    l = fmaf(l, alpha, ls);
    m = m_new;
    __syncwarp();  // this warp's p row is written
#pragma unroll
    for (int u = 0; u < CPL; ++u)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[u][i] *= alpha;
    const unsigned char* vc = base + n_max * ROW + c * 16;
#pragma unroll 2
    for (int j = kg; j < n; j += G) {
      const float e = pw[j];
#pragma unroll
      for (int u = 0; u < CPL; ++u) {
        float vf[VEC];
        unpack(reinterpret_cast<const T*>(vc + u * LANES * 16 + j * ROW), vf);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[u][i] = fmaf(e, vf[i], acc[u][i]);
      }
    }
  }
  // the groups still committed hold no copies

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
  for (int o = LANES; o < 32; o <<= 1) {
#pragma unroll
    for (int u = 0; u < CPL; ++u)
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        acc[u][i] += __shfl_xor_sync(0xffffffffu, acc[u][i], o);
  }
  if (ns == 1) {  // the row's only split: normalise and write
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[u][i] *= inv;
      if (kg == 0)
        pack_store(out + ((size_t)b * p.H + h) * HD + (c + u * LANES) * VEC,
                   acc[u]);
    }
    return;
  }

  const size_t at = (size_t)w * p.H + h;
  if (kg == 0) {
#pragma unroll
    for (int u = 0; u < CPL; ++u)
      store_f32(p.part_acc + at * HD + (c + u * LANES) * VEC, acc[u]);
  }
  if (lane == 0) p.part_ml[at] = make_float2(m, l);
  // The barrier orders every thread's partials before thread 0's fence,
  // which makes them visible before its ticket (the fence is
  // cumulative); the last block's thread 0 fences again before the
  // barrier that lets its threads read the other blocks' partials.
  __syncthreads();
  int* ticket = p.tickets + b * p.Hkv + g;
  if (tid == 0) {
    __threadfence();
    is_last = atomicAdd(ticket, 1) == ns - 1;
    if (is_last) __threadfence();
  }
  __syncthreads();
  if (!is_last) return;

  // The last block of (row, KV head) merges the row's splits in
  // ascending order. The ring is idle now: each chunk of splits'
  // partials for the block's heads is gathered into it by cp.async in
  // one round trip, the first while each warp finds its head's M = max m
  // over the splits. Every split's weight exp(m - M) is then computed at
  // once, lane by lane, and the merge itself is a chain of FMAs.
  constexpr int VC = HD / 32;      // the columns a lane merges
  const int group = n_rep * HD;    // floats of one split's heads
  const int chunk = min(32, STAGES * stage_b / (group * 4));
  const float* src = p.part_acc + ((size_t)s0 * p.H + g * n_rep) * HD;
  float* gathered = reinterpret_cast<float*>(ring);
  auto gather = [&](int i0) {
    for (int i = 0; i < min(chunk, ns - i0); ++i)
      for (int r = tid; r < group / 4; r += nthreads)
        cp_async_16(smem_u32(gathered + i * group + 4 * r),
                    src + (size_t)(i0 + i) * p.H * HD + 4 * r, 16);
    cp_async_commit();
  };
  gather(0);
  const float2* ml = p.part_ml + (size_t)s0 * p.H + h;
  float M = NEG_INF;
  for (int i = lane; i < ns; i += 32)
    M = fmaxf(M, __ldcg(ml + (size_t)i * p.H).x);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
  float Lsum = 0.f, o[VC];
#pragma unroll
  for (int k = 0; k < VC; ++k) o[k] = 0.f;
  for (int i0 = 0; i0 < ns; i0 += chunk) {
    const int n = min(chunk, ns - i0);
    float wi = 0.f, li = 0.f;
    if (lane < n) {
      const float2 mi = __ldcg(ml + (size_t)(i0 + lane) * p.H);
      wi = expf(mi.x - M);
      li = mi.y;
    }
    cp_async_wait_all();
    __syncthreads();
    const float* mine_acc = gathered + warp * HD + lane * VC;
    for (int i = 0; i < n; ++i) {
      const float wgt = __shfl_sync(0xffffffffu, wi, i);
      Lsum = fmaf(wgt, __shfl_sync(0xffffffffu, li, i), Lsum);
#pragma unroll
      for (int k = 0; k < VC; ++k)
        o[k] = fmaf(wgt, mine_acc[i * group + k], o[k]);
    }
    if (i0 + chunk < ns) {
      __syncthreads();  // this chunk is merged
      gather(i0 + chunk);
    }
  }
  const float inv = Lsum > 0.f ? 1.f / Lsum : 0.f;
  T* ob = out + ((size_t)b * p.H + h) * HD + lane * VC;
#pragma unroll
  for (int k = 0; k < VC; ++k) store(ob + k, o[k] * inv);
  if (tid == 0) *ticket = 0;
}

template <typename T, int HD>
int launch(Params p, int n_empty, cudaStream_t stream) {
  const int n_rep = p.H / p.Hkv, n_max = p.sp * p.ps;
  if (p.ps > Caps<T, HD>::PAGE || n_rep > Caps<T, HD>::REP)
    return (int)cudaErrorInvalidValue;
  const int smem =
      head_bytes<HD>(n_rep, n_max) + STAGES * stage_bytes<T, HD>(n_max);
  auto kern = paged_decode_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (long)(p.n_splits + n_empty) * p.Hkv;
  if (blocks == 0) return 0;
  kern<<<(unsigned)blocks, 32 * n_rep, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/out [B,H,hd]; k/v pages
// [P,page_size,Hkv,hd]; q bits/pos int32 [B]; kv bits/pos int32
// [P,page_size]; pages int32: the active pages row by row; split_ptr
// int32 [B+1] and splits int32 [n_splits][3] (row, first index into
// pages, page count), a row's splits consecutive and in page order;
// empty int32 [n_empty]: rows with no active page. scratch: f32
// [n_splits * H * (hd + 2)]; tickets: int32 [B * Hkv], zero, and zero
// again when the kernel ends. All contiguous; hd 64, 128 or 256;
// page_size <= 64 and H / Hkv <= 32, except at hd 256: page_size <= 32
// and H / Hkv <= 16 (Caps; past them, or at another hd,
// cudaErrorInvalidValue). Returns cudaGetLastError() after the launch.
extern "C" int paged_decode(const void* q, const void* k_pages,
                            const void* v_pages, const void* q_bits,
                            const void* q_pos, const void* kv_bits,
                            const void* kv_pos, const void* pages,
                            const void* split_ptr, const void* splits,
                            const void* empty, void* out, void* scratch,
                            void* tickets, int n_splits, int n_empty, int H,
                            int Hkv, int page_size, int hd, int dtype,
                            float scale, float softcap, int window,
                            void* stream) {
  Params p;
  p.q = q;
  p.k = k_pages;
  p.v = v_pages;
  p.q_bits = static_cast<const int*>(q_bits);
  p.q_pos = static_cast<const int*>(q_pos);
  p.kv_bits = static_cast<const int*>(kv_bits);
  p.kv_pos = static_cast<const int*>(kv_pos);
  p.pages = static_cast<const int*>(pages);
  p.split_ptr = static_cast<const int*>(split_ptr);
  p.splits = static_cast<const int*>(splits);
  p.empty = static_cast<const int*>(empty);
  p.out = out;
  p.part_acc = static_cast<float*>(scratch);
  p.part_ml = reinterpret_cast<float2*>(p.part_acc + (size_t)n_splits * H * hd);
  p.tickets = static_cast<int*>(tickets);
  p.H = H;
  p.Hkv = Hkv;
  p.ps = page_size;
  p.sp = page_size >= STAGE_KEYS ? 1 : STAGE_KEYS / page_size;
  p.n_splits = n_splits;
  p.scale = scale;
  p.softcap = softcap;
  p.window = window;
  if (page_size < 1 || page_size > MAX_PAGE || Hkv < 1 || H % Hkv ||
      H / Hkv > MAX_REP)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64) return launch<float, 64>(p, n_empty, st);
  if (dtype == 0 && hd == 128) return launch<float, 128>(p, n_empty, st);
  if (dtype == 0 && hd == 256) return launch<float, 256>(p, n_empty, st);
  if (dtype == 1 && hd == 64) return launch<__nv_bfloat16, 64>(p, n_empty, st);
  if (dtype == 1 && hd == 128)
    return launch<__nv_bfloat16, 128>(p, n_empty, st);
  if (dtype == 1 && hd == 256)
    return launch<__nv_bfloat16, 256>(p, n_empty, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* paged_decode_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
