// Paged GQA attention over the flat KV page pool, for Hopper (sm_90a).
//
// Replaces the TPU kernels in distributed_inference_server_tpu/ops/pallas/
// paged_attention.py: paged_attention_decode (_decode_kernel),
// paged_attention_prefill (_prefill_kernel) and paged_attention_ragged
// (_ragged_kernel), dense pools; and paged_attention_decode over int8
// QuantPool pools (the int8 branches of _decode_kernel).
//
// Contract (identical to the plain versions in ops/kernels/paged_attention.py):
//   pool_k, pool_v : [num_slots, KV, D], slot = page * page_size + offset
//   tables         : [B, P] int32 page ids (entries past a row's last page
//                    are arbitrary; they are clamped to the pool and masked)
//   valid          : [B] int32 tokens valid in each row, incl. this step's
//   decode         : q [B, H, D], query of row b sits at position valid-1
//   prefill        : q [B, T, H, D], query t of row b at q_start[b] + t
//   ragged         : q [S, H, D], a packed token axis: token i belongs to
//                    row tok_row[i] (-1 = padding; rows >= B clamp to B-1)
//                    at position q_pos[i]. Each row's tokens are one
//                    contiguous run (runs of different rows and padding
//                    may alternate in any order).
//   mask           : kv <= q_pos, kv < valid, and kv > q_pos - window when
//                    window > 0; softcap (tanh(s/cap)*cap) BEFORE the mask
//   queries with nothing visible, and padding tokens, write zeros.
//   int8 decode    : pool_k, pool_v hold int8 codes [num_slots, KV, D] and
//                    k_scale, v_scale [num_slots, KV] f32 (K/V = code x
//                    scale, ops/quant.py quantize_kv); only decode reads
//                    them.
//
// Common design (prefill, ragged, the scalar bodies). A block owns one tile
// of queries of one row and one KV head: the G = H/KV query heads of that
// KV head share every K/V byte the block loads, so the pool is read once
// per (row, KV head, query tile) instead of once per query head. The block
// walks the row's tokens from the window's lower edge to min(valid, last
// query + 1) in tiles: it reads each token's page id from the table
// (clamped), loads the tile's K and V into shared memory with 16-byte
// loads, scores it, and updates an online softmax in f32. A Tile says which
// queries (first token, count, positions) and which KV range a block
// serves; prefill and ragged differ only in how a block finds its Tile.
//
// Ragged (the engine's mixed step: decode rows and prefill chunks in one
// launch). The packed axis is cut into SEGMENTS: maximal runs of one row's
// tokens inside one TQ-wide window of the axis (TQ = the body's query tile).
// Segment starts are the tokens i with tok_row[i] >= 0 and (i % TQ == 0 or
// tok_row[i-1] != tok_row[i]); with each row contiguous there are at most
// ceil(S/TQ) + B of them, the grid's static size, so nothing is read back
// to the host. Block x finds the x-th start itself (a block-wide count over
// tok_row, a few KB from L2) and exits if there is none; split 0 of the
// blocks x < ceil(S/TQ) also writes the zeros of window x's padding tokens.
//
// Bodies:
// - decode_attend<D, Q8>: bf16 decode, D in {64, 128, 256}, G <= 64, dense
//   or int8 pools (below).
// - attend_wg<D>: bf16 prefill and ragged, D in {64, 128, 256}, G <= 64
//   (below).
// - everything else (f32, other head sizes, decode too): a scalar body —
//   one warp per query row for the scores, one thread per (row, dim)
//   output for P @ V.
//
// The prefill / ragged body (replaces _prefill_kernel of
// paged_attention_prefill and _ragged_kernel of paged_attention_ragged).
// Prefill is bound by operations: a [4, 512] chunk over histories up to
// 1537 tokens does 4 flops per (query head, visible key, dim), 8.8 GFLOP
// at llama-3.2-1b's shape, 8.9 us at 989 TFLOP/s, while its bytes (q and
// out, the visible K/V read once) take 6.5 us. Ragged is bound by bytes at
// the served mix (most of its 512 tokens are short chunks; its decode rows
// read 2 KB of K/V per key for 4 flops per byte pair). What kept the first
// tensor-core body from either bound was a serial chain per block
// (synchronous loads, scalar fragment loads, a transposed V, every element
// masked) and, for ragged, the longest row's whole history in one block.
// The design answers each:
// - 128 (query, head) rows per block on two warpgroups, 64 each (TQ = 128 /
//   G queries: 32 at both served geometries), so a row's history is read
//   once per 32 queries, not per 16.
// - A ring of four 64-key stages (32-key at D 256, whose query tile takes
//   64 KB) in dynamic shared memory filled by cp.async 16-byte copies, one
//   commit group per stage; the block's page ids are loaded into shared
//   memory once. K and V both lie row-major in
//   128-byte-swizzled rows, and the tensor cores read them as they lie:
//   S = Q K^T is wgmma m64n64k16 (m64n32k16 at D 256) with the query tile and K as K-major
//   shared-memory operands; O += P V is wgmma m64nDk16 with P from
//   registers (the S accumulators packed to bf16 are wgmma's A fragment as
//   they lie) and V as the transposed (N-major) B operand. No scalar
//   transpose and no fragment loads.
// - One block barrier per stage. The next stage's copies are issued while
//   S runs on the tensor cores, and a stage's P V is waited for only in
//   the next stage's step, under its barrier, copies and Q K^T.
// - The mask runs only on tiles that cross the causal diagonal, the window
//   edge or the range's end; O is rescaled only where a row's max moved.
// - Prefill launches its query tiles heaviest first (a row's last tile,
//   with the most keys, first; grid z reversed), statically.
// - KV split: the wrapper's plan (attend_plan: from the table capacity, the
//   grid's static size and the body's resident blocks per SM, never the
//   data) cuts every tile's range at multiples of `chunk` tokens over grid
//   x; prefill splits only where its grid leaves SMs idle, ragged caps a
//   split at a few stages, so a 2048-token decode row or a 1500-deep chunk
//   spreads over several blocks. A tile whose keys fall in one split
//   writes its output directly; otherwise each split writes (max, sum,
//   unnormalized output) and the last split of the (tile, KV head) to
//   finish, found with an atomic ticket, adds them in split order and
//   resets the ticket: one launch, and the result does not depend on which
//   block came last.
// Known limits, left for later work: the two warpgroups run each stage in
// step (one block barrier), so the softmax of one does not overlap the
// other's products, and the block's chain per stage (Q K^T, wait, softmax,
// P V) is serial: about 1.9 us a stage at D 64 (PERF.md); no TMA and
// no producer warp; a decode row in the ragged launch fills 4 (G) of a
// block's 128 rows; splits without keys still search for their segment.
//
// The decode body (replaces _decode_kernel of paged_attention_decode, dense
// and int8 QuantPool pools). Bound: bytes. A row's visible K/V is read once
// for ~4 flops per K/V byte pair, far below the card's ~295 bf16 flops per
// byte (B = 8 rows of up to 2048 keys at llama-3.2-1b's shape: 11.1 MB,
// 3.35 us at 3.35 TB/s). What kept the first tensor-core decode far from
// that was latency and layout, not bytes, and the design answers each:
// - A ring of 64-token K/V stages in dynamic shared memory filled by
//   cp.async 16-byte copies, one commit group per stage: the next stages
//   stay in flight while one is computed, and a stage costs one block
//   barrier. Three stages where three blocks still fit an SM (D 64), else
//   two (D 128): a smaller ring lets more blocks share an SM, so the
//   one-wave plan takes more, shorter splits (dense D 64: 4 blocks per SM
//   and 8 splits of 256 tokens at the served shape, against 3 and 6 with
//   four stages), and a block's stages run one after another; D 256 takes
//   two. The split's page ids are loaded into shared memory once; a
//   copy's slot is a shift and a shared read.
// - At D 256 the query rows sit in shared memory and each k-step's A
//   fragment comes from ldmatrix: the registers go to the output
//   accumulator (128 floats a thread) instead of 64 query fragments.
// - Every warp computes. The G query heads fill m16 tiles (one for G <= 16,
//   the served shapes); the warps split the keys: with one m16 tile, warp w
//   takes the 16-key slice w of every stage (with MT tiles, 4 / MT groups
//   of warps take every (4 / MT)-th slice). Each warp keeps its own running
//   max, sum and accumulator; the block merges them through shared memory
//   at its end.
// - Fragments come from ldmatrix: K from row-major rows, V from row-major
//   rows with .trans (no scalar transpose).
// - flash-decoding: each row's KV range is split over grid z so B x KV x
//   splits blocks fill the SMs; the wrapper plans the split from the table
//   capacity and the body's resident blocks per SM (one wave), never from
//   the data. Blocks whose split has no keys exit at once. A row whose keys
//   fall in one split writes its output directly; otherwise each split
//   writes a partial (max, sum, unnormalized output) and the last split of
//   the (row, KV head) to finish, found with an atomic ticket, adds them in
//   split order and resets the ticket: one launch, and the result does not
//   depend on which block came last.
// - int8 pools (Q8): the ring holds the raw codes and their f32 scales
//   (2 D + 8 bytes per token and KV head instead of 4 D: about half the
//   bytes in flight); each warp converts its slice to bf16 (exact, |code|
//   <= 127; a byte permute into 2^23's mantissa, no I2F) into a slice of
//   its own before the MMAs. The scales fold in as the TPU kernel folds
//   them: each score is multiplied by its key's k_scale after Q.K and
//   before softcap and mask, each probability by its key's v_scale before
//   P.V, and the softmax sum keeps the unscaled probabilities.
// Known limits, left for later work: no TMA, no warp specialisation, and a
// split plan that cannot know which rows are long, so a long row's few
// busy blocks may share an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // finite: fully-masked rows stay finite

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Args {
  const void* q;
  const void* pool_k;
  const void* pool_v;
  const int* tables;
  const int* q_start;  // prefill only
  const int* valid;
  const int* tok_row;  // ragged only: [S] owning row (-1 = padding)
  const int* q_pos;    // ragged only: [S] absolute positions
  void* out;
  int T;  // queries per row (1 for decode); ragged: the packed length S
  int B;  // rows of tables / valid
  int H, KV, D;
  int page_size, P, num_pages;
  int window;     // <= 0: full causal
  float softcap;  // <= 0: off
  float scale;    // 1/sqrt(D)
  int TQ, TK;     // queries / kv tokens per tile
};

// int8 pools only: the f32 scales [num_slots, KV] of the K and V codes. Kept
// out of Args, which every kernel takes by value: growing Args changed the
// register allocation of the bf16 bodies and slowed them.
struct Scales {
  const float* k;
  const float* v;
};

// The queries one block serves and the KV tokens [lo, hi) it walks. Query
// t < n is token tok0 + t of the [tokens, H, D] view of q and out, at
// position pos[t] (ragged) or pos0 + t (decode, prefill).
struct Tile {
  int b;  // page-table row
  int n;  // queries in the tile (0: nothing to do)
  size_t tok0;
  const int* pos;
  int pos0;
  int lo, hi;
  int qmin, qmax;  // least and greatest query position
};

__device__ __forceinline__ int tile_pos(const Tile& tl, int t) {
  return tl.pos ? tl.pos[t] : tl.pos0 + t;
}

__device__ __forceinline__ int window_lo(const Args& a, int first_pos) {
  return a.window > 0 ? max(first_pos - a.window + 1, 0) : 0;
}

// Pool slot of position pos of page-table row b (page ids clamped).
__device__ __forceinline__ size_t pool_slot(const Args& a, int b, int pos) {
  const int pslot = min(pos / a.page_size, a.P - 1);
  int page = a.tables[(size_t)b * a.P + pslot];
  page = min(max(page, 0), a.num_pages - 1);
  return (size_t)page * a.page_size + pos % a.page_size;
}

// int8 pools: the K and V scales of tokens k0 .. k0+TK-1 (zeros past hi).
__device__ __forceinline__ void load_kv_scales(const Args& a, const Scales& sc,
                                               int b, int kvh, int k0, int TK,
                                               int hi, float* ks_s,
                                               float* vs_s) {
  for (int j = threadIdx.x; j < TK; j += blockDim.x) {
    const int pos = k0 + j;
    float ks = 0.f, vs = 0.f;
    if (pos < hi) {
      const size_t i = pool_slot(a, b, pos) * a.KV + kvh;
      ks = sc.k[i];
      vs = sc.v[i];
    }
    ks_s[j] = ks;
    vs_s[j] = vs;
  }
}

// The 16 int8 codes of a uint4 as floats.
__device__ __forceinline__ float code_at(const uint4& v, int e) {
  const uint32_t w = e < 4 ? v.x : e < 8 ? v.y : e < 12 ? v.z : v.w;
  return (float)(int8_t)(uint8_t)(w >> (8 * (e & 3)));
}

// Decode (one query per row) or prefill (queries q0 .. q0+TQ-1 of row b).
__device__ Tile dense_tile(const Args& a, int b, int q0, int TQ,
                           bool decode) {
  Tile tl;
  const int vb = a.valid[b];
  tl.b = b;
  tl.n = decode ? 1 : min(TQ, a.T - q0);
  tl.tok0 = (size_t)b * a.T + q0;
  tl.pos = nullptr;
  tl.pos0 = decode ? vb - 1 : a.q_start[b] + q0;
  tl.lo = window_lo(a, tl.pos0);
  tl.hi = min(vb, tl.pos0 + tl.n);
  tl.qmin = tl.pos0;
  tl.qmax = tl.pos0 + tl.n - 1;
  return tl;
}

// Ragged: segment `seg` of the packed axis (see the header). Every thread
// of the block must call it; n == 0 when there are at most `seg` segments.
__device__ Tile ragged_tile(const Args& a, int seg, int TQ) {
  __shared__ int sh_cnt[32];
  __shared__ int sh_start, sh_end, sh_lo, sh_hi;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int S = a.T;
  if (tid == 0) sh_start = -1;
  __syncthreads();
  int base = 0;  // segment starts before this chunk (same in every thread)
  for (int c0 = 0; c0 < S && base <= seg; c0 += blockDim.x) {
    const int i = c0 + tid;
    bool f = false;
    if (i < S) {
      const int r = a.tok_row[i];
      f = r >= 0 && (i % TQ == 0 || a.tok_row[i - 1] != r);
    }
    const unsigned m = __ballot_sync(0xffffffffu, f);
    if (lane == 0) sh_cnt[warp] = __popc(m);
    __syncthreads();
    int before = base, total = 0;
    for (int w = 0; w < nw; ++w) {
      if (w < warp) before += sh_cnt[w];
      total += sh_cnt[w];
    }
    if (f && before + __popc(m & ((1u << lane) - 1u)) == seg) sh_start = i;
    base += total;
    __syncthreads();
  }
  Tile tl;
  tl.n = 0;
  const int start = sh_start;
  if (start < 0) return tl;
  const int r0 = a.tok_row[start];
  if (tid == 0) {
    sh_end = min((start / TQ + 1) * TQ, S);
    sh_lo = 0x7fffffff;
    sh_hi = -0x7fffffff;
  }
  __syncthreads();
  for (int t = tid; t < TQ; t += blockDim.x) {
    const int j = start + t;
    if (j < S && a.tok_row[j] != r0) atomicMin(&sh_end, j);
  }
  __syncthreads();
  const int end = sh_end;
  for (int j = start + tid; j < end; j += blockDim.x) {
    atomicMin(&sh_lo, a.q_pos[j]);
    atomicMax(&sh_hi, a.q_pos[j]);
  }
  __syncthreads();
  tl.b = min(r0, a.B - 1);
  tl.n = end - start;
  tl.tok0 = start;
  tl.pos = a.q_pos + start;
  tl.pos0 = 0;
  tl.lo = window_lo(a, sh_lo);
  tl.hi = min(a.valid[tl.b], sh_hi + 1);
  tl.qmin = sh_lo;
  tl.qmax = sh_hi;
  return tl;
}

// Ragged: zeros for the padding tokens of window w (the G heads of kvh).
// The window's rows are read once into shared memory, then each thread
// stores 16 zero bytes at a time.
constexpr int kMaxTQ = 128;  // queries a ragged block serves, at most

template <typename T>
__device__ void zero_padding(const Args& a, int w, int TQ, int kvh) {
  __shared__ bool pad_s[kMaxTQ];
  const int G = a.H / a.KV, GV = G * a.D * (int)sizeof(T) / 16;
  for (int t = threadIdx.x; t < TQ; t += blockDim.x) {
    const int tok = w * TQ + t;
    pad_s[t] = tok < a.T && a.tok_row[tok] < 0;
  }
  __syncthreads();
  T* out = static_cast<T*>(a.out);
  for (int i = threadIdx.x; i < TQ * GV; i += blockDim.x) {
    const int t = i / GV;
    if (pad_s[t])
      reinterpret_cast<uint4*>(
          out + ((size_t)(w * TQ + t) * a.H + kvh * G) * a.D)[i - t * GV] =
          make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename T>
__host__ __device__ constexpr int kt_pad() {
  return 4 / (int)sizeof(T);  // one 32-bit word: kT rows land on new banks
}

// Shared memory: [v TK x D][q R x D][kT D x (TK+pad)] in T, then f32
// [scores R x TK][m R][l R][alpha R] and, for int8 pools, [k scales TK]
// [v scales TK].
template <typename T>
size_t smem_bytes(int R, int D, int TK, bool int8_pool = false) {
  const size_t e = sizeof(T);
  return (size_t)TK * D * e + (size_t)R * D * e +
         (size_t)D * (TK + kt_pad<T>()) * e + ((size_t)R * TK + 3 * R) * 4 +
         (int8_pool ? (size_t)2 * TK * 4 : 0);
}

// KT: the pool's element type — T (dense) or int8_t (codes + scales).
template <typename T, typename KT, int NT, int MAXACC>
__device__ void attend(const Args& a, const Tile& tl, int kvh,
                       const Scales& sc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr bool Q8 = std::is_same<KT, int8_t>::value;
  constexpr int NW = NT / 32;
  constexpr int VEC = 16 / (int)sizeof(KT);  // pool elements per 16 bytes
  const int G = a.H / a.KV;
  const int TK = a.TK, D = a.D;
  const int R = a.TQ * G;
  const int TKP = TK + kt_pad<T>();
  T* v_s = reinterpret_cast<T*>(smem_raw);
  T* q_s = v_s + TK * D;
  T* kT_s = q_s + R * D;
  float* s_s = reinterpret_cast<float*>(kT_s + D * TKP);
  float* m_s = s_s + R * TK;
  float* l_s = m_s + R;
  float* al_s = l_s + R;
  float* ks_s = al_s + R;  // int8 pools only
  float* vs_s = ks_s + TK;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* q = static_cast<const T*>(a.q);
  const KT* pk = static_cast<const KT*>(a.pool_k);
  const KT* pv = static_cast<const KT*>(a.pool_v);
  T* out = static_cast<T*>(a.out);

  const int kv_upper = tl.hi;
  const int eff_w = a.window > 0 ? a.window : (1 << 30);

  for (int i = tid; i < R * D; i += NT) {
    const int r = i / D, d = i - r * D;
    const int t = r / G, g = r - t * G;
    q_s[i] = t < tl.n
                 ? q[((tl.tok0 + t) * a.H + kvh * G + g) * D + d]
                 : from_f<T>(0.f);
  }
  for (int r = tid; r < R; r += NT) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  float acc[MAXACC];
#pragma unroll
  for (int i = 0; i < MAXACC; ++i) acc[i] = 0.f;
  __syncthreads();

  const int DV = D / VEC;
  for (int k0 = tl.lo; k0 < kv_upper; k0 += TK) {
    // K (transposed) and V of tokens k0 .. k0+TK-1; past kv_upper: zeros
    for (int i = tid; i < TK * DV; i += NT) {
      const int j = i / DV, dv = i - j * DV;
      const int pos = k0 + j;
      uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = kk;
      if (pos < kv_upper) {
        const int pslot = min(pos / a.page_size, a.P - 1);
        int page = a.tables[(size_t)tl.b * a.P + pslot];
        page = min(max(page, 0), a.num_pages - 1);
        const size_t slot = (size_t)page * a.page_size + pos % a.page_size;
        const size_t off = (slot * a.KV + kvh) * D + (size_t)dv * VEC;
        kk = *reinterpret_cast<const uint4*>(pk + off);
        vv = *reinterpret_cast<const uint4*>(pv + off);
      }
      if constexpr (Q8) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          v_s[j * D + dv * VEC + e] = from_f<T>(code_at(vv, e));
          kT_s[(dv * VEC + e) * TKP + j] = from_f<T>(code_at(kk, e));
        }
      } else {
        *reinterpret_cast<uint4*>(v_s + j * D + dv * VEC) = vv;
        const T* ke = reinterpret_cast<const T*>(&kk);
#pragma unroll
        for (int e = 0; e < VEC; ++e) kT_s[(dv * VEC + e) * TKP + j] = ke[e];
      }
    }
    if constexpr (Q8)
      load_kv_scales(a, sc, tl.b, kvh, k0, TK, kv_upper, ks_s, vs_s);
    __syncthreads();

    // scores: one warp per query row, one lane per token
    for (int r = warp; r < R; r += NW) {
      const int t = r / G;
      const bool row_ok = t < tl.n;
      const int qpos = row_ok ? tile_pos(tl, t) : 0;
      const T* qr = q_s + r * D;
      for (int j = lane; j < TK; j += 32) {
        float s = 0.f;
        for (int d = 0; d < D; ++d) s += to_f(qr[d]) * to_f(kT_s[d * TKP + j]);
        if constexpr (Q8) s *= ks_s[j];
        s *= a.scale;
        if (a.softcap > 0.f) s = tanhf(s / a.softcap) * a.softcap;
        const int kv = k0 + j;
        const bool ok = row_ok && kv < kv_upper && kv <= qpos &&
                        kv > qpos - eff_w;
        s_s[r * TK + j] = ok ? s : kNegInf;
      }
    }
    __syncthreads();

    // online softmax in f32: one warp per row; probabilities overwrite
    // the scores in place
    for (int r = warp; r < R; r += NW) {
      float mx = kNegInf;
      for (int j = lane; j < TK; j += 32) mx = fmaxf(mx, s_s[r * TK + j]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < TK; j += 32) {
        const float s = s_s[r * TK + j];
        const float p = s > 0.5f * kNegInf ? expf(s - m_new) : 0.f;
        s_s[r * TK + j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        al_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P @ V; thread owns outputs idx = tid + i*NT
#pragma unroll
    for (int i = 0; i < MAXACC; ++i) {
      const int idx = tid + i * NT;
      if (idx < R * D) {
        const int r = idx / D, d = idx - r * D;
        const float* pr = s_s + r * TK;
        float v = acc[i] * al_s[r];
        if constexpr (Q8) {
          for (int j = 0; j < TK; ++j)
            v += pr[j] * vs_s[j] * to_f(v_s[j * D + d]);
        } else {
          for (int j = 0; j < TK; ++j) v += pr[j] * to_f(v_s[j * D + d]);
        }
        acc[i] = v;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < MAXACC; ++i) {
    const int idx = tid + i * NT;
    if (idx < R * D) {
      const int r = idx / D, d = idx - r * D;
      const int t = r / G, g = r - t * G;
      if (t < tl.n) {
        out[((tl.tok0 + t) * a.H + kvh * G + g) * D + d] =
            from_f<T>(acc[i] / fmaxf(l_s[r], 1e-30f));
      }
    }
  }
}

constexpr int kDecodeThreads = 128, kDecodeAcc = 8, kDecodeTK = 64;
constexpr int kPrefillThreads = 256, kPrefillAcc = 32, kPrefillTK = 32;

template <typename T, typename KT, int NT, int MAXACC>
__global__ void __launch_bounds__(NT) paged_decode_kernel(Args a, Scales sc) {
  attend<T, KT, NT, MAXACC>(a, dense_tile(a, blockIdx.x, 0, 1, true),
                            blockIdx.y, sc);
}

template <typename T, int NT, int MAXACC>
__global__ void __launch_bounds__(NT) paged_prefill_kernel(Args a) {
  attend<T, T, NT, MAXACC>(
      a, dense_tile(a, blockIdx.x, blockIdx.z * a.TQ, a.TQ, false),
      blockIdx.y, Scales{nullptr, nullptr});
}

template <typename T, int NT, int MAXACC>
__global__ void __launch_bounds__(NT) paged_ragged_kernel(Args a) {
  if (blockIdx.x * a.TQ < a.T) zero_padding<T>(a, blockIdx.x, a.TQ, blockIdx.y);
  const Tile tl = ragged_tile(a, blockIdx.x, a.TQ);
  if (tl.n == 0) return;
  attend<T, T, NT, MAXACC>(a, tl, blockIdx.y, Scales{nullptr, nullptr});
}

// Ragged grid width: one block per possible segment (see the header).
inline int ragged_blocks(const Args& a, int TQ) {
  return (a.T + TQ - 1) / TQ + a.B;
}

template <typename Kern>
cudaError_t set_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, typename KT = T>
int launch_decode(Args a, int B, cudaStream_t st,
                  Scales sc = Scales{nullptr, nullptr}) {
  constexpr int NT = kDecodeThreads, MAXACC = kDecodeAcc;
  const int G = a.H / a.KV;
  a.T = 1;
  a.TQ = 1;
  a.TK = kDecodeTK;
  if (G * a.D > NT * MAXACC) return (int)cudaErrorInvalidValue;
  const size_t smem =
      smem_bytes<T>(G, a.D, a.TK, std::is_same<KT, int8_t>::value);
  auto kern = paged_decode_kernel<T, KT, NT, MAXACC>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(B, a.KV), NT, smem, st>>>(a, sc);
  return (int)cudaGetLastError();
}

// Scalar prefill/ragged query tile: the largest power of two whose outputs
// fit the registers and that a short chunk does not overshoot by more than
// 2x; 0 when even one query's G heads do not fit.
int scalar_tq(const Args& a) {
  const int cap = kPrefillThreads * kPrefillAcc;
  const int G = a.H / a.KV;
  int TQ = 32;
  while (TQ > 1 && (TQ * G * a.D > cap || TQ / 2 >= a.T)) TQ /= 2;
  return TQ * G * a.D > cap ? 0 : TQ;
}

template <typename T>
int launch_prefill(Args a, int B, cudaStream_t st) {
  constexpr int NT = kPrefillThreads, MAXACC = kPrefillAcc;
  const int TQ = scalar_tq(a);
  if (TQ == 0) return (int)cudaErrorInvalidValue;
  a.TQ = TQ;
  a.TK = kPrefillTK;
  const size_t smem = smem_bytes<T>(TQ * (a.H / a.KV), a.D, a.TK);
  auto kern = paged_prefill_kernel<T, NT, MAXACC>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(B, a.KV, (a.T + TQ - 1) / TQ), NT, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ragged(Args a, cudaStream_t st) {
  constexpr int NT = kPrefillThreads, MAXACC = kPrefillAcc;
  const int TQ = scalar_tq(a);
  if (TQ == 0) return (int)cudaErrorInvalidValue;
  a.TQ = TQ;
  a.TK = kPrefillTK;
  const size_t smem = smem_bytes<T>(TQ * (a.H / a.KV), a.D, a.TK);
  auto kern = paged_ragged_kernel<T, NT, MAXACC>;
  cudaError_t e = set_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(ragged_blocks(a, TQ), a.KV), NT, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// tensor-core helpers (the decode body's mma.sync; the prefill / ragged
// body's wgmma further down)
// ---------------------------------------------------------------------------

constexpr int kMmaMaxG = 64;  // query heads per KV head the bf16 bodies take

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

bool mma_ok(int dtype, int D, int G) {
  return dtype == 1 && (D == 64 || D == 128 || D == 256) && G >= 1 &&
         G <= kMmaMaxG;
}

// ---------------------------------------------------------------------------
// bf16 decode body (see the header): a cp.async ring, every warp on the
// keys, the split merge in the same launch
// ---------------------------------------------------------------------------

constexpr int kDecThreads = 128;   // 4 warps
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecTK = 64;         // KV tokens per ring stage, 16 per warp
constexpr int kDecMaxPages = 256;  // page ids a block keeps in shared memory
constexpr int kDecMergeBatch = 8;  // partials the merge requests at once
constexpr float kLog2e = 1.4426950408889634f;

struct DecArgs {
  const __nv_bfloat16* q;  // [B, H, D]
  const void* pool_k;      // [slots, KV, D] bf16, or int8 codes
  const void* pool_v;
  const float* k_scale;    // int8 pools: [slots, KV]
  const float* v_scale;
  const int* tables;       // [B, P]
  const int* valid;        // [B]
  __nv_bfloat16* out;      // [B, H, D]
  float* part_o;           // [B, H, NS, D] unnormalized partial outputs
  float* part_ml;          // [B, H, NS, 2] partial max (log2 units), sum
  int* ticket;             // [B * KV] split counters, zero between launches
  int H, KV, G;
  int page_size, ps_shift;  // ps_shift = log2(page_size), or -1
  int P, num_pages;
  int window;     // <= 0: full causal
  float softcap;  // <= 0: off
  float scale;    // 1/sqrt(D)
  int NS, chunk;  // KV splits per row, tokens per split (whole stages)
};

// Dynamic shared memory of decode_attend<D, Q8>: the ring of K and V tiles
// (bf16 rows padded by 8 elements so ldmatrix rows land on distinct banks,
// or raw int8 codes plus their f32 scales), then for int8 pools one bf16
// K and V slice per warp (the converted codes), then at D 256 the query
// tiles (padded rows, read by ldmatrix: the registers go to the output
// accumulator, 128 a thread), then the block's page ids. The end-of-block
// merge reuses the ring.
constexpr int cmax(int x, int y) { return x > y ? x : y; }

template <int D, bool Q8>
struct DecSmem {
  static constexpr int KS = D + 8;  // bf16 row stride (elements)
  static constexpr int ROW = Q8 ? D : KS * 2;  // bytes per token row
  static constexpr int TILE = kDecTK * ROW;    // K (or V) bytes per stage
  static constexpr int STAGE = 2 * TILE + (Q8 ? 2 * kDecTK * 4 : 0);
  static constexpr int RED = kDecWarps * (16 * D + 32) * 4;  // o, m, l
  static constexpr int SLICE = 16 * KS * 2;  // one warp's K (or V) slice
  static constexpr int CONV = Q8 ? kDecWarps * 2 * SLICE : 0;
  static constexpr bool QSM = D > 128;  // query fragments from shared memory
  static constexpr int QS = QSM ? (kMmaMaxG / 16) * SLICE : 0;
  static constexpr int OTHER = CONV + QS + kDecMaxPages * 4;
  // three stages where three blocks (and their 1 KB of reserve) still
  // fit an SM's 228 KB, else two
  static constexpr int STAGES =
      3 * (cmax(3 * STAGE, RED) + OTHER + 1024) <= 233472 ? 3 : 2;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int BODY = cmax(RING, RED);
  static constexpr int BYTES = BODY + OTHER;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte (or 4-byte) copy global -> shared in the background; the bytes
// past `n` (0 or the full size here) are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory (lanes 8i .. 8i+7 give the
// row addresses of matrix i); .trans transposes each.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// Two int8 codes (bytes j, j + 1 of `u`, sign bits flipped: c + 128) as a
// packed bf16 pair, exactly: each byte becomes the low mantissa byte of
// 2^23, 2^23 + 128 is subtracted in f32, and |c| <= 128 rounds to itself.
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t u, int j) {
  const float lo =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | j)) - 8388736.f;
  const float hi =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | (j + 1))) -
      8388736.f;
  return pack_bf16(lo, hi);
}

// 16 consecutive codes of a slice row -> 16 bf16 values in `dst`.
__device__ __forceinline__ void convert16(const int8_t* src,
                                          __nv_bfloat16* dst) {
  const uint4 w = *reinterpret_cast<const uint4*>(src);
  const uint32_t u[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u,
                         w.z ^ 0x80808080u, w.w ^ 0x80808080u};
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(codes_bf16x2(u[0], 0), codes_bf16x2(u[0], 2),
                    codes_bf16x2(u[1], 0), codes_bf16x2(u[1], 2));
  d[1] = make_uint4(codes_bf16x2(u[2], 0), codes_bf16x2(u[2], 2),
                    codes_bf16x2(u[3], 0), codes_bf16x2(u[3], 2));
}

// One block per (row b, KV head, split z): grid (B, KV, NS). The G query
// heads of the KV head take MT = ceil(G / 16) m16 tiles; warp w serves
// tile w % MT and key group w / MT (KW = 4 / MT groups): within every
// 64-token stage, group k takes the 16-key slices k, k + KW, ... Each warp
// keeps its own running max, sum and accumulator; the block merges its
// warps at the end, then (NS > 1) the last block of the (row, KV head) to
// finish merges the splits.
template <int D, bool Q8>
__global__ void __launch_bounds__(kDecThreads) decode_attend(DecArgs a) {
  using L = DecSmem<D, Q8>;
  constexpr int KS = L::KS;
  constexpr int DK = D / 16;                 // k16 steps over the head dim
  constexpr int DN = D / 8;                  // output n8 tiles
  constexpr int CPR = Q8 ? D / 16 : D / 8;   // 16-byte chunks per token row
  constexpr int CPT = kDecTK * CPR / kDecThreads;  // per thread, K or V
  constexpr int JSTEP = kDecThreads / CPR;   // tokens between them
  constexpr int RW = 16 * D + 32;            // merge floats per warp
  extern __shared__ __align__(16) unsigned char dsm[];
  __nv_bfloat16* q_s =
      reinterpret_cast<__nv_bfloat16*>(dsm + L::BODY + L::CONV);
  int* pg_s = reinterpret_cast<int*>(dsm + L::BODY + L::CONV + L::QS);
  __shared__ int last;

  const int b = blockIdx.x, kvh = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.G;
  const size_t head0 = (size_t)b * a.H + (size_t)kvh * G;  // first head

  // Three loads at once, none waiting on another: the row's length, the
  // page ids of this split's range of the table (clamped into the pool),
  // and this warp's query fragments.
  auto page_of = [&](int pos) {
    return a.ps_shift >= 0 ? pos >> a.ps_shift : pos / a.page_size;
  };
  const int cap = a.P * a.page_size;
  const int p_first = page_of(min(z * a.chunk, cap - 1));
  const int np =
      cap > 0 ? page_of(min((z + 1) * a.chunk, cap) - 1) - p_first + 1 : 0;
  int pg[kDecMaxPages / kDecThreads];
#pragma unroll
  for (int r = 0; r < kDecMaxPages / kDecThreads; ++r) {
    const int i = tid + r * kDecThreads;
    pg[r] = i < np ? a.tables[(size_t)b * a.P + p_first + i] : 0;
  }
  // this warp's m16 tile of heads and key group
  const int MT = (G + 15) / 16, KW = kDecWarps / MT;
  const int mt = warp % MT, kg = warp / MT;
  const bool computes = kg < KW;
  uint32_t qf[L::QSM ? 1 : DK][4];
  if constexpr (!L::QSM) {
#pragma unroll
    for (int kk = 0; kk < DK; ++kk)
#pragma unroll
      for (int rg = 0; rg < 4; ++rg) {
        const int g = mt * 16 + (lane >> 2) + ((rg & 1) ? 8 : 0);
        const int col = kk * 16 + (lane & 3) * 2 + ((rg & 2) ? 8 : 0);
        qf[kk][rg] = g < G ? *reinterpret_cast<const uint32_t*>(
                                 a.q + (head0 + g) * D + col)
                           : 0u;
      }
  }
  const int valid = a.valid[b];

  // the row's visible keys [lo, hi): the query sits at valid - 1; keys
  // past the table's capacity are not read
  const int hi = max(0, min(valid, cap));
  const int lo = a.window > 0 ? max(valid - a.window, 0) : 0;
  if (hi <= lo) {  // nothing visible: zeros, written by split 0
    if (z == 0)
      for (int i = tid; i < G * D; i += kDecThreads)
        a.out[head0 * D + i] = __float2bfloat16(0.f);
    return;
  }
  const int z0 = lo / a.chunk, z1 = (hi - 1) / a.chunk;
  if (z < z0 || z > z1) return;  // a split with no keys
  const int nact = z1 - z0 + 1;  // splits of this row with keys
  const int t_begin = max(lo, z * a.chunk);
  const int t_end = min(hi, (z + 1) * a.chunk);
  const int ntiles = (t_end - t_begin + kDecTK - 1) / kDecTK;
#pragma unroll
  for (int r = 0; r < kDecMaxPages / kDecThreads; ++r)
    if (tid + r * kDecThreads < np)
      pg_s[tid + r * kDecThreads] = min(max(pg[r], 0), a.num_pages - 1);
  if constexpr (L::QSM) {  // the heads' query rows, zeros past G
    for (int i = tid; i < MT * 16 * (D / 8); i += kDecThreads) {
      const int g = i / (D / 8), c = i % (D / 8);
      *reinterpret_cast<uint4*>(q_s + g * KS + c * 8) =
          g < G ? *reinterpret_cast<const uint4*>(a.q + (head0 + g) * D +
                                                  c * 8)
                : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __syncthreads();  // pg_s, q_s

  // stage copies: this thread moves the 16-byte chunk cc of token rows
  // j0, j0 + JSTEP, ... of K and V (the same pool offsets for both)
  const char* pk = static_cast<const char*>(a.pool_k);
  const char* pv = static_cast<const char*>(a.pool_v);
  const int cc = tid % CPR, j0 = tid / CPR;
  const size_t slot_bytes = (size_t)a.KV * D * (Q8 ? 1 : 2);
  const size_t col_bytes = (size_t)kvh * D * (Q8 ? 1 : 2) + cc * 16;
  auto slot_of = [&](int pos) {
    const int p = page_of(pos);
    return (size_t)pg_s[p - p_first] * a.page_size + (pos - p * a.page_size);
  };
  auto issue = [&](int t) {  // tile t -> stage t % STAGES, one group each
    if (t < ntiles) {
      unsigned char* st = dsm + (t % L::STAGES) * L::STAGE;
      const int k0 = t_begin + t * kDecTK;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = j0 + c * JSTEP, pos = k0 + j;
        const bool in = pos < t_end;
        const size_t off = in ? slot_of(pos) * slot_bytes + col_bytes : 0;
        cp_async16(st + j * L::ROW + cc * 16, pk + off, in ? 16 : 0);
        cp_async16(st + L::TILE + j * L::ROW + cc * 16, pv + off,
                   in ? 16 : 0);
      }
      if constexpr (Q8) {  // threads 0-63: k scales; 64-127: v scales
        const int j = tid % kDecTK, pos = k0 + j;
        const bool in = pos < t_end;
        const size_t i = in ? slot_of(pos) * a.KV + kvh : 0;
        cp_async4(st + 2 * L::TILE + (tid / kDecTK) * kDecTK * 4 + j * 4,
                  (tid < kDecTK ? a.k_scale : a.v_scale) + i, in ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  float o[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  // running max (log2 units, shared by the 4 lanes of a row) and this
  // lane's share of the row's sum (added over the 4 lanes at the end)
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  const float inv_cap = a.softcap > 0.f ? 1.f / a.softcap : 0.f;

#pragma unroll
  for (int t = 0; t < L::STAGES - 1; ++t) issue(t);
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<L::STAGES - 2>();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    issue(t + L::STAGES - 1);  // into the stage tile t - 1 used
    if (!computes) continue;
    const unsigned char* st = dsm + (t % L::STAGES) * L::STAGE;
    const int k0 = t_begin + t * kDecTK;
    for (int s = kg; s < kDecTK / 16 && k0 + 16 * s < t_end; s += KW) {
      const __nv_bfloat16 *kt, *vt;  // the slice's 16 K and V rows
      const float *ksc = nullptr, *vsc = nullptr;
      if constexpr (Q8) {
        __nv_bfloat16* ck = reinterpret_cast<__nv_bfloat16*>(
            dsm + L::BODY + warp * 2 * L::SLICE);
        __nv_bfloat16* cv = ck + 16 * KS;
        const int8_t* sk = reinterpret_cast<const int8_t*>(st) + 16 * s * D;
        const int8_t* sv = sk + L::TILE;
        __syncwarp();  // the previous slice's ldmatrix reads are done
#pragma unroll
        for (int u = lane; u < D; u += 32) {  // D chunks of 16 codes each
          const int r = u / (D / 16), c16 = (u % (D / 16)) * 16;
          convert16(sk + r * D + c16, ck + r * KS + c16);
          convert16(sv + r * D + c16, cv + r * KS + c16);
        }
        __syncwarp();
        kt = ck;
        vt = cv;
        ksc = reinterpret_cast<const float*>(st + 2 * L::TILE) + 16 * s;
        vsc = ksc + kDecTK;
      } else {
        kt = reinterpret_cast<const __nv_bfloat16*>(st) + 16 * s * KS;
        vt = reinterpret_cast<const __nv_bfloat16*>(st + L::TILE) +
             16 * s * KS;
      }

      // scores of the slice: [16 heads x 16 keys], keys 0-7 in sc[0];
      // even and odd k-steps sum into separate registers (two chains of
      // dependent MMAs instead of one)
      float sc[2][4], sc2[2][4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[0][e] = sc[1][e] = sc2[0][e] = sc2[1][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        uint32_t kb[4];
        ldsm_x4(kb, kt + ((lane & 7) + ((lane >> 4) << 3)) * KS + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        float(&acc)[2][4] = (kk & 1) ? sc2 : sc;
        if constexpr (L::QSM) {
          uint32_t qa[4];
          ldsm_x4(qa, q_s + (mt * 16 + (lane & 15)) * KS + kk * 16 +
                          (lane >> 4) * 8);
          mma_bf16(acc[0], qa, kb[0], kb[1]);
          mma_bf16(acc[1], qa, kb[2], kb[3]);
        } else {
          mma_bf16(acc[0], qf[kk], kb[0], kb[1]);
          mma_bf16(acc[1], qf[kk], kb[2], kb[3]);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[0][e] += sc2[0][e];
        sc[1][e] += sc2[1][e];
      }
      // scale, k scale, softcap (before the mask), mask; row maxima
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j * 8 + (lane & 3) * 2 + (e & 1);
          float x = sc[j][e] * a.scale;
          if constexpr (Q8) x *= ksc[key];
          if (a.softcap > 0.f) x = tanhf(x * inv_cap) * a.softcap;
          x = k0 + 16 * s + key < t_end ? x * kLog2e : kNegInf;
          sc[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      // online softmax in f32; the four lanes of a row share its stats
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_r[i], mx[i]);
        alpha[i] = exp2f(m_r[i] - m_new);
        m_r[i] = m_new;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = sc[j][e] > 0.5f * kNegInf
                              ? exp2f(sc[j][e] - m_r[e >> 1])
                              : 0.f;
          sum[e >> 1] += p;
          if constexpr (Q8)  // v scales fold into P; the sum keeps raw p
            sc[j][e] = p * vsc[j * 8 + (lane & 3) * 2 + (e & 1)];
          else
            sc[j][e] = p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * alpha[i] + sum[i];
      // O = O * alpha + P @ V, P re-packed from the score registers
      const uint32_t pa[4] = {
          pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
          pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
      for (int i = 0; i < D / 16; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o[2 * i][e] *= alpha[e >> 1];
          o[2 * i + 1][e] *= alpha[e >> 1];
        }
        uint32_t vb[4];
        ldsm_x4_trans(vb, vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * KS +
                              16 * i + (lane >> 4) * 8);
        mma_bf16(o[2 * i], pa, vb[0], vb[1]);
        mma_bf16(o[2 * i + 1], pa, vb[2], vb[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the warps' results now

  float* red = reinterpret_cast<float*>(dsm);  // [warp][o 16 x D, m 16, l 16]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
  }
  if (computes) {
    float* rw = red + warp * RW;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        *reinterpret_cast<float2*>(rw + ((lane >> 2) + 8 * i) * D + dn * 8 +
                                   (lane & 3) * 2) =
            make_float2(o[dn][2 * i], o[dn][2 * i + 1]);
    if ((lane & 3) == 0)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        rw[16 * D + (lane >> 2) + 8 * i] = m_r[i];
        rw[16 * D + 16 + (lane >> 2) + 8 * i] = l_r[i];
      }
  }
  __syncthreads();

  // merge the key groups of each head (in group order), then write the
  // output (one split with keys) or this split's partial; a thread takes
  // two adjacent dims
  for (int i = tid; i < G * D / 2; i += kDecThreads) {
    const int g = 2 * i / D, d = 2 * i - g * D;
    const float* rw = red + (g / 16) * RW;  // key group 0 of the head's tile
    const int r = g % 16;
    float m = kNegInf;
    for (int k = 0; k < KW; ++k) m = fmaxf(m, rw[k * MT * RW + 16 * D + r]);
    float l = 0.f;
    float2 acc = make_float2(0.f, 0.f);
    for (int k = 0; k < KW; ++k) {
      const float* rk = rw + k * MT * RW;
      const float w = exp2f(rk[16 * D + r] - m);
      const float2 o2 = *reinterpret_cast<const float2*>(rk + r * D + d);
      l += rk[16 * D + 16 + r] * w;
      acc.x += o2.x * w;
      acc.y += o2.y * w;
    }
    if (nact == 1) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
      *reinterpret_cast<__nv_bfloat162*>(a.out + (head0 + g) * D + d) =
          __floats2bfloat162_rn(acc.x * inv, acc.y * inv);
    } else {
      const size_t part = (head0 + g) * a.NS + z;
      *reinterpret_cast<float2*>(a.part_o + part * D + d) = acc;
      if (d == 0)
        *reinterpret_cast<float2*>(a.part_ml + part * 2) = make_float2(m, l);
    }
  }
  if (nact == 1) return;

  // the last of the row's nact splits to finish adds the partials in split
  // order (the result does not depend on which block came last) and puts
  // the ticket back to zero for the next launch; every partial it reads is
  // requested at once
  int* ticket = a.ticket + (size_t)b * a.KV + kvh;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1) == nact - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < G * D / 2; i += kDecThreads) {
    const int g = 2 * i / D, d = 2 * i - g * D;
    const size_t part = (head0 + g) * a.NS + z0;
    float m = kNegInf, l = 0.f, x = 0.f, y = 0.f;
    for (int s0 = 0; s0 < nact; s0 += kDecMergeBatch) {
      float2 ml[kDecMergeBatch], ov[kDecMergeBatch];
#pragma unroll
      for (int s = 0; s < kDecMergeBatch; ++s)
        if (s0 + s < nact) {
          ml[s] = __ldcg(reinterpret_cast<const float2*>(a.part_ml) + part +
                         s0 + s);
          ov[s] = __ldcg(reinterpret_cast<const float2*>(
              a.part_o + (part + s0 + s) * D + d));
        }
      float mb = m;
#pragma unroll
      for (int s = 0; s < kDecMergeBatch; ++s)
        if (s0 + s < nact) mb = fmaxf(mb, ml[s].x);
      const float c = exp2f(m - mb);
      l *= c;
      x *= c;
      y *= c;
#pragma unroll
      for (int s = 0; s < kDecMergeBatch; ++s)
        if (s0 + s < nact) {
          const float w = exp2f(ml[s].x - mb);
          l += ml[s].y * w;
          x += ov[s].x * w;
          y += ov[s].y * w;
        }
      m = mb;
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    *reinterpret_cast<__nv_bfloat162*>(a.out + (head0 + g) * D + d) =
        __floats2bfloat162_rn(x * inv, y * inv);
  }
  if (tid == 0) *ticket = 0;
}

template <int D, bool Q8>
int launch_decode_attend(const DecArgs& a, int B, cudaStream_t st) {
  using L = DecSmem<D, Q8>;
  cudaError_t e = cudaFuncSetAttribute(
      decode_attend<D, Q8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::BYTES);
  if (e != cudaSuccess) return (int)e;
  decode_attend<D, Q8><<<dim3(B, a.KV, a.NS), kDecThreads, L::BYTES, st>>>(a);
  return (int)cudaGetLastError();
}

// The tensor-core decode over dense (k_scale null) or int8 pools. The
// split plan must cover the table: NS splits of `chunk` tokens (whole
// stages, few enough pages for pg_s), none empty; NS > 1 needs the partial
// buffers and the ticket.
int dispatch_decode(DecArgs a, int B, int D, int page_size, int P,
                    cudaStream_t st) {
  const long long cap = (long long)P * page_size;
  if (a.NS < 1 || a.chunk < kDecTK || a.chunk % kDecTK ||
      (a.chunk + page_size - 1) / page_size + 1 > kDecMaxPages ||
      (long long)a.NS * a.chunk < cap ||
      (cap > 0 && (long long)(a.NS - 1) * a.chunk >= cap) ||
      (a.NS > 1 && (a.part_o == nullptr || a.part_ml == nullptr ||
                    a.ticket == nullptr)))
    return (int)cudaErrorInvalidValue;
  a.ps_shift = (page_size & (page_size - 1)) == 0 ? __builtin_ctz(page_size)
                                                  : -1;
  const bool q8 = a.k_scale != nullptr;
  if (D == 64)
    return q8 ? launch_decode_attend<64, true>(a, B, st)
              : launch_decode_attend<64, false>(a, B, st);
  if (D == 128)
    return q8 ? launch_decode_attend<128, true>(a, B, st)
              : launch_decode_attend<128, false>(a, B, st);
  return q8 ? launch_decode_attend<256, true>(a, B, st)
            : launch_decode_attend<256, false>(a, B, st);
}

DecArgs make_dec_args(const void* q, const void* pk, const void* pv,
                      const void* k_scale, const void* v_scale,
                      const void* tables, const void* valid, void* out,
                      void* part_o, void* part_ml, void* ticket, int H,
                      int KV, int D, int page_size, int P, int num_pages,
                      int window, float softcap, int splits, int chunk) {
  DecArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.pool_k = pk;
  a.pool_v = pv;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.tables = static_cast<const int*>(tables);
  a.valid = static_cast<const int*>(valid);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.part_o = static_cast<float*>(part_o);
  a.part_ml = static_cast<float*>(part_ml);
  a.ticket = static_cast<int*>(ticket);
  a.H = H;
  a.KV = KV;
  a.G = H / KV;
  a.page_size = page_size;
  a.ps_shift = -1;
  a.P = P;
  a.num_pages = num_pages;
  a.window = window;
  a.softcap = softcap;
  a.scale = 1.0f / sqrtf((float)D);
  a.NS = splits;
  a.chunk = chunk;
  return a;
}

// ---------------------------------------------------------------------------
// bf16 prefill and ragged body (see the header): a cp.async ring of K/V
// stages, wgmma for both products, the KV split merged in the same launch
// ---------------------------------------------------------------------------

constexpr int kAttThreads = 256;   // two consumer warpgroups
constexpr int kAttRows = 128;      // (query, head) rows per block, 64 per wg
constexpr int kAttTK = 64;         // keys per split unit (and ring stage)
constexpr int kAttMaxPages = 256;  // page ids a block keeps in shared memory
constexpr int kAttMergeBatch = 8;  // partials the merge requests at once

// 2^x in one MUFU instruction (no denormal handling: the scores are
// shifted by the row max, so 2^x lies in [0, 1] and flushes below 2^-126)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Dynamic shared memory of attend_wg<D>, from a 1024-byte aligned base (the
// 128-byte swizzle's period): the query tile, the ring of K and V stages,
// the block's page ids. Every tile is 128-byte swizzled rows of 64 bf16
// (one "atom" column of 64 elements; D 128 keeps two atoms side by side,
// D 256 four): element (row, d) sits at (d / 64) * rows * 128 + row * 128 +
// (((d % 64) / 8) ^ (row % 8)) * 16 + (d % 8) * 2. A stage holds TK keys:
// 64, or 32 at D 256, where the 64 KB query tile and four 64-key stages
// (256 KB) would not fit the 227 KB a block may use; four 32-key stages
// do (194 KB, one block per SM).
template <int D>
struct AttSmem {
  static constexpr int TK = D > 128 ? 32 : kAttTK;  // keys per ring stage
  static constexpr int Q = kAttRows * D * 2;
  static constexpr int TILE = TK * D * 2;  // K (or V) bytes per stage
  static constexpr int STAGE = 2 * TILE;
  static constexpr int STAGES = 4;  // ring depth
  static constexpr int PAGES = Q + STAGES * STAGE;
  static constexpr int BYTES = 1024 + PAGES + kAttMaxPages * 4;
};

// Byte offset of 16-byte chunk c (8 elements along D) of row `row` in a
// swizzled tile of ROWS rows.
template <int ROWS>
__device__ __forceinline__ int sw_off(int row, int c) {
  return (c >> 3) * (ROWS * 128) + row * 128 + (((c & 7) ^ (row & 7)) << 4);
}

// The split plan and its buffers (NS > 1): partial outputs [tiles, KV, NS,
// kAttRows, D] and (max, sum) pairs [tiles, KV, NS, kAttRows, 2] in f32, a
// ticket per (tile, KV head), zero between launches.
struct AttPlan {
  float* part_o;
  float* part_ml;
  int* ticket;
  int NS, chunk;  // KV splits, tokens per split (whole stages)
  int ps_shift;   // log2(page_size), or -1
};

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator uses across a wgmma wait
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_operands_u32(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define WG_D8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// S[64 x 64] (+)= A[64 x 16] . B[16 x 64], both from shared memory, K-major
// (B is the K tile as it lies: key rows of D contiguous elements);
// accumulate = 0 overwrites s.
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// The same over a 32-key stage (D 256): S[64 x 32].
__device__ __forceinline__ void wgmma_qk(float (&d)[16], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_D8(0), WG_D8(8)
      : "l"(da), "l"(db), "r"(accumulate));
}

// O[64 x D] += P[64 x 16] . V[16 x D]: P from registers (the S accumulator
// packed to bf16), V from shared memory N-major (key rows of D contiguous
// elements: the transposed B operand).
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// 128 columns of O into accumulators OFF .. OFF + 63 of d (D 128 is one
// call, D 256 two: columns 128 .. 255 are accumulators 64 .. 127).
template <int OFF, int N>
__device__ __forceinline__ void wgmma_pv_n128(float (&d)[N],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  static_assert(OFF + 64 <= N, "accumulators past the array");
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : WG_D8(OFF), WG_D8(OFF + 8), WG_D8(OFF + 16), WG_D8(OFF + 24),
        WG_D8(OFF + 32), WG_D8(OFF + 40), WG_D8(OFF + 48), WG_D8(OFF + 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  wgmma_pv_n128<0>(d, a, db);
}
#undef WG_D8

// One block serves tile `tl` (TQ queries x G heads of KV head kvh, rows r =
// t * G + g, at most kAttRows) over split z of its KV range. Warpgroup wg
// owns rows 64 wg .. 64 wg + 63; in it warp w holds rows 16 w + lane / 4
// (+ 8), as wgmma's accumulators lay them out: accumulator j of a thread is
// row lane / 4 + 8 ((j / 2) % 2), column 8 (j / 4) + 2 (lane % 4) + j % 2.
// `tile_id` indexes the partial buffers and tickets.
template <int D>
__device__ void attend_wg(const Args& a, const AttPlan& sp, const Tile& tl,
                          int kvh, int z, int tile_id, int TQ) {
  using L = AttSmem<D>;
  constexpr int TK = L::TK;
  constexpr int CPR = D / 8;                         // 16-byte chunks a row
  constexpr int CPT = TK * CPR / kAttThreads;    // per thread, K or V
  constexpr int QPT = kAttRows * CPR / kAttThreads;  // per thread, Q
  extern __shared__ __align__(16) unsigned char att_raw[];
  unsigned char* sm = att_raw + ((1024 - (smem_u32(att_raw) & 1023)) & 1023);
  unsigned char* ring = sm + L::Q;
  int* pg_s = reinterpret_cast<int*>(sm + L::PAGES);
  __shared__ int last;

  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  const int G = a.H / a.KV, rows = TQ * G;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
  const size_t head0 = (size_t)kvh * G;
  // the element offset of row r's q / out vector (r live: r < rows and its
  // query inside the tile)
  auto row_live = [&](int r) { return r < rows && r / G < tl.n; };
  auto row_off = [&](int r) {
    const int t = r / G;
    return ((tl.tok0 + t) * a.H + head0 + (r - t * G)) * D;
  };

  // the tile's keys [lo, hi): nothing past the table's capacity
  const int cap = a.P * a.page_size;
  const int lo = tl.lo, hi = min(tl.hi, cap);
  if (hi <= lo) {  // no query of the tile sees a key: zeros, by split 0
    if (z == 0)
      for (int i = tid; i < rows * CPR; i += kAttThreads) {
        const int r = i / CPR;
        if (row_live(r))
          *reinterpret_cast<uint4*>(out + row_off(r) + (i - r * CPR) * 8) =
              make_uint4(0u, 0u, 0u, 0u);
      }
    return;
  }
  const int z0 = lo / sp.chunk, z1 = (hi - 1) / sp.chunk;
  if (z < z0 || z > z1) return;  // a split with no keys
  const int nact = z1 - z0 + 1;  // splits of this tile with keys
  const int t_begin = max(lo, z * sp.chunk);
  const int t_end = min(hi, (z + 1) * sp.chunk);
  const int ntiles = (t_end - t_begin + TK - 1) / TK;

  auto page_of = [&](int pos) {
    return sp.ps_shift >= 0 ? pos >> sp.ps_shift : pos / a.page_size;
  };
  const int p_first = page_of(t_begin);
  const int np = page_of(t_end - 1) - p_first + 1;
  for (int i = tid; i < np; i += kAttThreads)
    pg_s[i] = min(max(a.tables[(size_t)tl.b * a.P + p_first + i], 0),
                  a.num_pages - 1);
  // the query tile (rows past the tile zero-filled), in stage 0's group
#pragma unroll
  for (int u = 0; u < QPT; ++u) {
    const int i = tid + u * kAttThreads, r = i / CPR, c = i % CPR;
    const bool in = row_live(r);
    cp_async16(sm + sw_off<kAttRows>(r, c), in ? q + row_off(r) + c * 8 : q,
               in ? 16 : 0);
  }
  __syncthreads();  // pg_s

  // stage copies: thread tid moves chunk c of key rows j, j + 256 / CPR, ...
  // of K and V (the same pool offsets for both)
  const char* pk = static_cast<const char*>(a.pool_k);
  const char* pv = static_cast<const char*>(a.pool_v);
  const size_t slot_bytes = (size_t)a.KV * D * 2;
  const int cc = tid % CPR, j0 = tid / CPR;
  const size_t col_bytes = (size_t)kvh * D * 2 + cc * 16;
  auto issue = [&](int t) {  // tile t -> stage t % L::STAGES, one group
    if (t < ntiles) {
      unsigned char* st = ring + (t % L::STAGES) * L::STAGE;
      const int k0 = t_begin + t * TK;
#pragma unroll
      for (int u = 0; u < CPT; ++u) {
        const int j = j0 + u * (kAttThreads / CPR), pos = k0 + j;
        const bool in = pos < t_end;
        size_t off = 0;
        if (in) {
          const int p = page_of(pos);
          off = ((size_t)pg_s[p - p_first] * a.page_size +
                 (pos - p * a.page_size)) * slot_bytes + col_bytes;
        }
        cp_async16(st + sw_off<TK>(j, cc), pk + off, in ? 16 : 0);
        cp_async16(st + L::TILE + sw_off<TK>(j, cc), pv + off,
                   in ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  // the two rows this thread holds, and their query positions
  int r_of[2], qp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    r_of[i] = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2) + 8 * i;
    qp[i] = row_live(r_of[i]) ? tile_pos(tl, r_of[i] / G) : 0;
  }
  const int eff_w = a.window > 0 ? a.window : (1 << 30);
  const float sl2 = a.scale * kLog2e;
  const float inv_cap = a.softcap > 0.f ? 1.f / a.softcap : 0.f;
  const float cap_l2 = a.softcap * kLog2e;

  float o[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
  // running max (log2 units, shared by the 4 lanes of a row) and this
  // lane's share of the row's sum (added over the 4 lanes at the end)
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  const uint32_t q_addr = smem_u32(sm) + wg * 64 * 128;
  // P of the previous tile, read by its P V wgmma until the next wait
  uint32_t pa[TK / 16][4] = {};

  // One barrier a tile. Copies run L::STAGES - 2 tiles ahead: the copy
  // issued in tile t's step refills the stage of tile t - 2, whose P V
  // wgmma every warpgroup waited for in tile t - 1's step, before this
  // step's barrier. Tile t's P V is waited for in tile t + 1's step, under
  // that step's barrier, copies and Q K^T.
#pragma unroll
  for (int t = 0; t < L::STAGES - 2; ++t) issue(t);
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<L::STAGES - 3>();
    // this thread's cp.async writes -> visible to wgmma (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // tile t landed in every thread's copies
    const uint32_t k_addr = smem_u32(ring + (t % L::STAGES) * L::STAGE);
    const uint32_t v_addr = k_addr + L::TILE;
    const int k0 = t_begin + t * TK;

    // S = Q K^T: the K tile is the K-major B operand as it lies; a k16
    // step moves 32 bytes along the swizzled rows, D 128 changes atom
    float s[TK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_qk(s,
               wgmma_desc(q_addr + (kk >> 2) * (kAttRows * 128) + (kk & 3) * 32,
                          16, 1024),
               wgmma_desc(k_addr + (kk >> 2) * (TK * 128) + (kk & 3) * 32,
                          16, 1024),
               kk > 0);
    wgmma_commit();
    issue(t + L::STAGES - 2);  // while the tensor cores work
    wgmma_wait0();  // this tile's S and the previous tile's O
    fence_operands(s);
    fence_operands(o);
#pragma unroll
    for (int kb = 0; kb < TK / 16; ++kb) fence_operands_u32(pa[kb]);

    // scale (log2 units) and softcap (before the mask); the mask only on
    // tiles that cross the diagonal, the window edge or the range's end
    // scores in log2 units are s * scl: the scale folds into the
    // exponent's multiply-add, unless the softcap has applied it
    float scl = sl2;
    if (a.softcap > 0.f) {
#pragma unroll
      for (int j = 0; j < TK / 2; ++j)
        s[j] = tanhf(s[j] * a.scale * inv_cap) * cap_l2;
      scl = 1.f;
    }
    const bool full = k0 + TK <= t_end && k0 + TK - 1 <= tl.qmin &&
                      k0 > tl.qmax - eff_w;
    if (!full) {
#pragma unroll
      for (int j = 0; j < TK / 2; ++j) {
        const int i = (j >> 1) & 1;
        const int key = k0 + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
        if (!(key < t_end && key <= qp[i] && key > qp[i] - eff_w))
          s[j] = kNegInf;
      }
    }
    // online softmax in f32; the four lanes of a row share its stats
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < TK / 2; ++j)
      mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], s[j]);
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // a row with no key yet keeps a max of about kNegInf * scl: far
      // below any score, so its alpha and the merge's weights are 0
      const float m_new = fmaxf(m_r[i], mx[i] * scl);
      alpha[i] = ex2(m_r[i] - m_new);
      m_r[i] = m_new;
    }
    if (full) {
#pragma unroll
      for (int j = 0; j < TK / 2; ++j)
        s[j] = ex2(fmaf(s[j], scl, -m_r[(j >> 1) & 1]));
    } else {  // masked keys give exact zeros, whatever the row's max
#pragma unroll
      for (int j = 0; j < TK / 2; ++j)
        s[j] = s[j] > 0.5f * kNegInf
                   ? ex2(fmaf(s[j], scl, -m_r[(j >> 1) & 1]))
                   : 0.f;
    }
#pragma unroll
    for (int j = 0; j < TK / 2; ++j) sum[(j >> 1) & 1] += s[j];
#pragma unroll
    for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * alpha[i] + sum[i];
    // rescale O only where a row's max moved (a multiply by 1 is exact)
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < D / 2; ++j) o[j] *= alpha[(j >> 1) & 1];
    }

    // O += P V: P's k16 block kb is accumulators 8 kb .. 8 kb + 7, which
    // are wgmma's A fragment as they lie; V's k16 step is 16 key rows
#pragma unroll
    for (int kb = 0; kb < TK / 16; ++kb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kb][e] = pack_bf16(s[8 * kb + 2 * e], s[8 * kb + 2 * e + 1]);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < TK / 16; ++kb) {
      if constexpr (D == 256) {  // V's atoms 0-1, then 2-3
        wgmma_pv_n128<0>(o, pa[kb],
                         wgmma_desc(v_addr + kb * 2048, TK * 128, 1024));
        wgmma_pv_n128<64>(
            o, pa[kb],
            wgmma_desc(v_addr + 2 * TK * 128 + kb * 2048, TK * 128, 1024));
      } else {
        wgmma_pv(o, pa[kb], wgmma_desc(v_addr + kb * 2048, TK * 128, 1024));
      }
    }
    wgmma_commit();
  }
  wgmma_wait0();
  fence_operands(o);
#pragma unroll
  for (int kb = 0; kb < TK / 16; ++kb) fence_operands_u32(pa[kb]);
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
  }
  const size_t part0 = ((size_t)tile_id * a.KV + kvh) * sp.NS;  // split 0
  if (nact == 1) {  // the tile's keys fit one split: the output itself
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!row_live(r_of[i])) continue;
      const float inv = 1.f / fmaxf(l_r[i], 1e-30f);
      __nv_bfloat16* orow = out + row_off(r_of[i]) + 2 * (lane & 3);
#pragma unroll
      for (int j = 2 * i; j < D / 2; j += 4)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * (j >> 2)) =
            __floats2bfloat162_rn(o[j] * inv, o[j + 1] * inv);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_live(r_of[i])) continue;
    const size_t part = (part0 + z) * kAttRows + r_of[i];
    float* po = sp.part_o + part * D + 2 * (lane & 3);
#pragma unroll
    for (int j = 2 * i; j < D / 2; j += 4)
      *reinterpret_cast<float2*>(po + 8 * (j >> 2)) = make_float2(o[j], o[j + 1]);
    if ((lane & 3) == 0)
      *reinterpret_cast<float2*>(sp.part_ml + part * 2) =
          make_float2(m_r[i], l_r[i]);
  }

  // the last of the tile's nact splits to finish adds the partials in split
  // order (the result does not depend on which block came last) and puts
  // the ticket back to zero for the next launch
  int* ticket = sp.ticket + (size_t)tile_id * a.KV + kvh;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1) == nact - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < rows * (D / 2); i += kAttThreads) {
    const int r = i / (D / 2), d = 2 * (i - r * (D / 2));
    if (!row_live(r)) continue;
    const size_t part = (part0 + z0) * kAttRows + r;  // split s: + s * rows
    float m = kNegInf, l = 0.f, x = 0.f, y = 0.f;
    for (int s0 = 0; s0 < nact; s0 += kAttMergeBatch) {
      float2 ml[kAttMergeBatch], ov[kAttMergeBatch];
#pragma unroll
      for (int s = 0; s < kAttMergeBatch; ++s)
        if (s0 + s < nact) {
          const size_t ps = part + (size_t)(s0 + s) * kAttRows;
          ml[s] = __ldcg(reinterpret_cast<const float2*>(sp.part_ml) + ps);
          ov[s] = __ldcg(reinterpret_cast<const float2*>(sp.part_o + ps * D + d));
        }
      float mb = m;
#pragma unroll
      for (int s = 0; s < kAttMergeBatch; ++s)
        if (s0 + s < nact) mb = fmaxf(mb, ml[s].x);
      const float c = exp2f(m - mb);
      l *= c;
      x *= c;
      y *= c;
#pragma unroll
      for (int s = 0; s < kAttMergeBatch; ++s)
        if (s0 + s < nact) {
          const float w = exp2f(ml[s].x - mb);
          l += ml[s].y * w;
          x += ov[s].x * w;
          y += ov[s].y * w;
        }
      m = mb;
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    *reinterpret_cast<__nv_bfloat162*>(out + row_off(r) + d) =
        __floats2bfloat162_rn(x * inv, y * inv);
  }
  if (tid == 0) *ticket = 0;
}

// Prefill: grid (KV x NS, B, query tiles), the query tiles reversed so the
// tiles with the most keys (a row's last) launch first.
template <int D>
__global__ void __launch_bounds__(kAttThreads, D == 64 ? 2 : 1)
    attend_prefill_kernel(Args a, AttPlan sp) {
  const int TQ = kAttRows / (a.H / a.KV);
  const int kvh = blockIdx.x / sp.NS, z = blockIdx.x - kvh * sp.NS;
  const int b = blockIdx.y, qt = gridDim.z - 1 - blockIdx.z;
  attend_wg<D>(a, sp, dense_tile(a, b, qt * TQ, TQ, false), kvh, z,
               b * gridDim.z + qt, TQ);
}

// Ragged: grid (KV x NS, segments); split 0 of window x's block also
// writes the zeros of that window's padding tokens.
template <int D>
__global__ void __launch_bounds__(kAttThreads, D == 64 ? 2 : 1)
    attend_ragged_kernel(Args a, AttPlan sp) {
  const int TQ = kAttRows / (a.H / a.KV);
  const int kvh = blockIdx.x / sp.NS, z = blockIdx.x - kvh * sp.NS;
  if (z == 0 && (int)blockIdx.y * TQ < a.T)
    zero_padding<__nv_bfloat16>(a, blockIdx.y, TQ, kvh);
  const Tile tl = ragged_tile(a, blockIdx.y, TQ);
  if (tl.n == 0) return;
  attend_wg<D>(a, sp, tl, kvh, z, blockIdx.y, TQ);
}

template <int D>
cudaError_t attend_smem_attr(bool ragged) {
  return cudaFuncSetAttribute(
      ragged ? attend_ragged_kernel<D> : attend_prefill_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, AttSmem<D>::BYTES);
}

template <int D>
cudaError_t launch_attend(const Args& a, const AttPlan& sp, dim3 grid,
                          bool ragged, cudaStream_t st) {
  cudaError_t e = attend_smem_attr<D>(ragged);
  if (e != cudaSuccess) return e;
  if (ragged)
    attend_ragged_kernel<D>
        <<<grid, kAttThreads, AttSmem<D>::BYTES, st>>>(a, sp);
  else
    attend_prefill_kernel<D>
        <<<grid, kAttThreads, AttSmem<D>::BYTES, st>>>(a, sp);
  return cudaSuccess;
}

template <int D>
int attend_occupancy(bool ragged, int* blocks) {
  cudaError_t e = attend_smem_attr<D>(ragged);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, ragged ? attend_ragged_kernel<D> : attend_prefill_kernel<D>,
      kAttThreads, AttSmem<D>::BYTES);
}

// The wgmma body over `tiles` query tiles (B x query tiles, or segments)
// of a.KV heads. The split plan must cover the table: NS splits of `chunk`
// tokens (whole stages, few enough pages for pg_s), none empty; NS > 1
// needs the partial buffers and the ticket.
int dispatch_attend(const Args& a, AttPlan sp, int B, bool ragged,
                    cudaStream_t st) {
  const long long cap = (long long)a.P * a.page_size;
  if (sp.NS < 1 || sp.chunk < kAttTK || sp.chunk % kAttTK ||
      (sp.chunk + a.page_size - 1) / a.page_size + 1 > kAttMaxPages ||
      (long long)sp.NS * sp.chunk < cap ||
      (cap > 0 && (long long)(sp.NS - 1) * sp.chunk >= cap) ||
      (sp.NS > 1 && (sp.part_o == nullptr || sp.part_ml == nullptr ||
                     sp.ticket == nullptr)))
    return (int)cudaErrorInvalidValue;
  sp.ps_shift = (a.page_size & (a.page_size - 1)) == 0
                    ? __builtin_ctz(a.page_size)
                    : -1;
  const int TQ = kAttRows / (a.H / a.KV);
  const dim3 grid = ragged ? dim3(a.KV * sp.NS, ragged_blocks(a, TQ))
                           : dim3(a.KV * sp.NS, B, (a.T + TQ - 1) / TQ);
  cudaError_t e = a.D == 64    ? launch_attend<64>(a, sp, grid, ragged, st)
                  : a.D == 128 ? launch_attend<128>(a, sp, grid, ragged, st)
                               : launch_attend<256>(a, sp, grid, ragged, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

AttPlan make_att_plan(void* part_o, void* part_ml, void* ticket, int splits,
                        int chunk) {
  return AttPlan{static_cast<float*>(part_o), static_cast<float*>(part_ml),
                  static_cast<int*>(ticket), splits, chunk, -1};
}

Args make_args(const void* q, const void* pk, const void* pv,
               const void* tables, const void* q_start, const void* valid,
               void* out, int T, int B, int H, int KV, int D, int page_size,
               int P, int num_pages, int window, float softcap) {
  Args a;
  a.q = q;
  a.pool_k = pk;
  a.pool_v = pv;
  a.tables = static_cast<const int*>(tables);
  a.q_start = static_cast<const int*>(q_start);
  a.valid = static_cast<const int*>(valid);
  a.tok_row = nullptr;
  a.q_pos = nullptr;
  a.out = out;
  a.T = T;
  a.B = B;
  a.H = H;
  a.KV = KV;
  a.D = D;
  a.page_size = page_size;
  a.P = P;
  a.num_pages = num_pages;
  a.window = window;
  a.softcap = softcap;
  a.scale = 1.0f / sqrtf((float)D);
  a.TQ = 1;
  a.TK = 32;
  return a;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
// The bf16 tensor-core geometries (paged_attention_uses_mma) run the decode
// body with the split plan (splits, split_chunk: see dispatch_decode); with
// splits > 1 it needs part_o [B, H, splits, D] and part_ml [B, H, splits, 2]
// (f32) and ticket, B * KV int32 that are zero before the launch (the
// kernel leaves them zero). Other geometries run the scalar body unsplit
// and ignore the plan and the buffers.
extern "C" int paged_decode(int dtype, const void* q, const void* pool_k,
                            const void* pool_v, const void* tables,
                            const void* valid, void* out, int B, int H,
                            int KV, int D, int page_size, int P,
                            int num_pages, int window, float softcap,
                            void* part_o, void* part_ml, void* ticket,
                            int splits, int split_chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mma_ok(dtype, D, H / KV))
    return dispatch_decode(
        make_dec_args(q, pool_k, pool_v, nullptr, nullptr, tables, valid, out,
                      part_o, part_ml, ticket, H, KV, D, page_size, P,
                      num_pages, window, softcap, splits, split_chunk),
        B, D, page_size, P, st);
  Args a = make_args(q, pool_k, pool_v, tables, nullptr, valid, out, 1, B, H,
                     KV, D, page_size, P, num_pages, window, softcap);
  if (dtype == 0) return launch_decode<float>(a, B, st);
  if (dtype == 1) return launch_decode<__nv_bfloat16>(a, B, st);
  return (int)cudaErrorInvalidValue;
}

// int8 pools: codes_k, codes_v [num_slots, KV, D] int8, scale_k, scale_v
// [num_slots, KV] f32; the rest as paged_decode.
extern "C" int paged_decode_int8(int dtype, const void* q, const void* codes_k,
                                 const void* codes_v, const void* scale_k,
                                 const void* scale_v, const void* tables,
                                 const void* valid, void* out, int B, int H,
                                 int KV, int D, int page_size, int P,
                                 int num_pages, int window, float softcap,
                                 void* part_o, void* part_ml, void* ticket,
                                 int splits, int split_chunk, void* stream) {
  if (D % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mma_ok(dtype, D, H / KV))
    return dispatch_decode(
        make_dec_args(q, codes_k, codes_v, scale_k, scale_v, tables, valid,
                      out, part_o, part_ml, ticket, H, KV, D, page_size, P,
                      num_pages, window, softcap, splits, split_chunk),
        B, D, page_size, P, st);
  Args a = make_args(q, codes_k, codes_v, tables, nullptr, valid, out, 1, B,
                     H, KV, D, page_size, P, num_pages, window, softcap);
  const Scales sc{static_cast<const float*>(scale_k),
                  static_cast<const float*>(scale_v)};
  if (dtype == 0) return launch_decode<float, int8_t>(a, B, st, sc);
  if (dtype == 1) return launch_decode<__nv_bfloat16, int8_t>(a, B, st, sc);
  return (int)cudaErrorInvalidValue;
}

// The bf16 tensor-core geometries (paged_attention_uses_mma) of prefill and
// ragged run the wgmma body with the split plan (splits, split_chunk: see
// dispatch_attend); with splits > 1 it needs part_o [tiles, KV, splits,
// 128, D] and part_ml [tiles, KV, splits, 128, 2] (f32) and ticket, tiles *
// KV int32 that are zero before the launch (the kernel leaves them zero),
// where tiles = B * ceil(T / TQ) (prefill) or ceil(S / TQ) + B (ragged)
// and TQ = 128 / (H / KV). Other geometries run the scalar body unsplit and
// ignore the plan and the buffers.
extern "C" int paged_prefill(int dtype, const void* q, const void* pool_k,
                             const void* pool_v, const void* tables,
                             const void* q_start, const void* valid,
                             void* out, int B, int T, int H, int KV, int D,
                             int page_size, int P, int num_pages, int window,
                             float softcap, void* part_o, void* part_ml,
                             void* ticket, int splits, int split_chunk,
                             void* stream) {
  Args a = make_args(q, pool_k, pool_v, tables, q_start, valid, out, T, B, H,
                     KV, D, page_size, P, num_pages, window, softcap);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mma_ok(dtype, D, H / KV))
    return dispatch_attend(
        a, make_att_plan(part_o, part_ml, ticket, splits, split_chunk), B,
        false, st);
  if (dtype == 0) return launch_prefill<float>(a, B, st);
  if (dtype == 1) return launch_prefill<__nv_bfloat16>(a, B, st);
  return (int)cudaErrorInvalidValue;
}

// q, out [S, H, D]; tok_row, q_pos [S]; tables [B, P]; valid [B] (B >= 1);
// the split plan and buffers as paged_prefill.
extern "C" int paged_ragged(int dtype, const void* q, const void* pool_k,
                            const void* pool_v, const void* tables,
                            const void* tok_row, const void* q_pos,
                            const void* valid, void* out, int S, int B,
                            int H, int KV, int D, int page_size, int P,
                            int num_pages, int window, float softcap,
                            void* part_o, void* part_ml, void* ticket,
                            int splits, int split_chunk, void* stream) {
  if (S <= 0) return (int)cudaSuccess;
  if (B < 1) return (int)cudaErrorInvalidValue;
  Args a = make_args(q, pool_k, pool_v, tables, nullptr, valid, out, S, B, H,
                     KV, D, page_size, P, num_pages, window, softcap);
  a.tok_row = static_cast<const int*>(tok_row);
  a.q_pos = static_cast<const int*>(q_pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mma_ok(dtype, D, H / KV))
    return dispatch_attend(
        a, make_att_plan(part_o, part_ml, ticket, splits, split_chunk), B,
        true, st);
  if (dtype == 0) return launch_ragged<float>(a, st);
  if (dtype == 1) return launch_ragged<__nv_bfloat16>(a, st);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core bodies' eligibility, for the wrapper's split planning.
extern "C" int paged_attention_uses_mma(int dtype, int D, int G) {
  return mma_ok(dtype, D, G) ? 1 : 0;
}

// Resident decode blocks per SM of the tensor-core decode body at head dim
// D over dense (int8 = 0) or int8 pools (what its shared memory and
// registers allow), for the wrapper's split plan. Returns a cudaError_t.
extern "C" int paged_decode_blocks_per_sm(int D, int int8, int* blocks) {
  *blocks = 0;
  cudaError_t e = cudaErrorInvalidValue;
#define DEC_OCCUPANCY(DD, Q)                                                  \
  if (D == DD && (int8 != 0) == Q) {                                          \
    e = cudaFuncSetAttribute(decode_attend<DD, Q>,                            \
                             cudaFuncAttributeMaxDynamicSharedMemorySize,     \
                             DecSmem<DD, Q>::BYTES);                          \
    if (e == cudaSuccess)                                                     \
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                      \
          blocks, decode_attend<DD, Q>, kDecThreads, DecSmem<DD, Q>::BYTES);  \
  }
  DEC_OCCUPANCY(64, false)
  DEC_OCCUPANCY(64, true)
  DEC_OCCUPANCY(128, false)
  DEC_OCCUPANCY(128, true)
  DEC_OCCUPANCY(256, false)
  DEC_OCCUPANCY(256, true)
#undef DEC_OCCUPANCY
  return (int)e;
}

// Resident blocks per SM of the prefill / ragged wgmma body at head dim D
// (what its shared memory and registers allow), for the wrapper's split
// plan. Returns a cudaError_t.
extern "C" int paged_attend_blocks_per_sm(int D, int ragged, int* blocks) {
  *blocks = 0;
  if (D == 64) return attend_occupancy<64>(ragged != 0, blocks);
  if (D == 128) return attend_occupancy<128>(ragged != 0, blocks);
  if (D == 256) return attend_occupancy<256>(ragged != 0, blocks);
  return (int)cudaErrorInvalidValue;
}
