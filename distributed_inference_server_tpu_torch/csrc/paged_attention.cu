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
// Common design. A block owns one tile of queries of one row and one KV
// head: the G = H/KV query heads of that KV head share every K/V byte the
// block loads, so the pool is read once per (row, KV head, query tile)
// instead of once per query head. The block walks the row's tokens from the
// window's lower edge to min(valid, last query + 1) in tiles: it reads each
// token's page id from the table (clamped), loads the tile's K and V into
// shared memory with 16-byte loads, scores it, and updates an online
// softmax in f32. A Tile says which queries (first token, count, positions)
// and which KV range a block serves; decode, prefill and ragged differ only
// in how a block finds its Tile.
//
// Ragged (the engine's mixed step: decode rows and prefill chunks in one
// launch). The packed axis is cut into SEGMENTS: maximal runs of one row's
// tokens inside one TQ-wide window of the axis (TQ = the body's query tile).
// Segment starts are the tokens i with tok_row[i] >= 0 and (i % TQ == 0 or
// tok_row[i-1] != tok_row[i]); with each row contiguous there are at most
// ceil(S/TQ) + B of them, the grid's static size, so nothing is read back
// to the host. Block x finds the x-th start itself (a block-wide count over
// tok_row, a few KB from L2) and exits if there is none; blocks x <
// ceil(S/TQ) also write the zeros of window x's padding tokens. A decode
// row is a one-token segment and walks its whole history in one block (no
// KV split: a long decode row is the launch's longest block).
//
// Two bodies:
// - bf16, D in {64, 128}, G <= 64 (the serving path): tensor cores
//   (mma.sync m16n8k16, FlashAttention-2 layout). A block serves 64
//   (query, head) rows, 16 per warp; K sits row-major and V transposed in
//   shared memory (rows padded by 8 elements so fragment loads are
//   bank-conflict free); the scores stay in registers and are reused as
//   the A operand of P @ V. Decode splits each row's KV range over grid z
//   (flash-decoding) and a second kernel merges the partial softmaxes, so
//   B x KV x splits blocks fill the card instead of B x KV.
// - everything else (f32, other head sizes): a scalar body — one warp per
//   query row for the scores, one thread per (row, dim) output for P @ V.
//
// int8 pools (decode only). The codes are loaded 16 bytes at a time and
// converted to the body's type in shared memory, which is exact (|code| <=
// 127); the scales are folded in as the TPU kernel folds them: each score
// is multiplied by its key's k_scale after Q.K and before softcap and mask,
// and each probability by its key's v_scale before P.V (the softmax
// denominator keeps the unscaled probabilities). A token costs 2 D + 8
// bytes per KV head instead of 4 D (bf16): about half the bytes, the bound.
//
// Bound. Decode moves bytes, not operations: ~4 flops per K/V byte pair,
// far below the card's ~295 bf16 flops per byte; the design reads only the
// pages a row can see and never the dense [B, S_max] gather the plain path
// builds. Prefill at a 512-token chunk is near the balance point; the
// tensor-core body is what keeps it off the scalar pipes. Known limits,
// left for later work: no double-buffered (cp.async / TMA) tile loads and
// no wgmma.

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
  return tl;
}

// Ragged: zeros for the padding tokens of window w (the G heads of kvh).
template <typename T>
__device__ void zero_padding(const Args& a, int w, int TQ, int kvh) {
  const int G = a.H / a.KV, GD = G * a.D;
  T* out = static_cast<T*>(a.out);
  for (int i = threadIdx.x; i < TQ * GD; i += blockDim.x) {
    const int tok = w * TQ + i / GD;
    if (tok < a.T && a.tok_row[tok] < 0)
      out[((size_t)tok * a.H + kvh * G) * a.D + i % GD] = from_f<T>(0.f);
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
// bf16 tensor-core body
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps
constexpr int kMmaRows = 64;      // (query, head) rows per block, 16 per warp
constexpr int kMmaTK = 64;        // KV tokens per tile

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

struct Split {
  float* part_o;   // [B, H, NS, D] unnormalized partial outputs
  float* part_ml;  // [B, H, NS, 2] partial running max and sum
  int NS;          // KV splits per row (decode only; 1 = no split)
  int chunk;       // KV tokens per split
};

// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane l holds
//   A: rows l/4 and l/4+8, cols 2(l%4)+{0,1} and +8 (4 regs of 2 values);
//   B: k rows 2(l%4)+{0,1} and +8, col l/4 (2 regs);
//   C: rows l/4 (c0, c1) and l/4+8 (c2, c3), cols 2(l%4)+{0,1}.
//
// A block serves the tile's TQ queries (TQ * G <= 64 rows); z is its KV
// split (decode with sp.NS > 1) and selects the partial-output slot. Q8:
// int8 pools (codes converted to bf16 in shared memory, scales folded in).
template <int D, bool Q8>
__device__ void mma_attend(const Args& a, const Split& sp, const Tile& tl,
                           int kvh, int z, int TQ, const Scales& sc) {
  constexpr int TK = kMmaTK;
  constexpr int KS = D + 8;   // k_s row stride (elements)
  constexpr int VS = TK + 8;  // vt_s row stride (elements)
  constexpr int NT = TK / 8;  // score n-tiles
  constexpr int DK = D / 16;  // k-steps over the head dim
  constexpr int DN = D / 8;   // output n-tiles
  constexpr int DV = D / 8;   // 16-byte vectors per token row
  __shared__ __align__(16) __nv_bfloat16 k_s[TK * KS];
  __shared__ __align__(16) __nv_bfloat16 vt_s[D * VS];
  __shared__ float ks_s[Q8 ? TK : 1], vs_s[Q8 ? TK : 1];

  const int b = tl.b;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.H / a.KV;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* pk = static_cast<const __nv_bfloat16*>(a.pool_k);
  const __nv_bfloat16* pv = static_cast<const __nv_bfloat16*>(a.pool_v);

  const int eff_w = a.window > 0 ? a.window : (1 << 30);
  int t_begin = tl.lo;
  int t_end = tl.hi;
  if (sp.NS > 1) {  // this block's share of the row's KV range
    t_begin = max(t_begin, z * sp.chunk);
    t_end = min(t_end, (z + 1) * sp.chunk);
  }

  // the two rows this lane owns: row r = t * G + g (query t, head g)
  bool live[2];       // rows past the tile are dead
  int row_q[2];       // query position (-1 for a decode row with valid 0)
  size_t row_off[2];  // element offset of the row's q / out vector
  int row_h[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + (lane >> 2) + 8 * i;
    const int t = r / G, g = r - t * G;
    live[i] = r < TQ * G && t < tl.n;
    row_q[i] = live[i] ? tile_pos(tl, t) : 0;
    row_h[i] = kvh * G + g;
    row_off[i] = live[i] ? ((tl.tok0 + t) * a.H + row_h[i]) * D : 0;
  }
  const bool warp_live = __any_sync(0xffffffffu, live[0] || live[1]);

  uint32_t qf[DK][4];
#pragma unroll
  for (int kk = 0; kk < DK; ++kk)
#pragma unroll
    for (int rg = 0; rg < 4; ++rg) {
      const int i = rg & 1;
      const int col = kk * 16 + (lane & 3) * 2 + ((rg & 2) ? 8 : 0);
      qf[kk][rg] = live[i]
                       ? *reinterpret_cast<const uint32_t*>(q + row_off[i] + col)
                       : 0u;
    }

  float o[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dn][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};

  for (int k0 = t_begin; k0 < t_end; k0 += TK) {
    if constexpr (Q8) {
      // 16 int8 codes per load, converted to bf16 (exact)
      const int8_t* ck = static_cast<const int8_t*>(a.pool_k);
      const int8_t* cv = static_cast<const int8_t*>(a.pool_v);
      for (int i = tid; i < TK * (D / 16); i += kMmaThreads) {
        const int j = i / (D / 16), dv = i - j * (D / 16);
        const int pos = k0 + j;
        uint4 kk4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kk4;
        if (pos < t_end) {
          const size_t off = (pool_slot(a, b, pos) * a.KV + kvh) * D + dv * 16;
          kk4 = *reinterpret_cast<const uint4*>(ck + off);
          vv4 = *reinterpret_cast<const uint4*>(cv + off);
        }
        uint32_t kw[8];
#pragma unroll
        for (int e = 0; e < 16; e += 2)
          kw[e >> 1] = pack_bf16(code_at(kk4, e), code_at(kk4, e + 1));
        uint4* kd = reinterpret_cast<uint4*>(k_s + j * KS + dv * 16);
        kd[0] = make_uint4(kw[0], kw[1], kw[2], kw[3]);
        kd[1] = make_uint4(kw[4], kw[5], kw[6], kw[7]);
#pragma unroll
        for (int e = 0; e < 16; ++e)
          vt_s[(dv * 16 + e) * VS + j] = __float2bfloat16_rn(code_at(vv4, e));
      }
      load_kv_scales(a, sc, b, kvh, k0, TK, t_end, ks_s, vs_s);
    } else {
      for (int i = tid; i < TK * DV; i += kMmaThreads) {
        const int j = i / DV, dv = i - j * DV;
        const int pos = k0 + j;
        uint4 kk4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kk4;
        if (pos < t_end) {
          const int pslot = min(pos / a.page_size, a.P - 1);
          int page = a.tables[(size_t)b * a.P + pslot];
          page = min(max(page, 0), a.num_pages - 1);
          const size_t slot = (size_t)page * a.page_size + pos % a.page_size;
          const size_t off = (slot * a.KV + kvh) * D + (size_t)dv * 8;
          kk4 = *reinterpret_cast<const uint4*>(pk + off);
          vv4 = *reinterpret_cast<const uint4*>(pv + off);
        }
        *reinterpret_cast<uint4*>(k_s + j * KS + dv * 8) = kk4;
        const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv4);
#pragma unroll
        for (int e = 0; e < 8; ++e) vt_s[(dv * 8 + e) * VS + j] = ve[e];
      }
    }
    __syncthreads();

    if (warp_live) {
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DK; ++kk) {
          const uint32_t* kr = reinterpret_cast<const uint32_t*>(
              k_s + (j * 8 + (lane >> 2)) * KS + kk * 16 + (lane & 3) * 2);
          mma_bf16(s[j], qf[kk], kr[0], kr[4]);
        }
      }
      // scale, softcap (before the mask), mask; row maxima
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int key = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
          float x = s[j][e] * a.scale;
          if constexpr (Q8) x *= ks_s[key - k0];
          if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
          const int qp = row_q[i];
          const bool ok =
              live[i] && key < t_end && key <= qp && key > qp - eff_w;
          s[j][e] = ok ? x : kNegInf;
          mx[i] = fmaxf(mx[i], s[j][e]);
        }
      // online softmax in f32; the four lanes of a row share its stats
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_r[i], mx[i]);
        alpha[i] = expf(m_r[i] - m_new);
        m_r[i] = m_new;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float p =
              s[j][e] > 0.5f * kNegInf ? expf(s[j][e] - m_r[i]) : 0.f;
          sum[i] += p;
          if constexpr (Q8)  // v scales fold into P; the sum keeps raw p
            s[j][e] = p * vs_s[j * 8 + (lane & 3) * 2 + (e & 1)];
          else
            s[j][e] = p;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
        sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
        l_r[i] = l_r[i] * alpha[i] + sum[i];
      }
#pragma unroll
      for (int dn = 0; dn < DN; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dn][e] *= alpha[e >> 1];
      // O += P @ V, P re-packed from the score registers as A fragments
#pragma unroll
      for (int jj = 0; jj < TK / 16; ++jj) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * jj][0], s[2 * jj][1]),
            pack_bf16(s[2 * jj][2], s[2 * jj][3]),
            pack_bf16(s[2 * jj + 1][0], s[2 * jj + 1][1]),
            pack_bf16(s[2 * jj + 1][2], s[2 * jj + 1][3])};
#pragma unroll
        for (int dn = 0; dn < DN; ++dn) {
          const uint32_t* vr = reinterpret_cast<const uint32_t*>(
              vt_s + (dn * 8 + (lane >> 2)) * VS + jj * 16 + (lane & 3) * 2);
          mma_bf16(o[dn], pa, vr[0], vr[4]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!live[i]) continue;
    if (sp.NS > 1) {
      const size_t part = ((size_t)b * a.H + row_h[i]) * sp.NS + z;
      float* po = sp.part_o + part * D;
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        const int d = dn * 8 + (lane & 3) * 2;
        po[d] = o[dn][2 * i];
        po[d + 1] = o[dn][2 * i + 1];
      }
      if ((lane & 3) == 0) {
        sp.part_ml[part * 2] = m_r[i];
        sp.part_ml[part * 2 + 1] = l_r[i];
      }
    } else {
      const float inv = 1.f / fmaxf(l_r[i], 1e-30f);
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) + row_off[i];
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        const int d = dn * 8 + (lane & 3) * 2;
        *reinterpret_cast<__nv_bfloat162*>(out + d) =
            __floats2bfloat162_rn(o[dn][2 * i] * inv, o[dn][2 * i + 1] * inv);
      }
    }
  }
}

// Decode (grid z = KV split) and prefill (grid z = query tile).
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    mma_attend_kernel(Args a, Split sp, int decode) {
  const int TQ = decode ? 1 : kMmaRows / (a.H / a.KV);
  const int z = blockIdx.z;
  const Tile tl = dense_tile(a, blockIdx.x, decode ? 0 : z * TQ, TQ, decode);
  mma_attend<D, false>(a, sp, tl, blockIdx.y, z, TQ, Scales{nullptr, nullptr});
}

// Decode over int8 pools (grid z = KV split).
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    mma_decode_int8_kernel(Args a, Split sp, Scales sc) {
  const Tile tl = dense_tile(a, blockIdx.x, 0, 1, true);
  mma_attend<D, true>(a, sp, tl, blockIdx.y, blockIdx.z, 1, sc);
}

// Ragged: grid x = segment, y = KV head.
template <int D>
__global__ void __launch_bounds__(kMmaThreads) mma_ragged_kernel(Args a) {
  const int TQ = kMmaRows / (a.H / a.KV);
  if (blockIdx.x * TQ < a.T)
    zero_padding<__nv_bfloat16>(a, blockIdx.x, TQ, blockIdx.y);
  const Tile tl = ragged_tile(a, blockIdx.x, TQ);
  if (tl.n == 0) return;
  mma_attend<D, false>(a, Split{nullptr, nullptr, 1, 0}, tl, blockIdx.y, 0,
                       TQ, Scales{nullptr, nullptr});
}

// Merge the decode splits of one (row, head): one thread per output dim.
template <int D>
__global__ void __launch_bounds__(D)
    combine_splits_kernel(const float* part_o, const float* part_ml,
                          __nv_bfloat16* out, int NS) {
  const size_t bh = blockIdx.x;  // row * H + head
  const int d = threadIdx.x;
  const float* ml = part_ml + bh * NS * 2;
  float m = kNegInf;
  for (int s = 0; s < NS; ++s) m = fmaxf(m, ml[2 * s]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < NS; ++s) {
    const float wgt = expf(ml[2 * s] - m);
    l += ml[2 * s + 1] * wgt;
    acc += part_o[(bh * NS + s) * D + d] * wgt;
  }
  out[bh * D + d] = __float2bfloat16(acc / fmaxf(l, 1e-30f));
}

bool mma_ok(int dtype, int D, int G) {
  return dtype == 1 && (D == 64 || D == 128) && G >= 1 && G <= kMmaRows;
}

// sc.k != nullptr: decode over int8 pools.
template <int D>
int launch_mma(const Args& a, int B, int decode, const Split& sp,
               cudaStream_t st, const Scales& sc) {
  const int TQ = decode ? 1 : kMmaRows / (a.H / a.KV);
  const int gz = decode ? sp.NS : (a.T + TQ - 1) / TQ;
  if (sc.k != nullptr)
    mma_decode_int8_kernel<D><<<dim3(B, a.KV, gz), kMmaThreads, 0, st>>>(
        a, sp, sc);
  else
    mma_attend_kernel<D><<<dim3(B, a.KV, gz), kMmaThreads, 0, st>>>(a, sp,
                                                                  decode);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !(decode && sp.NS > 1)) return (int)e;
  combine_splits_kernel<D><<<B * a.H, D, 0, st>>>(
      sp.part_o, sp.part_ml, static_cast<__nv_bfloat16*>(a.out), sp.NS);
  return (int)cudaGetLastError();
}

int dispatch_mma(const Args& a, int B, int decode, const Split& sp,
                 cudaStream_t st,
                 const Scales& sc = Scales{nullptr, nullptr}) {
  if (a.D == 64) return launch_mma<64>(a, B, decode, sp, st, sc);
  return launch_mma<128>(a, B, decode, sp, st, sc);
}

int dispatch_mma_ragged(const Args& a, cudaStream_t st) {
  const dim3 grid(ragged_blocks(a, kMmaRows / (a.H / a.KV)), a.KV);
  if (a.D == 64)
    mma_ragged_kernel<64><<<grid, kMmaThreads, 0, st>>>(a);
  else
    mma_ragged_kernel<128><<<grid, kMmaThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
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
// Decode with splits > 1 (bf16 tensor-core body only) needs the partial
// buffers part_o [B, H, splits, D] and part_ml [B, H, splits, 2] (f32).
extern "C" int paged_decode(int dtype, const void* q, const void* pool_k,
                            const void* pool_v, const void* tables,
                            const void* valid, void* out, int B, int H,
                            int KV, int D, int page_size, int P,
                            int num_pages, int window, float softcap,
                            void* part_o, void* part_ml, int splits,
                            int split_chunk, void* stream) {
  Args a = make_args(q, pool_k, pool_v, tables, nullptr, valid, out, 1, B, H,
                     KV, D, page_size, P, num_pages, window, softcap);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mma_ok(dtype, D, H / KV)) {
    Split sp{static_cast<float*>(part_o), static_cast<float*>(part_ml),
             splits, split_chunk};
    if (splits > 1 && (part_o == nullptr || part_ml == nullptr))
      return (int)cudaErrorInvalidValue;
    if (splits < 1) sp.NS = 1;
    return dispatch_mma(a, B, 1, sp, st);
  }
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
                                 void* part_o, void* part_ml, int splits,
                                 int split_chunk, void* stream) {
  if (D % 16) return (int)cudaErrorInvalidValue;
  Args a = make_args(q, codes_k, codes_v, tables, nullptr, valid, out, 1, B,
                     H, KV, D, page_size, P, num_pages, window, softcap);
  const Scales sc{static_cast<const float*>(scale_k),
                  static_cast<const float*>(scale_v)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mma_ok(dtype, D, H / KV)) {
    Split sp{static_cast<float*>(part_o), static_cast<float*>(part_ml),
             splits, split_chunk};
    if (splits > 1 && (part_o == nullptr || part_ml == nullptr))
      return (int)cudaErrorInvalidValue;
    if (splits < 1) sp.NS = 1;
    return dispatch_mma(a, B, 1, sp, st, sc);
  }
  if (dtype == 0) return launch_decode<float, int8_t>(a, B, st, sc);
  if (dtype == 1) return launch_decode<__nv_bfloat16, int8_t>(a, B, st, sc);
  return (int)cudaErrorInvalidValue;
}

extern "C" int paged_prefill(int dtype, const void* q, const void* pool_k,
                             const void* pool_v, const void* tables,
                             const void* q_start, const void* valid,
                             void* out, int B, int T, int H, int KV, int D,
                             int page_size, int P, int num_pages, int window,
                             float softcap, void* stream) {
  Args a = make_args(q, pool_k, pool_v, tables, q_start, valid, out, T, B, H,
                     KV, D, page_size, P, num_pages, window, softcap);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mma_ok(dtype, D, H / KV))
    return dispatch_mma(a, B, 0, Split{nullptr, nullptr, 1, 0}, st);
  if (dtype == 0) return launch_prefill<float>(a, B, st);
  if (dtype == 1) return launch_prefill<__nv_bfloat16>(a, B, st);
  return (int)cudaErrorInvalidValue;
}

// q, out [S, H, D]; tok_row, q_pos [S]; tables [B, P]; valid [B] (B >= 1).
extern "C" int paged_ragged(int dtype, const void* q, const void* pool_k,
                            const void* pool_v, const void* tables,
                            const void* tok_row, const void* q_pos,
                            const void* valid, void* out, int S, int B,
                            int H, int KV, int D, int page_size, int P,
                            int num_pages, int window, float softcap,
                            void* stream) {
  if (S <= 0) return (int)cudaSuccess;
  if (B < 1) return (int)cudaErrorInvalidValue;
  Args a = make_args(q, pool_k, pool_v, tables, nullptr, valid, out, S, B, H,
                     KV, D, page_size, P, num_pages, window, softcap);
  a.tok_row = static_cast<const int*>(tok_row);
  a.q_pos = static_cast<const int*>(q_pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mma_ok(dtype, D, H / KV)) return dispatch_mma_ragged(a, st);
  if (dtype == 0) return launch_ragged<float>(a, st);
  if (dtype == 1) return launch_ragged<__nv_bfloat16>(a, st);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core body's eligibility, for the wrapper's split planning.
extern "C" int paged_attention_uses_mma(int dtype, int D, int G) {
  return mma_ok(dtype, D, G) ? 1 : 0;
}
