// Group-dequant matmul x @ dequant(q, s), for Hopper (sm_90a).
//
// Replaces the TPU kernel quant_matmul_pallas in
// distributed_inference_server_tpu/ops/pallas/fused.py (its two bodies,
// _q8_matmul_kernel and _q4_matmul_kernel).
//
// Contract (identical to quant_matmul_plain in ops/kernels/quant_matmul.py):
//   x   : [M, K] bfloat16 or float32, row-major
//   q   : [K, N] int8 codes, or (packed) [K/2, N] uint8 with two int4 codes
//         per byte: packed row i holds k = 2i in its low nibble and
//         k = 2i + 1 in its high nibble, both sign-extended
//   s   : [K/G, N] float32 scales, one per (input group of G rows, column)
//   out : [M, N] in x's type; w[k][n] = code * s[k/G][n] formed in f32 and
//         rounded to x's type (what dequantize(w, x.dtype) gives), products
//         accumulated in f32.
//
// Bound. At decode (M <= 16) the product reads every code once and does
// ~2M flops per code byte: bound by bytes (llama-3-8b int8: 218 MB of codes
// per layer, 67 us at 3.35 TB/s). At a prefill chunk (M = 2048) it is bound
// by operations (0.90 ms of bf16 tensor-core work per llama-3-8b layer at
// 989 TFLOP/s). Codes never go to device memory in a wider type.
//
// Design.
// - Dequantize once per block per k-tile. A block copies the raw codes of
//   its k-tile (BK = 64 k) and the scale rows the tile meets to shared
//   memory, and converts them there, once, into a bf16 tile that every row
//   of its output tile uses: w = (float)code * scale in f32, rounded to
//   bf16. The code is made exact in f32 without I2F (a byte permute into
//   the mantissa of 2^23, then a subtract); a thread converts 8 columns of
//   consecutive k rows and reads each group's scales once.
// - Prefill (M > 16): a 256 x 128 output tile per block (128 x 128 when
//   the larger tile would leave SMs idle), one warpgroup per 64 rows on
//   wgmma.mma_async m64n128k16 (bf16, f32 sums in registers). A ring of
//   4 to 6 stages in dynamic shared memory holds the x tile (K-major,
//   128-byte swizzle, as the wgmma descriptor names it), the raw code tile
//   and its scale rows; cp.async keeps the next stages in flight while the
//   current one is dequantized into one of three bf16 B tiles (N-major,
//   128-byte swizzle: the layout 16-bit wgmma takes transposed) and the
//   previous tile's wgmma runs. Three B tiles let a k-tile cost one block
//   barrier. Blocks walk M fastest, so the blocks that share a weight tile
//   run together and its codes come from device memory once.
// - Decode (M <= 16): a 16 x BN tile per block (BN 128, 64 or 32) and K
//   split over grid y; the wrapper picks the column block and the split
//   from the shapes and the kernel's resident blocks per SM (whole waves).
//   A ring of 4 stages of cp.async copies keeps each block's next 3 code
//   tiles in flight; each stage is dequantized into a bf16 tile and fed to
//   mma.sync m16n8k16 (wgmma's 64-row A would waste 4x at M = 16). A split
//   writes f32 partial sums [splits, M, N]; the last block of a column
//   block (an int32 ticket, atomically taken from a zeroed buffer and put
//   back to zero) adds the partials in split order and writes the output:
//   one launch, and the result does not depend on which block came last.
// - Copies: per-thread sources are computed once and advanced a tile at a
//   time; only edge tiles (K, N, or rows that do not allow 16-byte copies:
//   K % 8 or N % 16 not 0, a misaligned base) take the checked, zero-
//   filling path. Rows past M, K or the split are zero-filled, so their
//   weights and products are zero without a test in the arithmetic.
// - float32: a scalar tiled body (64 x 64 tile, 4 x 4 outputs per thread).
//   The Pallas kernel casts x to bf16; the JAX package's default _mm
//   (dequantize to x.dtype, then x @ w) keeps f32, and serving never runs
//   the kernel in f32, so f32 follows _mm.
// Known limits, left for later work: every thread copies, dequantizes and
// issues, so a block's steps run one after another between its barriers
// (no TMA, no warp specialisation, no persistent blocks); a prefill grid
// smaller than the SM count is not split over K; the prefill tile
// re-dequantizes each weight tile once per 256 (or 128) rows of M and
// re-reads x from L2 once per column block; groups shorter than 32 read
// their scales from global memory; the ticket buffer assumes one launch at
// a time per stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;  // k rows per tile (both bf16 bodies)

struct QArgs {
  const void* x;
  const uint8_t* q;
  const float* s;
  void* out;
  float* part;  // [splits, M, N] partial sums (split K only)
  int* ticket;  // one zeroed counter per column block (split K only)
  int M, K, N, G;
  int kchunk;  // K rows per split
  int vec_x;   // x rows allow 16-byte copies
  int vec_q;   // code rows allow 16-byte copies, scale rows 16-byte loads
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte copy global -> shared in the background; the bytes past `n`
// (0 or 16 here) are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
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

// 8 elements of x row m from column k into dst (zeros past M or ke).
__device__ __forceinline__ void copy_x(const QArgs& a, void* dst, int m, int k,
                                       int ke) {
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const bool row = m < a.M;
  if (a.vec_x) {  // K % 8 == 0 and ke is a multiple of 8: all in or all out
    const bool in = row && k < ke;
    cp_async16(dst, in ? x + (size_t)m * a.K + k : x, in ? 16 : 0);
    return;
  }
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (row) {
    const __nv_bfloat16* p = x + (size_t)m * a.K + k;
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[j] = k + j < ke ? p[j] : __float2bfloat16_rn(0.f);
  }
  *reinterpret_cast<uint4*>(dst) = v;
}

// 16 code bytes of code row `row` from column n into dst (zeros past N or
// when !ok).
__device__ __forceinline__ void copy_q(const QArgs& a, void* dst, int row,
                                       bool ok, int n) {
  const uint8_t* p = a.q + (size_t)row * a.N + n;
  if (a.vec_q) {  // N % 16 == 0: a chunk is all in or all out
    const bool in = ok && n < a.N;
    cp_async16(dst, in ? p : a.q, in ? 16 : 0);
    return;
  }
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (ok) {
    uint8_t* b = reinterpret_cast<uint8_t*>(&v);
#pragma unroll
    for (int e = 0; e < 16; ++e) b[e] = n + e < a.N ? p[e] : 0;
  }
  *reinterpret_cast<uint4*>(dst) = v;
}

// A stage holds the scale rows of its k-tile when the group is at least
// this long (a 64-row tile then meets at most 3 groups); shorter groups
// read their scales from global memory.
constexpr int kStageScaleG = 32, kStageScaleRows = 3;

// Scale rows g0 .. g0 + 2 (g0 = k0 / G; rows that start at or past the
// tile's end min(k0 + 64, ke) left out), BN columns from n0, into dst
// [3][BN].
template <int BN>
__device__ __forceinline__ void copy_scales(const QArgs& a, float* dst,
                                            int k0, int ke, int n0, int tid,
                                            int nthreads) {
  const int g0 = k0 / a.G, kt = min(k0 + kBK, ke);
  for (int i = tid; i < kStageScaleRows * BN / 4; i += nthreads) {
    const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
    const int g = g0 + r, n = n0 + c;
    float* d = dst + r * BN + c;
    const bool ok = g * a.G < kt;
    const float* p = a.s + (size_t)g * a.N + n;
    if (a.vec_q) {  // N % 16 == 0: 4 columns all in or all out
      const bool in = ok && n < a.N;
      cp_async16(d, in ? p : a.s, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) d[e] = ok && n + e < a.N ? p[e] : 0.f;
    }
  }
}

// The W scales of group g from column n (zeros past N).
template <int W>
__device__ __forceinline__ void load_scales(const QArgs& a, int g, int n,
                                            float (&sc)[W]) {
  const float* p = a.s + (size_t)g * a.N + n;
  if (a.vec_q && n + W <= a.N) {
#pragma unroll
    for (int e = 0; e < W; e += 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p + e));
      sc[e] = f.x;
      sc[e + 1] = f.y;
      sc[e + 2] = f.z;
      sc[e + 3] = f.w;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < W; ++e) sc[e] = n + e < a.N ? __ldg(p + e) : 0.f;
}

// Round two f32 values to bf16 (round to nearest even) and pack them, the
// lower address in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Exact f32 value of an int8 code without I2F: byte j of `u` (the codes
// with their sign bits flipped, c + 128) becomes the low mantissa byte of
// 2^23, and 2^23 + 128 is subtracted.
__device__ __forceinline__ float s8_at(uint32_t u, int j) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | j)) -
         8388736.f;
}

// The same for the int4 code in bits [sh, sh + 4) of `u` (nibbles with
// their sign bits flipped, c + 8).
__device__ __forceinline__ float s4_at(uint32_t u, int sh) {
  return __uint_as_float(((u >> sh) & 0xFu) | 0x4B000000u) - 8388616.f;
}

// 8 weights of one k row, 8 consecutive columns: codes (int8 bytes, or the
// low / high nibbles of 8 packed bytes), scales sc -> 4 packed bf16 words.
template <bool PACKED>
__device__ __forceinline__ void dequant8(uint2 w, int hi, const float* sc,
                                         uint32_t (&o)[4]) {
  if (PACKED) {
    const uint32_t u0 = w.x ^ 0x88888888u, u1 = w.y ^ 0x88888888u;
    const int h = hi ? 4 : 0;
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      o[e / 2] = pack_bf16(__fmul_rn(s4_at(u0, 8 * e + h), sc[e]),
                           __fmul_rn(s4_at(u0, 8 * e + 8 + h), sc[e + 1]));
      o[2 + e / 2] =
          pack_bf16(__fmul_rn(s4_at(u1, 8 * e + h), sc[4 + e]),
                    __fmul_rn(s4_at(u1, 8 * e + 8 + h), sc[5 + e]));
    }
  } else {
    const uint32_t u0 = w.x ^ 0x80808080u, u1 = w.y ^ 0x80808080u;
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      o[e / 2] = pack_bf16(__fmul_rn(s8_at(u0, e), sc[e]),
                           __fmul_rn(s8_at(u0, e + 1), sc[e + 1]));
      o[2 + e / 2] = pack_bf16(__fmul_rn(s8_at(u1, e), sc[4 + e]),
                               __fmul_rn(s8_at(u1, e + 1), sc[5 + e]));
    }
  }
}

// The W scales of k row k at columns n .. n + W - 1: from the stage's
// rows s_tile [3][bn] (groups g0 ..; column col of the tile) or, when
// s_tile is null, from global memory (a row past K takes the last group:
// its codes are zero).
template <int W>
__device__ __forceinline__ void row_scales(const QArgs& a, const float* s_tile,
                                           int g0, int bn, int col, int k,
                                           int n, float (&sc)[W]) {
  const int g = k / a.G;
  if (s_tile != nullptr) {
    const float4* p =
        reinterpret_cast<const float4*>(s_tile + (g - g0) * bn + col);
#pragma unroll
    for (int e = 0; e < W / 4; ++e) {
      const float4 f = p[e];
      sc[4 * e] = f.x;
      sc[4 * e + 1] = f.y;
      sc[4 * e + 2] = f.z;
      sc[4 * e + 3] = f.w;
    }
  } else {
    load_scales<W>(a, min(g, a.K / a.G - 1), n, sc);
  }
}

// Dequantize RPT consecutive k rows from kr (RPT / 2 code rows when
// packed) x 8 columns at col of a code tile with BN bytes a row into o[j],
// 4 packed bf16 words per row. Codes are loaded first; the scales are read
// once per group (cached in sc / sc_g across tiles) when the RPT rows share
// one, else per row. A row past K or past the split has zero codes.
template <bool PACKED, int RPT, int BN>
__device__ __forceinline__ void dequant_rows(const QArgs& a,
                                             const uint8_t* q_s, int kr,
                                             int col, int k0,
                                             const float* s_tile, int n,
                                             float (&sc)[8], int& sc_g,
                                             uint32_t (&o)[RPT][4]) {
  constexpr int CR = PACKED ? RPT / 2 : RPT;
  uint2 cw[CR];
#pragma unroll
  for (int i = 0; i < CR; ++i)
    cw[i] = *reinterpret_cast<const uint2*>(
        q_s + ((PACKED ? kr / 2 : kr) + i) * BN + col);
  const int g0 = k0 / a.G, g_first = (k0 + kr) / a.G;
  const bool one = g_first == (k0 + kr + RPT - 1) / a.G;
  if (one && g_first != sc_g) {
    row_scales<8>(a, s_tile, g0, BN, col, k0 + kr, n, sc);
    sc_g = g_first;
  }
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    if (!one) {
      const int g = (k0 + kr + j) / a.G;
      if (g != sc_g) {
        row_scales<8>(a, s_tile, g0, BN, col, k0 + kr + j, n, sc);
        sc_g = g;
      }
    }
    dequant8<PACKED>(cw[PACKED ? j / 2 : j], j & 1, sc, o[j]);
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of m16n8k16 from a row-major [m][k] tile: lanes 0-15 give
// rows 0-15 at column k, lanes 16-31 the same rows at k + 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// B fragment of m16n8k16 from a row-major [k][n] tile: rows k .. k+15 at
// column n (lanes 0-15 give the row addresses; .trans transposes).
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& b0, uint32_t& b1,
                                              const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(smem_u32(p)));
}

// ---------------------------------------------------------------------------
// decode body: M <= 16, bound by bytes
// ---------------------------------------------------------------------------

constexpr int kSmallM = 16;
constexpr int kDecStages = 4;
constexpr int kDecThreads = 128;  // 4 warps side by side along N

template <int BN, bool PACKED>
struct DecodeSmem {
  static constexpr int CROWS = PACKED ? kBK / 2 : kBK;  // code rows per tile
  static constexpr int XS = kBK + 8;  // x row stride (elements)
  static constexpr int BS = BN + 8;   // bf16 tile row stride: ldmatrix rows
  static constexpr int X_BYTES = kSmallM * XS * 2;
  static constexpr int S_OFF = X_BYTES + CROWS * BN;  // scale rows [3][BN]
  static constexpr int STAGE = S_OFF + kStageScaleRows * BN * 4;
  static constexpr int BYTES = kDecStages * STAGE + kBK * BS * 2;
};

template <int BN, bool PACKED>
__global__ void __launch_bounds__(kDecThreads)
    qmm_decode_kernel(QArgs a) {
  using L = DecodeSmem<BN, PACKED>;
  constexpr int NT = BN / 32;          // n8 tiles per warp
  constexpr int CPR = BN / 8;          // 8-column chunks per row
  constexpr int RPT = kBK * CPR / kDecThreads;  // k rows dequantized per thread
  constexpr int QCPR = BN / 16;        // 16-byte code chunks per code row
  constexpr int QCH = L::CROWS * QCPR;  // code chunks per tile
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* b_s =
      reinterpret_cast<__nv_bfloat16*>(smem + kDecStages * L::STAGE);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN;
  const int kb = blockIdx.y * a.kchunk;
  const int ke = min(kb + a.kchunk, a.K);
  const int ntiles = (ke - kb + kBK - 1) / kBK;
  const bool staged = a.G >= kStageScaleG;

  // Fast copies (16-byte rows, the tile's columns inside N, its k rows
  // inside the split): per-thread sources at tile 0, advanced a tile at a
  // time; x rows past M are zero-filled. Other tiles take the checked path.
  const bool fast_n = a.vec_x && a.vec_q && n0 + BN <= a.N;
  const int xr = tid >> 3, xc = tid & 7;  // 16 x rows x 8 chunks
  const __nv_bfloat16* x_src = static_cast<const __nv_bfloat16*>(a.x) +
                               (size_t)min(xr, a.M - 1) * a.K + kb + xc * 8;
  const int x_dst = (xr * L::XS + xc * 8) * 2, x_n = xr < a.M ? 16 : 0;
  const int qr = tid / QCPR, qc = (tid % QCPR) * 16;  // rows qr + step j
  constexpr int QSTEP = kDecThreads / QCPR;
  const uint8_t* q_src =
      a.q + (size_t)((PACKED ? kb / 2 : kb) + qr) * a.N + n0 + qc;
  const int sr = tid / (BN / 4), scol = (tid % (BN / 4)) * 4;

  // tile t of this split -> stage t % kDecStages (one commit group each)
  auto issue = [&](int t) {
    if (t < ntiles) {
      uint8_t* st = smem + (t % kDecStages) * L::STAGE;
      const int k0 = kb + t * kBK;
      if (fast_n && k0 + kBK <= ke) {
        cp_async16(st + x_dst, x_src + t * kBK, x_n);
        const uint8_t* qs = q_src + (size_t)t * (PACKED ? kBK / 2 : kBK) * a.N;
#pragma unroll
        for (int j = 0; j < (QCH + kDecThreads - 1) / kDecThreads; ++j)
          if (QCH % kDecThreads == 0 || tid + j * kDecThreads < QCH)
            cp_async16(st + L::X_BYTES + (qr + j * QSTEP) * BN + qc,
                       qs + (size_t)j * QSTEP * a.N, 16);
        if (staged && tid < kStageScaleRows * BN / 4) {
          const int g = k0 / a.G + sr;
          const bool in = g * a.G < k0 + kBK;
          cp_async16(st + L::S_OFF + (sr * BN + scol) * 4,
                     in ? a.s + (size_t)g * a.N + n0 + scol : a.s, in ? 16 : 0);
        }
      } else {
        copy_x(a, st + x_dst, xr, k0 + xc * 8, ke);
        for (int u = tid; u < QCH; u += kDecThreads) {
          const int cr = u / QCPR, cc = (u % QCPR) * 16;
          const int row = (PACKED ? k0 / 2 : k0) + cr;
          copy_q(a, st + L::X_BYTES + cr * BN + cc, row,
                 PACKED ? 2 * row < ke : row < ke, n0 + cc);
        }
        if (staged)
          copy_scales<BN>(a, reinterpret_cast<float*>(st + L::S_OFF), k0, ke,
                          n0, tid, kDecThreads);
      }
    }
    cp_async_commit();
  };

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // this thread dequantizes 8 columns (chunk c) of RPT consecutive k rows
  // from kr, the same in every tile; its scales are cached per group
  const int c = tid % CPR, kr = (tid / CPR) * RPT;
  float sc[8];
  int sc_g = -1;

#pragma unroll
  for (int t = 0; t < kDecStages - 1; ++t) issue(t);
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kDecStages - 2>();
    __syncthreads();  // tile t landed; every warp is done with b_s
    const uint8_t* st = smem + (t % kDecStages) * L::STAGE;
    const int k0 = kb + t * kBK;
    uint32_t o[RPT][4];
    dequant_rows<PACKED, RPT, BN>(
        a, st + L::X_BYTES, kr, c * 8, k0,
        staged ? reinterpret_cast<const float*>(st + L::S_OFF) : nullptr,
        n0 + c * 8, sc, sc_g, o);
#pragma unroll
    for (int j = 0; j < RPT; ++j)
      *reinterpret_cast<uint4*>(b_s + (kr + j) * L::BS + c * 8) =
          make_uint4(o[j][0], o[j][1], o[j][2], o[j][3]);
    issue(t + kDecStages - 1);  // into the stage tile t - 1 used
    __syncthreads();

    const __nv_bfloat16* x_s = reinterpret_cast<const __nv_bfloat16*>(st);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4(af, x_s + (lane & 15) * L::XS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, b_s + (kk * 16 + (lane & 15)) * L::BS +
                                  warp * (BN / 4) + j * 8);
        mma_bf16(acc[j], af, b0, b1);
      }
    }
  }
  cp_async_wait<0>();

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
  const bool split = gridDim.y > 1;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = (lane >> 2) + 8 * (e >> 1);
      const int n = n0 + warp * (BN / 4) + j * 8 + (lane & 3) * 2 + (e & 1);
      if (m >= a.M || n >= a.N) continue;
      if (split)
        a.part[((size_t)blockIdx.y * a.M + m) * a.N + n] = acc[j][e];
      else
        out[(size_t)m * a.N + n] = __float2bfloat16_rn(acc[j][e]);
    }
  if (!split) return;

  // split K: the last block of this column block adds the partial sums in
  // split order
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(a.ticket + blockIdx.x, 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int width = min(BN, a.N - n0), splits = gridDim.y;
  const size_t mn = (size_t)a.M * a.N;
  if ((a.N & 3) == 0) {  // 4 columns a thread, 16-byte partial loads
    const int w4 = width / 4;
    for (int i = tid; i < a.M * w4; i += kDecThreads) {
      const size_t o = (size_t)(i / w4) * a.N + n0 + (i % w4) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int z = 0; z < splits; ++z) {
        const float4 p =
            __ldcg(reinterpret_cast<const float4*>(a.part + z * mn + o));
        v.x += p.x;
        v.y += p.y;
        v.z += p.z;
        v.w += p.w;
      }
      *reinterpret_cast<__nv_bfloat162*>(out + o) =
          __floats2bfloat162_rn(v.x, v.y);
      *reinterpret_cast<__nv_bfloat162*>(out + o + 2) =
          __floats2bfloat162_rn(v.z, v.w);
    }
  } else {
    for (int i = tid; i < a.M * width; i += kDecThreads) {
      const size_t o = (size_t)(i / width) * a.N + n0 + i % width;
      float v = 0.f;
#pragma unroll 8
      for (int z = 0; z < splits; ++z) v += __ldcg(a.part + z * mn + o);
      out[o] = __float2bfloat16_rn(v);
    }
  }
  if (tid == 0) a.ticket[blockIdx.x] = 0;  // ready for the next launch
}

// ---------------------------------------------------------------------------
// prefill body: M > 16, bound by operations
// ---------------------------------------------------------------------------

constexpr int kSmemMax = 232448;  // dynamic shared memory a block may have

// BM x BN output tile; one warpgroup (128 threads) per 64 rows of BM.
template <int BM, int BN, bool PACKED>
struct PrefillSmem {
  static constexpr int THREADS = BM * 2;
  static constexpr int CROWS = PACKED ? kBK / 2 : kBK;
  static constexpr int X_BYTES = BM * kBK * 2;  // 128-byte rows
  static constexpr int S_OFF = X_BYTES + CROWS * BN;  // scale rows [3][BN]
  // rounded up to the swizzle's 1024-byte period
  static constexpr int STAGE =
      (S_OFF + kStageScaleRows * BN * 4 + 1023) / 1024 * 1024;
  static constexpr int B_BYTES = kBK * BN * 2;
  // ring depth: as many stages (up to 6) as fit beside the three B tiles;
  // + 1024: the base is aligned up to the swizzle's period
  static constexpr int FIT = (kSmemMax - 1024 - 3 * B_BYTES) / STAGE;
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static constexpr int BYTES = 1024 + STAGES * STAGE + 3 * B_BYTES;
  static_assert(STAGES >= 3, "a ring of at least 3 stages");
};

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// The bf16 B tile's offsets for wgmma: N-major, 128-byte swizzle, 64-column
// atoms 8 KB apart (the leading offset: the next 64 columns) and 8-k groups
// 1024 bytes apart (the stride offset).
constexpr uint32_t kBLeading = 8192, kBStride = 1024;

// d[64 x 128] (+)= A[64 x 16] (K-major) . B[16 x 128] (N-major), bf16 ->
// f32; accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator uses across a wgmma wait
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared layouts (bytes from the stage or tile base):
// x tile, K-major 128-byte swizzle: row m holds 64 k (128 bytes); 16-byte
//   chunk c of row m sits at m * 128 + ((c ^ (m % 8)) * 16).
// code tile: row-major [code row][BN columns] bytes; then the scale rows.
// bf16 B tile, N-major 128-byte swizzle: 64-column atoms of 8 KB; in an
//   atom, 8-k groups of 1024 bytes; row k holds 64 columns (128 bytes) with
//   chunk c (8 columns) at (c ^ (k % 8)) * 16.
__device__ __forceinline__ int b_offset(int k, int c) {
  return (c >> 3) * 8192 + (k >> 3) * 1024 + (k & 7) * 128 +
         (((c & 7) ^ (k & 7)) << 4);
}

template <int BM, int BN, bool PACKED>
__global__ void __launch_bounds__(BM * 2, 1) qmm_prefill_kernel(QArgs a) {
  using L = PrefillSmem<BM, BN, PACKED>;
  constexpr int kPreThreads = L::THREADS;
  constexpr int NI = BN / 128;  // m64n128 wgmmas per k16 step
  constexpr int CPR = BN / 8;              // 8-column chunks per row
  constexpr int RPT = kBK * CPR / kPreThreads;  // k rows dequantized per thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* b_tiles = smem + L::STAGES * L::STAGE;

  const int tid = threadIdx.x, wg = tid >> 7, tw = tid & 127;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int ntiles = (a.K + kBK - 1) / kBK;
  const bool staged = a.G >= kStageScaleG;

  // Fast copies (16-byte rows, the tile's columns inside N and its k rows
  // inside K): per-thread sources at tile 0, advanced a tile at a time; x
  // rows past M are zero-filled. Other tiles take the checked path. Each
  // warpgroup copies its own 64 x rows (only its own wgmma reads them);
  // both copy the codes and scales.
  constexpr int QCPR = BN / 16;  // 16-byte code chunks per code row
  constexpr int QSTEP = kPreThreads / QCPR;
  constexpr int QCH = L::CROWS * QCPR;  // code chunks per tile
  const bool fast_n = a.vec_x && a.vec_q && n0 + BN <= a.N;
  const int xr = wg * 64 + (tw >> 3), xc = tw & 7;  // rows xr + 16 i
  const __nv_bfloat16* x_src = static_cast<const __nv_bfloat16*>(a.x) +
                               (size_t)(m0 + xr) * a.K + xc * 8;
  const int x_dst = xr * 128 + ((xc ^ (xr & 7)) << 4);
  const int qr = tid / QCPR, qc = (tid % QCPR) * 16;  // rows qr + QSTEP j
  const uint8_t* q_src = a.q + (size_t)qr * a.N + n0 + qc;
  const int sr = tid / (BN / 4), scol = (tid % (BN / 4)) * 4;

  // tile t -> stage t % L::STAGES
  auto issue = [&](int t) {
    if (t < ntiles) {
      uint8_t* st = smem + (t % L::STAGES) * L::STAGE;
      const int k0 = t * kBK;
      if (fast_n && k0 + kBK <= a.K) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool in = m0 + xr + 16 * i < a.M;
          cp_async16(st + x_dst + i * 2048,
                     in ? x_src + (size_t)16 * i * a.K + k0 : a.x, in ? 16 : 0);
        }
        const uint8_t* qs = q_src + (size_t)(PACKED ? k0 / 2 : k0) * a.N;
#pragma unroll
        for (int j = 0; j < (QCH + kPreThreads - 1) / kPreThreads; ++j)
          if (QCH % kPreThreads == 0 || tid + j * kPreThreads < QCH)
            cp_async16(st + L::X_BYTES + (qr + j * QSTEP) * BN + qc,
                       qs + (size_t)j * QSTEP * a.N, 16);
        if (staged && tid < kStageScaleRows * BN / 4) {
          const int g = k0 / a.G + sr;
          const bool in = g * a.G < k0 + kBK;
          cp_async16(st + L::S_OFF + (sr * BN + scol) * 4,
                     in ? a.s + (size_t)g * a.N + n0 + scol : a.s, in ? 16 : 0);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          copy_x(a, st + x_dst + i * 2048, m0 + xr + 16 * i, k0 + xc * 8, a.K);
        for (int u = tid; u < QCH; u += kPreThreads) {
          const int r = u / QCPR, cc = (u % QCPR) * 16;
          const int row = (PACKED ? k0 / 2 : k0) + r;
          copy_q(a, st + L::X_BYTES + r * BN + cc, row,
                 PACKED ? 2 * row < a.K : row < a.K, n0 + cc);
        }
        if (staged)
          copy_scales<BN>(a, reinterpret_cast<float*>(st + L::S_OFF), k0,
                          a.K, n0, tid, kPreThreads);
      }
    }
    cp_async_commit();
  };

  // no zero fill: the first wgmma overwrites (accumulate = 0), so no other
  // instruction writes the accumulators while wgmma owns them
  float acc[NI][64];
  // this thread dequantizes 8 columns (chunk c) of RPT consecutive k rows
  // from kr, the same in every tile; its scales are cached per group
  const int c = tid % CPR, kr = (tid / CPR) * RPT, n = n0 + c * 8;
  float sc[8];
  int sc_g = -1;

  // One barrier a tile. Before it, each thread dequantizes tile t into B
  // tile t % 3 and waits for its copies of tile t + 1. That B tile was last
  // read by the wgmma of tile t - 3: each thread waited for its
  // warpgroup's wgmma of tile t - 3 before the previous barrier. After the
  // barrier, B tile t and tile t + 1's x, codes and scales are visible to
  // every thread (and, fenced, to wgmma).
#pragma unroll
  for (int t = 0; t < L::STAGES - 1; ++t) issue(t);
  cp_async_wait<L::STAGES - 2>();
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    const uint8_t* st = smem + (t % L::STAGES) * L::STAGE;
    const uint8_t* q_s = st + L::X_BYTES;
    uint8_t* b = b_tiles + (t % 3) * L::B_BYTES;
    const int k0 = t * kBK;
    const float* s_tile =
        staged ? reinterpret_cast<const float*>(st + L::S_OFF) : nullptr;
    // dequantize once (int8: RPT code rows; int4: RPT / 2 code rows, low
    // and high nibbles)
    uint32_t o[RPT][4];
    dequant_rows<PACKED, RPT, BN>(a, q_s, kr, c * 8, k0, s_tile, n, sc, sc_g,
                                  o);
#pragma unroll
    for (int j = 0; j < RPT; ++j)
      *reinterpret_cast<uint4*>(b + b_offset(kr + j, c)) =
          make_uint4(o[j][0], o[j][1], o[j][2], o[j][3]);
    // the generic-proxy writes (dequant, cp.async) -> visible to wgmma
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    cp_async_wait<L::STAGES - 3>();  // tile t + 1 landed
    __syncthreads();

    wgmma_fence();
    const uint32_t xa = smem_u32(st) + wg * 64 * 128;
    const uint32_t ba = smem_u32(b);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // A: advance 16 k (32 bytes) inside the swizzled rows; B: two 8-k
      // groups (2048 bytes); an instruction spans two 64-column atoms
      const uint64_t da = wgmma_desc(xa + kk * 32, 16, 1024);
#pragma unroll
      for (int i = 0; i < NI; ++i)
        wgmma_m64n128k16(acc[i], da,
                         wgmma_desc(ba + i * 16384 + kk * 2048, kBLeading,
                                    kBStride),
                         t > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // this warpgroup's wgmma of tile t - 1 is done
    issue(t + L::STAGES - 1);  // into the stage tile t - 1 used
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < NI; ++i) fence_operands(acc[i]);
  cp_async_wait<0>();

  // accumulator layout of m64nNk16: warp w of the warpgroup holds rows
  // 16w .. 16w + 15; d[j] is row lane/4 (+8 for j % 4 >= 2), column
  // 8 (j / 4) + 2 (lane % 4) + j % 2
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
  const int lane = tw & 31, w = tw >> 5;
  const bool pairs = (a.N & 1) == 0;
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < 64; j += 2) {
      const int m = m0 + wg * 64 + 16 * w + (lane >> 2) + 8 * ((j & 3) >> 1);
      const int nn = n0 + i * 128 + 8 * (j >> 2) + 2 * (lane & 3);
      if (m >= a.M || nn >= a.N) continue;
      __nv_bfloat16* p = out + (size_t)m * a.N + nn;
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(p) =
            __floats2bfloat162_rn(acc[i][j], acc[i][j + 1]);
      } else {
        p[0] = __float2bfloat16_rn(acc[i][j]);
        if (nn + 1 < a.N) p[1] = __float2bfloat16_rn(acc[i][j + 1]);
      }
    }
}

// ---------------------------------------------------------------------------
// float32 body: 64 x 64 output tile, 16 x 16 threads with 4 x 4 outputs each
// ---------------------------------------------------------------------------

constexpr int kF32Tile = 64, kF32K = 16, kF32Threads = 256;

__device__ __forceinline__ int nibble(uint8_t b, int hi) {
  const int v = hi ? (b >> 4) : (b & 0xF);
  return v > 7 ? v - 16 : v;
}

template <bool PACKED>
__global__ void __launch_bounds__(kF32Threads) qmm_f32_kernel(QArgs a) {
  __shared__ float a_s[kF32K][kF32Tile + 4];  // x tile, transposed [k][m]
  __shared__ float b_s[kF32K][kF32Tile + 4];  // dequantized [k][n]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kF32Tile, n0 = blockIdx.x * kF32Tile;
  const float* x = static_cast<const float*>(a.x);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < a.K; k0 += kF32K) {
    for (int i = tid; i < kF32Tile * kF32K; i += kF32Threads) {
      const int r = i / kF32K, kk = i % kF32K;
      const int m = m0 + r, k = k0 + kk;
      a_s[kk][r] = m < a.M && k < a.K ? x[(size_t)m * a.K + k] : 0.f;
    }
    for (int i = tid; i < kF32Tile * kF32K; i += kF32Threads) {
      const int kk = i / kF32Tile, c = i % kF32Tile;
      const int k = k0 + kk, n = n0 + c;
      float w = 0.f;
      if (k < a.K && n < a.N) {
        const int code =
            PACKED ? nibble(a.q[(size_t)(k / 2) * a.N + n], k & 1)
                   : (int)(int8_t)a.q[(size_t)k * a.N + n];
        w = (float)code * a.s[(size_t)(k / a.G) * a.N + n];
      }
      b_s[kk][c] = w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kF32K; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = a_s[kk][ty * 4 + i];
        bv[i] = b_s[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
      if (m < a.M && n < a.N) out[(size_t)m * a.N + n] = acc[i][j];
    }
}

// Launch `kernel` with `bytes` of dynamic shared memory (above 48 KB only
// after the attribute allows it).
template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int threads, int bytes, cudaStream_t st,
           const QArgs& a) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, threads, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

template <int BM, int BN, bool PACKED>
int launch_prefill(const QArgs& a, cudaStream_t st) {
  using L = PrefillSmem<BM, BN, PACKED>;
  return launch(qmm_prefill_kernel<BM, BN, PACKED>,
                dim3((a.M + BM - 1) / BM, (a.N + BN - 1) / BN), L::THREADS,
                L::BYTES, st, a);
}

template <bool PACKED>
int launch_bf16(const QArgs& a, int bm, int bn, int splits, cudaStream_t st) {
  if (a.M > kSmallM) {
    if (bm == 256 && bn == 128) return launch_prefill<256, 128, PACKED>(a, st);
    if (bm == 128 && bn == 128) return launch_prefill<128, 128, PACKED>(a, st);
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((a.N + bn - 1) / bn, splits);
  switch (bn) {
    case 128:
      return launch(qmm_decode_kernel<128, PACKED>, grid, kDecThreads,
                    DecodeSmem<128, PACKED>::BYTES, st, a);
    case 64:
      return launch(qmm_decode_kernel<64, PACKED>, grid, kDecThreads,
                    DecodeSmem<64, PACKED>::BYTES, st, a);
    case 32:
      return launch(qmm_decode_kernel<32, PACKED>, grid, kDecThreads,
                    DecodeSmem<32, PACKED>::BYTES, st, a);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Resident blocks per SM of the decode body with a bn-wide column block
// (what its shared memory and registers allow), for the wrapper's split
// plan. Returns a cudaError_t.
extern "C" int quant_matmul_decode_blocks_per_sm(int bn, int packed,
                                                 int* blocks) {
  *blocks = 0;
  cudaError_t e = cudaErrorInvalidValue;
#define QMM_OCCUPANCY(BN, P)                                                 \
  if (bn == BN && packed == P) {                                             \
    e = cudaFuncSetAttribute(qmm_decode_kernel<BN, P>,                       \
                             cudaFuncAttributeMaxDynamicSharedMemorySize,    \
                             DecodeSmem<BN, P>::BYTES);                      \
    if (e == cudaSuccess)                                                    \
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                     \
          blocks, qmm_decode_kernel<BN, P>, kDecThreads,                     \
          DecodeSmem<BN, P>::BYTES);                                         \
  }
  QMM_OCCUPANCY(128, false)
  QMM_OCCUPANCY(64, false)
  QMM_OCCUPANCY(32, false)
  QMM_OCCUPANCY(128, true)
  QMM_OCCUPANCY(64, true)
  QMM_OCCUPANCY(32, true)
#undef QMM_OCCUPANCY
  return (int)e;
}

// dtype: 0 = float32, 1 = bfloat16; packed: 0 = int8 codes [K, N], 1 =
// packed int4 [K/2, N]. bf16 with M > 16 runs the prefill body with a
// bm x bn tile (256 x 128 or 128 x 128). bf16 with M <= 16 runs
// the decode body with a bn-wide column block (128, 64 or 32) and K in
// `splits` splits of `split_rows` rows (a multiple of 64; splits *
// split_rows covers K and no split is empty); splits > 1 needs part
// [splits, M, N] f32 and ticket, one int32 per column block, zero before
// the launch (the kernel leaves it zero). float32 ignores bm and bn; only
// the decode body splits. Returns a cudaError_t (0 = launched).
extern "C" int quant_matmul(int dtype, int packed, const void* x,
                            const void* q, const void* s, void* out,
                            void* part, void* ticket, int M, int K, int N,
                            int G, int bm, int bn, int splits,
                            int split_rows,
                            int vec_x, int vec_q, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (K <= 0 || G <= 0 || K % G || (packed && K % 2) || splits < 1)
    return (int)cudaErrorInvalidValue;
  const bool decode = dtype == 1 && M <= kSmallM;
  if (!decode) splits = 1;
  if (decode &&
      (split_rows <= 0 || split_rows % kBK ||
       (long long)splits * split_rows < K ||
       (long long)(splits - 1) * split_rows >= K ||
       (splits > 1 && (part == nullptr || ticket == nullptr))))
    return (int)cudaErrorInvalidValue;
  QArgs a;
  a.x = x;
  a.q = static_cast<const uint8_t*>(q);
  a.s = static_cast<const float*>(s);
  a.out = out;
  a.part = static_cast<float*>(part);
  a.ticket = static_cast<int*>(ticket);
  a.M = M;
  a.K = K;
  a.N = N;
  a.G = G;
  a.kchunk = decode ? split_rows : K;
  a.vec_x = vec_x;
  a.vec_q = vec_q;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return packed ? launch_bf16<true>(a, bm, bn, splits, st)
                  : launch_bf16<false>(a, bm, bn, splits, st);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kF32Tile - 1) / kF32Tile, (M + kF32Tile - 1) / kF32Tile);
  if (packed)
    qmm_f32_kernel<true><<<grid, kF32Threads, 0, st>>>(a);
  else
    qmm_f32_kernel<false><<<grid, kF32Threads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
