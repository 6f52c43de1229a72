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
// Bound. At decode (M = batch <= 8) the product reads every code once and
// does ~2M flops per code byte: bound by bytes (llama-3-8b int8: 218 MB of
// codes per layer, 67 us at 3.35 TB/s). At a prefill chunk (M = 2048) it is
// bound by operations. Codes never go to device memory in a wider type:
// each block dequantizes its tile in registers into shared memory.
//
// Design (right first, fast later).
// - bf16: tensor cores (mma.sync m16n8k16, f32 accumulators). A block owns
//   a BM x 128 output tile and walks K in BK-deep steps: x's tile is copied
//   to shared memory as is; the code tile is read with 16-byte loads along
//   N (coalesced), dequantized in registers with its group's scales, and
//   stored row-major [k][n] as bf16; ldmatrix.trans gives the B fragments.
//   Two shapes: BM = 16, BK = 64 for M <= 16 (decode), with K split over
//   grid z so enough blocks are in flight to keep the memory system busy;
//   BM = 64, BK = 32 otherwise (prefill). A split K writes f32 partial sums
//   [splits, M, N] and a second kernel adds them in split order: no
//   atomics, so results are deterministic.
// - float32: a scalar tiled body (64 x 64 tile, 4 x 4 outputs per thread).
//   The Pallas kernel casts x to bf16; the JAX package's default _mm
//   (dequantize to x.dtype, then x @ w) keeps f32, and serving never runs
//   the kernel in f32, so f32 follows _mm.
// Known limits, left for later work: no double-buffered (cp.async / TMA)
// tile loads, no wgmma, no weight re-layout for register-direct fragments.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // bf16 body: 4 warps

struct QArgs {
  const void* x;
  const uint8_t* q;
  const float* s;
  void* out;
  float* part;  // [splits, M, N] partial sums (split K only)
  int M, K, N, G;
  int kchunk;  // K rows per split
  int vec_x;   // x rows allow 16-byte loads
  int vec_q;   // code rows allow 16-byte loads, scale rows 16-byte loads
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragment of m16n8k16 from a row-major [k][n] tile: rows k .. k+15 at
// column n (lanes 0-15 give the row addresses; .trans transposes).
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& b0, uint32_t& b1,
                                              const __nv_bfloat16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(a));
}

// Round two f32 values to bf16 (round to nearest even) and pack them, the
// lower address in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ int nibble(uint8_t b, int hi) {
  const int v = hi ? (b >> 4) : (b & 0xF);
  return v > 7 ? v - 16 : v;
}

// 16 code bytes of one code row from column n (zeros past N or when !ok).
__device__ __forceinline__ uint4 load_codes(const QArgs& a, int row, int n,
                                            bool ok) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (!ok) return v;
  const uint8_t* p = a.q + (size_t)row * a.N + n;
  if (a.vec_q && n + 16 <= a.N) return *reinterpret_cast<const uint4*>(p);
  uint8_t* b = reinterpret_cast<uint8_t*>(&v);
#pragma unroll
  for (int e = 0; e < 16; ++e) b[e] = n + e < a.N ? p[e] : 0;
  return v;
}

// The 16 scales of group g from column n (zeros past N).
__device__ __forceinline__ void load_scales(const QArgs& a, int g, int n,
                                            float (&sc)[16]) {
  const float* p = a.s + (size_t)g * a.N + n;
  if (a.vec_q && n + 16 <= a.N) {
#pragma unroll
    for (int e = 0; e < 16; e += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + e);
      sc[e] = f.x;
      sc[e + 1] = f.y;
      sc[e + 2] = f.z;
      sc[e + 3] = f.w;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 16; ++e) sc[e] = n + e < a.N ? p[e] : 0.f;
}

// Dequantize one k row (16 codes from `codes`, high or low nibbles when
// packed) into b_s at [r][c .. c+15]; zeros when k is past the split.
template <bool PACKED, int BS>
__device__ __forceinline__ void store_row(const QArgs& a, __nv_bfloat16* b_s,
                                          uint4 codes, int hi, int k, int ke,
                                          int r, int c, int n, float (&sc)[16],
                                          int& sc_g) {
  uint32_t wd[8];  // 16 bf16 weights, two per word
  if (k < ke) {
    const int g = k / a.G;
    if (g != sc_g) {
      load_scales(a, g, n, sc);
      sc_g = g;
    }
    const uint32_t words[4] = {codes.x, codes.y, codes.z, codes.w};
#pragma unroll
    for (int e = 0; e < 16; e += 2) {
      float v[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint8_t b = (uint8_t)(words[(e + h) >> 2] >> (8 * ((e + h) & 3)));
        const int code = PACKED ? nibble(b, hi) : (int)(int8_t)b;
        v[h] = (float)code * sc[e + h];
      }
      wd[e >> 1] = pack_bf16(v[0], v[1]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) wd[e] = 0u;
  }
  uint4* dst = reinterpret_cast<uint4*>(b_s + r * BS + c);
  dst[0] = make_uint4(wd[0], wd[1], wd[2], wd[3]);
  dst[1] = make_uint4(wd[4], wd[5], wd[6], wd[7]);
}

template <int BM, int BN, int BK, int WM, int WN, bool PACKED>
__global__ void __launch_bounds__(kThreads) qmm_mma_kernel(QArgs a) {
  constexpr int AS = BK + 8;  // a_s row stride (elements): conflict-free A
  constexpr int BS = BN + 8;  // b_s row stride: conflict-free ldmatrix rows
  constexpr int MT = BM / WM / 16;
  constexpr int NT = BN / WN / 8;
  constexpr int CROWS = PACKED ? BK / 2 : BK;  // code rows per tile
  static_assert(WM * WN * 32 == kThreads, "4 warps");
  __shared__ __align__(16) __nv_bfloat16 a_s[BM * AS];
  __shared__ __align__(16) __nv_bfloat16 b_s[BK * BS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kb = blockIdx.z * a.kchunk;
  const int ke = min(kb + a.kchunk, a.K);
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  // this thread's 16 columns are the same in every tile (kThreads is a
  // multiple of BN / 16), so one group's scales serve many rows
  float sc[16];
  int sc_g = -1;

  for (int k0 = kb; k0 < ke; k0 += BK) {
    for (int i = tid; i < BM * BK / 8; i += kThreads) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int m = m0 + r, k = k0 + c;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m < a.M) {
        const __nv_bfloat16* p = x + (size_t)m * a.K + k;
        if (a.vec_x && k + 8 <= ke) {
          v = *reinterpret_cast<const uint4*>(p);
        } else {
          __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            e[j] = k + j < ke ? p[j] : __float2bfloat16_rn(0.f);
        }
      }
      *reinterpret_cast<uint4*>(a_s + r * AS + c) = v;
    }
    for (int i = tid; i < CROWS * (BN / 16); i += kThreads) {
      const int r = i / (BN / 16), c = (i % (BN / 16)) * 16;
      const int n = n0 + c;
      if (PACKED) {
        const int k = k0 + 2 * r;
        const uint4 codes = load_codes(a, k / 2, n, k < ke);
        store_row<true, BS>(a, b_s, codes, 0, k, ke, 2 * r, c, n, sc, sc_g);
        store_row<true, BS>(a, b_s, codes, 1, k + 1, ke, 2 * r + 1, c, n, sc,
                            sc_g);
      } else {
        const int k = k0 + r;
        const uint4 codes = load_codes(a, k, n, k < ke);
        store_row<false, BS>(a, b_s, codes, 0, k, ke, r, c, n, sc, sc_g);
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int row = wm * (BM / WM) + mt * 16 + (lane >> 2);
        const int col = kk * 16 + (lane & 3) * 2;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(a_s + row * AS + col);
        af[mt][1] =
            *reinterpret_cast<const uint32_t*>(a_s + (row + 8) * AS + col);
        af[mt][2] =
            *reinterpret_cast<const uint32_t*>(a_s + row * AS + col + 8);
        af[mt][3] =
            *reinterpret_cast<const uint32_t*>(a_s + (row + 8) * AS + col + 8);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, b_s + (kk * 16 + (lane & 15)) * BS +
                                  wn * (BN / WN) + nt * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], af[mt], b0, b1);
      }
    }
    __syncthreads();
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * (BM / WM) + mt * 16 + (lane >> 2) + 8 * (e >> 1);
        const int n = n0 + wn * (BN / WN) + nt * 8 + (lane & 3) * 2 + (e & 1);
        if (m >= a.M || n >= a.N) continue;
        if (a.part != nullptr)
          a.part[((size_t)blockIdx.z * a.M + m) * a.N + n] = acc[mt][nt][e];
        else
          out[(size_t)m * a.N + n] = __float2bfloat16_rn(acc[mt][nt][e]);
      }
}

// out[m][n] = sum over splits, in split order.
__global__ void qmm_combine_kernel(const float* part, __nv_bfloat16* out,
                                   int splits, size_t mn) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float v = 0.f;
  for (int z = 0; z < splits; ++z) v += part[(size_t)z * mn + i];
  out[i] = __float2bfloat16_rn(v);
}

// float32: 64 x 64 output tile, 16 x 16 threads with 4 x 4 outputs each.
constexpr int kF32Tile = 64, kF32K = 16, kF32Threads = 256;

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

// The bf16 tile shapes (the wrapper plans K splits for the small one).
constexpr int kSmallM = 16;

template <bool PACKED>
int launch_bf16(const QArgs& a, int splits, cudaStream_t st) {
  const int gx = (a.N + 127) / 128;
  if (a.M <= kSmallM) {
    qmm_mma_kernel<16, 128, 64, 1, 4, PACKED>
        <<<dim3(gx, 1, splits), kThreads, 0, st>>>(a);
  } else {
    qmm_mma_kernel<64, 128, 32, 2, 2, PACKED>
        <<<dim3(gx, (a.M + 63) / 64, splits), kThreads, 0, st>>>(a);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const size_t mn = (size_t)a.M * a.N;
  qmm_combine_kernel<<<(unsigned)((mn + 255) / 256), 256, 0, st>>>(
      a.part, static_cast<__nv_bfloat16*>(a.out), splits, mn);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; packed: 0 = int8 codes [K, N], 1 =
// packed int4 [K/2, N]. splits > 1 (bf16, M <= 16 only) needs part
// [splits, M, N] f32 and split_rows a multiple of 64; splits * split_rows
// must cover K. Returns a cudaError_t (0 = launched).
extern "C" int quant_matmul(int dtype, int packed, const void* x,
                            const void* q, const void* s, void* out,
                            void* part, int M, int K, int N, int G,
                            int splits, int split_rows, int vec_x, int vec_q,
                            void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (K <= 0 || G <= 0 || K % G || (packed && K % 2) || splits < 1)
    return (int)cudaErrorInvalidValue;
  QArgs a;
  a.x = x;
  a.q = static_cast<const uint8_t*>(q);
  a.s = static_cast<const float*>(s);
  a.out = out;
  a.part = splits > 1 ? static_cast<float*>(part) : nullptr;
  a.M = M;
  a.K = K;
  a.N = N;
  a.G = G;
  a.kchunk = splits > 1 ? split_rows : K;
  a.vec_x = vec_x;
  a.vec_q = vec_q;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits > 1 &&
      (dtype != 1 || M > kSmallM || part == nullptr || split_rows % 64 ||
       (long long)splits * split_rows < K ||
       (long long)(splits - 1) * split_rows >= K))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return packed ? launch_bf16<true>(a, splits, st)
                  : launch_bf16<false>(a, splits, st);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kF32Tile - 1) / kF32Tile, (M + kF32Tile - 1) / kF32Tile);
  if (packed)
    qmm_f32_kernel<true><<<grid, kF32Threads, 0, st>>>(a);
  else
    qmm_f32_kernel<false><<<grid, kF32Threads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
