// Packed-int4 weight-only matmul, for Hopper (built for sm_90a by
// kernels/build.py; plain C interface, loaded with ctypes by
// ops/int4_matmul.py).
//
// Replaces: generativeaiexamples_tpu/ops/int4_matmul.py `int4_matmul`
// (the pallas_call). Computes out = x @ unpack(q4) * scale without ever
// writing the unpacked weight to device memory. q4 is (K/2, N) int8:
// reduction rows (2r, 2r+1) are the (low, high) nibbles of byte (r, n),
// both sign-extended. Scales are per output channel (N,) or per group of
// `group` reduction rows (G, N), G = K / group; a group's partial sum is
// multiplied by its float32 scale as ops/quant.py `_grouped_matmul` does
// (per channel is the case group = K). Sums are float32.
//
// What bounds it: at decode (M = 8 slots, M = 1 for a logits row) the
// bytes of the packed weight, ~1 FMA per weight byte read; at a prefill
// bucket (M up to 1024) the operations.
//
// What the design does about it: the weight is read once (once per M
// tile) and unpacked in registers, so device memory sees only the int4
// bytes (half of int8, a quarter of bf16). One launch covers any M, on
// one of two paths picked from the shape:
// - Decode, M <= 8 (the GEMV path): a warp streams 4-byte words of q4
//   (4 columns of one packed row per lane, 128 columns per warp), sixteen
//   rows in flight, straight into fp32 registers; x is staged per warp in
//   shared memory, 64 packed rows at a time, and read back as broadcast
//   (even, odd) pairs. The reduction is split twice so that even
//   N = 4096 keeps ~2 blocks per SM streaming: the 8 warps of a block,
//   and S blocks per column tile (split-K), take whole groups (per
//   channel: 128-row chunks), each group's partial sum times its scale.
//   Warps reduce through shared memory; the S blocks write fp32
//   partials to a workspace, and the last of them to finish (a per-tile
//   counter) sums the S partials in a fixed order, so the result does
//   not depend on timing, writes the output and resets the counter to 0
//   for the next launch.
// - Otherwise (prefill, M up to 1024; or a shape the GEMV path does not
//   take): a 64 x 64 output tile per block, 4 x 4 outputs per thread, x
//   and the unpacked weight staged through shared memory. Group
//   boundaries may fall anywhere inside a stage: the inner loop runs in
//   segments that end at the next boundary, where the segment's partial
//   sum takes its scale.
// The arithmetic is CUDA-core fp32, so float32 activations keep full
// precision. Work not done yet (later PRs): tensor cores (mma.sync or
// wgmma; the B fragment's k pairs are exactly one packed byte) for bf16
// x at decode, where the GEMV path is issue-bound, and at prefill;
// cp.async/TMA staging.
//
// Invariants the launch relies on:
// - 32-bit offsets: the wrapper refuses M*K, (K/2)*N, M*N or G*N above
//   2^31 - 1. At this repo's shapes the largest is (K/2)*N = 2048 *
//   32000 = 65.5e6 (llama-2-7b's lm_head); a 1024-row prefill of
//   w_down has M*K = 11.3e6. GEMV weight offsets are 64-bit anyway.
// - x is row-major (M, K) and contiguous; out is (M, N), written once.
// - The GEMV workspace and counters belong to one stream at a time: the
//   wrapper keeps one pair per device and the port launches on one
//   stream, so consecutive launches never overlap. The counters start at
//   0 and every launch leaves them at 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The 4-bit two's-complement value held in the low bits of v, as a float.
// (v & 0xF) ^ 8 is the value + 8, in 0..15; placed in the mantissa of 2^23
// it makes the float 2^23 + value + 8 exactly, and one subtraction leaves
// the value: an integer op and an add instead of a slow int-to-float
// conversion.
__device__ __forceinline__ float nibble(int v) {
  return __int_as_float(0x4B000000 | ((v & 0xF) ^ 8)) - 8388616.f;
}

constexpr int kGemvWarps = 8;
constexpr int kGemvCols = 128;     // 4 columns per lane
constexpr int kGemvUnroll = 16;    // packed rows in flight per warp
constexpr int kGemvStage = 64;     // packed rows of x staged at a time
constexpr int kMaxSplit = 16;      // blocks per column tile, at most

// Decode path (see the note at the top). MM: compile-time bound on M.
// chunk_rows packed rows per work item (group / 2, or 64 per channel).
template <typename T, typename TO, int MM>
__global__ void __launch_bounds__(32 * kGemvWarps)
int4_gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ q4,
                 const float* __restrict__ scale, TO* __restrict__ out,
                 float* __restrict__ partial, int* __restrict__ counters,
                 int M, int K, int N, int group, int chunk_rows,
                 int n_chunks) {
  // Per warp: x of the packed rows being streamed (2 * kGemvStage
  // values per row of x), then the warp's partial output for the
  // cross-warp reduction.
  static_assert(2 * kGemvStage == kGemvCols, "one buffer serves both");
  __shared__ float buf[kGemvWarps][MM][kGemvCols];
  __shared__ int is_last;
  float(*xs)[kGemvCols] = buf[threadIdx.x >> 5];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int S = gridDim.y;
  const int n0 = blockIdx.x * kGemvCols;
  const int n = n0 + 4 * lane;  // this lane's 4 columns (N % 4 == 0)
  const bool col_ok = n < N;
  const bool per_channel = group == K;
  const int K2 = K / 2;

  float acc[MM][4];
#pragma unroll
  for (int m = 0; m < MM; ++m) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;
  }

  for (int c = blockIdx.y * kGemvWarps + warp; c < n_chunks;
       c += S * kGemvWarps) {
    const int r0 = c * chunk_rows;
    const int r1 = min(r0 + chunk_rows, K2);
    float part[MM][4];
#pragma unroll
    for (int m = 0; m < MM; ++m) {
#pragma unroll
      for (int j = 0; j < 4; ++j) part[m][j] = 0.f;
    }
    for (int sb = r0; sb < r1; sb += kGemvStage) {
      const int se = min(sb + kGemvStage, r1);
      // Stage x[:, 2 sb : 2 se] (coalesced, all loads in flight at once)
      // so the stream below reads it from shared memory.
      __syncwarp();
#pragma unroll
      for (int i = lane; i < MM * kGemvCols; i += 32) {
        const int m = i / kGemvCols;
        const int k = 2 * sb + (i - m * kGemvCols);
        xs[m][i - m * kGemvCols] =
            (m < M && k < 2 * se) ? to_float(x[m * K + k]) : 0.f;
      }
      __syncwarp();
      for (int rb = sb; rb < se; rb += kGemvUnroll) {
        unsigned int w[kGemvUnroll];
#pragma unroll
        for (int u = 0; u < kGemvUnroll; ++u) {
          const int r = rb + u;
          w[u] = (col_ok && r < se)
                     ? __ldg(reinterpret_cast<const unsigned int*>(
                           q4 + (long long)r * N + n))
                     : 0u;
        }
#pragma unroll
        for (int u = 0; u < kGemvUnroll; ++u) {
          // Rows past se carry w = 0 and x = 0: no branch needed.
          const int kk = 2 * (rb + u - sb);
          float lo[4], hi[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int b = (int)((w[u] >> (8 * j)) & 0xFFu);
            lo[j] = nibble(b);
            hi[j] = nibble(b >> 4);
          }
#pragma unroll
          for (int m = 0; m < MM; ++m) {
            const float2 xv = *reinterpret_cast<const float2*>(&xs[m][kk]);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              part[m][j] = fmaf(xv.x, lo[j], fmaf(xv.y, hi[j], part[m][j]));
          }
        }
      }
    }
    if (per_channel) {
#pragma unroll
      for (int m = 0; m < MM; ++m) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] += part[m][j];
      }
    } else if (col_ok) {  // chunk c is group c
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float s = scale[(long long)c * N + n + j];
#pragma unroll
        for (int m = 0; m < MM; ++m) acc[m][j] = fmaf(part[m][j], s, acc[m][j]);
      }
    }
  }

  __syncwarp();  // the warp is done with its x stage: reuse it
#pragma unroll
  for (int m = 0; m < MM; ++m) {
#pragma unroll
    for (int j = 0; j < 4; ++j) xs[m][4 * lane + j] = acc[m][j];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < M * kGemvCols; idx += blockDim.x) {
    const int m = idx / kGemvCols;
    const int col = idx - m * kGemvCols;
    const int gn = n0 + col;
    if (gn >= N) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kGemvWarps; ++w) v += buf[w][m][col];
    if (S == 1) {
      out[m * N + gn] = from_float<TO>(per_channel ? v * scale[gn] : v);
    } else {
      partial[((long long)blockIdx.y * M + m) * N + gn] = v;
    }
  }
  if (S == 1) return;

  // Split-K: the last block of this column tile to finish sums the S
  // partials (in order s = 0..S-1) and writes the output.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(&counters[blockIdx.x], 1) == S - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int idx = threadIdx.x; idx < M * kGemvCols; idx += blockDim.x) {
    const int m = idx / kGemvCols;
    const int gn = n0 + idx - m * kGemvCols;
    if (gn >= N) continue;
    float v = 0.f;
    for (int s = 0; s < S; ++s)
      v += __ldcg(&partial[((long long)s * M + m) * N + gn]);
    out[m * N + gn] = from_float<TO>(per_channel ? v * scale[gn] : v);
  }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;
}

// BM x BN outputs per block, BK reduction rows per stage, TM x TN outputs
// per thread (rows ty + i * TY, columns tx + j * TX: neighbouring threads
// take neighbouring columns).
template <typename T, typename TO, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
int4_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ q4,
                   const float* __restrict__ scale, TO* __restrict__ out,
                   int M, int K, int N, int group) {
  constexpr int TX = BN / TN;
  constexpr int TY = BM / TM;
  constexpr int NT = TX * TY;
  constexpr int BK2 = BK / 2;
  static_assert(BK % 2 == 0, "stages hold whole nibble pairs");

  __shared__ float xs[BK][BM + 1];  // +1: the transposed stores hit
                                    // distinct banks
  __shared__ float ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int K2 = K / 2;

  float acc[TM][TN], part[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc[i][j] = 0.f;
      part[i][j] = 0.f;
    }
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    // Activations: neighbouring threads read neighbouring k of one row.
#pragma unroll
    for (int idx = tid; idx < BM * BK; idx += NT) {
      const int m = idx / BK;
      const int k = idx - m * BK;
      const int gm = m0 + m;
      const int gk = k0 + k;
      xs[k][m] = (gm < M && gk < K) ? to_float(x[gm * K + gk]) : 0.f;
    }
    // Packed weight: each byte becomes its two reduction rows.
#pragma unroll
    for (int idx = tid; idx < BK2 * BN; idx += NT) {
      const int r = idx / BN;
      const int n = idx - r * BN;
      const int gr = k0 / 2 + r;
      const int gn = n0 + n;
      int b = 0;
      if (gr < K2 && gn < N) b = (int)(uint8_t)q4[gr * N + gn];
      ws[2 * r][n] = nibble(b);
      ws[2 * r + 1][n] = nibble(b >> 4);
    }
    __syncthreads();

    const int kend = min(BK, K - k0);
    int kk = 0;
    while (kk < kend) {
      const int g = (k0 + kk) / group;
      const int gend = (g + 1) * group - k0;  // this group's end, in-stage
      const int seg = min(kend, gend);
#pragma unroll 4
      for (; kk < seg; ++kk) {
        float a[TM], w[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + i * TY];
#pragma unroll
        for (int j = 0; j < TN; ++j) w[j] = ws[kk][tx + j * TX];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
          for (int j = 0; j < TN; ++j) part[i][j] = fmaf(a[i], w[j], part[i][j]);
        }
      }
      if (kk == gend) {  // group g ends here: apply its scale
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int gn = n0 + tx + j * TX;
          const float s = gn < N ? scale[g * N + gn] : 0.f;
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            acc[i][j] = fmaf(part[i][j], s, acc[i][j]);
            part[i][j] = 0.f;
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + i * TY;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + j * TX;
      if (gm < M && gn < N) out[gm * N + gn] = from_float<TO>(acc[i][j]);
    }
  }
}

template <typename T, typename TO, int BM, int BN, int BK, int TM, int TN>
int launch_tile(const void* x, const int8_t* q4, const float* scale,
                void* out, int M, int K, int N, int group,
                cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  int4_matmul_kernel<T, TO, BM, BN, BK, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
          static_cast<const T*>(x), q4, scale, static_cast<TO*>(out), M, K,
          N, group);
  return (int)cudaGetLastError();
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
  }
  return n;
}

// The decode path, or -1 when it does not take the shape (then the tiled
// path runs). ws: fp32 workspace of ws_floats; counters: n_counters
// zeroed ints.
template <typename T, typename TO>
int launch_gemv(const void* x, const int8_t* q4, const float* scale,
                void* out, float* ws, long long ws_floats, int* counters,
                int n_counters, int M, int K, int N, int group,
                cudaStream_t stream) {
  const bool per_channel = group == K;
  const int tiles = (N + kGemvCols - 1) / kGemvCols;
  if (M > 8 || N % 4 || (!per_channel && group % 2) ||
      reinterpret_cast<uintptr_t>(q4) % 4 ||
      tiles > n_counters)
    return -1;
  const int chunk_rows = per_channel ? 64 : group / 2;
  const int n_chunks = (K / 2 + chunk_rows - 1) / chunk_rows;
  // ~2 blocks per SM, while every warp keeps a chunk to stream.
  int S = (2 * sm_count() + tiles - 1) / tiles;
  S = min(S, max(1, n_chunks / kGemvWarps));
  S = max(1, min(S, kMaxSplit));
  if (S > 1 && (long long)S * M * N > ws_floats) S = 1;
  const dim3 grid(tiles, S);
  if (M == 1)
    int4_gemv_kernel<T, TO, 1><<<grid, 32 * kGemvWarps, 0, stream>>>(
        static_cast<const T*>(x), q4, scale, static_cast<TO*>(out), ws,
        counters, M, K, N, group, chunk_rows, n_chunks);
  else
    int4_gemv_kernel<T, TO, 8><<<grid, 32 * kGemvWarps, 0, stream>>>(
        static_cast<const T*>(x), q4, scale, static_cast<TO*>(out), ws,
        counters, M, K, N, group, chunk_rows, n_chunks);
  return (int)cudaGetLastError();
}

template <typename T, typename TO>
int launch(const void* x, const int8_t* q4, const float* scale, void* out,
           float* ws, long long ws_floats, int* counters, int n_counters,
           int M, int K, int N, int group, cudaStream_t stream) {
  const int err = launch_gemv<T, TO>(x, q4, scale, out, ws, ws_floats,
                                     counters, n_counters, M, K, N, group,
                                     stream);
  if (err >= 0) return err;
  return launch_tile<T, TO, 64, 64, 32, 4, 4>(x, q4, scale, out, M, K, N,
                                             group, stream);
}

}  // namespace

// x_dtype, out_dtype: 0 = bfloat16, 1 = float32. scale is (K / group, N)
// float32 (group = K: per channel). ws (ws_floats fp32) and counters
// (n_counters ints, all 0) are the decode path's split-K scratch, owned
// by the caller and left as found. The caller (ops/int4_matmul.py)
// validates shapes, dtypes, contiguity and the 32-bit offset limit.
// Returns cudaGetLastError() after the launch.
extern "C" int int4_matmul(int x_dtype, int out_dtype, const void* x,
                           const void* q4, const void* scale, void* out,
                           void* ws, long long ws_floats, void* counters,
                           int n_counters, int M, int K, int N, int group,
                           void* stream) {
  if (M < 1 || K < 2 || K % 2 || N < 1 || group < 1 || K % group)
    return (int)cudaErrorInvalidValue;
  const int8_t* q = static_cast<const int8_t*>(q4);
  const float* s = static_cast<const float*>(scale);
  float* w = static_cast<float*>(ws);
  int* c = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype * 2 + out_dtype) {
    case 0:
      return launch<__nv_bfloat16, __nv_bfloat16>(
          x, q, s, out, w, ws_floats, c, n_counters, M, K, N, group, st);
    case 1:
      return launch<__nv_bfloat16, float>(
          x, q, s, out, w, ws_floats, c, n_counters, M, K, N, group, st);
    case 2:
      return launch<float, __nv_bfloat16>(
          x, q, s, out, w, ws_floats, c, n_counters, M, K, N, group, st);
    case 3:
      return launch<float, float>(
          x, q, s, out, w, ws_floats, c, n_counters, M, K, N, group, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
