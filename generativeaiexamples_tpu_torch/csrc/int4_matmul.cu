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
// Three paths; the caller names one (ops/int4_matmul.py `_path`) and a
// path that does not take the shape returns cudaErrorInvalidValue (no
// path falls back to another):
// - "tc", decode with bf16 x (M <= 8; K and N multiples of 16; per
//   channel or groups of a multiple of 128): tensor cores. Bound by the
//   packed weight's bytes (~1 weight byte read per 16 multiply-adds at
//   M = 8).
// - "gemv", decode with float32 x (M <= 8; N a multiple of 4, even
//   group): CUDA-core fp32, so float32 activations keep full precision
//   (tensor cores would round them to TF32). Issue-bound: each lane does
//   64 FMAs and 8 nibble conversions per 4 weight bytes.
// - "tile", prefill (any M; M up to 1024 on the served path): a 64 x 64
//   output tile per block on CUDA cores, x and the unpacked weight
//   staged through shared memory. Bound by its fp32 operations.
//
// The "tc" path. One mma.sync.m16n8k16 (bf16 in, fp32 accumulate) with
// the operands swapped: the weight is A (16 output columns x 16 k), x^T
// is B (16 k x 8 slots), so M <= 8 slots fill the n8 side and no MMA
// row is spent on padding; slots m >= M are zero in B and never written.
// - Streaming: a block owns a slab of 128 columns and a range of stages
//   of 128 reduction rows. A ring of 4 stages in shared memory is filled
//   by cp.async (16-byte copies; a warp copies 4 rows x 128 contiguous
//   bytes): 64 q4 rows, the stage's scale row and the (8, 128) tile of x,
//   so 3 stages (24 KB of q4) per block stay in flight while the warps
//   compute on the oldest, and up to 3 blocks share an SM (54 KB of
//   shared memory each; the launch bound caps registers at 85).
// - Warps: 2 across the slab (64 columns each) x 4 across k (2 of a
//   stage's 8 k16 steps each); the four k shares are summed through
//   shared memory at the end.
// - Fragment mapping, for lane (g, t) = (lane / 4, lane % 4): an A
//   register (fragment row i, k = 2t, 2t+1) is exactly one packed byte,
//   the low and high nibble of q4[k0/2 + t, column(i)]; a lane's four A
//   registers are the bytes at packed rows k0/2 + t and k0/2 + t + 4 of
//   fragment rows g and g + 8. Fragment row i of MMA tile j (j < 4) is
//   column c0 + 4 i + j of the warp's 64 columns c0.., so one 4-byte
//   read at row r, column c0 + 4g feeds the row-g register of all four
//   tiles and one at c0 + 32 + 4g their row-(g + 8) register. The
//   epilogue undoes the permutation.
// - Bank conflicts: shared q4 rows are padded from 128 to 160 bytes, so
//   the lanes of a 4-byte read (rows t, words g) hit banks 8t + g, all
//   distinct; x rows from 256 to 272 bytes (banks 4g + t).
// - Nibble to bf16: a byte permute puts byte j's low nibble in the low
//   half and its high nibble (from the word >> 4, shared by its 4 bytes)
//   in the high half; one lop3 keeps bits 0..2 of each nibble, flips bit
//   3 (nibble ^ 8 = value + 8, in 0..15) and sets 0x4300, which makes the
//   bf16 pair 128 + (value + 8); one bf16x2 FMA of -136 leaves the
//   values, exactly. 3 ops per 2 weights (+1 per 8), against 2
//   conversions and 16 FMAs on the "gemv" path.
// - B registers are x[g, k0 + 2t .. 2t + 1] and x[g, k0 + 8 + 2t ..],
//   4-byte reads of the staged x tile. C registers hold columns of
//   fragment rows g, g + 8 x slots 2t, 2t + 1.
// - Scales: a warp's k16 steps of a stage accumulate into a fresh C
//   fragment (the first MMA takes C = 0), which is then added to the
//   running sum times the stage's group scales (groups are multiples of
//   128 rows, so a stage lies in one group; the split may fall inside a
//   group); per channel, MMAs accumulate straight into the sum and the
//   scale is applied once at the end.
// - Split-K: the S blocks of a slab form one thread-block cluster (S <= 8,
//   the portable size), sized so that all blocks fit in one wave of 3 per
//   SM. After its k loop each block sums its warps' shares into shared
//   memory; then, after a cluster barrier, block y sums in rank order
//   every block's total for its 1/S of the slab's columns, read through
//   distributed shared memory, and writes the output. The order is
//   fixed, so the result does not depend on timing; nothing goes through
//   device memory, and no workspace or counter is needed.
// - Launch latency: a block waits a DRAM round trip for its first stage,
//   and the cluster epilogue waits for the slowest block of the cluster;
//   at 4096 x 4096 (4 stages per block) these fixed costs dominate. So
//   launches with S > 1 allow programmatic dependent launch: the kernel
//   streams its first stages of q4 and scales, which no earlier kernel
//   writes, before griddepcontrol.wait (after which it reads x and
//   writes out), and signals launch_dependents once its k loop is done,
//   so a back-to-back launch streams its weights under this one's
//   epilogue. With S = 1 (the lm_head's 250 slabs) it measured slower:
//   the early blocks only take the free slots and the launch starts
//   unevenly.
// Weights are exact in bf16 (-8..7) and each bf16 x bf16 product is
// exact in fp32, so the path differs from the plain version only in the
// order of the fp32 sums.
//
// Split-K on the "gemv" path: the S blocks of a column tile write fp32
// partials to a workspace, and the last of them to finish (a per-tile
// counter) sums the S partials in a fixed order, so the result does not
// depend on timing, writes the output and resets the counter to 0 for
// the next launch.
//
// Work not done yet (later PRs): tensor cores at prefill (wgmma with TMA
// staging of x and the weight), where the "tile" path is bound by fp32
// operations; the rest of the "tc" path's per-launch latency.
//
// Invariants the launch relies on:
// - 32-bit offsets: the wrapper refuses M*K, (K/2)*N, M*N or G*N above
//   2^31 - 1. At this repo's shapes the largest is (K/2)*N = 2048 *
//   32000 = 65.5e6 (llama-2-7b's lm_head); a 1024-row prefill of
//   w_down has M*K = 11.3e6. Decode-path weight offsets are 64-bit
//   anyway.
// - x is row-major (M, K) and contiguous; out is (M, N), written once.
// - The "gemv" path's split-K workspace and counters belong to one stream
//   at a time: the wrapper keeps one pair per (device, stream), so
//   launches that share a pair never overlap. The counters start at 0
//   and every launch leaves them at 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>
#include <type_traits>

namespace cg = cooperative_groups;

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

// The "tc" path's geometry. A block owns a slab of kTcCols columns (bytes
// of a q4 row) and a range of stages of kTcK reduction rows; the S blocks
// of a slab form one thread-block cluster.
constexpr int kTcWarps = 8;
constexpr int kTcColWarps = 2;                    // warps across the slab
constexpr int kTcKWarps = kTcWarps / kTcColWarps;  // warps across k
constexpr int kTcCols = 64 * kTcColWarps;         // 128 columns per block
constexpr int kTcRows = 64;                       // packed rows per stage
constexpr int kTcK = 2 * kTcRows;                 // 128 reduction rows
constexpr int kTcSteps = kTcK / 16 / kTcKWarps;   // k16 steps per warp
constexpr int kTcRing = 4;                        // stages in flight + 1
constexpr int kTcPerSm = 3;                       // resident blocks per SM
constexpr int kTcMaxCluster = 8;                  // portable cluster size
// Shared-memory rows are padded by 32 bytes: lane (g, t) reads word g of
// row t, so the banks are 8 t + g, all 32 distinct. x rows likewise
// (banks 4 g + t).
constexpr int kTcPitch = kTcCols + 32;
constexpr int kTcXPitch = 2 * kTcK + 16;          // bytes per row of x
constexpr int kTcScaleOff = kTcRows * kTcPitch;
constexpr int kTcXOff = kTcScaleOff + 4 * kTcCols;
constexpr int kTcStage = kTcXOff + 8 * kTcXPitch;  // bytes per stage
constexpr int kTcSmem = kTcRing * kTcStage;
static_assert(kTcStage % 16 == 0, "16-byte copies");
static_assert((kTcKWarps + 1) * 8 * kTcCols * 4 <= kTcSmem,
              "the reduction reuses the ring");

// 16 bytes from global to shared memory, asynchronously; zeros when !ok
// (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned int d =
      static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// Byte j of a q4 word w as the A fragment's bf16 pair (k, k + 1) of one
// column (wh = w >> 4). The permute puts byte j of w (low nibble) in bits
// 0..7 and byte j of wh (high nibble) in bits 16..23. One lop3 then keeps
// bits 0..2 of each nibble, flips bit 3 (nibble ^ 8 = value + 8, in
// 0..15), clears the rest and sets 0x4300: the bf16 pair 128 + (value +
// 8). The FMA subtracts 136 exactly.
__device__ __forceinline__ unsigned int nibble_pair(unsigned int w,
                                                    unsigned int wh, int j) {
  const unsigned int p = __byte_perm(w, wh, j | ((4 + j) << 8));
  // Per bit, with b = 0x43074307 and c = 0x43084308: b & c -> 1,
  // b only -> p, c only -> ~p, neither -> 0 (truth table 0xCA).
  unsigned int h, r;
  asm("lop3.b32 %0, %1, %2, %3, 0xCA;"
      : "=r"(h)
      : "r"(p), "r"(0x43074307u), "r"(0x43084308u));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;"
      : "=r"(r)
      : "r"(h), "r"(0x3F803F80u), "r"(0xC308C308u));  // h * 1 - 136
  return r;
}

// c += a . b, or c = a . b when `fresh` (a new partial sum).
template <bool FRESH>
__device__ __forceinline__ void mma_bf16(float (&c)[4], unsigned int a0,
                                         unsigned int a1, unsigned int a2,
                                         unsigned int a3, unsigned int b0,
                                         unsigned int b1) {
  if constexpr (FRESH)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};"
        : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(0.f),
          "f"(0.f), "f"(0.f), "f"(0.f));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One k16 step of a warp on a staged slot: 4 MMA tiles of 16 columns.
template <bool FRESH>
__device__ __forceinline__ void tc_step(float (&c)[4][4], const char* wrow,
                                        const char* xrow) {
  // A: packed rows t and t + 4 of the step, columns 4g.. and 32 + 4g..;
  // B: x[g, 2t ..] and x[g, 8 + 2t ..] of the step.
  const unsigned int w[2][2] = {
      {*reinterpret_cast<const unsigned int*>(wrow),
       *reinterpret_cast<const unsigned int*>(wrow + 32)},
      {*reinterpret_cast<const unsigned int*>(wrow + 4 * kTcPitch),
       *reinterpret_cast<const unsigned int*>(wrow + 4 * kTcPitch + 32)}};
  const unsigned int b0 = *reinterpret_cast<const unsigned int*>(xrow);
  const unsigned int b1 = *reinterpret_cast<const unsigned int*>(xrow + 16);
  unsigned int wh[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int ab = 0; ab < 2; ++ab) wh[h][ab] = w[h][ab] >> 4;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // a0: (row g, k 2t..), a1: (row g + 8, k 2t..),
    // a2: (row g, k 2t + 8..), a3: (row g + 8, k 2t + 8..).
    mma_bf16<FRESH>(c[j], nibble_pair(w[0][0], wh[0][0], j),
                    nibble_pair(w[0][1], wh[0][1], j),
                    nibble_pair(w[1][0], wh[1][0], j),
                    nibble_pair(w[1][1], wh[1][1], j), b0, b1);
  }
}

// The "tc" path (see the note at the top). Grid (slabs, S), clusters of
// (1, S): block y (its rank in the cluster) takes stages
// [y * n / S, (y + 1) * n / S) of the n = ceil(K / kTcK).
// PER_CHANNEL: scale is (N,), applied once at the end; else (G, N) with
// group a multiple of kTcK, so each stage lies in one group.
template <typename TO, bool PER_CHANNEL>
__global__ void __launch_bounds__(32 * kTcWarps, kTcPerSm)
int4_mma_kernel(const __nv_bfloat16* __restrict__ x,
                const int8_t* __restrict__ q4,
                const float* __restrict__ scale, TO* __restrict__ out,
                int M, int K, int N, int group) {
  extern __shared__ __align__(16) char ring[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int cw = warp % kTcColWarps;  // this warp's 64 columns of the slab
  const int kw = warp / kTcColWarps;  // and its k16 steps of each stage
  const int S = gridDim.y;
  const int n0 = blockIdx.x * kTcCols;
  const int K2 = K / 2;
  const int n_stages = (K + kTcK - 1) / kTcK;
  const int st0 = (int)((long long)blockIdx.y * n_stages / S);
  const int st1 = (int)((long long)(blockIdx.y + 1) * n_stages / S);

  // Stage st into its ring slot: 64 q4 rows of the slab (a warp copies 4
  // rows x 128 contiguous bytes), the stage's scale row, and the (8, 128)
  // tile of x (rows m >= M and k >= K are zeros).
  auto issue_w = [&](int st) {  // q4 rows and the scale row
    char* slot = ring + (st % kTcRing) * kTcStage;
    constexpr int kChunksPerRow = kTcCols / 16;
#pragma unroll
    for (int u = 0; u < kTcRows * kChunksPerRow / (32 * kTcWarps); ++u) {
      const int id = tid + 32 * kTcWarps * u;
      const int row = id / kChunksPerRow;
      const int col = (id % kChunksPerRow) * 16;
      const int gr = st * kTcRows + row;
      const bool ok = gr < K2 && n0 + col < N;
      cp_async16(slot + row * kTcPitch + col,
                 ok ? q4 + (long long)gr * N + n0 + col : q4, ok);
    }
    if (!PER_CHANNEL && tid < kTcCols / 4) {
      const int gn = n0 + 4 * tid;
      const bool ok = gn < N;
      const long long gi = (long long)st * kTcK / group;
      cp_async16(slot + kTcScaleOff + 16 * tid,
                 ok ? scale + gi * N + gn : scale, ok);
    }
  };
  auto issue_x = [&](int st) {  // the (8, 128) tile of x
    char* slot = ring + (st % kTcRing) * kTcStage;
    constexpr int kXChunksPerRow = 2 * kTcK / 16;
    const int id = tid - kTcCols / 4;
    if (id >= 0 && id < 8 * kXChunksPerRow) {
      const int m = id / kXChunksPerRow;
      const int kk = (id % kXChunksPerRow) * 8;
      const int gk = st * kTcK + kk;
      const bool ok = m < M && gk < K;
      cp_async16(slot + kTcXOff + m * kTcXPitch + 2 * kk,
                 ok ? x + (long long)m * K + gk : x, ok);
    }
  };

  float acc[4][4], part[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  }

  // The weights of the first stages do not depend on the launch before
  // this one (programmatic dependent launch), so they are in flight before
  // the wait for its results (x); the first group then holds them all.
#pragma unroll
  for (int p = 0; p < kTcRing - 1; ++p)
    if (st0 + p < st1) issue_w(st0 + p);
  asm volatile("griddepcontrol.wait;" ::: "memory");
#pragma unroll
  for (int p = 0; p < kTcRing - 1; ++p) {
    if (st0 + p < st1) issue_x(st0 + p);
    cp_async_commit();
  }
  for (int st = st0; st < st1; ++st) {
    cp_async_wait<kTcRing - 2>();  // stage st has landed (this thread's)
    __syncthreads();               // (everyone's); slot st - 1 is free
    if (st + kTcRing - 1 < st1) {
      issue_w(st + kTcRing - 1);
      issue_x(st + kTcRing - 1);
    }
    cp_async_commit();

    const char* slot = ring + (st % kTcRing) * kTcStage;
    const int s0 = kw * kTcSteps;  // this warp's first k16 step
    const char* wrow = slot + (8 * s0 + t) * kTcPitch + cw * 64 + 4 * g;
    const char* xrow = slot + kTcXOff + g * kTcXPitch + 32 * s0 + 4 * t;
    const int kleft = K - st * kTcK - 16 * s0;  // k16 steps past K skip
    if constexpr (PER_CHANNEL) {
#pragma unroll
      for (int s = 0; s < kTcSteps; ++s) {
        if (16 * s >= kleft) break;
        tc_step<false>(acc, wrow + 8 * s * kTcPitch, xrow + 32 * s);
      }
    } else if (kleft > 0) {
      // The stage's k16 steps into a fresh partial sum, which is then
      // added to the running sum times the stage's group scales.
      tc_step<true>(part, wrow, xrow);
#pragma unroll
      for (int s = 1; s < kTcSteps; ++s) {
        if (16 * s >= kleft) break;
        tc_step<false>(part, wrow + 8 * s * kTcPitch, xrow + 32 * s);
      }
      const float4 sa = *reinterpret_cast<const float4*>(
          slot + kTcScaleOff + 4 * (cw * 64 + 4 * g));
      const float4 sb = *reinterpret_cast<const float4*>(
          slot + kTcScaleOff + 4 * (cw * 64 + 32 + 4 * g));
      const float fa[4] = {sa.x, sa.y, sa.z, sa.w};
      const float fb[4] = {sb.x, sb.y, sb.z, sb.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[j][0] = fmaf(part[j][0], fa[j], acc[j][0]);
        acc[j][1] = fmaf(part[j][1], fa[j], acc[j][1]);
        acc[j][2] = fmaf(part[j][2], fb[j], acc[j][2]);
        acc[j][3] = fmaf(part[j][3], fb[j], acc[j][3]);
      }
    }
  }

  // The ring is idle: reuse it. red[kw][slot][column - n0] undoes the
  // fragment permutation; tot[slot][column - n0] is the block's sum.
  cp_async_wait<0>();
  __syncthreads();
  // The next launch may start streaming its weights now.
  asm volatile("griddepcontrol.launch_dependents;");
  float(*red)[8][kTcCols] = reinterpret_cast<float(*)[8][kTcCols]>(ring);
  float(*tot)[kTcCols] = red[kTcKWarps];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int ca = cw * 64 + 4 * g + j;
    red[kw][2 * t][ca] = acc[j][0];
    red[kw][2 * t + 1][ca] = acc[j][1];
    red[kw][2 * t][ca + 32] = acc[j][2];
    red[kw][2 * t + 1][ca + 32] = acc[j][3];
  }
  __syncthreads();
  for (int idx = tid; idx < M * kTcCols; idx += blockDim.x) {
    const int m = idx / kTcCols;
    const int col = idx - m * kTcCols;
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < kTcKWarps; ++i) v += red[i][m][col];
    const int gn = n0 + col;
    if (S > 1)
      tot[m][col] = v;
    else if (gn < N)
      out[m * N + gn] = from_float<TO>(PER_CHANNEL ? v * scale[gn] : v);
  }
  if (S == 1) return;

  // Split-K across the cluster: block y sums, in rank order, every
  // block's total for its share of the slab's columns, read from their
  // shared memory. The second barrier keeps each block's shared memory
  // alive until every read of it is done.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int c0 = blockIdx.y * kTcCols / S;
  const int width = (blockIdx.y + 1) * kTcCols / S - c0;
  for (int idx = tid; idx < M * width; idx += blockDim.x) {
    const int m = idx / width;
    const int col = c0 + idx - m * width;
    const int gn = n0 + col;
    float part_r[kTcMaxCluster];  // all S reads in flight, then summed
#pragma unroll
    for (int r = 0; r < kTcMaxCluster; ++r)
      part_r[r] = r < S ? *cluster.map_shared_rank(&tot[m][col], r) : 0.f;
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < kTcMaxCluster; ++r) v += part_r[r];
    if (gn < N)
      out[m * N + gn] = from_float<TO>(PER_CHANNEL ? v * scale[gn] : v);
  }
  cluster.sync();
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

// The "gemv" path. ws: fp32 workspace of ws_floats; counters: n_counters
// zeroed ints.
template <typename T, typename TO>
int launch_gemv(const void* x, const int8_t* q4, const float* scale,
                void* out, float* ws, long long ws_floats, int* counters,
                int n_counters, int M, int K, int N, int group,
                cudaStream_t stream) {
  const bool per_channel = group == K;
  const int tiles = (N + kGemvCols - 1) / kGemvCols;
  if (M > 8 || N % 4 || (!per_channel && group % 2) ||
      reinterpret_cast<uintptr_t>(q4) % 4 || tiles > n_counters)
    return (int)cudaErrorInvalidValue;
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

// The "tc" path (bf16 x). Needs no scratch: split-K reduces within a
// cluster.
template <typename TO, bool PER_CHANNEL>
int launch_mma_kernel(const void* x, const int8_t* q4, const float* scale,
                      void* out, int M, int K, int N, int group,
                      cudaStream_t stream) {
  auto kernel = int4_mma_kernel<TO, PER_CHANNEL>;
  // More than 48 KB of shared memory needs an opt-in, once per device.
  static unsigned int opted_in = 0;  // bit d: device d
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 32) return (int)cudaErrorInvalidDevice;
  if (!(opted_in >> dev & 1u)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in |= 1u << dev;
  }
  // S blocks per slab: as many as fit in one wave of kTcPerSm blocks per
  // SM (at N = 4096 there are only 32 slabs for 132 SMs), each with at
  // least 2 stages, at most one portable cluster.
  const int slabs = (N + kTcCols - 1) / kTcCols;
  const int n_stages = (K + kTcK - 1) / kTcK;
  const int S = max(1, min(min(kTcPerSm * sm_count() / slabs, n_stages / 2),
                           kTcMaxCluster));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(slabs, S);
  cfg.blockDim = dim3(32 * kTcWarps);
  cfg.dynamicSmemBytes = kTcSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = S;
  attr[0].val.clusterDim.z = 1;
  // Programmatic dependent launch (see the note at the top): this launch
  // may start while the one before it finishes; not with S = 1.
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = S > 1 ? 2 : 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel,
                                 static_cast<const __nv_bfloat16*>(x), q4,
                                 scale, static_cast<TO*>(out), M, K, N,
                                 group);
}

template <typename TO>
int launch_mma(const void* x, const int8_t* q4, const float* scale,
               void* out, int M, int K, int N, int group,
               cudaStream_t stream) {
  const bool per_channel = group == K;
  if (M > 8 || K % 16 || N % 16 || (!per_channel && group % kTcK) ||
      reinterpret_cast<uintptr_t>(q4) % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(scale) % 16)
    return (int)cudaErrorInvalidValue;
  if (per_channel)
    return launch_mma_kernel<TO, true>(x, q4, scale, out, M, K, N, group,
                                       stream);
  return launch_mma_kernel<TO, false>(x, q4, scale, out, M, K, N, group,
                                      stream);
}

// Path codes, as ops/int4_matmul.py passes them.
constexpr int kPathTc = 0;
constexpr int kPathGemv = 1;
constexpr int kPathTile = 2;

template <typename T, typename TO>
int launch(int path, const void* x, const int8_t* q4, const float* scale,
           void* out, float* ws, long long ws_floats, int* counters,
           int n_counters, int M, int K, int N, int group,
           cudaStream_t stream) {
  switch (path) {
    case kPathTc:
      if constexpr (std::is_same_v<T, __nv_bfloat16>)
        return launch_mma<TO>(x, q4, scale, out, M, K, N, group, stream);
      return (int)cudaErrorInvalidValue;  // tensor cores take bf16 x only
    case kPathGemv:
      return launch_gemv<T, TO>(x, q4, scale, out, ws, ws_floats, counters,
                                n_counters, M, K, N, group, stream);
    case kPathTile:
      return launch_tile<T, TO, 64, 64, 32, 4, 4>(x, q4, scale, out, M, K,
                                                 N, group, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// path: 0 = "tc", 1 = "gemv", 2 = "tile" (see the note at the top); a
// path that does not take the shape or dtype returns
// cudaErrorInvalidValue and launches nothing. x_dtype, out_dtype: 0 =
// bfloat16, 1 = float32. scale is (K / group, N) float32 (group = K: per
// channel). ws (ws_floats fp32) and counters (n_counters ints, all 0) are
// the "gemv" path's split-K scratch, owned by the caller and left as
// found; the other paths ignore them. The caller (ops/int4_matmul.py) validates shapes, dtypes,
// contiguity and the 32-bit offset limit. Returns cudaGetLastError()
// after the launch.
extern "C" int int4_matmul(int path, int x_dtype, int out_dtype,
                           const void* x, const void* q4, const void* scale,
                           void* out, void* ws, long long ws_floats,
                           void* counters, int n_counters, int M, int K,
                           int N, int group, void* stream) {
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
          path, x, q, s, out, w, ws_floats, c, n_counters, M, K, N, group,
          st);
    case 1:
      return launch<__nv_bfloat16, float>(
          path, x, q, s, out, w, ws_floats, c, n_counters, M, K, N, group,
          st);
    case 2:
      return launch<float, __nv_bfloat16>(
          path, x, q, s, out, w, ws_floats, c, n_counters, M, K, N, group,
          st);
    case 3:
      return launch<float, float>(
          path, x, q, s, out, w, ws_floats, c, n_counters, M, K, N, group,
          st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
