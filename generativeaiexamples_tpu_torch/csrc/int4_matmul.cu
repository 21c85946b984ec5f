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
// (per channel is the case group = K). Sums are float32. GPTQ zero
// points (gbias, (G, N) float32 beside grouped scales, null when absent)
// add sum_g (sum_{k in g} x[m, k]) * gbias[g, n] on the tensor-core
// paths; the others refuse them. Rows of q4 and of grouped scales (and
// gbias) are ldq bytes and lds floats apart (N for a whole weight, more
// for a column slice of a wider one); columns are packed.
//
// Four paths; the caller names one (ops/int4_matmul.py `_path`) and a
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
// - "wg", prefill with bf16 x (M > 8; K and N multiples of 16; per
//   channel or groups of a multiple of 128): warpgroup tensor cores
//   (wgmma) fed by TMA. Bound by bf16 operations at M = 1024 (2 M K N
//   over 989 TFLOP/s); at M = 128 by operations too, but only just.
// - "tile", the rest (float32 x at M > 8, bf16 shapes "wg" refuses; any
//   M): a 64 x 64 output tile per block on CUDA cores, x and the
//   unpacked weight staged through shared memory, full fp32. Bound by
//   its fp32 operations.
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
// - GPTQ zero points: with gbias the stage also stages its gbias row, and
//   each k16 step runs a fifth MMA whose A is all ones: its C fragment
//   holds sum_k x[slot, k] over the warp's steps for the lane's slots 2t,
//   2t + 1, laid out as the partial's, so the stage epilogue adds
//   xsum * gbias[g, column] beside part * scale. The ones and x are exact
//   in bf16, so the row sums differ from the plain version's only in
//   their fp32 order.
//
// Split-K on the "gemv" path: the S blocks of a column tile write fp32
// partials to a workspace, and the last of them to finish (a per-tile
// counter) sums the S partials in a fixed order, so the result does not
// depend on timing, writes the output and resets the counter to 0 for
// the next launch.
//
// The "wg" path. out^T (N x M) = W^T (N x K) . x^T (K x M) with
// wgmma.mma_async m64n128k16 (bf16 in, fp32 accumulate): the weight is A,
// built in registers from the packed bytes; x^T is B, read by the tensor
// cores from shared memory through a descriptor. A warpgroup's 64 MMA
// rows are 64 output columns and its n side a tile of 128 tokens.
// - Block: 2 consumer warpgroups (64 columns each of a 128-column slab)
//   and 1 producer warp; a tile of 128 tokens; a range of stages of 128
//   reduction rows. Under a launch bound of one block per SM ptxas gives
//   the 288 threads 168 registers each (as for 384): per channel the
//   kernel uses 128, grouped 168 with a 16-byte spill. No setmaxnreg: it
//   moves registers between whole warpgroups, and the producer is one
//   warp.
// - Staging: a ring of 4 stages (40 KB each: x 128 tokens x 128 k bf16,
//   q4 64 packed rows x 128 columns) in dynamic shared memory, filled by
//   TMA. One thread of the producer warp waits for a slot to be free
//   (an "empty" mbarrier, one arrival per consumer warp), arms its
//   "full" mbarrier with the stage's bytes and starts 3 tensor copies:
//   x as two boxes of 64 k x 128 tokens (128 bytes a row, the 128-byte
//   swizzle span) and q4 as one box of 128 columns x 64 rows, all with
//   128-byte swizzle. Rows past M, K/2 and columns past N are filled with
//   zeros by the copy (a zero byte is the weight 0), so ragged edges need
//   no code in the loop. The tensor maps are encoded per launch through
//   cuTensorMapEncodeTiled, found with cudaGetDriverEntryPoint (no -lcuda),
//   and passed as __grid_constant__ parameters.
// - B descriptor: K-major with 128-byte swizzle, the layout TMA writes (a
//   token row of 128 bytes, 8 rows = 1024 bytes apart, every swizzle
//   region 1024-byte aligned); a k16 step inside a 64-k half adds 32
//   bytes to the start address. x (M, K) row-major is already K-major
//   x^T, so nothing is transposed.
// - A registers have the per-warp layout of mma.m16n8k16 (warp w of a
//   warpgroup holds MMA rows 16 w..16 w + 15). A warpgroup row is one
//   output column, and each register one packed byte, as on the "tc"
//   path; here MMA row g of a warp is column 2 g of its 16 and row g + 8
//   column 2 g + 1, so one 2-byte shared read (packed row r, columns
//   2 g, 2 g + 1) gives a lane both rows' registers of one k pair. The
//   swizzle puts the 4 packed rows a warp reads at once in 4 distinct
//   16-byte chunks of the 128-byte row: no bank conflicts. A stage's 32 A
//   registers are converted (the "tc" path's 3-op nibble_pair) before its
//   8 wgmmas start, so no register that an in-flight wgmma reads is
//   written; the two warpgroups take turns on the tensor cores.
//   (Double-buffering A per k16 step, with wgmma.wait_group 1 between
//   steps, removed the spill but measured slower: not kept.)
// - Group scales: a stage's 8 wgmmas go into a fresh fragment (the first
//   with scale-d = 0); after wgmma.wait_group, acc = fma(part, s, acc)
//   with the stage's group scales (a lane's rows are 2 columns: one
//   float2 of scales per stage, loaded before the wait). Per channel the
//   wgmmas accumulate straight into acc and the scale is applied once at
//   the end. Two fp32 fragments of 64 x 128 are 128 registers a thread.
// - Filling the card: a 128 x 128 tile per block gives 32 blocks at
//   N = 4096, M = 128. So, as on the "tc" path, the S blocks of a tile
//   split K as one thread-block cluster (S <= 8) and reduce through
//   distributed shared memory in rank order (deterministic, no workspace,
//   no atomics); S minimises (waves of blocks) x (stages per block), so
//   at M = 128 it is 4 at 4096 x 4096 and w_down, 3 at w_gate, and 1
//   once the tiles alone fill a wave (M = 1024).
// - GPTQ zero points: after a stage lands, 128 consumer threads each sum
//   one token row of the staged x tile (both 64-k halves; the swizzle
//   permutes 16-byte chunks within a row, so the sum ignores it) into a
//   per-slot array in shared memory; a named barrier over the consumers
//   publishes it, and the stage epilogue adds xsum[token] * gbias[g, col]
//   (one float2 of gbias per stage, loaded with the scales) beside
//   part * scale. The next write of a slot's sums comes after three more
//   such barriers, so no consumer still reads them. The barrier makes the
//   call 2.2-2.5x the time without zero points; summing in the producer
//   warp behind an mbarrier instead measured 2.9-3.3x (one warp cannot
//   keep up with a stage).
// - No programmatic dependent launch: the next launch starts after this
//   one completes, as a plain launch does.
// - Sums: weights are exact in bf16 and bf16 x bf16 products exact in
//   fp32, so the path differs from the plain version only in the order of
//   its fp32 sums.
//
// Work not done yet (later PRs): on the "wg" path, overlapping a
// warpgroup's stage epilogue (wait, scale FMAs) with its next stage's
// wgmmas, and a persistent schedule that hides each tile's prologue and
// epilogue (multicasting x to a pair of slabs, split-K at M = 1024 and a
// 5-stage ring measured slower); the rest of the "tc" path's per-launch
// latency.
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

#include <cuda.h>  // CUtensorMap and its enums; libcuda is not linked
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
                 int M, int K, int N, int group, int ldq, int lds,
                 int chunk_rows,
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
                           q4 + (long long)r * ldq + n))
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
        const float s = scale[(long long)c * lds + n + j];
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
constexpr int kTcBiasOff = kTcXOff + 8 * kTcXPitch;  // the gbias row
constexpr int kTcStage = kTcBiasOff + 4 * kTcCols;  // bytes per stage
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

// bf16 pair (1, 1): an all-ones A register.
constexpr unsigned int kOnes = 0x3F803F80u;

// One k16 step of a warp on a staged slot: 4 MMA tiles of 16 columns;
// with XSUM a fifth MMA of ones sums the step's x rows into xs (slots
// 2t, 2t + 1 in xs[0], xs[1]).
template <bool FRESH, bool XSUM>
__device__ __forceinline__ void tc_step(float (&c)[4][4], float (&xs)[4],
                                        const char* wrow,
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
  if constexpr (XSUM) mma_bf16<FRESH>(xs, kOnes, kOnes, kOnes, kOnes, b0, b1);
}

// The "tc" path (see the note at the top). Grid (slabs, S), clusters of
// (1, S): block y (its rank in the cluster) takes stages
// [y * n / S, (y + 1) * n / S) of the n = ceil(K / kTcK).
// PER_CHANNEL: scale is (N,), applied once at the end; else (G, N) with
// group a multiple of kTcK, so each stage lies in one group. GBIAS (grouped
// only): gbias (G, N) zero points, row stride lds.
template <typename TO, bool PER_CHANNEL, bool GBIAS>
__global__ void __launch_bounds__(32 * kTcWarps, kTcPerSm)
int4_mma_kernel(const __nv_bfloat16* __restrict__ x,
                const int8_t* __restrict__ q4,
                const float* __restrict__ scale,
                const float* __restrict__ gbias, TO* __restrict__ out,
                int M, int K, int N, int group, int ldq, int lds) {
  static_assert(!(PER_CHANNEL && GBIAS), "zero points need groups");
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
                 ok ? q4 + (long long)gr * ldq + n0 + col : q4, ok);
    }
    if (!PER_CHANNEL && tid < kTcCols / 4) {
      const int gn = n0 + 4 * tid;
      const bool ok = gn < N;
      const long long gi = (long long)st * kTcK / group;
      cp_async16(slot + kTcScaleOff + 16 * tid,
                 ok ? scale + gi * lds + gn : scale, ok);
    }
    // The gbias row, by the threads after those that copy x.
    const int bt = tid - kTcCols / 4 - 8 * (2 * kTcK / 16);
    if (GBIAS && bt >= 0 && bt < kTcCols / 4) {
      const int gn = n0 + 4 * bt;
      const bool ok = gn < N;
      const long long gi = (long long)st * kTcK / group;
      cp_async16(slot + kTcBiasOff + 16 * bt,
                 ok ? gbias + gi * lds + gn : gbias, ok);
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

  static_assert(kTcCols / 4 + 8 * (2 * kTcK / 16) + kTcCols / 4 <=
                    32 * kTcWarps,
                "the scale row, x and the gbias row have a thread each");
  float acc[4][4], part[4][4], xs[4];
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
        tc_step<false, false>(acc, xs, wrow + 8 * s * kTcPitch,
                              xrow + 32 * s);
      }
    } else if (kleft > 0) {
      // The stage's k16 steps into a fresh partial sum, which is then
      // added to the running sum times the stage's group scales.
      tc_step<true, GBIAS>(part, xs, wrow, xrow);
#pragma unroll
      for (int s = 1; s < kTcSteps; ++s) {
        if (16 * s >= kleft) break;
        tc_step<false, GBIAS>(part, xs, wrow + 8 * s * kTcPitch,
                              xrow + 32 * s);
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
      if constexpr (GBIAS) {
        // This warp's share of the stage's row sums times the zero points
        // (the k warps' shares add up in the reduction).
        const float4 za = *reinterpret_cast<const float4*>(
            slot + kTcBiasOff + 4 * (cw * 64 + 4 * g));
        const float4 zb = *reinterpret_cast<const float4*>(
            slot + kTcBiasOff + 4 * (cw * 64 + 32 + 4 * g));
        const float ga[4] = {za.x, za.y, za.z, za.w};
        const float gb[4] = {zb.x, zb.y, zb.z, zb.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[j][0] = fmaf(xs[0], ga[j], acc[j][0]);
          acc[j][1] = fmaf(xs[1], ga[j], acc[j][1]);
          acc[j][2] = fmaf(xs[0], gb[j], acc[j][2]);
          acc[j][3] = fmaf(xs[1], gb[j], acc[j][3]);
        }
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

// The "wg" path's geometry (see the note at the top).
constexpr int kWgCols = 128;                 // columns (q4 bytes) per slab
constexpr int kWgTokens = 128;               // tokens per tile: wgmma's n
constexpr int kWgK = 128;                    // reduction rows per stage
constexpr int kWgRows = kWgK / 2;            // packed rows per stage
constexpr int kWgSteps = kWgK / 16;          // k16 steps per stage
constexpr int kWgConsumers = 2;              // warpgroups, 64 columns each
constexpr int kWgThreads = 128 * kWgConsumers + 32;  // + the producer warp
constexpr int kWgRing = 4;                   // stages in shared memory
constexpr int kWgXHalf = kWgTokens * 128;    // bytes of a 64-k box of x
constexpr int kWgQ4Off = 2 * kWgXHalf;       // the q4 box, after x's two
constexpr int kWgStage = kWgQ4Off + kWgRows * kWgCols;  // 40 KB
constexpr int kWgSmem = kWgRing * kWgStage + 1024;      // + 1024-alignment
constexpr int kWgPitch = kWgCols + 4;        // floats per row of the sums
constexpr int kWgMaxCluster = 8;             // portable cluster size
constexpr int kWgAcc = kWgTokens / 2;        // fp32 fragment registers
static_assert(kWgStage % 1024 == 0 && kWgXHalf % 1024 == 0,
              "every swizzled box starts 1024-byte aligned");
static_assert(kWgTokens * kWgPitch * 4 <= kWgRing * kWgStage,
              "the split-K sums reuse the ring");
static_assert(2 * kWgSmem > 227 * 1024, "one block per SM");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Arrive once and expect `bytes` more from copies before the phase ends.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Spin until the phase of the given parity has completed; a phase that
// never completes (a lost copy or arrival) traps instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  int tries = 0;
  do {
    if (++tries > (1 << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// One box of a 2-D tensor map at (inner, outer) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int inner,
                                            int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(inner),
      "r"(outer)
      : "memory");
}

// Shared-memory descriptor of a K-major operand with 128-byte swizzle:
// start address >> 4, leading offset 1 (unused by this layout), stride
// 1024 bytes between 8-row groups (>> 4), layout type 1 (128B swizzle).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// d (64 x 128, fp32) = a (64 x 16 bf16, registers) . b (16 x 128 bf16,
// shared memory) + (scale_d ? d : 0), for the whole warpgroup.
#define WG_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_F16(i) WG_F4(i), WG_F4(i + 4), WG_F4(i + 8), WG_F4(i + 12)
__device__ __forceinline__ void wgmma_n128(float (&d)[kWgAcc],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}"
      : WG_F16(0), WG_F16(16), WG_F16(32), WG_F16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)
      : "memory");
}
#undef WG_F16
#undef WG_F4

// Keep the compiler from moving reads or writes of the fragment across
// the asynchronous wgmma (its registers are in flight until the wait).
__device__ __forceinline__ void fence_fragment(float (&d)[kWgAcc]) {
#pragma unroll
  for (int i = 0; i < kWgAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A stage's k16 steps into d (after d's own value when `accumulate`, else
// from zero), waited for: the caller may then read d and reuse a and the
// stage's shared memory.
__device__ __forceinline__ void wg_stage(float (&d)[kWgAcc],
                                         const uint32_t (&a)[kWgSteps][4],
                                         uint32_t xs, bool accumulate) {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
  fence_fragment(d);
#pragma unroll
  for (int s = 0; s < kWgSteps; ++s)
    wgmma_n128(d, a[s], wg_desc(xs + (s >> 2) * kWgXHalf + 32 * (s & 3)),
               accumulate || s > 0);
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_fragment(d);
}

template <typename TO>
__device__ __forceinline__ void store2(TO* p, float a, float b) {
  if constexpr (std::is_same_v<TO, float>)
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  else
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The "wg" path (see the note at the top). Grid (slabs, token tiles, S),
// clusters of (1, 1, S): block z (its rank in the cluster) takes stages
// [z * n / S, (z + 1) * n / S) of the n = ceil(K / kWgK). x_map: x (M, K)
// bf16, boxes of 64 k x 128 tokens; q4_map: q4 (K/2, N) bytes, boxes of
// 128 columns x 64 rows; both with 128-byte swizzle. PER_CHANNEL: scale
// is (N,), applied once at the end; else (G, N) with group a multiple of
// kWgK, so each stage lies in one group. GBIAS (grouped only): gbias (G,
// N) zero points, row stride lds.
template <typename TO, bool PER_CHANNEL, bool GBIAS>
__global__ void __launch_bounds__(kWgThreads, 1)
int4_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap q4_map,
                  const float* __restrict__ scale,
                  const float* __restrict__ gbias, TO* __restrict__ out,
                  int M, int K, int N, int group, int lds) {
  static_assert(!(PER_CHANNEL && GBIAS), "zero points need groups");
  extern __shared__ char smem_raw[];
  __shared__ __align__(8) uint64_t full[kWgRing], empty[kWgRing];
  // Per slot: each token's sum of the staged x (GBIAS only).
  __shared__ __align__(8) float xsum[GBIAS ? kWgRing : 1][kWgTokens];
  // The swizzle is a function of the shared address: align the ring.
  char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int S = gridDim.z;
  const int rank = blockIdx.z;
  const int n0 = blockIdx.x * kWgCols;
  const int m0 = blockIdx.y * kWgTokens;
  const int n_stages = (K + kWgK - 1) / kWgK;
  const int st0 = (int)((long long)rank * n_stages / S);
  const int n_mine = (int)((long long)(rank + 1) * n_stages / S) - st0;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kWgRing; ++i) {
      mbar_init(&full[i], 1);                  // the producer's arrival
      mbar_init(&empty[i], 4 * kWgConsumers);  // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kWgConsumers) {
    // The producer: one thread keeps the ring full.
    if (lane == 0) {
      for (int i = 0; i < n_mine; ++i) {
        const int slot = i % kWgRing;
        mbar_wait(&empty[slot], ((i / kWgRing) & 1) ^ 1);
        char* stage = ring + slot * kWgStage;
        const int k0 = (st0 + i) * kWgK;
        mbar_expect_tx(&full[slot], kWgStage);
        tma_load_2d(stage, &x_map, &full[slot], k0, m0);
        tma_load_2d(stage + kWgXHalf, &x_map, &full[slot], k0 + 64, m0);
        tma_load_2d(stage + kWgQ4Off, &q4_map, &full[slot], n0, k0 / 2);
      }
    }
    __syncwarp();
  } else {
    // A consumer warpgroup: columns 64 wg .. 64 wg + 63 of the slab; this
    // lane's are col and col + 1 (MMA rows g and g + 8 of warp w).
    const int wg = warp >> 2;
    const int w = warp & 3;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int col = 64 * wg + 16 * w + 2 * g;
    const int chunk = col >> 4;  // its 16-byte chunk of a 128-byte q4 row
    const int gn = n0 + col;
    const bool col_ok = gn < N;
    float acc[kWgAcc], part[kWgAcc];
#pragma unroll
    for (int i = 0; i < kWgAcc; ++i) acc[i] = part[i] = 0.f;

    for (int i = 0; i < n_mine; ++i) {
      const int slot = i % kWgRing;
      float2 sc = make_float2(0.f, 0.f), zb = make_float2(0.f, 0.f);
      const long long gi = (long long)((st0 + i) * kWgK / group) * lds + gn;
      if (!PER_CHANNEL && col_ok)
        sc = __ldg(reinterpret_cast<const float2*>(scale + gi));
      if (GBIAS && col_ok)
        zb = __ldg(reinterpret_cast<const float2*>(gbias + gi));
      mbar_wait(&full[slot], (i / kWgRing) & 1);
      if constexpr (GBIAS) {
        // Thread tid < 128 sums token row tid of the stage (2 x 128
        // bytes); the barrier publishes the sums to every consumer.
        if (tid < kWgTokens) {
          const char* row = ring + slot * kWgStage + tid * 128;
          float v = 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const uint4 u = *reinterpret_cast<const uint4*>(
                  row + h * kWgXHalf + 16 * c);
              const unsigned int w4[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float2 f = __bfloat1622float2(
                    *reinterpret_cast<const __nv_bfloat162*>(&w4[e]));
                v += f.x + f.y;
              }
            }
          }
          xsum[slot][tid] = v;
        }
        asm volatile("bar.sync 2, %0;" ::"n"(128 * kWgConsumers) : "memory");
      }
      const char* sq = ring + slot * kWgStage + kWgQ4Off;
      // A of step s: packed rows 8 s + t (k pair 2t) and 8 s + t + 4 (k
      // pair 2t + 8), bytes 0 (column col: MMA row g) and 1 (col + 1: row
      // g + 8) of a 2-byte read of the swizzled q4 box.
      uint32_t a[kWgSteps][4];
#pragma unroll
      for (int s = 0; s < kWgSteps; ++s) {
        const int r0 = 8 * s + t;
        const int r1 = r0 + 4;
        const uint32_t u0 = *reinterpret_cast<const uint16_t*>(
            sq + r0 * kWgCols + ((chunk ^ (r0 & 7)) << 4) + 2 * g);
        const uint32_t u1 = *reinterpret_cast<const uint16_t*>(
            sq + r1 * kWgCols + ((chunk ^ (r1 & 7)) << 4) + 2 * g);
        a[s][0] = nibble_pair(u0, u0 >> 4, 0);
        a[s][1] = nibble_pair(u0, u0 >> 4, 1);
        a[s][2] = nibble_pair(u1, u1 >> 4, 0);
        a[s][3] = nibble_pair(u1, u1 >> 4, 1);
      }
      // B of step s: x's 64-k half s / 4, 32 bytes per k16 step in it.
      const uint32_t xs = smem_u32(ring + slot * kWgStage);
      if constexpr (PER_CHANNEL)
        wg_stage(acc, a, xs, true);
      else
        wg_stage(part, a, xs, false);
      if (lane == 0) mbar_arrive(&empty[slot]);  // the slot may refill
      if constexpr (!PER_CHANNEL) {
#pragma unroll
        for (int j = 0; j < kWgAcc / 4; ++j) {
          acc[4 * j] = fmaf(part[4 * j], sc.x, acc[4 * j]);
          acc[4 * j + 1] = fmaf(part[4 * j + 1], sc.x, acc[4 * j + 1]);
          acc[4 * j + 2] = fmaf(part[4 * j + 2], sc.y, acc[4 * j + 2]);
          acc[4 * j + 3] = fmaf(part[4 * j + 3], sc.y, acc[4 * j + 3]);
        }
      }
      if constexpr (GBIAS) {
#pragma unroll
        for (int j = 0; j < kWgAcc / 4; ++j) {
          const float2 xt = *reinterpret_cast<const float2*>(
              &xsum[slot][8 * j + 2 * t]);
          acc[4 * j] = fmaf(xt.x, zb.x, acc[4 * j]);
          acc[4 * j + 1] = fmaf(xt.y, zb.x, acc[4 * j + 1]);
          acc[4 * j + 2] = fmaf(xt.x, zb.y, acc[4 * j + 2]);
          acc[4 * j + 3] = fmaf(xt.y, zb.y, acc[4 * j + 3]);
        }
      }
    }

    // acc[4 j + e]: column col + (e >> 1), token 8 j + 2 t + (e & 1).
    if (S == 1) {
      if (col_ok) {
        float2 ps = make_float2(1.f, 1.f);
        if (PER_CHANNEL)
          ps = __ldg(reinterpret_cast<const float2*>(scale + gn));
#pragma unroll
        for (int j = 0; j < kWgAcc / 4; ++j) {
          const int m = m0 + 8 * j + 2 * t;
          if (m < M)
            store2(out + (long long)m * N + gn, acc[4 * j] * ps.x,
                   acc[4 * j + 2] * ps.y);
          if (m + 1 < M)
            store2(out + (long long)(m + 1) * N + gn, acc[4 * j + 1] * ps.x,
                   acc[4 * j + 3] * ps.y);
        }
      }
    } else {
      // Every consumer is done with the ring: it now holds this block's
      // sums, tot[token][column].
      asm volatile("bar.sync 1, %0;" ::"n"(128 * kWgConsumers) : "memory");
      float* tot = reinterpret_cast<float*>(ring);
#pragma unroll
      for (int j = 0; j < kWgAcc / 4; ++j) {
        const int m = 8 * j + 2 * t;
        *reinterpret_cast<float2*>(tot + m * kWgPitch + col) =
            make_float2(acc[4 * j], acc[4 * j + 2]);
        *reinterpret_cast<float2*>(tot + (m + 1) * kWgPitch + col) =
            make_float2(acc[4 * j + 1], acc[4 * j + 3]);
      }
    }
  }
  if (S == 1) return;

  // Split-K across the cluster: block z sums, in rank order, every
  // block's sums for its 1/S of the tile's tokens, read from their shared
  // memory. The second barrier keeps each block's shared memory alive
  // until every read of it is done.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const float* tot = reinterpret_cast<const float*>(ring);
  const int r0 = rank * kWgTokens / S;
  const int rows = (rank + 1) * kWgTokens / S - r0;
  constexpr int kQuads = kWgCols / 4;
  for (int idx = tid; idx < rows * kQuads; idx += kWgThreads) {
    const int row = r0 + idx / kQuads;
    const int c = 4 * (idx % kQuads);
    const int m = m0 + row;
    const int gn = n0 + c;
    if (m >= M || gn >= N) continue;
    float4 p[kWgMaxCluster];  // all S reads in flight, then summed
#pragma unroll
    for (int r = 0; r < kWgMaxCluster; ++r)
      p[r] = r < S ? *reinterpret_cast<const float4*>(cluster.map_shared_rank(
                         tot + row * kWgPitch + c, r))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 v = p[0];
#pragma unroll
    for (int r = 1; r < kWgMaxCluster; ++r) {
      v.x += p[r].x;
      v.y += p[r].y;
      v.z += p[r].z;
      v.w += p[r].w;
    }
    if (PER_CHANNEL) {
      const float4 s4 = __ldg(reinterpret_cast<const float4*>(scale + gn));
      v.x *= s4.x;
      v.y *= s4.y;
      v.z *= s4.z;
      v.w *= s4.w;
    }
    TO* o = out + (long long)m * N + gn;
    store2(o, v.x, v.y);
    store2(o + 2, v.z, v.w);
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
                   int M, int K, int N, int group, int ldq,
                   int lds) {
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
      if (gr < K2 && gn < N) b = (int)(uint8_t)q4[(long long)gr * ldq + gn];
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
          const float s = gn < N ? scale[(long long)g * lds + gn] : 0.f;
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
                void* out, int M, int K, int N, int group, int ldq, int lds,
                cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  int4_matmul_kernel<T, TO, BM, BN, BK, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
          static_cast<const T*>(x), q4, scale, static_cast<TO*>(out), M, K,
          N, group, ldq, lds);
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
                int n_counters, int M, int K, int N, int group, int ldq,
                int lds, cudaStream_t stream) {
  const bool per_channel = group == K;
  const int tiles = (N + kGemvCols - 1) / kGemvCols;
  if (M > 8 || N % 4 || (!per_channel && group % 2) ||
      reinterpret_cast<uintptr_t>(q4) % 4 || ldq % 4 || tiles > n_counters)
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
        counters, M, K, N, group, ldq, lds, chunk_rows, n_chunks);
  else
    int4_gemv_kernel<T, TO, 8><<<grid, 32 * kGemvWarps, 0, stream>>>(
        static_cast<const T*>(x), q4, scale, static_cast<TO*>(out), ws,
        counters, M, K, N, group, ldq, lds, chunk_rows, n_chunks);
  return (int)cudaGetLastError();
}

// The "tc" path (bf16 x). Needs no scratch: split-K reduces within a
// cluster.
template <typename TO, bool PER_CHANNEL, bool GBIAS>
int launch_mma_kernel(const void* x, const int8_t* q4, const float* scale,
                      const float* gbias, void* out, int M, int K, int N,
                      int group, int ldq, int lds, cudaStream_t stream) {
  auto kernel = int4_mma_kernel<TO, PER_CHANNEL, GBIAS>;
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
                                 scale, gbias, static_cast<TO*>(out), M, K,
                                 N, group, ldq, lds);
}

template <typename TO>
int launch_mma(const void* x, const int8_t* q4, const float* scale,
               const float* gbias, void* out, int M, int K, int N, int group,
               int ldq, int lds, cudaStream_t stream) {
  const bool per_channel = group == K;
  if (M > 8 || K % 16 || N % 16 || (!per_channel && group % kTcK) ||
      reinterpret_cast<uintptr_t>(q4) % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(scale) % 16 ||
      reinterpret_cast<uintptr_t>(gbias) % 16 || ldq % 16 || lds % 4 ||
      (per_channel && gbias != nullptr))
    return (int)cudaErrorInvalidValue;
  if (per_channel)
    return launch_mma_kernel<TO, true, false>(x, q4, scale, gbias, out, M, K,
                                              N, group, ldq, lds, stream);
  if (gbias != nullptr)
    return launch_mma_kernel<TO, false, true>(x, q4, scale, gbias, out, M, K,
                                              N, group, ldq, lds, stream);
  return launch_mma_kernel<TO, false, false>(x, q4, scale, gbias, out, M, K,
                                             N, group, ldq, lds, stream);
}

// cuTensorMapEncodeTiled, reached through the runtime so that the
// library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The map of a row-major (rows, cols) tensor with rows of row_bytes, in
// boxes of (box_rows, box_cols), 128-byte swizzle; reads outside the
// tensor fill the box with zeros.
bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
               unsigned long long rows, unsigned long long cols,
               unsigned long long row_bytes, unsigned int box_rows,
               unsigned int box_cols) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The "wg" path (bf16 x). Needs no scratch: split-K reduces within a
// cluster.
template <typename TO, bool PER_CHANNEL, bool GBIAS>
int launch_wg_kernel(const void* x, const int8_t* q4, const float* scale,
                     const float* gbias, void* out, int M, int K, int N,
                     int group, int ldq, int lds, cudaStream_t stream) {
  auto kernel = int4_wgmma_kernel<TO, PER_CHANNEL, GBIAS>;
  static unsigned int opted_in = 0;  // bit d: device d
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 32) return (int)cudaErrorInvalidDevice;
  if (!(opted_in >> dev & 1u)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in |= 1u << dev;
  }
  const int slabs = (N + kWgCols - 1) / kWgCols;
  const int tiles = (M + kWgTokens - 1) / kWgTokens;
  const int n_stages = (K + kWgK - 1) / kWgK;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap x_map, q4_map;
  if (!encode_2d(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, M, K, 2ull * K,
                 kWgTokens, 64) ||
      !encode_2d(&q4_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, q4, K / 2, N, ldq,
                 kWgRows, kWgCols))
    return (int)cudaErrorInvalidValue;
  // S blocks per tile (one block per SM): 1 once the tiles fill a wave;
  // else the S that minimises waves x stages per block (ties: the
  // smaller), each block keeping at least 2 stages.
  const int sms = sm_count();
  const long long blocks = (long long)slabs * tiles;
  int S = 1;
  if (blocks < sms) {
    long long best = n_stages;
    for (int s = 2; s <= kWgMaxCluster && s <= n_stages / 2; ++s) {
      const long long cost =
          (blocks * s + sms - 1) / sms * ((n_stages + s - 1) / s);
      if (cost < best) {
        best = cost;
        S = s;
      }
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(slabs, tiles, S);
  cfg.blockDim = dim3(kWgThreads);
  cfg.dynamicSmemBytes = kWgSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = S;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, x_map, q4_map, scale, gbias,
                                 static_cast<TO*>(out), M, K, N, group, lds);
}

// TMA needs 16-byte aligned tensors and row strides (K % 8, N % 16); k16
// steps tile K and a group is whole stages.
template <typename TO>
int launch_wg(const void* x, const int8_t* q4, const float* scale,
              const float* gbias, void* out, int M, int K, int N, int group,
              int ldq, int lds, cudaStream_t stream) {
  const bool per_channel = group == K;
  if (K % 16 || N % 16 || (!per_channel && group % kWgK) ||
      reinterpret_cast<uintptr_t>(q4) % 16 ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(scale) % 16 ||
      reinterpret_cast<uintptr_t>(gbias) % 8 || ldq % 16 || lds % 4 ||
      (per_channel && gbias != nullptr))
    return (int)cudaErrorInvalidValue;
  if (per_channel)
    return launch_wg_kernel<TO, true, false>(x, q4, scale, gbias, out, M, K,
                                             N, group, ldq, lds, stream);
  if (gbias != nullptr)
    return launch_wg_kernel<TO, false, true>(x, q4, scale, gbias, out, M, K,
                                             N, group, ldq, lds, stream);
  return launch_wg_kernel<TO, false, false>(x, q4, scale, gbias, out, M, K,
                                            N, group, ldq, lds, stream);
}

// Path codes, as ops/int4_matmul.py passes them.
constexpr int kPathTc = 0;
constexpr int kPathGemv = 1;
constexpr int kPathTile = 2;
constexpr int kPathWg = 3;

template <typename T, typename TO>
int launch(int path, const void* x, const int8_t* q4, const float* scale,
           const float* gbias, void* out, float* ws, long long ws_floats,
           int* counters, int n_counters, int M, int K, int N, int group,
           int ldq, int lds, cudaStream_t stream) {
  // Zero points are applied on the tensor-core paths only.
  if (gbias != nullptr && path != kPathTc && path != kPathWg)
    return (int)cudaErrorInvalidValue;
  switch (path) {
    case kPathTc:
      if constexpr (std::is_same_v<T, __nv_bfloat16>)
        return launch_mma<TO>(x, q4, scale, gbias, out, M, K, N, group, ldq,
                              lds, stream);
      return (int)cudaErrorInvalidValue;  // tensor cores take bf16 x only
    case kPathGemv:
      return launch_gemv<T, TO>(x, q4, scale, out, ws, ws_floats, counters,
                                n_counters, M, K, N, group, ldq, lds,
                                stream);
    case kPathTile:
      return launch_tile<T, TO, 64, 64, 32, 4, 4>(x, q4, scale, out, M, K,
                                                 N, group, ldq, lds, stream);
    case kPathWg:
      if constexpr (std::is_same_v<T, __nv_bfloat16>)
        return launch_wg<TO>(x, q4, scale, gbias, out, M, K, N, group, ldq,
                             lds, stream);
      return (int)cudaErrorInvalidValue;  // tensor cores take bf16 x only
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// path: 0 = "tc", 1 = "gemv", 2 = "tile", 3 = "wg" (see the note at the
// top); a path that does not take the shape or dtype returns
// cudaErrorInvalidValue and launches nothing. x_dtype, out_dtype: 0 =
// bfloat16, 1 = float32. scale is (K / group, N) float32 (group = K: per
// channel); gbias is null or GPTQ zero points of the grouped scales'
// shape and row stride ("tc" and "wg" only). ws (ws_floats fp32) and
// counters (n_counters ints, all 0) are the "gemv" path's split-K
// scratch, owned by the caller and left as found; the other paths ignore
// them. ldq and lds are the row strides
// of q4 (bytes) and of grouped scales (floats), at least N: a column
// slice of a wider weight (an lm_head vocab tile) is read in place. The
// tensor-core paths need both 16-byte aligned (ldq % 16, lds % 4), the
// "gemv" path ldq % 4. The caller (ops/int4_matmul.py) validates shapes,
// dtypes, strides and the 32-bit offset limit. Returns
// cudaGetLastError() after the launch.
extern "C" int int4_matmul(int path, int x_dtype, int out_dtype,
                           const void* x, const void* q4, const void* scale,
                           const void* gbias, void* out, void* ws,
                           long long ws_floats, void* counters,
                           int n_counters, int M, int K, int N, int group,
                           int ldq, int lds, void* stream) {
  if (M < 1 || K < 2 || K % 2 || N < 1 || group < 1 || K % group ||
      ldq < N || (group < K && lds < N))
    return (int)cudaErrorInvalidValue;
  const int8_t* q = static_cast<const int8_t*>(q4);
  const float* s = static_cast<const float*>(scale);
  const float* z = static_cast<const float*>(gbias);
  float* w = static_cast<float*>(ws);
  int* c = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype * 2 + out_dtype) {
    case 0:
      return launch<__nv_bfloat16, __nv_bfloat16>(
          path, x, q, s, z, out, w, ws_floats, c, n_counters, M, K, N, group,
          ldq, lds, st);
    case 1:
      return launch<__nv_bfloat16, float>(
          path, x, q, s, z, out, w, ws_floats, c, n_counters, M, K, N, group,
          ldq, lds, st);
    case 2:
      return launch<float, __nv_bfloat16>(
          path, x, q, s, z, out, w, ws_floats, c, n_counters, M, K, N, group,
          ldq, lds, st);
    case 3:
      return launch<float, float>(
          path, x, q, s, z, out, w, ws_floats, c, n_counters, M, K, N, group,
          ldq, lds, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
