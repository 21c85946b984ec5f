// Paged GQA decode attention with the in-place KV append, for Hopper
// (built for sm_90a by kernels/build.py; plain C interface, loaded with
// ctypes by ops/paged_attention.py).
//
// Replaces: generativeaiexamples_tpu/ops/paged_attention.py
// `paged_attention_decode` (the bf16/f32-pool pallas_call). One query
// token per slot attends over ceil(len/page) pages of a shared pool
// (L, N, KV, page, hd) through its block table, folds the current token's
// K/V in exactly (it is not in the pool yet), scales by 1/sqrt(hd), and
// writes the current K/V row at (layer, write_page, kv_head, write_offset).
//
// What bounds it: device-memory bytes. Each live K/V row is read once and
// used for G = H/KV query heads (G = 1 for llama-2-7b), so the work is a
// few flops per byte, two orders of magnitude below the card's
// flop-per-byte balance point.
//
// What the design does about it: one block per (slot, kv_head) reads only
// that slot's live rows (never the padding of its last page, never a
// dead slot's pages), each row exactly once; four warps split the rows
// and keep four rows' loads in flight each, accumulating an fp32 online
// softmax in registers; the warps' partial states merge through shared
// memory once at the end. Slot groups, the DMA ring and 8-row tile
// staging of the TPU kernel are TPU details and are not carried over.
// Work not done yet (later PRs): split-K over pages for long contexts,
// TMA/cp.async page streaming, vectorised 16-byte loads.
//
// Invariants the launch relies on:
// - Pool offsets are 64-bit: a 7B pool of ~9k tokens holds ~1.2e9
//   elements per K/V tensor, close to 2^31.
// - Reads and the append are disjoint: attention reads rows < len; the
//   appended row is row len of the slot (the engine passes write_page =
//   table[len / page], write_offset = len % page), so no block's append
//   races another block's reads within a launch.
// - Inactive slots arrive with len = 0, write_page = 0, write_offset = 0:
//   they read nothing, their output is exactly cur_v, and several of them
//   may write page 0 (the trash page) at once. That race is harmless only
//   because no live slot's table ever points at page 0.
// - The block table may be a column slice of a wider table: rows are
//   `tbl_stride` elements apart.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 4;        // rows each warp keeps in flight
constexpr float kNeg = -1e30f;  // the reference's masking constant, fp32

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// DPL: head-dim elements per lane (hd <= 32 * DPL); lane owns d = lane +
// 32 * i. MAXG: register capacity for the G query heads of one kv head.
template <typename T, int DPL, int MAXG>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, T* pool_k, T* pool_v,
                    const int* __restrict__ table, long long tbl_stride,
                    const int* __restrict__ lengths,
                    const T* __restrict__ cur_k, const T* __restrict__ cur_v,
                    const int* __restrict__ write_page,
                    const int* __restrict__ write_offset,
                    T* __restrict__ out, int layer, int n_pages, int KV,
                    int G, int page, int hd, float scale) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int H = KV * G;

  extern __shared__ float smem[];
  float* acc_s = smem;                   // [kWarps][G][hd]
  float* m_s = acc_s + kWarps * G * hd;  // [kWarps][G]
  float* l_s = m_s + kWarps * G;         // [kWarps][G]
  float* scur_s = l_s + kWarps * G;      // [G]

  // This kv head's G query rows (q viewed as (B, KV, G, hd)).
  float qf[MAXG][DPL];
  const T* qb = q + ((long long)b * H + (long long)kvh * G) * hd;
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      qf[g][i] = (g < G && d < hd) ? to_float(qb[g * hd + d]) : 0.f;
    }
  }

  const int len = lengths[b];
  const long long head_stride = (long long)page * hd;
  const long long page_stride = (long long)KV * head_stride;
  const long long layer_base = (long long)layer * n_pages * page_stride;
  const int* tbl = table + (long long)b * tbl_stride;

  float m[MAXG], l[MAXG], acc[MAXG][DPL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  }

  for (int t0 = warp * kRows; t0 < len; t0 += kWarps * kRows) {
    float kf[kRows][DPL], vf[kRows][DPL];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int t = t0 + r;
      const bool live = t < len;
      long long base = 0;
      if (live) {
        base = layer_base + (long long)tbl[t / page] * page_stride +
               (long long)kvh * head_stride + (long long)(t % page) * hd;
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        const bool ok = live && d < hd;
        kf[r][i] = ok ? to_float(pool_k[base + d]) : 0.f;
        vf[r][i] = ok ? to_float(pool_v[base + d]) : 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        float s[kRows];
        float mx = m[g];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float part = 0.f;
#pragma unroll
          for (int i = 0; i < DPL; ++i) part = fmaf(qf[g][i], kf[r][i], part);
          s[r] = warp_sum(part) * scale;
          if (t0 + r < len) mx = fmaxf(mx, s[r]);
        }
        const float alpha = expf(m[g] - mx);
        float p[kRows];
        float psum = 0.f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          p[r] = (t0 + r < len) ? expf(s[r] - mx) : 0.f;
          psum += p[r];
        }
        l[g] = l[g] * alpha + psum;
        m[g] = mx;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          float a = acc[g][i] * alpha;
#pragma unroll
          for (int r = 0; r < kRows; ++r) a = fmaf(p[r], vf[r][i], a);
          acc[g][i] = a;
        }
      }
    }
  }

  // Publish each warp's partial softmax state.
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G) {
      if (lane == 0) {
        m_s[warp * G + g] = m[g];
        l_s[warp * G + g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) acc_s[(warp * G + g) * hd + d] = acc[g][i];
      }
    }
  }
  // The current token's score per query head.
  const long long cur_off = ((long long)b * KV + kvh) * hd;
  if (warp == 0) {
    float ck[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      ck[i] = d < hd ? to_float(cur_k[cur_off + d]) : 0.f;
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) part = fmaf(qf[g][i], ck[i], part);
        const float s = warp_sum(part) * scale;
        if (lane == 0) scur_s[g] = s;
      }
    }
  }
  __syncthreads();

  // Merge the warps, then fold the current token in exactly as the TPU
  // kernel's epilogue does: m2, a, bta, (acc*a + cv*bta) / (l*a + bta).
  for (int idx = threadIdx.x; idx < G * hd; idx += kThreads) {
    const int g = idx / hd;
    const int d = idx - g * hd;
    float mm = kNeg;
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, m_s[w * G + g]);
    float ll = 0.f, aa = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(m_s[w * G + g] - mm);
      ll = fmaf(l_s[w * G + g], e, ll);
      aa = fmaf(acc_s[(w * G + g) * hd + d], e, aa);
    }
    const float s_cur = scur_s[g];
    const float m2 = fmaxf(mm, s_cur);
    const float a = expf(mm - m2);
    const float bta = expf(s_cur - m2);
    const float cv = to_float(cur_v[cur_off + d]);
    out[((long long)b * H + (long long)kvh * G + g) * hd + d] =
        from_float<T>((aa * a + cv * bta) / (ll * a + bta));
  }

  // Append: exactly one row per (slot, kv head), a bit copy of cur_k/cur_v.
  const long long dst = layer_base +
                        (long long)write_page[b] * page_stride +
                        (long long)kvh * head_stride +
                        (long long)write_offset[b] * hd;
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    pool_k[dst + d] = cur_k[cur_off + d];
    pool_v[dst + d] = cur_v[cur_off + d];
  }
}

struct Args {
  const void* q;
  void* pool_k;
  void* pool_v;
  const int* table;
  long long tbl_stride;
  const int* lengths;
  const void* cur_k;
  const void* cur_v;
  const int* write_page;
  const int* write_offset;
  void* out;
  int B, KV, G, hd, n_pages, page, layer;
  float scale;
  cudaStream_t stream;
};

template <typename T, int DPL, int MAXG>
int launch(const Args& a) {
  const dim3 grid(a.B, a.KV);
  const size_t smem =
      sizeof(float) * ((size_t)kWarps * a.G * a.hd + 2 * kWarps * a.G + a.G);
  paged_decode_kernel<T, DPL, MAXG><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<T*>(a.pool_k),
      static_cast<T*>(a.pool_v), a.table, a.tbl_stride, a.lengths,
      static_cast<const T*>(a.cur_k), static_cast<const T*>(a.cur_v),
      a.write_page, a.write_offset, static_cast<T*>(a.out), a.layer,
      a.n_pages, a.KV, a.G, a.page, a.hd, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int DPL>
int launch_g(const Args& a) {
  return a.G == 1 ? launch<T, DPL, 1>(a) : launch<T, DPL, 8>(a);
}

template <typename T>
int launch_d(const Args& a) {
  if (a.hd <= 32) return launch_g<T, 1>(a);
  if (a.hd <= 64) return launch_g<T, 2>(a);
  if (a.hd <= 128) return launch_g<T, 4>(a);
  return launch_g<T, 8>(a);
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32 (q, pools, cur_k/cur_v and out share
// it). The caller (ops/paged_attention.py) validates shapes, dtypes,
// contiguity and the gate 1 <= hd <= 256, H % KV == 0, 1 <= G <= 8,
// page >= 1, B >= 1. Returns cudaGetLastError() after the launch.
extern "C" int paged_attention_decode(
    int dtype, const void* q, void* pool_k, void* pool_v, const void* table,
    long long tbl_stride, const void* lengths, const void* cur_k,
    const void* cur_v, const void* write_page, const void* write_offset,
    void* out, int B, int KV, int G, int hd, int n_pages, int page,
    int layer, float scale, void* stream) {
  if (B < 1 || KV < 1 || G < 1 || G > 8 || hd < 1 || hd > 256 || page < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{q, pool_k, pool_v, static_cast<const int*>(table),
               tbl_stride, static_cast<const int*>(lengths), cur_k, cur_v,
               static_cast<const int*>(write_page),
               static_cast<const int*>(write_offset), out, B, KV, G, hd,
               n_pages, page, layer, scale,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return launch_d<__nv_bfloat16>(a);
    case 1: return launch_d<float>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}
