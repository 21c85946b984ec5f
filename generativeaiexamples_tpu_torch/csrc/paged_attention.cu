// Paged GQA decode attention with the in-place KV append, for Hopper
// (built for sm_90a by kernels/build.py; plain C interface, loaded with
// ctypes by ops/paged_attention.py). Two entry points share one pair of
// kernel templates: full-precision pools, and int8 pools with bf16
// per-row scales.
//
// Replaces: generativeaiexamples_tpu/ops/paged_attention.py
// `paged_attention_decode` (the bf16/f32-pool pallas_call) and
// `_paged_attention_decode_quant` (the int8-KV pallas_call). One query
// token per slot attends over ceil(len/page) pages of a shared pool
// (L, N, KV, page, hd) through its block table, folds the current token's
// K/V in exactly (it is not in the pool yet), scales by 1/sqrt(hd), and
// writes the current K/V row at (layer, write_page, kv_head, write_offset).
// Under int8 pools each row has one bf16 scale in (L, N, KV, page) pools:
// K scales fold into the scores after q.k, V scales into the
// probabilities before p.v, and the append quantizes the current row the
// way ops/kv_quant.py `quantize_rows` does (amax over hd, the scale
// rounded to bf16 before the divide, round half to even, clip to 127),
// writing its int8 row and its one scale.
//
// What bounds it: device-memory bytes. Each live K/V row is read once and
// used for G = H/KV query heads (G = 1 for llama-2-7b), so the work is a
// few flops per byte, two orders of magnitude below the card's
// flop-per-byte balance point. int8 pools halve the row bytes. To reach
// the memory rate the card needs many SMs streaming at once, each with
// many bytes in flight.
//
// What the design does about it ("flash-decoding"), in two launches:
// - Split pass, one block per (split s, kv head, slot): rows
//   [s*R, min((s+1)*R, len)) of one (slot, kv head). R (a multiple of
//   page, >= 256 rows: at the 7B shapes fewer, fuller splits beat 128-row
//   ones, whose dead blocks and fixed per-block costs weigh more) and the
//   split count S come from static shapes in the wrapper, so a launch
//   never waits on the host for `lengths`; a block whose rows start at or
//   past its slot's length exits at once. A long slot thus spreads over
//   ceil(len/R) blocks on as many SMs instead of one block walking it
//   serially.
// - Each lane loads 16 bytes of a row per instruction (an int8 row of
//   128 is 8 lanes, bf16 16 lanes, float32 32), so a warp reads 512
//   contiguous bytes per load of one (page, kv head) slab. Each lane
//   issues its K and V loads for RIF rows before any arithmetic; the
//   lanes of a row reduce their partial q.k with log2(lanes per row)
//   shuffles; int8 rows load their two scales once per row. A row whose
//   length does not allow 16-byte loads (hd * elem not a multiple of 16,
//   or a pool base off 16 bytes) takes a narrower load in the same
//   template. Each row group keeps an fp32 online softmax (m, l, acc) in
//   registers; a block merges its row groups by shuffles and its warps in
//   shared memory, and writes one state per query head to an fp32
//   scratch (B, S, KV, G, hd + 2): [acc[0..hd), m, l].
// - Merge pass, one block per (kv head, slot): merges the live splits
//   (s < ceil(len/R)) in split order, so the result is deterministic,
//   folds the current token in with the TPU kernel's epilogue (m2, a,
//   bta, (acc*a + cv*bta) / (l*a + bta)), writes `out`, and then appends
//   the current row. It never reads a dead split's scratch. It is a
//   programmatic dependent launch: its blocks may start under the split
//   pass's last blocks, compute the current token's scores and the
//   appended row (quantized under int8 pools) before griddepcontrol.wait,
//   and read the scratch and write only after it.
// Tensor cores, TMA and bulk page copies are not used: G <= 8 query rows
// per kv head make these GEMVs. Slot groups, the DMA ring and 8-row tile
// staging of the TPU kernel are TPU details and are not carried over; so
// is its write-back of a whole (KV, page) scale block (a lane-DMA rule):
// this kernel writes the appended row's scale and no other scale byte.
// Rows and scales at or past a length are never loaded (masked rows are
// skipped, never multiplied by 0: poisoned NaN rows stay out of the sum).
//
// Invariants the launches rely on:
// - Pool offsets are 64-bit: a 7B pool of ~9k tokens holds ~1.2e9
//   elements per K/V tensor, close to 2^31.
// - Reads and the append are disjoint: attention reads rows < len; the
//   appended row is row len of the slot (the engine passes write_page =
//   table[len / page], write_offset = len % page). The append runs in the
//   merge pass, after every read of the split pass in stream order, so
//   the split pass may use read-only (ld.global.nc) loads.
// - Inactive slots arrive with len = 0, write_page = 0, write_offset = 0:
//   they have no live split, their output is exactly cur_v, and several
//   of them may write page 0 (the trash page) at once. That race is
//   harmless only because no live slot's table ever points at page 0.
// - The block table may be a column slice of a wider table: rows are
//   `tbl_stride` elements apart.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxGroup = 8;    // query heads per kv head (the gate)
constexpr int kMaxHeadDim = 256;
constexpr float kNeg = -1e30f;  // the reference's masking constant, fp32
constexpr float kQmax = 127.f;  // ops/kv_quant.py QMAX

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over an aligned group of `width` lanes (a power of two <= 32).
// Every lane of the group ends with the same bits (a butterfly of
// commutative adds).
__device__ __forceinline__ float group_sum(float v, int width) {
  for (int o = width >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// VEC consecutive pool elements as loaded: raw 32-bit words.
template <typename P, int VEC>
struct Chunk {
  static constexpr int kBytes = VEC * (int)sizeof(P);
  static constexpr int kWords = kBytes >= 4 ? kBytes / 4 : 1;
  uint32_t w[kWords];
};

// One read-only load of VEC pool elements (16, 8, 4, 2 or 1 bytes; the
// caller keeps the address aligned to its width).
template <typename P, int VEC>
__device__ __forceinline__ void load_chunk(const P* p, Chunk<P, VEC>& c) {
  constexpr int kBytes = Chunk<P, VEC>::kBytes;
  if constexpr (kBytes == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    c.w[0] = u.x;
    c.w[1] = u.y;
    c.w[2] = u.z;
    c.w[3] = u.w;
  } else if constexpr (kBytes == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    c.w[0] = u.x;
    c.w[1] = u.y;
  } else if constexpr (kBytes == 4) {
    c.w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (kBytes == 2) {
    c.w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else {
    c.w[0] = __ldg(reinterpret_cast<const unsigned char*>(p));
  }
}

template <typename P, int VEC>
__device__ __forceinline__ void zero_chunk(Chunk<P, VEC>& c) {
#pragma unroll
  for (int i = 0; i < Chunk<P, VEC>::kWords; ++i) c.w[i] = 0u;
}

// Element v of a chunk as float (exact for every pool type; little-endian
// words, element 0 in the low bits). An int8 x becomes x + 128 in the low
// byte of 2^23's float bits (one byte permute), minus 2^23 + 128 (one
// add): the FP32 pipe instead of the 16-per-clock conversion unit.
template <typename P, int VEC>
__device__ __forceinline__ float chunk_elem(const Chunk<P, VEC>& c, int v) {
  if constexpr (std::is_same<P, float>::value) {
    return __uint_as_float(c.w[v]);
  } else if constexpr (std::is_same<P, __nv_bfloat16>::value) {
    const uint32_t w = c.w[v >> 1];
    return __uint_as_float((v & 1) ? (w & 0xffff0000u) : (w << 16));
  } else {
    const uint32_t biased = c.w[v >> 2] ^ 0x80808080u;
    return __uint_as_float(
               __byte_perm(biased, 0x4B000000u, 0x7440u | (v & 3))) -
           8388736.f;
  }
}

// Split pass (see the note at the top). T: q's dtype. P: pool element (T,
// or int8_t with bf16 row scales in pool_ks/pool_vs). VEC: pool elements
// per load. A row of hd elements is cpr = hd / VEC chunks over lpr lanes
// (the power of two >= cpr, at most 32); lane lr of a row owns chunks
// c * lpr + lr, c < NCH, so d = (c * lpr + lr) * VEC + v. A warp holds
// 32 / lpr row groups, one row each per load. MAXG: register capacity for
// the G query heads of one kv head.
template <typename T, typename P, int VEC, int MAXG>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const T* __restrict__ q,
                          const P* __restrict__ pool_k,
                          const P* __restrict__ pool_v,
                          const __nv_bfloat16* __restrict__ pool_ks,
                          const __nv_bfloat16* __restrict__ pool_vs,
                          const int* __restrict__ table, long long tbl_stride,
                          const int* __restrict__ lengths,
                          float* __restrict__ scratch, int layer, int n_pages,
                          int KV, int G, int page, int hd, int R,
                          float scale) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  // Chunks per lane: 8 elements a lane covers hd = 256 for narrow loads.
  constexpr int NCH = VEC >= 8 ? 1 : 8 / VEC;
  constexpr int kE = VEC * NCH;            // elements a lane may own
  // Rows in flight per row group: 32 elements of K and 32 of V a lane
  // at G = 1 (4 bf16 or 2 int8 rows of 16 bytes), 2 rows at G up to 8.
  constexpr int RIF = MAXG == 1 ? 32 / kE : 2;
  const int s = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int len = lengths[b];
  const int row0 = s * R;
  if (row0 >= len) return;  // a dead split: nothing to read or write
  const int row1 = min(row0 + R, len);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int cpr = hd / VEC;
  int lpr = 1;
  while (lpr < cpr && lpr < 32) lpr <<= 1;
  const int rpw = 32 / lpr;       // row groups per warp
  const int nrg = kWarps * rpw;   // row groups per block
  const int lr = lane & (lpr - 1);
  const int rg = warp * rpw + lane / lpr;
  const int H = KV * G;

  // This lane's slice of the kv head's G query rows.
  float qf[MAXG][kE];
  const T* qb = q + ((long long)b * H + (long long)kvh * G) * hd;
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int ci = c * lpr + lr;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        qf[g][c * VEC + v] = (g < G && ci < cpr)
                                 ? to_float(qb[g * hd + ci * VEC + v])
                                 : 0.f;
      }
    }
  }

  // Row index of (layer, page pg, kvh, r) = ((layer * N + pg) * KV + kvh)
  // * page + r; a row's elements start at row * hd, its scale at row.
  const long long layer_rows = (long long)layer * n_pages * KV;
  const int* tbl = table + (long long)b * tbl_stride;

  float m[MAXG], l[MAXG], acc[MAXG][kE];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[g][e] = 0.f;
  }

  // Block-uniform trip count: every lane runs every iteration, so the
  // shuffles below always see the whole warp.
  for (int base = row0; base < row1; base += nrg * RIF) {
    Chunk<P, VEC> kc[RIF][NCH], vc[RIF][NCH];
    float ksc[RIF], vsc[RIF];  // row scales (int8 pools)
    bool live[RIF];
#pragma unroll
    for (int i = 0; i < RIF; ++i) {
      const int t = base + i * nrg + rg;
      live[i] = t < row1;
      long long row = 0;
      if (live[i]) {
        row = (layer_rows + (long long)__ldg(tbl + t / page) * KV + kvh) *
                  page + t % page;
      }
      const P* kp = pool_k + row * hd;
      const P* vp = pool_v + row * hd;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int ci = c * lpr + lr;
        if (live[i] && ci < cpr) {
          load_chunk<P, VEC>(kp + ci * VEC, kc[i][c]);
          load_chunk<P, VEC>(vp + ci * VEC, vc[i][c]);
        } else {
          zero_chunk<P, VEC>(kc[i][c]);
          zero_chunk<P, VEC>(vc[i][c]);
        }
      }
      if constexpr (kQuant) {
        ksc[i] = live[i] ? __bfloat162float(__ldg(pool_ks + row)) : 0.f;
        vsc[i] = live[i] ? __bfloat162float(__ldg(pool_vs + row)) : 0.f;
      } else {
        ksc[i] = 1.f;
        vsc[i] = 1.f;
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        float sc[RIF];
        float mx = m[g];
#pragma unroll
        for (int i = 0; i < RIF; ++i) {
          float part = 0.f;
#pragma unroll
          for (int c = 0; c < NCH; ++c) {
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              part = fmaf(qf[g][c * VEC + v], chunk_elem<P, VEC>(kc[i][c], v),
                          part);
          }
          part = group_sum(part, lpr);
          sc[i] = kQuant ? part * ksc[i] * scale : part * scale;
          if (live[i]) mx = fmaxf(mx, sc[i]);
        }
        const float alpha = expf(m[g] - mx);
        float p[RIF];
        float psum = 0.f;
#pragma unroll
        for (int i = 0; i < RIF; ++i) {
          p[i] = live[i] ? expf(sc[i] - mx) : 0.f;
          psum += p[i];
        }
        l[g] = l[g] * alpha + psum;
        m[g] = mx;
        if constexpr (kQuant) {
#pragma unroll
          for (int i = 0; i < RIF; ++i) p[i] *= vsc[i];
        }
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            float a = acc[g][c * VEC + v] * alpha;
#pragma unroll
            for (int i = 0; i < RIF; ++i)
              a = fmaf(p[i], chunk_elem<P, VEC>(vc[i][c], v), a);
            acc[g][c * VEC + v] = a;
          }
        }
      }
    }
  }

  // Merge the warp's row groups (lanes lpr, 2 lpr, ... apart). A row
  // group that saw no row holds m = kNeg, l = 0, acc = 0 and weighs 0.
  for (int o = lpr; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
        const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
        const float mn = fmaxf(m[g], mo);
        const float a = expf(m[g] - mn);
        const float bo = expf(mo - mn);
        l[g] = l[g] * a + lo * bo;
        m[g] = mn;
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const float other = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
          acc[g][e] = acc[g][e] * a + other * bo;
        }
      }
    }
  }

  // The merge pass may launch once every block is here or gone; it waits
  // for this grid to finish before it reads the scratch.
  asm volatile("griddepcontrol.launch_dependents;");

  // Merge the warps through shared memory (row group 0 of each warp
  // publishes), then write the block's state per query head.
  extern __shared__ float smem[];
  float* acc_s = smem;                   // [kWarps][G][hd]
  float* m_s = acc_s + kWarps * G * hd;  // [kWarps][G]
  float* l_s = m_s + kWarps * G;         // [kWarps][G]
  if (lane < lpr) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        if (lane == 0) {
          m_s[warp * G + g] = m[g];
          l_s[warp * G + g] = l[g];
        }
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const int ci = c * lpr + lr;
          if (ci < cpr) {
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              acc_s[(warp * G + g) * hd + ci * VEC + v] = acc[g][c * VEC + v];
          }
        }
      }
    }
  }
  __syncthreads();
  float* dst =
      scratch + (((long long)b * gridDim.x + s) * KV + kvh) * G * (hd + 2);
  for (int idx = threadIdx.x; idx < G * (hd + 2); idx += kThreads) {
    const int g = idx / (hd + 2);
    const int d = idx - g * (hd + 2);
    float mm = kNeg;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, m_s[w * G + g]);
    if (d == hd) {
      dst[idx] = mm;
      continue;
    }
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float x = d < hd ? acc_s[(w * G + g) * hd + d] : l_s[w * G + g];
      sum = fmaf(x, expf(m_s[w * G + g] - mm), sum);
    }
    dst[idx] = sum;
  }
}

// Merge pass (see the note at the top): one block per (kv head, slot).
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
paged_decode_merge_kernel(const T* __restrict__ q, P* pool_k, P* pool_v,
                          __nv_bfloat16* pool_ks, __nv_bfloat16* pool_vs,
                          const int* __restrict__ lengths,
                          const T* __restrict__ cur_k,
                          const T* __restrict__ cur_v,
                          const int* __restrict__ write_page,
                          const int* __restrict__ write_offset,
                          const float* __restrict__ scratch,
                          T* __restrict__ out, int layer, int n_pages, int S,
                          int KV, int G, int page, int hd, int R,
                          float scale) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  constexpr int kPerLane = kMaxHeadDim / 32;
  constexpr int kPerThread = kMaxHeadDim / kThreads;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int H = KV * G;
  const int len = lengths[b];
  const int live = min((len + R - 1) / R, S);

  // Before the wait, everything that does not read the scratch: the
  // current token's score per query head, and the appended row (under
  // int8 pools quantized as quantize_rows does: warp 0 the K row, warp 1
  // the V row).
  __shared__ float scur_s[kMaxGroup];
  const long long cur_off = ((long long)b * KV + kvh) * hd;
  const T* qb = q + ((long long)b * H + (long long)kvh * G) * hd;
  for (int g = warp; g < G; g += kWarps) {
    float part = 0.f;
    for (int d = lane; d < hd; d += 32)
      part = fmaf(to_float(qb[g * hd + d]), to_float(cur_k[cur_off + d]),
                  part);
    part = warp_sum(part) * scale;
    if (lane == 0) scur_s[g] = part;
  }
  const long long dst_row =
      ((long long)layer * n_pages * KV + (long long)write_page[b] * KV +
       kvh) * page + write_offset[b];
  const long long dst = dst_row * hd;
  float row[kQuant ? kPerLane : 2 * kPerThread];
  __nv_bfloat16 row_scale = __float2bfloat16(0.f);
  if constexpr (kQuant) {
    if (warp < 2) {
      const T* src = (warp == 0 ? cur_k : cur_v) + cur_off;
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int d = lane + 32 * i;
        row[i] = d < hd ? to_float(src[d]) : 0.f;
        amax = fmaxf(amax, fabsf(row[i]));
      }
      amax = warp_max(amax);
      row_scale = __float2bfloat16(fmaxf(amax, 1e-8f) / kQmax);
      const float sf = __bfloat162float(row_scale);
#pragma unroll
      for (int i = 0; i < kPerLane; ++i)
        row[i] = fminf(fmaxf(rintf(row[i] / sf), -kQmax), kQmax);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int d = threadIdx.x + kThreads * i;
      row[2 * i] = d < hd ? to_float(cur_k[cur_off + d]) : 0.f;
      row[2 * i + 1] = d < hd ? to_float(cur_v[cur_off + d]) : 0.f;
    }
  }
  __syncthreads();
  // Launched programmatically: everything above overlaps the split
  // pass's tail; its scratch is complete and visible after this.
  asm volatile("griddepcontrol.wait;" ::: "memory");

  // Merge the live splits in split order (an online max, so each split's
  // state is read once; the unrolled loop keeps several splits' loads in
  // flight), then fold the current token in exactly as the TPU kernel's
  // epilogue does. No live split: mm = kNeg, ll = aa = 0, so the output
  // is exactly cur_v.
  const long long split_stride = (long long)KV * G * (hd + 2);
  const float* src = scratch + ((long long)b * S * KV + kvh) * G * (hd + 2);
  for (int idx = threadIdx.x; idx < G * hd; idx += kThreads) {
    const int g = idx / hd;
    const int d = idx - g * hd;
    const float* st = src + g * (hd + 2);
    float mm = kNeg, ll = 0.f, aa = 0.f;
#pragma unroll 4
    for (int sp = 0; sp < live; ++sp) {
      const float* x = st + sp * split_stride;
      const float ms = x[hd];
      const float mn = fmaxf(mm, ms);
      const float ea = expf(mm - mn);
      const float eb = expf(ms - mn);
      ll = ll * ea + x[hd + 1] * eb;
      aa = aa * ea + x[d] * eb;
      mm = mn;
    }
    const float s_cur = scur_s[g];
    const float m2 = fmaxf(mm, s_cur);
    const float a = expf(mm - m2);
    const float bta = expf(s_cur - m2);
    const float cv = to_float(cur_v[cur_off + d]);
    out[((long long)b * H + (long long)kvh * G + g) * hd + d] =
        from_float<T>((aa * a + cv * bta) / (ll * a + bta));
  }

  // Append exactly one row per (slot, kv head), after every read of the
  // split pass.
  if constexpr (kQuant) {
    if (warp < 2) {
      P* pool = warp == 0 ? pool_k : pool_v;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) pool[dst + d] = (int8_t)row[i];
      }
      if (lane == 0) (warp == 0 ? pool_ks : pool_vs)[dst_row] = row_scale;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int d = threadIdx.x + kThreads * i;
      if (d < hd) {
        pool_k[dst + d] = from_float<P>(row[2 * i]);
        pool_v[dst + d] = from_float<P>(row[2 * i + 1]);
      }
    }
  }
}

struct Args {
  const void* q;
  void* pool_k;
  void* pool_v;
  void* pool_ks;  // int8 pools only
  void* pool_vs;
  const int* table;
  long long tbl_stride;
  const int* lengths;
  const void* cur_k;
  const void* cur_v;
  const int* write_page;
  const int* write_offset;
  void* out;
  float* scratch;
  int B, KV, G, hd, n_pages, page, layer, R, S;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename P, int VEC, int MAXG>
int launch(const Args& a) {
  const dim3 split_grid(a.S, a.KV, a.B);
  const size_t smem =
      sizeof(float) * ((size_t)kWarps * a.G * a.hd + 2 * kWarps * a.G);
  paged_decode_split_kernel<T, P, VEC, MAXG>
      <<<split_grid, kThreads, smem, a.stream>>>(
          static_cast<const T*>(a.q), static_cast<const P*>(a.pool_k),
          static_cast<const P*>(a.pool_v),
          static_cast<const __nv_bfloat16*>(a.pool_ks),
          static_cast<const __nv_bfloat16*>(a.pool_vs), a.table,
          a.tbl_stride, a.lengths, a.scratch, a.layer, a.n_pages, a.KV, a.G,
          a.page, a.hd, a.R, a.scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // The merge pass is a programmatic dependent launch of the split pass:
  // it may start under the split pass's last blocks (griddepcontrol).
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.KV, a.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(
      &cfg, paged_decode_merge_kernel<T, P>, static_cast<const T*>(a.q),
      static_cast<P*>(a.pool_k), static_cast<P*>(a.pool_v),
      static_cast<__nv_bfloat16*>(a.pool_ks),
      static_cast<__nv_bfloat16*>(a.pool_vs), a.lengths,
      static_cast<const T*>(a.cur_k), static_cast<const T*>(a.cur_v),
      a.write_page, a.write_offset,
      static_cast<const float*>(a.scratch), static_cast<T*>(a.out),
      a.layer, a.n_pages, a.S, a.KV, a.G, a.page, a.hd, a.R, a.scale);
}

template <typename T, typename P, int VEC>
int launch_g(const Args& a) {
  if (a.G == 1) return launch<T, P, VEC, 1>(a);
  // 16 int8 elements a lane at G up to 8 would not fit in registers; the
  // caller narrows int8 loads to 8 bytes when G > 1.
  if constexpr (VEC * sizeof(P) <= 8 || sizeof(P) > 1)
    return launch<T, P, VEC, kMaxGroup>(a);
  return (int)cudaErrorInvalidValue;
}

// The widest load (<= 16 bytes) that divides the row and keeps both pool
// bases aligned, rounded down to a width this file instantiates: float
// 4 or 1 elements, bf16 8, 2 or 1, int8 16 (G = 1), 8, 4 or 1.
template <typename T, typename P>
int launch_p(const Args& a) {
  int vec = 16 / (int)sizeof(P);
  if (sizeof(P) == 1 && a.G > 1) vec = 8;
  const uintptr_t base = reinterpret_cast<uintptr_t>(a.pool_k) |
                         reinterpret_cast<uintptr_t>(a.pool_v);
  while (vec > 1 && (a.hd % vec != 0 || base % (vec * sizeof(P)) != 0))
    vec >>= 1;
  if constexpr (std::is_same<P, float>::value) {
    return vec >= 4 ? launch_g<T, P, 4>(a) : launch_g<T, P, 1>(a);
  } else if constexpr (std::is_same<P, __nv_bfloat16>::value) {
    if (vec >= 8) return launch_g<T, P, 8>(a);
    return vec >= 2 ? launch_g<T, P, 2>(a) : launch_g<T, P, 1>(a);
  } else {
    if (vec >= 16) return launch_g<T, P, 16>(a);
    if (vec >= 8) return launch_g<T, P, 8>(a);
    return vec >= 4 ? launch_g<T, P, 4>(a) : launch_g<T, P, 1>(a);
  }
}

bool bad_geometry(int B, int KV, int G, int hd, int page, int R, int S) {
  return B < 1 || B > 65535 || KV < 1 || KV > 65535 || G < 1 ||
         G > kMaxGroup || hd < 1 || hd > kMaxHeadDim || page < 1 || R < 1 ||
         R % page != 0 || S < 1;
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32 (q, pools, cur_k/cur_v and out share
// it). scratch: fp32 (B, S, KV, G, hd + 2), S splits of R rows each (R a
// multiple of page; S * R should cover the table's width in rows). The
// caller (ops/paged_attention.py) validates shapes, dtypes, contiguity and
// the gate 1 <= hd <= 256, H % KV == 0, 1 <= G <= 8, page >= 1, B >= 1,
// and picks R and S. Launches the split pass, then the merge pass, on
// `stream`; returns the first nonzero cudaGetLastError(), else 0.
extern "C" int paged_attention_decode(
    int dtype, const void* q, void* pool_k, void* pool_v, const void* table,
    long long tbl_stride, const void* lengths, const void* cur_k,
    const void* cur_v, const void* write_page, const void* write_offset,
    void* out, void* scratch, int B, int KV, int G, int hd, int n_pages,
    int page, int layer, int rows_per_split, int n_splits, float scale,
    void* stream) {
  if (bad_geometry(B, KV, G, hd, page, rows_per_split, n_splits))
    return (int)cudaErrorInvalidValue;
  const Args a{q, pool_k, pool_v, nullptr, nullptr,
               static_cast<const int*>(table), tbl_stride,
               static_cast<const int*>(lengths), cur_k, cur_v,
               static_cast<const int*>(write_page),
               static_cast<const int*>(write_offset), out,
               static_cast<float*>(scratch), B, KV, G, hd, n_pages, page,
               layer, rows_per_split, n_splits, scale,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return launch_p<__nv_bfloat16, __nv_bfloat16>(a);
    case 1: return launch_p<float, float>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// int8 pools with bf16 (L, N, KV, page) scale pools. dtype (0 = bfloat16,
// 1 = float32) is that of q, cur_k/cur_v and out. Same scratch, gate and
// return value as paged_attention_decode.
extern "C" int paged_attention_decode_int8(
    int dtype, const void* q, void* pool_k, void* pool_v, void* pool_ks,
    void* pool_vs, const void* table, long long tbl_stride,
    const void* lengths, const void* cur_k, const void* cur_v,
    const void* write_page, const void* write_offset, void* out,
    void* scratch, int B, int KV, int G, int hd, int n_pages, int page,
    int layer, int rows_per_split, int n_splits, float scale, void* stream) {
  if (bad_geometry(B, KV, G, hd, page, rows_per_split, n_splits))
    return (int)cudaErrorInvalidValue;
  const Args a{q, pool_k, pool_v, pool_ks, pool_vs,
               static_cast<const int*>(table), tbl_stride,
               static_cast<const int*>(lengths), cur_k, cur_v,
               static_cast<const int*>(write_page),
               static_cast<const int*>(write_offset), out,
               static_cast<float*>(scratch), B, KV, G, hd, n_pages, page,
               layer, rows_per_split, n_splits, scale,
               static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return launch_p<__nv_bfloat16, int8_t>(a);
    case 1: return launch_p<float, int8_t>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}
