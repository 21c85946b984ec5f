// Native top-k search kernels (brute-force + IVF-Flat over a CSR layout).
//
// The first-party stand-in for the C++ engines the reference leans on for
// vector search — FAISS and Milvus/knowhere GPU_IVF_FLAT (reference:
// common/utils.py:181-198). OpenMP parallel over queries; per-query
// bounded min-heap selection so k << N costs O(N log k).
//
// Build: g++ -O3 -fopenmp -shared -fPIC -std=c++17 topk.cpp -o <lib>.so
// (done on demand by native/__init__.py into the package's build/
// directory; numpy fallback if unavailable).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Hit {
  float score;
  int64_t id;
};

// Min-heap on score: root = worst of the current top-k.
inline bool worse(const Hit &a, const Hit &b) { return a.score > b.score; }

inline void heap_push(std::vector<Hit> &heap, int64_t k, float score,
                      int64_t id) {
  if ((int64_t)heap.size() < k) {
    heap.push_back({score, id});
    std::push_heap(heap.begin(), heap.end(), worse);
  } else if (score > heap.front().score) {
    std::pop_heap(heap.begin(), heap.end(), worse);
    heap.back() = {score, id};
    std::push_heap(heap.begin(), heap.end(), worse);
  }
}

inline float dot(const float *a, const float *b, int64_t d) {
  float s = 0.f;
  for (int64_t i = 0; i < d; ++i) s += a[i] * b[i];
  return s;
}

// metric: 0 = inner product, 1 = negated squared L2 (argmax == nearest).
inline float score_one(const float *base_row, float base_sq, const float *q,
                       float q_sq, int64_t d, int metric) {
  float dp = dot(base_row, q, d);
  return metric == 0 ? dp : 2.f * dp - base_sq - q_sq;
}

inline void emit(std::vector<Hit> &heap, int64_t k, int64_t *out_idx,
                 float *out_score) {
  // Sort descending by score; pad with id -1.
  std::sort(heap.begin(), heap.end(),
            [](const Hit &a, const Hit &b) { return a.score > b.score; });
  for (int64_t j = 0; j < k; ++j) {
    if (j < (int64_t)heap.size()) {
      out_idx[j] = heap[j].id;
      out_score[j] = heap[j].score;
    } else {
      out_idx[j] = -1;
      out_score[j] = -INFINITY;
    }
  }
}

}  // namespace

extern "C" {

// base: (n, d) row-major. base_sq: (n,) squared norms (may be null for ip).
// live: (n,) 0/1 mask (null == all live). out_*: (nq, k).
void gaie_brute_topk(const float *base, const float *base_sq,
                     const uint8_t *live, int64_t n, int64_t d,
                     const float *queries, int64_t nq, int64_t k, int metric,
                     int64_t *out_idx, float *out_score) {
#pragma omp parallel for schedule(static)
  for (int64_t qi = 0; qi < nq; ++qi) {
    const float *q = queries + qi * d;
    float q_sq = metric == 0 ? 0.f : dot(q, q, d);
    std::vector<Hit> heap;
    heap.reserve(k + 1);
    for (int64_t i = 0; i < n; ++i) {
      if (live && !live[i]) continue;
      heap_push(heap, k,
                score_one(base + i * d, base_sq ? base_sq[i] : 0.f, q, q_sq, d,
                          metric),
                i);
    }
    emit(heap, k, out_idx + qi * k, out_score + qi * k);
  }
}

// IVF-Flat search over a CSR cluster layout:
//   centroids: (nlist, d); offsets: (nlist+1,); items: (n,) vector ids
//   ordered by cluster. Scans the nprobe nearest centroids' postings.
void gaie_ivf_search(const float *base, const float *base_sq,
                     const uint8_t *live, int64_t d, const float *centroids,
                     int64_t nlist, const int64_t *offsets,
                     const int64_t *items, const float *queries, int64_t nq,
                     int64_t k, int64_t nprobe, int metric, int64_t *out_idx,
                     float *out_score) {
  if (nprobe > nlist) nprobe = nlist;
#pragma omp parallel for schedule(static)
  for (int64_t qi = 0; qi < nq; ++qi) {
    const float *q = queries + qi * d;
    float q_sq = dot(q, q, d);
    // Rank centroids by (negated) L2 distance — assignment metric is always
    // euclidean, matching the k-means used to build the lists.
    std::vector<Hit> cheap;
    cheap.reserve(nprobe + 1);
    for (int64_t c = 0; c < nlist; ++c) {
      const float *cr = centroids + c * d;
      float cs = 2.f * dot(cr, q, d) - dot(cr, cr, d) - q_sq;
      heap_push(cheap, nprobe, cs, c);
    }
    std::vector<Hit> heap;
    heap.reserve(k + 1);
    for (const Hit &ch : cheap) {
      int64_t c = ch.id;
      for (int64_t p = offsets[c]; p < offsets[c + 1]; ++p) {
        int64_t i = items[p];
        if (live && !live[i]) continue;
        heap_push(heap, k,
                  score_one(base + i * d, base_sq ? base_sq[i] : 0.f, q, q_sq,
                            d, metric),
                  i);
      }
    }
    emit(heap, k, out_idx + qi * k, out_score + qi * k);
  }
}

int gaie_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
