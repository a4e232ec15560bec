// K1: exact brute-force k-nearest-neighbor search for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lis_slam_tpu/ops/pallas_knn.py:_knn_kernel
// (launched by knn_pallas). Contract, as there: Q queries against an
// N-point masked map; the k best come back ascending, with their indices
// and coordinates; only neighbors strictly closer than `bound`
// (max_sq_dist, or +inf) are kept, and unfilled slots hold d=+inf, idx=-1.
// Among equal distances the lower map index wins (the TPU kernel's `bd > m`
// insertion and its wrapper's stable argsort).
//
// What bounds it on the H100: the distance evaluations, Q*N of them
// (2048 x 65536 = 134M for the surf map per cache refresh), each ~10 fp32
// instructions; the map itself is only 1 MB and stays in L2. Design:
//  - one thread per query keeps its k best in registers (k is a template
//    parameter, so the insertion network is fully unrolled and never
//    spills to local memory);
//  - the block streams the map through shared memory in tiles of float4
//    (x, y, z, valid); every thread reads the same tile entry, a broadcast
//    with no bank conflicts;
//  - 2048 queries are only 16 blocks of 128, too few for 132 SMs, so the
//    map is split over blockIdx.y: each split writes a partial top-k, and a
//    second kernel merges the splits in index order (which keeps the
//    lowest-index tie rule). No atomics: the result is deterministic.
//  - distances are the exact (q-r)^2, not the TPU's MXU form
//    |q|^2+|r|^2-2qr that loses ~1e-3 to cancellation. Built with
//    --fmad=false so each product rounds as in the plain PyTorch version
//    (ops/knn.py:sq_dist), and both pick the same neighbors.
// Later work: AABB tile skipping on the morton-ordered map, TMA tile loads.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;  // map points per shared-memory tile (16 KB)

// Insert (d, idx) into the ascending register list (bd, bi) of length K,
// after every entry <= d. The caller has checked d < bd[K-1].
template <int K>
__device__ __forceinline__ void insert_sorted(float (&bd)[K], int (&bi)[K],
                                              float d, int idx) {
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    if (bd[s - 1] > d) {
      bd[s] = bd[s - 1];
      bi[s] = bi[s - 1];
    } else if (bd[s] > d) {
      bd[s] = d;
      bi[s] = idx;
    }
  }
  if (bd[0] > d) {
    bd[0] = d;
    bi[0] = idx;
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_partial_kernel(const float* __restrict__ query, int q_n,
                   const float* __restrict__ ref,
                   const uint8_t* __restrict__ ref_mask, int n,
                   int split_len, float bound, float* __restrict__ part_d,
                   int* __restrict__ part_i) {
  __shared__ float4 tile[kTile];
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  const bool active = qi < q_n;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = query[3 * qi];
    qy = query[3 * qi + 1];
    qz = query[3 * qi + 2];
  }
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = bound;
    bi[s] = -1;
  }
  const int lo = blockIdx.y * split_len;
  const int hi = min(n, lo + split_len);
  for (int base = lo; base < hi; base += kTile) {
    const int cnt = min(kTile, hi - base);
    __syncthreads();
    for (int j = threadIdx.x; j < cnt; j += kThreads) {
      const int r = base + j;
      tile[j] = make_float4(ref[3 * r], ref[3 * r + 1], ref[3 * r + 2],
                            ref_mask[r] ? 1.f : 0.f);
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < cnt; ++j) {
        const float4 p = tile[j];
        const float dx = qx - p.x;
        const float dy = qy - p.y;
        const float dz = qz - p.z;
        const float d = dx * dx + dy * dy + dz * dz;
        if (p.w != 0.f && d < bd[K - 1]) insert_sorted<K>(bd, bi, d, base + j);
      }
    }
  }
  if (active) {
    const size_t o = (static_cast<size_t>(blockIdx.y) * q_n + qi) * K;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      part_d[o + s] = bi[s] >= 0 ? bd[s] : __int_as_float(0x7f800000);
      part_i[o + s] = bi[s];
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_merge_kernel(const float* __restrict__ part_d,
                 const int* __restrict__ part_i, int splits, int q_n,
                 const float* __restrict__ ref, float* __restrict__ out_d,
                 int* __restrict__ out_i, float* __restrict__ out_xyz) {
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  if (qi >= q_n) return;
  const float inf = __int_as_float(0x7f800000);
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = inf;
    bi[s] = -1;
  }
  // splits cover ascending index ranges, each list ascending with ties in
  // index order: inserting them in order keeps the lowest-index tie rule
  for (int sp = 0; sp < splits; ++sp) {
    const size_t o = (static_cast<size_t>(sp) * q_n + qi) * K;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const int idx = part_i[o + s];
      const float d = part_d[o + s];
      if (idx >= 0 && d < bd[K - 1]) insert_sorted<K>(bd, bi, d, idx);
    }
  }
  const size_t o = static_cast<size_t>(qi) * K;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const int idx = bi[s];
    out_d[o + s] = bd[s];
    out_i[o + s] = idx;
    for (int c = 0; c < 3; ++c)
      out_xyz[(o + s) * 3 + c] = idx >= 0 ? ref[3 * idx + c] : 0.f;
  }
}

template <int K>
cudaError_t launch(const float* query, int q_n, const float* ref,
                   const uint8_t* ref_mask, int n, float bound, int splits,
                   float* part_d, int* part_i, float* out_d, int* out_i,
                   float* out_xyz, cudaStream_t stream) {
  const int q_blocks = (q_n + kThreads - 1) / kThreads;
  const int split_len = n > 0 ? (n + splits - 1) / splits : 1;
  knn_partial_kernel<K><<<dim3(q_blocks, splits), kThreads, 0, stream>>>(
      query, q_n, ref, ref_mask, n, split_len, bound, part_d, part_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  knn_merge_kernel<K><<<q_blocks, kThreads, 0, stream>>>(
      part_d, part_i, splits, q_n, ref, out_d, out_i, out_xyz);
  return cudaGetLastError();
}

}  // namespace

// query (q_n, 3) f32, ref (n, 3) f32, ref_mask (n,) bool as bytes;
// scratch part_d/part_i (splits, q_n, k); outputs out_d/out_i (q_n, k),
// out_xyz (q_n, k, 3). Returns a cudaError_t (0 on success).
extern "C" int lis_knn(const float* query, int q_n, const float* ref,
                       const uint8_t* ref_mask, int n, int k, float bound,
                       int splits, float* part_d, int* part_i, float* out_d,
                       int* out_i, float* out_xyz, void* stream) {
  if (q_n <= 0 || splits <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LIS_KNN_CASE(KV)                                                   \
  case KV:                                                                 \
    return static_cast<int>(launch<KV>(query, q_n, ref, ref_mask, n,       \
                                       bound, splits, part_d, part_i,      \
                                       out_d, out_i, out_xyz, st));
  switch (k) {
    LIS_KNN_CASE(1)
    LIS_KNN_CASE(5)
    LIS_KNN_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LIS_KNN_CASE
}
