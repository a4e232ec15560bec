// K1: exact k-nearest-neighbor search with AABB tile skipping, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel lis_slam_tpu/ops/pallas_knn.py:_knn_kernel
// (launched by knn_pallas). Contract, as there: Q queries against an
// N-point masked map; the k best come back ascending, with their indices
// and coordinates; only neighbors strictly closer than `bound`
// (max_sq_dist, or +inf) are kept, and unfilled slots hold d=+inf, idx=-1.
// Among equal distances the lower map index wins (the TPU kernel's `bd > m`
// insertion and its wrapper's stable argsort).
//
// What bounds it on the H100. Brute force is Q*N distance evaluations
// (2048 x 65536 = 134M for the surf map per cache refresh, ~10 fp32
// instructions each); the map is only 1 MB and stays in L2. But the work
// these inputs need is far smaller: every scan-to-map search is capped at
// 2 m and hands in morton-sorted queries against a morton-ordered map
// (voxel_merge_aged), so a group of neighbouring queries can only find
// neighbours in a few map tiles. So the kernel skips, as the TPU kernel
// does (pallas_knn.py:155-172), every tile that provably cannot change a
// result, and what bounds it is the latency of the tiles a query group
// does need. Design:
//  - a prepass kernel (one block per tile of kTile map points) writes
//    each tile's AABB over its masked-in points (lo = +inf, hi = -inf when
//    it has none) and the tile in packed float4 form, with masked-out and
//    padding points at x = +inf so no distance to them is finite;
//  - a block holds one group of 32 queries (lane l of every warp has
//    query 32 * blockIdx.x + l, one thread per query and warp, k best in
//    registers; k is a template parameter, so the insertion unrolls);
//  - the group's queries lie in a box (over its active queries only);
//    each lane of a warp tests one tile at a time against that box: the
//    lower bound `lb` of any distance from the box to the tile's AABB,
//    and a ballot keeps the tiles with lb < `worst`, the warp's largest
//    k-th best (the cap from the start, so far tiles skip from the first
//    tile on and an empty map skips everything);
//  - the needed tiles of a group are a short contiguous run of the
//    morton-ordered map, so one warp would serialise them: the block's
//    kWarps warps take the tiles round-robin (tile t to warp t % kWarps;
//    a warp's lanes test 32 of its own tiles per ballot, so a 512-tile map
//    takes each warp two rounds), each stages a needed tile in its own
//    shared-memory chunk and scans it;
//    then the block merges its warps' lists by (distance, index), which
//    keeps the lowest-index tie rule for any split of the tiles;
//  - skipping is exact. lb = gx*gx + gy*gy + gz*gz is formed in the same
//    order as d, with every gap a rounded difference of box corners that
//    bounds the rounded coordinate difference of every pair; rounding is
//    monotone, so lb <= d for every point of the tile. A point enters a
//    list only if d < bd[k-1] <= worst, so a tile with lb >= worst can
//    change nothing: the result is bit-equal to the plain version;
//  - no atomics and no split of the map across blocks (a second pass
//    merging tile ranges was tried and dropped): the result is
//    deterministic.
//  - distances are the exact (q-r)^2, not the TPU's MXU form
//    |q|^2+|r|^2-2qr that loses ~1e-3 to cancellation. Built with
//    --fmad=false so each product rounds as in the plain PyTorch version
//    (ops/knn.py:sq_dist), and both pick the same neighbors.
// `tiles_done` (optional, null on the main path) receives each warp's
// count of tiles it scanned, so a caller can see the share skipped.
// Lanes (the scheduled solver's batched replay): B query clouds against B
// maps of equal sizes, lane-strided in memory, in the same two launches;
// the grid's y index is the lane, and each lane's blocks touch only its
// own map, tiles and outputs, so a lane's result is bit-equal to a
// one-lane launch.
// Constants, each timed against a copy of this file with another value
// (chip_smoke.py --baseline, H100 at 700 W): 128 points per tile and 16
// warps per group. 64-point tiles were equal on the front end's surf
// search, up to 9% faster on the back end's registrations and slower on
// an empty map; 256-point ones 1.4x slower on the surf search, 8 warps
// 1.3x.
// What bounds it now: the prepass is 2-3 us; the rest is the scan of the needed
// tiles, latency-bound, and set by the heaviest query group (several
// times the mean number of needed tiles). Not yet measured apart: how
// much of a tile's scan goes to the divergent insertions while a dense
// neighbourhood fills the k slots (any inserting lane holds its warp).
// Later work: cp.async double buffering of the needed tiles; a
// tree-shaped merge of the warps' lists; cheaper insertion.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 128;  // map points per AABB tile
constexpr int kWarps = 16;  // warps per query group (block)
constexpr int kThreads = 32 * kWarps;
// points a warp stages at once: 32 KB of chunks per block at most
constexpr int kChunk = kTile < 2048 / kWarps ? kTile : 2048 / kWarps;
constexpr int kPrepThreads = kTile < 256 ? kTile : 256;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kTile % kChunk == 0 && kChunk % 32 == 0, "tile shape");

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fminf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// Insert (d, idx) into the ascending register list (bd, bi) of length K,
// after every entry <= d. The caller has checked d < bd[K-1], and feeds
// points in ascending index order, so ties keep the lower index first.
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

// (d, i) before (e, j) in the plain version's order: by distance, then
// by index. Unfilled slots hold (bound, -1) and any candidate is strictly
// inside the bound, so they sort last.
__device__ __forceinline__ bool lex_less(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

// Insert a candidate from another list in (distance, index) order: the
// merge of lists built over disjoint index sets.
template <int K>
__device__ __forceinline__ void insert_lex(float (&bd)[K], int (&bi)[K],
                                           float d, int idx) {
  if (!lex_less(d, idx, bd[K - 1], bi[K - 1])) return;
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    if (lex_less(d, idx, bd[s - 1], bi[s - 1])) {
      bd[s] = bd[s - 1];
      bi[s] = bi[s - 1];
    } else if (lex_less(d, idx, bd[s], bi[s])) {
      bd[s] = d;
      bi[s] = idx;
    }
  }
  if (lex_less(d, idx, bd[0], bi[0])) {
    bd[0] = d;
    bi[0] = idx;
  }
}

// One block per tile: the tile's AABB over its masked-in points, and the
// tile packed as float4 (x, y, z, 0), masked-out / padding rows at x=+inf.
__global__ void __launch_bounds__(kPrepThreads)
knn_prepass_kernel(const float* __restrict__ ref,
                   const uint8_t* __restrict__ ref_mask, int n,
                   float4* __restrict__ packed, float4* __restrict__ box_lo,
                   float4* __restrict__ box_hi) {
  __shared__ float xyz[3 * kTile];
  __shared__ float red[6][kPrepThreads / 32];
  {  // this block's lane: its map, its packed tiles and boxes
    const size_t lane = blockIdx.y;
    const size_t n_tiles = gridDim.x;
    ref += lane * n * 3;
    ref_mask += lane * n;
    packed += lane * n_tiles * kTile;
    box_lo += lane * 2 * n_tiles;
    box_hi += lane * 2 * n_tiles;
  }
  const int base = blockIdx.x * kTile;
  const int cnt = min(kTile, n - base);
  for (int j = threadIdx.x; j < 3 * cnt; j += kPrepThreads)
    xyz[j] = ref[3 * static_cast<size_t>(base) + j];  // coalesced
  __syncthreads();
  const float inf = pos_inf();
  float v[6] = {inf, inf, inf, -inf, -inf, -inf};  // lo xyz, hi xyz
  for (int j = threadIdx.x; j < kTile; j += kPrepThreads) {
    float4 p = make_float4(inf, 0.f, 0.f, 0.f);
    if (j < cnt && ref_mask[base + j]) {
      p = make_float4(xyz[3 * j], xyz[3 * j + 1], xyz[3 * j + 2], 0.f);
      v[0] = fminf(v[0], p.x);
      v[1] = fminf(v[1], p.y);
      v[2] = fminf(v[2], p.z);
      v[3] = fmaxf(v[3], p.x);
      v[4] = fmaxf(v[4], p.y);
      v[5] = fmaxf(v[5], p.z);
    }
    packed[base + j] = p;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const float x = c < 3 ? warp_min(v[c]) : warp_max(v[c]);
    if (lane == 0) red[c][warp] = x;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float b[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      b[c] = red[c][0];
      for (int w = 1; w < kPrepThreads / 32; ++w)
        b[c] = c < 3 ? fminf(b[c], red[c][w]) : fmaxf(b[c], red[c][w]);
    }
    box_lo[blockIdx.x] = make_float4(b[0], b[1], b[2], 0.f);
    box_hi[blockIdx.x] = make_float4(b[3], b[4], b[5], 0.f);
  }
}

// The k best of one query written out, with the neighbors' coordinates.
template <int K>
__device__ __forceinline__ void write_result(const float (&bd)[K],
                                             const int (&bi)[K], int qi,
                                             const float* __restrict__ ref,
                                             float* __restrict__ out_d,
                                             int* __restrict__ out_i,
                                             float* __restrict__ out_xyz) {
  const size_t o = static_cast<size_t>(qi) * K;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const int idx = bi[s];
    out_d[o + s] = idx >= 0 ? bd[s] : pos_inf();
    out_i[o + s] = idx;
    for (int c = 0; c < 3; ++c)
      out_xyz[(o + s) * 3 + c] = idx >= 0 ? ref[3 * idx + c] : 0.f;
  }
}

// One query group (32 queries) per block over every tile of the map.
template <int K>
__global__ void __launch_bounds__(kThreads)
knn_tiles_kernel(const float* __restrict__ query, int q_n,
                 const float4* __restrict__ packed,
                 const float4* __restrict__ box_lo,
                 const float4* __restrict__ box_hi, int n_tiles, float bound,
                 const float* __restrict__ ref, int n_ref,
                 float* __restrict__ out_d,
                 int* __restrict__ out_i, float* __restrict__ out_xyz,
                 int* __restrict__ tiles_done) {
  {  // this block's lane: its queries, map, tiles, boxes and outputs
    const size_t lane = blockIdx.y;
    const size_t nt = n_tiles;
    query += lane * q_n * 3;
    packed += lane * nt * kTile;
    box_lo += lane * 2 * nt;
    box_hi += lane * 2 * nt;
    ref += lane * n_ref * 3;
    out_d += lane * q_n * K;
    out_i += lane * q_n * K;
    out_xyz += lane * q_n * K * 3;
    if (tiles_done != nullptr) tiles_done += lane * gridDim.x * kWarps;
  }
  // kWarps staging chunks; reused for the block merge after the scan
  constexpr int kStage = kWarps * kChunk * 4;
  constexpr int kMerge = kWarps * K * 32 * 2;
  __shared__ __align__(16) float smem[kStage > kMerge ? kStage : kMerge];
  float4* chunk = reinterpret_cast<float4*>(smem) +
                  (threadIdx.x >> 5) * kChunk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qi = blockIdx.x * 32 + lane;
  const bool active = qi < q_n;
  const float inf = pos_inf();
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = query[3 * qi];
    qy = query[3 * qi + 1];
    qz = query[3 * qi + 2];
  }
  // the group's query box, over its active queries only
  const float lox = warp_min(active ? qx : inf);
  const float loy = warp_min(active ? qy : inf);
  const float loz = warp_min(active ? qz : inf);
  const float hix = warp_max(active ? qx : -inf);
  const float hiy = warp_max(active ? qy : -inf);
  const float hiz = warp_max(active ? qz : -inf);
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = bound;
    bi[s] = -1;
  }
  float worst = warp_max(active ? bd[K - 1] : -inf);  // warp-uniform
  int done = 0;
  // a round tests 32 of this warp's own tiles, one per lane, ascending
  for (int t0 = warp; t0 < n_tiles; t0 += 32 * kWarps) {
    const int t = t0 + lane * kWarps;
    float lb = inf;
    if (t < n_tiles) {
      const float4 lo = box_lo[t], hi = box_hi[t];
      const float gx = fmaxf(fmaxf(lo.x - hix, lox - hi.x), 0.f);
      const float gy = fmaxf(fmaxf(lo.y - hiy, loy - hi.y), 0.f);
      const float gz = fmaxf(fmaxf(lo.z - hiz, loz - hi.z), 0.f);
      lb = gx * gx + gy * gy + gz * gz;
    }
    unsigned need = __ballot_sync(kFull, lb < worst);
    while (need != 0u) {
      const int b = __ffs(need) - 1;
      need &= need - 1u;
      if (!(__shfl_sync(kFull, lb, b) < worst)) continue;  // worst fell
      const int base = (t0 + b * kWarps) * kTile;
      for (int c = 0; c < kTile; c += kChunk) {
        __syncwarp();
        for (int j = lane; j < kChunk; j += 32) chunk[j] = packed[base + c + j];
        __syncwarp();
        if (active) {
#pragma unroll 4
          for (int j = 0; j < kChunk; ++j) {
            const float4 p = chunk[j];
            const float dx = qx - p.x;
            const float dy = qy - p.y;
            const float dz = qz - p.z;
            const float d = dx * dx + dy * dy + dz * dz;
            if (d < bd[K - 1]) insert_sorted<K>(bd, bi, d, base + c + j);
          }
        }
      }
      worst = warp_max(active ? bd[K - 1] : -inf);
      ++done;
    }
  }
  if (tiles_done != nullptr && lane == 0)
    tiles_done[blockIdx.x * kWarps + warp] = done;

  // merge the warps' lists by (distance, index) into warp 0
  __syncthreads();  // every warp is done with its staging chunk
  float* md = smem;
  int* mi = reinterpret_cast<int*>(smem) + kWarps * K * 32;
  if (warp > 0) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      md[(warp * K + s) * 32 + lane] = bd[s];
      mi[(warp * K + s) * 32 + lane] = bi[s];
    }
  }
  __syncthreads();
  if (warp != 0 || !active) return;
  for (int w = 1; w < kWarps; ++w) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const int idx = mi[(w * K + s) * 32 + lane];
      if (idx < 0) break;  // the rest of that list is unfilled
      insert_lex<K>(bd, bi, md[(w * K + s) * 32 + lane], idx);
    }
  }
  write_result<K>(bd, bi, qi, ref, out_d, out_i, out_xyz);
}

template <int K>
cudaError_t launch(const float* query, int q_n, const float* ref,
                   const uint8_t* ref_mask, int n, int lanes, float bound,
                   float4* packed, float4* boxes, float* out_d, int* out_i,
                   float* out_xyz, int* tiles_done, cudaStream_t stream) {
  const int n_tiles = (n + kTile - 1) / kTile;
  float4* box_lo = boxes;
  float4* box_hi = boxes + n_tiles;
  if (n_tiles > 0) {
    knn_prepass_kernel<<<dim3(n_tiles, lanes), kPrepThreads, 0, stream>>>(
        ref, ref_mask, n, packed, box_lo, box_hi);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  knn_tiles_kernel<K><<<dim3((q_n + 31) / 32, lanes), kThreads, 0, stream>>>(
      query, q_n, packed, box_lo, box_hi, n_tiles, bound, ref, n, out_d,
      out_i, out_xyz, tiles_done);
  return cudaGetLastError();
}

}  // namespace

// For each of `lanes` lanes: query (q_n, 3) f32, ref (n, 3) f32, ref_mask
// (n,) bool as bytes; scratch packed (n_tiles * tile, float4) and boxes
// (2 * n_tiles, float4); outputs out_d/out_i (q_n, k), out_xyz (q_n, k,
// 3); tiles_done (ceil(q_n / 32) * warps, int) or null; each array holds
// the lanes one after another. Returns a cudaError_t (0 on success).
extern "C" int lis_knn(const float* query, int q_n, const float* ref,
                       const uint8_t* ref_mask, int n, int lanes, int k,
                       float bound, void* packed, void* boxes, float* out_d,
                       int* out_i, float* out_xyz, int* tiles_done,
                       void* stream) {
  if (q_n <= 0 || n < 0 || lanes < 1 || lanes > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float4* pk = static_cast<float4*>(packed);
  float4* bx = static_cast<float4*>(boxes);
#define LIS_KNN_CASE(KV)                                                   \
  case KV:                                                                 \
    return static_cast<int>(launch<KV>(query, q_n, ref, ref_mask, n,       \
                                       lanes, bound, pk, bx, out_d, out_i, \
                                       out_xyz, tiles_done, st));
  switch (k) {
    LIS_KNN_CASE(1)
    LIS_KNN_CASE(5)
    LIS_KNN_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LIS_KNN_CASE
}

// Map points per AABB tile and warps per query group, so the caller can
// size the scratch buffers.
extern "C" int lis_knn_tile() { return kTile; }
extern "C" int lis_knn_warps() { return kWarps; }
