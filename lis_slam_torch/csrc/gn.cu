// K2: fused Gauss-Newton correspondence accumulation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lis_slam_tpu/ops/pallas_gn.py:_gn_kernel
// (launched by gn_partials, which gn_iteration_hg calls once per cloud per
// GN iteration). Per query, the whole LOAM iteration body of
// cornerOptimization / surfOptimization (odomEstimationNode.cpp:633-827):
//   transform by the pose -> re-rank the k cached candidates and take the
//   5 nearest by iterated min (lowest slot on ties) -> gate on the 5th
//   distance -> 5-point centroid + covariance (corner / 5, surf raw sum)
//   -> closed-form 3x3 eigenvalues -> projector eigenvector (first-max
//   column) -> corner point-to-line or surf TLS plane -> damping and gates
//   -> weighted Jacobian row J (6) and residual r.
// One launch per GN iteration covers both clouds: corner blocks first,
// then surf blocks, each block in one mode. Each block writes the 21
// upper-triangle entries of sum J^T J, the 6 of sum J^T (-r) and n_valid
// (28 floats); the last block to finish (an atomic ticket after a
// __threadfence) sums the corner blocks and the surf blocks, each in
// block order, adds the two, writes the full symmetric H (36), g (6) and
// n_valid, and resets the ticket for the next launch. No other atomics, so
// H is bit-reproducible from run to run (and equal to the two-launch
// design's Hc + Hs at the same block size).
// Lanes (the scheduled solver's batched replay): the grid's y index is the
// lane; each lane has its own clouds (lane-strided, equal sizes), its own
// partials, its own ticket and its own last block, which sums that lane's
// blocks in block order, so lane b's H is bit-equal to a one-lane launch
// on lane b's inputs. The lanes' scalar rows come from device memory
// (written there by K3, csrc/gn_solve.cu), the one-lane path's by value.
// The lanes path computes each row and the sums in double (T = double;
// inputs and the result stay float32): on the HDL-64 circuit, float32
// rounding of the rows whose five neighbours are nearly collinear moves
// the weakest eigenvalue of H by 5-9% around the solver's degeneracy
// threshold, and with it whether a lane drifted; in double a lane's track
// no longer depends on the last bit of its input (ops/gn_cuda.py). The
// one-lane path keeps float32, as the JAX kernel computes.
//
// What bounds it on the H100: not bytes (a GN iteration of the front end
// reads ~370 KB) nor operations (~1 MFLOP) but latency: a few hundred
// dependent fp32 ops per query, including sqrt/acos/cos, over a few
// thousand threads, and the launch itself. Design: one launch and no
// host-to-device copy per GN iteration (the two 64-float scalar rows --
// pose, rotation Jacobians, gates -- travel by value in the kernel's
// parameter struct, from the host where the pose lives); one thread per
// query with the k candidates in registers (k is a template parameter, so
// the selection network unrolls); the block stages its contiguous slab of
// candidates (kThreads x k x 3 floats) and flags in shared memory with
// 16-byte loads, padded rows so each thread then reads its own row
// without bank conflicts; small blocks so even 1024 queries spread over
// many SMs (64 threads: 32 were 1.1x slower at the front end's shapes
// and 1.35x at the refinement's, timed against a copy of this file with
// chip_smoke.py --baseline on an H100 at 700 W); the 28 sums reduced in
// the block by warp shuffles and a small shared-memory pass. Inputs keep
// the JAX public layout ((Q,3), (Q,k,3), ...), not the TPU's transposed
// (3k, Qp) lanes. Built without --use_fast_math (the closed-form acos/cos
// eigenvalues are sensitive to it) and with --fmad=false, so each product
// rounds as in the plain PyTorch version: surf rows whose five neighbours are nearly collinear
// have an ill-defined plane normal, and there any rounding difference
// picks another normal.
// Later work: fusing K3's 6x6 solve and degeneracy clamp into the last
// block.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 64;  // queries per block
constexpr int kWarps = kThreads / 32;
constexpr int kOut = 28;  // 21 H upper triangle, 6 g, n_valid
constexpr int kResult = 43;  // H (6x6 row-major), g, n_valid
constexpr float kInf = 3e38f;

// scalar row layout (ops/gn_cuda.py:pack_scalars, as pallas_gn.py:47-59)
constexpr int SC_R = 0, SC_T = 9, SC_MR = 12, SC_MP = 21, SC_MY = 30;
constexpr int SC_MAXSQ = 39, SC_DAMP = 40, SC_MINW = 41, SC_GATE = 42;

// The arithmetic type T of a row and of the sums: float (the one-lane
// path, as the JAX kernel computes) or double (the lanes path).
__device__ __forceinline__ float sqrt_(float v) { return sqrtf(v); }
__device__ __forceinline__ double sqrt_(double v) { return sqrt(v); }
__device__ __forceinline__ float acos_(float v) { return acosf(v); }
__device__ __forceinline__ double acos_(double v) { return acos(v); }
__device__ __forceinline__ float cos_(float v) { return cosf(v); }
__device__ __forceinline__ double cos_(double v) { return cos(v); }
__device__ __forceinline__ float abs_(float v) { return fabsf(v); }
__device__ __forceinline__ double abs_(double v) { return fabs(v); }
__device__ __forceinline__ float max_(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_(double a, double b) {
  return fmax(a, b);
}
__device__ __forceinline__ float min_(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double min_(double a, double b) {
  return fmin(a, b);
}

template <typename T>
struct Sym3 {
  T a00, a01, a02, a11, a12, a22;
};

// Unit nonzero column of (A - s1 I)(A - s2 I), the first one of maximal
// norm (jnp.argmax semantics, utils/lin.py principal/smallest_eigvec3).
template <typename T>
__device__ __forceinline__ void projector_eigvec(const Sym3<T>& A, T s1, T s2,
                                                 T& vx, T& vy, T& vz) {
  const T b00 = A.a00 - s1, b11 = A.a11 - s1, b22 = A.a22 - s1;
  const T c00 = A.a00 - s2, c11 = A.a11 - s2, c22 = A.a22 - s2;
  const T a01 = A.a01, a02 = A.a02, a12 = A.a12;
  const T p00 = b00 * c00 + a01 * a01 + a02 * a02;
  const T p10 = a01 * c00 + b11 * a01 + a12 * a02;
  const T p20 = a02 * c00 + a12 * a01 + b22 * a02;
  const T p01 = b00 * a01 + a01 * c11 + a02 * a12;
  const T p11 = a01 * a01 + b11 * c11 + a12 * a12;
  const T p21 = a02 * a01 + a12 * c11 + b22 * a12;
  const T p02 = b00 * a02 + a01 * a12 + a02 * c22;
  const T p12 = a01 * a02 + b11 * a12 + a12 * c22;
  const T p22 = a02 * a02 + a12 * a12 + b22 * c22;
  const T n0 = sqrt_(p00 * p00 + p10 * p10 + p20 * p20);
  const T n1 = sqrt_(p01 * p01 + p11 * p11 + p21 * p21);
  const T n2 = sqrt_(p02 * p02 + p12 * p12 + p22 * p22);
  if (n0 >= n1 && n0 >= n2) {
    vx = p00; vy = p10; vz = p20;
  } else if (n1 >= n2) {
    vx = p01; vy = p11; vz = p21;
  } else {
    vx = p02; vy = p12; vz = p22;
  }
  const T inv_n = T(1) / max_(sqrt_(vx * vx + vy * vy + vz * vz), T(1e-20f));
  vx *= inv_n;
  vy *= inv_n;
  vz *= inv_n;
}

// One cloud of a GN iteration. n_blocks = ceil(q_n / kThreads); a cloud
// with q_n = 0 has no blocks.
struct GnCloud {
  const float* pts;       // (q_n, 3)
  const uint8_t* mask;    // (q_n,) bool
  const float* cand;      // (q_n, K, 3)
  const uint8_t* cand_ok; // (q_n, K) bool
  const float* weight;    // (q_n,) or null for all ones
  int q_n;
  int n_blocks;
};

// Everything one launch needs, by value: clouds 0 (corner) and 1 (surf),
// lane 0's (others at lane-strided offsets), their scalar rows
// (ops/gn_cuda.py:pack_scalars) by value, or `rows` (lanes, 2, 64) in
// device memory, the (lanes, n_blocks, 28) partials scratch, the tickets
// (one per lane, 0 between launches) and the (lanes, 43) result.
struct GnParams {
  GnCloud cloud[2];
  float sc[2][64];
  const float* rows;
  void* partials;  // T (lanes, n_blocks, 28)
  unsigned int* ticket;
  float* out;
};

// The 28 terms of one query's row: J^T J upper triangle (21), J^T (-r)
// (6) and its validity (1); all zero for a masked-out or gated query.
// s_cand / s_ok hold the query's own staged candidates and flags.
template <int K, bool kCorner, typename T>
__device__ __forceinline__ void row_terms(const float* __restrict__ pts,
                                          const uint8_t* __restrict__ mask,
                                          const float* __restrict__ weight,
                                          const float* sc, int qi,
                                          bool in_range, const float* s_cand,
                                          const uint8_t* s_ok,
                                          T (&v)[kOut]) {
  // the float path's constants as before; 0.2 and 2 pi / 3 rounded to T
  constexpr T kFifth = static_cast<T>(sizeof(T) == 4 ? 0.2f : 0.2);
  constexpr T kThird2Pi = static_cast<T>(
      sizeof(T) == 4 ? 2.0943951023931953f : 2.0943951023931953);
  T J[6] = {0, 0, 0, 0, 0, 0};
  T r = 0, okf = 0;

  if (in_range && mask[qi]) {
    const T px = pts[3 * qi], py = pts[3 * qi + 1], pz = pts[3 * qi + 2];
    const T wx = T(sc[SC_R + 0]) * px + T(sc[SC_R + 1]) * py
                 + T(sc[SC_R + 2]) * pz + T(sc[SC_T + 0]);
    const T wy = T(sc[SC_R + 3]) * px + T(sc[SC_R + 4]) * py
                 + T(sc[SC_R + 5]) * pz + T(sc[SC_T + 1]);
    const T wz = T(sc[SC_R + 6]) * px + T(sc[SC_R + 7]) * py
                 + T(sc[SC_R + 8]) * pz + T(sc[SC_T + 2]);

    // ---- re-rank the cached candidates at the current pose ----
    T cx[K], cy[K], cz[K], ds[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      cx[j] = s_cand[3 * j];
      cy[j] = s_cand[3 * j + 1];
      cz[j] = s_cand[3 * j + 2];
      const T dx = cx[j] - wx, dy = cy[j] - wy, dz = cz[j] - wz;
      ds[j] = s_ok[j]
                  ? dx * dx + dy * dy + dz * dz
                  : T(kInf);
    }
    // ---- iterated-min selection of the 5 nearest, lowest slot on ties ----
    T sx[5], sy[5], sz[5], d5 = kInf;
#pragma unroll
    for (int p = 0; p < 5; ++p) {
      T m = ds[0];
#pragma unroll
      for (int j = 1; j < K; ++j) m = min_(m, ds[j]);
      bool taken = false;
      sx[p] = sy[p] = sz[p] = 0;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (!taken && ds[j] <= m) {
          taken = true;
          sx[p] = cx[j];
          sy[p] = cy[j];
          sz[p] = cz[j];
          ds[j] = kInf;
        }
      }
      d5 = m;
    }
    const bool gate = d5 < T(sc[SC_MAXSQ]);

    // ---- 5-point centroid + covariance ----
    const T cxm = (sx[0] + sx[1] + sx[2] + sx[3] + sx[4]) * kFifth;
    const T cym = (sy[0] + sy[1] + sy[2] + sy[3] + sy[4]) * kFifth;
    const T czm = (sz[0] + sz[1] + sz[2] + sz[3] + sz[4]) * kFifth;
    Sym3<T> A = {0, 0, 0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const T dx = sx[i] - cxm, dy = sy[i] - cym, dz = sz[i] - czm;
      A.a00 += dx * dx;
      A.a01 += dx * dy;
      A.a02 += dx * dz;
      A.a11 += dy * dy;
      A.a12 += dy * dz;
      A.a22 += dz * dz;
    }
    if (kCorner) {  // the reference divides the corner covariance by 5
      A.a00 *= kFifth; A.a01 *= kFifth; A.a02 *= kFifth;
      A.a11 *= kFifth; A.a12 *= kFifth; A.a22 *= kFifth;
    }

    // ---- closed-form symmetric 3x3 eigenvalues (utils/lin.eigvalsh3) ----
    const T q3 = (A.a00 + A.a11 + A.a22) / T(3);
    const T b00 = A.a00 - q3, b11 = A.a11 - q3, b22 = A.a22 - q3;
    const T p2 = b00 * b00 + b11 * b11 + b22 * b22
                 + T(2) * (A.a01 * A.a01 + A.a02 * A.a02 + A.a12 * A.a12);
    const T pp = sqrt_(max_(p2 / T(6), T(1e-30f)));
    const T det = b00 * (b11 * b22 - A.a12 * A.a12)
                  - A.a01 * (A.a01 * b22 - A.a12 * A.a02)
                  + A.a02 * (A.a01 * A.a12 - b11 * A.a02);
    const T rr = min_(max_(det / (T(2) * pp * pp * pp), T(-1)), T(1));
    const T phi = acos_(rr) / T(3);
    const T e_hi = q3 + T(2) * pp * cos_(phi);
    const T e_lo = q3 + T(2) * pp * cos_(phi + kThird2Pi);
    const T e_mid = T(3) * q3 - e_hi - e_lo;

    const T damping = sc[SC_DAMP], min_w = sc[SC_MINW];
    const T gate_p = sc[SC_GATE];
    T nx, ny, nz, s, resid0;
    bool ok;
    if (kCorner) {
      // line direction = principal eigenvector; residual = point-to-line
      T ux, uy, uz;
      projector_eigvec(A, e_mid, e_lo, ux, uy, uz);
      const T pcx = wx - cxm, pcy = wy - cym, pcz = wz - czm;
      const T cvx = pcy * uz - pcz * uy;
      const T cvy = pcz * ux - pcx * uz;
      const T cvz = pcx * uy - pcy * ux;
      const T dist = sqrt_(cvx * cvx + cvy * cvy + cvz * cvz);
      const T inv_d = T(1) / max_(dist, T(1e-12f));
      nx = (uy * cvz - uz * cvy) * inv_d;
      ny = (uz * cvx - ux * cvz) * inv_d;
      nz = (ux * cvy - uy * cvx) * inv_d;
      s = T(1) - damping * abs_(dist);
      resid0 = dist;
      ok = gate && (e_hi > gate_p * e_mid) && (s > min_w);
    } else {
      // TLS plane: normal = smallest eigenvector, d = -n . centroid
      projector_eigvec(A, e_hi, e_mid, nx, ny, nz);
      const T d_off = -(nx * cxm + ny * cym + nz * czm);
      bool plane_ok = true;
#pragma unroll
      for (int i = 0; i < 5; ++i)
        plane_ok = plane_ok &&
                   abs_(nx * sx[i] + ny * sy[i] + nz * sz[i] + d_off) <= gate_p;
      const T pd2 = nx * wx + ny * wy + nz * wz + d_off;
      const T range_damp =
          sqrt_(sqrt_(wx * wx + wy * wy + wz * wz + T(1e-12f)));
      s = T(1) - damping * abs_(pd2) / max_(range_damp, T(1e-6f));
      resid0 = pd2;
      ok = gate && plane_ok && (s > min_w);
    }

    if (ok) {
      const T sw = s * (weight != nullptr ? T(weight[qi]) : T(1));
      const T cfx = sw * nx, cfy = sw * ny, cfz = sw * nz;
      r = sw * resid0;
      okf = 1;
      // rotation columns: coeff . (dR/dangle @ p_sensor)
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float* m = sc + SC_MR + 9 * a;
        const T mx = T(m[0]) * px + T(m[1]) * py + T(m[2]) * pz;
        const T my = T(m[3]) * px + T(m[4]) * py + T(m[5]) * pz;
        const T mz = T(m[6]) * px + T(m[7]) * py + T(m[8]) * pz;
        J[a] = cfx * mx + cfy * my + cfz * mz;
      }
      J[3] = cfx;
      J[4] = cfy;
      J[5] = cfz;
    }
  }

  int t = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int b = a; b < 6; ++b) v[t++] = J[a] * J[b];
#pragma unroll
  for (int a = 0; a < 6; ++a) v[21 + a] = J[a] * (-r);
  v[27] = okf;

}

template <int K, typename T>
__global__ void __launch_bounds__(kThreads)
gn_iteration_kernel(const __grid_constant__ GnParams p) {
  constexpr int kRow = 3 * K + 1;  // odd stride: conflict-free row reads
  __shared__ float s_cand[kThreads * kRow];
  __shared__ uint8_t s_ok[kThreads * K];
  __shared__ T red[kWarps][kOut];
  __shared__ T tot[kOut];
  __shared__ bool s_last;
  const bool corner = blockIdx.x < p.cloud[0].n_blocks;
  const size_t lb = blockIdx.y;  // this block's lane of the batch
  const GnCloud& c0 = p.cloud[corner ? 0 : 1];
  const size_t qn = static_cast<size_t>(c0.q_n);
  const GnCloud c = {c0.pts + lb * qn * 3, c0.mask + lb * qn,
                     c0.cand + lb * qn * K * 3, c0.cand_ok + lb * qn * K,
                     c0.weight != nullptr ? c0.weight + lb * qn : nullptr,
                     c0.q_n, c0.n_blocks};
  const float* sc = p.rows != nullptr ? p.rows + lb * 128 + (corner ? 0 : 64)
                                      : p.sc[corner ? 0 : 1];
  T* partials = static_cast<T*>(p.partials) + lb * gridDim.x * kOut;
  unsigned int* ticket = p.ticket + lb;
  const int q0 = (corner ? blockIdx.x : blockIdx.x - p.cloud[0].n_blocks)
                 * kThreads;
  const int cnt = min(kThreads, c.q_n - q0);

  // ---- stage the block's candidate slab: 16-byte loads when aligned ----
  const float* src = c.cand + static_cast<size_t>(q0) * K * 3;
  const int nf = cnt * K * 3;
  int f0 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int j = threadIdx.x; j < nf / 4; j += kThreads) {
      const float4 x = s4[j];
      const float e[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int f = 4 * j + u;
        s_cand[(f / (3 * K)) * kRow + f % (3 * K)] = e[u];
      }
    }
    f0 = nf / 4 * 4;
  }
  for (int f = f0 + threadIdx.x; f < nf; f += kThreads)
    s_cand[(f / (3 * K)) * kRow + f % (3 * K)] = src[f];
  for (int j = threadIdx.x; j < cnt * K; j += kThreads)
    s_ok[j] = c.cand_ok[static_cast<size_t>(q0) * K + j];
  __syncthreads();

  T v[kOut];
  const int t = threadIdx.x;
  if (corner)
    row_terms<K, true, T>(c.pts, c.mask, c.weight, sc, q0 + t, t < cnt,
                       s_cand + t * kRow, s_ok + t * K, v);
  else
    row_terms<K, false, T>(c.pts, c.mask, c.weight, sc, q0 + t, t < cnt,
                        s_cand + t * kRow, s_ok + t * K, v);

  // ---- block reduction: warp shuffles, then warps in order ----
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kOut; ++i) {
    T x = v[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) red[warp][i] = x;
  }
  __syncthreads();
  if (threadIdx.x < kOut) {
    T acc = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc += red[w][threadIdx.x];
    partials[static_cast<size_t>(blockIdx.x) * kOut + threadIdx.x] = acc;
    __threadfence();  // this block's partials before its ticket
  }
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;

  // ---- the last block: sum each cloud's blocks in order, then add ----
  const int nb_c = p.cloud[0].n_blocks;
  for (int i = threadIdx.x; i < kOut; i += kThreads) {
    T ac = 0, as = 0;
    for (int b = 0; b < nb_c; ++b)
      ac += __ldcg(partials + static_cast<size_t>(b) * kOut + i);
    for (int b = nb_c; b < static_cast<int>(gridDim.x); ++b)
      as += __ldcg(partials + static_cast<size_t>(b) * kOut + i);
    tot[i] = ac + as;
  }
  __syncthreads();
  for (int o = threadIdx.x; o < kResult; o += kThreads) {
    T x;
    if (o < 36) {  // H[r][c] from the upper triangle, row-major
      const int a = min(o / 6, o % 6), b = max(o / 6, o % 6);
      x = tot[a * 6 - a * (a - 1) / 2 + (b - a)];
    } else {  // g, then n_valid
      x = tot[21 + (o - 36)];
    }
    p.out[lb * kResult + o] = static_cast<float>(x);
  }
  if (threadIdx.x == 0) *ticket = 0u;  // ready for the next launch
}

}  // namespace

// One GN iteration over the corner and surf clouds (either may have
// q_n = 0) of `lanes` lanes: pointers as in GnCloud (weights may be null:
// all ones), lane b's data at b times the lane's size past them; either
// `scalars` 128 floats on the host (the corner row, then the surf row;
// one lane) or `rows` (lanes, 2, 64) floats in device memory (null
// `scalars`); scratch partials (lanes x (ceil(q_c / kThreads) +
// ceil(q_s / kThreads)), 28) and tickets (lanes zeroed uint32, left
// zeroed); out (lanes, 43) = [H (6x6 row-major), g (6), n_valid] per lane.
// One launch. Returns a cudaError_t.
extern "C" int lis_gn_iteration(
    const float* c_pts, const uint8_t* c_mask, const float* c_cand,
    const uint8_t* c_ok, const float* c_w, int c_n,
    const float* s_pts, const uint8_t* s_mask, const float* s_cand,
    const uint8_t* s_ok, const float* s_w, int s_n, int k,
    const float* scalars, const float* rows, int lanes, int f64,
    void* partials, unsigned int* ticket, float* out, void* stream) {
  if (c_n < 0 || s_n < 0 || lanes < 1 || lanes > 65535
      || (scalars == nullptr) == (rows == nullptr)
      || (scalars != nullptr && lanes != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  GnParams p;
  p.cloud[0] = {c_pts, c_mask, c_cand, c_ok, c_w, c_n,
                (c_n + kThreads - 1) / kThreads};
  p.cloud[1] = {s_pts, s_mask, s_cand, s_ok, s_w, s_n,
                (s_n + kThreads - 1) / kThreads};
  for (int i = 0; i < 128; ++i)
    p.sc[i / 64][i % 64] = scalars != nullptr ? scalars[i] : 0.f;
  p.rows = rows;
  p.partials = partials;
  p.ticket = ticket;
  p.out = out;
  const int n_blocks = p.cloud[0].n_blocks + p.cloud[1].n_blocks;
  if (n_blocks == 0)
    return static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(lanes) * kResult * sizeof(float), st));
  const dim3 grid(n_blocks, lanes);
  switch (k * 2 + (f64 != 0)) {
    case 16:
      gn_iteration_kernel<8, float><<<grid, kThreads, 0, st>>>(p);
      break;
    case 17:
      gn_iteration_kernel<8, double><<<grid, kThreads, 0, st>>>(p);
      break;
    case 20:
      gn_iteration_kernel<10, float><<<grid, kThreads, 0, st>>>(p);
      break;
    case 21:
      gn_iteration_kernel<10, double><<<grid, kThreads, 0, st>>>(p);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Threads (queries) per block, so the caller can size the partials
// scratch.
extern "C" int lis_gn_block_size() { return kThreads; }
