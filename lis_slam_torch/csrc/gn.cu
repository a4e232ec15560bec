// K2: fused Gauss-Newton correspondence accumulation for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lis_slam_tpu/ops/pallas_gn.py:_gn_kernel
// (launched by gn_partials, called by gn_iteration_hg once per cloud per GN
// iteration). Per query, the whole LOAM iteration body of
// cornerOptimization / surfOptimization (odomEstimationNode.cpp:633-827):
//   transform by the pose -> re-rank the k cached candidates and take the
//   5 nearest by iterated min (lowest slot on ties) -> gate on the 5th
//   distance -> 5-point centroid + covariance (corner / 5, surf raw sum)
//   -> closed-form 3x3 eigenvalues -> projector eigenvector (first-max
//   column) -> corner point-to-line or surf TLS plane -> damping and gates
//   -> weighted Jacobian row J (6) and residual r.
// Output: per block, the 21 upper-triangle entries of sum J^T J, the 6 of
// sum J^T (-r) and n_valid (28 floats); a second kernel sums the blocks in
// a fixed order. No atomics, so H is bit-reproducible from run to run.
//
// What bounds it on the H100: not bytes (a 2048-query cloud reads ~300 KB)
// but latency — a few hundred dependent fp32 ops per query, including
// sqrt/acos/cos, over only 2048 threads. Design: one thread per query with
// the k candidates in registers (k is a template parameter, so the
// selection network unrolls), 64-thread blocks so even 1024 queries spread
// over 16 SMs, and the 28 sums reduced in the block by warp shuffles and a
// small shared-memory pass, so only n_blocks x 28 floats reach memory.
// Inputs keep the JAX public layout ((Q,3), (Q,k,3), ...), not the TPU's
// transposed (3k, Qp) lanes. Built without --use_fast_math (the closed-form
// acos/cos eigenvalues are sensitive to it) and with --fmad=false, so each
// product rounds as in the plain PyTorch version: surf rows whose five
// neighbours are nearly collinear have an ill-defined plane normal, and
// there any rounding difference picks another normal.
// Later work: more queries per SM (two clouds per launch), fusing the 6x6
// solve and degeneracy clamp into the same launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 64;
constexpr int kWarps = kThreads / 32;
constexpr int kOut = 28;  // 21 H upper triangle, 6 g, n_valid
constexpr float kInf = 3e38f;

// scalar row layout (ops/gn_cuda.py:pack_scalars, as pallas_gn.py:47-59)
constexpr int SC_R = 0, SC_T = 9, SC_MR = 12, SC_MP = 21, SC_MY = 30;
constexpr int SC_MAXSQ = 39, SC_DAMP = 40, SC_MINW = 41, SC_GATE = 42;

struct Sym3 {
  float a00, a01, a02, a11, a12, a22;
};

// Unit nonzero column of (A - s1 I)(A - s2 I), the first one of maximal
// norm (jnp.argmax semantics, utils/lin.py principal/smallest_eigvec3).
__device__ __forceinline__ void projector_eigvec(const Sym3& A, float s1,
                                                 float s2, float& vx,
                                                 float& vy, float& vz) {
  const float b00 = A.a00 - s1, b11 = A.a11 - s1, b22 = A.a22 - s1;
  const float c00 = A.a00 - s2, c11 = A.a11 - s2, c22 = A.a22 - s2;
  const float a01 = A.a01, a02 = A.a02, a12 = A.a12;
  const float p00 = b00 * c00 + a01 * a01 + a02 * a02;
  const float p10 = a01 * c00 + b11 * a01 + a12 * a02;
  const float p20 = a02 * c00 + a12 * a01 + b22 * a02;
  const float p01 = b00 * a01 + a01 * c11 + a02 * a12;
  const float p11 = a01 * a01 + b11 * c11 + a12 * a12;
  const float p21 = a02 * a01 + a12 * c11 + b22 * a12;
  const float p02 = b00 * a02 + a01 * a12 + a02 * c22;
  const float p12 = a01 * a02 + b11 * a12 + a12 * c22;
  const float p22 = a02 * a02 + a12 * a12 + b22 * c22;
  const float n0 = sqrtf(p00 * p00 + p10 * p10 + p20 * p20);
  const float n1 = sqrtf(p01 * p01 + p11 * p11 + p21 * p21);
  const float n2 = sqrtf(p02 * p02 + p12 * p12 + p22 * p22);
  if (n0 >= n1 && n0 >= n2) {
    vx = p00; vy = p10; vz = p20;
  } else if (n1 >= n2) {
    vx = p01; vy = p11; vz = p21;
  } else {
    vx = p02; vy = p12; vz = p22;
  }
  const float inv_n = 1.f / fmaxf(sqrtf(vx * vx + vy * vy + vz * vz), 1e-20f);
  vx *= inv_n;
  vy *= inv_n;
  vz *= inv_n;
}

template <int K, bool kCorner>
__global__ void __launch_bounds__(kThreads)
gn_partials_kernel(const float* __restrict__ pts,
                   const uint8_t* __restrict__ mask,
                   const float* __restrict__ cand,
                   const uint8_t* __restrict__ cand_ok,
                   const float* __restrict__ weight,
                   const float* __restrict__ sc, int q_n,
                   float* __restrict__ partials) {
  __shared__ float red[kWarps][kOut];
  const int qi = blockIdx.x * kThreads + threadIdx.x;
  float J[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float r = 0.f, okf = 0.f;

  if (qi < q_n && mask[qi]) {
    const float px = pts[3 * qi], py = pts[3 * qi + 1], pz = pts[3 * qi + 2];
    const float wx = sc[SC_R + 0] * px + sc[SC_R + 1] * py + sc[SC_R + 2] * pz
                     + sc[SC_T + 0];
    const float wy = sc[SC_R + 3] * px + sc[SC_R + 4] * py + sc[SC_R + 5] * pz
                     + sc[SC_T + 1];
    const float wz = sc[SC_R + 6] * px + sc[SC_R + 7] * py + sc[SC_R + 8] * pz
                     + sc[SC_T + 2];

    // ---- re-rank the cached candidates at the current pose ----
    float cx[K], cy[K], cz[K], ds[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const size_t o = (static_cast<size_t>(qi) * K + j) * 3;
      cx[j] = cand[o];
      cy[j] = cand[o + 1];
      cz[j] = cand[o + 2];
      const float dx = cx[j] - wx, dy = cy[j] - wy, dz = cz[j] - wz;
      ds[j] = cand_ok[static_cast<size_t>(qi) * K + j]
                  ? dx * dx + dy * dy + dz * dz
                  : kInf;
    }
    // ---- iterated-min selection of the 5 nearest, lowest slot on ties ----
    float sx[5], sy[5], sz[5], d5 = kInf;
#pragma unroll
    for (int p = 0; p < 5; ++p) {
      float m = ds[0];
#pragma unroll
      for (int j = 1; j < K; ++j) m = fminf(m, ds[j]);
      bool taken = false;
      sx[p] = sy[p] = sz[p] = 0.f;
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
    const bool gate = d5 < sc[SC_MAXSQ];

    // ---- 5-point centroid + covariance ----
    const float cxm = (sx[0] + sx[1] + sx[2] + sx[3] + sx[4]) * 0.2f;
    const float cym = (sy[0] + sy[1] + sy[2] + sy[3] + sy[4]) * 0.2f;
    const float czm = (sz[0] + sz[1] + sz[2] + sz[3] + sz[4]) * 0.2f;
    Sym3 A = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const float dx = sx[i] - cxm, dy = sy[i] - cym, dz = sz[i] - czm;
      A.a00 += dx * dx;
      A.a01 += dx * dy;
      A.a02 += dx * dz;
      A.a11 += dy * dy;
      A.a12 += dy * dz;
      A.a22 += dz * dz;
    }
    if (kCorner) {  // the reference divides the corner covariance by 5
      A.a00 *= 0.2f; A.a01 *= 0.2f; A.a02 *= 0.2f;
      A.a11 *= 0.2f; A.a12 *= 0.2f; A.a22 *= 0.2f;
    }

    // ---- closed-form symmetric 3x3 eigenvalues (utils/lin.eigvalsh3) ----
    const float q3 = (A.a00 + A.a11 + A.a22) / 3.f;
    const float b00 = A.a00 - q3, b11 = A.a11 - q3, b22 = A.a22 - q3;
    const float p2 = b00 * b00 + b11 * b11 + b22 * b22
                     + 2.f * (A.a01 * A.a01 + A.a02 * A.a02 + A.a12 * A.a12);
    const float pp = sqrtf(fmaxf(p2 / 6.f, 1e-30f));
    const float det = b00 * (b11 * b22 - A.a12 * A.a12)
                      - A.a01 * (A.a01 * b22 - A.a12 * A.a02)
                      + A.a02 * (A.a01 * A.a12 - b11 * A.a02);
    const float rr = fminf(fmaxf(det / (2.f * pp * pp * pp), -1.f), 1.f);
    const float phi = acosf(rr) / 3.f;
    const float e_hi = q3 + 2.f * pp * cosf(phi);
    const float e_lo = q3 + 2.f * pp * cosf(phi + 2.0943951023931953f);
    const float e_mid = 3.f * q3 - e_hi - e_lo;

    const float damping = sc[SC_DAMP], min_w = sc[SC_MINW];
    const float gate_p = sc[SC_GATE];
    float nx, ny, nz, s, resid0;
    bool ok;
    if (kCorner) {
      // line direction = principal eigenvector; residual = point-to-line
      float ux, uy, uz;
      projector_eigvec(A, e_mid, e_lo, ux, uy, uz);
      const float pcx = wx - cxm, pcy = wy - cym, pcz = wz - czm;
      const float cvx = pcy * uz - pcz * uy;
      const float cvy = pcz * ux - pcx * uz;
      const float cvz = pcx * uy - pcy * ux;
      const float dist = sqrtf(cvx * cvx + cvy * cvy + cvz * cvz);
      const float inv_d = 1.f / fmaxf(dist, 1e-12f);
      nx = (uy * cvz - uz * cvy) * inv_d;
      ny = (uz * cvx - ux * cvz) * inv_d;
      nz = (ux * cvy - uy * cvx) * inv_d;
      s = 1.f - damping * fabsf(dist);
      resid0 = dist;
      ok = gate && (e_hi > gate_p * e_mid) && (s > min_w);
    } else {
      // TLS plane: normal = smallest eigenvector, d = -n . centroid
      projector_eigvec(A, e_hi, e_mid, nx, ny, nz);
      const float d_off = -(nx * cxm + ny * cym + nz * czm);
      bool plane_ok = true;
#pragma unroll
      for (int i = 0; i < 5; ++i)
        plane_ok = plane_ok &&
                   fabsf(nx * sx[i] + ny * sy[i] + nz * sz[i] + d_off) <= gate_p;
      const float pd2 = nx * wx + ny * wy + nz * wz + d_off;
      const float range_damp = sqrtf(sqrtf(wx * wx + wy * wy + wz * wz + 1e-12f));
      s = 1.f - damping * fabsf(pd2) / fmaxf(range_damp, 1e-6f);
      resid0 = pd2;
      ok = gate && plane_ok && (s > min_w);
    }

    if (ok) {
      const float sw = s * weight[qi];
      const float cfx = sw * nx, cfy = sw * ny, cfz = sw * nz;
      r = sw * resid0;
      okf = 1.f;
      // rotation columns: coeff . (dR/dangle @ p_sensor)
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float* m = sc + SC_MR + 9 * a;
        const float mx = m[0] * px + m[1] * py + m[2] * pz;
        const float my = m[3] * px + m[4] * py + m[5] * pz;
        const float mz = m[6] * px + m[7] * py + m[8] * pz;
        J[a] = cfx * mx + cfy * my + cfz * mz;
      }
      J[3] = cfx;
      J[4] = cfy;
      J[5] = cfz;
    }
  }

  float v[kOut];
  int t = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int b = a; b < 6; ++b) v[t++] = J[a] * J[b];
#pragma unroll
  for (int a = 0; a < 6; ++a) v[21 + a] = J[a] * (-r);
  v[27] = okf;

  // ---- block reduction: warp shuffles, then warps in order ----
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kOut; ++i) {
    float x = v[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) red[warp][i] = x;
  }
  __syncthreads();
  if (threadIdx.x < kOut) {
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc += red[w][threadIdx.x];
    partials[static_cast<size_t>(blockIdx.x) * kOut + threadIdx.x] = acc;
  }
}

// Sum the (n_blocks, 28) partials block by block, in order.
__global__ void gn_sum_kernel(const float* __restrict__ partials,
                              int n_blocks, float* __restrict__ out) {
  const int t = threadIdx.x;
  if (t >= kOut) return;
  float acc = 0.f;
  for (int b = 0; b < n_blocks; ++b) acc += partials[b * kOut + t];
  out[t] = acc;
}

template <int K>
cudaError_t launch(const float* pts, const uint8_t* mask, const float* cand,
                   const uint8_t* cand_ok, const float* weight,
                   const float* scalars, int q_n, bool corner,
                   float* partials, float* out, cudaStream_t stream) {
  const int n_blocks = (q_n + kThreads - 1) / kThreads;
  if (n_blocks > 0) {
    if (corner)
      gn_partials_kernel<K, true><<<n_blocks, kThreads, 0, stream>>>(
          pts, mask, cand, cand_ok, weight, scalars, q_n, partials);
    else
      gn_partials_kernel<K, false><<<n_blocks, kThreads, 0, stream>>>(
          pts, mask, cand, cand_ok, weight, scalars, q_n, partials);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  gn_sum_kernel<<<1, 32, 0, stream>>>(partials, n_blocks, out);
  return cudaGetLastError();
}

}  // namespace

// pts (q_n, 3), mask (q_n,) bool bytes, cand (q_n, k, 3), cand_ok (q_n, k)
// bool bytes, weight (q_n,), scalars (64,) all f32 unless noted; scratch
// partials (ceil(q_n / 64), 28); out (28,) = [H upper triangle row-major,
// g, n_valid]. Returns a cudaError_t (0 on success).
extern "C" int lis_gn_partials(const float* pts, const uint8_t* mask,
                               const float* cand, const uint8_t* cand_ok,
                               const float* weight, const float* scalars,
                               int q_n, int k, int corner, float* partials,
                               float* out, void* stream) {
  if (q_n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define LIS_GN_CASE(KV)                                                    \
  case KV:                                                                 \
    return static_cast<int>(launch<KV>(pts, mask, cand, cand_ok, weight,   \
                                       scalars, q_n, corner != 0,          \
                                       partials, out, st));
  switch (k) {
    LIS_GN_CASE(8)
    LIS_GN_CASE(10)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LIS_GN_CASE
}

// Threads per block of gn_partials_kernel, so the caller can size the
// partials scratch.
extern "C" int lis_gn_block_size() { return kThreads; }
