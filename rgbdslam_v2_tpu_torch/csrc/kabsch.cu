// Weighted Kabsch fits for Hopper (sm_90a), two entry points that share the
// double-precision 3x3 code below.
//
// 1. weighted_kabsch_f32: for each problem b, the rigid T_b = [R t; 0 1]
//    minimising sum_n w_bn |R src_bn + t - dst_bn|^2.
//
//    Replaces core/alignment.weighted_kabsch's torch.linalg.svd + det (the
//    JAX function is rgbdslam_v2_tpu/core/alignment.py::weighted_kabsch, an
//    XLA SVD; it has no Pallas source). cuSOLVER's batched SVD and det check
//    their status on the host, two device->host waits a call; this kernel
//    makes none, so a step that calls it can be captured as a CUDA graph.
//
//    What it computes, as the plain torch version (weighted_kabsch_plain):
//      w <- max(w, 0); mu_s = sum w src / (sum w + 1e-12), mu_d likewise;
//      H = sum w (src - mu_s)(dst - mu_d)^T / (sum w + 1e-12);
//      H = U S V^T;  R = V diag(1, 1, det(V U^T)) U^T;  t = mu_d - R mu_s.
//    What bounds it on the card: nothing but latency. A fit reads B*N*7
//    floats (8*300*7*4 = 67 KB, 0.02 us at 3.35 TB/s) and does ~30 flops a
//    point. One block of 128 threads per problem: a strided pass sums the
//    weights and weighted points, a second the cross-covariance (both
//    warp-shuffle reductions, then across the 4 warps in shared memory);
//    thread 0 does the 3x3 part.
//
// 2. ransac_refine_f32: the refinement and final score of one RANSAC
//    registration a candidate, in one launch for all candidates: what
//    ops/registration.ransac_refine_plain computes (the JAX loop is the
//    refine_step scan and the final gate of
//    rgbdslam_v2_tpu/ops/registration.py::ransac_register, :262-279 and
//    :306-311; it has no Pallas source). Starting from the hypothesis
//    sweep's T and inliers, `iterations` times:
//      w = inliers ? w_depth : 0;  T2 = the weighted Kabsch fit;
//      m2 = (T2 src - dst)^T Sigma^-1 (T2 src - dst), Sigma = D_dst + R D_src R^T
//           (adjugate solve, |det| < 1e-18 clamped to 1e-18);
//      inl2 = valid & (m2 < max_mahal_sq);
//      where count(inl2) >= 3: T = T2, inliers = inl2;
//    then the final gate of T gives inliers, their count and
//    rmse = sqrt(sum of inlier m2 / max(count, 1)).
//    What bounds it on the card: latency again. It reads each match once
//    (14 values, ~55 B; 8 x 300 matches = 133 KB, 0.04 us at 3.35 TB/s) and
//    does ~660 flops a match over the loop, but every step depends on the
//    one before it: a fit needs the whole candidate's sums, and its 3x3 SVD
//    is a chain of dependent double-precision divisions and square roots.
//    Design: one 256-thread block a candidate. The matches are staged once
//    into shared memory with cp.async (read from global memory instead
//    where they do not fit in 48 KB); each thread owns the matches
//    tid + k*256 and keeps their inlier flags as bits of a register, so the
//    loop reads no mask from memory. A fit is ONE pass over the staged
//    matches that accumulates the 16 moments sum w, sum w s, sum w d and
//    sum w s d^T in double, about the first valid match (the centroids sit
//    2-6 m from the camera; the shift keeps their products from
//    cancelling), one shuffle-and-shared-memory reduction, then warp 0
//    solves the 3x3 part while the other warps wait at one barrier. The
//    gate evaluates m2 in
//    double over the staged matches and counts with __syncthreads_count;
//    the keep-or-not choice is a register select. One write of the outputs,
//    no host sync: the launch can be captured in a CUDA graph.
//
//    With projective_iterations > 0 (g2o_transformation_refinement) a
//    stage runs between the last refit and the final gate, what
//    ops/projective.refine_projective and the projective branch of
//    ops/registration.ransac_refine_plain compute (JAX
//    rgbdslam_v2_tpu/ops/registration.py:280-305 and
//    rgbdslam_v2_tpu/ops/projective.py:59-153, no Pallas source): the gate
//    of T gives the inliers; each inlier's landmark starts at its new-frame
//    point backprojected from (u, v, z); then `projective_iterations` times
//    every thread takes one 3x3 Gauss-Newton step of each of its own
//    landmarks (pixel and depth residuals in both cameras, information
//    diag(1, 1, 1/(sigma_depth max(z, 0.3)^2)^2), damping 1e-6, the 3x3
//    solved by pivoted elimination) and adds its matches' terms of the 6x6
//    pose system (21 + 6 doubles); one block reduction, then thread 0
//    solves the 6x6 by pivoted elimination, drops a step that is not finite
//    or has |xi| >= 1, and applies exp_se3(xi) on the left. T takes the
//    result where its gate keeps no fewer inliers. The stage computes in
//    double (JAX: float32) and keeps the landmarks in a float64 scratch
//    array of (B, M, 3) in global memory (L2-resident at 8 x 300: 58 KB).
//    It is a template branch: the launch with projective_iterations == 0
//    is the kernel without it. What bounds it: latency again; each
//    iteration is ~330 double operations a match and a block reduction
//    and a 6x6 solve on one thread that every thread waits for.
//
// The 3x3 SVD (both entries) is taken in registers: cyclic Jacobi on H^T H
// gives V and the singular values in descending order; u1 = H v1 / |H v1|,
// u2 is H v2 made orthogonal to u1 and normalised, u3 = u1 x u2. Then
//   R = v1 u1^T + v2 u2^T + det(V) v3 u3^T,
// which is V diag(1, 1, det(V U^T)) U^T for this U (det U = +1) and does
// not depend on the signs of v3 or u3. Degenerate H: a zero H (no positive
// weight) gives u_i = v_i, hence R = I (as LAPACK's SVD of a zero matrix);
// a rank-1 H completes u2 orthogonally, so R is still a proper rotation.
// Sums and the 3x3 algebra run in double, so the result is finite for any
// finite input; points of weight <= 0 add nothing.
//
// C entries (contiguous device arrays, row major; each returns
// cudaGetLastError() after its launch, or -2 for arguments it refuses):
//   weighted_kabsch_f32(src, dst, w, out, B, N, stream): src, dst (B, N, 3)
//     and w (B, N) float32, out (B, 4, 4) float32.
//   ransac_refine_f32(src, dst, w_depth, src_cov, dst_cov, valid, T_in,
//     inl_in, T_out, inl_out, n_out, rmse_out, B, M, iterations,
//     max_mahal_sq, proj_iterations, fx, fy, cx, cy, sigma_depth,
//     landmarks, stream): src, dst, src_cov, dst_cov (B, M, 3) and
//     w_depth (B, M) float32; valid, inl_in, inl_out (B, M) bytes (0/1);
//     T_in, T_out (B, 4, 4) float32; n_out (B,) int32; rmse_out (B,)
//     float32; M <= REFINE_MAX_M; landmarks (B, M, 3) float64 scratch,
//     needed only where proj_iterations > 0 (fx .. cx, cy the
//     full-resolution intrinsics of the projective stage).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

template <int K>
__device__ void block_sum(double (&v)[K], double (*sh)[K]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) sh[warp][k] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    double s = 0.0;
#pragma unroll
    for (int i = 0; i < WARPS; ++i) s += sh[i][k];
    v[k] = s;  // every thread holds the block's sums
  }
  __syncthreads();
}

__device__ void normalize3(double* a) {
  const double n = sqrt(a[0] * a[0] + a[1] * a[1] + a[2] * a[2]);
  a[0] /= n;
  a[1] /= n;
  a[2] /= n;
}

__device__ double dot3(const double* a, const double* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ void cross3(const double* a, const double* b, double* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// Eigen-decomposition of the symmetric 3x3 A (destroyed) by cyclic Jacobi:
// columns of V are the eigenvectors, lam the eigenvalues, both sorted by
// descending eigenvalue.
__device__ void jacobi_eigen3(double (&A)[3][3], double (&V)[3][3], double (&lam)[3]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) V[i][j] = i == j ? 1.0 : 0.0;
  for (int sweep = 0; sweep < 16; ++sweep) {
    const double off = A[0][1] * A[0][1] + A[0][2] * A[0][2] + A[1][2] * A[1][2];
    const double diag = A[0][0] * A[0][0] + A[1][1] * A[1][1] + A[2][2] * A[2][2];
    if (!(off > 1e-30 * diag)) break;  // also stops on a zero matrix
    for (int pq = 0; pq < 3; ++pq) {
      const int p = pq == 2 ? 1 : 0, q = pq == 0 ? 1 : 2;
      const double apq = A[p][q];
      if (apq == 0.0) continue;
      // t = tan of the angle that zeroes A[p][q], the smaller root of
      // t^2 + 2 d t / apq - 1 = 0: one division, one square root and one
      // reciprocal square root, the chain every rotation waits on
      const double d = 0.5 * (A[q][q] - A[p][p]);
      const double r = sqrt(d * d + apq * apq);
      const double t = apq / (d >= 0.0 ? d + r : d - r);
      const double c = rsqrt(1.0 + t * t), s = t * c;
      for (int k = 0; k < 3; ++k) {  // A <- A P
        const double akp = A[k][p], akq = A[k][q];
        A[k][p] = c * akp - s * akq;
        A[k][q] = s * akp + c * akq;
      }
      for (int k = 0; k < 3; ++k) {  // A <- P^T A
        const double apk = A[p][k], aqk = A[q][k];
        A[p][k] = c * apk - s * aqk;
        A[q][k] = s * apk + c * aqk;
      }
      for (int k = 0; k < 3; ++k) {  // V <- V P
        const double vkp = V[k][p], vkq = V[k][q];
        V[k][p] = c * vkp - s * vkq;
        V[k][q] = s * vkp + c * vkq;
      }
    }
  }
  for (int i = 0; i < 3; ++i) lam[i] = A[i][i];
  for (int i = 0; i < 2; ++i)  // selection sort, descending
    for (int j = i + 1; j < 3; ++j)
      if (lam[j] > lam[i]) {
        const double tl = lam[i];
        lam[i] = lam[j];
        lam[j] = tl;
        for (int k = 0; k < 3; ++k) {
          const double tv = V[k][i];
          V[k][i] = V[k][j];
          V[k][j] = tv;
        }
      }
}

// R = V diag(1, 1, det(V U^T)) U^T for the cross-covariance H = U S V^T.
__device__ void kabsch_rotation(const double (&H)[3][3], double (&R)[3][3]) {
  double A[3][3];  // H^T H
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) A[r][c] = H[0][r] * H[0][c] + H[1][r] * H[1][c] + H[2][r] * H[2][c];
  double V[3][3], lam[3];
  jacobi_eigen3(A, V, lam);
  double v[3][3];  // v[i] = i-th right singular vector
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k) v[i][k] = V[k][i];

  double u1[3], u2[3], u3[3], hv2[3];
  for (int k = 0; k < 3; ++k) {
    u1[k] = dot3(H[k], v[0]);
    hv2[k] = dot3(H[k], v[1]);
  }
  const double n1 = sqrt(dot3(u1, u1));
  if (n1 > 0.0) {
    for (int k = 0; k < 3; ++k) u1[k] /= n1;
  } else {  // zero H: R = I
    for (int k = 0; k < 3; ++k) u1[k] = v[0][k];
  }
  double p = dot3(u1, hv2);
  for (int k = 0; k < 3; ++k) u2[k] = hv2[k] - p * u1[k];
  if (!(sqrt(dot3(u2, u2)) > 1e-12 * n1)) {
    // rank <= 1: complete u1 with v2 (or, failing that, the axis least
    // aligned with u1) made orthogonal to it
    p = dot3(u1, v[1]);
    for (int k = 0; k < 3; ++k) u2[k] = v[1][k] - p * u1[k];
    if (!(dot3(u2, u2) > 0.25)) {
      int ax = 0;
      for (int k = 1; k < 3; ++k)
        if (fabs(u1[k]) < fabs(u1[ax])) ax = k;
      for (int k = 0; k < 3; ++k) u2[k] = (k == ax ? 1.0 : 0.0) - u1[ax] * u1[k];
    }
  }
  normalize3(u2);
  cross3(u1, u2, u3);
  double c23[3];
  cross3(v[1], v[2], c23);
  const double det_v = dot3(v[0], c23) >= 0.0 ? 1.0 : -1.0;
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      R[r][c] = v[0][r] * u1[c] + v[1][r] * u2[c] + det_v * v[2][r] * u3[c];
}

__global__ void __launch_bounds__(THREADS)
kabsch_kernel(const float* __restrict__ src, const float* __restrict__ dst,
              const float* __restrict__ w, float* __restrict__ out, int N) {
  __shared__ double sh7[WARPS][7];
  __shared__ double sh9[WARPS][9];
  const size_t b = blockIdx.x;
  src += b * N * 3;
  dst += b * N * 3;
  w += b * N;

  // pass 1: sum w, sum w src, sum w dst
  double m[7] = {0, 0, 0, 0, 0, 0, 0};
  for (int i = threadIdx.x; i < N; i += THREADS) {
    const float wi = w[i];
    if (wi > 0.0f) {
      m[0] += wi;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        m[1 + k] += static_cast<double>(wi) * src[3 * i + k];
        m[4 + k] += static_cast<double>(wi) * dst[3 * i + k];
      }
    }
  }
  block_sum<7>(m, sh7);
  const double wsum = m[0] + 1e-12;
  const double mu_s[3] = {m[1] / wsum, m[2] / wsum, m[3] / wsum};
  const double mu_d[3] = {m[4] / wsum, m[5] / wsum, m[6] / wsum};

  // pass 2: the centred cross-covariance
  double h[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  for (int i = threadIdx.x; i < N; i += THREADS) {
    const float wi = w[i];
    if (wi > 0.0f) {
      double sc[3], dc[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        sc[k] = static_cast<double>(wi) * (src[3 * i + k] - mu_s[k]);
        dc[k] = dst[3 * i + k] - mu_d[k];
      }
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int c = 0; c < 3; ++c) h[3 * r + c] += sc[r] * dc[c];
    }
  }
  block_sum<9>(h, sh9);
  if (threadIdx.x != 0) return;

  double H[3][3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) H[r][c] = h[3 * r + c] / wsum;
  double R[3][3];
  kabsch_rotation(H, R);
  float* T = out + b * 16;
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) T[4 * r + c] = static_cast<float>(R[r][c]);
    T[4 * r + 3] = static_cast<float>(mu_d[r] - dot3(R[r], mu_s));
  }
  T[12] = 0.0f;
  T[13] = 0.0f;
  T[14] = 0.0f;
  T[15] = 1.0f;
}

// ---- ransac_refine ------------------------------------------------------

constexpr int RT = 256;              // threads of a refine block
constexpr int RWARPS = RT / 32;
constexpr int BITS = 64;             // inlier flags a thread keeps in one register
constexpr int REFINE_MAX_M = RT * BITS;
constexpr int STAGE_FLOATS = 13;     // src 3, dst 3, src_cov 3, dst_cov 3, w_depth 1
constexpr size_t STAGE_MAX_BYTES = 48 * 1024;  // the default dynamic shared memory limit

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The candidate's matches: five arrays in shared memory (staged) or in
// global memory (too many to stage).
struct Matches {
  const float *src, *dst, *scov, *dcov, *w;
};

// Squared Mahalanobis distance of match i under T (3x4, row major, double):
// diff = R s + t - d, Sigma = D_dst + R D_src R^T, diff^T adj(Sigma) diff
// / det(Sigma) with |det| < 1e-18 clamped to 1e-18 (ops/registration.py
// _sym3_solve and mahalanobis_sq).
__device__ double mahalanobis_sq(const double (&T)[12], const Matches& m, int i) {
  double s[3], sc[3], diff[3];
  for (int k = 0; k < 3; ++k) {
    s[k] = m.src[3 * i + k];
    sc[k] = m.scov[3 * i + k];
  }
  for (int r = 0; r < 3; ++r)
    diff[r] = T[4 * r] * s[0] + T[4 * r + 1] * s[1] + T[4 * r + 2] * s[2] + T[4 * r + 3]
              - m.dst[3 * i + r];
  double S[3][3];  // upper triangle
  for (int r = 0; r < 3; ++r)
    for (int c = r; c < 3; ++c)
      S[r][c] = T[4 * r] * sc[0] * T[4 * c] + T[4 * r + 1] * sc[1] * T[4 * c + 1]
                + T[4 * r + 2] * sc[2] * T[4 * c + 2] + (r == c ? m.dcov[3 * i + r] : 0.0);
  const double a = S[0][0], b = S[0][1], c = S[0][2], e = S[1][1], f = S[1][2], ii = S[2][2];
  const double A = e * ii - f * f, B = c * f - b * ii, C = b * f - c * e;
  double det = a * A + b * B + c * C;
  if (fabs(det) < 1e-18) det = 1e-18;
  const double E = a * ii - c * c, F = b * c - a * f, I = a * e - b * b;
  const double x0 = A * diff[0] + B * diff[1] + C * diff[2];
  const double x1 = B * diff[0] + E * diff[1] + F * diff[2];
  const double x2 = C * diff[0] + F * diff[1] + I * diff[2];
  return (diff[0] * x0 + diff[1] * x1 + diff[2] * x2) / det;
}

// The gate of T over this thread's matches: bit k set where match tid + k*RT
// is valid and its m2 < thr; returns the block's count (every thread), and
// adds the passing matches' m2 to *m2_sum where that is given.
__device__ int gate(const double (&T)[12], const Matches& m, uint64_t valid, int rounds,
                    double thr, uint64_t* bits, double* m2_sum) {
  int count = 0;
  uint64_t out = 0;
  for (int k = 0; k < rounds; ++k) {
    int pass = 0;
    if ((valid >> k) & 1u) {
      const double m2 = mahalanobis_sq(T, m, threadIdx.x + k * RT);
      if (m2 < thr) {
        pass = 1;
        if (m2_sum) *m2_sum += m2;
      }
    }
    out |= static_cast<uint64_t>(pass) << k;
    count += __syncthreads_count(pass);
  }
  *bits = out;
  return count;
}

// ---- the projective stage -----------------------------------------------

struct ProjParams {
  int iterations;
  double fx, fy, cx, cy, sigma_depth;
};

constexpr double PROJ_DAMPING = 1e-6;
constexpr int PROJ_TERMS = 27;  // the 6x6 pose system: 21 upper-triangle terms + 6

// (u, v, z) of a camera-frame point (ops/projective.uvz_from_xyz)
__device__ void uvz3(const float* x, const ProjParams& pp, double (&o)[3]) {
  const double x0 = x[0], x1 = x[1], x2 = x[2];
  const double z = fabs(x2) < 1e-6 ? 1e-6 : x2;
  o[0] = pp.fx * x0 / z + pp.cx;
  o[1] = pp.fy * x1 / z + pp.cy;
  o[2] = x2;
}

// diag(1, 1, 1/sigma_z^2), sigma_z = sigma_depth max(z, 0.3)^2
__device__ void info3(double z, const ProjParams& pp, double (&W)[3]) {
  const double zc = z > 0.3 ? z : 0.3;
  const double sz = pp.sigma_depth * zc * zc;
  W[0] = 1.0;
  W[1] = 1.0;
  W[2] = 1.0 / (sz * sz);
}

// The residual (u(q) - u, v(q) - v, qz - z) of one observation and rows 0
// and 1 of its Jacobian in q (row 2 is (0, 0, 1)); ops/projective.py
// _proj_residual_jac.
__device__ void proj_residual(const double (&q)[3], const double (&meas)[3],
                              const ProjParams& pp, double (&r)[3], double (&J)[2][3]) {
  const double qz = fabs(q[2]) < 1e-6 ? 1e-6 : q[2];
  r[0] = pp.fx * q[0] / qz + pp.cx - meas[0];
  r[1] = pp.fy * q[1] / qz + pp.cy - meas[1];
  r[2] = q[2] - meas[2];
  J[0][0] = pp.fx / qz;
  J[0][1] = 0.0;
  J[0][2] = -pp.fx * q[0] / (qz * qz);
  J[1][0] = 0.0;
  J[1][1] = pp.fy / qz;
  J[1][2] = -pp.fy * q[1] / (qz * qz);
}

// b <- A^-1 b by Gaussian elimination with partial pivoting (A destroyed);
// a zero pivot gives non-finite values, which the callers' guards see.
template <int N>
__device__ void solve_pivoted(double (&A)[N][N], double (&b)[N]) {
  for (int c = 0; c < N; ++c) {
    int piv = c;
    for (int r = c + 1; r < N; ++r)
      if (fabs(A[r][c]) > fabs(A[piv][c])) piv = r;
    if (piv != c) {
      for (int k = 0; k < N; ++k) {
        const double t = A[c][k];
        A[c][k] = A[piv][k];
        A[piv][k] = t;
      }
      const double t = b[c];
      b[c] = b[piv];
      b[piv] = t;
    }
    for (int r = c + 1; r < N; ++r) {
      const double f = A[r][c] / A[c][c];
      for (int k = c; k < N; ++k) A[r][k] -= f * A[c][k];
      b[r] -= f * b[c];
    }
  }
  for (int r = N - 1; r >= 0; --r) {
    double s = b[r];
    for (int k = r + 1; k < N; ++k) s -= A[r][k] * b[k];
    b[r] = s / A[r][r];
  }
}

// T (3x4) <- exp_se3(xi) [T; bot] (core/se3.exp_se3, xi = (v, w))
__device__ void apply_exp_se3(const double (&xi)[6], double (&T)[12], const double (&bot)[4]) {
  const double w0 = xi[3], w1 = xi[4], w2 = xi[5];
  const double th2 = w0 * w0 + w1 * w1 + w2 * w2, th = sqrt(th2);
  const double a = th < 1e-5 ? 1.0 - th2 / 6.0 : sin(th) / th;
  const double b = th < 1e-4 ? 0.5 - th2 / 24.0 : (1.0 - cos(th)) / th2;
  const double c = th < 1e-4 ? 1.0 / 6.0 - th2 / 120.0 : (th - sin(th)) / (th2 * th);
  const double W[3][3] = {{0.0, -w2, w1}, {w2, 0.0, -w0}, {-w1, w0, 0.0}};
  double W2[3][3], R[3][3], t[3];
  for (int r = 0; r < 3; ++r)
    for (int k = 0; k < 3; ++k) W2[r][k] = W[r][0] * W[0][k] + W[r][1] * W[1][k] + W[r][2] * W[2][k];
  for (int r = 0; r < 3; ++r) {
    t[r] = 0.0;
    for (int k = 0; k < 3; ++k) {
      R[r][k] = (r == k ? 1.0 : 0.0) + a * W[r][k] + b * W2[r][k];
      t[r] += ((r == k ? 1.0 : 0.0) + b * W[r][k] + c * W2[r][k]) * xi[k];
    }
  }
  double out[12];
  for (int r = 0; r < 3; ++r)
    for (int k = 0; k < 4; ++k)
      out[4 * r + k] = R[r][0] * T[k] + R[r][1] * T[4 + k] + R[r][2] * T[8 + k] + t[r] * bot[k];
  for (int k = 0; k < 12; ++k) T[k] = out[k];
}

// The projective stage on T (3x4, double; bot its last row). Every thread
// of the block calls it. lm: the candidate's (M, 3) landmark scratch.
__device__ void projective_stage(double (&T)[12], const double (&bot)[4], const Matches& m,
                                 uint64_t valid, int rounds, double thr, const ProjParams& pp,
                                 double* __restrict__ lm) {
  __shared__ double red[RWARPS][PROJ_TERMS];
  __shared__ double fit[12];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint64_t inl;
  const int n_before = gate(T, m, valid, rounds, thr, &inl, nullptr);
  for (int k = 0; k < rounds; ++k) {
    if (!((inl >> k) & 1u)) continue;
    const int i = tid + k * RT;
    double su[3];
    uvz3(m.src + 3 * i, pp, su);
    lm[3 * i] = (su[0] - pp.cx) * su[2] / pp.fx;
    lm[3 * i + 1] = (su[1] - pp.cy) * su[2] / pp.fy;
    lm[3 * i + 2] = su[2];
  }
  double Tp[12];
  for (int k = 0; k < 12; ++k) Tp[k] = T[k];
  for (int it = 0; it < pp.iterations; ++it) {
    double acc[PROJ_TERMS];
#pragma unroll
    for (int k = 0; k < PROJ_TERMS; ++k) acc[k] = 0.0;
    for (int k = 0; k < rounds; ++k) {
      if (!((inl >> k) & 1u)) continue;
      const int i = tid + k * RT;
      double su[3], du[3], Ws[3], Wd[3], p[3], q[3], rs[3], rd[3], Js[2][3], Jq[2][3];
      uvz3(m.src + 3 * i, pp, su);
      uvz3(m.dst + 3 * i, pp, du);
      info3(su[2], pp, Ws);
      info3(du[2], pp, Wd);
      for (int c = 0; c < 3; ++c) p[c] = lm[3 * i + c];

      // (a) the landmark's 3x3 step
      proj_residual(p, su, pp, rs, Js);
      for (int r = 0; r < 3; ++r) q[r] = Tp[4 * r] * p[0] + Tp[4 * r + 1] * p[1] + Tp[4 * r + 2] * p[2] + Tp[4 * r + 3];
      proj_residual(q, du, pp, rd, Jq);
      double Js3[3][3], Jd[3][3];  // full Jacobians in p; Jd = dr/dq R
      for (int c = 0; c < 3; ++c) {
        Js3[0][c] = Js[0][c];
        Js3[1][c] = Js[1][c];
        Js3[2][c] = c == 2 ? 1.0 : 0.0;
        Jd[0][c] = Jq[0][0] * Tp[c] + Jq[0][1] * Tp[4 + c] + Jq[0][2] * Tp[8 + c];
        Jd[1][c] = Jq[1][0] * Tp[c] + Jq[1][1] * Tp[4 + c] + Jq[1][2] * Tp[8 + c];
        Jd[2][c] = Tp[8 + c];
      }
      double H[3][3], g[3];
      for (int a = 0; a < 3; ++a) {
        g[a] = 0.0;
        for (int k2 = 0; k2 < 3; ++k2) g[a] += Ws[k2] * Js3[k2][a] * rs[k2] + Wd[k2] * Jd[k2][a] * rd[k2];
        for (int c = 0; c < 3; ++c) {
          double h = a == c ? PROJ_DAMPING : 0.0;
          for (int k2 = 0; k2 < 3; ++k2) h += Ws[k2] * Js3[k2][a] * Js3[k2][c] + Wd[k2] * Jd[k2][a] * Jd[k2][c];
          H[a][c] = h;
        }
      }
      solve_pivoted<3>(H, g);
      for (int c = 0; c < 3; ++c) {
        p[c] -= g[c];
        lm[3 * i + c] = p[c];
      }

      // (b) this match's terms of the pose system: J6 = dr/dq [I | -[q]x]
      for (int r = 0; r < 3; ++r) q[r] = Tp[4 * r] * p[0] + Tp[4 * r + 1] * p[1] + Tp[4 * r + 2] * p[2] + Tp[4 * r + 3];
      proj_residual(q, du, pp, rd, Jq);
      const double mq[3][3] = {{0.0, q[2], -q[1]}, {-q[2], 0.0, q[0]}, {q[1], -q[0], 0.0}};
      double J6[3][6];
      for (int r = 0; r < 2; ++r)
        for (int c = 0; c < 3; ++c) {
          J6[r][c] = Jq[r][c];
          J6[r][3 + c] = Jq[r][0] * mq[0][c] + Jq[r][1] * mq[1][c] + Jq[r][2] * mq[2][c];
        }
      for (int c = 0; c < 3; ++c) {
        J6[2][c] = c == 2 ? 1.0 : 0.0;
        J6[2][3 + c] = mq[2][c];
      }
      int idx = 0;
      for (int a = 0; a < 6; ++a) {
        for (int c = a; c < 6; ++c, ++idx)
          acc[idx] += Wd[0] * J6[0][a] * J6[0][c] + Wd[1] * J6[1][a] * J6[1][c] + Wd[2] * J6[2][a] * J6[2][c];
        acc[21 + a] += Wd[0] * J6[0][a] * rd[0] + Wd[1] * J6[1][a] * rd[1] + Wd[2] * J6[2][a] * rd[2];
      }
    }
#pragma unroll
    for (int k = 0; k < PROJ_TERMS; ++k)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off);
    if (lane == 0)
#pragma unroll
      for (int k = 0; k < PROJ_TERMS; ++k) red[warp][k] = acc[k];
    __syncthreads();
    if (tid == 0) {
      double tot[PROJ_TERMS];
      for (int k = 0; k < PROJ_TERMS; ++k) {
        tot[k] = 0.0;
        for (int w = 0; w < RWARPS; ++w) tot[k] += red[w][k];
      }
      double H6[6][6], xi[6];
      int idx = 0;
      for (int a = 0; a < 6; ++a)
        for (int c = a; c < 6; ++c, ++idx) H6[a][c] = H6[c][a] = tot[idx] + (a == c ? PROJ_DAMPING : 0.0);
      for (int a = 0; a < 6; ++a) xi[a] = tot[21 + a];
      solve_pivoted<6>(H6, xi);
      double nrm2 = 0.0;
      bool finite = true;
      for (int a = 0; a < 6; ++a) {
        xi[a] = -xi[a];
        finite = finite && fabs(xi[a]) < 1e300;  // false for inf and NaN
        nrm2 += xi[a] * xi[a];
      }
      // a degenerate system (few or collinear inliers) must not blow up
      if (!(finite && sqrt(nrm2) < 1.0))
        for (int a = 0; a < 6; ++a) xi[a] = 0.0;
      apply_exp_se3(xi, Tp, bot);
      for (int k = 0; k < 12; ++k) fit[k] = Tp[k];
    }
    __syncthreads();
    for (int k = 0; k < 12; ++k) Tp[k] = fit[k];
  }
  uint64_t bits;
  if (gate(Tp, m, valid, rounds, thr, &bits, nullptr) >= n_before)
    for (int k = 0; k < 12; ++k) T[k] = Tp[k];
}

template <bool STAGED, bool PROJ>
__global__ void __launch_bounds__(RT)
refine_kernel(const float* __restrict__ src, const float* __restrict__ dst,
              const float* __restrict__ w_depth, const float* __restrict__ src_cov,
              const float* __restrict__ dst_cov, const unsigned char* __restrict__ valid,
              const float* __restrict__ T_in, const unsigned char* __restrict__ inl_in,
              float* __restrict__ T_out, unsigned char* __restrict__ inl_out,
              int* __restrict__ n_out, float* __restrict__ rmse_out, int M, int iterations,
              double thr, ProjParams pp, double* __restrict__ landmarks) {
  extern __shared__ float stage[];
  __shared__ double red[RWARPS][16];
  __shared__ double fit[12];  // the fitted T (3x4), broadcast by warp 0
  __shared__ int first_valid;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t b = blockIdx.x;
  const size_t p3 = b * M * 3, p1 = b * M;
  const int rounds = (M + RT - 1) / RT;

  Matches m{src + p3, dst + p3, src_cov + p3, dst_cov + p3, w_depth + p1};
  if (STAGED) {  // one asynchronous copy of the candidate's matches
    for (int j = tid; j < 3 * M; j += RT) {
      cp_async4(stage + j, m.src + j);
      cp_async4(stage + 3 * M + j, m.dst + j);
      cp_async4(stage + 6 * M + j, m.scov + j);
      cp_async4(stage + 9 * M + j, m.dcov + j);
    }
    for (int j = tid; j < M; j += RT) cp_async4(stage + 12 * M + j, m.w + j);
  }
  if (tid == 0) first_valid = M;
  uint64_t vbits = 0, cur = 0;  // this thread's valid and current inlier flags
  for (int k = 0; k < rounds; ++k) {
    const int i = tid + k * RT;
    if (i < M) {
      vbits |= static_cast<uint64_t>(valid[p1 + i] != 0) << k;
      cur |= static_cast<uint64_t>(inl_in[p1 + i] != 0) << k;
    }
  }
  __syncthreads();  // first_valid initialised
  if (vbits) atomicMin(&first_valid, tid + (__ffsll(static_cast<long long>(vbits)) - 1) * RT);
  if (STAGED) {
    cp_async_wait_all();
    m = Matches{stage, stage + 3 * M, stage + 6 * M, stage + 9 * M, stage + 12 * M};
  }
  __syncthreads();  // staged copy landed, first_valid final
  double ref_s[3] = {0, 0, 0}, ref_d[3] = {0, 0, 0};
  if (first_valid < M)
    for (int k = 0; k < 3; ++k) {
      ref_s[k] = m.src[3 * first_valid + k];
      ref_d[k] = m.dst[3 * first_valid + k];
    }

  double T[12];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 4; ++c) T[4 * r + c] = T_in[b * 16 + 4 * r + c];
  bool replaced = false;  // T is no longer T_in

  for (int it = 0; it < iterations; ++it) {
    // one pass: the 16 moments about the reference match
    double mo[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) mo[k] = 0.0;
    for (int k = 0; k < rounds; ++k) {
      if (!((cur >> k) & 1u)) continue;
      const int i = tid + k * RT;
      const double wi = m.w[i];
      if (!(wi > 0.0)) continue;
      double s[3], d[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        s[c] = m.src[3 * i + c] - ref_s[c];
        d[c] = m.dst[3 * i + c] - ref_d[c];
      }
      mo[0] += wi;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        mo[1 + c] += wi * s[c];
        mo[4 + c] += wi * d[c];
      }
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const double ws = wi * s[r];
#pragma unroll
        for (int c = 0; c < 3; ++c) mo[7 + 3 * r + c] += ws * d[c];
      }
    }
#pragma unroll
    for (int k = 0; k < 16; ++k)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mo[k] += __shfl_down_sync(0xffffffffu, mo[k], off);
    if (lane == 0)
#pragma unroll
      for (int k = 0; k < 16; ++k) red[warp][k] = mo[k];
    __syncthreads();
    if (warp == 0) {
      // lanes 0-15 sum one moment each over the warps, then every lane
      // takes all 16 and solves the same 3x3 problem
      double mine = 0.0;
      if (lane < 16)
        for (int i = 0; i < RWARPS; ++i) mine += red[i][lane];
#pragma unroll
      for (int k = 0; k < 16; ++k) mo[k] = __shfl_sync(0xffffffffu, mine, k);
      const double W = mo[0], We = W + 1e-12;
      double ms[3], md[3], H[3][3], R[3][3];
      for (int c = 0; c < 3; ++c) {
        ms[c] = mo[1 + c] / We;
        md[c] = mo[4 + c] / We;
      }
      const double k2 = 2.0 - W / We;
      for (int r = 0; r < 3; ++r)
        for (int c = 0; c < 3; ++c) H[r][c] = mo[7 + 3 * r + c] / We - k2 * ms[r] * md[c];
      kabsch_rotation(H, R);
      if (lane == 0) {
        const double f = W / We;  // mu = shifted mean + (W / We) ref
        double mu_s[3], mu_d[3];
        for (int c = 0; c < 3; ++c) {
          mu_s[c] = ms[c] + f * ref_s[c];
          mu_d[c] = md[c] + f * ref_d[c];
        }
        for (int r = 0; r < 3; ++r) {
          for (int c = 0; c < 3; ++c) fit[4 * r + c] = R[r][c];
          fit[4 * r + 3] = mu_d[r] - (R[r][0] * mu_s[0] + R[r][1] * mu_s[1] + R[r][2] * mu_s[2]);
        }
      }
    }
    __syncthreads();
    double T2[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) T2[k] = fit[k];
    uint64_t bits;
    if (gate(T2, m, vbits, rounds, thr, &bits, nullptr) >= 3) {  // keep the refit
#pragma unroll
      for (int k = 0; k < 12; ++k) T[k] = T2[k];
      cur = bits;
      replaced = true;
    }
  }

  if constexpr (PROJ) {
    double bot[4];  // T's last row, as the plain version multiplies it
    for (int k = 0; k < 4; ++k) bot[k] = replaced ? (k == 3 ? 1.0 : 0.0) : T_in[b * 16 + 12 + k];
    projective_stage(T, bot, m, vbits, rounds, thr, pp, landmarks + b * M * 3);
  }

  // the final gate of T: inliers, their count and rmse
  double m2_sum = 0.0;
  uint64_t bits;
  const int count = gate(T, m, vbits, rounds, thr, &bits, &m2_sum);
  for (int off = 16; off > 0; off >>= 1) m2_sum += __shfl_down_sync(0xffffffffu, m2_sum, off);
  if (lane == 0) red[warp][0] = m2_sum;
  for (int k = 0; k < rounds; ++k) {
    const int i = tid + k * RT;
    if (i < M) inl_out[p1 + i] = static_cast<unsigned char>((bits >> k) & 1u);
  }
  __syncthreads();
  if (tid == 0) {
    double total = 0.0;
    for (int i = 0; i < RWARPS; ++i) total += red[i][0];
    n_out[b] = count;
    rmse_out[b] = static_cast<float>(sqrt(total / (count > 0 ? count : 1)));
    float* To = T_out + b * 16;
    for (int k = 0; k < 12; ++k) To[k] = static_cast<float>(T[k]);
    for (int k = 12; k < 16; ++k) To[k] = replaced ? (k == 15 ? 1.0f : 0.0f) : T_in[b * 16 + k];
  }
}

}  // namespace

extern "C" int weighted_kabsch_f32(const float* src, const float* dst, const float* w, float* out,
                                   int B, int N, void* stream) {
  if (B < 1 || N < 0) return -2;
  kabsch_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(src, dst, w, out, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ransac_refine_f32(const float* src, const float* dst, const float* w_depth,
                                 const float* src_cov, const float* dst_cov,
                                 const unsigned char* valid, const float* T_in,
                                 const unsigned char* inl_in, float* T_out,
                                 unsigned char* inl_out, int* n_out, float* rmse_out, int B,
                                 int M, int iterations, double max_mahal_sq, int proj_iterations,
                                 double fx, double fy, double cx, double cy, double sigma_depth,
                                 double* landmarks, void* stream) {
  if (B < 1 || M < 0 || M > REFINE_MAX_M || iterations < 0 || proj_iterations < 0) return -2;
  if (proj_iterations > 0 && landmarks == nullptr) return -2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t stage_bytes = static_cast<size_t>(STAGE_FLOATS) * M * sizeof(float);
  const bool staged = stage_bytes <= STAGE_MAX_BYTES;
  const ProjParams pp{proj_iterations, fx, fy, cx, cy, sigma_depth};
#define REFINE_LAUNCH(ST, PJ)                                                                   \
  refine_kernel<ST, PJ><<<B, RT, ST ? stage_bytes : 0, s>>>(                                   \
      src, dst, w_depth, src_cov, dst_cov, valid, T_in, inl_in, T_out, inl_out, n_out,          \
      rmse_out, M, iterations, max_mahal_sq, pp, landmarks)
  if (proj_iterations == 0) {
    if (staged)
      REFINE_LAUNCH(true, false);
    else
      REFINE_LAUNCH(false, false);
  } else if (staged) {
    REFINE_LAUNCH(true, true);
  } else {
    REFINE_LAUNCH(false, true);
  }
#undef REFINE_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
