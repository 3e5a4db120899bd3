// Batched weighted Kabsch fit for Hopper (sm_90a): for each problem b,
// the rigid T_b = [R t; 0 1] minimising sum_n w_bn |R src_bn + t - dst_bn|^2.
//
// Replaces core/alignment.weighted_kabsch's torch.linalg.svd + det (the
// JAX function is rgbdslam_v2_tpu/core/alignment.py::weighted_kabsch, an
// XLA SVD; it has no Pallas source). cuSOLVER's batched SVD and det check
// their status on the host, two device->host waits a call; this kernel
// makes none, so a step that calls it can be captured as a CUDA graph.
//
// What it computes, as the plain torch version (weighted_kabsch_plain):
//   w <- max(w, 0); mu_s = sum w src / (sum w + 1e-12), mu_d likewise;
//   H = sum w (src - mu_s)(dst - mu_d)^T / (sum w + 1e-12);
//   H = U S V^T;  R = V diag(1, 1, det(V U^T)) U^T;  t = mu_d - R mu_s.
// The 3x3 SVD is taken in registers: cyclic Jacobi on H^T H gives V and
// the singular values in descending order; u1 = H v1 / |H v1|, u2 is
// H v2 made orthogonal to u1 and normalised, u3 = u1 x u2. Then
//   R = v1 u1^T + v2 u2^T + det(V) v3 u3^T,
// which is V diag(1, 1, det(V U^T)) U^T for this U (det U = +1) and does
// not depend on the signs of v3 or u3. Degenerate H: a zero H (no positive
// weight) gives u_i = v_i, hence R = I (as LAPACK's SVD of a zero matrix);
// a rank-1 H completes u2 orthogonally, so R is still a proper rotation.
// Sums and the 3x3 algebra run in double, so the result is finite for any
// finite input; points of weight <= 0 add nothing.
//
// What bounds it on the card: nothing but the launch. A refit reads
// B*N*7 floats (8*300*7*4 = 67 KB on the main path, 0.02 us at 3.35 TB/s)
// and does ~30 flops a point. One block of 128 threads per problem: a
// strided pass sums the weights and weighted points, a second the
// cross-covariance (both warp-shuffle reductions, then across the 4 warps
// in shared memory); thread 0 does the 3x3 part.
//
// C entry: weighted_kabsch_f32(src, dst, w, out, B, N, stream): src, dst
// (B, N, 3) and w (B, N) contiguous float32 device arrays, out (B, 4, 4)
// float32, row major. Returns cudaGetLastError() after the launch.
#include <cuda_runtime.h>

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
      const double theta = (A[q][q] - A[p][p]) / (2.0 * apq);
      const double t = (theta >= 0.0 ? 1.0 : -1.0) / (fabs(theta) + sqrt(1.0 + theta * theta));
      const double c = 1.0 / sqrt(1.0 + t * t), s = t * c;
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

  float* T = out + b * 16;
  double R[3][3];
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c)
      R[r][c] = v[0][r] * u1[c] + v[1][r] * u2[c] + det_v * v[2][r] * u3[c];
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) T[4 * r + c] = static_cast<float>(R[r][c]);
    T[4 * r + 3] = static_cast<float>(mu_d[r] - dot3(R[r], mu_s));
  }
  T[12] = 0.0f;
  T[13] = 0.0f;
  T[14] = 0.0f;
  T[15] = 1.0f;
}

}  // namespace

extern "C" int weighted_kabsch_f32(const float* src, const float* dst, const float* w, float* out,
                                   int B, int N, void* stream) {
  if (B < 1 || N < 0) return -2;
  kabsch_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(src, dst, w, out, N);
  return static_cast<int>(cudaGetLastError());
}
