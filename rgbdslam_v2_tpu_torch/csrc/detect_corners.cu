// Fused FAST-9/16 + Harris + 3x3 NMS corner scoring for Hopper (sm_90a).
//
// Replaces rgbdslam_v2_tpu/ops/pallas_detect.py::detect_corners_pallas
// (Pallas body `_kernel`). Same result as the plain torch version
// rgbdslam_v2_tpu_torch/ops/fast.py::detect_corners(use_harris=True):
//   FAST segment test over the radius-3 ring (9 contiguous brighter or darker
//   than center +- threshold), Sobel gx/gy, 5-tap sigma=1.5 Gaussian on
//   gx^2, gy^2, gx*gy, Harris det - k*tr^2, non-corners -> -inf, 3x3 NMS
//   keeping pixels >= all 8 neighbours, a `border`-pixel frame -> -inf.
//
// What bounds it on the card: memory traffic. A VGA frame is 1.2 MB in and
// 1.2 MB out; the ~150 flops a pixel are far below the H100's ridge point.
// The design keeps every intermediate (ring, gradients, products, blurs,
// masked scores) in shared memory and registers, so device memory sees one
// read of the tile plus halo and one write of the score tile.
//
// Layout: one 32x8 thread block per 32x8 output tile. The tile plus a 4-px
// halo (NMS 1 + blur 2 + Sobel 1; FAST 3 + NMS 1) is loaded with clamped
// (edge) reads. Every pixel within `border` >= 4 of an edge is -inf, so the
// padding rule never reaches an output. Stages, separated by barriers:
//   1. gradient products on the (TH+6)x(TW+6) region,
//   2. vertical then horizontal 5-tap blur, Harris and the FAST bit on the
//      (TH+2)x(TW+2) region -> masked score,
//   3. NMS, border mask, store.
// Arithmetic repeats the plain version's operation order; built with
// --fmad=false (no contraction) it rounds identically.
//
// C entry: detect_corners_f32(img, out, H, W, threshold, harris_k, border,
// taps5 (host pointer to the 5 blur taps), stream) returns cudaGetLastError()
// after the launch (0 = launched).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TW = 32;  // tile width  (threads in x)
constexpr int TH = 8;   // tile height (threads in y)
constexpr int HALO = 4;
constexpr int LW = TW + 2 * HALO;  // loaded image region
constexpr int LH = TH + 2 * HALO;
constexpr int PW = TW + 6;  // gradient-product region (halo 3)
constexpr int PH = TH + 6;
constexpr int MW = TW + 2;  // Harris / masked region (halo 1)
constexpr int MH = TH + 2;

// ops/image.gaussian_kernel_1d(1.5, 2) as float32, passed by value
struct Taps5 {
  float w[5];
};

// FAST ring (dy, dx), clockwise: ops/fast.RING
__constant__ int c_ring_dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int c_ring_dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

__device__ __forceinline__ bool has_arc9(unsigned m) {
  // 9 contiguous set bits on the circular 16-bit ring
  unsigned d = m | (m << 16);
  unsigned r = d & (d >> 1);  // runs of 2
  r &= r >> 2;                // runs of 4
  r &= r >> 4;                // runs of 8
  r &= d >> 8;                // runs of 9
  return (r & 0xFFFFu) != 0u;
}

__global__ void __launch_bounds__(TW * TH)
detect_corners_kernel(const float* __restrict__ img, float* __restrict__ out,
                      int H, int W, float threshold, float harris_k, int border,
                      Taps5 g5) {
  __shared__ float s_img[LH][LW];
  __shared__ float s_xx[PH][PW];
  __shared__ float s_yy[PH][PW];
  __shared__ float s_xy[PH][PW];
  __shared__ float s_vxx[MH][PW];
  __shared__ float s_vyy[MH][PW];
  __shared__ float s_vxy[MH][PW];
  __shared__ float s_masked[MH][MW];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TW + tx;
  constexpr int NT = TW * TH;
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;

  // ---- load tile + halo, clamped (edge) reads ----------------------------
  for (int i = tid; i < LH * LW; i += NT) {
    const int ly = i / LW, lx = i % LW;
    const int gy = min(max(y0 - HALO + ly, 0), H - 1);
    const int gx = min(max(x0 - HALO + lx, 0), W - 1);
    s_img[ly][lx] = img[static_cast<size_t>(gy) * W + gx];
  }
  __syncthreads();

  // ---- stage 1: Sobel products on the halo-3 region ----------------------
  // plain order: gx = conv_x(conv_y(img, [1,2,1]), [-1,0,1]);
  //              gy = conv_x(conv_y(img, [-1,0,1]), [1,2,1])
  for (int i = tid; i < PH * PW; i += NT) {
    const int py = i / PW, px = i % PW;
    const int ly = py + 1, lx = px + 1;  // center in s_img
    float s[3], d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int c = lx - 1 + k;
      const float a = s_img[ly - 1][c], b = s_img[ly][c], e = s_img[ly + 1][c];
      s[k] = __fadd_rn(__fadd_rn(__fmul_rn(a, 1.0f), __fmul_rn(b, 2.0f)), __fmul_rn(e, 1.0f));
      d[k] = __fadd_rn(__fadd_rn(__fmul_rn(a, -1.0f), __fmul_rn(b, 0.0f)), __fmul_rn(e, 1.0f));
    }
    const float gx = __fadd_rn(__fadd_rn(__fmul_rn(s[0], -1.0f), __fmul_rn(s[1], 0.0f)),
                               __fmul_rn(s[2], 1.0f));
    const float gy = __fadd_rn(__fadd_rn(__fmul_rn(d[0], 1.0f), __fmul_rn(d[1], 2.0f)),
                               __fmul_rn(d[2], 1.0f));
    s_xx[py][px] = __fmul_rn(gx, gx);
    s_yy[py][px] = __fmul_rn(gy, gy);
    s_xy[py][px] = __fmul_rn(gx, gy);
  }
  __syncthreads();

  // ---- stage 2a: vertical 5-tap blur -> (TH+2) x (TW+6) ------------------
  for (int i = tid; i < MH * PW; i += NT) {
    const int vy = i / PW, vx = i % PW;
    float axx = __fmul_rn(s_xx[vy][vx], g5.w[0]);
    float ayy = __fmul_rn(s_yy[vy][vx], g5.w[0]);
    float axy = __fmul_rn(s_xy[vy][vx], g5.w[0]);
#pragma unroll
    for (int k = 1; k < 5; ++k) {
      axx = __fadd_rn(axx, __fmul_rn(s_xx[vy + k][vx], g5.w[k]));
      ayy = __fadd_rn(ayy, __fmul_rn(s_yy[vy + k][vx], g5.w[k]));
      axy = __fadd_rn(axy, __fmul_rn(s_xy[vy + k][vx], g5.w[k]));
    }
    s_vxx[vy][vx] = axx;
    s_vyy[vy][vx] = ayy;
    s_vxy[vy][vx] = axy;
  }
  __syncthreads();

  // ---- stage 2b: horizontal blur, Harris, FAST bit -> masked score -------
  for (int i = tid; i < MH * MW; i += NT) {
    const int my = i / MW, mx = i % MW;
    float ixx = __fmul_rn(s_vxx[my][mx], g5.w[0]);
    float iyy = __fmul_rn(s_vyy[my][mx], g5.w[0]);
    float ixy = __fmul_rn(s_vxy[my][mx], g5.w[0]);
#pragma unroll
    for (int k = 1; k < 5; ++k) {
      ixx = __fadd_rn(ixx, __fmul_rn(s_vxx[my][mx + k], g5.w[k]));
      iyy = __fadd_rn(iyy, __fmul_rn(s_vyy[my][mx + k], g5.w[k]));
      ixy = __fadd_rn(ixy, __fmul_rn(s_vxy[my][mx + k], g5.w[k]));
    }
    const float det = __fsub_rn(__fmul_rn(ixx, iyy), __fmul_rn(ixy, ixy));
    const float tr = __fadd_rn(ixx, iyy);
    const float harris = __fsub_rn(det, __fmul_rn(__fmul_rn(harris_k, tr), tr));

    // FAST-9/16 on the center pixel (my+3, mx+3) of s_img
    const int cy = my + 3, cx = mx + 3;
    const float c = s_img[cy][cx];
    const float hi = __fadd_rn(c, threshold);
    const float lo = __fsub_rn(c, threshold);
    unsigned bright = 0u, dark = 0u;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float v = s_img[cy + c_ring_dy[k]][cx + c_ring_dx[k]];
      bright |= (v > hi ? 1u : 0u) << k;
      dark |= (v < lo ? 1u : 0u) << k;
    }
    const bool corner = has_arc9(bright) || has_arc9(dark);
    s_masked[my][mx] = corner ? harris : -CUDART_INF_F;
  }
  __syncthreads();

  // ---- stage 3: 3x3 NMS, border mask, store ------------------------------
  const int gx = x0 + tx, gy = y0 + ty;
  if (gx >= W || gy >= H) return;
  const float m = s_masked[ty + 1][tx + 1];
  float nbr = m;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
      if (dy != 1 || dx != 1) nbr = fmaxf(nbr, s_masked[ty + dy][tx + dx]);
  const bool inb = gy >= border && gy < H - border && gx >= border && gx < W - border;
  // m is finite exactly where the pixel is a FAST corner
  const bool keep = inb && m > -CUDART_INF_F && m >= nbr;
  out[static_cast<size_t>(gy) * W + gx] = keep ? m : -CUDART_INF_F;
}

}  // namespace

extern "C" int detect_corners_f32(const float* img, float* out, int H, int W,
                                  float threshold, float harris_k, int border,
                                  const float* taps5, void* stream) {
  Taps5 g5;
  for (int k = 0; k < 5; ++k) g5.w[k] = taps5[k];
  const dim3 block(TW, TH);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  detect_corners_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, out, H, W, threshold, harris_k, border, g5);
  return static_cast<int>(cudaGetLastError());
}
