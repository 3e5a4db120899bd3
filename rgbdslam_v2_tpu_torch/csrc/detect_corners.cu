// Fused FAST-9/16 + Harris + 3x3 NMS corner scoring of a whole image
// pyramid in one launch, for Hopper (sm_90a).
//
// Replaces rgbdslam_v2_tpu/ops/pallas_detect.py::detect_corners_pallas
// (Pallas body `_kernel`). Same result, bit for bit, as the plain torch
// version rgbdslam_v2_tpu_torch/ops/fast.py::detect_corners on each level:
//   FAST segment test over the radius-3 ring (9 contiguous brighter or darker
//   than center +- threshold), Sobel gx/gy, 5-tap sigma=1.5 Gaussian on
//   gx^2, gy^2, gx*gy, Harris det - k*tr^2, non-corners -> -inf, 3x3 NMS
//   keeping pixels >= all 8 neighbours, a `border`-pixel frame -> -inf.
//
// What bounds it on the card. A 640x480 frame's four levels hold 771,112
// pixels; the kernel reads one float and writes one float for each, 6.17 MB
// a frame, 1.84 us at 3.35 TB/s. The ~127 float operations a pixel take
// 1.46 us at 67 TFLOP/s, so bytes bound it on paper. In practice a frame is
// too small to fill the card for long: what costs time is launches, waves,
// re-read halos, recomputed stages and barriers, and the design cuts each:
//   * one launch a frame: the flat block index maps to (level, tile) through
//     a by-value level table (prefix sums of tile counts, level 0 first).
//     Each level is read where it lies, through its own CUtensorMap; TMA
//     needs 16-byte row pitches, so a width that is not a multiple of 4 is
//     padded by the resize that writes the level (ops/detect.pitched_empty);
//     the score maps are written unpadded, one after another;
//   * a block owns a 120x32 output tile. Its 128x40 input window (4-px halo)
//     arrives by TMA as five 8-row bands, each with its own mbarrier, all
//     requested at once by one thread: a warp starts computing on its first
//     band while the next ones are still in flight. Halo reads are
//     (128*40)/(120*32) = 1.33x the output, instead of 2.5x;
//   * each warp walks 8 output rows down the window; each lane owns a
//     4-column strip (float4 reads of shared memory, float4 stores where a
//     row allows). The vertical passes live in registers: the 5-tap vertical
//     blur as 4 running partial sums a channel (each new row of products adds
//     one tap to the five rows it feeds, in tap order), NMS as a 3-row ring.
//     The horizontal passes take neighbours' columns from the window in
//     shared memory (Sobel, FAST) or by one-lane warp shuffles (the
//     horizontal blur, NMS). No stage needs a block barrier: the only
//     __syncthreads is the one after the mbarriers are initialised;
//   * recompute: a warp's 8 output rows cost 10 rows of FAST/Harris work and
//     14 of Sobel (the halo rows); lanes 0 and 31 are the 4-column halo;
//   * FAST's 32 comparisons a pixel are one subtraction (FMA pipe) and one
//     funnel shift (integer pipe) each: the sign of hi - v or v - lo is the
//     comparison, shifted into the ring mask in ring order.
// With the halo and barriers gone, what limits it is instruction issue: a
// warp spends ~880 instructions on a row of 128 pixels (the bit-exact blurs
// and FAST are most of them), and a frame gives each scheduler <= 2 warps.
// Exactness. Every output within `border` >= 4 pixels of an edge is -inf,
// and every other output reads pixels inside its level only (NMS 1 + blur 2
// + Sobel 1, or NMS 1 + FAST 3). So the window's out-of-image pixels,
// which TMA fills with zeros, never reach a score (the wrapper raises for
// border < 4). Each sum is taken in the plain version's operation order with
// round-to-nearest intrinsics, built with --fmad=false; multiplications by
// 1.0 are left out (x*1 == x) and by -1.0 written as negation (exact).
// Register reuse shares inputs between neighbouring outputs, never partial
// sums of another output.
//
// C entry: detect_pyramid_f32(imgs, out, table, n_levels, threshold,
// harris_k, border, taps5, stream). `imgs` is a host array of n_levels
// device pointers, one 16-byte aligned image a level; `table` a host int32
// array of n_levels rows (pitch, h, w, out_off, blocks_x, blocks_y,
// block_start), see ops/detect.py; `taps5` a host pointer to the 5 blur
// taps. Returns 0 when the kernel was launched, a cudaError_t after a failed
// launch, -1 when the driver's cuTensorMapEncodeTiled is not available,
// -2 for a bad level count, -(1000 + CUresult) when a tensor map is refused.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

// Tile shape: a block owns TILE_W x TILE_H outputs, WARPS warps of
// WARP_ROWS rows each (ops/detect.py's level table assumes TILE_H = 32).
constexpr int WARP_ROWS = 8;                 // output rows a warp walks
constexpr int WARPS = 32 / WARP_ROWS;
constexpr int TILE_W = 120;                  // output columns of a block (30 lanes x 4)
constexpr int TILE_H = WARPS * WARP_ROWS;    // output rows of a block
constexpr int HALO = 4;
constexpr int WIN_W = TILE_W + 2 * HALO;     // 128: the input window
constexpr int WIN_H = TILE_H + 2 * HALO;     // 40
constexpr int BAND_H = 8;                    // rows of one TMA box
constexpr int N_BANDS = WIN_H / BAND_H;      // 5
constexpr int WARP_WIN = WARP_ROWS + 2 * HALO;  // 16 window rows a warp reads
constexpr int MAX_LEVELS = 8;
constexpr unsigned FULL = 0xFFFFFFFFu;

static_assert(WIN_W == 128 && WIN_H % BAND_H == 0 && TILE_H == 32, "window layout");
static_assert(WARP_ROWS % 4 == 0, "a warp's first row lies in the first half of a band");

struct Level {
  int h, w, out_off, blocks_x, block_start;
};

struct __align__(64) Params {
  CUtensorMap maps[MAX_LEVELS];  // one 2-D map per level, box 128 x 8
  Level lv[MAX_LEVELS];
  int n_levels;
  int border;
  float threshold;
  float harris_k;
  float g[5];  // ops/image.gaussian_kernel_1d(1.5, 2)
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// Nonzero iff the 16-bit ring mask m has 9 contiguous set bits, circularly.
// Bit i of the result is set when bits i-8..i of the twice-unrolled ring
// are; left shifts and a multiply run on the FMA pipe, leaving the
// half-rate integer pipe the ANDs.
__device__ __forceinline__ unsigned arc9(unsigned m) {
  const unsigned d = m * 0x10001u;  // m | m << 16
  unsigned r = d & (d << 1);        // runs of 2
  r &= r << 2;                      // runs of 4
  r &= r << 4;                      // runs of 8
  return r & (d << 8);              // runs of 9
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Spin until the barrier's phase `parity` completes. The loop lives inside
// the asm block, so the compiler sees no divergent branch around the warp's
// shuffles.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One window row of the lane's strip and its neighbours: band columns
// 4*lane-4 .. 4*lane+7 (v[q] is column 4*lane-4+q). Lanes 0 and 31 read a
// clamped chunk instead of the missing outer one; those columns feed only
// halo outputs that are never stored.
struct Row12 {
  float v[12];
};

__device__ __forceinline__ Row12 load_row(const float (*win)[WIN_W], int r, int cl, int cc,
                                          int cr) {
  const float4 a = *reinterpret_cast<const float4*>(&win[r][cl]);
  const float4 b = *reinterpret_cast<const float4*>(&win[r][cc]);
  const float4 c = *reinterpret_cast<const float4*>(&win[r][cr]);
  return Row12{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w}};
}

// The next ring point, at column offset DX on one ring row, for the lane's 4
// pixels: its bright and dark bits are shifted in at the bottom of the masks,
// so after the 16 points in ring order bit 15-n holds point n (a mirrored
// ring, which keeps runs contiguous). v > hi exactly when hi - v is negative
// (x - y is +0 for x == y and nonzero otherwise), so the bit is the sign of
// one subtraction, moved in by one funnel shift (see hi/lo below for zeros).
template <int DX>
__device__ __forceinline__ void ring(const Row12& row, const float (&hi)[4], const float (&lo)[4],
                                     unsigned (&bright)[4], unsigned (&dark)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float v = row.v[k + 4 + DX];
    bright[k] = __funnelshift_l(__float_as_uint(sub(hi[k], v)), bright[k], 1);
    dark[k] = __funnelshift_l(__float_as_uint(sub(v, lo[k])), dark[k], 1);
  }
}

__global__ void __launch_bounds__(WARPS * 32)
detect_pyramid_kernel(const __grid_constant__ Params p, float* __restrict__ out) {
  __shared__ __align__(128) float win[WIN_H][WIN_W];
  __shared__ __align__(8) uint64_t bars[N_BANDS];

  // ---- (level, tile) of this block --------------------------------------
  const int b = blockIdx.x;
  int L = 0, h = 0, w = 0, out_off = 0, blocks_x = 1, start = 0;
#pragma unroll
  for (int k = 0; k < MAX_LEVELS; ++k) {
    if (k < p.n_levels && b >= p.lv[k].block_start) {
      L = k;
      h = p.lv[k].h;
      w = p.lv[k].w;
      out_off = p.lv[k].out_off;
      blocks_x = p.lv[k].blocks_x;
      start = p.lv[k].block_start;
    }
  }
  const int t = b - start;
  const int x0 = (t % blocks_x) * TILE_W;  // first output column
  const int y0 = (t / blocks_x) * TILE_H;  // first output row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // warps with output rows, and the bands they read (a warp's rows plus 4
  // halo rows on each side); bands nobody reads are not requested, so no
  // copy is in flight when the block exits
  const int live = min(WARPS, (h - y0 + WARP_ROWS - 1) / WARP_ROWS);
  const int n_bands = (live * WARP_ROWS + 2 * HALO + BAND_H - 1) / BAND_H;

  // ---- request the window: one thread, one TMA box per band --------------
  if (threadIdx.x == 0) {
    for (int k = 0; k < n_bands; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&bars[k]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint64_t map = reinterpret_cast<uint64_t>(&p.maps[L]);
    for (int k = 0; k < n_bands; ++k) {
      const uint32_t bar = smem_addr(&bars[k]);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                   "r"(BAND_H * WIN_W * 4)
                   : "memory");
      asm volatile(
          "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(&win[k * BAND_H][0])),
          "l"(map), "r"(x0 - HALO), "r"(y0 - HALO + k * BAND_H), "r"(bar)
          : "memory");
    }
  }
  if (warp >= live) return;

  const float g0 = p.g[0], g1 = p.g[1], g2 = p.g[2], g3 = p.g[3], g4 = p.g[4];
  const float thr = p.threshold, hk = p.harris_k;
  const int cc = 4 * lane;                // the lane's own chunk
  const int cl = max(cc - 4, 0);          // left neighbour chunk (clamped)
  const int cr = min(cc + 4, WIN_W - 4);  // right neighbour chunk (clamped)
  const int r0 = warp * WARP_ROWS;        // the warp's first window row
  const int gx = x0 - HALO + cc;          // level column of the lane's first pixel
  const bool store_lane = lane >= 1 && lane <= 30;
  const bool vec_store = (w % 4 == 0) && (out_off % 4 == 0);
  const float NEG = -CUDART_INF_F;

  // vertical blur partial sums: acc[ch][n] holds taps 0..n of the blurred
  // row 4-n rows below the newest completed one
  float acc[3][4][4];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[c][n][k] = 0.f;
  float m1[4], m2[4];  // masked scores of the two rows above the newest
#pragma unroll
  for (int k = 0; k < 4; ++k) m1[k] = m2[k] = NEG;

  mbar_wait(smem_addr(&bars[r0 / BAND_H]), 0);
  // j: newest window row of the warp. Products of row j-1 need rows
  // j-2..j; the blurred products, FAST and the masked score of row j-3 need
  // products j-5..j-1 and rows j-6..j; NMS of row j-4 needs scores j-5..j-3.
  // Each band is waited for before its first row is read.
#pragma unroll 1
  for (int j = 2; j < WARP_WIN; ++j) {
    const int r = r0 + j;
    if (r % BAND_H == 0) mbar_wait(smem_addr(&bars[r / BAND_H]), 0);

    // ---- Sobel and gradient products of row j-1 -----------------------
    // plain order: gx = conv_x(conv_y(img, [1,2,1]), [-1,0,1]);
    //              gy = conv_x(conv_y(img, [-1,0,1]), [1,2,1])
    float prod[3][4];
    {
      const Row12 ra = load_row(win, r - 2, cl, cc, cr);
      const Row12 rb = load_row(win, r - 1, cl, cc, cr);
      const Row12 rc = load_row(win, r, cl, cc, cr);
      float s[6], d[6];  // columns 4*lane-1 .. 4*lane+4
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const float a = ra.v[i + 3], m = rb.v[i + 3], e = rc.v[i + 3];
        s[i] = add(add(a, mul(m, 2.0f)), e);
        d[i] = add(add(-a, mul(m, 0.0f)), e);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float gxk = add(add(-s[k], mul(s[k + 1], 0.0f)), s[k + 2]);
        const float gyk = add(add(d[k], mul(d[k + 1], 2.0f)), d[k + 2]);
        prod[0][k] = mul(gxk, gxk);
        prod[1][k] = mul(gyk, gyk);
        prod[2][k] = mul(gxk, gyk);
      }
    }

    // ---- vertical 5-tap blur: row j-1's products are tap 4 of row j-3,
    // tap 3 of j-2, ..., tap 0 of j+1 ----------------------------------------
    float vb[3][4];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float x = prod[c][k];
        vb[c][k] = add(acc[c][3][k], mul(x, g4));
        acc[c][3][k] = add(acc[c][2][k], mul(x, g3));
        acc[c][2][k] = add(acc[c][1][k], mul(x, g2));
        acc[c][1][k] = add(acc[c][0][k], mul(x, g1));
        acc[c][0][k] = mul(x, g0);
      }
    if (j < 6) continue;  // rows 1..4 of products fill the partial sums

    // ---- horizontal blur and Harris of row j-3 --------------------------
    float harris[4];
    {
      float ve[3][8];  // columns 4*lane-2 .. 4*lane+5
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        ve[c][0] = __shfl_up_sync(FULL, vb[c][2], 1);
        ve[c][1] = __shfl_up_sync(FULL, vb[c][3], 1);
#pragma unroll
        for (int k = 0; k < 4; ++k) ve[c][k + 2] = vb[c][k];
        ve[c][6] = __shfl_down_sync(FULL, vb[c][0], 1);
        ve[c][7] = __shfl_down_sync(FULL, vb[c][1], 1);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float I[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float a = mul(ve[c][k], g0);
          a = add(a, mul(ve[c][k + 1], g1));
          a = add(a, mul(ve[c][k + 2], g2));
          a = add(a, mul(ve[c][k + 3], g3));
          I[c] = add(a, mul(ve[c][k + 4], g4));
        }
        const float det = sub(mul(I[0], I[1]), mul(I[2], I[2]));
        const float tr = add(I[0], I[1]);
        harris[k] = sub(det, mul(mul(hk, tr), tr));
      }
    }

    // ---- FAST-9/16 on row j-3, ring rows j-6..j ---------------------------
    float m0[4];
    {
      const int rm = r - 3;
      const Row12 c0 = load_row(win, rm, cl, cc, cr);
      float hi[4], lo[4];
      unsigned br[4] = {0u, 0u, 0u, 0u}, dk[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        // a zero hi becomes +0 and a zero lo -0, so that hi - v and v - lo
        // are -0 for no v (-0 - +0 would be): their signs are then exactly
        // v > hi and v < lo for every finite v
        hi[k] = add(add(c0.v[k + 4], thr), 0.0f);
        lo[k] = -add(-sub(c0.v[k + 4], thr), 0.0f);
      }
      // the 16 ring points (dy, dx) in order, clockwise from (-3, 0): ops/fast.RING
      const Row12 u3 = load_row(win, rm - 3, cl, cc, cr);
      const Row12 u2 = load_row(win, rm - 2, cl, cc, cr);
      const Row12 u1 = load_row(win, rm - 1, cl, cc, cr);
      const Row12 d1 = load_row(win, rm + 1, cl, cc, cr);
      const Row12 d2 = load_row(win, rm + 2, cl, cc, cr);
      const Row12 d3 = load_row(win, rm + 3, cl, cc, cr);
      ring<0>(u3, hi, lo, br, dk);
      ring<1>(u3, hi, lo, br, dk);
      ring<2>(u2, hi, lo, br, dk);
      ring<3>(u1, hi, lo, br, dk);
      ring<3>(c0, hi, lo, br, dk);
      ring<3>(d1, hi, lo, br, dk);
      ring<2>(d2, hi, lo, br, dk);
      ring<1>(d3, hi, lo, br, dk);
      ring<0>(d3, hi, lo, br, dk);
      ring<-1>(d3, hi, lo, br, dk);
      ring<-2>(d2, hi, lo, br, dk);
      ring<-3>(d1, hi, lo, br, dk);
      ring<-3>(c0, hi, lo, br, dk);
      ring<-3>(u1, hi, lo, br, dk);
      ring<-2>(u2, hi, lo, br, dk);
      ring<-1>(u3, hi, lo, br, dk);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        m0[k] = (arc9(br[k]) | arc9(dk[k])) != 0u ? harris[k] : NEG;
    }

    // ---- 3x3 NMS, border, store of row j-4 ------------------------------
    {
      float cm[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) cm[k] = fmaxf(fmaxf(m2[k], m1[k]), m0[k]);
      const float left = __shfl_up_sync(FULL, cm[3], 1);
      const float right = __shfl_down_sync(FULL, cm[0], 1);
      const int gy = y0 + warp * WARP_ROWS + j - 8;  // level row of window row j-4
      if (j >= 8 && store_lane && gy < h) {
        const bool row_in = gy >= p.border && gy < h - p.border;
        float o[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float lft = k == 0 ? left : cm[k - 1];
          const float rgt = k == 3 ? right : cm[k + 1];
          const float nbr = fmaxf(fmaxf(lft, cm[k]), rgt);
          const float m = m1[k];
          const int x = gx + k;
          const bool inb = row_in && x >= p.border && x < w - p.border;
          // m is finite exactly where the pixel is a FAST corner
          o[k] = (inb && m > NEG && m >= nbr) ? m : NEG;
        }
        float* dst = out + out_off + static_cast<size_t>(gy) * w + gx;
        if (vec_store && gx + 3 < w) {
          *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (gx + k < w) dst[k] = o[k];
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        m2[k] = m1[k];
        m1[k] = m0[k];
      }
    }
  }
}

PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                         cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }
  return fn;
}

}  // namespace

extern "C" int detect_pyramid_f32(const float* const* imgs, float* out, const int* table,
                                  int n_levels, float threshold, float harris_k, int border,
                                  const float* taps5, void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS) return -2;
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_fn();
  if (encode == nullptr) return -1;
  Params p = {};
  int n_blocks = 0;
  for (int l = 0; l < n_levels; ++l) {
    const int* row = table + 7 * l;
    const int pitch = row[0], h = row[1], w = row[2];
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(w), static_cast<cuuint64_t>(h)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch) * sizeof(float)};
    const cuuint32_t box[2] = {WIN_W, BAND_H};
    const cuuint32_t elem[2] = {1, 1};
    const CUresult res = encode(
        &p.maps[l], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(imgs[l]), dims,
        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return -(1000 + static_cast<int>(res));
    p.lv[l] = Level{h, w, row[3], row[4], row[6]};
    n_blocks = row[6] + row[4] * row[5];
  }
  p.n_levels = n_levels;
  p.border = border;
  p.threshold = threshold;
  p.harris_k = harris_k;
  for (int k = 0; k < 5; ++k) p.g[k] = taps5[k];
  detect_pyramid_kernel<<<n_blocks, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(p, out);
  return static_cast<int>(cudaGetLastError());
}
