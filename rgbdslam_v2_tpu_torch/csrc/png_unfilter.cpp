// PNG row unfiltering (PNG specification, section 9: filter method 0) on
// the host, for io/png.py.
//
// Each filtered row is one filter-type byte followed by row_bytes bytes.
// Reconstruction reads the bytes already reconstructed to the left (a, at
// bpp bytes before) and above (b, and c above-left), so within an image the
// work is a sequential recurrence; the caller runs one image per thread.
//
// Built with g++ -O3 -shared -fPIC into a plain-C shared library by
// rgbdslam_v2_tpu_torch/backend.py and called through ctypes (which
// releases the GIL for the call).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// The Paeth predictor with ties to a, then b, then c, without branches on
// the data (selects the compiler turns into conditional moves): pa, pb and
// pc are |p - a|, |p - b| and |p - c| for p = a + b - c.
inline int paeth(int a, int b, int c) {
    const int pa = std::abs(b - c);
    const int pb = std::abs(a - c);
    const int pc = std::abs(a + b - 2 * c);
    const int best_ab = pb < pa ? b : a;
    const int p_ab = pb < pa ? pb : pa;
    return pc < p_ab ? c : best_ab;
}

}  // namespace

extern "C" {

// src: rows * (1 + row_bytes) filtered bytes; dst: rows * row_bytes
// reconstructed bytes; bpp: bytes per complete pixel (>= 1). Returns 0, or
// 1 + the index of the first row whose filter type is not 0-4. The first
// row reads a row of zeros above it; the first bpp bytes of a row read
// zeros to their left.
int png_unfilter(const uint8_t* src, uint8_t* dst, int64_t rows, int64_t row_bytes,
                 int bpp) {
    const std::vector<uint8_t> zeros(static_cast<size_t>(row_bytes), 0);
    const uint8_t* prior = zeros.data();
    const int64_t lead = bpp < row_bytes ? bpp : row_bytes;  // bytes with no left neighbour
    for (int64_t r = 0; r < rows; ++r) {
        const uint8_t type = src[0];
        const uint8_t* f = src + 1;
        uint8_t* out = dst;
        switch (type) {
            case 0:
                std::memcpy(out, f, static_cast<size_t>(row_bytes));
                break;
            case 1:
                std::memcpy(out, f, static_cast<size_t>(lead));
                for (int64_t x = lead; x < row_bytes; ++x)
                    out[x] = static_cast<uint8_t>(f[x] + out[x - bpp]);
                break;
            case 2:
                for (int64_t x = 0; x < row_bytes; ++x)
                    out[x] = static_cast<uint8_t>(f[x] + prior[x]);
                break;
            case 3:
                for (int64_t x = 0; x < lead; ++x)
                    out[x] = static_cast<uint8_t>(f[x] + (prior[x] >> 1));
                for (int64_t x = lead; x < row_bytes; ++x)
                    out[x] = static_cast<uint8_t>(f[x] + ((out[x - bpp] + prior[x]) >> 1));
                break;
            case 4:
                // at x < bpp, a = c = 0, so the predictor is b
                for (int64_t x = 0; x < lead; ++x)
                    out[x] = static_cast<uint8_t>(f[x] + prior[x]);
                for (int64_t x = lead; x < row_bytes; ++x)
                    out[x] = static_cast<uint8_t>(
                        f[x] + paeth(out[x - bpp], prior[x], prior[x - bpp]));
                break;
            default:
                return static_cast<int>(r + 1);
        }
        prior = out;
        src += row_bytes + 1;
        dst += row_bytes;
    }
    return 0;
}

}  // extern "C"
