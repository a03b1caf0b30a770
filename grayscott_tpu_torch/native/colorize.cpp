// Native host-pipeline kernels for data-to-pics / livesim: colorize and
// PNG encode.
//
// C++ re-design of the reference's native output stages — the
// rayon-parallel colorize (data-to-pics/src/main.rs:126-144: recursive
// row split, per pixel INFERNO.eval_continuous(AMPLITUDE_SCALE * v)) and
// the `image` crate's PNG writer on the output threads (main.rs:98-104).
// Exposed through ctypes (grayscott_tpu/native/__init__.py); colorize
// semantics bit-match the NumPy fallback in grayscott_tpu/utils/palette.py
// and the PNG stream is standard (zlib + Sub row filter), decodable by any
// reader.
//
// Build: see grayscott_tpu/native/__init__.py (g++ -O3 -shared -fPIC -lz).

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

void colorize_range(const float* v, size_t begin, size_t end,
                    const uint8_t* lut, float scale, uint8_t* out) {
  for (size_t i = begin; i < end; ++i) {
    float t = v[i] * scale;
    // NaN-safe clamp: std::min/std::max propagate NaN here, and a NaN t
    // would index wild memory below (a diverged simulation writes NaN
    // snapshots, e.g. dt too large). Map NaN to 0, matching the NumPy
    // fallback in utils/palette.py.
    t = t > 0.0f ? (t < 1.0f ? t : 1.0f) : 0.0f;
    float x = t * 255.0f;
    int lo = static_cast<int>(x);  // x in [0, 255] => trunc == floor
    int hi = std::min(lo + 1, 255);
    float frac = x - static_cast<float>(lo);
    const uint8_t* a = lut + 3 * lo;
    const uint8_t* b = lut + 3 * hi;
    for (int k = 0; k < 3; ++k) {
      float c = static_cast<float>(a[k]) * (1.0f - frac) +
                static_cast<float>(b[k]) * frac;
      out[3 * i + k] = static_cast<uint8_t>(c + 0.5f);
    }
  }
}

void put_be32(uint8_t* p, uint32_t v) {
  p[0] = static_cast<uint8_t>(v >> 24);
  p[1] = static_cast<uint8_t>(v >> 16);
  p[2] = static_cast<uint8_t>(v >> 8);
  p[3] = static_cast<uint8_t>(v);
}

// Writes one PNG chunk (length, type, payload, CRC) at `out`; returns its
// total size. CRC covers type + payload (PNG spec 5.3).
size_t write_chunk(uint8_t* out, const char type[4], const uint8_t* data,
                   size_t len) {
  put_be32(out, static_cast<uint32_t>(len));
  std::memcpy(out + 4, type, 4);
  if (len) std::memcpy(out + 8, data, len);
  uLong crc = crc32(0L, Z_NULL, 0);
  crc = crc32(crc, out + 4, static_cast<uInt>(4 + len));
  put_be32(out + 8 + len, static_cast<uint32_t>(crc));
  return 12 + len;
}

}  // namespace

extern "C" {

// Encode an 8-bit RGB image as a complete PNG stream into `out`.
// rgb: height*width*3 bytes, row-major. level: 1..9; levels <= 3 select
// zlib's Z_RLE strategy — run-length-only matching, ~5x faster than the
// default strategy at level 6 and SMALLER than plain level-1/2 on smooth
// gradient fields (Sub-filtered INFERNO renderings are long runs of tiny
// deltas). This is the analog of the fast fdeflate encoder behind the
// reference's `image`-crate PNG writer (data-to-pics/src/main.rs:98-104);
// levels >= 4 use the standard strategy for smaller archival files. The
// Sub row filter is applied first either way. Returns bytes written, or 0
// when out_cap is too small / zlib fails. Call gs_png_bound() for a safe
// capacity.
size_t gs_png_bound(int width, int height) {
  size_t raw = static_cast<size_t>(height) * (static_cast<size_t>(width) * 3 + 1);
  return 8 + 25 + 12 + 12 + compressBound(static_cast<uLong>(raw)) + 64;
}

size_t gs_png_encode(const uint8_t* rgb, int width, int height, int level,
                     uint8_t* out, size_t out_cap) {
  if (width <= 0 || height <= 0) return 0;
  const size_t row = static_cast<size_t>(width) * 3;
  const size_t raw = static_cast<size_t>(height) * (row + 1);
  // single-pass deflate: zlib's 32-bit avail_in caps the filtered size
  if (raw > 0xFFFFFFFFull / 2) return 0;
  std::vector<uint8_t> filt(raw);
  for (int y = 0; y < height; ++y) {
    uint8_t* d = filt.data() + static_cast<size_t>(y) * (row + 1);
    const uint8_t* s = rgb + static_cast<size_t>(y) * row;
    d[0] = 1;  // Sub filter
    d[1] = s[0];
    d[2] = s[1];
    d[3] = s[2];
    for (size_t i = 3; i < row; ++i) {
      d[1 + i] = static_cast<uint8_t>(s[i] - s[i - 3]);
    }
  }
  uLongf comp_len = compressBound(static_cast<uLong>(raw));
  std::vector<uint8_t> comp(comp_len);
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  const int strategy = level <= 3 ? Z_RLE : Z_DEFAULT_STRATEGY;
  if (deflateInit2(&zs, level, Z_DEFLATED, 15, 8, strategy) != Z_OK) {
    return 0;
  }
  zs.next_in = filt.data();
  zs.avail_in = static_cast<uInt>(raw);
  zs.next_out = comp.data();
  zs.avail_out = static_cast<uInt>(comp_len);
  const int rc = deflate(&zs, Z_FINISH);
  comp_len = static_cast<uLongf>(zs.total_out);
  deflateEnd(&zs);
  if (rc != Z_STREAM_END) return 0;
  const size_t need = 8 + 25 + (12 + comp_len) + 12;
  if (out_cap < need) return 0;
  static const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  std::memcpy(out, sig, 8);
  size_t off = 8;
  uint8_t ihdr[13];
  put_be32(ihdr, static_cast<uint32_t>(width));
  put_be32(ihdr + 4, static_cast<uint32_t>(height));
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // color type: truecolor RGB
  ihdr[10] = 0;  // compression: deflate
  ihdr[11] = 0;  // filter method 0
  ihdr[12] = 0;  // no interlace
  off += write_chunk(out + off, "IHDR", ihdr, 13);
  off += write_chunk(out + off, "IDAT", comp.data(), comp_len);
  off += write_chunk(out + off, "IEND", nullptr, 0);
  return off;
}

// values: n float32 concentrations; lut: 256*3 uint8; out: n*3 uint8.
void gs_colorize(const float* values, size_t n, const uint8_t* lut,
                 float scale, uint8_t* out, int num_threads) {
  if (num_threads <= 1 || n < (1u << 16)) {
    colorize_range(values, 0, n, lut, scale, out);
    return;
  }
  size_t chunk = (n + num_threads - 1) / num_threads;
  std::vector<std::thread> workers;
  workers.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) {
    size_t begin = std::min(static_cast<size_t>(t) * chunk, n);
    size_t end = std::min(begin + chunk, n);
    if (begin >= end) break;
    workers.emplace_back(colorize_range, values, begin, end, lut, scale, out);
  }
  for (auto& w : workers) w.join();
}

int gs_native_abi_version(void) { return 4; }

}  // extern "C"
