// Baseline and progressive Huffman JPEG decoder whose RGB output equals
// Pillow's `Image.open(f).convert("RGB")` (libjpeg-turbo underneath, with
// `ImageFile.LOAD_TRUNCATED_IMAGES = True`) bit for bit.
//
// What is replicated from libjpeg-turbo, and where it lives there:
//   * Huffman tables (Annex K.3's for an undefined table 0 or 1) and
//     decoding, including the zero bits a decoder reads past the end of a
//     scan's data and the "insufficient data" state that leaves every
//     later block of the scan untouched (jdhuff.c, jdphuff.c, jstdhuff.c);
//   * restart markers and the default resynchronisation (jdmarker.c);
//   * progressive spectral selection and successive approximation, with
//     EOB runs (jdphuff.c);
//   * the ISLOW integer IDCT, clamped as the SIMD build clamps (jidctint.c);
//   * "fancy" triangle upsampling for h2v1, h2v2 and h1v2, box upsampling
//     for other integral factors and for h2 components at most 2 samples
//     wide (jdsample.c); rows above the top and below the bottom repeat the
//     edge row (jdmainct.c);
//   * the fixed-point YCbCr->RGB and YCCK->CMYK tables (jdcolor.c) and the
//     colour space guess from JFIF / Adobe markers and component ids
//     (jdapimin.c).
// Pillow's own steps: a stream that ends early is finished with an EOI
// marker (JpegImagePlugin.load_read), four components are read as inverted
// CMYK ("CMYK;I") and converted with Convert.c's cmyk2rgb, one component is
// replicated to RGB.
//
// Arithmetic coding, 12-bit samples, lossless and hierarchical files, files
// with 2 or more than 4 components, a Huffman table 2 or 3 that the file
// uses but does not define (tables 0 and 1 default to Annex K.3's, as in
// libjpeg-turbo), and a progressive stream cut short so that libjpeg would
// smooth its blocks (jdcoefct.c decompress_smooth_data) are refused: the
// entry points return 1 with a message naming the feature.
//
// Corrupt streams are outside the contract. Where libjpeg stops with an
// error, Pillow (with LOAD_TRUNCATED_IMAGES) returns what it had decoded;
// this decoder raises. Where corrupt data drives coefficients past what any
// 8-bit encoder writes, libjpeg-turbo's SIMD IDCT wraps and saturates in
// 16-bit lanes while this one computes in 64 bits, so pixels may differ.
//
// C interface (loaded with ctypes, see __init__.py):
//   int prismer_jpeg_shape(data, n, int hw[2], err, errlen)
//   int prismer_jpeg_decode(data, n, out, out_size, err, errlen)
// Each returns 0 on success, 1 for a stream it refuses or cannot decode, 2
// for an internal failure (out of memory); `err` then holds the reason.

#include <algorithm>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

struct JpegError : std::exception {
  std::string msg;
  explicit JpegError(std::string m) : msg(std::move(m)) {}
  const char* what() const noexcept override { return msg.c_str(); }
};

[[noreturn]] void fail(const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw JpegError(buf);
}

// zigzag index -> natural index, with 16 guard entries for runs past 63
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// The standard tables of the JPEG spec's Annex K.3, which libjpeg-turbo
// substitutes for a table a scan uses but the file does not define
// (jstdhuff.c; Motion-JPEG frames carry no DHT): DC and AC, luminance (0)
// and chrominance (1), as {bits[1..16], values}.
const uint8_t kStdDcBits[2][16] = {
    {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
    {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
const uint8_t kStdAcBits[2][16] = {
    {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
    {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
const uint8_t kStdAcVals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
     0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
     0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
     0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
     0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
     0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
     0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
     0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
     0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
     0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
     0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
     0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
     0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
     0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
     0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
     0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
     0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
     0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
     0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
     0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
     0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
     0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
     0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
     0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
     0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};
  int32_t valoffset[18] = {};
  uint16_t lookup[1 << kLookBits] = {};  // (length << 8) | symbol, 0 = none

  // jpeg_std_huff_table: install table `index` (0 or 1) of Annex K.3
  void standard(bool dc, int index) {
    if (index > 1)
      fail("JPEG file uses Huffman table %d without defining it", index);
    bits[0] = 0;
    int count = 0;
    for (int i = 1; i <= 16; i++) {
      bits[i] = dc ? kStdDcBits[index][i - 1] : kStdAcBits[index][i - 1];
      count += bits[i];
    }
    std::memset(vals, 0, sizeof vals);
    for (int i = 0; i < count; i++)
      vals[i] = dc ? static_cast<uint8_t>(i) : kStdAcVals[index][i];
    defined = true;
  }

  // jpeg_make_d_derived_tbl
  void derive(bool dc) {
    int huffsize[257];
    uint32_t huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; l++) {
      int i = bits[l];
      if (p + i > 256) fail("corrupt JPEG: bad Huffman table");
      while (i--) huffsize[p++] = l;
    }
    huffsize[p] = 0;
    const int numsymbols = p;
    uint32_t code = 0;
    int si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (1u << si)) fail("corrupt JPEG: bad Huffman table");
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (bits[l]) {
        valoffset[l] = p - static_cast<int32_t>(huffcode[p]);
        p += bits[l];
        maxcode[l] = static_cast<int32_t>(huffcode[p - 1]);
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;
    std::memset(lookup, 0, sizeof lookup);
    p = 0;
    for (int l = 1; l <= kLookBits; l++) {
      for (int i = 1; i <= bits[l]; i++, p++) {
        const uint32_t base = huffcode[p] << (kLookBits - l);
        for (uint32_t c = 0; c < (1u << (kLookBits - l)); c++)
          lookup[base + c] = static_cast<uint16_t>((l << 8) | vals[p]);
      }
    }
    if (dc) {
      for (int i = 0; i < numsymbols; i++)
        if (vals[i] > 15) fail("corrupt JPEG: bad DC Huffman table");
    }
  }
};

// Entropy-coded data reader. Past a marker (or the end of the data, where
// Pillow appends EOI) it yields zero bits; consuming one of those sets
// `insufficient`, as jpeg_fill_bit_buffer does.
struct BitReader {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint64_t buf = 0;  // valid bits at the top
  int cnt = 0;
  bool at_marker = false;
  bool insufficient = false;

  void fill() {
    while (cnt <= 56 && !at_marker) {
      if (p >= end) {
        at_marker = true;
        break;
      }
      uint8_t b = *p;
      if (b == 0xFF) {
        const uint8_t* q = p + 1;
        while (q < end && *q == 0xFF) q++;
        if (q < end && *q == 0) {
          p = q + 1;
        } else {
          p = q - 1;  // the 0xFF before the marker code
          at_marker = true;
          break;
        }
      } else {
        p++;
      }
      buf |= static_cast<uint64_t>(b) << (56 - cnt);
      cnt += 8;
    }
  }
  uint32_t peek(int n) {  // 1 <= n <= 32
    if (cnt < n) fill();
    return static_cast<uint32_t>(buf >> (64 - n));
  }
  void skip(int n) {
    if (n > cnt) fill();
    if (n > cnt) {
      insufficient = true;
      buf = 0;
      cnt = 0;
    } else {
      buf <<= n;
      cnt -= n;
    }
  }
  int get(int n) {
    if (n == 0) return 0;
    const uint32_t v = peek(n);
    skip(n);
    return static_cast<int>(v);
  }
  int decode(const Huffman& h) {
    const uint16_t e = h.lookup[peek(kLookBits)];
    if (e) {
      skip(e >> 8);
      return e & 0xFF;
    }
    for (int l = kLookBits + 1; l <= 16; l++) {
      const int32_t code = static_cast<int32_t>(peek(l));
      if (code <= h.maxcode[l]) {
        skip(l);
        return h.vals[(code + h.valoffset[l]) & 0xFF];
      }
    }
    skip(17);  // libjpeg: "bad Huffman code", a zero is faked
    return 0;
  }
  void discard() {  // at a restart: drop the buffered bits
    buf = 0;
    cnt = 0;
  }
};

inline int extend(int x, int s) {
  return s == 0 ? 0 : (x < (1 << (s - 1)) ? x + (-(1 << s) + 1) : x);
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;    // downsampled width and height in samples
  int wib = 0, hib = 0;  // blocks that hold image samples
  int bw = 0, bh = 0;    // blocks of the coefficient grid (whole MCUs)
  std::vector<int16_t> coef;
  int16_t quant[64] = {};
  bool latched = false;
  int coef_bits[64];
  int dc_pred = 0;
  int td = 0, ta = 0;
  int16_t* block(int bx, int by) {
    return coef.data() + (static_cast<size_t>(by) * bw + bx) * 64;
  }
};

enum class Space { kGrey, kYCbCr, kRGB, kCMYK, kYCCK };

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t n) : data_(data), end_(data + n) {}

  void read_header_only() {
    parse(true);
  }
  int height() const { return height_; }
  int width() const { return width_; }

  void decode(uint8_t* out, size_t out_size) {
    parse(false);
    if (out_size != static_cast<size_t>(width_) * height_ * 3)
      fail("output buffer does not hold %d x %d x 3 bytes", height_, width_);
    finish(out);
  }

 private:
  const uint8_t* data_;
  const uint8_t* end_;
  const uint8_t* pos_ = nullptr;
  const uint8_t* marker_at_ = nullptr;  // code byte of the last marker read
  int width_ = 0, height_ = 0;
  bool progressive_ = false;
  bool have_frame_ = false;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1;
  bool space_fixed_ = false;
  Space space_ = Space::kYCbCr;
  int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  int restart_interval_ = 0;
  int scans_ = 0;
  std::vector<Component> comps_;
  uint16_t qt_[4][64] = {};
  bool qt_defined_[4] = {};
  Huffman dc_[4], ac_[4];

  // ---- markers ----------------------------------------------------------
  int byte() {
    if (pos_ >= end_) fail("JPEG file is truncated inside a marker segment");
    return *pos_++;
  }
  int u16() {
    const int a = byte();
    return (a << 8) | byte();
  }
  // next_marker: skip garbage and fill bytes; the end of the data reads as
  // the EOI that Pillow appends
  int next_marker() {
    for (;;) {
      marker_at_ = nullptr;
      while (pos_ < end_ && *pos_ != 0xFF) pos_++;
      if (pos_ >= end_) return 0xD9;
      while (pos_ < end_ && *pos_ == 0xFF) pos_++;
      if (pos_ >= end_) return 0xD9;
      marker_at_ = pos_;
      const int c = *pos_++;
      if (c != 0) return c;
    }
  }
  const uint8_t* segment(int* len) {
    const int n = u16();
    if (n < 2) fail("corrupt JPEG: bad marker length");
    if (end_ - pos_ < n - 2)
      fail("JPEG file is truncated inside a marker segment");
    const uint8_t* body = pos_;
    pos_ += n - 2;
    *len = n - 2;
    return body;
  }

  void parse(bool header_only) {
    if (end_ - data_ < 2 || data_[0] != 0xFF || data_[1] != 0xD8)
      fail("not a JPEG file (no SOI marker)");
    pos_ = data_ + 2;
    for (;;) {
      const int m = next_marker();
      int len;
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        read_sof(m == 0xC2);
        if (header_only) return;
      } else if (m == 0xC3) {
        fail("lossless JPEG (SOF3) is not supported");
      } else if (m >= 0xC5 && m <= 0xC7) {
        fail("hierarchical JPEG (SOF%d) is not supported", m - 0xC0);
      } else if (m >= 0xC9 && m <= 0xCF && m != 0xCC) {
        fail("arithmetic-coded JPEG (SOF%d) is not supported", m - 0xC0);
      } else if (m == 0xDE || m == 0xDF) {
        fail("hierarchical JPEG (DHP/EXP marker) is not supported");
      } else if (m == 0xC4) {
        read_dht();
      } else if (m == 0xDB) {
        read_dqt();
      } else if (m == 0xDD) {
        const uint8_t* b = segment(&len);
        if (len != 2) fail("corrupt JPEG: bad DRI length");
        restart_interval_ = (b[0] << 8) | b[1];
      } else if (m == 0xDA) {
        if (!have_frame_) fail("corrupt JPEG: SOS before SOF");
        read_scan();
      } else if (m == 0xD9) {
        if (!have_frame_) fail("JPEG file has no frame (no SOF marker)");
        if (scans_ == 0) fail("JPEG file has no scan");
        return;
      } else if (m == 0xE0) {
        const uint8_t* b = segment(&len);
        if (len >= 14 && !std::memcmp(b, "JFIF\0", 5)) jfif_ = true;
      } else if (m == 0xEE) {
        const uint8_t* b = segment(&len);
        if (len >= 12 && !std::memcmp(b, "Adobe", 5)) {
          adobe_ = true;
          adobe_transform_ = b[11];
        }
      } else if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE || m == 0xCC ||
                 m == 0xDC) {
        segment(&len);  // other APPn, COM, DAC, DNL
      } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
        // RSTn outside a scan, TEM: no parameters
      } else {
        fail("corrupt JPEG: unknown marker 0x%02X", m);
      }
    }
  }

  void read_sof(bool progressive) {
    if (have_frame_) fail("corrupt JPEG: second SOF marker");
    int len;
    const uint8_t* b = segment(&len);
    if (len < 6) fail("corrupt JPEG: bad SOF length");
    if (b[0] != 8)
      fail("%d-bit JPEG samples are not supported (8-bit only)", b[0]);
    height_ = (b[1] << 8) | b[2];
    width_ = (b[3] << 8) | b[4];
    const int nc = b[5];
    if (height_ == 0 || width_ == 0 || nc == 0)
      fail("corrupt JPEG: empty image");
    if (len != 6 + 3 * nc) fail("corrupt JPEG: bad SOF length");
    if (nc != 1 && nc != 3 && nc != 4)
      fail("JPEG files with %d components are not supported", nc);
    progressive_ = progressive;
    comps_.resize(nc);
    for (int i = 0; i < nc; i++) {
      Component& c = comps_[i];
      c.id = b[6 + 3 * i];
      c.h = b[7 + 3 * i] >> 4;
      c.v = b[7 + 3 * i] & 15;
      c.tq = b[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4)
        fail("corrupt JPEG: bad sampling factors");
      if (c.tq > 3) fail("corrupt JPEG: bad quantization table index");
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
    }
    mcux_ = (width_ + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (height_ + 8 * vmax_ - 1) / (8 * vmax_);
    for (Component& c : comps_) {
      c.dw = static_cast<int>(
          (static_cast<int64_t>(width_) * c.h + hmax_ - 1) / hmax_);
      c.dh = static_cast<int>(
          (static_cast<int64_t>(height_) * c.v + vmax_ - 1) / vmax_);
      c.wib = (c.dw + 7) / 8;
      c.hib = (c.dh + 7) / 8;
      c.bw = mcux_ * c.h;
      c.bh = mcuy_ * c.v;
      for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
    }
    have_frame_ = true;
  }

  void allocate() {
    for (Component& c : comps_)
      if (c.coef.empty())
        c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
  }

  void read_dht() {
    int len;
    const uint8_t* b = segment(&len);
    const uint8_t* e = b + len;
    while (e - b > 16) {
      const int index = *b++;
      if (index & ~0x13) fail("corrupt JPEG: bad DHT index");
      Huffman& h = (index & 0x10) ? ac_[index & 3] : dc_[index & 3];
      int count = 0;
      h.bits[0] = 0;
      for (int i = 1; i <= 16; i++) {
        h.bits[i] = *b++;
        count += h.bits[i];
      }
      if (count > 256 || count > e - b)
        fail("corrupt JPEG: bad Huffman table");
      std::memset(h.vals, 0, sizeof h.vals);
      std::memcpy(h.vals, b, count);
      b += count;
      h.defined = true;
    }
    if (b != e) fail("corrupt JPEG: bad DHT length");
  }

  void read_dqt() {
    int len;
    const uint8_t* b = segment(&len);
    const uint8_t* e = b + len;
    while (b < e) {
      const int pq = *b >> 4, tq = *b & 15;
      b++;
      if (tq > 3 || pq > 1) fail("corrupt JPEG: bad DQT table");
      if (e - b < (pq ? 128 : 64)) fail("corrupt JPEG: bad DQT length");
      for (int i = 0; i < 64; i++) {
        int v = *b++;
        if (pq) v = (v << 8) | *b++;
        qt_[tq][kNatural[i]] = static_cast<uint16_t>(v);
      }
      qt_defined_[tq] = true;
    }
  }

  void fix_space() {  // default_decompress_parms, at the first SOS
    if (space_fixed_) return;
    space_fixed_ = true;
    const int n = static_cast<int>(comps_.size());
    if (n == 1) {
      space_ = Space::kGrey;
    } else if (n == 3) {
      if (jfif_) {
        space_ = Space::kYCbCr;
      } else if (adobe_) {
        space_ = adobe_transform_ == 0 ? Space::kRGB : Space::kYCbCr;
      } else {
        const int a = comps_[0].id, b = comps_[1].id, c = comps_[2].id;
        space_ = (a == 82 && b == 71 && c == 66) ? Space::kRGB : Space::kYCbCr;
      }
    } else {
      space_ = (adobe_ && adobe_transform_ != 0) ? Space::kYCCK : Space::kCMYK;
    }
  }

  // ---- scans ------------------------------------------------------------
  void read_scan() {
    int len;
    const uint8_t* b = segment(&len);
    const int ns = len >= 1 ? b[0] : 0;
    if (ns < 1 || ns > 4 || len != 2 * ns + 4)
      fail("corrupt JPEG: bad SOS length");
    fix_space();
    allocate();
    std::vector<Component*> sc;
    for (int i = 0; i < ns; i++) {
      const int id = b[1 + 2 * i], t = b[2 + 2 * i];
      Component* c = nullptr;
      for (Component& k : comps_)
        if (k.id == id) c = &k;
      if (c == nullptr) fail("corrupt JPEG: scan names unknown component");
      for (Component* k : sc)
        if (k == c) fail("corrupt JPEG: component twice in one scan");
      c->td = t >> 4;
      c->ta = t & 15;
      if (c->td > 3 || c->ta > 3)
        fail("corrupt JPEG: bad Huffman table index");
      if (!c->latched) {  // latch_quant_tables
        if (!qt_defined_[c->tq]) fail("corrupt JPEG: missing quantization table");
        for (int k = 0; k < 64; k++)
          c->quant[k] = static_cast<int16_t>(qt_[c->tq][k]);
        c->latched = true;
      }
      sc.push_back(c);
    }
    const int ss = b[1 + 2 * ns], se = b[2 + 2 * ns];
    const int ah = b[3 + 2 * ns] >> 4, al = b[3 + 2 * ns] & 15;
    int blocks_in_mcu = 0;
    for (Component* c : sc) blocks_in_mcu += c->h * c->v;
    if (ns > 1 && blocks_in_mcu > 10) fail("corrupt JPEG: MCU too large");

    if (progressive_) {
      const bool dc = ss == 0;
      bool bad = false;
      if (dc) {
        if (se != 0) bad = true;
      } else {
        if (ss > se || se > 63 || ns != 1) bad = true;
      }
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) fail("corrupt JPEG: bad progressive scan parameters");
      for (Component* c : sc)
        for (int k = ss; k <= se; k++) c->coef_bits[k] = al;
    } else if (ss != 0 || se != 63 || ah != 0 || al != 0) {
      fail("sequential JPEG scan with Ss=%d Se=%d Ah=%d Al=%d is not "
           "supported", ss, se, ah, al);
    }
    const bool need_dc = !progressive_ || (ss == 0 && ah == 0);
    const bool need_ac = !progressive_ || ss != 0;
    for (Component* c : sc) {
      if (need_dc && !dc_[c->td].defined) dc_[c->td].standard(true, c->td);
      if (need_ac && !ac_[c->ta].defined) ac_[c->ta].standard(false, c->ta);
      if (need_dc) dc_[c->td].derive(true);
      if (need_ac) ac_[c->ta].derive(false);
      c->dc_pred = 0;
    }
    scans_++;

    BitReader br;
    br.p = pos_;
    br.end = end_;
    int eobrun = 0;
    int restarts_to_go = restart_interval_;
    int next_rst = 0;

    auto block_op = [&](Component* c, int16_t* blk) {
      if (!progressive_) {
        decode_sequential(br, c, blk);
      } else if (ss == 0) {
        if (ah == 0) {
          int s = br.decode(dc_[c->td]);
          if (s) s = extend(br.get(s), s);
          s += c->dc_pred;
          c->dc_pred = s;
          blk[0] = static_cast<int16_t>(static_cast<uint32_t>(s) << al);
        } else if (br.get(1)) {
          blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
        }
      } else if (ah == 0) {
        ac_first(br, ac_[c->ta], blk, ss, se, al, &eobrun);
      } else {
        ac_refine(br, ac_[c->ta], blk, ss, se, al, &eobrun);
      }
    };
    // DC refinement reads its bits even when the data ran out (zeros leave
    // the coefficients as they are); every other scan skips the MCU
    const bool always = progressive_ && ss == 0 && ah != 0;

    auto mcu_start = [&]() {
      if (restart_interval_) {
        if (restarts_to_go == 0) {
          restart(br, &next_rst);
          for (Component* c : sc) c->dc_pred = 0;
          eobrun = 0;
          restarts_to_go = restart_interval_;
        }
        restarts_to_go--;
      }
      return always || !br.insufficient;
    };

    if (ns == 1) {
      Component* c = sc[0];
      for (int by = 0; by < c->hib; by++)
        for (int bx = 0; bx < c->wib; bx++)
          if (mcu_start()) block_op(c, c->block(bx, by));
    } else {
      for (int my = 0; my < mcuy_; my++)
        for (int mx = 0; mx < mcux_; mx++) {
          if (!mcu_start()) continue;
          for (Component* c : sc)
            for (int y = 0; y < c->v; y++)
              for (int x = 0; x < c->h; x++)
                block_op(c, c->block(mx * c->h + x, my * c->v + y));
        }
    }
    pos_ = br.p;
  }

  // read_restart_marker + jpeg_resync_to_restart
  void restart(BitReader& br, int* next_rst) {
    br.discard();
    pos_ = br.p;
    int marker = next_marker();
    const int desired = *next_rst;
    for (;;) {
      int action;
      if (marker < 0xC0) {
        action = 2;
      } else if (marker < 0xD0 || marker > 0xD7) {
        action = 3;
      } else if (marker == 0xD0 + ((desired + 1) & 7) ||
                 marker == 0xD0 + ((desired + 2) & 7)) {
        action = 3;
      } else if (marker == 0xD0 + ((desired - 1) & 7) ||
                 marker == 0xD0 + ((desired - 2) & 7)) {
        action = 2;
      } else {
        action = 1;
      }
      if (action == 1) {  // consumed: the next segment starts after it
        br.p = pos_;
        br.at_marker = false;
        br.insufficient = false;
        break;
      }
      if (action == 3) {  // left unread: the reader sees it and reads zeros
        br.p = marker_at_ ? marker_at_ - 1 : end_;
        br.at_marker = true;
        break;
      }
      marker = next_marker();
    }
    *next_rst = (desired + 1) & 7;
  }

  void decode_sequential(BitReader& br, Component* c, int16_t* blk) {
    int s = br.decode(dc_[c->td]);
    if (s) s = extend(br.get(s), s);
    const int64_t sum = static_cast<int64_t>(s) + c->dc_pred;
    if (sum > INT32_MAX || sum < INT32_MIN) fail("corrupt JPEG: DC overflow");
    c->dc_pred = static_cast<int>(sum);
    blk[0] = static_cast<int16_t>(c->dc_pred);
    const Huffman& ac = ac_[c->ta];
    for (int k = 1; k < 64; k++) {
      int rs = br.decode(ac);
      const int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(extend(br.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  static void ac_first(BitReader& br, const Huffman& h, int16_t* blk, int ss,
                       int se, int al, int* eobrun) {
    if (*eobrun > 0) {
      (*eobrun)--;
      return;
    }
    for (int k = ss; k <= se; k++) {
      const int rs = br.decode(h);
      int r = rs >> 4;
      const int s = rs & 15;
      if (s) {
        k += r;
        const int v = extend(br.get(s), s);
        blk[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(v) << al);
      } else if (r == 15) {
        k += 15;
      } else {
        int run = 1 << r;
        if (r) run += br.get(r);
        *eobrun = run - 1;
        break;
      }
    }
  }

  static void ac_refine(BitReader& br, const Huffman& h, int16_t* blk, int ss,
                        int se, int al, int* eobrun) {
    const int p1 = 1 << al;
    const int m1 = static_cast<int>(static_cast<uint32_t>(-1) << al);
    int k = ss;
    auto correct = [&](int16_t* coef) {
      if (br.get(1) && (*coef & p1) == 0)
        *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
    };
    if (*eobrun == 0) {
      for (; k <= se; k++) {
        const int rs = br.decode(h);
        int r = rs >> 4;
        int s = rs & 15;
        if (s) {
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          *eobrun = 1 << r;
          if (r) *eobrun += br.get(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            correct(coef);
          } else if (--r < 0) {
            break;
          }
          k++;
        } while (k <= se);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (*eobrun > 0) {
      for (; k <= se; k++) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) correct(coef);
      }
      (*eobrun)--;
    }
  }

  // ---- output -----------------------------------------------------------
  // smoothing_ok (jdcoefct.c, 10 saved coefficients): libjpeg smooths the
  // blocks of a progressive image whose first AC coefficients never got
  // all their bits
  bool would_smooth() const {
    if (!progressive_) return false;
    bool useful = false;
    for (const Component& c : comps_) {
      if (!c.latched) return false;
      static const int kQ[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
      for (int q : kQ)
        if (c.quant[q] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; k++)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  static void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out,
                         int stride) {
    constexpr int kConst = 13, kPass1 = 2;
    constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                      F0899 = 7373, F1175 = 9633, F1501 = 12299,
                      F1847 = 15137, F1961 = 16069, F2053 = 16819,
                      F2562 = 20995, F3072 = 25172;
    auto descale = [](int64_t x, int n) {
      return (x + (int64_t{1} << (n - 1))) >> n;
    };
    int ws[64];
    for (int col = 0; col < 8; col++) {
      const int16_t* i = in + col;
      const int16_t* qq = q + col;
      int* w = ws + col;
      auto dq = [&](int r) { return static_cast<int64_t>(i[8 * r]) * qq[8 * r]; };
      if (!i[8] && !i[16] && !i[24] && !i[32] && !i[40] && !i[48] && !i[56]) {
        const int dc = static_cast<int>(dq(0) * (1 << kPass1));
        for (int r = 0; r < 8; r++) w[8 * r] = dc;
        continue;
      }
      int64_t z2 = dq(2), z3 = dq(6);
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      z2 = dq(0);
      z3 = dq(4);
      int64_t tmp0 = (z2 + z3) * (1 << kConst);
      int64_t tmp1 = (z2 - z3) * (1 << kConst);
      const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = dq(7);
      tmp1 = dq(5);
      tmp2 = dq(3);
      tmp3 = dq(1);
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      const int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      constexpr int n = kConst - kPass1;
      w[0] = static_cast<int>(descale(tmp10 + tmp3, n));
      w[56] = static_cast<int>(descale(tmp10 - tmp3, n));
      w[8] = static_cast<int>(descale(tmp11 + tmp2, n));
      w[48] = static_cast<int>(descale(tmp11 - tmp2, n));
      w[16] = static_cast<int>(descale(tmp12 + tmp1, n));
      w[40] = static_cast<int>(descale(tmp12 - tmp1, n));
      w[24] = static_cast<int>(descale(tmp13 + tmp0, n));
      w[32] = static_cast<int>(descale(tmp13 - tmp0, n));
    }
    auto clamp = [](int64_t x) {  // the SIMD build saturates, then adds 128
      return static_cast<uint8_t>(std::min<int64_t>(127, std::max<int64_t>(-128, x)) + 128);
    };
    for (int row = 0; row < 8; row++) {
      const int* w = ws + 8 * row;
      uint8_t* o = out + static_cast<size_t>(row) * stride;
      constexpr int n = kConst + kPass1 + 3;
      int64_t z2 = w[2], z3 = w[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = (static_cast<int64_t>(w[0]) + w[4]) * (1 << kConst);
      int64_t tmp1 = (static_cast<int64_t>(w[0]) - w[4]) * (1 << kConst);
      const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = w[7];
      tmp1 = w[5];
      tmp2 = w[3];
      tmp3 = w[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      const int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      o[0] = clamp(descale(tmp10 + tmp3, n));
      o[7] = clamp(descale(tmp10 - tmp3, n));
      o[1] = clamp(descale(tmp11 + tmp2, n));
      o[6] = clamp(descale(tmp11 - tmp2, n));
      o[2] = clamp(descale(tmp12 + tmp1, n));
      o[5] = clamp(descale(tmp12 - tmp1, n));
      o[3] = clamp(descale(tmp13 + tmp0, n));
      o[4] = clamp(descale(tmp13 - tmp0, n));
    }
  }

  // One component, IDCT'd and upsampled to (rows >= height_) x stride
  // samples; returns the stride.
  int component_plane(Component& c, std::vector<uint8_t>* full) {
    const int pw = c.wib * 8, ph = c.hib * 8;
    std::vector<uint8_t> plane(static_cast<size_t>(pw) * ph);
    for (int by = 0; by < c.hib; by++)
      for (int bx = 0; bx < c.wib; bx++)
        idct_islow(c.block(bx, by), c.quant,
                   plane.data() + static_cast<size_t>(by) * 8 * pw + bx * 8,
                   pw);
    const int hf = hmax_ / c.h, vf = vmax_ / c.v;
    if (hf * c.h != hmax_ || vf * c.v != vmax_)
      fail("JPEG sampling factors with a fractional ratio are not supported");
    const int ow = std::max(pw * hf, width_);
    full->assign(static_cast<size_t>(ow) * height_, 0);
    auto in = [&](int y) {
      y = std::min(std::max(y, 0), c.dh - 1);  // edge rows repeat
      return plane.data() + static_cast<size_t>(y) * pw;
    };
    auto out = [&](int y) { return full->data() + static_cast<size_t>(y) * ow; };
    const int dw = c.dw;
    if (hf == 1 && vf == 1) {
      for (int y = 0; y < height_; y++) std::memcpy(out(y), in(y), dw);
    } else if (hf == 2 && vf == 1 && dw > 2) {  // h2v1_fancy_upsample
      for (int y = 0; y < height_; y++) {
        const uint8_t* i = in(y);
        uint8_t* o = out(y);
        o[0] = i[0];
        o[1] = static_cast<uint8_t>((i[0] * 3 + i[1] + 2) >> 2);
        for (int x = 1; x < dw - 1; x++) {
          const int v = i[x] * 3;
          o[2 * x] = static_cast<uint8_t>((v + i[x - 1] + 1) >> 2);
          o[2 * x + 1] = static_cast<uint8_t>((v + i[x + 1] + 2) >> 2);
        }
        o[2 * dw - 2] = static_cast<uint8_t>((i[dw - 1] * 3 + i[dw - 2] + 1) >> 2);
        o[2 * dw - 1] = i[dw - 1];
      }
    } else if (hf == 1 && vf == 2) {  // h1v2_fancy_upsample
      for (int y = 0; y < height_; y++) {
        const int iy = y >> 1;
        const uint8_t* i0 = in(iy);
        const uint8_t* i1 = in((y & 1) ? iy + 1 : iy - 1);
        const int bias = (y & 1) ? 2 : 1;
        uint8_t* o = out(y);
        for (int x = 0; x < dw; x++)
          o[x] = static_cast<uint8_t>((i0[x] * 3 + i1[x] + bias) >> 2);
      }
    } else if (hf == 2 && vf == 2 && dw > 2) {  // h2v2_fancy_upsample
      std::vector<int> sum(dw);
      for (int y = 0; y < height_; y++) {
        const int iy = y >> 1;
        const uint8_t* i0 = in(iy);
        const uint8_t* i1 = in((y & 1) ? iy + 1 : iy - 1);
        for (int x = 0; x < dw; x++) sum[x] = i0[x] * 3 + i1[x];
        uint8_t* o = out(y);
        o[0] = static_cast<uint8_t>((sum[0] * 4 + 8) >> 4);
        o[1] = static_cast<uint8_t>((sum[0] * 3 + sum[1] + 7) >> 4);
        for (int x = 1; x < dw - 1; x++) {
          o[2 * x] = static_cast<uint8_t>((sum[x] * 3 + sum[x - 1] + 8) >> 4);
          o[2 * x + 1] = static_cast<uint8_t>((sum[x] * 3 + sum[x + 1] + 7) >> 4);
        }
        o[2 * dw - 2] = static_cast<uint8_t>((sum[dw - 1] * 3 + sum[dw - 2] + 8) >> 4);
        o[2 * dw - 1] = static_cast<uint8_t>((sum[dw - 1] * 4 + 7) >> 4);
      }
    } else {  // box: h2v1_upsample, h2v2_upsample, int_upsample
      for (int y = 0; y < height_; y++) {
        const uint8_t* i = in(y / vf);
        uint8_t* o = out(y);
        for (int x = 0; x < width_; x++) o[x] = i[x / hf];
      }
    }
    return ow;
  }

  void finish(uint8_t* rgb) {
    if (would_smooth())
      fail("progressive JPEG whose scans stop before every coefficient is "
           "complete (libjpeg smooths such blocks) is not supported");
    for (Component& c : comps_)
      if (!c.latched) fail("JPEG file has a component that no scan codes");
    const int n = static_cast<int>(comps_.size());
    std::vector<std::vector<uint8_t>> planes(n);
    std::vector<int> stride(n);
    for (int i = 0; i < n; i++) stride[i] = component_plane(comps_[i], &planes[i]);
    auto sample = [&](int i, int y, int x) {
      return static_cast<int>(planes[i][static_cast<size_t>(y) * stride[i] + x]);
    };
    // jdcolor.c build_ycc_rgb_table
    constexpr int kBits = 16;
    constexpr int64_t kHalf = int64_t{1} << (kBits - 1);
    auto fix = [](double x) { return static_cast<int64_t>(x * (1 << kBits) + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; i++) {
      const int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kBits);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kBits);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
    auto lim = [](int64_t v) {
      return static_cast<int>(std::min<int64_t>(255, std::max<int64_t>(0, v)));
    };
    auto muldiv255 = [](int a, int b) {
      const int t = a * b + 128;
      return ((t >> 8) + t) >> 8;
    };
    for (int y = 0; y < height_; y++) {
      uint8_t* o = rgb + static_cast<size_t>(y) * width_ * 3;
      for (int x = 0; x < width_; x++, o += 3) {
        if (space_ == Space::kGrey) {
          o[0] = o[1] = o[2] = static_cast<uint8_t>(sample(0, y, x));
          continue;
        }
        const int a = sample(0, y, x), b = sample(1, y, x), c = sample(2, y, x);
        if (space_ == Space::kRGB) {
          o[0] = static_cast<uint8_t>(a);
          o[1] = static_cast<uint8_t>(b);
          o[2] = static_cast<uint8_t>(c);
          continue;
        }
        int r, g, bl;
        if (space_ == Space::kYCbCr || space_ == Space::kYCCK) {
          r = lim(a + cr_r[c]);
          g = lim(a + ((cb_g[b] + cr_g[c]) >> kBits));
          bl = lim(a + cb_b[b]);
          if (space_ == Space::kYCbCr) {
            o[0] = static_cast<uint8_t>(r);
            o[1] = static_cast<uint8_t>(g);
            o[2] = static_cast<uint8_t>(bl);
            continue;
          }
          // ycck_cmyk_convert: C = 255 - R, ...
          r = lim(255 - (a + cr_r[c]));
          g = lim(255 - (a + ((cb_g[b] + cr_g[c]) >> kBits)));
          bl = lim(255 - (a + cb_b[b]));
        } else {
          r = a;
          g = b;
          bl = c;
        }
        // Pillow: "CMYK;I" inverts every channel, then cmyk2rgb
        const int k = sample(3, y, x);  // 255 - inverted K
        const int cmy[3] = {255 - r, 255 - g, 255 - bl};
        for (int j = 0; j < 3; j++)
          o[j] = static_cast<uint8_t>(lim(k - muldiv255(cmy[j], k)));
      }
    }
  }
};

int report(const char* msg, char* err, size_t errlen) {
  if (err && errlen) {
    std::strncpy(err, msg, errlen - 1);
    err[errlen - 1] = 0;
  }
  return 1;
}

}  // namespace

extern "C" {

int prismer_jpeg_shape(const uint8_t* data, size_t n, int* hw, char* err,
                       size_t errlen) {
  try {
    Decoder d(data, n);
    d.read_header_only();
    hw[0] = d.height();
    hw[1] = d.width();
    return 0;
  } catch (const JpegError& e) {
    return report(e.what(), err, errlen);
  } catch (const std::exception& e) {
    report(e.what(), err, errlen);
    return 2;
  }
}

int prismer_jpeg_decode(const uint8_t* data, size_t n, uint8_t* out,
                        size_t out_size, char* err, size_t errlen) {
  try {
    Decoder d(data, n);
    d.decode(out, out_size);
    return 0;
  } catch (const JpegError& e) {
    return report(e.what(), err, errlen);
  } catch (const std::exception& e) {
    report(e.what(), err, errlen);
    return 2;
  }
}

}  // extern "C"
