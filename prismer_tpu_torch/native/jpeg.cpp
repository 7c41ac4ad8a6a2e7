// JPEG decoder whose RGB output equals Pillow's
// `Image.open(f).convert("RGB")` (libjpeg-turbo 3.1 underneath, with
// `ImageFile.LOAD_TRUNCATED_IMAGES = True`) bit for bit: baseline,
// extended and progressive files, Huffman- or arithmetic-coded (SOF0-2,
// SOF9-10), and lossless files (SOF3).
//
// What is replicated from libjpeg-turbo, and where it lives there:
//   * Huffman tables (Annex K.3's for an undefined table 0 or 1) and
//     decoding, including the zero bits a decoder reads past the end of a
//     scan's data and the "insufficient data" state that leaves every
//     later block of the scan untouched (jdhuff.c, jdphuff.c, jstdhuff.c);
//   * arithmetic decoding with T.81's Qe table, DAC conditioning and the
//     "bad code" state that leaves the rest of a restart interval untouched
//     (jdarith.c, jaricom.c);
//   * restart markers and the default resynchronisation (jdmarker.c);
//   * progressive spectral selection and successive approximation, with
//     EOB runs (jdphuff.c, jdarith.c);
//   * block smoothing of a progressive image whose scans stop early, with
//     the wider window libjpeg-turbo 2.1 added (jdcoefct.c);
//   * lossless predictors 1-7, the point transform and the predictor
//     resets (jdlhuff.c, jddiffct.c, jdlossls.c);
//   * the ISLOW integer IDCT with the 16-bit wraps and saturation of the
//     x86 SIMD build (jidctint-sse2.asm / -avx2.asm);
//   * "fancy" triangle upsampling for h2v1, h2v2 and h1v2 in DCT files, box
//     upsampling for other integral factors, for h2 components at most 2
//     samples wide and for lossless files (jdsample.c); rows above the top
//     and below the bottom repeat the edge row (jdmainct.c);
//   * the fixed-point YCbCr->RGB and YCCK->CMYK tables (jdcolor.c) and the
//     colour space guess from JFIF / Adobe markers and component ids
//     (jdapimin.c).
// Pillow's own steps: it reads the file in 64 KiB pieces and reads again
// only when libjpeg suspends; a stream that ends early is finished with an
// EOI marker (JpegImagePlugin.load_read); when libjpeg stops with an error
// Pillow keeps the rows it had and the rest stay zero. So an arithmetic
// scan, whose decoder cannot suspend, ends where Pillow's data ends (the
// end of the file or of the 64 KiB read that holds its SOS), and a stream
// cut inside a marker segment after the first scan yields no rows of a
// multi-scan image. Four components are read as inverted CMYK ("CMYK;I") and
// converted with Convert.c's cmyk2rgb, one component is replicated to RGB.
//
// Refused, with 1 and a message naming the feature, where Pillow refuses
// too or libjpeg stops before the first row: sample precision other than
// 8, hierarchical files, lossless arithmetic coding (SOF11), 2 or more than
// 4 components, fractional sampling ratios, a Huffman table 2 or 3 that the
// file uses but does not define, a lossless file stored as YCbCr / YCCK
// (libjpeg-turbo converts no lossless colour) or whose restart interval is
// not a whole number of MCU rows, and a stream cut before its first scan.
//
// Corrupt streams are outside the contract. Where libjpeg stops with an
// error on corrupt data, Pillow returns what it had decoded; this decoder
// raises or decodes on.
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

  // jpeg_make_d_derived_tbl; a lossless DC table also codes category 16
  void derive(bool dc, int max_dc_symbol = 15) {
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
        if (vals[i] > max_dc_symbol) fail("corrupt JPEG: bad DC Huffman table");
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

// Thrown where libjpeg's arithmetic decoder needs a byte that Pillow has not
// handed it yet. That decoder cannot suspend (jdarith.c get_byte), so libjpeg
// stops with an error and Pillow keeps the rows it had (see Decoder::blank).
struct PillowStop {};

// Thrown where the data ends inside a marker segment.
struct SegmentCut {};

// T.81 Table D.2, packed as libjpeg's jaricom.c packs it: Qe << 16 |
// Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS. Entry 113 is the
// fixed estimate 0.5 that libjpeg uses for sign and refinement bits.
#define ARI(qe, lps, mps, sw) \
  ((uint32_t{qe} << 16) | (uint32_t{mps} << 8) | (uint32_t{sw} << 7) | (lps))
const uint32_t kAriTab[114] = {
    ARI(0x5a1d, 1, 1, 1), ARI(0x2586, 14, 2, 0), ARI(0x1114, 16, 3, 0),
    ARI(0x080b, 18, 4, 0), ARI(0x03d8, 20, 5, 0), ARI(0x01da, 23, 6, 0),
    ARI(0x00e5, 25, 7, 0), ARI(0x006f, 28, 8, 0), ARI(0x0036, 30, 9, 0),
    ARI(0x001a, 33, 10, 0), ARI(0x000d, 35, 11, 0), ARI(0x0006, 9, 12, 0),
    ARI(0x0003, 10, 13, 0), ARI(0x0001, 12, 13, 0), ARI(0x5a7f, 15, 15, 1),
    ARI(0x3f25, 36, 16, 0), ARI(0x2cf2, 38, 17, 0), ARI(0x207c, 39, 18, 0),
    ARI(0x17b9, 40, 19, 0), ARI(0x1182, 42, 20, 0), ARI(0x0cef, 43, 21, 0),
    ARI(0x09a1, 45, 22, 0), ARI(0x072f, 46, 23, 0), ARI(0x055c, 48, 24, 0),
    ARI(0x0406, 49, 25, 0), ARI(0x0303, 51, 26, 0), ARI(0x0240, 52, 27, 0),
    ARI(0x01b1, 54, 28, 0), ARI(0x0144, 56, 29, 0), ARI(0x00f5, 57, 30, 0),
    ARI(0x00b7, 59, 31, 0), ARI(0x008a, 60, 32, 0), ARI(0x0068, 62, 33, 0),
    ARI(0x004e, 63, 34, 0), ARI(0x003b, 32, 35, 0), ARI(0x002c, 33, 9, 0),
    ARI(0x5ae1, 37, 37, 1), ARI(0x484c, 64, 38, 0), ARI(0x3a0d, 65, 39, 0),
    ARI(0x2ef1, 67, 40, 0), ARI(0x261f, 68, 41, 0), ARI(0x1f33, 69, 42, 0),
    ARI(0x19a8, 70, 43, 0), ARI(0x1518, 72, 44, 0), ARI(0x1177, 73, 45, 0),
    ARI(0x0e74, 74, 46, 0), ARI(0x0bfb, 75, 47, 0), ARI(0x09f8, 77, 48, 0),
    ARI(0x0861, 78, 49, 0), ARI(0x0706, 79, 50, 0), ARI(0x05cd, 48, 51, 0),
    ARI(0x04de, 50, 52, 0), ARI(0x040f, 50, 53, 0), ARI(0x0363, 51, 54, 0),
    ARI(0x02d4, 52, 55, 0), ARI(0x025c, 53, 56, 0), ARI(0x01f8, 54, 57, 0),
    ARI(0x01a4, 55, 58, 0), ARI(0x0160, 56, 59, 0), ARI(0x0125, 57, 60, 0),
    ARI(0x00f6, 58, 61, 0), ARI(0x00cb, 59, 62, 0), ARI(0x00ab, 61, 63, 0),
    ARI(0x008f, 61, 32, 0), ARI(0x5b12, 65, 65, 1), ARI(0x4d04, 80, 66, 0),
    ARI(0x412c, 81, 67, 0), ARI(0x37d8, 82, 68, 0), ARI(0x2fe8, 83, 69, 0),
    ARI(0x293c, 84, 70, 0), ARI(0x2379, 86, 71, 0), ARI(0x1edf, 87, 72, 0),
    ARI(0x1aa9, 87, 73, 0), ARI(0x174e, 72, 74, 0), ARI(0x1424, 72, 75, 0),
    ARI(0x119c, 74, 76, 0), ARI(0x0f6b, 74, 77, 0), ARI(0x0d51, 75, 78, 0),
    ARI(0x0bb6, 77, 79, 0), ARI(0x0a40, 77, 48, 0), ARI(0x5832, 80, 81, 1),
    ARI(0x4d1c, 88, 82, 0), ARI(0x438e, 89, 83, 0), ARI(0x3bdd, 90, 84, 0),
    ARI(0x34ee, 91, 85, 0), ARI(0x2eae, 92, 86, 0), ARI(0x299a, 93, 87, 0),
    ARI(0x2516, 86, 71, 0), ARI(0x5570, 88, 89, 1), ARI(0x4ca9, 95, 90, 0),
    ARI(0x44d9, 96, 91, 0), ARI(0x3e22, 97, 92, 0), ARI(0x3824, 99, 93, 0),
    ARI(0x32b4, 99, 94, 0), ARI(0x2e17, 93, 86, 0), ARI(0x56a8, 95, 96, 1),
    ARI(0x4f46, 101, 97, 0), ARI(0x47e5, 102, 98, 0), ARI(0x41cf, 103, 99, 0),
    ARI(0x3c3d, 104, 100, 0), ARI(0x375e, 99, 93, 0), ARI(0x5231, 105, 102, 0),
    ARI(0x4c0f, 106, 103, 0), ARI(0x4639, 107, 104, 0),
    ARI(0x415e, 103, 99, 0), ARI(0x5627, 105, 106, 1),
    ARI(0x50e7, 108, 107, 0), ARI(0x4b85, 109, 103, 0),
    ARI(0x5597, 110, 109, 0), ARI(0x504f, 111, 107, 0),
    ARI(0x5a10, 110, 111, 1), ARI(0x5522, 112, 109, 0),
    ARI(0x59eb, 112, 111, 1), ARI(0x5a1d, 113, 113, 0)};
#undef ARI

// Arithmetic decoder of jdarith.c: C holds the interval's base and the
// bits read ahead, the cut between them moving with CT. CT -1 is libjpeg's
// "bad code" state, in which the scan decodes nothing more until a restart.
// Past a marker it reads zero bytes; a byte at or past `limit` (what Pillow
// has handed libjpeg) throws PillowStop.
struct ArithReader {
  const uint8_t* p = nullptr;
  const uint8_t* limit = nullptr;
  bool at_marker = false;
  int64_t c = 0, a = 0;
  int ct = -16;

  void reset() {
    c = 0;
    a = 0;
    ct = -16;  // read two bytes into C before the first decision
  }
  int byte() {
    if (p >= limit) throw PillowStop();
    return *p++;
  }
  int decode(uint8_t* st) {
    while (a < 0x8000) {  // renormalise, D.2.6
      if (--ct < 0) {
        int data = 0;
        if (!at_marker) {
          data = byte();
          if (data == 0xFF) {
            do data = byte();
            while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {  // a marker: point at its 0xFF, read zeros from here
              p -= 2;
              at_marker = true;
              data = 0;
            }
          }
        }
        c = (c << 8) | data;
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    uint32_t qe = kAriTab[sv & 0x7F];
    const int nl = qe & 0xFF;
    qe >>= 8;
    const int nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // conditional exchange, D.2.4 / D.2.5
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;    // downsampled width and height in samples
  int wib = 0, hib = 0;  // blocks that hold image samples
  int bw = 0, bh = 0;    // blocks of the coefficient grid (whole MCUs)
  std::vector<int16_t> coef;
  int16_t quant[64] = {};
  bool latched = false;
  int coef_bits[64];
  int prev_bits[10];  // coef_bits[0..9] before this component's last scan
  int dc_pred = 0;     // last DC value (Huffman, arithmetic)
  int dc_context = 0;  // arithmetic DC conditioning, F.1.4.4.1.2
  int td = 0, ta = 0;
  std::vector<uint8_t> samples;  // lossless: dw x dh, scaled
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
    // A DCT component that no scan coded keeps zero coefficients and reads
    // 128 (libjpeg pre-zeroes them); libjpeg hands Pillow no row of a
    // lossless image with such a component
    if (lossless_)
      for (const Component& c : comps_)
        if (!c.latched) stop_rows_ = 0;
    if (stop_rows_ != 0) finish(out);
    if (stop_rows_ >= 0) blank(out, stop_rows_);
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
  bool arith_ = false, lossless_ = false;
  bool single_pass_ = false;  // one scan holds every component (jdinput.c)
  std::vector<Component> comps_;
  uint16_t qt_[4][64] = {};
  bool qt_defined_[4] = {};
  Huffman dc_[4], ac_[4];
  // arithmetic conditioning (DAC; defaults L 0, U 1, Kx 5) and statistics
  uint8_t dac_l_[16], dac_u_[16], dac_k_[16];
  uint8_t dc_stats_[16][64], ac_stats_[16][256];
  uint8_t fixed_bin_ = 113;
  // Where next_marker stops: at end_ it reads the EOI that Pillow appends;
  // inside an arithmetic scan it stops where Pillow's data stops
  // (PillowStop), since that decoder cannot suspend.
  const uint8_t* limit_ = nullptr;
  bool stop_at_limit_ = false;
  int stop_rows_ = -1;  // rows Pillow kept when libjpeg stopped; -1: none
  int last_good_row_ = 0;  // jdmaster.c last_good_iMCU_row

  // ---- markers ----------------------------------------------------------
  int byte() {
    if (pos_ >= end_) throw SegmentCut();
    return *pos_++;
  }
  int u16() {
    const int a = byte();
    return (a << 8) | byte();
  }
  // next_marker: skip garbage and fill bytes; the end of the data reads as
  // the EOI that Pillow appends
  int next_marker() {
    auto out = [&]() {
      if (stop_at_limit_) throw PillowStop();
      return 0xD9;
    };
    for (;;) {
      marker_at_ = nullptr;
      while (pos_ < limit_ && *pos_ != 0xFF) pos_++;
      if (pos_ >= limit_) return out();
      while (pos_ < limit_ && *pos_ == 0xFF) pos_++;
      if (pos_ >= limit_) return out();
      marker_at_ = pos_;
      const int c = *pos_++;
      if (c != 0) return c;
    }
  }
  const uint8_t* segment(int* len) {
    const int n = u16();
    if (n < 2) fail("corrupt JPEG: bad marker length");
    if (end_ - pos_ < n - 2) throw SegmentCut();
    const uint8_t* body = pos_;
    pos_ += n - 2;
    *len = n - 2;
    return body;
  }

  void parse(bool header_only) {
    if (end_ - data_ < 2 || data_[0] != 0xFF || data_[1] != 0xD8)
      fail("not a JPEG file (no SOI marker)");
    pos_ = data_ + 2;
    limit_ = end_;
    for (int i = 0; i < 16; i++) {
      dac_l_[i] = 0;
      dac_u_[i] = 1;
      dac_k_[i] = 5;
    }
    for (;;) {
      const int m = next_marker();
      try {
        if (marker(m, header_only)) return;
      } catch (const SegmentCut&) {
        // Pillow reads the segments up to the first SOS itself and raises;
        // later, libjpeg waits for the rest of the segment, which never
        // comes, so it hands Pillow no row of a multi-scan image (all its
        // scans are read before the first row) and every row of a
        // single-scan image whose scan it has read
        if (scans_ == 0) fail("JPEG file is truncated inside a marker segment");
        if (!(single_pass_ && scans_ > 0)) stop_rows_ = 0;
        fix_space();
        return;
      }
    }
  }

  // One marker segment; true at the end of what parse() reads
  bool marker(int m, bool header_only) {
    int len;
    if (m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC3 || m == 0xC9 ||
        m == 0xCA) {
      read_sof(m);
      if (header_only) return true;
    } else if (m == 0xCB) {  // libjpeg-turbo has no decoder for it
      fail("lossless arithmetic-coded JPEG (SOF11) is not supported");
    } else if ((m >= 0xC5 && m <= 0xC7) || (m >= 0xCD && m <= 0xCF)) {
      fail("hierarchical JPEG (SOF%d) is not supported", m - 0xC0);
    } else if (m == 0xC8) {
      fail("corrupt JPEG: JPG marker (SOF8)");
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
      if (stop_rows_ >= 0) return true;
    } else if (m == 0xD9) {
      if (!have_frame_) fail("JPEG file has no frame (no SOF marker)");
      if (scans_ == 0) fail("JPEG file has no scan");
      return true;
    } else if (m == 0xE0) {
      const uint8_t* b = segment(&len);
      if (len >= 14 && !std::memcmp(b, "JFIF\0", 5)) jfif_ = true;
    } else if (m == 0xEE) {
      const uint8_t* b = segment(&len);
      if (len >= 12 && !std::memcmp(b, "Adobe", 5)) {
        adobe_ = true;
        adobe_transform_ = b[11];
      }
    } else if (m == 0xCC) {
      read_dac();
    } else if ((m >= 0xE1 && m <= 0xEF) || m == 0xFE || m == 0xDC) {
      segment(&len);  // other APPn, COM, DNL
    } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) {
      // RSTn outside a scan, TEM: no parameters
    } else {
      fail("corrupt JPEG: unknown marker 0x%02X", m);
    }
    return false;
  }

  void read_sof(int marker) {
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
    progressive_ = marker == 0xC2 || marker == 0xCA;
    arith_ = marker == 0xC9 || marker == 0xCA;
    lossless_ = marker == 0xC3;
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
    // a lossless file's data unit is one sample, a DCT file's an 8x8 block
    const int unit = lossless_ ? 1 : 8;
    mcux_ = (width_ + unit * hmax_ - 1) / (unit * hmax_);
    mcuy_ = (height_ + unit * vmax_ - 1) / (unit * vmax_);
    for (Component& c : comps_) {
      c.dw = static_cast<int>(
          (static_cast<int64_t>(width_) * c.h + hmax_ - 1) / hmax_);
      c.dh = static_cast<int>(
          (static_cast<int64_t>(height_) * c.v + vmax_ - 1) / vmax_);
      c.wib = (c.dw + unit - 1) / unit;
      c.hib = (c.dh + unit - 1) / unit;
      c.bw = mcux_ * c.h;
      c.bh = mcuy_ * c.v;
      for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
    }
    have_frame_ = true;
  }

  void read_dac() {  // get_dac
    int len;
    const uint8_t* b = segment(&len);
    if (len % 2) fail("corrupt JPEG: bad DAC length");
    for (int i = 0; i < len; i += 2) {
      const int index = b[i], val = b[i + 1];
      if (index >= 32) fail("corrupt JPEG: bad DAC index");
      if (index >= 16) {
        dac_k_[index - 16] = static_cast<uint8_t>(val);
      } else {
        dac_l_[index] = static_cast<uint8_t>(val & 15);
        dac_u_[index] = static_cast<uint8_t>(val >> 4);
        if (dac_l_[index] > dac_u_[index]) fail("corrupt JPEG: bad DAC value");
      }
    }
  }

  void allocate() {
    for (Component& c : comps_) {
      if (lossless_ && c.samples.empty())
        c.samples.assign(static_cast<size_t>(c.dw) * c.dh, 0);
      if (!lossless_ && c.coef.empty())
        c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
    }
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
        // libjpeg-turbo takes a lossless file without either marker for
        // RGB, a DCT file for RGB only with ids 'R', 'G', 'B'
        const int a = comps_[0].id, b = comps_[1].id, c = comps_[2].id;
        space_ = lossless_ || (a == 82 && b == 71 && c == 66) ? Space::kRGB
                                                              : Space::kYCbCr;
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
    for (const Component& c : comps_)  // jinit_upsampler, before any row
      if ((hmax_ / c.h) * c.h != hmax_ || (vmax_ / c.v) * c.v != vmax_)
        fail("JPEG sampling factors with a fractional ratio are not "
             "supported");
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
      // arithmetic coding has 16 conditioning tables, Huffman 4
      if (!arith_ && (c->td > 3 || c->ta > 3))
        fail("corrupt JPEG: bad Huffman table index");
      if (!c->latched) {  // latch_quant_tables
        if (!lossless_ && !qt_defined_[c->tq])
          fail("corrupt JPEG: missing quantization table");
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
    scans_++;
    if (scans_ == 1)
      single_pass_ = !progressive_ && ns == static_cast<int>(comps_.size());

    if (lossless_) {
      lossless_scan(sc, ss, se, ah, al);
      return;
    }
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
      // start_pass_phuff_decoder / jdarith.c start_pass: the bits each
      // coefficient had before this scan, then the bits it has after it
      for (Component* c : sc) {
        for (int k = std::min(ss, 1); k <= std::max(se, 9); k++)
          if (k < 10) c->prev_bits[k] = scans_ > 1 ? c->coef_bits[k] : 0;
        for (int k = ss; k <= se; k++) c->coef_bits[k] = al;
      }
    } else if (ss != 0 || se != 63 || ah != 0 || al != 0) {
      fail("sequential JPEG scan with Ss=%d Se=%d Ah=%d Al=%d is not "
           "supported", ss, se, ah, al);
    }
    if (arith_)
      arith_scan(sc, ss, se, ah, al);
    else
      huffman_scan(sc, ss, se, ah, al);
  }

  // Walk a DCT scan's MCUs: interleaved, or one block each in a scan of one
  // component (only the blocks that hold image samples). `mcu_start` handles
  // restarts and says whether the MCU is decoded; `block_op` decodes one
  // block and returns false to drop the rest of the MCU. `imcu` follows the
  // iMCU row being decoded.
  template <class Start, class Op, class End>
  void walk_mcus(const std::vector<Component*>& sc, Start mcu_start,
                 Op block_op, End row_end, int* imcu) {
    if (sc.size() == 1) {
      Component* c = sc[0];
      for (int by = 0; by < c->hib; by++) {
        *imcu = by / c->v;
        for (int bx = 0; bx < c->wib; bx++)
          if (mcu_start()) block_op(c, c->block(bx, by));
        if ((by + 1) % c->v == 0 || by + 1 == c->hib) row_end(*imcu);
      }
      return;
    }
    for (int my = 0; my < mcuy_; my++) {
      *imcu = my;
      for (int mx = 0; mx < mcux_; mx++) {
        if (!mcu_start()) continue;
        for (Component* c : sc)
          for (int y = 0; y < c->v; y++)
            for (int x = 0; x < c->h; x++)
              if (!block_op(c, c->block(mx * c->h + x, my * c->v + y)))
                goto next_mcu;
      next_mcu:;
      }
      row_end(my);
    }
  }

  void huffman_scan(const std::vector<Component*>& sc, int ss, int se, int ah,
                    int al) {
    const bool need_dc = !progressive_ || (ss == 0 && ah == 0);
    const bool need_ac = !progressive_ || ss != 0;
    for (Component* c : sc) {
      if (need_dc && !dc_[c->td].defined) dc_[c->td].standard(true, c->td);
      if (need_ac && !ac_[c->ta].defined) ac_[c->ta].standard(false, c->ta);
      if (need_dc) dc_[c->td].derive(true);
      if (need_ac) ac_[c->ta].derive(false);
      c->dc_pred = 0;
    }

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
      return true;
    };
    // DC refinement reads its bits even when the data ran out (zeros leave
    // the coefficients as they are); every other scan skips the MCU
    const bool always = progressive_ && ss == 0 && ah != 0;

    auto mcu_start = [&]() {
      if (restart_interval_) {
        if (restarts_to_go == 0) {
          br.discard();
          const uint8_t* left = resync(br.p, &next_rst);
          br.p = left ? left : pos_;
          br.at_marker = left != nullptr;
          if (!left) br.insufficient = false;
          for (Component* c : sc) c->dc_pred = 0;
          eobrun = 0;
          restarts_to_go = restart_interval_;
        }
        restarts_to_go--;
      }
      return always || !br.insufficient;
    };
    // last_good_iMCU_row: the last iMCU row that the scan started with data
    // left (a row cut short counts)
    bool had_data = true;
    auto row_end = [&](int r) {
      if (had_data) last_good_row_ = r;
      had_data = !br.insufficient;
    };
    int imcu = 0;
    walk_mcus(sc, mcu_start, block_op, row_end, &imcu);
    pos_ = br.p;
  }

  // Pillow hands libjpeg the file in reads of 64 KiB and reads again only
  // when libjpeg suspends, which its arithmetic decoder cannot do: an
  // arithmetic scan has the data up to the end of the read that holds the
  // end of its SOS segment, and no EOI after a file that ends early.
  const uint8_t* pillow_limit() const {
    constexpr size_t kRead = 65536;  // ImageFile.MAXBLOCK
    const size_t consumed = static_cast<size_t>(pos_ - data_);
    const size_t e = ((consumed - 1) / kRead + 1) * kRead;
    return data_ + std::min(e, static_cast<size_t>(end_ - data_));
  }

  // Rows of a single-pass image that libjpeg had handed Pillow when it
  // stopped in iMCU row `imcu`: every row of the rows before, less the last
  // row group when the upsampler needs the next rows as context
  // (jdmainct.c process_data_context_main).
  int rows_before(int imcu) const {
    bool context = false;
    for (const Component& c : comps_) {
      const int hf = hmax_ / c.h, vf = vmax_ / c.v;
      if (!lossless_ && vf == 2 && (hf == 1 || (hf == 2 && c.dw > 2)))
        context = true;
    }
    const int unit = lossless_ ? 1 : 8;
    int rows = unit * vmax_ * imcu;
    if (context && imcu > 0) rows -= vmax_;
    return std::min(rows, height_);
  }

  void arith_scan(const std::vector<Component*>& sc, int ss, int se, int ah,
                  int al) {
    const bool dc_stats = !progressive_ || (ss == 0 && ah == 0);
    const bool ac_stats = !progressive_ || ss != 0;
    auto reset_stats = [&]() {  // start_pass, process_restart
      for (Component* c : sc) {
        if (dc_stats) {
          std::memset(dc_stats_[c->td], 0, sizeof dc_stats_[0]);
          c->dc_pred = 0;
          c->dc_context = 0;
        }
        if (ac_stats) std::memset(ac_stats_[c->ta], 0, sizeof ac_stats_[0]);
      }
    };
    reset_stats();
    ArithReader ar;
    ar.p = pos_;
    ar.limit = pillow_limit();
    int restarts_to_go = restart_interval_;
    int next_rst = 0;
    // DC refinement decodes even in the bad-code state (jdarith.c)
    const bool always = progressive_ && ss == 0 && ah != 0;

    auto mcu_start = [&]() {
      if (restart_interval_) {
        if (restarts_to_go == 0) {
          limit_ = ar.limit;
          stop_at_limit_ = true;
          const uint8_t* left = resync(ar.p, &next_rst);
          limit_ = end_;
          stop_at_limit_ = false;
          ar.p = left ? left : pos_;
          ar.at_marker = left != nullptr;
          reset_stats();
          ar.reset();
          restarts_to_go = restart_interval_;
        }
        restarts_to_go--;
      }
      return always || ar.ct != -1;
    };
    auto block_op = [&](Component* c, int16_t* blk) {
      if (!progressive_) return arith_sequential(ar, c, blk);
      if (ss == 0 && ah == 0) {
        if (!arith_dc_diff(ar, c)) return false;
        blk[0] = static_cast<int16_t>(static_cast<uint32_t>(c->dc_pred) << al);
        return true;
      }
      if (ss == 0) {
        if (ar.decode(&fixed_bin_))
          blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
        return true;
      }
      if (ah == 0) return arith_ac(ar, c, blk, ss, se, al);
      return arith_ac_refine(ar, c, blk, ss, se, al);
    };
    auto row_end = [&](int r) { last_good_row_ = r; };
    int imcu = 0;
    try {
      walk_mcus(sc, mcu_start, block_op, row_end, &imcu);
    } catch (const PillowStop&) {
      limit_ = end_;
      stop_at_limit_ = false;
      stop_rows_ = single_pass_ ? rows_before(imcu) : 0;
      return;
    }
    pos_ = ar.p;
  }

  // read_restart_marker + jpeg_resync_to_restart from `p`. Returns null when
  // the expected marker was consumed (the next segment starts at pos_), or
  // the 0xFF of a marker left unread, which the entropy decoder then meets
  // and reads zeros after.
  const uint8_t* resync(const uint8_t* p, int* next_rst) {
    pos_ = p;
    int marker = next_marker();
    const int desired = *next_rst;
    *next_rst = (desired + 1) & 7;
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
      if (action == 1) return nullptr;
      if (action == 3) return marker_at_ ? marker_at_ - 1 : limit_;
      marker = next_marker();
    }
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

  // ---- lossless (T.81 Annex H; jdlhuff.c, jddiffct.c, jdlossls.c) ------
  // One scan: Huffman coded differences, a predictor that restarts in
  // "first row" mode at the start of the scan, at each restart and when the
  // data ran out (at the first row of the iMCU row in which that happened),
  // and samples scaled up by the point transform Pt.
  void lossless_scan(const std::vector<Component*>& sc, int psv, int se,
                     int ah, int pt) {
    if (psv < 1 || psv > 7 || se != 0 || ah != 0 || pt > 7)
      fail("corrupt JPEG: bad lossless scan parameters");
    // jdcolor.c allows no colour conversion in lossless mode, and Pillow
    // asks for RGB / CMYK output: libjpeg stops before the first row
    if (space_ == Space::kYCbCr || space_ == Space::kYCCK)
      fail("lossless JPEG stored as YCbCr or YCCK is not supported "
           "(libjpeg-turbo converts no lossless colour)");
    const bool one = sc.size() == 1;
    const int per_row = one ? sc[0]->dw : mcux_;  // MCUs in an MCU row
    const int mcu_rows = one ? sc[0]->dh : mcuy_;
    const int rows_per_imcu = one ? sc[0]->v : 1;
    if (restart_interval_ % per_row)
      fail("lossless JPEG whose restart interval (%d MCUs) is not a whole "
           "number of MCU rows (%d MCUs) is not supported (libjpeg-turbo "
           "refuses it)", restart_interval_, per_row);
    for (Component* c : sc) {
      if (!dc_[c->td].defined) dc_[c->td].standard(true, c->td);
      dc_[c->td].derive(true, 16);
    }
    const size_t nc = sc.size();
    // one iMCU row of differences per component, `width` samples a row
    std::vector<int> width(nc), height(nc);
    std::vector<std::vector<int>> diff(nc), prev(nc);
    std::vector<bool> first_row(nc, true);
    std::vector<int> out_row(nc, 0);
    for (size_t i = 0; i < nc; i++) {
      width[i] = one ? sc[i]->dw : mcux_ * sc[i]->h;
      height[i] = one ? rows_per_imcu : sc[i]->v;
      diff[i].assign(static_cast<size_t>(width[i]) * height[i], 0);
      prev[i].assign(sc[i]->dw, 0);
    }
    BitReader br;
    br.p = pos_;
    br.end = end_;
    const int restart_rows = restart_interval_ / per_row;
    int rows_to_go = restart_rows;
    int next_rst = 0;
    auto reset = [&]() { std::fill(first_row.begin(), first_row.end(), true); };
    auto sample_diff = [&](const Huffman& h) {
      int s = br.decode(h);
      if (s == 16) return 32768;
      return s ? extend(br.get(s), s) : 0;
    };
    for (int r0 = 0; r0 < mcu_rows; r0 += rows_per_imcu) {
      const int r1 = std::min(r0 + rows_per_imcu, mcu_rows);
      for (int r = r0; r < r1; r++) {  // decompress_data's MCU rows
        if (restart_interval_) {
          if (rows_to_go == 0) {
            br.discard();
            const uint8_t* left = resync(br.p, &next_rst);
            br.p = left ? left : pos_;
            br.at_marker = left != nullptr;
            if (!left) br.insufficient = false;
            reset();
            rows_to_go = restart_rows;
          }
        }
        if (br.insufficient) {  // decode_mcus: zeros, predictor reset
          for (size_t i = 0; i < nc; i++) {
            const int y0 = one ? r - r0 : 0;
            const int y1 = one ? y0 + 1 : height[i];
            std::fill(diff[i].begin() + static_cast<size_t>(y0) * width[i],
                      diff[i].begin() + static_cast<size_t>(y1) * width[i], 0);
          }
          reset();
        } else if (one) {
          int* d = diff[0].data() + static_cast<size_t>(r - r0) * width[0];
          for (int x = 0; x < per_row; x++) d[x] = sample_diff(dc_[sc[0]->td]);
        } else {
          for (int mx = 0; mx < mcux_; mx++)
            for (size_t i = 0; i < nc; i++) {
              const Component* c = sc[i];
              for (int y = 0; y < c->v; y++)
                for (int x = 0; x < c->h; x++)
                  diff[i][static_cast<size_t>(y) * width[i] + mx * c->h + x] =
                      sample_diff(dc_[c->td]);
            }
        }
        if (restart_interval_) rows_to_go--;
      }
      for (size_t i = 0; i < nc; i++) {  // undifference and scale
        Component* c = sc[i];
        const int rows = one ? r1 - r0 : c->v;
        for (int y = 0; y < rows && out_row[i] < c->dh; y++) {
          const int* d = diff[i].data() + static_cast<size_t>(y) * width[i];
          undifference(d, prev[i].data(), c->dw, first_row[i] ? 0 : psv, pt);
          first_row[i] = false;
          uint8_t* o = c->samples.data() +
                       static_cast<size_t>(out_row[i]++) * c->dw;
          for (int x = 0; x < c->dw; x++)
            o[x] = static_cast<uint8_t>(prev[i][x] << pt);
        }
      }
    }
    pos_ = br.p;
  }

  // One row of jdlossls.c's undifferencing, in place over `row` (the row
  // above on entry, this row on return); psv 0 is the first-row predictor.
  static void undifference(const int* d, int* row, int w, int psv, int pt) {
    int ra = 0, rb = 0, rc = 0;
    for (int x = 0; x < w; x++) {
      int pred;
      if (x == 0) {
        rb = row[0];
        pred = psv == 0 ? 1 << (7 - pt) : rb;
      } else if (psv <= 1) {
        pred = ra;
      } else {
        rc = rb;
        rb = row[x];
        switch (psv) {
          case 2: pred = rb; break;
          case 3: pred = rc; break;
          case 4: pred = ra + rb - rc; break;
          case 5: pred = ra + ((rb - rc) >> 1); break;
          case 6: pred = rb + ((ra - rc) >> 1); break;
          default: pred = (ra + rb) >> 1; break;
        }
      }
      ra = (d[x] + pred) & 0xFFFF;
      row[x] = ra;
    }
  }

  // ---- arithmetic decoding (jdarith.c, T.81 F.2.4 and G.2) -------------
  // One DC difference into c->dc_pred (Figures F.19-F.24); false when it
  // overflows, which puts the decoder in the bad-code state
  bool arith_dc_diff(ArithReader& ar, Component* c) {
    uint8_t* stats = dc_stats_[c->td];
    uint8_t* st = stats + c->dc_context;
    if (ar.decode(st) == 0) {
      c->dc_context = 0;
      return true;
    }
    const int sign = ar.decode(st + 1);
    st += 2 + sign;
    int m = ar.decode(st);
    if (m != 0) {
      st = stats + 20;  // X1
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) {
          ar.ct = -1;
          return false;
        }
        st++;
      }
    }
    if (m < ((1 << dac_l_[c->td]) >> 1))
      c->dc_context = 0;
    else if (m > ((1 << dac_u_[c->td]) >> 1))
      c->dc_context = 12 + sign * 4;
    else
      c->dc_context = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    c->dc_pred = (c->dc_pred + v) & 0xFFFF;
    return true;
  }

  // Sign and magnitude of one nonzero AC value, `st` at its SE bin
  bool arith_ac_value(ArithReader& ar, const Component* c, uint8_t* st, int k,
                      int* out) {
    const int sign = ar.decode(&fixed_bin_);
    st += 2;
    int m = ar.decode(st);
    if (m != 0 && ar.decode(st)) {
      m <<= 1;
      st = ac_stats_[c->ta] + (k <= dac_k_[c->ta] ? 189 : 217);
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) {
          ar.ct = -1;
          return false;
        }
        st++;
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    *out = sign ? -v : v;
    return true;
  }

  // Coefficients ss..se (Figure F.20); false on a bad code
  bool arith_ac(ArithReader& ar, const Component* c, int16_t* blk, int ss,
                int se, int al) {
    uint8_t* stats = ac_stats_[c->ta];
    for (int k = ss; k <= se; k++) {
      uint8_t* st = stats + 3 * (k - 1);
      if (ar.decode(st)) break;  // EOB
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++k > se) {  // spectral overflow
          ar.ct = -1;
          return false;
        }
      }
      int v;
      if (!arith_ac_value(ar, c, st, k, &v)) return false;
      blk[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(v) << al);
    }
    return true;
  }

  bool arith_sequential(ArithReader& ar, Component* c, int16_t* blk) {
    if (!arith_dc_diff(ar, c)) return false;
    blk[0] = static_cast<int16_t>(c->dc_pred);
    return arith_ac(ar, c, blk, 1, 63, 0);
  }

  bool arith_ac_refine(ArithReader& ar, Component* c, int16_t* blk, int ss,
                       int se, int al) {
    uint8_t* stats = ac_stats_[c->ta];
    const int p1 = 1 << al;
    const int m1 = static_cast<int>(static_cast<uint32_t>(-1) << al);
    int kex = se;  // EOBx: the previous stage's end of block
    for (; kex > 0; kex--)
      if (blk[kNatural[kex]]) break;
    for (int k = ss; k <= se; k++) {
      uint8_t* st = stats + 3 * (k - 1);
      if (k > kex && ar.decode(st)) break;  // EOB
      for (;;) {
        int16_t* coef = blk + kNatural[k];
        if (*coef) {  // correction bit of a coefficient already nonzero
          if (ar.decode(st + 2))
            *coef = static_cast<int16_t>(*coef < 0 ? *coef + m1 : *coef + p1);
          break;
        }
        if (ar.decode(st + 1)) {  // newly nonzero
          *coef = static_cast<int16_t>(ar.decode(&fixed_bin_) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) {
          ar.ct = -1;
          return false;
        }
      }
    }
    return true;
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

  // jdcoefct.c decompress_smooth_data (libjpeg-turbo 2.1 and later): each
  // block's first AC coefficients that are still zero and not known to full
  // precision are estimated from the DC values of the 5 x 5 blocks around
  // it, and, while no AC coefficient has any bit yet, its DC too. The
  // neighbours (edge blocks repeat, also in a component two blocks wide),
  // the rows past the image's last block row that a 2-row iMCU still reads,
  // and the rows that take the bits from before the last scan follow
  // libjpeg-turbo as Pillow's output pins it.
  void smooth_plane(Component& c, uint8_t* plane, int pw) {
    // smoothing_ok's latches: the bits after the last scan, and before the
    // component's last scan (for the rows that scan did not reach)
    int now[10], before[10];
    for (int k = 0; k < 10; k++) {
      now[k] = c.coef_bits[k];
      before[k] = scans_ > 1 ? c.prev_bits[k] : -1;
    }
    const int64_t q00 = c.quant[0], q01 = c.quant[1], q10 = c.quant[8],
                  q20 = c.quant[16], q11 = c.quant[9], q02 = c.quant[2],
                  q03 = c.quant[3], q12 = c.quant[10], q21 = c.quant[17],
                  q30 = c.quant[24];
    const int total = mcuy_, v = c.v, last = c.wib - 1;
    int16_t ws[64];
    // AC estimate of one coefficient, limited to the bits it lacks
    auto estimate = [&](int al, int pos, int64_t q, int64_t num) {
      if (al == 0 || ws[pos] != 0) return;
      const int64_t mag = num >= 0 ? num : -num;
      int pred = static_cast<int>(((q << 7) + mag) / (q << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      ws[pos] = static_cast<int16_t>(num >= 0 ? pred : -pred);
    };
    for (int r = 0; r < total; r++) {
      int block_rows = v;
      if (r == total - 1) {
        block_rows = c.hib % v;
        if (block_rows == 0) block_rows = v;
      }
      const int* bits = r > last_good_row_ ? before : now;
      bool change_dc = true;
      for (int k = 1; k < 10; k++)
        if (bits[k] != -1) change_dc = false;
      const int image_block_rows = block_rows * total;
      for (int br = 0; br < block_rows; br++) {
        const int ibr = r * block_rows + br;
        const int cur = r * v + br;
        const int prev = ibr > 0 ? cur - 1 : cur;
        const int next = ibr < image_block_rows - 1 ? cur + 1 : cur;
        const int rows[5] = {ibr > 1 ? cur - 2 : prev, prev, cur, next,
                             ibr < image_block_rows - 2 ? cur + 2 : next};
        auto dc = [&](int i, int col) {
          return static_cast<int64_t>(c.block(col, rows[i])[0]);
        };
        int64_t d[5][5];  // d[i][j] is libjpeg's DC(5 i + j + 1)
        for (int i = 0; i < 5; i++)
          for (int j = 0; j < 5; j++) d[i][j] = dc(i, 0);
        for (int bx = 0; bx <= last; bx++) {
          std::memcpy(ws, c.block(bx, cur), sizeof ws);
          if (bx == 0 && bx < last)
            for (int i = 0; i < 5; i++) d[i][3] = d[i][4] = dc(i, 1);
          if (bx + 1 < last)
            for (int i = 0; i < 5; i++) d[i][4] = dc(i, bx + 2);
          const int64_t
              D01 = d[0][0], D02 = d[0][1], D03 = d[0][2], D04 = d[0][3],
              D05 = d[0][4], D06 = d[1][0], D07 = d[1][1], D08 = d[1][2],
              D09 = d[1][3], D10 = d[1][4], D11 = d[2][0], D12 = d[2][1],
              D13 = d[2][2], D14 = d[2][3], D15 = d[2][4], D16 = d[3][0],
              D17 = d[3][1], D18 = d[3][2], D19 = d[3][3], D20 = d[3][4],
              D21 = d[4][0], D22 = d[4][1], D23 = d[4][2], D24 = d[4][3],
              D25 = d[4][4];
          estimate(bits[1], 1, q01, q00 * (change_dc ?
              -D01 - D02 + D04 + D05 - 3 * D06 + 13 * D07 - 13 * D09 +
              3 * D10 - 3 * D11 + 38 * D12 - 38 * D14 + 3 * D15 - 3 * D16 +
              13 * D17 - 13 * D19 + 3 * D20 - D21 - D22 + D24 + D25 :
              -7 * D11 + 50 * D12 - 50 * D14 + 7 * D15));
          estimate(bits[2], 8, q10, q00 * (change_dc ?
              -D01 - 3 * D02 - 3 * D03 - 3 * D04 - D05 - D06 + 13 * D07 +
              38 * D08 + 13 * D09 - D10 + D16 - 13 * D17 - 38 * D18 -
              13 * D19 + D20 + D21 + 3 * D22 + 3 * D23 + 3 * D24 + D25 :
              -7 * D03 + 50 * D08 - 50 * D18 + 7 * D23));
          estimate(bits[3], 16, q20, q00 * (change_dc ?
              D03 + 2 * D07 + 7 * D08 + 2 * D09 - 5 * D12 - 14 * D13 -
              5 * D14 + 2 * D17 + 7 * D18 + 2 * D19 + D23 :
              -D03 + 13 * D08 - 24 * D13 + 13 * D18 - D23));
          estimate(bits[4], 9, q11, q00 * (change_dc ?
              -D01 + D05 + 9 * D07 - 9 * D09 - 9 * D17 + 9 * D19 + D21 - D25 :
              D10 + D16 - 10 * D17 + 10 * D19 - D02 - D20 + D22 - D24 + D04 -
              D06 + 10 * D07 - 10 * D09));
          estimate(bits[5], 2, q02, q00 * (change_dc ?
              2 * D07 - 5 * D08 + 2 * D09 + D11 + 7 * D12 - 14 * D13 +
              7 * D14 + D15 + 2 * D17 - 5 * D18 + 2 * D19 :
              -D11 + 13 * D12 - 24 * D13 + 13 * D14 - D15));
          if (change_dc) {
            estimate(bits[6], 3, q03,
                     q00 * (D07 - D09 + 2 * D12 - 2 * D14 + D17 - D19));
            estimate(bits[7], 10, q12,
                     q00 * (D07 - 3 * D08 + D09 - D17 + 3 * D18 - D19));
            estimate(bits[8], 17, q21,
                     q00 * (D07 - D09 - 3 * D12 + 3 * D14 + D17 - D19));
            estimate(bits[9], 24, q30,
                     q00 * (D07 + 2 * D08 + D09 - D17 - 2 * D18 - D19));
            const int64_t num = q00 * (
                -2 * D01 - 6 * D02 - 8 * D03 - 6 * D04 - 2 * D05 - 6 * D06 +
                6 * D07 + 42 * D08 + 6 * D09 - 6 * D10 - 8 * D11 + 42 * D12 +
                152 * D13 + 42 * D14 - 8 * D15 - 6 * D16 + 6 * D17 +
                42 * D18 + 6 * D19 - 6 * D20 - 2 * D21 - 6 * D22 - 8 * D23 -
                6 * D24 - 2 * D25);
            const int pred = static_cast<int>(
                ((q00 << 7) + (num >= 0 ? num : -num)) / (q00 << 8));
            ws[0] = static_cast<int16_t>(num >= 0 ? pred : -pred);
          }
          idct_islow(ws, c.quant,
                     plane + static_cast<size_t>(cur) * 8 * pw + bx * 8, pw);
          for (int i = 0; i < 5; i++)
            for (int j = 0; j < 4; j++) d[i][j] = d[i][j + 1];
        }
      }
    }
  }

  // The ISLOW integer IDCT as libjpeg-turbo's x86 SIMD code computes it
  // (jidctint-sse2.asm / -avx2.asm): the same products as jidctint.c,
  // regrouped into pairs, but dequantisation and the sums in0 + in4,
  // in0 - in4, in3 + in7 and in1 + in5 wrap in 16 bits, the first pass
  // saturates its output to 16 bits, and a block whose rows 1-7 are all
  // zero takes a 16-bit shortcut through the first pass. Valid data never
  // reaches those limits; the coefficients that a cut stream decodes from
  // its zero bits can.
  static void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out,
                         int stride) {
    auto w16 = [](int64_t x) {
      return static_cast<int32_t>(
          static_cast<int16_t>(static_cast<uint16_t>(x)));
    };
    auto w32 = [](int64_t x) {
      return static_cast<int64_t>(
          static_cast<int32_t>(static_cast<uint32_t>(x)));
    };
    auto sat16 = [](int64_t x) {
      return static_cast<int32_t>(
          std::min<int64_t>(32767, std::max<int64_t>(-32768, x)));
    };
    // one 8-point pass over v[0..7] (v[k] = frequency k), into o[0..7]
    auto pass = [&](const int32_t* v, int32_t* o, int shift) {
      const int64_t z2 = v[2], z3 = v[6];
      const int64_t tmp3 = w32(z2 * 10703 + z3 * 4433);
      const int64_t tmp2 = w32(z2 * 4433 + z3 * -10704);
      const int64_t tmp0 = w32(static_cast<int64_t>(w16(v[0] + v[4])) * 8192);
      const int64_t tmp1 = w32(static_cast<int64_t>(w16(v[0] - v[4])) * 8192);
      const int64_t tmp10 = w32(tmp0 + tmp3), tmp13 = w32(tmp0 - tmp3);
      const int64_t tmp11 = w32(tmp1 + tmp2), tmp12 = w32(tmp1 - tmp2);
      const int64_t t0 = v[7], t1 = v[5], t2 = v[3], t3 = v[1];
      const int64_t z3s = w16(t0 + t2), z4s = w16(t1 + t3);
      const int64_t z3p = w32(z3s * -6436 + z4s * 9633);
      const int64_t z4p = w32(z3s * 9633 + z4s * 6437);
      const int64_t o0 = w32(w32(t0 * -4927 + t3 * -7373) + z3p);
      const int64_t o3 = w32(w32(t0 * -7373 + t3 * 4926) + z4p);
      const int64_t o1 = w32(w32(t1 * -4176 + t2 * -20995) + z4p);
      const int64_t o2 = w32(w32(t1 * -20995 + t2 * 4177) + z3p);
      const int64_t round = int64_t{1} << (shift - 1);
      auto d = [&](int64_t x) { return sat16(w32(w32(x) + round) >> shift); };
      o[0] = d(tmp10 + o3);
      o[7] = d(tmp10 - o3);
      o[1] = d(tmp11 + o2);
      o[6] = d(tmp11 - o2);
      o[2] = d(tmp12 + o1);
      o[5] = d(tmp12 - o1);
      o[3] = d(tmp13 + o0);
      o[4] = d(tmp13 - o0);
    };
    int32_t ws[64];  // ws[8 * row + col] after the column pass
    bool ac = false;
    for (int k = 8; k < 64; k++) ac = ac || in[k] != 0;
    if (!ac) {
      for (int col = 0; col < 8; col++) {
        const int32_t dc = w16(w16(static_cast<int32_t>(in[col]) * q[col]) * 4);
        for (int r = 0; r < 8; r++) ws[8 * r + col] = dc;
      }
    } else {
      for (int col = 0; col < 8; col++) {
        int32_t v[8], o[8];
        for (int r = 0; r < 8; r++)
          v[r] = w16(static_cast<int32_t>(in[8 * r + col]) * q[8 * r + col]);
        pass(v, o, 11);
        for (int r = 0; r < 8; r++) ws[8 * r + col] = o[r];
      }
    }
    for (int row = 0; row < 8; row++) {
      int32_t o[8];
      pass(ws + 8 * row, o, 18);
      uint8_t* p = out + static_cast<size_t>(row) * stride;
      for (int x = 0; x < 8; x++)  // packsswb, then + 128
        p[x] = static_cast<uint8_t>(std::min(127, std::max(-128, o[x])) + 128);
    }
  }

  // One component, IDCT'd and upsampled to (rows >= height_) x stride
  // samples; returns the stride.
  int component_plane(Component& c, bool smooth, std::vector<uint8_t>* full) {
    int pw, ph;
    std::vector<uint8_t> plane;
    if (lossless_) {
      pw = c.dw;
      ph = c.dh;
      plane = c.samples;
    } else {
      pw = c.wib * 8;
      ph = c.hib * 8;
      plane.resize(static_cast<size_t>(pw) * ph);
      if (smooth) {
        smooth_plane(c, plane.data(), pw);
      } else {
        for (int by = 0; by < c.hib; by++)
          for (int bx = 0; bx < c.wib; bx++)
            idct_islow(c.block(bx, by), c.quant,
                       plane.data() + static_cast<size_t>(by) * 8 * pw + bx * 8,
                       pw);
      }
    }
    // jdsample.c upsamples a lossless image (DCT size 1) without "fancy"
    const bool fancy = !lossless_;
    const int hf = hmax_ / c.h, vf = vmax_ / c.v;
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
    } else if (fancy && hf == 2 && vf == 1 && dw > 2) {  // h2v1_fancy_upsample
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
    } else if (fancy && hf == 1 && vf == 2) {  // h1v2_fancy_upsample
      for (int y = 0; y < height_; y++) {
        const int iy = y >> 1;
        const uint8_t* i0 = in(iy);
        const uint8_t* i1 = in((y & 1) ? iy + 1 : iy - 1);
        const int bias = (y & 1) ? 2 : 1;
        uint8_t* o = out(y);
        for (int x = 0; x < dw; x++)
          o[x] = static_cast<uint8_t>((i0[x] * 3 + i1[x] + bias) >> 2);
      }
    } else if (fancy && hf == 2 && vf == 2 && dw > 2) {  // h2v2_fancy_upsample
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

  // Pillow's image memory starts zeroed, so rows that libjpeg never handed
  // it read black, or white in a CMYK image (CMYK 0, 0, 0, 0)
  void blank(uint8_t* rgb, int from) const {
    const bool cmyk = space_ == Space::kCMYK || space_ == Space::kYCCK;
    const size_t row = static_cast<size_t>(width_) * 3;
    std::memset(rgb + from * row, cmyk ? 255 : 0, (height_ - from) * row);
  }

  void finish(uint8_t* rgb) {
    const bool smooth = would_smooth();
    const int n = static_cast<int>(comps_.size());
    std::vector<std::vector<uint8_t>> planes(n);
    std::vector<int> stride(n);
    for (int i = 0; i < n; i++)
      stride[i] = component_plane(comps_[i], smooth, &planes[i]);
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
