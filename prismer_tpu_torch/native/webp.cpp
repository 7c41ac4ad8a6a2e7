// WebP decoder whose output equals what Pillow 12 reads from a WebP file
// (libwebp 1.6 underneath) bit for bit: the RGBA canvas of the first frame
// that `WebPAnimDecoder` gives, which `Image.open(f)` holds as "RGB"
// (rawmode RGBX) or "RGBA" and `convert("RGB")` cuts to three channels.
//
// What is replicated from libwebp, and where it lives there:
//   * the RIFF container as WebPDemux parses it (demux/demux.c): simple
//     "VP8 " and "VP8L" files, "VP8X" files with ALPH, ICCP, EXIF, XMP and
//     unknown chunks, animations (ANIM / ANMF) of which the first frame is
//     drawn on a zeroed canvas at its offset (demux/anim_decode.c); a file
//     shorter than its RIFF size is refused, as WebPDemux refuses it;
//   * the mode Pillow picks, from WebPGetFeatures (dec/webp_dec.c): "RGBA"
//     when the file reports alpha or cannot be sniffed, else "RGB";
//   * VP8 (RFC 6386, dec/vp8_dec.c, dec/tree_dec.c, dec/quant_dec.c,
//     dec/frame_dec.c, dsp/dec.c): the boolean decoder, the key-frame
//     header with segments, quantizer and loop-filter deltas and 1-8 token
//     partitions, intra prediction with libwebp's edge samples (127 above
//     the frame, 129 left of it, prediction from unfiltered samples), the
//     token tree, the inverse WHT and DCT (for the blocks libwebp sends to
//     its x86 SSE2 transform, that transform's 16-bit wrapping
//     arithmetic, which corrupt coefficients reach), the simple and normal
//     loop filters with sharpness and per-segment levels; a partition that
//     runs dry before the last macroblock is an error, as in libwebp;
//   * "fancy" chroma upsampling and the 14-bit YUV->RGB of dsp/yuv.h and
//     dsp/upsampling.c, which WebPAnimDecoder leaves on;
//   * VP8L (dec/vp8l_dec.c, utils/huffman_utils.c, dsp/lossless.c): prefix
//     codes with libwebp's validity rules (a lone symbol costs no bits,
//     an incomplete or oversubscribed code is an error), meta prefix codes,
//     the colour cache, LZ77 with the 120-entry distance map, and the
//     predictor (14 modes; 14 and 15 predict black), cross-colour,
//     subtract-green and colour-indexing transforms with pixel packing; a
//     stream read past its end is an error;
//   * ALPH (dec/alpha_dec.c, dsp/filters.c): raw or VP8L-compressed alpha
//     and the horizontal, vertical and gradient unfilters. Alpha does not
//     change R, G or B, but a compressed stream that libwebp cannot decode
//     fails the frame, and Pillow then raises.
//
// Refused, with 1 and a message naming the feature, wherever WebPDemux or
// WebPDecode fails and Pillow raises "could not create decoder object" or
// "failed to read next frame": a cut file, a malformed container, a frame
// that does not fit the canvas, a VP8 inter frame, a broken bitstream.
//
// C interface (loaded with ctypes, see __init__.py):
//   int prismer_webp_info(data, n, int info[3], err, errlen)
//       info = {canvas height, canvas width, 1 if Pillow's mode is RGBA}
//   int prismer_webp_decode(data, n, out, out_size, err, errlen)
//       out = canvas height x width x 4 bytes, RGBA
// Each returns 0 on success, 1 for a file it refuses or cannot decode, 2
// for an internal failure (out of memory); `err` then holds the reason.

#include <algorithm>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <string>
#include <utility>
#include <vector>

namespace {

class WebpError : public std::exception {
 public:
  explicit WebpError(std::string m) : msg_(std::move(m)) {}
  const char* what() const noexcept override { return msg_.c_str(); }

 private:
  std::string msg_;
};

[[noreturn]] void fail(const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw WebpError(std::string("WebP: ") + buf);
}

inline uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t le24(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16);
}
inline uint32_t le32(const uint8_t* p) {
  return le24(p) | (static_cast<uint32_t>(p[3]) << 24);
}
inline bool tag_is(const uint8_t* p, const char* tag) {
  return memcmp(p, tag, 4) == 0;
}

// Pillow's decompression-bomb limit (Image.MAX_IMAGE_PIXELS * 2).
constexpr uint64_t kMaxPixels = 178956970;
constexpr uint32_t kMaxChunkPayload = ~0u - 8 - 1;
constexpr uint64_t kMaxImageArea = 1ull << 32;

// ---------------------------------------------------------------------------
// VP8 tables.

const uint8_t kDcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  10,  11,  12,  13,  14,  15,  16,  17,
    17,  18,  19,  20,  20,  21,  21,  22,  22,  23,  23,  24,  25,  25,  26,
    27,  28,  29,  30,  31,  32,  33,  34,  35,  36,  37,  37,  38,  39,  40,
    41,  42,  43,  44,  45,  46,  46,  47,  48,  49,  50,  51,  52,  53,  54,
    55,  56,  57,  58,  59,  60,  61,  62,  63,  64,  65,  66,  67,  68,  69,
    70,  71,  72,  73,  74,  75,  76,  76,  77,  78,  79,  80,  81,  82,  83,
    84,  85,  86,  87,  88,  89,  91,  93,  95,  96,  98,  100, 101, 102, 104,
    106, 108, 110, 112, 114, 116, 118, 122, 124, 126, 128, 130, 132, 134, 136,
    138, 140, 143, 145, 148, 151, 154, 157};

const uint16_t kAcTable[128] = {
    4,   5,   6,   7,   8,   9,   10,  11,  12,  13,  14,  15,  16,  17,  18,
    19,  20,  21,  22,  23,  24,  25,  26,  27,  28,  29,  30,  31,  32,  33,
    34,  35,  36,  37,  38,  39,  40,  41,  42,  43,  44,  45,  46,  47,  48,
    49,  50,  51,  52,  53,  54,  55,  56,  57,  58,  60,  62,  64,  66,  68,
    70,  72,  74,  76,  78,  80,  82,  84,  86,  88,  90,  92,  94,  96,  98,
    100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128, 131, 134,
    137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177, 181,
    185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245,
    249, 254, 259, 264, 269, 274, 279, 284};

const uint8_t kZigzag[16] = {0, 1,  4,  8,  5, 2,  3,  6,
                             9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153,
                         140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// Sub-block modes in libwebp's numbering.
enum {
  B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED,
  B_LD_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED,
  DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED,
  TM_PRED = B_TM_PRED,
  // DC variants at the frame's edges
  DC_NOTOP = 4, DC_NOLEFT = 5, DC_NOTOPLEFT = 6
};

// RFC 6386 section 11.2's sub-block mode tree.
const int8_t kYModesIntra4[18] = {
    -B_DC_PRED, 1,  -B_TM_PRED, 2,          -B_VE_PRED, 3,
    4,          6,  -B_HE_PRED, 5,          -B_RD_PRED, -B_VR_PRED,
    -B_LD_PRED, 7,  -B_VL_PRED, 8,          -B_HD_PRED, -B_HU_PRED};


// RFC 6386 section 13.5: default token probabilities [type][band][ctx][node].
const uint8_t kCoeffsProba0[1056] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
      1,  98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
     78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
      1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
     77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
      1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
     37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
      1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
      1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
     80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
      1,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198,  35, 237, 223, 193, 187, 162, 160, 145, 155,  62,
    131,  45, 198, 221, 172, 176, 220, 157, 252, 221,   1,
     68,  47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
      1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
     81,  99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
      1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
     99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
     23,  91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
      1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
     44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
      1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
     94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
     22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
      1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
     35,  77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
      1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
     45,  99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
      1,   1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203,   1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137,   1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253,   9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175,  13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
     73,  17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
      1,  95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239,  90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155,  77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
      1,  24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201,  51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
     69,  46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
      1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
      1,  16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190,  36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
      1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
      1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213,  62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
     55,  93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202,  24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126,  38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
     61,  46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
      1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
     39,  77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
      1,  52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124,  74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
     24,  71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
      1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
     28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
      1,  81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
     20,  95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
      1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
     47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
      1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141,  84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
     42,  80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
      1,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};
// RFC 6386 section 13.4: probabilities of a token probability update.
const uint8_t kCoeffsUpdateProba[1056] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};
// RFC 6386 section 11.5: key-frame sub-block mode probabilities [above][left],
// modes in libwebp's order (DC, TM, VE, HE, RD, VR, LD, VL, HD, HU).
const uint8_t kBModesProba[900] = {
    231, 120,  48,  89, 115, 113, 120, 152, 112,
    152, 179,  64, 126, 170, 118,  46,  70,  95,
    175,  69, 143,  80,  85,  82,  72, 155, 103,
     56,  58,  10, 171, 218, 189,  17,  13, 152,
    114,  26,  17, 163,  44, 195,  21,  10, 173,
    121,  24,  80, 195,  26,  62,  44,  64,  85,
    144,  71,  10,  38, 171, 213, 144,  34,  26,
    170,  46,  55,  19, 136, 160,  33, 206,  71,
     63,  20,   8, 114, 114, 208,  12,   9, 226,
     81,  40,  11,  96, 182,  84,  29,  16,  36,
    134, 183,  89, 137,  98, 101, 106, 165, 148,
     72, 187, 100, 130, 157, 111,  32,  75,  80,
     66, 102, 167,  99,  74,  62,  40, 234, 128,
     41,  53,   9, 178, 241, 141,  26,   8, 107,
     74,  43,  26, 146,  73, 166,  49,  23, 157,
     65,  38, 105, 160,  51,  52,  31, 115, 128,
    104,  79,  12,  27, 217, 255,  87,  17,   7,
     87,  68,  71,  44, 114,  51,  15, 186,  23,
     47,  41,  14, 110, 182, 183,  21,  17, 194,
     66,  45,  25, 102, 197, 189,  23,  18,  22,
     88,  88, 147, 150,  42,  46,  45, 196, 205,
     43,  97, 183, 117,  85,  38,  35, 179,  61,
     39,  53, 200,  87,  26,  21,  43, 232, 171,
     56,  34,  51, 104, 114, 102,  29,  93,  77,
     39,  28,  85, 171,  58, 165,  90,  98,  64,
     34,  22, 116, 206,  23,  34,  43, 166,  73,
    107,  54,  32,  26,  51,   1,  81,  43,  31,
     68,  25, 106,  22,  64, 171,  36, 225, 114,
     34,  19,  21, 102, 132, 188,  16,  76, 124,
     62,  18,  78,  95,  85,  57,  50,  48,  51,
    193, 101,  35, 159, 215, 111,  89,  46, 111,
     60, 148,  31, 172, 219, 228,  21,  18, 111,
    112, 113,  77,  85, 179, 255,  38, 120, 114,
     40,  42,   1, 196, 245, 209,  10,  25, 109,
     88,  43,  29, 140, 166, 213,  37,  43, 154,
     61,  63,  30, 155,  67,  45,  68,   1, 209,
    100,  80,   8,  43, 154,   1,  51,  26,  71,
    142,  78,  78,  16, 255, 128,  34, 197, 171,
     41,  40,   5, 102, 211, 183,   4,   1, 221,
     51,  50,  17, 168, 209, 192,  23,  25,  82,
    138,  31,  36, 171,  27, 166,  38,  44, 229,
     67,  87,  58, 169,  82, 115,  26,  59, 179,
     63,  59,  90, 180,  59, 166,  93,  73, 154,
     40,  40,  21, 116, 143, 209,  34,  39, 175,
     47,  15,  16, 183,  34, 223,  49,  45, 183,
     46,  17,  33, 183,   6,  98,  15,  32, 183,
     57,  46,  22,  24, 128,   1,  54,  17,  37,
     65,  32,  73, 115,  28, 128,  23, 128, 205,
     40,   3,   9, 115,  51, 192,  18,   6, 223,
     87,  37,   9, 115,  59,  77,  64,  21,  47,
    104,  55,  44, 218,   9,  54,  53, 130, 226,
     64,  90,  70, 205,  40,  41,  23,  26,  57,
     54,  57, 112, 184,   5,  41,  38, 166, 213,
     30,  34,  26, 133, 152, 116,  10,  32, 134,
     39,  19,  53, 221,  26, 114,  32,  73, 255,
     31,   9,  65, 234,   2,  15,   1, 118,  73,
     75,  32,  12,  51, 192, 255, 160,  43,  51,
     88,  31,  35,  67, 102,  85,  55, 186,  85,
     56,  21,  23, 111,  59, 205,  45,  37, 192,
     55,  38,  70, 124,  73, 102,   1,  34,  98,
    125,  98,  42,  88, 104,  85, 117, 175,  82,
     95,  84,  53,  89, 128, 100, 113, 101,  45,
     75,  79, 123,  47,  51, 128,  81, 171,   1,
     57,  17,   5,  71, 102,  57,  53,  41,  49,
     38,  33,  13, 121,  57,  73,  26,   1,  85,
     41,  10,  67, 138,  77, 110,  90,  47, 114,
    115,  21,   2,  10, 102, 255, 166,  23,   6,
    101,  29,  16,  10,  85, 128, 101, 196,  26,
     57,  18,  10, 102, 102, 213,  34,  20,  43,
    117,  20,  15,  36, 163, 128,  68,   1,  26,
    102,  61,  71,  37,  34,  53,  31, 243, 192,
     69,  60,  71,  38,  73, 119,  28, 222,  37,
     68,  45, 128,  34,   1,  47,  11, 245, 171,
     62,  17,  19,  70, 146,  85,  55,  62,  70,
     37,  43,  37, 154, 100, 163,  85, 160,   1,
     63,   9,  92, 136,  28,  64,  32, 201,  85,
     75,  15,   9,   9,  64, 255, 184, 119,  16,
     86,   6,  28,   5,  64, 255,  25, 248,   1,
     56,   8,  17, 132, 137, 255,  55, 116, 128,
     58,  15,  20,  82, 135,  57,  26, 121,  40,
    164,  50,  31, 137, 154, 133,  25,  35, 218,
     51, 103,  44, 131, 131, 123,  31,   6, 158,
     86,  40,  64, 135, 148, 224,  45, 183, 128,
     22,  26,  17, 131, 240, 154,  14,   1, 209,
     45,  16,  21,  91,  64, 222,   7,   1, 197,
     56,  21,  39, 155,  60, 138,  23, 102, 213,
     83,  12,  13,  54, 192, 255,  68,  47,  28,
     85,  26,  85,  85, 128, 128,  32, 146, 171,
     18,  11,   7,  63, 144, 171,   4,   4, 246,
     35,  27,  10, 146, 174, 171,  12,  26, 128,
    190,  80,  35,  99, 180,  80, 126,  54,  45,
     85, 126,  47,  87, 176,  51,  41,  20,  32,
    101,  75, 128, 139, 118, 146, 116, 128,  85,
     56,  41,  15, 176, 236,  85,  37,   9,  62,
     71,  30,  17, 119, 118, 255,  17,  18, 138,
    101,  38,  60, 138,  55,  70,  43,  26, 142,
    146,  36,  19,  30, 171, 255,  97,  27,  20,
    138,  45,  61,  62, 219,   1,  81, 188,  64,
     32,  41,  20, 117, 151, 142,  20,  21, 163,
    112,  19,  12,  61, 195, 128,  48,   4,  24,
};

// ---------------------------------------------------------------------------
// VP8 boolean decoder (RFC 6386 section 7), in libwebp's form: `range_` is
// the range less one, bytes come in one at a time, and a read past the end
// supplies zeros once and sets `eof` (utils/bit_reader_utils.c).

class BoolReader {
 public:
  void init(const uint8_t* p, size_t n) {
    buf_ = p;
    end_ = p + n;
    value_ = 0;
    bits_ = -8;
    range_ = 255 - 1;
    eof_ = false;
    load();
  }
  bool eof() const { return eof_; }

  int get_bit(int prob) {
    uint32_t range = range_;
    if (bits_ < 0) load();
    const int pos = bits_;
    const uint32_t split = (range * prob) >> 8;
    const uint32_t value = static_cast<uint32_t>(value_ >> pos);
    const int bit = value > split;
    if (bit) {
      range -= split;
      value_ -= static_cast<uint64_t>(split + 1) << pos;
    } else {
      range = split + 1;
    }
    const int shift = 7 ^ (31 - __builtin_clz(range));
    range <<= shift;
    bits_ -= shift;
    range_ = range - 1;
    return bit;
  }
  int get_value(int nbits) {
    int v = 0;
    while (nbits-- > 0) v |= get_bit(0x80) << nbits;
    return v;
  }
  int get_signed_value(int nbits) {
    const int v = get_value(nbits);
    return get_bit(0x80) ? -v : v;
  }
  int get_signed(int v) { return get_bit(0x80) ? -v : v; }

 private:
  void load() {
    if (buf_ < end_) {
      bits_ += 8;
      value_ = (value_ << 8) | *buf_++;
    } else if (!eof_) {
      value_ <<= 8;
      bits_ += 8;
      eof_ = true;
    } else {
      bits_ = 0;
    }
  }
  const uint8_t* buf_ = nullptr;
  const uint8_t* end_ = nullptr;
  uint64_t value_ = 0;
  int bits_ = 0;
  uint32_t range_ = 0;
  bool eof_ = false;
};

inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

// ---------------------------------------------------------------------------
// Prediction, transforms and loop filters (dsp/dec.c). `dst` points into a
// work buffer of stride BPS whose row above and column to the left hold the
// edge samples.

constexpr int BPS = 32;

#define DST(x, y) dst[(x) + (y) * BPS]
inline uint8_t avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline uint8_t avg2(int a, int b) { return (a + b + 1) >> 1; }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip255(top[x] + l - tl);
    dst += BPS;
  }
}

void pred4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  switch (mode) {
    case B_DC_PRED: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
      dc >>= 3;
      for (int i = 0; i < 4; ++i) memset(dst + i * BPS, dc, 4);
      break;
    }
    case B_TM_PRED:
      true_motion(dst, 4);
      break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {avg3(top[-1], top[0], top[1]),
                               avg3(top[0], top[1], top[2]),
                               avg3(top[1], top[2], top[3]),
                               avg3(top[2], top[3], top[4])};
      for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE_PRED: {
      const int A = dst[-1 - BPS], B = dst[-1], C = dst[-1 + BPS];
      const int D = dst[-1 + 2 * BPS], E = dst[-1 + 3 * BPS];
      memset(dst + 0 * BPS, avg3(A, B, C), 4);
      memset(dst + 1 * BPS, avg3(B, C, D), 4);
      memset(dst + 2 * BPS, avg3(C, D, E), 4);
      memset(dst + 3 * BPS, avg3(D, E, E), 4);
      break;
    }
    case B_RD_PRED: {
      const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS];
      const int L = dst[-1 + 3 * BPS], X = dst[-1 - BPS];
      const int A = top[0], B = top[1], C = top[2], D = top[3];
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    }
    case B_LD_PRED: {
      const int A = top[0], B = top[1], C = top[2], D = top[3];
      const int E = top[4], F = top[5], G = top[6], H = top[7];
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    }
    case B_VR_PRED: {
      const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS];
      const int X = dst[-1 - BPS];
      const int A = top[0], B = top[1], C = top[2], D = top[3];
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    }
    case B_VL_PRED: {
      const int A = top[0], B = top[1], C = top[2], D = top[3];
      const int E = top[4], F = top[5], G = top[6], H = top[7];
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    }
    case B_HD_PRED: {
      const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS];
      const int L = dst[-1 + 3 * BPS], X = dst[-1 - BPS];
      const int A = top[0], B = top[1], C = top[2];
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    }
    case B_HU_PRED: {
      const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS];
      const int L = dst[-1 + 3 * BPS];
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
    }
  }
}
#undef DST

// 16x16 luma (size 16) and 8x8 chroma (size 8) prediction.
void pred_block(uint8_t* dst, int size, int mode) {
  const int shift = size == 16 ? 4 : 3;
  int dc = 0;
  switch (mode) {
    case TM_PRED:
      true_motion(dst, size);
      return;
    case V_PRED:
      for (int j = 0; j < size; ++j) memcpy(dst + j * BPS, dst - BPS, size);
      return;
    case H_PRED:
      for (int j = 0; j < size; ++j) {
        memset(dst + j * BPS, dst[j * BPS - 1], size);
      }
      return;
    case DC_PRED:
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      dc = (dc + size) >> (shift + 1);
      break;
    case DC_NOTOP:
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      dc = (dc + (size >> 1)) >> shift;
      break;
    case DC_NOLEFT:
      for (int j = 0; j < size; ++j) dc += dst[j - BPS];
      dc = (dc + (size >> 1)) >> shift;
      break;
    default:  // DC_NOTOPLEFT
      dc = 0x80;
      break;
  }
  for (int j = 0; j < size; ++j) memset(dst + j * BPS, dc, size);
}

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

void transform_one(const int16_t* in, uint8_t* dst) {
  int C[16];
  int* tmp = C;
  for (int i = 0; i < 4; ++i) {  // vertical pass
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    in++;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {  // horizontal pass
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]);
    const int d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip255(dst[0] + ((a + d) >> 3));
    dst[1] = clip255(dst[1] + ((b + c) >> 3));
    dst[2] = clip255(dst[2] + ((b - c) >> 3));
    dst[3] = clip255(dst[3] + ((a - d) >> 3));
    tmp++;
    dst += BPS;
  }
}

// dsp/dec_sse2.c's Transform_SSE2, which libwebp runs on x86 for a block
// with more than three coded coefficients and for the chroma blocks of a
// plane with any AC coefficient: the same arithmetic as transform_one in
// 16-bit lanes (K * x as mulhi(x, K - 65536) + x), so the coefficients that
// corrupt data can yield wrap as they do there.
inline int16_t w16(int v) { return static_cast<int16_t>(v); }
inline int16_t mulhi(int16_t x, int k) { return w16((x * k) >> 16); }
void idct_pass16(const int16_t* in0, const int16_t* in1, const int16_t* in2,
                 const int16_t* in3, int16_t* out, int dc_add) {
  for (int i = 0; i < 4; ++i) {
    const int16_t dc = w16(in0[i] + dc_add);
    const int16_t a = w16(dc + in2[i]);
    const int16_t b = w16(dc - in2[i]);
    const int16_t c = w16(w16(in1[i] - in3[i]) +
                          w16(mulhi(in1[i], -30068) - mulhi(in3[i], 20091)));
    const int16_t d = w16(w16(in1[i] + in3[i]) +
                          w16(mulhi(in1[i], 20091) + mulhi(in3[i], -30068)));
    out[4 * i + 0] = w16(a + d);
    out[4 * i + 1] = w16(b + c);
    out[4 * i + 2] = w16(b - c);
    out[4 * i + 3] = w16(a - d);
  }
}
void transform_sse2(const int16_t* in, uint8_t* dst) {
  int16_t t[16], u[16];
  idct_pass16(in, in + 4, in + 8, in + 12, t, 0);  // columns, transposed
  idct_pass16(t, t + 4, t + 8, t + 12, u, 4);      // rows, transposed back
  for (int y = 0; y < 4; ++y) {
    for (int x = 0; x < 4; ++x) {
      const int v = dst[x + y * BPS] + (u[4 * y + x] >> 3);
      dst[x + y * BPS] = v < 0 ? 0 : v > 255 ? 255 : v;
    }
  }
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
    out += 64;
  }
}

// Loop filters; `p` is the first pixel past the edge, `step` crosses it.
inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip255(p0 + a2);
  p[0] = clip255(q0 - a1);
}
inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip255(p1 + a3);
  p[-step] = clip255(p0 + a2);
  p[0] = clip255(q0 - a1);
  p[step] = clip255(q1 - a3);
}
inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip255(p2 + a3);
  p[-2 * step] = clip255(p1 + a2);
  p[-step] = clip255(p0 + a1);
  p[0] = clip255(q0 - a1);
  p[step] = clip255(q1 - a2);
  p[2 * step] = clip255(q2 - a3);
}
inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return abs(p1 - p0) > thresh || abs(q1 - q0) > thresh;
}
inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * abs(p0 - q0) + abs(p1 - q1) <= t;
}
inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * abs(p0 - q0) + abs(p1 - q1) > t) return false;
  return abs(p3 - p2) <= it && abs(p2 - p1) <= it && abs(p1 - p0) <= it &&
         abs(q3 - q2) <= it && abs(q2 - q1) <= it && abs(q1 - q0) <= it;
}
void simple_filter(uint8_t* p, int step, int along, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i) {
    if (needs_filter(p + i * along, step, t2)) do_filter2(p + i * along, step);
  }
}
// `edge`: 6-tap macroblock-edge filter, else the 4-tap inner-edge one.
void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh,
                 int ithresh, int hev_t, bool edge) {
  const int t2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (needs_filter2(p, hstride, t2, ithresh)) {
      if (hev(p, hstride, hev_t)) {
        do_filter2(p, hstride);
      } else if (edge) {
        do_filter6(p, hstride);
      } else {
        do_filter4(p, hstride);
      }
    }
    p += vstride;
  }
}

// ---------------------------------------------------------------------------
// VP8 key-frame decoder. Reconstructs every macroblock into whole-frame
// planes (prediction reads unfiltered samples, as libwebp's row cache does),
// then runs the loop filter over the frame in raster order.

class Vp8Decoder {
 public:
  Vp8Decoder(const uint8_t* data, size_t size) : data_(data), size_(size) {}

  // Decodes the frame and writes width x height RGBA pixels (alpha 255)
  // into `out` with row stride `stride` bytes.
  void decode(uint8_t* out, size_t stride, int expect_w, int expect_h);

 private:
  struct FInfo {
    uint8_t limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
  };
  struct Quant {
    int y1[2], y2[2], uv[2];
  };
  struct MBData {
    int16_t coeffs[384];
    uint8_t is_i4x4 = 0, imodes[16] = {0}, uvmode = 0, segment = 0, skip = 0;
    uint32_t non_zero_y = 0, non_zero_uv = 0;
  };
  struct NZ {
    uint8_t nz = 0, nz_dc = 0;
  };

  void parse_headers();
  void parse_segment_header();
  void parse_filter_header();
  void parse_partitions(const uint8_t* buf, size_t size);
  void parse_quant();
  void parse_proba();
  void precompute_filter_strengths();
  void parse_intra_mode(int mb_x);
  bool decode_mb(int mb_x, int mb_y, BoolReader& tbr);
  int parse_residuals(int mb_x, BoolReader& tbr);
  int get_coeffs(BoolReader& br, int type, int ctx, const int* dq, int n,
                 int16_t* out);
  int get_large_value(BoolReader& br, const uint8_t* p);
  void reconstruct_row(int mb_y);
  void filter_mb(int mb_x, int mb_y);
  void emit_rgba(uint8_t* out, size_t stride);

  const uint8_t* data_;
  size_t size_;
  int width_ = 0, height_ = 0, mb_w_ = 0, mb_h_ = 0;
  BoolReader br_;
  BoolReader parts_[8];
  int num_parts_minus_one_ = 0;
  bool use_segment_ = false, update_map_ = false, absolute_delta_ = true;
  int quantizer_[4] = {0, 0, 0, 0}, filter_strength_[4] = {0, 0, 0, 0};
  uint8_t seg_probs_[3] = {255, 255, 255};
  int simple_ = 0, level_ = 0, sharpness_ = 0;
  bool use_lf_delta_ = false;
  int ref_lf_delta_[4] = {0, 0, 0, 0}, mode_lf_delta_[4] = {0, 0, 0, 0};
  int filter_type_ = 0;
  Quant dqm_[4];
  uint8_t proba_[4][8][3][11];
  bool use_skip_proba_ = false;
  int skip_p_ = 0;
  FInfo fstrengths_[4][2];
  std::vector<uint8_t> y_, u_, v_;
  int ystride_ = 0, uvstride_ = 0;
  std::vector<FInfo> finfo_;
  std::vector<uint8_t> intra_t_;
  uint8_t intra_l_[4] = {0, 0, 0, 0};
  std::vector<NZ> nz_top_;
  NZ nz_left_;
  std::vector<MBData> row_;
};

void Vp8Decoder::parse_headers() {
  const uint8_t* buf = data_;
  size_t buf_size = size_;
  if (buf_size < 4) fail("VP8 frame header is truncated");
  const uint32_t bits = le24(buf);
  const bool key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7;
  const int show = (bits >> 4) & 1;
  const uint32_t partition_length = bits >> 5;
  if (profile > 3) fail("VP8 profile %d is not 0-3", profile);
  if (!show) fail("VP8 frame is not displayable");
  if (!key_frame) fail("VP8 inter frames are not decoded (not a key frame)");
  buf += 3;
  buf_size -= 3;
  if (buf_size < 7) fail("VP8 picture header is truncated");
  if (!(buf[0] == 0x9d && buf[1] == 0x01 && buf[2] == 0x2a)) {
    fail("VP8 start code is missing");
  }
  width_ = le16(buf + 3) & 0x3fff;
  height_ = le16(buf + 5) & 0x3fff;
  buf += 7;
  buf_size -= 7;
  mb_w_ = (width_ + 15) >> 4;
  mb_h_ = (height_ + 15) >> 4;
  if (partition_length > buf_size) fail("VP8 first partition is truncated");
  br_.init(buf, partition_length);
  buf += partition_length;
  buf_size -= partition_length;

  br_.get_bit(0x80);  // colour space
  br_.get_bit(0x80);  // clamping type
  parse_segment_header();
  if (br_.eof()) fail("VP8 segment header is truncated");
  parse_filter_header();
  if (br_.eof()) fail("VP8 filter header is truncated");
  parse_partitions(buf, buf_size);
  parse_quant();
  br_.get_bit(0x80);  // update_proba, ignored on a key frame
  parse_proba();
}

void Vp8Decoder::parse_segment_header() {
  use_segment_ = br_.get_bit(0x80);
  if (use_segment_) {
    update_map_ = br_.get_bit(0x80);
    if (br_.get_bit(0x80)) {  // update data
      absolute_delta_ = br_.get_bit(0x80);
      for (int s = 0; s < 4; ++s) {
        quantizer_[s] = br_.get_bit(0x80) ? br_.get_signed_value(7) : 0;
      }
      for (int s = 0; s < 4; ++s) {
        filter_strength_[s] = br_.get_bit(0x80) ? br_.get_signed_value(6) : 0;
      }
    }
    if (update_map_) {
      for (int s = 0; s < 3; ++s) {
        seg_probs_[s] = br_.get_bit(0x80) ? br_.get_value(8) : 255;
      }
    }
  } else {
    update_map_ = false;
  }
}

void Vp8Decoder::parse_filter_header() {
  simple_ = br_.get_bit(0x80);
  level_ = br_.get_value(6);
  sharpness_ = br_.get_value(3);
  use_lf_delta_ = br_.get_bit(0x80);
  if (use_lf_delta_ && br_.get_bit(0x80)) {
    for (int i = 0; i < 4; ++i) {
      if (br_.get_bit(0x80)) ref_lf_delta_[i] = br_.get_signed_value(6);
    }
    for (int i = 0; i < 4; ++i) {
      if (br_.get_bit(0x80)) mode_lf_delta_[i] = br_.get_signed_value(6);
    }
  }
  filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
}

void Vp8Decoder::parse_partitions(const uint8_t* buf, size_t size) {
  const uint8_t* sz = buf;
  const uint8_t* buf_end = buf + size;
  num_parts_minus_one_ = (1 << br_.get_value(2)) - 1;
  const size_t last_part = num_parts_minus_one_;
  if (size < 3 * last_part) fail("VP8 partition sizes are truncated");
  const uint8_t* part_start = buf + last_part * 3;
  size_t size_left = size - last_part * 3;
  for (size_t p = 0; p < last_part; ++p) {
    size_t psize = le24(sz);
    if (psize > size_left) psize = size_left;
    parts_[p].init(part_start, psize);
    part_start += psize;
    size_left -= psize;
    sz += 3;
  }
  parts_[last_part].init(part_start, size_left);
  if (part_start >= buf_end) fail("VP8 token partitions are truncated");
}

void Vp8Decoder::parse_quant() {
  const int base_q0 = br_.get_value(7);
  const int dqy1_dc = br_.get_bit(0x80) ? br_.get_signed_value(4) : 0;
  const int dqy2_dc = br_.get_bit(0x80) ? br_.get_signed_value(4) : 0;
  const int dqy2_ac = br_.get_bit(0x80) ? br_.get_signed_value(4) : 0;
  const int dquv_dc = br_.get_bit(0x80) ? br_.get_signed_value(4) : 0;
  const int dquv_ac = br_.get_bit(0x80) ? br_.get_signed_value(4) : 0;
  auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
  for (int i = 0; i < 4; ++i) {
    int q;
    if (use_segment_) {
      q = quantizer_[i];
      if (!absolute_delta_) q += base_q0;
    } else if (i > 0) {
      dqm_[i] = dqm_[0];
      continue;
    } else {
      q = base_q0;
    }
    Quant& m = dqm_[i];
    m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
    m.y1[1] = kAcTable[clip(q, 127)];
    m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
    // x * 155 / 100 for every x in [0, 284]
    m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
    m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
  }
}

void Vp8Decoder::parse_proba() {
  int i = 0;
  for (int t = 0; t < 4; ++t) {
    for (int b = 0; b < 8; ++b) {
      for (int c = 0; c < 3; ++c) {
        for (int p = 0; p < 11; ++p, ++i) {
          proba_[t][b][c][p] = br_.get_bit(kCoeffsUpdateProba[i])
                                   ? br_.get_value(8)
                                   : kCoeffsProba0[i];
        }
      }
    }
  }
  use_skip_proba_ = br_.get_bit(0x80);
  if (use_skip_proba_) skip_p_ = br_.get_value(8);
}

void Vp8Decoder::precompute_filter_strengths() {
  if (filter_type_ == 0) return;
  for (int s = 0; s < 4; ++s) {
    int base_level;
    if (use_segment_) {
      base_level = filter_strength_[s];
      if (!absolute_delta_) base_level += level_;
    } else {
      base_level = level_;
    }
    for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
      FInfo& info = fstrengths_[s][i4x4];
      int level = base_level;
      if (use_lf_delta_) {
        level += ref_lf_delta_[0];
        if (i4x4) level += mode_lf_delta_[0];
      }
      level = level < 0 ? 0 : level > 63 ? 63 : level;
      if (level > 0) {
        int ilevel = level;
        if (sharpness_ > 0) {
          ilevel >>= sharpness_ > 4 ? 2 : 1;
          if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
        }
        if (ilevel < 1) ilevel = 1;
        info.ilevel = ilevel;
        info.limit = 2 * level + ilevel;
        info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
      } else {
        info.limit = 0;
      }
      info.inner = i4x4;
    }
  }
}

void Vp8Decoder::parse_intra_mode(int mb_x) {
  uint8_t* const top = &intra_t_[4 * mb_x];
  uint8_t* const left = intra_l_;
  MBData& block = row_[mb_x];
  if (update_map_) {
    block.segment = !br_.get_bit(seg_probs_[0])
                        ? br_.get_bit(seg_probs_[1])
                        : br_.get_bit(seg_probs_[2]) + 2;
  } else {
    block.segment = 0;
  }
  if (use_skip_proba_) block.skip = br_.get_bit(skip_p_);
  block.is_i4x4 = !br_.get_bit(145);
  if (!block.is_i4x4) {
    const int ymode = br_.get_bit(156)
                          ? (br_.get_bit(128) ? TM_PRED : H_PRED)
                          : (br_.get_bit(163) ? V_PRED : DC_PRED);
    block.imodes[0] = ymode;
    memset(top, ymode, 4);
    memset(left, ymode, 4);
  } else {
    uint8_t* modes = block.imodes;
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* const prob = &kBModesProba[(top[x] * 10 + ymode) * 9];
        int i = kYModesIntra4[br_.get_bit(prob[0])];
        while (i > 0) i = kYModesIntra4[2 * i + br_.get_bit(prob[i])];
        ymode = -i;
        top[x] = ymode;
      }
      memcpy(modes, top, 4);
      modes += 4;
      left[y] = ymode;
    }
  }
  block.uvmode = !br_.get_bit(142)   ? DC_PRED
                 : !br_.get_bit(114) ? V_PRED
                 : br_.get_bit(183)  ? TM_PRED
                                     : H_PRED;
}

int Vp8Decoder::get_large_value(BoolReader& br, const uint8_t* p) {
  int v;
  if (!br.get_bit(p[3])) {
    if (!br.get_bit(p[4])) {
      v = 2;
    } else {
      v = 3 + br.get_bit(p[5]);
    }
  } else {
    if (!br.get_bit(p[6])) {
      if (!br.get_bit(p[7])) {
        v = 5 + br.get_bit(159);
      } else {
        v = 7 + 2 * br.get_bit(165);
        v += br.get_bit(145);
      }
    } else {
      const int bit1 = br.get_bit(p[8]);
      const int bit0 = br.get_bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) {
        v += v + br.get_bit(*tab);
      }
      v += 3 + (8 << cat);
    }
  }
  return v;
}

// Returns the position after the last non-zero coefficient (libwebp's
// GetCoeffs); coefficients are stored dequantized, as int16 (wrapping).
int Vp8Decoder::get_coeffs(BoolReader& br, int type, int ctx, const int* dq,
                           int n, int16_t* out) {
  const uint8_t* p = proba_[type][kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.get_bit(p[0])) return n;
    while (!br.get_bit(p[1])) {
      p = proba_[type][kBands[++n]][0];
      if (n == 16) return 16;
    }
    const uint8_t(*p_ctx)[11] = proba_[type][kBands[n + 1]];
    int v;
    if (!br.get_bit(p[2])) {
      v = 1;
      p = p_ctx[1];
    } else {
      v = get_large_value(br, p);
      p = p_ctx[2];
    }
    out[kZigzag[n]] = static_cast<int16_t>(br.get_signed(v) * dq[n > 0]);
  }
  return 16;
}

inline uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
  nz_coeffs <<= 2;
  nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
  return nz_coeffs;
}

int Vp8Decoder::parse_residuals(int mb_x, BoolReader& tbr) {
  MBData& block = row_[mb_x];
  NZ& mb = nz_top_[mb_x];
  NZ& left_mb = nz_left_;
  const Quant& q = dqm_[block.segment];
  int16_t* dst = block.coeffs;
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  int first, ac_type;
  memset(dst, 0, sizeof block.coeffs);
  if (!block.is_i4x4) {  // parse DC
    int16_t dc[16] = {0};
    const int ctx = mb.nz_dc + left_mb.nz_dc;
    const int nz = get_coeffs(tbr, 1, ctx, q.y2, 0, dc);
    mb.nz_dc = left_mb.nz_dc = (nz > 0);
    if (nz > 1) {
      transform_wht(dc, dst);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 16 * 16; i += 16) dst[i] = static_cast<int16_t>(dc0);
    }
    first = 1;
    ac_type = 0;
  } else {
    first = 0;
    ac_type = 3;
  }

  uint32_t tnz = mb.nz & 0x0f;
  uint32_t lnz = left_mb.nz & 0x0f;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    uint32_t nz_coeffs = 0;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + (tnz & 1);
      const int nz = get_coeffs(tbr, ac_type, ctx, q.y1, first, dst);
      l = (nz > first);
      tnz = (tnz >> 1) | (l << 7);
      nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
      dst += 16;
    }
    tnz >>= 4;
    lnz = (lnz >> 1) | (l << 7);
    non_zero_y = (non_zero_y << 8) | nz_coeffs;
  }
  uint32_t out_t_nz = tnz;
  uint32_t out_l_nz = lnz >> 4;

  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t nz_coeffs = 0;
    tnz = mb.nz >> (4 + ch);
    lnz = left_mb.nz >> (4 + ch);
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(tbr, 2, ctx, q.uv, 0, dst);
        l = (nz > 0);
        tnz = (tnz >> 1) | (l << 3);
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 2;
      lnz = (lnz >> 1) | (l << 5);
    }
    non_zero_uv |= nz_coeffs << (4 * ch);
    out_t_nz |= (tnz << 4) << ch;
    out_l_nz |= (lnz & 0xf0) << ch;
  }
  mb.nz = static_cast<uint8_t>(out_t_nz);
  left_mb.nz = static_cast<uint8_t>(out_l_nz);
  block.non_zero_y = non_zero_y;
  block.non_zero_uv = non_zero_uv;
  return !(non_zero_y | non_zero_uv);
}

bool Vp8Decoder::decode_mb(int mb_x, int mb_y, BoolReader& tbr) {
  MBData& block = row_[mb_x];
  int skip = use_skip_proba_ ? block.skip : 0;
  if (!skip) {
    skip = parse_residuals(mb_x, tbr);
  } else {
    nz_left_.nz = nz_top_[mb_x].nz = 0;
    if (!block.is_i4x4) nz_left_.nz_dc = nz_top_[mb_x].nz_dc = 0;
    block.non_zero_y = 0;
    block.non_zero_uv = 0;
  }
  if (filter_type_ > 0) {
    FInfo f = fstrengths_[block.segment][block.is_i4x4];
    f.inner |= !skip;
    finfo_[static_cast<size_t>(mb_y) * mb_w_ + mb_x] = f;
  }
  return !tbr.eof();
}

// frame_dec.c's DoTransform / DoUVTransform: `code` is the block's 2-bit
// non-zero code (3: more than three coefficients, 2: an AC among the first
// three, 1: DC only). Codes 1-2 run libwebp's C transforms (int
// arithmetic; transform_one gives the same on such blocks), code 3 its
// SSE2 transform.
void do_transform(uint32_t code, const int16_t* in, uint8_t* dst) {
  if (code == 3) {
    transform_sse2(in, dst);
  } else if (code) {
    transform_one(in, dst);
  }
}
void do_uv_transform(uint32_t bits, const int16_t* in, uint8_t* dst) {
  if (!bits) return;
  for (int n = 0; n < 4; ++n) {
    uint8_t* const d = dst + (n & 1) * 4 + (n >> 1) * 4 * BPS;
    if (bits & 0xaa) {
      transform_sse2(in + n * 16, d);
    } else if (in[n * 16]) {
      transform_one(in + n * 16, d);  // DC only
    }
  }
}

inline int check_mode(int mb_x, int mb_y, int mode) {
  if (mode == B_DC_PRED) {
    if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
    return mb_y == 0 ? DC_NOTOP : DC_PRED;
  }
  return mode;
}

void Vp8Decoder::reconstruct_row(int mb_y) {
  // Work buffers: luma 17 rows (one above) x BPS with 4 columns to the
  // left; chroma 9 rows. Column 16..19 of rows -1, 3, 7, 11 hold the
  // top-right samples the 4x4 predictors read.
  uint8_t ybuf[17 * BPS], ubuf[9 * BPS], vbuf[9 * BPS];
  uint8_t* const y_dst = ybuf + BPS + 8;
  uint8_t* const u_dst = ubuf + BPS + 8;
  uint8_t* const v_dst = vbuf + BPS + 8;
  int kScan[16];
  for (int n = 0; n < 16; ++n) kScan[n] = (n & 3) * 4 + (n >> 2) * 4 * BPS;
  for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
    const MBData& block = row_[mb_x];
    const size_t yoff = static_cast<size_t>(mb_y) * 16 * ystride_ + mb_x * 16;
    const size_t uvoff = static_cast<size_t>(mb_y) * 8 * uvstride_ + mb_x * 8;
    uint8_t* const py = &y_[yoff];
    uint8_t* const pu = &u_[uvoff];
    uint8_t* const pv = &v_[uvoff];
    // Edge samples, as ReconstructRow leaves them.
    for (int j = 0; j < 16; ++j) {
      y_dst[j * BPS - 1] = mb_x > 0 ? py[j * ystride_ - 1] : 129;
    }
    for (int j = 0; j < 8; ++j) {
      u_dst[j * BPS - 1] = mb_x > 0 ? pu[j * uvstride_ - 1] : 129;
      v_dst[j * BPS - 1] = mb_x > 0 ? pv[j * uvstride_ - 1] : 129;
    }
    if (mb_y == 0) {
      memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      memset(u_dst - BPS - 1, 127, 8 + 1);
      memset(v_dst - BPS - 1, 127, 8 + 1);
    } else {
      y_dst[-BPS - 1] = mb_x > 0 ? py[-ystride_ - 1] : 129;
      u_dst[-BPS - 1] = mb_x > 0 ? pu[-uvstride_ - 1] : 129;
      v_dst[-BPS - 1] = mb_x > 0 ? pv[-uvstride_ - 1] : 129;
      memcpy(y_dst - BPS, py - ystride_, 16);
      memcpy(u_dst - BPS, pu - uvstride_, 8);
      memcpy(v_dst - BPS, pv - uvstride_, 8);
    }
    uint32_t bits = block.non_zero_y;
    if (block.is_i4x4) {
      uint8_t* const top_right = y_dst - BPS + 16;
      if (mb_y > 0) {
        if (mb_x >= mb_w_ - 1) {
          memset(top_right, py[-ystride_ + 15], 4);
        } else {
          memcpy(top_right, py - ystride_ + 16, 4);
        }
      }
      for (int r = 1; r <= 3; ++r) {
        memcpy(top_right + 4 * r * BPS, top_right, 4);
      }
      for (int n = 0; n < 16; ++n, bits <<= 2) {
        uint8_t* const dst = y_dst + kScan[n];
        pred4(dst, block.imodes[n]);
        do_transform(bits >> 30, block.coeffs + n * 16, dst);
      }
    } else {
      pred_block(y_dst, 16, check_mode(mb_x, mb_y, block.imodes[0]));
      for (int n = 0; n < 16; ++n, bits <<= 2) {
        do_transform(bits >> 30, block.coeffs + n * 16, y_dst + kScan[n]);
      }
    }
    const int uvmode = check_mode(mb_x, mb_y, block.uvmode);
    pred_block(u_dst, 8, uvmode);
    pred_block(v_dst, 8, uvmode);
    do_uv_transform(block.non_zero_uv & 0xff, block.coeffs + 16 * 16, u_dst);
    do_uv_transform((block.non_zero_uv >> 8) & 0xff, block.coeffs + 20 * 16,
                    v_dst);
    for (int j = 0; j < 16; ++j) memcpy(py + j * ystride_, y_dst + j * BPS, 16);
    for (int j = 0; j < 8; ++j) {
      memcpy(pu + j * uvstride_, u_dst + j * BPS, 8);
      memcpy(pv + j * uvstride_, v_dst + j * BPS, 8);
    }
  }
}

void Vp8Decoder::filter_mb(int mb_x, int mb_y) {
  const FInfo& f = finfo_[static_cast<size_t>(mb_y) * mb_w_ + mb_x];
  const int limit = f.limit;
  if (limit == 0) return;
  const int ilevel = f.ilevel;
  const int ys = ystride_, uvs = uvstride_;
  uint8_t* const y_dst = &y_[static_cast<size_t>(mb_y) * 16 * ys + mb_x * 16];
  if (filter_type_ == 1) {  // simple
    if (mb_x > 0) simple_filter(y_dst, 1, ys, limit + 4);
    if (f.inner) {
      for (int k = 1; k <= 3; ++k) simple_filter(y_dst + 4 * k, 1, ys, limit);
    }
    if (mb_y > 0) simple_filter(y_dst, ys, 1, limit + 4);
    if (f.inner) {
      for (int k = 1; k <= 3; ++k) {
        simple_filter(y_dst + 4 * k * ys, ys, 1, limit);
      }
    }
    return;
  }
  uint8_t* const u_dst = &u_[static_cast<size_t>(mb_y) * 8 * uvs + mb_x * 8];
  uint8_t* const v_dst = &v_[static_cast<size_t>(mb_y) * 8 * uvs + mb_x * 8];
  const int hev_t = f.hev_thresh;
  if (mb_x > 0) {
    filter_loop(y_dst, 1, ys, 16, limit + 4, ilevel, hev_t, true);
    filter_loop(u_dst, 1, uvs, 8, limit + 4, ilevel, hev_t, true);
    filter_loop(v_dst, 1, uvs, 8, limit + 4, ilevel, hev_t, true);
  }
  if (f.inner) {
    for (int k = 1; k <= 3; ++k) {
      filter_loop(y_dst + 4 * k, 1, ys, 16, limit, ilevel, hev_t, false);
    }
    filter_loop(u_dst + 4, 1, uvs, 8, limit, ilevel, hev_t, false);
    filter_loop(v_dst + 4, 1, uvs, 8, limit, ilevel, hev_t, false);
  }
  if (mb_y > 0) {
    filter_loop(y_dst, ys, 1, 16, limit + 4, ilevel, hev_t, true);
    filter_loop(u_dst, uvs, 1, 8, limit + 4, ilevel, hev_t, true);
    filter_loop(v_dst, uvs, 1, 8, limit + 4, ilevel, hev_t, true);
  }
  if (f.inner) {
    for (int k = 1; k <= 3; ++k) {
      filter_loop(y_dst + 4 * k * ys, ys, 1, 16, limit, ilevel, hev_t, false);
    }
    filter_loop(u_dst + 4 * uvs, uvs, 1, 8, limit, ilevel, hev_t, false);
    filter_loop(v_dst + 4 * uvs, uvs, 1, 8, limit, ilevel, hev_t, false);
  }
}

// dsp/yuv.h
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline int clip8(int v) {
  return (v & ~16383) == 0 ? (v >> 6) : (v < 0) ? 0 : 255;
}
inline void yuv_to_rgba(int y, int u, int v, uint8_t* rgba) {
  rgba[0] = clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgba[1] = clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) +
                  8708);
  rgba[2] = clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
  rgba[3] = 0xff;
}

// dsp/upsampling.c's UpsampleRgbaLinePair: u and v packed in one word.
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y,
                   const uint8_t* top_u, const uint8_t* top_v,
                   const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  auto load_uv = [](uint32_t u, uint32_t v) { return u | (v << 16); };
  const int last_pixel_pair = (len - 1) >> 1;
  uint32_t tl_uv = load_uv(top_u[0], top_v[0]);
  uint32_t l_uv = load_uv(cur_u[0], cur_v[0]);
  {
    const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
    yuv_to_rgba(top_y[0], uv0 & 0xff, uv0 >> 16, top_dst);
  }
  if (bottom_y != nullptr) {
    const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
    yuv_to_rgba(bottom_y[0], uv0 & 0xff, uv0 >> 16, bottom_dst);
  }
  for (int x = 1; x <= last_pixel_pair; ++x) {
    const uint32_t t_uv = load_uv(top_u[x], top_v[x]);
    const uint32_t uv = load_uv(cur_u[x], cur_v[x]);
    const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
    {
      const uint32_t uv0 = (diag_12 + tl_uv) >> 1;
      const uint32_t uv1 = (diag_03 + t_uv) >> 1;
      yuv_to_rgba(top_y[2 * x - 1], uv0 & 0xff, uv0 >> 16,
                  top_dst + (2 * x - 1) * 4);
      yuv_to_rgba(top_y[2 * x], uv1 & 0xff, uv1 >> 16, top_dst + 2 * x * 4);
    }
    if (bottom_y != nullptr) {
      const uint32_t uv0 = (diag_03 + l_uv) >> 1;
      const uint32_t uv1 = (diag_12 + uv) >> 1;
      yuv_to_rgba(bottom_y[2 * x - 1], uv0 & 0xff, uv0 >> 16,
                  bottom_dst + (2 * x - 1) * 4);
      yuv_to_rgba(bottom_y[2 * x], uv1 & 0xff, uv1 >> 16,
                  bottom_dst + 2 * x * 4);
    }
    tl_uv = t_uv;
    l_uv = uv;
  }
  if (!(len & 1)) {
    {
      const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
      yuv_to_rgba(top_y[len - 1], uv0 & 0xff, uv0 >> 16,
                  top_dst + (len - 1) * 4);
    }
    if (bottom_y != nullptr) {
      const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
      yuv_to_rgba(bottom_y[len - 1], uv0 & 0xff, uv0 >> 16,
                  bottom_dst + (len - 1) * 4);
    }
  }
}

// io_dec.c's EmitFancyRGB over the whole picture: row 0 from chroma row 0
// alone, rows 2k-1 and 2k from chroma rows k-1 and k, and the last row of
// an even height from the last chroma row alone.
void Vp8Decoder::emit_rgba(uint8_t* out, size_t stride) {
  const int w = width_, h = height_;
  auto yrow = [&](int r) { return &y_[static_cast<size_t>(r) * ystride_]; };
  auto urow = [&](int r) { return &u_[static_cast<size_t>(r) * uvstride_]; };
  auto vrow = [&](int r) { return &v_[static_cast<size_t>(r) * uvstride_]; };
  auto orow = [&](int r) { return out + static_cast<size_t>(r) * stride; };
  upsample_pair(yrow(0), nullptr, urow(0), vrow(0), urow(0), vrow(0), orow(0),
                nullptr, w);
  for (int k = 1; 2 * k - 1 < h; ++k) {
    if (2 * k < h) {
      upsample_pair(yrow(2 * k - 1), yrow(2 * k), urow(k - 1), vrow(k - 1),
                    urow(k), vrow(k), orow(2 * k - 1), orow(2 * k), w);
    } else {
      upsample_pair(yrow(h - 1), nullptr, urow(k - 1), vrow(k - 1),
                    urow(k - 1), vrow(k - 1), orow(h - 1), nullptr, w);
    }
  }
}

void Vp8Decoder::decode(uint8_t* out, size_t stride, int expect_w,
                        int expect_h) {
  parse_headers();
  if (width_ == 0 || height_ == 0) fail("VP8 frame has no pixels");
  if (width_ != expect_w || height_ != expect_h) {
    fail("VP8 frame is %dx%d where %dx%d was expected", width_, height_,
         expect_w, expect_h);
  }
  precompute_filter_strengths();
  ystride_ = mb_w_ * 16;
  uvstride_ = mb_w_ * 8;
  y_.assign(static_cast<size_t>(ystride_) * mb_h_ * 16, 0);
  u_.assign(static_cast<size_t>(uvstride_) * mb_h_ * 8, 0);
  v_.assign(static_cast<size_t>(uvstride_) * mb_h_ * 8, 0);
  finfo_.assign(static_cast<size_t>(mb_w_) * mb_h_, FInfo());
  intra_t_.assign(4 * static_cast<size_t>(mb_w_), B_DC_PRED);
  nz_top_.assign(mb_w_, NZ());
  row_.assign(mb_w_, MBData());
  for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
    BoolReader& tbr = parts_[mb_y & num_parts_minus_one_];
    for (int mb_x = 0; mb_x < mb_w_; ++mb_x) parse_intra_mode(mb_x);
    if (br_.eof()) fail("VP8 first partition ends early");
    for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
      if (!decode_mb(mb_x, mb_y, tbr)) fail("VP8 token partition ends early");
    }
    nz_left_ = NZ();
    memset(intra_l_, B_DC_PRED, sizeof intra_l_);
    reconstruct_row(mb_y);
  }
  if (filter_type_ > 0) {
    for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
      for (int mb_x = 0; mb_x < mb_w_; ++mb_x) filter_mb(mb_x, mb_y);
    }
  }
  emit_rgba(out, stride);
}

// ---------------------------------------------------------------------------
// VP8L bit reader: least significant bit first. Bits past the end read as
// zero; `eos()` is libwebp's VP8LIsEndOfStream, true once more bits were
// consumed than the stream holds (at least 64, as the reader's window).

class LBitReader {
 public:
  LBitReader(const uint8_t* p, size_t n)
      : buf_(p, p + n), len_(n), limit_(std::max<size_t>(n, 8) * 8) {
    buf_.resize(n + 16, 0);
  }
  uint32_t peek(int nbits) const {
    const size_t byte = pos_ >> 3;
    if (byte >= len_ + 8) return 0;
    uint64_t v;
    memcpy(&v, buf_.data() + byte, 8);
    v >>= (pos_ & 7);
    return static_cast<uint32_t>(v & ((1ull << nbits) - 1));
  }
  void skip(int nbits) { pos_ += nbits; }
  uint32_t read(int nbits) {
    const uint32_t v = peek(nbits);
    pos_ += nbits;
    return v;
  }
  bool eos() const { return pos_ > limit_; }

 private:
  std::vector<uint8_t> buf_;
  size_t len_;
  uint64_t limit_;
  uint64_t pos_ = 0;
};

// A canonical prefix code with utils/huffman_utils.c's validity rules.
class PrefixCode {
 public:
  static constexpr int kFastBits = 10;
  // Returns false where libwebp's VP8LBuildHuffmanTable returns 0.
  bool build(const int* lengths, int n) {
    int count[16] = {0};
    for (int s = 0; s < n; ++s) {
      if (lengths[s] > 15) return false;
      ++count[lengths[s]];
    }
    if (count[0] == n) return false;
    int used = n - count[0];
    sorted_.clear();
    for (int len = 1; len <= 15; ++len) {
      if (count[len] > (1 << len)) return false;
    }
    for (int len = 1; len <= 15; ++len) {
      for (int s = 0; s < n; ++s) {
        if (lengths[s] == len) sorted_.push_back(static_cast<uint16_t>(s));
      }
    }
    if (used == 1) {  // a lone symbol is read with no bits
      single_ = sorted_[0];
      return true;
    }
    single_ = -1;
    int num_open = 1;
    for (int len = 1; len <= 15; ++len) {
      num_open <<= 1;
      num_open -= count[len];
      if (num_open < 0) return false;
    }
    if (num_open != 0) return false;
    memcpy(count_, count, sizeof count_);
    fast_.assign(1 << kFastBits, 0);
    int code = 0, idx = 0;
    for (int len = 1; len <= 15; ++len) {
      for (int k = 0; k < count[len]; ++k, ++idx, ++code) {
        if (len > kFastBits) continue;
        int rev = 0;
        for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
        const uint32_t entry =
            (static_cast<uint32_t>(len) << 16) | sorted_[idx];
        for (int r = rev; r < (1 << kFastBits); r += 1 << len) fast_[r] = entry;
      }
      code <<= 1;
    }
    return true;
  }
  bool trivial() const { return single_ >= 0; }
  int read(LBitReader& br) const {
    if (single_ >= 0) return single_;
    const uint32_t e = fast_[br.peek(kFastBits)];
    if (e >> 16) {
      br.skip(e >> 16);
      return e & 0xffff;
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= 15; ++len) {
      code |= br.read(1);
      const int c = count_[len];
      if (code - first < c) return sorted_[index + code - first];
      index += c;
      first += c;
      first <<= 1;
      code <<= 1;
    }
    return 0;  // not reached: the code is complete
  }

 private:
  int single_ = -1;
  int count_[16] = {0};
  std::vector<uint16_t> sorted_;
  std::vector<uint32_t> fast_;
};

constexpr int kNumLiteralCodes = 256;
constexpr int kNumLengthCodes = 24;
constexpr int kNumDistanceCodes = 40;
constexpr int kCodeLengthCodes = 19;
const uint8_t kCodeLengthCodeOrder[kCodeLengthCodes] = {
    17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a,
    0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04,
    0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45,
    0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d,
    0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e,
    0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e,
    0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d,
    0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

inline int subsample(int size, int bits) {
  return (size + (1 << bits) - 1) >> bits;
}

// dsp/lossless.c, per channel.
inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
inline uint32_t clip255u(uint32_t a) { return a < 256 ? a : ~a >> 24; }
inline int sub3(int a, int b, int c) { return abs(b - c) - abs(a - c); }
inline uint32_t select_pred(uint32_t a, uint32_t b, uint32_t c) {
  const int pa_minus_pb =
      sub3(a >> 24, b >> 24, c >> 24) +
      sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
      sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
      sub3(a & 0xff, b & 0xff, c & 0xff);
  return pa_minus_pb <= 0 ? a : b;
}
inline uint32_t add_sub_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int sh = 0; sh < 32; sh += 8) {
    const int v = static_cast<int>((c0 >> sh) & 0xff) +
                  static_cast<int>((c1 >> sh) & 0xff) -
                  static_cast<int>((c2 >> sh) & 0xff);
    out |= clip255u(static_cast<uint32_t>(v)) << sh;
  }
  return out;
}
inline uint32_t add_sub_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int sh = 0; sh < 32; sh += 8) {
    const int a = (ave >> sh) & 0xff;
    const int b = (c2 >> sh) & 0xff;
    out |= clip255u(static_cast<uint32_t>(a + (a - b) / 2)) << sh;
  }
  return out;
}
// `top` is the row above; top[x + 1] of the last column is this row's
// first pixel, as in libwebp's contiguous buffer.
inline uint32_t predict(int mode, uint32_t left, const uint32_t* top) {
  switch (mode) {
    case 1: return left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return average2(average2(left, top[1]), top[0]);
    case 6: return average2(left, top[-1]);
    case 7: return average2(left, top[0]);
    case 8: return average2(top[-1], top[0]);
    case 9: return average2(top[0], top[1]);
    case 10: return average2(average2(left, top[-1]), average2(top[0], top[1]));
    case 11: return select_pred(top[0], left, top[-1]);
    case 12: return add_sub_full(left, top[0], top[-1]);
    case 13: return add_sub_half(left, top[0], top[-1]);
    default: return 0xff000000u;  // 0, and 14 and 15
  }
}

class Vp8lDecoder {
 public:
  enum {
    PREDICTOR = 0, CROSS_COLOR = 1, SUBTRACT_GREEN = 2, COLOR_INDEXING = 3
  };
  Vp8lDecoder(const uint8_t* data, size_t size) : br_(data, size) {}

  // A VP8L image with its 5-byte header: width x height ARGB pixels.
  std::vector<uint32_t> decode_image(int* width, int* height);
  // An ALPH chunk's headerless stream: alpha = the green channel.
  std::vector<uint32_t> decode_alpha(int width, int height);

 private:
  struct Group {
    PrefixCode codes[5];
  };
  struct Meta {
    int bits = 0, xsize = 0;
    std::vector<uint32_t> image;
    std::vector<Group> groups;
    int cache_bits = 0;
  };
  struct Transform {
    int type = 0, bits = 0, xsize = 0, ysize = 0;
    std::vector<uint32_t> data;
  };

  std::vector<uint32_t> decode_stream(int xsize, int ysize, bool level0);
  void read_transform(int* xsize, int ysize);
  void read_codes(Meta& meta, int xsize, int ysize, bool allow_recursion);
  void read_code(int alphabet_size, PrefixCode& code);
  void read_code_lengths(const int* cl_lengths, int num_symbols, int* lengths);
  void decode_data(const Meta& meta, int width, int height, uint32_t* data);
  int copy_distance(int symbol);
  void inverse_transforms(std::vector<uint32_t>& pixels);
  void check_eos() {
    if (br_.eos()) fail("VP8L stream ends early");
  }

  LBitReader br_;
  std::vector<Transform> transforms_;
  unsigned transforms_seen_ = 0;
  bool alpha_ = false;
  // Set while libwebp's 8-bit alpha path would decode the pixels: a stream
  // that runs dry fails there only when pixels are still missing.
  bool lenient_ = false;
};

int Vp8lDecoder::copy_distance(int symbol) {
  if (symbol < 4) return symbol + 1;
  const int extra_bits = (symbol - 2) >> 1;
  const int offset = (2 + (symbol & 1)) << extra_bits;
  return offset + br_.read(extra_bits) + 1;
}

void Vp8lDecoder::read_code_lengths(const int* cl_lengths, int num_symbols,
                                    int* lengths) {
  PrefixCode cl;
  if (!cl.build(cl_lengths, kCodeLengthCodes)) {
    fail("VP8L code-length code is invalid");
  }
  int max_symbol;
  if (br_.read(1)) {
    const int length_nbits = 2 + 2 * br_.read(3);
    max_symbol = 2 + br_.read(length_nbits);
    if (max_symbol > num_symbols) fail("VP8L code-length count is too large");
  } else {
    max_symbol = num_symbols;
  }
  int prev_code_len = 8;
  int symbol = 0;
  while (symbol < num_symbols) {
    if (max_symbol-- == 0) break;
    const int code_len = cl.read(br_);
    if (code_len < 16) {
      lengths[symbol++] = code_len;
      if (code_len != 0) prev_code_len = code_len;
    } else {
      static const int kExtraBits[3] = {2, 3, 7};
      static const int kRepeatOffsets[3] = {3, 3, 11};
      const int slot = code_len - 16;
      int repeat = br_.read(kExtraBits[slot]) + kRepeatOffsets[slot];
      if (symbol + repeat > num_symbols) fail("VP8L code lengths overrun");
      const int length = code_len == 16 ? prev_code_len : 0;
      while (repeat-- > 0) lengths[symbol++] = length;
    }
  }
}

void Vp8lDecoder::read_code(int alphabet_size, PrefixCode& code) {
  std::vector<int> lengths(std::max(alphabet_size, 256), 0);
  if (br_.read(1)) {  // simple code
    const int num_symbols = br_.read(1) + 1;
    const int first_symbol_len_code = br_.read(1);
    int symbol = br_.read(first_symbol_len_code == 0 ? 1 : 8);
    lengths[symbol] = 1;
    if (num_symbols == 2) {
      symbol = br_.read(8);
      lengths[symbol] = 1;
    }
  } else {
    int cl_lengths[kCodeLengthCodes] = {0};
    const int num_codes = br_.read(4) + 4;
    for (int i = 0; i < num_codes; ++i) {
      cl_lengths[kCodeLengthCodeOrder[i]] = br_.read(3);
    }
    read_code_lengths(cl_lengths, alphabet_size, lengths.data());
  }
  check_eos();
  if (!code.build(lengths.data(), alphabet_size)) {
    fail("VP8L prefix code is invalid");
  }
}

void Vp8lDecoder::read_codes(Meta& meta, int xsize, int ysize,
                             bool allow_recursion) {
  int num_groups = 1;
  meta.bits = 0;
  if (allow_recursion && br_.read(1)) {
    const int bits = 2 + br_.read(3);
    const int hx = subsample(xsize, bits), hy = subsample(ysize, bits);
    meta.image = decode_stream(hx, hy, false);
    meta.bits = bits;
    meta.xsize = hx;
    for (uint32_t& v : meta.image) {
      v = (v >> 8) & 0xffff;
      num_groups = std::max<int>(num_groups, v + 1);
    }
  }
  static const int kAlphabetSize[5] = {kNumLiteralCodes + kNumLengthCodes,
                                       kNumLiteralCodes, kNumLiteralCodes,
                                       kNumLiteralCodes, kNumDistanceCodes};
  meta.groups.resize(num_groups);
  for (Group& g : meta.groups) {
    for (int j = 0; j < 5; ++j) {
      int alphabet_size = kAlphabetSize[j];
      if (j == 0 && meta.cache_bits > 0) alphabet_size += 1 << meta.cache_bits;
      read_code(alphabet_size, g.codes[j]);
    }
  }
}

void Vp8lDecoder::decode_data(const Meta& meta, int width, int height,
                              uint32_t* data) {
  const size_t total = static_cast<size_t>(width) * height;
  const int len_code_limit = kNumLiteralCodes + kNumLengthCodes;
  const int cache_size = meta.cache_bits > 0 ? 1 << meta.cache_bits : 0;
  std::vector<uint32_t> cache(cache_size, 0);
  const int cache_shift = 32 - meta.cache_bits;
  size_t pos = 0, last_cached = 0;
  int col = 0, row = 0;
  auto group_at = [&](int x, int y) -> const Group& {
    if (meta.bits == 0) return meta.groups[0];
    return meta.groups[meta.image[static_cast<size_t>(meta.xsize) *
                                      (y >> meta.bits) +
                                  (x >> meta.bits)]];
  };
  auto flush_cache = [&]() {
    for (; last_cached < pos; ++last_cached) {
      const uint32_t argb = data[last_cached];
      cache[(0x1e35a7bdu * argb) >> cache_shift] = argb;
    }
  };
  while (pos < total) {
    if (lenient_ && br_.eos()) break;
    const Group& g = group_at(col, row);
    const int code = g.codes[0].read(br_);  // green, length or cache index
    if (!lenient_ && br_.eos()) break;
    if (code < kNumLiteralCodes) {
      const int red = g.codes[1].read(br_);
      const int blue = g.codes[2].read(br_);
      const int alpha = g.codes[3].read(br_);
      if (!lenient_ && br_.eos()) break;
      data[pos++] = (static_cast<uint32_t>(alpha) << 24) | (red << 16) |
                    (code << 8) | blue;
      if (++col >= width) {
        col = 0;
        ++row;
        if (cache_size) flush_cache();
      }
    } else if (code < len_code_limit) {
      const int length = copy_distance(code - kNumLiteralCodes);
      const int dist_code = copy_distance(g.codes[4].read(br_));
      size_t dist;
      if (dist_code > 120) {
        dist = dist_code - 120;
      } else {
        const int d = kCodeToPlane[dist_code - 1];
        const int v = (d >> 4) * width + 8 - (d & 0xf);
        dist = v >= 1 ? v : 1;
      }
      if (!lenient_ && br_.eos()) break;
      if (pos < dist || total - pos < static_cast<size_t>(length)) {
        fail("VP8L backward reference leaves the image");
      }
      for (int i = 0; i < length; ++i, ++pos) data[pos] = data[pos - dist];
      col += length;
      while (col >= width) {
        col -= width;
        ++row;
      }
      if (cache_size) flush_cache();
    } else if (code < len_code_limit + cache_size) {
      flush_cache();
      data[pos++] = cache[code - len_code_limit];
      if (++col >= width) {
        col = 0;
        ++row;
        flush_cache();
      }
    } else {
      fail("VP8L colour-cache index is out of range");
    }
  }
  if (pos < total || (!lenient_ && br_.eos())) fail("VP8L stream ends early");
}

std::vector<uint32_t> Vp8lDecoder::decode_stream(int xsize, int ysize,
                                                 bool level0) {
  int transform_xsize = xsize;
  if (level0) {
    while (br_.read(1)) read_transform(&transform_xsize, ysize);
  }
  Meta meta;
  if (br_.read(1)) {
    meta.cache_bits = br_.read(4);
    if (meta.cache_bits < 1 || meta.cache_bits > 11) {
      fail("VP8L colour-cache size is invalid");
    }
  }
  read_codes(meta, transform_xsize, ysize, level0);
  if (level0 && alpha_) {
    // libwebp decodes alpha with its 8-bit path only for a lone
    // colour-indexing transform, no cache and one-symbol R, B, A codes.
    lenient_ = transforms_.size() == 1 &&
               transforms_[0].type == COLOR_INDEXING && meta.cache_bits == 0;
    for (const Group& g : meta.groups) {
      lenient_ = lenient_ && g.codes[1].trivial() && g.codes[2].trivial() &&
                 g.codes[3].trivial();
    }
  }
  std::vector<uint32_t> data(static_cast<size_t>(transform_xsize) * ysize);
  decode_data(meta, transform_xsize, ysize, data.data());
  lenient_ = false;
  return data;
}

void Vp8lDecoder::read_transform(int* xsize, int ysize) {
  const int type = br_.read(2);
  if (transforms_seen_ & (1u << type)) fail("VP8L transform repeats");
  transforms_seen_ |= 1u << type;
  Transform t;
  t.type = type;
  t.xsize = *xsize;
  t.ysize = ysize;
  switch (type) {
    case PREDICTOR:
    case CROSS_COLOR:
      t.bits = br_.read(3) + 2;
      t.data = decode_stream(subsample(t.xsize, t.bits),
                             subsample(t.ysize, t.bits), false);
      break;
    case COLOR_INDEXING: {
      const int num_colors = br_.read(8) + 1;
      const int bits = num_colors > 16 ? 0 : num_colors > 4 ? 1
                       : num_colors > 2 ? 2 : 3;
      *xsize = subsample(t.xsize, bits);
      t.bits = bits;
      std::vector<uint32_t> pal = decode_stream(num_colors, 1, false);
      // Delta-coded entries; the rest of the 1 << (8 >> bits) map is
      // transparent black.
      t.data.assign(1 << (8 >> bits), 0);
      t.data[0] = pal[0];
      for (int i = 1; i < num_colors; ++i) {
        t.data[i] = add_pixels(pal[i], t.data[i - 1]);
      }
      break;
    }
    default:  // SUBTRACT_GREEN
      break;
  }
  transforms_.push_back(std::move(t));
}

void Vp8lDecoder::inverse_transforms(std::vector<uint32_t>& px) {
  for (int n = static_cast<int>(transforms_.size()) - 1; n >= 0; --n) {
    const Transform& t = transforms_[n];
    const int w = t.xsize, h = t.ysize;
    switch (t.type) {
      case PREDICTOR: {
        const int tiles_x = subsample(w, t.bits);
        for (int y = 0; y < h; ++y) {
          uint32_t* out = &px[static_cast<size_t>(y) * w];
          if (y == 0) {
            out[0] = add_pixels(out[0], 0xff000000u);
            for (int x = 1; x < w; ++x) out[x] = add_pixels(out[x], out[x - 1]);
            continue;
          }
          const uint32_t* top = out - w;
          out[0] = add_pixels(out[0], top[0]);
          const uint32_t* modes =
              &t.data[static_cast<size_t>(y >> t.bits) * tiles_x];
          for (int x = 1; x < w; ++x) {
            const int mode = (modes[x >> t.bits] >> 8) & 0xf;
            out[x] = add_pixels(out[x], predict(mode, out[x - 1], top + x));
          }
        }
        break;
      }
      case CROSS_COLOR: {
        const int tiles_x = subsample(w, t.bits);
        for (int y = 0; y < h; ++y) {
          uint32_t* p = &px[static_cast<size_t>(y) * w];
          const uint32_t* codes =
              &t.data[static_cast<size_t>(y >> t.bits) * tiles_x];
          for (int x = 0; x < w; ++x) {
            const uint32_t code = codes[x >> t.bits];
            const int8_t g2r = static_cast<int8_t>(code & 0xff);
            const int8_t g2b = static_cast<int8_t>((code >> 8) & 0xff);
            const int8_t r2b = static_cast<int8_t>((code >> 16) & 0xff);
            const uint32_t argb = p[x];
            const int8_t green = static_cast<int8_t>(argb >> 8);
            int new_red = (argb >> 16) & 0xff;
            int new_blue = argb & 0xff;
            new_red += (static_cast<int>(g2r) * green) >> 5;
            new_red &= 0xff;
            new_blue += (static_cast<int>(g2b) * green) >> 5;
            new_blue +=
                (static_cast<int>(r2b) * static_cast<int8_t>(new_red)) >> 5;
            new_blue &= 0xff;
            p[x] = (argb & 0xff00ff00u) | (new_red << 16) | new_blue;
          }
        }
        break;
      }
      case SUBTRACT_GREEN:
        for (uint32_t& v : px) {
          const uint32_t g = (v >> 8) & 0xff;
          const uint32_t rb =
              ((v & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
          v = (v & 0xff00ff00u) | rb;
        }
        break;
      case COLOR_INDEXING: {
        const int in_w = subsample(w, t.bits);
        std::vector<uint32_t> out(static_cast<size_t>(w) * h);
        const int bits_per_pixel = 8 >> t.bits;
        const int count_mask = (1 << t.bits) - 1;
        const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
        for (int y = 0; y < h; ++y) {
          const uint32_t* src = &px[static_cast<size_t>(y) * in_w];
          uint32_t* dst = &out[static_cast<size_t>(y) * w];
          uint32_t packed = 0;
          for (int x = 0; x < w; ++x) {
            if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
            dst[x] = t.data[packed & bit_mask];
            packed >>= bits_per_pixel;
          }
        }
        px.swap(out);
        break;
      }
    }
  }
}

std::vector<uint32_t> Vp8lDecoder::decode_image(int* width, int* height) {
  if (br_.read(8) != 0x2f) fail("VP8L signature is missing");
  *width = br_.read(14) + 1;
  *height = br_.read(14) + 1;
  br_.read(1);  // alpha_is_used: a hint, the pixels carry their alpha
  if (br_.read(3) != 0) fail("VP8L version is not 0");
  check_eos();
  std::vector<uint32_t> px = decode_stream(*width, *height, true);
  inverse_transforms(px);
  return px;
}

std::vector<uint32_t> Vp8lDecoder::decode_alpha(int width, int height) {
  alpha_ = true;
  std::vector<uint32_t> px = decode_stream(width, height, true);
  inverse_transforms(px);
  return px;
}

// ALPH chunk -> width x height alpha plane (dec/alpha_dec.c).
void decode_alph(const uint8_t* data, size_t size, int width, int height,
                 std::vector<uint8_t>& alpha) {
  if (size <= 1) fail("ALPH chunk is empty");
  const int method = data[0] & 3;
  const int filter = (data[0] >> 2) & 3;
  const int pre_processing = (data[0] >> 4) & 3;
  const int rsrv = (data[0] >> 6) & 3;
  if (method > 1 || pre_processing > 1 || rsrv != 0) {
    fail("ALPH header is invalid");
  }
  const size_t n = static_cast<size_t>(width) * height;
  alpha.resize(n);
  if (method == 0) {
    if (size - 1 < n) fail("ALPH chunk holds too few samples");
    memcpy(alpha.data(), data + 1, n);
  } else {
    Vp8lDecoder dec(data + 1, size - 1);
    std::vector<uint32_t> px = dec.decode_alpha(width, height);
    for (size_t i = 0; i < n; ++i) alpha[i] = (px[i] >> 8) & 0xff;
  }
  // Unfilter in place, row by row (dsp/filters.c).
  for (int y = 0; y < height; ++y) {
    uint8_t* out = &alpha[static_cast<size_t>(y) * width];
    const uint8_t* prev = y > 0 ? out - width : nullptr;
    if (filter == 0) continue;
    if (prev == nullptr || filter == 1) {
      uint8_t pred = prev == nullptr ? 0 : prev[0];
      for (int i = 0; i < width; ++i) {
        out[i] = static_cast<uint8_t>(pred + out[i]);
        pred = out[i];
      }
    } else if (filter == 2) {
      for (int i = 0; i < width; ++i) {
        out[i] = static_cast<uint8_t>(prev[i] + out[i]);
      }
    } else {
      uint8_t top = prev[0], top_left = top, left = top;
      for (int i = 0; i < width; ++i) {
        top = prev[i];
        const int g = left + top - top_left;
        const int pred = (g & ~0xff) == 0 ? g : g < 0 ? 0 : 255;
        left = static_cast<uint8_t>(out[i] + pred);
        top_left = top;
        out[i] = left;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Container. `Demux` follows demux/demux.c for a complete file (a file
// shorter than its RIFF size is refused before this); `sniff_has_alpha`
// follows WebPGetFeatures (dec/webp_dec.c's ParseHeadersInternal).

struct Chunk {
  size_t offset = 0, size = 0;  // chunk header + available payload
};
struct Frame {
  int x_offset = 0, y_offset = 0, width = 0, height = 0;
  int frame_num = 0;
  bool complete = false;
  Chunk image, alpha;
};

// The size of a "VP8 " / "VP8L" chunk's image at `p` (header included),
// as WebPGetFeatures reads it from that chunk alone; false where it fails.
bool chunk_size_of(const uint8_t* p, size_t n, int* w, int* h) {
  if (n < 8) return false;
  const uint32_t size = le32(p + 4);
  const uint8_t* d = p + 8;
  const size_t dn = n - 8;
  if (tag_is(p, "VP8 ")) {
    if (dn < 10) return false;
    if (!(d[3] == 0x9d && d[4] == 0x01 && d[5] == 0x2a)) return false;
    const uint32_t bits = le24(d);
    if (bits & 1) return false;                    // not a key frame
    if (((bits >> 1) & 7) > 3 || !((bits >> 4) & 1)) return false;
    if ((bits >> 5) >= size) return false;         // partition length
    *w = le16(d + 6) & 0x3fff;
    *h = le16(d + 8) & 0x3fff;
    return *w != 0 && *h != 0;
  }
  if (dn < 5) return false;
  if (d[0] != 0x2f || (d[4] >> 5) != 0) return false;
  const uint32_t bits = le32(d + 1);
  *w = (bits & 0x3fff) + 1;
  *h = ((bits >> 14) & 0x3fff) + 1;
  return true;
}

class Demux {
 public:
  Demux(const uint8_t* data, size_t size) : data_(data) {
    if (size < 20) fail("file is shorter than a RIFF header");
    if (!tag_is(data, "RIFF") || !tag_is(data + 8, "WEBP")) {
      fail("not a RIFF WEBP file");
    }
    const uint32_t riff_size = le32(data + 4);
    if (riff_size < 8 || riff_size > kMaxChunkPayload) {
      fail("RIFF size %u is invalid", riff_size);
    }
    riff_end_ = static_cast<size_t>(riff_size) + 8;
    if (size < riff_end_) {
      fail("file is cut: %zu of its %zu bytes", size, riff_end_);
    }
    end_ = riff_end_;
    start_ = 12;
    const uint8_t* tag = data + start_;
    if (tag_is(tag, "VP8 ") || tag_is(tag, "VP8L")) {
      parse_single_image();
      valid_simple();
    } else if (tag_is(tag, "VP8X")) {
      parse_vp8x();
      valid_extended();
    } else {
      fail("first chunk is neither VP8, VP8L nor VP8X");
    }
  }
  int canvas_width = 0, canvas_height = 0;
  uint32_t flags = 0;
  std::vector<Frame> frames;
  const uint8_t* data() const { return data_; }

 private:
  size_t avail() const { return end_ - start_; }
  bool size_invalid(size_t n) const { return n > riff_end_ - start_; }
  uint32_t read_le32() {
    const uint32_t v = le32(data_ + start_);
    start_ += 4;
    return v;
  }
  // demux.c's StoreFrame; returns false for PARSE_NEED_MORE_DATA, throws
  // for PARSE_ERROR.
  bool store_frame(int frame_num, uint32_t min_size, Frame& frame);
  void parse_single_image();
  void parse_vp8x();
  void parse_animation_frame(uint32_t frame_chunk_size);
  void valid_simple();
  void valid_extended();

  const uint8_t* data_;
  size_t riff_end_ = 0, end_ = 0, start_ = 0;
  bool is_ext_ = false;
};

bool Demux::store_frame(int frame_num, uint32_t min_size, Frame& frame) {
  int alpha_chunks = 0, image_chunks = 0;
  bool ok = true;
  if (avail() < 8 || avail() < min_size) return false;
  bool done = false;
  do {
    const size_t chunk_start = start_;
    const uint32_t fourcc_pos = static_cast<uint32_t>(start_);
    start_ += 4;
    const uint32_t payload_size = read_le32();
    if (payload_size > kMaxChunkPayload) fail("chunk size is invalid");
    const uint32_t padded = payload_size + (payload_size & 1);
    const size_t available = std::min<size_t>(padded, avail());
    const size_t chunk_size = 8 + available;
    if (size_invalid(padded)) fail("chunk overruns the RIFF size");
    if (padded > avail()) ok = false;
    const uint8_t* tag = data_ + fourcc_pos;
    const bool is_vp8l = tag_is(tag, "VP8L");
    if (is_vp8l && alpha_chunks > 0) fail("VP8L frame carries an ALPH chunk");
    if (tag_is(tag, "ALPH") && alpha_chunks == 0) {
      ++alpha_chunks;
      frame.alpha = {chunk_start, chunk_size};
      frame.frame_num = frame_num;
      start_ += available;
    } else if ((is_vp8l || tag_is(tag, "VP8 ")) && image_chunks == 0) {
      int w, h;
      if (!chunk_size_of(data_ + chunk_start, chunk_size, &w, &h)) {
        fail("%.4s bitstream header is invalid", tag);
      }
      ++image_chunks;
      frame.image = {chunk_start, chunk_size};
      frame.width = w;
      frame.height = h;
      frame.frame_num = frame_num;
      frame.complete = ok;
      start_ += available;
    } else {
      start_ -= 8;  // leave the chunk to the caller
      done = true;
    }
    if (start_ == riff_end_) {
      done = true;
    } else if (avail() < 8) {
      ok = false;
    }
  } while (!done && ok);
  return ok;
}

void Demux::parse_single_image() {
  if (!frames.empty()) fail("more than one image chunk");
  if (size_invalid(8)) fail("chunk overruns the RIFF size");
  if (avail() < 8) fail("file ends inside a chunk header");
  Frame frame;
  if (!store_frame(1, 0, frame)) fail("file ends inside the image");
  if (!(flags & 0x10)) frame.alpha = Chunk();  // VP8X's alpha flag unset
  if (!is_ext_ && frame.width > 0 && frame.height > 0) {
    canvas_width = frame.width;
    canvas_height = frame.height;
  }
  if (!frames.empty() && !frames.back().complete) fail("incomplete frame");
  frames.push_back(frame);
}

void Demux::parse_animation_frame(uint32_t frame_chunk_size) {
  const bool is_animation = flags & 0x02;
  if (size_invalid(16) || frame_chunk_size < 16) fail("ANMF chunk is invalid");
  if (avail() < 16) fail("file ends inside an ANMF header");
  const uint32_t anmf_payload_size = frame_chunk_size - 16;
  Frame frame;
  const uint8_t* p = data_ + start_;
  frame.x_offset = 2 * le24(p);
  frame.y_offset = 2 * le24(p + 3);
  frame.width = 1 + le24(p + 6);
  frame.height = 1 + le24(p + 9);
  start_ += 16;
  if (static_cast<uint64_t>(frame.width) * frame.height >= kMaxImageArea) {
    fail("ANMF frame is too large");
  }
  const size_t start_offset = start_;
  if (!store_frame(static_cast<int>(frames.size()) + 1, anmf_payload_size,
                   frame)) {
    fail("file ends inside an animation frame");
  }
  if (start_ - start_offset > anmf_payload_size) {
    fail("ANMF frame overruns its chunk");
  }
  if (is_animation && frame.frame_num > 0) {
    if (!frames.empty() && !frames.back().complete) fail("incomplete frame");
    frames.push_back(frame);
  }
}

void Demux::parse_vp8x() {
  is_ext_ = true;
  if (avail() < 8) fail("file ends inside the VP8X chunk");
  start_ += 4;
  uint32_t vp8x_size = read_le32();
  if (vp8x_size > kMaxChunkPayload || vp8x_size < 10) {
    fail("VP8X chunk size is invalid");
  }
  vp8x_size += vp8x_size & 1;
  if (size_invalid(vp8x_size)) fail("VP8X chunk overruns the RIFF size");
  if (avail() < vp8x_size) fail("file ends inside the VP8X chunk");
  const uint8_t* p = data_ + start_;
  flags = p[0];
  canvas_width = 1 + le24(p + 4);
  canvas_height = 1 + le24(p + 7);
  if (static_cast<uint64_t>(canvas_width) * canvas_height >= kMaxImageArea) {
    fail("canvas is too large");
  }
  start_ += vp8x_size;
  if (size_invalid(8) || avail() < 8) fail("file holds no chunk after VP8X");

  const bool is_animation = flags & 0x02;
  int anim_chunks = 0;
  for (;;) {
    const size_t chunk_start = start_;
    const uint8_t* tag = data_ + start_;
    start_ += 4;
    const uint32_t chunk_size = read_le32();
    if (chunk_size > kMaxChunkPayload) fail("chunk size is invalid");
    const uint32_t padded = chunk_size + (chunk_size & 1);
    if (size_invalid(padded)) fail("chunk overruns the RIFF size");
    if (tag_is(tag, "VP8X")) {
      fail("second VP8X chunk");
    } else if (tag_is(tag, "ALPH") || tag_is(tag, "VP8 ") ||
               tag_is(tag, "VP8L")) {
      if (anim_chunks > 0 || is_animation) {
        fail("image chunk outside ANMF in an animation");
      }
      start_ = chunk_start;
      parse_single_image();
    } else if (tag_is(tag, "ANIM")) {
      if (padded < 6) fail("ANIM chunk is too short");
      if (avail() < padded) fail("file ends inside the ANIM chunk");
      ++anim_chunks;
      start_ += padded;
    } else if (tag_is(tag, "ANMF")) {
      if (anim_chunks == 0) fail("ANMF before ANIM");
      parse_animation_frame(padded);
    } else {  // ICCP, EXIF, XMP and unknown chunks are skipped
      if (padded > avail()) fail("file ends inside a %.4s chunk", tag);
      start_ += padded;
    }
    if (start_ == riff_end_) break;
    if (avail() < 8) fail("file ends inside a chunk header");
  }
}

bool frame_fits(const Frame& f, bool exact, int cw, int ch) {
  if (exact) {
    return f.x_offset == 0 && f.y_offset == 0 && f.width == cw &&
           f.height == ch;
  }
  return f.x_offset >= 0 && f.y_offset >= 0 && f.width + f.x_offset <= cw &&
         f.height + f.y_offset <= ch;
}

void Demux::valid_simple() {
  if (canvas_width <= 0 || canvas_height <= 0 || frames.empty() ||
      frames[0].width <= 0 || frames[0].height <= 0) {
    fail("image has no pixels");
  }
}

void Demux::valid_extended() {
  const bool is_animation = flags & 0x02;
  if (frames.empty()) fail("file holds no frame");
  if (flags & ~0x3eu) fail("VP8X reserved flags are set");
  for (const Frame& f : frames) {
    if (!is_animation && f.frame_num > 1) fail("still image with two frames");
    if (!f.complete) fail("incomplete frame");
    if (f.alpha.size == 0 && f.image.size == 0) fail("frame has no image");
    if (f.alpha.size > 0 && f.alpha.offset > f.image.offset) {
      fail("ALPH chunk follows its image");
    }
    if (f.width <= 0 || f.height <= 0) fail("frame has no pixels");
    if (!frame_fits(f, !is_animation, canvas_width, canvas_height)) {
      fail("frame does not fit the canvas");
    }
  }
}

// WebPGetFeatures on the whole file: Pillow's mode is "RGBA" when it
// reports alpha or fails. In a VP8X file, data that ends early still
// yields the features read so far.
bool sniff_has_alpha(const uint8_t* data, size_t size) {
  if (size < 12) return true;
  const uint8_t* p = data;
  size_t n = size;
  uint32_t riff_size = 0;
  if (tag_is(p, "RIFF")) {
    if (!tag_is(p + 8, "WEBP")) return true;
    riff_size = le32(p + 4);
    if (riff_size < 12 || riff_size > kMaxChunkPayload) return true;
    p += 12;
    n -= 12;
  }
  if (n < 8) return true;
  bool has_alpha = false, vp8x = false;
  const uint8_t* alpha_data = nullptr;
  uint64_t cw = 0, ch = 0;
  if (tag_is(p, "VP8X")) {
    if (le32(p + 4) != 10 || n < 18) return true;
    const uint32_t flags = le32(p + 8);
    cw = 1 + le24(p + 12);
    ch = 1 + le24(p + 15);
    if (cw * ch >= kMaxImageArea) return true;
    has_alpha = flags & 0x10;
    vp8x = true;
    if (flags & 0x02) return has_alpha;  // animation: VP8X's flag alone
    p += 18;
    n -= 18;
  }
  auto not_enough = [&]() { return vp8x ? has_alpha || alpha_data : true; };
  if (n < 4) return not_enough();
  if (vp8x) {  // ParseOptionalChunks
    uint32_t total_size = 4 + 8 + 10;
    for (;;) {
      if (n < 8) return not_enough();
      const uint32_t chunk_size = le32(p + 4);
      if (chunk_size > kMaxChunkPayload) return true;
      const uint32_t disk = (8 + chunk_size + 1) & ~1u;
      total_size += disk;
      if (riff_size > 0 && total_size > riff_size) return true;
      if (tag_is(p, "VP8 ") || tag_is(p, "VP8L")) break;
      if (n < disk) return not_enough();
      if (tag_is(p, "ALPH")) alpha_data = p + 8;
      p += disk;
      n -= disk;
    }
  }
  if (n < 8) return not_enough();
  const bool is_vp8 = tag_is(p, "VP8 ");
  if (!is_vp8 && !tag_is(p, "VP8L")) return true;
  const uint32_t chunk = le32(p + 4);
  if (riff_size >= 12 && chunk > riff_size - 12) return true;
  p += 8;
  n -= 8;
  uint64_t w, h;
  if (is_vp8) {
    if (n < 10) return not_enough();
    if (!(p[3] == 0x9d && p[4] == 0x01 && p[5] == 0x2a)) return true;
    const uint32_t bits = le24(p);
    if ((bits & 1) || ((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) ||
        (bits >> 5) >= chunk) {
      return true;
    }
    w = le16(p + 6) & 0x3fff;
    h = le16(p + 8) & 0x3fff;
    if (w == 0 || h == 0) return true;
  } else {
    if (n < 5) return not_enough();
    if (p[0] != 0x2f || (p[4] >> 5) != 0) return true;
    const uint32_t bits = le32(p + 1);
    w = (bits & 0x3fff) + 1;
    h = ((bits >> 14) & 0x3fff) + 1;
    has_alpha = (bits >> 28) & 1;
  }
  if (vp8x && (w != cw || h != ch)) return true;
  return has_alpha || alpha_data;
}

// Decodes the first frame onto a zeroed canvas_w x canvas_h RGBA canvas.
void decode_first_frame(const Demux& dmx, uint8_t* canvas) {
  const Frame* f = nullptr;
  for (const Frame& fr : dmx.frames) {
    if (fr.frame_num == 1) {
      f = &fr;
      break;
    }
  }
  if (f == nullptr) fail("file holds no first frame");
  const size_t stride = static_cast<size_t>(dmx.canvas_width) * 4;
  memset(canvas, 0, stride * dmx.canvas_height);
  uint8_t* out = canvas + f->y_offset * stride + f->x_offset * 4;
  // The frame's payload: from its ALPH chunk (if any) to the end of its
  // image chunk, then WebPDecode's own parse of it.
  size_t start = f->image.offset, size = f->image.size;
  if (f->alpha.size > 0) {
    size += f->image.offset - f->alpha.offset;
    start = f->alpha.offset;
  }
  const uint8_t* p = dmx.data() + start;
  size_t n = size;
  const uint8_t* alpha_data = nullptr;
  size_t alpha_size = 0;
  if (tag_is(p, "ALPH")) {
    for (;;) {
      if (n < 8) fail("frame ends inside a chunk header");
      const uint32_t chunk_size = le32(p + 4);
      const uint32_t disk = (8 + chunk_size + 1) & ~1u;
      if (tag_is(p, "VP8 ") || tag_is(p, "VP8L")) break;
      if (n < disk) fail("frame ends inside a chunk");
      if (tag_is(p, "ALPH")) {
        alpha_data = p + 8;
        alpha_size = chunk_size;
      }
      p += disk;
      n -= disk;
    }
  }
  if (n < 8) fail("frame ends inside a chunk header");
  const uint32_t csize = le32(p + 4);
  if (csize > n - 8) fail("image chunk is truncated");
  const bool lossless = tag_is(p, "VP8L");
  p += 8;
  n -= 8;
  if (!lossless) {
    Vp8Decoder dec(p, n);
    dec.decode(out, stride, f->width, f->height);
    if (alpha_data != nullptr) {
      std::vector<uint8_t> alpha;
      decode_alph(alpha_data, alpha_size, f->width, f->height, alpha);
      for (int y = 0; y < f->height; ++y) {
        uint8_t* row = out + y * stride;
        for (int x = 0; x < f->width; ++x) {
          row[4 * x + 3] = alpha[static_cast<size_t>(y) * f->width + x];
        }
      }
    }
  } else {
    Vp8lDecoder dec(p, n);
    int w = 0, h = 0;
    std::vector<uint32_t> px = dec.decode_image(&w, &h);
    if (w != f->width || h != f->height) fail("VP8L size changed");
    for (int y = 0; y < h; ++y) {
      uint8_t* row = out + y * stride;
      for (int x = 0; x < w; ++x) {
        const uint32_t v = px[static_cast<size_t>(y) * w + x];
        row[4 * x + 0] = (v >> 16) & 0xff;
        row[4 * x + 1] = (v >> 8) & 0xff;
        row[4 * x + 2] = v & 0xff;
        row[4 * x + 3] = v >> 24;
      }
    }
  }
}

int report(const char* msg, char* err, size_t errlen) {
  if (errlen > 0) {
    snprintf(err, errlen, "%s", msg);
  }
  return 1;
}

}  // namespace

extern "C" {

int prismer_webp_info(const uint8_t* data, size_t n, int* info, char* err,
                      size_t errlen) {
  try {
    Demux dmx(data, n);
    if (static_cast<uint64_t>(dmx.canvas_width) * dmx.canvas_height >
        kMaxPixels) {
      fail("%dx%d canvas exceeds Pillow's decompression-bomb limit",
           dmx.canvas_width, dmx.canvas_height);
    }
    info[0] = dmx.canvas_height;
    info[1] = dmx.canvas_width;
    info[2] = sniff_has_alpha(data, n) ? 1 : 0;
    return 0;
  } catch (const WebpError& e) {
    return report(e.what(), err, errlen);
  } catch (const std::exception& e) {
    report(e.what(), err, errlen);
    return 2;
  }
}

int prismer_webp_decode(const uint8_t* data, size_t n, uint8_t* out,
                        size_t out_size, char* err, size_t errlen) {
  try {
    Demux dmx(data, n);
    const size_t canvas = static_cast<size_t>(dmx.canvas_width) *
                          dmx.canvas_height * 4;
    if (out_size != canvas) {
      fail("output buffer does not match the canvas");
    }
    decode_first_frame(dmx, out);
    return 0;
  } catch (const WebpError& e) {
    return report(e.what(), err, errlen);
  } catch (const std::exception& e) {
    report(e.what(), err, errlen);
    return 2;
  }
}

}  // extern "C"
