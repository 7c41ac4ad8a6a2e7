// GIF reader whose output equals what Pillow 12 reads for the first frame
// of a GIF file with `ImageFile.LOAD_TRUNCATED_IMAGES = True`: the frame's
// palette indices in Pillow's mode ("P", or "L" where the file has no
// palette or its palette is the identity grey ramp) and the palette that
// `convert("RGB")` maps them through.
//
// What is replicated, and where it lives in Pillow:
//   * GifImagePlugin._open / _seek(0): GIF87a and GIF89a, the global and
//     local colour tables, extension blocks (a graphic control extension's
//     transparency index), bytes between blocks skipped one at a time, a
//     first frame smaller than the screen or offset into it, and a frame
//     that reaches past the screen, which widens the image;
//   * GifImagePlugin.load_prepare: outside the frame, and wherever the data
//     ends before the frame is full, the image holds the transparency index
//     if the frame has one, else 0 (not the background colour);
//   * GifDecode.c: LZW with minimum code sizes 0-12, clear and end codes
//     anywhere, the "deferred clear" of a full 4096-entry table, the code
//     one past the table ("KwKwK"), interlaced rows; a code past the table
//     stops the decoder with the pixels it has written;
//   * ImageFile.load: the data is handed to the decoder in 64 KiB reads, the
//     decoder consumes only whole sub-blocks, and at the end of the file
//     the rest is dropped. A frame whose end code comes early is read on
//     from the next 64 KiB read, as Pillow reads it.
//
// Refused, with 1 and a message naming the feature, where Pillow raises: no
// image in the file, a header or image descriptor cut short, a frame of
// zero width or height (other than Pillow's 0-wide frame at x 0, which it
// widens to the image), more pixels than Pillow's decompression-bomb limit.
//
// C interface (loaded with ctypes, see __init__.py):
//   int prismer_gif_info(data, n, int info[4], err, errlen)
//       info = {height, width, 1 for mode "P" (0 for "L"), palette bytes}
//   int prismer_gif_decode(data, n, out, out_size, palette, palette_size,
//                          err, errlen)
//       out = height x width palette indices; palette = the colour table
//       bytes (R, G, B) that Pillow's palette holds
// Each returns 0 on success, 1 for a file it refuses, 2 for an internal
// failure (out of memory); `err` then holds the reason.

#include <algorithm>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <memory>
#include <string>
#include <vector>

namespace {

class GifError : public std::exception {
 public:
  explicit GifError(std::string m) : msg_(std::move(m)) {}
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
  throw GifError(std::string("GIF: ") + buf);
}

constexpr uint64_t kMaxPixels = 178956970;  // Image.MAX_IMAGE_PIXELS * 2
constexpr size_t kReadSize = 65536;         // ImageFile.decodermaxblock

inline int le16(const uint8_t* p) { return p[0] | (p[1] << 8); }

// GifImagePlugin's _is_palette_needed: false for the identity grey ramp.
bool palette_needed(const std::vector<uint8_t>& p) {
  // Python's chained comparison stops at the first inequality; an entry
  // cut short raises only where it is reached.
  for (size_t i = 0; i < p.size(); i += 3) {
    if (i / 3 != p[i]) return true;
    if (i + 1 >= p.size()) fail("colour table is cut short");
    if (p[i] != p[i + 1]) return true;
    if (i + 2 >= p.size()) fail("colour table is cut short");
    if (p[i + 1] != p[i + 2]) return true;
  }
  return false;
}

struct Header {
  int width = 0, height = 0;
  int x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  int transparency = -1;
  bool interlace = false;
  int bits = 0;                 // LZW minimum code size
  size_t data_offset = 0;
  bool has_palette = false;     // mode "P"
  std::vector<uint8_t> palette;
};

class Reader {
 public:
  Reader(const uint8_t* d, size_t n) : d_(d), n_(n) {}
  // Python's fp.read(k): up to k bytes.
  size_t read(size_t k, const uint8_t** out) {
    const size_t got = std::min(k, n_ - pos_);
    *out = d_ + pos_;
    pos_ += got;
    return got;
  }
  // GifImagePlugin.data(): -1 for no block (a zero length or the end of
  // the file), else the bytes read into `out` (fewer at the end).
  int block(std::vector<uint8_t>* out) {
    const uint8_t* p;
    if (read(1, &p) == 0 || p[0] == 0) return -1;
    const size_t got = read(p[0], &p);
    out->assign(p, p + got);
    return static_cast<int>(got);
  }
  size_t tell() const { return pos_; }

 private:
  const uint8_t* d_;
  size_t n_, pos_ = 0;
};

Header parse(const uint8_t* data, size_t n) {
  if (n < 13 || !(memcmp(data, "GIF87a", 6) == 0 ||
                  memcmp(data, "GIF89a", 6) == 0)) {
    fail("not a GIF87a or GIF89a file");
  }
  Header h;
  h.width = le16(data + 6);
  h.height = le16(data + 8);
  const int flags = data[10];
  Reader r(data, n);
  const uint8_t* p;
  r.read(13, &p);
  std::vector<uint8_t> global;
  bool have_global = false;
  if (flags & 128) {
    const size_t got = r.read(3u << ((flags & 7) + 1), &p);
    std::vector<uint8_t> pal(p, p + got);
    if (palette_needed(pal)) {
      global = pal;
      have_global = true;
    }
  }
  if (r.read(1, &p) == 0 || p[0] == ';') fail("file holds no image");
  int s = p[0];
  int local = -1;  // -1: no local table, 0: not needed, 1: needed
  std::vector<uint8_t> local_pal;
  bool found = false;
  for (;;) {
    if (s < 0) {
      if (r.read(1, &p) == 0) break;
      s = p[0];
    }
    if (s == ';') break;
    if (s == '!') {
      if (r.read(1, &p) == 0) fail("extension block is cut short");
      const int label = p[0];
      std::vector<uint8_t> blk;
      const bool has_block = r.block(&blk) >= 0;
      if (label == 249 && has_block) {
        if (blk.size() < 3) fail("graphic control extension is cut short");
        if (blk[0] & 1) {
          if (blk.size() < 4) fail("graphic control extension is cut short");
          h.transparency = blk[3];
        }
      } else if (label == 254) {
        bool more = has_block && !blk.empty();
        while (more) more = r.block(&blk) > 0;
        s = -1;
        continue;
      } else if (label == 255 && has_block) {
        if (blk.size() >= 11 && memcmp(blk.data(), "NETSCAPE2.0", 11) == 0) {
          r.block(&blk);
        }
      }
      while (r.block(&blk) > 0) {
      }
    } else if (s == ',') {
      if (r.read(9, &p) < 9) fail("image descriptor is cut short");
      h.x0 = le16(p);
      h.y0 = le16(p + 2);
      h.x1 = h.x0 + le16(p + 4);
      h.y1 = h.y0 + le16(p + 6);
      const int fl = p[8];
      h.interlace = (fl & 64) != 0;
      if (fl & 128) {
        const size_t got = r.read(3u << ((fl & 7) + 1), &p);
        local_pal.assign(p, p + got);
        local = palette_needed(local_pal) ? 1 : 0;
      }
      if (r.read(1, &p) == 0) fail("LZW code size is missing");
      h.bits = p[0];
      h.data_offset = r.tell();
      found = true;
      break;
    }
    s = -1;
  }
  if (!found) fail("file holds no image");
  h.width = std::max(h.width, h.x1);
  h.height = std::max(h.height, h.y1);
  if (local == 1) {
    h.has_palette = true;
    h.palette = local_pal;
  } else if (local == -1 && have_global) {
    h.has_palette = true;
    h.palette = global;
  }
  if (static_cast<uint64_t>(h.width) * h.height > kMaxPixels) {
    fail("%dx%d exceeds Pillow's decompression-bomb limit", h.width, h.height);
  }
  // ImageFile's setimage: a tile (0, y0, 0, y1) is the whole image.
  if (h.x0 == 0 && h.x1 == 0) {
    h.x1 = h.width;
    h.y0 = 0;
    h.y1 = h.height;
  }
  if (h.x1 - h.x0 <= 0 || h.y1 - h.y0 <= 0) fail("frame has no pixels");
  return h;
}

// GifDecode.c's ImagingGifDecode, state kept across calls.
class LzwDecoder {
 public:
  LzwDecoder(const Header& h, uint8_t* image)
      : image_(image), width_(h.width), xoff_(h.x0), yoff_(h.y0),
        xsize_(h.x1 - h.x0), ysize_(h.y1 - h.y0), bits_(h.bits),
        interlace_(h.interlace) {}

  // Returns the bytes consumed, or -1 when the decoder is done.
  long decode(const uint8_t* buffer, size_t bytes) {
    const uint8_t* ptr = buffer;
    if (state_ == 0) {
      if (bits_ < 0 || bits_ > 12) return -1;
      clear_ = 1 << bits_;
      end_ = clear_ + 1;
      if (interlace_) {
        interlace_ = 1;
        step_ = 8;
      } else {
        step_ = 1;
      }
      state_ = 1;
    }
    for (;;) {
      const uint8_t* p;
      int i;
      if (state_ == 1) {
        next_ = clear_ + 2;
        codesize_ = bits_ + 1;
        codemask_ = (1 << codesize_) - 1;
        bufferindex_ = kBuffer;
        state_ = 2;
      }
      if (bufferindex_ < kBuffer) {
        i = kBuffer - bufferindex_;
        p = &buffer_[bufferindex_];
        bufferindex_ = kBuffer;
      } else {
        while (bitcount_ < codesize_) {
          if (blocksize_ > 0) {
            const int c = *ptr++;
            bytes--;
            blocksize_--;
            bitbuffer_ |= static_cast<uint32_t>(c) << bitcount_;
            bitcount_ += 8;
          } else {
            // A new sub-block: only whole blocks are decoded.
            if (bytes < 1) return ptr - buffer;
            const int c = *ptr;
            if (bytes < static_cast<size_t>(c) + 1) return ptr - buffer;
            blocksize_ = c;
            ptr++;
            bytes--;
          }
        }
        int c = static_cast<int>(bitbuffer_ & codemask_);
        bitbuffer_ >>= codesize_;
        bitcount_ -= codesize_;
        if (c == clear_) {
          if (state_ != 2) state_ = 1;
          continue;
        }
        if (c == end_) break;
        i = 1;
        p = &lastdata_;
        if (state_ == 2) {
          if (c > clear_) return -1;  // broken: first code is not a literal
          lastdata_ = lastcode_ = c;
          state_ = 3;
        } else {
          const int thiscode = c;
          if (c > next_) return -1;
          if (c == next_) {
            if (bufferindex_ <= 0) return -1;
            buffer_[--bufferindex_] = lastdata_;
            c = lastcode_;
          }
          while (c >= clear_) {
            if (bufferindex_ <= 0 || c >= kTable) return -1;
            buffer_[--bufferindex_] = data_[c];
            c = link_[c];
          }
          lastdata_ = c;
          if (next_ < kTable) {
            data_[next_] = c;
            link_[next_] = lastcode_;
            if (next_ == codemask_ && codesize_ < 12) {
              codesize_++;
              codemask_ = (1 << codesize_) - 1;
            }
            next_++;
          }
          lastcode_ = thiscode;
        }
      }
      if (y_ >= ysize_) return -1;  // overrun
      for (int k = 0; k < i; ++k) {
        image_[static_cast<size_t>(y_ + yoff_) * width_ + xoff_ + x_] = p[k];
        if (++x_ >= xsize_) {
          if (!newline()) return -1;
          if (y_ >= ysize_) return -1;
        }
      }
    }
    return ptr - buffer;
  }

 private:
  static constexpr int kBuffer = 4096, kTable = 4096;
  // GifDecode.c's NEWLINE; false where it returns -1.
  bool newline() {
    x_ = 0;
    y_ += step_;
    while (y_ >= ysize_) {
      switch (interlace_) {
        case 1:
          y_ = 4;
          interlace_ = 2;
          break;
        case 2:
          step_ = 4;
          y_ = 2;
          interlace_ = 3;
          break;
        case 3:
          step_ = 2;
          y_ = 1;
          interlace_ = 0;
          break;
        default:
          return false;
      }
    }
    return true;
  }

  uint8_t* image_;
  int width_, xoff_, yoff_, xsize_, ysize_, bits_;
  int interlace_;
  int state_ = 0, step_ = 1, x_ = 0, y_ = 0;
  int clear_ = 0, end_ = 0, next_ = 0, codesize_ = 0, codemask_ = 0;
  int blocksize_ = 0, bitcount_ = 0;
  uint32_t bitbuffer_ = 0;
  int bufferindex_ = kBuffer;
  uint8_t lastdata_ = 0;
  int lastcode_ = 0;
  uint8_t buffer_[kBuffer] = {0};
  uint8_t data_[kTable] = {0};
  uint16_t link_[kTable] = {0};
};

// ImageFile.load's loop over 64 KiB reads.
void decode_frame(const uint8_t* data, size_t n, const Header& h,
                  uint8_t* image) {
  std::vector<uint8_t> b;
  size_t pos = h.data_offset;
  auto dec = std::make_unique<LzwDecoder>(h, image);
  for (;;) {
    const size_t take = std::min(kReadSize, n - std::min(pos, n));
    if (take == 0) break;
    b.insert(b.end(), data + pos, data + pos + take);
    pos += take;
    const long used = dec->decode(b.data(), b.size());
    if (used < 0) break;
    b.erase(b.begin(), b.begin() + used);
  }
}

int report(const char* msg, char* err, size_t errlen) {
  if (errlen > 0) snprintf(err, errlen, "%s", msg);
  return 1;
}

}  // namespace

extern "C" {

int prismer_gif_info(const uint8_t* data, size_t n, int* info, char* err,
                     size_t errlen) {
  try {
    const Header h = parse(data, n);
    info[0] = h.height;
    info[1] = h.width;
    info[2] = h.has_palette ? 1 : 0;
    info[3] = static_cast<int>(h.palette.size());
    return 0;
  } catch (const GifError& e) {
    return report(e.what(), err, errlen);
  } catch (const std::exception& e) {
    report(e.what(), err, errlen);
    return 2;
  }
}

int prismer_gif_decode(const uint8_t* data, size_t n, uint8_t* out,
                       size_t out_size, uint8_t* palette, size_t palette_size,
                       char* err, size_t errlen) {
  try {
    const Header h = parse(data, n);
    if (out_size != static_cast<size_t>(h.width) * h.height ||
        palette_size != h.palette.size()) {
      fail("output buffers do not match the image");
    }
    memset(out, h.transparency >= 0 ? h.transparency : 0, out_size);
    if (!h.palette.empty()) {
      memcpy(palette, h.palette.data(), h.palette.size());
    }
    decode_frame(data, n, h, out);
    return 0;
  } catch (const GifError& e) {
    return report(e.what(), err, errlen);
  } catch (const std::exception& e) {
    report(e.what(), err, errlen);
    return 2;
  }
}

}  // extern "C"
