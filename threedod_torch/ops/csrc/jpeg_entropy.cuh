// Host half of the card's JPEG decoder: the markers of a baseline sequential
// JPEG (8-bit samples, Huffman coding, restart markers, one interleaved scan
// or one scan a component) and its Huffman-coded data, decoded to each
// component's quantized DCT coefficients in natural (not zig-zag) order, with
// the quantization table each component uses. Everything after this step
// (dequantization, libjpeg's islow IDCT, upsampling, colour) runs on the card
// (jpeg_decode.cu).
//
// Plain C++ with no library: it is compiled by nvcc as host code. The
// decoding follows libjpeg's jdmarker.c and jdhuff.c (decode_mcu_slow):
// the DC difference is added to the component's last DC value, reset at every
// restart marker; an AC run of zeros is skipped, EOB ends the block. A file
// libjpeg would decode with a warning (a truncated stream, a missing restart
// marker) and any file outside the baseline subset (progressive, arithmetic,
// lossless, 12-bit, more than 3 components or other sampling factors than
// 1 and 2) is refused with a message; nothing is guessed.
#pragma once

#include <stdint.h>

namespace jpeg {

constexpr int MAX_COMPONENTS = 3;

struct Component {
  int id = 0;
  int h = 1, v = 1;         // sampling factors
  int tq = 0;               // quantization table
  int td = 0, ta = 0;       // DC and AC Huffman tables of the current scan
  int blocks_w = 0, blocks_h = 0;  // stored block grid: the MCU-padded area
  int width = 0, height = 0;       // the component's own samples: ceil(W h / hmax), ceil(H v / vmax)
  int64_t offset = 0;       // first coefficient of the component in the output
  int last_dc = 0;
};

struct Huffman {
  bool defined = false;
  uint8_t values[256] = {0};
  int maxcode[18] = {0};
  int valptr[17] = {0};
  int mincode[17] = {0};
};

struct Image {
  int width = 0, height = 0, components = 0;
  int hmax = 1, vmax = 1, mcus_w = 0, mcus_h = 0;
  int restart_interval = 0;
  Component comp[MAX_COMPONENTS];
  uint16_t quant[4][64] = {{0}};
  bool quant_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int64_t coefficients = 0;  // total coefficients over all components
};

// jpeg_natural_order: zig-zag index -> natural (row-major) index
constexpr int NATURAL_ORDER[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

class Reader {
 public:
  Reader(const uint8_t* data, int64_t length) : data_(data), length_(length) {}

  const char* error = nullptr;

  bool fail(const char* message) {
    if (error == nullptr) error = message;
    return false;
  }
  int64_t position() const { return pos_; }
  void seek(int64_t pos) { pos_ = pos; }
  bool byte(int* out) {
    if (pos_ >= length_) return fail("the file ends inside a marker segment");
    *out = data_[pos_++];
    return true;
  }
  bool word(int* out) {
    int hi = 0, lo = 0;
    if (!byte(&hi) || !byte(&lo)) return false;
    *out = (hi << 8) | lo;
    return true;
  }

  // entropy-coded data: bits with 0xFF00 stuffing; a marker ends the data
  void start_bits() {
    bits_ = 0;
    nbits_ = 0;
    hit_marker_ = false;
  }
  bool bit(int* out) {
    if (nbits_ == 0) {
      int b = 0;
      if (hit_marker_ || pos_ >= length_) return fail("the entropy-coded data ends early");
      b = data_[pos_];
      if (b == 0xFF) {
        if (pos_ + 1 >= length_) return fail("the entropy-coded data ends early");
        int next = data_[pos_ + 1];
        if (next != 0x00) {
          hit_marker_ = true;
          return fail("the entropy-coded data ends early (a marker inside a scan)");
        }
        pos_ += 2;
      } else {
        pos_ += 1;
      }
      bits_ = b;
      nbits_ = 8;
    }
    --nbits_;
    *out = (bits_ >> nbits_) & 1;
    return true;
  }
  bool bits(int n, int* out) {
    int v = 0;
    for (int i = 0; i < n; ++i) {
      int b = 0;
      if (!bit(&b)) return false;
      v = (v << 1) | b;
    }
    *out = v;
    return true;
  }
  // drop the bits left in the current byte, then expect the marker RSTn
  bool restart(int expected) {
    nbits_ = 0;
    if (pos_ + 1 >= length_ || data_[pos_] != 0xFF) return fail("a restart marker is missing");
    int64_t p = pos_ + 1;
    while (p < length_ && data_[p] == 0xFF) ++p;  // fill bytes
    if (p >= length_ || data_[p] != 0xD0 + expected) return fail("a restart marker is missing or out of order");
    pos_ = p + 1;
    hit_marker_ = false;
    return true;
  }
  // after a scan: skip to the next marker
  void end_scan() {
    nbits_ = 0;
    while (pos_ + 1 < length_ && !(data_[pos_] == 0xFF && data_[pos_ + 1] != 0x00 &&
                                   !(data_[pos_ + 1] >= 0xD0 && data_[pos_ + 1] <= 0xD7))) {
      ++pos_;
    }
  }

 private:
  const uint8_t* data_;
  int64_t length_;
  int64_t pos_ = 0;
  int bits_ = 0, nbits_ = 0;
  bool hit_marker_ = false;
};

inline bool read_dqt(Reader& r, Image& im, int length) {
  int left = length - 2;
  while (left > 0) {
    int pq_tq = 0;
    if (!r.byte(&pq_tq)) return false;
    int pq = pq_tq >> 4, tq = pq_tq & 15;
    if (tq > 3) return r.fail("a quantization table number above 3");
    if (pq > 1) return r.fail("a quantization table of unknown precision");
    for (int k = 0; k < 64; ++k) {
      int q = 0;
      if (pq ? !r.word(&q) : !r.byte(&q)) return false;
      im.quant[tq][NATURAL_ORDER[k]] = static_cast<uint16_t>(q);
    }
    im.quant_defined[tq] = true;
    left -= 1 + 64 * (pq + 1);
  }
  return left == 0 ? true : r.fail("a DQT segment of the wrong length");
}

inline bool read_dht(Reader& r, Image& im, int length) {
  int left = length - 2;
  while (left > 0) {
    int tc_th = 0;
    if (!r.byte(&tc_th)) return false;
    int tc = tc_th >> 4, th = tc_th & 15;
    if (tc > 1 || th > 3) return r.fail("a Huffman table of unknown class or number");
    Huffman& t = tc ? im.ac[th] : im.dc[th];
    int counts[17] = {0};
    int total = 0;
    for (int l = 1; l <= 16; ++l) {
      if (!r.byte(&counts[l])) return false;
      total += counts[l];
    }
    if (total > 256) return r.fail("a Huffman table with more than 256 codes");
    for (int i = 0; i < total; ++i) {
      int v = 0;
      if (!r.byte(&v)) return false;
      t.values[i] = static_cast<uint8_t>(v);
    }
    // canonical codes (jdhuff.c jpeg_make_d_derived_tbl)
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      t.valptr[l] = k;
      t.mincode[l] = code;
      code += counts[l];
      k += counts[l];
      t.maxcode[l] = counts[l] ? code - 1 : -1;
      code <<= 1;
    }
    t.maxcode[17] = 0x7FFFFFFF;
    t.defined = true;
    left -= 17 + total;
  }
  return left == 0 ? true : r.fail("a DHT segment of the wrong length");
}

inline bool read_sof(Reader& r, Image& im, int length) {
  int precision = 0, n = 0;
  if (!r.byte(&precision) || !r.word(&im.height) || !r.word(&im.width) || !r.byte(&n)) return false;
  if (precision != 8) return r.fail("not 8-bit samples");
  if (im.width <= 0 || im.height <= 0) return r.fail("an image without a width or a height in its header");
  if (n != 1 && n != 3) return r.fail("not 1 or 3 components");
  if (length != 8 + 3 * n) return r.fail("an SOF segment of the wrong length");
  im.components = n;
  for (int c = 0; c < n; ++c) {
    int hv = 0;
    Component& cp = im.comp[c];
    if (!r.byte(&cp.id) || !r.byte(&hv) || !r.byte(&cp.tq)) return false;
    cp.h = hv >> 4;
    cp.v = hv & 15;
    if (cp.h < 1 || cp.h > 2 || cp.v < 1 || cp.v > 2) return r.fail("sampling factors other than 1 and 2");
    if (cp.tq > 3) return r.fail("a quantization table number above 3");
    im.hmax = cp.h > im.hmax ? cp.h : im.hmax;
    im.vmax = cp.v > im.vmax ? cp.v : im.vmax;
  }
  im.mcus_w = (im.width + 8 * im.hmax - 1) / (8 * im.hmax);
  im.mcus_h = (im.height + 8 * im.vmax - 1) / (8 * im.vmax);
  int64_t offset = 0;
  for (int c = 0; c < n; ++c) {
    Component& cp = im.comp[c];
    cp.blocks_w = im.mcus_w * cp.h;
    cp.blocks_h = im.mcus_h * cp.v;
    cp.width = (im.width * cp.h + im.hmax - 1) / im.hmax;
    cp.height = (im.height * cp.v + im.vmax - 1) / im.vmax;
    cp.offset = offset;
    offset += static_cast<int64_t>(cp.blocks_w) * cp.blocks_h * 64;
  }
  im.coefficients = offset;
  return true;
}

inline bool decode_huffman(Reader& r, const Huffman& t, int* out) {
  int code = 0;
  for (int l = 1; l <= 16; ++l) {
    int b = 0;
    if (!r.bit(&b)) return false;
    code = (code << 1) | b;
    if (code <= t.maxcode[l]) {
      *out = t.values[t.valptr[l] + code - t.mincode[l]];
      return true;
    }
  }
  return r.fail("a Huffman code that is not in its table");
}

// HUFF_EXTEND: the s-bit value v as a signed coefficient
inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

inline bool decode_block(Reader& r, const Image& im, Component& cp, int16_t* block) {
  int s = 0, v = 0;
  if (!decode_huffman(r, im.dc[cp.td], &s)) return false;
  if (s > 11) return r.fail("a DC difference of more than 11 bits");
  int diff = 0;
  if (s) {
    if (!r.bits(s, &v)) return false;
    diff = extend(v, s);
  }
  cp.last_dc = static_cast<int>(static_cast<unsigned>(cp.last_dc) + static_cast<unsigned>(diff));
  block[0] = static_cast<int16_t>(cp.last_dc);
  for (int k = 1; k < 64; ++k) {
    int rs = 0;
    if (!decode_huffman(r, im.ac[cp.ta], &rs)) return false;
    int run = rs >> 4, size = rs & 15;
    if (size == 0) {
      if (run != 15) break;  // EOB
      k += 15;               // ZRL: sixteen zeros
      continue;
    }
    k += run;
    if (k > 63) return r.fail("an AC run past the end of a block");
    if (!r.bits(size, &v)) return false;
    block[NATURAL_ORDER[k]] = static_cast<int16_t>(extend(v, size));
  }
  return true;
}

// One scan: Ns components, interleaved in MCUs when Ns > 1; one component's
// blocks in raster order over its own ceil(width / 8) x ceil(height / 8)
// blocks when Ns == 1. `coef` is null on the first pass (sizes only).
inline bool read_scan(Reader& r, Image& im, int length, int16_t* coef) {
  int ns = 0;
  if (!r.byte(&ns)) return false;
  if (ns < 1 || ns > im.components || length != 6 + 2 * ns) return r.fail("an SOS segment of the wrong shape");
  int order[MAX_COMPONENTS] = {0, 0, 0};
  for (int i = 0; i < ns; ++i) {
    int id = 0, t = 0;
    if (!r.byte(&id) || !r.byte(&t)) return false;
    int c = -1;
    for (int j = 0; j < im.components; ++j)
      if (im.comp[j].id == id) c = j;
    if (c < 0) return r.fail("a scan names a component the frame does not have");
    im.comp[c].td = t >> 4;
    im.comp[c].ta = t & 15;
    if (im.comp[c].td > 3 || im.comp[c].ta > 3 || !im.dc[im.comp[c].td].defined || !im.ac[im.comp[c].ta].defined)
      return r.fail("a scan uses a Huffman table that is not defined");
    if (!im.quant_defined[im.comp[c].tq]) return r.fail("a component's quantization table is not defined");
    order[i] = c;
  }
  int ss = 0, se = 0, ahal = 0;
  if (!r.byte(&ss) || !r.byte(&se) || !r.byte(&ahal)) return false;
  if (ss != 0 || se != 63 || ahal != 0) return r.fail("a spectral selection of a progressive file");
  for (int i = 0; i < ns; ++i) im.comp[order[i]].last_dc = 0;
  if (coef == nullptr) {  // sizes only: skip the data
    r.end_scan();
    return true;
  }
  r.start_bits();
  int units_w = 0, units_h = 0;
  if (ns == 1) {
    const Component& cp = im.comp[order[0]];
    units_w = (cp.width + 7) / 8;
    units_h = (cp.height + 7) / 8;
  } else {
    units_w = im.mcus_w;
    units_h = im.mcus_h;
  }
  int64_t units = static_cast<int64_t>(units_w) * units_h;
  int to_go = im.restart_interval, next_rst = 0;
  for (int64_t u = 0; u < units; ++u) {
    if (im.restart_interval && to_go == 0) {
      if (!r.restart(next_rst)) return false;
      next_rst = (next_rst + 1) & 7;
      to_go = im.restart_interval;
      for (int i = 0; i < ns; ++i) im.comp[order[i]].last_dc = 0;
    }
    int ux = static_cast<int>(u % units_w), uy = static_cast<int>(u / units_w);
    for (int i = 0; i < ns; ++i) {
      Component& cp = im.comp[order[i]];
      int bw = ns == 1 ? 1 : cp.h, bh = ns == 1 ? 1 : cp.v;
      for (int by = 0; by < bh; ++by) {
        for (int bx = 0; bx < bw; ++bx) {
          int64_t row = static_cast<int64_t>(uy) * bh + by, col = static_cast<int64_t>(ux) * bw + bx;
          int16_t* block = coef + cp.offset + (row * cp.blocks_w + col) * 64;
          if (!decode_block(r, im, cp, block)) return false;
        }
      }
    }
    --to_go;
  }
  r.end_scan();
  return true;
}

// Parses the whole file. With `coef` null, reads the header only (sizes, and
// checks every segment up to the first scan); otherwise decodes every scan
// into `coef`, which holds `capacity` zeros on entry and must hold exactly
// im.coefficients (checked at the first scan, before anything is written).
inline const char* parse(const uint8_t* data, int64_t length, Image& im, int16_t* coef, int64_t capacity = 0) {
  Reader r(data, length);
  int a = 0, b = 0;
  if (!r.byte(&a) || !r.byte(&b) || a != 0xFF || b != 0xD8) return "not a JPEG file (no SOI marker)";
  bool frame = false, scanned = false;
  while (true) {
    int m = 0;
    if (!r.byte(&m)) return scanned ? "no EOI marker" : r.error;
    if (m != 0xFF) return "bytes between markers";
    while (m == 0xFF)
      if (!r.byte(&m)) return r.error;
    if (m == 0xD9) break;  // EOI
    if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
    int len = 0;
    if (!r.word(&len) || len < 2) return r.error ? r.error : "a marker segment shorter than its length field";
    int64_t end = r.position() + len - 2;
    bool ok = true;
    if (m == 0xC0 || m == 0xC1) {
      if (frame) return "two frames in one file";
      ok = read_sof(r, im, len);
      frame = true;
    } else if ((m >= 0xC2 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC)) {
      return m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE ? "a progressive JPEG (only baseline files are decoded)"
             : m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF ? "a lossless JPEG (only baseline files are decoded)"
                                                                 : "an arithmetic-coded JPEG (only baseline files "
                                                                   "are decoded)";
    } else if (m == 0xCC) {
      return "an arithmetic-coded JPEG (only baseline files are decoded)";
    } else if (m == 0xC4) {
      ok = read_dht(r, im, len);
    } else if (m == 0xDB) {
      ok = read_dqt(r, im, len);
    } else if (m == 0xDD) {
      ok = len == 4 && r.word(&im.restart_interval);
      if (!ok && !r.error) return "a DRI segment of the wrong length";
    } else if (m == 0xDA) {
      if (!frame) return "a scan before the frame header";
      if (coef == nullptr) {
        r.seek(r.position());
        ok = read_scan(r, im, len, nullptr);
        return ok ? nullptr : r.error;  // the header is known; the data is read on the second pass
      }
      if (im.coefficients != capacity) return "the coefficient buffer does not fit the header";
      ok = read_scan(r, im, len, coef);
      scanned = true;
      if (!ok) return r.error;
      continue;  // read_scan left the reader at the next marker
    }
    if (!ok) return r.error;
    r.seek(end);  // APPn, COM and the rest of a segment read above
    if (r.position() > length) return "a marker segment runs past the end of the file";
  }
  if (!frame) return "no frame header";
  if (coef != nullptr && !scanned) return "no scan";
  return nullptr;
}

}  // namespace jpeg
