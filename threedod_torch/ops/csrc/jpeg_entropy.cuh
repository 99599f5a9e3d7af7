// Host half of the card's JPEG decoder: the markers of a sequential (SOF0,
// SOF1) or progressive (SOF2) Huffman-coded JPEG with 8-bit samples (1, 3 or
// 4 components, sampling factors 1 to 4; restart markers; interleaved scans
// or one component a scan) and its Huffman-coded data, decoded to each
// component's quantized DCT coefficients in natural (not zig-zag) order, with
// the quantization table each component uses, and the colour space libjpeg
// reads the components in (jdapimin.c default_decompress_parms, from the
// JFIF APP0 and Adobe APP14 markers before the first scan and the component
// IDs: see color_space).
// Everything after this step (dequantization, libjpeg's islow IDCT,
// upsampling, colour) runs on the card (jpeg_decode.cu).
//
// Plain C++ with no library: it is compiled by nvcc as host code (and by a
// host compiler in the tests). The decoding follows libjpeg's jdmarker.c,
// jdhuff.c (decode_mcu_slow) and jdphuff.c:
//   * sequential: the DC difference is added to the component's last DC
//     value, reset at every restart marker; an AC run of zeros is skipped,
//     EOB ends the block;
//   * progressive: a DC first scan stores the DC value shifted left by Al; a
//     DC refinement scan ORs one bit into it; an AC first scan stores its
//     band's values shifted by Al, with end-of-band runs over blocks; an AC
//     refinement scan appends a correction bit to every already-nonzero
//     coefficient it passes and places newly nonzero ones of magnitude
//     1 << Al. Restart markers reset the DC predictions and the end-of-band
//     run. A scan of one component covers the component's own block grid,
//     ceil(width_c / 8) x ceil(height_c / 8), not the MCU-padded one.
// libjpeg smooths the blocks of a progressive file (jdcoefct.c
// decompress_smooth_data) only where, at the end of the file, some bits of
// the first 9 AC coefficients are still unknown (coef_bits not 0); every
// complete progression sends them all. Such a file is refused, as is a file
// libjpeg would decode with a warning (a truncated stream, a missing restart
// marker, a scan out of progression order) and any file outside this subset
// (arithmetic coding, lossless, 12-bit samples, 2 or more than 4 components,
// sampling factors outside 1 to 4, a fractional sampling ratio, an MCU of
// more than 10 blocks), each with a message; nothing is guessed.
#pragma once

#include <stdint.h>

namespace jpeg {

constexpr int MAX_COMPONENTS = 4;
constexpr int MAX_SAMP_FACTOR = 4;     // jpeglib.h
constexpr int MAX_BLOCKS_IN_MCU = 10;  // jpeglib.h D_MAX_BLOCKS_IN_MCU

// libjpeg's J_COLOR_SPACE values for the colour spaces a file's samples are in
enum ColorSpace { GRAYSCALE = 1, RGB = 2, YCBCR = 3, CMYK = 4, YCCK = 5 };

struct Component {
  int id = 0;
  int h = 1, v = 1;         // sampling factors
  int tq = 0;               // quantization table
  int td = 0, ta = 0;       // DC and AC Huffman tables of the current scan
  int blocks_w = 0, blocks_h = 0;  // stored block grid: the MCU-padded area
  int width = 0, height = 0;       // the component's own samples: ceil(W h / hmax), ceil(H v / vmax)
  int64_t offset = 0;       // first coefficient of the component in the output
  int last_dc = 0;
  bool latched = false;     // its quantization table, copied at its first scan (jdinput.c latch_quant_tables)
  uint16_t quant[64] = {0};
  int coef_bits[64];        // progressive: the lowest bit known of each zig-zag coefficient, -1 none yet
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
  bool progressive = false;
  bool saw_jfif = false, saw_adobe = false;  // jdmarker.c saw_JFIF_marker, saw_Adobe_marker
  int adobe_transform = 0;
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
  if (n == 2) return r.fail("2 components (Pillow cannot handle 2-layer images)");
  if (n != 1 && n != 3 && n != 4) return r.fail("not 1, 3 or 4 components");
  if (length != 8 + 3 * n) return r.fail("an SOF segment of the wrong length");
  im.components = n;
  for (int c = 0; c < n; ++c) {
    int hv = 0;
    Component& cp = im.comp[c];
    if (!r.byte(&cp.id) || !r.byte(&hv) || !r.byte(&cp.tq)) return false;
    cp.h = hv >> 4;
    cp.v = hv & 15;
    for (int k = 0; k < 64; ++k) cp.coef_bits[k] = -1;
    if (cp.h < 1 || cp.h > MAX_SAMP_FACTOR || cp.v < 1 || cp.v > MAX_SAMP_FACTOR)
      return r.fail("sampling factors outside 1 to 4 (jdinput.c JERR_BAD_SAMPLING)");
    if (cp.tq > 3) return r.fail("a quantization table number above 3");
    im.hmax = cp.h > im.hmax ? cp.h : im.hmax;
    im.vmax = cp.v > im.vmax ? cp.v : im.vmax;
  }
  for (int c = 0; c < n; ++c)
    if (im.hmax % im.comp[c].h || im.vmax % im.comp[c].v)
      return r.fail("a fractional sampling ratio: a component's factors do not divide the largest ones (jdsample.c "
                    "JERR_FRACT_SAMPLE_NOTIMPL)");
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

// jdmarker.c examine_app0 and examine_app14: an APP0 whose first 14 bytes
// start "JFIF\0" is a JFIF marker; an APP14 whose first 12 bytes start
// "Adobe" is an Adobe marker, its 12th byte the transform. Shorter segments
// are neither.
inline bool read_app(Reader& r, Image& im, int marker, int length) {
  const int need = marker == 0xE0 ? 14 : 12;
  if (length - 2 < need) return true;
  int d[14] = {0};
  for (int i = 0; i < need; ++i)
    if (!r.byte(&d[i])) return false;
  if (marker == 0xE0 && d[0] == 'J' && d[1] == 'F' && d[2] == 'I' && d[3] == 'F' && d[4] == 0) im.saw_jfif = true;
  if (marker == 0xEE && d[0] == 'A' && d[1] == 'd' && d[2] == 'o' && d[3] == 'b' && d[4] == 'e') {
    im.saw_adobe = true;
    im.adobe_transform = d[11];
  }
  return true;
}

// jdapimin.c default_decompress_parms: the colour space of the file's
// samples. 3 components: a JFIF marker means YCbCr; else an Adobe marker's
// transform 0 means RGB and any other YCbCr; else component IDs 'R', 'G', 'B'
// mean RGB and any others YCbCr. 4 components: an Adobe marker's transform 0
// or no Adobe marker means CMYK, any other transform YCCK.
inline int color_space(const Image& im) {
  if (im.components == 1) return GRAYSCALE;
  if (im.components == 3) {
    if (im.saw_jfif) return YCBCR;
    if (im.saw_adobe) return im.adobe_transform == 0 ? RGB : YCBCR;
    return im.comp[0].id == 82 && im.comp[1].id == 71 && im.comp[2].id == 66 ? RGB : YCBCR;
  }
  return im.saw_adobe && im.adobe_transform != 0 ? YCCK : CMYK;
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

// the DC coefficient: its difference added to the component's last DC value,
// shifted left by `al` (0 in a sequential file; jdphuff.c decode_mcu_DC_first)
inline bool decode_dc_first(Reader& r, const Image& im, Component& cp, int al, int16_t* block) {
  int s = 0, v = 0;
  if (!decode_huffman(r, im.dc[cp.td], &s)) return false;
  if (s > 11) return r.fail("a DC difference of more than 11 bits");
  int diff = 0;
  if (s) {
    if (!r.bits(s, &v)) return false;
    diff = extend(v, s);
  }
  cp.last_dc = static_cast<int>(static_cast<unsigned>(cp.last_dc) + static_cast<unsigned>(diff));
  block[0] = static_cast<int16_t>(static_cast<unsigned>(cp.last_dc) << al);
  return true;
}

inline bool decode_block(Reader& r, const Image& im, Component& cp, int16_t* block) {
  if (!decode_dc_first(r, im, cp, 0, block)) return false;
  for (int k = 1; k < 64; ++k) {
    int rs = 0, v = 0;
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

// the other scans of a progressive file, a block at a time (jdphuff.c
// decode_mcu_DC_refine, decode_mcu_AC_first, decode_mcu_AC_refine)
inline bool decode_dc_refine(Reader& r, int al, int16_t* block) {
  int b = 0;
  if (!r.bit(&b)) return false;
  if (b) block[0] = static_cast<int16_t>(block[0] | (1 << al));
  return true;
}

inline bool decode_ac_first(Reader& r, const Huffman& t, int ss, int se, int al, int* eobrun, int16_t* block) {
  if (*eobrun > 0) {  // a block of the band's end-of-band run: nothing to read
    --*eobrun;
    return true;
  }
  for (int k = ss; k <= se; ++k) {
    int rs = 0, v = 0;
    if (!decode_huffman(r, t, &rs)) return false;
    int run = rs >> 4, size = rs & 15;
    if (size) {
      k += run;
      if (k > se) return r.fail("an AC run past the end of a progressive band");
      if (!r.bits(size, &v)) return false;
      block[NATURAL_ORDER[k]] = static_cast<int16_t>(static_cast<unsigned>(extend(v, size)) << al);
    } else if (run == 15) {
      k += 15;  // ZRL: sixteen zeros
    } else {  // EOBr: this block and 2^r + r more bits - 1 blocks after it end here
      int extra = 0;
      if (run && !r.bits(run, &extra)) return false;
      *eobrun = (1 << run) + extra - 1;
      break;
    }
  }
  return true;
}

// a correction bit for an already-nonzero coefficient: 1 adds 1 << al to its
// magnitude, unless that bit is set already
inline bool refine(Reader& r, int al, int16_t* coef) {
  int b = 0;
  if (!r.bit(&b)) return false;
  if (b && (*coef & (1 << al)) == 0) *coef = static_cast<int16_t>(*coef >= 0 ? *coef + (1 << al) : *coef - (1 << al));
  return true;
}

inline bool decode_ac_refine(Reader& r, const Huffman& t, int ss, int se, int al, int* eobrun, int16_t* block) {
  int k = ss;
  if (*eobrun == 0) {
    for (; k <= se; ++k) {
      int rs = 0, run = 0, size = 0, value = 0;
      if (!decode_huffman(r, t, &rs)) return false;
      run = rs >> 4;
      size = rs & 15;
      if (size) {
        if (size != 1) return r.fail("a refinement scan's new coefficient of more than one bit");
        int b = 0;
        if (!r.bit(&b)) return false;
        value = b ? 1 << al : -(1 << al);
      } else if (run != 15) {  // EOBr: the rest of this block is the end-of-band run's
        int extra = 0;
        if (run && !r.bits(run, &extra)) return false;
        *eobrun = (1 << run) + extra;
        break;
      }
      // pass the already-nonzero coefficients, with their correction bits, and
      // `run` zero ones; a new coefficient goes to the zero after them
      do {
        int16_t* coef = block + NATURAL_ORDER[k];
        if (*coef != 0) {
          if (!refine(r, al, coef)) return false;
        } else if (--run < 0) {
          break;
        }
        ++k;
      } while (k <= se);
      if (value) {
        if (k > se) return r.fail("a refinement scan's new coefficient past the end of its band");
        block[NATURAL_ORDER[k]] = static_cast<int16_t>(value);
      }
    }
  }
  if (*eobrun > 0) {  // inside the run: only correction bits, for the already-nonzero coefficients
    for (; k <= se; ++k) {
      int16_t* coef = block + NATURAL_ORDER[k];
      if (*coef != 0 && !refine(r, al, coef)) return false;
    }
    --*eobrun;
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
  int order[MAX_COMPONENTS] = {0};
  for (int i = 0; i < ns; ++i) {
    int id = 0, t = 0;
    if (!r.byte(&id) || !r.byte(&t)) return false;
    int c = -1;
    for (int j = 0; j < im.components; ++j)
      if (im.comp[j].id == id) c = j;
    if (c < 0) return r.fail("a scan names a component the frame does not have");
    im.comp[c].td = t >> 4;
    im.comp[c].ta = t & 15;
    if (im.comp[c].td > 3 || im.comp[c].ta > 3) return r.fail("a scan uses a Huffman table number above 3");
    order[i] = c;
  }
  if (ns > 1) {  // jdinput.c per_scan_setup
    int blocks = 0;
    for (int i = 0; i < ns; ++i) blocks += im.comp[order[i]].h * im.comp[order[i]].v;
    if (blocks > MAX_BLOCKS_IN_MCU) return r.fail("more than 10 blocks in an MCU (jdinput.c JERR_BAD_MCU_SIZE)");
  }
  int ss = 0, se = 0, ahal = 0;
  if (!r.byte(&ss) || !r.byte(&se) || !r.byte(&ahal)) return false;
  const int ah = ahal >> 4, al = ahal & 15;
  const bool dc = ss == 0;
  if (!im.progressive) {
    if (ss != 0 || se != 63 || ahal != 0) return r.fail("a sequential scan with a spectral selection");
  } else if ((dc ? se != 0 : (ss > se || se > 63 || ns != 1)) || (ah != 0 && al != ah - 1) || al > 13) {
    return r.fail("a progressive scan with a bad spectral selection or successive approximation (jdphuff.c "
                  "JERR_BAD_PROGRESSION)");
  }
  const bool needs_dc = !im.progressive || (dc && ah == 0), needs_ac = !im.progressive || !dc;
  for (int i = 0; i < ns; ++i) {
    Component& cp = im.comp[order[i]];
    if ((needs_dc && !im.dc[cp.td].defined) || (needs_ac && !im.ac[cp.ta].defined))
      return r.fail("a scan uses a Huffman table that is not defined");
    if (!cp.latched) {
      if (!im.quant_defined[cp.tq]) return r.fail("a component's quantization table is not defined");
      for (int k = 0; k < 64; ++k) cp.quant[k] = im.quant[cp.tq][k];
      cp.latched = true;
    }
    if (im.progressive) {  // jdphuff.c start_pass_phuff_decoder's progression check, whose warnings refuse here
      if (!dc && cp.coef_bits[0] < 0) return r.fail("a progressive AC scan before its component's DC scan");
      for (int k = ss; k <= se; ++k) {
        if (ah != (cp.coef_bits[k] < 0 ? 0 : cp.coef_bits[k]))
          return r.fail("a progressive scan out of order (its Ah is not the bits already known)");
        cp.coef_bits[k] = al;
      }
    }
    cp.last_dc = 0;
  }
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
  int to_go = im.restart_interval, next_rst = 0, eobrun = 0;
  for (int64_t u = 0; u < units; ++u) {
    if (im.restart_interval && to_go == 0) {
      if (!r.restart(next_rst)) return false;
      next_rst = (next_rst + 1) & 7;
      to_go = im.restart_interval;
      for (int i = 0; i < ns; ++i) im.comp[order[i]].last_dc = 0;
      eobrun = 0;
    }
    int ux = static_cast<int>(u % units_w), uy = static_cast<int>(u / units_w);
    for (int i = 0; i < ns; ++i) {
      Component& cp = im.comp[order[i]];
      int bw = ns == 1 ? 1 : cp.h, bh = ns == 1 ? 1 : cp.v;
      for (int by = 0; by < bh; ++by) {
        for (int bx = 0; bx < bw; ++bx) {
          int64_t row = static_cast<int64_t>(uy) * bh + by, col = static_cast<int64_t>(ux) * bw + bx;
          int16_t* block = coef + cp.offset + (row * cp.blocks_w + col) * 64;
          bool ok = !im.progressive ? decode_block(r, im, cp, block)
                    : dc             ? (ah == 0 ? decode_dc_first(r, im, cp, al, block) : decode_dc_refine(r, al, block))
                    : ah == 0        ? decode_ac_first(r, im.ac[cp.ta], ss, se, al, &eobrun, block)
                                     : decode_ac_refine(r, im.ac[cp.ta], ss, se, al, &eobrun, block);
          if (!ok) return false;
        }
      }
    }
    --to_go;
  }
  r.end_scan();
  return true;
}

// Whether libjpeg would smooth the blocks of this progressive file
// (jdcoefct.c smoothing_ok in libjpeg-turbo, whose SAVED_COEFS is 10): every
// component's DC partly known and its quantization values at the first ten
// zig-zag places nonzero, and some component's first 9 AC coefficients not
// all fully known.
inline bool would_smooth(const Image& im) {
  if (!im.progressive) return false;
  bool useful = false;
  for (int c = 0; c < im.components; ++c) {
    const Component& cp = im.comp[c];
    for (int k = 0; k < 10; ++k)
      if (cp.quant[NATURAL_ORDER[k]] == 0) return false;
    if (cp.coef_bits[0] < 0) return false;
    for (int k = 1; k < 10; ++k) useful |= cp.coef_bits[k] != 0;
  }
  return useful;
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
    if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
      if (frame) return "two frames in one file";
      im.progressive = m == 0xC2;
      ok = read_sof(r, im, len);
      frame = true;
    } else if ((m >= 0xC3 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC)) {
      return m == 0xC3 || m == 0xC7 ? "a lossless or differential JPEG (only Huffman-coded sequential and "
                                      "progressive files are decoded)"
             : m >= 0xC9                   ? "an arithmetic-coded JPEG (only Huffman-coded files are decoded)"
                                           : "a differential (hierarchical) JPEG (only Huffman-coded sequential and "
                                             "progressive files are decoded)";
    } else if (m == 0xCC) {
      return "an arithmetic-coded JPEG (only Huffman-coded files are decoded)";
    } else if (m == 0xC4) {
      ok = read_dht(r, im, len);
    } else if (m == 0xDB) {
      ok = read_dqt(r, im, len);
    } else if (m == 0xE0 || m == 0xEE) {
      ok = read_app(r, im, m, len);
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
  if (coef != nullptr && would_smooth(im))
    return "an incomplete progressive JPEG: some bits of the first 9 AC coefficients are never sent, and libjpeg's "
           "block smoothing for such files is not reproduced";
  return nullptr;
}

// The header of a JPEG: out[0..3] = width, height, components, colour space
// (ColorSpace, from the markers before the first scan); then per component
// k, out[4 + 8 k ..] = h, v, blocks_w, blocks_h, width, height, offset of its
// first coefficient, quantization table. Null, or the reason the file is
// refused.
inline const char* header(const uint8_t* data, int64_t length, int64_t* out) {
  Image im;
  const char* err = parse(data, length, im, nullptr);
  if (err) return err;
  out[0] = im.width;
  out[1] = im.height;
  out[2] = im.components;
  out[3] = color_space(im);
  for (int k = 0; k < im.components; ++k) {
    const Component& c = im.comp[k];
    int64_t* o = out + 4 + 8 * k;
    o[0] = c.h;
    o[1] = c.v;
    o[2] = c.blocks_w;
    o[3] = c.blocks_h;
    o[4] = c.width;
    o[5] = c.height;
    o[6] = c.offset;
    o[7] = c.tq;
  }
  return nullptr;
}

// Decodes every scan into `coef` (`capacity` int16 zeros, the total of the
// header that `header` gave) in one pass over the file, and writes the
// quantization table each component latched (natural order) to quant[k * 64
// ..]. Null, or the reason the file is refused.
inline const char* coefficients(const uint8_t* data, int64_t length, int16_t* coef, int64_t capacity,
                                uint16_t* quant) {
  Image im;
  const char* err = parse(data, length, im, coef, capacity);
  if (err) return err;
  for (int k = 0; k < im.components; ++k)
    for (int i = 0; i < 64; ++i) quant[k * 64 + i] = im.comp[k].quant[i];
  return nullptr;
}

}  // namespace jpeg

// The host decoder's C interface, exported by the one source that includes
// this header (jpeg_decode.cu; the tests build it alone with a host
// compiler): 0, or -1 with threedod_jpeg_error() saying why.
namespace {
thread_local const char* g_jpeg_error = "";
}

extern "C" {

int threedod_jpeg_header(const uint8_t* data, int64_t length, int64_t* out) {
  const char* err = jpeg::header(data, length, out);
  if (err) g_jpeg_error = err;
  return err ? -1 : 0;
}

int threedod_jpeg_coefficients(const uint8_t* data, int64_t length, int16_t* coef, int64_t capacity,
                               uint16_t* quant) {
  const char* err = jpeg::coefficients(data, length, coef, capacity, quant);
  if (err) g_jpeg_error = err;
  return err ? -1 : 0;
}

const char* threedod_jpeg_error() { return g_jpeg_error; }

}  // extern "C"
