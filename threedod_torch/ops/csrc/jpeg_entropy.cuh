// Host half of the card's JPEG decoder: the markers of a JPEG with 8-bit
// samples (1, 3 or 4 components, sampling factors 1 to 4; restart markers;
// interleaved scans or one component a scan) and its entropy-coded data:
//   * DCT files, sequential or progressive, Huffman-coded (SOF0, SOF1, SOF2)
//     or arithmetic-coded (SOF9, SOF10, with the DAC segment's conditioning),
//     decoded to each component's quantized DCT coefficients in natural (not
//     zig-zag) order, with the quantization table each component uses;
//   * lossless files (SOF3, Huffman-coded), decoded to each component's
//     samples;
// and the colour space libjpeg reads the components in (jdapimin.c
// default_decompress_parms, from the JFIF APP0 and Adobe APP14 markers
// before the first scan and the component IDs: see color_space).
// Everything after this step (dequantization, libjpeg's islow IDCT,
// upsampling, colour) runs on the card (jpeg_decode.cu); a lossless file's
// samples go straight to the colour kernel.
//
// Plain C++ with no library: it is compiled by nvcc as host code (and by a
// host compiler in the tests). The decoding follows libjpeg-turbo 3.1's
// jdmarker.c, jdhuff.c (its bit buffer, its fast and slow paths),
// jdphuff.c, jdarith.c, jdlhuff.c, jddiffct.c and jdlossls.c:
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
//     ceil(width_c / 8) x ceil(height_c / 8), not the MCU-padded one;
//   * arithmetic coding (T.81 Annexes D, F.2.4 and G.2; jdarith.c): the QM
//     decoder over T.81 Table D.2 (jaricom.c's packing), 64 DC and 256 AC
//     statistics bins a table and the fixed bin of probability 0.5, the DC
//     contexts of the DAC segment's (L, U) and the AC ones of its Kx
//     (defaults 0, 1 and 5); a marker inside the data makes the rest zeros;
//     a restart marker resets the statistics, the DC predictions and
//     contexts and the decoder's registers;
//   * lossless (T.81 Annex H; jdlhuff.c, jdlossls.c): a difference of each
//     sample, category 0 to 16 (16 is 32768 with no extra bits), added
//     modulo 2^16 to the prediction: the first row of a scan and of each
//     restart interval from the left, its first sample 2^(P - Pt - 1);
//     every other row's first sample from above, the others by the scan's
//     predictor Ss (1 to 7) of the left, upper and upper-left samples; the
//     sample is the result shifted left by Pt, as an 8-bit sample. A
//     lossless file's colour space is RGB for 3 components without a JFIF
//     or Adobe marker, whatever the IDs.
// libjpeg smooths the blocks of a progressive file (jdcoefct.c
// decompress_smooth_data) where, at the end of the file, some bits of the
// first 9 AC coefficients are still unknown (would_smooth; every complete
// progression sends them all): the decoder hands each component's coef_bits
// of zig-zag places 0 to 9 to the caller with the coefficients, which it
// leaves as the file gives them, and the card smooths a copy of each block
// before its IDCT (jpeg_decode.cu), the iMCU rows the last scan reached
// out of data by the bits known before it (jdcoefct.c's use of
// last_good_iMCU_row).
// Damaged data decodes as libjpeg-turbo decodes it for Pillow, warnings and
// all, and Pillow's reading of the file (a source that suspends at the
// file's end) is part of it:
//   * a marker inside a scan ends its data: the bits after it are zeros, and
//     once one is read the MCUs are left as they are until a restart
//     (jdhuff.c jpeg_fill_bit_buffer, JWRN_HIT_MARKER); in a lossless scan
//     each MCU row after it is zero differences from a reset predictor;
//   * a missing or unexpected restart marker: jpeg_resync_to_restart's three
//     actions (swallow it, leave it and decode an empty interval, skip on to
//     the next marker); bytes before a marker are skipped;
//   * a bad Huffman code is the symbol 0 after 17 bits; an AC run past the
//     block's or the band's end lands on the padding of NATURAL_ORDER; a
//     refinement's new coefficient of another size than 1 is read as 1; a
//     DC category of 12 to 15 is read;
//   * a bad arithmetic code leaves the rest of the restart interval as it is;
//   * scans out of progression order, or sequential scans with spectral
//     selection, only warn.
// A file libjpeg refuses is refused with libjpeg's reason, among them a
// file that ends without a marker (its read-ahead of up to 57 bits
// included; a file of one scan may end so after its last MCU), a
// progressive DC past 32 bits, a Huffman table that does not make a code,
// reserved markers, a second SOI or frame, a second scan in a file of one
// scan; so is any file outside this subset (lossless arithmetic coding,
// hierarchical frames, samples of other than 8 bits, 2 or more than 4
// components, sampling factors outside 1 to 4, a fractional sampling ratio,
// an MCU of more than 10 blocks, a lossless file in YCbCr or YCCK, which
// libjpeg does not convert, a lossless restart interval that is not a whole
// number of MCU rows), each with a message; nothing is guessed.
#pragma once

#include <stdint.h>

namespace jpeg {

constexpr int MAX_COMPONENTS = 4;
constexpr int MAX_SAMP_FACTOR = 4;     // jpeglib.h
constexpr int MAX_BLOCKS_IN_MCU = 10;  // jpeglib.h D_MAX_BLOCKS_IN_MCU
constexpr int SAVED_COEFS = 10;        // jdcoefct.c: the zig-zag places block smoothing estimates
constexpr int NUM_ARITH_TBLS = 16;     // jpeglib.h
constexpr int DC_STAT_BINS = 64, AC_STAT_BINS = 256;  // jdarith.c

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
  int dc_context = 0;       // arithmetic coding: the DC statistics' context (0, 4, 8, 12 or 16)
  bool scanned = false;     // a lossless file: some scan coded it
  bool latched = false;     // its quantization table, copied at its first scan (jdinput.c latch_quant_tables)
  uint16_t quant[64] = {0};
  int coef_bits[64];        // progressive: the lowest bit known of each zig-zag coefficient, -1 none yet
  int prev_bits[SAVED_COEFS] = {0};  // coef_bits of places 0 to 9 before the last scan of the component
};

struct Huffman {
  bool defined = false;
  bool tree = true;         // the counts make a code with no all-ones code (jpeg_make_d_derived_tbl's check)
  int max_symbol = 0;
  uint8_t values[256] = {0};
  int maxcode[18] = {0};
  int valptr[17] = {0};
  int mincode[17] = {0};
};

struct Image {
  int width = 0, height = 0, components = 0;
  int hmax = 1, vmax = 1, mcus_w = 0, mcus_h = 0;
  int restart_interval = 0;
  bool progressive = false, arithmetic = false, lossless = false;
  bool saw_jfif = false, saw_adobe = false;  // jdmarker.c saw_JFIF_marker, saw_Adobe_marker
  int adobe_transform = 0;
  Component comp[MAX_COMPONENTS];
  uint16_t quant[4][64] = {{0}};
  bool quant_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  // the DAC segment's conditioning of each arithmetic table (jdmarker.c get_soi's defaults)
  uint8_t dc_l[NUM_ARITH_TBLS], dc_u[NUM_ARITH_TBLS], ac_k[NUM_ARITH_TBLS];
  int64_t coefficients = 0;  // total coefficients over all components (a lossless file: samples)
  int scans = 0;             // SOS markers read (jdmarker.c input_scan_number)
  bool multiple_scans = false;  // the first scan left components out, or the file is progressive
  int last_good_imcu = 0;    // jdmaster.c last_good_iMCU_row: the last iMCU row an MCU began with data left
  bool scanned_all = false;  // the last MCU of a scan decoded
  Image() {
    for (int t = 0; t < NUM_ARITH_TBLS; ++t) {
      dc_l[t] = 0;
      dc_u[t] = 1;
      ac_k[t] = 5;
    }
  }
};

// T.81 Table D.2 as jaricom.c's jpeg_aritab packs it: Qe << 16, the next
// state after an MPS << 8, the MPS switch << 7, the next state after an LPS.
// State 113 is the fixed probability 0.5 (T.851) of the AC signs and the
// refinement bits.
#define JPEG_ARITAB_V(qe, lps, mps, sw) ((static_cast<int64_t>(qe) << 16) | ((mps) << 8) | ((sw) << 7) | (lps))
constexpr int64_t ARITAB[114] = {
    JPEG_ARITAB_V(0x5a1d, 1, 1, 1),     JPEG_ARITAB_V(0x2586, 14, 2, 0),    JPEG_ARITAB_V(0x1114, 16, 3, 0),
    JPEG_ARITAB_V(0x080b, 18, 4, 0),    JPEG_ARITAB_V(0x03d8, 20, 5, 0),    JPEG_ARITAB_V(0x01da, 23, 6, 0),
    JPEG_ARITAB_V(0x00e5, 25, 7, 0),    JPEG_ARITAB_V(0x006f, 28, 8, 0),    JPEG_ARITAB_V(0x0036, 30, 9, 0),
    JPEG_ARITAB_V(0x001a, 33, 10, 0),   JPEG_ARITAB_V(0x000d, 35, 11, 0),   JPEG_ARITAB_V(0x0006, 9, 12, 0),
    JPEG_ARITAB_V(0x0003, 10, 13, 0),   JPEG_ARITAB_V(0x0001, 12, 13, 0),   JPEG_ARITAB_V(0x5a7f, 15, 15, 1),
    JPEG_ARITAB_V(0x3f25, 36, 16, 0),   JPEG_ARITAB_V(0x2cf2, 38, 17, 0),   JPEG_ARITAB_V(0x207c, 39, 18, 0),
    JPEG_ARITAB_V(0x17b9, 40, 19, 0),   JPEG_ARITAB_V(0x1182, 42, 20, 0),   JPEG_ARITAB_V(0x0cef, 43, 21, 0),
    JPEG_ARITAB_V(0x09a1, 45, 22, 0),   JPEG_ARITAB_V(0x072f, 46, 23, 0),   JPEG_ARITAB_V(0x055c, 48, 24, 0),
    JPEG_ARITAB_V(0x0406, 49, 25, 0),   JPEG_ARITAB_V(0x0303, 51, 26, 0),   JPEG_ARITAB_V(0x0240, 52, 27, 0),
    JPEG_ARITAB_V(0x01b1, 54, 28, 0),   JPEG_ARITAB_V(0x0144, 56, 29, 0),   JPEG_ARITAB_V(0x00f5, 57, 30, 0),
    JPEG_ARITAB_V(0x00b7, 59, 31, 0),   JPEG_ARITAB_V(0x008a, 60, 32, 0),   JPEG_ARITAB_V(0x0068, 62, 33, 0),
    JPEG_ARITAB_V(0x004e, 63, 34, 0),   JPEG_ARITAB_V(0x003b, 32, 35, 0),   JPEG_ARITAB_V(0x002c, 33, 9, 0),
    JPEG_ARITAB_V(0x5ae1, 37, 37, 1),   JPEG_ARITAB_V(0x484c, 64, 38, 0),   JPEG_ARITAB_V(0x3a0d, 65, 39, 0),
    JPEG_ARITAB_V(0x2ef1, 67, 40, 0),   JPEG_ARITAB_V(0x261f, 68, 41, 0),   JPEG_ARITAB_V(0x1f33, 69, 42, 0),
    JPEG_ARITAB_V(0x19a8, 70, 43, 0),   JPEG_ARITAB_V(0x1518, 72, 44, 0),   JPEG_ARITAB_V(0x1177, 73, 45, 0),
    JPEG_ARITAB_V(0x0e74, 74, 46, 0),   JPEG_ARITAB_V(0x0bfb, 75, 47, 0),   JPEG_ARITAB_V(0x09f8, 77, 48, 0),
    JPEG_ARITAB_V(0x0861, 78, 49, 0),   JPEG_ARITAB_V(0x0706, 79, 50, 0),   JPEG_ARITAB_V(0x05cd, 48, 51, 0),
    JPEG_ARITAB_V(0x04de, 50, 52, 0),   JPEG_ARITAB_V(0x040f, 50, 53, 0),   JPEG_ARITAB_V(0x0363, 51, 54, 0),
    JPEG_ARITAB_V(0x02d4, 52, 55, 0),   JPEG_ARITAB_V(0x025c, 53, 56, 0),   JPEG_ARITAB_V(0x01f8, 54, 57, 0),
    JPEG_ARITAB_V(0x01a4, 55, 58, 0),   JPEG_ARITAB_V(0x0160, 56, 59, 0),   JPEG_ARITAB_V(0x0125, 57, 60, 0),
    JPEG_ARITAB_V(0x00f6, 58, 61, 0),   JPEG_ARITAB_V(0x00cb, 59, 62, 0),   JPEG_ARITAB_V(0x00ab, 61, 63, 0),
    JPEG_ARITAB_V(0x008f, 61, 32, 0),   JPEG_ARITAB_V(0x5b12, 65, 65, 1),   JPEG_ARITAB_V(0x4d04, 80, 66, 0),
    JPEG_ARITAB_V(0x412c, 81, 67, 0),   JPEG_ARITAB_V(0x37d8, 82, 68, 0),   JPEG_ARITAB_V(0x2fe8, 83, 69, 0),
    JPEG_ARITAB_V(0x293c, 84, 70, 0),   JPEG_ARITAB_V(0x2379, 86, 71, 0),   JPEG_ARITAB_V(0x1edf, 87, 72, 0),
    JPEG_ARITAB_V(0x1aa9, 87, 73, 0),   JPEG_ARITAB_V(0x174e, 72, 74, 0),   JPEG_ARITAB_V(0x1424, 72, 75, 0),
    JPEG_ARITAB_V(0x119c, 74, 76, 0),   JPEG_ARITAB_V(0x0f6b, 74, 77, 0),   JPEG_ARITAB_V(0x0d51, 75, 78, 0),
    JPEG_ARITAB_V(0x0bb6, 77, 79, 0),   JPEG_ARITAB_V(0x0a40, 77, 48, 0),   JPEG_ARITAB_V(0x5832, 80, 81, 1),
    JPEG_ARITAB_V(0x4d1c, 88, 82, 0),   JPEG_ARITAB_V(0x438e, 89, 83, 0),   JPEG_ARITAB_V(0x3bdd, 90, 84, 0),
    JPEG_ARITAB_V(0x34ee, 91, 85, 0),   JPEG_ARITAB_V(0x2eae, 92, 86, 0),   JPEG_ARITAB_V(0x299a, 93, 87, 0),
    JPEG_ARITAB_V(0x2516, 86, 71, 0),   JPEG_ARITAB_V(0x5570, 88, 89, 1),   JPEG_ARITAB_V(0x4ca9, 95, 90, 0),
    JPEG_ARITAB_V(0x44d9, 96, 91, 0),   JPEG_ARITAB_V(0x3e22, 97, 92, 0),   JPEG_ARITAB_V(0x3824, 99, 93, 0),
    JPEG_ARITAB_V(0x32b4, 99, 94, 0),   JPEG_ARITAB_V(0x2e17, 93, 86, 0),   JPEG_ARITAB_V(0x56a8, 95, 96, 1),
    JPEG_ARITAB_V(0x4f46, 101, 97, 0),  JPEG_ARITAB_V(0x47e5, 102, 98, 0),  JPEG_ARITAB_V(0x41cf, 103, 99, 0),
    JPEG_ARITAB_V(0x3c3d, 104, 100, 0), JPEG_ARITAB_V(0x375e, 99, 93, 0),   JPEG_ARITAB_V(0x5231, 105, 102, 0),
    JPEG_ARITAB_V(0x4c0f, 106, 103, 0), JPEG_ARITAB_V(0x4639, 107, 104, 0), JPEG_ARITAB_V(0x415e, 103, 99, 0),
    JPEG_ARITAB_V(0x5627, 105, 106, 1), JPEG_ARITAB_V(0x50e7, 108, 107, 0), JPEG_ARITAB_V(0x4b85, 109, 103, 0),
    JPEG_ARITAB_V(0x5597, 110, 109, 0), JPEG_ARITAB_V(0x504f, 111, 107, 0), JPEG_ARITAB_V(0x5a10, 110, 111, 1),
    JPEG_ARITAB_V(0x5522, 112, 109, 0), JPEG_ARITAB_V(0x59eb, 112, 111, 1), JPEG_ARITAB_V(0x5a1d, 113, 113, 0)};
#undef JPEG_ARITAB_V
constexpr int FIXED_STATE = 113;

// jpeg_natural_order: zig-zag index -> natural (row-major) index, and
// libjpeg's 16 entries of 63 after it, where a corrupt AC run past the end of
// a block or a band lands
constexpr int NATURAL_ORDER[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63, 63, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// The reasons libjpeg (and Pillow) refuse a damaged file, where this decoder
// meets them
constexpr const char* TRUNCATED =
    "the file ends without a marker, inside a segment or its entropy-coded data (libjpeg's input suspends for "
    "more data; Pillow: \"image file is truncated\")";
constexpr const char* ARITH_TRUNCATED =
    "the file ends inside arithmetic-coded data without a marker (jdarith.c JERR_CANT_SUSPEND; Pillow refuses "
    "the file)";

constexpr int MIN_GET_BITS = 57;  // jdhuff.h: 64-bit bit buffer less 7

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
    if (pos_ >= length_) return fail(TRUNCATED);
    *out = data_[pos_++];
    return true;
  }
  bool word(int* out) {
    int hi = 0, lo = 0;
    if (!byte(&hi) || !byte(&lo)) return false;
    *out = (hi << 8) | lo;
    return true;
  }
  // the bytes after the read position: libjpeg's bytes_in_buffer, the whole
  // file taken as the buffer (Pillow hands libjpeg 64 KiB reads, and a read
  // ending earlier may send an MCU of a larger file down the slow path; no
  // file was found where that changes the outcome)
  int64_t remaining() const { return length_ - pos_; }

  // jdmarker.c next_marker: the next marker from the current position, any
  // other bytes (a stuffed 0xFF 0x00 among them) skipped, 0xFF fill bytes
  // swallowed; the file's end before one refuses, as Pillow's suspending
  // source does. The marker is left unread: marker() is its code,
  // marker_pos_ the 0xFF before it
  bool next_marker() {
    for (;;) {
      int c = 0;
      do {
        if (!byte(&c)) return false;
      } while (c != 0xFF);
      do {
        if (!byte(&c)) return false;
      } while (c == 0xFF);
      if (c != 0) {
        marker_ = c;
        marker_pos_ = pos_ - 2;
        return true;
      }
    }
  }
  int marker() const { return marker_; }
  int take_marker() {
    const int m = marker_;
    marker_ = 0;
    return m;
  }

  // Huffman-coded data as jdhuff.c reads it: a bit buffer of up to 64 bits
  // filled a byte at a time (0xFF 0x00 is a 0xFF byte, 0xFF fill bytes
  // before the 0x00 swallowed). jpeg_fill_bit_buffer, the slow path's fill,
  // reads ahead to 57 bits; the file's end on the way refuses, as Pillow's
  // suspending source does, even where no bit past it is needed. A marker
  // ends the data: the fill stops before it, and a request for more bits
  // than are left shifts in zeros and sets the insufficient-data flag
  // (JWRN_HIT_MARKER), after which the scan's decoders leave their MCUs
  // alone until a restart clears it. In the fast path (decode_mcu_fast,
  // fast()), a fill takes 6 bytes whenever 16 bits or fewer are left, and
  // meets a marker by feeding zero bytes.
  void start_bits() {
    buf_ = 0;
    left_ = 0;
    insufficient_ = false;
    fast_ = false;
  }
  bool insufficient() const { return insufficient_; }
  bool fast() const { return fast_; }
  void set_fast(bool fast) { fast_ = fast; }
  // FILL_BIT_BUFFER_FAST: 6 bytes where 16 bits or fewer are left (the
  // caller saw 512 bytes a block in the buffer); a marker is fed as zero
  // bytes and left in marker() for the caller, which decodes the MCU again
  // by the slow path
  void fill_fast() {
    if (left_ > 16) return;
    for (int i = 0; i < 6; ++i) {
      const int c0 = data_[pos_++], c1 = pos_ < length_ ? data_[pos_] : 0;
      buf_ = (buf_ << 8) | static_cast<uint64_t>(c0);
      left_ += 8;
      if (c0 == 0xFF) {
        ++pos_;
        if (c1 != 0) {
          marker_ = c1;
          pos_ -= 2;
          buf_ &= ~static_cast<uint64_t>(0xFF);
        }
      }
    }
  }
  // jpeg_fill_bit_buffer: to 57 bits, or to a marker, then zeros where
  // `nbits` are still more than are left
  bool fill(int nbits) {
    while (marker_ == 0 && left_ < MIN_GET_BITS) {
      int c = 0;
      if (!byte(&c)) return false;
      if (c == 0xFF) {
        do {
          if (!byte(&c)) return false;
        } while (c == 0xFF);
        if (c == 0) {
          c = 0xFF;
        } else {
          marker_ = c;
          marker_pos_ = pos_ - 2;
          break;
        }
      }
      buf_ = (buf_ << 8) | static_cast<uint64_t>(c);
      left_ += 8;
    }
    if (nbits > left_) {  // past the marker
      insufficient_ = true;
      buf_ <<= MIN_GET_BITS - left_;
      left_ = MIN_GET_BITS;
    }
    return true;
  }
  // GET_BITS: n bits the buffer holds
  int get(int n) {
    left_ -= n;
    return static_cast<int>((buf_ >> left_) & ((1u << n) - 1));
  }
  // CHECK_BIT_BUFFER and GET_BITS (the fast path: FILL_BIT_BUFFER_FAST first)
  bool bits(int n, int* out) {
    if (fast_)
      fill_fast();
    else if (left_ < n && !fill(n))
      return false;
    *out = get(n);
    return true;
  }
  bool bit(int* out) { return bits(1, out); }
  // the next 8 bits without taking them (PEEK_BITS(HUFF_LOOKAHEAD)), or -1
  // where fewer are left after a fill (the slow path: a marker met)
  bool peek8(int* out) {
    if (fast_) {
      fill_fast();
    } else if (left_ < 8) {
      if (!fill(0)) return false;
      if (left_ < 8) {
        *out = -1;
        return true;
      }
    }
    *out = static_cast<int>((buf_ >> (left_ - 8)) & 0xFF);
    return true;
  }
  // the state an MCU begins with, for decoding it again by the slow path
  // after a fast attempt met a marker
  struct State {
    int64_t pos, marker_pos;
    uint64_t buf;
    int left, marker;
    bool insufficient;
  };
  State save() const { return State{pos_, marker_pos_, buf_, left_, marker_, insufficient_}; }
  void restore(const State& st) {
    pos_ = st.pos;
    marker_pos_ = st.marker_pos;
    buf_ = st.buf;
    left_ = st.left;
    marker_ = st.marker;
    insufficient_ = st.insufficient;
  }
  // jdhuff.c process_restart: the bits left are dropped, the restart marker
  // read (read_restart_marker), and the insufficient-data flag cleared unless
  // a marker is left unread, which makes the interval empty
  bool restart(int expected) {
    left_ = 0;
    if (!read_restart_marker(expected)) return false;
    if (marker_ == 0) insufficient_ = false;
    return true;
  }
  // jdmarker.c read_restart_marker: the marker met in the data, or else the
  // next one in the file, is swallowed if it is RSTn for the expected n;
  // otherwise jpeg_resync_to_restart decides (JWRN_MUST_RESYNC)
  bool read_restart_marker(int expected) {
    if (marker_ == 0 && !next_marker()) return false;
    if (marker_ == 0xD0 + expected) {
      marker_ = 0;
      return true;
    }
    return resync(expected);
  }
  // jdmarker.c jpeg_resync_to_restart for the expected RSTn: a marker below
  // SOF0, or one of the two restarts before it, is skipped and the next
  // marker decides again; any other non-restart marker, or one of the two
  // restarts after it, is left unread (the interval decodes as empty); any
  // other restart marker is swallowed as if it were the expected one
  bool resync(int desired) {
    for (;;) {
      const int m = marker_;
      const bool restart = m >= 0xD0 && m <= 0xD7;
      if (m >= 0xC0 && (!restart || m == 0xD0 + ((desired + 1) & 7) || m == 0xD0 + ((desired + 2) & 7)))
        return true;
      marker_ = 0;
      if (m >= 0xC0 && m != 0xD0 + ((desired - 1) & 7) && m != 0xD0 + ((desired - 2) & 7)) return true;
      if (!next_marker()) return false;
    }
  }
  // after a scan: back to the marker that ended its data, or on to the next
  // one in the file
  bool end_scan() {
    left_ = 0;
    if (marker_ == 0 && !next_marker()) return false;
    pos_ = marker_pos_;
    marker_ = 0;
    return true;
  }

  // arithmetic-coded data (jdarith.c): the C register (the code's base and
  // the bits read ahead), the A register (the interval), CT (the bits left
  // in C; -16 before the first two bytes). A marker inside the data is
  // legal: the decoder reads zeros after it. A bad code (JWRN_ARITH_BAD_CODE)
  // sets CT to -1: the scan's MCUs are left alone until the next restart
  // (dead()).
  void start_arith() {
    c_ = 0;
    a_ = 0;
    ct_ = -16;
    dead_ = false;
  }
  void bad_code() { dead_ = true; }
  bool dead() const { return dead_; }
  // arith_decode: one binary decision in statistics bin *st
  bool decide(uint8_t* st, int* out) {
    while (a_ < 0x8000) {  // renormalization and data input (D.2.6)
      if (--ct_ < 0) {
        int d = 0;
        if (marker_ == 0) {
          if (pos_ >= length_) return fail(ARITH_TRUNCATED);
          d = data_[pos_++];
          if (d == 0xFF) {
            do {
              if (pos_ >= length_) return fail(ARITH_TRUNCATED);
              d = data_[pos_++];
            } while (d == 0xFF);
            if (d == 0) {
              d = 0xFF;  // a stuffed zero
            } else {
              marker_ = d;
              marker_pos_ = pos_ - 2;
              d = 0;
            }
          }
        }
        c_ = (c_ << 8) | d;
        if ((ct_ += 8) < 0 && ++ct_ == 0) a_ = 0x8000;  // the two first bytes read: A becomes 0x10000 below
      }
      a_ <<= 1;
    }
    int sv = *st;
    int64_t qe = ARITAB[sv & 0x7F];
    const int nl = static_cast<int>(qe & 0xFF), nm = static_cast<int>((qe >> 8) & 0xFF);
    qe >>= 16;
    int64_t temp = a_ - qe;  // decoding and estimation (D.2.4, D.2.5)
    a_ = temp;
    temp <<= ct_;
    if (c_ >= temp) {
      c_ -= temp;
      if (a_ < qe) {  // conditional exchange: the MPS
        a_ = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a_ = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a_ < 0x8000) {
      if (a_ < qe) {  // conditional exchange: the LPS
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    *out = sv >> 7;
    return true;
  }
  // jdarith.c process_restart: the restart marker read as the Huffman
  // decoder reads it (a marker left unread makes the rest zeros), and the
  // decoder's registers reset
  bool arith_restart(int expected) {
    if (!read_restart_marker(expected)) return false;
    start_arith();
    return true;
  }

 private:
  const uint8_t* data_;
  int64_t length_;
  int64_t pos_ = 0;
  uint64_t buf_ = 0;
  int left_ = 0;
  bool insufficient_ = false, dead_ = false, fast_ = false;
  int64_t c_ = 0, a_ = 0, marker_pos_ = 0;
  int ct_ = 0, marker_ = 0;
};

inline bool read_dqt(Reader& r, Image& im, int length) {
  int left = length - 2;
  while (left > 0) {
    int pq_tq = 0;
    if (!r.byte(&pq_tq)) return false;
    int pq = (pq_tq >> 4) != 0, tq = pq_tq & 15;  // jdmarker.c get_dqt: any nonzero precision is 16 bits
    if (tq > 3) return r.fail("a quantization table number above 3 (jdmarker.c JERR_DQT_INDEX)");
    for (int k = 0; k < 64; ++k) {
      int q = 0;
      if (pq ? !r.word(&q) : !r.byte(&q)) return false;
      im.quant[tq][NATURAL_ORDER[k]] = static_cast<uint16_t>(q);
    }
    im.quant_defined[tq] = true;
    left -= 1 + 64 * (pq + 1);
  }
  return left == 0 ? true : r.fail("a DQT segment of the wrong length (jdmarker.c JERR_BAD_LENGTH)");
}

// jdmarker.c get_dht, its reads and checks in its order
inline bool read_dht(Reader& r, Image& im, int length) {
  const char* bad = "a DHT segment with more codes than it holds (jdmarker.c JERR_BAD_HUFF_TABLE)";
  int left = length - 2;
  while (left > 16) {
    int tc_th = 0;
    if (!r.byte(&tc_th)) return false;
    int counts[17] = {0};
    int total = 0;
    for (int l = 1; l <= 16; ++l) {
      if (!r.byte(&counts[l])) return false;
      total += counts[l];
    }
    left -= 17;
    if (total > 256 || total > left) return r.fail(bad);
    uint8_t values[256] = {0};
    for (int i = 0; i < total; ++i) {
      int v = 0;
      if (!r.byte(&v)) return false;
      values[i] = static_cast<uint8_t>(v);
    }
    left -= total;
    const bool ac = (tc_th & 0x10) != 0;
    const int th = ac ? tc_th - 0x10 : tc_th;
    if (th > 3) return r.fail("a Huffman table number above 3 (jdmarker.c JERR_DHT_INDEX)");
    Huffman& t = ac ? im.ac[th] : im.dc[th];
    for (int i = 0; i < 256; ++i) t.values[i] = values[i];
    // canonical codes (jdhuff.c jpeg_make_d_derived_tbl)
    int code = 0, k = 0;
    t.tree = true;
    t.max_symbol = 0;
    for (int i = 0; i < total; ++i) t.max_symbol = t.values[i] > t.max_symbol ? t.values[i] : t.max_symbol;
    for (int l = 1; l <= 16; ++l) {
      t.valptr[l] = k;
      t.mincode[l] = code;
      code += counts[l];
      k += counts[l];
      t.maxcode[l] = counts[l] ? code - 1 : -1;
      if (code >= (1 << l)) t.tree = false;
      code <<= 1;
    }
    t.maxcode[17] = 0x7FFFFFFF;
    t.defined = true;
  }
  return left == 0 ? true : r.fail("a DHT segment of the wrong length (jdmarker.c JERR_BAD_LENGTH)");
}

inline bool read_sof(Reader& r, Image& im, int length) {
  int precision = 0, n = 0;
  if (!r.byte(&precision) || !r.word(&im.height) || !r.word(&im.width) || !r.byte(&n)) return false;
  if (precision != 8) return r.fail("not 8-bit samples");
  if (im.width <= 0 || im.height <= 0) return r.fail("an image without a width or a height in its header");
  if (n == 2) return r.fail("2 components (Pillow cannot handle 2-layer images)");
  if (n != 1 && n != 3 && n != 4) return r.fail("not 1, 3 or 4 components");
  if (length != 8 + 3 * n) return r.fail("an SOF segment of the wrong length (jdmarker.c JERR_BAD_LENGTH)");
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
    if (cp.tq > 3) return r.fail("a quantization table number above 3 (jdinput.c JERR_NO_QUANT_TABLE)");
    im.hmax = cp.h > im.hmax ? cp.h : im.hmax;
    im.vmax = cp.v > im.vmax ? cp.v : im.vmax;
  }
  for (int c = 0; c < n; ++c)
    if (im.hmax % im.comp[c].h || im.vmax % im.comp[c].v)
      return r.fail("a fractional sampling ratio: a component's factors do not divide the largest ones (jdsample.c "
                    "JERR_FRACT_SAMPLE_NOTIMPL)");
  // a lossless file's data unit is one sample, a DCT file's an 8x8 block;
  // a lossless component's "blocks" are its samples, stored at its own size
  const int unit = im.lossless ? 1 : 8;
  im.mcus_w = (im.width + unit * im.hmax - 1) / (unit * im.hmax);
  im.mcus_h = (im.height + unit * im.vmax - 1) / (unit * im.vmax);
  int64_t offset = 0;
  for (int c = 0; c < n; ++c) {
    Component& cp = im.comp[c];
    cp.width = (im.width * cp.h + im.hmax - 1) / im.hmax;
    cp.height = (im.height * cp.v + im.vmax - 1) / im.vmax;
    cp.blocks_w = im.lossless ? cp.width : im.mcus_w * cp.h;
    cp.blocks_h = im.lossless ? cp.height : im.mcus_h * cp.v;
    cp.offset = offset;
    offset += static_cast<int64_t>(cp.blocks_w) * cp.blocks_h * (im.lossless ? 1 : 64);
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

// jdmarker.c get_dac: the arithmetic conditioning of DC tables (index 0 to
// 15: L in the low nibble, U in the high one, L <= U) and AC tables (index
// 16 to 31: Kx)
inline bool read_dac(Reader& r, Image& im, int length) {
  int left = length - 2;
  while (left > 0) {
    int index = 0, value = 0;
    if (!r.byte(&index) || !r.byte(&value)) return false;
    left -= 2;
    if (index >= 2 * NUM_ARITH_TBLS) return r.fail("a DAC table index above 31 (jdmarker.c JERR_DAC_INDEX)");
    if (index >= NUM_ARITH_TBLS) {
      im.ac_k[index - NUM_ARITH_TBLS] = static_cast<uint8_t>(value);
    } else {
      im.dc_l[index] = static_cast<uint8_t>(value & 15);
      im.dc_u[index] = static_cast<uint8_t>(value >> 4);
      if (im.dc_l[index] > im.dc_u[index]) return r.fail("a DAC segment's L above its U (jdmarker.c JERR_DAC_VALUE)");
    }
  }
  return left == 0 ? true : r.fail("a DAC segment of the wrong length (jdmarker.c JERR_BAD_LENGTH)");
}

// jdapimin.c default_decompress_parms: the colour space of the file's
// samples. 3 components: a JFIF marker means YCbCr; else an Adobe marker's
// transform 0 means RGB and any other YCbCr; else component IDs 'R', 'G', 'B'
// mean RGB, and any others YCbCr in a DCT file and RGB in a lossless one.
// 4 components: an Adobe marker's transform 0 or no Adobe marker means CMYK,
// any other transform YCCK.
inline int color_space(const Image& im) {
  if (im.components == 1) return GRAYSCALE;
  if (im.components == 3) {
    if (im.saw_jfif) return YCBCR;
    if (im.saw_adobe) return im.adobe_transform == 0 ? RGB : YCBCR;
    if (im.lossless) return RGB;
    return im.comp[0].id == 82 && im.comp[1].id == 71 && im.comp[2].id == 66 ? RGB : YCBCR;
  }
  return im.saw_adobe && im.adobe_transform != 0 ? YCCK : CMYK;
}

// libjpeg-turbo makes no colour conversion in lossless mode
// (jdcolor.c JERR_CONVERSION_NOTIMPL), so Pillow, which asks for RGB from
// YCbCr and for CMYK from YCCK, refuses those lossless files
inline const char* lossless_space_error(const Image& im) {
  const int space = color_space(im);
  if (im.lossless && (space == YCBCR || space == YCCK))
    return space == YCBCR ? "a lossless JPEG in YCbCr: libjpeg makes no colour conversion in lossless mode "
                            "(JERR_CONVERSION_NOTIMPL), and Pillow refuses the file"
                          : "a lossless JPEG in YCCK: libjpeg makes no colour conversion in lossless mode "
                            "(JERR_CONVERSION_NOTIMPL), and Pillow refuses the file";
  return nullptr;
}

// jdhuff.c jpeg_make_d_derived_tbl's checks of a table a scan uses: codes
// that fit their lengths, and DC symbols (categories) of at most 15 (16 in
// a lossless file)
inline bool table_ok(const Huffman& t, bool dc, bool lossless) {
  return t.tree && (!dc || t.max_symbol <= (lossless ? 16 : 15));
}

// jdhuff.c HUFF_DECODE (and HUFF_DECODE_FAST): a code of up to 8 bits
// looked up in the next 8 bits, a longer one read a bit at a time from 9
// bits on (jpeg_huff_decode; the fast path takes those bits unchecked);
// where the data holds no code of 16 bits or less, the symbol 0 after 17
// bits (JWRN_HUFF_BAD_CODE)
inline bool decode_huffman(Reader& r, const Huffman& t, int* out) {
  int look = 0, nb = 1, code = 0;
  if (!r.peek8(&look)) return false;
  if (look >= 0) {
    for (int l = 1; l <= 8; ++l) {
      code = look >> (8 - l);
      if (code <= t.maxcode[l]) {
        r.get(l);
        *out = t.values[(t.valptr[l] + code - t.mincode[l]) & 0xFF];
        return true;
      }
    }
    nb = 9;
  }
  if (r.fast())
    code = r.get(nb);
  else if (!r.bits(nb, &code))
    return false;
  int l = nb;
  while (code > t.maxcode[l]) {
    int b = 0;
    if (r.fast())
      b = r.get(1);
    else if (!r.bit(&b))
      return false;
    code = (code << 1) | b;
    ++l;
  }
  *out = l > 16 ? 0 : t.values[(t.valptr[l] + code - t.mincode[l]) & 0xFF];
  return true;
}

// HUFF_EXTEND: the s-bit value v as a signed coefficient
inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// the DC coefficient: its difference (a category of up to 15 bits) added to
// the component's last DC value, shifted left by `al` (0 in a sequential
// file; jdphuff.c decode_mcu_DC_first, where a sum past 32 bits is
// JERR_BAD_DCT_COEF; the sequential decoder lets it wrap)
inline bool decode_dc_first(Reader& r, const Image& im, Component& cp, int al, int16_t* block) {
  int s = 0, v = 0;
  if (!decode_huffman(r, im.dc[cp.td], &s)) return false;
  int diff = 0;
  if (s) {
    if (!r.bits(s, &v)) return false;
    diff = extend(v, s);
  }
  const int64_t sum = static_cast<int64_t>(cp.last_dc) + diff;
  if (im.progressive && (sum > 2147483647LL || sum < -2147483648LL))
    return r.fail("a DC coefficient past 32 bits (jdphuff.c JERR_BAD_DCT_COEF, \"DCT coefficient out of range\"; "
                  "Pillow refuses the file)");
  cp.last_dc = static_cast<int>(static_cast<uint32_t>(sum));
  block[0] = static_cast<int16_t>(static_cast<unsigned>(cp.last_dc) << al);
  return true;
}

// a run past the block's end lands on the padding of NATURAL_ORDER: coefficient 63
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

// a run past the band's end writes the coefficient at NATURAL_ORDER[k]
// (outside the band, or 63) and ends the block, as jdphuff.c does
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
      if (size) {  // of size 1; any other size is read as 1 (JWRN_HUFF_BAD_CODE)
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
      if (value) block[NATURAL_ORDER[k]] = static_cast<int16_t>(value);  // past the band: Se + 1's place
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

// ---------------------------------------------------------------------------
// arithmetic coding (jdarith.c)
// ---------------------------------------------------------------------------

// a scan's statistics: 64 DC and 256 AC bins a table, and the fixed bin
struct ArithStats {
  uint8_t dc[NUM_ARITH_TBLS][DC_STAT_BINS];
  uint8_t ac[NUM_ARITH_TBLS][AC_STAT_BINS];
  uint8_t fixed;
};

// jdarith.c's answer to a bad code (a magnitude past 15 bits, an AC run past
// the band's end): JWRN_ARITH_BAD_CODE, CT = -1, the MCU and the rest of the
// restart interval left as they are. The decoders return at once.
inline bool bad_arithmetic_code(Reader& r) {
  r.bad_code();
  return true;
}

// F.2.4.3 (Figures F.23 and F.24): a magnitude whose first category
// decision is in bin st[0], the next ones from X1 on, each after the first
// from X2 on; the value's bits below its category's top bit 14 bins above
// the last category bin. `out` gets the magnitude less one.
inline bool arith_magnitude(Reader& r, uint8_t* st, uint8_t* x1, uint8_t* x2, int* out) {
  int m = 0, b = 0;
  if (!r.decide(st, &m)) return false;
  if (m) {
    st = x1;
    for (;;) {
      if (!r.decide(st, &b)) return false;
      if (!b) break;
      if ((m <<= 1) == 0x8000) return bad_arithmetic_code(r);  // magnitude overflow
      st = st == x1 ? x2 : st + 1;
    }
  }
  int v = m;
  st += 14;
  while (m >>= 1) {
    if (!r.decide(st, &b)) return false;
    if (b) v |= m;
  }
  *out = v;
  return true;
}

// F.2.4.1 (Figure F.19): a DC difference from the table's statistics `s`,
// in the component's context, which it updates (F.1.4.4.1.2)
inline bool arith_dc_diff(Reader& r, uint8_t* s, int l, int u, Component& cp, int* diff) {
  int nonzero = 0, sign = 0, v = 0;
  if (!r.decide(s + cp.dc_context, &nonzero)) return false;
  if (!nonzero) {
    cp.dc_context = 0;
    *diff = 0;
    return true;
  }
  if (!r.decide(s + cp.dc_context + 1, &sign)) return false;
  uint8_t* st = s + cp.dc_context + 2 + sign;
  if (!arith_magnitude(r, st, s + 20, s + 21, &v)) return false;
  if (r.dead()) return true;
  const int m = v == 0 ? 0 : 1 << (31 - __builtin_clz(static_cast<unsigned>(v)));  // the category's top bit
  if (m < (1 << l) >> 1)
    cp.dc_context = 0;  // zero difference category
  else if (m > (1 << u) >> 1)
    cp.dc_context = 12 + 4 * sign;  // large
  else
    cp.dc_context = 4 + 4 * sign;  // small
  *diff = sign ? -(v + 1) : v + 1;
  return true;
}

// F.2.4.2 (Figure F.20): the band Ss..Se of a block, each value shifted
// left by Al (jdarith.c decode_mcu's AC half and decode_mcu_AC_first)
inline bool arith_ac_first(Reader& r, uint8_t* s, uint8_t* fixed, int ss, int se, int al, int kx, int16_t* block) {
  for (int k = ss; k <= se; ++k) {
    uint8_t* st = s + 3 * (k - 1);
    int b = 0, sign = 0, v = 0;
    if (!r.decide(st, &b)) return false;
    if (b) break;  // the end of the block
    for (;;) {
      if (!r.decide(st + 1, &b)) return false;
      if (b) break;
      st += 3;
      if (++k > se) return bad_arithmetic_code(r);  // spectral overflow
    }
    if (!r.decide(fixed, &sign)) return false;
    if (!arith_magnitude(r, st + 2, st + 2, s + (k <= kx ? 189 : 217), &v)) return false;
    if (r.dead()) return true;
    v = sign ? -(v + 1) : v + 1;
    block[NATURAL_ORDER[k]] = static_cast<int16_t>(static_cast<unsigned>(v) << al);
  }
  return true;
}

// G.2 (jdarith.c decode_mcu_AC_refine): a correction bit for each
// coefficient known nonzero, a sign for each newly nonzero one (magnitude
// 1 << Al); an end-of-block decision only past the last known nonzero one
inline bool arith_ac_refine(Reader& r, uint8_t* s, uint8_t* fixed, int ss, int se, int al, int16_t* block) {
  const int p1 = 1 << al, m1 = -(1 << al);
  int kex = se;
  while (kex > 0 && block[NATURAL_ORDER[kex]] == 0) --kex;
  for (int k = ss; k <= se; ++k) {
    uint8_t* st = s + 3 * (k - 1);
    int b = 0;
    if (k > kex) {
      if (!r.decide(st, &b)) return false;
      if (b) break;  // the end of the block
    }
    for (;;) {
      int16_t* coef = block + NATURAL_ORDER[k];
      if (*coef) {
        if (!r.decide(st + 2, &b)) return false;
        if (b) *coef = static_cast<int16_t>(*coef < 0 ? *coef + m1 : *coef + p1);
        break;
      }
      if (!r.decide(st + 1, &b)) return false;
      if (b) {
        if (!r.decide(fixed, &b)) return false;
        *coef = static_cast<int16_t>(b ? m1 : p1);
        break;
      }
      st += 3;
      if (++k > se) return bad_arithmetic_code(r);  // spectral overflow
    }
  }
  return true;
}

// the statistics a scan uses, zeroed (jdarith.c start_pass and
// process_restart), with the DC predictions and contexts
inline void reset_arith_stats(Image& im, const int* order, int ns, bool dc, bool ac, ArithStats& st) {
  for (int i = 0; i < ns; ++i) {
    Component& cp = im.comp[order[i]];
    if (dc) {
      for (int b = 0; b < DC_STAT_BINS; ++b) st.dc[cp.td][b] = 0;
      cp.last_dc = 0;
      cp.dc_context = 0;
    }
    if (ac)
      for (int b = 0; b < AC_STAT_BINS; ++b) st.ac[cp.ta][b] = 0;
  }
  st.fixed = FIXED_STATE;
}

// one block of an arithmetic-coded scan (jdarith.c decode_mcu,
// decode_mcu_DC_first, decode_mcu_DC_refine, decode_mcu_AC_first,
// decode_mcu_AC_refine)
inline bool arith_block(Reader& r, Image& im, Component& cp, ArithStats& st, int ss, int se, int ah, int al,
                        int16_t* block) {
  if (!im.progressive || (ss == 0 && ah == 0)) {
    int diff = 0;
    if (!arith_dc_diff(r, st.dc[cp.td], im.dc_l[cp.td], im.dc_u[cp.td], cp, &diff)) return false;
    if (r.dead()) return true;
    cp.last_dc = (cp.last_dc + diff) & 0xFFFF;
    block[0] = static_cast<int16_t>(static_cast<unsigned>(cp.last_dc) << (im.progressive ? al : 0));
    return im.progressive || arith_ac_first(r, st.ac[cp.ta], &st.fixed, 1, 63, 0, im.ac_k[cp.ta], block);
  }
  if (ss == 0) {
    int b = 0;
    if (!r.decide(&st.fixed, &b)) return false;
    if (b) block[0] = static_cast<int16_t>(block[0] | (1 << al));
    return true;
  }
  return ah == 0 ? arith_ac_first(r, st.ac[cp.ta], &st.fixed, ss, se, al, im.ac_k[cp.ta], block)
                 : arith_ac_refine(r, st.ac[cp.ta], &st.fixed, ss, se, al, block);
}

// ---------------------------------------------------------------------------
// lossless (jdlhuff.c, jdlossls.c)
// ---------------------------------------------------------------------------

// H.2.2: one sample's difference; category 16 is 32768 with no extra bits
// (the scan's table holds no category above 16: table_ok)
inline bool decode_difference(Reader& r, const Huffman& t, int* diff) {
  int s = 0, v = 0;
  if (!decode_huffman(r, t, &s)) return false;
  if (s == 16) {
    *diff = 32768;
  } else if (s) {
    if (!r.bits(s, &v)) return false;
    *diff = extend(v, s);
  } else {
    *diff = 0;
  }
  return true;
}

// jdlossls.c's undifferencers: one row of a component from its
// differences `d` and the row above `above` (null for a first row), modulo
// 2^16, into `row`
inline void undifference(const int* d, const int* above, int predictor, int initial, int width, int* row) {
  if (above == nullptr) {  // the first row of a scan or a restart interval: 1-D, from the left
    int ra = (d[0] + initial) & 0xFFFF;
    row[0] = ra;
    for (int x = 1; x < width; ++x) row[x] = ra = (d[x] + ra) & 0xFFFF;
    return;
  }
  int rb = above[0], ra = (d[0] + rb) & 0xFFFF;  // the first column from above
  row[0] = ra;
  for (int x = 1; x < width; ++x) {
    const int rc = rb;
    rb = above[x];
    int pred = 0;
    switch (predictor) {
      case 1: pred = ra; break;
      case 2: pred = rb; break;
      case 3: pred = rc; break;
      case 4: pred = ra + rb - rc; break;
      case 5: pred = ra + ((rb - rc) >> 1); break;
      case 6: pred = rb + ((ra - rc) >> 1); break;
      default: pred = (ra + rb) >> 1; break;
    }
    row[x] = ra = (d[x] + pred) & 0xFFFF;
  }
}

// One lossless scan (jddiffct.c decompress_data): an iMCU row at a time (one
// MCU row of an interleaved scan, v sample rows of a one-component scan),
// its MCU rows of differences decoded, then each component's rows
// undifferenced (the dummy samples past a component's edge are decoded and
// dropped). Restarts come every restart_interval / units_w MCU rows. An MCU
// row met with the insufficient-data flag set is all zero differences
// (jdlhuff.c decode_mcus). Each restart and each such row resets the
// undifferencer: the first row undifferenced after it, the iMCU row's first,
// is a first row. Samples go to `samples` shifted left by Al.
inline bool lossless_scan(Reader& r, Image& im, const int* order, int ns, int predictor, int al, int units_w,
                          int units_h, uint8_t* samples) {
  int* diff[MAX_COMPONENTS] = {nullptr};  // the differences of an iMCU row, v rows a component
  int* rows[MAX_COMPONENTS] = {nullptr};  // two rows of undifferenced values a component
  bool first[MAX_COMPONENTS];
  bool ok = true;
  for (int i = 0; i < ns; ++i) {
    const Component& cp = im.comp[order[i]];
    const int bw = ns == 1 ? 1 : cp.h;
    diff[i] = new int[static_cast<int64_t>(units_w) * bw * cp.v];
    rows[i] = new int[2 * static_cast<int64_t>(cp.width)];
    first[i] = true;
  }
  const int initial = 1 << (8 - al - 1);
  const int rows_per_restart = im.restart_interval / units_w;
  const int mcu_rows_per_imcu = ns == 1 ? im.comp[order[0]].v : 1;
  int rows_to_go = rows_per_restart, next_rst = 0;
  int done[MAX_COMPONENTS] = {0};  // rows of each component written
  r.start_bits();
  for (int uy0 = 0; uy0 < units_h && ok; uy0 += mcu_rows_per_imcu) {
    const int mcu_rows = units_h - uy0 < mcu_rows_per_imcu ? units_h - uy0 : mcu_rows_per_imcu;
    for (int yo = 0; yo < mcu_rows && ok; ++yo) {
      if (im.restart_interval && rows_to_go == 0) {
        if (!(ok = r.restart(next_rst))) break;
        next_rst = (next_rst + 1) & 7;
        rows_to_go = rows_per_restart;
        for (int i = 0; i < ns; ++i) first[i] = true;
      }
      const bool empty = r.insufficient();
      for (int i = 0; i < ns && empty; ++i) first[i] = true;
      for (int ux = 0; ux < units_w && ok; ++ux) {
        for (int i = 0; i < ns && ok; ++i) {
          const Component& cp = im.comp[order[i]];
          const int bw = ns == 1 ? 1 : cp.h, bh = ns == 1 ? 1 : cp.v;
          for (int by = 0; by < bh && ok; ++by)
            for (int bx = 0; bx < bw && ok; ++bx) {
              int* d = diff[i] + static_cast<int64_t>(yo * bh + by) * units_w * bw + ux * bw + bx;
              if (empty)
                *d = 0;
              else
                ok = decode_difference(r, im.dc[cp.td], d);
            }
        }
      }
      --rows_to_go;
    }
    for (int i = 0; i < ns && ok; ++i) {
      const Component& cp = im.comp[order[i]];
      const int bw = ns == 1 ? 1 : cp.h, bh = ns == 1 ? mcu_rows : cp.v;
      for (int by = 0; by < bh && done[i] < cp.height; ++by, ++done[i]) {
        int* row = rows[i] + (done[i] & 1) * cp.width;
        const int* above = first[i] ? nullptr : rows[i] + ((done[i] + 1) & 1) * cp.width;
        undifference(diff[i] + static_cast<int64_t>(by) * units_w * bw, above, predictor, initial, cp.width, row);
        first[i] = false;
        uint8_t* out = samples + cp.offset + static_cast<int64_t>(done[i]) * cp.width;
        for (int x = 0; x < cp.width; ++x) out[x] = static_cast<uint8_t>(row[x] << al);
      }
    }
  }
  for (int i = 0; i < ns; ++i) {
    delete[] diff[i];
    delete[] rows[i];
  }
  return ok;
}

// One scan: Ns components, interleaved in MCUs when Ns > 1; one component's
// blocks (a lossless file: samples) in raster order over its own
// ceil(width / 8) x ceil(height / 8) blocks (width x height samples) when
// Ns == 1. `coef` and `samples` are null on the first pass (sizes only);
// else the one the file's kind decodes to is given. Damaged data decodes as
// libjpeg-turbo 3.1 decodes it (Reader: markers, restarts, the
// insufficient-data flag; the block decoders: bad codes, runs past a block
// or a band); libjpeg's errors refuse, each with its name.
inline bool read_scan(Reader& r, Image& im, int length, int16_t* coef, uint8_t* samples) {
  int ns = 0;
  if (!r.byte(&ns)) return false;
  if (ns < 1 || ns > im.components || length != 6 + 2 * ns)
    return r.fail("an SOS segment of the wrong shape (jdmarker.c JERR_BAD_LENGTH)");
  int order[MAX_COMPONENTS] = {0};
  for (int i = 0; i < ns; ++i) {
    int id = 0, t = 0;
    if (!r.byte(&id) || !r.byte(&t)) return false;
    int c = -1;
    for (int j = 0; j < im.components; ++j)
      if (im.comp[j].id == id) c = j;
    if (c < 0) return r.fail("a scan names a component the frame does not have (jdmarker.c JERR_BAD_COMPONENT_ID)");
    for (int k = 0; k < i; ++k)
      if (order[k] == c) return r.fail("a scan names a component twice (jdmarker.c JERR_BAD_COMPONENT_ID)");
    im.comp[c].td = t >> 4;
    im.comp[c].ta = t & 15;
    if (!im.arithmetic && (im.comp[c].td > 3 || im.comp[c].ta > 3))
      return r.fail("a scan uses a Huffman table number above 3 (jdhuff.c JERR_NO_HUFF_TABLE)");
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
  if (im.scans > 0 && !im.multiple_scans)
    return r.fail("a second scan in a file whose first scan coded every component (jdinput.c JERR_EOI_EXPECTED; "
                  "Pillow refuses the file)");
  if (++im.scans == 1) im.multiple_scans = ns < im.components || im.progressive;  // jdinput.c initial_setup
  int units_w = 0, units_h = 0;
  if (ns == 1) {
    const Component& cp = im.comp[order[0]];
    units_w = im.lossless ? cp.width : (cp.width + 7) / 8;
    units_h = im.lossless ? cp.height : (cp.height + 7) / 8;
  } else {
    units_w = im.mcus_w;
    units_h = im.mcus_h;
  }
  const char* bad_table =
      "a scan's Huffman table does not make a code, or holds a DC category above 15 (jdhuff.c JERR_BAD_HUFF_TABLE; "
      "Pillow refuses the file)";
  if (im.lossless) {  // jdlossls.c start_pass and jddiffct.c start_input_pass
    if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= 8)
      return r.fail("a lossless scan with a predictor outside 1 to 7, or Se, Ah or a point transform out of range "
                    "(jdlossls.c JERR_BAD_PROGRESSION)");
    if (im.restart_interval % units_w)
      return r.fail("a lossless restart interval that is not a whole number of MCU rows (jddiffct.c "
                    "JERR_BAD_RESTART)");
    for (int i = 0; i < ns; ++i) {
      Component& cp = im.comp[order[i]];
      if (cp.td > 3 || !im.dc[cp.td].defined)
        return r.fail("a scan uses a Huffman table that is not defined (jdhuff.c JERR_NO_HUFF_TABLE)");
      if (!table_ok(im.dc[cp.td], true, true)) return r.fail(bad_table);
      cp.scanned = true;
    }
    if (samples == nullptr) return true;  // sizes only
    if (!lossless_scan(r, im, order, ns, ss, al, units_w, units_h, samples)) return false;
    im.scanned_all = true;
    return r.end_scan();
  }
  // a sequential scan's Ss, Se, Ah and Al are not checked: jdhuff.c and
  // jdarith.c warn (JWRN_NOT_SEQUENTIAL) and decode a whole block, Al 0
  if (im.progressive && ((dc ? se != 0 : (ss > se || se > 63 || ns != 1)) || (ah != 0 && al != ah - 1) || al > 13))
    return r.fail("a progressive scan with a bad spectral selection or successive approximation (jdphuff.c "
                  "JERR_BAD_PROGRESSION)");
  const bool needs_dc = !im.progressive || (dc && ah == 0), needs_ac = !im.progressive || !dc;
  for (int i = 0; i < ns; ++i) {
    Component& cp = im.comp[order[i]];
    if (!im.arithmetic && ((needs_dc && !im.dc[cp.td].defined) || (needs_ac && !im.ac[cp.ta].defined)))
      return r.fail("a scan uses a Huffman table that is not defined (jdhuff.c JERR_NO_HUFF_TABLE)");
    if (!im.arithmetic && ((needs_dc && !table_ok(im.dc[cp.td], true, false)) ||
                           (needs_ac && !table_ok(im.ac[cp.ta], false, false))))
      return r.fail(bad_table);
    if (!cp.latched) {
      if (!im.quant_defined[cp.tq])
        return r.fail("a component's quantization table is not defined (jdinput.c JERR_NO_QUANT_TABLE)");
      for (int k = 0; k < 64; ++k) cp.quant[k] = im.quant[cp.tq][k];
      cp.latched = true;
    }
    // jdphuff.c start_pass_phuff_decoder's and jdarith.c start_pass's
    // progression check: an AC scan before the component's DC scan, or an Ah
    // that is not the bits known, only warns (JWRN_BOGUS_PROGRESSION), and
    // the scan decodes by its own Ah. The known bits of zig-zag places 0 to 9
    // before this scan are kept for block smoothing (prev_coef_bits; 0 at
    // the file's first scan)
    if (im.progressive) {
      for (int k = dc ? 0 : 1; k < SAVED_COEFS; ++k)
        cp.prev_bits[k] = im.scans > 1 ? cp.coef_bits[k] : 0;
      for (int k = ss; k <= se; ++k) cp.coef_bits[k] = al;
    }
    cp.last_dc = 0;
  }
  if (coef == nullptr) return true;  // sizes only
  ArithStats stats;
  if (im.arithmetic) {
    reset_arith_stats(im, order, ns, needs_dc, needs_ac, stats);
    r.start_arith();
  }
  r.start_bits();
  const int v0 = im.comp[order[0]].v;
  int blocks = 0;  // in an MCU
  for (int i = 0; i < ns; ++i) blocks += ns == 1 ? 1 : im.comp[order[i]].h * im.comp[order[i]].v;
  int64_t units = static_cast<int64_t>(units_w) * units_h;
  int to_go = im.restart_interval, next_rst = 0, eobrun = 0;
  for (int64_t u = 0; u < units; ++u) {
    int ux = static_cast<int>(u % units_w), uy = static_cast<int>(u / units_w);
    // jdcoefct.c consume_data: the last iMCU row an MCU began with data left
    if (!r.insufficient()) im.last_good_imcu = ns == 1 ? uy / v0 : uy;
    if (im.restart_interval && to_go == 0) {
      if (im.arithmetic) {
        if (!r.arith_restart(next_rst)) return false;
        reset_arith_stats(im, order, ns, needs_dc, needs_ac, stats);
      } else {
        if (!r.restart(next_rst)) return false;
        for (int i = 0; i < ns; ++i) im.comp[order[i]].last_dc = 0;
        eobrun = 0;
      }
      next_rst = (next_rst + 1) & 7;
      to_go = im.restart_interval;
    }
    --to_go;
    // out of data: the MCU is left as it is (a DC refinement reads zeros,
    // which change nothing); after a bad arithmetic code likewise
    if (im.arithmetic ? r.dead() : r.insufficient() && !(im.progressive && dc && ah != 0)) continue;
    auto mcu = [&]() {
      for (int i = 0; i < ns; ++i) {
        Component& cp = im.comp[order[i]];
        int bw = ns == 1 ? 1 : cp.h, bh = ns == 1 ? 1 : cp.v;
        for (int by = 0; by < bh; ++by) {
          for (int bx = 0; bx < bw; ++bx) {
            if (im.arithmetic && r.dead()) continue;
            int64_t row = static_cast<int64_t>(uy) * bh + by, col = static_cast<int64_t>(ux) * bw + bx;
            int16_t* block = coef + cp.offset + (row * cp.blocks_w + col) * 64;
            bool ok = im.arithmetic   ? arith_block(r, im, cp, stats, ss, se, ah, al, block)
                      : !im.progressive ? decode_block(r, im, cp, block)
                      : dc ? (ah == 0 ? decode_dc_first(r, im, cp, al, block) : decode_dc_refine(r, al, block))
                      : ah == 0 ? decode_ac_first(r, im.ac[cp.ta], ss, se, al, &eobrun, block)
                                : decode_ac_refine(r, im.ac[cp.ta], ss, se, al, &eobrun, block);
            if (!ok) return false;
          }
        }
      }
      return true;
    };
    if (im.arithmetic || im.progressive) {
      if (!mcu()) return false;
      continue;
    }
    // jdhuff.c decode_mcu: the fast path where no restart interval is set,
    // no marker waits and 512 bytes a block remain; an MCU whose fast decode
    // met a marker is decoded again by the slow path (the fill pattern, and
    // with it where a file's end is met, follows the path)
    const Reader::State start = r.save();
    int last_dc[MAX_COMPONENTS];
    for (int i = 0; i < ns; ++i) last_dc[i] = im.comp[order[i]].last_dc;
    for (bool slow = false;; slow = true) {
      const bool fast = !slow && !im.restart_interval && r.marker() == 0 && r.remaining() >= 512 * blocks;
      r.set_fast(fast);
      const bool ok = mcu();
      r.set_fast(false);
      if (!ok) return false;
      if (!fast || r.marker() == 0) break;
      r.restore(start);
      for (int i = 0; i < ns; ++i) im.comp[order[i]].last_dc = last_dc[i];
    }
  }
  im.scanned_all = true;
  return r.end_scan();
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
    for (int k = 0; k < SAVED_COEFS; ++k)
      if (cp.quant[NATURAL_ORDER[k]] == 0) return false;
    if (cp.coef_bits[0] < 0) return false;
    for (int k = 1; k < SAVED_COEFS; ++k) useful |= cp.coef_bits[k] != 0;
  }
  return useful;
}

// Parses the whole file. With `coef` and `samples` null, reads the header
// only (sizes, and checks every segment up to the first scan); otherwise
// decodes every scan into `coef` (a DCT file) or `samples` (a lossless
// file), which holds `capacity` zeros on entry and must hold exactly
// im.coefficients (checked at the first scan, before anything is written).
inline const char* parse_file(const uint8_t* data, int64_t length, Image& im, int16_t* coef, uint8_t* samples,
                              int64_t capacity) {
  Reader r(data, length);
  int a = 0, b = 0;
  if (!r.byte(&a) || !r.byte(&b) || a != 0xFF || b != 0xD8) return "not a JPEG file (no SOI marker)";
  const bool decode = coef != nullptr || samples != nullptr;
  bool frame = false, scanned = false;
  while (true) {
    // the next marker, whatever lies before it skipped (jdmarker.c
    // next_marker, JWRN_EXTRANEOUS_DATA), then libjpeg's read_markers
    if (!r.next_marker()) return r.error;
    const int m = r.take_marker();
    if (m == 0xD9) break;  // EOI
    if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;  // TEM, RSTn: no segment
    if (m == 0xD8) return "a second SOI marker (jdmarker.c JERR_SOI_DUPLICATE; Pillow refuses the file)";
    if (m < 0xC0 || m == 0xDE || m == 0xDF || (m >= 0xF0 && m <= 0xFD))
      return "a reserved marker (jdmarker.c JERR_UNKNOWN_MARKER, \"Unsupported marker type\"; Pillow refuses the "
             "file)";
    int len = 0;
    if (!r.word(&len)) return r.error;
    // APPn, COM and DNL skip what their length says, nothing where it is
    // below 2 (jdmarker.c skip_variable)
    if (len < 2 && !((m >= 0xE0 && m <= 0xEF) || m == 0xFE || m == 0xDC))
      return "a marker segment shorter than its length field (jdmarker.c JERR_BAD_LENGTH)";
    int64_t end = r.position() + (len < 2 ? 0 : len - 2);
    bool ok = true;
    if (m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC3 || m == 0xC9 || m == 0xCA) {
      if (frame) return "two frames in one file (jdmarker.c JERR_SOF_DUPLICATE)";
      im.progressive = m == 0xC2 || m == 0xCA;
      im.arithmetic = m == 0xC9 || m == 0xCA;
      im.lossless = m == 0xC3;
      ok = read_sof(r, im, len);
      frame = true;
    } else if (m == 0xCB) {
      return "a lossless arithmetic-coded JPEG (SOF11): libjpeg-turbo does not implement arithmetic coding in "
             "lossless mode, and Pillow refuses the file";
    } else if (m >= 0xC5 && m <= 0xCF && m != 0xC9 && m != 0xCA && m != 0xCC) {
      return "a hierarchical (differential) JPEG (SOF5 to SOF7, SOF13 to SOF15) or a JPG marker: libjpeg does not "
             "read it (JERR_SOF_UNSUPPORTED, \"Unsupported JPEG process\"), and Pillow refuses the file";
    } else if (m == 0xC4) {
      ok = read_dht(r, im, len);
    } else if (m == 0xCC) {
      ok = read_dac(r, im, len);
    } else if (m == 0xDB) {
      ok = read_dqt(r, im, len);
    } else if (m == 0xE0 || m == 0xEE) {
      ok = read_app(r, im, m, len);
    } else if (m == 0xDD) {
      ok = len == 4 && r.word(&im.restart_interval);
      if (!ok && !r.error) return "a DRI segment of the wrong length (jdmarker.c JERR_BAD_LENGTH)";
    } else if (m == 0xDA) {
      if (!frame) return "a scan before the frame header (jdmarker.c JERR_SOS_NO_SOF)";
      if (!decode) {
        r.seek(r.position());
        ok = read_scan(r, im, len, nullptr, nullptr);
        return ok ? nullptr : r.error;  // the header is known; the data is read on the second pass
      }
      if (im.lossless ? samples == nullptr : coef == nullptr)
        return im.lossless ? "a lossless JPEG: its samples are read by threedod_jpeg_samples"
                           : "a DCT JPEG: its coefficients are read by threedod_jpeg_coefficients";
      if (im.coefficients != capacity) return "the output buffer does not fit the header";
      ok = read_scan(r, im, len, coef, samples);
      scanned = true;
      if (!ok) return r.error;
      continue;  // read_scan left the reader at the next marker
    }
    if (!ok) return r.error;
    r.seek(end);  // APPn, COM, DNL and the rest of a segment read above
    if (r.position() > length) return TRUNCATED;
  }
  if (!frame) return "no frame header (jdapimin.c JERR_NO_IMAGE)";
  if (decode && !scanned) return "no scan (jdinput.c JERR_SOF_NO_SOS)";
  if (decode && im.lossless)
    for (int c = 0; c < im.components; ++c)
      if (!im.comp[c].scanned) return "a lossless JPEG with a component that no scan codes";
  return nullptr;
}

// The file, parsed by parse_file. A file of one scan is whole once its
// scan's last MCU is decoded: Pillow has every row then, and libjpeg's
// reading on to EOI (jpeg_finish_decompress) may meet the file's end, which
// only suspends it; any error there still refuses.
inline const char* parse(const uint8_t* data, int64_t length, Image& im, int16_t* coef, uint8_t* samples,
                         int64_t capacity = 0) {
  const char* err = parse_file(data, length, im, coef, samples, capacity);
  return err == TRUNCATED && im.scanned_all && !im.multiple_scans ? nullptr : err;
}

// The header of a JPEG: out[0..3] = width, height, components, colour space
// (ColorSpace, from the markers before the first scan); then per component
// k, out[4 + 8 k ..] = h, v, blocks_w, blocks_h, width, height, offset of its
// first coefficient, quantization table (a lossless file: blocks_w, blocks_h
// = width, height, the offset of its first sample, table 0); out[36] = 1 for
// a lossless file, else 0. Null, or the reason the file is refused.
inline const char* header(const uint8_t* data, int64_t length, int64_t* out) {
  Image im;
  const char* err = parse(data, length, im, nullptr, nullptr);
  if (err == nullptr) err = lossless_space_error(im);
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
    o[7] = im.lossless ? 0 : c.tq;
  }
  out[4 + 8 * MAX_COMPONENTS] = im.lossless;
  return nullptr;
}

// Decodes every scan of a DCT file into `coef` (`capacity` int16 zeros, the
// total of the header that `header` gave) in one pass over the file, and
// writes the quantization table each component latched (natural order) to
// quant[k * 64 ..]; smooth[0] = would_smooth, smooth[1] the last iMCU row an
// MCU of the last scan began with data left (last_good_imcu), smooth[2 + 10
// k + i] the coef_bits of component k's zig-zag place i (0 to 9: the lowest
// bit known, -1 none), and smooth[2 + 10 n + 10 k + i] those before the
// component's last scan, as jdcoefct.c smoothing_ok latches them (-1 for a
// file of one scan). Null, or the reason the file is refused.
inline const char* coefficients(const uint8_t* data, int64_t length, int16_t* coef, int64_t capacity,
                                uint16_t* quant, int32_t* smooth) {
  Image im;
  const char* err = parse(data, length, im, coef, nullptr, capacity);
  if (err) return err;
  smooth[0] = would_smooth(im);
  smooth[1] = im.last_good_imcu;
  for (int k = 0; k < im.components; ++k) {
    for (int i = 0; i < 64; ++i) quant[k * 64 + i] = im.comp[k].quant[i];
    for (int i = 0; i < SAVED_COEFS; ++i) {
      smooth[2 + SAVED_COEFS * k + i] = im.comp[k].coef_bits[i];
      smooth[2 + SAVED_COEFS * (im.components + k) + i] =
          i == 0 ? im.comp[k].coef_bits[0] : (im.scans > 1 ? im.comp[k].prev_bits[i] : -1);
    }
  }
  return nullptr;
}

// Decodes every scan of a lossless file into `samples` (`capacity` bytes,
// the total of the header that `header` gave): each component's samples
// at its own size, one after another. Null, or the reason the file is
// refused.
inline const char* lossless_samples(const uint8_t* data, int64_t length, uint8_t* samples, int64_t capacity) {
  Image im;
  const char* err = parse(data, length, im, nullptr, samples, capacity);
  return err ? err : lossless_space_error(im);
}

}  // namespace jpeg

// The host decoder's C interface, exported by the one source that includes
// this header (jpeg_decode.cu; the tests build it alone with a host
// compiler): threedod_jpeg_header, threedod_jpeg_coefficients (DCT files)
// and threedod_jpeg_samples (lossless files) return 0, or -1 with
// threedod_jpeg_error() saying why.
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
                               uint16_t* quant, int32_t* smooth) {
  const char* err = jpeg::coefficients(data, length, coef, capacity, quant, smooth);
  if (err) g_jpeg_error = err;
  return err ? -1 : 0;
}

int threedod_jpeg_samples(const uint8_t* data, int64_t length, uint8_t* samples, int64_t capacity) {
  const char* err = jpeg::lossless_samples(data, length, samples, capacity);
  if (err) g_jpeg_error = err;
  return err ? -1 : 0;
}

const char* threedod_jpeg_error() { return g_jpeg_error; }

}  // extern "C"
