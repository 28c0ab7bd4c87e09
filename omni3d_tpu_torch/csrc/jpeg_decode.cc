// Baseline (sequential, Huffman-coded, 8-bit) JPEG decoder with the
// arithmetic of libjpeg-turbo's default decompression, so that its output
// equals what libjpeg-turbo gives for BGR output:
//   * the accurate integer IDCT (jidctint.c: CONST_BITS 13, PASS1_BITS 2,
//     the 10-bit wrapping range-limit table of jdmaster.c);
//   * fancy upsampling (jdsample.c): the triangle filter for h2v1, h1v2 and
//     h2v2 chroma with its alternating rounding biases, edges replicated at
//     the component's own (downsampled) width and height; plain
//     replication for other integral factors and for h2 components of
//     width <= 2;
//   * YCbCr -> BGR through the fixed-point tables of jdcolor.c (16-bit
//     SCALEBITS); grey replicated to three channels; Adobe-RGB files as is.
// Restart intervals and sizes that are not a multiple of the MCU are read.
// Progressive, lossless, hierarchical, arithmetic-coded and 12-bit files are
// refused with a message naming the mode. The EXIF orientation tag of the
// first APP1 "Exif" segment is reported, not applied.
//
// C interface (ctypes):
//   int jpeg_header(data, n, &width, &height, &orientation, err, errlen)
//   int jpeg_decode_bgr(data, n, out, out_size, err, errlen)
// Both return 0, or -1 with a message in err.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  explicit Error(const std::string& m) : std::runtime_error(m) {}
};

const int kZigzag[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // overrun guard, as jpeg_natural_order's extra entries
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool present = false;
  uint8_t vals[256] = {0};
  int32_t maxcode[18];
  int32_t valptr[17];
  int32_t mincode[17];
  // 9-bit lookahead: code length (0 = longer) and value
  uint8_t look_len[512];
  uint8_t look_val[512];

  void build(const uint8_t* counts, const uint8_t* symbols, int nsym) {
    std::memcpy(vals, symbols, nsym);
    int code = 0, k = 0;
    std::memset(look_len, 0, sizeof(look_len));
    for (int len = 1; len <= 16; ++len) {
      valptr[len] = k;
      mincode[len] = code;
      for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
        if (len <= 9) {
          int shift = 9 - len;
          for (int f = 0; f < (1 << shift); ++f) {
            look_len[(code << shift) | f] = (uint8_t)len;
            look_val[(code << shift) | f] = vals[k];
          }
        }
      }
      maxcode[len] = counts[len - 1] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    present = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int dw = 0, dh = 0;    // downsampled width and height (samples)
  int bw = 0, bh = 0;    // blocks per row and column of the plane (MCU-padded)
  std::vector<uint8_t> plane;   // bw*8 x bh*8 samples
  int pred = 0;
};

class BitReader {
 public:
  BitReader(const uint8_t* d, size_t n, size_t pos) : d_(d), n_(n), pos_(pos) {}
  size_t pos() const { return pos_; }

  void fill(int need) {
    while (nbits_ < need) {
      uint32_t byte = 0;
      if (!marker_ && pos_ < n_) {
        byte = d_[pos_];
        if (byte == 0xFF) {
          uint8_t next = pos_ + 1 < n_ ? d_[pos_ + 1] : 0xD9;
          if (next == 0x00) {
            pos_ += 2;
          } else {
            marker_ = true;   // a marker: feed zeros from here, as libjpeg does
            byte = 0;
          }
        } else {
          ++pos_;
        }
      }
      acc_ = (acc_ << 8) | byte;
      nbits_ += 8;
    }
  }
  int peek(int n) { fill(n); return (int)((acc_ >> (nbits_ - n)) & ((1u << n) - 1)); }
  void skip(int n) { nbits_ -= n; }
  int get(int n) {
    if (n == 0) return 0;
    int v = peek(n);
    skip(n);
    return v;
  }
  int decode(const Huffman& t) {
    int look = peek(9);
    if (t.look_len[look]) {
      skip(t.look_len[look]);
      return t.look_val[look];
    }
    int code = 0, len = 0;
    do {
      code = (code << 1) | get(1);
      ++len;
    } while (len < 17 && code > t.maxcode[len]);
    if (len > 16) return 0;   // corrupt data: libjpeg warns and yields 0
    return t.vals[t.valptr[len] + code - t.mincode[len]];
  }
  // Byte-align and consume the restart marker (RSTn) that should follow.
  void restart() {
    acc_ = 0;
    nbits_ = 0;
    marker_ = false;
    while (pos_ + 1 < n_ && !(d_[pos_] == 0xFF && d_[pos_ + 1] >= 0xD0 && d_[pos_ + 1] <= 0xD7))
      ++pos_;
    if (pos_ + 1 < n_) pos_ += 2;
  }

 private:
  const uint8_t* d_;
  size_t n_, pos_;
  uint64_t acc_ = 0;
  int nbits_ = 0;
  bool marker_ = false;
};

inline int extend(int v, int t) { return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v; }

// jidctint.c jpeg_idct_islow
const int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
              FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
              FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;
const int CONST_BITS = 13, PASS1_BITS = 2;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

// The post-IDCT range limit: the value masked to 10 bits, read as signed,
// plus 128, clamped to [0, 255] (jdmaster.c prepare_range_limit_table).
inline uint8_t range_limit(int64_t x) {
  int t = (int)(x & 1023);
  if (t >= 512) t -= 1024;
  t += 128;
  return (uint8_t)(t < 0 ? 0 : (t > 255 ? 255 : t));
}

void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qt = q + c;
    int* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 && in[40] == 0 &&
        in[48] == 0 && in[56] == 0) {
      int dc = (int)in[0] * qt[0] * (1 << PASS1_BITS);
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = (int64_t)in[16] * qt[16], z3 = (int64_t)in[48] * qt[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)in[0] * qt[0];
    z3 = (int64_t)in[32] * qt[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)in[56] * qt[56];
    tmp1 = (int64_t)in[40] * qt[40];
    tmp2 = (int64_t)in[24] * qt[24];
    tmp3 = (int64_t)in[8] * qt[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int s = CONST_BITS - PASS1_BITS;
    w[0] = (int)descale(tmp10 + tmp3, s);
    w[56] = (int)descale(tmp10 - tmp3, s);
    w[8] = (int)descale(tmp11 + tmp2, s);
    w[48] = (int)descale(tmp11 - tmp2, s);
    w[16] = (int)descale(tmp12 + tmp1, s);
    w[40] = (int)descale(tmp12 - tmp1, s);
    w[24] = (int)descale(tmp13 + tmp0, s);
    w[32] = (int)descale(tmp13 - tmp0, s);
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 &&
        w[7] == 0) {
      uint8_t v = range_limit(descale(w[0], PASS1_BITS + 3));
      for (int c = 0; c < 8; ++c) o[c] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << CONST_BITS);
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int s = CONST_BITS + PASS1_BITS + 3;
    o[0] = range_limit(descale(tmp10 + tmp3, s));
    o[7] = range_limit(descale(tmp10 - tmp3, s));
    o[1] = range_limit(descale(tmp11 + tmp2, s));
    o[6] = range_limit(descale(tmp11 - tmp2, s));
    o[2] = range_limit(descale(tmp12 + tmp1, s));
    o[5] = range_limit(descale(tmp12 - tmp1, s));
    o[3] = range_limit(descale(tmp13 + tmp0, s));
    o[4] = range_limit(descale(tmp13 - tmp0, s));
  }
}

class Decoder {
 public:
  Decoder(const uint8_t* d, size_t n) : d_(d), n_(n) {}

  int width = 0, height = 0, orientation = 1;

  // Parse the markers up to the first scan; with decode, read every scan.
  void run(bool decode) {
    if (n_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8) throw Error("not a JPEG file (no SOI marker)");
    size_t pos = 2;
    bool frame = false;
    while (true) {
      while (pos < n_ && d_[pos] != 0xFF) ++pos;   // skip garbage between markers
      while (pos < n_ && d_[pos] == 0xFF) ++pos;
      if (pos >= n_) {
        if (frame && (!decode || scans_ > 0)) return;
        throw Error("truncated file: no image data");
      }
      int m = d_[pos++];
      if (m == 0xD9) {
        if (!frame) throw Error("no frame header before EOI");
        return;
      }
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      if (pos + 2 > n_) throw Error("truncated marker segment");
      size_t len = (d_[pos] << 8) | d_[pos + 1];
      if (len < 2 || pos + len > n_) throw Error("truncated marker segment");
      const uint8_t* seg = d_ + pos + 2;
      size_t slen = len - 2;
      pos += len;
      switch (m) {
        case 0xC0: case 0xC1:
          frame_header(seg, slen);
          frame = true;
          break;
        case 0xC2: case 0xC6: case 0xCA: case 0xCE:
          throw Error("progressive JPEG is not read (baseline and extended sequential only)");
        case 0xC3: case 0xC7: case 0xCB: case 0xCF:
          throw Error("lossless JPEG is not read (baseline and extended sequential only)");
        case 0xC5:
          throw Error("hierarchical (differential) JPEG is not read");
        case 0xC9: case 0xCD:
          throw Error("arithmetic-coded JPEG is not read (Huffman-coded files only)");
        case 0xC4: huffman_tables(seg, slen); break;
        case 0xDB: quant_tables(seg, slen); break;
        case 0xDD:
          if (slen < 2) throw Error("bad DRI segment");
          restart_interval_ = (seg[0] << 8) | seg[1];
          break;
        case 0xE0:
          if (slen >= 5 && std::memcmp(seg, "JFIF\0", 5) == 0) jfif_ = true;
          break;
        case 0xE1:
          if (!exif_seen_ && slen >= 6 && std::memcmp(seg, "Exif\0\0", 6) == 0) {
            exif_seen_ = true;
            exif(seg + 6, slen - 6);
          }
          break;
        case 0xEE:
          if (slen >= 12 && std::memcmp(seg, "Adobe", 5) == 0) {
            adobe_ = true;
            adobe_transform_ = seg[11];
          }
          break;
        case 0xDA:
          if (!frame) throw Error("scan before the frame header");
          if (!decode) return;
          pos = scan(seg, slen, pos);
          ++scans_;
          break;
        default:
          break;
      }
    }
  }

  void to_bgr(uint8_t* out) {
    int nc = (int)comps_.size();
    std::vector<std::vector<uint8_t>> full(nc);
    for (int c = 0; c < nc; ++c) upsample(comps_[c], full[c]);
    const size_t npix = (size_t)width * height;
    if (nc == 1) {
      const uint8_t* y = full[0].data();
      for (size_t i = 0; i < npix; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
      return;
    }
    if (nc != 3) throw Error("only 1- and 3-component JPEG is read");
    const uint8_t *p0 = full[0].data(), *p1 = full[1].data(), *p2 = full[2].data();
    if (is_rgb()) {
      for (size_t i = 0; i < npix; ++i) {
        out[3 * i] = p2[i];
        out[3 * i + 1] = p1[i];
        out[3 * i + 2] = p0[i];
      }
      return;
    }
    // jdcolor.c build_ycc_rgb_table / ycc_rgb_convert
    const int SCALEBITS = 16;
    const int32_t ONE_HALF = 1 << (SCALEBITS - 1);
    auto FIX = [](double x) { return (int32_t)(x * (1L << 16) + 0.5); };
    int cr_r[256], cb_b[256];
    int32_t cr_g[256], cb_g[256];
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = (-FIX(0.71414)) * x;
      cb_g[i] = (-FIX(0.34414)) * x + ONE_HALF;
    }
    auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    for (size_t i = 0; i < npix; ++i) {
      int y = p0[i], cb = p1[i], cr = p2[i];
      out[3 * i + 2] = clamp(y + cr_r[cr]);
      out[3 * i + 1] = clamp(y + (int)((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
      out[3 * i] = clamp(y + cb_b[cb]);
    }
  }

 private:
  const uint8_t* d_;
  size_t n_;
  std::vector<Component> comps_;
  Huffman dc_[4], ac_[4];
  uint16_t quant_[4][64];
  bool quant_present_[4] = {false, false, false, false};
  int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  int restart_interval_ = 0, scans_ = 0;
  bool jfif_ = false, adobe_ = false, exif_seen_ = false;
  int adobe_transform_ = 0;

  bool is_rgb() const {
    // jdapimin.c default_decompress_parms for three components
    if (jfif_) return false;
    if (adobe_) return adobe_transform_ == 0;
    return comps_[0].id == 82 && comps_[1].id == 71 && comps_[2].id == 66;
  }

  void frame_header(const uint8_t* s, size_t n) {
    if (!comps_.empty()) throw Error("more than one frame header");
    if (n < 6) throw Error("bad frame header");
    if (s[0] != 8) throw Error("only 8-bit JPEG is read (this file has " +
                               std::to_string(s[0]) + "-bit samples)");
    height = (s[1] << 8) | s[2];
    width = (s[3] << 8) | s[4];
    int nc = s[5];
    if (height == 0 || width == 0) throw Error("zero image size (DNL) is not read");
    if ((nc != 1 && nc != 3) || n < 6 + 3 * (size_t)nc)
      throw Error("only 1- and 3-component JPEG is read (this file has " +
                  std::to_string(nc) + ")");
    for (int c = 0; c < nc; ++c) {
      Component k;
      k.id = s[6 + 3 * c];
      k.h = s[7 + 3 * c] >> 4;
      k.v = s[7 + 3 * c] & 15;
      k.tq = s[8 + 3 * c];
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3) throw Error("bad sampling factors");
      hmax_ = std::max(hmax_, k.h);
      vmax_ = std::max(vmax_, k.v);
      comps_.push_back(k);
    }
    mcux_ = (width + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (height + 8 * vmax_ - 1) / (8 * vmax_);
    for (auto& k : comps_) {
      k.dw = (int)(((long)width * k.h + hmax_ - 1) / hmax_);
      k.dh = (int)(((long)height * k.v + vmax_ - 1) / vmax_);
      k.bw = mcux_ * k.h;
      k.bh = mcuy_ * k.v;
      k.plane.assign((size_t)k.bw * 8 * k.bh * 8, 0);
    }
  }

  void huffman_tables(const uint8_t* s, size_t n) {
    size_t i = 0;
    while (i < n) {
      if (i + 17 > n) throw Error("bad DHT segment");
      int tc = s[i] >> 4, th = s[i] & 15;
      if (tc > 1 || th > 3) throw Error("bad DHT segment");
      const uint8_t* counts = s + i + 1;
      int total = 0;
      for (int k = 0; k < 16; ++k) total += counts[k];
      if (total > 256 || i + 17 + total > n) throw Error("bad DHT segment");
      (tc == 0 ? dc_ : ac_)[th].build(counts, s + i + 17, total);
      i += 17 + total;
    }
  }

  void quant_tables(const uint8_t* s, size_t n) {
    size_t i = 0;
    while (i < n) {
      int pq = s[i] >> 4, tq = s[i] & 15;
      if (tq > 3 || pq > 1 || i + 1 + 64 * (pq + 1) > n) throw Error("bad DQT segment");
      for (int k = 0; k < 64; ++k)
        quant_[tq][kZigzag[k]] = pq ? (s[i + 1 + 2 * k] << 8) | s[i + 2 + 2 * k] : s[i + 1 + k];
      quant_present_[tq] = true;
      i += 1 + 64 * (pq + 1);
    }
  }

  void exif(const uint8_t* t, size_t n) {
    // TIFF header, IFD0, tag 0x0112 (orientation, SHORT)
    if (n < 8) return;
    bool le = t[0] == 'I' && t[1] == 'I';
    if (!le && !(t[0] == 'M' && t[1] == 'M')) return;
    auto u16 = [&](size_t o) -> unsigned {
      return le ? t[o] | (t[o + 1] << 8) : (t[o] << 8) | t[o + 1];
    };
    auto u32 = [&](size_t o) -> size_t {
      return le ? (size_t)t[o] | ((size_t)t[o + 1] << 8) | ((size_t)t[o + 2] << 16) |
                      ((size_t)t[o + 3] << 24)
                : ((size_t)t[o] << 24) | ((size_t)t[o + 1] << 16) | ((size_t)t[o + 2] << 8) |
                      (size_t)t[o + 3];
    };
    if (u16(2) != 42) return;
    size_t ifd = u32(4);
    if (ifd + 2 > n) return;
    unsigned count = u16(ifd);
    for (unsigned e = 0; e < count; ++e) {
      size_t o = ifd + 2 + 12 * (size_t)e;
      if (o + 12 > n) return;
      if (u16(o) == 0x0112 && u16(o + 2) == 3) {
        unsigned v = u16(o + 8);
        if (v >= 1 && v <= 8) orientation = (int)v;
        return;
      }
    }
  }

  void decode_block(BitReader& br, Component& k, int by, int bx) {
    int16_t coef[64];
    std::memset(coef, 0, sizeof(coef));
    const Huffman& dc = dc_[k.td];
    const Huffman& ac = ac_[k.ta];
    int t = br.decode(dc);
    int diff = t ? extend(br.get(t), t) : 0;
    k.pred += diff;
    coef[0] = (int16_t)k.pred;
    for (int i = 1; i < 64;) {
      int rs = br.decode(ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        i += r;
        coef[kZigzag[i]] = (int16_t)extend(br.get(s), s);
        ++i;
      } else {
        if (r != 15) break;
        i += 16;
      }
    }
    if (by >= k.bh || bx >= k.bw) return;
    const size_t stride = (size_t)k.bw * 8;
    idct_islow(coef, quant_[k.tq], k.plane.data() + (size_t)by * 8 * stride + (size_t)bx * 8,
               (int)stride);
  }

  size_t scan(const uint8_t* s, size_t n, size_t data_pos) {
    if (n < 1) throw Error("bad SOS segment");
    int ns = s[0];
    if (ns < 1 || ns > 4 || n < 4 + 2 * (size_t)ns) throw Error("bad SOS segment");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      int id = s[1 + 2 * i];
      Component* k = nullptr;
      for (auto& c : comps_)
        if (c.id == id) k = &c;
      if (!k) throw Error("scan names an unknown component");
      k->td = s[2 + 2 * i] >> 4;
      k->ta = s[2 + 2 * i] & 15;
      if (k->td > 3 || k->ta > 3 || !dc_[k->td].present || !ac_[k->ta].present)
        throw Error("scan uses an undefined Huffman table");
      if (!quant_present_[k->tq]) throw Error("component uses an undefined quantization table");
      k->pred = 0;
      sc.push_back(k);
    }
    int ss = s[1 + 2 * ns], se = s[2 + 2 * ns], ahal = s[3 + 2 * ns];
    if (ss != 0 || se != 63 || ahal != 0) throw Error("progressive scan parameters in a sequential file");
    BitReader br(d_, n_, data_pos);
    int units_x, units_y;
    if (ns == 1) {
      Component& k = *sc[0];
      units_x = (k.dw + 7) / 8;
      units_y = (k.dh + 7) / 8;
    } else {
      units_x = mcux_;
      units_y = mcuy_;
    }
    int left = restart_interval_;
    for (int my = 0; my < units_y; ++my) {
      for (int mx = 0; mx < units_x; ++mx) {
        if (restart_interval_ && left == 0) {
          br.restart();
          for (auto* k : sc) k->pred = 0;
          left = restart_interval_;
        }
        if (ns == 1) {
          decode_block(br, *sc[0], my, mx);
        } else {
          for (auto* k : sc)
            for (int v = 0; v < k->v; ++v)
              for (int h = 0; h < k->h; ++h) decode_block(br, *k, my * k->v + v, mx * k->h + h);
        }
        --left;
      }
    }
    return br.pos();
  }

  // One component upsampled to the image size (jdsample.c with fancy
  // upsampling on), into a width x height plane.
  void upsample(const Component& k, std::vector<uint8_t>& out) {
    const int W = width, H = height;
    const size_t stride = (size_t)k.bw * 8;
    const uint8_t* p = k.plane.data();
    const int fh = hmax_ / k.h, fv = vmax_ / k.v;
    if (hmax_ % k.h || vmax_ % k.v) throw Error("non-integral sampling factors are not read");
    out.assign((size_t)W * H, 0);
    auto at = [&](int y, int x) -> int {
      y = y < 0 ? 0 : (y >= k.dh ? k.dh - 1 : y);
      x = x < 0 ? 0 : (x >= k.dw ? k.dw - 1 : x);
      return p[(size_t)y * stride + x];
    };
    const bool fancy_h2 = fh == 2 && k.dw > 2;
    if (fh == 1 && fv == 1) {
      for (int y = 0; y < H; ++y) std::memcpy(&out[(size_t)y * W], p + (size_t)y * stride, W);
    } else if (fh == 2 && fv == 1 && fancy_h2) {
      for (int y = 0; y < H; ++y)
        for (int x = 0; x < W; ++x) {
          int j = x >> 1, c = at(y, j) * 3;
          out[(size_t)y * W + x] = (uint8_t)((x & 1) ? (c + at(y, j + 1) + 2) >> 2
                                                     : (c + at(y, j - 1) + 1) >> 2);
        }
    } else if (fh == 1 && fv == 2) {
      for (int y = 0; y < H; ++y) {
        int r = y >> 1, r1 = (y & 1) ? r + 1 : r - 1, bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < W; ++x)
          out[(size_t)y * W + x] = (uint8_t)((at(r, x) * 3 + at(r1, x) + bias) >> 2);
      }
    } else if (fh == 2 && fv == 2 && fancy_h2) {
      for (int y = 0; y < H; ++y) {
        int r = y >> 1, r1 = (y & 1) ? r + 1 : r - 1;
        auto colsum = [&](int j) { return at(r, j) * 3 + at(r1, j); };
        for (int x = 0; x < W; ++x) {
          int j = x >> 1, c = colsum(j) * 3;
          out[(size_t)y * W + x] = (uint8_t)((x & 1) ? (c + colsum(j + 1) + 7) >> 4
                                                     : (c + colsum(j - 1) + 8) >> 4);
        }
      }
    } else {
      // h2v1_upsample / h2v2_upsample / int_upsample: replication
      for (int y = 0; y < H; ++y)
        for (int x = 0; x < W; ++x)
          out[(size_t)y * W + x] = p[(size_t)(y / fv) * stride + x / fh];
    }
  }
};

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", msg.c_str());
}

}  // namespace

extern "C" int jpeg_header(const uint8_t* data, long n, int* width, int* height,
                           int* orientation, char* err, int errlen) {
  try {
    Decoder d(data, (size_t)n);
    d.run(false);
    *width = d.width;
    *height = d.height;
    *orientation = d.orientation;
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

extern "C" int jpeg_decode_bgr(const uint8_t* data, long n, uint8_t* out, long out_size,
                               char* err, int errlen) {
  try {
    Decoder d(data, (size_t)n);
    d.run(true);
    if ((long)d.width * d.height * 3 != out_size) throw Error("output buffer size mismatch");
    d.to_bgr(out);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}
