// Baseline JPEG codec of panodepth_torch: host C++17 with a plain C interface.
//
// The decoder reads baseline and extended sequential DCT files (SOF0/SOF1),
// 8-bit, Huffman-coded, with one component (gray) or three (YCbCr) at 4:4:4,
// 4:2:2 or 4:2:0, restart intervals, and DQT/DHT in any order.  It does what
// libjpeg(-turbo) does by default, so that it gives the pixels Pillow gives:
// the integer "islow" IDCT (jidctint.c), fancy (triangle) upsampling
// (h2v1_fancy_upsample / h2v2_fancy_upsample in jdsample.c) and the
// fixed-point YCbCr->RGB tables of jdcolor.c.  Everything else (progressive,
// arithmetic-coded, 12-bit, lossless, CMYK/YCCK, RGB-coded, other sampling)
// is refused with a message, never decoded approximately.  EXIF orientation
// is not applied.
//
// The encoder writes what libjpeg writes for Pillow's save(quality=q): a JFIF
// APP0, the quality-scaled standard tables (jpeg_set_quality, forced
// baseline), 4:2:0 for RGB and 1x1 for gray, the fixed-point RGB->YCbCr of
// jccolor.c, h2v2_downsample, edge replication and dummy blocks as
// jcprepct.c / jccoefct.c make them, the islow forward DCT (jfdctint.c), the
// reciprocal quantizer of jcdctmgr.c and the standard Huffman tables.
//
// Interface: every function returns 0 on success, else non-zero with a
// message in err.  Buffers handed out are malloc'd and released with
// pd_jpeg_free.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct JpegError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// zigzag position -> natural (row-major) position; 16 extra entries keep a
// corrupt run length inside the block, as libjpeg's jpeg_natural_order does
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// islow DCT constants (jidctint.c / jfdctint.c), CONST_BITS = 13
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t F_0_298631336 = 2446;
constexpr int32_t F_0_390180644 = 3196;
constexpr int32_t F_0_541196100 = 4433;
constexpr int32_t F_0_765366865 = 6270;
constexpr int32_t F_0_899976223 = 7373;
constexpr int32_t F_1_175875602 = 9633;
constexpr int32_t F_1_501321110 = 12299;
constexpr int32_t F_1_847759065 = 15137;
constexpr int32_t F_1_961570560 = 16069;
constexpr int32_t F_2_053119869 = 16819;
constexpr int32_t F_2_562915447 = 20995;
constexpr int32_t F_3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

// the post-IDCT range limit of jdmaster.c: index (v & 1023) of a table
// that clamps v + 128 to 0..255 for v in [-512, 511] and wraps beyond
inline uint8_t idct_limit(int32_t v) {
  int i = v & 1023;
  if (i < 128) return static_cast<uint8_t>(i + 128);
  if (i < 512) return 255;
  if (i < 896) return 0;
  return static_cast<uint8_t>(i - 896);
}

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// jpeg_idct_islow: dequantized coefficients (natural order) -> 8x8 samples
void idct_islow(const int16_t* coef, const int32_t* quant, uint8_t* out,
                size_t stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* in = coef + c;
    const int32_t* q = quant + c;
    int32_t* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
        in[40] == 0 && in[48] == 0 && in[56] == 0) {
      int32_t dc = (in[0] * q[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; r++) w[8 * r] = dc;
      continue;
    }
    int32_t z2 = in[16] * q[16], z3 = in[48] * q[48];
    int32_t z1 = (z2 + z3) * F_0_541196100;
    int32_t tmp2 = z1 + z3 * -F_1_847759065;
    int32_t tmp3 = z1 + z2 * F_0_765366865;
    z2 = in[0] * q[0];
    z3 = in[32] * q[32];
    int32_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int32_t tmp1 = (z2 - z3) * (1 << kConstBits);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = in[56] * q[56];
    tmp1 = in[40] * q[40];
    tmp2 = in[24] * q[24];
    tmp3 = in[8] * q[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * F_1_175875602;
    tmp0 *= F_0_298631336;
    tmp1 *= F_2_053119869;
    tmp2 *= F_3_072711026;
    tmp3 *= F_1_501321110;
    z1 *= -F_0_899976223;
    z2 *= -F_2_562915447;
    z3 *= -F_1_961570560;
    z4 *= -F_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits - kPass1Bits;
    w[0] = descale(tmp10 + tmp3, n);
    w[56] = descale(tmp10 - tmp3, n);
    w[8] = descale(tmp11 + tmp2, n);
    w[48] = descale(tmp11 - tmp2, n);
    w[16] = descale(tmp12 + tmp1, n);
    w[40] = descale(tmp12 - tmp1, n);
    w[24] = descale(tmp13 + tmp0, n);
    w[32] = descale(tmp13 - tmp0, n);
  }
  for (int r = 0; r < 8; r++) {
    const int32_t* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
        w[6] == 0 && w[7] == 0) {
      uint8_t v = idct_limit(descale(w[0], kPass1Bits + 3));
      for (int c = 0; c < 8; c++) o[c] = v;
      continue;
    }
    int32_t z2 = w[2], z3 = w[6];
    int32_t z1 = (z2 + z3) * F_0_541196100;
    int32_t tmp2 = z1 + z3 * -F_1_847759065;
    int32_t tmp3 = z1 + z2 * F_0_765366865;
    int32_t tmp0 = (w[0] + w[4]) * (1 << kConstBits);
    int32_t tmp1 = (w[0] - w[4]) * (1 << kConstBits);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * F_1_175875602;
    tmp0 *= F_0_298631336;
    tmp1 *= F_2_053119869;
    tmp2 *= F_3_072711026;
    tmp3 *= F_1_501321110;
    z1 *= -F_0_899976223;
    z2 *= -F_2_562915447;
    z3 *= -F_1_961570560;
    z4 *= -F_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = kConstBits + kPass1Bits + 3;
    o[0] = idct_limit(descale(tmp10 + tmp3, n));
    o[7] = idct_limit(descale(tmp10 - tmp3, n));
    o[1] = idct_limit(descale(tmp11 + tmp2, n));
    o[6] = idct_limit(descale(tmp11 - tmp2, n));
    o[2] = idct_limit(descale(tmp12 + tmp1, n));
    o[5] = idct_limit(descale(tmp12 - tmp1, n));
    o[3] = idct_limit(descale(tmp13 + tmp0, n));
    o[4] = idct_limit(descale(tmp13 - tmp0, n));
  }
}

// jpeg_fdct_islow on (sample - 128), in place, natural order, output x8
void fdct_islow(int32_t* d) {
  for (int r = 0; r < 8; r++) {
    int32_t* p = d + 8 * r;
    int32_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int32_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int32_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int32_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = (tmp10 + tmp11) * (1 << kPass1Bits);
    p[4] = (tmp10 - tmp11) * (1 << kPass1Bits);
    int32_t z1 = (tmp12 + tmp13) * F_0_541196100;
    const int n = kConstBits - kPass1Bits;
    p[2] = descale(z1 + tmp13 * F_0_765366865, n);
    p[6] = descale(z1 + tmp12 * -F_1_847759065, n);
    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int32_t z5 = (z3 + z4) * F_1_175875602;
    tmp4 *= F_0_298631336;
    tmp5 *= F_2_053119869;
    tmp6 *= F_3_072711026;
    tmp7 *= F_1_501321110;
    z1 *= -F_0_899976223;
    z2 *= -F_2_562915447;
    z3 *= -F_1_961570560;
    z4 *= -F_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = descale(tmp4 + z1 + z3, n);
    p[5] = descale(tmp5 + z2 + z4, n);
    p[3] = descale(tmp6 + z2 + z3, n);
    p[1] = descale(tmp7 + z1 + z4, n);
  }
  for (int c = 0; c < 8; c++) {
    int32_t* p = d + c;
    int32_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int32_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int32_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int32_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = descale(tmp10 + tmp11, kPass1Bits);
    p[32] = descale(tmp10 - tmp11, kPass1Bits);
    int32_t z1 = (tmp12 + tmp13) * F_0_541196100;
    const int n = kConstBits + kPass1Bits;
    p[16] = descale(z1 + tmp13 * F_0_765366865, n);
    p[48] = descale(z1 + tmp12 * -F_1_847759065, n);
    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int32_t z5 = (z3 + z4) * F_1_175875602;
    tmp4 *= F_0_298631336;
    tmp5 *= F_2_053119869;
    tmp6 *= F_3_072711026;
    tmp7 *= F_1_501321110;
    z1 *= -F_0_899976223;
    z2 *= -F_2_562915447;
    z3 *= -F_1_961570560;
    z4 *= -F_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = descale(tmp4 + z1 + z3, n);
    p[40] = descale(tmp5 + z2 + z4, n);
    p[24] = descale(tmp6 + z2 + z3, n);
    p[8] = descale(tmp7 + z1 + z4, n);
  }
}

// ---------------------------------------------------------------------------
// Huffman tables

struct HuffSpec {
  uint8_t bits[17] = {0};  // bits[l]: number of codes of length l
  uint8_t vals[256] = {0};
  int count = 0;
};

// canonical code sizes and codes of a table (jpeg_make_{c,d}_derived_tbl)
void canonical_codes(const HuffSpec& s, std::vector<int>& size,
                     std::vector<uint32_t>& code) {
  size.clear();
  code.clear();
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < s.bits[l]; i++) size.push_back(l);
  uint32_t c = 0;
  int si = size.empty() ? 0 : size[0];
  for (size_t p = 0; p < size.size();) {
    while (p < size.size() && size[p] == si) {
      code.push_back(c++);
      p++;
    }
    if (c >= (1u << si)) throw JpegError("bad Huffman table");
    c <<= 1;
    si++;
  }
}

struct DecodeTable {
  bool defined = false;
  uint8_t vals[256] = {0};
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t look[512];  // 9-bit lookahead: (length << 8) | value, 0 if longer

  void build(const HuffSpec& s, bool dc) {
    std::vector<int> size;
    std::vector<uint32_t> code;
    canonical_codes(s, size, code);
    std::memcpy(vals, s.vals, sizeof(vals));
    int p = 0;
    for (int l = 1; l <= 16; l++) {
      if (s.bits[l]) {
        valoffset[l] = p - static_cast<int32_t>(code[p]);
        p += s.bits[l];
        maxcode[l] = static_cast<int32_t>(code[p - 1]);
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0xFFFFF;
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= 9; l++) {
      for (int i = 0; i < s.bits[l]; i++, p++) {
        uint32_t first = code[p] << (9 - l);
        for (uint32_t k = 0; k < (1u << (9 - l)); k++)
          look[first + k] = static_cast<uint16_t>((l << 8) | s.vals[p]);
      }
    }
    if (dc)
      for (int i = 0; i < s.count; i++)
        if (s.vals[i] > 15) throw JpegError("bad Huffman table");
    defined = true;
  }
};

// ---------------------------------------------------------------------------
// entropy-coded segment reader

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t pos;           // next byte of the segment
  uint64_t buf = 0;     // bits, most significant first
  int nbits = 0;
  int pad = 0;          // zero bits appended after a marker or the end
  bool stopped = false; // a marker (or the end of the data) was reached

  void fill() {
    while (nbits <= 56) {
      uint32_t byte = 0;
      if (!stopped) {
        if (pos >= size) {
          stopped = true;
        } else if (data[pos] != 0xFF) {
          byte = data[pos++];
        } else {
          size_t q = pos + 1;
          while (q < size && data[q] == 0xFF) q++;  // fill bytes
          if (q < size && data[q] == 0x00) {
            byte = 0xFF;  // stuffed
            pos = q + 1;
          } else {
            stopped = true;  // pos stays on the marker's first 0xFF
          }
        }
      }
      if (stopped) pad += 8;
      buf |= static_cast<uint64_t>(byte) << (56 - nbits);
      nbits += 8;
    }
  }
  uint32_t peek(int n) {
    if (nbits < n) fill();
    return static_cast<uint32_t>(buf >> (64 - n));
  }
  void consume(int n) {
    buf <<= n;
    nbits -= n;
    if (nbits < pad)
      throw JpegError("truncated or corrupt entropy-coded data");
  }
  int32_t get(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    consume(n);
    return static_cast<int32_t>(v);
  }
  int decode(const DecodeTable& t) {
    if (nbits < 16) fill();
    uint16_t e = t.look[buf >> 55];
    if (e) {
      consume(e >> 8);
      return e & 0xFF;
    }
    int l = 10;
    int32_t code = static_cast<int32_t>(buf >> (64 - l));
    while (l <= 16 && code > t.maxcode[l]) {
      l++;
      code = static_cast<int32_t>(buf >> (64 - l));
    }
    if (l > 16) throw JpegError("corrupt Huffman code");
    consume(l);
    return t.vals[t.valoffset[l] + code];
  }
  // drop the buffered bits and return the position of the next marker
  size_t next_marker() {
    buf = 0;
    nbits = pad = 0;
    stopped = false;
    while (pos + 1 < size &&
           !(data[pos] == 0xFF && data[pos + 1] != 0x00 && data[pos + 1] != 0xFF))
      pos++;
    if (pos + 1 >= size) pos = size;  // no marker: the data ends here
    return pos;
  }
};

inline int32_t extend(int32_t v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// ---------------------------------------------------------------------------
// decoder

struct Component {
  int id, h, v, tq;
  int width, height;      // samples of the component (downsampled size)
  size_t stride, rows;    // plane size, whole MCUs
  std::vector<uint8_t> plane;
  int32_t quant[64];      // latched at the start of its scan
  bool scanned = false;
};

struct Decoder {
  const uint8_t* d = nullptr;
  size_t n = 0;
  size_t pos = 0;
  int32_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  DecodeTable dc[4], ac[4];
  int restart_interval = 0;
  bool saw_frame = false, saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;
  int width = 0, height = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  std::vector<Component> comps;

  uint8_t byte() {
    if (pos >= n) throw JpegError("truncated file");
    return d[pos++];
  }
  int u16() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  void read_dqt(size_t end) {
    while (pos < end) {
      int pq_tq = byte();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) throw JpegError("bad DQT");
      for (int k = 0; k < 64; k++)
        qt[tq][kNatural[k]] = pq ? u16() : byte();
      qt_defined[tq] = true;
    }
  }

  void read_dht(size_t end) {
    while (pos < end) {
      int tc_th = byte();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) throw JpegError("bad DHT");
      HuffSpec s;
      for (int l = 1; l <= 16; l++) {
        s.bits[l] = byte();
        s.count += s.bits[l];
      }
      if (s.count > 256) throw JpegError("bad Huffman table");
      for (int i = 0; i < s.count; i++) s.vals[i] = byte();
      (tc ? ac[th] : dc[th]).build(s, tc == 0);
    }
  }

  void read_sof() {
    if (saw_frame) throw JpegError("more than one frame header");
    int precision = byte();
    if (precision != 8)
      throw JpegError(std::to_string(precision) +
                      "-bit samples are not supported (8-bit only)");
    height = u16();
    width = u16();
    int nc = byte();
    if (height == 0)
      throw JpegError("image height defined by a DNL marker is not supported");
    if (width == 0) throw JpegError("image width is 0");
    if (nc == 4)
      throw JpegError("four-component (CMYK/YCCK) JPEG is not supported");
    if (nc != 1 && nc != 3)
      throw JpegError(std::to_string(nc) + "-component JPEG is not supported");
    comps.resize(nc);
    for (auto& c : comps) {
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        throw JpegError("bad frame header");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      c.width = static_cast<int>((static_cast<int64_t>(width) * c.h + hmax - 1) / hmax);
      c.height = static_cast<int>((static_cast<int64_t>(height) * c.v + vmax - 1) / vmax);
      c.stride = static_cast<size_t>(mcux) * c.h * 8;
      c.rows = static_cast<size_t>(mcuy) * c.v * 8;
      c.plane.assign(c.stride * c.rows, 0);
    }
    saw_frame = true;
  }

  void read_app(int m, size_t end) {
    size_t len = end - pos;
    if (m == 0xE0 && len >= 5 && std::memcmp(d + pos, "JFIF\0", 5) == 0)
      saw_jfif = true;
    if (m == 0xEE && len >= 12 && std::memcmp(d + pos, "Adobe", 5) == 0) {
      saw_adobe = true;
      adobe_transform = d[pos + 11];
    }
    pos = end;
  }

  void decode_block(BitReader& br, Component& c, const DecodeTable& dct,
                    const DecodeTable& act, int& pred, int brow, int bcol) {
    int16_t coef[64] = {0};
    int s = br.decode(dct);
    if (s) s = extend(br.get(s), s);
    pred += s;
    coef[0] = static_cast<int16_t>(pred);
    for (int k = 1; k < 64; k++) {
      int rs = br.decode(act);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        coef[kNatural[k]] = static_cast<int16_t>(extend(br.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    idct_islow(coef, c.quant,
               c.plane.data() + static_cast<size_t>(brow) * 8 * c.stride + bcol * 8,
               c.stride);
  }

  void read_scan(size_t end) {
    if (!saw_frame) throw JpegError("scan before the frame header");
    int ns = byte();
    if (ns < 1 || ns > static_cast<int>(comps.size())) throw JpegError("bad scan header");
    std::vector<Component*> sc;
    std::vector<int> td, ta;
    for (int i = 0; i < ns; i++) {
      int id = byte(), t = byte();
      Component* found = nullptr;
      for (auto& c : comps)
        if (c.id == id) found = &c;
      if (!found) throw JpegError("scan names an unknown component");
      if ((t >> 4) > 3 || (t & 15) > 3) throw JpegError("bad scan header");
      sc.push_back(found);
      td.push_back(t >> 4);
      ta.push_back(t & 15);
    }
    int ss = byte(), se = byte(), ahal = byte();
    if (ss != 0 || se != 63 || ahal != 0)
      throw JpegError("bad spectral selection for a sequential scan");
    pos = end;
    for (int i = 0; i < ns; i++) {
      Component& c = *sc[i];
      if (!qt_defined[c.tq]) throw JpegError("quantization table not defined");
      if (!dc[td[i]].defined || !ac[ta[i]].defined)
        throw JpegError("Huffman table not defined");
      std::memcpy(c.quant, qt[c.tq], sizeof(c.quant));
      c.scanned = true;
    }
    BitReader br{d, n, pos};
    std::vector<int> pred(ns, 0);
    int restarts_left = restart_interval, next_rst = 0;
    auto restart = [&]() {
      size_t m = br.next_marker();
      if (m + 1 >= n || d[m + 1] != 0xD0 + next_rst)
        throw JpegError("missing restart marker");
      br.pos = m + 2;
      next_rst = (next_rst + 1) & 7;
      std::fill(pred.begin(), pred.end(), 0);
      restarts_left = restart_interval;
    };
    if (ns == 1) {
      Component& c = *sc[0];
      int bw = (c.width + 7) / 8, bh = (c.height + 7) / 8;
      for (int by = 0; by < bh; by++)
        for (int bx = 0; bx < bw; bx++) {
          if (restart_interval) {
            if (restarts_left == 0) restart();
            restarts_left--;
          }
          decode_block(br, c, dc[td[0]], ac[ta[0]], pred[0], by, bx);
        }
    } else {
      for (int my = 0; my < mcuy; my++)
        for (int mx = 0; mx < mcux; mx++) {
          if (restart_interval) {
            if (restarts_left == 0) restart();
            restarts_left--;
          }
          for (int i = 0; i < ns; i++) {
            Component& c = *sc[i];
            for (int by = 0; by < c.v; by++)
              for (int bx = 0; bx < c.h; bx++)
                decode_block(br, c, dc[td[i]], ac[ta[i]], pred[i],
                             my * c.v + by, mx * c.h + bx);
          }
        }
    }
    pos = br.next_marker();
  }

  void parse() {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) throw JpegError("not a JPEG file");
    pos = 2;
    for (;;) {
      if (pos >= n) {
        if (!comps.empty() && all_scanned()) return;  // EOI missing
        throw JpegError("truncated file");
      }
      if (byte() != 0xFF) throw JpegError("bad marker");
      int m = byte();
      while (m == 0xFF) m = byte();
      if (m == 0xD9) return;
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;  // TEM, stray RSTn
      int len = u16();
      if (len < 2 || pos + len - 2 > n) throw JpegError("truncated marker segment");
      size_t end = pos + len - 2;
      switch (m) {
        case 0xC0:
        case 0xC1: read_sof(); break;
        case 0xC2:
        case 0xC6:
          throw JpegError("progressive JPEG is not supported (baseline only)");
        case 0xC3:
        case 0xC7: throw JpegError("lossless JPEG is not supported");
        case 0xC5: throw JpegError("hierarchical JPEG is not supported");
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
        case 0xCC:
          throw JpegError("arithmetic-coded JPEG is not supported");
        case 0xC4: read_dht(end); break;
        case 0xDB: read_dqt(end); break;
        case 0xDD: restart_interval = u16(); break;
        case 0xDA: read_scan(end); continue;
        default:
          if (m >= 0xE0 && m <= 0xEF) {
            read_app(m, end);
          } else if (m != 0xFE && m != 0xDC) {
            char buf[64];
            std::snprintf(buf, sizeof(buf), "unsupported marker 0x%02X", m);
            throw JpegError(buf);
          }
      }
      pos = end;
    }
  }

  bool all_scanned() const {
    for (auto& c : comps)
      if (!c.scanned) return false;
    return true;
  }

  // the component's samples at full resolution (fancy upsampling)
  std::vector<uint8_t> upsample(const Component& c) const {
    int rh = hmax / c.h, rv = vmax / c.v;
    int cw = c.width, ch = c.height;
    size_t ow = static_cast<size_t>(cw) * rh;
    std::vector<uint8_t> out(ow * ch * rv);
    auto in = [&](int y, int x) -> int { return c.plane[y * c.stride + x]; };
    if (rh == 2 && rv == 1) {
      for (int y = 0; y < ch; y++) {
        uint8_t* o = out.data() + y * ow;
        if (cw <= 2) {  // h2v1_upsample
          for (int x = 0; x < cw; x++) o[2 * x] = o[2 * x + 1] = in(y, x);
          continue;
        }
        for (int x = 0; x < cw; x++) {
          int v3 = in(y, x) * 3;
          int left = in(y, x > 0 ? x - 1 : 0), right = in(y, x < cw - 1 ? x + 1 : cw - 1);
          o[2 * x] = x == 0 ? in(y, 0) : static_cast<uint8_t>((v3 + left + 1) >> 2);
          o[2 * x + 1] = x == cw - 1 ? in(y, x) : static_cast<uint8_t>((v3 + right + 2) >> 2);
        }
      }
    } else if (rh == 2 && rv == 2) {
      for (int y = 0; y < ch; y++) {
        for (int v = 0; v < 2; v++) {
          uint8_t* o = out.data() + (2 * y + v) * ow;
          int yn = v == 0 ? (y > 0 ? y - 1 : 0) : (y < ch - 1 ? y + 1 : ch - 1);
          if (cw <= 2) {  // h2v2_upsample
            for (int x = 0; x < cw; x++) o[2 * x] = o[2 * x + 1] = in(y, x);
            continue;
          }
          auto colsum = [&](int x) { return in(y, x) * 3 + in(yn, x); };
          for (int x = 0; x < cw; x++) {
            int t = colsum(x);
            int last = colsum(x > 0 ? x - 1 : 0), next = colsum(x < cw - 1 ? x + 1 : cw - 1);
            o[2 * x] = static_cast<uint8_t>(x == 0 ? (t * 4 + 8) >> 4 : (t * 3 + last + 8) >> 4);
            o[2 * x + 1] = static_cast<uint8_t>(x == cw - 1 ? (t * 4 + 7) >> 4
                                                            : (t * 3 + next + 7) >> 4);
          }
        }
      }
    } else {
      for (int y = 0; y < ch; y++) std::memcpy(out.data() + y * ow, &c.plane[y * c.stride], cw);
    }
    return out;
  }

  std::vector<uint8_t> pixels(int& channels) {
    if (!saw_frame) throw JpegError("no frame header");
    if (!all_scanned()) throw JpegError("a component has no scan");
    const size_t hw = static_cast<size_t>(height) * width;
    if (comps.size() == 1) {
      channels = 1;
      std::vector<uint8_t> out(hw);
      const Component& c = comps[0];  // c.width == width: its h is hmax
      for (int y = 0; y < height; y++)
        std::memcpy(out.data() + static_cast<size_t>(y) * width, &c.plane[y * c.stride], width);
      return out;
    }
    bool rgb_coded = saw_jfif ? false
                   : saw_adobe ? adobe_transform == 0
                   : (comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66);
    if (rgb_coded) throw JpegError("RGB-coded (not YCbCr) JPEG is not supported");
    const Component &Y = comps[0], &Cb = comps[1], &Cr = comps[2];
    if (Y.h != hmax || Y.v != vmax || Cb.h != Cr.h || Cb.v != Cr.v ||
        hmax % Cb.h || vmax % Cb.v)
      throw JpegError("unsupported chroma subsampling");
    int rh = hmax / Cb.h, rv = vmax / Cb.v;
    if (!((rh == 1 && rv == 1) || (rh == 2 && rv == 1) || (rh == 2 && rv == 2)))
      throw JpegError("unsupported chroma subsampling (4:4:4, 4:2:2 and 4:2:0 only)");
    std::vector<uint8_t> cb = upsample(Cb), cr = upsample(Cr);
    size_t cstride = static_cast<size_t>(Cb.width) * rh;
    // jdcolor.c build_ycc_rgb_table, SCALEBITS = 16
    int cr_r[256], cb_b[256];
    int32_t cr_g[256], cb_g[256];
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = (91881 * x + 32768) >> 16;   // FIX(1.40200)
      cb_b[i] = (116130 * x + 32768) >> 16;  // FIX(1.77200)
      cr_g[i] = -46802 * x;                  // -FIX(0.71414)
      cb_g[i] = -22554 * x + 32768;          // -FIX(0.34414), + ONE_HALF
    }
    channels = 3;
    std::vector<uint8_t> out(hw * 3);
    for (int y = 0; y < height; y++) {
      const uint8_t* yp = &Y.plane[y * Y.stride];
      const uint8_t* bp = cb.data() + y * cstride;
      const uint8_t* rp = cr.data() + y * cstride;
      uint8_t* o = out.data() + static_cast<size_t>(y) * width * 3;
      for (int x = 0; x < width; x++) {
        int yy = yp[x], b = bp[x], r = rp[x];
        o[3 * x] = clamp255(yy + cr_r[r]);
        o[3 * x + 1] = clamp255(yy + ((cb_g[b] + cr_g[r]) >> 16));
        o[3 * x + 2] = clamp255(yy + cb_b[b]);
      }
    }
    return out;
  }
};

// ---------------------------------------------------------------------------
// encoder

const uint8_t kStdLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kStdChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdLumaAcBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kStdLumaAcVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kStdChromaAcBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kStdChromaAcVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// jcparam.c std_luminance_quant_tbl / std_chrominance_quant_tbl (natural order)
const int kStdLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kStdChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

HuffSpec make_spec(const uint8_t* bits, const uint8_t* vals) {
  HuffSpec s;
  for (int l = 1; l <= 16; l++) {
    s.bits[l] = bits[l];
    s.count += bits[l];
  }
  std::memcpy(s.vals, vals, s.count);
  return s;
}

struct EncodeTable {
  uint32_t code[256];
  uint8_t size[256];
  explicit EncodeTable(const HuffSpec& s) {
    std::memset(size, 0, sizeof(size));
    std::vector<int> sz;
    std::vector<uint32_t> cd;
    canonical_codes(s, sz, cd);
    for (size_t p = 0; p < sz.size(); p++) {
      code[s.vals[p]] = cd[p];
      size[s.vals[p]] = static_cast<uint8_t>(sz[p]);
    }
  }
};

// jcdctmgr.c compute_reciprocal + quantize (16-bit DCTELEM, as built with SIMD)
struct Divisor {
  uint32_t recip, corr;
  int shift;  // total right shift of (x + corr) * recip
};

Divisor reciprocal(uint32_t divisor) {
  int b = 31 - __builtin_clz(divisor);
  int r = 16 + b;
  uint64_t fq = (uint64_t{1} << r) / divisor;
  uint64_t fr = (uint64_t{1} << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2u) {
    c++;
  } else {
    fq++;
  }
  return Divisor{static_cast<uint32_t>(fq), c, r};
}

inline int16_t quantize(int32_t x, const Divisor& q) {
  uint32_t a = static_cast<uint32_t>(x < 0 ? -x : x);
  uint32_t v = static_cast<uint32_t>((static_cast<uint64_t>(a + q.corr) * q.recip) >> q.shift);
  return static_cast<int16_t>(x < 0 ? -static_cast<int32_t>(v) : static_cast<int32_t>(v));
}

struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t buf = 0;
  int nbits = 0;
  void put(uint32_t bits, int n) {
    if (n == 0) return;
    buf = (buf << n) | (bits & ((1u << n) - 1));
    nbits += n;
    while (nbits >= 8) {
      uint8_t b = static_cast<uint8_t>(buf >> (nbits - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      nbits -= 8;
    }
  }
  void flush() {  // pad the last byte with 1-bits
    if (nbits) put(0x7F, 8 - nbits);
  }
};

struct EncComponent {
  int id, h, v, tq, table;
  int bw, bh;                 // blocks with data (width_in_blocks...)
  size_t stride;              // plane: whole MCUs, edges replicated
  std::vector<uint8_t> plane;
  Divisor div[64];
  int last_dc = 0;
};

void encode_block(const EncComponent& c, int by, int bx, int16_t* q) {
  int32_t w[64];
  const uint8_t* p = c.plane.data() + static_cast<size_t>(by) * 8 * c.stride + bx * 8;
  for (int r = 0; r < 8; r++)
    for (int k = 0; k < 8; k++) w[8 * r + k] = static_cast<int32_t>(p[r * c.stride + k]) - 128;
  fdct_islow(w);
  for (int i = 0; i < 64; i++) q[i] = quantize(w[i], c.div[i]);
}

void emit_block(BitWriter& bw, const int16_t* q, int& last_dc,
                const EncodeTable& dct, const EncodeTable& act) {
  int temp = q[0] - last_dc, temp2 = temp;
  last_dc = q[0];
  if (temp < 0) {
    temp = -temp;
    temp2--;
  }
  int nbits = 0;
  while (temp) {
    nbits++;
    temp >>= 1;
  }
  bw.put(dct.code[nbits], dct.size[nbits]);
  bw.put(static_cast<uint32_t>(temp2), nbits);
  int r = 0;
  for (int k = 1; k < 64; k++) {
    temp = q[kNatural[k]];
    if (temp == 0) {
      r++;
      continue;
    }
    while (r > 15) {
      bw.put(act.code[0xF0], act.size[0xF0]);
      r -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    nbits = 1;
    while ((temp >>= 1)) nbits++;
    int i = (r << 4) + nbits;
    bw.put(act.code[i], act.size[i]);
    bw.put(static_cast<uint32_t>(temp2), nbits);
    r = 0;
  }
  if (r > 0) bw.put(act.code[0], act.size[0]);
}

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(static_cast<uint8_t>(v >> 8));
  o.push_back(static_cast<uint8_t>(v & 0xFF));
}

std::vector<uint8_t> encode(const uint8_t* px, int height, int width,
                            int channels, int quality) {
  if (channels != 1 && channels != 3) throw JpegError("encode takes 1 or 3 channels");
  if (width < 1 || height < 1 || width > 65535 || height > 65535)
    throw JpegError("image size out of range for JPEG");
  // jpeg_quality_scaling + jpeg_add_quant_table(force_baseline = TRUE)
  int qs = quality < 1 ? 1 : (quality > 100 ? 100 : quality);
  qs = qs < 50 ? 5000 / qs : 200 - qs * 2;
  int qtab[2][64];
  for (int i = 0; i < 64; i++) {
    for (int t = 0; t < 2; t++) {
      long v = ((t ? kStdChromaQuant : kStdLumaQuant)[i] * static_cast<long>(qs) + 50) / 100;
      qtab[t][i] = static_cast<int>(v < 1 ? 1 : (v > 255 ? 255 : v));
    }
  }
  const int hmax = channels == 3 ? 2 : 1;
  const int mcux = (width + 8 * hmax - 1) / (8 * hmax);
  const int mcuy = (height + 8 * hmax - 1) / (8 * hmax);
  std::vector<EncComponent> comps(channels);
  for (int ci = 0; ci < channels; ci++) {
    EncComponent& c = comps[ci];
    c.id = ci + 1;
    c.h = c.v = ci == 0 ? hmax : 1;
    c.tq = c.table = ci == 0 ? 0 : 1;
    int cw = (width * c.h + hmax - 1) / hmax, ch = (height * c.v + hmax - 1) / hmax;
    c.bw = (cw + 7) / 8;
    c.bh = (ch + 7) / 8;
    c.stride = static_cast<size_t>(mcux) * c.h * 8;
    c.plane.assign(c.stride * static_cast<size_t>(mcuy) * c.v * 8, 0);
    for (int i = 0; i < 64; i++) c.div[i] = reciprocal(static_cast<uint32_t>(qtab[c.tq][i]) << 3);
  }
  const size_t prow = static_cast<size_t>(mcuy) * hmax * 8;  // full-res rows padded
  if (channels == 1) {
    EncComponent& c = comps[0];
    for (size_t y = 0; y < prow; y++) {
      const uint8_t* src = px + std::min<size_t>(y, height - 1) * width;
      uint8_t* dst = c.plane.data() + y * c.stride;
      for (size_t x = 0; x < c.stride; x++) dst[x] = src[std::min<size_t>(x, width - 1)];
    }
  } else {
    // jccolor.c rgb_ycc_start, SCALEBITS = 16
    int32_t tab[8 * 256];
    for (int i = 0; i < 256; i++) {
      tab[i] = 19595 * i;                         // FIX(0.29900)
      tab[i + 256] = 38470 * i;                   // FIX(0.58700)
      tab[i + 512] = 7471 * i + 32768;            // FIX(0.11400), ONE_HALF
      tab[i + 768] = -11059 * i;                  // -FIX(0.16874)
      tab[i + 1024] = -21709 * i;                 // -FIX(0.33126)
      tab[i + 1280] = 32768 * i + (128 << 16) + 32768 - 1;  // FIX(0.5)
      tab[i + 1536] = -27439 * i;                 // -FIX(0.41869)
      tab[i + 1792] = -5329 * i;                  // -FIX(0.08131)
    }
    // full-resolution Y, Cb, Cr of the rows padded to an even count, each
    // row replicated right to the MCU edge (jcprepct.c, expand_right_edge)
    const size_t fw = static_cast<size_t>(mcux) * 16;
    const size_t fh = static_cast<size_t>(height + 1) / 2 * 2;
    std::vector<uint8_t> full[3];
    for (auto& f : full) f.assign(fw * fh, 0);
    for (size_t y = 0; y < fh; y++) {
      const uint8_t* src = px + std::min<size_t>(y, height - 1) * width * 3;
      for (size_t x = 0; x < fw; x++) {
        const uint8_t* p = src + std::min<size_t>(x, width - 1) * 3;
        int r = p[0], g = p[1], b = p[2];
        full[0][y * fw + x] = static_cast<uint8_t>((tab[r] + tab[g + 256] + tab[b + 512]) >> 16);
        full[1][y * fw + x] =
            static_cast<uint8_t>((tab[r + 768] + tab[g + 1024] + tab[b + 1280]) >> 16);
        full[2][y * fw + x] =
            static_cast<uint8_t>((tab[r + 1280] + tab[g + 1536] + tab[b + 1792]) >> 16);
      }
    }
    // Y: rows past the image repeat its last row
    EncComponent& Y = comps[0];
    for (size_t y = 0; y < prow; y++)
      std::memcpy(Y.plane.data() + y * Y.stride, &full[0][std::min<size_t>(y, height - 1) * fw],
                  Y.stride);
    // Cb, Cr: h2v2_downsample (bias 1, 2, 1, 2, ... along a row), then the
    // last downsampled row repeated down to the MCU edge
    const size_t crows = fh / 2;
    for (int ci = 1; ci < 3; ci++) {
      EncComponent& c = comps[ci];
      const std::vector<uint8_t>& f = full[ci];
      size_t nrows = c.plane.size() / c.stride;
      for (size_t y = 0; y < nrows; y++) {
        size_t sy = std::min(y, crows - 1);
        const uint8_t* r0 = &f[2 * sy * fw];
        const uint8_t* r1 = r0 + fw;
        uint8_t* dst = c.plane.data() + y * c.stride;
        int bias = 1;
        for (size_t x = 0; x < c.stride; x++) {
          dst[x] = static_cast<uint8_t>((r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] +
                                         bias) >> 2);
          bias ^= 3;
        }
      }
    }
  }

  HuffSpec dc_spec[2] = {make_spec(kStdLumaBits, kStdDcVals),
                         make_spec(kStdChromaBits, kStdDcVals)};
  HuffSpec ac_spec[2] = {make_spec(kStdLumaAcBits, kStdLumaAcVals),
                         make_spec(kStdChromaAcBits, kStdChromaAcVals)};
  const int ntables = channels == 3 ? 2 : 1;

  std::vector<uint8_t> o;
  o.reserve(static_cast<size_t>(width) * height * channels / 4 + 1024);
  const uint8_t head[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00,
                          0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
  o.insert(o.end(), head, head + sizeof(head));
  for (int t = 0; t < ntables; t++) {
    o.push_back(0xFF);
    o.push_back(0xDB);
    put16(o, 67);
    o.push_back(static_cast<uint8_t>(t));
    for (int k = 0; k < 64; k++) o.push_back(static_cast<uint8_t>(qtab[t][kNatural[k]]));
  }
  o.push_back(0xFF);
  o.push_back(0xC0);
  put16(o, 8 + 3 * channels);
  o.push_back(8);
  put16(o, height);
  put16(o, width);
  o.push_back(static_cast<uint8_t>(channels));
  for (auto& c : comps) {
    o.push_back(static_cast<uint8_t>(c.id));
    o.push_back(static_cast<uint8_t>((c.h << 4) | c.v));
    o.push_back(static_cast<uint8_t>(c.tq));
  }
  for (int t = 0; t < ntables; t++) {
    for (int cls = 0; cls < 2; cls++) {
      const HuffSpec& s = cls ? ac_spec[t] : dc_spec[t];
      o.push_back(0xFF);
      o.push_back(0xC4);
      put16(o, 2 + 1 + 16 + s.count);
      o.push_back(static_cast<uint8_t>((cls << 4) | t));
      for (int l = 1; l <= 16; l++) o.push_back(s.bits[l]);
      o.insert(o.end(), s.vals, s.vals + s.count);
    }
  }
  o.push_back(0xFF);
  o.push_back(0xDA);
  put16(o, 6 + 2 * channels);
  o.push_back(static_cast<uint8_t>(channels));
  for (auto& c : comps) {
    o.push_back(static_cast<uint8_t>(c.id));
    o.push_back(static_cast<uint8_t>((c.table << 4) | c.table));
  }
  o.push_back(0);
  o.push_back(63);
  o.push_back(0);

  EncodeTable dct[2] = {EncodeTable(dc_spec[0]), EncodeTable(dc_spec[1])};
  EncodeTable act[2] = {EncodeTable(ac_spec[0]), EncodeTable(ac_spec[1])};
  BitWriter bw{o};
  int16_t blocks[4][64];
  if (channels == 1) {
    EncComponent& c = comps[0];
    for (int by = 0; by < c.bh; by++)
      for (int bx = 0; bx < c.bw; bx++) {
        encode_block(c, by, bx, blocks[0]);
        emit_block(bw, blocks[0], c.last_dc, dct[0], act[0]);
      }
  } else {
    for (int my = 0; my < mcuy; my++)
      for (int mx = 0; mx < mcux; mx++)
        for (auto& c : comps) {
          // jccoefct.c compress_data: blocks past the image's are dummies
          // with zero AC and the DC of the block before them in the MCU
          int n = 0;
          for (int y = 0; y < c.v; y++) {
            int by = my * c.v + y;
            for (int x = 0; x < c.h; x++, n++) {
              int bx = mx * c.h + x;
              if (by < c.bh && bx < c.bw) {
                encode_block(c, by, bx, blocks[n]);
              } else {
                int16_t prev_dc = by < c.bh ? blocks[n - 1][0] : blocks[y * c.h - 1][0];
                std::memset(blocks[n], 0, sizeof(blocks[n]));
                blocks[n][0] = prev_dc;
              }
            }
          }
          for (int k = 0; k < n; k++)
            emit_block(bw, blocks[k], c.last_dc, dct[c.table], act[c.table]);
        }
  }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
  return o;
}

void set_error(char* err, size_t errlen, const char* msg) {
  if (err && errlen) {
    std::strncpy(err, msg, errlen - 1);
    err[errlen - 1] = '\0';
  }
}

}  // namespace

extern "C" {

// Decode a JPEG held in memory.  On success *out holds height*width*channels
// bytes (row-major, RGB interleaved), to be released with pd_jpeg_free.
int pd_jpeg_decode(const uint8_t* data, size_t size, uint8_t** out, int* height,
                   int* width, int* channels, char* err, size_t errlen) {
  *out = nullptr;
  try {
    Decoder dec;
    dec.d = data;
    dec.n = size;
    dec.parse();
    int c = 0;
    std::vector<uint8_t> px = dec.pixels(c);
    uint8_t* buf = static_cast<uint8_t*>(std::malloc(px.size()));
    if (!buf) throw JpegError("out of memory");
    std::memcpy(buf, px.data(), px.size());
    *out = buf;
    *height = dec.height;
    *width = dec.width;
    *channels = c;
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

// Encode height x width x channels (1 or 3) u8 pixels at ``quality``.  On
// success *out holds *size bytes, to be released with pd_jpeg_free.
int pd_jpeg_encode(const uint8_t* pixels, int height, int width, int channels,
                   int quality, uint8_t** out, size_t* size, char* err,
                   size_t errlen) {
  *out = nullptr;
  try {
    std::vector<uint8_t> o = encode(pixels, height, width, channels, quality);
    uint8_t* buf = static_cast<uint8_t*>(std::malloc(o.size()));
    if (!buf) throw JpegError("out of memory");
    std::memcpy(buf, o.data(), o.size());
    *out = buf;
    *size = o.size();
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

void pd_jpeg_free(void* p) { std::free(p); }

}  // extern "C"
