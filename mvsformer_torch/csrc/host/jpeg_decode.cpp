// Baseline JPEG decoder for the host CPU, bit for bit what libjpeg-turbo's
// default decompression returns (and so what cv2.imdecode returns).
//
// Decoded: SOF0 and SOF1 frames (8-bit, sequential, Huffman-coded) with 1
// component (grey) or 3 (YCbCr) in one scan, sampling factors of 1 or 2 on
// each axis, any size from 1x1, restart intervals, and any number of DQT,
// DHT, DRI, APPn and COM segments before the scan. The maths is
// libjpeg-turbo's:
// - the integer "islow" IDCT (jidctint.c: 13 constant bits, 2 pass-1 bits,
//   columns then rows, its 10-bit wrapping range limit);
// - its upsampler choice (jdsample.c): a component at half the width takes
//   the triangle ("fancy") filter only where its own downsampled width is
//   above 2, else it is replicated; half the height alone always takes the
//   vertical triangle filter. Each filter works from the component's true
//   downsampled width and height and repeats its last row and column;
// - YCbCr -> RGB through jdcolor.c's 16-bit fixed-point tables.
// A grey read of a YCbCr stream returns the Y plane (libjpeg's
// JCS_GRAYSCALE output, cv2's IMREAD_GRAYSCALE); a grey stream read in
// colour is its plane in all three channels.
//
// Refused, each with a message naming the format: progressive, lossless,
// arithmetic-coded and hierarchical frames, precision other than 8, 2 or 4
// components, RGB streams (Adobe transform 0, or component ids 'R','G','B'),
// a frame split over several scans, DNL (height 0), an EXIF orientation of
// 2-8 (cv2 would rotate or mirror the image), and a truncated or corrupt
// entropy-coded segment (cv2.imread returns a partly grey image there).
//
// C interface (no C++ exception leaves it; no global state, so threads may
// decode at once):
//   int jpeg_header(data, size, &height, &width, &components, err, err_size)
//   int jpeg_decode(data, size, gray, out, out_size, err, err_size)
// Both return 0 on success and 1 with a message in `err` on failure.
// `out` takes height * width bytes (gray) or height * width * 3 (RGB).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

class DecodeError : public std::runtime_error {
 public:
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& what) { throw DecodeError(what); }

// Zigzag position -> natural (row-major) index. The 16 extra entries at 63
// catch a corrupt run length past the block's end, as libjpeg's do.
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;
// libjpeg's JPEG_MAX_DIMENSION: larger frames are refused, as there.
constexpr int kMaxDimension = 65500;

struct Huffman {
  bool defined = false;
  uint16_t lookup[1 << kLookBits];  // (length << 8) | symbol; 0: longer code
  // AC symbols whose code and extra bits fit in the lookahead together:
  // (coefficient << 8) | (run << 4) | (code + extra bits); 0: not such a code.
  int32_t fast_ac[1 << kLookBits];
  int32_t maxcode[17];              // largest code of each length, -1 if none
  int32_t valoffset[17];            // symbol index = code + valoffset[length]
  uint8_t vals[256];
};

// A coefficient's value from its `s` extra bits `r` (HUFF_EXTEND).
inline int extend(int32_t r, int s) { return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r; }

void build_huffman(Huffman& h, const uint8_t* counts, const uint8_t* vals, int nvals) {
  std::memset(h.lookup, 0, sizeof h.lookup);
  std::memcpy(h.vals, vals, nvals);
  int32_t code = 0;
  int k = 0;
  for (int len = 1; len <= 16; ++len) {
    const int n = counts[len - 1];
    // The codes of this length must fit in `len` bits and none may be all
    // ones (libjpeg's check, jdhuff.c). Checked before any is written: an
    // over-subscribed table would index past `lookup`.
    if (code + n >= (1 << len)) fail("corrupt JPEG: bad Huffman table");
    h.valoffset[len] = k - code;
    for (int i = 0; i < n; ++i, ++code, ++k) {
      if (len <= kLookBits) {
        const int shift = kLookBits - len;
        const uint16_t entry = static_cast<uint16_t>((len << 8) | vals[k]);
        for (int j = 0; j < (1 << shift); ++j) h.lookup[(code << shift) | j] = entry;
      }
    }
    h.maxcode[len] = n ? code - 1 : -1;
    code <<= 1;
  }
  for (int look = 0; look < (1 << kLookBits); ++look) {
    h.fast_ac[look] = 0;
    const int len = h.lookup[look] >> 8, run = (h.lookup[look] >> 4) & 15,
              size = h.lookup[look] & 15;
    if (len == 0 || size == 0 || len + size > kLookBits) continue;
    const int32_t r = (look >> (kLookBits - len - size)) & ((1 << size) - 1);
    h.fast_ac[look] = extend(r, size) * 256 + (run << 4) + len + size;
  }
  h.defined = true;
}

// The entropy-coded segment's bits. Past a marker or the end of the data
// the reader supplies zero bits, as libjpeg does, and counts them: a code
// that consumes one is a truncated or corrupt segment.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;  // the next bit is bit 63
  int n = 0;         // bits held in acc
  int pad = 0;       // of those, the trailing zero bits past the data
  bool stopped = false;
  const uint8_t* marker = nullptr;  // the marker code byte that stopped the data

  BitReader(const uint8_t* begin, const uint8_t* stop) : p(begin), end(stop) {}

  void fill() {
    while (n <= 56) {
      uint32_t byte = 0;
      if (!stopped) {
        if (p >= end) {
          stopped = true;
        } else {
          byte = *p++;
          if (byte == 0xFF) {
            const uint8_t* q = p;
            while (q < end && *q == 0xFF) ++q;  // fill bytes
            if (q < end && *q == 0x00) {
              p = q + 1;  // FF 00: a data byte 0xFF
            } else {
              stopped = true;
              marker = q < end ? q : nullptr;
              byte = 0;
            }
          }
        }
      }
      if (stopped) pad += 8;
      acc |= static_cast<uint64_t>(byte) << (56 - n);
      n += 8;
    }
  }

  uint32_t peek(int k) {
    if (n < k) fill();
    return static_cast<uint32_t>(acc >> (64 - k));
  }

  void skip(int k) {
    if (n - k < pad) fail("truncated or corrupt JPEG entropy-coded data");
    acc <<= k;
    n -= k;
  }

  int32_t bits(int k) {
    if (k == 0) return 0;
    const uint32_t v = peek(k);
    skip(k);
    return static_cast<int32_t>(v);
  }

  int decode(const Huffman& h) {
    const uint32_t look = peek(16);
    const uint16_t entry = h.lookup[look >> (16 - kLookBits)];
    if (entry) {
      skip(entry >> 8);
      return entry & 0xFF;
    }
    for (int len = kLookBits + 1; len <= 16; ++len) {
      const int32_t code = static_cast<int32_t>(look >> (16 - len));
      if (code <= h.maxcode[len]) {
        skip(len);
        return h.vals[code + h.valoffset[len]];
      }
    }
    fail("corrupt JPEG: a Huffman code longer than 16 bits");
  }

  // Drop the buffered bits and read the restart marker that must follow.
  void restart(int expected) {
    const uint8_t* q = marker;
    if (!stopped) {  // skip what is left before the marker, as libjpeg does
      q = p;
      while (true) {
        while (q < end && *q != 0xFF) ++q;
        while (q < end && *q == 0xFF) ++q;
        if (q >= end || *q != 0x00) break;
        ++q;
      }
      if (q >= end) q = nullptr;
    }
    if (q == nullptr || *q != 0xD0 + expected)
      fail("truncated or corrupt JPEG: restart marker RST" + std::to_string(expected) +
           " missing");
    p = q + 1;
    acc = 0;
    n = pad = 0;
    stopped = false;
    marker = nullptr;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;       // the scan's DC and AC tables
  int bw = 0, bh = 0;       // blocks in the decoded plane
  int dw = 0, dh = 0;       // true (downsampled) width and height
  std::vector<uint8_t> plane;  // bw * 8 x bh * 8 samples
};

struct Stream {
  const uint8_t* data;
  size_t size;
  // Tables and frame as of the scan.
  int16_t quant[4][64];  // natural order; libjpeg keeps them as short
  bool quant_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int width = 0, height = 0, ncomp = 0;
  Component comp[3];
  int hmax = 1, vmax = 1;
  int scan_order[3] = {0, 0, 0};
  size_t scan_start = 0;  // the first byte of the entropy-coded segment
};

uint32_t be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

// 2..8 rotate or mirror the image in cv2; 1, a missing tag or an invalid
// value leave it as stored.
int exif_orientation(const uint8_t* d, size_t n) {
  if (n < 14 || std::memcmp(d, "Exif\0\0", 6) != 0) return 0;
  const uint8_t* t = d + 6;
  const size_t tn = n - 6;
  bool le;
  if (t[0] == 'I' && t[1] == 'I') le = true;
  else if (t[0] == 'M' && t[1] == 'M') le = false;
  else return 0;
  auto u16 = [&](size_t o) -> uint32_t {
    return le ? t[o] | (t[o + 1] << 8) : (t[o] << 8) | t[o + 1];
  };
  auto u32 = [&](size_t o) -> uint32_t {
    return le ? t[o] | (t[o + 1] << 8) | (t[o + 2] << 16) | (uint32_t(t[o + 3]) << 24)
              : (uint32_t(t[o]) << 24) | (t[o + 1] << 16) | (t[o + 2] << 8) | t[o + 3];
  };
  const size_t ifd = u32(4);
  if (ifd + 2 > tn) return 0;
  const uint32_t count = u16(ifd);
  for (uint32_t i = 0; i < count; ++i) {
    const size_t e = ifd + 2 + 12 * size_t(i);
    if (e + 12 > tn) return 0;
    if (u16(e) == 0x0112 && u16(e + 2) == 3) return static_cast<int>(u16(e + 8));
  }
  return 0;
}

const char* frame_kind(int code) {
  switch (code) {
    case 0xC2: return "progressive JPEG (SOF2) is not decoded; only baseline and extended sequential";
    case 0xC3: return "lossless JPEG (SOF3) is not decoded; only baseline and extended sequential";
    case 0xC5: case 0xC6: case 0xC7: case 0xCD: case 0xCE: case 0xCF:
      return "hierarchical (differential) JPEG is not decoded; only baseline and extended sequential";
    case 0xC9: case 0xCA: case 0xCB:
      return "arithmetic-coded JPEG is not decoded; only Huffman-coded";
    default: return nullptr;
  }
}

void read_frame(Stream& s, const uint8_t* b, size_t len, int code) {
  if (len < 6) fail("corrupt JPEG: short SOF segment");
  const int precision = b[0];
  if (precision != 8)
    fail(std::to_string(precision) + "-bit JPEG (SOF" + std::to_string(code - 0xC0) +
         " precision) is not decoded; only 8-bit");
  s.height = static_cast<int>(be16(b + 1));
  s.width = static_cast<int>(be16(b + 3));
  s.ncomp = b[5];
  if (s.height == 0) fail("JPEG with height 0 (defined by a DNL marker) is not decoded");
  if (s.width == 0) fail("corrupt JPEG: width 0");
  if (s.height > kMaxDimension || s.width > kMaxDimension)
    fail("JPEG larger than " + std::to_string(kMaxDimension) + " pixels on a side is not decoded");
  if (s.ncomp == 4) fail("4-component (CMYK/YCCK) JPEG is not decoded; only grey and YCbCr");
  if (s.ncomp != 1 && s.ncomp != 3)
    fail(std::to_string(s.ncomp) + "-component JPEG is not decoded; only grey and YCbCr");
  if (len < 6 + 3 * size_t(s.ncomp)) fail("corrupt JPEG: short SOF segment");
  for (int c = 0; c < s.ncomp; ++c) {
    Component& k = s.comp[c];
    k.id = b[6 + 3 * c];
    k.h = b[7 + 3 * c] >> 4;
    k.v = b[7 + 3 * c] & 15;
    k.tq = b[8 + 3 * c];
    if (k.tq > 3) fail("corrupt JPEG: quantisation table id above 3");
    if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4) fail("corrupt JPEG: bad sampling factor");
  }
  if (s.ncomp == 1) {
    // One component: one block per MCU, whatever its stated factors.
    s.comp[0].h = s.comp[0].v = 1;
  }
  s.hmax = s.vmax = 1;
  for (int c = 0; c < s.ncomp; ++c) {
    s.hmax = std::max(s.hmax, s.comp[c].h);
    s.vmax = std::max(s.vmax, s.comp[c].v);
  }
  for (int c = 0; c < s.ncomp; ++c) {
    const Component& k = s.comp[c];
    if (k.h > 2 || k.v > 2 || s.hmax % k.h || s.vmax % k.v) {
      std::string f;
      for (int i = 0; i < s.ncomp; ++i)
        f += (i ? "," : "") + std::to_string(s.comp[i].h) + "x" + std::to_string(s.comp[i].v);
      fail("JPEG sampling factors " + f +
           " are not decoded; only 1 or 2 on each axis (4:4:4, 4:2:2, 4:4:0, 4:2:0)");
    }
  }
}

// Parse the markers from SOI to the first SOS. Everything that is refused
// is refused here, before any pixel is decoded.
void read_headers(Stream& s) {
  const uint8_t* d = s.data;
  const size_t n = s.size;
  if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG stream (no SOI marker)");
  bool have_frame = false;
  size_t pos = 2;
  while (true) {
    while (pos < n && d[pos] != 0xFF) ++pos;  // libjpeg skips stray bytes too
    while (pos < n && d[pos] == 0xFF) ++pos;
    if (pos >= n) fail("truncated JPEG: no scan");
    const int code = d[pos++];
    if (code == 0xD9) fail("truncated JPEG: EOI before the scan");
    if ((code >= 0xD0 && code <= 0xD7) || code == 0x01) continue;  // RSTn, TEM
    if (code == 0xD8) fail("corrupt JPEG: a second SOI marker");
    if (pos + 2 > n) fail("truncated JPEG: a marker without its length");
    const size_t len = be16(d + pos);
    if (len < 2 || pos + len > n) fail("truncated JPEG: a marker segment past the end");
    const uint8_t* b = d + pos + 2;
    const size_t blen = len - 2;
    pos += len;
    if (const char* kind = frame_kind(code)) fail(kind);
    switch (code) {
      case 0xC0: case 0xC1:
        if (have_frame) fail("corrupt JPEG: a second SOF marker");
        read_frame(s, b, blen, code);
        have_frame = true;
        break;
      case 0xC4: {  // DHT: one or more tables
        size_t o = 0;
        while (o < blen) {
          if (o + 17 > blen) fail("corrupt JPEG: short DHT segment");
          const int tc = b[o] >> 4, th = b[o] & 15;
          if (tc > 1 || th > 3) fail("corrupt JPEG: bad DHT table id");
          int total = 0;
          for (int i = 0; i < 16; ++i) total += b[o + 1 + i];
          if (total > 256 || o + 17 + total > blen) fail("corrupt JPEG: bad Huffman table");
          build_huffman(tc ? s.ac[th] : s.dc[th], b + o + 1, b + o + 17, total);
          o += 17 + total;
        }
        break;
      }
      case 0xDB: {  // DQT
        size_t o = 0;
        while (o < blen) {
          const int pq = b[o] >> 4, tq = b[o] & 15;
          if (tq > 3 || pq > 1) fail("corrupt JPEG: bad DQT table");
          if (o + 1 + 64 * (pq + 1) > blen) fail("corrupt JPEG: short DQT segment");
          for (int i = 0; i < 64; ++i) {
            const uint32_t q = pq ? be16(b + o + 1 + 2 * i) : b[o + 1 + i];
            s.quant[tq][kNatural[i]] = static_cast<int16_t>(q);
          }
          s.quant_defined[tq] = true;
          o += 1 + 64 * (pq + 1);
        }
        break;
      }
      case 0xDD:  // DRI
        if (blen < 2) fail("corrupt JPEG: short DRI segment");
        s.restart_interval = static_cast<int>(be16(b));
        break;
      case 0xDC:
        fail("JPEG with a DNL marker is not decoded");
      case 0xDE: case 0xDF:
        fail("hierarchical JPEG (DHP/EXP markers) is not decoded");
      case 0xE0:
        if (blen >= 14 && std::memcmp(b, "JFIF\0", 5) == 0) s.jfif = true;
        break;
      case 0xE1: {
        const int orient = exif_orientation(b, blen);
        if (orient >= 2 && orient <= 8)
          fail("JPEG with EXIF orientation " + std::to_string(orient) +
               " is not decoded (cv2 would rotate or mirror it); only orientation 1");
        break;
      }
      case 0xEE:
        if (blen >= 12 && std::memcmp(b, "Adobe", 5) == 0) {
          s.adobe = true;
          s.adobe_transform = b[11];
        }
        break;
      case 0xDA: {  // SOS
        if (!have_frame) fail("corrupt JPEG: SOS before SOF");
        if (blen < 1) fail("corrupt JPEG: short SOS segment");
        const int ns = b[0];
        if (ns != s.ncomp)
          fail("JPEG whose frame is split into several sequential scans is not decoded");
        if (blen < 1 + 2 * size_t(ns) + 3) fail("corrupt JPEG: short SOS segment");
        for (int i = 0; i < ns; ++i) {
          const int id = b[1 + 2 * i];
          int c = 0;
          while (c < s.ncomp && s.comp[c].id != id) ++c;
          if (c == s.ncomp) fail("corrupt JPEG: a scan component not in the frame");
          for (int j = 0; j < i; ++j)
            if (s.scan_order[j] == c) fail("corrupt JPEG: a component twice in the scan");
          s.scan_order[i] = c;
          s.comp[c].td = b[2 + 2 * i] >> 4;
          s.comp[c].ta = b[2 + 2 * i] & 15;
          if (s.comp[c].td > 3 || s.comp[c].ta > 3) fail("corrupt JPEG: bad Huffman table id");
        }
        if (s.ncomp == 3) {
          const bool rgb_ids = s.comp[0].id == 'R' && s.comp[1].id == 'G' && s.comp[2].id == 'B';
          if ((!s.jfif && s.adobe && s.adobe_transform == 0) || (!s.jfif && !s.adobe && rgb_ids))
            fail("RGB JPEG (Adobe transform 0 or component ids R,G,B) is not decoded; "
                 "only YCbCr");
        }
        s.scan_start = pos;
        return;
      }
      default:
        if (code >= 0xE0 && code <= 0xEF) break;  // other APPn
        if (code == 0xFE || code == 0xCC) break;   // COM; DAC only serves arithmetic frames
        fail("corrupt JPEG: unknown marker " + std::to_string(code));
    }
  }
}

// ---- The integer IDCT (jidctint.c) ----------------------------------------

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// libjpeg's post-IDCT range limit: the value is taken mod 1024 as a signed
// 10-bit number, offset by 128 and clamped to [0, 255].
inline uint8_t idct_limit(int64_t x) {
  const int s = static_cast<int>(((x & 1023) ^ 512) - 512) + 128;
  return static_cast<uint8_t>(s < 0 ? 0 : s > 255 ? 255 : s);
}

void idct_islow(const int16_t* coef, const int16_t* quant, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const int16_t* q = quant + c;
    int* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 && in[40] == 0 &&
        in[48] == 0 && in[56] == 0) {
      // In 64 bits, then wrapped to int as libjpeg's LEFT_SHIFT does.
      const int dc = static_cast<int>(int64_t(in[0]) * q[0] * (1 << kPass1Bits));
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = int64_t(in[16]) * q[16];
    int64_t z3 = int64_t(in[48]) * q[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int64_t(in[0]) * q[0];
    z3 = int64_t(in[32]) * q[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = int64_t(in[56]) * q[56];
    tmp1 = int64_t(in[40]) * q[40];
    tmp2 = int64_t(in[24]) * q[24];
    tmp3 = int64_t(in[8]) * q[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
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

    constexpr int sh = kConstBits - kPass1Bits;
    w[0] = int(descale(tmp10 + tmp3, sh));
    w[56] = int(descale(tmp10 - tmp3, sh));
    w[8] = int(descale(tmp11 + tmp2, sh));
    w[48] = int(descale(tmp11 - tmp2, sh));
    w[16] = int(descale(tmp12 + tmp1, sh));
    w[40] = int(descale(tmp12 - tmp1, sh));
    w[24] = int(descale(tmp13 + tmp0, sh));
    w[32] = int(descale(tmp13 - tmp0, sh));
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 &&
        w[7] == 0) {
      const uint8_t dc = idct_limit(descale(w[0], kPass1Bits + 3));
      for (int c = 0; c < 8; ++c) o[c] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (1 << kConstBits);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (1 << kConstBits);
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
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
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

    constexpr int sh = kConstBits + kPass1Bits + 3;
    o[0] = idct_limit(descale(tmp10 + tmp3, sh));
    o[7] = idct_limit(descale(tmp10 - tmp3, sh));
    o[1] = idct_limit(descale(tmp11 + tmp2, sh));
    o[6] = idct_limit(descale(tmp11 - tmp2, sh));
    o[2] = idct_limit(descale(tmp12 + tmp1, sh));
    o[5] = idct_limit(descale(tmp12 - tmp1, sh));
    o[3] = idct_limit(descale(tmp13 + tmp0, sh));
    o[4] = idct_limit(descale(tmp13 - tmp0, sh));
  }
}

// ---- The scan -------------------------------------------------------------

// Decode the one scan into each component's plane; components the read
// does not need are entropy-decoded only.
void decode_scan(Stream& s, const bool* needed) {
  const int ns = s.ncomp;
  int mcux, mcuy;
  if (ns == 1) {
    Component& k = s.comp[0];
    mcux = k.bw = (s.width + 7) / 8;
    mcuy = k.bh = (s.height + 7) / 8;
  } else {
    mcux = (s.width + 8 * s.hmax - 1) / (8 * s.hmax);
    mcuy = (s.height + 8 * s.vmax - 1) / (8 * s.vmax);
    for (int c = 0; c < ns; ++c) {
      s.comp[c].bw = mcux * s.comp[c].h;
      s.comp[c].bh = mcuy * s.comp[c].v;
    }
  }
  for (int c = 0; c < ns; ++c) {
    Component& k = s.comp[c];
    k.dw = static_cast<int>((int64_t(s.width) * k.h + s.hmax - 1) / s.hmax);
    k.dh = static_cast<int>((int64_t(s.height) * k.v + s.vmax - 1) / s.vmax);
    if (!s.quant_defined[k.tq]) fail("corrupt JPEG: a quantisation table is not defined");
    if (!s.dc[k.td].defined || !s.ac[k.ta].defined)
      fail("corrupt JPEG: a Huffman table is not defined");
    if (needed[c]) k.plane.assign(size_t(k.bw) * 8 * size_t(k.bh) * 8, 0);
  }
  BitReader br(s.data + s.scan_start, s.data + s.size);
  int64_t pred[3] = {0, 0, 0};
  int restarts_left = s.restart_interval;
  int next_rst = 0;
  alignas(16) int16_t block[64];
  const int64_t total = int64_t(mcux) * mcuy;
  for (int64_t m = 0; m < total; ++m) {
    if (s.restart_interval) {
      if (restarts_left == 0) {
        br.restart(next_rst);
        next_rst = (next_rst + 1) & 7;
        pred[0] = pred[1] = pred[2] = 0;
        restarts_left = s.restart_interval;
      }
      --restarts_left;
    }
    const int mx = static_cast<int>(m % mcux), my = static_cast<int>(m / mcux);
    for (int i = 0; i < ns; ++i) {
      const int c = s.scan_order[i];
      Component& k = s.comp[c];
      const Huffman& dct = s.dc[k.td];
      const Huffman& act = s.ac[k.ta];
      const int bh = ns == 1 ? 1 : k.h, bv = ns == 1 ? 1 : k.v;
      for (int v = 0; v < bv; ++v) {
        for (int h = 0; h < bh; ++h) {
          std::memset(block, 0, sizeof block);
          int t = br.decode(dct);
          if (t > 15) fail("corrupt JPEG: a DC difference of more than 15 bits");
          const int diff = t ? extend(br.bits(t), t) : 0;
          pred[c] += diff;
          if (pred[c] > INT32_MAX || pred[c] < INT32_MIN) fail("corrupt JPEG: DC overflow");
          block[0] = static_cast<int16_t>(pred[c]);
          for (int z = 1; z < 64; ++z) {
            const int32_t fast = act.fast_ac[br.peek(16) >> (16 - kLookBits)];
            if (fast) {
              z += (fast >> 4) & 15;
              block[kNatural[z]] = static_cast<int16_t>(fast >> 8);
              br.skip(fast & 15);
              continue;
            }
            t = br.decode(act);
            const int run = t >> 4, size = t & 15;
            if (size) {
              z += run;
              block[kNatural[z]] = static_cast<int16_t>(extend(br.bits(size), size));
            } else {
              if (run != 15) break;
              z += 15;
            }
          }
          if (needed[c]) {
            const int by = my * bv + v, bx = mx * bh + h;
            const int stride = k.bw * 8;
            idct_islow(block, s.quant[k.tq], k.plane.data() + size_t(by) * 8 * stride + bx * 8,
                       stride);
          }
        }
      }
    }
  }
}

// ---- Upsampling (jdsample.c) and colour (jdcolor.c) -----------------------

// Row y of component `k` at full size: a pointer into its plane where it is
// full size, else `buf` (at least 2 * dw + 2 bytes) filled by libjpeg's
// upsampler for the component's factors. Columns past the image's width
// may be filled too; they are not read.
const uint8_t* upsample_row(const Stream& s, const Component& k, int y, uint8_t* buf,
                            int16_t* sums) {
  const int stride = k.bw * 8, dw = k.dw, dh = k.dh;
  const int rh = s.hmax / k.h, rv = s.vmax / k.v;
  const uint8_t* P = k.plane.data();
  auto row = [&](int r) { return P + size_t(r) * stride; };
  if (rv == 1) {
    const uint8_t* in = row(y);
    if (rh == 1) return in;
    if (dw > 2) {  // h2v1_fancy_upsample
      buf[0] = in[0];
      for (int i = 1; i < dw; ++i) {
        buf[2 * i - 1] = uint8_t((3 * in[i - 1] + in[i] + 2) >> 2);
        buf[2 * i] = uint8_t((3 * in[i] + in[i - 1] + 1) >> 2);
      }
      buf[2 * dw - 1] = in[dw - 1];
    } else {  // h2v1_upsample
      for (int i = 0; i < dw; ++i) buf[2 * i] = buf[2 * i + 1] = in[i];
    }
    return buf;
  }
  const int r = y >> 1;
  const uint8_t* near = row(r);
  if (rh == 2 && dw <= 2) {  // h2v2_upsample
    for (int i = 0; i < dw; ++i) buf[2 * i] = buf[2 * i + 1] = near[i];
    return buf;
  }
  // The vertical triangle: the nearer row 3/4, the row above (even output
  // rows) or below (odd ones) 1/4, repeating the first and last rows.
  const uint8_t* far = (y & 1) ? row(std::min(r + 1, dh - 1)) : row(std::max(r - 1, 0));
  if (rh == 1) {  // h1v2_fancy_upsample
    const int bias = (y & 1) ? 2 : 1;
    for (int i = 0; i < dw; ++i) buf[i] = uint8_t((3 * near[i] + far[i] + bias) >> 2);
    return buf;
  }
  for (int i = 0; i < dw; ++i) sums[i] = int16_t(3 * near[i] + far[i]);  // h2v2_fancy_upsample
  buf[0] = uint8_t((4 * sums[0] + 8) >> 4);
  for (int i = 1; i < dw; ++i) {
    buf[2 * i - 1] = uint8_t((3 * sums[i - 1] + sums[i] + 7) >> 4);
    buf[2 * i] = uint8_t((3 * sums[i] + sums[i - 1] + 8) >> 4);
  }
  buf[2 * dw - 1] = uint8_t((4 * sums[dw - 1] + 7) >> 4);
  return buf;
}

struct ColourTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  ColourTables() {
    constexpr int kBits = 16;
    constexpr int64_t kHalf = int64_t(1) << (kBits - 1);
    auto fix = [](double x) { return static_cast<int64_t>(x * (1L << kBits) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kBits);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kBits);
      cr_g[i] = static_cast<int32_t>(-fix(0.71414) * x);
      cb_g[i] = static_cast<int32_t>(-fix(0.34414) * x + kHalf);
    }
  }
};

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

void decode(const uint8_t* data, size_t size, bool gray, uint8_t* out, size_t out_size) {
  Stream s{};
  s.data = data;
  s.size = size;
  read_headers(s);
  const int H = s.height, W = s.width;
  if (out_size != size_t(H) * W * (gray ? 1 : 3)) fail("output buffer has the wrong size");
  bool needed[3] = {true, !gray, !gray};
  decode_scan(s, needed);
  int maxdw = 0;
  for (int c = 0; c < s.ncomp; ++c) maxdw = std::max(maxdw, s.comp[c].dw);
  std::vector<uint8_t> bufs(3 * size_t(2 * maxdw + 2));
  std::vector<int16_t> sums(maxdw);
  uint8_t* buf[3] = {bufs.data(), bufs.data() + 2 * maxdw + 2, bufs.data() + 4 * maxdw + 4};
  static const ColourTables t;  // built once, thread-safe (C++11), read-only
  for (int y = 0; y < H; ++y) {
    uint8_t* o = out + size_t(y) * W * (gray ? 1 : 3);
    const uint8_t* Y = upsample_row(s, s.comp[0], y, buf[0], sums.data());
    if (gray) {
      std::memcpy(o, Y, W);
    } else if (s.ncomp == 1) {
      for (int x = 0; x < W; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = Y[x];
    } else {
      const uint8_t* Cb = upsample_row(s, s.comp[1], y, buf[1], sums.data());
      const uint8_t* Cr = upsample_row(s, s.comp[2], y, buf[2], sums.data());
      for (int x = 0; x < W; ++x) {
        const int l = Y[x], cb = Cb[x], cr = Cr[x];
        o[3 * x] = clamp255(l + t.cr_r[cr]);
        o[3 * x + 1] = clamp255(l + ((t.cb_g[cb] + t.cr_g[cr]) >> 16));
        o[3 * x + 2] = clamp255(l + t.cb_b[cb]);
      }
    }
  }
}

void set_error(char* err, int64_t err_size, const char* msg) {
  if (err == nullptr || err_size <= 0) return;
  std::strncpy(err, msg, size_t(err_size) - 1);
  err[err_size - 1] = '\0';
}

}  // namespace

extern "C" int jpeg_header(const uint8_t* data, int64_t size, int32_t* height, int32_t* width,
                           int32_t* components, char* err, int64_t err_size) {
  try {
    Stream s{};
    s.data = data;
    s.size = static_cast<size_t>(size);
    read_headers(s);
    *height = s.height;
    *width = s.width;
    *components = s.ncomp;
    return 0;
  } catch (const std::exception& e) {
    set_error(err, err_size, e.what());
  } catch (...) {
    set_error(err, err_size, "JPEG decoder: unknown error");
  }
  return 1;
}

extern "C" int jpeg_decode(const uint8_t* data, int64_t size, int32_t gray, uint8_t* out,
                           int64_t out_size, char* err, int64_t err_size) {
  try {
    decode(data, static_cast<size_t>(size), gray != 0, out, static_cast<size_t>(out_size));
    return 0;
  } catch (const std::exception& e) {
    set_error(err, err_size, e.what());
  } catch (...) {
    set_error(err, err_size, "JPEG decoder: unknown error");
  }
  return 1;
}
