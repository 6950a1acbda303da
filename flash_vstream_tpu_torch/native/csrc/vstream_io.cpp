// vstream_io: the host frame-ingestion library of flash_vstream_tpu_torch.
//
// A JPEG decoder of its own (no libjpeg), a bilinear resize and a
// prefetching loader thread, behind a plain C interface that
// flash_vstream_tpu_torch/native/io.py binds with ctypes. The library is
// built from this file at first use with the host C++ compiler.
//
// The decoder covers baseline and extended sequential Huffman JPEG with
// 8-bit samples, 1 or 3 components, sampling factors up to 2x2 and restart
// markers: the files that MJPEG tracks, ffmpeg's `-q:v 2` frames and PIL's
// and OpenCV's encoders write. It follows libjpeg's default decode path
// step for step, so a full-size decode gives libjpeg-turbo's bits:
//   - the `islow` integer IDCT (jidctint.c) and its range limit table;
//   - "fancy" upsampling of subsampled chroma (jdsample.c: h2v1, h1v2,
//     h2v2 triangle filters; plain replication where the chroma plane is
//     two columns or less), edge rows and columns replicated;
//   - the YCbCr -> RGB tables of jdcolor.c.
// Progressive, lossless, hierarchical, arithmetic-coded and 12-bit files
// are refused with a reason and the code kRefused, so that the caller can
// decode them another way. A decode to another size decodes at full size
// and then runs one bilinear pass (libjpeg would first scale in the DCT
// domain).
//
// The input may be untrusted (an HTTP body): an image of more than
// kMaxPixels pixels is refused before anything is allocated for it, and no
// C entry lets an exception out (a failed allocation returns an error).

#include <condition_variable>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// PIL's decompression-bomb limit (2 x Image.MAX_IMAGE_PIXELS)
constexpr int64_t kMaxPixels = 2LL * 89478485;

// What a C entry returns: 0 decoded, kFailed for a file that is not a
// JPEG this decoder can read, kRefused for a valid JPEG of a coding it does
// not implement.
constexpr int kFailed = 1;
constexpr int kRefused = 2;

thread_local std::string g_error;
thread_local int g_code = kFailed;

bool fail(const std::string& why) {
  g_error = why;
  g_code = kFailed;
  return false;
}

bool refuse(const std::string& why) {
  g_error = why;
  g_code = kRefused;
  return false;
}

// The code of a C entry for the outcome of a call that set g_error.
int code(bool ok) { return ok ? 0 : g_code; }

// The code of a C entry whose call threw (std::bad_alloc for one).
int thrown(const char* what) {
  fail(std::string("the decoder threw: ") + what);
  return kFailed;
}

// Zigzag position -> natural (row-major) position, with 16 extra entries so
// that a corrupt run length lands on coefficient 63 (as jpeg_natural_order).
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---------------------------------------------------------------------------
// Huffman tables and the entropy-coded bit stream
// ---------------------------------------------------------------------------

constexpr int kLookBits = 9;

struct Huffman {
  bool present = false;
  int maxcode[18];
  int valoffset[17];
  uint8_t vals[256];
  uint8_t look_len[1 << kLookBits];  // 0: code longer than kLookBits
  uint8_t look_val[1 << kLookBits];
};

bool build_huffman(const uint8_t bits[17], const uint8_t* vals, int nvals,
                   Huffman* h) {
  int huffsize[257], huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < bits[l]; ++i) huffsize[p++] = l;
  huffsize[p] = 0;
  int code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1 << si)) return fail("bad Huffman table");
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits[l]) {
      h->valoffset[l] = p - huffcode[p];
      p += bits[l];
      h->maxcode[l] = huffcode[p - 1];
    } else {
      h->maxcode[l] = -1;
    }
  }
  h->maxcode[17] = 0xFFFFF;
  std::memcpy(h->vals, vals, nvals);
  std::memset(h->look_len, 0, sizeof(h->look_len));
  p = 0;
  for (int l = 1; l <= kLookBits; ++l) {
    for (int i = 0; i < bits[l]; ++i, ++p) {
      int base = huffcode[p] << (kLookBits - l);
      for (int j = 0; j < (1 << (kLookBits - l)); ++j) {
        h->look_len[base + j] = static_cast<uint8_t>(l);
        h->look_val[base + j] = vals[p];
      }
    }
  }
  h->present = true;
  return true;
}

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;  // left-aligned
  int bits = 0;
  bool at_marker = false;  // p rests on the 0xFF of a marker

  void fill() {
    while (bits <= 56) {
      uint32_t b = 0;
      if (!at_marker && p < end) {
        b = *p;
        if (b == 0xFF) {
          uint32_t next = p + 1 < end ? p[1] : 0xD9;
          if (next == 0x00) {
            p += 2;
          } else {
            at_marker = true;  // past the data: zeros, as libjpeg
            b = 0;
          }
        } else {
          ++p;
        }
      }
      acc |= static_cast<uint64_t>(b) << (56 - bits);
      bits += 8;
    }
  }
  int get(int n) {  // n in 1..16
    int v = static_cast<int>(acc >> (64 - n));
    acc <<= n;
    bits -= n;
    return v;
  }
  int decode(const Huffman& h) {
    if (bits < 32) fill();
    int look = static_cast<int>(acc >> (64 - kLookBits));
    int len = h.look_len[look];
    if (len) {
      acc <<= len;
      bits -= len;
      return h.look_val[look];
    }
    int l = kLookBits;
    int code = get(kLookBits);
    while (code > h.maxcode[l]) {
      code = (code << 1) | get(1);
      if (++l > 16) return 0;  // corrupt: libjpeg warns and uses 0
    }
    return h.vals[(code + h.valoffset[l]) & 0xFF];
  }
  // Byte-align and step over the next marker if it is a restart marker.
  void restart() {
    acc = 0;
    bits = 0;
    if (!at_marker) {
      while (p + 1 < end && !(p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF))
        ++p;
    }
    if (p + 1 < end && p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7) {
      p += 2;
    }
    at_marker = false;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// ---------------------------------------------------------------------------
// The islow IDCT (jidctint.c) and the range limit of its output
// ---------------------------------------------------------------------------

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t{1} << (n - 1))) >> n;
}

// libjpeg's post-IDCT range limit: the sample (value + 128), clamped to
// 0..255, looked up by the low 10 bits of the value as jdmaster.c builds it.
struct IdctRange {
  uint8_t t[1024];
  IdctRange() {
    for (int i = 0; i < 1024; ++i) {
      if (i < 128) t[i] = static_cast<uint8_t>(i + 128);
      else if (i < 384) t[i] = 255;
      else if (i < 896) t[i] = 0;
      else t[i] = static_cast<uint8_t>(i - 896);
    }
  }
};
const IdctRange kIdctRange;

struct OddEven {
  int64_t t10, t11, t12, t13, t0, t1, t2, t3;
};

inline OddEven idct_1d(int64_t in0, int64_t in1, int64_t in2, int64_t in3,
                       int64_t in4, int64_t in5, int64_t in6, int64_t in7) {
  OddEven r;
  // even part
  int64_t z2 = in2, z3 = in6;
  int64_t z1 = (z2 + z3) * FIX_0_541196100;
  int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
  int64_t tmp3 = z1 + z2 * FIX_0_765366865;
  int64_t tmp0 = (in0 + in4) * (int64_t{1} << kConstBits);
  int64_t tmp1 = (in0 - in4) * (int64_t{1} << kConstBits);
  r.t10 = tmp0 + tmp3;
  r.t13 = tmp0 - tmp3;
  r.t11 = tmp1 + tmp2;
  r.t12 = tmp1 - tmp2;
  // odd part
  tmp0 = in7;
  tmp1 = in5;
  tmp2 = in3;
  tmp3 = in1;
  z1 = tmp0 + tmp3;
  z2 = tmp1 + tmp2;
  z3 = tmp0 + tmp2;
  int64_t z4 = tmp1 + tmp3;
  int64_t z5 = (z3 + z4) * FIX_1_175875602;
  tmp0 = tmp0 * FIX_0_298631336;
  tmp1 = tmp1 * FIX_2_053119869;
  tmp2 = tmp2 * FIX_3_072711026;
  tmp3 = tmp3 * FIX_1_501321110;
  z1 = z1 * -FIX_0_899976223;
  z2 = z2 * -FIX_2_562915447;
  z3 = z3 * -FIX_1_961570560;
  z4 = z4 * -FIX_0_390180644;
  z3 += z5;
  z4 += z5;
  r.t0 = tmp0 + z1 + z3;
  r.t1 = tmp1 + z2 + z4;
  r.t2 = tmp2 + z2 + z3;
  r.t3 = tmp3 + z1 + z4;
  return r;
}

// One 8x8 block: coefficients (natural order) times the quantization table
// -> samples at out (row stride `stride`).
void idct_islow(const int16_t* coef, const uint16_t* quant, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {  // pass 1: columns
    int64_t in[8];
    for (int k = 0; k < 8; ++k)
      in[k] = static_cast<int64_t>(coef[8 * k + c]) * quant[8 * k + c];
    OddEven r = idct_1d(in[0], in[1], in[2], in[3], in[4], in[5], in[6],
                        in[7]);
    const int n = kConstBits - kPass1Bits;
    ws[8 * 0 + c] = static_cast<int>(descale(r.t10 + r.t3, n));
    ws[8 * 7 + c] = static_cast<int>(descale(r.t10 - r.t3, n));
    ws[8 * 1 + c] = static_cast<int>(descale(r.t11 + r.t2, n));
    ws[8 * 6 + c] = static_cast<int>(descale(r.t11 - r.t2, n));
    ws[8 * 2 + c] = static_cast<int>(descale(r.t12 + r.t1, n));
    ws[8 * 5 + c] = static_cast<int>(descale(r.t12 - r.t1, n));
    ws[8 * 3 + c] = static_cast<int>(descale(r.t13 + r.t0, n));
    ws[8 * 4 + c] = static_cast<int>(descale(r.t13 - r.t0, n));
  }
  for (int y = 0; y < 8; ++y) {  // pass 2: rows
    const int* w = ws + 8 * y;
    OddEven r = idct_1d(w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7]);
    const int n = kConstBits + kPass1Bits + 3;
    uint8_t* o = out + static_cast<size_t>(y) * stride;
    auto lim = [](int64_t v) { return kIdctRange.t[v & 1023]; };
    o[0] = lim(descale(r.t10 + r.t3, n));
    o[7] = lim(descale(r.t10 - r.t3, n));
    o[1] = lim(descale(r.t11 + r.t2, n));
    o[6] = lim(descale(r.t11 - r.t2, n));
    o[2] = lim(descale(r.t12 + r.t1, n));
    o[5] = lim(descale(r.t12 - r.t1, n));
    o[3] = lim(descale(r.t13 + r.t0, n));
    o[4] = lim(descale(r.t13 - r.t0, n));
  }
}

// ---------------------------------------------------------------------------
// The decoder
// ---------------------------------------------------------------------------

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;            // Huffman tables of the current scan
  bool quant_latched = false;    // libjpeg copies the table at first scan
  uint16_t quant[64];
  int bw = 0, bh = 0;            // allocated blocks (MCU-padded)
  int dw = 0, dh = 0;            // downsampled size in samples
  std::vector<int16_t> coef;     // [bh][bw][64], natural order
};

struct Jpeg {
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int restart_interval = 0;
  bool seen_sof = false, saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;
  uint16_t qt[4][64];
  bool qt_present[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  Component comp[3];
};

inline int u16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

bool parse_sof(Jpeg* j, const uint8_t* s, int len) {
  if (len < 6) return fail("short SOF segment");
  if (s[0] != 8)
    return refuse(std::to_string(s[0]) + "-bit samples are not supported");
  j->height = u16(s + 1);
  j->width = u16(s + 3);
  j->ncomp = s[5];
  if (j->height == 0) return fail("height defined by a DNL marker");
  if (j->width == 0) return fail("zero width");
  if (j->ncomp != 1 && j->ncomp != 3)
    return refuse(std::to_string(j->ncomp) + " components are not supported");
  if (len < 6 + 3 * j->ncomp) return fail("short SOF segment");
  j->hmax = j->vmax = 1;
  for (int i = 0; i < j->ncomp; ++i) {
    Component& c = j->comp[i];
    c.id = s[6 + 3 * i];
    c.h = s[7 + 3 * i] >> 4;
    c.v = s[7 + 3 * i] & 15;
    c.tq = s[8 + 3 * i] & 3;
    if (c.h < 1 || c.h > 2 || c.v < 1 || c.v > 2)
      return refuse("sampling factors above 2x2 are not supported");
    j->hmax = c.h > j->hmax ? c.h : j->hmax;
    j->vmax = c.v > j->vmax ? c.v : j->vmax;
  }
  const int mcux = (j->width + 8 * j->hmax - 1) / (8 * j->hmax);
  const int mcuy = (j->height + 8 * j->vmax - 1) / (8 * j->vmax);
  for (int i = 0; i < j->ncomp; ++i) {
    Component& c = j->comp[i];
    c.dw = (j->width * c.h + j->hmax - 1) / j->hmax;
    c.dh = (j->height * c.v + j->vmax - 1) / j->vmax;
    c.bw = mcux * c.h;
    c.bh = mcuy * c.v;
    c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
  }
  j->seen_sof = true;
  return true;
}

bool parse_dht(Jpeg* j, const uint8_t* s, int len) {
  int off = 0;
  while (off < len) {
    if (off + 17 > len) return fail("short DHT segment");
    int tc = s[off] >> 4, th = s[off] & 15;
    if (tc > 1 || th > 3) return fail("bad DHT table index");
    uint8_t bits[17];
    bits[0] = 0;
    int n = 0;
    for (int l = 1; l <= 16; ++l) {
      bits[l] = s[off + l];
      n += bits[l];
    }
    if (n > 256 || off + 17 + n > len) return fail("bad DHT segment");
    Huffman* h = tc == 0 ? &j->dc[th] : &j->ac[th];
    if (!build_huffman(bits, s + off + 17, n, h)) return false;
    off += 17 + n;
  }
  return true;
}

bool parse_dqt(Jpeg* j, const uint8_t* s, int len) {
  int off = 0;
  while (off < len) {
    int pq = s[off] >> 4, tq = s[off] & 15;
    if (tq > 3) return fail("bad DQT table index");
    int need = pq ? 129 : 65;
    if (off + need > len) return fail("short DQT segment");
    for (int i = 0; i < 64; ++i) {
      int v = pq ? u16(s + off + 1 + 2 * i) : s[off + 1 + i];
      j->qt[tq][kNatural[i]] = static_cast<uint16_t>(v);
    }
    j->qt_present[tq] = true;
    off += need;
  }
  return true;
}

bool decode_block(BitReader& br, const Huffman& dc, const Huffman& ac,
                  int* pred, int16_t* blk) {
  int s = br.decode(dc);
  int diff = 0;
  if (s) {
    if (s > 16) s = 16;
    diff = extend(br.get(s), s);
  }
  *pred += diff;
  blk[0] = static_cast<int16_t>(*pred);
  for (int k = 1; k < 64; ++k) {
    int sym = br.decode(ac);
    int r = sym >> 4;
    s = sym & 15;
    if (s) {
      k += r;
      if (br.bits < 16) br.fill();
      blk[kNatural[k]] = static_cast<int16_t>(extend(br.get(s), s));
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
  return true;
}

// One scan: its header at s (len bytes), its entropy-coded data from `data`.
// Returns the position after the data (at the next marker).
bool decode_scan(Jpeg* j, const uint8_t* s, int len, const uint8_t* data,
                 const uint8_t* end, const uint8_t** next) {
  if (!j->seen_sof) return fail("SOS before SOF");
  int ns = s[0];
  if (ns < 1 || ns > j->ncomp || len < 1 + 2 * ns + 3)
    return fail("bad SOS segment");
  Component* sc[3];
  for (int i = 0; i < ns; ++i) {
    int id = s[1 + 2 * i];
    Component* c = nullptr;
    for (int k = 0; k < j->ncomp; ++k)
      if (j->comp[k].id == id) c = &j->comp[k];
    if (c == nullptr) return fail("SOS names an unknown component");
    c->td = s[2 + 2 * i] >> 4;
    c->ta = s[2 + 2 * i] & 15;
    if (c->td > 3 || c->ta > 3 || !j->dc[c->td].present ||
        !j->ac[c->ta].present)
      return fail("scan uses an undefined Huffman table");
    if (!c->quant_latched) {
      if (!j->qt_present[c->tq])
        return fail("scan uses an undefined quantization table");
      std::memcpy(c->quant, j->qt[c->tq], sizeof(c->quant));
      c->quant_latched = true;
    }
    sc[i] = c;
  }
  const uint8_t* tail = s + 1 + 2 * ns;
  if (tail[0] != 0 || tail[1] != 63 || tail[2] != 0)
    return fail("spectral selection in a sequential scan");

  BitReader br{data, end};
  int pred[3] = {0, 0, 0};
  int mcux, mcuy;
  if (ns == 1) {
    mcux = (sc[0]->dw + 7) / 8;
    mcuy = (sc[0]->dh + 7) / 8;
  } else {
    mcux = (j->width + 8 * j->hmax - 1) / (8 * j->hmax);
    mcuy = (j->height + 8 * j->vmax - 1) / (8 * j->vmax);
  }
  const long total = static_cast<long>(mcux) * mcuy;
  int todo = j->restart_interval;
  for (long m = 0; m < total; ++m) {
    if (j->restart_interval) {
      if (todo == 0) {
        br.restart();
        pred[0] = pred[1] = pred[2] = 0;
        todo = j->restart_interval;
      }
      --todo;
    }
    const int mx = static_cast<int>(m % mcux), my = static_cast<int>(m / mcux);
    for (int i = 0; i < ns; ++i) {
      Component* c = sc[i];
      const int nh = ns == 1 ? 1 : c->h, nv = ns == 1 ? 1 : c->v;
      for (int by = 0; by < nv; ++by) {
        for (int bx = 0; bx < nh; ++bx) {
          const int row = my * nv + by, col = mx * nh + bx;
          int16_t* blk = c->coef.data() +
                         (static_cast<size_t>(row) * c->bw + col) * 64;
          decode_block(br, j->dc[c->td], j->ac[c->ta], &pred[i], blk);
        }
      }
    }
  }
  // the next marker: where the bit reader stopped, else scan ahead
  const uint8_t* p = br.p;
  while (p + 1 < end && !(p[0] == 0xFF && p[1] != 0x00 && p[1] != 0xFF &&
                          !(p[1] >= 0xD0 && p[1] <= 0xD7)))
    ++p;
  *next = p;
  return true;
}

// A component's samples at full image size (fancy upsampling of jdsample.c).
void upsample(const Component& c, const uint8_t* plane, int pw, int hmax,
              int vmax, int width, int height, uint8_t* out) {
  const int rh = hmax / c.h, rv = vmax / c.v;
  const int dw = c.dw, dh = c.dh;
  auto in_row = [&](int r) {  // rows past the edges repeat the edge row
    r = r < 0 ? 0 : (r >= dh ? dh - 1 : r);
    return plane + static_cast<size_t>(r) * pw;
  };
  std::vector<uint8_t> wide(static_cast<size_t>(2 * dw + 2));
  for (int y = 0; y < height; ++y) {
    uint8_t* o = out + static_cast<size_t>(y) * width;
    if (rh == 1 && rv == 1) {
      std::memcpy(o, in_row(y), width);
    } else if (rh == 2 && rv == 1) {
      const uint8_t* in = in_row(y);
      if (dw > 2) {  // h2v1_fancy_upsample
        uint8_t* w = wide.data();
        w[0] = in[0];
        w[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
        for (int x = 1; x < dw - 1; ++x) {
          int v3 = in[x] * 3;
          w[2 * x] = static_cast<uint8_t>((v3 + in[x - 1] + 1) >> 2);
          w[2 * x + 1] = static_cast<uint8_t>((v3 + in[x + 1] + 2) >> 2);
        }
        w[2 * dw - 2] =
            static_cast<uint8_t>((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
        w[2 * dw - 1] = in[dw - 1];
        std::memcpy(o, w, width);
      } else {
        for (int x = 0; x < width; ++x) o[x] = in[x >> 1];
      }
    } else if (rh == 1 && rv == 2) {  // h1v2_fancy_upsample
      const int r = y >> 1;
      const bool upper = (y & 1) == 0;
      const uint8_t* in0 = in_row(r);
      const uint8_t* in1 = in_row(upper ? r - 1 : r + 1);
      const int bias = upper ? 1 : 2;
      for (int x = 0; x < width; ++x)
        o[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
    } else {  // rh == 2 && rv == 2
      const int r = y >> 1;
      const bool upper = (y & 1) == 0;
      const uint8_t* in0 = in_row(r);
      if (dw > 2) {  // h2v2_fancy_upsample
        const uint8_t* in1 = in_row(upper ? r - 1 : r + 1);
        uint8_t* w = wide.data();
        int this_sum = in0[0] * 3 + in1[0];
        int next_sum = in0[1] * 3 + in1[1];
        w[0] = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
        w[1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
        int last_sum = this_sum;
        this_sum = next_sum;
        for (int x = 1; x < dw - 1; ++x) {
          next_sum = in0[x + 1] * 3 + in1[x + 1];
          w[2 * x] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
          w[2 * x + 1] =
              static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
          last_sum = this_sum;
          this_sum = next_sum;
        }
        w[2 * dw - 2] =
            static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
        w[2 * dw - 1] = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
        std::memcpy(o, w, width);
      } else {
        for (int x = 0; x < width; ++x) o[x] = in0[x >> 1];
      }
    }
  }
}

// jdcolor.c's YCbCr -> RGB tables (SCALEBITS 16).
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int kBits = 16;
    const int64_t half = int64_t{1} << (kBits - 1);
    auto fix = [](double x) {
      return static_cast<int64_t>(x * (1L << 16) + 0.5);
    };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + half) >> kBits);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + half) >> kBits);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// Decode a whole JPEG to RGB8 at its own size.
bool decode_jpeg(const uint8_t* data, size_t len, std::vector<uint8_t>* rgb,
                 int* out_h, int* out_w) {
  if (len < 4 || data[0] != 0xFF || data[1] != 0xD8)
    return fail("not a JPEG (no SOI marker)");
  Jpeg j;
  const uint8_t* p = data + 2;
  const uint8_t* end = data + len;
  bool scanned = false;
  for (;;) {
    while (p < end && *p != 0xFF) ++p;  // tolerate garbage between segments
    while (p < end && *p == 0xFF) ++p;
    if (p >= end) break;
    const int m = *p++;
    if (m == 0xD9) break;                     // EOI
    if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
    if (p + 2 > end) return fail("truncated segment");
    const int seg = u16(p);
    if (seg < 2 || p + seg > end) return fail("truncated segment");
    const uint8_t* s = p + 2;
    const int sl = seg - 2;
    if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC &&
        sl >= 5) {  // any SOF: the size cap comes before any other reading
      const int64_t pixels = static_cast<int64_t>(u16(s + 1)) * u16(s + 3);
      if (pixels > kMaxPixels)
        return fail(std::to_string(u16(s + 3)) + "x" +
                    std::to_string(u16(s + 1)) + " is more than the " +
                    std::to_string(kMaxPixels) + " pixels a JPEG may have");
    }
    if (m == 0xC0 || m == 0xC1) {
      if (j.seen_sof) return fail("two SOF markers");
      if (!parse_sof(&j, s, sl)) return false;
    } else if (m == 0xC2 || m == 0xC6) {
      return refuse("progressive JPEG is not supported");
    } else if (m == 0xC3 || m == 0xC7) {
      return refuse("lossless JPEG is not supported");
    } else if (m == 0xC5) {
      return refuse("hierarchical JPEG is not supported");
    } else if (m >= 0xC9 && m <= 0xCF && m != 0xCC) {
      return refuse("arithmetic-coded JPEG is not supported");
    } else if (m == 0xC4) {
      if (!parse_dht(&j, s, sl)) return false;
    } else if (m == 0xDB) {
      if (!parse_dqt(&j, s, sl)) return false;
    } else if (m == 0xDD) {
      if (sl < 2) return fail("short DRI segment");
      j.restart_interval = u16(s);
    } else if (m == 0xE0) {
      if (sl >= 5 && std::memcmp(s, "JFIF\0", 5) == 0) j.saw_jfif = true;
    } else if (m == 0xEE) {
      if (sl >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
        j.saw_adobe = true;
        j.adobe_transform = s[11];
      }
    } else if (m == 0xDA) {
      const uint8_t* next = nullptr;
      if (!decode_scan(&j, s, sl, p + seg, end, &next)) return false;
      scanned = true;
      p = next;
      continue;
    }
    p += seg;
  }
  if (!j.seen_sof) return fail("no SOF marker");
  if (!scanned) return fail("no scan");

  const int W = j.width, H = j.height;
  // samples of each component at full size
  std::vector<uint8_t> full[3];
  for (int i = 0; i < j.ncomp; ++i) {
    Component& c = j.comp[i];
    if (!c.quant_latched) return fail("a component has no scan");
    const int pw = c.bw * 8;
    std::vector<uint8_t> plane(static_cast<size_t>(pw) * c.bh * 8);
    for (int by = 0; by < c.bh; ++by)
      for (int bx = 0; bx < c.bw; ++bx)
        idct_islow(c.coef.data() + (static_cast<size_t>(by) * c.bw + bx) * 64,
                   c.quant,
                   plane.data() + static_cast<size_t>(by) * 8 * pw + bx * 8,
                   pw);
    full[i].resize(static_cast<size_t>(W) * H);
    upsample(c, plane.data(), pw, j.hmax, j.vmax, W, H, full[i].data());
  }
  rgb->resize(static_cast<size_t>(W) * H * 3);
  uint8_t* o = rgb->data();
  const size_t n = static_cast<size_t>(W) * H;
  if (j.ncomp == 1) {
    const uint8_t* g = full[0].data();
    for (size_t i = 0; i < n; ++i) o[3 * i] = o[3 * i + 1] = o[3 * i + 2] = g[i];
  } else {
    // libjpeg's colour space guess: JFIF is YCbCr; an Adobe marker says;
    // else component ids 'R', 'G', 'B' mean RGB
    bool is_rgb = false;
    if (!j.saw_jfif) {
      if (j.saw_adobe)
        is_rgb = j.adobe_transform == 0;
      else
        is_rgb = j.comp[0].id == 82 && j.comp[1].id == 71 &&
                 j.comp[2].id == 66;
    }
    const uint8_t* y = full[0].data();
    const uint8_t* cb = full[1].data();
    const uint8_t* cr = full[2].data();
    if (is_rgb) {
      for (size_t i = 0; i < n; ++i) {
        o[3 * i] = y[i];
        o[3 * i + 1] = cb[i];
        o[3 * i + 2] = cr[i];
      }
    } else {
      for (size_t i = 0; i < n; ++i) {
        const int Y = y[i], b = cb[i], r = cr[i];
        o[3 * i] = clamp255(Y + kYcc.cr_r[r]);
        o[3 * i + 1] = clamp255(
            Y + static_cast<int>((kYcc.cb_g[b] + kYcc.cr_g[r]) >> 16));
        o[3 * i + 2] = clamp255(Y + kYcc.cb_b[b]);
      }
    }
  }
  *out_h = H;
  *out_w = W;
  return true;
}

// ---------------------------------------------------------------------------
// Resize, files, the batch and the loader (as the JAX package's library)
// ---------------------------------------------------------------------------

// Bilinear resize RGB8 (half-pixel centers, like PIL/torchvision bilinear
// without antialias).
void resize_bilinear(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh,
                     int dw) {
  if (sh == dh && sw == dw) {
    std::memcpy(dst, src, static_cast<size_t>(dh) * dw * 3);
    return;
  }
  const float ys = static_cast<float>(sh) / dh;
  const float xs = static_cast<float>(sw) / dw;
  std::vector<int> x0v(dw), x1v(dw);
  std::vector<float> xwv(dw);
  for (int x = 0; x < dw; ++x) {
    float fx = (x + 0.5f) * xs - 0.5f;
    if (fx < 0) fx = 0;
    int x0 = static_cast<int>(fx);
    int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
    x0v[x] = x0; x1v[x] = x1; xwv[x] = fx - x0;
  }
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * ys - 0.5f;
    if (fy < 0) fy = 0;
    int y0 = static_cast<int>(fy);
    int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    float wy = fy - y0;
    const uint8_t* r0 = src + static_cast<size_t>(y0) * sw * 3;
    const uint8_t* r1 = src + static_cast<size_t>(y1) * sw * 3;
    uint8_t* drow = dst + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      const int x0 = x0v[x] * 3, x1 = x1v[x] * 3;
      const float wx = xwv[x];
      for (int k = 0; k < 3; ++k) {
        float top = r0[x0 + k] + (r0[x1 + k] - r0[x0 + k]) * wx;
        float bot = r1[x0 + k] + (r1[x1 + k] - r1[x0 + k]) * wx;
        float v = top + (bot - top) * wy;
        drow[3 * x + k] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return fail("cannot open the file");
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize(n > 0 ? n : 0);
  size_t got = n > 0 ? std::fread(out->data(), 1, n, f) : 0;
  std::fclose(f);
  if (got != static_cast<size_t>(n > 0 ? n : 0)) return fail("short read");
  return true;
}

bool decode_mem_to(const uint8_t* data, size_t len, int out_h, int out_w,
                   uint8_t* dst) {
  if (out_h <= 0 || out_w <= 0) return fail("the output size is empty");
  std::vector<uint8_t> rgb;
  int h = 0, w = 0;
  if (!decode_jpeg(data, len, &rgb, &h, &w)) return false;
  resize_bilinear(rgb.data(), h, w, dst, out_h, out_w);
  return true;
}

bool decode_file_to(const char* path, int out_h, int out_w, uint8_t* dst) {
  std::vector<uint8_t> bytes;
  if (!read_file(path, &bytes)) return false;
  return decode_mem_to(bytes.data(), bytes.size(), out_h, out_w, dst);
}

struct Loader {
  std::vector<std::string> paths;
  int out_h, out_w;
  size_t depth;
  std::deque<std::vector<uint8_t>> queue;  // decoded frames, FIFO
  std::deque<int> codes;                   // each frame's code (0 decoded)
  std::mutex mu;
  std::condition_variable cv_pop, cv_push;
  std::thread worker;
  std::atomic<bool> stop{false};
  bool done = false;  // guarded by mu: no more frames will ever be pushed

  void run() {
    for (size_t i = 0; i < paths.size() && !stop.load(); ++i) {
      // a frame whose decode fails or throws goes out empty: the consumer
      // zeroes its slot
      std::vector<uint8_t> buf;
      int rc = kFailed;
      try {
        buf.resize(static_cast<size_t>(out_h) * out_w * 3);
        rc = code(decode_file_to(paths[i].c_str(), out_h, out_w, buf.data()));
      } catch (const std::exception&) {
        rc = kFailed;
      }
      if (rc != 0) std::vector<uint8_t>().swap(buf);
      std::unique_lock<std::mutex> lk(mu);
      cv_push.wait(lk, [&] { return queue.size() < depth || stop.load(); });
      if (stop.load()) break;
      queue.emplace_back(std::move(buf));
      codes.push_back(rc);
      cv_pop.notify_one();
    }
    // publish exhaustion under the mutex after the last push, so a consumer
    // never sees exhausted-and-empty while a frame is in flight
    std::lock_guard<std::mutex> lk(mu);
    done = true;
    cv_pop.notify_all();
  }
};

}  // namespace

extern "C" {

// The reason the last failed call of this thread gave.
const char* vio_error() { return g_error.c_str(); }

// Decode one image file to RGB8 at (out_h, out_w). Returns 0 on success,
// else kFailed or kRefused with the reason in vio_error().
int vio_decode_file(const char* path, int out_h, int out_w, uint8_t* dst) {
  try {
    return code(decode_file_to(path, out_h, out_w, dst));
  } catch (const std::exception& e) {
    return thrown(e.what());
  }
}

// Decode a JPEG held in memory to RGB8 at (out_h, out_w), as
// vio_decode_file.
int vio_decode_mem(const uint8_t* data, long long len, int out_h, int out_w,
                   uint8_t* dst) {
  try {
    return code(
        decode_mem_to(data, static_cast<size_t>(len), out_h, out_w, dst));
  } catch (const std::exception& e) {
    return thrown(e.what());
  }
}

// Decode a batch of files into dst[n, out_h, out_w, 3], each file's code
// into codes[n]. Returns number of successfully decoded frames (failed
// slots are zeroed).
int vio_decode_batch(const char** paths, int n, int out_h, int out_w,
                     uint8_t* dst, int* codes) {
  const size_t stride = static_cast<size_t>(out_h) * out_w * 3;
  int ok_count = 0;
  for (int i = 0; i < n; ++i) {
    uint8_t* d = dst + static_cast<size_t>(i) * stride;
    try {
      codes[i] = code(decode_file_to(paths[i], out_h, out_w, d));
    } catch (const std::exception& e) {
      codes[i] = thrown(e.what());
    }
    if (codes[i] == 0) {
      ++ok_count;
    } else {
      std::memset(d, 0, stride);
    }
  }
  return ok_count;
}

// Bilinear resize of RGB8 [sh, sw, 3] into dst [dh, dw, 3]. Returns 0.
int vio_resize(const uint8_t* src, int sh, int sw, uint8_t* dst, int dh,
               int dw) {
  try {
    resize_bilinear(src, sh, sw, dst, dh, dw);
    return 0;
  } catch (const std::exception& e) {
    return thrown(e.what());
  }
}

// A loader thread over the files, or null with the reason in vio_error().
void* vio_loader_create(const char** paths, int n, int out_h, int out_w,
                        int prefetch_depth) {
  Loader* l = nullptr;
  try {
    l = new Loader();
    l->paths.assign(paths, paths + n);
    l->out_h = out_h;
    l->out_w = out_w;
    l->depth = prefetch_depth > 0 ? prefetch_depth : 8;
    l->worker = std::thread([l] { l->run(); });
    return l;
  } catch (const std::exception& e) {
    delete l;
    thrown(e.what());
    return nullptr;
  }
}

// Pop the next decoded frame into dst. Returns 1 on success, 0 when the
// stream is exhausted, -kFailed or -kRefused if the frame failed to decode
// (dst zeroed).
int vio_loader_next(void* handle, uint8_t* dst) {
  Loader* l = static_cast<Loader*>(handle);
  std::vector<uint8_t> buf;
  int rc = 0;
  {
    std::unique_lock<std::mutex> lk(l->mu);
    l->cv_pop.wait(lk, [&] { return !l->queue.empty() || l->done; });
    if (l->queue.empty()) return 0;
    buf = std::move(l->queue.front());
    l->queue.pop_front();
    rc = l->codes.front();
    l->codes.pop_front();
    l->cv_push.notify_one();
  }
  const size_t size = static_cast<size_t>(l->out_h) * l->out_w * 3;
  if (rc != 0) {
    std::memset(dst, 0, size);
    return -rc;
  }
  std::memcpy(dst, buf.data(), size);
  return 1;
}

void vio_loader_destroy(void* handle) {
  Loader* l = static_cast<Loader*>(handle);
  l->stop.store(true);
  l->cv_push.notify_all();
  l->cv_pop.notify_all();
  try {
    if (l->worker.joinable()) l->worker.join();
  } catch (const std::exception& e) {
    thrown(e.what());
  }
  delete l;
}

}  // extern "C"
