// exr_lite: minimal self-contained OpenEXR scanline reader/writer.
//
// Native replacement for the reference's imageio+freeimage EXR path
// (reference: test/utils.py:4-6 downloads the freeimage plugin at import
// time; this environment is offline). Implements the public OpenEXR file
// layout (single-part scanline images):
//   read:  NONE, RLE, ZIPS, ZIP, PIZ compression; HALF/FLOAT/UINT channels
//   write: NONE, ZIP; HALF or FLOAT channels
// Exposed through a C ABI consumed via ctypes
// (diffusionhandles_tpu_torch/utils/exr.py, which builds it with g++ at
// first use). A copy of native/exr_lite.cpp, which the JAX package builds.
//
// Implementation written from the OpenEXR file-format specification
// ("OpenEXR File Layout"): zip predictor+interleave, PIZ bitmap/LUT +
// canonical Huffman + 2D wavelet.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>
#include <zlib.h>

namespace {

// ----------------------------------------------------------------- errors
thread_local std::string g_err;

int fail(const std::string& msg) {
  g_err = msg;
  return -1;
}

// ------------------------------------------------------------- half float
float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h >> 15) << 31;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t mant = h & 0x3ff;
  uint32_t f;
  if (exp == 0) {
    if (mant == 0) {
      f = sign;
    } else {  // subnormal
      exp = 127 - 15 + 1;
      while (!(mant & 0x400)) {
        mant <<= 1;
        exp--;
      }
      mant &= 0x3ff;
      f = sign | (exp << 23) | (mant << 13);
    }
  } else if (exp == 31) {
    f = sign | 0x7f800000u | (mant << 13);
  } else {
    f = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float out;
  std::memcpy(&out, &f, 4);
  return out;
}

uint16_t float_to_half(float x) {
  uint32_t f;
  std::memcpy(&f, &x, 4);
  uint32_t sign = (f >> 31) << 15;
  int32_t exp = (int32_t)((f >> 23) & 0xff) - 127 + 15;
  uint32_t mant = f & 0x7fffff;
  if (((f >> 23) & 0xff) == 0xff) {  // inf/nan
    return (uint16_t)(sign | 0x7c00 | (mant ? 0x200 : 0));
  }
  if (exp >= 31) return (uint16_t)(sign | 0x7c00);  // overflow -> inf
  if (exp <= 0) {                                   // subnormal / zero
    if (exp < -10) return (uint16_t)sign;
    mant |= 0x800000;
    uint32_t shift = (uint32_t)(14 - exp);
    uint32_t rounded = (mant + (1u << (shift - 1))) >> shift;
    return (uint16_t)(sign | rounded);
  }
  // round-to-nearest-even on the 13 dropped bits
  uint32_t out = sign | ((uint32_t)exp << 10) | (mant >> 13);
  if ((mant & 0x1fff) > 0x1000 ||
      ((mant & 0x1fff) == 0x1000 && (out & 1))) {
    out++;
  }
  return (uint16_t)out;
}

// ------------------------------------------------------------ byte reader
struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  bool need(size_t n) {
    if ((size_t)(end - p) < n) {
      ok = false;
      return false;
    }
    return true;
  }
  uint8_t u8() {
    if (!need(1)) return 0;
    return *p++;
  }
  uint32_t u32() {
    if (!need(4)) return 0;
    uint32_t v;
    std::memcpy(&v, p, 4);
    p += 4;
    return v;
  }
  uint64_t u64() {
    if (!need(8)) return 0;
    uint64_t v;
    std::memcpy(&v, p, 8);
    p += 8;
    return v;
  }
  int32_t i32() { return (int32_t)u32(); }
  uint16_t u16() {
    if (!need(2)) return 0;
    uint16_t v;
    std::memcpy(&v, p, 2);
    p += 2;
    return v;
  }
  std::string cstr(size_t maxlen = 256) {
    std::string s;
    while (p < end && *p && s.size() < maxlen) s.push_back((char)*p++);
    if (p < end && *p == 0) p++;
    else ok = false;
    return s;
  }
  void skip(size_t n) {
    if (need(n)) p += n;
  }
};

// -------------------------------------------------------------- zip codec
// OpenEXR zip: deflate over a buffer that was (1) split into two halves of
// even/odd bytes and (2) delta-coded with +128 bias.
void zip_reconstruct(std::vector<uint8_t>& buf) {
  for (size_t i = 1; i < buf.size(); i++) {
    int d = (int)buf[i - 1] + (int)buf[i] - 128;
    buf[i] = (uint8_t)d;
  }
  std::vector<uint8_t> out(buf.size());
  const uint8_t* s1 = buf.data();
  const uint8_t* s2 = buf.data() + (buf.size() + 1) / 2;
  for (size_t i = 0; i < buf.size(); i++) {
    out[i] = (i & 1) ? *s2++ : *s1++;
  }
  buf.swap(out);
}

void zip_prepare(std::vector<uint8_t>& buf) {
  std::vector<uint8_t> tmp(buf.size());
  uint8_t* t1 = tmp.data();
  uint8_t* t2 = tmp.data() + (buf.size() + 1) / 2;
  for (size_t i = 0; i < buf.size(); i++) {
    if (i & 1) *t2++ = buf[i];
    else *t1++ = buf[i];
  }
  int prev = (int)tmp.empty() ? 0 : (int)tmp[0];
  for (size_t i = 1; i < tmp.size(); i++) {
    int d = (int)tmp[i] - prev + (128 + 256);
    prev = (int)tmp[i];
    tmp[i] = (uint8_t)d;
  }
  buf.swap(tmp);
}

int inflate_to(const uint8_t* src, size_t n, std::vector<uint8_t>& dst) {
  uLongf len = (uLongf)dst.size();
  if (uncompress(dst.data(), &len, src, (uLong)n) != Z_OK ||
      len != dst.size()) {
    return fail("zlib inflate failed");
  }
  return 0;
}

// -------------------------------------------------------------- rle codec
int rle_decode(const uint8_t* src, size_t n, std::vector<uint8_t>& dst) {
  size_t o = 0;
  size_t i = 0;
  while (i < n) {
    int8_t count = (int8_t)src[i++];
    if (count < 0) {
      size_t c = (size_t)(-count);
      if (i + c > n || o + c > dst.size()) return fail("rle overflow");
      std::memcpy(dst.data() + o, src + i, c);
      i += c;
      o += c;
    } else {
      size_t c = (size_t)count + 1;
      if (i >= n || o + c > dst.size()) return fail("rle overflow");
      std::memset(dst.data() + o, src[i++], c);
      o += c;
    }
  }
  if (o != dst.size()) return fail("rle short output");
  return 0;
}

// -------------------------------------------------------------- PIZ codec
constexpr int kEncBits = 16;
constexpr int kEncSize = (1 << kEncBits) + 1;  // 65537
constexpr int kShortZeroRun = 59;
constexpr int kLongZeroRun = 63;
constexpr int kShortestLongRun = 2 + kLongZeroRun - kShortZeroRun;  // 6

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t c = 0;
  int lc = 0;

  int bit() {
    if (lc == 0) {
      if (p < end) {
        c = *p++;
        lc = 8;
      } else {
        c = 0;
        lc = 8;  // zero padding past the end (trailing flush bits)
      }
    }
    lc--;
    return (int)((c >> lc) & 1);
  }
  uint32_t bits(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; i++) v = (v << 1) | (uint32_t)bit();
    return v;
  }
};

// Canonical Huffman decode tables built from per-symbol code lengths.
struct HufDecoder {
  // per length: first canonical code, symbol count, offset into syms
  uint64_t base[59];
  int count[59];
  int offset[59];
  std::vector<int> syms;

  int build(const std::vector<uint8_t>& lens, int im, int iM) {
    int n[59];
    std::memset(n, 0, sizeof n);
    for (int i = im; i <= iM; i++) n[lens[i]]++;
    n[0] = 0;
    // canonical code assignment (longest codes get smallest values):
    // replicate hufCanonicalCodeTable's backward pass.
    uint64_t c = 0;
    uint64_t start[59];
    for (int i = 58; i > 0; --i) {
      uint64_t nc = (c + (uint64_t)n[i]) >> 1;
      start[i] = c;
      c = nc;
    }
    int total = 0;
    for (int l = 1; l <= 58; l++) {
      base[l] = start[l];
      count[l] = n[l];
      offset[l] = total;
      total += n[l];
    }
    syms.resize(total);
    int fill[59];
    std::memcpy(fill, offset, sizeof fill);
    for (int i = im; i <= iM; i++) {
      int l = lens[i];
      if (l > 0) syms[fill[l]++] = i;
    }
    return 0;
  }

  int decode_symbol(BitReader& br) const {
    uint64_t code = 0;
    for (int l = 1; l <= 58; l++) {
      code = (code << 1) | (uint64_t)br.bit();
      if (count[l] > 0 && code >= base[l] &&
          code < base[l] + (uint64_t)count[l]) {
        return syms[offset[l] + (int)(code - base[l])];
      }
    }
    return -1;
  }
};

int huf_uncompress(const uint8_t* src, size_t nsrc,
                   std::vector<uint16_t>& out) {
  if (nsrc < 20) return fail("huffman header truncated");
  Reader r{src, src + nsrc};
  uint32_t im = r.u32();
  uint32_t iM = r.u32();
  r.u32();  // tableLength (unused)
  uint32_t nBits = r.u32();
  r.u32();  // room
  if (im >= kEncSize || iM >= kEncSize || im > iM)
    return fail("bad huffman symbol range");

  // unpack the 6-bit-packed code length table
  std::vector<uint8_t> lens(kEncSize, 0);
  BitReader br{r.p, src + nsrc};
  for (uint32_t i = im; i <= iM;) {
    uint32_t l = br.bits(6);
    if (l == (uint32_t)kLongZeroRun) {
      uint32_t run = br.bits(8) + kShortestLongRun;
      if (i + run > iM + 1) return fail("huffman zero run overflow");
      for (uint32_t k = 0; k < run; k++) lens[i++] = 0;
    } else if (l >= (uint32_t)kShortZeroRun) {
      uint32_t run = l - kShortZeroRun + 2;
      if (i + run > iM + 1) return fail("huffman zero run overflow");
      for (uint32_t k = 0; k < run; k++) lens[i++] = 0;
    } else {
      lens[i++] = (uint8_t)l;
    }
  }
  // Data bits start at the byte after the (bit-packed) table: BitReader
  // advances p at byte-load time, so br.p already points there and any
  // leftover bits of the partially-consumed byte are discarded, matching
  // hufUnpackEncTable's byte-aligned handoff.
  const uint8_t* data = br.p;
  HufDecoder dec;
  if (dec.build(lens, (int)im, (int)iM) != 0) return -1;

  BitReader db{data, src + nsrc};
  size_t produced = 0;
  uint64_t consumed_cap = nBits;
  (void)consumed_cap;
  int rlc = (int)iM;
  while (produced < out.size()) {
    int s = dec.decode_symbol(db);
    if (s < 0) return fail("huffman decode error");
    if (s == rlc) {
      uint32_t cs = db.bits(8);
      if (produced == 0 || produced + cs > out.size())
        return fail("huffman rle overflow");
      uint16_t v = out[produced - 1];
      for (uint32_t k = 0; k < cs; k++) out[produced++] = v;
    } else {
      out[produced++] = (uint16_t)s;
    }
  }
  return 0;
}

// 2D wavelet decode (ImfWav semantics).
inline void wdec14(uint16_t l, uint16_t h, uint16_t& a, uint16_t& b) {
  int16_t ls = (int16_t)l;
  int16_t hs = (int16_t)h;
  int hi = hs;
  int ai = ls + (hi & 1) + (hi >> 1);
  int16_t as = (int16_t)ai;
  int16_t bs = (int16_t)(ai - hi);
  a = (uint16_t)as;
  b = (uint16_t)bs;
}

constexpr int kModMask = (1 << 16) - 1;
constexpr int kAOffset = 1 << 15;

inline void wdec16(uint16_t l, uint16_t h, uint16_t& a, uint16_t& b) {
  int m = l;
  int d = h;
  int bb = (m - (d >> 1)) & kModMask;
  int aa = (d + bb - kAOffset) & kModMask;
  b = (uint16_t)bb;
  a = (uint16_t)aa;
}

void wav2_decode(uint16_t* in, int nx, int ox, int ny, int oy, uint16_t mx) {
  bool w14 = (mx < (1 << 14));
  int n = (nx > ny) ? ny : nx;
  int p = 1;
  while (p <= n) p <<= 1;
  p >>= 2;
  int p2 = p << 1;

  while (p >= 1) {
    uint16_t* py = in;
    uint16_t* ey = in + (size_t)oy * (ny - p2);
    int oy1 = oy * p;
    int oy2 = oy * p2;
    int ox1 = ox * p;
    int ox2 = ox * p2;
    uint16_t i00, i01, i10, i11;

    for (; py <= ey; py += oy2) {
      uint16_t* px = py;
      uint16_t* ex = py + (size_t)ox * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t* p01 = px + ox1;
        uint16_t* p10 = px + oy1;
        uint16_t* p11 = p10 + ox1;
        if (w14) {
          wdec14(*px, *p10, i00, i10);
          wdec14(*p01, *p11, i01, i11);
          wdec14(i00, i01, *px, *p01);
          wdec14(i10, i11, *p10, *p11);
        } else {
          wdec16(*px, *p10, i00, i10);
          wdec16(*p01, *p11, i01, i11);
          wdec16(i00, i01, *px, *p01);
          wdec16(i10, i11, *p10, *p11);
        }
      }
      if (nx & p) {
        uint16_t* p10 = px + oy1;
        if (w14) {
          wdec14(*px, *p10, i00, *p10);
        } else {
          wdec16(*px, *p10, i00, *p10);
        }
        *px = i00;
      }
    }
    if (ny & p) {
      uint16_t* px = py;
      uint16_t* ex = py + (size_t)ox * (nx - p2);
      for (; px <= ex; px += ox2) {
        uint16_t* p01 = px + ox1;
        if (w14) {
          wdec14(*px, *p01, i00, *p01);
        } else {
          wdec16(*px, *p01, i00, *p01);
        }
        *px = i00;
      }
    }
    p2 = p;
    p >>= 1;
  }
}

// ----------------------------------------------------------- file structs
struct Channel {
  std::string name;
  int pixel_type;  // 0 uint, 1 half, 2 float
  size_t bytes() const { return pixel_type == 1 ? 2 : 4; }
};

struct ExrHeader {
  std::vector<Channel> channels;
  int compression = -1;
  int32_t xmin = 0, ymin = 0, xmax = -1, ymax = -1;
  int line_order = 0;
  int width() const { return xmax - xmin + 1; }
  int height() const { return ymax - ymin + 1; }
};

int lines_per_chunk(int compression) {
  switch (compression) {
    case 0:  // NONE
    case 1:  // RLE
    case 2:  // ZIPS
      return 1;
    case 3:  // ZIP
      return 16;
    case 4:  // PIZ
      return 32;
    default:
      return -1;
  }
}

int parse_header(Reader& r, ExrHeader& h) {
  if (r.u32() != 20000630u) return fail("not an EXR file (bad magic)");
  uint32_t version = r.u32();
  if ((version & 0xff) != 2) return fail("unsupported EXR version");
  if (version & 0x200) return fail("tiled EXR not supported");
  if (version & 0x1000) return fail("multi-part EXR not supported");
  if (version & 0x800) return fail("deep EXR not supported");

  while (r.ok) {
    std::string name = r.cstr();
    if (name.empty()) break;  // end of header
    std::string type = r.cstr();
    int32_t size = r.i32();
    if (!r.ok || size < 0 || !r.need((size_t)size)) {
      return fail("truncated header attribute");
    }
    const uint8_t* attr_end = r.p + size;
    if (name == "channels" && type == "chlist") {
      while (r.p < attr_end - 1) {
        Channel c;
        c.name = r.cstr();
        if (c.name.empty()) break;
        c.pixel_type = r.i32();
        r.skip(4);  // pLinear + reserved
        r.skip(8);  // x/y sampling
        if (c.pixel_type < 0 || c.pixel_type > 2)
          return fail("bad channel pixel type");
        h.channels.push_back(c);
      }
    } else if (name == "compression" && type == "compression") {
      h.compression = r.u8();
    } else if (name == "dataWindow" && type == "box2i") {
      h.xmin = r.i32();
      h.ymin = r.i32();
      h.xmax = r.i32();
      h.ymax = r.i32();
    } else if (name == "lineOrder" && type == "lineOrder") {
      h.line_order = r.u8();
    }
    r.p = attr_end;
  }
  if (!r.ok) return fail("truncated header");
  if (h.channels.empty()) return fail("no channels");
  if (h.compression < 0) return fail("no compression attribute");
  if (h.width() <= 0 || h.height() <= 0) return fail("bad data window");
  if (h.line_order != 0 && h.line_order != 1)
    return fail("unsupported line order");
  return 0;
}

// Decode one PIZ chunk into the scanline-interleaved raw layout.
int piz_decode_chunk(const uint8_t* src, size_t nsrc, const ExrHeader& h,
                     int chunk_lines, std::vector<uint8_t>& raw) {
  Reader r{src, src + nsrc};
  uint16_t min_nz = r.u16();
  uint16_t max_nz = r.u16();
  if (!r.ok) return fail("piz bitmap truncated");
  std::vector<uint8_t> bitmap(8192, 0);
  if (min_nz <= max_nz) {
    size_t n = (size_t)max_nz - min_nz + 1;
    if (!r.need(n)) return fail("piz bitmap truncated");
    std::memcpy(bitmap.data() + min_nz, r.p, n);
    r.p += n;
  }
  // reverse LUT
  std::vector<uint16_t> lut(1 << 16);
  int k = 0;
  for (int i = 0; i < (1 << 16); i++) {
    if (i == 0 || (bitmap[i >> 3] & (1 << (i & 7)))) {
      lut[k++] = (uint16_t)i;
    }
  }
  uint16_t max_value = (uint16_t)(k - 1);

  int32_t huf_len = r.i32();
  if (!r.ok || huf_len < 0 || !r.need((size_t)huf_len))
    return fail("piz huffman data truncated");

  // per-channel u16 geometry within the chunk
  int w = h.width();
  size_t total = 0;
  std::vector<size_t> ch_off;
  std::vector<int> ch_units;  // u16 units per sample
  for (const auto& c : h.channels) {
    int units = (int)(c.bytes() / 2);
    ch_off.push_back(total);
    ch_units.push_back(units);
    total += (size_t)w * units * chunk_lines;
  }
  std::vector<uint16_t> tmp(total);
  if (huf_uncompress(r.p, (size_t)huf_len, tmp) != 0) return -1;

  // wavelet decode each channel rectangle, then apply LUT
  for (size_t ci = 0; ci < h.channels.size(); ci++) {
    int nx = w * ch_units[ci];
    wav2_decode(tmp.data() + ch_off[ci], nx, 1, chunk_lines, nx, max_value);
  }
  for (auto& v : tmp) v = lut[v];

  // repack to scanline-interleaved raw bytes
  raw.clear();
  size_t line_bytes = 0;
  for (const auto& c : h.channels) line_bytes += (size_t)w * c.bytes();
  raw.resize(line_bytes * chunk_lines);
  size_t o = 0;
  for (int y = 0; y < chunk_lines; y++) {
    for (size_t ci = 0; ci < h.channels.size(); ci++) {
      int nx = w * ch_units[ci];
      const uint16_t* line = tmp.data() + ch_off[ci] + (size_t)y * nx;
      std::memcpy(raw.data() + o, line, (size_t)nx * 2);
      o += (size_t)nx * 2;
    }
  }
  return 0;
}

}  // namespace

// ------------------------------------------------------------------ C API
extern "C" {

const char* exr_last_error() { return g_err.c_str(); }

// Query image dimensions/channels. Returns 0 on success. If `names` is
// non-null it receives the ';'-separated channel names in file order
// (truncated to names_cap bytes including the terminator).
int exr_info_names(const char* path, int* width, int* height, int* channels,
                   char* names, int names_cap) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return fail(std::string("cannot open ") + path);
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> data((size_t)sz);
  if (std::fread(data.data(), 1, (size_t)sz, f) != (size_t)sz) {
    std::fclose(f);
    return fail("short read");
  }
  std::fclose(f);
  Reader r{data.data(), data.data() + data.size()};
  ExrHeader h;
  if (parse_header(r, h) != 0) return -1;
  *width = h.width();
  *height = h.height();
  *channels = (int)h.channels.size();
  if (names && names_cap > 0) {
    std::string joined;
    for (size_t i = 0; i < h.channels.size(); i++) {
      if (i) joined += ';';
      joined += h.channels[i].name;
    }
    std::snprintf(names, (size_t)names_cap, "%s", joined.c_str());
  }
  return 0;
}

// Query image dimensions/channels. Returns 0 on success.
int exr_info(const char* path, int* width, int* height, int* channels) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return fail(std::string("cannot open ") + path);
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> data((size_t)sz);
  if (std::fread(data.data(), 1, (size_t)sz, f) != (size_t)sz) {
    std::fclose(f);
    return fail("short read");
  }
  std::fclose(f);
  Reader r{data.data(), data.data() + data.size()};
  ExrHeader h;
  if (parse_header(r, h) != 0) return -1;
  *width = h.width();
  *height = h.height();
  *channels = (int)h.channels.size();
  return 0;
}

// Read pixel data as float32, layout [height, width, channels] with
// channels in file (alphabetical) order. `out` must hold w*h*c floats.
int exr_read(const char* path, float* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return fail(std::string("cannot open ") + path);
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> data((size_t)sz);
  if (std::fread(data.data(), 1, (size_t)sz, f) != (size_t)sz) {
    std::fclose(f);
    return fail("short read");
  }
  std::fclose(f);

  Reader r{data.data(), data.data() + data.size()};
  ExrHeader h;
  if (parse_header(r, h) != 0) return -1;
  int lpc = lines_per_chunk(h.compression);
  if (lpc < 0) return fail("unsupported compression type");

  int w = h.width();
  int ht = h.height();
  int nc = (int)h.channels.size();
  int nchunks = (ht + lpc - 1) / lpc;

  // scanline offset table
  if (!r.need((size_t)nchunks * 8)) return fail("truncated offset table");
  std::vector<uint64_t> offsets(nchunks);
  for (int i = 0; i < nchunks; i++) offsets[i] = r.u64();

  size_t line_bytes = 0;
  for (const auto& c : h.channels) line_bytes += (size_t)w * c.bytes();

  std::vector<uint8_t> raw;
  for (int ci = 0; ci < nchunks; ci++) {
    if (offsets[ci] + 8 > data.size()) return fail("bad chunk offset");
    Reader cr{data.data() + offsets[ci], data.data() + data.size()};
    int32_t y = cr.i32();
    int32_t dsize = cr.i32();
    if (!cr.ok || dsize < 0 || !cr.need((size_t)dsize))
      return fail("truncated chunk");
    int y0 = y - h.ymin;
    int lines = lpc;
    if (y0 + lines > ht) lines = ht - y0;
    size_t raw_size = line_bytes * lines;

    if (h.compression == 0 || (size_t)dsize >= raw_size) {
      if ((size_t)dsize < raw_size) return fail("short uncompressed chunk");
      raw.assign(cr.p, cr.p + raw_size);
    } else if (h.compression == 2 || h.compression == 3) {  // ZIPS/ZIP
      raw.resize(raw_size);
      if (inflate_to(cr.p, (size_t)dsize, raw) != 0) return -1;
      zip_reconstruct(raw);
    } else if (h.compression == 1) {  // RLE
      raw.resize(raw_size);
      if (rle_decode(cr.p, (size_t)dsize, raw) != 0) return -1;
      zip_reconstruct(raw);
    } else if (h.compression == 4) {  // PIZ
      if (piz_decode_chunk(cr.p, (size_t)dsize, h, lines, raw) != 0)
        return -1;
    } else {
      return fail("unsupported compression type");
    }

    // convert to float32 interleaved output
    for (int ly = 0; ly < lines; ly++) {
      const uint8_t* lp = raw.data() + line_bytes * ly;
      float* orow = out + ((size_t)(y0 + ly) * w) * nc;
      for (int c = 0; c < nc; c++) {
        const Channel& ch = h.channels[c];
        if (ch.pixel_type == 1) {  // half
          const uint16_t* src16 = (const uint16_t*)lp;
          for (int x = 0; x < w; x++)
            orow[(size_t)x * nc + c] = half_to_float(src16[x]);
        } else if (ch.pixel_type == 2) {  // float
          const float* srcf = (const float*)lp;
          for (int x = 0; x < w; x++) orow[(size_t)x * nc + c] = srcf[x];
        } else {  // uint
          const uint32_t* srcu = (const uint32_t*)lp;
          for (int x = 0; x < w; x++)
            orow[(size_t)x * nc + c] = (float)srcu[x];
        }
        lp += (size_t)w * ch.bytes();
      }
    }
  }
  return 0;
}

// Write a float32 [height, width, channels] buffer. channel_names is a
// ';'-separated list (alphabetical order is the writer's responsibility —
// this writer sorts internally). pixel_type: 1=half, 2=float.
// compression: 0=none, 3=zip.
int exr_write(const char* path, const float* data, int width, int height,
              int nchan, const char* channel_names, int pixel_type,
              int compression) {
  if (pixel_type != 1 && pixel_type != 2) return fail("bad pixel type");
  if (compression != 0 && compression != 3) return fail("bad compression");
  if (nchan < 1 || nchan > 64) return fail("bad channel count");

  // split and sort channel names (EXR requires alphabetical order)
  std::vector<std::pair<std::string, int>> chans;  // name, source index
  {
    std::string s(channel_names ? channel_names : "");
    size_t pos = 0;
    int idx = 0;
    while (idx < nchan) {
      size_t semi = s.find(';', pos);
      std::string nm = (pos < s.size())
                           ? s.substr(pos, semi == std::string::npos
                                               ? std::string::npos
                                               : semi - pos)
                           : std::string(1, (char)('A' + idx));
      if (nm.empty()) nm = std::string(1, (char)('A' + idx));
      chans.push_back({nm, idx});
      pos = (semi == std::string::npos) ? s.size() + 1 : semi + 1;
      idx++;
    }
    std::sort(chans.begin(), chans.end());
  }

  std::vector<uint8_t> out;
  auto put = [&](const void* p, size_t n) {
    const uint8_t* b = (const uint8_t*)p;
    out.insert(out.end(), b, b + n);
  };
  auto put_str = [&](const std::string& s) {
    put(s.c_str(), s.size() + 1);
  };
  auto put_u32 = [&](uint32_t v) { put(&v, 4); };
  auto put_i32 = [&](int32_t v) { put(&v, 4); };

  put_u32(20000630u);
  put_u32(2u);

  // channels attribute
  {
    std::vector<uint8_t> ch;
    auto cput = [&](const void* p, size_t n) {
      const uint8_t* b = (const uint8_t*)p;
      ch.insert(ch.end(), b, b + n);
    };
    for (auto& [nm, src] : chans) {
      cput(nm.c_str(), nm.size() + 1);
      int32_t pt = pixel_type;
      cput(&pt, 4);
      uint32_t plin = 0;
      cput(&plin, 4);
      int32_t samp = 1;
      cput(&samp, 4);
      cput(&samp, 4);
    }
    uint8_t zero = 0;
    cput(&zero, 1);
    put_str("channels");
    put_str("chlist");
    put_i32((int32_t)ch.size());
    put(ch.data(), ch.size());
  }
  put_str("compression");
  put_str("compression");
  put_i32(1);
  out.push_back((uint8_t)compression);
  for (const char* nm : {"dataWindow", "displayWindow"}) {
    put_str(nm);
    put_str("box2i");
    put_i32(16);
    put_i32(0);
    put_i32(0);
    put_i32(width - 1);
    put_i32(height - 1);
  }
  put_str("lineOrder");
  put_str("lineOrder");
  put_i32(1);
  out.push_back(0);
  put_str("pixelAspectRatio");
  put_str("float");
  put_i32(4);
  float par = 1.0f;
  put(&par, 4);
  put_str("screenWindowCenter");
  put_str("v2f");
  put_i32(8);
  float swc[2] = {0.0f, 0.0f};
  put(swc, 8);
  put_str("screenWindowWidth");
  put_str("float");
  put_i32(4);
  float sww = 1.0f;
  put(&sww, 4);
  out.push_back(0);  // end of header

  int lpc = lines_per_chunk(compression);
  int nchunks = (height + lpc - 1) / lpc;
  size_t table_pos = out.size();
  out.resize(out.size() + (size_t)nchunks * 8);

  size_t chan_bytes = (pixel_type == 1) ? 2 : 4;
  size_t line_bytes = (size_t)width * nchan * chan_bytes;

  std::vector<uint8_t> raw;
  std::vector<uint8_t> comp;
  for (int ci = 0; ci < nchunks; ci++) {
    int y0 = ci * lpc;
    int lines = std::min(lpc, height - y0);
    raw.resize(line_bytes * lines);
    uint8_t* rp = raw.data();
    for (int ly = 0; ly < lines; ly++) {
      const float* irow = data + ((size_t)(y0 + ly) * width) * nchan;
      for (auto& [nm, src] : chans) {
        if (pixel_type == 1) {
          uint16_t* o16 = (uint16_t*)rp;
          for (int x = 0; x < width; x++)
            o16[x] = float_to_half(irow[(size_t)x * nchan + src]);
        } else {
          float* of = (float*)rp;
          for (int x = 0; x < width; x++)
            of[x] = irow[(size_t)x * nchan + src];
        }
        rp += (size_t)width * chan_bytes;
      }
    }

    uint64_t offset = out.size();
    std::memcpy(out.data() + table_pos + (size_t)ci * 8, &offset, 8);
    put_i32(y0);
    if (compression == 3) {
      std::vector<uint8_t> prep = raw;
      zip_prepare(prep);
      uLongf clen = compressBound((uLong)prep.size());
      comp.resize(clen);
      if (compress2(comp.data(), &clen, prep.data(), (uLong)prep.size(),
                    Z_DEFAULT_COMPRESSION) != Z_OK)
        return fail("zlib deflate failed");
      if (clen < raw.size()) {
        put_i32((int32_t)clen);
        put(comp.data(), clen);
      } else {
        put_i32((int32_t)raw.size());
        put(raw.data(), raw.size());
      }
    } else {
      put_i32((int32_t)raw.size());
      put(raw.data(), raw.size());
    }
  }

  FILE* f = std::fopen(path, "wb");
  if (!f) return fail(std::string("cannot open for write: ") + path);
  size_t wr = std::fwrite(out.data(), 1, out.size(), f);
  std::fclose(f);
  if (wr != out.size()) return fail("short write");
  return 0;
}

}  // extern "C"
