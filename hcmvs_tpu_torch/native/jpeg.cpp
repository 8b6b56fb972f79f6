// JPEG decoder giving the samples cv2.imread gives with OpenCV's
// libjpeg-turbo build: the ISLOW integer IDCT (jidctint.c), fancy
// upsampling (jdsample.c) and the YCbCr -> RGB tables (jdcolor.c), with
// the colour space decided as jdapimin.c decides it.
//
// Scope: SOF0 / SOF1 / SOF2 (baseline, extended Huffman, progressive) at
// 8-bit precision, 1 or 3 components, sampling factors 1-4 with integral
// ratios; DHT, DQT (8- and 16-bit), DRI with RSTn, SOS; APPn and COM are
// skipped (APP0 JFIF, APP14 Adobe and the first APP1 are noted).  The
// whole image is entropy-decoded into coefficient planes, then each
// component goes through the IDCT into a sample plane, is upsampled to
// full size and converted.  Arithmetic coding, lossless and hierarchical
// processes, 12-bit precision and four-component (CMYK / YCCK) files are
// reported as unsupported; a truncated or corrupt stream as corrupt.
//
// Entry points (ctypes):
//   int hcmvs_jpeg_header(data, n, info[10], msg, msg_len)
//     info = width, height, components, precision, SOF marker, colour
//     space (0 gray, 1 YCbCr, 2 RGB), offset and length of the first
//     APP1 segment's body (0, 0 if none), progressive, restart interval;
//   int hcmvs_jpeg_decode(data, n, mode, out, out_size, msg, msg_len)
//     mode 0: BGR (gray files replicated); 1: gray (the Y plane of a
//     YCbCr file, jdcolor.c's rgb_gray_convert of an RGB one); 2: as
//     stored (gray for one component, else BGR).
//   Both return 0 on success, 1 for an unsupported feature, 2 for a
//   corrupt or truncated stream (msg names it).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

enum Status { kOk = 0, kUnsupported = 1, kCorrupt = 2 };

struct Failure {
  int code;
  std::string msg;
};

[[noreturn]] void fail(int code, const std::string& msg) {
  throw Failure{code, msg};
}

// zigzag index -> natural (row-major) index, with 16 extra entries for
// run lengths that overshoot the block (as libjpeg's jpeg_natural_order)
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool defined = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  // 9-bit lookahead: code length (0 = longer) and symbol
  uint8_t look_len[512];
  uint8_t look_sym[512];

  void build(const uint8_t* counts, const uint8_t* symbols, int nsym,
             bool dc) {
    uint8_t size[257];
    int32_t code_of[257];
    int p = 0;
    for (int l = 1; l <= 16; l++)
      for (int i = 0; i < counts[l - 1]; i++) size[p++] = (uint8_t)l;
    size[p] = 0;
    int32_t code = 0;
    int si = size[0];
    p = 0;
    while (size[p]) {
      while (size[p] == si) code_of[p++] = code++;
      if (code >= (1 << si)) fail(kCorrupt, "bad Huffman table");
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (counts[l - 1]) {
        valoffset[l] = p - code_of[p];
        p += counts[l - 1];
        maxcode[l] = code_of[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;
    memcpy(vals, symbols, nsym);
    if (dc)
      for (int i = 0; i < nsym; i++)
        if (symbols[i] > 15) fail(kCorrupt, "bad DC Huffman table");
    memset(look_len, 0, sizeof(look_len));
    p = 0;
    for (int l = 1; l <= 9; l++)
      for (int i = 0; i < counts[l - 1]; i++, p++) {
        int base = code_of[p] << (9 - l);
        for (int j = 0; j < (1 << (9 - l)); j++) {
          look_len[base + j] = (uint8_t)l;
          look_sym[base + j] = symbols[p];
        }
      }
    defined = true;
  }
};

// Entropy-coded data: bytes with FF 00 stuffing, ended by a marker.  Past
// the marker the reader feeds zero bits, but consuming any of them is a
// truncated or corrupt segment.
struct BitReader {
  const uint8_t* d = nullptr;
  size_t n = 0, pos = 0;
  uint64_t buf = 0;
  int cnt = 0;        // bits in buf
  int virt = 0;       // of which zero bits fed past the marker
  bool at_marker = false;

  void start(const uint8_t* data, size_t len, size_t at) {
    d = data;
    n = len;
    pos = at;
    buf = 0;
    cnt = virt = 0;
    at_marker = false;
  }
  void fill() {
    while (cnt <= 56) {
      uint64_t byte = 0;
      if (at_marker || pos >= n) {
        at_marker = true;
        virt += 8;
      } else if (d[pos] != 0xFF) {
        byte = d[pos++];
      } else {
        size_t q = pos + 1;
        while (q < n && d[q] == 0xFF) q++;
        if (q < n && d[q] == 0) {
          byte = 0xFF;
          pos = q + 1;
        } else {
          at_marker = true;   // pos stays on the marker's first FF
          virt += 8;
        }
      }
      buf |= byte << (56 - cnt);
      cnt += 8;
    }
  }
  void consume(int k) {
    if (cnt - virt < k) fail(kCorrupt, "truncated or corrupt JPEG data");
    buf <<= k;
    cnt -= k;
  }
  int bits(int k) {
    if (k == 0) return 0;
    if (cnt < k) fill();
    int v = (int)(buf >> (64 - k));
    consume(k);
    return v;
  }
  int bit() { return bits(1); }
  int decode(const Huffman& h) {
    if (cnt < 16) fill();
    int look = (int)(buf >> 55);
    int l = h.look_len[look];
    if (l) {
      consume(l);
      return h.look_sym[look];
    }
    int32_t code = (int32_t)(buf >> 54);  // 10 bits
    l = 10;
    while (code > h.maxcode[l]) {
      l++;
      if (l > 16) fail(kCorrupt, "corrupt JPEG data: bad Huffman code");
      code = (int32_t)(buf >> (64 - l));
    }
    consume(l);
    return h.vals[(code + h.valoffset[l]) & 0xFF];
  }
  // drops the bits left before a restart marker or the scan's end
  void reset() {
    buf = 0;
    cnt = virt = 0;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;          // downsampled size
  int bw = 0, bh = 0;          // blocks in the MCU-padded grid
  int dc_tbl = 0, ac_tbl = 0;
  int pred = 0;
  bool latched = false;
  uint16_t q[64];              // quantization table, natural order
  std::vector<int16_t> coef;   // bw * bh blocks of 64, natural order
  int coef_bits[10];           // successive approximation state (0-9)
};

struct Decoder {
  const uint8_t* d;
  size_t n;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int width = 0, height = 0, ncomp = 0, precision = 0, sof = 0;
  bool frame = false, progressive = false;
  Component comp[4];
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  size_t app1_off = 0, app1_len = 0;
  BitReader br;
  int eobrun = 0;

  Decoder(const uint8_t* data, size_t len) : d(data), n(len) {}

  int u16(size_t at) const {
    if (at + 2 > n) fail(kCorrupt, "truncated JPEG header");
    return (d[at] << 8) | d[at + 1];
  }

  // the marker at or after pos (skipping stray bytes and fill FFs);
  // returns its code and leaves pos after it
  // (an FF 00 pair among skipped bytes is data, as in libjpeg's
  // next_marker)
  int next_marker(size_t& pos) const {
    for (;;) {
      while (pos < n && d[pos] != 0xFF) pos++;
      while (pos < n && d[pos] == 0xFF) pos++;
      if (pos >= n) fail(kCorrupt, "truncated JPEG");
      if (d[pos++] != 0) return d[pos - 1];
    }
  }

  int colour_space() const {
    if (ncomp == 1) return 0;
    if (jfif) return 1;
    if (adobe) return adobe_transform == 0 ? 2 : 1;
    if (comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66) return 2;
    return 1;
  }

  void parse_frame(size_t at, int len, int marker) {
    if (frame) fail(kCorrupt, "JPEG with two frames");
    if (len < 8) fail(kCorrupt, "bad SOF segment");
    precision = d[at];
    height = u16(at + 1);
    width = u16(at + 3);
    ncomp = d[at + 5];
    sof = marker;
    progressive = marker == 0xC2;
    if (precision != 8)
      fail(kUnsupported, std::to_string(precision) +
                             "-bit JPEG (8-bit precision only)");
    if (ncomp == 4)
      fail(kUnsupported, "CMYK / YCCK JPEG (4 components)");
    if (ncomp != 1 && ncomp != 3)
      fail(kUnsupported, "JPEG with " + std::to_string(ncomp) +
                             " components (1 or 3 only)");
    if (height == 0)
      fail(kUnsupported, "JPEG height given by a DNL marker");
    if (width == 0) fail(kCorrupt, "JPEG of width 0");
    if (len < 6 + 3 * ncomp) fail(kCorrupt, "bad SOF segment");
    for (int c = 0; c < ncomp; c++) {
      Component& k = comp[c];
      k.id = d[at + 6 + 3 * c];
      k.h = d[at + 7 + 3 * c] >> 4;
      k.v = d[at + 7 + 3 * c] & 15;
      k.tq = d[at + 8 + 3 * c];
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4)
        fail(kCorrupt, "bad JPEG sampling factors");
      if (k.tq > 3) fail(kCorrupt, "bad JPEG quantization table id");
      hmax = std::max(hmax, k.h);
      vmax = std::max(vmax, k.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int c = 0; c < ncomp; c++) {
      Component& k = comp[c];
      k.dw = (int)(((int64_t)width * k.h + hmax - 1) / hmax);
      k.dh = (int)(((int64_t)height * k.v + vmax - 1) / vmax);
      k.bw = mcux * k.h;
      k.bh = mcuy * k.v;
      for (int i = 0; i < 10; i++) k.coef_bits[i] = -1;
    }
    frame = true;
  }

  void parse_dht(size_t at, int len) {
    size_t end = at + len;
    while (at < end) {
      if (at + 17 > end) fail(kCorrupt, "bad DHT segment");
      int cls = d[at] >> 4, id = d[at] & 15;
      if (cls > 1 || id > 3) fail(kCorrupt, "bad DHT table id");
      int nsym = 0;
      for (int i = 0; i < 16; i++) nsym += d[at + 1 + i];
      if (nsym > 256 || at + 17 + nsym > end)
        fail(kCorrupt, "bad DHT segment");
      (cls ? ac : dc)[id].build(d + at + 1, d + at + 17, nsym, cls == 0);
      at += 17 + nsym;
    }
  }

  void parse_dqt(size_t at, int len) {
    size_t end = at + len;
    while (at < end) {
      int pq = d[at] >> 4, id = d[at] & 15;
      if (id > 3 || pq > 1) fail(kCorrupt, "bad DQT segment");
      if (at + 1 + 64 * (pq + 1) > end) fail(kCorrupt, "bad DQT segment");
      for (int i = 0; i < 64; i++)
        qt[id][kNatural[i]] = pq ? (uint16_t)((d[at + 1 + 2 * i] << 8) |
                                              d[at + 2 + 2 * i])
                                 : d[at + 1 + i];
      qt_defined[id] = true;
      at += 1 + 64 * (pq + 1);
    }
  }

  void parse_app(size_t at, int len, int marker) {
    if (marker == 0xE0 && len >= 14 && !memcmp(d + at, "JFIF\0", 5))
      jfif = true;
    if (marker == 0xEE && len >= 12 && !memcmp(d + at, "Adobe", 5)) {
      adobe = true;
      adobe_transform = d[at + 11];
    }
    if (marker == 0xE1 && app1_len == 0 && len > 0) {
      app1_off = at;
      app1_len = len;
    }
  }

  // header segments up to the first SOS (or all of them with decode)
  size_t read_header() {
    size_t pos = 0;
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) fail(kCorrupt, "not a JPEG");
    pos = 2;
    for (;;) {
      int m = next_marker(pos);
      if (m == 0xD8 || m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      if (m == 0xD9) fail(kCorrupt, "JPEG without image data");
      int len = u16(pos) - 2;
      if (len < 0 || pos + 2 + len > n) fail(kCorrupt, "truncated JPEG");
      size_t at = pos + 2;
      if (m == 0xDA) {
        if (!frame) fail(kCorrupt, "JPEG scan before its frame");
        return pos - 2;
      }
      handle(m, at, len);
      pos = at + len;
    }
  }

  void handle(int m, size_t at, int len) {
    if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
      parse_frame(at, len, m);
    } else if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) {
      fail(kUnsupported, "lossless JPEG");
    } else if (m == 0xC9 || m == 0xCA || m == 0xCC) {
      fail(kUnsupported, "arithmetic-coded JPEG");
    } else if (m == 0xC5 || m == 0xC6 || m == 0xCD || m == 0xCE ||
               m == 0xDE || m == 0xDF) {
      fail(kUnsupported, "hierarchical JPEG");
    } else if (m == 0xC4) {
      parse_dht(at, len);
    } else if (m == 0xDB) {
      parse_dqt(at, len);
    } else if (m == 0xDD) {
      if (len < 2) fail(kCorrupt, "bad DRI segment");
      restart_interval = u16(at);
    } else if (m >= 0xE0 && m <= 0xEF) {
      parse_app(at, len, m);
    }
  }

  // ---- scans ----
  int ns = 0;
  int sc[4];
  int ss = 0, se = 63, ah = 0, al = 0;

  void decode_block_baseline(Component& k, int16_t* blk) {
    const Huffman& hd = dc[k.dc_tbl];
    const Huffman& ha = ac[k.ac_tbl];
    int s = br.decode(hd);
    int diff = s ? extend(br.bits(s), s) : 0;
    k.pred += diff;
    blk[0] = (int16_t)k.pred;
    for (int i = 1; i < 64; i++) {
      int rs = br.decode(ha);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        i += r;
        blk[kNatural[i]] = (int16_t)extend(br.bits(s), s);
      } else {
        if (r != 15) break;
        i += 15;
      }
    }
  }

  void decode_dc_first(Component& k, int16_t* blk) {
    int s = br.decode(dc[k.dc_tbl]);
    int diff = s ? extend(br.bits(s), s) : 0;
    k.pred += diff;
    blk[0] = (int16_t)(k.pred * (1 << al));
  }

  void decode_dc_refine(int16_t* blk) {
    if (br.bit()) blk[0] = (int16_t)(blk[0] | (1 << al));
  }

  void decode_ac_first(Component& k, int16_t* blk) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    const Huffman& ha = ac[k.ac_tbl];
    for (int i = ss; i <= se; i++) {
      int rs = br.decode(ha);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        i += r;
        blk[kNatural[i]] = (int16_t)(extend(br.bits(s), s) * (1 << al));
      } else if (r == 15) {
        i += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.bits(r);
        eobrun--;
        break;
      }
    }
  }

  void refine_nonzero(int16_t& c, int p1) {
    if (br.bit() && (c & p1) == 0) c = (int16_t)(c >= 0 ? c + p1 : c - p1);
  }

  void decode_ac_refine(Component& k, int16_t* blk) {
    const int p1 = 1 << al;
    int i = ss;
    if (eobrun == 0) {
      const Huffman& ha = ac[k.ac_tbl];
      for (; i <= se; i++) {
        int rs = br.decode(ha);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.bit() ? p1 : -p1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          break;
        }
        do {
          int16_t& c = blk[kNatural[i]];
          if (c != 0) {
            refine_nonzero(c, p1);
          } else if (--r < 0) {
            break;
          }
          i++;
        } while (i <= se);
        if (s) blk[kNatural[i]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; i <= se; i++) {
        int16_t& c = blk[kNatural[i]];
        if (c != 0) refine_nonzero(c, p1);
      }
      eobrun--;
    }
  }

  void decode_block(Component& k, int bx, int by) {
    int16_t* blk = &k.coef[((size_t)by * k.bw + bx) * 64];
    if (!progressive)
      decode_block_baseline(k, blk);
    else if (ss == 0)
      ah ? decode_dc_refine(blk) : decode_dc_first(k, blk);
    else
      ah ? decode_ac_refine(k, blk) : decode_ac_first(k, blk);
  }

  void restart(int& next_rst) {
    br.reset();
    size_t p = br.pos;
    int m = next_marker(p);
    if (m != 0xD0 + next_rst)
      fail(kCorrupt, "corrupt JPEG data: missing restart marker");
    next_rst = (next_rst + 1) & 7;
    br.start(d, n, p);
    for (int c = 0; c < ns; c++) comp[sc[c]].pred = 0;
    eobrun = 0;
  }

  size_t parse_sos(size_t pos) {
    int len = u16(pos + 2) - 2;
    size_t at = pos + 4;
    if (len < 1 || at + len > n) fail(kCorrupt, "bad SOS segment");
    ns = d[at];
    if (ns < 1 || ns > 4 || len < 4 + 2 * ns)
      fail(kCorrupt, "bad SOS segment");
    for (int i = 0; i < ns; i++) {
      int id = d[at + 1 + 2 * i], c = 0;
      while (c < ncomp && comp[c].id != id) c++;
      if (c == ncomp) fail(kCorrupt, "SOS names an unknown component");
      sc[i] = c;
      comp[c].dc_tbl = d[at + 2 + 2 * i] >> 4;
      comp[c].ac_tbl = d[at + 2 + 2 * i] & 15;
      if (comp[c].dc_tbl > 3 || comp[c].ac_tbl > 3)
        fail(kCorrupt, "bad Huffman table id");
    }
    ss = d[at + 1 + 2 * ns];
    se = d[at + 2 + 2 * ns];
    ah = d[at + 3 + 2 * ns] >> 4;
    al = d[at + 3 + 2 * ns] & 15;
    if (progressive) {
      bool bad = ss > se || se > 63 || al > 13 || (ss == 0 && se != 0) ||
                 (ss > 0 && ns != 1);
      if (bad) fail(kCorrupt, "bad progressive scan parameters");
    } else if (ss != 0 || se != 63 || ah != 0 || al != 0) {
      // libjpeg ignores these in sequential files
      ss = 0;
      se = 63;
      ah = al = 0;
    }
    return at + len;
  }

  void decode_scan(size_t data_at) {
    for (int i = 0; i < ns; i++) {
      Component& k = comp[sc[i]];
      if (!k.latched) {
        if (!qt_defined[k.tq]) fail(kCorrupt, "JPEG without its DQT table");
        memcpy(k.q, qt[k.tq], sizeof(k.q));
        k.latched = true;
      }
      if (k.coef.empty()) k.coef.assign((size_t)k.bw * k.bh * 64, 0);
      bool need_dc = !progressive || ss == 0;
      bool need_ac = !progressive || ss > 0;
      if (need_dc && !(progressive && ah) && !dc[k.dc_tbl].defined)
        fail(kCorrupt, "JPEG without its DC Huffman table");
      if (need_ac && !ac[k.ac_tbl].defined)
        fail(kCorrupt, "JPEG without its AC Huffman table");
      k.pred = 0;
      if (progressive)
        for (int j = ss; j <= std::min(se, 9); j++) k.coef_bits[j] = al;
    }
    eobrun = 0;
    br.start(d, n, data_at);
    int next_rst = 0;
    if (ns == 1) {
      Component& k = comp[sc[0]];
      int nbx = (k.dw + 7) / 8, nby = (k.dh + 7) / 8;
      int64_t total = (int64_t)nbx * nby;
      for (int64_t m = 0; m < total; m++) {
        if (restart_interval && m && m % restart_interval == 0)
          restart(next_rst);
        decode_block(k, (int)(m % nbx), (int)(m / nbx));
      }
    } else {
      int64_t m = 0;
      for (int my = 0; my < mcuy; my++)
        for (int mx = 0; mx < mcux; mx++, m++) {
          if (restart_interval && m && m % restart_interval == 0)
            restart(next_rst);
          for (int i = 0; i < ns; i++) {
            Component& k = comp[sc[i]];
            for (int by = 0; by < k.v; by++)
              for (int bx = 0; bx < k.h; bx++)
                decode_block(k, mx * k.h + bx, my * k.v + by);
          }
        }
    }
  }

  void decode_all() {
    size_t pos = read_header();
    for (;;) {
      size_t data_at = parse_sos(pos);
      decode_scan(data_at);
      pos = br.pos;
      int m;
      for (;;) {
        if (pos >= n) {   // data ends after a scan: libjpeg supplies EOI
          m = 0xD9;
          break;
        }
        m = next_marker(pos);
        if (m == 0xD9 || m == 0xDA) break;
        if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
        int len = u16(pos) - 2;
        if (len < 0 || pos + 2 + len > n) fail(kCorrupt, "truncated JPEG");
        handle(m, pos + 2, len);
        pos += 2 + len;
      }
      if (m == 0xD9) break;
      pos -= 2;
    }
    for (int c = 0; c < ncomp; c++) {
      if (comp[c].coef.empty()) fail(kCorrupt, "JPEG component never coded");
      if (progressive)
        for (int j = 0; j < 10; j++)
          if (comp[c].coef_bits[j] != 0)
            fail(kUnsupported, "progressive JPEG with incomplete scans "
                               "(block smoothing)");
    }
  }
};

// ---- IDCT: jidctint.c's jpeg_idct_islow ----
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                  F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                  F1961 = 16069, F2053 = 16819, F2562 = 20995,
                  F3072 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + ((int64_t)1 << (n - 1))) >> n;
}

struct RangeLimit {
  uint8_t t[1024];   // indexed by the descaled value & 1023 (jdmaster.c)
  RangeLimit() {
    for (int i = 0; i < 1024; i++)
      t[i] = i < 128 ? i + 128 : i < 512 ? 255 : i < 896 ? 0 : i - 896;
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12,
        tmp13;
    z2 = (int64_t)ip[16] * qp[16];
    z3 = (int64_t)ip[48] * qp[48];
    z1 = (z2 + z3) * F0541;
    tmp2 = z1 + z3 * -F1847;
    tmp3 = z1 + z2 * F0765;
    z2 = (int64_t)ip[0] * qp[0];
    z3 = (int64_t)ip[32] * qp[32];
    tmp0 = (z2 + z3) * (1 << kConstBits);
    tmp1 = (z2 - z3) * (1 << kConstBits);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)ip[56] * qp[56];
    tmp1 = (int64_t)ip[40] * qp[40];
    tmp2 = (int64_t)ip[24] * qp[24];
    tmp3 = (int64_t)ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits - kPass1Bits;
    ws[c] = (int)descale(tmp10 + tmp3, sh);
    ws[c + 56] = (int)descale(tmp10 - tmp3, sh);
    ws[c + 8] = (int)descale(tmp11 + tmp2, sh);
    ws[c + 48] = (int)descale(tmp11 - tmp2, sh);
    ws[c + 16] = (int)descale(tmp12 + tmp1, sh);
    ws[c + 40] = (int)descale(tmp12 - tmp1, sh);
    ws[c + 24] = (int)descale(tmp13 + tmp0, sh);
    ws[c + 32] = (int)descale(tmp13 - tmp0, sh);
  }
  for (int r = 0; r < 8; r++) {
    const int* w = ws + 8 * r;
    uint8_t* op = out + (size_t)r * stride;
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12,
        tmp13;
    z2 = w[2];
    z3 = w[6];
    z1 = (z2 + z3) * F0541;
    tmp2 = z1 + z3 * -F1847;
    tmp3 = z1 + z2 * F0765;
    tmp0 = ((int64_t)w[0] + w[4]) * (1 << kConstBits);
    tmp1 = ((int64_t)w[0] - w[4]) * (1 << kConstBits);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConstBits + kPass1Bits + 3;
    op[0] = kRange.t[descale(tmp10 + tmp3, sh) & 1023];
    op[7] = kRange.t[descale(tmp10 - tmp3, sh) & 1023];
    op[1] = kRange.t[descale(tmp11 + tmp2, sh) & 1023];
    op[6] = kRange.t[descale(tmp11 - tmp2, sh) & 1023];
    op[2] = kRange.t[descale(tmp12 + tmp1, sh) & 1023];
    op[5] = kRange.t[descale(tmp12 - tmp1, sh) & 1023];
    op[3] = kRange.t[descale(tmp13 + tmp0, sh) & 1023];
    op[4] = kRange.t[descale(tmp13 - tmp0, sh) & 1023];
  }
}

// A component's samples: (nby * 8) rows of (nbx * 8), the blocks that
// cover its downsampled size.
struct Plane {
  int w = 0, h = 0, stride = 0;
  std::vector<uint8_t> px;
  uint8_t at(int x, int y) const { return px[(size_t)y * stride + x]; }
};

Plane inverse_dct(const Component& k) {
  Plane p;
  int nbx = (k.dw + 7) / 8, nby = (k.dh + 7) / 8;
  p.w = k.dw;
  p.h = k.dh;
  p.stride = nbx * 8;
  p.px.assign((size_t)p.stride * nby * 8, 0);
  for (int by = 0; by < nby; by++)
    for (int bx = 0; bx < nbx; bx++)
      idct_islow(&k.coef[((size_t)by * k.bw + bx) * 64], k.q,
                 &p.px[(size_t)by * 8 * p.stride + bx * 8], p.stride);
  return p;
}

// jdsample.c: the component's plane at full size (width x height)
std::vector<uint8_t> upsample(const Plane& p, int hr, int vr, int width,
                              int height) {
  std::vector<uint8_t> out((size_t)width * height);
  const int w = p.w, h = p.h;
  auto row = [&](int y) { return &p.px[(size_t)std::min(std::max(y, 0),
                                                       h - 1) * p.stride]; };
  if (hr == 1 && vr == 1) {
    for (int y = 0; y < height; y++) memcpy(&out[(size_t)y * width], row(y),
                                            width);
  } else if (hr == 2 && vr == 1 && w > 2) {              // h2v1 fancy
    std::vector<uint8_t> line(2 * (size_t)w);
    for (int y = 0; y < height; y++) {
      const uint8_t* in = row(y);
      line[0] = in[0];
      line[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
      for (int x = 1; x < w - 1; x++) {
        int v = in[x] * 3;
        line[2 * x] = (uint8_t)((v + in[x - 1] + 1) >> 2);
        line[2 * x + 1] = (uint8_t)((v + in[x + 1] + 2) >> 2);
      }
      line[2 * w - 2] = (uint8_t)((in[w - 1] * 3 + in[w - 2] + 1) >> 2);
      line[2 * w - 1] = in[w - 1];
      memcpy(&out[(size_t)y * width], line.data(), width);
    }
  } else if (hr == 1 && vr == 2) {                      // h1v2 fancy
    for (int y = 0; y < height; y++) {
      int r = y >> 1, up = y & 1;
      const uint8_t* near = row(r);
      const uint8_t* far = row(up ? r + 1 : r - 1);
      int bias = up ? 2 : 1;
      uint8_t* o = &out[(size_t)y * width];
      for (int x = 0; x < width; x++)
        o[x] = (uint8_t)((near[x] * 3 + far[x] + bias) >> 2);
    }
  } else if (hr == 2 && vr == 2 && w > 2) {              // h2v2 fancy
    std::vector<int> sum(w);
    std::vector<uint8_t> line(2 * (size_t)w);
    for (int y = 0; y < height; y++) {
      int r = y >> 1;
      const uint8_t* near = row(r);
      const uint8_t* far = row((y & 1) ? r + 1 : r - 1);
      for (int x = 0; x < w; x++) sum[x] = near[x] * 3 + far[x];
      line[0] = (uint8_t)((sum[0] * 4 + 8) >> 4);
      line[1] = (uint8_t)((sum[0] * 3 + sum[1] + 7) >> 4);
      for (int x = 1; x < w - 1; x++) {
        line[2 * x] = (uint8_t)((sum[x] * 3 + sum[x - 1] + 8) >> 4);
        line[2 * x + 1] = (uint8_t)((sum[x] * 3 + sum[x + 1] + 7) >> 4);
      }
      line[2 * w - 2] = (uint8_t)((sum[w - 1] * 3 + sum[w - 2] + 8) >> 4);
      line[2 * w - 1] = (uint8_t)((sum[w - 1] * 4 + 7) >> 4);
      memcpy(&out[(size_t)y * width], line.data(), width);
    }
  } else {                                    // replication (int_upsample)
    for (int y = 0; y < height; y++) {
      const uint8_t* in = row(y / vr);
      uint8_t* o = &out[(size_t)y * width];
      for (int x = 0; x < width; x++) o[x] = in[x / hr];
    }
  }
  return out;
}

constexpr int kScaleBits = 16;
constexpr int64_t kHalf = (int64_t)1 << (kScaleBits - 1);
inline int64_t fix(double x) {
  return (int64_t)(x * (1 << kScaleBits) + 0.5);
}

struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  int64_t r_y[256], g_y[256], b_y[256];
  YccTables() {
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + kHalf) >> kScaleBits);
      cb_b[i] = (int)((fix(1.77200) * x + kHalf) >> kScaleBits);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
      r_y[i] = fix(0.29900) * i;
      g_y[i] = fix(0.58700) * i;
      b_y[i] = fix(0.11400) * i + kHalf;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) {
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

void decode_into(const uint8_t* data, size_t n, int mode, uint8_t* out,
                 size_t out_size) {
  Decoder dec(data, n);
  dec.decode_all();
  const int W = dec.width, H = dec.height;
  const int space = dec.colour_space();
  const bool gray_out = mode == 1 || (mode == 2 && dec.ncomp == 1);
  const size_t npx = (size_t)W * H;
  if (out_size != npx * (gray_out ? 1 : 3))
    fail(kCorrupt, "output buffer of the wrong size");
  // components the output needs (jdcolor.c: gray from YCbCr reads Y only)
  int needed = (gray_out && space != 2) ? 1 : dec.ncomp;
  std::vector<std::vector<uint8_t>> full(needed);
  for (int c = 0; c < needed; c++) {
    const Component& k = dec.comp[c];
    if (dec.hmax % k.h || dec.vmax % k.v)
      fail(kUnsupported, "JPEG with fractional sampling ratios");
    Plane p = inverse_dct(k);
    full[c] = upsample(p, dec.hmax / k.h, dec.vmax / k.v, W, H);
  }
  if (gray_out) {
    if (space != 2) {
      memcpy(out, full[0].data(), npx);
    } else {
      for (size_t i = 0; i < npx; i++)
        out[i] = (uint8_t)((kYcc.r_y[full[0][i]] + kYcc.g_y[full[1][i]] +
                            kYcc.b_y[full[2][i]]) >> kScaleBits);
    }
    return;
  }
  if (dec.ncomp == 1) {
    for (size_t i = 0; i < npx; i++)
      out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = full[0][i];
  } else if (space == 2) {
    for (size_t i = 0; i < npx; i++) {
      out[3 * i] = full[2][i];
      out[3 * i + 1] = full[1][i];
      out[3 * i + 2] = full[0][i];
    }
  } else {
    for (size_t i = 0; i < npx; i++) {
      int y = full[0][i], cb = full[1][i], cr = full[2][i];
      out[3 * i + 2] = clamp255(y + kYcc.cr_r[cr]);
      out[3 * i + 1] = clamp255(
          y + (int)((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> kScaleBits));
      out[3 * i] = clamp255(y + kYcc.cb_b[cb]);
    }
  }
}

int report(const Failure& f, char* msg, int msg_len) {
  if (msg && msg_len > 0) {
    strncpy(msg, f.msg.c_str(), msg_len - 1);
    msg[msg_len - 1] = 0;
  }
  return f.code;
}

}  // namespace

extern "C" {

int hcmvs_jpeg_header(const uint8_t* data, int64_t n, int64_t* info,
                      char* msg, int msg_len) {
  try {
    Decoder dec(data, (size_t)n);
    dec.read_header();
    int64_t v[10] = {dec.width, dec.height, dec.ncomp, dec.precision,
                     dec.sof, dec.colour_space(), (int64_t)dec.app1_off,
                     (int64_t)dec.app1_len, dec.progressive,
                     dec.restart_interval};
    memcpy(info, v, sizeof(v));
    return kOk;
  } catch (const Failure& f) {
    return report(f, msg, msg_len);
  } catch (const std::exception& e) {
    return report(Failure{kCorrupt, e.what()}, msg, msg_len);
  }
}

int hcmvs_jpeg_decode(const uint8_t* data, int64_t n, int32_t mode,
                      uint8_t* out, int64_t out_size, char* msg,
                      int msg_len) {
  try {
    decode_into(data, (size_t)n, mode, out, (size_t)out_size);
    return kOk;
  } catch (const Failure& f) {
    return report(f, msg, msg_len);
  } catch (const std::exception& e) {
    return report(Failure{kCorrupt, e.what()}, msg, msg_len);
  }
}

}  // extern "C"
