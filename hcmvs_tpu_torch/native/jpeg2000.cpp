// JPEG 2000 (ITU-T T.800, Part 1) decoding to the components OpenJPEG
// 2.5.3's opj_decode gives, the decoder behind OpenCV 5.0's
// cv2.imread of .jp2 / .j2k files.
//
// The JP2 box or a raw codestream; SIZ, COD / COC, QCD / QCC, RGN, POC,
// PPM / PPT, TLM / PLM / PLT, COM and CRG markers; tile-parts of any tile
// in any order; SOP / EPH in packets; the packet headers' tag trees,
// pass counts and length indicators, layers and precincts in all five
// progression orders and POC changes (OpenJPEG's iterator, its
// already-included packets skipped); the MQ decoder and the three coding
// passes with their 19 contexts, every code-block style (bypass, reset,
// terminate each pass, vertically causal, predictable termination,
// segmentation symbols); ROI max-shift; reversible and scalar-quantised
// dequantisation with OpenJPEG's half-step reconstruction (coefficients
// carry one bit below their last decoded plane); the inverse 5/3 in
// integers and the inverse 9/7 in float32 with OpenJPEG's constants and
// order of operations (its "two_invK" high-band scale and the step sizes
// it compensates with); RCT / ICT; the DC level shift with OpenJPEG's
// rounding of the irreversible path (lrintf: half to even) and clamping;
// the JP2 palette (pclr + cmap) and channel definitions (cdef) applied as
// opj_jp2_decode applies them.
//
// Decoding is strict, as OpenJPEG's default decoder is: a tile-part
// longer than the stream, or a code-block segment running past its
// tile's data, fails the decode (cv2 then reads nothing).  A stream that
// ends at a tile-part boundary decodes only if an EOC marker follows:
// missing tiles stay 0, as in OpenJPEG's output image.
//
// This file must be compiled without floating-point contraction
// (-ffp-contract=off): a fused multiply-add in the 9/7 lifting or the ICT
// rounds differently from OpenJPEG's separate multiply and add.
//
// C interface (ctypes): hcmvs_jp2_info and hcmvs_jp2_decode; each returns
// 0, 1 for a feature or stream on which OpenJPEG / cv2 fail, 2 for a
// corrupt stream, with a message.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Unsupported : std::runtime_error {
    explicit Unsupported(const std::string& m) : std::runtime_error(m) {}
};
struct Corrupt : std::runtime_error {
    explicit Corrupt(const std::string& m) : std::runtime_error(m) {}
};

inline int ceildiv(int64_t a, int64_t b) {
    return (int)((a + b - 1) / b);
}
inline int ceildivpow2(int64_t a, int b) {
    return (int)((a + ((int64_t)1 << b) - 1) >> b);
}
inline int floordivpow2(int a, int b) { return a >> b; }

// ---------------------------------------------------------------- bytes

struct Reader {
    const uint8_t* p;
    size_t n, pos = 0;
    Reader(const uint8_t* d, size_t len) : p(d), n(len) {}
    size_t left() const { return n - pos; }
    void need(size_t k) const {
        if (pos + k > n) throw Corrupt("JPEG 2000 marker segment cut short");
    }
    uint32_t u8() { need(1); return p[pos++]; }
    uint32_t u16() { need(2); uint32_t v = (p[pos] << 8) | p[pos + 1];
                     pos += 2; return v; }
    uint32_t u32() { uint32_t v = u16() << 16; return v | u16(); }
    uint64_t u64() { uint64_t v = (uint64_t)u32() << 32; return v | u32(); }
};

// ---------------------------------------------------------------- params

const int MAXRLVLS = 33;
const int MAXBANDS = 3 * MAXRLVLS - 2;

struct StepSize { int expn = 0, mant = 0; };

struct TCCP {
    uint32_t csty = 0, numres = 0, cblkw = 0, cblkh = 0, cblksty = 0;
    uint32_t qmfbid = 0, qntsty = 0, numgbits = 0;
    int roishift = 0;
    StepSize steps[MAXBANDS];
    uint32_t prcw[MAXRLVLS], prch[MAXRLVLS];
};

struct Poc {
    uint32_t resno0 = 0, compno0 = 0, layno1 = 0, resno1 = 0, compno1 = 0;
    int prg = 0;
};

struct TCP {
    uint32_t csty = 0, numlayers = 0, mct = 0;
    int prg = 0;
    std::vector<TCCP> tccps;
    std::vector<Poc> pocs;
    bool cod = false;
    // tile state while reading
    std::vector<std::vector<uint8_t>> ppt_parts;   // by Zppt
    std::vector<uint8_t> data;                     // the tile-parts' bodies
    bool has_data = false, decoded = false;
    uint32_t nb_parts = 0, parts_read = 0;
};

struct Comp {
    uint32_t dx = 1, dy = 1, prec = 0, sgnd = 0;
    int x0 = 0, y0 = 0, w = 0, h = 0;
    uint16_t alpha = 0;
    std::vector<int32_t> data;
};

struct Image {
    int x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    std::vector<Comp> comps;
    int color_space = 0;          // OpenJPEG's OPJ_COLOR_SPACE
};

// OPJ_COLOR_SPACE values
const int CLRSPC_UNKNOWN = -1, CLRSPC_UNSPECIFIED = 0, CLRSPC_SRGB = 1,
          CLRSPC_GRAY = 2, CLRSPC_SYCC = 3, CLRSPC_EYCC = 4, CLRSPC_CMYK = 5;

// code-block styles
const uint32_t CBLK_LAZY = 1, CBLK_RESET = 2, CBLK_TERMALL = 4,
               CBLK_VSC = 8, CBLK_SEGSYM = 32, CBLK_HT = 64;

struct Codestream {
    Image image;
    uint32_t rsiz = 0, tdx = 0, tdy = 0, tw = 0, th = 0;
    int tx0 = 0, ty0 = 0;
    TCP deflt;
    std::vector<TCP> tcps;
    std::vector<std::vector<uint8_t>> ppm_parts;  // by Zppm
    bool ppm = false;
    std::vector<uint8_t> ppm_buf;                 // merged, Nppm removed
    size_t ppm_pos = 0;
};

// ---------------------------------------------------------------- markers

void read_spcod(Reader& r, TCCP& t, bool precincts) {
    t.numres = r.u8() + 1;
    if (t.numres > (uint32_t)MAXRLVLS)
        throw Corrupt("JPEG 2000 with more than 32 decomposition levels");
    t.cblkw = r.u8() + 2;
    t.cblkh = r.u8() + 2;
    if (t.cblkw > 10 || t.cblkh > 10 || t.cblkw + t.cblkh > 12)
        throw Corrupt("JPEG 2000 code-block size out of range");
    t.cblksty = r.u8();
    if (t.cblksty & 0x80)
        throw Unsupported("JPEG 2000 code-blocks in HT mixed mode "
                          "(cv2's OpenJPEG fails on them)");
    if (t.cblksty & CBLK_HT)
        throw Unsupported("High-Throughput JPEG 2000 (HTJ2K, Part 15) "
                          "code-blocks");
    t.qmfbid = r.u8();
    if (t.qmfbid > 1)
        throw Unsupported("JPEG 2000 Part 2 wavelet kernel (ATK)");
    for (uint32_t i = 0; i < t.numres; ++i) {
        if (precincts) {
            uint32_t v = r.u8();
            if (i != 0 && ((v & 15) == 0 || (v >> 4) == 0))
                throw Corrupt("JPEG 2000 invalid precinct size");
            t.prcw[i] = v & 15;
            t.prch[i] = v >> 4;
        } else {
            t.prcw[i] = 15;
            t.prch[i] = 15;
        }
    }
}

void read_sqcd(Reader& r, TCCP& t, size_t len) {
    uint32_t s = r.u8();
    t.qntsty = s & 0x1f;
    t.numgbits = s >> 5;
    --len;
    if (t.qntsty == 1) {
        if (len < 2) throw Corrupt("JPEG 2000 QCD / QCC cut short");
        uint32_t v = r.u16();
        t.steps[0].expn = v >> 11;
        t.steps[0].mant = v & 0x7ff;
        for (int b = 1; b < MAXBANDS; ++b) {
            int e = t.steps[0].expn - (b - 1) / 3;
            t.steps[b].expn = e > 0 ? e : 0;
            t.steps[b].mant = t.steps[0].mant;
        }
        r.pos += len - 2;
    } else if (t.qntsty == 0 || t.qntsty == 2) {
        size_t nb = t.qntsty == 0 ? len : len / 2;
        if (nb > (size_t)MAXBANDS) nb = MAXBANDS;
        for (size_t b = 0; b < nb; ++b) {
            if (t.qntsty == 0) {
                t.steps[b].expn = r.u8() >> 3;
                t.steps[b].mant = 0;
            } else {
                uint32_t v = r.u16();
                t.steps[b].expn = v >> 11;
                t.steps[b].mant = v & 0x7ff;
            }
        }
        r.pos += len - (t.qntsty == 0 ? nb : 2 * nb);
    } else {
        throw Corrupt("JPEG 2000 quantization style " +
                      std::to_string(t.qntsty));
    }
}

uint32_t read_compno(Reader& r, const Codestream& cs) {
    uint32_t c = cs.image.comps.size() <= 256 ? r.u8() : r.u16();
    if (c >= cs.image.comps.size())
        throw Corrupt("JPEG 2000 marker names a component beyond Csiz");
    return c;
}

void read_siz(Reader& r, Codestream& cs) {
    cs.rsiz = r.u16();
    uint32_t X1 = r.u32(), Y1 = r.u32(), X0 = r.u32(), Y0 = r.u32();
    cs.tdx = r.u32();
    cs.tdy = r.u32();
    cs.tx0 = (int)r.u32();
    cs.ty0 = (int)r.u32();
    uint32_t nc = r.u16();
    if (nc == 0 || nc > 16384) throw Corrupt("JPEG 2000 Csiz out of range");
    if (X0 >= X1 || Y0 >= Y1 || X1 > 0x7fffffffu || Y1 > 0x7fffffffu)
        throw Corrupt("JPEG 2000 image size out of range");
    if (cs.tdx == 0 || cs.tdy == 0 || (uint32_t)cs.tx0 > X0 ||
        (uint32_t)cs.ty0 > Y0 || cs.tx0 + (int64_t)cs.tdx <= X0 ||
        cs.ty0 + (int64_t)cs.tdy <= Y0)
        throw Corrupt("JPEG 2000 tile grid out of range");
    Image& im = cs.image;
    im.x0 = (int)X0; im.y0 = (int)Y0; im.x1 = (int)X1; im.y1 = (int)Y1;
    im.comps.resize(nc);
    for (uint32_t i = 0; i < nc; ++i) {
        Comp& c = im.comps[i];
        uint32_t s = r.u8();
        c.prec = (s & 0x7f) + 1;
        c.sgnd = s >> 7;
        c.dx = r.u8();
        c.dy = r.u8();
        if (c.dx == 0 || c.dy == 0)
            throw Corrupt("JPEG 2000 component sub-sampling of 0");
        if (c.prec > 31)
            throw Corrupt("JPEG 2000 component precision above 31 bits");
        c.x0 = ceildiv(X0, c.dx);
        c.y0 = ceildiv(Y0, c.dy);
        c.w = ceildiv(X1, c.dx) - c.x0;
        c.h = ceildiv(Y1, c.dy) - c.y0;
    }
    cs.tw = (uint32_t)ceildiv((int64_t)X1 - cs.tx0, cs.tdx);
    cs.th = (uint32_t)ceildiv((int64_t)Y1 - cs.ty0, cs.tdy);
    if ((uint64_t)cs.tw * cs.th > 65535)
        throw Corrupt("JPEG 2000 with more than 65535 tiles");
    cs.deflt.tccps.assign(nc, TCCP());
}

// COD / COC / QCD / QCC / RGN / POC into a TCP (the default one in the
// main header, a tile's in its tile-part headers)
void read_cod(Reader& r, TCP& tcp) {
    if (tcp.cod)
        throw Corrupt("JPEG 2000 with two COD markers in one header");
    tcp.cod = true;
    tcp.csty = r.u8();
    if (tcp.csty > 7) throw Corrupt("JPEG 2000 unknown Scod");
    tcp.prg = (int)r.u8();
    if (tcp.prg > 4) throw Corrupt("JPEG 2000 unknown progression order");
    tcp.numlayers = r.u16();
    if (tcp.numlayers == 0 || tcp.numlayers > 65535)
        throw Corrupt("JPEG 2000 number of layers out of range");
    tcp.mct = r.u8();
    if (tcp.mct > 1)
        throw Unsupported("JPEG 2000 Part 2 multiple component transform");
    TCCP& t0 = tcp.tccps[0];
    t0.csty = tcp.csty & 1;
    read_spcod(r, t0, tcp.csty & 1);
    for (size_t i = 1; i < tcp.tccps.size(); ++i) {
        TCCP& t = tcp.tccps[i];
        t.csty = t0.csty; t.numres = t0.numres; t.cblkw = t0.cblkw;
        t.cblkh = t0.cblkh; t.cblksty = t0.cblksty; t.qmfbid = t0.qmfbid;
        std::memcpy(t.prcw, t0.prcw, sizeof t.prcw);
        std::memcpy(t.prch, t0.prch, sizeof t.prch);
    }
}

void copy_quant(TCP& tcp) {
    const TCCP& t0 = tcp.tccps[0];
    for (size_t i = 1; i < tcp.tccps.size(); ++i) {
        TCCP& t = tcp.tccps[i];
        t.qntsty = t0.qntsty;
        t.numgbits = t0.numgbits;
        std::memcpy(t.steps, t0.steps, sizeof t.steps);
    }
}

void read_poc(Reader& r, TCP& tcp, size_t len, uint32_t nc) {
    size_t room = nc <= 256 ? 1 : 2, chunk = 5 + 2 * room;
    if (len == 0 || len % chunk) throw Corrupt("JPEG 2000 POC marker size");
    for (size_t k = 0; k < len / chunk; ++k) {
        Poc p;
        p.resno0 = r.u8();
        p.compno0 = room == 1 ? r.u8() : r.u16();
        p.layno1 = r.u16();
        p.resno1 = r.u8();
        p.compno1 = room == 1 ? r.u8() : r.u16();
        p.prg = (int)r.u8();
        p.compno1 = std::min(p.compno1, nc);
        tcp.pocs.push_back(p);
    }
    if (tcp.pocs.size() >= 32) throw Corrupt("JPEG 2000 with 32 POCs or more");
}

// One marker segment of the main header or of a tile-part header (into
// ``tcp``, the default or the tile's); unknown markers are skipped.
void read_marker(Reader& r, Codestream& cs, uint32_t marker, size_t len,
                 TCP& tcp, bool main_header) {
    size_t end = r.pos + len;
    uint32_t nc = (uint32_t)cs.image.comps.size();
    switch (marker) {
    case 0xFF52: read_cod(r, tcp); break;                         // COD
    case 0xFF53: {                                                // COC
        uint32_t c = read_compno(r, cs);
        TCCP& t = tcp.tccps[c];
        t.csty = r.u8() & 1;
        read_spcod(r, t, t.csty & 1);
        break;
    }
    case 0xFF5C:                                                  // QCD
        read_sqcd(r, tcp.tccps[0], len);
        copy_quant(tcp);
        break;
    case 0xFF5D: {                                                // QCC
        uint32_t c = read_compno(r, cs);
        read_sqcd(r, tcp.tccps[c], end - r.pos);
        break;
    }
    case 0xFF5E: {                                                // RGN
        uint32_t c = read_compno(r, cs);
        if (r.u8() != 0) throw Corrupt("JPEG 2000 unknown ROI style");
        tcp.tccps[c].roishift = (int)r.u8();
        break;
    }
    case 0xFF5F: read_poc(r, tcp, len, nc); break;                // POC
    case 0xFF60: {                                                // PPM
        if (!main_header) throw Corrupt("JPEG 2000 PPM in a tile header");
        uint32_t z = r.u8();
        if (cs.ppm_parts.size() <= z) cs.ppm_parts.resize(z + 1);
        cs.ppm_parts[z].assign(r.p + r.pos, r.p + end);
        cs.ppm = true;
        break;
    }
    case 0xFF61: {                                                // PPT
        if (main_header) throw Corrupt("JPEG 2000 PPT in the main header");
        uint32_t z = r.u8();
        if (tcp.ppt_parts.size() <= z) tcp.ppt_parts.resize(z + 1);
        tcp.ppt_parts[z].assign(r.p + r.pos, r.p + end);
        break;
    }
    case 0xFF55: case 0xFF57: case 0xFF58: case 0xFF64: case 0xFF63:
        break;                             // TLM, PLM, PLT, COM, CRG
    case 0xFF50: case 0xFF59:
        throw Unsupported("High-Throughput JPEG 2000 (HTJ2K, Part 15)");
    case 0xFF74: case 0xFF75: case 0xFF77: case 0xFF78: case 0xFF5A:
    case 0xFF5B:
        throw Unsupported("JPEG 2000 Part 2 markers (multiple component "
                          "transforms, arbitrary wavelets)");
    default:
        break;                             // unknown: skipped, as OpenJPEG
    }
    r.pos = end;
}

// ---------------------------------------------------------------- tiles

struct TagTree {
    struct Node { int parent, value, low; };
    std::vector<Node> nodes;
    void init(int w, int h) {
        nodes.clear();
        if (w <= 0 || h <= 0) return;
        std::vector<int> lw{w}, lh{h};
        while (lw.back() * lh.back() > 1) {
            lw.push_back((lw.back() + 1) / 2);
            lh.push_back((lh.back() + 1) / 2);
        }
        std::vector<int> start{0};
        for (size_t l = 0; l < lw.size(); ++l)
            start.push_back(start.back() + lw[l] * lh[l]);
        nodes.resize(start.back());
        for (size_t l = 0; l < lw.size(); ++l)
            for (int y = 0; y < lh[l]; ++y)
                for (int x = 0; x < lw[l]; ++x) {
                    int i = start[l] + y * lw[l] + x;
                    nodes[i].parent = l + 1 < lw.size()
                        ? start[l + 1] + (y / 2) * lw[l + 1] + x / 2 : -1;
                }
        reset();
    }
    void reset() {
        for (Node& n : nodes) { n.value = 999; n.low = 0; }
    }
};

// opj_bio: packet-header bits, a stuffed bit after each 0xFF
struct Bio {
    const uint8_t *start, *bp, *end;
    uint32_t buf = 0, ct = 0;
    Bio(const uint8_t* p, size_t n) : start(p), bp(p), end(p + n) {}
    void bytein() {
        buf = (buf << 8) & 0xffff;
        ct = buf == 0xff00 ? 7 : 8;
        if (bp < end) buf |= *bp++;
    }
    uint32_t bit() {
        if (ct == 0) bytein();
        --ct;
        return (buf >> ct) & 1;
    }
    uint32_t read(uint32_t n) {
        uint32_t v = 0;
        for (uint32_t i = n; i-- > 0;) v |= bit() << i;
        return v;
    }
    void inalign() {
        if ((buf & 0xff) == 0xff) bytein();
        ct = 0;
    }
    size_t numbytes() const { return (size_t)(bp - start); }
};

int tgt_decode(Bio& bio, TagTree& t, int leaf, int threshold) {
    int stk[32], sp = 0, node = leaf;
    while (t.nodes[node].parent >= 0) {
        stk[sp++] = node;
        node = t.nodes[node].parent;
    }
    int low = 0;
    for (;;) {
        TagTree::Node& n = t.nodes[node];
        if (low > n.low) n.low = low; else low = n.low;
        while (low < threshold && low < n.value) {
            if (bio.read(1)) n.value = low; else ++low;
        }
        n.low = low;
        if (sp == 0) break;
        node = stk[--sp];
    }
    return t.nodes[node].value < threshold ? 1 : 0;
}

struct Seg {
    uint32_t len = 0, numpasses = 0, maxpasses = 0, newlen = 0,
             numnewpasses = 0;
};

struct Cblk {
    int x0, y0, x1, y1;
    uint32_t numbps = 0, numlenbits = 0, numnewpasses = 0, numsegs = 0;
    std::vector<Seg> segs;
    std::vector<uint8_t> data;
};

struct Precinct {
    int x0, y0, x1, y1;
    int cw = 0, ch = 0;
    std::vector<Cblk> cblks;
    TagTree incl, imsb;
};

struct Band {
    int bandno = 0, x0 = 0, y0 = 0, x1 = 0, y1 = 0, numbps = 0;
    float stepsize = 0.f;
    std::vector<Precinct> precs;
    bool empty() const { return x0 == x1 || y0 == y1; }
};

struct Res {
    int x0, y0, x1, y1;
    uint32_t pw = 0, ph = 0, pdx = 0, pdy = 0;
    int numbands = 0;
    Band bands[3];
};

struct TileComp {
    int x0, y0, x1, y1;
    uint32_t numres;
    std::vector<Res> res;
    std::vector<int32_t> idata;
    std::vector<float> fdata;
};

struct Tile {
    int x0, y0, x1, y1;
    std::vector<TileComp> comps;
};

void init_tile(const Codestream& cs, const TCP& tcp, uint32_t tileno,
               Tile& tile) {
    uint32_t p = tileno % cs.tw, q = tileno / cs.tw;
    tile.x0 = std::max<int64_t>(cs.tx0 + (int64_t)p * cs.tdx, cs.image.x0);
    tile.y0 = std::max<int64_t>(cs.ty0 + (int64_t)q * cs.tdy, cs.image.y0);
    tile.x1 = std::min<int64_t>(cs.tx0 + (int64_t)(p + 1) * cs.tdx,
                                cs.image.x1);
    tile.y1 = std::min<int64_t>(cs.ty0 + (int64_t)(q + 1) * cs.tdy,
                                cs.image.y1);
    tile.comps.resize(cs.image.comps.size());
    for (size_t c = 0; c < tile.comps.size(); ++c) {
        const Comp& ic = cs.image.comps[c];
        const TCCP& tccp = tcp.tccps[c];
        TileComp& tc = tile.comps[c];
        tc.x0 = ceildiv(tile.x0, ic.dx);
        tc.y0 = ceildiv(tile.y0, ic.dy);
        tc.x1 = ceildiv(tile.x1, ic.dx);
        tc.y1 = ceildiv(tile.y1, ic.dy);
        tc.numres = tccp.numres;
        tc.res.assign(tc.numres, Res());
        size_t n = (size_t)(tc.x1 - tc.x0) * (tc.y1 - tc.y0);
        if (tccp.qmfbid == 1) tc.idata.assign(n, 0);
        else tc.fdata.assign(n, 0.f);
        int step = 0;
        for (uint32_t r = 0; r < tc.numres; ++r) {
            int level = (int)(tc.numres - 1 - r);
            Res& res = tc.res[r];
            res.x0 = ceildivpow2(tc.x0, level);
            res.y0 = ceildivpow2(tc.y0, level);
            res.x1 = ceildivpow2(tc.x1, level);
            res.y1 = ceildivpow2(tc.y1, level);
            uint32_t pdx = tccp.prcw[r], pdy = tccp.prch[r];
            res.pdx = pdx;
            res.pdy = pdy;
            int px0 = floordivpow2(res.x0, pdx) << pdx;
            int py0 = floordivpow2(res.y0, pdy) << pdy;
            int px1 = ceildivpow2(res.x1, pdx) << pdx;
            int py1 = ceildivpow2(res.y1, pdy) << pdy;
            res.pw = res.x0 == res.x1 ? 0 : (uint32_t)((px1 - px0) >> pdx);
            res.ph = res.y0 == res.y1 ? 0 : (uint32_t)((py1 - py0) >> pdy);
            if ((uint64_t)res.pw * res.ph > (1u << 24))
                throw Corrupt("JPEG 2000 with too many precincts");
            int cbgx0, cbgy0;
            uint32_t cbgw, cbgh;
            if (r == 0) {
                cbgx0 = px0; cbgy0 = py0; cbgw = pdx; cbgh = pdy;
                res.numbands = 1;
            } else {
                cbgx0 = ceildivpow2(px0, 1); cbgy0 = ceildivpow2(py0, 1);
                cbgw = pdx - 1; cbgh = pdy - 1;
                res.numbands = 3;
            }
            uint32_t cbw = std::min(tccp.cblkw, cbgw);
            uint32_t cbh = std::min(tccp.cblkh, cbgh);
            for (int b = 0; b < res.numbands; ++b, ++step) {
                Band& band = res.bands[b];
                if (r == 0) {
                    band.bandno = 0;
                    band.x0 = ceildivpow2(tc.x0, level);
                    band.y0 = ceildivpow2(tc.y0, level);
                    band.x1 = ceildivpow2(tc.x1, level);
                    band.y1 = ceildivpow2(tc.y1, level);
                } else {
                    band.bandno = b + 1;
                    int64_t xb = band.bandno & 1, yb = band.bandno >> 1;
                    band.x0 = ceildivpow2(tc.x0 - (xb << level), level + 1);
                    band.y0 = ceildivpow2(tc.y0 - (yb << level), level + 1);
                    band.x1 = ceildivpow2(tc.x1 - (xb << level), level + 1);
                    band.y1 = ceildivpow2(tc.y1 - (yb << level), level + 1);
                }
                const StepSize& ss = tccp.steps[step];
                // Table E-1's gains are 0 in the irreversible decoder: its
                // 9/7 scales the high bands by 2 / K (OpenJPEG's
                // "BUG_WEIRD_TWO_INVK"), and the step sizes compensate
                int log2_gain = tccp.qmfbid == 0 ? 0
                    : band.bandno == 0 ? 0 : band.bandno == 3 ? 2 : 1;
                int Rb = (int)cs.image.comps[c].prec + log2_gain;
                band.stepsize = (float)((1.0 + ss.mant / 2048.0) *
                                        std::pow(2.0, Rb - ss.expn));
                band.numbps = ss.expn + (int)tccp.numgbits - 1;
                band.precs.assign((size_t)res.pw * res.ph, Precinct());
                for (uint32_t pno = 0; pno < res.pw * res.ph; ++pno) {
                    Precinct& pr = band.precs[pno];
                    int gx0 = cbgx0 + (int)(pno % res.pw) * (1 << cbgw);
                    int gy0 = cbgy0 + (int)(pno / res.pw) * (1 << cbgh);
                    pr.x0 = std::max(gx0, band.x0);
                    pr.y0 = std::max(gy0, band.y0);
                    pr.x1 = std::min(gx0 + (1 << cbgw), band.x1);
                    pr.y1 = std::min(gy0 + (1 << cbgh), band.y1);
                    int bx0 = floordivpow2(pr.x0, cbw) << cbw;
                    int by0 = floordivpow2(pr.y0, cbh) << cbh;
                    int bx1 = ceildivpow2(pr.x1, cbw) << cbw;
                    int by1 = ceildivpow2(pr.y1, cbh) << cbh;
                    pr.cw = std::max(0, (bx1 - bx0) >> cbw);
                    pr.ch = std::max(0, (by1 - by0) >> cbh);
                    pr.cblks.resize((size_t)pr.cw * pr.ch);
                    for (int k = 0; k < pr.cw * pr.ch; ++k) {
                        Cblk& cb = pr.cblks[k];
                        int cx = bx0 + (k % pr.cw) * (1 << cbw);
                        int cy = by0 + (k / pr.cw) * (1 << cbh);
                        cb.x0 = std::max(cx, pr.x0);
                        cb.y0 = std::max(cy, pr.y0);
                        cb.x1 = std::min(cx + (1 << cbw), pr.x1);
                        cb.y1 = std::min(cy + (1 << cbh), pr.y1);
                    }
                    pr.incl.init(pr.cw, pr.ch);
                    pr.imsb.init(pr.cw, pr.ch);
                }
            }
        }
    }
}

// ---------------------------------------------------------------- tier 2

struct Packet { uint32_t layno, resno, compno, precno; };

// OpenJPEG's packet iterator (pi.c, the decoder's), one pass per POC (or
// one with the COD's order), packets already given by an earlier pass
// skipped
std::vector<Packet> packet_order(const Codestream& cs, const TCP& tcp,
                                 const Tile& tile) {
    uint32_t nc = (uint32_t)tile.comps.size(), max_res = 0, max_prec = 0;
    for (uint32_t c = 0; c < nc; ++c) {
        const TileComp& tc = tile.comps[c];
        max_res = std::max(max_res, tc.numres);
        for (const Res& r : tc.res)
            max_prec = std::max(max_prec, r.pw * r.ph);
    }
    uint64_t step_p = 1, step_c = max_prec, step_r = (uint64_t)nc * step_c,
             step_l = (uint64_t)max_res * step_r;
    std::vector<uint8_t> include((tcp.numlayers + 1) * step_l, 0);
    std::vector<Packet> out;
    std::vector<Poc> pocs = tcp.pocs;
    bool use_poc = !pocs.empty();
    if (!use_poc) {
        Poc p;
        p.resno0 = 0; p.compno0 = 0; p.resno1 = max_res; p.compno1 = nc;
        p.layno1 = tcp.numlayers; p.prg = tcp.prg;
        pocs.push_back(p);
    }
    auto emit = [&](uint32_t l, uint32_t r, uint32_t c, uint32_t p) {
        uint64_t idx = l * step_l + r * step_r + c * step_c + p * step_p;
        if (idx >= include.size())
            throw Corrupt("JPEG 2000 packet outside its precincts");
        if (!include[idx]) {
            include[idx] = 1;
            out.push_back({l, r, c, p});
        }
    };
    for (const Poc& poc0 : pocs) {
        uint32_t layno0 = 0, layno1 = use_poc
            ? std::min(poc0.layno1, tcp.numlayers) : poc0.layno1;
        uint32_t resno0 = poc0.resno0, resno1 = poc0.resno1;
        uint32_t compno0 = poc0.compno0, compno1 = poc0.compno1;
        if (poc0.prg > 4) throw Corrupt("JPEG 2000 unknown POC order");
        if (compno0 >= nc || compno1 >= nc + 1)
            throw Corrupt("JPEG 2000 invalid POC components");
        int prg = poc0.prg;
        auto precincts = [&](uint32_t l, uint32_t r) {
            for (uint32_t c = compno0; c < compno1; ++c) {
                const TileComp& tc = tile.comps[c];
                if (r >= tc.numres) continue;
                const Res& res = tc.res[r];
                for (uint32_t p = 0; p < res.pw * res.ph; ++p) emit(l, r, c, p);
            }
        };
        if (prg == 0) {                                      // LRCP
            for (uint32_t l = layno0; l < layno1; ++l)
                for (uint32_t r = resno0; r < resno1; ++r) precincts(l, r);
            continue;
        }
        if (prg == 1) {                                      // RLCP
            for (uint32_t r = resno0; r < resno1; ++r)
                for (uint32_t l = layno0; l < layno1; ++l) precincts(l, r);
            continue;
        }
        // position-driven orders: RPCL (2), PCRL (3), CPRL (4)
        auto steps = [&](uint32_t c0, uint32_t c1, uint32_t& dx,
                         uint32_t& dy) {
            dx = dy = 0;
            for (uint32_t c = c0; c < c1; ++c) {
                const TileComp& tc = tile.comps[c];
                const Comp& ic = cs.image.comps[c];
                for (uint32_t r = 0; r < tc.numres; ++r) {
                    const Res& res = tc.res[r];
                    uint32_t lv = tc.numres - 1 - r;
                    if (res.pdx + lv < 32 &&
                        ic.dx <= UINT32_MAX / (1u << (res.pdx + lv))) {
                        uint32_t v = ic.dx * (1u << (res.pdx + lv));
                        dx = !dx ? v : std::min(dx, v);
                    }
                    if (res.pdy + lv < 32 &&
                        ic.dy <= UINT32_MAX / (1u << (res.pdy + lv))) {
                        uint32_t v = ic.dy * (1u << (res.pdy + lv));
                        dy = !dy ? v : std::min(dy, v);
                    }
                }
            }
        };
        // the packet of (c, r) at position (x, y), if one starts there
        auto at = [&](uint32_t c, uint32_t r, uint32_t x, uint32_t y,
                      uint32_t& precno) -> bool {
            const TileComp& tc = tile.comps[c];
            const Comp& ic = cs.image.comps[c];
            if (r >= tc.numres) return false;
            const Res& res = tc.res[r];
            uint32_t lv = tc.numres - 1 - r;
            if (lv >= 32 || ((ic.dx << lv) >> lv) != ic.dx ||
                ((ic.dy << lv) >> lv) != ic.dy)
                return false;
            if ((uint64_t)(ic.dx << lv) > INT32_MAX ||
                (uint64_t)(ic.dy << lv) > INT32_MAX)
                return false;
            int trx0 = ceildiv(tile.x0, (int64_t)(ic.dx << lv));
            int try0 = ceildiv(tile.y0, (int64_t)(ic.dy << lv));
            int trx1 = ceildiv(tile.x1, (int64_t)(ic.dx << lv));
            int try1 = ceildiv(tile.y1, (int64_t)(ic.dy << lv));
            uint32_t rpx = res.pdx + lv, rpy = res.pdy + lv;
            if (rpx >= 31 || ((ic.dx << rpx) >> rpx) != ic.dx ||
                rpy >= 31 || ((ic.dy << rpy) >> rpy) != ic.dy)
                return false;
            if (!((uint64_t)y % ((uint64_t)ic.dy << rpy) == 0 ||
                  (y == (uint32_t)tile.y0 &&
                   (((uint64_t)try0 << lv) % ((uint64_t)1 << rpy)))))
                return false;
            if (!((uint64_t)x % ((uint64_t)ic.dx << rpx) == 0 ||
                  (x == (uint32_t)tile.x0 &&
                   (((uint64_t)trx0 << lv) % ((uint64_t)1 << rpx)))))
                return false;
            if (res.pw == 0 || res.ph == 0) return false;
            if (trx0 == trx1 || try0 == try1) return false;
            int prci = floordivpow2(ceildiv(x, (int64_t)(ic.dx << lv)),
                                    res.pdx) - floordivpow2(trx0, res.pdx);
            int prcj = floordivpow2(ceildiv(y, (int64_t)(ic.dy << lv)),
                                    res.pdy) - floordivpow2(try0, res.pdy);
            precno = (uint32_t)(prci + prcj * (int)res.pw);
            return true;
        };
        uint32_t dx, dy, precno;
        auto ys = [&](uint32_t dy_, auto&& body) {
            for (uint32_t y = tile.y0; y < (uint32_t)tile.y1;
                 y += dy_ - (y % dy_))
                body(y);
        };
        auto xs = [&](uint32_t dx_, auto&& body) {
            for (uint32_t x = tile.x0; x < (uint32_t)tile.x1;
                 x += dx_ - (x % dx_))
                body(x);
        };
        if (prg == 2) {                                      // RPCL
            steps(0, nc, dx, dy);
            if (!dx || !dy) continue;
            for (uint32_t r = resno0; r < resno1; ++r)
                ys(dy, [&](uint32_t y) { xs(dx, [&](uint32_t x) {
                    for (uint32_t c = compno0; c < compno1; ++c)
                        if (at(c, r, x, y, precno))
                            for (uint32_t l = layno0; l < layno1; ++l)
                                emit(l, r, c, precno);
                }); });
        } else if (prg == 3) {                               // PCRL
            steps(0, nc, dx, dy);
            if (!dx || !dy) continue;
            ys(dy, [&](uint32_t y) { xs(dx, [&](uint32_t x) {
                for (uint32_t c = compno0; c < compno1; ++c) {
                    uint32_t rmax = std::min(resno1, tile.comps[c].numres);
                    for (uint32_t r = resno0; r < rmax; ++r)
                        if (at(c, r, x, y, precno))
                            for (uint32_t l = layno0; l < layno1; ++l)
                                emit(l, r, c, precno);
                }
            }); });
        } else {                                             // CPRL
            for (uint32_t c = compno0; c < compno1; ++c) {
                steps(c, c + 1, dx, dy);
                if (!dx || !dy) break;
                uint32_t rmax = std::min(resno1, tile.comps[c].numres);
                ys(dy, [&](uint32_t y) { xs(dx, [&](uint32_t x) {
                    for (uint32_t r = resno0; r < rmax; ++r)
                        if (at(c, r, x, y, precno))
                            for (uint32_t l = layno0; l < layno1; ++l)
                                emit(l, r, c, precno);
                }); });
            }
        }
    }
    return out;
}

void init_seg(Cblk& cb, uint32_t index, uint32_t cblksty, bool first) {
    if (cb.segs.size() < index + 1) cb.segs.resize(index + 1);
    Seg& s = cb.segs[index];
    s = Seg();
    if (cblksty & CBLK_TERMALL) {
        s.maxpasses = 1;
    } else if (cblksty & CBLK_LAZY) {
        if (first) {
            s.maxpasses = 10;
        } else {
            uint32_t prev = cb.segs[index - 1].maxpasses;
            s.maxpasses = (prev == 1 || prev == 10) ? 2 : 1;
        }
    } else {
        s.maxpasses = 109;
    }
}

uint32_t getnumpasses(Bio& b) {
    if (!b.read(1)) return 1;
    if (!b.read(1)) return 2;
    uint32_t n = b.read(2);
    if (n != 3) return 3 + n;
    n = b.read(5);
    if (n != 31) return 6 + n;
    return 37 + b.read(7);
}

uint32_t floorlog2(uint32_t a) {
    uint32_t l = 0;
    while (a > 1) { a >>= 1; ++l; }
    return l;
}

struct HeaderSource {          // where packet headers are read from
    const uint8_t* p;
    size_t len, pos = 0;
};

// Reads one packet (opj_t2_read_packet_header + opj_t2_read_packet_data);
// advances ``pos`` in the tile's data and the header source
void read_packet(const TCP& tcp, Tile& tile, const Packet& pk,
                 const uint8_t* data, size_t max_len, size_t& pos,
                 HeaderSource* hs) {
    TileComp& tc = tile.comps[pk.compno];
    Res& res = tc.res[pk.resno];
    uint32_t cblksty = tcp.tccps[pk.compno].cblksty;
    if (pk.layno == 0) {
        for (int b = 0; b < res.numbands; ++b) {
            Band& band = res.bands[b];
            if (band.empty()) continue;
            if (pk.precno >= band.precs.size())
                throw Corrupt("JPEG 2000 invalid precinct");
            Precinct& pr = band.precs[pk.precno];
            pr.incl.reset();
            pr.imsb.reset();
            for (Cblk& cb : pr.cblks) cb.numsegs = 0;
        }
    }
    size_t cur = pos;
    if (tcp.csty & 2) {                                      // SOP
        if (max_len - cur >= 6 && data[cur] == 0xff && data[cur + 1] == 0x91)
            cur += 6;
    }
    const uint8_t* hp;
    size_t hlen;
    if (hs) { hp = hs->p + hs->pos; hlen = hs->len - hs->pos; }
    else { hp = data + cur; hlen = max_len - cur; }
    Bio bio(hp, hlen);
    bool present = bio.read(1);
    if (present) {
        for (int b = 0; b < res.numbands; ++b) {
            Band& band = res.bands[b];
            if (band.empty()) continue;
            Precinct& pr = band.precs[pk.precno];
            for (int k = 0; k < pr.cw * pr.ch; ++k) {
                Cblk& cb = pr.cblks[k];
                uint32_t included = !cb.numsegs
                    ? tgt_decode(bio, pr.incl, k, (int)pk.layno + 1)
                    : bio.read(1);
                if (!included) { cb.numnewpasses = 0; continue; }
                if (!cb.numsegs) {
                    int i = 0;
                    while (!tgt_decode(bio, pr.imsb, k, i)) {
                        ++i;
                        if (i > 64) throw Corrupt("JPEG 2000 corrupt zero "
                                                  "bit-plane tag tree");
                    }
                    cb.numbps = (uint32_t)(band.numbps + 1 - i);
                    cb.numlenbits = 3;
                }
                cb.numnewpasses = getnumpasses(bio);
                uint32_t inc = 0;
                while (bio.read(1)) ++inc;
                cb.numlenbits += inc;
                uint32_t segno = 0;
                if (!cb.numsegs) {
                    init_seg(cb, 0, cblksty, true);
                } else {
                    segno = cb.numsegs - 1;
                    if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
                        ++segno;
                        init_seg(cb, segno, cblksty, false);
                    }
                }
                int n = (int)cb.numnewpasses;
                do {
                    Seg& s = cb.segs[segno];
                    s.numnewpasses = (uint32_t)std::min<int>(
                        (int)(s.maxpasses - s.numpasses), n);
                    uint32_t bits = cb.numlenbits + floorlog2(s.numnewpasses);
                    if (bits > 32)
                        throw Corrupt("JPEG 2000 invalid length indicator");
                    s.newlen = bio.read(bits);
                    n -= (int)s.numnewpasses;
                    if (n > 0) {
                        ++segno;
                        init_seg(cb, segno, cblksty, false);
                    }
                } while (n > 0);
            }
        }
    }
    bio.inalign();
    size_t hbytes = bio.numbytes();
    if (tcp.csty & 4) {                 // EPH: required, as OpenJPEG 2.5
        if (hlen - hbytes < 2 || hp[hbytes] != 0xff || hp[hbytes + 1] != 0x92)
            throw Unsupported("JPEG 2000 packet header without the EPH "
                              "marker its COD announces (cv2's OpenJPEG "
                              "fails, \"Expected EPH marker\")");
        hbytes += 2;
    }
    if (hs) hs->pos += hbytes; else cur += hbytes;
    if (present) {
        for (int b = 0; b < res.numbands; ++b) {
            Band& band = res.bands[b];
            if (band.empty()) continue;
            Precinct& pr = band.precs[pk.precno];
            for (int k = 0; k < pr.cw * pr.ch; ++k) {
                Cblk& cb = pr.cblks[k];
                if (!cb.numnewpasses) continue;
                uint32_t si;
                if (!cb.numsegs) {
                    si = 0;
                    cb.numsegs = 1;
                } else {
                    si = cb.numsegs - 1;
                    if (cb.segs[si].numpasses == cb.segs[si].maxpasses) {
                        ++si;
                        ++cb.numsegs;
                    }
                }
                do {
                    Seg& s = cb.segs[si];
                    if (s.newlen > max_len - cur)
                        throw Unsupported(
                            "JPEG 2000 code-block data past the end of its "
                            "tile (a cut stream: cv2's OpenJPEG fails, "
                            "\"segment too long\")");
                    cb.data.insert(cb.data.end(), data + cur,
                                   data + cur + s.newlen);
                    cur += s.newlen;
                    s.len += s.newlen;
                    s.numpasses += s.numnewpasses;
                    cb.numnewpasses -= s.numnewpasses;
                    if (cb.numnewpasses > 0) {
                        ++si;
                        ++cb.numsegs;
                    }
                } while (cb.numnewpasses > 0);
            }
        }
    }
    pos = cur;
}

// ---------------------------------------------------------------- tier 1

struct MqState { uint16_t qe; uint8_t nmps, nlps, sw; };
const MqState MQ[47] = {
    {0x5601, 1, 1, 1}, {0x3401, 2, 6, 0}, {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0}, {0x0521, 5, 29, 0}, {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1}, {0x5401, 8, 14, 0}, {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

// contexts: 0-8 zero coding, 9-13 sign, 14-16 refinement, 17 run
// length, 18 uniform
const int CTX_ZC = 0, CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18;

struct Mq {
    const uint8_t* bp;
    uint32_t a = 0, c = 0, ct = 0;
    uint8_t state[19], mps[19];
    void reset_states() {
        for (int i = 0; i < 19; ++i) { state[i] = 0; mps[i] = 0; }
        state[CTX_UNI] = 46;
        state[CTX_AGG] = 3;
        state[CTX_ZC] = 4;
    }
    // the segment's bytes are followed by 0xFF 0xFF in the buffer
    void bytein() {
        if (bp[0] == 0xff) {
            if (bp[1] > 0x8f) {
                c += 0xff00;
                ct = 8;
            } else {
                ++bp;
                c += (uint32_t)bp[0] << 9;
                ct = 7;
            }
        } else {
            ++bp;
            c += (uint32_t)bp[0] << 8;
            ct = 8;
        }
    }
    void init(const uint8_t* p, size_t len) {
        bp = p;
        c = len == 0 ? 0xffu << 16 : (uint32_t)p[0] << 16;
        bytein();
        c <<= 7;
        ct -= 7;
        a = 0x8000;
    }
    void renorm() {
        do {
            if (ct == 0) bytein();
            a <<= 1;
            c <<= 1;
            --ct;
        } while (a < 0x8000);
    }
    uint32_t decode(int cx) {
        const MqState& s = MQ[state[cx]];
        uint32_t d;
        a -= s.qe;
        if ((c >> 16) < s.qe) {
            if (a < s.qe) {
                a = s.qe;
                d = mps[cx];
                state[cx] = s.nmps;
            } else {
                a = s.qe;
                d = !mps[cx];
                if (s.sw) mps[cx] = !mps[cx];
                state[cx] = s.nlps;
            }
            renorm();
        } else {
            c -= (uint32_t)s.qe << 16;
            if ((a & 0x8000) == 0) {
                if (a < s.qe) {
                    d = !mps[cx];
                    if (s.sw) mps[cx] = !mps[cx];
                    state[cx] = s.nlps;
                } else {
                    d = mps[cx];
                    state[cx] = s.nmps;
                }
                renorm();
            } else {
                d = mps[cx];
            }
        }
        return d;
    }
    // bypass (raw) segments
    void raw_init(const uint8_t* p) { bp = p; c = 0; ct = 0; }
    uint32_t raw_decode() {
        if (ct == 0) {
            if (c == 0xff) {
                if (*bp > 0x8f) {
                    c = 0xff;
                    ct = 8;
                } else {
                    c = *bp++;
                    ct = 7;
                }
            } else {
                c = *bp++;
                ct = 8;
            }
        }
        --ct;
        return (c >> ct) & 1;
    }
};

// per coefficient flags
const uint8_t F_SIG = 1, F_NEG = 2, F_VISIT = 4, F_REFINED = 8;

struct T1 {
    int w = 0, h = 0, stride = 0;
    std::vector<uint8_t> flags;      // (h + 2) x (w + 2), a border of 0
    std::vector<int32_t> data;       // h x w
    bool vsc = false;
    int orient = 0;
    Mq mq;

    uint8_t& f(int x, int y) { return flags[(y + 1) * stride + x + 1]; }
    // significance of a neighbour; with vertically causal contexts the
    // row below a stripe's last row reads as insignificant
    int sig(int x, int y, int ny) {
        if (vsc && (y & 3) == 3 && ny == y + 1) return 0;
        return f(x, ny) & F_SIG;
    }
    int neighbours(int x, int y) {
        return sig(x - 1, y, y) | sig(x + 1, y, y) |
               sig(x - 1, y, y - 1) | sig(x, y, y - 1) | sig(x + 1, y, y - 1) |
               sig(x - 1, y, y + 1) | sig(x, y, y + 1) | sig(x + 1, y, y + 1);
    }
    int zc_ctx(int x, int y) {
        int hh = sig(x - 1, y, y) + sig(x + 1, y, y);
        int vv = sig(x, y, y - 1) + sig(x, y, y + 1);
        int dd = sig(x - 1, y, y - 1) + sig(x + 1, y, y - 1) +
                 sig(x - 1, y, y + 1) + sig(x + 1, y, y + 1);
        int n;
        if (orient == 3) {
            int hv = hh + vv;
            if (!dd) n = !hv ? 0 : hv == 1 ? 1 : 2;
            else if (dd == 1) n = !hv ? 3 : hv == 1 ? 4 : 5;
            else if (dd == 2) n = !hv ? 6 : 7;
            else n = 8;
        } else {
            if (orient == 1) std::swap(hh, vv);     // HL: transposed
            if (!hh) n = !vv ? (!dd ? 0 : dd == 1 ? 1 : 2) : vv == 1 ? 3 : 4;
            else if (hh == 1) n = !vv ? (!dd ? 5 : 6) : 7;
            else n = 8;
        }
        return CTX_ZC + n;
    }
    int contrib(int x, int y, int ny) {
        if (!sig(x, y, ny)) return 0;
        return (f(x, ny) & F_NEG) ? -1 : 1;
    }
    // the sign's context and the bit it is XORed with (Table D.3)
    int sc_ctx(int x, int y, int& xorbit) {
        int hc = contrib(x - 1, y, y) + contrib(x + 1, y, y);
        int vc = contrib(x, y, y - 1) + contrib(x, y, y + 1);
        hc = std::max(-1, std::min(1, hc));
        vc = std::max(-1, std::min(1, vc));
        xorbit = 0;
        if (hc < 0 || (hc == 0 && vc < 0)) {
            xorbit = 1;
            hc = -hc;
            vc = -vc;
        }
        int n = hc == 0 ? (vc == 0 ? 0 : 1) : (vc == 1 ? 4 : vc == 0 ? 3 : 2);
        return CTX_SC + n;
    }
    void set_sig(int x, int y, uint32_t neg, int32_t v) {
        f(x, y) |= F_SIG | (neg ? F_NEG : 0);
        data[y * w + x] = neg ? -v : v;
    }

    void sigpass(int bpno, bool raw) {
        int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
        for (int k = 0; k < h; k += 4)
            for (int x = 0; x < w; ++x)
                for (int y = k; y < std::min(k + 4, h); ++y) {
                    uint8_t& fl = f(x, y);
                    if ((fl & (F_SIG | F_VISIT)) || !neighbours(x, y))
                        continue;
                    if (raw) {
                        if (mq.raw_decode())
                            set_sig(x, y, mq.raw_decode(), oneplushalf);
                    } else if (mq.decode(zc_ctx(x, y))) {
                        int xb;
                        int cx = sc_ctx(x, y, xb);
                        set_sig(x, y, mq.decode(cx) ^ xb, oneplushalf);
                    }
                    fl |= F_VISIT;
                }
    }
    void refpass(int bpno, bool raw) {
        int32_t poshalf = (1 << bpno) >> 1;
        for (int k = 0; k < h; k += 4)
            for (int x = 0; x < w; ++x)
                for (int y = k; y < std::min(k + 4, h); ++y) {
                    uint8_t& fl = f(x, y);
                    if ((fl & (F_SIG | F_VISIT)) != F_SIG) continue;
                    uint32_t v;
                    if (raw) {
                        v = mq.raw_decode();
                    } else {
                        int cx = (fl & F_REFINED) ? CTX_MAG + 2
                                 : neighbours(x, y) ? CTX_MAG + 1 : CTX_MAG;
                        v = mq.decode(cx);
                    }
                    int32_t& d = data[y * w + x];
                    d += (v ^ (uint32_t)(d < 0)) ? poshalf : -poshalf;
                    fl |= F_REFINED;
                }
    }
    void clean_one(int x, int y, int32_t oneplushalf, bool partial) {
        if (!partial && !mq.decode(zc_ctx(x, y))) return;
        int xb;
        int cx = sc_ctx(x, y, xb);
        set_sig(x, y, mq.decode(cx) ^ xb, oneplushalf);
    }
    void clnpass(int bpno, bool segsym) {
        int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
        for (int k = 0; k < h; k += 4)
            for (int x = 0; x < w; ++x) {
                int y1 = std::min(k + 4, h);
                bool run = y1 - k == 4;
                for (int y = k; run && y < y1; ++y)
                    run = !(f(x, y) & (F_SIG | F_VISIT)) && !neighbours(x, y);
                int y = k;
                if (run) {
                    if (!mq.decode(CTX_AGG)) {
                        y = y1;
                    } else {
                        uint32_t r = mq.decode(CTX_UNI);
                        r = (r << 1) | mq.decode(CTX_UNI);
                        y = k + (int)r;
                        clean_one(x, y, oneplushalf, true);
                        ++y;
                    }
                }
                for (; y < y1; ++y)
                    if (!(f(x, y) & (F_SIG | F_VISIT)))
                        clean_one(x, y, oneplushalf, false);
                for (int yy = k; yy < y1; ++yy) f(x, yy) &= ~F_VISIT;
            }
        if (segsym)
            for (int i = 0; i < 4; ++i) mq.decode(CTX_UNI);
    }

    // opj_t1_decode_cblk: the coefficients, scaled by 2 (a half step
    // below the last decoded bit plane, as OpenJPEG reconstructs)
    void decode(Cblk& cb, int orient_, int roishift, uint32_t cblksty) {
        w = cb.x1 - cb.x0;
        h = cb.y1 - cb.y0;
        stride = w + 2;
        flags.assign((size_t)(w + 2) * (h + 2), 0);
        data.assign((size_t)w * h, 0);
        orient = orient_;
        vsc = cblksty & CBLK_VSC;
        mq.reset_states();
        int bpno_plus_one = roishift + (int)cb.numbps;
        if (bpno_plus_one >= 31)
            throw Unsupported("JPEG 2000 code-block of 31 bit planes or "
                              "more (cv2's OpenJPEG fails on it)");
        int passtype = 2;
        std::vector<uint8_t> seg;
        size_t at = 0;
        for (uint32_t si = 0; si < cb.numsegs; ++si) {
            const Seg& s = cb.segs[si];
            bool raw = bpno_plus_one <= (int)cb.numbps - 4 && passtype < 2 &&
                       (cblksty & CBLK_LAZY);
            seg.assign(cb.data.begin() + at, cb.data.begin() + at + s.len);
            seg.push_back(0xff);
            seg.push_back(0xff);
            at += s.len;
            if (raw) mq.raw_init(seg.data());
            else mq.init(seg.data(), s.len);
            for (uint32_t pn = 0; pn < s.numpasses && bpno_plus_one >= 1;
                 ++pn) {
                if (passtype == 0) sigpass(bpno_plus_one, raw);
                else if (passtype == 1) refpass(bpno_plus_one, raw);
                else clnpass(bpno_plus_one, cblksty & CBLK_SEGSYM);
                if ((cblksty & CBLK_RESET) && !raw) mq.reset_states();
                if (++passtype == 3) {
                    passtype = 0;
                    --bpno_plus_one;
                }
            }
        }
        if (roishift) {
            int32_t thresh = 1 << roishift;
            for (int32_t& v : data) {
                int32_t mag = v < 0 ? -v : v;
                if (mag >= thresh) {
                    mag >>= roishift;
                    v = v < 0 ? -mag : mag;
                }
            }
        }
    }
};

// ---------------------------------------------------------------- DWT

// inverse 5/3 of one line (OpenJPEG's opj_idwt53_h / _v): cas 1 when the
// first sample has an odd coordinate (a high-pass one)
void idwt53(int32_t* a, size_t stride, int sn, int dn, int cas,
            std::vector<int32_t>& tmp) {
    int len = sn + dn;
    if (len == 1) {
        if (cas) a[0] /= 2;
        return;
    }
    // deinterleaved input: low band first (sn samples), then high
    tmp.resize(len);
    for (int i = 0; i < len; ++i) tmp[i] = a[i * stride];
    std::vector<int32_t> x(len);
    int lo = cas ? 1 : 0;        // position of low sample 0
    for (int i = 0; i < sn; ++i) x[lo + 2 * i] = tmp[i];
    for (int i = 0; i < dn; ++i) x[1 - lo + 2 * i] = tmp[sn + i];
    auto at = [&](int p) {
        if (p < 0) p = -p;
        if (p >= len) p = 2 * (len - 1) - p;
        return x[p];
    };
    for (int p = lo; p < len; p += 2)
        x[p] = x[p] - ((at(p - 1) + at(p + 1) + 2) >> 2);
    for (int p = 1 - lo; p < len; p += 2)
        x[p] = (int32_t)((uint32_t)x[p] + (uint32_t)((at(p - 1) + at(p + 1)) >> 1));
    for (int i = 0; i < len; ++i) a[i * stride] = x[i];
}

const float DWT_ALPHA = -1.586134342f, DWT_BETA = -0.052980118f,
            DWT_GAMMA = 0.882911075f, DWT_DELTA = 0.443506852f,
            DWT_K = 1.230174105f, DWT_TWO_INVK = 1.625732422f;

// inverse 9/7 of one line, opj_v8dwt_decode's operations in its order
void idwt97(float* a, size_t stride, int sn, int dn, int cas,
            std::vector<float>& x) {
    int len = sn + dn;
    x.resize(len);
    int lo = cas ? 1 : 0;
    for (int i = 0; i < sn; ++i) x[lo + 2 * i] = a[i * stride];
    for (int i = 0; i < dn; ++i) x[1 - lo + 2 * i] = a[(sn + i) * stride];
    bool act = cas == 0 ? (dn > 0 || sn > 1) : (sn > 0 || dn > 1);
    if (act) {
        for (int p = lo; p < len; p += 2) x[p] = x[p] * DWT_K;
        for (int p = 1 - lo; p < len; p += 2) x[p] = x[p] * DWT_TWO_INVK;
        auto nb = [&](int p) {
            int l = p - 1 < 0 ? p + 1 : p - 1;
            int r = p + 1 >= len ? p - 1 : p + 1;
            return x[l] + x[r];
        };
        const float cs[4] = {-DWT_DELTA, -DWT_GAMMA, -DWT_BETA, -DWT_ALPHA};
        for (int s = 0; s < 4; ++s) {
            int start = s % 2 == 0 ? lo : 1 - lo;
            for (int p = start; p < len; p += 2) {
                float n = nb(p);
                x[p] = x[p] + n * cs[s];
            }
        }
    }
    for (int i = 0; i < len; ++i) a[i * stride] = x[i];
}

template <typename T, typename F>
void idwt_tile(TileComp& tc, std::vector<T>& buf, F line) {
    int w = tc.x1 - tc.x0;
    std::vector<T> tmp;
    for (uint32_t r = 1; r < tc.numres; ++r) {
        const Res& lo = tc.res[r - 1];
        const Res& res = tc.res[r];
        int rw = res.x1 - res.x0, rh = res.y1 - res.y0;
        int sn = lo.x1 - lo.x0, dn = rw - sn, cas = res.x0 % 2;
        if (rw > 0)
            for (int j = 0; j < rh; ++j)
                line(&buf[(size_t)j * w], 1, sn, dn, cas, tmp);
        sn = lo.y1 - lo.y0;
        dn = rh - sn;
        cas = res.y0 % 2;
        if (rh > 0)
            for (int i = 0; i < rw; ++i)
                line(&buf[i], (size_t)w, sn, dn, cas, tmp);
    }
}

// ---------------------------------------------------------------- decode

void decode_tile(Codestream& cs, uint32_t tileno) {
    TCP& tcp = cs.tcps[tileno];
    Tile tile;
    init_tile(cs, tcp, tileno, tile);
    // tier 2
    std::vector<Packet> order = packet_order(cs, tcp, tile);
    std::vector<uint8_t> ppt;
    HeaderSource hs{nullptr, 0};
    HeaderSource* hsp = nullptr;
    if (cs.ppm) {
        hs = {cs.ppm_buf.data(), cs.ppm_buf.size(), cs.ppm_pos};
        hsp = &hs;
    } else if (!tcp.ppt_parts.empty()) {
        for (auto& part : tcp.ppt_parts) ppt.insert(ppt.end(), part.begin(),
                                                    part.end());
        hs = {ppt.data(), ppt.size(), 0};
        hsp = &hs;
    }
    size_t pos = 0;
    for (const Packet& pk : order)
        read_packet(tcp, tile, pk, tcp.data.data(), tcp.data.size(), pos,
                    hsp);
    if (cs.ppm) cs.ppm_pos = hs.pos;
    // tier 1 and dequantisation
    T1 t1;
    for (size_t c = 0; c < tile.comps.size(); ++c) {
        TileComp& tc = tile.comps[c];
        const TCCP& tccp = tcp.tccps[c];
        int tw = tc.x1 - tc.x0;
        for (uint32_t r = 0; r < tc.numres; ++r) {
            Res& res = tc.res[r];
            for (int b = 0; b < res.numbands; ++b) {
                Band& band = res.bands[b];
                for (Precinct& pr : band.precs)
                    for (Cblk& cb : pr.cblks) {
                        if (cb.x1 <= cb.x0 || cb.y1 <= cb.y0) continue;
                        int x = cb.x0 - band.x0, y = cb.y0 - band.y0;
                        if (band.bandno & 1) {
                            const Res& pres = tc.res[r - 1];
                            x += pres.x1 - pres.x0;
                        }
                        if (band.bandno & 2) {
                            const Res& pres = tc.res[r - 1];
                            y += pres.y1 - pres.y0;
                        }
                        if (!cb.numsegs) continue;
                        t1.decode(cb, band.bandno, tccp.roishift,
                                  tccp.cblksty);
                        int cw = t1.w, ch = t1.h;
                        if (tccp.qmfbid == 1) {
                            for (int j = 0; j < ch; ++j)
                                for (int i = 0; i < cw; ++i)
                                    tc.idata[(size_t)(y + j) * tw + x + i] =
                                        t1.data[j * cw + i] / 2;
                        } else {
                            float step = 0.5f * band.stepsize;
                            for (int j = 0; j < ch; ++j)
                                for (int i = 0; i < cw; ++i)
                                    tc.fdata[(size_t)(y + j) * tw + x + i] =
                                        (float)t1.data[j * cw + i] * step;
                        }
                    }
            }
        }
        // the inverse wavelet transform
        if (tccp.qmfbid == 1)
            idwt_tile(tc, tc.idata, [](int32_t* a, size_t s, int sn, int dn,
                                       int cas, std::vector<int32_t>& t) {
                idwt53(a, s, sn, dn, cas, t);
            });
        else
            idwt_tile(tc, tc.fdata, [](float* a, size_t s, int sn, int dn,
                                       int cas, std::vector<float>& t) {
                idwt97(a, s, sn, dn, cas, t);
            });
    }
    // the inverse component transform (OpenJPEG: on the first three
    // components when their sizes agree; the first one's wavelet decides)
    if (tcp.mct && tile.comps.size() >= 3) {
        TileComp &c0 = tile.comps[0], &c1 = tile.comps[1],
                 &c2 = tile.comps[2];
        bool same = true;
        for (int k = 1; k < 3; ++k) {
            const TileComp& t = tile.comps[k];
            if (t.x1 - t.x0 != c0.x1 - c0.x0 || t.y1 - t.y0 != c0.y1 - c0.y0)
                same = false;
        }
        if (same) {
            size_t n = (size_t)(c0.x1 - c0.x0) * (c0.y1 - c0.y0);
            if (tcp.tccps[0].qmfbid == 1) {
                if (c1.idata.size() != n || c2.idata.size() != n)
                    throw Unsupported("JPEG 2000 colour transform across "
                                      "components of different wavelets");
                for (size_t i = 0; i < n; ++i) {
                    int32_t y = c0.idata[i], u = c1.idata[i], v = c2.idata[i];
                    int32_t g = y - ((u + v) >> 2);
                    c0.idata[i] = v + g;
                    c1.idata[i] = g;
                    c2.idata[i] = u + g;
                }
            } else {
                if (c1.fdata.size() != n || c2.fdata.size() != n)
                    throw Unsupported("JPEG 2000 colour transform across "
                                      "components of different wavelets");
                for (size_t i = 0; i < n; ++i) {
                    float y = c0.fdata[i], u = c1.fdata[i], v = c2.fdata[i];
                    float r = y + (v * 1.402f);
                    float g = y - (u * 0.34413f) - (v * 0.71414f);
                    float b = y + (u * 1.772f);
                    c0.fdata[i] = r;
                    c1.fdata[i] = g;
                    c2.fdata[i] = b;
                }
            }
        }
    }
    // DC level shift, clamping, into the image
    for (size_t c = 0; c < tile.comps.size(); ++c) {
        TileComp& tc = tile.comps[c];
        Comp& ic = cs.image.comps[c];
        int32_t lo, hi, shift;
        if (ic.sgnd) {
            lo = -(int32_t)(1u << (ic.prec - 1));
            hi = (int32_t)((1u << (ic.prec - 1)) - 1);
            shift = 0;
        } else {
            lo = 0;
            hi = (int32_t)((1u << ic.prec) - 1);
            shift = (int32_t)(1u << (ic.prec - 1));
        }
        int tw = tc.x1 - tc.x0;
        for (int y = tc.y0; y < tc.y1; ++y)
            for (int x = tc.x0; x < tc.x1; ++x) {
                size_t i = (size_t)(y - tc.y0) * tw + (x - tc.x0);
                int64_t v;
                if (tcp.tccps[c].qmfbid == 1) {
                    v = (int64_t)tc.idata[i] + shift;
                } else {
                    float f = tc.fdata[i];
                    if (f > (float)INT32_MAX) v = hi;
                    else if (f < (float)INT32_MIN) v = lo;
                    else v = (int64_t)std::lrintf(f) + shift;
                }
                v = std::max<int64_t>(lo, std::min<int64_t>(hi, v));
                ic.data[(size_t)(y - ic.y0) * ic.w + (x - ic.x0)] = (int32_t)v;
            }
    }
}

// Reads the codestream at ``p``; decodes its tiles if ``decode``.
void read_codestream(const uint8_t* p, size_t n, Codestream& cs,
                     bool decode) {
    Reader r(p, n);
    if (r.u16() != 0xFF4F) throw Corrupt("JPEG 2000 codestream without SOC");
    if (r.u16() != 0xFF51) throw Corrupt("JPEG 2000 codestream without SIZ");
    size_t len = r.u16();
    if (len < 41) throw Corrupt("JPEG 2000 SIZ marker size");
    size_t end = r.pos + len - 2;
    read_siz(r, cs);
    r.pos = end;
    bool cod = false, qcd = false;
    for (;;) {
        uint32_t m = r.u16();
        if (m == 0xFF90) break;                              // SOT
        if (m < 0xFF30 || m == 0xFFD9)
            throw Corrupt("JPEG 2000 main header without SOT");
        len = r.u16();
        if (len < 2) throw Corrupt("JPEG 2000 marker size");
        r.need(len - 2);
        if (m == 0xFF52) cod = true;
        if (m == 0xFF5C) qcd = true;
        read_marker(r, cs, m, len - 2, cs.deflt, true);
    }
    if (!cod) throw Corrupt("JPEG 2000 main header without COD");
    if (!qcd) throw Corrupt("JPEG 2000 main header without QCD");
    if (!decode) return;
    for (auto& comp : cs.image.comps)
        comp.data.clear();
    // PPM: one stream of packet headers, the Nppm lengths removed
    if (cs.ppm) {
        std::vector<uint8_t> all;
        for (auto& part : cs.ppm_parts) all.insert(all.end(), part.begin(),
                                                   part.end());
        size_t at = 0;
        while (at < all.size()) {
            if (all.size() - at < 4)
                throw Corrupt("JPEG 2000 PPM without its Nppm");
            uint32_t nppm = ((uint32_t)all[at] << 24) | (all[at + 1] << 16) |
                            (all[at + 2] << 8) | all[at + 3];
            at += 4;
            size_t take = std::min<size_t>(nppm, all.size() - at);
            cs.ppm_buf.insert(cs.ppm_buf.end(), all.begin() + at,
                              all.begin() + at + take);
            at += take;
        }
    }
    uint32_t ntiles = cs.tw * cs.th;
    cs.tcps.assign(ntiles, cs.deflt);
    for (TCP& t : cs.tcps) t.cod = false;
    std::vector<uint32_t> ready;
    uint32_t decoded = 0;
    auto decode_now = [&](uint32_t t) {
        if (decoded == 0)
            for (auto& comp : cs.image.comps)
                comp.data.assign((size_t)comp.w * comp.h, 0);
        decode_tile(cs, t);
        cs.tcps[t].decoded = true;
        cs.tcps[t].data.clear();
        cs.tcps[t].data.shrink_to_fit();
        ++decoded;
    };
    // r is just past an SOT marker
    for (;;) {
        size_t sot = r.pos - 2;
        if (r.u16() != 10) throw Corrupt("JPEG 2000 SOT marker size");
        uint32_t isot = r.u16(), psot = r.u32(), tpsot = r.u8(),
                 tnsot = r.u8();
        if (isot >= ntiles) throw Corrupt("JPEG 2000 tile index beyond the "
                                          "tile grid");
        TCP& tcp = cs.tcps[isot];
        if (tcp.decoded)
            throw Corrupt("JPEG 2000 tile-part of a tile already decoded");
        if (tnsot) {
            if (tcp.nb_parts && tpsot >= tcp.nb_parts)
                throw Corrupt("JPEG 2000 tile-part index beyond TNsot");
            if (tpsot >= tnsot)
                throw Corrupt("JPEG 2000 tile-part index beyond TNsot");
            tcp.nb_parts = tnsot;
        }
        // the tile-part header
        uint32_t m;
        for (;;) {
            m = r.u16();
            if (m == 0xFF93) break;                          // SOD
            if (m < 0xFF30) throw Corrupt("JPEG 2000 tile-part header "
                                          "without SOD");
            len = r.u16();
            if (len < 2) throw Corrupt("JPEG 2000 marker size");
            r.need(len - 2);
            if (tcp.parts_read > 0 &&
                (m == 0xFF52 || m == 0xFF53 || m == 0xFF5C || m == 0xFF5D ||
                 m == 0xFF5E)) {
                r.pos += len - 2;    // only the first tile-part's count
                continue;
            }
            read_marker(r, cs, m, len - 2, tcp, false);
        }
        size_t body;
        if (psot == 0) {
            body = r.left() >= 2 ? r.left() - 2 : 0;
        } else {
            size_t header = r.pos - sot;
            body = psot >= header ? psot - header : 0;
            if (body > r.left())
                throw Unsupported("JPEG 2000 tile-part longer than the "
                                  "stream (a cut stream: cv2's OpenJPEG "
                                  "fails, \"Tile part length size "
                                  "inconsistent with stream length\")");
        }
        tcp.data.insert(tcp.data.end(), p + r.pos, p + r.pos + body);
        tcp.has_data = true;
        r.pos += body;
        ++tcp.parts_read;
        bool complete = tcp.nb_parts && tpsot + 1 == tcp.nb_parts;
        if (complete) {
            decode_now(isot);
            if (decoded == ntiles) break;
        }
        // the next marker: another tile-part or the end of the codestream
        if (r.left() < 2) {
            if (r.left() == 0 && psot == 0 && !complete) break;
            throw Unsupported("JPEG 2000 codestream cut after a tile-part, "
                              "without EOC (cv2's OpenJPEG fails, \"Stream "
                              "too short\")");
        }
        m = r.u16();
        if (m == 0xFFD9) break;
        if (m != 0xFF90) {
            if (r.left() == 0) break;
            throw Corrupt("JPEG 2000 tile-part not followed by SOT or EOC");
        }
    }
    // tiles of an unknown number of tile-parts, in index order
    for (uint32_t t = 0; t < ntiles; ++t)
        if (cs.tcps[t].has_data && !cs.tcps[t].decoded) decode_now(t);
    if (decoded == 0)
        throw Unsupported("JPEG 2000 codestream without a tile (cv2's "
                          "OpenJPEG fails on it)");
}

// ---------------------------------------------------------------- JP2

struct Jp2 {
    bool is_jp2 = false;
    size_t cs_off = 0, cs_len = 0;
    uint32_t ihdr_w = 0, ihdr_h = 0;
    int meth = 0;
    uint32_t enumcs = 0;
    bool has_colr = false;
    // pclr
    bool has_pclr = false, has_cmap = false;
    uint32_t nr_entries = 0, nr_channels = 0;
    std::vector<uint8_t> ch_size, ch_sign;
    std::vector<uint32_t> entries;
    struct Cmap { uint32_t cmp, mtyp, pcol; };
    std::vector<Cmap> cmap;
    struct Cdef { uint32_t cn, typ, asoc; };
    std::vector<Cdef> cdef;
    bool has_cdef = false;
};

void read_jp2h(const uint8_t* p, size_t n, Jp2& j) {
    size_t pos = 0;
    bool first = true;
    while (pos + 8 <= n) {
        Reader r(p + pos, n - pos);
        uint64_t lbox = r.u32();
        uint32_t tbox = r.u32();
        size_t hdr = 8;
        if (lbox == 1) { lbox = r.u64(); hdr = 16; }
        if (lbox == 0) lbox = n - pos;
        if (lbox < hdr || lbox > n - pos)
            throw Corrupt("JPEG 2000 box size out of range in jp2h");
        const uint8_t* b = p + pos + hdr;
        size_t blen = (size_t)lbox - hdr;
        Reader br(b, blen);
        if (first && tbox != 0x69686472)                     // ihdr
            throw Corrupt("JPEG 2000 jp2h box without ihdr first");
        first = false;
        if (tbox == 0x69686472) {                            // ihdr
            j.ihdr_h = br.u32();
            j.ihdr_w = br.u32();
        } else if (tbox == 0x636f6c72 && !j.has_colr) {      // colr
            j.meth = (int)br.u8();
            br.u8();
            br.u8();
            if (j.meth == 1) {
                if (blen < 7) throw Corrupt("JPEG 2000 colr box too short");
                j.enumcs = br.u32();
                j.has_colr = true;
            } else if (j.meth == 2) {
                j.enumcs = 0;
                j.has_colr = true;
            }
        } else if (tbox == 0x70636c72) {                     // pclr
            if (j.has_pclr) throw Corrupt("JPEG 2000 with two pclr boxes");
            j.has_pclr = true;
            j.nr_entries = br.u16();
            j.nr_channels = br.u8();
            if (j.nr_entries == 0 || j.nr_entries > 1024 ||
                j.nr_channels == 0)
                throw Corrupt("JPEG 2000 pclr box out of range");
            for (uint32_t i = 0; i < j.nr_channels; ++i) {
                uint32_t v = br.u8();
                j.ch_size.push_back((v & 0x7f) + 1);
                j.ch_sign.push_back((v >> 7) & 1);
            }
            for (uint32_t e = 0; e < j.nr_entries; ++e)
                for (uint32_t i = 0; i < j.nr_channels; ++i) {
                    uint32_t bytes = (j.ch_size[i] + 7) >> 3;
                    if (bytes > 4) bytes = 4;
                    uint32_t v = 0;
                    for (uint32_t k = 0; k < bytes; ++k) v = (v << 8) | br.u8();
                    j.entries.push_back(v);
                }
        } else if (tbox == 0x636d6170) {                     // cmap
            if (!j.has_pclr)
                throw Corrupt("JPEG 2000 cmap box before its pclr");
            if (j.has_cmap) throw Corrupt("JPEG 2000 with two cmap boxes");
            j.has_cmap = true;
            for (uint32_t i = 0; i < j.nr_channels; ++i) {
                Jp2::Cmap c;
                c.cmp = br.u16();
                c.mtyp = br.u8();
                c.pcol = br.u8();
                j.cmap.push_back(c);
            }
        } else if (tbox == 0x63646566) {                     // cdef
            if (j.has_cdef) throw Corrupt("JPEG 2000 with two cdef boxes");
            j.has_cdef = true;
            uint32_t k = br.u16();
            if (k == 0) throw Corrupt("JPEG 2000 empty cdef box");
            for (uint32_t i = 0; i < k; ++i) {
                Jp2::Cdef d;
                d.cn = br.u16();
                d.typ = br.u16();
                d.asoc = br.u16();
                j.cdef.push_back(d);
            }
        }
        pos += (size_t)lbox;
    }
    if (first) throw Corrupt("JPEG 2000 jp2h box without ihdr");
}

void read_boxes(const uint8_t* p, size_t n, Jp2& j) {
    // a file cut before its codestream box holds nothing to decode
    bool has_jp2c = false;
    for (size_t at = 0; at + 8 <= n && !has_jp2c;) {
        Reader r(p + at, n - at);
        uint64_t lbox = r.u32();
        has_jp2c = r.u32() == 0x6a703263;
        if (lbox == 1 && r.left() >= 8) lbox = r.u64();
        if (lbox == 0 || lbox < 8 || lbox > n - at) break;
        at += (size_t)lbox;
    }
    if (!has_jp2c)
        throw Unsupported("JPEG 2000 file without a codestream box (cut "
                          "short? cv2's OpenJPEG fails on it)");
    size_t pos = 0;
    int k = 0;
    bool jp2h = false;
    while (pos + 8 <= n) {
        Reader r(p + pos, n - pos);
        uint64_t lbox = r.u32();
        uint32_t tbox = r.u32();
        size_t hdr = 8;
        if (lbox == 1) { lbox = r.u64(); hdr = 16; }
        if (tbox == 0x6a703263) {                            // jp2c
            // OpenJPEG reads the codestream to the end of the file,
            // whatever the box's length says
            if (!jp2h) throw Corrupt("JPEG 2000 file without jp2h before "
                                     "its codestream");
            j.cs_off = pos + hdr;
            j.cs_len = n - j.cs_off;
            return;
        }
        if (lbox == 0) lbox = n - pos;
        if (lbox < hdr || lbox > n - pos)
            throw Corrupt("JPEG 2000 box size out of range");
        if (k == 0 && tbox != 0x6a502020)
            throw Corrupt("JPEG 2000 file without its signature box first");
        if (k == 1 && tbox != 0x66747970)
            throw Corrupt("JPEG 2000 file without ftyp second");
        if (tbox == 0x6a703268) {                            // jp2h
            read_jp2h(p + pos + hdr, (size_t)lbox - hdr, j);
            jp2h = true;
        }
        pos += (size_t)lbox;
        ++k;
    }
    throw Corrupt("JPEG 2000 file without a codestream box");
}

struct Decoded {
    Codestream cs;
    Jp2 jp2;
};

void parse(const uint8_t* p, size_t n, Decoded& d, bool decode) {
    static const uint8_t sig[12] = {0, 0, 0, 12, 'j', 'P', ' ', ' ',
                                    13, 10, 0x87, 10};
    if (n >= 12 && !std::memcmp(p, sig, 12)) {
        d.jp2.is_jp2 = true;
        read_boxes(p, n, d.jp2);
        read_codestream(p + d.jp2.cs_off, d.jp2.cs_len, d.cs, decode);
        const Image& im = d.cs.image;
        if (d.jp2.ihdr_w != (uint32_t)(im.x1 - im.x0) ||
            d.jp2.ihdr_h != (uint32_t)(im.y1 - im.y0))
            throw Unsupported("JPEG 2000 ihdr size differs from its SIZ "
                              "(cv2's OpenJPEG fails on it)");
        if (d.jp2.meth == 1 || d.jp2.meth == 2) {
            uint32_t e = d.jp2.enumcs;
            d.cs.image.color_space = e == 16 ? CLRSPC_SRGB
                : e == 17 ? CLRSPC_GRAY : e == 18 ? CLRSPC_SYCC
                : e == 24 ? CLRSPC_EYCC : e == 12 ? CLRSPC_CMYK
                : CLRSPC_UNKNOWN;
        } else {
            d.cs.image.color_space = CLRSPC_UNKNOWN;
        }
    } else if (n >= 4 && p[0] == 0xff && p[1] == 0x4f && p[2] == 0xff &&
               p[3] == 0x51) {
        read_codestream(p, n, d.cs, decode);
        d.cs.image.color_space = CLRSPC_UNSPECIFIED;
    } else {
        throw Corrupt("not a JPEG 2000 file");
    }
}

// opj_jp2_check_color, then the palette and the channel definitions as
// opj_jp2_decode applies them
void apply_jp2(Decoded& d) {
    Jp2& j = d.jp2;
    Image& im = d.cs.image;
    uint32_t nc = (uint32_t)im.comps.size();
    bool pclr = j.has_pclr && j.has_cmap;
    if (j.has_cdef) {
        uint32_t nr = pclr ? j.nr_channels : nc;
        for (auto& c : j.cdef) {
            if (c.cn >= nr)
                throw Unsupported("JPEG 2000 cdef names a channel beyond "
                                  "the image (cv2's OpenJPEG fails)");
            if (c.asoc != 65535 && c.asoc > 0 && c.asoc - 1 >= nr)
                throw Unsupported("JPEG 2000 cdef associates a channel "
                                  "beyond the image (cv2's OpenJPEG fails)");
        }
        for (uint32_t k = nr; k > 0; --k) {
            bool found = false;
            for (auto& c : j.cdef) found |= c.cn == k - 1;
            if (!found)
                throw Unsupported("JPEG 2000 incomplete cdef (cv2's "
                                  "OpenJPEG fails on it)");
        }
    }
    if (pclr) {
        uint32_t nr = j.nr_channels;
        std::vector<bool> used(nr, false);
        bool sane = true;
        for (auto& c : j.cmap) if (c.cmp >= nc) sane = false;
        for (uint32_t i = 0; i < nr && sane; ++i) {
            auto& c = j.cmap[i];
            if (c.mtyp > 1 || c.pcol >= nr || (used[c.pcol] && c.mtyp == 1) ||
                (c.mtyp == 0 && c.pcol != 0) || (c.mtyp == 1 && c.pcol != i))
                sane = false;
            else
                used[c.pcol] = true;
        }
        for (uint32_t i = 0; i < nr && sane; ++i)
            if (!used[i] && j.cmap[i].mtyp != 0) sane = false;
        if (sane && nc == 1) {
            bool fix = false;
            for (uint32_t i = 0; i < nr; ++i) fix |= !used[i];
            if (fix)
                for (uint32_t i = 0; i < nr; ++i) {
                    j.cmap[i].mtyp = 1;
                    j.cmap[i].pcol = i;
                }
        }
        if (!sane)
            throw Unsupported("JPEG 2000 inconsistent cmap (cv2's OpenJPEG "
                              "fails on it)");
        std::vector<Comp> out(nr);
        int32_t top = (int32_t)j.nr_entries - 1;
        for (uint32_t i = 0; i < nr; ++i) {
            const Comp& src = im.comps[j.cmap[i].cmp];
            Comp& dst = out[i];
            dst = src;
            dst.prec = j.ch_size[i];
            dst.sgnd = j.ch_sign[i];
            if (j.cmap[i].mtyp == 0) continue;
            for (size_t k = 0; k < src.data.size(); ++k) {
                int32_t v = src.data[k];
                v = v < 0 ? 0 : v > top ? top : v;
                dst.data[k] = (int32_t)j.entries[(size_t)v * nr + i];
            }
        }
        im.comps = out;
    }
    if (j.has_cdef) {
        std::vector<Jp2::Cdef> info = j.cdef;
        uint32_t n = (uint32_t)im.comps.size();
        for (size_t i = 0; i < info.size(); ++i) {
            uint32_t cn = info[i].cn, asoc = info[i].asoc;
            if (cn >= n) continue;
            if (asoc == 0 || asoc == 65535) {
                im.comps[cn].alpha = (uint16_t)info[i].typ;
                continue;
            }
            uint32_t acn = asoc - 1;
            if (acn >= n) continue;
            if (cn != acn && info[i].typ == 0) {
                std::swap(im.comps[cn], im.comps[acn]);
                for (size_t k = i + 1; k < info.size(); ++k) {
                    if (info[k].cn == cn) info[k].cn = acn;
                    else if (info[k].cn == acn) info[k].cn = cn;
                }
            }
            im.comps[cn].alpha = (uint16_t)info[i].typ;
        }
    }
}

int fail(char* msg, int msglen, const std::string& text, int rc) {
    if (msglen > 0) {
        std::snprintf(msg, (size_t)msglen, "%s", text.c_str());
    }
    return rc;
}

}  // namespace

extern "C" {

// info: [width, height, components (the codestream's), colour space
// (OPJ_COLOR_SPACE), channels after the JP2 palette, x0, y0, rsiz], then
// for each of the first 16 components [precision, signed, dx, dy, x0, y0]
int hcmvs_jp2_info(const uint8_t* data, int64_t n, int64_t* info,
                   char* msg, int msglen) {
    try {
        Decoded d;
        parse(data, (size_t)n, d, false);
        const Image& im = d.cs.image;
        info[0] = im.x1 - im.x0;
        info[1] = im.y1 - im.y0;
        info[2] = (int64_t)im.comps.size();
        info[3] = im.color_space;
        info[4] = d.jp2.has_pclr && d.jp2.has_cmap
            ? d.jp2.nr_channels : (int64_t)im.comps.size();
        info[5] = im.x0;
        info[6] = im.y0;
        info[7] = d.cs.rsiz;
        for (size_t c = 0; c < im.comps.size() && c < 16; ++c) {
            const Comp& k = im.comps[c];
            int64_t* o = info + 8 + 6 * c;
            o[0] = k.prec; o[1] = k.sgnd; o[2] = k.dx; o[3] = k.dy;
            o[4] = k.x0; o[5] = k.y0;
        }
        return 0;
    } catch (const Unsupported& e) {
        return fail(msg, msglen, e.what(), 1);
    } catch (const Corrupt& e) {
        return fail(msg, msglen, e.what(), 2);
    } catch (const std::exception& e) {
        return fail(msg, msglen, std::string("JPEG 2000: ") + e.what(), 2);
    }
}

// The decoded components after the JP2 palette and channel definitions,
// each (h, w) int32, one after another in ``out`` (``cap`` values); per
// channel in ``comp_info`` (16 at most): [precision, signed, w, h, alpha]
int hcmvs_jp2_decode(const uint8_t* data, int64_t n, int32_t* out,
                     int64_t cap, int64_t* comp_info, char* msg,
                     int msglen) {
    try {
        Decoded d;
        parse(data, (size_t)n, d, true);
        if (d.jp2.is_jp2) apply_jp2(d);
        const Image& im = d.cs.image;
        int64_t at = 0;
        for (size_t c = 0; c < im.comps.size(); ++c) {
            const Comp& k = im.comps[c];
            if (at + (int64_t)k.data.size() > cap)
                return fail(msg, msglen, "JPEG 2000 output buffer too small",
                            2);
            std::memcpy(out + at, k.data.data(), k.data.size() * 4);
            at += (int64_t)k.data.size();
            if (c < 16) {
                int64_t* o = comp_info + 5 * c;
                o[0] = k.prec; o[1] = k.sgnd; o[2] = k.w; o[3] = k.h;
                o[4] = k.alpha;
            }
        }
        return 0;
    } catch (const Unsupported& e) {
        return fail(msg, msglen, e.what(), 1);
    } catch (const Corrupt& e) {
        return fail(msg, msglen, e.what(), 2);
    } catch (const std::exception& e) {
        return fail(msg, msglen, std::string("JPEG 2000: ") + e.what(), 2);
    }
}

}  // extern "C"
