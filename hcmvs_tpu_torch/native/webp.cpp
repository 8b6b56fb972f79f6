// WebP decoding to the samples cv2.imread gives (OpenCV 5.0 decodes WebP
// with libwebp: WebPDecodeBGR / WebPDecodeBGRA for a still image, the
// first frame of WebPAnimDecoder for an animation), written from the
// format's specifications:
//
// - the container: "WebP Container Specification" (RIFF, the simple
//   'VP8 ' / 'VP8L' files, the extended 'VP8X' file with 'ALPH', 'ICCP',
//   'EXIF', 'XMP ', 'ANIM' and 'ANMF' chunks);
// - lossy images: RFC 6386, "VP8 Data Format and Decoding Guide" (the
//   boolean decoder of section 7, the frame header of sections 9 and 19,
//   segments and quantizers (9.3, 9.6, 14.1), token partitions (9.5), the
//   coefficient token tree and its probabilities (13), the intra modes
//   (11, 12), the inverse DCT and WHT (14.3, 14.4) and the loop filters
//   (15)), reconstructed to Y'CbCr 4:2:0 and turned into BGR(A) by
//   libwebp's "fancy" upsampler (each chroma sample weighted 9:3:3:1
//   between its four neighbours) and its 14-bit fixed-point BT.601
//   conversion;
// - lossless images and lossless alpha: "WebP Lossless Bitstream
//   Specification" (prefix codes and meta prefix codes, the predictor,
//   cross-colour, subtract-green and colour-indexing transforms, LZ77
//   backward references with the 120-entry distance map, the colour
//   cache);
// - the 'ALPH' chunk: raw or lossless-coded alpha, horizontally,
//   vertically or gradient filtered ("WebP Container Specification",
//   "Alpha").
//
// The constant tables that the format defines but that cannot be derived
// (RFC 6386's default coefficient probabilities (section 13.5) and their
// update probabilities (13.4), the intra sub-block mode probabilities
// (11.5), the DC and AC quantizer tables (14.1), and the lossless
// format's distance map) were taken from libwebp 1.6's read-only data;
// the fixtures' bit equality with cv2 checks every entry.
//
// C interface (ctypes):
//   hcmvs_webp_info(data, size, info[8], msg, msglen): width, height,
//     has_alpha, animated, exif offset, exif length of the canvas;
//   hcmvs_webp_decode(data, size, channels, out, out_size, msg, msglen):
//     the canvas as (height, width, 4) BGRA (alpha 255 where the file has
//     none), (height, width, 3) BGR or, for 1 channel, cvtColor's gray of
//     the BGR.
// Both return 0, 1 for a feature outside the decoder's scope or 2 for a
// corrupt or truncated file, with the reason in msg.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Failure {
  int code;  // 1 unsupported, 2 corrupt
  std::string msg;
};

[[noreturn]] void corrupt(const std::string& m) { throw Failure{2, m}; }
[[noreturn]] void unsupported(const std::string& m) { throw Failure{1, m}; }

inline uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t le24(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16);
}
inline uint32_t le32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24);
}
inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

// Tables (see the header comment for where they come from)
// RFC 6386 section 13.5: default coefficient probabilities;
// section 13.4: their update probabilities; section 11.5: the sub-block
// mode probabilities; section 14.1: the DC and AC quantizer steps;
// lossless specification, "LZ77 Backward Reference": the distance map.
const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128};
const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255};
const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24};
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284};
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112};

// ---------------------------------------------------------------------------
// VP8 (RFC 6386)

// The boolean entropy decoder (RFC 6386 section 7), kept as a window of
// bits over the partition the way libwebp reads it, so that a partition
// read past its end is noticed where libwebp notices it.
struct BoolReader {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  int bits = -8;         // bits below the current 8-bit window
  uint32_t range = 254;  // range - 1
  bool eof = false;

  void init(const uint8_t* p, size_t size) {
    buf = p;
    end = p + size;
    value = 0;
    bits = -8;
    range = 254;
    eof = false;
    load();
  }
  void load() {
    while (bits < 0) {
      if (buf < end) {
        value = (value << 8) | *buf++;
        bits += 8;
      } else if (!eof) {
        value <<= 8;
        bits += 8;
        eof = true;
      } else {
        bits = 0;
      }
    }
  }
  int bit(int prob) {
    if (bits < 0) load();
    uint32_t r = range;
    const uint32_t split = (r * (uint32_t)prob) >> 8;
    const uint32_t v = (uint32_t)(value >> bits);
    int b;
    if (v > split) {
      r -= split;
      value -= (uint64_t)(split + 1) << bits;
      b = 1;
    } else {
      r = split + 1;
      b = 0;
    }
    const int shift = __builtin_clz(r) - 24;  // r << shift in [128, 255]
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return b;
  }
  uint32_t literal(int n) {  // most significant bit first
    uint32_t v = 0;
    while (n-- > 0) v |= (uint32_t)bit(0x80) << n;
    return v;
  }
  int signed_literal(int n) {
    const int v = (int)literal(n);
    return bit(0x80) ? -v : v;
  }
  int sign(int v) { return bit(0x80) ? -v : v; }
};

// Section 13: the coefficient token probabilities' layout
const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
// section 13.2: the extra bits of DCT_CAT3 .. DCT_CAT6
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// section 11.2: the sub-block mode tree (leaves are negated modes)
enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED,
       B_LD_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED,
       // 16x16 and chroma: DC_PRED = B_DC_PRED, TM, V = VE, H = HE
       DC_NOTOP = 10, DC_NOLEFT, DC_NOTOPLEFT };
const int8_t kYModesIntra4[18] = {
    -B_DC_PRED, 1, -B_TM_PRED, 2, -B_VE_PRED, 3, 4, 6, -B_HE_PRED, 5,
    -B_RD_PRED, -B_VR_PRED, -B_LD_PRED, 7, -B_VL_PRED, 8, -B_HD_PRED,
    -B_HU_PRED};

constexpr int BPS = 32;  // stride of the macroblock work buffer

#define AVG3(a, b, c) ((uint8_t)(((a) + 2 * (b) + (c) + 2) >> 2))
#define AVG2(a, b) ((uint8_t)(((a) + (b) + 1) >> 1))
#define DST(x, y) dst[(x) + (y) * BPS]

// Section 12: intra prediction, on a block of the work buffer whose row
// above, column to the left and corner hold the edge samples
void TrueMotion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[-1 + y * BPS];
    for (int x = 0; x < size; ++x)
      dst[x + y * BPS] = (uint8_t)clip255(top[x] + l - tl);
  }
}

void Fill(uint8_t* dst, int size, int v) {
  for (int y = 0; y < size; ++y) memset(dst + y * BPS, v, size);
}

void PredictBlock(uint8_t* dst, int size, int mode) {
  const int shift = size == 16 ? 5 : 4;
  int dc = 0;
  switch (mode) {
    case B_DC_PRED:
      for (int i = 0; i < size; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      Fill(dst, size, (dc + size) >> shift);
      break;
    case DC_NOTOP:
      for (int i = 0; i < size; ++i) dc += dst[-1 + i * BPS];
      Fill(dst, size, (dc + size / 2) >> (shift - 1));
      break;
    case DC_NOLEFT:
      for (int i = 0; i < size; ++i) dc += dst[i - BPS];
      Fill(dst, size, (dc + size / 2) >> (shift - 1));
      break;
    case DC_NOTOPLEFT:
      Fill(dst, size, 0x80);
      break;
    case B_TM_PRED:
      TrueMotion(dst, size);
      break;
    case B_VE_PRED:
      for (int y = 0; y < size; ++y) memcpy(dst + y * BPS, dst - BPS, size);
      break;
    case B_HE_PRED:
      for (int y = 0; y < size; ++y) memset(dst + y * BPS, dst[-1 + y * BPS], size);
      break;
  }
}

void Predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS];
  const int L = dst[-1 + 3 * BPS];
  switch (mode) {
    case B_DC_PRED: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      Fill(dst, 4, dc >> 3);
      break;
    }
    case B_TM_PRED:
      TrueMotion(dst, 4);
      break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {AVG3(X, A, B), AVG3(A, B, C), AVG3(B, C, D),
                               AVG3(C, D, E)};
      for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE_PRED:
      memset(dst + 0 * BPS, AVG3(X, I, J), 4);
      memset(dst + 1 * BPS, AVG3(I, J, K), 4);
      memset(dst + 2 * BPS, AVG3(J, K, L), 4);
      memset(dst + 3 * BPS, AVG3(K, L, L), 4);
      break;
    case B_RD_PRED:
      DST(0, 3) = AVG3(J, K, L);
      DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
      DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
      DST(3, 0) = AVG3(D, C, B);
      break;
    case B_VR_PRED:
      DST(0, 0) = DST(1, 2) = AVG2(X, A);
      DST(1, 0) = DST(2, 2) = AVG2(A, B);
      DST(2, 0) = DST(3, 2) = AVG2(B, C);
      DST(3, 0) = AVG2(C, D);
      DST(0, 3) = AVG3(K, J, I);
      DST(0, 2) = AVG3(J, I, X);
      DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
      DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
      DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
      DST(3, 1) = AVG3(B, C, D);
      break;
    case B_LD_PRED:
      DST(0, 0) = AVG3(A, B, C);
      DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
      DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
      DST(3, 3) = AVG3(G, H, H);
      break;
    case B_VL_PRED:
      DST(0, 0) = AVG2(A, B);
      DST(1, 0) = DST(0, 2) = AVG2(B, C);
      DST(2, 0) = DST(1, 2) = AVG2(C, D);
      DST(3, 0) = DST(2, 2) = AVG2(D, E);
      DST(0, 1) = AVG3(A, B, C);
      DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
      DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
      DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
      DST(3, 2) = AVG3(E, F, G);
      DST(3, 3) = AVG3(F, G, H);
      break;
    case B_HD_PRED:
      DST(0, 0) = DST(2, 1) = AVG2(I, X);
      DST(0, 1) = DST(2, 2) = AVG2(J, I);
      DST(0, 2) = DST(2, 3) = AVG2(K, J);
      DST(0, 3) = AVG2(L, K);
      DST(3, 0) = AVG3(A, B, C);
      DST(2, 0) = AVG3(X, A, B);
      DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
      DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
      DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
      DST(1, 3) = AVG3(L, K, J);
      break;
    case B_HU_PRED:
      DST(0, 0) = AVG2(I, J);
      DST(2, 0) = DST(0, 1) = AVG2(J, K);
      DST(2, 1) = DST(0, 2) = AVG2(K, L);
      DST(1, 0) = AVG3(I, J, K);
      DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
      DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) =
          DST(3, 3) = L;
      break;
  }
}

// Section 14.3: the inverse DCT of one 4x4 block, added to the prediction
// (vertical pass first, then horizontal with rounding by 8)
inline int Mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int Mul2(int a) { return (a * 35468) >> 16; }

void InverseDctAdd(const int16_t* in, uint8_t* dst) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a = in[i] + in[8 + i];
    const int b = in[i] - in[8 + i];
    const int c = Mul2(in[4 + i]) - Mul1(in[12 + i]);
    const int d = Mul1(in[4 + i]) + Mul2(in[12 + i]);
    tmp[4 * i + 0] = a + d;
    tmp[4 * i + 1] = b + c;
    tmp[4 * i + 2] = b - c;
    tmp[4 * i + 3] = a - d;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[i] + 4;
    const int a = dc + tmp[8 + i];
    const int b = dc - tmp[8 + i];
    const int c = Mul2(tmp[4 + i]) - Mul1(tmp[12 + i]);
    const int d = Mul1(tmp[4 + i]) + Mul2(tmp[12 + i]);
    uint8_t* row = dst + i * BPS;
    row[0] = (uint8_t)clip255(row[0] + ((a + d) >> 3));
    row[1] = (uint8_t)clip255(row[1] + ((b + c) >> 3));
    row[2] = (uint8_t)clip255(row[2] + ((b - c) >> 3));
    row[3] = (uint8_t)clip255(row[3] + ((a - d) >> 3));
  }
}

// Section 14.4: the inverse Walsh-Hadamard transform of the Y2 block into
// the DC of the 16 luma blocks
void InverseWht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

// Section 15: the loop filters
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void Filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = (uint8_t)clip255(p0 + a2);
  p[0] = (uint8_t)clip255(q0 - a1);
}

inline void Filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = (uint8_t)clip255(p1 + a3);
  p[-step] = (uint8_t)clip255(p0 + a2);
  p[0] = (uint8_t)clip255(q0 - a1);
  p[step] = (uint8_t)clip255(q1 - a3);
}

inline void Filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = (uint8_t)clip255(p2 + a3);
  p[-2 * step] = (uint8_t)clip255(p1 + a2);
  p[-step] = (uint8_t)clip255(p0 + a1);
  p[0] = (uint8_t)clip255(q0 - a1);
  p[step] = (uint8_t)clip255(q1 - a2);
  p[2 * step] = (uint8_t)clip255(q2 - a3);
}

inline bool Hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool NeedsFilter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool NeedsFilter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
         std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
         std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// the simple filter across one edge of ``size`` pixels: ``hstride`` steps
// across the edge, ``vstride`` along it
void SimpleEdge(uint8_t* p, int hstride, int vstride, int size, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride)
    if (NeedsFilter(p, hstride, thresh2)) Filter2(p, hstride);
}

// the normal filter: macroblock edges (``inner`` false) change three
// pixels a side, sub-block edges two
void NormalEdge(uint8_t* p, int hstride, int vstride, int size, int thresh,
                int ithresh, int hev_thresh, bool inner) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!NeedsFilter2(p, hstride, thresh2, ithresh)) continue;
    if (Hev(p, hstride, hev_thresh))
      Filter2(p, hstride);
    else if (inner)
      Filter4(p, hstride);
    else
      Filter6(p, hstride);
  }
}

struct FilterInfo {
  int limit = 0;   // 0: no filtering
  int ilevel = 0;
  int hev_thresh = 0;
  bool inner = false;
};

struct Plane {
  int w = 0, h = 0;  // whole macroblocks
  std::vector<uint8_t> px;
  uint8_t* at(int x, int y) { return px.data() + (size_t)y * w + x; }
};

struct Vp8Image {
  int width = 0, height = 0;
  Plane y, u, v;
};

struct MbData {
  bool i4x4 = false;
  int segment = 0;
  bool skip = false;
  uint8_t imodes[16] = {0};
  int uvmode = 0;
  int16_t coeffs[384];
  uint32_t non_zero_y = 0, non_zero_uv = 0;
};

inline uint32_t NzCodeBits(uint32_t nz_coeffs, int nz, int dc_nz) {
  nz_coeffs <<= 2;
  nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
  return nz_coeffs;
}

struct Vp8Decoder {
  BoolReader br;                 // the first partition
  BoolReader parts[8];           // the token partitions
  int num_parts_minus_one = 0;
  int mb_w = 0, mb_h = 0;
  // segment header
  bool use_segment = false, update_map = false, absolute_delta = true;
  int quantizer[4] = {0}, filter_strength[4] = {0};
  uint8_t segment_probs[3] = {255, 255, 255};
  // filter header
  bool simple = false;
  int level = 0, sharpness = 0;
  bool use_lf_delta = false;
  int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
  int filter_type = 0;
  // quantizers per segment: y1 (dc, ac), y2, uv
  int y1q[4][2], y2q[4][2], uvq[4][2];
  uint8_t probas[4][8][3][11];
  bool use_skip_proba = false;
  int skip_p = 0;
  FilterInfo fstrengths[4][2];

  void ParseHeaders(const uint8_t* data, size_t size, Vp8Image& img);
  void ParseQuant();
  void ParseProba();
  void ParseIntraMode(MbData& mb, uint8_t* top, uint8_t* left);
  int GetCoeffs(BoolReader& tbr, int type, int ctx, const int* dq, int n,
                int16_t* out);
  bool ParseResiduals(MbData& mb, uint8_t& t_nz, uint8_t& t_nz_dc,
                      uint8_t& l_nz, uint8_t& l_nz_dc, BoolReader& tbr);
  void Decode(const uint8_t* data, size_t size, Vp8Image& img);
};

void Vp8Decoder::ParseHeaders(const uint8_t* data, size_t size,
                              Vp8Image& img) {
  // section 9.1: the frame tag; 9.2: the key frame's start code and size
  if (size < 10) corrupt("truncated VP8 header");
  const uint32_t bits = le24(data);
  const bool key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7;
  const bool show = (bits >> 4) & 1;
  const uint32_t part_len = bits >> 5;
  if (profile > 3) corrupt("VP8 profile above 3");
  if (!show) unsupported("VP8 frame not displayable");
  if (!key_frame) unsupported("VP8 interframe");
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a)
    corrupt("VP8 start code missing");
  img.width = le16(data + 6) & 0x3fff;
  img.height = le16(data + 8) & 0x3fff;
  if (img.width == 0 || img.height == 0) corrupt("VP8 of zero size");
  mb_w = (img.width + 15) >> 4;
  mb_h = (img.height + 15) >> 4;
  data += 10;
  size -= 10;
  if (part_len > size) corrupt("VP8 first partition past the data");
  br.init(data, part_len);
  const uint8_t* rest = data + part_len;
  size_t rest_size = size - part_len;
  br.literal(1);  // colour space
  br.literal(1);  // clamping type
  // section 9.3: segments
  use_segment = br.literal(1);
  if (use_segment) {
    update_map = br.literal(1);
    if (br.literal(1)) {
      absolute_delta = br.literal(1);
      for (int s = 0; s < 4; ++s)
        quantizer[s] = br.literal(1) ? br.signed_literal(7) : 0;
      for (int s = 0; s < 4; ++s)
        filter_strength[s] = br.literal(1) ? br.signed_literal(6) : 0;
    }
    if (update_map)
      for (int s = 0; s < 3; ++s)
        segment_probs[s] = br.literal(1) ? br.literal(8) : 255;
  } else {
    update_map = false;
  }
  if (br.eof) corrupt("cannot parse the VP8 segment header");
  // section 9.6: the loop filter
  simple = br.literal(1);
  level = br.literal(6);
  sharpness = br.literal(3);
  use_lf_delta = br.literal(1);
  if (use_lf_delta && br.literal(1)) {
    for (int i = 0; i < 4; ++i)
      if (br.literal(1)) ref_lf_delta[i] = br.signed_literal(6);
    for (int i = 0; i < 4; ++i)
      if (br.literal(1)) mode_lf_delta[i] = br.signed_literal(6);
  }
  filter_type = level == 0 ? 0 : simple ? 1 : 2;
  if (br.eof) corrupt("cannot parse the VP8 filter header");
  // section 9.5: token partitions
  num_parts_minus_one = (1 << br.literal(2)) - 1;
  const size_t last = num_parts_minus_one;
  if (rest_size < 3 * last) corrupt("VP8 partition sizes past the data");
  const uint8_t* sz = rest;
  const uint8_t* part = rest + 3 * last;
  size_t left = rest_size - 3 * last;
  for (size_t p = 0; p < last; ++p) {
    size_t psize = le24(sz);
    if (psize > left) psize = left;
    parts[p].init(part, psize);
    part += psize;
    left -= psize;
    sz += 3;
  }
  parts[last].init(part, left);
  if (part >= rest + rest_size) corrupt("VP8 token partitions empty");
  ParseQuant();
  br.literal(1);  // refresh entropy probs: ignored on a key frame
  ParseProba();
}

void Vp8Decoder::ParseQuant() {
  // section 9.6 / 14.1
  const int base_q0 = br.literal(7);
  const int dqy1_dc = br.literal(1) ? br.signed_literal(4) : 0;
  const int dqy2_dc = br.literal(1) ? br.signed_literal(4) : 0;
  const int dqy2_ac = br.literal(1) ? br.signed_literal(4) : 0;
  const int dquv_dc = br.literal(1) ? br.signed_literal(4) : 0;
  const int dquv_ac = br.literal(1) ? br.signed_literal(4) : 0;
  auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
  for (int i = 0; i < 4; ++i) {
    int q;
    if (use_segment) {
      q = quantizer[i];
      if (!absolute_delta) q += base_q0;
    } else if (i > 0) {
      for (int k = 0; k < 2; ++k) {
        y1q[i][k] = y1q[0][k];
        y2q[i][k] = y2q[0][k];
        uvq[i][k] = uvq[0][k];
      }
      continue;
    } else {
      q = base_q0;
    }
    y1q[i][0] = kDcTable[clip(q + dqy1_dc, 127)];
    y1q[i][1] = kAcTable[clip(q + 0, 127)];
    y2q[i][0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
    // x * 155 / 100, as (x * 101581) >> 16 (equal for x in 0..284)
    y2q[i][1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
    if (y2q[i][1] < 8) y2q[i][1] = 8;
    uvq[i][0] = kDcTable[clip(q + dquv_dc, 117)];
    uvq[i][1] = kAcTable[clip(q + dquv_ac, 127)];
  }
}

void Vp8Decoder::ParseProba() {
  // section 13.4: coefficient probability updates
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p)
          probas[t][b][c][p] = br.bit(kCoeffsUpdateProba[t][b][c][p])
                                   ? (uint8_t)br.literal(8)
                                   : kCoeffsProba0[t][b][c][p];
  use_skip_proba = br.literal(1);
  if (use_skip_proba) skip_p = br.literal(8);
}

void Vp8Decoder::ParseIntraMode(MbData& mb, uint8_t* top, uint8_t* left) {
  // section 19.3: the macroblock header
  if (update_map)
    mb.segment = !br.bit(segment_probs[0]) ? br.bit(segment_probs[1])
                                           : br.bit(segment_probs[2]) + 2;
  else
    mb.segment = 0;
  mb.skip = use_skip_proba ? br.bit(skip_p) : false;
  mb.i4x4 = !br.bit(145);
  if (!mb.i4x4) {
    // section 11.2: the key frame's 16x16 mode tree
    const int ymode = br.bit(156) ? (br.bit(128) ? B_TM_PRED : B_HE_PRED)
                                  : (br.bit(163) ? B_VE_PRED : B_DC_PRED);
    mb.imodes[0] = (uint8_t)ymode;
    memset(top, ymode, 4);
    memset(left, ymode, 4);
  } else {
    uint8_t* modes = mb.imodes;
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* prob = kBModesProba[top[x]][ymode];
        int i = kYModesIntra4[br.bit(prob[0])];
        while (i > 0) i = kYModesIntra4[2 * i + br.bit(prob[i])];
        ymode = -i;
        top[x] = (uint8_t)ymode;
      }
      memcpy(modes, top, 4);
      modes += 4;
      left[y] = (uint8_t)ymode;
    }
  }
  mb.uvmode = !br.bit(142)   ? B_DC_PRED
              : !br.bit(114) ? B_VE_PRED
              : br.bit(183)  ? B_TM_PRED
                             : B_HE_PRED;
}

int Vp8Decoder::GetCoeffs(BoolReader& tbr, int type, int ctx, const int* dq,
                          int n, int16_t* out) {
  // section 13: the token tree, with the band of each position
  const uint8_t* p = probas[type][kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!tbr.bit(p[0])) return n;  // end of block
    while (!tbr.bit(p[1])) {       // a zero
      p = probas[type][kBands[++n]][0];
      if (n == 16) return 16;
    }
    int v;
    const uint8_t(*next)[11] = probas[type][kBands[n + 1]];
    if (!tbr.bit(p[2])) {
      v = 1;
      p = next[1];
    } else {
      if (!tbr.bit(p[3])) {
        if (!tbr.bit(p[4]))
          v = 2;
        else
          v = 3 + tbr.bit(p[5]);
      } else if (!tbr.bit(p[6])) {
        if (!tbr.bit(p[7])) {
          v = 5 + tbr.bit(159);
        } else {
          v = 7 + 2 * tbr.bit(165);
          v += tbr.bit(145);
        }
      } else {
        const int bit1 = tbr.bit(p[8]);
        const int bit0 = tbr.bit(p[9 + bit1]);
        const int cat = 2 * bit1 + bit0;
        v = 0;
        for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab)
          v += v + tbr.bit(*tab);
        v += 3 + (8 << cat);
      }
      p = next[2];
    }
    out[kZigzag[n]] = (int16_t)(tbr.sign(v) * dq[n > 0]);
  }
  return 16;
}

bool Vp8Decoder::ParseResiduals(MbData& mb, uint8_t& t_nz, uint8_t& t_nz_dc,
                                uint8_t& l_nz, uint8_t& l_nz_dc,
                                BoolReader& tbr) {
  int16_t* dst = mb.coeffs;
  memset(dst, 0, sizeof(mb.coeffs));
  int first, ac_type;
  const int seg = mb.segment;
  if (!mb.i4x4) {  // the Y2 block (type 1)
    int16_t dc[16] = {0};
    const int ctx = t_nz_dc + l_nz_dc;
    const int nz = GetCoeffs(tbr, 1, ctx, y2q[seg], 0, dc);
    t_nz_dc = l_nz_dc = (nz > 0);
    InverseWht(dc, dst);
    first = 1;
    ac_type = 0;
  } else {
    first = 0;
    ac_type = 3;
  }
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  uint8_t tnz = t_nz & 0x0f, lnz = l_nz & 0x0f;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    uint32_t nz_coeffs = 0;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + (tnz & 1);
      const int nz = GetCoeffs(tbr, ac_type, ctx, y1q[seg], first, dst);
      l = (nz > first);
      tnz = (uint8_t)((tnz >> 1) | (l << 7));
      nz_coeffs = NzCodeBits(nz_coeffs, nz, dst[0] != 0);
      dst += 16;
    }
    tnz >>= 4;
    lnz = (uint8_t)((lnz >> 1) | (l << 7));
    non_zero_y = (non_zero_y << 8) | nz_coeffs;
  }
  uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t nz_coeffs = 0;
    tnz = (uint8_t)(t_nz >> (4 + ch));
    lnz = (uint8_t)(l_nz >> (4 + ch));
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = GetCoeffs(tbr, 2, ctx, uvq[seg], 0, dst);
        l = (nz > 0);
        tnz = (uint8_t)((tnz >> 1) | (l << 3));
        nz_coeffs = NzCodeBits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 2;
      lnz = (uint8_t)((lnz >> 1) | (l << 5));
    }
    non_zero_uv |= nz_coeffs << (4 * ch);
    out_t_nz |= (uint32_t)(tnz << 4) << ch;
    out_l_nz |= (uint32_t)(lnz & 0xf0) << ch;
  }
  t_nz = (uint8_t)out_t_nz;
  l_nz = (uint8_t)out_l_nz;
  mb.non_zero_y = non_zero_y;
  mb.non_zero_uv = non_zero_uv;
  return !(non_zero_y | non_zero_uv);
}

// The macroblock's prediction and residual in a work buffer with its edge
// samples (RFC 6386 section 12: above the frame 127, left of it 129, the
// corner 127 on the top row and 129 below it; a 4x4 sub-block in the
// right column takes the 4 samples above and to the right of the
// macroblock, the last one repeated at the right edge of the frame), then
// copied into the frame.
void Reconstruct(const MbData& mb, int mb_x, int mb_y, int mb_w,
                 Vp8Image& img) {
  uint8_t ybuf[BPS * 17], ubuf[BPS * 9], vbuf[BPS * 9];
  uint8_t* const y_dst = ybuf + BPS + 8;
  uint8_t* const u_dst = ubuf + BPS + 8;
  uint8_t* const v_dst = vbuf + BPS + 8;
  struct Ch { uint8_t* dst; Plane* pl; int size; };
  const Ch chans[3] = {{y_dst, &img.y, 16}, {u_dst, &img.u, 8},
                       {v_dst, &img.v, 8}};
  for (const Ch& c : chans) {
    const int x0 = mb_x * c.size, y0 = mb_y * c.size;
    for (int j = 0; j < c.size; ++j)
      c.dst[j * BPS - 1] = mb_x > 0 ? *c.pl->at(x0 - 1, y0 + j) : 129;
    if (mb_y > 0) {
      memcpy(c.dst - BPS, c.pl->at(x0, y0 - 1), c.size);
      c.dst[-BPS - 1] = mb_x > 0 ? *c.pl->at(x0 - 1, y0 - 1) : 129;
    } else {
      memset(c.dst - BPS - 1, 127, c.size + 1 + (c.size == 16 ? 4 : 0));
    }
  }
  const int16_t* coeffs = mb.coeffs;
  if (mb.i4x4) {
    uint8_t* top_right = y_dst - BPS + 16;
    if (mb_y > 0) {
      if (mb_x >= mb_w - 1)
        memset(top_right, *img.y.at(mb_x * 16 + 15, mb_y * 16 - 1), 4);
      else
        memcpy(top_right, img.y.at(mb_x * 16 + 16, mb_y * 16 - 1), 4);
    }
    for (int r = 1; r < 4; ++r) memcpy(top_right + r * 4 * BPS, top_right, 4);
    for (int n = 0; n < 16; ++n) {
      uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
      Predict4(dst, mb.imodes[n]);
      InverseDctAdd(coeffs + n * 16, dst);
    }
  } else {
    int mode = mb.imodes[0];
    if (mode == B_DC_PRED)
      mode = mb_x == 0 ? (mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT)
                       : (mb_y == 0 ? DC_NOTOP : B_DC_PRED);
    PredictBlock(y_dst, 16, mode);
    for (int n = 0; n < 16; ++n)
      InverseDctAdd(coeffs + n * 16, y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
  }
  int uvmode = mb.uvmode;
  if (uvmode == B_DC_PRED)
    uvmode = mb_x == 0 ? (mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT)
                       : (mb_y == 0 ? DC_NOTOP : B_DC_PRED);
  PredictBlock(u_dst, 8, uvmode);
  PredictBlock(v_dst, 8, uvmode);
  for (int n = 0; n < 4; ++n) {
    const int off = (n & 1) * 4 + (n >> 1) * 4 * BPS;
    InverseDctAdd(coeffs + 256 + n * 16, u_dst + off);
    InverseDctAdd(coeffs + 320 + n * 16, v_dst + off);
  }
  for (const Ch& c : chans)
    for (int j = 0; j < c.size; ++j)
      memcpy(c.pl->at(mb_x * c.size, mb_y * c.size + j), c.dst + j * BPS,
             c.size);
}

void Vp8Decoder::Decode(const uint8_t* data, size_t size, Vp8Image& img) {
  ParseHeaders(data, size, img);
  // section 15.1 / 9.6: the filter strength of each segment and kind of
  // macroblock (sub-block modes take mode_lf_delta[0])
  if (filter_type > 0) {
    for (int s = 0; s < 4; ++s) {
      int base = level;
      if (use_segment) {
        base = filter_strength[s];
        if (!absolute_delta) base += level;
      }
      for (int i4 = 0; i4 <= 1; ++i4) {
        FilterInfo& info = fstrengths[s][i4];
        int lvl = base;
        if (use_lf_delta) {
          lvl += ref_lf_delta[0];
          if (i4) lvl += mode_lf_delta[0];
        }
        lvl = lvl < 0 ? 0 : lvl > 63 ? 63 : lvl;
        if (lvl > 0) {
          int ilevel = lvl;
          if (sharpness > 0) {
            ilevel >>= sharpness > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
          }
          if (ilevel < 1) ilevel = 1;
          info.ilevel = ilevel;
          info.limit = 2 * lvl + ilevel;
          info.hev_thresh = lvl >= 40 ? 2 : lvl >= 15 ? 1 : 0;
        } else {
          info.limit = 0;
        }
        info.inner = i4;
      }
    }
  }
  img.y.w = mb_w * 16;
  img.y.h = mb_h * 16;
  img.u.w = img.v.w = mb_w * 8;
  img.u.h = img.v.h = mb_h * 8;
  img.y.px.assign((size_t)img.y.w * img.y.h, 0);
  img.u.px.assign((size_t)img.u.w * img.u.h, 0);
  img.v.px.assign((size_t)img.v.w * img.v.h, 0);
  std::vector<uint8_t> intra_t(4 * mb_w, B_DC_PRED);
  std::vector<uint8_t> t_nz(mb_w, 0), t_nz_dc(mb_w, 0);
  std::vector<FilterInfo> finfo((size_t)mb_w * mb_h);
  std::vector<MbData> row(mb_w);
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    BoolReader& tbr = parts[mb_y & num_parts_minus_one];
    uint8_t intra_l[4];
    memset(intra_l, B_DC_PRED, 4);
    for (int mb_x = 0; mb_x < mb_w; ++mb_x)
      ParseIntraMode(row[mb_x], intra_t.data() + 4 * mb_x, intra_l);
    if (br.eof) corrupt("premature end of the VP8 first partition");
    uint8_t l_nz = 0, l_nz_dc = 0;
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      MbData& mb = row[mb_x];
      bool skip = use_skip_proba ? mb.skip : false;
      if (!skip) {
        skip = ParseResiduals(mb, t_nz[mb_x], t_nz_dc[mb_x], l_nz, l_nz_dc,
                              tbr);
      } else {
        l_nz = t_nz[mb_x] = 0;
        if (!mb.i4x4) l_nz_dc = t_nz_dc[mb_x] = 0;
        memset(mb.coeffs, 0, sizeof(mb.coeffs));
        mb.non_zero_y = mb.non_zero_uv = 0;
      }
      if (filter_type > 0) {
        FilterInfo f = fstrengths[mb.segment][mb.i4x4];
        f.inner = f.inner || !skip;
        finfo[(size_t)mb_y * mb_w + mb_x] = f;
      }
      if (tbr.eof) corrupt("premature end of a VP8 token partition");
      Reconstruct(mb, mb_x, mb_y, mb_w, img);
    }
  }
  if (filter_type == 0) return;
  // section 15: macroblocks in raster order, each: its left edge, its
  // inner vertical edges, its top edge, its inner horizontal edges
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const FilterInfo& f = finfo[(size_t)mb_y * mb_w + mb_x];
      const int limit = f.limit;
      if (limit == 0) continue;
      uint8_t* yp = img.y.at(mb_x * 16, mb_y * 16);
      const int ys = img.y.w;
      if (filter_type == 1) {
        if (mb_x > 0) SimpleEdge(yp, 1, ys, 16, limit + 4);
        if (f.inner)
          for (int k = 1; k < 4; ++k) SimpleEdge(yp + 4 * k, 1, ys, 16, limit);
        if (mb_y > 0) SimpleEdge(yp, ys, 1, 16, limit + 4);
        if (f.inner)
          for (int k = 1; k < 4; ++k)
            SimpleEdge(yp + 4 * k * ys, ys, 1, 16, limit);
        continue;
      }
      uint8_t* up = img.u.at(mb_x * 8, mb_y * 8);
      uint8_t* vp = img.v.at(mb_x * 8, mb_y * 8);
      const int us = img.u.w;
      const int il = f.ilevel, hev = f.hev_thresh;
      if (mb_x > 0) {
        NormalEdge(yp, 1, ys, 16, limit + 4, il, hev, false);
        NormalEdge(up, 1, us, 8, limit + 4, il, hev, false);
        NormalEdge(vp, 1, us, 8, limit + 4, il, hev, false);
      }
      if (f.inner) {
        for (int k = 1; k < 4; ++k)
          NormalEdge(yp + 4 * k, 1, ys, 16, limit, il, hev, true);
        NormalEdge(up + 4, 1, us, 8, limit, il, hev, true);
        NormalEdge(vp + 4, 1, us, 8, limit, il, hev, true);
      }
      if (mb_y > 0) {
        NormalEdge(yp, ys, 1, 16, limit + 4, il, hev, false);
        NormalEdge(up, us, 1, 8, limit + 4, il, hev, false);
        NormalEdge(vp, us, 1, 8, limit + 4, il, hev, false);
      }
      if (f.inner) {
        for (int k = 1; k < 4; ++k)
          NormalEdge(yp + 4 * k * ys, ys, 1, 16, limit, il, hev, true);
        NormalEdge(up + 4 * us, us, 1, 8, limit, il, hev, true);
        NormalEdge(vp + 4 * us, us, 1, 8, limit, il, hev, true);
      }
    }
  }
}

// libwebp's fixed-point BT.601 Y'CbCr -> RGB (14-bit coefficients, a
// result with 6 fractional bits clipped to 0..255)
inline int MultHi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t Clip8(int v) {
  return (v & ~16383) == 0 ? (uint8_t)(v >> 6) : v < 0 ? 0 : 255;
}
inline void YuvToBgr(int y, int u, int v, uint8_t* bgr) {
  bgr[2] = Clip8(MultHi(y, 19077) + MultHi(v, 26149) - 14234);
  bgr[1] = Clip8(MultHi(y, 19077) - MultHi(u, 6419) - MultHi(v, 13320) + 8708);
  bgr[0] = Clip8(MultHi(y, 19077) + MultHi(u, 33050) - 17685);
}

// libwebp's "fancy" upsampling of the 4:2:0 chroma: a pixel takes
// (9 near + 3 + 3 + 1 far) / 16 of its four chroma neighbours, computed as
// two rounded averages; the first and last column and row mirror.
void YuvToBgra(const Vp8Image& img, uint8_t* out, int stride) {
  const int w = img.width, h = img.height;
  const int uv_h = (h + 1) / 2;
  const int last_pair = (w - 1) >> 1;
  std::vector<int> up_u(w), up_v(w);
  // one output row's chroma, upsampled from its nearest chroma row ``n``
  // and the one beyond it, ``f``
  auto upsample = [&](const uint8_t* n, const uint8_t* f, int* dst) {
    dst[0] = (3 * n[0] + f[0] + 2) >> 2;
    for (int x = 1; x <= last_pair; ++x) {
      // pixel 2x - 1 is nearest chroma column x - 1, pixel 2x column x
      const int avg = n[x - 1] + n[x] + f[x - 1] + f[x] + 8;
      const int diag_a = (avg + 2 * (n[x] + f[x - 1])) >> 3;
      const int diag_b = (avg + 2 * (n[x - 1] + f[x])) >> 3;
      dst[2 * x - 1] = (diag_a + n[x - 1]) >> 1;
      dst[2 * x] = (diag_b + n[x]) >> 1;
    }
    if (!(w & 1)) dst[w - 1] = (3 * n[last_pair] + f[last_pair] + 2) >> 2;
  };
  for (int r = 0; r < h; ++r) {
    // the chroma row nearest to output row r and the one beyond it
    int near_row, far_row;
    if (r == 0) {
      near_row = far_row = 0;
    } else if (r & 1) {
      near_row = (r - 1) >> 1;
      far_row = std::min(near_row + 1, uv_h - 1);
    } else {
      near_row = r >> 1;
      far_row = near_row - 1;
    }
    upsample(img.u.px.data() + (size_t)near_row * img.u.w,
             img.u.px.data() + (size_t)far_row * img.u.w, up_u.data());
    upsample(img.v.px.data() + (size_t)near_row * img.v.w,
             img.v.px.data() + (size_t)far_row * img.v.w, up_v.data());
    const uint8_t* yrow = img.y.px.data() + (size_t)r * img.y.w;
    uint8_t* dst = out + (size_t)r * stride;
    for (int x = 0; x < w; ++x) YuvToBgr(yrow[x], up_u[x], up_v[x], dst + 4 * x);
  }
}

// ---------------------------------------------------------------------------
// VP8L ("WebP Lossless Bitstream Specification")

// Bits least significant first; reading past the end sets ``eos``.
struct LBitReader {
  const uint8_t* data = nullptr;
  size_t size = 0;
  size_t pos = 0;  // in bits
  bool eos = false;

  void init(const uint8_t* p, size_t n) {
    data = p;
    size = n;
    pos = 0;
    eos = false;
  }
  uint32_t peek(int n) const {  // up to 24 bits, zeros past the end
    const size_t byte = pos >> 3;
    uint32_t v = 0;
    if (byte + 4 <= size) {
      v = le32(data + byte);
    } else {
      for (int i = 0; i < 4; ++i)
        if (byte + i < size) v |= (uint32_t)data[byte + i] << (8 * i);
    }
    return (v >> (pos & 7)) & ((1u << n) - 1);
  }
  void skip(int n) {
    pos += n;
    if (pos > 8 * size) eos = true;
  }
  uint32_t read(int n) {
    if (n == 0) return 0;
    const uint32_t v = peek(n);
    skip(n);
    return v;
  }
};

// A canonical prefix code read bits first-bit-most-significant (the
// codes' bits are packed in the order they are read), decoded through a
// table of the first kRootBits bits and, for longer codes, code by code.
constexpr int kRootBits = 10;

struct PrefixCode {
  // root[bits] = symbol << 8 | length, length 0: longer than kRootBits
  std::vector<uint32_t> root;
  int single = -1;  // the symbol of a code of one symbol (zero bits)
  // canonical decoding of the longer codes: per length, the first code,
  // the number of codes and the index of its first symbol in ``sorted``
  int first_code[16] = {0}, count[16] = {0}, offset[16] = {0};
  std::vector<int> sorted;

  // returns false if the lengths do not form a complete code
  bool build(const std::vector<int>& lengths) {
    const int n = (int)lengths.size();
    int num_nonzero = 0, last = 0;
    memset(count, 0, sizeof(count));
    for (int s = 0; s < n; ++s) {
      if (lengths[s] > 15) return false;
      if (lengths[s] > 0) {
        ++count[lengths[s]];
        ++num_nonzero;
        last = s;
      }
    }
    if (num_nonzero == 0) return false;
    if (num_nonzero == 1) {
      single = last;
      root.clear();
      return true;
    }
    single = -1;
    // completeness: the Kraft sum is exactly 1
    int left = 1;
    for (int len = 1; len < 16; ++len) {
      left <<= 1;
      left -= count[len];
      if (left < 0) return false;
    }
    if (left != 0) return false;
    // canonical codes: each length's first code follows the last code of
    // the length before, shifted left
    int code = 0, idx = 0;
    for (int len = 1; len < 16; ++len) {
      code = (code + count[len - 1]) << 1;
      first_code[len] = code;
      offset[len] = idx;
      idx += count[len];
    }
    sorted.assign(num_nonzero, 0);
    int fill[16];
    memcpy(fill, offset, sizeof(fill));
    for (int s = 0; s < n; ++s)
      if (lengths[s] > 0) sorted[fill[lengths[s]]++] = s;
    root.assign(1u << kRootBits, 0);
    for (int len = 1; len <= kRootBits; ++len) {
      for (int k = 0; k < count[len]; ++k) {
        const int c = first_code[len] + k;
        // the code's bits, first read first: reverse them into the
        // least significant end
        int rev = 0;
        for (int b = 0; b < len; ++b) rev |= ((c >> (len - 1 - b)) & 1) << b;
        const uint32_t entry = (uint32_t)sorted[offset[len] + k] << 8 | len;
        for (int hi = 0; hi < (1 << (kRootBits - len)); ++hi)
          root[rev | (hi << len)] = entry;
      }
    }
    return true;
  }

  int read(LBitReader& br) const {
    if (single >= 0) return single;
    const uint32_t e = root[br.peek(kRootBits)];
    if (e & 0xff) {
      br.skip(e & 0xff);
      return (int)(e >> 8);
    }
    int code = 0;
    for (int len = 1; len < 16; ++len) {
      code |= (int)br.read(1);
      const int d = code - first_code[len];
      if (d >= 0 && d < count[len]) return sorted[offset[len] + d];
      code <<= 1;
    }
    br.eos = true;
    return 0;
  }
};

const uint8_t kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                          7, 8, 9, 10, 11, 12, 13, 14, 15};

struct HTreeGroup {
  PrefixCode codes[5];  // green + lengths + cache, red, blue, alpha, distance
};

enum { PREDICTOR = 0, CROSS_COLOR = 1, SUBTRACT_GREEN = 2, COLOR_INDEXING = 3 };

struct Transform {
  int type;
  int bits;
  int xsize;  // the width it is applied to (before colour indexing packs)
  std::vector<uint32_t> data;
};

struct Vp8lDecoder {
  LBitReader br;

  void ReadCode(int alphabet, PrefixCode& code) {
    std::vector<int> lengths(alphabet, 0);
    if (br.read(1)) {  // simple code: one or two symbols of length 1
      const int num = br.read(1) + 1;
      const int first_8bits = br.read(1);
      const int s0 = br.read(first_8bits ? 8 : 1);
      if (s0 >= alphabet) corrupt("VP8L symbol beyond its alphabet");
      lengths[s0] = 1;
      if (num == 2) {
        const int s1 = br.read(8);
        if (s1 >= alphabet) corrupt("VP8L symbol beyond its alphabet");
        lengths[s1] = 1;
      }
    } else {  // normal code: code lengths coded by a code of their own
      std::vector<int> cl_lengths(19, 0);
      const int num_codes = br.read(4) + 4;
      for (int i = 0; i < num_codes; ++i)
        cl_lengths[kCodeLengthCodeOrder[i]] = br.read(3);
      PrefixCode cl;
      if (!cl.build(cl_lengths)) corrupt("VP8L code length code invalid");
      int max_symbol = alphabet;
      if (br.read(1)) {
        const int length_nbits = 2 + 2 * br.read(3);
        max_symbol = 2 + br.read(length_nbits);
        if (max_symbol > alphabet) corrupt("VP8L max_symbol too large");
      }
      int symbol = 0, prev = 8;
      while (symbol < alphabet) {
        if (max_symbol-- == 0) break;
        if (br.eos) corrupt("truncated VP8L code lengths");
        const int len = cl.read(br);
        if (len < 16) {
          lengths[symbol++] = len;
          if (len != 0) prev = len;
        } else {
          static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
          const int slot = len - 16;
          int repeat = br.read(kExtra[slot]) + kOffset[slot];
          if (symbol + repeat > alphabet) corrupt("VP8L code length repeat");
          const int v = len == 16 ? prev : 0;
          while (repeat-- > 0) lengths[symbol++] = v;
        }
      }
    }
    if (br.eos) corrupt("truncated VP8L prefix code");
    if (!code.build(lengths)) corrupt("VP8L prefix code not complete");
  }

  static int CopyValue(int symbol, LBitReader& br) {
    // prefix coding of lengths and distances
    if (symbol < 4) return symbol + 1;
    const int extra = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra;
    return offset + (int)br.read(extra) + 1;
  }

  static int PlaneCodeToDistance(int xsize, int plane_code) {
    if (plane_code > 120) return plane_code - 120;
    const int dist_code = kCodeToPlane[plane_code - 1];
    const int yoffset = dist_code >> 4;
    const int xoffset = 8 - (dist_code & 0xf);
    const int dist = yoffset * xsize + xoffset;
    return dist >= 1 ? dist : 1;
  }

  // An entropy-coded image of xsize x ysize ARGB pixels; ``level0``: the
  // main image (meta prefix codes allowed).
  std::vector<uint32_t> DecodeImageStream(int xsize, int ysize, bool level0) {
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = br.read(4);
      if (cache_bits < 1 || cache_bits > 11) corrupt("VP8L colour cache bits");
    }
    int huff_bits = 0;
    std::vector<uint32_t> huff_image;
    int num_groups = 1;
    if (level0 && br.read(1)) {
      huff_bits = br.read(3) + 2;
      const int hx = (xsize + (1 << huff_bits) - 1) >> huff_bits;
      const int hy = (ysize + (1 << huff_bits) - 1) >> huff_bits;
      huff_image = DecodeImageStream(hx, hy, false);
      for (uint32_t& v : huff_image) {
        v = (v >> 8) & 0xffff;
        num_groups = std::max(num_groups, (int)v + 1);
      }
    }
    if (br.eos) corrupt("truncated VP8L image header");
    const int cache_size = cache_bits ? 1 << cache_bits : 0;
    std::vector<HTreeGroup> groups(num_groups);
    for (HTreeGroup& g : groups) {
      ReadCode(256 + 24 + cache_size, g.codes[0]);
      ReadCode(256, g.codes[1]);
      ReadCode(256, g.codes[2]);
      ReadCode(256, g.codes[3]);
      ReadCode(40, g.codes[4]);
    }
    std::vector<uint32_t> cache(cache_size, 0);
    std::vector<uint32_t> px((size_t)xsize * ysize);
    const size_t total = px.size();
    const int hx = huff_bits ? (xsize + (1 << huff_bits) - 1) >> huff_bits : 0;
    size_t pos = 0, cached = 0;
    int col = 0, row = 0;
    auto group_at = [&](int c, int r) -> const HTreeGroup& {
      if (!huff_bits) return groups[0];
      return groups[huff_image[(size_t)(r >> huff_bits) * hx + (c >> huff_bits)]];
    };
    auto flush_cache = [&]() {
      if (!cache_size) return;
      for (; cached < pos; ++cached)
        cache[(0x1e35a7bdu * px[cached]) >> (32 - cache_bits)] = px[cached];
    };
    while (pos < total) {
      const HTreeGroup& g = group_at(col, row);
      const int code = g.codes[0].read(br);
      if (code < 256) {
        const uint32_t red = g.codes[1].read(br);
        const uint32_t blue = g.codes[2].read(br);
        const uint32_t alpha = g.codes[3].read(br);
        px[pos++] = (alpha << 24) | (red << 16) | ((uint32_t)code << 8) | blue;
        if (++col >= xsize) {
          col = 0;
          ++row;
        }
      } else if (code < 256 + 24) {
        const int length = CopyValue(code - 256, br);
        const int dist_symbol = g.codes[4].read(br);
        const int dist_code = CopyValue(dist_symbol, br);
        const size_t dist = PlaneCodeToDistance(xsize, dist_code);
        if (dist > pos || total - pos < (size_t)length)
          corrupt("VP8L backward reference out of the image");
        for (int i = 0; i < length; ++i, ++pos) px[pos] = px[pos - dist];
        col += length;
        while (col >= xsize) {
          col -= xsize;
          ++row;
        }
      } else {
        const int key = code - 280;
        if (key >= cache_size) corrupt("VP8L colour cache key");
        flush_cache();
        px[pos++] = cache[key];
        if (++col >= xsize) {
          col = 0;
          ++row;
        }
      }
      if (br.eos) corrupt("truncated VP8L image data");
    }
    return px;
  }

  std::vector<uint32_t> DecodeImage(int xsize, int ysize) {
    std::vector<Transform> transforms;
    int width = xsize;
    uint32_t seen = 0;
    while (br.read(1)) {
      Transform t;
      t.type = br.read(2);
      if (seen & (1u << t.type)) corrupt("VP8L transform used twice");
      seen |= 1u << t.type;
      t.xsize = width;
      t.bits = 0;
      if (t.type == PREDICTOR || t.type == CROSS_COLOR) {
        t.bits = br.read(3) + 2;
        t.data = DecodeImageStream((width + (1 << t.bits) - 1) >> t.bits,
                                   (ysize + (1 << t.bits) - 1) >> t.bits,
                                   false);
      } else if (t.type == COLOR_INDEXING) {
        const int num_colors = br.read(8) + 1;
        t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
        std::vector<uint32_t> pal = DecodeImageStream(num_colors, 1, false);
        // the palette is delta-coded, channel by channel
        t.data.assign((size_t)1 << (8 >> t.bits), 0);
        uint32_t prev = 0;
        for (int i = 0; i < num_colors; ++i) {
          uint32_t c = pal[i], out = 0;
          for (int s = 0; s < 32; s += 8)
            out |= (((c >> s) + (prev >> s)) & 0xff) << s;
          t.data[i] = prev = out;
        }
        width = (width + (1 << t.bits) - 1) >> t.bits;
      }
      if (br.eos) corrupt("truncated VP8L transform");
      transforms.push_back(std::move(t));
    }
    std::vector<uint32_t> px = DecodeImageStream(width, ysize, true);
    for (int k = (int)transforms.size() - 1; k >= 0; --k)
      px = Inverse(transforms[k], px, ysize);
    return px;
  }

  static uint32_t Average2(uint32_t a, uint32_t b) {
    return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
  }
  static int Sub3(int a, int b, int c) {
    return std::abs(b - c) - std::abs(a - c);
  }
  static uint32_t Select(uint32_t a, uint32_t b, uint32_t c) {
    int d = 0;
    for (int s = 0; s < 32; s += 8)
      d += Sub3((a >> s) & 0xff, (b >> s) & 0xff, (c >> s) & 0xff);
    return d <= 0 ? a : b;
  }
  static uint32_t ClampFull(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8)
      out |= (uint32_t)clip255((int)((a >> s) & 0xff) + (int)((b >> s) & 0xff) -
                               (int)((c >> s) & 0xff)) << s;
    return out;
  }
  static uint32_t ClampHalf(uint32_t a, uint32_t b) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
      const int x = (a >> s) & 0xff, y = (b >> s) & 0xff;
      out |= (uint32_t)clip255(x + (x - y) / 2) << s;
    }
    return out;
  }
  static uint32_t AddPixels(uint32_t a, uint32_t b) {
    const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
    const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
    return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
  }
  static uint32_t Predict(int mode, const uint32_t* cur, const uint32_t* top) {
    // cur points at the pixel, top at the pixel above (rows contiguous,
    // so the right neighbour above the last column is the row's first)
    const uint32_t L = cur[-1], T = top[0], TR = top[1], TL = top[-1];
    switch (mode) {
      case 1: return L;
      case 2: return T;
      case 3: return TR;
      case 4: return TL;
      case 5: return Average2(Average2(L, TR), T);
      case 6: return Average2(L, TL);
      case 7: return Average2(L, T);
      case 8: return Average2(TL, T);
      case 9: return Average2(T, TR);
      case 10: return Average2(Average2(L, TL), Average2(T, TR));
      case 11: return Select(T, L, TL);
      case 12: return ClampFull(L, T, TL);
      case 13: return ClampHalf(Average2(L, T), TL);
      default: return 0xff000000u;
    }
  }

  static std::vector<uint32_t> Inverse(const Transform& t,
                                       std::vector<uint32_t>& in, int ysize) {
    const int w = t.xsize;
    if (t.type == SUBTRACT_GREEN) {
      for (uint32_t& p : in) {
        const uint32_t g = (p >> 8) & 0xff;
        const uint32_t rb = ((p & 0x00ff00ffu) + (g << 16 | g)) & 0x00ff00ffu;
        p = (p & 0xff00ff00u) | rb;
      }
      return std::move(in);
    }
    if (t.type == PREDICTOR) {
      const int tiles = (w + (1 << t.bits) - 1) >> t.bits;
      std::vector<uint32_t>& px = in;
      px[0] = AddPixels(px[0], 0xff000000u);
      for (int x = 1; x < w; ++x) px[x] = AddPixels(px[x], px[x - 1]);
      for (int y = 1; y < ysize; ++y) {
        uint32_t* row = px.data() + (size_t)y * w;
        const uint32_t* mrow = t.data.data() + (size_t)(y >> t.bits) * tiles;
        row[0] = AddPixels(row[0], row[-w]);
        for (int x = 1; x < w; ++x) {
          const int mode = (mrow[x >> t.bits] >> 8) & 0xf;
          row[x] = AddPixels(row[x], Predict(mode, row + x, row + x - w));
        }
      }
      return std::move(in);
    }
    if (t.type == CROSS_COLOR) {
      const int tiles = (w + (1 << t.bits) - 1) >> t.bits;
      for (int y = 0; y < ysize; ++y) {
        uint32_t* row = in.data() + (size_t)y * w;
        const uint32_t* mrow = t.data.data() + (size_t)(y >> t.bits) * tiles;
        for (int x = 0; x < w; ++x) {
          const uint32_t m = mrow[x >> t.bits];
          const int8_t g2r = (int8_t)(m & 0xff), g2b = (int8_t)((m >> 8) & 0xff);
          const int8_t r2b = (int8_t)((m >> 16) & 0xff);
          const uint32_t argb = row[x];
          const int8_t green = (int8_t)(argb >> 8);
          int new_red = (argb >> 16) & 0xff;
          int new_blue = argb & 0xff;
          new_red += ((int)g2r * green) >> 5;
          new_red &= 0xff;
          new_blue += ((int)g2b * green) >> 5;
          new_blue += ((int)r2b * (int8_t)new_red) >> 5;
          new_blue &= 0xff;
          row[x] = (argb & 0xff00ff00u) | ((uint32_t)new_red << 16) | new_blue;
        }
      }
      return std::move(in);
    }
    // colour indexing: the green of each packed pixel holds 1, 2, 4 or 8
    // indices, the first in the least significant bits
    const int packed_w = (w + (1 << t.bits) - 1) >> t.bits;
    const int bpp = 8 >> t.bits;
    const uint32_t mask = (1u << bpp) - 1;
    std::vector<uint32_t> out((size_t)w * ysize);
    for (int y = 0; y < ysize; ++y) {
      const uint32_t* src = in.data() + (size_t)y * packed_w;
      uint32_t* dst = out.data() + (size_t)y * w;
      for (int x = 0; x < w; ++x) {
        const uint32_t g = (src[x >> t.bits] >> 8) & 0xff;
        const uint32_t idx = (g >> ((x & ((1 << t.bits) - 1)) * bpp)) & mask;
        dst[x] = idx < t.data.size() ? t.data[idx] : 0;
      }
    }
    return out;
  }
};

// ---------------------------------------------------------------------------
// The container ("WebP Container Specification")

struct Chunk {
  uint32_t tag;
  const uint8_t* data;
  size_t size;
};

constexpr uint32_t Tag(const char* s) {
  return (uint32_t)(uint8_t)s[0] | ((uint32_t)(uint8_t)s[1] << 8) |
         ((uint32_t)(uint8_t)s[2] << 16) | ((uint32_t)(uint8_t)s[3] << 24);
}

// The chunks of [data, data + size), each padded to an even size.
std::vector<Chunk> ReadChunks(const uint8_t* data, size_t size) {
  std::vector<Chunk> out;
  size_t pos = 0;
  while (pos + 8 <= size) {
    const uint32_t len = le32(data + pos + 4);
    if (len > size - pos - 8) corrupt("WebP chunk past the end of the file");
    out.push_back({le32(data + pos), data + pos + 8, len});
    pos += 8 + len + (len & 1);
  }
  return out;
}

struct Features {
  int width = 0, height = 0;  // the canvas
  bool has_alpha = false, animated = false;
  const uint8_t* exif = nullptr;
  size_t exif_size = 0;
  // the still image (or the first frame of an animation): its bitstream,
  // ALPH chunk, offset and size on the canvas
  Chunk image{0, nullptr, 0}, alpha{0, nullptr, 0};
  int x0 = 0, y0 = 0, fw = 0, fh = 0;
};

void VP8Size(const Chunk& c, int* w, int* h) {
  if (c.tag == Tag("VP8 ")) {
    if (c.size < 10) corrupt("truncated VP8 chunk");
    *w = le16(c.data + 6) & 0x3fff;
    *h = le16(c.data + 8) & 0x3fff;
  } else {
    if (c.size < 5 || c.data[0] != 0x2f) corrupt("VP8L signature missing");
    const uint32_t bits = le32(c.data + 1);
    *w = (bits & 0x3fff) + 1;
    *h = ((bits >> 14) & 0x3fff) + 1;
  }
}

// The image of a run of chunks: an optional ALPH before 'VP8 ', or 'VP8L'.
void FindImage(const std::vector<Chunk>& chunks, size_t from, Features& f) {
  for (size_t i = from; i < chunks.size(); ++i) {
    const Chunk& c = chunks[i];
    if (c.tag == Tag("ALPH") && !f.alpha.data) f.alpha = c;
    if (c.tag == Tag("VP8 ") || c.tag == Tag("VP8L")) {
      f.image = c;
      if (c.tag == Tag("VP8L")) f.alpha = Chunk{0, nullptr, 0};
      VP8Size(c, &f.fw, &f.fh);
      return;
    }
  }
  corrupt("WebP without an image chunk");
}

Features Parse(const uint8_t* data, size_t size) {
  if (size < 12 || memcmp(data, "RIFF", 4) || memcmp(data + 8, "WEBP", 4))
    corrupt("not a RIFF WebP file");
  const uint32_t riff = le32(data + 4);
  if (riff < 12) corrupt("RIFF size too small");
  if (riff > size - 8) corrupt("truncated WebP file");
  const std::vector<Chunk> chunks = ReadChunks(data + 12, riff - 4);
  if (chunks.empty()) corrupt("WebP without chunks");
  Features f;
  const Chunk& first = chunks[0];
  if (first.tag == Tag("VP8X")) {
    if (first.size < 10) corrupt("VP8X chunk too small");
    const uint32_t flags = le32(first.data);
    f.width = (int)le24(first.data + 4) + 1;
    f.height = (int)le24(first.data + 7) + 1;
    f.has_alpha = flags & 0x10;
    f.animated = flags & 0x02;
    for (const Chunk& c : chunks)
      if (c.tag == Tag("EXIF") && !f.exif) {
        f.exif = c.data;
        f.exif_size = c.size;
      }
    if (f.animated) {
      // WebPAnimDecoder's first frame: decoded into a transparent canvas
      for (const Chunk& c : chunks) {
        if (c.tag != Tag("ANMF")) continue;
        if (c.size < 16) corrupt("ANMF chunk too small");
        f.x0 = 2 * (int)le24(c.data);
        f.y0 = 2 * (int)le24(c.data + 3);
        const int fw = (int)le24(c.data + 6) + 1, fh = (int)le24(c.data + 9) + 1;
        const std::vector<Chunk> sub = ReadChunks(c.data + 16, c.size - 16);
        FindImage(sub, 0, f);
        if (f.fw != fw || f.fh != fh) corrupt("ANMF frame size mismatch");
        if (f.x0 + fw > f.width || f.y0 + fh > f.height)
          corrupt("ANMF frame outside the canvas");
        return f;
      }
      corrupt("animated WebP without a frame");
    }
    FindImage(chunks, 1, f);
    if (f.fw != f.width || f.fh != f.height)
      corrupt("VP8X canvas and image sizes differ");
    f.has_alpha = f.has_alpha || f.alpha.data;
  } else {
    FindImage(chunks, 0, f);
    if (f.image.tag == Tag("VP8L"))
      f.has_alpha = (le32(f.image.data + 1) >> 28) & 1;
    f.width = f.fw;
    f.height = f.fh;
  }
  return f;
}

// The 'ALPH' chunk: raw or lossless-coded alpha, then the inverse of its
// filter, row by row (the first pixel of a row below the first predicted
// from the pixel above).
std::vector<uint8_t> DecodeAlpha(const Chunk& c, int w, int h) {
  if (c.size < 1) corrupt("empty ALPH chunk");
  const int method = c.data[0] & 3, filter = (c.data[0] >> 2) & 3;
  const int pre = (c.data[0] >> 4) & 3, rsrv = c.data[0] >> 6;
  if (method > 1 || pre > 1 || rsrv != 0) corrupt("ALPH header invalid");
  std::vector<uint8_t> a((size_t)w * h);
  if (method == 0) {
    if (c.size - 1 < a.size()) corrupt("truncated raw alpha");
    memcpy(a.data(), c.data + 1, a.size());
  } else {
    Vp8lDecoder d;
    d.br.init(c.data + 1, c.size - 1);
    const std::vector<uint32_t> argb = d.DecodeImage(w, h);
    for (size_t i = 0; i < a.size(); ++i) a[i] = (argb[i] >> 8) & 0xff;
  }
  if (filter == 0) return a;
  for (int y = 0; y < h; ++y) {
    uint8_t* row = a.data() + (size_t)y * w;
    const uint8_t* prev = y > 0 ? row - w : nullptr;
    if (!prev || filter == 1) {
      uint8_t pred = prev ? prev[0] : 0;
      for (int x = 0; x < w; ++x) pred = row[x] = (uint8_t)(pred + row[x]);
    } else if (filter == 2) {
      for (int x = 0; x < w; ++x) row[x] = (uint8_t)(prev[x] + row[x]);
    } else {
      int left = prev[0], top_left = prev[0];
      for (int x = 0; x < w; ++x) {
        const int top = prev[x];
        left = (uint8_t)(row[x] + clip255(left + top - top_left));
        top_left = top;
        row[x] = (uint8_t)left;
      }
    }
  }
  return a;
}

// The frame as BGRA into ``out`` (row stride ``stride`` bytes).
void DecodeFrame(const Features& f, uint8_t* out, int stride) {
  const int w = f.fw, h = f.fh;
  if (f.image.tag == Tag("VP8L")) {
    Vp8lDecoder d;
    d.br.init(f.image.data + 5, f.image.size - 5);
    const uint32_t bits = le32(f.image.data + 1);
    if ((bits >> 29) != 0) corrupt("VP8L version not 0");
    const std::vector<uint32_t> argb = d.DecodeImage(w, h);
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const uint32_t p = argb[(size_t)y * w + x];
        uint8_t* o = out + (size_t)y * stride + 4 * x;
        o[0] = p & 0xff;
        o[1] = (p >> 8) & 0xff;
        o[2] = (p >> 16) & 0xff;
        o[3] = p >> 24;
      }
    return;
  }
  Vp8Decoder dec;
  Vp8Image img;
  dec.Decode(f.image.data, f.image.size, img);
  if (img.width != w || img.height != h) corrupt("VP8 size mismatch");
  YuvToBgra(img, out, stride);
  if (f.alpha.data) {
    const std::vector<uint8_t> a = DecodeAlpha(f.alpha, w, h);
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x)
        out[(size_t)y * stride + 4 * x + 3] = a[(size_t)y * w + x];
  } else {
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) out[(size_t)y * stride + 4 * x + 3] = 255;
  }
}

int Report(const Failure& e, char* msg, int msglen) {
  if (msg && msglen > 0) {
    strncpy(msg, e.msg.c_str(), msglen - 1);
    msg[msglen - 1] = 0;
  }
  return e.code;
}

}  // namespace

extern "C" {

int hcmvs_webp_info(const uint8_t* data, int64_t size, int64_t* info,
                    char* msg, int msglen) {
  try {
    const Features f = Parse(data, (size_t)size);
    info[0] = f.width;
    info[1] = f.height;
    info[2] = f.has_alpha;
    info[3] = f.animated;
    info[4] = f.exif ? f.exif - data : 0;
    info[5] = f.exif_size;
    return 0;
  } catch (const Failure& e) {
    return Report(e, msg, msglen);
  } catch (const std::bad_alloc&) {
    return Report(Failure{2, "WebP too large to decode"}, msg, msglen);
  }
}

int hcmvs_webp_decode(const uint8_t* data, int64_t size, int32_t channels,
                      uint8_t* out, int64_t out_size, char* msg, int msglen) {
  try {
    const Features f = Parse(data, (size_t)size);
    const size_t n = (size_t)f.width * f.height;
    if ((channels != 1 && channels != 3 && channels != 4) ||
        out_size != (int64_t)(n * channels))
      corrupt("output buffer of the wrong size");
    std::vector<uint8_t> canvas;
    uint8_t* bgra = out;
    if (channels != 4) {
      canvas.resize(4 * n);
      bgra = canvas.data();
    }
    memset(bgra, 0, 4 * n);
    const int stride = 4 * f.width;
    DecodeFrame(f, bgra + (size_t)f.y0 * stride + 4 * f.x0, stride);
    if (channels == 3) {
      for (size_t i = 0; i < n; ++i) memcpy(out + 3 * i, bgra + 4 * i, 3);
    } else if (channels == 1) {
      // cvtColor's BGR2GRAY on 8-bit samples: B, G, R weights scaled by
      // 2**15, rounded
      for (size_t i = 0; i < n; ++i) {
        const uint8_t* p = bgra + 4 * i;
        out[i] = (uint8_t)((p[0] * 3735 + p[1] * 19235 + p[2] * 9798 +
                            (1 << 14)) >> 15);
      }
    }
    return 0;
  } catch (const Failure& e) {
    return Report(e, msg, msglen);
  } catch (const std::bad_alloc&) {
    return Report(Failure{2, "WebP too large to decode"}, msg, msglen);
  }
}

}  // extern "C"
