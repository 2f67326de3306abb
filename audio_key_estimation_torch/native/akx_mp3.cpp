// akx_mp3 — MPEG Layer III decoder (C++ fast path).
//
// The reference ingests mp3 through torchaudio's C++ decoders
// (reference KeyDataset.py:341); 8 of its 14 corpora are mp3. This is the
// native-speed implementation of the same decoder specified executably in
// data/mp3.py — both are validated against an independent decoder
// (libavcodec via tests/av_oracle.py) by the differential suites in
// tests/test_mp3.py + test_mp3_lsf.py, and against each other. Math in
// double, PCM out in float32, channel 0 (what the pipeline consumes).
//
// Scope: MPEG-1 Layer III (32/44.1/48 kHz, mono/stereo, all block types,
// MS + intensity stereo, scfsi, the bit reservoir, all Huffman tables,
// the oracle's escape-value requantizer clamp — see
// data/mp3.py::_escape_clamp for the witnessed rule) plus the MPEG-2 /
// MPEG-2.5 lower-sampling-frequency profile (8-24 kHz, 576-sample
// single-granule frames, 9-bit scalefac_compress partitions, io-based
// intensity stereo, the oracle-pinned 8 kHz mixed-block geometry).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "akx_decoded.h"
#include "akx_mp3_tables.h"

namespace akx {
namespace {

using akx_mp3::HuffRow;
using akx_mp3::QuadRow;

constexpr double kPi = 3.14159265358979323846;
constexpr double kImdctScalar = 1.759;  // oracle escape-clamp reference

const int kSrTable[3] = {44100, 48000, 32000};
const int kBitrateTable[15] = {0,   32,  40,  48,  56,  64,  80, 96,
                               112, 128, 160, 192, 224, 256, 320};

// ---------------------------------------------------------------- bits

struct Bits {
  const uint8_t* data;
  size_t len;     // bytes
  size_t pos;     // bits

  int get1() {
    size_t byte = pos >> 3;
    int v = byte < len ? (data[byte] >> (7 - (pos & 7))) & 1 : 0;
    ++pos;
    return v;
  }
  int get(int n) {
    int v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | get1();
    return v;
  }
};

// ---------------------------------------------------------------- huffman

// flat binary decode tree: node = pair of child slots; child >= 0 is a
// node index, child < 0 is ~row_index (leaf)
struct Tree {
  std::vector<int32_t> nodes;  // 2 slots per node
  int max_len = 0;

  template <typename Row>
  void build(const Row* rows, int n) {
    nodes.assign(2, INT32_MIN);
    for (int r = 0; r < n; ++r) {
      int hlen = rows[r].hlen, hcod = rows[r].hcod;
      if (hlen > max_len) max_len = hlen;
      int node = 0;
      for (int b = hlen - 1; b >= 0; --b) {
        size_t si = 2 * node + ((hcod >> b) & 1);
        if (b == 0) {
          nodes[si] = ~r;
        } else {
          if (nodes[si] == INT32_MIN) {
            int32_t child = (int32_t)(nodes.size() / 2);
            nodes.push_back(INT32_MIN);  // may reallocate: index, not ref
            nodes.push_back(INT32_MIN);
            nodes[si] = child;
          }
          node = nodes[si];
        }
      }
    }
  }
  // returns row index, or -1 on invalid code
  int read(Bits* bits) const {
    int node = 0;
    for (int depth = 0; depth < max_len; ++depth) {
      int32_t slot = nodes[2 * node + bits->get1()];
      if (slot < 0) return slot == INT32_MIN ? -1 : ~slot;
      node = slot;
    }
    return -1;
  }
};

struct Trees {
  Tree big[32];
  Tree c1[2];
  Trees() {
    for (int t = 0; t < 32; ++t)
      if (akx_mp3::kHuffTables[t].rows)
        big[t].build(akx_mp3::kHuffTables[t].rows, akx_mp3::kHuffTables[t].n);
    c1[0].build(akx_mp3::kCount1A, akx_mp3::kCount1An);
    c1[1].build(akx_mp3::kCount1B, akx_mp3::kCount1Bn);
  }
};

const Trees& trees() {
  static const Trees t;  // thread-safe static init
  return t;
}

// ------------------------------------------------------------ precomputed

struct Tables {
  double win[4][36];   // imdct windows by block type (2 = 12-pt short win)
  double i36[36][18];  // 36-point IMDCT basis
  double i12[12][6];   // 12-point IMDCT basis
  double n64[64][32];  // synthesis matrixing
  double cs[8], ca[8];
  Tables() {
    for (int i = 0; i < 36; ++i) win[0][i] = std::sin(kPi / 36 * (i + 0.5));
    for (int i = 0; i < 36; ++i) win[1][i] = win[0][i];
    for (int i = 18; i < 24; ++i) win[1][i] = 1.0;
    for (int i = 24; i < 30; ++i)
      win[1][i] = std::sin(kPi / 12 * (i - 18 + 0.5));
    for (int i = 30; i < 36; ++i) win[1][i] = 0.0;
    for (int i = 0; i < 36; ++i) win[3][i] = win[0][i];
    for (int i = 0; i < 6; ++i) win[3][i] = 0.0;
    for (int i = 6; i < 12; ++i) win[3][i] = std::sin(kPi / 12 * (i - 6 + 0.5));
    for (int i = 12; i < 18; ++i) win[3][i] = 1.0;
    for (int i = 0; i < 12; ++i) win[2][i] = std::sin(kPi / 12 * (i + 0.5));
    for (int i = 12; i < 36; ++i) win[2][i] = 0.0;
    for (int i = 0; i < 36; ++i)
      for (int k = 0; k < 18; ++k)
        i36[i][k] = std::cos(kPi / 72 * (2 * i + 1 + 18) * (2 * k + 1));
    for (int i = 0; i < 12; ++i)
      for (int k = 0; k < 6; ++k)
        i12[i][k] = std::cos(kPi / 24 * (2 * i + 1 + 6) * (2 * k + 1));
    for (int i = 0; i < 64; ++i)
      for (int k = 0; k < 32; ++k)
        n64[i][k] = std::cos(kPi / 64 * (16 + i) * (2 * k + 1));
    const double ci[8] = {-0.6,    -0.535,  -0.33,   -0.185,
                          -0.095,  -0.041,  -0.0142, -0.0037};
    for (int j = 0; j < 8; ++j) {
      cs[j] = 1.0 / std::sqrt(1.0 + ci[j] * ci[j]);
      ca[j] = ci[j] * cs[j];
    }
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

// ---------------------------------------------------------------- header

struct Header {
  int sr = 0, bitrate = 0, padding = 0;
  int mode = 0, mode_ext = 0, nch = 0, frame_bytes = 0;
  int samples = 1152;  // 576 for LSF (one granule)
  bool crc = false;
  bool lsf = false;  // MPEG-2 (v=2) / MPEG-2.5 (v=0): 13818-3 LSF profile
  const int16_t* band_l = nullptr;  // scalefactor band boundaries
  const int16_t* band_s = nullptr;

  bool parse(const uint8_t* b, size_t len, size_t off) {
    if (off + 4 > len) return false;
    uint32_t h = ((uint32_t)b[off] << 24) | ((uint32_t)b[off + 1] << 16) |
                 ((uint32_t)b[off + 2] << 8) | b[off + 3];
    if (((h >> 21) & 0x7FF) != 0x7FF) return false;
    int version = (h >> 19) & 3;
    int layer = (h >> 17) & 3;
    if (layer != 1) return false;  // not Layer III
    if (version == 1) return false;  // reserved version bits
    lsf = version != 3;
    crc = ((h >> 16) & 1) == 0;
    int bi = (h >> 12) & 0xF;
    int si = (h >> 10) & 3;
    if (bi == 0 || bi == 15 || si == 3) return false;
    if (lsf) {
      bitrate = akx_mp3::kBitrateLsf[bi];
      int idx = (version == 2 ? 0 : 3) + si;  // V2: 22050/24000/16000
      sr = akx_mp3::kLsfRates[idx];
      band_l = akx_mp3::kSfbLongLsf[idx];
      band_s = akx_mp3::kSfbShortLsf[idx];
      samples = 576;
    } else {
      bitrate = kBitrateTable[bi];
      sr = kSrTable[si];
      band_l = akx_mp3::kSfbLong[si];
      band_s = akx_mp3::kSfbShort[si];
      samples = 1152;
    }
    padding = (h >> 9) & 1;
    mode = (h >> 6) & 3;
    mode_ext = (h >> 4) & 3;
    nch = mode == 3 ? 1 : 2;
    frame_bytes = (samples / 8) * bitrate * 1000 / sr + padding;
    return true;
  }
};

// -------------------------------------------------------------- side info

struct Granule {
  int part2_3_length, big_values, global_gain, scalefac_compress;
  bool window_switching, mixed_block;
  bool lsf = false;
  int block_type, table_select[3], subblock_gain[3];
  int region0_count, region1_count;
  int preflag, scalefac_scale, count1table_select;
  int scalefac_l[22];
  int scalefac_s[13][3];

  bool is_short() const { return window_switching && block_type == 2; }
  // mixed-block long region: 8 long sfb (MPEG-1) / 6 (LSF). band_l of
  // that count is ALSO the reorder/intensity boundary at every rate
  // (36 lines; 72 at MPEG-2.5 8 kHz) — oracle-pinned per stage, see
  // data/mp3.py::_MixedGeo. The imdct long region (2 subbands) and the
  // single alias butterfly below are constants at EVERY rate.
  int mixed_long_end() const { return lsf ? 6 : 8; }
};

// MPEG-1: 9-bit main_data_begin, scfsi, TWO granules, 4-bit
// scalefac_compress, explicit preflag. LSF (ISO 13818-3 2.4.1.7): 8-bit
// main_data_begin, no scfsi, ONE granule, 9-bit scalefac_compress, no
// preflag bit (implied by the scalefac_compress range).
bool read_side_info(Bits* bits, int nch, bool lsf, int* main_data_begin,
                    int scfsi[2][4], Granule g[2][2], std::string* err) {
  *main_data_begin = bits->get(lsf ? 8 : 9);
  if (lsf) {
    bits->get(nch == 1 ? 1 : 2);
    for (int ch = 0; ch < 2; ++ch)
      for (int i = 0; i < 4; ++i) scfsi[ch][i] = 0;
  } else {
    bits->get(nch == 1 ? 5 : 3);
    for (int ch = 0; ch < nch; ++ch)
      for (int i = 0; i < 4; ++i) scfsi[ch][i] = bits->get1();
  }
  for (int gr = 0; gr < (lsf ? 1 : 2); ++gr) {
    for (int ch = 0; ch < nch; ++ch) {
      Granule& x = g[gr][ch];
      x.lsf = lsf;
      x.part2_3_length = bits->get(12);
      x.big_values = bits->get(9);
      x.global_gain = bits->get(8);
      x.scalefac_compress = bits->get(lsf ? 9 : 4);
      x.window_switching = bits->get1() != 0;
      if (x.window_switching) {
        x.block_type = bits->get(2);
        x.mixed_block = bits->get1() != 0;
        x.table_select[0] = bits->get(5);
        x.table_select[1] = bits->get(5);
        x.table_select[2] = 0;
        for (int w = 0; w < 3; ++w) x.subblock_gain[w] = bits->get(3);
        // ISO 2.4.2.7 fixed region split for switched blocks
        x.region0_count = (x.block_type == 2 && !x.mixed_block) ? 8 : 7;
        x.region1_count = 20 - x.region0_count;
        if (x.block_type == 0) {
          *err = "window_switching with block_type 0";
          return false;
        }
      } else {
        x.block_type = 0;
        x.mixed_block = false;
        for (int r = 0; r < 3; ++r) x.table_select[r] = bits->get(5);
        for (int w = 0; w < 3; ++w) x.subblock_gain[w] = 0;
        x.region0_count = bits->get(4);
        x.region1_count = bits->get(3);
      }
      x.preflag = lsf ? 0 : bits->get1();
      x.scalefac_scale = bits->get1();
      x.count1table_select = bits->get1();
    }
  }
  return true;
}

// ------------------------------------------------------------ scalefactors

// fills g->scalefac_l / scalefac_s; returns part2 bits consumed
int read_scalefactors(Bits* bits, Granule* g, int gr, const int scfsi[4],
                      const Granule* prev) {
  int s1 = akx_mp3::kSlen[g->scalefac_compress][0];
  int s2 = akx_mp3::kSlen[g->scalefac_compress][1];
  size_t start = bits->pos;
  std::memset(g->scalefac_l, 0, sizeof(g->scalefac_l));
  std::memset(g->scalefac_s, 0, sizeof(g->scalefac_s));
  if (g->is_short()) {
    if (g->mixed_block) {
      for (int sfb = 0; sfb < 8; ++sfb) g->scalefac_l[sfb] = bits->get(s1);
      for (int sfb = 3; sfb < 6; ++sfb)
        for (int w = 0; w < 3; ++w) g->scalefac_s[sfb][w] = bits->get(s1);
      for (int sfb = 6; sfb < 12; ++sfb)
        for (int w = 0; w < 3; ++w) g->scalefac_s[sfb][w] = bits->get(s2);
    } else {
      for (int sfb = 0; sfb < 6; ++sfb)
        for (int w = 0; w < 3; ++w) g->scalefac_s[sfb][w] = bits->get(s1);
      for (int sfb = 6; sfb < 12; ++sfb)
        for (int w = 0; w < 3; ++w) g->scalefac_s[sfb][w] = bits->get(s2);
    }
  } else {
    const int bands[4][3] = {{0, 6, s1}, {6, 11, s1}, {11, 16, s2},
                             {16, 21, s2}};
    for (int grp = 0; grp < 4; ++grp) {
      int lo = bands[grp][0], hi = bands[grp][1], sl = bands[grp][2];
      if (gr == 1 && scfsi[grp] && prev != nullptr) {
        for (int sfb = lo; sfb < hi; ++sfb)
          g->scalefac_l[sfb] = prev->scalefac_l[sfb];
      } else {
        for (int sfb = lo; sfb < hi; ++sfb) g->scalefac_l[sfb] = bits->get(sl);
      }
    }
  }
  return (int)(bits->pos - start);
}

// (slens[4], nsfb[4], preflag) for one LSF granule-channel; mirrors
// data/_mp3_tables_lsf.py::lsf_scalefactor_layout (ISO 13818-3 2.4.3.4)
bool lsf_scalefactor_layout(int sfc, bool intensity_ch, bool short_,
                            bool mixed, int slens[4], const int8_t** nsfb,
                            int* preflag) {
  int cls = (short_ && mixed) ? 2 : (short_ ? 1 : 0);
  int blk;
  *preflag = 0;
  if (intensity_ch) {
    int isc = sfc >> 1;
    if (isc < 180) {
      slens[0] = isc / 36; slens[1] = (isc % 36) / 6;
      slens[2] = isc % 6; slens[3] = 0;
      blk = 3;
    } else if (isc < 244) {
      int i = isc - 180;
      slens[0] = i >> 4; slens[1] = (i >> 2) & 3;
      slens[2] = i & 3; slens[3] = 0;
      blk = 4;
    } else if (isc < 255) {
      int i = isc - 244;
      slens[0] = i / 3; slens[1] = i % 3;
      slens[2] = 0; slens[3] = 0;
      blk = 5;
    } else {
      return false;  // out of range
    }
  } else {
    if (sfc < 400) {
      slens[0] = (sfc >> 4) / 5; slens[1] = (sfc >> 4) % 5;
      slens[2] = (sfc % 16) >> 2; slens[3] = sfc & 3;
      blk = 0;
    } else if (sfc < 500) {
      int i = sfc - 400;
      slens[0] = (i >> 2) / 5; slens[1] = (i >> 2) % 5;
      slens[2] = i & 3; slens[3] = 0;
      blk = 1;
    } else {
      int i = sfc - 500;
      slens[0] = i / 3; slens[1] = i % 3;
      slens[2] = 0; slens[3] = 0;
      blk = 2;
      *preflag = 1;
    }
  }
  *nsfb = akx_mp3::kLsfNsfb[blk][cls];
  return true;
}

// LSF scalefactors: flat partition read, then the exponent-walk band
// assignment (long bands to mixed_long_end, short from sfb 3); mirrors
// data/mp3.py::_read_scalefactors_lsf. Returns part2 bits consumed.
int read_scalefactors_lsf(Bits* bits, Granule* g, bool intensity_ch) {
  int slens[4], preflag;
  const int8_t* nsfb;
  std::memset(g->scalefac_l, 0, sizeof(g->scalefac_l));
  std::memset(g->scalefac_s, 0, sizeof(g->scalefac_s));
  if (!lsf_scalefactor_layout(g->scalefac_compress, intensity_ch,
                              g->is_short(), g->mixed_block, slens, &nsfb,
                              &preflag))
    return -1;  // malformed intensity compress: decode error
  g->preflag = preflag;
  size_t start = bits->pos;
  int flat[40];
  int total = 0;
  for (int k = 0; k < 4; ++k)
    for (int i = 0; i < nsfb[k]; ++i) flat[total++] = bits->get(slens[k]);
  int part2 = (int)(bits->pos - start);
  while (total < 40) flat[total++] = 0;  // safety pad (walk fits exactly)
  int j = 0;
  if (g->is_short()) {
    int sfb0 = 0;
    if (g->mixed_block) {
      for (int sfb = 0; sfb < g->mixed_long_end(); ++sfb)
        g->scalefac_l[sfb] = flat[j++];
      sfb0 = 3;
    }
    for (int sfb = sfb0; sfb < 12; ++sfb)
      for (int w = 0; w < 3; ++w) g->scalefac_s[sfb][w] = flat[j++];
  } else {
    for (int sfb = 0; sfb < 21; ++sfb) g->scalefac_l[sfb] = flat[j++];
  }
  return part2;
}

// --------------------------------------------------------------- huffman

// mirrors data/mp3.py::_region_boundaries: switched blocks split after
// 3 short bands x3 windows (pure short) or 8 long bands — both 36 lines
// at every MPEG-1 rate but rate-dependent at LSF (72 at MPEG-2.5 8 kHz
// short); oracle-pinned by the LSF region differential tests
void region_boundaries(const Granule& g, const Header& hdr, int* r0,
                       int* r1) {
  if (g.window_switching) {
    *r0 = (g.block_type == 2 && !g.mixed_block) ? 3 * hdr.band_s[3]
                                                : hdr.band_l[8];
    *r1 = 576;
    return;
  }
  const int16_t* band = hdr.band_l;
  int a = g.region0_count + 1;
  int b = g.region0_count + 1 + g.region1_count + 1;
  *r0 = band[a < 22 ? a : 22];
  *r1 = band[b < 22 ? b : 22];
}

// 576 integer spectral values; mirrors data/mp3.py::_read_huffman
void read_huffman(Bits* bits, const Granule& g, const Header& hdr,
                  size_t end, int32_t is[576]) {
  std::memset(is, 0, 576 * sizeof(int32_t));
  int r0, r1;
  region_boundaries(g, hdr, &r0, &r1);
  int big_end = 2 * g.big_values;
  if (big_end > 576) big_end = 576;
  const Trees& tr = trees();
  int line = 0;
  while (line < big_end) {
    if (bits->pos >= end) break;  // remaining big values are zero
    int region = line < r0 ? 0 : (line < r1 ? 1 : 2);
    int tab = g.table_select[region];
    if (tab == 0 || tab == 4 || tab == 14) {
      line += 2;
      continue;
    }
    int row = tr.big[tab].read(bits);
    if (row < 0) break;  // invalid code: stop (end-snap zeroes the rest)
    const HuffRow& hr = akx_mp3::kHuffTables[tab].rows[row];
    int linbits = akx_mp3::kLinbits[tab];
    int x = hr.x, y = hr.y;
    if (x == 15 && linbits) x += bits->get(linbits);
    if (x && bits->get1()) x = -x;
    if (y == 15 && linbits) y += bits->get(linbits);
    if (y && bits->get1()) y = -y;
    if (line + 1 < 576) {
      is[line] = x;
      is[line + 1] = y;
    }
    line += 2;
  }
  // count1 region
  const Tree& c1 = tr.c1[g.count1table_select];
  const QuadRow* qrows = g.count1table_select ? akx_mp3::kCount1B
                                              : akx_mp3::kCount1A;
  while (bits->pos < end && line + 3 < 576) {
    size_t mark = bits->pos;
    int row = c1.read(bits);
    if (row < 0) {
      bits->pos = mark;
      break;
    }
    int vals[4] = {qrows[row].v, qrows[row].w, qrows[row].x, qrows[row].y};
    for (int i = 0; i < 4; ++i)
      if (vals[i] && bits->get1()) vals[i] = -vals[i];
    if (bits->pos > end) {
      bits->pos = mark;  // partial quad past the boundary: discard
      break;
    }
    for (int i = 0; i < 4; ++i) is[line + i] = vals[i];
    line += 4;
  }
  bits->pos = end;
}

// ------------------------------------------------------------- requantize

// the oracle's fixed-point escape clamp (data/mp3.py::_escape_clamp):
// with q4 the band's integer quarter-step exponent, an escape-path value
// (|quantized| >= 15) is zeroed iff frexp_exp(|v|^(4/3) * 2^((q4&3)/4)
// / IMDCT_SCALAR) + (q4>>2) is outside [-28, 3]
inline double requantized(int v, double scale, int q4) {
  if (v == 0) return 0.0;
  int av = v < 0 ? -v : v;
  double mag = std::pow((double)av, 4.0 / 3.0);
  if (av >= 15) {
    double f = mag * std::exp2((q4 & 3) * 0.25) / kImdctScalar;
    int ef;
    std::frexp(f, &ef);
    int e = ef + (q4 >> 2);
    if (e > 3 || e < -28) return 0.0;
  }
  return (v < 0 ? -mag : mag) * scale;
}

void requantize(const Granule& g, const int32_t is[576],
                const Header& hdr, double xr[576]) {
  const int16_t* band_l = hdr.band_l;
  const int16_t* band_s = hdr.band_s;
  double gain = std::exp2((g.global_gain - 210) / 4.0);
  double mult = g.scalefac_scale ? 1.0 : 0.5;
  int q0 = g.global_gain - 210;
  int qmul = g.scalefac_scale ? 4 : 2;
  std::memset(xr, 0, 576 * sizeof(double));
  if (!g.is_short()) {
    for (int sfb = 0; sfb < 21; ++sfb) {
      int sf = g.scalefac_l[sfb] + (g.preflag ? akx_mp3::kPretab[sfb] : 0);
      double scale = gain * std::exp2(-mult * sf);
      int q4 = q0 - qmul * sf;
      for (int i = band_l[sfb]; i < band_l[sfb + 1]; ++i)
        xr[i] = requantized(is[i], scale, q4);
    }
    for (int i = band_l[21]; i < 576; ++i)  // last partial band: sf 0
      xr[i] = requantized(is[i], gain, q0);
    return;
  }
  int pos = 0;
  if (g.mixed_block) {
    int nl = g.mixed_long_end();
    for (int sfb = 0; sfb < nl; ++sfb) {
      int sf = g.scalefac_l[sfb] + (g.preflag ? akx_mp3::kPretab[sfb] : 0);
      double scale = gain * std::exp2(-mult * sf);
      int q4 = q0 - qmul * sf;
      for (int i = band_l[sfb]; i < band_l[sfb + 1]; ++i)
        xr[i] = requantized(is[i], scale, q4);
    }
    pos = band_l[nl];
  }
  int sfb0 = g.mixed_block ? 3 : 0;
  for (int sfb = sfb0; sfb < 13; ++sfb) {
    int nxt = sfb + 1 < 13 ? sfb + 1 : 13;
    int n = band_s[nxt] - band_s[sfb];
    for (int w = 0; w < 3; ++w) {
      int sfac = sfb < 12 ? g.scalefac_s[sfb][w] : 0;
      double scale =
          gain * std::exp2(-2.0 * g.subblock_gain[w] - mult * sfac);
      int q4 = q0 - 8 * g.subblock_gain[w] - qmul * sfac;
      for (int i = 0; i < n && pos + i < 576; ++i)
        xr[pos + i] = requantized(is[pos + i], scale, q4);
      pos += n;
    }
  }
}

// ----------------------------------------------------------------- stereo

// mirrors data/mp3.py::_stereo/_intensity_stereo/_intensity_stereo_lsf
void stereo_process(double xr_l[576], double xr_r[576], const Granule& g_r,
                    const Header& hdr) {
  bool ms = hdr.mode == 1 && (hdr.mode_ext & 2);
  bool intensity = hdr.mode == 1 && (hdr.mode_ext & 1);
  const double isqrt2 = 1.0 / std::sqrt(2.0);
  if (!intensity) {
    if (ms) {
      for (int i = 0; i < 576; ++i) {
        double l = (xr_l[i] + xr_r[i]) * isqrt2;
        double r = (xr_l[i] - xr_r[i]) * isqrt2;
        xr_l[i] = l;
        xr_r[i] = r;
      }
    }
    return;
  }
  // intensity: bands wholly above the right channel's last nonzero line
  // carry position info in the RIGHT channel scalefactors
  double orig_l[576];
  std::memcpy(orig_l, xr_l, sizeof(orig_l));
  int rzero = 0;
  for (int i = 575; i >= 0; --i)
    if (xr_r[i] != 0.0) {
      rzero = i + 1;
      break;
    }
  if (ms) {
    for (int i = 0; i < 576; ++i) {
      double l = (xr_l[i] + xr_r[i]) * isqrt2;
      double r = (xr_l[i] - xr_r[i]) * isqrt2;
      xr_l[i] = l;
      xr_r[i] = r;
    }
  }
  // LSF intensity (13818-3 2.4.3.4.9.3, oracle-pinned in
  // tests/test_mp3_lsf.py): io by scalefac_compress bit 0, k scales the
  // LEFT channel for odd positions / RIGHT for even, every expressible
  // position applies (no MPEG-1-style illegal marker)
  double io = (g_r.scalefac_compress & 1) ? std::exp2(-0.5)
                                          : std::exp2(-0.25);
  auto apply = [&](int lo, int hi, int is_pos) {
    if (hdr.lsf) {
      double t = std::pow(io, (is_pos + 1) >> 1);
      double k0 = (is_pos & 1) ? t : 1.0;
      double k1 = (is_pos & 1) ? 1.0 : t;
      for (int i = lo; i < hi; ++i) {
        xr_l[i] = orig_l[i] * k0;
        xr_r[i] = orig_l[i] * k1;
      }
      return;
    }
    if (is_pos == 7) return;  // illegal position: leave as-is
    double ratio = std::tan(is_pos * kPi / 12.0);
    for (int i = lo; i < hi; ++i) {
      xr_l[i] = orig_l[i] * (ratio / (1.0 + ratio));
      xr_r[i] = orig_l[i] * (1.0 / (1.0 + ratio));
    }
  };
  const int16_t* band_l = hdr.band_l;
  const int16_t* band_s = hdr.band_s;
  if (!g_r.is_short()) {
    for (int sfb = 21; sfb >= 0; --sfb) {
      int lo = band_l[sfb];
      int hi = band_l[sfb + 1 < 22 ? sfb + 1 : 22];
      if (lo < rzero) break;
      apply(lo, hi, g_r.scalefac_l[sfb < 21 ? (sfb < 20 ? sfb : 20) : 20]);
    }
  } else {
    int long_lines = g_r.mixed_block ? band_l[g_r.mixed_long_end()] : 0;
    int sfb0 = g_r.mixed_block ? 3 : 0;
    struct Span {
      int lo, hi, sfb, w;
    };
    std::vector<Span> spans;
    int pos = long_lines;
    for (int sfb = sfb0; sfb < 13; ++sfb) {
      int nxt = sfb + 1 < 13 ? sfb + 1 : 13;
      int n = band_s[nxt] - band_s[sfb];
      for (int w = 0; w < 3; ++w) {
        spans.push_back({pos, pos + n, sfb, w});
        pos += n;
      }
    }
    for (auto it = spans.rbegin(); it != spans.rend(); ++it) {
      if (it->lo < rzero) break;
      apply(it->lo, it->hi,
            g_r.scalefac_s[it->sfb < 12 ? (it->sfb < 11 ? it->sfb : 11) : 11]
                          [it->w]);
    }
  }
}

// -------------------------------------------------- reorder / alias / imdct

void reorder_short(const Granule& g, const Header& hdr, double xr[576]) {
  if (!g.is_short()) return;
  const int16_t* band_s = hdr.band_s;
  const int16_t* band_l = hdr.band_l;
  int pos = g.mixed_block ? band_l[g.mixed_long_end()] : 0;
  int sfb0 = g.mixed_block ? 3 : 0;
  double tmp[576];
  for (int sfb = sfb0; sfb < 13; ++sfb) {
    int nxt = sfb + 1 < 13 ? sfb + 1 : 13;
    int n = band_s[nxt] - band_s[sfb];
    if (pos + 3 * n > 576) n = (576 - pos) / 3 > 0 ? (576 - pos) / 3 : 0;
    if (n == 0) break;
    for (int w = 0; w < 3; ++w)
      for (int i = 0; i < n; ++i) tmp[pos + 3 * i + w] = xr[pos + w * n + i];
    std::memcpy(xr + pos, tmp + pos, (size_t)(3 * n) * sizeof(double));
    pos += 3 * n;
  }
}

void alias_reduce(const Granule& g, double xr[576]) {
  bool sh = g.is_short();
  if (sh && !g.mixed_block) return;
  const Tables& tb = tables();
  int n_b = sh ? 1 : 31;
  for (int b = 0; b < n_b; ++b) {
    int base = 18 * (b + 1);
    for (int j = 0; j < 8; ++j) {
      double a = xr[base - 1 - j];
      double c = xr[base + j];
      xr[base - 1 - j] = a * tb.cs[j] - c * tb.ca[j];
      xr[base + j] = c * tb.cs[j] + a * tb.ca[j];
    }
  }
}

// (18, 32) time-major subband samples; updates overlap[18][32] in place
void imdct_granule(const Granule& g, const double xr[576],
                   double overlap[18][32], double out[18][32]) {
  const Tables& tb = tables();
  bool sh = g.is_short();
  for (int sb = 0; sb < 32; ++sb) {
    const double* X = xr + 18 * sb;
    double z[36];
    if (sh && (!g.mixed_block || sb >= 2)) {
      std::memset(z, 0, sizeof(z));
      for (int w = 0; w < 3; ++w) {
        for (int i = 0; i < 12; ++i) {
          double acc = 0.0;
          for (int k = 0; k < 6; ++k) acc += tb.i12[i][k] * X[3 * k + w];
          z[6 + 6 * w + i] += acc * tb.win[2][i];
        }
      }
    } else {
      int wt = (sh && g.mixed_block && sb < 2) ? 0 : g.block_type;
      const double* win = tb.win[wt];
      for (int i = 0; i < 36; ++i) {
        double acc = 0.0;
        for (int k = 0; k < 18; ++k) acc += tb.i36[i][k] * X[k];
        z[i] = acc * win[i];
      }
    }
    for (int i = 0; i < 18; ++i) {
      out[i][sb] = z[i] + overlap[i][sb];
      overlap[i][sb] = z[18 + i];
    }
  }
  // frequency inversion: odd subbands, odd time samples
  for (int i = 1; i < 18; i += 2)
    for (int sb = 1; sb < 32; sb += 2) out[i][sb] = -out[i][sb];
}

// ---------------------------------------------------------------- synth

struct Synth {
  double v[16][64];
  int head = 0;  // circular: logical row r lives at (head + r) % 16

  Synth() { std::memset(v, 0, sizeof(v)); }

  // one 32-sample block from one time step of subband samples
  void step(const double sb[32], float* out) {
    const Tables& tb = tables();
    head = (head + 15) % 16;  // roll: new row becomes logical row 0
    double* v0 = v[head];
    for (int i = 0; i < 64; ++i) {
      double acc = 0.0;
      for (int k = 0; k < 32; ++k) acc += tb.n64[i][k] * sb[k];
      v0[i] = acc;
    }
    double s[32];
    std::memset(s, 0, sizeof(s));
    for (int i = 0; i < 8; ++i) {
      const double* va = v[(head + 2 * i) % 16];
      const double* vb = v[(head + 2 * i + 1) % 16];
      const double* da = akx_mp3::kSynthD + 32 * (2 * i);
      const double* db = akx_mp3::kSynthD + 32 * (2 * i + 1);
      for (int j = 0; j < 32; ++j) s[j] += va[j] * da[j] + vb[32 + j] * db[j];
    }
    for (int j = 0; j < 32; ++j) out[j] = (float)s[j];
  }
};

// ---------------------------------------------------------------- decoder

struct Decoder {
  int nch;
  double overlap[2][18][32];
  Synth synth[2];
  std::vector<uint8_t> reservoir;

  explicit Decoder(int channels) : nch(channels) {
    std::memset(overlap, 0, sizeof(overlap));
  }

  // appends hdr.samples channel-0 samples to out; mirrors
  // data/mp3.py::Mp3Decoder.decode_frame (LSF: one granule, 9/17-byte
  // side info)
  bool decode_frame(const Header& hdr, const uint8_t* frame, size_t flen,
                    std::vector<float>* out, std::string* err) {
    size_t off = 4 + (hdr.crc ? 2 : 0);
    size_t side_len = hdr.lsf ? (nch == 1 ? 9 : 17) : (nch == 1 ? 17 : 32);
    int n_gr = hdr.lsf ? 1 : 2;
    if (off + side_len > flen) {
      err->assign("truncated side info");
      return false;
    }
    Bits sbits{frame + off, side_len, 0};
    int main_data_begin, scfsi[2][4];
    Granule g[2][2];
    if (!read_side_info(&sbits, nch, hdr.lsf, &main_data_begin, scfsi, g,
                        err))
      return false;
    const uint8_t* main = frame + off + side_len;
    size_t main_len = flen - off - side_len;
    if ((size_t)main_data_begin > reservoir.size()) {
      // not enough reservoir (stream start / cut): frame unusable
      append_reservoir(main, main_len);
      out->insert(out->end(), (size_t)hdr.samples, 0.0f);
      return true;
    }
    std::vector<uint8_t> data(
        reservoir.end() - main_data_begin, reservoir.end());
    data.insert(data.end(), main, main + main_len);
    append_reservoir(main, main_len);

    Bits bits{data.data(), data.size(), 0};
    const Granule* prev[2] = {nullptr, nullptr};
    bool intensity = hdr.mode == 1 && (hdr.mode_ext & 1);
    double xr[2][576];
    float pcm_block[32];
    size_t base = out->size();
    out->resize(base + (size_t)hdr.samples);
    for (int gr = 0; gr < n_gr; ++gr) {
      for (int ch = 0; ch < nch; ++ch) {
        Granule& x = g[gr][ch];
        int part2 =
            hdr.lsf
                ? read_scalefactors_lsf(&bits, &x, intensity && ch == 1)
                : read_scalefactors(&bits, &x, gr, scfsi[ch], prev[ch]);
        if (part2 < 0) {
          err->assign("intensity scalefac_compress out of range");
          return false;
        }
        prev[ch] = &x;
        int32_t is[576];
        size_t end = bits.pos - part2 + x.part2_3_length;
        read_huffman(&bits, x, hdr, end, is);
        requantize(x, is, hdr, xr[ch]);
      }
      if (nch == 2) stereo_process(xr[0], xr[1], g[gr][1], hdr);
      for (int ch = 0; ch < nch; ++ch) {
        reorder_short(g[gr][ch], hdr, xr[ch]);
        alias_reduce(g[gr][ch], xr[ch]);
        double sbs[18][32];
        imdct_granule(g[gr][ch], xr[ch], overlap[ch], sbs);
        for (int t = 0; t < 18; ++t) {
          synth[ch].step(sbs[t], pcm_block);
          if (ch == 0)
            std::memcpy(out->data() + base + gr * 576 + t * 32, pcm_block,
                        32 * sizeof(float));
        }
      }
    }
    return true;
  }

  void append_reservoir(const uint8_t* main, size_t n) {
    reservoir.insert(reservoir.end(), main, main + n);
    if (reservoir.size() > 511)
      reservoir.erase(reservoir.begin(),
                      reservoir.end() - 511);  // keep last 511 bytes
  }
};

}  // namespace

bool decode_mp3_buffer(const uint8_t* buf, size_t len, Decoded* out) {
  size_t off = 0;
  if (len > 10 && std::memcmp(buf, "ID3", 3) == 0) {
    size_t size = ((buf[6] & 0x7F) << 21) | ((buf[7] & 0x7F) << 14) |
                  ((buf[8] & 0x7F) << 7) | (buf[9] & 0x7F);
    off = 10 + size;
  }
  Decoder* dec = nullptr;
  Decoder storage(1);
  bool have = false;
  while (off + 4 <= len) {
    Header hdr;
    if (!hdr.parse(buf, len, off)) {
      ++off;
      continue;
    }
    if (off + (size_t)hdr.frame_bytes > len) break;
    // require the next frame to sync too (guards against false sync),
    // unless this is the last frame in the stream
    size_t nxt = off + hdr.frame_bytes;
    if (nxt + 4 <= len) {
      Header h2;
      if (!h2.parse(buf, len, nxt)) {
        ++off;
        continue;
      }
    }
    if (!have) {
      storage = Decoder(hdr.nch);
      dec = &storage;
      out->sample_rate = hdr.sr;
      have = true;
    }
    std::string err;
    if (!dec->decode_frame(hdr, buf + off, hdr.frame_bytes, &out->samples,
                           &err)) {
      out->error = err;
      return false;
    }
    off = nxt;
  }
  if (!have) {
    out->error = "no Layer III frames found";
    return false;
  }
  return true;
}

bool decode_mp3_file(const char* path, Decoded* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    out->error = std::string("cannot open ") + path;
    return false;
  }
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf((size_t)sz);
  size_t got = std::fread(buf.data(), 1, (size_t)sz, f);
  std::fclose(f);
  if (got != (size_t)sz) {
    out->error = "short read";
    return false;
  }
  return decode_mp3_buffer(buf.data(), buf.size(), out);
}

}  // namespace akx
