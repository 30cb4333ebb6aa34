// Huffman entropy decoding of one scan of a baseline (sequential, 8-bit)
// JPEG: the one step of the port's JPEG decoder (data/jpeg.py) that does
// not vectorize. Host C++, built with the host compiler at first use.
//
// Input: the scan's entropy-coded bytes [pos, end) (the caller finds the
// marker that ends them), each scan component's DC and AC Huffman tables
// as the DHT segment gives them (16 code counts, then up to 256 symbols),
// the MCU grid and the restart interval. Output: each component's
// quantized coefficient blocks, int16, natural (row-major) order, written
// at (row, col) of the component's block array, as ITU T.81 F.2.2 decodes
// them: a DC difference added to the component's predictor, then run /
// size pairs of AC coefficients up to the end of block. Every restart
// interval resets the predictors and expects its RSTn marker.
//
// Like libjpeg, the bit reader stops at a marker and reads zero bits past
// it, so a final code shorter than the reader's lookahead decodes.

#include <stdint.h>

#include <cstring>

namespace {

constexpr int kLookahead = 9;  // bits of the fast decoding table

// position k of the zig-zag scan -> index in the natural-order block
constexpr int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

enum Error {
  kBadTable = -1,
  kBadCode = -2,
  kBadRestart = -3,
  kBadCoefficient = -4,
};

struct Table {
  int maxcode[18];    // the largest code of each length, -1 if none
  int valoffset[18];  // symbol index of a code of that length, less it
  uint8_t vals[256];
  // kLookahead-bit prefix -> (length << 8 | symbol), 0 if longer
  uint16_t fast[1 << kLookahead];
};

// The canonical code of T.81 C.2 from the DHT counts and symbols.
bool make_table(const uint8_t* spec, Table* t) {
  int count = 0;
  for (int l = 0; l < 16; ++l) count += spec[l];
  if (count > 256) return false;
  std::memcpy(t->vals, spec + 16, count);
  std::memset(t->fast, 0, sizeof(t->fast));
  int code = 0, p = 0;
  for (int l = 1; l <= 16; ++l) {
    const int n = spec[l - 1];
    if (n) {
      t->valoffset[l] = p - code;
      for (int i = 0; i < n; ++i, ++p, ++code) {
        if (l <= kLookahead) {
          const int shift = kLookahead - l;
          for (int j = 0; j < (1 << shift); ++j)
            t->fast[(code << shift) | j] =
                static_cast<uint16_t>(l << 8 | t->vals[p]);
        }
      }
      t->maxcode[l] = code - 1;
      if (code > (1 << l)) return false;  // more codes than the length has
    } else {
      t->maxcode[l] = -1;
    }
    code <<= 1;
  }
  t->maxcode[17] = 0x7fffffff;  // ends the search of a code that is none
  return true;
}

struct Bits {
  const uint8_t* data;
  long pos, end;
  uint64_t buf = 0;  // the next n bits, most significant first
  int n = 0;
  bool at_marker = false;

  void fill() {
    while (n <= 56) {
      uint64_t b = 0;
      if (!at_marker) {
        if (pos >= end) {
          at_marker = true;
        } else if (data[pos] != 0xFF) {
          b = data[pos++];
        } else if (pos + 1 < end && data[pos + 1] == 0x00) {
          b = 0xFF;  // a stuffed byte
          pos += 2;
        } else {
          at_marker = true;  // RSTn: zeros until the restart
        }
      }
      buf |= b << (56 - n);
      n += 8;
    }
  }

  int get(int s) {  // s <= 16 bits, as an unsigned value
    if (s == 0) return 0;
    fill();
    const int v = static_cast<int>(buf >> (64 - s));
    buf <<= s;
    n -= s;
    return v;
  }

  int decode(const Table& t) {  // a symbol, or kBadCode
    fill();
    const uint16_t e = t.fast[buf >> (64 - kLookahead)];
    if (e) {
      const int l = e >> 8;
      buf <<= l;
      n -= l;
      return e & 0xFF;
    }
    for (int l = kLookahead + 1; l <= 16; ++l) {
      const int code = static_cast<int>(buf >> (64 - l));
      if (code <= t.maxcode[l]) {
        buf <<= l;
        n -= l;
        return t.vals[code + t.valoffset[l]];
      }
    }
    return kBadCode;
  }

  // Drop what is left of the interval and step over its RSTn marker.
  bool restart(int k) {
    buf = 0;
    n = 0;
    at_marker = false;
    while (pos + 1 < end && data[pos] == 0xFF && data[pos + 1] == 0xFF)
      ++pos;  // fill bytes before the marker
    if (pos + 1 >= end || data[pos] != 0xFF || data[pos + 1] != 0xD0 + k)
      return false;
    pos += 2;
    return true;
  }
};

// the value of s bits read as T.81's EXTEND
inline int extend(int v, int s) {
  return s == 0 ? 0 : (v < (1 << (s - 1)) ? v - (1 << s) + 1 : v);
}

}  // namespace

// Decode the scan data [pos, end) of data. ns components, each with its
// int16 block array coef[i] of blocks_per_row[i] blocks a row (64
// coefficients a block), hs[i] x vs[i] blocks an MCU (1 x 1 in a scan of
// one component), and its tables dc[i], ac[i] (16 counts + 256 symbols
// each). mcus_x x mcus_y MCUs; restart_interval MCUs between RSTn markers
// (0: none). Returns the position the reader stopped at, or a negative
// Error.
extern "C" long jpeg_decode_scan(const uint8_t* data, long pos, long end,
                                 int ns, int16_t* const* coef,
                                 const int* blocks_per_row, const int* hs,
                                 const int* vs, const uint8_t* dc,
                                 const uint8_t* ac, int mcus_x, int mcus_y,
                                 int restart_interval) {
  if (ns < 1 || ns > 4) return kBadTable;
  Table dc_t[4], ac_t[4];
  for (int i = 0; i < ns; ++i)
    if (!make_table(dc + i * 272, &dc_t[i]) ||
        !make_table(ac + i * 272, &ac_t[i]))
      return kBadTable;
  int pred[4] = {0, 0, 0, 0};
  Bits bits;
  bits.data = data;
  bits.pos = pos;
  bits.end = end;
  const long n_mcus = static_cast<long>(mcus_x) * mcus_y;
  int next_rst = 0;
  for (long m = 0; m < n_mcus; ++m) {
    if (restart_interval > 0 && m > 0 && m % restart_interval == 0) {
      if (!bits.restart(next_rst)) return kBadRestart;
      next_rst = (next_rst + 1) & 7;
      std::memset(pred, 0, sizeof(pred));
    }
    const long mx = m % mcus_x, my = m / mcus_x;
    for (int i = 0; i < ns; ++i) {
      for (int by = 0; by < vs[i]; ++by) {
        for (int bx = 0; bx < hs[i]; ++bx) {
          const long row = my * vs[i] + by, col = mx * hs[i] + bx;
          int16_t* blk = coef[i] + (row * blocks_per_row[i] + col) * 64;
          std::memset(blk, 0, 64 * sizeof(int16_t));
          int s = bits.decode(dc_t[i]);
          if (s < 0 || s > 16) return kBadCode;
          pred[i] += extend(bits.get(s), s);
          blk[0] = static_cast<int16_t>(pred[i]);
          for (int k = 1; k < 64;) {
            const int rs = bits.decode(ac_t[i]);
            if (rs < 0) return kBadCode;
            const int r = rs >> 4;
            s = rs & 15;
            if (s == 0) {
              if (r != 15) break;  // end of block
              k += 16;
              continue;
            }
            k += r;
            if (k > 63) return kBadCoefficient;
            blk[kNatural[k]] = static_cast<int16_t>(extend(bits.get(s), s));
            ++k;
          }
        }
      }
    }
  }
  return bits.pos;
}
