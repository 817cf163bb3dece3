// First-party zstd (RFC 8878) frame decoder, a raw-block frame writer and
// CRC32C: the codecs of orbax's checkpoints (zarr v2 chunks are zstd frames,
// OCDBT manifests and B+tree nodes are zstd-wrapped and end in a CRC32C),
// so that models/checkpoint.py reads and writes them without tensorstore or
// the zstandard package.
//
// The decoder writes straight into a caller-given buffer of the expected
// size: tensorstore's frames declare no content size, the zarr chunk's shape
// gives it. Matches reach back into that buffer, so no window buffer is kept.
// It takes raw, RLE and compressed blocks; raw, RLE, Huffman (1 or 4
// streams) and treeless literals; FSE sequence tables in predefined, RLE,
// compressed and repeat modes; repeat offsets; skippable and concatenated
// frames; and the optional XXH64 content checksum. Dictionaries are refused.
// A truncated input, a corrupt stream, a bad checksum or an output of
// another size than expected fails with a message (rlt_zstd_error).
//
// The writer emits raw blocks only (valid zstd at memcpy speed; the
// checkpoint's bytes are not compressed). Host code, exposed as a C API for
// ctypes (raglite_tpu_torch/native/__init__.py); ctypes releases the GIL, so
// callers decode leaves on a thread pool.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local std::string g_error;

struct ZstdError {
  const char* what;
};

[[noreturn]] void fail(const char* what) { throw ZstdError{what}; }

constexpr size_t kBlockMax = 128 * 1024;
constexpr uint32_t kMagic = 0xFD2FB528u;

inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}
inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
inline unsigned highbit32(uint32_t v) { return 31u - static_cast<unsigned>(__builtin_clz(v)); }

// --- Bit readers -------------------------------------------------------------

// Forward little-endian reader (FSE table descriptions).
struct ForwardBits {
  const uint8_t* src;
  size_t size;
  size_t pos = 0;  // in bits

  uint32_t peek(unsigned n) const {
    size_t byte = pos >> 3;
    uint32_t v = 0;
    for (unsigned i = 0; i < 4 && byte + i < size; ++i) v |= uint32_t(src[byte + i]) << (8 * i);
    return (v >> (pos & 7)) & ((1u << n) - 1u);
  }
  void skip(unsigned n) { pos += n; }
};

// Backward reader of a zstd bitstream (Huffman streams, FSE states, sequence
// fields): the last byte's highest set bit marks the end; bits are read from
// the end towards the start.
struct BackBits {
  enum Status { kUnfinished, kEnd, kCompleted, kOverflow };
  const uint8_t* start;
  const uint8_t* ptr;
  uint64_t container;
  unsigned consumed;  // bits consumed from the container's top

  void init(const uint8_t* src, size_t size) {
    if (size == 0) fail("corrupt zstd frame: empty bitstream");
    const uint8_t last = src[size - 1];
    if (last == 0) fail("corrupt zstd frame: bitstream without its end mark");
    start = src;
    if (size >= 8) {
      ptr = src + size - 8;
      container = load64(ptr);
      consumed = 8 - highbit32(last);
    } else {
      ptr = src;
      container = 0;
      for (size_t i = 0; i < size; ++i) container |= uint64_t(src[i]) << (8 * i);
      consumed = 8 - highbit32(last) + unsigned(8 - size) * 8;
    }
  }
  uint64_t look(unsigned n) const { return ((container << (consumed & 63)) >> 1) >> (63 - n); }
  uint64_t read(unsigned n) {
    uint64_t v = look(n);
    consumed += n;
    return v;
  }
  Status reload() {
    if (consumed > 64) return kOverflow;
    if (ptr >= start + 8) {
      ptr -= consumed >> 3;
      consumed &= 7;
      container = load64(ptr);
      return kUnfinished;
    }
    if (ptr == start) return consumed < 64 ? kEnd : kCompleted;
    size_t bytes = consumed >> 3;
    Status status = kUnfinished;
    if (bytes > size_t(ptr - start)) {
      bytes = size_t(ptr - start);
      status = kEnd;
    }
    ptr -= bytes;
    consumed -= unsigned(bytes) * 8;
    container = load64(ptr);
    return status;
  }
  bool finished() const { return ptr == start && consumed == 64; }
};

// --- FSE -------------------------------------------------------------------

struct FseEntry {
  uint16_t new_state;
  uint8_t symbol;
  uint8_t nb_bits;
};

struct FseTable {
  unsigned log = 0;
  std::vector<FseEntry> cells;
};

// Reads an FSE table description (normalized counts); returns bytes used.
size_t read_ncount(const uint8_t* src, size_t size, int16_t* norm, unsigned max_symbol, unsigned* used_max_symbol,
                   unsigned* table_log, unsigned max_log) {
  if (size == 0) fail("corrupt zstd frame: truncated FSE table");
  ForwardBits bits{src, size};
  const unsigned log = bits.peek(4) + 5;
  bits.skip(4);
  if (log > max_log) fail("corrupt zstd frame: FSE accuracy log too large");
  int remaining = (1 << log) + 1;
  int threshold = 1 << log;
  unsigned nb_bits = log + 1;
  unsigned symbol = 0;
  bool previous0 = false;
  while (remaining > 1) {
    if (previous0) {
      unsigned n0 = symbol;
      for (;;) {
        const unsigned repeat = bits.peek(2);
        bits.skip(2);
        n0 += repeat;
        if (repeat != 3) break;
        if (bits.pos > 8 * size) fail("corrupt zstd frame: truncated FSE table");
      }
      if (n0 > max_symbol) fail("corrupt zstd frame: FSE symbol out of range");
      while (symbol < n0) norm[symbol++] = 0;
    }
    if (symbol > max_symbol) fail("corrupt zstd frame: FSE symbol out of range");
    const int max = (2 * threshold - 1) - remaining;
    int count;
    const int low = int(bits.peek(nb_bits - 1));
    if (low < max) {
      count = low;
      bits.skip(nb_bits - 1);
    } else {
      count = int(bits.peek(nb_bits));
      if (count >= threshold) count -= max;
      bits.skip(nb_bits);
    }
    count--;  // -1: a "less than 1" probability
    remaining -= count < 0 ? -count : count;
    if (remaining < 1) fail("corrupt zstd frame: FSE counts exceed the table");
    norm[symbol++] = int16_t(count);
    previous0 = count == 0;
    while (remaining < threshold) {
      nb_bits--;
      threshold >>= 1;
    }
    if (bits.pos > 8 * size) fail("corrupt zstd frame: truncated FSE table");
  }
  *used_max_symbol = symbol - 1;
  *table_log = log;
  return (bits.pos + 7) >> 3;
}

void build_fse(FseTable& table, const int16_t* norm, unsigned max_symbol, unsigned log) {
  const unsigned size = 1u << log;
  table.log = log;
  table.cells.assign(size, FseEntry{0, 0, 0});
  unsigned high = size - 1;
  uint16_t next[256];
  for (unsigned s = 0; s <= max_symbol; ++s) {
    if (norm[s] == -1) {
      table.cells[high--].symbol = uint8_t(s);
      next[s] = 1;
    } else {
      next[s] = uint16_t(norm[s]);
    }
  }
  const unsigned step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  unsigned pos = 0;
  for (unsigned s = 0; s <= max_symbol; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      table.cells[pos].symbol = uint8_t(s);
      do {
        pos = (pos + step) & mask;
      } while (pos > high);
    }
  }
  if (pos != 0) fail("corrupt zstd frame: FSE counts do not fill the table");
  for (unsigned u = 0; u < size; ++u) {
    const unsigned s = table.cells[u].symbol;
    const unsigned x = next[s]++;
    const unsigned nb = log - highbit32(x);
    table.cells[u].nb_bits = uint8_t(nb);
    table.cells[u].new_state = uint16_t((x << nb) - size);
  }
}

void rle_fse(FseTable& table, uint8_t symbol) {
  table.log = 0;
  table.cells.assign(1, FseEntry{0, symbol, 0});
}

// --- Huffman literals ----------------------------------------------------------

struct HufEntry {
  uint8_t symbol;
  uint8_t nb_bits;
};

struct HufTable {
  unsigned log = 0;
  std::vector<HufEntry> cells;
};

// Reads a Huffman tree description; returns bytes used.
size_t read_huffman(const uint8_t* src, size_t size, HufTable& table) {
  if (size == 0) fail("corrupt zstd frame: truncated Huffman tree");
  uint8_t weights[256];
  size_t count = 0, used;
  const uint8_t header = src[0];
  if (header >= 128) {  // direct 4-bit weights
    count = header - 127;
    used = 1 + (count + 1) / 2;
    if (used > size) fail("corrupt zstd frame: truncated Huffman tree");
    for (size_t i = 0; i < count; ++i) weights[i] = (i % 2 == 0) ? src[1 + i / 2] >> 4 : src[1 + i / 2] & 15;
  } else {  // FSE-compressed weights, two interleaved states
    used = 1 + size_t(header);
    if (used > size) fail("corrupt zstd frame: truncated Huffman tree");
    int16_t norm[16];
    unsigned max_symbol, log;
    const size_t head = read_ncount(src + 1, header, norm, 12, &max_symbol, &log, 6);
    if (head >= header) fail("corrupt zstd frame: Huffman weights without a bitstream");
    FseTable fse;
    build_fse(fse, norm, max_symbol, log);
    BackBits bits;
    bits.init(src + 1 + head, header - head);
    unsigned s1 = unsigned(bits.read(log)), s2 = unsigned(bits.read(log));
    bits.reload();
    const FseEntry* cells = fse.cells.data();
    auto emit = [&](unsigned state) {
      if (count >= 255) fail("corrupt zstd frame: too many Huffman weights");
      weights[count++] = cells[state].symbol;
    };
    for (;;) {
      emit(s1);
      s1 = cells[s1].new_state + unsigned(bits.read(cells[s1].nb_bits));
      if (bits.reload() == BackBits::kOverflow) {
        emit(s2);
        break;
      }
      emit(s2);
      s2 = cells[s2].new_state + unsigned(bits.read(cells[s2].nb_bits));
      if (bits.reload() == BackBits::kOverflow) {
        emit(s1);
        break;
      }
    }
  }
  // The last symbol's weight is implied: the weights' powers sum to a power of 2.
  uint32_t total = 0;
  unsigned rank_count[16] = {0};
  for (size_t i = 0; i < count; ++i) {
    if (weights[i] > 12) fail("corrupt zstd frame: Huffman weight out of range");
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  if (total == 0) fail("corrupt zstd frame: empty Huffman tree");
  const unsigned max_bits = highbit32(total) + 1;
  if (max_bits > 12) fail("corrupt zstd frame: Huffman codes too long");
  const uint32_t left = (1u << max_bits) - total;
  if (left == 0 || (left & (left - 1)) != 0) fail("corrupt zstd frame: Huffman weights do not sum to a power of 2");
  if (count >= 256) fail("corrupt zstd frame: too many Huffman weights");
  weights[count++] = uint8_t(highbit32(left) + 1);
  for (size_t i = 0; i < count; ++i) rank_count[weights[i]]++;
  unsigned rank_start[16] = {0};
  unsigned next = 0;
  for (unsigned w = 1; w <= max_bits; ++w) {
    rank_start[w] = next;
    next += rank_count[w] << (w - 1);
  }
  table.log = max_bits;
  table.cells.assign(size_t(1) << max_bits, HufEntry{0, 0});
  for (size_t n = 0; n < count; ++n) {
    const unsigned w = weights[n];
    if (w == 0) continue;
    const unsigned length = (1u << w) >> 1;
    const HufEntry e{uint8_t(n), uint8_t(max_bits + 1 - w)};
    for (unsigned u = rank_start[w]; u < rank_start[w] + length; ++u) table.cells[u] = e;
    rank_start[w] += length;
  }
  return used;
}

// One Huffman-coded literal stream being decoded.
struct HufStream {
  BackBits bits;
  uint8_t* out;
  size_t left;

  void init(const uint8_t* src, size_t size, uint8_t* dst, size_t count) {
    bits.init(src, size);
    out = dst;
    left = count;
  }
  inline void decode_one(const HufEntry* cells, unsigned log) {
    const HufEntry e = cells[bits.look(log)];
    bits.consumed += e.nb_bits;
    *out++ = e.symbol;
    left--;
  }
  // The symbols left, 4 per refill (at most 4 x 12 of the 57 bits a refill
  // guarantees), then one at a time near the stream's start; the stream
  // must end exactly.
  void finish(const HufTable& table) {
    const HufEntry* cells = table.cells.data();
    while (left >= 4 && bits.reload() == BackBits::kUnfinished)
      for (int k = 0; k < 4; ++k) decode_one(cells, table.log);
    while (left) {
      bits.reload();
      decode_one(cells, table.log);
    }
    if (!bits.finished()) fail("corrupt zstd frame: Huffman stream not consumed exactly");
  }
};

// Four streams decoded in turn, so that their table lookups overlap.
void huffman_4streams(const HufTable& table, HufStream* s) {
  const HufEntry* cells = table.cells.data();
  const unsigned log = table.log;
  for (;;) {
    bool refilled = true;
    for (int k = 0; k < 4; ++k) refilled &= s[k].bits.reload() == BackBits::kUnfinished && s[k].left >= 4;
    if (!refilled) break;
    for (int r = 0; r < 4; ++r)
      for (int k = 0; k < 4; ++k) s[k].decode_one(cells, log);
  }
  for (int k = 0; k < 4; ++k) s[k].finish(table);
}

// --- Sequences ---------------------------------------------------------------

constexpr uint32_t kLLBase[36] = {0,  1,  2,  3,  4,  5,  6,   7,   8,   9,   10,   11,   12,   13,   14,    15,    16,   18,
                                  20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
constexpr uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                                 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,  15,  16,   17,   18,   19,   20,
                                  21, 22, 23, 24, 25, 26, 27, 28, 29, 30,  31,  32,  33,  34,   35,   37,   39,   41,
                                  43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
constexpr uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr int16_t kLLNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
constexpr int16_t kMLNorm[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,  1,  1,  1,  1, 1,
                                 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
constexpr int16_t kOFNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct FrameState {
  HufTable huffman;
  bool has_huffman = false;
  FseTable tables[3];  // literal lengths, offsets, match lengths
  bool has_table[3] = {false, false, false};
  uint64_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> literals;
};

size_t decode_literals(const uint8_t* src, size_t size, FrameState& st, const uint8_t** lit, size_t* lit_size) {
  if (size == 0) fail("corrupt zstd frame: empty block");
  const unsigned type = src[0] & 3, format = (src[0] >> 2) & 3;
  if (type <= 1) {  // raw or RLE
    size_t head, regen;
    if (format == 0 || format == 2) {
      head = 1;
      regen = src[0] >> 3;
    } else if (format == 1) {
      if (size < 2) fail("truncated zstd frame");
      head = 2;
      regen = (src[0] >> 4) + (size_t(src[1]) << 4);
    } else {
      if (size < 3) fail("truncated zstd frame");
      head = 3;
      regen = (src[0] >> 4) + (size_t(src[1]) << 4) + (size_t(src[2]) << 12);
    }
    if (regen > kBlockMax) fail("corrupt zstd frame: literals larger than a block");
    if (type == 0) {
      if (head + regen > size) fail("truncated zstd frame");
      *lit = src + head;
      *lit_size = regen;
      return head + regen;
    }
    if (head + 1 > size) fail("truncated zstd frame");
    std::memset(st.literals.data(), src[head], regen);
    *lit = st.literals.data();
    *lit_size = regen;
    return head + 1;
  }
  // Huffman-compressed (2) or treeless (3, the previous block's table).
  const size_t head = format <= 1 ? 3 : format + 2;
  const unsigned field = head == 3 ? 10 : head == 4 ? 14 : 18;
  if (size < head) fail("truncated zstd frame");
  uint64_t h = 0;
  for (size_t i = 0; i < head; ++i) h |= uint64_t(src[i]) << (8 * i);
  const size_t regen = (h >> 4) & ((1u << field) - 1);
  const size_t csize = (h >> (4 + field)) & ((1u << field) - 1);
  if (regen > kBlockMax) fail("corrupt zstd frame: literals larger than a block");
  if (head + csize > size) fail("truncated zstd frame");
  const uint8_t* p = src + head;
  size_t n = csize;
  if (type == 2) {
    const size_t used = read_huffman(p, n, st.huffman);
    st.has_huffman = true;
    p += used;
    n -= used;
  } else if (!st.has_huffman) {
    fail("corrupt zstd frame: treeless literals without a previous Huffman table");
  }
  uint8_t* out = st.literals.data();
  if (format == 0) {
    HufStream one;
    one.init(p, n, out, regen);
    one.finish(st.huffman);
  } else {
    if (n < 10 || regen < 6) fail("corrupt zstd frame: 4-stream literals too short");
    const size_t s1 = p[0] | (size_t(p[1]) << 8), s2 = p[2] | (size_t(p[3]) << 8), s3 = p[4] | (size_t(p[5]) << 8);
    if (6 + s1 + s2 + s3 >= n) fail("corrupt zstd frame: 4-stream jump table out of range");
    const size_t s4 = n - 6 - s1 - s2 - s3;
    const size_t seg = (regen + 3) / 4;
    const uint8_t* q = p + 6;
    HufStream four[4];
    four[0].init(q, s1, out, seg);
    four[1].init(q + s1, s2, out + seg, seg);
    four[2].init(q + s1 + s2, s3, out + 2 * seg, seg);
    four[3].init(q + s1 + s2 + s3, s4, out + 3 * seg, regen - 3 * seg);
    huffman_4streams(st.huffman, four);
  }
  *lit = out;
  *lit_size = regen;
  return head + csize;
}

struct Predefined {
  FseTable t[3];
  Predefined() {
    build_fse(t[0], kLLNorm, 35, 6);
    build_fse(t[1], kOFNorm, 28, 5);
    build_fse(t[2], kMLNorm, 52, 6);
  }
};

const FseTable& predefined(int kind) {
  static const Predefined tables;
  return tables.t[kind];
}

// Reads the three tables' modes and descriptions; returns bytes used.
size_t read_tables(const uint8_t* src, size_t size, FrameState& st) {
  if (size == 0) fail("truncated zstd frame");
  const uint8_t modes = src[0];
  if (modes & 3) fail("corrupt zstd frame: reserved bits set in the sequence modes");
  size_t pos = 1;
  constexpr unsigned kMaxSymbol[3] = {35, 31, 52}, kMaxLog[3] = {9, 8, 9};
  const unsigned mode[3] = {unsigned(modes >> 6), unsigned((modes >> 4) & 3), unsigned((modes >> 2) & 3)};
  for (int k = 0; k < 3; ++k) {
    switch (mode[k]) {
      case 0:
        st.tables[k] = predefined(k);
        break;
      case 1:
        if (pos >= size) fail("truncated zstd frame");
        if (src[pos] > kMaxSymbol[k]) fail("corrupt zstd frame: RLE sequence symbol out of range");
        rle_fse(st.tables[k], src[pos++]);
        break;
      case 2: {
        int16_t norm[64];
        unsigned max_symbol, log;
        pos += read_ncount(src + pos, size - pos, norm, kMaxSymbol[k], &max_symbol, &log, kMaxLog[k]);
        if (pos > size) fail("truncated zstd frame");
        build_fse(st.tables[k], norm, max_symbol, log);
        break;
      }
      default:
        if (!st.has_table[k]) fail("corrupt zstd frame: repeat mode without a previous table");
    }
    st.has_table[k] = true;
  }
  return pos;
}

inline void copy_match(uint8_t* op, size_t offset, size_t length) {
  if (offset == 1) {
    std::memset(op, op[-1], length);
    return;
  }
  while (length) {  // chunks of at most `offset` bytes never overlap their source
    const size_t n = length < offset ? length : offset;
    std::memcpy(op, op - offset, n);
    op += n;
    length -= n;
  }
}

// Decodes one compressed block into [op, oend); returns the new op.
uint8_t* decode_block(const uint8_t* src, size_t size, FrameState& st, const uint8_t* frame_start, uint8_t* op,
                      uint8_t* oend) {
  const uint8_t* lit;
  size_t lit_size;
  size_t pos = decode_literals(src, size, st, &lit, &lit_size);
  const uint8_t* lit_end = lit + lit_size;
  if (pos >= size) fail("truncated zstd frame");
  size_t nseq;
  const uint8_t b0 = src[pos];
  if (b0 < 128) {
    nseq = b0;
    pos += 1;
  } else if (b0 < 255) {
    if (pos + 2 > size) fail("truncated zstd frame");
    nseq = (size_t(b0 - 128) << 8) + src[pos + 1];
    pos += 2;
  } else {
    if (pos + 3 > size) fail("truncated zstd frame");
    nseq = src[pos + 1] + (size_t(src[pos + 2]) << 8) + 0x7F00;
    pos += 3;
  }
  if (nseq > 0) {
    pos += read_tables(src + pos, size - pos, st);
    if (pos >= size) fail("truncated zstd frame");
    const FseEntry* ll_t = st.tables[0].cells.data();
    const FseEntry* of_t = st.tables[1].cells.data();
    const FseEntry* ml_t = st.tables[2].cells.data();
    BackBits bits;
    bits.init(src + pos, size - pos);
    unsigned ll = unsigned(bits.read(st.tables[0].log));
    unsigned of = unsigned(bits.read(st.tables[1].log));
    unsigned ml = unsigned(bits.read(st.tables[2].log));
    bits.reload();
    uint64_t* rep = st.rep;
    for (size_t i = 0; i < nseq; ++i) {
      const unsigned ll_code = ll_t[ll].symbol, of_code = of_t[of].symbol, ml_code = ml_t[ml].symbol;
      if (of_code > 31) fail("corrupt zstd frame: offset code out of range");
      const uint64_t of_value = (uint64_t(1) << of_code) + bits.read(of_code);
      bits.reload();
      const size_t match = kMLBase[ml_code] + size_t(bits.read(kMLBits[ml_code]));
      const size_t literal = kLLBase[ll_code] + size_t(bits.read(kLLBits[ll_code]));
      bits.reload();
      uint64_t offset;
      if (of_value > 3) {
        offset = of_value - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      } else {  // a repeat offset, shifted by one when the literal length is 0
        const unsigned idx = unsigned(of_value) - 1 + (literal == 0 ? 1 : 0);
        if (idx == 0) {
          offset = rep[0];
        } else {
          offset = idx == 3 ? rep[0] - 1 : rep[idx];
          if (offset == 0) fail("corrupt zstd frame: zero repeat offset");
          if (idx != 1) rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = offset;
        }
      }
      if (i + 1 < nseq) {
        ll = ll_t[ll].new_state + unsigned(bits.read(ll_t[ll].nb_bits));
        ml = ml_t[ml].new_state + unsigned(bits.read(ml_t[ml].nb_bits));
        of = of_t[of].new_state + unsigned(bits.read(of_t[of].nb_bits));
        bits.reload();
      }
      if (literal > size_t(lit_end - lit)) fail("corrupt zstd frame: sequence takes more literals than decoded");
      if (literal + match > size_t(oend - op)) fail("zstd frame decodes to more bytes than expected");
      std::memcpy(op, lit, literal);
      op += literal;
      lit += literal;
      if (offset > uint64_t(op - frame_start)) fail("corrupt zstd frame: match offset before the frame's start");
      copy_match(op, size_t(offset), match);
      op += match;
    }
    if (!bits.finished()) fail("corrupt zstd frame: sequence bitstream not consumed exactly");
  } else if (pos != size) {
    fail("corrupt zstd frame: bytes after an empty sequence section");
  }
  const size_t rest = size_t(lit_end - lit);
  if (rest > size_t(oend - op)) fail("zstd frame decodes to more bytes than expected");
  std::memcpy(op, lit, rest);
  return op + rest;
}

// --- Checksums ------------------------------------------------------------------

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL, P3 = 1609587929392839161ULL,
                   P4 = 9650029242287828579ULL, P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xxh_round(uint64_t acc, uint64_t input) { return rotl(acc + input * P2, 31) * P1; }
inline uint64_t xxh_merge(uint64_t acc, uint64_t v) { return (acc ^ xxh_round(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t len, uint64_t seed) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    while (p + 32 <= end) {
      v1 = xxh_round(v1, load64(p));
      v2 = xxh_round(v2, load64(p + 8));
      v3 = xxh_round(v3, load64(p + 16));
      v4 = xxh_round(v4, load64(p + 24));
      p += 32;
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xxh_merge(xxh_merge(xxh_merge(xxh_merge(h, v1), v2), v3), v4);
  } else {
    h = seed + P5;
  }
  h += len;
  while (p + 8 <= end) {
    h ^= xxh_round(0, load64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= uint64_t(load32(p)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p++) * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

struct Crc32cTable {
  uint32_t t[8][256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (c & 1 ? 0x82F63B78u : 0u);
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

uint32_t crc32c(const uint8_t* p, size_t n, uint32_t crc) {
  static const Crc32cTable table;
  const auto& t = table.t;
  crc = ~crc;
  while (n >= 8) {  // slicing by 8
    const uint64_t v = load64(p) ^ crc;
    crc = t[7][v & 0xFF] ^ t[6][(v >> 8) & 0xFF] ^ t[5][(v >> 16) & 0xFF] ^ t[4][(v >> 24) & 0xFF] ^
          t[3][(v >> 32) & 0xFF] ^ t[2][(v >> 40) & 0xFF] ^ t[1][(v >> 48) & 0xFF] ^ t[0][v >> 56];
    p += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ t[0][(crc ^ *p++) & 0xFF];
  return ~crc;
}

// --- Frames ----------------------------------------------------------------------

// Decodes every frame of src into [dst, dst + cap), which it must fill when
// `exact`; returns the bytes written.
size_t decompress(const uint8_t* src, size_t size, uint8_t* dst, size_t cap, bool exact) {
  const uint8_t* ip = src;
  const uint8_t* iend = src + size;
  uint8_t* op = dst;
  uint8_t* oend = dst + cap;
  FrameState st;
  st.literals.resize(kBlockMax + 8);
  if (size == 0) fail("truncated zstd input: no frame");
  while (ip < iend) {
    if (iend - ip < 4) fail("truncated zstd frame");
    const uint32_t magic = load32(ip);
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable frame
      if (iend - ip < 8) fail("truncated zstd frame");
      const uint32_t n = load32(ip + 4);
      if (n > size_t(iend - ip - 8)) fail("truncated zstd frame");
      ip += 8 + n;
      continue;
    }
    if (magic != kMagic) fail("not a zstd frame (bad magic number)");
    ip += 4;
    if (ip >= iend) fail("truncated zstd frame");
    const uint8_t fhd = *ip++;
    const unsigned fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1, dict_flag = fhd & 3;
    if (fhd & 0x08) fail("corrupt zstd frame: reserved header bit set");
    const size_t dict_size = dict_flag == 3 ? 4 : dict_flag;
    const size_t fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : size_t(1) << fcs_flag;
    if (size_t(iend - ip) < (single ? 0 : 1) + dict_size + fcs_size) fail("truncated zstd frame");
    if (!single) ip++;  // window descriptor: matches reach back into dst itself
    uint32_t dict_id = 0;
    for (size_t i = 0; i < dict_size; ++i) dict_id |= uint32_t(ip[i]) << (8 * i);
    ip += dict_size;
    if (dict_id != 0) fail("zstd frame needs a dictionary (not supported)");
    uint64_t content_size = 0;
    for (size_t i = 0; i < fcs_size; ++i) content_size |= uint64_t(ip[i]) << (8 * i);
    if (fcs_size == 2) content_size += 256;
    ip += fcs_size;
    const bool known = fcs_size > 0;
    uint8_t* frame_start = op;
    st.has_huffman = false;
    st.has_table[0] = st.has_table[1] = st.has_table[2] = false;
    st.rep[0] = 1;
    st.rep[1] = 4;
    st.rep[2] = 8;
    for (;;) {
      if (iend - ip < 3) fail("truncated zstd frame");
      const uint32_t bh = ip[0] | (uint32_t(ip[1]) << 8) | (uint32_t(ip[2]) << 16);
      ip += 3;
      const unsigned last = bh & 1, type = (bh >> 1) & 3;
      const size_t bsize = bh >> 3;
      if (type == 0) {
        if (bsize > size_t(iend - ip)) fail("truncated zstd frame");
        if (bsize > size_t(oend - op)) fail("zstd frame decodes to more bytes than expected");
        std::memcpy(op, ip, bsize);
        ip += bsize;
        op += bsize;
      } else if (type == 1) {
        if (ip >= iend) fail("truncated zstd frame");
        if (bsize > size_t(oend - op)) fail("zstd frame decodes to more bytes than expected");
        std::memset(op, *ip++, bsize);
        op += bsize;
      } else if (type == 2) {
        if (bsize > size_t(iend - ip)) fail("truncated zstd frame");
        if (bsize > kBlockMax) fail("corrupt zstd frame: block larger than 128 KiB");
        op = decode_block(ip, bsize, st, frame_start, op, oend);
        ip += bsize;
      } else {
        fail("corrupt zstd frame: reserved block type");
      }
      if (last) break;
    }
    if (checksum) {
      if (iend - ip < 4) fail("truncated zstd frame");
      if (uint32_t(xxh64(frame_start, size_t(op - frame_start), 0)) != load32(ip))
        fail("zstd content checksum mismatch");
      ip += 4;
    }
    if (known && uint64_t(op - frame_start) != content_size) fail("zstd frame content size mismatch");
  }
  if (exact && op != oend) fail("zstd frames decode to fewer bytes than expected");
  return size_t(op - dst);
}

constexpr size_t kRawBlock = 128 * 1024;

size_t raw_frame_size(size_t n) {
  const size_t blocks = n == 0 ? 1 : (n + kRawBlock - 1) / kRawBlock;
  return 4 + 1 + 1 + (n < (uint64_t(1) << 32) ? 4 : 8) + 3 * blocks + n;
}

}  // namespace

extern "C" {

const char* rlt_zstd_error() { return g_error.c_str(); }

// Decodes the zstd frames of src[0, size) into dst[0, cap) (filling it
// exactly when `exact`); returns the bytes written, or -1 on failure
// (message: rlt_zstd_error, per thread).
int64_t rlt_zstd_decompress(const uint8_t* src, int64_t size, uint8_t* dst, int64_t cap, int32_t exact) {
  try {
    return int64_t(decompress(src, size_t(size), dst, size_t(cap), exact != 0));
  } catch (const ZstdError& e) {
    g_error = e.what;
  } catch (const std::bad_alloc&) {
    g_error = "out of memory";
  }
  return -1;
}

int64_t rlt_zstd_raw_frame_size(int64_t n) { return int64_t(raw_frame_size(size_t(n))); }

// One zstd frame of raw blocks holding src[0, n) (content size declared, a
// 128 KiB window, no checksum), written to dst (rlt_zstd_raw_frame_size(n)
// bytes); returns the bytes written.
int64_t rlt_zstd_raw_frame(const uint8_t* src, int64_t n, uint8_t* dst) {
  const size_t size = size_t(n);
  uint8_t* op = dst;
  const uint32_t magic = kMagic;
  std::memcpy(op, &magic, 4);
  op += 4;
  const bool wide = size >= (uint64_t(1) << 32);
  *op++ = uint8_t((wide ? 3 : 2) << 6);  // content size field of 4 or 8 bytes
  *op++ = uint8_t(7 << 3);               // window 2^(10 + 7) = 128 KiB
  const uint64_t content = size;
  std::memcpy(op, &content, wide ? 8 : 4);
  op += wide ? 8 : 4;
  size_t pos = 0;
  do {
    const size_t chunk = size - pos < kRawBlock ? size - pos : kRawBlock;
    const uint32_t last = pos + chunk == size ? 1 : 0;
    const uint32_t bh = uint32_t(chunk << 3) | last;  // type 0: raw
    op[0] = uint8_t(bh);
    op[1] = uint8_t(bh >> 8);
    op[2] = uint8_t(bh >> 16);
    std::memcpy(op + 3, src + pos, chunk);
    op += 3 + chunk;
    pos += chunk;
  } while (pos < size);
  return int64_t(op - dst);
}

uint32_t rlt_crc32c(const uint8_t* src, int64_t n, uint32_t crc) { return crc32c(src, size_t(n), crc); }

}  // extern "C"
