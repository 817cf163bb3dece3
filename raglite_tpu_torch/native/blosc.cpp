// First-party decoder of the Blosc (1.x) container and its inner codecs, the
// compressor that tensorstore's zarr drivers write as "blosc" (zarr v2's
// compressor, zarr v3's bytes-to-bytes codec), so that models/checkpoint.py
// reads such checkpoints without c-blosc, numcodecs or lz4.
//
// A container is a 16-byte header (format version, codec version, flags,
// type size, uncompressed bytes, block size, compressed bytes; integers
// little-endian), then either the data itself (flag 0x2: "memcpyed") or one
// int32 start offset per block followed by the blocks.  A block holds one
// stream, or one stream per byte of the type (split: flag 0x10 clear, every
// block but a leftover last one); each stream is an int32 compressed size and
// the compressed bytes, stored as they are when that size equals the
// stream's decoded size.  The codec is flags >> 5: 0 BloscLZ, 1 LZ4 (lz4 and
// lz4hc), 2 Snappy, 3 zlib, 4 zstd.  After decoding, a block is unshuffled:
// bytes (flag 0x1, type size > 1) or bits (flag 0x4; the bitshuffle
// library's layout, applied when the block's element count is a multiple of
// 8).
//
// LZ4 blocks, BloscLZ and raw Snappy are decoded here; zstd streams go to the
// port's zstd decoder (zstd.cpp), zlib streams to a callback the caller
// passes (Python's zlib).  Every read and write is bounds-checked: a
// truncated or corrupt input fails with a message (rlt_blosc_error), never
// reads or writes outside the buffers.  Host code, exposed as a C API for
// ctypes (raglite_tpu_torch/native/__init__.py).

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

extern "C" int64_t rlt_zstd_decompress(const uint8_t* src, int64_t size, uint8_t* dst, int64_t cap, int32_t exact);
extern "C" const char* rlt_zstd_error();

namespace {

thread_local std::string g_error;

struct BloscError {
  std::string what;
  bool unsupported;
};

[[noreturn]] void fail(const std::string& what) { throw BloscError{what, false}; }
[[noreturn]] void unsupported(const std::string& what) { throw BloscError{what, true}; }

inline uint32_t le32(const uint8_t* p) { return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 | uint32_t(p[3]) << 24; }

// Copies a match of `len` bytes from `offset` bytes back, with the
// byte-by-byte semantics of an overlapping copy.
inline void copy_match(uint8_t* op, size_t offset, size_t len) {
  const uint8_t* ref = op - offset;
  if (offset >= len) {
    std::memcpy(op, ref, len);
  } else if (offset >= 8) {
    for (; len >= 8; len -= 8, op += 8, ref += 8) std::memcpy(op, ref, 8);
    while (len--) *op++ = *ref++;
  } else {
    while (len--) *op++ = *ref++;
  }
}

// --- LZ4 block format --------------------------------------------------------

// Sequences of (token, literal length bytes, literals, 2-byte offset, match
// length bytes); the last sequence has literals only.
size_t lz4_block(const uint8_t* src, size_t size, uint8_t* dst, size_t cap) {
  const uint8_t* ip = src;
  const uint8_t* const iend = src + size;
  uint8_t* op = dst;
  uint8_t* const oend = dst + cap;
  if (size == 0) fail("corrupt LZ4 block: empty");
  for (;;) {
    const unsigned token = *ip++;
    size_t lit = token >> 4;
    if (lit == 15) {
      unsigned b;
      do {
        if (ip >= iend) fail("truncated LZ4 block");
        b = *ip++;
        lit += b;
      } while (b == 255);
    }
    if (lit > size_t(iend - ip)) fail("truncated LZ4 block");
    if (lit > size_t(oend - op)) fail("LZ4 block decodes to more bytes than expected");
    std::memcpy(op, ip, lit);
    op += lit;
    ip += lit;
    if (ip == iend) break;
    if (iend - ip < 2) fail("truncated LZ4 block");
    const size_t offset = size_t(ip[0]) | size_t(ip[1]) << 8;
    ip += 2;
    if (offset == 0 || offset > size_t(op - dst)) fail("corrupt LZ4 block: offset outside the output");
    size_t len = token & 15;
    if (len == 15) {
      unsigned b;
      do {
        if (ip >= iend) fail("truncated LZ4 block");
        b = *ip++;
        len += b;
      } while (b == 255);
    }
    len += 4;
    if (len > size_t(oend - op)) fail("LZ4 block decodes to more bytes than expected");
    copy_match(op, offset, len);
    op += len;
  }
  return size_t(op - dst);
}

// --- BloscLZ -------------------------------------------------------------------

// c-blosc 1.x's blosclz_decompress: a literal run (control < 32: control + 1
// bytes) or a match (length from the control's top 3 bits, 7 meaning more
// length bytes; distance from its low 5 bits and the next byte, 31 and 255
// meaning a 16-bit distance beyond 8,191 follows).  The first control's top
// 3 bits are the level marker.
size_t blosclz(const uint8_t* src, size_t size, uint8_t* dst, size_t cap) {
  constexpr size_t kMaxDistance = 8191;
  const uint8_t* ip = src;
  const uint8_t* const iend = src + size;
  uint8_t* op = dst;
  uint8_t* const oend = dst + cap;
  if (size == 0) return 0;
  unsigned ctrl = *ip++ & 31u;
  for (;;) {
    if (ctrl >= 32) {
      size_t len = (ctrl >> 5) - 1;
      size_t ofs = size_t(ctrl & 31u) << 8;
      unsigned code;
      if (len == 7 - 1) {
        do {
          if (ip + 1 >= iend) fail("truncated BloscLZ stream");
          code = *ip++;
          len += code;
        } while (code == 255);
      } else if (ip + 1 >= iend) {
        fail("truncated BloscLZ stream");
      }
      code = *ip++;
      len += 3;
      size_t back = ofs + code + 1;  // the match starts `back` bytes before op
      if (code == 255 && ofs == (31u << 8)) {
        if (ip + 1 >= iend) fail("truncated BloscLZ stream");
        ofs = size_t(ip[0]) << 8 | ip[1];
        ip += 2;
        back = ofs + kMaxDistance + 1;
      }
      if (len > size_t(oend - op)) fail("BloscLZ stream decodes to more bytes than expected");
      if (back > size_t(op - dst)) fail("corrupt BloscLZ stream: distance outside the output");
      if (ip >= iend) break;  // as c-blosc: a stream never ends on a match
      ctrl = *ip++;
      copy_match(op, back, len);
      op += len;
    } else {
      const size_t lit = ctrl + 1;
      if (lit > size_t(oend - op)) fail("BloscLZ stream decodes to more bytes than expected");
      if (lit > size_t(iend - ip)) fail("truncated BloscLZ stream");
      std::memcpy(op, ip, lit);
      op += lit;
      ip += lit;
      if (ip >= iend) break;
      ctrl = *ip++;
    }
  }
  return size_t(op - dst);
}

// --- Snappy (raw format) -----------------------------------------------------

// A varint of the decoded length, then elements: literals (tag & 3 == 0;
// length in the tag or in 1-4 following bytes) and copies with 1-, 2- or
// 4-byte offsets.
size_t snappy(const uint8_t* src, size_t size, uint8_t* dst, size_t cap) {
  const uint8_t* ip = src;
  const uint8_t* const iend = src + size;
  uint64_t length = 0;
  for (unsigned shift = 0;; shift += 7) {
    if (ip >= iend || shift > 28) fail("corrupt Snappy stream: bad length");
    const unsigned b = *ip++;
    length |= uint64_t(b & 0x7F) << shift;
    if (b < 0x80) break;
  }
  if (length > cap) fail("Snappy stream decodes to more bytes than expected");
  uint8_t* op = dst;
  uint8_t* const oend = dst + length;
  while (ip < iend) {
    const unsigned tag = *ip++;
    size_t len, offset;
    switch (tag & 3) {
      case 0: {
        len = tag >> 2;
        if (len >= 60) {
          const size_t n = len - 59;
          if (size_t(iend - ip) < n) fail("truncated Snappy stream");
          len = 0;
          for (size_t i = 0; i < n; ++i) len |= size_t(ip[i]) << (8 * i);
          ip += n;
        }
        len += 1;
        if (len > size_t(iend - ip)) fail("truncated Snappy stream");
        if (len > size_t(oend - op)) fail("Snappy stream decodes to more bytes than declared");
        std::memcpy(op, ip, len);
        op += len;
        ip += len;
        continue;
      }
      case 1:
        if (ip >= iend) fail("truncated Snappy stream");
        len = ((tag >> 2) & 7) + 4;
        offset = size_t(tag >> 5) << 8 | *ip++;
        break;
      case 2:
        if (iend - ip < 2) fail("truncated Snappy stream");
        len = (tag >> 2) + 1;
        offset = size_t(ip[0]) | size_t(ip[1]) << 8;
        ip += 2;
        break;
      default:
        if (iend - ip < 4) fail("truncated Snappy stream");
        len = (tag >> 2) + 1;
        offset = le32(ip);
        ip += 4;
        break;
    }
    if (offset == 0 || offset > size_t(op - dst)) fail("corrupt Snappy stream: offset outside the output");
    if (len > size_t(oend - op)) fail("Snappy stream decodes to more bytes than declared");
    copy_match(op, offset, len);
    op += len;
  }
  if (op != oend) fail("Snappy stream decodes to fewer bytes than declared");
  return size_t(length);
}

// --- Unshuffles ----------------------------------------------------------------

// Byte shuffle: byte j of every element together, j = 0 .. type size - 1;
// the bytes past the last whole element as they are.
void unshuffle(size_t typesize, size_t n, const uint8_t* src, uint8_t* dst) {
  const size_t elems = n / typesize;
  for (size_t j = 0; j < typesize; ++j) {
    const uint8_t* s = src + j * elems;
    uint8_t* d = dst + j;
    for (size_t i = 0; i < elems; ++i) d[i * typesize] = s[i];
  }
  std::memcpy(dst + elems * typesize, src + elems * typesize, n - elems * typesize);
}

// Transposes an 8 x 8 bit matrix held in a 64-bit word (byte r = row r, bit
// c = column c), the bitshuffle library's TRANS_BIT_8X8.
inline uint64_t transpose8x8(uint64_t x) {
  uint64_t t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAull;
  x = x ^ t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCull;
  x = x ^ t ^ (t << 14);
  t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ull;
  return x ^ t ^ (t << 28);
}

// Bit shuffle (bitshuffle's bshuf_trans_bit_elem): for byte j and bit k of
// the type, row 8 j + k holds bit k of byte j of every element, element i at
// row byte i / 8, bit i % 8.  c-blosc applies it only when the element count
// is a multiple of 8, and copies the block as it is otherwise.
void bitunshuffle(size_t typesize, size_t n, const uint8_t* src, uint8_t* dst) {
  const size_t elems = n / typesize;
  if (elems % 8 != 0) {
    std::memcpy(dst, src, n);
    return;
  }
  const size_t row = elems / 8;  // bytes of one bit row
  for (size_t j = 0; j < typesize; ++j) {
    const uint8_t* rows = src + j * 8 * row;
    for (size_t g = 0; g < row; ++g) {  // elements 8 g .. 8 g + 7
      uint64_t x = 0;
      for (unsigned k = 0; k < 8; ++k) x |= uint64_t(rows[k * row + g]) << (8 * k);
      x = transpose8x8(x);
      uint8_t* d = dst + 8 * g * typesize + j;
      for (unsigned m = 0; m < 8; ++m) d[m * typesize] = uint8_t(x >> (8 * m));
    }
  }
  std::memcpy(dst + elems * typesize, src + elems * typesize, n - elems * typesize);
}

// --- The container -------------------------------------------------------------

using InflateFn = int64_t (*)(const uint8_t* src, int64_t size, uint8_t* dst, int64_t cap);

constexpr size_t kHeader = 16;
constexpr uint8_t kShuffle = 0x1, kMemcpyed = 0x2, kBitshuffle = 0x4, kNoSplit = 0x10;

size_t header_nbytes(const uint8_t* src, size_t size) {
  if (size < kHeader) fail("truncated Blosc header");
  if (src[0] == 0 || src[0] > 2) unsupported("Blosc format version " + std::to_string(src[0]) + " (c-blosc 1.x's versions 1 and 2 are read)");
  return le32(src + 4);
}

void decode_stream(unsigned codec, const uint8_t* src, size_t size, uint8_t* dst, size_t n, InflateFn inflate) {
  size_t got = 0;
  switch (codec) {
    case 0:
      got = blosclz(src, size, dst, n);
      break;
    case 1:
      got = lz4_block(src, size, dst, n);
      break;
    case 2:
      got = snappy(src, size, dst, n);
      break;
    case 3: {
      if (inflate == nullptr) unsupported("Blosc zlib stream without an inflate callback");
      const int64_t r = inflate(src, int64_t(size), dst, int64_t(n));
      if (r < 0) fail("corrupt zlib stream in a Blosc block");
      got = size_t(r);
      break;
    }
    case 4: {
      const int64_t r = rlt_zstd_decompress(src, int64_t(size), dst, int64_t(n), 1);
      if (r < 0) fail(std::string("zstd stream in a Blosc block: ") + rlt_zstd_error());
      got = size_t(r);
      break;
    }
    default:
      unsupported("Blosc codec " + std::to_string(codec) + " (BloscLZ, LZ4, Snappy, zlib and zstd are read)");
  }
  if (got != n) fail("a Blosc stream decodes to another size than its block says");
}

size_t decompress(const uint8_t* src, size_t size, uint8_t* dst, size_t cap, InflateFn inflate) {
  const size_t nbytes = header_nbytes(src, size);
  const uint8_t flags = src[2];
  const size_t typesize = src[3];
  const size_t blocksize = le32(src + 8);
  const size_t cbytes = le32(src + 12);
  if (cbytes > size) fail("truncated Blosc container");
  if (nbytes != cap) fail("Blosc container holds " + std::to_string(nbytes) + " bytes, expected " + std::to_string(cap));
  if (flags & kMemcpyed) {
    if (cbytes < kHeader + nbytes) fail("truncated Blosc container");
    std::memcpy(dst, src + kHeader, nbytes);
    return nbytes;
  }
  if (nbytes == 0) return 0;
  if (typesize == 0 || blocksize == 0) fail("corrupt Blosc header: zero type or block size");
  const unsigned codec = flags >> 5;
  const bool split_allowed = !(flags & kNoSplit);
  const size_t nblocks = nbytes / blocksize + (nbytes % blocksize != 0);
  const size_t leftover = nbytes % blocksize;
  if (kHeader + 4 * nblocks > cbytes) fail("truncated Blosc block offsets");
  std::vector<uint8_t> tmp((flags & (kShuffle | kBitshuffle)) ? blocksize : 0);
  for (size_t b = 0; b < nblocks; ++b) {
    const bool last_leftover = b + 1 == nblocks && leftover != 0;
    const size_t bsize = last_leftover ? leftover : blocksize;
    const bool shuffle = (flags & kShuffle) && typesize > 1;
    const bool bitshuffle = (flags & kBitshuffle) && bsize >= typesize;
    uint8_t* const out = dst + b * blocksize;
    uint8_t* const target = (shuffle || bitshuffle) ? tmp.data() : out;
    const size_t nsplits = split_allowed && !last_leftover ? typesize : 1;
    if (bsize % nsplits != 0) fail("corrupt Blosc container: a block does not divide into its streams");
    const size_t neblock = bsize / nsplits;
    size_t pos = le32(src + kHeader + 4 * b);
    for (size_t s = 0; s < nsplits; ++s) {
      if (pos < kHeader + 4 * nblocks || pos + 4 > cbytes) fail("corrupt Blosc container: a block outside the buffer");
      const size_t csize = le32(src + pos);
      pos += 4;
      if (csize > cbytes - pos) fail("truncated Blosc block");
      if (csize == neblock) {
        std::memcpy(target + s * neblock, src + pos, neblock);
      } else {
        decode_stream(codec, src + pos, csize, target + s * neblock, neblock, inflate);
      }
      pos += csize;
    }
    if (shuffle) {
      unshuffle(typesize, bsize, target, out);
    } else if (bitshuffle) {
      bitunshuffle(typesize, bsize, target, out);
    }
  }
  return nbytes;
}

int64_t report(const BloscError& e) {
  g_error = e.what;
  return e.unsupported ? -2 : -1;
}

}  // namespace

extern "C" {

const char* rlt_blosc_error() { return g_error.c_str(); }

// The uncompressed bytes a Blosc container's header declares; -1 for a
// truncated header, -2 for a format this decoder does not read (message:
// rlt_blosc_error, per thread).
int64_t rlt_blosc_nbytes(const uint8_t* src, int64_t size) {
  try {
    return int64_t(header_nbytes(src, size_t(size)));
  } catch (const BloscError& e) {
    return report(e);
  }
}

// Decodes the Blosc container src[0, size) into dst[0, cap), which it must
// fill exactly; zlib streams go through `inflate` (which returns the bytes
// it wrote, or -1).  Returns the bytes written, -1 on a corrupt or truncated
// input, -2 on a codec or format this decoder does not read.
int64_t rlt_blosc_decompress(const uint8_t* src, int64_t size, uint8_t* dst, int64_t cap, InflateFn inflate) {
  try {
    return int64_t(decompress(src, size_t(size), dst, size_t(cap), inflate));
  } catch (const BloscError& e) {
    return report(e);
  } catch (const std::bad_alloc&) {
    g_error = "out of memory";
    return -1;
  }
}

}  // extern "C"
