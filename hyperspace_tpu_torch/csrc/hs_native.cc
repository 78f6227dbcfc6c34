// libhs_native — native Parquet column-chunk decoder.
//
// The TPU framework's one ground-up native component (SURVEY.md §7 design
// stance: "a C++ Parquet column-chunk decode path into device-feedable
// buffers"; the reference is 100% JVM and delegates scans to Spark executors,
// SURVEY.md §0). Decodes flat Parquet columns — PLAIN or RLE_DICTIONARY
// encoded; UNCOMPRESSED, SNAPPY, GZIP, or ZSTD — from an mmap'd file straight into
// caller-allocated buffers (numpy arrays on the Python side) with zero copies
// for uncompressed pages, so index scans feed jax.device_put without
// pyarrow/JVM row pivoting.
//
// The framework's own index files are written uncompressed (zero-copy fast
// path); SNAPPY (Spark's default codec, own decompressor), GZIP (system
// zlib), and ZSTD (system libzstd) keep externally-written lake files on the
// native path too. Anything
// outside this dialect returns an error and the Python caller falls back to
// pyarrow.
//
// Build: make -C native  (g++ -O3 -shared -fPIC, links -lz -lzstd)

#include <fcntl.h>
#ifndef HS_NO_ZLIB
#include <zlib.h>
#endif
#if defined(HS_ZSTD_COMPAT)
// Header-less build against a runtime libzstd.so.1 (dev package absent).
// These four symbols are ZSTD's stable public ABI since 1.0 — declaring them
// by hand keeps the codec alive on hosts that ship the library but not zstd.h.
extern "C" {
typedef struct ZSTD_DCtx_s ZSTD_DCtx;
ZSTD_DCtx* ZSTD_createDCtx(void);
size_t ZSTD_freeDCtx(ZSTD_DCtx* dctx);
size_t ZSTD_decompressDCtx(ZSTD_DCtx* dctx, void* dst, size_t dst_capacity,
                           const void* src, size_t src_size);
unsigned ZSTD_isError(size_t code);
}
#elif !defined(HS_NO_ZSTD)
#include <zstd.h>
#endif
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <string>
#include <vector>

#include "thrift_compact.h"

namespace hsn {

// ---------------------------------------------------------------------------
// parquet footer model (subset of parquet.thrift)
// ---------------------------------------------------------------------------

enum PhysicalType : int32_t {
  T_BOOLEAN = 0,
  T_INT32 = 1,
  T_INT64 = 2,
  T_INT96 = 3,
  T_FLOAT = 4,
  T_DOUBLE = 5,
  T_BYTE_ARRAY = 6,
  T_FIXED_LEN_BYTE_ARRAY = 7,
};

enum Encoding : int32_t {
  E_PLAIN = 0,
  E_PLAIN_DICTIONARY = 2,
  E_RLE = 3,
  E_RLE_DICTIONARY = 8,
};

enum PageType : int32_t {
  P_DATA_PAGE = 0,
  P_INDEX_PAGE = 1,
  P_DICTIONARY_PAGE = 2,
  P_DATA_PAGE_V2 = 3,
};

struct SchemaElement {
  std::string name;
  int32_t type = -1;             // PhysicalType; -1 for group nodes
  int32_t repetition = 0;        // 0=REQUIRED 1=OPTIONAL 2=REPEATED
  int32_t num_children = 0;
  int32_t type_length = 0;
};

struct ColumnMeta {
  int32_t type = -1;
  std::vector<std::string> path;
  int32_t codec = -1;            // 0 = UNCOMPRESSED
  int64_t num_values = 0;
  int64_t data_page_offset = -1;
  int64_t dictionary_page_offset = -1;
  int64_t total_compressed_size = 0;
};

struct RowGroup {
  std::vector<ColumnMeta> columns;
  int64_t num_rows = 0;
};

struct FileMeta {
  int64_t num_rows = 0;
  std::vector<SchemaElement> schema;
  std::vector<RowGroup> row_groups;
};

static SchemaElement parse_schema_element(Reader& r) {
  SchemaElement e;
  int16_t last = 0;
  Reader::FieldHeader f;
  while (r.read_field(last, f)) {
    switch (f.id) {
      case 1: e.type = static_cast<int32_t>(r.zigzag()); break;
      case 2: e.type_length = static_cast<int32_t>(r.zigzag()); break;
      case 3: e.repetition = static_cast<int32_t>(r.zigzag()); break;
      case 4: e.name = r.binary(); break;
      case 5: e.num_children = static_cast<int32_t>(r.zigzag()); break;
      default: r.skip(f.type);
    }
  }
  return e;
}

static ColumnMeta parse_column_meta(Reader& r) {
  ColumnMeta m;
  int16_t last = 0;
  Reader::FieldHeader f;
  while (r.read_field(last, f)) {
    switch (f.id) {
      case 1: m.type = static_cast<int32_t>(r.zigzag()); break;
      case 3: {
        auto lh = r.read_list();
        for (uint32_t i = 0; i < lh.size; i++) m.path.push_back(r.binary());
        break;
      }
      case 4: m.codec = static_cast<int32_t>(r.zigzag()); break;
      case 5: m.num_values = r.zigzag(); break;
      case 9: m.data_page_offset = r.zigzag(); break;
      case 11: m.dictionary_page_offset = r.zigzag(); break;
      case 7: m.total_compressed_size = r.zigzag(); break;
      default: r.skip(f.type);
    }
  }
  return m;
}

static RowGroup parse_row_group(Reader& r) {
  RowGroup g;
  int16_t last = 0;
  Reader::FieldHeader f;
  while (r.read_field(last, f)) {
    switch (f.id) {
      case 1: {  // columns: list<ColumnChunk>
        auto lh = r.read_list();
        for (uint32_t i = 0; i < lh.size; i++) {
          // ColumnChunk struct
          int16_t cl = 0;
          Reader::FieldHeader cf;
          ColumnMeta m;
          bool have_meta = false;
          while (r.read_field(cl, cf)) {
            if (cf.id == 3 && cf.type == CType::STRUCT) {
              m = parse_column_meta(r);
              have_meta = true;
            } else {
              r.skip(cf.type);
            }
          }
          if (!have_meta) throw ThriftError("column chunk without metadata");
          g.columns.push_back(std::move(m));
        }
        break;
      }
      case 3: g.num_rows = r.zigzag(); break;
      default: r.skip(f.type);
    }
  }
  return g;
}

static FileMeta parse_file_meta(const uint8_t* buf, size_t len) {
  Reader r(buf, len);
  FileMeta fm;
  int16_t last = 0;
  Reader::FieldHeader f;
  while (r.read_field(last, f)) {
    switch (f.id) {
      case 2: {
        auto lh = r.read_list();
        for (uint32_t i = 0; i < lh.size; i++) fm.schema.push_back(parse_schema_element(r));
        break;
      }
      case 3: fm.num_rows = r.zigzag(); break;
      case 4: {
        auto lh = r.read_list();
        for (uint32_t i = 0; i < lh.size; i++) fm.row_groups.push_back(parse_row_group(r));
        break;
      }
      default: r.skip(f.type);
    }
  }
  return fm;
}

// ---------------------------------------------------------------------------
// page headers
// ---------------------------------------------------------------------------

struct PageHeader {
  int32_t type = -1;
  int32_t uncompressed_size = 0;
  int32_t compressed_size = 0;
  // v1
  int32_t num_values = 0;
  int32_t encoding = -1;
  int32_t def_encoding = -1;
  int32_t rep_encoding = -1;
  // v2
  int32_t num_nulls = 0;
  int32_t num_rows = 0;
  int32_t def_bytes = 0;
  int32_t rep_bytes = 0;
  // dictionary
  int32_t dict_num_values = 0;
  int32_t dict_encoding = -1;
  bool v2_is_compressed = true;  // DataPageHeaderV2.is_compressed (default true)
};

// Parses the header and advances *pos past it.
static PageHeader parse_page_header(const uint8_t* base, size_t file_len, size_t* pos) {
  Reader r(base + *pos, file_len - *pos);
  PageHeader h;
  int16_t last = 0;
  Reader::FieldHeader f;
  while (r.read_field(last, f)) {
    switch (f.id) {
      case 1: h.type = static_cast<int32_t>(r.zigzag()); break;
      case 2: h.uncompressed_size = static_cast<int32_t>(r.zigzag()); break;
      case 3: h.compressed_size = static_cast<int32_t>(r.zigzag()); break;
      case 5: {  // DataPageHeader
        int16_t l2 = 0;
        Reader::FieldHeader f2;
        while (r.read_field(l2, f2)) {
          switch (f2.id) {
            case 1: h.num_values = static_cast<int32_t>(r.zigzag()); break;
            case 2: h.encoding = static_cast<int32_t>(r.zigzag()); break;
            case 3: h.def_encoding = static_cast<int32_t>(r.zigzag()); break;
            case 4: h.rep_encoding = static_cast<int32_t>(r.zigzag()); break;
            default: r.skip(f2.type);
          }
        }
        break;
      }
      case 7: {  // DictionaryPageHeader
        int16_t l2 = 0;
        Reader::FieldHeader f2;
        while (r.read_field(l2, f2)) {
          switch (f2.id) {
            case 1: h.dict_num_values = static_cast<int32_t>(r.zigzag()); break;
            case 2: h.dict_encoding = static_cast<int32_t>(r.zigzag()); break;
            default: r.skip(f2.type);
          }
        }
        break;
      }
      case 8: {  // DataPageHeaderV2
        int16_t l2 = 0;
        Reader::FieldHeader f2;
        while (r.read_field(l2, f2)) {
          switch (f2.id) {
            case 1: h.num_values = static_cast<int32_t>(r.zigzag()); break;
            case 2: h.num_nulls = static_cast<int32_t>(r.zigzag()); break;
            case 3: h.num_rows = static_cast<int32_t>(r.zigzag()); break;
            case 4: h.encoding = static_cast<int32_t>(r.zigzag()); break;
            case 5: h.def_bytes = static_cast<int32_t>(r.zigzag()); break;
            case 6: h.rep_bytes = static_cast<int32_t>(r.zigzag()); break;
            case 7: h.v2_is_compressed = f2.bool_value; break;
            default: r.skip(f2.type);
          }
        }
        break;
      }
      default: r.skip(f.type);
    }
  }
  *pos += r.pos(base + *pos);
  return h;
}

// ---------------------------------------------------------------------------
// RLE / bit-packed hybrid (definition levels, dictionary indices)
// ---------------------------------------------------------------------------

static void decode_rle_hybrid(const uint8_t* p, const uint8_t* end, int bit_width,
                              int64_t n, int32_t* out) {
  if (bit_width == 0) {
    std::memset(out, 0, n * sizeof(int32_t));
    return;
  }
  int64_t i = 0;
  const int byte_width = (bit_width + 7) / 8;
  const uint32_t mask = bit_width == 32 ? 0xFFFFFFFFu : ((1u << bit_width) - 1);
  while (i < n) {
    if (p >= end) throw ThriftError("rle: unexpected end of data");
    // varint header
    uint64_t header = 0;
    int shift = 0;
    while (true) {
      if (p >= end) throw ThriftError("rle: truncated header");
      uint8_t b = *p++;
      header |= static_cast<uint64_t>(b & 0x7F) << shift;
      if (!(b & 0x80)) break;
      shift += 7;
    }
    if ((header & 1) == 0) {
      // RLE run
      int64_t run = static_cast<int64_t>(header >> 1);
      if (end - p < byte_width) throw ThriftError("rle: truncated run value");
      uint32_t v = 0;
      for (int b = 0; b < byte_width; b++) v |= static_cast<uint32_t>(p[b]) << (8 * b);
      p += byte_width;
      v &= mask;
      int64_t take = std::min(run, n - i);
      for (int64_t k = 0; k < take; k++) out[i + k] = static_cast<int32_t>(v);
      i += take;
    } else {
      // bit-packed run: groups of 8 values
      int64_t groups = static_cast<int64_t>(header >> 1);
      int64_t vals = groups * 8;
      int64_t bytes = groups * bit_width;
      if (end - p < bytes) throw ThriftError("rle: truncated bit-packed run");
      int64_t take = std::min(vals, n - i);
      uint64_t bitpos = 0;
      int64_t k = 0;
      // bit_width <= 32 and bit offset <= 7, so one unaligned 8-byte load
      // always covers a value; run the run body branch-free while a full
      // load stays inside the run, then finish the tail byte-exactly
      if (bytes >= 8) {
        const int64_t fast = std::min(take, ((bytes - 8) * 8) / bit_width + 1);
        for (; k < fast; k++) {
          uint64_t word;
          std::memcpy(&word, p + (bitpos >> 3), 8);
          out[i + k] = static_cast<int32_t>((word >> (bitpos & 7)) & mask);
          bitpos += bit_width;
        }
      }
      for (; k < take; k++) {
        uint64_t byte_idx = bitpos >> 3;
        int bit_off = static_cast<int>(bitpos & 7);
        uint64_t word = 0;
        int avail = static_cast<int>(std::min<int64_t>(8, bytes - static_cast<int64_t>(byte_idx)));
        std::memcpy(&word, p + byte_idx, avail);
        out[i + k] = static_cast<int32_t>((word >> bit_off) & mask);
        bitpos += bit_width;
      }
      p += bytes;
      i += take;
    }
  }
}

// ---------------------------------------------------------------------------
// reader handle
// ---------------------------------------------------------------------------

struct Handle {
  const uint8_t* map = nullptr;
  size_t len = 0;
  int fd = -1;
  FileMeta meta;
  std::vector<int> leaf_schema_idx;  // schema index of each leaf column
  std::string error;

  ~Handle() {
    if (map) munmap(const_cast<uint8_t*>(map), len);
    if (fd >= 0) close(fd);
  }
};

static bool build_leaves(Handle* h) {
  // flat files only: root at schema[0] with N children, each a leaf
  auto& s = h->meta.schema;
  if (s.empty()) { h->error = "empty schema"; return false; }
  size_t idx = 1;
  for (int32_t c = 0; c < s[0].num_children; c++) {
    if (idx >= s.size()) { h->error = "truncated schema"; return false; }
    if (s[idx].num_children > 0) { h->error = "nested schema unsupported"; return false; }
    if (s[idx].repetition == 2) { h->error = "repeated field unsupported"; return false; }
    h->leaf_schema_idx.push_back(static_cast<int>(idx));
    idx++;
  }
  return true;
}

// ---------------------------------------------------------------------------
// snappy decompression (raw format; the one codec Spark writes by default, so
// externally-written lake files stay on this native path instead of falling
// back to pyarrow. Format: google/snappy format_description.txt)
// ---------------------------------------------------------------------------

static bool snappy_varint(const uint8_t* src, size_t n, size_t* val, size_t* used) {
  size_t v = 0;
  int shift = 0;
  size_t i = 0;
  while (i < n && i < 5) {
    uint8_t b = src[i++];
    v |= static_cast<size_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *val = v;
      *used = i;
      return true;
    }
    shift += 7;
  }
  return false;
}

// Decompresses `src[0..n)` into `dst[0..dst_len)`; throws on malformed input
// or any length mismatch.
static void snappy_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t dst_len) {
  size_t ulen = 0, hdr = 0;
  if (!snappy_varint(src, n, &ulen, &hdr)) throw ThriftError("snappy: bad length header");
  if (ulen != dst_len) throw ThriftError("snappy: uncompressed length mismatch");
  size_t ip = hdr, op = 0;
  while (ip < n) {
    const uint8_t tag = src[ip++];
    uint64_t len;  // 64-bit end to end: a 0xFFFFFFFF extra-byte length must
                   // not wrap on the +1 (or on the narrowing) and desync the parse
    size_t offset = 0;
    switch (tag & 3) {
      case 0: {  // literal; length-1 in high 6 bits (60-63 = extra LE bytes)
        len = (tag >> 2) + 1;
        if (len > 60) {
          const uint32_t extra = static_cast<uint32_t>(len) - 60;
          if (ip + extra > n) throw ThriftError("snappy: truncated literal length");
          len = 0;
          for (uint32_t k = 0; k < extra; k++) len |= static_cast<uint64_t>(src[ip + k]) << (8 * k);
          len += 1;
          ip += extra;
        }
        if (ip + len > n || op + len > dst_len) throw ThriftError("snappy: literal overrun");
        std::memcpy(dst + op, src + ip, len);
        ip += len;
        op += len;
        continue;
      }
      case 1:  // copy, 1-byte offset
        if (ip >= n) throw ThriftError("snappy: truncated copy");
        len = 4 + ((tag >> 2) & 0x7);
        offset = (static_cast<size_t>(tag >> 5) << 8) | src[ip++];
        break;
      case 2:  // copy, 2-byte offset
        if (ip + 2 > n) throw ThriftError("snappy: truncated copy");
        len = (tag >> 2) + 1;
        offset = src[ip] | (static_cast<size_t>(src[ip + 1]) << 8);
        ip += 2;
        break;
      default:  // copy, 4-byte offset
        if (ip + 4 > n) throw ThriftError("snappy: truncated copy");
        len = (tag >> 2) + 1;
        offset = src[ip] | (static_cast<size_t>(src[ip + 1]) << 8) |
                 (static_cast<size_t>(src[ip + 2]) << 16) |
                 (static_cast<size_t>(src[ip + 3]) << 24);
        ip += 4;
        break;
    }
    if (offset == 0 || offset > op || op + len > dst_len)
      throw ThriftError("snappy: bad copy");
    if (offset >= len) {
      std::memcpy(dst + op, dst + op - offset, len);
      op += len;
    } else {
      // overlapping copy replicates a period-`offset` pattern; chunked
      // memcpy with the largest safe multiple of the period (doubles each
      // round) instead of a byte-wise loop
      uint8_t* d = dst + op;
      size_t done = 0;
      while (done < len) {
        const size_t D = offset * ((done + offset) / offset);
        const size_t chunk = std::min(static_cast<size_t>(len) - done, D);
        std::memcpy(d + done, d + done - D, chunk);
        done += chunk;
      }
      op += len;
    }
  }
  if (op != dst_len) throw ThriftError("snappy: short output");
}

enum Codec : int32_t { C_UNCOMPRESSED = 0, C_SNAPPY = 1, C_GZIP = 2, C_ZSTD = 6 };

#ifndef HS_NO_ZSTD
// zstd (parquet codec 6): system libzstd, one reusable decompression context
// per decode thread (context setup is the per-page overhead worth amortizing)
static void zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t dst_len) {
  if (dst_len == 0) return;  // empty values section (all-null v2 page)
  struct TlsDctx {
    ZSTD_DCtx* ctx;
    TlsDctx() : ctx(ZSTD_createDCtx()) {}
    ~TlsDctx() {
      if (ctx) ZSTD_freeDCtx(ctx);
    }
  };
  thread_local TlsDctx tls;
  if (!tls.ctx) throw ThriftError("zstd: context init failed");
  const size_t got = ZSTD_decompressDCtx(tls.ctx, dst, dst_len, src, n);
  if (ZSTD_isError(got) || got != dst_len)
    throw ThriftError("zstd: malformed or short frame");
}
#endif

#ifndef HS_NO_ZLIB
// gzip (parquet codec 2): zlib inflate with gzip-header wrapping. One inflate
// state per thread, reset per page (reinitializing the ~40KB window for every
// page would dominate small-page decode); decode threads release the GIL, so
// thread_local is the right scope.
static void gzip_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t dst_len) {
  if (dst_len == 0) return;  // empty values section (all-null v2 page)
  struct TlsInflate {
    z_stream zs;
    bool ok;
    TlsInflate() : zs(), ok(false) {
      // 16+MAX_WBITS: accept a gzip wrapper (parquet-mr writes gzip members)
      ok = inflateInit2(&zs, 16 + MAX_WBITS) == Z_OK;
    }
    ~TlsInflate() {
      if (ok) inflateEnd(&zs);
    }
  };
  thread_local TlsInflate tls;
  if (!tls.ok) throw ThriftError("gzip: init failed");
  if (inflateReset(&tls.zs) != Z_OK) throw ThriftError("gzip: reset failed");
  tls.zs.next_in = const_cast<uint8_t*>(src);
  tls.zs.avail_in = static_cast<uInt>(n);
  tls.zs.next_out = dst;
  tls.zs.avail_out = static_cast<uInt>(dst_len);
  const int rc = inflate(&tls.zs, Z_FINISH);
  const size_t produced = dst_len - tls.zs.avail_out;
  if (rc != Z_STREAM_END || produced != dst_len)
    throw ThriftError("gzip: malformed or short stream");
}
#endif

static bool codec_supported(int32_t codec) {
#ifndef HS_NO_ZLIB
  if (codec == C_GZIP) return true;
#endif
#ifndef HS_NO_ZSTD
  if (codec == C_ZSTD) return true;
#endif
  return codec == C_UNCOMPRESSED || codec == C_SNAPPY;
}

// decompress a page body with the chunk's codec into scratch
static void page_decompress(int32_t codec, const uint8_t* src, size_t n, uint8_t* dst,
                            size_t dst_len) {
  switch (codec) {
    case C_SNAPPY:
      if (dst_len == 0) {
        size_t ulen = 0, hdr = 0;
        if (!snappy_varint(src, n, &ulen, &hdr) || ulen != 0)
          throw ThriftError("snappy: length mismatch on empty page");
        return;
      }
      snappy_decompress(src, n, dst, dst_len);
      return;
#ifndef HS_NO_ZLIB
    case C_GZIP:
      gzip_decompress(src, n, dst, dst_len);
      return;
#endif
#ifndef HS_NO_ZSTD
    case C_ZSTD:
      zstd_decompress(src, n, dst, dst_len);
      return;
#endif
    default:  // keep codec_supported and this switch decoupled-safe
      throw ThriftError("page_decompress: unsupported codec " + std::to_string(codec));
  }
}

// Per-chunk decode state shared by fixed-width and byte-array paths.
struct ChunkCursor {
  const Handle* h;
  const ColumnMeta* cm;
  size_t pos;        // current byte offset in file
  size_t end;        // end of chunk region
  // dictionary (raw PLAIN-encoded dictionary page payload)
  const uint8_t* dict = nullptr;
  size_t dict_len = 0;  // payload length — the bound for parsing dict entries
  int64_t dict_count = 0;
  bool optional;
  // decompressed page bodies (snappy/gzip); dict buffer outlives data pages
  std::vector<uint8_t> page_scratch;
  std::vector<uint8_t> dict_scratch;

  ChunkCursor(const Handle* h_, const ColumnMeta* cm_, bool opt) : h(h_), cm(cm_), optional(opt) {
    int64_t start = cm->data_page_offset;
    if (cm->dictionary_page_offset > 0 && cm->dictionary_page_offset < start)
      start = cm->dictionary_page_offset;
    pos = static_cast<size_t>(start);
    end = pos + static_cast<size_t>(cm->total_compressed_size);
    if (end > h->len) throw ThriftError("column chunk extends past EOF");
  }
};

struct PageData {
  const uint8_t* values;     // start of encoded values
  size_t values_len;
  int32_t num_values;        // rows in page (incl nulls)
  int32_t encoding;
  std::vector<int32_t> defs; // empty if required
};

// Reads the next data page (resolving any dictionary page first); returns
// false at end of chunk.
static bool next_data_page(ChunkCursor& c, PageData& out) {
  while (c.pos < c.end) {
    size_t pos = c.pos;
    PageHeader ph = parse_page_header(c.h->map, c.h->len, &pos);
    const uint8_t* body = c.h->map + pos;
    if (pos + static_cast<size_t>(ph.compressed_size) > c.h->len)
      throw ThriftError("page body extends past EOF");
    c.pos = pos + static_cast<size_t>(ph.compressed_size);
    const int32_t codec = c.cm->codec;
    if (codec == C_UNCOMPRESSED && ph.compressed_size != ph.uncompressed_size)
      throw ThriftError("compressed pages unsupported (codec mismatch)");

    if (ph.type == P_DICTIONARY_PAGE) {
      if (ph.dict_encoding != E_PLAIN && ph.dict_encoding != E_PLAIN_DICTIONARY)
        throw ThriftError("non-PLAIN dictionary page");
      if (codec != C_UNCOMPRESSED) {
        c.dict_scratch.resize(ph.uncompressed_size);
        page_decompress(codec, body, ph.compressed_size, c.dict_scratch.data(),
                        ph.uncompressed_size);
        c.dict = c.dict_scratch.data();
        c.dict_len = static_cast<size_t>(ph.uncompressed_size);
      } else {
        c.dict = body;
        c.dict_len = static_cast<size_t>(ph.compressed_size);
      }
      c.dict_count = ph.dict_num_values;
      continue;
    }
    if (ph.type == P_INDEX_PAGE) continue;

    if (ph.type == P_DATA_PAGE) {
      // v1: the whole body (levels + values) is compressed as one block
      const uint8_t* p = body;
      const uint8_t* bend = body + ph.compressed_size;
      if (codec != C_UNCOMPRESSED) {
        c.page_scratch.resize(ph.uncompressed_size);
        page_decompress(codec, body, ph.compressed_size, c.page_scratch.data(),
                        ph.uncompressed_size);
        p = c.page_scratch.data();
        bend = p + ph.uncompressed_size;
      }
      out.defs.clear();
      if (c.optional) {
        if (ph.def_encoding != E_RLE) throw ThriftError("non-RLE definition levels");
        if (bend - p < 4) throw ThriftError("truncated def level block");
        uint32_t dlen;
        std::memcpy(&dlen, p, 4);
        p += 4;
        if (static_cast<size_t>(bend - p) < dlen) throw ThriftError("truncated def levels");
        out.defs.resize(ph.num_values);
        decode_rle_hybrid(p, p + dlen, 1, ph.num_values, out.defs.data());
        p += dlen;
      }
      out.values = p;
      out.values_len = static_cast<size_t>(bend - p);
      out.num_values = ph.num_values;
      out.encoding = ph.encoding;
      return true;
    }
    if (ph.type == P_DATA_PAGE_V2) {
      const uint8_t* p = body;
      const uint8_t* bend = body + ph.compressed_size;
      if (ph.rep_bytes > 0) throw ThriftError("repetition levels unsupported");
      out.defs.clear();
      if (ph.def_bytes < 0 || ph.rep_bytes < 0 ||
          static_cast<int64_t>(ph.def_bytes) + ph.rep_bytes > ph.compressed_size ||
          static_cast<int64_t>(ph.def_bytes) + ph.rep_bytes > ph.uncompressed_size)
        throw ThriftError("v2 page level sizes exceed page body");
      if (c.optional) {
        out.defs.resize(ph.num_values);
        decode_rle_hybrid(p, p + ph.def_bytes, 1, ph.num_values, out.defs.data());
      }
      p += ph.def_bytes;
      if (codec != C_UNCOMPRESSED && ph.v2_is_compressed) {
        // v2 keeps rep/def levels uncompressed; only the values section is
        // a compressed block
        const size_t vals_unc = static_cast<size_t>(ph.uncompressed_size) -
                                static_cast<size_t>(ph.def_bytes) -
                                static_cast<size_t>(ph.rep_bytes);
        c.page_scratch.resize(vals_unc);
        page_decompress(codec, p, static_cast<size_t>(bend - p), c.page_scratch.data(), vals_unc);
        out.values = c.page_scratch.data();
        out.values_len = vals_unc;
        out.num_values = ph.num_values;
        out.encoding = ph.encoding;
        return true;
      }
      out.values = p;
      out.values_len = static_cast<size_t>(bend - p);
      out.num_values = ph.num_values;
      out.encoding = ph.encoding;
      return true;
    }
    throw ThriftError("unknown page type " + std::to_string(ph.type));
  }
  return false;
}

static int physical_width(int32_t t, int32_t type_length) {
  switch (t) {
    case T_INT32: return 4;
    case T_INT64: return 8;
    case T_FLOAT: return 4;
    case T_DOUBLE: return 8;
    case T_INT96: return 12;
    case T_FIXED_LEN_BYTE_ARRAY: return type_length;
    default: return -1;
  }
}

// ---------------------------------------------------------------------------
// per-chunk decoders (one row group × one column). These are the shared
// bodies behind both the whole-file readers and the row-group-granular ABI:
// they touch only caller-provided buffers and throw on malformed input, so
// concurrent calls on one read-only Handle are thread-safe.
// ---------------------------------------------------------------------------

// Fixed-width chunk into `dst` (chunk-local row 0 at dst[0]). Returns rows.
static int64_t decode_fixed_chunk(const Handle* h, const SchemaElement& se,
                                  const ColumnMeta& cm, int width, uint8_t* dst,
                                  uint8_t* validity) {
  if (!codec_supported(cm.codec))
    throw ThriftError("unsupported codec " + std::to_string(cm.codec));
  ChunkCursor cur(h, &cm, se.repetition == 1);
  PageData pd;
  std::vector<int32_t> idx;
  int64_t row = 0;
  while (next_data_page(cur, pd)) {
    const int64_t n = pd.num_values;
    int64_t present = n;
    if (!pd.defs.empty()) {
      present = 0;
      for (int32_t d : pd.defs) present += (d != 0);
    }
    if (pd.encoding == E_PLAIN) {
      if (se.type == T_BOOLEAN) {
        // bit-packed LSB-first
        std::vector<uint8_t> vals(present);
        if (pd.values_len * 8 < static_cast<size_t>(present))
          throw ThriftError("truncated boolean page");
        for (int64_t k = 0; k < present; k++)
          vals[k] = (pd.values[k >> 3] >> (k & 7)) & 1;
        if (pd.defs.empty()) {
          std::memcpy(dst + row * width, vals.data(), present);
          if (validity) std::memset(validity + row, 1, n);
        } else {
          int64_t vi = 0;
          for (int64_t k = 0; k < n; k++) {
            bool v = pd.defs[k] != 0;
            dst[(row + k)] = v ? vals[vi++] : 0;
            if (validity) validity[row + k] = v;
          }
        }
        row += n;
        continue;
      }
      if (pd.values_len < static_cast<size_t>(present) * width)
        throw ThriftError("truncated PLAIN page");
      if (pd.defs.empty()) {
        std::memcpy(dst + row * width, pd.values, static_cast<size_t>(n) * width);
        if (validity) std::memset(validity + row, 1, n);
      } else {
        int64_t vi = 0;
        for (int64_t k = 0; k < n; k++) {
          if (pd.defs[k] != 0) {
            std::memcpy(dst + (row + k) * width, pd.values + vi * width, width);
            vi++;
          } else {
            std::memset(dst + (row + k) * width, 0, width);
          }
          if (validity) validity[row + k] = pd.defs[k] != 0;
        }
      }
      row += n;
    } else if (pd.encoding == E_RLE && se.type == T_BOOLEAN) {
      // RLE boolean values (data page v2 writes booleans this way):
      // 4-byte LE length prefix, then RLE/bit-packed hybrid at width 1
      if (pd.values_len < 4) throw ThriftError("truncated RLE boolean page");
      uint32_t rlen;
      std::memcpy(&rlen, pd.values, 4);
      if (pd.values_len < 4 + static_cast<size_t>(rlen))
        throw ThriftError("truncated RLE boolean page body");
      idx.assign(present, 0);
      decode_rle_hybrid(pd.values + 4, pd.values + 4 + rlen, 1, present, idx.data());
      int64_t vi = 0;
      for (int64_t k = 0; k < n; k++) {
        bool v = pd.defs.empty() || pd.defs[k] != 0;
        dst[row + k] = v ? static_cast<uint8_t>(idx[vi++]) : 0;
        if (validity) validity[row + k] = v;
      }
      row += n;
    } else if (pd.encoding == E_RLE_DICTIONARY || pd.encoding == E_PLAIN_DICTIONARY) {
      if (!cur.dict) throw ThriftError("dictionary page missing");
      if (pd.values_len < 1) throw ThriftError("empty dictionary-encoded page");
      int bw = pd.values[0];
      if (bw < 0 || bw > 32) throw ThriftError("bad dictionary bit width");
      if (static_cast<uint64_t>(cur.dict_count) * width > cur.dict_len)
        throw ThriftError("truncated dictionary");  // header claims more entries than payload holds
      idx.assign(present, 0);
      decode_rle_hybrid(pd.values + 1, pd.values + pd.values_len, bw, present, idx.data());
      // hoist the bounds check out of the gather: one pass over the codes,
      // then width-specialized branch-free copies (the per-value check +
      // variable-width memcpy pair dominated dict-coded decode)
      int32_t lo = 0, hi = -1;
      for (int64_t k = 0; k < present; k++) {
        lo = std::min(lo, idx[k]);
        hi = std::max(hi, idx[k]);
      }
      if (present > 0 && (lo < 0 || hi >= cur.dict_count))
        throw ThriftError("dictionary index out of range");
      if (pd.defs.empty()) {
        uint8_t* d = dst + row * width;
        if (width == 8) {
          for (int64_t k = 0; k < n; k++)
            std::memcpy(d + k * 8, cur.dict + static_cast<int64_t>(idx[k]) * 8, 8);
        } else if (width == 4) {
          for (int64_t k = 0; k < n; k++)
            std::memcpy(d + k * 4, cur.dict + static_cast<int64_t>(idx[k]) * 4, 4);
        } else {
          for (int64_t k = 0; k < n; k++)
            std::memcpy(d + k * width, cur.dict + static_cast<int64_t>(idx[k]) * width, width);
        }
        if (validity) std::memset(validity + row, 1, n);
      } else {
        int64_t vi = 0;
        for (int64_t k = 0; k < n; k++) {
          bool v = pd.defs[k] != 0;
          if (v) {
            std::memcpy(dst + (row + k) * width,
                        cur.dict + static_cast<int64_t>(idx[vi++]) * width, width);
          } else {
            std::memset(dst + (row + k) * width, 0, width);
          }
          if (validity) validity[row + k] = v;
        }
      }
      row += n;
    } else {
      throw ThriftError("unsupported encoding " + std::to_string(pd.encoding));
    }
  }
  return row;
}

// BYTE_ARRAY chunk. `offsets` points at this chunk's first row slot and
// `offsets[0]` must already hold *nbytes (the running payload offset in the
// shared `data` buffer, which is NOT pre-offset). With data == NULL only
// offsets/validity are filled (sizing pass). Returns rows; advances *nbytes.
static int64_t decode_binary_chunk(const Handle* h, const SchemaElement& se,
                                   const ColumnMeta& cm, int64_t* offsets,
                                   uint8_t* data, uint8_t* validity,
                                   int64_t* nbytes) {
  if (!codec_supported(cm.codec))
    throw ThriftError("unsupported codec " + std::to_string(cm.codec));
  ChunkCursor cur(h, &cm, se.repetition == 1);
  PageData pd;
  std::vector<int32_t> idx;
  // dictionary spans: resolved lazily per chunk
  std::vector<std::pair<const uint8_t*, uint32_t>> dict_spans;
  bool dict_resolved = false;
  int64_t row = 0;
  while (next_data_page(cur, pd)) {
    const int64_t n = pd.num_values;
    int64_t present = n;
    if (!pd.defs.empty()) {
      present = 0;
      for (int32_t d : pd.defs) present += (d != 0);
    }
    if (pd.encoding == E_PLAIN) {
      const uint8_t* p = pd.values;
      const uint8_t* bend = pd.values + pd.values_len;
      int64_t vi = 0;
      for (int64_t k = 0; k < n; k++) {
        bool v = pd.defs.empty() || pd.defs[k] != 0;
        uint32_t len = 0;
        if (v) {
          if (bend - p < 4) throw ThriftError("truncated byte array length");
          std::memcpy(&len, p, 4);
          p += 4;
          if (static_cast<size_t>(bend - p) < len) throw ThriftError("truncated byte array");
          if (data) std::memcpy(data + *nbytes, p, len);
          p += len;
          vi++;
        }
        *nbytes += len;
        offsets[row + k + 1] = *nbytes;
        if (validity) validity[row + k] = v;
      }
      row += n;
    } else if (pd.encoding == E_RLE_DICTIONARY || pd.encoding == E_PLAIN_DICTIONARY) {
      if (!cur.dict) throw ThriftError("dictionary page missing");
      if (!dict_resolved) {
        dict_spans.clear();
        const uint8_t* p = cur.dict;
        // bound by the dictionary PAYLOAD length: a decompressed dict
        // lives in heap scratch, so any file-offset bound (h->map +
        // cur.end) is meaningless for it — comparing heap pointers
        // against mmap offsets made decode fail or pass depending on
        // address-space layout
        const uint8_t* dend = cur.dict + cur.dict_len;
        for (int64_t d = 0; d < cur.dict_count; d++) {
          if (dend - p < 4) throw ThriftError("truncated dictionary");
          uint32_t len;
          std::memcpy(&len, p, 4);
          p += 4;
          if (static_cast<size_t>(dend - p) < len) throw ThriftError("truncated dictionary");
          dict_spans.emplace_back(p, len);
          p += len;
        }
        dict_resolved = true;
      }
      if (pd.values_len < 1) throw ThriftError("empty dictionary-encoded page");
      int bw = pd.values[0];
      if (bw < 0 || bw > 32) throw ThriftError("bad dictionary bit width");
      idx.assign(present, 0);
      decode_rle_hybrid(pd.values + 1, pd.values + pd.values_len, bw, present, idx.data());
      int64_t vi = 0;
      for (int64_t k = 0; k < n; k++) {
        bool v = pd.defs.empty() || pd.defs[k] != 0;
        uint32_t len = 0;
        if (v) {
          int32_t di = idx[vi++];
          if (di < 0 || di >= (int32_t)dict_spans.size())
            throw ThriftError("dictionary index out of range");
          len = dict_spans[di].second;
          if (data) std::memcpy(data + *nbytes, dict_spans[di].first, len);
        }
        *nbytes += len;
        offsets[row + k + 1] = *nbytes;
        if (validity) validity[row + k] = v;
      }
      row += n;
    } else {
      throw ThriftError("unsupported encoding " + std::to_string(pd.encoding));
    }
  }
  return row;
}

// Dictionary codes for a fully dictionary-encoded chunk: codes[k] is the
// dictionary index of row k, -1 for nulls. Any PLAIN page (dictionary
// fallback overflow) throws — the caller falls back to value decode.
static int64_t decode_codes_chunk(const Handle* h, const SchemaElement& se,
                                  const ColumnMeta& cm, int32_t* codes) {
  if (!codec_supported(cm.codec))
    throw ThriftError("unsupported codec " + std::to_string(cm.codec));
  ChunkCursor cur(h, &cm, se.repetition == 1);
  PageData pd;
  std::vector<int32_t> idx;
  int64_t row = 0;
  while (next_data_page(cur, pd)) {
    const int64_t n = pd.num_values;
    int64_t present = n;
    if (!pd.defs.empty()) {
      present = 0;
      for (int32_t d : pd.defs) present += (d != 0);
    }
    if (pd.encoding != E_RLE_DICTIONARY && pd.encoding != E_PLAIN_DICTIONARY)
      throw ThriftError("page not dictionary-encoded");
    if (!cur.dict) throw ThriftError("dictionary page missing");
    if (pd.values_len < 1) throw ThriftError("empty dictionary-encoded page");
    int bw = pd.values[0];
    if (bw < 0 || bw > 32) throw ThriftError("bad dictionary bit width");
    if (pd.defs.empty()) {
      // required column: unpack straight into the caller's codes slab (no
      // staging copy), then validate the whole page in one pass
      decode_rle_hybrid(pd.values + 1, pd.values + pd.values_len, bw, n, codes + row);
      int32_t lo = 0, hi = -1;
      for (int64_t k = 0; k < n; k++) {
        lo = std::min(lo, codes[row + k]);
        hi = std::max(hi, codes[row + k]);
      }
      if (n > 0 && (lo < 0 || hi >= cur.dict_count))
        throw ThriftError("dictionary index out of range");
    } else {
      idx.assign(present, 0);
      decode_rle_hybrid(pd.values + 1, pd.values + pd.values_len, bw, present, idx.data());
      int32_t lo = 0, hi = -1;
      for (int64_t k = 0; k < present; k++) {
        lo = std::min(lo, idx[k]);
        hi = std::max(hi, idx[k]);
      }
      if (present > 0 && (lo < 0 || hi >= cur.dict_count))
        throw ThriftError("dictionary index out of range");
      int64_t vi = 0;
      for (int64_t k = 0; k < n; k++)
        codes[row + k] = pd.defs[k] != 0 ? idx[vi++] : -1;
    }
    row += n;
  }
  return row;
}

// Per-call error reporting for the row-group ABI: concurrent workers share
// one Handle, so Handle::error (a std::string) is off limits there.
static void fill_err(char* err, int32_t cap, const char* msg) {
  if (!err || cap <= 0) return;
  std::snprintf(err, static_cast<size_t>(cap), "%s", msg);
}

static const ColumnMeta* rg_column(Handle* h, int32_t rg, int32_t col,
                                   const SchemaElement** se_out, char* err,
                                   int32_t err_cap) {
  if (col < 0 || col >= (int32_t)h->leaf_schema_idx.size()) {
    fill_err(err, err_cap, "column index out of range");
    return nullptr;
  }
  if (rg < 0 || rg >= (int32_t)h->meta.row_groups.size()) {
    fill_err(err, err_cap, "row group index out of range");
    return nullptr;
  }
  const auto& g = h->meta.row_groups[rg];
  if (col >= (int32_t)g.columns.size()) {
    fill_err(err, err_cap, "row group missing column");
    return nullptr;
  }
  *se_out = &h->meta.schema[h->leaf_schema_idx[col]];
  return &g.columns[col];
}

}  // namespace hsn

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

using namespace hsn;

extern "C" {

void* hsn_open(const char* path) {
  auto h = std::make_unique<Handle>();
  h->fd = open(path, O_RDONLY);
  if (h->fd < 0) return nullptr;
  struct stat st;
  if (fstat(h->fd, &st) != 0 || st.st_size < 12) return nullptr;
  h->len = static_cast<size_t>(st.st_size);
  void* m = mmap(nullptr, h->len, PROT_READ, MAP_PRIVATE, h->fd, 0);
  if (m == MAP_FAILED) return nullptr;
  h->map = static_cast<const uint8_t*>(m);
  if (std::memcmp(h->map + h->len - 4, "PAR1", 4) != 0) return nullptr;
  uint32_t flen;
  std::memcpy(&flen, h->map + h->len - 8, 4);
  if (flen + 8 > h->len) return nullptr;
  try {
    h->meta = parse_file_meta(h->map + h->len - 8 - flen, flen);
    if (!build_leaves(h.get())) {
      // keep the handle alive so the caller can read the error
      return h.release();
    }
  } catch (const std::exception& e) {
    return nullptr;
  }
  return h.release();
}

void hsn_close(void* hp) { delete static_cast<Handle*>(hp); }

const char* hsn_error(void* hp) {
  auto* h = static_cast<Handle*>(hp);
  return h->error.empty() ? nullptr : h->error.c_str();
}

int64_t hsn_num_rows(void* hp) { return static_cast<Handle*>(hp)->meta.num_rows; }

int32_t hsn_num_columns(void* hp) {
  return static_cast<int32_t>(static_cast<Handle*>(hp)->leaf_schema_idx.size());
}

const char* hsn_column_name(void* hp, int32_t i) {
  auto* h = static_cast<Handle*>(hp);
  if (i < 0 || i >= (int32_t)h->leaf_schema_idx.size()) return nullptr;
  return h->meta.schema[h->leaf_schema_idx[i]].name.c_str();
}

int32_t hsn_column_type(void* hp, int32_t i) {
  auto* h = static_cast<Handle*>(hp);
  if (i < 0 || i >= (int32_t)h->leaf_schema_idx.size()) return -1;
  return h->meta.schema[h->leaf_schema_idx[i]].type;
}

int32_t hsn_column_optional(void* hp, int32_t i) {
  auto* h = static_cast<Handle*>(hp);
  if (i < 0 || i >= (int32_t)h->leaf_schema_idx.size()) return -1;
  return h->meta.schema[h->leaf_schema_idx[i]].repetition == 1 ? 1 : 0;
}

// Decode a fixed-width column (INT32/INT64/FLOAT/DOUBLE/BOOLEAN) across all
// row groups into `out` (num_rows elements of the physical width; BOOLEAN
// decodes to one byte per value). `validity` (nullable) receives 1/0 per row.
// Null slots in `out` are zero-filled. Returns rows decoded, or -1 (see
// hsn_error).
int64_t hsn_read_fixed(void* hp, int32_t col, void* out, uint8_t* validity) {
  auto* h = static_cast<Handle*>(hp);
  if (col < 0 || col >= (int32_t)h->leaf_schema_idx.size()) {
    h->error = "column index out of range";
    return -1;
  }
  const auto& se = h->meta.schema[h->leaf_schema_idx[col]];
  const int width = se.type == T_BOOLEAN ? 1 : physical_width(se.type, se.type_length);
  if (width <= 0) {
    h->error = "not a fixed-width column";
    return -1;
  }
  uint8_t* dst = static_cast<uint8_t*>(out);
  int64_t row = 0;
  try {
    for (const auto& rg : h->meta.row_groups) {
      if (col >= (int32_t)rg.columns.size()) throw ThriftError("row group missing column");
      row += decode_fixed_chunk(h, se, rg.columns[col], width, dst + row * width,
                                validity ? validity + row : nullptr);
    }
  } catch (const std::exception& e) {
    h->error = e.what();
    return -1;
  }
  return row;
}

// BYTE_ARRAY decode. offsets must hold num_rows+1 int64s. If data == NULL the
// function only fills offsets (so the caller can allocate exactly); otherwise
// data must hold offsets[num_rows] bytes. Null rows get empty spans.
// Returns rows decoded or -1.
int64_t hsn_read_binary(void* hp, int32_t col, int64_t* offsets, uint8_t* data,
                        uint8_t* validity) {
  auto* h = static_cast<Handle*>(hp);
  if (col < 0 || col >= (int32_t)h->leaf_schema_idx.size()) {
    h->error = "column index out of range";
    return -1;
  }
  const auto& se = h->meta.schema[h->leaf_schema_idx[col]];
  if (se.type != T_BYTE_ARRAY) {
    h->error = "not a BYTE_ARRAY column";
    return -1;
  }
  int64_t row = 0;
  int64_t nbytes = 0;
  offsets[0] = 0;
  try {
    for (const auto& rg : h->meta.row_groups) {
      if (col >= (int32_t)rg.columns.size()) throw ThriftError("row group missing column");
      row += decode_binary_chunk(h, se, rg.columns[col], offsets + row, data,
                                 validity ? validity + row : nullptr, &nbytes);
    }
  } catch (const std::exception& e) {
    h->error = e.what();
    return -1;
  }
  return row;
}

// ---------------------------------------------------------------------------
// Row-group-granular ABI. One call decodes one (row group × column) chunk
// into caller-provided buffers; the Python side offsets the output pointers
// to the chunk's row slot, so a thread pool fans out across (file, row group,
// column) tasks writing disjoint slices of shared per-column buffers. These
// entry points never touch Handle::error — errors go to the per-call `err`
// buffer (err_cap bytes) — so concurrent calls on one handle are safe.
// ---------------------------------------------------------------------------

int32_t hsn_num_row_groups(void* hp) {
  return static_cast<int32_t>(static_cast<Handle*>(hp)->meta.row_groups.size());
}

int64_t hsn_rg_num_rows(void* hp, int32_t rg) {
  auto* h = static_cast<Handle*>(hp);
  if (rg < 0 || rg >= (int32_t)h->meta.row_groups.size()) return -1;
  return h->meta.row_groups[rg].num_rows;
}

// Parquet codec id (0=uncompressed 1=snappy 2=gzip 6=zstd) of one chunk;
// -1 when out of range. Feeds the hs_native_decode_total{codec} label.
int32_t hsn_rg_codec(void* hp, int32_t rg, int32_t col) {
  auto* h = static_cast<Handle*>(hp);
  if (rg < 0 || rg >= (int32_t)h->meta.row_groups.size()) return -1;
  const auto& g = h->meta.row_groups[rg];
  if (col < 0 || col >= (int32_t)g.columns.size()) return -1;
  return g.columns[col].codec;
}

// Fixed-width chunk decode; `out`/`validity` point at the chunk's first row.
// Returns rows decoded or -1 (message in `err`).
int64_t hsn_read_fixed_rg(void* hp, int32_t rg, int32_t col, void* out,
                          uint8_t* validity, char* err, int32_t err_cap) {
  auto* h = static_cast<Handle*>(hp);
  const SchemaElement* se = nullptr;
  const ColumnMeta* cm = rg_column(h, rg, col, &se, err, err_cap);
  if (!cm) return -1;
  const int width = se->type == T_BOOLEAN ? 1 : physical_width(se->type, se->type_length);
  if (width <= 0) {
    fill_err(err, err_cap, "not a fixed-width column");
    return -1;
  }
  try {
    return decode_fixed_chunk(h, *se, *cm, width, static_cast<uint8_t*>(out), validity);
  } catch (const std::exception& e) {
    fill_err(err, err_cap, e.what());
    return -1;
  }
}

// BYTE_ARRAY chunk decode with chunk-local offsets (offsets[0] = 0; must hold
// chunk rows + 1 int64s). data == NULL sizes only. Returns rows or -1.
int64_t hsn_read_binary_rg(void* hp, int32_t rg, int32_t col, int64_t* offsets,
                           uint8_t* data, uint8_t* validity, char* err,
                           int32_t err_cap) {
  auto* h = static_cast<Handle*>(hp);
  const SchemaElement* se = nullptr;
  const ColumnMeta* cm = rg_column(h, rg, col, &se, err, err_cap);
  if (!cm) return -1;
  if (se->type != T_BYTE_ARRAY) {
    fill_err(err, err_cap, "not a BYTE_ARRAY column");
    return -1;
  }
  int64_t nbytes = 0;
  offsets[0] = 0;
  try {
    return decode_binary_chunk(h, *se, *cm, offsets, data, validity, &nbytes);
  } catch (const std::exception& e) {
    fill_err(err, err_cap, e.what());
    return -1;
  }
}

// Dictionary codes for a fully dictionary-encoded chunk (codes[k] = dict
// index, -1 = null). Fails — distinct "page not dictionary-encoded" message —
// if any data page fell back to PLAIN, so callers can retry as values.
int64_t hsn_read_codes_rg(void* hp, int32_t rg, int32_t col, int32_t* codes,
                          char* err, int32_t err_cap) {
  auto* h = static_cast<Handle*>(hp);
  const SchemaElement* se = nullptr;
  const ColumnMeta* cm = rg_column(h, rg, col, &se, err, err_cap);
  if (!cm) return -1;
  try {
    return decode_codes_chunk(h, *se, *cm, codes);
  } catch (const std::exception& e) {
    fill_err(err, err_cap, e.what());
    return -1;
  }
}

// Dictionary entry count for a chunk: 0 when the chunk has no dictionary
// page, -1 on error. Cheap — parses page headers up to the first data page.
int64_t hsn_rg_dict_count(void* hp, int32_t rg, int32_t col, char* err,
                          int32_t err_cap) {
  auto* h = static_cast<Handle*>(hp);
  const SchemaElement* se = nullptr;
  const ColumnMeta* cm = rg_column(h, rg, col, &se, err, err_cap);
  if (!cm) return -1;
  if (!codec_supported(cm->codec)) {
    fill_err(err, err_cap, "unsupported codec");
    return -1;
  }
  try {
    ChunkCursor cur(h, cm, se->repetition == 1);
    PageData pd;
    next_data_page(cur, pd);  // resolves a leading dictionary page if present
    return cur.dict ? cur.dict_count : 0;
  } catch (const std::exception& e) {
    fill_err(err, err_cap, e.what());
    return -1;
  }
}

// BYTE_ARRAY dictionary payload for one chunk. `offsets` must hold
// dict_count + 1 int64s; with data == NULL only offsets are filled (sizing
// pass). Returns the entry count or -1.
int64_t hsn_read_dict_binary_rg(void* hp, int32_t rg, int32_t col,
                                int64_t* offsets, uint8_t* data, char* err,
                                int32_t err_cap) {
  auto* h = static_cast<Handle*>(hp);
  const SchemaElement* se = nullptr;
  const ColumnMeta* cm = rg_column(h, rg, col, &se, err, err_cap);
  if (!cm) return -1;
  if (se->type != T_BYTE_ARRAY) {
    fill_err(err, err_cap, "not a BYTE_ARRAY column");
    return -1;
  }
  if (!codec_supported(cm->codec)) {
    fill_err(err, err_cap, "unsupported codec");
    return -1;
  }
  try {
    ChunkCursor cur(h, cm, se->repetition == 1);
    PageData pd;
    next_data_page(cur, pd);
    if (!cur.dict) {
      fill_err(err, err_cap, "no dictionary page");
      return -1;
    }
    const uint8_t* p = cur.dict;
    const uint8_t* dend = cur.dict + cur.dict_len;
    int64_t nbytes = 0;
    offsets[0] = 0;
    for (int64_t d = 0; d < cur.dict_count; d++) {
      if (dend - p < 4) throw ThriftError("truncated dictionary");
      uint32_t len;
      std::memcpy(&len, p, 4);
      p += 4;
      if (static_cast<size_t>(dend - p) < len) throw ThriftError("truncated dictionary");
      if (data) std::memcpy(data + nbytes, p, len);
      p += len;
      nbytes += len;
      offsets[d + 1] = nbytes;
    }
    return cur.dict_count;
  } catch (const std::exception& e) {
    fill_err(err, err_cap, e.what());
    return -1;
  }
}

// ---------------------------------------------------------------------------
// Sorted-merge join kernels (host side of the shuffle-free bucketed SMJ).
// Both key arrays must be ascending (the index dialect guarantees per-bucket
// sortedness). One O(n+m) walk replaces two O(n log m) binary-search passes,
// and pair expansion fills the gather indices without intermediate arrays.
// ---------------------------------------------------------------------------

// Per left row, the [lo, hi) span of equal keys on the right.
void hsn_merge_spans(const int64_t* lk, int64_t n, const int64_t* rk, int64_t m,
                     int32_t* lo, int32_t* hi) {
  int64_t r = 0;
  int64_t i = 0;
  while (i < n) {
    const int64_t key = lk[i];
    while (r < m && rk[r] < key) r++;
    int64_t r2 = r;
    while (r2 < m && rk[r2] == key) r2++;
    int64_t i2 = i;
    while (i2 < n && lk[i2] == key) i2++;
    for (int64_t j = i; j < i2; j++) {
      lo[j] = static_cast<int32_t>(r);
      hi[j] = static_cast<int32_t>(r2);
    }
    i = i2;
    r = r2;
  }
}

// Expand spans into (left row, right row) gather indices. `lidx`/`ridx` must
// hold sum(hi-lo) elements; returns the number written.
int64_t hsn_expand_pairs(const int32_t* lo, const int32_t* hi, int64_t n,
                         int32_t* lidx, int32_t* ridx) {
  int64_t off = 0;
  for (int64_t i = 0; i < n; i++) {
    const int32_t a = lo[i], b = hi[i];
    for (int32_t r = a; r < b; r++) {
      lidx[off] = static_cast<int32_t>(i);
      ridx[off] = r;
      off++;
    }
  }
  return off;
}

// Standalone raw-snappy decompression (used by the Python Avro codec for
// snappy-compressed blocks; Avro frames carry the uncompressed size via the
// snappy preamble). Returns 0 on success, -1 on malformed input.
int32_t hsn_snappy_decompress(const uint8_t* src, int64_t src_len, uint8_t* dst,
                              int64_t dst_len) {
  try {
    hsn::snappy_decompress(src, static_cast<size_t>(src_len), dst,
                           static_cast<size_t>(dst_len));
    return 0;
  } catch (const std::exception&) {
    return -1;
  }
}

// Uncompressed length from a raw-snappy preamble; -1 on malformed input.
int64_t hsn_snappy_uncompressed_length(const uint8_t* src, int64_t src_len) {
  size_t val = 0, used = 0;
  if (!hsn::snappy_varint(src, static_cast<size_t>(src_len), &val, &used)) return -1;
  return static_cast<int64_t>(val);
}

}  // extern "C"
