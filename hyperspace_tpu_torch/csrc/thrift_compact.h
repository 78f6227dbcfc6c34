// Minimal Thrift Compact Protocol reader — just what the Parquet footer and
// page headers need. Hand-written against the thrift compact spec; the
// reference framework has no native code at all (SURVEY.md §2 "Native
// components: none"), so this file has no reference counterpart: it exists to
// feed TPU HBM from Parquet without a JVM or even pyarrow in the hot loop.
#pragma once

#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace hsn {

struct ThriftError : std::runtime_error {
  explicit ThriftError(const std::string& m) : std::runtime_error(m) {}
};

// compact-protocol wire types
enum class CType : uint8_t {
  STOP = 0,
  TRUE_ = 1,
  FALSE_ = 2,
  BYTE = 3,
  I16 = 4,
  I32 = 5,
  I64 = 6,
  DOUBLE = 7,
  BINARY = 8,
  LIST = 9,
  SET = 10,
  MAP = 11,
  STRUCT = 12,
};

class Reader {
 public:
  Reader(const uint8_t* data, size_t len) : p_(data), end_(data + len) {}

  size_t pos(const uint8_t* base) const { return static_cast<size_t>(p_ - base); }
  const uint8_t* cursor() const { return p_; }

  uint64_t varint() {
    uint64_t v = 0;
    int shift = 0;
    while (true) {
      need(1);
      uint8_t b = *p_++;
      v |= static_cast<uint64_t>(b & 0x7F) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
      if (shift > 63) throw ThriftError("varint overflow");
    }
  }

  int64_t zigzag() {
    uint64_t v = varint();
    return static_cast<int64_t>(v >> 1) ^ -static_cast<int64_t>(v & 1);
  }

  std::string binary() {
    uint64_t n = varint();
    need(n);
    std::string s(reinterpret_cast<const char*>(p_), n);
    p_ += n;
    return s;
  }

  void skip_binary() {
    uint64_t n = varint();
    need(n);
    p_ += n;
  }

  double f64() {
    need(8);
    double d;
    std::memcpy(&d, p_, 8);  // compact protocol: little-endian
    p_ += 8;
    return d;
  }

  struct FieldHeader {
    int16_t id;
    CType type;
    bool bool_value;  // booleans are encoded in the type nibble
  };

  // Returns false at STOP. last_id threads the running field-id delta.
  bool read_field(int16_t& last_id, FieldHeader& out) {
    need(1);
    uint8_t b = *p_++;
    if (b == 0) return false;
    uint8_t delta = b >> 4;
    auto type = static_cast<CType>(b & 0x0F);
    int16_t id = delta ? static_cast<int16_t>(last_id + delta)
                       : static_cast<int16_t>(zigzag());
    last_id = id;
    out.id = id;
    out.type = type;
    out.bool_value = (type == CType::TRUE_);
    return true;
  }

  struct ListHeader {
    uint32_t size;
    CType elem_type;
  };

  ListHeader read_list() {
    need(1);
    uint8_t b = *p_++;
    uint32_t size = b >> 4;
    auto et = static_cast<CType>(b & 0x0F);
    if (size == 15) size = static_cast<uint32_t>(varint());
    return {size, et};
  }

  void skip(CType t) {
    switch (t) {
      case CType::TRUE_:
      case CType::FALSE_:
        return;  // value was in the field header
      case CType::BYTE:
        need(1);
        p_++;
        return;
      case CType::I16:
      case CType::I32:
      case CType::I64:
        varint();
        return;
      case CType::DOUBLE:
        need(8);
        p_ += 8;
        return;
      case CType::BINARY:
        skip_binary();
        return;
      case CType::LIST:
      case CType::SET: {
        ListHeader lh = read_list();
        for (uint32_t i = 0; i < lh.size; i++) skip_elem(lh.elem_type);
        return;
      }
      case CType::MAP: {
        uint64_t n = varint();
        if (n == 0) return;
        need(1);
        uint8_t kv = *p_++;
        auto kt = static_cast<CType>(kv >> 4);
        auto vt = static_cast<CType>(kv & 0x0F);
        for (uint64_t i = 0; i < n; i++) {
          skip_elem(kt);
          skip_elem(vt);
        }
        return;
      }
      case CType::STRUCT: {
        int16_t last = 0;
        FieldHeader fh;
        while (read_field(last, fh)) skip(fh.type);
        return;
      }
      default:
        throw ThriftError("cannot skip thrift type " + std::to_string(int(t)));
    }
  }

  // list/map elements encode bools as full bytes, unlike struct fields
  void skip_elem(CType t) {
    if (t == CType::TRUE_ || t == CType::FALSE_) {
      need(1);
      p_++;
      return;
    }
    skip(t);
  }

  bool elem_bool(CType t) {
    (void)t;
    need(1);
    return *p_++ == 1;
  }

 private:
  void need(uint64_t n) {
    if (static_cast<uint64_t>(end_ - p_) < n) throw ThriftError("thrift: unexpected EOF");
  }
  const uint8_t* p_;
  const uint8_t* end_;
};

}  // namespace hsn
