// The port's own copy of the JAX package's native/splicer.cc; the same
// scanner, built on first use by native/proto_splicer.py.
//
// Zero-copy protobuf field location: find a (possibly nested) string field
// in serialized protobuf bytes WITHOUT a full parse or schema.
//
// Native equivalent of the reference's ProtoSplicer (ProtoSplicer.java:29 —
// extractId/spliceId over netty ByteBufs): the data plane treats inference
// payloads as opaque bytes; when the model id rides inside the request
// message body (dataplane config idExtractionPath), this locates it so the
// Python layer can read or replace it with minimal copying.
//
// Exported C ABI (ctypes):
//   int mm_find_path(const uint8_t* data, size_t len,
//                    const uint32_t* path, size_t npath,
//                    size_t* out /* 3*npath: {len_varint_off, payload_off,
//                                             payload_len} per level */);
// Returns 0 on success, -1 if the path's field is absent, -2 on malformed
// input. Scans each message level linearly once: O(len) worst case, no
// allocation.
//
// Build: g++ -O2 -shared -fPIC -o libmmsplicer.so splicer.cc

#include <cstddef>
#include <cstdint>

namespace {

// Reads a base-128 varint; advances *pos. Returns false on overrun/overflow.
bool read_varint(const uint8_t* data, size_t len, size_t* pos, uint64_t* out) {
  uint64_t result = 0;
  int shift = 0;
  while (*pos < len && shift <= 63) {
    uint8_t b = data[(*pos)++];
    result |= static_cast<uint64_t>(b & 0x7f) << shift;
    if ((b & 0x80) == 0) {
      *out = result;
      return true;
    }
    shift += 7;
  }
  return false;
}

// Skips a field body of the given wire type. Returns false on malformed.
bool skip_field(const uint8_t* data, size_t len, size_t* pos, uint32_t wire) {
  uint64_t v;
  switch (wire) {
    case 0:  // varint
      return read_varint(data, len, pos, &v);
    case 1:  // fixed64
      if (*pos + 8 > len) return false;
      *pos += 8;
      return true;
    case 2:  // length-delimited
      if (!read_varint(data, len, pos, &v)) return false;
      // Overflow-safe bound: *pos + v can wrap uint64 on a crafted varint,
      // turning this into an infinite scan loop on untrusted payloads.
      if (v > len - *pos) return false;
      *pos += v;
      return true;
    case 5:  // fixed32
      if (*pos + 4 > len) return false;
      *pos += 4;
      return true;
    default:  // groups (3/4) unsupported, as in the reference
      return false;
  }
}

}  // namespace

extern "C" int mm_find_path(const uint8_t* data, size_t len,
                            const uint32_t* path, size_t npath, size_t* out) {
  if (npath == 0) return -1;
  size_t begin = 0, end = len;
  for (size_t level = 0; level < npath; ++level) {
    const uint32_t want = path[level];
    size_t pos = begin;
    bool found = false;
    while (pos < end) {
      uint64_t key;
      if (!read_varint(data, end, &pos, &key)) return -2;
      const uint32_t field = static_cast<uint32_t>(key >> 3);
      const uint32_t wire = static_cast<uint32_t>(key & 7);
      if (field == want && wire == 2) {
        size_t len_off = pos;
        uint64_t flen;
        if (!read_varint(data, end, &pos, &flen)) return -2;
        if (flen > end - pos) return -2;  // overflow-safe (see skip_field)
        out[3 * level + 0] = len_off;
        out[3 * level + 1] = pos;
        out[3 * level + 2] = static_cast<size_t>(flen);
        begin = pos;
        end = pos + flen;
        found = true;
        break;
      }
      if (!skip_field(data, end, &pos, wire)) return -2;
    }
    if (!found) return -1;
  }
  return 0;
}
