// The MultiSlot text parser of the port's datasets (dataset/native.py).
//
// A copy of the JAX package's csrc/data_feed.cc, the twin of the
// reference's MultiSlotDataFeed parse loop (paddle/fluid/framework/
// data_feed.cc CheckFileFormat / ParseOneInstanceFromPipe): each text line
// holds, for every slot in order, "<num> <value>*num" where values are
// floats or uint64 feasign ids. A batch-oriented C library called through
// ctypes in two passes (size, then fill); files fan out over threads in
// Python. It runs on the host: the card sees the collated batches.
//
// Build (dataset/native.py does it at first use):
//   g++ -O3 -shared -fPIC -o libdata_feed.so data_feed.cc
#include <cctype>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// Pass 1: scan the buffer, count instances and total values per slot.
// slot_types: one char per slot, 'f' (float) or 'u' (uint64).
// out_counts: int64[num_slots] -> total value count per slot.
// Returns number of instances (lines), or -1 on malformed input.
long long mslot_count(const char* buf, long long len, int num_slots,
                      const char* slot_types, long long* out_counts) {
  for (int s = 0; s < num_slots; ++s) out_counts[s] = 0;
  const char* p = buf;
  const char* end = buf + len;
  long long instances = 0;
  while (p < end) {
    // skip blank lines
    while (p < end && (*p == '\n' || *p == '\r')) ++p;
    if (p >= end) break;
    for (int s = 0; s < num_slots; ++s) {
      char* next;
      errno = 0;
      long num = strtol(p, &next, 10);
      if (next == p || num <= 0 || errno == ERANGE) return -1;
      p = next;
      out_counts[s] += num;
      for (long i = 0; i < num; ++i) {
        errno = 0;
        if (slot_types[s] == 'f') {
          strtof(p, &next);
        } else {
          strtoull(p, &next, 10);
        }
        if (next == p || errno == ERANGE) return -1;
        p = next;
      }
    }
    // only whitespace may trail (hadoop reduce adds '\t')
    while (p < end && *p != '\n') {
      if (!isspace((unsigned char)*p)) return -1;
      ++p;
    }
    ++instances;
  }
  return instances;
}

// Pass 2: fill caller-allocated buffers.
// For each slot s: values land in float32* or uint64* value_ptrs[s];
// lengths[inst * num_slots + s] = id count of that instance/slot.
// Returns instances filled, or -1 on malformed input.
long long mslot_fill(const char* buf, long long len, int num_slots,
                     const char* slot_types, void** value_ptrs,
                     int* lengths) {
  const char* p = buf;
  const char* end = buf + len;
  long long instances = 0;
  long long* offs = (long long*)calloc(num_slots, sizeof(long long));
  if (!offs) return -1;
  while (p < end) {
    while (p < end && (*p == '\n' || *p == '\r')) ++p;
    if (p >= end) break;
    for (int s = 0; s < num_slots; ++s) {
      char* next;
      long num = strtol(p, &next, 10);
      if (next == p || num <= 0) { free(offs); return -1; }
      p = next;
      lengths[instances * num_slots + s] = (int)num;
      if (slot_types[s] == 'f') {
        float* dst = (float*)value_ptrs[s] + offs[s];
        for (long i = 0; i < num; ++i) {
          dst[i] = strtof(p, &next);
          if (next == p) { free(offs); return -1; }
          p = next;
        }
      } else {
        uint64_t* dst = (uint64_t*)value_ptrs[s] + offs[s];
        for (long i = 0; i < num; ++i) {
          dst[i] = strtoull(p, &next, 10);
          if (next == p) { free(offs); return -1; }
          p = next;
        }
      }
      offs[s] += num;
    }
    while (p < end && *p != '\n') {
      if (!isspace((unsigned char)*p)) { free(offs); return -1; }
      ++p;
    }
    ++instances;
  }
  free(offs);
  return instances;
}

}  // extern "C"
