// Multithreaded SPRITE/ChIA-Drop .clusters parser.
//
// Behavioural parity with the reference's parse_file (ref:
// Code/process.py:42-87) and with the Python fallback in
// matcha_tpu_torch/data/clusters.py (_parse_lines, the correctness oracle):
//   * one cluster per line: id<TAB>chrom:coord<TAB>chrom:coord...
//   * raw member count (tab-separated fields after the id, INCLUDING
//     empty fields) outside [2, max_cluster_size*50] -> line skipped
//   * members on unknown chromosomes dropped
//   * coordinate floored to the bin grid: node = first_node[chrom] +
//     coord / resolution
//   * per-line dedup + sort; clusters with <2 or >max_cluster_size
//     distinct nodes dropped
//   * cluster file order preserved in the output CSR
//
// The Python loop is ~1-2 MB/s per core on real SPRITE files (string
// splits + int() per member); this kernel mmaps the file, splits it into
// per-thread byte ranges aligned to newlines, parses with raw pointer
// scans, and concatenates the per-thread CSR pieces in order.
//
// ctypes ABI (see cluster_native.py): parse -> opaque handle -> sizes ->
// fill caller-allocated numpy buffers -> free.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct ChromTable {
  // tiny (~24 entries): linear scan with length + memcmp beats hashing
  std::vector<std::pair<std::string, int32_t>> names;
  int32_t find(const char* s, size_t len) const {
    for (const auto& kv : names) {
      if (kv.first.size() == len &&
          std::memcmp(kv.first.data(), s, len) == 0)
        return kv.second;
    }
    return -1;
  }
};

struct Piece {
  std::vector<int32_t> flat;
  std::vector<int32_t> sizes;
};

struct Result {
  std::vector<int32_t> flat;
  std::vector<int64_t> offsets;
};

inline bool is_space(char c) {
  return c == ' ' || c == '\r' || c == '\v' || c == '\f';
}

// Parse a coordinate with Python int() semantics: optional surrounding
// whitespace, optional sign, >= 1 digit, nothing else.  Returns false on
// malformed input (the Python oracle raises ValueError there — silent
// wrong-bin placement would be data corruption).
inline bool parse_coord(const char* p, const char* end, int64_t* out_val) {
  while (p < end && is_space(*p)) ++p;
  bool neg = false;
  if (p < end && (*p == '+' || *p == '-')) {
    neg = (*p == '-');
    ++p;
  }
  if (p >= end || *p < '0' || *p > '9') return false;
  int64_t v = 0;
  while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
  while (p < end && is_space(*p)) ++p;
  if (p != end) return false;
  *out_val = neg ? -v : v;
  return true;
}

// floor division (Python // semantics; coords can legally be parsed
// negative even if biologically nonsensical — match the oracle exactly)
inline int64_t floordiv(int64_t a, int64_t b) {
  int64_t q = a / b, r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

// parse [begin, end): every line fully contained (caller aligns bounds)
void parse_range(const char* begin, const char* end, const ChromTable& ct,
                 const int64_t* first_node, int64_t resolution,
                 int32_t max_cluster_size, Piece* out,
                 std::atomic<int>* error) {
  const int64_t raw_cap = int64_t(max_cluster_size) * 50;
  std::vector<int32_t> nodes;
  nodes.reserve(raw_cap);
  const char* p = begin;
  while (p < end) {
    const char* nl = static_cast<const char*>(
        std::memchr(p, '\n', size_t(end - p)));
    const char* line_end = nl ? nl : end;
    // count raw members = number of tab characters on the line
    int64_t n_raw = 0;
    for (const char* q = p; q < line_end; ++q) n_raw += (*q == '\t');
    if (n_raw >= 2 && n_raw <= raw_cap) {
      nodes.clear();
      // skip field 0 (cluster id)
      const char* f = static_cast<const char*>(
          std::memchr(p, '\t', size_t(line_end - p)));
      while (f) {
        ++f;  // start of member field
        const char* fe = static_cast<const char*>(
            std::memchr(f, '\t', size_t(line_end - f)));
        const char* field_end = fe ? fe : line_end;
        const char* colon = static_cast<const char*>(
            std::memchr(f, ':', size_t(field_end - f)));
        if (colon) {
          int32_t ci = ct.find(f, size_t(colon - f));
          if (ci >= 0) {
            int64_t coord;
            if (!parse_coord(colon + 1, field_end, &coord)) {
              error->store(1, std::memory_order_relaxed);
              return;
            }
            nodes.push_back(
                int32_t(first_node[ci] + floordiv(coord, resolution)));
          }
        }
        f = fe;
      }
      std::sort(nodes.begin(), nodes.end());
      nodes.erase(std::unique(nodes.begin(), nodes.end()), nodes.end());
      int64_t n = int64_t(nodes.size());
      if (n >= 2 && n <= max_cluster_size) {
        out->flat.insert(out->flat.end(), nodes.begin(), nodes.end());
        out->sizes.push_back(int32_t(n));
      }
    }
    if (!nl) break;
    p = nl + 1;
  }
}

}  // namespace

extern "C" {

// Returns 0 on success, negative on error.  chrom_blob holds the
// concatenated chromosome names; chrom_lens their lengths.
int32_t matcha_parse_clusters(const char* path, const char* chrom_blob,
                              const int32_t* chrom_lens, int32_t n_chroms,
                              const int64_t* first_node, int64_t resolution,
                              int32_t max_cluster_size, int32_t n_threads,
                              void** out_handle) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (::fstat(fd, &st) != 0) {
    ::close(fd);
    return -2;
  }
  size_t size = size_t(st.st_size);
  ChromTable ct;
  {
    const char* b = chrom_blob;
    for (int32_t i = 0; i < n_chroms; ++i) {
      ct.names.emplace_back(std::string(b, size_t(chrom_lens[i])), i);
      b += chrom_lens[i];
    }
  }
  auto* res = new Result();
  if (size > 0) {
    const char* data = static_cast<const char*>(
        ::mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0));
    if (data == MAP_FAILED) {
      ::close(fd);
      delete res;
      return -3;
    }
    int32_t T = std::max(1, n_threads);
    if (size < (1u << 20)) T = 1;  // small files: no thread overhead
    const size_t nT = size_t(T);
    std::vector<Piece> pieces{nT};
    std::atomic<int> error{0};
    std::vector<std::thread> threads;
    std::vector<const char*> starts(size_t(T) + 1);
    starts[0] = data;
    for (int32_t t = 1; t < T; ++t) {
      const char* s = data + (size * size_t(t)) / size_t(T);
      const char* nl = static_cast<const char*>(
          std::memchr(s, '\n', size_t(data + size - s)));
      starts[size_t(t)] = nl ? nl + 1 : data + size;
    }
    starts[size_t(T)] = data + size;
    for (int32_t t = 0; t < T; ++t) {
      threads.emplace_back(parse_range, starts[size_t(t)],
                           starts[size_t(t) + 1], std::cref(ct), first_node,
                           resolution, max_cluster_size, &pieces[size_t(t)],
                           &error);
    }
    for (auto& th : threads) th.join();
    ::munmap(const_cast<char*>(data), size);
    if (error.load()) {
      ::close(fd);
      delete res;
      return -4;  // malformed coordinate (Python oracle raises ValueError)
    }

    size_t total_flat = 0, total_clusters = 0;
    for (const auto& pc : pieces) {
      total_flat += pc.flat.size();
      total_clusters += pc.sizes.size();
    }
    res->flat.reserve(total_flat);
    res->offsets.reserve(total_clusters + 1);
    res->offsets.push_back(0);
    for (const auto& pc : pieces) {
      res->flat.insert(res->flat.end(), pc.flat.begin(), pc.flat.end());
      for (int32_t s : pc.sizes)
        res->offsets.push_back(res->offsets.back() + s);
    }
  } else {
    res->offsets.push_back(0);
  }
  ::close(fd);
  *out_handle = res;
  return 0;
}

void matcha_cluster_result_sizes(void* handle, int64_t* n_flat,
                                 int64_t* n_clusters) {
  auto* res = static_cast<Result*>(handle);
  *n_flat = int64_t(res->flat.size());
  *n_clusters = int64_t(res->offsets.size()) - 1;
}

void matcha_cluster_result_fill(void* handle, int32_t* flat,
                                int64_t* offsets) {
  auto* res = static_cast<Result*>(handle);
  std::memcpy(flat, res->flat.data(), res->flat.size() * sizeof(int32_t));
  std::memcpy(offsets, res->offsets.data(),
              res->offsets.size() * sizeof(int64_t));
}

void matcha_cluster_result_free(void* handle) {
  delete static_cast<Result*>(handle);
}

}  // extern "C"
