// Native token-cache file: the TPU-host analogue of the Arrow cache HF
// datasets keeps behind `dataset.map` (the reference's `GRPO/grpo.py:266-268`
// relies on it so re-runs skip tokenization). A single binary file holds the
// ragged tokenized corpus; readers mmap it and pack batches straight from
// the flat buffer (pack_left_pad in bucketing.cpp), so a 250k-prompt corpus
// loads in O(pages touched), not O(re-tokenize).
//
// Layout (little-endian, 8-byte aligned):
//   [0]  u64 magic   0x4e524c48'544f4b31  ("NRLH" "TOK1")
//   [8]  u64 n_rows
//   [16] u64 fingerprint  (caller-supplied hash of tokenizer/source/params)
//   [24] i64 offsets[n_rows+1]            (offsets[0] == 0)
//   [..] i32 tokens[offsets[n_rows]]
//
// C ABI + ctypes (no pybind11 in the image); every entry point returns an
// error code instead of throwing. Python fallback lives in data/token_cache.py.

#include <cstdint>
#include <cstdio>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {
constexpr uint64_t kMagic = 0x4e524c48544f4b31ull;

struct Header {
  uint64_t magic;
  uint64_t n_rows;
  uint64_t fingerprint;
};
}  // namespace

extern "C" {

// Write the cache atomically (tmp file + rename). Returns 0 on success.
int token_cache_write(const char* path, const int32_t* flat,
                      const int64_t* offsets, int64_t n_rows,
                      uint64_t fingerprint) {
  if (n_rows < 0 || offsets[0] != 0) return -1;
  char tmp[4096];
  if (snprintf(tmp, sizeof(tmp), "%s.%d.tmp", path, getpid()) >=
      static_cast<int>(sizeof(tmp)))
    return -2;
  FILE* f = fopen(tmp, "wb");
  if (!f) return -3;
  Header h{kMagic, static_cast<uint64_t>(n_rows), fingerprint};
  int64_t total = offsets[n_rows];
  bool ok = fwrite(&h, sizeof(h), 1, f) == 1 &&
            fwrite(offsets, sizeof(int64_t), n_rows + 1, f) ==
                static_cast<size_t>(n_rows + 1) &&
            (total == 0 ||
             fwrite(flat, sizeof(int32_t), total, f) ==
                 static_cast<size_t>(total));
  ok = (fclose(f) == 0) && ok;
  if (!ok || rename(tmp, path) != 0) {
    remove(tmp);
    return -4;
  }
  return 0;
}

// Validate the header; returns 0 and fills n_rows/total_tokens on success,
// <0 on missing/corrupt/fingerprint-mismatch (callers then re-tokenize).
int token_cache_stat(const char* path, uint64_t fingerprint, int64_t* n_rows,
                     int64_t* total_tokens) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  Header h;
  int64_t first_last[1];
  int rc = -2;
  struct stat st;
  if (fread(&h, sizeof(h), 1, f) == 1 && h.magic == kMagic &&
      h.fingerprint == fingerprint && fstat(fileno(f), &st) == 0 &&
      // bound n_rows BEFORE any offset arithmetic: a corrupt header's u64
      // n_rows can overflow the signed fseek offset (UB) and the expected
      // size computation. The offsets table alone needs
      // (n_rows+1)*8 bytes inside the file.
      st.st_size >= static_cast<int64_t>(sizeof(Header) + sizeof(int64_t)) &&
      h.n_rows < (static_cast<uint64_t>(st.st_size) - sizeof(Header)) /
                     sizeof(int64_t)) {
    // last offset sits right before the token payload; bound it against
    // the space actually left for the payload BEFORE the *4 multiply — a
    // corrupt value near 2^62 would otherwise wrap the uint64 product back
    // onto the true file size and hand the caller a view spanning ~2^64
    // bytes past the mapping
    int64_t payload_cap = (st.st_size - static_cast<int64_t>(sizeof(Header)) -
                           static_cast<int64_t>((h.n_rows + 1) *
                                                sizeof(int64_t))) /
                          static_cast<int64_t>(sizeof(int32_t));
    if (payload_cap >= 0 &&
        fseek(f, sizeof(Header) + h.n_rows * sizeof(int64_t), SEEK_SET) == 0 &&
        fread(first_last, sizeof(int64_t), 1, f) == 1 &&
        first_last[0] >= 0 && first_last[0] <= payload_cap) {
      int64_t expect = sizeof(Header) +
                       (h.n_rows + 1) * sizeof(int64_t) +
                       first_last[0] * sizeof(int32_t);
      if (st.st_size == expect) {
        *n_rows = static_cast<int64_t>(h.n_rows);
        *total_tokens = first_last[0];
        rc = 0;
      }
    }
  }
  fclose(f);
  return rc;
}

// mmap the cache read-only. Fills pointers into the mapping; the caller owns
// the mapping via token_cache_close(map_base, map_len). Returns 0 on success.
int token_cache_open(const char* path, uint64_t fingerprint,
                     void** map_base, int64_t* map_len,
                     const int64_t** offsets, const int32_t** flat,
                     int64_t* n_rows) {
  int64_t rows = 0, total = 0;
  int rc = token_cache_stat(path, fingerprint, &rows, &total);
  if (rc != 0) return rc;
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -5;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return -6;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);  // mapping persists past close
  if (base == MAP_FAILED) return -7;
  *map_base = base;
  *map_len = st.st_size;
  auto* p = static_cast<const char*>(base);
  *offsets = reinterpret_cast<const int64_t*>(p + sizeof(Header));
  *flat = reinterpret_cast<const int32_t*>(p + sizeof(Header) +
                                           (rows + 1) * sizeof(int64_t));
  *n_rows = rows;
  return 0;
}

void token_cache_close(void* map_base, int64_t map_len) {
  if (map_base) munmap(map_base, map_len);
}

}  // extern "C"
