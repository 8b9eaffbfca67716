// Host-side readers for pygemma_tpu_torch, exposed through a C ABI for
// ctypes (native/bed_native.py builds them with g++ at first use).  This is
// host code, not device kernels.
//
// Role parity with the reference's native IO layer:
//   * pygemma_decode_bed: a multithreaded .bed 2-bit decoder (the reference
//     uses pysnptools for this, experiments/wtccc/run_pygemma.py:381-400);
//     it fills the float32 (n, p) dosage matrix that the dense CLI path
//     hands to the scan.
//   * pygemma_read_filtered_matrix: stream a large whitespace-separated
//     ASCII matrix keeping only the rows and columns of a sorted index set,
//     one line at a time (the reference's Rcpp matrix_reader,
//     experiments/benchmarks/matrix_reader.cpp:29-101).
//
// Each thread decodes tiles of kTile SNPs: it reads the tile's SNP-major
// rows, then writes each sample's kTile dosages as one contiguous run of
// the sample-major output, so a store touches a few cache lines rather
// than one line per value.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kTile = 64;

}  // namespace

extern "C" {

// Decode the SNP columns snp_idx[0..p_sel) of a SNP-major .bed file into
// the float32 (n_samples, p_sel) row-major matrix `out`.  count_a1 counts
// the A1 allele (00 -> 2, 10 -> 1, 11 -> 0); otherwise A2.  Missing (01)
// decodes to NaN.  n_threads <= 0 takes the hardware's thread count.
// Returns 0 on success, 1 when the file cannot be opened, 2 when a seek
// fails and 3 on a short read.
int pygemma_decode_bed(const char* path, int64_t n_samples,
                       int64_t bytes_per_snp, const int64_t* snp_idx,
                       int64_t p_sel, int count_a1, int n_threads,
                       float* out) {
  float table[256][4];
  const float nanv = std::nanf("");
  for (int byte = 0; byte < 256; ++byte) {
    for (int k = 0; k < 4; ++k) {
      switch ((byte >> (2 * k)) & 0b11) {
        case 0b00: table[byte][k] = count_a1 ? 2.0f : 0.0f; break;
        case 0b01: table[byte][k] = nanv; break;
        case 0b10: table[byte][k] = 1.0f; break;
        default:   table[byte][k] = count_a1 ? 0.0f : 2.0f; break;
      }
    }
  }

  const int64_t n_tiles = (p_sel + kTile - 1) / kTile;
  if (n_threads <= 0) {
    n_threads = static_cast<int>(
        std::max(1u, std::thread::hardware_concurrency()));
  }
  n_threads = static_cast<int>(
      std::min<int64_t>(n_threads, std::max<int64_t>(1, n_tiles)));

  std::vector<std::thread> workers;
  std::vector<int> errs(n_threads, 0);
  for (int t = 0; t < n_threads; ++t) {
    workers.emplace_back([&, t]() {
      FILE* f = std::fopen(path, "rb");
      if (!f) {
        errs[t] = 1;
        return;
      }
      std::vector<uint8_t> buf(kTile * bytes_per_snp);
      for (int64_t tile = t; tile < n_tiles && !errs[t]; tile += n_threads) {
        const int64_t j0 = tile * kTile;
        const int64_t nj = std::min(kTile, p_sel - j0);
        for (int64_t jj = 0; jj < nj; ++jj) {
          const int64_t off = 3 + snp_idx[j0 + jj] * bytes_per_snp;
          if (std::fseek(f, static_cast<long>(off), SEEK_SET) != 0) {
            errs[t] = 2;
            break;
          }
          if (std::fread(buf.data() + jj * bytes_per_snp, 1, bytes_per_snp,
                         f) != static_cast<size_t>(bytes_per_snp)) {
            errs[t] = 3;
            break;
          }
        }
        if (errs[t]) break;
        for (int64_t i = 0; i < n_samples; ++i) {
          const uint8_t* src = buf.data() + (i >> 2);
          const int k = static_cast<int>(i & 3);
          float* row = out + i * p_sel + j0;
          for (int64_t jj = 0; jj < nj; ++jj) {
            row[jj] = table[src[jj * bytes_per_snp]][k];
          }
        }
      }
      std::fclose(f);
    });
  }
  for (auto& w : workers) w.join();
  for (int e : errs) {
    if (e) return e;
  }
  return 0;
}

// Stream the whitespace-separated ASCII matrix at `path`, keeping the
// entries whose row AND column index are in idx[0..n_idx) (sorted
// ascending), into the float32 (n_idx, n_idx) row-major matrix `out`.  Lines
// are read in 1 MiB chunks; no row is kept beyond the one being scanned.
// Returns 0 on success, 1 when the file cannot be opened, 4 when the file
// ends before the last wanted row and 5 when a wanted row is shorter than
// the last wanted column.
int pygemma_read_filtered_matrix(const char* path, const int64_t* idx,
                                 int64_t n_idx, float* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  int64_t row = 0;   // the file's current row
  int64_t wrow = 0;  // the next wanted row
  int err = 0;
  auto process_line = [&](const char* line, size_t len) {
    if (wrow < n_idx && row == idx[wrow]) {
      int64_t col = 0, wcol = 0;
      const char* p = line;
      const char* end = line + len;
      while (p < end && wcol < n_idx) {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
        if (p >= end) break;
        if (col == idx[wcol]) {
          out[wrow * n_idx + wcol] = std::strtof(p, nullptr);
          ++wcol;
        }
        while (p < end && *p != ' ' && *p != '\t' && *p != '\r') ++p;
        ++col;
      }
      if (wcol < n_idx) err = 5;
      ++wrow;
    }
    ++row;
  };

  constexpr size_t kChunk = 1 << 20;
  std::vector<char> buf(kChunk);
  std::string carry;  // a line cut by a chunk boundary
  size_t got;
  while (!err && wrow < n_idx &&
         (got = std::fread(buf.data(), 1, kChunk, f)) > 0) {
    size_t start = 0;
    for (size_t i = 0; i < got && !err && wrow < n_idx; ++i) {
      if (buf[i] != '\n') continue;
      if (carry.empty()) {
        process_line(&buf[start], i - start);
      } else {
        carry.append(&buf[start], i - start);
        process_line(carry.data(), carry.size());
        carry.clear();
      }
      start = i + 1;
    }
    if (start < got) carry.append(&buf[start], got - start);
  }
  if (!err && wrow < n_idx && !carry.empty()) {
    process_line(carry.data(), carry.size());
  }
  std::fclose(f);
  if (err) return err;
  return wrow == n_idx ? 0 : 4;
}

}  // extern "C"
