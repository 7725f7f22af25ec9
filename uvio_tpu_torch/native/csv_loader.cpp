// Native dataset loader: EuRoC/TUM-VI `data.csv` parsing.
//
// The reference's data path is C++ (rosbag readers + `DatasetReader`,
// `ov_core/src/utils/dataset_reader.h:62-177`); this is the framework's
// native data-loader: one-pass CSV -> row-major double matrix over a
// plain C ABI. '#'-prefixed and non-numeric header lines are skipped,
// both ',' and whitespace separate fields (the reference's gt text
// files are space-separated TUM format).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// Parses `path`; on success allocates *out (row-major rows x cols,
// caller frees with uvio_csv_free) and returns 0. Returns -1 on IO
// error, -2 on ragged rows (inconsistent column count).
int64_t uvio_csv_load(const char* path, double** out, int64_t* rows,
                      int64_t* cols) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(size + 1);
  if (size > 0 && std::fread(buf.data(), 1, size, f) != (size_t)size) {
    std::fclose(f);
    return -1;
  }
  std::fclose(f);
  buf[size] = '\0';

  std::vector<double> vals;
  vals.reserve(1 << 16);
  int64_t ncols = -1, nrows = 0;
  char* p = buf.data();
  char* end = buf.data() + size;
  while (p < end) {
    char* line_end = (char*)memchr(p, '\n', end - p);
    if (!line_end) line_end = end;
    *line_end = '\0';
    // skip comments / headers / blank lines
    char* q = p;
    while (*q == ' ' || *q == '\t' || *q == '\r') q++;
    bool numeric = (*q == '-' || *q == '+' || *q == '.' ||
                    (*q >= '0' && *q <= '9'));
    if (*q != '\0' && *q != '#' && numeric) {
      int64_t c = 0;
      while (q < line_end) {
        char* next = nullptr;
        double v = std::strtod(q, &next);
        if (next == q) break;
        vals.push_back(v);
        c++;
        q = next;
        while (*q == ',' || *q == ' ' || *q == '\t' || *q == '\r') q++;
      }
      if (c > 0) {
        if (ncols == -1) ncols = c;
        if (c != ncols) return -2;
        nrows++;
      }
    }
    p = line_end + 1;
  }
  double* data = (double*)std::malloc(sizeof(double) * vals.size());
  if (!data && !vals.empty()) return -1;
  std::memcpy(data, vals.data(), sizeof(double) * vals.size());
  *out = data;
  *rows = nrows;
  *cols = ncols < 0 ? 0 : ncols;
  return 0;
}

void uvio_csv_free(double* p) { std::free(p); }

}  // extern "C"
