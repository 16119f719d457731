// Fast MPS parser — native IO core for clp_tpu_torch.
//
// Plays the role CoinMpsIO's C++ reader plays for the reference
// (ClpModel::readMps, ClpModel.hpp:131): host-side parse of large MPS files
// at native speed. Exposed through a minimal C ABI consumed via ctypes
// (clp_tpu_torch/io/native.py); the Python reader remains the fallback and the
// semantics oracle (same section handling: ROWS/COLUMNS with INTORG
// markers, RHS with objective-row offset, RANGES, BOUNDS incl. the
// negative-UP quirk).
//
// Built by clp_tpu_torch/io/native.py at first use (g++ -O2 -shared -fPIC).

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr double kInf = 1e30;

struct Triplet {
  int64_t i, j;
  double v;
};

struct Parser {
  std::vector<std::string> row_names, col_names;
  std::unordered_map<std::string, int64_t> row_index, col_index;
  std::vector<char> row_type;
  std::string obj_row, problem_name;
  std::vector<Triplet> triplets;
  std::vector<double> obj;            // per column
  std::vector<double> rhs;            // per row (default 0)
  std::vector<double> range;          // per row (NaN = unset)
  std::vector<double> col_lower, col_upper;
  std::vector<uint8_t> lower_explicit;
  std::vector<int64_t> integer_cols;
  std::vector<uint8_t> is_integer;
  double obj_offset = 0.0;
  bool maximize = false;
  std::unordered_map<std::string, char> free_rows;  // extra N rows (free)
};

int64_t col_of(Parser& p, const std::string& name) {
  auto it = p.col_index.find(name);
  if (it != p.col_index.end()) return it->second;
  int64_t j = static_cast<int64_t>(p.col_names.size());
  p.col_index.emplace(name, j);
  p.col_names.push_back(name);
  p.obj.push_back(0.0);
  p.col_lower.push_back(0.0);
  p.col_upper.push_back(kInf);
  p.lower_explicit.push_back(0);
  p.is_integer.push_back(0);
  return j;
}

// split a line into whitespace-separated fields (in place views)
int fields_of(char* line, char* out[16]) {
  int n = 0;
  char* s = line;
  while (*s && n < 16) {
    while (*s && std::isspace(static_cast<unsigned char>(*s))) ++s;
    if (!*s) break;
    out[n++] = s;
    while (*s && !std::isspace(static_cast<unsigned char>(*s))) ++s;
    if (*s) *s++ = '\0';
  }
  return n;
}

enum Section {
  SEC_NONE,
  SEC_NAME,
  SEC_OBJSENSE,
  SEC_ROWS,
  SEC_COLUMNS,
  SEC_RHS,
  SEC_RANGES,
  SEC_BOUNDS,
  SEC_UNSUPPORTED,
  SEC_END
};

}  // namespace

extern "C" {

struct ClpTpuMps {
  int64_t n_rows, n_cols, nnz;
  double* row_lower;
  double* row_upper;
  double* col_lower;
  double* col_upper;
  double* obj;
  int64_t* ai;
  int64_t* aj;
  double* av;
  double obj_offset;
  int32_t maximize;
  // names: contiguous blob of NUL-terminated strings, offsets per entity
  char* names_blob;
  int64_t names_blob_len;
  int64_t* row_name_off;
  int64_t* col_name_off;
  char problem_name[256];
  int64_t n_integer;
  int64_t* integer_idx;
};

// returns 0 on success; 1 file error; 2 parse error; 3 unsupported section
// (caller should fall back to the Python reader on 2/3)
int clptpu_read_mps(const char* path, ClpTpuMps* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  Parser p;
  Section sec = SEC_NONE;
  bool in_integer = false;
  int rc = 0;

  char buf[65536];
  while (std::fgets(buf, sizeof buf, f)) {
    size_t len = std::strlen(buf);
    while (len && (buf[len - 1] == '\n' || buf[len - 1] == '\r')) buf[--len] = '\0';
    if (!len || buf[0] == '*') continue;
    if (!std::isspace(static_cast<unsigned char>(buf[0]))) {
      char* fl[16];
      int nf = fields_of(buf, fl);
      if (nf == 0) continue;
      std::string head(fl[0]);
      for (auto& c : head) c = std::toupper(static_cast<unsigned char>(c));
      if (head == "NAME") {
        if (nf > 1) p.problem_name = fl[1];
        sec = SEC_NAME;
      } else if (head == "OBJSENSE") {
        sec = SEC_OBJSENSE;
        if (nf > 1 && (fl[1][0] == 'M' || fl[1][0] == 'm') &&
            (fl[1][1] == 'A' || fl[1][1] == 'a'))
          p.maximize = true;
      } else if (head == "ROWS") {
        sec = SEC_ROWS;
      } else if (head == "COLUMNS") {
        sec = SEC_COLUMNS;
      } else if (head == "RHS") {
        sec = SEC_RHS;
      } else if (head == "RANGES") {
        sec = SEC_RANGES;
      } else if (head == "BOUNDS") {
        sec = SEC_BOUNDS;
      } else if (head == "ENDATA") {
        sec = SEC_END;
        break;
      } else if (head == "QUADOBJ" || head == "QMATRIX" || head == "QSECTION" ||
                 head == "SOS") {
        rc = 3;  // quadratic/SOS: fall back to the Python reader
        break;
      } else {
        rc = 2;
        break;
      }
      continue;
    }
    char* fl[16];
    int nf = fields_of(buf, fl);
    if (nf == 0) continue;
    switch (sec) {
      case SEC_OBJSENSE: {
        if ((fl[0][0] == 'M' || fl[0][0] == 'm') &&
            (fl[0][1] == 'A' || fl[0][1] == 'a'))
          p.maximize = true;
        break;
      }
      case SEC_ROWS: {
        if (nf < 2) { rc = 2; break; }
        char t = std::toupper(static_cast<unsigned char>(fl[0][0]));
        std::string rname(fl[1]);
        if (t == 'N' && p.obj_row.empty()) {
          p.obj_row = rname;
        } else if (t == 'N' || t == 'L' || t == 'G' || t == 'E') {
          // extra N rows are kept as free constraint rows with infinite
          // bounds (CoinMpsIO semantics) so counts/names/duals match
          if (t == 'N') p.free_rows.emplace(rname, 'N');
          p.row_index.emplace(rname, static_cast<int64_t>(p.row_names.size()));
          p.row_names.push_back(rname);
          p.row_type.push_back(t);
          p.rhs.push_back(0.0);
          p.range.push_back(NAN);
        } else {
          rc = 2;
        }
        break;
      }
      case SEC_COLUMNS: {
        if (nf >= 3 && std::strstr(fl[1], "MARKER")) {
          if (std::strstr(fl[nf - 1], "INTORG")) in_integer = true;
          else if (std::strstr(fl[nf - 1], "INTEND")) in_integer = false;
          break;
        }
        if (nf < 3) { rc = 2; break; }
        int64_t j = col_of(p, fl[0]);
        if (in_integer && !p.is_integer[j]) {
          p.is_integer[j] = 1;
          p.integer_cols.push_back(j);
        }
        for (int k = 1; k + 1 < nf; k += 2) {
          std::string rname(fl[k]);
          double v = std::strtod(fl[k + 1], nullptr);
          if (rname == p.obj_row) {
            p.obj[j] += v;
          } else {
            auto it = p.row_index.find(rname);
            if (it == p.row_index.end()) { rc = 2; break; }
            p.triplets.push_back({it->second, j, v});
          }
        }
        break;
      }
      case SEC_RHS:
      case SEC_RANGES: {
        // first field may be a set name; detect by row lookup
        int start = 0;
        {
          std::string f0(fl[0]);
          bool is_row = p.row_index.count(f0) || f0 == p.obj_row;
          if (!is_row) start = 1;
        }
        for (int k = start; k + 1 < nf; k += 2) {
          std::string rname(fl[k]);
          double v = std::strtod(fl[k + 1], nullptr);
          if (sec == SEC_RHS && rname == p.obj_row) {
            p.obj_offset = -v;
            continue;
          }
          auto it = p.row_index.find(rname);
          if (it == p.row_index.end()) {
            if (p.free_rows.count(rname)) continue;
            rc = 2;
            break;
          }
          if (sec == SEC_RHS)
            p.rhs[it->second] = v;
          else
            p.range[it->second] = v;
        }
        break;
      }
      case SEC_BOUNDS: {
        if (nf < 2) { rc = 2; break; }
        char b0 = std::toupper(static_cast<unsigned char>(fl[0][0]));
        char b1 = std::toupper(static_cast<unsigned char>(fl[0][1]));
        bool no_value = (b0 == 'F' && b1 == 'R') || (b0 == 'M' && b1 == 'I') ||
                        (b0 == 'P' && b1 == 'L') || (b0 == 'B' && b1 == 'V');
        // bound-set name is optional
        const char* cname;
        double v = 0.0;
        if (no_value) {
          cname = (nf >= 3) ? fl[2] : fl[1];
        } else {
          if (nf >= 4) {
            cname = fl[2];
            v = std::strtod(fl[3], nullptr);
          } else if (nf == 3) {
            cname = fl[1];
            v = std::strtod(fl[2], nullptr);
          } else {
            rc = 2;
            break;
          }
        }
        auto it = p.col_index.find(cname);
        if (it == p.col_index.end()) break;  // unknown column: ignore
        int64_t j = it->second;
        if (b0 == 'L' && b1 == 'O') {
          p.col_lower[j] = v;
          p.lower_explicit[j] = 1;
        } else if (b0 == 'U' && b1 == 'P') {
          p.col_upper[j] = v;
          if (v < 0 && !p.lower_explicit[j]) p.col_lower[j] = -kInf;
        } else if (b0 == 'F' && b1 == 'X') {
          p.col_lower[j] = p.col_upper[j] = v;
          p.lower_explicit[j] = 1;
        } else if (b0 == 'F' && b1 == 'R') {
          p.col_lower[j] = -kInf;
          p.col_upper[j] = kInf;
        } else if (b0 == 'M' && b1 == 'I') {
          p.col_lower[j] = -kInf;
        } else if (b0 == 'P' && b1 == 'L') {
          p.col_upper[j] = kInf;
        } else if (b0 == 'B' && b1 == 'V') {
          p.col_lower[j] = 0.0;
          p.col_upper[j] = 1.0;
          p.lower_explicit[j] = 1;
          if (!p.is_integer[j]) { p.is_integer[j] = 1; p.integer_cols.push_back(j); }
        } else if (b0 == 'L' && b1 == 'I') {
          p.col_lower[j] = v;
          p.lower_explicit[j] = 1;
          if (!p.is_integer[j]) { p.is_integer[j] = 1; p.integer_cols.push_back(j); }
        } else if (b0 == 'U' && b1 == 'I') {
          p.col_upper[j] = v;
          if (!p.is_integer[j]) { p.is_integer[j] = 1; p.integer_cols.push_back(j); }
        } else {
          rc = 2;
        }
        break;
      }
      case SEC_NAME:
        break;
      default:
        rc = 2;
        break;
    }
    if (rc) break;
  }
  std::fclose(f);
  if (rc) return rc;

  const int64_t m = static_cast<int64_t>(p.row_names.size());
  const int64_t n = static_cast<int64_t>(p.col_names.size());
  const int64_t nnz = static_cast<int64_t>(p.triplets.size());

  std::memset(out, 0, sizeof *out);
  out->n_rows = m;
  out->n_cols = n;
  out->nnz = nnz;
  out->obj_offset = p.obj_offset;
  out->maximize = p.maximize ? 1 : 0;
  std::snprintf(out->problem_name, sizeof out->problem_name, "%s",
                p.problem_name.c_str());

  out->row_lower = static_cast<double*>(std::malloc(m * sizeof(double)));
  out->row_upper = static_cast<double*>(std::malloc(m * sizeof(double)));
  for (int64_t i = 0; i < m; ++i) {
    double b = p.rhs[i];
    double lo, up;
    switch (p.row_type[i]) {
      case 'N': lo = -kInf; up = kInf; break;  // free row: never binds
      case 'L': lo = -kInf; up = b; break;
      case 'G': lo = b; up = kInf; break;
      default:  lo = b; up = b; break;  // E
    }
    double r = p.range[i];
    if (p.row_type[i] != 'N' && !std::isnan(r)) {
      if (p.row_type[i] == 'L') lo = b - std::fabs(r);
      else if (p.row_type[i] == 'G') up = b + std::fabs(r);
      else if (r >= 0) up = b + r;
      else lo = b + r;
    }
    out->row_lower[i] = lo;
    out->row_upper[i] = up;
  }
  out->col_lower = static_cast<double*>(std::malloc(n * sizeof(double)));
  out->col_upper = static_cast<double*>(std::malloc(n * sizeof(double)));
  out->obj = static_cast<double*>(std::malloc(n * sizeof(double)));
  std::memcpy(out->col_lower, p.col_lower.data(), n * sizeof(double));
  std::memcpy(out->col_upper, p.col_upper.data(), n * sizeof(double));
  std::memcpy(out->obj, p.obj.data(), n * sizeof(double));

  out->ai = static_cast<int64_t*>(std::malloc(nnz * sizeof(int64_t)));
  out->aj = static_cast<int64_t*>(std::malloc(nnz * sizeof(int64_t)));
  out->av = static_cast<double*>(std::malloc(nnz * sizeof(double)));
  for (int64_t k = 0; k < nnz; ++k) {
    out->ai[k] = p.triplets[k].i;
    out->aj[k] = p.triplets[k].j;
    out->av[k] = p.triplets[k].v;
  }

  int64_t blob_len = 0;
  for (auto& s : p.row_names) blob_len += static_cast<int64_t>(s.size()) + 1;
  for (auto& s : p.col_names) blob_len += static_cast<int64_t>(s.size()) + 1;
  out->names_blob = static_cast<char*>(std::malloc(blob_len ? blob_len : 1));
  out->names_blob_len = blob_len;
  out->row_name_off = static_cast<int64_t*>(std::malloc((m ? m : 1) * sizeof(int64_t)));
  out->col_name_off = static_cast<int64_t*>(std::malloc((n ? n : 1) * sizeof(int64_t)));
  int64_t off = 0;
  for (int64_t i = 0; i < m; ++i) {
    out->row_name_off[i] = off;
    std::memcpy(out->names_blob + off, p.row_names[i].c_str(),
                p.row_names[i].size() + 1);
    off += static_cast<int64_t>(p.row_names[i].size()) + 1;
  }
  for (int64_t j = 0; j < n; ++j) {
    out->col_name_off[j] = off;
    std::memcpy(out->names_blob + off, p.col_names[j].c_str(),
                p.col_names[j].size() + 1);
    off += static_cast<int64_t>(p.col_names[j].size()) + 1;
  }

  out->n_integer = static_cast<int64_t>(p.integer_cols.size());
  out->integer_idx = static_cast<int64_t*>(
      std::malloc((out->n_integer ? out->n_integer : 1) * sizeof(int64_t)));
  for (int64_t k = 0; k < out->n_integer; ++k)
    out->integer_idx[k] = p.integer_cols[k];
  return 0;
}

void clptpu_free_mps(ClpTpuMps* r) {
  std::free(r->row_lower);
  std::free(r->row_upper);
  std::free(r->col_lower);
  std::free(r->col_upper);
  std::free(r->obj);
  std::free(r->ai);
  std::free(r->aj);
  std::free(r->av);
  std::free(r->names_blob);
  std::free(r->row_name_off);
  std::free(r->col_name_off);
  std::free(r->integer_idx);
  std::memset(r, 0, sizeof *r);
}

}  // extern "C"
