// Native IO for the bundle-adjustment text formats.
//
// The reference's L0 layer is MATLAB readmatrix (ReadFiles.m:49); this is
// the framework's native-runtime equivalent: a single-pass tokenizer +
// string-ID interner that parses the hot file (.pho — one row per image
// observation, ~1M rows at benchmark scale) and the ID/XYZ tables
// (.cnt/.cze) without ever materializing per-row Python objects.
//
// Contract (mirrors io/readers.py exactly):
//   - whitespace-delimited (spaces/tabs, runs collapsed)
//   - '#' starts a comment anywhere in a line
//   - blank lines skipped
//   - .pho rows need >= 4 tokens: targetID imageID x y (extras ignored)
//   - ID columns are interned in FIRST-APPEARANCE order; per-row columns
//     come back as int32 indices into the unique table — the form the
//     problem-assembly join (io/problem.py) consumes directly.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

char* dup_cstr(const std::string& s) {
  char* out = static_cast<char*>(std::malloc(s.size() + 1));
  if (out) std::memcpy(out, s.c_str(), s.size() + 1);
  return out;
}

// Read a whole file into a NUL-terminated buffer (nullptr on failure).
char* read_file(const char* path, size_t* len_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long len = std::ftell(f);
  if (len < 0) {
    std::fclose(f);
    return nullptr;
  }
  std::fseek(f, 0, SEEK_SET);
  char* buf = static_cast<char*>(std::malloc(static_cast<size_t>(len) + 1));
  if (!buf) {
    std::fclose(f);
    return nullptr;
  }
  size_t got = std::fread(buf, 1, static_cast<size_t>(len), f);
  std::fclose(f);
  buf[got] = '\0';
  *len_out = got;
  return buf;
}

inline bool is_space(char c) { return c == ' ' || c == '\t' || c == '\r'; }
inline bool is_eol(char c) { return c == '\n' || c == '\0'; }

struct Interner {
  std::unordered_map<std::string_view, int32_t> map;
  std::vector<std::string_view> order;

  int32_t intern(std::string_view s) {
    auto it = map.find(s);
    if (it != map.end()) return it->second;
    int32_t id = static_cast<int32_t>(order.size());
    map.emplace(s, id);
    order.push_back(s);
    return id;
  }

  // '\n'-joined blob of the unique IDs, in first-appearance order.
  std::string join() const {
    size_t total = 0;
    for (auto s : order) total += s.size() + 1;
    std::string out;
    out.reserve(total);
    for (auto s : order) {
      out.append(s.data(), s.size());
      out.push_back('\n');
    }
    return out;
  }
};

// Cursor over the file buffer yielding tokens within the current line.
struct Cursor {
  const char* p;
  int64_t line = 1;  // 1-based physical line number for error messages

  // Advance past spaces; returns false at end-of-line / comment / EOF
  // (does not consume the newline).
  bool skip_ws_in_line() {
    while (is_space(*p)) ++p;
    return !(is_eol(*p) || *p == '#');
  }

  // Consume the rest of the current line including its newline.
  void next_line() {
    while (!is_eol(*p)) ++p;
    if (*p == '\n') {
      ++p;
      ++line;
    }
  }

  std::string_view token() {
    const char* start = p;
    while (!is_space(*p) && !is_eol(*p) && *p != '#') ++p;
    return std::string_view(start, static_cast<size_t>(p - start));
  }
};

// strtod that must consume exactly the given token.
bool parse_double(std::string_view tok, double* out) {
  if (tok.empty()) return false;
  char* end = nullptr;
  errno = 0;
  double v = std::strtod(tok.data(), &end);
  if (end != tok.data() + tok.size()) return false;
  *out = v;
  return true;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// .pho: targetID imageID x y  (per-row string IDs interned)
// ---------------------------------------------------------------------------
struct PhoResult {
  int64_t n_obs;
  int64_t n_targets;
  int64_t n_images;
  double* xy;          // 2 * n_obs, row-major (x, y)
  int32_t* tgt_idx;    // n_obs -> unique-target index
  int32_t* img_idx;    // n_obs -> unique-image index
  char* target_blob;   // '\n'-joined unique target IDs
  int64_t target_blob_len;
  char* image_blob;    // '\n'-joined unique image IDs
  int64_t image_blob_len;
  char* error;         // nullptr on success
};

static PhoResult* pho_error(PhoResult* r, const std::string& msg) {
  r->error = dup_cstr(msg);
  return r;
}

PhoResult* feba_parse_pho(const char* path) {
  auto* r = static_cast<PhoResult*>(std::calloc(1, sizeof(PhoResult)));
  if (!r) return nullptr;
  size_t len = 0;
  char* buf = read_file(path, &len);
  if (!buf) return pho_error(r, std::string("cannot read ") + path);

  Interner targets, images;
  std::vector<double> xy;
  std::vector<int32_t> tgt, img;
  Cursor c{buf};

  while (*c.p) {
    if (!c.skip_ws_in_line()) {  // blank / comment line
      c.next_line();
      continue;
    }
    std::string_view t_tgt = c.token();
    std::string_view t_img, t_x, t_y;
    int got = 1;
    if (c.skip_ws_in_line()) { t_img = c.token(); got = 2; }
    if (got == 2 && c.skip_ws_in_line()) { t_x = c.token(); got = 3; }
    if (got == 3 && c.skip_ws_in_line()) { t_y = c.token(); got = 4; }
    if (got < 4) {
      std::string msg = ".pho row needs 4 columns (line " +
                        std::to_string(c.line) + ")";
      std::free(buf);
      return pho_error(r, msg);
    }
    double x, y;
    if (!parse_double(t_x, &x) || !parse_double(t_y, &y)) {
      std::string msg = ".pho row has non-numeric coordinate (line " +
                        std::to_string(c.line) + ")";
      std::free(buf);
      return pho_error(r, msg);
    }
    tgt.push_back(targets.intern(t_tgt));
    img.push_back(images.intern(t_img));
    xy.push_back(x);
    xy.push_back(y);
    c.next_line();
  }

  r->n_obs = static_cast<int64_t>(tgt.size());
  r->n_targets = static_cast<int64_t>(targets.order.size());
  r->n_images = static_cast<int64_t>(images.order.size());
  r->xy = static_cast<double*>(std::malloc(xy.size() * sizeof(double)));
  r->tgt_idx = static_cast<int32_t*>(std::malloc(tgt.size() * sizeof(int32_t)));
  r->img_idx = static_cast<int32_t*>(std::malloc(img.size() * sizeof(int32_t)));
  std::string tb = targets.join();
  std::string ib = images.join();
  r->target_blob = dup_cstr(tb);
  r->target_blob_len = static_cast<int64_t>(tb.size());
  r->image_blob = dup_cstr(ib);
  r->image_blob_len = static_cast<int64_t>(ib.size());
  if ((!r->xy && !xy.empty()) || (!r->tgt_idx && !tgt.empty()) ||
      (!r->img_idx && !img.empty()) || !r->target_blob || !r->image_blob) {
    std::free(buf);
    return pho_error(r, "out of memory");
  }
  if (!xy.empty()) std::memcpy(r->xy, xy.data(), xy.size() * sizeof(double));
  if (!tgt.empty())
    std::memcpy(r->tgt_idx, tgt.data(), tgt.size() * sizeof(int32_t));
  if (!img.empty())
    std::memcpy(r->img_idx, img.data(), img.size() * sizeof(int32_t));
  std::free(buf);  // blobs are owned copies; views no longer needed
  return r;
}

void feba_free_pho(PhoResult* r) {
  if (!r) return;
  std::free(r->xy);
  std::free(r->tgt_idx);
  std::free(r->img_idx);
  std::free(r->target_blob);
  std::free(r->image_blob);
  std::free(r->error);
  std::free(r);
}

// ---------------------------------------------------------------------------
// ID + numeric table: `id v1 .. vK` per row (.cnt / .cze, K=3)
// ---------------------------------------------------------------------------
struct TableResult {
  int64_t n_rows;
  int64_t n_unique;
  int32_t* id_idx;   // n_rows -> unique-ID index
  char* id_blob;     // '\n'-joined unique IDs
  int64_t id_blob_len;
  double* vals;      // n_rows * n_num, row-major
  char* error;
};

static TableResult* table_error(TableResult* r, const std::string& msg) {
  r->error = dup_cstr(msg);
  return r;
}

TableResult* feba_parse_idtable(const char* path, int32_t n_num) {
  auto* r = static_cast<TableResult*>(std::calloc(1, sizeof(TableResult)));
  if (!r) return nullptr;
  size_t len = 0;
  char* buf = read_file(path, &len);
  if (!buf) return table_error(r, std::string("cannot read ") + path);

  Interner ids;
  std::vector<int32_t> idx;
  std::vector<double> vals;
  Cursor c{buf};

  while (*c.p) {
    if (!c.skip_ws_in_line()) {
      c.next_line();
      continue;
    }
    std::string_view id = c.token();
    int32_t row_ok = 1;
    size_t base = vals.size();
    for (int32_t k = 0; k < n_num; ++k) {
      if (!c.skip_ws_in_line()) {
        row_ok = 0;
        break;
      }
      double v;
      if (!parse_double(c.token(), &v)) {
        row_ok = -1;
        break;
      }
      vals.push_back(v);
    }
    if (row_ok != 1) {
      std::string msg =
          row_ok == 0
              ? "row needs " + std::to_string(n_num + 1) + " columns (line " +
                    std::to_string(c.line) + ")"
              : "row has non-numeric value (line " + std::to_string(c.line) +
                    ")";
      std::free(buf);
      vals.resize(base);
      return table_error(r, msg);
    }
    idx.push_back(ids.intern(id));
    c.next_line();
  }

  r->n_rows = static_cast<int64_t>(idx.size());
  r->n_unique = static_cast<int64_t>(ids.order.size());
  r->id_idx = static_cast<int32_t*>(std::malloc(idx.size() * sizeof(int32_t)));
  r->vals = static_cast<double*>(std::malloc(vals.size() * sizeof(double)));
  std::string blob = ids.join();
  r->id_blob = dup_cstr(blob);
  r->id_blob_len = static_cast<int64_t>(blob.size());
  if ((!r->id_idx && !idx.empty()) || (!r->vals && !vals.empty()) ||
      !r->id_blob) {
    std::free(buf);
    return table_error(r, "out of memory");
  }
  if (!idx.empty())
    std::memcpy(r->id_idx, idx.data(), idx.size() * sizeof(int32_t));
  if (!vals.empty())
    std::memcpy(r->vals, vals.data(), vals.size() * sizeof(double));
  std::free(buf);
  return r;
}

void feba_free_table(TableResult* r) {
  if (!r) return;
  std::free(r->id_idx);
  std::free(r->id_blob);
  std::free(r->vals);
  std::free(r->error);
  std::free(r);
}

int32_t feba_abi_version(void) { return 1; }

}  // extern "C"
