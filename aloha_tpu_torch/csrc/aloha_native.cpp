// ALOHA-TPU native runtime support (C ABI, loaded via ctypes): the port's
// own copy of native/aloha_native.cpp, the same functions and file format.
//
// Plays the role of the reference's only native code — the DPI trace-database
// reader used by its co-simulation harness (reference:
// sim/vp/top/tdb_reader.{h,cpp}, dpi_c_interface.cpp) — re-designed for this
// framework:
//
//   * TDB: a binary trace database of per-instruction engine results
//     (header + field table + row-addressable uint64 payload).  The Python
//     replayer records traces; this reader gives random access for
//     co-simulation diffing without loading whole files.
//   * fast text IO: the reference golden vectors are million-line decimal
//     files; parse_u64_file is ~20x faster than generic text parsing.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 at first use (see
// aloha_tpu_torch/native.py); not part of the nvcc build of csrc/*.cu.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------- text IO
// Parse a file of ASCII decimal uint64 values (one or more per line,
// whitespace separated) into out[0..max_count). Returns count parsed, or
// -1 on open failure.
long long aloha_parse_u64_file(const char* path, uint64_t* out,
                               long long max_count) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  // read whole file
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  char* buf = (char*)malloc((size_t)sz + 1);
  if (!buf) {
    fclose(f);
    return -1;
  }
  size_t rd = fread(buf, 1, (size_t)sz, f);
  fclose(f);
  buf[rd] = 0;
  long long n = 0;
  const char* p = buf;
  const char* end = buf + rd;
  while (p < end && n < max_count) {
    // skip non-digits
    while (p < end && (*p < '0' || *p > '9')) p++;
    if (p >= end) break;
    uint64_t v = 0;
    while (p < end && *p >= '0' && *p <= '9') {
      v = v * 10u + (uint64_t)(*p - '0');
      p++;
    }
    out[n++] = v;
  }
  free(buf);
  return n;
}

// Write uint64 values as decimal lines (the reference dump format).
long long aloha_write_u64_file(const char* path, const uint64_t* vals,
                               long long count) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  char line[24];
  for (long long i = 0; i < count; i++) {
    int len = snprintf(line, sizeof line, "%llu\n",
                       (unsigned long long)vals[i]);
    fwrite(line, 1, (size_t)len, f);
  }
  fclose(f);
  return count;
}

// ------------------------------------------------------------------- TDB
// Layout (little endian):
//   [0]  magic   "ATDB" (4 bytes) | version u32
//   [8]  n_fields u32 | name_bytes u32
//   [16] n_rows  u64 | row_words u64
//   [32] field table: n_fields x { name_off u32, name_len u32,
//                                  word_off u32, word_len u32 }
//   [..] name pool (name_bytes)
//   [..] payload: n_rows x row_words x u64

struct TdbField {
  uint32_t name_off, name_len, word_off, word_len;
};

struct Tdb {
  FILE* f;
  uint32_t n_fields;
  uint64_t n_rows, row_words;
  long long payload_off;
  TdbField* fields;
  char* names;
};

static const uint32_t kMagic = 0x42445441u;  // "ATDB"

void* aloha_tdb_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  uint32_t magic = 0, version = 0, n_fields = 0, name_bytes = 0;
  uint64_t n_rows = 0, row_words = 0;
  if (fread(&magic, 4, 1, f) != 1 || magic != kMagic) goto fail;
  if (fread(&version, 4, 1, f) != 1) goto fail;
  if (fread(&n_fields, 4, 1, f) != 1) goto fail;
  if (fread(&name_bytes, 4, 1, f) != 1) goto fail;
  if (fread(&n_rows, 8, 1, f) != 1) goto fail;
  if (fread(&row_words, 8, 1, f) != 1) goto fail;
  {
    Tdb* t = new Tdb;
    t->f = f;
    t->n_fields = n_fields;
    t->n_rows = n_rows;
    t->row_words = row_words;
    t->fields = new TdbField[n_fields];
    if (fread(t->fields, sizeof(TdbField), n_fields, f) != n_fields) {
      delete[] t->fields;
      delete t;
      goto fail;
    }
    t->names = new char[name_bytes + 1];
    if (name_bytes &&
        fread(t->names, 1, name_bytes, f) != name_bytes) {
      delete[] t->fields;
      delete[] t->names;
      delete t;
      goto fail;
    }
    t->names[name_bytes] = 0;
    // validate the field table against the name pool up front so
    // aloha_tdb_field can never read out of bounds on a corrupt file
    for (uint32_t i = 0; i < n_fields; ++i) {
      const TdbField& fl = t->fields[i];
      if ((uint64_t)fl.name_off + fl.name_len > name_bytes) {
        delete[] t->fields;
        delete[] t->names;
        delete t;
        goto fail;
      }
    }
    t->payload_off = ftell(f);
    return t;
  }
fail:
  fclose(f);
  return nullptr;
}

long long aloha_tdb_rows(void* h) {
  return h ? (long long)((Tdb*)h)->n_rows : -1;
}

long long aloha_tdb_row_words(void* h) {
  return h ? (long long)((Tdb*)h)->row_words : -1;
}

int aloha_tdb_n_fields(void* h) {
  return h ? (int)((Tdb*)h)->n_fields : -1;
}

// Copy field metadata: name into name_buf (NUL terminated), returns
// word_off<<32 | word_len, or -1.
long long aloha_tdb_field(void* h, int idx, char* name_buf, int name_cap) {
  if (!h || name_cap < 1) return -1;  // cap < 1 would underflow the copy
  Tdb* t = (Tdb*)h;
  if (idx < 0 || (uint32_t)idx >= t->n_fields) return -1;
  TdbField& fl = t->fields[idx];
  uint32_t len = fl.name_len < (uint32_t)(name_cap - 1)
                     ? fl.name_len
                     : (uint32_t)(name_cap - 1);
  memcpy(name_buf, t->names + fl.name_off, len);
  name_buf[len] = 0;
  return ((long long)fl.word_off << 32) | fl.word_len;
}

// Read `n` whole rows starting at `row` into out (n * row_words u64).
long long aloha_tdb_read(void* h, long long row, long long n, uint64_t* out) {
  if (!h) return -1;
  Tdb* t = (Tdb*)h;
  if (row < 0 || (uint64_t)row >= t->n_rows) return 0;
  if ((uint64_t)(row + n) > t->n_rows) n = (long long)(t->n_rows - row);
  if (fseek(t->f,
            t->payload_off + (long long)(row * t->row_words * 8), SEEK_SET))
    return -1;
  size_t want = (size_t)(n * t->row_words);
  size_t got = fread(out, 8, want, t->f);
  return (long long)(got / t->row_words);
}

void aloha_tdb_close(void* h) {
  if (!h) return;
  Tdb* t = (Tdb*)h;
  fclose(t->f);
  delete[] t->fields;
  delete[] t->names;
  delete t;
}

}  // extern "C"
