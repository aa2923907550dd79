// Native NetCDF3 encoder of mckpp_torch's output path: the diagnostic
// windows, restarts and merged shard files.
//
// This file is mckpp_torch's own copy of the encoder that the JAX package
// ships (mckpp_tpu/native/ncwriter.cc); the code below the header is the
// same, so both packages write the same bytes for the same payload.  It
// is the port's stand-in for XIOS, the reference's C++ I/O server
// (mckpp_xios_io.F90:11, run/iodef.xml:88-157): the diagnostics writer
// thread drives it through ctypes (mckpp_torch/native/__init__.py).
//
// Why native: NetCDF3 is big-endian on disk.  scipy's writer makes a full
// byteswapped copy of every array before writing; this encoder streams the
// host arrays through a fixed 1 MiB swap buffer instead, so host memory
// stays flat whatever the size of the output window.
//
// Format: NetCDF "classic" with 64-bit offsets (magic CDF\x02), fixed-size
// variables only (numrecs = 0), float64 or float32 data, text and double
// attributes: the subset io/ncio.py:write_fields produces, readable by
// scipy.io.netcdf_file.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC (no external dependencies).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int32_t NC_DIMENSION = 10;
constexpr int32_t NC_VARIABLE = 11;
constexpr int32_t NC_ATTRIBUTE = 12;
constexpr int32_t NC_CHAR = 2;
constexpr int32_t NC_FLOAT = 5;
constexpr int32_t NC_DOUBLE = 6;

struct Dim {
  std::string name;
  int64_t len;
};

struct Att {
  std::string name;
  bool is_text;
  std::string text;
  double value;
};

struct Var {
  std::string name;
  std::vector<int32_t> dimids;
  std::vector<Att> atts;
  const void* data;  // borrowed; owner keeps it alive until ncw_close
  int64_t nelems;
  int64_t begin;
  int32_t nc_type;   // NC_DOUBLE or NC_FLOAT
  int64_t esize;     // element bytes: 8 or 4
};

struct Writer {
  std::string path;
  std::vector<Dim> dims;
  std::vector<Att> atts;
  std::vector<Var> vars;
  bool failed = false;
};

// ---- header size accounting -------------------------------------------------

int64_t padded(int64_t n) { return (n + 3) & ~int64_t(3); }

int64_t name_bytes(const std::string& s) { return 4 + padded(s.size()); }

int64_t att_bytes(const Att& a) {
  // name, nc_type, nelems, values
  int64_t vals = a.is_text ? padded(a.text.size()) : 8;
  return name_bytes(a.name) + 4 + 4 + vals;
}

int64_t att_list_bytes(const std::vector<Att>& atts) {
  int64_t n = 8;  // tag + count
  for (const auto& a : atts) n += att_bytes(a);
  return n;
}

int64_t var_header_bytes(const Var& v) {
  // name, ndims, dimids, vatt_list, nc_type, vsize, begin(8: v2)
  return name_bytes(v.name) + 4 + 4 * (int64_t)v.dimids.size() +
         att_list_bytes(v.atts) + 4 + 4 + 8;
}

int64_t header_bytes(const Writer& w) {
  int64_t n = 4 + 4;  // magic + numrecs
  n += 8;             // dim_list tag + count
  for (const auto& d : w.dims) n += name_bytes(d.name) + 4;
  n += att_list_bytes(w.atts);  // gatt_list
  n += 8;  // var_list tag + count
  for (const auto& v : w.vars) n += var_header_bytes(v);
  return n;
}

// ---- big-endian emission ----------------------------------------------------

struct Out {
  FILE* f;
  bool ok = true;

  void bytes(const void* p, size_t n) {
    if (ok && fwrite(p, 1, n, f) != n) ok = false;
  }
  void u32(uint32_t v) {
    unsigned char b[4] = {(unsigned char)(v >> 24), (unsigned char)(v >> 16),
                          (unsigned char)(v >> 8), (unsigned char)v};
    bytes(b, 4);
  }
  void i32(int32_t v) { u32((uint32_t)v); }
  void u64(uint64_t v) {
    u32((uint32_t)(v >> 32));
    u32((uint32_t)v);
  }
  void f64(double v) {
    uint64_t u;
    memcpy(&u, &v, 8);
    u64(u);
  }
  void name(const std::string& s) {
    i32((int32_t)s.size());
    bytes(s.data(), s.size());
    static const char zeros[4] = {0, 0, 0, 0};
    bytes(zeros, padded(s.size()) - (int64_t)s.size());
  }
};

void write_att_list(Out& out, const std::vector<Att>& atts) {
  out.i32(atts.empty() ? 0 : NC_ATTRIBUTE);
  out.i32((int32_t)atts.size());
  for (const auto& a : atts) {
    out.name(a.name);
    if (a.is_text) {
      out.i32(NC_CHAR);
      out.i32((int32_t)a.text.size());
      out.bytes(a.text.data(), a.text.size());
      static const char zeros[4] = {0, 0, 0, 0};
      out.bytes(zeros, padded(a.text.size()) - (int64_t)a.text.size());
    } else {
      out.i32(NC_DOUBLE);
      out.i32(1);
      out.f64(a.value);
    }
  }
}

// Stream-byteswap an array to the file through a bounded buffer.
bool write_swapped64(Out& out, const void* data, int64_t nelems) {
  constexpr int64_t CHUNK = 131072;  // 1 MiB of doubles
  std::vector<uint64_t> buf((size_t)std::min(nelems, CHUNK));
  const uint64_t* src = reinterpret_cast<const uint64_t*>(data);
  for (int64_t off = 0; off < nelems; off += CHUNK) {
    int64_t n = std::min(CHUNK, nelems - off);
    for (int64_t i = 0; i < n; ++i) buf[(size_t)i] = __builtin_bswap64(src[off + i]);
    out.bytes(buf.data(), (size_t)n * 8);
    if (!out.ok) return false;
  }
  return true;
}

bool write_swapped32(Out& out, const void* data, int64_t nelems) {
  constexpr int64_t CHUNK = 262144;  // 1 MiB of floats
  std::vector<uint32_t> buf((size_t)std::min(nelems, CHUNK));
  const uint32_t* src = reinterpret_cast<const uint32_t*>(data);
  for (int64_t off = 0; off < nelems; off += CHUNK) {
    int64_t n = std::min(CHUNK, nelems - off);
    for (int64_t i = 0; i < n; ++i) buf[(size_t)i] = __builtin_bswap32(src[off + i]);
    out.bytes(buf.data(), (size_t)n * 4);
    if (!out.ok) return false;
  }
  // NetCDF pads each non-record variable's data to a 4-byte boundary;
  // float32 elements are already 4-aligned, so no tail padding needed.
  return true;
}

}  // namespace

extern "C" {

void* ncw_create(const char* path) {
  Writer* w = new Writer();
  w->path = path;
  return w;
}

int ncw_def_dim(void* h, const char* name, long long len) {
  Writer* w = static_cast<Writer*>(h);
  // record dims unsupported in this subset; dims beyond the CDF-2 int32
  // limit would truncate in the header, so refuse those too (caller then
  // falls back to the pure-Python writer)
  if (len <= 0 || len > 0x7FFFFFFFLL) {
    w->failed = true;
    return -1;
  }
  w->dims.push_back({name, (int64_t)len});
  return (int)w->dims.size() - 1;
}

void ncw_att_text(void* h, const char* name, const char* value) {
  static_cast<Writer*>(h)->atts.push_back({name, true, value, 0.0});
}

void ncw_att_double(void* h, const char* name, double value) {
  static_cast<Writer*>(h)->atts.push_back({name, false, "", value});
}

void ncw_var_att_text(void* h, int varid, const char* name, const char* value) {
  Writer* w = static_cast<Writer*>(h);
  if (varid < 0 || varid >= (int)w->vars.size()) {
    w->failed = true;
    return;
  }
  w->vars[(size_t)varid].atts.push_back({name, true, value, 0.0});
}

void ncw_var_att_double(void* h, int varid, const char* name, double value) {
  Writer* w = static_cast<Writer*>(h);
  if (varid < 0 || varid >= (int)w->vars.size()) {
    w->failed = true;
    return;
  }
  w->vars[(size_t)varid].atts.push_back({name, false, "", value});
}

static int def_var_typed(Writer* w, const char* name, int ndims,
                         const int* dimids, const void* data,
                         int32_t nc_type, int64_t esize) {
  Var v;
  v.name = name;
  v.nelems = 1;
  v.nc_type = nc_type;
  v.esize = esize;
  for (int i = 0; i < ndims; ++i) {
    if (dimids[i] < 0 || dimids[i] >= (int)w->dims.size()) {
      w->failed = true;
      return -1;
    }
    v.dimids.push_back(dimids[i]);
    v.nelems *= w->dims[(size_t)dimids[i]].len;
  }
  v.data = data;
  w->vars.push_back(std::move(v));
  return (int)w->vars.size() - 1;
}

int ncw_def_var_f64(void* h, const char* name, int ndims, const int* dimids,
                    const double* data) {
  return def_var_typed(static_cast<Writer*>(h), name, ndims, dimids, data,
                       NC_DOUBLE, 8);
}

// 4-byte float variable (the XIOS default output precision).
int ncw_def_var_f32(void* h, const char* name, int ndims, const int* dimids,
                    const float* data) {
  return def_var_typed(static_cast<Writer*>(h), name, ndims, dimids, data,
                       NC_FLOAT, 4);
}

// Writes the file; frees the handle; returns bytes written or -1 on error.
long long ncw_close(void* h) {
  Writer* w = static_cast<Writer*>(h);
  long long result = -1;
  if (!w->failed) {
    int64_t off = header_bytes(*w);
    for (auto& v : w->vars) {
      v.begin = off;
      off += padded(v.nelems * v.esize);
    }
    FILE* f = fopen(w->path.c_str(), "wb");
    if (f) {
      Out out{f};
      out.bytes("CDF\x02", 4);  // version 2: 64-bit offsets
      out.i32(0);               // numrecs
      out.i32(w->dims.empty() ? 0 : NC_DIMENSION);
      out.i32((int32_t)w->dims.size());
      for (const auto& d : w->dims) {
        out.name(d.name);
        out.i32((int32_t)d.len);
      }
      write_att_list(out, w->atts);
      out.i32(w->vars.empty() ? 0 : NC_VARIABLE);
      out.i32((int32_t)w->vars.size());
      for (const auto& v : w->vars) {
        out.name(v.name);
        out.i32((int32_t)v.dimids.size());
        for (int32_t d : v.dimids) out.i32(d);
        write_att_list(out, v.atts);
        out.i32(v.nc_type);
        int64_t vsize = padded(v.nelems * v.esize);
        out.i32(vsize <= 0x7FFFFFFF ? (int32_t)vsize : (int32_t)0x7FFFFFFF);
        out.u64((uint64_t)v.begin);
      }
      for (const auto& v : w->vars) {
        bool w_ok = (v.nc_type == NC_FLOAT)
                        ? write_swapped32(out, v.data, v.nelems)
                        : write_swapped64(out, v.data, v.nelems);
        if (!w_ok) break;
      }
      if (out.ok) result = (long long)ftell(f);
      fclose(f);
    }
  }
  delete w;
  return result;
}

}  // extern "C"
