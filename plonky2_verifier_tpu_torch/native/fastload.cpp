// Native proof ingest: Plonky2 JSON -> flattened uint64 verifier arrays.
//
// Single-pass design: a recursive-descent parser dispatches on object keys
// and writes numbers STRAIGHT into the flattened batch arrays produced by
// compiler/flatten.py — no intermediate DOM, no per-node allocation. The
// round-4 DOM version built a Val tree (one heap node + two std::vector per
// JSON value) before filling arrays; eliminating it is worth ~4-6x per core
// and makes ingest allocation-free on the hot path.
//
// Semantics vs the Python ingest tier (json.loads -> types.from_json ->
// compiler.flatten.flatten_proofs):
//   - same layout, same shape validation (ValueError on malformed proofs);
//   - unknown object keys are skipped (json.loads tolerance);
//   - DUPLICATED schema keys are rejected (the Python raw tier rejects them
//     too via native.strict_loads) — a duplicate-key parser differential on
//     untrusted bytes must not let two ingest tiers disagree;
//   - trailing bytes after the top-level value are rejected, like json.loads.
//
// The GIL is released during parse+fill, so a Python thread pool scales
// ingest across host cores; flatten_rows() parses a contiguous row chunk per
// call so buffer acquisition is amortized across the chunk.
//
// Schema: the repo's own codecs (types.py to_json/from_json), which mirror
// Plonky2's serde JSON (reference Types.hs:47-279). All scalars are u64.
//
// Build: plonky2_verifier_tpu/native/__init__.py build() (g++ -O2 -shared
// -fPIC), gated on a recorded source hash; pure-Python fallback otherwise.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct ParseError : std::runtime_error {
  explicit ParseError(const std::string& m) : std::runtime_error(m) {}
};

ParseError malformed(const char* msg) {
  return ParseError(std::string("malformed proof: ") + msg);
}

// ---------------------------------------------------------------------------
// Shape descriptor + output buffers (borrowed from Python before dropping
// the GIL).

struct StepShape {
  int64_t arity, path_len, cap_len;
};

struct Shape {
  int64_t n_pi, cap_len, n_const_cols, n_sigmas, num_wires, n_zs, n_pp, n_quot,
      n_lookup, final_poly_len, num_queries, initial_path_len;
  int64_t oracle_widths[4];
  std::vector<StepShape> steps;
};

struct Buf {
  uint64_t* data = nullptr;
  int64_t rows = 0;      // batch dimension
  int64_t per_row = 0;   // elements per batch row
  uint64_t* at(int64_t row) const { return data + row * per_row; }
};

struct Out {
  Buf circuit_digest, public_inputs, cap_cs, cap_w, cap_zp, cap_q, openings1,
      openings2, final_poly, pow_witness;
  std::vector<Buf> leaves, sibs, step_cap, step_evals, step_sibs;
};

// ---------------------------------------------------------------------------
// Single-pass parser. parse_* consume one JSON value from the cursor; fill_*
// additionally write it into a destination pointer with strict count checks.

struct Key {
  const char* s;
  size_t n;
  bool is(const char* lit) const {
    size_t ln = std::strlen(lit);
    return n == ln && std::memcmp(s, lit, ln) == 0;
  }
  std::string str() const { return std::string(s, n); }
};

// Per-object duplicate/missing tracking over the known schema keys.
struct Seen {
  uint32_t bits = 0;
  void mark(int i, const Key& k) {
    if (bits & (1u << i)) throw ParseError("duplicate key: " + k.str());
    bits |= (1u << i);
  }
  void require(uint32_t mask, const char* ctx) const {
    if ((bits & mask) != mask)
      throw ParseError(std::string("missing key in ") + ctx);
  }
};

struct Parser {
  const char* p;
  const char* end;

  Parser(const char* data, size_t n) : p(data), end(data + n) {}

  void ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
  }
  char peek() {
    ws();
    if (p >= end) throw ParseError("unexpected end of JSON");
    return *p;
  }
  void expect(char c) {
    if (peek() != c) throw ParseError(std::string("expected '") + c + "'");
    ++p;
  }
  bool maybe(char c) {
    if (peek() == c) {
      ++p;
      return true;
    }
    return false;
  }
  uint64_t parse_u64() {
    ws();
    if (p < end && *p == '-') throw ParseError("negative number in proof");
    if (p >= end || *p < '0' || *p > '9') throw ParseError("expected digit");
    uint64_t v = 0;
    while (p < end && *p >= '0' && *p <= '9') {
      uint64_t d = uint64_t(*p - '0');
      if (v > (UINT64_MAX - d) / 10) throw ParseError("number exceeds u64");
      v = v * 10 + d;
      ++p;
    }
    if (p < end && (*p == '.' || *p == 'e' || *p == 'E'))
      throw ParseError("non-integer number in proof");
    return v;
  }
  // Zero-copy string scan (keys and skipped string values; the schema never
  // produces escapes in keys we dispatch on).
  Key parse_string() {
    expect('"');
    const char* s = p;
    while (p < end && *p != '"') {
      if (*p == '\\') throw ParseError("escapes not supported in this schema");
      ++p;
    }
    if (p >= end) throw ParseError("unterminated string");
    Key k{s, size_t(p - s)};
    ++p;
    return k;
  }
  void literal(const char* lit) {
    ws();
    size_t n = std::strlen(lit);
    if (size_t(end - p) < n || std::memcmp(p, lit, n) != 0)
      throw ParseError("bad literal");
    p += n;
  }
  // Structural skip of one value (unknown keys — json.loads tolerance).
  void skip_value(int depth = 0) {
    if (depth > 64) throw ParseError("JSON nesting too deep");
    char c = peek();
    if (c == '{') {
      ++p;
      if (maybe('}')) return;
      for (;;) {
        parse_string();
        expect(':');
        skip_value(depth + 1);
        if (maybe(',')) continue;
        expect('}');
        break;
      }
    } else if (c == '[') {
      ++p;
      if (maybe(']')) return;
      for (;;) {
        skip_value(depth + 1);
        if (maybe(',')) continue;
        expect(']');
        break;
      }
    } else if (c == '"') {
      parse_string();
    } else if (c == 't') {
      literal("true");
    } else if (c == 'f') {
      literal("false");
    } else if (c == 'n') {
      literal("null");
    } else {
      parse_u64();
    }
  }
  // Object driver: handle(key) consumes the value for every key (known keys
  // fill arrays, unknown keys must skip_value()).
  template <class F>
  void object(F&& handle) {
    expect('{');
    if (maybe('}')) return;
    for (;;) {
      Key k = parse_string();
      expect(':');
      handle(k);
      if (maybe(',')) continue;
      expect('}');
      break;
    }
  }
  void done() {
    ws();
    if (p != end) throw ParseError("trailing bytes after JSON document");
  }

  // -- typed fills with strict counts -------------------------------------

  void fill_u64s(uint64_t* w, int64_t n, const char* msg) {
    expect('[');
    int64_t i = 0;
    if (!maybe(']')) {
      for (;;) {
        if (i >= n) throw malformed(msg);
        w[i++] = parse_u64();
        if (maybe(',')) continue;
        expect(']');
        break;
      }
    }
    if (i != n) throw malformed(msg);
  }

  // n quadratic-extension elements, each [a, b] (Types.hs QuadraticExt).
  void fill_ext_list(uint64_t* w, int64_t n, const char* msg) {
    expect('[');
    int64_t i = 0;
    if (!maybe(']')) {
      for (;;) {
        if (i >= n) throw malformed(msg);
        fill_u64s(w + 2 * i, 2, "extension element width");
        ++i;
        if (maybe(',')) continue;
        expect(']');
        break;
      }
    }
    if (i != n) throw malformed(msg);
  }

  // {"elements": [a, b, c, d]}
  void fill_digest(uint64_t* w) {
    Seen s;
    object([&](const Key& k) {
      if (k.is("elements")) {
        s.mark(0, k);
        fill_u64s(w, 4, "digest width");
      } else {
        skip_value();
      }
    });
    s.require(1, "digest");
  }

  // Merkle caps and sibling lists: n digests.
  void fill_digest_list(uint64_t* w, int64_t n, const char* msg) {
    expect('[');
    int64_t i = 0;
    if (!maybe(']')) {
      for (;;) {
        if (i >= n) throw malformed(msg);
        fill_digest(w + 4 * i);
        ++i;
        if (maybe(',')) continue;
        expect(']');
        break;
      }
    }
    if (i != n) throw malformed(msg);
  }

  // {"siblings": [digest...]}
  void fill_merkle_proof(uint64_t* w, int64_t n, const char* msg) {
    Seen s;
    object([&](const Key& k) {
      if (k.is("siblings")) {
        s.mark(0, k);
        fill_digest_list(w, n, msg);
      } else {
        skip_value();
      }
    });
    s.require(1, "merkle_proof");
  }
};

// ---------------------------------------------------------------------------
// Schema walkers (types.py to_json layouts; key order not assumed).

void parse_vkey(Parser& ps, const Shape& sh, Out& out, int64_t row) {
  Seen s;
  ps.object([&](const Key& k) {
    if (k.is("circuit_digest")) {
      s.mark(0, k);
      ps.fill_digest(out.circuit_digest.at(row));
    } else if (k.is("constants_sigmas_cap")) {
      s.mark(1, k);
      ps.fill_digest_list(out.cap_cs.at(row), sh.cap_len, "constants cap size");
    } else {
      ps.skip_value();
    }
  });
  s.require(0x3, "verifier key");
}

// openings, transcript batch order in the arrays (Challenge/FRI.hs:46-61):
// batch 1 = constants|sigmas|wires|zs|partial_products|quotient|lookup_zs,
// batch 2 = zs_next|lookup_zs_next. JSON keys may arrive in any order; each
// field writes at its fixed offset.
void parse_openings(Parser& ps, const Shape& sh, uint64_t* o1, uint64_t* o2) {
  const int64_t off_s = sh.n_const_cols;
  const int64_t off_w = off_s + sh.n_sigmas;
  const int64_t off_z = off_w + sh.num_wires;
  const int64_t off_pp = off_z + sh.n_zs;
  const int64_t off_q = off_pp + sh.n_pp;
  const int64_t off_l = off_q + sh.n_quot;
  Seen s;
  ps.object([&](const Key& k) {
    if (k.is("constants")) {
      s.mark(0, k);
      ps.fill_ext_list(o1, sh.n_const_cols, "constants openings");
    } else if (k.is("plonk_sigmas")) {
      s.mark(1, k);
      ps.fill_ext_list(o1 + 2 * off_s, sh.n_sigmas, "sigma openings");
    } else if (k.is("wires")) {
      s.mark(2, k);
      ps.fill_ext_list(o1 + 2 * off_w, sh.num_wires, "wire openings");
    } else if (k.is("plonk_zs")) {
      s.mark(3, k);
      ps.fill_ext_list(o1 + 2 * off_z, sh.n_zs, "zs openings");
    } else if (k.is("partial_products")) {
      s.mark(4, k);
      ps.fill_ext_list(o1 + 2 * off_pp, sh.n_pp, "pp openings");
    } else if (k.is("quotient_polys")) {
      s.mark(5, k);
      ps.fill_ext_list(o1 + 2 * off_q, sh.n_quot, "quotient openings");
    } else if (k.is("lookup_zs")) {
      s.mark(6, k);
      ps.fill_ext_list(o1 + 2 * off_l, sh.n_lookup, "lookup openings");
    } else if (k.is("plonk_zs_next")) {
      s.mark(7, k);
      ps.fill_ext_list(o2, sh.n_zs, "zs_next openings");
    } else if (k.is("lookup_zs_next")) {
      s.mark(8, k);
      ps.fill_ext_list(o2 + 2 * sh.n_zs, sh.n_lookup, "lookup_next openings");
    } else {
      ps.skip_value();
    }
  });
  s.require(0x1FF, "openings");
}

void parse_query_round(Parser& ps, const Shape& sh, Out& out, int64_t row,
                       int64_t q) {
  Seen s;
  ps.object([&](const Key& k) {
    if (k.is("initial_trees_proof")) {
      s.mark(0, k);
      Seen ts;
      ps.object([&](const Key& tk) {
        if (tk.is("evals_proofs")) {
          ts.mark(0, tk);
          ps.expect('[');
          int o = 0;
          if (!ps.maybe(']')) {
            for (;;) {
              if (o >= 4) throw malformed("4 initial oracles");
              // pair [leaf_values, merkle_proof]
              ps.expect('[');
              int64_t wdt = sh.oracle_widths[o];
              ps.fill_u64s(out.leaves[o].at(row) + q * wdt, wdt,
                           "oracle leaf width");
              ps.expect(',');
              ps.fill_merkle_proof(
                  out.sibs[o].at(row) + q * sh.initial_path_len * 4,
                  sh.initial_path_len, "oracle path length");
              ps.expect(']');
              ++o;
              if (ps.maybe(',')) continue;
              ps.expect(']');
              break;
            }
          }
          if (o != 4) throw malformed("4 initial oracles");
        } else {
          ps.skip_value();
        }
      });
      ts.require(1, "initial_trees_proof");
    } else if (k.is("steps")) {
      s.mark(1, k);
      ps.expect('[');
      int64_t st = 0;
      if (!ps.maybe(']')) {
        for (;;) {
          if (st >= (int64_t)sh.steps.size()) throw malformed("fold step count");
          const int64_t arity = sh.steps[st].arity;
          const int64_t plen = sh.steps[st].path_len;
          Seen ss;
          ps.object([&](const Key& sk) {
            if (sk.is("evals")) {
              ss.mark(0, sk);
              ps.fill_ext_list(out.step_evals[st].at(row) + q * arity * 2,
                               arity, "step coset size");
            } else if (sk.is("merkle_proof")) {
              ss.mark(1, sk);
              ps.fill_merkle_proof(out.step_sibs[st].at(row) + q * plen * 4,
                                   plen, "step path length");
            } else {
              ps.skip_value();
            }
          });
          ss.require(0x3, "query step");
          ++st;
          if (ps.maybe(',')) continue;
          ps.expect(']');
          break;
        }
      }
      if (st != (int64_t)sh.steps.size()) throw malformed("fold step count");
    } else {
      ps.skip_value();
    }
  });
  s.require(0x3, "query round");
}

void parse_opening_proof(Parser& ps, const Shape& sh, Out& out, int64_t row) {
  Seen s;
  ps.object([&](const Key& k) {
    if (k.is("commit_phase_merkle_caps")) {
      s.mark(0, k);
      ps.expect('[');
      int64_t i = 0;
      if (!ps.maybe(']')) {
        for (;;) {
          if (i >= (int64_t)sh.steps.size()) throw malformed("commit phase caps");
          ps.fill_digest_list(out.step_cap[i].at(row), sh.steps[i].cap_len,
                              "step cap size");
          ++i;
          if (ps.maybe(',')) continue;
          ps.expect(']');
          break;
        }
      }
      if (i != (int64_t)sh.steps.size()) throw malformed("commit phase caps");
    } else if (k.is("query_round_proofs")) {
      s.mark(1, k);
      ps.expect('[');
      int64_t q = 0;
      if (!ps.maybe(']')) {
        for (;;) {
          if (q >= sh.num_queries) throw malformed("query round count");
          parse_query_round(ps, sh, out, row, q);
          ++q;
          if (ps.maybe(',')) continue;
          ps.expect(']');
          break;
        }
      }
      if (q != sh.num_queries) throw malformed("query round count");
    } else if (k.is("final_poly")) {
      s.mark(2, k);
      Seen fs;
      ps.object([&](const Key& fk) {
        if (fk.is("coeffs")) {
          fs.mark(0, fk);
          ps.fill_ext_list(out.final_poly.at(row), sh.final_poly_len,
                           "final poly length");
        } else {
          ps.skip_value();
        }
      });
      fs.require(1, "final_poly");
    } else if (k.is("pow_witness")) {
      s.mark(3, k);
      out.pow_witness.data[row] = ps.parse_u64();
    } else {
      ps.skip_value();
    }
  });
  s.require(0xF, "opening_proof");
}

void parse_pwp(Parser& ps, const Shape& sh, Out& out, int64_t row) {
  Seen s;
  ps.object([&](const Key& k) {
    if (k.is("proof")) {
      s.mark(0, k);
      Seen pr;
      ps.object([&](const Key& pk) {
        if (pk.is("wires_cap")) {
          pr.mark(0, pk);
          ps.fill_digest_list(out.cap_w.at(row), sh.cap_len, "wires cap size");
        } else if (pk.is("plonk_zs_partial_products_cap")) {
          pr.mark(1, pk);
          ps.fill_digest_list(out.cap_zp.at(row), sh.cap_len, "zs/pp cap size");
        } else if (pk.is("quotient_polys_cap")) {
          pr.mark(2, pk);
          ps.fill_digest_list(out.cap_q.at(row), sh.cap_len,
                              "quotient cap size");
        } else if (pk.is("openings")) {
          pr.mark(3, pk);
          parse_openings(ps, sh, out.openings1.at(row), out.openings2.at(row));
        } else if (pk.is("opening_proof")) {
          pr.mark(4, pk);
          parse_opening_proof(ps, sh, out, row);
        } else {
          ps.skip_value();
        }
      });
      pr.require(0x1F, "proof");
    } else if (k.is("public_inputs")) {
      s.mark(1, k);
      ps.fill_u64s(out.public_inputs.at(row), sh.n_pi, "public input count");
    } else {
      ps.skip_value();
    }
  });
  s.require(0x3, "proof with public inputs");
}

void fill_one(const Shape& sh, Out& out, int64_t row, const char* vk_buf,
              size_t vk_len, const char* pf_buf, size_t pf_len) {
  Parser vp(vk_buf, vk_len);
  parse_vkey(vp, sh, out, row);
  vp.done();
  Parser pp(pf_buf, pf_len);
  parse_pwp(pp, sh, out, row);
  pp.done();
}

// ---------------------------------------------------------------------------
// Python boundary

int64_t dict_i64(PyObject* d, const char* k) {
  PyObject* v = PyDict_GetItemString(d, k);  // borrowed
  if (!v) throw ParseError(std::string("shape missing key ") + k);
  int64_t r = PyLong_AsLongLong(v);
  if (r == -1 && PyErr_Occurred()) throw ParseError(std::string("bad shape value ") + k);
  return r;
}

Shape read_shape(PyObject* d) {
  Shape sh;
  sh.n_pi = dict_i64(d, "n_pi");
  sh.cap_len = dict_i64(d, "cap_len");
  sh.n_const_cols = dict_i64(d, "n_const_cols");
  sh.n_sigmas = dict_i64(d, "n_sigmas");
  sh.num_wires = dict_i64(d, "num_wires");
  sh.n_zs = dict_i64(d, "n_zs");
  sh.n_pp = dict_i64(d, "n_pp");
  sh.n_quot = dict_i64(d, "n_quot");
  sh.n_lookup = dict_i64(d, "n_lookup");
  sh.final_poly_len = dict_i64(d, "final_poly_len");
  sh.num_queries = dict_i64(d, "num_queries");
  sh.initial_path_len = dict_i64(d, "initial_path_len");
  PyObject* ow = PyDict_GetItemString(d, "oracle_widths");
  if (!ow || !PyList_Check(ow) || PyList_Size(ow) != 4) throw ParseError("oracle_widths");
  for (int i = 0; i < 4; i++) sh.oracle_widths[i] = PyLong_AsLongLong(PyList_GetItem(ow, i));
  PyObject* st = PyDict_GetItemString(d, "steps");
  if (!st || !PyList_Check(st)) throw ParseError("steps");
  for (Py_ssize_t i = 0; i < PyList_Size(st); i++) {
    PyObject* e = PyList_GetItem(st, i);
    StepShape s;
    s.arity = dict_i64(e, "arity");
    s.path_len = dict_i64(e, "path_len");
    s.cap_len = dict_i64(e, "cap_len");
    sh.steps.push_back(s);
  }
  return sh;
}

struct Buffers {
  std::vector<Py_buffer> views;
  ~Buffers() {
    for (auto& v : views) PyBuffer_Release(&v);
  }
  Buf get(PyObject* dict, const std::string& key) {
    PyObject* arr = PyDict_GetItemString(dict, key.c_str());  // borrowed
    if (!arr) throw ParseError("output dict missing " + key);
    Py_buffer view;
    if (PyObject_GetBuffer(arr, &view, PyBUF_WRITABLE | PyBUF_C_CONTIGUOUS | PyBUF_FORMAT) != 0) {
      PyErr_Clear();
      throw ParseError("array for " + key + " is not a writable C-contiguous buffer");
    }
    views.push_back(view);
    if (view.itemsize != 8 || !(view.format && (view.format[0] == 'L' || view.format[0] == 'Q')))
      throw ParseError("array for " + key + " must be uint64");
    Buf b;
    b.data = static_cast<uint64_t*>(view.buf);
    b.rows = view.ndim > 0 ? view.shape[0] : 1;
    int64_t total = view.len / 8;
    b.per_row = b.rows ? total / b.rows : 0;
    return b;
  }
};

Out read_out(Buffers& bufs, PyObject* out_d, const Shape& sh) {
  Out out;
  out.circuit_digest = bufs.get(out_d, "circuit_digest");
  out.public_inputs = bufs.get(out_d, "public_inputs");
  out.cap_cs = bufs.get(out_d, "cap_cs");
  out.cap_w = bufs.get(out_d, "cap_w");
  out.cap_zp = bufs.get(out_d, "cap_zp");
  out.cap_q = bufs.get(out_d, "cap_q");
  out.openings1 = bufs.get(out_d, "openings1");
  out.openings2 = bufs.get(out_d, "openings2");
  out.final_poly = bufs.get(out_d, "final_poly");
  out.pow_witness = bufs.get(out_d, "pow_witness");
  for (int o = 0; o < 4; o++) {
    out.leaves.push_back(bufs.get(out_d, "leaves_" + std::to_string(o)));
    out.sibs.push_back(bufs.get(out_d, "sibs_" + std::to_string(o)));
  }
  for (size_t s = 0; s < sh.steps.size(); s++) {
    out.step_cap.push_back(bufs.get(out_d, "step_cap_" + std::to_string(s)));
    out.step_evals.push_back(bufs.get(out_d, "step_evals_" + std::to_string(s)));
    out.step_sibs.push_back(bufs.get(out_d, "step_sibs_" + std::to_string(s)));
  }
  return out;
}

// flatten_into(shape_dict, out_dict, row, vkey_bytes, proof_bytes)
PyObject* flatten_into(PyObject*, PyObject* args) {
  PyObject *shape_d, *out_d;
  Py_ssize_t row;
  const char *vk_buf, *pf_buf;
  Py_ssize_t vk_len, pf_len;
  if (!PyArg_ParseTuple(args, "O!O!ny#y#", &PyDict_Type, &shape_d, &PyDict_Type,
                        &out_d, &row, &vk_buf, &vk_len, &pf_buf, &pf_len))
    return nullptr;
  try {
    Shape sh = read_shape(shape_d);
    Buffers bufs;
    Out out = read_out(bufs, out_d, sh);
    if (row < 0 || row >= out.circuit_digest.rows) throw ParseError("row out of range");

    // no Python API below this point: parse + fill without the GIL
    std::string err;
    Py_BEGIN_ALLOW_THREADS;
    try {
      fill_one(sh, out, row, vk_buf, (size_t)vk_len, pf_buf, (size_t)pf_len);
    } catch (const std::exception& e) {
      err = e.what();
    }
    Py_END_ALLOW_THREADS;
    if (!err.empty()) throw ParseError(err);
  } catch (const std::exception& e) {
    PyErr_SetString(PyExc_ValueError, e.what());
    return nullptr;
  }
  Py_RETURN_NONE;
}

// flatten_rows(shape_dict, out_dict, start_row, pairs): parse a contiguous
// chunk of (vkey_bytes, proof_bytes) pairs into rows [start_row, start_row +
// len(pairs)). One buffer acquisition per chunk; the GIL is dropped for the
// whole chunk parse — this is the thread-pool unit of work.
PyObject* flatten_rows(PyObject*, PyObject* args) {
  PyObject *shape_d, *out_d, *pairs;
  Py_ssize_t start;
  if (!PyArg_ParseTuple(args, "O!O!nO", &PyDict_Type, &shape_d, &PyDict_Type,
                        &out_d, &start, &pairs))
    return nullptr;
  try {
    Shape sh = read_shape(shape_d);
    Buffers bufs;
    Out out = read_out(bufs, out_d, sh);
    PyObject* seq = PySequence_Fast(pairs, "pairs must be a sequence");
    if (!seq) throw ParseError("pairs must be a sequence");
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    // Pull the byte pointers out under the GIL; the caller holds references
    // to the bytes objects for the duration of the call.
    struct Span { const char* p; Py_ssize_t n; };
    std::vector<std::pair<Span, Span>> spans;
    spans.reserve(n);
    for (Py_ssize_t i = 0; i < n; i++) {
      PyObject* pair = PySequence_Fast_GET_ITEM(seq, i);  // borrowed
      PyObject* vko = PyTuple_Check(pair) && PyTuple_GET_SIZE(pair) == 2
                          ? PyTuple_GET_ITEM(pair, 0)
                          : nullptr;
      PyObject* pfo = vko ? PyTuple_GET_ITEM(pair, 1) : nullptr;
      char *vb, *pb;
      Py_ssize_t vl, pl;
      if (!vko || PyBytes_AsStringAndSize(vko, &vb, &vl) != 0 ||
          PyBytes_AsStringAndSize(pfo, &pb, &pl) != 0) {
        Py_DECREF(seq);
        PyErr_Clear();
        throw ParseError("pairs must be (vkey_bytes, proof_bytes) tuples");
      }
      spans.push_back({{vb, vl}, {pb, pl}});
    }
    if (start < 0 || start + n > out.circuit_digest.rows) {
      Py_DECREF(seq);
      throw ParseError("row range out of bounds");
    }

    std::string err;
    Py_BEGIN_ALLOW_THREADS;
    try {
      for (Py_ssize_t i = 0; i < n; i++)
        fill_one(sh, out, start + i, spans[i].first.p, (size_t)spans[i].first.n,
                 spans[i].second.p, (size_t)spans[i].second.n);
    } catch (const std::exception& e) {
      err = e.what();
    }
    Py_END_ALLOW_THREADS;
    Py_DECREF(seq);
    if (!err.empty()) throw ParseError(err);
  } catch (const std::exception& e) {
    PyErr_SetString(PyExc_ValueError, e.what());
    return nullptr;
  }
  Py_RETURN_NONE;
}

PyMethodDef methods[] = {
    {"flatten_into", flatten_into, METH_VARARGS,
     "flatten_into(shape, out_arrays, row, vkey_json, proof_json): parse one "
     "proof's JSON into row `row` of the flattened uint64 batch arrays."},
    {"flatten_rows", flatten_rows, METH_VARARGS,
     "flatten_rows(shape, out_arrays, start_row, pairs): parse a contiguous "
     "chunk of (vkey_json, proof_json) byte pairs into rows starting at "
     "start_row; the GIL is released for the whole chunk."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moddef = {PyModuleDef_HEAD_INIT, "p2v_fastload",
                      "Native Plonky2 proof JSON -> verifier array ingest",
                      -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit_p2v_fastload() { return PyModule_Create(&moddef); }
