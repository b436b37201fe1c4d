// Native host runtime of pumiumtally_tpu_torch: the face-adjacency hash,
// the derived face-plane and volume tables, and the Gmsh ASCII tokenizer.
//
// The mesh ingest and adjacency construction the reference leaves to
// Omega_h (ask_up(dim-1,dim) face->element lists, its mesh reader) is host
// work around the walk on the card. It is compiled here with g++ and called
// through ctypes (pumiumtally_tpu_torch/native/__init__.py), and every table
// it returns is bit for bit the one the numpy path of mesh/core.py and
// mesh/io.py computes:
//   * the three-term dot products add the first and third products before
//     the second, the order numpy's einsum("ij,ij->i") sums three terms;
//   * -ffp-contract=off keeps every product rounded on its own (GCC would
//     otherwise fuse them into FMAs where the host has them, aarch64
//     included), and no -march=native.
//
// Build (pumiumtally_tpu_torch/native/__init__.py does it at first use):
//   g++ -O3 -shared -fPIC -std=c++17 -pthread -ffp-contract=off
//       pumi_native.cpp -o libpumi_native-<hash>.so

#include <atomic>
#include <memory>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int64_t hardware_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int64_t>(n);
}

// Run fn(begin, end) over [0, n) split across worker threads.
template <typename F>
void parallel_for_ranges(int64_t n, F fn) {
  int64_t nthreads = std::min<int64_t>(hardware_threads(), std::max<int64_t>(n / 4096, 1));
  if (nthreads <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int64_t t = 0; t < nthreads; ++t) {
    int64_t b = t * chunk, e = std::min(n, b + chunk);
    if (b >= e) break;
    threads.emplace_back([=] { fn(b, e); });
  }
  for (auto& th : threads) th.join();
}

// Local vertex triples of the face opposite each local vertex — must match
// FACE_LOCAL_VERTS in pumiumtally_tpu_torch/mesh/core.py.
constexpr int kFaceLocal[4][3] = {{1, 2, 3}, {0, 2, 3}, {0, 1, 3}, {0, 1, 2}};

inline uint64_t mix(uint64_t x) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdULL;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ULL;
  x ^= x >> 33;
  return x;
}

inline uint64_t face_hash(int64_t a, int64_t b, int64_t c) {
  return mix(static_cast<uint64_t>(a) * 0x9e3779b97f4a7c15ULL ^
             mix(static_cast<uint64_t>(b)) ^
             mix(static_cast<uint64_t>(c) * 0x2545f4914f6cdd1dULL));
}

// a . b summed as numpy's einsum("ij,ij->i") sums three terms: (0 + 2) + 1
// into an accumulator that starts at +0, so a zero sum is never -0.
inline double dot3(const double* a, const double* b) {
  const double s = (a[0] * b[0] + a[2] * b[2]) + a[1] * b[1];
  return s == 0.0 ? 0.0 : s;
}

inline void sort3(int64_t& a, int64_t& b, int64_t& c) {
  if (a > b) std::swap(a, b);
  if (b > c) std::swap(b, c);
  if (a > b) std::swap(a, b);
}

}  // namespace

extern "C" {

// Face-adjacency table: out[t*4+f] = neighbor across the face opposite local
// vertex f, or -1 on the domain boundary (Omega_h ask_up(dim-1,dim)
// equivalent, reference .cpp:415-433, built once instead of traversed per
// crossing). Open-addressing hash on sorted vertex triples; single writer
// pass (deterministic). Returns 0 on success, 1 on a non-manifold face
// (>2 owners).
int pn_build_tet2tet(const int64_t* tet2vert, int64_t ntet, int64_t* out) {
  const int64_t nfaces = ntet * 4;
  // Power-of-two table, ~2x load headroom.
  uint64_t cap = 1;
  while (cap < static_cast<uint64_t>(nfaces) * 2) cap <<= 1;
  const uint64_t mask = cap - 1;
  struct Slot {
    int64_t key3[3];
    int64_t owner;  // packed t*4+f of first owner; -1 = empty
  };
  std::vector<Slot> table(cap);
  for (auto& s : table) s.owner = -1;

  std::atomic<int> bad{0};
  // Phase 1: fill hash table with every face (serial insert is the simplest
  // deterministic correct scheme; the probe loop is memory-bound and still
  // ~50M faces/s). Pair on collision of equal keys.
  for (int64_t t = 0; t < ntet; ++t) {
    for (int f = 0; f < 4; ++f) {
      int64_t a = tet2vert[t * 4 + kFaceLocal[f][0]];
      int64_t b = tet2vert[t * 4 + kFaceLocal[f][1]];
      int64_t c = tet2vert[t * 4 + kFaceLocal[f][2]];
      sort3(a, b, c);
      uint64_t h = face_hash(a, b, c) & mask;
      for (;;) {
        Slot& s = table[h];
        if (s.owner == -1) {
          s.key3[0] = a;
          s.key3[1] = b;
          s.key3[2] = c;
          s.owner = t * 4 + f;
          out[t * 4 + f] = -1;
          break;
        }
        if (s.key3[0] == a && s.key3[1] == b && s.key3[2] == c) {
          if (s.owner < 0) {  // already paired twice -> non-manifold
            bad.store(1);
            out[t * 4 + f] = -1;
          } else {
            int64_t ot = s.owner / 4, of = s.owner % 4;
            out[t * 4 + f] = ot;
            out[ot * 4 + of] = t;
            s.owner = -2;  // consumed
          }
          break;
        }
        h = (h + 1) & mask;
      }
    }
  }
  return bad.load();
}

// Derived geometry tables in one multithreaded pass over the elements:
//   * canonicalize orientation in place (swap last two verts when the signed
//     volume is negative) — _canonicalize_orientation parity,
//   * volumes[t] = det/6 (> 0 after canonicalization) — simplex_size parity
//     (reference .cpp:665-666),
//   * unit outward face normals[t*12 + f*3 + k] and plane offsets
//     face_d[t*4+f] with the opposite vertex on the inside — _face_planes
//     parity (hot-walk tables, no per-crossing vertex gathers).
void pn_derive_geometry(const double* coords, int64_t* tet2vert, int64_t ntet,
                        double* volumes, double* normals, double* face_d) {
  parallel_for_ranges(ntet, [&](int64_t begin, int64_t end) {
    for (int64_t t = begin; t < end; ++t) {
      int64_t* tv = tet2vert + t * 4;
      double v[4][3];
      for (int i = 0; i < 4; ++i)
        for (int k = 0; k < 3; ++k) v[i][k] = coords[tv[i] * 3 + k];
      double e1[3], e2[3], e3[3];
      for (int k = 0; k < 3; ++k) {
        e1[k] = v[1][k] - v[0][k];
        e2[k] = v[2][k] - v[0][k];
        e3[k] = v[3][k] - v[0][k];
      }
      const double c[3] = {e2[1] * e3[2] - e2[2] * e3[1],
                           e2[2] * e3[0] - e2[0] * e3[2],
                           e2[0] * e3[1] - e2[1] * e3[0]};
      double det = dot3(e1, c);
      if (det < 0) {
        std::swap(tv[2], tv[3]);
        for (int k = 0; k < 3; ++k) std::swap(v[2][k], v[3][k]);
        det = -det;
      }
      volumes[t] = det / 6.0;
      for (int f = 0; f < 4; ++f) {
        const double* a = v[kFaceLocal[f][0]];
        const double* b = v[kFaceLocal[f][1]];
        const double* c = v[kFaceLocal[f][2]];
        double ab[3], ac[3];
        for (int k = 0; k < 3; ++k) {
          ab[k] = b[k] - a[k];
          ac[k] = c[k] - a[k];
        }
        double n[3] = {ab[1] * ac[2] - ab[2] * ac[1],
                       ab[2] * ac[0] - ab[0] * ac[2],
                       ab[0] * ac[1] - ab[1] * ac[0]};
        const double* opp = v[f];
        const double to_opp[3] = {opp[0] - a[0], opp[1] - a[1],
                                  opp[2] - a[2]};
        double side = dot3(n, to_opp);
        double flip = side > 0 ? -1.0 : 1.0;
        double norm = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
        if (norm == 0.0) norm = 1.0;
        for (int k = 0; k < 3; ++k) n[k] = flip * n[k] / norm;
        normals[t * 12 + f * 3 + 0] = n[0];
        normals[t * 12 + f * 3 + 1] = n[1];
        normals[t * 12 + f * 3 + 2] = n[2];
        face_d[t * 4 + f] = dot3(n, a);
      }
    }
  });
}

// ---------------------------------------------------------------------------
// Gmsh ASCII reader (v2.2 and v4.1; keeps only 4-node tetrahedra, element
// type 4). Two-call protocol: pn_gmsh_open parses the whole file into an
// opaque handle and reports sizes; pn_gmsh_fill copies into caller
// buffers. Replaces the reference's Omega_h binary mesh reader call site
// (read_pumipic_lib_and_full_mesh, .cpp:891-909) with the standard
// unstructured-tet interchange format.
// ---------------------------------------------------------------------------

struct GmshData {
  std::vector<double> coords;     // [n_nodes*3], renumbered dense
  std::vector<int64_t> tet2vert;  // [n_tets*4], 0-based dense vertex ids
  std::vector<int32_t> class_id;  // [n_tets]
};

namespace {

// Minimal fast tokenizer over a malloc'd file image.
struct Cursor {
  const char* p;
  const char* end;
  bool ok = true;
  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
  }
  int64_t next_i64() {
    skip_ws();
    char* q = nullptr;
    long long v = strtoll(p, &q, 10);
    if (q == p) ok = false;
    p = q;
    return v;
  }
  double next_f64() {
    skip_ws();
    char* q = nullptr;
    double v = strtod(p, &q);
    if (q == p) ok = false;
    p = q;
    return v;
  }
  bool seek_line(const char* tag) {
    size_t len = strlen(tag);
    const char* s = p;
    while (s < end) {
      const char* nl = static_cast<const char*>(memchr(s, '\n', end - s));
      size_t linelen = nl ? static_cast<size_t>(nl - s) : static_cast<size_t>(end - s);
      while (linelen && (s[linelen - 1] == '\r')) --linelen;
      if (linelen == len && memcmp(s, tag, len) == 0) {
        p = nl ? nl + 1 : end;
        return true;
      }
      if (!nl) break;
      s = nl + 1;
    }
    return false;
  }
};

// Node counts per Gmsh element type 1..15 (same codes in v2 and v4; type
// 15 points appear in most real exports with physical points and must be
// skippable, not fatal).
const int kNvertsForType[16] = {0, 2, 3, 4, 4,  8,  6,  5,
                                3, 6, 9, 10, 27, 18, 14, 1};

// Dense remap is only sensible for near-dense id spaces; sparse/huge ids
// (legal in Gmsh) fall back to the Python dict-based renumbering rather
// than attempting a max_id-sized allocation.
bool build_remap(const std::vector<int64_t>& node_ids, int64_t max_id,
                 std::vector<int64_t>& remap) {
  int64_t nn = static_cast<int64_t>(node_ids.size());
  if (max_id < 0 || max_id > nn * 8 + (1 << 20)) return false;
  remap.assign(static_cast<size_t>(max_id) + 1, -1);
  for (int64_t i = 0; i < nn; ++i) remap[node_ids[i]] = i;
  return true;
}

GmshData* parse_gmsh_v41(Cursor cur, int64_t* n_nodes, int64_t* n_tets) {
  // v4.1 ASCII layout: block-structured $Nodes (header
  // `numBlocks numNodes minTag maxTag`, each block `dim tag parametric
  // numInBlock` followed by numInBlock node tags then numInBlock xyz
  // lines) and $Elements (header `numBlocks numElems minTag maxTag`,
  // each block `dim entityTag elemType numInBlock` followed by
  // `elemTag node...` rows). class_id = the block's entity tag,
  // matching the Python parser and the reference's region tag use.
  if (!cur.seek_line("$Nodes")) return nullptr;
  int64_t nblocks = cur.next_i64();
  int64_t nn = cur.next_i64();
  cur.next_i64();  // minNodeTag
  cur.next_i64();  // maxNodeTag
  if (!cur.ok || nn <= 0 || nblocks < 0) return nullptr;
  std::vector<int64_t> node_ids(nn);
  std::vector<double> raw_coords(nn * 3);
  int64_t k = 0, max_id = 0;
  for (int64_t b = 0; b < nblocks && cur.ok; ++b) {
    cur.next_i64();  // entityDim
    cur.next_i64();  // entityTag
    int64_t parametric = cur.next_i64();
    int64_t nb = cur.next_i64();
    // nb > nn - k (not k + nb > nn): the latter can wrap negative on a
    // corrupt header claiming ~INT64_MAX nodes and bypass the bound.
    if (!cur.ok || parametric != 0 || nb < 0 || nb > nn - k) return nullptr;
    for (int64_t i = 0; i < nb; ++i) {
      node_ids[k + i] = cur.next_i64();
      if (node_ids[k + i] > max_id) max_id = node_ids[k + i];
    }
    for (int64_t i = 0; i < nb; ++i) {
      raw_coords[(k + i) * 3 + 0] = cur.next_f64();
      raw_coords[(k + i) * 3 + 1] = cur.next_f64();
      raw_coords[(k + i) * 3 + 2] = cur.next_f64();
    }
    k += nb;
  }
  if (!cur.ok || k != nn) return nullptr;
  std::vector<int64_t> remap;
  if (!build_remap(node_ids, max_id, remap)) return nullptr;

  if (!cur.seek_line("$Elements")) return nullptr;
  int64_t eblocks = cur.next_i64();
  int64_t ne = cur.next_i64();
  cur.next_i64();  // minElementTag
  cur.next_i64();  // maxElementTag
  if (!cur.ok || eblocks < 0 || ne < 0) return nullptr;
  auto data = std::make_unique<GmshData>();
  data->coords = std::move(raw_coords);
  // Avoid push_back reallocation churn on multi-million-tet meshes (the
  // workload this fast path exists for); cap against a corrupt header.
  int64_t reserve_n = ne < (1 << 28) ? ne : (1 << 28);
  data->tet2vert.reserve(static_cast<size_t>(reserve_n) * 4);
  data->class_id.reserve(static_cast<size_t>(reserve_n));
  for (int64_t b = 0; b < eblocks && cur.ok; ++b) {
    cur.next_i64();  // entityDim
    int64_t etag = cur.next_i64();
    int64_t etype = cur.next_i64();
    int64_t nb = cur.next_i64();
    if (!cur.ok || nb < 0) return nullptr;
    int nv = (etype >= 1 && etype <= 15)
                 ? kNvertsForType[etype]
                 : -1;
    if (nv < 0) return nullptr;  // unknown element type — cannot skip
    for (int64_t e = 0; e < nb && cur.ok; ++e) {
      cur.next_i64();  // element tag
      if (etype == 4) {
        for (int v = 0; v < 4; ++v) {
          int64_t nid = cur.next_i64();
          if (nid < 0 || nid > max_id || remap[nid] < 0) return nullptr;
          data->tet2vert.push_back(remap[nid]);
        }
        data->class_id.push_back(static_cast<int32_t>(etag));
      } else {
        for (int v = 0; v < nv; ++v) cur.next_i64();
      }
    }
  }
  if (!cur.ok || data->tet2vert.empty()) return nullptr;
  *n_nodes = nn;
  *n_tets = static_cast<int64_t>(data->class_id.size());
  return data.release();
}

}  // namespace

// Returns handle (or nullptr). Sets *n_nodes, *n_tets.
void* pn_gmsh_open(const char* path, int64_t* n_nodes, int64_t* n_tets) try {
  FILE* fp = fopen(path, "rb");
  if (!fp) return nullptr;
  fseek(fp, 0, SEEK_END);
  long size = ftell(fp);
  fseek(fp, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(size) + 1);
  size_t rd = fread(buf.data(), 1, static_cast<size_t>(size), fp);
  fclose(fp);
  buf[rd] = '\0';

  Cursor cur{buf.data(), buf.data() + rd};
  if (!cur.seek_line("$MeshFormat")) return nullptr;
  double version = cur.next_f64();
  int64_t is_binary = cur.next_i64();
  if (!cur.ok || is_binary != 0) return nullptr;  // binary → Python/error
  if (version >= 4.0 && version < 5.0)
    return parse_gmsh_v41(cur, n_nodes, n_tets);
  if (version >= 4.0) return nullptr;  // unknown major → Python fallback

  if (!cur.seek_line("$Nodes")) return nullptr;
  int64_t nn = cur.next_i64();
  if (!cur.ok || nn <= 0) return nullptr;
  std::vector<int64_t> node_ids(nn);
  std::vector<double> raw_coords(nn * 3);
  int64_t max_id = 0;
  for (int64_t i = 0; i < nn; ++i) {
    node_ids[i] = cur.next_i64();
    raw_coords[i * 3 + 0] = cur.next_f64();
    raw_coords[i * 3 + 1] = cur.next_f64();
    raw_coords[i * 3 + 2] = cur.next_f64();
    if (node_ids[i] > max_id) max_id = node_ids[i];
  }
  if (!cur.ok) return nullptr;
  std::vector<int64_t> remap;
  if (!build_remap(node_ids, max_id, remap)) return nullptr;

  if (!cur.seek_line("$Elements")) return nullptr;
  int64_t ne = cur.next_i64();
  if (!cur.ok || ne < 0) return nullptr;

  auto data = std::make_unique<GmshData>();
  data->coords = std::move(raw_coords);
  data->tet2vert.reserve(ne * 4);
  data->class_id.reserve(ne);
  for (int64_t e = 0; e < ne && cur.ok; ++e) {
    cur.next_i64();  // element id
    int64_t etype = cur.next_i64();
    int64_t ntags = cur.next_i64();
    int64_t first_tag = 0;
    for (int64_t t = 0; t < ntags; ++t) {
      int64_t tag = cur.next_i64();
      if (t == 0) first_tag = tag;
    }
    int nv = (etype >= 1 && etype <= 15) ? kNvertsForType[etype] : -1;
    if (nv < 0) return nullptr;  // unknown element type — cannot skip safely
    if (etype == 4) {
      for (int k = 0; k < 4; ++k) {
        int64_t nid = cur.next_i64();
        if (nid < 0 || nid > max_id || remap[nid] < 0) return nullptr;
        data->tet2vert.push_back(remap[nid]);
      }
      data->class_id.push_back(static_cast<int32_t>(ntags > 0 ? first_tag : 0));
    } else {
      for (int k = 0; k < nv; ++k) cur.next_i64();
    }
  }
  if (!cur.ok || data->tet2vert.empty()) return nullptr;
  *n_nodes = nn;
  *n_tets = static_cast<int64_t>(data->class_id.size());
  return data.release();
} catch (...) {
  // Never let an exception (e.g. bad_alloc) unwind through the C ABI into
  // ctypes; a null return routes callers to the Python parser.
  return nullptr;
}

void pn_gmsh_fill(void* handle, double* coords, int64_t* tet2vert,
                  int32_t* class_id) {
  auto* d = static_cast<GmshData*>(handle);
  memcpy(coords, d->coords.data(), d->coords.size() * sizeof(double));
  memcpy(tet2vert, d->tet2vert.data(), d->tet2vert.size() * sizeof(int64_t));
  memcpy(class_id, d->class_id.data(), d->class_id.size() * sizeof(int32_t));
}

void pn_gmsh_free(void* handle) { delete static_cast<GmshData*>(handle); }

int pn_abi_version() { return 1; }

}  // extern "C"
