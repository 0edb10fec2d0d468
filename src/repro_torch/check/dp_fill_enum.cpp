// Host-only enumerator of the DP-fill kernels' memory accesses, for
// repro_torch/check/kernel_analyzer.py.
//
// It includes the header the CUDA kernels compile (DP_FILL_INDEX_HEADER,
// normally kernels/csrc/dp_fill_index.cuh) and instantiates the kernel
// bodies with shadow views and a host execution context: every launch of a
// case runs every block of its grid, every thread of a block, phase by phase
// between the barriers the body asks for, and for the fused fills every band
// in turn with a grid-wide barrier between bands.  Values are abstracted to
// their validity (Val); indices are computed concretely from the case's
// integer operands.  The views check, for each access:
//
//   out-of-bounds    a table's row and column against its driver shape, a
//                    vector's index against its length, a shared index
//                    against its carve segment and the block's allocation;
//   final-invalid    a read of a cell no earlier band wrote (fused), of a
//                    row the per-band fill has not published (band_min), of
//                    unwritten shared memory; at the end, any real cell not
//                    written exactly once from valid values;
//   grid-race        a fused read of the current band's own cells (ordered
//                    against their writes by no grid barrier); two threads
//                    of a block touching one shared word between barriers,
//                    one of them writing;
//   clobber          a write to a cell of another band, or a second write;
//   read-only-write  a write to an input.
//
// Protocol: one case a line on standard input,
//
//   fused <offload> <L> <W> <grid> <allow_fall> <host_on> <ncells> <vec>
//         off[L+2] wa[vec] wb[vec] mn[L*L] ma[L*L]
//   stacked <kAcc> <d> <ns> <w> <warps> <rows> <cols> <toff> <out>
//   tables <kAcc> <c3> <L> <S> <width> <warps> <ncells> <rcols> <lcols>
//          <cbcols> <wa> <cum> <toff> <out> wa[wa]
//
// the shapes (table rows and columns, vector and output lengths) being the
// driver contract the analyzer states (kernel_analyzer.py).
//
// and for each, lines "issue\t<kind>\t<message>" (at most three a kind;
// "more\t<kind>\t<n>" counts the rest), one "stats\t..." line and "end".

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <iostream>
#include <map>
#include <set>
#include <sstream>
#include <string>
#include <vector>

#include DP_FILL_INDEX_HEADER

namespace shadow {

using dpfill::kThreads;

// a value's validity: false for anything computed from memory no one wrote
// or from a register no one set
struct Val {
  bool ok;
  Val() : ok(false) {}
  Val(float) : ok(true) {}  // NOLINT: constants are valid
};

inline Val meet(Val a, Val b) {
  Val v;
  v.ok = a.ok && b.ok;
  return v;
}
inline Val operator+(Val a, Val b) { return meet(a, b); }
inline Val operator-(Val a, Val b) { return meet(a, b); }
inline Val fminf(Val a, Val b) { return meet(a, b); }
inline Val fmaxf(Val a, Val b) { return meet(a, b); }

struct Report {
  std::map<std::string, int64_t> counts;
  void issue(const char* kind, const std::string& msg) {
    if (counts[kind]++ < 3) std::printf("issue\t%s\t%s\n", kind, msg.c_str());
  }
  void close() {
    for (const auto& kv : counts)
      if (kv.second > 3)
        std::printf("more\t%s\t%lld\n", kv.first.c_str(),
                    static_cast<long long>(kv.second - 3));
    counts.clear();
  }
};

struct Word {
  int ival = 0;
  bool vok = false, written = false;
  int64_t w_epoch = -1, w_thread = -1;
  int64_t r_epoch = -1, r_thread = -1;  // r_thread -2: read by several
};

// the state of one launch (or, for a fused fill, of the whole fill)
struct Emu {
  Report* rep = nullptr;
  int band = 0;              // the band running (fused) or launched
  int block = 0, block_y = 0, grid = 1, grid_y = 1, threads = kThreads;
  bool in_block = false;     // the body runs for one block (each: its threads)
  int64_t thread = -1;       // the running thread, unique in the launch
  std::vector<std::vector<Word>> smem;   // per block
  std::vector<int64_t> epoch;            // per block: barriers passed
  int64_t reads = 0, writes = 0, shared = 0;
  int64_t regs = 0;          // Regs built
  int64_t rounds = 0;        // the most a block built in one band
  int words = 0;

  void reset_smem(int nblocks, int nwords) {
    words = nwords;
    smem.assign(nblocks, std::vector<Word>(nwords));
    epoch.assign(nblocks, 0);
  }
  int linear() const { return block_y * grid + block; }
};

thread_local Emu* g_emu = nullptr;

std::string where(const char* name, int64_t r, int64_t c) {
  std::ostringstream s;
  s << name << "[" << r << ", " << c << "]";
  return s.str();
}

// a float table of (rows, cols) cells
struct TableState {
  const char* name = "?";
  int64_t rows = 0, cols = 0;
  bool readonly = true;
  // fused: the band of each row (from off) and the writes so far
  std::vector<int> band_of_row;
  std::vector<int> wband;        // -1: never written; 0: staged before launch
  std::vector<uint8_t> ok;
  // band_min inputs: rows below this are published
  int64_t valid_rows = 0;
  bool fused = false;

  bool inside(int64_t r, int64_t c, const char* what) const {
    if (r < 0 || r >= rows || c < 0 || c >= cols) {
      std::ostringstream s;
      s << what << " " << where(name, r, c) << " outside (" << rows << ", "
        << cols << ") in band " << g_emu->band;
      g_emu->rep->issue("out-of-bounds", s.str());
      return false;
    }
    return true;
  }

  Val ld(int64_t r, int64_t c) {
    ++g_emu->reads;
    if (!inside(r, c, "read")) return Val();
    const int d = g_emu->band;
    if (!fused) {
      if (r >= valid_rows) {
        std::ostringstream s;
        s << "read " << where(name, r, c) << " of a row not published before"
          << " band " << d << " (rows < " << valid_rows << ")";
        g_emu->rep->issue("final-invalid", s.str());
        return Val();
      }
      return Val(0.f);
    }
    const int k = band_of_row[r];
    if (k == d) {
      std::ostringstream s;
      s << "band " << d << " reads its own cell " << where(name, r, c)
        << ", ordered against its write by no grid barrier";
      g_emu->rep->issue("grid-race", s.str());
      return Val();
    }
    const int64_t at = r * cols + c;
    if (k > d || wband[at] < 0) {
      std::ostringstream s;
      s << "band " << d << " reads " << where(name, r, c) << " of band " << k
        << " before any write";
      g_emu->rep->issue("final-invalid", s.str());
      return Val();
    }
    Val v;
    v.ok = ok[at] != 0;
    return v;
  }

  void st(int64_t r, int64_t c, Val v) {
    ++g_emu->writes;
    if (readonly) {
      g_emu->rep->issue("read-only-write",
                        std::string("write to the input ") + where(name, r, c));
      return;
    }
    if (!inside(r, c, "write")) return;
    const int d = g_emu->band;
    const int64_t at = r * cols + c;
    if (band_of_row[r] != d || wband[at] >= 0) {
      std::ostringstream s;
      s << "band " << d << " writes " << where(name, r, c) << " of band "
        << band_of_row[r]
        << (wband[at] >= 0 ? ", written already" : "");
      g_emu->rep->issue("clobber", s.str());
      if (wband[at] >= 0) {
        ok[at] = 0;
        return;
      }
    }
    wband[at] = d;
    ok[at] = v.ok;
  }
};

struct HTable {
  TableState* s;
  Val ld(int64_t r, int64_t c) const { return s->ld(r, c); }
  void st(int64_t r, int64_t c, Val v) const { s->st(r, c, v); }
};

// an integer or float input vector (an integer matrix when cols > 0)
template <class T>
struct HVec {
  const char* name = "?";
  std::vector<int> vals;   // integers; floats only count
  int64_t n = 0, cols = 0;

  bool inside(int64_t i) const {
    if (i < 0 || i >= n) {
      std::ostringstream s;
      s << "read " << name << "[" << i << "] outside [0, " << n
        << ") in band " << g_emu->band;
      g_emu->rep->issue("out-of-bounds", s.str());
      return false;
    }
    return true;
  }
  T ld(int64_t i) const;
  T ld(int64_t r, int64_t c) const {
    if (c < 0 || c >= cols || r < 0 || r * cols >= n) {
      std::ostringstream s;
      s << "read " << where(name, r, c) << " outside (" << (cols ? n / cols : 0)
        << ", " << cols << ") in band " << g_emu->band;
      g_emu->rep->issue("out-of-bounds", s.str());
      return T();
    }
    return ld(r * cols + c);
  }
  void st(int64_t i, T) const {
    std::ostringstream s;
    s << "write to the input " << name << "[" << i << "]";
    g_emu->rep->issue("read-only-write", s.str());
  }
};

template <>
inline int HVec<int>::ld(int64_t i) const {
  ++g_emu->reads;
  return inside(i) ? vals[i] : 0;
}
template <>
inline Val HVec<Val>::ld(int64_t i) const {
  ++g_emu->reads;
  return inside(i) ? Val(0.f) : Val();
}

// a flat output of n cells, the first `real` of which this launch owns
struct OutState {
  const char* name = "out";
  int64_t n = 0, real = 0;
  std::vector<int> writes;
  std::vector<uint8_t> ok;
};

struct HOut {
  OutState* s;
  void st(int64_t i, Val v) const {
    ++g_emu->writes;
    if (i < 0 || i >= s->real) {
      std::ostringstream o;
      o << "write " << s->name << "[" << i << "] outside "
        << (i < 0 || i >= s->n ? "the buffer" : "this band's result")
        << " [0, " << (i < 0 || i >= s->n ? s->n : s->real) << ")";
      g_emu->rep->issue("out-of-bounds", o.str());
      return;
    }
    if (s->writes[i]++) {
      std::ostringstream o;
      o << "second write of " << s->name << "[" << i << "]";
      g_emu->rep->issue("clobber", o.str());
    }
    s->ok[i] = v.ok;
  }
};

// one segment [base, base + len) of a block's shared memory
template <class T>
struct HShared {
  const char* name = "?";
  int base = 0, len = 0;

  Word* word(int i, const char* what) const {
    Emu& e = *g_emu;
    ++e.shared;
    if (i < 0 || i >= len || base + i < 0 || base + i >= e.words) {
      std::ostringstream s;
      s << what << " shared " << name << "[" << i << "] outside its "
        << len << " words (at " << base << " of " << e.words << ")";
      e.rep->issue("out-of-bounds", s.str());
      return nullptr;
    }
    return &e.smem[e.linear()][base + i];
  }
  void race(const char* what, int i) const {
    std::ostringstream s;
    s << "shared " << name << "[" << i << "]: " << what
      << " by two threads of block " << g_emu->linear()
      << " between barriers, band " << g_emu->band;
    g_emu->rep->issue("grid-race", s.str());
  }
  T ld(int i) const {
    Word* w = word(i, "read");
    if (!w) return T();
    Emu& e = *g_emu;
    const int64_t now = e.epoch[e.linear()];
    if (!w->written) {
      std::ostringstream s;
      s << "read of shared " << name << "[" << i << "] before any write";
      e.rep->issue("final-invalid", s.str());
      return T();
    }
    if (w->w_epoch == now && w->w_thread != e.thread) race("write, read", i);
    if (w->r_epoch == now && w->r_thread != e.thread)
      w->r_thread = -2;
    else
      w->r_thread = e.thread;
    w->r_epoch = now;
    return get(*w);
  }
  void st(int i, T v) const {
    Word* w = word(i, "write");
    if (!w) return;
    Emu& e = *g_emu;
    const int64_t now = e.epoch[e.linear()];
    if (w->w_epoch == now && w->w_thread != e.thread) race("write, write", i);
    if (w->r_epoch == now && w->r_thread != e.thread) race("read, write", i);
    w->w_epoch = now;
    w->w_thread = e.thread;
    w->written = true;
    put(*w, v);
  }
  static T get(const Word& w);
  static void put(Word& w, T v);
};

template <>
inline int HShared<int>::get(const Word& w) { return w.ival; }
template <>
inline void HShared<int>::put(Word& w, int v) { w.ival = v; }
template <>
inline Val HShared<Val>::get(const Word& w) {
  Val v;
  v.ok = w.vok;
  return v;
}
template <>
inline void HShared<Val>::put(Word& w, Val v) { w.vok = v.ok; }

// the execution context: see dp_fill_index.cuh
struct HostX {
  template <class T>
  struct Regs {
    std::vector<T> v;
    Regs() : v(g_emu->threads) { ++g_emu->regs; }
  };
  int block() const { return g_emu->block; }
  int block_y() const { return g_emu->block_y; }
  int grid() const { return g_emu->grid; }
  int block_warps() const { return g_emu->threads / 32; }

  template <class Fn>
  void run_threads(Fn&& fn) const {
    Emu& e = *g_emu;
    for (int t = 0; t < e.threads; ++t) {
      e.thread = static_cast<int64_t>(e.linear()) * e.threads + t;
      fn(t);
    }
  }
  template <class Fn>
  void each(Fn&& fn) const {
    Emu& e = *g_emu;
    if (e.in_block) {
      run_threads(fn);
      return;
    }
    for (int y = 0; y < e.grid_y; ++y)
      for (int b = 0; b < e.grid; ++b) {
        e.block = b;
        e.block_y = y;
        run_threads(fn);
      }
  }
  template <class T, class Fn>
  void each(Regs<T>& u, Fn&& fn) const {
    if (!g_emu->in_block) {
      g_emu->rep->issue("unsupported",
                        "per-thread registers outside a block's body");
      return;
    }
    run_threads([&](int t) { fn(t, u.v[t]); });
  }
  void sync() const {
    Emu& e = *g_emu;
    if (e.in_block)
      ++e.epoch[e.linear()];
    else
      for (auto& k : e.epoch) ++k;
  }
  template <class Fn>
  void bands(int L, Fn&& fn) const {
    Emu& e = *g_emu;
    for (int d = 1; d <= L; ++d) {
      e.band = d;
      for (int b = 0; b < e.grid; ++b) {
        e.block = b;
        e.in_block = true;
        const int64_t before = e.regs;
        fn(d);
        e.rounds = std::max(e.rounds, e.regs - before);
        e.in_block = false;
      }
      for (auto& k : e.epoch) ++k;                 // the grid barrier
    }
  }
};

struct HFused {
  using V = Val;
  HTable tb, te;
  HVec<int> off, wa, wb, mn, ma;
  HVec<Val> cum, uf, ub, toff, tpre;
  HShared<int> s_off, s_wa, s_wb;
  HShared<Val> s_cum, s_part;
  int L, W, allow_fall, host_on;
};

template <int kAcc>
struct HBand {
  using V = Val;
  HTable r, r3, cb;
  HTable lm[kAcc];
  HVec<int> wa;
  HVec<Val> cum, toff;
  HOut out;
  HShared<Val> part;
  int rows, c3, L, S, d, ns, w, g;
  const HTable& left(int a) const {
    if (a < 0 || a >= kAcc) {
      g_emu->rep->issue("out-of-bounds", "left table index outside kAcc");
      return lm[0];
    }
    return lm[a];
  }
};

std::vector<int> read_ints(std::istream& in, int64_t n) {
  std::vector<int> v(n);
  for (auto& x : v) in >> x;
  return v;
}

std::string join(const std::set<int>& s) {
  std::string out;
  for (int x : s) out += (out.empty() ? "" : ",") + std::to_string(x);
  return out;
}

// -- the fused fills -----------------------------------------------------------

template <bool kOffload>
void fused_case(std::istream& in, Report& rep) {
  int L, W, grid, allow_fall, host_on;
  int64_t ncells, vec;
  in >> L >> W >> grid >> allow_fall >> host_on >> ncells >> vec;
  const std::vector<int> off = read_ints(in, L + 2);
  const std::vector<int> wa = read_ints(in, vec), wb = read_ints(in, vec);
  const std::vector<int> mn = read_ints(in, static_cast<int64_t>(L) * L);
  const std::vector<int> ma = read_ints(in, static_cast<int64_t>(L) * L);
  Emu e;
  e.rep = &rep;
  e.grid = grid;
  g_emu = &e;
  const int nacc = kOffload ? 3 : 1;
  const dpfill::FusedCarve k = dpfill::fused_carve(L, nacc);
  const size_t bytes = dpfill::fused_smem_bytes(L, nacc);
  e.reset_smem(grid, static_cast<int>(bytes / 4));
  TableState tb, te;
  for (TableState* t : {&tb, &te}) {
    t->name = t == &tb ? "tb" : "te";
    t->fused = true;
    t->readonly = false;
    t->rows = (kOffload || t == &tb) ? ncells : 0;
    t->cols = W;
    t->band_of_row.assign(t->rows, -1);
    for (int d = 0; d <= L; ++d)
      for (int64_t r = off[d]; r < off[d + 1] && r < t->rows; ++r)
        if (r >= 0) t->band_of_row[r] = d;
    t->wband.assign(t->rows * W, -1);
    t->ok.assign(t->rows * W, 0);
    for (int64_t r = 0; r < L + 1 && r < t->rows; ++r)   // the base case
      for (int c = 0; c < W; ++c) {
        t->wband[r * W + c] = 0;
        t->ok[r * W + c] = 1;
      }
  }
  HFused f;
  f.tb = HTable{&tb};
  f.te = HTable{&te};
  auto ivec = [](const char* name, const std::vector<int>& v, int64_t cols) {
    HVec<int> h;
    h.name = name;
    h.vals = v;
    h.n = static_cast<int64_t>(v.size());
    h.cols = cols;
    return h;
  };
  auto fvec = [](const char* name, int64_t n) {
    HVec<Val> h;
    h.name = name;
    h.n = n;
    return h;
  };
  f.off = ivec("off", off, 0);
  f.wa = ivec("wa", wa, 0);
  f.wb = ivec("wb", wb, 0);
  f.mn = ivec("mn", mn, L);
  f.ma = ivec("ma", ma, L);
  f.cum = fvec("cum", vec);
  f.uf = fvec("uf", vec);
  f.ub = fvec("ub", vec);
  f.toff = fvec("toff", kOffload ? vec : 0);
  f.tpre = fvec("tpre", kOffload ? vec : 0);
  auto seg = [&](auto& s, const char* name, int base, int end) {
    s.name = name;
    s.base = base;
    s.len = end - base;
  };
  seg(f.s_off, "s_off", k.off, k.wa);
  seg(f.s_wa, "s_wa", k.wa, k.wb);
  seg(f.s_wb, "s_wb", k.wb, k.cum);
  seg(f.s_cum, "s_cum", k.cum, k.part);
  seg(f.s_part, "s_part", k.part, k.words);
  f.L = L;
  f.W = W;
  f.allow_fall = allow_fall;
  f.host_on = host_on;
  if (static_cast<int64_t>(k.words) * 4 != static_cast<int64_t>(bytes))
    rep.issue("out-of-bounds", "fused_smem_bytes disagrees with the carve");

  // each band's group size; the stride loop's rounds are the Regs a block
  // builds in a band (HostX::bands)
  std::set<int> gs;
  const int ntiles = (W + 31) / 32;
  for (int d = 1; d <= L; ++d)
    gs.insert(dpfill::fused_group_size(d, (L + 1 - d) * ntiles,
                                       grid * dpfill::kWarps));
  HostX x;
  dpfill::fused_fill_body<kOffload>(f, x);

  // every real cell valid, written exactly once (or staged)
  for (TableState* t : {&tb, &te}) {
    int64_t never = 0, garbage = 0;
    int64_t first = -1;
    for (int64_t i = 0; i < t->rows * W; ++i) {
      if (t->wband[i] < 0) ++never;
      else if (!t->ok[i]) ++garbage;
      else continue;
      if (first < 0) first = i;
    }
    if (never || garbage) {
      std::ostringstream s;
      s << (never + garbage) << " real cell(s) of " << t->name
        << " end the fill invalid (" << never << " never written, " << garbage
        << " from garbage; first " << where(t->name, first / W, first % W)
        << ")";
      rep.issue("final-invalid", s.str());
    }
  }
  rep.close();
  std::printf("stats\tg=%s\trounds=%lld\treads=%lld\twrites=%lld\tshared=%lld\n",
              join(gs).c_str(), static_cast<long long>(e.rounds),
              static_cast<long long>(e.reads),
              static_cast<long long>(e.writes),
              static_cast<long long>(e.shared));
  g_emu = nullptr;
}

// -- band_min ------------------------------------------------------------------

// one launch of band_min<kAcc>; returns its group size
template <int kAcc>
int band_launch(HBand<kAcc>& b, Emu& e, OutState& out, int warps) {
  const dpfill::BandGeometry k =
      dpfill::band_min_geometry(b.d, b.ns, b.w, warps);
  b.g = k.g;
  e.threads = 32 * k.block_warps;
  e.grid = b.ns;
  e.grid_y = static_cast<int>(k.groups);
  e.band = b.d;
  e.reset_smem(e.grid * e.grid_y, kAcc * kThreads);
  out.real = static_cast<int64_t>(kAcc) * b.ns * b.w;
  out.writes.assign(out.n, 0);
  out.ok.assign(out.n, 0);
  b.part.name = "s_part";
  b.part.base = 0;
  b.part.len = kAcc * kThreads;
  HostX x;
  for (int y = 0; y < e.grid_y; ++y)
    for (int bx = 0; bx < e.grid; ++bx) {
      e.block = bx;
      e.block_y = y;
      e.in_block = true;
      dpfill::band_min_body<kAcc>(b, x);
      e.in_block = false;
    }
  int64_t never = 0, garbage = 0, first = -1;
  for (int64_t i = 0; i < out.real && i < out.n; ++i) {
    if (!out.writes[i]) ++never;
    else if (!out.ok[i]) ++garbage;
    else continue;
    if (first < 0) first = i;
  }
  if (never || garbage) {
    std::ostringstream s;
    s << (never + garbage) << " cell(s) of band " << b.d << "'s result end "
      << "invalid (" << never << " never written, " << garbage
      << " from an unset or garbage value; first out[" << first << "])";
    e.rep->issue("final-invalid", s.str());
  }
  return k.g;
}

TableState input_table(const char* name, int64_t rows, int64_t cols,
                       int64_t valid_rows) {
  TableState t;
  t.name = name;
  t.rows = rows;
  t.cols = cols;
  t.valid_rows = valid_rows;
  return t;
}

template <int kAcc>
void band_case(const char* mode, std::istream& in, Report& rep) {
  Emu e;
  e.rep = &rep;
  g_emu = &e;
  std::set<int> gs;
  static const char* kLeft[3] = {"lm0", "lm1", "lm2"};
  if (std::string(mode) == "stacked") {
    int d, ns, w, warps;
    int64_t rows, cols, ntoff, nout;
    in >> d >> ns >> w >> warps >> rows >> cols >> ntoff >> nout;
    TableState r = input_table("r", rows, cols, rows);
    TableState r3 = input_table("r3", kAcc == 3 ? rows : 0, cols, rows);
    TableState cb = input_table("cb", 0, 0, 0);
    TableState lm[3];
    for (int a = 0; a < 3; ++a)
      lm[a] = input_table(kLeft[a], a < kAcc ? rows : 0, cols, rows);
    OutState out;
    out.n = nout;
    HBand<kAcc> b;
    b.r = HTable{&r};
    b.r3 = HTable{&r3};
    b.cb = HTable{&cb};
    for (int a = 0; a < kAcc; ++a) b.lm[a] = HTable{&lm[a]};
    b.wa.name = "wa";
    b.cum.name = "cum";
    b.toff.name = "toff";
    b.toff.n = ntoff;
    b.out = HOut{&out};
    b.rows = dpfill::kStacked;
    b.c3 = dpfill::kC3Operand;
    b.L = 0;
    b.S = 0;
    b.d = d;
    b.ns = ns;
    b.w = w;
    gs.insert(band_launch<kAcc>(b, e, out, warps));
  } else {
    int c3, L, S, width, warps;
    int64_t ncells, rcols, lcols, cbcols, nwa, ncum, ntoff, nout;
    in >> c3 >> L >> S >> width >> warps >> ncells >> rcols >> lcols
       >> cbcols >> nwa >> ncum >> ntoff >> nout;
    const std::vector<int> wa = read_ints(in, nwa);
    TableState r = input_table("r", ncells, rcols, 0);
    TableState r3 = input_table("r3", 0, 0, 0);
    TableState cb = input_table("cb", cbcols ? ncells : 0, cbcols, 0);
    TableState lm[3];
    for (int a = 0; a < 3; ++a)
      lm[a] = input_table(kLeft[a], a < kAcc ? ncells : 0, lcols, 0);
    OutState out;
    out.n = nout;
    HBand<kAcc> b;
    b.r = HTable{&r};
    b.r3 = HTable{&r3};
    b.cb = HTable{&cb};
    for (int a = 0; a < kAcc; ++a) b.lm[a] = HTable{&lm[a]};
    b.wa.name = "wa";
    b.wa.vals = wa;
    b.wa.n = nwa;
    b.cum.name = "cum";
    b.cum.n = ncum;
    b.toff.name = "toff";
    b.toff.n = ntoff;
    b.out = HOut{&out};
    b.rows = dpfill::kTables;
    b.c3 = kAcc == 3 ? c3 : -1;
    b.L = L;
    b.S = S;
    for (int d = 1; d <= L; ++d) {   // the per-band fill: bands in turn
      const int64_t published = dpfill::band_start(d, L);
      for (TableState* t : {&r, &r3, &cb, &lm[0], &lm[1], &lm[2]})
        t->valid_rows = published;
      b.d = d;
      b.ns = L + 1 - d;
      b.w = width;
      gs.insert(band_launch<kAcc>(b, e, out, warps));
    }
  }
  rep.close();
  std::printf("stats\tg=%s\trounds=%lld\treads=%lld\twrites=%lld\tshared=%lld\n",
              join(gs).c_str(), static_cast<long long>(e.rounds),
              static_cast<long long>(e.reads),
              static_cast<long long>(e.writes),
              static_cast<long long>(e.shared));
  g_emu = nullptr;
}

}  // namespace shadow

int main() {
  std::ios::sync_with_stdio(false);
  shadow::Report rep;
  std::string line;
  while (std::getline(std::cin, line)) {
    std::istringstream in(line);
    std::string kind;
    if (!(in >> kind)) continue;
    if (kind == "fused") {
      int offload;
      in >> offload;
      if (offload)
        shadow::fused_case<true>(in, rep);
      else
        shadow::fused_case<false>(in, rep);
    } else if (kind == "stacked" || kind == "tables") {
      int acc;
      in >> acc;
      if (acc == 1)
        shadow::band_case<1>(kind.c_str(), in, rep);
      else if (acc == 2)
        shadow::band_case<2>(kind.c_str(), in, rep);
      else
        shadow::band_case<3>(kind.c_str(), in, rep);
    } else {
      std::printf("issue\tunsupported\tunknown case %s\n", kind.c_str());
    }
    std::printf("end\n");
    std::fflush(stdout);
  }
  return 0;
}
