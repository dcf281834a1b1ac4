// manta_tpu native core: affine-gap SWG aligners with jump/large-indel
// states, exact integer DP with deterministic tie-breaking.
//
// Behavioral parity targets (reference, studied not copied):
//   - GlobalAligner          (alignment/GlobalAlignerImpl.hpp)
//   - GlobalJumpAligner      (alignment/GlobalJumpAlignerImpl.hpp)
//   - GlobalLargeIndelAligner(alignment/GlobalLargeIndelAlignerImpl.hpp)
//
// Design: flat row-state score vectors (two rolling rows), one packed
// pointer byte per (state) per cell, C ABI for ctypes binding. Paths are
// emitted as BAM cigar op codes (M=0, I=1, D=2, S=4).
//
// Build: g++ -O3 -shared -fPIC -o libmanta_core.so manta_core.cpp

#include <cctype>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <limits>
#include <vector>
#include <algorithm>

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
#endif

namespace {

constexpr int32_t BAD = -10000;

enum State : uint8_t { ST_MATCH = 0, ST_DELETE = 1, ST_INSERT = 2, ST_JUMP = 3, ST_JUMPINS = 4 };

// BAM cigar op codes for path output
constexpr uint8_t OP_M = 0, OP_I = 1, OP_D = 2, OP_S = 4, OP_NONE = 255;

struct Scores {
  int32_t match, mismatch, open, extend, off_edge;
  bool allow_edge_insertion;
};

struct Btrace {
  int32_t max = 0;
  uint8_t state = ST_MATCH;
  int32_t qb = 0, rb = 0;
  bool init = false;
};

inline void upd_btrace(Btrace& bt, int32_t v, int32_t r, int32_t q, uint8_t st = ST_MATCH) {
  if (!bt.init || v > bt.max) {
    bt.max = v; bt.rb = r; bt.qb = q; bt.init = true; bt.state = st;
  }
}

// winner-takes-first tie-breaking: later candidates only win on strict >
inline uint8_t best3(int32_t& out, int32_t v0, int32_t v1, int32_t v2) {
  out = v0; uint8_t p = 0;
  if (v1 > v0) { out = v1; p = 1; }
  if (v2 > out) { out = v2; p = 2; }
  return p;
}
inline uint8_t best4(int32_t& out, int32_t v0, int32_t v1, int32_t v2, int32_t v3) {
  out = v0; uint8_t p = 0;
  if (v1 > v0) { out = v1; p = 1; }
  if (v2 > out) { out = v2; p = 2; }
  if (v3 > out) { out = v3; p = 3; }
  return p;
}
inline uint8_t best5(int32_t& out, int32_t v0, int32_t v1, int32_t v2, int32_t v3, int32_t v4) {
  out = v0; uint8_t p = 0;
  if (v1 > v0) { out = v1; p = 1; }
  if (v2 > out) { out = v2; p = 2; }
  if (v3 > out) { out = v3; p = 3; }
  if (v4 > out) { out = v4; p = 4; }
  return p;
}

// incremental path builder replicating the updatePath/ps mechanics
struct PathBuilder {
  std::vector<uint8_t> ops;
  std::vector<int32_t> lens;
  uint8_t cur_op = OP_NONE;
  int32_t cur_len = 0;

  void switch_op(uint8_t op) {
    if (cur_op == op) return;
    if (cur_op != OP_NONE) { ops.push_back(cur_op); lens.push_back(cur_len); }
    cur_op = op;
    cur_len = 0;
  }
  void bump() { cur_len++; }
  void flush() {
    if (cur_op != OP_NONE) { ops.push_back(cur_op); lens.push_back(cur_len); }
    cur_op = OP_NONE; cur_len = 0;
  }
  void push_direct(uint8_t op, int32_t len) { ops.push_back(op); lens.push_back(len); }
  void reverse() {
    std::reverse(ops.begin(), ops.end());
    std::reverse(lens.begin(), lens.end());
  }
};

inline int emit_path(const PathBuilder& pb, uint8_t* out_ops, int32_t* out_lens,
                     int32_t* out_n, int32_t cap) {
  int n = (int)pb.ops.size();
  if (n > cap) return -1;
  for (int i = 0; i < n; i++) { out_ops[i] = pb.ops[i]; out_lens[i] = pb.lens[i]; }
  *out_n = n;
  return 0;
}

}  // namespace

// ---------------------------------------------------------------------------
// Global aligner (single reference, M/D/I states)

extern "C" int mt_align_global(
    const char* query, int32_t nq, const char* ref, int32_t nr,
    int32_t s_match, int32_t s_mismatch, int32_t s_open, int32_t s_extend,
    int32_t s_off_edge, int32_t allow_edge_ins,
    int32_t* out_score, int32_t* out_begin,
    uint8_t* out_ops, int32_t* out_lens, int32_t* out_n, int32_t cap) {
  if (nq <= 0 || nr <= 0) return -2;
  const Scores sc{s_match, s_mismatch, s_open, s_extend, s_off_edge,
                  allow_edge_ins != 0};

  std::vector<int32_t> m0(nq + 1), d0(nq + 1), i0(nq + 1);
  std::vector<int32_t> m1(nq + 1), d1(nq + 1), i1(nq + 1);
  int32_t *pm = m0.data(), *pd = d0.data(), *pi = i0.data();
  int32_t *cm = m1.data(), *cd = d1.data(), *ci = i1.data();

  // ptr codes: per cell, 3 states x 2 bits packed into one byte
  std::vector<uint8_t> ptr((size_t)(nq + 1) * (nr + 1));
  auto P = [&](int q, int r) -> uint8_t& { return ptr[(size_t)r * (nq + 1) + q]; };
  auto pack = [](uint8_t pm_, uint8_t pd_, uint8_t pi_) -> uint8_t {
    return (uint8_t)(pm_ | (pd_ << 2) | (pi_ << 4));
  };
  auto get_state_ptr = [&](uint8_t packed, uint8_t state) -> uint8_t {
    switch (state) {
      case ST_MATCH: return packed & 3;
      case ST_DELETE: return (packed >> 2) & 3;
      default: return (packed >> 4) & 3;
    }
  };

  for (int q = 0; q <= nq; q++) {
    cm[q] = q * sc.off_edge;
    cd[q] = BAD;
    if (!sc.allow_edge_insertion) {
      ci[q] = BAD;
      P(q, 0) = pack(ST_MATCH, ST_MATCH, ST_MATCH);
    } else {
      ci[q] = sc.open + q * sc.extend;
      P(q, 0) = pack(ST_MATCH, ST_MATCH, ST_INSERT);
    }
  }

  Btrace bt;
  for (int r = 0; r < nr; r++) {
    std::swap(cm, pm); std::swap(cd, pd); std::swap(ci, pi);
    cm[0] = 0; cd[0] = BAD; ci[0] = BAD;
    P(0, r + 1) = pack(ST_MATCH, ST_MATCH, ST_MATCH);
    const char rc = ref[r];
    for (int q = 0; q < nq; q++) {
      int32_t vm, vd, vi;
      uint8_t ptm = best3(vm, pm[q], pd[q], pi[q]);
      vm += (query[q] == rc ? sc.match : sc.mismatch);
      uint8_t ptd = best3(vd, pm[q + 1] + sc.open, pd[q + 1], pi[q + 1]);
      vd += sc.extend;
      if (q == 0) vd = BAD;
      uint8_t pti = best3(vi, cm[q] + sc.open, BAD, ci[q]);
      vi += sc.extend;
      if (q == 0) vi = BAD;
      cm[q + 1] = vm; cd[q + 1] = vd; ci[q + 1] = vi;
      P(q + 1, r + 1) = pack(ptm, ptd, pti);
    }
    upd_btrace(bt, cm[nq], r + 1, nq);
  }
  if (sc.allow_edge_insertion) upd_btrace(bt, ci[nq], nr, nq, ST_INSERT);
  for (int q = 0; q < nq; q++) {
    upd_btrace(bt, cm[q] + (nq - q) * sc.off_edge, nr, q);
  }

  // backtrace
  *out_score = bt.max;
  PathBuilder pb;
  if (bt.qb < nq) { pb.cur_op = OP_S; pb.cur_len = nq - bt.qb; }
  int q = bt.qb, r = bt.rb;
  uint8_t st = bt.state;
  while (true) {
    uint8_t next = get_state_ptr(P(q, r), st);
    if (st == ST_MATCH) {
      if (q < 1 || r < 1) break;
      pb.switch_op(OP_M); q--; r--;
    } else if (st == ST_DELETE) {
      if (r < 1) break;
      pb.switch_op(OP_D); r--;
    } else {  // INSERT
      if (q < 1) break;
      pb.switch_op(OP_I); q--;
    }
    st = next;
    pb.bump();
  }
  pb.flush();
  if (q != 0) pb.push_direct(OP_S, q);
  *out_begin = r;
  pb.reverse();
  return emit_path(pb, out_ops, out_lens, out_n, cap);
}

// ---------------------------------------------------------------------------
// Jump aligner (two references, M/D/I/J states)

extern "C" int mt_align_jump(
    const char* query, int32_t nq,
    const char* ref1, int32_t nr1, const char* ref2, int32_t nr2,
    int32_t s_match, int32_t s_mismatch, int32_t s_open, int32_t s_extend,
    int32_t s_off_edge, int32_t jump_score,
    int32_t* out_score,
    int32_t* out_begin1, uint8_t* out_ops1, int32_t* out_lens1, int32_t* out_n1,
    int32_t* out_begin2, uint8_t* out_ops2, int32_t* out_lens2, int32_t* out_n2,
    int32_t* out_jump_ins, int32_t* out_jump_range, int32_t cap) {
  if (nq <= 0 || nr1 <= 0 || nr2 <= 0) return -2;
  const int32_t jmp = jump_score;

  std::vector<int32_t> m0(nq + 1), d0(nq + 1), i0(nq + 1), j0(nq + 1);
  std::vector<int32_t> m1(nq + 1), d1(nq + 1), i1(nq + 1), j1(nq + 1);
  int32_t *pm = m0.data(), *pd = d0.data(), *pi = i0.data(), *pj = j0.data();
  int32_t *cm = m1.data(), *cd = d1.data(), *ci = i1.data(), *cj = j1.data();

  // pointer codes: 4 states x 2 bits per cell, one byte
  std::vector<uint8_t> ptr1((size_t)(nq + 1) * (nr1 + 1));
  std::vector<uint8_t> ptr2((size_t)(nq + 1) * (nr2 + 1));
  auto pack = [](uint8_t a, uint8_t b, uint8_t c, uint8_t d) -> uint8_t {
    return (uint8_t)(a | (b << 2) | (c << 4) | (d << 6));
  };
  auto get_ptr = [](uint8_t packed, uint8_t state) -> uint8_t {
    switch (state) {
      case ST_MATCH: return packed & 3;
      case ST_DELETE: return (packed >> 2) & 3;
      case ST_INSERT: return (packed >> 4) & 3;
      default: return (packed >> 6) & 3;
    }
  };

  for (int q = 0; q <= nq; q++) {
    cm[q] = q * s_off_edge;
    cd[q] = BAD; ci[q] = BAD; cj[q] = BAD;
    ptr1[q] = pack(ST_MATCH, ST_MATCH, ST_MATCH, ST_MATCH);
    ptr2[q] = pack(ST_MATCH, ST_MATCH, ST_MATCH, ST_MATCH);
  }

  Btrace bt;
  // --- ref1 phase
  for (int r = 0; r < nr1; r++) {
    std::swap(cm, pm); std::swap(cd, pd); std::swap(ci, pi); std::swap(cj, pj);
    cm[0] = 0; cd[0] = BAD; ci[0] = BAD; cj[0] = BAD;
    ptr1[(size_t)(r + 1) * (nq + 1)] = pack(ST_MATCH, ST_MATCH, ST_MATCH, ST_MATCH);
    const char rc = ref1[r];
    for (int q = 0; q < nq; q++) {
      int32_t vm, vd, vi, vj;
      uint8_t ptm = best3(vm, pm[q], pd[q], pi[q]);
      vm += (query[q] == rc ? s_match : s_mismatch);
      uint8_t ptd = best3(vd, pm[q + 1] + s_open, pd[q + 1], pi[q + 1]);
      vd += s_extend;
      if (q == 0) vd = BAD;
      uint8_t pti = best3(vi, cm[q] + s_open, BAD, ci[q]);
      vi += s_extend;
      if (q == 0) vi = BAD;
      // jump from this cell's completed match/ins scores, or carried jump
      uint8_t ptj = best4(vj, vm + jmp, BAD, vi + jmp, pj[q + 1]);
      cm[q + 1] = vm; cd[q + 1] = vd; ci[q + 1] = vi; cj[q + 1] = vj;
      ptr1[(size_t)(r + 1) * (nq + 1) + q + 1] = pack(ptm, ptd, pti, ptj);
    }
    upd_btrace(bt, cm[nq], r + 1, nq);
  }
  for (int q = 0; q < nq; q++) {
    upd_btrace(bt, cm[q] + (nq - q) * s_off_edge, nr1, q);
  }

  // --- reset match/del/ins for ref2, preserve jump
  for (int q = 0; q <= nq; q++) {
    cm[q] = q * s_off_edge;
    cd[q] = BAD; ci[q] = BAD;
  }

  // --- ref2 phase
  for (int r = 0; r < nr2; r++) {
    std::swap(cm, pm); std::swap(cd, pd); std::swap(ci, pi); std::swap(cj, pj);
    cm[0] = 0; cd[0] = BAD; ci[0] = BAD; cj[0] = BAD;
    ptr2[(size_t)(r + 1) * (nq + 1)] = pack(ST_MATCH, ST_MATCH, ST_MATCH, ST_MATCH);
    const char rc = ref2[r];
    for (int q = 0; q < nq; q++) {
      int32_t vm, vd, vi, vj;
      uint8_t ptm = best4(vm, pm[q], pd[q], pi[q], pj[q]);
      vm += (query[q] == rc ? s_match : s_mismatch);
      uint8_t ptd = best3(vd, pm[q + 1] + s_open, pd[q + 1], pi[q + 1]);
      vd += s_extend;
      // jump->ins transition skips the gap-open penalty (breakend insertions)
      uint8_t pti = best4(vi, cm[q] + s_open, BAD, ci[q], cj[q]);
      vi += s_extend;
      // jump carries across ref2 columns unchanged
      vj = pj[q + 1];
      uint8_t ptj = ST_JUMP;
      cm[q + 1] = vm; cd[q + 1] = vd; ci[q + 1] = vi; cj[q + 1] = vj;
      ptr2[(size_t)(r + 1) * (nq + 1) + q + 1] = pack(ptm, ptd, pti, ptj);
    }
    upd_btrace(bt, cm[nq], nr1 + r + 1, nq);
  }
  for (int q = 0; q < nq; q++) {
    upd_btrace(bt, cm[q] + (nq - q) * s_off_edge, nr1 + nr2, q);
  }

  // --- backtrace
  *out_score = bt.max;
  *out_jump_ins = 0;
  *out_jump_range = 0;
  PathBuilder pb1, pb2;
  // emulate the shared running-segment across both paths
  uint8_t cur_op = OP_NONE;
  int32_t cur_len = 0;
  int32_t begin1 = 0, begin2 = 0;
  bool begin2_set = false;

  if (bt.qb < nq) { cur_op = OP_S; cur_len = nq - bt.qb; }
  int q = bt.qb, r = bt.rb;
  uint8_t st = bt.state;
  bool is_ref2_end = false;

  auto switch_seg = [&](PathBuilder& target, uint8_t op) {
    if (cur_op == op) return;
    if (cur_op != OP_NONE) { target.push_direct(cur_op, cur_len); }
    cur_op = op; cur_len = 0;
  };

  while (q > 0 && r > 0) {
    if (is_ref2_end) break;
    const bool is_ref1 = (r <= nr1);
    PathBuilder& apath = is_ref1 ? pb1 : pb2;
    const int rx = r - (is_ref1 ? 0 : nr1);
    const uint8_t packed = is_ref1 ? ptr1[(size_t)rx * (nq + 1) + q]
                                   : ptr2[(size_t)rx * (nq + 1) + q];
    const uint8_t next = get_ptr(packed, st);

    if (st == ST_MATCH) {
      if (!is_ref1 && rx == 1 && next == ST_MATCH) is_ref2_end = true;
      switch_seg(apath, OP_M); q--; r--;
    } else if (st == ST_DELETE) {
      switch_seg(apath, OP_D); r--;
    } else if (st == ST_INSERT) {
      switch_seg(apath, OP_I); q--;
    } else {  // JUMP
      if (cur_op != OP_NONE) {
        begin2 = r - nr1;
        begin2_set = true;
        if (cur_op == OP_I) {
          *out_jump_ins += cur_len;
          cur_op = OP_NONE; cur_len = 0;
        } else {
          pb2.push_direct(cur_op, cur_len);
          cur_op = OP_NONE; cur_len = 0;
        }
      } else {
        if (next == ST_JUMP) r--;
      }
    }
    st = next;
    cur_len++;
  }

  {
    const bool is_ref1 = (r < nr1);
    PathBuilder& apath = is_ref1 ? pb1 : pb2;
    if (cur_op != OP_NONE) apath.push_direct(cur_op, cur_len);
    if (q != 0) apath.push_direct(OP_S, q);
    if (is_ref1) begin1 = r;
    else { begin2 = r - nr1; begin2_set = true; }
  }
  (void)begin2_set;

  pb1.reverse();
  pb2.reverse();
  *out_begin1 = begin1;
  *out_begin2 = begin2;

  // jumpRange: distance over which the breakpoint could shift right with
  // equal score (breakend homology)
  if (!pb1.ops.empty() && !pb2.ops.empty()) {
    int64_t ref1_len_used = 0, read1_len_used = 0, ref2_len_used = 0;
    for (size_t k = 0; k < pb1.ops.size(); k++) {
      if (pb1.ops[k] == OP_M || pb1.ops[k] == OP_D) ref1_len_used += pb1.lens[k];
      if (pb1.ops[k] == OP_M || pb1.ops[k] == OP_I || pb1.ops[k] == OP_S)
        read1_len_used += pb1.lens[k];
    }
    (void)ref2_len_used;
    int64_t r1 = begin1 + ref1_len_used;
    int64_t r2 = begin2;
    int64_t qk = read1_len_used;
    int32_t jic = *out_jump_ins;
    while (true) {
      if (r1 >= nr1) break;
      if (jic > 0) {
        if (qk >= nq) break;
        if (ref1[r1] != query[qk]) break;
      } else {
        if (r2 >= nr2) break;
        if (ref1[r1] != ref2[r2]) break;
      }
      (*out_jump_range)++;
      r1++;
      if (jic > 0) { jic--; qk++; } else { r2++; }
    }
  }

  int rc1 = emit_path(pb1, out_ops1, out_lens1, out_n1, cap);
  int rc2 = emit_path(pb2, out_ops2, out_lens2, out_n2, cap);
  return (rc1 < 0 || rc2 < 0) ? -1 : 0;
}

// ---------------------------------------------------------------------------
// Large-indel aligner (single ref; adds unpenalized-length jumpDel/jumpIns
// states entered at largeIndelScore)

extern "C" int mt_align_large_indel(
    const char* query, int32_t nq, const char* ref, int32_t nr,
    int32_t s_match, int32_t s_mismatch, int32_t s_open, int32_t s_extend,
    int32_t s_off_edge, int32_t allow_edge_ins, int32_t large_indel_score,
    int32_t* out_score, int32_t* out_begin, int32_t* out_is_jumped,
    uint8_t* out_ops, int32_t* out_lens, int32_t* out_n, int32_t cap) {
  if (nq <= 0 || nr <= 0) return -2;
  const int32_t lis = large_indel_score;
  const bool edge_ins = allow_edge_ins != 0;

  std::vector<int32_t> m0(nq + 1), d0(nq + 1), i0(nq + 1), jd0(nq + 1), ji0(nq + 1);
  std::vector<int32_t> m1(nq + 1), d1(nq + 1), i1(nq + 1), jd1(nq + 1), ji1(nq + 1);
  int32_t *pm = m0.data(), *pd = d0.data(), *pi = i0.data(), *pjd = jd0.data(), *pji = ji0.data();
  int32_t *cm = m1.data(), *cd = d1.data(), *ci = i1.data(), *cjd = jd1.data(), *cji = ji1.data();

  // 5 states x 3 bits -> use 2 bytes per cell
  std::vector<uint16_t> ptr((size_t)(nq + 1) * (nr + 1));
  auto pack = [](uint8_t a, uint8_t b, uint8_t c, uint8_t d, uint8_t e) -> uint16_t {
    return (uint16_t)(a | (b << 3) | (c << 6) | (d << 9) | (e << 12));
  };
  auto get_ptr = [](uint16_t packed, uint8_t state) -> uint8_t {
    switch (state) {
      case ST_MATCH: return packed & 7;
      case ST_DELETE: return (packed >> 3) & 7;
      case ST_INSERT: return (packed >> 6) & 7;
      case ST_JUMP: return (packed >> 9) & 7;
      default: return (packed >> 12) & 7;
    }
  };

  for (int q = 0; q <= nq; q++) {
    cm[q] = q * s_off_edge;
    cd[q] = BAD;
    cjd[q] = BAD; cji[q] = BAD;
    if (!edge_ins) {
      ci[q] = BAD;
      ptr[q] = pack(ST_MATCH, ST_MATCH, ST_MATCH, ST_MATCH, ST_MATCH);
    } else {
      ci[q] = s_open + q * s_extend;
      ptr[q] = pack(ST_MATCH, ST_MATCH, ST_INSERT, ST_MATCH, ST_MATCH);
    }
  }

  Btrace bt;
  for (int r = 0; r < nr; r++) {
    std::swap(cm, pm); std::swap(cd, pd); std::swap(ci, pi);
    std::swap(cjd, pjd); std::swap(cji, pji);
    cm[0] = 0; cd[0] = BAD; ci[0] = BAD; cjd[0] = BAD; cji[0] = BAD;
    ptr[(size_t)(r + 1) * (nq + 1)] = pack(ST_MATCH, ST_MATCH, ST_MATCH, ST_MATCH, ST_MATCH);
    const char rc = ref[r];
    for (int q = 0; q < nq; q++) {
      int32_t vm, vd, vi, vjd, vji;
      uint8_t ptm = best5(vm, pm[q], pd[q], pi[q], pjd[q], pji[q]);
      vm += (query[q] == rc ? s_match : s_mismatch);
      uint8_t ptd = best5(vd, pm[q + 1] + s_open, pd[q + 1], pi[q + 1], BAD, pji[q + 1]);
      vd += s_extend;
      if (q == 0) vd = BAD;
      uint8_t pti = best5(vi, cm[q] + s_open, BAD, ci[q], BAD, BAD);
      vi += s_extend;
      if (q == 0) vi = BAD;
      uint8_t ptjd = best5(vjd, pm[q + 1] + lis, BAD, pi[q + 1] + lis - s_open,
                           pjd[q + 1], pji[q + 1] + lis);
      if (q == 0) vjd = BAD;
      uint8_t ptji = best5(vji, cm[q] + lis, BAD, BAD, BAD, cji[q]);
      if (q == 0) vji = BAD;
      cm[q + 1] = vm; cd[q + 1] = vd; ci[q + 1] = vi; cjd[q + 1] = vjd; cji[q + 1] = vji;
      ptr[(size_t)(r + 1) * (nq + 1) + q + 1] = pack(ptm, ptd, pti, ptjd, ptji);
    }
    upd_btrace(bt, cm[nq], r + 1, nq);
  }
  if (edge_ins) upd_btrace(bt, ci[nq], nr, nq, ST_INSERT);
  for (int q = 0; q <= nq; q++) {
    upd_btrace(bt, cm[q] + (nq - q) * s_off_edge, nr, q);
  }

  *out_score = bt.max;
  *out_is_jumped = 0;
  PathBuilder pb;
  if (bt.qb < nq) { pb.cur_op = OP_S; pb.cur_len = nq - bt.qb; }
  int q = bt.qb, r = bt.rb;
  uint8_t st = bt.state;
  while (true) {
    const uint8_t next = get_ptr(ptr[(size_t)r * (nq + 1) + q], st);
    if (st == ST_MATCH) {
      if (q < 1 || r < 1) break;
      pb.switch_op(OP_M); q--; r--;
    } else if (st == ST_DELETE || st == ST_JUMP) {
      if (r < 1) break;
      pb.switch_op(OP_D); r--;
    } else {  // INSERT / JUMPINS
      if (q < 1) break;
      pb.switch_op(OP_I); q--;
    }
    if (st == ST_JUMP || st == ST_JUMPINS) *out_is_jumped = 1;
    st = next;
    pb.bump();
  }
  pb.flush();
  if (q != 0) pb.push_direct(OP_S, q);
  *out_begin = r;
  pb.reverse();
  return emit_path(pb, out_ops, out_lens, out_n, cap);
}

// ---------------------------------------------------------------------------
// Jump aligner with intron (splice) state for RNA spanning contigs.
// Behavioral parity target (studied not copied):
//   GlobalJumpIntronAligner (alignment/GlobalJumpIntronAlignerImpl.hpp)
// The splice state extends along the reference like an unpenalized
// deletion; it may only be entered where the reference starts a splice
// donor motif (GT fwd / CT rev) and exited where it ends a splice
// acceptor motif (AG fwd / AC rev); unstranded mode accepts both.

namespace {
constexpr uint8_t ST_SPLICE = 4;
constexpr uint8_t OP_N = 3;

inline bool splice_acceptor(const char* ref, int r, bool fw, bool stranded) {
  if (r < 2) return false;
  if ((fw || !stranded) && ref[r - 2] == 'A' && ref[r - 1] == 'G') return true;
  if ((!fw || !stranded) && ref[r - 2] == 'A' && ref[r - 1] == 'C') return true;
  return false;
}
inline bool splice_donor(const char* ref, int r, int nr, bool fw, bool stranded) {
  if (nr - r < 2) return false;
  if ((fw || !stranded) && ref[r] == 'G' && ref[r + 1] == 'T') return true;
  if ((!fw || !stranded) && ref[r] == 'C' && ref[r + 1] == 'T') return true;
  return false;
}
}  // namespace

extern "C" int mt_align_jump_intron(
    const char* query, int32_t nq,
    const char* ref1, int32_t nr1, const char* ref2, int32_t nr2,
    int32_t s_match, int32_t s_mismatch, int32_t s_open, int32_t s_extend,
    int32_t s_off_edge, int32_t jump_score,
    int32_t intron_open, int32_t intron_off_edge,
    int32_t ref1_fw, int32_t ref2_fw, int32_t is_stranded,
    int32_t* out_score,
    int32_t* out_begin1, uint8_t* out_ops1, int32_t* out_lens1, int32_t* out_n1,
    int32_t* out_begin2, uint8_t* out_ops2, int32_t* out_lens2, int32_t* out_n2,
    int32_t* out_jump_ins, int32_t* out_jump_range, int32_t cap) {
  if (nq <= 0 || nr1 <= 0 || nr2 <= 0) return -2;
  const int32_t jmp = jump_score;
  const bool fw1 = ref1_fw != 0, fw2 = ref2_fw != 0, strd = is_stranded != 0;

  std::vector<int32_t> m0(nq + 1), d0(nq + 1), i0(nq + 1), j0(nq + 1), sp0(nq + 1);
  std::vector<int32_t> m1(nq + 1), d1(nq + 1), i1(nq + 1), j1(nq + 1), sp1(nq + 1);
  int32_t *pm = m0.data(), *pd = d0.data(), *pi = i0.data(), *pj = j0.data(),
          *ps = sp0.data();
  int32_t *cm = m1.data(), *cd = d1.data(), *ci = i1.data(), *cj = j1.data(),
          *cs = sp1.data();

  // 5 states x 3 bits
  std::vector<uint16_t> ptr1((size_t)(nq + 1) * (nr1 + 1));
  std::vector<uint16_t> ptr2((size_t)(nq + 1) * (nr2 + 1));
  auto pack = [](uint8_t a, uint8_t b, uint8_t c, uint8_t d, uint8_t e) -> uint16_t {
    return (uint16_t)(a | (b << 3) | (c << 6) | (d << 9) | (e << 12));
  };
  auto get_ptr = [](uint16_t packed, uint8_t state) -> uint8_t {
    switch (state) {
      case ST_MATCH: return packed & 7;
      case ST_DELETE: return (packed >> 3) & 7;
      case ST_INSERT: return (packed >> 6) & 7;
      case ST_JUMP: return (packed >> 9) & 7;
      default: return (packed >> 12) & 7;
    }
  };
  const uint16_t all_match = 0;

  for (int q = 0; q <= nq; q++) {
    cm[q] = q * s_off_edge;
    cd[q] = BAD; ci[q] = BAD; cj[q] = BAD;
    cs[q] = q * intron_off_edge + intron_open;
    ptr1[q] = all_match;
    ptr2[q] = all_match;
  }

  Btrace bt;
  // --- ref1 phase
  for (int r = 0; r < nr1; r++) {
    std::swap(cm, pm); std::swap(cd, pd); std::swap(ci, pi);
    std::swap(cj, pj); std::swap(cs, ps);
    cm[0] = 0; cd[0] = BAD; ci[0] = BAD; cj[0] = BAD; cs[0] = BAD;
    ptr1[(size_t)(r + 1) * (nq + 1)] = all_match;
    const char rc = ref1[r];
    const bool acc = splice_acceptor(ref1, r, fw1, strd);
    const bool don = splice_donor(ref1, r, nr1, fw1, strd);
    for (int q = 0; q < nq; q++) {
      int32_t vm, vd, vi, vj, vs;
      uint8_t ptm = best3(vm, pm[q], pd[q], pi[q]);
      if (acc && vm < ps[q]) { vm = ps[q]; ptm = ST_SPLICE; }
      vm += (query[q] == rc ? s_match : s_mismatch);
      uint8_t ptd = best3(vd, pm[q + 1] + s_open, pd[q + 1], pi[q + 1] + s_open);
      vd += s_extend;
      if (q == 0) vd = BAD;
      uint8_t pti = best3(vi, cm[q] + s_open, BAD, ci[q]);
      vi += s_extend;
      if (q == 0) vi = BAD;
      uint8_t pts = ST_SPLICE;
      vs = ps[q + 1];
      if (don && pm[q + 1] + intron_open > vs) { vs = pm[q + 1] + intron_open; pts = ST_MATCH; }
      uint8_t ptj = best4(vj, vm + jmp, BAD, vi + jmp, pj[q + 1]);
      cm[q + 1] = vm; cd[q + 1] = vd; ci[q + 1] = vi; cj[q + 1] = vj; cs[q + 1] = vs;
      ptr1[(size_t)(r + 1) * (nq + 1) + q + 1] = pack(ptm, ptd, pti, ptj, pts);
    }
    upd_btrace(bt, cm[nq], r + 1, nq);
  }
  for (int q = 0; q < nq; q++) {
    const int32_t max_match = cm[q] + (nq - q) * s_off_edge;
    const int32_t max_intron = cs[q] + (nq - q) * intron_off_edge;
    if (max_match >= max_intron) upd_btrace(bt, max_match, nr1, q, ST_MATCH);
    else upd_btrace(bt, max_intron, nr1, q, ST_SPLICE);
  }

  // --- reset for ref2, preserve jump
  for (int q = 0; q <= nq; q++) {
    cm[q] = q * s_off_edge;
    cd[q] = BAD; ci[q] = BAD;
    cs[q] = q * intron_off_edge + intron_open;
  }

  // --- ref2 phase
  for (int r = 0; r < nr2; r++) {
    std::swap(cm, pm); std::swap(cd, pd); std::swap(ci, pi);
    std::swap(cj, pj); std::swap(cs, ps);
    cm[0] = 0; cd[0] = BAD; ci[0] = BAD; cj[0] = BAD; cs[0] = BAD;
    ptr2[(size_t)(r + 1) * (nq + 1)] = all_match;
    const char rc = ref2[r];
    const bool acc = splice_acceptor(ref2, r, fw2, strd);
    const bool don = splice_donor(ref2, r, nr2, fw2, strd);
    for (int q = 0; q < nq; q++) {
      int32_t vm, vd, vi, vj, vs;
      uint8_t ptm = best4(vm, pm[q], pd[q], pi[q], pj[q]);
      if (acc && vm < ps[q]) { vm = ps[q]; ptm = ST_SPLICE; }
      vm += (query[q] == rc ? s_match : s_mismatch);
      uint8_t ptd = best3(vd, pm[q + 1] + s_open, pd[q + 1], pi[q + 1] + s_open);
      vd += s_extend;
      // jump->ins transition skips the gap-open penalty
      uint8_t pti = best4(vi, cm[q] + s_open, BAD, ci[q], cj[q]);
      vi += s_extend;
      uint8_t pts = ST_SPLICE;
      vs = ps[q + 1];
      if (don && pm[q + 1] + intron_open > vs) { vs = pm[q + 1] + intron_open; pts = ST_MATCH; }
      vj = pj[q + 1];
      uint8_t ptj = ST_JUMP;
      cm[q + 1] = vm; cd[q + 1] = vd; ci[q + 1] = vi; cj[q + 1] = vj; cs[q + 1] = vs;
      ptr2[(size_t)(r + 1) * (nq + 1) + q + 1] = pack(ptm, ptd, pti, ptj, pts);
    }
    upd_btrace(bt, cm[nq], nr1 + r + 1, nq);
  }
  for (int q = 0; q < nq; q++) {
    const int32_t max_match = cm[q] + (nq - q) * s_off_edge;
    const int32_t max_intron = cs[q] + (nq - q) * intron_off_edge;
    if (max_match >= max_intron) upd_btrace(bt, max_match, nr1 + nr2, q, ST_MATCH);
    else upd_btrace(bt, max_intron, nr1 + nr2, q, ST_SPLICE);
  }

  // --- backtrace (mirrors mt_align_jump with the added SPLICE case)
  *out_score = bt.max;
  *out_jump_ins = 0;
  *out_jump_range = 0;
  PathBuilder pb1, pb2;
  uint8_t cur_op = OP_NONE;
  int32_t cur_len = 0;
  int32_t begin1 = 0, begin2 = 0;

  if (bt.qb < nq) { cur_op = OP_S; cur_len = nq - bt.qb; }
  int q = bt.qb, r = bt.rb;
  uint8_t st = bt.state;
  bool is_ref2_end = false;

  auto switch_seg = [&](PathBuilder& target, uint8_t op) {
    if (cur_op == op) return;
    if (cur_op != OP_NONE) { target.push_direct(cur_op, cur_len); }
    cur_op = op; cur_len = 0;
  };

  while (q > 0 && r > 0) {
    if (is_ref2_end) break;
    const bool is_ref1 = (r <= nr1);
    PathBuilder& apath = is_ref1 ? pb1 : pb2;
    const int rx = r - (is_ref1 ? 0 : nr1);
    const uint16_t packed = is_ref1 ? ptr1[(size_t)rx * (nq + 1) + q]
                                    : ptr2[(size_t)rx * (nq + 1) + q];
    const uint8_t next = get_ptr(packed, st);

    if (st == ST_MATCH) {
      if (!is_ref1 && rx == 1 && next == ST_MATCH) is_ref2_end = true;
      switch_seg(apath, OP_M); q--; r--;
    } else if (st == ST_DELETE) {
      switch_seg(apath, OP_D); r--;
    } else if (st == ST_SPLICE) {
      if (!is_ref1 && rx == 1 && next == ST_SPLICE) is_ref2_end = true;
      switch_seg(apath, OP_N); r--;
    } else if (st == ST_INSERT) {
      switch_seg(apath, OP_I); q--;
    } else {  // JUMP
      if (cur_op != OP_NONE) {
        begin2 = r - nr1;
        if (cur_op == OP_I) {
          *out_jump_ins += cur_len;
          cur_op = OP_NONE; cur_len = 0;
        } else {
          pb2.push_direct(cur_op, cur_len);
          cur_op = OP_NONE; cur_len = 0;
        }
      } else {
        if (next == ST_JUMP) r--;
      }
    }
    st = next;
    cur_len++;
  }

  {
    const bool is_ref1 = (r < nr1);
    PathBuilder& apath = is_ref1 ? pb1 : pb2;
    if (cur_op != OP_NONE) apath.push_direct(cur_op, cur_len);
    if (q != 0) apath.push_direct(OP_S, q);
    if (is_ref1) begin1 = r;
    else begin2 = r - nr1;
  }

  pb1.reverse();
  pb2.reverse();
  *out_begin1 = begin1;
  *out_begin2 = begin2;

  // jumpRange homology walk (same as mt_align_jump)
  if (!pb1.ops.empty() && !pb2.ops.empty()) {
    int64_t ref1_len_used = 0, read1_len_used = 0;
    for (size_t k = 0; k < pb1.ops.size(); k++) {
      if (pb1.ops[k] == OP_M || pb1.ops[k] == OP_D || pb1.ops[k] == OP_N)
        ref1_len_used += pb1.lens[k];
      if (pb1.ops[k] == OP_M || pb1.ops[k] == OP_I || pb1.ops[k] == OP_S)
        read1_len_used += pb1.lens[k];
    }
    int64_t r1 = begin1 + ref1_len_used;
    int64_t r2 = begin2;
    int64_t qk = read1_len_used;
    int32_t jic = *out_jump_ins;
    while (true) {
      if (r1 >= nr1) break;
      if (jic > 0) {
        if (qk >= nq) break;
        if (ref1[r1] != query[qk]) break;
      } else {
        if (r2 >= nr2) break;
        if (ref1[r1] != ref2[r2]) break;
      }
      (*out_jump_range)++;
      r1++;
      if (jic > 0) { jic--; qk++; } else { r2++; }
    }
  }

  int rc1 = emit_path(pb1, out_ops1, out_lens1, out_n1, cap);
  int rc2 = emit_path(pb2, out_ops2, out_lens2, out_n2, cap);
  return (rc1 < 0 || rc2 < 0) ? -1 : 0;
}

// ---------------------------------------------------------------------------
// BAM record parsing: single-pass native extraction of the
// struct-of-arrays ReadBatch layout (replaces the per-record Python loop
// over the uncompressed buffer; reference semantics: htslib bam_read1).

namespace {
constexpr char SEQ16[] = "=ACMGRSVTWYHKDBN";
}

extern "C" int mt_bam_size(
    const uint8_t* buf, int64_t buflen, int64_t start,
    int64_t* out_n, int64_t* out_cigar, int64_t* out_seq,
    int64_t* out_name, int64_t* out_tags) {
  int64_t n = 0, tot_cigar = 0, tot_seq = 0, tot_name = 0, tot_tags = 0;
  int64_t i = start;
  while (i + 4 <= buflen) {
    uint32_t bs;
    std::memcpy(&bs, buf + i, 4);
    if (i + 4 + (int64_t)bs > buflen) break;
    const uint8_t* p = buf + i + 4;
    const uint8_t lqn = p[8];
    uint16_t ncig;
    std::memcpy(&ncig, p + 12, 2);
    int32_t lseq;
    std::memcpy(&lseq, p + 16, 4);
    const int64_t var = 32;  // fixed fields after block_size
    const int64_t tag_len =
        (int64_t)bs - var - lqn - 4LL * ncig - ((lseq + 1) / 2) - lseq;
    n++;
    tot_cigar += ncig;
    tot_seq += lseq;
    tot_name += lqn - 1;
    tot_tags += (tag_len > 0 ? tag_len : 0);
    i += 4 + bs;
  }
  *out_n = n;
  *out_cigar = tot_cigar;
  *out_seq = tot_seq;
  *out_name = tot_name;
  *out_tags = tot_tags;
  return 0;
}

extern "C" int mt_bam_fill(
    const uint8_t* buf, int64_t buflen, int64_t start, int64_t n,
    int32_t* refid, int32_t* pos, uint8_t* mapq, uint16_t* flag,
    int32_t* nrefid, int32_t* npos, int32_t* tlen,
    int64_t* cigar_off, uint32_t* cigar_out,
    int64_t* seq_off, uint8_t* seq_out,
    int64_t* qual_off, uint8_t* qual_out,
    int64_t* name_off, uint8_t* name_out,
    int64_t* tag_off, uint8_t* tag_out) {
  int64_t i = start;
  int64_t k = 0;
  cigar_off[0] = seq_off[0] = qual_off[0] = name_off[0] = tag_off[0] = 0;
  while (i + 4 <= buflen && k < n) {
    uint32_t bs;
    std::memcpy(&bs, buf + i, 4);
    if (i + 4 + (int64_t)bs > buflen) break;
    const uint8_t* p = buf + i + 4;
    int32_t rid, pp, lseq, nrid, np_, tl;
    std::memcpy(&rid, p, 4);
    std::memcpy(&pp, p + 4, 4);
    const uint8_t lqn = p[8];
    const uint8_t mq = p[9];
    uint16_t ncig, fl;
    std::memcpy(&ncig, p + 12, 2);
    std::memcpy(&fl, p + 14, 2);
    std::memcpy(&lseq, p + 16, 4);
    std::memcpy(&nrid, p + 20, 4);
    std::memcpy(&np_, p + 24, 4);
    std::memcpy(&tl, p + 28, 4);
    refid[k] = rid; pos[k] = pp; mapq[k] = mq; flag[k] = fl;
    nrefid[k] = nrid; npos[k] = np_; tlen[k] = tl;

    const uint8_t* q = p + 32;
    std::memcpy(name_out + name_off[k], q, lqn - 1);
    name_off[k + 1] = name_off[k] + (lqn - 1);
    q += lqn;
    std::memcpy(cigar_out + cigar_off[k], q, 4LL * ncig);
    cigar_off[k + 1] = cigar_off[k] + ncig;
    q += 4LL * ncig;
    {
      uint8_t* dst = seq_out + seq_off[k];
      const int64_t half = (lseq + 1) / 2;
      for (int64_t b = 0; b < half; b++) {
        const uint8_t packed = q[b];
        dst[2 * b] = SEQ16[packed >> 4];
        if (2 * b + 1 < lseq) dst[2 * b + 1] = SEQ16[packed & 0xF];
      }
      seq_off[k + 1] = seq_off[k] + lseq;
      q += half;
    }
    std::memcpy(qual_out + qual_off[k], q, lseq);
    qual_off[k + 1] = qual_off[k] + lseq;
    q += lseq;
    const int64_t tag_len = (buf + i + 4 + bs) - q;
    if (tag_len > 0) std::memcpy(tag_out + tag_off[k], q, tag_len);
    tag_off[k + 1] = tag_off[k] + (tag_len > 0 ? tag_len : 0);

    i += 4 + bs;
    k++;
  }
  return (int)(k == n ? 0 : -1);
}

// Batch BAM record encoding: the inverse of mt_bam_fill. Emits one
// contiguous buffer of raw alignment blocks (each with its leading
// block_size) from struct-of-arrays ReadBatch fields at precomputed
// output offsets, plus per-record reference end positions for BAI
// linear-index construction (reference semantics: htslib bam_write1;
// consumer: htsapi/bam_dumper.hpp-equivalent io/bamwriter.py).

namespace {
inline int bam_reg2bin(int64_t beg, int64_t end) {
  --end;
  if (beg >> 14 == end >> 14) return ((1 << 15) - 1) / 7 + (int)(beg >> 14);
  if (beg >> 17 == end >> 17) return ((1 << 12) - 1) / 7 + (int)(beg >> 17);
  if (beg >> 20 == end >> 20) return ((1 << 9) - 1) / 7 + (int)(beg >> 20);
  if (beg >> 23 == end >> 23) return ((1 << 6) - 1) / 7 + (int)(beg >> 23);
  if (beg >> 26 == end >> 26) return ((1 << 3) - 1) / 7 + (int)(beg >> 26);
  return 0;
}
}  // namespace

extern "C" int mt_bam_encode(
    int64_t n, const int64_t* idx,
    const int32_t* refid, const int32_t* pos, const uint8_t* mapq,
    const uint16_t* flag, const int32_t* nrefid, const int32_t* npos,
    const int32_t* tlen,
    const int64_t* name_off, const uint8_t* name,
    const int64_t* cigar_off, const uint32_t* cigar,
    const int64_t* seq_off, const uint8_t* seq,
    const int64_t* qual_off, const uint8_t* qual,
    const int64_t* tag_off, const uint8_t* tags,
    const int64_t* extra_off, const uint8_t* extra,
    const int64_t* out_off, uint8_t* out, int32_t* out_end) {
  uint8_t nib[256];
  std::memset(nib, 15, sizeof(nib));
  for (int b = 0; b < 16; b++) {
    nib[(uint8_t)SEQ16[b]] = (uint8_t)b;
    nib[(uint8_t)std::tolower(SEQ16[b])] = (uint8_t)b;
  }
  for (int64_t k = 0; k < n; k++) {
    const int64_t i = idx ? idx[k] : k;
    const int64_t lname = name_off[i + 1] - name_off[i];
    const int64_t ncig = cigar_off[i + 1] - cigar_off[i];
    const int64_t lseq = seq_off[i + 1] - seq_off[i];
    const int64_t ltag = tag_off[i + 1] - tag_off[i];
    const int64_t lextra = extra_off ? extra_off[k + 1] - extra_off[k] : 0;
    const uint32_t bs = (uint32_t)(32 + lname + 1 + 4 * ncig +
                                   (lseq + 1) / 2 + lseq + ltag + lextra);
    uint8_t* p = out + out_off[k];
    std::memcpy(p, &bs, 4);
    p += 4;
    int64_t ref_len = 0;
    // ref-consuming ops M/D/N/=/X (0,2,3,7,8)
    const uint32_t ref_ops = (1u << 0) | (1u << 2) | (1u << 3) |
                             (1u << 7) | (1u << 8);
    for (int64_t c = cigar_off[i]; c < cigar_off[i + 1]; c++)
      if (ref_ops & (1u << (cigar[c] & 0xF))) ref_len += cigar[c] >> 4;
    const int64_t end = pos[i] + (ref_len > 1 ? ref_len : 1);
    out_end[k] = (int32_t)end;
    const int32_t rid = refid[i], pp = pos[i];
    std::memcpy(p, &rid, 4);
    std::memcpy(p + 4, &pp, 4);
    p[8] = (uint8_t)(lname + 1);
    p[9] = mapq[i];
    const uint16_t bin = (uint16_t)bam_reg2bin(pp, end);
    std::memcpy(p + 10, &bin, 2);
    const uint16_t nc16 = (uint16_t)ncig;
    std::memcpy(p + 12, &nc16, 2);
    std::memcpy(p + 14, &flag[i], 2);
    const int32_t ls32 = (int32_t)lseq;
    std::memcpy(p + 16, &ls32, 4);
    std::memcpy(p + 20, &nrefid[i], 4);
    std::memcpy(p + 24, &npos[i], 4);
    std::memcpy(p + 28, &tlen[i], 4);
    p += 32;
    std::memcpy(p, name + name_off[i], lname);
    p[lname] = 0;
    p += lname + 1;
    std::memcpy(p, cigar + cigar_off[i], 4 * ncig);
    p += 4 * ncig;
    const uint8_t* s = seq + seq_off[i];
    for (int64_t b = 0; b + 1 < lseq; b += 2)
      *p++ = (uint8_t)((nib[s[b]] << 4) | nib[s[b + 1]]);
    if (lseq & 1) *p++ = (uint8_t)(nib[s[lseq - 1]] << 4);
    std::memcpy(p, qual + qual_off[i], lseq);
    p += lseq;
    std::memcpy(p, tags + tag_off[i], ltag);
    p += ltag;
    if (lextra > 0) {
      std::memcpy(p, extra + extra_off[k], lextra);
      p += lextra;
    }
    if (p != out + out_off[k + 1]) return -1;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Batched semi-aligned edge scan: leading/trailing poorly-aligned edge
// lengths per read (reference: SVLocusScannerSemiAligned.cpp:33-131),
// with edge soft-clips matchified first
// (reference: SimpleAlignment.cpp matchifyEdgeSegmentType).

namespace {
inline bool sa_base_match(uint8_t rb, const uint8_t* refseq, int64_t ref_len,
                          int64_t fi) {
  const uint8_t fb = (fi >= 0 && fi < ref_len) ? refseq[fi] : (uint8_t)'N';
  return rb == 'N' || fb == 'N' || rb == fb;
}
constexpr uint32_t OPBIT_MATCH = (1u << 0) | (1u << 7) | (1u << 8);
constexpr uint32_t OPBIT_INDEL = (1u << 1) | (1u << 2);
constexpr uint32_t OPBIT_READ = (1u << 0) | (1u << 1) | (1u << 4) |
                                (1u << 7) | (1u << 8);
constexpr uint32_t OPBIT_REF = (1u << 0) | (1u << 2) | (1u << 3) |
                               (1u << 7) | (1u << 8);
}  // namespace

namespace {
inline void semi_aligned_one(
    int32_t pos_r, const uint32_t* cigar, int64_t c0, int64_t c1,
    const uint8_t* read, int64_t n_read,
    const uint8_t* refseq, int64_t ref_len, int64_t ref_offset,
    int32_t contiguous, std::vector<uint8_t>& ops,
    std::vector<int32_t>& lens,
    int32_t* out_lead_len, int32_t* out_lead_ref,
    int32_t* out_trail_len, int32_t* out_trail_ref);
}

extern "C" int mt_semi_aligned_batch(
    int64_t n,
    const int32_t* pos,
    const int64_t* cigar_off, const uint32_t* cigar,
    const int64_t* seq_off, const uint8_t* seq,
    const uint8_t* refseq, int64_t ref_len, int64_t ref_offset,
    int32_t contiguous,
    int32_t* out_lead_len, int32_t* out_lead_ref,
    int32_t* out_trail_len, int32_t* out_trail_ref) {
  std::vector<uint8_t> ops;
  std::vector<int32_t> lens;
  for (int64_t r = 0; r < n; r++) {
    semi_aligned_one(pos[r], cigar, cigar_off[r], cigar_off[r + 1],
                     seq + seq_off[r], seq_off[r + 1] - seq_off[r],
                     refseq, ref_len, ref_offset, contiguous, ops, lens,
                     out_lead_len + r, out_lead_ref + r,
                     out_trail_len + r, out_trail_ref + r);
  }
  return 0;
}

extern "C" int mt_semi_aligned_batch_idx(
    int64_t n_idx, const int64_t* idx,
    const int32_t* pos,
    const int64_t* cigar_off, const uint32_t* cigar,
    const int64_t* seq_off, const uint8_t* seq,
    const uint8_t* refseq, int64_t ref_len, int64_t ref_offset,
    int32_t contiguous,
    const int64_t* qual_off, const uint8_t* qual, int32_t min_bq,
    int32_t* out_lead_len, int32_t* out_lead_ref,
    int32_t* out_trail_len, int32_t* out_trail_ref,
    int32_t* out_lead_hq, int32_t* out_trail_hq) {
  std::vector<uint8_t> ops;
  std::vector<int32_t> lens;
  for (int64_t k = 0; k < n_idx; k++) {
    const int64_t r = idx[k];
    semi_aligned_one(pos[r], cigar, cigar_off[r], cigar_off[r + 1],
                     seq + seq_off[r], seq_off[r + 1] - seq_off[r],
                     refseq, ref_len, ref_offset, contiguous, ops, lens,
                     out_lead_len + k, out_lead_ref + k,
                     out_trail_len + k, out_trail_ref + k);
    // high-quality base counts over the lead/trail windows, so the
    // caller's basecall-quality gate needs no whole-batch prefix sums
    const uint8_t* q = qual + qual_off[r];
    const int64_t lq = qual_off[r + 1] - qual_off[r];
    int32_t lhq = 0, thq = 0;
    const int32_t ll = out_lead_len[k] < lq ? out_lead_len[k] : (int32_t)lq;
    for (int32_t b = 0; b < ll; b++) lhq += (q[b] >= min_bq);
    const int32_t tl = out_trail_len[k] < lq ? out_trail_len[k] : (int32_t)lq;
    for (int32_t b = 0; b < tl; b++) thq += (q[lq - 1 - b] >= min_bq);
    out_lead_hq[k] = lhq;
    out_trail_hq[k] = thq;
  }
  return 0;
}

namespace {
inline void semi_aligned_one(
    int32_t pos_r, const uint32_t* cigar, int64_t c0, int64_t c1,
    const uint8_t* read, int64_t n_read,
    const uint8_t* refseq, int64_t ref_len, int64_t ref_offset,
    int32_t contiguous, std::vector<uint8_t>& ops,
    std::vector<int32_t>& lens,
    int32_t* out_lead_len, int32_t* out_lead_ref,
    int32_t* out_trail_len, int32_t* out_trail_ref) {
  {

    // matchify edge soft clips
    ops.clear(); lens.clear();
    const int nseg = (int)(c1 - c0);
    int first = nseg, last = nseg;
    bool found = false;
    for (int i = 0; i < nseg; i++) {
      const uint8_t o = cigar[c0 + i] & 0xF;
      if (OPBIT_MATCH & (1u << o)) {
        if (!found) first = i;
        found = true;
        last = i;
      }
    }
    int64_t mpos = pos_r;
    for (int i = 0; i < nseg; i++) {
      const uint8_t o = cigar[c0 + i] & 0xF;
      const int32_t l = cigar[c0 + i] >> 4;
      const bool is_edge = (i < first) || (i > last);
      const bool target = is_edge && (o == 4);
      if (target && i < first) mpos -= l;
      if (target || o == 0) {
        if (!ops.empty() && ops.back() == 0) lens.back() += l;
        else { ops.push_back(0); lens.push_back(l); }
      } else {
        ops.push_back(o); lens.push_back(l);
      }
    }
    const int m = (int)ops.size();

    // leading scan
    int64_t read_idx = 0, ref_idx = mpos;
    int32_t lead_len = -1, lead_ref = (int32_t)mpos;
    int run = 0;
    for (int i = 0; i < m && lead_len < 0; i++) {
      const uint8_t o = ops[i];
      const int32_t l = lens[i];
      if (OPBIT_MATCH & (1u << o)) {
        for (int32_t sp = 0; sp < l; sp++) {
          if (sa_base_match(read[read_idx + sp], refseq, ref_len,
                            ref_idx + sp - ref_offset)) {
            run++;
            if (run >= contiguous) {
              lead_len = (int32_t)((read_idx + sp) - (run - 1));
              lead_ref = (int32_t)((ref_idx + sp) - (run - 1));
              break;
            }
          } else {
            run = 0;
          }
        }
      } else if (OPBIT_INDEL & (1u << o)) {
        run = 0;
      }
      if (lead_len >= 0) break;
      if (OPBIT_READ & (1u << o)) read_idx += l;
      if (OPBIT_REF & (1u << o)) ref_idx += l;
    }
    if (lead_len < 0) { lead_len = (int32_t)read_idx; lead_ref = (int32_t)ref_idx; }

    // trailing scan
    int64_t ref_span = 0;
    for (int i = 0; i < m; i++)
      if (OPBIT_REF & (1u << ops[i])) ref_span += lens[i];
    read_idx = n_read - 1;
    ref_idx = mpos + ref_span - 1;
    int32_t trail_len = -1, trail_ref = 0;
    run = 0;
    for (int i = m - 1; i >= 0 && trail_len < 0; i--) {
      const uint8_t o = ops[i];
      const int32_t l = lens[i];
      if (OPBIT_MATCH & (1u << o)) {
        for (int32_t sp = 0; sp < l; sp++) {
          if (sa_base_match(read[read_idx - sp], refseq, ref_len,
                            ref_idx - sp - ref_offset)) {
            run++;
            if (run >= contiguous) {
              trail_len = (int32_t)((n_read - (read_idx - sp)) - run);
              trail_ref = (int32_t)((ref_idx - sp) + run);
              break;
            }
          } else {
            run = 0;
          }
        }
      } else if (OPBIT_INDEL & (1u << o)) {
        run = 0;
      }
      if (trail_len >= 0) break;
      if (OPBIT_READ & (1u << o)) read_idx -= l;
      if (OPBIT_REF & (1u << o)) ref_idx -= l;
    }
    if (trail_len < 0) {
      trail_len = (int32_t)(n_read - (read_idx + 1));
      trail_ref = (int32_t)(ref_idx + 1);
    }

    *out_lead_len = lead_len;
    *out_lead_ref = lead_ref;
    *out_trail_len = trail_len;
    *out_trail_ref = trail_ref;
  }
}
}  // namespace

// ---------------------------------------------------------------------------
// Split-read junction scan (host production path; the device kernel in
// align/device_splitscore.py is the JAX equivalent).
// Behavioral parity target (studied not copied):
//   SplitReadAlignment.cpp splitReadAligner — per scan position the
//   basecall ln-likelihoods accumulate in float32 in base order, ties
//   resolved winner-takes-first.

extern "C" int mt_split_read_scan(
    const uint8_t* query, int32_t nq, const uint8_t* qual,
    const uint8_t* target, int32_t nt,
    int32_t bp_beg, int32_t bp_end, int32_t flank_score_size,
    const float* lut_match, const float* lut_mism, float ln_random,
    float* out_best_lnl, int32_t* out_best_pos) {
  if (nq <= 0 || nq >= nt) return -2;
  int32_t scan_start = bp_beg - nq + 2;
  if (scan_start < 0) scan_start = 0;
  int32_t scan_end = bp_end < (nt - nq) ? bp_end : (nt - nq);
  if (scan_end < 0) scan_end = 0;
  if (scan_end < scan_start) return -3;
  const int32_t score_beg = bp_beg - flank_score_size;
  const int32_t score_end = bp_end + flank_score_size;

  float best = 0.0f;
  int32_t best_k = 0;
  bool init = false;
  for (int32_t k = scan_start; k <= scan_end; k++) {
    float acc = 0.0f;
    const uint8_t* w = target + k;
    for (int32_t j = 0; j < nq; j++) {
      const int32_t tpos = k + j;
      if (tpos <= score_beg || tpos > score_end) continue;
      const uint8_t qb = query[j];
      const uint8_t tb = w[j];
      float term;
      if (qb == 'N' || tb == 'N') term = ln_random;
      else if (qb != tb) term = lut_mism[qual[j]];
      else term = lut_match[qual[j]];
      acc += term;
    }
    if (!init || acc > best) {
      best = acc;
      best_k = k;
      init = true;
    }
  }
  *out_best_lnl = best;
  *out_best_pos = best_k;
  return 0;
}

// ---------------------------------------------------------------------------
// Batched BAM aux-tag scans: tag presence and MC-tag mate reference
// length (replaces per-read Python tag walks in the scan hot path).

namespace {
// returns pointer to the value bytes of `tag` within [blob, blob+len),
// sets *type; nullptr if absent
inline const uint8_t* find_tag_value(const uint8_t* blob, int64_t len,
                                     char t0, char t1, uint8_t* type) {
  int64_t i = 0;
  while (i + 3 <= len) {
    const uint8_t a = blob[i], b = blob[i + 1], ty = blob[i + 2];
    i += 3;
    const bool hit = (a == (uint8_t)t0 && b == (uint8_t)t1);
    int64_t sz = -1;
    switch (ty) {
      case 'A': case 'c': case 'C': sz = 1; break;
      case 's': case 'S': sz = 2; break;
      case 'i': case 'I': case 'f': sz = 4; break;
      default: break;
    }
    if (sz >= 0) {
      if (hit) { *type = ty; return blob + i; }
      i += sz;
    } else if (ty == 'Z' || ty == 'H') {
      int64_t e = i;
      while (e < len && blob[e] != 0) e++;
      if (hit) { *type = ty; return blob + i; }
      i = e + 1;
    } else if (ty == 'B') {
      if (i >= len) return nullptr;
      const uint8_t sub = blob[i];
      uint32_t cnt;
      if (i + 5 > len) return nullptr;
      std::memcpy(&cnt, blob + i + 1, 4);
      int64_t esz = (sub == 'c' || sub == 'C') ? 1
                  : (sub == 's' || sub == 'S') ? 2 : 4;
      if (hit) { *type = ty; return blob + i; }
      i += 5 + esz * (int64_t)cnt;
    } else {
      return nullptr;  // unknown type: stop scanning
    }
  }
  return nullptr;
}
}  // namespace

extern "C" int mt_has_tag(
    int64_t n, const int64_t* tag_off, const uint8_t* tags,
    char t0, char t1, uint8_t* out) {
  for (int64_t r = 0; r < n; r++) {
    uint8_t ty;
    out[r] = find_tag_value(tags + tag_off[r], tag_off[r + 1] - tag_off[r],
                            t0, t1, &ty) != nullptr;
  }
  return 0;
}

// mate reference span: MC cigar ref length when present, else the
// read's own length (reference: SimpleAlignment_bam_util.cpp:43-61
// faked full-match mate alignment)
extern "C" int mt_mate_ref_len(
    int64_t n, const int64_t* tag_off, const uint8_t* tags,
    const int64_t* seq_off, int32_t* out) {
  for (int64_t r = 0; r < n; r++) {
    uint8_t ty;
    const int64_t len = tag_off[r + 1] - tag_off[r];
    const uint8_t* v =
        find_tag_value(tags + tag_off[r], len, 'M', 'C', &ty);
    if (v != nullptr && ty == 'Z') {
      int64_t ref_len = 0, num = 0;
      for (const uint8_t* p = v; *p != 0 &&
           p < tags + tag_off[r + 1]; p++) {
        const uint8_t c = *p;
        if (c >= '0' && c <= '9') {
          num = num * 10 + (c - '0');
        } else {
          if (c == 'M' || c == 'D' || c == 'N' || c == '=' || c == 'X')
            ref_len += num;
          num = 0;
        }
      }
      out[r] = (int32_t)ref_len;
    } else {
      out[r] = (int32_t)(seq_off[r + 1] - seq_off[r]);
    }
  }
  return 0;
}

// full mate alignment stats from the MC cigar: reference span, read
// length, and unaligned edge sizes (S/I run before the first / after
// the last anchored op, H consuming nothing), faked as a full match of
// the read's own length when MC is absent (reference:
// SimpleAlignment_bam_util.cpp:43-61 + blt_util/align_path.cpp
// apath_read_lead_size/apath_read_trail_size semantics)
extern "C" int mt_mate_align_stats(
    int64_t n, const int64_t* tag_off, const uint8_t* tags,
    const int64_t* seq_off, int32_t* out_ref_len, int32_t* out_read_len,
    int32_t* out_unaln_prefix, int32_t* out_unaln_suffix) {
  for (int64_t r = 0; r < n; r++) {
    uint8_t ty;
    const int64_t len = tag_off[r + 1] - tag_off[r];
    const uint8_t* v =
        find_tag_value(tags + tag_off[r], len, 'M', 'C', &ty);
    if (v == nullptr || ty != 'Z') {
      const int32_t rl = (int32_t)(seq_off[r + 1] - seq_off[r]);
      out_ref_len[r] = rl;
      out_read_len[r] = rl;
      out_unaln_prefix[r] = 0;
      out_unaln_suffix[r] = 0;
      continue;
    }
    int64_t ref_len = 0, read_len = 0, num = 0;
    int64_t prefix = 0, suffix = 0;
    bool in_prefix = true;
    for (const uint8_t* p = v; *p != 0 && p < tags + tag_off[r + 1];
         p++) {
      const uint8_t c = *p;
      if (c >= '0' && c <= '9') {
        num = num * 10 + (c - '0');
        continue;
      }
      const bool is_ref =
          (c == 'M' || c == 'D' || c == 'N' || c == '=' || c == 'X');
      const bool is_read =
          (c == 'M' || c == 'I' || c == 'S' || c == '=' || c == 'X');
      const bool is_edge = (c == 'I' || c == 'H' || c == 'S');
      if (is_ref) ref_len += num;
      if (is_read) read_len += num;
      if (is_edge) {
        if (in_prefix) prefix += is_read ? num : 0;
        suffix += is_read ? num : 0;
      } else {
        in_prefix = false;
        suffix = 0;
      }
      num = 0;
    }
    out_ref_len[r] = (int32_t)ref_len;
    out_read_len[r] = (int32_t)read_len;
    out_unaln_prefix[r] = (int32_t)prefix;
    out_unaln_suffix[r] = (int32_t)suffix;
  }
  return 0;
}

// Batched multi-target split scan: score many reads against the same
// small set of junction targets (alt/ref x bp1/bp2) in one call.
// Inner loop shared with mt_split_read_scan.

namespace {

// One scan position: the reference's per-base float32 accumulation
// order (SplitReadAlignment.cpp); kept as the scalar tail path.
inline float split_scan_pos(
    const uint8_t* query, int32_t nq, const uint8_t* qual,
    const uint8_t* target, int32_t k,
    int32_t score_beg, int32_t score_end,
    const float* lut_match, const float* lut_mism, float ln_random) {
  float acc = 0.0f;
  const uint8_t* w = target + k;
  const int32_t j_lo = (score_beg - k + 1) > 0 ? (score_beg - k + 1) : 0;
  const int32_t j_hi_excl = (score_end - k + 1) < nq ? (score_end - k + 1) : nq;
  for (int32_t j = j_lo; j < j_hi_excl; j++) {
    const uint8_t qb = query[j];
    const uint8_t tb = w[j];
    float term;
    if (qb == 'N' || tb == 'N') term = ln_random;
    else if (qb != tb) term = lut_mism[qual[j]];
    else term = lut_match[qual[j]];
    acc += term;
  }
  return acc;
}

// Lane-parallel scan: 16 consecutive scan positions accumulate
// simultaneously, each lane in the exact scalar base order. The term
// for every lane is SELECTED (blended), never recombined
// arithmetically, and lanes outside their scoring window add +0.0f via
// the write mask — bit-exact because every real term is a negative
// log-likelihood, so the accumulator never holds -0.0f. Consecutive
// scan positions read consecutive target bytes, so the lane load is
// one unaligned 16-byte load. Runtime-dispatched: AVX-512 when
// available, exact scalar loop otherwise.
constexpr int32_t SCAN_W = 16;

#if defined(__x86_64__) || defined(__i386__)
__attribute__((target("avx512f")))
void split_scan_block16_avx512(
    const uint8_t* query, const uint8_t* qual, const uint8_t* target,
    int32_t nq, int32_t k0, int32_t score_beg, int32_t score_end,
    const float* lut_match, const float* lut_mism, float ln_random,
    float* acc_out) {
  __m512 acc = _mm512_setzero_ps();
  const __m512 ln_rv = _mm512_set1_ps(ln_random);
  const __m512i nv = _mm512_set1_epi32('N');
  int32_t j_lo = score_beg - k0 - (SCAN_W - 1) + 1;
  if (j_lo < 0) j_lo = 0;
  int32_t j_hi_excl = score_end - k0 + 1;
  if (j_hi_excl > nq) j_hi_excl = nq;
  for (int32_t j = j_lo; j < j_hi_excl; j++) {
    const uint8_t qb = query[j];
    const __m512 m = _mm512_set1_ps(lut_match[qual[j]]);
    const __m512 x = _mm512_set1_ps(lut_mism[qual[j]]);
    const __m128i tb8 =
        _mm_loadu_si128((const __m128i*)(target + k0 + j));
    const __m512i tb = _mm512_cvtepu8_epi32(tb8);
    const __mmask16 eq =
        _mm512_cmpeq_epi32_mask(tb, _mm512_set1_epi32(qb));
    __mmask16 isn = _mm512_cmpeq_epi32_mask(tb, nv);
    if (qb == 'N') isn = (__mmask16)0xFFFF;
    __m512 term = _mm512_mask_blend_ps(eq, x, m);
    term = _mm512_mask_blend_ps(isn, term, ln_rv);
    // lane l active iff score_beg < k0+l+j <= score_end; p grows with
    // l, so the active lanes are the contiguous range [lo_l, hi_l)
    const int32_t p0 = k0 + j;
    int32_t lo_l = score_beg + 1 - p0;
    if (lo_l < 0) lo_l = 0;
    int32_t hi_l = score_end + 1 - p0;
    if (hi_l > SCAN_W) hi_l = SCAN_W;
    const uint32_t hi_bits = (hi_l >= SCAN_W) ? 0xFFFFu
                                              : ((1u << hi_l) - 1u);
    const uint32_t lo_bits = (1u << lo_l) - 1u;
    const __mmask16 active = (__mmask16)(hi_bits & ~lo_bits);
    acc = _mm512_mask_add_ps(acc, active, acc, term);
  }
  _mm512_storeu_ps(acc_out, acc);
}
#endif

inline bool have_avx512() {
#if defined(__x86_64__) || defined(__i386__)
  static const bool ok = __builtin_cpu_supports("avx512f");
  return ok;
#else
  return false;
#endif
}

int split_scan_core(
    const uint8_t* query, int32_t nq, const uint8_t* qual,
    const uint8_t* target, int32_t nt,
    int32_t bp_beg, int32_t bp_end, int32_t flank_score_size,
    const float* lut_match, const float* lut_mism, float ln_random,
    float* out_best_lnl, int32_t* out_best_pos) {
  if (nq <= 0 || nq >= nt) return -2;
  int32_t scan_start = bp_beg - nq + 2;
  if (scan_start < 0) scan_start = 0;
  int32_t scan_end = bp_end < (nt - nq) ? bp_end : (nt - nq);
  if (scan_end < 0) scan_end = 0;
  if (scan_end < scan_start) return -3;
  const int32_t score_beg = bp_beg - flank_score_size;
  const int32_t score_end = bp_end + flank_score_size;

  float best = 0.0f;
  int32_t best_k = 0;
  bool init = false;

  int32_t k0 = scan_start;
#if defined(__x86_64__) || defined(__i386__)
  if (have_avx512()) {
    // full blocks only: max target index touched is (k0+W-1)+(nq-1)
    // <= scan_end+nq-1 <= nt-1, so the 16-byte lane loads are in-bounds
    for (; k0 + SCAN_W - 1 <= scan_end; k0 += SCAN_W) {
      float acc[SCAN_W];
      split_scan_block16_avx512(query, qual, target, nq, k0, score_beg,
                                score_end, lut_match, lut_mism, ln_random,
                                acc);
      for (int32_t l = 0; l < SCAN_W; l++) {
        if (!init || acc[l] > best) {
          best = acc[l];
          best_k = k0 + l;
          init = true;
        }
      }
    }
  }
#endif
  for (int32_t k = k0; k <= scan_end; k++) {
    const float acc = split_scan_pos(query, nq, qual, target, k, score_beg,
                                     score_end, lut_match, lut_mism,
                                     ln_random);
    if (!init || acc > best) {
      best = acc;
      best_k = k;
      init = true;
    }
  }
  *out_best_lnl = best;
  *out_best_pos = best_k;
  return 0;
}
}  // namespace

extern "C" int mt_split_read_scan_multi(
    int64_t n_reads, const int64_t* read_idx,
    const int64_t* seq_off, const uint8_t* seq,
    const int64_t* qual_off, const uint8_t* qual,
    int32_t n_targets, const uint8_t* target_blob,
    const int64_t* target_off,
    const int32_t* bp_beg, const int32_t* bp_end,
    int32_t flank_score_size,
    const float* lut_match, const float* lut_mism, float ln_random,
    float* out_lnl, int32_t* out_pos) {
  for (int64_t r = 0; r < n_reads; r++) {
    const int64_t i = read_idx[r];
    const uint8_t* q = seq + seq_off[i];
    const int32_t nq = (int32_t)(seq_off[i + 1] - seq_off[i]);
    const uint8_t* ql = qual + qual_off[i];
    for (int32_t t = 0; t < n_targets; t++) {
      const uint8_t* tg = target_blob + target_off[t];
      const int32_t nt = (int32_t)(target_off[t + 1] - target_off[t]);
      const int rc = split_scan_core(
          q, nq, ql, tg, nt, bp_beg[t], bp_end[t], flank_score_size,
          lut_match, lut_mism, ln_random,
          out_lnl + r * n_targets + t, out_pos + r * n_targets + t);
      if (rc != 0) return rc;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// rANS 4x8 block decoder (CRAM 3.0 compression method 4).
//
// Implements the decoder side of the rANS codec specified in the CRAM 3.0
// format specification section 13 (reference analogue: the htslib-1.9 codec
// used by the reference's htsapi layer via redist/htslib; reimplemented from
// the format spec): 4 interleaved byte-wise rANS states, 12-bit normalized
// frequencies, order-0 (i%4 state striping) and order-1 (quartered output,
// previous-byte context) variants.
//
// Input layout: [order u8][compressed size u32le][raw size u32le][payload].
// Returns 0 on success, negative on malformed input.

namespace {

constexpr uint32_t RANS_LOW = 1u << 23;
constexpr uint32_t RANS_TF = 1u << 12;  // total frequency (12-bit)

struct ByteCur {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;
  inline uint8_t u8() {
    if (p >= end) { ok = false; return 0; }
    return *p++;
  }
  inline uint32_t u32le() {
    if (p + 4 > end) { ok = false; return 0; }
    uint32_t v = (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                 ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
    p += 4;
    return v;
  }
  inline uint8_t peek() const { return p < end ? *p : 0; }
};

// shared frequency-table reader: symbols ascend with RLE runs, 0 terminator
// (a leading symbol 0 is consumed before the terminator check).
template <typename SetF>
inline bool read_freq_rle(ByteCur& c, SetF&& set_freq) {
  int rle = 0;
  int j = c.u8();
  do {
    int f = c.u8();
    if (f >= 128) f = ((f & 127) << 8) | c.u8();
    if (!c.ok || !set_freq(j, f)) return false;
    if (!rle && c.peek() == j + 1) {
      j = c.u8();
      rle = c.u8();
    } else if (rle) {
      rle--;
      j++;
    } else {
      j = c.u8();
    }
  } while (j && c.ok);
  return c.ok;
}

inline void rans_renorm(uint32_t& x, ByteCur& c) {
  while (x < RANS_LOW) {
    if (c.p >= c.end) break;  // stream exhausted: states stay valid for
                              // remaining buffered symbols
    x = (x << 8) | *c.p++;
  }
}

}  // namespace

extern "C" int mt_rans_uncompress(
    const uint8_t* in, int64_t in_sz, uint8_t* out, int64_t out_sz) {
  if (in_sz < 9) return -1;
  ByteCur c{in, in + in_sz};
  const int order = c.u8();
  (void)c.u32le();                      // compressed size (unused)
  const uint32_t raw_sz = c.u32le();
  if (!c.ok || (int64_t)raw_sz != out_sz || (order != 0 && order != 1))
    return -2;
  if (out_sz == 0) return 0;

  if (order == 0) {
    // order-0: one shared table; output byte i decoded by state i & 3
    std::vector<uint32_t> freq(256, 0), cbase(256, 0);
    std::vector<uint8_t> ssym(RANS_TF);
    uint32_t x = 0;
    bool fit = read_freq_rle(c, [&](int j, int f) {
      if (j < 0 || j > 255 || x + (uint32_t)f > RANS_TF) return false;
      freq[j] = f;
      cbase[j] = x;
      std::memset(&ssym[x], j, f);
      x += f;
      return true;
    });
    if (!fit) return -3;
    uint32_t R[4];
    for (int k = 0; k < 4; k++) R[k] = c.u32le();
    if (!c.ok) return -4;
    for (int64_t i = 0; i < out_sz; i++) {
      uint32_t& rx = R[i & 3];
      const uint32_t m = rx & (RANS_TF - 1);
      const uint8_t s = ssym[m];
      out[i] = s;
      rx = freq[s] * (rx >> 12) + m - cbase[s];
      rans_renorm(rx, c);
    }
    return 0;
  }

  // order-1: per-context tables; output split into 4 quarters, one state
  // each, with the previous decoded byte (0 at start) as context
  std::vector<uint32_t> freq(256 * 256, 0), cbase(256 * 256, 0);
  std::vector<uint8_t> ssym(256 * RANS_TF);
  {
    int rle_i = 0;
    int i = c.u8();
    do {
      uint32_t x = 0;
      bool fit = read_freq_rle(c, [&](int j, int f) {
        if (i < 0 || i > 255 || j < 0 || j > 255 ||
            x + (uint32_t)f > RANS_TF)
          return false;
        freq[i * 256 + j] = f;
        cbase[i * 256 + j] = x;
        std::memset(&ssym[i * RANS_TF + x], j, f);
        x += f;
        return true;
      });
      if (!fit) return -3;
      if (!rle_i && c.peek() == i + 1) {
        i = c.u8();
        rle_i = c.u8();
      } else if (rle_i) {
        rle_i--;
        i++;
      } else {
        i = c.u8();
      }
    } while (i && c.ok);
    if (!c.ok) return -3;
  }
  uint32_t R[4];
  for (int k = 0; k < 4; k++) R[k] = c.u32le();
  if (!c.ok) return -4;
  const int64_t q = out_sz >> 2;
  int64_t idx[4] = {0, q, 2 * q, 3 * q};
  uint8_t ctx[4] = {0, 0, 0, 0};
  for (int64_t i = 0; i < q; i++) {
    for (int k = 0; k < 4; k++) {
      uint32_t& rx = R[k];
      const uint32_t m = rx & (RANS_TF - 1);
      const uint8_t s = ssym[ctx[k] * RANS_TF + m];
      out[idx[k]] = s;
      rx = freq[ctx[k] * 256 + s] * (rx >> 12) + m - cbase[ctx[k] * 256 + s];
      rans_renorm(rx, c);
      ctx[k] = s;
      idx[k]++;
    }
  }
  // tail (out_sz not divisible by 4): state 3 continues
  for (int64_t i = idx[3]; i < out_sz; i++) {
    uint32_t& rx = R[3];
    const uint32_t m = rx & (RANS_TF - 1);
    const uint8_t s = ssym[ctx[3] * RANS_TF + m];
    out[i] = s;
    rx = freq[ctx[3] * 256 + s] * (rx >> 12) + m - cbase[ctx[3] * 256 + s];
    rans_renorm(rx, c);
    ctx[3] = s;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Batched soft-clip-matchified reference ranges.
//
// Port of the per-read matchifyEdgeSoftClipRefRange logic (reference:
// manta/SVCandidateAssembler.cpp edge-segment handling): the reference
// span of each read extended by any read-consuming ops outside the
// first/last aligned-match segments. One call covers a whole batch,
// replacing a per-read Python cigar walk.

extern "C" int mt_matchify_ranges(
    int64_t n, const int32_t* pos, const int64_t* cigar_off,
    const uint32_t* cigar, int32_t* out_beg, int32_t* out_end) {
  for (int64_t r = 0; r < n; r++) {
    const int64_t c0 = cigar_off[r];
    const int64_t c1 = cigar_off[r + 1];
    int64_t first = c1;
    int64_t last = c1;
    bool found = false;
    for (int64_t k = c0; k < c1; k++) {
      const uint32_t op = cigar[k] & 0xF;
      if (op == 0 || op == 7 || op == 8) {  // M/=/X
        if (!found) first = k;
        found = true;
        last = k;
      }
    }
    int64_t beg = pos[r];
    int64_t end = beg;
    for (int64_t k = c0; k < c1; k++) {
      const uint32_t op = cigar[k] & 0xF;
      const int64_t l = cigar[k] >> 4;
      if (k < first || k > last) {
        if (op == 0 || op == 1 || op == 4 || op == 7 || op == 8) {
          // read-consuming op on an edge segment
          if (k < first) beg -= l; else end += l;
        }
      }
      if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8) end += l;
    }
    out_beg[r] = (int32_t)beg;
    out_end[r] = (int32_t)end;
  }
  return 0;
}

// Depth pileup over a window for selected reads: accumulates the
// M/=/X segments of each read's alignment into a per-position counter
// (reference: GenerateSVCandidates/SVScorer.cpp
// addReadToDepthEst/getBreakendMaxMappedDepthAndMQ0:76-143).
extern "C" int mt_depth_pileup(
    int64_t n_sel, const int64_t* sel, const int32_t* pos,
    const int64_t* cigar_off, const uint32_t* cigar,
    int64_t win_beg, int64_t win_end, int32_t* depth) {
  for (int64_t r = 0; r < n_sel; r++) {
    const int64_t i = sel[r];
    int64_t ref_pos = pos[i];
    const int64_t c0 = cigar_off[i];
    const int64_t c1 = cigar_off[i + 1];
    for (int64_t k = c0; k < c1; k++) {
      if (ref_pos >= win_end) break;
      const uint32_t op = cigar[k] & 0xF;
      const int64_t l = cigar[k] >> 4;
      if (op == 0 || op == 7 || op == 8) {  // M/=/X
        int64_t s = ref_pos > win_beg ? ref_pos : win_beg;
        int64_t e = (ref_pos + l) < win_end ? (ref_pos + l) : win_end;
        for (int64_t p = s; p < e; p++) depth[p - win_beg]++;
      }
      if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)  // M/D/N/=/X
        ref_pos += l;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Batched split-alignment mismatch accounting at the winning scan
// position (reference: SplitReadAlignment.cpp calculateAlignScore):
// for each (read, target) pair, counts mismatches in the left / homology
// / right regions implied by the breakend offset range.

extern "C" int mt_split_finalize_multi(
    int64_t n_reads, const int64_t* read_idx,
    const int64_t* seq_off, const uint8_t* seq,
    int32_t n_targets, const uint8_t* target_blob, const int64_t* target_off,
    const int32_t* bp_beg, const int32_t* bp_end,
    const int32_t* best_pos, int32_t* out_mm /* (n_reads, n_targets, 3) */) {
  for (int64_t r = 0; r < n_reads; r++) {
    const int64_t i = read_idx[r];
    const uint8_t* q = seq + seq_off[i];
    const int64_t nq = seq_off[i + 1] - seq_off[i];
    for (int32_t t = 0; t < n_targets; t++) {
      const uint8_t* tg = target_blob + target_off[t];
      const int64_t nt = target_off[t + 1] - target_off[t];
      const int64_t pos = best_pos[r * n_targets + t];
      int64_t left = 0;
      if (pos <= bp_beg[t] + 1) left = (int64_t)bp_beg[t] + 1 - pos;
      int64_t hom = (int64_t)bp_end[t] + 1 - pos - left;
      if (hom > nq - left) hom = nq - left;
      // region boundaries match the Python slices [:l+1], [l+1:h+1], [h+1:]
      int64_t lend = left + 1;
      int64_t hend = left + hom + 1;
      if (lend > nq) lend = nq;
      if (hend > nq) hend = nq;
      if (hend < lend) hend = lend;
      int32_t mm[3] = {0, 0, 0};
      for (int64_t j = 0; j < nq; j++) {
        const int64_t tp = pos + j;
        const uint8_t tb = (tp >= 0 && tp < nt) ? tg[tp] : (uint8_t)'N';
        const bool mis = (q[j] != tb) || (q[j] == 'N');
        if (!mis) continue;
        if (j < lend) mm[0]++;
        else if (j < hend) mm[1]++;
        else mm[2]++;
      }
      int32_t* o = out_mm + (r * n_targets + t) * 3;
      o[0] = mm[0];
      o[1] = mm[1];
      o[2] = mm[2];
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Iterative greedy de-Bruijn assembler, native port of
// manta_tpu/assembly/assembler.py (reference:
// src/c++/lib/assembly/IterativeAssembler.cpp): k-mer counting with
// pseudo-read weighting, Tarjan SCC repeat detection with the
// small-circle threshold, greedy bidirectional contig extension with
// supporting/rejecting read tracking, word-size iteration with
// pseudo-read rollover, and greedy contig selection. Deterministic
// orders follow the Python module: sorted word order for repeat-search
// roots and seed selection, alphabet order for successors/branches.
// Read sets are bitsets (all set operations here are
// order-independent), so results match the Python set semantics
// exactly.

#include <string>
#include <unordered_map>
#include <unordered_set>
#include <map>
#include <set>
#include <array>
#include <cstdlib>

namespace asmx {

struct Bits {
  std::vector<uint64_t> w;
  explicit Bits(size_t n = 0) : w((n + 63) / 64, 0) {}
  void resize_bits(size_t n) { w.assign((n + 63) / 64, 0); }
  void set(size_t i) { w[i >> 6] |= (1ull << (i & 63)); }
  bool test(size_t i) const {
    return (w[i >> 6] >> (i & 63)) & 1ull;
  }
  void ior(const Bits& o) {
    for (size_t i = 0; i < w.size(); i++) w[i] |= o.w[i];
  }
  void andnot_eq(const Bits& o) {  // this &= ~o
    for (size_t i = 0; i < w.size(); i++) w[i] &= ~o.w[i];
  }
  static Bits and_(const Bits& a, const Bits& b) {
    Bits r;
    r.w.resize(a.w.size());
    for (size_t i = 0; i < a.w.size(); i++) r.w[i] = a.w[i] & b.w[i];
    return r;
  }
  static Bits andnot(const Bits& a, const Bits& b) {  // a & ~b
    Bits r;
    r.w.resize(a.w.size());
    for (size_t i = 0; i < a.w.size(); i++) r.w[i] = a.w[i] & ~b.w[i];
    return r;
  }
  void or_andnot(const Bits& a, const Bits& b) {  // this |= a & ~b
    for (size_t i = 0; i < w.size(); i++) w[i] |= a.w[i] & ~b.w[i];
  }
  bool any() const {
    for (uint64_t x : w)
      if (x) return true;
    return false;
  }
  int64_t count() const {
    int64_t c = 0;
    for (uint64_t x : w) c += __builtin_popcountll(x);
    return c;
  }
  bool operator==(const Bits& o) const { return w == o.w; }
};

struct Contig {
  std::string seq;
  Bits support;
  Bits reject;
  int32_t cons_beg = 0;
  int32_t cons_end = 0;
};

struct WordInfo {
  int32_t count = 0;
  Bits reads;
};

struct Options {
  int32_t min_word, max_word, word_step;
  int32_t min_coverage, min_cons_coverage;
  int32_t min_unused_reads, min_support_reads, max_assembly_count;
};

typedef std::unordered_map<std::string, WordInfo> WordMap;

static const char ALPHABET[4] = {'A', 'C', 'G', 'T'};

// assembler.py _get_kmer_maps
static void get_kmer_maps(const Options& opt,
                          const std::vector<std::string>& reads,
                          const std::vector<bool>& is_pseudo,
                          int32_t word_length, size_t capacity,
                          WordMap& words) {
  const size_t n_reads = reads.size();
  std::unordered_set<std::string> read_words;
  for (size_t ri = 0; ri < n_reads; ri++) {
    const std::string& seq = reads[ri];
    const int64_t read_len = (int64_t)seq.size();
    if (read_len < word_length) continue;
    read_words.clear();
    for (int64_t j = 0; j + word_length <= read_len; j++) {
      const char* p = seq.data() + j;
      bool has_n = false;
      for (int64_t t = 0; t < word_length; t++)
        if (p[t] == 'N') { has_n = true; break; }
      if (has_n) continue;
      read_words.emplace(p, word_length);
    }
    const int32_t add = is_pseudo[ri] ? opt.min_coverage : 1;
    for (const std::string& word : read_words) {
      WordInfo& wi = words[word];
      if (wi.reads.w.empty()) wi.reads.resize_bits(capacity);
      wi.count += add;
      wi.reads.set(ri);
    }
  }
}

// assembler.py _get_repeat_kmers: iterative Tarjan SCC, sorted roots,
// alphabet-order successors; non-singleton SCCs with DFS-index span
// <= 50 are repeats, plus homopolymer self-loops.
static void get_repeat_kmers(const WordMap& words,
                             const std::vector<const std::string*>& sorted_words,
                             std::unordered_set<std::string>& repeat_words) {
  std::unordered_map<std::string, int32_t> index_of, lowlink;
  std::unordered_set<std::string> on_stack;
  std::vector<std::string> stack;
  int32_t next_index = 1;

  struct Frame {
    std::string word;
    int8_t next_symbol;  // next alphabet successor to examine (0..4)
  };

  auto successors_of = [&](const std::string& word,
                           std::vector<std::string>& out) {
    out.clear();
    const std::string tail = word.substr(1);
    for (char symbol : ALPHABET) {
      std::string nxt = tail + symbol;
      if (nxt == word) {
        repeat_words.insert(word);
        continue;
      }
      if (words.count(nxt)) out.push_back(std::move(nxt));
    }
  };

  // per-frame successor lists (mirrors the Python generator state)
  std::vector<std::pair<std::string, std::pair<std::vector<std::string>,
                                               size_t>>> work;
  std::vector<std::string> succ;

  for (const std::string* startp : sorted_words) {
    const std::string& start = *startp;
    if (index_of.count(start)) continue;
    successors_of(start, succ);
    work.clear();
    work.push_back({start, {succ, 0}});
    index_of[start] = lowlink[start] = next_index++;
    stack.push_back(start);
    on_stack.insert(start);
    while (!work.empty()) {
      auto& top = work.back();
      const std::string word = top.first;
      bool advanced = false;
      while (top.second.second < top.second.first.size()) {
        const std::string& nxt = top.second.first[top.second.second++];
        if (!index_of.count(nxt)) {
          index_of[nxt] = lowlink[nxt] = next_index++;
          stack.push_back(nxt);
          on_stack.insert(nxt);
          successors_of(nxt, succ);
          work.push_back({nxt, {succ, 0}});
          advanced = true;
          break;
        } else if (on_stack.count(nxt)) {
          if (index_of[nxt] < lowlink[word]) lowlink[word] = index_of[nxt];
        }
      }
      if (advanced) continue;
      work.pop_back();
      if (!work.empty()) {
        const std::string& parent = work.back().first;
        if (lowlink[word] < lowlink[parent]) lowlink[parent] = lowlink[word];
      }
      if (lowlink[word] == index_of[word]) {
        const std::string& last = stack.back();
        if (last == word) {
          stack.pop_back();
          on_stack.erase(word);
        } else {
          const bool small = (index_of[last] - index_of[word]) <= 50;
          while (true) {
            std::string w = stack.back();
            stack.pop_back();
            on_stack.erase(w);
            const bool done = (w == word);
            if (small) repeat_words.insert(std::move(w));
            if (done) break;
          }
        }
      }
    }
  }
}

// assembler.py _walk
static bool walk(const Options& opt, const std::string& seed,
                 int32_t word_length, const WordMap& words,
                 const std::unordered_set<std::string>& repeat_words,
                 std::unordered_set<std::string>& unused_words,
                 size_t capacity, Contig& contig) {
  const WordInfo& seed_info = words.at(seed);
  contig.support = seed_info.reads;
  contig.reject.resize_bits(capacity);
  contig.seq = seed;
  unused_words.erase(seed);

  if (repeat_words.count(seed)) {
    contig.cons_beg = 0;
    contig.cons_end = word_length;
    return true;
  }

  std::unordered_set<std::string> words_in_contig;
  words_in_contig.insert(seed);

  {
    const std::string tmp_trunk = seed.substr(0, word_length - 1);
    for (char symbol : ALPHABET) {
      if (symbol == seed[word_length - 1]) continue;
      auto it = words.find(tmp_trunk + symbol);
      if (it != words.end()) contig.reject.ior(it->second.reads);
    }
  }

  bool is_repeat_found = false;
  int32_t cons_right = 0, cons_left = 0;

  for (int mode = 0; mode < 2; mode++) {
    const bool is_end = (mode == 0);
    int32_t cons_offset = 0;
    while (true) {
      const std::string previous_word =
          is_end ? contig.seq.substr(contig.seq.size() - word_length)
                 : contig.seq.substr(0, word_length);
      const std::string trunk =
          is_end ? contig.seq.substr(contig.seq.size() - (word_length - 1))
                 : contig.seq.substr(0, word_length - 1);

      int32_t max_base_count = 0;
      int64_t max_contig_word_read_count = 0;
      std::string max_word;
      char max_base = ALPHABET[0];
      Bits max_word_reads(capacity);
      Bits max_contig_word_reads(capacity);
      Bits support_remove(capacity);
      Bits reject_add(capacity);
      bool have_max = false;

      for (char symbol : ALPHABET) {
        const std::string new_key =
            is_end ? (trunk + symbol) : (symbol + trunk);
        auto it = words.find(new_key);
        if (it == words.end()) continue;
        const int32_t curr_word_count = it->second.count;
        const Bits& curr_word_reads = it->second.reads;
        Bits contig_word_reads = Bits::and_(contig.support, curr_word_reads);
        Bits shared_reads = Bits::and_(max_contig_word_reads,
                                       curr_word_reads);
        if (!contig_word_reads.any()) continue;
        const int64_t cwr = contig_word_reads.count();
        if (cwr > max_contig_word_read_count) {
          if (have_max) {
            support_remove.or_andnot(max_contig_word_reads, shared_reads);
            reject_add.or_andnot(max_word_reads, shared_reads);
          }
          max_word_reads = curr_word_reads;
          max_contig_word_read_count = cwr;
          max_contig_word_reads = std::move(contig_word_reads);
          max_base_count = curr_word_count;
          max_base = symbol;
          max_word = new_key;
          have_max = true;
        } else {
          support_remove.or_andnot(contig_word_reads, shared_reads);
          reject_add.or_andnot(curr_word_reads, shared_reads);
        }
      }

      if (max_base_count < opt.min_coverage) break;
      if (words_in_contig.count(max_word)) {
        is_repeat_found = true;
        break;
      }

      if (is_end)
        contig.seq.push_back(max_base);
      else
        contig.seq.insert(contig.seq.begin(), max_base);

      if (cons_offset != 0 || max_base_count < opt.min_cons_coverage)
        cons_offset += 1;

      // branch-point backward check (previous_word_reads is freshly
      // empty each step in the source, so the guard always fires when
      // a branch was selected)
      {
        const char tmp_symbol =
            is_end ? previous_word[0] : previous_word[word_length - 1];
        for (char symbol : ALPHABET) {
          if (symbol == tmp_symbol) continue;
          const std::string back_key =
              is_end ? (symbol + trunk) : (trunk + symbol);
          if (back_key == max_word) continue;
          auto it = words.find(back_key);
          if (it == words.end()) continue;
          const Bits& back_reads = it->second.reads;
          // to_update = back_reads - (max_contig_word_reads & back_reads)
          Bits to_update = Bits::andnot(back_reads, max_contig_word_reads);
          if (to_update.any()) {
            reject_add.ior(to_update);
            support_remove.ior(to_update);
          }
        }
      }

      contig.reject.ior(reject_add);
      contig.support.or_andnot(max_word_reads, contig.reject);
      contig.support.andnot_eq(support_remove);

      unused_words.erase(max_word);
      words_in_contig.insert(std::move(max_word));
    }
    if (mode == 0)
      cons_right = cons_offset;
    else
      cons_left = cons_offset;
  }

  contig.cons_beg = cons_left;
  contig.cons_end = (int32_t)contig.seq.size() - cons_right;
  return is_repeat_found;
}

// assembler.py _build_contigs
static bool build_contigs(const Options& opt,
                          const std::vector<std::string>& reads,
                          const std::vector<bool>& is_pseudo,
                          int32_t word_length, size_t capacity,
                          std::vector<Contig>& contigs) {
  WordMap words;
  get_kmer_maps(opt, reads, is_pseudo, word_length, capacity, words);

  std::vector<const std::string*> sorted_words;
  sorted_words.reserve(words.size());
  for (const auto& kv : words) sorted_words.push_back(&kv.first);
  std::sort(sorted_words.begin(), sorted_words.end(),
            [](const std::string* a, const std::string* b) {
              return *a < *b;
            });

  std::unordered_set<std::string> repeat_words;
  get_repeat_kmers(words, sorted_words, repeat_words);

  std::unordered_set<std::string> unused_words;
  for (const auto& kv : words)
    if (kv.second.count >= opt.min_coverage) unused_words.insert(kv.first);

  bool is_success = true;
  while (!unused_words.empty() &&
         (int64_t)contigs.size() < 2 * (int64_t)opt.max_assembly_count) {
    // max-count word, smallest in sorted order among ties (the Python
    // scans sorted(unused_words) keeping strictly-greater counts)
    const std::string* max_word = nullptr;
    int32_t max_word_count = 0;
    for (const std::string* w : sorted_words) {
      if (!unused_words.count(*w)) continue;
      const int32_t c = words.at(*w).count;
      if (c > max_word_count) {
        max_word = w;
        max_word_count = c;
      }
    }
    if (!max_word) break;  // unreachable: unused_words implies a max
    contigs.emplace_back();
    const bool is_repeat = walk(opt, *max_word, word_length, words,
                                repeat_words, unused_words, capacity,
                                contigs.back());
    if (is_repeat) is_success = false;
  }
  return is_success;
}

}  // namespace asmx

struct MtAsmResult {
  int32_t n_contigs;
  int64_t* seq_off;
  uint8_t* seq_blob;
  int32_t* cons_beg;
  int32_t* cons_end;
  int64_t* sup_off;
  int32_t* sup_idx;
  int32_t final_read_count;
  int32_t pseudo_start;
};

extern "C" void mt_assemble_free(MtAsmResult* r) {
  if (!r) return;
  free(r->seq_off);
  free(r->seq_blob);
  free(r->cons_beg);
  free(r->cons_end);
  free(r->sup_off);
  free(r->sup_idx);
  free(r);
}

// assembler.py run_iterative_assembler + _select_contigs. Returns the
// selected contigs plus per-contig support read lists so the caller
// can reconstruct read_info (is_used/contig_ids) identically.
extern "C" int mt_assemble(
    int64_t n_reads, const int64_t* read_off, const uint8_t* read_blob,
    int32_t min_word, int32_t max_word, int32_t word_step,
    int32_t min_coverage, int32_t min_cons_coverage,
    int32_t min_unused_reads, int32_t min_support_reads,
    int32_t max_assembly_count, MtAsmResult** out) {
  asmx::Options opt{min_word, max_word, word_step, min_coverage,
                    min_cons_coverage, min_unused_reads,
                    min_support_reads, max_assembly_count};

  std::vector<std::string> reads;
  reads.reserve(n_reads);
  for (int64_t i = 0; i < n_reads; i++)
    reads.emplace_back((const char*)read_blob + read_off[i],
                       (size_t)(read_off[i + 1] - read_off[i]));
  std::vector<bool> is_pseudo(reads.size(), false);
  const int64_t normal_read_count = n_reads;

  // fixed bitset capacity: pseudo reads per iteration are bounded by
  // the contig cap (2 * max_assembly_count)
  const size_t capacity =
      (size_t)n_reads + 2 * (size_t)max_assembly_count + 1;
  std::vector<asmx::Contig> iterative_contigs;
  int32_t word_length = opt.min_word;
  while (word_length <= opt.max_word) {
    iterative_contigs.clear();
    const bool ok = asmx::build_contigs(opt, reads, is_pseudo, word_length,
                                        capacity, iterative_contigs);
    if (ok) break;
    // drop pseudo reads from the previous iteration (always a suffix)
    for (size_t ri = 0; ri < reads.size(); ri++) {
      if (is_pseudo[ri]) {
        reads.resize(ri);
        is_pseudo.resize(ri);
        break;
      }
    }
    for (const asmx::Contig& c : iterative_contigs) {
      if ((int64_t)c.seq.size() > word_length + opt.word_step) {
        reads.push_back(c.seq);
        is_pseudo.push_back(true);
      }
    }
    word_length += opt.word_step;
  }

  // _select_contigs — note contig bitsets were sized for the read count
  // of their build iteration; align by re-checking indexes < that size
  const size_t final_reads = reads.size();
  asmx::Bits used_reads(capacity), used_pseudo(capacity);
  std::vector<asmx::Contig*> candidates;
  for (asmx::Contig& c : iterative_contigs) candidates.push_back(&c);
  std::vector<const asmx::Contig*> final_contigs;

  // indices >= final_reads are stale (erased pseudo) — pseudo reads
  // are always a suffix starting at the same base, so any index at or
  // beyond the first pseudo slot is pseudo
  asmx::Bits pseudo_mask(capacity);
  size_t first_pseudo = final_reads;
  for (size_t ri = 0; ri < final_reads; ri++)
    if (is_pseudo[ri]) { first_pseudo = ri; break; }
  for (size_t ri = first_pseudo; ri < capacity; ri++) pseudo_mask.set(ri);

  while (!candidates.empty() &&
         (int64_t)final_contigs.size() < opt.max_assembly_count) {
    const int64_t used_normal = used_reads.count() - used_pseudo.count();
    const int64_t unused_normal = normal_read_count - used_normal;
    if (unused_normal < opt.min_unused_reads) break;
    std::vector<size_t> to_remove;
    const asmx::Contig* selected = nullptr;
    size_t selected_index = 0;
    int64_t max_support = 0;
    int64_t max_length = 0;
    for (size_t ci = 0; ci < candidates.size(); ci++) {
      const asmx::Contig* c = candidates[ci];
      asmx::Bits new_support = asmx::Bits::andnot(c->support, used_reads);
      const int64_t new_total = new_support.count();
      const int64_t new_normal =
          new_total - asmx::Bits::and_(new_support, pseudo_mask).count();
      if (new_normal < opt.min_support_reads) {
        to_remove.push_back(ci);
        continue;
      }
      if (new_total > max_support ||
          (new_total == max_support &&
           (int64_t)c->seq.size() > max_length)) {
        selected = c;
        selected_index = ci;
        max_support = new_total;
        max_length = (int64_t)c->seq.size();
      }
    }
    if (max_support == 0) break;
    final_contigs.push_back(selected);
    to_remove.push_back(selected_index);
    std::sort(to_remove.begin(), to_remove.end());
    for (size_t k = to_remove.size(); k-- > 0;)
      candidates.erase(candidates.begin() + to_remove[k]);
    used_reads.ior(selected->support);
    used_pseudo.ior(asmx::Bits::and_(selected->support, pseudo_mask));
  }

  // pack the result
  MtAsmResult* r = (MtAsmResult*)calloc(1, sizeof(MtAsmResult));
  const int32_t nc = (int32_t)final_contigs.size();
  r->n_contigs = nc;
  r->final_read_count = (int32_t)final_reads;
  int32_t pseudo_start = (int32_t)final_reads;
  for (size_t ri = 0; ri < final_reads; ri++) {
    if (is_pseudo[ri]) {
      pseudo_start = (int32_t)ri;
      break;
    }
  }
  r->pseudo_start = pseudo_start;
  r->seq_off = (int64_t*)malloc(sizeof(int64_t) * (nc + 1));
  r->sup_off = (int64_t*)malloc(sizeof(int64_t) * (nc + 1));
  r->cons_beg = (int32_t*)malloc(sizeof(int32_t) * (nc > 0 ? nc : 1));
  r->cons_end = (int32_t*)malloc(sizeof(int32_t) * (nc > 0 ? nc : 1));
  int64_t seq_total = 0, sup_total = 0;
  r->seq_off[0] = 0;
  r->sup_off[0] = 0;
  for (int32_t t = 0; t < nc; t++) {
    seq_total += (int64_t)final_contigs[t]->seq.size();
    sup_total += final_contigs[t]->support.count();
    r->seq_off[t + 1] = seq_total;
    r->sup_off[t + 1] = sup_total;
    r->cons_beg[t] = final_contigs[t]->cons_beg;
    r->cons_end[t] = final_contigs[t]->cons_end;
  }
  r->seq_blob = (uint8_t*)malloc(seq_total > 0 ? seq_total : 1);
  r->sup_idx = (int32_t*)malloc(sizeof(int32_t) *
                                (sup_total > 0 ? sup_total : 1));
  int64_t sp = 0;
  for (int32_t t = 0; t < nc; t++) {
    const asmx::Contig* c = final_contigs[t];
    memcpy(r->seq_blob + r->seq_off[t], c->seq.data(), c->seq.size());
    const size_t nb = c->support.w.size() * 64;
    for (size_t ri = 0; ri < nb; ri++)
      if (c->support.test(ri)) r->sup_idx[sp++] = (int32_t)ri;
  }
  *out = r;
  return 0;
}

// ---------------------------------------------------------------------------
// Phase-0 fragment-stats read-pair scan: the sequential
// ReadPairDepthFilter + observation emission inner loop (reference:
// ReadGroupStatsUtil.cpp readPairDepthFilter/TrackerFilter usage in
// extractReadGroupStatsFromAlignmentFile :833-947). The caller passes
// precomputed per-read masks; this walks reads in order, maintains the
// mate-pair bank across calls via an opaque state handle, and stops
// after emitting max_rp proper-pair observations (the tracker's buffer
// boundary) so the Python tracker can commit/convergence-check with
// the exact scalar semantics.

struct MtFragState {
  std::unordered_set<std::string> good_mates;
  int32_t last_tid = 0;
  int32_t last_pos = 0;
  int32_t pos_count = 0;
};

extern "C" void* mt_frag_new() { return new MtFragState(); }
extern "C" void mt_frag_free(void* h) { delete (MtFragState*)h; }

extern "C" int mt_frag_scan(
    void* h, int64_t i0, int64_t n,
    const int32_t* refid, const int32_t* pos, const int32_t* tlen,
    const int32_t* next_pos, const uint8_t* is_first,
    const uint8_t* skip_mask, const int8_t* orient, const int32_t* skip_len,
    const int64_t* name_off, const uint8_t* name,
    int32_t want_obs, int64_t max_rp,
    int8_t* obs_ori, int32_t* obs_frag,
    int64_t* n_obs_out, int64_t* i_next_out) {
  MtFragState& st = *(MtFragState*)h;
  int64_t n_obs = 0, rp = 0;
  std::string key;
  int64_t i = i0;
  for (; i < n; i++) {
    if (skip_mask[i]) continue;
    const int32_t p = pos[i];
    if (refid[i] != st.last_tid) {
      st.good_mates.clear();
      st.last_tid = refid[i];
      st.pos_count = 0;
      st.last_pos = p;
    } else if (p != st.last_pos) {
      st.pos_count = 0;
      st.last_pos = p;
    }
    const int32_t tl = tlen[i];
    if (tl == 0) continue;
    const int32_t mpos = next_pos[i];
    const int readno = is_first[i] ? 1 : 2;
    key.assign((const char*)(name + name_off[i]),
               (size_t)(name_off[i + 1] - name_off[i]));
    bool keep = false;
    if (p >= mpos) {
      key.push_back((char)('0' + (3 - readno)));
      if (st.good_mates.erase(key)) {
        keep = true;
      } else if (p > mpos) {
        continue;
      }
      key.pop_back();
    }
    if (!keep) {
      if (st.pos_count >= 1) continue;
      st.pos_count++;
      if (st.good_mates.size() > 100000) st.good_mates.clear();
      if (skip_len[i] > 0) continue;
      key.push_back((char)('0' + readno));
      st.good_mates.insert(key);
      continue;
    }
    if (!want_obs) continue;
    const int8_t ori = orient[i];
    int32_t frag = 0;
    if (ori == 4) {  // ORIENT_RP
      const int64_t raw = (tl < 0 ? -(int64_t)tl : tl) - skip_len[i];
      if (raw <= 0) {
        *n_obs_out = n_obs;
        *i_next_out = i;
        return -1;
      }
      int64_t s = raw, mul = 1;
      while (s > 1000) { s /= 10; mul *= 10; }
      frag = (int32_t)(s * mul);
    }
    obs_ori[n_obs] = ori;
    obs_frag[n_obs] = frag;
    n_obs++;
    if (ori == 4 && ++rp >= max_rp) { i++; break; }
  }
  *n_obs_out = n_obs;
  *i_next_out = i;
  return 0;
}

// ---------------------------------------------------------------------------
// Breakend-graph merge engine (reference: svgraph/SVLocus.{hpp,cpp},
// SVLocusSet.{hpp,cpp}; behavioral map: manta_tpu/graph/locusgraph.py,
// which this replicates operation-for-operation so phase-1 builds are
// bit-identical between the host and native engines). Exposed as an
// opaque handle driven by graph/native_set.py during phase-1 graph
// construction; the Python SVLocusSet remains the interchange/query
// structure for phase 2.

namespace svg {

struct Node {
  int32_t tid = 0, beg = 0, end = 0, ev_beg = 0, ev_end = 0;
  std::map<int32_t, int32_t> edges;

  bool is_out_count() const {
    for (const auto& kv : edges)
      if (kv.second > 0) return true;
    return false;
  }
  bool intersects(int32_t t, int32_t b, int32_t e) const {
    return tid == t && beg < e && b < end;
  }
  bool is_intersect(const Node& o) const {
    return intersects(o.tid, o.beg, o.end);
  }
};

struct Locus {
  std::vector<Node> nodes;
};

struct Entry {
  int32_t tid, beg, end, li, ni;
  bool operator<(const Entry& o) const {
    if (tid != o.tid) return tid < o.tid;
    if (beg != o.beg) return beg < o.beg;
    if (end != o.end) return end < o.end;
    if (li != o.li) return li < o.li;
    return ni < o.ni;
  }
  bool operator==(const Entry& o) const {
    return tid == o.tid && beg == o.beg && end == o.end && li == o.li &&
           ni == o.ni;
  }
};

typedef std::pair<int32_t, int32_t> Addr;

// peak interval-sum (reference: blt_util/RegionSum.hpp)
struct RegionSum {
  std::vector<std::pair<std::pair<int32_t, int32_t>, int32_t>> events;
  void clear() { events.clear(); }
  void add(int32_t beg, int32_t end, int32_t val) {
    events.push_back({{beg, 0}, val});
    events.push_back({{end, 0}, -val});
  }
  int64_t max_val() {
    if (events.empty()) return 0;
    // python sorts (pos, delta) pairs: ties ordered by delta
    for (auto& e : events) e.first.second = e.second;
    std::sort(events.begin(), events.end(),
              [](const auto& a, const auto& b) {
                if (a.first.first != b.first.first)
                  return a.first.first < b.first.first;
                return a.second < b.second;
              });
    int64_t best = 0, cur = 0;
    for (const auto& e : events) {
      cur += e.second;
      if (cur > best) best = cur;
    }
    return best;
  }
};

struct GraphSet {
  int32_t min_merge_edge_count = 3;
  int32_t max_search_count = 500;
  double max_search_density = 0.5;
  bool is_finalized = false;
  int64_t total_cleaned = 0;
  int64_t highest_search_count = 0;
  double highest_search_density = 0.0;
  bool is_max_search_count = false, is_max_search_density = false;
  std::vector<Locus> loci;
  std::set<int32_t> empty_loci;
  std::set<Entry> inodes;
  std::vector<int32_t> max_region_size;  // per tid
  RegionSum merge_regions[4];
  int err = 0;  // first invariant violation (assert parity)

  Entry entry(int32_t li, int32_t ni) const {
    const Node& n = loci[li].nodes[ni];
    return Entry{n.tid, n.beg, n.end, li, ni};
  }
  void index_add(int32_t li, int32_t ni) {
    const Node& n = loci[li].nodes[ni];
    inodes.insert(Entry{n.tid, n.beg, n.end, li, ni});
    const int32_t size = n.end - n.beg;
    if (n.tid >= 0 && n.tid < (int32_t)max_region_size.size() &&
        size > max_region_size[n.tid])
      max_region_size[n.tid] = size;
  }
  void index_del(int32_t li, int32_t ni) {
    const Node& n = loci[li].nodes[ni];
    inodes.erase(Entry{n.tid, n.beg, n.end, li, ni});
  }

  // ---- locus-level ops on indexed loci (observer notifications live)

  void merge_node(int32_t li, int32_t from_idx, int32_t to_idx) {
    Locus& locus = loci[li];
    Node& fnode = locus.nodes[from_idx];
    Node& tnode = locus.nodes[to_idx];
    if (fnode.tid != tnode.tid) { err = 1; return; }
    index_del(li, to_idx);
    tnode.beg = std::min(tnode.beg, fnode.beg);
    tnode.end = std::max(tnode.end, fnode.end);
    const bool t_has = tnode.is_out_count(), f_has = fnode.is_out_count();
    if (!t_has && f_has) {
      tnode.ev_beg = fnode.ev_beg;
      tnode.ev_end = fnode.ev_end;
    } else if (!(f_has && !t_has) && !(!f_has && t_has)) {
      tnode.ev_beg = std::min(tnode.ev_beg, fnode.ev_beg);
      tnode.ev_end = std::max(tnode.ev_end, fnode.ev_end);
    }
    index_add(li, to_idx);

    const std::vector<std::pair<int32_t, int32_t>> fedges(
        fnode.edges.begin(), fnode.edges.end());
    for (const auto& kv : fedges) {
      const int32_t edge_idx = kv.first;
      const int32_t edge_count = kv.second;
      if (edge_idx == from_idx) {
        tnode.edges[to_idx] += edge_count;
        continue;
      }
      const bool is_from_to_edge = (edge_idx == to_idx);
      int32_t merge_count = 0;
      if (is_from_to_edge) {
        const int32_t from_count = edge_count;
        int32_t to_count = 0;
        auto it = tnode.edges.find(from_idx);
        if (it != tnode.edges.end()) to_count = it->second;
        auto it2 = tnode.edges.find(to_idx);
        merge_count = (it2 != tnode.edges.end() ? it2->second : 0) +
                      std::max(from_count, to_count);
      }
      tnode.edges[edge_idx] += edge_count;
      if (is_from_to_edge) {
        tnode.edges[to_idx] = merge_count;
        tnode.edges[from_idx] = 0;
      }
      Node& remote = locus.nodes[edge_idx];
      auto rit = remote.edges.find(from_idx);
      if (rit == remote.edges.end()) { err = 2; return; }
      remote.edges[to_idx] += rit->second;
    }
    clear_node_edges(li, from_idx);
  }

  void clear_node_edges(int32_t li, int32_t i) {
    Locus& locus = loci[li];
    Node& node = locus.nodes[i];
    for (const auto& kv : node.edges) {
      if (kv.first == i) continue;
      locus.nodes[kv.first].edges.erase(i);
    }
    node.edges.clear();
  }

  void erase_node(int32_t li, int32_t i) {
    Locus& locus = loci[li];
    if (i >= (int32_t)locus.nodes.size()) return;
    clear_node_edges(li, i);
    const int32_t last = (int32_t)locus.nodes.size() - 1;
    if (last != i) {
      Node& lnode = locus.nodes[last];
      bool handle_self = false;
      const std::vector<int32_t> ekeys = [&] {
        std::vector<int32_t> k;
        for (const auto& kv : lnode.edges) k.push_back(kv.first);
        return k;
      }();
      for (const int32_t j : ekeys) {
        if (j == last) {
          handle_self = true;
          continue;
        }
        Node& remote = locus.nodes[j];
        remote.edges[i] = remote.edges[last];
        remote.edges.erase(last);
      }
      if (handle_self) {
        lnode.edges[i] = lnode.edges[last];
        lnode.edges.erase(last);
      }
      index_del(li, i);
      locus.nodes[i] = std::move(locus.nodes[last]);
      index_add(li, i);
    }
    index_del(li, last);
    locus.nodes.pop_back();
  }

  void clear_locus(int32_t idx) {
    Locus& locus = loci[idx];
    for (int32_t i = 0; i < (int32_t)locus.nodes.size(); i++)
      index_del(idx, i);
    locus.nodes.clear();
    empty_loci.insert(idx);
  }

  int32_t insert_locus(const Locus& src) {
    int32_t idx;
    if (!empty_loci.empty()) {
      idx = *empty_loci.begin();
      empty_loci.erase(empty_loci.begin());
    } else {
      idx = (int32_t)loci.size();
      loci.emplace_back();
    }
    copy_from(idx, src);
    return idx;
  }

  void copy_from(int32_t to_idx, const Locus& other) {
    Locus& target = loci[to_idx];
    const int32_t offset = (int32_t)target.nodes.size();
    for (const Node& node : other.nodes) {
      Node n;
      n.tid = node.tid; n.beg = node.beg; n.end = node.end;
      n.ev_beg = node.ev_beg; n.ev_end = node.ev_end;
      for (const auto& kv : node.edges)
        n.edges[kv.first + offset] = kv.second;
      target.nodes.push_back(std::move(n));
      index_add(to_idx, (int32_t)target.nodes.size() - 1);
    }
  }

  bool is_noise_node(const Addr& a) const {
    const Locus& locus = loci[a.first];
    const Node& node = locus.nodes[a.second];
    for (const auto& kv : node.edges) {
      if (kv.second >= min_merge_edge_count) return false;
      auto it = locus.nodes[kv.first].edges.find(a.second);
      if (it != locus.nodes[kv.first].edges.end() &&
          it->second >= min_merge_edge_count)
        return false;
    }
    return true;
  }

  int64_t clean_node_core(int32_t li, int32_t i, std::set<int32_t>& empty) {
    int64_t total = 0;
    Locus& locus = loci[li];
    Node& node = locus.nodes[i];
    std::vector<int32_t> keys;
    for (const auto& kv : node.edges) keys.push_back(kv.first);
    std::vector<int32_t> erase_edges;
    for (const int32_t j : keys) {
      int32_t c = node.edges[j];
      if (c != 0 && c < min_merge_edge_count) {
        total += c;
        node.edges[j] = 0;
        c = 0;
      }
      if (c == 0) {
        auto it = locus.nodes[j].edges.find(i);
        const int32_t back = (it != locus.nodes[j].edges.end())
                                 ? it->second : 0;
        if (back == 0) {
          erase_edges.push_back(j);
          const Node& remote = locus.nodes[j];
          if (!remote.is_out_count() && remote.edges.size() == 1)
            empty.insert(j);
        }
      }
    }
    for (const int32_t j : erase_edges) {
      node.edges.erase(j);
      if (j != i) locus.nodes[j].edges.erase(i);
    }
    if (node.edges.empty() && !node.is_out_count()) empty.insert(i);
    return total;
  }

  void erase_nodes(int32_t li, const std::set<int32_t>& idxs) {
    if (idxs.empty()) return;
    Locus& locus = loci[li];
    if (idxs.size() == locus.nodes.size()) {
      for (int32_t i = 0; i < (int32_t)locus.nodes.size(); i++)
        index_del(li, i);
      locus.nodes.clear();
      return;
    }
    for (auto it = idxs.rbegin(); it != idxs.rend(); ++it)
      erase_node(li, *it);
  }

  int64_t clean_node(int32_t li, int32_t i) {
    std::set<int32_t> empty;
    const int64_t total = clean_node_core(li, i, empty);
    erase_nodes(li, empty);
    return total;
  }
};

}  // namespace svg

namespace svg {

// getIntersectingNodeAddressesCore (locusgraph.py _intersecting_core)
static bool intersecting_core(GraphSet& g, const Addr& query,
                              const std::set<Entry>& search,
                              int32_t filter_locus, bool is_test_usability,
                              std::set<Addr>& out) {
  const Node& qnode = g.loci[query.first].nodes[query.second];
  const Entry q_entry{qnode.tid, qnode.beg, qnode.end, query.first,
                      query.second};
  auto start = search.lower_bound(q_entry);
  const int32_t max_region =
      (qnode.tid >= 0 && qnode.tid < (int32_t)g.max_region_size.size())
          ? g.max_region_size[qnode.tid] : 0;
  bool usable = true;
  int64_t search_count = 0;

  for (auto it = start; it != search.end(); ++it) {
    if (is_test_usability) {
      search_count++;
      if (search_count > g.max_search_count) {
        usable = false;
        g.is_max_search_count = true;
        break;
      }
    }
    if (it->li == filter_locus) continue;
    if (!qnode.intersects(it->tid, it->beg, it->end)) break;
    out.insert(Addr(it->li, it->ni));
  }

  auto it = start;
  while (it != search.begin()) {
    --it;
    if (is_test_usability) {
      if (!usable) break;
      search_count++;
      if (search_count > g.max_search_count) {
        usable = false;
        g.is_max_search_count = true;
        break;
      }
    }
    if (it->li == filter_locus) continue;
    if (!qnode.intersects(it->tid, it->beg, it->end)) {
      if (g.is_finalized) break;  // overlap not allowed once finalized
      if (qnode.tid != it->tid) break;
      if ((int64_t)it->beg + max_region < qnode.beg) break;
      continue;
    }
    out.insert(Addr(it->li, it->ni));
  }

  if (!is_test_usability) return true;

  if (search_count > g.highest_search_count)
    g.highest_search_count = search_count;
  int64_t search_size =
      qnode.end - std::max((int64_t)0, (int64_t)qnode.beg - max_region);
  if (search_size != 0) {
    if (search_size < 40) search_size = 40;
    const double density = (double)search_count / (double)search_size;
    if (density > g.highest_search_density)
      g.highest_search_density = density;
    if (density > g.max_search_density) {
      usable = false;
      g.is_max_search_density = true;
    }
  }
  return usable;
}

// getMergeableIntersectingNodeAddresses (locusgraph.py _get_mergeable)
static void get_mergeable(GraphSet& g, int32_t query_locus,
                          int32_t query_node, bool is_query_duplicated,
                          std::set<Addr>& out) {
  const Addr query_addr(query_locus, query_node);
  std::set<Addr> intersecting;
  intersecting_core(g, query_addr, g.inodes, query_locus, false,
                    intersecting);

  std::set<Entry> remote_search;
  std::map<Addr, std::vector<int32_t>> remote_to_local;
  for (const Addr& addr : intersecting) {
    const Node& inode = g.loci[addr.first].nodes[addr.second];
    for (const auto& kv : inode.edges) {
      const Addr conn(addr.first, kv.first);
      auto it = remote_to_local.find(conn);
      if (it == remote_to_local.end()) {
        it = remote_to_local.emplace(conn, std::vector<int32_t>()).first;
        const Node& cn = g.loci[conn.first].nodes[conn.second];
        remote_search.insert(
            Entry{cn.tid, cn.beg, cn.end, conn.first, conn.second});
      }
      it->second.push_back(addr.second);
    }
  }

  std::set<Addr> signal_nodes;
  for (const Addr& addr : intersecting)
    if (!g.is_noise_node(addr)) signal_nodes.insert(addr);

  const Node& qn = g.loci[query_locus].nodes[query_node];
  // iterate a snapshot of the query node's out-edges
  std::vector<int32_t> q_edges;
  for (const auto& kv : qn.edges) q_edges.push_back(kv.first);

  for (const int32_t remote_node_idx : q_edges) {
    // getIntersectingEdges
    std::set<Addr> hits;
    intersecting_core(g, Addr(query_locus, remote_node_idx), remote_search,
                      query_locus, false, hits);
    std::vector<std::pair<Addr, int32_t>> edges;  // (local addr, remote ni)
    for (const Addr& addr : hits)
      for (const int32_t local_node : remote_to_local[addr])
        edges.push_back({Addr(addr.first, local_node), addr.second});

    int64_t edge_count = (int64_t)edges.size();
    if (!is_query_duplicated) edge_count++;
    const bool is_region_check = edge_count > 2;
    if (is_region_check)
      for (auto& rs : g.merge_regions) rs.clear();
    int64_t out_ev = 0, in_ev = 0;

    auto add_edge_evidence = [&](int32_t li, int32_t from_node,
                                 int32_t to_node) {
      Locus& locus = g.loci[li];
      const int32_t inc = locus.nodes[to_node].edges[from_node];
      const int32_t outc = locus.nodes[from_node].edges[to_node];
      if (is_region_check) {
        const Node& ln = locus.nodes[from_node];
        const Node& rn = locus.nodes[to_node];
        g.merge_regions[0].add(ln.beg, ln.end, outc);
        g.merge_regions[1].add(ln.beg, ln.end, inc);
        g.merge_regions[2].add(rn.beg, rn.end, inc);
        g.merge_regions[3].add(rn.beg, rn.end, outc);
      } else {
        out_ev += outc;
        in_ev += inc;
      }
    };

    for (const auto& e : edges)
      add_edge_evidence(e.first.first, e.first.second, e.second);
    if (!is_query_duplicated)
      add_edge_evidence(query_locus, query_node, remote_node_idx);

    if (is_region_check) {
      out_ev = std::min(g.merge_regions[0].max_val(),
                        g.merge_regions[3].max_val());
      in_ev = std::min(g.merge_regions[1].max_val(),
                       g.merge_regions[2].max_val());
    }
    if (out_ev < g.min_merge_edge_count && in_ev < g.min_merge_edge_count)
      continue;

    // type1 nodes
    for (const auto& e : edges) out.insert(e.first);

    std::set<Addr> remote_addrs;
    for (const auto& e : edges)
      remote_addrs.insert(Addr(e.first.first, e.second));

    // getIntersectingSignalNodeAddresses
    auto get_signal = [&](const Addr& target) {
      std::set<Addr> shits;
      intersecting_core(g, target, g.inodes, query_locus, false, shits);
      bool intersects_target = false;
      for (const Addr& addr : shits) {
        if (!g.is_noise_node(addr))
          signal_nodes.insert(addr);
        else if (remote_addrs.count(addr))
          intersects_target = true;
      }
      return intersects_target;
    };

    bool intersect_remotes = get_signal(query_addr);
    for (const auto& e : edges) intersect_remotes |= get_signal(e.first);
    if (intersect_remotes) {
      for (const Addr& raddr : remote_addrs) {
        out.insert(raddr);
        get_signal(raddr);
      }
    }
    // type2 nodes
    for (const Addr& s : signal_nodes) out.insert(s);
  }
}

static void combine_loci(GraphSet& g, int32_t from_idx, int32_t to_idx,
                         bool clear_source) {
  if (from_idx == to_idx || from_idx >= (int32_t)g.loci.size()) return;
  Locus& from_locus = g.loci[from_idx];
  if (from_locus.nodes.empty()) return;
  // copy_from may reallocate loci? no: vector indices stable, but the
  // source reference stays valid because copy_from only mutates the
  // target locus and the index
  g.copy_from(to_idx, from_locus);
  if (clear_source) g.clear_locus(from_idx);
}

static int32_t move_to_lowest_locus(GraphSet& g,
                                    const std::set<Addr>& mergeable,
                                    int32_t start_locus_idx,
                                    int32_t head_locus_idx) {
  const int32_t input_head = head_locus_idx;
  int32_t new_head = mergeable.begin()->first;
  for (const Addr& a : mergeable) new_head = std::min(new_head, a.first);
  const bool clear_source = start_locus_idx != input_head;
  combine_loci(g, input_head, new_head, clear_source);
  for (const Addr& addr : mergeable)  // std::set iterates ascending
    combine_loci(g, addr.first, new_head, true);
  return new_head;
}

// merge(SVLocus) (locusgraph.py merge_locus)
static int merge_locus(GraphSet& g, const Locus& input_locus) {
  if (g.is_finalized || input_locus.nodes.empty()) return -10;
  const int32_t start_locus_idx = g.insert_locus(input_locus);
  int32_t head_locus_idx = start_locus_idx;
  bool is_duplicated = false;
  bool is_abort = false;

  // order nodes by interval; identical intervals keep the first node
  std::map<std::array<int32_t, 3>, int32_t> interval_map;
  {
    const Locus& sl = g.loci[start_locus_idx];
    for (int32_t i = 0; i < (int32_t)sl.nodes.size(); i++) {
      const Node& nd = sl.nodes[i];
      interval_map.emplace(std::array<int32_t, 3>{nd.tid, nd.beg, nd.end},
                           i);
    }
  }
  std::vector<int32_t> node_order;
  for (const auto& kv : interval_map) node_order.push_back(kv.second);

  const bool is_test_usability = input_locus.nodes.size() <= 2;
  for (const int32_t node_idx : node_order) {
    std::set<Addr> tmp;
    const bool usable =
        intersecting_core(g, Addr(start_locus_idx, node_idx), g.inodes,
                          start_locus_idx, is_test_usability, tmp);
    if (!usable) {
      is_abort = true;
      break;
    }
  }

  for (const int32_t node_idx : node_order) {
    if (is_abort) break;
    std::set<Addr> mergeable;
    get_mergeable(g, start_locus_idx, node_idx, is_duplicated, mergeable);
    if (mergeable.empty()) continue;
    if (is_duplicated && mergeable.size() < 2) continue;

    auto all_head = [&] {
      for (const Addr& a : mergeable)
        if (a.first != head_locus_idx) return false;
      return true;
    };
    while (!all_head()) {
      head_locus_idx =
          move_to_lowest_locus(g, mergeable, start_locus_idx,
                               head_locus_idx);
      if (!is_duplicated)
        is_duplicated = head_locus_idx != start_locus_idx;
      mergeable.clear();
      get_mergeable(g, start_locus_idx, node_idx, is_duplicated, mergeable);
      if (mergeable.empty()) return -11;
    }

    // superset node of the start node, in ascending ADDRESS order —
    // the reference iterates std::set<NodeAddressType>, i.e.
    // (locus, node-index) pairs (SVLocusSet.cpp:270-288)
    const Node& snode = g.loci[start_locus_idx].nodes[node_idx];
    bool have_superset = false;
    Addr superset_addr(0, 0);
    for (const Addr& a : mergeable) {
      const Node& cand = g.loci[a.first].nodes[a.second];
      if (cand.beg <= snode.beg && cand.end >= snode.end) {
        superset_addr = a;
        have_superset = true;
        break;
      }
    }
    if (!have_superset) return -12;

    Addr target_addr = superset_addr;
    std::map<int32_t, int32_t> remap;
    auto resolve = [&](Addr a) {
      int32_t i = a.second;
      auto it = remap.find(i);
      while (it != remap.end()) {
        i = it->second;
        it = remap.find(i);
      }
      return Addr(a.first, i);
    };
    // merge in DESCENDING address order (the reference's
    // BOOST_REVERSE_FOREACH over the address set,
    // SVLocusSet.cpp:292-310); the descending order means each erase's
    // swap-with-last can only move node indexes above every remaining
    // address, so the remap chain below stays a no-op safety net
    for (auto it = mergeable.rbegin(); it != mergeable.rend(); ++it) {
      const Addr addr = *it;
      if (addr == superset_addr) continue;
      Addr a = resolve(addr);
      Addr t = resolve(target_addr);
      if (a == t) continue;
      if (a < t) std::swap(a, t);
      if (a.first != t.first) return -13;
      const int32_t last = (int32_t)g.loci[a.first].nodes.size() - 1;
      g.merge_node(a.first, a.second, t.second);
      if (g.err) return -14;
      g.erase_node(a.first, a.second);
      if (last != a.second) remap[last] = a.second;
      target_addr = t;
    }
  }

  if (is_abort || is_duplicated) g.clear_locus(start_locus_idx);
  return 0;
}

}  // namespace svg

extern "C" void* mt_graph_new(int32_t min_merge_edge_count,
                              int32_t max_search_count,
                              double max_search_density, int32_t n_tids) {
  svg::GraphSet* g = new svg::GraphSet();
  g->min_merge_edge_count = min_merge_edge_count;
  g->max_search_count = max_search_count;
  g->max_search_density = max_search_density;
  g->max_region_size.assign(n_tids, 0);
  return g;
}

extern "C" void mt_graph_free(void* h) { delete (svg::GraphSet*)h; }

extern "C" int mt_graph_insert_read(void* h, int32_t tid1, int32_t beg1,
                                    int32_t end1, int32_t ev_beg,
                                    int32_t ev_end, int32_t w1,
                                    int32_t is_complex, int32_t tid2,
                                    int32_t beg2, int32_t end2, int32_t w2) {
  svg::GraphSet& g = *(svg::GraphSet*)h;
  svg::Locus locus;
  svg::Node n1;
  n1.tid = tid1; n1.beg = beg1; n1.end = end1;
  n1.ev_beg = ev_beg; n1.ev_end = ev_end;
  locus.nodes.push_back(n1);
  if (is_complex) {
    locus.nodes[0].edges[0] = w1;  // self-edge (from_count + to_count=0)
  } else {
    svg::Node n2;
    n2.tid = tid2; n2.beg = beg2; n2.end = end2;
    n2.ev_beg = beg2; n2.ev_end = end2;
    locus.nodes.push_back(n2);
    locus.nodes[0].edges[1] = w1;
    locus.nodes[1].edges[0] = w2;
    // merge_self_overlap for the 2-node case (standalone, no index)
    if (locus.nodes[1].is_intersect(locus.nodes[0])) {
      // merge_node(1 -> 0) on the standalone pair, then erase node 1
      svg::Node& f = locus.nodes[1];
      svg::Node& t = locus.nodes[0];
      t.beg = std::min(t.beg, f.beg);
      t.end = std::max(t.end, f.end);
      const bool t_has = t.is_out_count(), f_has = f.is_out_count();
      if (!t_has && f_has) {
        t.ev_beg = f.ev_beg; t.ev_end = f.ev_end;
      } else if ((t_has && f_has) || (!t_has && !f_has)) {
        t.ev_beg = std::min(t.ev_beg, f.ev_beg);
        t.ev_end = std::max(t.ev_end, f.ev_end);
      }
      // f's only edge is 1->0 (the from->to edge): apply the chimera
      // max-count rule with the return edge, landing on a 0->0 self
      // edge of max(w1... the from-edge is f.edges[0]=w2? note: from
      // node is index1 whose edge to index0 carries w2
      const int32_t from_count = f.edges[0];
      const int32_t to_count = t.edges.count(1) ? t.edges[1] : 0;
      t.edges[0] = std::max(from_count, to_count);
      t.edges.erase(1);
      locus.nodes.pop_back();
    }
  }
  return svg::merge_locus(g, locus);
}

extern "C" int mt_graph_clean_region(void* h, int32_t tid, int32_t beg,
                                     int32_t end) {
  svg::GraphSet& g = *(svg::GraphSet*)h;
  // probe locus insertion mirrors get_region_intersect exactly
  // (including its max_region_size side effect)
  svg::Locus probe;
  svg::Node pn;
  pn.tid = tid; pn.beg = beg; pn.end = end;
  pn.ev_beg = beg; pn.ev_end = end;
  probe.nodes.push_back(pn);
  const int32_t idx = g.insert_locus(probe);
  std::set<svg::Addr> hits;
  svg::intersecting_core(g, svg::Addr(idx, 0), g.inodes, idx, false, hits);
  g.clear_locus(idx);
  for (auto it = hits.rbegin(); it != hits.rend(); ++it) {
    svg::Locus& locus = g.loci[it->first];
    if (locus.nodes.empty()) continue;
    g.total_cleaned += g.clean_node(it->first, it->second);
    if (locus.nodes.empty()) g.empty_loci.insert(it->first);
  }
  return 0;
}

extern "C" int64_t mt_graph_finalize(void* h) {
  // whole-graph clean + finalization flag (locusgraph.py
  // SVLocusSet.finalize -> clean; reference SVLocusSet::finalize,
  // SVLocusSet.cpp).  Mirrors the Python path exactly: per locus,
  // clean every node accumulating the locus-local empty set, then one
  // erase_nodes sweep; empties recorded, totals accumulated.
  svg::GraphSet& g = *(svg::GraphSet*)h;
  for (int32_t li = 0; li < (int32_t)g.loci.size(); li++) {
    svg::Locus& locus = g.loci[li];
    if (locus.nodes.empty()) continue;
    std::set<int32_t> empty;
    int64_t total = 0;
    for (int32_t i = 0; i < (int32_t)locus.nodes.size(); i++)
      total += g.clean_node_core(li, i, empty);
    g.erase_nodes(li, empty);
    g.total_cleaned += total;
    if (locus.nodes.empty()) g.empty_loci.insert(li);
  }
  g.is_finalized = true;
  return g.total_cleaned;
}

extern "C" int mt_graph_merge_graph(void* dst, void* src) {
  svg::GraphSet& d = *(svg::GraphSet*)dst;
  svg::GraphSet& s = *(svg::GraphSet*)src;
  if (d.min_merge_edge_count != s.min_merge_edge_count) return -1;
  for (const svg::Locus& locus : s.loci) {
    if (locus.nodes.empty()) continue;
    const int rc = svg::merge_locus(d, locus);
    if (rc != 0) return rc;
  }
  d.total_cleaned += s.total_cleaned;
  d.highest_search_count =
      std::max(d.highest_search_count, s.highest_search_count);
  d.is_max_search_count |= s.is_max_search_count;
  d.highest_search_density =
      std::max(d.highest_search_density, s.highest_search_density);
  d.is_max_search_density |= s.is_max_search_density;
  return 0;
}

extern "C" int mt_graph_load(void* h, int64_t n_loci,
                             const int64_t* locus_sizes,
                             const int64_t* nodes6, const int64_t* edges2) {
  // reconstruct a saved graph (locusgraph.py load + reconstruct_index)
  svg::GraphSet& g = *(svg::GraphSet*)h;
  int64_t ni = 0, ei = 0;
  for (int64_t li = 0; li < n_loci; li++) {
    g.loci.emplace_back();
    svg::Locus& locus = g.loci.back();
    for (int64_t k = 0; k < locus_sizes[li]; k++, ni++) {
      svg::Node n;
      n.tid = (int32_t)nodes6[ni * 6 + 0];
      n.beg = (int32_t)nodes6[ni * 6 + 1];
      n.end = (int32_t)nodes6[ni * 6 + 2];
      n.ev_beg = (int32_t)nodes6[ni * 6 + 3];
      n.ev_end = (int32_t)nodes6[ni * 6 + 4];
      const int64_t n_edges = nodes6[ni * 6 + 5];
      for (int64_t e = 0; e < n_edges; e++, ei++)
        n.edges[(int32_t)edges2[ei * 2 + 0]] = (int32_t)edges2[ei * 2 + 1];
      locus.nodes.push_back(std::move(n));
      g.index_add((int32_t)li, (int32_t)k);
    }
    if (locus.nodes.empty()) g.empty_loci.insert((int32_t)li);
  }
  return 0;
}

extern "C" void mt_graph_set_stats(void* h, int64_t total_cleaned,
                                   int64_t highest_count,
                                   double highest_density,
                                   int32_t is_max_count,
                                   int32_t is_max_density) {
  svg::GraphSet& g = *(svg::GraphSet*)h;
  g.total_cleaned = total_cleaned;
  g.highest_search_count = highest_count;
  g.highest_search_density = highest_density;
  g.is_max_search_count = is_max_count != 0;
  g.is_max_search_density = is_max_density != 0;
}

extern "C" void mt_graph_counts(void* h, int64_t* n_loci, int64_t* n_nodes,
                                int64_t* n_edges) {
  svg::GraphSet& g = *(svg::GraphSet*)h;
  int64_t nl = 0, nn = 0, ne = 0;
  for (const svg::Locus& locus : g.loci) {
    if (locus.nodes.empty()) continue;
    nl++;
    nn += (int64_t)locus.nodes.size();
    for (const svg::Node& node : locus.nodes)
      ne += (int64_t)node.edges.size();
  }
  *n_loci = nl;
  *n_nodes = nn;
  *n_edges = ne;
}

extern "C" int mt_graph_export(void* h, int64_t* locus_sizes,
                               int64_t* nodes6, int64_t* edges2,
                               int64_t* total_cleaned,
                               int64_t* highest_count,
                               double* highest_density,
                               int32_t* is_max_count,
                               int32_t* is_max_density) {
  // same iteration order as locusgraph.py save(): loci in slot order
  // (empties skipped), nodes in storage order, edges sorted by key
  svg::GraphSet& g = *(svg::GraphSet*)h;
  int64_t li = 0, ni = 0, ei = 0;
  for (const svg::Locus& locus : g.loci) {
    if (locus.nodes.empty()) continue;
    locus_sizes[li++] = (int64_t)locus.nodes.size();
    for (const svg::Node& node : locus.nodes) {
      nodes6[ni * 6 + 0] = node.tid;
      nodes6[ni * 6 + 1] = node.beg;
      nodes6[ni * 6 + 2] = node.end;
      nodes6[ni * 6 + 3] = node.ev_beg;
      nodes6[ni * 6 + 4] = node.ev_end;
      nodes6[ni * 6 + 5] = (int64_t)node.edges.size();
      ni++;
      for (const auto& kv : node.edges) {  // std::map: ascending keys
        edges2[ei * 2 + 0] = kv.first;
        edges2[ei * 2 + 1] = kv.second;
        ei++;
      }
    }
  }
  *total_cleaned = g.total_cleaned;
  *highest_count = g.highest_search_count;
  *highest_density = g.highest_search_density;
  *is_max_count = g.is_max_search_count ? 1 : 0;
  *is_max_density = g.is_max_search_density ? 1 : 0;
  return 0;
}

// Multi-chunk filtered BAM parse: one struct-of-arrays batch from the
// decompressed byte ranges of all BAI chunks of a region query, with
// the region-overlap predicate applied during the walk (replaces
// per-chunk parse + concat + subset on the Python side; overlap
// semantics: io/bam.py parse_records want_overlap — zero-aligned-length
// records count as 1-base intervals, htslib region-query parity).

namespace {
inline bool bam_rec_keep(const uint8_t* p, int32_t tid, int64_t beg,
                         int64_t end) {
  int32_t rid, pp;
  std::memcpy(&rid, p, 4);
  if (rid != tid) return false;
  std::memcpy(&pp, p + 4, 4);
  if ((int64_t)pp >= end) return false;
  uint16_t ncig;
  std::memcpy(&ncig, p + 12, 2);
  const uint8_t lqn = p[8];
  const uint8_t* c = p + 32 + lqn;
  const uint32_t ref_ops = (1u << 0) | (1u << 2) | (1u << 3) |
                           (1u << 7) | (1u << 8);
  int64_t ref_len = 0;
  for (int64_t k = 0; k < ncig; k++) {
    uint32_t v;
    std::memcpy(&v, c + 4 * k, 4);
    if (ref_ops & (1u << (v & 0xF))) ref_len += v >> 4;
  }
  return pp + (ref_len > 1 ? ref_len : 1) > beg;
}
}  // namespace

extern "C" int mt_bam_size_multi(
    int64_t n_bufs, const uint8_t* const* bufs, const int64_t* lens,
    const int64_t* starts,
    int32_t do_filter, int32_t tid, int64_t beg, int64_t end,
    int64_t* out_n, int64_t* out_cigar, int64_t* out_seq,
    int64_t* out_name, int64_t* out_tags) {
  int64_t n = 0, tot_cigar = 0, tot_seq = 0, tot_name = 0, tot_tags = 0;
  for (int64_t b = 0; b < n_bufs; b++) {
    const uint8_t* buf = bufs[b];
    const int64_t buflen = lens[b];
    int64_t i = starts[b];
    while (i + 4 <= buflen) {
      uint32_t bs;
      std::memcpy(&bs, buf + i, 4);
      if (i + 4 + (int64_t)bs > buflen) break;
      const uint8_t* p = buf + i + 4;
      if (!do_filter || bam_rec_keep(p, tid, beg, end)) {
        const uint8_t lqn = p[8];
        uint16_t ncig;
        std::memcpy(&ncig, p + 12, 2);
        int32_t lseq;
        std::memcpy(&lseq, p + 16, 4);
        const int64_t tag_len = (int64_t)bs - 32 - lqn - 4LL * ncig -
                                ((lseq + 1) / 2) - lseq;
        n++;
        tot_cigar += ncig;
        tot_seq += lseq;
        tot_name += lqn - 1;
        tot_tags += (tag_len > 0 ? tag_len : 0);
      }
      i += 4 + bs;
    }
  }
  *out_n = n;
  *out_cigar = tot_cigar;
  *out_seq = tot_seq;
  *out_name = tot_name;
  *out_tags = tot_tags;
  return 0;
}

extern "C" int mt_bam_fill_multi(
    int64_t n_bufs, const uint8_t* const* bufs, const int64_t* lens,
    const int64_t* starts,
    int32_t do_filter, int32_t tid, int64_t beg, int64_t end, int64_t n,
    int32_t* refid, int32_t* pos, uint8_t* mapq, uint16_t* flag,
    int32_t* nrefid, int32_t* npos, int32_t* tlen,
    int64_t* cigar_off, uint32_t* cigar_out,
    int64_t* seq_off, uint8_t* seq_out,
    int64_t* qual_off, uint8_t* qual_out,
    int64_t* name_off, uint8_t* name_out,
    int64_t* tag_off, uint8_t* tag_out) {
  int64_t k = 0;
  cigar_off[0] = seq_off[0] = qual_off[0] = name_off[0] = tag_off[0] = 0;
  for (int64_t b = 0; b < n_bufs; b++) {
    const uint8_t* buf = bufs[b];
    const int64_t buflen = lens[b];
    int64_t i = starts[b];
    while (i + 4 <= buflen && k < n) {
      uint32_t bs;
      std::memcpy(&bs, buf + i, 4);
      if (i + 4 + (int64_t)bs > buflen) break;
      const uint8_t* p = buf + i + 4;
      if (do_filter && !bam_rec_keep(p, tid, beg, end)) {
        i += 4 + bs;
        continue;
      }
      int32_t rid, pp, lseq, nrid, np_, tl;
      std::memcpy(&rid, p, 4);
      std::memcpy(&pp, p + 4, 4);
      const uint8_t lqn = p[8];
      const uint8_t mq = p[9];
      uint16_t ncig, fl;
      std::memcpy(&ncig, p + 12, 2);
      std::memcpy(&fl, p + 14, 2);
      std::memcpy(&lseq, p + 16, 4);
      std::memcpy(&nrid, p + 20, 4);
      std::memcpy(&np_, p + 24, 4);
      std::memcpy(&tl, p + 28, 4);
      refid[k] = rid; pos[k] = pp; mapq[k] = mq; flag[k] = fl;
      nrefid[k] = nrid; npos[k] = np_; tlen[k] = tl;

      const uint8_t* q = p + 32;
      std::memcpy(name_out + name_off[k], q, lqn - 1);
      name_off[k + 1] = name_off[k] + (lqn - 1);
      q += lqn;
      std::memcpy(cigar_out + cigar_off[k], q, 4LL * ncig);
      cigar_off[k + 1] = cigar_off[k] + ncig;
      q += 4LL * ncig;
      {
        uint8_t* dst = seq_out + seq_off[k];
        const int64_t half = (lseq + 1) / 2;
        for (int64_t x = 0; x < half; x++) {
          const uint8_t packed = q[x];
          dst[2 * x] = SEQ16[packed >> 4];
          if (2 * x + 1 < lseq) dst[2 * x + 1] = SEQ16[packed & 0xF];
        }
        seq_off[k + 1] = seq_off[k] + lseq;
        q += half;
      }
      std::memcpy(qual_out + qual_off[k], q, lseq);
      qual_off[k + 1] = qual_off[k] + lseq;
      q += lseq;
      const int64_t tag_len = (buf + i + 4 + bs) - q;
      if (tag_len > 0) std::memcpy(tag_out + tag_off[k], q, tag_len);
      tag_off[k + 1] = tag_off[k] + (tag_len > 0 ? tag_len : 0);

      i += 4 + bs;
      k++;
    }
  }
  return (int)(k == n ? 0 : -1);
}

// ---------------------------------------------------------------------------
// Fragment-evidence bank consumers (struct-of-arrays scoring hot loops).
//
// Behavioral parity targets (reference, studied not copied):
//   - getRefAltFromFrag / addDiploidLoglhood / computeSomaticSampleLoghood
//     (GenerateSVCandidates/SVScorer.cpp:679-801, 1143-1200)
//   - sample support summaries (SVScorer.cpp addConservativeSplitReadSupport /
//     addSpanningPairSupport / addConservativeSpanningPairSupport)
//
// Bank layout (row-major, n fragments):
//   read fields   (n, 2)          index r*2 + rd          rd: 0=read1
//   pair fields   (n, 2, 2)       index r*4 + al*2 + bp   al: 0=alt 1=ref
//   split fields  (n, 2, 2, 2)    index r*8 + al*4 + bp*2 + rd
//
// All float math is double-precision libm (std::log/std::exp/std::log1p),
// accumulated sequentially in the caller-provided row order, matching the
// scalar Python/math-module path bit for bit.

namespace {

constexpr int FB_ALT = 0, FB_REF = 1;

inline double fb_log_sum(double a, double b) {
  if (a < b) std::swap(a, b);
  return a + std::log1p(std::exp(b - a));
}

struct FbProbSet {
  double prob, comp, ln_prob, ln_comp;
  explicit FbProbSet(double p)
      : prob(p), comp(1.0 - p), ln_prob(std::log(p)), ln_comp(std::log(1.0 - p)) {}
};

// _get_spanning_pair_allele_lhood
inline double fb_pair_allele_lhood(const uint8_t* pair_sup, const double* pair_prob,
                                   int64_t r, int al) {
  double p = 0.0;
  if (pair_sup[r * 4 + al * 2 + 0]) p = pair_prob[r * 4 + al * 2 + 0];
  if (pair_sup[r * 4 + al * 2 + 1]) {
    const double p2 = pair_prob[r * 4 + al * 2 + 1];
    if (p2 > p) p = p2;
  }
  return p;
}

}  // namespace

extern "C" int mt_frag_lhood(
    int64_t n_sel, const int64_t* order,
    const uint8_t* r_scanned, const uint8_t* r_anch, const uint8_t* r_t2anch,
    const uint8_t* pair_sup, const double* pair_prob,
    const uint8_t* sp_eval, const uint8_t* sp_sup, const uint8_t* sp_t2,
    const double* sp_lnl,
    double spanning_weight, double semi_mapped_power,
    double ref_chim_prob, double alt_chim_prob,
    double ref_map_prob, double alt_map_prob,
    int32_t is_permissive,
    int32_t n_gt, const double* alt_fraction,
    double* loglhood) {
  const FbProbSet ref_chim(ref_chim_prob), alt_chim(alt_chim_prob);
  const FbProbSet ref_map(ref_map_prob), alt_map(alt_map_prob);
  const double NEG_INF = -std::numeric_limits<double>::infinity();
  for (int64_t s = 0; s < n_sel; s++) {
    const int64_t r = order[s];
    double frag_pair_ref = 0.0, frag_pair_alt = 0.0;
    double rs_ref[2] = {0.0, 0.0}, rs_alt[2] = {0.0, 0.0};
    bool r_eval[2] = {true, true};
    bool frag_evaluated = false;

    bool pair_usable;
    if (is_permissive) {
      pair_usable = (r_scanned[r * 2 + 0] && r_t2anch[r * 2 + 0]) ||
                    (r_scanned[r * 2 + 1] && r_t2anch[r * 2 + 1]);
    } else {
      pair_usable = (r_scanned[r * 2 + 0] && r_scanned[r * 2 + 1]) &&
                    (r_anch[r * 2 + 0] || r_anch[r * 2 + 1]);
    }
    bool any_span = false;
    for (int k = 0; k < 4; k++) any_span |= (pair_sup[r * 4 + k] != 0);
    if (pair_usable && any_span) {
      const uint8_t* anch = is_permissive ? r_t2anch : r_anch;
      const bool semi_mapped = !(anch[r * 2 + 0] && anch[r * 2 + 1]);
      double span_power = spanning_weight;
      const double ref_frag = fb_pair_allele_lhood(pair_sup, pair_prob, r, FB_REF);
      const double alt_frag = fb_pair_allele_lhood(pair_sup, pair_prob, r, FB_ALT);
      if (semi_mapped) {
        if (alt_frag > ref_frag)
          span_power *= semi_mapped_power;
        else
          span_power = 0.0;
      }
      frag_pair_ref += std::log(ref_chim.comp * ref_frag + alt_chim.prob) * span_power;
      frag_pair_alt += std::log(alt_chim.comp * alt_frag + ref_chim.prob) * span_power;
      frag_evaluated = true;
    }

    for (int rd = 0; rd < 2; rd++) {
      const int64_t base = r * 8;
      const uint8_t* supfield = is_permissive ? sp_t2 : sp_sup;
      const bool s0 = supfield[base + FB_ALT * 4 + 0 * 2 + rd] ||
                      supfield[base + FB_REF * 4 + 0 * 2 + rd];
      const bool s1 = supfield[base + FB_ALT * 4 + 1 * 2 + rd] ||
                      supfield[base + FB_REF * 4 + 1 * 2 + rd];
      if (!s0 && !s1) {
        r_eval[rd] = false;
        continue;
      }
      const bool ev_ok = sp_eval[base + FB_ALT * 4 + 0 * 2 + rd] &&
                         sp_eval[base + FB_ALT * 4 + 1 * 2 + rd] &&
                         sp_eval[base + FB_REF * 4 + 0 * 2 + rd] &&
                         sp_eval[base + FB_REF * 4 + 1 * 2 + rd];
      auto pick = [&](int al) -> double {
        const double l1 = sp_lnl[base + al * 4 + 0 * 2 + rd];
        const double l2 = sp_lnl[base + al * 4 + 1 * 2 + rd];
        bool use_bp1 = s0;
        if (s0 && s1) use_bp1 = l1 >= l2;
        return use_bp1 ? l1 : l2;
      };
      const double ref_align = pick(FB_REF);
      const double alt_align = pick(FB_ALT);
      if (!ev_ok) r_eval[rd] = false;
      const double ref_split = fb_log_sum(ref_map.ln_comp + ref_align, alt_map.ln_prob);
      const double alt_split = fb_log_sum(alt_map.ln_comp + alt_align, ref_map.ln_prob);
      const double pseudo = 0.5;
      if (ref_split < (alt_map.ln_prob + pseudo) && alt_split < (ref_map.ln_prob + pseudo))
        continue;
      rs_ref[rd] += ref_split;
      rs_alt[rd] += alt_split;
    }

    if (!(frag_evaluated || r_eval[0] || r_eval[1])) continue;
    double ref_lnl = frag_pair_ref;
    double alt_lnl = frag_pair_alt;
    if (r_eval[0]) {
      if (r_eval[1]) {
        ref_lnl += std::max(rs_ref[0], rs_ref[1]);
        alt_lnl += std::max(rs_alt[0], rs_alt[1]);
      } else {
        ref_lnl += rs_ref[0];
        alt_lnl += rs_alt[0];
      }
    } else if (r_eval[1]) {
      ref_lnl += rs_ref[1];
      alt_lnl += rs_alt[1];
    }
    for (int gt = 0; gt < n_gt; gt++) {
      const double f = alt_fraction[gt];
      const double ref_gt = (f < 1.0) ? ref_lnl + std::log(1.0 - f) : NEG_INF;
      const double alt_gt = (f > 0.0) ? alt_lnl + std::log(f) : NEG_INF;
      loglhood[gt] += fb_log_sum(ref_gt, alt_gt);
    }
  }
  return 0;
}

// _get_sample_split_read_lnlhood(is_forced=false): returns false when
// unsupported, else writes (ref_lnl, alt_lnl).
namespace {
inline bool fb_split_lnlhood(const uint8_t* sp_sup, const double* sp_lnl,
                             int64_t r, int rd, bool forced,
                             double* out_ref, double* out_alt) {
  const int64_t base = r * 8;
  const bool s0 = sp_sup[base + FB_ALT * 4 + 0 * 2 + rd] ||
                  sp_sup[base + FB_REF * 4 + 0 * 2 + rd];
  const bool s1 = sp_sup[base + FB_ALT * 4 + 1 * 2 + rd] ||
                  sp_sup[base + FB_REF * 4 + 1 * 2 + rd];
  if (!forced && !(s0 || s1)) return false;
  bool use_bp1 = s0;
  if (forced || (s0 == s1))
    use_bp1 = sp_lnl[base + FB_ALT * 4 + 0 * 2 + rd] >=
              sp_lnl[base + FB_ALT * 4 + 1 * 2 + rd];
  *out_alt = sp_lnl[base + FB_ALT * 4 + (use_bp1 ? 0 : 1) * 2 + rd];
  if (s0 && s1)
    use_bp1 = sp_lnl[base + FB_REF * 4 + 0 * 2 + rd] >=
              sp_lnl[base + FB_REF * 4 + 1 * 2 + rd];
  *out_ref = sp_lnl[base + FB_REF * 4 + (use_bp1 ? 0 : 1) * 2 + rd];
  return true;
}
}  // namespace

// Per-sample support summaries. out_counts layout (int64):
//   [al*6 + c] al: 0=alt 1=ref
//   c: 0 spanning_pair, 1 confident_spanning_pair,
//      2 confident_semi_mapped_spanning_pair, 3 confident_split_read,
//      4 confident_split_read_and_pair_ref_bp1 (ref only),
//      5 confident_split_read_and_pair_ref_bp2 (ref only)
// Returns -1 on the "zero spanning likelihood" invariant violation.
extern "C" int mt_frag_support(
    int64_t n,
    const uint8_t* r_scanned, const uint8_t* r_anch,
    const uint8_t* pair_sup, const double* pair_prob,
    const uint8_t* sp_sup, const double* sp_lnl,
    int64_t* out_counts) {
  for (int64_t r = 0; r < n; r++) {
    // _add_conservative_split_read_support for read1/read2
    for (int rd = 0; rd < 2; rd++) {
      double ref_lnl, alt_lnl;
      if (!fb_split_lnlhood(sp_sup, sp_lnl, r, rd, false, &ref_lnl, &alt_lnl))
        continue;
      if (alt_lnl > ref_lnl) {
        const double lower = std::exp(ref_lnl - alt_lnl);
        const double p = 1.0 / (lower + 1.0);
        if (p > 0.999) out_counts[FB_ALT * 6 + 3] += 1;
      } else {
        const double lower = std::exp(alt_lnl - ref_lnl);
        const double p = 1.0 / (lower + 1.0);
        if (p > 0.999) {
          out_counts[FB_REF * 6 + 3] += 1;
          if (sp_sup[r * 8 + FB_REF * 4 + 0 * 2 + rd]) out_counts[FB_REF * 6 + 4] += 1;
          if (sp_sup[r * 8 + FB_REF * 4 + 1 * 2 + rd]) out_counts[FB_REF * 6 + 5] += 1;
        }
      }
    }
    // _add_spanning_pair_support
    const bool alt_pair = pair_sup[r * 4 + FB_ALT * 2 + 0] || pair_sup[r * 4 + FB_ALT * 2 + 1];
    const bool ref_pair = pair_sup[r * 4 + FB_REF * 2 + 0] || pair_sup[r * 4 + FB_REF * 2 + 1];
    if (alt_pair) out_counts[FB_ALT * 6 + 0] += 1;
    if (ref_pair) out_counts[FB_REF * 6 + 0] += 1;
    // _add_conservative_spanning_pair_support
    if (!(alt_pair || ref_pair)) continue;
    const double alt = fb_pair_allele_lhood(pair_sup, pair_prob, r, FB_ALT);
    const double ref = fb_pair_allele_lhood(pair_sup, pair_prob, r, FB_REF);
    if (alt <= 0.0 && ref <= 0.0) return -1;
    const bool fully_mapped = (r_scanned[r * 2 + 0] && r_anch[r * 2 + 0]) &&
                              (r_scanned[r * 2 + 1] && r_anch[r * 2 + 1]);
    const double total = alt + ref;
    if (alt > ref) {
      if (alt / total > 0.9) {
        out_counts[FB_ALT * 6 + 2] += 1;
        if (fully_mapped) out_counts[FB_ALT * 6 + 1] += 1;
      }
    } else {
      if (ref / total > 0.9) {
        out_counts[FB_REF * 6 + 2] += 1;
        if (fully_mapped) {
          out_counts[FB_REF * 6 + 1] += 1;
          if (pair_sup[r * 4 + FB_REF * 2 + 0]) out_counts[FB_REF * 6 + 4] += 1;
          if (pair_sup[r * 4 + FB_REF * 2 + 1]) out_counts[FB_REF * 6 + 5] += 1;
        }
      }
    }
  }
  return 0;
}

// resolvePairSplitConflicts over the bank: clears all 4 pair-support
// slots of fragments whose forced split winner contradicts the pair
// winner (reference: SVScorer.cpp resolvePairSplitConflicts:476).
extern "C" int mt_frag_pair_split_conflicts(
    int64_t n,
    uint8_t* pair_sup, double* pair_prob,
    const uint8_t* sp_sup, const double* sp_lnl,
    int32_t find_alt_pair_conflict) {
  for (int64_t r = 0; r < n; r++) {
    bool any_span = false;
    for (int k = 0; k < 4; k++) any_span |= (pair_sup[r * 4 + k] != 0);
    if (!any_span) continue;
    const double ref_pair = fb_pair_allele_lhood(pair_sup, pair_prob, r, FB_REF);
    const double alt_pair = fb_pair_allele_lhood(pair_sup, pair_prob, r, FB_ALT);
    const bool is_ref_pair = ref_pair > alt_pair;
    const bool is_alt_pair = alt_pair > ref_pair;
    if (is_alt_pair && !find_alt_pair_conflict) continue;
    bool clear = false;
    for (int rd = 0; rd < 2; rd++) {
      double ref_lnl, alt_lnl;
      fb_split_lnlhood(sp_sup, sp_lnl, r, rd, true, &ref_lnl, &alt_lnl);
      if (alt_lnl > ref_lnl && is_ref_pair) clear = true;
      if (ref_lnl > alt_lnl && is_alt_pair) clear = true;
    }
    if (clear) {
      for (int k = 0; k < 4; k++) {
        pair_sup[r * 4 + k] = 0;
        pair_prob[r * 4 + k] = 0.0;
      }
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Score-only batched jump alignment (host winner-selection fast path).
//
// Same integer recurrences as mt_align_jump (reference, studied not
// copied: alignment/GlobalJumpAlignerImpl.hpp) without pointer-byte
// storage or backtrace: the refiner scores every contig x (ref1, ref2)
// pair cheaply, then runs the full traceback aligner only on the
// descending-score winners. Max scores are tie-order independent, so
// selection is bit-identical to aligning everything.

extern "C" int mt_align_jump_score_batch(
    int64_t n,
    const uint8_t* q_blob, const int64_t* q_off,
    const uint8_t* r1_blob, const int64_t* r1_off,
    const uint8_t* r2_blob, const int64_t* r2_off,
    int32_t s_match, int32_t s_mismatch, int32_t s_open, int32_t s_extend,
    int32_t s_off_edge, int32_t jump_score,
    int32_t* out_scores) {
  std::vector<int32_t> buf;
  for (int64_t b = 0; b < n; b++) {
    const char* query = (const char*)(q_blob + q_off[b]);
    const int32_t nq = (int32_t)(q_off[b + 1] - q_off[b]);
    const char* ref1 = (const char*)(r1_blob + r1_off[b]);
    const int32_t nr1 = (int32_t)(r1_off[b + 1] - r1_off[b]);
    const char* ref2 = (const char*)(r2_blob + r2_off[b]);
    const int32_t nr2 = (int32_t)(r2_off[b + 1] - r2_off[b]);
    if (nq <= 0 || nr1 <= 0 || nr2 <= 0) return -2;
    buf.assign((size_t)8 * (nq + 1), 0);
    int32_t* m0 = buf.data();
    int32_t* d0 = m0 + (nq + 1);
    int32_t* i0 = d0 + (nq + 1);
    int32_t* j0 = i0 + (nq + 1);
    int32_t* m1 = j0 + (nq + 1);
    int32_t* d1 = m1 + (nq + 1);
    int32_t* i1 = d1 + (nq + 1);
    int32_t* j1 = i1 + (nq + 1);
    int32_t *pm = m0, *pd = d0, *pi = i0, *pj = j0;
    int32_t *cm = m1, *cd = d1, *ci = i1, *cj = j1;
    const int32_t jmp = jump_score;
    for (int q = 0; q <= nq; q++) {
      cm[q] = q * s_off_edge;
      cd[q] = BAD; ci[q] = BAD; cj[q] = BAD;
    }
    Btrace bt;
    for (int r = 0; r < nr1; r++) {
      std::swap(cm, pm); std::swap(cd, pd); std::swap(ci, pi); std::swap(cj, pj);
      cm[0] = 0; cd[0] = BAD; ci[0] = BAD; cj[0] = BAD;
      const char rc = ref1[r];
      // the in-column insert chain rides in scalars (up_*): reading it
      // back through cm/ci let GCC 12's -O3 loop vectorizer break the
      // q -> q+1 dependence and return wrong maxima
      int32_t up_m = 0, up_i = BAD;
      for (int q = 0; q < nq; q++) {
        int32_t vm, vd, vi, vj;
        best3(vm, pm[q], pd[q], pi[q]);
        vm += (query[q] == rc ? s_match : s_mismatch);
        best3(vd, pm[q + 1] + s_open, pd[q + 1], pi[q + 1]);
        vd += s_extend;
        if (q == 0) vd = BAD;
        best3(vi, up_m + s_open, BAD, up_i);
        vi += s_extend;
        if (q == 0) vi = BAD;
        best4(vj, vm + jmp, BAD, vi + jmp, pj[q + 1]);
        cm[q + 1] = vm; cd[q + 1] = vd; ci[q + 1] = vi; cj[q + 1] = vj;
        up_m = vm; up_i = vi;
      }
      upd_btrace(bt, cm[nq], r + 1, nq);
    }
    for (int q = 0; q < nq; q++) {
      upd_btrace(bt, cm[q] + (nq - q) * s_off_edge, nr1, q);
    }
    for (int q = 0; q <= nq; q++) {
      cm[q] = q * s_off_edge;
      cd[q] = BAD; ci[q] = BAD;
    }
    for (int r = 0; r < nr2; r++) {
      std::swap(cm, pm); std::swap(cd, pd); std::swap(ci, pi); std::swap(cj, pj);
      cm[0] = 0; cd[0] = BAD; ci[0] = BAD; cj[0] = BAD;
      const char rc = ref2[r];
      int32_t up_m = 0, up_i = BAD, up_j = BAD;
      for (int q = 0; q < nq; q++) {
        int32_t vm, vd, vi, vj;
        best4(vm, pm[q], pd[q], pi[q], pj[q]);
        vm += (query[q] == rc ? s_match : s_mismatch);
        best3(vd, pm[q + 1] + s_open, pd[q + 1], pi[q + 1]);
        vd += s_extend;
        best4(vi, up_m + s_open, BAD, up_i, up_j);
        vi += s_extend;
        vj = pj[q + 1];
        cm[q + 1] = vm; cd[q + 1] = vd; ci[q + 1] = vi; cj[q + 1] = vj;
        up_m = vm; up_i = vi; up_j = vj;
      }
      upd_btrace(bt, cm[nq], nr1 + r + 1, nq);
    }
    for (int q = 0; q < nq; q++) {
      upd_btrace(bt, cm[q] + (nq - q) * s_off_edge, nr1 + nr2, q);
    }
    out_scores[b] = bt.max;
  }
  return 0;
}

// Strided rolling-denoise fan: N consecutive fixed-step cleanRegion
// fires in one call (reference: SVLocusSetFinderActiveRegionManager's
// stage_manager crossings at MIN_DENOISE_REGION_SIZE boundaries) —
// identical region sequence to N individual mt_graph_clean_region
// calls, without N ctypes crossings.
extern "C" int mt_graph_clean_stride(void* h, int32_t tid, int32_t start,
                                     int32_t step, int64_t count) {
  for (int64_t k = 0; k < count; k++) {
    const int rc = mt_graph_clean_region(h, tid, start + (int32_t)(k * step),
                                         start + (int32_t)((k + 1) * step));
    if (rc != 0) return rc;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Threaded BGZF block inflation via libdeflate.
//
// BGZF blocks are independent raw-deflate members with the uncompressed
// size recorded in the trailing ISIZE word, which is exactly the shape
// libdeflate's deflate_decompress wants (known output size, no stream
// state). Blocks fan out over a small thread pool. Replaces the Python
// zlib path for large region reads (reference analogue: htslib's
// multi-threaded bgzf reader, bgzf.c + thread pool).

#include <thread>
#include <atomic>

#ifdef MANTA_ZLIB
// Hosts without libdeflate build with -DMANTA_ZLIB: zlib stand-ins for
// the libdeflate calls used here. The raw-deflate streams are
// interchangeable; zlib's compressed bytes differ from libdeflate's,
// the decompressed content does not.
#include <zlib.h>
struct libdeflate_decompressor { z_stream zs; };
static libdeflate_decompressor* libdeflate_alloc_decompressor() {
  auto* d = new libdeflate_decompressor();
  if (inflateInit2(&d->zs, -15) != Z_OK) { delete d; return nullptr; }
  return d;
}
static void libdeflate_free_decompressor(libdeflate_decompressor* d) {
  inflateEnd(&d->zs);
  delete d;
}
static int libdeflate_deflate_decompress(libdeflate_decompressor* d,
                                         const void* in, size_t in_nbytes,
                                         void* out, size_t out_nbytes_avail,
                                         size_t* actual_out_nbytes_ret) {
  if (inflateReset(&d->zs) != Z_OK) return 1;
  d->zs.next_in = (Bytef*)in;
  d->zs.avail_in = (uInt)in_nbytes;
  d->zs.next_out = (Bytef*)out;
  d->zs.avail_out = (uInt)out_nbytes_avail;
  const int rc = inflate(&d->zs, Z_FINISH);
  *actual_out_nbytes_ret = out_nbytes_avail - d->zs.avail_out;
  return rc == Z_STREAM_END ? 0 : 1;
}
#else
extern "C" {
// minimal libdeflate ABI (linked against libdeflate.so.0)
struct libdeflate_decompressor;
struct libdeflate_decompressor* libdeflate_alloc_decompressor(void);
void libdeflate_free_decompressor(struct libdeflate_decompressor*);
int libdeflate_deflate_decompress(struct libdeflate_decompressor*,
                                  const void* in, size_t in_nbytes,
                                  void* out, size_t out_nbytes_avail,
                                  size_t* actual_out_nbytes_ret);
}
#endif

extern "C" int mt_bgzf_inflate_batch(
    int64_t n_blocks,
    const uint8_t* file_data,
    const int64_t* comp_off, const int32_t* comp_len,
    uint8_t* out_blob, const int64_t* out_off,
    int32_t n_threads) {
  std::atomic<int64_t> next(0);
  std::atomic<int> err(0);
  auto work = [&]() {
    struct libdeflate_decompressor* d = libdeflate_alloc_decompressor();
    if (!d) { err.store(-3); return; }
    for (;;) {
      const int64_t b = next.fetch_add(1);
      if (b >= n_blocks || err.load() != 0) break;
      const size_t want = (size_t)(out_off[b + 1] - out_off[b]);
      if (want == 0) continue;
      size_t got = 0;
      const int rc = libdeflate_deflate_decompress(
          d, file_data + comp_off[b], (size_t)comp_len[b],
          out_blob + out_off[b], want, &got);
      if (rc != 0 || got != want) err.store(-1);
    }
    libdeflate_free_decompressor(d);
  };
  // never spawn more threads than blocks: small prefetches on
  // many-core hosts would otherwise churn mostly-idle threads
  const int nt = (int)std::min<int64_t>(n_threads, n_blocks);
  if (nt <= 1 || n_blocks < 4) {
    work();
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < nt; t++) ts.emplace_back(work);
    for (auto& t : ts) t.join();
  }
  return err.load();
}

// Walk the BGZF block chain covering [cstart, cend] (compressed block
// offsets, cend inclusive as in a BAI virtual-offset range), emitting
// one row per block: compressed offset, payload offset, payload
// length, uncompressed size. Returns the block count, or -1 on a
// malformed header / count overflow. Replaces the per-fetch Python
// chain walk in io/bgzf.py read_range_arr (~25 us of Python per block,
// the hottest line of the single-core pipeline profile) with one
// native call; header semantics mirror _parse_block_header on
// well-formed BGZF (strict 1f 8b 08 04 magic, BC subfield scan with
// last-match-wins, payload = [extra end, block end - 8)) — but this
// scan bounds-checks each subfield header against the extra-field end
// (`p + 4 <= xend`, BC payload `p + 6 <= xend`) where the Python
// parser reads subfield headers unguarded, so on a malformed/truncated
// extra field the native walk returns -1 (falling back to the Python
// path) while Python may parse differently or raise. The stop rule
// mirrors the Python loop: include the block at coff == cend, or stop
// before a block that would start past cend.
extern "C" int64_t mt_bgzf_index_range(
    const uint8_t* data, int64_t n, int64_t cstart, int64_t cend,
    int64_t max_blocks, int64_t* coffs, int64_t* pay_offs,
    int32_t* pay_lens, int32_t* isizes) {
  int64_t count = 0;
  int64_t coff = cstart;
  while (coff < n) {
    if (coff + 18 > n) return -1;
    if (data[coff] != 0x1f || data[coff + 1] != 0x8b ||
        data[coff + 2] != 0x08 || data[coff + 3] != 0x04)
      return -1;
    const int64_t xlen =
        data[coff + 10] | ((int64_t)data[coff + 11] << 8);
    const int64_t xend = coff + 12 + xlen;
    if (xend > n) return -1;
    int64_t p = coff + 12;
    int64_t bsize = -1;
    while (p + 4 <= xend) {
      const uint8_t si1 = data[p], si2 = data[p + 1];
      const int64_t slen = data[p + 2] | ((int64_t)data[p + 3] << 8);
      if (si1 == 0x42 && si2 == 0x43 && slen == 2 && p + 6 <= xend)
        bsize = (data[p + 4] | ((int64_t)data[p + 5] << 8)) + 1;
      p += 4 + slen;
    }
    if (bsize < 28 || coff + bsize > n) return -1;
    if (count >= max_blocks) return -1;
    coffs[count] = coff;
    pay_offs[count] = xend;
    pay_lens[count] = (int32_t)((coff + bsize - 8) - xend);
    const int64_t iso = coff + bsize - 4;
    isizes[count] = (int32_t)((uint32_t)data[iso] |
                              ((uint32_t)data[iso + 1] << 8) |
                              ((uint32_t)data[iso + 2] << 16) |
                              ((uint32_t)data[iso + 3] << 24));
    count++;
    const int64_t nxt = coff + bsize;
    if (coff == cend || nxt > cend) break;
    coff = nxt;
  }
  return count;
}

// ---------------------------------------------------------------------------
// Ragged row gather: copy the payload runs of selected rows into a dense
// output blob. Replaces ReadBatch.subset's per-run Python copy loop
// (io/bam.py) with one memcpy pass; offsets are element counts, elem_size
// converts to bytes. out_off must already hold the destination offsets
// (exclusive cumsum of the selected lengths, in elements).
extern "C" int mt_gather_ragged(
    int64_t n_idx, const int64_t* idx,
    const int64_t* off, const uint8_t* blob, int32_t elem_size,
    const int64_t* out_off, uint8_t* out_blob) {
  for (int64_t i = 0; i < n_idx; i++) {
    const int64_t r = idx[i];
    const int64_t nb = (off[r + 1] - off[r]) * elem_size;
    if (nb > 0)
      memcpy(out_blob + out_off[i] * elem_size,
             blob + off[r] * elem_size, (size_t)nb);
  }
  return 0;
}

// Per-read Z-tag equality mask: out[r] = 1 iff read r's (t0,t1) tag is
// a Z string equal to want; want_len == 0 also matches an absent tag.
// Replaces the per-read Python tag walk in read-group routing
// (core/fragstats.py batch_rg_keep_mask).
extern "C" int mt_tag_zmatch(
    int64_t n, const int64_t* tag_off, const uint8_t* tags,
    char t0, char t1, const uint8_t* want, int32_t want_len,
    uint8_t* out) {
  for (int64_t r = 0; r < n; r++) {
    uint8_t ty;
    const int64_t len = tag_off[r + 1] - tag_off[r];
    const uint8_t* v = find_tag_value(tags + tag_off[r], len, t0, t1, &ty);
    if (v == nullptr) { out[r] = (uint8_t)(want_len == 0); continue; }
    if (ty != 'Z') { out[r] = 0; continue; }
    const uint8_t* end = tags + tag_off[r + 1];
    int32_t m = 0;
    const uint8_t* p = v;
    while (p < end && *p != 0 && m < want_len && *p == want[m]) { p++; m++; }
    out[r] = (uint8_t)(m == want_len && p < end && *p == 0);
  }
  return 0;
}

// Light depth-scan column extraction: (pos, flag, l_seq) of records
// whose START position lies in [beg, end) on tid. Start-position
// windowing (not overlap) lets the chrom-depth estimator fetch
// segments in incremental chunks with exact dedup across chunk
// boundaries, and skipping the cigar/seq/qual/name/tag copies makes
// the walk ~memory-bandwidth-bound (reference:
// GetChromDepth/ReadChromDepthUtil.cpp streams records and reads only
// pos/flags/read_size). Returns the record count written.
extern "C" int64_t mt_bam_depth_cols(
    int64_t n_bufs, const uint8_t* const* bufs, const int64_t* lens,
    int32_t tid, int64_t beg, int64_t end,
    int32_t* pos_out, uint16_t* flag_out, int32_t* lseq_out) {
  int64_t n = 0;
  for (int64_t b = 0; b < n_bufs; b++) {
    const uint8_t* buf = bufs[b];
    const int64_t buflen = lens[b];
    int64_t i = 0;
    while (i + 4 <= buflen) {
      uint32_t bs;
      std::memcpy(&bs, buf + i, 4);
      if (i + 4 + (int64_t)bs > buflen) break;
      const uint8_t* p = buf + i + 4;
      int32_t rid, pp;
      std::memcpy(&rid, p, 4);
      std::memcpy(&pp, p + 4, 4);
      if (rid == tid && (int64_t)pp >= beg && (int64_t)pp < end) {
        uint16_t fl;
        int32_t lseq;
        std::memcpy(&fl, p + 14, 2);
        std::memcpy(&lseq, p + 16, 4);
        pos_out[n] = pp;
        flag_out[n] = fl;
        lseq_out[n] = lseq;
        n++;
      }
      i += 4 + bs;
    }
  }
  return n;
}

// ---------------------------------------------------------------------------
// Threaded BGZF block deflation via libdeflate (the write-side mirror
// of mt_bgzf_inflate_batch). Each input slice (<= 65280 bytes) becomes
// one complete BGZF block: 18-byte gzip header with the BC/BSIZE extra
// field, raw deflate payload, crc32, isize. Blocks are written at
// fixed stride out_stride in out_blob with their total sizes in
// out_len; the caller compacts. Powers the external-merge sorted BAM
// writer (io/bamwriter.py) and any bulk .gz output. Returns 0, or -1
// if a block failed to compress into its slot.
#ifdef MANTA_ZLIB
struct libdeflate_compressor { z_stream zs; };
static libdeflate_compressor* libdeflate_alloc_compressor(int level) {
  auto* c = new libdeflate_compressor();
  if (deflateInit2(&c->zs, std::min(level, 9), Z_DEFLATED, -15, 8,
                   Z_DEFAULT_STRATEGY) != Z_OK) {
    delete c;
    return nullptr;
  }
  return c;
}
static void libdeflate_free_compressor(libdeflate_compressor* c) {
  deflateEnd(&c->zs);
  delete c;
}
static size_t libdeflate_deflate_compress(libdeflate_compressor* c,
                                          const void* in, size_t in_nbytes,
                                          void* out, size_t out_nbytes_avail) {
  if (deflateReset(&c->zs) != Z_OK) return 0;
  c->zs.next_in = (Bytef*)in;
  c->zs.avail_in = (uInt)in_nbytes;
  c->zs.next_out = (Bytef*)out;
  c->zs.avail_out = (uInt)out_nbytes_avail;
  const int rc = deflate(&c->zs, Z_FINISH);
  return rc == Z_STREAM_END ? out_nbytes_avail - c->zs.avail_out : 0;
}
static uint32_t libdeflate_crc32(uint32_t crc, const void* buf, size_t len) {
  return (uint32_t)crc32(crc, (const Bytef*)buf, (uInt)len);
}
#else
extern "C" {
struct libdeflate_compressor;
struct libdeflate_compressor* libdeflate_alloc_compressor(int level);
void libdeflate_free_compressor(struct libdeflate_compressor*);
size_t libdeflate_deflate_compress(struct libdeflate_compressor*,
                                   const void* in, size_t in_nbytes,
                                   void* out, size_t out_nbytes_avail);
uint32_t libdeflate_crc32(uint32_t crc, const void* buf, size_t len);
}
#endif

extern "C" int mt_bgzf_deflate_batch(
    int64_t n_blocks, const uint8_t* data, const int64_t* off,
    int32_t level, uint8_t* out_blob, int64_t out_stride,
    int32_t* out_len, int32_t n_threads) {
  std::atomic<int64_t> next(0);
  std::atomic<int> err(0);
  auto work = [&]() {
    struct libdeflate_compressor* c = libdeflate_alloc_compressor(level);
    if (!c) { err.store(-3); return; }
    for (;;) {
      const int64_t b = next.fetch_add(1);
      if (b >= n_blocks || err.load() != 0) break;
      const uint8_t* in = data + off[b];
      const size_t in_n = (size_t)(off[b + 1] - off[b]);
      uint8_t* o = out_blob + b * out_stride;
      const size_t avail = (size_t)out_stride - 26;
      const size_t cn = libdeflate_deflate_compress(c, in, in_n,
                                                    o + 18, avail);
      if (cn == 0 || in_n > 65280) { err.store(-1); break; }
      const uint32_t bsize = (uint32_t)(cn + 25);  // total-1
      static const uint8_t hdr[16] = {
          0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0, 0, 0xff, 6, 0,
          'B', 'C', 2, 0};
      memcpy(o, hdr, 16);
      o[16] = (uint8_t)(bsize & 0xff);
      o[17] = (uint8_t)(bsize >> 8);
      const uint32_t crc = libdeflate_crc32(0, in, in_n);
      uint8_t* tr = o + 18 + cn;
      memcpy(tr, &crc, 4);
      const uint32_t isz = (uint32_t)in_n;
      memcpy(tr + 4, &isz, 4);
      out_len[b] = (int32_t)(cn + 26);
    }
    libdeflate_free_compressor(c);
  };
  const int nt = (int)std::min<int64_t>(n_threads, n_blocks);
  if (nt <= 1 || n_blocks < 4) {
    work();
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < nt; t++) ts.emplace_back(work);
    for (auto& t : ts) t.join();
  }
  return err.load();
}
