// Score-only two-reference jump Smith-Waterman-Gotoh DP on an NVIDIA
// Hopper GPU, called from JAX through the XLA foreign function
// interface (align/cuda_jumpscore.py builds and registers it).
//
// Same integer recurrences as the native host scorer
// (manta_core.cpp mt_align_jump_score_batch), so scores are bit-exact:
// the max over the per-column end cells and the off-edge exits of both
// reference segments.
//
// Layout: one job (query, ref1, ref2) per block of one warp. Each lane
// owns a stripe of K consecutive query rows and keeps their M/D/I/J
// state of the previous column in registers. The lanes walk the
// concatenated ref1|ref2 columns as an anti-diagonal wavefront: lane t
// scores column c at step c + t, so the value above its stripe (same
// column) and the diagonal one (previous column) arrive from lane t-1
// by __shfl_up_sync, and the in-column insert chain flows down the
// stripe and from lane to lane with no scan. Queries taller than one
// warp stripe (32 * K rows) run as horizontal bands; the last row of a
// band is handed to the next band through a global scratch buffer.
//
// Reference semantics (studied not copied):
// alignment/GlobalJumpAlignerImpl.hpp.

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int32_t kBad = -10000;      // manta_core.cpp BAD
constexpr int32_t kNeg = -(1 << 28);  // below any reachable score
constexpr unsigned kFull = 0xffffffffu;

struct Scores {
  int32_t match, mismatch, open, extend, off_edge, jump;
};

__device__ __forceinline__ int32_t max3(int32_t a, int32_t b, int32_t c) {
  return max(max(a, b), c);
}

template <int K>
__global__ void __launch_bounds__(32) jump_score_kernel(
    const int32_t* __restrict__ query, const int32_t* __restrict__ query_len,
    const int32_t* __restrict__ ref1, const int32_t* __restrict__ ref1_len,
    const int32_t* __restrict__ ref2, const int32_t* __restrict__ ref2_len,
    int nq_pad, int nr1_pad, int nr2_pad, Scores s,
    int32_t* __restrict__ out, int4* __restrict__ bounds) {
  constexpr int H = 32 * K;  // rows per band
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int nq = query_len[b];
  const int nr1 = ref1_len[b];
  const int ncols = nr1 + ref2_len[b];
  const int ncols_pad = nr1_pad + nr2_pad;
  const int32_t* q = query + (size_t)b * nq_pad;
  const int32_t* r1 = ref1 + (size_t)b * nr1_pad;
  const int32_t* r2 = ref2 + (size_t)b * nr2_pad;
  int32_t best = kNeg;
  const int n_bands = (nq + H - 1) / H;

  for (int band = 0; band < n_bands; ++band) {
    // this lane's rows are r0+1 .. r0+K (row 0 is the empty prefix)
    const int r0 = band * H + lane * K;
    const int4* band_in = bounds + ((size_t)b * 2 + (band & 1)) * ncols_pad;
    int4* band_out = bounds + ((size_t)b * 2 + ((band + 1) & 1)) * ncols_pad;
    int32_t qc[K], pm[K], pd[K], pi[K], pj[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int row = r0 + 1 + k;
      qc[k] = row <= nq ? q[row - 1] : -1;
      pm[k] = row * s.off_edge;
      pd[k] = kBad;
      pi[k] = kBad;
      pj[k] = kBad;
    }
    // row r0 in the current column (u*) and the previous one (d*)
    int32_t um = 0, ud = kBad, ui = kBad, uj = kBad;
    // this lane's last row in the column it scored last
    int32_t om = 0, od = kBad, oi = kBad, oj = kBad;
    for (int step = 0; step < ncols + 31; ++step) {
      const int c = step - lane;
      int32_t rm = __shfl_up_sync(kFull, om, 1);
      int32_t rd = __shfl_up_sync(kFull, od, 1);
      int32_t ri = __shfl_up_sync(kFull, oi, 1);
      int32_t rj = __shfl_up_sync(kFull, oj, 1);
      if (lane == 0) {
        if (band == 0) {
          rm = 0; rd = kBad; ri = kBad; rj = kBad;
        } else if (c < ncols) {
          const int4 v = band_in[c];
          rm = v.x; rd = v.y; ri = v.z; rj = v.w;
        }
      }
      int32_t dm = um, dd = ud, di = ui, dj = uj;
      um = rm; ud = rd; ui = ri; uj = rj;
      if (c < 0 || c >= ncols) continue;
      const bool is_ref1 = c < nr1;
      if (c == 0 || c == nr1) {
        // the column before each reference segment: off-edge entry
        // scores, with J carried over from ref1's last column
        dm = r0 * s.off_edge; dd = kBad; di = kBad;
        if (c == 0) dj = kBad;
      }
      if (c == nr1) {
        // off-edge exits after ref1's last column, then restart the
        // state for ref2 (J carries over)
        if (band == 0 && lane == 0) best = max(best, nq * s.off_edge);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int row = r0 + 1 + k;
          if (row < nq) best = max(best, pm[k] + (nq - row) * s.off_edge);
          pm[k] = row * s.off_edge;
          pd[k] = kBad;
          pi[k] = kBad;
        }
      }
      const int32_t rc = is_ref1 ? r1[c] : r2[c - nr1];
      int32_t up_m = um, up_i = ui, up_j = uj;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int row = r0 + 1 + k;
        const int32_t sub = qc[k] == rc ? s.match : s.mismatch;
        int32_t vm, vd, vi, vj;
        vd = max3(pm[k] + s.open, pd[k], pi[k]) + s.extend;
        if (is_ref1) {
          vm = max3(dm, dd, di) + sub;
          vi = max(max(up_m + s.open, kBad), up_i) + s.extend;
          if (row == 1) { vd = kBad; vi = kBad; }
          vj = max(max(vm + s.jump, kBad), max(vi + s.jump, pj[k]));
        } else {
          vm = max(max3(dm, dd, di), dj) + sub;
          vi = max(max3(up_m + s.open, kBad, up_i), up_j) + s.extend;
          vj = pj[k];
        }
        dm = pm[k]; dd = pd[k]; di = pi[k]; dj = pj[k];
        pm[k] = vm; pd[k] = vd; pi[k] = vi; pj[k] = vj;
        up_m = vm; up_i = vi; up_j = vj;
        if (row == nq) best = max(best, vm);
      }
      om = pm[K - 1]; od = pd[K - 1]; oi = pi[K - 1]; oj = pj[K - 1];
      if (lane == 31 && band + 1 < n_bands) band_out[c] = make_int4(om, od, oi, oj);
    }
    // off-edge exits after ref2's last column
    if (band == 0 && lane == 0) best = max(best, nq * s.off_edge);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int row = r0 + 1 + k;
      if (row < nq) best = max(best, pm[k] + (nq - row) * s.off_edge);
    }
    __syncwarp();  // band_out visible to lane 0 of the next band
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    best = max(best, __shfl_down_sync(kFull, best, off));
  if (lane == 0) out[b] = best;
}

ffi::Error JumpScoreImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> query,
                         ffi::Buffer<ffi::S32> query_len,
                         ffi::Buffer<ffi::S32> ref1,
                         ffi::Buffer<ffi::S32> ref1_len,
                         ffi::Buffer<ffi::S32> ref2,
                         ffi::Buffer<ffi::S32> ref2_len, int32_t match,
                         int32_t mismatch, int32_t open, int32_t extend,
                         int32_t off_edge, int32_t jump,
                         int32_t rows_per_lane,
                         ffi::ResultBuffer<ffi::S32> out,
                         ffi::ResultBuffer<ffi::S32> bounds) {
  const auto qd = query.dimensions();
  if (qd.size() != 2 || ref1.dimensions().size() != 2 ||
      ref2.dimensions().size() != 2)
    return ffi::Error::InvalidArgument("jump_score: rank-2 sequences expected");
  const int64_t B = qd[0], nq_pad = qd[1];
  const int64_t nr1_pad = ref1.dimensions()[1];
  const int64_t nr2_pad = ref2.dimensions()[1];
  const int64_t band_rows = 32 * (int64_t)rows_per_lane;
  if (nq_pad > band_rows &&
      bounds->element_count() < (size_t)(B * 2 * (nr1_pad + nr2_pad) * 4))
    return ffi::Error::InvalidArgument("jump_score: band scratch too small");
  if (B == 0) return ffi::Error::Success();
  const Scores s{match, mismatch, open, extend, off_edge, jump};
  int4* scratch = reinterpret_cast<int4*>(bounds->typed_data());
  const dim3 grid((unsigned)B), block(32);
#define MANTA_LAUNCH(KK)                                                  \
  jump_score_kernel<KK><<<grid, block, 0, stream>>>(                      \
      query.typed_data(), query_len.typed_data(), ref1.typed_data(),      \
      ref1_len.typed_data(), ref2.typed_data(), ref2_len.typed_data(),    \
      (int)nq_pad, (int)nr1_pad, (int)nr2_pad, s, out->typed_data(),      \
      scratch)
  switch (rows_per_lane) {
    case 4: MANTA_LAUNCH(4); break;
    case 8: MANTA_LAUNCH(8); break;
    case 16: MANTA_LAUNCH(16); break;
    default:
      return ffi::Error::InvalidArgument("jump_score: rows_per_lane not 4/8/16");
  }
#undef MANTA_LAUNCH
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(MantaJumpScore, JumpScoreImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()  // query
                                  .Arg<ffi::Buffer<ffi::S32>>()  // query_len
                                  .Arg<ffi::Buffer<ffi::S32>>()  // ref1
                                  .Arg<ffi::Buffer<ffi::S32>>()  // ref1_len
                                  .Arg<ffi::Buffer<ffi::S32>>()  // ref2
                                  .Arg<ffi::Buffer<ffi::S32>>()  // ref2_len
                                  .Attr<int32_t>("match")
                                  .Attr<int32_t>("mismatch")
                                  .Attr<int32_t>("open")
                                  .Attr<int32_t>("extend")
                                  .Attr<int32_t>("off_edge")
                                  .Attr<int32_t>("jump")
                                  .Attr<int32_t>("rows_per_lane")
                                  .Ret<ffi::Buffer<ffi::S32>>()   // scores
                                  .Ret<ffi::Buffer<ffi::S32>>()); // band scratch
