// Candidate distances by id: the query engine's Step-3 epilogue with the
// coordinate gather inside the kernel.
//
// Replaces l2_distance_gathered_pallas
// (src/repro/kernels/l2_distance/kernel.py:66) together with the gathers
// and the mask the reference leaves to XLA around it
// (src/repro/core/query.py:337-343). For query q and candidate slot s with
// id = buf[q, s]:
//   d2[q, s] = +inf                                        if id == INVALID
//              max(xn2[id] - 2 * <db[id, :], qv[q, :]> + qn2[q], 0)  otherwise
// with the epilogue in that op order (__fmul_rn/__fsub_rn/__fadd_rn keep
// nvcc from contracting it into an FMA).
//
// What bounds it on the H100: bytes. Each valid slot reads one db row of D
// floats (512 B at D = 128) and its norm for 2 * D flops; the ids and the
// output are 8 B a slot. At the SIFT1M configuration (Q = 256, sbuf = 64) a
// radius reads at most 8.4 MB of rows; the bound counts the valid slots of
// this run's buffer.
//
// Design: a block serves one query and 32 slots, a warp 4 consecutive
// slots. Each lane loads the 4 ids (a broadcast), then for each float4 chunk
// of D it issues the 4 rows' loads (lane k reads float4 k of each row, a
// 512 B coalesced read per row at D = 128) before it multiplies any, so 4
// random rows are in flight per warp; an INVALID slot loads nothing. The
// query's float4 is read once per chunk (an L1 hit after the first warp) and
// serves the 4 rows. Lane u fetches slot u's norm before the products, so
// its latency hides under them. Each dot is a per-lane FMA chain over
// chunks k = lane, lane + 32, ... and a xor-butterfly across the warp: the
// same instruction sequence for every slot, whatever its position, the
// buffer's width or Q, so the fused and external plans, and a lone query
// and its row in a batch, get bit-identical distances. D % 4 != 0 or
// unaligned rows take the scalar path (lane k reads floats k, k + 32, ...),
// D > 128 loops over chunks (GIST's D = 960 is 8 chunks a lane). The
// [Q, sbuf, D] coordinates tensor of the unfused epilogue never exists.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 4;  // candidate rows a warp keeps in flight
constexpr int32_t kInvalid = 0x7FFFFFFF;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
l2_by_id_kernel(const float* __restrict__ qv, const int32_t* __restrict__ buf,
                const float* __restrict__ db, const float* __restrict__ xn2,
                const float* __restrict__ qn2, float* __restrict__ out, int sbuf,
                int ld, int d, int vec4) {
  const int qi = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int32_t* ids = buf + (size_t)qi * ld;
  const float* q = qv + (size_t)qi * d;
  const float qn = __ldg(qn2 + qi);
  const int stride = gridDim.y * kWarps * kRows;
  for (int s0 = (blockIdx.y * kWarps + warp) * kRows; s0 < sbuf; s0 += stride) {
    int id[kRows];
    float xn = 0.f;  // lane u < kRows: slot s0 + u's norm
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      id[u] = s0 + u < sbuf ? __ldg(ids + s0 + u) : kInvalid;
      if (lane == u && id[u] != kInvalid) xn = __ldg(xn2 + id[u]);
    }
    float dot[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) dot[u] = 0.f;
    if (vec4) {
      const int nv = d >> 2;
      const float4* q4p = reinterpret_cast<const float4*>(q);
      for (int k = lane; k < nv; k += 32) {
        const float4 q4 = __ldg(q4p + k);
        float4 c4[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u)
          c4[u] = id[u] != kInvalid
                      ? __ldg(reinterpret_cast<const float4*>(db + (size_t)id[u] * d) + k)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          dot[u] = fmaf(c4[u].x, q4.x, dot[u]);
          dot[u] = fmaf(c4[u].y, q4.y, dot[u]);
          dot[u] = fmaf(c4[u].z, q4.z, dot[u]);
          dot[u] = fmaf(c4[u].w, q4.w, dot[u]);
        }
      }
    } else {
      for (int k = lane; k < d; k += 32) {
        const float qk = __ldg(q + k);
        float ck[kRows];
#pragma unroll
        for (int u = 0; u < kRows; ++u)
          ck[u] = id[u] != kInvalid ? __ldg(db + (size_t)id[u] * d + k) : 0.f;
#pragma unroll
        for (int u = 0; u < kRows; ++u) dot[u] = fmaf(ck[u], qk, dot[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u)
      for (int off = 16; off > 0; off >>= 1) dot[u] += __shfl_xor_sync(kFull, dot[u], off);
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (lane == u && s0 + u < sbuf) {
        float r = INFINITY;
        if (id[u] != kInvalid) {
          r = __fadd_rn(__fsub_rn(xn, __fmul_rn(2.f, dot[u])), qn);
          r = r < 0.f ? 0.f : r;
        }
        out[(size_t)qi * sbuf + s0 + u] = r;
      }
    }
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// qv [Q, d] f32, buf [Q, sbuf] i32 with row stride ld (ids in [0, n) or
// INVALID), db [n, d] f32, xn2 [n] f32, qn2 [Q] f32, out [Q, sbuf] f32;
// contiguous apart from buf's rows. vec4 != 0 asserts d % 4 == 0 and
// 16 B-aligned qv/db.
extern "C" int l2_by_id_launch(const float* qv, const int32_t* buf, const float* db,
                               const float* xn2, const float* qn2, float* out,
                               int q_total, int sbuf, int ld, int d, int vec4,
                               cudaStream_t stream) {
  int gy = (sbuf + kWarps * kRows - 1) / (kWarps * kRows);
  if (gy > 65535) gy = 65535;
  const dim3 grid(q_total, gy);
  l2_by_id_kernel<<<grid, kWarps * 32, 0, stream>>>(qv, buf, db, xn2, qn2, out, sbuf, ld,
                                                    d, vec4);
  return (int)cudaGetLastError();
}
