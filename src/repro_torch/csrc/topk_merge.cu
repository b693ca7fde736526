// One radius' fold of a query batch's candidates into its search state: the
// top-k merge with id dedup, the done test and the per-query counters, in one
// launch.
//
// Replaces no TPU kernel: it replaces the tensor work that the reference
// leaves to XLA in src/repro/core/query.py (_merge_topk and _update_state,
// lines 355-400: two concatenates, two stable argsorts, four gathers, the
// duplicate mask, the selects, the within count and the counter adds), which
// the port ran as ~30 eager operations a radius.
//
// For query row q: take the k running (id, d2) entries followed by the
// radius' sbuf candidates, in that order. An id that is not INVALID and
// appeared earlier in that order gets d2 = +inf (what the stable id sort and
// the neighbour compare give). Keep the k smallest entries by (d2, id,
// position) in ascending order (the stable d2 sort over the id-sorted order),
// with INVALID where d2 is inf. The fold compares floats and does no
// arithmetic on them, so the result equals the plain fold bit for bit. A row
// already done keeps its top-k and gains only the probe's counts (zero for
// such a row); an active row sets done when its k-th distance is within
// (c R_t)^2 (the merged row is ascending), counts one radius searched, and
// counts its non-empty buckets (cnt > 0) as hash-table reads; with the probe
// trace on, probe_sizes[q, t, l] is cnt for those buckets and -1 elsewhere.
//
// What bounds it on the H100: neither bytes nor operations. The main path's
// rows are tiny (Q = 256, k = 10, sbuf = 64: ~0.2 MB in and out), and the
// O(n^2) compares of a row of n = k + sbuf entries take ~n^2 / blockDim
// steps a thread. What it removes is the host's dispatch of ~30 operations
// and the device's two segmented radix sorts and gathers.
//
// Design: one block per row, as many threads as the row has entries rounded
// up to a warp (at most 1,024; wider rows give each thread several entries).
// The row's entries are staged in shared memory as (d2, id) pairs (n * 8
// bytes, n <= 4,096), with every global load of the row issued at once.
// Pass 1 marks duplicates: each entry scans the entries before it, all
// threads reading the same address at each step (a broadcast). Pass 2 ranks
// each entry by counting the entries before it in (d2, id, position), which
// is a strict total order, so the ranks below k are k distinct slots; an
// entry stops counting once it has k before it. Both scans take four
// entries a step. Each of the k winners writes its own slot of the running
// top-k in place, and the k-th sets done. The bucket counts are summed by
// __syncthreads_count over the row's L tables.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int32_t kInvalid = 0x7FFFFFFF;
constexpr int kMaxThreads = 1024;
constexpr int kMaxEntries = 4096;  // 32 KB of staged (id, d2): under 48 KB

__device__ __forceinline__ bool before(float dj, int32_t ij, int j, float di, int32_t ii,
                                       int i) {
  return dj < di || (dj == di && (ij < ii || (ij == ii && j < i)));
}

__global__ void topk_merge_kernel(int32_t* __restrict__ best_id, float* __restrict__ best_d2,
                                  uint8_t* __restrict__ done, int32_t* __restrict__ radii,
                                  int32_t* __restrict__ nio_table,
                                  int32_t* __restrict__ nio_blocks,
                                  int32_t* __restrict__ cands,
                                  int32_t* __restrict__ probe_sizes,
                                  const int32_t* __restrict__ cand_id, int ld_id,
                                  const float* __restrict__ cand_d2,
                                  const int32_t* __restrict__ cnt, int ld_cnt,
                                  const int32_t* __restrict__ blocks, int ld_blocks,
                                  const int32_t* __restrict__ count, int ld_count, int k,
                                  int sbuf, int L, int r, int t, float thresh2) {
  extern __shared__ float2 ent[];  // the row's entries: (d2, id's bits)
  const int n = k + sbuf;
  const size_t q = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  // every load is issued before the done flag is known (a done row's are
  // wasted), so the block waits on one round of memory latency, not three
  const uint8_t was_done = done[q];
  for (int i = tid; i < n; i += nt)
    ent[i] = i < k ? make_float2(best_d2[q * k + i], __int_as_float(best_id[q * k + i]))
                   : make_float2(__ldg(cand_d2 + q * sbuf + (i - k)),
                                 __int_as_float(__ldg(cand_id + q * ld_id + (i - k))));
  int add_blocks = 0, add_count = 0;
  if (tid == 0) {
    add_blocks = __ldg(blocks + q * ld_blocks);
    add_count = __ldg(count + q * ld_count);
  }
  const bool active = was_done == 0;  // read by every thread before any barrier
  int nonempty = 0;                   // uniform: a barrier's count
  for (int l0 = 0; l0 < L; l0 += nt) {
    const int l = l0 + tid;
    const int c = l < L ? __ldg(cnt + q * ld_cnt + l) : 0;
    const bool hit = active && c > 0;
    if (probe_sizes != nullptr && l < L) probe_sizes[(q * r + t) * L + l] = hit ? c : -1;
    nonempty += __syncthreads_count(hit);
  }
  if (tid == 0) {
    radii[q] += active;
    nio_table[q] += nonempty;
    nio_blocks[q] += add_blocks;
    cands[q] += add_count;
  }
  if (!active) return;  // uniform over the block
  __syncthreads();

  // pass 1: a valid id seen earlier in the row is a duplicate; four entries
  // a step, so their shared-memory loads are in flight together
  for (int i = tid; i < n; i += nt) {
    const int32_t id = __float_as_int(ent[i].y);
    bool dup = false;
    if (id != kInvalid) {
      for (int j0 = 0; j0 < i && !dup; j0 += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          dup |= j0 + u < i && __float_as_int(ent[j0 + u].y) == id;
      }
    }
    if (dup) ent[i].x = INFINITY;  // entry i's own d2: pass 1 reads ids alone
  }
  __syncthreads();

  // pass 2: rank by (d2, id, position); the k first take their slots
  for (int i = tid; i < n; i += nt) {
    const float2 e = ent[i];
    const int32_t ii = __float_as_int(e.y);
    int rank = 0;
    for (int j0 = 0; j0 < n && rank < k; j0 += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + u;
        if (j < n) {
          const float2 o = ent[j];
          rank += before(o.x, __float_as_int(o.y), j, e.x, ii, i);
        }
      }
    }
    if (rank < k) {
      best_id[q * k + rank] = isinf(e.x) ? kInvalid : ii;
      best_d2[q * k + rank] = e.x;
      if (rank == k - 1) done[q] = e.x <= thresh2;
    }
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// best_id [q_total, k] i32, best_d2 [q_total, k] f32, done [q_total] bool (one
// byte each), radii/nio_table/nio_blocks/cands [q_total] i32, probe_sizes
// [q_total, r, L] i32 or null (then r and t are unused): the state, updated in
// place, all contiguous. cand_id [q_total, sbuf] i32 with row stride ld_id,
// cand_d2 [q_total, sbuf] f32 contiguous, cnt [q_total, L] i32 with row stride
// ld_cnt, blocks and count [q_total] i32 with strides ld_blocks and ld_count.
// 1 <= k, 0 <= sbuf, k + sbuf <= 4096.
extern "C" int topk_merge_launch(int32_t* best_id, float* best_d2, uint8_t* done,
                                 int32_t* radii, int32_t* nio_table, int32_t* nio_blocks,
                                 int32_t* cands, int32_t* probe_sizes, const int32_t* cand_id,
                                 int ld_id, const float* cand_d2, const int32_t* cnt,
                                 int ld_cnt, const int32_t* blocks, int ld_blocks,
                                 const int32_t* count, int ld_count, int q_total, int k,
                                 int sbuf, int L, int r, int t, float thresh2,
                                 cudaStream_t stream) {
  const int n = k + sbuf;
  if (k < 1 || sbuf < 0 || n > kMaxEntries) return (int)cudaErrorInvalidValue;
  int threads = (n + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = (size_t)2 * n * sizeof(int32_t);
  topk_merge_kernel<<<q_total, threads, smem, stream>>>(
      best_id, best_d2, done, radii, nio_table, nio_blocks, cands, probe_sizes, cand_id,
      ld_id, cand_d2, cnt, ld_cnt, blocks, ld_blocks, count, ld_count, k, sbuf, L, r, t,
      thresh2);
  return (int)cudaGetLastError();
}
