// One radius of the fused probe: chain-row gather, fingerprint filter, the
// S-budget gate and the ordered compact append, in one launch.
//
// Replaces bucket_probe_pallas (src/repro/kernels/bucket_probe/kernel.py:38)
// and the tensor work the reference leaves to XLA around it
// (src/repro/core/query.py:283-345: the step gate scan and the append). For
// query q with buckets (cnt, head, qfp)[q, l], l < L, chunk c < C of bucket
// l is block row head + c. It is readable iff active[q] and
// cnt > c * block_objs. Step c is read iff the candidates collected before
// it number fewer than S; a read step reads all of its readable rows, and
// blocks_read counts them. The matches (fps == qfp, ids != INVALID) of the
// read steps are appended in (step, l, slot) order; a match lands only at a
// position below S, and count = min(matches, S). Slots from count to sbuf
// hold INVALID, so an inactive query gets an all-INVALID row and zeros.
//
// What bounds it on the H100: bytes. A read row moves 2 * BLKp * 4 bytes
// (832 B at BLKp = 104) for one compare and select per slot; the [Q, L]
// inputs and the [Q, sbuf] output are small beside the rows. At the SIFT1M
// configuration (Q = 256, L = 32, C = 2) a radius reads at most 16,384 rows,
// ~13.6 MB; the bound counts the rows this run's data reads.
//
// Design: one block per query, 8 warps. The block stages its query's L
// (cnt, head, qfp) in shared memory, loaded beside its active flag. A step's
// L rows go in chunks of 32, 4 rows per warp: each lane loads one int4 of
// ids and of fps of each of its warp's 4 rows (a 416 B row is 26 int4s)
// before it compares any, so 8 loads per lane are in flight. Pass 1 counts
// each row's matches (__reduce_add_sync of per-lane popcounts); after one
// __syncthreads every warp scans the chunk's 32 row counts with shuffles,
// which gives each row its offset. Pass 2 reloads the warp's rows (L1 hits)
// and writes each match at count + row offset + its rank in the row (four
// ballots and popcounts over the lanes below). The running count is held by
// every thread alike, so the step gate and the loop bounds are uniform; the
// row counts are double-buffered, so one barrier per chunk suffices. A
// step's rows past the budget are counted but not loaded. While a step is
// read, the next step's rows of still-deep buckets are prefetched into L2 (a
// hint: not counted, harmless if the gate then closes). Nothing else leaves
// the block: the [Q*C*L, BLKp] filtered rows of the unfused probe never
// exist. Rows wider than 128 slots take several 32-lane segments, so any
// BLKp % 4 == 0, any C >= 1 and any L up to 4096 work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kChunk = kWarps * kRowsPerWarp;  // rows per chunk: one warp scan
constexpr int32_t kInvalid = 0x7FFFFFFF;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kChunk == 32, "a chunk's row counts are scanned by one warp");

__device__ __forceinline__ unsigned match_bits(int4 id, int4 fp, int32_t q) {
  return (unsigned)(fp.x == q && id.x != kInvalid) |
         (unsigned)(fp.y == q && id.y != kInvalid) << 1 |
         (unsigned)(fp.z == q && id.z != kInvalid) << 2 |
         (unsigned)(fp.w == q && id.w != kInvalid) << 3;
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

__global__ void __launch_bounds__(kWarps * 32)
probe_append_kernel(const int32_t* __restrict__ cnt, const int32_t* __restrict__ head,
                    const int32_t* __restrict__ qfp, const uint8_t* __restrict__ active,
                    const int4* __restrict__ ids, const int4* __restrict__ fps,
                    int32_t* __restrict__ buf, int32_t* __restrict__ count_out,
                    int32_t* __restrict__ blocks_out, int L, int C, int block_objs,
                    int S, int sbuf, int row_vecs) {
  __shared__ int row_total[2][kChunk];
  __shared__ int warp_reads[kWarps];
  extern __shared__ int32_t staged[];  // the query's cnt, head, qfp: 3 * L
  const int qi = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int32_t* cq = staged;
  int32_t* hq = staged + L;
  int32_t* fq = staged + 2 * L;
  int32_t* out = buf + (size_t)qi * sbuf;
  const unsigned below = (1u << lane) - 1u;
  // staged whether or not the query is active, so these loads and the
  // active flag's are in flight together
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    cq[l] = __ldg(cnt + (size_t)qi * L + l);
    hq[l] = __ldg(head + (size_t)qi * L + l);
    fq[l] = __ldg(qfp + (size_t)qi * L + l);
  }
  const bool on = active[qi] != 0;
  __syncthreads();

  int base = 0;   // matches of the read steps so far, unclamped; uniform
  int reads = 0;  // readable rows of the read steps, this warp's
  int parity = 0;
  for (int c = 0; on && c < C && base < S; ++c) {
    const int depth = c * block_objs;
    for (int r0 = 0; r0 < L; r0 += kChunk) {
      // pass 1: which of this warp's rows are readable, and their matches
      bool load[kRowsPerWarp];
      size_t row[kRowsPerWarp];
      int32_t f[kRowsPerWarp];
      int total[kRowsPerWarp];
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
        const int l = r0 + warp * kRowsPerWarp + j;
        const int n = l < L ? cq[l] : 0;
        const bool readable = n > depth;
        reads += readable;
        load[j] = readable && base < S;
        row[j] = load[j] ? (size_t)hq[l] + c : 0;
        f[j] = load[j] ? fq[l] : 0;
        total[j] = 0;
        if (load[j] && c + 1 < C && n > depth + block_objs) {
          for (int v = lane; v < row_vecs; v += 32) {
            prefetch_l2(ids + (row[j] + 1) * row_vecs + v);
            prefetch_l2(fps + (row[j] + 1) * row_vecs + v);
          }
        }
      }
      for (int v0 = 0; v0 < row_vecs; v0 += 32) {
        const int v = v0 + lane;
        int4 iv[kRowsPerWarp], fv[kRowsPerWarp];
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) {
          if (load[j] && v < row_vecs) {
            iv[j] = __ldg(ids + row[j] * row_vecs + v);
            fv[j] = __ldg(fps + row[j] * row_vecs + v);
          } else {
            iv[j] = make_int4(kInvalid, kInvalid, kInvalid, kInvalid);
            fv[j] = make_int4(0, 0, 0, 0);
          }
        }
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j)
          total[j] += __reduce_add_sync(kFull, __popc(match_bits(iv[j], fv[j], f[j])));
      }
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j)
          row_total[parity][warp * kRowsPerWarp + j] = total[j];
      }
      __syncthreads();

      // every warp scans the chunk's row counts: exclusive offsets
      const int t = row_total[parity][lane];
      int incl = t;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      const int chunk_total = __shfl_sync(kFull, incl, 31);

      // pass 2: write this warp's matches below S
#pragma unroll
      for (int j = 0; j < kRowsPerWarp; ++j) {
        int pos = base + __shfl_sync(kFull, incl - t, warp * kRowsPerWarp + j);
        if (total[j] == 0 || pos >= S) continue;  // uniform within the warp
        for (int v0 = 0; v0 < row_vecs && pos < S; v0 += 32) {
          const int v = v0 + lane;
          int4 id = make_int4(kInvalid, kInvalid, kInvalid, kInvalid);
          unsigned m = 0;
          if (v < row_vecs) {
            id = __ldg(ids + row[j] * row_vecs + v);
            m = match_bits(id, __ldg(fps + row[j] * row_vecs + v), f[j]);
          }
          const unsigned b0 = __ballot_sync(kFull, m & 1u), b1 = __ballot_sync(kFull, m & 2u),
                         b2 = __ballot_sync(kFull, m & 4u), b3 = __ballot_sync(kFull, m & 8u);
          int p = pos + __popc(b0 & below) + __popc(b1 & below) + __popc(b2 & below) +
                  __popc(b3 & below);
          const int32_t e[4] = {id.x, id.y, id.z, id.w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (m >> k & 1u) {
              if (p < S) out[p] = e[k];
              ++p;
            }
          }
          pos += __popc(b0) + __popc(b1) + __popc(b2) + __popc(b3);
        }
      }
      base += chunk_total;
      parity ^= 1;
    }
  }

  const int count = base < S ? base : S;
  for (int p = count + threadIdx.x; p < sbuf; p += blockDim.x) out[p] = kInvalid;
  if (lane == 0) warp_reads[warp] = reads;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int w = 0; w < kWarps; ++w) sum += warp_reads[w];
    count_out[qi] = count;
    blocks_out[qi] = sum;
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// cnt/head/qfp [q_total, L] i32, active [q_total] bool (one byte each),
// ids/fps [NB, blkp] i32 (blkp % 4 == 0, 16 B-aligned), buf [q_total, sbuf]
// i32, count/blocks [q_total] i32; all contiguous. 0 < S <= sbuf, C >= 1,
// L <= 4096 (3 * L ints of shared memory).
// The caller guarantees head + c < NB for every readable chunk (the index's
// chain rows).
extern "C" int probe_append_launch(const int32_t* cnt, const int32_t* head,
                                   const int32_t* qfp, const uint8_t* active,
                                   const int32_t* ids, const int32_t* fps, int32_t* buf,
                                   int32_t* count, int32_t* blocks, int q_total, int L,
                                   int C, int block_objs, int S, int sbuf, int blkp,
                                   cudaStream_t stream) {
  const size_t smem = (size_t)3 * L * sizeof(int32_t);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;  // the wrapper caps L
  probe_append_kernel<<<q_total, kWarps * 32, smem, stream>>>(
      cnt, head, qfp, active, reinterpret_cast<const int4*>(ids),
      reinterpret_cast<const int4*>(fps), buf, count, blocks, L, C, block_objs, S, sbuf,
      blkp / 4);
  return (int)cudaGetLastError();
}
