// Fused p-stable LSH hashing for the whole radius schedule in one launch,
// with the hash-table lookup of every bucket in its epilogue.
//
// Replaces lsh_hash_pallas (src/repro/kernels/lsh_hash/kernel.py:76): for
// query row n and compound hash j (j = t*L + l over every radius t),
//   proj_c = x[n] . a[c]                      c = j*mp + i, i < mp
//   h_c    = floor((proj_c + bwr[c]) / wr[c])  per-column width wr = w*R_t
//   acc    = sum_i uint32(h_c) * rm[c]         wrapping uint32
//   hv     = fmix32(acc)
//   bucket = hv & (2^u - 1),  fp = (hv >> u) & (2^fp_bits - 1)
// and, given the index's tables cnt/head [r, L, 2^u] (the query plans' Step 1
// read), gathers
//   cnt[(j << u) + bucket], head[(j << u) + bucket]   (64-bit index: r*L*2^u
//                                                      can pass 2^31)
// and writes cnt, head and fp to [r, N, L] int32 at (t*N + n)*L + l: the
// layout the probe stage reads a radius at a time as contiguous [N, L] rows,
// so the bucket id never reaches device memory. Without tables (null
// pointers) it writes bucket and fp in that layout instead. The operands are
// the wrapper's pack (kernels/lsh_hash/ops.py), built once per index and
// radius schedule: each hash's m columns padded to mp (a multiple of 4 that
// divides the block width) with a = 0, bwr = 0, wr = 1, rm = 0, so a padding
// column adds 0.
//
// Arithmetic contract: the projection is IEEE fp32 FMAs (no TF32, no tensor
// cores, no cuBLAS) and the quantisation keeps the reference's op order with
// a true division (__fadd_rn, __fdiv_rn), so a hash differs from the
// reference's only where the two fp32 projections straddle a floor()
// boundary. The lookup reads what the hash names and changes no hash.
//
// What bounds it on the H100: operations. At the SIFT1M configuration
// (N = 256, D = 128, r*L*m = 5152) it does 2*N*D*5152 = 338 MFLOP of fp32
// FMAs against ~3.3 MB of traffic: 5.0 us at 67 TFLOP/s, 1 us at 3.35 TB/s.
// The lookup adds 2*N*r*L random 4-byte reads (57,344 at N = 256; a 32-byte
// sector each, 1.8 MB) and 3*N*r*L*4 bytes of writes.
// Design: the projection is the shared register-tiled product of
// fp32_tile.cuh (C = x . a^T, cp.async ring, register micro-tiles), and the
// epilogue above runs on its accumulators. Wrapping uint32 addition is
// associative, so the m products of one hash, held by several threads, are
// summed per thread in groups of four columns and then across threads
// through shared memory; the [N, r*L*m] projection never reaches device
// memory, as in the TPU kernel. Consecutive threads then take consecutive
// hashes of one row: the block's BN/mp of them (4 at mp = 24, 12 at mp = 8),
// so a run of [r, N, L] stores is BN/mp ints wide before the next row's run
// starts L ints on; the outputs are 12*N*r*L bytes against the projection's
// 2*N*D*r*L*m flops, too few for the stores' width to matter. The epilogue's
// column operands (bwr, wr, rm) are staged into shared memory with the first
// K slice. Two tiles of one kernel, with the same FMA chain per output (a
// lone query hashes bit for bit as the same row of a batch) and the same
// epilogue:
//  * N > 4 (a query batch): 64 x 96 blocks of 128 threads, 4 x 12 per
//    thread, 3 stages; 224 blocks at N = 256, two resident per SM. K = 128
//    is only four slices deep, so the ring's fill and the IEEE divisions of
//    the epilogue are a large share of its time.
//  * N <= 4 (a lone query, padded to 2): the work is reading a (2.75 MB,
//    0.8 us at the HBM rate), and a thread's chain of dependent loads and
//    FMAs is the latency that counts. 4 x 48 blocks of 48 threads, 1 x 4 per
//    thread, the whole K in flight (4 stages): 112 blocks on as many SMs.
// The small tile needs mp | 48; for mp = 32 or 96 the batch tile serves
// every N. No tensor cores: TF32 would move projections across floor(), and
// a 3xTF32 split changes the rounding model the hashes are held to.
#include "fp32_tile.cuh"

namespace {

using Batch = fp32_tile::Tile<64, 96, 8, 16, 3, 2>;
using Lone = fp32_tile::Tile<4, 48, 12, 4, 4, 1>;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

struct HashEpilogue {
  const float* bwr;   // [ncols] b * wr, packed
  const float* wr;    // [ncols]
  const int32_t* rm;  // [ncols] uint32 bit patterns
  const int32_t* __restrict__ tcnt;   // [n_hashes << u] bucket sizes, or null
  const int32_t* __restrict__ thead;  // [n_hashes << u] chain heads, or null
  int32_t* __restrict__ out0;         // [r, M, L]: cnt (tables) or bucket
  int32_t* __restrict__ out1;         // [r, M, L]: head (tables only)
  int32_t* __restrict__ fp;           // [r, M, L]
  int M, ncols, n_hashes, L, mp, u, fp_bits;

  // bwr, wr, rm of the block's BN columns, staged with the first K slice
  template <class T>
  static constexpr int extra_floats() { return 3 * T::BN; }

  template <class T>
  __device__ __forceinline__ void stage(float* extra, int n0, int tid) {
    constexpr int kChunks = T::BN / 4;  // ncols and n0 are multiples of 4
    for (int c = tid; c < 3 * kChunks; c += T::kThreads) {
      const int which = c / kChunks, k = (c - which * kChunks) * 4;
      const float* src = which == 0 ? bwr : which == 1 ? wr
                                                      : reinterpret_cast<const float*>(rm);
      const bool ok = n0 + k < ncols;
      fp32_tile::cp_async16(extra + which * T::BN + k, ok ? src + n0 + k : src, ok);
    }
  }

  template <class T>
  __device__ __forceinline__ void on_slice(const float*, int) {}

  template <class T>
  __device__ __forceinline__ void finish(float (&acc)[T::TM][T::TN], float* smem, int m0,
                                         int n0, int tx, int ty, int tid) {
    constexpr int kGroups = T::BN / 4;  // four-column groups per block row
    static_assert(size_t(T::BM) * kGroups * 4 <= T::kSmemBytes, "partials exceed the ring");
    const float* cols = smem + T::STAGES * T::kStageFloats;  // staged bwr | wr | rm
    uint32_t* part = reinterpret_cast<uint32_t*>(smem);      // [BM][kGroups]
#pragma unroll
    for (int g = 0; g < T::TN / 4; ++g) {
      float cb[4], cw[4];
      uint32_t cr[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int cl = T::col(tx, 4 * g + jj);
        const bool ok = n0 + cl < ncols;
        cb[jj] = ok ? cols[cl] : 0.f;
        cw[jj] = ok ? cols[T::BN + cl] : 1.f;
        cr[jj] = ok ? __float_as_uint(cols[2 * T::BN + cl]) : 0u;
      }
#pragma unroll
      for (int i = 0; i < T::TM; ++i) {
        uint32_t s = 0u;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float h = floorf(__fdiv_rn(__fadd_rn(acc[i][4 * g + jj], cb[jj]), cw[jj]));
          s += (uint32_t)(int32_t)h * cr[jj];
        }
        part[T::row(ty, i) * kGroups + g * T::TX + tx] = s;
      }
    }
    __syncthreads();
    const int per_block = T::BN / mp;  // whole hashes per block
    const int gph = mp / 4;            // groups per hash
    const int h0 = n0 / mp;
    for (int p = tid; p < T::BM * per_block; p += T::kThreads) {
      const int r = p / per_block, h = p - r * per_block;
      const int row = m0 + r, j = h0 + h;
      if (row >= M || j >= n_hashes) continue;
      uint32_t s = 0u;
      for (int k = 0; k < gph; ++k) s += part[r * kGroups + h * gph + k];
      const uint32_t hv = fmix32(s);
      const uint32_t bucket = hv & ((1u << u) - 1u);
      const int t = j / L;
      const size_t o = ((size_t)t * M + row) * L + (j - t * L);
      if (tcnt != nullptr) {
        const size_t flat = ((size_t)j << u) + bucket;
        out0[o] = __ldg(tcnt + flat);
        out1[o] = __ldg(thead + flat);
      } else {
        out0[o] = (int32_t)bucket;
      }
      fp[o] = (int32_t)((hv >> u) & ((1u << fp_bits) - 1u));
    }
  }
};

template <class T>
cudaError_t run(const float* x, const float* a, const HashEpilogue& epi, int n, int d,
                bool vec4, cudaStream_t stream) {
  return vec4 ? fp32_tile::launch<T, true>(x, a, n, epi.ncols, d, epi, stream)
              : fp32_tile::launch<T, false>(x, a, n, epi.ncols, d, epi, stream);
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x [n, d] f32; a [r*L*mp, d] f32 (row c = projection column c, each hash's
// columns padded to mp); bwr/wr [r*L*mp] f32; rm [r*L*mp] i32 (uint32 bit
// patterns). With tables, tcnt/thead [r, L, 2^u] i32 and the outputs
// cnt = out0, head = out1, fp [r, n, L] i32; with tcnt = thead = null, the
// outputs bucket = out0 and fp (out1 unused). All contiguous on the current
// device. mp must be a multiple of 4 that divides 96.
extern "C" int lsh_hash_launch(const float* x, const float* a, const float* bwr,
                               const float* wr, const int32_t* rm, const int32_t* tcnt,
                               const int32_t* thead, int32_t* out0, int32_t* out1,
                               int32_t* fp, int n, int d, int r, int L, int mp, int u,
                               int fp_bits, cudaStream_t stream) {
  if (mp <= 0 || mp % 4 != 0 || Batch::BN % mp != 0) return (int)cudaErrorInvalidValue;
  if ((tcnt == nullptr) != (thead == nullptr) || (tcnt != nullptr && out1 == nullptr))
    return (int)cudaErrorInvalidValue;
  // the column operands are staged by 16-byte copies
  if ((reinterpret_cast<uintptr_t>(bwr) | reinterpret_cast<uintptr_t>(wr) |
       reinterpret_cast<uintptr_t>(rm)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int n_hashes = r * L;
  const HashEpilogue epi{bwr, wr, rm, tcnt, thead, out0, out1, fp,
                         n, n_hashes * mp, n_hashes, L, mp, u, fp_bits};
  const bool vec4 = fp32_tile::rows_aligned16(x, d) && fp32_tile::rows_aligned16(a, d);
  if (n <= Lone::BM && Lone::BN % mp == 0)
    return (int)run<Lone>(x, a, epi, n, d, vec4, stream);
  return (int)run<Batch>(x, a, epi, n, d, vec4, stream);
}
