// Dense clamped squared distances: the exact k-NN scan's inner product.
//
// Replaces l2_distance_pallas (src/repro/kernels/l2_distance/kernel.py:31,
// body _kernel at :22): for query row i and database row j,
//   d2[i, j] = max((||q_i||^2 + ||x_j||^2) - 2 * <q_i, x_j>, 0)
// with both norms computed inside the kernel, as the TPU kernel does, and
// the epilogue evaluated in the reference's op order (ref.py:16):
// __fadd_rn/__fmul_rn/__fsub_rn keep nvcc from contracting it into an FMA.
//
// What bounds it on the H100: operations. The work is 2*NQ*NC*D flops over
// (NQ + NC)*D*4 bytes read and NQ*NC*4 written; at the exact scan's block
// (NQ = 256, NC = 16384, D = 128) that is 1.07 GFLOP against 25 MB, about
// 43 flop/byte, far above the fp32 ridge of 67 TFLOP/s / 3.35 TB/s = 20, so
// the bound is fp32 FMA throughput (16 us).
// Design: the shared register-tiled product of fp32_tile.cuh (cp.async
// ring of two 32-wide K slices, conflict-free float4 shared-memory reads)
// with 128 x 256 blocks of 256 threads, 8 x 16 accumulators per thread: 128
// FMAs per 24 float4s read from shared memory (a float4 read takes a
// quarter warp one shared-memory cycle, so fewer accumulators would leave
// the FMA pipe waiting on shared memory). At the scan's block shape that is
// 128 blocks, one per SM (255 registers, no spills), in a single wave. The
// norms are summed from the same staged slices, spread over all 256
// threads (the 384 staged rows, one or two each). The epilogue stores each
// thread's four adjacent columns as one float4 where the row allows it.
// No tensor cores: TF32 keeps 10 mantissa bits, which moves d2 by ~1e-3
// relative and reorders near neighbours; a 3xTF32 split on wgmma would keep
// fp32 accuracy at a higher rate but changes the rounding model.
#include "fp32_tile.cuh"

namespace {

using Dense = fp32_tile::Tile<128, 256, 16, 16, 2, 1>;

struct DistanceEpilogue {
  static constexpr int kMaxRowsPerThread = 2;
  float* out;  // [M, N]
  int M, N;
  bool vec_out;  // rows of out start on 16 bytes
  // this thread's staged rows tid + k * threads: A rows [0, BM), then B rows
  float norm[kMaxRowsPerThread];

  template <class T>
  static constexpr int extra_floats() { return 0; }

  template <class T>
  __device__ __forceinline__ void stage(float*, int, int) {}

  template <class T>
  __device__ __forceinline__ void on_slice(const float* st, int tid) {
    constexpr int kPer = (T::kRows + T::kThreads - 1) / T::kThreads;
    static_assert(kPer <= kMaxRowsPerThread, "too many staged rows per thread");
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int R = tid + k * T::kThreads;
      if (R >= T::kRows) break;
      const float* row = st + R * fp32_tile::kBK;
      // chunks in an order rotated by lane, so a quarter warp reads eight
      // bank groups (the rows' swizzle does not matter for a sum over the row)
#pragma unroll
      for (int p = 0; p < fp32_tile::kBK / 4; ++p) {
        const float4 v = *reinterpret_cast<const float4*>(row + (((p + tid) & 7) << 2));
        norm[k] = fmaf(v.x, v.x, norm[k]);
        norm[k] = fmaf(v.y, v.y, norm[k]);
        norm[k] = fmaf(v.z, v.z, norm[k]);
        norm[k] = fmaf(v.w, v.w, norm[k]);
      }
    }
  }

  template <class T>
  __device__ __forceinline__ void finish(float (&acc)[T::TM][T::TN], float* smem, int m0,
                                         int n0, int tx, int ty, int tid) {
#pragma unroll
    for (int k = 0; k < kMaxRowsPerThread; ++k)  // [BM] query norms, [BN] database norms
      if (tid + k * T::kThreads < T::kRows) smem[tid + k * T::kThreads] = norm[k];
    __syncthreads();
    const float* xn = smem + T::BM;
#pragma unroll
    for (int i = 0; i < T::TM; ++i) {
      const int gi = m0 + T::row(ty, i);
      if (gi >= M) break;
      const float qn = smem[T::row(ty, i)];
      float* orow = out + (size_t)gi * N;
#pragma unroll
      for (int g = 0; g < T::TN / 4; ++g) {
        const int c = T::col(tx, 4 * g);
        const int gj = n0 + c;
        float v[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          v[jj] = fmaxf(__fsub_rn(__fadd_rn(qn, xn[c + jj]), __fmul_rn(2.f, acc[i][4 * g + jj])),
                        0.f);
        if (vec_out && gj + 3 < N) {
          *reinterpret_cast<float4*>(orow + gj) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            if (gj + jj < N) orow[gj + jj] = v[jj];
        }
      }
    }
  }
};

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [nq, d], x [nc, d], out [nq, nc]; f32, contiguous.
extern "C" int l2_dense_launch(const float* q, const float* x, float* out, int nq, int nc,
                               int d, cudaStream_t stream) {
  const DistanceEpilogue epi{out, nq, nc, fp32_tile::rows_aligned16(out, nc), {0.f, 0.f}};
  const bool vec4 = fp32_tile::rows_aligned16(q, d) && fp32_tile::rows_aligned16(x, d);
  return (int)(vec4 ? fp32_tile::launch<Dense, true>(q, x, nq, nc, d, epi, stream)
                    : fp32_tile::launch<Dense, false>(q, x, nq, nc, d, epi, stream));
}
