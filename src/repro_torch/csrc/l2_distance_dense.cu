// Dense clamped squared distances: the exact k-NN scan's inner product.
//
// Replaces l2_distance_pallas (src/repro/kernels/l2_distance/kernel.py:31,
// body _kernel at :22): for query row i and database row j,
//   d2[i, j] = max((||q_i||^2 + ||x_j||^2) - 2 * <q_i, x_j>, 0)
// with both norms computed inside the kernel, as the TPU kernel does, and
// the epilogue evaluated in the reference's op order (ref.py:16):
// __fadd_rn/__fmul_rn/__fsub_rn keep nvcc from contracting it into an FMA.
// Every sum is an IEEE fp32 FMA chain on the CUDA cores: no tensor cores and
// no TF32, whose 10-bit mantissa moves d2 by ~1e-3 relative and reorders
// near neighbours.
//
// What bounds it on the H100: operations. The work is 2*NQ*NC*D flops over
// (NQ + NC)*D*4 bytes read and NQ*NC*4 written; at the exact scan's block
// (NQ = 256, NC = 16384, D = 128) that is 1.07 GFLOP against 25 MB, about
// 43 flop/byte, far above the fp32 ridge of 67 TFLOP/s / 3.35 TB/s = 20, so
// the bound is fp32 FMA throughput. Design: a simple SIMT tiled product.
// A block owns a 64 x 64 output tile and walks D in slices of 16: each
// slice of the q tile and of the x tile is staged in shared memory,
// k-major so a thread reads its four rows and four columns as two float4s;
// each of the 256 threads accumulates a 4 x 4 register micro-tile.
// Threads 0-63 sum the q rows' squares and threads 64-127 the x rows'
// squares from the same staged slices. Ragged NQ, NC and any D are handled
// by bounds checks (zero-filled loads, guarded stores), not a padding
// contract. Tensor cores (wgmma with a 3xTF32 split) and TMA staging are
// the way to the card's peak, and are left for later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;   // query rows per block
constexpr int kBN = 64;   // database rows per block
constexpr int kBK = 16;   // D slice staged per step
constexpr int kPad = 4;   // keeps each staged row 16 B aligned, spreads banks
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
l2_dense_kernel(const float* __restrict__ q, const float* __restrict__ x,
                float* __restrict__ out, int nq, int nc, int d) {
  __shared__ __align__(16) float qs[kBK][kBM + kPad];
  __shared__ __align__(16) float xs[kBK][kBN + kPad];
  __shared__ float qn_s[kBM];
  __shared__ float xn_s[kBN];

  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float norm = 0.f;  // threads 0-63: ||q_{m0+t}||^2; 64-127: ||x_{n0+t-64}||^2

  for (int k0 = 0; k0 < d; k0 += kBK) {
    // 64 rows x 16 columns of each operand: four elements per thread
#pragma unroll
    for (int e = 0; e < (kBM * kBK) / kThreads; ++e) {
      const int idx = t + e * kThreads;
      const int r = idx / kBK, c = idx % kBK;
      const int gk = k0 + c;
      const int gq = m0 + r, gx = n0 + r;
      qs[c][r] = (gq < nq && gk < d) ? __ldg(q + (size_t)gq * d + gk) : 0.f;
      xs[c][r] = (gx < nc && gk < d) ? __ldg(x + (size_t)gx * d + gk) : 0.f;
    }
    __syncthreads();

    if (t < kBM) {
#pragma unroll
      for (int k = 0; k < kBK; ++k) norm = fmaf(qs[k][t], qs[k][t], norm);
    } else if (t < kBM + kBN) {
#pragma unroll
      for (int k = 0; k < kBK; ++k) norm = fmaf(xs[k][t - kBM], xs[k][t - kBM], norm);
    }
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&qs[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&xs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (t < kBM) {
    qn_s[t] = norm;
  } else if (t < kBM + kBN) {
    xn_s[t - kBM] = norm;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gq = m0 + ty * 4 + i;
    if (gq >= nq) break;
    const float qn = qn_s[ty * 4 + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gx = n0 + tx * 4 + j;
      if (gx < nc) {
        const float v = __fsub_rn(__fadd_rn(qn, xn_s[tx * 4 + j]),
                                  __fmul_rn(2.f, acc[i][j]));
        out[(size_t)gq * nc + gx] = fmaxf(v, 0.f);
      }
    }
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [nq, d], x [nc, d], out [nq, nc]; f32, contiguous.
extern "C" int l2_dense_launch(const float* q, const float* x, float* out, int nq,
                               int nc, int d, cudaStream_t stream) {
  const int gy = (nq + kBM - 1) / kBM;
  if (gy > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((nc + kBN - 1) / kBN, gy);
  l2_dense_kernel<<<grid, kThreads, 0, stream>>>(q, x, out, nq, nc, d);
  return (int)cudaGetLastError();
}
