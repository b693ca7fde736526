// Fused p-stable LSH hashing for the whole radius schedule in one launch.
//
// Replaces lsh_hash_pallas (src/repro/kernels/lsh_hash/kernel.py:76): for
// query row n and compound hash j (j = t*L + l over every radius t),
//   proj_c = x[n] . a[c]                      c = j*m + i, i < m
//   h_c    = floor((proj_c + bwr[c]) / wr[c])  per-column width wr = w*R_t
//   acc    = sum_i uint32(h_c) * rm[c]         wrapping uint32
//   hv     = fmix32(acc)
//   bucket = hv & (2^u - 1),  fp = (hv >> u) & (2^fp_bits - 1)
// written to bucket/fp [N, n_hashes] int32.
//
// Arithmetic contract: the projection is IEEE fp32 FMAs (no TF32, no tensor
// cores, no cuBLAS) and the quantisation keeps the reference's op order with
// a true division (__fadd_rn, __fdiv_rn), so a hash differs from the
// reference's only where the two fp32 projections straddle a floor()
// boundary.
//
// What bounds it on the H100: operations. At the SIFT1M configuration
// (N = 256, D = 128, r*L*m = 5152) it does 2*N*D*5152 = 338 MFLOP of fp32
// FMAs against ~3.3 MB of traffic, so the fp32 pipe (67 TFLOP/s outside the
// tensor cores) is the bound. Design: a block owns 32 query rows and 8
// compound hashes. The 32 rows sit in shared memory with a padded row
// stride (D+1), so lane k reading row k's element d hits bank (k*(D+1)+d)%32
// with no conflicts. Warp w walks the m projection columns of compound hash
// j; every lane of the warp reads the same element of a (a broadcast from
// L1; the whole of a, 2.6 MB, stays resident in the 50 MB L2). The combine
// over m stays in registers, so the [N, r*L*m] projection never reaches
// device memory, as in the TPU kernel. There is no size limit: the TPU
// path's 8 MiB VMEM fall-back has no counterpart here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;    // query rows per block: one per lane
constexpr int kHashes = 8;   // compound hashes per block: one per warp

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__global__ void __launch_bounds__(kRows * kHashes)
lsh_hash_kernel(const float* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ bwr, const float* __restrict__ wr,
                const int32_t* __restrict__ rm, int32_t* __restrict__ bucket,
                int32_t* __restrict__ fp, int n, int d, int n_hashes, int m,
                int u, int fp_bits) {
  extern __shared__ float xs[];  // [kRows][d + 1]
  const int ld = d + 1;
  const int row0 = blockIdx.x * kRows;
  for (int i = threadIdx.x; i < kRows * d; i += blockDim.x) {
    const int r = i / d, c = i - r * d;
    const int row = row0 + r;
    xs[r * ld + c] = row < n ? x[(size_t)row * d + c] : 0.f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int j = blockIdx.y * kHashes + (threadIdx.x >> 5);
  const int row = row0 + lane;
  if (j >= n_hashes || row >= n) return;

  const float* xr = xs + lane * ld;
  uint32_t acc = 0u;
  for (int i = 0; i < m; ++i) {
    const int col = j * m + i;
    const float* ac = a + (size_t)col * d;
    float proj = 0.f;
    for (int k = 0; k < d; ++k) proj = fmaf(xr[k], __ldg(ac + k), proj);
    const float h = floorf(__fdiv_rn(__fadd_rn(proj, __ldg(bwr + col)),
                                     __ldg(wr + col)));
    acc += (uint32_t)(int32_t)h * (uint32_t)__ldg(rm + col);
  }
  const uint32_t hv = fmix32(acc);
  const size_t o = (size_t)row * n_hashes + j;
  bucket[o] = (int32_t)(hv & ((1u << u) - 1u));
  fp[o] = (int32_t)((hv >> u) & ((1u << fp_bits) - 1u));
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x [n, d] f32, a [n_hashes*m, d] f32 (row c = projection column c),
// bwr/wr [n_hashes*m] f32, rm [n_hashes*m] i32 (uint32 bit patterns),
// bucket/fp [n, n_hashes] i32. All contiguous on the current device.
extern "C" int lsh_hash_launch(const float* x, const float* a, const float* bwr,
                               const float* wr, const int32_t* rm,
                               int32_t* bucket, int32_t* fp, int n, int d,
                               int n_hashes, int m, int u, int fp_bits,
                               cudaStream_t stream) {
  const size_t smem = (size_t)kRows * (d + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lsh_hash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((n + kRows - 1) / kRows, (n_hashes + kHashes - 1) / kHashes);
  lsh_hash_kernel<<<grid, kRows * kHashes, smem, stream>>>(
      x, a, bwr, wr, rm, bucket, fp, n, d, n_hashes, m, u, fp_bits);
  return (int)cudaGetLastError();
}
