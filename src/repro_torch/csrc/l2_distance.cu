// Gathered-candidate squared distances: the query engine's Step-3 epilogue.
//
// Replaces l2_distance_gathered_pallas
// (src/repro/kernels/l2_distance/kernel.py:66): for query q and candidate
// slot s,
//   d2[q, s] = xn2[q, s] - 2 * <coords[q, s, :], qv[q, :]> + qn2[q]
// evaluated in that op order (__fmul_rn/__fsub_rn/__fadd_rn keep nvcc from
// contracting it into an FMA), unclamped; the caller masks and clamps.
//
// What bounds it on the H100: bytes. Each candidate row of D floats is read
// once for 2*D flops (0.5 flop/byte), so device-memory bandwidth is the
// bound; at the SIFT1M configuration (Q = 256, S = 64, D = 128) a radius
// reads 8.4 MB of gathered coordinates. Design: a block serves one query and
// up to 8 candidate rows, a warp per row. The block stages the query vector
// in shared memory; each lane reads 16 B of the candidate row (D = 128 is
// one float4 per lane, a 512 B coalesced read per warp), multiplies
// against the staged query and the warp reduces with shuffles. Several
// blocks per query (grid.y) keep enough rows in flight to cover memory
// latency at small Q. The coordinates stay gathered outside the kernel by
// torch indexing, as jnp.take does outside the Pallas call in the
// reference.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // candidate rows in flight per block

__global__ void __launch_bounds__(kWarps * 32)
l2_gathered_kernel(const float* __restrict__ qv, const float* __restrict__ coords,
                   const float* __restrict__ xn2, const float* __restrict__ qn2,
                   float* __restrict__ out, int s_total, int d, int vec4) {
  extern __shared__ float4 qs4[];  // the query row, d floats
  float* qs = reinterpret_cast<float*>(qs4);
  const int qi = blockIdx.x;
  for (int k = threadIdx.x; k < d; k += blockDim.x) qs[k] = qv[(size_t)qi * d + k];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int stride = gridDim.y * kWarps;
  for (int s = blockIdx.y * kWarps + (threadIdx.x >> 5); s < s_total; s += stride) {
    const size_t o = (size_t)qi * s_total + s;
    const float* c = coords + o * d;
    float dot = 0.f;
    if (vec4) {
      const float4* c4 = reinterpret_cast<const float4*>(c);
      for (int k = lane; k < d / 4; k += 32) {
        const float4 cv = __ldg(c4 + k);
        const float4 q4 = qs4[k];
        dot = fmaf(cv.x, q4.x, dot);
        dot = fmaf(cv.y, q4.y, dot);
        dot = fmaf(cv.z, q4.z, dot);
        dot = fmaf(cv.w, q4.w, dot);
      }
    } else {
      for (int k = lane; k < d; k += 32) dot = fmaf(__ldg(c + k), qs[k], dot);
    }
    for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (lane == 0) {
      out[o] = __fadd_rn(__fsub_rn(__ldg(xn2 + o), __fmul_rn(2.f, dot)),
                         __ldg(qn2 + qi));
    }
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// qv [Q, d], coords [Q, s_total, d], xn2 [Q, s_total], qn2 [Q], out
// [Q, s_total]; f32, contiguous. vec4 != 0 asserts d % 4 == 0 and 16 B-aligned
// qv/coords.
extern "C" int l2_gathered_launch(const float* qv, const float* coords,
                                  const float* xn2, const float* qn2, float* out,
                                  int q_total, int s_total, int d, int vec4,
                                  cudaStream_t stream) {
  int gy = (s_total + kWarps - 1) / kWarps;
  if (gy > 65535) gy = 65535;
  const dim3 grid(q_total, gy);
  const size_t smem = ((size_t)d + 3) / 4 * sizeof(float4);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        l2_gathered_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  l2_gathered_kernel<<<grid, kWarps * 32, smem, stream>>>(qv, coords, xn2, qn2, out,
                                                          s_total, d, vec4);
  return (int)cudaGetLastError();
}
