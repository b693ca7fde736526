// Block-row gather + fingerprint filter over the blockified bucket store.
//
// Replaces bucket_probe_pallas (src/repro/kernels/bucket_probe/kernel.py:38):
// for each of G requests g, read row block_rows[g] of ids_blocks and
// fps_blocks [NB, BLKp] and write
//   out[g, c] = ids[row, c]  if fps[row, c] == qfp[g] and ids[row, c] != INVALID
//               INVALID      otherwise
// to out [G, BLKp] int32.
//
// What bounds it on the H100: bytes. Each request moves two 416 B rows in
// (BLKp = 104 at block_objs = 99) and one row out, with one compare and one
// select per lane, so device-memory bandwidth (3.35 TB/s) is the bound; at
// the SIFT1M configuration a radius probes G = 16384 rows (~20 MB of
// traffic). Design: one warp per request. The warp loads its own row index
// and query fingerprint (this replaces the TPU's scalar prefetch, which
// steered the DMA from the index list), then reads the two rows as int4: a
// row is 26 int4s, one per lane, so each row arrives in one coalesced
// 416 B transaction group and the output row leaves the same way. The
// caller guarantees 0 <= block_rows[g] < NB (the query engine builds them
// from chain heads, with spare row 0 as padding).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // requests per block
constexpr int32_t kInvalid = 0x7FFFFFFF;

__device__ __forceinline__ int32_t pick(int32_t id, int32_t f, int32_t q) {
  return (f == q && id != kInvalid) ? id : kInvalid;
}

__global__ void __launch_bounds__(kWarps * 32)
bucket_probe_kernel(const int32_t* __restrict__ block_rows,
                    const int32_t* __restrict__ qfp,
                    const int4* __restrict__ ids, const int4* __restrict__ fps,
                    int4* __restrict__ out, int g_total, int row_vecs) {
  const int g = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (g >= g_total) return;
  const int lane = threadIdx.x & 31;
  const size_t row = (size_t)__ldg(block_rows + g);
  const int32_t q = __ldg(qfp + g);
  const int4* ir = ids + row * row_vecs;
  const int4* fr = fps + row * row_vecs;
  int4* o = out + (size_t)g * row_vecs;
  for (int c = lane; c < row_vecs; c += 32) {
    const int4 i4 = __ldg(ir + c);
    const int4 f4 = __ldg(fr + c);
    int4 r;
    r.x = pick(i4.x, f4.x, q);
    r.y = pick(i4.y, f4.y, q);
    r.z = pick(i4.z, f4.z, q);
    r.w = pick(i4.w, f4.w, q);
    o[c] = r;
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// block_rows/qfp [g_total] i32; ids/fps [NB, blkp] i32 and out [g_total, blkp]
// i32, contiguous and 16 B-aligned, blkp % 4 == 0.
extern "C" int bucket_probe_launch(const int32_t* block_rows, const int32_t* qfp,
                                   const int32_t* ids, const int32_t* fps,
                                   int32_t* out, int g_total, int blkp,
                                   cudaStream_t stream) {
  const int blocks = (g_total + kWarps - 1) / kWarps;
  bucket_probe_kernel<<<blocks, kWarps * 32, 0, stream>>>(
      block_rows, qfp, reinterpret_cast<const int4*>(ids),
      reinterpret_cast<const int4*>(fps), reinterpret_cast<int4*>(out),
      g_total, blkp / 4);
  return (int)cudaGetLastError();
}
