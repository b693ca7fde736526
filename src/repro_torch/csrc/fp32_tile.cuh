// The port's shared fp32 product mainloop: C[i, j] = sum_k A[i, k] * B[j, k]
// with A [M, K] and B [N, K] row-major (both K-contiguous), in IEEE fp32 FMAs
// on the CUDA cores, followed by a kernel's own epilogue.
//
// Used by lsh_hash.cu (A = queries, B = projection rows) and
// l2_distance_dense.cu (A = queries, B = database rows); each file holds only
// its epilogue, a device functor passed as a template parameter.
//
// Design, for an H100 (132 SMs, 128 fp32 lanes and 128 B/clk of shared
// memory per SM):
//  * Block tile BM x BN over TX x TY threads (tx = thread % TX); each
//    thread keeps a TM x TN register micro-tile (TM = BM/TY, TN = BN/TX),
//    so TM*TN independent accumulators hide FMA latency and every value
//    read from shared memory feeds TM or TN FMAs. Thread (tx, ty) owns rows ty*TM + i and columns
//    g*4*TX + 4*tx + jj (g < TN/4, jj < 4): groups of four adjacent columns,
//    so an epilogue can store them as one float4.
//  * K is walked in slices of kBK = 32 through a ring of STAGES shared-memory
//    stages filled by cp.async: 16-byte copies when every row starts on 16
//    bytes (K % 4 == 0 and aligned bases), 4-byte copies otherwise. The next
//    slices' copies are in flight while the current slice's FMAs run, with
//    one barrier per slice. Rows past M or N and columns past K are
//    zero-filled by the copy itself (source size 0), so ragged shapes need
//    no padding contract; the epilogue guards its stores.
//  * A staged slice is [BM + BN][32] floats (A rows, then B rows), one
//    128-byte row each, read as float4 along K. 16-byte chunk c of staged
//    row R lives at chunk c ^ ((R / 4) % 8): the eight lanes of a quarter
//    warp read B rows 4*tx + jj for consecutive tx, eight different rows
//    from eight different bank groups (TX = 8 or 16) or four rows read
//    twice (TX = 4), and A reads are broadcasts of one or two rows. No
//    padding, so the 16-byte copies stay aligned.
//  * Every sum over k is one sequential fp32 FMA chain per output element
//    (k ascending); zero-filled k add exact zeros.
// No tensor cores: the port's arithmetic contract is IEEE fp32 products
// (TF32 keeps 10 mantissa bits, which moves projections across floor()
// boundaries and reorders near neighbours).
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace fp32_tile {

constexpr int kBK = 32;  // K slice: one 128-byte shared-memory row per operand row

// Float offset of 16-byte chunk `chunk` of staged row R.
__device__ __forceinline__ int swz(int R, int chunk) {
  return R * kBK + ((chunk ^ ((R >> 2) & 7)) << 2);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Tile shape. With TX = 4, 8 or 16 a quarter warp covers whole runs of tx
// (the bank-conflict argument above); TX = 12 costs a 2-way conflict on some
// B reads. MIN_BLOCKS feeds __launch_bounds__.
template <int BM_, int BN_, int TX_, int TY_, int STAGES_, int MIN_BLOCKS_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, TX = TX_, TY = TY_;
  static constexpr int STAGES = STAGES_, kMinBlocks = MIN_BLOCKS_;
  static constexpr int kThreads = TX * TY;
  static constexpr int TM = BM / TY;
  static constexpr int TN = BN / TX;
  static constexpr int kRows = BM + BN;  // staged rows per slice
  static constexpr int kStageFloats = kRows * kBK;
  static constexpr size_t kSmemBytes = size_t(STAGES) * kStageFloats * sizeof(float);
  static_assert(TX == 4 || TX == 8 || TX == 12 || TX == 16, "TX must be 4, 8, 12 or 16");
  static_assert(BM % TY == 0 && TN % 4 == 0 && TN * TX == BN, "ragged micro-tile");
  static_assert(STAGES >= 2, "the ring needs two stages at least");

  __device__ __forceinline__ static int row(int ty, int i) { return ty * TM + i; }
  __device__ __forceinline__ static int col(int tx, int j) {
    return (j >> 2) * (4 * TX) + tx * 4 + (j & 3);
  }
};

// Issue the copies of one K slice (columns k0 .. k0+31) of the block's A rows
// [m0, m0+BM) and B rows [n0, n0+BN) into stage `st`.
template <class T, bool VEC4>
__device__ __forceinline__ void load_slice(float* st, const float* __restrict__ A,
                                           const float* __restrict__ B, int M, int N,
                                           int K, int m0, int n0, int k0, int tid) {
  if constexpr (VEC4) {
    constexpr int kChunks = T::kRows * (kBK / 4);
#pragma unroll
    for (int c = tid; c < kChunks; c += T::kThreads) {
      const int R = c >> 3, q = c & 7;
      const int k = k0 + q * 4;
      const bool is_a = R < T::BM;
      const int g = is_a ? m0 + R : n0 + (R - T::BM);
      const float* base = is_a ? A : B;
      const bool ok = g < (is_a ? M : N) && k < K;
      cp_async16(st + swz(R, q), ok ? base + (size_t)g * K + k : base, ok);
    }
  } else {
    constexpr int kElems = T::kRows * kBK;
    for (int e = tid; e < kElems; e += T::kThreads) {
      const int R = e >> 5, kk = e & 31;
      const int k = k0 + kk;
      const bool is_a = R < T::BM;
      const int g = is_a ? m0 + R : n0 + (R - T::BM);
      const float* base = is_a ? A : B;
      const bool ok = g < (is_a ? M : N) && k < K;
      cp_async4(st + swz(R, kk >> 2) + (kk & 3), ok ? base + (size_t)g * K + k : base, ok);
    }
  }
}

// acc += the block's product over one staged slice: per 16-byte K chunk,
// TM float4s of A held in registers against each float4 of B.
template <class T>
__device__ __forceinline__ void fma_slice(const float* st, int tx, int ty,
                                          float (&acc)[T::TM][T::TN]) {
#pragma unroll
  for (int q = 0; q < kBK / 4; ++q) {
    float4 a[T::TM];
#pragma unroll
    for (int i = 0; i < T::TM; ++i)
      a[i] = *reinterpret_cast<const float4*>(st + swz(T::row(ty, i), q));
#pragma unroll
    for (int j = 0; j < T::TN; ++j) {
      const float4 b = *reinterpret_cast<const float4*>(st + swz(T::BM + T::col(tx, j), q));
#pragma unroll
      for (int i = 0; i < T::TM; ++i) {
        float& c = acc[i][j];
        c = fmaf(a[i].x, b.x, c);
        c = fmaf(a[i].y, b.y, c);
        c = fmaf(a[i].z, b.z, c);
        c = fmaf(a[i].w, b.w, c);
      }
    }
  }
}

// The kernel: mainloop, then epi.finish. `Epi` provides
//   template <class T> static constexpr int extra_floats();
//     shared memory it needs beside the ring, for operands of its own;
//   template <class T> __device__ void stage(float* extra, int n0, int tid);
//     issues cp.async copies of those operands into `extra`; they join the
//     first K slice's group, so they land with it and cost no extra wait;
//   template <class T> __device__ void on_slice(const float* stage, int tid);
//     called by every thread on every staged slice before its FMAs (it may
//     read the stage, not write it);
//   template <class T> __device__ void finish(float (&acc)[T::TM][T::TN],
//       float* smem, int m0, int n0, int tx, int ty, int tid);
//     called once the ring is drained: the ring (T::kSmemBytes) is free for
//     it as scratch, and its staged operands follow the ring.
template <class T, bool VEC4, class Epi>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
fp32_tile_kernel(const float* __restrict__ A, const float* __restrict__ B, int M, int N,
                 int K, Epi epi) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int tx = tid % T::TX, ty = tid / T::TX;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;

  Epi e = epi;  // the epilogue's per-thread state lives in registers
  float acc[T::TM][T::TN];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.f;

  const int nk = (K + kBK - 1) / kBK;
  e.template stage<T>(smem + T::STAGES * T::kStageFloats, n0, tid);
#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < nk)
      load_slice<T, VEC4>(smem + s * T::kStageFloats, A, B, M, N, K, m0, n0, s * kBK, tid);
    cp_async_commit();
  }
  for (int s = 0; s < nk; ++s) {
    cp_async_wait<T::STAGES - 2>();  // slice s has landed (this thread's copies)
    __syncthreads();                 // ... everyone's; and slice s-1 is consumed
    const int sn = s + T::STAGES - 1;
    if (sn < nk)
      load_slice<T, VEC4>(smem + (sn % T::STAGES) * T::kStageFloats, A, B, M, N, K, m0,
                          n0, sn * kBK, tid);
    cp_async_commit();
    const float* st = smem + (s % T::STAGES) * T::kStageFloats;
    e.template on_slice<T>(st, tid);
    fma_slice<T>(st, tx, ty, acc);
  }
  cp_async_wait<0>();
  __syncthreads();
  e.template finish<T>(acc, smem, m0, n0, tx, ty, tid);
}

// Launch on `stream`: grid (ceil(N/BN), ceil(M/BM)), the ring's and the
// epilogue's dynamic shared memory (opted in above 48 KB). Returns
// cudaGetLastError().
template <class T, bool VEC4, class Epi>
cudaError_t launch(const float* A, const float* B, int M, int N, int K, const Epi& epi,
                   cudaStream_t stream) {
  const int gy = (M + T::BM - 1) / T::BM;
  if (gy > 65535) return cudaErrorInvalidConfiguration;
  auto kern = fp32_tile_kernel<T, VEC4, Epi>;
  const size_t smem = T::kSmemBytes + sizeof(float) * Epi::template extra_floats<T>();
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((N + T::BN - 1) / T::BN, gy);
  kern<<<grid, T::kThreads, smem, stream>>>(A, B, M, N, K, epi);
  return cudaGetLastError();
}

// True when every row of a [rows, K] fp32 matrix at p starts on 16 bytes.
inline bool rows_aligned16(const void* p, int K) {
  return K % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace fp32_tile
