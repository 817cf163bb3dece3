// Shared body of the two bucketed max/argmax scans (bucket_scan.cu,
// int4_scan.cu).
//
// Semantics (the TPU kernels `_scan_kernel` and `_scan_kernel_int4` of
// raglite_tpu/ops/fused_scan.py): row n belongs to bucket n mod L; for every
// query b and bucket j the kernel walks the steps s = 0 .. N/L - 1 in order,
// scores row s*L + j as
//     score = dot(q[b], row) * rscale[row] + bias[row]
// and keeps a running max and argmax with a strict `>` merge, so the lowest
// step wins a tie.  Outputs are [B, L] f32 scores and [B, L] i32 row ids.
//
// Design (simple and correct first): one block owns TB consecutive buckets
// and a tile of QT queries.  The query tile sits in shared memory for the
// whole scan; at every step the block copies its TB rows (contiguous in
// device memory) into shared memory with coalesced 32-bit loads, then each
// thread scores its bucket against QPT queries, reusing every row word
// across those queries.  Integer rows use __dp4a with int32 accumulation;
// the epilogue is __fmul_rn then __fadd_rn so the f32 score rounds exactly as
// the plain PyTorch version's two ops do (no FMA contraction).
//
// Bound: the scan reads each row byte once, so at B <= 32 it is bound by
// device memory bytes (N*d for int8, N*d/2 for int4).  This first version
// neither overlaps the copy of step s+1 with the compute of step s nor uses
// the tensor cores; both are later work.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rlt {

constexpr int kThreads = 128;
constexpr int kBucketsPerBlock = 16;                       // TB
constexpr int kQueriesPerBlock = 32;                       // QT
constexpr int kLanes = kThreads / kBucketsPerBlock;        // 8 query lanes
constexpr int kQueriesPerThread = kQueriesPerBlock / kLanes;  // 4

enum RowKind { kInt8 = 0, kInt4 = 1, kBf16 = 2, kF32 = 3 };

// 32-bit words per stored row.
template <int KIND>
__host__ __device__ inline int row_words(int d) {
  if (KIND == kInt8) return d / 4;
  if (KIND == kInt4) return d / 8;
  if (KIND == kBf16) return d / 2;
  return d;
}

// 32-bit words per query row in shared memory (int8 bytes or f32 values).
template <int KIND>
__host__ __device__ inline int query_words(int d) {
  return (KIND == kInt8 || KIND == kInt4) ? d / 4 : d;
}

// Row strides are padded by one word so the TB rows of a step fall in
// different shared-memory banks.
template <int KIND>
__host__ inline size_t smem_bytes(int d) {
  return sizeof(uint32_t) * ((size_t)kQueriesPerBlock * (query_words<KIND>(d) + 1) +
                             (size_t)kBucketsPerBlock * (row_words<KIND>(d) + 1));
}

__device__ inline float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ inline float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

// Signed int4 nibbles of each byte, sign-extended into int8 lanes:
// (n ^ 8) - 8 maps 0..15 onto 0..7, -8..-1, per byte.
__device__ inline int lo_nibbles(uint32_t p) {
  return (int)__vsub4((p & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}
__device__ inline int hi_nibbles(uint32_t p) {
  return (int)__vsub4(((p >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

// q: int8 [B, d] for the integer kinds, f32 [B, d] otherwise.
// rows: [N, row_words*4 bytes]; rscale, bias: [N] f32.
// grid = (L / TB, ceil(B / QT)), block = kThreads, dynamic smem = smem_bytes.
template <int KIND>
__global__ void __launch_bounds__(kThreads)
bucket_scan_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ rows,
                   const float* __restrict__ rscale, const float* __restrict__ bias,
                   int B, int d, int N, int L, float* __restrict__ out_scores,
                   int* __restrict__ out_ids) {
  extern __shared__ uint32_t smem[];
  const int qw = query_words<KIND>(d);
  const int qstride = qw + 1;
  const int rw = row_words<KIND>(d);
  const int rstride = rw + 1;
  uint32_t* sq = smem;
  uint32_t* sr = smem + (size_t)kQueriesPerBlock * qstride;

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kBucketsPerBlock;
  const int q0 = blockIdx.y * kQueriesPerBlock;

  // Query tile, zero-filled past B.
  for (int i = tid; i < kQueriesPerBlock * qw; i += kThreads) {
    const int qi = i / qw, w = i - qi * qw;
    sq[qi * qstride + w] = (q0 + qi < B) ? q[(size_t)(q0 + qi) * qw + w] : 0u;
  }

  const int jj = tid % kBucketsPerBlock;
  const int lane = tid / kBucketsPerBlock;
  float best[kQueriesPerThread];
  int best_id[kQueriesPerThread];
#pragma unroll
  for (int k = 0; k < kQueriesPerThread; ++k) {
    best[k] = 0.0f;
    best_id[k] = 0;
  }

  const int steps = N / L;
  for (int s = 0; s < steps; ++s) {
    const size_t row0 = (size_t)s * L + j0;
    __syncthreads();  // previous step's readers are done with sr
    const uint32_t* src = rows + row0 * rw;
    for (int i = tid; i < kBucketsPerBlock * rw; i += kThreads) {
      const int r = i / rw, w = i - r * rw;
      sr[r * rstride + w] = src[i];
    }
    __syncthreads();

    const uint32_t* r = sr + jj * rstride;
    const size_t row = row0 + jj;
    float sims[kQueriesPerThread];
    if (KIND == kInt8 || KIND == kInt4) {
      int acc[kQueriesPerThread];
#pragma unroll
      for (int k = 0; k < kQueriesPerThread; ++k) acc[k] = 0;
      if (KIND == kInt8) {
        for (int w = 0; w < rw; ++w) {
          const int rv = (int)r[w];
#pragma unroll
          for (int k = 0; k < kQueriesPerThread; ++k)
            acc[k] = __dp4a(rv, (int)sq[(lane + kLanes * k) * qstride + w], acc[k]);
        }
      } else {
        // Packed byte b holds dim b (low nibble) and dim d/2 + b (high).
        const int half = d / 8;  // query words per half row
        for (int w = 0; w < rw; ++w) {
          const uint32_t p = r[w];
          const int lo = lo_nibbles(p), hi = hi_nibbles(p);
#pragma unroll
          for (int k = 0; k < kQueriesPerThread; ++k) {
            const uint32_t* qk = sq + (lane + kLanes * k) * qstride;
            acc[k] = __dp4a(lo, (int)qk[w], acc[k]);
            acc[k] = __dp4a(hi, (int)qk[half + w], acc[k]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kQueriesPerThread; ++k) sims[k] = (float)acc[k];
    } else {
      float acc[kQueriesPerThread];
#pragma unroll
      for (int k = 0; k < kQueriesPerThread; ++k) acc[k] = 0.0f;
      if (KIND == kBf16) {
        for (int w = 0; w < rw; ++w) {
          const uint32_t rv = r[w];
          const float a = bf16_lo(rv), b = bf16_hi(rv);
#pragma unroll
          for (int k = 0; k < kQueriesPerThread; ++k) {
            const float* qk = reinterpret_cast<const float*>(sq + (lane + kLanes * k) * qstride);
            acc[k] = fmaf(a, qk[2 * w], acc[k]);
            acc[k] = fmaf(b, qk[2 * w + 1], acc[k]);
          }
        }
      } else {
        for (int w = 0; w < rw; ++w) {
          const float a = __uint_as_float(r[w]);
#pragma unroll
          for (int k = 0; k < kQueriesPerThread; ++k)
            acc[k] = fmaf(a, __uint_as_float(sq[(lane + kLanes * k) * qstride + w]), acc[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kQueriesPerThread; ++k) sims[k] = acc[k];
    }

    const float rs = rscale[row], bs = bias[row];
#pragma unroll
    for (int k = 0; k < kQueriesPerThread; ++k) {
      const float score = __fadd_rn(__fmul_rn(sims[k], rs), bs);
      if (s == 0 || score > best[k]) {
        best[k] = score;
        best_id[k] = (int)row;
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kQueriesPerThread; ++k) {
    const int b = q0 + lane + kLanes * k;
    if (b < B) {
      out_scores[(size_t)b * L + j0 + jj] = best[k];
      out_ids[(size_t)b * L + j0 + jj] = best_id[k];
    }
  }
}

// Host launcher with a plain C interface: returns a cudaError_t value (0 on
// success).  The shapes were checked by the Python wrapper; the launcher
// re-checks what would make the kernel read or write out of bounds.
template <int KIND>
int launch_bucket_scan(const void* q, const void* rows, const float* rscale,
                       const float* bias, int B, int d, int N, int L, float* scores,
                       int* ids, cudaStream_t stream) {
  if (B <= 0 || d <= 0 || L <= 0 || N < L || N % L != 0 || L % kBucketsPerBlock != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<KIND>(d);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bucket_scan_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(L / kBucketsPerBlock, (B + kQueriesPerBlock - 1) / kQueriesPerBlock);
  bucket_scan_kernel<KIND><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(rows), rscale, bias, B,
      d, N, L, scores, ids);
  return (int)cudaGetLastError();
}

}  // namespace rlt
