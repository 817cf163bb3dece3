// Tensor-core body of the integer bucketed scans (int8 rows, and int4 rows
// unpacked in registers): the path the index takes at its usual widths.
//
// Semantics are those of scan_common.cuh: per query b and bucket j, the max
// over steps s of dot(q[b], row s*L + j) * rscale + bias, the lowest step
// winning a tie, with the same __fmul_rn/__fadd_rn epilogue; the int32
// products are exact in any order, so the result is bit-identical to the
// plain PyTorch version.
//
// Design.  The scan is bound by the bytes of the rows (N*d for int8, N*d/2
// for int4) at B <= 32, so the work is shaped for memory-level parallelism:
// - a warp owns 16 consecutive buckets and a contiguous range of steps; at
//   each step its 16 rows are 16 consecutive rows in device memory, read
//   with 16-byte loads straight into the A fragments of
//   mma.sync.m16n8k32.s8 (no shared-memory staging of rows);
// - the step range is split across warps (grid.y), so that about two
//   thousand warps are in flight whatever L is; each split writes its
//   per-bucket best to scratch and a second small kernel merges the splits
//   in step order with a strict `>`, which keeps the lowest-step-wins rule;
// - the queries (a tile of up to 32, zero-padded to whole n-tiles of 8)
//   sit in shared memory and feed the B fragments.
// The k order inside an mma is permuted consistently for A and B (a thread
// feeds the 16 contiguous bytes it loaded to two mmas); a dot product does
// not depend on the order of its terms.

#pragma once

#include "scan_common.cuh"

namespace rlt {

constexpr int kMmaWarps = 4;                 // warps per block
constexpr int kMmaBuckets = 16 * kMmaWarps;  // buckets per block
constexpr int kQueryPad = 64;                // bytes of padding per query row
constexpr int kTargetWarps = 2112;           // ~16 warps on each of 132 SMs
constexpr int kLoadChunk = 4;                // 64-byte k-blocks loaded per batch

__device__ inline void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                              uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ inline uint4 unpack_lo(uint4 p) {
  return make_uint4(lo_nibbles(p.x), lo_nibbles(p.y), lo_nibbles(p.z), lo_nibbles(p.w));
}
__device__ inline uint4 unpack_hi(uint4 p) {
  return make_uint4(hi_nibbles(p.x), hi_nibbles(p.y), hi_nibbles(p.z), hi_nibbles(p.w));
}

// One 64-byte k-block: rows g and g+8 (16 int8 each, this thread's slice),
// the queries' matching 16 bytes at byte offset `qoff` of each query row.
template <int NT>
__device__ inline void mma_kblock(int (&acc)[NT][4], uint4 ra, uint4 rb, const uint8_t* sq,
                                  int qstride, int g, int qoff) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const uint4 qv = *reinterpret_cast<const uint4*>(sq + (size_t)(nt * 8 + g) * qstride + qoff);
    mma_s8(acc[nt], ra.x, rb.x, ra.y, rb.y, qv.x, qv.y);
    mma_s8(acc[nt], ra.z, rb.z, ra.w, rb.w, qv.z, qv.w);
  }
}

// grid = (L / kMmaBuckets, splits, ceil(B / 32)); block = 32 * kMmaWarps.
// Writes part_scores/part_ids [splits, B, L].
template <bool INT4, int NT>
__global__ void __launch_bounds__(32 * kMmaWarps)
mma_scan_kernel(const uint8_t* __restrict__ q, const uint8_t* __restrict__ rows,
                const float* __restrict__ rscale, const float* __restrict__ bias, int B, int d,
                int L, int steps, int steps_per_split, float* __restrict__ part_scores,
                int* __restrict__ part_ids) {
  extern __shared__ __align__(16) uint8_t sq[];
  const int qstride = d + kQueryPad;
  const int q0 = blockIdx.z * 32;
  const int nq = NT * 8;
  // Query tile (int8 bytes), zero-padded past B, 16 bytes at a time.
  for (int i = threadIdx.x; i < nq * (d / 16); i += blockDim.x) {
    const int qi = i / (d / 16), c = i - qi * (d / 16);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (q0 + qi < B) v = *reinterpret_cast<const uint4*>(q + (size_t)(q0 + qi) * d + c * 16);
    *reinterpret_cast<uint4*>(sq + (size_t)qi * qstride + c * 16) = v;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int j0 = blockIdx.x * kMmaBuckets + warp * 16;
  const int s_begin = blockIdx.y * steps_per_split;
  const int s_end = min(steps, s_begin + steps_per_split);
  const int row_bytes = INT4 ? d / 2 : d;

  float best[NT][4];
  int best_id[NT][4];
  for (int s = s_begin; s < s_end; ++s) {
    const size_t row_a = (size_t)s * L + j0 + g;  // row of c[0], c[1]
    const uint8_t* pa = rows + row_a * row_bytes + t * 16;
    const uint8_t* pb = pa + (size_t)8 * row_bytes;  // row_a + 8: c[2], c[3]
    int acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[nt][c] = 0;
    // Issue the loads of kLoadChunk k-blocks before their mmas, so that
    // each warp keeps 2 * kLoadChunk 16-byte loads per thread in flight.
    const int kblocks = row_bytes / 64;
    for (int kb0 = 0; kb0 < kblocks; kb0 += kLoadChunk) {
      uint4 ra[kLoadChunk], rb[kLoadChunk];
#pragma unroll
      for (int i = 0; i < kLoadChunk; ++i)
        if (kb0 + i < kblocks) {
          ra[i] = __ldg(reinterpret_cast<const uint4*>(pa + (kb0 + i) * 64));
          rb[i] = __ldg(reinterpret_cast<const uint4*>(pb + (kb0 + i) * 64));
        }
#pragma unroll
      for (int i = 0; i < kLoadChunk; ++i)
        if (kb0 + i < kblocks) {
          const int off = (kb0 + i) * 64 + t * 16;
          if (INT4) {
            // Packed byte p holds dim p (low nibble) and dim d/2 + p (high).
            mma_kblock<NT>(acc, unpack_lo(ra[i]), unpack_lo(rb[i]), sq, qstride, g, off);
            mma_kblock<NT>(acc, unpack_hi(ra[i]), unpack_hi(rb[i]), sq, qstride, g, d / 2 + off);
          } else {
            mma_kblock<NT>(acc, ra[i], rb[i], sq, qstride, g, off);
          }
        }
    }
    const float rs_a = rscale[row_a], rs_b = rscale[row_a + 8];
    const float bs_a = bias[row_a], bs_b = bias[row_a + 8];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool hi = c >= 2;
        const float score =
            __fadd_rn(__fmul_rn((float)acc[nt][c], hi ? rs_b : rs_a), hi ? bs_b : bs_a);
        if (s == s_begin || score > best[nt][c]) {
          best[nt][c] = score;
          best_id[nt][c] = (int)(hi ? row_a + 8 : row_a);
        }
      }
  }
  if (s_begin >= s_end) return;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int b = q0 + nt * 8 + 2 * t + (c & 1);
      const int j = j0 + g + (c >= 2 ? 8 : 0);
      if (b < B) {
        const size_t o = ((size_t)blockIdx.y * B + b) * L + j;
        part_scores[o] = best[nt][c];
        part_ids[o] = best_id[nt][c];
      }
    }
}

// Merge the splits in step order: the first split's value stands unless a
// later one is strictly greater.
__global__ void merge_splits_kernel(const float* __restrict__ part_scores,
                                    const int* __restrict__ part_ids, int splits, int BL,
                                    float* __restrict__ scores, int* __restrict__ ids) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= BL) return;
  float best = part_scores[i];
  int best_id = part_ids[i];
  for (int sp = 1; sp < splits; ++sp) {
    const float v = part_scores[(size_t)sp * BL + i];
    if (v > best) {
      best = v;
      best_id = part_ids[(size_t)sp * BL + i];
    }
  }
  scores[i] = best;
  ids[i] = best_id;
}

// Whether the tensor-core path takes these widths.
template <bool INT4>
__host__ inline bool mma_scan_fits(int d, int L) {
  return L % kMmaBuckets == 0 && (INT4 ? d % 128 == 0 : d % 64 == 0);
}

// Split count so that about kTargetWarps warps run; never an empty split.
__host__ inline void mma_scan_splits(int L, int steps, int* splits, int* steps_per_split) {
  const int tiles = L / 16;
  int want = (kTargetWarps + tiles - 1) / tiles;
  want = want < 1 ? 1 : (want > steps ? steps : want);
  *steps_per_split = (steps + want - 1) / want;
  *splits = (steps + *steps_per_split - 1) / *steps_per_split;
}

template <bool INT4, int NT>
int launch_mma_scan_nt(const void* q, const void* rows, const float* rscale, const float* bias,
                       int B, int d, int L, int steps, int splits, int steps_per_split,
                       float* part_scores, int* part_ids, cudaStream_t stream) {
  const size_t smem = (size_t)NT * 8 * (d + kQueryPad);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mma_scan_kernel<INT4, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(L / kMmaBuckets, splits, (B + 31) / 32);
  mma_scan_kernel<INT4, NT><<<grid, 32 * kMmaWarps, smem, stream>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(rows), rscale, bias, B, d, L,
      steps, steps_per_split, part_scores, part_ids);
  return (int)cudaGetLastError();
}

// Scan + merge.  `scratch` holds splits * B * L floats and as many ints
// (the wrapper sizes it with rlt_*_scratch_elems).
template <bool INT4>
int launch_mma_scan(const void* q, const void* rows, const float* rscale, const float* bias,
                    int B, int d, int N, int L, float* scores, int* ids, void* scratch,
                    cudaStream_t stream) {
  if (B <= 0 || N < L || N % L != 0 || !mma_scan_fits<INT4>(d, L))
    return (int)cudaErrorInvalidValue;
  const int steps = N / L;
  int splits, per;
  mma_scan_splits(L, steps, &splits, &per);
  float* part_scores = static_cast<float*>(scratch);
  int* part_ids = reinterpret_cast<int*>(part_scores + (size_t)splits * B * L);
  const int nt = B >= 32 ? 4 : (B + 7) / 8;
  int err;
  switch (nt) {
    case 1: err = launch_mma_scan_nt<INT4, 1>(q, rows, rscale, bias, B, d, L, steps, splits, per, part_scores, part_ids, stream); break;
    case 2: err = launch_mma_scan_nt<INT4, 2>(q, rows, rscale, bias, B, d, L, steps, splits, per, part_scores, part_ids, stream); break;
    case 3: err = launch_mma_scan_nt<INT4, 3>(q, rows, rscale, bias, B, d, L, steps, splits, per, part_scores, part_ids, stream); break;
    default: err = launch_mma_scan_nt<INT4, 4>(q, rows, rscale, bias, B, d, L, steps, splits, per, part_scores, part_ids, stream); break;
  }
  if (err != 0) return err;
  const int BL = B * L;
  merge_splits_kernel<<<(BL + 255) / 256, 256, 0, stream>>>(part_scores, part_ids, splits, BL,
                                                             scores, ids);
  return (int)cudaGetLastError();
}

// Elements of each scratch array (floats, then as many ints) the
// tensor-core path needs; 0 when it does not take these widths.
template <bool INT4>
long long mma_scratch_elems(int B, int d, int N, int L) {
  if (B <= 0 || L <= 0 || N < L || N % L != 0 || !mma_scan_fits<INT4>(d, L)) return 0;
  int splits, per;
  mma_scan_splits(L, N / L, &splits, &per);
  return (long long)splits * B * L;
}

}  // namespace rlt
