// Single-stage bucketed max/argmax scan over int8, bf16 or f32 rows.
//
// Replaces the TPU kernel `_scan_kernel` (raglite_tpu/ops/fused_scan.py:65,
// wrapper `bucketed_max_scan`).  Python binding:
// raglite_tpu_torch/ops/fused_scan.py:bucketed_max_scan, through ctypes.
// int8 rows with d % 64 == 0 take the tensor-core path (mma_scan.cuh); other
// int8 widths and bf16/f32 rows take the simple path (scan_common.cuh).

#include "mma_scan.cuh"

// Scratch elements (floats, then as many ints) a call needs; 0 for none.
extern "C" long long rlt_bucketed_max_scan_scratch(int kind, int B, int d, int N, int L) {
  return kind == rlt::kInt8 ? rlt::mma_scratch_elems<false>(B, d, N, L) : 0;
}

extern "C" int rlt_bucketed_max_scan(int kind, const void* q, const void* rows,
                                     const float* rscale, const float* bias, int B, int d,
                                     int N, int L, float* scores, int* ids, void* scratch,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case rlt::kInt8:
      if (d % 4) return (int)cudaErrorInvalidValue;
      if (rlt::mma_scratch_elems<false>(B, d, N, L) > 0)
        return rlt::launch_mma_scan<false>(q, rows, rscale, bias, B, d, N, L, scores, ids,
                                           scratch, s);
      return rlt::launch_bucket_scan<rlt::kInt8>(q, rows, rscale, bias, B, d, N, L, scores,
                                                 ids, s);
    case rlt::kBf16:
      if (d % 2) return (int)cudaErrorInvalidValue;
      return rlt::launch_bucket_scan<rlt::kBf16>(q, rows, rscale, bias, B, d, N, L, scores,
                                                 ids, s);
    case rlt::kF32:
      return rlt::launch_bucket_scan<rlt::kF32>(q, rows, rscale, bias, B, d, N, L, scores,
                                                ids, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
