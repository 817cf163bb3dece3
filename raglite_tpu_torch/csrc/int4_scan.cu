// Stage-1 bucketed max/argmax scan over int4-packed rows (two nibbles per
// byte: low nibble = dims [0, d/2), high nibble = dims [d/2, d)).
//
// Replaces the TPU kernel `_scan_kernel_int4` (raglite_tpu/ops/fused_scan.py:269,
// wrapper `int4_bucket_scan`).  Python binding:
// raglite_tpu_torch/ops/fused_scan.py:int4_bucket_scan, through ctypes.
// Hopper's tensor cores take s8 but not s4, so the nibbles are unpacked in
// registers (per-byte mask, xor and __vsub4) into s8 and fed to
// mma.sync.m16n8k32.s8 (mma_scan.cuh) when d % 128 == 0, or to __dp4a on the
// simple path (scan_common.cuh) otherwise; device memory traffic is the
// packed N*d/2 bytes either way.

#include "mma_scan.cuh"

extern "C" long long rlt_int4_bucket_scan_scratch(int B, int d, int N, int L) {
  return rlt::mma_scratch_elems<true>(B, d, N, L);
}

extern "C" int rlt_int4_bucket_scan(const void* q, const void* packed, const float* rscale,
                                    const float* bias, int B, int d, int N, int L,
                                    float* scores, int* ids, void* scratch, void* stream) {
  if (d % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rlt::mma_scratch_elems<true>(B, d, N, L) > 0)
    return rlt::launch_mma_scan<true>(q, packed, rscale, bias, B, d, N, L, scores, ids, scratch,
                                      s);
  return rlt::launch_bucket_scan<rlt::kInt4>(q, packed, rscale, bias, B, d, N, L, scores, ids,
                                             s);
}
