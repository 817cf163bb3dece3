// Grouped-query attention of a few query positions over the resident KV cache:
// the decode step (T = 1) and the speculative verify window (T <= 16).
//
// Replaces the TPU kernels `_decode_attn_kernel` (raglite_tpu/ops/decode_attention.py:37,
// wrapper `gqa_decode_attention`) and `_verify_attn_kernel` (:140, wrapper
// `gqa_verify_attention`).  Python binding: raglite_tpu_torch/ops/decode_attention.py,
// through ctypes.
//
// Semantics.  q [B, KVH, REP, T, hd] bf16 (query row r = rep * T + t), k and v
// [B, KVH, hd, S] bf16 with the sequence minor-most, pos0 [B] int32.  Row r of
// group g in batch row b sits at position p = pos0[b] + r % T and attends key s
// iff s <= p and, with a window w > 0, s > p - w.  For each row:
//     logits[s] = dot(q, k[:, s]) * scale          (f32 accumulation)
//     logits    = softcap * tanh(logits / softcap)  (softcap > 0 only)
//     logits[s] = -1e9 where s is masked
//     out       = sum_s softmax(logits)[s] * v[:, s]   -> [B, KVH, REP, T, hd] f32
//
// Design.  The TPU grid is (B, KVH): at B = 1 that is 4 programs on the `large`
// preset, which would leave 128 of 132 SMs idle.  So the sequence is split
// (flash-decoding): one block per (b, g, split of kKeys keys) stages the
// split's K and V tiles in shared memory once for every row of the group,
// computes the split's logits, its max m, the sum l of exp(logit - m) and the
// unnormalised sum of bf16(exp(logit - m)) * v; a second small kernel merges
// the splits in split order.
//
// Verify row t must equal the decode kernel at position pos0 + t bit for bit
// (the reason the TPU verify kernel exists: greedy speculation is exact only if
// both forwards share attention numerics).  So:
// - split boundaries depend on S only (kKeys keys each), never on positions;
// - every per-row sum runs in a fixed order with explicit fmaf/__fadd_rn (no
//   contraction choices left to the compiler), and a row's arithmetic does not
//   depend on T or on which other rows share the block;
// - the merge visits the splits in ascending order.
// Splits wholly outside a row's valid keys contribute exactly 0 to it (their
// masked logits underflow against the row's max), so the merge skips them and a
// block none of whose rows has a valid key in its split exits before loading
// anything: the bytes read follow the valid keys.  A row with no valid key at
// all (only possible for positions >= S + window - 1) keeps every split, so its
// softmax is the plain version's uniform one.
//
// Rounding.  The plain version (like the JAX kernel) rounds the NORMALISED
// probabilities to bf16 before the PV product; with splits this kernel rounds
// the unnormalised exp(logit - m_split) instead.  Both are within a relative
// 2^-8 of the exact probability, so an output differs by at most
// 2^-7 * sum_s p_s |v_s|, and in practice by far less (attention_tolerance in
// ops/decode_attention.py states the limit).
//
// Bound: bytes.  Every valid key's K and V column is read once (2 * hd * 2
// bytes per key and group), against 4 * REP * T * hd flops per key; at T <= 16
// that is under 80 flops a byte, far below the card's ~295 bf16 flops a byte.
// This first version stages tiles with plain loads and does the dot products
// on the FMA units; cp.async/TMA double buffering is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kKeys = 128;            // keys per split; boundaries depend on S only
constexpr int kThreads = 128;         // one thread per key of the split
constexpr int kRowChunk = 32;         // query rows staged in shared memory at a time
constexpr int kRowGroup = 8;          // rows accumulated together in registers
constexpr int kVStride = kKeys + 2;   // bf16 per staged V row: an odd word stride
constexpr int kMaxHd = 256;

__device__ __forceinline__ float bf16_bits_to_f32(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

__device__ __forceinline__ float round_to_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Whether split `sp` can contribute to a row at position `pos`: it overlaps the
// row's valid keys [lo, hi], or the row has none (then every split counts).
__device__ __forceinline__ bool split_live(int pos, int window, int S, int sp) {
  const int lo = window > 0 ? max(0, pos - window + 1) : 0;
  const int hi = min(pos, S - 1);
  if (lo > hi) return true;
  const int s0 = sp * kKeys;
  const int s1 = min(s0 + kKeys, S) - 1;
  return s0 <= hi && s1 >= lo;
}

__host__ __device__ inline size_t smem_bytes(int hd) {
  return sizeof(uint16_t) * ((size_t)hd * kKeys + (size_t)hd * kVStride) +
         sizeof(float) * ((size_t)kRowChunk * hd + (size_t)kRowChunk * kKeys);
}

// grid = (nsplit, KVH, B), block = kThreads.
// part_ml [B, KVH, nsplit, R, 2] (m, l); part_acc [B, KVH, nsplit, R, hd].
__global__ void __launch_bounds__(kThreads)
split_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
             const uint16_t* __restrict__ v, const int* __restrict__ pos0, int KVH, int R,
             int T, int hd, int S, int nsplit, float scale, float softcap, int window,
             bool vec, float* __restrict__ part_ml, float* __restrict__ part_acc) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* ks = reinterpret_cast<uint16_t*>(smem);                 // [hd][kKeys]
  uint16_t* vs = ks + (size_t)hd * kKeys;                            // [hd][kVStride]
  float* qs = reinterpret_cast<float*>(vs + (size_t)hd * kVStride);  // [kRowChunk][hd]
  float* ps = qs + (size_t)kRowChunk * hd;                           // [kRowChunk][kKeys]
  __shared__ int any_live;

  const int sp = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int p0 = pos0[b];

  if (tid == 0) any_live = 0;
  __syncthreads();
  for (int r = tid; r < R; r += kThreads)
    if (split_live(p0 + r % T, window, S, sp)) any_live = 1;
  __syncthreads();
  if (!any_live) return;

  const int s0 = sp * kKeys;
  const int nk = min(kKeys, S - s0);
  const size_t kv_base = ((size_t)b * KVH + g) * hd * S + s0;
  if (vec) {
    // 8 keys (16 bytes) a load; S % 8 == 0, so nk is a multiple of 8.
    for (int i = tid; i < hd * (kKeys / 8); i += kThreads) {
      const int d = i / (kKeys / 8), c = (i % (kKeys / 8)) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (c < nk) {
        kv = *reinterpret_cast<const uint4*>(k + kv_base + (size_t)d * S + c);
        vv = *reinterpret_cast<const uint4*>(v + kv_base + (size_t)d * S + c);
      }
      *reinterpret_cast<uint4*>(ks + (size_t)d * kKeys + c) = kv;
      uint32_t* vrow = reinterpret_cast<uint32_t*>(vs + (size_t)d * kVStride + c);
      vrow[0] = vv.x;
      vrow[1] = vv.y;
      vrow[2] = vv.z;
      vrow[3] = vv.w;
    }
  } else {
    for (int i = tid; i < hd * kKeys; i += kThreads) {
      const int d = i / kKeys, s = i % kKeys;
      const bool in = s < nk;
      ks[(size_t)d * kKeys + s] = in ? k[kv_base + (size_t)d * S + s] : 0;
      vs[(size_t)d * kVStride + s] = in ? v[kv_base + (size_t)d * S + s] : 0;
    }
  }

  const size_t row_base = ((size_t)b * KVH + g) * R;                 // q/out row of r = 0
  const size_t part_base = (((size_t)b * KVH + g) * nsplit + sp) * R;  // part row of r = 0
  const int warp = tid / 32, lane = tid % 32;

  for (int c0 = 0; c0 < R; c0 += kRowChunk) {
    const int nr = min(kRowChunk, R - c0);
    __syncthreads();  // tiles staged; the previous chunk's readers are done
    for (int i = tid; i < kRowChunk * hd; i += kThreads) {
      const int r = i / hd;
      qs[i] = r < nr ? bf16_bits_to_f32(q[(row_base + c0 + r) * hd + i % hd]) : 0.0f;
    }
    __syncthreads();

    // Logits: thread = key; each row's dot runs d = 0 .. hd-1 in order.
    {
      const int s = tid;
      const int key = s0 + s;
      for (int r0 = 0; r0 < nr; r0 += kRowGroup) {
        float acc[kRowGroup];
#pragma unroll
        for (int j = 0; j < kRowGroup; ++j) acc[j] = 0.0f;
        for (int d = 0; d < hd; ++d) {
          const float kd = bf16_bits_to_f32(ks[(size_t)d * kKeys + s]);
#pragma unroll
          for (int j = 0; j < kRowGroup; ++j) acc[j] = fmaf(qs[(r0 + j) * hd + d], kd, acc[j]);
        }
#pragma unroll
        for (int j = 0; j < kRowGroup; ++j) {
          const int pos = p0 + (c0 + r0 + j) % T;
          float x = __fmul_rn(acc[j], scale);
          if (softcap > 0.0f) x = __fmul_rn(softcap, tanhf(__fdiv_rn(x, softcap)));
          const bool ok = key <= pos && (window <= 0 || key > pos - window);
          x = ok ? x : -1e9f;
          ps[(r0 + j) * kKeys + s] = s < nk ? x : -INFINITY;
        }
      }
    }
    __syncthreads();

    // Softmax statistics of the split: one warp per row, lane i holds keys
    // i, i+32, i+64, i+96; the butterfly order is fixed, lane 0 writes.
    for (int rr = warp; rr < nr; rr += kThreads / 32) {
      float x[kKeys / 32];
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < kKeys / 32; ++i) {
        x[i] = ps[rr * kKeys + lane + 32 * i];
        m = fmaxf(m, x[i]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float l = 0.0f;
#pragma unroll
      for (int i = 0; i < kKeys / 32; ++i) {
        const float e = expf(__fsub_rn(x[i], m));
        l = __fadd_rn(l, e);
        ps[rr * kKeys + lane + 32 * i] = round_to_bf16(e);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, o));
      if (lane == 0) {
        part_ml[(part_base + c0 + rr) * 2] = m;
        part_ml[(part_base + c0 + rr) * 2 + 1] = l;
      }
    }
    __syncthreads();

    // Unnormalised context: thread = output dim; each row's sum runs over
    // the split's keys in order.
    for (int d = tid; d < hd; d += kThreads) {
      for (int r0 = 0; r0 < nr; r0 += kRowGroup) {
        float acc[kRowGroup];
#pragma unroll
        for (int j = 0; j < kRowGroup; ++j) acc[j] = 0.0f;
        for (int s = 0; s < nk; ++s) {
          const float vv = bf16_bits_to_f32(vs[(size_t)d * kVStride + s]);
#pragma unroll
          for (int j = 0; j < kRowGroup; ++j) acc[j] = fmaf(ps[(r0 + j) * kKeys + s], vv, acc[j]);
        }
#pragma unroll
        for (int j = 0; j < kRowGroup; ++j)
          if (r0 + j < nr) part_acc[(part_base + c0 + r0 + j) * hd + d] = acc[j];
      }
    }
  }
}

// grid = (R, KVH, B), block = kThreads, dynamic smem = 3 * nsplit words: the
// splits of one row merged in ascending split order.  The splits' maxima are
// gathered in parallel; one thread then walks the live splits in order for
// the total weight L and a compact list of (weight, split); every thread
// sums its output dims over that list.
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
             const int* __restrict__ pos0, int KVH, int R, int T, int hd, int S, int nsplit,
             int window, float* __restrict__ out) {
  extern __shared__ float sm[];
  float* sm_m = sm;                                        // [nsplit] m, -inf if not live
  float* sm_w = sm + nsplit;                               // [nsplit] weights of live splits
  int* sm_sp = reinterpret_cast<int*>(sm + 2 * nsplit);    // [nsplit] their split ids
  __shared__ float sm_l;
  __shared__ int sm_n;
  const int r = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int pos = pos0[b] + r % T;
  const size_t first = ((size_t)b * KVH + g) * nsplit * R + r;  // part row of split 0
  for (int sp = threadIdx.x; sp < nsplit; sp += blockDim.x)
    sm_m[sp] = split_live(pos, window, S, sp) ? part_ml[(first + (size_t)sp * R) * 2] : -INFINITY;
  __syncthreads();
  if (threadIdx.x == 0) {
    float M = -INFINITY;
    for (int sp = 0; sp < nsplit; ++sp) M = fmaxf(M, sm_m[sp]);
    float L = 0.0f;
    int n = 0;
    for (int sp = 0; sp < nsplit; ++sp) {
      if (!split_live(pos, window, S, sp)) continue;
      const float w = expf(__fsub_rn(sm_m[sp], M));
      L = fmaf(w, part_ml[(first + (size_t)sp * R) * 2 + 1], L);
      sm_w[n] = w;
      sm_sp[n++] = sp;
    }
    sm_l = L;
    sm_n = n;
  }
  __syncthreads();
  const int n = sm_n;
  const float L = sm_l;
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float acc = 0.0f;
#pragma unroll 8
    for (int j = 0; j < n; ++j)
      acc = fmaf(sm_w[j], part_acc[(first + (size_t)sm_sp[j] * R) * hd + d], acc);
    out[(((size_t)b * KVH + g) * R + r) * hd + d] = __fdiv_rn(acc, L);
  }
}

int num_splits(int S) { return (S + kKeys - 1) / kKeys; }

}  // namespace

// Scratch floats of one call: (m, l) and the hd partial sums per row and split.
extern "C" long long rlt_gqa_decode_scratch(int B, int KVH, int R, int hd, int S) {
  return (long long)B * KVH * num_splits(S) * R * (hd + 2);
}

// Host launcher with a plain C interface; returns a cudaError_t value (0 on
// success).  R = REP * T rows per group; out [B, KVH, R, hd] f32.
extern "C" int rlt_gqa_decode(const void* q, const void* k, const void* v, const int* pos0,
                              int B, int KVH, int R, int T, int hd, int S, float scale,
                              float softcap, int window, float* out, float* scratch,
                              void* stream) {
  if (B <= 0 || KVH <= 0 || T <= 0 || R <= 0 || R % T != 0 || S <= 0 || hd <= 0 ||
      hd % 8 != 0 || hd > kMaxHd)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || KVH > 65535 || R > 2147483647 / 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nsplit = num_splits(S);
  const size_t smem = smem_bytes(hd);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const bool vec = S % 8 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  float* part_ml = scratch;
  float* part_acc = scratch + (size_t)B * KVH * nsplit * R * 2;
  split_kernel<<<dim3(nsplit, KVH, B), kThreads, smem, s>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), pos0, KVH, R, T, hd, S, nsplit, scale, softcap, window,
      vec, part_ml, part_acc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t merge_smem = 3 * sizeof(float) * (size_t)nsplit;
  if (merge_smem > 48 * 1024) return (int)cudaErrorInvalidValue;  // S > 524,288
  merge_kernel<<<dim3(R, KVH, B), kThreads, merge_smem, s>>>(part_ml, part_acc, pos0, KVH, R, T,
                                                              hd, S, nsplit, window, out);
  return (int)cudaGetLastError();
}
