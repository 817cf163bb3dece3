// Grouped-query attention of many query positions over the resident KV cache
// (prompt prefill, and verify windows wider than 16).
//
// Replaces the TPU kernel `_prefill_attn_kernel` (raglite_tpu/ops/prefill_attention.py:71,
// wrapper `gqa_prefill_attention`).  Python binding:
// raglite_tpu_torch/ops/prefill_attention.py, through ctypes.
//
// Semantics.  q [B, KVH, REP, T, hd] bf16, k and v [B, KVH, hd, S] bf16 with the
// sequence minor-most, off [B] int32.  Query t of batch row b sits at position
// p = off[b] + t and attends key s iff s <= p and, with a window w > 0,
// s > p - w; logits are dot(q, k) * scale in f32, optionally soft-capped
// (softcap * tanh(x / softcap)), masked to -1e9, softmaxed over all S and
// applied to v: out [B, KVH, REP, T, hd] f32.
//
// Design.  The TPU kernel keeps a whole [REP * BQ, S] f32 logits tile in VMEM;
// Hopper's 227 KB of shared memory cannot hold that at S = 8 K, so this is a
// flash kernel with an online softmax over key tiles of kBK keys.  One block
// owns (b, g, a tile of BQ = 16 * MT positions) and every REP head of the
// group: warp w computes the 16 rows (head w / MT, positions w % MT * 16 ..
// +15), so each K/V tile is staged in shared memory once for the whole group.
// K and V tiles are staged in shared memory as stored ([hd][key]) with
// 16-byte cp.async copies, double-buffered so tile i + 1 loads while tile i
// computes.  Both products are bf16 mma.sync.m16n8k16 with f32 accumulation:
// S = Q K^T with Q's fragments held in registers for the whole block and
// K^T's fragments read by ldmatrix.trans, then P V with P re-packed from the
// S accumulators (the m16n8 C layout of two n-tiles is the m16k16 A layout)
// and V's fragments read directly.  Key tiles wholly above the block's causal
// limit or below its window are skipped: their keys are masked for every row
// of the block and would contribute exactly 0.  The ragged S edge is masked
// to -inf (zero weight) with zero-filled K/V; rows past T compute on zero
// queries and are not written.
//
// Rounding.  P is rounded to bf16 unnormalised (against the running max) where
// the plain version rounds the normalised probabilities, and the online
// rescaling multiplies in another order, so the two agree to a tolerance
// (attention_tolerance in ops/decode_attention.py), not bit for bit.
//
// Bound: operations at prompt lengths.  4 * REP * T * hd flops per key and
// group (the causal half of S on average) against 2 * hd * 2 bytes of K/V per
// key and group: at T = 2048 that is thousands of flops a byte, far above the
// card's ~295 bf16 flops a byte, so the tensor cores' 989 TFLOP/s bound it.
// This version uses mma.sync with cp.async double buffering; wgmma, TMA and
// a producer warp are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;              // keys per tile
constexpr int kStride = kBK + 8;     // bf16 per staged [hd] row: 144 bytes, so
                                     // 16-byte aligned and conflict-free
constexpr int kMaxThreads = 256;

// 16-byte global -> shared copy; with pred false it writes zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most one copy group (the newest) is still in flight.
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Four 8x8 bf16 matrices, transposed: the B fragments of two n-tiles.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 -> one register of two bf16 (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Dynamic shared memory: two stages of K and V tiles, [hd][kStride] each.
template <int HD>
constexpr size_t smem_bytes() {
  return 2 * 2 * (size_t)HD * kStride * sizeof(uint16_t);
}

// grid = (ceil(T / (16 * MT)), KVH, B), block = 32 * REP * MT.
template <int HD>
__global__ void __launch_bounds__(kMaxThreads)
prefill_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
               const uint16_t* __restrict__ v, const int* __restrict__ off, int KVH, int REP,
               int T, int S, int MT, float scale, float softcap, int window, bool vec,
               float* __restrict__ out) {
  extern __shared__ __align__(16) uint16_t tiles[];  // [stage][K, V][hd][kStride]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int rep = warp / MT, sub = warp % MT;
  const int bq = 16 * MT;
  const int tq0 = blockIdx.x * bq;
  const int g = blockIdx.y, b = blockIdx.z;
  const int o = off[b];
  const int t_a = tq0 + sub * 16 + g8;  // this thread's two rows: t_a and t_a + 8
  const int t_b = t_a + 8;
  const int pos_a = o + t_a, pos_b = o + t_b;
  const size_t qrow0 = (((size_t)b * KVH + g) * REP + rep) * T;  // row of (rep, t = 0)

  // Q fragments (m16k16 A layout) for the whole block; rows past T are zero.
  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int kc = 0; kc < HD / 16; ++kc) {
    const int c = kc * 16 + 2 * t4;
    const uint32_t* ra = reinterpret_cast<const uint32_t*>(q + (qrow0 + t_a) * HD + c);
    const uint32_t* rb = reinterpret_cast<const uint32_t*>(q + (qrow0 + t_b) * HD + c);
    qa[kc][0] = t_a < T ? ra[0] : 0u;
    qa[kc][1] = t_b < T ? rb[0] : 0u;
    qa[kc][2] = t_a < T ? ra[4] : 0u;
    qa[kc][3] = t_b < T ? rb[4] : 0u;
  }

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};
  float acc[HD / 8][4];
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.0f;

  // Keys the block needs: [lo_key, hi_key].  If some row of the block has no
  // valid key at all (positions >= S + window - 1, or negative offsets), every
  // key counts for it (uniform softmax, as in the plain version): no skipping.
  const int pos_min = o + tq0;
  const int pos_max = o + min(tq0 + bq, T) - 1;
  const bool all = o < 0 || (window > 0 && pos_max - window + 1 > S - 1);
  const int hi_key = all ? S - 1 : min(pos_max, S - 1);
  const int lo_key = (all || window <= 0) ? 0 : max(0, pos_min - window + 1);
  const size_t kv_base = ((size_t)b * KVH + g) * HD * S;

  // Stage `st` <- the K and V columns [kt0, kt0 + kBK), zero past S.
  auto load_tile = [&](int st, int kt0) {
    uint16_t* ks = tiles + (size_t)st * 2 * HD * kStride;
    uint16_t* vs = ks + HD * kStride;
    if (vec) {  // S % 8 == 0: whole 8-key chunks, one cp.async each
      for (int i = threadIdx.x; i < HD * (kBK / 8); i += blockDim.x) {
        const int d = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
        const bool in = kt0 + c < S;
        const size_t src = kv_base + (size_t)d * S + (in ? kt0 + c : 0);
        cp_async16(ks + d * kStride + c, k + src, in);
        cp_async16(vs + d * kStride + c, v + src, in);
      }
    } else {
      for (int i = threadIdx.x; i < HD * kBK; i += blockDim.x) {
        const int d = i / kBK, s = i % kBK;
        const bool in = kt0 + s < S;
        ks[d * kStride + s] = in ? k[kv_base + (size_t)d * S + kt0 + s] : 0;
        vs[d * kStride + s] = in ? v[kv_base + (size_t)d * S + kt0 + s] : 0;
      }
    }
  };

  const int first = (lo_key / kBK) * kBK;
  const int ntiles = hi_key >= first ? (hi_key - first) / kBK + 1 : 0;
  if (ntiles > 0) load_tile(0, first);
  cp_async_commit();
  for (int it = 0; it < ntiles; ++it) {
    const int kt0 = first + it * kBK;
    if (it + 1 < ntiles) load_tile((it + 1) & 1, kt0 + kBK);
    cp_async_commit();
    cp_async_wait_all_but_one();  // tile `it` has landed (this thread's copies)
    __syncthreads();              // ... and every other thread's
    const uint16_t* ks = tiles + (size_t)(it & 1) * 2 * HD * kStride;
    const uint16_t* vs = ks + HD * kStride;

    // S = Q K^T: 16 rows x kBK keys for this warp.  Lane l addresses row
    // l % 8 of matrix l / 8: hd rows +0 / +8 of n-tiles nt and nt + 1.
    float sc[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.0f;
    const int lm = lane >> 3, lr = lane & 7;
#pragma unroll
    for (int kc = 0; kc < HD / 16; ++kc) {
#pragma unroll
      for (int nt = 0; nt < kBK / 8; nt += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, ks + (kc * 16 + (lm & 1) * 8 + lr) * kStride + (nt + (lm >> 1)) * 8);
        mma_bf16(sc[nt], qa[kc], b[0], b[1]);
        mma_bf16(sc[nt + 1], qa[kc], b[2], b[3]);
      }
    }

    // Scale, soft-cap, mask; the online softmax of rows a (j < 2) and b.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = kt0 + nt * 8 + 2 * t4 + (j & 1);
        const int pos = j < 2 ? pos_a : pos_b;
        float x = sc[nt][j] * scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        const bool ok = key <= pos && (window <= 0 || key > pos - window);
        x = ok ? x : -1e9f;
        x = key < S ? x : -INFINITY;
        sc[nt][j] = x;
        mx[j >> 1] = fmaxf(mx[j >> 1], x);
      }
    }
    float corr[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);  // finite: every tile has a key < S
      corr[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[nt][j] - m[j >> 1]);
        sc[nt][j] = p;
        rs[j >> 1] += p;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
      l[h] = l[h] * corr[h] + rs[h];
    }
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn) {
      acc[dn][0] *= corr[0];
      acc[dn][1] *= corr[0];
      acc[dn][2] *= corr[1];
      acc[dn][3] *= corr[1];
    }

    // O += P V, P (bf16) from the S accumulators: n-tiles 2c and 2c + 1 form
    // the A fragment of keys 16c .. 16c + 15.
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[2 * kc][0], sc[2 * kc][1]);
      pa[1] = pack_bf16(sc[2 * kc][2], sc[2 * kc][3]);
      pa[2] = pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]);
      pa[3] = pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3]);
#pragma unroll
      for (int dn = 0; dn < HD / 8; ++dn) {
        const uint16_t* vp = vs + (dn * 8 + g8) * kStride + kc * 16 + 2 * t4;
        mma_bf16(acc[dn], pa, *reinterpret_cast<const uint32_t*>(vp),
                 *reinterpret_cast<const uint32_t*>(vp + 8));
      }
    }
    __syncthreads();  // this stage is free for tile it + 2
  }

  const float inv_a = 1.0f / l[0], inv_b = 1.0f / l[1];
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn) {
    const int c = dn * 8 + 2 * t4;
    if (t_a < T)
      *reinterpret_cast<float2*>(out + (qrow0 + t_a) * HD + c) =
          make_float2(acc[dn][0] * inv_a, acc[dn][1] * inv_a);
    if (t_b < T)
      *reinterpret_cast<float2*>(out + (qrow0 + t_b) * HD + c) =
          make_float2(acc[dn][2] * inv_b, acc[dn][3] * inv_b);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const int* off, int B, int KVH, int REP,
           int T, int S, float scale, float softcap, int window, float* out,
           cudaStream_t stream) {
  const int mt = REP >= 8 ? 1 : 8 / REP;
  const int threads = 32 * REP * mt;
  if (threads > kMaxThreads) return (int)cudaErrorInvalidValue;
  const bool vec = S % 8 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const dim3 grid((T + 16 * mt - 1) / (16 * mt), KVH, B);
  constexpr size_t smem = smem_bytes<HD>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        prefill_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  prefill_kernel<HD><<<grid, threads, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), off, KVH, REP, T, S, mt, scale, softcap, window, vec,
      out);
  return (int)cudaGetLastError();
}

}  // namespace

// Host launcher with a plain C interface; returns a cudaError_t value (0 on
// success).  hd in {32, 64, 128}, REP <= 8.
extern "C" int rlt_gqa_prefill(const void* q, const void* k, const void* v, const int* off,
                               int B, int KVH, int REP, int T, int hd, int S, float scale,
                               float softcap, int window, float* out, void* stream) {
  if (B <= 0 || KVH <= 0 || REP <= 0 || REP > 8 || T <= 0 || S <= 0 || B > 65535 ||
      KVH > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch<32>(q, k, v, off, B, KVH, REP, T, S, scale, softcap, window, out, s);
    case 64:
      return launch<64>(q, k, v, off, B, KVH, REP, T, S, scale, softcap, window, out, s);
    case 128:
      return launch<128>(q, k, v, off, B, KVH, REP, T, S, scale, softcap, window, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
