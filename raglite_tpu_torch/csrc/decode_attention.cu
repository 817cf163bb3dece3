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
// (flash-decoding): one block of eight warps per (b, g, split of kKeys keys),
// and ONE launch that also merges the splits.
//
// - Tiles.  The block fetches the group's Q rows and its split's K tile, and
//   then its V tile, as stored ([hd][key]), with 16-byte cp.async copies in two
//   groups: the logits start when K has landed, while V is still in flight.
//   Rows are padded (kStride, hd + 8) so that every ldmatrix is free of bank
//   conflicts.  A cache whose rows are not 16-byte aligned (S % 8 != 0) is
//   staged by a scalar path into the same tiles.
// - Products.  Both run on the tensor cores (bf16 mma.sync.m16n8k16, f32
//   accumulators).  The R = REP * T query rows are padded to 16-row tiles,
//   taken one after the other; a tile's Q fragments sit in registers for all
//   of its logits.  For Q K^T warp w owns keys 16 w .. 16 w + 15 (K^T's B
//   fragments by ldmatrix.trans); the logits stay in registers through scale,
//   soft-cap, mask, row max and row sum (quad shuffles, then one value per
//   warp and row through shared memory, combined in warp order).  For P V
//   warp w owns hd / 8 output dims (at hd = 32 four warps own 8 each and four
//   sit out) over all of the split's keys, so no f32
//   sum crosses warps: what crosses is P alone, rounded to bf16, through a
//   [16][kStride] tile (4 KB) that the warps read back with ldmatrix; V
//   [hd][key] is already a column-major B.  Padded rows compute on zero
//   queries and write nothing.
// - Merge.  Each block writes its split's (m, l, unnormalised context) and
//   takes a ticket from a counter per (b, g, chunk of kChunk splits); the block
//   that draws the last ticket merges the chunk's splits in ascending order
//   into one partial and takes a ticket from the counter of (b, g); the last
//   of those merges the chunks in ascending order, divides and writes the
//   output.  Which block is last changes who does the work, never the result:
//   the tree's shape depends on S only.  All threads compute a merge's
//   weights (one per row and entry); the counters live in a persistent
//   buffer that is zero between launches (the merging block resets them).
//   A merge is bound by trips to L2 (about a microsecond each on an H100), so
//   its loads are unconditional and batched: the first round of contexts goes
//   out with the (m, l) loads, and later rounds hold 2 x (kChunk + 1) float4
//   a thread.
//
// Verify row t must equal the decode kernel at position pos0 + t bit for bit
// (the reason the TPU verify kernel exists: greedy speculation is exact only if
// both forwards share attention numerics).  So:
// - split and chunk boundaries depend on S only, never on positions;
// - an mma output element depends on its own A row and B column only, so a
//   row's logits and context do not depend on T, on the tile row it sits in or
//   on which other rows share the tile; its mask, max, sum and merge weights
//   depend on its own position only, and every sum outside the tensor cores
//   runs in a fixed order with explicit fmaf/__fadd_rn.
// Splits wholly outside a row's valid keys contribute exactly 0 to it (their
// masked logits underflow against the row's max), so the merges skip them and a
// block none of whose rows has a valid key in its split loads and computes
// nothing (it only takes its ticket): the bytes read follow the valid keys.  A
// row with no valid key at all (only possible for positions >= S + window - 1)
// keeps every split, so its softmax is the plain version's uniform one.
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
// A block needs (2 hd + 16) kStride + 16 ceil(R / 16) (hd + 8) bf16 and 1 KB of
// shared memory (78 KB at hd = 128 for decode, 95 KB for T = 16 at REP = 5:
// two blocks an SM, 16 warps), and all of a block's K and V bytes are in
// flight at once.  Past the tile's arrival the block is bound by shared
// memory: every warp reads all of Q and all of P again for each row tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kKeys = 128;              // keys per split; boundaries depend on S only
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpKeys = kKeys / kWarps;  // keys of a split whose logits one warp computes
constexpr int kStride = kKeys + 8;      // bf16 per staged row: 272 bytes, so 16-byte
                                        // aligned and conflict-free for ldmatrix
constexpr int kChunk = 8;               // splits merged by the first level of the tree
constexpr int kMaxDevices = 64;
// Dynamic shared memory a block may ask for: the card's 227 KB less the static.
constexpr size_t kMaxSmem = 226 * 1024;

// 16-byte global -> shared copy; with pred false it writes zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's copy groups (the newest) are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 bf16 matrices as stored: the A fragment of one m16k16 tile, or
// the B fragments of two n-tiles of a column-major B.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Two 8x8 bf16 matrices as stored (lanes 0-15 give the row addresses).
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* smem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
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

// Loads that go to L2 (another block wrote the data in this launch) and that
// the compiler can neither drop nor sink to their first use: the merges send
// a batch of them before the first sum needs one.
__device__ __forceinline__ float4 ld_cg_f4(const float* p) {
  float4 x;
  asm volatile("ld.global.cg.v4.f32 {%0,%1,%2,%3}, [%4];\n"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "l"(p));
  return x;
}

__device__ __forceinline__ float2 ld_cg_f2(const float* p) {
  float2 x;
  asm volatile("ld.global.cg.v2.f32 {%0,%1}, [%2];\n" : "=f"(x.x), "=f"(x.y) : "l"(p));
  return x;
}

// Built with -DRLT_STAMPS, thread 0 of every block notes the card's global
// timer (nanoseconds) at seven points of its course (the card has no other profiler that
// sees inside a kernel); rlt_gqa_decode_stamps reads the notes back.  Without
// the flag stamp() is nothing.
enum Stamp { kStart, kKLanded, kSplitDone, kTicket1, kMerge1Done, kTicket2, kMerge2Done, kStamps };
#ifdef RLT_STAMPS
constexpr int kStampBlocks = 4096;
__device__ unsigned long long g_stamps[kStamps * kStampBlocks];
__device__ __forceinline__ void stamp(Stamp slot) {
  const int block = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  if (threadIdx.x == 0 && block < kStampBlocks) {
    unsigned long long now;
    asm volatile("mov.u64 %0, %globaltimer;" : "=l"(now));
    g_stamps[slot * kStampBlocks + block] = now;
  }
}
#else
__device__ __forceinline__ void stamp(Stamp) {}
#endif

// Whether the keys [k0, k1] can contribute to a row at position `pos`: they
// overlap the row's valid keys [lo, hi], or the row has none (then all count).
__device__ __forceinline__ bool keys_live(int pos, int window, int S, int k0, int k1) {
  const int lo = window > 0 ? max(0, pos - window + 1) : 0;
  const int hi = min(pos, S - 1);
  if (lo > hi) return true;
  return k0 <= hi && k1 >= lo;
}

// The n-tiles (8 output dims each) of the context that one warp computes;
// where hd has fewer n-tiles than the block has warps, the last warps sit out.
__host__ __device__ constexpr int out_tiles(int hd) {
  return hd / (8 * kWarps) > 0 ? hd / (8 * kWarps) : 1;
}

// Dynamic shared memory: the K and V tiles [hd][kStride], the P tile
// [16][kStride], the Q rows padded to 16-row tiles [.][hd + 8] (all bf16), and
// per warp and tile row a max and a sum (f32).
__host__ __device__ constexpr size_t smem_bytes(int hd, int R) {
  const size_t q_rows = (size_t)((R + 15) / 16) * 16;
  return sizeof(uint16_t) * ((size_t)(2 * hd + 16) * kStride + q_rows * (hd + 8)) +
         sizeof(float) * 2 * kWarps * 16;
}

// Merge `n` entries (splits of a chunk, or chunks of a group) of the R rows of
// one (b, g) in ascending order.  ml [n][R][2] holds each entry's (m, l), acc
// [n][R][HD] its unnormalised context; entry j covers the keys first_key +
// j * span .. + span - 1.  A row skips the entries none of whose keys it can
// see.  kFinal divides by the total weight and writes the output rows;
// otherwise the merged (m, l, context) become one entry of the next level.
// `sm` is `cap` floats of shared memory that nothing else uses any more.
template <int HD, bool kFinal>
__device__ __forceinline__ void merge(const float* __restrict__ ml, const float* __restrict__ acc,
                                      int n, int first_key, int span, int R, int T, int S, int p0,
                                      int window, float* sm, int cap, float* __restrict__ out_ml,
                                      float* __restrict__ out_acc) {
  const int tid = threadIdx.x;
  const int rb = min(R, cap / (2 * n + 2));  // rows whose weights fit at once
  float* sm_w = sm;                          // [rb][n] m, then the weight exp(m - M)
  float* sm_l = sm_w + (size_t)rb * n;       // [rb][n] l, then weight * l
  float* sm_M = sm_l + (size_t)rb * n;       // [rb]
  float* sm_L = sm_M + rb;                   // [rb]
  // Four output dims a thread and kItems items in flight: a round loads the
  // contexts of up to kRound entries for each item before the first sum needs
  // one (kChunk + 1, so that one chunk more than kChunk still is one round).
  // Entries of weight zero (dead, or underflowed) are loaded too and add
  // exactly nothing; their bits are arbitrary, so they are selected away, not
  // multiplied.  A dependent trip to L2 costs about a microsecond here, so the
  // first round goes out together with the (m, l) loads, before the weights.
  constexpr int kItems = 2, kRound = kChunk + 1;
  for (int r0 = 0; r0 < R; r0 += rb) {
    const int nr = min(rb, R - r0);
    const int total = nr * (HD / 4);
    float4 x[kItems][kRound];
    auto load_round = [&](int base, int j0) {
#pragma unroll
      for (int u = 0; u < kItems; ++u) {
        const int i = min(base + u * kThreads, total - 1);
        const int rr = i / (HD / 4), d = (i % (HD / 4)) * 4;
#pragma unroll
        for (int e = 0; e < kRound; ++e)
          x[u][e] = ld_cg_f4(acc + ((size_t)min(j0 + e, n - 1) * R + r0 + rr) * HD + d);
      }
    };
    load_round(tid, 0);
    __syncthreads();  // the previous batch's readers are done
    // Every (m, l) is loaded, live or not (a dead entry's bits are arbitrary
    // and dropped): unconditional loads stay in flight together.
#pragma unroll 4
    for (int i = tid; i < nr * n; i += kThreads) {
      const int r = r0 + i / n, j = i % n;
      const int k0 = first_key + j * span;
      const int k1 = min(k0 + span, S) - 1;
      const float2 y = ld_cg_f2(ml + ((size_t)j * R + r) * 2);
      const bool lv = keys_live(p0 + r % T, window, S, k0, k1);
      sm_w[i] = lv ? y.x : -INFINITY;
      sm_l[i] = lv ? y.y : 0.0f;
    }
    __syncthreads();
    for (int i = tid; i < nr; i += kThreads) {
      float M = -INFINITY;
      for (int j = 0; j < n; ++j) M = fmaxf(M, sm_w[i * n + j]);
      sm_M[i] = M;
    }
    __syncthreads();
    for (int i = tid; i < nr * n; i += kThreads) {
      const float m = sm_w[i];
      const float w = m == -INFINITY ? 0.0f : expf(__fsub_rn(m, sm_M[i / n]));
      sm_w[i] = w;
      sm_l[i] = __fmul_rn(w, sm_l[i]);
    }
    __syncthreads();
    for (int i = tid; i < nr; i += kThreads) {
      float L = 0.0f;
      for (int j = 0; j < n; ++j) L = __fadd_rn(L, sm_l[i * n + j]);
      sm_L[i] = L;
    }
    __syncthreads();
    for (int base = tid; base < total; base += kThreads * kItems) {
      float4 a[kItems];
#pragma unroll
      for (int u = 0; u < kItems; ++u) a[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int j0 = 0; j0 < n; j0 += kRound) {
        if (base != tid || j0 != 0) load_round(base, j0);
#pragma unroll
        for (int u = 0; u < kItems; ++u) {
          const int rr = min(base + u * kThreads, total - 1) / (HD / 4);
#pragma unroll
          for (int e = 0; e < kRound; ++e) {
            const float w = j0 + e < n ? sm_w[rr * n + min(j0 + e, n - 1)] : 0.0f;
            const bool on = w != 0.0f;
            a[u].x = on ? fmaf(w, x[u][e].x, a[u].x) : a[u].x;
            a[u].y = on ? fmaf(w, x[u][e].y, a[u].y) : a[u].y;
            a[u].z = on ? fmaf(w, x[u][e].z, a[u].z) : a[u].z;
            a[u].w = on ? fmaf(w, x[u][e].w, a[u].w) : a[u].w;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kItems; ++u) {
        const int i = base + u * kThreads;
        if (i >= total) continue;
        const int rr = i / (HD / 4), d = (i % (HD / 4)) * 4;
        float4 o = a[u];
        if (kFinal) {
          const float L = sm_L[rr];
          o = make_float4(__fdiv_rn(o.x, L), __fdiv_rn(o.y, L), __fdiv_rn(o.z, L),
                          __fdiv_rn(o.w, L));
        } else if (d == 0) {
          *reinterpret_cast<float2*>(out_ml + (size_t)(r0 + rr) * 2) =
              make_float2(sm_M[rr], sm_L[rr]);
        }
        *reinterpret_cast<float4*>(out_acc + (size_t)(r0 + rr) * HD + d) = o;
      }
    }
  }
}

// grid = (nsplit, KVH, B), block = kThreads, dynamic shared memory
// smem_bytes(HD, R).
// part_ml [B, KVH, nsplit, R, 2] (m, l) and part_acc [B, KVH, nsplit, R, HD] per
// split; chunk_ml / chunk_acc the same per chunk of kChunk splits; chunk_count
// [B, KVH, nchunk] and group_count [B, KVH] are zero at launch and at exit.
template <int HD>
__global__ void __launch_bounds__(kThreads, HD <= 128 ? 2 : 1)  // two blocks an SM: 128 registers
attn_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
            const uint16_t* __restrict__ v, const int* __restrict__ pos0, int KVH, int R, int T,
            int S, int nsplit, int nchunk, float scale, float softcap, int window, bool vec,
            float* part_ml, float* part_acc, float* chunk_ml, float* chunk_acc, int* chunk_count,
            int* group_count, float* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* ks = reinterpret_cast<uint16_t*>(smem);    // [HD][kStride]
  uint16_t* vs = ks + HD * kStride;                     // [HD][kStride]
  uint16_t* ps = vs + HD * kStride;                     // [16][kStride]
  float* wm = reinterpret_cast<float*>(ps + 16 * kStride);  // [kWarps][16] row max per warp
  float* wl = wm + kWarps * 16;                         // [kWarps][16] row sum per warp
  uint16_t* qs = reinterpret_cast<uint16_t*>(wl + kWarps * 16);  // [R to 16s][kQStride]
  constexpr int kQStride = HD + 8;                      // conflict-free for ldmatrix, as kStride
  __shared__ int last;

  const int sp = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int lm = lane >> 3, lr = lane & 7;
  const int p0 = pos0[b];
  const size_t bg = (size_t)b * KVH + g;
  const int s0 = sp * kKeys;
  const int s1 = min(s0 + kKeys, S) - 1;

  stamp(kStart);
  bool live = false;  // some row of the group can see a key of this split
  for (int t = 0; t < T; ++t) live |= keys_live(p0 + t, window, S, s0, s1);

  if (live) {
    const size_t row_base = bg * R;                    // q/out row of r = 0
    const size_t part_base = (bg * nsplit + sp) * R;   // part row of r = 0
    constexpr int kOutTiles = out_tiles(HD);
    const int d0 = warp * kOutTiles * 8;               // this warp's first output dim
    // Every Q row of the group, zero past R: a trip to device memory takes
    // longer than a row tile computes, so none is fetched tile by tile.
    auto load_q = [&]() {
      for (int i = tid; i < (R + 15) / 16 * 16 * (HD / 8); i += kThreads) {
        const int row = i / (HD / 8), c = (i % (HD / 8)) * 8;
        cp_async16(qs + row * kQStride + c, q + (row_base + (row < R ? row : 0)) * HD + c, row < R);
      }
    };
    const int nk = s1 - s0 + 1;
    const size_t kv_base = bg * HD * S + s0;
    // Two copy groups: (K, Q), then (V).
    if (vec) {
      // 8 keys (16 bytes) a copy; S % 8 == 0, so nk is a multiple of 8.
      for (int i = tid; i < HD * (kKeys / 8); i += kThreads) {
        const int d = i / (kKeys / 8), c = (i % (kKeys / 8)) * 8;
        cp_async16(ks + d * kStride + c, k + kv_base + (size_t)d * S + (c < nk ? c : 0), c < nk);
      }
      load_q();
      cp_async_commit();
      for (int i = tid; i < HD * (kKeys / 8); i += kThreads) {
        const int d = i / (kKeys / 8), c = (i % (kKeys / 8)) * 8;
        cp_async16(vs + d * kStride + c, v + kv_base + (size_t)d * S + (c < nk ? c : 0), c < nk);
      }
      cp_async_commit();
    } else {
      load_q();
      cp_async_commit();
      cp_async_commit();
      for (int i = tid; i < HD * kKeys; i += kThreads) {
        const int d = i / kKeys, s = i % kKeys;
        ks[d * kStride + s] = s < nk ? k[kv_base + (size_t)d * S + s] : 0;
        vs[d * kStride + s] = s < nk ? v[kv_base + (size_t)d * S + s] : 0;
      }
    }

    for (int r16 = 0; r16 < R; r16 += 16) {
      const int r_a = r16 + g8, r_b = r_a + 8;         // this thread's two rows
      if (r16 == 0) {
        cp_async_wait<1>();  // K and Q have landed (this thread's copies)
        __syncthreads();     // ... and every other thread's
        stamp(kKLanded);
      }
      // Q fragments (m16k16 A layout) of the tile, for all of its products.
      uint32_t qa[HD / 16][4];
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc)
        ldmatrix_x4(qa[kc], qs + (r16 + (lm & 1) * 8 + lr) * kQStride + kc * 16 + (lm >> 1) * 8);

      // Logits of this warp's kWarpKeys keys.  Lane l addresses row l % 8 of
      // matrix l / 8: hd rows +0 / +8 of n-tiles nt and nt + 1.
      float sc[kWarpKeys / 8][4];
#pragma unroll
      for (int nt = 0; nt < kWarpKeys / 8; ++nt)
        sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.0f;
#pragma unroll
      for (int kc = 0; kc < HD / 16; ++kc) {
#pragma unroll
        for (int nt = 0; nt < kWarpKeys / 8; nt += 2) {
          uint32_t kb[4];
          ldmatrix_x4_trans(kb, ks + (kc * 16 + (lm & 1) * 8 + lr) * kStride + warp * kWarpKeys +
                                    (nt + (lm >> 1)) * 8);
          mma_bf16(sc[nt], qa[kc], kb[0], kb[1]);
          mma_bf16(sc[nt + 1], qa[kc], kb[2], kb[3]);
        }
      }

      // Scale, soft-cap, mask; the split's max of rows a (j < 2) and b.
      const int pos_a = p0 + r_a % T, pos_b = p0 + r_b % T;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < kWarpKeys / 8; ++nt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = s0 + warp * kWarpKeys + nt * 8 + 2 * t4 + (j & 1);
          const int pos = j < 2 ? pos_a : pos_b;
          float x = __fmul_rn(sc[nt][j], scale);
          if (softcap > 0.0f) x = __fmul_rn(softcap, tanhf(__fdiv_rn(x, softcap)));
          const bool ok = key <= pos && (window <= 0 || key > pos - window);
          x = ok ? x : -1e9f;
          x = key < S ? x : -INFINITY;
          sc[nt][j] = x;
          mx[j >> 1] = fmaxf(mx[j >> 1], x);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      }
      if (t4 == 0) {
        wm[warp * 16 + g8] = mx[0];
        wm[warp * 16 + g8 + 8] = mx[1];
      }
      __syncthreads();
      float m[2];  // finite: every split has a key < S
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = g8 + 8 * h;
        m[h] = wm[row];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) m[h] = fmaxf(m[h], wm[w * 16 + row]);
      }

      // exp(logit - m): its f32 sum, and P rounded to bf16 into the P tile.
      float rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int nt = 0; nt < kWarpKeys / 8; ++nt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float e = expf(__fsub_rn(sc[nt][j], m[j >> 1]));
          sc[nt][j] = e;
          rs[j >> 1] = __fadd_rn(rs[j >> 1], e);
        }
        uint16_t* pp = ps + g8 * kStride + warp * kWarpKeys + nt * 8 + 2 * t4;
        *reinterpret_cast<uint32_t*>(pp) = pack_bf16(sc[nt][0], sc[nt][1]);
        *reinterpret_cast<uint32_t*>(pp + 8 * kStride) = pack_bf16(sc[nt][2], sc[nt][3]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rs[h] = __fadd_rn(rs[h], __shfl_xor_sync(0xffffffffu, rs[h], 1));
        rs[h] = __fadd_rn(rs[h], __shfl_xor_sync(0xffffffffu, rs[h], 2));
      }
      if (t4 == 0) {
        wl[warp * 16 + g8] = rs[0];
        wl[warp * 16 + g8 + 8] = rs[1];
      }
      if (r16 == 0) cp_async_wait<0>();  // V has landed
      __syncthreads();

      // Unnormalised context of this warp's kOutTiles * 8 output dims over all
      // of the split's keys: P's A fragments by ldmatrix, V's B fragments as
      // stored (V [hd][key] is a column-major B of P V^T).
      if (d0 < HD) {
        float o[kOutTiles][4];
#pragma unroll
        for (int nt = 0; nt < kOutTiles; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.0f;
#pragma unroll
        for (int kc = 0; kc < kKeys / 16; ++kc) {
          uint32_t pa[4];
          ldmatrix_x4(pa, ps + ((lm & 1) * 8 + lr) * kStride + kc * 16 + (lm >> 1) * 8);
          // V [hd][key] is a column-major B of P V^T: matrix l / 8 of an x4 is
          // keys +0 / +8 of n-tiles nt and nt + 1; an x2 serves a single n-tile.
          if constexpr (kOutTiles % 2 == 0) {
#pragma unroll
            for (int nt = 0; nt < kOutTiles; nt += 2) {
              uint32_t vb[4];
              ldmatrix_x4(vb, vs + (d0 + (nt + (lm >> 1)) * 8 + lr) * kStride + kc * 16 +
                                  (lm & 1) * 8);
              mma_bf16(o[nt], pa, vb[0], vb[1]);
              mma_bf16(o[nt + 1], pa, vb[2], vb[3]);
            }
          } else {
            static_assert(kOutTiles == 1, "an odd count of n-tiles a warp is one");
            uint32_t vb[2];
            ldmatrix_x2(vb, vs + (d0 + lr) * kStride + kc * 16 + (lm & 1) * 8);
            mma_bf16(o[0], pa, vb[0], vb[1]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < kOutTiles; ++nt) {
          const int c = d0 + nt * 8 + 2 * t4;
          if (r_a < R)
            *reinterpret_cast<float2*>(part_acc + (part_base + r_a) * HD + c) =
                make_float2(o[nt][0], o[nt][1]);
          if (r_b < R)
            *reinterpret_cast<float2*>(part_acc + (part_base + r_b) * HD + c) =
                make_float2(o[nt][2], o[nt][3]);
        }
      }
      if (warp == 0 && t4 == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = g8 + 8 * h;
          float l = wl[row];
#pragma unroll
          for (int w = 1; w < kWarps; ++w) l = __fadd_rn(l, wl[w * 16 + row]);
          if (r16 + row < R)
            *reinterpret_cast<float2*>(part_ml + (part_base + r16 + row) * 2) =
                make_float2(m[h], l);
        }
      }
      __syncthreads();  // the P tile and the per-warp values are free again
    }
  }

  stamp(kSplitDone);
  // The chunk's ticket: the last of its splits' blocks merges them.
  const int c = sp / kChunk;
  const int c_first = c * kChunk;
  const int c_n = min(kChunk, nsplit - c_first);
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(chunk_count + bg * nchunk + c, 1) == c_n - 1;
  __syncthreads();
  stamp(kTicket1);
  if (!last) return;
  __threadfence();
  float* sm = reinterpret_cast<float*>(smem);  // the tiles are dead
  constexpr int cap = HD * kStride;            // floats in the K and V tiles
  bool chunk_live = false;
  for (int t = 0; t < T; ++t)
    chunk_live |= keys_live(p0 + t, window, S, c_first * kKeys,
                            min((c_first + c_n) * kKeys, S) - 1);
  if (chunk_live)
    merge<HD, false>(part_ml + (bg * nsplit + c_first) * R * 2,
                     part_acc + (bg * nsplit + c_first) * R * HD, c_n, c_first * kKeys, kKeys, R,
                     T, S, p0, window, sm, cap, chunk_ml + (bg * nchunk + c) * R * 2,
                     chunk_acc + (bg * nchunk + c) * R * HD);

  stamp(kMerge1Done);
  // The group's ticket: the last of its chunks' mergers writes the output.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    chunk_count[bg * nchunk + c] = 0;
    last = atomicAdd(group_count + bg, 1) == nchunk - 1;
  }
  __syncthreads();
  stamp(kTicket2);
  if (!last) return;
  __threadfence();
  merge<HD, true>(chunk_ml + bg * nchunk * R * 2, chunk_acc + bg * nchunk * R * HD, nchunk, 0,
                  kKeys * kChunk, R, T, S, p0, window, sm, cap, nullptr, out + bg * R * HD);
  if (tid == 0) group_count[bg] = 0;
  stamp(kMerge2Done);
}

// An empty kernel for the launch floor: the same grid, block and shared memory.
__global__ void __launch_bounds__(kThreads) floor_kernel() {}

int num_splits(int S) { return (S + kKeys - 1) / kKeys; }
int num_chunks(int S) { return (num_splits(S) + kChunk - 1) / kChunk; }

bool shape_ok(int B, int KVH, int R, int hd, int S) {
  return B > 0 && KVH > 0 && R > 0 && S > 0 && B <= 65535 && KVH <= 65535 && R <= 65536 &&
         (hd == 32 || hd == 64 || hd == 128 || hd == 256) &&
         smem_bytes(hd, R) <= kMaxSmem &&          // the group's Q rows fit beside the tiles
         2 * num_chunks(S) + 2 <= hd * kStride;    // one row's merge weights fit
}

// Allow `kernel` all the dynamic shared memory a block may have, once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidValue;
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (err == cudaSuccess) done[dev] = true;
  return err;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const int* pos0, int B, int KVH, int R,
           int T, int S, float scale, float softcap, int window, float* out, float* scratch,
           int* counters, cudaStream_t stream) {
  static bool smem_allowed[kMaxDevices] = {};
  const cudaError_t err = allow_smem(attn_kernel<HD>, smem_allowed);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(HD, R);
  const int nsplit = num_splits(S), nchunk = num_chunks(S);
  const size_t groups = (size_t)B * KVH;
  // The contexts first: their float4 loads want 16-byte alignment.
  float* part_acc = scratch;
  float* chunk_acc = part_acc + groups * nsplit * R * HD;
  float* part_ml = chunk_acc + groups * nchunk * R * HD;
  float* chunk_ml = part_ml + groups * nsplit * R * 2;
  int* chunk_count = counters;
  int* group_count = counters + groups * nchunk;
  const bool vec = S % 8 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  attn_kernel<HD><<<dim3(nsplit, KVH, B), kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), pos0, KVH, R, T, S, nsplit, nchunk, scale, softcap,
      window, vec, part_ml, part_acc, chunk_ml, chunk_acc, chunk_count, group_count, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Scratch floats of one call: (m, l) and the hd partial sums per row, for
// every split and every chunk of splits.
extern "C" long long rlt_gqa_decode_scratch(int B, int KVH, int R, int hd, int S) {
  return (long long)B * KVH * (num_splits(S) + num_chunks(S)) * R * (hd + 2);
}

// Ticket counters (ints) of one call: one per chunk and one per group.  The
// kernel expects them zero and leaves them zero.
extern "C" long long rlt_gqa_decode_counters(int B, int KVH, int S) {
  return (long long)B * KVH * (num_chunks(S) + 1);
}

// Host launcher with a plain C interface; returns a cudaError_t value (0 on
// success).  R = REP * T rows per group; out [B, KVH, R, hd] f32; hd in {32,
// 64, 128, 256}.  One kernel launch, nothing else on the stream.
extern "C" int rlt_gqa_decode(const void* q, const void* k, const void* v, const int* pos0,
                              int B, int KVH, int R, int T, int hd, int S, float scale,
                              float softcap, int window, float* out, float* scratch,
                              int* counters, void* stream) {
  if (T <= 0 || R % T != 0 || !shape_ok(B, KVH, R, hd, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch<32>(q, k, v, pos0, B, KVH, R, T, S, scale, softcap, window, out, scratch,
                        counters, s);
    case 64:
      return launch<64>(q, k, v, pos0, B, KVH, R, T, S, scale, softcap, window, out, scratch,
                        counters, s);
    case 128:
      return launch<128>(q, k, v, pos0, B, KVH, R, T, S, scale, softcap, window, out, scratch,
                         counters, s);
    default:
      return launch<256>(q, k, v, pos0, B, KVH, R, T, S, scale, softcap, window, out, scratch,
                         counters, s);
  }
}

// The launch floor of rlt_gqa_decode at these shapes: an empty kernel with the
// same grid, block and dynamic shared memory.  For measurements only.
extern "C" int rlt_gqa_decode_floor(int B, int KVH, int R, int hd, int S, void* stream) {
  if (!shape_ok(B, KVH, R, hd, S)) return (int)cudaErrorInvalidValue;
  static bool smem_allowed[kMaxDevices] = {};
  const cudaError_t err = allow_smem(floor_kernel, smem_allowed);
  if (err != cudaSuccess) return (int)err;
  floor_kernel<<<dim3(num_splits(S), KVH, B), kThreads, smem_bytes(hd, R),
                 static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

#ifdef RLT_STAMPS
// Copy the stamps [7][4096] (nanoseconds, by point and block; 0 where a block
// did not pass) to `host`, then clear them.  For measurements only.
extern "C" int rlt_gqa_decode_stamps(unsigned long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));
  if (err != cudaSuccess) return (int)err;
  void* dev = nullptr;
  err = cudaGetSymbolAddress(&dev, g_stamps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemset(dev, 0, sizeof(g_stamps));
}
#endif
