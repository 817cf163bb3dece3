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
// applied to v: out [B, KVH, REP, T, hd] f32.  A row with no valid key at all
// (a negative position, or one past S + w - 1) gets the uniform softmax over
// every key, as the plain version gives it.
//
// What bounds it on an H100.  Operations at prompt lengths: 4 * REP * T * hd
// flops per key and group against 4 * hd bytes of K/V, thousands of flops a
// byte at T = 2048 where the card turns at about 295, so the tensor cores'
// 989 TFLOP/s are the limit, and only `wgmma` reaches that rate.  The second
// limit is the softmax: one exponential per logit on the SM's special-function
// unit (16 a clock) is about half the time the products take at hd = 128, so
// it has to run beside them, not between them.
//
// Design.
// - Rows.  A block owns (b, g, a tile of 128 packed rows).  A packed row is one
//   (head of the group, query position) pair, heads fastest: row r is head
//   r % HC of position r / HC, with HC = min(REP, 128) heads and 128 / HC
//   positions a tile (25 positions at REP 5; rows past them compute on zero
//   queries and are not written).  Any REP >= 1 fits: REP > 128 takes several
//   head chunks.  Each K/V tile is therefore fetched once for every head of
//   the group, and each of the two consumer warpgroups owns one 64-row wgmma
//   tile of it.
// - Products.  S = Q K^T: A is the Q tile, staged once a block in shared memory
//   (K-major, swizzled), B is the K tile as the cache stores it, [hd][keys]
//   with the keys contiguous: an MN-major B operand (transpose bit set, the
//   descriptor's leading offset steps over 64-key boxes, its stride offset over
//   8 rows of hd).  O += P V: A is P from registers (the S accumulators packed
//   to bf16 in place: the m64nN accumulator layout of two 8-key columns is the
//   m64k16 A layout), B is the V tile [hd][keys], for this product K-major.
//   So the cache's layout costs no transposition on either product.
// - Tiles.  One 2-D tensor map per cache tensor over [B * KVH * hd rows, S
//   columns], box hd x 64 keys with the 128-byte swizzle (a 128-key tile is two
//   boxes; hd = 256 takes 64-key tiles).  One producer thread starts the TMA
//   loads into a ring of stages; `full` mbarriers (transaction bytes) hand a
//   tile to the consumers, `empty` mbarriers hand the stage back, K and V
//   apart so that K's stage is free as soon as S is formed.  Columns past S
//   arrive as zeros.  TMA needs 16-byte aligned bases and rows: S % 8 == 0.
//   For every other S (and only by that condition) the producer warpgroup's
//   128 threads stage the same tiles into the same swizzled layout with plain
//   loads: the "staged" path.  Both count as one kernel.
// - Warp specialisation.  384 threads: two consumer warpgroups (232 registers
//   a thread by setmaxnreg) and one producer warpgroup (40).
// - Softmax beside the products.  Each warpgroup's loop is software-pipelined:
//   tile j's Q K^T and tile j - 1's P V are started together, the softmax of
//   tile j starts when the first is done and runs while the second and the
//   other warpgroup's products occupy the tensor cores; only then are the
//   sums rescaled and P packed.  exp2 with log2(e) folded into the scale (one
//   fma an element on interior tiles); with a soft-cap tanhf is kept
//   (tanh.approx errs by 2^-11, five times what the tolerance allows at a cap
//   of 50).  The per-element mask runs only on tiles that a row's causal
//   limit, a window's lower edge or the end of S crosses; tiles outside every
//   row's range are skipped (their keys would weigh exactly 0), unless some
//   row of the block has no valid key.
// - Order.  Blocks take query tiles from the last (most keys) to the first, so
//   the card does not drain on the heaviest tiles.
//
// Shapes and paths.  hd in {32, 64, 128, 256}; tiles of 128 keys (64 at
// hd = 256), two stages of K and V (four at hd <= 64).  S % 8 == 0 with
// 16-byte aligned caches (the decoder's caches, the RAG prompt's S = 8,352):
// TMA.  Any other S (2,211, 227): the staged path.
//
// Tried on the card and left out (no gain at T = 8,192, hd = 128): a third
// stage; named barriers that make the two warpgroups take turns at the tensor
// cores; skipping the rescale when no row of a warp moved its max.  With the
// softmax compiled out the kernel still takes four fifths of its time: the
// products themselves run at about 70 % of the tensor cores' rate, beside
// shared-memory traffic of about 110 of the SM's 128 bytes a clock (Q and K
// read per 64-row wgmma, V, and TMA's writes).  Q as register fragments would
// cut that; at hd = 128 it leaves no registers to spare.
//
// Rounding.  P is rounded to bf16 unnormalised (against the running max) where
// the plain version rounds the normalised probabilities, and the online
// rescaling multiplies in another order, so the two agree to a tolerance
// (attention_tolerance in ops/decode_attention.py), not bit for bit.

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int kRows = 128;       // packed rows a block owns: 64 per consumer warpgroup
constexpr int kConsumers = 2;    // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBox = 64;         // keys per TMA box: 128 bytes, the swizzle's span
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = -1e9f * kLog2e;  // the plain version's -1e9, in the exp2 domain

template <int HD>
struct Cfg {
  static constexpr int BK = HD <= 128 ? 128 : 64;  // keys per tile
  static constexpr int NBOX = BK / kBox;
  static constexpr int STAGES = HD >= 128 ? 2 : 4;
  static constexpr int Q_BYTES = kRows * HD * 2;
  static constexpr int BOX_BYTES = HD * kBox * 2;
  static constexpr int TILE_BYTES = NBOX * BOX_BYTES;  // one K or one V tile
  static constexpr int BAR_OFFSET = Q_BYTES + STAGES * 2 * TILE_BYTES;
  // 1 KB of slack to align the base: the swizzle works on address bits.
  static constexpr int SMEM = 1024 + BAR_OFFSET + 4 * STAGES * 8;
  static constexpr int OW = HD <= 128 ? HD / 2 : 64;  // accumulators per output half
  static constexpr int OH = HD <= 128 ? 1 : 2;        // output halves of 128 columns
};

struct Params {
  int KVH, REP, T, S;
  int HC, P, NHC;    // heads a tile, positions a tile, head chunks
  int NQT, INNER;    // query tiles, blocks per query tile
  int window;
  float scale, softcap;
  int tma, vec;      // tiles by TMA; else staged by threads, in 16-byte pieces if vec
};

// ---- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of the tensor map at (column c0, row c1) -> shared memory; the bytes
// are reported to `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Makes this thread's shared-memory stores visible to wgmma and TMA.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers that an asynchronous wgmma writes or reads: the compiler may
// neither read them earlier nor reuse them before this point.
template <int N>
__device__ __forceinline__ void pin(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(x[i])::"memory");
}

// Shared-memory matrix descriptor: address, leading and stride byte offsets in
// 16-byte units, layout 1 = 128-byte swizzle, 2 = 64-byte swizzle.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

#define RLT_REGS16 "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}"
#define RLT_REGS32                                                                              \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24," \
  "%25,%26,%27,%28,%29,%30,%31}"
#define RLT_REGS64                                                                              \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24," \
  "%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,"    \
  "%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}"
#define RLT_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define RLT_F16(d, i) RLT_F4(d, i), RLT_F4(d, i + 4), RLT_F4(d, i + 8), RLT_F4(d, i + 12)
#define RLT_F32(d, i) RLT_F16(d, i), RLT_F16(d, i + 16)
#define RLT_F64(d, i) RLT_F32(d, i), RLT_F32(d, i + 32)

// d[64 x N] (+)= A[64 x 16] B[16 x N], bf16 in, f32 out, one warpgroup.
//   ss: A and B from shared memory, B MN-major (the K tile): transpose bit 1.
//   rs: A from registers, B from shared memory K-major (the V tile).
template <int N>
struct Mma;

template <>
struct Mma<32> {
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t* a, uint64_t b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " RLT_REGS16
                 ", {%16,%17,%18,%19}, %20, p, 1, 1, 0;\n}\n"
                 : RLT_F16(d, 0)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b,
                                            int accumulate) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RLT_REGS32
                 ", %32, %33, p, 1, 1, 0, 1;\n}\n"
                 : RLT_F32(d, 0)
                 : "l"(a), "l"(b), "r"(accumulate));
  }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t* a, uint64_t b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RLT_REGS32
                 ", {%32,%33,%34,%35}, %36, p, 1, 1, 0;\n}\n"
                 : RLT_F32(d, 0)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b,
                                            int accumulate) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " RLT_REGS64
                 ", %64, %65, p, 1, 1, 0, 1;\n}\n"
                 : RLT_F64(d, 0)
                 : "l"(a), "l"(b), "r"(accumulate));
  }
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t* a, uint64_t b) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " RLT_REGS64
                 ", {%64,%65,%66,%67}, %68, p, 1, 1, 0;\n}\n"
                 : RLT_F64(d, 0)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// Two f32 -> one register of two bf16 (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// 2^x on the special-function unit (2 ulp; -inf gives 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Built with -DRLT_STAMPS, every block notes where its time goes (the card has
// no other profiler that sees inside a kernel); rlt_gqa_prefill_stamps reads
// the notes back.  Points in time are the card's global timer (nanoseconds),
// durations are sums of SM clocks.  Without the flag the notes are nothing.
enum Stamp {
  kStart,         // block start (ns)
  kFirstTile,     // the first K tile has landed for consumer 0 (ns)
  kEnd,           // consumer 0 has written its rows (ns)
  kTiles,         // key tiles of the block
  kWaitTile,      // consumer 0 waiting for K and V tiles (clocks)
  kProduct,       // consumer 0 waiting for its own wgmma groups (clocks)
  kSoftmax,       // consumer 0 in the softmax, scaling and packing (clocks)
  kProducerWait,  // the producer waiting for an empty stage (clocks)
  kQueueing,      // consumer 0 queueing wgmma (clocks): it stalls while the tensor cores are busy
  kClocks,        // consumer 0 from the block's start to its end (clocks)
  kStamps
};
#ifdef RLT_STAMPS
constexpr int kStampBlocks = 4096;
__device__ unsigned long long g_stamps[kStamps * kStampBlocks];
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void note(Stamp slot, unsigned long long value) {
  if (blockIdx.x < kStampBlocks) g_stamps[slot * kStampBlocks + blockIdx.x] = value;
}
#define RLT_NOTE(who, slot, value) \
  if (threadIdx.x == (who)) note(slot, value)
#define RLT_CLOCK(var) const long long var = clock64()
#define RLT_SPENT(sum, since) sum += clock64() - (since)
#else
#define RLT_NOTE(who, slot, value)
#define RLT_CLOCK(var)
#define RLT_SPENT(sum, since)
#endif

// ---- The producer's staged path --------------------------------------------

// Stage `dst` <- the K or V columns [kt0, kt0 + BK) of the rows at `src`
// ([hd][S]), zero past S, in the layout TMA's 128-byte swizzle writes: boxes
// of 64 keys, row d of a box at d * 128 bytes, its 16-byte piece c at piece
// c ^ (d % 8).
template <int HD>
__device__ __forceinline__ void stage_tile(uint8_t* dst, const uint16_t* __restrict__ src, int S,
                                           int kt0, bool vec, int tid) {
  constexpr int BK = Cfg<HD>::BK;
  constexpr int BATCH = 4;  // pieces a thread has in flight: the loads first, then the stores
  static_assert(HD * (BK / 8) % (128 * BATCH) == 0, "a tile is whole batches of pieces");
  for (int i0 = tid; i0 < HD * (BK / 8); i0 += 128 * BATCH) {
    uint4 piece[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = i0 + u * 128;
      const int d = i / (BK / 8), key0 = kt0 + (i % (BK / 8)) * 8;
      const uint16_t* row = src + (size_t)d * S;
      piece[u] = make_uint4(0u, 0u, 0u, 0u);
      if (vec) {  // S % 8 == 0: a piece is wholly inside or outside
        if (key0 < S) piece[u] = *reinterpret_cast<const uint4*>(row + key0);
      } else {
        uint32_t w[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int s0 = key0 + 2 * x;
          const uint32_t lo = s0 < S ? row[s0] : 0u;
          const uint32_t hi = s0 + 1 < S ? row[s0 + 1] : 0u;
          w[x] = lo | (hi << 16);
        }
        piece[u] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = i0 + u * 128;
      const int d = i / (BK / 8), c = i % (BK / 8);
      const int box = c / 8, cc = c % 8;
      *reinterpret_cast<uint4*>(dst + box * Cfg<HD>::BOX_BYTES + d * 128 + ((cc ^ (d & 7)) << 4)) =
          piece[u];
    }
  }
}

// ---- The kernel -------------------------------------------------------------

// grid = NQT * INNER blocks (query tiles from the last to the first; within
// one, batch row, kv group and head chunk), block = 384 threads.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
prefill_kernel(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
               const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
               const uint16_t* __restrict__ v, const int* __restrict__ off,
               float* __restrict__ out, const Params p) {
  using C = Cfg<HD>;
  constexpr int BK = C::BK, STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sm = smem_raw + (base - raw);  // Q | stages of (K, V) | barriers
  const uint32_t tiles = base + C::Q_BYTES;
  const uint32_t bars = base + C::BAR_OFFSET;
  auto full_k = [&](int st) { return bars + 8u * st; };
  auto full_v = [&](int st) { return bars + 8u * (STAGES + st); };
  auto empty_k = [&](int st) { return bars + 8u * (2 * STAGES + st); };
  auto empty_v = [&](int st) { return bars + 8u * (3 * STAGES + st); };

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      // A TMA tile arrives by its bytes and the one expect_tx; a staged tile
      // by each of the 128 producer threads.  A stage is handed back by lane 0
      // of each consumer warp.
      mbar_init(full_k(st), p.tma ? 1 : 128);
      mbar_init(full_v(st), p.tma ? 1 : 128);
      mbar_init(empty_k(st), kConsumers * 4);
      mbar_init(empty_v(st), kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x == kConsumers * 128 && p.tma) {  // fetch the maps while the block sets up
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&kmap)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&vmap)) : "memory");
  }
  __syncthreads();
  RLT_NOTE(0, kStart, now_ns());

  // The block's place: heaviest query tiles first.
  const int qt = p.NQT - 1 - blockIdx.x / p.INNER;
  const int rem = blockIdx.x % p.INNER;
  const int hc0 = (rem % p.NHC) * p.HC;
  const int g = (rem / p.NHC) % p.KVH, b = rem / (p.NHC * p.KVH);
  const int tq0 = qt * p.P;
  const int o = off[b];
  const int S = p.S, window = p.window;

  // Keys the block needs: [lo_key, hi_key].  If some row of the block has no
  // valid key at all (positions >= S + window - 1, or negative offsets), every
  // key counts for it (uniform softmax, as in the plain version): no skipping.
  const int pos_min = o + tq0;
  const int pos_max = o + min(tq0 + p.P, p.T) - 1;
  const bool all = o < 0 || (window > 0 && pos_max - window + 1 > S - 1);
  const int hi_key = all ? S - 1 : min(pos_max, S - 1);
  const int lo_key = (all || window <= 0) ? 0 : max(0, pos_min - window + 1);
  const int first = (lo_key / BK) * BK;
  const int ntiles = hi_key >= first ? (hi_key - first) / BK + 1 : 0;
  const int kv_row = (b * p.KVH + g) * HD;  // first row of (b, g) in [B * KVH * hd, S]
  RLT_NOTE(0, kTiles, ntiles);

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- Producer: keeps the ring of K and V tiles full. ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
#ifdef RLT_STAMPS
    long long waited = 0;
#endif
    if (p.tma) {
      if (threadIdx.x == kConsumers * 128) {
        for (int j = 0; j < ntiles; ++j) {
          const int st = j % STAGES, kt0 = first + j * BK;
          // The first round finds every stage empty.
          const uint32_t parity = ((j / STAGES) & 1) ^ 1;
          const uint32_t ks = tiles + st * 2 * C::TILE_BYTES, vs = ks + C::TILE_BYTES;
          RLT_CLOCK(t0);
          mbar_wait(empty_k(st), parity);
          RLT_SPENT(waited, t0);
          mbar_expect_tx(full_k(st), C::TILE_BYTES);
#pragma unroll
          for (int x = 0; x < C::NBOX; ++x)
            tma_load_2d(ks + x * C::BOX_BYTES, &kmap, full_k(st), kt0 + x * kBox, kv_row);
          RLT_CLOCK(t1);
          mbar_wait(empty_v(st), parity);
          RLT_SPENT(waited, t1);
          mbar_expect_tx(full_v(st), C::TILE_BYTES);
#pragma unroll
          for (int x = 0; x < C::NBOX; ++x)
            tma_load_2d(vs + x * C::BOX_BYTES, &vmap, full_v(st), kt0 + x * kBox, kv_row);
        }
      }
    } else {
      const int tid = threadIdx.x - kConsumers * 128;
      const uint16_t* ksrc = k + (size_t)kv_row * S;
      const uint16_t* vsrc = v + (size_t)kv_row * S;
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % STAGES, kt0 = first + j * BK;
        const uint32_t parity = ((j / STAGES) & 1) ^ 1;
        uint8_t* ks = sm + C::Q_BYTES + st * 2 * C::TILE_BYTES;
        RLT_CLOCK(t0);
        mbar_wait(empty_k(st), parity);
        RLT_SPENT(waited, t0);
        stage_tile<HD>(ks, ksrc, S, kt0, p.vec, tid);
        fence_async_proxy();
        mbar_arrive(full_k(st));
        RLT_CLOCK(t1);
        mbar_wait(empty_v(st), parity);
        RLT_SPENT(waited, t1);
        stage_tile<HD>(ks + C::TILE_BYTES, vsrc, S, kt0, p.vec, tid);
        fence_async_proxy();
        mbar_arrive(full_v(st));
      }
    }
    RLT_NOTE(kConsumers * 128, kProducerWait, waited);
  } else {
    // ---- Consumers: 64 packed rows each. ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g8 = lane >> 2, t4 = lane & 3;
    const size_t head0 = (size_t)(b * p.KVH + g) * p.REP;  // first head of the group

    // Packed row r of the block -> its query row in q and out, or -1.
    auto query_row = [&](int r) -> long long {
      const int pl = r / p.HC, head = hc0 + r % p.HC, t = tq0 + pl;
      return (pl < p.P && head < p.REP && t < p.T) ? (long long)((head0 + head) * p.T + t) : -1;
    };

    // Stage this warpgroup's Q rows, K-major and swizzled: 64-column blocks of
    // 128-byte rows (128-byte swizzle), or at hd = 32 one block of 64-byte
    // rows (64-byte swizzle: piece c of row r at piece c ^ ((r / 2) % 4)).
    {
      constexpr int PIECES = HD / 8;  // 16-byte pieces a row
      constexpr int BATCH = PIECES / 2 < 8 ? PIECES / 2 : 8;  // loads in flight a thread
      uint8_t* qs = sm + wg * (64 * HD * 2);
      for (int i0 = tid; i0 < 64 * PIECES; i0 += 128 * BATCH) {
        uint4 piece[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {  // the loads first: one trip to memory, not BATCH
          const int i = i0 + u * 128;
          const long long row = query_row(wg * 64 + i / PIECES);
          piece[u] = make_uint4(0u, 0u, 0u, 0u);
          if (row >= 0)
            piece[u] = *reinterpret_cast<const uint4*>(q + row * HD + (i % PIECES) * 8);
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          const int i = i0 + u * 128;
          const int r = i / PIECES, c = i % PIECES;
          const int at = HD >= 64 ? (c / 8) * 8192 + r * 128 + (((c % 8) ^ (r & 7)) << 4)
                                  : r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
          *reinterpret_cast<uint4*>(qs + at) = piece[u];
        }
      }
      fence_async_proxy();
      named_sync(1 + wg, 128);
    }
    const uint32_t qs = base + wg * (64 * HD * 2);
    // k16 step kk of Q: within a 64-column block the step is 32 bytes.
    auto q_desc = [&](int kk) {
      return HD >= 64 ? make_desc(qs + (kk / 4) * 8192 + (kk % 4) * 32, 16, 1024, 1)
                      : make_desc(qs + kk * 32, 16, 512, 2);
    };

    const int row_a = wg * 64 + warp * 16 + g8, row_b = row_a + 8;  // this thread's two rows
    const int pos_a = o + tq0 + row_a / p.HC, pos_b = o + tq0 + row_b / p.HC;
    const float sl2 = p.scale * kLog2e;
    const float cap_in = p.softcap > 0.0f ? p.scale / p.softcap : 0.0f;
    const float cap_out = p.softcap * kLog2e;

    float m[2] = {-INFINITY, -INFINITY};  // running max, exp2 domain
    float l[2] = {0.0f, 0.0f};            // this thread's share of the running sum
    float acc[C::OH][C::OW];
#pragma unroll
    for (int h = 0; h < C::OH; ++h)
#pragma unroll
      for (int i = 0; i < C::OW; ++i) acc[h][i] = 0.0f;
#ifdef RLT_STAMPS
    long long wait_tile = 0, product = 0, softmax = 0, queueing = 0;
    const long long block_t0 = clock64();
#endif

    float s[BK / 2];       // the tile's logits, then its unnormalised probabilities
    uint32_t pa[BK / 4];   // the previous tile's probabilities, bf16, as A fragments
    float corr[2];

    // S = Q K^T of tile j, started.  K is MN-major: 16 rows of hd a step,
    // 64-key boxes apart by the leading offset, 8-row groups by 1024 bytes.
    auto start_qk = [&](int j) {
      const int st = j % STAGES;
      const uint32_t ks = tiles + st * 2 * C::TILE_BYTES;
      RLT_CLOCK(t0);
      mbar_wait(full_k(st), (j / STAGES) & 1);
      RLT_SPENT(wait_tile, t0);
      RLT_CLOCK(t1);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        Mma<BK>::ss(s, q_desc(kk), make_desc(ks + kk * 2048, C::BOX_BYTES, 1024, 1), kk > 0);
      wgmma_commit();
      RLT_SPENT(queueing, t1);
    };
    // O += P V of tile j, started.  V is K-major: 16 keys a step are 32 bytes
    // within a box.
    auto start_pv = [&](int j) {
      const int st = j % STAGES;
      const uint32_t vs = tiles + st * 2 * C::TILE_BYTES + C::TILE_BYTES;
      RLT_CLOCK(t0);
      mbar_wait(full_v(st), (j / STAGES) & 1);
      RLT_SPENT(wait_tile, t0);
      RLT_CLOCK(t1);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int h = 0; h < C::OH; ++h)
          Mma<2 * C::OW>::rs(acc[h], &pa[4 * kk],
                             make_desc(vs + (kk / 4) * C::BOX_BYTES + (kk % 4) * 32 + h * 16384, 16,
                                       1024, 1));
      wgmma_commit();
      RLT_SPENT(queueing, t1);
    };
    // Tile j's logits in s -> unnormalised probabilities in s (exp2 domain,
    // against the new running max), m, l and corr (what the old max's sums
    // must be scaled by) brought up to date.
    auto softmax_tile = [&](int j) {
      const int kt0 = first + j * BK;
      const bool crossing = all || kt0 + BK - 1 > pos_min || kt0 + BK > S ||
                            (window > 0 && kt0 <= pos_max - window);
      const bool folded = !crossing && p.softcap <= 0.0f && sl2 > 0.0f;
      float mx[2] = {-INFINITY, -INFINITY};
      if (folded) {
        // Interior tile, no soft-cap: the scale goes into the exponent's fma.
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        mx[0] *= sl2, mx[1] *= sl2;
      } else {
        if (p.softcap > 0.0f) {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) s[i] = cap_out * tanhf(s[i] * cap_in);
        } else {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) s[i] *= sl2;
        }
        if (crossing) {
#pragma unroll
          for (int i = 0; i < BK / 2; ++i) {
            const int key = kt0 + (i / 4) * 8 + 2 * t4 + (i & 1);
            const int pos = (i & 2) ? pos_b : pos_a;
            const bool ok = key <= pos && (window <= 0 || key > pos - window);
            const float x = ok ? s[i] : kMasked;
            s[i] = key < S ? x : -INFINITY;
          }
        }
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows a (i & 2 == 0) and b
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);  // finite: every tile has a key < S
        corr[h] = fast_exp2(m[h] - m_new);
        m[h] = m_new;
      }
      float rs[2] = {0.0f, 0.0f};
      if (folded) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          s[i] = fast_exp2(fmaf(s[i], sl2, -m[(i >> 1) & 1]));
          rs[(i >> 1) & 1] += s[i];
        }
      } else {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          s[i] = fast_exp2(s[i] - m[(i >> 1) & 1]);
          rs[(i >> 1) & 1] += s[i];
        }
      }
      l[0] = l[0] * corr[0] + rs[0];
      l[1] = l[1] * corr[1] + rs[1];
    };
    // P (bf16) from the S accumulators: 8-key columns 2c and 2c + 1 form the
    // A fragment of keys 16c .. 16c + 15.
    auto pack_p = [&]() {
#pragma unroll
      for (int c = 0; c < BK / 16; ++c) {
        pa[4 * c + 0] = pack_bf16(s[8 * c + 0], s[8 * c + 1]);
        pa[4 * c + 1] = pack_bf16(s[8 * c + 2], s[8 * c + 3]);
        pa[4 * c + 2] = pack_bf16(s[8 * c + 4], s[8 * c + 5]);
        pa[4 * c + 3] = pack_bf16(s[8 * c + 6], s[8 * c + 7]);
      }
    };
    auto pin_acc = [&]() {
#pragma unroll
      for (int h = 0; h < C::OH; ++h) pin(acc[h]);
    };

    // The loop, software-pipelined: tile j's Q K^T and tile j - 1's P V are in
    // flight on the tensor cores while tile j's softmax waits only for the
    // first of them.
    if (ntiles > 0) {
      wgmma_fence();
      start_qk(0);
      RLT_NOTE(0, kFirstTile, now_ns());
      RLT_CLOCK(t0);
      wgmma_wait<0>();
      pin(s);
      RLT_SPENT(product, t0);
      if (lane == 0) mbar_arrive(empty_k(0));
      RLT_CLOCK(t1);
      softmax_tile(0);
      pack_p();
      RLT_SPENT(softmax, t1);
    }
    for (int j = 1; j < ntiles; ++j) {
      wgmma_fence();
      start_qk(j);
      start_pv(j - 1);
      RLT_CLOCK(t0);
      wgmma_wait<1>();  // Q K^T of tile j is done; P V of tile j - 1 may still run
      pin(s);
      RLT_SPENT(product, t0);
      if (lane == 0) mbar_arrive(empty_k(j % STAGES));
      RLT_CLOCK(t1);
      softmax_tile(j);
      RLT_SPENT(softmax, t1);
      RLT_CLOCK(t2);
      wgmma_wait<0>();
      pin_acc();
      pin(pa);
      RLT_SPENT(product, t2);
      if (lane == 0) mbar_arrive(empty_v((j - 1) % STAGES));
      RLT_CLOCK(t3);
#pragma unroll
      for (int h = 0; h < C::OH; ++h)
#pragma unroll
        for (int i = 0; i < C::OW; ++i) acc[h][i] *= corr[(i >> 1) & 1];
      pack_p();
      RLT_SPENT(softmax, t3);
    }
    if (ntiles > 0) {
      wgmma_fence();
      start_pv(ntiles - 1);
      RLT_CLOCK(t0);
      wgmma_wait<0>();
      pin_acc();
      pin(pa);
      RLT_SPENT(product, t0);
      if (lane == 0) mbar_arrive(empty_v((ntiles - 1) % STAGES));
    }

    // Normalise and write this thread's two rows.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
    const float inv_a = 1.0f / l[0], inv_b = 1.0f / l[1];
    const long long out_a = query_row(row_a), out_b = query_row(row_b);
#pragma unroll
    for (int h = 0; h < C::OH; ++h)
#pragma unroll
      for (int nt = 0; nt < C::OW / 4; ++nt) {
        const int c = h * 128 + nt * 8 + 2 * t4;
        if (out_a >= 0)
          *reinterpret_cast<float2*>(out + out_a * HD + c) =
              make_float2(acc[h][4 * nt] * inv_a, acc[h][4 * nt + 1] * inv_a);
        if (out_b >= 0)
          *reinterpret_cast<float2*>(out + out_b * HD + c) =
              make_float2(acc[h][4 * nt + 2] * inv_b, acc[h][4 * nt + 3] * inv_b);
      }
    RLT_NOTE(0, kEnd, now_ns());
    RLT_NOTE(0, kWaitTile, wait_tile);
    RLT_NOTE(0, kProduct, product);
    RLT_NOTE(0, kSoftmax, softmax);
    RLT_NOTE(0, kQueueing, queueing);
    RLT_NOTE(0, kClocks, clock64() - block_t0);
  }
}

// ---- Host side --------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, fetched through the runtime (the
// library links no libcuda), or null.
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      ptr = nullptr;
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// The tensor map of one cache tensor: [rows, S] bf16, box [hd, 64 keys], 128-byte
// swizzle, zeros past the edge.  Encoding takes the host microseconds, so maps
// are kept by everything they encode; no device memory is involved.
bool tensor_map(const void* ptr, long long rows, int S, int hd, CUtensorMap* out) {
  using Key = std::tuple<uintptr_t, long long, int, int>;
  static std::mutex lock;
  static std::map<Key, CUtensorMap> maps;
  const Key key{reinterpret_cast<uintptr_t>(ptr), rows, S, hd};
  std::lock_guard<std::mutex> guard(lock);
  const auto it = maps.find(key);
  if (it != maps.end()) {
    *out = it->second;
    return true;
  }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)S, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)S * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBox, (cuuint32_t)hd};
  const cuuint32_t steps[2] = {1, 1};
  if (encode(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
             steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (maps.size() >= 4096) maps.clear();
  maps.emplace(key, *out);
  return true;
}

constexpr int kMaxDevices = 64;

template <int HD>
int launch(const void* q, const void* k, const void* v, const int* off, int B, int KVH, int REP,
           int T, int S, float scale, float softcap, int window, float* out, bool staged,
           cudaStream_t stream) {
  static bool smem_allowed[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidValue;
  if (!smem_allowed[dev]) {
    err = cudaFuncSetAttribute(prefill_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Cfg<HD>::SMEM);
    if (err != cudaSuccess) return (int)err;
    smem_allowed[dev] = true;
  }
  Params p;
  p.KVH = KVH, p.REP = REP, p.T = T, p.S = S;
  p.HC = REP < kRows ? REP : kRows;
  p.P = kRows / p.HC;
  p.NHC = (REP + p.HC - 1) / p.HC;
  p.NQT = (T + p.P - 1) / p.P;
  p.INNER = B * KVH * p.NHC;
  p.window = window, p.scale = scale, p.softcap = softcap;
  // TMA wants 16-byte aligned bases and rows; every other S is staged by the
  // producer's threads.  The choice is by shape alone, never by a failure.
  p.vec = S % 8 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(v) % 16 == 0;
  p.tma = p.vec && !staged;
  if ((long long)p.NQT * p.INNER > 0x7fffffffLL || (long long)B * KVH * HD > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap kmap = {}, vmap = {};
  if (p.tma && !(tensor_map(k, (long long)B * KVH * HD, S, HD, &kmap) &&
                 tensor_map(v, (long long)B * KVH * HD, S, HD, &vmap)))
    return (int)cudaErrorNotSupported;
  prefill_kernel<HD><<<p.NQT * p.INNER, kThreads, Cfg<HD>::SMEM, stream>>>(
      kmap, vmap, static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), off, out, p);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, const int* off, int B, int KVH, int REP,
             int T, int hd, int S, float scale, float softcap, int window, float* out, bool staged,
             void* stream) {
  if (B <= 0 || KVH <= 0 || REP <= 0 || T <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch<32>(q, k, v, off, B, KVH, REP, T, S, scale, softcap, window, out, staged, s);
    case 64:
      return launch<64>(q, k, v, off, B, KVH, REP, T, S, scale, softcap, window, out, staged, s);
    case 128:
      return launch<128>(q, k, v, off, B, KVH, REP, T, S, scale, softcap, window, out, staged, s);
    case 256:
      return launch<256>(q, k, v, off, B, KVH, REP, T, S, scale, softcap, window, out, staged, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Host launcher with a plain C interface; returns a cudaError_t value (0 on
// success).  hd in {32, 64, 128, 256}, any REP.  Tiles come by TMA where
// S % 8 == 0 and the caches are 16-byte aligned, else by the staged path.
extern "C" int rlt_gqa_prefill(const void* q, const void* k, const void* v, const int* off,
                               int B, int KVH, int REP, int T, int hd, int S, float scale,
                               float softcap, int window, float* out, void* stream) {
  return dispatch(q, k, v, off, B, KVH, REP, T, hd, S, scale, softcap, window, out, false, stream);
}

// The same with the tiles staged by the producer's threads whatever S is.  For
// measurements only: what TMA buys at the shapes that take it.
extern "C" int rlt_gqa_prefill_staged(const void* q, const void* k, const void* v, const int* off,
                                      int B, int KVH, int REP, int T, int hd, int S, float scale,
                                      float softcap, int window, float* out, void* stream) {
  return dispatch(q, k, v, off, B, KVH, REP, T, hd, S, scale, softcap, window, out, true, stream);
}

#ifdef RLT_STAMPS
// Copy the notes [kStamps][4096] (by point and block; 0 where a block noted
// nothing) to `host`, then clear them.  For measurements only.
extern "C" int rlt_gqa_prefill_stamps(unsigned long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));
  if (err != cudaSuccess) return (int)err;
  void* dev = nullptr;
  err = cudaGetSymbolAddress(&dev, g_stamps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemset(dev, 0, sizeof(g_stamps));
}
#endif
