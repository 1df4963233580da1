// Whole-scan GRU beam search for NVIDIA Hopper (sm_90a), fp32 and bf16.
//
// Replaces the TPU kernel controlled_peptide_generation_tpu/ops/
// pallas_beam.py:beam_scan_gru (kernel body _kernel). One launch runs all
// T steps of the beam for every sentence: per step and beam, the GRU cell
// over the pre-gated input (tok_table[prev] + zc_gi), the output head, an
// fp32 log-softmax, the candidate masking, an iterated top-K over the K*V
// candidates with ties to the lowest flat index k*V+v, the done gating and
// the hidden-state reorder by backpointer. It emits the per-step tapes
// ys/ptr/sc [B,T,K] and the final scores [B,K], adv [B], fin_cnt [B];
// the heap reconstruction and backtrace stay in torch (ops/beam.py).
//
// What bounds it on the H100: operations. At the shipped width (H 102,
// V 24, K 5, T 25) a sentence costs K*T*2*(H*3H + H*V) = 8.5 MFLOP
// against ~0.5 KB of inputs and outputs: 42 GFLOP for a round of 5,000
// sentences, 0.63 ms at the fp32 rate of the CUDA cores (67 TFLOP/s),
// 0.043 ms at the bf16 tensor-core rate (989 TFLOP/s); the per-step
// [K, H] x [H, 3H] product of one sentence is a matrix-vector-like shape.
//
// Where the time went (the stamp entries, tools/beam_split.py, B 5,000,
// in the previous design of one thread per (sentence, hidden unit), ten
// sentences and 1,020 threads a block, four block-wide phases): the GRU
// cell 69% of a step, bound by shared loads (3 weight and 5 h loads of 4
// bytes per 15 FMAs); the selection 16% and the head 10% on 10 and 8 of
// 32 warps while the rest of the SM waited at the barrier; 3.79 waves.
// What this design does about each:
// * One warp per sentence, and nothing in the scan waits for another
//   warp: the cell, the head, the selection and the reorder of a sentence
//   follow each other within its warp (__syncwarp only), so one warp's
//   selection runs while the others' cells use the FMA units or the
//   tensor cores.
// * The f32 cell: lane l computes units l, l + NL, l + 2NL, l + 3NL
//   (NL = ceil(H/4) lanes) of all three gates for 5 beams at a time, 60
//   sums in registers. Per 4 k it reads 5 h rows as 16-byte broadcasts
//   (all lanes one address) and 12 weight vectors of 4 k as 16-byte loads
//   from a transposed f32 copy [gate][unit][k] whose row stride LDW (4 x
//   an odd number, 108 at H 102) puts a quarter-warp's rows on distinct
//   banks: 17 loads per 240 FMAs, against 8 per 15. The head: lane v of a
//   pass of 32 columns, 5 beams at a time, the same 16-byte reads from a
//   transposed copy of w_out. Every sum is one sequential FMA chain over
//   k in order (as the plain version's f32 SGEMM accumulates), the bias
//   added after.
// * The bf16 kernel (beam_gru_mma_kernel; the two kernels share the
//   block prologue, a sentence's set-up, the selection, the reorder and
//   the outputs) runs the cell and head on the tensor cores (mma.sync
//   m16n8k16, bf16 inputs, f32 accumulators): gh^T = wh^T h^T with the
//   units as the 16 rows of a tile and 8 beams as its columns (beams 5-7
//   zero at K 5),
//   per gate 7 unit tiles x 7 k steps at H 102; the head logits^T =
//   w_out^T hn^T, 2 vocabulary tiles. The weights are a transposed bf16
//   copy [gate][unit][k] (ops/beam_kernel.py:mma_layout), 88 KB at
//   H 102, read by ldmatrix.x4 from rows LDK = KP + 8 values apart so
//   that a phase's eight 16-byte rows hit distinct banks; h's B fragments
//   are packed once per step from its f32 rows. Each lane ends with its
//   tile's outputs for 2 units x 2 beams of all three gates in registers,
//   so the gate math follows in place. 16 warps a block (the bf16 kernel
//   needs under 128 registers).
// * A persistent grid: at most one block per SM, up to 8 warps (f32) or
//   16 (bf16) as shared memory allows, each warp walking the sentences
//   b*S + w, + grid*S, ... so that the last round's sentences spread over
//   every SM.
// This design's split (B 5,000, warp 0's sentences): f32 the cell 69%, the
// selection 19%, the head 9%; bf16 the cell 69% (its gi gathers and gate
// math now, not its products), the selection 23%, the head 5%.
// Each sentence's result does not depend on which warp or block ran it:
// bitwise batch invariance. The f32 results equal the previous design's
// bitwise. The bf16 sums are the tensor cores' (exact bf16 products,
// accumulated in f32 in the hardware's order), not the plain version's
// sequential chain, so near-tie rows may pick another token than the
// plain version: chip_smoke.py's bf16 gates bound that share.
//
// Scope: V <= 128, H <= 127, T*K <= 256; beams beyond 5 (f32) or 8 (bf16)
// go in chunks. Where the weights and one warp's state do not fit the
// 227 KB a block can opt into (H 127 with V 128 and large K), the
// transposed weights are read from device memory through the L1/L2 caches
// (the kSmemW = false instantiations).
//
// bf16 (entry beam_gru_bf16): bf16 storage for the inputs and the weights;
// the hidden states stay in shared memory as floats that hold bf16 values.
// Rounded to bf16 (round to nearest even) where the JAX kernel rounds in
// interpret mode (ops/beam_kernel.py:gru_cell_bf16_points): gi =
// tok_table[prev] + zc_gi; gh and the logits accumulated in f32 with
// their bias added and rounded once; r and z the f32 sigmoid (expf) of
// the unrounded f32 sum gi + gh, rounded; n the f32 tanhf of gi_n plus
// the rounded r * gh_n, rounded; the blend (1 - z) * n + z * h with each
// op rounded. The log-softmax, scores and top-K stay f32, so the tie rule
// is unchanged: equal candidates, far more common on bf16 logits, go to
// the lowest flat index k*V+v. The fp32 instantiation's rounding is the
// identity.
//
// Stamps: the kStamp instantiations (entries *_stamp, measurement only)
// clock the phases of warp 0's sentences; the production entries compile
// them away.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int PAD_IDX = 1;
constexpr int START_IDX = 2;
constexpr int EOS_IDX = 3;
constexpr float NEG = -1e20f;
constexpr int KC = 5;            // beams per pass of the f32 cell and head
// warps (sentences at once) per block: in f32, 8 warps of up to 255
// registers hold the cell's 60 sums, its 20 h and 12 weight vectors
// without spills; the bf16 tensor-core cell needs under 128, so 16 warps
template <typename St>
constexpr int max_warps() { return 8; }
template <>
constexpr int max_warps<__nv_bfloat16>() { return 16; }
constexpr int MAX_KS = 8;        // 16-k steps of the bf16 products, H <= 128

// The transposed weights' geometry: NL lanes of 4 units each, the units
// padded to HL = 4 NL rows per gate, the head's columns to VP, every row
// LDW values long (4 x an odd number >= HL: a quarter-warp's 16-byte loads
// of consecutive rows hit distinct banks). ops/beam_kernel.py:
// weight_layout builds the same.
struct Geo {
  int NL, HL, LDW, VP;
};

__host__ __device__ inline Geo make_geo(int H, int V) {
  Geo g;
  g.NL = (H + 3) / 4;
  g.HL = 4 * g.NL;
  g.LDW = 4 * (g.NL | 1);
  g.VP = 32 * ((V + 31) / 32);
  return g;
}

// The bf16 instantiation's weights, for the tensor cores: wh^T [3][MU][LDK]
// and w_out^T [VM][LDK] in bf16, units and vocabulary padded to 16 rows
// (one m16n8k16 tile), k to KP = 16 * ceil(H/16), every row LDK = KP + 8
// values long (LDK / 2 words = 4 mod 8: ldmatrix's eight 16-byte rows of
// a phase hit distinct banks). ops/beam_kernel.py:mma_layout builds the
// same.
struct MGeo {
  int KP, LDK, MU, VM;
};

__host__ __device__ inline MGeo make_mgeo(int H, int V) {
  MGeo g;
  g.KP = 16 * ((H + 15) / 16);
  g.LDK = g.KP + 8;
  g.MU = g.KP;
  g.VM = 16 * ((V + 15) / 16);
  return g;
}

// per-warp shared-memory offsets (4-byte words): h and hn [K][HL] f32,
// the candidates [K][V], and the bookkeeping
struct Layout {
  int h, hn, cand, scores, best, prev, nexty, pk, misc, words;
};

__host__ __device__ inline Layout make_layout(int K, int V, int HL) {
  Layout L;
  int o = 0;
  L.h = o;      o += K * HL;
  L.hn = o;     o += K * HL;
  L.cand = o;   o += K * V;
  L.scores = o; o += K;
  L.best = o;   o += K;
  L.prev = o;   o += K;
  L.nexty = o;  o += K;
  L.pk = o;     o += K;
  L.misc = o;   o += 3;          // adv, eos_top, fin_cnt
  L.words = (o + 3) & ~3;        // 16-byte aligned warps
  return L;
}

// shared words of bh as f32, a multiple of four
__host__ __device__ inline int bh_words(int H) { return (3 * H + 3) & ~3; }

// words of the transposed wh: f32 [3][HL][LDW], bf16 [3][MU][LDK] (a
// multiple of four either way)
template <typename St>
__host__ __device__ inline int wh_words(int H, int V) {
  const Geo g = make_geo(H, V);
  return 3 * g.HL * g.LDW;
}
template <>
__host__ __device__ inline int wh_words<__nv_bfloat16>(int H, int V) {
  const MGeo g = make_mgeo(H, V);
  return 3 * g.MU * g.LDK / 2;
}

// shared words of the transposed weights: f32 wh^T [3][HL][LDW] and
// w_out^T [VP][LDW]; bf16 wh^T [3][MU][LDK] and w_out^T [VM][LDK] (a
// multiple of four words either way)
template <typename St>
__host__ __device__ inline int weight_words(int H, int V) {
  const Geo g = make_geo(H, V);
  return (3 * g.HL + g.VP) * g.LDW;
}
template <>
__host__ __device__ inline int weight_words<__nv_bfloat16>(int H, int V) {
  const MGeo g = make_mgeo(H, V);
  return (3 * g.MU + g.VM) * g.LDK / 2;
}

// storage types: a load widens to f32, rnd rounds an f32 result to the
// storage type's precision (the identity for float)
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg(const __nv_bfloat16* p) {
  return __uint_as_float(
      (unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}
// four consecutive weights from shared memory (kSmem) or through the
// read-only cache
template <bool kSmem>
__device__ __forceinline__ float4 ld4(const float* p) {
  return kSmem ? *reinterpret_cast<const float4*>(p)
               : __ldg(reinterpret_cast<const float4*>(p));
}
template <typename T>
__device__ __forceinline__ float rnd(float x) { return x; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float sigmoid_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// h' = (1 - z) * n + z * h; in bf16 each op rounded, as the JAX kernel
template <typename T>
__device__ __forceinline__ float blend(float z, float n, float h) {
  return (1.0f - z) * n + z * h;
}
template <>
__device__ __forceinline__ float blend<__nv_bfloat16>(float z, float n,
                                                      float h) {
  typedef __nv_bfloat16 B;
  return rnd<B>(rnd<B>(rnd<B>(1.0f - z) * n) + rnd<B>(z * h));
}

// component i of v (i a constant after unrolling)
__device__ __forceinline__ float comp(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// four steps of one sequential FMA chain: s += a . w in k order
__device__ __forceinline__ float fma4(float4 a, float4 w, float s) {
  s = fmaf(a.x, w.x, s);
  s = fmaf(a.y, w.y, s);
  s = fmaf(a.z, w.z, s);
  s = fmaf(a.w, w.w, s);
  return s;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// (value, index) argmax over the warp: larger value wins, ties go to the
// lower index (the lowest flat index among equal candidates)
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, v, off);
    int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

// ---- the bf16 instantiation's tensor-core products -----------------------
// Two f32 values that hold bf16 values as one bf16x2 register (exact),
// the lower index in the low half, as mma.sync's fragments take them.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a . b on the tensor cores: m16n8k16, bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A fragment of the 16 x 16 tile at (m0, k0) of a row-major bf16
// matrix of row stride LDK: one ldmatrix.x4 from shared memory (kSmem), or
// four 4-byte loads through the read-only cache.
template <bool kSmem>
__device__ __forceinline__ void lda(uint32_t (&a)[4],
                                    const __nv_bfloat16* W, int LDK, int m0,
                                    int k0) {
  const int lane = threadIdx.x & 31;
  if (kSmem) {
    const int q = lane >> 3;
    const __nv_bfloat16* p =
        W + (m0 + (lane & 7) + 8 * (q & 1)) * LDK + k0 + 8 * (q >> 1);
    const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
        : "r"(addr));
  } else {
    const unsigned* p = reinterpret_cast<const unsigned*>(
        W + (size_t)(m0 + (lane >> 2)) * LDK + k0 + 2 * (lane & 3));
    const int row8 = 4 * LDK;                 // 8 rows, in words
    a[0] = __ldg(p);
    a[1] = __ldg(p + row8);
    a[2] = __ldg(p + 4);
    a[3] = __ldg(p + row8 + 4);
  }
}

// The B fragments of every 16-k step for the beams nb0..nb0+7 from their
// f32 rows (stride HL, bf16 values) in shared memory: lane l holds beam
// nb0 + l/4, k = 16ks + 2(l%4) + {0, 1} and + 8; beams at or beyond K and
// k at or beyond HL (the rows' zero padding ends there) give 0.
__device__ __forceinline__ void ldb(uint32_t (&b)[MAX_KS][2],
                                    const float* rows, int HL, int nb0,
                                    int K, int NKS) {
  const int lane = threadIdx.x & 31;
  const int n = nb0 + (lane >> 2);
  const float* r = rows + (n < K ? n : 0) * HL;
#pragma unroll
  for (int ks = 0; ks < MAX_KS; ++ks)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int k = 16 * ks + 8 * hh + 2 * (lane & 3);
      float2 v = make_float2(0.0f, 0.0f);
      if (ks < NKS && n < K && k < HL)
        v = *reinterpret_cast<const float2*>(r + k);
      b[ks][hh] = pack_bf16(v.x, v.y);
    }
}

// Phase stamps, compiled only into the kStamp instantiations (entries
// *_stamp, for measurement): thread 0 of block 0 and of the grid's last
// block adds up the SM clock cycles of each phase (from one warp barrier to
// the next; thread 0 is lane 0 of warp 0, so these are warp 0's phases),
// and every block writes its start and end on the global timer, from which
// the caller reads the wave each block ran in. Buffer (int64): [2]
// recorded block ids, then per record [total cycles, NPH phase cycles],
// then [grid][start ns, end ns].
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// static shared bytes the stamp instantiations' clocks take; the plans
// leave them free in every instantiation, so that both plan alike
constexpr int STAMP_SMEM = 256;

template <bool kStamp, int NPH>
struct PhaseClock {
  __device__ __forceinline__ explicit PhaseClock(long long*) {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void done() {}
};

template <int NPH>
struct PhaseClock<true, NPH> {
  static_assert(8 * (NPH + 3) <= STAMP_SMEM, "the clocks' shared state");
  bool on;   // thread 0 of a recorded block
  // the state in shared memory, so that the clocks hold no registers of
  // the kernel's: NPH phase cycles, the last mark, the start, the buffer
  __device__ static long long* state() {
    __shared__ long long s[NPH + 3];
    return s;
  }
  __device__ explicit PhaseClock(long long* b) {
    on = threadIdx.x == 0 && (blockIdx.x == 0 || blockIdx.x == gridDim.x - 1);
    if (threadIdx.x == 0) {
      b[2 + 2 * (NPH + 1) + 2 * blockIdx.x] = global_ns();
      long long* s = state();
      for (int i = 0; i < NPH; ++i) s[i] = 0;
      s[NPH + 2] = reinterpret_cast<long long>(b);
      s[NPH] = s[NPH + 1] = clock64();
    }
  }
  __device__ __forceinline__ void mark(int ph) {
    if (on) {
      long long* s = state();
      const long long now = clock64();
      s[ph] += now - s[NPH];
      s[NPH] = now;
    }
  }
  __device__ void done() {
    if (threadIdx.x == 0) {
      long long* s = state();
      long long* buf = reinterpret_cast<long long*>(s[NPH + 2]);
      buf[2 + 2 * (NPH + 1) + 2 * blockIdx.x + 1] = global_ns();
      if (on) {
        const int rec = blockIdx.x == 0 ? 0 : 1;
        buf[rec] = blockIdx.x;
        long long* o = buf + 2 + rec * (NPH + 1);
        o[0] = s[NPH] - s[NPH + 1];
        for (int i = 0; i < NPH; ++i) o[1 + i] = s[i];
      }
    }
  }
};

// phases of the stamp instantiation, in the order of
// ops/beam_kernel.py:STAMP_PHASES
enum Phase { PH_GRU, PH_HEAD, PH_SELECT, PH_REORDER, NPH };

// One step's log-softmax, candidates, top-K and bookkeeping of one
// sentence (sentence index sg, step t) by its warp, from the logits in
// its cand rows; writes the step's tapes and updates its state.
__device__ __forceinline__ void select_step(float* st, const Layout& L,
                                            int K, int V, int T, int t,
                                            int sg, int min_length,
                                            int n_best, int* ys, int* ptr,
                                            float* sc) {
  const int lane = threadIdx.x & 31;
  int* sti = reinterpret_cast<int*>(st);
  float* cand = st + L.cand;
  int* mi = sti + L.misc;
  const int adv = mi[0];
  const int eos_top = mi[1];
  const int fin = mi[2];
  const bool done = eos_top && fin >= n_best;
  const bool eos_early = adv + 1 < min_length;
  const bool is_first = adv == 0;

  // each row's max and sum of exps by the warp_max / warp_sum butterfly,
  // the reductions of 5 rows interleaved
  for (int b0 = 0; b0 < K; b0 += KC) {
    float m[KC], e[KC];
#pragma unroll
    for (int q = 0; q < KC; ++q) {
      m[q] = -INFINITY;
      if (b0 + q < K)
        for (int v = lane; v < V; v += 32)
          m[q] = fmaxf(m[q], cand[(b0 + q) * V + v]);
    }
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int q = 0; q < KC; ++q)
        m[q] = fmaxf(m[q], __shfl_xor_sync(0xffffffffu, m[q], off));
#pragma unroll
    for (int q = 0; q < KC; ++q) {
      e[q] = 0.0f;
      if (b0 + q < K)
        for (int v = lane; v < V; v += 32)
          e[q] += expf(cand[(b0 + q) * V + v] - m[q]);
    }
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int q = 0; q < KC; ++q)
        e[q] += __shfl_xor_sync(0xffffffffu, e[q], off);
#pragma unroll
    for (int q = 0; q < KC; ++q) {
      const int b = b0 + q;
      if (b >= K) continue;
      float* rw = cand + b * V;
      const float lse = logf(e[q]);
      const float score_b = st[L.scores + b];
      const bool eos_row = sti[L.prev + b] == EOS_IDX;
      for (int v = lane; v < V; v += 32) {
        const float lp = (rw[v] - m[q]) - lse;
        float wp = (v == START_IDX) ? NEG : lp;
        if (v == EOS_IDX && eos_early) wp = NEG;
        float bs;
        if (is_first) {
          bs = (b == 0) ? wp : -INFINITY;
        } else {
          bs = eos_row ? NEG : wp + score_b;
        }
        rw[v] = (bs == 0.0f) ? 0.0f : bs;    // -0.0 -> +0.0
      }
    }
  }
  __syncwarp();

  // K rounds of argmax, the found candidate masked between rounds; each
  // lane's best is the largest of its candidates f = lane + 32i, ties to
  // the lowest f, then the warp's (warp_argmax): the lowest flat index
  // among equal candidates. Up to 128 candidates stay in registers.
  const int KV = K * V;
  if (KV <= 128) {
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = lane + 32 * i < KV ? cand[lane + 32 * i] : -INFINITY;
    for (int i = 0; i < K; ++i) {
      float bv = x[0];
      int bi = lane;
#pragma unroll
      for (int j = 1; j < 4; ++j)
        if (x[j] > bv) {
          bv = x[j];
          bi = lane + 32 * j;
        }
      warp_argmax(bv, bi);
      if (bi >= KV) bi = 0;   // unreachable within the scope: K <= V - 2
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (bi == lane + 32 * j) x[j] = -INFINITY;
      if (lane == 0) {
        st[L.best + i] = bv;
        sti[L.nexty + i] = bi % V;
        sti[L.pk + i] = bi / V;
      }
    }
    __syncwarp();
  } else {
    for (int i = 0; i < K; ++i) {
      float bv = -INFINITY;
      int bi = 0x7fffffff;
      for (int f = lane; f < KV; f += 32) {
        const float x = cand[f];
        if (x > bv || (x == bv && f < bi)) {
          bv = x;
          bi = f;
        }
      }
      warp_argmax(bv, bi);
      if (bi >= KV) bi = 0;   // unreachable within the scope: K <= V - 2
      if (lane == 0) {
        cand[bi] = -INFINITY;
        st[L.best + i] = bv;
        sti[L.nexty + i] = bi % V;
        sti[L.pk + i] = bi / V;
      }
      __syncwarp();
    }
  }

  // bookkeeping + tapes (done-gated; sc stays ungated)
  int n_fin = 0;
  for (int k = lane; k < K; k += 32) {
    const int ny = sti[L.nexty + k];
    const int pk = sti[L.pk + k];
    const float bv = st[L.best + k];
    const size_t o = ((size_t)sg * T + t) * K + k;
    ys[o] = done ? PAD_IDX : ny;
    ptr[o] = done ? 0 : pk;
    sc[o] = bv;
    if (!done) {
      st[L.scores + k] = bv;
      sti[L.prev + k] = ny;
      n_fin += (ny == EOS_IDX);
    }
  }
  n_fin = warp_sum_int(n_fin);
  __syncwarp();
  if (lane == 0 && !done) {
    mi[0] = adv + 1;
    mi[1] = eos_top | (sti[L.nexty] == EOS_IDX);
    mi[2] = fin + n_fin;
  }
  __syncwarp();
}

// The per-block prologue of both kernels: the weights (transposed by the
// wrapper) into shared memory where kSmemW, bh as f32. Returns the first
// word after them, where the warps' sentence states start.
template <typename St, bool kSmemW>
__device__ __forceinline__ float* load_block(float* smem, const St* whT_g,
                                             const St* woT_g, const St* bh,
                                             int H, int V) {
  if (kSmemW) {
    const int n_wh = wh_words<St>(H, V) / 4;
    const int n16 = weight_words<St>(H, V) / 4;
    float4* dst = reinterpret_cast<float4*>(smem);
    const float4* src = reinterpret_cast<const float4*>(whT_g);
    const float4* src2 = reinterpret_cast<const float4*>(woT_g);
    for (int i = threadIdx.x; i < n16; i += blockDim.x)
      dst[i] = i < n_wh ? src[i] : src2[i - n_wh];
  }
  float* rest = kSmemW ? smem + weight_words<St>(H, V) : smem;
  for (int i = threadIdx.x; i < 3 * H; i += blockDim.x) rest[i] = ldg(bh + i);
  return rest;
}

// A sentence's initial state in its warp's words st: h = zc0 (zero
// padded), beam 0 from START, the bookkeeping cleared.
template <typename St>
__device__ __forceinline__ void init_sentence(float* st, const Layout& L,
                                              const St* zc0, int s0, int K,
                                              int H, int HL) {
  const int lane = threadIdx.x & 31;
  int* sti = reinterpret_cast<int*>(st);
  for (int i = lane; i < K * HL; i += 32) {
    const int j = i % HL;
    st[L.h + i] = j < H ? ld(zc0 + (size_t)s0 * H + j) : 0.0f;
    st[L.hn + i] = 0.0f;
  }
  for (int k = lane; k < K; k += 32) {
    st[L.scores + k] = 0.0f;
    sti[L.prev + k] = (k == 0) ? START_IDX : PAD_IDX;
  }
  if (lane == 0) {
    sti[L.misc] = 0;
    sti[L.misc + 1] = 0;
    sti[L.misc + 2] = 0;
  }
  __syncwarp();
}

// Phase 4: the hidden state reordered by backpointer (ungated).
__device__ __forceinline__ void reorder(float* st, const Layout& L, int K,
                                        int HL) {
  const int lane = threadIdx.x & 31;
  const int* sti = reinterpret_cast<const int*>(st);
  const int HL4 = HL / 4;
  for (int i = lane; i < K * HL4; i += 32) {
    const int b = i / HL4;
    reinterpret_cast<float4*>(st + L.h)[i] = reinterpret_cast<float4*>(
        st + L.hn + sti[L.pk + b] * HL)[i - b * HL4];
  }
  __syncwarp();
}

// A sentence's final scores, adv and fin_cnt.
__device__ __forceinline__ void finish_sentence(const float* st,
                                                const Layout& L, int s0,
                                                int K, float* scores_out,
                                                int* adv_out, int* fin_out) {
  const int lane = threadIdx.x & 31;
  const int* sti = reinterpret_cast<const int*>(st);
  for (int k = lane; k < K; k += 32)
    scores_out[(size_t)s0 * K + k] = st[L.scores + k];
  if (lane == 0) {
    adv_out[s0] = sti[L.misc];
    fin_out[s0] = sti[L.misc + 2];
  }
  __syncwarp();
}

// The f32 kernel: the cell and head as sequential FMA chains on the CUDA
// cores.
template <typename St, bool kSmemW, bool kStamp>
__global__ void __launch_bounds__(32 * max_warps<St>(), 1)
beam_gru_kernel(const St* __restrict__ tok_table,       // [V, 3H]
                const St* __restrict__ zc_gi,           // [B, 3H]
                const St* __restrict__ whT_g,           // [3][HL][LDW]
                const St* __restrict__ bh,              // [3H]
                const St* __restrict__ woT_g,           // [VP][LDW]
                const St* __restrict__ b_out,           // [V]
                const St* __restrict__ zc0,             // [B, H]
                int* __restrict__ ys,                  // [B, T, K]
                int* __restrict__ ptr,                 // [B, T, K]
                float* __restrict__ sc,                // [B, T, K]
                float* __restrict__ scores_out,        // [B, K]
                int* __restrict__ adv_out,             // [B]
                int* __restrict__ fin_out,             // [B]
                int B, int T, int K, int V, int H, int min_length,
                int n_best, int S, long long* stamps) {
  PhaseClock<kStamp, NPH> clk(stamps);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int H3 = 3 * H;
  const Geo geo = make_geo(H, V);
  const int NL = geo.NL, HL = geo.HL, LDW = geo.LDW;
  float* bhs = load_block<St, kSmemW>(smem, whT_g, woT_g, bh, H, V);
  const float* whT = kSmemW ? smem : whT_g;
  const float* woT = kSmemW ? smem + 3 * HL * LDW : woT_g;
  const Layout L = make_layout(K, V, HL);
  float* st = bhs + bh_words(H) + warp * L.words;   // the warp's sentence
  int* sti = reinterpret_cast<int*>(st);
  __syncthreads();

  // lane l's units l + NL*u (u < 4); lanes beyond NL redo lane NL-1's
  // reads and store nothing
  const int lc = min(lane, NL - 1);
  const bool cell_lane = lane < NL;
  for (int s0 = blockIdx.x * S + warp; s0 < B; s0 += gridDim.x * S) {
    init_sentence(st, L, zc0, s0, K, H, HL);
    const St* zg = zc_gi + (size_t)s0 * H3;

    for (int t = 0; t < T; ++t) {
      // ---- 1. GRU cell: units lc + NL*u of 5 beams at a time -------------
      for (int b0 = 0; b0 < K; b0 += KC) {
        const int nq = min(KC, K - b0);
        // gi = tok_table[prev] + zc_gi of the lane's units, loaded before
        // the sums so that their latency hides behind them
        float gi[KC][4][3];
#pragma unroll
        for (int q = 0; q < KC; ++q) {
          const St* tt =
              tok_table + (size_t)sti[L.prev + b0 + min(q, nq - 1)] * H3;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = min(lc + NL * u, H - 1);
#pragma unroll
            for (int g = 0; g < 3; ++g)
              gi[q][u][g] = rnd<St>(ldg(tt + g * H + j) + ldg(zg + g * H + j));
          }
        }
        // rows b0 + q; beams past K repeat the last
        const float* h0 = st + L.h + b0 * HL;
        float acc[KC][4][3];
#pragma unroll
        for (int q = 0; q < KC; ++q)
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int g = 0; g < 3; ++g) acc[q][u][g] = 0.0f;
        const float* wl = whT + lc * LDW;
        for (int kq = 0; kq < NL; ++kq) {
          float4 hv[KC], w[4][3];
#pragma unroll
          for (int q = 0; q < KC; ++q)
            hv[q] = *reinterpret_cast<const float4*>(
                h0 + min(q, nq - 1) * HL + 4 * kq);
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int g = 0; g < 3; ++g)
              w[u][g] = ld4<kSmemW>(wl + (g * HL + NL * u) * LDW + 4 * kq);
          // k in order within every sum; the sums interleaved
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int g = 0; g < 3; ++g)
#pragma unroll
                for (int q = 0; q < KC; ++q)
                  acc[q][u][g] = fmaf(comp(hv[q], kk), comp(w[u][g], kk),
                                      acc[q][u][g]);
        }
#pragma unroll
        for (int q = 0; q < KC; ++q) {
          const int b = b0 + q;
          if (b >= K || !cell_lane) continue;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = lc + NL * u;
            if (j >= H) continue;
            const float gir = gi[q][u][0], giz = gi[q][u][1];
            const float gin = gi[q][u][2];
            const float ghr = rnd<St>(acc[q][u][0] + bhs[j]);
            const float ghz = rnd<St>(acc[q][u][1] + bhs[H + j]);
            const float ghn = rnd<St>(acc[q][u][2] + bhs[2 * H + j]);
            const float r = rnd<St>(sigmoid_(gir + ghr));
            const float z = rnd<St>(sigmoid_(giz + ghz));
            const float n = rnd<St>(tanhf(gin + rnd<St>(r * ghn)));
            st[L.hn + b * HL + j] = blend<St>(z, n, st[L.h + b * HL + j]);
          }
        }
      }
      __syncwarp();
      clk.mark(PH_GRU);

      // ---- 2. output head: lane v of each pass of 32 columns -------------
      for (int v0 = 0; v0 < V; v0 += 32) {
        const int v = v0 + lane;
        const float* wr = woT + min(v, geo.VP - 1) * LDW;
        const float bo = v < V ? ldg(b_out + v) : 0.0f;
        for (int b0 = 0; b0 < K; b0 += KC) {
          const int nq = min(KC, K - b0);
          const float* h0 = st + L.hn + b0 * HL;
          float acc[KC];
#pragma unroll
          for (int q = 0; q < KC; ++q) acc[q] = 0.0f;
          for (int kq = 0; kq < NL; ++kq) {
            const float4 w = ld4<kSmemW>(wr + 4 * kq);
#pragma unroll
            for (int q = 0; q < KC; ++q)
              acc[q] = fma4(*reinterpret_cast<const float4*>(
                                h0 + min(q, nq - 1) * HL + 4 * kq),
                            w, acc[q]);
          }
          if (v < V) {
#pragma unroll
            for (int q = 0; q < KC; ++q)
              if (b0 + q < K)
                st[L.cand + (b0 + q) * V + v] = rnd<St>(acc[q] + bo);
          }
        }
      }
      __syncwarp();
      clk.mark(PH_HEAD);

      // ---- 3. log-softmax, candidates, top-K ------------------------------
      select_step(st, L, K, V, T, t, s0, min_length, n_best, ys, ptr, sc);
      clk.mark(PH_SELECT);

      // ---- 4. reorder the hidden state by backpointer (ungated) ----------
      reorder(st, L, K, HL);
      clk.mark(PH_REORDER);
    }
    finish_sentence(st, L, s0, K, scores_out, adv_out, fin_out);
  }
  clk.done();
}

// The bf16 kernel: the cell and head on the tensor cores. Lane l's
// outputs of an m16n8 tile are rows (units or tokens) l/4 and l/4 + 8,
// beams 2(l%4) and 2(l%4) + 1.
template <typename St, bool kSmemW, bool kStamp>
__global__ void __launch_bounds__(32 * max_warps<St>(), 1)
beam_gru_mma_kernel(const St* __restrict__ tok_table,   // [V, 3H]
                    const St* __restrict__ zc_gi,       // [B, 3H]
                    const St* __restrict__ whT_g,       // [3][MU][LDK]
                    const St* __restrict__ bh,          // [3H]
                    const St* __restrict__ woT_g,       // [VM][LDK]
                    const St* __restrict__ b_out,       // [V]
                    const St* __restrict__ zc0,         // [B, H]
                    int* __restrict__ ys,              // [B, T, K]
                    int* __restrict__ ptr,             // [B, T, K]
                    float* __restrict__ sc,            // [B, T, K]
                    float* __restrict__ scores_out,    // [B, K]
                    int* __restrict__ adv_out,         // [B]
                    int* __restrict__ fin_out,         // [B]
                    int B, int T, int K, int V, int H, int min_length,
                    int n_best, int S, long long* stamps) {
  PhaseClock<kStamp, NPH> clk(stamps);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int H3 = 3 * H;
  const int HL = make_geo(H, V).HL;
  const MGeo mg = make_mgeo(H, V);
  const int NKS = mg.KP / 16;
  float* bhs = load_block<St, kSmemW>(smem, whT_g, woT_g, bh, H, V);
  const St* whT = kSmemW ? reinterpret_cast<const St*>(smem) : whT_g;
  const St* woT =
      kSmemW ? reinterpret_cast<const St*>(smem) + 3 * mg.MU * mg.LDK : woT_g;
  const Layout L = make_layout(K, V, HL);
  float* st = bhs + bh_words(H) + warp * L.words;   // the warp's sentence
  const int* sti = reinterpret_cast<const int*>(st);
  __syncthreads();

  const int r4 = lane >> 2, c2 = 2 * (lane & 3);
  for (int s0 = blockIdx.x * S + warp; s0 < B; s0 += gridDim.x * S) {
    init_sentence(st, L, zc0, s0, K, H, HL);
    const St* zg = zc_gi + (size_t)s0 * H3;

    for (int t = 0; t < T; ++t) {
      // ---- 1. GRU cell: gh^T = wh^T h^T, one m16n8 tile of 16 units x 8
      // beams per gate, f32 accumulators ----------------------------------
      for (int nb0 = 0; nb0 < K; nb0 += 8) {
        uint32_t bf[MAX_KS][2];
        ldb(bf, st + L.h, HL, nb0, K, NKS);
        for (int m0 = 0; m0 < mg.MU; m0 += 16) {
          // gi = tok_table[prev] + zc_gi of the lane's outputs, loaded
          // before the products so that their latency hides behind them
          float gi[2][2][3];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const St* tt =
                tok_table +
                (size_t)sti[L.prev + min(nb0 + c2 + c, K - 1)] * H3;
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int j = min(m0 + r4 + 8 * i, H - 1);
#pragma unroll
              for (int g = 0; g < 3; ++g)
                gi[i][c][g] =
                    rnd<St>(ldg(tt + g * H + j) + ldg(zg + g * H + j));
            }
          }
          float acc[3][4] = {};
#pragma unroll
          for (int ks = 0; ks < MAX_KS; ++ks) {
            if (ks < NKS) {
#pragma unroll
              for (int g = 0; g < 3; ++g) {
                uint32_t a[4];
                lda<kSmemW>(a, whT + g * mg.MU * mg.LDK, mg.LDK, m0, 16 * ks);
                mma_bf16(acc[g], a, bf[ks]);
              }
            }
          }
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int j = m0 + r4 + 8 * i, b = nb0 + c2 + c;
              if (j >= H || b >= K) continue;
              const int e = 2 * i + c;
              const float ghr = rnd<St>(acc[0][e] + bhs[j]);
              const float ghz = rnd<St>(acc[1][e] + bhs[H + j]);
              const float ghn = rnd<St>(acc[2][e] + bhs[2 * H + j]);
              const float r = rnd<St>(sigmoid_(gi[i][c][0] + ghr));
              const float z = rnd<St>(sigmoid_(gi[i][c][1] + ghz));
              const float n = rnd<St>(tanhf(gi[i][c][2] + rnd<St>(r * ghn)));
              st[L.hn + b * HL + j] = blend<St>(z, n, st[L.h + b * HL + j]);
            }
        }
      }
      __syncwarp();
      clk.mark(PH_GRU);

      // ---- 2. output head: logits^T = w_out^T hn^T ------------------------
      for (int nb0 = 0; nb0 < K; nb0 += 8) {
        uint32_t bf[MAX_KS][2];
        ldb(bf, st + L.hn, HL, nb0, K, NKS);
        for (int m0 = 0; m0 < mg.VM; m0 += 16) {
          float acc[4] = {};
#pragma unroll
          for (int ks = 0; ks < MAX_KS; ++ks) {
            if (ks < NKS) {
              uint32_t a[4];
              lda<kSmemW>(a, woT, mg.LDK, m0, 16 * ks);
              mma_bf16(acc, a, bf[ks]);
            }
          }
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int v = m0 + r4 + 8 * i, b = nb0 + c2 + c;
              if (v < V && b < K)
                st[L.cand + b * V + v] =
                    rnd<St>(acc[2 * i + c] + ldg(b_out + v));
            }
        }
      }
      __syncwarp();
      clk.mark(PH_HEAD);

      // ---- 3. log-softmax, candidates, top-K ------------------------------
      select_step(st, L, K, V, T, t, s0, min_length, n_best, ys, ptr, sc);
      clk.mark(PH_SELECT);

      // ---- 4. reorder the hidden state by backpointer (ungated) ----------
      reorder(st, L, K, HL);
      clk.mark(PH_REORDER);
    }
    finish_sentence(st, L, s0, K, scores_out, adv_out, fin_out);
  }
  clk.done();
}

struct Plan {
  int S, threads, weights_in_smem, grid;
  size_t smem;
};

// Sentences (warps) per block, where the weights live, the grid.
template <typename T>
int make_plan(int B, int K, int V, int H, Plan* plan) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int max_smem = 0, n_sm = 0;
  e = cudaDeviceGetAttribute(&max_smem,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  max_smem -= STAMP_SMEM;      // the stamp instantiations' static clocks
  const Geo g = make_geo(H, V);
  const size_t per_sent = (size_t)make_layout(K, V, g.HL).words * 4;
  const size_t w_bytes = (size_t)weight_words<T>(H, V) * 4;
  const size_t bh_bytes = (size_t)bh_words(H) * 4;
  int S;
  if (w_bytes + bh_bytes + per_sent <= (size_t)max_smem) {
    plan->weights_in_smem = 1;
    S = (int)(((size_t)max_smem - w_bytes - bh_bytes) / per_sent);
  } else {
    plan->weights_in_smem = 0;
    S = (int)(((size_t)max_smem - bh_bytes) / per_sent);
  }
  if (S < 1) return (int)cudaErrorInvalidConfiguration;
  S = S < max_warps<T>() ? S : max_warps<T>();
  S = S < B ? S : (B > 0 ? B : 1);
  plan->S = S;
  plan->threads = 32 * S;
  plan->smem = S * per_sent + bh_bytes +
               (plan->weights_in_smem ? w_bytes : 0);
  const int blocks = (B + S - 1) / S;
  plan->grid = blocks < n_sm ? blocks : n_sm;
  return 0;
}

template <typename T, bool kStamp>
int launch(const T* tok_table, const T* zc_gi, const T* whT, const T* bh,
           const T* woT, const T* b_out, const T* zc0, int* ys, int* ptr,
           float* sc, float* scores, int* adv, int* fin, int B, int T_,
           int K, int V, int H, int min_length, int n_best,
           long long* stamps, void* stream) {
  if (B <= 0) return 0;
  Plan p;
  int e = make_plan<T>(B, K, V, H, &p);
  if (e) return e;
  void (*kern)(const T*, const T*, const T*, const T*, const T*, const T*,
               const T*, int*, int*, float*, float*, int*, int*, int, int,
               int, int, int, int, int, int, long long*);
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    kern = p.weights_in_smem ? beam_gru_mma_kernel<T, true, kStamp>
                             : beam_gru_mma_kernel<T, false, kStamp>;
  else
    kern = p.weights_in_smem ? beam_gru_kernel<T, true, kStamp>
                             : beam_gru_kernel<T, false, kStamp>;
  cudaError_t ce = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (ce != cudaSuccess) return (int)ce;
  kern<<<p.grid, p.threads, p.smem, (cudaStream_t)stream>>>(
      tok_table, zc_gi, whT, bh, woT, b_out, zc0, ys, ptr, sc, scores, adv,
      fin, B, T_, K, V, H, min_length, n_best, p.S, stamps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch plan for these shapes: sentences (warps) per block, threads
// per block, weights in shared memory (1/0), dynamic shared bytes, grid;
// bf16 != 0 for the bf16 instantiation.
int beam_gru_plan(int B, int K, int V, int H, int bf16, int* out5) {
  Plan p;
  int e = bf16 ? make_plan<__nv_bfloat16>(B, K, V, H, &p)
               : make_plan<float>(B, K, V, H, &p);
  if (e) return e;
  out5[0] = p.S;
  out5[1] = p.threads;
  out5[2] = p.weights_in_smem;
  out5[3] = (int)p.smem;
  out5[4] = p.grid;
  return 0;
}

// Launch the beam on `stream`; returns the CUDA error of the launch (0 on
// success). Does not synchronise and allocates nothing. whT and woT are
// wh and w_out transposed and padded as ops/beam_kernel.py:weight_layout
// lays them out.
int beam_gru_f32(const float* tok_table, const float* zc_gi,
                 const float* whT, const float* bh, const float* woT,
                 const float* b_out, const float* zc0, int* ys, int* ptr,
                 float* sc, float* scores, int* adv, int* fin, int B, int T,
                 int K, int V, int H, int min_length, int n_best,
                 void* stream) {
  return launch<float, false>(tok_table, zc_gi, whT, bh, woT, b_out, zc0, ys,
                              ptr, sc, scores, adv, fin, B, T, K, V, H,
                              min_length, n_best, nullptr, stream);
}

// The same on bf16 inputs (tapes and scores as the f32 entry's); whT and
// woT in bf16 as ops/beam_kernel.py:mma_layout lays them out.
int beam_gru_bf16(const __nv_bfloat16* tok_table, const __nv_bfloat16* zc_gi,
                  const __nv_bfloat16* whT, const __nv_bfloat16* bh,
                  const __nv_bfloat16* woT, const __nv_bfloat16* b_out,
                  const __nv_bfloat16* zc0, int* ys, int* ptr, float* sc,
                  float* scores, int* adv, int* fin, int B, int T, int K,
                  int V, int H, int min_length, int n_best, void* stream) {
  return launch<__nv_bfloat16, false>(tok_table, zc_gi, whT, bh, woT, b_out,
                                      zc0, ys, ptr, sc, scores, adv, fin, B,
                                      T, K, V, H, min_length, n_best, nullptr,
                                      stream);
}

// Measurement only: the stamp instantiations of the two entries, the
// same arguments and one more, the zeroed int64 buffer of
// beam_gru_stamp_words(grid) words the phase clocks write (PhaseClock).
int beam_gru_f32_stamp(const float* tok_table, const float* zc_gi,
                       const float* whT, const float* bh, const float* woT,
                       const float* b_out, const float* zc0, int* ys,
                       int* ptr, float* sc, float* scores, int* adv, int* fin,
                       int B, int T, int K, int V, int H, int min_length,
                       int n_best, long long* stamps, void* stream) {
  return launch<float, true>(tok_table, zc_gi, whT, bh, woT, b_out, zc0, ys,
                             ptr, sc, scores, adv, fin, B, T, K, V, H,
                             min_length, n_best, stamps, stream);
}

int beam_gru_bf16_stamp(const __nv_bfloat16* tok_table,
                        const __nv_bfloat16* zc_gi,
                        const __nv_bfloat16* whT, const __nv_bfloat16* bh,
                        const __nv_bfloat16* woT,
                        const __nv_bfloat16* b_out, const __nv_bfloat16* zc0,
                        int* ys, int* ptr, float* sc, float* scores, int* adv,
                        int* fin, int B, int T, int K, int V, int H,
                        int min_length, int n_best, long long* stamps,
                        void* stream) {
  return launch<__nv_bfloat16, true>(tok_table, zc_gi, whT, bh, woT, b_out,
                                     zc0, ys, ptr, sc, scores, adv, fin, B, T,
                                     K, V, H, min_length, n_best, stamps,
                                     stream);
}

// Words of the stamp buffer for a grid of `grid` blocks; the phase count.
int beam_gru_stamp_words(int grid) { return 2 + 2 * (NPH + 1) + 2 * grid; }
int beam_gru_stamp_phases() { return NPH; }

const char* beam_gru_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
