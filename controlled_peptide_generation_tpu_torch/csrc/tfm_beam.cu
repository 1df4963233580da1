// Whole-scan transformer beam search for NVIDIA Hopper (sm_90a), fp32 and
// bf16.
//
// Replaces the TPU kernel controlled_peptide_generation_tpu/ops/
// pallas_tfm_beam.py:beam_scan_tfm (kernel body _kernel). One launch runs
// all T steps of the beam for every sentence. Per step and beam lane:
// x = tok_table[prev] + pos_table[t+1]; L pre-LN blocks (LN1, the fused
// qkv product in the checkpoint's head-major [H, 3, Dh] column layout, the
// lane's k and v written at position t+1, attention per head over
// positions 0..t+1 with the latent prefix at 0, the out product and the
// residual, LN2, ff1, tanh GELU, ff2 and the residual); the final LN, the
// head and an fp32 log-softmax; then the GRU beam's bookkeeping
// (csrc/beam_gru.cu): START blocked, EOS blocked below min_length,
// children of EOS rows blocked, the first step from beam 0 only, signed
// zeros canonicalized, an iterated top-K with ties to the lowest flat
// index k*V+v, the done-gated tapes. It emits ys/ptr/sc [B,T,K] and
// scores [B,K], adv [B], fin_cnt [B]; ops/beam.py turns them into
// hypotheses.
//
// What bounds it on the H100. Per beam-token the products cost
// 2*L*(D*3D + D*D + 2*D*F) + 2*D*V FLOP plus attention's 4*D*(t+2) per
// layer, 544 kFLOP on average at the shipped width (D 128, L 2, F 256,
// V 24, T 25): 340 GFLOP for a round of 5,000 sentences at beam 5, 5.08 ms
// at the fp32 rate of the CUDA cores (67 TFLOP/s). The bytes the function
// must move are the 1.07 MB of weights and the tapes. The attention's KV
// reads are not in that bound: each lane reads its K and V history,
// sum_t B*K*(t+2)*D*L*2 values, 17.9 GB (fp32) / 9.0 GB (bf16) a round at
// B 5,000, 5.35 / 2.68 ms at HBM's 3.35 TB/s; one sentence's fp32 caches
// (260 KB) exceed a block's 227 KB, and the 1.3 GB scratch does not stay
// in the 50 MB L2.
//
// Where the time went (the stamp entries, tools/beam_split.py, B 5,000):
// the previous design spent 48.7% of a block-step in the four products (bf16
// 53.5%), each row group of 20 rows reading every weight through L1/L2,
// and 42.4% (37.0%) in attention, each task a chain of device-memory loads
// one position at a time; 625 blocks of 8 sentences on 264 slots, 2.37
// waves. (Those stamp builds held their clocks in registers and ran
// 15-18% longer than the production entry, so the two shares are within
// that distortion; the clocks now keep their state in shared memory and
// match the production entry's time within 3%.) What this design does
// about each:
// * The products stay fp32 FMAs on the CUDA cores, in both entries, each
//   output one sequential chain over k in order. The plain version
//   computes a bf16 product as an f32 SGEMM, which accumulates in that
//   order. The bf16 products on the tensor cores (gemm_mma: mma.sync
//   m16n8k16, f32 accumulators, the same rounding points) are kept as the
//   measurement entry tfm_beam_bf16_mma (tools/tfm_beam_mma.py): 1.39x /
//   1.58x faster at B 5,000 / 2,500, but their decodes keep 19% of rows
//   identical to the plain version's at T 25 under T_args.bf16, 47% at the
//   S 32 scope edge and 49% at T*K 256, against chip_smoke.py's gate (d)
//   of 70% (the sequential chain: 92%, 84%, 92%); against a plain version
//   whose products are summed in FP64 they agree less than the chain too
//   (19% against 85%, 51% against 64%), so the production entry gives up
//   the tensor cores to keep the gates. What the products
//   change: the eight warps split the columns, so every weight is read
//   once per block-step (not once per row group); lane (rg, cg) keeps 10
//   rows x 2 columns in registers, reads its 8 weights of a 4-k step as
//   one or two 16-byte loads from a copy the wrapper pre-tiles in that
//   order (ops/tfm_beam_kernel.py:weight_tiles), one step ahead, and the
//   rows as 16-byte loads. Wider register tiles spilled at the 128
//   registers two blocks an SM leave, and one block an SM halves the warps
//   that hide attention's memory latency; both measured slower. Not done:
//   a ring of weight tiles in shared memory filled by cp.async or TMA (the
//   110 KB two blocks an SM leave each hold the activations), and named
//   barriers between warp roles.
// * Attention: one warp per (lane, head) as before and the same sums in
//   the same order, but all of a task's loads go out at once, before the
//   softmax needs them: lane s its position's K row (16-byte loads), lane
//   d the V values of dim d at every position <= t+1 (32 predicated loads,
//   unrolled). A task waits for one device-memory latency, not one per
//   position. Holding the caches on chip across a cluster (distributed
//   shared memory, as the JAX kernel holds them in VMEM) needs 130 KB a
//   bf16 sentence: a cluster of 8 blocks would hold about 13 sentences,
//   3x fewer rows per block than the products need; not taken.
//   Not done: staging a task's K and V rows in shared memory by cp.async
//   or TMA; the loads go straight to registers, all issued before the
//   softmax.
// * Waves: the plan picks sentences per block (at most 8, 40 lanes) from B
//   and the card's resident blocks, minimising waves x (sentences + 2), so
//   that the last wave is not a short one (B 5,000: 7 a block, 715 blocks
//   on 264 slots; B 2,500: 5 a block).
// Each output is one fixed-order sum whatever the tiling, so every
// sentence's result is independent of the batch and of the plan: bitwise
// batch invariance. Sums are taken in another order than cuBLAS or the
// CPU, so near-tie rows may pick another token than the plain version;
// chip_smoke.py bounds that share.
//
// Layout: a block holds a tile of sentences whose lanes, M = sentences*K
// rows, advance together through all T steps; lanes beyond 40 (large K)
// run in chunks of 40 rows. Activations in shared memory: the residual
// stream and the LN/attention output [40, D] each, one [40, 384] buffer
// for qkv or a 384-column chunk of ff1 (d_ff above 384 runs in chunks;
// ff2 then sums the chunks into a fifth [40, D] buffer in the same k
// order). The KV caches live in a scratch tensor [B, K, L, 2, S, D]; each
// lane writes only its own row at t+1. The beam reorder permutes a
// [sentences, K, S] ancestry map instead of the caches (the JAX package's
// no-reorder arm, ops/beam.py:388): lane k's history row at position s is
// the row lane anc[k][s] wrote, so attention reads the same values in the
// same order as a reordered cache. Position 0, the latent prefix, is the
// same for every lane and is stored once, in lane 0. LayerNorm and the
// softmaxes are f32 with one warp per row; eps 1e-6 inside the square
// root; GELU is the tanh form.
//
// bf16 (entry tfm_beam_bf16): the same kernel instantiated on bf16 storage
// for the tables, the products' weights and biases, the prefix rows and
// the KV caches (53 KB a sentence at the shipped width, 266 MB at
// B 5,000, half of fp32's); LayerNorm's parameters, the final LN and the
// head stay f32, as the JAX kernel keeps them (pallas_tfm_beam.py:406).
// Activations stay f32 in shared memory, rounded to bf16 (round to nearest
// even) where the JAX kernel rounds in interpret mode
// (models/transformer.py:_block_step): the entry tok_table[prev] +
// pos_table[t+1]; each product accumulated in f32 and rounded, then its
// bias added and the sum rounded (qkv, out, ff2); the attention
// probabilities before the value sum and that sum once; the LayerNorms
// and the GELU in f32, their outputs rounded. LayerNorm reads the residual
// stream's f32 sum before its rounding and the GELU the f32 sum of ff1's
// rounded product and bias, while the residual adds take the rounded
// values: the stream is kept unrounded in shared memory and rounded where
// a residual add reads it. The fp32 instantiation's rounding is the
// identity.
//
// Stamps: the kStamp instantiations (entries *_stamp, measurement only)
// clock the phases; the production entries compile them away.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int PAD_IDX = 1;
constexpr int START_IDX = 2;
constexpr int EOS_IDX = 3;
constexpr float NEG = -1e20f;
constexpr int D = 128;           // d_model: the kernel's scope
constexpr int NT = 256;          // threads per block
constexpr int NWARPS = NT / 32;
constexpr int CH = 40;           // rows per chunk: at most 8 sentences at K 5
constexpr int FC = 3 * D;        // widest product: qkv, or a chunk of ff1

struct Dims {
  int B, T, K, V, S, L, H, F, min_length, n_best, n_sent;
};

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
// lower index
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

// storage types: a load widens to f32, st narrows (exact on the values
// stored here), rnd rounds an f32 result to the storage type's precision
// (the identity for float)
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg(const __nv_bfloat16* p) {
  return __uint_as_float(
      (unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
template <typename T>
__device__ __forceinline__ float rnd(float x) { return x; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// four consecutive values of a row (16-byte aligned for float, 8-byte for
// bf16) widened to f32
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;   // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(k0 * (x + 0.044715f * x * x * x)));
}

// ---- the products ----------------------------------------------------------
// Row strides (floats) of the [rows, D] and [rows, FC] activation buffers:
// the four row groups of a warp's A loads (rows 10 apart) hit distinct
// banks.
constexpr int LDX = D + 4, LDB = FC + 4;

// a lane's 8 weights of one 4-k step (2 columns x 4 k, contiguous)
// widened to f32
__device__ __forceinline__ void ld8(const float* p, float (&w)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}
__device__ __forceinline__ void ld8(const __nv_bfloat16* p, float (&w)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t x[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[2 * i] = __uint_as_float(x[i] << 16);
    w[2 * i + 1] = __uint_as_float(x[i] & 0xffff0000u);
  }
}

// offsets (in elements of T) of one layer's parameters in the packed
// weights, in the order of ops/tfm_beam_kernel.py:pack_layers: the four
// matrices pre-tiled (weight_tiles), then the four biases
struct LayerOff {
  size_t qkvw, aow, ff1w, ff2w, qkvb, aob, ff1b, ff2b, size;
};

__host__ __device__ inline LayerOff layer_off(int F) {
  LayerOff o;
  size_t x = 0;
  o.qkvw = x; x += (size_t)D * 3 * D;
  o.aow = x;  x += (size_t)D * D;
  o.ff1w = x; x += (size_t)D * F;
  o.ff2w = x; x += (size_t)F * D;
  o.qkvb = x; x += 3 * D;
  o.aob = x;  x += D;
  o.ff1b = x; x += F;
  o.ff2b = x; x += D;
  o.size = x;
  return o;
}

// LayerNorm's f32 parameters per layer: ln1 g, b, ln2 g, b
constexpr int LN_WORDS = 4 * D;

// per-block shared-memory layout, in 4-byte words (anc in bytes after)
struct Smem {
  int big, hs, xs, acc2, cand, scores, best, prev, nexty, pk, misc, words;
  int anc_bytes;
};

__host__ __device__ inline Smem make_smem(int n_sent, int K, int V, int S,
                                          int F) {
  Smem m;
  const int M = n_sent * K;
  int o = 0;
  m.big = o;    o += CH * LDB;
  m.hs = o;     o += CH * LDX;
  m.xs = o;     o += CH * LDX;
  m.acc2 = o;   o += (F > FC) ? CH * LDX : 0;
  m.cand = o;   o += M * V;
  m.scores = o; o += M;
  m.best = o;   o += M;
  m.prev = o;   o += M;
  m.nexty = o;  o += M;
  m.pk = o;     o += M;
  m.misc = o;   o += 3 * n_sent;   // adv, eos_top, fin_cnt
  m.words = (o + 3) & ~3;
  // two maps (this step's and the next), and 32 bytes that a warp's
  // predicated reads of positions above S may touch
  m.anc_bytes = 2 * M * S + 32;
  return m;
}

enum Epi { EPI_BIAS, EPI_GELU, EPI_RESID, EPI_PARTIAL };

// C[r][n] for r < rows and the call's N columns (a multiple of 128): the
// product of the shared f32 rows A [rows, Kd] (stride LDA) and a weight
// matrix pre-tiled by weight_tiles (kq4 4-k steps in all; this call takes
// the k steps from kk0), each output one sequential FMA chain over k in
// order, as an f32 SGEMM accumulates, so that bf16 roundings of the sums
// fall where the plain version's do. Sums start from Cin (stride LDX)
// when given, else 0. Epilogues, with P = rnd(sum) + b (the rounded
// product plus the bias, unrounded): BIAS C = rnd(P); GELU C =
// rnd(gelu(P)); RESID C = rnd(C) + rnd(P), the residual stream's
// unrounded sum; PARTIAL C = sum. The columns go in chunks of 128; in each,
// warp w owns columns 16w..16w+15, so every weight is read once per
// block-step, and lane (rg, cg) = (lane / 8, lane % 8) keeps rows
// 10rg..10rg+9 x columns 16w + 2cg, +1 in registers: per 4 k ten 16-byte
// A loads (one address per quarter-warp) and its 8 weights (from L2, one
// step ahead) for 80 FMAs. Rows at and above `rows` hold whatever the
// buffer holds and are not stored.
template <typename T, int EPI, int LDA>
__device__ __forceinline__ void gemm(const float* A, int Kd,
                                     const T* __restrict__ Wt, int kq4,
                                     int kk0, int N,
                                     const T* __restrict__ bias, float* C,
                                     int ldc, const float* Cin, int rows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = lane >> 3, cg = lane & 7;
  const int KT = Kd >> 2;
  const float* a0 = A + 10 * rg * LDA;
  for (int n_c = 0; n_c < N; n_c += 128) {
    const int n0 = n_c + 16 * warp + 2 * cg;
    float acc[10][2];
#pragma unroll
    for (int i = 0; i < 10; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int r = 10 * rg + i;
        acc[i][c] = (Cin != nullptr && r < rows) ? Cin[r * LDX + n0 + c]
                                                 : 0.0f;
      }
    // this chunk's tiles: [8 warps][kq4][8 cg][2][4]
    const T* wp = Wt + (size_t)n_c * 4 * kq4 +
                  (((size_t)warp * kq4 + kk0) * 8 + cg) * 8;
    float w[8], wn[8];
    ld8(wp, w);
    for (int kk = 0; kk < KT; ++kk) {
      if (kk + 1 < KT) ld8(wp + (size_t)(kk + 1) * 64, wn);
#pragma unroll
      for (int i = 0; i < 10; ++i) {
        const float4 a =
            *reinterpret_cast<const float4*>(a0 + i * LDA + 4 * kk);
        float s0 = acc[i][0], s1 = acc[i][1];
        s0 = fmaf(a.x, w[0], s0);
        s0 = fmaf(a.y, w[1], s0);
        s0 = fmaf(a.z, w[2], s0);
        s0 = fmaf(a.w, w[3], s0);
        s1 = fmaf(a.x, w[4], s1);
        s1 = fmaf(a.y, w[5], s1);
        s1 = fmaf(a.z, w[6], s1);
        s1 = fmaf(a.w, w[7], s1);
        acc[i][0] = s0;
        acc[i][1] = s1;
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) w[q] = wn[q];
    }
#pragma unroll
    for (int i = 0; i < 10; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int r = 10 * rg + i;
        const int n = n0 + c;
        if (r < rows) {
          float* out = C + r * ldc + n;
          const float v = acc[i][c];
          if (EPI == EPI_PARTIAL) {
            *out = v;
          } else {
            const float pb = rnd<T>(v) + ldg(bias + n);
            if (EPI == EPI_BIAS) {
              *out = rnd<T>(pb);
            } else if (EPI == EPI_GELU) {
              *out = rnd<T>(gelu_tanh(pb));
            } else {
              *out = rnd<T>(*out) + rnd<T>(pb);
            }
          }
        }
      }
  }
}

// Two f32 values that hold bf16 values as one bf16x2 register (exact),
// the lower index in the low half, as mma.sync's fragments take them.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The same product and epilogues as gemm, for bf16 weights on the tensor
// cores (mma.sync m16n8k16, bf16 inputs, f32 accumulators): per chunk of
// 128 columns warp w owns columns 16w..16w+15 (two n8 tiles) x all rows
// (three m16 tiles, 40 rows padded to 48); the B fragments read the
// pre-tiled weights (one 4-byte load each: two consecutive k of one
// column), the A fragments the shared f32 rows packed to bf16 (exact:
// the rows hold bf16 values). The sums are the tensor cores', not one
// sequential chain.
template <int EPI, int LDA>
__device__ __forceinline__ void gemm_mma(
    const float* A, int Kd, const __nv_bfloat16* __restrict__ Wt, int kq4,
    int kk0, int N, const __nv_bfloat16* __restrict__ bias, float* C, int ldc,
    const float* Cin, int rows) {
  typedef __nv_bfloat16 T;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r4 = lane >> 2, c2 = 2 * (lane & 3);
  const int n_mt = (rows + 15) / 16;
  for (int n_c = 0; n_c < N; n_c += 128) {
    float acc[3][2][4];
#pragma unroll
    for (int mt = 0; mt < 3; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 16 * mt + r4 + 8 * (e >> 1);
          const int n = n_c + 16 * warp + 8 * nt + c2 + (e & 1);
          acc[mt][nt][e] = (Cin != nullptr && r < rows) ? Cin[r * LDX + n]
                                                        : 0.0f;
        }
    // this warp's tiles: [kq4][8 cg][2][4]; lane's column 8nt + r4 is
    // cg 4nt + r4/2, c r4%2; its k pair 2(lane%4) of a 4-k step
    const unsigned* wq = reinterpret_cast<const unsigned*>(
        Wt + (size_t)n_c * 4 * kq4 +
        (((size_t)warp * kq4 + kk0) * 8 + (r4 >> 1)) * 8 + (r4 & 1) * 4 +
        2 * (lane & 1));
    for (int k0 = 0; k0 < Kd; k0 += 16) {
      const int kk = (k0 >> 2) + ((lane & 3) >> 1);
      uint32_t b[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          b[nt][hh] = __ldg(wq + ((size_t)(kk + 2 * hh) * 8 + 4 * nt) * 4);
#pragma unroll
      for (int mt = 0; mt < 3; ++mt) {
        if (mt >= n_mt) break;
        uint32_t a[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = min(16 * mt + r4 + 8 * (q & 1), CH - 1);
          const float2 v = *reinterpret_cast<const float2*>(
              A + r * LDA + k0 + c2 + 8 * (q >> 1));
          a[q] = pack_bf16(v.x, v.y);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          asm volatile(
              "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
              "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
              : "+f"(acc[mt][nt][0]), "+f"(acc[mt][nt][1]),
                "+f"(acc[mt][nt][2]), "+f"(acc[mt][nt][3])
              : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[nt][0]),
                "r"(b[nt][1]));
      }
    }
#pragma unroll
    for (int mt = 0; mt < 3; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 16 * mt + r4 + 8 * (e >> 1);
          const int n = n_c + 16 * warp + 8 * nt + c2 + (e & 1);
          if (r < rows) {
            float* out = C + r * ldc + n;
            const float v = acc[mt][nt][e];
            if (EPI == EPI_PARTIAL) {
              *out = v;
            } else {
              const float pb = rnd<T>(v) + ldg(bias + n);
              if (EPI == EPI_BIAS) {
                *out = rnd<T>(pb);
              } else if (EPI == EPI_GELU) {
                *out = rnd<T>(gelu_tanh(pb));
              } else {
                *out = rnd<T>(*out) + rnd<T>(pb);
              }
            }
          }
        }
  }
}

// gemm on the CUDA cores, or gemm_mma where kMma (bf16 only)
template <typename T, bool kMma, int EPI, int LDA>
__device__ __forceinline__ void product(const float* A, int Kd,
                                        const T* __restrict__ Wt, int kq4,
                                        int kk0, int N,
                                        const T* __restrict__ bias, float* C,
                                        int ldc, const float* Cin, int rows) {
  if constexpr (kMma)
    gemm_mma<EPI, LDA>(A, Kd, Wt, kq4, kk0, N, bias, C, ldc, Cin, rows);
  else
    gemm<T, EPI, LDA>(A, Kd, Wt, kq4, kk0, N, bias, C, ldc, Cin, rows);
}

// Y[r] = LayerNorm(X[r]) * g + b over D = 128 values, one warp per row,
// rounded to T's precision; rows at stride LD
template <typename T, int LD>
__device__ __forceinline__ void layer_norm(const float* X, float* Y, int rows,
                                           const float* __restrict__ g,
                                           const float* __restrict__ b) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float4 gv = __ldg(reinterpret_cast<const float4*>(g) + lane);
  const float4 bv = __ldg(reinterpret_cast<const float4*>(b) + lane);
  for (int r = warp; r < rows; r += NWARPS) {
    const float4 v = reinterpret_cast<const float4*>(X + r * LD)[lane];
    const float mu = warp_sum((v.x + v.y) + (v.z + v.w)) / D;
    const float dx = v.x - mu, dy = v.y - mu, dz = v.z - mu, dw = v.w - mu;
    const float var =
        warp_sum((dx * dx + dy * dy) + (dz * dz + dw * dw)) / D;
    const float inv = 1.0f / sqrtf(var + 1e-6f);
    float4 y;
    y.x = rnd<T>((dx * inv) * gv.x + bv.x);
    y.y = rnd<T>((dy * inv) * gv.y + bv.y);
    y.z = rnd<T>((dz * inv) * gv.z + bv.z);
    y.w = rnd<T>((dw * inv) * gv.w + bv.w);
    reinterpret_cast<float4*>(Y + r * LD)[lane] = y;
  }
}

// Phase stamps, compiled only into the kStamp instantiations (entries
// *_stamp, for measurement): thread 0 of block 0 and of the grid's last
// block adds up the SM clock cycles of each phase (from one block barrier
// to the next), and every block writes its start and end on the global
// timer, from which the caller reads the wave each block ran in. Buffer
// (int64): [2] recorded block ids, then per record [total cycles, NPH
// phase cycles], then [grid][start ns, end ns].
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
// ops/tfm_beam_kernel.py:STAMP_PHASES (layers summed)
enum Phase { PH_EMBED, PH_LN1, PH_QKV, PH_KVW, PH_ATTN, PH_OUT, PH_LN2, PH_FF1,
             PH_FF2, PH_HEAD, PH_SELECT, PH_REORDER, NPH };

template <typename T, bool kMma, bool kStamp>
__global__ void __launch_bounds__(NT, 2)
tfm_beam_kernel(const T* __restrict__ tok,          // [V, D]
                const T* __restrict__ pos,          // [S, D]
                const T* __restrict__ wpack,        // L x layer_off(F).size
                const float* __restrict__ lnpack,   // L x LN_WORDS
                const float* __restrict__ lnf_g,    // [D]
                const float* __restrict__ lnf_b,    // [D]
                const float* __restrict__ wout,     // [D, V]
                const float* __restrict__ bout,     // [V]
                const T* __restrict__ k0,           // [L, B, D]
                const T* __restrict__ v0,           // [L, B, D]
                T* scratch,                         // [B, K, L, 2, S, D]
                int* __restrict__ ys,               // [B, T, K]
                int* __restrict__ ptr,              // [B, T, K]
                float* __restrict__ sc,             // [B, T, K]
                float* __restrict__ scores_out,     // [B, K]
                int* __restrict__ adv_out,          // [B]
                int* __restrict__ fin_out,          // [B]
                long long* stamps,                  // kStamp only
                Dims d) {
  PhaseClock<kStamp, NPH> clk(stamps);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int K = d.K, V = d.V, S = d.S, L = d.L, H = d.H, F = d.F;
  const int Dh = D / H;
  const int s0 = blockIdx.x * d.n_sent;
  const int n_s = min(d.n_sent, d.B - s0);    // live sentences here
  const int M = n_s * K;                      // beam lanes here
  const Smem lay = make_smem(d.n_sent, K, V, S, F);
  const LayerOff lo = layer_off(F);
  float* xs = smem + lay.xs;
  float* hs = smem + lay.hs;
  float* big = smem + lay.big;
  float* acc2 = smem + lay.acc2;
  float* cand = smem + lay.cand;
  float* scores = smem + lay.scores;
  float* best = smem + lay.best;
  int* prev = reinterpret_cast<int*>(smem) + lay.prev;
  int* nexty = reinterpret_cast<int*>(smem) + lay.nexty;
  int* pk = reinterpret_cast<int*>(smem) + lay.pk;
  int* misc = reinterpret_cast<int*>(smem) + lay.misc;
  uint8_t* anc = reinterpret_cast<uint8_t*>(smem + lay.words);
  uint8_t* anc_nxt = anc + M * S;
  const float sqrt_dh = sqrtf((float)Dh);
  // lane (b, k)'s rows of layer l, k or v: row s at + s*D
  auto kv_rows = [&](int sent, int kl, int l, int kv) {
    return scratch + ((((size_t)(s0 + sent) * K + kl) * L + l) * 2 + kv) *
                         (size_t)S * D;
  };
  const size_t lane_stride = (size_t)L * 2 * S * D;   // kl -> kl + 1

  // ---- initial state: position 0 (the latent prefix) in lane 0 -------
  for (int i = tid; i < M; i += NT) {
    scores[i] = 0.0f;
    prev[i] = (i % K == 0) ? START_IDX : PAD_IDX;
    anc[i * S] = 0;
  }
  for (int s = tid; s < n_s; s += NT) {
    misc[3 * s] = 0;
    misc[3 * s + 1] = 0;
    misc[3 * s + 2] = 0;
  }
  for (int i = tid; i < n_s * L * 2 * D; i += NT) {
    const int c = i % D, kv = (i / D) % 2, l = (i / (2 * D)) % L,
              s = i / (2 * D * L);
    const T* src = kv ? v0 : k0;
    kv_rows(s, 0, l, kv)[c] = src[((size_t)l * d.B + s0 + s) * D + c];
  }
  __syncthreads();

  for (int t = 0; t < d.T; ++t) {
    const int p = t + 1;                 // this step's position
    for (int i = tid; i < M; i += NT) anc[i * S + p] = (uint8_t)(i % K);
    __syncthreads();
    clk.mark(PH_REORDER);

    for (int r0 = 0; r0 < M; r0 += CH) {
      const int rows = min(CH, M - r0);
      // ---- x = tok_table[prev] + pos_table[t+1] -------------------------
      for (int i = tid; i < rows * D; i += NT) {
        const int r = i / D, c = i - r * D;
        xs[r * LDX + c] =
            rnd<T>(ldg(tok + prev[r0 + r] * D + c) + ldg(pos + p * D + c));
      }
      __syncthreads();
      clk.mark(PH_EMBED);

      for (int l = 0; l < L; ++l) {
        const T* W = wpack + (size_t)l * lo.size;
        const float* Wln = lnpack + (size_t)l * LN_WORDS;
        layer_norm<T, LDX>(xs, hs, rows, Wln, Wln + D);
        __syncthreads();
        clk.mark(PH_LN1);
        product<T, kMma, EPI_BIAS, LDX>(hs, D, W + lo.qkvw, D / 4, 0, 3 * D,
                                        W + lo.qkvb, big, LDB, nullptr, rows);
        __syncthreads();
        clk.mark(PH_QKV);
        // each lane writes its own k and v rows at position p
        for (int i = tid; i < rows * D; i += NT) {
          const int r = i / D, c = i - r * D;
          const int row = r0 + r, hh = c / Dh, dd = c - hh * Dh;
          const float* q = big + r * LDB + hh * 3 * Dh + dd;
          st(kv_rows(row / K, row % K, l, 0) + p * D + c, q[Dh]);
          st(kv_rows(row / K, row % K, l, 1) + p * D + c, q[2 * Dh]);
        }
        __syncthreads();
        clk.mark(PH_KVW);
        // ---- attention: one warp per (lane, head) -> hs ----------------
        // a task's loads all go out before its softmax: lane s the K row
        // of position s, lane d the V values of dim d at every position
        for (int pr = warp; pr < rows * H; pr += NWARPS) {
          const int r = pr / H, hh = pr - r * H;
          const int row = r0 + r, sent = row / K;
          const uint8_t* an = anc + row * S;
          const float* q = big + r * LDB + hh * 3 * Dh;
          const T* kb = kv_rows(sent, 0, l, 0) + hh * Dh;  // + kl, s
          const T* vb = kv_rows(sent, 0, l, 1) + hh * Dh;
          float vv[32];
#pragma unroll
          for (int s = 0; s < 32; ++s)
            vv[s] = (s <= p && lane < Dh)
                        ? ld(vb + an[s] * lane_stride + s * D + lane)
                        : 0.0f;
          float score = -INFINITY;
          if (lane <= p) {
            const T* kr = kb + an[lane] * lane_stride + lane * D;
            float dot = 0.0f;
            if ((Dh & 3) == 0) {
#pragma unroll 8
              for (int dd = 0; dd < Dh; dd += 4) {
                const float4 qv = *reinterpret_cast<const float4*>(q + dd);
                const float4 kv = ld4(kr + dd);
                dot = fmaf(qv.x, kv.x, dot);
                dot = fmaf(qv.y, kv.y, dot);
                dot = fmaf(qv.z, kv.z, dot);
                dot = fmaf(qv.w, kv.w, dot);
              }
            } else {
              for (int dd = 0; dd < Dh; ++dd)
                dot = fmaf(q[dd], ld(kr + dd), dot);
            }
            score = dot / sqrt_dh;
          }
          const float m = warp_max(score);
          const float e = (lane <= p) ? expf(score - m) : 0.0f;
          const float prob = rnd<T>(e / warp_sum(e));
          for (int d0 = 0;;) {
            float acc = 0.0f;
#pragma unroll
            for (int s = 0; s < 32; ++s) {
              const float ps = __shfl_sync(0xffffffffu, prob, s);
              if (s <= p) acc = fmaf(ps, vv[s], acc);
            }
            if (d0 + lane < Dh)
              hs[r * LDX + hh * Dh + d0 + lane] = rnd<T>(acc);
            d0 += 32;
            if (d0 >= Dh) break;
#pragma unroll
            for (int s = 0; s < 32; ++s)
              vv[s] = (s <= p && d0 + lane < Dh)
                          ? ld(vb + an[s] * lane_stride + s * D + d0 + lane)
                          : 0.0f;
          }
        }
        __syncthreads();
        clk.mark(PH_ATTN);
        product<T, kMma, EPI_RESID, LDX>(hs, D, W + lo.aow, D / 4, 0, D,
                                         W + lo.aob, xs, LDX, nullptr, rows);
        __syncthreads();
        clk.mark(PH_OUT);
        layer_norm<T, LDX>(xs, hs, rows, Wln + 2 * D, Wln + 3 * D);
        __syncthreads();
        clk.mark(PH_LN2);
        // ---- feed-forward in chunks of up to 384 columns of d_ff --------
        for (int f0 = 0; f0 < F; f0 += FC) {
          const int wdt = min(FC, F - f0);
          // columns f0.. of ff1: its 128-column chunks from f0 / 128 on
          product<T, kMma, EPI_GELU, LDX>(
              hs, D, W + lo.ff1w + (size_t)f0 * D, D / 4, 0, wdt,
              W + lo.ff1b + f0, big, LDB, nullptr, rows);
          __syncthreads();
          clk.mark(PH_FF1);
          const float* from = (f0 == 0) ? nullptr : acc2;
          if (f0 + wdt >= F)
            product<T, kMma, EPI_RESID, LDB>(big, wdt, W + lo.ff2w, F / 4,
                                             f0 / 4, D, W + lo.ff2b, xs, LDX,
                                             from, rows);
          else
            product<T, kMma, EPI_PARTIAL, LDB>(big, wdt, W + lo.ff2w, F / 4,
                                               f0 / 4, D, (const T*)nullptr,
                                               acc2, LDX, from, rows);
          __syncthreads();
          clk.mark(PH_FF2);
        }
      }
      // ---- final LN and head -> candidate rows ----------------------------
      layer_norm<T, LDX>(xs, hs, rows, lnf_g, lnf_b);
      __syncthreads();
      for (int i = tid; i < rows * V; i += NT) {
        const int r = i / V, v = i - r * V;
        const float* h = hs + r * LDX;
        float acc = 0.0f;
#pragma unroll 8
        for (int k = 0; k < D; k += 4) {
          const float4 hv = *reinterpret_cast<const float4*>(h + k);
          acc = fmaf(hv.x, __ldg(wout + k * V + v), acc);
          acc = fmaf(hv.y, __ldg(wout + (k + 1) * V + v), acc);
          acc = fmaf(hv.z, __ldg(wout + (k + 2) * V + v), acc);
          acc = fmaf(hv.w, __ldg(wout + (k + 3) * V + v), acc);
        }
        cand[(r0 + r) * V + v] = acc + __ldg(bout + v);
      }
      __syncthreads();
      clk.mark(PH_HEAD);
    }

    // ---- one warp per sentence: log-softmax, candidates, top-K ----------
    for (int s = warp; s < n_s; s += NWARPS) {
      float* cs = cand + s * K * V;
      int* mi = misc + 3 * s;
      const int adv = mi[0];
      const int eos_top = mi[1];
      const int fin = mi[2];
      const bool done = eos_top && fin >= d.n_best;
      const bool eos_early = adv + 1 < d.min_length;
      const bool is_first = adv == 0;

      for (int b = 0; b < K; ++b) {
        float* row = cs + b * V;
        float m = -INFINITY;
        for (int v = lane; v < V; v += 32) m = fmaxf(m, row[v]);
        m = warp_max(m);
        float e = 0.0f;
        for (int v = lane; v < V; v += 32) e += expf(row[v] - m);
        const float lse = logf(warp_sum(e));
        const float score_b = scores[s * K + b];
        const bool eos_row = prev[s * K + b] == EOS_IDX;
        for (int v = lane; v < V; v += 32) {
          const float lp = (row[v] - m) - lse;
          float wp = (v == START_IDX) ? NEG : lp;
          if (v == EOS_IDX && eos_early) wp = NEG;
          float bs;
          if (is_first) {
            bs = (b == 0) ? wp : -INFINITY;
          } else {
            bs = eos_row ? NEG : wp + score_b;
          }
          row[v] = (bs == 0.0f) ? 0.0f : bs;    // -0.0 -> +0.0
        }
      }
      __syncwarp();

      const int KV = K * V;
      for (int i = 0; i < K; ++i) {
        float bv = -INFINITY;
        int bi = 0x7fffffff;
        for (int f = lane; f < KV; f += 32) {
          const float x = cs[f];
          if (x > bv || (x == bv && f < bi)) {
            bv = x;
            bi = f;
          }
        }
        warp_argmax(bv, bi);
        if (bi >= KV) bi = 0;   // unreachable within the scope: K <= V - 2
        if (lane == 0) {
          cs[bi] = -INFINITY;
          best[s * K + i] = bv;
          nexty[s * K + i] = bi % V;
          pk[s * K + i] = bi / V;
        }
        __syncwarp();
      }

      // bookkeeping + tapes (done-gated; sc stays ungated)
      const int sg = s0 + s;
      int n_fin = 0;
      for (int k = lane; k < K; k += 32) {
        const int ny = nexty[s * K + k];
        const int pkk = pk[s * K + k];
        const float bv = best[s * K + k];
        const size_t o = ((size_t)sg * d.T + t) * K + k;
        ys[o] = done ? PAD_IDX : ny;
        ptr[o] = done ? 0 : pkk;
        sc[o] = bv;
        if (!done) {
          scores[s * K + k] = bv;
          prev[s * K + k] = ny;
          n_fin += (ny == EOS_IDX);
        }
      }
      n_fin = warp_sum_int(n_fin);
      if (lane == 0 && !done) {
        mi[0] = adv + 1;
        mi[1] = eos_top | (nexty[s * K] == EOS_IDX);
        mi[2] = fin + n_fin;
      }
      __syncwarp();
    }
    __syncthreads();
    clk.mark(PH_SELECT);

    // ---- the beam reorder: permute the ancestry map, not the caches ------
    for (int i = tid; i < M * (p + 1); i += NT) {
      const int row = i / (p + 1), s = i - row * (p + 1);
      const int src = (row / K) * K + pk[row];
      anc_nxt[row * S + s] = anc[src * S + s];
    }
    __syncthreads();
    clk.mark(PH_REORDER);
    uint8_t* tmp = anc;
    anc = anc_nxt;
    anc_nxt = tmp;
  }

  for (int i = tid; i < M; i += NT) scores_out[(size_t)s0 * K + i] = scores[i];
  for (int s = tid; s < n_s; s += NT) {
    adv_out[s0 + s] = misc[3 * s];
    fin_out[s0 + s] = misc[3 * s + 2];
  }
  clk.done();
}

struct Plan {
  int n_sent, threads, slots;
  size_t smem;
};

size_t smem_bytes(int n, int K, int V, int S, int F) {
  const Smem m = make_smem(n, K, V, S, F);
  return (size_t)m.words * 4 + (size_t)((m.anc_bytes + 15) & ~15);
}

// Sentences per block: at most CH / K (at least 1), chosen from B and the
// blocks the card holds at once (slots) so that the waves come out full:
// the n that minimises waves(n) * (n + 2), the 2 standing for a block's
// fixed cost (its weight reads, the selection's latency) in sentences;
// ties go to the larger n.
template <typename T>
int make_plan(int B, int K, int V, int S, int F, Plan* plan) {
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
  if (K < 1 || K > 255 || S > 32 || F < 128 || F % 128)
    return (int)cudaErrorInvalidValue;
  const int n_max = CH / K > 0 ? CH / K : 1;
  const size_t smem_max = smem_bytes(n_max, K, V, S, F);
  if (smem_max > (size_t)max_smem) return (int)cudaErrorInvalidConfiguration;
  e = cudaFuncSetAttribute(tfm_beam_kernel<T, false, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_max);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, tfm_beam_kernel<T, false, false>, NT, smem_max);
  if (e != cudaSuccess) return (int)e;
  const long long slots = (long long)(per_sm > 0 ? per_sm : 1) * n_sm;
  const int Bp = B > 0 ? B : 1;
  int best_n = 1;
  long long best_cost = -1;
  for (int n = 1; n <= n_max && n <= Bp; ++n) {
    const long long blocks = (Bp + n - 1) / n;
    const long long cost = ((blocks + slots - 1) / slots) * (n + 2);
    if (best_cost < 0 || cost <= best_cost) {
      best_cost = cost;
      best_n = n;
    }
  }
  plan->n_sent = best_n;
  plan->threads = NT;
  plan->slots = (int)slots;
  plan->smem = smem_bytes(best_n, K, V, S, F);
  return 0;
}

template <typename T, bool kMma, bool kStamp>
int launch(const T* tok, const T* pos, const T* wpack, const float* lnpack,
           const float* lnf_g, const float* lnf_b, const float* wout,
           const float* bout, const T* k0, const T* v0, T* scratch, int* ys,
           int* ptr, float* sc, float* scores, int* adv, int* fin, int B,
           int T_, int K, int V, int S, int L, int H, int F, int min_length,
           int n_best, long long* stamps, void* stream) {
  if (B <= 0) return 0;
  if (H <= 0 || D % H || T_ + 1 > S || V > 127 || K > V - 2 || L < 1)
    return (int)cudaErrorInvalidValue;
  Plan p;
  int e = make_plan<T>(B, K, V, S, F, &p);
  if (e) return e;
  cudaError_t ce = cudaFuncSetAttribute(
      tfm_beam_kernel<T, kMma, kStamp>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (ce != cudaSuccess) return (int)ce;
  Dims d{B, T_, K, V, S, L, H, F, min_length, n_best, p.n_sent};
  const int grid = (B + p.n_sent - 1) / p.n_sent;
  tfm_beam_kernel<T, kMma, kStamp><<<grid, p.threads, p.smem,
                                     (cudaStream_t)stream>>>(
      tok, pos, wpack, lnpack, lnf_g, lnf_b, wout, bout, k0, v0, scratch, ys,
      ptr, sc, scores, adv, fin, stamps, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch plan for these shapes and type (bf16 != 0: the bf16
// instantiation): sentences per block, threads per block, dynamic shared
// bytes, blocks resident on the card at once.
int tfm_beam_plan(int B, int K, int V, int S, int F, int bf16, int* out4) {
  Plan p;
  int e = bf16 ? make_plan<__nv_bfloat16>(B, K, V, S, F, &p)
               : make_plan<float>(B, K, V, S, F, &p);
  if (e) return e;
  out4[0] = p.n_sent;
  out4[1] = p.threads;
  out4[2] = (int)p.smem;
  out4[3] = p.slots;
  return 0;
}

// Launch the beam on `stream`; returns the CUDA error of the launch (0 on
// success). Does not synchronise and allocates nothing: `scratch` is the
// caller's [B, K, L, 2, S, 128] buffer for the lanes' KV rows. wpack holds
// per layer the four matrices pre-tiled (weight_tiles) and the four
// biases; lnpack per layer LayerNorm's ln1 g, b, ln2 g, b (f32).
int tfm_beam_f32(const float* tok, const float* pos, const float* wpack,
                 const float* lnpack, const float* lnf_g, const float* lnf_b,
                 const float* wout, const float* bout, const float* k0,
                 const float* v0, float* scratch, int* ys, int* ptr,
                 float* sc, float* scores, int* adv, int* fin, int B, int T,
                 int K, int V, int S, int L, int H, int F, int min_length,
                 int n_best, void* stream) {
  return launch<float, false, false>(
      tok, pos, wpack, lnpack, lnf_g, lnf_b, wout, bout, k0, v0, scratch, ys,
      ptr, sc, scores, adv, fin, B, T, K, V, S, L, H, F, min_length, n_best,
      nullptr, stream);
}

// The same on bf16 tables, products' weights and biases (wpack), prefix
// rows and KV scratch; LayerNorm's parameters, the final LN and the head
// are f32.
int tfm_beam_bf16(const __nv_bfloat16* tok, const __nv_bfloat16* pos,
                  const __nv_bfloat16* wpack, const float* lnpack,
                  const float* lnf_g, const float* lnf_b, const float* wout,
                  const float* bout, const __nv_bfloat16* k0,
                  const __nv_bfloat16* v0, __nv_bfloat16* scratch, int* ys,
                  int* ptr, float* sc, float* scores, int* adv, int* fin,
                  int B, int T, int K, int V, int S, int L, int H, int F,
                  int min_length, int n_best, void* stream) {
  return launch<__nv_bfloat16, false, false>(
      tok, pos, wpack, lnpack, lnf_g, lnf_b, wout, bout, k0, v0, scratch, ys,
      ptr, sc, scores, adv, fin, B, T, K, V, S, L, H, F, min_length, n_best,
      nullptr, stream);
}

// Measurement only: the stamp instantiations of the two entries, the
// same arguments and one more, the zeroed int64 buffer of
// tfm_beam_stamp_words(grid) words the phase clocks write (PhaseClock).
int tfm_beam_f32_stamp(const float* tok, const float* pos, const float* wpack,
                       const float* lnpack, const float* lnf_g,
                       const float* lnf_b, const float* wout,
                       const float* bout, const float* k0, const float* v0,
                       float* scratch, int* ys, int* ptr, float* sc,
                       float* scores, int* adv, int* fin, int B, int T, int K,
                       int V, int S, int L, int H, int F, int min_length,
                       int n_best, long long* stamps, void* stream) {
  return launch<float, false, true>(
      tok, pos, wpack, lnpack, lnf_g, lnf_b, wout, bout, k0, v0, scratch, ys,
      ptr, sc, scores, adv, fin, B, T, K, V, S, L, H, F, min_length, n_best,
      stamps, stream);
}

int tfm_beam_bf16_stamp(const __nv_bfloat16* tok, const __nv_bfloat16* pos,
                        const __nv_bfloat16* wpack, const float* lnpack,
                        const float* lnf_g, const float* lnf_b,
                        const float* wout, const float* bout,
                        const __nv_bfloat16* k0, const __nv_bfloat16* v0,
                        __nv_bfloat16* scratch, int* ys, int* ptr, float* sc,
                        float* scores, int* adv, int* fin, int B, int T,
                        int K, int V, int S, int L, int H, int F,
                        int min_length, int n_best, long long* stamps,
                        void* stream) {
  return launch<__nv_bfloat16, false, true>(
      tok, pos, wpack, lnpack, lnf_g, lnf_b, wout, bout, k0, v0, scratch, ys,
      ptr, sc, scores, adv, fin, B, T, K, V, S, L, H, F, min_length, n_best,
      stamps, stream);
}

// Measurement only: the bf16 entry with its products on the tensor cores
// (gemm_mma), the same arguments as tfm_beam_bf16.
int tfm_beam_bf16_mma(const __nv_bfloat16* tok, const __nv_bfloat16* pos,
                      const __nv_bfloat16* wpack, const float* lnpack,
                      const float* lnf_g, const float* lnf_b,
                      const float* wout, const float* bout,
                      const __nv_bfloat16* k0, const __nv_bfloat16* v0,
                      __nv_bfloat16* scratch, int* ys, int* ptr, float* sc,
                      float* scores, int* adv, int* fin, int B, int T, int K,
                      int V, int S, int L, int H, int F, int min_length,
                      int n_best, void* stream) {
  return launch<__nv_bfloat16, true, false>(
      tok, pos, wpack, lnpack, lnf_g, lnf_b, wout, bout, k0, v0, scratch, ys,
      ptr, sc, scores, adv, fin, B, T, K, V, S, L, H, F, min_length, n_best,
      nullptr, stream);
}

// Words of the stamp buffer for a grid of `grid` blocks; the phase count.
int tfm_beam_stamp_words(int grid) { return 2 + 2 * (NPH + 1) + 2 * grid; }
int tfm_beam_stamp_phases() { return NPH; }

const char* tfm_beam_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
