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
// (csrc/beam_gru.cu, unchanged): START blocked, EOS blocked below
// min_length, children of EOS rows blocked, the first step from beam 0
// only, signed zeros canonicalized, an iterated top-K with ties to the
// lowest flat index k*V+v, the done-gated tapes. It emits ys/ptr/sc
// [B,T,K] and scores [B,K], adv [B], fin_cnt [B]; ops/beam.py turns them
// into hypotheses.
//
// What bounds it on the H100: operations. Per beam-token the products
// cost 2*L*(D*3D + D*D + 2*D*F) + 2*D*V FLOP plus attention's
// 4*D*(t+2) per layer, 544 kFLOP on average at the shipped width (D 128,
// L 2, F 256, V 24, T 25): 340 GFLOP for a round of 5,000 sentences at
// beam 5, 5.08 ms at the fp32 rate of the CUDA cores (67 TFLOP/s). The
// bytes the function must move are the 1.07 MB of weights and the tapes.
//
// Design (right first, not yet fast):
// * One block holds a tile of sentences whose beam lanes, M = sentences*K
//   rows (40 at K 5), advance together through all T steps; nothing
//   carries between blocks, so every sentence's result is independent of
//   the batch and of the tiling (bitwise batch invariance).
// * Activations live in shared memory in fp32: the residual stream and the
//   LN/attention output [40, 128] each, and one [40, 384] buffer for qkv
//   or a 384-column chunk of ff1 (d_ff above 384 runs in chunks; ff2 then
//   sums the chunks into a fifth [40, 128] buffer in the same k order).
//   Lanes beyond 40 (large K) run in chunks of 40 rows: a step's rows
//   only meet again at the candidate selection.
// * Weights stay in device memory, where the 50 MB L2 holds them for every
//   block. The products are fp32 FMAs on the CUDA cores (no TF32): thread
//   (row group g, column c) keeps 20 rows x RN columns of sums in
//   registers, reads each weight once per row group through L1/L2 (the
//   next four k ahead), and the activation rows as broadcast 16-byte
//   shared loads. Each output is one sequential sum over k.
// * The KV caches do not fit on chip: one sentence's fp32 caches at the
//   shipped width are K*L*2*S*D*4 = 260 KB, above a block's 227 KB. They
//   live in a scratch tensor [B, K, L, 2, S, D] that the wrapper
//   allocates; each lane writes only its own row at t+1. The beam reorder
//   permutes a [sentences, K, S] ancestry map in shared memory instead of
//   the caches (the JAX package's no-reorder arm, ops/beam.py:388): lane
//   k's history row at position s is the row lane anc[k][s] wrote, so
//   attention reads the same values in the same order as a reordered
//   cache. Position 0, the latent prefix, is the same for every lane and
//   is stored once, in lane 0.
// * Attention: one warp per (lane, head); lane s of the warp scores
//   position s (S <= 32), positions above t+1 are skipped (their masked
//   -1e30 logits contribute exact zeros); the value sum runs over
//   positions in order, lanes over the head's dims.
// * LayerNorm and the softmaxes are f32 with one warp per row; eps 1e-6
//   inside the square root; GELU is the tanh form.
// Sums are taken in another order than cuBLAS or the CPU, so near-tie
// rows may pick another token than the plain version; chip_smoke.py
// bounds that share.
//
// bf16 (entry tfm_beam_bf16): the same kernel instantiated on bf16 storage
// for the tables, the products' weights and biases, the prefix rows and
// the KV caches (53 KB a sentence at the shipped width, 266 MB at
// B 5,000, half of fp32's); LayerNorm's parameters, the final LN and the
// head stay f32, as the JAX kernel keeps them (pallas_tfm_beam.py:406).
// Activations stay f32 in shared memory and the math is fp32 FMAs,
// rounded to bf16 (round to nearest even) where the JAX kernel rounds in
// interpret mode (models/transformer.py:_block_step): the entry
// tok_table[prev] + pos_table[t+1]; each product accumulated in f32 and
// rounded, then its bias added and the sum rounded (qkv, out, ff2); the
// attention probabilities before the value sum and that sum once; the
// LayerNorms and the GELU in f32, their outputs rounded. LayerNorm reads
// the residual stream's f32 sum before its rounding and the GELU the f32
// sum of ff1's rounded product and bias, while the residual adds take the
// rounded values: the stream is kept unrounded in shared memory and
// rounded where a residual add reads it. The fp32 instantiation's
// rounding is the identity: the fp32 kernel's arithmetic is unchanged.

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
constexpr int RM = 20;           // rows per thread in the products
constexpr int CH = 2 * RM;       // rows per chunk: two row groups
constexpr int FC = 3 * D;        // widest product: qkv, or a chunk of ff1
constexpr int MAX_ROWS = 40;     // beam lanes per block aimed at

struct Dims {
  int B, T, K, V, S, L, H, F, min_length, n_best, n_sent;
};

// offsets (in floats) of one layer's parameters in the packed weights, in
// the order of ops/tfm_beam_kernel.py:_LAYER_LEAVES
struct LayerOff {
  int ln1g, ln1b, qkvw, qkvb, aow, aob, ln2g, ln2b, ff1w, ff1b, ff2w, ff2b,
      size;
};

__host__ __device__ inline LayerOff layer_off(int F) {
  LayerOff o;
  int x = 0;
  o.ln1g = x; x += D;
  o.ln1b = x; x += D;
  o.qkvw = x; x += D * 3 * D;
  o.qkvb = x; x += 3 * D;
  o.aow = x;  x += D * D;
  o.aob = x;  x += D;
  o.ln2g = x; x += D;
  o.ln2b = x; x += D;
  o.ff1w = x; x += D * F;
  o.ff1b = x; x += F;
  o.ff2w = x; x += F * D;
  o.ff2b = x; x += D;
  o.size = x;
  return o;
}

// per-block shared-memory layout, in 4-byte words (anc in bytes after)
struct Smem {
  int xs, hs, big, acc2, cand, scores, best, prev, nexty, pk, misc, words;
  int anc_bytes;
};

__host__ __device__ inline Smem make_smem(int n_sent, int K, int V, int S,
                                          int F) {
  Smem m;
  const int M = n_sent * K;
  int o = 0;
  m.xs = o;     o += CH * D;
  m.hs = o;     o += CH * D;
  m.big = o;    o += CH * FC;
  m.acc2 = o;   o += (F > FC) ? CH * D : 0;
  m.cand = o;   o += M * V;
  m.scores = o; o += M;
  m.best = o;   o += M;
  m.prev = o;   o += M;
  m.nexty = o;  o += M;
  m.pk = o;     o += M;
  m.misc = o;   o += 3 * n_sent;   // adv, eos_top, fin_cnt
  m.words = (o + 3) & ~3;
  m.anc_bytes = 2 * M * S;         // two maps: this step's and the next
  return m;
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

enum Epi { EPI_BIAS, EPI_GELU, EPI_RESID, EPI_PARTIAL };

// C[r][n] for r < rows, n < RN*128: the product of the shared rows A
// [rows, Kd] (row stride LDA) and the device-memory W [Kd, ldw] (columns
// from W's first, ldw its row stride), each output one sequential sum over
// k. Sums start from Cin (stride D) when given, else 0. Epilogues, with
// P = rnd(sum) + b (the rounded product plus the bias, unrounded):
// BIAS C = rnd(P); GELU C = rnd(gelu(P)); RESID C = rnd(C) + rnd(P), the
// residual stream's unrounded sum; PARTIAL C = sum. Thread (g = tid / 128,
// c = tid % 128) owns rows g*RM.. of columns c + 128*q. Rows at and above
// `rows` read whatever the buffer holds and are not stored.
template <int RN, int EPI, int LDA, typename T>
__device__ __forceinline__ void gemm(const float* A, int Kd,
                                     const T* __restrict__ W, int ldw,
                                     const T* __restrict__ bias,
                                     float* C, int ldc, const float* Cin,
                                     int rows) {
  const int c = threadIdx.x & 127;
  const int g = threadIdx.x >> 7;
  const int rbase = g * RM;
  const float* a0 = A + rbase * LDA;
  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int q = 0; q < RN; ++q)
      acc[i][q] = (Cin != nullptr && rbase + i < rows)
                      ? Cin[(rbase + i) * D + c + 128 * q] : 0.0f;
  float w[4][RN], wn[4][RN];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < RN; ++q) w[kk][q] = ldg(W + kk * ldw + c + 128 * q);
  for (int k = 0; k < Kd; k += 4) {
    if (k + 4 < Kd) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < RN; ++q)
          wn[kk][q] = ldg(W + (k + 4 + kk) * ldw + c + 128 * q);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(a0 + i * LDA + k);
#pragma unroll
      for (int q = 0; q < RN; ++q) {
        float s = acc[i][q];
        s = fmaf(a.x, w[0][q], s);
        s = fmaf(a.y, w[1][q], s);
        s = fmaf(a.z, w[2][q], s);
        s = fmaf(a.w, w[3][q], s);
        acc[i][q] = s;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < RN; ++q) w[kk][q] = wn[kk][q];
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = rbase + i;
    if (r < rows) {
#pragma unroll
      for (int q = 0; q < RN; ++q) {
        const int n = c + 128 * q;
        float* out = C + r * ldc + n;
        if (EPI == EPI_PARTIAL) {
          *out = acc[i][q];
        } else {
          const float pb = rnd<T>(acc[i][q]) + ldg(bias + n);
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

// Y[r] = LayerNorm(X[r]) * g + b over D = 128 values, one warp per row,
// rounded to T's precision
template <typename T>
__device__ __forceinline__ void layer_norm(const float* X, float* Y, int rows,
                                           const float* __restrict__ g,
                                           const float* __restrict__ b) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float4 gv = __ldg(reinterpret_cast<const float4*>(g) + lane);
  const float4 bv = __ldg(reinterpret_cast<const float4*>(b) + lane);
  for (int r = warp; r < rows; r += NWARPS) {
    const float4 v = reinterpret_cast<const float4*>(X + r * D)[lane];
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
    reinterpret_cast<float4*>(Y + r * D)[lane] = y;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 2)
tfm_beam_kernel(const T* __restrict__ tok,          // [V, D]
                const T* __restrict__ pos,          // [S, D]
                const T* __restrict__ wpack,        // L x LayerOff.size
                const float* __restrict__ lnpack,   // L x LayerOff.size
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
                Dims d) {
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

    for (int r0 = 0; r0 < M; r0 += CH) {
      const int rows = min(CH, M - r0);
      // ---- x = tok_table[prev] + pos_table[t+1] -------------------------
      for (int i = tid; i < rows * D; i += NT) {
        const int r = i / D, c = i - r * D;
        xs[i] = rnd<T>(ldg(tok + prev[r0 + r] * D + c) + ldg(pos + p * D + c));
      }
      __syncthreads();

      for (int l = 0; l < L; ++l) {
        const T* W = wpack + (size_t)l * lo.size;
        const float* Wln = lnpack + (size_t)l * lo.size;
        layer_norm<T>(xs, hs, rows, Wln + lo.ln1g, Wln + lo.ln1b);
        __syncthreads();
        gemm<3, EPI_BIAS, D>(hs, D, W + lo.qkvw, 3 * D, W + lo.qkvb, big, FC,
                             nullptr, rows);
        __syncthreads();
        // each lane writes its own k and v rows at position p
        for (int i = tid; i < rows * D; i += NT) {
          const int r = i / D, c = i - r * D;
          const int row = r0 + r, hh = c / Dh, dd = c - hh * Dh;
          const float* q = big + r * FC + hh * 3 * Dh + dd;
          st(kv_rows(row / K, row % K, l, 0) + p * D + c, q[Dh]);
          st(kv_rows(row / K, row % K, l, 1) + p * D + c, q[2 * Dh]);
        }
        __syncthreads();
        // ---- attention: one warp per (lane, head) -> hs ----------------
        for (int pr = warp; pr < rows * H; pr += NWARPS) {
          const int r = pr / H, hh = pr - r * H;
          const int row = r0 + r, sent = row / K;
          const uint8_t* an = anc + row * S;
          const float* q = big + r * FC + hh * 3 * Dh;
          float score = -INFINITY;
          if (lane <= p) {
            const T* kr = kv_rows(sent, an[lane], l, 0) + lane * D +
                          hh * Dh;
            float dot = 0.0f;
            if ((Dh & 3) == 0) {
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
          for (int d0 = 0; d0 < Dh; d0 += 32) {
            const int dd = d0 + lane;
            float acc = 0.0f;
            for (int s = 0; s <= p; ++s) {
              const float ps = __shfl_sync(0xffffffffu, prob, s);
              if (dd < Dh)
                acc = fmaf(ps,
                           ld(kv_rows(sent, an[s], l, 1) + s * D + hh * Dh + dd),
                           acc);
            }
            if (dd < Dh) hs[r * D + hh * Dh + dd] = rnd<T>(acc);
          }
        }
        __syncthreads();
        gemm<1, EPI_RESID, D>(hs, D, W + lo.aow, D, W + lo.aob, xs, D,
                              nullptr, rows);
        __syncthreads();
        layer_norm<T>(xs, hs, rows, Wln + lo.ln2g, Wln + lo.ln2b);
        __syncthreads();
        // ---- feed-forward in chunks of up to 384 columns of d_ff --------
        for (int f0 = 0; f0 < F; f0 += FC) {
          const int wdt = min(FC, F - f0);
          const T* w1 = W + lo.ff1w + f0;
          const T* b1 = W + lo.ff1b + f0;
          if (wdt == 3 * 128)
            gemm<3, EPI_GELU, D>(hs, D, w1, F, b1, big, FC, nullptr, rows);
          else if (wdt == 2 * 128)
            gemm<2, EPI_GELU, D>(hs, D, w1, F, b1, big, FC, nullptr, rows);
          else
            gemm<1, EPI_GELU, D>(hs, D, w1, F, b1, big, FC, nullptr, rows);
          __syncthreads();
          const T* w2 = W + lo.ff2w + (size_t)f0 * D;
          const float* from = (f0 == 0) ? nullptr : acc2;
          if (f0 + wdt >= F)
            gemm<1, EPI_RESID, FC>(big, wdt, w2, D, W + lo.ff2b, xs, D, from,
                                   rows);
          else
            gemm<1, EPI_PARTIAL, FC>(big, wdt, w2, D, (const T*)nullptr, acc2,
                                     D, from, rows);
          __syncthreads();
        }
      }
      // ---- final LN and head -> candidate rows ----------------------------
      layer_norm<T>(xs, hs, rows, lnf_g, lnf_b);
      __syncthreads();
      for (int i = tid; i < rows * V; i += NT) {
        const int r = i / V, v = i - r * V;
        const float* h = hs + r * D;
        float acc = 0.0f;
        for (int k = 0; k < D; ++k) acc = fmaf(h[k], __ldg(wout + k * V + v),
                                               acc);
        cand[(r0 + r) * V + v] = acc + __ldg(bout + v);
      }
      __syncthreads();
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

    // ---- the beam reorder: permute the ancestry map, not the caches ------
    for (int i = tid; i < M * (p + 1); i += NT) {
      const int row = i / (p + 1), s = i - row * (p + 1);
      const int src = (row / K) * K + pk[row];
      anc_nxt[row * S + s] = anc[src * S + s];
    }
    __syncthreads();
    uint8_t* tmp = anc;
    anc = anc_nxt;
    anc_nxt = tmp;
  }

  for (int i = tid; i < M; i += NT) scores_out[(size_t)s0 * K + i] = scores[i];
  for (int s = tid; s < n_s; s += NT) {
    adv_out[s0 + s] = misc[3 * s];
    fin_out[s0 + s] = misc[3 * s + 2];
  }
}

struct Plan {
  int n_sent, threads;
  size_t smem;
};

int make_plan(int B, int K, int V, int S, int F, Plan* plan) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int max_smem = 0;
  e = cudaDeviceGetAttribute(&max_smem,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (K < 1 || K > 255 || S > 32 || F < 128 || F % 128)
    return (int)cudaErrorInvalidValue;
  int n = MAX_ROWS / K > 0 ? MAX_ROWS / K : 1;
  n = n < B ? n : (B > 0 ? B : 1);
  const Smem m = make_smem(n, K, V, S, F);
  plan->n_sent = n;
  plan->threads = NT;
  plan->smem = (size_t)m.words * 4 + (size_t)((m.anc_bytes + 15) & ~15);
  if (plan->smem > (size_t)max_smem) return (int)cudaErrorInvalidConfiguration;
  return 0;
}

template <typename T>
int launch(const T* tok, const T* pos, const T* wpack, const float* lnpack,
           const float* lnf_g, const float* lnf_b, const float* wout,
           const float* bout, const T* k0, const T* v0, T* scratch, int* ys,
           int* ptr, float* sc, float* scores, int* adv, int* fin, int B,
           int T_, int K, int V, int S, int L, int H, int F, int min_length,
           int n_best, void* stream) {
  if (B <= 0) return 0;
  if (H <= 0 || D % H || T_ + 1 > S || V > 127 || K > V - 2 || L < 1)
    return (int)cudaErrorInvalidValue;
  Plan p;
  int e = make_plan(B, K, V, S, F, &p);
  if (e) return e;
  cudaError_t ce = cudaFuncSetAttribute(
      tfm_beam_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)p.smem);
  if (ce != cudaSuccess) return (int)ce;
  Dims d{B, T_, K, V, S, L, H, F, min_length, n_best, p.n_sent};
  const int grid = (B + p.n_sent - 1) / p.n_sent;
  tfm_beam_kernel<T><<<grid, p.threads, p.smem, (cudaStream_t)stream>>>(
      tok, pos, wpack, lnpack, lnf_g, lnf_b, wout, bout, k0, v0, scratch, ys,
      ptr, sc, scores, adv, fin, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch plan for these shapes: sentences per block, threads per
// block, dynamic shared bytes (the same for both types).
int tfm_beam_plan(int B, int K, int V, int S, int F, int* out3) {
  Plan p;
  int e = make_plan(B, K, V, S, F, &p);
  if (e) return e;
  out3[0] = p.n_sent;
  out3[1] = p.threads;
  out3[2] = (int)p.smem;
  return 0;
}

// Launch the beam on `stream`; returns the CUDA error of the launch (0 on
// success). Does not synchronise and allocates nothing: `scratch` is the
// caller's [B, K, L, 2, S, 128] float buffer for the lanes' KV rows.
int tfm_beam_f32(const float* tok, const float* pos, const float* wpack,
                 const float* lnf_g, const float* lnf_b, const float* wout,
                 const float* bout, const float* k0, const float* v0,
                 float* scratch, int* ys, int* ptr, float* sc, float* scores,
                 int* adv, int* fin, int B, int T, int K, int V, int S,
                 int L, int H, int F, int min_length, int n_best,
                 void* stream) {
  return launch<float>(tok, pos, wpack, wpack, lnf_g, lnf_b, wout, bout, k0,
                       v0, scratch, ys, ptr, sc, scores, adv, fin, B, T, K, V,
                       S, L, H, F, min_length, n_best, stream);
}

// The same on bf16 tables, products' weights and biases (wpack), prefix
// rows and KV scratch; LayerNorm's parameters come from the f32 pack
// lnpack (laid out as wpack), the final LN and the head are f32.
int tfm_beam_bf16(const __nv_bfloat16* tok, const __nv_bfloat16* pos,
                  const __nv_bfloat16* wpack, const float* lnpack,
                  const float* lnf_g, const float* lnf_b, const float* wout,
                  const float* bout, const __nv_bfloat16* k0,
                  const __nv_bfloat16* v0, __nv_bfloat16* scratch, int* ys,
                  int* ptr, float* sc, float* scores, int* adv, int* fin,
                  int B, int T, int K, int V, int S, int L, int H, int F,
                  int min_length, int n_best, void* stream) {
  return launch<__nv_bfloat16>(tok, pos, wpack, lnpack, lnf_g, lnf_b, wout,
                               bout, k0, v0, scratch, ys, ptr, sc, scores,
                               adv, fin, B, T, K, V, S, L, H, F, min_length,
                               n_best, stream);
}

const char* tfm_beam_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
