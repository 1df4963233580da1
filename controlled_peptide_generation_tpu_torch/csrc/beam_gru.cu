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
// V 24, K 5, T 25) a sentence costs K*T*2*(H*3H + H*V) = 8.5 MFLOP of
// fp32 FMAs against ~0.5 KB of inputs and outputs, so the fp32 rate of the
// CUDA cores (67 TFLOP/s) is the roof, and the recurrence leaves no
// tensor-core-sized product: the per-step [K, H] x [H, 3H] product of one
// sentence is a matrix-vector-like shape.
//
// Design: one block holds S sentences, S*H threads. The recurrent weights
// wh [H, 3H] and the head w_out [H, V] are copied once into shared memory
// (125 KB + 10 KB at the shipped width) and reused for all T steps of all
// S sentences; the hidden states, logits and candidates of the S
// sentences live in shared memory too, so nothing but the inputs and the
// tapes touch device memory. Where the weights and one sentence do not
// fit the 227 KB a block can opt into (H 127 with V 128), the weights are
// read through the L1/L2 caches instead. Each step has four phases split
// by block barriers:
//   1. GRU: thread (s, j) computes gate column j of all K beams of
//      sentence s, so every weight read from shared memory feeds K FMAs
//      (beams in chunks of KC) and the gates finish in registers;
//   2. head: thread (s, v) computes logit v of all K beams;
//   3. one warp per sentence: log-softmax, masking, K rounds of warp
//      argmax, bookkeeping and the tape writes;
//   4. the hidden-state reorder by backpointer.
// Sums are taken in another order than cuBLAS or the CPU, so near-tie
// rows may pick another token than the plain version; chip_smoke.py
// bounds that share.
//
// bf16 (entry beam_gru_bf16): the same kernel instantiated on bf16
// storage for the inputs and the shared weights (wh 62.4 KB at H 102,
// half of fp32's); the hidden states stay in shared memory as floats that
// hold bf16 values. The math is fp32 FMAs, rounded to bf16 (round to
// nearest even) where the JAX kernel rounds in interpret mode
// (ops/beam_kernel.py:gru_cell_bf16_points): gi = tok_table[prev] + zc_gi;
// gh and the logits accumulated in f32 with their bias and rounded once;
// r and z the f32 sigmoid (expf) of the unrounded f32 sum gi + gh, rounded;
// n the f32 tanhf of gi_n plus the rounded r * gh_n, rounded; the blend
// (1 - z) * n + z * h with each op rounded. The log-softmax, scores and
// top-K stay f32, so the tie rule is unchanged: equal candidates, far more
// common on bf16 logits, go to the lowest flat index k*V+v. Each output
// is one sequential sum over k whatever the batch, so batch invariance
// stays bitwise. The fp32 instantiation's rounding is the identity: the
// fp32 kernel's arithmetic is unchanged. Bound at the shipped width: the
// same FMAs over the bf16 tensor-core rate (this kernel does not use the
// tensor cores: that is a later redesign).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int PAD_IDX = 1;
constexpr int START_IDX = 2;
constexpr int EOS_IDX = 3;
constexpr float NEG = -1e20f;
constexpr int KC = 5;            // beams per pass of the GRU/head loops
constexpr int MAX_THREADS = 1024;

struct Layout {
  // per-sentence shared-memory offsets, in 4-byte words
  int zcgi, h, hn, cand, scores, best, prev, nexty, pk, misc, words;
};

__host__ __device__ inline Layout make_layout(int K, int V, int H) {
  Layout L;
  int o = 0;
  L.zcgi = o;   o += 3 * H;
  L.h = o;      o += K * H;
  L.hn = o;     o += K * H;
  L.cand = o;   o += K * V;
  L.scores = o; o += K;
  L.best = o;   o += K;
  L.prev = o;   o += K;
  L.nexty = o;  o += K;
  L.pk = o;     o += K;
  L.misc = o;   o += 3;          // adv, eos_top, fin_cnt
  L.words = o + (o & 1);         // keep 8-byte alignment between sentences
  return L;
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

// shared-memory words of the weights wh and w_out in storage type T, kept
// a multiple of four (16-byte alignment of the sentences' state after them)
template <typename T>
__host__ __device__ inline int weight_words(int H, int V) {
  const int bytes = (3 * H * H + H * V) * (int)sizeof(T);
  return ((bytes + 15) / 16) * 4;
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

template <typename St>
__global__ void __launch_bounds__(MAX_THREADS, 1)
beam_gru_kernel(const St* __restrict__ tok_table,       // [V, 3H]
                const St* __restrict__ zc_gi,           // [B, 3H]
                const St* __restrict__ wh_g,            // [H, 3H]
                const St* __restrict__ bh,              // [3H]
                const St* __restrict__ wout_g,          // [H, V]
                const St* __restrict__ b_out,           // [V]
                const St* __restrict__ zc0,             // [B, H]
                int* __restrict__ ys,                  // [B, T, K]
                int* __restrict__ ptr,                 // [B, T, K]
                float* __restrict__ sc,                // [B, T, K]
                float* __restrict__ scores_out,        // [B, K]
                int* __restrict__ adv_out,             // [B]
                int* __restrict__ fin_out,             // [B]
                int B, int T, int K, int V, int H, int min_length,
                int n_best, int S, int weights_in_smem) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  const int H3 = 3 * H;
  const int s0 = blockIdx.x * S;
  const int n_s = min(S, B - s0);          // live sentences in this block

  const St* wh = wh_g;
  const St* wout = wout_g;
  float* sent_base = smem;
  if (weights_in_smem) {
    St* s_wh = reinterpret_cast<St*>(smem);
    St* s_wout = s_wh + H * H3;
    for (int i = tid; i < H * H3; i += nt) s_wh[i] = wh_g[i];
    for (int i = tid; i < H * V; i += nt) s_wout[i] = wout_g[i];
    wh = s_wh;
    wout = s_wout;
    sent_base = smem + weight_words<St>(H, V);
  }
  const Layout L = make_layout(K, V, H);
  auto sent = [&](int s) { return sent_base + s * L.words; };

  // ---- initial state ------------------------------------------------
  for (int i = tid; i < n_s * H3; i += nt) {
    int s = i / H3, j = i - s * H3;
    sent(s)[L.zcgi + j] = ld(zc_gi + (size_t)(s0 + s) * H3 + j);
  }
  for (int i = tid; i < n_s * K * H; i += nt) {
    int s = i / (K * H), r = i - s * K * H, j = r % H;
    sent(s)[L.h + r] = ld(zc0 + (size_t)(s0 + s) * H + j);
  }
  for (int i = tid; i < n_s * K; i += nt) {
    int s = i / K, k = i - s * K;
    float* st = sent(s);
    st[L.scores + k] = 0.0f;
    reinterpret_cast<int*>(st)[L.prev + k] = (k == 0) ? START_IDX : PAD_IDX;
  }
  for (int s = tid; s < n_s; s += nt) {
    int* mi = reinterpret_cast<int*>(sent(s)) + L.misc;
    mi[0] = 0;
    mi[1] = 0;
    mi[2] = 0;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // ---- 1. GRU cell: thread (s, j) -> h'[s, :, j] ----------------------
    for (int p = tid; p < n_s * H; p += nt) {
      const int s = p / H, j = p - s * H;
      float* st = sent(s);
      const float* hs = st + L.h;
      const int* prev = reinterpret_cast<const int*>(st) + L.prev;
      for (int b0 = 0; b0 < K; b0 += KC) {
        float ar[KC], az[KC], an[KC];
#pragma unroll
        for (int q = 0; q < KC; ++q) ar[q] = az[q] = an[q] = 0.0f;
        int row[KC];
#pragma unroll
        for (int q = 0; q < KC; ++q) row[q] = min(b0 + q, K - 1) * H;
#pragma unroll 2
        for (int k = 0; k < H; ++k) {
          const St* w = wh + k * H3 + j;
          const float wr = ld(w), wz = ld(w + H), wn = ld(w + 2 * H);
#pragma unroll
          for (int q = 0; q < KC; ++q) {
            const float hv = hs[row[q] + k];
            ar[q] = fmaf(hv, wr, ar[q]);
            az[q] = fmaf(hv, wz, az[q]);
            an[q] = fmaf(hv, wn, an[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < KC; ++q) {
          const int b = b0 + q;
          if (b < K) {
            const St* tt = tok_table + (size_t)prev[b] * H3;
            const float gir = rnd<St>(ldg(tt + j) + st[L.zcgi + j]);
            const float giz = rnd<St>(ldg(tt + H + j) + st[L.zcgi + H + j]);
            const float gin =
                rnd<St>(ldg(tt + 2 * H + j) + st[L.zcgi + 2 * H + j]);
            const float ghr = rnd<St>(ar[q] + ldg(bh + j));
            const float ghz = rnd<St>(az[q] + ldg(bh + H + j));
            const float ghn = rnd<St>(an[q] + ldg(bh + 2 * H + j));
            const float r = rnd<St>(sigmoid_(gir + ghr));
            const float z = rnd<St>(sigmoid_(giz + ghz));
            const float n = rnd<St>(tanhf(gin + rnd<St>(r * ghn)));
            st[L.hn + b * H + j] = blend<St>(z, n, hs[b * H + j]);
          }
        }
      }
    }
    __syncthreads();

    // ---- 2. output head: thread (s, v) -> logits[s, :, v] ---------------
    for (int p = tid; p < n_s * V; p += nt) {
      const int s = p / V, v = p - s * V;
      float* st = sent(s);
      const float* hn = st + L.hn;
      for (int b0 = 0; b0 < K; b0 += KC) {
        float acc[KC];
        int row[KC];
#pragma unroll
        for (int q = 0; q < KC; ++q) {
          acc[q] = 0.0f;
          row[q] = min(b0 + q, K - 1) * H;
        }
        for (int k = 0; k < H; ++k) {
          const float w = ld(wout + k * V + v);
#pragma unroll
          for (int q = 0; q < KC; ++q) acc[q] = fmaf(hn[row[q] + k], w, acc[q]);
        }
        const float bo = ldg(b_out + v);
#pragma unroll
        for (int q = 0; q < KC; ++q)
          if (b0 + q < K) st[L.cand + (b0 + q) * V + v] = rnd<St>(acc[q] + bo);
      }
    }
    __syncthreads();

    // ---- 3. one warp per sentence: log-softmax, candidates, top-K ------
    for (int s = warp; s < n_s; s += nwarps) {
      float* st = sent(s);
      int* sti = reinterpret_cast<int*>(st);
      float* cand = st + L.cand;
      int* mi = sti + L.misc;
      const int adv = mi[0];
      const int eos_top = mi[1];
      const int fin = mi[2];
      const bool done = eos_top && fin >= n_best;
      const bool eos_early = adv + 1 < min_length;
      const bool is_first = adv == 0;

      for (int b = 0; b < K; ++b) {
        float* row = cand + b * V;
        float m = -INFINITY;
        for (int v = lane; v < V; v += 32) m = fmaxf(m, row[v]);
        m = warp_max(m);
        float e = 0.0f;
        for (int v = lane; v < V; v += 32) e += expf(row[v] - m);
        const float lse = logf(warp_sum(e));
        const float score_b = st[L.scores + b];
        const bool eos_row = sti[L.prev + b] == EOS_IDX;
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

      // bookkeeping + tapes (done-gated; sc stays ungated)
      const int sg = s0 + s;
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
      if (lane == 0) {
        if (!done) {
          mi[0] = adv + 1;
          mi[1] = eos_top | (sti[L.nexty] == EOS_IDX);
          mi[2] = fin + n_fin;
        }
      }
      __syncwarp();
    }
    __syncthreads();

    // ---- 4. reorder the hidden state by backpointer (ungated) ----------
    for (int i = tid; i < n_s * K * H; i += nt) {
      const int s = i / (K * H), r = i - s * K * H;
      const int b = r / H, j = r - b * H;
      float* st = sent(s);
      const int src = reinterpret_cast<const int*>(st)[L.pk + b];
      st[L.h + r] = st[L.hn + src * H + j];
    }
    __syncthreads();
  }

  for (int i = tid; i < n_s * K; i += nt) {
    const int s = i / K, k = i - s * K;
    scores_out[(size_t)(s0 + s) * K + k] = sent(s)[L.scores + k];
  }
  for (int s = tid; s < n_s; s += nt) {
    const int* mi = reinterpret_cast<const int*>(sent(s)) + L.misc;
    adv_out[s0 + s] = mi[0];
    fin_out[s0 + s] = mi[2];
  }
}

struct Plan {
  int S, threads, weights_in_smem;
  size_t smem;
};

// Sentences per block and where the weights live, for this device.
template <typename T>
int make_plan(int B, int K, int V, int H, Plan* plan) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int max_smem = 0;
  e = cudaDeviceGetAttribute(&max_smem,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const size_t per_sent = (size_t)make_layout(K, V, H).words * 4;
  const size_t w_bytes = (size_t)weight_words<T>(H, V) * 4;
  const int s_threads = MAX_THREADS / H > 0 ? MAX_THREADS / H : 1;
  int S;
  if (w_bytes + per_sent <= (size_t)max_smem) {
    plan->weights_in_smem = 1;
    S = (int)(((size_t)max_smem - w_bytes) / per_sent);
  } else {
    plan->weights_in_smem = 0;
    S = (int)((size_t)max_smem / per_sent);
  }
  if (S < 1) return (int)cudaErrorInvalidConfiguration;
  S = S < s_threads ? S : s_threads;
  S = S < B ? S : (B > 0 ? B : 1);
  plan->S = S;
  int nt = ((S * H + 31) / 32) * 32;
  nt = nt < 64 ? 64 : (nt > MAX_THREADS ? MAX_THREADS : nt);
  plan->threads = nt;
  plan->smem = S * per_sent + (plan->weights_in_smem ? w_bytes : 0);
  return 0;
}

template <typename T>
int launch(const T* tok_table, const T* zc_gi, const T* wh, const T* bh,
           const T* w_out, const T* b_out, const T* zc0, int* ys, int* ptr,
           float* sc, float* scores, int* adv, int* fin, int B, int T_,
           int K, int V, int H, int min_length, int n_best, void* stream) {
  if (B <= 0) return 0;
  Plan p;
  int e = make_plan<T>(B, K, V, H, &p);
  if (e) return e;
  cudaError_t ce = cudaFuncSetAttribute(
      beam_gru_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)p.smem);
  if (ce != cudaSuccess) return (int)ce;
  const int grid = (B + p.S - 1) / p.S;
  beam_gru_kernel<T><<<grid, p.threads, p.smem, (cudaStream_t)stream>>>(
      tok_table, zc_gi, wh, bh, w_out, b_out, zc0, ys, ptr, sc, scores, adv,
      fin, B, T_, K, V, H, min_length, n_best, p.S, p.weights_in_smem);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch plan for these shapes: sentences per block, threads per
// block, weights in shared memory (1/0), dynamic shared bytes; bf16 != 0
// for the bf16 instantiation.
int beam_gru_plan(int B, int K, int V, int H, int bf16, int* out4) {
  Plan p;
  int e = bf16 ? make_plan<__nv_bfloat16>(B, K, V, H, &p)
               : make_plan<float>(B, K, V, H, &p);
  if (e) return e;
  out4[0] = p.S;
  out4[1] = p.threads;
  out4[2] = p.weights_in_smem;
  out4[3] = (int)p.smem;
  return 0;
}

// Launch the beam on `stream`; returns the CUDA error of the launch (0 on
// success). Does not synchronise and allocates nothing.
int beam_gru_f32(const float* tok_table, const float* zc_gi, const float* wh,
                 const float* bh, const float* w_out, const float* b_out,
                 const float* zc0, int* ys, int* ptr, float* sc,
                 float* scores, int* adv, int* fin, int B, int T, int K,
                 int V, int H, int min_length, int n_best, void* stream) {
  return launch<float>(tok_table, zc_gi, wh, bh, w_out, b_out, zc0, ys, ptr,
                       sc, scores, adv, fin, B, T, K, V, H, min_length,
                       n_best, stream);
}

// The same on bf16 inputs (tapes and scores as the f32 entry's).
int beam_gru_bf16(const __nv_bfloat16* tok_table, const __nv_bfloat16* zc_gi,
                  const __nv_bfloat16* wh, const __nv_bfloat16* bh,
                  const __nv_bfloat16* w_out, const __nv_bfloat16* b_out,
                  const __nv_bfloat16* zc0, int* ys, int* ptr, float* sc,
                  float* scores, int* adv, int* fin, int B, int T, int K,
                  int V, int H, int min_length, int n_best, void* stream) {
  return launch<__nv_bfloat16>(tok_table, zc_gi, wh, bh, w_out, b_out, zc0,
                               ys, ptr, sc, scores, adv, fin, B, T, K, V, H,
                               min_length, n_best, stream);
}

const char* beam_gru_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
