// WAE-MMD with the full kernel matrices on NVIDIA Hopper (sm_90a), fp32:
// the value and its gradient.
//
// Replaces the TPU kernel of controlled_peptide_generation_tpu/ops/
// pallas_kernels.py:mmd_full_pallas (_mmd_kernel), which computes
// losses.py:mmd_full_kernel for the gaussian kernel. These kernels compute
// it for the three forms of compute_mmd_kernel, phi of the squared distance
// d (form 0 gaussian exp(-d / s2), 1 laplace exp(-sqrt(d + s2)), 2 energy
// (d + s2)^-1/4, s2 = sigma^2):
//
//   S = (sum_ij H_ij - N sum_j H_jj) / (N (N - 1)),
//   H = K11 + K22 - 2 K12,   Kab_ij = phi(|za_i - zb_j|^2),
//
// the JAX package's quirk of subtracting diag(H) broadcast over rows, kept
// exactly; and the gradient (mmd_grad_kernel)
//
//   dS/dz1_a = 4 / (N (N - 1)) [ sum_j phi'(d11_aj) (z1_a - z1_j)
//                              - sum_j phi'(d12_aj) (z1_a - z2_j)
//                              + N phi'(d12_aa) (z1_a - z2_a) ].
//
// S is symmetric in (z1, z2), so dS/dz2 is the same kernel with the two
// arguments swapped.
//
// Distances are the difference form sum_d (x_d - y_d)^2 that the loss
// uses, not the Pallas kernel's expanded |x|^2 + |y|^2 - 2 x.y: it is
// exactly 0 on the diagonals, where the expanded form can go slightly
// negative.
//
// What bounds them on the H100: operations. Each of the N^2 pairs costs
// three distances of D subtractions and D FMAs in the value (9 N^2 D
// FLOP) and two distances plus two weighted differences per feature in the
// gradient (12 N^2 D FLOP), against 2 N D inputs read once; at the train
// step's N 32, D 100 either is a few microseconds of work, so there the
// launch and the dependent reduction steps are what is paid. The design
// keeps every reuse on chip: the value kernel stages a tile of rows of each
// argument per side in shared memory, DC feature columns per pass (any D),
// so each loaded value feeds a tile's row of pairs: 32 x 32 pairs a block,
// 4 a thread, in general; up to N 64, 16 x 16 pairs a block, one a thread,
// so the train step's N 32 runs on four SMs, not one (a block's serial
// pair work, not the launch, set the single 32 x 32 block's time). The
// gradient (mmd_grad_kernel) tiles the pairs: a block owns BA rows a (64
// from N 1,024 at D <= 128, else 16) and walks tiles of BA rows j, the
// next tile staged by cp.async (16 bytes where D % 4 == 0) while the
// current one is summed. Phase 1, a 16 x 16 thread grid forms each pair's
// two distances (T x T pairs a thread, a float4 of features a step);
// phase 2, every lane sums the weighted differences of its rows and 4
// features over the tile's j in f32, folded into fp64 once a tile. Small N
// spreads over SMs by splitting j over the ranks of a cluster (up to 8),
// whose fp64 partials are summed in rank order through distributed shared
// memory: N 32 runs on 16 SMs, not 4.
//
// Cancellation and order: the sum over N^2 terms of H cancels (the value is
// a small difference of O(1) sums), so each thread accumulates its pairs'
// H in fp64 and the block reduces in fp64 in a fixed tree. The value is one
// launch: where one block holds every pair (N <= 16) it writes the value;
// otherwise every block writes its partial, makes it visible
// (__threadfence) and counts itself done on a device-scope counter, and
// the block that counts last sums the partials in block-index order
// (thread t: blocks t, t + 256, ..., then the same tree) and rounds once
// to fp32. It then resets the counter, so the next launch needs no memset
// and a CUDA graph can replay the launch; the wrapper keeps one counter per
// device and stream, so two launches in flight never share one. Which
// block finishes last varies from run to run, not what it sums or in which
// order: the value's bits depend on N alone (the tiling is a function of
// N), not on the run, and no float is added atomically. The gradient's
// tiling and cluster split are functions of (N, D) alone and its sums of
// fixed order, so its bits depend on (N, D) alone too; its one launch
// needs no memset and no attribute call once set up.
//
// The earlier design summed the partials in a second launch; at the train
// step's N 32 that was two launch latencies for one 32 x 32 tile.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "device_cache.cuh"

namespace cg = cooperative_groups;

namespace {

// value: a block owns TL x TL pairs in TL x TY threads (TL / TY pairs
// each): 32 x 32 pairs (4 a thread) in general, 16 x 16 (one a thread) up
// to N 64, so a train-size batch spreads over several SMs
constexpr int THREADS = 256;        // value: threads a block, either tiling
constexpr int SMALL_N = 64;         // value: the largest N of the 16 x 16 tiles
constexpr int DC = 32;              // value: feature columns per staged pass
constexpr int FIN = THREADS;        // threads of the final reduction
constexpr int MAX_D = 256;          // gradient: the scope, D <= 256
// the tiled gradient (mmd_grad_kernel): BA rows a x BA rows j a tile
constexpr int GT = 256;             // threads: a 16 x 16 grid in phase 1
constexpr int G_BIG_N = 1024;       // from this N (and D <= 128) BA 64
constexpr int G_BIG_D = 128;
constexpr int G_MAX_CLUSTER = 8;    // ranks splitting j, the portable size
// blocks a launch aims at (about one per SM of an H100). A constant, not
// the card's SM count: the plan, and with it the bits, depend on (N, D)
// alone
constexpr int G_TARGET = 128;

__device__ __forceinline__ float phi(float d, float s2, int form) {
  if (form == 0) return expf(-d / s2);
  if (form == 1) return expf(-sqrtf(d + s2));
  return powf(d + s2, -0.25f);
}

// d phi / d d
__device__ __forceinline__ float dphi(float d, float s2, int form) {
  if (form == 0) return -expf(-d / s2) / s2;
  if (form == 1) {
    const float r = sqrtf(d + s2);
    return -expf(-r) / (2.f * r);
  }
  return -0.25f * powf(d + s2, -1.25f);
}

// The thread's index in the block, read anew (volatile: never merged
// with an earlier read). The last block's reduction tree takes it, so it
// computes its own predicates: merged with the first tree's, one of them
// (tid < 128) lived in local memory across the slow-path call of the
// value's double division (ptxas: 4 bytes spill stores and loads in
// mmd_fwd_kernel<16, 16>).
__device__ __forceinline__ int fresh_tid(int TL) {
  int x, y;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(x));
  asm volatile("mov.u32 %0, %%tid.y;" : "=r"(y));
  return y * TL + x;
}

__device__ __forceinline__ float mmd_value(double all, double diag, int N) {
  const double n = (double)N;
  return (float)((all - n * diag) / (n * (n - 1.0)));
}

// One block per TL x TL pairs (i of the rows, j of the columns): the
// block's (sum of H, sum of H on the diagonal i == j) in fp64 go to part,
// and the last block to finish (count) sums every block's into out[0].
template <int TL, int TY>
__global__ void __launch_bounds__(THREADS)
mmd_fwd_kernel(const float* __restrict__ z1, const float* __restrict__ z2,
               int N, int D, float s2, int form, double* __restrict__ part,
               unsigned int* __restrict__ count, float* __restrict__ out) {
  static_assert(TL * TY == THREADS, "one block size for both tilings");
  constexpr int PER = TL / TY;         // pairs per thread
  constexpr int LD = TL * DC / THREADS;   // staged values per thread, array
  __shared__ float a1[TL][DC + 1], a2[TL][DC + 1];   // rows i
  __shared__ float b1[TL][DC + 1], b2[TL][DC + 1];   // rows j
  __shared__ double red[2][THREADS];
  __shared__ bool last;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TL + tx;
  const int i0 = blockIdx.y * TL, j0 = blockIdx.x * TL;
  // pair p of this thread: (i0 + ty + TY p, j0 + tx)
  float d11[PER], d22[PER], d12[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) d11[p] = d22[p] = d12[p] = 0.f;
  for (int c0 = 0; c0 < D; c0 += DC) {
    // DC feature columns of the tile's rows: a thread's LD loads of each
    // array are issued together, then stored
    float v[4][LD];
#pragma unroll
    for (int u = 0; u < LD; ++u) {
      const int e = tid + u * THREADS;
      const int r = e / DC, d = c0 + e - r * DC;
      const bool iok = d < D && i0 + r < N, jok = d < D && j0 + r < N;
      const size_t ia = (size_t)(i0 + r) * D + d;
      const size_t ja = (size_t)(j0 + r) * D + d;
      v[0][u] = iok ? z1[ia] : 0.f;
      v[1][u] = iok ? z2[ia] : 0.f;
      v[2][u] = jok ? z1[ja] : 0.f;
      v[3][u] = jok ? z2[ja] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < LD; ++u) {
      const int e = tid + u * THREADS;
      const int r = e / DC, c = e - r * DC;
      a1[r][c] = v[0][u];
      a2[r][c] = v[1][u];
      b1[r][c] = v[2][u];
      b2[r][c] = v[3][u];
    }
    __syncthreads();
    const int nc = min(DC, D - c0);
    for (int c = 0; c < nc; ++c) {
      const float y1 = b1[tx][c], y2 = b2[tx][c];
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const float x1 = a1[ty + TY * p][c], x2 = a2[ty + TY * p][c];
        float e = x1 - y1;
        d11[p] = fmaf(e, e, d11[p]);
        e = x2 - y2;
        d22[p] = fmaf(e, e, d22[p]);
        e = x1 - y2;
        d12[p] = fmaf(e, e, d12[p]);
      }
    }
    __syncthreads();
  }
  double s_all = 0.0, s_diag = 0.0;
  const int j = j0 + tx;
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int i = i0 + ty + TY * p;
    if (i < N && j < N) {
      const float h = (phi(d11[p], s2, form) + phi(d22[p], s2, form))
                      - 2.f * phi(d12[p], s2, form);
      s_all += (double)h;
      if (i == j) s_diag += (double)h;
    }
  }
  red[0][tid] = s_all;
  red[1][tid] = s_diag;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) {
      red[0][tid] += red[0][tid + s];
      red[1][tid] += red[1][tid + s];
    }
    __syncthreads();
  }
  const int nblocks = gridDim.x * gridDim.y;
  if (nblocks == 1) {
    if (tid == 0) out[0] = mmd_value(red[0][0], red[1][0], N);
    return;
  }
  if (tid == 0) {
    const size_t b = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    part[2 * b] = red[0][0];
    part[2 * b + 1] = red[1][0];
    __threadfence();                    // the partial, before the count
    last = atomicAdd(count, 1u) == (unsigned)(nblocks - 1);
  }
  __syncthreads();
  if (!last) return;
  // the last block: every partial is written and fenced; read them past
  // this SM's L1 (__ldcg), in block-index order per thread, then the tree
  __threadfence();
  const int ft = fresh_tid(TL);
  double a = 0.0, d = 0.0;
  for (int b = ft; b < nblocks; b += FIN) {
    a += __ldcg(part + 2 * b);
    d += __ldcg(part + 2 * b + 1);
  }
  red[0][ft] = a;
  red[1][ft] = d;
  __syncthreads();
  for (int s = FIN / 2; s > 0; s >>= 1) {
    if (ft < s) {
      red[0][ft] += red[0][ft + s];
      red[1][ft] += red[1][ft + s];
    }
    __syncthreads();
  }
  if (ft == 0) {
    out[0] = mmd_value(red[0][0], red[1][0], N);
    *count = 0u;                        // ready for the next launch
  }
}

// ---- the tiled gradient --------------------------------------------------

// features padded to a float4; the row pitch of the staged tiles, a
// multiple of 4 floats that is 4 mod 32 words, so the float4 loads of 8
// lanes on 8 consecutive rows fall in 8 distinct bank groups
__host__ __device__ inline int feat_pad(int D) { return (D + 3) & ~3; }
__host__ __device__ inline int tile_pitch(int D) {
  const int p = feat_pad(D);
  return p + (36 - p % 32) % 32;
}

// dynamic shared bytes of mmd_grad_kernel<BA> at D: the block's rows a,
// two stages of (x_j, y_j) tiles, the two weight tiles
size_t grad_smem_bytes(int BA, int D) {
  const size_t S = (size_t)tile_pitch(D);
  return (5 * BA * S + 2 * (size_t)BA * (BA + 4)) * sizeof(float);
}

__device__ __forceinline__ void cp_async_f(float* dst, const float* src,
                                           bool vec, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (vec)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 4 : 0));
}

// gx[a] = gout * dS/dx_a for the BA rows a of tile blockIdx.y, the rows j
// split over the ranks of the cluster (rank blockIdx.x takes j in [rank
// j_per, (rank + 1) j_per)). Per j-tile of BA rows, staged by cp.async a
// tile ahead (vec: 16-byte copies, D % 4 == 0 and 16-byte aligned
// inputs; else 4-byte ones): phase 1, thread (ag, jg) of a 16 x 16 grid
// forms the distances |x_a - x_j|^2 and |x_a - y_j|^2 of its T x T pairs
// (rows a ag + 16 i, rows j jg + 16 k), in the difference form, a float4
// of features a step, and stores their weights phi'; phase 2, item q (of
// 8 x ceil(D / 4)) sums w11 (x_a - x_j) - w12 (x_a - y_j) over the tile's
// j for its T2 rows and 4 features in f32, and folds the tile's sums into
// its fp64 accumulators. The diagonal term N phi'(|x_a - y_a|^2) (x_a -
// y_a) rides in the sums: the rank whose rows j hold j == a weighs that
// cross pair by phi' (1 - N) in place of phi'. At the end the ranks' fp64
// partials are summed in rank order through distributed shared memory and
// scaled once (at N 1 that is 0 / 0 = NaN, as the plain expression
// gives).
template <int BA>
__global__ void __launch_bounds__(GT, 1)
mmd_grad_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ gout, int N, int D, float s2,
                int form, int j_per, int vec, float* __restrict__ gx) {
  constexpr int BJ = BA;
  constexpr int T = BA / 16;         // phase 1: rows a and rows j a thread
  constexpr int T2 = BA / 8;         // phase 2: rows of an item
  constexpr int MAXI = BA == 16 ? 2 : 1;   // items a thread: 8 x D/4
  constexpr int WP = BA + 4;         // pitch of the weight tiles
  extern __shared__ __align__(16) float gsm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int C = (int)cluster.num_blocks();
  const int S = tile_pitch(D), Dp = feat_pad(D), DG = Dp / 4;
  float* const xa = gsm;                      // [BA][S]
  float* const stg = xa + BA * S;             // [2][x_j, y_j][BJ][S]
  float* const w11 = stg + 4 * BJ * S;        // [BJ][WP]
  float* const w12 = w11 + BJ * WP;
  const int tid = threadIdx.x;
  const int a0 = blockIdx.y * BA;
  const int j_begin = min(N, rank * j_per);
  const int j_end = min(N, j_begin + j_per);
  const int ntiles = (j_end - j_begin + BJ - 1) / BJ;
  // rows r0 .. r0+BA-1 of src [N, D] into dst [BA][S], rows from r_end on
  // and features D .. Dp-1 zeros
  auto copy_rows = [&](float* dst, const float* src, int r0, int r_end) {
    const int V = vec ? 4 : 1, DV = Dp / V;
#pragma unroll 1
    for (int e = tid; e < BA * DV; e += GT) {
      const int r = e / DV, c = V * (e - r * DV);
      if (c < D) {
        const bool ok = r0 + r < r_end;
        cp_async_f(dst + r * S + c,
                   ok ? src + (size_t)(r0 + r) * D + c : src, vec, ok);
      } else {
        dst[r * S + c] = 0.f;
      }
    }
  };
  copy_rows(xa, x, a0, N);
  if (ntiles > 0) {
    copy_rows(stg, x, j_begin, j_end);
    copy_rows(stg + BJ * S, y, j_begin, j_end);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  const int ag = tid / 16, jg = tid % 16;
  double acc64[MAXI][T2][4];
#pragma unroll
  for (int u = 0; u < MAXI; ++u)
#pragma unroll
    for (int r = 0; r < T2; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc64[u][r][c] = 0.0;
  for (int t = 0; t < ntiles; ++t) {
    const int j0 = j_begin + t * BJ;
    const int nj = min(BJ, j_end - j0);
    const float* xj = stg + (t % 2) * 2 * BJ * S;
    const float* yj = xj + BJ * S;
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();          // tile t in; tile t-1's phase 2 done
    if (t + 1 < ntiles) {
      float* nx = stg + ((t + 1) % 2) * 2 * BJ * S;
      copy_rows(nx, x, j0 + BJ, j_end);
      copy_rows(nx + BJ * S, y, j0 + BJ, j_end);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    // phase 1: the distances of T x T pairs, then their weights
    {
      float d11[T][T], d12[T][T];
#pragma unroll
      for (int i = 0; i < T; ++i)
#pragma unroll
        for (int k = 0; k < T; ++k) d11[i][k] = d12[i][k] = 0.f;
      for (int c = 0; c < Dp; c += 4) {
        float4 va[T], vx[T], vy[T];
#pragma unroll
        for (int i = 0; i < T; ++i)
          va[i] = *reinterpret_cast<const float4*>(xa + (ag + 16 * i) * S + c);
#pragma unroll
        for (int k = 0; k < T; ++k) {
          vx[k] = *reinterpret_cast<const float4*>(xj + (jg + 16 * k) * S + c);
          vy[k] = *reinterpret_cast<const float4*>(yj + (jg + 16 * k) * S + c);
        }
#pragma unroll
        for (int i = 0; i < T; ++i)
#pragma unroll
          for (int k = 0; k < T; ++k) {
            float e = va[i].x - vx[k].x;
            d11[i][k] = fmaf(e, e, d11[i][k]);
            e = va[i].y - vx[k].y;
            d11[i][k] = fmaf(e, e, d11[i][k]);
            e = va[i].z - vx[k].z;
            d11[i][k] = fmaf(e, e, d11[i][k]);
            e = va[i].w - vx[k].w;
            d11[i][k] = fmaf(e, e, d11[i][k]);
            e = va[i].x - vy[k].x;
            d12[i][k] = fmaf(e, e, d12[i][k]);
            e = va[i].y - vy[k].y;
            d12[i][k] = fmaf(e, e, d12[i][k]);
            e = va[i].z - vy[k].z;
            d12[i][k] = fmaf(e, e, d12[i][k]);
            e = va[i].w - vy[k].w;
            d12[i][k] = fmaf(e, e, d12[i][k]);
          }
      }
#pragma unroll
      for (int k = 0; k < T; ++k) {
        const int jl = jg + 16 * k;
        const bool ok = jl < nj;             // rows past j_end weigh 0
#pragma unroll
        for (int i = 0; i < T; ++i) {
          const int al = ag + 16 * i;
          const float v12 = dphi(d12[i][k], s2, form);
          w11[jl * WP + al] = ok ? dphi(d11[i][k], s2, form) : 0.f;
          w12[jl * WP + al] =
              !ok ? 0.f : a0 + al == j0 + jl ? v12 * (float)(1 - N) : v12;
        }
      }
    }
    __syncthreads();          // the weights in shared memory
    // phase 2: the weighted differences of each item, in f32 over the
    // tile's j, folded into fp64 once a tile
#pragma unroll
    for (int u = 0; u < MAXI; ++u) {
      const int q = tid + GT * u;
      if (q < 8 * DG) {
        const int r0 = (q / DG) * T2, c0 = 4 * (q % DG);
        float4 xv[T2];
        float acc[T2][4];
#pragma unroll
        for (int r = 0; r < T2; ++r) {
          xv[r] = *reinterpret_cast<const float4*>(xa + (r0 + r) * S + c0);
          acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
        }
        for (int j = 0; j < nj; ++j) {
          float a11[T2], a12[T2];
#pragma unroll
          for (int r = 0; r < T2; r += 2) {
            const float2 p = *reinterpret_cast<const float2*>(
                w11 + j * WP + r0 + r);
            const float2 q2 = *reinterpret_cast<const float2*>(
                w12 + j * WP + r0 + r);
            a11[r] = p.x;
            a11[r + 1] = p.y;
            a12[r] = q2.x;
            a12[r + 1] = q2.y;
          }
          const float4 vx = *reinterpret_cast<const float4*>(xj + j * S + c0);
          const float4 vy = *reinterpret_cast<const float4*>(yj + j * S + c0);
          const float cx[4] = {vx.x, vx.y, vx.z, vx.w};
          const float cy[4] = {vy.x, vy.y, vy.z, vy.w};
#pragma unroll
          for (int r = 0; r < T2; ++r) {
            const float xr[4] = {xv[r].x, xv[r].y, xv[r].z, xv[r].w};
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              acc[r][c] = fmaf(a11[r], xr[c] - cx[c], acc[r][c]);
              acc[r][c] = fmaf(-a12[r], xr[c] - cy[c], acc[r][c]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < T2; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc64[u][r][c] += (double)acc[r][c];
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();            // every tile read: the stages hold partials
  double* const part = reinterpret_cast<double*>(stg);   // [BA][Dp]
#pragma unroll
  for (int u = 0; u < MAXI; ++u) {
    const int q = tid + GT * u;
    if (q < 8 * DG) {
      const int r0 = (q / DG) * T2, c0 = 4 * (q % DG);
#pragma unroll
      for (int r = 0; r < T2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[(r0 + r) * Dp + c0 + c] = acc64[u][r][c];
    }
  }
  cluster.sync();             // every rank's partial written
  // this rank's share of the entries, summed over ranks 0..C-1 in order
  // (all C loads issued first)
  const double n = (double)N;
  const double scale = 4.0 * (double)gout[0] / (n * (n - 1.0));
  const int total = BA * Dp;
  const int per = (total + C - 1) / C;
  const int e_end = min(total, (rank + 1) * per);
#pragma unroll 1
  for (int e = rank * per + tid; e < e_end; e += GT) {
    const int r = e / Dp, c = e - r * Dp;
    const int a = a0 + r;
    if (c >= D || a >= N) continue;
    double v[G_MAX_CLUSTER];
#pragma unroll
    for (int q = 0; q < G_MAX_CLUSTER; ++q)
      if (q < C) v[q] = cluster.map_shared_rank(part, q)[e];
    double sum = v[0];
#pragma unroll
    for (int q = 1; q < G_MAX_CLUSTER; ++q)
      if (q < C) sum += v[q];
    gx[(size_t)a * D + c] = (float)(scale * sum);
  }
  cluster.sync();             // partials read: blocks may exit
}

struct GradPlan {
  int ba;        // rows a (and j) of a tile: 16 or 64
  int a_tiles;   // tiles of rows a, along y
  int cluster;   // C: ranks splitting j, along x
  int j_per;     // rows j of a rank
};

// By N and D alone: BA 64 from N 1,024 at D <= 128 (the shared tiles of
// BA 64 hold D 128 at most), else 16; then as many ranks per tile of rows
// a as bring the blocks to about G_TARGET, at most 8 and at most N.
void make_grad_plan(int N, int D, GradPlan* p) {
  p->ba = N >= G_BIG_N && D <= G_BIG_D ? 64 : 16;
  p->a_tiles = (N + p->ba - 1) / p->ba;
  int c = (G_TARGET + p->a_tiles - 1) / p->a_tiles;
  c = c > G_MAX_CLUSTER ? G_MAX_CLUSTER : c;
  c = c > N ? N : c;
  p->j_per = (N + c - 1) / c;
  p->cluster = (N + p->j_per - 1) / p->j_per;
}

// The gradient kernels' shared-memory reservations, for the largest D each
// takes, set once per device (an attribute of the kernel on the current
// device; a launch may use less).
cudaError_t bwd_setup() {
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  const int de = current_device(&dev);
  if (de) return (cudaError_t)de;
  if (done[dev]) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      mmd_grad_kernel<16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)grad_smem_bytes(16, MAX_D));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(mmd_grad_kernel<64>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)grad_smem_bytes(64, G_BIG_D));
  done[dev] = e == cudaSuccess;
  return e;
}

// N 1 is in scope: the value and the gradient divide 0 by N (N - 1) = 0
// and give NaN, as the plain expression does (a batch of one row).
int check_shape(int N, int D) {
  if (N < 1 || D < 1) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

// Number of partial blocks of the value for N rows: the caller allocates
// 2 * blocks doubles of scratch.
int mmd_full_blocks(int N) {
  const int tl = N <= SMALL_N ? 16 : 32;
  const int t = (N + tl - 1) / tl;
  return t * t;
}

int mmd_full_max_d() { return MAX_D; }

// out [1] = S for z1, z2 [N, D] (row-major fp32), s2 = sigma^2, form 0/1/2;
// part: 2 * mmd_full_blocks(N) doubles of scratch; count: one unsigned
// int, zero before the launch and zero again after it, used by no other
// launch in flight (one per device and stream). One launch on `stream`.
int mmd_full_fwd_f32(const float* z1, const float* z2, double* part,
                     unsigned int* count, float* out, int N, int D, float s2,
                     int form, void* stream) {
  int e = check_shape(N, D);
  if (e) return e;
  if (form < 0 || form > 2) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (N <= SMALL_N) {
    const int t = (N + 15) / 16;
    mmd_fwd_kernel<16, 16><<<dim3(t, t), dim3(16, 16), 0, s>>>(
        z1, z2, N, D, s2, form, part, count, out);
  } else {
    const int t = (N + 31) / 32;
    mmd_fwd_kernel<32, 8><<<dim3(t, t), dim3(32, 8), 0, s>>>(
        z1, z2, N, D, s2, form, part, count, out);
  }
  return (int)cudaGetLastError();
}

// gx [N, D] = gout[0] * dS/dx for x, y [N, D] (S symmetric: pass (z1, z2)
// for z1's gradient and (z2, z1) for z2's); D <= mmd_full_max_d(). One
// cluster launch of mmd_grad_kernel (mmd_full_grad_plan).
int mmd_full_bwd_f32(const float* x, const float* y, const float* gout,
                     float* gx, int N, int D, float s2, int form,
                     void* stream) {
  int e = check_shape(N, D);
  if (e) return e;
  if (D > MAX_D || form < 0 || form > 2) return (int)cudaErrorInvalidValue;
  cudaError_t ce = bwd_setup();
  if (ce != cudaSuccess) return (int)ce;
  GradPlan p;
  make_grad_plan(N, D, &p);
  const int vec = D % 4 == 0 && ((reinterpret_cast<size_t>(x)
                                  | reinterpret_cast<size_t>(y)) & 15) == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, p.a_tiles, 1);
  cfg.blockDim = dim3(GT, 1, 1);
  cfg.dynamicSmemBytes = grad_smem_bytes(p.ba, D);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  ce = p.ba == 64
           ? cudaLaunchKernelEx(&cfg, mmd_grad_kernel<64>, x, y, gout, N, D,
                                s2, form, p.j_per, vec, gx)
           : cudaLaunchKernelEx(&cfg, mmd_grad_kernel<16>, x, y, gout, N, D,
                                s2, form, p.j_per, vec, gx);
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}

// The gradient's plan for N rows of D features. out4: rows a (and j) of a
// tile, tiles of rows a, ranks splitting j (the cluster), rows j a rank.
int mmd_full_grad_plan(int N, int D, int* out4) {
  int e = check_shape(N, D);
  if (e) return e;
  GradPlan p;
  make_grad_plan(N, D, &p);
  out4[0] = p.ba;
  out4[1] = p.a_tiles;
  out4[2] = p.cluster;
  out4[3] = p.j_per;
  return 0;
}

const char* mmd_full_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
