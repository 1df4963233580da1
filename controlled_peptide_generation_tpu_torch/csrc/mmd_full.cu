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
// exactly; and the gradient (mmd_bwd_kernel)
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
// gradient kernel keeps BR rows of the differentiated argument and a
// BJ-row tile of both arguments in shared memory, one thread per feature
// column for the weighted sums.
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
// N), not on the run, and no float is added atomically. The gradient's weighted sums run in fp64 FMAs,
// sequential in j.
//
// The earlier design summed the partials in a second launch; at the train
// step's N 32 that was two launch latencies for one 32 x 32 tile.

#include <cuda_runtime.h>
#include <math.h>

#include "device_cache.cuh"

namespace {

// value: a block owns TL x TL pairs in TL x TY threads (TL / TY pairs
// each): 32 x 32 pairs (4 a thread) in general, 16 x 16 (one a thread) up
// to N 64, so a train-size batch spreads over several SMs
constexpr int THREADS = 256;        // value: threads a block, either tiling
constexpr int SMALL_N = 64;         // value: the largest N of the 16 x 16 tiles
constexpr int DC = 32;              // value: feature columns per staged pass
constexpr int FIN = THREADS;        // threads of the final reduction
constexpr int BR = 8;               // gradient: rows a per block
constexpr int BJ = 32;              // gradient: rows j per pass
constexpr int BT = BR * BJ;         // gradient: threads (one pair each)
constexpr int MAX_D = BT;           // gradient: one thread per feature column

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
  double a = 0.0, d = 0.0;
  for (int b = tid; b < nblocks; b += FIN) {
    a += __ldcg(part + 2 * b);
    d += __ldcg(part + 2 * b + 1);
  }
  red[0][tid] = a;
  red[1][tid] = d;
  __syncthreads();
  for (int s = FIN / 2; s > 0; s >>= 1) {
    if (tid < s) {
      red[0][tid] += red[0][tid + s];
      red[1][tid] += red[1][tid + s];
    }
    __syncthreads();
  }
  if (tid == 0) {
    out[0] = mmd_value(red[0][0], red[1][0], N);
    *count = 0u;                        // ready for the next launch
  }
}

__host__ __device__ inline int row_ld(int D) { return D | 1; }

size_t bwd_smem_bytes(int D) {
  const size_t ld = (size_t)row_ld(D);
  return ((size_t)(2 * BR + 2 * BJ) * ld + BR) * sizeof(float)
         + (size_t)2 * BR * BJ * sizeof(double);
}

// gx[a] = gout * dS/dx_a for the rows a of this block (x the argument
// differentiated, y the other one). Phase 1: thread (r, c) computes the
// weights phi'(|x_a - x_j|^2) and phi'(|x_a - y_j|^2) of row a = a0 + r
// and j = j0 + c; phase 2: thread d sums w (x_a[d] - x_j[d]) - w' (x_a[d] -
// y_j[d]) over the tile's j for every row of the block.
__global__ void __launch_bounds__(BT)
mmd_bwd_kernel(const float* __restrict__ x, const float* __restrict__ y,
               const float* __restrict__ gout, int N, int D, float s2,
               int form, float* __restrict__ gx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* w11 = reinterpret_cast<double*>(smem_raw);        // [BR][BJ]
  double* w12 = w11 + BR * BJ;                               // [BR][BJ]
  float* xa = reinterpret_cast<float*>(w12 + BR * BJ);       // [BR][ld]
  const int ld = row_ld(D);
  float* ya = xa + BR * ld;                                  // [BR][ld]
  float* xj = ya + BR * ld;                                  // [BJ][ld]
  float* yj = xj + BJ * ld;                                  // [BJ][ld]
  float* wdiag = yj + BJ * ld;                               // [BR]
  const int tid = threadIdx.x;
  const int a0 = blockIdx.x * BR;
  for (int e = tid; e < BR * D; e += BT) {
    const int r = e / D, d = e - r * D;
    const bool ok = a0 + r < N;
    xa[r * ld + d] = ok ? x[(size_t)(a0 + r) * D + d] : 0.f;
    ya[r * ld + d] = ok ? y[(size_t)(a0 + r) * D + d] : 0.f;
  }
  if (tid < BR) wdiag[tid] = 0.f;
  double acc[BR];
  float xr[BR];
#pragma unroll
  for (int r = 0; r < BR; ++r) acc[r] = 0.0;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < BR; ++r) xr[r] = tid < D ? xa[r * ld + tid] : 0.f;
  const int pr = tid / BJ, pc = tid - pr * BJ;   // this thread's pair
  for (int j0 = 0; j0 < N; j0 += BJ) {
    for (int e = tid; e < BJ * D; e += BT) {
      const int r = e / D, d = e - r * D;
      const bool ok = j0 + r < N;
      xj[r * ld + d] = ok ? x[(size_t)(j0 + r) * D + d] : 0.f;
      yj[r * ld + d] = ok ? y[(size_t)(j0 + r) * D + d] : 0.f;
    }
    __syncthreads();
    {
      const float* p = xa + pr * ld;
      const float* q1 = xj + pc * ld;
      const float* q2 = yj + pc * ld;
      float d11 = 0.f, d12 = 0.f;
      for (int d = 0; d < D; ++d) {
        float e = p[d] - q1[d];
        d11 = fmaf(e, e, d11);
        e = p[d] - q2[d];
        d12 = fmaf(e, e, d12);
      }
      const bool ok = a0 + pr < N && j0 + pc < N;
      const float v12 = dphi(d12, s2, form);
      w11[pr * BJ + pc] = ok ? (double)dphi(d11, s2, form) : 0.0;
      w12[pr * BJ + pc] = ok ? (double)v12 : 0.0;
      if (ok && a0 + pr == j0 + pc) wdiag[pr] = v12;
    }
    __syncthreads();
    if (tid < D) {
      const int nj = min(BJ, N - j0);
      for (int c = 0; c < nj; ++c) {
        const float vx = xj[c * ld + tid], vy = yj[c * ld + tid];
#pragma unroll
        for (int r = 0; r < BR; ++r) {
          acc[r] = fma(w11[r * BJ + c], (double)(xr[r] - vx), acc[r]);
          acc[r] = fma(-w12[r * BJ + c], (double)(xr[r] - vy), acc[r]);
        }
      }
    }
    __syncthreads();
  }
  if (tid < D) {
    const double n = (double)N;
    const double scale = 4.0 * (double)gout[0] / (n * (n - 1.0));
#pragma unroll
    for (int r = 0; r < BR; ++r) {
      if (a0 + r < N) {
        const double diag = n * (double)wdiag[r]
                            * (double)(xr[r] - ya[r * ld + tid]);
        gx[(size_t)(a0 + r) * D + tid] = (float)(scale * (acc[r] + diag));
      }
    }
  }
}

// The gradient kernel's shared-memory reservation, for the scope's largest
// D, set once per device (an attribute of the kernel on the current
// device; a launch may use less).
cudaError_t bwd_setup() {
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  const int de = current_device(&dev);
  if (de) return (cudaError_t)de;
  if (done[dev]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      mmd_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bwd_smem_bytes(MAX_D));
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
// for z1's gradient and (z2, z1) for z2's); D <= mmd_full_max_d().
int mmd_full_bwd_f32(const float* x, const float* y, const float* gout,
                     float* gx, int N, int D, float s2, int form,
                     void* stream) {
  int e = check_shape(N, D);
  if (e) return e;
  if (D > MAX_D || form < 0 || form > 2) return (int)cudaErrorInvalidValue;
  cudaError_t ce = bwd_setup();
  if (ce != cudaSuccess) return (int)ce;
  mmd_bwd_kernel<<<(N + BR - 1) / BR, BT, bwd_smem_bytes(D),
                   (cudaStream_t)stream>>>(x, y, gout, N, D, s2, form, gx);
  return (int)cudaGetLastError();
}

const char* mmd_full_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
