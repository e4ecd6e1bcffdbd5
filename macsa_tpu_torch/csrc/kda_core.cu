// The chunked KDA (Kimi Delta Attention) core, forward and backward, for
// Hopper (sm_90a), through `ops/kda.py` `KDACore` on CUDA tensors.
//
// Replaces no TPU kernel: the JAX package has no KDA.  It exists because the
// plain chunked core (`kda.chunk_kda`) spends a Kimi-Linear train step in f32
// elementwise passes: its pairwise decays as tensors 4x the size of q, a loop
// of small products over the chunks, and autograd's backward through all of
// it, paid for the forward, the backward's recomputation and autograd.
//
// The arithmetic is `kda.subchunk_kda`'s and `kda.chunk_kda_backward`'s, their
// plain versions: per head, q and k l2-normalized (q also times d^-1/2),
// chunks of BT = 64 positions; G the running sum of the log decays g <= 0
// from the chunk's start; A_qk[i, j] = sum_d q_i k_j exp(G_i - G_j) (j <= i)
// and A_kk (j < i); (I + diag(beta) A_kk) [W | U'] = diag(beta) [exp(G) k | v];
// then over the chunks in order from S = 0
//     U = U' - W S;  O = exp(G) q S + A_qk U;  S <- exp(G_last) S + (exp(G_last - G) k)^T U.
// The pairwise decays are never split as exp(G_i) exp(-G_j), which overflows:
// a sub-chunk of BC = 16 positions takes its own 16 x 16 block pair by pair,
// and the block of its rows i and the earlier columns j is the product of
// x_i exp(G_i - G_r) and k_j exp(G_r - G_j), r the sub-chunk's first row, both
// factors at most 1.  That is exact for any finite g <= 0.
//
// Every product is f32 on the CUDA cores (FFMA, f32 sums); the decays, the
// running sums, the state and the triangular solves are f32 too.  Nothing is
// computed in bf16 or TF32.
//
// What bounds it: at the Kimi-Linear cell's shape (48 x 170 positions, 32
// heads of 128) the forward reads q, k, v in bf16 and g, beta in f32 and
// writes o, 401 MB (0.120 ms at 3.35 TB/s); its 48.3 GFLOP take 0.72 ms at
// the CUDA cores' 67 TFLOP/s, so the operations bound it.  The design keeps
// every product a register-tiled FFMA loop over operands in shared memory and
// spreads a call over many blocks; the f32 intermediates pass through device
// scratch (the forward 0.83 GB, the backward 2.9 GB at the cell's shape),
// whose traffic is a small share of the time.  PERF.md section 6 has the
// times.
//
// Kernels (a forward call launches the first two; a backward call the first,
// the second keeping the state entering each chunk and U, then the rest):
//   kda_chunk_kernel       one block a chunk and head: the l2 norms, G, A_qk,
//                          A_kk (two passes of DH key channels), the solve by
//                          forward substitution, a column a thread: W, U',
//                          exp(G) q, exp(G_last - G) k.
//   kda_walk_kernel        one block a head and BV value columns: the chunks in
//                          order with that slice of S in shared memory: O, or
//                          the state entering each chunk and U.
//   kda_bwd_walk_kernel    the chunks in reverse with dS, the gradient of the
//                          state leaving a chunk: dU = A_qk^T dO + Kd dS,
//                          dS <- Qg^T dO + exp(G_last) dS - W^T dU.
//   kda_bwd_state_kernel   a chunk and BK key channels: the state products'
//                          gradients (dO S^T, U dS^T, -dU S^T), dA_qk = dO U^T.
//   kda_bwd_solve_kernel   a chunk: the solve's gradients by back substitution,
//                          dv, dbeta, dA_kk.
//   kda_bwd_pairs_kernel   a chunk: the pairwise decays' gradients in their
//                          sub-chunk form, dg (the reverse running sum of dG
//                          over the chunk), dq and dk through the l2 norms.
// Scratch rows are [B*H, N*BT, .] (N chunks a sequence); states are
// [B*H, N, D, D], key channel by value column.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 128;      // head width
constexpr int BT = 64;      // positions a chunk
constexpr int BC = 16;      // positions a sub-chunk
constexpr int NSUB = BT / BC;
constexpr int DH = 64;      // key channels a pass of the pairwise products
constexpr int BV = 32;      // value columns a block of the walks
constexpr int BK = 32;      // key channels a block of the state's gradients
constexpr int KT = 32;      // rows of a staged tile of a product's left operand
constexpr int P = 1;        // padding of a shared row: consecutive rows on other banks
constexpr int RH = DH + P;  // shared row strides
constexpr int RD = D + P;
constexpr int RV = BV + P;
constexpr int RT = BT + P;
constexpr int RB = 2 * D + P;

// `bf16` is a kernel's template parameter at every call: the branch folds away
__device__ __forceinline__ float ld(const void* p, long long i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st(void* p, long long i, float x, int bf16) {
  if (bf16) static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
  else static_cast<float*>(p)[i] = x;
}

// offset of x[b, t, h, 0] in a [B, L, H, D] tensor
__device__ __forceinline__ long long pos(int b, int t, int h, int L, int H) {
  return ((static_cast<long long>(b) * L + t) * H + h) * D;
}

// acc[i][j] += sum_{k < K} A(ty + i TY, k) B(k, tx + j TX), where
// A(m, k) = A[m am + k ak] and B(k, n) = B[k bk + n bn], both in shared memory.
template <int TM, int TN, int TY, int TX>
__device__ __forceinline__ void mac(float (&acc)[TM][TN], const float* A, int am, int ak,
                                    const float* B, int bk, int bn, int K, int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = A[(ty + i * TY) * am + k * ak];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = B[k * bk + (tx + j * TX) * bn];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// The same with A(m, k) = A[m am + k ak] (m < TM TY) in device memory, staged
// KT columns at a time into sA (k-major, row stride TM TY + P).  Every thread
// of the block takes part; it synchronizes before each tile.
template <int TM, int TN, int TY, int TX>
__device__ void mac_staged(float (&acc)[TM][TN], float* sA, const float* A, int am, int ak,
                           const float* B, int bk, int bn, int K, int tid, int ty, int tx) {
  constexpr int M = TM * TY, NT = TY * TX;
  for (int k0 = 0; k0 < K; k0 += KT) {
    __syncthreads();
#pragma unroll
    for (int e = tid; e < M * KT; e += NT) {
      int m, k;
      if (ak == 1) {  // consecutive threads along k: coalesced reads
        m = e / KT;
        k = e % KT;
      } else {
        k = e / M;
        m = e % M;
      }
      sA[k * (M + P) + m] = A[static_cast<long long>(m) * am + static_cast<long long>(k0 + k) * ak];
    }
    __syncthreads();
    mac<TM, TN, TY, TX>(acc, sA, 1, M + P, B + k0 * bk, bk, bn, KT, ty, tx);
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// index of the off-diagonal block (I, J), J < I, among the 6 of a chunk
__device__ __forceinline__ constexpr int off_block(int I, int J) { return I * (I - 1) / 2 + J; }

// ---------------------------------------------------------------- the chunk
// One block (256 threads) a chunk and head.  Writes G, exp(G) q, exp(G_last -
// G) k, W, U', A_qk (lower, zeros above), and for the backward A_kk and the l2
// norms' factors 1/|q|, 1/|k| (where those pointers are not null).  The
// pairwise products are taken of q and k as they come and scaled by the
// norms' factors at the end (they are linear in each), so the rows' sums of
// squares come from the same staged rows.
constexpr int CHUNK_THREADS = 256;
constexpr int CHUNK_SMEM = 3 * BT * RH + 5 * BC * RH + 3 * BT + 2 * BT * 4;

template <int IB>
__global__ void __launch_bounds__(CHUNK_THREADS)
kda_chunk_kernel(const void* q, const void* k, const void* v, const float* g, const float* beta,
                 float* G_s, float* QG_s, float* KD_s, float* W_s, float* U0_s, float* Aqk_s,
                 float* Akk_s, float* RQ_s, float* RK_s, int L, int H, int N, float scale,
                 float eps) {
  extern __shared__ float sm[];
  float* sQ = sm;                 // [BT][RH] q, DH key channels
  float* sK = sQ + BT * RH;       // [BT][RH] k
  float* sG = sK + BT * RH;       // [BT][RH] G
  float* sL = sG + BT * RH;       // [5 BC][RH] the off-diagonal blocks' operands
  float* sRq = sL + 5 * BC * RH;  // [BT] 1 / |q|
  float* sRk = sRq + BT;          // [BT] 1 / |k|
  float* sBeta = sRk + BT;        // [BT]
  float* sPart = sBeta + BT;      // [2][BT][4]
  float* sN = sQ;                 // [BT][BT] beta_i A_kk[i][j], after the pairwise products

  const int c = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H, tid = threadIdx.x;
  const int t0 = c * BT;
  const long long row0 = static_cast<long long>(bh) * N * BT + t0;

  if (tid < BT)
    sBeta[tid] = t0 + tid < L ? beta[(static_cast<long long>(b) * L + t0 + tid) * H + h] : 0.f;
  float sq = 0.f, sk = 0.f;  // sums of squares: thread (tid >> 2)'s row, DH / 4 channels a pass
  // the pairwise products: thread (ri, cj) takes entry (ri, cj) of every
  // 16 x 16 block, summed over the two passes of DH key channels
  const int ri = tid >> 4, cj = tid & 15;
  float aqd[NSUB], akd[NSUB], aqo[6], ako[6];
#pragma unroll
  for (int i = 0; i < NSUB; ++i) aqd[i] = akd[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) aqo[i] = ako[i] = 0.f;
  for (int h0 = 0; h0 < D; h0 += DH) {
    __syncthreads();
#pragma unroll
    for (int e = tid; e < BT * DH; e += CHUNK_THREADS) {
      const int row = e / DH, d = e % DH, t = t0 + row;
      float xq = 0.f, xk = 0.f, xg = 0.f;
      if (t < L) {
        const long long o = pos(b, t, h, L, H) + h0 + d;
        xq = ld(q, o, IB);
        xk = ld(k, o, IB);
        xg = g[o];
      }
      sQ[row * RH + d] = xq;
      sK[row * RH + d] = xk;
      sG[row * RH + d] = xg;
    }
    __syncthreads();
    {
      const int row = tid >> 2, part = tid & 3;
#pragma unroll
      for (int n = 0; n < DH / 4; ++n) {
        const float xq = sQ[row * RH + part + 4 * n], xk = sK[row * RH + part + 4 * n];
        sq = fmaf(xq, xq, sq);
        sk = fmaf(xk, xk, sk);
      }
    }
    if (tid < DH) {
      float run = 0.f;
      for (int row = 0; row < BT; ++row) {
        run += sG[row * RH + tid];
        sG[row * RH + tid] = run;
      }
    }
    __syncthreads();
    // each sub-chunk's own block, pair by pair
#pragma unroll
    for (int I = 0; I < NSUB; ++I) {
      if (cj <= ri) {
        const float* xq = sQ + (I * BC + ri) * RH;
        const float* xk = sK + (I * BC + ri) * RH;
        const float* gi = sG + (I * BC + ri) * RH;
        const float* kj = sK + (I * BC + cj) * RH;
        const float* gj = sG + (I * BC + cj) * RH;
        float sq = 0.f, sk = 0.f;
#pragma unroll 8
        for (int d = 0; d < DH; ++d) {
          const float kk = kj[d] * expf(fminf(gi[d] - gj[d], 0.f));
          sq = fmaf(xq[d], kk, sq);
          sk = fmaf(xk[d], kk, sk);
        }
        aqd[I] += sq;
        akd[I] += sk;
      }
    }
    // the rows of sub-chunk I against the columns before its first row r
#pragma unroll
    for (int I = 1; I < NSUB; ++I) {
      const int r = I * BC;
      __syncthreads();
      // rows 0..15: q_i exp(G_i - G_r); 16..31: k_i exp(G_i - G_r); then k_j exp(G_r - G_j)
      for (int e = tid; e < (2 * BC + r) * DH; e += CHUNK_THREADS) {
        const int row = e / DH, d = e % DH;
        const float gr = sG[r * RH + d];
        float val;
        if (row < 2 * BC) {
          const int i = r + (row & (BC - 1));
          val = (row < BC ? sQ : sK)[i * RH + d] * expf(sG[i * RH + d] - gr);
        } else {
          const int j = row - 2 * BC;
          val = sK[j * RH + d] * expf(gr - sG[j * RH + d]);
        }
        sL[row * RH + d] = val;
      }
      __syncthreads();
#pragma unroll
      for (int J = 0; J < I; ++J) {
        const float* lq = sL + ri * RH;
        const float* lk = sL + (BC + ri) * RH;
        const float* rj = sL + (2 * BC + J * BC + cj) * RH;
        float sq = 0.f, sk = 0.f;
#pragma unroll 8
        for (int d = 0; d < DH; ++d) {
          sq = fmaf(lq[d], rj[d], sq);
          sk = fmaf(lk[d], rj[d], sk);
        }
        aqo[off_block(I, J)] += sq;
        ako[off_block(I, J)] += sk;
      }
    }
  }
  sPart[tid] = sq;
  sPart[BT * 4 + tid] = sk;
  __syncthreads();  // sN takes sQ's place
  if (tid < BT) {
    const float* pq = sPart + tid * 4;
    const float* pk = sPart + BT * 4 + tid * 4;
    sRq[tid] = rsqrtf(((pq[0] + pq[1]) + (pq[2] + pq[3])) + eps);
    sRk[tid] = rsqrtf(((pk[0] + pk[1]) + (pk[2] + pk[3])) + eps);
    if (RQ_s != nullptr) {
      RQ_s[row0 + tid] = sRq[tid];
      RK_s[row0 + tid] = sRk[tid];
    }
  }
  __syncthreads();
#pragma unroll
  for (int I = 0; I < NSUB; ++I) {
#pragma unroll
    for (int J = 0; J < NSUB; ++J) {
      const int i = I * BC + ri, j = J * BC + cj;
      float aq = 0.f, ak = 0.f;
      if (J < I) {
        aq = aqo[off_block(I, J)];
        ak = ako[off_block(I, J)];
      } else if (J == I) {
        aq = cj <= ri ? aqd[I] : 0.f;
        ak = cj < ri ? akd[I] : 0.f;
      }
      aq *= sRq[i] * scale * sRk[j];
      ak *= sRk[i] * sRk[j];
      Aqk_s[(row0 + i) * BT + j] = aq;
      if (Akk_s != nullptr) Akk_s[(row0 + i) * BT + j] = ak;
      sN[i * BT + j] = sBeta[i] * ak;
    }
  }
  __syncthreads();

  // the solve, a column of [W | U'] a thread, by forward substitution:
  // X_i = beta_i B_i - sum_{j < i} beta_i A_kk[i][j] X_j
  const int col = tid & (D - 1);
  const bool vside = tid >= D;
  float glast = 0.f;
  if (!vside)
    for (int i = 0; i < BT && t0 + i < L; ++i) glast += g[pos(b, t0 + i, h, L, H) + col];
  float x[BT];  // the right-hand side first (independent rows: the loads overlap), then X
  float run = 0.f;
#pragma unroll
  for (int i = 0; i < BT; ++i) {
    const int t = t0 + i;
    float rhs = 0.f;
    if (!vside) {
      const long long s = (row0 + i) * D + col;
      float gi = 0.f, kn = 0.f, qn = 0.f;
      if (t < L) {
        const long long o = pos(b, t, h, L, H) + col;
        gi = g[o];
        kn = ld(k, o, IB) * sRk[i];
        qn = ld(q, o, IB) * sRq[i] * scale;
      }
      run += gi;
      const float eg = expf(run);
      G_s[s] = run;
      QG_s[s] = qn * eg;
      KD_s[s] = kn * expf(glast - run);
      rhs = kn * eg;
    } else if (t < L) {
      rhs = ld(v, pos(b, t, h, L, H) + col, IB);
    }
    x[i] = sBeta[i] * rhs;
  }
  float* X = vside ? U0_s : W_s;
#pragma unroll
  for (int i = 0; i < BT; ++i) {
#pragma unroll
    for (int j = 0; j < i; ++j) x[i] = fmaf(-sN[i * BT + j], x[j], x[i]);
    X[(row0 + i) * D + col] = x[i];
  }
}

// ----------------------------------------------------------------- the walk
// One block (128 threads) a head and BV value columns, over its chunks in
// order from S = 0 (S's slice in shared memory).  With `o`: O, written in the
// output dtype.  With `S_s`: the state entering each chunk and U, for the
// backward.
constexpr int WALK_THREADS = 128;
constexpr int WALK_SMEM = D * RV + BT * RV + KT * RD;

template <int OB>
__global__ void __launch_bounds__(WALK_THREADS)
kda_walk_kernel(const float* G_s, const float* QG_s, const float* KD_s, const float* W_s,
                const float* U0_s, const float* Aqk_s, void* o, float* S_s, float* U_s, int L,
                int H, int N) {
  extern __shared__ float sm[];
  float* sS = sm;              // [D][RV]
  float* sU = sS + D * RV;     // [BT][RV]
  float* sA = sU + BT * RV;    // staging
  const int v0 = blockIdx.x * BV, bh = blockIdx.y, b = bh / H, h = bh % H, tid = threadIdx.x;
  const int ty = tid / 8, tx = tid % 8;  // 16 x 8 threads
  for (int e = tid; e < D * BV; e += WALK_THREADS) sS[(e / BV) * RV + e % BV] = 0.f;
  for (int c = 0; c < N; ++c) {
    const long long row0 = static_cast<long long>(bh) * N * BT + c * BT;
    __syncthreads();
    if (S_s != nullptr)
      for (int e = tid; e < D * BV; e += WALK_THREADS)
        S_s[((static_cast<long long>(bh) * N + c) * D + e / BV) * D + v0 + e % BV] =
            sS[(e / BV) * RV + e % BV];
    float u[4][4];
    zero(u);
    if (c > 0)
      mac_staged<4, 4, 16, 8>(u, sA, W_s + row0 * D, D, 1, sS, RV, 1, D, tid, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = ty + 16 * i, cv = tx + 8 * j;
        const long long s = (row0 + row) * D + v0 + cv;
        const float val = U0_s[s] - u[i][j];
        sU[row * RV + cv] = val;
        if (U_s != nullptr) U_s[s] = val;
      }
    if (o != nullptr) {
      float acc[4][4];
      zero(acc);
      if (c > 0)
        mac_staged<4, 4, 16, 8>(acc, sA, QG_s + row0 * D, D, 1, sS, RV, 1, D, tid, ty, tx);
      mac_staged<4, 4, 16, 8>(acc, sA, Aqk_s + row0 * BT, BT, 1, sU, RV, 1, BT, tid, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = c * BT + ty + 16 * i;
        if (t < L)
#pragma unroll
          for (int j = 0; j < 4; ++j) st(o, pos(b, t, h, L, H) + v0 + tx + 8 * j, acc[i][j], OB);
      }
    }
    // S <- exp(G_last) S + Kd^T U, Kd^T(d, t) = KD[t][d]
    float s[8][4];
    zero(s);
    mac_staged<8, 4, 16, 8>(s, sA, KD_s + row0 * D, 1, D, sU, RV, 1, BT, tid, ty, tx);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int d = ty + 16 * i;
      const float gamma = expf(G_s[(row0 + BT - 1) * D + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float& cell = sS[d * RV + tx + 8 * j];
        cell = fmaf(gamma, cell, s[i][j]);
      }
    }
  }
}

// ---------------------------------------------------------- the reverse walk
// One block (128 threads) a head and BV value columns, over its chunks in
// reverse from dS = 0: dU = A_qk^T dO + Kd dS, then dS <- Qg^T dO +
// exp(G_last) dS - W^T dU.  Keeps dU and the dS leaving each chunk.
constexpr int BWALK_SMEM = D * RV + 2 * BT * RV + KT * RD;

template <int OB>
__global__ void __launch_bounds__(WALK_THREADS)
kda_bwd_walk_kernel(const float* G_s, const float* QG_s, const float* KD_s, const float* W_s,
                    const float* Aqk_s, const void* dO, float* dU_s, float* dS_s, int L, int H,
                    int N) {
  extern __shared__ float sm[];
  float* sdS = sm;               // [D][RV]
  float* sDO = sdS + D * RV;     // [BT][RV]
  float* sdU = sDO + BT * RV;    // [BT][RV]
  float* sA = sdU + BT * RV;     // staging
  const int v0 = blockIdx.x * BV, bh = blockIdx.y, b = bh / H, h = bh % H, tid = threadIdx.x;
  const int ty = tid / 8, tx = tid % 8;
  for (int e = tid; e < D * BV; e += WALK_THREADS) sdS[(e / BV) * RV + e % BV] = 0.f;
  for (int n = 0; n < N; ++n) {
    const int c = N - 1 - n;
    const long long row0 = static_cast<long long>(bh) * N * BT + c * BT;
    __syncthreads();
    for (int e = tid; e < D * BV; e += WALK_THREADS)
      dS_s[((static_cast<long long>(bh) * N + c) * D + e / BV) * D + v0 + e % BV] =
          sdS[(e / BV) * RV + e % BV];
#pragma unroll
    for (int e = tid; e < BT * BV; e += WALK_THREADS) {
      const int row = e / BV, cv = e % BV, t = c * BT + row;
      sDO[row * RV + cv] = t < L ? ld(dO, pos(b, t, h, L, H) + v0 + cv, OB) : 0.f;
    }
    float du[4][4];
    zero(du);
    // A_qk^T(t, t') = A_qk[t'][t]
    mac_staged<4, 4, 16, 8>(du, sA, Aqk_s + row0 * BT, 1, BT, sDO, RV, 1, BT, tid, ty, tx);
    if (n > 0)
      mac_staged<4, 4, 16, 8>(du, sA, KD_s + row0 * D, D, 1, sdS, RV, 1, D, tid, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = ty + 16 * i, cv = tx + 8 * j;
        sdU[row * RV + cv] = du[i][j];
        dU_s[(row0 + row) * D + v0 + cv] = du[i][j];
      }
    float p[8][4], m[8][4];
    zero(p);
    zero(m);
    mac_staged<8, 4, 16, 8>(p, sA, QG_s + row0 * D, 1, D, sDO, RV, 1, BT, tid, ty, tx);
    mac_staged<8, 4, 16, 8>(m, sA, W_s + row0 * D, 1, D, sdU, RV, 1, BT, tid, ty, tx);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int d = ty + 16 * i;
      const float gamma = expf(G_s[(row0 + BT - 1) * D + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float& cell = sdS[d * RV + tx + 8 * j];
        cell = fmaf(gamma, cell, p[i][j] - m[i][j]);
      }
    }
  }
}

// ---------------------------------------------------- the state's gradients
// One block (128 threads) a chunk and BK key channels: dQg = dO S^T, dKd =
// U dS^T, dW = -dU S^T and d exp(G_last) = sum_v S * dS, written as exp(G)
// dQg (to dq_s), exp(G_last - G) dKd (to dk_s), the G gradient Qg dQg - Kd dKd
// (the last row also sum_t Kd dKd + exp(G_last) d exp(G_last)) (to dG_s) and
// dW; the block of the first channels also dA_qk = dO U^T (lower).
constexpr int STATE_THREADS = 128;
constexpr int STATE_SMEM = BT * RD + 2 * BK * RD + KT * RT + 16 * BK + BK;

template <int OB>
__global__ void __launch_bounds__(STATE_THREADS)
kda_bwd_state_kernel(const float* G_s, const float* QG_s, const float* KD_s, const float* U_s,
                     const float* dU_s, const float* S_s, const float* dS_s, const void* dO,
                     float* dq_s, float* dk_s, float* dG_s, float* dW_s, float* dAqk_s, int L,
                     int H, int N) {
  extern __shared__ float sm[];
  float* sDO = sm;               // [BT][RD]
  float* sS = sDO + BT * RD;     // [BK][RD] S[k0 + kk][v]
  float* sdS = sS + BK * RD;     // [BK][RD]
  float* sA = sdS + BK * RD;     // staging
  float* sRed = sA + KT * RT;    // [16][BK]
  float* sGam = sRed + 16 * BK;  // [BK]
  const int k0 = blockIdx.x * BK, c = blockIdx.y, bh = blockIdx.z, b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const long long row0 = static_cast<long long>(bh) * N * BT + c * BT;
  const long long st0 = (static_cast<long long>(bh) * N + c) * D * D;
#pragma unroll
  for (int e = tid; e < BT * D; e += STATE_THREADS) {
    const int row = e / D, cv = e % D, t = c * BT + row;
    sDO[row * RD + cv] = t < L ? ld(dO, pos(b, t, h, L, H) + cv, OB) : 0.f;
  }
#pragma unroll
  for (int e = tid; e < BK * D; e += STATE_THREADS) {
    const int kk = e / D, cv = e % D;
    sS[kk * RD + cv] = S_s[st0 + static_cast<long long>(k0 + kk) * D + cv];
    sdS[kk * RD + cv] = dS_s[st0 + static_cast<long long>(k0 + kk) * D + cv];
  }
  __syncthreads();
  if (tid < BK) {
    float sum = 0.f;
    for (int cv = 0; cv < D; ++cv) sum = fmaf(sS[tid * RD + cv], sdS[tid * RD + cv], sum);
    sGam[tid] = sum;
  }
  const int ty = tid / 8, tx = tid % 8;  // rows ty + 16 i, channels k0 + tx + 8 j
  float dqg[4][4], dkd[4][4], dw[4][4];
  zero(dqg);
  zero(dkd);
  zero(dw);
  mac<4, 4, 16, 8>(dqg, sDO, RD, 1, sS, 1, RD, D, ty, tx);
  mac_staged<4, 4, 16, 8>(dkd, sA, U_s + row0 * D, D, 1, sdS, 1, RD, D, tid, ty, tx);
  mac_staged<4, 4, 16, 8>(dw, sA, dU_s + row0 * D, D, 1, sS, 1, RD, D, tid, ty, tx);
  float kdd[4][4];
  float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = ty + 16 * i, d = k0 + tx + 8 * j;
      const long long s = (row0 + row) * D + d;
      const float G = G_s[s], gl = G_s[(row0 + BT - 1) * D + d];
      kdd[i][j] = KD_s[s] * dkd[i][j];
      part[j] += kdd[i][j];
      dq_s[s] = expf(G) * dqg[i][j];
      dk_s[s] = expf(gl - G) * dkd[i][j];
      dW_s[s] = -dw[i][j];
      if (row != BT - 1) dG_s[s] = QG_s[s] * dqg[i][j] - kdd[i][j];
    }
#pragma unroll
  for (int j = 0; j < 4; ++j) sRed[ty * BK + tx + 8 * j] = part[j];
  __syncthreads();
  if (ty == 15) {  // the thread of row BT - 1 = 15 + 16 * 3
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = tx + 8 * j, d = k0 + kk;
      const long long s = (row0 + BT - 1) * D + d;
      float sum = 0.f;
      for (int r = 0; r < 16; ++r) sum += sRed[r * BK + kk];
      dG_s[s] = QG_s[s] * dqg[3][j] - kdd[3][j] + sum + expf(G_s[s]) * sGam[kk];
    }
  }
  if (k0 == 0) {  // dA_qk = dO U^T, lower: as (U dO^T)^T, rows t' = ty2 + 8 i, columns t
    const int ty2 = tid / 16, tx2 = tid % 16;
    float a[8][4];
    zero(a);
    mac_staged<8, 4, 8, 16>(a, sA, U_s + row0 * D, D, 1, sDO, 1, RD, D, tid, ty2, tx2);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int tp = ty2 + 8 * i, t = tx2 + 16 * j;
        dAqk_s[(row0 + t) * BT + tp] = tp <= t ? a[i][j] : 0.f;
      }
  }
}

// ------------------------------------------------------ the solve's gradients
// One block (256 threads) a chunk.  With M = I + diag(beta) A_kk and X = [W |
// U'] = M^-1 diag(beta) [exp(G) k | v]: dB = M^-T [dW | dU] by back
// substitution, a column a thread; dM = -dB X^T (strictly lower); dv = beta
// dB_v; dbeta = sum_j dM A_kk + sum_c dB [exp(G) k | v]; the pairwise
// gradient dA_kk = diag(beta) dM; and through diag(beta) exp(G) k, exp(G)
// beta dB_k added to dk_s and exp(G) k beta dB_k to dG_s.
constexpr int SOLVE_THREADS = 256;
constexpr int SOLVE_SMEM = BT * BT + BT * RB + KT * RT + BT * 17 + BT * 4 + BT;

template <int IB>
__global__ void __launch_bounds__(SOLVE_THREADS)
kda_bwd_solve_kernel(const void* k, const void* v, const float* beta, const float* G_s,
                     const float* RK_s, const float* W_s, const float* U0_s, const float* Akk_s,
                     const float* dU_s, const float* dW_s, float* dk_s, float* dG_s,
                     float* dAkk_s, void* dv, float* dbeta, int L, int H, int N) {
  extern __shared__ float sm[];
  float* sN = sm;                  // [BT][BT] beta_i A_kk[i][j]
  float* sDB = sN + BT * BT;       // [BT][RB] dB
  float* sA = sDB + BT * RB;       // staging
  float* sRed = sA + KT * RT;      // [BT][17]
  float* sPart = sRed + BT * 17;   // [BT][4]
  float* sBeta = sPart + BT * 4;   // [BT]
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H, tid = threadIdx.x;
  const int t0 = c * BT;
  const long long row0 = static_cast<long long>(bh) * N * BT + t0;
  if (tid < BT) sBeta[tid] = t0 + tid < L ? beta[(static_cast<long long>(b) * L + t0 + tid) * H + h] : 0.f;
  __syncthreads();
  for (int e = tid; e < BT * BT; e += SOLVE_THREADS) sN[e] = sBeta[e / BT] * Akk_s[row0 * BT + e];
  __syncthreads();
  const int col = tid & (D - 1);
  const bool vside = tid >= D;
  const float* R = vside ? dU_s : dW_s;
  float y[BT];  // y[BT - 1 - n]: counted from the last row, so the loops unroll as the forward's
#pragma unroll
  for (int n = 0; n < BT; ++n) {
    const int i = BT - 1 - n;
    float acc = R[(row0 + i) * D + col];
#pragma unroll
    for (int m = 0; m < n; ++m) acc = fmaf(-sN[(BT - 1 - m) * BT + i], y[m], acc);
    y[n] = acc;
    sDB[i * RB + tid] = acc;
  }
  // through beta [exp(G) k | v]
  for (int i = 0; i < BT; ++i) {
    const int t = t0 + i;
    if (t >= L) break;
    const float db = sBeta[i] * sDB[i * RB + tid];
    if (vside) {
      st(dv, pos(b, t, h, L, H) + col, db, IB);
    } else {
      const long long s = (row0 + i) * D + col;
      const float eg = expf(G_s[s]);
      dk_s[s] += eg * db;
      dG_s[s] += eg * ld(k, pos(b, t, h, L, H) + col, IB) * RK_s[row0 + i] * db;
    }
  }
  __syncthreads();
  {  // sum_c dB [exp(G) k | v], 4 threads a row
    const int row = tid >> 2, part = tid & 3, t = t0 + row;
    float sum = 0.f;
    if (t < L) {
      const long long o = pos(b, t, h, L, H);
      const float rk = RK_s[row0 + row];
#pragma unroll 8
      for (int n = 0; n < 2 * D / 4; ++n) {  // interleaved: a warp's loads share rows' sectors
        const int cc = part + 4 * n;
        const float raw = cc < D ? expf(G_s[(row0 + row) * D + cc]) * ld(k, o + cc, IB) * rk
                                 : ld(v, o + cc - D, IB);
        sum = fmaf(sDB[row * RB + cc], raw, sum);
      }
    }
    sPart[row * 4 + part] = sum;
  }
  // dM^T[j][i] = -sum_c X[j][c] dB[i][c]: rows j = ty + 16 a, columns i = tx + 16 e
  const int ty = tid / 16, tx = tid % 16;
  float a[4][4];
  zero(a);
  mac_staged<4, 4, 16, 16>(a, sA, W_s + row0 * D, D, 1, sDB, 1, RB, D, tid, ty, tx);
  mac_staged<4, 4, 16, 16>(a, sA, U0_s + row0 * D, D, 1, sDB + D, 1, RB, D, tid, ty, tx);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = tx + 16 * e;
    float part = 0.f;
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int j = ty + 16 * f;
      const float dm = j < i ? -a[f][e] : 0.f;
      dAkk_s[(row0 + i) * BT + j] = sBeta[i] * dm;
      part = fmaf(dm, Akk_s[(row0 + i) * BT + j], part);
    }
    sRed[i * 17 + ty] = part;
  }
  __syncthreads();
  if (tid < BT && t0 + tid < L) {
    float sum = (sPart[tid * 4] + sPart[tid * 4 + 1]) + (sPart[tid * 4 + 2] + sPart[tid * 4 + 3]);
    for (int r = 0; r < 16; ++r) sum += sRed[tid * 17 + r];
    dbeta[(static_cast<long long>(b) * L + t0 + tid) * H + h] = sum;
  }
}

// ------------------------------------------------ the pairwise decays' gradients
// One block (256 threads) a chunk, in passes of PD key channels; thread
// (channel d = tid % PD, rows i = tid / PD + PG m).  From dA_qk (lower) and
// dA_kk (strictly lower): the rows' gradients (q's from dA_qk, k's from dA_kk)
// and the columns' (k's from both), the sub-chunks' own blocks pair by pair
// and the earlier columns factored at each sub-chunk's first row; then dqn =
// those + dq_s, dkn = those + dk_s, dG = dG_s + qn dq_rows - kn dk_cols(qk) +
// kn dk_rows(kk) - kn dk_cols(kk), dg = its reverse running sum over the
// chunk; last, dq and dk through the l2 norms.
constexpr int PAIRS_THREADS = 256;
constexpr int PD = 32;                  // key channels a pass
constexpr int PG = PAIRS_THREADS / PD;  // row groups: a thread's rows are PG apart
constexpr int PM = BT / PG;             // rows a thread
constexpr int RP = PD + P;
constexpr int PAIRS_SMEM = 3 * BT * RP + 5 * BC * RP + 2 * BT * RT + BT * 8;

// the sub-chunk of a thread's m-th row
__device__ __forceinline__ constexpr int pair_sub(int m) { return m / (BC / PG); }

template <int IB>
__global__ void __launch_bounds__(PAIRS_THREADS, 2)
kda_bwd_pairs_kernel(const void* q, const void* k, const float* G_s, const float* RQ_s,
                     const float* RK_s, const float* dAqk_s, const float* dAkk_s, float* dq_s,
                     float* dk_s, const float* dG_s, void* dq, void* dk, float* dg, int L, int H,
                     int N, float scale) {
  extern __shared__ float sm[];
  float* sQ = sm;                // [BT][RP] q / |q| * scale
  float* sK = sQ + BT * RP;      // [BT][RP] k / |k|
  float* sG = sK + BT * RP;      // [BT][RP] G
  float* sL = sG + BT * RP;      // [5 BC][RP] operands; then dG of the pass [BT][RP]
  float* sAq = sL + 5 * BC * RP; // [BT][RT] dA_qk
  float* sAk = sAq + BT * RT;    // [BT][RT] dA_kk
  float* sPart = sAk + BT * RT;  // [2][BT][4]
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H, tid = threadIdx.x;
  const int t0 = c * BT;
  const long long row0 = static_cast<long long>(bh) * N * BT + t0;
  for (int e = tid; e < BT * BT; e += PAIRS_THREADS) {
    sAq[(e / BT) * RT + e % BT] = dAqk_s[row0 * BT + e];
    sAk[(e / BT) * RT + e % BT] = dAkk_s[row0 * BT + e];
  }
  const int d = tid % PD, rq = tid / PD;
  for (int h0 = 0; h0 < D; h0 += PD) {
    __syncthreads();
#pragma unroll
    for (int e = tid; e < BT * PD; e += PAIRS_THREADS) {
      const int row = e / PD, dd = e % PD, t = t0 + row;
      float xq = 0.f, xk = 0.f;
      if (t < L) {
        const long long o = pos(b, t, h, L, H) + h0 + dd;
        xq = ld(q, o, IB) * RQ_s[row0 + row] * scale;
        xk = ld(k, o, IB) * RK_s[row0 + row];
      }
      sQ[row * RP + dd] = xq;
      sK[row * RP + dd] = xk;
      sG[row * RP + dd] = G_s[(row0 + row) * D + h0 + dd];
    }
    __syncthreads();
    float dqa[PM], dkb[PM], dka[PM], dkc[PM];  // rows i = rq + PG m
#pragma unroll
    for (int m = 0; m < PM; ++m) {
      const int i = rq + PG * m, r = pair_sub(m) * BC;  // i's sub-chunk starts at r
      const float gi = sG[i * RP + d];
      float s1 = 0.f, s2 = 0.f, s3 = 0.f, s4 = 0.f;
      for (int j = r; j <= i; ++j) {  // i as a row
        const float kj = sK[j * RP + d] * expf(fminf(gi - sG[j * RP + d], 0.f));
        s1 = fmaf(sAq[i * RT + j], kj, s1);
        s2 = fmaf(sAk[i * RT + j], kj, s2);
      }
      for (int j = i; j < r + BC; ++j) {  // i as a column
        const float e = expf(fminf(sG[j * RP + d] - gi, 0.f));
        s3 = fmaf(sAq[j * RT + i], sQ[j * RP + d] * e, s3);
        s4 = fmaf(sAk[j * RT + i], sK[j * RP + d] * e, s4);
      }
      dqa[m] = s1;
      dkb[m] = s2;
      dka[m] = s3;
      dkc[m] = s4;
    }
#pragma unroll
    for (int I = 1; I < NSUB; ++I) {
      const int r = I * BC;
      __syncthreads();
      for (int e = tid; e < (2 * BC + r) * PD; e += PAIRS_THREADS) {
        const int row = e / PD, dd = e % PD;
        const float gr = sG[r * RP + dd];
        float val;
        if (row < 2 * BC) {
          const int i = r + (row & (BC - 1));
          val = (row < BC ? sQ : sK)[i * RP + dd] * expf(sG[i * RP + dd] - gr);
        } else {
          const int j = row - 2 * BC;
          val = sK[j * RP + dd] * expf(gr - sG[j * RP + dd]);
        }
        sL[row * RP + dd] = val;
      }
      __syncthreads();
      const float gr = sG[r * RP + d];
#pragma unroll
      for (int m = 0; m < PM; ++m) {
        const int i = rq + PG * m;
        if (pair_sub(m) == I) {  // a row of sub-chunk I: the columns before r
          float s1 = 0.f, s2 = 0.f;
          for (int j = 0; j < r; ++j) {
            const float rk = sL[(2 * BC + j) * RP + d];
            s1 = fmaf(sAq[i * RT + j], rk, s1);
            s2 = fmaf(sAk[i * RT + j], rk, s2);
          }
          const float e = expf(sG[i * RP + d] - gr);
          dqa[m] = fmaf(e, s1, dqa[m]);
          dkb[m] = fmaf(e, s2, dkb[m]);
        } else if (pair_sub(m) < I) {  // a column before r: the rows of sub-chunk I
          float s3 = 0.f, s4 = 0.f;
          for (int ii = 0; ii < BC; ++ii) {
            s3 = fmaf(sAq[(r + ii) * RT + i], sL[ii * RP + d], s3);
            s4 = fmaf(sAk[(r + ii) * RT + i], sL[(BC + ii) * RP + d], s4);
          }
          const float e = expf(gr - sG[i * RP + d]);
          dka[m] = fmaf(e, s3, dka[m]);
          dkc[m] = fmaf(e, s4, dkc[m]);
        }
      }
    }
    __syncthreads();  // sL takes this pass's dG
#pragma unroll
    for (int m = 0; m < PM; ++m) {
      const int i = rq + PG * m;
      const long long s = (row0 + i) * D + h0 + d;
      const float qn = sQ[i * RP + d], kn = sK[i * RP + d];
      dq_s[s] += dqa[m];
      dk_s[s] += dka[m] + dkb[m] + dkc[m];
      sL[i * RP + d] = dG_s[s] + qn * dqa[m] - kn * dka[m] + kn * dkb[m] - kn * dkc[m];
    }
    __syncthreads();
    if (tid < PD) {  // dg: the reverse running sum down the chunk
      float run = 0.f;
      for (int i = BT - 1; i >= 0; --i) {
        run += sL[i * RP + tid];
        if (t0 + i < L) dg[pos(b, t0 + i, h, L, H) + h0 + tid] = run;
      }
    }
  }
  __syncthreads();  // dq_s, dk_s of every channel are written
  // through the l2 norms: dx = r dy - x r^3 (x . dy), 4 threads a row
  const int row = tid >> 2, part = tid & 3, t = t0 + row;
  const long long o = t < L ? pos(b, t, h, L, H) : 0;
  const long long s0 = (row0 + row) * D;
  float xq_dy = 0.f, xk_dy = 0.f;
  if (t < L)
#pragma unroll 8
    for (int n = 0; n < D / 4; ++n) {  // interleaved: a warp's loads share rows' sectors
      const int dd = part + 4 * n;
      xq_dy = fmaf(ld(q, o + dd, IB), dq_s[s0 + dd] * scale, xq_dy);
      xk_dy = fmaf(ld(k, o + dd, IB), dk_s[s0 + dd], xk_dy);
    }
  sPart[row * 4 + part] = xq_dy;
  sPart[BT * 4 + row * 4 + part] = xk_dy;
  __syncthreads();
  if (t < L) {
    const float* pq = sPart + row * 4;
    const float* pk = sPart + BT * 4 + row * 4;
    const float sq = (pq[0] + pq[1]) + (pq[2] + pq[3]), sk = (pk[0] + pk[1]) + (pk[2] + pk[3]);
    const float rqn = RQ_s[row0 + row], rkn = RK_s[row0 + row];
    const float cq = rqn * rqn * rqn * sq, ck = rkn * rkn * rkn * sk;
#pragma unroll 8
    for (int n = 0; n < D / 4; ++n) {
      const int dd = part + 4 * n;
      st(dq, o + dd, rqn * dq_s[s0 + dd] * scale - ld(q, o + dd, IB) * cq, IB);
      st(dk, o + dd, rkn * dk_s[s0 + dd] - ld(k, o + dd, IB) * ck, IB);
    }
  }
}

// --------------------------------------------------------------- the scratch
struct Scratch {
  float *G, *QG, *KD, *W, *U0, *Aqk;                                 // both
  float *Akk, *RQ, *RK, *S, *U, *dS, *dU, *dq, *dk, *dG, *dW, *dAqk, *dAkk;  // backward
};

long long scratch_floats(int b, int l, int h, bool backward, Scratch* out, float* base) {
  const long long n = (l + BT - 1) / BT, rows = static_cast<long long>(b) * h * n * BT;
  const long long sizes[19] = {rows * D, rows * D, rows * D, rows * D, rows * D, rows * BT,
                               rows * BT, rows, rows, rows / BT * D * D, rows * D,
                               rows / BT * D * D, rows * D, rows * D, rows * D, rows * D,
                               rows * D, rows * BT, rows * BT};
  float** slots[19] = {&out->G, &out->QG, &out->KD, &out->W, &out->U0, &out->Aqk, &out->Akk,
                       &out->RQ, &out->RK, &out->S, &out->U, &out->dS, &out->dU, &out->dq,
                       &out->dk, &out->dG, &out->dW, &out->dAqk, &out->dAkk};
  long long total = 0;
  for (int i = 0; i < (backward ? 19 : 6); ++i) {
    *slots[i] = base == nullptr ? nullptr : base + total;
    total += (sizes[i] + 31) / 32 * 32;  // 128-byte aligned slices
  }
  return total;
}

template <typename K>
void allow_smem(K kernel, int floats) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       floats * static_cast<int>(sizeof(float)));
}

constexpr float kScale = 0.08838834764831845f;  // D^-1/2
constexpr float kEps = 1e-6f;                   // the l2 norms' (`kda.L2_EPS`)

template <int IB>
void launch_chunk(const void* q, const void* k, const void* v, const float* g, const float* beta,
                  const Scratch& s, bool backward, int b, int l, int h, int n,
                  cudaStream_t stream) {
  allow_smem(kda_chunk_kernel<IB>, CHUNK_SMEM);
  kda_chunk_kernel<IB><<<dim3(n, b * h), CHUNK_THREADS, CHUNK_SMEM * sizeof(float), stream>>>(
      q, k, v, g, beta, s.G, s.QG, s.KD, s.W, s.U0, s.Aqk, backward ? s.Akk : nullptr,
      backward ? s.RQ : nullptr, backward ? s.RK : nullptr, l, h, n, kScale, kEps);
}

template <int IB, int OB>
void forward(const void* q, const void* k, const void* v, const float* g, const float* beta,
             void* o, const Scratch& s, int b, int l, int h, int n, cudaStream_t st) {
  launch_chunk<IB>(q, k, v, g, beta, s, false, b, l, h, n, st);
  allow_smem(kda_walk_kernel<OB>, WALK_SMEM);
  kda_walk_kernel<OB><<<dim3(D / BV, b * h), WALK_THREADS, WALK_SMEM * sizeof(float), st>>>(
      s.G, s.QG, s.KD, s.W, s.U0, s.Aqk, o, nullptr, nullptr, l, h, n);
}

template <int IB, int OB>
void backward(const void* q, const void* k, const void* v, const float* g, const float* beta,
              const void* dO, void* dq, void* dk, void* dv, float* dg, float* dbeta,
              const Scratch& s, int b, int l, int h, int n, cudaStream_t st) {
  launch_chunk<IB>(q, k, v, g, beta, s, true, b, l, h, n, st);
  allow_smem(kda_walk_kernel<OB>, WALK_SMEM);
  kda_walk_kernel<OB><<<dim3(D / BV, b * h), WALK_THREADS, WALK_SMEM * sizeof(float), st>>>(
      s.G, s.QG, s.KD, s.W, s.U0, s.Aqk, nullptr, s.S, s.U, l, h, n);
  allow_smem(kda_bwd_walk_kernel<OB>, BWALK_SMEM);
  kda_bwd_walk_kernel<OB><<<dim3(D / BV, b * h), WALK_THREADS, BWALK_SMEM * sizeof(float), st>>>(
      s.G, s.QG, s.KD, s.W, s.Aqk, dO, s.dU, s.dS, l, h, n);
  allow_smem(kda_bwd_state_kernel<OB>, STATE_SMEM);
  kda_bwd_state_kernel<OB><<<dim3(D / BK, n, b * h), STATE_THREADS, STATE_SMEM * sizeof(float),
                             st>>>(s.G, s.QG, s.KD, s.U, s.dU, s.S, s.dS, dO, s.dq, s.dk, s.dG,
                                   s.dW, s.dAqk, l, h, n);
  allow_smem(kda_bwd_solve_kernel<IB>, SOLVE_SMEM);
  kda_bwd_solve_kernel<IB><<<dim3(n, b * h), SOLVE_THREADS, SOLVE_SMEM * sizeof(float), st>>>(
      k, v, beta, s.G, s.RK, s.W, s.U0, s.Akk, s.dU, s.dW, s.dk, s.dG, s.dAkk, dv, dbeta, l, h,
      n);
  allow_smem(kda_bwd_pairs_kernel<IB>, PAIRS_SMEM);
  kda_bwd_pairs_kernel<IB><<<dim3(n, b * h), PAIRS_THREADS, PAIRS_SMEM * sizeof(float), st>>>(
      q, k, s.G, s.RQ, s.RK, s.dAqk, s.dAkk, s.dq, s.dk, s.dG, dq, dk, dg, l, h, n, kScale);
}

}  // namespace

// Floats of scratch a forward (backward = 0) or a backward call takes.
extern "C" long long macsa_kda_scratch_floats(int b, int l, int h, int backward) {
  Scratch s;
  return scratch_floats(b, l, h, backward != 0, &s, nullptr);
}

// q, k, v [B, L, H, 128] (bf16 if in_bf16, else f32), g [B, L, H, 128] f32,
// beta [B, L, H] f32 -> o [B, L, H, 128] (bf16 if out_bf16, else f32).
extern "C" int macsa_kda_fwd(const void* q, const void* k, const void* v, const float* g,
                             const float* beta, void* o, float* scratch, int b, int l, int h,
                             int in_bf16, int out_bf16, void* stream) {
  if (b < 1 || l < 1 || h < 1 || b * h > 65535) return cudaErrorInvalidValue;  // B*H: a grid's y or z
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = (l + BT - 1) / BT;
  Scratch s;
  scratch_floats(b, l, h, false, &s, scratch);
  auto run = in_bf16 ? (out_bf16 ? forward<1, 1> : forward<1, 0>)
                     : (out_bf16 ? forward<0, 1> : forward<0, 0>);
  run(q, k, v, g, beta, o, s, b, l, h, n, st);
  return cudaGetLastError();
}

// The gradients of `macsa_kda_fwd` from dO (o's dtype): dq, dk, dv in q's
// dtype, dg and dbeta in f32.
extern "C" int macsa_kda_bwd(const void* q, const void* k, const void* v, const float* g,
                             const float* beta, const void* dO, void* dq, void* dk, void* dv,
                             float* dg, float* dbeta, float* scratch, int b, int l, int h,
                             int in_bf16, int out_bf16, void* stream) {
  if (b < 1 || l < 1 || h < 1 || b * h > 65535) return cudaErrorInvalidValue;  // B*H: a grid's y or z
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = (l + BT - 1) / BT;
  Scratch s;
  scratch_floats(b, l, h, true, &s, scratch);
  auto run = in_bf16 ? (out_bf16 ? backward<1, 1> : backward<1, 0>)
                     : (out_bf16 ? backward<0, 1> : backward<0, 0>);
  run(q, k, v, g, beta, dO, dq, dk, dv, dg, dbeta, s, b, l, h, n, st);
  return cudaGetLastError();
}
