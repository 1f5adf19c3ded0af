// Kernel K4: batched Cholesky factor of small dense SPD matrices, float32.
//
// Replaces: legged_mpc_control_tpu/ops/chol_pallas.py, cholesky_lanes.
// Plain version: legged_mpc_control_tpu_torch/ops/chol_kernel.py,
//           cholesky_plain.
//
// The callers: the condensed PDIP and ADMM solvers (mpc/pdip.py,
// mpc/admm.py) factor K (B, n, n) with n = 12H: n = 120 at B = 4096 in the
// closed loop and at B = 1 in the latency cells, n = 360 (H = 30, the
// reference's horizon) at B = 512; the contact-implicit MPC on a height
// field (mpc/ci_mpc.py, backend "lanes") factors n = 24 at B = 256 in every
// backward stage. Layouts are batch-first, row-major.
//
// Contract (K5 and K6 in chol_lanes.cu read F): F holds L in its lower
// triangle and on the diagonal, and L^T mirrored in its strict upper
// triangle, F[i][j] = L[j][i] for j > i. Only the lower triangle of K is
// read. A non-positive pivot p gives a non-finite factor for that matrix
// (sqrt(p) = NaN, or 1/sqrt(0) = inf), never clamped, as the TPU kernel's
// rsqrt(p), so the PDIP solver's non-finite guard freezes that scenario.
// sqrtf and the reciprocal are correctly rounded (CUDA's rsqrtf is an
// approximation): late in a PDIP solve many Newton matrices are within
// float32 rounding of singular, and every ulp of a pivot decides which of
// them fail. All arithmetic is float32 FMA on the CUDA cores.
//
// Every variant runs the same right-looking recursion with the same
// roundings: at step j, p = A[j][j], inv = 1 / sqrtf(p), l_i = A[i][j] inv,
// and each A[i][k], j < k <= i, becomes fma(-l_i, l_k, A[i][k]); L[j][j] =
// sqrtf(p). An element meets its updates in the order of j. So the three
// variants agree bit for bit where the compiler contracts alike.
//
// What bounds it on an H100. At n = 120, B = 4096, K4 must read one
// triangle of K and write F: 0.071 ms at 3.35 TB/s; it does n^3/3 = 0.58
// MFLOP a matrix, 0.035 ms at 67 TFLOP/s. At n = 360, B = 512, operations
// bound it (0.119 ms). But the recursion is n dependent column steps, each
// a reciprocal square root apart: what a kernel meets first is the latency
// of a step, times n, times the waves of matrices. The design keeps a step
// short and runs many matrices at once.
//
// Small n (n <= 32; the CI gain systems, n = 24): a warp per matrix, two
// to a block. Lane i holds row i of the lower triangle in registers; step j
// broadcasts the pivot and each l_k by __shfl_sync from lane k. The matrix
// is padded to 32 with identity rows and the loops are unrolled over 32
// without a branch, so the registers are indexed by constants and the
// shuffles of a step issue back to back. No shared memory and no barrier:
// the ragged last block's idle warp simply returns.
//
// Mid n (33 <= n <= 128; the PDIP/ADMM Newton matrices, n = 120): a block
// of 16 x 16 threads per matrix holds the lower triangle in registers, 2-D
// cyclic: thread (r, c) owns rows r + 16 s and columns c + 16 t, s, t < 8.
// The factor is blocked by 16 columns, three barriers a panel instead of a
// barrier a column (the recursion's latency at B = 1): the threads write
// the panel to double-buffered shared memory; warp 0 factors its 16 x 16
// diagonal tile as the small variant does, with shuffles; a thread a row
// solves the rows below against the tile (each element meets its updates
// in the same order); every thread applies the panel's 16 rank-1 updates
// to its slots in column order, 2 FMAs per shared load. Column blocks are
// walked with a compile-time index, so finished blocks are skipped at
// compile time and registers stay constant-indexed. K and F pass through a
// shared-memory copy of the triangle, so device memory sees whole rows.
// (On the card a barrier a column was slower at B = 1 and B = 256 and a
// little faster at B = 4096; publishing the next column ahead, or float4
// reads of the column, were slower at all three.)
//
// Large n (n > 128; n = 360): a blocked right-looking factor, a block per
// matrix, the trailing triangle in F in device memory. Panel by panel
// (width NB = 36; a ragged last panel is served): the panel's columns,
// rows p0..n-1, are staged in shared memory column-major and factored
// there (the diagonal tile and the rows below it in one unblocked sweep,
// one barrier a column), written to F with the mirror, and the trailing
// triangle is updated with 4 x 4 register micro-tiles of 64 x 64 tiles,
// the panel's rows read from shared memory (8 loads for 16 FMAs). The
// first panel reads K and the first trailing update writes F, so K is read
// once. At n = 360 the panel is 36 x 361 floats (52 KB): four blocks an
// SM. n is limited by the panel: NB columns of n floats must fit a block's
// shared memory (n <= 1,613 at NB = 36); narrower panels serve larger n
// (to n = 58,111).

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARP = 32;
constexpr int SMALL_N = 32;          // small variant: n <= SMALL_N
constexpr int SMALL_MATS = 2;        // matrices (warps) a block: B = 256
                                     // spreads over 128 SMs
constexpr int MID_T = 16;            // mid variant: MID_T x MID_T threads
constexpr int MID_S = 8;             // slots a thread along each axis
constexpr int MID_N = MID_T * MID_S;  // mid variant: n <= MID_N
constexpr int LARGE_THREADS = 256;
constexpr int NB = 36;               // large variant's panel width
constexpr int TILE = 64;             // trailing update tile, 4 x 4 a thread
constexpr size_t SMEM_MAX = 232448;  // an H100 block's shared memory
// the mid variant's dynamic shared memory at n = MID_N (its static panel
// buffers take part of the rest of the block's share)
constexpr size_t MID_SMEM = (size_t)MID_N * (MID_N | 1) * sizeof(float);
constexpr int MAX_DEVICES = 64;

__global__ void __launch_bounds__(SMALL_MATS * WARP)
chol_factor_small(const float* __restrict__ K, float* __restrict__ F, int B,
                  int n) {
  const int i = threadIdx.x % WARP;                      // row of the lane
  const int b = blockIdx.x * SMALL_MATS + threadIdx.x / WARP;
  if (b >= B) return;                                    // a whole warp
  const size_t nn = (size_t)n * n;
  const float* Kb = K + b * nn;
  float* Fb = F + b * nn;
  // A[i][k], k <= i; rows n..31 are the identity's, so every step runs
  // (the kernel is one straight-line block the compiler can schedule) and
  // leaves rows < n as they are: their l_j is 0 at steps j >= n
  float a[SMALL_N];
#pragma unroll
  for (int k = 0; k < SMALL_N; ++k)
    a[k] = i < n ? (k <= i ? Kb[i * n + k] : 0.0f) : (k == i ? 1.0f : 0.0f);
#pragma unroll
  for (int j = 0; j < SMALL_N; ++j) {
    const float p = __shfl_sync(FULL, a[j], j);          // A[j][j]
    const float sq = sqrtf(p);
    const float inv = 1.0f / sq;
    const float lij = a[j] * inv;
#pragma unroll
    for (int k = j + 1; k < SMALL_N; ++k) {
      const float lkj = __shfl_sync(FULL, lij, k);
      if (k <= i) a[k] -= lij * lkj;
    }
    if (i > j) a[j] = lij;
    else if (i == j) a[j] = sq;
  }
  if (i < n) {
#pragma unroll
    for (int k = 0; k < SMALL_N; ++k) {
      if (k <= i) {
        Fb[i * n + k] = a[k];
        if (k < i) Fb[k * n + i] = a[k];                 // the mirror
      }
    }
  }
}

__global__ void __launch_bounds__(MID_T * MID_T, 2)
chol_factor_mid(const float* __restrict__ K, float* __restrict__ F, int n) {
  extern __shared__ float tri[];       // the lower triangle, row stride ld
  // the panel (16 columns of A) and 1 / L[j][j] of its columns, double
  // buffered: a panel's writers need not wait for the last one's readers
  __shared__ float Pb[2][MID_N][MID_T + 1];
  __shared__ float pinvb[2][MID_T];
  const int ld = n | 1;                // odd: mirrored reads hit all banks
  const int tid = threadIdx.x;
  const int r = tid % MID_T, c = tid / MID_T;
  const size_t nn = (size_t)n * n;
  const float* Kb = K + blockIdx.x * nn;
  float* Fb = F + blockIdx.x * nn;
  for (int row = tid / WARP; row < n; row += MID_T * MID_T / WARP)
    for (int col = tid % WARP; col <= row; col += WARP)
      tri[row * ld + col] = Kb[row * n + col];
  __syncthreads();
  float a[MID_S][MID_S];               // A[r + 16 s][c + 16 t], t <= s
#pragma unroll
  for (int s = 0; s < MID_S; ++s) {
#pragma unroll
    for (int t = 0; t < MID_S; ++t) {
      const int row = r + MID_T * s, col = c + MID_T * t;
      a[s][t] = (t <= s && row < n && col <= row) ? tri[row * ld + col]
                                                  : 0.0f;
    }
  }
#pragma unroll
  for (int jb = 0; jb < MID_S; ++jb) {
    if (MID_T * jb < n) {
      const int p0 = MID_T * jb;       // the panel's first column
      float (*P)[MID_T + 1] = Pb[jb & 1];
      float* pinv = pinvb[jb & 1];
      // 1. the panel, rows p0..127: thread (r, c) holds its column c
#pragma unroll
      for (int s = jb; s < MID_S; ++s) P[r + MID_T * s][c] = a[s][jb];
      __syncthreads();
      // 2. warp 0 factors the diagonal tile, a lane a row (lanes 16-31
      // repeat lanes 0-15), as chol_factor_small does, rows past n padded
      // with the identity's
      if (tid < WARP) {
        const int i = tid % MID_T;
        float d[MID_T], own_inv = 0.0f;  // 1 / L[i][i] of the lane's row
#pragma unroll
        for (int k = 0; k < MID_T; ++k)
          d[k] = p0 + i < n ? (k <= i ? P[p0 + i][k] : 0.0f)
                            : (k == i ? 1.0f : 0.0f);
#pragma unroll
        for (int j = 0; j < MID_T; ++j) {
          const float p = __shfl_sync(FULL, d[j], j);
          const float sq = sqrtf(p);
          const float inv = 1.0f / sq;
          const float lij = d[j] * inv;
#pragma unroll
          for (int k = j + 1; k < MID_T; ++k) {
            const float lkj = __shfl_sync(FULL, lij, k);
            if (k <= i) d[k] -= lij * lkj;
          }
          if (i > j) d[j] = lij;
          else if (i == j) d[j] = sq;
          if (i == j) own_inv = inv;
        }
        // stored after the steps, which stay one straight-line block (a
        // store inside them branches at every step)
        if (tid < MID_T) {
#pragma unroll
          for (int k = 0; k < MID_T; ++k)
            if (k <= i) P[p0 + i][k] = d[k];
          pinv[i] = own_inv;
        }
      }
      __syncthreads();
      // 3. the panel's rows below the tile, a thread a row: column j takes
      // the updates of columns 0..j-1 in order, then the pivot's reciprocal
      for (int i = p0 + MID_T + tid; i < n; i += MID_T * MID_T) {
        float l[MID_T];
#pragma unroll
        for (int j = 0; j < MID_T; ++j) {
          float x = P[i][j];
#pragma unroll
          for (int k = 0; k < j; ++k) x -= l[k] * P[p0 + j][k];
          l[j] = x * pinv[j];
          P[i][j] = l[j];
        }
      }
      __syncthreads();
      // 4. the panel's slots take L; the trailing slots take the panel's
      // 16 rank-1 updates, in column order
#pragma unroll
      for (int s = jb; s < MID_S; ++s) {
        if (c <= r + MID_T * (s - jb)) a[s][jb] = P[r + MID_T * s][c];
      }
#pragma unroll 4
      for (int k = 0; k < MID_T; ++k) {
        float lr[MID_S], lc[MID_S];
#pragma unroll
        for (int s = jb + 1; s < MID_S; ++s) {
          lr[s] = P[r + MID_T * s][k];
          lc[s] = P[c + MID_T * s][k];
        }
#pragma unroll
        for (int s = jb + 1; s < MID_S; ++s) {
#pragma unroll
          for (int t = jb + 1; t <= s; ++t) a[s][t] -= lr[s] * lc[t];
        }
      }
    }
  }
#pragma unroll
  for (int s = 0; s < MID_S; ++s) {
#pragma unroll
    for (int t = 0; t <= s; ++t) {
      const int row = r + MID_T * s, col = c + MID_T * t;
      if (row < n && col <= row) tri[row * ld + col] = a[s][t];
    }
  }
  __syncthreads();
  for (int row = tid / WARP; row < n; row += MID_T * MID_T / WARP)
    for (int col = tid % WARP; col < n; col += WARP)
      Fb[row * n + col] = col <= row ? tri[row * ld + col]
                                     : tri[col * ld + row];
}

__global__ void __launch_bounds__(LARGE_THREADS)
chol_factor_large(const float* __restrict__ K, float* __restrict__ F, int n,
                  int nb) {
  extern __shared__ float panel[];     // panel[t * ld + i] = A[p0 + i][p0 + t]
  const int ld = n | 1;
  const int tid = threadIdx.x;
  const size_t nn = (size_t)n * n;
  const float* Kb = K + blockIdx.x * nn;
  float* Fb = F + blockIdx.x * nn;
  for (int p0 = 0; p0 < n; p0 += nb) {
    const int pw = n - p0 < nb ? n - p0 : nb;
    const int m = n - p0;              // the panel's rows
    const float* src = p0 == 0 ? Kb : Fb;
    __syncthreads();                   // the last trailing update is done
    for (int e = tid; e < m * pw; e += LARGE_THREADS) {
      const int i = e / pw, t = e % pw;
      panel[t * ld + i] = t <= i ? src[(size_t)(p0 + i) * n + p0 + t] : 0.0f;
    }
    // the panel's unblocked factor; column j - 1 is scaled during step j,
    // which does not read it
    float sq = 0.0f, inv = 0.0f;
    for (int j = 0; j < pw; ++j) {
      __syncthreads();
      if (j > 0) {
        for (int i = j - 1 + tid; i < m; i += LARGE_THREADS)
          panel[(j - 1) * ld + i] = i == j - 1 ? sq
                                               : panel[(j - 1) * ld + i] * inv;
      }
      sq = sqrtf(panel[j * ld + j]);
      inv = 1.0f / sq;
      float lk[NB / 4];                // l_k of this thread's columns k
#pragma unroll
      for (int q = 0; q < NB / 4; ++q) {
        const int k = j + 1 + tid / 64 + 4 * q;
        lk[q] = k < pw ? panel[j * ld + k] * inv : 0.0f;
      }
      for (int i = j + 1 + tid % 64; i < m; i += 64) {
        const float li = panel[j * ld + i] * inv;
#pragma unroll
        for (int q = 0; q < NB / 4; ++q) {
          const int k = j + 1 + tid / 64 + 4 * q;
          if (k < pw && k <= i) panel[k * ld + i] -= li * lk[q];
        }
      }
    }
    __syncthreads();
    for (int i = pw - 1 + tid; i < m; i += LARGE_THREADS)
      panel[(pw - 1) * ld + i] = i == pw - 1 ? sq
                                             : panel[(pw - 1) * ld + i] * inv;
    __syncthreads();
    // L's columns p0.. to F, and L^T to rows p0.. (never read again)
    for (int e = tid; e < m * pw; e += LARGE_THREADS) {
      const int i = e / pw, t = e % pw;
      if (t <= i) Fb[(size_t)(p0 + i) * n + p0 + t] = panel[t * ld + i];
    }
    for (int e = tid; e < pw * m; e += LARGE_THREADS) {
      const int t = e / m, i = e % m;
      if (i > t) Fb[(size_t)(p0 + t) * n + p0 + i] = panel[t * ld + i];
    }
    // the trailing triangle: A[i][k] -= sum over the panel of l_i l_k,
    // in the panel's column order
    const int q0 = p0 + pw;
    const int nt = (n - q0 + TILE - 1) / TILE;
    const int ty = tid / 16, tx = tid % 16;
    for (int tr = 0; tr < nt; ++tr) {
      for (int tc = 0; tc <= tr; ++tc) {
        int row[4], col[4], pr[4], pc[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          row[q] = q0 + TILE * tr + ty + 16 * q;
          col[q] = q0 + TILE * tc + tx + 16 * q;
          pr[q] = (row[q] < n ? row[q] : n - 1) - p0;
          pc[q] = (col[q] < n ? col[q] : n - 1) - p0;
        }
        float acc[4][4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
#pragma unroll
          for (int y = 0; y < 4; ++y)
            acc[x][y] = (row[x] < n && col[y] <= row[x])
                            ? src[(size_t)row[x] * n + col[y]] : 0.0f;
        }
        for (int t = 0; t < pw; ++t) {
          const float* pt = panel + t * ld;
          float lr[4], lc[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            lr[q] = pt[pr[q]];
            lc[q] = pt[pc[q]];
          }
#pragma unroll
          for (int x = 0; x < 4; ++x) {
#pragma unroll
            for (int y = 0; y < 4; ++y) acc[x][y] -= lr[x] * lc[y];
          }
        }
#pragma unroll
        for (int x = 0; x < 4; ++x) {
#pragma unroll
          for (int y = 0; y < 4; ++y)
            if (row[x] < n && col[y] <= row[x])
              Fb[(size_t)row[x] * n + col[y]] = acc[x][y];
        }
      }
    }
  }
}

// raise `kernel`'s dynamic shared-memory limit to `bytes` once per device,
// not at every launch (a host call on a host-bound path)
template <typename Kernel>
cudaError_t raise_smem_once(Kernel kernel, size_t bytes, bool* raised) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!raised[device]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return err;
    raised[device] = true;
  }
  return cudaSuccess;
}

}  // namespace

// F = factor of K, both (B, n, n) f32 row-major, on `stream`. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue where n is too
// large for a panel of one column).
extern "C" int chol_factor_launch(const float* K, float* F, int B, int n,
                                  void* stream) {
  if (B == 0 || n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= SMALL_N) {
    chol_factor_small<<<(B + SMALL_MATS - 1) / SMALL_MATS, SMALL_MATS * WARP,
                        0, st>>>(K, F, B, n);
  } else if (n <= MID_N) {
    static bool raised[MAX_DEVICES] = {};
    const cudaError_t err = raise_smem_once(chol_factor_mid, MID_SMEM,
                                            raised);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = (size_t)n * (n | 1) * sizeof(float);
    chol_factor_mid<<<B, MID_T * MID_T, smem, st>>>(K, F, n);
  } else {
    const size_t col = (size_t)(n | 1) * sizeof(float);
    int nb = (int)(SMEM_MAX / col);
    if (nb < 1) return (int)cudaErrorInvalidValue;
    if (nb > NB) nb = NB;
    static bool raised[MAX_DEVICES] = {};
    const cudaError_t err = raise_smem_once(chol_factor_large, SMEM_MAX,
                                            raised);
    if (err != cudaSuccess) return (int)err;
    chol_factor_large<<<B, LARGE_THREADS, nb * col, st>>>(K, F, n, nb);
  }
  return (int)cudaGetLastError();
}
