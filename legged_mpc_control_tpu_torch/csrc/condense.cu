// The condensed QP's build: the Hessian P and the linear term q of
// mpc/qp_builder.py's build_condensed_qp, straight from the per-step
// factors, in float64, P written once.
//
// Replaces: no Pallas kernel. The JAX package builds P = S^T Q S as a dense
//           matrix product (legged_mpc_control_tpu/mpc/qp_builder.py); on
//           the card that product and the elementwise passes that make S
//           moved ~50 GB a tick at B = 4096, H = 30.
// Plain version: legged_mpc_control_tpu_torch/ops/condense_kernel.py,
//           condense_plain (those torch operations).
//
// The QP. B scenarios, horizon H, n = 12H forces. Per scenario: x0 (12),
// x_ref (H, 12), A_seq (H, 12, 12), Bm (12, 12), contact (H, 4), the
// diagonal weights Q, R (12 each). Write Mc_k = sum_{m<=k} A_m[0:3, 6:9] / dt,
// and Bt_j, Bf_j for Bm's rows 6:9 and 9:12 with the columns of the legs in
// swing at step j zeroed. The condensed S[k, j] (k >= j) has rows
// dt (Mc_k - Mc_j) Bt_j, dt (k - j) Bf_j, Bt_j, Bf_j, so with m = max(j1, j2)
// and n_m = H - m:
//
//   P[j1,j2] = Bt_j1^T (dt^2 W + n_m Q69) Bt_j2 + Bf_j1^T (n_m Q912
//              + dt^2 s Q36) Bf_j2 + [j1 == j2] R
//   W        = sum_{k>=m} (Mc_k - Mc_j1)^T Q03 (Mc_k - Mc_j2)       (3 x 3)
//   s        = sum_{k>=m} (k - j1) (k - j2)                        (an integer)
//   q_j      = dt Bt_j^T sum_{k>=j} (Mc_k - Mc_j)^T Q03 r_k[0:3]
//              + dt Bf_j^T Q36 sum_{k>=j} (k - j) r_k[3:6]
//              + Bt_j^T Q69 sum_{k>=j} r_k[6:9] + Bf_j^T Q912 sum_{k>=j} r_k[9:12]
//
// with r = c - x_ref, c the free evolution of x0 (qp_builder.py). Layouts
// are batch-first, row-major; Q and R are (12) rows at a stride of 0 (shared)
// or 12 (a scenario each). P (B, n, n) and q (B, n) are written whole.
//
// Arithmetic. Every sum and product in float64 from the float32 inputs, W
// summed over k directly (no difference of suffix sums, which would
// cancel), R added before the one rounding to float32. Each entry of P and
// its transposed twin come from the same float64 operations (below), so P
// is exactly symmetric.
//
// What bounds it on an H100: bytes. P is n^2 floats a scenario, 2.12 GB at
// B = 4096, H = 30: 0.64 ms at 3.35 TB/s; everything read is (B, H, <= 144).
// Design: a block of eight warps a scenario. It stages Bm's rows 6:12, the
// contact mask, Q, R, x_ref and M_k = A_k[0:3, 6:9] / dt in shared memory in
// float64 (Mc their running sums, Y the masked Bm columns of every step) and
// the residuals r_k; then the warps take items, with no barrier of the block:
//   - q: two steps j an item, a lane one of q_j's twelve residual sums;
//   - two tiles of 2 x 2 block pairs (j1, j2), j1 <= j2 (24 x 24 entries
//     of P's upper triangle a tile):
//     A. G(j1, j2) = [dt^2 W + n_m Q69 | n_m Q912 + dt^2 s Q36] of each
//        pair: a lane a row of W, its three sums over k side by side;
//     B. the entries: a lane three columns c2 of a pair, with v = (G_t y,
//        g_f * y_f) of each column's y = Y[j2][c2] in registers, and each
//        entry Y[j1][c1] . v, a six-term FMA chain, into the tile in shared
//        memory (float); a diagonal block's upper half mirrored;
//     C. the tile's rows into P, and its columns as the rows of the twin
//        tile below the diagonal: 16 bytes a lane, consecutive lanes along
//        a row, 96 bytes a row.
// Each entry is computed once and written to both places, so P is exactly
// symmetric. Shared memory: 108 + 97 H doubles and 5.5 KB a warp (69 KB at
// H = 30, three blocks an SM; 96 KB at MAX_H = 64).

#include <cuda_runtime.h>

namespace {

constexpr int MAX_H = 64;          // the largest horizon shared memory takes
constexpr int MAX_DEVICES = 64;    // devices whose shared-memory limit is set
constexpr int NX = 12;             // states, and forces a step

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILES = 2;           // tiles of 2 x 2 block pairs a warp takes
constexpr int PAIRS = 4 * TILES;
constexpr int TW = 24;             // a tile's width
constexpr int OS = TW + 1;         // its row stride in shared memory, floats
// a warp's scratch, in doubles: G (PAIRS x 12), the tiles (TILES x TW x OS
// floats), the pairs' steps and the tiles' (ints)
constexpr int SCRATCH = PAIRS * 12 + (TILES * TW * OS + 1) / 2
                        + PAIRS + TILES;

// shared memory, in doubles: bm (72), qv, rv, y0 (12 each), the warps'
// scratch, then per step msk (4), Mc (9), R (12), Y (72)
constexpr int smem_doubles(int H) { return 108 + WARPS * SCRATCH + 97 * H; }

struct Args {
  const float* x0;       // (B, 12)
  const float* xref;     // (B, H, 12)
  const float* A;        // (B, H, 12, 12)
  const float* Bm;       // (B, 12, 12)
  const float* contact;  // (B, H, 4)
  const float* qw;       // (B, 12) at stride qs, 0 or 12
  const float* rw;       // (B, 12) at stride rs
  float* P;              // (B, 12H, 12H)
  float* q;              // (B, 12H)
  int qs, rs, H;
  double dt, gdt;        // the MPC step, gravity * dt
};

// the block pair (j1, j2), j1 <= j2, of index p = j2 (j2 + 1) / 2 + j1
__device__ __forceinline__ void pair_of(int p, int* j1, int* j2) {
  int j = (int)((sqrtf(8.0f * p + 1.0f) - 1.0f) * 0.5f);
  while (j * (j + 1) / 2 > p) --j;
  while ((j + 1) * (j + 2) / 2 <= p) ++j;
  *j2 = j;
  *j1 = p - j * (j + 1) / 2;
}

__global__ void __launch_bounds__(THREADS, 3)
condense_kernel(const Args p) {
  extern __shared__ double smem[];
  const int H = p.H, n = NX * H, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const long b = blockIdx.x;
  double* bm = smem;                 // Bm rows 6:12, (6, 12)
  double* qv = smem + 72;
  double* rv = smem + 84;
  double* y0 = smem + 96;            // A_0 x0
  double* scr = smem + 108;          // the warps' scratch; M_k in step 0
  double* msk = scr + WARPS * SCRATCH;   // contact, (H, 4)
  double* Mc = msk + 4 * H;          // (H, 9)
  double* R = Mc + 9 * H;            // x_ref, then the residuals, (H, 12)
  double* Y = R + 12 * H;            // Bm[6:12, c] masked at step j, (H, 12, 6)
  const double dt = p.dt, dt2 = dt * dt;
  const float* A = p.A + b * 144L * H;
  float* P = p.P + b * (long)n * n;

  // 0. the inputs, M_k = A_k[0:3, 6:9] / dt (in the scratch), A_0 x0
  for (int i = tid; i < 72; i += THREADS) bm[i] = p.Bm[b * 144 + 72 + i];
  for (int i = tid; i < 4 * H; i += THREADS)
    msk[i] = p.contact[b * 4L * H + i];
  for (int i = tid; i < n; i += THREADS) R[i] = p.xref[b * n + i];
  for (int i = tid; i < 9 * H; i += THREADS) {
    const int k = i / 9, e = i % 9;
    scr[i] = (double)A[144 * k + NX * (e / 3) + 6 + e % 3] / dt;
  }
  if (tid < NX) {
    qv[tid] = p.qw[b * p.qs + tid];
    rv[tid] = p.rw[b * p.rs + tid];
    double y = 0.0;
    for (int j = 0; j < NX; ++j)
      y = fma((double)A[NX * tid + j], (double)p.x0[b * NX + j], y);
    y0[tid] = y;
  }
  __syncthreads();
  // 1. Mc_k, M's running sums (an entry a thread, in a cumulative sum's
  // order), and Y
  for (int i = tid; i < 9 * H; i += THREADS) {
    double acc = scr[i % 9];
    for (int m = 9 + i % 9; m <= i; m += 9) acc += scr[m];
    Mc[i] = acc;
  }
  for (int i = tid; i < 72 * H; i += THREADS) {
    const int e = i % 6, c = (i / 6) % 12, j = i / 72;
    Y[i] = bm[12 * e + c] * msk[4 * j + c / 3];
  }
  __syncthreads();
  // 2. the residuals r_k = c_k - x_ref_k
  for (int t = tid; t < n; t += THREADS) {
    const int k = t / 12, i = t % 12;
    double c = y0[i];
    if (i < 3) {
      double m = (Mc[9 * k + 3 * i] - Mc[3 * i]) * y0[6];
      m = fma(Mc[9 * k + 3 * i + 1] - Mc[3 * i + 1], y0[7], m);
      m = fma(Mc[9 * k + 3 * i + 2] - Mc[3 * i + 2], y0[8], m);
      c += dt * m;
    } else if (i < 6) {
      c += dt * k * y0[i + 6];
    }
    if (i == 5) c += -p.gdt * dt * k * (k + 1.0) / 2.0;
    if (i == 11) c += -(k + 1.0) * p.gdt;
    R[t] = c - R[t];
  }
  __syncthreads();

  // 3. the warps' work, no barrier of the block: q, two steps an item, then
  // the tiles (I <= J), TILES at a time in the order of (J, I). Each entry
  // of the upper triangle is computed once, into its tile in shared memory,
  // and written from there to both places.
  double* G = scr + warp * SCRATCH;  // (PAIRS, 12)
  float* Ob = reinterpret_cast<float*>(G + PAIRS * 12);   // (TILES, TW, OS)
  int* js = reinterpret_cast<int*>(G + SCRATCH - PAIRS - TILES);  // (PAIRS, 2)
  int* ts = js + 2 * PAIRS;          // (TILES, 2)
  const int H2 = (H + 1) / 2, ntile = H2 * (H2 + 1) / 2;
  for (int item = warp; item < H2 + (ntile + TILES - 1) / TILES;
       item += WARPS) {
    if (item < H2) {                 // q_j: its twelve residual sums, then q
      const int j = 2 * item + lane / 16, l = lane % 16;
      const bool on = l < NX && j < H;
      if (on) {
        const int grp = l / 3, a = l % 3;
        double acc = 0.0;
        for (int k = j; k < H; ++k) {
          if (grp == 0) {
            for (int s = 0; s < 3; ++s)
              acc = fma((Mc[9 * k + 3 * s + a] - Mc[9 * j + 3 * s + a])
                        * qv[s], R[NX * k + s], acc);
          } else if (grp == 1) {
            acc = fma((double)(k - j), R[NX * k + 3 + a], acc);
          } else {
            acc += R[NX * k + 3 * grp + a];
          }
        }
        G[lane] = acc;
      }
      __syncwarp();
      if (on) {
        const double* y = Y + 72 * j + 6 * l;
        const double* g = G + 16 * (lane / 16);
        double acc = 0.0;
        for (int a = 0; a < 3; ++a) {
          acc = fma(y[a], dt * g[a], acc);
          acc = fma(y[3 + a], dt * qv[3 + a] * g[3 + a], acc);
          acc = fma(y[a], qv[6 + a] * g[6 + a], acc);
          acc = fma(y[3 + a], qv[9 + a] * g[9 + a], acc);
        }
        p.q[b * n + NX * j + l] = (float)acc;
      }
      __syncwarp();
      continue;
    }
    // TILES tiles (I, J), I <= J, each of block rows 2I, 2I + 1 and block
    // columns 2J, 2J + 1 (I = -1: none), and their pairs (j1, j2) with
    // j1 <= j2 (j1 = -1: none)
    if (lane < TILES) {
      const int tile = TILES * (item - H2) + lane;
      if (tile < ntile) {
        pair_of(tile, ts + 2 * lane, ts + 2 * lane + 1);
      } else {
        ts[2 * lane] = -1;
      }
    }
    __syncwarp();
    if (lane < PAIRS) {
      const int I = ts[2 * (lane / 4)], J = ts[2 * (lane / 4) + 1];
      const int j1 = 2 * I + lane % 4 / 2, j2 = 2 * J + lane % 2;
      const bool ok = I >= 0 && j1 < H && j2 < H && j1 <= j2;
      js[2 * lane] = ok ? j1 : -1;
      js[2 * lane + 1] = j2;
    }
    __syncwarp();
    // A. G = [dt^2 W + n_m Q69 | n_m Q912 + dt^2 s Q36] of each pair: a
    // lane a row a of W (three sums over k side by side), a lane g_f
    if (lane < 4 * PAIRS) {
      const int pp = lane < 3 * PAIRS ? lane / 3 : lane - 3 * PAIRS;
      const int j1 = js[2 * pp], j2 = js[2 * pp + 1];
      const double nm = H - j2;
      if (j1 < 0) {
      } else if (lane < 3 * PAIRS) {
        const int a = lane % 3;
        double w[3] = {0.0, 0.0, 0.0};
        for (int k = j2; k < H; ++k)
          for (int s = 0; s < 3; ++s) {
            const double* mk = Mc + 9 * k + 3 * s;
            const double d = (mk[a] - Mc[9 * j1 + 3 * s + a]) * qv[s];
            for (int c = 0; c < 3; ++c)
              w[c] = fma(d, mk[c] - Mc[9 * j2 + 3 * s + c], w[c]);
          }
        for (int c = 0; c < 3; ++c) {
          double v = dt2 * w[c];
          if (a == c) v += nm * qv[6 + a];
          G[12 * pp + 3 * a + c] = v;
        }
      } else {
        long sk = 0;
        for (int k = j2; k < H; ++k) sk += (long)(k - j1) * (k - j2);
        for (int a = 0; a < 3; ++a)
          G[12 * pp + 9 + a] = nm * qv[9 + a] + dt2 * (double)sk * qv[3 + a];
      }
    }
    __syncwarp();
    // B. the entries into the tile: a lane three columns c2 = c0, c0 + 4,
    // c0 + 8 of a pair, with v = (G_t y, g_f * y_f) of each column's
    // y = Y[j2][c2] in registers, and each entry Y[j1][c1] . v, R on the
    // diagonal; on a diagonal tile the upper entries, each also at its
    // twin's place
    for (int id = lane; id < 4 * PAIRS; id += 32) {
      const int pp = id / 4, c0 = id % 4;
      const int j1 = js[2 * pp], j2 = js[2 * pp + 1];
      if (j1 < 0) continue;
      const double* g = G + 12 * pp;
      double v[3][6];
      for (int i = 0; i < 3; ++i) {
        const double* yh = Y + 72 * j2 + 6 * (c0 + 4 * i);
        for (int a = 0; a < 3; ++a) {
          double t = g[3 * a] * yh[0];
          t = fma(g[3 * a + 1], yh[1], t);
          v[i][a] = fma(g[3 * a + 2], yh[2], t);
          v[i][3 + a] = g[9 + a] * yh[3 + a];
        }
      }
      const int tr = NX * (pp % 4 / 2), tc = NX * (pp % 2) + c0;
      const bool diag = ts[2 * (pp / 4)] == ts[2 * (pp / 4) + 1];
      float* ob = Ob + TW * OS * (pp / 4);
      const int last = j1 == j2 ? c0 + 8 : NX - 1;
      for (int c1 = 0; c1 <= last; ++c1) {
        const double* yl = Y + 72 * j1 + 6 * c1;
        double x[3];
        for (int i = 0; i < 3; ++i) x[i] = yl[0] * v[i][0];
        for (int e = 1; e < 6; ++e) {
          const double y = yl[e];
          for (int i = 0; i < 3; ++i) x[i] = fma(y, v[i][e], x[i]);
        }
        for (int i = 0; i < 3; ++i) {
          const int c2 = c0 + 4 * i;
          if (j1 == j2 && c1 > c2) continue;
          if (j1 == j2 && c1 == c2) x[i] += rv[c1];
          ob[OS * (tr + c1) + tc + 4 * i] = (float)x[i];
          if (diag) ob[OS * (tc + 4 * i) + tr + c1] = (float)x[i];
        }
      }
    }
    __syncwarp();
    // C. each tile's rows into P, then (I < J) its columns as the rows of
    // the twin tile (J, I): 16 bytes a lane, consecutive lanes along a row
    int nd[TILES], nt[TILES], total = 0;
    for (int t = 0; t < TILES; ++t) {
      const int I = ts[2 * t], J = ts[2 * t + 1];
      const int rows = 2 * I + 1 < H ? TW : NX, cols = 2 * J + 1 < H ? TW : NX;
      nd[t] = I < 0 ? 0 : rows * (cols / 4);
      nt[t] = I < 0 || I == J ? 0 : cols * (rows / 4);
      total += nd[t] + nt[t];
    }
    for (int id = lane; id < total; id += 32) {
      int t = 0, u = id;
      while (u >= nd[t] + nt[t]) {
        u -= nd[t] + nt[t];
        ++t;
      }
      const int I = ts[2 * t], J = ts[2 * t + 1];
      const int rows = 2 * I + 1 < H ? TW : NX, cols = 2 * J + 1 < H ? TW : NX;
      const float* ob = Ob + TW * OS * t;
      float4 v4;
      long at;
      if (u < nd[t]) {
        const int r = cols == TW ? u / 6 : u / 3;
        const int c4 = 4 * (u - r * (cols / 4));
        const float* o = ob + OS * r + c4;
        v4.x = o[0];
        v4.y = o[1];
        v4.z = o[2];
        v4.w = o[3];
        at = (long)(TW * I + r) * n + TW * J + c4;
      } else {
        u -= nd[t];
        const int r = rows == TW ? u / 6 : u / 3;
        const int c4 = 4 * (u - r * (rows / 4));
        const float* o = ob + OS * c4 + r;
        v4.x = o[0];
        v4.y = o[OS];
        v4.z = o[2 * OS];
        v4.w = o[3 * OS];
        at = (long)(TW * J + r) * n + TW * I + c4;
      }
      *reinterpret_cast<float4*>(P + at) = v4;
    }
    __syncwarp();
  }
}

}  // namespace

// The largest horizon the kernel takes (its shared memory's).
extern "C" int condense_max_h() { return MAX_H; }

// P and q of B scenarios of horizon H on `stream` (see the top of the
// file); qs, rs the strides of Q's and R's rows (0 or 12); g gravity.
// Returns cudaErrorInvalidValue for H outside 1..MAX_H, else
// cudaGetLastError() after the launch.
extern "C" int condense_launch(const float* x0, const float* xref,
                               const float* A, const float* Bm,
                               const float* contact, const float* qw,
                               const float* rw, int qs, int rs, float* P,
                               float* q, int B, int H, double dt, double g,
                               void* stream) {
  if (H < 1 || H > MAX_H) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const Args a{x0, xref, A, Bm, contact, qw, rw, P, q, qs, rs, H, dt, g * dt};
  // the limit of dynamic shared memory raised to MAX_H's once a device
  static bool raised[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  if (device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!raised[device]) {
    e = cudaFuncSetAttribute(condense_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_doubles(MAX_H) * (int)sizeof(double));
    if (e != cudaSuccess) return (int)e;
    raised[device] = true;
  }
  const int smem = smem_doubles(H) * (int)sizeof(double);
  condense_kernel<<<(unsigned)B, THREADS, smem,
                    (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
