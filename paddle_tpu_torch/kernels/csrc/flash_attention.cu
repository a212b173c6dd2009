// Flash attention for Hopper (sm_90a), float32: forward, dK/dV backward and
// dQ backward.
//
// Replaces the three Pallas TPU kernels of
// paddle_tpu/ops/pallas/flash_attention.py:
//
//   flash_attention_fwd_f32       <- `_fwd_impl`,  pallas_call at :167
//                                    (body `_attention_kernel`, :42)
//   flash_attention_bwd_dkdv_f32  <- `_flash_bwd`, pallas_call at :378
//                                    (body `_bwd_dkdv_kernel`, :197)
//   flash_attention_bwd_dq_f32    <- `_flash_bwd`, pallas_call at :419
//                                    (body `_bwd_dq_kernel`, :265)
//
// q, k, v, o, do, dq, dk, dv are [BH, S, D] (BH = B * H heads, contiguous);
// bias is an optional additive key bias [B, S] shared by the H heads of a
// batch row; lse and delta (= rowsum(dO * O), computed by the caller) are
// [BH, S]; dbias is the per-(b, h) key-bias grad [BH, S], summed over the
// queries (the caller sums the heads). Scores are
//
//   s[r, c] = q[r] . k[c] * scale + bias[c],   s = -1e30 where causal and c > r,
//
// O = softmax(s) V with the running max m, normaliser l and accumulator in
// registers, LSE = m + log(l) (l == 0 counts as 1, O = 0 there, as :89-91).
// The backward recomputes p = exp(s - lse), 0 where lse <= -5e29
// (:230-232), dV = P^T dO, dS = P * (dO V^T - delta), dK = dS^T Q * scale,
// dQ = dS K * scale, dbias = colsum(dS).
//
// Bound. At BERT-base's training shapes (B=32, H=12, S=128, D=64) each of
// the three does 4-8 * B*H*S^2*D float32 FLOPs against about 13 MB per
// operand, so the work, not the memory, bounds them: about 0.024 ms
// (forward), 0.048 ms (dK/dV) and 0.036 ms (dQ) at 67 TFLOP/s of FFMA.
//
// Design. The TPU kernels run a sequential grid with whole K/V rows in VMEM
// and blocks of 128. Here blocks run in parallel on 132 SMs and nothing
// crosses blocks: the forward and dQ kernels take one block per (head,
// tile of 32 query rows) and loop over tiles of 64 keys; the dK/dV kernel
// takes one block per (head, tile of 32 keys) and loops over tiles of 64
// queries, so it needs no atomics and is deterministic. At S=128 that is
// 1536 blocks of 128 threads each. Every tile is staged in shared memory
// (with the operand of each product stored transposed, so a thread reads
// four neighbouring values as one 16-byte vector), and each thread owns a
// 4 x 4 micro-tile of the score tile and 4 rows of the accumulators
// (columns tx*4 + 64*j of D). Row maxima and sums of the online softmax
// are reduced with shuffles across the 16 threads that share a row.
// Products run as FFMA (no tensor cores): a right first kernel; wgmma/TMA
// and bf16 come later. Causal masking follows `cols <= rows` and skips the
// key (or query) tiles that the mask removes whole (:84-86, :253-256,
// :307-310). Any S works: rows and keys at or past S are zero-filled in
// shared memory and masked, and nothing is written for them. D is a
// multiple of 4 up to 128.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;       // kTy x kTx threads, a 4 x 4 tile each
constexpr int kTx = 16;
constexpr int kRows = 32;           // rows of a block's tile (4 * kTy)
constexpr int kCols = 64;           // columns of a streamed tile (4 * kTx)
constexpr int kMaxD = 128;
constexpr int kJ = kMaxD / 64;      // accumulator column groups per thread
constexpr float kNeg = -1e30f;
constexpr float kDeadLse = -5e29f;  // lse of a row with no live key

constexpr int kLdRows = kRows + 4;  // leading dims of transposed tiles
constexpr int kLdCols = kCols + 4;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// dst[d * ld + r] = src[(row0 + r) * D + d] for r < n, zero past S.
__device__ void load_transposed(float* dst, int ld, const float* src, int row0,
                                int n, int S, int D) {
  const int d4s = D / 4;
  for (int i = threadIdx.x; i < n * d4s; i += kThreads) {
    const int r = i / d4s, d = (i % d4s) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S) v = ld4(src + static_cast<size_t>(row0 + r) * D + d);
    dst[(d + 0) * ld + r] = v.x;
    dst[(d + 1) * ld + r] = v.y;
    dst[(d + 2) * ld + r] = v.z;
    dst[(d + 3) * ld + r] = v.w;
  }
}

// dst[r * ld + d] = src[(row0 + r) * D + d] for r < n, zero past S.
__device__ void load_rows(float* dst, int ld, const float* src, int row0,
                          int n, int S, int D) {
  const int d4s = D / 4;
  for (int i = threadIdx.x; i < n * d4s; i += kThreads) {
    const int r = i / d4s, d = (i % d4s) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < S) v = ld4(src + static_cast<size_t>(row0 + r) * D + d);
    *reinterpret_cast<float4*>(dst + r * ld + d) = v;
  }
}

// Reductions over the 16 threads (tx) that share a row group: lanes
// 0-15 and 16-31 of a warp.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[i][4j+e] += a[i] * src[c * ld + 64j + tx*4 + e] over the 4 rows i a
// thread owns, for the column groups inside D.
__device__ __forceinline__ void rank1_update(float (&acc)[4][4 * kJ],
                                             const float4& a, const float* src,
                                             int tx, int D) {
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int col = 64 * j + tx * 4;
    if (col < D) {
      const float4 b = ld4(src + col);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ai = comp(a, i);
        acc[i][4 * j + 0] += ai * b.x;
        acc[i][4 * j + 1] += ai * b.y;
        acc[i][4 * j + 2] += ai * b.z;
        acc[i][4 * j + 3] += ai * b.w;
      }
    }
  }
}

// out[(row0 + 4ty + i) * D + col] = acc[i][...] * mul for rows below S.
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[4][4 * kJ],
                                           const float (&mul)[4], int row0,
                                           int ty, int tx, int S, int D) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int col = 64 * j + tx * 4;
      if (col < D)
        *reinterpret_cast<float4*>(out + static_cast<size_t>(row) * D + col) =
            make_float4(acc[i][4 * j] * mul[i], acc[i][4 * j + 1] * mul[i],
                        acc[i][4 * j + 2] * mul[i], acc[i][4 * j + 3] * mul[i]);
    }
  }
}

// ---- K1: forward ---------------------------------------------------------
// Block: (head, 32 query rows). Shared: Qt [D][36], Kt [D][68], V [64][D+4],
// Pt [64][36].
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ o, float* __restrict__ lse, int H, int S,
                 int D, float scale, int causal) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldv = D + 4;
  float* Qt = smem;
  float* Kt = Qt + D * kLdRows;
  float* Vs = Kt + D * kLdCols;
  float* Pt = Vs + kCols * ldv;

  const int n_qt = (S + kRows - 1) / kRows;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * kRows;
  const int tid = threadIdx.x, ty = tid / kTx, tx = tid % kTx;
  const size_t base = static_cast<size_t>(bh) * S * D;
  const float* brow = bias ? bias + static_cast<size_t>(bh / H) * S : nullptr;

  load_transposed(Qt, kLdRows, q + base, q0, kRows, S, D);

  float m[4], l[4], acc[4][4 * kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kJ; ++c) acc[i][c] = 0.f;
  }

  int n_kt = (S + kCols - 1) / kCols;
  if (causal) n_kt = min(n_kt, (q0 + kRows + kCols - 1) / kCols);
  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * kCols;
    __syncthreads();  // the previous tile's readers are done
    load_transposed(Kt, kLdCols, k + base, k0, kCols, S, D);
    load_rows(Vs, ldv, v + base, k0, kCols, S, D);
    __syncthreads();

    float s[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = ld4(Qt + d * kLdRows + ty * 4);
      const float4 b = ld4(Kt + d * kLdCols + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ai = comp(a, i);
        s[i][0] += ai * b.x;
        s[i][1] += ai * b.y;
        s[i][2] += ai * b.z;
        s[i][3] += ai * b.w;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        float x = s[i][j] * scale;
        if (col >= S) {
          x = -INFINITY;  // exp() gives 0 exactly: the key does not exist
        } else {
          if (brow) x += brow[col];
          if (causal && col > row) x = kNeg;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Pt[(tx * 4 + j) * kLdRows + ty * 4 + i] = p;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kJ; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    const int n_c = min(kCols, S - k0);
    for (int c = 0; c < n_c; ++c)
      rank1_update(acc, ld4(Pt + c * kLdRows + ty * 4), Vs + c * ldv, tx, D);
  }

  float inv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    inv[i] = 1.f / l_safe;
    const int row = q0 + ty * 4 + i;
    if (tx == 0 && row < S) lse[static_cast<size_t>(bh) * S + row] = m[i] + logf(l_safe);
  }
  store_rows(o + base, acc, inv, q0, ty, tx, S, D);
}

// ---- K2b: dQ --------------------------------------------------------------
// Block: (head, 32 query rows). Shared: Qt, dOt [D][36], Kt, Vt [D][68],
// K [64][D+4], dSt [64][36].
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ bias,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int H, int S, int D, float scale, int causal) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldk = D + 4;
  float* Qt = smem;
  float* dOt = Qt + D * kLdRows;
  float* Kt = dOt + D * kLdRows;
  float* Vt = Kt + D * kLdCols;
  float* Ks = Vt + D * kLdCols;
  float* dSt = Ks + kCols * ldk;

  const int n_qt = (S + kRows - 1) / kRows;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * kRows;
  const int tid = threadIdx.x, ty = tid / kTx, tx = tid % kTx;
  const size_t base = static_cast<size_t>(bh) * S * D;
  const float* brow = bias ? bias + static_cast<size_t>(bh / H) * S : nullptr;

  load_transposed(Qt, kLdRows, q + base, q0, kRows, S, D);
  load_transposed(dOt, kLdRows, dout + base, q0, kRows, S, D);
  float row_lse[4], row_delta[4], acc[4][4 * kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    row_lse[i] = row < S ? lse[static_cast<size_t>(bh) * S + row] : kNeg;
    row_delta[i] = row < S ? delta[static_cast<size_t>(bh) * S + row] : 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kJ; ++c) acc[i][c] = 0.f;
  }

  int n_kt = (S + kCols - 1) / kCols;
  if (causal) n_kt = min(n_kt, (q0 + kRows + kCols - 1) / kCols);
  for (int t = 0; t < n_kt; ++t) {
    const int k0 = t * kCols;
    __syncthreads();
    load_transposed(Kt, kLdCols, k + base, k0, kCols, S, D);
    load_transposed(Vt, kLdCols, v + base, k0, kCols, S, D);
    load_rows(Ks, ldk, k + base, k0, kCols, S, D);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = ld4(Qt + d * kLdRows + ty * 4);
      const float4 g = ld4(dOt + d * kLdRows + ty * 4);
      const float4 b = ld4(Kt + d * kLdCols + tx * 4);
      const float4 w = ld4(Vt + d * kLdCols + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ai = comp(a, i), gi = comp(g, i);
        s[i][0] += ai * b.x;
        s[i][1] += ai * b.y;
        s[i][2] += ai * b.z;
        s[i][3] += ai * b.w;
        dp[i][0] += gi * w.x;
        dp[i][1] += gi * w.y;
        dp[i][2] += gi * w.z;
        dp[i][3] += gi * w.w;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        float p = 0.f;
        if (col < S && row_lse[i] > kDeadLse) {
          float x = s[i][j] * scale;
          if (brow) x += brow[col];
          if (causal && col > row) x = kNeg;
          p = expf(x - row_lse[i]);
        }
        dSt[(tx * 4 + j) * kLdRows + ty * 4 + i] = p * (dp[i][j] - row_delta[i]);
      }
    }
    __syncthreads();
    const int n_c = min(kCols, S - k0);
    for (int c = 0; c < n_c; ++c)
      rank1_update(acc, ld4(dSt + c * kLdRows + ty * 4), Ks + c * ldk, tx, D);
  }
  const float mul[4] = {scale, scale, scale, scale};
  store_rows(dq + base, acc, mul, q0, ty, tx, S, D);
}

// ---- K2a: dK, dV, dbias ---------------------------------------------------
// Block: (head, 32 keys). Shared: Kt, Vt [D][36], Qt, dOt [D][68],
// Q, dO [64][D+4], P, dS [64][36] (query-major, 4 keys per 16 bytes).
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ bias,
                      const float* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, float* __restrict__ dbias, int H,
                      int S, int D, float scale, int causal) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ldq = D + 4;
  float* Kt = smem;
  float* Vt = Kt + D * kLdRows;
  float* Qt = Vt + D * kLdRows;
  float* dOt = Qt + D * kLdCols;
  float* Qs = dOt + D * kLdCols;
  float* dOs = Qs + kCols * ldq;
  float* Ps = dOs + kCols * ldq;
  float* dSs = Ps + kCols * kLdRows;

  const int n_kt = (S + kRows - 1) / kRows;
  const int bh = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x % n_kt) * kRows;
  const int tid = threadIdx.x, ty = tid / kTx, tx = tid % kTx;
  const size_t base = static_cast<size_t>(bh) * S * D;
  const float* brow = bias ? bias + static_cast<size_t>(bh / H) * S : nullptr;
  const float* lse_h = lse + static_cast<size_t>(bh) * S;
  const float* delta_h = delta + static_cast<size_t>(bh) * S;

  load_transposed(Kt, kLdRows, k + base, k0, kRows, S, D);
  load_transposed(Vt, kLdRows, v + base, k0, kRows, S, D);
  float key_bias[4], dk_acc[4][4 * kJ], dv_acc[4][4 * kJ], db[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    key_bias[i] = (brow && key < S) ? brow[key] : 0.f;
    db[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kJ; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  }

  const int n_qt = (S + kCols - 1) / kCols;
  const int t0 = causal ? k0 / kCols : 0;  // earlier query tiles see no key here
  for (int t = t0; t < n_qt; ++t) {
    const int q0 = t * kCols;
    __syncthreads();
    load_transposed(Qt, kLdCols, q + base, q0, kCols, S, D);
    load_transposed(dOt, kLdCols, dout + base, q0, kCols, S, D);
    load_rows(Qs, ldq, q + base, q0, kCols, S, D);
    load_rows(dOs, ldq, dout + base, q0, kCols, S, D);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = ld4(Kt + d * kLdRows + ty * 4);
      const float4 w = ld4(Vt + d * kLdRows + ty * 4);
      const float4 b = ld4(Qt + d * kLdCols + tx * 4);
      const float4 g = ld4(dOt + d * kLdCols + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ai = comp(a, i), wi = comp(w, i);
        s[i][0] += ai * b.x;
        s[i][1] += ai * b.y;
        s[i][2] += ai * b.z;
        s[i][3] += ai * b.w;
        dp[i][0] += wi * g.x;
        dp[i][1] += wi * g.y;
        dp[i][2] += wi * g.z;
        dp[i][3] += wi * g.w;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = q0 + tx * 4 + j;
      const float r_lse = row < S ? lse_h[row] : kNeg;
      const float r_delta = row < S ? delta_h[row] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + ty * 4 + i;
        float p = 0.f;
        if (key < S && r_lse > kDeadLse) {
          float x = s[i][j] * scale + key_bias[i];
          if (causal && key > row) x = kNeg;
          p = expf(x - r_lse);
        }
        const float ds = p * (dp[i][j] - r_delta);
        db[i] += ds;
        Ps[(tx * 4 + j) * kLdRows + ty * 4 + i] = p;
        dSs[(tx * 4 + j) * kLdRows + ty * 4 + i] = ds;
      }
    }
    __syncthreads();
    const int n_r = min(kCols, S - q0);
    for (int r = 0; r < n_r; ++r) {
      rank1_update(dv_acc, ld4(Ps + r * kLdRows + ty * 4), dOs + r * ldq, tx, D);
      rank1_update(dk_acc, ld4(dSs + r * kLdRows + ty * 4), Qs + r * ldq, tx, D);
    }
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  const float mul[4] = {scale, scale, scale, scale};
  store_rows(dv + base, dv_acc, one, k0, ty, tx, S, D);
  store_rows(dk + base, dk_acc, mul, k0, ty, tx, S, D);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float total = row_sum(db[i]);
    const int key = k0 + ty * 4 + i;
    if (dbias && tx == 0 && key < S) dbias[static_cast<size_t>(bh) * S + key] = total;
  }
}

// Dynamic shared memory past 48 KB must be allowed per kernel first.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

bool bad_shape(int BH, int H, int S, int D) {
  return BH <= 0 || H <= 0 || BH % H != 0 || S <= 0 || D <= 0 || D % 4 != 0 ||
         D > kMaxD;
}

}  // namespace

extern "C" {

// Each entry point launches one kernel on `stream` (a cudaStream_t) and
// returns cudaGetLastError() as an int (0 = launched). Pointers are device
// pointers to contiguous float32 arrays, 16-byte aligned; bias (and with it
// dbias) may be null. D must be a multiple of 4 up to 128.

int flash_attention_fwd_f32(const float* q, const float* k, const float* v,
                            const float* bias, float* o, float* lse, int BH,
                            int H, int S, int D, float scale, int causal,
                            void* stream) {
  if (bad_shape(BH, H, S, D)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (D * kLdRows + D * kLdCols +
                                       kCols * (D + 4) + kCols * kLdRows);
  int err = allow_smem(flash_fwd_kernel, smem);
  if (err) return err;
  const long long blocks = static_cast<long long>(BH) * ((S + kRows - 1) / kRows);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_fwd_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      q, k, v, bias, o, lse, H, S, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

int flash_attention_bwd_dq_f32(const float* q, const float* k, const float* v,
                               const float* bias, const float* dout,
                               const float* lse, const float* delta, float* dq,
                               int BH, int H, int S, int D, float scale,
                               int causal, void* stream) {
  if (bad_shape(BH, H, S, D)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (2 * D * kLdRows + 2 * D * kLdCols +
                                       kCols * (D + 4) + kCols * kLdRows);
  int err = allow_smem(flash_bwd_dq_kernel, smem);
  if (err) return err;
  const long long blocks = static_cast<long long>(BH) * ((S + kRows - 1) / kRows);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_dq_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      q, k, v, bias, dout, lse, delta, dq, H, S, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

int flash_attention_bwd_dkdv_f32(const float* q, const float* k, const float* v,
                                 const float* bias, const float* dout,
                                 const float* lse, const float* delta, float* dk,
                                 float* dv, float* dbias, int BH, int H, int S,
                                 int D, float scale, int causal, void* stream) {
  if (bad_shape(BH, H, S, D)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * (2 * D * kLdRows + 2 * D * kLdCols +
                                       2 * kCols * (D + 4) + 2 * kCols * kLdRows);
  int err = allow_smem(flash_bwd_dkdv_kernel, smem);
  if (err) return err;
  const long long blocks = static_cast<long long>(BH) * ((S + kRows - 1) / kRows);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_dkdv_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      q, k, v, bias, dout, lse, delta, dk, dv, bias ? dbias : nullptr, H, S, D,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
