// Flash attention for Hopper (sm_90a): forward, dK/dV backward and dQ
// backward, in float32 and, for AMP's operand types, in bf16 and float16
// (the 16-bit builds, their own section below).
//
// Replaces the three Pallas TPU kernels of
// paddle_tpu/ops/pallas/flash_attention.py:
//
//   flash_attention_fwd_{f32,bf16,f16}       <- `_fwd_impl`,  pallas_call at :167
//                                               (body `_attention_kernel`, :42)
//   flash_attention_bwd_dkdv_{f32,bf16,f16}  <- `_flash_bwd`, pallas_call at :378
//                                               (body `_bwd_dkdv_kernel`, :197)
//   flash_attention_bwd_dq_{f32,bf16,f16}    <- `_flash_bwd`, pallas_call at :419
//                                               (body `_bwd_dq_kernel`, :265)
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
// Nothing crosses blocks, so no kernel needs atomics and two launches on
// the same inputs give the same bits. Causal masking follows `cols <= rows`
// and skips the key (or query) tiles that the mask removes whole (:84-86,
// :253-256, :307-310). Any S works: rows and keys at or past S are
// zero-filled in shared memory and masked, and nothing is written for them.
// D is a multiple of 4 up to 128 in float32, of 8 in the 16-bit builds.
//
// The float32 builds. Bound: at BERT-base's shapes (B=32, H=12, S=128,
// D=64) K1 does 2, K2a 4 and K2b 3 * B*H*S^2*D multiply-adds: 0.024, 0.048
// and 0.036 ms at the f32 FFMA rate (67 TFLOP/s), which first designs in
// FFMA (paced by their shared-memory loads) reached a quarter (K1) to a
// fifth (K2a, K2b) of. So
// every product of all three runs on the tensor cores, as mma.sync m16n8k8
// TF32 in the 3xTF32 split (each f32 operand as big = tf32(x) plus small =
// tf32(x - big), three MMAs a product, f32 accumulators): f32-accurate,
// where plain TF32 misses the float32 bars by 40x (K1) to two orders (K2a,
// K2b; tests/test_torch_flash_attention.py emulates both routes). At 495 / 3 = 165 TFLOP/s of f32 work all three are bound by
// bytes: 50.5 MB (K1), 76 MB (K2a) and 63 MB (K2b) at 3.35 TB/s, 0.015,
// 0.023 and 0.019 ms. On the card they are bound by instruction throughput
// and latency instead: at BERT-base's shapes they run 2.4M, 4.7M and 3.5M
// mma.sync, and mma.sync's TF32 rate is well under wgmma's: on an H100 at
// most 322 TFLOP/s, and 226 with one dependent chain a warp at these
// kernels' 12 warps an SM (tools/torch_mma_rate.py), while each tile's
// splits, loads and softmax come on top. The design keeps the instructions
// per MMA few and three blocks on each SM (D <= 64):
// - A block is 4 warps and owns 64 rows, 16 a warp (the MMA's m16): K1 and
//   K2b 64 queries, looping over key tiles of 16; K2a 64 keys, looping over
//   query tiles of 16 (768 blocks each at BERT-base's shapes, three on an
//   SM). The O (dK/dV, dQ) accumulators stay in registers in the MMA's C
//   layout. Wider tiles cost registers and shared memory, and so blocks on
//   an SM, more than they save.
// - The block's own rows (Q for K1; K, V or Q, dO) are staged once; the
//   streamed tiles (K, V and the keys' bias for K1 and K2b; Q, dO, lse,
//   delta for K2a) go through a 2-stage ring of 16-byte cp.async copies, so
//   the next tile loads under this tile's products. Every tile sits once in
//   shared memory, row-major: the fragment layouts, not a transposed copy,
//   do the transposes.
// - A streamed tile is split once when it lands (big parts in place, small
//   parts beside it), since all four warps read it as B operands; the
//   block's own rows, read by one warp each as A operands, are split as
//   they are loaded, at every tile (splitting them in shared memory too
//   costs a block an SM; K1 holding its Q fragments in registers for the
//   whole loop was no faster at D = 64 and 8% slower at D = 128, where
//   they spill). Fragments along rows load with ldmatrix.
// - P and dS never leave registers: the products over them take their k
//   steps in an order that makes the score tile's C fragment the A
//   fragment (frag_a_from_c), so they need neither a pass through shared
//   memory nor shuffles. K1's online softmax runs on that C fragment: a
//   row's max and sum over the 4 lanes that hold it, its rescale of O in
//   registers.
// - Each two k steps' six MMAs go into a fresh accumulator, added to the
//   running sum in f32: the tensor core rounds toward zero as it adds.
// - Shared rows have a leading dim of 4 (mod 32) floats, so every fragment
//   load is free of bank conflicts; D is zero-padded to a class of 32, 64,
//   96 or 128 columns, so the loops have fixed trip counts.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxD = 128;
constexpr float kNeg = -1e30f;
constexpr float kDeadLse = -5e29f;  // lse of a row with no live key

// ---- The tensor-core pieces of K1, K2a and K2b ------------------------------
// Every product is an m16n8k8 TF32 mma.sync in the 3xTF32 split: x = big +
// small with big = tf32(x), small = tf32(x - big), and a * b is taken as
// small(a) big(b) + big(a) small(b) + big(a) big(b), summed in f32 registers.
// A warp owns 16 rows of the block's 64. Fragments (lane = 4 g + t):
//   A 16x8:  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B 8x8:   b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C 16x8:  c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// A product over the columns of an accumulator (P V, P^T dO, dS^T Q, dS K)
// takes its k steps in the order k = t -> column 2t, k = t + 4 -> column
// 2t + 1, which makes the C fragment {c0, c2, c1, c3} its A fragment: P and
// dS stay in registers. Tiles sit in shared memory row-major with a leading
// dim of 4 (mod 32) floats, so both ways of reading them (lanes along rows by
// g, or along rows by 2t) hit 32 distinct banks. Every warp reads every
// streamed tile as B operands, so a tile is split once when it lands: its
// big parts in place, its small parts beside it.

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // queries (K1, K2b) or keys (K2a) a block owns
constexpr int kStages = 2;          // depth of the cp.async ring
constexpr int kFwdTile = 16;        // rows of K1's key tiles
constexpr int kDkdvTile = 16;       // rows of K2a's query tiles
constexpr int kDqTile = 16;         // rows of K2b's key tiles
static_assert(kFwdTile % 16 == 0 && kDkdvTile % 16 == 0 && kDqTile % 16 == 0,
              "a tile is a whole number of k-step pairs (mma3_pair)");

// The leading dim of a tile's rows in head-width class NT: D zero-padded to
// 8 * NT columns, NT in {4, 8, 12, 16}, so every loop over columns has a
// fixed trip count and unrolls into one basic block that the compiler can
// schedule across; 4 more floats put row r at bank 4r (mod 32).
template <int NT>
__host__ __device__ constexpr int row_ld() {
  return 8 * NT + 4;
}

// Shared bytes of a backward block: its own 64 rows of two matrices, the
// ring of streamed tiles (two matrices and `extra` vectors of a row each),
// and the small parts of one tile.
template <int NT>
__host__ __device__ constexpr size_t bwd_smem(int tile, int extra) {
  return sizeof(float) * (2 * kRows * row_ld<NT>() +
                          kStages * (2 * tile * row_ld<NT>() + extra * tile) +
                          2 * tile * row_ld<NT>());
}

// Shared bytes of a K1 block: its 64 query rows, the ring of (K, V, bias)
// tiles, and the small parts of one.
template <int NT>
__host__ __device__ constexpr size_t fwd_smem() {
  return sizeof(float) * (kRows * row_ld<NT>() +
                          kStages * (2 * kFwdTile * row_ld<NT>() + kFwdTile) +
                          2 * kFwdTile * row_ld<NT>());
}

// K1's register cap: 3 blocks an SM (168 registers a thread) where its
// accumulator (4 NT registers) leaves room and 3 fit by shared memory
// (NT <= 8: 44 KB at most); a wider class takes as many registers as it
// needs and fewer blocks.
template <int NT>
__host__ __device__ constexpr int fwd_blocks() {
  return NT <= 8 ? 3 : 1;
}

// K2b's blocks an SM for its register cap: 3 (168 registers a thread)
// where 3 fit by shared memory (228 KB an SM, 1 KB of it reserved a
// block), else as many as fit (NT = 12: 2, NT = 16: 1, both no cap under
// the 255 registers a thread may have), so a wider class is not held to
// registers for blocks that could not be resident anyway.
template <int NT>
__host__ __device__ constexpr int dq_blocks() {
  return 228 * 1024 / (bwd_smem<NT>(kDqTile, 1) + 1024) < 3
             ? static_cast<int>(228 * 1024 / (bwd_smem<NT>(kDqTile, 1) + 1024))
             : 3;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to dst, or 16 zero bytes (nothing read) when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// dst[r * LD + c] = src[(row0 + r) * D + c] for r < n, c < CHUNKS 16-byte
// chunks (4 floats or 8 16-bit values each), as 16-byte copies; zeros for
// rows at or past S and columns at or past D.
template <int LD, int CHUNKS, typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int row0, int n, int S,
                                           int D) {
  constexpr int kPer = 16 / sizeof(T);
  for (int i = threadIdx.x; i < n * CHUNKS; i += kThreads) {
    const int r = i / CHUNKS, c = (i - r * CHUNKS) * kPer;
    const bool valid = row0 + r < S && c < D;
    cp_async16(dst + r * LD + c, valid ? src + static_cast<size_t>(row0 + r) * D + c : src,
               valid);
  }
}

// dst[i] = src[row0 + i] for i < n, zero past S.
__device__ __forceinline__ void stage_vec(float* dst, const float* src, int row0, int n,
                                          int S) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const bool valid = row0 + i < S;
    cp_async4(dst + i, valid ? src + row0 + i : src, valid);
  }
}

struct FragA {
  uint32_t big[4], small[4];
};

struct FragB {
  uint32_t big[2], small[2];
};

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(x - __uint_as_float(big)));
}

// The n x (4 * CHUNKS) tile at `tile` split in place: its big parts stay,
// its small parts go to the same places of `small`.
template <int LD, int CHUNKS>
__device__ __forceinline__ void split_tile(float* tile, float* small, int n) {
  for (int i = threadIdx.x; i < n * CHUNKS; i += kThreads) {
    const int at = (i / CHUNKS) * LD + (i % CHUNKS) * 4;
    const float4 x = *reinterpret_cast<const float4*>(tile + at);
    uint4 b, s;
    split_tf32(x.x, b.x, s.x);
    split_tf32(x.y, b.y, s.y);
    split_tf32(x.z, b.z, s.z);
    split_tf32(x.w, b.w, s.w);
    *reinterpret_cast<uint4*>(tile + at) = b;
    *reinterpret_cast<uint4*>(small + at) = s;
  }
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a0 b0 + a1 b1, two k steps in 3xTF32: the small terms first, then
// big * big. The tensor core rounds each sum it adds into its accumulator
// toward zero, a bias that would grow with every k step of a long product,
// so the two steps' six MMAs go into a fresh accumulator that is added to c
// in f32 (round to nearest).
__device__ __forceinline__ void mma3_pair(float (&c)[4], const FragA& a0, const FragB& b0,
                                          const FragA& a1, const FragB& b1) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(d, a0.small, b0.big);
  mma_tf32(d, a0.big, b0.small);
  mma_tf32(d, a1.small, b1.big);
  mma_tf32(d, a1.big, b1.small);
  mma_tf32(d, a0.big, b0.big);
  mma_tf32(d, a1.big, b1.big);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += d[e];
}

// Four 8 x 4 blocks of 32-bit words in one instruction (ldmatrix's 8 x 8
// b16 matrices): lane l gives the address of row l % 8 of block l / 8 and
// gets word l % 4 of row l / 4 of each block.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// A lane's ldmatrix row address, from a tile's corner, for frag_a (the
// blocks: rows 0-7 and 8-15 of columns 0-3, then of columns 4-7) and for
// frag_b_rows (rows 0-7 of columns 0-3, 4-7, 8-11, 12-15).
template <int LD>
__device__ __forceinline__ int frag_a_lane(int lane) {
  return ((lane & 7) + (lane & 8)) * LD + (lane >> 4) * 4;
}

template <int LD>
__device__ __forceinline__ int frag_b_lane(int lane) {
  return (lane & 7) * LD + (lane >> 3) * 4;
}

// A = rows 0-15 of `tile`, columns c0 .. c0 + 7 (`lane_at` = frag_a_lane),
// split here.
__device__ __forceinline__ FragA frag_a(const float* tile, int lane_at, int c0) {
  uint32_t x[4];
  ldsm_x4(x, tile + lane_at + c0);
  FragA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(x[i]), f.big[i], f.small[i]);
  return f;
}

__device__ __forceinline__ uint32_t bits(const float* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The B fragments of two k steps, B[k][n] = tile[n][c0 + k] and
// tile[n][c0 + 8 + k], of a split tile (big parts at `big`, small parts at
// `big + small`; `lane_at` = frag_b_lane): rows 0-7 are the n columns of B.
__device__ __forceinline__ void frag_b_rows(FragB& b0, FragB& b1, const float* big,
                                            ptrdiff_t small, int lane_at, int c0) {
  uint32_t x[4], y[4];
  ldsm_x4(x, big + lane_at + c0);
  ldsm_x4(y, big + small + lane_at + c0);
  b0 = FragB{{x[0], x[1]}, {y[0], y[1]}};
  b1 = FragB{{x[2], x[3]}, {y[2], y[3]}};
}

// B[k][n] = tile[row(k)][c0 + n] of a split tile, with row(t) = 2t and
// row(t + 4) = 2t + 1, the k order of frag_a_from_c.
template <int LD>
__device__ __forceinline__ FragB frag_b_cols(const float* big, ptrdiff_t small, int c0,
                                             int g, int t) {
  const float* p = big + 2 * t * LD + c0 + g;
  return FragB{{bits(p), bits(p + LD)}, {bits(p + small), bits(p + small + LD)}};
}

// The accumulator c (rows g, g + 8; columns 2t, 2t + 1 of 8) as the A
// fragment of a product over its 8 columns.
__device__ __forceinline__ FragA frag_a_from_c(const float (&c)[4]) {
  FragA f;
  split_tf32(c[0], f.big[0], f.small[0]);
  split_tf32(c[2], f.big[1], f.small[1]);
  split_tf32(c[1], f.big[2], f.small[2]);
  split_tf32(c[3], f.big[3], f.small[3]);
  return f;
}

// ---- K1: O and LSE ---------------------------------------------------------
// Block: (head, 64 queries). Shared: Q [64][LD]; the ring of (K, V
// [TILE][LD], bias [TILE]) tiles; the small parts of the tile in use
// [2 * TILE][LD]. Per key tile, a warp takes S = Q K^T for its 16 rows, the
// online softmax on S's C fragments (a row's max and sum over the 4 lanes
// that hold it), and O += P V with P as the A fragment.
template <int NT>
__global__ void __launch_bounds__(kThreads, fwd_blocks<NT>())
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ o, float* __restrict__ lse, int H, int S, int D,
                 float scale, int causal) {
  constexpr int LD = row_ld<NT>(), TILE = kFwdTile, CHUNKS = 2 * NT;
  constexpr int kStage = 2 * TILE * LD + TILE;  // floats of one ring stage
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* ring = Qs + kRows * LD;
  float* small = ring + kStages * kStage;

  const int n_qt = (S + kRows - 1) / kRows;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const size_t base = static_cast<size_t>(bh) * S * D;
  const float* brow = bias ? bias + static_cast<size_t>(bh / H) * S : nullptr;

  int n_kt = (S + TILE - 1) / TILE;
  if (causal) n_kt = min(n_kt, (q0 + kRows + TILE - 1) / TILE);  // later keys masked
  auto stage = [&](int tile) {
    float* Ks = ring + (tile % kStages) * kStage;
    stage_rows<LD, CHUNKS>(Ks, k + base, tile * TILE, TILE, S, D);
    stage_rows<LD, CHUNKS>(Ks + TILE * LD, v + base, tile * TILE, TILE, S, D);
    if (brow) stage_vec(Ks + 2 * TILE * LD, brow, tile * TILE, TILE, S);
  };
  stage_rows<LD, CHUNKS>(Qs, q + base, q0, kRows, S, D);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_kt) stage(i);
    cp_async_commit();
  }
  const float* Qw = Qs + 16 * warp * LD;
  const int a_at = frag_a_lane<LD>(lane), b_at = frag_b_lane<LD>(lane);

  const int row0 = q0 + 16 * warp + g;  // this thread's rows: row0, row0 + 8
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  for (int it = 0; it < n_kt; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile `it` has landed; every warp is done with it - 1
    if (it + kStages - 1 < n_kt) stage(it + kStages - 1);
    cp_async_commit();
    float* Ks = ring + (it % kStages) * kStage;
    const float* Vs = Ks + TILE * LD;
    const float* Bs = Vs + TILE * LD;
    const ptrdiff_t sm = small - Ks;  // from a big part to its small part
    split_tile<LD, CHUNKS>(Ks, small, 2 * TILE);  // K and V
    __syncthreads();
    const int k0 = it * TILE;

    float s[TILE / 8][4];
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT; kk += 2) {
      const FragA qa0 = frag_a(Qw, a_at, 8 * kk), qa1 = frag_a(Qw, a_at, 8 * kk + 8);
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
        FragB b0, b1;
        frag_b_rows(b0, b1, Ks + 8 * j * LD, sm, b_at, 8 * kk);
        mma3_pair(s[j], qa0, b0, qa1, b1);
      }
    }
    // the masked scores, and the rows' maxima over the tile
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      const float2 b2 = brow ? *reinterpret_cast<const float2*>(Bs + 8 * j + 2 * t)
                             : make_float2(0.f, 0.f);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 8 * (e / 2);
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        float x = s[j][e] * scale;
        if (col >= S) {
          x = -INFINITY;  // exp() gives 0 exactly: the key does not exist
        } else {
          x += (e & 1) ? b2.y : b2.x;
          if (causal && col > row) x = kNeg;
        }
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e / 2]);
        s[j][e] = p;
        sum[e / 2] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // the row's sum over the 4 lanes that share it, in a fixed order
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * alpha[i] + sum[i];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }
    // O += P V over the tile's keys
#pragma unroll
    for (int j = 0; j < TILE / 8; j += 2) {
      const FragA pa0 = frag_a_from_c(s[j]), pa1 = frag_a_from_c(s[j + 1]);
      const float* vj = Vs + 8 * j * LD;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma3_pair(acc[nt], pa0, frag_b_cols<LD>(vj, sm, 8 * nt, g, t), pa1,
                  frag_b_cols<LD>(vj + 8 * LD, sm, 8 * nt, g, t));
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= S) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    const float inv = 1.f / l_safe;
    if (t == 0) lse[static_cast<size_t>(bh) * S + row] = m[i] + logf(l_safe);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = 8 * nt + 2 * t;
      if (col < D)
        *reinterpret_cast<float2*>(o + base + static_cast<size_t>(row) * D + col) =
            make_float2(acc[nt][2 * i] * inv, acc[nt][2 * i + 1] * inv);
    }
  }
}

// ---- K2b: dQ --------------------------------------------------------------
// Block: (head, 64 queries). Shared: Q, dO [64][LD]; the ring of (K, V
// [TILE][LD], bias [TILE]) tiles; the small parts of the tile in use
// [2 * TILE][LD].
template <int NT>
__global__ void __launch_bounds__(kThreads, dq_blocks<NT>())
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ bias,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int H, int S, int D, float scale, int causal) {
  constexpr int LD = row_ld<NT>(), TILE = kDqTile, CHUNKS = 2 * NT;
  constexpr int kStage = 2 * TILE * LD + TILE;  // floats of one ring stage
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kRows * LD;
  float* ring = dOs + kRows * LD;
  float* small = ring + kStages * kStage;

  const int n_qt = (S + kRows - 1) / kRows;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const size_t base = static_cast<size_t>(bh) * S * D;
  const float* brow = bias ? bias + static_cast<size_t>(bh / H) * S : nullptr;

  int n_kt = (S + TILE - 1) / TILE;
  if (causal) n_kt = min(n_kt, (q0 + kRows + TILE - 1) / TILE);  // later keys masked
  auto stage = [&](int tile) {
    float* Ks = ring + (tile % kStages) * kStage;
    stage_rows<LD, CHUNKS>(Ks, k + base, tile * TILE, TILE, S, D);
    stage_rows<LD, CHUNKS>(Ks + TILE * LD, v + base, tile * TILE, TILE, S, D);
    if (brow) stage_vec(Ks + 2 * TILE * LD, brow, tile * TILE, TILE, S);
  };
  stage_rows<LD, CHUNKS>(Qs, q + base, q0, kRows, S, D);
  stage_rows<LD, CHUNKS>(dOs, dout + base, q0, kRows, S, D);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_kt) stage(i);
    cp_async_commit();
  }

  const int row0 = q0 + 16 * warp + g;  // this thread's rows: row0, row0 + 8
  float row_lse[2], row_delta[2], acc[NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    row_lse[i] = row < S ? lse[static_cast<size_t>(bh) * S + row] : kNeg;
    row_delta[i] = row < S ? delta[static_cast<size_t>(bh) * S + row] : 0.f;
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  const float* Qw = Qs + 16 * warp * LD;
  const float* dOw = dOs + 16 * warp * LD;
  const int a_at = frag_a_lane<LD>(lane), b_at = frag_b_lane<LD>(lane);

  for (int it = 0; it < n_kt; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile `it` has landed; every warp is done with it - 1
    if (it + kStages - 1 < n_kt) stage(it + kStages - 1);
    cp_async_commit();
    float* Ks = ring + (it % kStages) * kStage;
    const float* Vs = Ks + TILE * LD;
    const float* Bs = Vs + TILE * LD;
    const ptrdiff_t sm = small - Ks;  // from a big part to its small part
    split_tile<LD, CHUNKS>(Ks, small, 2 * TILE);  // K and V
    __syncthreads();
    const int k0 = it * TILE;

    float s[TILE / 8][4], dp[TILE / 8][4];
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT; kk += 2) {
      const FragA qa0 = frag_a(Qw, a_at, 8 * kk), qa1 = frag_a(Qw, a_at, 8 * kk + 8);
      const FragA ga0 = frag_a(dOw, a_at, 8 * kk), ga1 = frag_a(dOw, a_at, 8 * kk + 8);
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
        FragB b0, b1;
        frag_b_rows(b0, b1, Ks + 8 * j * LD, sm, b_at, 8 * kk);
        mma3_pair(s[j], qa0, b0, qa1, b1);
        frag_b_rows(b0, b1, Vs + 8 * j * LD, sm, b_at, 8 * kk);
        mma3_pair(dp[j], ga0, b0, ga1, b1);
      }
    }
    // dS = P (dP - delta) with P = exp(s - lse), in place of s
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      const float2 b2 = brow ? *reinterpret_cast<const float2*>(Bs + 8 * j + 2 * t)
                             : make_float2(0.f, 0.f);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 8 * (e / 2);
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        float p = 0.f;
        if (col < S && row_lse[e / 2] > kDeadLse) {
          float x = s[j][e] * scale + ((e & 1) ? b2.y : b2.x);
          if (causal && col > row) x = kNeg;
          p = expf(x - row_lse[e / 2]);
        }
        s[j][e] = p * (dp[j][e] - row_delta[e / 2]);
      }
    }
    // dQ += dS K over the tile's keys
#pragma unroll
    for (int j = 0; j < TILE / 8; j += 2) {
      const FragA a0 = frag_a_from_c(s[j]), a1 = frag_a_from_c(s[j + 1]);
      const float* kj = Ks + 8 * j * LD;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma3_pair(acc[nt], a0, frag_b_cols<LD>(kj, sm, 8 * nt, g, t), a1,
                  frag_b_cols<LD>(kj + 8 * LD, sm, 8 * nt, g, t));
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= S) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = 8 * nt + 2 * t;
      if (col < D)
        *reinterpret_cast<float2*>(dq + base + static_cast<size_t>(row) * D + col) =
            make_float2(acc[nt][2 * i] * scale, acc[nt][2 * i + 1] * scale);
    }
  }
}

// ---- K2a: dK, dV, dbias ---------------------------------------------------
// Block: (head, 64 keys). Shared: K, V [64][LD]; the ring of (Q, dO
// [TILE][LD], lse, delta [TILE]) tiles; the small parts of the tile in use
// [2 * TILE][LD]. The products run key-major: S^T = K Q^T and dP^T = V
// dO^T, so P^T and dS^T are A fragments of dV += P^T dO and dK += dS^T Q,
// and dbias is a row sum of dS^T.
template <int NT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ bias,
                      const float* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, float* __restrict__ dbias, int H,
                      int S, int D, float scale, int causal) {
  constexpr int LD = row_ld<NT>(), TILE = kDkdvTile, CHUNKS = 2 * NT;
  constexpr int kStage = 2 * TILE * LD + 2 * TILE;  // floats of one ring stage
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kRows * LD;
  float* ring = Vs + kRows * LD;
  float* small = ring + kStages * kStage;

  const int n_kt = (S + kRows - 1) / kRows;
  const int bh = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x % n_kt) * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const size_t base = static_cast<size_t>(bh) * S * D;
  const float* brow = bias ? bias + static_cast<size_t>(bh / H) * S : nullptr;

  const int n_qt = (S + TILE - 1) / TILE;
  const int t0 = causal ? k0 / TILE : 0;  // earlier query tiles see no key here
  auto stage = [&](int tile) {
    float* Qs = ring + (tile % kStages) * kStage;
    stage_rows<LD, CHUNKS>(Qs, q + base, tile * TILE, TILE, S, D);
    stage_rows<LD, CHUNKS>(Qs + TILE * LD, dout + base, tile * TILE, TILE, S, D);
    stage_vec(Qs + 2 * TILE * LD, lse + static_cast<size_t>(bh) * S, tile * TILE, TILE, S);
    stage_vec(Qs + 2 * TILE * LD + TILE, delta + static_cast<size_t>(bh) * S, tile * TILE,
              TILE, S);
  };
  stage_rows<LD, CHUNKS>(Ks, k + base, k0, kRows, S, D);
  stage_rows<LD, CHUNKS>(Vs, v + base, k0, kRows, S, D);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (t0 + i < n_qt) stage(t0 + i);
    cp_async_commit();
  }

  const int key0 = k0 + 16 * warp + g;  // this thread's keys: key0, key0 + 8
  float key_bias[2], db[2] = {0.f, 0.f}, dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    key_bias[i] = (brow && key < S) ? brow[key] : 0.f;
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nt][e] = dv_acc[nt][e] = 0.f;
  const float* Kw = Ks + 16 * warp * LD;
  const float* Vw = Vs + 16 * warp * LD;
  const int a_at = frag_a_lane<LD>(lane), b_at = frag_b_lane<LD>(lane);

  for (int it = t0; it < n_qt; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile `it` has landed; every warp is done with it - 1
    if (it + kStages - 1 < n_qt) stage(it + kStages - 1);
    cp_async_commit();
    float* Qs = ring + (it % kStages) * kStage;
    const float* dOs = Qs + TILE * LD;
    const float* Ls = dOs + TILE * LD;
    const float* Ds = Ls + TILE;
    const ptrdiff_t sm = small - Qs;  // from a big part to its small part
    split_tile<LD, CHUNKS>(Qs, small, 2 * TILE);  // Q and dO
    __syncthreads();
    const int qt0 = it * TILE;

    float s[TILE / 8][4], dp[TILE / 8][4];
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT; kk += 2) {
      const FragA ka0 = frag_a(Kw, a_at, 8 * kk), ka1 = frag_a(Kw, a_at, 8 * kk + 8);
      const FragA va0 = frag_a(Vw, a_at, 8 * kk), va1 = frag_a(Vw, a_at, 8 * kk + 8);
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
        FragB b0, b1;
        frag_b_rows(b0, b1, Qs + 8 * j * LD, sm, b_at, 8 * kk);
        mma3_pair(s[j], ka0, b0, ka1, b1);
        frag_b_rows(b0, b1, dOs + 8 * j * LD, sm, b_at, 8 * kk);
        mma3_pair(dp[j], va0, b0, va1, b1);
      }
    }
    // P^T in s, dS^T = P^T (dP^T - delta) in dp
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(Ls + 8 * j + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(Ds + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 8 * (e / 2);
        const int row = qt0 + 8 * j + 2 * t + (e & 1);
        const float r_lse = (e & 1) ? l2.y : l2.x;
        const float r_delta = (e & 1) ? d2.y : d2.x;
        float p = 0.f;
        if (key < S && row < S && r_lse > kDeadLse) {
          float x = s[j][e] * scale + key_bias[e / 2];
          if (causal && key > row) x = kNeg;
          p = expf(x - r_lse);
        }
        const float ds = p * (dp[j][e] - r_delta);
        db[e / 2] += ds;
        s[j][e] = p;
        dp[j][e] = ds;
      }
    }
    // dV += P^T dO and dK += dS^T Q over the tile's queries
#pragma unroll
    for (int j = 0; j < TILE / 8; j += 2) {
      const FragA pa0 = frag_a_from_c(s[j]), pa1 = frag_a_from_c(s[j + 1]);
      const FragA sa0 = frag_a_from_c(dp[j]), sa1 = frag_a_from_c(dp[j + 1]);
      const float* gj = dOs + 8 * j * LD;
      const float* qj = Qs + 8 * j * LD;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma3_pair(dv_acc[nt], pa0, frag_b_cols<LD>(gj, sm, 8 * nt, g, t), pa1,
                  frag_b_cols<LD>(gj + 8 * LD, sm, 8 * nt, g, t));
        mma3_pair(dk_acc[nt], sa0, frag_b_cols<LD>(qj, sm, 8 * nt, g, t), sa1,
                  frag_b_cols<LD>(qj + 8 * LD, sm, 8 * nt, g, t));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    // the row's sum over the 4 lanes that share it, in a fixed order
    float total = db[i];
    total += __shfl_xor_sync(0xffffffffu, total, 1);
    total += __shfl_xor_sync(0xffffffffu, total, 2);
    if (key >= S) continue;
    if (dbias && t == 0) dbias[static_cast<size_t>(bh) * S + key] = total;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = 8 * nt + 2 * t;
      if (col < D) {
        const size_t at = base + static_cast<size_t>(key) * D + col;
        *reinterpret_cast<float2*>(dv + at) =
            make_float2(dv_acc[nt][2 * i], dv_acc[nt][2 * i + 1]);
        *reinterpret_cast<float2*>(dk + at) =
            make_float2(dk_acc[nt][2 * i] * scale, dk_acc[nt][2 * i + 1] * scale);
      }
    }
  }
}

// ---- The 16-bit builds: K1, K2b and K2a in bf16 and float16 ----------------
// Under AMP the JAX package feeds the Pallas kernels bf16 q, k, v (and dO),
// and their dots run in that type with f32 accumulation
// (preferred_element_type, flash_attention.py:43-45, :72-75): s = q k^T is
// exact products summed in f32; p is rounded to the operand type only for
// the p v product (:74), while l sums the unrounded f32 p (:70); in the
// backward p and dS are rounded before their products (:234, :243, :301).
// O, dQ, dK and dV come out in the operand type, LSE and dbias in f32. These
// kernels round at the same points. Each product is one mma.sync m16n8k16
// (bf16 or f16 operands, f32 accumulators) in place of the float32 build's
// three TF32 ones; the softmax, p, dS and every sum stay f32 in registers.
//
// Fragments of m16n8k16 (lane = 4 g + t), two 16-bit values a register:
//   A 16x16: a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..)
//   B 16x8:  b0 (k = 2t..2t+1, n = g), b1 (k = 2t + 8.., n = g)
//   C 16x8:  c0 c1 (g, 2t..2t+1), c2 c3 (g + 8, 2t..2t+1)
// The C fragments of two adjacent 8-column tiles are, packed in pairs, the A
// fragment of a product over their 16 columns, so P and dS stay in registers
// with no reordering. Every operand loads with ldmatrix: A and the B of
// S = Q K^T (K's rows are B's columns) as stored, the B of P V, dS K, P^T dO
// and dS^T Q (rows are B's k) through ldmatrix.trans. Tiles sit row-major in
// shared memory with a leading dim of D's class + 8 values, so a row is 16
// (mod 128) bytes after the one before it and the 8 rows an ldmatrix reads
// hit 8 distinct 16-byte bank groups. A block is 4 warps owning 64 rows, 16
// a warp, as in the float32 build, and streams tiles of 32 rows through the
// same 2-stage cp.async ring; operands are read from shared memory at each
// use (no fragment is held across tiles), which keeps registers for the
// accumulators at D = 128 (234 registers, no spill, in K2a). D must be a
// multiple of 8 (a 16-byte copy is 8 values).
//
// Bound: at BERT-base's shapes the products take 1.6-3.3 us at the bf16
// tensor-core rate, so all three are bound by bytes (16-bit q, k, v, O, dO
// and grads, float32 LSE, delta, bias): 0.0076 (K1), 0.0114 (K2a) and
// 0.0095 ms (K2b) at 3.35 TB/s. On an H100 they run 2.3-2.7x that
// (chip_smoke.py phase 2f), on mma.sync; wgmma is a later design.

constexpr int kTile16 = 32;  // rows of a streamed tile (keys, or K2a's queries)

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <typename T>
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// The leading dim, in values, of a 16-bit tile in head-width class NT.
template <int NT>
__host__ __device__ constexpr int row_ld16() {
  return 8 * NT + 8;
}

// A lane's ldmatrix row address from a tile's corner, in values:
// - lane_a: the A fragment of rows 0-15, columns 0-15;
// - lane_b: two B fragments (8 columns n each) of one k16 step, B[k][n] =
//   tile[n][k], rows 0-15 (n) and columns 0-15 (k): regs 0, 1 for rows 0-7,
//   regs 2, 3 for rows 8-15;
// - lane_bt (with .trans): two B fragments of one k16 step, B[k][n] =
//   tile[k][n], rows 0-15 (k) and columns 0-15 (n): regs 0, 1 for columns
//   0-7, regs 2, 3 for columns 8-15.
template <int LD>
__device__ __forceinline__ int lane_a(int lane) {
  return (lane & 15) * LD + (lane >> 4) * 8;
}

template <int LD>
__device__ __forceinline__ int lane_b(int lane) {
  return ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
}

template <int LD>
__device__ __forceinline__ int lane_bt(int lane) {
  return ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + (lane >> 4) * 8;
}

// c[j] += A B_j over the k16 steps of a D-wide row product, j over the
// TILE / 8 column tiles: A = 16 rows of `a` (this warp's, `a_at` =
// lane_a), B_j[k][n] = b[8 j + n][k] (`b_at` = lane_b).
template <typename T, int NT, int TILE>
__device__ __forceinline__ void rows_product(float (&c)[TILE / 8][4], const T* a, int a_at,
                                             const T* b, int b_at) {
  constexpr int LD = row_ld16<NT>();
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a + a_at + 16 * kk);
#pragma unroll
    for (int jj = 0; jj < TILE / 16; ++jj) {
      uint32_t bf[4];
      ldsm_x4(bf, b + 16 * jj * LD + b_at + 16 * kk);
      mma16<T>(c[2 * jj], af, bf[0], bf[1]);
      mma16<T>(c[2 * jj + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[nt] += P B over the tile's TILE rows: P in C fragments (f32, rounded
// to T here), B[k][n] = b[k][8 nt + n] (`bt_at` = lane_bt).
template <typename T, int NT, int TILE>
__device__ __forceinline__ void cols_product(float (&acc)[NT][4],
                                             const float (&p)[TILE / 8][4], const T* b,
                                             int bt_at) {
  constexpr int LD = row_ld16<NT>();
#pragma unroll
  for (int jj = 0; jj < TILE / 16; ++jj) {
    const uint32_t pa[4] = {pack2<T>(p[2 * jj][0], p[2 * jj][1]),
                            pack2<T>(p[2 * jj][2], p[2 * jj][3]),
                            pack2<T>(p[2 * jj + 1][0], p[2 * jj + 1][1]),
                            pack2<T>(p[2 * jj + 1][2], p[2 * jj + 1][3])};
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, b + 16 * jj * LD + bt_at + 16 * np);
      mma16<T>(acc[2 * np], pa, bf[0], bf[1]);
      mma16<T>(acc[2 * np + 1], pa, bf[2], bf[3]);
    }
  }
}

// Writes acc (this thread's rows row0 and row0 + 8 of 16, columns 2t, 2t + 1
// of each 8) times `mul[i]` as T to out's rows below S and columns below D.
template <typename T, int NT>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[NT][4], int row0,
                                           const float (&mul)[2], int S, int D, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= S) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = 8 * nt + 2 * t;
      if (col < D)
        *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row) * D + col) =
            pack2<T>(acc[nt][2 * i] * mul[i], acc[nt][2 * i + 1] * mul[i]);
    }
  }
}

// Shared bytes of a 16-bit block: `own` matrices of its 64 rows and the
// ring of streamed tiles (two matrices and `extra` f32 vectors of a row).
template <typename T, int NT>
__host__ __device__ constexpr size_t smem16(int own, int extra) {
  return own * kRows * row_ld16<NT>() * sizeof(T) +
         kStages * (2 * kTile16 * row_ld16<NT>() * sizeof(T) +
                    extra * kTile16 * sizeof(float));
}

// ---- K1 (16-bit): O and LSE -------------------------------------------------
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
flash_fwd16_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ bias,
                   T* __restrict__ o, float* __restrict__ lse, int H, int S, int D,
                   float scale, int causal) {
  constexpr int LD = row_ld16<NT>(), TILE = kTile16, CHUNKS = NT;
  constexpr size_t kStage = 2 * TILE * LD * sizeof(T) + TILE * sizeof(float);
  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);
  char* ring = reinterpret_cast<char*>(Qs + kRows * LD);

  const int n_qt = (S + kRows - 1) / kRows;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4;
  const size_t base = static_cast<size_t>(bh) * S * D;
  const float* brow = bias ? bias + static_cast<size_t>(bh / H) * S : nullptr;

  int n_kt = (S + TILE - 1) / TILE;
  if (causal) n_kt = min(n_kt, (q0 + kRows + TILE - 1) / TILE);  // later keys masked
  auto stage = [&](int tile) {
    T* Ks = reinterpret_cast<T*>(ring + (tile % kStages) * kStage);
    stage_rows<LD, CHUNKS>(Ks, k + base, tile * TILE, TILE, S, D);
    stage_rows<LD, CHUNKS>(Ks + TILE * LD, v + base, tile * TILE, TILE, S, D);
    if (brow)
      stage_vec(reinterpret_cast<float*>(Ks + 2 * TILE * LD), brow, tile * TILE, TILE, S);
  };
  stage_rows<LD, CHUNKS>(Qs, q + base, q0, kRows, S, D);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_kt) stage(i);
    cp_async_commit();
  }
  const T* Qw = Qs + 16 * warp * LD;
  const int a_at = lane_a<LD>(lane), b_at = lane_b<LD>(lane), bt_at = lane_bt<LD>(lane);

  const int row0 = q0 + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  for (int it = 0; it < n_kt; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile `it` has landed; every warp is done with it - 1
    if (it + kStages - 1 < n_kt) stage(it + kStages - 1);
    cp_async_commit();
    const T* Ks = reinterpret_cast<const T*>(ring + (it % kStages) * kStage);
    const T* Vs = Ks + TILE * LD;
    const float* Bs = reinterpret_cast<const float*>(Vs + TILE * LD);
    const int k0 = it * TILE;

    float s[TILE / 8][4];
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    rows_product<T, NT, TILE>(s, Qw, a_at, Ks, b_at);
    // the masked scores, and the rows' maxima over the tile
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      const float2 b2 = brow ? *reinterpret_cast<const float2*>(Bs + 8 * j + 2 * t)
                             : make_float2(0.f, 0.f);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 8 * (e / 2);
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        float x = s[j][e] * scale;
        if (col >= S) {
          x = -INFINITY;  // exp() gives 0 exactly: the key does not exist
        } else {
          x += (e & 1) ? b2.y : b2.x;
          if (causal && col > row) x = kNeg;
        }
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e / 2]);
        s[j][e] = p;
        sum[e / 2] += p;  // l sums the unrounded p
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * alpha[i] + sum[i];
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }
    cols_product<T, NT, TILE>(acc, s, Vs, bt_at);  // O += round(P) V
  }
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    inv[i] = 1.f / l_safe;
    if (row < S && t == 0) lse[static_cast<size_t>(bh) * S + row] = m[i] + logf(l_safe);
  }
  store_rows<T, NT>(o + base, acc, row0, inv, S, D, t);
}

// ---- K2b (16-bit): dQ -------------------------------------------------------
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq16_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ bias,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dq, int H,
                      int S, int D, float scale, int causal) {
  constexpr int LD = row_ld16<NT>(), TILE = kTile16, CHUNKS = NT;
  constexpr size_t kStage = 2 * TILE * LD * sizeof(T) + TILE * sizeof(float);
  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);
  T* dOs = Qs + kRows * LD;
  char* ring = reinterpret_cast<char*>(dOs + kRows * LD);

  const int n_qt = (S + kRows - 1) / kRows;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4;
  const size_t base = static_cast<size_t>(bh) * S * D;
  const float* brow = bias ? bias + static_cast<size_t>(bh / H) * S : nullptr;

  int n_kt = (S + TILE - 1) / TILE;
  if (causal) n_kt = min(n_kt, (q0 + kRows + TILE - 1) / TILE);  // later keys masked
  auto stage = [&](int tile) {
    T* Ks = reinterpret_cast<T*>(ring + (tile % kStages) * kStage);
    stage_rows<LD, CHUNKS>(Ks, k + base, tile * TILE, TILE, S, D);
    stage_rows<LD, CHUNKS>(Ks + TILE * LD, v + base, tile * TILE, TILE, S, D);
    if (brow)
      stage_vec(reinterpret_cast<float*>(Ks + 2 * TILE * LD), brow, tile * TILE, TILE, S);
  };
  stage_rows<LD, CHUNKS>(Qs, q + base, q0, kRows, S, D);
  stage_rows<LD, CHUNKS>(dOs, dout + base, q0, kRows, S, D);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_kt) stage(i);
    cp_async_commit();
  }

  const int row0 = q0 + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
  float row_lse[2], row_delta[2], acc[NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    row_lse[i] = row < S ? lse[static_cast<size_t>(bh) * S + row] : kNeg;
    row_delta[i] = row < S ? delta[static_cast<size_t>(bh) * S + row] : 0.f;
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  const T* Qw = Qs + 16 * warp * LD;
  const T* dOw = dOs + 16 * warp * LD;
  const int a_at = lane_a<LD>(lane), b_at = lane_b<LD>(lane), bt_at = lane_bt<LD>(lane);

  for (int it = 0; it < n_kt; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile `it` has landed; every warp is done with it - 1
    if (it + kStages - 1 < n_kt) stage(it + kStages - 1);
    cp_async_commit();
    const T* Ks = reinterpret_cast<const T*>(ring + (it % kStages) * kStage);
    const T* Vs = Ks + TILE * LD;
    const float* Bs = reinterpret_cast<const float*>(Vs + TILE * LD);
    const int k0 = it * TILE;

    float s[TILE / 8][4], dp[TILE / 8][4];
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    rows_product<T, NT, TILE>(s, Qw, a_at, Ks, b_at);    // S = Q K^T
    rows_product<T, NT, TILE>(dp, dOw, a_at, Vs, b_at);  // dP = dO V^T
    // dS = P (dP - delta) with P = exp(s - lse), in place of s
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      const float2 b2 = brow ? *reinterpret_cast<const float2*>(Bs + 8 * j + 2 * t)
                             : make_float2(0.f, 0.f);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 8 * (e / 2);
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        float p = 0.f;
        if (col < S && row_lse[e / 2] > kDeadLse) {
          float x = s[j][e] * scale + ((e & 1) ? b2.y : b2.x);
          if (causal && col > row) x = kNeg;
          p = expf(x - row_lse[e / 2]);
        }
        s[j][e] = p * (dp[j][e] - row_delta[e / 2]);
      }
    }
    cols_product<T, NT, TILE>(acc, s, Ks, bt_at);  // dQ += round(dS) K
  }
  const float mul[2] = {scale, scale};
  store_rows<T, NT>(dq + base, acc, row0, mul, S, D, t);
}

// ---- K2a (16-bit): dK, dV, dbias --------------------------------------------
// Key-major, as the float32 build: S^T = K Q^T and dP^T = V dO^T, so P^T and
// dS^T are A fragments of dV += P^T dO and dK += dS^T Q, and dbias is a row
// sum of the unrounded f32 dS^T.
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv16_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ bias,
                        const T* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dk,
                        T* __restrict__ dv, float* __restrict__ dbias, int H, int S, int D,
                        float scale, int causal) {
  constexpr int LD = row_ld16<NT>(), TILE = kTile16, CHUNKS = NT;
  constexpr size_t kStage = 2 * TILE * LD * sizeof(T) + 2 * TILE * sizeof(float);
  extern __shared__ float4 smem4[];
  T* Ks = reinterpret_cast<T*>(smem4);
  T* Vs = Ks + kRows * LD;
  char* ring = reinterpret_cast<char*>(Vs + kRows * LD);

  const int n_kt = (S + kRows - 1) / kRows;
  const int bh = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x % n_kt) * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4;
  const size_t base = static_cast<size_t>(bh) * S * D;
  const float* brow = bias ? bias + static_cast<size_t>(bh / H) * S : nullptr;

  const int n_qt = (S + TILE - 1) / TILE;
  const int t0 = causal ? k0 / TILE : 0;  // earlier query tiles see no key here
  auto stage = [&](int tile) {
    T* Qs = reinterpret_cast<T*>(ring + (tile % kStages) * kStage);
    float* Ls = reinterpret_cast<float*>(Qs + 2 * TILE * LD);
    stage_rows<LD, CHUNKS>(Qs, q + base, tile * TILE, TILE, S, D);
    stage_rows<LD, CHUNKS>(Qs + TILE * LD, dout + base, tile * TILE, TILE, S, D);
    stage_vec(Ls, lse + static_cast<size_t>(bh) * S, tile * TILE, TILE, S);
    stage_vec(Ls + TILE, delta + static_cast<size_t>(bh) * S, tile * TILE, TILE, S);
  };
  stage_rows<LD, CHUNKS>(Ks, k + base, k0, kRows, S, D);
  stage_rows<LD, CHUNKS>(Vs, v + base, k0, kRows, S, D);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (t0 + i < n_qt) stage(t0 + i);
    cp_async_commit();
  }

  const int key0 = k0 + 16 * warp + lane / 4;  // this thread's keys: key0, key0 + 8
  float key_bias[2], db[2] = {0.f, 0.f}, dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    key_bias[i] = (brow && key < S) ? brow[key] : 0.f;
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nt][e] = dv_acc[nt][e] = 0.f;
  const T* Kw = Ks + 16 * warp * LD;
  const T* Vw = Vs + 16 * warp * LD;
  const int a_at = lane_a<LD>(lane), b_at = lane_b<LD>(lane), bt_at = lane_bt<LD>(lane);

  for (int it = t0; it < n_qt; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile `it` has landed; every warp is done with it - 1
    if (it + kStages - 1 < n_qt) stage(it + kStages - 1);
    cp_async_commit();
    const T* Qs = reinterpret_cast<const T*>(ring + (it % kStages) * kStage);
    const T* dOs = Qs + TILE * LD;
    const float* Ls = reinterpret_cast<const float*>(dOs + TILE * LD);
    const float* Ds = Ls + TILE;
    const int qt0 = it * TILE;

    float s[TILE / 8][4], dp[TILE / 8][4];
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    rows_product<T, NT, TILE>(s, Kw, a_at, Qs, b_at);    // S^T = K Q^T
    rows_product<T, NT, TILE>(dp, Vw, a_at, dOs, b_at);  // dP^T = V dO^T
    // P^T in s, dS^T = P^T (dP^T - delta) in dp
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(Ls + 8 * j + 2 * t);
      const float2 d2 = *reinterpret_cast<const float2*>(Ds + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 8 * (e / 2);
        const int row = qt0 + 8 * j + 2 * t + (e & 1);
        const float r_lse = (e & 1) ? l2.y : l2.x;
        const float r_delta = (e & 1) ? d2.y : d2.x;
        float p = 0.f;
        if (key < S && row < S && r_lse > kDeadLse) {
          float x = s[j][e] * scale + key_bias[e / 2];
          if (causal && key > row) x = kNeg;
          p = expf(x - r_lse);
        }
        const float ds = p * (dp[j][e] - r_delta);
        db[e / 2] += ds;
        s[j][e] = p;
        dp[j][e] = ds;
      }
    }
    cols_product<T, NT, TILE>(dv_acc, s, dOs, bt_at);  // dV += round(P^T) dO
    cols_product<T, NT, TILE>(dk_acc, dp, Qs, bt_at);  // dK += round(dS^T) Q
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // the row's sum over the 4 lanes that share it, in a fixed order
    float total = db[i];
    total += __shfl_xor_sync(0xffffffffu, total, 1);
    total += __shfl_xor_sync(0xffffffffu, total, 2);
    const int key = key0 + 8 * i;
    if (dbias && t == 0 && key < S) dbias[static_cast<size_t>(bh) * S + key] = total;
  }
  const float one[2] = {1.f, 1.f}, mul[2] = {scale, scale};
  store_rows<T, NT>(dv + base, dv_acc, key0, one, S, D, t);
  store_rows<T, NT>(dk + base, dk_acc, key0, mul, S, D, t);
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

// The head-width class of D: 8 * NT padded columns.
int head_class(int D) {
  const int nt = (D + 7) / 8;
  return nt <= 4 ? 4 : nt <= 8 ? 8 : nt <= 12 ? 12 : 16;
}

// Calls launch(std::integral_constant<int, NT>()) for D's head-width class.
template <typename Launch>
int by_class(int D, Launch launch) {
  switch (head_class(D)) {
    case 4:
      return launch(std::integral_constant<int, 4>());
    case 8:
      return launch(std::integral_constant<int, 8>());
    case 12:
      return launch(std::integral_constant<int, 12>());
    default:
      return launch(std::integral_constant<int, 16>());
  }
}

// Launches a kernel over its (head, 64 rows) blocks.
template <typename... Params, typename... Args>
int launch_blocks(void (*kernel)(Params...), size_t smem, int BH, int S, cudaStream_t stream,
               Args... args) {
  int err = allow_smem(kernel, smem);
  if (err) return err;
  const long long blocks = static_cast<long long>(BH) * ((S + kRows - 1) / kRows);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape16(int BH, int H, int S, int D) {
  return bad_shape(BH, H, S, D) || D % 8 != 0;
}

template <typename T>
int fwd16(const void* q, const void* k, const void* v, const float* bias, void* o,
          float* lse, int BH, int H, int S, int D, float scale, int causal, void* stream) {
  if (bad_shape16(BH, H, S, D)) return static_cast<int>(cudaErrorInvalidValue);
  return by_class(D, [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    return launch_blocks(flash_fwd16_kernel<T, NT>, smem16<T, NT>(1, 1), BH, S,
                         static_cast<cudaStream_t>(stream), static_cast<const T*>(q),
                         static_cast<const T*>(k), static_cast<const T*>(v), bias,
                         static_cast<T*>(o), lse, H, S, D, scale, causal);
  });
}

template <typename T>
int bwd_dq16(const void* q, const void* k, const void* v, const float* bias,
             const void* dout, const float* lse, const float* delta, void* dq, int BH,
             int H, int S, int D, float scale, int causal, void* stream) {
  if (bad_shape16(BH, H, S, D)) return static_cast<int>(cudaErrorInvalidValue);
  return by_class(D, [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    return launch_blocks(flash_bwd_dq16_kernel<T, NT>, smem16<T, NT>(2, 1), BH, S,
                         static_cast<cudaStream_t>(stream), static_cast<const T*>(q),
                         static_cast<const T*>(k), static_cast<const T*>(v), bias,
                         static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), H, S,
                         D, scale, causal);
  });
}

template <typename T>
int bwd_dkdv16(const void* q, const void* k, const void* v, const float* bias,
               const void* dout, const float* lse, const float* delta, void* dk, void* dv,
               float* dbias, int BH, int H, int S, int D, float scale, int causal,
               void* stream) {
  if (bad_shape16(BH, H, S, D)) return static_cast<int>(cudaErrorInvalidValue);
  float* db = bias ? dbias : nullptr;
  return by_class(D, [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    return launch_blocks(flash_bwd_dkdv16_kernel<T, NT>, smem16<T, NT>(2, 2), BH, S,
                         static_cast<cudaStream_t>(stream), static_cast<const T*>(q),
                         static_cast<const T*>(k), static_cast<const T*>(v), bias,
                         static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk),
                         static_cast<T*>(dv), db, H, S, D, scale, causal);
  });
}

}  // namespace

extern "C" {

// Each entry point launches one kernel on `stream` (a cudaStream_t) and
// returns cudaGetLastError() as an int (0 = launched). Pointers are device
// pointers to contiguous arrays, 16-byte aligned; bias (and with it dbias)
// may be null. The _f32 builds take float32 arrays with D a multiple of 4
// up to 128.

int flash_attention_fwd_f32(const float* q, const float* k, const float* v,
                            const float* bias, float* o, float* lse, int BH,
                            int H, int S, int D, float scale, int causal,
                            void* stream) {
  if (bad_shape(BH, H, S, D)) return static_cast<int>(cudaErrorInvalidValue);
  return by_class(D, [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    return launch_blocks(flash_fwd_kernel<NT>, fwd_smem<NT>(), BH, S,
                         static_cast<cudaStream_t>(stream), q, k, v, bias, o, lse, H, S,
                         D, scale, causal);
  });
}

int flash_attention_bwd_dq_f32(const float* q, const float* k, const float* v,
                               const float* bias, const float* dout,
                               const float* lse, const float* delta, float* dq,
                               int BH, int H, int S, int D, float scale,
                               int causal, void* stream) {
  if (bad_shape(BH, H, S, D)) return static_cast<int>(cudaErrorInvalidValue);
  return by_class(D, [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    return launch_blocks(flash_bwd_dq_kernel<NT>, bwd_smem<NT>(kDqTile, 1),  // the keys' bias
                      BH, S, static_cast<cudaStream_t>(stream), q, k, v, bias, dout, lse,
                      delta, dq, H, S, D, scale, causal);
  });
}

int flash_attention_bwd_dkdv_f32(const float* q, const float* k, const float* v,
                                 const float* bias, const float* dout,
                                 const float* lse, const float* delta, float* dk,
                                 float* dv, float* dbias, int BH, int H, int S,
                                 int D, float scale, int causal, void* stream) {
  if (bad_shape(BH, H, S, D)) return static_cast<int>(cudaErrorInvalidValue);
  float* db = bias ? dbias : nullptr;
  return by_class(D, [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    return launch_blocks(flash_bwd_dkdv_kernel<NT>,
                      bwd_smem<NT>(kDkdvTile, 2),  // the rows' lse and delta
                      BH, S, static_cast<cudaStream_t>(stream), q, k, v, bias, dout, lse,
                      delta, dk, dv, db, H, S, D, scale, causal);
  });
}

// The 16-bit builds take the same arguments, with q, k, v, o, dout, dq, dk
// and dv pointers to bf16 (_bf16) or float16 (_f16) values; bias, lse,
// delta and dbias stay float32. D must be a multiple of 8 up to 128.
#define FLASH16_ENTRY_POINTS(SUFFIX, T)                                                     \
  int flash_attention_fwd_##SUFFIX(const void* q, const void* k, const void* v,             \
                                   const float* bias, void* o, float* lse, int BH, int H,   \
                                   int S, int D, float scale, int causal, void* stream) {   \
    return fwd16<T>(q, k, v, bias, o, lse, BH, H, S, D, scale, causal, stream);             \
  }                                                                                         \
  int flash_attention_bwd_dq_##SUFFIX(const void* q, const void* k, const void* v,          \
                                      const float* bias, const void* dout,                  \
                                      const float* lse, const float* delta, void* dq,       \
                                      int BH, int H, int S, int D, float scale,             \
                                      int causal, void* stream) {                           \
    return bwd_dq16<T>(q, k, v, bias, dout, lse, delta, dq, BH, H, S, D, scale, causal,     \
                       stream);                                                             \
  }                                                                                         \
  int flash_attention_bwd_dkdv_##SUFFIX(const void* q, const void* k, const void* v,        \
                                        const float* bias, const void* dout,                \
                                        const float* lse, const float* delta, void* dk,     \
                                        void* dv, float* dbias, int BH, int H, int S,       \
                                        int D, float scale, int causal, void* stream) {     \
    return bwd_dkdv16<T>(q, k, v, bias, dout, lse, delta, dk, dv, dbias, BH, H, S, D,       \
                         scale, causal, stream);                                            \
  }

FLASH16_ENTRY_POINTS(bf16, __nv_bfloat16)
FLASH16_ENTRY_POINTS(f16, __half)
#undef FLASH16_ENTRY_POINTS

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
