// Paged decode attention for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel behind `paged_attention` and
// `decode_attention` in paddle_tpu/kernels/attention.py (both reach
// `pl.pallas_call` through `_pallas_full_block`, :116-128). There the whole
// workset sits in VMEM and one program runs the gather+softmax+matmul
// composite. Here the same function is computed for one query row per slot:
//
//   out[s] = sum_p softmax_p(q[s] . K[rows[s*L+p]] * sm_scale + bias[s,p]) * V[rows[s*L+p]]
//
// q [S, H], K/V arenas [R, H], rows [S*L] int64, bias [S, 1, L] -> out [S, H].
// `decode_attention` is the same kernel over the [S*L, H] view of a dense
// [S, L, H] cache, with rows == nullptr meaning rows[i] == i.
//
// Bound: bytes. Each output needs L K rows and L V rows of H floats and
// does two multiply-adds per element read: at the decode engine's shapes
// (S=8, L=1024, H=768) the kernel reads 50.3 MB of rows a call, 15 us at
// 3.35 TB/s, against 25 MFLOP. Every row the composite reads is read: a
// position whose weight comes out 0 still has its V row read (0 * inf is
// NaN in both).
//
// Design: one launch that keeps many row loads in flight.
// - Eight slots are far too few blocks for 132 SMs, so each slot's L
//   positions are split into chunks (flash-decoding): grid (n_split, S),
//   one block of 256 threads per chunk. The chunk size comes from the
//   caller (kernels/attention.py `split_plan`, a host-side function of S,
//   L and the SM count): about two blocks an SM, 32 positions a block at
//   the engine's shapes.
// - The block's row indices go to shared memory; then each warp takes
//   kBatch positions at a time and issues all of their 16-byte K loads
//   (lanes on neighbouring addresses; 24 a lane at H = 768) before it
//   reduces the kBatch dot products with interleaved shuffles.
// - After one barrier every warp takes the chunk's max from the scores in
//   shared memory, the block writes the weights exp(score - max) once, and
//   after a second barrier each thread owns a float4 column of the chunk's
//   weighted V sum, with kUnroll rows' loads in flight before it adds them
//   in position order. Three barriers before the partial is written (the
//   two-kernel design before it had six), two around the arrival.
// - The partial (acc, m, l) goes to scratch that the caller allocates,
//   and the block bumps its slot's arrival counter; the block that arrives
//   last combines the slot's partials: every split's (m, l) loaded at once
//   into shared memory, the weights exp(m_i - max m) and the total weight
//   summed there in split order, then each thread's column of the rescaled
//   partials, kUnroll of them in flight, in split order. The order does
//   not depend on which block arrives last, so two launches give the same
//   bits. The counters live in the scratch's tail and are zeroed by a
//   cudaMemsetAsync in the same C call, on the same stream, before the
//   launch.
// - Measured on an H100 (PERF.md §6): the combine's tail and the
//   arrival cost about 3 us of the call and the memset about 1 us; larger
//   or smaller chunks, other unrolls and batches, prefetching V into L2,
//   or staging a chunk's rows in shared memory were all slower or no
//   faster.
// Rows must lie in [0, R): the decode engine checks its row map on the
// host before each step, so a bad map raises there on every device. The
// kernel clamps an index outside that range only so that it never reads
// outside the arena.
//
// Semantics kept from the composite: a position with bias -1e9 has
// exp(score - max) == 0.0 exactly whenever its slot has an unmasked
// position, and a slot whose bias row is all -1e9 gives the uniform
// average of its V rows (all scores round to the same float). Sums run in
// another order than the composite's matmuls, so results agree to a
// tolerance, not bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 4;   // positions whose K loads a warp issues together
constexpr int kUnroll = 16;  // V rows (partials) a thread has in flight

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ void fma4(float4& acc, float w, const float4& b) {
  acc.x += w * b.x;
  acc.y += w * b.y;
  acc.z += w * b.z;
  acc.w += w * b.w;
}

// One block per (chunk of `chunk` positions, slot). Shared memory: rows
// [chunk] (int64) | scores [W] | weights [W], W = max(chunk, n_split) (the
// combine keeps a slot's split weights there).
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const int64_t* __restrict__ rows,
                       const float* __restrict__ bias, float* __restrict__ out,
                       float* __restrict__ part_acc, float* __restrict__ part_ml,
                       unsigned* __restrict__ arrivals, int L, int H, long long R,
                       float sm_scale, int chunk) {
  extern __shared__ __align__(16) float smem[];
  long long* row_sh = reinterpret_cast<long long*>(smem);
  float* score = reinterpret_cast<float*>(row_sh + chunk);
  float* weight = score + max(chunk, static_cast<int>(gridDim.x));
  __shared__ float red[kWarps];
  __shared__ bool last;
  const int split = blockIdx.x, n_split = gridDim.x, s = blockIdx.y;
  const int H4 = H / 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p0 = split * chunk;
  const int n = min(chunk, L - p0);  // <= 0 only past a caller's surplus splits
  const size_t base = static_cast<size_t>(s) * L + p0;

  for (int i = threadIdx.x; i < n; i += kThreads) {
    const long long r = rows ? rows[base + i] : static_cast<long long>(base + i);
    row_sh[i] = r < 0 ? 0 : (r >= R ? R - 1 : r);
  }
  __syncthreads();

  // scores: a warp takes kBatch positions, all their K loads in flight
  const float4* q4 = reinterpret_cast<const float4*>(q + static_cast<size_t>(s) * H);
  const float4* k4 = reinterpret_cast<const float4*>(k);
  for (int i0 = warp * kBatch; i0 < n; i0 += kWarps * kBatch) {
    const float4* kr[kBatch];
    float d[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      kr[b] = k4 + (i0 + b < n ? row_sh[i0 + b] : row_sh[i0]) * H4;
      d[b] = 0.f;
    }
#pragma unroll 6
    for (int c = lane; c < H4; c += 32) {
      const float4 a = __ldg(q4 + c);
      float4 x[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (i0 + b < n) x[b] = __ldg(kr[b] + c);
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (i0 + b < n) d[b] += dot4(a, x[b]);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) d[b] = warp_sum(d[b]);
    if (lane == 0)
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (i0 + b < n) score[i0 + b] = d[b] * sm_scale + bias[base + i0 + b];
  }
  __syncthreads();

  // the chunk's max (every warp the same) and its weights
  float m = -INFINITY;
  for (int i = lane; i < n; i += 32) m = fmaxf(m, score[i]);
  m = warp_max(m);
  for (int i = threadIdx.x; i < n; i += kThreads) weight[i] = expf(score[i] - m);
  __syncthreads();

  // weighted V rows: thread c owns float4 column c, in position order
  const size_t part = static_cast<size_t>(s) * n_split + split;
  const float4* v4 = reinterpret_cast<const float4*>(v);
  float4* acc4 = reinterpret_cast<float4*>(part_acc + part * H);
  for (int c = threadIdx.x; c < H4; c += kThreads) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    int i = 0;
    for (; i + kUnroll <= n; i += kUnroll) {
      float4 x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) x[u] = __ldg(v4 + row_sh[i + u] * H4 + c);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) fma4(acc, weight[i + u], x[u]);
    }
    for (; i < n; ++i) fma4(acc, weight[i], __ldg(v4 + row_sh[i] * H4 + c));
    acc4[c] = acc;
  }
  if (warp == 0) {
    float l = 0.f;
    for (int i = lane; i < n; i += 32) l += weight[i];
    l = warp_sum(l);
    if (lane == 0) {
      part_ml[2 * part] = m;
      part_ml[2 * part + 1] = l;
    }
  }

  // the last block of the slot to arrive combines its partials (the
  // fences as in a grid-wide barrier: thread 0 fences after the block's
  // barrier, so the block's partial is visible before its arrival, and
  // the last block's thread 0 fences before its barrier releases the reads)
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(arrivals + s, 1u) == static_cast<unsigned>(n_split - 1);
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;
  // the slot's split weights, every split's (m, l) loaded at once: m_i
  // into score[], then w_i = exp(m_i - max m) into weight[] and w_i l_i
  // into score[] (l_i == 0 marks a split with no position)
  const float* ml = part_ml + static_cast<size_t>(s) * n_split * 2;
  float mx = -INFINITY;
  for (int i = threadIdx.x; i < n_split; i += kThreads) {
    const float mi = __ldcg(ml + 2 * i), li = __ldcg(ml + 2 * i + 1);
    score[i] = mi;
    weight[i] = li;
    if (li > 0.f) mx = fmaxf(mx, mi);
  }
  mx = warp_max(mx);
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  float M = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) M = fmaxf(M, red[w]);
  for (int i = threadIdx.x; i < n_split; i += kThreads) {
    const float li = weight[i];
    const float wi = li > 0.f ? expf(score[i] - M) : 0.f;
    weight[i] = wi;
    score[i] = wi * li;
  }
  __syncthreads();
  float total = 0.f;  // in split order, the same in every thread
  for (int i = 0; i < n_split; ++i) total += score[i];
  const float inv = 1.f / total;
  const float4* slot4 = reinterpret_cast<const float4*>(part_acc) +
                        static_cast<size_t>(s) * n_split * H4;
  float4* out4 = reinterpret_cast<float4*>(out + static_cast<size_t>(s) * H);
  for (int c = threadIdx.x; c < H4; c += kThreads) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    int i = 0;
    for (; i + kUnroll <= n_split; i += kUnroll) {
      float4 x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        x[u] = __ldcg(slot4 + static_cast<size_t>(i + u) * H4 + c);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) fma4(a, weight[i + u], x[u]);
    }
    for (; i < n_split; ++i) fma4(a, weight[i], __ldcg(slot4 + static_cast<size_t>(i) * H4 + c));
    out4[c] = make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
  }
}

}  // namespace

extern "C" {

// Zeroes the slots' arrival counters and launches the kernel on `stream` (a
// cudaStream_t); returns the first CUDA error as an int (0 = launched).
// Pointers are device pointers; q/k/v/bias/out must be 16-byte aligned and
// contiguous; H must be a multiple of 4; rows may be null (identity rows,
// R >= S*L); part_acc holds S*n_split*H floats, part_ml S*n_split*2 floats
// followed by S 32-bit words (the counters), with n_split*chunk >= L.
int paged_attention_f32(const float* q, const float* k, const float* v,
                        const int64_t* rows, const float* bias, float* out,
                        float* part_acc, float* part_ml, int S, int L, int H,
                        long long R, float sm_scale, int chunk, int n_split,
                        void* stream) {
  if (S <= 0 || L <= 0 || H <= 0 || H % 4 != 0 || R <= 0 || chunk <= 0 ||
      chunk % 2 != 0 || n_split <= 0 ||
      static_cast<long long>(n_split) * chunk < L || n_split > 65535 || S > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* arrivals = reinterpret_cast<unsigned*>(part_ml + static_cast<size_t>(S) * n_split * 2);
  cudaError_t e = cudaMemsetAsync(arrivals, 0, sizeof(unsigned) * S, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = sizeof(long long) * chunk + 2 * sizeof(float) * (chunk > n_split ? chunk : n_split);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(paged_attention_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  paged_attention_kernel<<<dim3(n_split, S), kThreads, smem, st>>>(
      q, k, v, rows, bias, out, part_acc, part_ml, arrivals, L, H, R, sm_scale, chunk);
  return static_cast<int>(cudaGetLastError());
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
