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
// Bound. Each output needs L K rows and L V rows of H floats and does two
// multiply-adds per element read, so the kernel is bound by memory traffic:
// at the decode engine's shapes (S=8, L=1024, H=768) that is 50 MB of rows
// per call, about 15 us at 3.35 TB/s, against about 25 MFLOP.
//
// Design. Eight slots are far too few blocks for 132 SMs, so each slot's L
// positions are split into chunks (flash-decoding): grid (S, n_split), one
// block per chunk. A block stages q and its chunk's row indices in shared
// memory; each warp takes whole positions and reads K rows as 16-byte
// vectors (lanes on neighbouring addresses), reduces the dot product with
// shuffles, and writes the chunk's scores to shared memory. The block then
// takes the chunk max m and the exponentials (sum l), and every thread
// accumulates one float4 column of sum_p e_p * V[row_p]. The partial
// (acc, m, l) goes to scratch that the caller allocates; a second kernel
// rescales the partials of one slot by exp(m_i - max m) and divides,
// its column groups in parallel.
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reductions through `red` (kWarps floats). Every thread gets
// the result; `red` is free again when the function returns.
__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = lane < kWarps ? red[lane] : -INFINITY;
  r = warp_max(r);
  __syncthreads();
  return r;
}

__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = lane < kWarps ? red[lane] : 0.f;
  r = warp_sum(r);
  __syncthreads();
  return r;
}

// One block per (slot, chunk of `chunk` positions).
// Shared memory: q [H] | scores [chunk] | rows [chunk] (int64) | red [kWarps].
__global__ void __launch_bounds__(kThreads)
paged_attention_partial(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int64_t* __restrict__ rows,
                        const float* __restrict__ bias,
                        float* __restrict__ part_acc,
                        float* __restrict__ part_ml,
                        int L, int H, long long R, float sm_scale, int chunk) {
  extern __shared__ __align__(16) float smem[];
  const int s = blockIdx.x;
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int H4 = H / 4;
  float4* q_sh = reinterpret_cast<float4*>(smem);
  float* score = smem + H;
  long long* row_sh = reinterpret_cast<long long*>(score + chunk);
  float* red = reinterpret_cast<float*>(row_sh + chunk);

  const int p0 = split * chunk;
  const int n = min(chunk, L - p0);
  const size_t base = static_cast<size_t>(s) * L + p0;

  const float4* q4 = reinterpret_cast<const float4*>(q + static_cast<size_t>(s) * H);
  for (int c = threadIdx.x; c < H4; c += kThreads) q_sh[c] = q4[c];
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const long long r = rows ? rows[base + i] : static_cast<long long>(base + i);
    row_sh[i] = r < 0 ? 0 : (r >= R ? R - 1 : r);
  }
  __syncthreads();

  // scores: one warp per position, 16-byte loads across the row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < n; i += kWarps) {
    const float4* k4 = reinterpret_cast<const float4*>(k + row_sh[i] * H);
    float acc = 0.f;
    for (int c = lane; c < H4; c += 32) {
      const float4 a = q_sh[c];
      const float4 b = __ldg(k4 + c);
      acc += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
    }
    acc = warp_sum(acc);
    if (lane == 0) score[i] = acc * sm_scale + bias[base + i];
  }
  __syncthreads();

  float m = -INFINITY;
  for (int i = threadIdx.x; i < n; i += kThreads) m = fmaxf(m, score[i]);
  m = block_max(m, red);
  float l = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float e = expf(score[i] - m);
    score[i] = e;
    l += e;
  }
  l = block_sum(l, red);  // its barriers also publish score[]

  // weighted V rows: thread c owns float4 column c
  float4* out4 = reinterpret_cast<float4*>(
      part_acc + (static_cast<size_t>(s) * n_split + split) * H);
  for (int c = threadIdx.x; c < H4; c += kThreads) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const float w = score[i];
      const float4 b = __ldg(reinterpret_cast<const float4*>(v + row_sh[i] * H) + c);
      acc.x += w * b.x;
      acc.y += w * b.y;
      acc.z += w * b.z;
      acc.w += w * b.w;
    }
    out4[c] = acc;
  }
  if (threadIdx.x == 0) {
    float* ml = part_ml + (static_cast<size_t>(s) * n_split + split) * 2;
    ml[0] = m;
    ml[1] = l;
  }
}

// Grid (S, column groups): rescale the chunk partials of one slot to its
// max and divide by the total weight. Every block recomputes the slot's
// n_split weights (a block-wide reduction), then each thread owns one
// output column. Shared memory: n_split weights.
__global__ void __launch_bounds__(kThreads)
paged_attention_combine(const float* __restrict__ part_acc,
                        const float* __restrict__ part_ml,
                        float* __restrict__ out, int H, int n_split) {
  extern __shared__ __align__(16) float w_sh[];
  __shared__ float red[kWarps];
  const int s = blockIdx.x;
  const float* ml = part_ml + static_cast<size_t>(s) * n_split * 2;
  float M = -INFINITY;
  for (int i = threadIdx.x; i < n_split; i += kThreads)
    if (ml[2 * i + 1] > 0.f) M = fmaxf(M, ml[2 * i]);
  M = block_max(M, red);
  float d = 0.f;
  for (int i = threadIdx.x; i < n_split; i += kThreads) {
    const float l = ml[2 * i + 1];
    const float w = l > 0.f ? expf(ml[2 * i] - M) : 0.f;
    w_sh[i] = w;
    d += w * l;
  }
  d = block_sum(d, red);  // its barriers also publish w_sh[]
  const float* acc = part_acc + static_cast<size_t>(s) * n_split * H;
  for (int c = blockIdx.y * kThreads + threadIdx.x; c < H;
       c += gridDim.y * kThreads) {
    float a = 0.f;
#pragma unroll 8
    for (int i = 0; i < n_split; ++i) a += w_sh[i] * acc[static_cast<size_t>(i) * H + c];
    out[static_cast<size_t>(s) * H + c] = a / d;
  }
}

}  // namespace

extern "C" {

// Launches both kernels on `stream` (a cudaStream_t) and returns
// cudaGetLastError() as an int (0 = launched). Pointers are device
// pointers; q/k/v/bias/out must be 16-byte aligned and contiguous; H must
// be a multiple of 4; rows may be null (identity rows, R >= S*L);
// part_acc holds S*n_split*H floats, part_ml S*n_split*2, with
// n_split*chunk >= L.
int paged_attention_f32(const float* q, const float* k, const float* v,
                        const int64_t* rows, const float* bias, float* out,
                        float* part_acc, float* part_ml, int S, int L, int H,
                        long long R, float sm_scale, int chunk, int n_split,
                        void* stream) {
  if (S <= 0 || L <= 0 || H <= 0 || H % 4 != 0 || R <= 0 || chunk <= 0 ||
      chunk % 2 != 0 || n_split <= 0 ||
      static_cast<long long>(n_split) * chunk < L || n_split > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * (H + chunk) + sizeof(long long) * chunk +
                      sizeof(float) * kWarps;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_partial, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  paged_attention_partial<<<dim3(S, n_split), kThreads, smem, st>>>(
      q, k, v, rows, bias, part_acc, part_ml, L, H, R, sm_scale, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int col_groups = (H + kThreads - 1) / kThreads;
  paged_attention_combine<<<dim3(S, col_groups), kThreads,
                            sizeof(float) * n_split, st>>>(
      part_acc, part_ml, out, H, n_split);
  return static_cast<int>(cudaGetLastError());
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
