// Blocked top-k of |x| for Hopper (sm_90a), float32: for each block of
// `block` elements of x (the last one padded), the block's top-kk entries of
// |x| (kk = min(k, block)), written in index order.
//
// Replaces the Pallas TPU kernel `_block_topk_kernel` in
// paddle_tpu/ops/pallas/topk.py (`pl.pallas_call` at :66, body :37), called
// by `blocked_topk_abs`, whose only caller is dgc_momentum's sparse exchange
// (paddle_tpu/ops/optimizers.py:472-478). The Pallas body keeps each VMEM
// block's lax.top_k; the exact top-k over the nb * kk candidates stays
// outside the kernel, here as in JAX (kernels/topk.py: a stable descending
// sort, which gives descending value, ties by lower index).
//
// x [n] f32, vals [nb * kk] f32, idx [nb * kk] int32. Pad lanes (position
// >= n, last block only) count as |x| = -1, below every real |x| >= 0, as
// in the Pallas kernel: they are chosen only when a block has fewer than kk
// real elements, then with value -1 and their (out-of-range) position, and
// the wrapper's final selection never picks them (it runs only for n > 2k).
//
// Bound. The call must read n floats and write nb * kk (value, index)
// pairs: at word_emb [37000, 512] with k = 75,776 (DGC's k at sparsity
// 0.996), 75.8 MB read and 87.9 MB written, about 0.049 ms at 3.35 TB/s.
// No arithmetic to speak of: bytes bound it.
//
// Design (simple and exact first; making it fast is a later change). One
// thread block of 1024 threads per data block. A key orders like |x|: the
// bits of |x| plus one for a real element (non-negative floats order like
// their bit patterns; NaN above inf), 0 for a pad lane. Four 8-bit radix
// passes, most significant digit first, each a shared-memory histogram of
// the keys that match the digits found so far (warp-aggregated atomics),
// find the kk-th largest key T and how many ties at T to take (`need`).
// Then one ordered compaction in tiles of 1024 elements: a block-wide scan
// of (key > T, key == T) gives each selected element its output position,
// the number of elements above T before it plus min(ties before it, need),
// so the output lists the block's top-kk in index order, the same set as a
// stable descending sort's first kk. The block is read five times (512 KB,
// from L2 after the first pass); the next step is one read into shared
// memory or registers and a warp-level select.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t key_of(const float* x, long long pos,
                                           long long n) {
  if (pos >= n) return 0u;
  return (__float_as_uint(__ldg(x + pos)) & 0x7fffffffu) + 1u;
}

__global__ void __launch_bounds__(kThreads)
block_topk_kernel(const float* __restrict__ x, float* __restrict__ vals,
                  int32_t* __restrict__ idx, long long n, int block, int kk) {
  __shared__ unsigned hist[256];
  __shared__ unsigned long long warp_sums[kWarps];
  __shared__ unsigned long long tile_total;
  __shared__ uint32_t s_prefix;
  __shared__ unsigned s_need;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long start = static_cast<long long>(blockIdx.x) * block;

  if (tid == 0) {
    s_prefix = 0u;
    s_need = static_cast<unsigned>(kk);
  }
  // -- select: the kk-th largest key, one 8-bit digit per pass -------------
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    const uint32_t hi_mask = pass == 0 ? 0u : (0xffffffffu << (shift + 8));
    for (int d = tid; d < 256; d += kThreads) hist[d] = 0u;
    __syncthreads();
    const uint32_t prefix = s_prefix;
    for (int base = 0; base < block; base += kThreads) {
      const int i = base + tid;
      uint32_t key = 0u;
      bool in = false;
      if (i < block) {
        key = key_of(x, start + i, n);
        in = (key & hi_mask) == prefix;
      }
      const unsigned active = __ballot_sync(kFull, in);
      if (in) {
        const unsigned digit = (key >> shift) & 0xffu;
        const unsigned peers = __match_any_sync(active, digit);
        if (lane == __ffs(peers) - 1)
          atomicAdd(&hist[digit], static_cast<unsigned>(__popc(peers)));
      }
    }
    __syncthreads();
    if (warp == 0) {
      // lane l holds digits 255 - 8l down to 248 - 8l: the scan over lanes
      // runs from the largest digit down
      const unsigned need = s_need;
      unsigned c[8];
      unsigned sum = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = hist[255 - (lane * 8 + j)];
        sum += c[j];
      }
      unsigned incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned t = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += t;
      }
      const unsigned excl = incl - sum;
      if (excl < need && need <= incl) {
        unsigned acc = excl;
        for (int j = 0; j < 8; ++j) {
          if (acc + c[j] >= need) {
            const uint32_t digit = 255u - static_cast<uint32_t>(lane * 8 + j);
            s_prefix = prefix | (digit << shift);
            s_need = need - acc;
            break;
          }
          acc += c[j];
        }
      }
    }
    __syncthreads();
  }
  const uint32_t T = s_prefix;
  const unsigned long long need = s_need;

  // -- ordered compaction ---------------------------------------------------
  float* out_v = vals + static_cast<long long>(blockIdx.x) * kk;
  int32_t* out_i = idx + static_cast<long long>(blockIdx.x) * kk;
  unsigned long long gt_base = 0ull, eq_base = 0ull;
  for (int base = 0; base < block; base += kThreads) {
    const int i = base + tid;
    uint32_t key = 0u;
    if (i < block) key = key_of(x, start + i, n);
    const bool valid = i < block;
    const bool gt = valid && key > T;
    const bool eq = valid && key == T;
    // (count above T) << 32 | (count at T), scanned together
    const unsigned long long mine =
        (static_cast<unsigned long long>(gt) << 32) | static_cast<unsigned long long>(eq);
    unsigned long long incl = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned long long t = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += t;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const unsigned long long w = warp_sums[lane];
      unsigned long long wi = w;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned long long t = __shfl_up_sync(kFull, wi, off);
        if (lane >= off) wi += t;
      }
      warp_sums[lane] = wi - w;  // exclusive prefix of each warp
    }
    __syncthreads();
    const unsigned long long total_before = warp_sums[warp] + incl - mine;
    const unsigned long long gt_before = gt_base + (total_before >> 32);
    const unsigned long long eq_before = eq_base + (total_before & 0xffffffffull);
    if (gt || (eq && eq_before < need)) {
      const unsigned long long pos =
          gt_before + (eq_before < need ? eq_before : need);
      const long long g = start + i;
      out_v[pos] = g < n ? fabsf(__ldg(x + g)) : -1.0f;
      out_i[pos] = static_cast<int32_t>(g);
    }
    // the block's totals for this tile: the last thread's inclusive sum
    if (tid == kThreads - 1) tile_total = warp_sums[warp] + incl;
    __syncthreads();
    gt_base += tile_total >> 32;
    eq_base += tile_total & 0xffffffffull;
    __syncthreads();  // warp_sums and tile_total are rewritten next tile
  }
}

}  // namespace

extern "C" {

// Launches the per-block stage on `stream` (a cudaStream_t) and returns
// cudaGetLastError() as an int (0 = launched). x is a device pointer to n
// contiguous floats; vals/idx hold ceil(n / block) * kk entries.
int blocked_topk_abs_f32(const float* x, float* vals, int32_t* idx,
                         long long n, int block, int kk, void* stream) {
  if (n <= 0 || block <= 0 || kk <= 0 || kk > block)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nb = (n + block - 1) / block;
  if (nb * static_cast<long long>(block) >= (1ll << 31) || nb >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  block_topk_kernel<<<static_cast<unsigned>(nb), kThreads, 0, st>>>(
      x, vals, idx, n, block, kk);
  return static_cast<int>(cudaGetLastError());
}

const char* blocked_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
