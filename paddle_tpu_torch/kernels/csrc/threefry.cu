// Threefry-2x32 random bits and the fused dropout forward for Hopper
// (sm_90a): K8.
//
// Replaces no Pallas kernel. The JAX package draws every random number
// through jax.random, which XLA compiles to threefry2x32 (20 rounds, the
// partitionable counter layout of jax_threefry_partitionable): the
// executor's per-op keys (paddle_tpu/core/executor.py:147-148), the random
// ops (paddle_tpu/ops/tensor.py:375-436) and dropout's mask
// (paddle_tpu/ops/nn.py:321-356, jax.random.bernoulli). This kernel gives
// the same bytes on the card, so a seed gives the JAX package's weights and
// masks.
//
// Entry points (C interface, ctypes; each returns cudaGetLastError()):
// * threefry_random_bits: out[i] = y0 ^ y1 of threefry2x32(key, hi(c),
//   lo(c)), c = base + i the counter of flat index i split into high and
//   low 32-bit words — jax.random.bits(key, (n,), uint32) at base 0, and
//   elements [base, base + n) of a larger draw otherwise (a data-parallel
//   rank's rows of the global draw);
// * threefry_dropout_f32: for each element, u = the float in [0, 1) from
//   the top 23 bits of its draw (jax.random.uniform's construction), kept
//   where u < keep (the float32 1 - p, as jax.random.bernoulli compares);
//   Mask = 1 or 0, Out = x / scale where kept and 0 elsewhere with
//   upscale (an IEEE division, __fdiv_rn, as the op's source divides),
//   else x * Mask; element i hashes the counter base + i, as above. The
//   key's two words and the base are launch arguments: the host computes
//   them with no device sync.
//
// Bound. A draw is one threefry2x32: 2 adds in, 20 rounds of add, rotate
// (one funnel shift) and xor, 10 key-injection adds and the output xor, 73
// 32-bit integer operations at least (the compiled SASS holds about 104).
// An SM dispatches at most one warp instruction a scheduler a cycle, 128
// thread operations a cycle (the 64 INT32 lanes plus the FMA lanes, which
// run IMAD): 33.4 T operations/s over 132 SMs at 1.98 GHz. A [32, 128, 768]
// float32 dropout site (3.15M draws) moves 37.7 MB (x read, Out and Mask
// written), 11.3 us at 3.35 TB/s, against 6.9 us of integer work: bytes
// bound it. random_bits writes 4 bytes a draw, so its integer work bounds
// it (BERT-base's word_embedding, 23.4M draws: 51.2 us; bytes 28.0 us).
// On the card (chip_smoke.py phase 2e, H100 80GB HBM3): the dropout site
// 15.9 us, the word_embedding draw 79.1 us, which is the dispatch rate over
// the compiled instruction count (about 104 a draw): the compiler's
// instructions, not the algorithm's 73, pace it.
//
// Design. One thread takes 4 contiguous elements: one 16-byte load of x and
// two 16-byte stores (Out, Mask), 4 threefry evaluations in registers; a
// grid-stride loop covers any n. The quad's 4 counters share their high
// word (a base that is a multiple of 4 keeps the low words from carrying).
// Each kernel is built twice: for counter 0, with no base arithmetic (a
// base added to every counter measured 5-8% slower at the hidden site than
// the kernel before the base; tools/torch_k8_cost.py), and for a nonzero
// base. Pointers that are not 16-byte aligned, a base that is not a
// multiple of 4, and the ragged last quad take a scalar path. Built without --use_fast_math:
// the division is the correctly rounded one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// y0 ^ y1 of threefry2x32(key, (hi, lo)): the counter's two words
__device__ __forceinline__ uint32_t threefry_words(uint32_t k0, uint32_t k1,
                                                   uint32_t hi, uint32_t lo) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = hi + k0;
  uint32_t x1 = lo + k1;
#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r) ^ x0;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
#undef TF_ROUND
  return x0 ^ x1;
}

__device__ __forceinline__ uint32_t threefry_xor(uint32_t k0, uint32_t k1,
                                                 unsigned long long c) {
  return threefry_words(k0, k1, static_cast<uint32_t>(c >> 32),
                        static_cast<uint32_t>(c));
}

// jax.random.uniform's float in [0, 1) from 32 bits
__device__ __forceinline__ float unit_float(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// kBase: the counters start at `base` (a data-parallel rank's block);
// false compiles the counter-0 kernel without the base's arithmetic
template <bool kBase>
__global__ void __launch_bounds__(kThreads)
random_bits_kernel(uint32_t* __restrict__ out, long long n, uint32_t k0,
                   uint32_t k1, unsigned long long base, int vec) {
  const long long quads = (n + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long q = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       q < quads; q += stride) {
    const long long i = q * 4;
    if (vec && i + 3 < n) {
      // vec implies base % 4 == 0: the quad's counters share their high
      // word, and the low words take no carry
      const unsigned long long c = kBase ? base + i : i;
      const uint32_t hi = static_cast<uint32_t>(c >> 32);
      const uint32_t lo = static_cast<uint32_t>(c);
      uint4 v;
      v.x = threefry_words(k0, k1, hi, lo);
      v.y = threefry_words(k0, k1, hi, lo + 1u);
      v.z = threefry_words(k0, k1, hi, lo + 2u);
      v.w = threefry_words(k0, k1, hi, lo + 3u);
      *reinterpret_cast<uint4*>(out + i) = v;
    } else {
      for (long long j = i; j < n && j < i + 4; ++j)
        out[j] = threefry_xor(k0, k1, kBase ? base + j : j);
    }
  }
}

__device__ __forceinline__ void drop_one(float x, uint32_t bits, float keep,
                                         float scale, int upscale,
                                         float* out, float* mask) {
  const bool kept = unit_float(bits) < keep;
  const float m = kept ? 1.0f : 0.0f;
  *mask = m;
  *out = upscale ? (kept ? __fdiv_rn(x, scale) : 0.0f) : x * m;
}

template <bool kBase>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const float* __restrict__ x, float* __restrict__ out,
               float* __restrict__ mask, long long n, uint32_t k0,
               uint32_t k1, unsigned long long base, float keep, float scale,
               int upscale, int vec) {
  const long long quads = (n + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long q = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       q < quads; q += stride) {
    const long long i = q * 4;
    if (vec && i + 3 < n) {
      const float4 xv = __ldg(reinterpret_cast<const float4*>(x + i));
      // as in random_bits_kernel: one high word for the quad
      const unsigned long long c = kBase ? base + i : i;
      const uint32_t hi = static_cast<uint32_t>(c >> 32);
      const uint32_t lo = static_cast<uint32_t>(c);
      float4 o, m;
      drop_one(xv.x, threefry_words(k0, k1, hi, lo), keep, scale, upscale,
               &o.x, &m.x);
      drop_one(xv.y, threefry_words(k0, k1, hi, lo + 1u), keep, scale,
               upscale, &o.y, &m.y);
      drop_one(xv.z, threefry_words(k0, k1, hi, lo + 2u), keep, scale,
               upscale, &o.z, &m.z);
      drop_one(xv.w, threefry_words(k0, k1, hi, lo + 3u), keep, scale,
               upscale, &o.w, &m.w);
      *reinterpret_cast<float4*>(out + i) = o;
      *reinterpret_cast<float4*>(mask + i) = m;
    } else {
      for (long long j = i; j < n && j < i + 4; ++j)
        drop_one(x[j], threefry_xor(k0, k1, kBase ? base + j : j), keep,
                 scale, upscale, out + j, mask + j);
    }
  }
}

unsigned grid_for(long long n) {
  long long blocks = ((n + 3) / 4 + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned>(blocks);
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Make `device` current for a launch; returns the previous device in *prev.
cudaError_t enter(int device, int* prev) {
  cudaError_t err = cudaGetDevice(prev);
  if (err == cudaSuccess && *prev != device) err = cudaSetDevice(device);
  return err;
}

cudaError_t leave(int device, int prev, cudaError_t err) {
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return err;
}

}  // namespace

extern "C" {

// Elements [base, base + n) of jax.random.bits(key, (N,), uint32), N >=
// base + n, into `out` ([n] uint32 on card `device`), on `stream`.
int threefry_random_bits(int device, uint32_t* out, long long n,
                         unsigned k0, unsigned k1, unsigned long long base,
                         cudaStream_t stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  int prev = 0;
  cudaError_t err = enter(device, &prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = aligned(out) && base % 4 == 0 ? 1 : 0;
  if (base == 0)
    random_bits_kernel<false><<<grid_for(n), kThreads, 0, stream>>>(
        out, n, k0, k1, base, vec);
  else
    random_bits_kernel<true><<<grid_for(n), kThreads, 0, stream>>>(
        out, n, k0, k1, base, vec);
  return static_cast<int>(leave(device, prev, cudaGetLastError()));
}

// Dropout of float32 `x` ([n], contiguous) into `out` and `mask`: keep
// where the element's uniform is below `keep`; Out = x / scale there with
// `upscale`, else x * Mask. Element i draws the counter base + i.
int threefry_dropout_f32(int device, const float* x, float* out,
                         float* mask, long long n, unsigned k0, unsigned k1,
                         unsigned long long base, float keep, float scale,
                         int upscale, cudaStream_t stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  int prev = 0;
  cudaError_t err = enter(device, &prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec =
      aligned(x) && aligned(out) && aligned(mask) && base % 4 == 0 ? 1 : 0;
  if (base == 0)
    dropout_kernel<false><<<grid_for(n), kThreads, 0, stream>>>(
        x, out, mask, n, k0, k1, base, keep, scale, upscale, vec);
  else
    dropout_kernel<true><<<grid_for(n), kThreads, 0, stream>>>(
        x, out, mask, n, k0, k1, base, keep, scale, upscale, vec);
  return static_cast<int>(leave(device, prev, cudaGetLastError()));
}

const char* threefry_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
