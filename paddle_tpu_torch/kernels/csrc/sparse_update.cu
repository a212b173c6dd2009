// Sparse row update for Hopper (sm_90a), float32: param[ids[i]] += rows[i]
// for i < n_unique, in place.
//
// Replaces the Pallas TPU kernel `sparse_row_update` in
// paddle_tpu/ops/pallas/sparse_update.py (`pl.pallas_call` at :57, body
// :31, caller `sgd_sparse` in paddle_tpu/ops/optimizers.py:51-73). After
// sgd_sparse merges duplicate ids (unique + segment-sum of the scaled rows,
// plain tensor ops), every destination row is touched once: param [V, D]
// f32, ids [N] int32 distinct among the first n_unique, rows [N, D] f32.
//
// The JAX caller pads to N with fill rows that repeat id 0 and relies on
// the TPU's in-order grid (fill rows first) so that a fill row's write of
// param[0] + 0 cannot land after the real id-0 update. Blocks here run in
// no order, so this kernel never touches a row at or past n_unique: the
// caller passes the real unique count, and fill rows are ignored.
//
// Bound. Each touched element is read once from param and rows and written
// once: at the dense CTR shapes (about 12k unique rows of D = 16 or 1 per
// call) about 2.4 MB, under a microsecond at 3.35 TB/s, so the launch (a
// few microseconds) bounds it.
//
// Design. One thread per element, as one float4 (16 bytes, neighbouring
// threads on neighbouring addresses) when D is a multiple of 4 and the
// pointers are 16-byte aligned, else one float (D = 1, the wide tables).
// The ids are distinct, so each element gets one plain read-add-write and
// no atomics: the result is p + r, the same bits as index_add_ over the
// same rows. The wrapper raises on an id outside [0, V) before the launch;
// the kernel still skips one, so nothing outside param is ever written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 8192;

__device__ __forceinline__ void add_to(float* p, float r) { *p += r; }

__device__ __forceinline__ void add_to(float4* p, float4 r) {
  float4 v = *p;
  v.x += r.x;
  v.y += r.y;
  v.z += r.z;
  v.w += r.w;
  *p = v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
row_update_kernel(T* __restrict__ param, const int32_t* __restrict__ ids,
                  const T* __restrict__ rows, long long n, long long vocab,
                  long long width) {
  const long long total = n * width;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < total; t += stride) {
    const long long i = t / width;
    const long long id = __ldg(ids + i);
    if (id >= 0 && id < vocab)
      add_to(param + id * width + (t - i * width), __ldg(rows + t));
  }
}

}  // namespace

extern "C" {

// Launches the update of the first `n_unique` rows on `stream` (a
// cudaStream_t) and returns cudaGetLastError() as an int (0 = launched, or
// nothing to do). Pointers are device pointers to contiguous arrays.
int sparse_row_update_f32(float* param, const int32_t* ids, const float* rows,
                          long long n_unique, long long vocab, long long d,
                          void* stream) {
  if (n_unique < 0 || vocab <= 0 || d <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_unique == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(param) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  const long long width = vec ? d / 4 : d;
  long long blocks = (n_unique * width + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (vec) {
    row_update_kernel<float4><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        reinterpret_cast<float4*>(param), ids,
        reinterpret_cast<const float4*>(rows), n_unique, vocab, width);
  } else {
    row_update_kernel<float><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        param, ids, rows, n_unique, vocab, width);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* sparse_row_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
