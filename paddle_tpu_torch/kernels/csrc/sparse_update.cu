// Sparse row update for Hopper (sm_90a), float32: param[ids[i]] += rows[i]
// for i < n_unique, in place.
//
// Replaces the Pallas TPU kernel `sparse_row_update` in
// paddle_tpu/ops/pallas/sparse_update.py (`pl.pallas_call` at :57, body
// :31, caller `sgd_sparse` in paddle_tpu/ops/optimizers.py:51-73). After
// sgd_sparse merges duplicate ids (unique + segment-sum of the scaled rows,
// plain tensor ops), every destination row is touched once: param [V, D]
// f32, ids [N] int32 or int64 (torch.unique's ids go in as they come),
// distinct among the first n_unique, rows [N, D] f32.
//
// The JAX caller pads to N with fill rows that repeat id 0 and relies on
// the TPU's in-order grid (fill rows first) so that a fill row's write of
// param[0] + 0 cannot land after the real id-0 update. Blocks here run in
// no order, so this kernel never touches a row at or past n_unique: the
// caller passes the real unique count, and fill rows are ignored.
//
// Ids outside [0, V). The JAX kernel checks nothing. This one skips such an
// id, so nothing outside param is ever written, and records it without a
// sync: the first thread to find one takes a flag word in device memory
// (atomicCAS) and writes the id, then a "set" word, into host words that
// are pinned and mapped into the device's address space. The wrapper reads
// those host words on its next call, and the executor after the copy of
// its fetches (kernels/sparse_update.py), and raises ValueError there.
//
// Bound. Each touched element is read once from param and rows and written
// once: at the dense CTR shapes (about 12k unique rows of D = 16 or 1 per
// call) about 2.4 MB, 0.71 us at 3.35 TB/s. The card cannot reach that: an
// empty kernel launched through the same route (the launch floor) takes
// 2.0 us of device time and 4-7.5 us of host time a call, and this kernel
// 2.9 us of device time at 12.2k rows of D = 16 (chip_smoke.py phase 2c,
// H100 80GB HBM3 at 700 W; PERF.md). The launch bounds it, not the bytes.
//
// Design. At 0.05-2.4 MB a call there is nothing to stage: TMA, wgmma and
// shared memory buy nothing, and the right body is plain 16-byte vector
// loads and stores with each row's chunks on neighbouring threads. A 2-D
// block maps threadIdx.y to rows and threadIdx.x to the row's 16-byte chunks
// (one float4, or one float where D is not a multiple of 4 or a pointer is
// not 16-byte aligned: D = 1, the wide tables), so no thread divides by the
// width. The ids are distinct, so each element gets one plain read-add-write
// and no atomics: the result is p + r, the same bits as index_add_ over the
// same rows.

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

// host words: [0] set (0 or 1), [1] the id, [2] the table's row count
__device__ void record_bad_id(int* flag, volatile long long* host,
                              long long id, long long vocab) {
  if (atomicCAS(flag, 0, 1) == 0) {
    host[1] = id;
    host[2] = vocab;
    __threadfence_system();
    host[0] = 1;
  }
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
row_update_kernel(T* __restrict__ param, const I* __restrict__ ids,
                  const T* __restrict__ rows, long long n, long long vocab,
                  int width, int* err_flag, long long* err_host) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.y;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.y +
                     threadIdx.y;
       i < n; i += stride) {
    const long long id = static_cast<long long>(__ldg(ids + i));
    if (id < 0 || id >= vocab) {
      if (threadIdx.x == 0) record_bad_id(err_flag, err_host, id, vocab);
      continue;
    }
    T* dst = param + id * width;
    const T* src = rows + i * width;
    for (int c = threadIdx.x; c < width; c += blockDim.x)
      add_to(dst + c, __ldg(src + c));
  }
}

template <typename T, typename I>
void launch_rows(T* param, const I* ids, const T* rows, long long n,
                 long long vocab, int width, int* err_flag,
                 long long* err_host, cudaStream_t st) {
  int lanes = 1;  // threads per row: the row's chunks, up to a warp
  while (lanes < width && lanes < 32) lanes <<= 1;
  const dim3 block(lanes, kThreads / lanes);
  long long blocks = (n + block.y - 1) / block.y;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  row_update_kernel<T, I><<<static_cast<unsigned>(blocks), block, 0, st>>>(
      param, ids, rows, n, vocab, width, err_flag, err_host);
}

template <typename I>
void launch_typed(float* param, const I* ids, const float* rows, long long n,
                  long long vocab, long long d, int* err_flag,
                  long long* err_host, cudaStream_t st) {
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(param) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  if (vec)
    launch_rows(reinterpret_cast<float4*>(param), ids,
                reinterpret_cast<const float4*>(rows), n, vocab,
                static_cast<int>(d / 4), err_flag, err_host, st);
  else
    launch_rows(param, ids, rows, n, vocab, static_cast<int>(d), err_flag,
                err_host, st);
}

}  // namespace

extern "C" {

// Launches the update of the first `n_unique` rows on `stream` on card
// `device` (made current for the call, then restored) and returns
// cudaGetLastError() as an int (0 = launched, or nothing to do). `ids` is
// const int64* when `ids_64bit`, else const int32*; `err_flag` is an int
// on the device, `err_host` the device address of the three mapped host
// words. Device pointers are to contiguous arrays.
int sparse_row_update_f32(int device, float* param, const void* ids,
                          int ids_64bit, const float* rows, long long n,
                          long long vocab, long long d, cudaStream_t stream,
                          int* err_flag, long long* err_host) {
  if (n < 0 || vocab <= 0 || d <= 0 || d >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ids_64bit)
    launch_typed(param, static_cast<const long long*>(ids), rows, n, vocab,
                 d, err_flag, err_host, stream);
  else
    launch_typed(param, static_cast<const int32_t*>(ids), rows, n, vocab, d,
                 err_flag, err_host, stream);
  err = cudaGetLastError();
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

// The device address of pinned host memory at `host` (the error words).
int sparse_row_update_device_pointer(void* host, void** device_ptr) {
  return static_cast<int>(cudaHostGetDevicePointer(device_ptr, host, 0));
}

const char* sparse_row_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
