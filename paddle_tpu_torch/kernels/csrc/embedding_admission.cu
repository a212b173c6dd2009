// Embedding admission for Hopper (sm_90a), float32: slab[slots[i]] = rows[i].
//
// Replaces the Pallas TPU kernel `_scatter_pallas` in
// paddle_tpu/kernels/embedding.py (`pl.pallas_call` at :105, body :93-103,
// called by `admit_rows` :148). The embedding engine admits a batch's cache
// misses by copying their host rows into free or evicted slots of the
// device slab [C, D]. The JAX package pads the admission count to a
// power-of-two bucket so that its compiled shapes stay few; a padded entry
// carries slot == C, which writes nowhere (the paged arena's drop
// convention). Nothing here compiles per shape, so the engine's path uploads
// and launches over the n real rows only; slot == C still writes nowhere, so
// a caller that passes a padded bucket gets the same bytes. Real slots are
// distinct, so the rows are written in any order and the result is the same
// bytes as `slab.at[slots].set(rows, mode="drop")`.
//
// slab [C, D] f32 (updated in place), slots [M] int32 in [0, C], rows [M, D]
// f32. The wrapper (kernels/embedding.py) rejects a slot outside [0, C] on
// the host before the upload; the kernel skips any slot outside [0, C) as
// well, so it can never write outside the slab.
//
// The upload. The slots and rows are host data. The wrapper packs them into
// one pinned staging buffer (slots, then rows at a 16-byte boundary); this
// entry point copies it to the device staging buffer with one
// cudaMemcpyAsync on the same stream, launches, and records the caller's
// event after the launch (the wrapper refills either buffer only once that
// event is done, whatever stream the next call is on): one call from
// Python, no sync.
//
// Bound. A call moves n rows of D floats once in and once out plus the
// slots: 3-94 KB at the Wide&Deep shapes (n = 200-1024, D = 1 or 16), a
// few hundredths of a microsecond at 3.35 TB/s. An empty kernel launched
// through the same route (the launch floor) takes 2.0 us of device time and
// 4-7.5 us of host time a call, and this kernel 2.5 us of device time at
// 700 rows of D = 16 (chip_smoke.py phase 2c, H100 80GB HBM3 at 700 W;
// PERF.md): the launch, not the bytes, bounds the call.
//
// Design. At these sizes TMA, wgmma and shared-memory staging buy nothing:
// the body is plain 16-byte vector copies with each row's chunks on
// neighbouring threads. A 2-D block maps threadIdx.y to rows and threadIdx.x
// to the row's 16-byte chunks (one float4, or one float where D is not a
// multiple of 4 or a pointer is not 16-byte aligned: D = 1, the wide
// tables), so no thread divides by the width. No atomics: the slots are
// distinct, so nothing orders the writes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;

template <typename T>
__global__ void __launch_bounds__(kThreads)
admit_rows_kernel(T* __restrict__ slab, const int32_t* __restrict__ slots,
                  const T* __restrict__ rows, long long m, long long cap,
                  int width) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.y;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.y +
                     threadIdx.y;
       i < m; i += stride) {
    const long long s = __ldg(slots + i);
    if (s < 0 || s >= cap) continue;  // slot == C: a pad entry
    T* dst = slab + s * width;
    const T* src = rows + i * width;
    for (int c = threadIdx.x; c < width; c += blockDim.x) dst[c] = __ldg(src + c);
  }
}

template <typename T>
void launch_rows(T* slab, const int32_t* slots, const T* rows, long long m,
                 long long cap, int width, cudaStream_t st) {
  int lanes = 1;  // threads per row: the row's chunks, up to a warp
  while (lanes < width && lanes < 32) lanes <<= 1;
  const dim3 block(lanes, kThreads / lanes);
  long long blocks = (m + block.y - 1) / block.y;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  admit_rows_kernel<T><<<static_cast<unsigned>(blocks), block, 0, st>>>(
      slab, slots, rows, m, cap, width);
}

}  // namespace

extern "C" {

// On card `device` (made current for the call, then restored) and
// `stream`: when `host_src` is not null, first copies `nbytes` from that
// pinned host buffer to `slots` (the device staging buffer, which holds
// the rows too); then launches the copy of the m rows, and with
// `host_src` records `done` after it. Returns cudaGetLastError() (or the
// first failing call's error) as an int: 0 = launched, or nothing to do.
// Device pointers are to contiguous arrays.
int embedding_admission_f32(int device, float* slab, int32_t* slots,
                            const float* rows, long long m, long long cap,
                            long long d, cudaStream_t stream,
                            const void* host_src, long long nbytes,
                            cudaEvent_t done) {
  if (m < 0 || cap <= 0 || d <= 0 || d >= (1LL << 31) || nbytes < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (host_src != nullptr)
    err = cudaMemcpyAsync(slots, host_src, static_cast<size_t>(nbytes),
                          cudaMemcpyHostToDevice, stream);
  if (err == cudaSuccess) {
    const bool vec = d % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(slab) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(rows) % 16 == 0;
    if (vec)
      launch_rows(reinterpret_cast<float4*>(slab), slots,
                  reinterpret_cast<const float4*>(rows), m, cap,
                  static_cast<int>(d / 4), stream);
    else
      launch_rows(slab, slots, rows, m, cap, static_cast<int>(d), stream);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess && host_src != nullptr)
    err = cudaEventRecord(done, stream);
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

const char* embedding_admission_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
