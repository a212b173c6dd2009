// Embedding admission for Hopper (sm_90a), float32: slab[slots[i]] = rows[i].
//
// Replaces the Pallas TPU kernel `_scatter_pallas` in
// paddle_tpu/kernels/embedding.py (`pl.pallas_call` at :105, body :93-103,
// called by `admit_rows` :148). The embedding engine admits a batch's cache
// misses by copying their host rows into free or evicted slots of the
// device slab [C, D]. The admission count is padded to a power-of-two
// bucket M; a padded entry carries slot == C, which writes nowhere (the
// paged arena's drop convention). Real slots are distinct, so the rows are
// written in any order and the result is the same bytes as
// `slab.at[slots].set(rows, mode="drop")`.
//
// slab [C, D] f32 (updated in place), slots [M] int32 in [0, C], rows [M, D]
// f32. The wrapper (kernels/embedding.py) rejects a slot outside [0, C]
// before the launch; the kernel skips any slot outside [0, C) as well, so it
// can never write outside the slab.
//
// Bound. A call moves M rows of D floats once in and once out plus the
// slots: 16-64 KB at the Wide&Deep shapes (M = 256-1024, D = 1 or 16), well
// under a microsecond of memory traffic at 3.35 TB/s. The launch itself
// (a few microseconds) bounds it.
//
// Design. The TPU kernel loops over the M rows in one program. Here every
// thread copies one element: one float4 (16 bytes, neighbouring threads on
// neighbouring addresses) when D is a multiple of 4 and both pointers are
// 16-byte aligned, else one float (D = 1, the wide tables). A grid-stride
// loop keeps the grid small for large M. No shared memory, no atomics: the
// slots are distinct, so nothing orders the writes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 4096;

template <typename T>
__global__ void __launch_bounds__(kThreads)
admit_rows_kernel(T* __restrict__ slab, const int32_t* __restrict__ slots,
                  const T* __restrict__ rows, long long m, long long cap,
                  long long width) {
  const long long total = m * width;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < total; t += stride) {
    const long long i = t / width;
    const long long s = __ldg(slots + i);
    if (s >= 0 && s < cap) slab[s * width + (t - i * width)] = __ldg(rows + t);
  }
}

}  // namespace

extern "C" {

// Launches the copy on `stream` (a cudaStream_t) and returns
// cudaGetLastError() as an int (0 = launched, or nothing to do). Pointers
// are device pointers to contiguous arrays.
int embedding_admission_f32(float* slab, const int32_t* slots,
                            const float* rows, long long m, long long cap,
                            long long d, void* stream) {
  if (m < 0 || cap <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(slab) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(rows) % 16 == 0;
  const long long width = vec ? d / 4 : d;
  long long blocks = (m * width + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (vec) {
    admit_rows_kernel<float4><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        reinterpret_cast<float4*>(slab), slots,
        reinterpret_cast<const float4*>(rows), m, cap, width);
  } else {
    admit_rows_kernel<float><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        slab, slots, rows, m, cap, width);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* embedding_admission_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
