// The launch floor: an empty kernel, launched through the same route as
// K5 and K6 (one ctypes call into a plain C entry point that makes the
// card current, launches on the caller's stream and returns
// cudaGetLastError()). It computes nothing and is no port of a TPU kernel.
// chip_smoke.py times it beside K5 and K6: its device time is the least a
// launch costs the card, its host time the least a call costs Python, so
// no kernel launched this way can beat those, whatever its byte bound.
//
// Both entry points take K6's eleven arguments (sparse_update.cu): one one
// by one with their types declared to ctypes, as every kernel's entry point
// takes them; the other as one block of int64 words behind one pointer, so
// that ctypes converts a single argument. Their host times are the A/B of
// the two bindings, which chip_smoke.py reports on every run.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

int launch_empty(int device, cudaStream_t stream) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  empty_kernel<<<1, 32, 0, stream>>>();
  err = cudaGetLastError();
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// K6's eleven arguments as int64 words; [0] the device, [8] the stream.
int launch_floor_block(const long long* args) {
  return launch_empty(static_cast<int>(args[0]),
                      reinterpret_cast<cudaStream_t>(args[8]));
}

// K6's eleven arguments with their own types; only device and stream are
// used.
int launch_floor(int device, void*, void*, int, void*, long long,
                       long long, long long, void* stream, void*, void*) {
  return launch_empty(device, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
