// Blocked top-k of |x| for Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel `_block_topk_kernel` in
// paddle_tpu/ops/pallas/topk.py (`pl.pallas_call` at :66, body :37), called
// by `blocked_topk_abs`, whose only caller is dgc_momentum's sparse exchange
// (paddle_tpu/ops/optimizers.py:472-478). One kernel, two launches behind
// one C call:
//
// * the stage: for each block of `block` elements of x (the last one
//   padded), the block's top-kk entries of |x| (kk = min(k, block)),
//   written in index order: the Pallas body;
// * the selection: the exact top k of those nb * kk candidates, descending
//   value, ties by lower index: the JAX function's `lax.top_k` over the
//   candidates (ops/pallas/topk.py:80), folded in behind the stage where
//   the k survivors fit one CTA's shared memory. Elsewhere (word_emb's
//   k = 75,776) the wrapper sorts the candidates outside the kernel, as JAX
//   does (kernels/topk.py).
//
// x [n] f32; candidates [nb * kk] f32 values and int32 indices; result
// [k] f32 and int32. A key orders like |x|: the bits of |x| plus one for a
// real element (non-negative floats order like their bit patterns; NaN
// above inf; -0.0 is 0.0), 0 for a pad lane (position >= n, last block
// only), which counts as |x| = -1, below every real |x| >= 0, as in the
// Pallas kernel: chosen only when a block has fewer than kk real elements,
// then with value -1 and its (out-of-range) position, and never chosen by
// the selection (it runs only for n > 2k).
//
// Bound. The call must read n floats and write k (value, index) pairs (the
// stage alone: nb * kk pairs): at a sparse Transformer-base step's small
// calls, [262144] at k = 1049 and [1048576] at k = 4194, 1 MB and 4 MB read,
// 0.3 and 1.3 us at 3.35 TB/s, under the launch floor of about 2 us. No
// arithmetic to speak of: latency bounds it. The one-CTA-per-block design
// before this one used 2 or 8 of the 132 SMs on those calls, each CTA
// making five passes over 512 KB; its selection was a library sort.
//
// Design. A thread-block cluster of C CTAs (C <= 8, the portable size, or
// up to 16 where a call spans few blocks and the card schedules it; the
// wrapper picks C) owns one block; rank r owns the slice [r * slice,
// (r + 1) * slice) of it. Each CTA copies its slice into dynamic shared
// memory once (cp.async, 16 bytes where the addresses allow) and turns it
// into keys in place; a slice too large for shared memory (blocks over
// about 460k elements) is read from device memory on every pass instead.
// Four 8-bit radix passes, most significant digit first, find the kk-th
// largest key T and how many ties at T to take (`need`): in each pass
// every CTA builds a histogram of its slice's keys that match the digits
// found so far (shared atomics), a cluster barrier publishes it, and every
// CTA sums the cluster's histograms through distributed shared memory and
// finds the same digit. The histograms alternate between two buffers, so
// one barrier a pass suffices: a buffer is rewritten only after the next
// pass's barrier, which every CTA reaches after it has read it. Then each
// CTA counts its keys above and at T, and an exclusive prefix over the
// cluster's ranks (distributed shared memory again, then a cluster barrier)
// gives its bases. Each warp walks its run of the slice in index order, a
// warp scan giving each selected element its output position: the elements
// above T before it plus min(ties before it, need). The output lists the
// block's top-kk in index order, the same set as a stable descending
// sort's first kk. x is read from device memory once.
//
// The selection is the same kernel over the candidates as one block (a
// candidate's key is 0 for a pad, value -1): each CTA sends its survivors,
// in index order, as (key, candidate position) pairs into rank 0's shared
// memory; after a last cluster barrier rank 0 sorts the k pairs by a
// stable LSD radix sort on the descending key, 8 bits a pass (a pass
// whose digit every key shares is skipped), so ties stay in index order,
// and writes the values and the candidates' indices. No library sort.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPortableCluster = 8;
constexpr int kMaxCluster = 16;   // non-portable: only where the card schedules it
constexpr unsigned kFull = 0xffffffffu;
// dynamic shared memory a CTA may take (the card allows 227 KB with the
// static part, which is under 4 KB)
constexpr long long kMaxDynamicSmem = 224 * 1024;

__device__ __forceinline__ uint32_t key_of_bits(uint32_t bits) {
  return (bits & 0x7fffffffu) + 1u;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// Adds a thread's four keys with `in` set to `hist`, by their digit at
// `shift`: one shared atomic when all four are in and share a digit (a run
// of zeros or ties), else one for each key in. Warp votes to merge the
// atomics of a warp cost more than the conflicts they save.
__device__ __forceinline__ void add_digits(unsigned* hist, const uint32_t (&key)[4],
                                           const bool (&in)[4], int shift) {
  unsigned d[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) d[j] = (key[j] >> shift) & 0xffu;
  if (in[0] && in[1] && in[2] && in[3] && d[0] == d[1] && d[0] == d[2] &&
      d[0] == d[3]) {
    atomicAdd(&hist[d[0]], 4u);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (in[j]) atomicAdd(&hist[d[j]], 1u);
  }
}

// The sum over the cluster's CTAs of `word` in each one's shared memory,
// the remote reads issued together.
__device__ __forceinline__ unsigned cluster_sum(cg::cluster_group& cluster,
                                                unsigned* word, unsigned ranks) {
  unsigned v[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    v[r] = r < static_cast<int>(ranks) ? *cluster.map_shared_rank(word, r) : 0u;
  unsigned s = 0u;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) s += v[r];
  return s;
}

// Warp 0: replaces a[0..31] and b[0..31] by their exclusive prefix sums.
__device__ __forceinline__ void warp_exclusive_scan2(unsigned* a, unsigned* b) {
  const int lane = threadIdx.x & 31;
  const unsigned x = a[lane], y = b[lane];
  unsigned xi = x, yi = y;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned tx = __shfl_up_sync(kFull, xi, off);
    const unsigned ty = __shfl_up_sync(kFull, yi, off);
    if (lane >= off) {
      xi += tx;
      yi += ty;
    }
  }
  a[lane] = xi - x;
  b[lane] = yi - y;
}

// Warp 0 of a CTA: given the 256-digit histogram `h` of the keys matching
// *prefix and the rank `*need` sought among them (1 = the largest), fixes
// the digit at `shift` that holds it into *prefix and the rank left within
// that digit into *need. Lane l holds digits 255 - 8l down to 248 - 8l, so
// the scan over lanes runs from the largest digit down.
__device__ __forceinline__ void pick_digit(const unsigned* h, uint32_t* prefix,
                                           unsigned* need, int shift) {
  const int lane = threadIdx.x & 31;
  const unsigned want = *need;
  unsigned c[8];
  unsigned sum = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j] = h[255 - (lane * 8 + j)];
    sum += c[j];
  }
  unsigned incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned t = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += t;
  }
  const unsigned excl = incl - sum;
  __syncwarp();
  if (excl < want && want <= incl) {
    unsigned acc = excl;
    for (int j = 0; j < 8; ++j) {
      if (acc + c[j] >= want) {
        const uint32_t digit = 255u - static_cast<uint32_t>(lane * 8 + j);
        *prefix |= digit << shift;
        *need = want - acc;
        break;
      }
      acc += c[j];
    }
  }
}

// Keys come in chunks of four consecutive ones: chunk c holds elements
// 4c - mis .. 4c + 3 - mis of a run (mis aligns the chunks to 16 bytes);
// `load(c, key, valid)` fills them and which of them are in the run, all
// invalid for c < 0.

// The counts of a warp's keys above and at T over its chunks [c_lo, c_hi),
// summed over the warp.
template <typename Load>
__device__ __forceinline__ void count_cut(Load load, int c_lo, int c_hi,
                                          uint32_t T, unsigned* n_gt,
                                          unsigned* n_eq) {
  const int lane = threadIdx.x & 31;
  unsigned g = 0u, e = 0u;
  for (int base = c_lo; base < c_hi; base += 32) {
    uint32_t key[4];
    bool valid[4];
    load(base + lane < c_hi ? base + lane : -1, key, valid);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      g += valid[j] && key[j] > T;
      e += valid[j] && key[j] == T;
    }
  }
  *n_gt = __reduce_add_sync(kFull, g);
  *n_eq = __reduce_add_sync(kFull, e);
}

// Walks a warp's chunks [c_lo, c_hi) in index order and calls
// emit(pos, key, element) for each selected key: every key above T, and the
// first `need` keys at T of the whole run; `gt_run` and `eq_run` are the
// keys above and at T before the warp's first chunk. pos = the keys above T
// before it plus min(the keys at T before it, need): the selected keys in
// index order.
template <typename Load, typename Emit>
__device__ __forceinline__ void emit_cut(Load load, int c_lo, int c_hi,
                                         uint32_t T, unsigned need,
                                         unsigned gt_run, unsigned eq_run,
                                         int mis, Emit emit) {
  const int lane = threadIdx.x & 31;
  for (int base = c_lo; base < c_hi; base += 32) {
    const int c = base + lane < c_hi ? base + lane : -1;
    uint32_t key[4];
    bool valid[4];
    load(c, key, valid);
    unsigned g = 0u, e = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      g += valid[j] && key[j] > T;
      e += valid[j] && key[j] == T;
    }
    // (above T) << 16 | (at T), at most 128 each a round, scanned together
    const unsigned mine = (g << 16) | e;
    unsigned incl = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned t = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += t;
    }
    const unsigned total = __shfl_sync(kFull, incl, 31);
    unsigned gb = gt_run + ((incl - mine) >> 16);
    unsigned eb = eq_run + ((incl - mine) & 0xffffu);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!valid[j]) continue;
      if (key[j] > T) {
        emit(gb + min(eb, need), key[j], 4 * c + j - mis);
        ++gb;
      } else if (key[j] == T) {
        if (eb < need) emit(gb + eb, key[j], 4 * c + j - mis);
        ++eb;
      }
    }
    gt_run += total >> 16;
    eq_run += total & 0xffffu;
  }
}

// The k (key, candidate position) pairs in `from`, in index order, sorted
// by descending key, ties kept in order: a stable LSD radix sort, 8 bits a
// pass, run by the whole CTA; `to` is the second buffer, `counts` holds
// kWarps x 256 digit counts, `total` 256. Returns the buffer that holds the
// result.
__device__ uint2* sort_survivors(uint2* from, uint2* to, unsigned* counts,
                                 unsigned* total, int k) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int seg = ((k + kThreads - 1) / kThreads) * 32;
  const int e_lo = min(k, warp * seg);
  const int e_hi = min(k, e_lo + seg);
  unsigned* mine = counts + warp * 256;
  const unsigned below = lanemask_lt();
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 8 * pass;
    for (int d = lane; d < 256; d += 32) mine[d] = 0u;
    __syncwarp();
    for (int i = e_lo + lane; i < e_hi; i += 32)
      atomicAdd(&mine[(~from[i].x >> shift) & 0xffu], 1u);
    __syncthreads();
    for (int d = tid; d < 256; d += kThreads) {
      unsigned s = 0u;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += counts[w * 256 + d];
      total[d] = s;
    }
    __syncthreads();
    if (warp == 0) {
      // exclusive scan over digits, lane l holding digits 8l .. 8l + 7
      unsigned c[8];
      unsigned sum = 0u;
      bool one_digit = false;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = total[lane * 8 + j];
        sum += c[j];
        one_digit |= c[j] == static_cast<unsigned>(k);
      }
      unsigned incl = sum;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned t = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += t;
      }
      unsigned run = incl - sum;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        total[lane * 8 + j] = run;
        run += c[j];
      }
      // every key with one digit: the pass would keep the order
      if (__any_sync(kFull, one_digit) && lane == 0) total[0] = kFull;
    }
    __syncthreads();
    if (total[0] == kFull) continue;
    for (int d = tid; d < 256; d += kThreads) {
      // each warp's first slot for each digit: digits in order, warps in
      // order within a digit
      unsigned run = total[d];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const unsigned c = counts[w * 256 + d];
        counts[w * 256 + d] = run;
        run += c;
      }
    }
    __syncthreads();
    // four rounds of 32 at a time: their loads and digit matches first,
    // then each round's slots in order (a round's rank within its digit is
    // the warp's count so far plus the lower lanes of the same digit)
    for (int base = e_lo; base < e_hi; base += 32 * 4) {
      uint2 v[4];
      unsigned digit[4], peers[4];
      bool in[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = base + 32 * r + lane;
        in[r] = i < e_hi;
        v[r] = in[r] ? from[i] : make_uint2(0u, 0u);
        digit[r] = (~v[r].x >> shift) & 0xffu;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const unsigned active = __ballot_sync(kFull, in[r]);
        peers[r] = in[r] ? __match_any_sync(active, digit[r]) : 0u;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (in[r]) to[mine[digit[r]] + __popc(peers[r] & below)] = v[r];
        __syncwarp();
        if (in[r] && lane == __ffs(peers[r]) - 1)
          mine[digit[r]] += __popc(peers[r]);
        __syncwarp();
      }
    }
    __syncthreads();
    uint2* t = from;
    from = to;
    to = t;
  }
  return from;
}

__host__ __device__ __forceinline__ long long align16(long long bytes) {
  return (bytes + 15) / 16 * 16;
}

// Dynamic shared memory of a CTA: the slice's keys (slice + 8 words); in
// the selection, then rank 0's two buffers of k pairs and its digit counts.
__host__ __device__ __forceinline__ long long keys_smem(int slice) {
  return align16((static_cast<long long>(slice) + 8) * 4);
}
__host__ __device__ __forceinline__ long long select_smem(int slice, int k) {
  return keys_smem(slice) + 2 * align16(static_cast<long long>(k) * 8) +
         kWarps * 256 * 4;
}

// One cluster of C CTAs per block. kResident: the slice's keys live in
// dynamic shared memory; else they are read from x on every pass.
// kSelect: the selection over the candidates x [n] (n = block, kk = k),
// their indices ci, into vals / idx [k]; else the stage into vals / idx
// [nb * kk].
template <bool kResident, bool kSelect>
__global__ void __launch_bounds__(kThreads)
block_topk_kernel(const float* __restrict__ x, const int32_t* __restrict__ ci,
                  float* __restrict__ vals, int32_t* __restrict__ idx,
                  long long n, int block, int kk, int slice) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned hist[2][256];
  __shared__ unsigned total[256];
  __shared__ unsigned warp_gt[32], warp_eq[32];   // kWarps used
  __shared__ unsigned cta_count[2];   // this CTA's keys above and at T
  __shared__ unsigned s_base[2];
  __shared__ uint32_t s_prefix;
  __shared__ unsigned s_need;

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned C = cluster.num_blocks();
  const unsigned rank = cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long b = blockIdx.x / C;
  const long long block_start = b * block;
  const int lo = static_cast<int>(rank) * slice;
  const int len = max(0, min(slice, block - lo));      // elements of the slice
  const long long gstart = block_start + lo;
  const float* src = x + gstart;
  // real elements (position < n); the rest of the slice are pad lanes
  const int avail = static_cast<int>(
      max(0ll, min(static_cast<long long>(len), n - gstart)));
  // shared-memory words congruent to the source addresses mod 16 bytes, so
  // the copy moves 16 bytes at a time whatever the slice's alignment
  const int mis =
      kResident ? static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3) : 0;
  const int n_chunks = (mis + len + 3) >> 2;
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem);
  // a candidate's value is |x| (sign clear) or -1 for a pad lane
  auto key_of = [](uint32_t bits) {
    return kSelect ? ((bits >> 31) ? 0u : bits + 1u) : key_of_bits(bits);
  };

  if (kResident) {
    float* dst = reinterpret_cast<float*>(keys) + mis;
    const int head = min(avail, (4 - mis) & 3);
    const int body = (avail - head) >> 2;
    for (int i = tid; i < head; i += kThreads) cp_async4(dst + i, src + i);
    for (int j = tid; j < body; j += kThreads)
      cp_async16(dst + head + 4 * j, src + head + 4 * j);
    for (int i = head + 4 * body + tid; i < avail; i += kThreads)
      cp_async4(dst + i, src + i);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    for (int c = tid; c < n_chunks; c += kThreads) {
      uint4 w = reinterpret_cast<uint4*>(keys)[c];
      uint32_t* v = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 4 * c + j - mis;
        if (i >= avail) v[j] = 0u;   // pad lanes (and words past the slice)
        else if (i >= 0) v[j] = key_of(v[j]);
      }
      reinterpret_cast<uint4*>(keys)[c] = w;
    }
  }
  auto load = [&](int c, uint32_t(&key)[4], bool(&valid)[4]) {
    if (kResident && c >= 0) {
      const uint4 w = reinterpret_cast<const uint4*>(keys)[c];
      key[0] = w.x;
      key[1] = w.y;
      key[2] = w.z;
      key[3] = w.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 4 * c + j - mis;
      valid[j] = c >= 0 && i >= 0 && i < len;
      if (!kResident)
        key[j] = valid[j] && i < avail ? key_of(__float_as_uint(__ldg(src + i))) : 0u;
      if (c < 0) key[j] = 0u;
    }
  };

  if (tid == 0) {
    s_prefix = 0u;
    s_need = static_cast<unsigned>(kk);
  }
  // -- select: the kk-th largest key of the block, one digit per pass ------
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    const uint32_t hi_mask = pass == 0 ? 0u : (kFull << (shift + 8));
    unsigned* h = hist[pass & 1];
    for (int d = tid; d < 256; d += kThreads) h[d] = 0u;
    __syncthreads();   // h zeroed, keys and s_prefix written
    const uint32_t prefix = s_prefix;
#pragma unroll 2
    for (int c0 = 0; c0 < n_chunks; c0 += kThreads) {
      uint32_t key[4];
      bool in[4];
      load(c0 + tid < n_chunks ? c0 + tid : -1, key, in);
#pragma unroll
      for (int j = 0; j < 4; ++j) in[j] = in[j] && (key[j] & hi_mask) == prefix;
      add_digits(h, key, in, shift);
    }
    cluster.sync();    // every CTA's histogram of this pass is complete
    for (int d = tid; d < 256; d += kThreads)
      total[d] = cluster_sum(cluster, h + d, C);
    __syncthreads();
    if (warp == 0) pick_digit(total, &s_prefix, &s_need, shift);
  }
  __syncthreads();
  const uint32_t T = s_prefix;
  const unsigned need = s_need;

  // -- ordered compaction -------------------------------------------------
  // warp w walks chunks [c_lo, c_hi) of the slice, 32 chunks a round
  const int per_warp = ((n_chunks + kThreads - 1) / kThreads) * 32;
  const int c_lo = min(n_chunks, warp * per_warp);
  const int c_hi = min(n_chunks, c_lo + per_warp);
  unsigned n_gt, n_eq;
  count_cut(load, c_lo, c_hi, T, &n_gt, &n_eq);
  if (lane == 0) {
    warp_gt[warp] = n_gt;
    warp_eq[warp] = n_eq;
  } else if (warp == 0 && lane >= kWarps) {
    warp_gt[lane] = 0u;
    warp_eq[lane] = 0u;
  }
  __syncthreads();
  if (warp == 0) {
    // exclusive prefix over the CTA's warps; the CTA's totals
    const unsigned g = warp_gt[kWarps - 1], e = warp_eq[kWarps - 1];
    __syncwarp();
    warp_exclusive_scan2(warp_gt, warp_eq);
    if (lane == 0) {
      cta_count[0] = warp_gt[kWarps - 1] + g;
      cta_count[1] = warp_eq[kWarps - 1] + e;
    }
  }
  cluster.sync();      // every CTA's counts are published
  if (tid < 2) s_base[tid] = cluster_sum(cluster, cta_count + tid, rank);
  // no CTA reads another's counts after this barrier
  cluster.sync();
  const unsigned gt_base = s_base[0] + warp_gt[warp];
  const unsigned eq_base = s_base[1] + warp_eq[warp];
  if (!kSelect) {
    float* out_v = vals + b * kk;
    int32_t* out_i = idx + b * kk;
    emit_cut(load, c_lo, c_hi, T, need, gt_base, eq_base, mis,
             [&](unsigned pos, uint32_t key, int i) {
               out_v[pos] = key ? __uint_as_float(key - 1u) : -1.0f;
               out_i[pos] = static_cast<int32_t>(gstart + i);
             });
    return;
  }
  // the survivors go to rank 0, which sorts them once all have arrived;
  // the others leave after the last barrier
  uint2* survivors = reinterpret_cast<uint2*>(smem + keys_smem(slice));
  uint2* sink = cluster.map_shared_rank(survivors, 0u);
  emit_cut(load, c_lo, c_hi, T, need, gt_base, eq_base, mis,
           [&](unsigned pos, uint32_t key, int i) {
             sink[pos] = make_uint2(key, static_cast<uint32_t>(lo + i));
           });
  cluster.sync();
  if (rank != 0) return;
  uint2* second = survivors + align16(static_cast<long long>(kk) * 8) / 8;
  unsigned* counts = reinterpret_cast<unsigned*>(second + align16(
      static_cast<long long>(kk) * 8) / 8);
  const uint2* sorted = sort_survivors(survivors, second, counts, total, kk);
  for (int i = tid; i < kk; i += kThreads) {
    const uint2 v = sorted[i];
    vals[i] = __uint_as_float(v.x - 1u);
    idx[i] = __ldg(ci + v.y);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, long long smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// A launch of the kernel over nb blocks of `block` with clusters of
// `cluster` CTAs; k_select > 0 for the selection of k_select survivors.
struct Launch {
  int slice;
  bool resident;
  long long smem;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];

  Launch(int block, int cluster, long long nb, int k_select, cudaStream_t st) {
    slice = (block + cluster - 1) / cluster;
    smem = k_select > 0 ? select_smem(slice, k_select) : keys_smem(slice);
    resident = smem <= kMaxDynamicSmem;
    if (!resident) smem = 0;
    cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(nb * cluster), 1, 1);
    cfg.blockDim = dim3(kThreads, 1, 1);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <bool kResident, bool kSelect>
cudaError_t launch_as(Launch& l, const float* x, const int32_t* ci, float* vals,
                      int32_t* idx, long long n, int block, int kk) {
  cudaError_t err = allow_smem(block_topk_kernel<kResident, kSelect>, l.smem);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&l.cfg, block_topk_kernel<kResident, kSelect>, x,
                            ci, vals, idx, n, block, kk, l.slice);
}

// Whether the card schedules the launch's clusters: above the portable 8
// the kernel must allow it, and the occupancy query must find room for one.
template <bool kResident, bool kSelect>
cudaError_t schedules(Launch& l, int* ok) {
  auto kernel = block_topk_kernel<kResident, kSelect>;
  cudaError_t err = allow_smem(kernel, l.smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  int active = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&active, kernel, &l.cfg);
  *ok = active > 0;
  return err;
}

// Makes card `device` current for the life of the object.
struct OnDevice {
  int prev = 0;
  int device;
  cudaError_t err;
  explicit OnDevice(int d) : device(d) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  }
  cudaError_t restore(cudaError_t result) {
    if (prev != device) {
      const cudaError_t back = cudaSetDevice(prev);
      if (result == cudaSuccess) result = back;
    }
    return result;
  }
};

}  // namespace

extern "C" {

// Dynamic shared memory the selection takes for m candidates, k survivors
// and clusters of `cluster`, or -1 where it does not fit a CTA (the caller
// then sorts the candidates itself).
long long blocked_topk_select_smem(long long m, int k, int cluster) {
  if (m <= 0 || k <= 0 || k > m || m >= (1ll << 31) || cluster < 1 ||
      cluster > kMaxCluster || cluster > m)
    return -1;
  const long long smem =
      select_smem(static_cast<int>((m + cluster - 1) / cluster), k);
  return smem <= kMaxDynamicSmem ? smem : -1;
}

// The cluster size for blocks of `block` on card `device` (made current
// for the call), of the stage or, for k_select > 0, of the selection:
// `want` where it is at most the portable 8 or the card schedules it, else
// 8. Returns -1 - the cudaError_t on a failure.
int blocked_topk_cluster_size(int device, int block, int k_select, int want) {
  if (block <= 0 || want < 1 || want > kMaxCluster || want > block) return -1;
  if (want <= kPortableCluster) return want;
  OnDevice on(device);
  cudaError_t err = on.err;
  int ok = 0;
  if (err == cudaSuccess) {
    Launch l(block, want, 1, k_select, nullptr);
    // a selection too large for shared memory is never launched
    if (k_select > 0 && l.resident) err = schedules<true, true>(l, &ok);
    else if (k_select == 0)
      err = l.resident ? schedules<true, false>(l, &ok)
                       : schedules<false, false>(l, &ok);
  }
  err = on.restore(err);
  if (err != cudaSuccess) return -1 - static_cast<int>(err);
  return ok ? want : kPortableCluster;
}

// On card `device` (made current for the call, then restored), launches on
// `stream` the stage over x [n] into the candidates cand_v / cand_i
// [ceil(n / block) * kk], with clusters of `cluster` CTAs, and, when out_v
// is not null, the selection of the top k of the candidates into out_v /
// out_i [k] behind it, with clusters of `select_cluster`. Returns a
// cudaError_t as an int (0 = launched). Device pointers are to contiguous
// arrays.
int blocked_topk_abs_f32(int device, const float* x, float* cand_v,
                         int32_t* cand_i, float* out_v, int32_t* out_i,
                         long long n, int block, int kk, int k, int cluster,
                         int select_cluster, cudaStream_t stream) {
  if (n <= 0 || block <= 0 || kk <= 0 || kk > block || cluster < 1 ||
      cluster > kMaxCluster || cluster > block)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nb = (n + block - 1) / block;
  // positions and output slots are int32 / unsigned inside the kernel
  if (nb * static_cast<long long>(block) >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long m = nb * kk;
  if (out_v != nullptr && blocked_topk_select_smem(m, k, select_cluster) < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  OnDevice on(device);
  cudaError_t err = on.err;
  if (err == cudaSuccess) {
    Launch l(block, cluster, nb, 0, stream);
    err = l.resident ? launch_as<true, false>(l, x, nullptr, cand_v, cand_i, n,
                                              block, kk)
                     : launch_as<false, false>(l, x, nullptr, cand_v, cand_i, n,
                                               block, kk);
  }
  if (err == cudaSuccess && out_v != nullptr) {
    Launch l(static_cast<int>(m), select_cluster, 1, k, stream);
    err = launch_as<true, true>(l, cand_v, cand_i, out_v, out_i, m,
                                static_cast<int>(m), k);
  }
  return static_cast<int>(on.restore(err));
}

const char* blocked_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
