// Hopper (sm_90a) kernels for GYM's three shard-local hot loops.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// into a plain-C shared library loaded with ctypes.  Every launcher takes
// device pointers and the caller's CUDA stream, allocates nothing, never
// synchronises, and returns the cudaError_t of its launches (0 = success).
//
// All three work on B equal-length segments laid out back to back (the
// flattened (p, k) shard x instance axes of a fused op group), so one
// launch serves a whole group.  All three are memory-bound: integer
// arithmetic only, a handful of operations per byte moved.
//
// Replaces (TPU Pallas kernels of the reference package):
//   gym_hash_partition    <- repro/kernels/hash_partition.py::_partition_kernel
//   gym_semijoin_probe    <- repro/kernels/semijoin_probe.py::_probe_kernel
//   gym_sorted_probe      <- repro/kernels/sorted_probe.py::_range_kernel
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kC1 = 0x85EBCA6Bu;
constexpr uint32_t kC2 = 0xC2B2AE35u;
constexpr uint32_t kGold = 0x9E3779B9u;
constexpr int32_t kI32Max = 0x7FFFFFFF;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= kC1;
  x ^= x >> 13;
  x *= kC2;
  x ^= x >> 16;
  return x;
}

inline unsigned int blocks_for(long long total) {
  long long b = (total + kThreads - 1) / kThreads;
  // grid-stride loops cover the rest; 132 SMs x 16 blocks keeps the card full
  const long long cap = 132LL * 16LL;
  return (unsigned int)(b < cap ? b : cap);
}

// ---------------------------------------------------------------- hashing
// One thread per row: the seeded murmur3 fmix32 chain over the row's nk
// key columns (read in column order from a contiguous (B, n, nk) matrix),
// then % p (a mask when p is a power of two).  Invalid rows get p.
__global__ void hash_partition_kernel(const int32_t* __restrict__ keys,
                                      const uint8_t* __restrict__ valid,
                                      const uint32_t* __restrict__ seeds,
                                      int32_t* __restrict__ dest, long long n,
                                      int nk, int p, long long total) {
  const bool pow2 = (p & (p - 1)) == 0;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    uint32_t h = mix32(seeds[i / n]);
    const int32_t* row = keys + i * nk;
    for (int c = 0; c < nk; ++c) {
      h = mix32(h ^ (mix32((uint32_t)row[c]) + kGold));
    }
    const uint32_t d = pow2 ? (h & (uint32_t)(p - 1)) : (h % (uint32_t)p);
    dest[i] = valid[i] ? (int32_t)d : p;
  }
}

// ------------------------------------------------------------- membership
// One open-addressing hash set per segment, `slots` (a power of two, at
// least twice the segment's key count) int32 cells each.  A cell holds
// key ^ INT32_MAX, so the all-zero memset is the empty set and the
// INT32_MAX padding key (which would store 0) is never inserted.
__global__ void set_build_kernel(const int32_t* __restrict__ keys, long long m,
                                 int32_t* __restrict__ table, long long slots,
                                 long long total) {
  const uint32_t mask = (uint32_t)(slots - 1);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int32_t k = keys[i];
    if (k == kI32Max) continue;
    const int32_t tag = k ^ kI32Max;
    int32_t* seg = table + (i / m) * slots;
    uint32_t h = mix32((uint32_t)k) & mask;
    while (true) {
      const int32_t prev = atomicCAS(seg + h, 0, tag);
      if (prev == 0 || prev == tag) break;
      h = (h + 1) & mask;
    }
  }
}

__global__ void set_probe_kernel(const int32_t* __restrict__ q, long long n,
                                 const int32_t* __restrict__ table,
                                 long long slots, uint8_t* __restrict__ out,
                                 long long total) {
  const uint32_t mask = (uint32_t)(slots - 1);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int32_t x = q[i];
    uint8_t hit = 0;
    if (x != kI32Max) {
      const int32_t tag = x ^ kI32Max;
      const int32_t* seg = table + (i / n) * slots;
      uint32_t h = mix32((uint32_t)x) & mask;
      while (true) {
        const int32_t v = seg[h];
        if (v == tag) { hit = 1; break; }
        if (v == 0) break;
        h = (h + 1) & mask;
      }
    }
    out[i] = hit;
  }
}

// ------------------------------------------------------------ match ranges
// One thread per probe: lower- and upper-bound binary searches in the
// probe's segment of the sorted keys.  lo = #{keys < q}, hi = #{keys <= q}.
__global__ void sorted_probe_kernel(const int32_t* __restrict__ q, long long n,
                                    const int32_t* __restrict__ keys, long long m,
                                    int32_t* __restrict__ lo_out,
                                    int32_t* __restrict__ hi_out,
                                    long long total) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int32_t x = q[i];
    const int32_t* ks = keys + (i / n) * m;
    long long a = 0, b = m;
    while (a < b) {
      const long long mid = (a + b) >> 1;
      if (ks[mid] < x) a = mid + 1; else b = mid;
    }
    long long c = a, d = m;
    while (c < d) {
      const long long mid = (c + d) >> 1;
      if (ks[mid] <= x) c = mid + 1; else d = mid;
    }
    lo_out[i] = (int32_t)a;
    hi_out[i] = (int32_t)c;
  }
}

}  // namespace

extern "C" {

int gym_hash_partition(const void* keys, const void* valid, const void* seeds,
                       void* dest, long long segments, long long n, int nk,
                       int p, void* stream) {
  const long long total = segments * n;
  if (total == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  hash_partition_kernel<<<blocks_for(total), kThreads, 0, s>>>(
      (const int32_t*)keys, (const uint8_t*)valid, (const uint32_t*)seeds,
      (int32_t*)dest, n, nk, p, total);
  return (int)cudaGetLastError();
}

int gym_semijoin_probe(const void* q, const void* keys, void* table, void* out,
                       long long segments, long long n, long long m,
                       long long slots, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (segments * n == 0) return 0;
  cudaError_t err = cudaMemsetAsync(
      table, 0, (size_t)(segments * slots) * sizeof(int32_t), s);
  if (err != cudaSuccess) return (int)err;
  if (segments * m > 0) {
    set_build_kernel<<<blocks_for(segments * m), kThreads, 0, s>>>(
        (const int32_t*)keys, m, (int32_t*)table, slots, segments * m);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  set_probe_kernel<<<blocks_for(segments * n), kThreads, 0, s>>>(
      (const int32_t*)q, n, (const int32_t*)table, slots, (uint8_t*)out,
      segments * n);
  return (int)cudaGetLastError();
}

int gym_sorted_probe(const void* q, const void* keys, void* lo, void* hi,
                     long long segments, long long n, long long m,
                     void* stream) {
  const long long total = segments * n;
  if (total == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  sorted_probe_kernel<<<blocks_for(total), kThreads, 0, s>>>(
      (const int32_t*)q, n, (const int32_t*)keys, m, (int32_t*)lo,
      (int32_t*)hi, total);
  return (int)cudaGetLastError();
}

}  // extern "C"
