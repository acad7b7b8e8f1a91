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
// launch serves a whole group.  All three are bound by memory bytes on
// this card: integer arithmetic only, a handful of operations per byte
// moved.  The sorted probe reads each probe once, writes two int32s and
// needs only the valid keys; its design (below) keeps the dependent reads
// of its searches off the path of probes that need none and off the top
// of the search tree.
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
// lo = #{keys < q}, hi = #{keys <= q} for probes q < INT32_MAX in each
// segment's sorted keys (INT32_MAX padding at the back).  Two launches:
//
// sorted_probe_prep_kernel, one block per segment: m_eff, the lower bound
// of INT32_MAX (padding never counts for a probe below it, so every search
// runs over [0, m_eff)), and a splitter sample spl[i] = ks[i * st] of
// ns = ceil(m_eff / st) <= NS keys, st = ceil(m_eff / NS), written to a
// (B, NS) scratch tensor, so each probe block loads its segment's top of
// the search tree as NS contiguous ints instead of NS scattered reads.
//
// sorted_probe_kernel, grid (tile groups, segments): a block stages its
// segment's splitters in shared memory, then each thread takes
// kProbesPerThread probes per tile, kProbeThreads apart (a warp's loads
// and stores cover whole lines), and
//   - answers (0, 0) for q < ks[0] (the -1 invalid probes) or an empty
//     segment, and (m_eff, m_eff) for q > ks[m_eff - 1], with no search;
//   - finds lo by a lower-bound search over the splitters in shared memory
//     (log2 ns steps), then over the window of at most st - 1 keys the
//     splitters leave (log2 st steps in global memory), the searches of a
//     thread's probes interleaved so that their dependent loads overlap;
//   - finds hi by galloping right from lo (1, 2, 4, ... keys ahead, then a
//     binary search), usually one read: multiplicities are small on the
//     join paths, and the gallop stays right for a run of any length.
constexpr int kProbeThreads = 256;
constexpr int kProbesPerThread = 4;
constexpr int kProbeTile = kProbeThreads * kProbesPerThread;
constexpr int kSplitters = 1024;  // NS at most: 4 KB of shared memory

__device__ __forceinline__ int ceil_div_i(int a, int b) { return (a + b - 1) / b; }

__global__ void sorted_probe_prep_kernel(const int32_t* __restrict__ keys,
                                         int m, long long segments, int ns_cap,
                                         int32_t* __restrict__ meff_out,
                                         int32_t* __restrict__ spl_out) {
  __shared__ int s_meff;
  for (long long seg = blockIdx.x; seg < segments; seg += gridDim.x) {
    const int32_t* ks = keys + seg * (long long)m;
    if (threadIdx.x == 0) {
      int a = 0, b = m;  // lower bound of INT32_MAX
      while (a < b) {
        const int mid = (a + b) >> 1;
        if (ks[mid] < kI32Max) a = mid + 1; else b = mid;
      }
      s_meff = a;
      meff_out[seg] = a;
    }
    __syncthreads();
    const int meff = s_meff;
    if (meff > 0) {
      const int st = ceil_div_i(meff, ns_cap);
      const int ns = ceil_div_i(meff, st);
      int32_t* spl = spl_out + seg * (long long)ns_cap;
      for (int i = threadIdx.x; i < ns; i += blockDim.x) spl[i] = ks[(long long)i * st];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kProbeThreads)
    sorted_probe_kernel(const int32_t* __restrict__ q, long long n,
                        const int32_t* __restrict__ keys, int m,
                        const int32_t* __restrict__ meff_in,
                        const int32_t* __restrict__ spl_in, int ns_cap,
                        long long segments, int tiles_per_block,
                        int32_t* __restrict__ lo_out,
                        int32_t* __restrict__ hi_out) {
  __shared__ int32_t s_spl[kSplitters];
  __shared__ int32_t s_last;
  for (long long seg = blockIdx.y; seg < segments; seg += gridDim.y) {
    const int32_t* ks = keys + seg * (long long)m;
    const int32_t* qs = q + seg * n;
    int32_t* los = lo_out + seg * n;
    int32_t* his = hi_out + seg * n;
    const int meff = meff_in[seg];
    const int st = meff > 0 ? ceil_div_i(meff, ns_cap) : 1;
    const int ns = meff > 0 ? ceil_div_i(meff, st) : 0;
    __syncthreads();  // the previous segment's splitters are all read
    for (int i = threadIdx.x; i < ns; i += kProbeThreads)
      s_spl[i] = spl_in[seg * (long long)ns_cap + i];
    if (threadIdx.x == 0) s_last = meff > 0 ? ks[meff - 1] : 0;
    __syncthreads();
    const int32_t first = ns > 0 ? s_spl[0] : 0;
    const int32_t last = s_last;

    const long long tile0 = (long long)blockIdx.x * tiles_per_block;
    for (long long tile = tile0; tile < tile0 + tiles_per_block; ++tile) {
      const long long base = tile * kProbeTile;
      if (base >= n) break;
      // probe k of a thread sits kProbeThreads after probe k - 1, so every
      // load and store of a warp covers whole 128-byte lines
      long long idx[kProbesPerThread];
      bool in[kProbesPerThread];
      int32_t x[kProbesPerThread];
#pragma unroll
      for (int k = 0; k < kProbesPerThread; ++k) {
        idx[k] = base + threadIdx.x + (long long)k * kProbeThreads;
        in[k] = idx[k] < n;
        x[k] = in[k] ? qs[idx[k]] : -1;
      }
      // early outs: below every key (or an empty segment) and above every key
      int a[kProbesPerThread], len[kProbesPerThread];
#pragma unroll
      for (int k = 0; k < kProbesPerThread; ++k) {
        const bool below = meff == 0 || x[k] < first;
        const bool above = !below && x[k] > last;
        a[k] = below ? 0 : (above ? meff : 0);
        len[k] = (below || above) ? 0 : ns;
      }
      // lower bound among the splitters, in shared memory
      bool busy = true;
      while (busy) {
        busy = false;
#pragma unroll
        for (int k = 0; k < kProbesPerThread; ++k) {
          if (len[k] > 0) {
            const int half = len[k] >> 1;
            if (s_spl[a[k] + half] < x[k]) {
              a[k] += half + 1;
              len[k] -= half + 1;
            } else {
              len[k] = half;
            }
            busy |= len[k] > 0;
          }
        }
      }
      // splitter j = a: ks[(j-1)*st] < q <= ks[j*st], so lo lies in
      // [(j-1)*st + 1, min(j*st, m_eff)]; search that window in global memory
#pragma unroll
      for (int k = 0; k < kProbesPerThread; ++k) {
        const bool searched = !(meff == 0 || x[k] < first || x[k] > last);
        if (searched) {
          const int j = a[k];
          const int w0 = j == 0 ? 0 : (j - 1) * st + 1;
          const int w1 = (int)min((long long)j * st, (long long)meff);
          a[k] = w0;
          len[k] = w1 - w0;
        }
      }
      busy = true;
      while (busy) {
        busy = false;
        int32_t v[kProbesPerThread];
#pragma unroll
        for (int k = 0; k < kProbesPerThread; ++k)
          v[k] = len[k] > 0 ? ks[a[k] + (len[k] >> 1)] : 0;
#pragma unroll
        for (int k = 0; k < kProbesPerThread; ++k) {
          if (len[k] > 0) {
            const int half = len[k] >> 1;
            if (v[k] < x[k]) {
              a[k] += half + 1;
              len[k] -= half + 1;
            } else {
              len[k] = half;
            }
            busy |= len[k] > 0;
          }
        }
      }
      // hi: gallop right from lo over the run of keys equal to q
      int hi[kProbesPerThread];
      int32_t at_lo[kProbesPerThread];
#pragma unroll
      for (int k = 0; k < kProbesPerThread; ++k)
        at_lo[k] = a[k] < meff ? ks[a[k]] : kI32Max;
#pragma unroll
      for (int k = 0; k < kProbesPerThread; ++k) {
        hi[k] = a[k];
        if (at_lo[k] == x[k]) {
          int good = a[k], bad = meff;  // ks[good] <= q < ks[bad]
          long long step = 1;
          while (step < meff - good) {
            if (ks[good + step] <= x[k]) {
              good += (int)step;
              step <<= 1;
            } else {
              bad = good + (int)step;
              break;
            }
          }
          int lo2 = good + 1, hi2 = bad;
          while (lo2 < hi2) {
            const int mid = (lo2 + hi2) >> 1;
            if (ks[mid] <= x[k]) lo2 = mid + 1; else hi2 = mid;
          }
          hi[k] = lo2;
        }
      }
#pragma unroll
      for (int k = 0; k < kProbesPerThread; ++k) {
        if (in[k]) {
          los[idx[k]] = a[k];
          his[idx[k]] = hi[k];
        }
      }
    }
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

// meff: (segments,) int32 scratch; spl: (segments, ns_cap) int32 scratch
// with 1 <= ns_cap <= 1024.  The caller has checked m < 2^31.
int gym_sorted_probe(const void* q, const void* keys, void* lo, void* hi,
                     void* meff, void* spl, long long segments, long long n,
                     long long m, int ns_cap, void* stream) {
  if (segments * n == 0) return 0;
  if (ns_cap < 1 || ns_cap > kSplitters) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (m == 0) {  // no keys: every range is (0, 0)
    cudaError_t err = cudaMemsetAsync(lo, 0, (size_t)(segments * n) * 4, s);
    if (err == cudaSuccess) err = cudaMemsetAsync(hi, 0, (size_t)(segments * n) * 4, s);
    return (int)err;
  }
  const long long prep_blocks = segments < 65535 ? segments : 65535;
  sorted_probe_prep_kernel<<<(unsigned int)prep_blocks, 128, 0, s>>>(
      (const int32_t*)keys, (int)m, segments, ns_cap, (int32_t*)meff,
      (int32_t*)spl);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // about 16 tiles (16 K probes) per block amortise the splitter staging,
  // while keeping at least ~2k blocks in flight over the segments
  const long long tiles = (n + kProbeTile - 1) / kProbeTile;
  const long long ys = segments < 65535 ? segments : 65535;
  long long per = 16;
  while (per > 1 && ((tiles + per - 1) / per) * ys < 2048) per >>= 1;
  const dim3 grid((unsigned int)((tiles + per - 1) / per), (unsigned int)ys);
  sorted_probe_kernel<<<grid, kProbeThreads, 0, s>>>(
      (const int32_t*)q, n, (const int32_t*)keys, (int)m, (const int32_t*)meff,
      (const int32_t*)spl, ns_cap, segments, (int)per, (int32_t*)lo,
      (int32_t*)hi);
  return (int)cudaGetLastError();
}

}  // extern "C"
