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
// Membership has two paths, chosen on the host from the shapes and the
// caller's `bound` alone:
//   - bitmap (gym_semijoin_bitmap), when the caller promises that every
//     key other than INT32_MAX lies in [0, bound) and a segment's
//     ceil(bound / 128) * 16 bytes of bits fit in one block's shared
//     memory.  The dense ranks of a semijoin do: bound = n + m.  A key
//     outside [0, bound) breaks the promise and stops the kernel with
//     __trap(), never a quietly wrong mask.  A probe costs one compare
//     and one shared-memory bit test, so the kernel moves about the bytes
//     the function must move;
//   - hash set (gym_semijoin_probe), for any other int32 input.
//
// Replaces (TPU Pallas kernels of the reference package):
//   gym_hash_partition    <- repro/kernels/hash_partition.py::_partition_kernel
//   gym_semijoin_bitmap,
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

// ------------------------------------------------------ membership, hashed
// The path for keys of no known range.  One open-addressing hash set per
// segment, `slots` (a power of two, at least twice the segment's key
// count, so at most half full) int32 cells each.  A cell holds
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

// ------------------------------------------------------ membership, bitmap
// The path for keys promised to lie in [0, bound): bit x of a segment's
// row of `words` uint32 (words = ceil(bound / 128) * 4, so every row
// starts on 16 bytes) is set when x is one of its keys.  At the largest
// main-path call (56 segments of 2^20 probes and 2^17 keys, bound 2^20 +
// 2^17) a row is 144 KiB and all rows 7.9 MiB, which stays in L2.
//
// bitmap_build_kernel, grid (slices, segments): a block clears its slice
// of a segment's words in shared memory, sets one bit per valid key with a
// shared-memory atomicOr, and writes the slice out whole, so one launch
// both clears and fills the bitmap.  With fewer segments than SMs, a
// segment's words are cut into up to four slices; each slice's block
// reads all the segment's keys (the second reads hit L2) and keeps the
// bits that fall in its slice.
//
// bitmap_probe_kernel: one persistent block per SM (the bitmap takes most
// of the shared memory), each over one contiguous run of the flattened
// (segment, probe) order, so it stages each segment's words once, with
// 16-byte cp.async copies from L2, and again only when its run crosses
// into the next segment.  Probes are read 16 bytes a thread, four loads in
// flight, with a streaming hint (each is read once); a probe outside
// [0, bound), such as the -1 of an invalid row, is answered by one
// compare before any shared-memory access; each thread writes its four
// mask bytes as one 4-byte store.
constexpr int kBitmapThreads = 1024;
constexpr int kBitmapUnroll = 4;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the caller's promise: a key is INT32_MAX (padding) or in [0, bound)
__device__ __forceinline__ void bitmap_set(int32_t k, uint32_t bound, uint32_t lo_bit,
                                           uint32_t slice_bits, uint32_t* s_bits) {
  if (k == kI32Max) return;
  const uint32_t u = (uint32_t)k;
  if (u >= bound) __trap();
  const uint32_t r = u - lo_bit;
  if (r < slice_bits) atomicOr(s_bits + (r >> 5), 1u << (r & 31));
}

__global__ void __launch_bounds__(kBitmapThreads)
    bitmap_build_kernel(const int32_t* __restrict__ keys, long long m,
                        uint32_t bound, int words, int slice_words,
                        long long segments, uint32_t* __restrict__ bits) {
  extern __shared__ uint4 s_raw[];
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(s_raw);
  const int w0 = blockIdx.x * slice_words;
  const int nw = max(0, min(slice_words, words - w0));
  const uint32_t lo_bit = (uint32_t)w0 * 32u;
  const uint32_t slice_bits = (uint32_t)nw * 32u;
  for (long long seg = blockIdx.y; seg < segments; seg += gridDim.y) {
    for (int w = threadIdx.x; w < nw; w += kBitmapThreads) s_bits[w] = 0u;
    __syncthreads();
    const int32_t* ks = keys + seg * m;
    // scalar keys up to the first 16-byte boundary, int4 loads after it
    const long long head =
        min(m, (long long)(((16u - ((uintptr_t)ks & 15u)) & 15u) >> 2));
    const long long nvec = (m - head) >> 2;
    for (long long i = threadIdx.x; i < head; i += kBitmapThreads)
      bitmap_set(ks[i], bound, lo_bit, slice_bits, s_bits);
    for (long long i = head + 4 * nvec + threadIdx.x; i < m; i += kBitmapThreads)
      bitmap_set(ks[i], bound, lo_bit, slice_bits, s_bits);
    const int4* kv = reinterpret_cast<const int4*>(ks + head);
    for (long long v = threadIdx.x; v < nvec;
         v += (long long)kBitmapThreads * kBitmapUnroll) {
      int4 x[kBitmapUnroll];
#pragma unroll
      for (int u = 0; u < kBitmapUnroll; ++u) {
        const long long vu = v + (long long)u * kBitmapThreads;
        x[u] = vu < nvec ? kv[vu] : make_int4(kI32Max, kI32Max, kI32Max, kI32Max);
      }
#pragma unroll
      for (int u = 0; u < kBitmapUnroll; ++u) {
        bitmap_set(x[u].x, bound, lo_bit, slice_bits, s_bits);
        bitmap_set(x[u].y, bound, lo_bit, slice_bits, s_bits);
        bitmap_set(x[u].z, bound, lo_bit, slice_bits, s_bits);
        bitmap_set(x[u].w, bound, lo_bit, slice_bits, s_bits);
      }
    }
    __syncthreads();
    uint32_t* dst = bits + seg * (long long)words + w0;
    for (int w = threadIdx.x; w < nw; w += kBitmapThreads) dst[w] = s_bits[w];
    __syncthreads();  // the slice is written out before the next clear
  }
}

__device__ __forceinline__ uint32_t bitmap_hit(int32_t x, uint32_t bound,
                                               const uint32_t* s_bits) {
  const uint32_t u = (uint32_t)x;
  return u < bound ? (s_bits[u >> 5] >> (u & 31)) & 1u : 0u;
}

// q is 16-byte aligned (the wrapper sees to it) and out is a fresh
// allocation, so at a flat index i % 4 == 0 an int4 of probes and a
// uint32 of mask bytes are aligned
__global__ void __launch_bounds__(kBitmapThreads, 1)
    bitmap_probe_kernel(const int32_t* __restrict__ q, long long n,
                        const uint32_t* __restrict__ bits, int words,
                        uint32_t bound, long long total, long long per_block,
                        uint8_t* __restrict__ out) {
  extern __shared__ uint4 s_raw[];
  const uint32_t* s_bits = reinterpret_cast<const uint32_t*>(s_raw);
  const long long g0 = (long long)blockIdx.x * per_block;
  const long long g1 = min(g0 + per_block, total);
  const int t = threadIdx.x;
  long long seg = g0 / n;
  for (long long i0 = g0; i0 < g1; ++seg) {
    const long long i1 = min((seg + 1) * n, g1);
    __syncthreads();  // every thread is done with the previous segment
    const uint4* src = reinterpret_cast<const uint4*>(bits + seg * (long long)words);
    for (int w = t; w < (words >> 2); w += kBitmapThreads) cp_async16(s_raw + w, src + w);
    cp_async_wait_all();
    __syncthreads();
    const long long a = min(i1, (i0 + 3) & ~3LL);  // first multiple of 4
    const long long b = max(a, i1 & ~3LL);         // last multiple of 4
    for (long long i = i0 + t; i < a; i += kBitmapThreads)
      out[i] = (uint8_t)bitmap_hit(q[i], bound, s_bits);
    for (long long i = b + t; i < i1; i += kBitmapThreads)
      out[i] = (uint8_t)bitmap_hit(q[i], bound, s_bits);
    const int4* qv = reinterpret_cast<const int4*>(q);
    uint32_t* ov = reinterpret_cast<uint32_t*>(out);
    const long long v1 = b >> 2;
    for (long long v = (a >> 2) + t; v < v1;
         v += (long long)kBitmapThreads * kBitmapUnroll) {
      int4 x[kBitmapUnroll];
#pragma unroll
      for (int u = 0; u < kBitmapUnroll; ++u) {
        const long long vu = v + (long long)u * kBitmapThreads;
        x[u] = vu < v1 ? __ldcs(qv + vu) : make_int4(-1, -1, -1, -1);
      }
#pragma unroll
      for (int u = 0; u < kBitmapUnroll; ++u) {
        const long long vu = v + (long long)u * kBitmapThreads;
        if (vu < v1) {
          const uint32_t r = bitmap_hit(x[u].x, bound, s_bits) |
                             bitmap_hit(x[u].y, bound, s_bits) << 8 |
                             bitmap_hit(x[u].z, bound, s_bits) << 16 |
                             bitmap_hit(x[u].w, bound, s_bits) << 24;
          __stcs(ov + vu, r);
        }
      }
    }
    i0 = i1;
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

// Bitmap membership: bits is (segments, words) uint32 scratch, words a
// multiple of 4 with bound <= 32 * words; keys other than INT32_MAX must
// lie in [0, bound) (else the build traps).  Two launches: build, probe.
int gym_semijoin_bitmap(const void* q, const void* keys, void* bits, void* out,
                        long long segments, long long n, long long m,
                        long long bound, long long words, void* stream) {
  if (segments * n == 0) return 0;
  if (bound < 0 || words < 0 || (words & 3) || bound > 32 * words ||
      bound > (long long)kI32Max)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  static int s_sms[64], s_optin[64];
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (s_sms[dev] == 0) {  // once per device: SM count, opt-in shared memory
    int sms = 0, optin = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(bitmap_build_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(bitmap_probe_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return (int)err;
    s_optin[dev] = optin;
    s_sms[dev] = sms;
  }
  const int sms = s_sms[dev];
  if (words * 4 > (long long)s_optin[dev]) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // build: up to four slices of a segment's words when segments < SMs
  long long slices = segments < sms ? sms / segments : 1;
  slices = slices < 1 ? 1 : (slices > 4 ? 4 : slices);
  long long slice_words = ((words + slices - 1) / slices + 3) & ~3LL;
  if (slice_words > 0) slices = (words + slice_words - 1) / slice_words;
  else slices = 1;
  const dim3 bgrid((unsigned int)slices,
                   (unsigned int)(segments < 65535 ? segments : 65535));
  bitmap_build_kernel<<<bgrid, kBitmapThreads, (size_t)slice_words * 4, s>>>(
      (const int32_t*)keys, m, (uint32_t)bound, (int)words, (int)slice_words,
      segments, (uint32_t*)bits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // probe: at most one block per SM, each over >= 4096 probes, runs of a
  // multiple of 4 probes
  const long long total = segments * n;
  long long blocks = (total + 4095) / 4096;
  if (blocks > sms) blocks = sms;
  const long long per_block = (((total + blocks - 1) / blocks) + 3) & ~3LL;
  blocks = (total + per_block - 1) / per_block;
  bitmap_probe_kernel<<<(unsigned int)blocks, kBitmapThreads, (size_t)words * 4, s>>>(
      (const int32_t*)q, n, (const uint32_t*)bits, (int)words, (uint32_t)bound,
      total, per_block, (uint8_t*)out);
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
