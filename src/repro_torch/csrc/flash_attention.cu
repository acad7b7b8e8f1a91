// Hopper (sm_90a) flash attention: online-softmax attention with GQA,
// causal and sliding-window masks, a logit softcap and f32 accumulators.
//
// Built by repro_torch/kernels/build.py, with the other sources of this
// directory, into one plain-C shared library loaded with ctypes.  The
// launcher takes device pointers and the caller's CUDA stream, allocates
// nothing, never synchronises, and returns the cudaError_t of its
// attribute call and launch (0 = success).
//
// Replaces (TPU Pallas kernel of the reference package):
//   gym_flash_attention  <- repro/kernels/flash_attention.py::_attn_kernel
//
// Contract: q (B, H, Sq, D), k/v (B, KVH, Skv, D), all contiguous, f32 or
// bf16; head h reads kv-head h / (H / KVH).  A key col is visible from
// query row when col < Skv, (causal) col <= row (top-left aligned, no
// shift when Sq != Skv), and (window > 0) col > row - window.  Scores are
// s * scale, then softcap * tanh(s / softcap) when softcap > 0.  Masked
// entries contribute exactly 0 and a row with no visible key is 0 (the
// TPU kernel's carry turns a wholly masked leading tile into exp(0) = 1
// weights; this kernel does not).  The output has the input dtype,
// rounded once from the f32 accumulator.
//
// Bound: the main path's call (B=2, H=16, S=4608, D=256, bf16, causal)
// does 4*B*H*D*S(S+1)/2 = 348 GFLOP against 226 MB of q, k, v and o, so
// it is bound by operations: 0.35 ms at the 989 TFLOP/s bf16 tensor-core
// peak.  Only the tensor cores reach that, so the bf16 path runs both
// products there:
//
// bf16 (flash_attention_wgmma_kernel, D = 64, 128, 256; the wrapper pads
// any other D <= 256 with zero columns).  One block of two consumer
// warpgroups owns 128 q rows, 64 per warpgroup, and both share each K/V
// tile.  Thread 0 loads Q once and K/V tiles of 64 keys by TMA (3-D tensor
// maps over (D, S, B*heads), so rows past Sq/Skv arrive as zeros and never
// the next head's rows) into a 2-stage ring of 128-byte-swizzled tiles,
// with a "full" mbarrier per stage that the loads complete and an "empty"
// one that all 256 threads arrive on once they are done with the stage.
// S = Q K^T is 64x64x16 wgmma with both operands in shared memory and f32
// accumulators; the online softmax runs on the accumulator fragment in
// registers (two rows a thread, quad shuffles for the row max, the sum
// kept per thread and reduced once at the end, log2(e) folded into the
// scale so exp2f does the exponentials, the softcap's tanh as
// 1 - 2/(2^(2t log2 e) + 1), not tanh.approx, whose 5e-4 error would be
// 2.5% of a weight at softcap 50).  Masked entries get -inf before the
// exponential, so they weigh exactly 0.  P is rounded to bf16 in
// registers, where the S fragment already has the layout of the A
// operand, and O += P V is 64x64x16 wgmma with V read from shared memory
// as an MN-major B operand, one call per 64 output columns.  Tiles wholly
// above the causal diagonal or left of the window are never loaded, and
// the q tiles with the most kv tiles are launched first (block index
// reversed over the q tiles) so that the causal tail spreads over the SMs.
// At D = 256 a thread keeps 128 f32 of O and 32 of S; shared memory holds
// Q (64 KB) and two stages of K and V (128 KB).
//
// f32 (flash_attention_kernel, D = 16, 32, 64, 128, 256): CUDA-core FMAs
// from f32 tiles in shared memory.  TF32 products would not meet the f32
// tolerance (1e-4), and no dense config of the main path is f32; the edge
// checks and f32 configs use it.  One block of 256 threads per (q tile of
// 64 rows, head, batch) loops over kv tiles of 64 keys; the 64 x 64 score
// tile is a 16 x 16 grid of threads, each owning 4 rows x 4 strided
// columns; the probabilities go through shared memory to the P.V product.
// At D = 256 it takes 214,016 bytes of dynamic shared memory.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {


constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per kv tile
constexpr int kThreads = 256;  // f32 path: 16 x 16 threads over the 64 x 64 score tile

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  // Q (BQ x (D+1)), K and V (BK x (D+1)), P (BQ x (BK+1)), all f32
  return sizeof(float) *
         (size_t)(kBQ * (D + 1) + 2 * kBK * (D + 1) + kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int H,
                           int KVH, int Sq, int Skv, float scale, int causal,
                           int window, float softcap) {
  constexpr int DS = D + 1;    // padded row stride of Q, K, V in shared memory
  constexpr int PS = kBK + 1;  // padded row stride of P
  constexpr int NC = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * DS;
  float* Vs = Ks + kBK * DS;
  float* Ps = Vs + kBK * DS;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // key column group / output column group
  const int ty = tid >> 4;  // 4 query rows: ty*4 .. ty*4+3
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const T* qb = q + ((size_t)b * H + h) * (size_t)Sq * D;
  const T* kb = k + ((size_t)b * KVH + kvh) * (size_t)Skv * D;
  const T* vb = v + ((size_t)b * KVH + kvh) * (size_t)Skv * D;
  T* ob = o + ((size_t)b * H + h) * (size_t)Sq * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int row = q0 + r;
    Qs[r * DS + c] = row < Sq ? to_f32(qb[(size_t)row * D + c]) : 0.f;
  }

  // kv tiles that hold any key visible from some row of this q tile
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int kv_end = Skv;
  if (causal) kv_end = min(kv_end, q_last + 1);
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = kv_begin / kBK;
  const int t_end = (kv_end + kBK - 1) / kBK;

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // Q stored; the previous tile's K, V, P all read
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int col = k0 + r;
      const bool in = col < Skv;
      // rows past Skv are zero so that 0-weight products stay 0, not NaN
      Ks[r * DS + c] = in ? to_f32(kb[(size_t)col * D + c]) : 0.f;
      Vs[r * DS + c] = in ? to_f32(vb[(size_t)col * D + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * DS + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DS + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      bool vis[4];
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        vis[j] = col < Skv && (!causal || col <= row) &&
                 (window <= 0 || col > row - window);
        s[i][j] = x;
        if (vis[j]) mt = fmaxf(mt, x);
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float mn = fmaxf(m[i], mt);
      // mn == -inf: nothing visible yet in this row, every weight is 0
      const float corr = mn == -INFINITY ? 0.f : expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = vis[j] ? expf(s[i][j] - mn) : 0.f;
        Ps[(ty * 4 + i) * PS + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = Vs[kk * DS + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;  // no visible key -> 0
#pragma unroll
    for (int c = 0; c < NC; ++c)
      ob[(size_t)row * D + tx + 16 * c] = from_f32<T>(acc[i][c] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   long long B, long long H, long long KVH, long long Sq,
                   long long Skv, float scale, int causal, int window,
                   float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned int)((Sq + kBQ - 1) / kBQ), (unsigned int)H,
                  (unsigned int)B);
  kern<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (int)H, (int)KVH, (int)Sq,
      (int)Skv, scale, causal, window, softcap);
  return cudaGetLastError();
}

// ------------------------------------------------------- bf16: wgmma + TMA
// D (64 x 64, f32) (+)= A (64 x 16, bf16, shared memory, K-major) *
// B (16 x 64, bf16, shared memory, K-major); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16, bf16, registers: each warp holds its 16
// rows as the m16n8k16 A fragment) * B (16 x 64, bf16, shared memory,
// MN-major, so imm-trans-b = 1).
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// spins until the barrier's phase of this parity completes; a wait far
// longer than any load (2^30 polls) traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 30)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one (64 columns x 64 rows x 1) box of a 3-D tensor map into shared memory
__device__ __forceinline__ void tma_load_box(uint32_t dst, const CUtensorMap* map,
                                             uint32_t bar, int col, int row, int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(col), "r"(row), "r"(plane)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading byte offset (K-major: unused; MN-major: the stride
// between 64-element column blocks), stride byte offset 1024 (8 rows of
// 128 B), swizzle mode 128B.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from touching an accumulator across the async product
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

// tanh t = 1 - 2 / (e^(2t) + 1), e^(2t) as exp2f, clamped where tanh is
// +-1 in f32 (2^64 keeps __fdividef in its range)
__device__ __forceinline__ float tanh_exp2(float t) {
  const float z = fminf(fmaxf(t * 2.8853900817779268f, -64.f), 64.f);
  return 1.f - __fdividef(2.f, exp2f(z) + 1.f);
}

constexpr int kWgThreads = 256;  // two consumer warpgroups
constexpr int kWgRows = 128;     // q rows per block, 64 per warpgroup
constexpr uint32_t kBox = 64 * 64 * 2;  // one 64 x 64 bf16 box, 8 KB

template <int D>
constexpr size_t wgmma_smem_bytes() {
  // Q (2 x 64 rows), 2 stages of K and V (64 rows each), 5 mbarriers,
  // and slack to align the tiles to the 1024-byte swizzle atom
  return (size_t)6 * (D / 64) * kBox + 64 + 1024;
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                                 const __grid_constant__ CUtensorMap kmap,
                                 const __grid_constant__ CUtensorMap vmap,
                                 __nv_bfloat16* __restrict__ o, int H, int KVH,
                                 int Sq, int Skv, int n_qt, float scale_log2,
                                 float cap_in, float cap_log2, int causal,
                                 int window) {
  constexpr int NC = D / 64;                // 64-column chunks of a row
  constexpr uint32_t kTile = NC * kBox;     // 64 rows x D
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;                 // [warpgroup][chunk]
  const uint32_t sK = base + 2 * kTile;     // [stage][chunk]
  const uint32_t sV = base + 4 * kTile;     // [stage][chunk]
  const uint32_t sBar = base + 6 * kTile;   // full[2], empty[2], q
  const uint32_t qbar = sBar + 32;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int BH = gridDim.x / n_qt;
  const int qt = n_qt - 1 - (int)(blockIdx.x / BH);  // most kv tiles first
  const int bh = (int)(blockIdx.x % BH);
  const int b = bh / H, h = bh % H;
  const int kv_plane = b * KVH + h / (H / KVH);
  const int q0 = qt * kWgRows;
  const int q_last = min(q0 + kWgRows, Sq) - 1;
  int kv_end = Skv;
  if (causal) kv_end = min(kv_end, q_last + 1);
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = kv_begin / 64;
  const int ntiles = max(0, (kv_end + 63) / 64 - t_begin);

  if (tid == 0) {
    mbar_init(sBar, 1);
    mbar_init(sBar + 8, 1);
    mbar_init(sBar + 16, kWgThreads);
    mbar_init(sBar + 24, kWgThreads);
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load_kv = [&](int i) {  // tile i of this block into stage i & 1
    const int s = i & 1;
    const int k0 = (t_begin + i) * 64;
    mbar_expect_tx(sBar + 8 * s, 2 * kTile);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      tma_load_box(sK + s * kTile + c * kBox, &kmap, sBar + 8 * s, 64 * c, k0, kv_plane);
      tma_load_box(sV + s * kTile + c * kBox, &vmap, sBar + 8 * s, 64 * c, k0, kv_plane);
    }
  };
  if (tid == 0 && ntiles > 0) {
    mbar_expect_tx(qbar, 2 * kTile);
#pragma unroll
    for (int w = 0; w < 2; ++w)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        tma_load_box(sQ + (w * NC + c) * kBox, &qmap, qbar, 64 * c, q0 + 64 * w, bh);
    load_kv(0);
    if (ntiles > 1) load_kv(1);
  }
  __syncwarp();

  // this thread's rows r0 and r0 + 8 and its first column in an 8-column group
  const int r0 = q0 + 64 * wg + 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const int wr_lo = q0 + 64 * wg, wr_hi = wr_lo + 63;
  float acc[NC][32];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[c][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  if (ntiles > 0) mbar_wait(qbar, 0);
  for (int i = 0; i < ntiles; ++i) {
    const int s = i & 1;
    const int k0 = (t_begin + i) * 64;
    mbar_wait(sBar + 8 * s, (i >> 1) & 1);

    // S = Q K^T over D / 16 steps of 16
    float sc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t off = (ks >> 2) * kBox + (ks & 3) * 32;
      wgmma_ss_m64n64k16(sc, desc_sw128(sQ + wg * kTile + off, 16),
                         desc_sw128(sK + s * kTile + off, 16), ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // scores in log2 units; element e of the fragment is row r0 + 8 *
    // ((e >> 1) & 1), column k0 + 8 * (e >> 2) + cq + (e & 1)
    if (cap_in > 0.f) {
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = cap_log2 * tanh_exp2(sc[e] * cap_in);
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] *= scale_log2;
    }
    const bool need_mask = k0 + 63 >= Skv || (causal && k0 + 63 > wr_lo) ||
                           (window > 0 && k0 <= wr_hi - window);
    if (need_mask) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int row = r0 + 8 * ((e >> 1) & 1);
        const int col = k0 + 8 * (e >> 2) + cq + (e & 1);
        const bool vis = col < Skv && (!causal || col <= row) &&
                         (window <= 0 || col > row - window);
        if (!vis) sc[e] = -INFINITY;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 32; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
    float corr[2], ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m_run[r], mx[r]);
      // a row that has seen no key keeps max -inf; offset 0 keeps its
      // weights exp2(-inf) = 0 and its correction 0
      ms[r] = mn == -INFINITY ? 0.f : mn;
      corr[r] = exp2f(m_run[r] - ms[r]);
      m_run[r] = mn;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      sc[e] = exp2f(sc[e] - ms[(e >> 1) & 1]);
      rs[(e >> 1) & 1] += sc[e];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + rs[r];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[c][e] *= corr[(e >> 1) & 1];
    // P in bf16: k-step kk of 16 keys is fragment elements 8kk .. 8kk+7
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16x2(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

    // O += P V, 64 output columns a call
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_m64n64k16(acc[c], pa[kk],
                           desc_sw128(sV + s * kTile + c * kBox + kk * 16 * 128, kBox));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < NC; ++c) fence_regs(acc[c]);

    mbar_arrive(sBar + 16 + 8 * s);  // this thread is done with the stage
    if (tid == 0 && i + 2 < ntiles) {
      mbar_wait(sBar + 16 + 8 * s, (i >> 1) & 1);
      load_kv(i + 2);
    }
    __syncwarp();
  }

  // epilogue: row sums over the quad, normalise, round once to bf16
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = l > 0.f ? 1.f / l : 0.f;  // no visible key -> 0
  }
  __nv_bfloat16* ob = o + (size_t)bh * Sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= Sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t v = pack_bf16x2(acc[c][4 * j + 2 * r] * inv[r],
                                       acc[c][4 * j + 2 * r + 1] * inv[r]);
        *reinterpret_cast<uint32_t*>(ob + (size_t)row * D + 64 * c + 8 * j + cq) = v;
      }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime's entry-point query
// so that the library needs no -lcuda
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult qr;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &qr);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &qr);
#endif
    if (e != cudaSuccess || qr != cudaDriverEntryPointSuccess) return nullptr;
    fn = (EncodeTiledFn)p;
  }
  return fn;
}

// (D, S, planes) bf16, row-major, read in 64 x 64 boxes with the 128-byte
// swizzle; coordinates past S are filled with zeros
bool make_map(EncodeTiledFn enc, CUtensorMap* map, const void* ptr, long long D,
              long long S, long long planes) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)(S * D * 2)};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
             strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o,
                         long long B, long long H, long long KVH, long long Sq,
                         long long Skv, float scale, int causal, int window,
                         float softcap, cudaStream_t stream) {
  if (Skv == 0)  // no key anywhere: every row is 0
    return cudaMemsetAsync(o, 0, (size_t)(B * H * Sq * D) * 2, stream);
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap qm, km, vm;
  if (!make_map(enc, &qm, q, D, Sq, B * H) || !make_map(enc, &km, k, D, Skv, B * KVH) ||
      !make_map(enc, &vm, v, D, Skv, B * KVH))
    return cudaErrorInvalidValue;
  constexpr size_t smem = wgmma_smem_bytes<D>();
  auto kern = flash_attention_wgmma_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long n_qt = (Sq + kWgRows - 1) / kWgRows;
  if (n_qt * B * H >= (1LL << 31)) return cudaErrorInvalidValue;
  const float log2e = 1.4426950408889634f;
  kern<<<(unsigned int)(n_qt * B * H), kWgThreads, smem, stream>>>(
      qm, km, vm, (__nv_bfloat16*)o, (int)H, (int)KVH, (int)Sq, (int)Skv, (int)n_qt,
      scale * log2e, softcap > 0.f ? scale / softcap : 0.f, softcap * log2e, causal,
      window);
  return cudaGetLastError();
}

cudaError_t launch_f32(int D, const void* q, const void* k, const void* v,
                       void* o, long long B, long long H, long long KVH,
                       long long Sq, long long Skv, float scale, int causal,
                       int window, float softcap, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<float, 16>(q, k, v, o, B, H, KVH, Sq, Skv, scale, causal,
                               window, softcap, stream);
    case 32:
      return launch<float, 32>(q, k, v, o, B, H, KVH, Sq, Skv, scale, causal,
                               window, softcap, stream);
    case 64:
      return launch<float, 64>(q, k, v, o, B, H, KVH, Sq, Skv, scale, causal,
                               window, softcap, stream);
    case 128:
      return launch<float, 128>(q, k, v, o, B, H, KVH, Sq, Skv, scale, causal,
                                window, softcap, stream);
    case 256:
      return launch<float, 256>(q, k, v, o, B, H, KVH, Sq, Skv, scale, causal,
                                window, softcap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t launch_bf16(int D, const void* q, const void* k, const void* v,
                        void* o, long long B, long long H, long long KVH,
                        long long Sq, long long Skv, float scale, int causal,
                        int window, float softcap, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch_wgmma<64>(q, k, v, o, B, H, KVH, Sq, Skv, scale, causal,
                              window, softcap, stream);
    case 128:
      return launch_wgmma<128>(q, k, v, o, B, H, KVH, Sq, Skv, scale, causal,
                               window, softcap, stream);
    case 256:
      return launch_wgmma<256>(q, k, v, o, B, H, KVH, Sq, Skv, scale, causal,
                               window, softcap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (D in 16, 32, 64, 128, 256), 1 = bfloat16 (D in 64,
// 128, 256).  The caller has checked shapes, the grid limits and that Sq,
// Skv fit in an int, and (bf16) that q, k, v are 16-byte aligned.
int gym_flash_attention(const void* q, const void* k, const void* v, void* o,
                        int dtype, long long B, long long H, long long KVH,
                        long long Sq, long long Skv, int D, float scale,
                        int causal, int window, float softcap, void* stream) {
  if (B * H * Sq == 0) return 0;
  if (KVH <= 0 || H % KVH != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_f32(D, q, k, v, o, B, H, KVH, Sq, Skv, scale, causal,
                           window, softcap, s);
  if (dtype == 1)
    return (int)launch_bf16(D, q, k, v, o, B, H, KVH, Sq, Skv, scale, causal,
                            window, softcap, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
