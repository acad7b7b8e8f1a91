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
// Design.  One block of 256 threads per (q tile of 64 rows, head, batch);
// a loop over kv tiles of 64 keys, staged in shared memory as f32, takes
// the place of the TPU's sequential kv grid axis.  The 64 x 64 score tile
// is a 16 x 16 grid of threads, each owning 4 rows x 4 strided columns;
// each row's running max m and sum l live in the registers of the 16
// lanes that share the row (reduced with warp shuffles), and the
// unnormalised output (64 x D) is spread over the same threads, D/16
// columns each.  The probabilities go through shared memory to the P.V
// product.  Shared-memory rows are padded by one float so that the 16
// lanes reading 16 different key rows hit 16 different banks.  At D = 256
// the block needs 214,016 bytes of dynamic shared memory, above the 48 KB
// default, so the launcher raises the limit with cudaFuncSetAttribute.
// Tiles wholly above the causal diagonal or wholly left of the window are
// never loaded.
//
// Bound: the main path's call (B=2, H=16, S=4608, D=256, causal) does
// 4*B*H*D*S(S+1)/2 = 348 GFLOP against 226 MB of q, k, v and o, so it is
// bound by operations (0.35 ms at the bf16 tensor-core peak).  This
// kernel runs its products as f32 FMAs on the CUDA cores and reads its
// operands from shared memory, so it reaches neither that peak nor the
// 67 TFLOP/s of f32: tensor cores (wgmma) and TMA staging are the work of
// a later change.  Supported D: 16, 32, 64, 128, 256 (the wrapper pads
// any other D <= 256 with zero columns).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per kv tile
constexpr int kThreads = 256;  // 16 x 16 threads over the 64 x 64 score tile

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
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

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     void* o, long long B, long long H, long long KVH,
                     long long Sq, long long Skv, float scale, int causal,
                     int window, float softcap, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, H, KVH, Sq, Skv, scale, causal,
                           window, softcap, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, KVH, Sq, Skv, scale, causal,
                           window, softcap, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, KVH, Sq, Skv, scale, causal,
                           window, softcap, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, KVH, Sq, Skv, scale, causal,
                            window, softcap, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, H, KVH, Sq, Skv, scale, causal,
                            window, softcap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  The caller has checked shapes, the
// grid limits (H, B <= 65535) and that Sq, Skv fit in an int.
int gym_flash_attention(const void* q, const void* k, const void* v, void* o,
                        int dtype, long long B, long long H, long long KVH,
                        long long Sq, long long Skv, int D, float scale,
                        int causal, int window, float softcap, void* stream) {
  if (B * H * Sq == 0) return 0;
  if (KVH <= 0 || H % KVH != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_d<float>(D, q, k, v, o, B, H, KVH, Sq, Skv, scale,
                                causal, window, softcap, s);
  if (dtype == 1)
    return (int)launch_d<__nv_bfloat16>(D, q, k, v, o, B, H, KVH, Sq, Skv,
                                        scale, causal, window, softcap, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
