// Hopper (sm_90a) kernels of the packed exchange wire: the bit-level
// codec of repro_torch/relational/wire.py, one pass each way.
//
// Built with the other csrc/*.cu by repro_torch/kernels/build.py into one
// plain-C shared library loaded with ctypes.  Every launcher takes device
// pointers and the caller's CUDA stream, allocates nothing, never
// synchronises, and returns the cudaError_t of its launch (0 = success).
//
// The layout (the reference's, pinned by tests/fixtures/wire_s8_packed.npz):
// a bucket of c slots is padded with invalid slots to groups of 8; group g
// packs to row_bits bytes, where byte b holds bit b of every slot's row
// stream, slot r of the group in bit r of the byte.  A row stream is the
// valid bit, then each column's col_bits[j] bits, least significant first.
//
// One warp owns 32 consecutive slots = 4 groups of one segment (segments
// are the flattened leading axes, laid out back to back).  Encode: each
// lane reads its slot's valid flag and arity words once; for every row bit
// one __ballot_sync over the lanes yields the 4 groups' bytes in one
// 32-bit word (byte q of the ballot is group q), which lanes 0-3 drop into
// a per-warp shared buffer; the warp then stores its 4 * row_bits
// contiguous output bytes with coalesced byte stores.  Decode is the
// inverse: the warp loads its 4 * row_bits bytes into shared memory once,
// and lane 8q + r rebuilds slot r of group q bit by bit.  Both are bound
// by memory bytes: encode reads 4 * arity + 1 bytes a slot and writes
// row_bits / 8; decode the reverse.
//
// This codec has no TPU counterpart: the reference computes it with XLA
// element-wise operations (repro/relational/wire.py), which fuse under jit
// but would each materialise a (slots, row_bits) tensor in eager PyTorch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroupsPerWarp = 4;  // 32 slots / 8 slots a group
constexpr unsigned kFull = 0xFFFFFFFFu;

inline unsigned int blocks_for_warps(long long warps) {
  long long b = (warps + kWarps - 1) / kWarps;
  const long long cap = 132LL * 16LL;  // grid-stride loops cover the rest
  return (unsigned int)(b < cap ? b : cap);
}

__global__ void wire_encode_kernel(const int32_t* __restrict__ buf,
                                   const uint8_t* __restrict__ valid,
                                   const int32_t* __restrict__ col_bits,
                                   uint8_t* __restrict__ out, long long c,
                                   long long ng, int ar, int row_bits,
                                   long long total_warps) {
  extern __shared__ uint8_t smem[];
  const int lane = threadIdx.x & 31;
  uint8_t* wbuf = smem + (threadIdx.x >> 5) * kGroupsPerWarp * row_bits;
  const long long wps = (ng + kGroupsPerWarp - 1) / kGroupsPerWarp;
  for (long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       w < total_warps; w += (long long)gridDim.x * kWarps) {
    const long long s = w / wps;
    const long long g0 = (w % wps) * kGroupsPerWarp;
    const long long slot = g0 * 8 + lane;
    const bool in = slot < c;
    const long long at = s * c + slot;
    unsigned bal = __ballot_sync(kFull, in && valid[at] != 0);
    if (lane < kGroupsPerWarp) wbuf[lane * row_bits] = (uint8_t)(bal >> (8 * lane));
    int b = 1;
    for (int j = 0; j < ar; ++j) {
      const uint32_t x = in ? (uint32_t)buf[at * ar + j] : 0u;
      const int nb = col_bits[j];
      for (int k = 0; k < nb; ++k, ++b) {
        bal = __ballot_sync(kFull, (x >> k) & 1u);
        if (lane < kGroupsPerWarp) wbuf[lane * row_bits + b] = (uint8_t)(bal >> (8 * lane));
      }
    }
    __syncwarp();
    const long long left = ng - g0;
    const int n = (int)(left < kGroupsPerWarp ? left : kGroupsPerWarp) * row_bits;
    uint8_t* dst = out + (s * ng + g0) * row_bits;
    for (int i = lane; i < n; i += 32) dst[i] = wbuf[i];
    __syncwarp();
  }
}

__global__ void wire_decode_kernel(const uint8_t* __restrict__ in,
                                   const int32_t* __restrict__ col_bits,
                                   int32_t* __restrict__ buf,
                                   uint8_t* __restrict__ valid, long long c,
                                   long long ng, int ar, int row_bits,
                                   long long total_warps) {
  extern __shared__ uint8_t smem[];
  const int lane = threadIdx.x & 31;
  uint8_t* wbuf = smem + (threadIdx.x >> 5) * kGroupsPerWarp * row_bits;
  const long long wps = (ng + kGroupsPerWarp - 1) / kGroupsPerWarp;
  for (long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       w < total_warps; w += (long long)gridDim.x * kWarps) {
    const long long s = w / wps;
    const long long g0 = (w % wps) * kGroupsPerWarp;
    const long long left = ng - g0;
    const int n = (int)(left < kGroupsPerWarp ? left : kGroupsPerWarp) * row_bits;
    const uint8_t* src = in + (s * ng + g0) * row_bits;
    for (int i = lane; i < n; i += 32) wbuf[i] = src[i];
    __syncwarp();
    const long long slot = g0 * 8 + lane;
    if (slot < c) {
      const int r = lane & 7;
      const uint8_t* grp = wbuf + (lane >> 3) * row_bits;
      const long long at = s * c + slot;
      valid[at] = (grp[0] >> r) & 1;
      int b = 1;
      for (int j = 0; j < ar; ++j) {
        const int nb = col_bits[j];
        uint32_t x = 0;
        for (int k = 0; k < nb; ++k, ++b) x |= (uint32_t)((grp[b] >> r) & 1) << k;
        buf[at * ar + j] = (int32_t)x;
      }
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// buf (segs, c, ar) int32, valid (segs, c) uint8, col_bits (ar,) int32 ->
// out (segs, ceil(c / 8) * row_bits) uint8
int gym_wire_encode(const void* buf, const void* valid, const void* col_bits, void* out,
                    long long segs, long long c, int ar, int row_bits, void* stream) {
  const long long ng = (c + 7) / 8;
  const long long warps = segs * ((ng + kGroupsPerWarp - 1) / kGroupsPerWarp);
  if (warps == 0) return 0;
  const size_t smem = (size_t)kWarps * kGroupsPerWarp * row_bits;
  wire_encode_kernel<<<blocks_for_warps(warps), kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)buf, (const uint8_t*)valid, (const int32_t*)col_bits, (uint8_t*)out,
      c, ng, ar, row_bits, warps);
  return (int)cudaGetLastError();
}

// in (segs, ceil(c / 8) * row_bits) uint8 -> buf (segs, c, ar) int32,
// valid (segs, c) uint8
int gym_wire_decode(const void* in, const void* col_bits, void* buf, void* valid,
                    long long segs, long long c, int ar, int row_bits, void* stream) {
  const long long ng = (c + 7) / 8;
  const long long warps = segs * ((ng + kGroupsPerWarp - 1) / kGroupsPerWarp);
  if (warps == 0) return 0;
  const size_t smem = (size_t)kWarps * kGroupsPerWarp * row_bits;
  wire_decode_kernel<<<blocks_for_warps(warps), kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (const int32_t*)col_bits, (int32_t*)buf, (uint8_t*)valid,
      c, ng, ar, row_bits, warps);
  return (int)cudaGetLastError();
}

}  // extern "C"
