// Compressed-plane combine kernels for Hopper (sm_90a).
//
// K3 dequant_reduce:          out[t] = sum_{i<N} w[i] * (q[i,t] * s[i, t/1024])
// K4 masked_dequant_reduce:   out[t] = g[t/1024] * center((sum_i z[i,t]
//                                        - sum_i c[i,t]) mod 2^mbits)
//
// Replace the Pallas TPU kernels in src/repro/kernels/compressed_agg/kernel.py:
//   K3 dequant_reduce_flat        (_dequant_reduce_kernel)
//   K4 masked_dequant_reduce_flat (_masked_dequant_reduce_kernel, and
//                                  _masked_dequant_reduce_corr_kernel with c)
//
// q: (N, T) int8 row-major, T a multiple of 1024; s: (N, T/1024) f32;
// w: (N,) f32. z, c: (N, T) uint32 (any 32-bit storage); g: (T/1024,) f32;
// out: (T,) f32. mbits is 16 or 32.
//
// Bound: bytes. K3 reads N*T int8 plus 4*N*T/1024 scale bytes and writes
// 4*T: about 3 flops per byte read, far under the card's ridge. K4 reads
// 4*N*T (z) [+ 4*N*T (c)] plus T/256 grid bytes and writes 4*T, with a
// handful of integer ops per 4-byte word. The least time is those bytes
// over the HBM rate (3.35 TB/s on an H100 SXM).
//
// Design. The TPU kernels tile T into (N, 4096) VMEM blocks; K3 runs a
// (1,N)x(N,BT) MXU product per block, K4 a VPU integer reduce. With N a
// handful of rows there is no tensor-core work worth having, so both are
// column-parallel, like K1, with a grid-stride loop over column groups
// and a few blocks per SM:
// - K3: a thread owns 16 adjacent int8 columns and loads them as one
//   16-byte word per row (neighbouring threads on neighbouring words). A
//   16-column group never straddles a 1024-column chunk, so the thread
//   reads one scale per row. Rows are summed in the fixed order
//   i = 0..N-1 as acc += w[i] * (float(q) * s), dequantise first and then
//   weight, as the TPU kernel does; repeat launches are bitwise equal.
// - K4: a thread owns 4 columns and loads them as one uint4 per row. The
//   row sum wraps natively in uint32 (that is the mod 2^32 the masks
//   cancel under), the correction rows are subtracted the same way, then
//   the residue is masked to mbits, centered (a bitcast at mbits = 32)
//   and multiplied once by the chunk's grid value. The integer part is
//   exact in any order, so the result is bitwise that of the plain
//   version.
// The ragged grid-stride tail is masked in the kernel; the TPU wrapper
// pads instead (kernel.py:53-56, 143-149). T % 1024 == 0 keeps every row
// 16-byte aligned when the base pointers are; the wrapper checks both.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr long long kChunk = 1024;
constexpr int kI8Cols = 16;        // K3 columns a thread
constexpr int kU32Cols = 4;        // K4 columns a thread

__global__ void __launch_bounds__(kThreads)
dequant_reduce_k(const int4* __restrict__ q, const float* __restrict__ s,
                 const float* __restrict__ w, float4* __restrict__ out,
                 int n, long long groups, long long chunks) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const long long chunk = g / (kChunk / kI8Cols);
    float acc[kI8Cols];
#pragma unroll
    for (int k = 0; k < kI8Cols; ++k) acc[k] = 0.f;
    for (int i = 0; i < n; ++i) {
      union { int4 v; signed char b[kI8Cols]; } row;
      row.v = __ldg(q + (long long)i * groups + g);
      const float si = __ldg(s + (long long)i * chunks + chunk);
      const float wi = __ldg(w + i);
#pragma unroll
      for (int k = 0; k < kI8Cols; ++k) {
        acc[k] += wi * ((float)row.b[k] * si);
      }
    }
    float4* o = out + g * (kI8Cols / 4);
#pragma unroll
    for (int k = 0; k < kI8Cols / 4; ++k) {
      o[k] = make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2],
                         acc[4 * k + 3]);
    }
  }
}

__device__ __forceinline__ float decode(unsigned int sum, unsigned int mask,
                                        int mbits, float grid) {
  const unsigned int r = sum & mask;
  int c;
  if (mbits == 32) {
    c = static_cast<int>(r);                 // two's-complement bitcast
  } else {
    const int ri = static_cast<int>(r);      // r < 2^mbits fits exactly
    c = ri - (ri >= (1 << (mbits - 1)) ? (1 << mbits) : 0);
  }
  return (float)c * grid;
}

template <bool kCorr>
__global__ void __launch_bounds__(kThreads)
masked_dequant_reduce_k(const uint4* __restrict__ z,
                        const uint4* __restrict__ c,
                        const float* __restrict__ grid,
                        float4* __restrict__ out, int n, long long groups,
                        unsigned int mask, int mbits) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    uint4 acc = make_uint4(0u, 0u, 0u, 0u);
    for (int i = 0; i < n; ++i) {
      const uint4 v = __ldg(z + (long long)i * groups + g);
      acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    }
    if (kCorr) {
      for (int i = 0; i < n; ++i) {
        const uint4 v = __ldg(c + (long long)i * groups + g);
        acc.x -= v.x; acc.y -= v.y; acc.z -= v.z; acc.w -= v.w;
      }
    }
    const float gs = __ldg(grid + g / (kChunk / kU32Cols));
    out[g] = make_float4(decode(acc.x, mask, mbits, gs),
                         decode(acc.y, mask, mbits, gs),
                         decode(acc.z, mask, mbits, gs),
                         decode(acc.w, mask, mbits, gs));
  }
}

int grid_for(long long work, int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)
      != cudaSuccess || sms <= 0) {
    sms = 132;
  }
  long long blocks = (work + kThreads - 1) / kThreads;
  long long cap = (long long)sms * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// K3. Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a T that is not a 1024 multiple or a base
// pointer that is not 16-byte aligned.
int dequant_reduce_f32(const void* q, const void* s, const void* w,
                       void* out, int n, long long t, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (t % kChunk != 0 || !aligned16(q) || !aligned16(out)) {
    return (int)cudaErrorInvalidValue;
  }
  if (t == 0) return (int)cudaSuccess;
  const long long groups = t / kI8Cols;
  dequant_reduce_k<<<grid_for(groups, device), kThreads, 0,
                     reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(q), static_cast<const float*>(s),
      static_cast<const float*>(w), static_cast<float4*>(out), n, groups,
      t / kChunk);
  return (int)cudaGetLastError();
}

// K4, with (c != nullptr) or without corrections. Same return codes as
// K3; also cudaErrorInvalidValue for mbits outside {16, 32}.
int masked_dequant_reduce_u32(const void* z, const void* c, const void* g,
                              void* out, int n, long long t, int mbits,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (t % kChunk != 0 || (mbits != 16 && mbits != 32) || !aligned16(z) ||
      !aligned16(out) || (c != nullptr && !aligned16(c))) {
    return (int)cudaErrorInvalidValue;
  }
  if (t == 0) return (int)cudaSuccess;
  const long long groups = t / kU32Cols;
  const unsigned int mask =
      mbits == 32 ? 0xFFFFFFFFu : ((1u << mbits) - 1u);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (c != nullptr) {
    masked_dequant_reduce_k<true><<<grid_for(groups, device), kThreads, 0,
                                    st>>>(
        static_cast<const uint4*>(z), static_cast<const uint4*>(c),
        static_cast<const float*>(g), static_cast<float4*>(out), n, groups,
        mask, mbits);
  } else {
    masked_dequant_reduce_k<false><<<grid_for(groups, device), kThreads, 0,
                                     st>>>(
        static_cast<const uint4*>(z), nullptr,
        static_cast<const float*>(g), static_cast<float4*>(out), n, groups,
        mask, mbits);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
