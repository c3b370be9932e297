// Secure-aggregation combine kernels for Hopper (sm_90a).
//
// K1 masked_sum:            out[t] = sum_{i<N} w[i] * x[i,t]
// K2 masked_sum_corrected:  out[t] = sum_{i<N} w[i] * (x[i,t] - c[i,t])
// K5 secure_agg_combine:    out[t] = sum_{i<N} ws[i] * float(q[i,t])
//
// Replace the Pallas TPU kernels in src/repro/kernels/secure_agg/kernel.py:
//   K1 masked_sum_flat           (_combine_call / _combine_kernel)
//   K2 masked_sum_corrected_flat (_combine_call / _combine_corrected_kernel)
//   K5 secure_agg_combine_flat   (_combine_call / _combine_kernel, int8 q,
//                                 ws = weights * scales formed in f32 by
//                                 the caller, as kernel.py:63 does)
//
// x, c: (N, T) fp32 row-major contiguous; q: (N, T) int8; w, ws: (N,) fp32;
// out: (T,) fp32.
//
// Bound: bytes. Each column is read once per row and written once, with
// 2 (K1, K5) or 3 (K2) flops per element read, far under the card's
// flop/byte ridge. So the least time is (N+1)*T*4 bytes (K1),
// (2N+1)*T*4 bytes (K2) or N*T + 4*T bytes (K5) over the HBM rate
// (3.35 TB/s on an H100 SXM).
//
// Design: the TPU kernel tiles T into (N, 4096) VMEM blocks and runs a
// (1,N)x(N,BT) MXU product per block. Here there is no tensor-core work
// worth having (N is a handful of rows), so the kernel is column-parallel:
// each thread owns 4 adjacent columns, loads them as one float4 (K1, K2)
// or one char4 (K5) per row (neighbouring threads on neighbouring
// addresses) and sums the rows in the fixed order i = 0..N-1 in fp32, so
// two launches on the same input are bitwise equal. A grid-stride loop
// over column groups with a few blocks per SM keeps all 132 SMs busy. The
// ragged tail is masked in the kernel (no padded copy, unlike
// kernel.py:36-42): when T is not a multiple of 4 (rows then lose their
// vector alignment) or a base pointer is not aligned for the vector load,
// the scalar variant runs, one column a thread. The correction subtract
// of K2 is fused into the same pass, as the TPU kernel fuses it into its
// tile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ float4 load4(const float4* p) { return __ldg(p); }

__device__ __forceinline__ float4 load4(const char4* p) {
  const char4 v = __ldg(p);
  return make_float4((float)v.x, (float)v.y, (float)v.z, (float)v.w);
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load1(const signed char* p) {
  return (float)__ldg(p);
}

// V: float4 (K1, K2) or char4 (K5) rows of x.
template <typename V, bool kCorr>
__global__ void __launch_bounds__(kThreads)
combine_vec4(const V* __restrict__ x, const float4* __restrict__ c,
             const float* __restrict__ w, float4* __restrict__ out,
             int n, long long groups) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = 0; i < n; ++i) {
      const float wi = __ldg(w + i);
      float4 v = load4(x + (long long)i * groups + g);
      if (kCorr) {
        const float4 ci = __ldg(c + (long long)i * groups + g);
        v.x -= ci.x; v.y -= ci.y; v.z -= ci.z; v.w -= ci.w;
      }
      acc.x += wi * v.x; acc.y += wi * v.y;
      acc.z += wi * v.z; acc.w += wi * v.w;
    }
    out[g] = acc;
  }
}

// E: float (K1, K2) or signed char (K5) elements of x.
template <typename E, bool kCorr>
__global__ void __launch_bounds__(kThreads)
combine_scalar(const E* __restrict__ x, const float* __restrict__ c,
               const float* __restrict__ w, float* __restrict__ out,
               int n, long long t) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < t; j += stride) {
    float acc = 0.f;
    for (int i = 0; i < n; ++i) {
      float v = load1(x + (long long)i * t + j);
      if (kCorr) v -= __ldg(c + (long long)i * t + j);
      acc += __ldg(w + i) * v;
    }
    out[j] = acc;
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

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// E: the element type of x (float or signed char); V: its 4-vector.
template <typename E, typename V, bool kCorr>
int launch(const void* x, const void* c, const void* w, void* out, int n,
           long long t, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (t <= 0) return (int)cudaSuccess;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool vec = (t % 4 == 0) && aligned(x, sizeof(V)) &&
                   aligned(out, 16) && (!kCorr || aligned(c, 16));
  if (vec) {
    const long long groups = t / 4;
    combine_vec4<V, kCorr><<<grid_for(groups, device), kThreads, 0, s>>>(
        static_cast<const V*>(x), static_cast<const float4*>(c),
        static_cast<const float*>(w), static_cast<float4*>(out), n, groups);
  } else {
    combine_scalar<E, kCorr><<<grid_for(t, device), kThreads, 0, s>>>(
        static_cast<const E*>(x), static_cast<const float*>(c),
        static_cast<const float*>(w), static_cast<float*>(out), n, t);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1. Returns cudaGetLastError() after the launch (0 = launched).
int masked_sum_f32(const void* x, const void* w, void* out, int n,
                   long long t, int device, void* stream) {
  return launch<float, float4, false>(x, nullptr, w, out, n, t, device,
                                      stream);
}

// K2. Returns cudaGetLastError() after the launch (0 = launched).
int masked_sum_corrected_f32(const void* x, const void* c, const void* w,
                             void* out, int n, long long t, int device,
                             void* stream) {
  return launch<float, float4, true>(x, c, w, out, n, t, device, stream);
}

// K5. q int8 rows, ws = weights * scales. Returns cudaGetLastError()
// after the launch (0 = launched).
int secure_agg_combine_f32(const void* q, const void* ws, void* out, int n,
                           long long t, int device, void* stream) {
  return launch<signed char, char4, false>(q, nullptr, ws, out, n, t,
                                           device, stream);
}

}  // extern "C"
