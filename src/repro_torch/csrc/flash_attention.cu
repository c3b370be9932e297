// K6 flash attention forward for Hopper (sm_90a).
//
//   o[b,i,h,:] = sum_j softmax_j(cap(scale * q[b,i,h,:] . k[b,j,h/G,:])) v[b,j,h/G,:]
//
// over the keys j that the mask lets through: j <= i when causal, and
// j > i - window when window > 0. cap is the tanh logit softcap (off at 0).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/
// kernel.py::flash_attention_bhsd (_attn_kernel).
//
// q: (B, Sq, H, D), k and v: (B, Sk, Hkv, D), o: (B, Sq, H, D), each read or
// written through its (b, s, h) element strides with d contiguous, so the
// models' (B,S,H,D) layout needs no transposed copy (the TPU wrapper swaps
// axes, flash_attention/ops.py:22-24). float32 or bfloat16 (all four the
// same type); D in {32, 64, 128}; H a multiple of Hkv (G = H / Hkv).
//
// Bound: operations. 4*D FLOPs per visible (query, key) pair; at the serve
// path's shape (B 4, H 25, S 2048, D 64, bf16) a global layer is 53.7
// GFLOP against 63 MB of q/k/v/o, far above the card's ridge, so the
// least time is those FLOPs over the bf16 tensor-core rate.
//
// Design (a simple kernel that is right; wgmma and TMA come later). One
// CTA of 256 threads per (q-block of 64 rows, head, batch). A 64-key tile
// of K and V at a time goes through shared memory, widened to f32; the
// q-block sits there too, transposed, for the whole CTA. A thread owns 4
// query rows (ty + 16 i) and 4 keys (tx + 16 j) of the 64 x 64 score tile,
// and the same 4 rows times D/16 columns (tx + 16 c) of the output. Row
// max and row sum go across the 16 tx lanes of a half-warp by shuffles.
// m, l and the accumulator are f32 (online softmax); the probabilities stay
// f32 into the PV product, as the TPU kernel's do. Every FMA runs on the
// CUDA cores, so this kernel is far from its tensor-core bound.
//   - Tiles wholly outside the causal/window band are skipped: the loop
//     runs over [max(0, q0 - window + 1), min(Sk, q0 + 64)) rounded to
//     tiles (the TPU kernel walks all Sk/BK tiles).
//   - Ragged Sq and Sk tails are masked in the kernel (K and V rows past Sk
//     are zero-filled, query rows past Sq are not stored).
//   - Masked pairs get probability 0 (not exp(NEG_INF - m)), and the
//     output is acc / max(l, 1e-30) as in the TPU kernel, so a row with
//     nothing visible gives 0, not NaN.
//   - Sums run in a fixed order: repeat launches are bitwise equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                 // query rows a CTA
constexpr int kBK = 64;                 // keys a tile
constexpr int kTX = 16;                 // threads across keys / out columns
constexpr int kTY = 16;                 // threads across query rows
constexpr int kThreads = kTX * kTY;
constexpr int kRows = kBQ / kTY;        // query rows a thread
constexpr int kCols = kBK / kTX;        // keys a thread
constexpr int kQtStride = kBQ + 1;      // q tile stored [d][row]
constexpr int kKtStride = kBK + 1;      // k tile stored [d][key]
constexpr int kPStride = kBK + 16;      // p tile stored [row][key]
constexpr float kNegInf = -2.3819763e38f;

struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);     // round to nearest even, as torch and XLA
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)D * kQtStride + (size_t)D * kKtStride +
                          (size_t)kBK * D + (size_t)kBQ * kPStride);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_k(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
            int group, Strides qs, Strides ks, Strides vs, Strides os,
            float scale, int causal, int window, float softcap) {
  constexpr int kOut = D / kTX;         // output columns a thread
  extern __shared__ float smem[];
  float* qt = smem;                     // [D][kQtStride]
  float* kt = qt + D * kQtStride;       // [D][kKtStride]
  float* vsm = kt + D * kKtStride;      // [kBK][D]
  float* ps = vsm + kBK * D;            // [kBQ][kPStride]

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  T* ob = o + b * os.b + h * os.h;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int qi = q0 + r;
    qt[d * kQtStride + r] = qi < sq ? to_f32(qb[qi * qs.s + d]) : 0.f;
  }

  int k_lo = 0, k_hi = sk;
  if (causal) k_hi = min(sk, q0 + kBQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  k_lo = (k_lo / kBK) * kBK;

  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();            // the last tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const int kj = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kj < sk) {
        kv = to_f32(kb[kj * ks.s + d]);
        vv = to_f32(vb[kj * vs.s + d]);
      }
      kt[d * kKtStride + r] = kv;
      vsm[r * D + d] = vv;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    }
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[kRows], bk[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = qt[d * kQtStride + ty + kTY * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) bk[j] = kt[d * kKtStride + tx + kTX * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + kTY * i;
      const int qi = q0 + r;
      bool vis[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kj = k0 + tx + kTX * j;
        vis[j] = kj < sk && (!causal || kj <= qi) &&
                 (window <= 0 || kj > qi - window);
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        s[i][j] = x;
        if (vis[j]) mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = vis[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[r * kPStride + tx + kTX * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1) {
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      }
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOut; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float vv[kOut];
#pragma unroll
      for (int c = 0; c < kOut; ++c) vv[c] = vsm[kk * D + tx + kTX * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = ps[(ty + kTY * i) * kPStride + kk];
#pragma unroll
        for (int c = 0; c < kOut; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qi = q0 + ty + kTY * i;
    if (qi >= sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kOut; ++c) {
      store(ob + qi * os.s + tx + kTX * c, acc[i][c] * inv);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int h, int hkv, int sq, int sk, const long long* st, float scale,
           int causal, int window, float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_k<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  flash_fwd_k<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, h / hkv, qs, ks,
      vs, os, scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, void* o,
               int b, int h, int hkv, int sq, int sk, const long long* st,
               float scale, int causal, int window, float softcap,
               cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, b, h, hkv, sq, sk, st, scale, causal,
                           window, softcap, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, b, h, hkv, sq, sk, st, scale, causal,
                           window, softcap, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, b, h, hkv, sq, sk, st, scale, causal,
                            window, softcap, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. strides: 12 element strides, (b, s, h) of
// q, k, v and o in that order. Returns cudaGetLastError() after the launch
// (0 = launched), or cudaErrorInvalidValue for a dtype, head dim or head
// grouping the kernel does not take.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* o, int dtype, int b, int h, int hkv, int sq,
                        int sk, int d, const long long* strides, float scale,
                        int causal, int window, float softcap, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (hkv <= 0 || h % hkv != 0 || b < 0 || sq < 0 || sk < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (b == 0 || h == 0 || sq == 0) return (int)cudaSuccess;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_d<float>(d, q, k, v, o, b, h, hkv, sq, sk, strides,
                             scale, causal, window, softcap, st);
  }
  if (dtype == 1) {
    return dispatch_d<__nv_bfloat16>(d, q, k, v, o, b, h, hkv, sq, sk,
                                     strides, scale, causal, window, softcap,
                                     st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
