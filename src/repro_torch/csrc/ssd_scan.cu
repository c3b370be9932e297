// K7 chunked Mamba2 SSD scan for Hopper (sm_90a).
//
//   h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T,   y_t = C_t . h_t
//
// computed chunk by chunk: within a chunk of Q steps, with
// L = cumsum(dt A) and xb = x dt,
//   y_t = sum_{s<=t} (C_t . B_s) exp(L_t - L_s) xb_s + exp(L_t) C_t . h
//   h  <- exp(L_last) h + sum_s exp(L_last - L_s) B_s xb_s^T
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py::
// ssd_scan_chunked (_ssd_kernel).
//
// x: (b, S, H, P) read through its (b, s, h) element strides, p contiguous;
// dt: (b, S, H) f32 through its (b, s, h) strides; A: (H,) f32 contiguous;
// B, C: (b, S, N) through their (b, s) strides, n contiguous (ngroups = 1:
// every head shares them). x, B and C are float32 or bfloat16 (all three
// the same), widened to f32 on load as the TPU kernel does. Outputs, both
// contiguous f32: y (b, S, H, P) and the final state (b, H, P, N).
//
// Bound: operations. C B^T is shared by every head (ngroups = 1), so the
// function needs Q(Q+1) N FLOPs per (batch, chunk) for it and
// 2 (Q(Q+1)/2 P + 2 Q N P) per (batch, chunk, head) for the rest, all in
// f32; at the serve path's shape (b 4, S 2048, H 50, P 64, N 16, Q 128)
// that is 5.08 GFLOP against about 160 MB of traffic (mostly the f32 y),
// so the least time is those FLOPs over the card's f32 CUDA-core rate.
// This kernel recomputes C B^T in each head's CTA (50x at that shape).
//
// Design (a simple kernel that is right). Heads are independent, so one
// CTA of 512 threads per (head, batch) walks the chunks in order with its
// state h (N x P f32) in shared memory: 200 CTAs at the serve shape. The
// TPU kernel instead runs one program per (batch, chunk) over all heads
// and carries the state through the sequential grid. Per chunk the CTA
// stages xb = x dt (Q x P), B transposed (N x Q), C (Q x N), dt, L and the
// lower-triangular decayed C B^T matrix (Q x Q) in shared memory, then
// computes y row by row and updates h. exp(L_t - L_s) is evaluated only
// for s <= t, where the exponent is <= 0 (the TPU kernel takes the exp of
// the whole square and masks after; above the diagonal it overflows). A
// ragged last chunk is zero-filled in shared memory (dt = 0, x = 0, B = C
// = 0), which is exactly the reference's dt = 0 padding: L stays flat and
// nothing enters the state; its rows past S are not stored. The final
// state is written transposed to (P, N). Sums run in a fixed order, so
// repeat launches are bitwise equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr size_t kMaxSmem = 232448;     // per block on sm_90

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

size_t smem_floats(int q, int p, int n) {
  return (size_t)q * p + 2 * (size_t)q * n + (size_t)n * p +
         (size_t)q * q + 3 * (size_t)q;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_k(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a, const T* __restrict__ bm,
           const T* __restrict__ cm, float* __restrict__ y,
           float* __restrict__ state, int S, int H, int P, int N, int Q,
           long long x_sb, long long x_ss, long long x_sh, long long dt_sb,
           long long dt_ss, long long dt_sh, long long b_sb, long long b_ss,
           long long c_sb, long long c_ss) {
  extern __shared__ float smem[];
  float* xb = smem;                     // [Q][P]  x * dt
  float* bt = xb + Q * P;               // [N][Q]  B transposed
  float* cs = bt + N * Q;               // [Q][N]
  float* hs = cs + Q * N;               // [N][P]  running state
  float* att = hs + N * P;              // [Q][Q]  (C B^T) * decay, s <= t
  float* dts = att + Q * Q;             // [Q]
  float* L = dts + Q;                   // [Q]     cumsum(dt * A)
  float* w = L + Q;                     // [Q]     exp(L_last - L_s)

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const float ah = a[h];
  const T* xh = x + b * x_sb + h * x_sh;
  const float* dth = dt + b * dt_sb + h * dt_sh;
  const T* bb = bm + b * b_sb;
  const T* cb = cm + b * c_sb;
  float* yh = y + ((long long)b * S * H + h) * P;

  for (int i = tid; i < N * P; i += kThreads) hs[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += Q) {
    const int qe = min(Q, S - t0);
    __syncthreads();            // the last chunk's readers are done
    for (int i = tid; i < Q; i += kThreads) {
      dts[i] = i < qe ? dth[(t0 + i) * dt_ss] : 0.f;
    }
    for (int i = tid; i < Q * N; i += kThreads) {
      const int t = i / N, n = i % N;
      float bv = 0.f, cv = 0.f;
      if (t < qe) {
        bv = to_f32(bb[(t0 + t) * b_ss + n]);
        cv = to_f32(cb[(t0 + t) * c_ss + n]);
      }
      bt[n * Q + t] = bv;
      cs[i] = cv;
    }
    __syncthreads();
    for (int i = tid; i < Q * P; i += kThreads) {
      const int t = i / P, p = i % P;
      xb[i] = t < qe ? to_f32(xh[(t0 + t) * x_ss + p]) * dts[t] : 0.f;
    }
    if (tid == 0) {
      float acc = 0.f;
      for (int t = 0; t < Q; ++t) {
        acc += dts[t] * ah;
        L[t] = acc;
      }
    }
    __syncthreads();
    const float l_last = L[Q - 1];
    for (int i = tid; i < Q; i += kThreads) w[i] = expf(l_last - L[i]);
    for (int i = tid; i < Q * Q; i += kThreads) {
      const int t = i / Q, s = i % Q;
      float val = 0.f;
      if (s <= t) {
        float dot = 0.f;
        for (int n = 0; n < N; ++n) {
          dot = fmaf(cs[t * N + n], bt[n * Q + s], dot);
        }
        val = dot * expf(L[t] - L[s]);
      }
      att[i] = val;
    }
    __syncthreads();
    for (int i = tid; i < Q * P; i += kThreads) {
      const int t = i / P, p = i % P;
      float intra = 0.f;
      for (int s = 0; s <= t; ++s) {
        intra = fmaf(att[t * Q + s], xb[s * P + p], intra);
      }
      float ch = 0.f;
      for (int n = 0; n < N; ++n) ch = fmaf(cs[t * N + n], hs[n * P + p], ch);
      if (t < qe) yh[(long long)(t0 + t) * H * P + p] = intra + expf(L[t]) * ch;
    }
    __syncthreads();
    const float decay = expf(l_last);
    for (int i = tid; i < N * P; i += kThreads) {
      const int n = i / P, p = i % P;
      float delta = 0.f;
      for (int s = 0; s < Q; ++s) {
        delta = fmaf(bt[n * Q + s] * w[s], xb[s * P + p], delta);
      }
      hs[i] = hs[i] * decay + delta;
    }
  }
  __syncthreads();
  for (int i = tid; i < N * P; i += kThreads) {
    const int n = i / P, p = i % P;
    state[(((long long)b * H + h) * P + p) * N + n] = hs[i];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, void* y, void* state, int b, int s, int h, int p,
           int n, int q, const long long* st, cudaStream_t stream) {
  const size_t smem = smem_floats(q, p, n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_k<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(h, b);
  ssd_scan_k<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<float*>(y),
      static_cast<float*>(state), s, h, p, n, q, st[0], st[1], st[2], st[3],
      st[4], st[5], st[6], st[7], st[8], st[9]);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a launch needs (the wrapper checks it
// against the card's limit before a launch).
long long ssd_scan_smem_bytes(int q, int p, int n) {
  return (long long)(smem_floats(q, p, n) * sizeof(float));
}

// dtype: 0 float32, 1 bfloat16 (x, B and C). strides: 10 element strides,
// x (b, s, h), dt (b, s, h), B (b, s), C (b, s). q: the chunk length,
// 1 <= q. Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a dtype, shape or shared-memory size the
// kernel does not take.
int ssd_scan_fwd(const void* x, const void* dt, const void* a, const void* bm,
                 const void* cm, void* y, void* state, int dtype, int b,
                 int s, int h, int p, int n, int q, const long long* strides,
                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b < 0 || s < 0 || h < 0 || p <= 0 || n <= 0 || q <= 0 ||
      smem_floats(q, p, n) * sizeof(float) > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  if (b == 0 || h == 0) return (int)cudaSuccess;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(x, dt, a, bm, cm, y, state, b, s, h, p, n, q,
                         strides, st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, dt, a, bm, cm, y, state, b, s, h, p, n,
                                 q, strides, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
