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
// B, C: (b, S, G, N) through their (b, s, g) strides, n contiguous: G
// groups, head h reading group h / (H / G) (G = 1: every head shares
// them, the reference's (b, S, N)). Each group's rows are read by group,
// never expanded to heads. x, B and C are float32 or bfloat16 (all three
// the same), widened to f32 on load as the TPU kernel does. Outputs, both
// contiguous f32: y (b, S, H, P) and the final state (b, H, P, N).
//
// Bound: operations. C B^T is shared by every head (ngroups = 1), so the
// function needs Q(Q+1) N FLOPs per (batch, chunk) for it and
// 2 (Q(Q+1)/2 P + 2 Q N P) per (batch, chunk, head) for the rest, all in
// f32; at the serve path's shape (b 4, S 2048, H 50, P 64, N 16, Q 128)
// that is 5.08 GFLOP against about 160 MB of traffic (mostly the f32 y),
// so the least time is those FLOPs over the card's f32 CUDA-core rate.
// Arithmetic stays f32 on the CUDA cores: the 2e-4 tolerance against the
// chunked form rules out TF32 products, and the largest product (the
// intra-chunk one, Q x Q times Q x P a head) has a decayed f32 left
// operand that bf16 cannot hold exactly.
//
// Design: the Mamba2 chunk-parallel decomposition, three launches behind
// one wrapper call (scratch from the wrapper: C B^T, L, the chunk states
// and the states entering each chunk). dt is folded into the weights
// (xb_s = x_s dt_s enters as x_s times a dt-scaled weight), so x is staged
// as it is, and each CTA issues all its global loads (16 bytes a load
// where rows are aligned; cp.async for the scratch) before its first
// barrier.
//  1. chunk_k, one CTA per (head or group's C B^T, chunk, batch),
//     (H+G) x nc x b: the G extra CTAs of a (batch, chunk) compute each
//     group's C B^T once for all its heads (as the TPU kernel's
//     per-(batch, chunk) program does at G = 1), stored transposed; a head's CTA scans L = cumsum(dt A) in one warp (shuffle
//     scans over 32-step segments), stores it, and computes the chunk's own
//     state S_c = sum_s exp(L_last - L_s) dt_s B_s x_s^T (N x P).
//  2. pass_k, one thread per (batch, head, n, p): walks the chunks in
//     order, h_c = exp(L_last,c) h_{c-1} + S_c, writing the state entering
//     each chunk to its own buffer (in place, each chunk's load would wait
//     behind the last chunk's store), and the final state as (P, N).
//  3. output_k, one CTA of 512 threads per (head, chunk, batch), 3,200 at
//     the serve shape, two an SM (64 registers a thread, all of the SM's
//     shared memory): stages (C B^T o exp(L_t - L_s) dt_s o tril)
//     transposed, x, C transposed and the entering state in shared memory,
//     then each thread owns a 4 (t) x 4 (p) tile of y: per step s one
//     float4 of the decayed C B^T column and one float4 of x feed 16 FMAs,
//     and the loop stops at the tile's last row (the triangle). 512
//     threads with 4 x 4 tiles beat 256 with 8 x 4 by 1.3x in this pass
//     (an H100, `python -m repro_torch.kernels.variants`): more warps
//     hide the staging. exp(L_t - L_s) is
//     taken only for s <= t (above the diagonal it overflows), by
//     ex2.approx (relative error about 2^-22).
// A ragged last chunk is zero-filled (dt = 0, x = B = C = 0), exactly the
// reference's dt = 0 padding: L stays flat and nothing enters the state;
// rows past S are not stored. The chunk is padded to Qp, a multiple of 8
// rows (Qp <= 256, one row a thread where rows are staged). No float
// atomics and a fixed order of every sum: repeat launches are bitwise
// equal.
// What bounds it (an H100, `python -m repro_torch.kernels.variants`): of
// 0.36 ms the output pass takes 0.22 and the chunk pass 0.12, of which
// its state sum 0.05; both spend more on staging short-lived CTAs than on
// their FMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // chunk and state passes
constexpr int kOutThreads = 512;        // output pass
constexpr int kPad = 8;                 // the chunk is padded to kPad rows
constexpr int kTT = 4;                  // rows of y a thread
constexpr int kTP = 4;                  // columns of y a thread
constexpr size_t kMaxSmem = 232448;     // per block on sm_90

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without a register round trip (cp.async)
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// e^x by one MUFU op (ex2.approx.ftz): relative error about 2^-22 over
// the exponents here (<= 0, above -100 or so), far inside the 2e-4 bar
__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

int pad_rows(int q) { return (q + kPad - 1) / kPad * kPad; }

// floats of shared memory of each pass (qp = the padded chunk)
size_t chunk_floats(int qp, int p, int n) {
  const size_t head = 2 * (size_t)qp + (size_t)qp * p + (size_t)qp * n;
  const size_t cb = 2 * (size_t)qp * n;
  return head > cb ? head : cb;
}
size_t output_floats(int qp, int p, int n) {
  return (size_t)qp * qp + (size_t)qp * p + (size_t)n * qp + (size_t)n * p +
         2 * (size_t)qp;
}

struct Dims {
  int S, H, P, N, Q, Qp, nc;
  int G, hpg;                           // B/C groups, heads a group
  int xvec;                             // x's rows 16-byte aligned
  int bcvec;                            // B's and C's rows 16-byte aligned
};

struct Strides {
  long long x_b, x_s, x_h, dt_b, dt_s, dt_h, b_b, b_s, c_b, c_s, b_g, c_g;
};

// x of one (batch, chunk, head) widened into smem [Qp][P]; rows past the
// sequence are 0. Where x's rows are 16-byte aligned (d.xvec) a thread
// loads 16 bytes at a time, four loads in flight before any is used;
// otherwise one element at a time, rows by warp.
template <int NT, typename T>
__device__ void stage_x(const T* __restrict__ x, float* xs, const Dims& d,
                        const Strides& st, int b, int c, int h) {
  constexpr int kWarps = NT / 32;
  const int t0 = c * d.Q;
  const int qe = min(d.Q, d.S - t0);
  const T* xh = x + b * st.x_b + (long long)t0 * st.x_s + h * st.x_h;
  if (d.xvec) {
    constexpr int V = 16 / sizeof(T);   // elements a load
    const int vpr = d.P / V, total = d.Qp * vpr;
    for (int i0 = threadIdx.x; i0 < total; i0 += 4 * NT) {
      uint4 raw[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * NT, t = i / vpr;
        raw[u] = i < total && t < qe
                     ? *reinterpret_cast<const uint4*>(
                           xh + t * st.x_s + (i - t * vpr) * V)
                     : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * NT, t = i / vpr;
        if (i >= total) break;
        const T* e = reinterpret_cast<const T*>(&raw[u]);
        float* dst = xs + t * d.P + (i - t * vpr) * V;
#pragma unroll
        for (int j = 0; j < V; ++j) dst[j] = to_f32(e[j]);
      }
    }
    return;
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll 4
  for (int t = warp; t < d.Qp; t += kWarps) {
    for (int p = lane; p < d.P; p += 32) {
      xs[t * d.P + p] = t < qe ? to_f32(xh[t * st.x_s + p]) : 0.f;
    }
  }
}

// the chunk's rows of B or C (n contiguous) widened into smem, as [Qp][N]
// or transposed [N][Qp]; rows past the sequence are 0. 16-byte loads
// where the rows are aligned (d.bcvec)
template <int NT, typename T>
__device__ void stage_rows(const T* __restrict__ m, long long m_b,
                           long long m_s, float* dst, bool transposed,
                           const Dims& d, int b, int c) {
  const int t0 = c * d.Q;
  const int qe = min(d.Q, d.S - t0);
  const T* mb = m + b * m_b + (long long)t0 * m_s;
  if (d.bcvec) {
    constexpr int V = 16 / sizeof(T);
    const int vpr = d.N / V, total = d.Qp * vpr;
#pragma unroll 2
    for (int i = threadIdx.x; i < total; i += NT) {
      const int t = i / vpr, n0 = (i - t * vpr) * V;
      const uint4 raw = t < qe ? *reinterpret_cast<const uint4*>(
                                     mb + t * m_s + n0)
                               : make_uint4(0, 0, 0, 0);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        dst[transposed ? (n0 + j) * d.Qp + t : t * d.N + n0 + j] =
            to_f32(e[j]);
      }
    }
    return;
  }
  for (int t = threadIdx.x; t < d.Qp; t += NT) {
#pragma unroll 8
    for (int n = 0; n < d.N; ++n) {
      dst[transposed ? n * d.Qp + t : t * d.N + n] =
          t < qe ? to_f32(mb[t * m_s + n]) : 0.f;
    }
  }
}

// dt of the chunk's rows for one head (row tid; Qp <= kThreads)
__device__ __forceinline__ float load_dt(const float* __restrict__ dt,
                                         const Dims& d, const Strides& st,
                                         int b, int c, int h) {
  const int t = threadIdx.x, t0 = c * d.Q;
  return t < min(d.Q, d.S - t0)
             ? dt[b * st.dt_b + (long long)(t0 + t) * st.dt_s + h * st.dt_h]
             : 0.f;
}

// pass 1: a group's C B^T (blockIdx.x >= H) or a head's L and chunk state
// S_c. Every global load of a CTA is issued before its first barrier.
template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_k(const T* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ a, const T* __restrict__ bm,
        const T* __restrict__ cm, float* __restrict__ cbt,
        float* __restrict__ lg, float* __restrict__ hs, Dims d, Strides st) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int Qp = d.Qp, P = d.P, N = d.N;

  if (h >= d.H) {
    // cbt[s][t] = C_t . B_s for s <= t (0 above), once for every head of
    // group g
    const int g = h - d.H;
    float* ct = smem;                   // [N][Qp]  C transposed
    float* bs = ct + N * Qp;            // [Qp][N]
    stage_rows<kThreads>(cm + g * st.c_g, st.c_b, st.c_s, ct, true, d, b, c);
    stage_rows<kThreads>(bm + g * st.b_g, st.b_b, st.b_s, bs, false, d, b, c);
    __syncthreads();
    float* out = cbt + (((long long)b * d.nc + c) * d.G + g) * Qp * Qp;
    for (int s = tid / 32; s < Qp; s += kThreads / 32) {
      for (int t = tid % 32; t < Qp; t += 32) {
        float dot = 0.f;
        if (s <= t) {
          for (int n = 0; n < N; ++n) {
            dot = fmaf(ct[n * Qp + t], bs[s * N + n], dot);
          }
        }
        out[s * Qp + t] = dot;
      }
    }
    return;
  }

  float* dts = smem;                    // [Qp]  dt, then exp(L_last - L) dt
  float* L = dts + Qp;                  // [Qp]
  float* xs = L + Qp;                   // [Qp][P]  x
  float* bw = xs + Qp * P;              // [Qp][N]  B_s exp(L_last - L_s) dt_s
  if (tid < Qp) dts[tid] = load_dt(dt, d, st, b, c, h);
  stage_x<kThreads>(x, xs, d, st, b, c, h);
  stage_rows<kThreads>(bm + h / d.hpg * st.b_g, st.b_b, st.b_s, bw, false, d,
                       b, c);
  __syncthreads();
  if (tid < 32) {                       // L = cumsum(dt A), one warp
    const float ah = a[h];
    float carry = 0.f;
    for (int base = 0; base < Qp; base += 32) {
      const int i = base + tid;
      float v = i < Qp ? dts[i] * ah : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, off);
        if (tid >= off) v += u;
      }
      v += carry;
      if (i < Qp) L[i] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
  const long long row = ((long long)b * d.nc + c) * d.H + h;
  if (tid < Qp) {
    lg[row * Qp + tid] = L[tid];
    dts[tid] *= fast_exp(L[d.Q - 1] - L[tid]);
  }
  __syncthreads();
  for (int i = tid; i < Qp * N; i += kThreads) bw[i] *= dts[i / N];
  __syncthreads();
  float* sc = hs + row * N * P;
  const int P4 = P / kTP;
  for (int task = tid; task < N * P4; task += kThreads) {
    const int n = task / P4, p = task % P4 * kTP;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < Qp; ++s) {
      const float w = bw[s * N + n];
      const float4 xv = *reinterpret_cast<const float4*>(&xs[s * P + p]);
      acc.x = fmaf(w, xv.x, acc.x);
      acc.y = fmaf(w, xv.y, acc.y);
      acc.z = fmaf(w, xv.z, acc.z);
      acc.w = fmaf(w, xv.w, acc.w);
    }
    *reinterpret_cast<float4*>(&sc[n * P + p]) = acc;
  }
}

// pass 2: h_c = exp(L_last,c) h_{c-1} + S_c in chunk order; hin gets the
// state entering chunk c (its own buffer, so the loads of later chunks
// need not wait behind the stores); the last state goes out (P, N)
__global__ void pass_k(const float* __restrict__ hs,
                       const float* __restrict__ lg, float* __restrict__ hin,
                       float* __restrict__ state, int batch, Dims d) {
  const long long per = (long long)d.H * d.N * d.P;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch * per) return;
  const int b = (int)(i / per);
  const int rem = (int)(i % per);
  const int h = rem / (d.N * d.P), np = rem % (d.N * d.P);
  const int n = np / d.P, p = np % d.P;
  float hv = 0.f;
#pragma unroll 4
  for (int c = 0; c < d.nc; ++c) {
    const long long row = ((long long)b * d.nc + c) * d.H + h;
    const float decay = fast_exp(lg[row * d.Qp + d.Q - 1]);
    const float sc = hs[row * d.N * d.P + np];
    hin[row * d.N * d.P + np] = hv;
    hv = hv * decay + sc;
  }
  state[(((long long)b * d.H + h) * d.P + p) * d.N + n] = hv;
}

// pass 3: y of one (head, chunk, batch), a kTT x kTP tile a thread.
// Every global load is issued before the first barrier: C B^T, L and the
// entering state by cp.async, dt, x and C into registers.
template <typename T>
__global__ void __launch_bounds__(kOutThreads)
output_k(const T* __restrict__ x, const float* __restrict__ dt,
         const T* __restrict__ cm, const float* __restrict__ cbt,
         const float* __restrict__ lg, const float* __restrict__ hin,
         float* __restrict__ y, Dims d, Strides st) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int t0 = c * d.Q, qe = min(d.Q, d.S - t0);
  const int Qp = d.Qp, P = d.P, N = d.N;
  float* att = smem;                    // [Qp][Qp]  att[s][t]
  float* xs = att + Qp * Qp;            // [Qp][P]   x
  float* ct = xs + Qp * P;              // [N][Qp]   C transposed
  float* hp = ct + N * Qp;              // [N][P]    state entering chunk c
  float* L = hp + N * P;                // [Qp]
  float* dts = L + Qp;                  // [Qp]

  const long long row = ((long long)b * d.nc + c) * d.H + h;
  const int g = h / d.hpg;
  const float* cb = cbt + (((long long)b * d.nc + c) * d.G + g) * Qp * Qp;
  for (int i = tid * 4; i < Qp * Qp; i += kOutThreads * 4) {
    copy16(&att[i], &cb[i]);
  }
  for (int i = tid * 4; i < Qp; i += kOutThreads * 4) {
    copy16(&L[i], &lg[row * Qp + i]);
  }
  for (int i = tid * 4; i < N * P; i += kOutThreads * 4) {
    copy16(&hp[i], &hin[row * N * P + i]);
  }
  if (tid < Qp) dts[tid] = load_dt(dt, d, st, b, c, h);
  stage_x<kOutThreads>(x, xs, d, st, b, c, h);
  stage_rows<kOutThreads>(cm + g * st.c_g, st.c_b, st.c_s, ct, true, d, b,
                          c);
  copy_wait();
  __syncthreads();
  // att[s][t] = C_t . B_s exp(L_t - L_s) dt_s for s <= t, else 0, in place
#pragma unroll 4
  for (int s = tid / 32; s < Qp; s += kOutThreads / 32) {
    const float ls = L[s], ds = dts[s];
    for (int t = tid % 32; t < Qp; t += 32) {
      const float v = att[s * Qp + t];
      att[s * Qp + t] = s <= t ? v * fast_exp(L[t] - ls) * ds : 0.f;
    }
  }
  __syncthreads();

  const int P4 = P / kTP;
  for (int task = tid; task < Qp / kTT * P4; task += kOutThreads) {
    const int r0 = task / P4 * kTT, p0 = task % P4 * kTP;
    float acc[kTT][kTP], inter[kTT][kTP];
#pragma unroll
    for (int i = 0; i < kTT; ++i) {
#pragma unroll
      for (int j = 0; j < kTP; ++j) acc[i][j] = inter[i][j] = 0.f;
    }
    const int s_end = min(r0 + kTT, qe);
    for (int s = 0; s < s_end; ++s) {
      float av[kTT];
#pragma unroll
      for (int i = 0; i < kTT; i += 4) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(&att[s * Qp + r0 + i]);
        av[i] = v4.x;
        av[i + 1] = v4.y;
        av[i + 2] = v4.z;
        av[i + 3] = v4.w;
      }
      const float4 xv = *reinterpret_cast<const float4*>(&xs[s * P + p0]);
      const float xr[kTP] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int i = 0; i < kTT; ++i) {
#pragma unroll
        for (int j = 0; j < kTP; ++j) {
          acc[i][j] = fmaf(av[i], xr[j], acc[i][j]);
        }
      }
    }
    for (int n = 0; n < N; ++n) {
      float cv[kTT];
#pragma unroll
      for (int i = 0; i < kTT; i += 4) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(&ct[n * Qp + r0 + i]);
        cv[i] = v4.x;
        cv[i + 1] = v4.y;
        cv[i + 2] = v4.z;
        cv[i + 3] = v4.w;
      }
      const float4 hv = *reinterpret_cast<const float4*>(&hp[n * P + p0]);
      const float hr[kTP] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
      for (int i = 0; i < kTT; ++i) {
#pragma unroll
        for (int j = 0; j < kTP; ++j) {
          inter[i][j] = fmaf(cv[i], hr[j], inter[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kTT; ++i) {
      const int t = r0 + i;
      if (t >= qe) break;
      const float el = expf(L[t]);
      float4 out;
      out.x = acc[i][0] + el * inter[i][0];
      out.y = acc[i][1] + el * inter[i][1];
      out.z = acc[i][2] + el * inter[i][2];
      out.w = acc[i][3] + el * inter[i][3];
      *reinterpret_cast<float4*>(
          &y[(((long long)b * d.S + t0 + t) * d.H + h) * P + p0]) = out;
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, void* y, void* state, void* cbt, void* lg,
           void* hs, void* hin, int b, int s, int h, int p, int n, int g,
           int q, const long long* st, cudaStream_t stream) {
  const long long es = sizeof(T);
  auto aligned = [](const void* ptr, long long s0, long long s1,
                    long long s2) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && s0 % 16 == 0 &&
           s1 % 16 == 0 && s2 % 16 == 0;
  };
  const bool xvec = aligned(x, st[0] * es, st[1] * es, st[2] * es) &&
                    p * es % 16 == 0;
  const bool bcvec = aligned(bm, st[6] * es, st[7] * es, n * es) &&
                     aligned(cm, st[8] * es, st[9] * es, n * es) &&
                     st[10] * es % 16 == 0 && st[11] * es % 16 == 0;
  const Dims d{s, h, p, n, q, pad_rows(q), (s + q - 1) / q, g, h / g,
               xvec ? 1 : 0, bcvec ? 1 : 0};
  const Strides ss{st[0], st[1], st[2], st[3], st[4],  st[5],
                   st[6], st[7], st[8], st[9], st[10], st[11]};
  const size_t s1 = chunk_floats(d.Qp, p, n) * sizeof(float);
  const size_t s3 = output_floats(d.Qp, p, n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      chunk_k<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        output_k<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s3);
  }
  // all of the SM's shared memory, so two output CTAs fit on one SM
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(output_k<T>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return (int)err;
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(bm);
  const T* ctp = static_cast<const T*>(cm);
  const float* dtf = static_cast<const float*>(dt);
  float* cbf = static_cast<float*>(cbt);
  float* lgf = static_cast<float*>(lg);
  float* hsf = static_cast<float*>(hs);
  float* hinf = static_cast<float*>(hin);
  if (d.nc > 0) {
    chunk_k<T><<<dim3(h + g, d.nc, b), kThreads, s1, stream>>>(
        xt, dtf, static_cast<const float*>(a), bt, ctp, cbf, lgf, hsf, d, ss);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long total = (long long)b * h * n * p;
  pass_k<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0,
           stream>>>(hsf, lgf, hinf, static_cast<float*>(state), b, d);
  err = cudaGetLastError();
  if (err != cudaSuccess || d.nc == 0) return (int)err;
  output_k<T><<<dim3(h, d.nc, b), kOutThreads, s3, stream>>>(
      xt, dtf, ctp, cbf, lgf, hinf, static_cast<float*>(y), d, ss);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory the largest pass needs (the wrapper
// checks it against the card's limit before a launch).
long long ssd_scan_smem_bytes(int q, int p, int n) {
  const int qp = pad_rows(q);
  const size_t a = chunk_floats(qp, p, n), c = output_floats(qp, p, n);
  return (long long)((a > c ? a : c) * sizeof(float));
}

// dtype: 0 float32, 1 bfloat16 (x, B and C). g: B/C groups, dividing h.
// strides: 12 element strides, x (b, s, h), dt (b, s, h), B (b, s),
// C (b, s), B (g), C (g). q: the chunk length, 1 <= q; p a multiple of 4.
// Scratch, all f32 and contiguous, from the caller: cbt (b, nc, g, Qp, Qp),
// lg (b, nc, H, Qp), hs and hin
// (b, nc, H, N, P) (each chunk's own state, the state entering it), with
// nc = ceil(s / q) and Qp = q rounded up to a multiple of 8. Returns
// cudaGetLastError() after the launches (0 = launched), or
// cudaErrorInvalidValue for a dtype, shape or shared-memory size the
// kernels do not take.
int ssd_scan_fwd(const void* x, const void* dt, const void* a, const void* bm,
                 const void* cm, void* y, void* state, void* cbt, void* lg,
                 void* hs, void* hin, int dtype, int b, int s, int h, int p,
                 int n, int g, int q, const long long* strides, int device,
                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (b < 0 || s < 0 || h < 0 || p <= 0 || p % kTP || n <= 0 || q <= 0 ||
      g <= 0 || h % g ||
      pad_rows(q) > kThreads ||
      (size_t)ssd_scan_smem_bytes(q, p, n) > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  if (b == 0 || h == 0) return (int)cudaSuccess;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(x, dt, a, bm, cm, y, state, cbt, lg, hs, hin, b, s,
                         h, p, n, g, q, strides, st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, dt, a, bm, cm, y, state, cbt, lg, hs,
                                 hin, b, s, h, p, n, g, q, strides, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
