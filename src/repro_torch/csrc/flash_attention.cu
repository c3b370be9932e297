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
// axes, flash_attention/ops.py:22-24). D in {32, 64, 128, 256}; H a multiple
// of Hkv (G = H / Hkv).
//
// Bound: operations. 4*D FLOPs per visible (query, key) pair; at the serve
// path's shape (B 4, H 25, S 2048, D 64, bf16) a global layer is 53.7
// GFLOP against 63 MB of q/k/v/o, far above the card's ridge, so the
// least time is those FLOPs over the bf16 tensor-core rate.
//
// Two kernels, chosen by the inputs' type (a fixed rule, not a fallback):
//
// bfloat16 -> flash_wgmma_k, on the tensor cores. One CTA of 288 threads
// per (128-row q block, head, batch), the longest q blocks first: two
// consumer warpgroups of 64 query rows each and one producer warp. The
// producer's lane 0 loads the q block once and a 2-stage ring of K and V
// tiles (128 keys, 64 at D >= 128) by TMA into shared memory swizzled as
// wgmma reads it (128-byte rows, 64-byte at D 32; D 128 and 256 as two and
// four 64-column panels), behind full/empty mbarriers. At D 256 a CTA is
// one consumer warpgroup of 64 rows and the producer warp (160 threads):
// its O accumulator is 128 f32 registers a thread, which with S and P
// needs about 220, and ptxas gives a thread of a 288-thread CTA 168 (three
// warps share one SM sub-partition's 16,384 registers) but of a
// 160-thread CTA 255 (two warps). Its shared memory is 32 KiB of Q and a
// 128 KiB ring. Each consumer warpgroup runs, a tile at a time,
//   S = Q K^T        wgmma, bf16 operands from shared memory, f32 sums;
//   online softmax   in registers and f32: scale, accurate tanhf softcap,
//                    running max m and sum l; the scale and log2 e fold
//                    into one FMA before a single-op exp2 (ex2.approx);
//   O += P V         wgmma with P as the register A operand and V read
//                    from shared memory through the transpose flag.
// The TPU kernel multiplies f32 probabilities by the widened v. One bf16
// rounding of P would put the bf16 output about 20x past half a bf16 ulp
// of the f32 result, so P is split into P_hi = bf16(P) and P_lo =
// bf16(P - P_hi) and both go through the tensor cores into the same f32
// O: 1.5x the function's FLOPs, P kept to about 16 significant bits.
// Tiles wholly outside the causal/window band are not loaded; the mask is
// applied only on the edge tiles (keys past Sk, the diagonal, the window's
// far edge). TMA zero-fills rows past Sq and Sk; rows past Sq are not
// stored. Masked scores are -inf, a row's max is taken as 0 while it has
// seen nothing, and o = acc / max(l, 1e-30) as in the TPU kernel, so a row
// with nothing visible gives 0, not NaN or the mean of v. No atomics and
// a fixed order of sums: repeat launches are bitwise equal. TMA needs
// 16-byte-aligned bases and (b, s, h) byte strides; the wrapper checks
// them and raises otherwise.
// What bounds it (an H100, `python -m repro_torch.kernels.variants`): at
// the serve shape it reaches 16-18 % of its bound. Taking the P V
// products out saves 22-25 %, the P_lo half of them 8-12 %, the exp 7-9 %,
// S = Q K^T 2-5 %: no one unit dominates; each warpgroup's serial chain a
// tile (S, wait, softmax, P V, wait) with two warpgroups an SM to hide it
// does. A 3-stage ring, 64-key tiles at two CTAs an SM, and three or four
// consumer warpgroups were no faster (up to 20 % slower). Overlapping S of
// the next tile with the softmax needs a second score buffer, which does
// not fit the 168 registers a thread has at 288 threads: tried, it
// spilled and ran slower (setmaxnreg did not lift ptxas's limit).

// float32 -> flash_fwd_k, on the CUDA cores: the bf16 tensor cores cannot
// hold the 2e-5 float32 tolerance. One CTA of 256 threads per (64-row q
// block, head, batch); 64-key K/V tiles staged through shared memory (at
// D 256, 219,136 bytes of the 232,448 a block may have); a
// thread owns 4 query rows (ty + 16 i) and 4 keys (tx + 16 j) of the
// 64 x 64 score tile and the same rows times D/16 output columns; row max
// and sum go across the 16 tx lanes by shuffles; m, l, the probabilities
// and the accumulator are f32. The same band skipping, masking, clamp and
// fixed order as above.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
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


template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)D * kQtStride + (size_t)D * kKtStride +
                          (size_t)kBK * D + (size_t)kBQ * kPStride);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_k(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ o, int sq, int sk,
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
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  float* ob = o + b * os.b + h * os.h;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int qi = q0 + r;
    qt[d * kQtStride + r] = qi < sq ? qb[qi * qs.s + d] : 0.f;
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
        kv = kb[kj * ks.s + d];
        vv = vb[kj * vs.s + d];
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
      ob[qi * os.s + tx + kTX * c] = acc[i][c] * inv;
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int h, int hkv, int sq, int sk, const long long* st, float scale,
           int causal, int window, float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_k<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  flash_fwd_k<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, sk, h / hkv,
      qs, ks, vs, os, scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

int dispatch_f32(int d, const void* q, const void* k, const void* v,
                 void* o, int b, int h, int hkv, int sq, int sk,
                 const long long* st, float scale, int causal, int window,
                 float softcap, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<32>(q, k, v, o, b, h, hkv, sq, sk, st, scale, causal,
                        window, softcap, stream);
    case 64:
      return launch<64>(q, k, v, o, b, h, hkv, sq, sk, st, scale, causal,
                        window, softcap, stream);
    case 128:
      return launch<128>(q, k, v, o, b, h, hkv, sq, sk, st, scale, causal,
                         window, softcap, stream);
    case 256:
      return launch<256>(q, k, v, o, b, h, hkv, sq, sk, st, scale, causal,
                         window, softcap, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// bfloat16: flash_wgmma_k on the tensor cores
// ---------------------------------------------------------------------------
namespace wg {

constexpr int kBQ = 128;                // query rows a CTA (D < 256)
constexpr int kStages = 2;              // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t n) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(n) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// a phase that never completes is a fault of this kernel: trap after about
// 2^26 polls (seconds) so it surfaces as a launch error, not a hung card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (polls == (1u << 26)) __trap();
  }
}

// a (PW x rows) box of a 4-d map (d, h, s, b) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d, int h, int s,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(d), "r"(h), "r"(s), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor of a tile stored as rows of `sw` bytes
// (64 or 128), swizzled as TMA writes them, 8-row groups `8 sw` apart.
// lbo: 16 for K-major operands (unused there); for the MN-major V tile,
// whose N fits one swizzle row, the same 8-row stride as sbo.
__device__ __forceinline__ uint64_t desc(const void* p, int sw, uint32_t lbo) {
  const uint64_t addr = smem_u32(p);
  const uint64_t sbo = 8u * sw;
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((sbo >> 4) << 32) | ((uint64_t)(sw == 128 ? 1 : 2) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// 2^x in one MUFU op; results below 2^-126 flush to 0 (they are far
// below anything a bf16 output can show)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// keep the compiler from touching wgmma operands before the wait
template <int N>
__device__ __forceinline__ void reg_fence(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// D(64 x 64) (+)= A(64 x 16, smem) . B(64 x 16, smem)^T
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                              uint64_t db, int accum) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accum));
}

// D(64 x 64) = A(64 x 16, smem) . B(64 x 16, smem)^T
__device__ __forceinline__ void wgmma_ss_n64_first(float* d, uint64_t da,
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// D(64 x 128) (+)= A(64 x 16, smem) . B(128 x 16, smem)^T
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                               uint64_t db, int accum) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accum));
}

// D(64 x 128) = A(64 x 16, smem) . B(128 x 16, smem)^T
__device__ __forceinline__ void wgmma_ss_n128_first(float* d, uint64_t da,
                                                     uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// D(64 x 32) += A(64 x 16, registers) . B(16 x 32, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 64) += A(64 x 16, registers) . B(16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
struct Tile {
  static constexpr int PW = D < 64 ? D : 64;    // columns a swizzled panel
  static constexpr int SW = 2 * PW;             // bytes a panel row
  static constexpr int NP = D / PW;             // panels
  // query rows a CTA: 64 at D 256 (one consumer warpgroup; see the top)
  static constexpr int BQ = D == 256 ? 64 : kBQ;
  static constexpr int kConsumers = 2 * BQ;     // a warpgroup per 64 rows
  static constexpr int kThreads = kConsumers + 32;  // + the producer warp
  static constexpr int BK = D >= 128 ? 64 : 128;    // keys a tile
  static constexpr uint32_t kQBytes = BQ * D * 2;
  static constexpr uint32_t kKVBytes = BK * D * 2;  // one K or V tile
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * (2 * kStages + 1);
};

template <int D>
__global__ void __launch_bounds__(Tile<D>::kThreads, 1)
flash_wgmma_k(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap,
              __nv_bfloat16* __restrict__ out, int sq, int sk, int group,
              long long os_b, long long os_s, long long os_h, float scale,
              int causal, int window, float softcap) {
  using T = Tile<D>;
  constexpr int PW = T::PW, SW = T::SW, NP = T::NP, BK = T::BK;
  constexpr int BQ = T::BQ, kConsumers = T::kConsumers;
  constexpr int SN = BK / 2;            // S accumulator floats a thread
  constexpr int ON = D / 2;             // O accumulator floats a thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ks = qs + T::kQBytes;        // [stage][panel][BK][SW]
  uint8_t* vs = ks + kStages * T::kKVBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + kStages * T::kKVBytes);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;    // longest first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  int k_lo = 0, k_hi = sk;
  if (causal) k_hi = min(sk, q0 + BQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  k_lo = (k_lo / BK) * BK;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {              // the producer warp
    if (tid == kConsumers) {
      mbar_expect_tx(qbar, T::kQBytes);
      for (int p = 0; p < NP; ++p) {
        tma_load(qs + p * BQ * SW, &qmap, qbar, p * PW, h, q0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        mbar_wait(&empty[st], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * T::kKVBytes);
        const int k0 = k_lo + i * BK;
        for (int p = 0; p < NP; ++p) {
          tma_load(ks + st * T::kKVBytes + p * BK * SW, &kmap, &full[st],
                   p * PW, hk, k0, b);
          tma_load(vs + st * T::kKVBytes + p * BK * SW, &vmap, &full[st],
                   p * PW, hk, k0, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63; in it,
  // warp w rows 16 w .. + 15, and lane (g, t) rows g and g + 8 of those
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int w_lo = q0 + wg * 64;
  const int row0 = w_lo + warp * 16 + g;
  // exponent factor of a score: scale log2 e, or log2 e once capped
  const float f = softcap > 0.f ? kLog2e : scale * kLog2e;
  const uint8_t* qw = qs + wg * 64 * SW;

  float o[ON], m[2], l[2];
#pragma unroll
  for (int i = 0; i < ON; ++i) o[i] = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  mbar_wait(qbar, 0);

  // S = Q K_i^T into acc, issued and committed
  auto qk = [&](int i, float* acc) {
    const int st = i % kStages;
    const uint8_t* kt = ks + st * T::kKVBytes;
    mbar_wait(&full[st], (i / kStages) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int p = kk * 16 / PW, off = (kk * 16 % PW) * 2;
      const uint64_t da = desc(qw + p * BQ * SW + off, SW, 16);
      const uint64_t db = desc(kt + p * BK * SW + off, SW, 16);
      if constexpr (BK == 128) {
        if (kk == 0) {
          wgmma_ss_n128_first(acc, da, db);
        } else {
          wgmma_ss_n128(acc, da, db, 1);
        }
      } else {
        if (kk == 0) {
          wgmma_ss_n64_first(acc, da, db);
        } else {
          wgmma_ss_n64(acc, da, db, 1);
        }
      }
    }
    wg_commit();
  };

  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = k_lo + i * BK;
    float s[SN];
    qk(i, s);
    wg_wait_all();
    reg_fence<SN>(s);

    // s[4j + e]: row row0 + 8 (e >> 1), key k0 + 8 j + 2 t + (e & 1);
    // scores stay unscaled (or capped) here; the exponent folds the
    // scale and log2 e into one FMA: p = exp2(x f - m f)
    const bool edge = k0 + BK > sk || (causal && k0 + BK - 1 > w_lo) ||
                      (window > 0 && k0 <= w_lo + 63 - window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e];
        if (softcap > 0.f) x = softcap * tanhf(x * scale / softcap);
        if (edge) {
          const int r = row0 + 8 * (e >> 1);
          const int kj = k0 + 8 * j + 2 * t + (e & 1);
          if (kj >= sk || (causal && kj > r) ||
              (window > 0 && kj <= r - window)) {
            x = -INFINITY;
          }
        }
        s[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], mf[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      const float mu = mn == -INFINITY ? 0.f : mn;  // nothing seen: p = 0
      alpha[r] = ex2((m[r] - mu) * f);
      mf[r] = mu * f;
      m[r] = mn;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < SN; ++j) {
      const float p = ex2(fmaf(s[j], f, -mf[(j >> 1) & 1]));
      s[j] = p;
      rs[(j >> 1) & 1] += p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];

#pragma unroll
    for (int j = 0; j < ON; ++j) o[j] *= alpha[(j >> 1) & 1];

    // P as the A operand of k-step kk: register r holds the bf16 pair
    // s[8 kk + 2 r], s[8 kk + 2 r + 1]; P = P_hi + P_lo
    uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float a = s[8 * kk + 2 * r], c = s[8 * kk + 2 * r + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(a, c);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(
            a - __low2float(hi), c - __high2float(hi));
        ph[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
        pl[kk][r] = *reinterpret_cast<const uint32_t*>(&lo);
      }
    }
    const uint8_t* vt = vs + (i % kStages) * T::kKVBytes;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const uint64_t db = desc(vt + p * BK * SW + kk * 16 * SW, SW, 8 * SW);
        if constexpr (PW == 64) {
          wgmma_rs_n64(o + 32 * p, ph[kk], db);
          wgmma_rs_n64(o + 32 * p, pl[kk], db);
        } else {
          wgmma_rs_n32(o, ph[kk], db);
          wgmma_rs_n32(o, pl[kk], db);
        }
      }
    }
    wg_commit();
    wg_wait_all();
    reg_fence<ON>(o);
    reg_fence<BK / 4>(&ph[0][0]);
    reg_fence<BK / 4>(&pl[0][0]);
    mbar_arrive(&empty[i % kStages]);
  }

  // o[4j + e]: row row0 + 8 (e >> 1), column 8 j + 2 t + (e & 1)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = out + b * os_b + row * os_s + h * os_h + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                o[4 * j + 2 * r + 1] * inv);
    }
  }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time: no -lcuda at link time
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &got) == cudaSuccess &&
        got == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// the (d, h, s, b) view of a (B, S, H, D) bf16 tensor with element strides
// st = (b, s, h), read in boxes of pw columns x rows rows of one head
bool make_map(CUtensorMap* map, const void* ptr, int d, int h, int s, int b,
              const long long* st, int pw, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)s,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {(cuuint32_t)pw, 1, (cuuint32_t)rows, 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  EncodeTiled fn = encode_tiled();
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
            pw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int h, int hkv, int sq, int sk, const long long* st, float scale,
           int causal, int window, float softcap, cudaStream_t stream) {
  using T = Tile<D>;
  CUtensorMap qmap, kmap, vmap;
  // Sk = 0 loads nothing; the maps only need a valid extent
  if (!make_map(&qmap, q, D, h, sq, b, st, T::PW, T::BQ) ||
      !make_map(&kmap, k, D, hkv, sk > 0 ? sk : 1, b, st + 3, T::PW, T::BK) ||
      !make_map(&vmap, v, D, hkv, sk > 0 ? sk : 1, b, st + 6, T::PW, T::BK)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_k<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)T::kSmem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_wgmma_k<D>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  }
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + T::BQ - 1) / T::BQ, h, b);
  flash_wgmma_k<D><<<grid, T::kThreads, T::kSmem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), sq, sk, h / hkv,
      st[9], st[10], st[11], scale, causal, window, softcap);
  return (int)cudaGetLastError();
}

}  // namespace wg

extern "C" {

// The common checks of both entry points; 0 = launch, -1 = nothing to do.
static int prepare(int b, int h, int hkv, int sq, int sk, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (hkv <= 0 || h % hkv != 0 || b < 0 || sq < 0 || sk < 0) {
    return (int)cudaErrorInvalidValue;
  }
  return b == 0 || h == 0 || sq == 0 ? -1 : 0;
}

// float32 q, k, v, o on the CUDA cores. strides: 12 element strides,
// (b, s, h) of q, k, v and o in that order. Returns cudaGetLastError()
// after the launch (0 = launched), or cudaErrorInvalidValue for a head dim
// or head grouping the kernel does not take.
int flash_attention_f32_fwd(const void* q, const void* k, const void* v,
                            void* o, int b, int h, int hkv, int sq, int sk,
                            int d, const long long* strides, float scale,
                            int causal, int window, float softcap, int device,
                            void* stream) {
  const int ready = prepare(b, h, hkv, sq, sk, device);
  if (ready != 0) return ready < 0 ? (int)cudaSuccess : ready;
  return dispatch_f32(d, q, k, v, o, b, h, hkv, sq, sk, strides, scale,
                      causal, window, softcap,
                      reinterpret_cast<cudaStream_t>(stream));
}

// bfloat16 q, k, v, o on the tensor cores (wgmma, TMA). The same
// arguments; q, k and v need 16-byte-aligned bases and (b, s, h) strides
// of a multiple of 8 elements (the TMA maps), which the wrapper checks.
// Returns cudaErrorInvalidValue where a map cannot be encoded.
int flash_attention_bf16_fwd(const void* q, const void* k, const void* v,
                             void* o, int b, int h, int hkv, int sq, int sk,
                             int d, const long long* strides, float scale,
                             int causal, int window, float softcap,
                             int device, void* stream) {
  const int ready = prepare(b, h, hkv, sq, sk, device);
  if (ready != 0) return ready < 0 ? (int)cudaSuccess : ready;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return wg::launch<32>(q, k, v, o, b, h, hkv, sq, sk, strides, scale,
                            causal, window, softcap, st);
    case 64:
      return wg::launch<64>(q, k, v, o, b, h, hkv, sq, sk, strides, scale,
                            causal, window, softcap, st);
    case 128:
      return wg::launch<128>(q, k, v, o, b, h, hkv, sq, sk, strides, scale,
                             causal, window, softcap, st);
    case 256:
      return wg::launch<256>(q, k, v, o, b, h, hkv, sq, sk, strides, scale,
                             causal, window, softcap, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
