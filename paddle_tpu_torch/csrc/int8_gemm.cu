// W8A8 linear for Hopper (sm_90a): the int8 GEMM of weight-only
// quantized serving.
//
// It replaces no Pallas kernel. The JAX package's weight-only linears
// (paddle_tpu/quantization/runtime.py:134 `Int8WeightOnlyLinear` and
// :209 `Int4WeightOnlyLinear`) compute their product with
// `lax.dot_general(int8, int8 -> int32)` and leave it to XLA. On CUDA,
// `torch.matmul` has no int8 path and `torch._int_mm` needs more than 16
// rows, while a decode tick and every fused or propose window has 8, so
// the exact int32 product is this kernel.
//
// What it computes, in the reference's order (runtime.py:127-141):
//   a_step[t] = max(max_k |x[t, k]|, 1e-8) / 127      (f32)
//   x_q[t, k] = clip(rint(x[t, k] / a_step[t]), -127, 127)   (int8)
//   acc[t, n] = sum_k x_q[t, k] * W_q[k, n]            (int32, exact)
//   out[t, n] = (f32(acc) * a_step[t]) * w_step[n] (+ f32(bias[n]))
// cast to x's dtype (f32 or bf16). The f32 epilogue uses __fmul_rn /
// __fadd_rn, so no multiply-add is contracted into an FMA and the result
// is bit-equal to the plain PyTorch version on the same accumulators.
// W_q is int8 [K, N] (the paddle layout, [in, out]), or packed int4
// [K/2, N] in the split-halves layout of `pack_int4(axis=0)`: packed row
// j holds in-row j in its low nibble and in-row j + K/2 in its high
// nibble. The int4 kernel reads the packed bytes and sign-extends the
// nibbles in registers; no unpacked copy of a weight is ever written.
//
// What bounds it: at the serving shapes (T 8-256 rows, (K, N) of
// gpt_small's qkv / proj / fc1 / fc2) the weight bytes. At T 8 the
// product does 2·T·K·N = 28 Mops on 1.77 MB of qkv weight, 16 ops per
// byte, far below the ~590 int8 ops per byte where the tensor cores
// (1979 dense TOPS) become the limit at 3.35 TB/s; at T 256 it reaches
// about one third of that line. The least time is the weight bytes (half
// of them for int4) plus x and out over 3.35 TB/s.
//
// Design. Two launches from one entry point: `quantize_rows_kernel`, one
// block per row (absmax by shuffles, then the codes and the row's step),
// then `w8a8_gemm_kernel` over 64 x 64 output tiles, 4 warps, each warp
// 32 rows x 32 columns with mma.sync.m16n8k32 (s8 x s8 -> s32) on the
// tensor cores. Both operands stream through a 3-stage cp.async ring of
// 64-deep k tiles in shared memory, x_q row-major and W_q as it lies in
// device memory ([k][n], n contiguous). The mma wants B with its 4 k
// values of one column in one register, so a thread reads four 32-bit
// words from four consecutive k rows (each word 4 adjacent columns) and
// transposes the 4 x 4 bytes with __byte_perm: that gives its B registers
// for 4 n8 tiles at once, the tiles' columns interleaved (tile t, mma
// column c is output column 4c + t of the warp's 32), which the epilogue
// undoes. The int4 kernel stages the packed tile once and two x tiles
// (the low and the high half of k) and runs both halves against it. Rows
// past T are zero-filled and their warps skip the mma. What this simple
// kernel leaves: at T 8 one block column per 64 outputs walks the whole
// K alone (no split-K), and the quantize pass is a launch of its own.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using pt_mma::cp_async16;
using pt_mma::cp_commit;
using pt_mma::cp_wait;
using pt_mma::smem_addr;

constexpr int kBM = 64;        // output rows of a block
constexpr int kBN = 64;        // output columns of a block
constexpr int kBK = 64;        // k (int8) or packed rows (int4) per stage
constexpr int kStages = 3;
constexpr int kThreads = 128;
constexpr int kLD = 64 + 16;   // smem row stride in bytes of both tiles:
                               // conflict-free A fragment loads

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// c += a · b: a 16x32 s8 (row-major fragment), b 32x8 s8 (column-major
// fragment), c 16x8 s32
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the four int4 codes of one nibble half of a packed word (4 bytes),
// sign-extended to 4 int8 bytes: ((n ^ 8) - 8) per byte, no borrow
// across bytes
__device__ __forceinline__ uint32_t nibbles(uint32_t v, bool hi) {
  const uint32_t n = (hi ? v >> 4 : v) & 0x0F0F0F0Fu;
  return __vsub4(n ^ 0x08080808u, 0x08080808u);
}

// 4 x 4 byte transpose: r[i] holds row i's bytes (columns 0..3); after,
// r[c] holds column c's bytes (rows 0..3, row 0 in the low byte)
__device__ __forceinline__ void transpose4(uint32_t (&r)[4]) {
  const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
  r[0] = __byte_perm(lo01, lo23, 0x5410);
  r[1] = __byte_perm(lo01, lo23, 0x7632);
  r[2] = __byte_perm(hi01, hi23, 0x5410);
  r[3] = __byte_perm(hi01, hi23, 0x7632);
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// one block per row: a_step and the int8 codes of x's row
template <typename XT>
__global__ void __launch_bounds__(kThreads)
    quantize_rows_kernel(const XT* __restrict__ x, int8_t* __restrict__ xq,
                         float* __restrict__ a_step, int K) {
  __shared__ float warp_max[kThreads / 32];
  const XT* xr = x + (size_t)blockIdx.x * K;
  float m = 0.f;
  for (int i = threadIdx.x; i < K; i += kThreads)
    m = fmaxf(m, fabsf(to_f(xr[i])));
  for (int o = 16; o; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = fmaxf(fmaxf(warp_max[0], warp_max[1]), fmaxf(warp_max[2], warp_max[3]));
  const float step = __fdiv_rn(fmaxf(m, 1e-8f), 127.0f);
  if (threadIdx.x == 0) a_step[blockIdx.x] = step;
  int8_t* qr = xq + (size_t)blockIdx.x * K;
  for (int i = threadIdx.x; i < K; i += kThreads) {
    const float q = rintf(__fdiv_rn(to_f(xr[i]), step));
    qr[i] = (int8_t)(int)fminf(fmaxf(q, -127.f), 127.f);
  }
}

template <typename OutT, bool kInt4>
__global__ void __launch_bounds__(kThreads)
    w8a8_gemm_kernel(const int8_t* __restrict__ xq,
                     const float* __restrict__ a_step,
                     const int8_t* __restrict__ w,
                     const float* __restrict__ w_step,
                     const OutT* __restrict__ bias, OutT* __restrict__ out,
                     int* __restrict__ acc_out, int T, int K, int N) {
  constexpr int kA = kInt4 ? 2 : 1;   // x tiles a stage: int4, k's halves
  __shared__ __align__(16) int8_t sa[kStages][kA][kBM * kLD];
  __shared__ __align__(16) int8_t sw[kStages][kBK * kLD];
  const int Kp = kInt4 ? K / 2 : K;   // rows of w as stored
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const int nk = (Kp + kBK - 1) / kBK;
  const bool live = m0 + wm * 32 < T;   // warp-uniform: rows past T are 0

  // one stage: 64 x 64 bytes of each tile, 16-byte chunks, zero-filled
  // past T rows, past Kp and past N (K % 16 == 0, N % 16 == 0)
  auto load = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    for (int c = tid; c < kBM * kBK / 16; c += kThreads) {
      const int r = c >> 2, col = (c & 3) * 16;
      const bool ok = m0 + r < T && k0 + col < Kp;
      for (int h = 0; h < kA; ++h) {
        const int8_t* src =
            xq + (ok ? (size_t)(m0 + r) * K + h * Kp + k0 + col : 0);
        cp_async16(smem_addr(&sa[stage][h][r * kLD + col]), src, ok ? 16 : 0);
      }
      const bool okw = k0 + r < Kp && n0 + col < N;
      const int8_t* srcw = w + (okw ? (size_t)(k0 + r) * N + n0 + col : 0);
      cp_async16(smem_addr(&sw[stage][r * kLD + col]), srcw, okw ? 16 : 0);
    }
  };

  int acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][t][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<kStages - 2>();
    __syncthreads();   // stage kt landed; stage kt - 1 is free to refill
    const int pf = kt + kStages - 1;
    if (pf < nk) load(pf % kStages, pf);
    cp_commit();
    if (!live) continue;
    const int st = kt % kStages;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
#pragma unroll
      for (int h = 0; h < kA; ++h) {
        // B registers of the warp's 4 n8 tiles: b[half][t] holds k rows
        // ks + 16·half + 4·tig .. +3 of column wn·32 + 4·g + t
        uint32_t b[2][4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int8_t* p =
              &sw[st][(ks + half * 16 + tig * 4) * kLD + wn * 32 + g * 4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t v = lds32(p + i * kLD);
            b[half][i] = kInt4 ? nibbles(v, h == 1) : v;
          }
          transpose4(b[half]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int rb = wm * 32 + mt * 16;
          if (m0 + rb >= T) continue;
          const int8_t* a = &sa[st][h][(rb + g) * kLD + ks + tig * 4];
          const uint32_t af[4] = {lds32(a), lds32(a + 8 * kLD),
                                  lds32(a + 16), lds32(a + 8 * kLD + 16)};
#pragma unroll
          for (int t = 0; t < 4; ++t) mma_s8(acc[mt][t], af, b[0][t], b[1][t]);
        }
      }
    }
  }
  cp_wait<0>();
  if (!live) return;

  // c[e]: row g (+8 for e >= 2), mma column 2·tig + (e & 1) of tile t,
  // which is output column n0 + wn·32 + 4·(2·tig + (e & 1)) + t
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * 32 + mt * 16 + g + (e >= 2 ? 8 : 0);
        const int col = n0 + wn * 32 + 4 * (2 * tig + (e & 1)) + t;
        if (row >= T || col >= N) continue;
        const size_t i = (size_t)row * N + col;
        const int v = acc[mt][t][e];
        if (acc_out) acc_out[i] = v;
        float o = __fmul_rn(__fmul_rn((float)v, a_step[row]), w_step[col]);
        if (bias) o = __fadd_rn(o, to_f(bias[col]));
        store(out + i, o);
      }
}

template <typename XT>
cudaError_t launch(const void* x, void* xq, void* a_step, const void* w,
                   const void* w_step, const void* bias, void* out,
                   void* acc_out, int T, int K, int N, bool int4,
                   cudaStream_t stream) {
  quantize_rows_kernel<XT><<<T, kThreads, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<int8_t*>(xq),
      static_cast<float*>(a_step), K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (T + kBM - 1) / kBM);
  auto* kern = int4 ? w8a8_gemm_kernel<XT, true> : w8a8_gemm_kernel<XT, false>;
  kern<<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(a_step),
      static_cast<const int8_t*>(w), static_cast<const float*>(w_step),
      static_cast<const XT*>(bias), static_cast<XT*>(out),
      static_cast<int*>(acc_out), T, K, N);
  return cudaGetLastError();
}

}  // namespace

// x [T, K] (f32 or bf16, x_bf16), xq [T, K] int8 and a_step [T] f32
// (scratch the kernel writes), w int8 [K, N] or packed int4 [K/2, N]
// (int4), w_step [N] f32, bias [N] in x's dtype or null, out [T, N] in
// x's dtype, acc_out [T, N] int32 or null (the accumulators, for checks).
// All contiguous and 16-byte aligned; K % 16 == 0 (int4: K % 32 == 0),
// N % 16 == 0. Returns the cudaError of the launches.
extern "C" int pt_w8a8_linear(const void* x, void* xq, void* a_step,
                              const void* w, const void* w_step,
                              const void* bias, void* out, void* acc_out,
                              int T, int K, int N, int x_bf16, int int4,
                              void* stream) {
  if (T <= 0 || K <= 0 || N <= 0 || T > 65535 * kBM || N % 16 != 0 ||
      K % (int4 ? 32 : 16) != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(x_bf16 ? launch<__nv_bfloat16>(x, xq, a_step, w, w_step, bias,
                                              out, acc_out, T, K, N,
                                              int4 != 0, s)
                      : launch<float>(x, xq, a_step, w, w_step, bias, out,
                                      acc_out, T, K, N, int4 != 0, s));
}
