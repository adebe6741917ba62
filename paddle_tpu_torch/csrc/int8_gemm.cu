// W8A8 linear for Hopper (sm_90a): the int8 GEMM of weight-only
// quantized serving, the activation quantize included.
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
//   a_step[t] = max(max_k |x[t, k]|, 1e-8) / 127      (f32, __fdiv_rn)
//   x_q[t, k] = clip(rint(x[t, k] / a_step[t]), -127, 127)   (int8)
//   acc[t, n] = sum_k x_q[t, k] * W_q[k, n]            (int32, exact)
//   out[t, n] = (f32(acc) * a_step[t]) * w_step[n] (+ f32(bias[n]))
// cast to x's dtype (f32 or bf16). The codes are those of the correctly
// rounded quotient (`quantize16`: a multiply by 1 / step, and __fdiv_rn
// where the product lies near a half-integer); the f32 epilogue uses
// __fmul_rn / __fadd_rn, so no multiply-add is contracted into an FMA and
// the result is bit-equal to the plain PyTorch version on the same
// accumulators. W_q is int8 [K, N] (the paddle layout, [in, out]), or
// packed int4 [K/2, N] in the split-halves layout of `pack_int4(axis=0)`:
// packed row j holds in-row j in its low nibble and in-row j + K/2 in its
// high nibble, so a range of packed rows meets two slices of x. The
// nibbles are sign-extended in registers; no unpacked weight is written.
//
// What bounds it. 2·T·K·N operations on K·N weight bytes (K·N/2 for
// int4) are 2T (4T) operations a byte, and the card turns from bytes to
// operations at 1979 TOPS / 3.35 TB/s ≈ 590 a byte: T ≈ 295 for int8
// weights, ≈ 148 for int4. Every serving shape (T 1-48: decode ticks,
// fused windows, the fleet's budget; T 256: the mixed tick; gpt_small's
// qkv / proj / fc1 / fc2) is bound by its weight bytes, 0.2-0.7 µs at
// 3.35 TB/s, which is below one launch's latency. So what the card can
// reach at T <= 48 is set by latency: the launch, one round trip to
// device memory with enough bytes in flight, and the barriers between
// the activation's absmax and the epilogue.
//
// What the kernel's first, simple version left, and what this design does
// about it:
// 1. Too few blocks at T 8 (one per 64 columns, each walking all of K):
//    split-K across a thread-block cluster. The planner
//    (ops/cuda_kernels/int8_gemm.py `plan`) cuts the weight's rows into
//    S <= 8 ranges of whole 32-row steps, S the fewest that give at least
//    132 blocks (one per SM) where the shape allows it; the S blocks of a
//    tile are one cluster. Each block reduces its k-range; the partial
//    tiles meet by token row in the owner rank's shared memory (plain
//    stores to distributed shared memory, `to_owner`; the wide route
//    moves whole 16-byte pieces) and each rank writes the rows it owns.
//    Int32 sums are associative, so the result is exact in any order.
//    Nothing lives in device memory between launches — no workspace, no
//    counter — so a CUDA graph replays the kernel as it is and replicas
//    on two streams share nothing.
// 2. A 64-row tile for 8 rows: the operands are swapped. The weight's
//    out-features are the 16-row side of mma.sync.m16n8k32 and the tokens
//    its n8 side, so one n8 tile is a whole decode tick; a tile past T is
//    skipped, warp-uniformly, and no mma runs on rows that are only
//    zeros. W_q lies [k][n] and the mma wants 4 k values of one
//    out-feature in a register, so a thread reads four 32-bit words from
//    four k rows and transposes the 4 x 4 bytes with __byte_perm (columns
//    4g + 0 / 1 go to the row halves of one m16 tile, 4g + 2 / 3 to the
//    other's). A stage's rows sit permuted within each 16 (row r at
//    4·(r % 4) + r / 4), which makes those reads free of bank conflicts.
// 3. The quantize was a launch of its own. Decode route (T <= 16, one
//    launch, `w8a8_gemm_kernel`): each warp reads its rows of x whole,
//    takes the absmax with shuffles and quantizes its block's k-range
//    from the same registers into shared memory; x is 16 rows, so every
//    block reads it rather than waiting on a cluster exchange. Wide route
//    (T > 16, `quantize_rows_kernel` + `w8a8_gemm_wide_kernel`): a block
//    a row quantizes x once into device memory, and the GEMM is launched
//    under programmatic dependent launch — it streams its first weight
//    stages and waits (griddepcontrol.wait) only before the codes. At 17
//    rows and more, re-quantizing in every column tile cost more than the
//    second launch.
// 4. Bytes in flight: weights move with cp.async (16 bytes, L2 only) —
//    decode: a ring of 4 one-KB stages for each of 8 warps, 32 KB a block,
//    issued before the absmax waits on x; wide: a ring of 6 stages of
//    weights (4 KB) and the 64 tokens' codes a block. Decode warps split
//    the block's steps and add their partials in shared memory; wide
//    warps each own 32 columns x 32 tokens.
// 5. Host cost per call: the launcher checks a weight once (`prepare`,
//    kept by the module) and per call only x and the bias; the kernel
//    writes codes and steps to device memory only when asked (checks) or
//    on the wide route, whose buffers between its launches they are.
// mma.sync, not wgmma: wgmma takes 8-bit operands K-major from shared
// memory, and W_q is stored [in, out] (out contiguous), as the reference
// and `state_dict()` carry it; a second, repacked device copy would undo
// the weight bytes that quantization saves. At these shapes the tensor
// cores are not the limit (T 8 asks for well under 1 % of their rate).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

using pt_mma::cp_async16;
using pt_mma::cp_commit;
using pt_mma::cp_wait;
using pt_mma::smem_addr;

// the layout below is mirrored by the planner (int8_gemm.py): keep the
// two in step
constexpr int kStepRows = 32;      // weight rows (as stored) of a step
constexpr int kWarpCols = 32;      // output columns of a warp
constexpr int kStageBytes = kStepRows * kWarpCols;   // a warp's step
constexpr int kMaxSplits = 8;      // a portable cluster
// decode route (T <= kDecodeRows): 8 warps split a block's steps
constexpr int kDecodeRows = 16;
constexpr int kDecodeThreads = 256;
constexpr int kDecodeWarps = kDecodeThreads / 32;
constexpr int kWarpStages = 4;     // cp.async ring depth of each warp
constexpr int kCodePad = 16;       // pad of a code row: conflict-free B reads
// wide route: 8 warps take 32 columns and 32 tokens each of a tile of
// 128 columns and 64 tokens
constexpr int kWideRows = 64;
constexpr int kWideCols = 128;
constexpr int kWideThreads = 256;
constexpr int kWideColWarps = kWideCols / kWarpCols;   // 4 column slices
constexpr int kWideWarpRows =                          // 32 tokens a warp
    kWideRows * kWideColWarps / (kWideThreads / 32);
constexpr int kWideStages = 6;     // cp.async ring depth of the block
constexpr int kCodeLd = 48;        // a token's 32 codes of a step, padded
// the row quantize ahead of the wide route: one block a row
constexpr int kQuantThreads = 128;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 16 bytes of x (raw) as f32: 4 floats, or 8 bf16
__device__ __forceinline__ void to_floats(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x); f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z); f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void to_floats(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ float absmax16(const uint4& v, float m,
                                          const float*) {
  float f[4];
  to_floats(v, f);
#pragma unroll
  for (int i = 0; i < 4; ++i) m = fmaxf(m, fabsf(f[i]));
  return m;
}
__device__ __forceinline__ float absmax16(const uint4& v, float m,
                                          const __nv_bfloat16*) {
  float f[8];
  to_floats(v, f);
#pragma unroll
  for (int i = 0; i < 8; ++i) m = fmaxf(m, fabsf(f[i]));
  return m;
}

__device__ __forceinline__ float row_step(float absmax) {
  return __fdiv_rn(fmaxf(absmax, 1e-8f), 127.0f);
}

// the correctly rounded quotient's integer, out of line: the rare path
// of `quantize`, kept out of its unrolled copies
__device__ __noinline__ float exact_code(float v, float step) {
  return rintf(__fdiv_rn(v, step));
}

// x · (1 / step) near a half-integer: its rint may differ from the
// correctly rounded quotient's
__device__ __forceinline__ bool near_half(float y) {
  return fabsf(fabsf(y - rintf(y)) - 0.5f) < 0x1p-10f;
}

// the codes of 16 bytes of x, packed (8 bytes for bf16, 4 for f32): rint
// of the correctly rounded x / step, clipped to ±127. With `inv` within
// 2 ulps of 1 / step, x · inv lies within 2^-14 of x / step (|x / step|
// <= 127), so both round to the same integer unless the product is near
// a half-integer; there (a few in a thousand) the quotient is taken
// with __fdiv_rn.
template <typename XT>
__device__ __forceinline__ uint2 quantize16(const uint4& v, float step,
                                            float inv) {
  constexpr int kVec = 16 / sizeof(XT);
  float f[kVec], r[kVec];
  to_floats(v, f);
  bool near = false;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const float y = __fmul_rn(f[i], inv);
    r[i] = rintf(y);
    near |= near_half(y);
  }
  if (near) {
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      if (near_half(__fmul_rn(f[i], inv))) r[i] = exact_code(f[i], step);
  }
  uint32_t q[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    q[i / 4] |= (uint32_t)(uint8_t)(int8_t)(int)fminf(fmaxf(r[i], -127.f),
                                                     127.f)
                << (8 * (i % 4));
  return make_uint2(q[0], q[1]);
}

template <typename XT>
__device__ __forceinline__ void store_codes(int8_t* dst, uint2 q) {
  if (sizeof(XT) == 2)
    *reinterpret_cast<uint2*>(dst) = q;
  else
    *reinterpret_cast<uint32_t*>(dst) = q.x;
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

// the slot of a step's row r in its stage: within each 16 rows, row r
// sits at 4·(r % 4) + r / 4, so the rows 4·tig + i that one read of the
// transpose touches (tig = 0..3) fall in four different bank groups
__device__ __forceinline__ int row_slot(int r) {
  return (r & 16) | ((r & 3) << 2) | ((r >> 2) & 3);
}

// one step's weight tile (32 stored rows x the block's 32 columns from
// n0) into a stage, 16-byte chunks c = first, first + stride, ... < 64;
// rows past Kp are zero-filled
__device__ __forceinline__ void load_weights(int8_t* dst,
                                             const int8_t* __restrict__ w,
                                             int r0, int n0, int Kp, int N,
                                             int first, int stride) {
  for (int c = first; c < kStageBytes / 16; c += stride) {
    const int r = c >> 1, col = (c & 1) * 16;
    const bool ok = r0 + r < Kp && n0 + col < N;
    const int8_t* src = w + (ok ? (size_t)(r0 + r) * N + n0 + col : 0);
    cp_async16(smem_addr(dst + row_slot(r) * kWarpCols + col), src,
               ok ? 16 : 0);
  }
}

// A fragments of one step from a stage: two m16 tiles (x: columns
// 4g + 0 / 1, y: 4g + 2 / 3 on the row halves) of 32 k each, for
// nibble half h of a packed int4 stage
template <bool kInt4>
__device__ __forceinline__ void a_fragments(const int8_t* st, int g, int tig,
                                            int h, uint32_t (&ax)[4],
                                            uint32_t (&ay)[4]) {
  uint32_t a0[4], a1[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    // rows 4·tig + q and 16 + 4·tig + q sit at slots 4q + tig (+ 16)
    const uint32_t v0 = lds32(st + (4 * q + tig) * kWarpCols + 4 * g);
    const uint32_t v1 = lds32(st + (16 + 4 * q + tig) * kWarpCols + 4 * g);
    a0[q] = kInt4 ? nibbles(v0, h == 1) : v0;
    a1[q] = kInt4 ? nibbles(v1, h == 1) : v1;
  }
  transpose4(a0);   // a0[c]: column 4g + c, k rows 4·tig .. + 3
  transpose4(a1);   // a1[c]: column 4g + c, k rows 16 + 4·tig .. + 3
  ax[0] = a0[0]; ax[1] = a0[1]; ax[2] = a1[0]; ax[3] = a1[1];
  ay[0] = a0[2]; ay[1] = a0[3]; ay[2] = a1[2]; ay[3] = a1[3];
}

// the cluster barrier in two halves: arrive early (nothing to publish
// yet), wait where the other ranks' shared memory is first touched
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The cluster's partial tiles meet by token row: row t of a tile (kCols
// columns) belongs to rank t % S, and every rank stores its partial of
// the row into its own slot on the owner (plain stores to distributed
// shared memory: no atomics, nothing to zero first); after a barrier
// the owner adds its S slots. Slots: [S][ceil(rows / S)][kCols] int32.
template <int kCols>
__device__ __forceinline__ void to_owner(cg::cluster_group& cluster,
                                         int* slots, int t, int col, int v,
                                         int rank, int S, int rpo) {
  *cluster.map_shared_rank(slots + ((rank * rpo + t / S) * kCols + col),
                           t % S) = v;
}

// the epilogue of the rows this rank owns (t = rank + S·lr < T), its
// slots added up
template <typename XT, int kThreads, int kCols>
__device__ __forceinline__ void epilogue(const int* slots,
                                         const float* steps_s,
                                         const float* ws_s, const XT* bias_s,
                                         XT* __restrict__ out,
                                         int* __restrict__ acc_out, int rank,
                                         int S, int rpo, int tid, int m0,
                                         int nb, int rows, int T, int N) {
  for (int e = tid; e < rpo * kCols; e += kThreads) {
    const int lr = e / kCols, col = e % kCols;
    const int t = rank + S * lr, n = nb + col;
    if (t >= rows || m0 + t >= T || n >= N) continue;
    int acc = 0;
    for (int q = 0; q < S; ++q) acc += slots[(q * rpo + lr) * kCols + col];
    const size_t o = (size_t)(m0 + t) * N + n;
    if (acc_out) acc_out[o] = acc;
    float v = __fmul_rn(__fmul_rn((float)acc, steps_s[t]), ws_s[col]);
    if (bias_s) v = __fadd_rn(v, to_f(bias_s[col]));
    store(out + o, v);
  }
}

// the block's columns' w_step and bias into shared memory with
// cp.async at the start (in the issuing threads' first group): the
// epilogue reads them without a round trip, and nothing waits on them
template <typename XT, int kCols>
__device__ __forceinline__ void column_params(
    const float* __restrict__ w_step, const XT* __restrict__ bias,
    float* ws_s, XT* bias_s, int nb, int N, int tid) {
  constexpr int kW = kCols * 4 / 16, kB = kCols * sizeof(XT) / 16;
  constexpr int kPer = 16 / sizeof(XT);
  if (tid < kW) {
    const bool ok = nb + 4 * tid < N;
    cp_async16(smem_addr(ws_s + 4 * tid), w_step + (ok ? nb + 4 * tid : 0),
               ok ? 16 : 0);
  } else if (bias != nullptr && tid < kW + kB) {
    const int c = (tid - kW) * kPer;
    const bool ok = nb + c < N;
    cp_async16(smem_addr(bias_s + c), bias + (ok ? nb + c : 0), ok ? 16 : 0);
  }
}

// dynamic shared memory of a block, in bytes (int8_gemm.py `_smem`)
__host__ __device__ constexpr int code_stride(int per, bool int4) {
  return (int4 ? 2 : 1) * per * kStepRows + kCodePad;
}
__host__ __device__ constexpr int decode_smem(int per, bool int4) {
  return kDecodeWarps * kWarpStages * kStageBytes        // weight rings
         + (kDecodeRows + kMaxSplits) * kWarpCols * 4    // partial slots
         + kDecodeRows * code_stride(per, int4)          // x codes
         + kDecodeRows * 4                               // steps
         + kWarpCols * 4 * 2;                            // w_step, bias
}
__host__ __device__ constexpr int wide_stage(bool int4) {
  return kWideCols * kStepRows + (int4 ? 2 : 1) * kWideRows * kCodeLd;
}
__host__ __device__ constexpr int wide_smem(bool int4) {
  return kWideStages * wide_stage(int4)                  // weights, codes
         + (kWideRows + kMaxSplits) * kWideCols * 4      // partial slots
         + kWideRows * 4                                 // steps
         + kWideCols * 4 * 2;                            // w_step, bias
}

// ---------------------------------------------------------------------
// decode route, T <= 16: grid (S, column tiles, 1), clusters of
// (S, 1, 1). Each block takes its rows' absmax over the whole K (x is
// small: 16 rows), quantizes the x columns of its k-range into shared
// memory, and its 8 warps split the range's steps (s0 + warp, + 8, ...),
// each through its own cp.async ring; the warps' partials are added in
// shared memory, and the cluster's meet by token row (`to_owner`).
template <typename XT, bool kInt4>
__global__ void __launch_bounds__(kDecodeThreads)
    w8a8_gemm_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ w_step,
                     const XT* __restrict__ bias, XT* __restrict__ out,
                     int8_t* __restrict__ codes_out,
                     float* __restrict__ a_step_out,
                     int* __restrict__ acc_out, int T, int K, int N,
                     int per) {
  constexpr int kH = kInt4 ? 2 : 1;    // x slices a step meets
  constexpr int kVec = 16 / sizeof(XT);
  constexpr int kV = 12;               // x vectors a lane loads at once
  extern __shared__ __align__(16) int8_t smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int S = gridDim.x;
  const int rank = blockIdx.x;
  const int Kp = kInt4 ? K / 2 : K;    // weight rows as stored
  const int steps = (Kp + kStepRows - 1) / kStepRows;
  const int s0 = rank * per, s1 = min(s0 + per, steps);
  const int k0 = s0 * kStepRows;                   // first stored row
  const int span = (s1 - s0) * kStepRows;          // rows of this range
  const int cw = per * kStepRows;                  // code columns a half
  const int ldx = code_stride(per, kInt4);
  const int nb = blockIdx.y * kWarpCols;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;

  int8_t* ring = smem + warp * kWarpStages * kStageBytes;
  int* slots = reinterpret_cast<int*>(smem + kDecodeWarps * kWarpStages *
                                                 kStageBytes);
  int8_t* codes = reinterpret_cast<int8_t*>(
      slots + (kDecodeRows + kMaxSplits) * kWarpCols);
  float* steps_s = reinterpret_cast<float*>(codes + kDecodeRows * ldx);
  float* ws_s = steps_s + kDecodeRows;
  XT* bias_s = reinterpret_cast<XT*>(ws_s + kWarpCols);

  // rows warp and warp + 8, one after the other; each lane kV of a row's
  // K / kVec vectors at once, row warp's before the weights: the
  // quantize waits on x, the mma loop on the weights
  const int vrow = K / kVec;
  uint4 raw[kV];
  auto x_row = [&](int r, int v0) {
#pragma unroll
    for (int b = 0; b < kV; ++b)
      if (r < T && v0 + 32 * b < vrow)
        raw[b] = *reinterpret_cast<const uint4*>(x + (size_t)r * K +
                                                 (v0 + 32 * b) * kVec);
  };
  x_row(warp, lane);
  column_params<XT, kWarpCols>(w_step, bias, ws_s, bias_s, nb, N, tid);

  const int nsw =
      s1 - s0 > warp ? (s1 - s0 - warp + kDecodeWarps - 1) / kDecodeWarps : 0;
#pragma unroll
  for (int i = 0; i < kWarpStages; ++i) {
    if (i < nsw)
      load_weights(ring + i * kStageBytes, w,
                   (s0 + warp + i * kDecodeWarps) * kStepRows, nb, Kp, N,
                   lane, 32);
    cp_commit();
  }
  // the cluster's first barrier phase: every rank has started by the
  // time it completes (waited on before the first remote store)
  cluster_arrive_relaxed();

  // 1. rows warp and warp + 8, each by its warp alone: the absmax over
  // all of K, the step (every lane has it after the shuffles), then the
  // codes of this block's columns. A row of at most 32·kV vectors stays
  // in the lanes' registers from the absmax to the codes; a longer one
  // is read again. The warp's code rows start at 0: rows past T and the
  // tail of the last range stay so.
  const bool emit = codes_out != nullptr && blockIdx.y == 0;
  const int live_cols = min(span, Kp - k0);
  const bool held = vrow <= 32 * kV;
  // x's columns k .. k + kVec - 1 → their code column, or -1 outside
  // this block's range (for int4, x's second half meets the high nibbles)
  auto code_col = [&](int k) {
    const int h = (kH == 2 && k >= Kp) ? 1 : 0;
    const int c = k - h * Kp - k0;
    return c >= 0 && c < live_cols ? h * cw + c : -1;
  };
  auto put = [&](int r, int k, float step, float inv, const uint4& xv) {
    const int cc = k < K ? code_col(k) : -1;
    if (cc < 0) return;
    const uint2 q = quantize16<XT>(xv, step, inv);
    store_codes<XT>(codes + r * ldx + cc, q);
    if (emit) store_codes<XT>(codes_out + (size_t)r * K + k, q);
  };
#pragma unroll
  for (int a = 0; a < 2; ++a)
    for (int c = 16 * lane; c < ldx; c += 32 * 16)
      *reinterpret_cast<uint4*>(codes + (warp + kDecodeWarps * a) * ldx +
                                c) = make_uint4(0, 0, 0, 0);
  __syncwarp();
  for (int a = 0; a < 2; ++a) {
    const int r = warp + kDecodeWarps * a;
    if (r >= T) break;   // warp-uniform
    float m = 0.f;
    for (int v0 = lane; v0 < vrow; v0 += 32 * kV) {
      if (a > 0 || v0 != lane) x_row(r, v0);
#pragma unroll
      for (int b = 0; b < kV; ++b)
        if (v0 + 32 * b < vrow) m = absmax16(raw[b], m, x);
    }
#pragma unroll
    for (int o = 16; o; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float step = row_step(m), inv = __fdividef(1.0f, step);
    if (lane == 0) {
      steps_s[r] = step;
      if (a_step_out && blockIdx.y == 0 && rank == 0) a_step_out[r] = step;
    }
    for (int v0 = lane; v0 < vrow; v0 += 32 * kV) {
      if (!held) x_row(r, v0);
#pragma unroll
      for (int b = 0; b < kV; ++b)
        put(r, (v0 + 32 * b) * kVec, step, inv, raw[b]);
    }
  }
  __syncthreads();

  // 2. the warp's steps through its ring: A = W^T from the stage, B =
  // the codes of each live n8 token tile
  int accx[2][4], accy[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) accx[j][e] = accy[j][e] = 0;
  for (int i = 0; i < nsw; ++i) {
    cp_wait<kWarpStages - 1>();
    __syncwarp();
    const int slot = i % kWarpStages;
    const int8_t* st = ring + slot * kStageBytes;
    const int kb = (warp + i * kDecodeWarps) * kStepRows;
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      uint32_t ax[4], ay[4];
      a_fragments<kInt4>(st, g, tig, h, ax, ay);
      const int8_t* cb = codes + g * ldx + h * cw + kb + 4 * tig;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (8 * j >= T) break;   // warp-uniform: no all-zero tile
        const uint32_t b0 = lds32(cb + 8 * j * ldx);
        const uint32_t b1 = lds32(cb + 8 * j * ldx + 16);
        mma_s8(accx[j], ax, b0, b1);
        mma_s8(accy[j], ay, b0, b1);
      }
    }
    __syncwarp();   // every lane has read the slot before it is refilled
    if (i + kWarpStages < nsw)
      load_weights(ring + slot * kStageBytes, w,
                   (s0 + warp + (i + kWarpStages) * kDecodeWarps) *
                       kStepRows,
                   nb, Kp, N, lane, 32);
    cp_commit();
  }
  cp_wait<0>();
  __syncthreads();   // the rings are free: the warps' partials go there

  // 3. the warps' partials, [warp][token][column], added up by entry and
  // stored into the owner ranks' slots (c[e]: token 8j + 2·tig + (e & 1)
  // of column 4g + (e >> 1), x tile, or 4g + 2 + (e >> 1), y tile)
  int* red = reinterpret_cast<int*>(smem);
  if (nsw > 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (8 * j >= T) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ix = (8 * j + 2 * tig + (e & 1)) * kWarpCols + 4 * g +
                       (e >> 1);
        red[warp * kDecodeRows * kWarpCols + ix] = accx[j][e];
        red[warp * kDecodeRows * kWarpCols + ix + 2] = accy[j][e];
      }
    }
  }
  __syncthreads();
  const int rpo = (kDecodeRows + S - 1) / S;       // rows an owner holds
  const int busy = min(s1 - s0, kDecodeWarps);     // warps with steps
  cluster_wait();
  for (int e = tid; e < min(T, kDecodeRows) * kWarpCols;
       e += kDecodeThreads) {
    int v = 0;
    for (int q = 0; q < busy; ++q) v += red[q * kDecodeRows * kWarpCols + e];
    to_owner<kWarpCols>(cluster, slots, e / kWarpCols, e % kWarpCols, v,
                        rank, S, rpo);
  }
  cluster.sync();   // every slot has landed; nothing remote after this
  epilogue<XT, kDecodeThreads, kWarpCols>(slots, steps_s, ws_s,
                                          bias ? bias_s : nullptr, out,
                                          acc_out, rank, S, rpo, tid, 0, nb,
                                          kDecodeRows, T, N);
}

// ---------------------------------------------------------------------
// wide route, T > 16, first launch: one block a row, the row's step and
// codes into device memory, the row held in registers between the two
// (up to 128·kV vectors; a longer one is read again). It lets the GEMM
// launch at once (programmatic dependent launch): the GEMM streams its
// weights while this runs and waits for the codes only.
template <typename XT>
__global__ void __launch_bounds__(kQuantThreads)
    quantize_rows_kernel(const XT* __restrict__ x, int8_t* __restrict__ codes,
                         float* __restrict__ a_step, int K) {
  constexpr int kVec = 16 / sizeof(XT);
  constexpr int kV = 12;
  constexpr int kStride = kQuantThreads;
  __shared__ float warp_max[kQuantThreads / 32];
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int tid = threadIdx.x, lane = tid & 31, r = blockIdx.x;
  const XT* xr = x + (size_t)r * K;
  const int vrow = K / kVec;
  uint4 xv[kV];
  auto load = [&](int v0) {
#pragma unroll
    for (int b = 0; b < kV; ++b)
      if (v0 + kStride * b < vrow)
        xv[b] = *reinterpret_cast<const uint4*>(xr +
                                                (v0 + kStride * b) * kVec);
  };
  float m = 0.f;
  for (int v0 = tid; v0 < vrow; v0 += kStride * kV) {
    load(v0);
#pragma unroll
    for (int b = 0; b < kV; ++b)
      if (v0 + kStride * b < vrow) m = absmax16(xv[b], m, x);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0) warp_max[tid >> 5] = m;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kQuantThreads / 32; ++i) m = fmaxf(m, warp_max[i]);
  const float step = row_step(m), inv = __fdividef(1.0f, step);
  if (tid == 0) a_step[r] = step;
  for (int v0 = tid; v0 < vrow; v0 += kStride * kV) {
    if (vrow > kStride * kV) load(v0);
#pragma unroll
    for (int b = 0; b < kV; ++b)
      if (v0 + kStride * b < vrow)
        store_codes<XT>(codes + (size_t)r * K + (v0 + kStride * b) * kVec,
                        quantize16<XT>(xv[b], step, inv));
  }
}

// wide route, second launch: grid (S, 128-column tiles, 64-token tiles),
// clusters of (S, 1, 1). Each block streams its k-range's steps — the
// weight tile (four 32-column sub-tiles) and the 64 tokens' codes —
// through one cp.async ring, the weights of the first stages before it
// waits for the quantize; warp w takes sub-tile w % 4 against tokens
// 32·(w / 4) .. + 31.
template <typename XT, bool kInt4>
__global__ void __launch_bounds__(kWideThreads)
    w8a8_gemm_wide_kernel(const int8_t* __restrict__ codes_g,
                          const float* __restrict__ a_step,
                          const int8_t* __restrict__ w,
                          const float* __restrict__ w_step,
                          const XT* __restrict__ bias, XT* __restrict__ out,
                          int* __restrict__ acc_out, int T, int K, int N,
                          int per) {
  constexpr int kH = kInt4 ? 2 : 1;
  constexpr int kNT = kWideWarpRows / 8;    // a warp's n8 token tiles
  constexpr int kWeights = kWideCols * kStepRows;
  constexpr int kStage = wide_stage(kInt4);
  extern __shared__ __align__(16) int8_t smem[];

  cg::cluster_group cluster = cg::this_cluster();
  const int S = gridDim.x;
  const int rank = blockIdx.x;
  const int Kp = kInt4 ? K / 2 : K;
  const int steps = (Kp + kStepRows - 1) / kStepRows;
  const int s0 = rank * per, s1 = min(s0 + per, steps);
  const int ns = s1 - s0;
  const int m0 = blockIdx.z * kWideRows;
  const int nb = blockIdx.y * kWideCols;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wn = warp % kWideColWarps;
  const int tw = kWideWarpRows * (warp / kWideColWarps);

  int8_t* ring = smem;
  int* slots = reinterpret_cast<int*>(smem + kWideStages * kStage);
  float* steps_s = reinterpret_cast<float*>(
      slots + (kWideRows + kMaxSplits) * kWideCols);
  float* ws_s = steps_s + kWideRows;
  XT* bias_s = reinterpret_cast<XT*>(ws_s + kWideCols);

  // a step's weights: sub-tile u (columns nb + 32u ..) at u·1 KB, as
  // `load_weights` lays out a warp's
  auto load_w = [&](int8_t* st, int r0) {
    for (int c = tid; c < kWeights / 16; c += kWideThreads) {
      const int u = c / (kStageBytes / 16), r = (c & 63) >> 1;
      const int col = (c & 1) * 16, n = nb + u * kWarpCols + col;
      const bool ok = r0 + r < Kp && n < N;
      const int8_t* src = w + (ok ? (size_t)(r0 + r) * N + n : 0);
      cp_async16(smem_addr(st + u * kStageBytes + row_slot(r) * kWarpCols +
                           col),
                 src, ok ? 16 : 0);
    }
  };
  // a step's codes: token t's 32 codes of stored rows r0 .. r0 + 31 (x's
  // columns h·Kp + r0 ..), 16-byte chunks; tokens past T are zero
  auto load_codes = [&](int8_t* st, int r0) {
    for (int c = tid; c < kH * kWideRows * 2; c += kWideThreads) {
      const int h = c / (kWideRows * 2), t = (c >> 1) % kWideRows;
      const int col = (c & 1) * 16;
      const bool ok = m0 + t < T && r0 + col < Kp;
      const int8_t* src =
          codes_g + (ok ? (size_t)(m0 + t) * K + h * Kp + r0 + col : 0);
      cp_async16(smem_addr(st + kWeights + (h * kWideRows + t) * kCodeLd +
                           col),
                 src, ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int i = 0; i < kWideStages - 1; ++i)
    if (i < ns) load_w(ring + i * kStage, (s0 + i) * kStepRows);
  column_params<XT, kWideCols>(w_step, bias, ws_s, bias_s, nb, N, tid);
  cp_commit();
  cluster_arrive_relaxed();
  // the codes and steps are the quantize's: wait for it
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (tid < kWideRows)
    steps_s[tid] = m0 + tid < T ? a_step[m0 + tid] : 0.f;
#pragma unroll
  for (int i = 0; i < kWideStages - 1; ++i) {
    if (i < ns) load_codes(ring + i * kStage, (s0 + i) * kStepRows);
    cp_commit();
  }

  int accx[kNT][4], accy[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) accx[j][e] = accy[j][e] = 0;
  const bool busy = m0 + tw < T;   // warp-uniform: tokens past T only
  for (int i = 0; i < ns; ++i) {
    cp_wait<kWideStages - 2>();
    __syncthreads();   // step i landed; step i - 1's slot is free
    const int pf = i + kWideStages - 1;
    if (pf < ns) {
      int8_t* st = ring + (pf % kWideStages) * kStage;
      load_w(st, (s0 + pf) * kStepRows);
      load_codes(st, (s0 + pf) * kStepRows);
    }
    cp_commit();
    if (!busy) continue;
    const int8_t* st = ring + (i % kWideStages) * kStage;
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      uint32_t ax[4], ay[4];
      a_fragments<kInt4>(st + wn * kStageBytes, g, tig, h, ax, ay);
      const int8_t* cb =
          st + kWeights + (h * kWideRows + tw + g) * kCodeLd + 4 * tig;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        if (m0 + tw + 8 * j >= T) break;   // warp-uniform: no all-zero tile
        const uint32_t b0 = lds32(cb + 8 * j * kCodeLd);
        const uint32_t b1 = lds32(cb + 8 * j * kCodeLd + 16);
        mma_s8(accx[j], ax, b0, b1);
        mma_s8(accy[j], ay, b0, b1);
      }
    }
  }
  cp_wait<0>();
  __syncthreads();

  // the block's partial tile [64][128] into the free ring, then by
  // token row to the owner ranks' slots in 16-byte pieces (alone, S = 1,
  // the tile is the slots)
  int* tile = reinterpret_cast<int*>(smem);
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    if (m0 + tw + 8 * j >= T) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ix = (tw + 8 * j + 2 * tig + (e & 1)) * kWideCols +
                     wn * kWarpCols + 4 * g + (e >> 1);
      tile[ix] = accx[j][e];
      tile[ix + 2] = accy[j][e];
    }
  }
  __syncthreads();
  const int rpo = (kWideRows + S - 1) / S;
  const int live = min(kWideRows, T - m0);
  cluster_wait();
  const int* sums = tile;
  if (S > 1) {
    constexpr int kChunks = kWideCols / 4;       // 16 bytes a piece
    for (int c = tid; c < live * kChunks; c += kWideThreads) {
      const int t = c / kChunks, piece = c % kChunks;
      uint4* dst = reinterpret_cast<uint4*>(
          slots + (rank * rpo + t / S) * kWideCols) + piece;
      *cluster.map_shared_rank(dst, t % S) =
          reinterpret_cast<const uint4*>(tile)[c];
    }
    cluster.sync();
    sums = slots;
  }
  // the epilogue of the rows this rank owns, 4 columns a thread
  for (int c = tid; c < rpo * kWideCols / 4; c += kWideThreads) {
    const int lr = c / (kWideCols / 4), col = (c % (kWideCols / 4)) * 4;
    const int t = rank + S * lr, n = nb + col;
    if (t >= live || n >= N) continue;
    int4 acc = make_int4(0, 0, 0, 0);
    for (int q = 0; q < S; ++q) {
      const int4 v = *reinterpret_cast<const int4*>(
          sums + (q * rpo + lr) * kWideCols + col);
      acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    }
    const size_t o = (size_t)(m0 + t) * N + n;
    if (acc_out) *reinterpret_cast<int4*>(acc_out + o) = acc;
    const int a[4] = {acc.x, acc.y, acc.z, acc.w};
    const float st = steps_s[t];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = __fmul_rn(__fmul_rn((float)a[i], st), ws_s[col + i]);
      if (bias) v = __fadd_rn(v, to_f(bias_s[col + i]));
      store(out + o + i, v);
    }
  }
}

// shared memory above 48 KB is opted into once per device; `granted`
// is the kernel's own record
template <typename Kern>
cudaError_t opt_in(Kern kern, int smem, int (&granted)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || smem <= 48 * 1024) return err;
  if (dev < 64 && granted[dev] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess && dev < 64) granted[dev] = smem;
  return err;
}

template <typename XT, bool kInt4>
cudaError_t launch(const void* x, const void* w, const void* w_step,
                   const void* bias, void* out, void* codes, void* a_step,
                   void* acc_out, int T, int K, int N, int splits, int per,
                   int smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaError_t err;
  if (T <= kDecodeRows) {
    static int granted[64] = {0};
    auto* kern = w8a8_gemm_kernel<XT, kInt4>;
    if ((err = opt_in(kern, smem, granted)) != cudaSuccess) return err;
    cfg.gridDim = dim3(splits, (N + kWarpCols - 1) / kWarpCols, 1);
    cfg.blockDim = dim3(kDecodeThreads);
    err = cudaLaunchKernelEx(
        &cfg, kern, static_cast<const XT*>(x),
        static_cast<const int8_t*>(w), static_cast<const float*>(w_step),
        static_cast<const XT*>(bias), static_cast<XT*>(out),
        static_cast<int8_t*>(codes), static_cast<float*>(a_step),
        static_cast<int*>(acc_out), T, K, N, per);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
  quantize_rows_kernel<XT><<<T, kQuantThreads, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<int8_t*>(codes),
      static_cast<float*>(a_step), K);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  static int granted[64] = {0};
  auto* kern = w8a8_gemm_wide_kernel<XT, kInt4>;
  if ((err = opt_in(kern, smem, granted)) != cudaSuccess) return err;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.numAttrs = 2;
  cfg.gridDim = dim3(splits, (N + kWideCols - 1) / kWideCols,
                     (T + kWideRows - 1) / kWideRows);
  cfg.blockDim = dim3(kWideThreads);
  err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const int8_t*>(codes),
      static_cast<const float*>(a_step), static_cast<const int8_t*>(w),
      static_cast<const float*>(w_step), static_cast<const XT*>(bias),
      static_cast<XT*>(out), static_cast<int*>(acc_out), T, K, N, per);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// x [T, K] (f32 or bf16, x_bf16), w int8 [K, N] or packed int4 [K/2, N]
// (int4), w_step [N] f32, bias [N] in x's dtype or null, out [T, N] in
// x's dtype; codes int8 [T, K] and a_step f32 [T]: the activation codes
// and steps — the wide route's (T > 16) buffers between its two
// launches, required there; at T <= 16 written only when given (checks);
// acc_out int32 [T, N] or null (the accumulators, for checks). The plan
// (int8_gemm.py `plan`): `splits` k-ranges (the cluster) of `per` steps
// each, `smem` bytes of dynamic shared memory — refused unless it is
// what the route lays out. All pointers 16-byte aligned, tensors
// contiguous; K % 16 == 0 (int4: K % 32 == 0), N % 16 == 0. Returns the
// cudaError of the launches.
extern "C" int pt_w8a8_linear(const void* x, const void* w,
                              const void* w_step, const void* bias,
                              void* out, void* codes, void* a_step,
                              void* acc_out, int T, int K, int N, int x_bf16,
                              int int4, int splits, int per, int smem,
                              void* stream) {
  const int rows = int4 ? K / 2 : K;
  const int steps = (rows + kStepRows - 1) / kStepRows;
  const bool decode = T <= kDecodeRows;
  const int want = decode ? decode_smem(per, int4 != 0) : wide_smem(int4 != 0);
  if (T <= 0 || K <= 0 || N <= 0 || N % 16 != 0 ||
      K % (int4 ? 32 : 16) != 0 ||
      (T + kWideRows - 1) / kWideRows > 65535 || splits < 1 ||
      splits > kMaxSplits || per < 1 || (splits - 1) * per >= steps ||
      splits * per < steps || smem != want ||
      (!decode && (codes == nullptr || a_step == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return (int)(int4 ? launch<__nv_bfloat16, true>(x, w, w_step, bias, out,
                                                    codes, a_step, acc_out, T,
                                                    K, N, splits, per, smem, s)
                      : launch<__nv_bfloat16, false>(
                            x, w, w_step, bias, out, codes, a_step, acc_out,
                            T, K, N, splits, per, smem, s));
  return (int)(int4 ? launch<float, true>(x, w, w_step, bias, out, codes,
                                          a_step, acc_out, T, K, N, splits,
                                          per, smem, s)
                    : launch<float, false>(x, w, w_step, bias, out, codes,
                                           a_step, acc_out, T, K, N, splits,
                                           per, smem, s));
}
