// The fused training stem of bf16 training: on the materialized bf16 conv
// output y of a [conv + BN + leaky, maxpool 2x2/2] pair, train-mode BN
// apply + bias + leaky + pool forward, and the pool routing + leaky
// backward + darknet's BN backward in two passes.
//
// Replaces the Pallas TPU kernels of sr_object_detection_tpu/kernels/
// fused_stem.py (fused_bn_leaky_pool, :295):
//   * fused_stem_f2: _f2_kernel (:135, call :220): per 2x2 window, per tap
//     x_hat = (y - mean) * inv, z = bf16(bf16(x_hat * scale) + bf16(bias)),
//     a = z > 0 ? z : bf16(0.10009765625 * z), pooled = max of the four;
//   * fused_stem_b1: _b1_kernel (:170, call :238): the same per-tap
//     values, the window's pooled cotangent routed to the FIRST tap
//     attaining the maximum (row-major; maxpool_layer.c:95-108), through
//     the bf16 leaky slope (dz), and per channel sum dz and sum dz * x_hat;
//   * fused_stem_b2: _b2_kernel (:187, call :256): the same dz, then
//     dy = bf16(dz*c1 + (y - mean)*c2 + c3) at every tap.
// __fmul_rn/__fsub_rn/__fadd_rn keep nvcc from contracting into FMAs, so
// F2 and B2 equal their plain versions bit for bit at fixed constants.
//
// Layout: the TPU kernels ran on HWCN with the batch in the 128 lanes.
// These read the layout the port's conv writes (NCHW logically, NHWC or
// NCHW in memory). No transpose copy around the kernels.
//
// Bound on an H100, each pass touching each byte once (pair 2 at 416,
// B=128, 208x208x32): F2 reads y (354 MB) and writes the pooled output
// (89 MB), 0.132 ms; B1 reads y and dp (443 MB), 0.132 ms; B2 also writes
// dy (797 MB), 0.238 ms. Elementwise work per byte is small: the bytes
// bound all three.
//
// Two designs:
//   * f2_row_kernel / b1_row_kernel / b2_row_kernel, for y, dp, dy and
//     F2's output dense channels-last,
//     C % 8 == 0 and 16-byte aligned (the port's conv output on the card,
//     so the training step's path). A task is one pooled row (b, ph): y
//     rows 2ph and 2ph+1 and dp row ph, contiguous runs. A thread holds
//     one pooled column pw and one group of 8 channels for its whole life
//     (block = kper columns x C/8 groups, thread t: group t % (C/8)), so
//     its per-channel constants are loaded once into registers, every tap
//     is one 16-byte load and one 16-byte store, and the task index is
//     split into (row, column tile) once per row in 32-bit arithmetic: no
//     per-element division. A thread issues a task's five loads (80
//     bytes) before any arithmetic; at 13 warps a block (416 threads at
//     every fusable pair) and one block an SM that is about 33 KB in
//     flight an SM. Two or four rows a thread spilled B2's registers at
//     the 128 a thread that 13 warps allow, and ran slower. The bf16
//     rounding steps' instructions, not the bytes, held the first version
//     (float math a channel at a time); the activation,
//     the leaky, the window's maximum, the routing masks and the leaky
//     backward now run on two channels at once as bf16x2 (add.rn, mul.rn,
//     max, set), the same values as the float expressions (see hadd2).
//     F2's row pass is B1's forward half: the four taps' loads, the
//     bf16x2 activation and the window's maximum, then one 16-byte store
//     of the window's 8 pooled channels; no cross-thread sum, so no
//     shared memory and no barrier. It needs fewer registers than B1, so
//     more blocks share an SM (F2_MIN_BLOCKS, chosen on the card by
//     tools/fused_stem_ab.py --variants).
//     B1 sums per thread in a fixed order, the block adds its threads of
//     one channel group in a fixed order in shared memory into one
//     partial row, and colsum adds the rows in a fixed order: no atomics,
//     the same bits on every run.
//   * f2_kernel / b1_kernel / b2_kernel, for every other layout: every
//     tensor comes with its four element strides, one pooled window of
//     one channel a thread (grid-stride loop), walked channel-fastest when
//     y is channels-last, width-fastest otherwise. Their limits, which the
//     row kernels remove: 2-byte loads and stores, seven constant loads a
//     window, about 10 bytes in flight a thread, four or five 32-bit
//     divisions a window (and B1's 64-bit ones). B1 gives a block a fixed
//     range of pooled pixels, thread t a fixed channel (t mod C, C
//     dividing 256 or a multiple of it) and a pixel lane, and reduces as
//     above.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define FS_THREADS 256
#define FS_MAX_BLOCKS (132 * 16)
#define ROW_THREADS 448     // a row kernel's block at most (14 warps)
#ifndef F2_MIN_BLOCKS
#define F2_MIN_BLOCKS 2     // f2_row_kernel's blocks an SM, at least
#endif

namespace {

struct FsArgs {
  const __nv_bfloat16* y;
  const __nv_bfloat16* dp;
  __nv_bfloat16* out;
  float* partial;
  const float* kc;           // (rows, C): mean, inv, scales, bias, c1, c2,
                             // c3 (F2 and B1 read the first four)
  long long ys[4], ds[4], os[4];   // element strides (b, c, h, w)
  int B, C, H, W;
  int cfast;                 // walk the pooled elements channel-fastest
};

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void decompose(unsigned e, const FsArgs& A,
                                          int& b, int& c, int& ph, int& pw) {
  const unsigned H2 = A.H / 2, W2 = A.W / 2, C = A.C;
  if (A.cfast) {
    c = e % C;
    e /= C;
    pw = e % W2;
    e /= W2;
    ph = e % H2;
    b = e / H2;
  } else {
    pw = e % W2;
    e /= W2;
    ph = e % H2;
    e /= H2;
    c = e % C;
    b = e / C;
  }
}

// BN + bias + leaky on one tap's y (bias already rounded to bf16): y -
// mean, x_hat, the activation a and the pre-activation's sign.
__device__ __forceinline__ void bn_leaky_tap(float yv, float mean,
                                             float inv, float sc,
                                             float bias, float& xm,
                                             float& xh, float& a,
                                             bool& pos) {
  xm = __fsub_rn(yv, mean);
  xh = __fmul_rn(xm, inv);
  const float z = bf16r(__fadd_rn(bf16r(__fmul_rn(xh, sc)), bias));
  pos = z > 0.f;
  a = pos ? z : bf16r(__fmul_rn(0.10009765625f, z));
}

// The first tap (row-major) attaining the window's maximum.
__device__ __forceinline__ int first_max(const float a[4]) {
  const float m = fmaxf(fmaxf(a[0], a[1]), fmaxf(a[2], a[3]));
  int first = 3;
#pragma unroll
  for (int k = 3; k >= 0; --k)
    if (a[k] == m) first = k;
  return first;
}

// The leaky backward of the pooled cotangent g with the bf16 slope.
__device__ __forceinline__ float leaky_grad(bool pos, float g) {
  return pos ? g : bf16r(__fmul_rn(0.10009765625f, g));
}

// BN + bias + leaky on the window's four taps (row-major).
__device__ __forceinline__ void bn_leaky(const FsArgs& A, int b, int c,
                                         int ph, int pw, float xm[4],
                                         float xh[4], float a[4],
                                         bool pos[4]) {
  const float mean = __ldg(A.kc + c), inv = __ldg(A.kc + A.C + c);
  const float sc = __ldg(A.kc + 2 * A.C + c);
  const float bias = bf16r(__ldg(A.kc + 3 * A.C + c));
  const __nv_bfloat16* base = A.y + b * A.ys[0] + c * A.ys[1] +
                              2LL * ph * A.ys[2] + 2LL * pw * A.ys[3];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    bn_leaky_tap(ld(base + (k >> 1) * A.ys[2] + (k & 1) * A.ys[3]), mean,
                 inv, sc, bias, xm[k], xh[k], a[k], pos[k]);
}

// The pooled cotangent g to the first tap attaining the window's maximum,
// through the leaky backward.
__device__ __forceinline__ void route(const float a[4], const bool pos[4],
                                      float g, float dz[4]) {
  const int first = first_max(a);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    dz[k] = k == first ? leaky_grad(pos[k], g) : 0.f;
}

__global__ void __launch_bounds__(FS_THREADS) f2_kernel(FsArgs A) {
  const unsigned n =
      static_cast<unsigned>(A.B) * A.C * (A.H / 2) * (A.W / 2);
  for (unsigned e = blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += gridDim.x * blockDim.x) {
    int b, c, ph, pw;
    decompose(e, A, b, c, ph, pw);
    float xm[4], xh[4], a[4];
    bool pos[4];
    bn_leaky(A, b, c, ph, pw, xm, xh, a, pos);
    const float m = fmaxf(fmaxf(a[0], a[1]), fmaxf(a[2], a[3]));
    A.out[b * A.os[0] + c * A.os[1] + ph * A.os[2] + pw * A.os[3]] =
        __float2bfloat16_rn(m);
  }
}

__global__ void __launch_bounds__(FS_THREADS) b2_kernel(FsArgs A) {
  const unsigned n =
      static_cast<unsigned>(A.B) * A.C * (A.H / 2) * (A.W / 2);
  for (unsigned e = blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += gridDim.x * blockDim.x) {
    int b, c, ph, pw;
    decompose(e, A, b, c, ph, pw);
    float xm[4], xh[4], a[4], dz[4];
    bool pos[4];
    bn_leaky(A, b, c, ph, pw, xm, xh, a, pos);
    route(a, pos,
          ld(A.dp + b * A.ds[0] + c * A.ds[1] + ph * A.ds[2] +
             pw * A.ds[3]),
          dz);
    const float c1 = __ldg(A.kc + 4 * A.C + c);
    const float c2 = __ldg(A.kc + 5 * A.C + c);
    const float c3 = __ldg(A.kc + 6 * A.C + c);
    __nv_bfloat16* o = A.out + b * A.os[0] + c * A.os[1] +
                       2LL * ph * A.os[2] + 2LL * pw * A.os[3];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      o[(k >> 1) * A.os[2] + (k & 1) * A.os[3]] = __float2bfloat16_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(dz[k], c1), __fmul_rn(xm[k], c2)),
                    c3));
  }
}

// Block blockIdx.x takes pooled pixels [blockIdx.x * per_block, + per_block)
// of the (b, ph, pw) space; partial row blockIdx.x = [sum dz | sum dz*x_hat]
// over them, (2 * C) floats.
__global__ void __launch_bounds__(FS_THREADS) b1_kernel(FsArgs A,
                                                         int per_block) {
  __shared__ float red[2][FS_THREADS];
  const int H2 = A.H / 2, W2 = A.W / 2;
  const int CL = A.C < FS_THREADS ? A.C : FS_THREADS;
  const int lanes = FS_THREADS / CL;
  const int t = threadIdx.x;
  const int lane = t / CL, cc = t % CL;
  const long long P = static_cast<long long>(A.B) * H2 * W2;
  const long long p0 = static_cast<long long>(blockIdx.x) * per_block;
  const long long p1 = p0 + per_block < P ? p0 + per_block : P;
  float* row = A.partial + static_cast<size_t>(blockIdx.x) * 2 * A.C;
  for (int cg = 0; cg < A.C; cg += CL) {
    const int c = cg + cc;
    float s0 = 0.f, s1 = 0.f;
    for (long long p = p0 + lane; p < p1; p += lanes) {
      const int pw = static_cast<int>(p % W2);
      const long long r = p / W2;
      const int ph = static_cast<int>(r % H2);
      const int b = static_cast<int>(r / H2);
      float xm[4], xh[4], a[4], dz[4];
      bool pos[4];
      bn_leaky(A, b, c, ph, pw, xm, xh, a, pos);
      route(a, pos,
            ld(A.dp + b * A.ds[0] + c * A.ds[1] + ph * A.ds[2] +
               pw * A.ds[3]),
            dz);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s0 += dz[k];
        s1 += dz[k] * xh[k];
      }
    }
    red[0][t] = s0;
    red[1][t] = s1;
    __syncthreads();
    if (t < CL) {
      float r0 = 0.f, r1 = 0.f;
      for (int l = 0; l < lanes; ++l) {
        r0 += red[0][l * CL + t];
        r1 += red[1][l * CL + t];
      }
      row[c] = r0;
      row[A.C + c] = r1;
    }
    __syncthreads();
  }
}

// out[c] = sum over rows of partial[row][c] in a fixed order (as
// phase_train.cu's colsum_kernel).
__global__ void __launch_bounds__(FS_THREADS)
colsum_kernel(const float* __restrict__ partial, int rows, int cols,
              float* __restrict__ out) {
  __shared__ float red[FS_THREADS];
  const int c = blockIdx.x;
  float s = 0.f;
  for (int r = threadIdx.x; r < rows; r += FS_THREADS)
    s += partial[static_cast<size_t>(r) * cols + c];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int n = FS_THREADS / 2; n > 0; n >>= 1) {
    if (threadIdx.x < n) red[threadIdx.x] += red[threadIdx.x + n];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[c] = red[0];
}

// ------------------------------------------------------ the row kernels

struct RowArgs {
  const uint4* y;     // (B, H, W, C) bf16 as 16-byte vectors of 8 channels
  const uint4* dp;    // (B, H/2, W/2, C)
  uint4* out;         // dy (B, H, W, C) (B2), pooled (B, H/2, W/2, C)
                      // (F2)
  float* partial;     // (gridDim.x, 2 * C) (B1)
  const float* kc;    // as in FsArgs
  int G;              // C / 8 channel groups
  int W2;             // pooled columns
  int kper;           // pooled columns a block covers in one tile
  int ntile;          // column tiles a row: kper * ntile >= W2
  int tasks;          // B * H/2 * ntile
};

// A row kernel holds two channels (2m, 2m+1) in one 32-bit word of bf16x2,
// low half first (little-endian): lo() and hi() widen them to float.
__device__ __forceinline__ float lo(unsigned w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// float pair -> bf16x2, each rounded to nearest even (F2FP)
__device__ __forceinline__ unsigned pack2(float l, float h) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(l, h);
  return *reinterpret_cast<const unsigned*>(&v);
}

// bf16x2 arithmetic, each lane rounded once to nearest even. For bf16
// operands these equal the strided kernels' float expressions: a product
// of two bf16 values is exact in float32, so bf16r(x * y) has one
// rounding; and bf16r(x + y) rounds a float32 sum that is exact unless
// the exponents differ by more than 16, where the smaller operand is far
// below half a bf16 ulp of the larger and both round to the larger.
__device__ __forceinline__ unsigned hadd2(unsigned a, unsigned b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ unsigned hmul2(unsigned a, unsigned b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ unsigned hmax2(unsigned a, unsigned b) {
  unsigned d;
  asm("max.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// 0xffff in each lane where a == b (+0 == -0), else 0
__device__ __forceinline__ unsigned heq2(unsigned a, unsigned b) {
  unsigned d;
  asm("set.eq.u32.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// 0xffff in each lane where a > 0, else 0
__device__ __forceinline__ unsigned hpos2(unsigned a) {
  unsigned d;
  asm("set.gt.u32.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(0u));
  return d;
}

#define SLOPE2 0x3dcd3dcdu   // bf16x2 (0.10009765625, 0.10009765625)

// One row kernel thread's per-channel constants for its 8 channels
struct RowConsts {
  float mean[8], inv[8], sc[8];
  unsigned bias2[4];        // bf16(bias), channel pairs
};

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load_consts(const float* kc, int C, int cg,
                                            RowConsts& K) {
  float bias[8];
  load8(kc + 8 * cg, K.mean);
  load8(kc + C + 8 * cg, K.inv);
  load8(kc + 2 * C + 8 * cg, K.sc);
  load8(kc + 3 * C + 8 * cg, bias);
#pragma unroll
  for (int m = 0; m < 4; ++m)
    K.bias2[m] = pack2(bias[2 * m], bias[2 * m + 1]);
}

// Channels 2m, 2m+1 of one window's four taps, from their words w
// (row-major): every tap's y - mean (xm), pre-activation z and activation
// a (bf16x2). The same values as bn_leaky.
__device__ __forceinline__ void row_act(const unsigned w[4],
                                        const RowConsts& K, int m,
                                        float xm[4][2], unsigned z[4],
                                        unsigned a[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    xm[k][0] = __fsub_rn(lo(w[k]), K.mean[2 * m]);
    xm[k][1] = __fsub_rn(hi(w[k]), K.mean[2 * m + 1]);
    const float x0 = __fmul_rn(xm[k][0], K.inv[2 * m]);
    const float x1 = __fmul_rn(xm[k][1], K.inv[2 * m + 1]);
    z[k] = hadd2(pack2(__fmul_rn(x0, K.sc[2 * m]),
                       __fmul_rn(x1, K.sc[2 * m + 1])), K.bias2[m]);
    // leaky: z > 0 ? z : bf16(slope * z) is max(z, bf16(slope * z))
    a[k] = hmax2(z[k], hmul2(SLOPE2, z[k]));
  }
}

__device__ __forceinline__ unsigned max4(const unsigned a[4]) {
  return hmax2(hmax2(a[0], a[1]), hmax2(a[2], a[3]));
}

// Channels 2m, 2m+1 of one window, from the four taps' words w (row-major)
// and the pooled cotangent's word g: every tap's y - mean (xm), the masks
// f[k] (0xffff in a lane whose first tap attaining the maximum of the
// activation is k) and the routed cotangent dz (bf16x2, through the leaky
// backward of that tap's sign). The same values as bn_leaky + route.
__device__ __forceinline__ void row_pair(const unsigned w[4], unsigned g,
                                         const RowConsts& K, int m,
                                         float xm[4][2], unsigned f[4],
                                         unsigned& dz) {
  unsigned z[4], a[4];
  row_act(w, K, m, xm, z, a);
  const unsigned mx = max4(a);
  unsigned seen = heq2(a[0], mx);
  f[0] = seen;
#pragma unroll
  for (int k = 1; k < 3; ++k) {
    const unsigned e = heq2(a[k], mx);
    f[k] = e & ~seen;
    seen |= e;
  }
  f[3] = ~seen;
  const unsigned zf = (z[0] & f[0]) | (z[1] & f[1]) | (z[2] & f[2]) |
                      (z[3] & f[3]);
  const unsigned pos = hpos2(zf);
  dz = (g & pos) | (hmul2(SLOPE2, g) & ~pos);
}

// The loads of one task (a pooled row r, column tile `tile`) for the
// thread's column q and channel group cg, issued before any arithmetic:
// the four taps' vectors v. Returns false past the row's last column; yo
// = the vector offset of the window's first tap, po = that of the pooled
// pixel (dp's, F2's output).
__device__ __forceinline__ bool row_loads(const RowArgs& A, int task, int q,
                                          int cg, uint4 v[4], long long& yo,
                                          long long& po) {
  const long long yrow = 2LL * A.W2 * A.G;     // a y row, in vectors
  int r = task, tile = 0;
  if (A.ntile > 1) {
    r = task / A.ntile;
    tile = task - r * A.ntile;
  }
  const int pw = tile * A.kper + q;
  if (pw >= A.W2) return false;
  yo = 2LL * r * yrow + 2 * pw * A.G + cg;
  po = static_cast<long long>(r) * A.W2 * A.G + pw * A.G + cg;
  v[0] = __ldg(A.y + yo);
  v[1] = __ldg(A.y + yo + A.G);
  v[2] = __ldg(A.y + yo + yrow);
  v[3] = __ldg(A.y + yo + yrow + A.G);
  return true;
}

// word m of a vector
__device__ __forceinline__ unsigned word(const uint4& v, int m) {
  return m == 0 ? v.x : m == 1 ? v.y : m == 2 ? v.z : v.w;
}

// Block b takes tasks b, b + gridDim.x, ...; the window's pooled
// activation for the thread's 8 channels, one 16-byte store.
__global__ void __launch_bounds__(ROW_THREADS, F2_MIN_BLOCKS)
f2_row_kernel(RowArgs A) {
  const int t = threadIdx.x;
  const int cg = t % A.G, q = t / A.G;
  RowConsts K;
  load_consts(A.kc, 8 * A.G, cg, K);
  for (int task = blockIdx.x; task < A.tasks; task += gridDim.x) {
    uint4 v[4];
    long long yo, po;
    if (!row_loads(A, task, q, cg, v, yo, po)) continue;
    unsigned o[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const unsigned w[4] = {word(v[0], m), word(v[1], m), word(v[2], m),
                             word(v[3], m)};
      float xm[4][2];
      unsigned z[4], a[4];
      row_act(w, K, m, xm, z, a);
      o[m] = max4(a);
    }
    A.out[po] = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// Block b takes tasks b, b + gridDim.x, ... Partial row b = [sum dz | sum
// dz * x_hat] over them, (2 * C) floats; dynamic shared memory 16 *
// blockDim.x floats.
__global__ void __launch_bounds__(ROW_THREADS, 1) b1_row_kernel(RowArgs A) {
  extern __shared__ float red[];
  const int t = threadIdx.x, bd = blockDim.x;
  const int cg = t % A.G, q = t / A.G;
  const int C = 8 * A.G;
  RowConsts K;
  load_consts(A.kc, C, cg, K);
  float s0[8], s1[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s0[j] = s1[j] = 0.f;
  for (int task = blockIdx.x; task < A.tasks; task += gridDim.x) {
    uint4 v[4];
    long long yo, po;
    if (!row_loads(A, task, q, cg, v, yo, po)) continue;
    const uint4 g = __ldg(A.dp + po);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const unsigned w[4] = {word(v[0], m), word(v[1], m), word(v[2], m),
                             word(v[3], m)};
      float xm[4][2];
      unsigned f[4], dz;
      row_pair(w, word(g, m), K, m, xm, f, dz);
      // x_hat of the routed tap; the other three taps' dz are 0
      const unsigned yf = (w[0] & f[0]) | (w[1] & f[1]) | (w[2] & f[2]) |
                          (w[3] & f[3]);
      const float d0 = lo(dz), d1 = hi(dz);
      s0[2 * m] += d0;
      s0[2 * m + 1] += d1;
      s1[2 * m] += d0 * __fmul_rn(__fsub_rn(lo(yf), K.mean[2 * m]),
                                  K.inv[2 * m]);
      s1[2 * m + 1] += d1 * __fmul_rn(__fsub_rn(hi(yf), K.mean[2 * m + 1]),
                                      K.inv[2 * m + 1]);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    red[j * bd + t] = s0[j];
    red[(8 + j) * bd + t] = s1[j];
  }
  __syncthreads();
  const int kper = bd / A.G;
  float* row = A.partial + static_cast<size_t>(blockIdx.x) * 2 * C;
  for (int o = t; o < 2 * C; o += bd) {
    const int which = o >= C, c = o - which * C;
    const float* src = red + (8 * which + (c & 7)) * bd + (c >> 3);
    float s = 0.f;
    for (int k = 0; k < kper; ++k) s += src[k * A.G];
    row[o] = s;
  }
}

// The tasks as b1_row_kernel's; dy = bf16(dz*c1 + (y - mean)*c2 + c3) at
// every tap, as 16-byte stores.
__global__ void __launch_bounds__(ROW_THREADS, 1) b2_row_kernel(RowArgs A) {
  const int t = threadIdx.x;
  const int cg = t % A.G, q = t / A.G;
  const int C = 8 * A.G;
  const long long yrow = 2LL * A.W2 * A.G;
  RowConsts K;
  load_consts(A.kc, C, cg, K);
  float c1[8], c2[8], c3[8];
  load8(A.kc + 4 * C + 8 * cg, c1);
  load8(A.kc + 5 * C + 8 * cg, c2);
  load8(A.kc + 6 * C + 8 * cg, c3);
  for (int task = blockIdx.x; task < A.tasks; task += gridDim.x) {
    uint4 v[4];
    long long yo, po;
    if (!row_loads(A, task, q, cg, v, yo, po)) continue;
    const uint4 g = __ldg(A.dp + po);
    unsigned o[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const unsigned w[4] = {word(v[0], m), word(v[1], m), word(v[2], m),
                             word(v[3], m)};
      float xm[4][2];
      unsigned f[4], dz;
      row_pair(w, word(g, m), K, m, xm, f, dz);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const unsigned dk = dz & f[k];         // +0 off the routed tap
        o[k][m] = pack2(
            __fadd_rn(__fadd_rn(__fmul_rn(lo(dk), c1[2 * m]),
                                __fmul_rn(xm[k][0], c2[2 * m])),
                      c3[2 * m]),
            __fadd_rn(__fadd_rn(__fmul_rn(hi(dk), c1[2 * m + 1]),
                                __fmul_rn(xm[k][1], c2[2 * m + 1])),
                      c3[2 * m + 1]));
      }
    }
    const long long off[4] = {yo, yo + A.G, yo + yrow, yo + yrow + A.G};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      A.out[off[k]] = make_uint4(o[k][0], o[k][1], o[k][2], o[k][3]);
  }
}

bool shapes_ok(int B, int C, int H, int W) {
  return B > 0 && C > 0 && H > 1 && W > 1 && H % 2 == 0 && W % 2 == 0 &&
         static_cast<long long>(B) * C * (H / 2) * (W / 2) < (1LL << 31);
}

FsArgs make_args(const void* y, const void* dp, const void* kc, void* out,
                 void* partial, const long long* strides, int B, int C,
                 int H, int W, int cfast) {
  FsArgs A;
  A.y = static_cast<const __nv_bfloat16*>(y);
  A.dp = static_cast<const __nv_bfloat16*>(dp);
  A.out = static_cast<__nv_bfloat16*>(out);
  A.partial = static_cast<float*>(partial);
  A.kc = static_cast<const float*>(kc);
  long long* dst[3] = {A.ys, A.ds, A.os};
  for (int t = 0; t < 3; ++t)
    for (int i = 0; i < 4; ++i)
      dst[t][i] = strides[4 * t + i];
  A.B = B;
  A.C = C;
  A.H = H;
  A.W = W;
  A.cfast = cfast;
  return A;
}

int blocks_for(const FsArgs& A) {
  const long long n = static_cast<long long>(A.B) * A.C * (A.H / 2) *
                      (A.W / 2);
  const long long want = (n + FS_THREADS - 1) / FS_THREADS;
  return static_cast<int>(want < FS_MAX_BLOCKS ? want : FS_MAX_BLOCKS);
}


bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

// The row kernels' geometry as the wrapper chose it (kernels/fused_stem.py
// row_geometry): a block of kper * C/8 threads, ntile column tiles a row.
bool row_ok(int B, int C, int H, int W, int kper, int ntile) {
  return shapes_ok(B, C, H, W) && C % 8 == 0 && kper >= 1 && ntile >= 1 &&
         static_cast<long long>(kper) * (C / 8) <= ROW_THREADS &&
         static_cast<long long>(kper) * ntile >= W / 2 &&
         static_cast<long long>(B) * (H / 2) * ntile < (1LL << 31);
}

RowArgs row_args(const void* y, const void* dp, const void* kc, void* out,
                 void* partial, int B, int C, int H, int W, int kper,
                 int ntile) {
  RowArgs A;
  A.y = static_cast<const uint4*>(y);
  A.dp = static_cast<const uint4*>(dp);
  A.out = static_cast<uint4*>(out);
  A.partial = static_cast<float*>(partial);
  A.kc = static_cast<const float*>(kc);
  A.G = C / 8;
  A.W2 = W / 2;
  A.kper = kper;
  A.ntile = ntile;
  A.tasks = B * (H / 2) * ntile;
  return A;
}

}  // namespace

// Every entry point takes strides[12]: the element strides (b, c, h, w)
// of y (B, C, H, W), dp (B, C, H/2, W/2) and out, 0 for a tensor it does
// not read, and kc (7 * C,) float32 [mean | inv | scales | bias | c1 | c2
// | c3] (c1..c3 read by B2 only). All bf16 tensors.

// out (B, C, H/2, W/2): the pooled activation.
extern "C" int srod_fs_f2(const void* y, const void* kc, void* out,
                          const long long* strides, int B, int C, int H,
                          int W, int cfast, void* stream) {
  if (!shapes_ok(B, C, H, W)) return static_cast<int>(cudaErrorInvalidValue);
  const FsArgs A = make_args(y, nullptr, kc, out, nullptr, strides, B, C, H,
                             W, cfast);
  f2_kernel<<<blocks_for(A), FS_THREADS, 0,
              static_cast<cudaStream_t>(stream)>>>(A);
  return static_cast<int>(cudaGetLastError());
}

// partial (nblk, 2 * C) float32 scratch, nblk * per_block >= B * H/2 *
// W/2; out (2 * C,) float32 [sum dz | sum dz * x_hat]. C divides 256 or is
// a multiple of it.
extern "C" int srod_fs_b1(const void* y, const void* dp, const void* kc,
                          void* partial, int nblk, int per_block, void* out,
                          const long long* strides, int B, int C, int H,
                          int W, void* stream) {
  const int cl = C < FS_THREADS ? FS_THREADS % C : C % FS_THREADS;
  if (!shapes_ok(B, C, H, W) || cl || nblk < 1 || per_block < 1 ||
      static_cast<long long>(nblk) * per_block <
          static_cast<long long>(B) * (H / 2) * (W / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const FsArgs A = make_args(y, dp, kc, nullptr, partial, strides, B, C, H,
                             W, 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  b1_kernel<<<nblk, FS_THREADS, 0, s>>>(A, per_block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  colsum_kernel<<<2 * C, FS_THREADS, 0, s>>>(
      static_cast<const float*>(partial), nblk, 2 * C,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out (B, C, H, W): dy, the cotangent of y.
extern "C" int srod_fs_b2(const void* y, const void* dp, const void* kc,
                          void* out, const long long* strides, int B, int C,
                          int H, int W, int cfast, void* stream) {
  if (!shapes_ok(B, C, H, W)) return static_cast<int>(cudaErrorInvalidValue);
  const FsArgs A = make_args(y, dp, kc, out, nullptr, strides, B, C, H, W,
                             cfast);
  b2_kernel<<<blocks_for(A), FS_THREADS, 0,
              static_cast<cudaStream_t>(stream)>>>(A);
  return static_cast<int>(cudaGetLastError());
}

// The row kernels (f2_row_kernel, b1_row_kernel, b2_row_kernel): y, dp,
// dy and F2's output dense channels-last (B, H, W, C) bf16, C % 8 == 0,
// every pointer 16-byte aligned; kper and ntile as kernels/fused_stem.py's
// row_geometry.

// The blocks to launch (kind 0: B2, 1: B1, 2: F2) for `threads` a block:
// the blocks resident on the device at once, at most one a task; -1 on a
// bad argument.
extern "C" int srod_fs_row_grid(int kind, int threads, int tasks) {
  int dev, sms, per_sm = 0;
  if (threads < 1 || threads > ROW_THREADS || tasks < 1 || kind < 0 ||
      kind > 2 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  const cudaError_t err =
      kind == 1 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &per_sm, b1_row_kernel, threads,
                      16 * sizeof(float) * threads)
      : kind == 2
          ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, f2_row_kernel, threads, 0)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, b2_row_kernel, threads, 0);
  if (err != cudaSuccess || per_sm < 1) return -1;
  const long long most = static_cast<long long>(sms) * per_sm;
  return static_cast<int>(tasks < most ? tasks : most);
}

// out (B, H/2, W/2, C) channels-last bf16: the pooled activation.
extern "C" int srod_fs_f2_row(const void* y, const void* kc, void* out,
                              int nblk, int B, int C, int H, int W, int kper,
                              int ntile, void* stream) {
  if (!row_ok(B, C, H, W, kper, ntile) || nblk < 1 || !aligned16(y) ||
      !aligned16(kc) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const RowArgs A = row_args(y, nullptr, kc, out, nullptr, B, C, H, W, kper,
                             ntile);
  f2_row_kernel<<<nblk, kper * A.G, 0, static_cast<cudaStream_t>(stream)>>>(
      A);
  return static_cast<int>(cudaGetLastError());
}

// partial (nblk, 2 * C) float32 scratch; out (2 * C,) float32 [sum dz |
// sum dz * x_hat].
extern "C" int srod_fs_b1_row(const void* y, const void* dp, const void* kc,
                              void* partial, int nblk, void* out, int B,
                              int C, int H, int W, int kper, int ntile,
                              void* stream) {
  if (!row_ok(B, C, H, W, kper, ntile) || nblk < 1 || !aligned16(y) ||
      !aligned16(dp) || !aligned16(kc))
    return static_cast<int>(cudaErrorInvalidValue);
  const RowArgs A = row_args(y, dp, kc, nullptr, partial, B, C, H, W, kper,
                             ntile);
  const int threads = kper * A.G;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  b1_row_kernel<<<nblk, threads, 16 * sizeof(float) * threads, s>>>(A);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  colsum_kernel<<<2 * C, FS_THREADS, 0, s>>>(
      static_cast<const float*>(partial), nblk, 2 * C,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out (B, H, W, C) channels-last bf16: dy.
extern "C" int srod_fs_b2_row(const void* y, const void* dp, const void* kc,
                              void* out, int nblk, int B, int C, int H,
                              int W, int kper, int ntile, void* stream) {
  if (!row_ok(B, C, H, W, kper, ntile) || nblk < 1 || !aligned16(y) ||
      !aligned16(dp) || !aligned16(kc) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const RowArgs A = row_args(y, dp, kc, out, nullptr, B, C, H, W, kper,
                             ntile);
  b2_row_kernel<<<nblk, kper * A.G, 0, static_cast<cudaStream_t>(stream)>>>(
      A);
  return static_cast<int>(cudaGetLastError());
}
