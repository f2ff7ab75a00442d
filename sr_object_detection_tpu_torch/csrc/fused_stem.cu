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
// NCHW in memory): every tensor comes with its four element strides, and
// the elementwise passes walk the pooled elements channel-fastest when y
// is channels-last, width-fastest otherwise, so neighbouring threads read
// neighbouring addresses. No transpose copy around the kernels.
//
// Bound on an H100, each pass touching each byte once (pair 2 at 416,
// B=128, 208x208x32): F2 reads y (354 MB) and writes the pooled output
// (89 MB), 0.132 ms; B1 reads y and dp (443 MB), 0.132 ms; B2 also writes
// dy (797 MB), 0.238 ms. Elementwise work per byte is small: the bytes
// bound all three. Design: one pooled window a thread (grid-stride loop)
// for F2 and B2. B1 sums per channel without atomics: a block takes a
// fixed range of pooled pixels, thread t a fixed channel (t mod C, C
// dividing 256 or a multiple of it) and a pixel lane, the block adds its
// lanes in a fixed order into one partial row, and colsum adds the rows
// in a fixed order: the same sums on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define FS_THREADS 256
#define FS_MAX_BLOCKS (132 * 16)

namespace {

struct FsArgs {
  const __nv_bfloat16* y;
  const __nv_bfloat16* dp;
  __nv_bfloat16* out;
  float* partial;
  const float* kc;           // (7, C): mean, inv, scales, bias, c1, c2, c3
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

// BN + bias + leaky on the window's four taps (row-major): y - mean,
// x_hat, the activation a and the pre-activation's sign.
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
  for (int k = 0; k < 4; ++k) {
    const float yv = ld(base + (k >> 1) * A.ys[2] + (k & 1) * A.ys[3]);
    xm[k] = __fsub_rn(yv, mean);
    xh[k] = __fmul_rn(xm[k], inv);
    const float z = bf16r(__fadd_rn(bf16r(__fmul_rn(xh[k], sc)), bias));
    pos[k] = z > 0.f;
    a[k] = pos[k] ? z : bf16r(__fmul_rn(0.10009765625f, z));
  }
}

// The pooled cotangent g to the first tap attaining the window's maximum,
// through the leaky backward with the bf16 slope.
__device__ __forceinline__ void route(const float a[4], const bool pos[4],
                                      float g, float dz[4]) {
  const float m = fmaxf(fmaxf(a[0], a[1]), fmaxf(a[2], a[3]));
  int first = 3;
#pragma unroll
  for (int k = 3; k >= 0; --k)
    if (a[k] == m) first = k;
  const float neg = bf16r(__fmul_rn(0.10009765625f, g));
#pragma unroll
  for (int k = 0; k < 4; ++k) dz[k] = k == first ? (pos[k] ? g : neg) : 0.f;
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
