// Batch-1 stem pair: bf16(max over 2x2 of leaky(conv3x3(x, w) + b)).
//
// Replaces the Pallas TPU kernel sr_object_detection_tpu/kernels/
// b1_stem.py (_pair_kernel, via _run_pair and build_stem), which owns a
// [conv3x3 s1 p1 + bias + leaky 0.1 -> maxpool 2x2/2] pair at batch 1
// with BN already folded. The TPU kernel's layout — flat channels-first
// rows padded to 128 lanes, one-hot selection matmuls for the strided
// pool — answered TPU limits and is not carried over.
//
// Tensors: x NHWC bf16 (1,H,W,Cin); w HWIO bf16 (3,3,Cin,Cout); bias f32
// (Cout); out NHWC bf16 (1,H/2,W/2,Cout); H and W even. Products and sums
// in f32, bias in f32, leaky, 2x2 max, ONE rounding to bf16 — the TPU
// kernel's order (b1_stem.py:110-129).
//
// What bounds it on an H100 at batch 1: the four tiny-yolo-416 pairs are
// about 1.35 GFLOP (150, 399, 399 and 399 MFLOP) over a few MB of bf16
// activations, too small to fill the card through one kernel launch per
// pair unless every SM gets blocks. This first version keeps the design
// simple and correct: a block owns a PT x PT tile of pooled pixels and CT
// output channels (one thread per (pooled pixel, channel), four conv
// outputs accumulated per thread), stages the input halo and the weights
// for CI input channels at a time in shared memory as f32, and runs the
// products on the FP32 cores. Tensor cores (wgmma implicit GEMM) are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define SROD_STEM_PT 4                       // pooled tile edge
#define SROD_STEM_CT 16                      // output channels per block
#define SROD_STEM_CI 16                      // input channels per stage
#define SROD_STEM_TH (2 * SROD_STEM_PT + 2)  // input halo edge
#define SROD_STEM_CIP (SROD_STEM_CI + 1)     // padded: fewer bank conflicts

__global__ void __launch_bounds__(SROD_STEM_CT * SROD_STEM_PT * SROD_STEM_PT)
stem_pair_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w,
                 const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, int H, int W, int Cin,
                 int Cout) {
  __shared__ float xs[SROD_STEM_TH][SROD_STEM_TH][SROD_STEM_CIP];
  __shared__ float ws[9][SROD_STEM_CI][SROD_STEM_CT];

  const int H2 = H / 2, W2 = W / 2;
  const int tiles_x = (W2 + SROD_STEM_PT - 1) / SROD_STEM_PT;
  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x % tiles_x;
  const int co0 = blockIdx.y * SROD_STEM_CT;
  const int co_l = threadIdx.x;                  // output channel in tile
  const int py_l = threadIdx.y / SROD_STEM_PT;   // pooled pixel in tile
  const int px_l = threadIdx.y % SROD_STEM_PT;
  const int tid = threadIdx.y * SROD_STEM_CT + threadIdx.x;
  const int nthreads = SROD_STEM_CT * SROD_STEM_PT * SROD_STEM_PT;
  // input row/col of the halo's top-left corner (conv pad 1)
  const int gy0 = 2 * ty * SROD_STEM_PT - 1;
  const int gx0 = 2 * tx * SROD_STEM_PT - 1;

  float acc00 = 0.f, acc01 = 0.f, acc10 = 0.f, acc11 = 0.f;
  for (int ci0 = 0; ci0 < Cin; ci0 += SROD_STEM_CI) {
    const int nci = min(SROD_STEM_CI, Cin - ci0);
    for (int i = tid; i < SROD_STEM_TH * SROD_STEM_TH * SROD_STEM_CI;
         i += nthreads) {
      const int c = i % SROD_STEM_CI;
      const int pix = i / SROD_STEM_CI;
      const int yy = pix / SROD_STEM_TH, xx = pix % SROD_STEM_TH;
      const int gy = gy0 + yy, gx = gx0 + xx;
      float v = 0.f;
      if (c < nci && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = __bfloat162float(
            x[(static_cast<size_t>(gy) * W + gx) * Cin + ci0 + c]);
      xs[yy][xx][c] = v;
    }
    for (int i = tid; i < 9 * SROD_STEM_CI * SROD_STEM_CT; i += nthreads) {
      const int o = i % SROD_STEM_CT;
      const int rest = i / SROD_STEM_CT;
      const int c = rest % SROD_STEM_CI;
      const int t = rest / SROD_STEM_CI;
      float v = 0.f;
      if (c < nci && co0 + o < Cout)
        v = __bfloat162float(
            w[(static_cast<size_t>(t) * Cin + ci0 + c) * Cout + co0 + o]);
      ws[t][c][o] = v;
    }
    __syncthreads();
    for (int c = 0; c < nci; ++c) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float wv = ws[dy * 3 + dx][c][co_l];
          const int r = 2 * py_l + dy, q = 2 * px_l + dx;
          acc00 += xs[r][q][c] * wv;
          acc01 += xs[r][q + 1][c] * wv;
          acc10 += xs[r + 1][q][c] * wv;
          acc11 += xs[r + 1][q + 1][c] * wv;
        }
      }
    }
    __syncthreads();
  }

  const int py = ty * SROD_STEM_PT + py_l, px = tx * SROD_STEM_PT + px_l;
  const int co = co0 + co_l;
  if (py < H2 && px < W2 && co < Cout) {
    const float b = bias[co];
    float v0 = acc00 + b, v1 = acc01 + b, v2 = acc10 + b, v3 = acc11 + b;
    v0 = v0 > 0.f ? v0 : 0.1f * v0;
    v1 = v1 > 0.f ? v1 : 0.1f * v1;
    v2 = v2 > 0.f ? v2 : 0.1f * v2;
    v3 = v3 > 0.f ? v3 : 0.1f * v3;
    const float m = fmaxf(fmaxf(v0, v1), fmaxf(v2, v3));
    out[(static_cast<size_t>(py) * W2 + px) * Cout + co] =
        __float2bfloat16_rn(m);
  }
}

extern "C" int srod_stem_pair(const void* x, const void* w, const void* bias,
                              void* out, int H, int W, int Cin, int Cout,
                              void* stream) {
  if (H <= 0 || W <= 0 || (H % 2) || (W % 2) || Cin <= 0 || Cout <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int H2 = H / 2, W2 = W / 2;
  const int tiles = ((H2 + SROD_STEM_PT - 1) / SROD_STEM_PT) *
                    ((W2 + SROD_STEM_PT - 1) / SROD_STEM_PT);
  const dim3 grid(tiles, (Cout + SROD_STEM_CT - 1) / SROD_STEM_CT);
  const dim3 block(SROD_STEM_CT, SROD_STEM_PT * SROD_STEM_PT);
  stem_pair_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), H, W, Cin, Cout);
  return static_cast<int>(cudaGetLastError());
}
