// int8 stem pair of the batch-128 serving engine:
//   out = requant(leaky(dequant(max over 2x2 of conv3x3_s32(x, w)) + bias))
//
// Replaces the Pallas TPU kernel sr_object_detection_tpu/kernels/
// phase_stem.py (_pair_kernel, via _run_pair and build_phase_stem), which
// owns a [conv3x3 s1 p1 + bias + leaky 0.1 -> maxpool 2x2/2] pair of the
// int8 engine (infer/quant.py) at batch 128. Its phase-split
// [phase][w2][batch] lane layout, halo sidebands and M-packed pool
// variants answered TPU limits (no strided lane slice, the batch filling
// the 128-lane tile) and are not carried over: this kernel reads NHWC
// int8 and HWIO int8 directly.
//
// What it computes, per image, pooled pixel (i, j) and channel f: the
// four int32 accumulators of the 3x3 s1 p1 conv (zero padding) at
// (2i+dr, 2j+dc), their max on the raw int32 values, then the epilogue
// once:
//   v = float(m) * dq[f] + bias[f];  v = v > 0 ? v : 0.1f * v;
//   q = clamp(rint(v * inv_out), -127, 127)
// Bit-exact to the plain chain conv -> epilogue -> requant -> int8 pool
// because the epilogue is monotone for dq > 0 (phase_stem.py:9-13). The
// epilogue uses __fmul_rn/__fadd_rn so nvcc cannot contract m*dq+bias
// into an FMA (that moves codes at .5 boundaries), and rintf rounds half
// to even like torch.round and jnp.round.
//
// Input: int8 NHWC, or the raw frames (uint8 or float32 NHWC) of pair 1,
// which are requantized on load with the engine's own expression
// clamp(rint(float(x) * inv_in), -127, 127) — so the frame is read once,
// as uint8, and no int8 copy of it reaches device memory.
//
// What bounds it on an H100 (tiny-yolo-voc-416, B=128, four pairs): 172
// G int8 operations (87 us at 1,979 TOP/s) against about 388 MB moved
// (uint8 frames 66.5 MB; each pair's int8 output written once and read
// by the next: 88.6, 44.3, 22.2 MB, twice each; 11.1 MB last output):
// 116 us at 3.35 TB/s, so the bytes bound it. This first version runs
// the products on the integer cores with __dp4a (four int8 MACs per
// instruction), which puts it well above that bound; mma.sync/wgmma s8
// tiles are later work.
//
// Design: one block per (image, 8x8 tile of pooled pixels, 16 output
// channels), 256 threads. The block stages the 18x18 input halo tile and
// the channel group's weights for 32 input channels at a time in shared
// memory as int32 words of four channels (Cin padded with zeros to a
// multiple of 4: Cin=3 becomes 4). The halo tile keeps even and odd
// columns apart, and its rows 20 words apart, so the 32 threads of a
// warp (4 pooled rows x 8 pooled columns) read 32 different banks. Each
// thread owns one pooled pixel x 4 channels: it loads its 4x4 input
// patch once per word, the 9 taps' weights for its 4 channels as one
// 16-byte read each (the same address across the warp: a broadcast), and
// keeps the four pool variants' accumulators for each channel in
// registers.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define SROD_PS_PT 8                           // pooled tile edge
#define SROD_PS_CO 16                          // output channels per block
#define SROD_PS_NG (SROD_PS_CO / 4)            // 4-channel groups per block
#define SROD_PS_THREADS (SROD_PS_PT * SROD_PS_PT * SROD_PS_NG)   // 256
#define SROD_PS_TH (2 * SROD_PS_PT + 2)        // halo tile edge (18)
#define SROD_PS_PH 10                          // words per column parity
#define SROD_PS_RS (2 * SROD_PS_PH)            // words per halo tile row
#define SROD_PS_CW 8                           // words (x4 channels) per stage

namespace {

template <typename T>
__device__ __forceinline__ int8_t load_q(const T* x, size_t i, float inv) {
  // raw frame -> int8 code, the engine's requant expression
  const float q = rintf(__fmul_rn(static_cast<float>(x[i]), inv));
  return static_cast<int8_t>(fminf(fmaxf(q, -127.f), 127.f));
}

template <>
__device__ __forceinline__ int8_t load_q<int8_t>(const int8_t* x, size_t i,
                                                 float) {
  return x[i];
}

__device__ __forceinline__ int pack4(int8_t a, int8_t b, int8_t c,
                                     int8_t d) {
  return static_cast<int>(static_cast<uint32_t>(static_cast<uint8_t>(a)) |
                          (static_cast<uint32_t>(static_cast<uint8_t>(b))
                           << 8) |
                          (static_cast<uint32_t>(static_cast<uint8_t>(c))
                           << 16) |
                          (static_cast<uint32_t>(static_cast<uint8_t>(d))
                           << 24));
}

__device__ __forceinline__ int8_t epilogue(int m, float dq, float bias,
                                           float inv_out) {
  float v = __fadd_rn(__fmul_rn(static_cast<float>(m), dq), bias);
  v = v > 0.f ? v : __fmul_rn(0.1f, v);
  const float q = rintf(__fmul_rn(v, inv_out));
  return static_cast<int8_t>(fminf(fmaxf(q, -127.f), 127.f));
}

template <typename T>
__global__ void __launch_bounds__(SROD_PS_THREADS)
phase_pair_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ dq,
                  const float* __restrict__ bias, float inv_in,
                  float inv_out, int8_t* __restrict__ out, int H, int W,
                  int Cin, int Cout) {
  __shared__ int xs[SROD_PS_CW][SROD_PS_TH][SROD_PS_RS];
  __shared__ int4 ws[SROD_PS_CW][9][SROD_PS_NG];

  const int H2 = H / 2, W2 = W / 2;
  const int tiles_x = (W2 + SROD_PS_PT - 1) / SROD_PS_PT;
  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x % tiles_x;
  const int co0 = blockIdx.y * SROD_PS_CO;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int pix = tid % (SROD_PS_PT * SROD_PS_PT);
  const int g = tid / (SROD_PS_PT * SROD_PS_PT);     // channel group
  const int py = pix / SROD_PS_PT, px = pix % SROD_PS_PT;
  // input row/col of the halo tile's top-left corner (conv pad 1)
  const int gy0 = 2 * ty * SROD_PS_PT - 1;
  const int gx0 = 2 * tx * SROD_PS_PT - 1;
  // int8 input with whole 4-channel words: one 32-bit load per word
  const bool word_loads = std::is_same<T, int8_t>::value && Cin % 4 == 0;
  int* wsw = reinterpret_cast<int*>(&ws[0][0][0]);

  int acc[4][4];                 // [channel in group][pool variant]
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[j][v] = 0;

  for (int ci0 = 0; ci0 < Cin; ci0 += 4 * SROD_PS_CW) {
    const int nw = min(SROD_PS_CW, (Cin - ci0 + 3) / 4);
    // the halo tile, word fastest (consecutive threads: consecutive
    // channel words of one pixel)
    for (int i = tid; i < nw * SROD_PS_TH * SROD_PS_TH;
         i += SROD_PS_THREADS) {
      const int wd = i % nw;
      const int pos = i / nw;
      const int yy = pos / SROD_PS_TH, xx = pos % SROD_PS_TH;
      const int gy = gy0 + yy, gx = gx0 + xx;
      const int c = ci0 + 4 * wd;
      int word = 0;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const size_t base =
            ((static_cast<size_t>(b) * H + gy) * W + gx) * Cin + c;
        if (word_loads) {
          word = *reinterpret_cast<const int*>(
              reinterpret_cast<const int8_t*>(x) + base);
        } else {
          int8_t q[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            q[k] = c + k < Cin ? load_q<T>(x, base + k, inv_in) : 0;
          word = pack4(q[0], q[1], q[2], q[3]);
        }
      }
      xs[wd][yy][(xx & 1) * SROD_PS_PH + (xx >> 1)] = word;
    }
    // the weights: ws[wd][tap][g] holds channels co0+4g..+3
    for (int i = tid; i < nw * 9 * SROD_PS_CO; i += SROD_PS_THREADS) {
      const int o = i % SROD_PS_CO;
      const int rest = i / SROD_PS_CO;
      const int t = rest % 9, wd = rest / 9;
      const int co = co0 + o, c = ci0 + 4 * wd;
      int8_t q[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        q[k] = (co < Cout && c + k < Cin)
                   ? w[(static_cast<size_t>(t) * Cin + c + k) * Cout + co]
                   : 0;
      wsw[(wd * 9 + t) * SROD_PS_CO + o] = pack4(q[0], q[1], q[2], q[3]);
    }
    __syncthreads();
    for (int wd = 0; wd < nw; ++wd) {
      int in[4][4];              // the thread's 4x4 input patch
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          in[r][c] = xs[wd][2 * py + r][(c & 1) * SROD_PS_PH + px + (c >> 1)];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const int4 wv = ws[wd][ky * 3 + kx][g];
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int a = in[(v >> 1) + ky][(v & 1) + kx];
            acc[0][v] = __dp4a(a, wv.x, acc[0][v]);
            acc[1][v] = __dp4a(a, wv.y, acc[1][v]);
            acc[2][v] = __dp4a(a, wv.z, acc[2][v]);
            acc[3][v] = __dp4a(a, wv.w, acc[3][v]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int oy = ty * SROD_PS_PT + py, ox = tx * SROD_PS_PT + px;
  if (oy >= H2 || ox >= W2) return;
  const int cb = co0 + 4 * g;
  int8_t q[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = cb + j;
    const int m = max(max(acc[j][0], acc[j][1]), max(acc[j][2], acc[j][3]));
    q[j] = co < Cout ? epilogue(m, dq[co], bias[co], inv_out) : 0;
  }
  int8_t* o = out + ((static_cast<size_t>(b) * H2 + oy) * W2 + ox) * Cout;
  if (Cout % 4 == 0 && cb + 3 < Cout) {
    *reinterpret_cast<int*>(o + cb) = pack4(q[0], q[1], q[2], q[3]);
  } else {
    for (int j = 0; j < 4 && cb + j < Cout; ++j) o[cb + j] = q[j];
  }
}

}  // namespace

// x_dtype: 0 int8 (inv_in unused, pass 0), 1 uint8, 2 float32 (raw
// frames, requantized on load with inv_in).
extern "C" int srod_phase_pair(const void* x, int x_dtype, const void* w,
                               const void* dq, const void* bias,
                               float inv_in, float inv_out, void* out,
                               int B, int H, int W, int Cin, int Cout,
                               void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || (H % 2) || (W % 2) ||
      Cin <= 0 || Cout <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int H2 = H / 2, W2 = W / 2;
  const int tiles = ((H2 + SROD_PS_PT - 1) / SROD_PS_PT) *
                    ((W2 + SROD_PS_PT - 1) / SROD_PS_PT);
  const dim3 grid(tiles, (Cout + SROD_PS_CO - 1) / SROD_PS_CO, B);
  const dim3 block(SROD_PS_THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* d = static_cast<const float*>(dq);
  const float* bb = static_cast<const float*>(bias);
  int8_t* o = static_cast<int8_t*>(out);
  switch (x_dtype) {
    case 0:
      phase_pair_kernel<int8_t><<<grid, block, 0, s>>>(
          static_cast<const int8_t*>(x), wq, d, bb, 0.f, inv_out, o, H, W,
          Cin, Cout);
      break;
    case 1:
      phase_pair_kernel<uint8_t><<<grid, block, 0, s>>>(
          static_cast<const uint8_t*>(x), wq, d, bb, inv_in, inv_out, o, H,
          W, Cin, Cout);
      break;
    case 2:
      phase_pair_kernel<float><<<grid, block, 0, s>>>(
          static_cast<const float*>(x), wq, d, bb, inv_in, inv_out, o, H, W,
          Cin, Cout);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
