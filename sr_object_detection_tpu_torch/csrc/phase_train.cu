// The fused leading pair of bf16 training:
//   conv3x3 s1 p1 (bf16 operands, float32 sums, rounded to bf16)
//   -> train-mode BN -> + bias -> leaky -> maxpool 2x2/2,
// with the full-resolution conv output never written to device memory.
//
// Replaces the Pallas TPU kernels of sr_object_detection_tpu/kernels/
// phase_train.py:
//   * phase_train_fwdstats: _train_kernel (phase_train.py:209) in mode
//     "fwdstats" with the int8 argmax (via _run, :573; _pair_fwd :1006);
//   * phase_train_apply: _apply_kernel (:722, via _run_apply_nhwc :802);
//   * phase_train_bwdg: _train_kernel in mode "bwdg", the gram-factored
//     backward with no conv recompute (_pair_grads :1082).
// The TPU kernels' phase-split columns, halo sidebands, 128-lane batch and
// pool-variant M-packing answered Mosaic's limits; these kernels read and
// write NHWC directly and take any batch and any even H and W.
//
// fwdstats: for each image, pooled pixel (i, j) and output channel f, the
// four conv outputs y_k at (2i + k/2, 2j + k%2), k = 0..3 (window
// row-major order), each rounded to bf16. Writes Z = max_k y_k if
// scales[f] > 0 else min_k y_k (bf16), the first k with y_k == Z (int8),
// and per-block partial sums of (y - shift) and (y - shift)^2 per
// channel, which a second pass (colsum) reduces in a fixed order: no
// float atomics, the same sums on every run. Cin <= 64 (staged 16 at a
// time), Cout a multiple of 16 up to 128.
//   Three paths, chosen by one mode-aware predicate (conv_path):
//   * Cin a multiple of 16: the tensor-core tile below
//     (fwdstats_tc_kernel), in every mode;
//   * Cin <= 3 (the leading pair, whose input is the image; fwdstats
//     only): the same tile with the taps fold (fwdstats_fold_kernel),
//     below;
//   * the rest (Cin 4-15, Cin > 16 no multiple of 16; no model in
//     models/zoo.py reaches them): fwdstats_kernel, one block per (image,
//     8x8 pooled tile, 16 channels), 256 threads, each thread one pooled
//     pixel x 4 channels with the four pool variants' accumulators in
//     registers; the 18x18 input halo tile in shared memory with even
//     and odd columns apart (rows 20 floats apart), so a warp's 4x8
//     pooled pixels read 32 different banks; the weights of the channel
//     group read as float4 broadcasts; the products on the FP32 cores.
//   The taps fold. Bound on an H100 at the training pair's shape (B=128,
//   416x416, 3 -> 16): x 133 MB read, Z 177 MB and argmax 89 MB written,
//   0.119 ms at 3.35 TB/s; its 19 GFLOP (K = 27) take 0.023 ms at the bf16
//   dense peak (K padded to 32), and at least 0.29 ms at the FP32 cores'
//   67 TFLOP/s, which held fwdstats_kernel there (with per-value halo
//   loads, runtime divisions and a serial reduction in each of its
//   86,528 short-lived blocks: 1.232 ms). The fold puts K = 9 Cin (tap,
//   ci) pairs into two k16 steps of the tile's GEMM: per tile the block
//   builds X' [256 positions x 32] bf16 in shared memory, column
//   t * Cin + ci the tap's value, columns 9 Cin..31 zero, rows 64 bytes
//   with their 16-byte units XOR-swizzled by the row; A fragments by
//   ldmatrix.x4 from X' in the tile's m16 order, B from the weights as
//   [32 rows t * Cin + ci (zero past 9 Cin)][NC], loaded once a block;
//   2 k16 steps x 2 m16 x NC/8 n8 mma.sync a warp and tile. The rest is
//   the tile's: persistent blocks, the epilogue, the float64 statistics,
//   one partial row a block, colsum. At Cin 3 a pixel is 6 bytes and a
//   halo row (18 pixels) starts at no 16-byte boundary: the ring holds,
//   per halo row, the aligned 16-byte units that cover it (cp.async,
//   zero-filled before x, past its end and for rows outside the image) at
//   a byte offset known from the row's address; X' reads each tap row's
//   3 Cin contiguous values as 4-byte words, funnel-shifted where the
//   offset is 2 mod 4, and masks the columns outside the image. The
//   block builds tile s + 1's X' (the other of two buffers) after tile
//   s's products: one barrier a tile; a block steps through its tiles
//   with adds (TileWalk), no per-element or per-tile division. (A
//   loader of the halo's values into registers by __ldg, a tile ahead,
//   measured slower on an H100 SXM at 700 W: 0.648 against 0.550 ms at
//   3 -> 16 @416, B=128.)
//   y = bf16(float32 sum) as before: every product of
//   two bf16 values is exact in float32, and the sums have one owner and
//   one order, so two launches are bit-equal.
//
// The tensor-core conv tile (conv_tc_body; fwdstats_tc_kernel,
// red_tc_kernel, dy_tc_kernel), for Cin a multiple of 16 — chosen by one
// predicate (conv_path) for fwdstats, red and dy alike, so the chain's
// forward and backward compute one y (red and dy take Cin 8 or 16; the
// fold serves fwdstats alone): the same conv as one
// implicit GEMM on mma.sync m16n8k16 (bf16 operands, float32 sums) per
// work item (image, 8x8 pooled tile, group of NC = 32 output channels,
// or 16 where Cout is not a multiple of 32): M = the 16x16 positions,
// N = NC, K = 9 x Cin in k16 steps (16-channel chunk, tap), chunks
// outer, taps inner, in every mode. Bound at the chain's pair 1 (208x208,
// 16 -> 32, B=128) by bytes (x read, Z and argmax written, 310 MB:
// 0.093 ms at 3.35 TB/s); its 51 GFLOP take 0.052 ms at the bf16 dense peak, where
// the FP32 cores needed 0.76 ms at best. So the design streams x through
// shared memory and keeps the products cheap:
//   - persistent blocks (grid (as many as fit / groups, groups), two of
//     256 threads an SM): a block keeps its channel group's weights in
//     shared memory as bf16 [k16 step][16 ci][NC co] (16-byte units
//     swizzled by ci) and walks its tiles through a ring of 4 halo
//     chunks (18x18 pixels x 16 channels, NHWC, 32 bytes a pixel, units
//     XOR-swizzled by the halo column), fetched by cp.async (src-size 0
//     for the zero padding) while the tensor cores work;
//   - A fragments by ldmatrix.x4 straight from the halo at the tap's
//     shifted position (no im2col), B fragments by ldmatrix.x4.trans;
//     every ldmatrix phase hits eight distinct bank groups;
//   - an m16 tile is 2 full-resolution rows x 8 columns, so a lane's
//     accumulators hold a vertical pair of one pool window and
//     __shfl_xor(., 4) brings the horizontal pair; y = bf16(sum) and
//     every epilogue expression as in fwdstats_kernel / chain_bwd_kernel;
//   - per-channel sums in registers across the block's tiles (float64
//     for fwdstats' statistics: the chain's BN backward is sensitive to
//     the variance at 1e-6), the lanes and warps added in a fixed order
//     into one partial row a block; colsum reduces the rows. No atomics:
//     two launches are bit-equal;
//   - dy (Cin 16): the tile's bf16 dy (the value written to device
//     memory) goes to shared memory, out in 16-byte stores, and into the
//     weight gradient dw += X_taps^T dy, a second GEMM on mma.sync with
//     the 256 positions as K (M = 9 taps x 16 ci, N = NC): both operands
//     run along K, so both come from ldmatrix.trans; every product is
//     exact in float32; warp w owns the (tap, n8) tiles w, w + 8, ...;
//     a tile's 16 k16 steps sum in its registers, the tiles in float32
//     round-to-nearest in shared memory (the tensor cores' own adds
//     truncate, a bias over thousands of steps).
//
// The batch-1 serving stem (kernel 2 of the TPU package, b1_stem.py:82,
// _pair_kernel; srod_pt_stem_pair): out = bf16(max over 2x2 of
// leaky_0.1(conv3x3(x, w) + b)) at batch 1, BN folded, on the same tile in
// mode CT_STEM (stem_tc_kernel<NC>; stem_fold_kernel<CIN, NC>, the taps
// fold, at Cin <= 3), for Cout a multiple of 16 and Cin <= 3 or a
// multiple of 16 up to 128 (the rest: stem_pair_kernel, csrc/b1_stem.cu,
// FP32 cores). Its epilogue takes the maximum of the window's four
// float32 sums, adds the float32 bias and applies the leaky once, and
// rounds once: the per-tap order's value, since fl(m + b) and the leaky
// are nondecreasing in m (up to the sign of a zero); no statistics, no
// argmax, no partial rows. At batch 1 neither bytes (6.3 MB over the four
// tiny-yolo-416 pairs, 1.9 us) nor products (1.35 GFLOP, 1.4 us) bound
// it: pairs 3-4 have 49 and 16 8x8 pooled tiles, so one tile's K loop,
// the block's prologue (the group's weights, the ring's first halos) and
// the launch set its time.
//
// The bf16 serving stem (kernel 4's mode "fwd", phase_train.py:455-474 of
// the TPU package, chained four times by build_bf16_stem, :1464-1517;
// srod_pt_fwd_pair): per tap v = bf16(y), zb = bf16(v + bias) with the
// bf16 bias, out = zb > 0 ? zb : bf16(zb * 0.10009765625), then the
// first maximum of the window, at any batch, on the same tile in mode
// CT_FWD (fwd_tc_kernel<NC>; fwd_fold_kernel<CIN, NC>, the taps fold, at
// Cin <= 3). It shares CT_STEM's window maximum of the raw float32 sums
// and its one 4-byte store a lane pair; the epilogue then rounds as the
// mode does: v = bf16(m), zb = bf16(v + bias), the bf16 leaky. Rounding
// to bf16, the rounded add and the leaky are nondecreasing, so this is
// the per-tap value (up to the sign of a zero), bit-equal to fwdstats +
// apply with identity constants, which it replaces on the serving path:
// no argmax, no statistics, no partial rows, no colsum, no Z written and
// read back. Bound at B=128 by bytes at the leading pairs (x read once,
// the pooled output written once: 3 -> 16 @416 0.0926 ms, 16 -> 32 @208
// 0.0793 ms at 3.35 TB/s) and by the bf16 products at the later two
// (0.0516 ms each at 989 TFLOP/s). Shapes the tile refuses (Cin 4-15,
// Cin > 16 no multiple of 16) run fwdstats_kernel + apply_kernel, a
// dispatch by shape in the wrapper (kernels/phase_train.fwd_pair).
//
// apply (kernel 5): zb = bf16(bf16((z - mean) * inv * scale) + bf16(bias)),
// out = zb > 0 ? zb : bf16(0.10009765625 * zb) — the exact expressions of
// _apply_kernel (phase_train.py:739-742), with __fmul_rn/__fsub_rn/
// __fadd_rn so nvcc cannot contract them into FMAs: bit-equal to its plain
// version. Elementwise, 8 bf16 (16 bytes) per thread and step; bound by
// its bytes (Z read, output written: 354 MB at the pair's shape, 0.106 ms).
//
// bwdg: from x, the pooled cotangent dp, Z and the argmax, with no conv
// recompute (phase_train.py:330-379): x_hat = (Z - mean) * inv; the leaky
// sign from bf16(bf16(x_hat * scale) + bf16(bias)); dzs = pos ? dp :
// bf16(0.10009765625 * dp). Sums Sdzs and Sdzs*x_hat per channel,
// A = sum over pooled pixels of x_taps (9*Cin) (x) dzs at the selected
// tap's full-resolution position, D = sum of x_taps and the Gram
// G = sum of x_taps (x) x_taps over every full-resolution position (the
// upper triangle; the wrapper mirrors it). The wrapper forms
// dw = c1*A + c2*(G @ w - D (x) mean) + c3*D. Cin <= 16, Cout a multiple
// of 16 up to 64, in two kernels chosen by shape alone:
//   Bound at the pair's shape (416, B=128, 3 -> 16): x, dp, Z and argmax
//   read once, about 576 MB, 0.17 ms; the products (40 GFLOP in bf16)
//   take 0.04 ms on the tensor cores, so the bytes bound it.
//   * bwdg_tc_kernel<CIN, COUT> (Cin <= 3, Cout 16 or 32: the leading
//     pair, whose input is the image, on every training path): the JAX
//     kernel's own factoring (phase_train.py:330-379), one dot of the
//     taps with [dz per pool variant | ones] and one Gram dot, folded
//     into ONE bf16 GEMM per work item on the tensor cores (mma.sync
//     m16n8k16, float32 sums). An item is (image, 8x8 pooled tile): its
//     16x16 = 256 full-resolution positions are the GEMM's K. Per item
//     the block stages the 18x18xCin halo (zero outside the image) and
//     builds two bf16 tiles in shared memory:
//       X' [256 x 32]: columns 0..9Cin-1 the position's taps in HWIO
//         order (t*Cin + ci), column 9Cin 1 for a position inside the
//         image, the rest 0; a position outside the image is a zero row;
//       Dz [256 x Cout]: dzs of the position's pooled pixel where its
//         argmax selects this position's pool variant, else 0;
//     and every warp adds X'^T [X' | Dz] over its 32 positions (two k16
//     steps) into acc [32 x (32 + Cout)] in its registers, across all of
//     its block's items. Then G = acc[0:9Cin, 0:9Cin] (upper triangle),
//     D = acc[0:9Cin, 9Cin], A = acc[0:9Cin, 32:], S[0] = acc[9Cin, 32:];
//     the n8 tiles holding none of these (rows past 9Cin, G's lower-left
//     16x16 block) are not computed (bwdg_tile), which keeps the kernel
//     under 128 registers. Every value is exact in bf16, so every
//     product is exact in float32. S[1] =
//     sum dzs * x_hat (x_hat lives at pooled resolution) is a float32
//     sum per staging thread and channel. Both operands run along K,
//     the stored rows, so both fragments come from ldmatrix.trans, and
//     the same 8x8 blocks of X' serve as A (X'^T) and as B (X'); rows
//     are 64 (X') or 32/64 bytes (Dz) with their 16-byte units XOR-
//     swizzled by the row, so an ldmatrix phase hits distinct banks. The
//     next item's x, dp, Z and argmax are fetched into registers while
//     this one is built and multiplied;
//   * bwdg_kernel (the other shapes the wrapper takes: Cin 4-16 or Cout
//     48/64, which no model in models/zoo.py reaches): the FP32 cores;
//     each thread owns fixed entries of S, A, D and G, sums them over
//     the item in a register and adds the sum to its entry's shared-
//     memory accumulator.
//   Both: a fixed grid of persistent blocks (as many as fit on the card
//   at once), each walking the items in a fixed order. Every sum has one
//   owner and one order (the tensor-core kernel adds its warps in warp
//   order), so two launches are bit-equal. Each block writes one row of
//   partial sums; colsum reduces the blocks.
//
// The opt-in two-pair chain (phase_train="chain") adds the second pair's
// backward with an input gradient:
//   * phase_train_red: _train_kernel in mode "red" (phase_train.py:547-
//     557; call via _pair_grads(want_dx=True), :1079): recompute the bf16
//     conv, BN + bias + leaky per tap, route the pooled cotangent to the
//     FIRST maximum of the recomputed activation (:498-512), and sum
//     dz and dz * x_hat per channel;
//   * phase_train_dy: mode "dy" with_wgrad (:514-545, :1113): the same
//     recompute and routing, then dy = bf16(dz*c1 + (y - mean)*c2 + c3)
//     at full resolution, and in the same pass the direct weight gradient
//     dw = sum x_taps (x) dy (the product lies in the TPU kernel's body,
//     so it is computed here, not by a library GEMM);
//   * phase_train_dgrad: _dgrad_kernel (:1256, call :1328), which forms
//     dx = dy conv w with flipped taps and swapped channels as one bf16
//     dot_general on the MXU with float32 sums (:1292-1294); here the
//     same product runs on the tensor cores (mma.sync), bf16 out.
//   On the FP32 cores (Cin 8, chain_bwd_kernel): red and dy share
//   fwdstats' block shape (image, 8x8 pooled tile, 16 channels) and its
//   conv loop, so y is bit-equal to the forward's; a
//   block walks a fixed set of an image's tiles (a chunk) and keeps its
//   sums in registers, one owner per sum; colsum reduces the chunks in a
//   fixed order. dy's weight-gradient step: thread (ci, co) sums the 9
//   taps over the tile's 16x16 positions from the staged halo and dy,
//   a sliding 3x3 window in registers. Cin 8 or 16 (the chain's pair 1,
//   and dgrad's widths), Cout a multiple of 16 up to 128.
//   Bound on an H100 at the chain's second pair (416, B=128, 208x208,
//   16 -> 32): red reads x (177 MB) and dp (89 MB): 0.079 ms; dy also
//   writes dy (354 MB): 0.185 ms; the conv recompute (51 GFLOP, twice
//   that in dy with the weight gradient) takes 0.052 (0.104) ms on the
//   bf16 tensor cores: at Cin 16 both run on the tensor-core tile above.
//   dgrad: an implicit GEMM on the bf16 tensor cores. M = the output
//   pixels, N = Cin (one or two n8 tiles), K = 9 taps x Cout, taken 16
//   dy channels (one k16 step) at a time; mma.sync m16n8k16 with float32
//   accumulators. Bound at the chain's shape by bytes: dy read and dx
//   written, 532 MB, 0.159 ms at 3.35 TB/s; its 51 GFLOP take 0.052 ms at
//   the bf16 dense peak. So the design streams dy through shared memory
//   at HBM rate and keeps the products cheap:
//   - a fixed grid of persistent blocks (two of 256 threads an SM, as
//     many as fit at once, as bwdg), each walking items (image, 16x32
//     output tile, group of 32 dy channels, or 16 where Cout is not a
//     multiple of 32) in a fixed order through a ring of stages (2 for
//     32-channel items, 3 for 16): cp.async (16 bytes, src-size 0 for
//     the zero padding) fetches the next items while the tensor cores
//     work on this one. A 32-channel item reads whole 64-byte runs of a
//     pixel (at Cout 32 its whole row of dy), which the measurement
//     showed to stream faster than two 32-byte halves a pixel apart.
//     Neighbouring blocks walk neighbouring tiles, so the 18x34 halo's
//     extra rows and columns come from L2 (dy is read 1.2x over from L2,
//     once from HBM);
//   - a stage holds the item's dy halo, NHWC, 32 or 64 bytes a pixel, its
//     16-byte units XOR-swizzled by the pixel's halo column, so the eight
//     row addresses of an ldmatrix phase fall in distinct banks and every
//     ldmatrix address is a per-thread base plus a constant; and the
//     group's weights [tap][ci][32 or 16 co], swizzled by ci;
//   - A fragments: ldmatrix.x4 straight from the halo, a row = one
//     pixel's 16 channels at the tap's shifted position (no im2col).
//     Warp w owns output rows 4(w/2)..+3 of one 16-pixel column half:
//     each of its 6 halo rows x 3 column shifts is loaded once a k16 step
//     and feeds every output row it is a tap of (18 ldmatrix for 36 tap
//     products, not 36); B fragments: one ldmatrix.x4 per tap and step;
//   - epilogue: the float32 sums rounded to bf16 once, staged per warp in
//     shared memory and written as 16-byte stores, one pixel's Cin
//     channels contiguous. No atomics: every output has one owner and one
//     summation order (channel groups, then taps in a fixed order), so
//     two runs are bit-equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define PT_PT 8                         // pooled tile edge
#define PT_NPIX (PT_PT * PT_PT)         // pooled pixels per tile
#define PT_CO 16                        // output channels per fwdstats block
#define PT_THREADS 256
#define PT_TH (2 * PT_PT + 2)           // halo tile edge (18)
#define PT_PH 10                        // floats per column parity
#define PT_RS (2 * PT_PH)               // floats per halo row (fwdstats)
#define PT_CI 16                        // input channels per fwdstats stage
#define PT_MAX_CIN_FWD 64
#define PT_MAX_CO_FWD 128
#define PT_MAX_CIN_BWD 16
#define PT_MAX_CO_BWD 64
#define PT_MAX_CIN_CHAIN 16
#define PT_FULL (2 * PT_PT)             // full-resolution tile edge (16)
#define PT_DYS (PT_FULL * PT_FULL + 1)  // dy floats per channel in smem
#define DG_TX 32                        // dgrad output tile: 32 wide
#define DG_TY 16                        //   and 16 tall
#define DG_HX (DG_TX + 2)               // dy halo: 34 wide
#define DG_HY (DG_TY + 2)               //   and 18 tall
#define DG_KC 16                        // dy channels per k16 step
#define DG_EPI (4 * 16 * 32)            // epilogue bytes a warp

namespace {

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ unsigned short bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(PT_THREADS)
fwdstats_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ w,
                const float* __restrict__ shift,
                const float* __restrict__ scales,
                __nv_bfloat16* __restrict__ z, int8_t* __restrict__ am,
                float* __restrict__ partial, int H, int W, int Cin,
                int Cout) {
  __shared__ float xs[PT_CI][PT_TH][PT_RS];
  __shared__ float4 ws[PT_CI][9][PT_CO / 4];
  __shared__ float red[2][PT_CO][PT_NPIX + 1];

  const int H2 = H / 2, W2 = W / 2;
  const int tiles_x = (W2 + PT_PT - 1) / PT_PT;
  const int tiles = tiles_x * ((H2 + PT_PT - 1) / PT_PT);
  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x % tiles_x;
  const int co0 = blockIdx.y * PT_CO;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int pix = tid % PT_NPIX;
  const int g = tid / PT_NPIX;                 // 4-channel group
  const int py = pix / PT_PT, px = pix % PT_PT;
  const int gy0 = 2 * ty * PT_PT - 1, gx0 = 2 * tx * PT_PT - 1;
  float* wsf = reinterpret_cast<float*>(&ws[0][0][0]);

  float acc[4][4];                             // [channel][pool variant]
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[j][v] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += PT_CI) {
    const int nc = min(PT_CI, Cin - ci0);
    for (int i = tid; i < nc * PT_TH * PT_TH; i += PT_THREADS) {
      const int c = i % nc;
      const int pos = i / nc;
      const int yy = pos / PT_TH, xx = pos % PT_TH;
      const int gy = gy0 + yy, gx = gx0 + xx;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = __bfloat162float(
            x[((static_cast<size_t>(b) * H + gy) * W + gx) * Cin + ci0 + c]);
      xs[c][yy][(xx & 1) * PT_PH + (xx >> 1)] = v;
    }
    for (int i = tid; i < nc * 9 * PT_CO; i += PT_THREADS) {
      const int o = i % PT_CO;
      const int rest = i / PT_CO;
      const int t = rest % 9, c = rest / 9;
      wsf[(c * 9 + t) * PT_CO + o] = __bfloat162float(
          w[(static_cast<size_t>(t) * Cin + ci0 + c) * Cout + co0 + o]);
    }
    __syncthreads();
    for (int c = 0; c < nc; ++c) {
      float in[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          in[r][cc] = xs[c][2 * py + r][(cc & 1) * PT_PH + px + (cc >> 1)];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4 wv = ws[c][ky * 3 + kx][g];
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const float a = in[(v >> 1) + ky][(v & 1) + kx];
            acc[0][v] = fmaf(a, wv.x, acc[0][v]);
            acc[1][v] = fmaf(a, wv.y, acc[1][v]);
            acc[2][v] = fmaf(a, wv.z, acc[2][v]);
            acc[3][v] = fmaf(a, wv.w, acc[3][v]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int oy = ty * PT_PT + py, ox = tx * PT_PT + px;
  const bool valid = oy < H2 && ox < W2;
  const int cb = co0 + 4 * g;
  unsigned short zb[4];
  int8_t kb[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = cb + j;
    float y[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) y[v] = bf16r(acc[j][v]);
    const float sh = shift[co];
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float d = y[v] - sh;
      s0 += d;
      s1 += d * d;
    }
    red[0][4 * g + j][pix] = valid ? s0 : 0.f;
    red[1][4 * g + j][pix] = valid ? s1 : 0.f;
    // the extreme in the direction of the channel's BN slope: the
    // monotone BN + bias + leaky map then commutes with the pool
    const bool up = scales[co] > 0.f;
    float zs = y[0];
#pragma unroll
    for (int v = 1; v < 4; ++v) zs = up ? fmaxf(zs, y[v]) : fminf(zs, y[v]);
    int k = 3;
#pragma unroll
    for (int v = 3; v >= 0; --v)
      if (y[v] == zs) k = v;                   // the first tap attaining it
    zb[j] = bf16_bits(zs);
    kb[j] = static_cast<int8_t>(k);
  }
  if (valid) {
    const size_t o = ((static_cast<size_t>(b) * H2 + oy) * W2 + ox) * Cout + cb;
    uint2 zw;
    zw.x = static_cast<unsigned>(zb[0]) | (static_cast<unsigned>(zb[1]) << 16);
    zw.y = static_cast<unsigned>(zb[2]) | (static_cast<unsigned>(zb[3]) << 16);
    *reinterpret_cast<uint2*>(z + o) = zw;
    *reinterpret_cast<int*>(am + o) =
        static_cast<int>(static_cast<uint8_t>(kb[0]) |
                         (static_cast<uint8_t>(kb[1]) << 8) |
                         (static_cast<uint8_t>(kb[2]) << 16) |
                         (static_cast<unsigned>(static_cast<uint8_t>(kb[3]))
                          << 24));
  }
  __syncthreads();
  if (tid < 2 * PT_CO) {
    const int st = tid / PT_CO, c = tid % PT_CO;
    float s = 0.f;
    for (int p = 0; p < PT_NPIX; ++p) s += red[st][c][p];
    partial[(static_cast<size_t>(b) * tiles + blockIdx.x) * 2 * Cout +
            st * Cout + co0 + c] = s;
  }
}

// out[c] = sum over rows of partial[row][c], in a fixed order: thread t
// sums rows t, t + 256, ... and a tree in shared memory adds the threads.
__global__ void __launch_bounds__(PT_THREADS)
colsum_kernel(const float* __restrict__ partial, int rows, int cols,
              float* __restrict__ out) {
  __shared__ float red[PT_THREADS];
  const int c = blockIdx.x;
  float s = 0.f;
  for (int r = threadIdx.x; r < rows; r += PT_THREADS)
    s += partial[static_cast<size_t>(r) * cols + c];
  red[threadIdx.x] = s;
  __syncthreads();
  for (int n = PT_THREADS / 2; n > 0; n >>= 1) {
    if (threadIdx.x < n) red[threadIdx.x] += red[threadIdx.x + n];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[c] = red[0];
}

__global__ void apply_kernel(const __nv_bfloat16* __restrict__ z,
                             const float* __restrict__ mean,
                             const float* __restrict__ inv,
                             const float* __restrict__ scales,
                             const float* __restrict__ bias,
                             __nv_bfloat16* __restrict__ out, size_t n8,
                             int Cout) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n8; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const uint4 in = reinterpret_cast<const uint4*>(z)[i];
    const unsigned short* zi = reinterpret_cast<const unsigned short*>(&in);
    uint4 res;
    unsigned short* ro = reinterpret_cast<unsigned short*>(&res);
    const int c0 = static_cast<int>((i * 8) % Cout);   // Cout % 8 == 0
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = c0 + e;
      const float zf = __bfloat162float(__ushort_as_bfloat16(zi[e]));
      const float t = bf16r(__fmul_rn(
          __fmul_rn(__fsub_rn(zf, __ldg(mean + c)), __ldg(inv + c)),
          __ldg(scales + c)));
      const float zb = bf16r(__fadd_rn(t, bf16r(__ldg(bias + c))));
      ro[e] = bf16_bits(zb > 0.f ? zb : __fmul_rn(0.10009765625f, zb));
    }
    reinterpret_cast<uint4*>(out)[i] = res;
  }
}

struct BwdgLayout {                 // offsets (floats) in shared memory
  int xs, dz, xh, acc_s, acc_a, acc_d, acc_g, sel_bytes, total_bytes;
  int n9;
};

__host__ __device__ inline BwdgLayout bwdg_layout(int Cin, int Cout) {
  BwdgLayout L;
  L.n9 = 9 * Cin;
  L.xs = 0;
  L.dz = L.xs + PT_TH * PT_TH * Cin;
  L.xh = L.dz + PT_NPIX * Cout;
  L.acc_s = L.xh + PT_NPIX * Cout;
  L.acc_a = L.acc_s + 2 * Cout;
  L.acc_d = L.acc_a + L.n9 * Cout;
  L.acc_g = L.acc_d + L.n9;
  const int floats = L.acc_g + L.n9 * L.n9;
  L.sel_bytes = PT_NPIX * Cout;
  L.total_bytes = floats * 4 + L.sel_bytes;
  return L;
}

// partial row layout: [S (2*Cout) | A (9Cin*Cout) | D (9Cin) | G (9Cin^2)]
__global__ void __launch_bounds__(PT_THREADS)
bwdg_kernel(const __nv_bfloat16* __restrict__ x,
            const __nv_bfloat16* __restrict__ dp,
            const __nv_bfloat16* __restrict__ z,
            const int8_t* __restrict__ am, const float* __restrict__ mean,
            const float* __restrict__ inv, const float* __restrict__ scales,
            const float* __restrict__ bias, float* __restrict__ partial,
            int B, int H, int W, int Cin, int Cout) {
  extern __shared__ float sm[];
  const BwdgLayout L = bwdg_layout(Cin, Cout);
  float* xs = sm + L.xs;
  float* dz = sm + L.dz;
  float* xh = sm + L.xh;
  float* acc_s = sm + L.acc_s;
  float* acc_a = sm + L.acc_a;
  float* acc_d = sm + L.acc_d;
  float* acc_g = sm + L.acc_g;
  int8_t* sel = reinterpret_cast<int8_t*>(sm + L.acc_g + L.n9 * L.n9);
  const int n9 = L.n9;
  const int nacc = 2 * Cout + n9 * Cout + n9 + n9 * n9;
  const int tid = threadIdx.x;
  for (int i = tid; i < nacc; i += PT_THREADS) acc_s[i] = 0.f;

  const int H2 = H / 2, W2 = W / 2;
  const int tiles_x = (W2 + PT_PT - 1) / PT_PT;
  const int tiles = tiles_x * ((H2 + PT_PT - 1) / PT_PT);
  const int items = tiles * B;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int b = it / tiles, tile = it % tiles;
    const int ty = tile / tiles_x, tx = tile % tiles_x;
    const int gy0 = 2 * ty * PT_PT - 1, gx0 = 2 * tx * PT_PT - 1;
    __syncthreads();                 // the previous item is done with smem
    for (int i = tid; i < PT_TH * PT_TH * Cin; i += PT_THREADS) {
      const int c = i % Cin, pos = i / Cin;
      const int gy = gy0 + pos / PT_TH, gx = gx0 + pos % PT_TH;
      xs[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                  ? __bfloat162float(
                        x[((static_cast<size_t>(b) * H + gy) * W + gx) *
                              Cin + c])
                  : 0.f;
    }
    for (int i = tid; i < PT_NPIX * Cout; i += PT_THREADS) {
      const int c = i % Cout, p = i / Cout;
      const int oy = ty * PT_PT + p / PT_PT, ox = tx * PT_PT + p % PT_PT;
      float d = 0.f, xhat = 0.f;
      int k = 0;
      if (oy < H2 && ox < W2) {
        const size_t o = ((static_cast<size_t>(b) * H2 + oy) * W2 + ox) *
                             Cout + c;
        const float zf = __bfloat162float(z[o]);
        xhat = __fmul_rn(__fsub_rn(zf, mean[c]), inv[c]);
        const float zb = bf16r(__fadd_rn(bf16r(__fmul_rn(xhat, scales[c])),
                                         bf16r(bias[c])));
        const float gct = __bfloat162float(dp[o]);
        d = zb > 0.f ? gct : bf16r(__fmul_rn(0.10009765625f, gct));
        k = am[o];
      }
      dz[i] = d;
      xh[i] = xhat;
      sel[i] = static_cast<int8_t>(k);
    }
    __syncthreads();
    // per-channel sums of dzs and dzs * x_hat
    for (int e = tid; e < 2 * Cout; e += PT_THREADS) {
      const int st = e / Cout, c = e % Cout;
      float s = 0.f;
      for (int p = 0; p < PT_NPIX; ++p) {
        const float d = dz[p * Cout + c];
        s += st == 0 ? d : d * xh[p * Cout + c];
      }
      acc_s[e] += s;
    }
    // A: taps at the selected full-resolution position (x) dzs
    for (int e = tid; e < n9 * Cout; e += PT_THREADS) {
      const int r = e / Cout, c = e % Cout;
      const int t = r / Cin, ci = r % Cin;
      const int ky = t / 3, kx = t % 3;
      float s = 0.f;
      for (int p = 0; p < PT_NPIX; ++p) {
        const int k = sel[p * Cout + c];
        const int fy = 2 * (p / PT_PT) + (k >> 1) + ky;
        const int fx = 2 * (p % PT_PT) + (k & 1) + kx;
        s += xs[(fy * PT_TH + fx) * Cin + ci] * dz[p * Cout + c];
      }
      acc_a[e] += s;
    }
    // D and the Gram's upper triangle over the valid positions
    const int vh = min(2 * PT_PT, H - 2 * ty * PT_PT);
    const int vw = min(2 * PT_PT, W - 2 * tx * PT_PT);
    for (int e = tid; e < n9 + n9 * n9; e += PT_THREADS) {
      int r, s2;
      if (e < n9) {
        r = e;
        s2 = -1;
      } else {
        r = (e - n9) / n9;
        s2 = (e - n9) % n9;
        if (s2 < r) continue;
      }
      const int tr = r / Cin, cr = r % Cin;
      const int offr = ((tr / 3) * PT_TH + tr % 3) * Cin + cr;
      int offs = 0;
      if (s2 >= 0) {
        const int ts = s2 / Cin, cs = s2 % Cin;
        offs = ((ts / 3) * PT_TH + ts % 3) * Cin + cs;
      }
      float s = 0.f;
      for (int fy = 0; fy < vh; ++fy) {
        for (int fx = 0; fx < vw; ++fx) {
          const int q = (fy * PT_TH + fx) * Cin;
          const float a = xs[q + offr];
          s += s2 < 0 ? a : a * xs[q + offs];
        }
      }
      if (s2 < 0)
        acc_d[r] += s;
      else
        acc_g[r * n9 + s2] += s;
    }
  }
  __syncthreads();
  float* row = partial + static_cast<size_t>(blockIdx.x) * nacc;
  for (int i = tid; i < nacc; i += PT_THREADS) row[i] = acc_s[i];
}

// Modes "red" (DY false) and "dy" (DY true). kc: (7, Cout) float32 rows
// mean, inv, scales, bias, c1, c2, c3 (c1..c3 read in "dy" only). Grid
// (nchunk, Cout / 16, B); block (chunk, group, b) walks the image's tiles
// chunk, chunk + nchunk, ... Partial rows (B * nchunk): "red" 2 * Cout
// columns [sum dz | sum dz * x_hat], "dy" 9 * Cin * Cout (HWIO order).
template <bool DY>
__global__ void __launch_bounds__(PT_THREADS)
chain_bwd_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w,
                 const __nv_bfloat16* __restrict__ dp,
                 const float* __restrict__ kc, __nv_bfloat16* __restrict__ dy,
                 float* __restrict__ partial, int H, int W, int Cin,
                 int Cout) {
  __shared__ float xs[PT_CI][PT_TH][PT_RS];
  __shared__ float4 ws[PT_CI][9][PT_CO / 4];
  // "dy": the tile's dy, [channel][position]; "red": [2][channel][pixel]
  __shared__ float aux[DY ? PT_CO * PT_DYS : 2 * PT_CO * (PT_NPIX + 1)];

  const int H2 = H / 2, W2 = W / 2;
  const int tiles_x = (W2 + PT_PT - 1) / PT_PT;
  const int tiles = tiles_x * ((H2 + PT_PT - 1) / PT_PT);
  const int chunk = blockIdx.x, nchunk = gridDim.x;
  const int co0 = blockIdx.y * PT_CO;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int pix = tid % PT_NPIX;
  const int g = tid / PT_NPIX;                 // 4-channel group
  const int py = pix / PT_PT, px = pix % PT_PT;
  float* wsf = reinterpret_cast<float*>(&ws[0][0][0]);

  for (int i = tid; i < Cin * 9 * PT_CO; i += PT_THREADS) {
    const int o = i % PT_CO;
    const int rest = i / PT_CO;
    const int t = rest % 9, c = rest / 9;
    wsf[(c * 9 + t) * PT_CO + o] = __bfloat162float(
        w[(static_cast<size_t>(t) * Cin + c) * Cout + co0 + o]);
  }
  float run = 0.f;                   // "red": thread tid < 32's sum
  float dwacc[9];                    // "dy": thread (ci, co)'s 9 taps
#pragma unroll
  for (int t = 0; t < 9; ++t) dwacc[t] = 0.f;
  const int wci = tid / PT_CO, wco = tid % PT_CO;

  for (int tile = chunk; tile < tiles; tile += nchunk) {
    const int ty = tile / tiles_x, tx = tile % tiles_x;
    const int gy0 = 2 * ty * PT_PT - 1, gx0 = 2 * tx * PT_PT - 1;
    __syncthreads();                 // the previous tile is done with smem
    for (int i = tid; i < Cin * PT_TH * PT_TH; i += PT_THREADS) {
      const int c = i % Cin;
      const int pos = i / Cin;
      const int yy = pos / PT_TH, xx = pos % PT_TH;
      const int gy = gy0 + yy, gx = gx0 + xx;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = __bfloat162float(
            x[((static_cast<size_t>(b) * H + gy) * W + gx) * Cin + c]);
      xs[c][yy][(xx & 1) * PT_PH + (xx >> 1)] = v;
    }
    __syncthreads();
    float acc[4][4];                 // [channel][pool tap], as fwdstats
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[j][v] = 0.f;
    for (int c = 0; c < Cin; ++c) {
      float in[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          in[r][cc] = xs[c][2 * py + r][(cc & 1) * PT_PH + px + (cc >> 1)];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4 wv = ws[c][ky * 3 + kx][g];
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const float a = in[(v >> 1) + ky][(v & 1) + kx];
            acc[0][v] = fmaf(a, wv.x, acc[0][v]);
            acc[1][v] = fmaf(a, wv.y, acc[1][v]);
            acc[2][v] = fmaf(a, wv.z, acc[2][v]);
            acc[3][v] = fmaf(a, wv.w, acc[3][v]);
          }
        }
      }
    }

    const int oy = ty * PT_PT + py, ox = tx * PT_PT + px;
    const bool valid = oy < H2 && ox < W2;
    const int cb = co0 + 4 * g;
    float dyv[4][4];                 // [channel][tap], "dy" only
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = cb + j;
      const float mean = __ldg(kc + co), inv = __ldg(kc + Cout + co);
      const float sc = __ldg(kc + 2 * Cout + co);
      const float bias = bf16r(__ldg(kc + 3 * Cout + co));
      float xm[4], xh[4], a[4];
      bool pos[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        xm[v] = __fsub_rn(bf16r(acc[j][v]), mean);
        xh[v] = __fmul_rn(xm[v], inv);
        const float z = bf16r(__fadd_rn(bf16r(__fmul_rn(xh[v], sc)), bias));
        pos[v] = z > 0.f;
        a[v] = pos[v] ? z : bf16r(__fmul_rn(0.10009765625f, z));
      }
      const float m = fmaxf(fmaxf(a[0], a[1]), fmaxf(a[2], a[3]));
      int first = 3;
#pragma unroll
      for (int v = 3; v >= 0; --v)
        if (a[v] == m) first = v;    // the first tap attaining the max
      float gct = 0.f;
      if (valid)
        gct = __bfloat162float(
            dp[((static_cast<size_t>(b) * H2 + oy) * W2 + ox) * Cout + co]);
      const float neg = bf16r(__fmul_rn(0.10009765625f, gct));
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float dz = v == first ? (pos[v] ? gct : neg) : 0.f;
        if constexpr (DY) {
          dyv[j][v] = bf16r(__fadd_rn(
              __fadd_rn(__fmul_rn(dz, __ldg(kc + 4 * Cout + co)),
                        __fmul_rn(xm[v], __ldg(kc + 5 * Cout + co))),
              __ldg(kc + 6 * Cout + co)));
        } else {
          s0 += dz;
          s1 += dz * xh[v];
        }
      }
      if constexpr (!DY) {
        aux[(4 * g + j) * (PT_NPIX + 1) + pix] = valid ? s0 : 0.f;
        aux[(PT_CO + 4 * g + j) * (PT_NPIX + 1) + pix] = valid ? s1 : 0.f;
      }
    }
    if constexpr (DY) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int fy = 2 * py + (v >> 1), fx = 2 * px + (v & 1);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          aux[(4 * g + j) * PT_DYS + fy * PT_FULL + fx] =
              valid ? dyv[j][v] : 0.f;
        if (valid) {
          const size_t o =
              ((static_cast<size_t>(b) * H + 2 * oy + (v >> 1)) * W +
               2 * ox + (v & 1)) * Cout + cb;
          uint2 dw2;
          dw2.x = static_cast<unsigned>(bf16_bits(dyv[0][v])) |
                  (static_cast<unsigned>(bf16_bits(dyv[1][v])) << 16);
          dw2.y = static_cast<unsigned>(bf16_bits(dyv[2][v])) |
                  (static_cast<unsigned>(bf16_bits(dyv[3][v])) << 16);
          *reinterpret_cast<uint2*>(dy + o) = dw2;
        }
      }
      __syncthreads();
      // dw[ky][kx][ci][co] += sum over the tile's positions of
      // x(position + (ky - 1, kx - 1), ci) * dy(position, co)
      if (wci < Cin) {
        const float* dr = aux + wco * PT_DYS;
        for (int fy = 0; fy < PT_FULL; ++fy) {
          float c0[3], c1[3];
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            c0[r] = xs[wci][fy + r][0];
            c1[r] = xs[wci][fy + r][PT_PH];
          }
          for (int fx = 0; fx < PT_FULL; ++fx) {
            const int xx = fx + 2;
            float c2[3];
#pragma unroll
            for (int r = 0; r < 3; ++r)
              c2[r] = xs[wci][fy + r][(xx & 1) * PT_PH + (xx >> 1)];
            const float d = dr[fy * PT_FULL + fx];
#pragma unroll
            for (int r = 0; r < 3; ++r) {
              dwacc[r * 3 + 0] = fmaf(c0[r], d, dwacc[r * 3 + 0]);
              dwacc[r * 3 + 1] = fmaf(c1[r], d, dwacc[r * 3 + 1]);
              dwacc[r * 3 + 2] = fmaf(c2[r], d, dwacc[r * 3 + 2]);
              c0[r] = c1[r];
              c1[r] = c2[r];
            }
          }
        }
      }
    } else {
      __syncthreads();
      if (tid < 2 * PT_CO) {
        float s = 0.f;
        for (int p = 0; p < PT_NPIX; ++p) s += aux[tid * (PT_NPIX + 1) + p];
        run += s;
      }
    }
  }

  const size_t row = static_cast<size_t>(b) * nchunk + chunk;
  if constexpr (DY) {
    if (wci < Cin)
#pragma unroll
      for (int t = 0; t < 9; ++t)
        partial[row * 9 * Cin * Cout + (t * Cin + wci) * Cout + co0 + wco] =
            dwacc[t];
  } else if (tid < 2 * PT_CO) {
    partial[row * 2 * Cout + (tid / PT_CO) * Cout + co0 + tid % PT_CO] = run;
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// four 8x8 b16 matrices, each transposed: lane l receives elements
// (rows 2 (l % 4) and 2 (l % 4) + 1, column l / 4) of its matrices
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned addr,
                                                  unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a (16x16, row) * b (16x8, col): bf16 operands, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte offset of 16-byte unit u of row r (KG x 32 bytes) in a staged
// array: the units are XOR-swizzled by the low bits of `key` (the halo
// column of a pixel, the ci of a weight row), so the eight row addresses
// of an ldmatrix phase (eight consecutive columns of one halo row, or
// eight consecutive ci, one unit) fall in distinct banks
template <int KG>
__device__ __forceinline__ int swz(int r, int key, int u) {
  return r * 32 * KG + ((u ^ ((key >> (3 - KG)) & (2 * KG - 1))) << 4);
}

// bytes of one stage: the halo (KG x 16 dy channels a pixel) and the
// group's weights [tap][ci][KG x 16 co]
__host__ __device__ constexpr int dgrad_stage_bytes(int nt, int kg) {
  return (DG_HY * DG_HX + 9 * 8 * nt) * 32 * kg;
}

// stages in the ring: two blocks of 256 threads fit on an SM
__host__ __device__ constexpr int dgrad_stages(int kg) { return 4 - kg; }

// dx[b, y, x, ci] = sum over ky, kx, co of dy[b, y + 1 - ky, x + 1 - kx, co]
// * w[ky, kx, ci, co], float32 sums rounded to bf16 (see the note at the
// top). NT = Cin / 8 n8 tiles; KG k16 steps (16 dy channels each) an
// item, Cout a multiple of 16 KG. A persistent block walks its tiles
// t = blockIdx.x, + gridDim.x, ..., each in Cout / (16 KG) items. 8 warps:
// warp w owns output rows 4 (w / 2) .. + 3 of the tile, pixels
// 16 (w % 2) .. + 15 of each: 4 M-tiles x NT n8 tiles.
template <int NT, int KG>
__global__ void __launch_bounds__(PT_THREADS, 2)
dgrad_kernel(const __nv_bfloat16* __restrict__ dy,
             const __nv_bfloat16* __restrict__ w,
             __nv_bfloat16* __restrict__ dx, int B, int H, int W, int Cout) {
  constexpr int Cin = 8 * NT;
  constexpr int NS = dgrad_stages(KG);
  constexpr int STAGE = dgrad_stage_bytes(NT, KG);
  constexpr int HALO = DG_HY * DG_HX * 32 * KG;
  constexpr int U = 2 * KG;                    // 16-byte units a row
  extern __shared__ __align__(128) unsigned char dsm[];
  unsigned char* epi = dsm + NS * STAGE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ngr = Cout / (DG_KC * KG);
  const int tiles_x = (W + DG_TX - 1) / DG_TX;
  const int tiles_img = tiles_x * ((H + DG_TY - 1) / DG_TY);
  const int tiles = B * tiles_img;
  const int items = ((tiles - 1 - static_cast<int>(blockIdx.x)) /
                         static_cast<int>(gridDim.x) + 1) * ngr;

  // stage item `it` (or commit an empty group past the last item).
  // Thread tid copies unit tid % U of halo pixels tid / U, + 256 / U, ...
  // (row-major in the 18 x 34 halo, stepped without a division), then
  // unit tid % U of weight rows tid / U, + 256 / U, ...
  constexpr int PSTEP = PT_THREADS / U;
  const int u_ld = tid % U;
  const int hy_ld = (tid / U) / DG_HX, hx_ld = (tid / U) % DG_HX;
  auto load = [&](int it) {
    if (it < items) {
      const int t = blockIdx.x + (it / ngr) * gridDim.x;
      const int c0 = (it % ngr) * DG_KC * KG + 8 * u_ld;
      const int b = t / tiles_img, r = t % tiles_img;
      const int y0 = (r / tiles_x) * DG_TY - 1;
      const int x0 = (r % tiles_x) * DG_TX - 1;
      const __nv_bfloat16* img = dy + static_cast<size_t>(b) * H * W * Cout;
      const unsigned st = smem_u32(dsm + (it % NS) * STAGE);
      for (int hy = hy_ld, hx = hx_ld; hy < DG_HY;) {
        const int gy = y0 + hy, gx = x0 + hx;
        const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
        const __nv_bfloat16* src =
            in ? img + (static_cast<size_t>(gy) * W + gx) * Cout + c0 : dy;
        cp_async16(st + swz<KG>(hy * DG_HX + hx, hx, u_ld), src,
                   in ? 16 : 0);
        hx += PSTEP % DG_HX;
        hy += PSTEP / DG_HX;
        if (hx >= DG_HX) {
          hx -= DG_HX;
          ++hy;
        }
      }
      // weight row = tap * Cin + ci
      for (int row = tid / U; row < 9 * Cin; row += PSTEP)
        cp_async16(st + HALO + swz<KG>(row, row, u_ld),
                   w + static_cast<size_t>(row) * Cout + c0, 16);
    }
    cp_async_commit();
  };

  const int rg = warp >> 1, mcol = warp & 1;
  const int g = lane >> 2, q = lane & 3;
  // ldmatrix row addresses: A, pixel lane % 16 of the M-tile, unit
  // lane / 16 of the k16 step; B, ci (lane % 8) + 8 (lane / 16), unit
  // (lane / 8) % 2 of the k16 step
  const int a_px = 16 * mcol + (lane & 15), a_h = lane >> 4;
  const int b_ci = (lane & 7) + (NT == 2 ? 8 * (lane >> 4) : 0);
  const int b_h = (lane >> 3) & 1;
  // halo row hr of the warp, column shift fx, step kk: a_off[fx][kk] +
  // hr * the row's bytes; tap f of step kk: b_off[kk] + (8 - f) * Cin rows
  int a_off[3][KG], b_off[KG];
#pragma unroll
  for (int kk = 0; kk < KG; ++kk) {
#pragma unroll
    for (int fx = 0; fx < 3; ++fx)
      a_off[fx][kk] = swz<KG>(4 * rg * DG_HX + a_px + fx, a_px + fx,
                              2 * kk + a_h);
    b_off[kk] = HALO + swz<KG>(b_ci, b_ci, 2 * kk + b_h);
  }
  float acc[4][NT][4];

  for (int s = 0; s < NS - 1; ++s) load(s);
  for (int it = 0; it < items; ++it) {
    cp_async_wait<NS - 2>();         // item it has landed ...
    __syncthreads();                 // ... for all, and it - 1 is done
    load(it + NS - 1);
    const int gr = it % ngr;
    if (gr == 0) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][n][e] = 0.f;
    }
    const unsigned st = smem_u32(dsm + (it % NS) * STAGE);
#pragma unroll
    for (int kk = 0; kk < KG; ++kk) {
      unsigned bf[9][4];             // [flipped tap fy * 3 + fx]
#pragma unroll
      for (int f = 0; f < 9; ++f)
        ldmatrix_x4(st + b_off[kk] + (8 - f) * Cin * 32 * KG, bf[f]);
#pragma unroll
      for (int hr = 0; hr < 6; ++hr) {
#pragma unroll
        for (int fx = 0; fx < 3; ++fx) {
          unsigned a[4];
          ldmatrix_x4(st + a_off[fx][kk] + hr * DG_HX * 32 * KG, a);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int fy = hr - r;
            if (fy >= 0 && fy < 3) {
#pragma unroll
              for (int n = 0; n < NT; ++n)
                mma_bf16(acc[r][n], a, bf[fy * 3 + fx][2 * n],
                         bf[fy * 3 + fx][2 * n + 1]);
            }
          }
        }
      }
    }
    if (gr == ngr - 1) {
      // round once, stage the warp's 4 x 16 pixels x Cin, 16-byte stores
      unsigned char* e = epi + warp * DG_EPI;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int px = 16 * r + g + 8 * hh;
            const __nv_bfloat162 v = __floats2bfloat162_rn(
                acc[r][n][2 * hh], acc[r][n][2 * hh + 1]);
            const int off = NT == 2 ? swz<1>(px, px, n) : px * 16;
            *reinterpret_cast<__nv_bfloat162*>(e + off + 4 * q) = v;
          }
      __syncwarp();
      const int t = blockIdx.x + (it / ngr) * gridDim.x;
      const int b = t / tiles_img, rr = t % tiles_img;
      const int oy0 = (rr / tiles_x) * DG_TY + 4 * rg;
      const int ox0 = (rr % tiles_x) * DG_TX + 16 * mcol;
#pragma unroll
      for (int i = lane; i < 64 * NT; i += 32) {
        const int px = i / NT, n = i % NT;
        const int oy = oy0 + px / 16, ox = ox0 + px % 16;
        const int off = NT == 2 ? swz<1>(px, px, n) : px * 16;
        if (oy < H && ox < W)
          reinterpret_cast<uint4*>(
              dx + ((static_cast<size_t>(b) * H + oy) * W + ox) * Cin)[n] =
              *reinterpret_cast<const uint4*>(e + off);
      }
      __syncwarp();
    }
  }
  cp_async_wait<0>();
}

// launches dgrad_kernel<NT, KG> on a persistent grid: min(tiles, the
// blocks resident at once)
template <int NT, int KG>
int dgrad_launch(const void* dy, const void* w, void* dx, int B, int H,
                 int W, int Cout, cudaStream_t s) {
  const long long tiles = static_cast<long long>(B) *
                          ((H + DG_TY - 1) / DG_TY) *
                          ((W + DG_TX - 1) / DG_TX);
  const int smem =
      dgrad_stages(KG) * dgrad_stage_bytes(NT, KG) + 8 * DG_EPI;
  int dev = 0, sms = 0, per_sm = 0;
  if (tiles > 0x7fffffff ||
      cudaFuncSetAttribute(dgrad_kernel<NT, KG>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, dgrad_kernel<NT, KG>, PT_THREADS, smem) != cudaSuccess ||
      per_sm < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long most = static_cast<long long>(sms) * per_sm;
  dgrad_kernel<NT, KG><<<static_cast<int>(tiles < most ? tiles : most),
                         PT_THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(dy),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(dx),
      B, H, W, Cout);
  return static_cast<int>(cudaGetLastError());
}

// bf16x2 (two values, low half first): the larger of each lane; 0xffff
// in each lane where a == b (+0 == -0), else 0
__device__ __forceinline__ unsigned hmax2(unsigned a, unsigned b) {
  unsigned d;
  asm("max.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ unsigned heq2(unsigned a, unsigned b) {
  unsigned d;
  asm("set.eq.u32.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// 8 bytes global -> shared through L1; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async8(unsigned dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// whether bwdg_tc_kernel<CIN, ...> keeps accumulator tile (mt, nt) of
// acc [32 x (32 + COUT)], n8 tiles 0..3 the X' columns, 4.. the Dz ones:
// only rows 0..9Cin of X'^T and columns 0..9Cin of X' are not zero, and
// the rows 16.. x columns 0..15 block holds G's lower triangle alone (D
// is read from column 9Cin)
__host__ __device__ constexpr bool bwdg_tile(int cin, int mt, int nt) {
  return 16 * mt <= 9 * cin &&
         (nt >= 4 || (8 * nt <= 9 * cin && (mt == 0 || nt >= 2)));
}

// bwdg on the tensor cores (see the note at the top). CIN <= 3, COUT 16 or
// 32; z, dp 16-byte and am 8-byte aligned. Partial row layout as
// bwdg_kernel's, the Gram's lower triangle 0.
template <int CIN, int COUT>
__global__ void __launch_bounds__(PT_THREADS, 2)
bwdg_tc_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ dp,
               const __nv_bfloat16* __restrict__ z,
               const int8_t* __restrict__ am, const float* __restrict__ mean,
               const float* __restrict__ inv,
               const float* __restrict__ scales,
               const float* __restrict__ bias, float* __restrict__ partial,
               int B, int H, int W) {
  constexpr int N9 = 9 * CIN;                // taps; X' column N9 is ones
  constexpr int KD = COUT / 16;              // Dz rows: 32 KD bytes
  constexpr int NTD = COUT / 8;              // Dz n8 tiles = channel groups
  constexpr int NT = 4 + NTD;                // n8 tiles of [X' | Dz]
  constexpr int NC = 32 + COUT;              // accumulator columns
  constexpr int HALO = PT_TH * PT_TH * CIN;  // halo values
  constexpr int HL = (HALO + PT_THREADS - 1) / PT_THREADS;
  constexpr int PW = PT_NPIX * NTD;          // threads staging dzs
  constexpr int XP = PT_THREADS * 64;        // X' bytes (256 rows)
  constexpr int DZ = PT_THREADS * 32 * KD;   // Dz bytes
  constexpr int RZ = PT_NPIX * COUT * 2;     // raw Z (and dp) bytes
  static_assert(CIN >= 1 && N9 < 32 && (COUT == 16 || COUT == 32), "shape");
  static_assert(4 * (32 * NC + PT_NPIX * COUT) <= XP + DZ, "epilogue");
  __shared__ __align__(128) unsigned char sm[XP + DZ];
  // the next item's Z, dp and argmax, each staging thread's own 8 channels
  __shared__ __align__(16) unsigned char raw[2 * RZ + PT_NPIX * COUT];
  __shared__ unsigned short hs[HALO];        // bf16 bits, [yy][xx][ci]
  __shared__ float kc[4][COUT];              // mean, inv, scales, bias
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < 4 * COUT; i += PT_THREADS) {
    const int r = i / COUT, c = i % COUT;
    kc[r][c] = (r == 0 ? mean : r == 1 ? inv : r == 2 ? scales : bias)[c];
  }
  const int H2 = H / 2, W2 = W / 2;
  const int tiles_x = (W2 + PT_PT - 1) / PT_PT;
  const int tiles = tiles_x * ((H2 + PT_PT - 1) / PT_PT);
  const int items = tiles * B;
  // the dzs staging thread's pooled pixel and 8-channel group
  const int pp = tid / NTD, grp = tid % NTD;
  const int ppy = pp / PT_PT, ppx = pp % PT_PT;
  const bool pworker = tid < PW;
  const int rawo = pp * COUT + 8 * grp;      // its first channel in raw
  const unsigned short* xu = reinterpret_cast<const unsigned short*>(x);

  // stage the inputs of item `it`: the halo values tid, + 256, ... into
  // registers; the staging thread's Z, dp, argmax into raw (cp.async,
  // zeros outside the image: dp 0 makes dzs 0 at all four positions)
  unsigned short hv[HL];
  auto fetch = [&](int it) {
    const int b = it / tiles, tile = it % tiles;
    const int ty = tile / tiles_x, tx = tile % tiles_x;
    const int gy0 = 2 * ty * PT_PT - 1, gx0 = 2 * tx * PT_PT - 1;
    const unsigned short* img = xu + static_cast<size_t>(b) * H * W * CIN;
#pragma unroll
    for (int j = 0; j < HL; ++j) {
      const int i = tid + j * PT_THREADS;
      const int ci = i % CIN, pos = i / CIN;
      const int gy = gy0 + pos / PT_TH, gx = gx0 + pos % PT_TH;
      hv[j] = (i < HALO && gy >= 0 && gy < H && gx >= 0 && gx < W)
                  ? __ldg(img + (static_cast<size_t>(gy) * W + gx) * CIN +
                          ci)
                  : static_cast<unsigned short>(0);
    }
    if (pworker) {
      const int oy = ty * PT_PT + ppy, ox = tx * PT_PT + ppx;
      const bool in = oy < H2 && ox < W2;
      const size_t o =
          in ? ((static_cast<size_t>(b) * H2 + oy) * W2 + ox) * COUT +
                   8 * grp
             : 0;
      cp_async16(smem_u32(raw + 2 * rawo), z + o, in ? 16 : 0);
      cp_async16(smem_u32(raw + RZ + 2 * rawo), dp + o, in ? 16 : 0);
      cp_async8(smem_u32(raw + 2 * RZ + rawo), am + o, in ? 8 : 0);
    }
    cp_async_commit();
  };

  // ldmatrix.trans row addresses. Warp w's k16 step ks covers positions
  // 32 w + 16 ks .. + 15. X': lane l addresses row 32 w + 16 ks + 8 h +
  // l % 8, unit l / 8 (xa + (16 ks + 8 h) * 64: the row's swizzle key
  // depends on l alone), so xt[h][u] holds the 8x8 block (positions
  // + 8 h .., X' columns 8 u ..). Dz unit pair pr: row 32 w + 16 ks +
  // 8 ((l / 8) % 2) + l % 8, unit 2 pr + l / 16 (da[pr] + 16 ks * 32 KD):
  // df[pr][2 (u % 2) + h] holds block (+ 8 h .., Dz columns 8 u ..) for
  // u = 2 pr + u % 2.
  const unsigned smb = smem_u32(sm);
  const unsigned xa = smb + swz<2>(32 * warp + (lane & 7), lane & 7,
                                   lane >> 3);
  unsigned da[KD];
#pragma unroll
  for (int pr = 0; pr < KD; ++pr) {
    const int r = 32 * warp + 8 * ((lane >> 3) & 1) + (lane & 7);
    da[pr] = smb + XP + swz<KD>(r, r, 2 * pr + (lane >> 4));
  }

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  float s1[8];                       // sum dzs * x_hat, the thread's channels
#pragma unroll
  for (int e = 0; e < 8; ++e) s1[e] = 0.f;

  if (static_cast<int>(blockIdx.x) < items) fetch(blockIdx.x);
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int tile = it % tiles;
    const int ty = tile / tiles_x, tx = tile % tiles_x;
    cp_async_wait<0>();              // this thread's raw slots have landed
    __syncthreads();                 // the previous item's tiles are read
#pragma unroll
    for (int j = 0; j < HL; ++j)
      if (tid + j * PT_THREADS < HALO) hs[tid + j * PT_THREADS] = hv[j];
    if (pworker) {
      // dzs with the exact expressions of bwdg_kernel, then the four Dz
      // rows of the pixel's 2x2 window, unit grp: dzs where the argmax
      // selects the position, else 0
      const uint4 zv = *reinterpret_cast<const uint4*>(raw + 2 * rawo);
      const uint4 dv = *reinterpret_cast<const uint4*>(raw + RZ + 2 * rawo);
      const uint2 av = *reinterpret_cast<const uint2*>(raw + 2 * RZ + rawo);
      const unsigned zw[4] = {zv.x, zv.y, zv.z, zv.w};
      const unsigned dw[4] = {dv.x, dv.y, dv.z, dv.w};
      const unsigned aw[2] = {av.x, av.y};
      unsigned dbits[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = 8 * grp + e;
        const float zf = __uint_as_float((zw[e / 2] >> (16 * (e % 2))) << 16);
        const float gct =
            __uint_as_float((dw[e / 2] >> (16 * (e % 2))) << 16);
        const float xhat = __fmul_rn(__fsub_rn(zf, kc[0][c]), kc[1][c]);
        const float zb = bf16r(__fadd_rn(bf16r(__fmul_rn(xhat, kc[2][c])),
                                         bf16r(kc[3][c])));
        const float d =
            zb > 0.f ? gct : bf16r(__fmul_rn(0.10009765625f, gct));
        s1[e] = __fadd_rn(s1[e], __fmul_rn(d, xhat));
        dbits[e] = bf16_bits(d);
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int pos = (2 * ppy + (v >> 1)) * PT_FULL + 2 * ppx + (v & 1);
        unsigned u[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int e = 2 * h;
          const unsigned k0 = (aw[e / 4] >> (8 * (e % 4))) & 0xff;
          const unsigned k1 = (aw[e / 4] >> (8 * (e % 4) + 8)) & 0xff;
          u[h] = (k0 == static_cast<unsigned>(v) ? dbits[e] : 0u) |
                 ((k1 == static_cast<unsigned>(v) ? dbits[e + 1] : 0u)
                  << 16);
        }
        *reinterpret_cast<uint4*>(sm + XP + swz<KD>(pos, pos, grp)) =
            make_uint4(u[0], u[1], u[2], u[3]);
      }
    }
    if (it + static_cast<int>(gridDim.x) < items) fetch(it + gridDim.x);
    __syncthreads();
    {
      // X' row tid: position (fy, fx) of the 16x16 tile
      const int fy = tid >> 4, fx = tid & 15;
      const bool in = 2 * ty * PT_PT + fy < H && 2 * tx * PT_PT + fx < W;
      const unsigned short* hp = hs + (fy * PT_TH + fx) * CIN;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        unsigned wv[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          unsigned half[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * u + 2 * h + e;
            const int t = col / CIN, ci = col % CIN;
            half[e] = col < N9 ? hp[((t / 3) * PT_TH + t % 3) * CIN + ci]
                      : col == N9 ? 0x3F80u        // bf16 1.0
                                  : 0u;
          }
          wv[h] = in ? half[0] | (half[1] << 16) : 0u;
        }
        *reinterpret_cast<uint4*>(sm + swz<2>(tid, tid, u)) =
            make_uint4(wv[0], wv[1], wv[2], wv[3]);
      }
    }
    __syncthreads();
#pragma unroll 1                     // one step's fragments live: no spills
    for (int ks = 0; ks < 2; ++ks) {
      unsigned xt[2][4], df[KD][4];
      ldmatrix_x4_trans(xa + (16 * ks) * 64, xt[0]);
      ldmatrix_x4_trans(xa + (16 * ks + 8) * 64, xt[1]);
#pragma unroll
      for (int pr = 0; pr < KD; ++pr)
        ldmatrix_x4_trans(da[pr] + 16 * ks * 32 * KD, df[pr]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        // A = X'^T rows 16 mt ..: blocks (k lo, 2 mt), (k lo, 2 mt + 1),
        // (k hi, 2 mt), (k hi, 2 mt + 1); B = X' columns 8 nt ..: (k lo,
        // nt), (k hi, nt)
        const unsigned a[4] = {xt[0][2 * mt], xt[0][2 * mt + 1],
                               xt[1][2 * mt], xt[1][2 * mt + 1]};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          if (bwdg_tile(CIN, mt, nt))
            mma_bf16(acc[mt][nt], a, xt[0][nt], xt[1][nt]);
#pragma unroll
        for (int u = 0; u < NTD; ++u)
          if (bwdg_tile(CIN, mt, 4 + u))
            mma_bf16(acc[mt][4 + u], a, df[u / 2][2 * (u % 2)],
                     df[u / 2][2 * (u % 2) + 1]);
      }
    }
  }

  // epilogue: the warps' kept accumulator tiles added in warp order into
  // red [32][NC], the staging threads' S[1] sums into s1b [64][COUT]
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(sm);
  float* s1b = red + 32 * NC;
  const int g = lane >> 2, q = lane & 3;
  for (int w = 0; w < PT_THREADS / 32; ++w) {
    if (warp == w) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          if (bwdg_tile(CIN, mt, nt))
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float& r = red[(16 * mt + g + 8 * (e >> 1)) * NC + 8 * nt +
                             2 * q + (e & 1)];
              r = w == 0 ? acc[mt][nt][e] : r + acc[mt][nt][e];
            }
    }
    __syncthreads();
  }
  if (pworker)
#pragma unroll
    for (int e = 0; e < 8; ++e) s1b[pp * COUT + 8 * grp + e] = s1[e];
  __syncthreads();
  constexpr int NCOLS = 2 * COUT + N9 * COUT + N9 + N9 * N9;
  float* row = partial + static_cast<size_t>(blockIdx.x) * NCOLS;
  for (int i = tid; i < NCOLS; i += PT_THREADS) {
    float v;
    if (i < COUT) {                                   // S[0]
      v = red[N9 * NC + 32 + i];
    } else if (i < 2 * COUT) {                        // S[1]
      v = 0.f;
      for (int p = 0; p < PT_NPIX; ++p) v += s1b[p * COUT + i - COUT];
    } else if (i < 2 * COUT + N9 * COUT) {            // A
      const int j = i - 2 * COUT;
      v = red[(j / COUT) * NC + 32 + j % COUT];
    } else if (i < 2 * COUT + N9 * COUT + N9) {       // D: X'^T ones
      v = red[(i - 2 * COUT - N9 * COUT) * NC + N9];
    } else {                                          // G, upper triangle
      const int j = i - 2 * COUT - N9 * COUT - N9;
      const int r = j / N9, s = j % N9;
      v = s >= r ? red[r * NC + s] : 0.f;
    }
    row[i] = v;
  }
}

// whether bwdg runs on the tensor cores (bwdg_tc_kernel) for this shape
bool bwdg_tensor_core(int Cin, int Cout) {
  return Cin >= 1 && Cin <= 3 && (Cout == 16 || Cout == 32);
}

using BwdgTc = void (*)(const __nv_bfloat16*, const __nv_bfloat16*,
                        const __nv_bfloat16*, const int8_t*, const float*,
                        const float*, const float*, const float*, float*,
                        int, int, int);

BwdgTc bwdg_tc_instance(int Cin, int Cout) {
  if (Cout == 16)
    return Cin == 1 ? bwdg_tc_kernel<1, 16>
         : Cin == 2 ? bwdg_tc_kernel<2, 16> : bwdg_tc_kernel<3, 16>;
  return Cin == 1 ? bwdg_tc_kernel<1, 32>
       : Cin == 2 ? bwdg_tc_kernel<2, 32> : bwdg_tc_kernel<3, 32>;
}

// the persistent grid of the shape's bwdg kernel: min(items, the blocks
// resident at once); *smem its dynamic shared memory. -1 on failure.
int bwdg_grid(int B, int H, int W, int Cin, int Cout, int* smem) {
  const void* fn;
  if (bwdg_tensor_core(Cin, Cout)) {
    *smem = 0;
    fn = reinterpret_cast<const void*>(bwdg_tc_instance(Cin, Cout));
  } else {
    *smem = bwdg_layout(Cin, Cout).total_bytes;
    fn = reinterpret_cast<const void*>(bwdg_kernel);
    if (cudaFuncSetAttribute(bwdg_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *smem) != cudaSuccess)
      return -1;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fn, PT_THREADS, *smem) != cudaSuccess ||
      per_sm < 1)
    return -1;
  const int H2 = H / 2, W2 = W / 2;
  const long long items = static_cast<long long>(B) *
                          ((H2 + PT_PT - 1) / PT_PT) *
                          ((W2 + PT_PT - 1) / PT_PT);
  if (items > 0x7fffffff) return -1;
  return static_cast<int>(items < static_cast<long long>(sms) * per_sm
                              ? items
                              : static_cast<long long>(sms) * per_sm);
}

// ------------------------------------------------------------------------
// The tensor-core conv tile of fwdstats, red and dy (Cin a multiple of 16;
// see the note at the top) and of the batch-1 stem (CT_STEM, below).
// Modes of conv_tc_body:
enum { CT_FWDSTATS = 0, CT_RED = 1, CT_DY = 2, CT_STEM = 3, CT_FWD = 4 };
// the conv path of a launch (conv_path): the FP32-core loop, the tile,
// the tile with the taps fold (fwdstats and the stem at Cin <= 3)
enum { CP_FP32 = 0, CP_TILE = 1, CP_FOLD = 2 };
#define PT_MAX_CIN_STEM 128              // plan_pairs' widest pair output
// The stem's channel group at Cout a multiple of 32 (else 16); a
// measurement switch of tools/b1_stem_ab.py --variants
#ifndef PT_STEM_NC
#define PT_STEM_NC 32
#endif
#define CT_CH 16                         // input channels of a k16 step
#define CT_HALO (PT_TH * PT_TH * 32)     // bytes of one staged halo chunk
#define CT_NS 4                          // halo chunks in the ring
#define FD_ROW 128                       // fold: bytes of a staged halo row
#define FD_SLOT (PT_TH * FD_ROW)         // fold: bytes of a ring slot
#define FD_XP (PT_FULL * PT_FULL * 64)   // fold: X' [256 positions x 32]
// A measurement switch of tools/fwdstats_fold_ab.py --variants, 0 in the
// library: the fold without its epilogue (1), without building X' (2),
// with the statistics summed in float32 (3)
#ifndef PT_FOLD_PROBE
#define PT_FOLD_PROBE 0
#endif

// byte offset of 16-byte unit u of row r (U units a row), the units
// XOR-swizzled by the low bits of `key`, so that the rows of eight
// consecutive keys, one unit, fall in eight distinct 16-byte bank groups
template <int U>
__device__ __forceinline__ int swzu(int r, int key, int u) {
  constexpr int SH = U == 2 ? 2 : 1;
  static_assert(U == 2 || U == 4, "units a row");
  return r * 16 * U + ((u ^ ((key >> SH) & (U - 1))) << 4);
}

// two 8x8 b16 matrices (row addresses from lanes 0..15), each transposed
__device__ __forceinline__ void ldmatrix_x2_trans(unsigned addr, unsigned& r0,
                                                  unsigned& r1) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr)
      : "memory");
}

struct ConvTcLayout {                // byte offsets in shared memory
  int w, halo, xp, dys, kc, dws, total;
};

// the weights [k16 step (chunk, tap)][16 ci][nc co] bf16 (the fold: [32
// rows t * Cin + ci, zero past 9 Cin][nc co]), CT_NS halo chunks (the
// fold: ring slots of 18 rows x FD_ROW bytes) and the fold's two X', dy's
// tile [256 positions][nc] bf16 ("dy" only), the per-channel constants
// [7][nc] float32 and dw's running sums ("dy" only: [warp][5 tiles][4]
// [lane] float32)
__host__ __device__ inline ConvTcLayout conv_tc_layout(int mode, int Cin,
                                                       int nc, bool fold) {
  ConvTcLayout L;
  L.w = 0;
  L.halo = (fold ? 32 : 9 * Cin) * nc * 2;
  L.xp = L.halo + CT_NS * (fold ? FD_SLOT : CT_HALO);
  L.dys = L.xp + (fold ? 2 * FD_XP : 0);
  L.kc = L.dys + (mode == CT_DY ? PT_FULL * PT_FULL * nc * 2 : 0);
  L.dws = L.kc + 7 * nc * 4;
  L.total = L.dws + (mode == CT_DY ? 8 * 5 * 4 * 32 * 4 : 0);
  return L;
}

// The tiles blockIdx.x, + gridDim.x, ... of a persistent block, as
// (image b, pooled tile row ty, column tx): next() steps to the following
// one with adds and compares, not the divisions a tile index needs
struct TileWalk {
  int b, ty, tx;
  int sb, sty, stx, tiles_x, tiles_y;
  __device__ TileWalk(int tx_n, int ty_n) : tiles_x(tx_n), tiles_y(ty_n) {
    const int tiles = tx_n * ty_n, step = gridDim.x % tiles;
    b = blockIdx.x / tiles;
    ty = blockIdx.x % tiles / tx_n;
    tx = blockIdx.x % tiles % tx_n;
    sb = gridDim.x / tiles;
    sty = step / tx_n;
    stx = step % tx_n;
  }
  __device__ void next() {
    tx += stx;
    const bool cx = tx >= tiles_x;
    tx -= cx ? tiles_x : 0;
    ty += sty + cx;
    const bool cy = ty >= tiles_y;
    ty -= cy ? tiles_y : 0;
    b += sb + cy;
  }
};

// The taps fold's X' row p = tid (position fy = p / 16, fx = p % 16 of
// the tile): column t * Cin + ci holds x at (gy0 + fy + t / 3, gx0 + fx +
// t % 3, ci), 0 outside the image and in columns 9 Cin..31; 16-byte
// units XOR-swizzled by the row (swzu<4>), so that an ldmatrix phase
// (eight consecutive positions, one unit) hits eight bank groups. For
// one tap row ky the 3 Cin values (taps 3 ky .. 3 ky + 2, every ci) are
// contiguous in the staged halo row fy + ky, from byte o + 2 Cin fx (o:
// the row's offset in its span): read as 4-byte words and funnel-shifted
// by 2 bytes where that byte is not a multiple of 4. No division.
template <int FOLD>
__device__ __forceinline__ void fold_xprime(const unsigned char* slot,
                                            unsigned char* xp, int tid,
                                            int b, int gy0, int gx0, int H,
                                            int W) {
  constexpr int N = 3 * FOLD;               // values of a tap row
  constexpr int NV = (N + 1) / 2;           // their words once aligned
  const int fy = tid >> 4, fx = tid & 15;
  // word k of a tap row holds values 2k, 2k + 1 (tap kx = value / Cin):
  // keep a value where column gx0 + fx + kx lies in the image
  unsigned mk[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const auto in = [&](int j) {
      return j < N && static_cast<unsigned>(gx0 + fx + j / FOLD) <
                          static_cast<unsigned>(W);
    };
    mk[k] = (in(2 * k) ? 0xffffu : 0u) | (in(2 * k + 1) ? 0xffff0000u : 0u);
  }
  unsigned v[3][NV];
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
    const int hr = fy + ky;
    // byte of pixel gx0 of x's row gy0 + hr, mod 16 (unsigned wrap keeps
    // the residue for gx0 = -1)
    const unsigned o = (2u * FOLD *
                        (static_cast<unsigned>(b * H + gy0 + hr) *
                             static_cast<unsigned>(W) +
                         static_cast<unsigned>(gx0))) &
                       15u;
    const unsigned off = hr * FD_ROW + o + 2 * FOLD * fx;
    const unsigned* wp =
        reinterpret_cast<const unsigned*>(slot + (off & ~3u));
    unsigned wd[NV + 1];
#pragma unroll
    for (int k = 0; k <= NV; ++k) wd[k] = wp[k];
#pragma unroll
    for (int k = 0; k < NV; ++k)
      v[ky][k] = __funnelshift_r(wd[k], wd[k + 1], 8 * (off & 2u)) & mk[k];
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    unsigned wv[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      unsigned half[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * u + 2 * h + e;    // X' column t * Cin + ci
        const int ky = c / N, j = c % N;    // tap row, value in it
        half[e] = c < 3 * N
                      ? (v[ky < 3 ? ky : 0][j / 2] >> (16 * (j & 1))) & 0xffffu
                      : 0u;
      }
      wv[h] = half[0] | (half[1] << 16);
    }
    *reinterpret_cast<uint4*>(xp + swzu<4>(tid, tid, u)) =
        make_uint4(wv[0], wv[1], wv[2], wv[3]);
  }
}

// One block: output channels co0 = blockIdx.y * NC .. + NC - 1 of the
// pooled tiles blockIdx.x, + gridDim.x, ... (over the batch's B * tiles),
// each in Cin / 16 halo chunks streamed through a cp.async ring. The
// conv of a tile is a GEMM: M = its 16x16 positions, N = NC, K = 9 x Cin
// in k16 steps (chunk, tap), chunks outer, taps in row-major order: the
// same order in every mode, so red and dy recompute fwdstats' y bit for
// bit. Warp w owns full-resolution rows 2w, 2w + 1 (pooled row w): two
// m16 tiles, mt = columns 8 mt .. + 7, rows 0-7 of a tile at row 2w and
// 8-15 at row 2w + 1. A lane's accumulators then hold a vertical pair of
// a pool window for channels 2q, 2q + 1; __shfl_xor(., 4) brings the
// horizontal partner, after which the even-column lane owns the window
// of channel 2q and the odd one that of 2q + 1.
// k0, k1: fwdstats shift and scales (Cout,); red/dy the (7, Cout) rows
// mean, inv, scales, bias, c1, c2, c3 in k0.
// FOLD (fwdstats and the stem): 0, or Cin (1..3) for the taps fold: K =
// the 9 Cin (tap, ci) pairs in column t * Cin + ci of X' [256 positions x
// 32] (zero past 9 Cin), two k16 steps; the tile's A operand is then X',
// built a tile ahead in shared memory from the staged halo, and
// everything else is the same code.
// CT_STEM (the batch-1 serving stem, kernel 2): k0 the bias (Cout,)
// float32, z the output (B, H/2, W/2, Cout) bf16 = bf16(leaky_0.1(max of
// the window's four float32 sums + bias)); no statistics, no argmax, no
// partial rows. CT_FWD (the bf16 serving stem, kernel 4's mode "fwd"):
// the same with fwd's roundings (serve_out).
//
// The serving modes' value of a window from the maximum m of its four
// raw float32 sums: CT_STEM fl(m + b) and the 0.1f leaky, one rounding;
// CT_FWD v = bf16(m), zb = bf16(v + b) (b rounded to bf16), the bf16 slope
// 0.10009765625 and a rounding (zb * slope is exact in float32). Each
// step is nondecreasing in m, so either is its per-tap order's value.
template <int MODE>
__device__ __forceinline__ unsigned short serve_out(float m, float b) {
  if constexpr (MODE == CT_STEM) {
    const float v = __fadd_rn(m, b);
    return bf16_bits(v > 0.f ? v : __fmul_rn(0.1f, v));
  } else {
    const float zb = bf16r(__fadd_rn(bf16r(m), b));
    return bf16_bits(zb > 0.f ? zb : __fmul_rn(zb, 0.10009765625f));
  }
}

template <int MODE, int NC, int FOLD = 0>
__device__ __forceinline__ void conv_tc_body(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const __nv_bfloat16* __restrict__ dp, const float* __restrict__ k0,
    const float* __restrict__ k1, __nv_bfloat16* __restrict__ z,
    int8_t* __restrict__ am, __nv_bfloat16* __restrict__ dy,
    float* __restrict__ partial, int B, int H, int W, int Cin, int Cout) {
  constexpr int NT = NC / 8;         // n8 tiles; also 16-byte units a row
  constexpr bool FD = FOLD > 0;
  static_assert(FOLD >= 0 && FOLD <= 3 &&
                    (!FD || MODE == CT_FWDSTATS || MODE == CT_STEM ||
                     MODE == CT_FWD),
                "the taps fold serves fwdstats and the stems at Cin <= 3");
  constexpr bool SERVE = MODE == CT_STEM || MODE == CT_FWD;
  extern __shared__ __align__(128) unsigned char csm[];
  const ConvTcLayout L = conv_tc_layout(MODE, Cin, NC, FD);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const bool even = (g & 1) == 0;
  const int nch = FD ? 1 : Cin / CT_CH;
  const int co0 = blockIdx.y * NC;
  const int H2 = H / 2, W2 = W / 2;
  const int tiles_x = (W2 + PT_PT - 1) / PT_PT;
  const int tiles = tiles_x * ((H2 + PT_PT - 1) / PT_PT);
  const int ntl = (B * tiles - 1 - static_cast<int>(blockIdx.x)) /
                      static_cast<int>(gridDim.x) + 1;
  const int S = ntl * nch;           // (tile, chunk) stages of the block
  const unsigned smb = smem_u32(csm);
  // the group's constants [7][NC]: red and dy the rows of k0, the stems
  // its first (the bias; CT_FWD's rounded to bf16, as apply's); fwdstats
  // the shift as float64 (rows 2-3) and the sign mask that turns the
  // channel's extreme into a maximum (row 4: 0 where scales > 0, else the
  // bf16x2 sign bits), so no tile converts them
  float* kcs = reinterpret_cast<float*>(csm + L.kc);
  for (int i = tid; i < (MODE == CT_RED || MODE == CT_DY ? 7 * NC : NC);
       i += PT_THREADS) {
    const int c = co0 + i % NC;
    if constexpr (MODE == CT_FWDSTATS) {
      reinterpret_cast<double*>(kcs + 2 * NC)[i] = k0[c];
      reinterpret_cast<unsigned*>(kcs)[4 * NC + i] =
          k1[c] > 0.f ? 0u : 0x80008000u;
    } else if constexpr (MODE == CT_FWD) {
      kcs[i] = bf16r(k0[c]);
    } else {
      kcs[i] = k0[(i / NC) * Cout + c];
    }
  }
  // the weights: global row t * Cin + ci -> shared row (ci / 16 * 9 + t)
  // * 16 + ci % 16 (the fold: the same row, rows 9 Cin..31 zero); they
  // land with the first halo chunk's group
  for (int i = tid; i < (FD ? 32 : 9 * Cin) * NT; i += PT_THREADS) {
    const int row = i / NT, u = i % NT;
    const int t = row / Cin, ci = row % Cin;
    const int srow =
        FD ? row : ((ci / CT_CH) * 9 + t) * CT_CH + ci % CT_CH;
    const bool in = !FD || row < 9 * Cin;
    cp_async16(smb + L.w + swzu<NT>(srow, srow, u),
               in ? w + static_cast<size_t>(row) * Cout + co0 + 8 * u : w,
               in ? 16 : 0);
  }
  // the tiles of the ring's loads, of the fold's X' builds and of the
  // epilogue, each stepped once a tile
  const int tiles_y = tiles / tiles_x;
  TileWalk lw(tiles_x, tiles_y), bw(tiles_x, tiles_y), cw(tiles_x, tiles_y);
  // stage s = (the block's tile s / nch, chunk s % nch): the 18x18 halo's
  // 16 channels, 32 bytes a pixel, units swizzled by the halo column;
  // src-size 0 writes the zero padding. The fold: halo row hr, pixels
  // gx0 .. gx0 + 17 at byte a = 2 Cin ((b H + gy) W + gx0) of x, lies in
  // the 16-byte units from a & ~15 on, at byte a & 15 of slot row hr
  // (FD_ROW bytes); units before x, past its end or of a row outside the
  // image are zero-filled, and the pixels outside the image that a span
  // holds are masked where X' is built. An empty group past the last
  // stage.
  auto load = [&](int s) {
    if (s < S) {
      const int b = lw.b;
      const int gy0 = 2 * PT_PT * lw.ty - 1, gx0 = 2 * PT_PT * lw.tx - 1;
      if constexpr (FD) {
        constexpr int NU = (36 * FOLD + 29) / 16;  // units covering a row
        const unsigned st = smb + L.halo + (s % CT_NS) * FD_SLOT;
        const long long total = 2LL * FOLD * B * H * W;
        if (tid < PT_TH * NU) {
          const int hr = tid / NU, u = tid % NU;
          const int gy = gy0 + hr;
          const long long a =
              2LL * FOLD * ((static_cast<long long>(b) * H + gy) * W + gx0);
          const long long rel = (a & ~15LL) + 16 * u;
          const int n = gy < 0 || gy >= H || rel < 0 || rel >= total ? 0
                        : total - rel < 16 ? static_cast<int>(total - rel)
                                           : 16;
          cp_async16(st + hr * FD_ROW + 16 * u,
                     n ? reinterpret_cast<const unsigned char*>(x) + rel
                       : reinterpret_cast<const unsigned char*>(x),
                     n);
        }
      } else {
        const int ch = s % nch;
        const unsigned st = smb + L.halo + (s % CT_NS) * CT_HALO;
        for (int i = tid; i < PT_TH * PT_TH * 2; i += PT_THREADS) {
          const int p = i >> 1, u = i & 1;
          const int hx = p % PT_TH;
          const int gy = gy0 + p / PT_TH, gx = gx0 + hx;
          const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
          cp_async16(st + swzu<2>(p, hx, u),
                     in ? x + ((static_cast<size_t>(b) * H + gy) * W + gx) *
                                  Cin + ch * CT_CH + 8 * u
                        : x,
                     in ? 16 : 0);
        }
      }
      if (s % nch == nch - 1) lw.next();
    }
    cp_async_commit();
  };

  // ldmatrix row addresses. Conv A (positions x 16 ci): lane l, matrix
  // j = l / 8, row 2w + j % 2 of the tile, column 8 mt + l % 8, unit
  // j / 2, at the tap's shift (ky rows, kx columns); the fold: X' row p =
  // that position (fy * 16 + fx), unit 2 ks + j / 2 (a_off[mt][ks], from
  // the start of shared memory). Conv B (16 ci x NC co, .trans): row
  // l % 8 + 8 ((l / 8) % 2), unit 2 pr + l / 16.
  int a_off[2][3];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const int hc = 8 * mt + (lane & 7) + kx;
      const int p = (2 * warp + ((lane >> 3) & 1)) * PT_FULL + hc - kx;
      a_off[mt][kx] =
          FD ? L.xp + swzu<4>(p, p, (2 * kx + (lane >> 4)) & 3)
             : swzu<2>((2 * warp + ((lane >> 3) & 1)) * PT_TH + hc, hc,
                       lane >> 4);
    }
  int b_off[NT / 2];
  const int krow = (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int pr = 0; pr < NT / 2; ++pr)
    b_off[pr] = L.w + swzu<NT>(krow, krow, 2 * pr + (lane >> 4));
  // dy's weight gradient: dw[(t, ci)][co] += sum over the tile's
  // positions p of x(p + tap t, ci) * dy(p, co), M = (t, ci), N = NC,
  // K = positions, a k16 step per full-resolution row. Warp w owns the
  // (tap, n8 tile) accumulator tiles w, w + 8, ... < 9 NT: its n8 tile
  // ntw = w % NT and the taps (w + 8 j) / NT. A (.trans from the halo):
  // lane l, column (l % 8) + 8 (l / 16), unit (l / 8) % 2; B (.trans from
  // dy's tile): lanes 0-15, position l % 16, unit ntw.
  const int ntw = warp % NT;
  const int dwa_fx = (lane & 7) + 8 * (lane >> 4), dwa_u = (lane >> 3) & 1;
  const int dyb_off = L.dys + swzu<NT>(lane & 15, lane & 15, ntw);

  float acc[2][NT][4];
  float sink = 0.f;                  // PT_FOLD_PROBE 1: keeps the products
  // fwdstats, red: the sums of the thread's channels over its windows.
  // fwdstats sums in float64: the chain's BN backward (c1..c3) turns a
  // 1e-6 error of the variance into per cent of the weight gradient
  // (its dy is a sum with heavy cancellation, and a per-channel offset
  // of c1 moves the bf16 rounding of dy one way), so the statistics are
  // kept exact to float32's last bits
  using Acc = typename std::conditional<
      MODE == CT_FWDSTATS && !(FD && PT_FOLD_PROBE == 3), double,
      float>::type;
  Acc run0[NT], run1[NT];
  float dwacc[5][4];                 // dy: the warp's dw tiles, one tile
  // dy: dw's running sums over the block's tiles, one slot a thread and
  // entry. The tensor cores add into their accumulators with truncation
  // (not round-to-nearest), a bias that a sum over thousands of steps
  // with heavy cancellation would grow; a tile's 16 steps stay in
  // registers and the tiles are added with float32 round-to-nearest.
  float* dws = reinterpret_cast<float*>(csm + L.dws) + warp * 5 * 4 * 32 +
               lane;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) run0[nt] = run1[nt] = 0.f;
  if constexpr (MODE == CT_DY)
#pragma unroll
    for (int j = 0; j < 5; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dws[(j * 4 + e) * 32] = 0.f;

  for (int s = 0; s < CT_NS - 1; ++s) load(s);
  // the fold builds tile s's X' into buffer s % 2 while tile s - 1's
  // products and epilogue run: one barrier a tile
  auto build = [&](int s) {
    if constexpr (FD && PT_FOLD_PROBE != 2)
      fold_xprime<FOLD>(csm + L.halo + s % CT_NS * FD_SLOT,
                        csm + L.xp + (s & 1) * FD_XP, tid, bw.b,
                        2 * PT_PT * bw.ty - 1, 2 * PT_PT * bw.tx - 1, H, W);
    bw.next();
  };
  if constexpr (FD) {
    cp_async_wait<CT_NS - 2>();      // tile 0's halo and the weights
    __syncthreads();
    if (S > 0) build(0);
  }
  for (int s = 0; s < S; ++s) {
    // stage s (the fold: tile s + 1's halo; tile s's X') has landed for
    // all, and s - 1 is done
    if constexpr (FD)
      cp_async_wait<CT_NS - 3>();
    else
      cp_async_wait<CT_NS - 2>();
    __syncthreads();
    load(s + CT_NS - 1);
    const int ch = s % nch;
    if (ch == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
    const unsigned st = smb + L.halo + (s % CT_NS) * CT_HALO;
    if constexpr (FD) {
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        unsigned bfr[NT / 2][4];
#pragma unroll
        for (int pr = 0; pr < NT / 2; ++pr)
          ldmatrix_x4_trans(smb + b_off[pr] + ks * CT_CH * NT * 16, bfr[pr]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          unsigned a[4];
          ldmatrix_x4(smb + a_off[mt][ks] + (s & 1) * FD_XP, a);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_bf16(acc[mt][nt], a, bfr[nt / 2][2 * (nt % 2)],
                     bfr[nt / 2][2 * (nt % 2) + 1]);
        }
      }
      if (s + 1 < S) build(s + 1);
    } else {
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        unsigned bfr[NT / 2][4];
#pragma unroll
        for (int pr = 0; pr < NT / 2; ++pr)
          ldmatrix_x4_trans(smb + b_off[pr] + (ch * 9 + t) * CT_CH * NT * 16,
                            bfr[pr]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          unsigned a[4];
          ldmatrix_x4(st + a_off[mt][t % 3] + (t / 3) * PT_TH * 32, a);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_bf16(acc[mt][nt], a, bfr[nt / 2][2 * (nt % 2)],
                     bfr[nt / 2][2 * (nt % 2) + 1]);
        }
      }
    }
    if (ch != nch - 1) continue;
    if constexpr (FD && MODE == CT_FWDSTATS && PT_FOLD_PROBE == 1) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sink += acc[mt][nt][e];
      cw.next();
      continue;
    }

    // ---- the tile's epilogue
    const int b = cw.b, ty = cw.ty, tx = cw.tx;
    cw.next();
    const int oy = ty * PT_PT + warp;
    if constexpr (SERVE) {
      // The window's maximum of the raw float32 sums, then bias and leaky
      // once (serve_out): the value of the per-tap order (up to the sign
      // of a zero) of stem_pair_kernel (CT_STEM) or of fwdstats + apply
      // (CT_FWD).
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = 8 * nt + 2 * q + (g & 1);    // the window's channel
        unsigned short o[2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          // the vertical pair's maximum of channels 2q and 2q + 1; the
          // horizontal partner's from lane ^ 4
          const float m0 = fmaxf(acc[mt][nt][0], acc[mt][nt][2]);
          const float m1 = fmaxf(acc[mt][nt][1], acc[mt][nt][3]);
          const float r = __shfl_xor_sync(0xffffffffu, even ? m1 : m0, 4);
          o[mt] = serve_out<MODE>(fmaxf(even ? m0 : m1, r), kcs[c]);
        }
        // channels 8 nt + 2 q, + 1 of a pixel: the even lane stores mt 0's,
        // the odd one mt 1's
        const unsigned zz = o[0] | (static_cast<unsigned>(o[1]) << 16);
        const unsigned zo = __shfl_xor_sync(0xffffffffu, zz, 4);
        const int sx = tx * PT_PT + 4 * (g & 1) + (g >> 1);
        if (oy < H2 && sx < W2)
          *reinterpret_cast<unsigned*>(
              z + ((static_cast<size_t>(b) * H2 + oy) * W2 + sx) * Cout +
              co0 + 8 * nt + 2 * q) = even ? __byte_perm(zz, zo, 0x5410)
                                           : __byte_perm(zo, zz, 0x7632);
      }
      continue;
    }
    unsigned wlo[NT][2];               // fwdstats: mt 0's windows
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int ox = tx * PT_PT + 4 * mt + (g >> 1);
      const bool valid = oy < H2 && ox < W2;
      const size_t o = ((static_cast<size_t>(b) * H2 + oy) * W2 + ox) * Cout;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = 8 * nt + 2 * q + (g & 1);    // the window's channel
        float y[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) y[e] = bf16r(acc[mt][nt][e]);
        const float ra = __shfl_xor_sync(0xffffffffu, even ? y[1] : y[0], 4);
        const float rb = __shfl_xor_sync(0xffffffffu, even ? y[3] : y[2], 4);
        // the window in row-major order: (0,0) (0,1) (1,0) (1,1)
        const float v[4] = {even ? y[0] : ra, even ? ra : y[1],
                            even ? y[2] : rb, even ? rb : y[3]};
        if constexpr (MODE == CT_FWDSTATS) {
          const Acc sh = static_cast<Acc>(
              reinterpret_cast<const double*>(kcs + 2 * NC)[c]);
          Acc s0 = 0, s1 = 0;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const Acc d = static_cast<Acc>(v[k]) - sh;
            s0 += d;
            s1 += d * d;
          }
          if (valid) {
            run0[nt] += s0;
            run1[nt] += s1;
          }
          if (mt == 0) {
            // mt 0's window, bf16 bits two a word, until mt 1's joins it
            wlo[nt][0] = __byte_perm(__float_as_uint(v[0]),
                                     __float_as_uint(v[1]), 0x7632);
            wlo[nt][1] = __byte_perm(__float_as_uint(v[2]),
                                     __float_as_uint(v[3]), 0x7632);
            continue;
          }
          // Both windows of the channel at once as bf16x2 (low half mt 0,
          // high half mt 1): the extreme in the direction of the
          // channel's BN slope (the monotone BN + bias + leaky map then
          // commutes with the pool; the minimum as the maximum of the
          // negated values) and the first tap attaining it
          const unsigned flip =
              reinterpret_cast<const unsigned*>(kcs)[4 * NC + c];
          unsigned wk[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            wk[k] = __byte_perm(wlo[nt][k / 2], __float_as_uint(v[k]),
                                k % 2 ? 0x7632 : 0x7610) ^ flip;
          const unsigned m = hmax2(hmax2(wk[0], wk[1]), hmax2(wk[2], wk[3]));
          unsigned kf = 0x00030003u;
#pragma unroll
          for (int k = 2; k >= 0; --k) {
            const unsigned e = heq2(wk[k], m);
            kf = (kf & ~e) | (0x00010001u * k & e);
          }
          const unsigned zz = m ^ flip;
          const unsigned zo = __shfl_xor_sync(0xffffffffu, zz, 4);
          const unsigned ko = __shfl_xor_sync(0xffffffffu, kf, 4);
          // channels 8 nt + 2 q, + 1 of a pixel: the even lane stores mt
          // 0's, the odd one mt 1's
          const int sx = tx * PT_PT + 4 * (g & 1) + (g >> 1);
          if (oy < H2 && sx < W2) {
            const size_t os = ((static_cast<size_t>(b) * H2 + oy) * W2 + sx) *
                                  Cout + co0 + 8 * nt + 2 * q;
            *reinterpret_cast<unsigned*>(z + os) =
                even ? __byte_perm(zz, zo, 0x5410)
                     : __byte_perm(zo, zz, 0x7632);
            *reinterpret_cast<unsigned short*>(am + os) =
                static_cast<unsigned short>(
                    even ? (kf & 0xffu) | ((ko & 0xffu) << 8)
                         : ((ko >> 16) & 0xffu) | ((kf >> 8) & 0xff00u));
          }
        } else {
          // the exact expressions of chain_bwd_kernel
          const float mean = kcs[c], inv = kcs[NC + c];
          const float sc = kcs[2 * NC + c], bias = bf16r(kcs[3 * NC + c]);
          float xm[4], xh[4], a[4];
          bool pos[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            xm[k] = __fsub_rn(v[k], mean);
            xh[k] = __fmul_rn(xm[k], inv);
            const float zz =
                bf16r(__fadd_rn(bf16r(__fmul_rn(xh[k], sc)), bias));
            pos[k] = zz > 0.f;
            a[k] = pos[k] ? zz : bf16r(__fmul_rn(0.10009765625f, zz));
          }
          const float m = fmaxf(fmaxf(a[0], a[1]), fmaxf(a[2], a[3]));
          int first = 3;
#pragma unroll
          for (int k = 3; k >= 0; --k)
            if (a[k] == m) first = k;  // the first tap attaining the max
          const float gct =
              valid ? __bfloat162float(dp[o + co0 + c]) : 0.f;
          const float neg = bf16r(__fmul_rn(0.10009765625f, gct));
          float s0 = 0.f, s1 = 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float dz = k == first ? (pos[k] ? gct : neg) : 0.f;
            if constexpr (MODE == CT_DY) {
              const float d = bf16r(__fadd_rn(
                  __fadd_rn(__fmul_rn(dz, kcs[4 * NC + c]),
                            __fmul_rn(xm[k], kcs[5 * NC + c])),
                  kcs[6 * NC + c]));
              const int p = (2 * warp + (k >> 1)) * PT_FULL + 8 * mt +
                            2 * (g >> 1) + (k & 1);
              *reinterpret_cast<unsigned short*>(
                  csm + L.dys + swzu<NT>(p, p, nt) + 2 * (c % 8)) =
                  valid ? bf16_bits(d) : static_cast<unsigned short>(0);
            } else {
              s0 += dz;
              s1 += dz * xh[k];
            }
          }
          if constexpr (MODE == CT_RED) {
            if (valid) {
              run0[nt] += s0;
              run1[nt] += s1;
            }
          }
        }
      }
    }
    if constexpr (MODE == CT_DY) {
      __syncthreads();               // the tile's dy is in shared memory
      // dy to device memory, 16 bytes a store, a pixel's NC channels
      // contiguous
      for (int i = tid; i < PT_FULL * PT_FULL * NT; i += PT_THREADS) {
        const int p = i / NT, u = i % NT;
        const int gy = 2 * PT_PT * ty + (p >> 4);
        const int gx = 2 * PT_PT * tx + (p & 15);
        if (gy < H && gx < W)
          *reinterpret_cast<uint4*>(
              dy + ((static_cast<size_t>(b) * H + gy) * W + gx) * Cout +
              co0 + 8 * u) =
              *reinterpret_cast<const uint4*>(csm + L.dys + swzu<NT>(p, p, u));
      }
      // the weight gradient on the tensor cores: both operands run along
      // K (the positions), so both come from ldmatrix.trans
#pragma unroll
      for (int j = 0; j < 5; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dwacc[j][e] = 0.f;
#pragma unroll 1
      for (int ks = 0; ks < PT_FULL; ++ks) {
        unsigned b0, b1;
        ldmatrix_x2_trans(smb + dyb_off + ks * PT_FULL * NT * 16, b0, b1);
#pragma unroll
        for (int j = 0; j < 5; ++j) {
          const int i = warp + 8 * j;
          if (i < 9 * NT) {
            const int t = i / NT, hc = dwa_fx + t % 3;
            unsigned a[4];
            ldmatrix_x4_trans(
                st + swzu<2>((ks + t / 3) * PT_TH + hc, hc, dwa_u), a);
            mma_bf16(dwacc[j], a, b0, b1);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 5; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dws[(j * 4 + e) * 32] += dwacc[j][e];
    }
  }

  cp_async_wait<0>();
  __syncthreads();                   // the ring is free
  if constexpr (FD && MODE == CT_FWDSTATS && PT_FOLD_PROBE == 1)
    if (sink == 1.5f) partial[blockIdx.x] = sink;
  if constexpr (MODE == CT_DY) {
    // partial row blockIdx.x: dw in HWIO order (Cin 16: row t * 16 + ci)
    float* row = partial + static_cast<size_t>(blockIdx.x) * 9 * Cin * Cout;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const int i = warp + 8 * j;
      if (i < 9 * NT) {
        const int t = i / NT;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          row[(t * CT_CH + g + 8 * (e >> 1)) * Cout + co0 + 8 * ntw + 2 * q +
              (e & 1)] = dws[(j * 4 + e) * 32];
      }
    }
  } else if constexpr (!SERVE) {
    // the lanes of a channel (lane bits 3, 4), then the warps in order
    Acc* red = reinterpret_cast<Acc*>(csm + L.halo);   // [8][2][NC]
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        Acc v = k ? run1[nt] : run0[nt];
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < 8) red[(warp * 2 + k) * NC + 8 * nt + 2 * q + g] = v;
      }
    __syncthreads();
    if (tid < 2 * NC) {
      const int k = tid / NC, c = tid % NC;
      Acc v = 0;
      for (int wi = 0; wi < PT_THREADS / 32; ++wi)
        v += red[(wi * 2 + k) * NC + c];
      partial[static_cast<size_t>(blockIdx.x) * 2 * Cout + k * Cout + co0 +
              c] = static_cast<float>(v);
    }
  }
}

// The three modes as kernels of their own (names the profiler shows)
#define CONV_TC_PARAMS                                                      \
  const __nv_bfloat16 *__restrict__ x, const __nv_bfloat16 *__restrict__ w, \
      const __nv_bfloat16 *__restrict__ dp, const float *__restrict__ k0,   \
      const float *__restrict__ k1, __nv_bfloat16 *__restrict__ z,          \
      int8_t *__restrict__ am, __nv_bfloat16 *__restrict__ dy,              \
      float *__restrict__ partial, int B, int H, int W, int Cin, int Cout
#define CONV_TC_ARGS x, w, dp, k0, k1, z, am, dy, partial, B, H, W, Cin, Cout

template <int NC>
__global__ void __launch_bounds__(PT_THREADS, 2)
fwdstats_tc_kernel(CONV_TC_PARAMS) {
  conv_tc_body<CT_FWDSTATS, NC>(CONV_TC_ARGS);
}

template <int NC>
__global__ void __launch_bounds__(PT_THREADS, 2)
red_tc_kernel(CONV_TC_PARAMS) {
  conv_tc_body<CT_RED, NC>(CONV_TC_ARGS);
}

template <int NC>
__global__ void __launch_bounds__(PT_THREADS, 2)
dy_tc_kernel(CONV_TC_PARAMS) {
  conv_tc_body<CT_DY, NC>(CONV_TC_ARGS);
}

// fwdstats at Cin = CIN <= 3: the tile with the taps fold; three blocks
// an SM at NC 16 (about 44 KB of shared memory each; NC 32 spills at the
// 80 registers that allows, so it takes two)
template <int CIN, int NC>
__global__ void __launch_bounds__(PT_THREADS, NC == 16 ? 3 : 2)
fwdstats_fold_kernel(CONV_TC_PARAMS) {
  conv_tc_body<CT_FWDSTATS, NC, CIN>(CONV_TC_ARGS);
}

// The batch-1 stem (kernel 2) on the tile, and at Cin <= 3 on its taps
// fold
template <int NC>
__global__ void __launch_bounds__(PT_THREADS, 2)
stem_tc_kernel(CONV_TC_PARAMS) {
  conv_tc_body<CT_STEM, NC>(CONV_TC_ARGS);
}

template <int CIN, int NC>
__global__ void __launch_bounds__(PT_THREADS, NC == 16 ? 3 : 2)
stem_fold_kernel(CONV_TC_PARAMS) {
  conv_tc_body<CT_STEM, NC, CIN>(CONV_TC_ARGS);
}

// The bf16 serving stem (kernel 4's mode "fwd") on the tile, and at Cin
// <= 3 on its taps fold
template <int NC>
__global__ void __launch_bounds__(PT_THREADS, 2)
fwd_tc_kernel(CONV_TC_PARAMS) {
  conv_tc_body<CT_FWD, NC>(CONV_TC_ARGS);
}

template <int CIN, int NC>
__global__ void __launch_bounds__(PT_THREADS, NC == 16 ? 3 : 2)
fwd_fold_kernel(CONV_TC_PARAMS) {
  conv_tc_body<CT_FWD, NC, CIN>(CONV_TC_ARGS);
}

using ConvTc = void (*)(const __nv_bfloat16*, const __nv_bfloat16*,
                        const __nv_bfloat16*, const float*, const float*,
                        __nv_bfloat16*, int8_t*, __nv_bfloat16*, float*, int,
                        int, int, int, int);

// the conv path of fwdstats, red, dy and the two stems for a shape: the
// tensor-core tile for Cin a multiple of 16 in every mode (so the chain's
// forward and backward compute one y; the batch-1 stem up to
// PT_MAX_CIN_STEM), the tile with the taps fold for fwdstats and the
// stems at Cin <= 3 (red and dy take Cin a multiple of 8), else the
// FP32-core loop (the batch-1 stem's: stem_pair_kernel, csrc/b1_stem.cu;
// the bf16 serving stem's: fwdstats_kernel + apply_kernel)
int conv_path(int mode, int Cin, int Cout) {
  if (Cin <= 0 || Cout <= 0 || Cout % 16 ||
      (mode == CT_STEM && Cin > PT_MAX_CIN_STEM))
    return CP_FP32;
  if (Cin % CT_CH == 0) return CP_TILE;
  return (mode == CT_FWDSTATS || mode == CT_STEM || mode == CT_FWD) &&
                 Cin <= 3
             ? CP_FOLD
             : CP_FP32;
}

// the kernel of a mode at NC, on the taps fold or not
template <int NC>
ConvTc conv_tc_kernel(int mode, int Cin, bool fold) {
  if (fold && mode == CT_STEM)
    return Cin == 1   ? stem_fold_kernel<1, NC>
           : Cin == 2 ? stem_fold_kernel<2, NC>
                      : stem_fold_kernel<3, NC>;
  if (fold && mode == CT_FWD)
    return Cin == 1   ? fwd_fold_kernel<1, NC>
           : Cin == 2 ? fwd_fold_kernel<2, NC>
                      : fwd_fold_kernel<3, NC>;
  if (fold)
    return Cin == 1   ? fwdstats_fold_kernel<1, NC>
           : Cin == 2 ? fwdstats_fold_kernel<2, NC>
                      : fwdstats_fold_kernel<3, NC>;
  return mode == CT_FWDSTATS ? fwdstats_tc_kernel<NC>
         : mode == CT_RED    ? red_tc_kernel<NC>
         : mode == CT_DY     ? dy_tc_kernel<NC>
         : mode == CT_FWD    ? fwd_tc_kernel<NC>
                             : stem_tc_kernel<NC>;
}

// launches mode `mode` of the tile (the fold where conv_path says so):
// grid (n, Cout / NC), n = min(the tiles, rows_cap, the blocks resident
// at once / groups); *nblk = n, the partial rows written. NC = 32 where
// Cout allows (the batch-1 stem: PT_STEM_NC), else 16.
int conv_tc_launch(int mode, const void* x, const void* w, const void* dp,
                   const void* k0, const void* k1, void* z, void* am,
                   void* dy, void* partial, int B, int H, int W, int Cin,
                   int Cout, long long rows_cap, int* nblk, cudaStream_t s) {
  const int nc =
      Cout % 32 == 0 && (mode != CT_STEM || PT_STEM_NC == 32) ? 32 : 16;
  const int path = conv_path(mode, Cin, Cout);
  const bool fold = path == CP_FOLD;
  const ConvTc fn = nc == 32 ? conv_tc_kernel<32>(mode, Cin, fold)
                             : conv_tc_kernel<16>(mode, Cin, fold);
  const int smem = conv_tc_layout(mode, Cin, nc, fold).total;
  const int H2 = H / 2, W2 = W / 2;
  const long long tiles = static_cast<long long>(B) *
                          ((H2 + PT_PT - 1) / PT_PT) *
                          ((W2 + PT_PT - 1) / PT_PT);
  const int groups = Cout / nc;
  int dev = 0, sms = 0, per_sm = 0;
  if (path == CP_FP32 || (mode == CT_DY && Cin != CT_CH) ||
      tiles < 1 || tiles > 0x7fffffff || rows_cap < 1 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(dy)) % 16 ||
      reinterpret_cast<uintptr_t>(z) % 4 ||
      reinterpret_cast<uintptr_t>(am) % 2 ||
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, PT_THREADS,
                                                    smem) != cudaSuccess ||
      per_sm < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  long long n = static_cast<long long>(sms) * per_sm / groups;
  n = n < 1 ? 1 : n;
  n = n < tiles ? n : tiles;
  n = n < rows_cap ? n : rows_cap;
  *nblk = static_cast<int>(n);
  fn<<<dim3(*nblk, groups), PT_THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(dp), static_cast<const float*>(k0),
      static_cast<const float*>(k1), static_cast<__nv_bfloat16*>(z),
      static_cast<int8_t*>(am), static_cast<__nv_bfloat16*>(dy),
      static_cast<float*>(partial), B, H, W, Cin, Cout);
  return static_cast<int>(cudaGetLastError());
}

bool shapes_ok(int B, int H, int W, int Cin, int Cout, int max_cin,
               int max_cout) {
  return B > 0 && B <= 65535 && H > 0 && W > 0 && H % 2 == 0 && W % 2 == 0 &&
         Cin > 0 && Cin <= max_cin && Cout > 0 && Cout % PT_CO == 0 &&
         Cout <= max_cout;
}

}  // namespace

// partial: (B * tiles, 2 * Cout) float32 scratch (the tensor-core tile
// uses its first rows, one a block); stats: (2 * Cout,) float32 out,
// [sum(y - shift) | sum((y - shift)^2)]. Cin a multiple of 16 runs the
// tensor-core tile (fwdstats_tc_kernel), Cin <= 3 the tile with the taps
// fold (fwdstats_fold_kernel), the rest the FP32-core loop (conv_path).
// x and w 16-byte aligned on the tile's paths.
extern "C" int srod_pt_fwdstats(const void* x, const void* w,
                                const void* shift, const void* scales,
                                void* z, void* am, void* partial, void* stats,
                                int B, int H, int W, int Cin, int Cout,
                                void* stream) {
  if (!shapes_ok(B, H, W, Cin, Cout, PT_MAX_CIN_FWD, PT_MAX_CO_FWD))
    return static_cast<int>(cudaErrorInvalidValue);
  const int H2 = H / 2, W2 = W / 2;
  const int tiles = ((H2 + PT_PT - 1) / PT_PT) * ((W2 + PT_PT - 1) / PT_PT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rows = B * tiles;
  if (conv_path(CT_FWDSTATS, Cin, Cout) != CP_FP32) {
    const int err = conv_tc_launch(CT_FWDSTATS, x, w, nullptr, shift, scales,
                                   z, am, nullptr, partial, B, H, W, Cin,
                                   Cout, rows, &rows, s);
    if (err != cudaSuccess) return err;
  } else {
    fwdstats_kernel<<<dim3(tiles, Cout / PT_CO, B), PT_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<const float*>(shift), static_cast<const float*>(scales),
        static_cast<__nv_bfloat16*>(z), static_cast<int8_t*>(am),
        static_cast<float*>(partial), H, W, Cin, Cout);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  colsum_kernel<<<2 * Cout, PT_THREADS, 0, s>>>(
      static_cast<const float*>(partial), rows, 2 * Cout,
      static_cast<float*>(stats));
  return static_cast<int>(cudaGetLastError());
}

// The conv path srod_pt_fwdstats (mode 0), srod_pt_red (1), srod_pt_dy
// (2), the batch-1 stem (3) and the bf16 serving stem (4) run for a
// shape: 1 the tensor-core tile (Cin a multiple of 16), 2 the tile with
// the taps fold (fwdstats and the stems at Cin <= 3), 0 the FP32-core
// loop (the batch-1 stem: srod_stem_pair; the serving stem:
// srod_pt_fwdstats + srod_pt_apply).
extern "C" int srod_pt_conv_tensor_core(int mode, int Cin, int Cout) {
  return conv_path(mode, Cin, Cout);
}

// The batch-1 stem pair on the tensor-core tile (kernel 2 of the TPU
// package, b1_stem.py:82): x (1, H, W, Cin) bf16 NHWC, w (3, 3, Cin, Cout)
// bf16 HWIO, bias (Cout,) float32 -> out (1, H/2, W/2, Cout) bf16 =
// bf16(max over 2x2 of leaky_0.1(conv3x3(x, w) + bias)), float32 sums,
// bias and leaky, one rounding. The shapes srod_pt_conv_tensor_core(3,
// Cin, Cout) puts on the tile; x and w 16-byte aligned. Bound at batch 1
// by neither bytes nor products (see the note at the top) but by the
// launch and one tile's prologue and K loop a block.
extern "C" int srod_pt_stem_pair(const void* x, const void* w,
                                 const void* bias, void* out, int H, int W,
                                 int Cin, int Cout, void* stream) {
  if (H <= 0 || W <= 0 || H % 2 || W % 2 ||
      conv_path(CT_STEM, Cin, Cout) == CP_FP32)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = static_cast<long long>((H / 2 + PT_PT - 1) / PT_PT) *
                          ((W / 2 + PT_PT - 1) / PT_PT);
  int nblk = 0;
  return conv_tc_launch(CT_STEM, x, w, nullptr, bias, nullptr, out, nullptr,
                        nullptr, nullptr, 1, H, W, Cin, Cout, tiles, &nblk,
                        static_cast<cudaStream_t>(stream));
}

// The bf16 serving stem's pair on the tensor-core tile (kernel 4's mode
// "fwd"): x (B, H, W, Cin) bf16 NHWC, w (3, 3, Cin, Cout) bf16 HWIO, bias
// (Cout,) float32, rounded to bf16 as apply_kernel rounds it -> out (B,
// H/2, W/2, Cout) bf16, fwd's per-tap roundings (see the note at the
// top). The shapes srod_pt_conv_tensor_core(4, Cin, Cout) puts on the
// tile (Cin <= 64); x and w 16-byte aligned, out 4-byte aligned. One
// launch a pair.
extern "C" int srod_pt_fwd_pair(const void* x, const void* w,
                                const void* bias, void* out, int B, int H,
                                int W, int Cin, int Cout, void* stream) {
  if (!shapes_ok(B, H, W, Cin, Cout, PT_MAX_CIN_FWD, PT_MAX_CO_FWD) ||
      conv_path(CT_FWD, Cin, Cout) == CP_FP32)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = static_cast<long long>(B) *
                          ((H / 2 + PT_PT - 1) / PT_PT) *
                          ((W / 2 + PT_PT - 1) / PT_PT);
  int nblk = 0;
  return conv_tc_launch(CT_FWD, x, w, nullptr, bias, nullptr, out, nullptr,
                        nullptr, nullptr, B, H, W, Cin, Cout, tiles, &nblk,
                        static_cast<cudaStream_t>(stream));
}

// z, out: n bf16 values (n % 8 == 0), NHWC with Cout channels.
extern "C" int srod_pt_apply(const void* z, const void* mean, const void* inv,
                             const void* scales, const void* bias, void* out,
                             long long n, int Cout, void* stream) {
  if (n <= 0 || n % 8 || Cout <= 0 || Cout % 8 || n % Cout)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n8 = static_cast<size_t>(n) / 8;
  const size_t want = (n8 + PT_THREADS - 1) / PT_THREADS;
  const int blocks = static_cast<int>(want < 132 * 64 ? want : 132 * 64);
  apply_kernel<<<blocks, PT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(z), static_cast<const float*>(mean),
      static_cast<const float*>(inv), static_cast<const float*>(scales),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), n8,
      Cout);
  return static_cast<int>(cudaGetLastError());
}

// Whether srod_pt_bwdg runs the tensor-core kernel (1) or the FP32-core
// one (0) for this shape: Cin <= 3 and Cout 16 or 32 take the first.
extern "C" int srod_pt_bwdg_tensor_core(int Cin, int Cout) {
  return bwdg_tensor_core(Cin, Cout) ? 1 : 0;
}

// The number of blocks (rows of the partial scratch) srod_pt_bwdg uses,
// or -1 for shapes it does not take.
extern "C" int srod_pt_bwdg_blocks(int B, int H, int W, int Cin, int Cout) {
  if (!shapes_ok(B, H, W, Cin, Cout, PT_MAX_CIN_BWD, PT_MAX_CO_BWD)) return -1;
  int smem = 0;
  return bwdg_grid(B, H, W, Cin, Cout, &smem);
}

// partial: (blocks, ncols) float32 scratch, blocks from
// srod_pt_bwdg_blocks; out: (ncols,) float32, ncols = 2*Cout + 9*Cin*Cout +
// 9*Cin + (9*Cin)^2 (the Gram's lower triangle is left 0). On the
// tensor-core kernel's shapes dp and z are 16-byte and am 8-byte aligned.
extern "C" int srod_pt_bwdg(const void* x, const void* dp, const void* z,
                            const void* am, const void* mean, const void* inv,
                            const void* scales, const void* bias,
                            void* partial, int blocks, void* out, int B,
                            int H, int W, int Cin, int Cout, void* stream) {
  if (!shapes_ok(B, H, W, Cin, Cout, PT_MAX_CIN_BWD, PT_MAX_CO_BWD))
    return static_cast<int>(cudaErrorInvalidValue);
  int smem = 0;
  if (blocks != bwdg_grid(B, H, W, Cin, Cout, &smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n9 = 9 * Cin;
  const int ncols = 2 * Cout + n9 * Cout + n9 + n9 * n9;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* dpb = static_cast<const __nv_bfloat16*>(dp);
  const auto* zb = static_cast<const __nv_bfloat16*>(z);
  const auto* amb = static_cast<const int8_t*>(am);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (bwdg_tensor_core(Cin, Cout)) {
    if ((reinterpret_cast<uintptr_t>(dp) | reinterpret_cast<uintptr_t>(z)) %
            16 ||
        reinterpret_cast<uintptr_t>(am) % 8)
      return static_cast<int>(cudaErrorInvalidValue);
    bwdg_tc_instance(Cin, Cout)<<<blocks, PT_THREADS, 0, s>>>(
        xb, dpb, zb, amb, f(mean), f(inv), f(scales), f(bias),
        static_cast<float*>(partial), B, H, W);
  } else {
    bwdg_kernel<<<blocks, PT_THREADS, smem, s>>>(
        xb, dpb, zb, amb, f(mean), f(inv), f(scales), f(bias),
        static_cast<float*>(partial), B, H, W, Cin, Cout);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  colsum_kernel<<<ncols, PT_THREADS, 0, s>>>(
      static_cast<const float*>(partial), blocks, ncols,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Modes "red" and "dy" of the chain's second pair, Cin 8 or 16. kc:
// (7 * Cout,) float32 [mean | inv | scales | bias | c1 | c2 | c3];
// partial: (B * nchunk, cols) float32 scratch, 1 <= nchunk <= the
// image's 8x8 pooled tiles (the tensor-core tile, Cin 16, uses its first
// rows, one a block); out: (cols,) float32, cols = 2 * Cout ("red":
// [sum dz | sum dz * x_hat]) or 9 * Cin * Cout ("dy": dw in HWIO order);
// dy ("dy" only): (B, H, W, Cout) bf16.
static int chain_bwd(bool with_dy, const void* x, const void* w,
                     const void* dp, const void* kc, void* dy, void* partial,
                     int nchunk, void* out, int B, int H, int W, int Cin,
                     int Cout, void* stream) {
  if (!shapes_ok(B, H, W, Cin, Cout, PT_MAX_CIN_CHAIN, PT_MAX_CO_FWD) ||
      Cin % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int H2 = H / 2, W2 = W / 2;
  const int tiles = ((H2 + PT_PT - 1) / PT_PT) * ((W2 + PT_PT - 1) / PT_PT);
  if (nchunk < 1 || nchunk > tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rows = B * nchunk;
  if (conv_path(with_dy ? CT_DY : CT_RED, Cin, Cout) == CP_TILE) {
    const int err = conv_tc_launch(with_dy ? CT_DY : CT_RED, x, w, dp, kc,
                                   nullptr, nullptr, nullptr, dy, partial, B,
                                   H, W, Cin, Cout, rows, &rows, s);
    if (err != cudaSuccess) return err;
  } else {
    const dim3 grid(nchunk, Cout / PT_CO, B);
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* wb = static_cast<const __nv_bfloat16*>(w);
    const auto* dpb = static_cast<const __nv_bfloat16*>(dp);
    const auto* kcf = static_cast<const float*>(kc);
    if (with_dy)
      chain_bwd_kernel<true><<<grid, PT_THREADS, 0, s>>>(
          xb, wb, dpb, kcf, static_cast<__nv_bfloat16*>(dy),
          static_cast<float*>(partial), H, W, Cin, Cout);
    else
      chain_bwd_kernel<false><<<grid, PT_THREADS, 0, s>>>(
          xb, wb, dpb, kcf, nullptr, static_cast<float*>(partial), H, W,
          Cin, Cout);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int cols = with_dy ? 9 * Cin * Cout : 2 * Cout;
  colsum_kernel<<<cols, PT_THREADS, 0, s>>>(
      static_cast<const float*>(partial), rows, cols,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int srod_pt_red(const void* x, const void* w, const void* dp,
                           const void* kc, void* partial, int nchunk,
                           void* out, int B, int H, int W, int Cin, int Cout,
                           void* stream) {
  return chain_bwd(false, x, w, dp, kc, nullptr, partial, nchunk, out, B, H,
                   W, Cin, Cout, stream);
}

extern "C" int srod_pt_dy(const void* x, const void* w, const void* dp,
                          const void* kc, void* dy, void* partial, int nchunk,
                          void* out, int B, int H, int W, int Cin, int Cout,
                          void* stream) {
  return chain_bwd(true, x, w, dp, kc, dy, partial, nchunk, out, B, H, W,
                   Cin, Cout, stream);
}

// dy (B, H, W, Cout) bf16, w (3, 3, Cin, Cout) bf16 -> dx (B, H, W, Cin)
// bf16. Cin 8 or 16, Cout a multiple of 16; the three pointers 16-byte
// aligned (cp.async and the 16-byte stores).
extern "C" int srod_pt_dgrad(const void* dy, const void* w, void* dx, int B,
                             int H, int W, int Cin, int Cout, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || (Cin != 8 && Cin != 16) ||
      Cout <= 0 || Cout % DG_KC ||
      (reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(dx)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // a pixel's dy channels in 32-channel groups where Cout allows: whole
  // 64-byte runs from device memory
  if (Cout % (2 * DG_KC) == 0)
    return Cin == 8 ? dgrad_launch<1, 2>(dy, w, dx, B, H, W, Cout, s)
                    : dgrad_launch<2, 2>(dy, w, dx, B, H, W, Cout, s);
  return Cin == 8 ? dgrad_launch<1, 1>(dy, w, dx, B, H, W, Cout, s)
                  : dgrad_launch<2, 1>(dy, w, dx, B, H, W, Cout, s);
}
