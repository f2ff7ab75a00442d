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
// and no int8 copy of it reaches device memory.
//
// What bounds it on an H100 (tiny-yolo-voc-416, B=128; bytes = input read
// once + output written once, at 3.35 TB/s; operations at the int8 dense
// peak, 1,979 TOP/s):
//   pair 1, 3 -> 16 @416 from u8 frames: 66.5 + 88.6 MB, 19.1 G ops:
//     0.046 ms, bytes
//   pair 2, 16 -> 32 @208: 88.6 + 44.3 MB, 51.0 G ops: 0.040 ms, bytes
//   pair 3, 32 -> 64 @104: 44.3 + 22.2 MB, 51.0 G ops: 0.026 ms, operations
//   pair 4, 64 -> 128 @52: 22.2 + 11.1 MB, 51.0 G ops: 0.026 ms, operations
// The chain's 172 G operations take about 1.3-1.5 ms on the integer
// pipes (__dp4a, four MACs an instruction: the first version, 27x the
// chain's 0.116 ms bytes bound) and 0.087 ms on the int8 tensor cores,
// about 15x less and below the bytes: each pair becomes bound by its
// bytes, or by its operations at pairs 3-4. The design keeps the products
// on the tensor cores and the bytes moving:
//
//   - an implicit GEMM on mma.sync.m16n8k32 s8 x s8 -> s32 (no
//     .satfinite: the largest sum, 127 * 127 * 9 * Cin, stays far inside
//     int32, so the sums and the pooled max are exact). M = the work
//     item's 16x16 full-resolution positions (an 8x8 pooled tile), N = NC
//     output channels (16 or 32; Cout masked), K = taps x Cin folded into
//     k32 steps so that few steps are padding:
//       taps      (Cin <= 3, pair 1): 9 taps x Cin channels (27 at Cin 3)
//                 plus zeros, ONE k32 step; each lane assembles its
//                 position's row from the staged halo codes (at Cin 3
//                 by funnel shifts of three 9-byte runs) into its warp's
//                 rows in shared memory;
//       tap pairs (Cin <= 16, pair 2): two taps a step, 16 channels each,
//                 5 steps (the last one's upper half zero);
//       chunks    (Cin > 16, pairs 3-4): one tap x one 32-channel chunk a
//                 step, 9 per chunk (chunks outer, taps inner).
//     A fragments by ldmatrix.x4 (an s8 m16k32 fragment is four 8x16-byte
//     matrices) straight from the staged halo at the tap's shifted
//     position, or from the assembled rows of the taps fold; B fragments
//     by ldmatrix.x4 from the block's weights, staged once, 32 bytes of K
//     contiguous per output channel and step;
//   - warp w owns full-resolution rows 2w, 2w + 1 (pooled row w) as two
//     m16 tiles of 2 rows x 8 columns, as the conv tile of
//     csrc/phase_train.cu: a lane's accumulators hold a pool window's
//     vertical pair for two channels, one __shfl_xor(., 4) brings the
//     horizontal pair, and the max and the epilogue run once per pooled
//     pixel, in registers; each warp stages its pooled row's codes and
//     stores them as 16-byte runs of a pixel's channels;
//   - persistent blocks (as many as fit at once) walk the work items;
//     the tap-pair and chunk folds stream their halo (18x18 pixels, 16 or
//     32 bytes a pixel) through a ring of 4 stages filled by cp.async (16
//     bytes, src-size 0 for the zero padding), so the next items' loads
//     overlap this item's products; the taps fold requantizes the frame
//     through registers (cp.async cannot convert) into two halo buffers
//     of packed rows (3 bytes a pixel at Cin 3): the next item's loads
//     are issued before this item's products and stored after them, one
//     block barrier an item. u8 frames (W a multiple of 4) arrive as
//     aligned 32-bit words, one a thread, requantized by a table of the
//     256 codes.
//   The taps fold has little arithmetic per item (4 mma a warp), so what
//   holds it is instructions an item: the loads, offsets and decodes are
//   kept per thread and per item, not per element. Shapes the fast loads
//   do not take (int8 Cin not a multiple of 16, frames with Cin > 3) are
//   staged through registers in the same layouts.

#include <cuda_runtime.h>
#include <stdint.h>

#define PS_PT 8                   // pooled tile edge
#define PS_FULL 16                // full-resolution tile edge
#define PS_TH 18                  // halo tile edge
#define PS_THREADS 256
#define PS_NS 4                   // halo stages in the ring
#define PS_MAX_CIN 512            // the weights are staged whole

enum { FOLD_TAPS = 0, FOLD_TAP_PAIRS = 1, FOLD_CHUNKS = 2 };

namespace {

__host__ __device__ inline int fold_of(int Cin) {
  return Cin <= 3 ? FOLD_TAPS : Cin <= 16 ? FOLD_TAP_PAIRS : FOLD_CHUNKS;
}

// k32 steps of a work item's GEMM
__host__ __device__ inline int k_steps(int fold, int Cin) {
  return fold == FOLD_TAPS ? 1
       : fold == FOLD_TAP_PAIRS ? 5 : 9 * ((Cin + 31) / 32);
}

// bytes of one staged halo: codes of an 18x18 pixel tile, as 18 packed
// rows of 64 bytes (taps fold), or 16 or 32 bytes a pixel
__host__ __device__ inline int stage_bytes(int fold) {
  return fold == FOLD_TAPS ? PS_TH * 64
       : PS_TH * PS_TH * (fold == FOLD_TAP_PAIRS ? 16 : 32);
}

struct Item {                   // a work item's image, first pooled row
  int b, oy0, ox0;              // and column
};

struct Layout {                 // byte offsets in shared memory
  int w, ring, a, out, kc, kmap, lut, total;
};

// the weights [k32 step][NC co][32 bytes of K], the halo stages (two for
// the taps fold, PS_NS otherwise), the taps fold's assembled A rows
// [8 warps][32 positions][32 bytes], the codes [8 warps][8 pooled
// pixels][NC], dq and bias [2][NC] float32, the taps fold's byte offsets
// [32] int and its requant table of u8 frames [256]
__host__ __device__ inline Layout layout(int fold, int Cin, int nc) {
  Layout L;
  L.w = 0;
  L.ring = L.w + k_steps(fold, Cin) * nc * 32;
  L.a = L.ring + (fold == FOLD_TAPS ? 2 : PS_NS) * stage_bytes(fold);
  L.out = L.a + (fold == FOLD_TAPS ? PS_FULL * PS_FULL * 32 : 0);
  L.kc = L.out + PS_PT * PS_PT * nc;
  L.kmap = L.kc + 2 * nc * 4;
  L.lut = L.kmap + 32 * 4;
  L.total = L.lut + (fold == FOLD_TAPS ? 256 : 0);
  return L;
}

// the (tap, input channel) at byte k of k32 step s; false for padding
__device__ __forceinline__ bool k_source(int fold, int Cin, int s, int k,
                                         int& tap, int& ci) {
  if (fold == FOLD_TAPS) {
    tap = k / Cin;
    ci = k - tap * Cin;
  } else if (fold == FOLD_TAP_PAIRS) {
    tap = 2 * s + (k >> 4);
    ci = k & 15;
  } else {
    tap = s % 9;
    ci = 32 * (s / 9) + k;
  }
  return tap < 9 && ci < Cin;
}

// byte offset of 16-byte unit u of 32-byte row r, the units XOR-swizzled
// by bit 2 of `key`, so that the rows of eight consecutive keys, one
// unit, fall in eight distinct 16-byte bank groups
__device__ __forceinline__ int swz2(int r, int key, int u) {
  return r * 32 + ((u ^ ((key >> 2) & 1)) << 4);
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

// four 8x16-byte matrices, row addresses from lanes 8j .. 8j + 7 for
// matrix j: lane l receives bytes 4 (l % 4) .. + 3 of row l / 4 of each
__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a (16x32, row) * b (32x8, col): s8 operands, s32 sums, exact
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int8_t requant(float x, float inv) {
  // raw frame value -> int8 code, the engine's requant expression
  const float q = rintf(__fmul_rn(x, inv));
  return static_cast<int8_t>(fminf(fmaxf(q, -127.f), 127.f));
}

// element i of the input as a float (int8 codes exactly)
__device__ __forceinline__ float raw_at(const void* x, int xdt, size_t i) {
  return xdt == 0 ? static_cast<float>(static_cast<const int8_t*>(x)[i])
       : xdt == 1 ? static_cast<float>(static_cast<const uint8_t*>(x)[i])
                  : static_cast<const float*>(x)[i];
}

__device__ __forceinline__ int8_t code_of(float v, int xdt, float inv) {
  return xdt == 0 ? static_cast<int8_t>(static_cast<int>(v))
                  : requant(v, inv);
}

// leaky as max(v, 0.1 v) (the same value as v > 0 ? v : 0.1 v, as
// 0.1 v rounds between v and 0), __float2int_rn rounds half to even
__device__ __forceinline__ int8_t epilogue(int m, float dq, float bias,
                                           float inv_out) {
  float v = __fadd_rn(__fmul_rn(static_cast<float>(m), dq), bias);
  v = fmaxf(v, __fmul_rn(0.1f, v));
  return static_cast<int8_t>(
      min(max(__float2int_rn(__fmul_rn(v, inv_out)), -127), 127));
}

// One block: output channels co0 = blockIdx.y * NC .. + NC - 1 of the
// pooled tiles blockIdx.x, + gridDim.x, ... of the batch's B * tiles.
// x_dtype 0 int8, 1 uint8, 2 float32 (requantized with inv_in).
template <int FOLD, int NC>
__global__ void __launch_bounds__(PS_THREADS, FOLD == FOLD_CHUNKS ? 2 : 3)
phase_pair_tc_kernel(const void* __restrict__ x, int xdt,
                     const int8_t* __restrict__ w,
                     const float* __restrict__ dq,
                     const float* __restrict__ bias, float inv_in,
                     float inv_out, int8_t* __restrict__ out, int B, int H,
                     int W, int Cin, int Cout) {
  constexpr int NT = NC / 8;             // n8 tiles
  extern __shared__ __align__(128) unsigned char csm[];
  const Layout L = layout(FOLD, Cin, NC);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const bool even = (g & 1) == 0;
  const int co0 = blockIdx.y * NC;
  const int H2 = H / 2, W2 = W / 2;
  const int tiles_x = (W2 + PS_PT - 1) / PS_PT;
  const int tiles = tiles_x * ((H2 + PS_PT - 1) / PS_PT);
  const int ntl = (B * tiles - 1 - static_cast<int>(blockIdx.x)) /
                      static_cast<int>(gridDim.x) + 1;
  const int steps = k_steps(FOLD, Cin);
  const unsigned smb = smem_u32(csm);
  float* kc = reinterpret_cast<float*>(csm + L.kc);
  int8_t* outs = reinterpret_cast<int8_t*>(csm + L.out);

  for (int i = tid; i < NC; i += PS_THREADS) {
    const bool in = co0 + i < Cout;
    kc[i] = in ? dq[co0 + i] : 0.f;
    kc[NC + i] = in ? bias[co0 + i] : 0.f;
  }
  // the weights: byte k of step s, channel n at row s * NC + n; the
  // threads walk n fastest (the global weights' contiguous axis)
  for (int i = tid; i < steps * 32 * NC; i += PS_THREADS) {
    const int n = i % NC, sk = i / NC;
    const int s = sk >> 5, k = sk & 31;
    int tap, ci;
    int8_t v = 0;
    if (co0 + n < Cout && k_source(FOLD, Cin, s, k, tap, ci))
      v = w[(static_cast<size_t>(tap) * Cin + ci) * Cout + co0 + n];
    const int row = s * NC + n;
    csm[L.w + swz2(row, row, k >> 4) + (k & 15)] =
        static_cast<unsigned char>(v);
  }
  // B row addresses: rows n = 16 pr + l % 8 + 8 (l / 16), unit (l / 8) % 2
  // (the step's and pr's offsets are multiples of 512 bytes and keep the
  // swizzle)
  const int brow = (lane & 7) + 8 * (lane >> 4);
  const unsigned b_base = smb + L.w + swz2(brow, brow, (lane >> 3) & 1);
  // A rows: lane l, matrix j = l / 8: full-resolution row 2w + j % 2,
  // column 8 mt + l % 8, K bytes 16 (j / 2) ..
  const int arow = 2 * warp + ((lane >> 3) & 1), aunit = lane >> 4;

  // work item `tile` -> its image and first pooled row and column, once
  // an item. An integer division costs tens of instructions, so n / d is
  // a multiply-high by ceil(2^32 / d): exact while n * d < 2^32, which
  // holds for every n < B * tiles when B * tiles^2 < 2^32
  const bool fdiv = static_cast<unsigned long long>(B) * tiles * tiles <
                    0x100000000ull;
  const unsigned long long m_tiles = (0x100000000ull + tiles - 1) / tiles;
  const unsigned long long m_tx = (0x100000000ull + tiles_x - 1) / tiles_x;
  auto divide = [&](int n, int d, unsigned long long m) {
    return fdiv ? static_cast<int>((static_cast<unsigned long long>(n) * m) >>
                                   32)
                : n / d;
  };
  auto item_of = [&](int tile) {
    Item it;
    it.b = divide(tile, tiles, m_tiles);
    const int r = tile - it.b * tiles, ty = divide(r, tiles_x, m_tx);
    it.oy0 = ty * PS_PT;
    it.ox0 = (r - ty * tiles_x) * PS_PT;
    return it;
  };

  int acc[2][NT][4];
  auto zero_acc = [&]() {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
  };
  // the products of k32 step s, A at a[mt] (shared addresses)
  auto mma_step = [&](int s, const unsigned (&a_addr)[2]) {
    unsigned bfr[NT / 2][4];
#pragma unroll
    for (int pr = 0; pr < NT / 2; ++pr)
      ldmatrix_x4(b_base + (s * NC + 16 * pr) * 32, bfr[pr]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      unsigned a[4];
      ldmatrix_x4(a_addr[mt], a);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_s8(acc[mt][nt], a, bfr[nt / 2][2 * (nt % 2)],
               bfr[nt / 2][2 * (nt % 2) + 1]);
    }
  };
  // the tile's pool, epilogue and store. Lane 4g + q holds rows g and
  // g + 8 of each m16 tile (positions (2w, 8 mt + g), (2w + 1, 8 mt + g))
  // for channels 2q, 2q + 1: the vertical max first, then the horizontal
  // partner's through __shfl_xor(., 4); the even-column lane owns channel
  // 2q of pooled pixel (w, 4 mt + g / 2), the odd one channel 2q + 1.
  // Warp w stages its pooled row's codes and stores them itself.
  int8_t* wo = outs + warp * PS_PT * NC;
  float kdq[NT], kbi[NT];            // taps fold: the lane's dq and bias
  auto finish = [&](const Item& it) {
    const int b = it.b, oy = it.oy0 + warp, ox0 = it.ox0;
    __syncwarp();                    // the row's last codes have left
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int v0 = max(acc[mt][nt][0], acc[mt][nt][2]);
        const int v1 = max(acc[mt][nt][1], acc[mt][nt][3]);
        const int other = __shfl_xor_sync(0xffffffffu, even ? v1 : v0, 4);
        const int m = even ? max(v0, other) : max(v1, other);
        const int c = 8 * nt + 2 * q + (g & 1);
        float dqc, bic;
        if constexpr (FOLD == FOLD_TAPS) {
          dqc = kdq[nt];
          bic = kbi[nt];
        } else {
          dqc = kc[c];
          bic = kc[NC + c];
        }
        wo[(4 * mt + (g >> 1)) * NC + c] = epilogue(m, dqc, bic, inv_out);
      }
    __syncwarp();                    // the row's codes are staged
    // lane: pooled pixel lane / (NC / 16), 16 channels lane % (NC / 16)
    const int px = lane / (NC / 16), u = lane % (NC / 16);
    if (lane >= PS_PT * (NC / 16) || oy >= H2 || ox0 + px >= W2 ||
        co0 + 16 * u >= Cout)
      return;
    int8_t* o = out + ((static_cast<size_t>(b) * H2 + oy) * W2 + ox0 + px) *
                          Cout + co0 + 16 * u;
    const int8_t* sv = wo + px * NC + 16 * u;
    if (Cout % 16 == 0) {
      *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(sv);
    } else {
      for (int j = 0; j < 16 && co0 + 16 * u + j < Cout; ++j) o[j] = sv[j];
    }
  };

  if constexpr (FOLD == FOLD_TAPS) {
    // ---- one k32 step an item: 9 taps x Cin codes. The halo's codes are
    // staged as packed rows, two buffers of 18 rows x RS bytes: channel c
    // of halo pixel (hy, hx) at hy * RS + 1 + Cin * hx + c. The lead byte
    // is where a row of u8 frames starts in its aligned word when W is a
    // multiple of 4 (the row's first halo pixel, column 16 tx - 1, is
    // byte 3 (16 tx - 1) = 1 mod 4 of a row of 3 W bytes), so such frames
    // (Cin 3) are copied as aligned words and requantized through a table
    // of the 256 codes; other inputs go element by element. Each lane
    // assembles the A row of its own position in its warp's rows (at Cin
    // 3 by funnel shifts of three 9-byte runs, at offsets that are the
    // same in every item), so one block barrier an item remains
    constexpr int RS = 64, HB = PS_TH * RS;
    int8_t* halo = reinterpret_cast<int8_t*>(csm + L.ring);
    unsigned char* lut = csm + L.lut;
    int* kmap = reinterpret_cast<int*>(csm + L.kmap);
    const bool words = xdt == 1 && Cin == 3 && W % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 4 == 0;
    lut[tid] = static_cast<unsigned char>(
        code_of(static_cast<float>(tid), 1, inv_in));
    if (tid < 32) {                  // byte k's offset from the window's
      int tap, ci;                   // first code
      kmap[tid] = k_source(FOLD_TAPS, Cin, 0, tid, tap, ci)
                      ? (tap / 3) * RS + (tap % 3) * Cin + ci
                      : -1;
    }
    // the thread's share of every halo, the same in every item: u8 words:
    // row tid / 14, word tid % 14 (252 words: the lead and 54 bytes);
    // other inputs: elements e = tid + 256 j, as halo row | column << 8
    // (-1: none), the offset in x from the halo's first element and the
    // place in the buffer
    constexpr int WPR = 14;          // words a row
    const int w_row = tid / WPR, w_word = tid % WPR;
    const int E = PS_TH * PS_TH * Cin;     // halo elements (<= 972)
    int f_pos[4], f_src[4], f_dst[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = tid + j * PS_THREADS;
      const int pp = e / Cin, c = e - pp * Cin;
      const int hy = pp / PS_TH, hx = pp % PS_TH;
      f_pos[j] = e < E ? hy | (hx << 8) : -1;
      f_src[j] = (hy * W + hx) * Cin + c;
      f_dst[j] = hy * RS + 1 + Cin * hx + c;
    }
    unsigned raw = 0;                // the next item's, raw (words)
    float pre[4];                    // (elements)
    auto fetch = [&](const Item& it) {
      const int gy0 = 2 * it.oy0 - 1, gx0 = 2 * it.ox0 - 1;
      if (words) {
        raw = 0;
        const int gy = gy0 + w_row;
        if (w_row < PS_TH && gy >= 0 && gy < H) {
          // the row's first halo pixel is byte 1 of an aligned word
          const long long rb =
              ((static_cast<long long>(it.b) * H + gy) * W + gx0) * 3 - 1;
          // the row's bytes of pixels inside the image
          const int lo = 1 + 3 * max(0, -gx0);
          const int hi = 1 + 3 * min(PS_TH, W - gx0);
          const int b0 = 4 * w_word;
          if (b0 + 4 > lo && b0 < hi) {
            raw = *reinterpret_cast<const unsigned*>(
                static_cast<const uint8_t*>(x) + (rb + b0));
            const int nlo = min(max(lo - b0, 0), 4);   // bytes to clear
            const int nhi = min(max(b0 + 4 - hi, 0), 4);
            raw &= static_cast<unsigned>(0xffffffffull << (8 * nlo));
            raw &= static_cast<unsigned>(0xffffffffull >> (8 * nhi));
          }
        }
      } else {
        const long long base =
            ((static_cast<long long>(it.b) * H + gy0) * W + gx0) * Cin;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pre[j] = 0.f;
          if (f_pos[j] >= 0 &&
              static_cast<unsigned>(gy0 + (f_pos[j] & 0xff)) <
                  static_cast<unsigned>(H) &&
              static_cast<unsigned>(gx0 + (f_pos[j] >> 8)) <
                  static_cast<unsigned>(W))
            pre[j] = raw_at(x, xdt, static_cast<size_t>(base + f_src[j]));
        }
      }
    };
    auto put = [&](int8_t* hb) {
      if (words) {
        if (w_row < PS_TH)
          *reinterpret_cast<unsigned*>(hb + w_row * RS + 4 * w_word) =
              static_cast<unsigned>(lut[raw & 0xff]) |
              static_cast<unsigned>(lut[(raw >> 8) & 0xff]) << 8 |
              static_cast<unsigned>(lut[(raw >> 16) & 0xff]) << 16 |
              static_cast<unsigned>(lut[raw >> 24]) << 24;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (f_pos[j] >= 0) hb[f_dst[j]] = code_of(pre[j], xdt, inv_in);
      }
    };
    // the warp's 32 A rows: lane l's position (2w + l / 16, l % 16) is
    // row l; ldmatrix rows: m16 tile mt, row l % 8 + 8 ((l / 8) % 2) ->
    // warp row 16 ((l / 8) % 2) + 8 mt + l % 8
    const int wa = L.a + warp * 32 * 32;
    unsigned a_addr[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int rr = 16 * ((lane >> 3) & 1) + 8 * mt + (lane & 7);
      a_addr[mt] = smb + wa + swz2(rr, rr, aunit);
    }
    // the lane's window: its first code at win = fy * RS + 1 + Cin * fx;
    // at Cin 3 the 9 bytes of taps (ky, 0..2) are contiguous, read as the
    // three words from win + ky * RS rounded down, shifted by sh bits
    const int fy = 2 * warp + (lane >> 4), fx = lane & 15;
    const int win = fy * RS + 1 + Cin * fx;
    const int wbase = win & ~3, sh = 8 * (win & 3);
    Item cur = item_of(blockIdx.x), nxt = cur;
    __syncthreads();                 // the table and constants are in
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      kdq[nt] = kc[8 * nt + 2 * q + (g & 1)];
      kbi[nt] = kc[NC + 8 * nt + 2 * q + (g & 1)];
    }
    fetch(cur);
    put(halo);
    for (int i = 0; i < ntl; ++i) {
      __syncthreads();               // halo i % 2 is in; the other free
      const int8_t* hl = halo + (i & 1) * HB;
      unsigned wd[8];
      if (Cin == 3) {
        unsigned S[3][3];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          const unsigned* rw =
              reinterpret_cast<const unsigned*>(hl + wbase + ky * RS);
          const unsigned w0 = rw[0], w1 = rw[1], w2 = rw[2];
          S[ky][0] = __funnelshift_r(w0, w1, sh);
          S[ky][1] = __funnelshift_r(w1, w2, sh);
          S[ky][2] = (w2 >> sh) & 0xffu;
        }
        // 27 bytes: run ky at bytes 9 ky .. 9 ky + 8
        wd[0] = S[0][0];
        wd[1] = S[0][1];
        wd[2] = S[0][2] | (S[1][0] << 8);
        wd[3] = __funnelshift_r(S[1][0], S[1][1], 24);
        wd[4] = (S[1][1] >> 24) | (S[1][2] << 8) | (S[2][0] << 16);
        wd[5] = __funnelshift_r(S[2][0], S[2][1], 16);
        wd[6] = (S[2][1] >> 16) | (S[2][2] << 16);
        wd[7] = 0;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) wd[j] = 0;
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          const int m = kmap[k];
          if (m < 0) continue;
          const unsigned v = static_cast<unsigned char>(hl[win + m]);
          wd[k >> 2] |= v << (8 * (k & 3));
        }
      }
      *reinterpret_cast<uint4*>(csm + wa + swz2(lane, lane, 0)) =
          make_uint4(wd[0], wd[1], wd[2], wd[3]);
      *reinterpret_cast<uint4*>(csm + wa + swz2(lane, lane, 1)) =
          make_uint4(wd[4], wd[5], wd[6], wd[7]);
      if (i + 1 < ntl) {             // in flight meanwhile
        nxt = item_of(blockIdx.x + (i + 1) * gridDim.x);
        fetch(nxt);
      }
      __syncwarp();                  // the warp's A rows are in
      zero_acc();
      mma_step(0, a_addr);
      finish(cur);
      if (i + 1 < ntl) put(halo + ((i + 1) & 1) * HB);
      cur = nxt;
    }
  } else {
    // ---- tap pairs (one 16-byte unit a pixel) or 32-channel chunks (two
    // units a pixel, swizzled by the halo column) through the ring
    constexpr int U = FOLD == FOLD_TAP_PAIRS ? 1 : 2;
    constexpr int SB = PS_TH * PS_TH * 16 * U;
    const int nch = FOLD == FOLD_TAP_PAIRS ? 1 : (Cin + 31) / 32;
    const int S = ntl * nch;         // (item, chunk) stages of the block
    const bool fast = xdt == 0 && Cin % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0;
    auto unit_at = [&](int p, int hx, int u) {
      return U == 1 ? p * 16 : swz2(p, hx, u);
    };
    // the fast path's 16-byte units i = tid + 256 k of every stage, the
    // same in every stage: offset from the halo's first pixel in x, place
    // in the stage (-1: none), halo row | column << 8 | channel << 16
    constexpr int NU = PS_TH * PS_TH * U;
    constexpr int KU = (NU + PS_THREADS - 1) / PS_THREADS;
    int u_src[KU], u_dst[KU], u_pos[KU];
#pragma unroll
    for (int k = 0; k < KU; ++k) {
      const int i = tid + k * PS_THREADS;
      const int p = i / U, u = i % U, hy = p / PS_TH, hx = p % PS_TH;
      u_src[k] = (hy * W + hx) * Cin + 16 * u;
      u_dst[k] = i < NU ? unit_at(p, hx, u) : -1;
      u_pos[k] = hy | (hx << 8) | (16 * u << 16);
    }
    auto load = [&](int s) {
      if (s < S) {
        const int ch = s % nch;
        const Item it = item_of(blockIdx.x + (s / nch) * gridDim.x);
        const int b = it.b, gy0 = 2 * it.oy0 - 1, gx0 = 2 * it.ox0 - 1;
        const int st = L.ring + (s % PS_NS) * SB;
        if (fast) {
          const long long base =
              ((static_cast<long long>(b) * H + gy0) * W + gx0) * Cin +
              32 * ch;
#pragma unroll
          for (int k = 0; k < KU; ++k) {
            if (u_dst[k] < 0) continue;
            const bool in =
                static_cast<unsigned>(gy0 + (u_pos[k] & 0xff)) <
                    static_cast<unsigned>(H) &&
                static_cast<unsigned>(gx0 + ((u_pos[k] >> 8) & 0xff)) <
                    static_cast<unsigned>(W) &&
                32 * ch + (u_pos[k] >> 16) < Cin;
            cp_async16(smb + st + u_dst[k],
                       in ? static_cast<const int8_t*>(x) + base + u_src[k]
                          : x,
                       in ? 16 : 0);
          }
        } else {
          for (int i = tid; i < PS_TH * PS_TH * 16 * U; i += PS_THREADS) {
            const int p = i / (16 * U), c = i % (16 * U), hx = p % PS_TH;
            const int gy = gy0 + p / PS_TH, gx = gx0 + hx;
            const int ci = 32 * ch + c;
            int8_t v = 0;
            if (gy >= 0 && gy < H && gx >= 0 && gx < W && ci < Cin)
              v = code_of(
                  raw_at(x, xdt,
                         ((static_cast<size_t>(b) * H + gy) * W + gx) * Cin +
                             ci),
                  xdt, inv_in);
            csm[st + unit_at(p, hx, c >> 4) + (c & 15)] =
                static_cast<unsigned char>(v);
          }
        }
      }
      cp_async_commit();
    };
    // A: the lane's halo pixel at tap (0, 0) and the byte offset of a tap
    int a_pix[2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      a_pix[mt] = arow * PS_TH + 8 * mt + (lane & 7);

    for (int s = 0; s < PS_NS - 1; ++s) load(s);
    for (int s = 0; s < S; ++s) {
      cp_async_wait<PS_NS - 2>();    // stage s has landed ...
      __syncthreads();               // ... for all, and s - 1 is done
      load(s + PS_NS - 1);
      const int ch = s % nch;
      if (ch == 0) zero_acc();
      const unsigned st = smb + L.ring + (s % PS_NS) * SB;
      if constexpr (FOLD == FOLD_TAP_PAIRS) {
        // lanes 0-15 (K bytes 0-15) at tap 2 ks, lanes 16-31 at tap
        // 2 ks + 1 (tap 9 is padding: its weights are 0, A reads tap 8)
#pragma unroll
        for (int ks = 0; ks < 5; ++ks) {
          const int t = aunit ? min(2 * ks + 1, 8) : 2 * ks;
          const int toff = (t / 3) * PS_TH + t % 3;
          const unsigned a_addr[2] = {st + (a_pix[0] + toff) * 16,
                                      st + (a_pix[1] + toff) * 16};
          mma_step(ks, a_addr);
        }
      } else {
#pragma unroll
        for (int t = 0; t < 9; ++t) {
          const int ky = t / 3, kx = t % 3;
          unsigned a_addr[2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const int p = a_pix[mt] + ky * PS_TH + kx;
            a_addr[mt] = st + swz2(p, p % PS_TH, aunit);
          }
          mma_step(ch * 9 + t, a_addr);
        }
      }
      if (ch != nch - 1) continue;
      finish(item_of(blockIdx.x + (s / nch) * gridDim.x));
    }
    cp_async_wait<0>();
  }
}

using PairFn = void (*)(const void*, int, const int8_t*, const float*,
                        const float*, float, float, int8_t*, int, int, int,
                        int, int);

PairFn pick(int fold, int nc) {
  if (nc == 16)
    return fold == FOLD_TAPS        ? phase_pair_tc_kernel<FOLD_TAPS, 16>
         : fold == FOLD_TAP_PAIRS   ? phase_pair_tc_kernel<FOLD_TAP_PAIRS, 16>
                                    : phase_pair_tc_kernel<FOLD_CHUNKS, 16>;
  return fold == FOLD_TAPS        ? phase_pair_tc_kernel<FOLD_TAPS, 32>
       : fold == FOLD_TAP_PAIRS   ? phase_pair_tc_kernel<FOLD_TAP_PAIRS, 32>
                                  : phase_pair_tc_kernel<FOLD_CHUNKS, 32>;
}

}  // namespace

// The K fold a pair with Cin input channels runs: 0 taps, 1 tap pairs,
// 2 chunks (all on the tensor cores).
extern "C" int srod_phase_pair_fold(int Cin) { return fold_of(Cin); }

// x_dtype: 0 int8 (inv_in unused, pass 0), 1 uint8, 2 float32 (raw
// frames, requantized on load with inv_in). The grid: a persistent block
// for each one resident at once, divided among the channel groups (along
// y), at most one a work item.
extern "C" int srod_phase_pair(const void* x, int x_dtype, const void* w,
                               const void* dq, const void* bias,
                               float inv_in, float inv_out, void* out,
                               int B, int H, int W, int Cin, int Cout,
                               void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || (H % 2) || (W % 2) || Cin <= 0 ||
      Cin > PS_MAX_CIN || Cout <= 0 || x_dtype < 0 || x_dtype > 2 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int fold = fold_of(Cin);
  const int nc = Cout <= 16 ? 16 : 32;
  const int groups = (Cout + nc - 1) / nc;
  const PairFn fn = pick(fold, nc);
  const int smem = layout(fold, Cin, nc).total;
  const long long tiles = static_cast<long long>(B) *
                          ((H / 2 + PS_PT - 1) / PS_PT) *
                          ((W / 2 + PS_PT - 1) / PS_PT);
  int dev = 0, sms = 0, per_sm = 0;
  if (tiles > 0x7fffffff || groups > 65535 ||
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, PS_THREADS,
                                                    smem) != cudaSuccess ||
      per_sm < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  long long n = static_cast<long long>(sms) * per_sm / groups;
  n = n < 1 ? 1 : n;
  n = n < tiles ? n : tiles;
  fn<<<dim3(static_cast<unsigned>(n), groups), PS_THREADS, smem,
       static_cast<cudaStream_t>(stream)>>>(
      x, x_dtype, static_cast<const int8_t*>(w),
      static_cast<const float*>(dq), static_cast<const float*>(bias), inv_in,
      inv_out, static_cast<int8_t*>(out), B, H, W, Cin, Cout);
  return static_cast<int>(cudaGetLastError());
}
