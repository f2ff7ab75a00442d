// Per-class greedy NMS over rank-sorted top-k candidates.
//
// Replaces the Pallas TPU kernel sr_object_detection_tpu/kernels/
// nms_pallas.py (_nms_kernel, via nms_per_class_pallas and
// nms_sort_topk_pallas), which builds a (k, k) IoU matrix per class in
// VMEM and runs the rank recurrence as a fori_loop over iota masks.
//
// Semantics (box.c do_nms_sort:249-277 restricted to the top k): per
// class, rank r survives if p[r] > 0 and no surviving higher rank killed
// it; a survivor kills every lower rank q whose IoU(r, q) > thresh
// (strict). Output: p with the killed ranks zeroed.
//
// What bounds it on an H100: latency, not bytes or FLOPs. The main path
// runs C=20 classes at k=128 (about 50 KB in), so the recurrence's chain
// of dependent steps and the launch itself are the cost. Design:
//   * one block per class; the class's box edges, areas and probs live in
//     dynamic shared memory (k up to SROD_NMS_MAX_K; above 48 KB the
//     launch raises the block's shared-memory limit first), O(k), so one
//     kernel serves every k;
//   * the ranks are taken in chunks of 32. For chunk j the block's warps
//     first compute the 32x32 diagonal block's suppression bits (row r,
//     bit q set for q > r in the chunk with IoU(r, q) > thresh), one
//     __ballot_sync a row; after one __syncthreads() every thread resolves
//     the chunk's survivors itself, serially in registers: rank r
//     survives if p[r] > 0, no earlier chunk suppressed it and no earlier
//     survivor of the chunk has its bit set. Then the threads suppress
//     the ranks past the chunk against its survivors (at most 32 IoUs a
//     rank, split over up to 32 threads a rank where few ranks remain,
//     two IoUs in flight a thread). The diagonal rows are double-buffered,
//     so the next chunk's rows are computed while other threads still
//     resolve this one: ceil(n / 32) barriers for the recurrence, not n;
//   * 512 threads a block: at the Detector's k=128 the chunks' serial
//     chain sets the time, and 1024 threads take longer over the prologue
//     and the barriers; from k=512 to 845 on random boxes 512 and 1024
//     threads take the same time, 256 up to 1.5x longer
//     (tools/nms_ab.py --variants);
//   * ranks past the last positive prob can never survive, so the walk
//     stops there, and ranks past the last prob that is not +0 read +0
//     whether suppressed or not, so the suppression stops there (both
//     block-wide maxima found in the prologue). On a frame's candidates
//     (a few live ranks in a few classes) that leaves one chunk and no
//     later ranks to test.
// The IoU is computed in the Pallas kernel's expression order with
// round-to-nearest intrinsics, so nvcc's FMA contraction cannot move a
// knife-edge `> thresh` decision: every decision, and so the output, is
// the rank-by-rank walk's bit for bit.

#include <cuda_runtime.h>

#define SROD_NMS_MAX_K 8192
#define SROD_NMS_THREADS 512
#define SROD_NMS_CHUNK 32

namespace {

// IoU(r, q) > thresh, from the staged edges and areas of r and q
__device__ __forceinline__ bool overlaps(float rx1, float rx2, float ry1,
                                         float ry2, float ra, float qx1,
                                         float qx2, float qy1, float qy2,
                                         float qa, float thresh) {
  const float iw = __fsub_rn(fminf(rx2, qx2), fmaxf(rx1, qx1));
  const float ih = __fsub_rn(fminf(ry2, qy2), fmaxf(ry1, qy1));
  const float inter = (iw < 0.0f || ih < 0.0f) ? 0.0f : __fmul_rn(iw, ih);
  const float uni = __fsub_rn(__fadd_rn(ra, qa), inter);
  return __fdiv_rn(inter, uni) > thresh;
}

}  // namespace

__global__ void __launch_bounds__(SROD_NMS_THREADS)
nms_per_class_kernel(const float* __restrict__ boxes,
                     const float* __restrict__ probs,
                     float* __restrict__ out, int k, float thresh) {
  extern __shared__ float smem[];
  float* x1 = smem;
  float* x2 = x1 + k;
  float* y1 = x2 + k;
  float* y2 = y1 + k;
  float* area = y2 + k;
  float* p = area + k;
  unsigned char* sup = reinterpret_cast<unsigned char*>(p + k);
  __shared__ unsigned rows[2][SROD_NMS_CHUNK];
  __shared__ int n_live, n_tail;

  const int c = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* bc = boxes + static_cast<size_t>(c) * k * 4;
  const float* pc = probs + static_cast<size_t>(c) * k;
  if (tid == 0) n_live = 0, n_tail = 0;
  __syncthreads();

  int last = 0, tail = 0;
  for (int q = tid; q < k; q += blockDim.x) {
    const float x = bc[4 * q + 0], y = bc[4 * q + 1];
    const float w = bc[4 * q + 2], h = bc[4 * q + 3];
    const float hw = __fmul_rn(w, 0.5f), hh = __fmul_rn(h, 0.5f);
    x1[q] = __fsub_rn(x, hw);
    x2[q] = __fadd_rn(x, hw);
    y1[q] = __fsub_rn(y, hh);
    y2[q] = __fadd_rn(y, hh);
    area[q] = __fmul_rn(w, h);
    const float pq = pc[q];
    p[q] = pq;
    sup[q] = 0;
    if (pq > 0.0f) last = q + 1;
    if (__float_as_uint(pq) != 0u) tail = q + 1;
  }
  atomicMax(&n_live, last);
  atomicMax(&n_tail, tail);
  __syncthreads();

  const int n = n_live, nz = n_tail;
  constexpr int NW = SROD_NMS_THREADS / 32;
  // the previous chunk's ranks that its own survivors suppressed, flagged
  // after the next barrier (their flags are read only by the output)
  unsigned pend = 0;
  int pbase = 0;
  for (int base = 0, j = 0; base < n; base += SROD_NMS_CHUNK, ++j) {
    unsigned* rw = rows[j & 1];
    // the diagonal block: warp w computes rows w, w + NW, ...; lane = q
    {
      const int q = base + lane;
      const bool qin = q < k;
      const float qx1 = qin ? x1[q] : 0.f, qx2 = qin ? x2[q] : 0.f;
      const float qy1 = qin ? y1[q] : 0.f, qy2 = qin ? y2[q] : 0.f;
      const float qa = qin ? area[q] : 0.f;
      for (int i = warp; i < SROD_NMS_CHUNK; i += NW) {
        const int r = base + i;
        bool hit = false;
        if (r < n && p[r] > 0.0f && qin && lane > i)
          hit = overlaps(x1[r], x2[r], y1[r], y2[r], area[r], qx1, qx2, qy1,
                         qy2, qa, thresh);
        const unsigned bits = __ballot_sync(0xffffffffu, hit);
        if (lane == 0) rw[i] = bits;
      }
    }
    // the chunk's sup flags (set by earlier chunks) and rows are final
    __syncthreads();
    if (tid < SROD_NMS_CHUNK && (pend >> tid & 1u)) sup[pbase + tid] = 1;
    // every thread resolves the chunk's survivors in registers
    const int r0 = base + lane;
    const unsigned cand = __ballot_sync(
        0xffffffffu, r0 < n && p[r0] > 0.0f && !sup[r0]);
    unsigned row[SROD_NMS_CHUNK];    // loaded ahead of the serial chain
#pragma unroll
    for (int i = 0; i < SROD_NMS_CHUNK; ++i) row[i] = rw[i];
    unsigned killed = 0, surv = 0;
#pragma unroll
    for (int i = 0; i < SROD_NMS_CHUNK; ++i) {
      const bool take = (cand >> i & 1u) && !(killed >> i & 1u);
      surv |= take ? 1u << i : 0u;
      killed |= take ? row[i] : 0u;
    }
    // the ranks past the chunk against its survivors: g threads a rank,
    // thread t of a rank taking the survivors i = t mod g
    const int end = base + SROD_NMS_CHUNK;
    if (surv && end < nz) {
      const int nq = nz - end;
      int g = 1;
      while (g < 32 && 2 * g * nq <= SROD_NMS_THREADS) g *= 2;
      // bits i = t mod g: 0xffffffff / (2^g - 1) repeats a 1 every g bits
      const unsigned every = 0xffffffffu / ((g == 32 ? 0u : 1u << g) - 1u);
      const unsigned mine = surv & (every << (tid & (g - 1)));
      for (int q = end + tid / g; q < nz; q += SROD_NMS_THREADS / g) {
        if (sup[q]) continue;
        const float qx1 = x1[q], qx2 = x2[q], qy1 = y1[q], qy2 = y2[q];
        const float qa = area[q];
        // two survivors a step, so that two IoUs are in flight
        for (unsigned m = mine; m;) {
          const int r = base + __ffs(m) - 1;
          m &= m - 1;
          bool hit = overlaps(x1[r], x2[r], y1[r], y2[r], area[r], qx1, qx2,
                              qy1, qy2, qa, thresh);
          if (m) {
            const int r2 = base + __ffs(m) - 1;
            m &= m - 1;
            hit |= overlaps(x1[r2], x2[r2], y1[r2], y2[r2], area[r2], qx1,
                            qx2, qy1, qy2, qa, thresh);
          }
          if (hit) {
            sup[q] = 1;
            break;
          }
        }
      }
    }
    pend = killed;
    pbase = base;
  }
  __syncthreads();
  if (tid < SROD_NMS_CHUNK && (pend >> tid & 1u)) sup[pbase + tid] = 1;
  __syncthreads();

  float* oc = out + static_cast<size_t>(c) * k;
  for (int q = tid; q < k; q += blockDim.x)
    oc[q] = sup[q] ? 0.0f : p[q];
}

// The launch floor of nms_per_class_kernel: the same grid, block and
// dynamic shared memory, no work (a measurement of chip_smoke.py and
// tools/nms_ab.py, not a part of the NMS path).
__global__ void __launch_bounds__(SROD_NMS_THREADS) nms_empty_kernel() {}

extern "C" int srod_nms_per_class(const void* boxes, const void* probs,
                                  void* out, int n_classes, int k,
                                  float thresh, void* stream) {
  if (n_classes <= 0 || k <= 0 || k > SROD_NMS_MAX_K)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(k) * (6 * sizeof(float) + 1);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        nms_per_class_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  nms_per_class_kernel<<<n_classes, SROD_NMS_THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(probs),
      static_cast<float*>(out), k, thresh);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int srod_nms_empty(int n_classes, int k, void* stream) {
  if (n_classes <= 0 || k <= 0 || k > SROD_NMS_MAX_K)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(k) * (6 * sizeof(float) + 1);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        nms_empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  nms_empty_kernel<<<n_classes, SROD_NMS_THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" int srod_nms_max_k() { return SROD_NMS_MAX_K; }

extern "C" const char* srod_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
