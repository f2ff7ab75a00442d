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
// runs C=20 classes at k=128 (about 50 KB in), so the recurrence's k
// dependent steps, each ended by a __syncthreads(), and the launch
// itself are the cost. Design:
//   * one block per class; the class's box edges, areas and probs live in
//     dynamic shared memory (k up to SROD_NMS_MAX_K; above 48 KB the
//     launch raises the block's shared-memory limit first);
//   * the block walks the ranks in order; for a live rank r its threads
//     compute IoU(r, q) on the fly for q > r in parallel — no k x k
//     matrix is materialized;
//   * ranks past the last positive prob can never survive, so the walk
//     stops there (a block-wide max found in the prologue).
// The IoU is computed in the Pallas kernel's expression order with
// round-to-nearest intrinsics, so nvcc's FMA contraction cannot move a
// knife-edge `> thresh` decision.

#include <cuda_runtime.h>

#define SROD_NMS_THREADS 256
#define SROD_NMS_MAX_K 8192

__global__ void nms_per_class_kernel(const float* __restrict__ boxes,
                                     const float* __restrict__ probs,
                                     float* __restrict__ out, int k,
                                     float thresh) {
  extern __shared__ float smem[];
  float* x1 = smem;
  float* x2 = x1 + k;
  float* y1 = x2 + k;
  float* y2 = y1 + k;
  float* area = y2 + k;
  float* p = area + k;
  unsigned char* sup = reinterpret_cast<unsigned char*>(p + k);
  __shared__ int n_live;

  const int c = blockIdx.x;
  const float* bc = boxes + static_cast<size_t>(c) * k * 4;
  const float* pc = probs + static_cast<size_t>(c) * k;
  if (threadIdx.x == 0) n_live = 0;
  __syncthreads();

  int last = 0;
  for (int q = threadIdx.x; q < k; q += blockDim.x) {
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
  }
  atomicMax(&n_live, last);
  __syncthreads();

  const int n = n_live;
  for (int r = 0; r < n; ++r) {
    // every thread reads the same shared flags: the branch is uniform
    if (p[r] > 0.0f && !sup[r]) {
      const float rx1 = x1[r], rx2 = x2[r], ry1 = y1[r], ry2 = y2[r];
      const float ra = area[r];
      for (int q = r + 1 + threadIdx.x; q < k; q += blockDim.x) {
        const float iw = __fsub_rn(fminf(rx2, x2[q]), fmaxf(rx1, x1[q]));
        const float ih = __fsub_rn(fminf(ry2, y2[q]), fmaxf(ry1, y1[q]));
        const float inter =
            (iw < 0.0f || ih < 0.0f) ? 0.0f : __fmul_rn(iw, ih);
        const float uni = __fsub_rn(__fadd_rn(ra, area[q]), inter);
        if (__fdiv_rn(inter, uni) > thresh) sup[q] = 1;
      }
    }
    __syncthreads();
  }

  float* oc = out + static_cast<size_t>(c) * k;
  for (int q = threadIdx.x; q < k; q += blockDim.x)
    oc[q] = sup[q] ? 0.0f : p[q];
}

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

extern "C" int srod_nms_max_k() { return SROD_NMS_MAX_K; }

extern "C" const char* srod_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
