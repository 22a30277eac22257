// Greedy class-offset NMS over a fixed candidate pool, one block per image.
//
// Computes what lpc_yolo_tpu/ops/postprocess.py::non_max_suppression's
// `nms_one` scan computes (:144-163), not a bitmask NMS with other semantics:
// live = score where score > conf, else -1; then up to max_det steps, each
// taking j = the first index of the largest live score, stopping at the first
// step whose best is <= 0 (every later JAX step is invalid too), emitting row
// j, and setting live = -1 at j and wherever IoU(box_j, box_i) > iou_thres on
// the label-offset boxes. The JAX package has no Pallas kernel here: XLA
// compiles the scan. A plain PyTorch loop would launch ~25 kernels a step.
//
// Bound: neither bytes nor operations. The pool is read once (28 bytes a
// candidate) and the rows written once, a few microseconds of HBM time; the
// IoU work is ~15 operations per live candidate per step. What bounds it is
// the chain of max_det dependent steps, each a block-wide argmax. The design
// keeps the pool (offset box, area, live score: 24 bytes a candidate, 96 KB
// at the default 4096) in shared memory for the whole loop, fuses each step's
// suppression pass with the next step's per-thread argmax, and double-buffers
// the per-warp partials so that a step needs one __syncthreads. Only B blocks
// are live (32 of 132 SMs at b32): making it fast is later work.
//
// Rounding: every IoU operation is written as a round-to-nearest intrinsic, so
// nvcc cannot contract a*b + c into an FMA and the IoU is the one the plain
// PyTorch version computes, operation by operation, in the JAX order
// inter / (area1 + area2 - inter + 1e-7). A box at the threshold then falls on
// the same side in both.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// The better of two (value, index) candidates: the larger value, the lower index on a tie.
__device__ __forceinline__ void better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ __forceinline__ float box_area(float4 q) {
  return __fmul_rn(__fsub_rn(q.z, q.x), __fsub_rn(q.w, q.y));
}

__global__ void __launch_bounds__(1024) nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
                                                   const int* __restrict__ labels, const int* __restrict__ anchors,
                                                   float* __restrict__ out, int* __restrict__ out_anchor, int k,
                                                   int max_det, float conf, float iou_thres, float max_wh,
                                                   int agnostic) {
  extern __shared__ float4 smem[];
  float4* off = smem;                                   // k offset boxes
  float* area = reinterpret_cast<float*>(off + k);      // k areas of the offset boxes
  float* live = area + k;                               // k live scores
  float* part_v = live + k;                             // 2 x 32 per-warp best values
  int* part_i = reinterpret_cast<int*>(part_v + 64);    // 2 x 32 per-warp best indices

  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const float4* bx = boxes + (size_t)b * k;
  const float* sc = scores + (size_t)b * k;
  const int* lb = labels + (size_t)b * k;
  float* rows = out + (size_t)b * max_det * 6;
  int* rows_anchor = out_anchor + (size_t)b * max_det;

  float bv = -2.0f;
  int bi = INT_MAX;
  for (int i = tid; i < k; i += nt) {
    float4 q = bx[i];
    const float o = agnostic ? 0.0f : __fmul_rn((float)lb[i], max_wh);
    q.x = __fadd_rn(q.x, o);
    q.y = __fadd_rn(q.y, o);
    q.z = __fadd_rn(q.z, o);
    q.w = __fadd_rn(q.w, o);
    off[i] = q;
    area[i] = box_area(q);
    const float s = sc[i];
    const float l = s > conf ? s : -1.0f;
    live[i] = l;
    if (l > bv) {  // i rises, so the first of equal values stays
      bv = l;
      bi = i;
    }
  }

  int t = 0;
  for (; t < max_det; ++t) {
    for (int o = 16; o > 0; o >>= 1) better(bv, bi, __shfl_down_sync(kFull, bv, o), __shfl_down_sync(kFull, bi, o));
    const int buf = (t & 1) * 32;
    if (lane == 0) {
      part_v[buf + warp] = bv;
      part_i[buf + warp] = bi;
    }
    __syncthreads();  // also publishes the initial pass's shared arrays at t = 0
    float v = lane < nw ? part_v[buf + lane] : -2.0f;
    int j = lane < nw ? part_i[buf + lane] : INT_MAX;
    for (int o = 16; o > 0; o >>= 1) better(v, j, __shfl_xor_sync(kFull, v, o), __shfl_xor_sync(kFull, j, o));
    if (!(v > 0.0f)) break;  // the same v in every thread

    if (tid == 0) {
      const float4 q = bx[j];
      float* r = rows + (size_t)t * 6;
      r[0] = q.x;
      r[1] = q.y;
      r[2] = q.z;
      r[3] = q.w;
      r[4] = sc[j];
      r[5] = (float)lb[j];
      rows_anchor[t] = anchors[(size_t)b * k + j];
    }
    // suppress against box j, and find each thread's best of what stays live for the next step
    const float4 qj = off[j];
    const float aj = area[j];
    bv = -2.0f;
    bi = INT_MAX;
    for (int i = tid; i < k; i += nt) {
      const float l = live[i];
      if (i == j) {
        live[i] = -1.0f;
        continue;
      }
      if (!(l > 0.0f)) continue;  // never selected again: suppressing it changes nothing
      const float4 q = off[i];
      const float w = fmaxf(__fsub_rn(fminf(qj.z, q.z), fmaxf(qj.x, q.x)), 0.0f);
      const float h = fmaxf(__fsub_rn(fminf(qj.w, q.w), fmaxf(qj.y, q.y)), 0.0f);
      const float inter = __fmul_rn(w, h);
      const float iou = __fdiv_rn(inter, __fadd_rn(__fsub_rn(__fadd_rn(aj, area[i]), inter), 1e-7f));
      if (iou > iou_thres) {
        live[i] = -1.0f;
        continue;
      }
      if (l > bv) {
        bv = l;
        bi = i;
      }
    }
  }
  // rows t..max_det-1 are invalid: zeros with label -1, anchor 0
  for (int e = tid; e < (max_det - t) * 6; e += nt) rows[(size_t)t * 6 + e] = (e % 6 == 5) ? -1.0f : 0.0f;
  for (int e = t + tid; e < max_det; e += nt) rows_anchor[e] = 0;
}

}  // namespace

// boxes (B, k, 4) xyxy f32, scores (B, k) f32, labels and anchors (B, k) int32, all contiguous;
// out (B, max_det, 6) f32, out_anchor (B, max_det) int32. Returns the launch's cudaError_t.
extern "C" int nms_launch(const void* boxes, const void* scores, const void* labels, const void* anchors, void* out,
                          void* out_anchor, int B, int k, int max_det, float conf, float iou_thres, float max_wh,
                          int agnostic, void* stream) {
  if (B <= 0 || max_det <= 0) return 0;
  if (k < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)k * (sizeof(float4) + 2 * sizeof(float)) + 64 * (sizeof(float) + sizeof(int));
  static size_t opted = 48 * 1024;  // dynamic shared memory the kernel may use without opting in
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted = smem;
  }
  int threads = ((k + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  nms_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const float*>(scores), static_cast<const int*>(labels),
      static_cast<const int*>(anchors), static_cast<float*>(out), static_cast<int*>(out_anchor), k, max_det, conf,
      iou_thres, max_wh, agnostic);
  return (int)cudaGetLastError();
}
