// Per-tensor symmetric int8 quantization of an NHWC activation into a channel slice of an NHWC s8 buffer:
// y[b, h, w, c] = clip(rint(x[b, h, w, c] * inv), -127, 127), rint half to even.
//
// Replaces no TPU kernel. The JAX package quantizes in XLA passes ahead of its int8 convs
// (lpc_yolo_tpu/nn/quant.py:131 and :142-147, `jnp.clip(jnp.round(x * (1.0 / sx)), -127, 127)`), writing the
// parts of a C2f/C2fCIB concat tail and of the SPPF tail into one s8 concat (q8_concat_conv,
// q8_pool_concat_conv). Here one launch quantizes one part straight into its channel slice of the s8 buffer
// that conv_s8.cu reads, so the wide bf16 concat is never built.
//
// Bound: bytes (2 or 4 read and 1 written per element, one multiply and a round each), so a thread takes four
// neighbouring channels: its reads are contiguous with its neighbours' and it writes one 32-bit word where the
// slice is 4-byte aligned. `inv` is the f32 of the double 1 / sx, as the JAX package uses it; the product is
// rounded before the round to integer (__fmul_rn, no contraction).
//
// Layouts: x is (B, H, W, C) f32 or bf16 with any four strides (channel-contiguous is the fast case); y points at
// the slice's first channel of pixel 0 and has pixel stride syp (the buffer's channel count), channels
// contiguous.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ int8_t quant(float v, float inv) {
  const int q = __float2int_rn(__fmul_rn(v, inv));
  return static_cast<int8_t>(min(max(q, -127), 127));
}

template <typename T>
__global__ void __launch_bounds__(NT) quantize_s8_kernel(const T* __restrict__ x, int8_t* __restrict__ y, int H,
                                                         int W, int C, long long sxb, long long sxh, long long sxw,
                                                         long long sxc, long long syp, float inv, long long n,
                                                         int word) {
  const int groups = (C + 3) >> 2;
  for (long long t = (long long)blockIdx.x * NT + threadIdx.x; t < n; t += (long long)gridDim.x * NT) {
    const long long p = t / groups;
    const int c = static_cast<int>(t - p * groups) * 4;
    const long long hw = (long long)H * W;
    const long long b = p / hw;
    const int r = static_cast<int>(p - b * hw);
    const int h = r / W, wi = r - h * W;
    const T* src = x + b * sxb + h * sxh + wi * sxw + c * sxc;
    int8_t* dst = y + p * syp + c;
    if (c + 4 <= C) {
      char4 q;
      q.x = quant(load(src), inv);
      q.y = quant(load(src + sxc), inv);
      q.z = quant(load(src + 2 * sxc), inv);
      q.w = quant(load(src + 3 * sxc), inv);
      if (word) {
        *reinterpret_cast<char4*>(dst) = q;
      } else {
        dst[0] = q.x;
        dst[1] = q.y;
        dst[2] = q.z;
        dst[3] = q.w;
      }
    } else {
      for (int e = 0; c + e < C; ++e) dst[e] = quant(load(src + e * sxc), inv);
    }
  }
}

}  // namespace

// x (B, H, W, C) with strides (sxb, sxh, sxw, sxc), f32 (dtype 0) or bf16 (1); y the slice's base, pixel stride
// syp. Returns the launch's cudaError_t.
extern "C" int quantize_s8_launch(const void* x, void* y, int B, int H, int W, int C, long long sxb, long long sxh,
                                  long long sxw, long long sxc, long long syp, float inv, int dtype, void* stream) {
  if (dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * H * W * ((C + 3) / 4);
  if (n <= 0) return 0;
  const int word = syp % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 4 == 0;
  const long long want = (n + NT - 1) / NT;
  const unsigned blocks = (unsigned)(want < 132LL * 64 ? want : 132LL * 64);  // a grid-stride loop past that
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* yp = static_cast<int8_t*>(y);
  if (dtype == 0)
    quantize_s8_kernel<float><<<blocks, NT, 0, s>>>(static_cast<const float*>(x), yp, H, W, C, sxb, sxh, sxw, sxc,
                                                    syp, inv, n, word);
  else
    quantize_s8_kernel<__nv_bfloat16><<<blocks, NT, 0, s>>>(static_cast<const __nv_bfloat16*>(x), yp, H, W, C, sxb,
                                                            sxh, sxw, sxc, syp, inv, n, word);
  return (int)cudaGetLastError();
}
