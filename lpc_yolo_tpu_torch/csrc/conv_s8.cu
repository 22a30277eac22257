// s8 x s8 -> s32 implicit-GEMM convolution (1x1 or 3x3, stride 1 or 2, same padding, groups 1) with a
// dequantize + bias + activation epilogue: y = act(acc * (sx * sw[c]) + b[c]), acc the exact s32 sum.
//
// Replaces no TPU kernel. The JAX package runs its int8 serving convs as XLA's lax.conv_general_dilated over s8
// operands with preferred_element_type=int32 and dequantizes in a second pass (lpc_yolo_tpu/nn/quant.py:135-139,
// :186-189, :244-248). PyTorch has no int8 convolution on CUDA (torch._int_mm covers a 1x1 conv's GEMM only and
// returns s32 that another pass must dequantize), so the port's int8 serving path (nn/quant.py) needs its own.
//
// Bound: 2*k*k*C*Co integer operations per output pixel, against C input bytes per input pixel and Co outputs
// (2 bytes each in bf16) per output pixel, each moved once: the 3x3 sites and the wide 1x1s sit above the
// H100's int8 ridge (~590 operations a byte at 1,979 TOP/s over 3.35 TB/s), the narrow 1x1s below it. This first kernel is the simple shape of an
// implicit GEMM on the int8 tensor cores: M = the block's 128 output pixels, N = 64 output channels, K = taps x
// C walked in 64-byte chunks, double-buffered in shared memory with 16-byte cp.async copies (zero-fill writes
// the padding, the ragged pixel and channel tails), mma.sync m16n8k32 s8 -> s32, and the epilogue on the
// accumulators. wgmma/TMA and a deeper ring are later work; its times stand beside its bound in PERF.md.
//
// Layouts: x is NHWC s8 with channel stride 1 and any batch/row/pixel strides (a channel slice of a buffer
// needs no copy); w is (Co, kh, kw, C) s8 contiguous, so each output channel's K values are contiguous and a
// B fragment (4 consecutive K bytes of one channel) is one 32-bit shared load: sm_90 has no 8-bit ldmatrix
// transpose that would read them from an HWIO tile. sw (Co,) and bias (Co,) are f32; y is NHWC contiguous,
// bf16 or f32. The epilogue rounds as the JAX package does in f32: the s32 sum to f32, times the f32 product
// sx * sw[c], plus the bias, each rounded (no contraction into an fma).
//
// A C that is no multiple of 16, or strides or pointers that are not 16-byte aligned, take the same tiling with
// byte loads in place of cp.async.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 64, BK = 64, PITCH = BK + 16, NT = 128;

__device__ __forceinline__ float activate(float v, int act) {
  if (act == 1) return v / (1.0f + expf(-v));
  if (act == 2) {
    const float sp = fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
    return v * tanhf(sp);
  }
  if (act == 3) return fmaxf(v, 0.0f);
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct Geo {
  int H, W, C, Ho, Wo, Co, k, s, pad;
  long long M, sxb, sxh, sxw;
};

// 128 threads = 4 warps, 2 (pixels) x 2 (channels); a warp owns 64 pixels x 32 channels: 4 x 4 mma tiles.
template <bool VEC>
__global__ void __launch_bounds__(NT) conv_s8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                                                     const float* __restrict__ sw, float sx,
                                                     const float* __restrict__ bias, void* __restrict__ y, Geo g,
                                                     int act, int out_bf16) {
  __shared__ __align__(16) int8_t As[2][BM * PITCH];
  __shared__ __align__(16) int8_t Bs[2][BN * PITCH];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const long long m0 = (long long)blockIdx.x * BM;
  const int co0 = blockIdx.y * BN;
  const long long K = (long long)g.k * g.k * g.C;  // a weight row
  const int chunk = tid & 3;                       // the 16-byte column of the rows this thread loads
  const int row = tid >> 2;                        // rows row + 32 i

  // the four A rows (output pixels) this thread stages: batch offset, top-left input coordinate
  long long a_base[4];
  int a_ih[4], a_iw[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + row + 32 * i;
    if (m < g.M) {
      const long long hw = (long long)g.Ho * g.Wo;
      const long long b = m / hw;
      const int r = static_cast<int>(m - b * hw);
      const int oh = r / g.Wo, ow = r - oh * g.Wo;
      a_base[i] = b * g.sxb;
      a_ih[i] = oh * g.s - g.pad;
      a_iw[i] = ow * g.s - g.pad;
    } else {
      a_base[i] = 0;
      a_ih[i] = -(1 << 28);  // never inside the map
      a_iw[i] = 0;
    }
  }

  const int csteps = (g.C + BK - 1) / BK;
  const int nsteps = g.k * g.k * csteps;

  auto stage = [&](int step, int buf) {
    const int tap = step / csteps;
    const int c = (step - tap * csteps) * BK + chunk * 16;
    const int r = tap / g.k, q = tap - r * g.k;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int8_t* dst = &As[buf][(row + 32 * i) * PITCH + chunk * 16];
      const int ih = a_ih[i] + r, iw = a_iw[i] + q;
      const bool in = ih >= 0 && ih < g.H && iw >= 0 && iw < g.W && c < g.C;
      const int8_t* src = in ? x + a_base[i] + ih * g.sxh + iw * g.sxw + c : x;
      if (VEC) {
        cp_async16(dst, src, in ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) dst[e] = in && c + e < g.C ? src[e] : int8_t(0);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = row + 32 * j, o = co0 + n;
      int8_t* dst = &Bs[buf][n * PITCH + chunk * 16];
      const bool in = o < g.Co && c < g.C;
      const int8_t* src = in ? w + o * K + (long long)tap * g.C + c : w;
      if (VEC) {
        cp_async16(dst, src, in ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e) dst[e] = in && c + e < g.C ? src[e] : int8_t(0);
      }
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  stage(0, 0);
  cp_async_commit();
  const int gr = lane >> 2, gc = (lane & 3) * 4;  // fragment row (pixel or channel) and byte column
  for (int step = 0; step < nsteps; ++step) {
    const int buf = step & 1;
    if (step + 1 < nsteps) {
      stage(step + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* A = As[buf];
    const int8_t* Bt = Bs[buf];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* p = A + (wm * 64 + i * 16 + gr) * PITCH + kk + gc;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * PITCH);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * PITCH + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = Bt + (wn * 32 + j * 8 + gr) * PITCH + kk + gc;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }

  // epilogue: accumulator e of tile (i, j) is pixel row gr (+8 for e >= 2), channel 2 (lane & 3) + (e & 1)
  const bool pairs = (g.Co & 1) == 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = co0 + wn * 32 + j * 8 + (lane & 3) * 2;
    float sc[2], bb[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = o + e < g.Co;
      sc[e] = ok ? __fmul_rn(sx, sw[o + e]) : 0.0f;
      bb[e] = ok ? bias[o + e] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long m = m0 + wm * 64 + i * 16 + gr + h * 8;
        if (m >= g.M) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[e] = activate(__fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][h * 2 + e]), sc[e]), bb[e]), act);
        const long long off = m * g.Co + o;
        if (out_bf16) {
          __nv_bfloat16* yp = static_cast<__nv_bfloat16*>(y) + off;
          if (pairs && o + 1 < g.Co) {
            *reinterpret_cast<__nv_bfloat162*>(yp) = __floats2bfloat162_rn(v[0], v[1]);
          } else {
            for (int e = 0; e < 2; ++e)
              if (o + e < g.Co) yp[e] = __float2bfloat16_rn(v[e]);
          }
        } else {
          float* yp = static_cast<float*>(y) + off;
          if (pairs && o + 1 < g.Co) {
            *reinterpret_cast<float2*>(yp) = make_float2(v[0], v[1]);
          } else {
            for (int e = 0; e < 2; ++e)
              if (o + e < g.Co) yp[e] = v[e];
          }
        }
      }
    }
  }
}

}  // namespace

// x (B, H, W, C) s8 with strides (sxb, sxh, sxw, 1); w (Co, k, k, C) s8; sw, bias (Co,) f32; y (B, Ho, Wo, Co)
// contiguous, bf16 (out_dtype 1) or f32 (0). k 1 or 3, stride 1 or 2, padding k / 2. act: 0 = none, 1 = SiLU,
// 2 = Mish, 3 = ReLU. Returns the launch's cudaError_t.
extern "C" int conv_s8_launch(const void* x, const void* w, const void* sw, float sx, const void* bias, void* y,
                              int B, int H, int W, int C, int Co, int k, int stride, long long sxb, long long sxh,
                              long long sxw, int act, int out_dtype, void* stream) {
  if ((k != 1 && k != 3) || (stride != 1 && stride != 2) || act < 0 || act > 3 || out_dtype < 0 || out_dtype > 1)
    return (int)cudaErrorInvalidValue;
  Geo g;
  g.H = H;
  g.W = W;
  g.C = C;
  g.k = k;
  g.s = stride;
  g.pad = k / 2;
  g.Ho = (H + 2 * g.pad - k) / stride + 1;
  g.Wo = (W + 2 * g.pad - k) / stride + 1;
  g.Co = Co;
  g.M = (long long)B * g.Ho * g.Wo;
  g.sxb = sxb;
  g.sxh = sxh;
  g.sxw = sxw;
  if (g.M <= 0 || Co <= 0 || C <= 0) return 0;
  const dim3 grid((unsigned)((g.M + BM - 1) / BM), (Co + BN - 1) / BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = C % 16 == 0 && sxb % 16 == 0 && sxh % 16 == 0 && sxw % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* swp = static_cast<const float*>(sw);
  const float* bp = static_cast<const float*>(bias);
  if (vec)
    conv_s8_kernel<true><<<grid, NT, 0, s>>>(xp, wp, swp, sx, bp, y, g, act, out_dtype);
  else
    conv_s8_kernel<false><<<grid, NT, 0, s>>>(xp, wp, swp, sx, bp, y, g, act, out_dtype);
  return (int)cudaGetLastError();
}
