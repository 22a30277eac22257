// Same-padded 3x3 stride-1 groups-1 conv with a bias + activation epilogue.
//
// Replaces lpc_yolo_tpu/ops/pallas_conv.py::conv3x3_pallas (_conv3_kernel:
// nine per-tap MXU dots into an f32 accumulator, then + b and apply_act).
// The epilogue adds the bias and applies none / SiLU / Mish / ReLU (softplus
// in its stable form, as jax.nn.softplus, on the f32 path), in f32.
//
// Bound: on LPC-YOLO's serving shapes (C, Co in 16..384, maps 20^2..320^2)
// the work is 2*9*C*Co flops per pixel against (C + Co) elements moved, so
// the small-channel convs sit under the H100's ~295 flops/byte ridge (bytes
// bound) and the widest above it (operations bound at the bf16 peak). What
// a kernel of this shape loses is staging and reuse, not the tensor cores'
// rate: the bf16 path below therefore reads each halo chunk once per block
// for all of the block's output channels (up to 128), overlaps the next
// chunks' copies with the current chunk's MMAs, and applies the epilogue on
// the accumulators. Its times per shape stand beside the bound in PERF.md.
//
// Layouts: x is NHWC with channel stride 1 and arbitrary batch/row/pixel
// strides (a channel slice of a channels_last tensor needs no copy); w is
// HWIO (3, 3, C, Co) contiguous; bias is f32 (Co,); y is NHWC contiguous.
// x, w and y share one dtype: f32 or bf16 (accumulation is always f32).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TH = 8, TW = 16, CK = 16, COT = 32, NT = 256;  // the f32 path's tiling

__device__ __forceinline__ float activate(float v, int act) {
  if (act == 1) return v / (1.0f + expf(-v));
  if (act == 2) {
    const float sp = fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
    return v * tanhf(sp);
  }
  if (act == 3) return fmaxf(v, 0.0f);
  return v;
}

// CUDA-core f32 path: thread = 4 pixels (along w) x 4 output channels.
__global__ void __launch_bounds__(NT) conv3x3_f32(
    const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias, float* __restrict__ y,
    int H, int W, int C, int Co, long long sxb, long long sxh, long long sxw, int act, int tiles_w,
    int tiles_h) {
  __shared__ float xs[TH + 2][TW + 2][CK + 1];
  __shared__ __align__(16) float ws[9][CK][COT];

  int t = blockIdx.x;
  const int tw = t % tiles_w;
  t /= tiles_w;
  const int th = t % tiles_h;
  const int b = t / tiles_h;
  const int h0 = th * TH, w0 = tw * TW, co0 = blockIdx.y * COT;
  const int tid = threadIdx.x;
  const int cg = tid & 7;          // output channels co0 + 4*cg .. +3
  const int pg = tid >> 3;         // pixel group 0..31
  const int pr = pg >> 2;          // tile row 0..7
  const int pc = (pg & 3) * 4;     // tile columns pc .. pc+3

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.0f;

  const float* xb = x + (long long)b * sxb;
  for (int c0 = 0; c0 < C; c0 += CK) {
    for (int i = tid; i < (TH + 2) * (TW + 2) * CK; i += NT) {
      const int ci = i % CK;
      const int p = i / CK;
      const int cc = p % (TW + 2), rr = p / (TW + 2);
      const int hh = h0 + rr - 1, ww = w0 + cc - 1, c = c0 + ci;
      float v = 0.0f;
      if (hh >= 0 && hh < H && ww >= 0 && ww < W && c < C) v = xb[hh * sxh + ww * sxw + c];
      xs[rr][cc][ci] = v;
    }
    for (int i = tid; i < 9 * CK * COT; i += NT) {
      const int co = i % COT;
      const int p = i / COT;
      const int ci = p % CK, tap = p / CK;
      const int c = c0 + ci, o = co0 + co;
      float v = 0.0f;
      if (c < C && o < Co) v = w[((long long)tap * C + c) * Co + o];
      ws[tap][ci][co] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const int tap = kh * 3 + kw;
#pragma unroll 4
        for (int ci = 0; ci < CK; ++ci) {
          const float4 wv = *reinterpret_cast<const float4*>(&ws[tap][ci][cg * 4]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float xv = xs[pr + kh][pc + j + kw][ci];
            acc[j][0] = fmaf(xv, wv.x, acc[j][0]);
            acc[j][1] = fmaf(xv, wv.y, acc[j][1]);
            acc[j][2] = fmaf(xv, wv.z, acc[j][2]);
            acc[j][3] = fmaf(xv, wv.w, acc[j][3]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int hh = h0 + pr;
  if (hh >= H) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int ww = w0 + pc + j;
    if (ww >= W) continue;
    float* yp = y + (((long long)b * H + hh) * W + ww) * Co;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int o = co0 + cg * 4 + q;
      if (o < Co) yp[o] = activate(acc[j][q] + bias[o], act);
    }
  }
}

// ---- bf16 tensor-core path ------------------------------------------------
//
// Implicit GEMM: M = the block's TILE_H x TILE_W output pixels, N = BN output
// channels, K = 9 taps x C, walked in chunks of CK channels. Each chunk stages
// the (TILE_H+2) x (TILE_W+2) x CK input halo and the 9 x CK x BN weight slice
// into one slot of a STAGES-deep shared-memory ring with 16-byte cp.async
// copies; zero-fill (src-size 0) writes the conv's padding, the ragged tile
// edges and the channels past C. Chunk k+STAGES-1 loads while chunk k
// computes, with one __syncthreads per chunk.
//
// A warp owns WM pixels x WN channels. A fragments (16 pixels x 16 channels)
// come from the halo with ldmatrix.x4, one row address per lane, so a
// fragment is any 16 output pixels shifted by the tap; B fragments come from
// the HWIO weight slice with ldmatrix.x4.trans; mma.sync m16n8k16 bf16 -> f32.
// Both shared layouts pad each row by 16 bytes (halo pixel pitch CK+8, weight
// row pitch BN+8 elements), so the 8 rows an ldmatrix phase reads land on 8
// different 16-byte bank groups. The epilogue adds the bias and applies the
// activation on the accumulators, then stages the bf16 tile in shared memory
// (the ring's space) for 16-byte coalesced stores, or stores bf16 pairs
// straight from the registers where Co is no multiple of 8.
//
// The tiles (kConfigs) were chosen by timing candidates on an H100 with
// `chip_smoke.py --conv3x3`: 16-channel chunks beat 32 on the large maps
// (smaller rings, more blocks per SM); the small maps take wider tiles with
// 32-channel chunks, whose weight slice is then read by fewer blocks.

template <int TILE_H, int TILE_W, int BN, int CK, int STAGES, int WM, int WN>
struct Tile {
  static constexpr int M = TILE_H * TILE_W, WARPS_M = M / WM, WARPS_N = BN / WN;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int HALO_W = TILE_W + 2, HALO_PX = (TILE_H + 2) * HALO_W;
  static constexpr int PA = CK + 8, PB = BN + 8;  // row pitches in elements
  static constexpr int XS_BYTES = HALO_PX * PA * 2, WS_BYTES = 9 * CK * PB * 2;
  static constexpr int STAGE_BYTES = XS_BYTES + WS_BYTES, RING_BYTES = STAGES * STAGE_BYTES;
  static constexpr int EPI_BYTES = M * PB * 2;  // the bf16 output tile, rows of pitch PB, staged for 16-byte stores
  static constexpr int SMEM = RING_BYTES > EPI_BYTES ? RING_BYTES : EPI_BYTES;
  static constexpr int MF = WM / 16, NF = WN / 8;
  static_assert(M % WM == 0 && BN % WN == 0 && WM % 16 == 0 && WN % 16 == 0, "warp tiling");
  static_assert(CK % 16 == 0 && STAGES >= 2 && THREADS <= 1024, "chunk and ring");
  static_assert(TILE_W % 8 == 0, "8-pixel ldmatrix phases stay inside one tile row");
  static_assert(SMEM <= 232448, "dynamic shared memory of one block");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
               "{%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// none / SiLU / Mish / ReLU with the fast intrinsics. Mish as v * tanh(softplus(v)) =
// v * n(n+2) / (n(n+2) + 2) with n = e^v, which is v itself to f32 above 20.
__device__ __forceinline__ float activate_fast(float v, int act) {
  if (act == 1) return __fdividef(v, 1.0f + __expf(-v));
  if (act == 2) {
    if (v > 20.0f) return v;
    const float n = __expf(v), q = n * (n + 2.0f);
    return v * __fdividef(q, q + 2.0f);
  }
  if (act == 3) return fmaxf(v, 0.0f);
  return v;
}

// 8 channels of x or w read one element at a time (the unaligned path), zero past `valid`.
__device__ __forceinline__ uint4 gather8(const __nv_bfloat16* src, int valid) {
  union { uint4 v; __nv_bfloat16 e[8]; } u;
#pragma unroll
  for (int j = 0; j < 8; ++j) u.e[j] = j < valid ? src[j] : __float2bfloat16_rn(0.0f);
  return u.v;
}

template <int TILE_H, int TILE_W, int BN, int CK, int STAGES, int WM, int WN>
__global__ void __launch_bounds__(Tile<TILE_H, TILE_W, BN, CK, STAGES, WM, WN>::THREADS) conv3x3_bf16_mma(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ y, int H, int W, int C, int Co, long long sxb, long long sxh, long long sxw,
    int act, int tiles_w, int tiles_h, int vec_x, int vec_w, int vec_y) {
  using T = Tile<TILE_H, TILE_W, BN, CK, STAGES, WM, WN>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_u32(smem);

  int t = blockIdx.x;
  const int tw = t % tiles_w;
  t /= tiles_w;
  const int th = t % tiles_h;
  const int b = t / tiles_h;
  const int h0 = th * TILE_H, w0 = tw * TILE_W, co0 = blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp % T::WARPS_M, wn = warp / T::WARPS_M;
  const __nv_bfloat16* xb = x + (long long)b * sxb;
  const int nchunks = (C + CK - 1) / CK;

  // Issue the copies of chunk `c0` into ring slot `slot` (the caller commits the group).
  auto load = [&](int slot, int c0) {
    const uint32_t xs = sbase + slot * T::STAGE_BYTES, ws = xs + T::XS_BYTES;
    constexpr int XQ = CK / 8, WQ = BN / 8;
    for (int i = tid; i < T::HALO_PX * XQ; i += T::THREADS) {
      const int p = i / XQ, q = i % XQ;
      const int hh = h0 - 1 + p / T::HALO_W, ww = w0 - 1 + p % T::HALO_W, c = c0 + q * 8;
      const bool in = hh >= 0 && hh < H && ww >= 0 && ww < W && c < C;
      const __nv_bfloat16* src = in ? xb + hh * sxh + ww * sxw + c : x;
      const uint32_t dst = xs + (p * T::PA + q * 8) * 2;
      if (vec_x)
        cp_async16(dst, src, in ? 16 : 0);
      else
        st_shared16(dst, gather8(src, in ? C - c : 0));
    }
    for (int i = tid; i < 9 * CK * WQ; i += T::THREADS) {
      const int r = i / WQ, q = i % WQ;  // r = tap * CK + channel in chunk
      const int tap = r / CK, c = c0 + r % CK, o = co0 + q * 8;
      const bool in = c < C && o < Co;
      const __nv_bfloat16* src = in ? w + ((long long)tap * C + c) * Co + o : w;
      const uint32_t dst = ws + (r * T::PB + q * 8) * 2;
      if (vec_w)
        cp_async16(dst, src, in ? 16 : 0);
      else
        st_shared16(dst, gather8(src, in ? Co - o : 0));
    }
  };

  float acc[T::MF][T::NF][4];
#pragma unroll
  for (int i = 0; i < T::MF; ++i)
#pragma unroll
    for (int j = 0; j < T::NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  // Lane addresses, in bytes inside a ring slot, for tap (0, 0) and the chunk's first 16 channels.
  uint32_t a_off[T::MF];
#pragma unroll
  for (int i = 0; i < T::MF; ++i) {
    const int m = wm * WM + i * 16 + (lane & 15);
    a_off[i] = (((m / TILE_W) * T::HALO_W + m % TILE_W) * T::PA + (lane >> 4) * 8) * 2;
  }
  const uint32_t b_off = T::XS_BYTES + ((lane & 15) * T::PB + wn * WN + (lane >> 4) * 8) * 2;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nchunks) load(s, s * CK);
    cp_async_commit();
  }
  for (int k = 0; k < nchunks; ++k) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk k have landed
    __syncthreads();              // everyone's have, and slot (k-1) % STAGES is free
    const int next = k + STAGES - 1;
    if (next < nchunks) load(next % STAGES, next * CK);
    cp_async_commit();
    const uint32_t slot = sbase + (k % STAGES) * T::STAGE_BYTES;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
#pragma unroll
      for (int ks = 0; ks < CK / 16; ++ks) {
        uint32_t a[T::MF][4], bq[T::NF / 2][4];
#pragma unroll
        for (int i = 0; i < T::MF; ++i)
          ldsm_x4(a[i], slot + a_off[i] + (((tap / 3) * T::HALO_W + tap % 3) * T::PA + ks * 16) * 2);
#pragma unroll
        for (int j = 0; j < T::NF / 2; ++j)
          ldsm_x4_trans(bq[j], slot + b_off + ((tap * CK + ks * 16) * T::PB + j * 16) * 2);
#pragma unroll
        for (int i = 0; i < T::MF; ++i)
#pragma unroll
          for (int j = 0; j < T::NF; ++j) mma_bf16(acc[i][j], a[i], bq[j / 2][(j & 1) * 2], bq[j / 2][(j & 1) * 2 + 1]);
      }
    }
  }
  cp_async_wait<0>();

  // Epilogue from the accumulators: lane holds rows lane/4 and lane/4 + 8 of each
  // 16-pixel fragment, channels 2*(lane%4) and +1 of each 8-channel fragment. With
  // vec_y the bf16 pairs go to a (pixels x BN) tile in shared memory (the ring's
  // space) and leave it in 16-byte stores; else straight from the registers.
  float b0[T::NF], b1[T::NF];
#pragma unroll
  for (int j = 0; j < T::NF; ++j) {
    const int o = co0 + wn * WN + j * 8 + (lane & 3) * 2;
    b0[j] = o < Co ? bias[o] : 0.0f;
    b1[j] = o + 1 < Co ? bias[o + 1] : 0.0f;
  }
  if (vec_y) {
    __syncthreads();  // every warp is done reading the ring
#pragma unroll
    for (int i = 0; i < T::MF; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = wm * WM + i * 16 + (lane >> 2) + half * 8;
#pragma unroll
        for (int j = 0; j < T::NF; ++j) {
          const int n = wn * WN + j * 8 + (lane & 3) * 2;
          *reinterpret_cast<__nv_bfloat162*>(smem + (m * T::PB + n) * 2) = __floats2bfloat162_rn(
              activate_fast(acc[i][j][half * 2] + b0[j], act), activate_fast(acc[i][j][half * 2 + 1] + b1[j], act));
        }
      }
    __syncthreads();
    constexpr int NQ = BN / 8;
    for (int i = tid; i < T::M * NQ; i += T::THREADS) {
      const int m = i / NQ, o = co0 + (i % NQ) * 8;
      const int hh = h0 + m / TILE_W, ww = w0 + m % TILE_W;
      if (hh < H && ww < W && o < Co)
        *reinterpret_cast<uint4*>(y + (((long long)b * H + hh) * W + ww) * Co + o) =
            *reinterpret_cast<const uint4*>(smem + (m * T::PB + (i % NQ) * 8) * 2);
    }
    return;
  }
  const bool pairs = (Co & 1) == 0;
#pragma unroll
  for (int i = 0; i < T::MF; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = wm * WM + i * 16 + (lane >> 2) + half * 8;
      const int hh = h0 + m / TILE_W, ww = w0 + m % TILE_W;
      if (hh >= H || ww >= W) continue;
      __nv_bfloat16* yp = y + (((long long)b * H + hh) * W + ww) * Co;
#pragma unroll
      for (int j = 0; j < T::NF; ++j) {
        const int o = co0 + wn * WN + j * 8 + (lane & 3) * 2;
        const float v0 = activate_fast(acc[i][j][half * 2] + b0[j], act);
        const float v1 = activate_fast(acc[i][j][half * 2 + 1] + b1[j], act);
        if (pairs && o + 1 < Co) {
          *reinterpret_cast<__nv_bfloat162*>(yp + o) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (o < Co) yp[o] = __float2bfloat16_rn(v0);
          if (o + 1 < Co) yp[o + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

template <int TILE_H, int TILE_W, int BN, int CK, int STAGES, int WM, int WN>
int launch_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w, const float* bias, __nv_bfloat16* y, int B, int H,
                int W, int C, int Co, long long sxb, long long sxh, long long sxw, int act, int vec_x, int vec_w,
                int vec_y, cudaStream_t s) {
  using T = Tile<TILE_H, TILE_W, BN, CK, STAGES, WM, WN>;
  auto kern = conv3x3_bf16_mma<TILE_H, TILE_W, BN, CK, STAGES, WM, WN>;
  static unsigned long long ready = 0;  // one bit per device: dynamic shared memory above 48 KB allowed
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!(ready >> dev & 1ull)) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return (int)e;
    ready |= 1ull << dev;
  }
  const int tiles_h = (H + TILE_H - 1) / TILE_H, tiles_w = (W + TILE_W - 1) / TILE_W;
  const dim3 grid((unsigned)B * tiles_h * tiles_w, (Co + BN - 1) / BN);
  kern<<<grid, T::THREADS, T::SMEM, s>>>(x, w, bias, y, H, W, C, Co, sxb, sxh, sxw, act, tiles_w, tiles_h, vec_x,
                                         vec_w, vec_y);
  return (int)cudaGetLastError();
}

template <int TILE_H, int TILE_W, int BN, int CK, int STAGES, int WM, int WN>
void describe(int* out) {
  using T = Tile<TILE_H, TILE_W, BN, CK, STAGES, WM, WN>;
  const int v[9] = {TILE_H, TILE_W, BN, CK, STAGES, WM, WN, T::THREADS, T::SMEM};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
}

using LaunchFn = int (*)(const __nv_bfloat16*, const __nv_bfloat16*, const float*, __nv_bfloat16*, int, int, int, int,
                         int, long long, long long, long long, int, int, int, int, cudaStream_t);
struct Config {
  LaunchFn launch;
  void (*describe)(int*);
};
#define CONV3X3_CONFIG(...) {launch_bf16<__VA_ARGS__>, describe<__VA_ARGS__>}

// The instantiations, by index; ops/conv3x3.py::CONFIGS lists the same tuples in the
// same order and picks one per shape. (TILE_H, TILE_W, BN, CK, STAGES, WM, WN):
const Config kConfigs[] = {
    // 16x16 pixels, 16-channel chunks: the large maps, and C that is no multiple of 32
    CONV3X3_CONFIG(16, 16, 16, 16, 2, 32, 16),
    CONV3X3_CONFIG(16, 16, 32, 16, 2, 32, 32),
    CONV3X3_CONFIG(16, 16, 64, 16, 3, 64, 32),
    CONV3X3_CONFIG(16, 16, 128, 16, 3, 64, 32),
    // Co up to 64 on the 40^2 maps (8x16 wastes 1/6 of a 40-wide row) and the 20^2 maps (4x24, 1/6)
    CONV3X3_CONFIG(8, 16, 64, 32, 2, 32, 32),
    CONV3X3_CONFIG(4, 24, 64, 32, 2, 32, 32),
    // Co past 64 on the 80^2 and 40^2 maps (8x40, whole rows of 40) and the 20^2 maps (4x24)
    CONV3X3_CONFIG(8, 40, 128, 32, 2, 80, 32),
    CONV3X3_CONFIG(4, 24, 128, 16, 2, 32, 32),
};
constexpr int kNumConfigs = sizeof(kConfigs) / sizeof(kConfigs[0]);

}  // namespace

extern "C" int conv3x3_num_configs() { return kNumConfigs; }

// (TILE_H, TILE_W, BN, CK, STAGES, WM, WN, threads, dynamic shared bytes) of bf16 configuration `config`.
extern "C" int conv3x3_describe(int config, int* out) {
  if (config < 0 || config >= kNumConfigs) return (int)cudaErrorInvalidValue;
  kConfigs[config].describe(out);
  return 0;
}

// dtype: 0 = f32, 1 = bf16. act: 0 = none, 1 = SiLU, 2 = Mish, 3 = ReLU. config: the bf16
// instantiation (an index into kConfigs); the f32 path has one tiling and ignores it.
extern "C" int conv3x3_launch(const void* x, const void* w, const void* bias, void* y, int B, int H,
                              int W, int C, int Co, long long sxb, long long sxh, long long sxw, int act,
                              int dtype, int config, void* stream) {
  if (act < 0 || act > 3) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || W <= 0 || Co <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const int tiles_h = (H + TH - 1) / TH, tiles_w = (W + TW - 1) / TW;
    const dim3 grid((unsigned)B * tiles_h * tiles_w, (Co + COT - 1) / COT);
    conv3x3_f32<<<grid, NT, 0, s>>>(static_cast<const float*>(x), static_cast<const float*>(w),
                                    static_cast<const float*>(bias), static_cast<float*>(y), H, W, C, Co, sxb,
                                    sxh, sxw, act, tiles_w, tiles_h);
    return (int)cudaGetLastError();
  }
  if (dtype != 1 || config < 0 || config >= kNumConfigs) return (int)cudaErrorInvalidValue;
  const int vec_x = C % 8 == 0 && sxb % 8 == 0 && sxh % 8 == 0 && sxw % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_w = Co % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int vec_y = Co % 8 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  return kConfigs[config].launch(static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
                                 static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), B, H, W, C, Co,
                                 sxb, sxh, sxw, act, vec_x, vec_w, vec_y, s);
}
