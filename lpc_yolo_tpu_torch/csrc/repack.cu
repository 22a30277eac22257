// Width-pack factor change (B, H, W/pf, pf*C) -> (B, H, W/pt, pt*C), pt | pf.
//
// Replaces lpc_yolo_tpu/ops/pallas_layout.py::repack_width_pallas
// (_repack_kernel), which streamed the relayout through VMEM as per-column
// lane slices: out[b, h, wi*r + q, j] = in[b, h, wi, q*ptc + j], r = pf/pt,
// ptc = pt*C. The r lane blocks of one input column land side by side in the
// output row, so the element order of a row never changes: column wi of the
// input (pf*C contiguous elements) is copied to offset wi*pf*C of the
// contiguous output row, whatever pt is. On a TPU the lane-dimension change
// forces a physical relayout; here the only real work is gathering a strided
// input (a slice of a larger staging buffer) into a contiguous output.
//
// The wrapper therefore hands the kernel a byte-level copy plan: the input as
// up to three strided outer dimensions (n0, n1, n2; strides in bytes) around
// a contiguous run of `run` bytes, with every input dimension that is already
// contiguous folded into the run. The output is the runs back to back.
//
// Bound: memory. No arithmetic but the index split; each byte is read once
// and written once. The design keeps every access as wide as alignment
// allows (16 bytes a thread when the pointer, the run and the strides are all
// multiples of 16; else 8, 4, 2 or 1), puts neighbouring threads on
// neighbouring addresses, and gives each thread one vector so that enough
// loads are in flight to cover the memory latency. The element type never
// matters: uint8, bf16/f16 and f32 are all copied by byte width.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V>
__global__ void repack_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                              unsigned total,    // vectors in the output
                              unsigned per_run,  // vectors in one contiguous run
                              unsigned n1, unsigned n2, long long s0, long long s1, long long s2) {
  const unsigned idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  unsigned r = idx / per_run;
  const unsigned o = idx - r * per_run;
  const unsigned i2 = r % n2;
  r /= n2;
  const unsigned i1 = r % n1;
  const unsigned i0 = r / n1;
  const uint8_t* src = in + i0 * s0 + i1 * s1 + i2 * s2 + (size_t)o * sizeof(V);
  *reinterpret_cast<V*>(out + (size_t)idx * sizeof(V)) = *reinterpret_cast<const V*>(src);
}

template <typename V>
int launch(const void* in, void* out, long long n_runs, long long run, int n1, int n2,
           long long s0, long long s1, long long s2, cudaStream_t stream) {
  const long long per_run = run / (long long)sizeof(V);
  const long long total = n_runs * per_run;
  if (total >= (1ll << 32) - 256) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  repack_kernel<V><<<blocks, threads, 0, stream>>>(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), (unsigned)total, (unsigned)per_run,
      (unsigned)n1, (unsigned)n2, s0, s1, s2);
  return (int)cudaGetLastError();
}

}  // namespace

// in: n0 x n1 x n2 runs of `run` bytes at byte strides s0, s1, s2; out: the
// runs back to back. vec is the access width in bytes (16, 8, 4, 2 or 1) and
// must divide run, the strides and both pointers.
extern "C" int repack_launch(const void* in, void* out, int n0, int n1, int n2, long long s0, long long s1,
                             long long s2, long long run, int vec, void* stream) {
  const long long n_runs = (long long)n0 * n1 * n2;
  if (n_runs <= 0 || run <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 16: return launch<uint4>(in, out, n_runs, run, n1, n2, s0, s1, s2, st);
    case 8: return launch<uint2>(in, out, n_runs, run, n1, n2, s0, s1, s2, st);
    case 4: return launch<uint32_t>(in, out, n_runs, run, n1, n2, s0, s1, s2, st);
    case 2: return launch<uint16_t>(in, out, n_runs, run, n1, n2, s0, s1, s2, st);
    case 1: return launch<uint8_t>(in, out, n_runs, run, n1, n2, s0, s1, s2, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
