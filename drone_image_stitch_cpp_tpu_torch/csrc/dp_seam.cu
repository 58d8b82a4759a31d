// The DP seam's min-cost vertical path in one launch.
//
// Replaces no Pallas kernel: the JAX package runs the same recurrence as a
// lax.scan over rows (drone_image_stitch_cpp_tpu/ops/seam.py), which XLA
// compiles into one loop on the device. The port's plain version
// (ops/seam_kernel.seam_path_plain) runs it as a host loop of small
// launches, about eight a row, so a scan of ~250 rows cost ~35 ms of host
// time on an H100 whatever its width, and a thermal sortie makes ~1600.
//
// The work is tiny (h * w three-way minima) and serial in the rows, so it
// is bound by the row-to-row barrier, not by bytes or operations. One
// block walks all rows: each thread owns columns tid, tid + blockDim, ...;
// the running row sums live in shared memory, double-buffered, so a row
// costs one __syncthreads. The move table goes to device memory (int8),
// then the block takes the first-minimum column of the last row and thread
// 0 backtracks. Ties and rounding are those of the plain version: the
// three-way minimum keeps the lowest offset (-1, 0, +1) on ties, each row
// sum is one float32 add, and the last row's argmin is its first minimum,
// so the kernel returns the plain version's path bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr float kPad = 3e38f;           // the plain version's out-of-row cost
constexpr size_t kSmemCap = 48 * 1024;  // larger rows keep their sums in
                                        // the caller's scratch

__global__ void __launch_bounds__(kMaxThreads)
dp_seam_kernel(const float* __restrict__ cost, long long ld, int h, int w,
               float* scratch, int8_t* __restrict__ offs,
               long long* __restrict__ xs) {
  extern __shared__ float smem[];
  __shared__ float red_v[kMaxThreads / 32];
  __shared__ int red_i[kMaxThreads / 32];
  float* prev = scratch != nullptr ? scratch : smem;
  float* cur = prev + w;
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int c = tid; c < w; c += nt) prev[c] = cost[c];
  __syncthreads();
  for (int r = 1; r < h; ++r) {
    const float* row = cost + (long long)r * ld;
    int8_t* orow = offs + (long long)r * w;
    for (int c = tid; c < w; c += nt) {
      float best = c > 0 ? prev[c - 1] : kPad;
      int arg = -1;
      const float mid = prev[c];
      if (mid < best) { best = mid; arg = 0; }
      const float right = c + 1 < w ? prev[c + 1] : kPad;
      if (right < best) { best = right; arg = 1; }
      orow[c] = (int8_t)arg;
      cur[c] = __fadd_rn(row[c], best);
    }
    __syncthreads();
    float* t = prev; prev = cur; cur = t;
  }

  // first minimum of the last row: each thread's own first minimum over
  // its columns (ascending), then the lowest column among equal values
  float bv = __int_as_float(0x7f800000);
  int bi = w;
  for (int c = tid; c < w; c += nt) {
    const float v = prev[c];
    if (v < bv) { bv = v; bi = c; }
  }
  for (int s = 16; s > 0; s >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, s);
    const int oi = __shfl_down_sync(0xffffffffu, bi, s);
    if (ov < bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
  }
  if ((tid & 31) == 0) { red_v[tid >> 5] = bv; red_i[tid >> 5] = bi; }
  __syncthreads();
  if (tid == 0) {
    for (int k = 1; k < nt / 32; ++k)
      if (red_v[k] < bv || (red_v[k] == bv && red_i[k] < bi)) {
        bv = red_v[k]; bi = red_i[k];
      }
    int x = bi;
    xs[h - 1] = x;
    for (int r = h - 1; r > 0; --r) {
      x += offs[(long long)r * w + x];
      x = x < 0 ? 0 : (x > w - 1 ? w - 1 : x);
      xs[r - 1] = x;
    }
  }
}

}  // namespace

// Shared memory the launch takes for a row of w columns; 0 means the row
// sums go to a scratch of 2 * w floats that the caller passes.
extern "C" long long dp_seam_smem_bytes(int w) {
  const size_t b = 2ull * (size_t)w * sizeof(float);
  return b <= kSmemCap ? (long long)b : 0;
}

// cost: (h, w) float32, rows ld floats apart; offs: (h, w) int8 scratch
// (row 0 unused); xs: (h,) int64, the path's column per row; scratch:
// 2 * w floats where dp_seam_smem_bytes(w) is 0, else ignored. One block
// on `stream`; returns the launch's cudaError.
extern "C" int dp_seam_path(const float* cost, long long ld, int h, int w,
                            float* scratch, int8_t* offs, long long* xs,
                            void* stream) {
  if (h < 1 || w < 1 || ld < w) return (int)cudaErrorInvalidValue;
  const long long smem = dp_seam_smem_bytes(w);
  if (smem == 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  int threads = ((w + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  dp_seam_kernel<<<1, threads, (size_t)smem, (cudaStream_t)stream>>>(
      cost, ld, h, w, smem == 0 ? scratch : nullptr, offs, xs);
  return (int)cudaGetLastError();
}
