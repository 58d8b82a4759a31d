// K2: exact bilinear affine warp of a uint8 BGR frame + its content mask.
//
// Replaces the Pallas TPU kernel drone_image_stitch_cpp_tpu/ops/
// pallas_warp.py::_kernel (launched through _run, four launches per compose
// feed: three channels and the content mask, compose_feed.py:92,97). The
// TPU kernel avoided gathers with a two-pass shift-select that is only
// valid for near-identity transforms (|linear - I| <= 0.05). On the H100 a
// gather is cheap, so this kernel is the direct per-pixel bilinear gather
// of ops/warp.warp_affine for any affine, with no envelope and no tile
// plan, and ONE launch reads the uint8 frame and writes all three float32
// channels plus the warped all-ones content mask.
//
// What bounds it on the H100: memory traffic. Per output pixel it writes
// 16 bytes (3 channels + mask, float32) and reads 4 taps x 3 bytes of
// uint8 source; a 2176x3904 window is ~136 MB written and ~25 MB of
// source read (taps of neighbouring threads share cache lines, so the
// source is read about once through L2). One thread per output pixel keeps
// the design simple; coalescing of the 12-byte pixel stores is left to a
// later pass.
//
// Rounding: source coordinates are ((i00*x) + (i01*y)) + i02 and the blend
// is ((v00*(1-fx)) + (v01*fx))*(1-fy) + ..., each step rounded to nearest
// with __fmul_rn/__fadd_rn so nvcc cannot contract them into FMAs. That is
// the operation order of the plain PyTorch version, so both agree even at
// canvas coordinates of ~1.6e4 px where an FMA would move fx visibly.
//
// Plain C interface for ctypes; returns the cudaGetLastError() code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float tap(const uint8_t* __restrict__ src, int h,
                                     int w, int y, int x, int c, bool* inb) {
  *inb = (y >= 0) & (y < h) & (x >= 0) & (x < w);
  return *inb ? (float)src[((size_t)y * w + x) * 3 + c] : 0.f;
}

__device__ __forceinline__ float lerp2(float v00, float v01, float v10,
                                       float v11, float fx, float fy) {
  const float gx = __fsub_rn(1.f, fx);
  const float gy = __fsub_rn(1.f, fy);
  const float top = __fadd_rn(__fmul_rn(v00, gx), __fmul_rn(v01, fx));
  const float bot = __fadd_rn(__fmul_rn(v10, gx), __fmul_rn(v11, fx));
  return __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, fy));
}

__global__ void __launch_bounds__(kThreads)
warp_affine_u8_kernel(const uint8_t* __restrict__ src, int h, int w,
                      float i00, float i01, float i02, float i10, float i11,
                      float i12, float* __restrict__ out,
                      float* __restrict__ mask, int out_h, int out_w) {
  const size_t p = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (p >= (size_t)out_h * out_w) return;
  const float x = (float)(int)(p % out_w);
  const float y = (float)(int)(p / out_w);
  const float sx = __fadd_rn(__fadd_rn(__fmul_rn(i00, x), __fmul_rn(i01, y)),
                             i02);
  const float sy = __fadd_rn(__fadd_rn(__fmul_rn(i10, x), __fmul_rn(i11, y)),
                             i12);
  const float x0 = floorf(sx);
  const float y0 = floorf(sy);
  const float fx = __fsub_rn(sx, x0);
  const float fy = __fsub_rn(sy, y0);
  // saturating conversion; out-of-range taps fail the bounds test below
  const int xi = (int)fmaxf(fminf(x0, 2.0e9f), -2.0e9f);
  const int yi = (int)fmaxf(fminf(y0, 2.0e9f), -2.0e9f);
  bool b00, b01, b10, b11;
  for (int c = 0; c < 3; ++c) {
    const float v00 = tap(src, h, w, yi, xi, c, &b00);
    const float v01 = tap(src, h, w, yi, xi + 1, c, &b01);
    const float v10 = tap(src, h, w, yi + 1, xi, c, &b10);
    const float v11 = tap(src, h, w, yi + 1, xi + 1, c, &b11);
    out[p * 3 + c] = lerp2(v00, v01, v10, v11, fx, fy);
  }
  mask[p] = lerp2(b00 ? 1.f : 0.f, b01 ? 1.f : 0.f, b10 ? 1.f : 0.f,
                  b11 ? 1.f : 0.f, fx, fy);
}

}  // namespace

extern "C" int warp_affine_u8(const uint8_t* src, int h, int w, float i00,
                              float i01, float i02, float i10, float i11,
                              float i12, float* out, float* mask, int out_h,
                              int out_w, void* stream) {
  const size_t n = (size_t)out_h * out_w;
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  warp_affine_u8_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      src, h, w, i00, i01, i02, i10, i11, i12, out, mask, out_h, out_w);
  return (int)cudaGetLastError();
}
