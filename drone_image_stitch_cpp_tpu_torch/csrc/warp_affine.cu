// K2: exact bilinear affine warp of BGR frames (uint8 or float32) + their
// content masks.
//
// Replaces the Pallas TPU kernel drone_image_stitch_cpp_tpu/ops/
// pallas_warp.py::_kernel (launched through _run; entries warp_affine and
// warp_affine_many; four launches per compose feed on the TPU: three
// channels and the content mask, compose_feed.py:92,97). The TPU kernel
// avoided gathers with a two-pass shift-select that is only valid for
// near-identity transforms (|linear - I| <= 0.05). On the H100 a gather is
// cheap, so this kernel is the direct per-pixel bilinear gather of
// ops/warp.warp_affine for any affine, and ONE launch reads N frames and
// writes all three float32 channels plus the warped content mask of each
// (grid: pixel blocks x frames). The mask is the warp of all-ones (the
// strip compose: the source rectangle's footprint) or, in content mode
// (the global compose, compose_feed.py:94-96; uint8 sources only), the warp
// of the source's gray > 2 indicator, computed per tap from the 3 values
// the tap already reads, so content mode costs no extra memory traffic.
//
// The source is templated on its element type: uint8 BGR (the frames as
// decoded), float32 BGR (the frames area-resized for compositing below
// full resolution, strip.py:227-239, which the JAX package warps
// unquantised) or packed I420 uint8 (the frame store's JPEG planes, the
// JAX package's yuv420 wire: Y rows [0, H), then U as H/4 rows of width W
// that ravel the (H/2, W/2) plane, then V the same way; H % 4 == 0,
// W % 2 == 0). All feed the same arithmetic: a tap's three channels become
// floats, exactly the values the uint8 path has always used. An I420 tap
// is converted where it is read, as ops/color.yuv420_to_bgr converts the
// whole frame: chroma upsampled with libjpeg's triangle filter (0.75/0.25
// along W, then along H, edges replicated), 128 subtracted, the full-range
// JFIF matrix, each channel clipped to [0, 255]. Converting in the tap
// keeps the source at 1.5 bytes a pixel: the float32 BGR of a 4K frame is
// 99.5 MB, and a 12-frame seam batch would hold 1.19 GB of it.
//
// What bounds it on the H100: memory traffic, almost all of it stores. Per
// output pixel it writes 16 bytes (3 channels + mask, float32) and reads
// 4 taps x 3 values of source (3 bytes each for uint8, 12 for float32; an
// I420 tap reads 1 luma byte and 4 bytes of each chroma plane, mostly from
// L1); a 2176x3904 window is ~136 MB written. So each thread produces 4
// consecutive output pixels and writes them as three 16-byte stores of BGR
// (48 B) and one 16-byte store of the mask; a uint8 tap is read as the
// aligned 32-bit word(s) holding its 3 bytes, a float32 tap as three
// 4-byte loads (a 12-byte pixel has no wider aligned load).
//
// Rounding: each pixel's source coordinates are ((i00*x) + (i01*y)) + i02
// from its own (x, y), and the blend is ((v00*(1-fx)) + (v01*fx))*(1-fy)
// + ..., each step rounded to nearest with __fmul_rn/__fadd_rn so nvcc
// cannot contract them into FMAs. That is the operation order of the plain
// PyTorch version, so both agree bit for bit even at canvas coordinates of
// ~1.6e4 px where an FMA would move fx visibly. Content mode's gray is
// ((b*0.114f) + (g*0.587f)) + (r*0.299f) with the same rounding, the plain
// version's ops/color.content_mask, so no pixel crosses 2.0 differently.
//
// Plain C interface for ctypes; each entry returns the cudaGetLastError()
// code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 4;              // output pixels per thread

struct Coeffs {
  float i00, i01, i02, i10, i11, i12;
};

// Tag type of a packed I420 source (one byte per element).
struct I420 {
  uint8_t v;
};

// The 3 bytes of the pixel at src + off (B in the low byte), read as the
// aligned word that holds the first byte and, when the pixel straddles a
// word boundary, the next one. Both words hold a byte of this pixel, so
// neither read leaves the frame's pages.
__device__ __forceinline__ uint32_t load_bgr(const uint8_t* src, size_t off) {
  const uintptr_t addr = (uintptr_t)(src + off);
  const uint32_t* word = (const uint32_t*)(addr & ~(uintptr_t)3);
  const uint32_t sh = (uint32_t)(addr & 3);
  const uint32_t lo = __ldg(word);
  const uint32_t hi = sh > 1 ? __ldg(word + 1) : 0u;
  return __funnelshift_r(lo, hi, 8 * sh);
}

__device__ __forceinline__ float lerp2(float v00, float v01, float v10,
                                       float v11, float fx, float fy) {
  const float gx = __fsub_rn(1.f, fx);
  const float gy = __fsub_rn(1.f, fy);
  const float top = __fadd_rn(__fmul_rn(v00, gx), __fmul_rn(v01, fx));
  const float bot = __fadd_rn(__fmul_rn(v10, gx), __fmul_rn(v11, fx));
  return __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, fy));
}

// The three channels of source pixel `pix` (a pixel index) as floats.
__device__ __forceinline__ void load_tap(const uint8_t* src, size_t pix,
                                         float* c) {
  const uint32_t v = load_bgr(src, pix * 3);
  c[0] = (float)(v & 0xffu);
  c[1] = (float)((v >> 8) & 0xffu);
  c[2] = (float)((v >> 16) & 0xffu);
}

__device__ __forceinline__ void load_tap(const float* src, size_t pix,
                                         float* c) {
  const float* p = src + pix * 3;
  c[0] = __ldg(p);
  c[1] = __ldg(p + 1);
  c[2] = __ldg(p + 2);
}

// Full-resolution chroma at (x, y) from one (ch, cw) plane: libjpeg's
// triangle filter along W, then along H (ops/color._fancy_up2), edges
// replicated. Even x takes its left neighbour, odd x its right one (the
// same for y). Every value is a multiple of 1/16 below 256, so each step
// is exact; it is still rounded in the plain version's order.
__device__ __forceinline__ float fancy_chroma(const uint8_t* p, int cw,
                                              int ch, int x, int y) {
  const int cx = x >> 1;
  const int cy = y >> 1;
  const int nx = (x & 1) ? min(cx + 1, cw - 1) : max(cx - 1, 0);
  const int ny = (y & 1) ? min(cy + 1, ch - 1) : max(cy - 1, 0);
  const uint8_t* r0 = p + (size_t)cy * cw;
  const uint8_t* r1 = p + (size_t)ny * cw;
  const float a = __fadd_rn(__fmul_rn(0.75f, (float)__ldg(r0 + cx)),
                            __fmul_rn(0.25f, (float)__ldg(r0 + nx)));
  const float b = __fadd_rn(__fmul_rn(0.75f, (float)__ldg(r1 + cx)),
                            __fmul_rn(0.25f, (float)__ldg(r1 + nx)));
  return __fadd_rn(__fmul_rn(0.75f, a), __fmul_rn(0.25f, b));
}

// The in-range tap (x, y) of an h x w frame as three floats (B, G, R).
__device__ __forceinline__ void tap(const uint8_t* src, int h, int w, int x,
                                    int y, float* c) {
  load_tap(src, (size_t)y * w + x, c);
}

__device__ __forceinline__ void tap(const float* src, int h, int w, int x,
                                    int y, float* c) {
  load_tap(src, (size_t)y * w + x, c);
}

// A packed I420 tap, converted as ops/color.yuv420_to_bgr converts it:
// r = Y + 1.402 V, g = (Y - 0.344136286 U) - 0.714136286 V,
// b = Y + 1.772 U (U, V minus 128), each clipped to [0, 255].
__device__ __forceinline__ void tap(const I420* src, int h, int w, int x,
                                    int y, float* c) {
  const uint8_t* yp = reinterpret_cast<const uint8_t*>(src);
  const int cw = w >> 1;
  const int ch = h >> 1;
  const uint8_t* up = yp + (size_t)h * w;
  const uint8_t* vp = up + (size_t)ch * cw;
  const float yy = (float)__ldg(yp + (size_t)y * w + x);
  const float u = __fsub_rn(fancy_chroma(up, cw, ch, x, y), 128.f);
  const float v = __fsub_rn(fancy_chroma(vp, cw, ch, x, y), 128.f);
  const float r = __fadd_rn(yy, __fmul_rn(1.402f, v));
  const float g = __fsub_rn(__fsub_rn(yy, __fmul_rn(0.344136286f, u)),
                            __fmul_rn(0.714136286f, v));
  const float b = __fadd_rn(yy, __fmul_rn(1.772f, u));
  c[0] = fminf(fmaxf(b, 0.f), 255.f);
  c[1] = fminf(fmaxf(g, 0.f), 255.f);
  c[2] = fminf(fmaxf(r, 0.f), 255.f);
}

// The content indicator of a tap: 1 where its gray is above 2, else 0 (an
// out-of-range tap reads 0 and so is 0 too).
__device__ __forceinline__ float nonblack(const float* c) {
  const float gray = __fadd_rn(__fadd_rn(__fmul_rn(c[0], 0.114f),
                                         __fmul_rn(c[1], 0.587f)),
                               __fmul_rn(c[2], 0.299f));
  return gray > 2.0f ? 1.f : 0.f;
}

// One output pixel (x, y): BGR into v[0..2], the warped mask into *m (the
// footprint, or with `content` the warped gray > 2 indicator).
template <typename T>
__device__ __forceinline__ void warp_pixel(const T* __restrict__ src,
                                           int h, int w, const Coeffs& k,
                                           bool content, int x, int y,
                                           float* v, float* m) {
  const float xf = (float)x;
  const float yf = (float)y;
  const float sx = __fadd_rn(__fadd_rn(__fmul_rn(k.i00, xf),
                                       __fmul_rn(k.i01, yf)), k.i02);
  const float sy = __fadd_rn(__fadd_rn(__fmul_rn(k.i10, xf),
                                       __fmul_rn(k.i11, yf)), k.i12);
  const float x0 = floorf(sx);
  const float y0 = floorf(sy);
  const float fx = __fsub_rn(sx, x0);
  const float fy = __fsub_rn(sy, y0);
  // saturating conversion; out-of-range taps fail the bounds tests below
  const int xi = (int)fmaxf(fminf(x0, 2.0e9f), -2.0e9f);
  const int yi = (int)fmaxf(fminf(y0, 2.0e9f), -2.0e9f);
  const bool cx0 = (xi >= 0) & (xi < w);
  const bool cx1 = (xi >= -1) & (xi < w - 1);
  const bool ry0 = (yi >= 0) & (yi < h);
  const bool ry1 = (yi >= -1) & (yi < h - 1);
  float t00[3] = {0.f, 0.f, 0.f}, t01[3] = {0.f, 0.f, 0.f};
  float t10[3] = {0.f, 0.f, 0.f}, t11[3] = {0.f, 0.f, 0.f};
  if (ry0 & cx0) tap(src, h, w, xi, yi, t00);
  if (ry0 & cx1) tap(src, h, w, xi + 1, yi, t01);
  if (ry1 & cx0) tap(src, h, w, xi, yi + 1, t10);
  if (ry1 & cx1) tap(src, h, w, xi + 1, yi + 1, t11);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    v[c] = lerp2(t00[c], t01[c], t10[c], t11[c], fx, fy);
  if (content)
    *m = lerp2(nonblack(t00), nonblack(t01), nonblack(t10), nonblack(t11),
               fx, fy);
  else
    *m = lerp2((ry0 & cx0) ? 1.f : 0.f, (ry0 & cx1) ? 1.f : 0.f,
               (ry1 & cx0) ? 1.f : 0.f, (ry1 & cx1) ? 1.f : 0.f, fx, fy);
}

// grid.x: blocks of kThreads * kPix output pixels; grid.y: frames. Frame n
// reads src + n * src_stride elements (h x w the frame's logical size) and its coefficients from
// table[6n..] (or `one` when table is null), and writes out/mask at
// n * out_h * out_w.
template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_affine_kernel(const T* __restrict__ src, size_t src_stride, int h,
                   int w, const float* __restrict__ table, Coeffs one,
                   int content, float* __restrict__ out,
                   float* __restrict__ mask, int out_h, int out_w) {
  const size_t total = (size_t)out_h * out_w;
  const size_t p0 = ((size_t)blockIdx.x * kThreads + threadIdx.x) * kPix;
  if (p0 >= total) return;
  const int n = blockIdx.y;
  Coeffs k = one;
  if (table != nullptr) {
    const float* t = table + 6 * n;
    k = Coeffs{t[0], t[1], t[2], t[3], t[4], t[5]};
  }
  const T* frame = src + (size_t)n * src_stride;
  float* fout = out + (size_t)n * total * 3 + p0 * 3;
  float* fmask = mask + (size_t)n * total + p0;

  float v[kPix][3];
  float m[kPix];
  int x = (int)(p0 % out_w);
  int y = (int)(p0 / out_w);
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    if (p0 + j < total) {
      warp_pixel(frame, h, w, k, content != 0, x, y, v[j], &m[j]);
    } else {
      v[j][0] = v[j][1] = v[j][2] = m[j] = 0.f;
    }
    if (++x == out_w) {           // the next pixel starts a new row
      x = 0;
      ++y;
    }
  }
  // A frame's planes start 16-byte aligned only when out_h*out_w is a
  // multiple of 4; ragged frames and the tail take scalar stores.
  const bool whole = p0 + kPix <= total;
  if (whole && ((uintptr_t)fout & 15) == 0) {
    float4* o4 = reinterpret_cast<float4*>(fout);
    o4[0] = make_float4(v[0][0], v[0][1], v[0][2], v[1][0]);
    o4[1] = make_float4(v[1][1], v[1][2], v[2][0], v[2][1]);
    o4[2] = make_float4(v[2][2], v[3][0], v[3][1], v[3][2]);
  } else {
#pragma unroll
    for (int j = 0; j < kPix; ++j)
      if (p0 + j < total) {
        fout[3 * j] = v[j][0];
        fout[3 * j + 1] = v[j][1];
        fout[3 * j + 2] = v[j][2];
      }
  }
  if (whole && ((uintptr_t)fmask & 15) == 0) {
    *reinterpret_cast<float4*>(fmask) = make_float4(m[0], m[1], m[2], m[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kPix; ++j)
      if (p0 + j < total) fmask[j] = m[j];
  }
}

// n frames of h x w x 3 elements, src_stride elements apart; table: device
// (n, 6) float32 dst->src coefficients, or null for n == 1 with the
// coefficients passed by value.
template <typename T>
int launch(const T* src, long long src_stride, int h, int w,
           const float* table, Coeffs k, int content, float* out,
           float* mask, int out_h, int out_w, int n, void* stream) {
  const size_t total = (size_t)out_h * out_w;
  if (total == 0 || n <= 0) return 0;
  if (table == nullptr && n != 1) return (int)cudaErrorInvalidValue;
  const size_t threads = (total + kPix - 1) / kPix;
  const dim3 grid((unsigned)((threads + kThreads - 1) / kThreads),
                  (unsigned)n);
  warp_affine_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      src, (size_t)src_stride, h, w, table, k, content, out, mask, out_h,
      out_w);
  return (int)cudaGetLastError();
}

}  // namespace

// uint8 frames (src_stride in bytes); content: 0 for the footprint mask,
// 1 for the warped gray > 2 indicator.
extern "C" int warp_affine_u8(const uint8_t* src, long long src_stride,
                              int h, int w, const float* table, float i00,
                              float i01, float i02, float i10, float i11,
                              float i12, int content, float* out,
                              float* mask, int out_h, int out_w, int n,
                              void* stream) {
  return launch(src, src_stride, h, w, table,
                Coeffs{i00, i01, i02, i10, i11, i12}, content, out, mask,
                out_h, out_w, n, stream);
}

// float32 frames (src_stride in floats); the mask is always the footprint.
extern "C" int warp_affine_f32(const float* src, long long src_stride,
                               int h, int w, const float* table, float i00,
                               float i01, float i02, float i10, float i11,
                               float i12, float* out, float* mask,
                               int out_h, int out_w, int n, void* stream) {
  return launch(src, src_stride, h, w, table,
                Coeffs{i00, i01, i02, i10, i11, i12}, 0, out, mask, out_h,
                out_w, n, stream);
}

// packed I420 uint8 frames (h x w the logical size, h % 4 == 0, w % 2 ==
// 0; src_stride in bytes, h * w * 3 / 2 a frame); the mask is always the
// footprint.
extern "C" int warp_affine_i420(const uint8_t* src, long long src_stride,
                                int h, int w, const float* table, float i00,
                                float i01, float i02, float i10, float i11,
                                float i12, float* out, float* mask,
                                int out_h, int out_w, int n, void* stream) {
  if ((h & 3) || (w & 1)) return (int)cudaErrorInvalidValue;
  return launch(reinterpret_cast<const I420*>(src), src_stride, h, w, table,
                Coeffs{i00, i01, i02, i10, i11, i12}, 0, out, mask, out_h,
                out_w, n, stream);
}
