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
// floats, exactly the values the uint8 path has always used. An I420
// pixel is converted as ops/color.yuv420_to_bgr converts the whole frame
// (the JAX package feeds its kernel yuv420_to_bgr(frame) at
// compose_feed.py:79 and strip.py:62): chroma upsampled with libjpeg's
// triangle filter (0.75/0.25 along W, then along H, edges replicated), 128
// subtracted, the full-range JFIF matrix, each channel clipped to
// [0, 255]. Converting on the card keeps the source at 1.5 bytes a pixel:
// the float32 BGR of a 4K frame is 99.5 MB, and a 12-frame seam batch
// would hold 1.19 GB of it.
//
// What bounds it on the H100: memory traffic, almost all of it stores. Per
// output pixel it writes 16 bytes (3 channels + mask, float32) and reads
// 4 taps x 3 values of source (3 bytes each for uint8, 12 for float32, 1.5
// touched bytes a pixel for I420); a 2176x3904 window is ~136 MB written.
// So each thread produces 4 consecutive output pixels and writes them as
// three 16-byte stores of BGR (48 B) and one 16-byte store of the mask; a
// uint8 tap is read as the aligned 32-bit word(s) holding its 3 bytes, a
// float32 tap as three 4-byte loads (a 12-byte pixel has no wider aligned
// load).
//
// The I420 source has two kernels, and the wrapper's host plan
// (ops/warp_kernel.i420_plan) picks one per launch from the geometry:
//  - warp_i420_staged_kernel, where neighbouring output pixels share taps
//    (the compose feed, a near-identity warp: each source pixel is a tap of
//    ~4 output pixels). Converting per tap there costs 9 scattered byte
//    loads and ~34 operations a tap, each source pixel ~4 times over. A
//    block instead covers a kTileH x kTileW output tile, maps the tile's
//    corners through the inverse affine with warp_pixel's own rounded
//    arithmetic (monotone in x and in y, so the corners bound every
//    pixel's coordinates exactly: the box [floor(min), floor(max) + 1]
//    holds every tap, with no margin for rounding), stages the box's Y
//    rows and its chroma box's U and V rows (one chroma sample more on
//    each side for the triangle filter's clamped neighbour) with 16-byte
//    cp.async, converts every box pixel once into planar float32 B, G, R
//    in shared memory (one padding float every 32, so the lanes' taps 4
//    pixels apart fall in distinct banks), and warps from there. Its
//    shared memory is sized on the host for the launch's largest box.
//  - warp_affine_kernel<I420>, per tap, where a tile's box is too large
//    for shared memory: a downscale (the seam batch at 0.12: each touched
//    source pixel is the tap of one output pixel, so per-tap conversion
//    already converts it once, and a tile's box would be megabytes) or a
//    strong rotation.
// Both give the plain version's values bit for bit.
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
constexpr int kWarps = kThreads / 32;
// the staged I420 kernel's output tile: each warp takes whole rows (32
// lanes x kPix consecutive pixels), rows warp, warp + kWarps, ...
constexpr int kTileW = 32 * kPix;    // 128
constexpr int kTileH = 24;
static_assert(kTileH % kWarps == 0, "each warp takes the same rows");

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

// The chroma neighbour of full-resolution coordinate x in a plane of n
// samples: even x takes its left neighbour, odd x its right one, edges
// replicated.
__device__ __forceinline__ int chroma_nb(int x, int n) {
  const int c = x >> 1;
  return (x & 1) ? min(c + 1, n - 1) : max(c - 1, 0);
}

// libjpeg's triangle filter (ops/color._fancy_up2) from a pixel's own
// chroma sample c00, its column neighbour c01, its row neighbour c10 and
// the diagonal c11: along W, then along H. Every value is a multiple of
// 1/16 below 256, so each step is exact; it is still rounded in the plain
// version's order.
__device__ __forceinline__ float triangle(float c00, float c01, float c10,
                                          float c11) {
  const float a = __fadd_rn(__fmul_rn(0.75f, c00), __fmul_rn(0.25f, c01));
  const float b = __fadd_rn(__fmul_rn(0.75f, c10), __fmul_rn(0.25f, c11));
  return __fadd_rn(__fmul_rn(0.75f, a), __fmul_rn(0.25f, b));
}

// Full-resolution chroma at (x, y) from one (ch, cw) plane in device
// memory.
__device__ __forceinline__ float fancy_chroma(const uint8_t* p, int cw,
                                              int ch, int x, int y) {
  const int cx = x >> 1;
  const int nx = chroma_nb(x, cw);
  const uint8_t* r0 = p + (size_t)(y >> 1) * cw;
  const uint8_t* r1 = p + (size_t)chroma_nb(y, ch) * cw;
  return triangle((float)__ldg(r0 + cx), (float)__ldg(r0 + nx),
                  (float)__ldg(r1 + cx), (float)__ldg(r1 + nx));
}

// A pixel's B, G, R from its luma and upsampled chroma, as
// ops/color.yuv420_to_bgr converts it: r = Y + 1.402 V,
// g = (Y - 0.344136286 U) - 0.714136286 V, b = Y + 1.772 U (U, V minus
// 128), each clipped to [0, 255].
__device__ __forceinline__ void yuv_bgr(float yy, float cu, float cv,
                                        float* c) {
  const float u = __fsub_rn(cu, 128.f);
  const float v = __fsub_rn(cv, 128.f);
  const float r = __fadd_rn(yy, __fmul_rn(1.402f, v));
  const float g = __fsub_rn(__fsub_rn(yy, __fmul_rn(0.344136286f, u)),
                            __fmul_rn(0.714136286f, v));
  const float b = __fadd_rn(yy, __fmul_rn(1.772f, u));
  c[0] = fminf(fmaxf(b, 0.f), 255.f);
  c[1] = fminf(fmaxf(g, 0.f), 255.f);
  c[2] = fminf(fmaxf(r, 0.f), 255.f);
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

// A packed I420 tap, converted where it is read.
__device__ __forceinline__ void tap(const I420* src, int h, int w, int x,
                                    int y, float* c) {
  const uint8_t* yp = reinterpret_cast<const uint8_t*>(src);
  const int cw = w >> 1;
  const int ch = h >> 1;
  const uint8_t* up = yp + (size_t)h * w;
  const uint8_t* vp = up + (size_t)ch * cw;
  yuv_bgr((float)__ldg(yp + (size_t)y * w + x),
          fancy_chroma(up, cw, ch, x, y), fancy_chroma(vp, cw, ch, x, y), c);
}

// Column c of a staged row, padded one float every 32.
__device__ __forceinline__ int padded(int c) { return c + (c >> 5); }

// A staged source box (rows from y0, columns from x0): planar float32
// B, G, R in shared memory, `plane` floats apart, rows `pitch` floats
// apart.
struct Staged {
  const float* b;
  int plane, pitch, x0, y0;
};

// A tap of a staged box.
__device__ __forceinline__ void tap(const Staged* s, int h, int w, int x,
                                    int y, float* c) {
  const float* p = s->b + (y - s->y0) * s->pitch + padded(x - s->x0);
  c[0] = p[0];
  c[1] = p[s->plane];
  c[2] = p[2 * s->plane];
}

// The content indicator of a tap: 1 where its gray is above 2, else 0 (an
// out-of-range tap reads 0 and so is 0 too).
__device__ __forceinline__ float nonblack(const float* c) {
  const float gray = __fadd_rn(__fadd_rn(__fmul_rn(c[0], 0.114f),
                                         __fmul_rn(c[1], 0.587f)),
                               __fmul_rn(c[2], 0.299f));
  return gray > 2.0f ? 1.f : 0.f;
}

// Source coordinate ((a*x) + (b*y)) + c of output pixel (x, y).
__device__ __forceinline__ float src_coord(float a, float b, float c, int x,
                                           int y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, (float)x), __fmul_rn(b, (float)y)),
                   c);
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

// A thread's kPix consecutive output pixels i .. i + kPix - 1 of a run of
// output pixels that ends before `end`: BGR at fout, the mask at fmask. A
// frame's planes start 16-byte aligned only when out_h*out_w is a multiple
// of 4 (a row only when out_w is); ragged groups and the tail take scalar
// stores.
__device__ __forceinline__ void store_pixels(float* fout, float* fmask,
                                             const float (&v)[kPix][3],
                                             const float (&m)[kPix],
                                             size_t i, size_t end) {
  const bool whole = i + kPix <= end;
  if (whole && ((uintptr_t)fout & 15) == 0) {
    float4* o4 = reinterpret_cast<float4*>(fout);
    o4[0] = make_float4(v[0][0], v[0][1], v[0][2], v[1][0]);
    o4[1] = make_float4(v[1][1], v[1][2], v[2][0], v[2][1]);
    o4[2] = make_float4(v[2][2], v[3][0], v[3][1], v[3][2]);
  } else {
#pragma unroll
    for (int j = 0; j < kPix; ++j)
      if (i + j < end) {
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
      if (i + j < end) fmask[j] = m[j];
  }
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
  store_pixels(fout, fmask, v, m, p0, total);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// [*lo, *hi]: the source rows (or columns) that the taps floor(s) and
// floor(s) + 1 of the tile [x0, x1] x [y0, y1] can read, s = src_coord(a,
// b, c, x, y) as warp_pixel rounds it, clipped to [0, n - 1]. s is
// monotone in x and in y (each rounding is), so the tile's corners hold
// its extremes. False when no tap is in range (non-finite coordinates
// included: their taps fail warp_pixel's bounds tests).
__device__ __forceinline__ bool tap_span(float a, float b, float c, int x0,
                                         int y0, int x1, int y1, int n,
                                         int* lo, int* hi) {
  const float s00 = src_coord(a, b, c, x0, y0);
  const float s01 = src_coord(a, b, c, x1, y0);
  const float s10 = src_coord(a, b, c, x0, y1);
  const float s11 = src_coord(a, b, c, x1, y1);
  const float l = floorf(fminf(fminf(s00, s01), fminf(s10, s11)));
  const float u = floorf(fmaxf(fmaxf(s00, s01), fmaxf(s10, s11))) + 1.f;
  if (!(l <= (float)(n - 1) && u >= 0.f)) return false;
  *lo = (int)fmaxf(l, 0.f);
  *hi = (int)fminf(u, (float)(n - 1));
  return true;
}

// Bytes of a staged row of n bytes: whole aligned 16-byte chunks from the
// one holding its first byte.
__host__ __device__ __forceinline__ int row16(int n) {
  return 16 * ((n + 30) >> 4);
}

// The shared memory of the staged kernel for source boxes of at most
// box_h x box_w pixels (ops/warp_kernel.i420_smem_bytes computes the same
// total): planar float32 B, G, R rows of `pitch` floats, then the Y rows,
// then the U and V rows of the chroma box (at most (box >> 1) + 3 samples
// each way, and the plane).
struct StagedLayout {
  int pitch, plane, cbox_h, cbox_w, y_off, u_off, v_off, bytes;
  __host__ __device__ StagedLayout(int box_h, int box_w, int h, int w) {
    pitch = box_w + ((box_w - 1) >> 5);
    plane = box_h * pitch;
    cbox_h = (box_h >> 1) + 3 < (h >> 1) ? (box_h >> 1) + 3 : h >> 1;
    cbox_w = (box_w >> 1) + 3 < (w >> 1) ? (box_w >> 1) + 3 : w >> 1;
    y_off = 16 * ((12 * plane + 15) >> 4);
    u_off = y_off + box_h * row16(box_w);
    v_off = u_off + cbox_h * row16(cbox_w);
    bytes = v_off + cbox_h * row16(cbox_w);
  }
};

// Rows [r0, r0 + nr) x columns [c0, c0 + nc) of a plane whose rows are
// `pitch` bytes apart into shared rows row16(...) bytes apart: each row as
// the aligned 16-byte chunks from the one holding (r, c0), so (r, c0)
// lands at byte (address of (r, c0)) & 15 of its shared row. A chunk
// holding a byte of the plane never leaves the plane's pages. One warp a
// row.
__device__ __forceinline__ void stage_rows(const uint8_t* plane, int pitch,
                                           int r0, int nr, int c0, int nc,
                                           uint8_t* dst, int dpitch,
                                           int warp, int lane) {
  for (int r = warp; r < nr; r += kWarps) {
    const uintptr_t a = (uintptr_t)(plane + (size_t)(r0 + r) * pitch + c0);
    const uint8_t* s = (const uint8_t*)(a & ~(uintptr_t)15);
    const int chunks = (int)(((a & 15) + nc + 15) >> 4);
    for (int k = lane; k < chunks; k += 32)
      cp_async16(dst + r * dpitch + 16 * k, s + 16 * k);
  }
}

// The staged row holding byte (r, c0) of a plane, shifted so that index c0
// reads it.
__device__ __forceinline__ const uint8_t* staged_row(const uint8_t* sm,
                                                     int dpitch, int r,
                                                     const uint8_t* plane,
                                                     int pitch, int r0,
                                                     int c0) {
  const uintptr_t a = (uintptr_t)(plane + (size_t)(r0 + r) * pitch + c0);
  return sm + r * dpitch + (int)(a & 15) - c0;
}

// grid: (output tiles across, tiles down, frames); a block warps one
// kTileH x kTileW output tile of frame blockIdx.z from its staged source
// box (packed I420 frames src_stride bytes apart, coefficients as in
// warp_affine_kernel). box_h x box_w bounds every tile's box (the host
// plan); dynamic shared memory: StagedLayout(box_h, box_w, h, w).bytes.
// Four blocks an SM: at most 64 registers.
__global__ void __launch_bounds__(kThreads, 4)
warp_i420_staged_kernel(const uint8_t* __restrict__ src, size_t src_stride,
                        int h, int w, const float* __restrict__ table,
                        Coeffs one, float* __restrict__ out,
                        float* __restrict__ mask, int out_h, int out_w,
                        int box_h, int box_w) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int n = blockIdx.z;
  Coeffs k = one;
  if (table != nullptr) {
    const float* t = table + 6 * n;
    k = Coeffs{t[0], t[1], t[2], t[3], t[4], t[5]};
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tx0 = blockIdx.x * kTileW;
  const int ty0 = blockIdx.y * kTileH;
  const int tx1 = min(tx0 + kTileW, out_w) - 1;
  const int ty1 = min(ty0 + kTileH, out_h) - 1;
  const int cw = w >> 1;
  const int ch = h >> 1;
  const StagedLayout lay(box_h, box_w, h, w);
  float* sb = reinterpret_cast<float*>(smem);
  uint8_t* sy = smem + lay.y_off;
  uint8_t* su = smem + lay.u_off;
  uint8_t* sv = smem + lay.v_off;
  const uint8_t* yp = src + (size_t)n * src_stride;
  const uint8_t* up = yp + (size_t)h * w;
  const uint8_t* vp = up + (size_t)ch * cw;

  // the box: every in-range tap of the tile; empty when none is
  int x0 = 0, x1 = -1, y0 = 0, y1 = -1;
  if (!tap_span(k.i00, k.i01, k.i02, tx0, ty0, tx1, ty1, w, &x0, &x1) ||
      !tap_span(k.i10, k.i11, k.i12, tx0, ty0, tx1, ty1, h, &y0, &y1)) {
    x1 = x0 - 1;
    y1 = y0 - 1;
  }
  const int bw = x1 - x0 + 1;
  const int bh = y1 - y0 + 1;
  if (bh > box_h || bw > box_w) __trap();     // the host plan is wrong
  const int cx0 = max((x0 >> 1) - 1, 0);
  const int cy0 = max((y0 >> 1) - 1, 0);
  const int cbw = bw > 0 ? min((x1 >> 1) + 1, cw - 1) - cx0 + 1 : 0;
  const int cbh = bh > 0 ? min((y1 >> 1) + 1, ch - 1) - cy0 + 1 : 0;
  const int ypitch = row16(box_w);
  const int cpitch = row16(lay.cbox_w);

  // stage the Y box and the U and V chroma boxes
  stage_rows(yp, w, y0, bh, x0, bw, sy, ypitch, warp, lane);
  stage_rows(up, cw, cy0, cbh, cx0, cbw, su, cpitch, warp, lane);
  stage_rows(vp, cw, cy0, cbh, cx0, cbw, sv, cpitch, warp, lane);
  cp_async_wait_all();
  __syncthreads();

  // convert every box pixel once
  for (int r = warp; r < bh; r += kWarps) {
    const int y = y0 + r;
    const uint8_t* yrow = staged_row(sy, ypitch, r, yp, w, y0, x0);
    const int r0 = (y >> 1) - cy0;
    const int r1 = chroma_nb(y, ch) - cy0;
    const uint8_t* u0 = staged_row(su, cpitch, r0, up, cw, cy0, cx0);
    const uint8_t* u1 = staged_row(su, cpitch, r1, up, cw, cy0, cx0);
    const uint8_t* v0 = staged_row(sv, cpitch, r0, vp, cw, cy0, cx0);
    const uint8_t* v1 = staged_row(sv, cpitch, r1, vp, cw, cy0, cx0);
    float* row = sb + r * lay.pitch;
    for (int c = lane; c < bw; c += 32) {
      const int x = x0 + c;
      const int cx = x >> 1;
      const int nx = chroma_nb(x, cw);
      float bgr[3];
      yuv_bgr((float)yrow[x],
              triangle((float)u0[cx], (float)u0[nx], (float)u1[cx],
                       (float)u1[nx]),
              triangle((float)v0[cx], (float)v0[nx], (float)v1[cx],
                       (float)v1[nx]),
              bgr);
      float* p = row + padded(c);
      p[0] = bgr[0];
      p[lay.plane] = bgr[1];
      p[2 * lay.plane] = bgr[2];
    }
  }
  __syncthreads();

  // warp the tile from the staged box
  const Staged box{sb, lay.plane, lay.pitch, x0, y0};
  const int x = tx0 + lane * kPix;
  if (x > tx1) return;
  const size_t total = (size_t)out_h * out_w;
  for (int y = ty0 + warp; y <= ty1; y += kWarps) {
    const int valid = min(kPix, tx1 - x + 1);
    float v[kPix][3];
    float m[kPix];
#pragma unroll
    for (int j = 0; j < kPix; ++j)
      if (j < valid) warp_pixel(&box, h, w, k, false, x + j, y, v[j], &m[j]);
    const size_t p = (size_t)n * total + (size_t)y * out_w + x;
    store_pixels(out + p * 3, mask + p, v, m, x, tx1 + 1);
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

// The staged I420 kernel over boxes of at most box_h x box_w; smem_bytes
// as the host plan sized it (at least StagedLayout's).
int launch_staged(const uint8_t* src, long long src_stride, int h, int w,
                  const float* table, Coeffs k, float* out, float* mask,
                  int out_h, int out_w, int n, int box_h, int box_w,
                  int smem_bytes, void* stream) {
  if ((long long)out_h * out_w == 0 || n <= 0) return 0;
  if ((table == nullptr && n != 1) || box_h <= 0 || box_w <= 0 ||
      smem_bytes < StagedLayout(box_h, box_w, h, w).bytes)
    return (int)cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory only after opting in, per device
  static int opted_in[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (smem_bytes > 48 * 1024 && smem_bytes > opted_in[dev]) {
    err = cudaFuncSetAttribute(warp_i420_staged_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = smem_bytes;
  }
  const dim3 grid((unsigned)((out_w + kTileW - 1) / kTileW),
                  (unsigned)((out_h + kTileH - 1) / kTileH), (unsigned)n);
  warp_i420_staged_kernel<<<grid, kThreads, smem_bytes,
                            (cudaStream_t)stream>>>(
      src, (size_t)src_stride, h, w, table, k, out, mask, out_h, out_w,
      box_h, box_w);
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
// footprint. box_h == 0: the per-tap kernel; else the staged kernel over
// source boxes of at most box_h x box_w with smem_bytes of dynamic shared
// memory (ops/warp_kernel.i420_plan).
extern "C" int warp_affine_i420(const uint8_t* src, long long src_stride,
                                int h, int w, const float* table, float i00,
                                float i01, float i02, float i10, float i11,
                                float i12, float* out, float* mask,
                                int out_h, int out_w, int n, int box_h,
                                int box_w, int smem_bytes, void* stream) {
  if ((h & 3) || (w & 1)) return (int)cudaErrorInvalidValue;
  const Coeffs k{i00, i01, i02, i10, i11, i12};
  if (box_h == 0)
    return launch(reinterpret_cast<const I420*>(src), src_stride, h, w,
                  table, k, 0, out, mask, out_h, out_w, n, stream);
  return launch_staged(src, src_stride, h, w, table, k, out, mask, out_h,
                       out_w, n, box_h, box_w, smem_bytes, stream);
}
