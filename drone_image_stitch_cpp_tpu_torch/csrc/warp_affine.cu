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
// The uint8, float32 and per-tap I420 sources share one gather kernel
// (warp_affine_tile_kernel). A block covers a kGatherTileH x kTileW
// output tile (8 x 128: one row a warp, so no warp waits on its taps'
// loads row after row), maps its corners through the inverse affine with
// the pixels' own rounded arithmetic (monotone in x and in y, so the
// corners bound every pixel's coordinates exactly: the box [floor(min),
// floor(max) + 1] holds every tap, with no margin for rounding) and takes
// one of two routes:
//  - zero, when no tap of the tile is in the frame: it writes the tile's
//    zeros as whole 16-byte stores across the warp and does no per-pixel
//    work. At a seam-scale downscale a frame covers a sixth of its window,
//    so most tiles of a seam batch are zero, and their stores are all the
//    bound counts for them;
//  - direct, per-tap loads from device memory.
// A box inside the frame drops the per-tap bounds tests. An I420 pixel's
// four taps share the 3 x 3 chroma samples around their quad
// (sample_i420): 22 byte loads where per-tap conversion takes 36.
// One frame's uint8 or float32 warp may pass its src->dst affine: the
// entry inverts it on the host (affine_inverse_f32_host's code) and
// launches nothing when the inverse is not finite, so the wrapper runs no
// Python inverse and applies its singular test before any launch.
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
//  - the gather kernel, per tap, where a tile's box is too large for
//    shared memory: a downscale (the seam batch at 0.12: each touched
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
// A batch's coefficients reach the kernel by value, as a parameter block
// of kByValue sets of six floats (3,840 B, inside the 4 KB of kernel
// parameters of every toolkit), so a launch needs no host-to-device copy;
// one frame passes a block of one set (24 B); above kByValue frames they
// come from a device table. The host computes those sets with
// the single-plane kernel's own inverse (affine_inverse_f32_host, below),
// one call for a whole batch.
//
// One more form reads a single float32 plane and writes it with no mask
// (warp_affine_plane_f32: the JAX package's warp_affine_traced,
// pallas_warp.py:323, which bench.py:111 runs on 7 full-4K gray frames of
// each batch, and its batched warp_affine_many, :287). It takes the
// src->dst affines themselves, from the device (RANSAC's models as they
// lie on the card, read through their strides) or by value, and each
// block inverts its frame's affine (csrc/affine_inverse.cuh, the float32
// LU of ops/warp_kernel.inverse_coeffs in its rounding), so a call is one
// launch and no host work. It writes 4 B and reads about 4 B of touched
// source a pixel, so it is bound by memory traffic: 459 MB for the
// 7-frame 4K batch. A block covers a kPlaneTileH x kTileW output tile
// (256 threads, each 4 consecutive pixels of 4 rows). It maps the tile's
// corners with warp_pixel's own rounded arithmetic to the source box that
// holds every tap (as the staged I420 kernel does) and, when the box
// clipped to the frame fits the block's fixed kPlaneSmemFloats of shared
// memory, stages its rows with 16-byte cp.async (L2 only) and gathers the
// four taps of each pixel from shared memory: each source pixel comes
// from device memory once, where the per-tap loads of a 4-pixel thread
// spread every warp load over four cache lines. A box that does not fit
// (a strong downscale or rotation), or a tile with no tap in the frame,
// takes the direct gather (__ldg per tap); the choice is the block's own
// and uniform across it. Both routes share the per-pixel code, which is
// issue-bound as much as memory-bound (a 4K pixel moves 8 B for some 30
// operations), so it is lean: a thread computes a x for its 4 pixels and
// a row's b y once (the same rounded products src_coord takes), and a
// tile whose box lies inside the frame, most of them, drops the bounds
// tests and saturating conversions. Lanes 8g..8g+7 take their 4 pixels
// starting at pixel g, so a warp's shared-memory taps of a near-identity
// warp fall in 32 distinct banks. Each thread writes its 4 pixels as one
// 16-byte streaming store (__stcs): the output is read once, by what
// follows, and should not evict the source from L2. Both gathers give the
// plain version's values bit for bit: the same coordinates, bounds tests
// and lerp2.
//
// Plain C interface for ctypes; each entry returns the cudaGetLastError()
// code.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <cmath>
#include <type_traits>

#include "affine_inverse.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 4;              // output pixels per thread
constexpr int kWarps = kThreads / 32;
// the staged I420 kernel's output tile: each warp takes whole rows (32
// lanes x kPix consecutive pixels), rows warp, warp + kWarps, ...
constexpr int kTileW = 32 * kPix;    // 128
constexpr int kTileH = 24;
static_assert(kTileH % kWarps == 0, "each warp takes the same rows");
// the gather kernel's output tile: kGatherTileH rows of kTileW
constexpr int kGatherTileH = 8;

// the single-plane kernel's output tile: kPlaneTileH rows of kTileW, and
// the shared memory that bounds its staged source box: 30 KB, so seven
// blocks fit an SM (a near-identity tile's box takes ~18 KB; a rotation
// up to ~9 degrees still fits)
constexpr int kPlaneTileH = 32;
constexpr int kPlaneSmemFloats = 7680;
static_assert(kPlaneTileH % kWarps == 0, "each warp takes the same rows");
// coefficient sets a launch takes by value, at most (3,840 B of
// parameters; one frame passes a block of one: with_sets)
constexpr int kByValue = 160;

struct Coeffs {
  float i00, i01, i02, i10, i11, i12;
};

// S sets of six floats passed by value: dst->src coefficients (the BGR
// and I420 kernels) or src->dst affines (the single-plane kernel), set n
// for frame n.
template <int S>
struct HostSets {
  static constexpr int kSets = S;
  float v[S][6];
};

// Frame n's coefficients: row n of the device table, else set n of the
// by-value block.
template <int S>
__device__ __forceinline__ Coeffs coeffs_of(const float* __restrict__ table,
                                            const HostSets<S>& host, int n) {
  if (table != nullptr) {
    const float* t = table + 6 * n;
    return Coeffs{t[0], t[1], t[2], t[3], t[4], t[5]};
  }
  const float* t = host.v[n];
  return Coeffs{t[0], t[1], t[2], t[3], t[4], t[5]};
}

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

// The bilinear taps of output pixel (x, y) in an h x w source: the top-left
// tap (xi, yi), the weights fx and fy, and which of the four taps lie in
// the source (the others read the constant-0 border).
struct Bilinear {
  int xi, yi;
  float fx, fy;
  bool in00, in01, in10, in11;
};

__device__ __forceinline__ Bilinear bilinear_of(float sx, float sy, int h,
                                                int w) {
  const float x0 = floorf(sx);
  const float y0 = floorf(sy);
  Bilinear b;
  b.fx = __fsub_rn(sx, x0);
  b.fy = __fsub_rn(sy, y0);
  // saturating conversion; out-of-range taps fail the bounds tests below
  b.xi = (int)fmaxf(fminf(x0, 2.0e9f), -2.0e9f);
  b.yi = (int)fmaxf(fminf(y0, 2.0e9f), -2.0e9f);
  const bool cx0 = (b.xi >= 0) & (b.xi < w);
  const bool cx1 = (b.xi >= -1) & (b.xi < w - 1);
  const bool ry0 = (b.yi >= 0) & (b.yi < h);
  const bool ry1 = (b.yi >= -1) & (b.yi < h - 1);
  b.in00 = ry0 & cx0;
  b.in01 = ry0 & cx1;
  b.in10 = ry1 & cx0;
  b.in11 = ry1 & cx1;
  return b;
}

// bilinear_of for a sample whose four taps the caller knows lie in the
// frame: the same floor and weights, no bounds tests, no saturation.
__device__ __forceinline__ Bilinear bilinear_inside(float sx, float sy) {
  const float x0 = floorf(sx);
  const float y0 = floorf(sy);
  Bilinear b;
  b.fx = __fsub_rn(sx, x0);
  b.fy = __fsub_rn(sy, y0);
  b.xi = (int)x0;
  b.yi = (int)y0;
  b.in00 = b.in01 = b.in10 = b.in11 = true;
  return b;
}

template <bool kInterior>
__device__ __forceinline__ Bilinear bilinear_sample_at(float sx, float sy,
                                                       int h, int w) {
  if constexpr (kInterior) return bilinear_inside(sx, sy);
  return bilinear_of(sx, sy, h, w);
}

// The BGR sample at source (sx, sy) of a frame read through tap(src, ...):
// BGR into v[0..2], the warped mask into *m (the footprint, or with
// `content` the warped gray > 2 indicator). kInterior: every tap lies in
// the frame (bilinear_inside).
template <bool kInterior, typename T>
__device__ __forceinline__ void sample_bgr(const T* __restrict__ src, int h,
                                           int w, bool content, float sx,
                                           float sy, float* v, float* m) {
  const Bilinear b = bilinear_sample_at<kInterior>(sx, sy, h, w);
  float t00[3] = {0.f, 0.f, 0.f}, t01[3] = {0.f, 0.f, 0.f};
  float t10[3] = {0.f, 0.f, 0.f}, t11[3] = {0.f, 0.f, 0.f};
  if (b.in00) tap(src, h, w, b.xi, b.yi, t00);
  if (b.in01) tap(src, h, w, b.xi + 1, b.yi, t01);
  if (b.in10) tap(src, h, w, b.xi, b.yi + 1, t10);
  if (b.in11) tap(src, h, w, b.xi + 1, b.yi + 1, t11);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    v[c] = lerp2(t00[c], t01[c], t10[c], t11[c], b.fx, b.fy);
  if (content)
    *m = lerp2(nonblack(t00), nonblack(t01), nonblack(t10), nonblack(t11),
               b.fx, b.fy);
  else
    *m = lerp2(b.in00 ? 1.f : 0.f, b.in01 ? 1.f : 0.f, b.in10 ? 1.f : 0.f,
               b.in11 ? 1.f : 0.f, b.fx, b.fy);
}

// One output pixel (x, y) of the staged I420 kernel's box.
template <typename T>
__device__ __forceinline__ void warp_pixel(const T* __restrict__ src,
                                           int h, int w, const Coeffs& k,
                                           bool content, int x, int y,
                                           float* v, float* m) {
  sample_bgr<false>(src, h, w, content, src_coord(k.i00, k.i01, k.i02, x, y),
                    src_coord(k.i10, k.i11, k.i12, x, y), v, m);
}

// One step of libjpeg's triangle filter: 0.75 own + 0.25 neighbour
// (triangle's a and b along W, then its result along H).
__device__ __forceinline__ float tri_step(float own, float nb) {
  return __fadd_rn(__fmul_rn(0.75f, own), __fmul_rn(0.25f, nb));
}

// The I420 sample at source (sx, sy): the four taps' B, G, R as
// ops/color.yuv420_to_bgr converts them, blended as sample_bgr blends
// them, with the footprint mask. The four taps' chroma comes from at most
// 3 x 3 samples of each chroma plane around the quad: tap column x takes
// chroma column x >> 1 and its neighbour chroma_nb(x), and for the two
// columns xi, xi + 1 these lie in {m - 1, m, m + 1}, m = (xi + 1) >> 1
// (edges replicated); rows likewise. So the quad loads 4 Y + 9 U + 9 V
// bytes, where per-tap conversion loads 4 x (1 + 4 + 4), and each tap
// still runs triangle's three steps and yuv_bgr on its own four samples
// in the plain version's order (a step shared by two taps is computed
// once: the same operation on the same values), so every value is
// bit-equal to the per-tap conversion's. Taps out of the frame read 0 and
// their chroma, read from clamped indices, is unused.
template <bool kInterior>
__device__ __forceinline__ void sample_i420(const uint8_t* __restrict__ yp,
                                            int h, int w, float sx,
                                            float sy, float* v, float* m) {
  const Bilinear b = bilinear_sample_at<kInterior>(sx, sy, h, w);
  float t[4][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f},
                   {0.f, 0.f, 0.f}};            // t00, t01, t10, t11
  if (b.in00 | b.in01 | b.in10 | b.in11) {      // xi, yi >= -1 then
    const int cw = w >> 1;
    const int ch = h >> 1;
    const uint8_t* up = yp + (size_t)h * w;
    const uint8_t* vp = up + (size_t)ch * cw;
    const int mx = (b.xi + 1) >> 1;
    const int my = (b.yi + 1) >> 1;
    const int cx[3] = {max(mx - 1, 0), min(mx, cw - 1), min(mx + 1, cw - 1)};
    const int cy[3] = {max(my - 1, 0), min(my, ch - 1), min(my + 1, ch - 1)};
    // column indices (into cx) of own and neighbour chroma for the taps
    // at xi and xi + 1: even xi (1, 0) and (1, 2); odd xi (0, 1), (1, 0)
    const bool ex = (b.xi & 1) == 0;
    const bool ey = (b.yi & 1) == 0;
    float hu[3][2], hv[3][2];                   // [chroma row][x tap]
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const uint8_t* ur = up + (size_t)cy[r] * cw;
      const uint8_t* vr = vp + (size_t)cy[r] * cw;
      float u[3], vv[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        u[c] = (float)__ldg(ur + cx[c]);
        vv[c] = (float)__ldg(vr + cx[c]);
      }
      hu[r][0] = tri_step(ex ? u[1] : u[0], ex ? u[0] : u[1]);
      hu[r][1] = tri_step(u[1], ex ? u[2] : u[0]);
      hv[r][0] = tri_step(ex ? vv[1] : vv[0], ex ? vv[0] : vv[1]);
      hv[r][1] = tri_step(vv[1], ex ? vv[2] : vv[0]);
    }
    const bool in[4] = {b.in00, b.in01, b.in10, b.in11};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int kx = q & 1;                      // x tap: xi + kx
      const int jy = q >> 1;                     // y tap: yi + jy
      if (!in[q]) continue;
      // own and neighbour chroma rows (into cy) of the y tap
      const float uo = jy ? hu[1][kx] : (ey ? hu[1][kx] : hu[0][kx]);
      const float un = jy ? (ey ? hu[2][kx] : hu[0][kx])
                          : (ey ? hu[0][kx] : hu[1][kx]);
      const float vo = jy ? hv[1][kx] : (ey ? hv[1][kx] : hv[0][kx]);
      const float vn = jy ? (ey ? hv[2][kx] : hv[0][kx])
                          : (ey ? hv[0][kx] : hv[1][kx]);
      yuv_bgr((float)__ldg(yp + (size_t)(b.yi + jy) * w + (b.xi + kx)),
              tri_step(uo, un), tri_step(vo, vn), t[q]);
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c)
    v[c] = lerp2(t[0][c], t[1][c], t[2][c], t[3][c], b.fx, b.fy);
  *m = lerp2(b.in00 ? 1.f : 0.f, b.in01 ? 1.f : 0.f, b.in10 ? 1.f : 0.f,
             b.in11 ? 1.f : 0.f, b.fx, b.fy);
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
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
// warp_affine_tile_kernel). box_h x box_w bounds every tile's box (the host
// plan); dynamic shared memory: StagedLayout(box_h, box_w, h, w).bytes.
// Four blocks an SM: at most 64 registers.
template <int S>
__global__ void __launch_bounds__(kThreads, 4)
warp_i420_staged_kernel(const uint8_t* __restrict__ src, size_t src_stride,
                        int h, int w, const float* __restrict__ table,
                        const __grid_constant__ HostSets<S> host,
                        float* __restrict__ out, float* __restrict__ mask,
                        int out_h, int out_w, int box_h, int box_w) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int n = blockIdx.z;
  const Coeffs k = coeffs_of(table, host, n);
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

// A source plane's box staged in shared memory by stage_plane: source
// (y, x) at s[y * pitch + x + base].
struct PlaneBox {
  const float* s;
  int pitch, base;
};

// The taps (y, x), (y, x + 1), (y + 1, x), (y + 1, x + 1) of a float32
// plane of width w, in device memory or in its staged box; `in` says which
// lie in the frame (the others are 0 and are not read). Indices are
// unsigned, so an out-of-range tap's, never used, cannot overflow.
__device__ __forceinline__ void taps(const float* __restrict__ frame, int w,
                                     int x, int y, const bool (&in)[4],
                                     float (&t)[4]) {
  const float* p = frame + ((long long)y * w + x);
  t[0] = in[0] ? __ldg(p) : 0.f;
  t[1] = in[1] ? __ldg(p + 1) : 0.f;
  t[2] = in[2] ? __ldg(p + w) : 0.f;
  t[3] = in[3] ? __ldg(p + w + 1) : 0.f;
}

__device__ __forceinline__ void taps(const PlaneBox& b, int w, int x, int y,
                                     const bool (&in)[4], float (&t)[4]) {
  const unsigned i = (unsigned)y * (unsigned)b.pitch + (unsigned)x +
                     (unsigned)b.base;
  t[0] = in[0] ? b.s[i] : 0.f;
  t[1] = in[1] ? b.s[i + 1] : 0.f;
  t[2] = in[2] ? b.s[i + b.pitch] : 0.f;
  t[3] = in[3] ? b.s[i + b.pitch + 1] : 0.f;
}

// The plane's bilinear sample at source (sx, sy): bilinear_of's taps,
// bounds tests and rounding, then lerp2. kInterior: the caller knows every
// tap lies in the frame, so the bounds tests and the saturating
// conversions are left out (they would all pass).
template <bool kInterior, typename S>
__device__ __forceinline__ float plane_sample(const S& src, int h, int w,
                                              float sx, float sy) {
  float t[4];
  if constexpr (kInterior) {
    const float x0 = floorf(sx);
    const float y0 = floorf(sy);
    const bool all[4] = {true, true, true, true};
    taps(src, w, (int)x0, (int)y0, all, t);
    return lerp2(t[0], t[1], t[2], t[3], __fsub_rn(sx, x0),
                 __fsub_rn(sy, y0));
  }
  const Bilinear b = bilinear_of(sx, sy, h, w);
  const bool in[4] = {b.in00, b.in01, b.in10, b.in11};
  taps(src, w, b.xi, b.yi, in, t);
  return lerp2(t[0], t[1], t[2], t[3], b.fx, b.fy);
}

// Rows [y0, y0 + bh) x columns [x0, x0 + bw) of a plane of width w into
// shared rows `pitch` floats apart, spread over the block's threads: with
// w % 4 == 0 as the pitch / 4 16-byte cp.async chunks (L2 only) from the
// aligned one that holds (y, x0), `lead` floats before it (the same in
// every row); else float by float (4-byte cp.async), lead 0. A chunk
// holding a float of the frame never leaves the frame's pages; the floats
// of a chunk outside the box are never read.
__device__ __forceinline__ void stage_plane(const float* frame, int w,
                                            int x0, int y0, int bw, int bh,
                                            int lead, float* sm, int pitch) {
  const bool wide = (w & 3) == 0;
  const int per_row = wide ? pitch >> 2 : bw;     // copies a row
  const int dr = kThreads / per_row;              // a stride of kThreads
  const int dc = kThreads - dr * per_row;         // copies, in (rows, cols)
  int r = threadIdx.x / per_row;
  int c = threadIdx.x - r * per_row;
  for (int i = threadIdx.x; i < bh * per_row; i += kThreads) {
    const float* row = frame + (size_t)(y0 + r) * w + x0;
    if (wide)
      cp_async16(sm + r * pitch + 4 * c, row - lead + 4 * c);
    else
      cp_async4(sm + r * pitch + c, row + c);
    r += dr;
    c += dc;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
}

// The tile [tx0, tx1] x [ty0, ty1] of an output plane of width out_w from
// `src` (the frame in device memory, or its staged box): warp r takes rows
// ty0 + r, ty0 + r + kWarps, ..., each lane 4 consecutive pixels from x =
// tx0 + 4 lane, written as one 16-byte streaming store where whole and
// aligned. Lane group rot = lane / 8 computes its 4 pixels starting at
// pixel rot, so at each step a warp's taps of a near-identity warp lie 4
// columns apart plus rot: 32 distinct shared-memory banks. A pixel's
// source coordinate is ((a x) + (b y)) + c, src_coord's rounding, with
// the thread's a x (4 pixels) and a row's b y computed once.
template <bool kInterior, typename S>
__device__ __forceinline__ void plane_tile(const S& src, int h, int w,
                                           const Coeffs& k,
                                           float* __restrict__ out,
                                           int out_w, int tx0, int ty0,
                                           int tx1, int ty1) {
  static_assert(kPix == 4, "the rotation below selects among 4 pixels");
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int x = tx0 + lane * kPix;
  if (x > tx1) return;
  const int rot = lane >> 3;
  int px[kPix];                      // step j computes pixel px[j]
  float ax[kPix], cx[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) {
    px[j] = x + ((j + rot) & (kPix - 1));
    ax[j] = __fmul_rn(k.i00, (float)px[j]);
    cx[j] = __fmul_rn(k.i10, (float)px[j]);
  }
  for (int y = ty0 + warp; y <= ty1; y += kWarps) {
    const float by = __fmul_rn(k.i01, (float)y);
    const float dy = __fmul_rn(k.i11, (float)y);
    float got[kPix];
#pragma unroll
    for (int j = 0; j < kPix; ++j)
      got[j] = px[j] <= tx1
                   ? plane_sample<kInterior>(
                         src, h, w, __fadd_rn(__fadd_rn(ax[j], by), k.i02),
                         __fadd_rn(__fadd_rn(cx[j], dy), k.i12))
                   : 0.f;
    float v[kPix];                   // v[i] is pixel x + i
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      const int j = (i - rot) & (kPix - 1);
      v[i] = j == 0 ? got[0] : j == 1 ? got[1] : j == 2 ? got[2] : got[3];
    }
    float* o = out + (size_t)y * out_w + x;
    if (x + kPix - 1 <= tx1 && ((uintptr_t)o & 15) == 0) {
      __stcs(reinterpret_cast<float4*>(o),
             make_float4(v[0], v[1], v[2], v[3]));
    } else {
#pragma unroll
      for (int j = 0; j < kPix; ++j)
        if (x + j <= tx1) __stcs(o + j, v[j]);
    }
  }
}

// plane_tile<interior>
template <typename S>
__device__ __forceinline__ void plane_tile_of(bool interior, const S& src,
                                              int h, int w, const Coeffs& k,
                                              float* __restrict__ out,
                                              int out_w, int tx0, int ty0,
                                              int tx1, int ty1) {
  if (interior)
    plane_tile<true>(src, h, w, k, out, out_w, tx0, ty0, tx1, ty1);
  else
    plane_tile<false>(src, h, w, k, out, out_w, tx0, ty0, tx1, ty1);
}

// [*lo, *hi] = [floor(min s), floor(max s) + 1] over the tile [x0, x1] x
// [y0, y1], s = src_coord(a, b, c, x, y): the source rows (or columns)
// that its taps read, unclipped (tap_span's span before the clip); and
// whether all four corners' s are finite (then so is every pixel's: the
// rounded s is monotone in x and y, so the corners bound it).
__device__ __forceinline__ bool tile_span(float a, float b, float c, int x0,
                                          int y0, int x1, int y1, float* lo,
                                          float* hi) {
  const float s00 = src_coord(a, b, c, x0, y0);
  const float s01 = src_coord(a, b, c, x1, y0);
  const float s10 = src_coord(a, b, c, x0, y1);
  const float s11 = src_coord(a, b, c, x1, y1);
  *lo = floorf(fminf(fminf(s00, s01), fminf(s10, s11)));
  *hi = floorf(fmaxf(fmaxf(s00, s01), fmaxf(s10, s11))) + 1.f;
  return isfinite(s00) && isfinite(s01) && isfinite(s10) && isfinite(s11);
}

// grid: (output tiles across, tiles down, frames); a block warps one
// kPlaneTileH x kTileW output tile of plane blockIdx.z (src + n *
// src_stride, h x w) into out + n * out_h * out_w. Frame n's src->dst
// affine is element (n, i, j) = a23s[n * sn + i * sr + j * sc] of a
// device array, or set n of `host` when a23s is null; every thread
// inverts it (affine_inverse::invert). The tile's taps span a source box
// (tile_span, monotone: its corners bound it). The box clipped to the
// frame is staged when it fits kPlaneSmemFloats and `direct` is 0, else
// the tile gathers from device memory; a box inside the frame (every tap
// in range) drops the bounds tests. staged_tiles, when not null, counts
// the staged tiles.
template <int S>
__global__ void __launch_bounds__(kThreads)
warp_plane_kernel(const float* __restrict__ src, size_t src_stride, int h,
                  int w, const float* __restrict__ a23s, long long sn,
                  long long sr, long long sc,
                  const __grid_constant__ HostSets<S> host,
                  float* __restrict__ out, int out_h, int out_w, int direct,
                  int* __restrict__ staged_tiles) {
  __shared__ __align__(16) float sm[kPlaneSmemFloats];
  const int n = blockIdx.z;
  float m[6], inv[6];
  if (a23s != nullptr) {
    const float* a = a23s + n * sn;
#pragma unroll
    for (int i = 0; i < 6; ++i) m[i] = __ldg(a + (i / 3) * sr + (i % 3) * sc);
  } else {
#pragma unroll
    for (int i = 0; i < 6; ++i) m[i] = host.v[n][i];
  }
  affine_inverse::invert(m, inv);
  const Coeffs k{inv[0], inv[1], inv[2], inv[3], inv[4], inv[5]};
  const int tx0 = blockIdx.x * kTileW;
  const int ty0 = blockIdx.y * kPlaneTileH;
  const int tx1 = min(tx0 + kTileW, out_w) - 1;
  const int ty1 = min(ty0 + kPlaneTileH, out_h) - 1;
  const float* frame = src + (size_t)n * src_stride;
  float* fout = out + (size_t)n * out_h * out_w;

  float lx, ux, ly, uy;
  tile_span(k.i00, k.i01, k.i02, tx0, ty0, tx1, ty1, &lx, &ux);
  tile_span(k.i10, k.i11, k.i12, tx0, ty0, tx1, ty1, &ly, &uy);
  // false for coordinates that are not finite
  const bool interior = lx >= 0.f && ux <= (float)(w - 1) && ly >= 0.f &&
                        uy <= (float)(h - 1);
  const bool any = lx <= (float)(w - 1) && ux >= 0.f &&
                   ly <= (float)(h - 1) && uy >= 0.f;
  int x0 = 0, y0 = 0, bw = 0, bh = 0, pitch = 0, lead = 0;
  bool staged = direct == 0 && any;
  if (staged) {                      // the box clipped to the frame
    x0 = (int)fmaxf(lx, 0.f);
    y0 = (int)fmaxf(ly, 0.f);
    bw = (int)fminf(ux, (float)(w - 1)) - x0 + 1;
    bh = (int)fminf(uy, (float)(h - 1)) - y0 + 1;
    if ((w & 3) == 0) {
      lead = (int)(((uintptr_t)(frame + x0) >> 2) & 3);
      pitch = 4 * ((lead + bw + 3) >> 2);
    } else {
      pitch = bw;
    }
    staged = (long long)bh * pitch <= kPlaneSmemFloats;
  }
  if (!staged) {
    plane_tile_of(interior, frame, h, w, k, fout, out_w, tx0, ty0, tx1,
                  ty1);
    return;
  }
  stage_plane(frame, w, x0, y0, bw, bh, lead, sm, pitch);
  cp_async_wait_all();
  __syncthreads();
  if (staged_tiles != nullptr && threadIdx.x == 0) atomicAdd(staged_tiles, 1);
  const PlaneBox box{sm, pitch, lead - y0 * pitch - x0};
  plane_tile_of(interior, box, h, w, k, fout, out_w, tx0, ty0, tx1, ty1);
}

// The gather kernel's routes, in the order of its optional tile counter.
enum Route { kZeroTile = 0, kDirectTile = 1 };

// The zero tile [tx0, tx1] x [ty0, ty1]: BGR and mask rows of zeros, as
// the warp of taps that all read the constant-0 border gives them; whole
// 16-byte stores across each warp's lanes where a row is aligned, warp r
// taking rows ty0 + r, ty0 + r + kWarps, ...
__device__ __forceinline__ void zero_tile(float* __restrict__ out,
                                          float* __restrict__ mask,
                                          size_t frame_px, int out_w,
                                          int tx0, int ty0, int tx1,
                                          int ty1) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nx = tx1 - tx0 + 1;
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int y = ty0 + warp; y <= ty1; y += kWarps) {
    const size_t p = frame_px + (size_t)y * out_w + tx0;
    float* o = out + 3 * p;
    float* mk = mask + p;
    if ((((uintptr_t)o & 15) | ((3 * nx) & 3)) == 0) {
      for (int i = lane; i < (3 * nx) >> 2; i += 32)
        reinterpret_cast<float4*>(o)[i] = z;
    } else {
      for (int i = lane; i < 3 * nx; i += 32) o[i] = 0.f;
    }
    if ((((uintptr_t)mk & 15) | (nx & 3)) == 0) {
      for (int i = lane; i < nx >> 2; i += 32)
        reinterpret_cast<float4*>(mk)[i] = z;
    } else {
      for (int i = lane; i < nx; i += 32) mk[i] = 0.f;
    }
  }
}

// The sample of a gather source at (sx, sy): BGR uint8 or float32 frames
// through sample_bgr, packed I420 frames through sample_i420 (footprint
// mask only).
template <bool kInterior, typename T>
__device__ __forceinline__ void sample_any(const T* src, int h, int w,
                                           bool content, float sx, float sy,
                                           float* v, float* m) {
  if constexpr (std::is_same<T, I420>::value)
    sample_i420<kInterior>(reinterpret_cast<const uint8_t*>(src), h, w, sx,
                           sy, v, m);
  else
    sample_bgr<kInterior>(src, h, w, content, sx, sy, v, m);
}

// The non-zero tile [tx0, tx1] x [ty0, ty1] of frame n (its pixels from
// frame_px on) from `src`: warp r takes rows ty0 + r, ty0 + r + kWarps,
// ..., each lane the 4 consecutive pixels from x = tx0 + 4 lane, written
// by store_pixels. A pixel's source coordinate is src_coord's ((a x) +
// (b y)) + c.
template <bool kInterior, typename T>
__device__ __forceinline__ void gather_tile(const T* src, int h, int w,
                                            const Coeffs& k, bool content,
                                            float* __restrict__ out,
                                            float* __restrict__ mask,
                                            size_t frame_px, int out_w,
                                            int tx0, int ty0, int tx1,
                                            int ty1) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int x = tx0 + lane * kPix;
  if (x > tx1) return;
  for (int y = ty0 + warp; y <= ty1; y += kWarps) {
    float v[kPix][3], m[kPix];       // v[i], m[i]: pixel x + i
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      const int px = x + i;
      if (px <= tx1) {
        sample_any<kInterior>(src, h, w, content,
                              src_coord(k.i00, k.i01, k.i02, px, y),
                              src_coord(k.i10, k.i11, k.i12, px, y), v[i],
                              &m[i]);
      } else {
        v[i][0] = v[i][1] = v[i][2] = m[i] = 0.f;
      }
    }
    const size_t p = frame_px + (size_t)y * out_w + x;
    store_pixels(out + p * 3, mask + p, v, m, x, tx1 + 1);
  }
}

// The gather kernel of the uint8, float32 and per-tap I420 sources. grid:
// (output tiles across, tiles down, frames); a block warps one
// kGatherTileH x kTileW output tile of frame blockIdx.z (src + n *
// src_stride elements, h x w its logical size) into out/mask from n *
// out_h * out_w on. Frame n's dst->src coefficients are row n of the
// device `table`, else set n of `host`. The block maps its tile's corners
// (tile_span) and takes one route, uniform across it:
//  - zero: every corner finite and no tap in the frame: zero_tile, no
//    per-pixel work (at a seam-scale downscale most of a frame's window);
//  - direct: the taps from device memory (__ldg).
// A box inside the frame (every tap in range) drops the bounds tests and
// saturating conversions. tiles, when not null, counts the tiles of each
// Route. kTileBlocks<T> blocks an SM bound ptxas's registers: the direct
// route is bound by its taps' load latency, so it needs warps in flight.
template <typename T>
constexpr int kTileBlocks = std::is_same<T, I420>::value ? 4 : 5;

template <typename T, int S>
__global__ void __launch_bounds__(kThreads, kTileBlocks<T>)
warp_affine_tile_kernel(const T* __restrict__ src, size_t src_stride,
                        int h, int w, const float* __restrict__ table,
                        const __grid_constant__ HostSets<S> host,
                        int content, float* __restrict__ out,
                        float* __restrict__ mask, int out_h, int out_w,
                        int* __restrict__ tiles) {
  const int n = blockIdx.z;
  const Coeffs k = coeffs_of(table, host, n);
  const int tx0 = blockIdx.x * kTileW;
  const int ty0 = blockIdx.y * kGatherTileH;
  const int tx1 = min(tx0 + kTileW, out_w) - 1;
  const int ty1 = min(ty0 + kGatherTileH, out_h) - 1;
  const size_t frame_px = (size_t)n * out_h * out_w;
  float lx, ux, ly, uy;
  const bool finite =
      tile_span(k.i00, k.i01, k.i02, tx0, ty0, tx1, ty1, &lx, &ux) &
      tile_span(k.i10, k.i11, k.i12, tx0, ty0, tx1, ty1, &ly, &uy);
  int route = kDirectTile;
  if (finite && !(lx <= (float)(w - 1) && ux >= 0.f &&
                  ly <= (float)(h - 1) && uy >= 0.f)) {
    route = kZeroTile;
    zero_tile(out, mask, frame_px, out_w, tx0, ty0, tx1, ty1);
  } else {
    const T* frame = src + (size_t)n * src_stride;
    if (finite && lx >= 0.f && ux <= (float)(w - 1) && ly >= 0.f &&
        uy <= (float)(h - 1))
      gather_tile<true>(frame, h, w, k, content != 0, out, mask, frame_px,
                        out_w, tx0, ty0, tx1, ty1);
    else
      gather_tile<false>(frame, h, w, k, content != 0, out, mask, frame_px,
                         out_w, tx0, ty0, tx1, ty1);
  }
  if (tiles != nullptr && threadIdx.x == 0) atomicAdd(tiles + route, 1);
}

// One thread an affine: out[6i..] = affine_inverse::invert(a23s[6i..]).
__global__ void affine_inverse_kernel(const float* __restrict__ a23s,
                                      float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) affine_inverse::invert(a23s + 6 * i, out + 6 * i);
}

// The n <= S coefficient sets at `host` by value, or none when the kernel
// reads a device table.
template <int S>
HostSets<S> host_sets(const float* table, const float* host, int n) {
  HostSets<S> sets{};
  if (table == nullptr) memcpy(sets.v, host, sizeof(float) * 6 * (size_t)n);
  return sets;
}

// f(the n sets at host by value): a block of one set when the kernel
// reads a device table or warps one frame, so a one-frame launch carries
// 24 B of coefficients and not 3,840.
template <typename F>
int with_sets(const float* table, const float* host, int n, F&& f) {
  if (table != nullptr || n == 1) return f(host_sets<1>(table, host, n));
  return f(host_sets<kByValue>(table, host, n));
}

// The sets' count, S, of a HostSets<S> value.
template <typename Sets>
constexpr int sets_of() {
  return std::decay_t<Sets>::kSets;
}

// Whether a launch of n frames reads table (device), or else the n sets
// at host by value: false when it can do neither (no table and more than
// kByValue sets, or none).
bool coefficients_ok(const float* table, const float* host, int n) {
  return table != nullptr || (host != nullptr && n <= kByValue);
}

// Lets warp_i420_staged_kernel<S> take smem_bytes of dynamic shared
// memory: above 48 KB only after opting in, per device.
template <int S>
int opt_in_staged(int smem_bytes) {
  static int opted_in[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (smem_bytes > 48 * 1024 && smem_bytes > opted_in[dev]) {
    err = cudaFuncSetAttribute(warp_i420_staged_kernel<S>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = smem_bytes;
  }
  return 0;
}

// What a launch returns, beside 0 and the CUDA errors, when a frame's
// src->dst affine has no finite inverse: it launched nothing (the wrapper
// then applies inverse_coeffs' singular test).
constexpr int kNotFinite = -1;

// The n src->dst affines at a23s inverted on the host (affine_inverse's
// host path: inverse_coeffs' bits) into k (n x 6): the number of them
// with a coefficient that is not finite.
int host_inverse(const float* a23s, int n, float* k) {
  int bad = 0;
  for (int f = 0; f < n; ++f) {
    affine_inverse::invert(a23s + 6 * f, k + 6 * f);
    bool finite = true;
    for (int j = 0; j < 6; ++j) finite = finite && std::isfinite(k[6 * f + j]);
    bad += finite ? 0 : 1;
  }
  return bad;
}

// The gather kernel over n frames of h x w (src_stride elements apart):
// table a device (n, 6) float32 array of dst->src coefficients, or null
// with the n sets at host passed by value: dst->src coefficients, or with
// invert src->dst affines, inverted here first. Returns kNotFinite, and
// launches nothing, when such an inverse is not finite.
template <typename T>
int launch_tiles(const T* src, long long src_stride, int h, int w,
                 const float* table, const float* host, int invert,
                 int content, float* out, float* mask, int out_h, int out_w,
                 int n, int* tiles, void* stream) {
  if ((size_t)out_h * out_w == 0 || n <= 0) return 0;
  if (!coefficients_ok(table, host, n) || (invert && table != nullptr))
    return (int)cudaErrorInvalidValue;
  float k[6 * kByValue];
  if (invert) {
    if (host_inverse(host, n, k) != 0) return kNotFinite;
    host = k;
  }
  const dim3 grid((unsigned)((out_w + kTileW - 1) / kTileW),
                  (unsigned)((out_h + kGatherTileH - 1) / kGatherTileH),
                  (unsigned)n);
  return with_sets(table, host, n, [&](const auto& sets) {
    constexpr int S = sets_of<decltype(sets)>();
    warp_affine_tile_kernel<T, S><<<grid, kThreads, 0,
                                    (cudaStream_t)stream>>>(
        src, (size_t)src_stride, h, w, table, sets, content, out, mask,
        out_h, out_w, tiles);
    return (int)cudaGetLastError();
  });
}

// The staged I420 kernel over boxes of at most box_h x box_w; smem_bytes
// as the host plan sized it (at least StagedLayout's).
int launch_staged(const uint8_t* src, long long src_stride, int h, int w,
                  const float* table, const float* host, float* out,
                  float* mask, int out_h, int out_w, int n, int box_h,
                  int box_w, int smem_bytes, void* stream) {
  if ((long long)out_h * out_w == 0 || n <= 0) return 0;
  if (!coefficients_ok(table, host, n) || box_h <= 0 || box_w <= 0 ||
      smem_bytes < StagedLayout(box_h, box_w, h, w).bytes)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((out_w + kTileW - 1) / kTileW),
                  (unsigned)((out_h + kTileH - 1) / kTileH), (unsigned)n);
  return with_sets(table, host, n, [&](const auto& sets) {
    constexpr int S = sets_of<decltype(sets)>();
    const int err = opt_in_staged<S>(smem_bytes);
    if (err != 0) return err;
    warp_i420_staged_kernel<S><<<grid, kThreads, smem_bytes,
                                 (cudaStream_t)stream>>>(
        src, (size_t)src_stride, h, w, table, sets, out, mask, out_h, out_w,
        box_h, box_w);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// uint8 frames (src_stride in bytes); content: 0 for the footprint mask,
// 1 for the warped gray > 2 indicator. table: device (n, 6) float32
// dst->src coefficients, or null with the n <= kByValue sets at the host
// pointer `host` (read during the call, passed to the kernel by value):
// dst->src coefficients, or with invert != 0 src->dst affines that the
// entry inverts on the host. tiles: device int counts of zero and direct
// tiles (added to), or null. Returns 0, a CUDA error, or kNotFinite
// (nothing launched: an inverse is not finite).
extern "C" int warp_affine_u8(const uint8_t* src, long long src_stride,
                              int h, int w, const float* table,
                              const float* host, int invert, int content,
                              float* out, float* mask, int out_h, int out_w,
                              int n, int* tiles, void* stream) {
  return launch_tiles(src, src_stride, h, w, table, host, invert, content,
                      out, mask, out_h, out_w, n, tiles, stream);
}

// float32 frames (src_stride in floats); the mask is always the footprint;
// the rest as warp_affine_u8.
extern "C" int warp_affine_f32(const float* src, long long src_stride,
                               int h, int w, const float* table,
                               const float* host, int invert, float* out,
                               float* mask, int out_h, int out_w, int n,
                               int* tiles, void* stream) {
  return launch_tiles(src, src_stride, h, w, table, host, invert, 0, out,
                      mask, out_h, out_w, n, tiles, stream);
}

// packed I420 uint8 frames (h x w the logical size, h % 4 == 0, w % 2 ==
// 0; src_stride in bytes, h * w * 3 / 2 a frame); dst->src coefficients
// as warp_affine_u8's; the mask is always the footprint. box_h == 0: the
// gather kernel (zero and direct tiles, counted in `tiles` when not
// null); else the staged kernel over source boxes of at most box_h x
// box_w with smem_bytes of dynamic shared memory (ops/warp_kernel.
// i420_plan).
extern "C" int warp_affine_i420(const uint8_t* src, long long src_stride,
                                int h, int w, const float* table,
                                const float* host, float* out, float* mask,
                                int out_h, int out_w, int n, int box_h,
                                int box_w, int smem_bytes, int* tiles,
                                void* stream) {
  if ((h & 3) || (w & 1)) return (int)cudaErrorInvalidValue;
  if (box_h == 0)
    return launch_tiles(reinterpret_cast<const I420*>(src), src_stride, h,
                        w, table, host, 0, 0, out, mask, out_h, out_w, n,
                        tiles, stream);
  return launch_staged(src, src_stride, h, w, table, host, out, mask, out_h,
                       out_w, n, box_h, box_w, smem_bytes, stream);
}

// n single float32 planes of h x w (src_stride floats apart; the JAX
// package's warp_affine_traced / warp_affine_many form), each warped by
// its src->dst affine, inverted in the kernel: element (k, i, j) of the
// device array a23s at k * sn + i * sr + j * sc floats, or, with a23s
// null, the n <= kByValue row-major (2, 3) affines at the host pointer
// `host`, passed by value. out: (n, out_h, out_w) float32, no mask.
// direct != 0 keeps every tile on the direct gather; staged_tiles (device,
// or null) adds the number of staged tiles.
extern "C" int warp_affine_plane_f32(const float* src, long long src_stride,
                                     int h, int w, const float* a23s,
                                     long long sn, long long sr,
                                     long long sc, const float* host,
                                     float* out, int out_h, int out_w, int n,
                                     int direct, int* staged_tiles,
                                     void* stream) {
  if ((size_t)out_h * out_w == 0 || n <= 0) return 0;
  if (!coefficients_ok(a23s, host, n)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((out_w + kTileW - 1) / kTileW),
                  (unsigned)((out_h + kPlaneTileH - 1) / kPlaneTileH),
                  (unsigned)n);
  return with_sets(a23s, host, n, [&](const auto& sets) {
    constexpr int S = sets_of<decltype(sets)>();
    warp_plane_kernel<S><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        src, (size_t)src_stride, h, w, a23s, sn, sr, sc, sets, out, out_h,
        out_w, direct, staged_tiles);
    return (int)cudaGetLastError();
  });
}

// The single-plane kernel's inverse alone: n row-major (2, 3) src->dst
// affines (device, contiguous) to their n x 6 dst->src coefficients
// (device), one thread each.
extern "C" int affine_inverse_f32(const float* a23s, float* out, int n,
                                  void* stream) {
  if (n <= 0) return 0;
  affine_inverse_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      a23s, out, n);
  return (int)cudaGetLastError();
}

// The same inverse on the host (affine_inverse.cuh's host path, built by
// nvcc's host compiler with -ffp-contract=off): n row-major (2, 3)
// src->dst affines (host) to their n x 6 dst->src coefficients (host),
// which the uint8, float32 and I420 launches take by value. Returns the
// number of affines with a coefficient that is not finite.
extern "C" int affine_inverse_f32_host(const float* a23s, float* out,
                                       int n) {
  return host_inverse(a23s, n, out);
}
