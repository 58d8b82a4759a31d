// K1: SIFT orientation + 128-d descriptor, one thread block per keypoint.
//
// Replaces the Pallas TPU kernel drone_image_stitch_cpp_tpu/ops/
// pallas_sift.py::_kernel (launched through _run / orientation_descriptor_
// flat, called at ops/features.py:794). The TPU version DMA'd a 96x256
// window per keypoint, packed two keypoints into 256 lanes and binned with
// masked row reductions and a polynomial atan2; atan2f here is the CUDA
// math library's.
//
// What bounds it on the H100: per keypoint it needs the (2R+1)^2 window
// of its support (R = support_radius(sigma) <= 40, from the wrapper), and
// the gradient, histogram and descriptor arithmetic over it. The unique
// window bytes of a detect batch are tens of MB and the arithmetic about
// a GFLOP, so the card's bound is tens of microseconds; what a kernel
// loses is latency and issue slots: the window gather, loops over
// positions outside the support, idle lanes, contended atomics. So:
//  - the window is staged with 4-byte cp.async (zero fill outside the
//    stack: such taps only feed gradients that are masked out), sized by
//    the keypoint's own support radius, all threads over the flattened
//    window (the row pitch of the stack is not a multiple of 16 bytes);
//  - each gradient's magnitude and angle are computed once, and only
//    where a pass uses them, into shared planes (dynamic shared memory,
//    ~108 KB, two blocks per SM): the orientation pass computes its
//    round(4.5 sigma) box; once the angle is known, the descriptor pass
//    reuses those and computes the rest of its rotated 4x4-cell square,
//    turning each pixel into its Gaussian-weighted magnitude and
//    orientation bin; each cell's warp then visits only the bounding box
//    of the pixels whose hats reach that cell;
//  - no float atomics: the orientation histogram is summed by bin-owner
//    threads over fixed slices of the box and then over the slices in a
//    fixed order; warp w owns descriptor cell w (4x4 grid), each lane
//    sums its pixels' 8 orientation bins in a private shared row, and the
//    warp reduces the rows with a fixed shuffle tree. Two launches on the
//    same input give bit-identical results;
//  - one warp smooths the histogram and finds the first maximum with
//    shuffles (ties to the lowest bin, as torch.argmax).
// Block k handles keypoint k; the launch order of the keypoints (by scale
// or as given) made no measurable difference on the card.
//
// Semantics match ops/sift_kernel.orientation_descriptor_plain: the
// gradient at absolute (r, c) is valid iff 1 <= r <= h-2 and 1 <= c <= w-2
// of the keypoint's own octave (true_h/true_w); rintf centre; first
// maximum; 0.2 clip, x512, clip at 255.
//
// Plain C interface for ctypes; returns the cudaGetLastError() code.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRMax = 40;                  // window half-size cap: 81x81
constexpr int kWinMax = 2 * kRMax + 1;     // 81
constexpr int kGridMax = kWinMax - 2;      // 79 gradient positions per axis
constexpr int kPlane = kGridMax * kGridMax;
constexpr int kOriBins = 36;
constexpr int kSlices = 14;                // 36 bins x 14 slices = 504 threads
constexpr int kD = 4;
constexpr int kOBins = 8;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;      // 16: one per descriptor cell
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kBinAngle = 0.17453292519943295f;   // 2*pi/36

// window, magnitude, angle, orientation-box values, slice partials,
// histogram, smoothed histogram, descriptor, angle (+pad); then the
// orientation-box bins as bytes
constexpr int kSmemFloats = kWinMax * kWinMax + 3 * kPlane +
                            kSlices * kOriBins + 2 * kOriBins +
                            kD * kD * kOBins + 4;
constexpr int kSmemBytes = kSmemFloats * 4 + kPlane;

static_assert(kWarps == kD * kD, "one warp per descriptor cell");
static_assert(kThreads * 9 <= kWinMax * kWinMax,
              "per-lane descriptor sums fit in the window");
static_assert(kSlices * kOriBins <= kThreads, "bin-owner threads");
static_assert((kWinMax * kWinMax + 3 * kPlane + kSlices * kOriBins +
               2 * kOriBins) % 4 == 0, "descriptor is float4-aligned");

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Central-difference gradient (magnitude, angle) at grid position (a, b)
// of a window with pitch ws whose row/column 0 lies one pixel before grid
// row/column 0 (absolute row oy + a, column ox + b); zero magnitude and
// angle outside [1, th-2] x [1, tw-2] of the keypoint's octave.
__device__ __forceinline__ void gradient(const float* win, int ws, int a,
                                         int b, int oy, int ox, float th,
                                         float tw, float* m, float* t) {
  const float r = (float)(oy + a);
  const float c = (float)(ox + b);
  *m = 0.f;
  *t = 0.f;
  if (r >= 1.f && r <= th - 2.f && c >= 1.f && c <= tw - 2.f) {
    const float* w0 = win + (a + 1) * ws + b + 1;
    const float gx = 0.5f * (w0[1] - w0[-1]);
    const float gy = 0.5f * (w0[-ws] - w0[ws]);   // y-up
    *m = sqrtf(gx * gx + gy * gy);
    *t = atan2f(gy, gx);
  }
}

// Offsets of pixel (c, r) from (x, y) rotated into the descriptor frame,
// in units of hist_width. Every step is rounded on its own, so the
// per-pixel pass and the per-cell pass get the same (u, v) and agree on
// which pixels lie inside.
__device__ __forceinline__ void rotate(int c, int r, float x, float y,
                                       float ca, float sa, float inv_hw,
                                       float* u, float* v) {
  const float dx = __fsub_rn((float)c, x);
  const float dy = __fsub_rn((float)r, y);
  *u = __fmul_rn(__fsub_rn(__fmul_rn(ca, dx), __fmul_rn(sa, dy)), inv_hw);
  *v = __fmul_rn(__fadd_rn(__fmul_rn(sa, dx), __fmul_rn(ca, dy)), inv_hw);
}

// torch.remainder for a positive modulus
__device__ __forceinline__ float py_mod(float a, float m) {
  float r = fmodf(a, m);
  return r < 0.f ? r + m : r;
}

__global__ void __launch_bounds__(kThreads, 2)
sift_orient_desc_kernel(const float* __restrict__ gauss, int L, int H, int W,
                        const int* __restrict__ radius,
                        const int64_t* __restrict__ layer,
                        const float* __restrict__ yf,
                        const float* __restrict__ xf,
                        const float* __restrict__ sigma,
                        const float* __restrict__ true_h,
                        const float* __restrict__ true_w,
                        float* __restrict__ angle_out,
                        float* __restrict__ desc_out) {
  extern __shared__ __align__(16) float smem[];
  float* win = smem;
  float* mag = win + kWinMax * kWinMax;
  float* theta = mag + kPlane;
  float* oval = theta + kPlane;
  float* part = oval + kPlane;
  float* hist = part + kSlices * kOriBins;
  float* hsm = hist + kOriBins;
  float* desc = hsm + kOriBins;
  float* s_angle = desc + kD * kD * kOBins;
  uint8_t* obin = reinterpret_cast<uint8_t*>(s_angle + 4);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int k = blockIdx.x;
  const int R = min(max(radius[k], 1), kRMax);
  const int G = R - 1;                 // gradient offsets -G..G
  const int ws = 2 * R + 1;
  const int gs = 2 * G + 1;
  const int li = (int)min(max(layer[k], (int64_t)0), (int64_t)(L - 1));
  const float y = yf[k];
  const float x = xf[k];
  const float s = sigma[k];
  const float th = true_h[k];
  const float tw = true_w[k];
  const int yi = (int)rintf(y);        // round half to even, like torch
  const int xi = (int)rintf(x);
  const float* img = gauss + (size_t)li * H * W;

  // ---- stage the support window ---------------------------------------
  // Loops over a side x side square take positions i = tid, tid + kThreads,
  // ... as (row a, column b), advanced without dividing.
  {
    int a = tid / ws;
    int b = tid % ws;
    for (int i = tid; i < ws * ws; i += kThreads) {
      const int r = yi - R + a;
      const int c = xi - R + b;
      const bool in = r >= 0 && r < H && c >= 0 && c < W;
      cp_async4(win + i, in ? img + (size_t)r * W + c : img, in ? 4 : 0);
      a += kThreads / ws;
      b += kThreads % ws;
      if (b >= ws) {
        b -= ws;
        ++a;
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // ---- gradients of the orientation box (weights and bins) ------------
  const int ro = min((int)rintf(4.5f * s), G);   // orientation box half-size
  const int os = 2 * ro + 1;
  const int npos = ro >= 0 ? os * os : 0;
  const float sig = 1.5f * s;
  const float two_sig2 = 2.f * sig * sig;
  {
    int qa = tid / os;
    int qb = tid % os;
    for (int q = tid; q < npos; q += kThreads) {
      const int dyo = qa - ro;
      const int dxo = qb - ro;
      float m, t;
      gradient(win, ws, G + dyo, G + dxo, yi - G, xi - G, th, tw, &m, &t);
      mag[(G + dyo) * gs + G + dxo] = m;
      theta[(G + dyo) * gs + G + dxo] = t;
      const float w = expf(-(float)(dyo * dyo + dxo * dxo) / two_sig2);
      int bin = (int)rintf((t / kTwoPi) * (float)kOriBins) % kOriBins;
      if (bin < 0) bin += kOriBins;
      oval[q] = m * w;
      obin[q] = (uint8_t)bin;
      qa += kThreads / os;
      qb += kThreads % os;
      if (qb >= os) {
        qb -= os;
        ++qa;
      }
    }
  }
  __syncthreads();

  // ---- orientation histogram: thread (bin b, slice j) sums the box
  //      positions j, j + kSlices, ... that fall in bin b -----------------
  if (tid < kSlices * kOriBins) {
    const int b = tid % kOriBins;
    const int j = tid / kOriBins;
    float acc = 0.f;
    for (int q = j; q < npos; q += kSlices)
      if (obin[q] == b) acc += oval[q];
    part[j * kOriBins + b] = acc;
  }
  __syncthreads();

  // ---- one warp: smoothing, first-max argmax, parabolic peak ------------
  if (warp == 0) {
    for (int b = lane; b < kOriBins; b += 32) {
      float sum = 0.f;
      for (int j = 0; j < kSlices; ++j) sum += part[j * kOriBins + b];
      hist[b] = sum;
    }
    __syncwarp();
    float best_v = -1.f;               // histogram values are >= 0
    int best_b = 0;
    for (int b = lane; b < kOriBins; b += 32) {
      const float m2 = hist[(b + kOriBins - 2) % kOriBins];
      const float p2 = hist[(b + 2) % kOriBins];
      const float m1 = hist[(b + kOriBins - 1) % kOriBins];
      const float p1 = hist[(b + 1) % kOriBins];
      const float v = ((m2 + p2) + 4.f * (m1 + p1) + 6.f * hist[b]) / 16.f;
      hsm[b] = v;
      if (v > best_v) {
        best_v = v;
        best_b = b;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best_v, off);
      const int ob = __shfl_xor_sync(0xffffffffu, best_b, off);
      if (ov > best_v || (ov == best_v && ob < best_b)) {
        best_v = ov;
        best_b = ob;
      }
    }
    __syncwarp();
    if (lane == 0) {
      const float lv = hsm[(best_b + kOriBins - 1) % kOriBins];
      const float cv = hsm[best_b];
      const float rv = hsm[(best_b + 1) % kOriBins];
      const float denom = lv - 2.f * cv + rv;
      const float interp =
          fabsf(denom) > 1e-12f ? 0.5f * (lv - rv) / denom : 0.f;
      const float ang =
          py_mod((float)best_b + interp, (float)kOriBins) * kBinAngle;
      *s_angle = ang;
      angle_out[k] = ang;
    }
  }
  __syncthreads();

  // ---- descriptor, per pixel: weighted magnitude and orientation bin ---
  const float ang = *s_angle;
  const float ca = cosf(ang);
  const float sa = sinf(ang);
  const float hist_width = 3.f * s;
  const float inv_hw = 1.f / hist_width;
  const int ox = xi - G;               // absolute column of grid column 0
  const int oy = yi - G;
  // Grid rows/columns strictly inside the bounding box of the rotated
  // square |u|, |v| < hu (in cells of hist_width) around centre (uc, vc).
  auto box = [&](float uc, float vc, float hu, int* r0, int* r1, int* c0,
                 int* c1) {
    float dx_lo = 3.4e38f, dx_hi = -3.4e38f, dy_lo = 3.4e38f,
          dy_hi = -3.4e38f;
#pragma unroll
    for (int corner = 0; corner < 4; ++corner) {
      const float u = uc + ((corner & 1) ? hu : -hu);
      const float v = vc + ((corner >> 1) ? hu : -hu);
      const float dx = hist_width * (ca * u + sa * v);
      const float dy = hist_width * (ca * v - sa * u);
      dx_lo = fminf(dx_lo, dx);
      dx_hi = fmaxf(dx_hi, dx);
      dy_lo = fminf(dy_lo, dy);
      dy_hi = fmaxf(dy_hi, dy);
    }
    // widened by 1e-3 px against rounding; the exact tests decide
    *r0 = max(0, (int)floorf(y + dy_lo - 1e-3f) + 1 - oy);
    *r1 = min(gs - 1, (int)ceilf(y + dy_hi + 1e-3f) - 1 - oy);
    *c0 = max(0, (int)floorf(x + dx_lo - 1e-3f) + 1 - ox);
    *c1 = min(gs - 1, (int)ceilf(x + dx_hi + 1e-3f) - 1 - ox);
  };
  // Each pixel of the 4x4-cell square (rbin, cbin in (-1, 4)) once: its
  // gradient (from the orientation pass where it has one), then mag
  // becomes magnitude x exp(-(u^2 + v^2)/8) and theta the orientation bin
  // position in [0, 8] (torch.remainder, exact for a power of 2). Pixels
  // outside the square are never read again.
  int sa0, sa1, sb0, sb1;
  box(0.f, 0.f, 0.5f * kD + 0.5f, &sa0, &sa1, &sb0, &sb1);
  {
    const int sw = max(sb1 - sb0 + 1, 1);
    const int ns = sa1 >= sa0 && sb1 >= sb0 ? (sa1 - sa0 + 1) * sw : 0;
    int a = sa0 + tid / sw;
    int b = sb0 + tid % sw;
    for (int i = tid; i < ns; i += kThreads) {
      float u, v;
      rotate(ox + b, oy + a, x, y, ca, sa, inv_hw, &u, &v);
      const float rbin = __fadd_rn(v, 1.5f);
      const float cbin = __fadd_rn(u, 1.5f);
      if (rbin > -1.f && rbin < (float)kD && cbin > -1.f &&
          cbin < (float)kD) {
        const int p = a * gs + b;
        float m, t;
        if (abs(a - G) <= ro && abs(b - G) <= ro) {
          m = mag[p];
          t = theta[p];
        } else {
          gradient(win, ws, a, b, oy, ox, th, tw, &m, &t);
        }
        float z0 = 0.f;
        float ob = 0.f;
        if (m > 0.f) {
          z0 = m * expf(-(u * u + v * v) * (2.f / (kD * kD)));
          const float tb = (t - ang) * ((float)kOBins / kTwoPi);
          ob = tb - (float)kOBins * floorf(tb * (1.f / kOBins));
        }
        mag[p] = z0;
        theta[p] = ob;
      }
      a += kThreads / sw;
      b += kThreads % sw;
      if (b > sb1) {
        b -= sw;
        ++a;
      }
    }
  }
  __syncthreads();

  // ---- descriptor, per cell: warp w owns cell (w / 4, w % 4) ------------
  // Its pixels are those whose hats reach the cell: rbin in (by-1, by+1)
  // and cbin in (bx-1, bx+1), a square inside the 4x4-cell one.
  const int by = warp / kD;
  const int bx = warp % kD;
  int a0, a1, b0, b1;
  box((float)bx - 1.5f, (float)by - 1.5f, 1.f, &a0, &a1, &b0, &b1);
  const int bw = max(b1 - b0 + 1, 1);
  const int nbox = a1 >= a0 && b1 >= b0 ? (a1 - a0 + 1) * bw : 0;
  // Each lane sums its 8 orientation bins in a private shared row (stride
  // 9: no bank conflicts) in the window, which is dead by now.
  float* sums = win + (warp * 32 + lane) * 9;
#pragma unroll
  for (int o = 0; o < kOBins; ++o) sums[o] = 0.f;
  {
    int a = a0 + lane / bw;
    int b = b0 + lane % bw;
    for (int i = lane; i < nbox; i += 32) {
      float u, v;
      rotate(ox + b, oy + a, x, y, ca, sa, inv_hw, &u, &v);
      const float wy = 1.f - fabsf(__fadd_rn(v, 1.5f) - (float)by);
      const float wx = 1.f - fabsf(__fadd_rn(u, 1.5f) - (float)bx);
      if (wy > 0.f && wx > 0.f) {
        const int p = a * gs + b;
        const float z0 = mag[p];
        if (z0 > 0.f) {
          // the two orientation hats, as 1 - circular distance
          const float z = wx * (wy * z0);
          const float ob = theta[p];
          const float o0 = floorf(ob);
          sums[(int)o0 & (kOBins - 1)] += z * (1.f - (ob - o0));
          sums[((int)o0 + 1) & (kOBins - 1)] +=
              z * (1.f - ((o0 + 1.f) - ob));
        }
      }
      a += 32 / bw;
      b += 32 % bw;
      if (b > b1) {
        b -= bw;
        ++a;
      }
    }
  }
#pragma unroll
  for (int o = 0; o < kOBins; ++o) {
    float v = sums[o];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == o) desc[warp * kOBins + o] = v;
  }
  __syncthreads();

  // ---- normalise, clip 0.2, renormalise, x512, clip 255 (one warp) -----
  if (warp == 0) {
    const float4 d4 = reinterpret_cast<const float4*>(desc)[lane];
    float v[4] = {d4.x, d4.y, d4.z, d4.w};
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) ss += v[j] * v[j];
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    const float nrm = sqrtf(ss + 1e-12f);
    float ss2 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = fminf(v[j] / nrm, 0.2f);
      ss2 += v[j] * v[j];
    }
    for (int off = 16; off > 0; off >>= 1)
      ss2 += __shfl_xor_sync(0xffffffffu, ss2, off);
    const float nrm2 = sqrtf(ss2 + 1e-12f);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = fminf(v[j] / nrm2 * 512.f, 255.f);
    reinterpret_cast<float4*>(desc_out + (size_t)k * (kD * kD * kOBins))
        [lane] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

}  // namespace

// radius: each keypoint's window half-size (ops/sift_kernel.support_radius, capped at 40); layer: each
// keypoint's flat layer in the (L, H, W) stack.
extern "C" int sift_orient_desc(const float* gauss, int L, int H, int W,
                                const int* radius,
                                const int64_t* layer, const float* yf,
                                const float* xf, const float* sigma,
                                const float* true_h, const float* true_w,
                                float* angle_out, float* desc_out, int n,
                                void* stream) {
  if (n <= 0) return 0;
  // above 48 KB of dynamic shared memory only after opting in, once per
  // device
  static bool opted_in[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(sift_orient_desc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = true;
  }
  sift_orient_desc_kernel<<<n, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      gauss, L, H, W, radius, layer, yf, xf, sigma, true_h, true_w,
      angle_out, desc_out);
  return (int)cudaGetLastError();
}
