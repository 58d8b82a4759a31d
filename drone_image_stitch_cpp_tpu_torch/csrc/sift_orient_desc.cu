// K1: SIFT orientation + 128-d descriptor, one thread block per keypoint.
//
// Replaces the Pallas TPU kernel drone_image_stitch_cpp_tpu/ops/
// pallas_sift.py::_kernel (launched through _run / orientation_descriptor_
// flat, called at ops/features.py:794). The TPU version DMA'd a 96x256
// window per keypoint, packed two keypoints into 256 lanes and binned with
// masked row reductions and a polynomial atan2. Here each block stages the
// keypoint's 81x81 support window (26 KB) in shared memory once, and the
// histograms are shared-memory float atomics; atan2f is the CUDA math
// library's.
//
// What bounds it on the H100: per keypoint it reads 26 KB (the window,
// scattered rows of a Gaussian stack that mostly sits in the 50 MB L2) and
// does ~6.2k gradient evaluations twice (orientation pass, then the
// descriptor pass with up to 8 hat-weighted atomic adds per pixel). At
// 12k keypoints per 8-frame batch that is ~0.3 GB of window loads and
// ~10^8 shared atomics: latency of the window gather and atomic contention
// on the 128 descriptor bins bound it, not arithmetic. The simple design
// recomputes the gradients in the descriptor pass instead of keeping
// magnitude/angle planes (which would need 50 KB more shared memory).
//
// Semantics match ops/sift_kernel.orientation_descriptor_plain: the
// gradient at absolute (r, c) is valid iff 1 <= r <= h-2 and 1 <= c <= w-2
// of the keypoint's own octave (true_h/true_w); the window reads are
// clamped to the stack, which never affects a valid gradient.
//
// Plain C interface for ctypes; returns the cudaGetLastError() code.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kR = 40;                 // window half-size
constexpr int kWin = 2 * kR + 1;       // 81
constexpr int kIn = kWin - 2;          // 79 gradient positions per axis
constexpr int kOriBins = 36;
constexpr int kD = 4;
constexpr int kOBins = 8;
constexpr int kThreads = 256;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kBinAngle = 0.17453292519943295f;   // 2*pi/36

__global__ void __launch_bounds__(kThreads)
sift_orient_desc_kernel(const float* __restrict__ gauss, int L, int H, int W,
                        const int* __restrict__ layer,
                        const float* __restrict__ yf,
                        const float* __restrict__ xf,
                        const float* __restrict__ sigma,
                        const float* __restrict__ true_h,
                        const float* __restrict__ true_w,
                        float* __restrict__ angle_out,
                        float* __restrict__ desc_out) {
  __shared__ float win[kWin * kWin];
  __shared__ float hist[kOriBins];
  __shared__ float desc[kD * kD * kOBins];
  __shared__ float s_angle;

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const int li = min(max(layer[k], 0), L - 1);
  const float y = yf[k];
  const float x = xf[k];
  const float s = sigma[k];
  const float th = true_h[k];
  const float tw = true_w[k];
  const int yi = (int)rintf(y);        // round half to even, like torch
  const int xi = (int)rintf(x);
  const float* img = gauss + (size_t)li * H * W;

  for (int i = tid; i < kWin * kWin; i += kThreads) {
    int r = min(max(yi - kR + i / kWin, 0), H - 1);
    int c = min(max(xi - kR + i % kWin, 0), W - 1);
    win[i] = img[(size_t)r * W + c];
  }
  for (int i = tid; i < kOriBins; i += kThreads) hist[i] = 0.f;
  for (int i = tid; i < kD * kD * kOBins; i += kThreads) desc[i] = 0.f;
  __syncthreads();

  // ---- orientation histogram (offsets from the rounded centre) ---------
  const float radius = rintf(4.5f * s);
  const float sig = 1.5f * s;
  const float two_sig2 = 2.f * sig * sig;
  for (int i = tid; i < kIn * kIn; i += kThreads) {
    const int a = i / kIn + 1;
    const int b = i % kIn + 1;
    const float dyo = (float)(a - kR);
    const float dxo = (float)(b - kR);
    if (fabsf(dyo) > radius || fabsf(dxo) > radius) continue;
    const float r = (float)(yi - kR + a);
    const float c = (float)(xi - kR + b);
    if (!(r >= 1.f && r <= th - 2.f && c >= 1.f && c <= tw - 2.f)) continue;
    const float gx = 0.5f * (win[a * kWin + b + 1] - win[a * kWin + b - 1]);
    const float gy = 0.5f * (win[(a - 1) * kWin + b] - win[(a + 1) * kWin + b]);
    const float mag = sqrtf(gx * gx + gy * gy);
    const float w = expf(-(dyo * dyo + dxo * dxo) / two_sig2);
    const float theta = atan2f(gy, gx);
    int bin = (int)rintf((theta / kTwoPi) * (float)kOriBins) % kOriBins;
    if (bin < 0) bin += kOriBins;
    atomicAdd(&hist[bin], mag * w);
  }
  __syncthreads();

  if (tid == 0) {
    float hs[kOriBins];
    for (int b = 0; b < kOriBins; ++b) {
      const float m2 = hist[(b + kOriBins - 2) % kOriBins];
      const float p2 = hist[(b + 2) % kOriBins];
      const float m1 = hist[(b + kOriBins - 1) % kOriBins];
      const float p1 = hist[(b + 1) % kOriBins];
      hs[b] = ((m2 + p2) + 4.f * (m1 + p1) + 6.f * hist[b]) / 16.f;
    }
    int best = 0;
    for (int b = 1; b < kOriBins; ++b)
      if (hs[b] > hs[best]) best = b;   // first maximum, like argmax
    const float lv = hs[(best + kOriBins - 1) % kOriBins];
    const float cv = hs[best];
    const float rv = hs[(best + 1) % kOriBins];
    const float denom = lv - 2.f * cv + rv;
    const float interp = fabsf(denom) > 1e-12f ? 0.5f * (lv - rv) / denom : 0.f;
    float pos = fmodf((float)best + interp, (float)kOriBins);
    if (pos < 0.f) pos += (float)kOriBins;
    s_angle = pos * kBinAngle;
    angle_out[k] = s_angle;
  }
  __syncthreads();

  // ---- descriptor: native pixels in the rotated frame ------------------
  const float ang = s_angle;
  const float ca = cosf(ang);
  const float sa = sinf(ang);
  const float hist_width = 3.f * s;
  for (int i = tid; i < kIn * kIn; i += kThreads) {
    const int a = i / kIn + 1;
    const int b = i % kIn + 1;
    const float r = (float)(yi - kR + a);
    const float c = (float)(xi - kR + b);
    if (!(r >= 1.f && r <= th - 2.f && c >= 1.f && c <= tw - 2.f)) continue;
    const float dx = c - x;
    const float dy = r - y;
    const float u = (ca * dx - sa * dy) / hist_width;
    const float v = (sa * dx + ca * dy) / hist_width;
    const float rbin = v + 1.5f;
    const float cbin = u + 1.5f;
    if (!(rbin > -1.f && rbin < (float)kD && cbin > -1.f && cbin < (float)kD))
      continue;
    const float gx = 0.5f * (win[a * kWin + b + 1] - win[a * kWin + b - 1]);
    const float gy = 0.5f * (win[(a - 1) * kWin + b] - win[(a + 1) * kWin + b]);
    const float mag = sqrtf(gx * gx + gy * gy);
    const float theta = atan2f(gy, gx);
    float obin = fmodf(((theta - ang) / kTwoPi) * (float)kOBins, (float)kOBins);
    if (obin < 0.f) obin += (float)kOBins;
    const float m = mag * expf(-(u * u + v * v) * (2.f / (kD * kD)));
    for (int by = 0; by < kD; ++by) {
      const float wy = 1.f - fabsf(rbin - (float)by);
      if (wy <= 0.f) continue;
      const float wym = wy * m;
      for (int bx = 0; bx < kD; ++bx) {
        const float wx = 1.f - fabsf(cbin - (float)bx);
        if (wx <= 0.f) continue;
        const float z = wx * wym;
        for (int o = 0; o < kOBins; ++o) {
          const float od = fabsf(obin - (float)o);
          const float wo = 1.f - fminf(od, (float)kOBins - od);
          if (wo <= 0.f) continue;
          atomicAdd(&desc[(by * kD + bx) * kOBins + o], z * wo);
        }
      }
    }
  }
  __syncthreads();

  // ---- normalise, clip 0.2, renormalise, x512, clip 255 (one warp) -----
  if (tid < 32) {
    float v[4];
    float ss = 0.f;
    for (int j = 0; j < 4; ++j) {
      v[j] = desc[tid * 4 + j];
      ss += v[j] * v[j];
    }
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    const float nrm = sqrtf(ss + 1e-12f);
    float ss2 = 0.f;
    for (int j = 0; j < 4; ++j) {
      v[j] = fminf(v[j] / nrm, 0.2f);
      ss2 += v[j] * v[j];
    }
    for (int off = 16; off > 0; off >>= 1)
      ss2 += __shfl_xor_sync(0xffffffffu, ss2, off);
    const float nrm2 = sqrtf(ss2 + 1e-12f);
    float* out = desc_out + (size_t)k * (kD * kD * kOBins);
    for (int j = 0; j < 4; ++j)
      out[tid * 4 + j] = fminf(v[j] / nrm2 * 512.f, 255.f);
  }
}

}  // namespace

extern "C" int sift_orient_desc(const float* gauss, int L, int H, int W,
                                const int* layer, const float* yf,
                                const float* xf, const float* sigma,
                                const float* true_h, const float* true_w,
                                float* angle_out, float* desc_out, int n,
                                void* stream) {
  if (n <= 0) return 0;
  sift_orient_desc_kernel<<<n, kThreads, 0, (cudaStream_t)stream>>>(
      gauss, L, H, W, layer, yf, xf, sigma, true_h, true_w, angle_out,
      desc_out);
  return (int)cudaGetLastError();
}
