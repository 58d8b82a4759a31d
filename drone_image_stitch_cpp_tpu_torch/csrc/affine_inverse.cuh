// The float32 inverse of a 2x3 affine, for K2's single-plane kernel
// (csrc/warp_affine.cu), which inverts each frame's src->dst transform
// inside the launch; for the same library's host entry
// affine_inverse_f32_host, which inverts the other K2 launches' affines
// before they go by value; and for a host build by g++ (csrc/
// affine_inverse_host.cpp) that holds the same source to the plain
// versions on a machine with no card.
//
// It is the LU solve with partial pivoting of ops/warp_kernel.
// device_inverse_coeffs, in that function's operation order, which is the
// JAX package's ops/transform.invert_affine: pivot reciprocals, the fused
// back substitution and translation. Every step is rounded to float32
// once, as that function rounds it: a reciprocal, a product or a
// difference alone, and a * b + c as one fused multiply-add. So the
// coefficients equal device_inverse_coeffs (and its rows, inverse_coeffs)
// and invert_affine bit for bit. A singular affine gives what the same
// arithmetic gives there, coefficients that are not finite (a reciprocal
// of 0) as a rule; nothing here raises.
//
// On the card each step is an explicitly rounded intrinsic (__frcp_rn,
// __fmul_rn, __fsub_rn, __fmaf_rn), so nvcc can neither contract nor
// approximate it. On the host (g++, and nvcc's host pass) the steps are
// IEEE float operations and std::fmaf; both host builds pass
// -ffp-contract=off. Build none with fast-math flags.

#pragma once

#include <cmath>

#ifdef __CUDACC__
#define AFFINE_INVERSE_FN __host__ __device__ __forceinline__
#else
#define AFFINE_INVERSE_FN inline
#endif

namespace affine_inverse {

AFFINE_INVERSE_FN float rcp(float p) {
#ifdef __CUDA_ARCH__
  return __frcp_rn(p);
#else
  return 1.0f / p;
#endif
}

AFFINE_INVERSE_FN float mul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

AFFINE_INVERSE_FN float sub(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}

// a * b + c, rounded once
AFFINE_INVERSE_FN float fma(float a, float b, float c) {
#ifdef __CUDA_ARCH__
  return __fmaf_rn(a, b, c);
#else
  return std::fmaf(a, b, c);
#endif
}

AFFINE_INVERSE_FN float absf(float v) {
#ifdef __CUDA_ARCH__
  return fabsf(v);
#else
  return std::fabs(v);
#endif
}

// m: the src->dst affine [a, b, tx, c, d, ty] (row-major (2, 3)); out: its
// dst->src coefficients [i00, i01, i02, i10, i11, i12].
AFFINE_INVERSE_FN void invert(const float m[6], float out[6]) {
  const float a = m[0], b = m[1], tx = m[2];
  const float c = m[3], d = m[4], ty = m[5];
  const bool swap = absf(c) > absf(a);          // the pivot row
  const float p = swap ? c : a, q = swap ? d : b;
  const float r = swap ? a : c, s = swap ? b : d;
  const float rp = rcp(p);
  const float low = mul(r, rp);
  const float ru = rcp(sub(s, mul(low, q)));
  float x1[2], x2[2];
  for (int e = 0; e < 2; ++e) {                 // the columns e1, e2
    const float y1 = (e == 0) != swap ? 1.0f : 0.0f;
    const float y2 = 1.0f - y1;
    x2[e] = mul(sub(y2, mul(low, y1)), ru);
    x1[e] = mul(fma(-q, x2[e], y1), rp);
  }
  out[0] = x1[0];
  out[1] = x1[1];
  out[2] = -fma(x1[1], ty, mul(x1[0], tx));
  out[3] = x2[0];
  out[4] = x2[1];
  out[5] = -fma(x2[1], ty, mul(x2[0], tx));
}

}  // namespace affine_inverse

#undef AFFINE_INVERSE_FN
