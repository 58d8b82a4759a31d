// The host instantiation of csrc/affine_inverse.cuh, built by g++ with
// -ffp-contract=off (utils/native.affine_inverse_host): the tests hold it
// bit-equal to ops/warp_kernel.inverse_coeffs, device_inverse_coeffs and
// the JAX package's invert_affine on the CPU.

#include "affine_inverse.cuh"

// a23s: n row-major (2, 3) src->dst affines; out: n x 6 dst->src
// coefficients.
extern "C" void affine_inverse_f32_host(const float* a23s, float* out,
                                        int n) {
  for (int i = 0; i < n; ++i)
    affine_inverse::invert(a23s + 6 * i, out + 6 * i);
}
