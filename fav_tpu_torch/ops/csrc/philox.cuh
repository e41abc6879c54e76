// Philox4x32-10 and the uniform map shared by the port's CUDA kernels.
//
// Stream layout (fav_tpu_torch/ops/random.py computes the same words in
// plain PyTorch): a 64-bit seed is the key (low word, high word); element e
// of a flat field takes draw d from word e % 4 of
// philox(counter = (g & 0xffffffff, g >> 32, d, 0)) with g = e / 4.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fav {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t lo0 = kPhiloxM0 * c.x;
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
    const uint32_t lo1 = kPhiloxM1 * c.z;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// The four words of group g (elements 4g .. 4g + 3) of draw `draw`.
__device__ __forceinline__ uint4 draw_words(long long group, uint32_t draw, uint32_t k0,
                                            uint32_t k1) {
  const unsigned long long g = static_cast<unsigned long long>(group);
  return philox4x32_10(make_uint4(static_cast<uint32_t>(g), static_cast<uint32_t>(g >> 32), draw, 0u),
                       k0, k1);
}

// Top 24 bits, offset by half a step: (0, 1] with 0 excluded, as
// corruptions_pallas.py:73-82 maps the TPU's bits.
__device__ __forceinline__ float bits_to_uniform(uint32_t bits) {
  return __fadd_rn(__fmul_rn(static_cast<float>(bits >> 8), 5.9604644775390625e-08f),
                   2.98023223876953125e-08f);
}

__device__ __forceinline__ uint32_t word(const uint4& w, int j) {
  return j == 0 ? w.x : (j == 1 ? w.y : (j == 2 ? w.z : w.w));
}

}  // namespace fav
