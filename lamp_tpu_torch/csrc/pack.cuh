// V values of a row as they lie in memory, for the row kernels
// (fused_layernorm.cu, quantize_int8.cu): 16 bytes for V > 1 (8 bf16 or 4
// f32: one load), one value for V = 1, held in 32-bit registers and turned
// into floats where used.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

template <typename T, int V>
struct Pack {
  static constexpr int kRegs = V > 1 ? 4 : 1;
  uint32_t r[kRegs];
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (V > 1) {
      const uint4 a = *reinterpret_cast<const uint4*>(p);
      r[0] = a.x, r[1] = a.y, r[2] = a.z, r[3] = a.w;
    } else if constexpr (sizeof(T) == 4) {
      r[0] = __float_as_uint(*reinterpret_cast<const float*>(p));
    } else {
      r[0] = *reinterpret_cast<const unsigned short*>(p);
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kRegs; ++i) r[i] = 0u;
  }
  __device__ __forceinline__ float operator[](int e) const {  // e a constant after unrolling
    if constexpr (sizeof(T) == 4) return __uint_as_float(r[e]);
    const uint32_t w = r[e / 2];
    return __uint_as_float(e % 2 ? w & 0xFFFF0000u : w << 16);
  }
};
