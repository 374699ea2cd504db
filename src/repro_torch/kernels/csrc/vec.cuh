// 16-byte vector access to rows of fp32 or bf16 elements, shared by the
// row kernels (csrc/rmsnorm.cu, csrc/rmsnorm_bwd.cu): a vector is a uint4
// of V = 16 / sizeof(T) elements, loaded in one access where the row is
// 16-byte aligned and the vector lies inside it, else element by element
// into the same bits.
#pragma once

#include "common.cuh"

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Raw element bits, so that a 16-byte vector and its element loads fill
// the same uint4.
template <typename T> struct Bits;
template <> struct Bits<float> { using type = uint32_t; };
template <> struct Bits<__nv_bfloat16> { using type = uint16_t; };

__device__ __forceinline__ uint32_t word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

// Element j of a vector, as fp32.
template <typename T> __device__ __forceinline__ float elem(const uint4& u, int j);
template <> __device__ __forceinline__ float elem<float>(const uint4& u, int j) {
  return __uint_as_float(word(u, j));
}
template <> __device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& u, int j) {
  return __uint_as_float(j % 2 ? word(u, j / 2) & 0xffff0000u : word(u, j / 2) << 16);
}

// Element j of a 16-byte vector of V elements: word j * 4 / V of the uint4,
// from bit (128 / V) * (j % (V / 4)).
template <int V> __device__ __forceinline__ int word_of(int j) { return j * 4 / V; }
template <int V> __device__ __forceinline__ int shift_of(int j) { return 128 / V * (j % (V / 4)); }

// Element j's bits when stored as T (bf16: round to nearest even).
template <typename T> __device__ __forceinline__ uint32_t bits(float v);
template <> __device__ __forceinline__ uint32_t bits<float>(float v) { return __float_as_uint(v); }
template <> __device__ __forceinline__ uint32_t bits<__nv_bfloat16>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// The vector of p's elements [c, c + V): one 16-byte load when `vec` (p
// 16-byte aligned) and the vector lies inside d, else element loads, zero
// past d.
template <typename T>
__device__ __forceinline__ uint4 load_vec(const T* __restrict__ p, int c, int d, bool vec) {
  constexpr int V = 16 / sizeof(T);
  if (vec && c + V <= d) return __ldg(reinterpret_cast<const uint4*>(p + c));
  using B = typename Bits<T>::type;
  const B* q = reinterpret_cast<const B*>(p);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const uint32_t b = c + j < d ? (uint32_t)q[c + j] : 0u;
    w[word_of<V>(j)] |= b << shift_of<V>(j);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// p's elements [c, c + V) = cast(v[j]): one 16-byte store when `vec` and the
// vector lies inside d, else element stores, none past d.
template <typename T>
__device__ __forceinline__ void store_floats(T* __restrict__ p, int c, int d, bool vec,
                                             const float (&v)[16 / sizeof(T)]) {
  constexpr int V = 16 / sizeof(T);
  using B = typename Bits<T>::type;
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < V; ++j) w[word_of<V>(j)] |= bits<T>(v[j]) << shift_of<V>(j);
  if (vec && c + V <= d) {
    *reinterpret_cast<uint4*>(p + c) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
  B* q = reinterpret_cast<B*>(p);
#pragma unroll
  for (int j = 0; j < V; ++j)
    if (c + j < d) q[c + j] = (B)(w[word_of<V>(j)] >> shift_of<V>(j));
}

static __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}
