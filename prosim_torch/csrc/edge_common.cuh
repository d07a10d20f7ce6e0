// Helpers shared by csrc/edge_attn.cu (the edge core) and
// csrc/fused_stack.cu (the fused policy stack), and by the bf16 edge engine
// csrc/edge_mma.cuh: the cp.async wrappers that stage a tile, and the two
// storage types of the kernels' tables, float (the f32 paths' CUDA-core
// tile engine) and __nv_bfloat16 (the bf16 paths), with their conversions
// to the f32 of every sum. Each .cu file includes this header; it is not a
// kernel of its own.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits until at most N of this thread's newest copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// One f32 value from global to shared memory, where a row is not copied by
// 16-byte copies.
__device__ __forceinline__ void copy_value(float* dst, const float* src) { cp_async4(dst, src); }

// f32 values of a storage type, and the storage value of an f32 (rounded
// to nearest even)
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }
// v rounded through T (the identity for float)
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

// 4 staged f32 values
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
