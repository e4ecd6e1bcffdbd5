// Tile helpers shared by the tensor-core kernels (sm_90a): asynchronous
// 16-byte copies into shared memory, the fence between those copies (or
// plain stores) and the tensor cores' reads, `ldmatrix`, and the
// shared-memory matrix descriptor of `wgmma` for 128-byte-swizzled tiles.
//
// A swizzled tile is rows of 128 bytes (64 bf16), row r at r * 128, its
// 16-byte chunk c stored at chunk (c ^ (r & 7)); tiles start on 1024-byte
// boundaries.  The same bytes serve two operand forms, told apart by the
// descriptor and the instruction's transpose bit:
//   K-major  (`desc_k`, bit clear): rows are the M (or N) index, the 64
//     contiguous values the k index; 16 k further is 32 bytes further;
//   MN-major (`desc_mn`, bit set): rows are the k index, the 64 contiguous
//     values the M (or N) index; 16 k further is 16 rows, 2048 bytes.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int kAlign = 1024;  // swizzle atoms are 1024-byte aligned

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (src is not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}
// orders this thread's view of shared memory before the tensor cores' reads
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// shared-memory matrix descriptor, 128-byte swizzle; offsets in bytes
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t leading, uint32_t stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(leading >> 4) << 16) |
         (static_cast<uint64_t>(stride >> 4) << 32) | (1ull << 62);
}

// K-major tile: 8-row groups 1024 bytes apart (the leading offset is not used)
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) { return make_desc(addr, 16, 1024); }
// MN-major tile: the next 64 columns 8192 bytes on, the next 8 k 1024 bytes on
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) { return make_desc(addr, 8192, 1024); }
constexpr int kDescK16 = 32 >> 4;      // descriptor step of 16 k in a K-major tile
constexpr int kDescMnK16 = 2048 >> 4;  // and in an MN-major tile

// byte offset of 16-byte chunk c of row r in a swizzled tile
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  const uint32_t addr = smem_u32(raw);
  return raw + (((addr + kAlign - 1) & ~static_cast<uint32_t>(kAlign - 1)) - addr);
}

}  // namespace hopper
