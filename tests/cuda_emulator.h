// A CPU emulator of the CUDA features `lio_slam_tpu_torch/ops/csrc/
// fused_corr.cu` uses, for the tests (tests/torch_port_cuda_emulator.py
// compiles the kernel's own source against it with g++): one std::thread a
// CUDA thread, a block at a time; __syncthreads, __syncwarp and the
// shuffles are barriers over the threads their mask names (a group of 8
// lanes or the whole warp); shared memory is static storage; cp.async is a
// plain copy.  It runs the kernel's control flow and arithmetic, not its
// timing, and finds no race that the barriers hide.
#pragma once
#include <math.h>

#include <atomic>
#include <barrier>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __align__(x)
#define __restrict__
#define __shared__ static

struct emu_dim3 { unsigned x = 0, y = 0, z = 0; };
thread_local emu_dim3 threadIdx;
static emu_dim3 blockDim, blockIdx, gridDim;

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
typedef void* cudaStream_t;

static float* emu_dynamic_smem = nullptr;
static std::barrier<>* emu_block_barrier = nullptr;
static std::barrier<>* emu_warp_barrier[32][5];   // 4 groups of 8, the warp
static uint64_t emu_slots[32][32];

static inline std::barrier<>* emu_barrier_for(unsigned mask) {
  const int w = threadIdx.x >> 5;
  if (mask == 0xffffffffu) return emu_warp_barrier[w][4];
  return emu_warp_barrier[w][__builtin_ctz(mask) / 8];
}

template <class T>
static T emu_shuffle(unsigned mask, T v, int src) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint64_t u = 0;
  memcpy(&u, &v, sizeof(T));
  emu_slots[w][lane] = u;
  emu_barrier_for(mask)->arrive_and_wait();
  const uint64_t r = emu_slots[w][src & 31];
  emu_barrier_for(mask)->arrive_and_wait();
  T out;
  memcpy(&out, &r, sizeof(T));
  return out;
}

template <class T> T __shfl_sync(unsigned m, T v, int src) {
  return emu_shuffle(m, v, src);
}
template <class T> T __shfl_xor_sync(unsigned m, T v, int off) {
  return emu_shuffle(m, v, (int)(threadIdx.x & 31) ^ off);
}
template <class T> T __shfl_down_sync(unsigned m, T v, int off) {
  const int lane = threadIdx.x & 31;
  return emu_shuffle(m, v, lane + off < 32 ? lane + off : lane);
}
inline void __syncwarp(unsigned m = 0xffffffffu) {
  emu_barrier_for(m)->arrive_and_wait();
}
inline void __syncthreads() { emu_block_barrier->arrive_and_wait(); }
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline unsigned __float_as_uint(float f) { unsigned u; memcpy(&u, &f, 4); return u; }
inline float __uint_as_float(unsigned u) { float f; memcpy(&f, &u, 4); return f; }
inline float __ldcg(const float* p) { return *(volatile const float*)p; }
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned long long min(unsigned long long a, unsigned long long b) {
  return a < b ? a : b;
}
inline void emu_copy(float* dst, const float* src, int n) { memcpy(dst, src, 4 * n); }

// kernel<<<blocks, threads, smem>>>(args...), the blocks one after another
template <class K, class... A>
void emu_launch(K kernel, int blocks, int threads, size_t smem, A... args) {
  std::vector<float> shared(smem / 4 + 4);
  emu_dynamic_smem = shared.data();
  gridDim.x = blocks;
  blockDim.x = threads;
  for (int b = 0; b < blocks; ++b) {
    blockIdx.x = b;
    std::barrier<> block(threads);
    emu_block_barrier = &block;
    std::vector<std::barrier<>*> owned;
    for (int w = 0; w < threads / 32; ++w) {
      for (int g = 0; g < 4; ++g)
        owned.push_back(emu_warp_barrier[w][g] = new std::barrier<>(8));
      owned.push_back(emu_warp_barrier[w][4] = new std::barrier<>(32));
    }
    std::vector<std::thread> team;
    for (int t = 0; t < threads; ++t)
      team.emplace_back([&, t] { threadIdx.x = t; kernel(args...); });
    for (auto& th : team) th.join();
    for (auto* p : owned) delete p;
  }
}
