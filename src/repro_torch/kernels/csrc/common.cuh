// Launch helpers shared by the port's CUDA sources.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kThreads = 256;

// The SM count of the device current at the first call, queried once per
// library (every card of one host is the same model).
inline int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return sms;
}

// Blocks for a grid-stride loop over `items` work items: one thread per
// item, capped at 16 blocks per SM (each thread then loops).
inline int grid_for(int64_t items) {
  const int64_t want = (items + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sm_count()) * 16;
  return static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
}

inline bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace repro_torch
