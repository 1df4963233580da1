// The per-device caches of the kernels' launch set-up (a kernel attribute
// set once, an occupancy queried once), shared by the sources here: each
// cache holds one entry per device ordinal below MAX_DEVICES.

#pragma once

#include <cuda_runtime.h>

constexpr int MAX_DEVICES = 64;

// The current device's ordinal in *dev; 0, or the CUDA error code when it
// cannot be read or lies outside the caches' range.
inline int current_device(int* dev) {
  const cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  return *dev < MAX_DEVICES ? 0 : (int)cudaErrorInvalidDevice;
}
