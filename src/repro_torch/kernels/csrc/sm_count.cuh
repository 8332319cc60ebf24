// The number of SMs of the current device, asked once per device (the
// kernels size their grids by it); 132, the H100's count, if the runtime
// cannot say.
#pragma once
#include <cuda_runtime.h>

static inline int sm_count() {
  static int sms[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    sms[dev] = 132;
  return sms[dev];
}
