// Per-device state of the kernels: the number of SMs of the current
// device, asked once per device (the kernels size their grids by it;
// 132, the H100's count, if the runtime cannot say), and the dynamic
// shared memory opt-in, made once per device (the attribute belongs to
// the current device, so one flag a process would leave every other
// card without it).
#pragma once
#include <cuda_runtime.h>

#define KERNEL_MAX_DEVICES 64

static inline int sm_count() {
  static int sms[KERNEL_MAX_DEVICES] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 ||
      dev >= KERNEL_MAX_DEVICES)
    return 132;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    sms[dev] = 132;
  return sms[dev];
}

// Raise ``kernel``'s dynamic shared memory cap to ``bytes`` on the
// current device unless ``done`` (one entry a device, kept by the
// caller for this kernel) says it was raised there already.
template <typename Kernel>
static inline cudaError_t opt_in_smem(bool* done, Kernel kernel, int bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool kept = dev >= 0 && dev < KERNEL_MAX_DEVICES;
  if (kept && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && kept) done[dev] = true;
  return e;
}
