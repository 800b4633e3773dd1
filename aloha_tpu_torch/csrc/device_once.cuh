// Per-device launch set-up that a C entry does once per process, not on
// every call: a kernel's dynamic shared-memory size and the SM count.
// Host code only: including it changes no kernel's device code.
#pragma once

#include <cuda_runtime.h>

namespace {

// Device indices the C entries take: [0, MAX_DEVICES).
constexpr int MAX_DEVICES = 64;

// Sets `kernel`'s dynamic shared-memory size to `bytes` on `device` (the
// current device) at its first call there; `set` holds the kernel's flags,
// one static array a kernel (or template instance).
template <typename Kernel>
cudaError_t smem_once(Kernel kernel, int bytes, int device, bool (&set)[MAX_DEVICES]) {
  if (set[device]) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) set[device] = true;
  return err;
}

// The SM count of `device`, read at the first call there, into *n.
inline cudaError_t sm_count(int device, int* n) {
  static int sms[MAX_DEVICES];  // 0 until read
  if (!sms[device]) {
    int read = 0;
    const cudaError_t err = cudaDeviceGetAttribute(&read, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    sms[device] = read;
  }
  *n = sms[device];
  return cudaSuccess;
}

}  // namespace
