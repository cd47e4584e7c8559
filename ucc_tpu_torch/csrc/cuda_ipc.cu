// CUDA IPC of device buffers between the processes of one host, for the
// device TLs' teams that span processes (ucc_tpu_torch/kernels/cuda_ipc.py,
// ucc_tpu_torch/tl/device_sync.py).
//
// Replaces no TPU kernel: on the TPU a team that spans processes runs one
// program over the global array of every process's shards (the JAX
// package's tl/xla rendezvous), and the runtime moves the bytes. Here each
// process must reach its peers' buffers itself, and CUDA IPC is how a
// process of one host maps another's device allocation: no data moves
// through this file, it only exports, opens and closes mappings.
//
// PyTorch's caching allocator hands out pieces of larger cudaMalloc
// allocations, and an IPC handle names a whole allocation. So a buffer is
// exported as (the handle of its allocation's base, its offset, its bytes):
// ucc_cuda_ipc_range finds the base and size with cuMemGetAddressRange,
// reached through the runtime's driver entry point (no link against
// libcuda). An allocation made by the expandable-segments allocator
// (cuMemCreate/cuMemMap) has no IPC handle; cudaIpcGetMemHandle refuses it
// and the caller raises.
//
// Every function takes the device ordinal, sets it current, and returns a
// cudaError_t as int (0 on success); ucc_cuda_ipc_error_string names one.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

// CUresult cuMemGetAddressRange(CUdeviceptr* base, size_t* size,
//                               CUdeviceptr ptr), the _v2 ABI
typedef int (*AddressRange)(unsigned long long*, size_t*,
                            unsigned long long);

AddressRange address_range() {
  static AddressRange fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuMemGetAddressRange", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuMemGetAddressRange", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<AddressRange>(p);
  }
  return fn;
}

}  // namespace

extern "C" {

// The allocation that holds `ptr`: its base and its size in bytes.
int ucc_cuda_ipc_range(int dev, void* ptr, void** base, size_t* size) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  AddressRange fn = address_range();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  unsigned long long b = 0;
  if (fn(&b, size, reinterpret_cast<unsigned long long>(ptr)) != 0)
    return (int)cudaErrorInvalidDevicePointer;
  *base = reinterpret_cast<void*>(b);
  return 0;
}

// The IPC handle (CUDA_IPC_HANDLE_SIZE = 64 bytes, into `out`) of the
// allocation whose base is `base`.
int ucc_cuda_ipc_get(int dev, void* base, void* out) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  cudaIpcMemHandle_t h;
  e = cudaIpcGetMemHandle(&h, base);
  if (e != cudaSuccess) return (int)e;
  memcpy(out, &h, sizeof(h));
  return 0;
}

// Map another process's allocation named by the 64-byte `handle`; `*ptr`
// is its base in this process. Peer access is enabled on demand (one card:
// the mapping is of the same device's memory).
int ucc_cuda_ipc_open(int dev, const void* handle, void** ptr) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return (int)cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

int ucc_cuda_ipc_close(int dev, void* ptr) {
  cudaError_t e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaIpcCloseMemHandle(ptr);
}

int ucc_cuda_ipc_handle_size() { return (int)sizeof(cudaIpcMemHandle_t); }

const char* ucc_cuda_ipc_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

}  // extern "C"
