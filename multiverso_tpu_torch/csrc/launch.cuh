// What every C entry of the port's row kernels does around its launch.
#pragma once

#include <cuda_runtime.h>

// Makes `device` current for its scope when it is not already, and puts
// the caller's device back at its end. The wrapper passes the tensors'
// device ordinal instead of entering torch.cuda.device(...) on every call:
// in the usual case, the device already current, this costs one
// cudaGetDevice and no switch.
class DeviceScope {
 public:
  explicit DeviceScope(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      switched_ = err_ == cudaSuccess;
    }
  }
  ~DeviceScope() {
    if (switched_) cudaSetDevice(prev_);
  }
  DeviceScope(const DeviceScope&) = delete;
  DeviceScope& operator=(const DeviceScope&) = delete;
  int error() const { return (int)err_; }

 private:
  int prev_ = 0;
  cudaError_t err_ = cudaSuccess;
  bool switched_ = false;
};
