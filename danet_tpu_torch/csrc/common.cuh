// Shared by the port's kernels: status codes of the C entry points.
//
// Every entry point returns 0 on success, a cudaError_t value when the
// runtime refused or failed the launch (cudaGetLastError right after it),
// or one of the negative codes below for a request the kernel does not
// take.  danet_error_string() turns any of them into text.
#pragma once

#include <cuda_runtime.h>

enum DanetStatus : int {
  DANET_BAD_ARGUMENT = -1,
  DANET_NOT_RESIDENT = -2,   // cooperative grid does not fit on the card
  DANET_SMEM_TOO_LARGE = -3, // a block needs more shared memory than exists
};
