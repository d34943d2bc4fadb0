// Text of the status codes the port's C entry points return.
#include "common.cuh"

extern "C" const char* danet_error_string(int status) {
  switch (status) {
    case DANET_BAD_ARGUMENT:
      return "bad argument";
    case DANET_NOT_RESIDENT:
      return "cooperative grid does not fit: not every block can be "
             "resident at once";
    case DANET_SMEM_TOO_LARGE:
      return "shared memory per block exceeds the card's opt-in limit";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(status));
  }
}
