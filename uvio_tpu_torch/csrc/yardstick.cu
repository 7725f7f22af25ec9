// An empty kernel: what any launch of a given grid costs on the card.
// `chip_smoke.py` times it beside the real kernels as a yardstick; the
// package itself never calls it.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// Launches an empty kernel of grid (grid_x, grid_y) x `threads` on
// `stream` and returns cudaGetLastError().
extern "C" int uvio_empty_launch(int grid_x, int grid_y, int threads, cudaStream_t stream) {
  empty_kernel<<<dim3(grid_x, grid_y), threads, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}
