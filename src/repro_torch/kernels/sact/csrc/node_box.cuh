// Octree node box from its Morton code, as every traversal arm builds it
// (repro_torch/core/octree.py::node_centers_from_xyz):
//   centre = lo + (xyz + 0.5) * cell,  half = cell * 0.5
// with xyz the cell coordinates decoded from the code's interleaved bits.
// Build with --fmad=false so the centre rounds twice, as in PyTorch.
#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t compact1by2(uint32_t x) {
  x &= 0x09249249u;
  x = (x | (x >> 2)) & 0x030C30C3u;
  x = (x | (x >> 4)) & 0x0300F00Fu;
  x = (x | (x >> 8)) & 0x030000FFu;
  x = (x | (x >> 16)) & 0x000003FFu;
  return x;
}

__device__ __forceinline__ void node_centre(uint32_t code, float lo0,
                                            float lo1, float lo2, float cell,
                                            float c[3]) {
  c[0] = lo0 + ((float)compact1by2(code) + 0.5f) * cell;
  c[1] = lo1 + ((float)compact1by2(code >> 1) + 0.5f) * cell;
  c[2] = lo2 + ((float)compact1by2(code >> 2) + 0.5f) * cell;
}
