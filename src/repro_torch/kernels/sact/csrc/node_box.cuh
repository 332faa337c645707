// Octree node box from its cell coordinates, as every traversal arm builds
// it (repro_torch/core/octree.py::node_centers_from_xyz):
//   centre = lo + (xyz + 0.5) * cell,  half = cell * 0.5
// with xyz the integer cell coordinates at the node's level: decoded from
// the interleaved bits of a Morton code, or read from a packed row
// (decode_row; repro_torch/kernels/persist/ref.py::decode_meta_rows).
// Every route yields the same integers and then the same two fp32
// roundings.  Build with --fmad=false so the centre rounds twice, as in
// PyTorch.
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

__device__ __forceinline__ void node_centre_xyz(const uint32_t xyz[3],
                                                float lo0, float lo1,
                                                float lo2, float cell,
                                                float c[3]) {
  c[0] = lo0 + ((float)xyz[0] + 0.5f) * cell;
  c[1] = lo1 + ((float)xyz[1] + 0.5f) * cell;
  c[2] = lo2 + ((float)xyz[2] + 0.5f) * cell;
}

__device__ __forceinline__ void morton_xyz(uint32_t code, uint32_t xyz[3]) {
  xyz[0] = compact1by2(code);
  xyz[1] = compact1by2(code >> 1);
  xyz[2] = compact1by2(code >> 2);
}

__device__ __forceinline__ void node_centre(uint32_t code, float lo0,
                                            float lo1, float lo2, float cell,
                                            float c[3]) {
  uint32_t xyz[3];
  morton_xyz(code, xyz);
  node_centre_xyz(xyz, lo0, lo1, lo2, cell, c);
}

// ---- packed node-metadata rows (repro_torch/core/quantize.py) ------------
// fp32: 4 words [code, full, child_start, child_mask]; bf16: 2 words, the
// topology word full << 31 | child_start << 8 | mask and the geometry
// word of three 10-bit leaf-grid coordinates; u8: 1 word, full << 31 |
// octant << 28 | child_start << 8 | mask, the node's code rebuilt from its
// parent's.  The topology word's right shifts sign-extend when full is set,
// so every field is masked.

constexpr int kGridBits = 10;        // quantize.GRID_BITS
constexpr int kBf16StartBits = 23;   // quantize.BF16_START_BITS
constexpr int kU8StartBits = 20;     // quantize.U8_START_BITS

struct NodeRow {
  uint32_t xyz[3];   // cell coordinates at the row's level
  bool full;
  int child_start;
  int child_mask;
  int code;          // u8: the node's own code, its children's parent code
};

__device__ __forceinline__ NodeRow decode_row(int4 row, int, int) {
  NodeRow n;
  morton_xyz((uint32_t)row.x, n.xyz);
  n.full = row.y != 0;
  n.child_start = row.z;
  n.child_mask = row.w;
  n.code = 0;
  return n;
}

__device__ __forceinline__ NodeRow decode_row(int2 row, int level, int) {
  NodeRow n;
  const int shift = kGridBits - level;
  n.xyz[0] = (uint32_t)(((row.y >> 20) & 0x3FF) >> shift);
  n.xyz[1] = (uint32_t)(((row.y >> 10) & 0x3FF) >> shift);
  n.xyz[2] = (uint32_t)((row.y & 0x3FF) >> shift);
  n.full = row.x < 0;
  n.child_start = (row.x >> 8) & ((1 << kBf16StartBits) - 1);
  n.child_mask = row.x & 0xFF;
  n.code = 0;
  return n;
}

__device__ __forceinline__ NodeRow decode_row(int row, int, int pcode) {
  NodeRow n;
  n.code = (pcode << 3) | ((row >> 28) & 7);
  morton_xyz((uint32_t)n.code, n.xyz);
  n.full = row < 0;
  n.child_start = (row >> 8) & ((1 << kU8StartBits) - 1);
  n.child_mask = row & 0xFF;
  return n;
}
