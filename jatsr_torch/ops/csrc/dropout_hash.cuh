// The counter-hash dropout of the JAX package (lowbias32), shared by B10's
// kernels: attention_rows.cuh's train epilogue, attention_train.cu's and
// attention_wide.cu's backward, and the fp32 mode (attention_f32.cu's
// forward, attention_f32_bwd.cu).  keep = h32(stream ^ (row * np + col))
// <= thr, stream = h32(b * 0x9E3779B9 + h + seed * 0x85EBCA6B), all uint32
// with wrap-around; np = round_up(N, 8), the JAX wrapper's padded lattice.
// b is the row of the global batch: a launch's own batch index plus its
// args' b0, the first row of the batch it holds (a data-parallel rank's
// span); h is the global q head: the launch's own q head plus its args'
// h0, the first head it holds (a tensor-parallel rank's heads, whose kv
// heads stay local: local q head j reads local kv head j / G).  So every
// rank draws the mask one launch over the whole batch and all heads would
// draw.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// The (batch, head) stream with its half of the score hash's first
// xor-shift applied: (s ^ i) >> 16 = (s >> 16) ^ (i >> 16), so kept() does
// one shift and one three-way xor for it.
__device__ __forceinline__ uint32_t stream_of(int b, int h, uint32_t seed) {
  const uint32_t s = hash_u32((uint32_t)b * 0x9E3779B9u + (uint32_t)h + seed * 0x85EBCA6Bu);
  return s ^ (s >> 16);
}

// keep = h32(stream ^ (row * np + col)) <= thr, `stream` from stream_of().
__device__ __forceinline__ bool kept(uint32_t stream, int row, int col, int np, uint32_t thr) {
  const uint32_t i = (uint32_t)(row * np + col);
  uint32_t x = stream ^ i ^ (i >> 16);
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x <= thr;
}
