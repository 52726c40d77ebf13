// The body shared by the in-place SGD kernels (sgd.cu, masked_update.cu):
// how a leaf splits into a 16-byte aligned float4 body and scalar ends, and
// the grid that covers them.
//
// An update kernel touches every byte once, and a client leaf is many times
// the 50 MB L2, so it is bound by HBM.  Each thread of the body takes one
// float4 of every operand, and the grid has one block for every kThreads
// float4, with no grid stride: the block scheduler then walks the leaf in
// order.  Measured on an H100 inside the full-width TinyLlama-1.1B rounds
// (tools/update_variants.py, PERF.md), that cut the update group's time by
// 2-3% against the old two-wave grid stride; one wave of persistent
// blocks, more float4 in flight a thread, streaming cache hints and TMA
// bulk copies were no faster, or slower.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace float4_body {

constexpr int kThreads = 256;

// How a leaf of n elements splits: scalar elements [0, head), the float4
// body of n4 float4 from head, scalar elements [tail, n).
struct Split {
  long long head, n4, tail;
};

// The body starts where w reaches 16 bytes; it needs every operand to
// share w's misalignment (then each reaches 16 bytes at the same element).
// Otherwise the whole leaf is scalar.
inline Split split(long long n, const void* w, const void* a, const void* b) {
  const uintptr_t mis = reinterpret_cast<uintptr_t>(w) & 15;
  Split s{n, 0, n};
  if (mis % 4 != 0 || (reinterpret_cast<uintptr_t>(a) & 15) != mis ||
      (reinterpret_cast<uintptr_t>(b) & 15) != mis)
    return s;
  s.head = static_cast<long long>((16 - mis) & 15) / 4;
  if (s.head > n) s.head = n;
  s.n4 = (n - s.head) / 4;
  s.tail = s.head + 4 * s.n4;
  return s;
}

// A thread for every float4 of the body and for every element of the
// longer scalar end.
inline unsigned grid(long long n, const Split& s) {
  long long work = s.head > n - s.tail ? s.head : n - s.tail;
  if (s.n4 > work) work = s.n4;
  const long long blocks = (work + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

}  // namespace float4_body
