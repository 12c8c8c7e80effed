// Helpers of the warp-specialised fused kernels (ops/fused.py, a plan cut
// into pipeline stages by ops/partition.py; K10's backward too): the
// asynchronous lane copies into shared memory and the barrier between chunk
// steps.
//
// On the card a stage warp prefetches the next chunk of the lanes it reads
// with cp.async (4 bytes a thread, 128 contiguous bytes a warp) while it
// computes this chunk, and waits for them with cp.async.wait_group before
// the chunk after.  Each thread reads back only what it copied itself, so
// the wait alone orders the copy before the read.  On the host (the g++
// build of the tests) the copy is a plain store and the waits are empty.

#pragma once

#ifdef __CUDACC__
#define SRK_PIPE_HD __host__ __device__ __forceinline__
#else
#define SRK_PIPE_HD inline
#endif

// one float of a lane, device memory -> shared memory, asynchronously
SRK_PIPE_HD void srk_cp_async4(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
#else
  memcpy(dst, src, 4);  // a word of either type (K10's scratch holds ints)
#endif
}

// four floats, 16-byte aligned at both ends, asynchronously (through L2)
SRK_PIPE_HD void srk_cp_async16(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
#else
  memcpy(dst, src, 16);
#endif
}

// an int32 word that a copy above put into the float buffer
SRK_PIPE_HD int srk_ld_word(const float* p) {
  int i;
  memcpy(&i, p, 4);
  return i;
}

// close this thread's group of copies (an empty group is allowed)
SRK_PIPE_HD void srk_cp_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// wait until at most one group (the newest) of this thread's copies is
// still in flight
SRK_PIPE_HD void srk_cp_wait1() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
#endif
}

#ifdef __CUDACC__
// the end of a chunk step: every stage warp of the CTA (named barrier 1,
// `threads` threads), after its own lanes reconverge.  It orders each
// warp's shared-memory wire writes before the reads of the next steps.
__device__ __forceinline__ void srk_step_barrier(int threads) {
#ifdef __CUDA_ARCH__
  __syncwarp();
  asm volatile("bar.sync 1, %0;\n" :: "r"(threads) : "memory");
#endif
}
#endif
