// hopper.cuh for tools/cpu_rehearsal.py: the shared-memory opt-in and
// ex2.approx (as exp2f).
#pragma once
#include <atomic>
#include "cuda_runtime.h"
namespace ptt {
template <class K> inline cudaError_t allow_smem(K, int, std::atomic<uint64_t>&) { return 0; }
namespace sm90 {
inline float ex2_approx(float x) { return exp2f(x); }
}
}
