// Bounds checks of computed indices for a diagnostic build.  Built with
// -DUNIRENDER_INDEX_CHECK (ops/_build.py INDEX_CHECK, chip_sanitize.py's
// `checked` mode), UR_CHECK_INDEX(i, n, what) traps the kernel when i is
// outside [0, n), after printing the index, the extent and the block and
// thread.  Without the define it is nothing: the build the package loads
// carries no check.

#pragma once

#ifdef UNIRENDER_INDEX_CHECK
#include <stdio.h>
#define UR_CHECK_INDEX(idx, extent, what)                                   \
  do {                                                                      \
    const long long ur_i_ = (long long)(idx);                               \
    const long long ur_n_ = (long long)(extent);                            \
    if (ur_i_ < 0 || ur_i_ >= ur_n_) {                                      \
      printf("index check: %s %lld outside [0, %lld), block (%d, %d) "      \
             "thread %d\n", (what), ur_i_, ur_n_, (int)blockIdx.x,          \
             (int)blockIdx.y, (int)threadIdx.x);                            \
      __trap();                                                             \
    }                                                                       \
  } while (0)
#else
#define UR_CHECK_INDEX(idx, extent, what) ((void)0)
#endif
