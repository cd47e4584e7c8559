// The part instances of gen_fold.cu (PART true): a launch of one part
// [lo, hi) of a generated collective's elements, as each process of a
// team that spans processes makes it (tl/device_sync.py). A library of
// its own, so that nvcc builds these instances in parallel with
// gen_fold.cu's whole-walk ones; the kernels and the C entry points are
// gen_fold.cu's (kernels/gen_device.py: _FOLD_PART).

#define GEN_FOLD_PART true
#include "gen_fold.cu"
