// The fp16 GroupNorm forward kernels of groupnorm.cu (which has the design), in
// a translation unit of their own so that nvcc compiles the dtypes and the
// directions in parallel: groupnorm.cu's C entry points call mdt_gn_*_f16.
#define MDT_GN_ONE_DTYPE
#include "groupnorm.cu"

MDT_GN_FWD_ENTRIES(__half, f16)
