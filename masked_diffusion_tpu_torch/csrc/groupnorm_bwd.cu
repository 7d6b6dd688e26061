// The fp32 GroupNorm backward kernels of groupnorm.cu (which has the design),
// in a translation unit of their own so that nvcc compiles the dtypes and the
// directions in parallel: groupnorm.cu's C entry points call mdt_gn_bwd_f32.
#define MDT_GN_ONE_DTYPE
#include "groupnorm.cu"

MDT_GN_BWD_ENTRIES(float, f32)
