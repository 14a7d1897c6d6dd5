// K7 in float32: field_bwd.cu's entry compiled for the float activation
// dtype, a source of its own so that it builds beside the bfloat16 one.
#define NW_FIELD_BWD_F32
#include "field_bwd.cu"
