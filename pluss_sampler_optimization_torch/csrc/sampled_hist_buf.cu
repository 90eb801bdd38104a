// Kernel B1's buffer form, built as a library of its own: the descriptor
// in a device buffer, staged in each block's shared memory (see
// sampled_hist.cu, which this file compiles with
// SAMPLED_HIST_BUFFER_FORM defined: its 6 instantiations
// sampled_hist_kernel_buf<LV, TRI> and sampled_hist_launch_buf, and none
// of the parameter form's). Two sources let nvcc build both forms at once.
#define SAMPLED_HIST_BUFFER_FORM
#include "sampled_hist.cu"
