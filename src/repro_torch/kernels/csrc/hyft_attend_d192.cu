// The split-K and paged Hyft attention kernels (hyft_attend.cuh) at head
// width 192: decode and verify, over every split and page size and K/V
// type.  One source per width, so that nvcc builds the widths in parallel.

#include "hyft_attend.cuh"

HYFT_ATTEND_WIDTH(192)
