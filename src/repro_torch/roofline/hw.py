"""NVIDIA H100 SXM constants: the card the port runs on.

The PyTorch counterpart of ``repro.roofline.hw``, which holds the TPU v5e's.
Every figure is a published dense peak from NVIDIA's H100 data sheet (SXM
part, no sparsity), at the card's full 700 W power limit; a card set below
it runs slower under load, so a roofline share is stated beside the card's
name and power limit.
"""

# HBM3 bandwidth of one card, bytes/s (80 GB at 3.35 TB/s)
HBM_BW = 3.35e12
# HBM3 capacity of one card, bytes: the dry-run's fits check
HBM_BYTES = 80e9
# tensor cores, bf16 and fp16 operands with fp32 accumulation, FLOP/s
PEAK_FLOPS_BF16 = 989e12
# fp32 outside the tensor cores (the CUDA cores' FMAs, two FLOPs each),
# FLOP/s; fp32 products run here too, since TF32 is off in the port
PEAK_FLOPS_FP32 = 67e12
# instruction rates: one instruction a lane a clock over all lanes (the
# fp32 peak over its two FLOPs of an FMA); 32-bit integer operations run
# on half the lanes.  The Hyft softmax kernels' bound counts its
# datapath's operations at these rates
LANE_INSTR_PER_S = PEAK_FLOPS_FP32 / 2
INT_INSTR_PER_S = LANE_INSTR_PER_S / 2
# NVLink 4 between two cards of one host, bytes/s per direction: the
# collective term's rate (one card moves no collective bytes)
NVLINK_BW = 450e9
