"""Target-hardware constants: one NVIDIA H100 SXM5 80GB (twin of
``repro/roofline/constants.py``, whose figures are the TPU v5e's).

The rates are NVIDIA's H100 SXM5 data sheet's, dense (no sparsity), at
the part's full power limit of 700 W; a card set below it runs slower
under load, so a number measured against them names the card's limit.
"""

# dense bf16 (and fp16) tensor-core peak, operations/s (data sheet)
BF16_OPS_PS = 989e12
# float32 outside the tensor cores, operations/s (data sheet)
OPS_PS = 67e12
# HBM3 bandwidth, bytes/s (data sheet)
MEM_BPS = 3.35e12
# NVLink 4: 900 GB/s in both directions together, 450e9 bytes/s each way
# (data sheet); in the place of the reference's ICI_BW_PER_LINK
LINK_BPS = 450e9
# device memory in bytes: torch.cuda.get_device_properties(0).total_memory
# on "NVIDIA H100 80GB HBM3, 700.00 W" (nvidia-smi name, power.limit)
HBM_BYTES = 85017493504

# bytes an element, by XLA's dtype names and torch's
BYTES = {"pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2,
         "f16": 2, "f32": 4, "s32": 4, "u32": 4, "f64": 8, "s64": 8,
         "u64": 8, "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
         "bool": 1, "int8": 1, "uint8": 1, "int16": 2, "uint16": 2,
         "bfloat16": 2, "float16": 2, "float32": 4, "int32": 4,
         "uint32": 4, "float64": 8, "int64": 8, "uint64": 8,
         "complex64": 8, "complex128": 16, "float8_e4m3fn": 1,
         "float8_e5m2": 1}
