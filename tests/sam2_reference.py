"""SAM 2.1's video propagation in plain fp32 PyTorch, for the port's CPU
tests.

It is the benchmark's reference, portbench/reference/sam2.py, imported from
there so that the CPU tests and the benchmark's `correct` hold the port to
one reference: written from upstream's modules in upstream's parameter
names and sequence-first layouts, importing nothing of l4p_tpu or
l4p_tpu_torch and running no kernel, attention in blocks of keys. Its
docstring lists every departure from upstream. Importing this module turns
TF32 off for matmuls and convolutions.
"""

from portbench.reference.sam2 import (  # noqa: F401
    NO_OBJ_SCORE,
    MemoryAttention,
    MultiScaleBlock,
    RoPEAttention,
    SAM2Base,
    apply_rotary_enc,
    attention,
    compute_axial_cis,
    memory_selection,
    plain_fp32,
    read_config,
)

plain_fp32()
