"""VGGT's forward in plain fp32 PyTorch, for the port's CPU tests.

It is the benchmark's reference, portbench/reference/vggt.py, imported from
there so that the CPU tests and the benchmark's `correct` hold the port to
one reference: written from upstream's modules in upstream's parameter
names, importing nothing of l4p_tpu or l4p_tpu_torch and running no kernel,
attention in query blocks. Its docstring lists every departure from
upstream. Importing this module turns TF32 off for matmuls and
convolutions.
"""

from portbench.reference.vggt import (  # noqa: F401
    QUERY_BLOCK,
    VGGT,
    RotaryPositionEmbedding2D,
    attention,
    plain_fp32,
    pose_encoding_to_extri_intri,
    read_config,
)

plain_fp32()
