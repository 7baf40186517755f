"""Video Depth Anything's forward and long-video inference in plain fp32
PyTorch, for the port's CPU tests.

It is the benchmark's reference, portbench/reference/vda.py, imported from
there so that the CPU tests and the benchmark's `correct` hold the port to
one reference: written from upstream's modules in upstream's parameter
names, importing nothing of l4p_tpu or l4p_tpu_torch and running no kernel,
attention in query blocks and position chunks. Its docstring lists every
departure from upstream. Importing this module turns TF32 off for matmuls
and convolutions.
"""

from portbench.reference.vda import (  # noqa: F401
    INFER_LEN,
    KEYFRAMES,
    OVERLAP,
    DinoVisionTransformer,
    TemporalModule,
    VideoDepthAnything,
    align,
    attention,
    compute_scale_and_shift,
    plain_fp32,
    read_config,
)

plain_fp32()
