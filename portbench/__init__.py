"""The benchmark of the PyTorch/CUDA port (`l4p_tpu_torch`) on NVIDIA cards.

    python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

runs one cell of `BENCHMARK.json` once and prints one JSON line. Each cell
names a configuration (`configs/<name>.json`) and a traffic mix
(`traffic/<name>.json`, whose `driver` names the module under `drivers/`
that serves it); each per-layer metric is read by `layers/<family>.py`,
the family being the metric's name up to its first dot. The yardstick
(the work counts and peaks under `work/`, the plain fp32 reference under
`reference/` and the limits under `limits/`) lives here, apart from the
program it measures.
"""
