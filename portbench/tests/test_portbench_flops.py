"""The frozen FLOP counts against the records and the program's own."""

import pytest

from portbench.reference.l4p.config import load_model_config
from portbench.tests.tiny import REPO
from portbench.work import flops


def test_alltask_counts_match_the_record():
    cfg, tasks = load_model_config(str(REPO / "configs" / "model.yaml"))
    assert flops.alltask_video_flops(cfg, tasks, 192, 128)["total"] / 1e12 == pytest.approx(416.81, abs=0.005)
    assert flops.alltask_video_flops(cfg, tasks, 48, 64)["total"] / 1e12 == pytest.approx(79.98, abs=0.005)


def test_counts_equal_the_programs():
    from l4p_tpu_torch.config import load_model_config as program_config
    from l4p_tpu_torch.utils import flops as program

    cfg, tasks = program_config(str(REPO / "configs" / "model.yaml"))
    for t, q in ((96, 128), (96, 0), (16, 64)):
        assert flops.alltask_video_flops(cfg, tasks, t, q) == program.alltask_video_flops(cfg, tasks, t, q)


def test_the_cells_count_is_the_alltask_count_without_camray():
    cfg, _ = load_model_config(str(REPO / "portbench" / "configs" / "l4p_videomae_g.json"))
    nocam = ("flow_2d_backward", "track_2d", "depth", "dyn_mask")
    full = flops.alltask_video_flops(cfg, nocam + ("camray",), 96, 128)
    assert flops.alltask_video_flops(cfg, nocam, 96, 128)["total"] == pytest.approx(full["total"] - full["dense/camray"])
    assert full["dense/camray"] > 0 and full["track"] > 0
