"""The port's Trainer.fit / save / restore and `main fit` (fp32, CPU, the tiny
config), mirroring tests/test_trainer.py: fit against the JAX Trainer.fit on
the same batches (the scalars.jsonl records), the loss falling and the
checkpoints; frozen parameters bitwise unchanged; a bitwise save / restore
round trip; the degenerate-batch skip and validation in the middle of fit;
the encoder-only checkpoint init; stochastic depth in fit; and
`python3 -m l4p_tpu_torch.main fit --device cpu` on a DAVIS tree."""

import copy
import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

import jax

from l4p_tpu_torch import L4P, Trainer, TrainerConfig
from l4p_tpu_torch.trainer import do_data_sanity_checks
from tests.test_torch_encoder import tiny_models
from tests.test_torch_ops import check
from tests.test_trainer import make_train_batch

torch.set_num_threads(1)
jax.config.update("jax_default_matmul_precision", "highest")

TASKS = ("depth", "flow_2d_backward", "dyn_mask")  # tests/test_trainer.py's


def records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def fresh_model():
    """A trainable copy of the tiny model (tiny_models' is shared)."""
    return copy.deepcopy(tiny_models()[3])


def fit(tmp_path, cfg=None, batches=None, model=None, **kw):
    cfg = tiny_models()[2] if cfg is None else cfg
    tcfg = dict(max_steps=6, log_every=2, ckpt_every=3, out_dir=str(tmp_path), lr=1e-4)
    tcfg.update(kw)
    trainer = Trainer(cfg, TASKS, TrainerConfig(**tcfg), device="cpu")
    model = fresh_model() if model is None else model
    batches = [make_train_batch(seed=i % 2) for i in range(6)] if batches is None else batches
    return trainer, model, trainer.fit(model, iter(batches))


def test_fit_matches_the_jax_trainer_loss_falls_and_checkpoints(tmp_path):
    """tests/test_trainer.py:34 on both packages: the same six batches, the
    records every 2 steps under the JAX trainer's keys with the same losses,
    the loss falling, checkpoints at steps 3 and 6."""
    from l4p_tpu.trainer import Trainer as JaxTrainer
    from l4p_tpu.trainer import TrainerConfig as JaxTrainerConfig

    jcfg, jparams, _, _ = tiny_models()
    batches = [make_train_batch(seed=i % 2) for i in range(6)]
    JaxTrainer(jcfg, TASKS, JaxTrainerConfig(max_steps=6, log_every=2, ckpt_every=3, out_dir=str(tmp_path / "jax"),
                                             lr=1e-4)).fit(jparams, iter(batches))
    _, _, (_, optimizer, step) = fit(tmp_path / "port", batches=batches)
    assert step == 6 and optimizer.count == 6
    port, ref = records(tmp_path / "port/scalars.jsonl"), records(tmp_path / "jax/scalars.jsonl")
    assert [r["step"] for r in port] == [r["step"] for r in ref] == [2, 4, 6]
    for p, r in zip(port, ref):
        assert set(p) == set(r) == {"step", *(f"scalars/train/{k}" for k in
                                              ("loss", "depth", "flow", "dyn_mask", "steps_per_sec"))}
        for k in r:
            if k != "step" and not k.endswith("steps_per_sec"):
                check(torch.tensor(p[k]), r[k], 1e-6, f"step {p['step']} {k}")  # measured <= 5.0e-7
    assert port[-1]["scalars/train/loss"] < port[0]["scalars/train/loss"]
    assert sorted(os.path.basename(p) for p in glob.glob(str(tmp_path / "port/ckpt_*"))) == [
        "ckpt_0000003.pt", "ckpt_0000006.pt"]


@pytest.mark.parametrize("flags,frozen,trained", [
    # tests/test_trainer.py:64: the encoder frozen but block 1 and the final norm
    (dict(freeze_video_encoder=True, unfreeze_blocks=(1,)),
     ("video_encoder.patch_embed.", "video_encoder.blocks.0.", "video_encoder.blocks.2.", "video_encoder.blocks.3."),
     ("video_encoder.blocks.1.attn.qkv.weight", "video_encoder.norm.weight",
      "task_heads.depth.task_head.dpt.head2.0.bias")),
    # tests/test_trainer.py:100: one head frozen
    (dict(freeze_heads=("depth",)), ("task_heads.depth.",),
     ("task_heads.flow_2d_backward.task_head.dpt.head2.0.bias", "video_encoder.blocks.0.attn.qkv.weight")),
])
def test_frozen_parameters_stay_bitwise_unchanged(tmp_path, flags, frozen, trained):
    cfg = dataclasses.replace(tiny_models()[2], **flags)
    before = {k: v.clone() for k, v in fresh_model().state_dict().items()}
    _, model, _ = fit(tmp_path, cfg=cfg, batches=[make_train_batch(seed=i) for i in range(3)], max_steps=3, lr=1e-3,
                      log_every=10, ckpt_every=10)
    after = model.state_dict()
    for name in before:
        if name.startswith(frozen):
            assert torch.equal(before[name], after[name]), f"frozen parameter changed: {name}"
    for name in trained:
        assert not torch.equal(before[name], after[name]), f"trainable parameter did not change: {name}"


def test_save_restore_round_trip_is_bitwise(tmp_path):
    """fit's last checkpoint restored into a fresh model and a new optimizer:
    the weights and the optimizer state bit for bit, and one more step from
    each gives the same weights bit for bit."""
    from l4p_tpu_torch.train import train_step
    from tests.test_torch_train import torch_batch

    trainer, model, (_, optimizer, step) = fit(tmp_path, batches=[make_train_batch(seed=i) for i in range(2)])
    assert step == 2
    restored, opt2, step2 = trainer.restore(str(tmp_path / "ckpt_0000002.pt"), fresh_model())
    assert step2 == 2 and opt2.count == optimizer.count == 2
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in restored.state_dict().items())
    for moments, restored_moments in ((optimizer.mu, opt2.mu), (optimizer.nu, opt2.nu)):
        assert set(moments) == set(restored_moments) and all(torch.equal(moments[k], restored_moments[k])
                                                             for k in moments)
    batch = torch_batch(make_train_batch(seed=5))
    for m, o in ((model, optimizer), (restored, opt2)):
        train_step(m, o, batch, trainer.model_cfg, TASKS)
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in restored.state_dict().items())
    with pytest.raises(ValueError, match="optimizer state"):
        opt2.load_state_dict({**optimizer.state_dict(), "mu": {}})


def test_fit_skips_degenerate_batches_and_validates_in_between(tmp_path):
    """A batch whose tracks are all invalid is skipped (reference
    l4p.py:41-52); validation under inference mode after every step leaves
    nothing the next training step cannot save for its backward."""
    bad = {**make_train_batch(seed=0), "track_2d_valid_bn1t": np.zeros((1, 3, 1, 4), np.float32)}
    good = [make_train_batch(seed=i) for i in (1, 2)]
    trainer = Trainer(tiny_models()[2], TASKS, TrainerConfig(max_steps=5, log_every=1, ckpt_every=10, val_every=1,
                                                             out_dir=str(tmp_path)), device="cpu")
    val = [make_train_batch(seed=3)]
    _, _, step = trainer.fit(fresh_model(), iter([bad, *good]), val_iter=lambda: iter(val))
    assert step == 2
    phases = [next(k.split("/")[1] for k in r if k.startswith("scalars/")) for r in records(tmp_path / "scalars.jsonl")]
    assert phases == ["train", "val", "train", "val"]
    assert do_data_sanity_checks(bad) and not do_data_sanity_checks(good[0])


def test_encoder_only_checkpoint_init(tmp_path):
    """tests/test_trainer.py:116 on the port: load_video_encoder_ckpt overlays
    the present tensors (a whole per-block stack, the patch embedding), keeps
    the init where a stack is partial, ignores extra keys, as JAX's
    convert_encoder_lenient; then fit trains from it."""
    from l4p_tpu.checkpoint import convert_encoder_lenient

    from l4p_tpu_torch import load_video_encoder_ckpt, params_from_jax

    jcfg, jparams, pcfg, _ = tiny_models()
    ecfg, e = jcfg.encoder, jcfg.encoder.embed_dim
    rng = np.random.default_rng(0)
    sd = {f"blocks.{i}.norm1.weight": rng.standard_normal(e).astype(np.float32) for i in range(ecfg.depth)}
    sd["patch_embed.proj.weight"] = rng.standard_normal(
        (e, 3, ecfg.tubelet_size, ecfg.patch_size, ecfg.patch_size)).astype(np.float32)
    sd["decoder.blocks.0.attn.qkv.weight"] = rng.standard_normal((3 * e, e)).astype(np.float32)
    for i in range(1, ecfg.depth):  # a partial stack: not loaded
        sd[f"blocks.{i}.norm2.weight"] = rng.standard_normal(e).astype(np.float32)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "enc.pth")
    model = fresh_model()
    load_video_encoder_ckpt(model.video_encoder, str(tmp_path / "enc.pth"))
    ref = convert_encoder_lenient(sd, ecfg, jparams["video_encoder"], dtype=np.float32)
    want = params_from_jax(jax.tree.map(np.asarray, {**jparams, "video_encoder": ref}), pcfg)
    for name, v in model.state_dict().items():
        assert torch.equal(v, want[name]), name
    assert torch.equal(model.video_encoder.blocks[3].norm1.weight.detach(),
                       torch.from_numpy(sd["blocks.3.norm1.weight"]))
    _, _, (_, _, step) = fit(tmp_path / "fit", model=model, batches=[make_train_batch(seed=0)])
    assert step == 1


def test_fit_with_stochastic_depth(tmp_path):
    """drop_path_rate 0.3: fit draws each step's masks (RandomDropPath(0,
    step)), so its losses differ from the rate-0 run's; a rerun repeats them."""
    cfg = tiny_models()[2]
    dp = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, drop_path_rate=0.3))
    runs = {}
    for name, c in (("dp", dp), ("dp again", dp), ("none", cfg)):
        model = L4P(c)  # the encoder reads its rates from its own config
        model.load_state_dict(tiny_models()[3].state_dict())
        fit(tmp_path / name, cfg=c, model=model, batches=[make_train_batch(seed=i) for i in range(4)], max_steps=4,
            log_every=1, ckpt_every=10)
        runs[name] = [r["scalars/train/loss"] for r in records(tmp_path / name / "scalars.jsonl")]
    assert all(np.isfinite(runs["dp"])) and runs["dp"] == runs["dp again"] and runs["dp"] != runs["none"]


def test_main_fit_on_a_davis_tree(tmp_path):
    """`main fit --device cpu` on a written DAVIS tree with the tiny model
    training track_2d. DAVIS has no ground-truth tracks (the loader's are
    all invalid), so each sequence is a degenerate batch that fit skips, as
    the JAX trainer's check says: fit ends at step 0 with its last
    checkpoint, which the trainer restores strictly."""
    import yaml

    from l4p_tpu.trainer import do_data_sanity_checks as jax_sanity

    from l4p_tpu_torch import main as cli
    from l4p_tpu_torch.config import load_model_config
    from l4p_tpu_torch.data.dataset import collate
    from l4p_tpu_torch.data.sources import DavisDataset
    from l4p_tpu_torch.demo import dataset_kwargs
    from tests.test_torch_data import write_davis
    from tests.test_torch_eval import TINY_YAML

    for seq in ("walk", "swing"):
        write_davis(tmp_path / "davis", seq, 5, (40, 56))
    tree = yaml.safe_load(open(TINY_YAML))
    tree["init_args"]["tasks"] = ["track_2d"]
    with open(tmp_path / "track.yaml", "w") as f:
        yaml.safe_dump(tree, f)
    cfg, tasks = load_model_config(str(tmp_path / "track.yaml"))
    ds = DavisDataset(str(tmp_path / "davis"), **dataset_kwargs(cfg))
    assert all(jax_sanity(collate(ds[i])) and do_data_sanity_checks(collate(ds[i])) for i in range(len(ds)))
    out = tmp_path / "out"
    assert cli.main(["fit", "--config", str(tmp_path / "track.yaml"), "--davis-root", str(tmp_path / "davis"),
                     "--device", "cpu", "--fp32", "--max-steps", "2", "--lr", "1e-3", "--out-dir", str(out)]) == 0
    assert sorted(os.listdir(out)) == ["ckpt_0000000.pt", "config.json"]
    trainer_cfg = json.load(open(out / "config.json"))["trainer"]
    assert (trainer_cfg["max_steps"], trainer_cfg["lr"], tasks) == (2, 1e-3, ("track_2d",))
    _, optimizer, step = Trainer(cfg, tasks, TrainerConfig(out_dir=str(tmp_path / "restore")), device="cpu").restore(
        str(out / "ckpt_0000000.pt"), L4P(cfg))
    assert step == 0 and optimizer.count == 0


@pytest.mark.parametrize("keys", [
    dict(freeze_video_encoder=True, unfreeze_blocks=None),
    dict(freeze_video_encoder=True, unfreeze_blocks=[]),
    dict(freeze_video_encoder=True, unfreeze_blocks=[1, 3], freeze_heads=["depth", "camray"]),
    dict(freeze_heads=None),
])
def test_yaml_reader_reads_the_freeze_keys_as_jax_does(tmp_path, keys):
    """freeze_video_encoder, unfreeze_blocks (None apart from the empty tuple)
    and freeze_heads read as l4p_tpu/config.py:147-150 reads them; an
    unknown encoder key still raises ValueError naming it."""
    import yaml

    from l4p_tpu.config import load_model_config as jax_load

    from l4p_tpu_torch.config import load_model_config
    from tests.test_torch_ops import port_config, tiny_yaml_with_encoder

    tree = yaml.safe_load(open("configs/model_tiny.yaml"))
    tree["init_args"]["l4p_model"]["init_args"].update(keys)
    path = tmp_path / "freeze.yaml"
    path.write_text(yaml.safe_dump(tree))
    cfg, _ = load_model_config(str(path))
    assert cfg == port_config(jax_load(str(path))[0])
    assert cfg.unfreeze_blocks == (None if keys.get("unfreeze_blocks") is None else tuple(keys["unfreeze_blocks"]))
    with pytest.raises(ValueError, match="freeze_encoder"):
        load_model_config(tiny_yaml_with_encoder(tmp_path, freeze_encoder=True))
