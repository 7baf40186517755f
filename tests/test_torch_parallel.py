"""The port's multi-process paths (l4p_tpu_torch.parallel, gloo on the CPU)
against the JAX package's mesh paths on the conftest's virtual CPU devices
and against the port without a mesh (fp32): window-sharded dense inference
over a (4, 1) mesh with an uneven window count, query-sharded tracking over
(4, 1), the tensor-parallel encoder over (2, 2), one DP x TP train_step
against JAX's jitted step of dryrun_multichip's batch with valid masks
that differ between the data ranks, stochastic depth and Trainer.fit /
save / restore under a mesh against the port without one, the collectives'
forwards and backwards, the q/k/v split of the fused qkv weight against
JAX's (3, E, E) split, shard_params' refusals, and the dry run under
torchrun.

The ranks are processes of tests/torch_parallel_ranks.py, which import no
JAX; one job file feeds all of them, and they meet through a file in the
test's temporary directory. The parent runs JAX and writes the port's
weights (params_from_jax) into that file."""

import dataclasses
import functools
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from l4p_tpu_torch import L4P, InferenceSession, Trainer, TrainerConfig, params_from_jax
from l4p_tpu_torch.checkpoint import _encoder_state
from l4p_tpu_torch.config import EncoderConfig
from l4p_tpu_torch.models.encoder import RandomDropPath
from l4p_tpu_torch.parallel import dryrun as DR
from l4p_tpu_torch.parallel import mesh as PM
from l4p_tpu_torch.train import make_optimizer, train_step, trainable_mask
from tests.test_torch_encoder import tiny_models
from tests.test_torch_ops import check, port_config

torch.set_num_threads(1)
jax.config.update("jax_default_matmul_precision", "highest")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
DENSE = ("depth", "dyn_mask", "flow_2d_backward")
TRAIN_TASKS = DR.TASKS
LR = 1e-4
pytestmark = pytest.mark.skipif(len(jax.devices()) < WORLD, reason="needs 4 virtual devices")


def launch(folder, jobs: dict, world: int = WORLD, timeout: float = 240.0) -> list:
    """Runs `jobs` on `world` rank processes; returns each rank's results."""
    path = os.path.join(folder, "jobs.pt")
    torch.save(jobs, path)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_parallel_ranks", path, str(r), str(world)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode, log[-3000:]) for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
    assert not failed, failed
    return [torch.load(os.path.join(folder, f"out{r}.pt"), weights_only=False) for r in range(world)]


# --- the cases' inputs ----------------------------------------------------

def dense_request():
    """T = 12 frames: 5 windows at stride 2 over 4 data ranks (2, 1, 1, 1)."""
    from tests.test_l4p_forward import make_data

    return {k: np.asarray(v) for k, v in make_data(T=12, N=4, with_tracks=False, seed=3).items()}


def track_request():
    """16 queries in chunks of max_queries 8, each split 2 a rank."""
    from tests.test_l4p_forward import make_data

    return {k: np.asarray(v) for k, v in make_data(T=8, N=16, seed=4).items() if k != "intrinsics_b44t"}


def tp_encoder_cfg():
    """tests/test_parallel.py's TP encoder: MLP width 256 splits over 2 model ranks."""
    from l4p_tpu.models.encoder import EncoderConfig as JaxEncoderConfig

    kw = dict(img_size=28, patch_size=14, embed_dim=64, depth=4, num_heads=4, mlp_ratio=4.0, all_frames=4)
    return JaxEncoderConfig(**kw), EncoderConfig(**kw)


TP_HOOKS = (2, 4)


@functools.lru_cache(maxsize=1)
def tp_encoder():
    """(JAX config, JAX params, port config, port state dict, x) of the TP encoder."""
    from l4p_tpu.models.encoder import init_encoder_params

    jcfg, pcfg = tp_encoder_cfg()
    params = init_encoder_params(jcfg, jax.random.PRNGKey(0))
    x = np.random.default_rng(0).standard_normal((2, 3, 4, 28, 28)).astype(np.float32)
    return jcfg, params, pcfg, _encoder_state(jax.tree.map(np.asarray, params), pcfg), x


@functools.lru_cache(maxsize=1)
def dryrun_models():
    """(JAX config, JAX params, port config, port state dict) of
    __graft_entry__.dryrun_multichip's model."""
    from l4p_tpu.config import init_l4p_params
    from l4p_tpu.models.dpt import DPTConfig
    from l4p_tpu.models.encoder import EncoderConfig as JE
    from l4p_tpu.models.l4p import DenseHeadConfig, L4PConfig
    from l4p_tpu.models.sam import SamConfig
    from l4p_tpu.models.track import TrackConfig

    hooks = (1, 2, 3, 4)
    enc = JE(img_size=28, patch_size=14, embed_dim=64, depth=4, num_heads=4, all_frames=4, mlp_ratio=4.0)
    kw = dict(layer_dims=(8, 8, 16, 16), feature_dim=8, last_dim=8, dim_tokens=64)
    heads = (
        ("flow_2d_backward", DenseHeadConfig(task_name="flow_2d_backward", kind="flow", out_nchan=2,
                                             dpt=DPTConfig(num_channels=2, hooks=hooks, **kw))),
        ("depth", DenseHeadConfig(task_name="depth", kind="depth", out_nchan=1,
                                  dpt=DPTConfig(num_channels=1, hooks=hooks, **kw))),
        ("dyn_mask", DenseHeadConfig(task_name="dyn_mask", kind="dyn_mask", out_nchan=1,
                                     dpt=DPTConfig(num_channels=1, hooks=hooks, **kw))),
        ("camray", DenseHeadConfig(task_name="traj3d", kind="camray", out_nchan=6, use_intrinsics=False,
                                   fixed_intrinsics=False,
                                   dpt=DPTConfig(num_channels=6, hooks=hooks,
                                                 actpost_scale_factors=((1, 0, 0), (1, 0, 0), (0, 0, 0), (-1, -1, -1)),
                                                 fusion_scale_factors=((1, 1, 1), (1, 1, 1), (2, 1, 1), (2, 2, 2)),
                                                 output_size=(4, 2, 2), **kw))),
    )
    jcfg = L4PConfig(encoder=enc, window_size=(4, 28, 28), window_stride_t=2, joint_alignment=True, heads=heads,
                     track=TrackConfig(image_size=(4, 28, 28),
                                       sam=SamConfig(embed_dim=64, image_embedding_size=(2, 2, 2),
                                                     input_image_size=(4, 28, 28)),
                                       max_queries=8, estimation_directions=(1, -1)))
    jparams = init_l4p_params(jcfg, jax.random.PRNGKey(0))
    pcfg = port_config(jcfg)
    return jcfg, jparams, pcfg, params_from_jax(jax.tree.map(np.asarray, jparams), pcfg)


def train_batch() -> dict:
    """dryrun_multichip's batch for a data axis of 2, with valid masks that
    differ between the rows (the data ranks): row 0 mostly valid, row 1
    mostly not, so a mean of per-rank means is not the batch's mean."""
    batch = DR.train_batch(2)
    rng = np.random.default_rng(7)
    share = np.array([0.9, 0.2])

    def mask(shape):
        return (rng.uniform(size=shape) < share.reshape((2,) + (1,) * (len(shape) - 1))).astype(np.float32)

    batch["depth_valid_b1thw"] = mask((2, 1, 4, 28, 28))
    batch["flow_2d_backward_valid_b2thw"] = mask((2, 2, 4, 28, 28))
    batch["dyn_mask_valid_b1thw"] = mask((2, 1, 4, 28, 28))
    batch["track_2d_valid_bn1t"] = mask((2, DR.QUERIES, 1, 4))
    return batch


def drop_path_cfg(cfg):
    return dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, drop_path_rate=0.5))


# --- one launch for every case --------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    folder = tmp_path_factory.mktemp("ranks")
    _, _, pcfg, model = tiny_models()
    tiny_state = model.state_dict()
    # the TP session and training need an MLP width that 2 model ranks split (the tiny config's is 279)
    _, _, dcfg, dstate = dryrun_models()
    _, _, ecfg, estate, x = tp_encoder()
    jobs = {
        "dense": ("session", (4, 1), dict(cfg=pcfg, state=tiny_state, tasks=DENSE, data=dense_request())),
        "track": ("session", (4, 1), dict(cfg=pcfg, state=tiny_state, tasks=("track_2d",), data=track_request(),
                                          state_dict=True)),
        "tp_session": ("session", (2, 2), dict(cfg=dcfg, state=dstate, tasks=DENSE + ("track_2d",),
                                               data=dense_request() | {k: v for k, v in track_request().items()
                                                                       if k.startswith("track")})),
        "encoder": ("encoder", (2, 2), dict(cfg=ecfg, state=estate, x=x, hooks=TP_HOOKS)),
        "train": ("train", (2, 2), dict(cfg=dcfg, state=dstate, batch=train_batch(), tasks=TRAIN_TASKS, lr=LR,
                                        total_steps=10)),
        "drop_path": ("train", (2, 2), dict(cfg=drop_path_cfg(dcfg), state=dstate, batch=train_batch(),
                                            tasks=TRAIN_TASKS, lr=LR, total_steps=10, drop_path_seed=3)),
        "fit": ("fit", (2, 2), dict(cfg=dcfg, state=dstate, tasks=TRAIN_TASKS, out_dir=str(folder / "fit"),
                                    batches=[train_batch(), DR.train_batch(2, seed=1)])),
        "collectives_4x1": ("collectives", (4, 1), {}),
        "collectives_2x2": ("collectives", (2, 2), {}),
    }
    return launch(str(folder), jobs)


def every_rank(ranks, job: str):
    """The job's result of rank 0 after checking that every rank returned the same."""
    first = ranks[0][job]
    for r, res in enumerate(ranks[1:], 1):
        for k, v in first.items():
            np.testing.assert_array_equal(res[job][k], v, err_msg=f"{job} {k}: rank {r} differs from rank 0")
    return first


# --- inference --------------------------------------------------------------

def jax_forward(jparams, jcfg, data, tasks, n_data):
    """JAX's l4p_forward(mesh=) jitted over an (n_data, 1) mesh."""
    from l4p_tpu.models.l4p import l4p_forward
    from l4p_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(n_data=n_data, n_model=1, devices=jax.devices()[:n_data])
    out = jax.jit(lambda p, d: l4p_forward(p, jcfg, d, tasks, mesh=mesh))(
        jparams, {k: jnp.asarray(v) for k, v in data.items()})
    return {k: np.asarray(v) for k, v in out.items()}


def test_window_sharded_dense_session_matches_jax_mesh_and_the_port_without_one(ranks):
    """5 windows over 4 data ranks (two ranks' counts differ) against JAX's
    l4p_forward(mesh=) on 4 devices and the port's session without a mesh."""
    jcfg, jparams, pcfg, model = tiny_models()
    data = dense_request()
    got = every_rank(ranks, "dense")
    ref = jax_forward(jparams, jcfg, data, DENSE, 4)
    plain = InferenceSession(pcfg, DENSE, "cpu")(model, data)
    assert set(got) == set(ref) == set(plain)
    for k in ref:
        assert got[k].shape[2] == 12
        # measured <= 1.23e-5 against JAX (depth's disparity chain), 5.1e-8 against the port
        check(got[k], ref[k], 3e-5, f"{k} against JAX's mesh")
        check(got[k], plain[k], 2e-7, f"{k} against the port without a mesh")


def test_query_sharded_tracking_matches_jax_mesh_and_the_port_without_one(ranks):
    """16 queries, max_queries 8: each chunk's 8 queries over 4 data ranks
    (tests/test_parallel.py's case on 4 devices); the session loaded the
    state dict and sharded it itself."""
    jcfg, jparams, pcfg, model = tiny_models()
    data = track_request()
    got = every_rank(ranks, "track")
    ref = jax_forward(jparams, jcfg, data, ("track_2d",), 4)
    plain = InferenceSession(pcfg, ("track_2d",), "cpu")(model, data)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape[1] == 16
        # measured <= 3.2e-7 against JAX (traj, in pixels), 1.3e-7 against the port
        check(got[k], ref[k], 1e-6, f"{k} against JAX's mesh")
        check(got[k], plain[k], 5e-7, f"{k} against the port without a mesh")


def test_tp_session_matches_jax_mesh(ranks):
    """Dense tasks and tracks on a (2, 2) mesh: windows and queries over
    `data`, the encoder's blocks over `model`, against JAX's l4p_forward
    on the same (2, 2) device mesh with its encoder TP-sharded."""
    from jax.sharding import NamedSharding

    from l4p_tpu.models.l4p import l4p_forward
    from l4p_tpu.parallel.mesh import l4p_param_specs, make_mesh

    jcfg, jparams, pcfg, _ = dryrun_models()
    tasks = DENSE + ("track_2d",)
    data = dense_request() | {k: v for k, v in track_request().items() if k.startswith("track")}
    mesh = make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    sharded = jax.tree.map(lambda v, s: jax.device_put(v, NamedSharding(mesh, s)), jparams, l4p_param_specs(jparams))
    ref = jax.jit(lambda p, d: l4p_forward(p, jcfg, d, tasks, mesh=mesh))(
        sharded, {k: jnp.asarray(v) for k, v in data.items()})
    got = every_rank(ranks, "tp_session")
    assert set(got) == set(ref)
    for k in ref:
        check(got[k], np.asarray(ref[k]), 6e-6, k)  # measured <= 2.4e-6 (depth), 3.2e-7 (traj)


# --- the tensor-parallel encoder ------------------------------------------

def test_qkv_row_split_equals_jax_split():
    """The fused (3E, E) qkv weight's shard on each of 4 model ranks is
    JAX's (3, E, E) qkv_w split on its output rows, flattened; the inverse
    gives the weight back."""
    _, params, pcfg, state, _ = tp_encoder()
    qkv = np.asarray(params["blocks"]["qkv_w"])[1]  # block 1: (3, E_out, E_in), split on E_out
    e, nm = pcfg.embed_dim, 4
    full = state["blocks.1.attn.qkv.weight"]
    parts = [PM.shard_tensor("blocks.1.attn.qkv.weight", full, nm, r) for r in range(nm)]
    for r, part in enumerate(parts):
        want = qkv[:, r * e // nm: (r + 1) * e // nm]  # (3, E/nm, E): this rank's rows of q, k and v
        np.testing.assert_array_equal(part.numpy(), want.reshape(-1, e))
    assert torch.equal(PM.unshard_tensor("blocks.1.attn.qkv.weight", parts), full)
    # a plain 3E/nm chunk would cross from q into k
    assert not torch.equal(parts[1], full[3 * e // nm: 2 * 3 * e // nm])


def test_tp_encoder_matches_jax_sharded_encoder(ranks):
    """Hooks 2 and 4 and the output over a (2, 2) mesh (rows over `data`,
    blocks over `model`) against JAX's encoder_apply with
    encoder_param_specs on the same (2, 2) device mesh."""
    from jax.sharding import NamedSharding

    from l4p_tpu.models.encoder import encoder_apply
    from l4p_tpu.parallel.mesh import encoder_param_specs, make_mesh

    jcfg, params, _, _, x = tp_encoder()
    mesh = make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    sharded = jax.tree.map(lambda v, s: jax.device_put(v, NamedSharding(mesh, s)), params,
                           encoder_param_specs(params))
    ref = jax.jit(lambda p, xx: encoder_apply(p, xx, jcfg, hooks=TP_HOOKS))(sharded, jnp.asarray(x))
    got = every_rank(ranks, "encoder")
    # measured <= 2.6e-6 (hook 2), 1.6e-6 (hook 4, final)
    for h, r in zip(TP_HOOKS, ref["hooks"]):
        check(got[f"hook {h}"], np.asarray(r), 6e-6, f"hook {h}")
    check(got["final"], np.asarray(ref["final"]), 6e-6, "final")


class FakeMesh:
    """A mesh of one data rank and `nm` model ranks, this process model rank
    0, for the checks that raise before any collective."""

    mesh_dim_names = (PM.DATA, PM.MODEL)

    def __init__(self, nm):
        self.nm = nm

    def size(self, dim):
        return (1, self.nm)[dim]

    def get_coordinate(self):
        return [0, 0]

    def get_group(self, axis):
        return None


def test_shard_params_refuses_what_the_model_axis_does_not_divide():
    from l4p_tpu_torch.models.encoder import Block

    cfg = dryrun_models()[2]
    base = dict(img_size=28, patch_size=14, embed_dim=64, depth=1, all_frames=4)
    model = L4P(dataclasses.replace(cfg, encoder=EncoderConfig(num_heads=4, mlp_ratio=4.0, **base)))
    with pytest.raises(ValueError, match=r"heads 4 % 3 != 0"):
        PM.shard_params(model, FakeMesh(3))
    odd = L4P(dataclasses.replace(cfg, encoder=EncoderConfig(num_heads=4, mlp_ratio=4.03125, **base)))
    with pytest.raises(ValueError, match=r"hidden 258 % 4 != 0"):
        PM.shard_params(odd, FakeMesh(4))
    blk = Block(EncoderConfig(num_heads=4, **base).block)  # left whole under a model axis of 2
    with pytest.raises(ValueError, match="not the shard of a model axis of 2"):
        blk(torch.zeros(1, 8, 64), lambda q, k, v, scale: q, None, FakeMesh(2))


def test_fused_encoder_refuses_a_mesh():
    """JAX's gate runs the default blocks under a mesh; the port raises, in
    the session and in the encoder."""
    cfg, model = tiny_models()[2:]
    fused = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, fused_encoder=True))
    with pytest.raises(ValueError, match="fused encoder .* takes no mesh"):
        InferenceSession(fused, DENSE, "cpu", mesh=FakeMesh(1))(model, dense_request())
    with pytest.raises(ValueError, match="takes no mesh"):
        model.video_encoder(torch.zeros(1, 8, 64), (4,), encoder_blocks=lambda *a: None, mesh=FakeMesh(1))


# --- training ---------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def jax_train_step():
    """JAX's step jitted over a (2, 2) mesh on dryrun_multichip's model,
    optimizer and (masked) batch, as __graft_entry__.py:163-178 runs it,
    with the port's trainable set (pe_gaussian a buffer)."""
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from l4p_tpu.parallel.mesh import l4p_param_specs, make_mesh
    from l4p_tpu.train import l4p_loss
    from l4p_tpu.train import make_optimizer as jax_optimizer
    from l4p_tpu.train import trainable_mask as jax_mask

    jcfg, jparams, pcfg, _ = dryrun_models()
    mask = jax_mask(jparams, jcfg)
    mask["task_heads"]["track_2d"]["prompt_encoder"]["pe_gaussian"] = 0.0
    optimizer = jax_optimizer(lr=LR, total_steps=10, mask=mask)
    mesh = make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    params = jax.tree.map(lambda v, s: jax.device_put(v, NamedSharding(mesh, s)), jparams, l4p_param_specs(jparams))
    opt_state = jax.tree.map(lambda v: jax.device_put(v, NamedSharding(mesh, P())), optimizer.init(jparams))
    batch = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, P("data"))) for k, v in train_batch().items()}

    @jax.jit
    def step(params, opt_state, batch):
        (loss, losses), grads = jax.value_and_grad(lambda p: l4p_loss(p, jcfg, batch, TRAIN_TASKS), has_aux=True)(
            params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), loss, losses

    new, loss, losses = step(params, opt_state, batch)
    return (float(loss), {k: float(v) for k, v in losses.items()},
            params_from_jax(jax.tree.map(np.asarray, new), pcfg))


def test_dp_tp_train_step_matches_jax_mesh_step(ranks):
    """The loss, each task's loss and every weight after one step (gathered
    from the shards) against JAX's step jitted over the (2, 2) mesh. The
    rows' valid masks differ, so each mean must divide by the count over
    both data ranks; every rank holds the same gathered weights."""
    ref_loss, ref_losses, ref_state = jax_train_step()
    got = ranks[0]["train"]
    for r in range(1, WORLD):
        assert ranks[r]["train"]["loss"] == got["loss"] and ranks[r]["train"]["losses"] == got["losses"]
        for k, v in got["state"].items():
            assert torch.equal(ranks[r]["train"]["state"][k], v), f"{k}: rank {r} differs from rank 0"
    assert set(got["losses"]) == set(ref_losses)
    for k, v in ref_losses.items():
        check(got["losses"][k], v, 1e-6, k)  # measured <= 3.5e-7 (depth)
    check(got["loss"], ref_loss, 1e-6, "total")
    noise = {n for n in got["state"] if n.endswith("k_proj.bias")}  # gradient 0 in exact arithmetic
    for name, p in got["state"].items():
        if name in noise:
            assert (p - ref_state[name]).abs().max() <= 3 * LR, name
        else:
            check(p, ref_state[name], 3e-7, name)  # measured <= 9.1e-8


def test_dp_tp_train_step_with_masks_differs_from_a_mean_of_rank_means():
    """The check above has teeth: on these masks the batch's masked mean
    and the mean of the two rows' masked means are far apart."""
    b = train_batch()
    x = np.abs(np.random.default_rng(0).standard_normal(b["depth_valid_b1thw"].shape))
    m = b["depth_valid_b1thw"]
    global_mean = (x * m).sum() / m.sum()
    rank_means = np.mean([(x[i] * m[i]).sum() / m[i].sum() for i in range(2)])
    assert abs(global_mean - rank_means) > 1e-2 * global_mean


def test_dp_tp_stochastic_depth_draws_the_whole_batch(ranks):
    """drop_path_rate 0.5 with RandomDropPath(3, 0): the (2, 2) step equals
    the port's step without a mesh on the same draws (each mask drawn for
    the whole batch and cut to the rank's row)."""
    _, _, pcfg, state = dryrun_models()
    cfg = drop_path_cfg(pcfg)
    model = L4P(cfg)
    model.load_state_dict(state, strict=True)
    opt = make_optimizer(model, lr=LR, total_steps=10, mask=trainable_mask(model, cfg))
    loss, _ = train_step(model, opt, {k: torch.from_numpy(v) for k, v in train_batch().items()}, cfg, TRAIN_TASKS,
                         drop_path_draws=RandomDropPath(3, 0))
    got = ranks[0]["drop_path"]
    assert all(r["drop_path"]["loss"] == got["loss"] for r in ranks)
    check(got["loss"], float(loss), 1e-6, "loss")  # measured 0
    want = model.state_dict()
    for name, p in got["state"].items():
        if name.endswith("k_proj.bias"):  # gradient 0 in exact arithmetic: Adam moves its noise by up to lr
            assert (p - want[name]).abs().max() <= 3 * LR, name
        else:
            check(p, want[name], 2e-7, name)  # measured <= 6.4e-8


def test_fit_saves_one_gathered_checkpoint_and_restores_the_shards(ranks, tmp_path):
    """Trainer.fit on a (2, 2) mesh over two batches: rank 0's checkpoint
    holds the whole model in the released layout, equal to fit without a
    mesh on the same batches; restore gave every rank its shard of weights
    and moments back bit for bit."""
    _, _, pcfg, state = dryrun_models()
    res = [r["fit"] for r in ranks]
    assert all(r["restored"] and r["step"] == 2 for r in res), res
    got = torch.load(res[0]["path"], weights_only=True)
    trainer = Trainer(pcfg, TRAIN_TASKS, TrainerConfig(max_steps=2, log_every=1, ckpt_every=10 ** 6,
                                                       val_every=10 ** 6, out_dir=str(tmp_path)),
                      metrics_fn=None, device="cpu")
    model = L4P(pcfg)
    model.load_state_dict(state, strict=True)
    trainer.fit(model, [train_batch(), DR.train_batch(2, seed=1)])
    want = torch.load(os.path.join(tmp_path, "ckpt_0000002.pt"), weights_only=True)
    assert got["step"] == want["step"] == 2 and set(got["model"]) == set(want["model"])
    for name, p in got["model"].items():
        if name.endswith("k_proj.bias"):  # gradient 0 in exact arithmetic: Adam moves its noise by up to lr a step
            assert (p - want["model"][name]).abs().max() <= 3 * 2 * LR, name
        else:
            check(p, want["model"][name], 2.5e-7, name)  # measured <= 8.4e-8
    assert got["optimizer"]["count"] == 2 and set(got["optimizer"]["mu"]) == set(want["optimizer"]["mu"])
    for name, m in got["optimizer"]["mu"].items():
        assert m.shape == want["optimizer"]["mu"][name].shape, name


def test_port_dryrun_config_is_jaxs():
    assert DR.dryrun_config() == dryrun_models()[2]


# --- the collectives ----------------------------------------------------------

@pytest.mark.parametrize("job", ["collectives_4x1", "collectives_2x2"])
def test_collective_functions_forward_and_backward(ranks, job):
    for res in (r[job] for r in ranks):
        d, m = res["rank"]
        nd, nm = (4, 1) if job.endswith("4x1") else (2, 2)
        y, g = res["copy"]
        np.testing.assert_array_equal(y, np.full(3, d + 1.0))  # identity forward
        np.testing.assert_array_equal(g, np.full(3, nm * (nm + 1) / 2))  # gradients of the model ranks summed
        y, g = res["reduce"]
        np.testing.assert_array_equal(y, np.full(2, nm * (nm + 1) / 2))  # summed over the model ranks
        np.testing.assert_array_equal(g, np.full(2, 3.0))  # identity backward
        n_local, gathered, grad, counts = res["rows"]
        full = np.arange(14, dtype=np.float32).reshape(7, 2)
        np.testing.assert_array_equal(gathered, full)
        assert n_local == PM.row_counts(7, nd)[d]
        lo = sum(PM.row_counts(7, nd)[:d])
        np.testing.assert_array_equal(grad, np.broadcast_to(np.arange(lo, lo + n_local, dtype=np.float32)[:, None],
                                                            (n_local, 2)))
        if nd == 4:
            np.testing.assert_array_equal(res["sparse"], full[:2])
        assert res["data_sum"] == sum(range(nd))


def test_row_counts_split_as_array_split():
    for n in range(0, 11):
        for parts in (1, 2, 3, 4):
            assert PM.row_counts(n, parts) == [len(a) for a in np.array_split(np.arange(n), parts)]


def test_split_table_matches_jax_encoder_param_specs():
    """Every block leaf JAX's encoder_param_specs splits, and the dim it
    splits, against the port's table on the released names."""
    from l4p_tpu.parallel.mesh import encoder_param_specs as jax_specs

    jcfg, params, pcfg, state, _ = tp_encoder()
    specs = jax_specs(params)["blocks"]
    # JAX leaf -> the port's name below blocks.{i}. and the port's dim for JAX's model dim
    leaf = {"qkv_w": ("attn.qkv.weight", 0), "q_bias": ("attn.q_bias", 0), "v_bias": ("attn.v_bias", 0),
            "proj_w": ("attn.proj.weight", 1), "fc1_w": ("mlp.fc1.weight", 0), "fc1_b": ("mlp.fc1.bias", 0),
            "fc2_w": ("mlp.fc2.weight", 1)}
    split = {k for k, s in specs.items() if "model" in tuple(s)}
    assert split == set(leaf)
    port = {n for n, d in PM.encoder_param_specs(state).items() if d is not None}
    assert port == {f"blocks.{i}.{leaf[k][0]}" for i in range(pcfg.depth) for k in leaf}
    assert all(PM.param_split(f"video_encoder.blocks.3.{name}") == dim for name, dim in leaf.values())


# --- the dry run ------------------------------------------------------------

def test_dryrun_under_torchrun_on_four_cpu_ranks():
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "4", "-m",
           "l4p_tpu_torch.parallel.dryrun", "--device", "cpu"]
    res = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=240,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-3000:]
    m = re.search(r"dryrun OK: mesh=\{'data': 2, 'model': 2\} loss=(\S+) .*sharded inference over 10 frames OK",
                  res.stdout)
    assert m is not None, res.stdout
    assert np.isfinite(float(m.group(1)))
