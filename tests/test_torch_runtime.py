"""The port's runtime from files: checkpoints, resume, the eval loop
against the JAX package's, and the train / test CLIs on the CPU.

* ``save_checkpoint`` / ``latest_checkpoint`` / ``load_checkpoint`` /
  ``load_meta`` and ``max_keep``.
* Resume: two train steps straight equal one step, a checkpoint, a
  fresh trainer (another seed) loading it, one step, bit for bit in
  every parameter and buffer, AdamW's state, the update count and the
  rate (a cosine schedule, so the rate moves every step). The smoke
  config on the CPU, scenes from its dataset on disk.
* ``run_eval`` against JAX's ``run_eval`` with
  ``make_eval_step(..., with_rays=True)`` (the density modulation on, as
  the port always runs it) on the same written scenes, with the JAX
  weights carried over by ``from_jax_variables``: per scene the same
  number of detections and labels, boxes and scores within 1e-4; the
  mAP / mAR dicts within 1e-6 (over ranks, ``tests/test_torch_ddp.py``).
  ``inference_detector`` on a scene's info equals the eval loop's
  detections of that scene.
* ``tools/train`` (2 steps) then ``tools/test --eval mAP nvs`` end to
  end in subprocesses with ``--device cpu`` on the smoke config:
  ``ckpt_1.pth`` written and loadable by ``init_detector``, the metrics
  JSON printed. Without ``--device cpu`` and without a card both CLIs
  raise.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfdet_tpu.api import run_eval as jax_run_eval
from nerfdet_tpu.api import single_scene_test as jax_single_scene_test
from nerfdet_tpu.data import (MultiViewPipeline as JaxPipeline,
                              ScanNetMultiViewDataset as JaxDataset)
from nerfdet_tpu.models.nerfdet import NerfDet as JaxNerfDet
from nerfdet_tpu.models.nerfdet import SceneMeta as JaxSceneMeta
from nerfdet_tpu.train.step import make_eval_step

from nerfdet_tpu_torch import api
from nerfdet_tpu_torch.config import Config
from nerfdet_tpu_torch.data.dataset import (ScanNetMultiViewDataset,
                                            build_dataset,
                                            ray_stats_spec_from_config,
                                            rgb_stats_spec_from_config)
from nerfdet_tpu_torch.data.pipeline import MultiViewPipeline
from nerfdet_tpu_torch.data.synthetic import write_synthetic_scannet
from nerfdet_tpu_torch.models.nerfdet import NerfDet, SceneMeta
from nerfdet_tpu_torch.tools import test as test_cli
from nerfdet_tpu_torch.tools import train as train_cli
from nerfdet_tpu_torch.utils.checkpoint import (latest_checkpoint,
                                                load_checkpoint, load_meta,
                                                save_checkpoint)
from nerfdet_tpu_torch.utils.weight_convert import from_jax_variables

from tests.test_torch_nerfdet import _perturb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs", "nerfdet", "nerfdet_smoke_synthetic.py")
TEST_CFG = dict(nms_pre=100, score_thr=0.01, iou_thr=0.25)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _options(root):
    return [f"data.train.data_root={root}/",
            f"data.train.ann_file={root}/scannet_infos_train.pkl",
            f"data.val.data_root={root}/",
            f"data.val.ann_file={root}/scannet_infos_val.pkl",
            f"data.test.data_root={root}/",
            f"data.test.ann_file={root}/scannet_infos_val.pkl"]


@pytest.fixture(scope="module")
def smoke_root(tmp_path_factory):
    """The smoke config's dataset: two scenes a split at its ori_shape."""
    return write_synthetic_scannet(
        str(tmp_path_factory.mktemp("smoke")), n_scenes=2, n_images=8,
        hw=(240, 320))


# ---------------------------------------------------------------------
# checkpoints and resume
# ---------------------------------------------------------------------

def test_checkpoint_files_and_max_keep(tmp_path):
    d = str(tmp_path / "ckpts")
    assert latest_checkpoint(d) is None
    for epoch in (1, 2, 10):
        path = save_checkpoint(d, epoch, dict(w=torch.full((2,), epoch),
                                              step=epoch * 3),
                               meta=dict(epoch=epoch, config="c.py"),
                               max_keep=2)
        assert path.endswith(f"ckpt_{epoch}.pth")
    assert sorted(os.listdir(d)) == ["ckpt_10.pth", "ckpt_2.pth"]
    assert latest_checkpoint(d) == os.path.join(d, "ckpt_10.pth")
    got = load_checkpoint(d)  # a directory: its latest
    assert got["step"] == 30 and torch.equal(got["w"], torch.full((2,), 10))
    assert load_meta(os.path.join(d, "ckpt_2.pth")) == dict(epoch=2,
                                                            config="c.py")
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "empty"))


def _smoke_trainer(seed):
    cfg = Config.fromfile(SMOKE)
    cfg.merge_from_options({"lr_config": dict(policy="CosineAnnealing",
                                              min_lr_ratio=0.01)})
    return api.init_trainer(cfg, device="cpu", seed=seed,
                            steps_per_epoch=2)


def test_resume_equals_straight_run(smoke_root, tmp_path):
    cfg = Config.fromfile(SMOKE)
    cfg.merge_from_options(_options(smoke_root))
    ds = build_dataset(cfg.data["train"], n_rand=cfg.model["N_rand"],
                       rgb_stats_spec=rgb_stats_spec_from_config(cfg),
                       ray_stats_spec=ray_stats_spec_from_config(cfg))
    scenes = [ds[0], ds[1]]

    straight = _smoke_trainer(0)
    for s in scenes:
        straight.step(api.train_batch(straight.model, [s]))

    first = _smoke_trainer(0)
    first.step(api.train_batch(first.model, [scenes[0]]))
    path = save_checkpoint(str(tmp_path), 1, dict(
        model=first.model.state_dict(),
        optimizer=first.optimizer.state_dict(),
        step=first.optimizer.count, epoch=1))
    resumed = _smoke_trainer(1)  # other random weights, all overwritten
    ckpt = load_checkpoint(path)
    resumed.model.load_state_dict(ckpt["model"])
    resumed.optimizer.load_state_dict(ckpt["optimizer"])
    assert resumed.optimizer.count == 1
    resumed.step(api.train_batch(resumed.model, [scenes[1]]))

    want, got = straight.model.state_dict(), resumed.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    a, b = straight.optimizer, resumed.optimizer
    assert a.count == b.count == 2
    assert a.schedule(2) == b.schedule(2) != a.schedule(1)
    assert ([g["lr"] for g in a.adamw.param_groups]
            == [g["lr"] for g in b.adamw.param_groups])
    sa, sb = a.adamw.state_dict()["state"], b.adamw.state_dict()["state"]
    assert set(sa) == set(sb) and len(sa) > 100
    for i in sa:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)


# ---------------------------------------------------------------------
# run_eval against JAX
# ---------------------------------------------------------------------

ORI, IMG, PAD = (124, 160), (31, 40), (32, 40)
N_VOX, VOXEL = (8, 8, 4), (0.8, 0.8, 0.8)


def _datasets(root):
    def pipeline(cls):
        return cls(n_images=3, img_scale=(40, 31), pad_size=PAD, margin=2,
                   nerf_target_views=1)

    kw = dict(data_root=root, ann_file=f"{root}/scannet_infos_val.pkl",
              test_mode=True, use_ray=True,
              rgb_stats_spec=(N_VOX, VOXEL, "float32"))
    return (ScanNetMultiViewDataset(pipeline=pipeline(MultiViewPipeline),
                                    **kw),
            JaxDataset(pipeline=pipeline(JaxPipeline), **kw))


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """Written scenes, both datasets, the JAX model and its perturbed
    weights, and the port's model with them."""
    root = write_synthetic_scannet(
        str(tmp_path_factory.mktemp("eval")), n_scenes=2, n_images=5,
        hw=ORI, n_boxes=3, seed=4, splits=("val",))
    port_ds, jax_ds = _datasets(root)
    jmodel = JaxNerfDet(backbone_depth=50, n_voxels=N_VOX, voxel_size=VOXEL,
                        aabb=((-3.2, -3.2, -1.1), (3.2, 3.2, 2.1)),
                        n_samples=16, n_rand=32, nerf_density=True,
                        meta=JaxSceneMeta(ori_shape=ORI, img_shape=IMG,
                                          pad_shape=PAD))
    scene = jax_ds[0]
    batch = {k: jnp.asarray(scene[k]) for k in (
        "imgs", "denorm_images", "intrinsic", "extrinsics", "origin")}
    batch["ray_o"] = jnp.asarray(scene["ray_o"][0, :8])
    batch["ray_d"] = jnp.asarray(scene["ray_d"][0, :8])
    variables = jax.jit(lambda k: jmodel.init(
        k, batch, train=False, with_rays=True))(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    params = _perturb(dict(variables["params"]), rng)
    # the box regression back at its init scale: boxes of a room's size
    # (x20 with the scores' kernels they reach kilometres, where float32
    # rounding exceeds 1e-4 absolute)
    params["bbox_head"]["reg_conv"]["kernel"] /= np.float32(20.0)
    variables = {"params": params,
                 "batch_stats": _perturb(dict(variables["batch_stats"]),
                                         rng)}
    model = NerfDet(n_voxels=N_VOX, voxel_size=VOXEL, n_samples=16,
                    n_rand=32, nerf_density=True,
                    meta=SceneMeta(ori_shape=ORI, img_shape=IMG,
                                   pad_shape=PAD))
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return root, port_ds, jax_ds, jmodel, variables, model.eval()


def test_run_eval_matches_jax_with_density(toy):
    root, port_ds, jax_ds, jmodel, variables, model = toy
    eval_step = make_eval_step(jmodel, nms_pre=TEST_CFG["nms_pre"],
                               with_rays=True)
    n_dets = 0
    for i in range(len(port_ds)):
        want = jax_single_scene_test(eval_step, variables, jax_ds[i],
                                     TEST_CFG["score_thr"],
                                     TEST_CFG["iou_thr"])
        got = api.single_scene_test(model, port_ds[i], TEST_CFG["score_thr"],
                                    TEST_CFG["iou_thr"], TEST_CFG["nms_pre"])
        assert len(got["labels_3d"]) == len(want["labels_3d"]), i
        np.testing.assert_array_equal(got["labels_3d"], want["labels_3d"])
        np.testing.assert_allclose(got["boxes_3d"], want["boxes_3d"],
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(got["scores_3d"], want["scores_3d"],
                                   rtol=0, atol=1e-4)
        n_dets += len(got["labels_3d"])
    assert n_dets > 0  # the comparison holds detections

    want = jax_run_eval(jmodel, variables, jax_ds, TEST_CFG,
                        progress=False, eval_step=eval_step)
    got = api.run_eval(model, port_ds, TEST_CFG, progress=False)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, k

    # one raw scene through the test pipeline, as the eval loop's scene 0
    cfg = Config(dict(
        data=dict(test=dict(
            data_root=root, ann_file=f"{root}/scannet_infos_val.pkl",
            pipeline=[dict(type="MultiViewPipeline", n_images=3, margin=2,
                           nerf_target_views=1, transforms=[
                               dict(type="Resize", img_scale=(40, 31)),
                               dict(type="Pad", size=PAD)])])),
        test_cfg=TEST_CFG))
    single = api.inference_detector(model, port_ds.get_data_info(0), cfg)
    loop = api.single_scene_test(model, port_ds[0], **TEST_CFG)
    for k in loop:
        np.testing.assert_array_equal(single[k], loop[k])


# ---------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------

def _cli(module, *args):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, "-m", f"nerfdet_tpu_torch.tools.{module}", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)


def test_train_then_test_cli_on_cpu(smoke_root, tmp_path):
    work = str(tmp_path / "work")
    run = _cli("train", SMOKE, "--work-dir", work, "--max-steps", "2",
               "--device", "cpu", "--options", *_options(smoke_root))
    assert run.returncode == 0, run.stderr[-3000:]
    ckpt = os.path.join(work, "ckpts", "ckpt_1.pth")
    assert os.path.exists(ckpt)
    assert "Eval: mAP_0.25" in run.stderr
    records = [json.loads(line) for line in
               open(os.path.join(work, "metrics.jsonl"))]
    assert records[0]["step"] == 2 and np.isfinite(records[0]["loss_nvs"])
    assert records[-1]["mode"] == "val"

    out = str(tmp_path / "metrics.json")
    run = _cli("test", SMOKE, ckpt, "--eval", "mAP", "nvs", "--device",
               "cpu", "--out", out, "--options", *_options(smoke_root))
    assert run.returncode == 0, run.stderr[-3000:]
    printed = json.loads(run.stdout[run.stdout.rindex("{"):])
    assert {"mAP_0.25", "mAR_0.25", "mAP_0.50", "mAR_0.50", "psnr",
            "ssim"} <= set(printed)
    assert all(np.isfinite(v) for v in printed.values())
    assert json.load(open(out))["psnr"] == printed["psnr"]

    # the port's checkpoint loads through init_detector
    saved = load_checkpoint(ckpt)
    assert saved["step"] == 2 and saved["epoch"] == 1
    assert load_meta(ckpt) == dict(epoch=1, config=SMOKE)
    model = api.init_detector(SMOKE, checkpoint=ckpt, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k


def test_train_cli_bf16_on_cpu(smoke_root, tmp_path, monkeypatch):
    """``--bf16`` trains at ``compute_dtype=bfloat16`` with the bf16 host
    streams, and keeps float32 weights in its checkpoint."""
    seen = {}
    init = api.init_trainer

    def spy(*args, **kwargs):
        seen.update(kwargs)
        return init(*args, **kwargs)

    monkeypatch.setattr(api, "init_trainer", spy)
    result = train_cli.main([SMOKE, "--bf16", "--work-dir",
                             str(tmp_path / "w"), "--max-steps", "1",
                             "--no-validate", "--device", "cpu",
                             "--options", *_options(smoke_root)])
    assert seen["compute_dtype"] == torch.bfloat16
    (step,) = result["history"]
    assert all(np.isfinite(step[k]) for k in step if k.startswith("loss"))
    saved = load_checkpoint(result["checkpoints"][0])
    assert all(v.dtype == torch.float32 for v in saved["model"].values()
               if v.is_floating_point())


def test_clis_need_cuda_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main([SMOKE, "--work-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        test_cli.main([SMOKE, str(tmp_path / "ckpt_1.pth")])
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 1.4"):
        train_cli.main([SMOKE, "--mesh-views", "2", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="torchrun"):  # no group to join
        train_cli.main([SMOKE, "--distributed", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="CUDA"):  # bfloat16 too
        train_cli.main([SMOKE, "--bf16", "--work-dir", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 1.4"):
        test_cli.main([SMOKE, "x.pth", "--mesh-views", "2"])
