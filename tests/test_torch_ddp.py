"""Data-parallel training and evaluation over processes, on the CPU (gloo).

The ranks are processes spawned with ``torch.multiprocessing`` or the
CLIs as subprocesses; they import the port and never JAX. The weights
and scenes are the toys of ``tests/test_torch_train.py`` (detection,
``rgb_supervision=False``) and ``tests/test_torch_train_nvs.py`` (the
joint step, here with ``loss_depth``), made in the test process (the
JAX weights through ``from_jax_variables``, computed once per test run)
and handed to the ranks as a numpy file. Those files hold the
one-process two-scene step against JAX's ``make_train_step``, so the
step over ranks is held to JAX through them.

* 2 ranks x 1 scene equal 1 process x 2 scenes: loss terms and
  grad_norm within 1e-6 relative; every gradient (reduced, then
  clipped) within 1e-6 of its tensor's max; the running statistics
  within 1e-6 and the parameters after the step within 1e-6 where the
  gradient is signal, by the rule of ``tests/test_torch_train.py``
  (elsewhere within 2 lr mult a step + 1e-6: AdamW's first steps move
  an element by ~lr sign(g), and where g sums to its rounding noise
  its sign is noise; the smoke run below has 4 such of 29 M elements
  off by 1.6e-6 to 3.5e-6); the two ranks' parameters bit for bit the
  same.
* n_pos is global: the scenes' positive counts differ, and a rank that
  divided by its own would miss the global ``loss_cls`` by far more than
  the tolerance.
* A group of one gives the step of no group, bit for bit.
* The loader's split: the ranks' index lists partition each global
  batch, in rank order the one-process batch; with one thread a rank
  every scene's random draws are the one-process run's (hypothesis over
  seeds, W in {1, 2, 3}, B in {1, 2}; and the written smoke dataset's
  scenes, bit for bit).
* The CLIs: ``tools/train --distributed --device cpu`` at 2 ranks for 2
  steps writes one checkpoint, one log and one metrics file, the
  checkpoint within 1e-6 of a one-process ``--batch-size 2`` run's (the
  parameters by the rule above, AdamW's first moment standing for the
  gradient; its moments within 1e-4 of their max);
  ``tools/test --distributed`` at 2 ranks (torchrun) prints the mAP JSON
  of world 1.
* Sharded ``run_eval`` twice in a row, with part files of the old
  on-disk merge left where it wrote them: each run's metrics equal its
  world-1 metrics exactly.

Each multi-process test waits at most 120 s for its ranks, then kills
them and fails.
"""

import json
import os
import pickle
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from hypothesis import given, settings
from hypothesis import strategies as st

from nerfdet_tpu_torch import api
from nerfdet_tpu_torch.config import Config
from nerfdet_tpu_torch.data.dataset import (ScanNetMultiViewDataset,
                                            build_dataset,
                                            ray_stats_spec_from_config,
                                            rgb_stats_spec_from_config)
from nerfdet_tpu_torch.data.loader import BatchLoader
from nerfdet_tpu_torch.data.synthetic import write_synthetic_scannet
from nerfdet_tpu_torch.models.nerfdet import NerfDet, SceneMeta
from nerfdet_tpu_torch.parallel import dist as pdist
from nerfdet_tpu_torch.train import optim as toptim
from nerfdet_tpu_torch.train.step import make_train_step
from nerfdet_tpu_torch.utils.checkpoint import load_checkpoint, \
    save_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "configs", "nerfdet", "nerfdet_smoke_synthetic.py")
JOIN_TIMEOUT = 120.0
THREADS = 2
# the toys' geometry (``tests/test_torch_train.py``,
# ``tests/test_torch_train_nvs.py``; the fixture checks they agree)
ORI, IMG, PAD = (128, 160), (31, 40), (32, 40)
N_VOX, VOX = (8, 8, 4), (0.8, 0.8, 0.8)
FPN_OUT, NECK3D_OUT, N_CLS, N_SCALES = 64, 16, 5, 3
N_RAND, N_SAMPLES, NEAR_FAR = 24, 16, (0.2, 8.0)
OPTIMIZER = dict(type="AdamW", lr=2e-4, weight_decay=1e-4,
                 paramwise_cfg=dict(custom_keys=dict(
                     backbone=dict(lr_mult=0.1, decay_mult=1.0))))
MAX_NORM = 35.0
LR = OPTIMIZER["lr"]
RAY_KEYS = ("ray_o", "ray_d", "gt_rgb", "gt_depth")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    """The ranks' thread count here too: a conv's float32 sums follow
    the threads' blocking."""
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


def _toy_model(kind):
    kw = (dict(n_samples=N_SAMPLES, n_rand=N_RAND, near_far_range=NEAR_FAR)
          if kind == "joint" else {})
    return NerfDet(
        fpn_out_channels=FPN_OUT, neck3d_out_channels=NECK3D_OUT,
        neck3d_n_blocks=(1, 1, 1), n_classes=N_CLS, n_scales=N_SCALES,
        n_voxels=N_VOX, voxel_size=VOX, nerf_density=True,
        meta=SceneMeta(ori_shape=ORI, img_shape=IMG, pad_shape=PAD), **kw)


def _toy_step(kind, model, group=None):
    opt = toptim.build_optimizer(model, OPTIMIZER,
                                 grad_clip=dict(max_norm=MAX_NORM))
    joint = kind == "joint"
    return make_train_step(model, opt, rgb_supervision=joint,
                           depth_supervise=joint, process_group=group)


def _load_case(path):
    """(kind, start state_dict, scenes) from a case file."""
    with np.load(path) as f:
        kind = str(f["kind"])
        start = {k[2:]: torch.from_numpy(f[k]) for k in f if k[:2] == "w:"}
        n = int(f["n_scenes"])
        scenes = [{k.split(":", 1)[1]: f[k] for k in f
                   if k.startswith(f"s{i}:")} for i in range(n)]
    return kind, start, scenes


def _stepped(kind, start, scenes, group=None):
    """One step of the toy from ``start`` on ``scenes``: the metrics,
    the gradients as the update read them and the state after it."""
    model = _toy_model(kind)
    model.load_state_dict(start, strict=True)
    metrics = _toy_step(kind, model, group)(api.train_batch(model, scenes))
    return dict(metrics={k: v.clone() for k, v in metrics.items()},
                grads={n: p.grad.clone()
                       for n, p in model.named_parameters()},
                state={k: v.clone() for k, v in model.state_dict().items()})


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(target, world, *args, meanwhile=None):
    """Run ``target(rank, world, port, *args)`` in ``world`` spawned
    processes, and ``meanwhile()`` here while they run; kill them and
    fail after ``JOIN_TIMEOUT``. Returns what ``meanwhile`` returns."""
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=target, args=(r, world, port, *args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_TIMEOUT
    try:
        result = meanwhile() if meanwhile is not None else None
    finally:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
    assert not alive, f"ranks still running after {JOIN_TIMEOUT} s, killed"
    assert [p.exitcode for p in procs] == [0] * world
    return result


def _train_rank(rank, world, port, case, out):
    torch.set_num_threads(THREADS)
    kind, start, scenes = _load_case(case)
    b = len(scenes) // world
    with pdist.process_group("cpu", f"localhost:{port}", world, rank) as (
            _, group):
        got = _stepped(kind, start, scenes[rank * b:(rank + 1) * b], group)
        if world == 1:  # the same step without a group
            got = dict(group=got, none=_stepped(kind, start, scenes))
    torch.save(got, os.path.join(out, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """The two toys' weights and scenes, as case files."""
    import tests.test_torch_train as det
    import tests.test_torch_train_nvs as joint
    from nerfdet_tpu_torch.utils.weight_convert import from_jax_variables

    for mod in (det, joint):
        assert (mod.ORI, mod.IMG, mod.PAD, mod.N_VOX, mod.VOX, mod.FPN_OUT,
                mod.NECK3D_OUT, mod.N_CLS, mod.N_SCALES) == (
            ORI, IMG, PAD, N_VOX, VOX, FPN_OUT, NECK3D_OUT, N_CLS, N_SCALES)
        assert mod.MAX_NORM == MAX_NORM
    assert det.OPTIMIZER == OPTIMIZER
    assert (joint.N_RAND, joint.N_SAMPLES, joint.NEAR_FAR) == (
        N_RAND, N_SAMPLES, NEAR_FAR)
    # detection: the scenes without rays (the step reads none of them)
    det_scenes = [{k: v for k, v in det._scene(s).items()
                   if k not in RAY_KEYS} for s in det.SCENE_SEEDS]
    joint_scenes = [joint._scene(s) for s in joint.SCENE_SEEDS]
    made = {
        "detection": (det.toy_variables(tmp_path_factory), det_scenes),
        "joint": (joint.toy_variables(tmp_path_factory, joint_scenes),
                  joint_scenes)}
    root = tmp_path_factory.mktemp("ddp_cases")
    paths = {}
    for kind, (variables, scenes) in made.items():
        arrays = {f"w:{k}": v.numpy()
                  for k, v in from_jax_variables(variables).items()}
        for i, s in enumerate(scenes):
            arrays.update({f"s{i}:{k}": np.asarray(v) for k, v in s.items()})
        paths[kind] = str(root / f"{kind}.npz")
        np.savez(paths[kind], kind=np.array(kind), n_scenes=len(scenes),
                 **arrays)
    return paths


def _load_ranks(d, world):
    """The ranks' results, their files removed (~0.23 GB a rank)."""
    out = []
    for r in range(world):
        path = os.path.join(d, f"rank{r}.pt")
        out.append(torch.load(path))
        os.remove(path)
    return out


@pytest.fixture(scope="module")
def two_ranks(cases, tmp_path_factory):
    """Per toy: the step over 2 ranks (1 scene each), and 1 process
    stepping both scenes."""
    out = {}
    for kind, case in cases.items():
        d = str(tmp_path_factory.mktemp(f"ddp_{kind}"))
        _, start, scenes = _load_case(case)
        one = _spawn(_train_rank, 2, case, d,
                     meanwhile=lambda: _stepped(kind, start, scenes))
        out[kind] = dict(ranks=_load_ranks(d, 2), one=one, start=start,
                         scenes=scenes)
    return out


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _max_err(got, want):
    """max |got - want| over the largest |want| of the tensor."""
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def _check_state(got, want, signal, steps):
    """The parameters within 1e-6 where ``signal`` (the gradient, or a
    stand-in for it, by name) is at least 1e-3 of its tensor's max, else
    within ``steps`` x 2 lr mult + 1e-6; the buffers within 1e-6 of
    their largest value (at least 1)."""
    for k, v in want.items():
        err = (got[k].double() - v.double()).abs()
        if k not in signal:
            assert float(err.max()) <= 1e-6 * max(
                float(v.abs().max()), 1.0), k
            continue
        mult = 0.1 if k.startswith("backbone.") else 1.0
        g = signal[k].abs()
        strong = g >= 1e-3 * float(g.max())
        if bool(strong.any()):
            assert float(err[strong].max()) <= 1e-6, k
        assert float(err.max()) <= steps * 2 * LR * mult + 1e-6, k


@pytest.mark.parametrize("kind", ["detection", "joint"])
def test_two_ranks_match_one_process(two_ranks, kind):
    run = two_ranks[kind]
    one, ranks = run["one"], run["ranks"]
    for r in ranks:
        assert set(r["metrics"]) == set(one["metrics"])
        for k, v in one["metrics"].items():
            assert _rel(r["metrics"][k], v) <= 1e-6, (k, r["metrics"][k], v)
        for name, g in one["grads"].items():
            assert _max_err(r["grads"][name], g) <= 1e-6, name
        _check_state(r["state"], one["state"], one["grads"], 1)
    for k, v in ranks[0]["state"].items():
        assert torch.equal(v, ranks[1]["state"][k]), k
    if kind == "joint":
        assert float(one["metrics"]["loss_depth"]) > 0
        assert float(one["metrics"]["loss_nvs"]) > 0
    else:
        assert float(one["metrics"]["grad_norm"]) > MAX_NORM  # clipped
    moved = [k for k in one["state"] if k.endswith("running_mean")
             and not torch.equal(one["state"][k], run["start"][k])]
    assert moved  # the running statistics were averaged, not kept


def test_n_pos_is_the_global_mean(two_ranks):
    """The two detection scenes have different positive counts; the loss
    over ranks divides by their mean, and a rank dividing by its own
    count would be far outside the tolerance of the test above."""
    run = two_ranks["detection"]
    model = _toy_model("detection")
    model.load_state_dict(run["start"], strict=True)
    model.train()
    from nerfdet_tpu_torch.train.step import scene_loss_terms
    with torch.no_grad():
        terms = [scene_loss_terms(model, b, rgb_supervision=False)
                 for b in api.train_batch(model, run["scenes"])]
    n = [float(t["n_pos"]) for t in terms]
    cls = [float(t["cls_sum"]) for t in terms]
    assert n[0] != n[1] and min(n) >= 1
    global_cls = (cls[0] + cls[1]) / 2 / ((n[0] + n[1]) / 2)
    local_cls = (cls[0] / n[0] + cls[1] / n[1]) / 2
    got = float(run["ranks"][0]["metrics"]["loss_cls"])
    assert float(run["ranks"][0]["metrics"]["n_pos"]) == (n[0] + n[1]) / 2
    assert _rel(got, global_cls) <= 1e-5
    assert _rel(local_cls, global_cls) > 1e-3


def test_a_group_of_one_is_bitwise_no_group(cases, tmp_path):
    _spawn(_train_rank, 1, cases["joint"], str(tmp_path))
    (got,) = _load_ranks(str(tmp_path), 1)
    with_group, without = got["group"], got["none"]
    for part in ("metrics", "grads", "state"):
        assert set(with_group[part]) == set(without[part])
        for k, v in without[part].items():
            assert torch.equal(with_group[part][k], v), (part, k)


# ---------------------------------------------------------------------
# the loader's split
# ---------------------------------------------------------------------

class _Seeded:
    """Scenes that each draw their seed from one shared stream, as the
    train-mode dataset does, with its ``skip_seeds``."""

    test_mode = False
    skip_seeds = ScanNetMultiViewDataset.skip_seeds

    def __init__(self, n, seed):
        self.n = n
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return (int(i), int(self._rng.randint(0, 2 ** 31 - 1)))


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 16), world=st.sampled_from([1, 2, 3]),
       b=st.sampled_from([1, 2]), n=st.integers(1, 13))
def test_loader_splits_each_global_batch_over_the_ranks(seed, world, b, n):
    one = BatchLoader(_Seeded(n, seed + 1), batch_size=world * b,
                      num_workers=1, seed=seed)
    ranks = [BatchLoader(_Seeded(n, seed + 1), batch_size=b, num_workers=1,
                         seed=seed, rank=r, world=world)
             for r in range(world)]
    assert all(len(r) == len(one) == n // (world * b) for r in ranks)
    for _ in range(2):  # the order reshuffles, the seed stream goes on
        want = list(one)
        got = [list(r) for r in ranks]
        for i, batch in enumerate(want):
            shares = [g[i] for g in got]
            assert all(len(s) == b for s in shares)
            assert sum(shares, []) == batch  # indices and draws


def test_two_ranks_load_the_one_process_scenes(smoke):
    """The written smoke set, one loader thread a rank: the scenes of 2
    ranks at 1 a rank are those of 1 process at 2, bit for bit."""
    cfg = Config.fromfile(SMOKE)
    cfg.merge_from_options(smoke["options"])

    def loader(batch, rank=0, world=1):
        ds = build_dataset(cfg.data["train"], n_rand=cfg.model["N_rand"],
                           rgb_stats_spec=rgb_stats_spec_from_config(cfg),
                           ray_stats_spec=ray_stats_spec_from_config(cfg))
        return list(BatchLoader(ds, batch_size=batch, num_workers=1, seed=3,
                                rank=rank, world=world))

    one = loader(2)
    ranks = [loader(1, r, 2) for r in (0, 1)]
    assert len(one) == 2
    for i, batch in enumerate(one):
        for scene, got in zip(batch, [ranks[0][i][0], ranks[1][i][0]]):
            assert set(got) == set(scene)
            for k in scene:
                np.testing.assert_array_equal(got[k], scene[k], err_msg=k)


# ---------------------------------------------------------------------
# the CLIs and the sharded eval
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """The smoke config's dataset: four scenes a split, and a checkpoint
    of its random weights."""
    root = write_synthetic_scannet(
        str(tmp_path_factory.mktemp("smoke")), n_scenes=4, n_images=8,
        hw=(240, 320))
    ckpt = save_checkpoint(
        str(tmp_path_factory.mktemp("smoke_ckpt")), 1,
        dict(model=api.init_detector(SMOKE, device="cpu").state_dict(),
             optimizer={}))
    options = [f"data.{split}.{k}={root}/{v}"
               for split, ann in (("train", "train"), ("val", "val"),
                                  ("test", "val"))
               for k, v in (("data_root", ""),
                            ("ann_file", f"scannet_infos_{ann}.pkl"))]
    # every candidate scored, so the metrics hold detections
    return dict(root=root, ckpt=ckpt,
                options=options + ["test_cfg.score_thr=0.0"])


def _run(commands, cwd):
    """Run ``commands`` at once; (returncode, stdout, stderr) of each.
    Kill them all and fail after ``JOIN_TIMEOUT``."""
    env = dict(os.environ, OMP_NUM_THREADS=str(THREADS))
    procs = [subprocess.Popen(c, cwd=cwd, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              start_new_session=True) for c in commands]
    deadline = time.monotonic() + JOIN_TIMEOUT
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic())))
    except subprocess.TimeoutExpired:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
        pytest.fail(f"{commands} still running after {JOIN_TIMEOUT} s, "
                    f"killed")
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


def _cli(module):
    return [sys.executable, "-m", f"nerfdet_tpu_torch.tools.{module}"]


def _torchrun(n):
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", str(n)]


def test_train_cli_over_two_ranks(smoke, tmp_path):
    port = _free_port()
    args = [SMOKE, "--max-steps", "2", "--device", "cpu", "--no-validate",
            "--options", *smoke["options"]]
    ranks = [_cli("train") + [
        "--work-dir", str(tmp_path / "two"), "--distributed",
        "--coordinator", f"localhost:{port}", "--num-processes", "2",
        "--process-id", str(r)] + args for r in (0, 1)]
    one = _cli("train") + ["--work-dir", str(tmp_path / "one"),
                           "--batch-size", "2"] + args
    runs = _run(ranks + [one], ROOT)
    for code, _, err in runs:
        assert code == 0, err[-3000:]
    two = tmp_path / "two"
    assert sorted(os.listdir(two / "ckpts")) == ["ckpt_1.pth"]
    assert len([f for f in os.listdir(two) if f.endswith(".log")]) == 1
    records = [json.loads(line) for line in open(two / "metrics.jsonl")]
    assert [r["step"] for r in records] == [2]
    got = load_checkpoint(str(two / "ckpts" / "ckpt_1.pth"))
    want = load_checkpoint(str(tmp_path / "one" / "ckpts" / "ckpt_1.pth"))
    assert got["step"] == want["step"] == 2
    assert set(got["model"]) == set(want["model"])
    # AdamW's state in the optimizer's order: the main group, then the
    # backbone's (``train/optim.py``)
    labels = toptim.param_labels(api.init_detector(SMOKE, device="cpu"))
    order = [n for group in ("main", "backbone")
             for n, label in labels.items() if label == group]
    moments = {}
    for i, state in want["optimizer"]["adamw"]["state"].items():
        moments[order[int(i)]] = state["exp_avg"]
        for key in ("exp_avg", "exp_avg_sq"):
            other = got["optimizer"]["adamw"]["state"][i][key]
            assert _max_err(other, state[key]) <= 1e-4, (order[int(i)], key)
    _check_state(got["model"], want["model"], moments, 2)
    mine = json.loads(open(tmp_path / "one" / "metrics.jsonl").readline())
    for k in ("loss", "loss_cls", "loss_nvs", "grad_norm"):
        assert _rel(records[0][k], mine[k]) <= 1e-5, k


def test_test_cli_over_two_ranks_prints_world_one_metrics(smoke, tmp_path):
    args = [SMOKE, smoke["ckpt"], "--eval", "mAP", "--device", "cpu",
            "--options", *smoke["options"]]
    (c2, out2, err2), (c1, out1, err1) = _run(
        [_torchrun(2) + ["-m", "nerfdet_tpu_torch.tools.test",
                         "--distributed"] + args,
         _cli("test") + args], ROOT)
    assert c2 == 0, err2[-3000:]
    assert c1 == 0, err1[-3000:]
    printed = out1[out1.rindex("{"):]
    assert out2.count('"mAP_0.25"') == 1  # rank 0 alone prints
    assert out2[out2.rindex("{"):] == printed


def _smoke_eval(cfg, ds, group=None):
    """``run_eval`` of the smoke detector at two seeds on ``ds``, and the
    per-scene detections each run scored (rank 0; [] elsewhere)."""
    scored = []
    evaluate = ds.evaluate

    def keep(results, **kwargs):
        scored.append(results)
        return evaluate(results, **kwargs)

    ds.evaluate = keep
    metrics = [api.run_eval(api.init_detector(cfg, device="cpu", seed=s), ds,
                            dict(cfg.test_cfg), progress=False,
                            process_group=group) for s in (0, 1)]
    return metrics, scored


def _eval_rank(rank, world, port, options, out):
    torch.set_num_threads(THREADS)
    cfg = Config.fromfile(SMOKE)
    cfg.merge_from_options(options)
    ds = build_dataset(cfg.data["test"], test_mode=True,
                       rgb_stats_spec=rgb_stats_spec_from_config(cfg))
    os.chdir(out)  # where the stale parts lie
    with pdist.process_group("cpu", f"localhost:{port}", world, rank) as (
            _, group):
        got = _smoke_eval(cfg, ds, group)
    if rank == 0:
        with open(os.path.join(out, "got.pkl"), "wb") as f:
            pickle.dump(got, f)


def test_sharded_run_eval_ignores_stale_part_files(smoke, tmp_path):
    """Two sharded runs of other weights in a row, with an old run's part
    files (the on-disk merge's ``parts/part_{r}.pkl``) left in the
    working directory: each scores the detections of world 1, scene for
    scene and bit for bit, and gives its metrics."""
    stale = tmp_path / "parts"
    stale.mkdir()
    for r in (0, 1):
        with open(stale / f"part_{r}.pkl", "wb") as f:
            pickle.dump([(i, None) for i in range(r, 4, 2)], f)
    cfg = Config.fromfile(SMOKE)
    cfg.merge_from_options(smoke["options"])
    ds = build_dataset(cfg.data["test"], test_mode=True,
                       rgb_stats_spec=rgb_stats_spec_from_config(cfg))
    want, want_scored = _spawn(_eval_rank, 2, smoke["options"],
                               str(tmp_path),
                               meanwhile=lambda: _smoke_eval(cfg, ds))
    with open(tmp_path / "got.pkl", "rb") as f:
        got, got_scored = pickle.load(f)
    assert got == want
    assert len(got_scored) == len(want_scored) == 2
    n_dets = 0
    for run_got, run_want in zip(got_scored, want_scored):
        assert len(run_got) == len(run_want) == len(ds) == 4
        for a, b in zip(run_got, run_want):
            assert set(a) == set(b)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            n_dets += len(b["labels_3d"])
    assert n_dets > 0
    assert any(not np.array_equal(a["scores_3d"], b["scores_3d"])
               for a, b in zip(*want_scored))  # the two runs differ
