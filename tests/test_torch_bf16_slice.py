"""The port's bfloat16 slice against the JAX package's ``--bf16`` path,
whole, on the CPU: detection, rendering and the joint detection + NVS
train step of a toy NeRF-Det (ResNet-50 at 32x40 images, three views, a
16x16x8 volume of 0.4 m voxels, FPN 64, 24 rays of 16 samples a scene)
at ``compute_dtype=bfloat16``.

The bar (the issue's, for a path whose roundings cannot all be
replayed): on every continuous quantity the port's bfloat16 result lies
closer to JAX's bfloat16 result than JAX's bfloat16 lies to JAX's
float32, by at least 2x; distances are relative L2 norms, and each ratio
is printed (``-s``). That shows the port computes the bfloat16 semantics
and not float32's. What keeps the two bfloat16 runs apart: a conv's
float32 accumulation order (cuDNN's or the CPU's against XLA's) moves an
output across a bfloat16 rounding boundary now and then, and each such
ulp spreads through the later layers (``tests/test_torch_bf16.py`` holds
single layers to one ulp). A head output is one quantity over its three
scales (the per-scale ratios are printed too): the coarsest scale holds
4x4x2 voxels, where bfloat16 barely moves JAX's result beyond its final
rounding and a single ulp of the port's decides the ratio. The
candidates' scores and boxes are compared before the top-k (every voxel
a candidate), whose indices are discrete. Discrete outputs match
exactly: the view counts, the ray masks, the candidates' top-k indices
(except where a score lies within the port's largest score deviation of
the k-th, which one ulp of a logit makes ~3%) and the positives' count.
The gradients are one quantity a module (backbone, FPN, 3D neck, head,
NeRF MLP, mapping), the running statistics one in all; each tensor's
ratio is printed, and each must be at least 1 (the port no farther from
JAX's bfloat16 gradient than that is from float32's): a tensor of a few
dozen values deep in the neck, whose bfloat16 gradient JAX barely moves,
reads 1.7 there. The parameters after one step are compared only where
JAX's bfloat16
gradient lies farther from 0 than twice the port's distance to it on
that tensor, and than 1000 x AdamW's epsilon: the first step is close to
``lr * sign(g)``, so a gradient whose sign the noise can flip says
nothing, and one near epsilon moves the step by its own noise.

JAX runs compiled with ``xla_allow_excess_precision`` off (see
``tests/test_torch_bf16.py``); its float32 reference runs compiled with
XLA's defaults. The volume is finer than the float32 toys' (8x8x4 of
0.8 m) and the head's kernels are scaled by 5 from their init, not by
20: there, two positive voxels a scene carried the box loss, whose
ratio was then a coin toss (0.66 and 0.87 on the two toys tried), and at
20 the predicted boxes are metres wide, every IoU near 0. No seed was
chosen for the result.
"""

import ctypes
import gc

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerfdet_tpu.nn.heads import get_candidate_bboxes as jax_candidates
from nerfdet_tpu.ops.voxel import host_rgb_stats as jax_host_rgb_stats
from nerfdet_tpu.train import TrainState, make_train_step as jax_train_step
from nerfdet_tpu.train import optim as joptim

from nerfdet_tpu_torch import api
from nerfdet_tpu_torch.data import ray_stats
from nerfdet_tpu_torch.models.nerfdet import NerfDet, SceneMeta
from nerfdet_tpu_torch.nn.heads import _top_k_ids, get_candidate_bboxes
from nerfdet_tpu_torch.train import optim as toptim
from nerfdet_tpu_torch.train.step import make_train_step
from nerfdet_tpu_torch.utils.weight_convert import from_jax_variables

from nerfdet_tpu.models.nerfdet import NerfDet as JaxNerfDet
from nerfdet_tpu.models.nerfdet import SceneMeta as JaxSceneMeta
from tests.test_torch_session_cache import computed_once
from tests.test_torch_train import OPTIMIZER, _capture, _port_tree
from tests.test_torch_train_nvs import (FPN_OUT, IMG, JAX_KEYS, MAX_NORM,
                                        NEAR_FAR, NECK3D_OUT, N_CLS, N_RAND,
                                        N_SAMPLES, N_SCALES, ORI, PAD,
                                        RAY_SEED, SCENE_SEEDS, _raw_scene)

BF16 = jnp.bfloat16
N_VOX, VOX = (16, 16, 8), (0.4, 0.4, 0.4)
NMS_PRE = 100
ADAM_EPS = 1e-8  # optax.adamw's default, the optimizer of OPTIMIZER
EVAL_KEYS = ("imgs", "denorm_images", "intrinsic", "extrinsics", "origin",
             "rgb_s1", "rgb_s2", "ray_o", "ray_d")


def _perturb(tree, rng, path=()):
    """Random norms, biases and head scales; head kernels x5."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out[k] = _perturb(dict(v), rng, path + (k,))
            continue
        v = np.asarray(v, np.float32)
        if k in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k in ("bias", "mean"):
            v = (v + rng.normal(0, 0.1, v.shape)).astype(np.float32)
        elif k == "scales":
            v = rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
        elif k == "kernel" and "bbox_head" in path:
            v = v * 5.0
        out[k] = v
    return out


def _scene(seed, bf16):
    """A training scene with its host rgb sums and ray stream in the
    given precision."""
    s = _raw_scene(seed)
    s1, s2 = jax_host_rgb_stats(s["denorm_images"], s["intrinsic"],
                                s["extrinsics"], s["origin"], N_VOX, VOX,
                                ORI, IMG, compute_dtype=BF16 if bf16
                                else jnp.float32)
    return ray_stats.prepare_rays(
        dict(s, rgb_s1=np.asarray(s1), rgb_s2=np.asarray(s2)),
        np.random.RandomState(RAY_SEED + seed), N_RAND, NEAR_FAR,
        N_SAMPLES, ORI, IMG,
        compute_dtype="bfloat16" if bf16 else "float32")


def _compiled(fn, *args, exact=True):
    opts = {"xla_allow_excess_precision": False} if exact else None
    return jax.jit(fn).lower(*args).compile(compiler_options=opts)(*args)


def _release():
    """Drop JAX's compiled executables and hand the freed heap back, so
    the file's peak memory is one compiled train step's, not the sum of
    four graphs'."""
    jax.clear_caches()
    gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(a, b):
    a, b = _f32(a).astype(np.float64), _f32(b).astype(np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _ratio(name, port, j16, j32):
    """JAX bf16's distance to JAX f32 over the port's distance to JAX
    bf16; printed."""
    d_port, d_ref = _rel(port, j16), _rel(j16, j32)
    ratio = d_ref / max(d_port, 1e-30)
    print(f"[bf16] {name}: port-jax16 {d_port:.3g}, jax16-jax32 "
          f"{d_ref:.3g}, ratio {ratio:.2f}")
    return ratio


def _jax_model():
    return JaxNerfDet(
        backbone_depth=50, fpn_out_channels=FPN_OUT,
        neck3d_out_channels=NECK3D_OUT, neck3d_n_blocks=(1, 1, 1),
        n_classes=N_CLS, n_scales=N_SCALES, n_voxels=N_VOX,
        voxel_size=VOX, n_samples=N_SAMPLES, n_rand=N_RAND,
        near_far_range=NEAR_FAR, nerf_density=True,
        meta=JaxSceneMeta(ori_shape=ORI, img_shape=IMG, pad_shape=PAD))


def _port_model():
    return NerfDet(
        fpn_out_channels=FPN_OUT, neck3d_out_channels=NECK3D_OUT,
        neck3d_n_blocks=(1, 1, 1), n_classes=N_CLS, n_scales=N_SCALES,
        n_voxels=N_VOX, voxel_size=VOX, n_samples=N_SAMPLES, n_rand=N_RAND,
        near_far_range=NEAR_FAR, nerf_density=True,
        meta=SceneMeta(ori_shape=ORI, img_shape=IMG, pad_shape=PAD),
        compute_dtype=torch.bfloat16)


def _jax_models():
    jm = {0: _jax_model()}
    jm[1] = jm[0].clone(compute_dtype=BF16)
    return jm


def _jax_reference(scenes):
    """The weights, JAX's joint step on both scenes and its eval of scene
    0, each at float32 and at bfloat16."""
    jm = _jax_models()
    init = {k: jnp.asarray(scenes[0][0][k]) for k in JAX_KEYS}
    variables = jax.jit(lambda k: jm[0].init(k, init, train=False))(
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    variables = {"params": _perturb(dict(variables["params"]), rng),
                 "batch_stats": _perturb(dict(variables["batch_stats"]),
                                         rng)}

    # one joint train step on both scenes
    steps = {}
    for bf in (0, 1):
        batch = {k: np.stack([s[k] for s in scenes[bf]]) for k in JAX_KEYS}
        tx = optax.chain(_capture(), joptim.build_optimizer(
            variables["params"], OPTIMIZER,
            grad_clip=dict(max_norm=MAX_NORM)))
        state = TrainState.create(variables["params"],
                                  variables["batch_stats"], tx)
        step = jax_train_step(jm[bf], tx, rgb_supervision=True, donate=False)
        new, metrics = _compiled(step, state, batch, jax.random.PRNGKey(0),
                                 exact=bool(bf))
        metrics = {k: float(v) for k, v in metrics.items()}
        raw = jax.device_get(new.opt_state[0])  # the captured gradients
        kept = jax.device_get((new.params, new.batch_stats))
        del new, state, step, tx
        _release()
        # optax's clip_by_global_norm, on the host
        norm, top = np.float32(metrics["grad_norm"]), np.float32(MAX_NORM)
        grads = jax.tree_util.tree_map(
            lambda t: t if norm < top else (t / norm) * top, raw)
        zero = jax.tree_util.tree_map(np.zeros_like,
                                      variables["batch_stats"])
        params = _port_tree(*kept)
        if not bf:  # of float32's, only the running statistics are read
            params = {k: v for k, v in params.items()
                      if k.endswith(("running_mean", "running_var"))}
        steps[bf] = dict(metrics=metrics, grads=_port_tree(grads, zero),
                         params=params)
        del raw, kept, grads, params
        _release()

    # detection + the eval render of scene 0's rays
    evals = {}
    for bf in (0, 1):
        batch = {k: jnp.asarray(scenes[bf][0][k]) for k in EVAL_KEYS}
        evals[bf] = _compiled(lambda v, b, m=jm[bf]: m.apply(
            v, b, train=False, with_rays=True), variables, batch,
            exact=bool(bf))
        _release()
    return dict(variables=variables, steps=steps, evals=evals)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    scenes = {bf: [_scene(s, bf) for s in SCENE_SEEDS] for bf in (0, 1)}
    ref = computed_once(tmp_path_factory, "torch_bf16_slice_jax",
                        lambda: _jax_reference(scenes))
    steps, evals = ref["steps"], ref["evals"]
    start = from_jax_variables(ref["variables"])
    del ref

    # the port: the same eval, then the same step
    model = _port_model()
    model.load_state_dict(start, strict=True)
    model.eval()
    scene = scenes[1][0]
    batch = {**api.device_batch(model, scene),
             **api.render_batch(model, scene)}
    with torch.inference_mode():
        port_eval = model(batch)
    points = model.mlvl_points(batch["origin"])

    model.load_state_dict(start, strict=True)
    opt = toptim.build_optimizer(model, OPTIMIZER,
                                 grad_clip=dict(max_norm=MAX_NORM))
    metrics = make_train_step(model, opt)(api.train_batch(model, scenes[1]))
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad.clone())
             for n, p in model.named_parameters()}
    labels = toptim.param_labels(model)
    del opt
    yield dict(jm=_jax_models(), evals=evals, port_eval=port_eval,
               points=points,
               steps=steps, start=start,
               port_step=dict(metrics={k: float(v) for k, v in
                                       metrics.items()},
                              grads=grads, params=model.state_dict()),
               labels=labels)
    torch.set_num_threads(n_threads)


def _flat(outs, k):
    return np.concatenate([_f32(o[k]).reshape(-1) for o in outs])


def test_bf16_detection_matches_jax(toy):
    (head_t, valid_t, _), ev = toy["port_eval"], toy["evals"]
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(ev[1][1]))
    np.testing.assert_array_equal(np.asarray(ev[0][1]), np.asarray(ev[1][1]))
    for k, name in enumerate(("centerness", "bbox_pred", "cls_score")):
        for s in range(N_SCALES):
            got = head_t[s][k]
            assert got.dtype == torch.bfloat16
            assert np.isfinite(_f32(got)).all()
            _ratio(f"scale {s} {name}", got, ev[1][0][s][k], ev[0][0][s][k])
        assert _ratio(f"{name}, every scale", _flat(head_t, k),
                      _flat(ev[1][0], k), _flat(ev[0][0], k)) >= 2


def test_bf16_candidates_match_jax(toy):
    """The candidates' scores and boxes (every voxel of every scale), and
    the top-k indices that pick nms_pre of them at scale 0."""
    (head_t, valid_t, _), ev = toy["port_eval"], toy["evals"]
    points = toy["points"]
    got = get_candidate_bboxes(head_t, valid_t, points, 0, N_CLS)
    want = {bf: jax_candidates(ev[bf][0], ev[bf][1],
                               [jnp.asarray(p.numpy()) for p in points],
                               0, N_CLS) for bf in (0, 1)}
    assert got[1].dtype == torch.bfloat16
    for k, name in enumerate(("boxes", "scores")):
        assert _ratio(f"candidate {name}", got[k], want[1][k],
                      want[0][k]) >= 2
    c, s = head_t[0][0], head_t[0][2]
    mx = (torch.sigmoid(s.reshape(-1, N_CLS))
          * torch.sigmoid(c.reshape(-1))[:, None]).max(1).values
    cj, sj = ev[1][0][0][0], ev[1][0][0][2]
    mj = (jax.nn.sigmoid(sj.reshape(-1, N_CLS))
          * jax.nn.sigmoid(cj.reshape(-1))[:, None]).max(1)
    ids_t = set(_top_k_ids(mx, NMS_PRE).tolist())
    ids_j = set(np.asarray(jax.lax.top_k(mj, NMS_PRE)[1]).tolist())
    mj = _f32(mj)
    kth = float(np.sort(mj)[-NMS_PRE])
    bound = float(np.abs(_f32(mx) - mj).max())
    print(f"[bf16] top-{NMS_PRE}: {len(ids_t ^ ids_j)} indices swapped, "
          f"scores within {bound:.3g} of JAX's, k-th {kth:.3g}")
    assert bound <= 0.05 * kth
    for i in ids_t ^ ids_j:
        assert abs(float(mj[i]) - kth) <= bound, i
    assert len(ids_t ^ ids_j) <= 0.1 * NMS_PRE


def test_bf16_render_matches_jax(toy):
    (_, _, out_t), ev = toy["port_eval"], toy["evals"]
    assert out_t["rgb"].dtype == torch.bfloat16
    assert out_t["depth"].dtype == torch.float32
    np.testing.assert_array_equal(out_t["mask"].numpy(),
                                  np.asarray(ev[1][2]["mask"]))
    assert 0 < out_t["mask"].float().mean() < 1
    for key in ("rgb", "depth"):
        assert np.isfinite(_f32(out_t[key])).all()
        assert _ratio(f"render {key}", out_t[key], ev[1][2][key],
                      ev[0][2][key]) >= 2


def test_bf16_joint_step_losses_match_jax(toy):
    got, j16 = toy["port_step"]["metrics"], toy["steps"][1]["metrics"]
    j32 = toy["steps"][0]["metrics"]
    assert set(got) == set(j16)
    assert got["n_pos"] == j16["n_pos"] > 0 and got["loss_nvs"] > 0
    for k in ("loss", "loss_cls", "loss_bbox", "loss_centerness",
              "loss_nvs", "grad_norm"):
        assert np.isfinite(got[k])
        assert _ratio(k, np.float32(got[k]), np.float32(j16[k]),
                      np.float32(j32[k])) >= 2, k


MODULES = ("backbone.", "neck.", "neck_3d.", "bbox_head.", "nerf_mlp.",
           "mapping.")


def test_bf16_joint_step_gradients_match_jax(toy):
    grads = toy["port_step"]["grads"]
    j16, j32 = toy["steps"][1]["grads"], toy["steps"][0]["grads"]
    ratios = []
    for name, g in grads.items():
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), name
        assert name.startswith(MODULES), name
        if float(j32[name].norm()) == 0:  # frozen by the graph: no path
            assert float(g.norm()) == float(j16[name].norm()) == 0, name
            continue
        d_port, d_ref = _rel(g, j16[name]), _rel(j16[name], j32[name])
        ratios.append((d_ref / max(d_port, 1e-30), name))
    ratios.sort()
    for r, name in ratios:
        print(f"[bf16] gradient {name}: ratio {r:.2f}")
    assert ratios[0][0] >= 1, ratios[0]
    for module in MODULES:
        names = [n for n in grads if n.startswith(module)]
        assert _ratio(f"gradients of {module[:-1]}",
                      *(np.concatenate([_f32(t[n]).reshape(-1)
                                        for n in names])
                        for t in (grads, j16, j32))) >= 2
    # the NVS loss reaches mapping and the FPN through K2's backward
    for name in ("mapping.0.weight", "neck.lateral_convs.0.conv.weight",
                 "nerf_mlp.mlp.rgb_layer.output_layer.weight"):
        assert float(grads[name].abs().max()) > 0, name


def test_bf16_joint_step_parameters_match_jax(toy):
    """Where JAX's bfloat16 gradient is signal (see the module docstring),
    the updated parameters agree within 1e-6; frozen ones are unchanged;
    the running statistics as every continuous quantity."""
    state, want = toy["port_step"]["params"], toy["steps"][1]["params"]
    grads, j16 = toy["port_step"]["grads"], toy["steps"][1]["grads"]
    compared = 0
    for name, label in toy["labels"].items():
        before, after = toy["start"][name], state[name]
        if label == "frozen":
            assert torch.equal(after, before), name
            continue
        bound = max(2 * float((grads[name] - j16[name]).abs().max()),
                    1e3 * ADAM_EPS)
        signal = j16[name].abs() > bound
        if bool(signal.any()):
            err = (after - want[name]).abs()[signal]
            assert float(err.max()) <= 1e-6, name
            compared += int(signal.sum())
    assert compared > 1000
    stats = [k for k in state if k.endswith(("running_mean",
                                              "running_var"))]
    j32 = toy["steps"][0]["params"]
    assert _ratio("running statistics", *(np.concatenate(
        [_f32(t[k]).reshape(-1) for k in stats]) for t in (state, want, j32))
    ) >= 2
