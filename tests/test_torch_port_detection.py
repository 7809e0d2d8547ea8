"""The port's MaskRCNNLite (`models/detection.py`) against the JAX module.

Both trunks ("lite" and the torchvision-layout ResNet-50) at 64 px, batch 2,
the Flax variables carried across (`load_flax_variables`): every output
(ground-truth prompts and predicted-box prompts) within 1e-5 of its largest
entry in fp32, the top-K labels and the score-ranked detections identical
(on tied objectness too: ties go to the lower index, as `lax.top_k`
decides them; with predicted-box prompts the masks and IoUs within 5e-5),
the loss and its five parts within 1e-5 relative; one
training step's gradients and BatchNorm statistics in float64
(`jax.enable_x64`, `.double()`: Flax's one-pass batch variance would
otherwise set the bar; the JAX trunk built in float64), within 1e-7 of
each tensor's largest gradient. Also
the nearest upsample against `jax.image.resize`, the registry's "maskrcnn"
and the experiment (2 steps into `tmp_path`).
"""

import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import equiadapt_tpu.models.detection as jdet
import equiadapt_tpu.models.resnet as jresnet
import equiadapt_tpu.utils.registry as jreg
import equiadapt_tpu_torch as tp
import equiadapt_tpu_torch.models.detection as tdet
import equiadapt_tpu_torch.utils.registry as treg
from equiadapt_tpu_torch.cli import maskrcnn_lite_experiment as experiment
from equiadapt_tpu_torch.utils.jax_weights import flax_placements
from torch_port_cpu import one_intra_op_thread  # noqa: F401

B, SIZE, N, CLASSES = 2, 64, 4, 5


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(B, SIZE, SIZE, 3)).astype(np.float32)
    x1 = rng.uniform(4, SIZE // 2, size=(B, N))
    y1 = rng.uniform(4, SIZE // 2, size=(B, N))
    boxes = np.stack([x1, y1, x1 + SIZE // 4, y1 + SIZE // 4], -1).astype(np.float32)
    masks = np.zeros((B, N, SIZE, SIZE), np.float32)
    for i in range(B):
        for j in range(N):
            xa, ya, xb, yb = boxes[i, j].astype(int)
            masks[i, j, ya:yb, xa:xb] = 1.0
    valid = np.ones((B, N), np.float32)
    valid[1, 3] = 0.0
    targets = {"boxes": boxes, "masks": masks, "valid": valid,
               "labels": rng.integers(0, CLASSES, size=(B, N)).astype(np.int32)}
    return images, targets


def random_variables(module, seed=0):
    """Flax variables of `module` drawn from `seed` at the shapes
    `jax.eval_shape` gives (no eager Flax init): kernels N(0, 1 / fan_in),
    biases and running means 0.1 N(0, 1), scales and variances U(0.5, 1.5),
    other parameters N(0, 1)."""
    rng = np.random.default_rng(seed)
    images, targets = _batch()
    shapes = jax.eval_shape(module.init, jax.random.key(0), jnp.asarray(images),
                            jnp.asarray(targets["boxes"]))

    def draw(path, s):
        name = path[-1].key
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, s.shape).astype(s.dtype)
        if name in ("mean", "bias"):
            return (0.1 * rng.normal(size=s.shape)).astype(s.dtype)
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(s.dtype)
        return rng.normal(size=s.shape).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def _models(trunk, seed=0):
    jm = jdet.MaskRCNNLite(num_classes=CLASSES, max_instances=N, channels=32,
                           backbone=trunk)
    variables = random_variables(jm, seed)
    tm = tdet.MaskRCNNLite(num_classes=CLASSES, max_instances=N, channels=32,
                           backbone=trunk, device="cpu")
    tp.load_flax_variables(tm, variables)
    return jm, variables, tm


def _japply(jm, variables, images, boxes=None):
    """The JAX module's eval forward, jitted (eager Flax takes seconds)."""
    fn = jax.jit(lambda v, x, b: jm.apply(v, x, b))
    out = fn(variables, jnp.asarray(images), None if boxes is None else jnp.asarray(boxes))
    return {k: (v if k == "stride" else np.asarray(v)) for k, v in out.items()}


@pytest.fixture(scope="module", params=["lite", "resnet50"])
def models(request):
    return request.param, _models(request.param)


def _close(ours, ref, rel=1e-5):
    ref = np.asarray(ref, np.float64)
    err = np.abs(np.asarray(ours, np.float64) - ref).max()
    assert err <= rel * max(np.abs(ref).max(), 1e-30), (err, np.abs(ref).max())


def _compare_outputs(jo, to, predicted=False):
    """Every output within 1e-5 of its largest entry; with predicted-box
    prompts the masks and IoUs within 5e-5: the detected boxes' fp32
    rounding (1e-6 of 64 px) enters the prompts' Fourier features at
    frequencies up to 2 pi |pe_gaussian| / 32 per pixel."""
    assert set(jo) == set(to)
    assert to["stride"] == jo["stride"]
    for k in jo:
        if k == "stride":
            continue
        a = np.asarray(jo[k])
        assert to[k].shape == a.shape, k
        if k in ("det_labels", "det_valid"):
            np.testing.assert_array_equal(to[k].numpy(), a, err_msg=k)
        else:
            _close(to[k].numpy(), a,
                   5e-5 if predicted and k in ("pred_masks", "ious") else 1e-5)


@pytest.mark.parametrize("prompts", ["ground_truth", "predicted"])
def test_outputs_match_jax(models, prompts):
    _, (jm, variables, tm) = models
    images, targets = _batch()
    boxes = targets["boxes"] if prompts == "ground_truth" else None
    jo = _japply(jm, variables, images, boxes)
    with torch.no_grad():
        to = tm(torch.from_numpy(images), None if boxes is None else torch.from_numpy(boxes))
    _compare_outputs(jo, to, predicted=boxes is None)
    assert to["pred_masks"].shape == (B, N, SIZE, SIZE)
    # detections stay score-ranked
    assert bool((to["det_scores"][:, :-1] >= to["det_scores"][:, 1:]).all())


def test_tied_objectness_picks_as_lax_top_k(models):
    """With the objectness conv zeroed every location ties; the detections
    are the first K locations in both packages."""
    _, (jm, variables, tm) = models
    obj = f"Conv_{tm._head + 2}"
    variables = jax.tree_util.tree_map(np.copy, variables)
    variables["params"][obj] = {k: np.zeros_like(v)
                                for k, v in variables["params"][obj].items()}
    with torch.no_grad():
        getattr(tm, obj).weight.zero_()
        getattr(tm, obj).bias.zero_()
    images, _ = _batch(seed=1)
    jo = _japply(jm, variables, images)
    with torch.no_grad():
        to = tm(torch.from_numpy(images))
    _compare_outputs(jo, to, predicted=True)
    dense = to["dense_boxes"].reshape(B, -1, 4)[:, :N]
    assert torch.equal(to["det_boxes"], dense)
    tp.load_flax_variables(tm, _models(models[0])[1])  # restore the fixture


def test_loss_and_its_parts_match_jax(models):
    _, (jm, variables, tm) = models
    images, targets = _batch()
    jo = _japply(jm, variables, images, targets["boxes"])
    _, jparts = jdet.maskrcnn_lite_loss(jo, {k: jnp.asarray(v) for k, v in targets.items()})
    with torch.no_grad():
        to = tm(torch.from_numpy(images), torch.from_numpy(targets["boxes"]))
        _, tparts = tdet.maskrcnn_lite_loss(
            to, {k: torch.from_numpy(v) for k, v in targets.items()})
    assert set(tparts) == set(jparts) and len(jparts) == 6
    for k in jparts:
        assert tparts[k].item() == pytest.approx(float(jparts[k]), rel=1e-5), k


def test_train_step_gradients_match_jax_in_float64(models, monkeypatch):
    trunk, (jm, variables, _) = models
    # the JAX trunk computes in its `dtype` (fp32 by default) whatever the
    # variables' dtype: build it in float64 (the JAX module imports it at call
    # time)
    monkeypatch.setattr(jresnet, "ResNet50", partial(jresnet.ResNet50, dtype=jnp.float64))
    images, targets = _batch(seed=2)
    tm = tdet.MaskRCNNLite(num_classes=CLASSES, max_instances=N, channels=32,
                           backbone=trunk, device="cpu")
    tp.load_flax_variables(tm, variables)
    tm.double()
    if trunk == "resnet50":
        tm.backbone.dtype = torch.float64  # the trunk's compute dtype
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        tg = {k: jnp.asarray(v, jnp.float64 if v.dtype == np.float32 else v.dtype)
              for k, v in targets.items()}

        def loss_fn(params):
            out, mut = jm.apply({"params": params, "batch_stats": v64["batch_stats"]},
                                jnp.asarray(images, jnp.float64), tg["boxes"],
                                training=True, mutable=["batch_stats"])
            return jdet.maskrcnn_lite_loss(out, tg)[0], mut["batch_stats"]

        (jloss, jstats), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            v64["params"])
        jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
        jstats = jax.tree_util.tree_map(np.asarray, jstats)
    out = tm(torch.from_numpy(images).double(),
             torch.from_numpy(targets["boxes"]).double(), training=True)
    loss, _ = tdet.maskrcnn_lite_loss(out, {
        k: torch.from_numpy(v).double() if v.dtype == np.float32 else torch.from_numpy(v)
        for k, v in targets.items()})
    loss.backward()
    assert loss.item() == pytest.approx(float(jloss), rel=1e-10)
    want = flax_placements(tm, {"params": jgrads, "batch_stats": jstats})
    for name, p in tm.named_parameters():
        ref = np.asarray(want[name], np.float64)
        # no grad: a parameter the loss does not reach (the IoU head), zero in JAX
        grad = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
        err = np.abs(grad - ref).max()
        # a floor for gradients that vanish but for rounding (a conv bias
        # before a train-mode BatchNorm)
        assert err <= 1e-7 * max(np.abs(ref).max(), 1e-6), (name, err)
    for name, buf in tm.named_buffers():
        if name in want:
            np.testing.assert_allclose(buf.numpy(), want[name], rtol=1e-10, atol=1e-12,
                                       err_msg=name)


@pytest.mark.parametrize("m,n", [(4, 8), (5, 9), (3, 7), (8, 8)])
def test_nearest_upsample_matches_jax_image_resize(m, n):
    x = np.random.default_rng(m * n).normal(size=(1, 2, m, m + 1)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (1, 2, n, n + 2), method="nearest")
    got = tdet._upsample_nearest(torch.from_numpy(x), (n, n + 2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_decode_boxes():
    got = tdet.decode_boxes(torch.tensor([[10.0, 20.0]]), torch.tensor([[2.0, 3.0, 4.0, 5.0]]))
    assert got.tolist() == [[8.0, 17.0, 14.0, 25.0]]


def test_registry_builds_maskrcnn_as_jax_does():
    kw = dict(max_instances=3, channels=16)
    tm = treg.get_segmentation_prediction_network("maskrcnn", SIZE, num_classes=7,
                                                  device="cpu", **kw)
    assert isinstance(tm, tdet.MaskRCNNLite) and tm.num_classes == 7
    jm = jreg.get_segmentation_prediction_network("maskrcnn", num_classes=7, **kw)
    shapes = jax.eval_shape(jm.init, jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)))
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    assert len(flax_placements(tm, variables)) == len(jax.tree_util.tree_leaves(variables))
    with pytest.raises(ValueError, match="backbone"):
        tdet.MaskRCNNLite(backbone="vgg", device="cpu")


def test_experiment_runs_two_steps(tmp_path):
    out = tmp_path / "record.json"
    result = experiment.main(["--steps", "2", "--out", str(out)], device="cpu")
    saved = json.loads(out.read_text())
    assert saved == result
    assert saved["config"]["steps"] == 2 and saved["device"] == "cpu"
    assert set(saved["final_train_losses"]) == {
        "loss/objectness", "loss/box_reg", "loss/classifier", "loss/mask_focal",
        "loss/mask_dice", "loss/total"}
    assert all(np.isfinite(v) for v in saved["final_train_losses"].values())
    assert 0.0 <= saved["eval_segm_map_coco101"] <= 1.0
    assert 0.0 <= saved["eval_det_mean_best_iou"] <= 1.0
    assert saved["passed"] is False  # two steps do not reach the bar


def test_experiment_trunk_is_the_converted_state_dict():
    model = experiment.build_model("cpu")
    sd = experiment.random_resnet50_state_dict()
    got = model.backbone.state_dict()
    assert torch.equal(got["Conv_0.weight"], sd["conv1.weight"])
    assert torch.equal(got["Bottleneck_15.Conv_2.weight"], sd["layer4.2.conv3.weight"])
    assert torch.equal(got["Bottleneck_3.Conv_3.weight"], sd["layer2.0.downsample.0.weight"])
