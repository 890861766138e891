"""The ported scene classifiers against the JAX reference on CPU: VGG-16
features, both classifiers on bridged weights, the loss, both LR ladders,
one training step of each with JAX's dropout mask injected, accuracy,
vehicle crops, the CSV helpers and the torchvision converters.

Sizes: 64-px inputs (fc1 of the dynamic-vehicle head is then 2048 -> 4096)
except one 224-px forward of each classifier. Tolerances: forwards within
1e-5 of the largest logit magnitude (the same f32 convs summed in other
orders); the training step's loss within 1e-5 relative, each head
gradient within 1e-4 of its largest magnitude (a bias's gradient is a
mean of terms of both signs) and the head after the step within 1e-5,
the backbone bit for bit unchanged (Adam's first step is about
lr x sign(gradient), so a larger rate would only magnify the elements
whose gradient is near 0 and whose sign rounding decides); crops within
1e-5 (the same resize weights applied as matrix products); schedules
within 1e-7 relative (optax's f32 arithmetic).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eval_driving_safety_tpu.config import (
    DynamicVehicleConfig as JaxDynCfg, RoadTypeConfig as JaxRoadCfg)
from eval_driving_safety_tpu.models import classifiers as JC
from eval_driving_safety_tpu.models.vgg import VGG16Features as JaxVGG
from eval_driving_safety_tpu.utils import torch_import as JTI
from eval_driving_safety_tpu_torch.config import (DynamicVehicleConfig,
                                                   RoadTypeConfig)
from eval_driving_safety_tpu_torch.models import classifiers as C
from eval_driving_safety_tpu_torch.models.resnet import resnet50
from eval_driving_safety_tpu_torch.models.vgg import VGG16Features
from eval_driving_safety_tpu_torch.utils import torch_import as TI
from eval_driving_safety_tpu_torch.utils.from_flax import (
    dsgn_state_dict_from_flax, dynamic_vehicle_state_dict_from_flax,
    road_type_state_dict_from_flax)

TASKS = {
    "road_type": (JC.RoadTypeClassifier, road_type_state_dict_from_flax,
                  ("head",)),
    "dynamic_vehicle": (JC.DynamicVehicleClassifier,
                        dynamic_vehicle_state_dict_from_flax, ("fc1", "fc2")),
}


def _images(n, size, seed=0):
    return np.random.RandomState(seed).randn(n, size, size, 3).astype(
        np.float32)


def _pair(task, size, seed=0):
    """(JAX model, its variables, the port's model on the same weights)."""
    jax_cls, bridge, _ = TASKS[task]
    jm = jax_cls()
    variables = jax.jit(lambda k, x: jm.init(k, x, train=False))(
        jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)))
    model = C.make_classifier(task, dataclasses.replace(
        RoadTypeConfig() if task == "road_type" else DynamicVehicleConfig(),
        image_size=size))
    model.load_state_dict(bridge(variables))
    return jm, variables, model


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (err, tol)


def test_vgg16_features_match_jax():
    x = _images(2, 64)
    jm = JaxVGG()
    v = jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.asarray(x))
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    model = VGG16Features()
    model.load_state_dict(dsgn_state_dict_from_flax(v))
    got = model(torch.from_numpy(x))
    assert got.shape == (2, 2, 2, 512)
    _close(got.detach(), want, 1e-5)


@pytest.mark.parametrize("size", [64, 224])
@pytest.mark.parametrize("task", sorted(TASKS))
def test_classifier_forward_matches_jax(task, size):
    """Logits of both classifiers on bridged weights; at 224 px the
    published widths (fc1 25088 -> 4096)."""
    jm, v, model = _pair(task, size)
    x = _images(2, size, seed=1)
    want = jax.jit(lambda v, a: jm.apply(v, a, train=False))(v, x)
    got = model(torch.from_numpy(x))
    _close(got.detach(), want, 1e-5)
    if task == "dynamic_vehicle":
        assert model.fc1.weight.shape == ((size // 32) ** 2 * 512, 4096)[::-1]


def test_bce_logits_matches_jax():
    rng = np.random.RandomState(2)
    logits = (rng.randn(64) * 30).astype(np.float32)
    labels = (rng.rand(64) > 0.5).astype(np.float32)
    want = float(JC.bce_logits(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(C.bce_logits(torch.from_numpy(logits),
                             torch.from_numpy(labels)))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("task", sorted(TASKS))
def test_schedules_match_optax_at_each_boundary(task):
    spe = 7
    if task == "road_type":
        want = JC.make_road_type_schedule(JaxRoadCfg(), spe)
        got = C.make_road_type_schedule(RoadTypeConfig(), spe)
        epochs = RoadTypeConfig().lr_milestones
    else:
        want = JC.make_dynamic_vehicle_schedule(JaxDynCfg(), spe)
        got = C.make_dynamic_vehicle_schedule(DynamicVehicleConfig(), spe)
        epochs = DynamicVehicleConfig().lr_halve_epochs
    counts = [0] + [m * spe + d for m in epochs for d in (-1, 0)] + [10 ** 4]
    values = [got(n) for n in counts]
    for n, v in zip(counts, values):
        assert v == pytest.approx(float(want(n)), rel=1e-7), n
    # each boundary scales the rate at m * spe, not at m * spe - 1
    assert len(set(values)) == len(epochs) + 1


def _dropout_mask(jm, variables, x, rng):
    """JAX's keep mask for `rng`: the units of Dropout_0's output that are
    not 0."""
    _, state = jax.jit(lambda v, a, r: jm.apply(
        v, a, train=True, rngs={"dropout": r},
        capture_intermediates=True))(variables, jnp.asarray(x), rng)
    out = state["intermediates"]["Dropout_0"]["__call__"][0]
    return torch.from_numpy(np.asarray(out) != 0)


@pytest.mark.parametrize("task", sorted(TASKS))
def test_train_step_matches_jax_with_its_dropout_mask(task):
    """One step at the task's first learning rate (road type 1e-3,
    dynamic vehicle 1e-6): the loss, the head's gradient and the head
    after the step; the backbone unchanged bit for bit."""
    jm, _, model = _pair(task, 64, seed=4)
    bridge, head_names = TASKS[task][1:]
    if task == "road_type":
        cfg = JaxRoadCfg()
        sched = JC.make_road_type_schedule(cfg, 10)
        port_sched = C.make_road_type_schedule(RoadTypeConfig(), 10)
    else:
        cfg = JaxDynCfg()
        sched = JC.make_dynamic_vehicle_schedule(cfg, 10)
        port_sched = C.make_dynamic_vehicle_schedule(DynamicVehicleConfig(),
                                                     10)
    jparams, tx, opt_state = JC.make_train_state(
        jm, jax.random.PRNGKey(4), (64, 64, 3), sched, head_names)
    x = _images(8, 64, seed=5)
    labels = (np.arange(8) % 2).astype(np.float32)
    rng = jax.random.PRNGKey(6)
    mask = _dropout_mask(jm, jparams, x, rng)
    assert 0 < mask.float().mean() < 1
    jgrads = jax.jit(jax.grad(lambda p: JC.bce_logits(jm.apply(
        p, jnp.asarray(x), train=True, rngs={"dropout": rng}),
        jnp.asarray(labels))))(jparams)
    jafter, _, jloss = JC.make_train_step(jm, tx)(
        jparams, opt_state, jnp.asarray(x), jnp.asarray(labels), rng)

    before = {k: t.clone() for k, t in model.state_dict().items()}
    opt = C.make_train_state(model, port_sched)
    loss = C.make_train_step(model, opt)(
        torch.from_numpy(x), torch.from_numpy(labels), dropout_mask=mask)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    want, want_g = bridge(jafter), bridge(jgrads)
    for name, p in model.named_parameters():
        if name.split(".")[0] in head_names:
            _close(p.grad, want_g[name].numpy(), 1e-4)
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                       rtol=0, atol=1e-5, err_msg=name)
        else:
            assert p.grad is None and torch.equal(p, before[name]), name
    assert opt.count == 1


def test_accuracy_matches_jax():
    jm, v, model = _pair("road_type", 64, seed=7)
    x = _images(16, 64, seed=8)
    logits = np.asarray(jax.jit(
        lambda v, a: jm.apply(v, a, train=False))(v, x))
    # the head's bias puts the threshold in the widest gap of the logits
    s = np.sort(logits)
    gap = int(np.argmax(np.diff(s[4:-4]))) + 4
    bias = -(s[gap] + s[gap + 1]) / 2
    v = jax.tree_util.tree_map(lambda a: a, v)
    v["params"]["head"]["bias"] = v["params"]["head"]["bias"] + bias
    with torch.no_grad():
        model.head.bias += float(bias)
    labels = (np.arange(16) % 3 == 0).astype(np.float32)
    batches = [(x[:10], labels[:10]), (x[10:], labels[10:])]
    want = JC.accuracy(jm, v, batches)
    got = C.accuracy(model, [(torch.from_numpy(a), b) for a, b in batches])
    assert got == pytest.approx(float(want)) and 0 < got < 1


CROPS = {
    # (bbox, image size): the crop shrinks to 224 (antialiased)
    "shrinking": ((100.0, 20.0, 420.0, 250.0), (300, 500)),
    # grows from a 20-px box; bounds land on .5 (rounded half to even)
    "growing": ((201.0, 101.0, 219.0, 117.0), (300, 500)),
    "edge_clipped": ((-30.0, 250.0, 60.0, 310.0), (300, 500)),
    # the box lies past the image: an empty crop
    "empty": ((600.0, 10.0, 640.0, 50.0), (300, 500)),
}


@pytest.mark.parametrize("case", sorted(CROPS))
def test_crop_vehicle_matches_jax(case):
    bbox, (h, w) = CROPS[case]
    img = np.random.RandomState(9).rand(h, w, 3).astype(np.float32)
    want = JC.crop_vehicle(img, np.asarray(bbox))
    got = C.crop_vehicle(torch.from_numpy(img), np.asarray(bbox)).numpy()
    assert got.shape == want.shape == (224, 224, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if case == "empty":
        assert not got.any()


def test_label_from_filename_and_csv_match_jax(tmp_path):
    for name in ("000012_0_d.png", "000012_1_s.png", "a.b_d.png",
                 "weird_x.png", "noext_d"):
        assert C.label_from_filename(name) == JC.label_from_filename(name)
    p = tmp_path / "rows.csv"
    p.write_text("a_d.png,1\n\nb_s.png,0\nc,d_s.png,0.0\n  e_d.png,1.0  \n")
    rows = C.read_csv_dataset(str(p))
    assert rows == JC.read_csv_dataset(str(p))
    assert rows[2] == ("c,d_s.png", 0)


def _torchvision_resnet50_sd(rng):
    sd = {"conv1.weight": rng.randn(64, 3, 7, 7)}

    def bn(prefix, c):
        sd[f"{prefix}.weight"] = rng.rand(c) + 0.5
        sd[f"{prefix}.bias"] = rng.randn(c)
        sd[f"{prefix}.running_mean"] = rng.randn(c)
        sd[f"{prefix}.running_var"] = rng.rand(c) + 0.5
        sd[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)
    bn("bn1", 64)
    cin = 64
    for stage, n in enumerate((3, 4, 6, 3)):
        width = 64 * 2 ** stage
        for b in range(n):
            pre = f"layer{stage + 1}.{b}."
            sd[pre + "conv1.weight"] = rng.randn(width, cin, 1, 1)
            sd[pre + "conv2.weight"] = rng.randn(width, width, 3, 3)
            sd[pre + "conv3.weight"] = rng.randn(4 * width, width, 1, 1)
            for i, c in ((1, width), (2, width), (3, 4 * width)):
                bn(f"{pre}bn{i}", c)
            if b == 0:
                sd[pre + "downsample.0.weight"] = rng.randn(4 * width, cin,
                                                            1, 1)
                bn(pre + "downsample.1", 4 * width)
            cin = 4 * width
    sd["fc.weight"] = rng.randn(1000, 2048)
    return {k: torch.from_numpy(np.asarray(v, np.float32))
            if v.dtype != np.int64 else torch.from_numpy(v)
            for k, v in sd.items()}


def test_torchvision_converters_match_jax():
    """A synthetic torchvision resnet50 (wrapped under `model.`) and a
    vgg16 state dict: the port's converters give exactly the state dict
    that JAX's converters give through the bridge, and it loads into the
    port's backbones."""
    rng = np.random.RandomState(10)
    sd = _torchvision_resnet50_sd(rng)
    wrapped = {f"model.{k}": v for k, v in sd.items()}
    np_sd = {k: v.numpy().astype(np.float32) for k, v in wrapped.items()}
    got = TI.convert_torchvision_resnet(wrapped, (3, 4, 6, 3),
                                        prefix="model.")
    want = dsgn_state_dict_from_flax(JTI.convert_torchvision_resnet(
        np_sd, (3, 4, 6, 3), prefix="model."))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    resnet50().load_state_dict(got)

    vgg = {}
    cin = 3
    for layer, ch in zip(TI.VGG16_CONV_LAYERS, (64, 64, 128, 128, 256, 256,
                                                256, 512, 512, 512, 512, 512,
                                                512)):
        vgg[f"features.{layer}.weight"] = torch.randn(ch, cin, 3, 3)
        vgg[f"features.{layer}.bias"] = torch.randn(ch)
        cin = ch
    got = TI.convert_torchvision_vgg16(vgg)
    want = dsgn_state_dict_from_flax(JTI.convert_torchvision_vgg16(
        {k: v.numpy() for k, v in vgg.items()}))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    VGG16Features().load_state_dict(got)
