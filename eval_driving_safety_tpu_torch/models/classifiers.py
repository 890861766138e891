"""Scene classifiers: road type (highway / street) and dynamic vehicle
(moving / static), their training step and their host helpers.

Counterpart of eval_driving_safety_tpu/models/classifiers.py, with its
module names (`ResNet_0` / `VGG16Features_0` for the backbones, `head`,
`fc1`, `fc2`), so utils.from_flax maps Flax weights leaf for leaf:
* RoadTypeClassifier: a frozen ResNet-50, the mean of c5 over H and W,
  dropout 0.5 and Dense(2048 -> 1);
* DynamicVehicleClassifier: frozen VGG-16 features flattened in (H, W, C)
  order, Dense(25088 -> 4096) + ReLU, dropout 0.1, Dense(4096 -> 1); fc1's
  width follows the image size, (size / 32)^2 x 512, as Flax infers it.
Both return logits. Only the head trains: the optimizer holds the head's
parameters alone and the backbone runs without autograd, which is what
the JAX package's `set_to_zero` mask over the backbone amounts to.

Dropout draws its mask from an explicit `torch.Generator`, or takes it as
a tensor (`dropout_mask`, True where a unit is kept).
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence

import torch
from torch import nn

from eval_driving_safety_tpu_torch.config import (DynamicVehicleConfig,
                                                   RoadTypeConfig)
from eval_driving_safety_tpu_torch.models.common import (Conv, Dense,
                                                         lecun_normal_,
                                                         resize_bilinear)
from eval_driving_safety_tpu_torch.models.resnet import resnet50
from eval_driving_safety_tpu_torch.models.vgg import VGG16Features


def dropout(x: torch.Tensor, rate: float, generator=None,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flax's `nn.Dropout` in training: units kept with probability
    1 - rate (from `generator`, or where `mask` is True) scaled by
    1 / (1 - rate), the others 0."""
    keep = 1.0 - rate
    if mask is None:
        mask = torch.rand(x.shape, generator=generator,
                          device=x.device) < keep
    return torch.where(mask.to(x.device, torch.bool), x / keep,
                       torch.zeros((), dtype=x.dtype, device=x.device))


class _Classifier(nn.Module):
    """A frozen backbone and a trained head; subclasses name both."""
    head_names: Sequence[str] = ()

    def features(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def head_logits(self, feats, train, generator, dropout_mask):
        raise NotImplementedError

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                dropout_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, S, S, 3) normalized RGB -> (B,) logits; `train` applies
        dropout."""
        with torch.no_grad():
            feats = self.features(x)
        return self.head_logits(feats, train, generator, dropout_mask)

    def head_parameters(self):
        return [p for n in self.head_names
                for p in getattr(self, n).parameters()]

    def init_weights(self, seed: int = 0) -> "_Classifier":
        """Flax's init distributions: lecun-normal kernels, zero biases,
        BatchNorm scale 1, mean 0, var 1."""
        g = torch.Generator().manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, (Conv, Dense)):
                lecun_normal_(mod.weight, mod.weight[0].numel(), g)
        return self

    def freeze_backbone(self) -> "_Classifier":
        """No gradient for anything but the head."""
        for name, p in self.named_parameters():
            p.requires_grad_(name.split(".")[0] in self.head_names)
        return self


class RoadTypeClassifier(_Classifier):
    """highway (1) / street (0) on full left frames."""
    head_names = ("head",)

    def __init__(self, dropout: float = 0.5):
        super().__init__()
        self.ResNet_0 = resnet50()
        self.head = Dense(2048, 1)
        self.dropout = dropout

    def features(self, x):
        return self.ResNet_0(x)[-1].mean(dim=(1, 2))

    def head_logits(self, feats, train, generator, dropout_mask):
        if train:
            feats = dropout(feats, self.dropout, generator, dropout_mask)
        return self.head(feats)[..., 0]


class DynamicVehicleClassifier(_Classifier):
    """moving (1) / static (0) on square vehicle crops of `image_size`."""
    head_names = ("fc1", "fc2")

    def __init__(self, dropout: float = 0.1, image_size: int = 224):
        super().__init__()
        self.VGG16Features_0 = VGG16Features()
        self.fc1 = Dense((image_size // 32) ** 2 * 512, 4096)
        self.fc2 = Dense(4096, 1)
        self.dropout = dropout

    def features(self, x):
        feats = self.VGG16Features_0(x)
        return feats.reshape(feats.shape[0], -1)       # (H, W, C) order

    def head_logits(self, feats, train, generator, dropout_mask):
        h = torch.relu(self.fc1(feats))
        if train:
            h = dropout(h, self.dropout, generator, dropout_mask)
        return self.fc2(h)[..., 0]


def make_classifier(task: str, cfg) -> _Classifier:
    """The classifier of `task` ("road_type" or "dynamic_vehicle") at
    `cfg`'s dropout (and image size), weights uninitialised."""
    if task == "road_type":
        return RoadTypeClassifier(dropout=cfg.dropout)
    return DynamicVehicleClassifier(dropout=cfg.dropout,
                                    image_size=cfg.image_size)


def bce_logits(logits: torch.Tensor, labels01: torch.Tensor) -> torch.Tensor:
    return (torch.logaddexp(torch.zeros_like(logits), logits)
            - logits * labels01).mean()


def piecewise_constant(init: float, boundaries_and_scales: Dict[int, float]
                       ) -> Callable[[int], float]:
    """`optax.piecewise_constant_schedule`: `init` times every scale whose
    boundary the count has reached (count >= boundary)."""
    def sched(count: int) -> float:
        v = init
        for boundary, scale in sorted(boundaries_and_scales.items()):
            if count >= boundary:
                v *= scale
        return v
    return sched


def make_road_type_schedule(cfg: RoadTypeConfig, steps_per_epoch: int):
    """x gamma after each milestone epoch."""
    return piecewise_constant(
        cfg.lr, {m * steps_per_epoch: cfg.lr_gamma for m in cfg.lr_milestones})


def make_dynamic_vehicle_schedule(cfg: DynamicVehicleConfig,
                                  steps_per_epoch: int):
    """Halved after each of the configured epochs."""
    return piecewise_constant(
        cfg.lr, {m * steps_per_epoch: 0.5 for m in cfg.lr_halve_epochs})


class HeadOptimizer:
    """`optax.adam(schedule)` over the head's parameters: the learning
    rate is `sched(count)`, read before the count advances."""

    def __init__(self, params, sched):
        self.adam = torch.optim.Adam(list(params), lr=sched(0),
                                     betas=(0.9, 0.999), eps=1e-8)
        self.sched, self.count = sched, 0

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        for group in self.adam.param_groups:
            group["lr"] = self.sched(self.count)
        self.adam.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"adam": self.adam.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state["adam"])
        self.count = int(state["count"])


def make_train_state(model: _Classifier, sched) -> HeadOptimizer:
    """Freeze the backbone and hold the head in a scheduled Adam."""
    model.freeze_backbone()
    return HeadOptimizer(model.head_parameters(), sched)


def make_train_step(model: _Classifier, opt: HeadOptimizer) -> Callable:
    """step(images, labels, generator=None, dropout_mask=None) -> the
    batch's loss (a tensor on the device) after one update."""
    def step(images, labels, generator=None, dropout_mask=None):
        loss = bce_logits(model(images, train=True, generator=generator,
                                dropout_mask=dropout_mask), labels)
        opt.zero_grad()
        loss.backward()
        opt.step()
        return loss.detach()
    return step


def make_eval_step(model: _Classifier) -> Callable:
    """images -> sigmoid probabilities."""
    def step(images):
        with torch.inference_mode():
            return torch.sigmoid(model(images, train=False))
    return step


def accuracy(model: _Classifier, batches: Iterable) -> float:
    """Fraction correct at probability > 0.5 over (images, labels)
    batches."""
    step = make_eval_step(model)
    correct = total = 0
    for images, labels in batches:
        probs = step(images).cpu().numpy()
        labels = torch.as_tensor(labels).cpu().numpy()
        correct += int(((probs > 0.5) == (labels > 0.5)).sum())
        total += len(labels)
    return correct / max(total, 1)


def resize_normalize(img01: torch.Tensor, cfg) -> torch.Tensor:
    """(H, W, 3) RGB in [0, 1] -> (S, S, 3) at cfg.image_size (linear,
    antialiased where it shrinks), minus cfg.mean, over cfg.std."""
    x = resize_bilinear(img01.float()[None], cfg.image_size,
                        cfg.image_size)[0]
    mean = torch.tensor(cfg.mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(cfg.std, dtype=torch.float32, device=x.device)
    return (x - mean) / std


# ---------------------------------------------------------------------------
# Host helpers
# ---------------------------------------------------------------------------

def crop_vehicle(image: torch.Tensor, bbox, margin: int = 4,
                 out_size: int = 224) -> torch.Tensor:
    """Square crop centred on the bbox, of side max(w, h) + margin, clipped
    to the (H, W, C) [0, 1] RGB `image` (bounds rounded half to even) and
    resized to out_size on the image's device; an empty crop is an 8x8
    crop of zeros."""
    x1, y1, x2, y2 = bbox
    cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0
    side = max(x2 - x1, y2 - y1) + margin
    h, w = image.shape[:2]
    xa = int(round(max(cx - side / 2, 0)))
    ya = int(round(max(cy - side / 2, 0)))
    xb = int(round(min(cx + side / 2, w)))
    yb = int(round(min(cy + side / 2, h)))
    crop = image[ya:yb, xa:xb].float()
    if crop.numel() == 0:
        crop = torch.zeros((8, 8) + tuple(image.shape[2:]),
                           device=image.device)
    return resize_bilinear(crop[None], out_size, out_size)[0]


def label_from_filename(name: str) -> int:
    """`..._d.png` -> 1 (dynamic), `..._s.png` -> 0 (static)."""
    stem = name.rsplit(".", 1)[0]
    return 1 if stem.endswith("d") else 0


def read_csv_dataset(path: str):
    """CSV rows `filename,label` -> [(filename, int label)]."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            name, label = line.rsplit(",", 1)
            rows.append((name, int(float(label))))
    return rows
