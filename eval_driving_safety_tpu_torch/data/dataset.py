"""KITTI stereo frames, DSGN and Stereo R-CNN u8 batches, and the
sweep's host side: fetching packed signs, replaying them, writing PNGs
in the background.

Counterpart of the attack parts of eval_driving_safety_tpu/data/
dataset.py. Frames stay raw uint8 on the host; the device converts them
(DSGN: the clean pair is exactly the loaded pixels; Stereo R-CNN: the
exact integer resize of data.exact_resize), and only packed gradient
signs come back, from which the host replays every iterate bit-exactly
(attack.replay_native; attack.pgd holds the plain versions) and writes
`{prefix}_iters_{k}/image_{2,3}/<id>.png`.
"""
from __future__ import annotations

import itertools
import os
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from eval_driving_safety_tpu_torch.attack import replay_native
from eval_driving_safety_tpu_torch.config import (DSGNInputConfig,
                                                   SRCNNInputConfig)
from eval_driving_safety_tpu_torch.data import kitti as K
from eval_driving_safety_tpu_torch.data.exact_resize import (
    bilinear_axis_weights, resize_v2_device, resize_v2_host)


@dataclass
class KittiSample:
    frame_id: str
    im_left: np.ndarray           # (H, W, 3) uint8 RGB
    im_right: np.ndarray
    calib: K.Calibration
    objects: List[K.KittiObject]
    orig_hw: tuple


class KittiStereoDataset:
    """KITTI object layout: root/{image_2,image_3,calib,label_2}/<id>.*;
    frames load as uint8 RGB."""

    def __init__(self, root: str, split_file: Optional[str] = None,
                 image_2_dir: Optional[str] = None,
                 image_3_dir: Optional[str] = None):
        self.root = root
        self.image_2_dir = image_2_dir or os.path.join(root, "image_2")
        self.image_3_dir = image_3_dir or os.path.join(root, "image_3")
        self.label_dir = os.path.join(root, "label_2")
        self.calib_dir = os.path.join(root, "calib")
        if split_file:
            with open(split_file) as f:
                self.ids = [ln.strip() for ln in f if ln.strip()]
        else:
            self.ids = sorted(
                n.split(".")[0] for n in os.listdir(self.image_2_dir)
                if n.endswith((".png", ".jpg")))

    def __len__(self) -> int:
        return len(self.ids)

    @staticmethod
    def _img_path(d: str, fid: str) -> str:
        for ext in (".png", ".jpg"):
            p = os.path.join(d, fid + ext)
            if os.path.exists(p):
                return p
        raise FileNotFoundError(os.path.join(d, fid + ".png"))

    def get(self, i: int) -> KittiSample:
        fid = self.ids[i]
        im_l = K.load_image_u8(self._img_path(self.image_2_dir, fid))
        im_r = K.load_image_u8(self._img_path(self.image_3_dir, fid))
        calib_path = os.path.join(self.calib_dir, fid + ".txt")
        calib = K.read_calib(calib_path) if os.path.exists(calib_path) \
            else K.Calibration.default()
        label_path = os.path.join(self.label_dir, fid + ".txt")
        objects = K.read_label(label_path) if os.path.exists(label_path) \
            else []
        return KittiSample(fid, im_l, im_r, calib, objects, im_l.shape[:2])

    def batches(self, batch_size: int, drop_remainder: bool = False,
                prefetch: int = 2, io_workers: int = 4, prepare=None):
        """Yield `prepare(samples)` (or the sample lists) per batch, in
        order; with `drop_remainder` a last batch of fewer than
        `batch_size` frames is left out. With prefetch > 0 that many
        batches are decoded and prepared on a thread pool ahead of the
        consumer."""
        n = len(self)
        stop = n - n % batch_size if drop_remainder else n
        starts = range(0, stop, batch_size)

        def batch(s):
            samples = [self.get(i) for i in range(s, min(s + batch_size, n))]
            return prepare(samples) if prepare is not None else samples

        if prefetch <= 0:
            for s in starts:
                yield batch(s)
            return
        with ThreadPoolExecutor(max_workers=io_workers) as ex:
            it = iter(starts)
            pending = deque(ex.submit(batch, s)
                            for s in itertools.islice(it, prefetch + 1))
            while pending:
                fut = pending.popleft()
                for s in itertools.islice(it, 1):
                    pending.append(ex.submit(batch, s))
                yield fut.result()


def prepare_dsgn_batch_u8(samples: Sequence[KittiSample],
                          cfg: DSGNInputConfig = DSGNInputConfig(),
                          depth_dir: Optional[str] = None) -> Dict:
    """Padded raw uint8 frames plus calibration vectors and optional
    per-frame depth ground truth (`depth_dir/<id>.npy`, zeros if absent)."""
    b = len(samples)
    h, w = cfg.height, cfg.width
    il = np.zeros((b, h, w, 3), np.uint8)
    ir = np.zeros((b, h, w, 3), np.uint8)
    depth = np.zeros((b, h, w), np.float32)
    calib = {k: np.zeros((b,), np.float32)
             for k in ("f_u", "baseline", "c_u", "c_v")}
    for i, s in enumerate(samples):
        il[i] = K.pad_to(s.im_left, h, w)
        ir[i] = K.pad_to(s.im_right, h, w)
        for k in calib:
            calib[k][i] = getattr(s.calib, k)
        if depth_dir:
            p = os.path.join(depth_dir, s.frame_id + ".npy")
            if os.path.exists(p):
                depth[i] = K.pad_to(np.load(p).astype(np.float32), h, w)
    return {"im_left_u8": il, "im_right_u8": ir, **calib,
            "depth_gt": depth,
            "frame_ids": [s.frame_id for s in samples],
            "orig_hw": [s.orig_hw for s in samples],
            "calibs": [s.calib for s in samples],
            "objects": [s.objects for s in samples]}


def prepare_srcnn_batch_u8(samples: Sequence[KittiSample],
                           cfg: SRCNNInputConfig = SRCNNInputConfig()
                           ) -> Dict:
    """Raw uint8 BGR frames, padded to a per-batch size that is a multiple
    of 8, with each frame's integer resize weights to the network's
    height (scale = height / frame rows) and width (cropped to cfg.width):
    `ih` (B, 3, H) and `iw` (B, 3, W) hold (i0, i1, r), `den_h`/`den_w`
    the denominators, `wmask` the columns inside the frame. The attack
    space is v = den_h * den_w * 255 * bgr01 (`srcnn_cleanv_device`);
    `c255` = 1 / (den_h * den_w) maps it to BGR pixels and `c` =
    c255 / 255 to [0, 1]."""
    b = len(samples)
    out_h, out_w = cfg.height, cfg.width
    hp = -(-max(s.orig_hw[0] for s in samples) // 8) * 8
    wp = -(-max(s.orig_hw[1] for s in samples) // 8) * 8
    il = np.zeros((b, hp, wp, 3), np.uint8)
    ir = np.zeros((b, hp, wp, 3), np.uint8)
    ih = np.zeros((b, 3, out_h), np.int32)
    iw = np.zeros((b, 3, out_w), np.int32)
    den_h = np.zeros((b,), np.int32)
    den_w = np.zeros((b,), np.int32)
    wmask = np.zeros((b, out_w), np.int32)
    c = np.zeros((b,), np.float32)
    c255 = np.zeros((b,), np.float32)
    scales = np.zeros((b,), np.float32)
    net_hw = []
    for i, s in enumerate(samples):
        oh, ow = s.orig_hw
        il[i, :oh, :ow] = s.im_left[..., ::-1]          # BGR byte order
        ir[i, :oh, :ow] = s.im_right[..., ::-1]
        scale = out_h / oh
        full_w = int(round(ow * scale))
        nw = min(full_w, out_w)
        wh = bilinear_axis_weights(oh, out_h)
        ww = bilinear_axis_weights(ow, full_w, crop=nw)
        ih[i] = np.stack([wh.i0, wh.i1, wh.r])
        iw[i, :, :nw] = np.stack([ww.i0, ww.i1, ww.r])
        den_h[i], den_w[i] = wh.den, ww.den
        wmask[i, :nw] = 1
        c[i] = np.float64(1.0) / (255.0 * wh.den * ww.den)
        c255[i] = np.float64(1.0) / (wh.den * ww.den)
        scales[i] = scale
        net_hw.append((out_h, nw))
    return {"im_left_u8": il, "im_right_u8": ir, "ih": ih, "iw": iw,
            "den_h": den_h, "den_w": den_w, "wmask": wmask, "c": c,
            "c255": c255, "scales": scales,
            "frame_ids": [s.frame_id for s in samples],
            "orig_hw": [s.orig_hw for s in samples], "net_hw": net_hw,
            "calibs": [s.calib for s in samples],
            "objects": [s.objects for s in samples]}


def srcnn_cleanv_device(weights: Dict, img_u8: torch.Tensor) -> torch.Tensor:
    """The card's ingest into v-space: (B, Hp, Wp, 3) uint8 BGR and the
    batch's weight tensors (`ih`, `iw`, `den_h`, `den_w`, `wmask` of
    `prepare_srcnn_batch_u8`, on the card) -> (B, H, W, 3) float32
    integers v = den_h * den_w * 255 * bgr01, zero past each frame's
    width. Below 2^24 at KITTI scales, so exact in f32."""
    ih, iw = weights["ih"], weights["iw"]
    v2 = resize_v2_device(img_u8, ih[:, 0], ih[:, 1], ih[:, 2],
                          weights["den_h"], iw[:, 0], iw[:, 1], iw[:, 2],
                          weights["den_w"])
    return (v2 * weights["wmask"][:, None, :, None]).to(torch.float32)


def _frame_weights(batch_u8: Dict, i: int) -> tuple:
    """Frame i's source size and the axis weights of its resize to network
    scale, cropped to its width there: (oh, ow, wh, ww)."""
    oh, ow = batch_u8["orig_hw"][i]
    out_h, nw = batch_u8["net_hw"][i]
    return (oh, ow, bilinear_axis_weights(oh, out_h),
            bilinear_axis_weights(ow, int(round(ow * (out_h / oh))), crop=nw))


def srcnn_cleanv_host(batch_u8: Dict) -> tuple:
    """The host twin of `srcnn_cleanv_device`, as int32 (the replay's
    seeds): (v_left, v_right), each (B, H, W, 3). numpy: the plain
    version of the native resize in `srcnn_cleanv_q0_host`, for the
    tests."""
    out_w = batch_u8["wmask"].shape[1]
    out = []
    for side in ("im_left_u8", "im_right_u8"):
        frames = []
        for i in range(len(batch_u8["orig_hw"])):
            oh, ow, wh, ww = _frame_weights(batch_u8, i)
            x = np.zeros((len(wh.i0), out_w, 3), np.int32)
            x[:, :len(ww.i0)] = resize_v2_host(batch_u8[side][i, :oh, :ow],
                                               wh, ww)
            frames.append(x)
        out.append(np.stack(frames))
    return out[0], out[1]


def srcnn_clean01_device(weights: Dict, img_u8: torch.Tensor) -> torch.Tensor:
    """The card's ingest into BGR [0,1] at network scale: the v-space
    frame of `srcnn_cleanv_device` times the batch's `c` (weights["c"],
    (B,)), one f32 multiply; 0 past each frame's width (black, which is
    the reference's -mean padding once the means are subtracted)."""
    return srcnn_cleanv_device(weights, img_u8) \
        * weights["c"][:, None, None, None]


def srcnn_cleanv_q0_host(batch_u8: Dict) -> tuple:
    """`srcnn_cleanv_host` and the quantized clean frames (iteration 0),
    each frame in one native pass (`attack.replay_native.resize_v2_q0`):
    (v_left, v_right, q_left, q_right)."""
    out_w = batch_u8["wmask"].shape[1]
    c255 = np.asarray(batch_u8["c255"], np.float32).reshape(-1)
    vs, qs = [], []
    for side in ("im_left_u8", "im_right_u8"):
        va, qa = [], []
        for i in range(len(batch_u8["orig_hw"])):
            oh, ow, wh, ww = _frame_weights(batch_u8, i)
            v, q = replay_native.resize_v2_q0(batch_u8[side][i, :oh, :ow],
                                              wh, ww, out_w, c255[i])
            va.append(v)
            qa.append(q)
        vs.append(np.stack(va))
        qs.append(np.stack(qa))
    return vs[0], vs[1], qs[0], qs[1]


def quantize_v_rgb_u8(x_v, c255):
    """v-space frames -> truncated RGB uint8 pixels: one f32 multiply by
    c255 = 1 / (den_h * den_w) (flat (B,), broadcast over the batch axis
    of (B, H, W, 3) frames or an (iters, B, H, W, 3) stack), a clamp to
    [0, 255] and truncation, then BGR -> RGB. The same operations on an
    array (numpy) and a tensor (on the card), so both transfer modes
    write the same PNGs."""
    shape = (1,) * (x_v.ndim - 4) + (-1, 1, 1, 1)
    if isinstance(x_v, np.ndarray):
        x = x_v.astype(np.float32) * \
            np.asarray(c255, np.float32).reshape(shape)
        return np.clip(x, 0, 255).astype(np.uint8)[..., ::-1]
    c = torch.as_tensor(c255, dtype=torch.float32, device=x_v.device)
    x = x_v.to(torch.float32) * c.reshape(shape)
    return torch.clamp(x, 0, 255).to(torch.uint8).flip(-1)


def quantize_v_batch_u8(v_i32: np.ndarray, c255) -> np.ndarray:
    """(B, H, W, 3) int32 v-space frames -> truncated RGB uint8: the plain
    version of `srcnn_cleanv_q0_host`'s clean frames, for the tests."""
    return quantize_v_rgb_u8(v_i32.astype(np.float32), c255)


def srcnn_clip_bounds(cfg: SRCNNInputConfig):
    """Per-channel pixel bounds in the Stereo R-CNN input space (BGR minus
    the means): (-means, 255 - means), each (3,) float32."""
    means = np.asarray(cfg.pixel_means_bgr, np.float32)
    return -means, 255.0 - means


def u8_to_01(x):
    """uint8 pixels -> float32 [0,1], equal to u8 / 255 computed on the
    host. numpy input divides; a tensor gathers from a 256-entry table
    built on the host with numpy's correctly rounded division, so the
    device values are exact whatever its division does."""
    if isinstance(x, np.ndarray):
        return x.astype(np.float32) / 255.0
    table = torch.from_numpy(np.arange(256, dtype=np.float32) / 255.0)
    return table.to(x.device)[x.long()]


def dsgn_boxes3d(samples: Sequence[KittiSample], max_boxes: int = 16) -> Dict:
    """Padded (B, G, 8) [x, y, z, h, w, l, ry, cls] gt for the RPN3D loss
    (Car and Van)."""
    b = len(samples)
    boxes = np.zeros((b, max_boxes, 8), np.float32)
    num = np.zeros((b,), np.int32)
    for i, s in enumerate(samples):
        k = 0
        for o in s.objects:
            if o.type not in ("Car", "Van") or k >= max_boxes:
                continue
            boxes[i, k] = [*o.location, *o.dimensions, o.rotation_y, 1.0]
            k += 1
        num[i] = k
    return {"boxes3d": boxes, "num_boxes": num}


class AsyncImageWriter:
    """Bounded-queue PNG writer pool: the sweep writes (iters+1) x 2 PNGs
    per frame while the device runs the next frame. Write errors are
    re-raised at flush()/close()."""

    _STOP = object()

    def __init__(self, workers: int = 2, queue_depth: int = 32,
                 compress_level: int = 0):
        self.compress_level = compress_level
        self._q: queue.Queue = queue.Queue(maxsize=queue_depth)
        self._errors: List[BaseException] = []
        self._threads = [threading.Thread(target=self._run, daemon=True,
                                          name=f"png-writer-{i}")
                         for i in range(max(1, workers))]
        for t in self._threads:
            t.start()

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is self._STOP:
                    return
                path, img, crop_hw = item
                K.save_image(path, fetch_np(img), crop_hw=crop_hw,
                             compress_level=self.compress_level)
            except Exception as e:                       # noqa: BLE001
                self._errors.append(e)
            finally:
                self._q.task_done()

    def put(self, path: str, img, crop_hw=None) -> None:
        """Enqueue one write; `img` may be a device tensor, fetched on the
        worker thread."""
        self._q.put((path, img, crop_hw))

    def flush(self) -> None:
        self._q.join()
        if self._errors:
            raise self._errors[0]

    def close(self) -> None:
        try:
            self.flush()
        finally:
            for _ in self._threads:
                self._q.put(self._STOP)
            for t in self._threads:
                t.join()


def fetch_np(x) -> np.ndarray:
    """Host copy of a tensor (waits for the device) or an array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def fetch_signs1(side) -> tuple:
    """One side of a collect="signs1" trajectory -> (pos, zero or None):
    the zero plane is fetched only when some gradient was exactly 0."""
    pos, zero, nz = side
    if int(fetch_np(nz).sum()) == 0:
        return fetch_np(pos), None
    return fetch_np(pos), fetch_np(zero)


def fetch_packed_signs(packed_l, packed_r):
    """A sign trajectory pair -> host (pl, pr, bits): "signs1" sides are
    3-tuples (bits=1 when no zero plane was needed, else converted to the
    2-bit codes); plain tensors are the 2-bit format."""
    from eval_driving_safety_tpu_torch.attack.pgd import signs1_to_packed2
    if isinstance(packed_l, tuple):
        pl, zl = fetch_signs1(packed_l)
        pr, zr = fetch_signs1(packed_r)
        if zl is None and zr is None:
            return pl, pr, 1
        return signs1_to_packed2(pl, zl), signs1_to_packed2(pr, zr), 2
    return fetch_np(packed_l), fetch_np(packed_r), 2


def save_sweep_from_signs(batch: Dict, clean_l: np.ndarray,
                          clean_r: np.ndarray, packed_l, packed_r,
                          prefix: str, writer, *, alpha, eps, clip_min,
                          clip_max) -> None:
    """Replay a packed sign trajectory from the host uint8 clean pair and
    save every iteration under `{prefix}_iters_{k}/image_{2,3}/` (k = 0 is
    the clean pair). A unit step with a half-integer ball in [0, 255]
    replays natively on the doubled grid from the 1- or 2-bit planes as
    fetched (`attack.replay_native.replay_sweep_u8`); anything else in
    f32 (`attack.pgd.replay_pgd`)."""
    from eval_driving_safety_tpu_torch.attack.pgd import (replay_255_valid,
                                                          replay_pgd,
                                                          signs1_to_packed2)
    pl, pr, bits = fetch_packed_signs(packed_l, packed_r)
    if replay_255_valid(alpha, eps, clip_min, clip_max):
        e2 = int(round(2 * float(eps)))
        frames = zip(*(replay_native.replay_sweep_u8(
            clean.astype(np.int32), packed, alpha2=2, eps2=e2, max2=510,
            c255=1.0, flip_channels=False, bits=bits)
            for clean, packed in ((clean_l, pl), (clean_r, pr))))
    else:
        if bits == 1:
            pl, pr = signs1_to_packed2(pl), signs1_to_packed2(pr)
        frames = ((np.clip(xl, 0, 255).astype(np.uint8),
                   np.clip(xr, 0, 255).astype(np.uint8))
                  for xl, xr in replay_pgd(
                      clean_l.astype(np.float32), clean_r.astype(np.float32),
                      pl, pr, alpha=alpha, eps=eps, clip_min=clip_min,
                      clip_max=clip_max))
    save_sweep(batch, (clean_l, clean_r), frames, prefix, writer)


def save_sweep(batch: Dict, clean_pair, frames, prefix: str,
               writer) -> None:
    """Save iteration 0 (`clean_pair`) and every pair of `frames` under
    `{prefix}_iters_{k}/image_{2,3}/`."""
    save_attacked_images(batch, clean_pair[0], clean_pair[1],
                         f"{prefix}_iters_0", writer=writer)
    for k, (xl, xr) in enumerate(frames):
        save_attacked_images(batch, xl, xr, f"{prefix}_iters_{k + 1}",
                             writer=writer)


def save_attacked_images(batch: Dict, adv_left, adv_right, out_dir: str,
                         writer: Optional[AsyncImageWriter] = None) -> None:
    """Write uint8 RGB pairs as `out_dir/image_{2,3}/<id>.png`, cropped to
    each frame's content: its size before padding (DSGN), or its resized
    size at network scale (Stereo R-CNN batches, `net_hw`)."""
    if writer is None:
        adv_left, adv_right = fetch_np(adv_left), fetch_np(adv_right)
    sizes = batch.get("net_hw", batch["orig_hw"])
    for i, fid in enumerate(batch["frame_ids"]):
        hw = sizes[i]
        for sub, adv in (("image_2", adv_left), ("image_3", adv_right)):
            path = os.path.join(out_dir, sub, fid + ".png")
            if writer is not None:
                writer.put(path, adv[i], crop_hw=hw)
            else:
                K.save_image(path, adv[i], crop_hw=hw)
