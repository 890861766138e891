"""Predict and KITTI export on one CUDA card: DSGN and Stereo R-CNN.

Counterpart of `eval_driving_safety_tpu.cli.predict_and_save`, with the
same flags and the same output layout: run the detector over (attacked)
image dirs and write
  <result_dir>/data/<id>.txt       16-field KITTI detection lines,
  <result_dir>/metrics.jsonl       depth error metrics (DSGN) and the AP
                                   table,
  <result_dir>/refer/<id>.png      detection panels (--plot),
and on request the input images and every submodule's activations,
and for DSGN the depth maps (.npy) and pseudo-lidar clouds (.bin).
`--patch_npy` composites a trained patch before the forward in one of
four placements (`--patch_mode`).

DSGN (`--detector dsgn`): frames go to the card as raw uint8; forward,
score map, top-k, rotated NMS and box decode run there, and only the
(B, max_detections) detections come back, in one fetch per batch. On
random weights (no `--ckpt`) the BEV head's class bias of -4.59 keeps
every score under the default threshold of 0.1, so the txts are empty.

Stereo R-CNN (`--detector srcnn`, StereoRCNNConfig(), bf16 unless
`--fp32`): the card resizes the uint8 frames to the network's 600 rows
exactly (data.exact_resize) and runs the forward on every post-NMS
proposal; the outputs come back in one fetch per batch, and the host
decodes them, runs NMS and the 3D box solve; the dense alignment runs
on the card's network-scale images (inference.stereo_rcnn_predict).

Usage:
  python -m eval_driving_safety_tpu_torch.cli.predict_and_save \\
      --detector dsgn --data_path KITTI/object/training \\
      --split_file val.txt --image_2_dir dsgn_pgd_iters_4/image_2 \\
      --image_3_dir dsgn_pgd_iters_4/image_3 --ckpt ck/epoch10 \\
      --result_dir results --eval_ap --scale paper
  python -m eval_driving_safety_tpu_torch.cli.predict_and_save \\
      --detector srcnn --data_path KITTI/object/training \\
      --split_file val.txt --ckpt srcnn_state.pt --result_dir results \\
      --eval_ap
"""
from __future__ import annotations

import argparse
import os
import time
from functools import partial

import numpy as np
import torch

from eval_driving_safety_tpu_torch.cli.common import (
    add_dataset_args, add_device_args, add_scale_args, append_metrics, log,
    make_dataset, make_dsgn_cfg, make_dsgn_model, metrics_path,
    use_deterministic_kernels)
from eval_driving_safety_tpu_torch.config import PLACEMENT_BANDS


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    add_dataset_args(p)
    p.add_argument("--detector", choices=("dsgn", "srcnn"), default="dsgn")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--result_dir", default="results")
    p.add_argument("--patch_npy", default=None,
                   help="composite this trained patch before inference")
    p.add_argument("--patch_mode", choices=tuple(PLACEMENT_BANDS),
                   default="random")
    p.add_argument("--eval_ap", action="store_true",
                   help="score AP vs the dataset's label_2 after export: "
                        "full easy/moderate/hard table")
    p.add_argument("--eval_classes", default="Car",
                   help="comma-separated classes for --eval_ap")
    p.add_argument("--depth_dir", default=None,
                   help="depth gt .npy dir for depth error metrics")
    p.add_argument("--save_feat_dir", default=None,
                   help="dump every submodule's activations per frame")
    p.add_argument("--save_input_dir", default=None,
                   help="dump the network input images (after any patch "
                        "compositing) as image_2/image_3 pngs")
    p.add_argument("--save_depth_dir", default=None,
                   help="dump predicted depth maps as .npy")
    p.add_argument("--save_lidar_dir", default=None,
                   help="dump pseudo-lidar point clouds as .bin")
    p.add_argument("--plot", action="store_true",
                   help="save detection panels (left+right boxes + BEV) to "
                        "result_dir/refer/<id>.png")
    p.add_argument("--vis_thresh", type=float, default=0.7)
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the patch placements")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 trunk for the srcnn detector (already "
                        "its default; DSGN takes its dtype from the "
                        "config)")
    p.add_argument("--fp32", action="store_true",
                   help="float32 trunk for the srcnn detector, with TF32 "
                        "off")
    add_scale_args(p)
    add_device_args(p)
    return p.parse_args(argv)


class Normalizer:
    """[0,1] RGB -> the model's ImageNet-normalized input, on `device`."""

    def __init__(self, cfg, device):
        self.mean = torch.tensor(cfg.input.mean, dtype=torch.float32,
                                 device=device)
        self.std = torch.tensor(cfg.input.std, dtype=torch.float32,
                                device=device)

    def __call__(self, x01):
        return (x01 - self.mean) / self.std


def upload(b, device):
    """A prepared batch's frames as [0,1] f32 on `device` (uploaded as
    uint8) and its calibration vectors."""
    from eval_driving_safety_tpu_torch.data.dataset import u8_to_01

    def put(x):
        return torch.as_tensor(x).to(device, non_blocking=True)
    return (u8_to_01(put(b["im_left_u8"])), u8_to_01(put(b["im_right_u8"])),
            tuple(put(b[k]) for k in ("f_u", "baseline", "c_u", "c_v")))


def predict(model, cfg, norm, il01, ir01, calib):
    """Forward and decode on the inputs' device -> (host detections, the
    device outputs)."""
    from eval_driving_safety_tpu_torch.inference.fcos3d_post import (
        decode_bev_outputs, fetch_detections)
    out = model(norm(il01), norm(ir01), *calib)
    return fetch_detections(decode_bev_outputs(out, cfg)), out


def export_txts(result_dir, b, dets):
    """Each frame's detections as `result_dir/data/<id>.txt`; returns the
    KITTI dicts per frame."""
    from eval_driving_safety_tpu_torch.data.kitti import write_detections
    from eval_driving_safety_tpu_torch.inference.fcos3d_post import (
        Detections3D, detections_to_kitti)
    rows = []
    for i, fid in enumerate(b["frame_ids"]):
        row = Detections3D(*(f[i] for f in dets))
        kitti = detections_to_kitti(row, b["calibs"][i], b["orig_hw"][i])
        write_detections(os.path.join(result_dir, "data", fid + ".txt"),
                         kitti)
        rows.append(kitti)
    return rows


class FeatureRecorder:
    """Forward hooks on every submodule of a model: each call's output is
    kept, and `flat()` lists them as the JAX CLI's
    `capture_intermediates` dump names them: the module path, then
    `__call__`, then the call's index and the output's structure, joined
    by "_" (dict keys sorted, sequences as [i]), in sorted order."""

    def __init__(self, model):
        self.model = model
        self.calls = {}
        self.handles = []

    def __enter__(self):
        for name, mod in self.model.named_modules():
            path = tuple(name.split(".")) if name else ()
            self.handles.append(mod.register_forward_hook(
                lambda m, a, out, path=path:
                self.calls.setdefault(path, []).append(out)))
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        self.handles = []

    def flat(self):
        tree = {}
        for path, outs in self.calls.items():
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node["__call__"] = tuple(outs)
        leaves = []

        def walk(x, parts):
            if x is None:                 # an empty subtree, as in JAX
                return
            if isinstance(x, dict):
                for k in sorted(x):
                    walk(x[k], parts + (str(k),))
            elif isinstance(x, (tuple, list)):
                for i, v in enumerate(x):
                    walk(v, parts + (f"[{i}]",))
            else:
                leaves.append(("_".join(parts)[:120], x))
        walk(tree, ())
        return leaves


def _featdir(args, fid):
    d = os.path.join(args.save_feat_dir, fid)
    os.makedirs(d, exist_ok=True)
    return d


def _save_feats(args, b, feats, batch_axis_only=False):
    """Frame i's slice of every activation, as float32 .npy (bf16 ones
    widened: numpy has no bfloat16). With `batch_axis_only`, an
    activation whose first axis is not the batch's (the rois of the whole
    batch, flattened) is written whole for every frame."""
    n = len(b["frame_ids"])
    for i, fid in enumerate(b["frame_ids"]):
        d = _featdir(args, fid)
        for j, (name, val) in enumerate(feats):
            per_frame = val.dim() > 0 and (not batch_axis_only
                                           or val.shape[0] == n)
            v = val[i] if per_frame else val
            np.save(os.path.join(d, f"feat{j:02d}_{name}.npy"),
                    v.detach().float().cpu().numpy())


def _save_inputs(args, b, il, ir, to_rgb01=lambda x: x):
    """The network's input frames as PNGs; `to_rgb01` maps a frame's
    array to RGB [0,1]."""
    from eval_driving_safety_tpu_torch.data.kitti import save_image
    for i, fid in enumerate(b["frame_ids"]):
        for sub, img in (("image_2", il[i]), ("image_3", ir[i])):
            save_image(os.path.join(args.save_input_dir, sub, fid + ".png"),
                       to_rgb01(img.cpu().numpy()))


def composite(patch_npy, patch_mode, seed, il, ir, radius_shift=-64.0):
    """The patch of `patch_npy` composited into both views of a [0,1]
    batch (on its device) at centres drawn from `seed` in the
    `patch_mode` column band, the right view's shifted by the disparity
    offset."""
    from eval_driving_safety_tpu_torch.attack.patch import (
        composite_patch_batch, load_patch, sample_patch_centers)
    patch = load_patch(patch_npy)
    radius = patch.shape[0] // 2
    h, w = il.shape[1:3]
    cl, cr = sample_patch_centers(
        torch.Generator().manual_seed(seed), il.shape[0], h, w, radius,
        col_band=PLACEMENT_BANDS[patch_mode], disparity_shift=radius_shift)
    return (composite_patch_batch(il, patch, cl),
            composite_patch_batch(ir, patch, cr))


def _export_depth(args, b, i, fid, dp, il, ir, kitti):
    from eval_driving_safety_tpu_torch.inference.depth_export import (
        depth_to_points, save_depth_map, save_pseudo_lidar)
    if args.save_depth_dir:
        save_depth_map(os.path.join(args.save_depth_dir, fid + ".npy"), dp)
    if args.save_lidar_dir:
        save_pseudo_lidar(os.path.join(args.save_lidar_dir, fid + ".bin"),
                          dp, b["calibs"][i])
    if args.plot:
        from eval_driving_safety_tpu_torch.inference.vis import \
            save_detection_panel
        pts = depth_to_points(dp, b["calibs"][i], stride=4)
        save_detection_panel(
            os.path.join(args.result_dir, "refer", fid + ".png"),
            il[i].cpu().numpy(), ir[i].cpu().numpy(), kitti, points=pts,
            vis_thresh=args.vis_thresh)


def run_dsgn(args):
    from eval_driving_safety_tpu_torch.data.dataset import (
        fetch_np, prepare_dsgn_batch_u8)
    device = torch.device(args.device)
    use_deterministic_kernels(device)
    cfg = make_dsgn_cfg(args)
    model = make_dsgn_model(args, cfg, device)
    norm = Normalizer(cfg, device)
    ds = make_dataset(args)
    mpath = metrics_path(args.result_dir)
    depth_errs = []
    prep = partial(prepare_dsgn_batch_u8, cfg=cfg.input,
                   depth_dir=args.depth_dir)
    needs_depth = bool(args.save_depth_dir or args.save_lidar_dir
                       or args.plot)
    t0 = time.perf_counter()
    with torch.inference_mode():
        for b in ds.batches(args.batch, prepare=prep):
            il, ir, calib = upload(b, device)
            if args.patch_npy:
                il, ir = composite(args.patch_npy, args.patch_mode,
                                   args.seed, il, ir)
            if args.save_input_dir:
                _save_inputs(args, b, il, ir)
            if args.save_feat_dir:
                with FeatureRecorder(model) as rec:
                    dets, out = predict(model, cfg, norm, il, ir, calib)
                _save_feats(args, b, rec.flat())
            else:
                dets, out = predict(model, cfg, norm, il, ir, calib)
            rows = export_txts(args.result_dir, b, dets)
            # depth error metrics: gt depths in (min_depth, max_depth]
            gt = b["depth_gt"]
            m = (gt > cfg.min_depth) & (gt <= cfg.max_depth)
            depth = fetch_np(out["depth_preds"][-1]) \
                if needs_depth or m.any() else None
            for i, fid in enumerate(b["frame_ids"]):
                if needs_depth:
                    _export_depth(args, b, i, fid, depth[i], il, ir, rows[i])
                if m[i].any():
                    err = np.abs(depth[i] - gt[i])[m[i]]
                    depth_errs.append((float(err.mean()),
                                       float(np.median(err))))
            t1 = time.perf_counter()
            log(f"exported {len(b['frame_ids'])} frames "
                f"({(t1 - t0) * 1e3:.1f} ms)")
            t0 = t1
    if depth_errs:
        mean_err = float(np.mean([e[0] for e in depth_errs]))
        med_err = float(np.mean([e[1] for e in depth_errs]))
        log(f"depth error: mean {mean_err:.3f} m, median {med_err:.3f} m")
        append_metrics(mpath, {"depth_mean_err": mean_err,
                               "depth_median_err": med_err})
    _maybe_eval_ap(args, ds, mpath)


def run_srcnn(args):
    from eval_driving_safety_tpu_torch.cli.common import (
        make_srcnn_cfg, make_srcnn_model, use_srcnn_precision)
    from eval_driving_safety_tpu_torch.data.dataset import (
        prepare_srcnn_batch_u8, srcnn_clean01_device)
    from eval_driving_safety_tpu_torch.data.kitti import (srcnn_to_rgb01,
                                                          write_detections)
    from eval_driving_safety_tpu_torch.inference.stereo_rcnn_predict import (
        fetch_outputs, predict_image)
    device = torch.device(args.device)
    use_deterministic_kernels(device)
    cfg = make_srcnn_cfg(args, default_bf16=True)
    use_srcnn_precision(cfg)
    model, _ = make_srcnn_model(args, cfg, device)
    ds = make_dataset(args)
    mpath = metrics_path(args.result_dir)
    pix_means = cfg.input.pixel_means_bgr
    means = torch.tensor(pix_means, dtype=torch.float32, device=device)
    to_rgb01 = partial(srcnn_to_rgb01, pixel_means_bgr=pix_means)
    prep = partial(prepare_srcnn_batch_u8, cfg=cfg.input)

    def put(x):
        return torch.as_tensor(x).to(device, non_blocking=True)

    t0 = time.perf_counter()
    with torch.inference_mode():
        for b in ds.batches(args.batch, prepare=prep):
            weights = {k: put(b[k]) for k in ("ih", "iw", "den_h", "den_w",
                                              "wmask", "c")}
            # BGR pixels minus the means at network scale
            il = srcnn_clean01_device(weights, put(b["im_left_u8"])) \
                * 255.0 - means
            ir = srcnn_clean01_device(weights, put(b["im_right_u8"])) \
                * 255.0 - means
            if args.patch_npy:
                il, ir = composite(args.patch_npy, args.patch_mode,
                                   args.seed, il, ir)
            if args.save_input_dir:
                _save_inputs(args, b, il, ir, to_rgb01)
            if args.save_feat_dir:
                with FeatureRecorder(model) as rec:
                    out = model(il, ir, mode="infer")
                _save_feats(args, b, rec.flat(), batch_axis_only=True)
            else:
                out = model(il, ir, mode="infer")
            host = fetch_outputs(out)
            for i, fid in enumerate(b["frame_ids"]):
                scale = float(b["scales"][i])
                dets = predict_image(host, il[i], ir[i], b["calibs"][i], cfg,
                                     image_hw=b["orig_hw"][i],
                                     batch_index=i, image_scale=scale)
                write_detections(
                    os.path.join(args.result_dir, "data", fid + ".txt"),
                    dets)
                if args.plot:
                    from eval_driving_safety_tpu_torch.inference.vis import \
                        save_detection_panel
                    # the panel is at network scale
                    save_detection_panel(
                        os.path.join(args.result_dir, "refer", fid + ".png"),
                        to_rgb01(il[i].cpu().numpy()),
                        to_rgb01(ir[i].cpu().numpy()),
                        [dict(d, bbox=d["bbox"] * scale) for d in dets],
                        vis_thresh=args.vis_thresh)
            t1 = time.perf_counter()
            log(f"exported {len(b['frame_ids'])} frames "
                f"({(t1 - t0) * 1e3:.1f} ms)")
            t0 = t1
    _maybe_eval_ap(args, ds, mpath)


def _maybe_eval_ap(args, ds, mpath):
    if not args.eval_ap:
        return
    from eval_driving_safety_tpu_torch.evalap.kitti_ap import (
        CLASS_IOU_THRESH, evaluate_folders_full, format_ap_table)
    classes = tuple(c.strip() for c in args.eval_classes.split(",")
                    if c.strip())
    table = evaluate_folders_full(
        ds.label_dir, os.path.join(args.result_dir, "data"), classes)
    log(format_ap_table(table))
    summary_cls = "Car" if "Car" in table else next(iter(table))
    r = table[summary_cls]["moderate"]
    log(f"AP ({summary_cls}, moderate, "
        f"IoU {CLASS_IOU_THRESH.get(summary_cls, 0.5):.2f}): "
        f"bbox {r['ap_bbox']:.4f} "
        f"bev {r['ap_bev']:.4f} 3d {r['ap_3d']:.4f}")
    append_metrics(mpath, {"ap_table": table, **r})


def main(argv=None):
    args = parse_args(argv)
    (run_dsgn if args.detector == "dsgn" else run_srcnn)(args)


if __name__ == "__main__":
    main()
