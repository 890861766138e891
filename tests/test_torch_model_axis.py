"""The model axis (parallel/volume.py) on the CPU over gloo: DSGN's
plane-sweep volume split by depth plane over the ranks of a model group.

The ranks are subprocesses with the torchrun environment
(chip_smoke.launch_ranks) running tests/torch_model_axis_ranks.py: at
world 2 and world 4 each primitive against the whole tensor (forward,
and the ranks' input gradients against the whole gradient), each sharded
op of the tiny DSGN against its whole version, and the tiny DSGN on the
(1, 2) and (2, 2) meshes and the tiny compat model on the (1, 2) mesh
against the JAX package's models under its `constrain_psv` on the
suite's virtual CPU devices (the JAX package's default `psv_method` and
`depthconv_method`, as tests/test_torch_dsgn.py's library case runs
them), each model also with remat: the hourglass recomputed in the
backward pass, halo exchanges and all, against JAX's remat models, and
bit for bit against the same ranks without it. All in fp32, with tests/test_torch_dsgn.py's tolerances: outputs
rtol 1e-4 and the loss 1e-5, with a floor of 1e-4 x the largest
reference magnitude; input gradients rtol 1e-3 with a floor of 1e-3 x
the largest. A sharded op against its whole version in the port is held
to rtol 1e-5 (the same arithmetic but for the order of a few sums); the
primitives move data, so they are exact, but for copy_to_model's sum of
partial gradients (1e-6).

Then `parallel.dryrun` at world 4 on the (2, 2) mesh at --scale tiny,
and the two refusals: a plane count that does not divide by 4 x n_model,
and a parameter that needs a gradient."""
import concurrent.futures as cf
import dataclasses
import functools
import json
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

import torch_model_axis_ranks as R
from eval_driving_safety_tpu_torch.parallel import sharding as S
from eval_driving_safety_tpu_torch.parallel import volume as V

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

ENV = dict(os.environ, OMP_NUM_THREADS="1")
TIMEOUT = 300


def launch(world, argv):
    results = chip_smoke.launch_ranks(world, argv, TIMEOUT, env=ENV,
                                      cwd=str(ROOT))
    for rank, (rc, out, err) in enumerate(results):
        assert rc == 0, f"rank {rank} of {world} exited {rc}:\n{err[-3000:]}"
    return [out for _, out, _ in results]


def _close(got, want, rtol, floor):
    want = np.asarray(want)
    assert np.shape(got) == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=floor * max(np.abs(want).max(), 1e-12))


def _norm(x):
    return (x - R.MEAN255) / R.STD255


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """One set of weights in both packages for each model: the JAX tiny
    DSGN's init bridged to the port, and the port's seeded compat model
    imported into the JAX package (tests/test_torch_dsgn_compat.py's
    weights)."""
    import jax
    from eval_driving_safety_tpu.config import DSGNConfig as JaxDSGNConfig
    from eval_driving_safety_tpu.models.dsgn import DSGN as JaxDSGN
    from eval_driving_safety_tpu.utils import torch_import as JI
    from eval_driving_safety_tpu_torch.utils.from_flax import \
        dsgn_state_dict_from_flax
    from test_torch_dsgn_compat import TINY, _upstream_sd
    d = tmp_path_factory.mktemp("weights")
    jcfg = dataclasses.replace(JaxDSGNConfig.tiny(), dtype="float32")
    il, ir, calib = R.model_inputs()[:3]
    params = jax.jit(JaxDSGN(jcfg).init)(jax.random.PRNGKey(1), _norm(il),
                                         _norm(ir), *calib)
    torch.save(dsgn_state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, params)), d / "dsgn.pt")
    _, sd = _upstream_sd(seed=3)
    torch.save({k.removeprefix("module."): v for k, v in sd.items()
                if not k.endswith("num_batches_tracked")}, d / "compat.pt")
    jimp = JI.import_dsgn({k: v.numpy() for k, v in sd.items()})
    return dict(dir=d, dsgn=params, compat=jimp["params"],
                compat_arch=dataclasses.replace(jimp["arch"],
                                                spp_pools=TINY.spp_pools))


@pytest.fixture(scope="module")
def ranks(weights, tmp_path_factory):
    """Both launches at once, in the background: {world: future of each
    rank's results}. A test that needs JAX's side asks for it after this,
    so that JAX compiles while the ranks run."""
    out = tmp_path_factory.mktemp("ranks")

    def run(world):
        path = out / f"w{world}_rank{{rank}}.npz"
        launch(world, [sys.executable, str(ROOT / "tests" /
                                           "torch_model_axis_ranks.py"),
                       str(path), str(weights["dir"])])
        return [dict(np.load(str(path).replace("{rank}", str(r))))
                for r in range(world)]
    with cf.ThreadPoolExecutor(2) as ex:
        yield {w: ex.submit(run, w) for w in (2, 4)}


# ----- (a) the primitives against the whole tensor -----

@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("primitive", ["copy_to_model", "gather_planes",
                                       "gather_planes_ragged",
                                       "halo_exchange"])
def test_primitive_matches_the_whole_tensor(ranks, world, primitive):
    """Forward, each rank's part of the whole result; backward, each
    rank's input gradient is its part of the whole loss's gradient,
    counted once: copy_to_model's is the whole gradient on every rank
    (the sum of the ranks' partials), a gather's the rank's slice (not
    n times it), a halo's the sum of what each window read."""
    res = ranks[world].result()
    vol, cot, ragged, rcot = R.primitive_inputs(world)
    t = f"w{world}_"
    for m, r in enumerate(res):
        mine = slice(4 * m, 4 * m + 4)
        if primitive == "copy_to_model":
            np.testing.assert_array_equal(r[t + "copy_fwd"], vol)
            np.testing.assert_allclose(r[t + "copy_grad"], cot, rtol=1e-6,
                                       atol=1e-6)
        elif primitive == "gather_planes":
            np.testing.assert_array_equal(r[t + "gather_fwd"], vol)
            np.testing.assert_array_equal(r[t + "gather_grad"],
                                          cot[:, mine])
        elif primitive == "gather_planes_ragged":
            first = m * (m + 1) // 2
            np.testing.assert_array_equal(r[t + "ragged_fwd"], ragged)
            np.testing.assert_array_equal(r[t + "ragged_grad"],
                                          rcot[:, first:first + m + 1])
    if primitive != "halo_exchange":
        return
    for lo, hi in R.HALOS:
        padded = np.pad(vol, ((0, 0), (lo, hi), (0, 0), (0, 0)))
        read = np.zeros_like(padded)
        for m, r in enumerate(res):
            window = slice(4 * m, 4 * m + 4 + lo + hi)
            np.testing.assert_array_equal(r[t + f"halo{lo}{hi}_fwd"],
                                          padded[:, window])
            read[:, window] += R.halo_cotangent(world, m, lo, hi)
        got = np.concatenate([r[t + f"halo{lo}{hi}_grad"] for r in res], 1)
        np.testing.assert_allclose(got, read[:, lo:lo + 4 * world],
                                   rtol=1e-6, atol=1e-6)


# ----- (b) the sharded ops of the tiny DSGN against their whole versions

@pytest.mark.parametrize("op", ["depth_stage_s1", "depth_stage_s2",
                                "upsample_d", "score3d", "soft_argmin",
                                "psv_to_3dgv"])
def test_sharded_op_matches_its_whole_version(ranks, op):
    """Each rank's output is its planes of the whole op's (the whole
    output where the op ends in a gather), and its input gradient its
    planes of the whole gradient, on DSGNConfig.tiny() over 2 ranks."""
    for r in ranks[2].result():
        got, want = r["op_" + op]
        _close(got, want, 1e-5, 1e-6)
        got, want = r["op_" + op + "_grad"]
        _close(got, want, 1e-5, 1e-6)


# ----- (c), (d) the tiny models against the JAX package's constrain_psv

def _jax_dsgn(params, mesh_shape, remat=False):
    import jax
    from eval_driving_safety_tpu.config import DSGNConfig as JaxDSGNConfig
    from eval_driving_safety_tpu.models.dsgn import DSGN as JaxDSGN
    from eval_driving_safety_tpu.models.rpn3d_loss import dsgn_total_loss
    from eval_driving_safety_tpu.parallel.sharding import (constrain_psv,
                                                           make_mesh)
    jcfg = dataclasses.replace(JaxDSGNConfig.tiny(), dtype="float32",
                               remat=remat)
    jm = JaxDSGN(jcfg, volume_constraint=functools.partial(
        constrain_psv, mesh=make_mesh(*mesh_shape)))
    il, ir, calib, depth, boxes, nb = R.model_inputs()
    if remat:
        # nn.remat's module is named CheckpointHourglass3D_0
        tree = dict(params["params"])
        tree["CheckpointHourglass3D_0"] = tree.pop("Hourglass3D_0")
        params = {**params, "params": tree}

    def loss_fn(l255, r255):
        out = jm.apply(params, _norm(l255), _norm(r255), *calib)
        return dsgn_total_loss(out, depth, boxes, nb, jcfg)[0], out
    (total, out), grads = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(il, ir)
    return float(total), jax.tree_util.tree_map(np.asarray, out), [
        np.asarray(g) for g in grads]


# the halo exchanges a rank makes in one PGD step, (forward, backward):
# with remat the hourglass's forward runs again inside the backward pass,
# and with it its exchanges (the fast model's 9, the compat model's 6);
# the backward's own exchanges are the same
HALO_CALLS = {("dsgn", False): [14, 14], ("dsgn", True): [23, 14],
              ("compat", False): [14, 14], ("compat", True): [20, 14]}


def _same_as_without_remat(res, tag, plain_tag):
    """Every result a rank recorded with remat equals, bit for bit, the
    same rank's result without it (the halo counts aside)."""
    for r in res:
        for k in r:
            if k.startswith(tag) and not k.endswith("halo_calls"):
                np.testing.assert_array_equal(
                    r[k], r[plain_tag + k[len(tag):]], k)


@pytest.mark.parametrize("mesh_shape,remat", [
    pytest.param((1, 2), False, id="mesh1x2"),
    pytest.param((2, 2), False, id="mesh2x2"),
    pytest.param((1, 2), True, id="mesh1x2-remat"),
    pytest.param((2, 2), True, id="mesh2x2-remat")])
def test_tiny_dsgn_matches_jax_constrain_psv(ranks, weights, mesh_shape,
                                             remat):
    """The tiny DSGN on the (1, 2) mesh (the batch of 2 whole on both
    model ranks) and the (2, 2) mesh (a row a data row): depth maps, BEV
    outputs, the whole batch's loss and both image gradients against
    JAX's DSGN(cfg, volume_constraint=partial(constrain_psv, mesh)); the
    model ranks of a data row hold the same bits, and each rank made 14
    halo exchanges forward and 14 back. With remat (cfg.remat, JAX's
    nn.remat) against JAX's remat model, and bit for bit the same ranks'
    results without it."""
    n_data, n_model = mesh_shape
    res = ranks[n_data * n_model].result()
    loss, out, grads = _jax_dsgn(weights["dsgn"], mesh_shape, remat)
    t = f"m{n_data}{n_model}{'r' if remat else ''}_"
    for row in range(n_data):
        group = res[row * n_model:(row + 1) * n_model]
        for r in group[1:]:
            for k in group[0]:
                if k.startswith(t):
                    np.testing.assert_array_equal(r[k], group[0][k], k)
    heads = res[::n_model]
    rows = np.concatenate([r[t + "rows"] for r in heads])
    assert rows.tolist() == list(range(R.BATCH))
    cat = lambda k: np.concatenate([r[t + k] for r in heads])
    for i, want in enumerate(out["depth_preds"]):
        _close(cat(f"depth{i}"), want, 1e-4, 1e-4)
    for k in ("bbox_cls", "bbox_reg", "bbox_centerness"):
        _close(cat(k), out[k], 1e-4, 1e-4)
    for r in res:
        _close(r[t + "loss"], loss, 1e-5, 1e-6)
        assert r[t + "halo_calls"].tolist() == HALO_CALLS["dsgn", remat]
    _close(cat("grad_l"), grads[0], 1e-3, 1e-3)
    _close(cat("grad_r"), grads[1], 1e-3, 1e-3)
    if remat:
        _same_as_without_remat(res, t, f"m{n_data}{n_model}_")


def _check_tiny_compat(ranks, weights, remat):
    """The tiny compat model on the (1, 2) mesh against the JAX compat
    model under constrain_psv (with remat, its remat model)."""
    import jax
    from eval_driving_safety_tpu.config import DSGNConfig as JaxDSGNConfig
    from eval_driving_safety_tpu.models import dsgn_compat as JC
    from eval_driving_safety_tpu.models.rpn3d_loss import dsgn_total_loss
    from eval_driving_safety_tpu.parallel.sharding import (constrain_psv,
                                                           make_mesh)
    res = ranks[2].result()
    jcfg = dataclasses.replace(JaxDSGNConfig.tiny(), dtype="float32",
                               remat=remat)
    jm = JC.DSGNCompat(jcfg, weights["compat_arch"],
                       volume_constraint=functools.partial(
                           constrain_psv, mesh=make_mesh(1, 2)))
    il, ir, calib, depth, boxes, nb = R.compat_inputs()

    def loss_fn(l, r):
        out = jm.apply({"params": weights["compat"]}, l, r, *calib)
        return dsgn_total_loss(out, depth, boxes, nb, jcfg)[0], out
    (loss, out), grads = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(il, ir)
    t = "compatr_" if remat else "compat_"
    for k in res[0]:
        if k.startswith(t):
            np.testing.assert_array_equal(res[1][k], res[0][k], k)
    r = res[0]
    _close(r[t + "depth"], out["depth_preds"][0], 1e-4, 1e-4)
    for k in ("bbox_cls", "bbox_reg", "bbox_centerness"):
        _close(r[t + k], out[k], 1e-4, 1e-4)
    _close(r[t + "loss"], float(loss), 1e-5, 1e-6)
    _close(r[t + "grad_l"], grads[0], 1e-3, 1e-3)
    _close(r[t + "grad_r"], grads[1], 1e-3, 1e-3)
    assert r[t + "halo_calls"].tolist() == HALO_CALLS["compat", remat]
    if remat:
        _same_as_without_remat(res, t, "compat_")


def test_tiny_compat_matches_jax_constrain_psv(ranks, weights):
    """The tiny compat model on the (1, 2) mesh against the JAX compat
    model under constrain_psv: depth map, BEV outputs, loss and both
    image gradients, the same bits on both model ranks."""
    _check_tiny_compat(ranks, weights, remat=False)


def test_tiny_compat_with_remat_matches_jax_constrain_psv(ranks, weights):
    """The same with remat (cfg.remat; JAX's nn.remat): its hourglass
    recomputed in the backward pass, halo exchanges and all, against
    JAX's remat model, and bit for bit the ranks' results without it."""
    _check_tiny_compat(ranks, weights, remat=True)


# ----- (e) the dry run; (f) the refusals -----

def test_dryrun_on_the_2x2_mesh():
    """parallel.dryrun at world 4 (mesh (2, 2), --scale tiny): every rank
    exits 0 (the restored patch is the saved one bit for bit on every
    rank, or the run raises), the loss is finite and the patch moved;
    rank 0 prints JAX's line."""
    outs = launch(4, [sys.executable, "-m",
                      "eval_driving_safety_tpu_torch.parallel.dryrun",
                      "--scale", "tiny", "--device", "cpu"])
    lines = outs[0].strip().splitlines()
    rec = json.loads(lines[-2])["dryrun"]
    assert lines[-1].startswith(
        "dryrun_multichip(4): DSGN mesh={'data': 2, 'model': 2} h=96 "
        "w=320 D=16 loss=") and lines[-1].endswith("ckpt-restore OK")
    assert np.isfinite(rec["loss"]) and np.isfinite(rec["loss2"])
    assert rec["patch_max_change"] > 0 and rec["second_step_moved"] > 0
    assert rec["traffic"]["halo_exchange.fwd"]["calls"] == 14
    assert not any(o.strip() for o in outs[1:])


def _lone_shard(rank=0):
    """Model rank `rank` of a (1, 2) mesh, with no process group: enough
    for the checks that run before any collective."""
    return V.VolumeShard(S.Mesh(2, rank, torch.device("cpu"), 2))


def test_planes_that_do_not_divide_by_4_n_model_raise():
    assert _lone_shard(1).planes(16) == (8, 16)
    with pytest.raises(ValueError, match="divide by 4 x 2 = 8"):
        _lone_shard().planes(20)
    from eval_driving_safety_tpu_torch.models.dsgn import DSGN
    cfg = dataclasses.replace(R.tiny_cfg(), num_depth_planes=12)
    model = DSGN(cfg, volume_constraint=_lone_shard()).requires_grad_(False)
    x = torch.zeros(1, 96, 320, 3)
    with pytest.raises(ValueError, match="12 depth planes over 2"):
        model(x, x, *(torch.ones(1),) * 4)


@pytest.mark.parametrize("model_name", ["dsgn", "compat"])
def test_a_parameter_that_needs_a_gradient_raises(model_name):
    """The model axis gives input gradients only: a model with a
    parameter that needs a gradient refuses to run on it. A mesh without
    a model axis constrains nothing."""
    from eval_driving_safety_tpu_torch.models import dsgn_compat as TC
    from eval_driving_safety_tpu_torch.models.dsgn import DSGN
    cfg = R.tiny_cfg()
    model = (DSGN(cfg, volume_constraint=_lone_shard())
             if model_name == "dsgn" else
             TC.DSGNCompat(cfg, TC.DSGNCompatArch.tiny(),
                           volume_constraint=_lone_shard()))
    model.requires_grad_(False)
    next(model.parameters()).requires_grad_(True)
    x = torch.zeros(1, 96, 320, 3)
    with pytest.raises(RuntimeError, match="input gradients only"):
        model(x, x, *(torch.ones(1),) * 4)
    assert V.constrain_psv(S.Mesh(2, 0, torch.device("cpu"))) is None
