"""The depth-tap conv's bytes and operations, copied from the port's chip
check, give the bounds that check printed at DSGNConfig.full()'s
shapes (chip_smoke.py's `kernel_detail` line, H100 run of the port's
twenty-third slice)."""
import pytest

from portbench import counts

# (kernel, (B, D, N, C, F), dtype) -> bound_ms as chip_smoke.py printed it
CHIP_SMOKE = {
    ("fwd", (1, 96, 29952, 32, 32), "bfloat16"): 0.10986759641791044,
    ("bwd", (1, 96, 29952, 32, 32), "bfloat16"): 0.16480045850746267,
    ("fwd", (1, 48, 7488, 64, 64), "bfloat16"): 0.02747384358208955,
    ("bwd", (1, 48, 7488, 64, 64), "bfloat16"): 0.04120705910447761,
    ("fwd", (1, 24, 1872, 64, 64), "bfloat16"): 0.003440716417910448,
    ("bwd", (1, 24, 1872, 64, 64), "bfloat16"): 0.005157368358208955,
    ("fwd", (1, 288, 3040, 32, 32), "bfloat16"): 0.03345457671641791,
    ("bwd", (1, 288, 3040, 32, 32), "bfloat16"): 0.05018092895522388,
    ("fwd", (1, 96, 29952, 32, 32), "float32"): 0.26367773802985073,
    ("bwd", (1, 96, 29952, 32, 32), "float32"): 0.32960091701492533,
    ("fwd", (1, 48, 7488, 64, 64), "float32"): 0.13183886901492536,
    ("bwd", (1, 48, 7488, 64, 64), "float32"): 0.13183886901492536,
    ("fwd", (1, 24, 1872, 64, 64), "float32"): 0.01647985862686567,
    ("bwd", (1, 24, 1872, 64, 64), "float32"): 0.01647985862686567,
    ("fwd", (1, 288, 3040, 32, 32), "float32"): 0.08028649074626865,
    ("bwd", (1, 288, 3040, 32, 32), "float32"): 0.10036185791044776,
}


def test_the_shapes_are_chip_smokes():
    import chip_smoke
    from eval_driving_safety_tpu_torch.config import DSGNConfig
    shapes = set(map(tuple, chip_smoke.depthconv_shapes(DSGNConfig.full())))
    assert shapes == {s for _, s, _ in CHIP_SMOKE}
    assert chip_smoke.PEAK_BYTES == counts.PEAK_BYTES
    assert chip_smoke.PEAK_OPS == counts.PEAK_OPS


@pytest.mark.parametrize("key", sorted(CHIP_SMOKE), ids=str)
def test_bound_per_shape(key):
    kind, shape, dtype = key
    isz = 2 if dtype == "bfloat16" else 4
    fn = counts.depth_tap_conv_fwd if kind == "fwd" else \
        counts.depth_tap_conv_dx
    got = counts.bound_s(*fn(*shape, isz), dtype) * 1e3
    assert got == pytest.approx(CHIP_SMOKE[key], rel=1e-12)


def test_summed_bound_of_calls():
    calls = [((1, 96, 29952, 32, 32), "bfloat16", True),
             ((1, 288, 3040, 32, 32), "bfloat16", False)]
    want = (CHIP_SMOKE[("fwd", (1, 96, 29952, 32, 32), "bfloat16")]
            + CHIP_SMOKE[("bwd", (1, 96, 29952, 32, 32), "bfloat16")]
            + CHIP_SMOKE[("fwd", (1, 288, 3040, 32, 32), "bfloat16")])
    assert counts.depth_tap_conv_bound_s(calls) * 1e3 == pytest.approx(
        want, rel=1e-12)
