"""Write the committed orbax fixture tests/torch_fixtures/orbax_dsgn_tiny/.

It is what the JAX package's DSGN trainer writes at `--tiny`
(DSGNConfig.tiny(), bf16) after one epoch over chip_smoke.write_frames'
two seeded frames: `epoch1/`, an orbax PyTree checkpoint of `params`,
the optax chain's `opt_state` and `epoch`. Beside it, `digests.json`
holds each leaf's shape, dtype and SHA-256 (scalars by value) as the JAX
package's `restore_checkpoint` gives them (chip_smoke.leaf_digests).
chip_smoke.py's phase 14 reads the fixture on a machine without JAX, and
tests/test_torch_orbax.py holds it against this restore.

    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_orbax_dsgn_tiny.py
"""
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
from eval_driving_safety_tpu.cli import train_detector  # noqa: E402
from eval_driving_safety_tpu.utils.checkpoint import \
    restore_checkpoint  # noqa: E402

OUT = os.path.join(ROOT, chip_smoke.ORBAX_FIXTURE)


def jax_digests(path):
    """chip_smoke.leaf_digests of the JAX package's restore of `path`."""
    tree = jax.tree_util.tree_map(
        lambda x: np.asarray(x) if isinstance(x, jax.Array) else x,
        restore_checkpoint(path))
    return chip_smoke.leaf_digests(tree)


def main():
    shutil.rmtree(OUT, ignore_errors=True)
    with tempfile.TemporaryDirectory() as tmp:
        chip_smoke.write_frames(tmp, ["000001", "000002"])
        train_detector.main(["--data_path", tmp, "--detector", "dsgn",
                             "--tiny", "--epochs", "1", "--ckpt_every", "1",
                             "--ckpt_dir", OUT])
    digests = jax_digests(os.path.join(OUT, "epoch1"))
    with open(os.path.join(OUT, "digests.json"), "w") as f:
        f.write("{\n" + ",\n".join(
            f"{json.dumps(k)}: {json.dumps(digests[k], sort_keys=True)}"
            for k in sorted(digests)) + "\n}\n")


if __name__ == "__main__":
    main()
