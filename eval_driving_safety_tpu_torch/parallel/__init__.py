"""The batch split (data parallelism) and the model axis (the plane-sweep
volume's depth planes) over torch.distributed."""
from eval_driving_safety_tpu_torch.parallel.sharding import (  # noqa: F401
    BatchSharding,
    Mesh,
    dp_sharding,
    global_mean,
    global_sum,
    make_mesh,
    shard_batch,
    sharded_patch_step,
    sharded_pgd_step,
)
from eval_driving_safety_tpu_torch.parallel.volume import (  # noqa: F401
    VolumeShard,
    constrain_psv,
)
