"""The batch split over torch.distributed (data parallelism)."""
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
