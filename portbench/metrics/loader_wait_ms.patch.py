"""Host ms per batch that the CLI's loop waits in
KittiStereoDataset.batches (PNG decode and batch preparation not hidden
by the prefetch)."""
from portbench import readers

LAYER = "host data (data/dataset.py)"
UNIT = "ms"
MOVES = "patch_steps_per_s"
read = readers.loader_wait_ms
