"""Device ms per PGD iteration under the port's roi_align_fwd /
roi_align_bwd profiler ranges."""
from portbench import readers

LAYER = "ops (ops/roi_align.py)"
UNIT = "ms"
MOVES = "attack_pairs_per_s"
read = readers.roi_align_ms_per_iter
