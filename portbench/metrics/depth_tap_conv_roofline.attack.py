"""The depth-tap conv's share of its roofline: its calls' bound over the
device time of the kernels they launch, forward and backward."""
from portbench import readers

LAYER = "ops (ops/depthconv.py)"
UNIT = "%"
MOVES = "attack_pairs_per_s"
install = readers.mark_depth_tap_conv
read = readers.depth_tap_conv_roofline
