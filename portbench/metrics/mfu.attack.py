"""The model's operations per pair (forward and input gradient of each
PGD iteration, counted on the plain reference) times the pairs completed
once the profiler had stopped, over that part of the window, as a share
of the card's bf16 peak."""
from portbench import readers

LAYER = "model + loss (models/*)"
UNIT = "%"
MOVES = "attack_pairs_per_s"
read = readers.mfu("attack")
