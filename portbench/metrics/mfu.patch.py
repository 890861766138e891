"""The model's operations per patch step (a forward and input-gradient
pass over the batch, counted on the plain reference) times the steps
completed once the profiler had stopped, over that part of the window,
as a share of the card's bf16 peak."""
from portbench import readers

LAYER = "model + loss (models/*)"
UNIT = "%"
MOVES = "patch_steps_per_s"
read = readers.mfu("patch")
