"""Share of the traced window in which no operation ran on the card."""
from portbench import readers

LAYER = "device"
UNIT = "%"
MOVES = "attack_pairs_per_s"
read = readers.device_idle_pct
