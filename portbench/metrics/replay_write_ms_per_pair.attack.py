"""Host ms per pair of the sweep's host side on the replay threads: the
native replay of the packed signs (attack/replay_native.py
replay_sweep_u8), the Stereo R-CNN's clean resize (data/dataset.py
srcnn_cleanv_q0_host) and handing every PNG to the writer (save_sweep,
which waits when the writer's queue is full). The sign fetch, which
waits for the card, is left out."""
from portbench import readers

LAYER = "host data (data/dataset.py)"
UNIT = "ms"
MOVES = "attack_pairs_per_s"
read = readers.span_ms_per_pair("replay_write")
