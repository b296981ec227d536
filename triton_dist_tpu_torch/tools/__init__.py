"""Measurement scripts of the port, run on the card as modules
(`python3 -m triton_dist_tpu_torch.tools.<name>`); nothing here runs at
import time."""
