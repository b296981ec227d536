"""Runtime helpers of the port (device choice)."""

from triton_dist_tpu_torch.runtime.device import resolve_device  # noqa: F401
