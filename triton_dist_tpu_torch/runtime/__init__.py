"""Runtime helpers of the port: device choice, the mesh and symmetric
buffers."""

from triton_dist_tpu_torch.runtime.bootstrap import Mesh, make_mesh, mesh_of  # noqa: F401
from triton_dist_tpu_torch.runtime.device import resolve_device  # noqa: F401
