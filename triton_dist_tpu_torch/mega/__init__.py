"""Megakernel subsystem of the port: counterpart of triton_dist_tpu/mega
(the same exports). Each decode layer runs as ONE launch of a persistent
cooperative CUDA kernel whose phases are the tasks MegaKernelBuilder
recorded and validated; on the CPU the same tasks run as plain PyTorch.
What the fusion removes on this card is the host's per-op launch cost
(about 65 device launches per layer on the per-op path) and the device
memory round trips between the ops.
"""

from triton_dist_tpu_torch.mega.builder import MegaKernelBuilder  # noqa: F401
from triton_dist_tpu_torch.mega.decode_layer import (  # noqa: F401
    MegaDecodeLayer,
    MegaPagedDecodeLayer,
    mega_decode_layer_ref,
    mega_paged_decode_layer_ref,
)
