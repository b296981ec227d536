"""The fused expert-parallel MoE: counterpart of
triton_dist_tpu/kernels/ep_fused.py (`ep_moe_fused_device`, the TPU
kernel `_ep_fused_kernel` of its pallas_call).

One kernel per rank (csrc/ep_fused.cu) puts send slab p to peer p, runs
each local expert's SwiGLU MLP on every peer's rows as they land, and
stores the results straight into the origin's `y_back`. The send layout
groups the slots by global expert (layers/ep_moe.py `fwd_ep_fused` plans
one destination per expert), so peer p's slab arrives grouped by p's local
experts and no metadata travels: an unused slot is a zero row, and its
output a zero row. The expert panels may be int8 QuantW panels with
per-expert per-column scales; the gate/up scale applies to h before the
SwiGLU and the down scale after the down product, as in the TPU kernel.

The JAX tuning and measurement knobs (`resident_w`, `block_i`,
`weight_buffers`, `ablate`, `straggler`) shape how the TPU kernel stages
its panels in VMEM or feed the kprof and stress tools, none of which the
port has: anything but their defaults raises NotImplementedError.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels import _comm
from triton_dist_tpu_torch.kernels._build import DTYPE_CODES
from triton_dist_tpu_torch.kernels.quant import QuantW

# the kernel's tile (gemm_tile.cuh RowTile): rows and columns, by dtype
_TILE = {torch.bfloat16: 128, torch.float32: 64}


def _panels(w):
    """(panel tensor, f32 scales or None) of a plain or QuantW panel."""
    return (w.q, w.s.float()) if isinstance(w, QuantW) else (w, None)


def _expert_mlp(a: torch.Tensor, wgu, wd) -> torch.Tensor:
    """swiglu(a @ w_gu[e]) @ w_d[e] for a [E, C, D]: products in f32 (an
    int8 panel widened exactly, its scale applied per column after the
    product), the activation rounded to a's dtype, the result rounded
    once."""
    gq, gs = _panels(wgu)
    dq, ds = _panels(wd)
    h = torch.bmm(a.float(), gq.float())
    if gs is not None:
        h = h * gs[:, None, :]
    gate, up = h.chunk(2, dim=-1)
    act = (gate * torch.sigmoid(gate) * up).to(a.dtype)
    y = torch.bmm(act.float(), dq.float())
    if ds is not None:
        y = y * ds[:, None, :]
    return y.to(a.dtype)


def ep_moe_fused_device_ref(xs, wgu, wd, *, cap_e: int) -> list:
    """Plain version: y_back of origin o, slab p = the expert MLPs of peer
    p (its panels wgu[p], wd[p]) on slab p of xs[o], computed on p's
    device and returned to o's."""
    n = len(xs)
    E, D = _panels(wgu[0])[0].shape[:2]
    out = []
    for o, x in enumerate(xs):
        slabs = x.reshape(n, E, cap_e, D)
        out.append(torch.stack([
            _expert_mlp(slabs[p].to(_panels(wgu[p])[0].device), wgu[p], wd[p]).to(x.device)
            for p in range(n)]))
    return out


def ep_moe_fused_device(xs, wgu, wd, *, mesh, cap_e: int, resident_w=None, block_i=None,
                        weight_buffers: int = 2, ablate: frozenset = frozenset(),
                        straggler=None) -> list:
    """xs: each rank's send slots [n*E_loc*cap_e, D] (slab p = peer p's
    experts, global-expert-major); wgu: each rank's [E_loc, D, 2I] panels,
    wd: its [E_loc, I, D] (both plain, or both QuantW). Returns each
    rank's y_back [n, E_loc, cap_e, D]: slab p holds this rank's tokens
    processed on peer p, in their slot order."""
    if (resident_w is not None or block_i is not None or weight_buffers != 2 or ablate
            or straggler is not None):
        raise NotImplementedError("ep_moe_fused_device resident_w / block_i / "
                                  "weight_buffers / ablate / straggler: not yet ported")
    n = mesh.size
    quant = isinstance(wgu[0], QuantW)
    if quant != isinstance(wd[0], QuantW):
        raise ValueError("ep_moe_fused_device: quantize both expert weights or neither")
    gq = [_panels(w)[0] for w in wgu]
    dq = [_panels(w)[0] for w in wd]
    E, D, I2 = gq[0].shape
    I = I2 // 2
    _comm.check_parts(xs, mesh, "ep_moe_fused_device x")
    _comm.check_parts(gq, mesh, "ep_moe_fused_device w_gate_up", ndim=3)
    _comm.check_parts(dq, mesh, "ep_moe_fused_device w_down", ndim=3)
    if tuple(xs[0].shape) != (n * E * cap_e, D) or tuple(dq[0].shape) != (E, I, D):
        raise ValueError(f"ep_moe_fused_device: x {tuple(xs[0].shape)}, w_gate_up "
                         f"{tuple(gq[0].shape)}, w_down {tuple(dq[0].shape)}; want x "
                         f"[{n}*{E}*{cap_e}, {D}] and w_down [{E}, {I}, {D}]")
    if xs[0].device.type == "cpu":
        return ep_moe_fused_device_ref(xs, wgu, wd, cap_e=cap_e)
    dt = xs[0].dtype
    wdt = torch.int8 if quant else dt
    vec = 16 // xs[0].element_size()
    if (dt not in _TILE or gq[0].dtype != wdt or dq[0].dtype != wdt or D % vec or I % vec):
        raise ValueError(f"ep_moe_fused_device: x {dt} with panels {gq[0].dtype}; the kernel "
                         "takes bf16 or f32 x, panels of its dtype or int8 QuantW, D and I "
                         f"multiples of {vec} (D={D}, I={I})")
    scales = []
    if quant:
        scales = ([w.s.float().contiguous() for w in wgu], [w.s.float().contiguous() for w in wd])
        _comm.check_parts(scales[0], mesh, "ep_moe_fused_device w_gate_up scales")
        _comm.check_parts(scales[1], mesh, "ep_moe_fused_device w_down scales")
        if tuple(scales[0][0].shape) != (E, I2) or tuple(scales[1][0].shape) != (E, D):
            raise ValueError("ep_moe_fused_device: QuantW scales must be [E, 2I] and [E, D]")
    recv = [torch.empty((E, n * cap_e, D), dtype=dt, device=x.device) for x in xs]
    h = [torch.empty((E, n * cap_e, I), dtype=dt, device=x.device) for x in xs]
    yback = [torch.empty((n, E, cap_e, D), dtype=dt, device=x.device) for x in xs]
    tile = _TILE[dt]
    G = _comm.ctas(mesh, n * E * -(-cap_e // tile) * -(-max(I, D) // tile))
    ptrs = lambda ts: [t.data_ptr() for t in ts]  # noqa: E731

    def call(lib, first, n_local, epoch, sig, st):
        lib.ep_moe_fused(DTYPE_CODES[dt], DTYPE_CODES[wdt], ptrs(xs), ptrs(gq),
                         ptrs(scales[0]) if quant else [], ptrs(dq),
                         ptrs(scales[1]) if quant else [], ptrs(recv), ptrs(h), ptrs(yback),
                         sig, first, n_local, epoch, E, cap_e, D, I, G, st)

    _comm.launch("ep_moe_fused", mesh, call)
    return yback
