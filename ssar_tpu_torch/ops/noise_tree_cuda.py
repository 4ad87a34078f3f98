"""ctypes binding of the noise-tree kernels (csrc/noise_tree.cu), and the
flat plan of a lazy noise tree that they evaluate.

Replaces no TPU kernel: the JAX package leaves the random-patch system's
noise trees (``generate/noise.py``) to XLA, which traces a chunk's trees with
the synthesis into one program (``ssar_tpu/generate/sample.py:101-120``).
Evaluated eagerly, a tree is ~80 launches a window and the host's enqueue of
a chunk's 17 trees kept the card idle; through these kernels it is two
launches (one when the tree has no ``Loop`` leaf).

The kernels are bound by bytes: a tree reads each bank plane once and writes
its (b, H, W) float32 window once.  ``noise_tree.cu`` keeps a tile of 16
frames of accumulators in registers a pixel, builds the per-frame weights of
every plane in shared memory from the modulators' window rows on the card,
and writes no temporary; the Loop leaves' RMS comes from a first kernel's
fixed-order partial sums (no atomics, so two calls give the same bits).

A ``Plan`` is the tree in the kernels' affine form, built once a tree
(``generate/noise.py:flatten``): the nodes in pre-order with the factor each
applies on the way into its parent, the bank leaves, the Loop leaves, the
ScaleBias biases and the opaque leaves (nodes of other types, evaluated by
their own call every window).  Its records go to the card in one
non-blocking copy from pinned memory at the first window.  ``evaluate_plain``
is the same affine form in plain PyTorch, the reference the tests hold the
flattening to; the nodes' eager bodies are the plain version of the whole.

Counters: ``launches`` (kernel launches), ``trees`` (windows evaluated by
the kernels) and ``opaque_leaves`` (nodes evaluated eagerly inside them).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from . import _build

CONST, MOD, ONE_MINUS_MOD = 0, 1, 2   # what a node's value is multiplied by on its way into its parent
EPS = float(torch.finfo(torch.float32).eps)
THREADS = 256                          # csrc/noise_tree.cu's block
MAX_SHARED = 232448                    # bytes of shared memory a block can have (the tables' limit)

launches = 0
trees = 0
opaque_leaves = 0

_fn = None             # the library's ssar_noise_tree_f32, once bound
_shared_bytes = None   # and its ssar_noise_tree_shared_bytes
_sm_count: dict[int, int] = {}


class _Node(ctypes.Structure):
    _fields_ = [("mod", ctypes.c_void_p), ("mod_stride", ctypes.c_longlong), ("parent", ctypes.c_int),
                ("kind", ctypes.c_int), ("constant", ctypes.c_float), ("mod_len", ctypes.c_int)]


class _Bank(ctypes.Structure):
    _fields_ = [("planes", ctypes.c_void_p), ("mod", ctypes.c_void_p), ("row_stride", ctypes.c_longlong),
                ("col_stride", ctypes.c_longlong), ("node", ctypes.c_int), ("width", ctypes.c_int),
                ("blend", ctypes.c_int), ("mod_len", ctypes.c_int)]


class _Loop(ctypes.Structure):
    _fields_ = [("noise", ctypes.c_void_p), ("idx", ctypes.c_void_p), ("idx_stride", ctypes.c_longlong),
                ("node", ctypes.c_int), ("len", ctypes.c_int), ("inv", ctypes.c_float), ("pad", ctypes.c_int)]


class _Bias(ctypes.Structure):
    _fields_ = [("node", ctypes.c_int), ("bias", ctypes.c_float)]


_ENTRY_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_longlong] \
    + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
_RECORDS = (_Node, _Bank, _Loop, _Bias)


def bind(lib: ctypes.CDLL):
    """The library's entry point and its shared-memory count with their
    argument types, after checking that the binding's records have the sizes
    the source gives them."""
    sizes = (ctypes.c_int * 4)()
    lib.ssar_noise_tree_record_sizes(sizes)
    if list(sizes) != [ctypes.sizeof(r) for r in _RECORDS]:
        raise RuntimeError(f"noise_tree.cu's records are {list(sizes)} bytes, the binding's "
                           f"{[ctypes.sizeof(r) for r in _RECORDS]}")
    lib.ssar_noise_tree_shared_bytes.argtypes = [ctypes.c_int] * 4
    lib.ssar_noise_tree_shared_bytes.restype = ctypes.c_longlong
    fn = lib.ssar_noise_tree_f32
    fn.argtypes = _ENTRY_ARGTYPES
    fn.restype = ctypes.c_int
    return fn, lib.ssar_noise_tree_shared_bytes


class Packed(NamedTuple):
    """A plan's records on its device, and what a launch takes of them."""

    host: torch.Tensor       # the records (pinned on a card: kept until the copy has run)
    buffer: torch.Tensor     # the same bytes on the plan's device
    pointers: list           # nodes, banks, loops, biases, opaque node numbers
    counts: tuple            # nodes, banks, planes, loops, biases, opaque leaves
    max_window: int          # the fewest rows of any windowed tensor


@dataclass(eq=False)
class Plan:
    """A noise tree in the kernels' affine form (see the module's docstring).

    ``nodes``: (parent, kind, constant, modulator (T,) or None) in pre-order;
    ``banks``: (node, planes (P, H, W), modulator (T, M), blend);
    ``loops``: (node, noise (3, H, W), phases (T,), 1 / (sigma / 50) in float32);
    ``biases``: (node, bias); ``opaque``: (node, module)."""

    size: tuple[int, int]
    device: torch.device
    nodes: list = field(default_factory=list)
    banks: list = field(default_factory=list)
    loops: list = field(default_factory=list)
    biases: list = field(default_factory=list)
    opaque: list = field(default_factory=list)
    packed: Packed | None = None

    def add_node(self, parent: int, kind: int, constant: float = 1.0, mod: torch.Tensor | None = None) -> int:
        self.nodes.append((parent, kind, float(np.float32(constant)), mod))
        return len(self.nodes) - 1

    @property
    def n_planes(self) -> int:
        return sum(planes.shape[0] for _, planes, _, _ in self.banks)


def loop_inverse(sigma: float) -> float:
    """1 / (sigma / 50) as PyTorch's CUDA division by a host scalar forms it:
    the reciprocal of the float32 divisor, in float32."""
    return float(np.float32(1.0) / np.float32(sigma / 50))


def _check_tensor(x: torch.Tensor, device: torch.device, what: str, contiguous: bool = True):
    if x.device != device:
        raise ValueError(f"noise tree: {what} lies on {x.device}, the tree's other tensors on {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"noise tree: {what} is {x.dtype}; the kernels take float32")
    if contiguous and not x.is_contiguous():
        raise ValueError(f"noise tree: {what} is not contiguous")


def _records(plan: Plan):
    """The plan's four record arrays and its opaque leaves' node numbers,
    after checking every tensor it points to."""
    H, W = plan.size
    nodes = (_Node * len(plan.nodes))()
    for r, (parent, kind, constant, mod) in zip(nodes, plan.nodes):
        r.parent, r.kind, r.constant = parent, kind, constant
        if mod is not None:
            _check_tensor(mod, plan.device, "a Modulate's modulator", contiguous=False)
            if mod.ndim != 1:
                raise ValueError(f"noise tree: a Modulate's modulator is {tuple(mod.shape)}, not (T,)")
            r.mod, r.mod_stride, r.mod_len = mod.data_ptr(), mod.stride(0), mod.shape[0]
    banks = (_Bank * len(plan.banks))()
    for r, (node, planes, mod, blend) in zip(banks, plan.banks):
        _check_tensor(planes, plan.device, "a bank")
        _check_tensor(mod, plan.device, "a Blend's or Multiply's modulator", contiguous=False)
        width = planes.shape[0] // (2 if blend else 1)
        if tuple(planes.shape[1:]) != (H, W) or mod.ndim != 2 or mod.shape[1] != width:
            raise ValueError(f"noise tree: a bank of {tuple(planes.shape)} with a modulator of {tuple(mod.shape)} "
                             f"in a tree of {H}x{W}")
        r.planes, r.mod, r.row_stride, r.col_stride = planes.data_ptr(), mod.data_ptr(), mod.stride(0), mod.stride(1)
        r.node, r.width, r.blend, r.mod_len = node, width, int(blend), mod.shape[0]
    loops = (_Loop * len(plan.loops))()
    for r, (node, noise, idx, inv) in zip(loops, plan.loops):
        _check_tensor(noise, plan.device, "a Loop's bank")
        _check_tensor(idx, plan.device, "a Loop's phases", contiguous=False)
        if tuple(noise.shape) != (3, H, W) or idx.ndim != 1:
            raise ValueError(f"noise tree: a Loop of {tuple(noise.shape)} in a tree of {H}x{W}")
        r.noise, r.idx, r.idx_stride, r.node, r.len, r.inv = noise.data_ptr(), idx.data_ptr(), idx.stride(0), \
            node, idx.shape[0], inv
    biases = (_Bias * len(plan.biases))(*[_Bias(node, bias) for node, bias in plan.biases])
    opaque = (ctypes.c_int * len(plan.opaque))(*[node for node, _ in plan.opaque])
    return nodes, banks, loops, biases, opaque


def pack(plan: Plan, shared_bytes) -> Packed:
    """The plan's records in one buffer on its device (one non-blocking copy
    from pinned memory on a card), after checking every tensor they point to.
    `shared_bytes` is the library's ``ssar_noise_tree_shared_bytes``."""
    counts = (len(plan.nodes), len(plan.banks), plan.n_planes, len(plan.loops), len(plan.biases), len(plan.opaque))
    need = shared_bytes(counts[0], counts[2], counts[3], counts[5])
    if need > MAX_SHARED:
        raise ValueError(f"noise tree of {counts[0]} nodes and {counts[2]} bank planes: the kernel's tables take "
                         f"{need} bytes of shared memory, more than a block has ({MAX_SHARED})")
    parts = [bytes(a) for a in _records(plan)]
    offsets, total = [], 0
    for p in parts:
        offsets.append(total)
        total += -(-len(p) // 16) * 16
    host = torch.zeros(max(total, 16), dtype=torch.uint8)
    view = host.numpy()
    for off, p in zip(offsets, parts):
        view[off : off + len(p)] = np.frombuffer(p, dtype=np.uint8)
    if plan.device.type == "cuda":
        host = host.pin_memory()
        buf = host.to(plan.device, non_blocking=True)
    else:
        buf = host
    rows = [m.shape[0] for _, _, _, m in plan.nodes if m is not None]
    rows += [m.shape[0] for _, _, m, _ in plan.banks] + [idx.shape[0] for _, _, idx, _ in plan.loops]
    return Packed(host, buf, [buf.data_ptr() + off for off in offsets], counts, min(rows, default=2**31 - 1))


def partial_blocks(hw: int, sm_count: int) -> int:
    """Blocks of the loop-sum kernel, one partial sum each: two an SM at most."""
    return min(-(-hw // THREADS), 2 * sm_count)


def run(plan: Plan, i: int, b: int, entry, sm_count: int) -> torch.Tensor:
    """The plan's window of frames [i, i + b), (b, H, W) float32, by
    ``entry(*args)``: the library's ``ssar_noise_tree_f32`` with the stream
    bound.  Evaluates the opaque leaves by their own call first."""
    global launches, trees, opaque_leaves
    i, b = int(i), int(b)
    pointers, counts, max_window = plan.packed.pointers, plan.packed.counts, plan.packed.max_window
    if not 1 <= b <= max_window:
        raise ValueError(f"noise tree: a window of {b} frames; the tree's tensors have {max_window} rows")
    H, W = plan.size
    hw, dev = H * W, plan.device
    opaque = None
    if plan.opaque:
        windows = []
        for _, module in plan.opaque:
            x = torch.as_tensor(module(i, b))
            _check_tensor(x, dev, f"the window of {type(module).__name__}", contiguous=False)
            if tuple(x.shape) != (b, H, W):
                raise ValueError(f"noise tree: {type(module).__name__} gave {tuple(x.shape)}, expected {(b, H, W)}")
            windows.append(x)
        opaque = windows[0].contiguous() if len(windows) == 1 else torch.stack(windows)
        opaque_leaves += len(windows)
    out = torch.empty(b, H, W, device=dev, dtype=torch.float32)
    n_partials = partial_blocks(hw, sm_count)
    partials = torch.empty(counts[3] * b * n_partials, device=dev, dtype=torch.float32) if counts[3] else None
    err = entry(*pointers, *counts, i, b, hw, None if opaque is None else opaque.data_ptr(),
                None if partials is None else partials.data_ptr(), n_partials, out.data_ptr(), sm_count)
    if err != 0:
        raise RuntimeError(f"noise tree launch failed: cudaError {err}")
    launches += 2 if counts[3] else 1
    trees += 1
    return out


def noise_tree_cuda(plan: Plan, i: int, b: int) -> torch.Tensor:
    """The window of frames [i, i + b) of a tree whose tensors lie on a CUDA
    card, (b, H, W) float32, in two launches on PyTorch's current stream."""
    global _fn, _shared_bytes
    if plan.device.type != "cuda":
        raise ValueError(f"noise_tree_cuda takes a tree on a CUDA card, not on {plan.device}")
    if _fn is None:
        _fn, _shared_bytes = bind(_build.load("noise_tree"))
    if plan.packed is None:
        plan.packed = pack(plan, _shared_bytes)
    sm = _sm_count.get(plan.device.index)
    if sm is None:
        sm = _sm_count[plan.device.index] = torch.cuda.get_device_properties(plan.device).multi_processor_count
    return run(plan, i, b, lambda *args: _build.launch(_fn, plan.device, *args), sm)


def _window(x: torch.Tensor, i: int, b: int) -> torch.Tensor:
    i = max(0, min(int(i), x.shape[0] - b))
    return x[i : i + b]


def evaluate_plain(plan: Plan, i: int, b: int) -> torch.Tensor:
    """The plan's window in plain PyTorch, in the kernels' affine form: each
    node's per-frame coefficient (the product of the factors on its path to
    the root), the weighted bank planes, the normalised loops, the opaque
    leaves and the biases."""
    H, W = plan.size
    coef = []
    for parent, kind, constant, mod in plan.nodes:
        if kind == CONST:
            f = torch.full((b,), constant, dtype=torch.float32, device=plan.device)
        else:
            m = _window(mod, i, b)
            f = m if kind == MOD else 1 - m
        coef.append(f if parent < 0 else coef[parent] * f)
    out = torch.zeros(b, H, W, dtype=torch.float32, device=plan.device)
    for node, bias in plan.biases:
        out = out + (coef[node] * bias)[:, None, None]
    for node, planes, mod, blend in plan.banks:
        m = _window(mod, i, b)
        weights = coef[node][:, None] * (torch.cat([m, 1 - m], dim=1) if blend else m)
        out = out + torch.einsum("bk,khw->bhw", weights, planes)
    for node, noise, idx, inv in plan.loops:
        raw = torch.sin(torch.cos(_window(idx, i, b)[:, None, None] + noise[0]) * inv + noise[1]) * noise[2]
        rms = torch.sqrt(torch.mean(raw**2, dim=(1, 2)))
        out = out + (coef[node] / (rms + EPS))[:, None, None] * raw
    for node, module in plan.opaque:
        out = out + coef[node][:, None, None] * module(i, b)
    return out

