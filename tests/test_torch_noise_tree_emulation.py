"""The noise-tree CUDA source runs on the host against the eager trees.

``csrc/noise_tree.cu`` compiles as plain C++ with ``-DSSAR_HOST_EMULATION``
(``csrc/host_emulation.h``: one host thread per CUDA thread, block after
block), so its per-frame tables (node coefficients, plane weights, the loops'
RMS from fixed-order partial sums, the biases), the window clamps and the
grid-stride pixel loops are held against ``generate/noise.py``'s eager bodies
on the CPU, each window within 1e-5 of its largest magnitude (the affine form
adds in another order; the CPU's cosine and sine are not the card's, and it
divides by sigma / 50 where the card multiplies by its reciprocal).  The flat
plan is also held to the eager trees in plain PyTorch
(``noise_tree_cuda.evaluate_plain``).  Whether nvcc accepts the source, and
how fast it is, only the card can say (``chip_smoke.py``,
``tests/test_torch_cuda.py``).  Needs g++ with C++20; skips without one.
"""
import pytest
import torch
from test_torch_median_emulation import _emulated

from ssar_tpu_torch.generate import keys
from ssar_tpu_torch.generate import noise as N
from ssar_tpu_torch.generate.mir import ALLFEATS, UNITFEATS
from ssar_tpu_torch.ops import noise_tree_cuda

T = 40


@pytest.fixture(scope="module")
def entry():
    fn, shared_bytes = noise_tree_cuda.bind(_emulated("noise_tree"))
    return fn, shared_bytes


def _kernel(entry, tree, i, b, sm_count=1):
    """`tree`'s window through the emulated kernels, with the wrapper's plan
    and records (``flatten``, ``pack``, ``run``)."""
    fn, shared_bytes = entry
    plan = N.flatten(tree)
    plan.packed = noise_tree_cuda.pack(plan, shared_bytes)
    return noise_tree_cuda.run(plan, i, b, lambda *args: fn(*args, None), sm_count)


def _features(seed, widths=(("chromagram", 3), ("tonnetz", 2), ("mfcc", 4), ("spectral_contrast", 2))):
    g = torch.Generator().manual_seed(seed)
    feats = {name: torch.rand(T, m, generator=g) for name, m in widths}
    feats.update({name: torch.rand(T, 1, generator=g) for name in UNITFEATS})
    return feats


class Wobble(N.Noise):
    """A user's own node: a (T, H, W) sequence sliced per window."""

    def __init__(self, seed, size):
        super().__init__(T, size)
        self.seq = torch.randn(T, *size, generator=torch.Generator().manual_seed(seed))

    def __call__(self, i, b):
        return N._win(self.seq, i, b) * 0.5


class ShiftedBlend(N.Blend):
    """A subclass of a kernel node with its own call: opaque too."""

    def __call__(self, i, b):
        return super().eager(i, b) + 1.0


def _tree(kind, size=(8, 12), seed=0):
    f = _features(seed)
    k = [keys.PRNGKey(seed * 100 + j) for j in range(6)]
    loop = N.Loop(k[0], T, size, n_loops=3.0, sigma=4.0)
    blend = N.Blend(k[1], T, size, 0.7 * f["chromagram"])
    mult = N.Multiply(k[2], T, size, f["mfcc"])
    if kind == "loop":
        return loop
    if kind == "blend":
        return blend
    if kind == "multiply":
        return mult
    if kind == "average":
        return N.ScaleBias(N.Average(loop, blend), 0.9, -0.2)
    if kind == "modulate":
        return N.ScaleBias(N.Modulate(loop, mult, 0.8 * f["rms"]), 0.6, 0.1)
    if kind == "replace":
        return N.ScaleBias(blend, 1.3, 0.4)
    if kind == "nested_scalebias":
        inner = N.ScaleBias(N.Modulate(N.ScaleBias(loop, 0.5, 0.2), blend, f["onsets"]), 1.7, -0.3)
        return N.ScaleBias(N.Average(inner, N.ScaleBias(mult, 0.25, 0.05)), 0.8, 0.6)
    if kind == "opaque":
        return N.ScaleBias(N.Modulate(N.Average(loop, Wobble(seed, size)), ShiftedBlend(k[3], T, size, f["tonnetz"]),
                                      f["drop_strength"]), 0.7, 0.2)
    if kind == "patch20":
        layers = [N.Loop(k[4], T, size, n_loops=2.0, sigma=7.0)] * 17
        rng = torch.Generator().manual_seed(seed)
        for j in range(20):
            pick = lambda opts: opts[int(torch.randint(len(opts), (1,), generator=rng))]  # noqa: E731
            layers = N.noise_patch(keys.PRNGKey(1000 + j), layers, f, 120.0, 24, patch_type=pick(["blend", "multiply", "loop"]),
                                   loop_bars=pick([4, 8]), seq_feat=pick(ALLFEATS), seq_feat_weight=0.6,
                                   mod_feat=pick(UNITFEATS), mod_feat_weight=0.9,
                                   merge_type=pick(["average", "modulate", "modulate"]),
                                   merge_depth="low", noise_mean=0.1 * j - 1, noise_std=0.7)
        return layers[3]   # 61 nodes: the base loop under 20 merges (the "replace" case drops the tree below it)
    raise ValueError(kind)


KINDS = ["loop", "blend", "multiply", "average", "modulate", "replace", "nested_scalebias", "opaque", "patch20"]
WINDOWS = [(0, 16), (T - 16, 16), (33, 16), (-3, 4)]   # (33, 16) and (-3, 4): starts clamped as _win clamps them


def _close(got, want, what):
    assert got.shape == want.shape, what
    gap = float((got - want).abs().max() / want.abs().max())
    assert gap <= 1e-5, f"{what}: {gap}"


@pytest.mark.parametrize("kind", KINDS)
def test_emulated_kernels_match_the_eager_tree(entry, kind):
    tree = _tree(kind)
    for i, b in WINDOWS:
        _close(_kernel(entry, tree, i, b), tree(i, b), f"{kind} at ({i}, {b})")


@pytest.mark.parametrize("b", [1, 20])
def test_emulated_kernels_take_any_window_length(entry, b):
    """b = 1 (one frame of the 16-frame tile) and b = 20 (two tiles)."""
    tree = _tree("nested_scalebias", seed=3)
    for i in (0, 17, T):
        _close(_kernel(entry, tree, i, b), tree(i, b), f"({i}, {b})")


@pytest.mark.parametrize("size,sm_count", [((5, 9), 1), ((24, 40), 1), ((40, 40), 1), ((40, 40), 132)])
def test_emulated_kernels_on_non_square_and_multi_block_layers(entry, size, sm_count):
    """Non-square layers; at one SM, more pixels than the blocks' threads, so
    both kernels' grid-stride loops and several partial sums a loop run."""
    tree = _tree("modulate", size=size, seed=5)
    _close(_kernel(entry, tree, 7, 16, sm_count), tree(7, 16), f"{size}")


def test_emulated_kernels_are_deterministic_and_counted(entry):
    tree = _tree("opaque", size=(24, 40), seed=7)
    before = (noise_tree_cuda.launches, noise_tree_cuda.trees, noise_tree_cuda.opaque_leaves)
    first, second = _kernel(entry, tree, 5, 16), _kernel(entry, tree, 5, 16)
    assert torch.equal(first, second)
    after = (noise_tree_cuda.launches, noise_tree_cuda.trees, noise_tree_cuda.opaque_leaves)
    assert [a - b for a, b in zip(after, before)] == [4, 2, 4]   # 2 launches, 1 tree, 2 opaque nodes a window


@pytest.mark.parametrize("kind", KINDS)
def test_flat_plan_in_plain_pytorch_equals_the_eager_tree(kind):
    """The affine form: node coefficients as products along the path to the
    root, weighted planes, normalised loops, opaque leaves and biases."""
    tree = _tree(kind, seed=11)
    plan = N.flatten(tree)
    for i, b in WINDOWS + [(9, 1), (0, 20)]:
        _close(noise_tree_cuda.evaluate_plain(plan, i, b), tree(i, b), f"{kind} at ({i}, {b})")
    assert N.eager(tree, 4, 8).equal(tree(4, 8))   # on the CPU a call is the eager tree
    assert tree._plan is False


def test_flat_plan_shape_and_refusals(entry):
    tree = _tree("opaque", seed=13)
    plan = N.flatten(tree)
    kinds = [kind for _, kind, _, _ in plan.nodes]
    assert (len(plan.nodes), len(plan.banks), len(plan.loops), len(plan.biases), len(plan.opaque)) == (6, 0, 1, 1, 2)
    assert kinds.count(noise_tree_cuda.MOD) == kinds.count(noise_tree_cuda.ONE_MINUS_MOD) == 1
    assert all(parent < n for n, (parent, _, _, _) in enumerate(plan.nodes))
    with pytest.raises(ValueError, match="window of 41"):
        _kernel(entry, tree, 0, T + 1)
    bad = N.Average(_tree("loop"), N.Loop(keys.PRNGKey(5), T, (8, 10)))
    with pytest.raises(ValueError, match="tree of 8x12"):
        _kernel(entry, bad, 0, 4)
    wide = N.Multiply(keys.PRNGKey(6), T, (1, 2), torch.rand(T, 4000))   # 64,000 weights a tile: past a block's memory
    with pytest.raises(ValueError, match="shared memory"):
        _kernel(entry, wide, 0, 4)
