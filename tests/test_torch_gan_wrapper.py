"""The port's StyleGAN2 wrapper, checkpoint loaders, resize and render loop
against the JAX package's, on the CPU, in float32.

Both packages read the same checkpoint files (the test writes each from one
JAX parameter tree) and the same numpy latents and noises.  Loaded parameters
must be equal exactly; images are held at rtol 1e-5 of their scale, as in
tests/test_torch_gan.py (convolutions summed in another order); resize at
1e-5 of the scale (one product per axis against JAX's one einsum); uint8
frames within one level (a value that sits on a rounding boundary may round
either way).  Bend transforms are written once per package: JAX's take NHWC
activations, the port's NCHW.
"""
import functools
import importlib
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ssar_tpu_torch.gan import convert as t_convert
from ssar_tpu_torch.gan import render as t_render
from ssar_tpu_torch.gan import stylegan2 as ts
from ssar_tpu_torch.gan import wrapper as t_wrap
from ssar_tpu_torch.generate import audio2video as t_a2v
from ssar_tpu_torch.ops.resize import resize

js = importlib.import_module("ssar_tpu.gan.stylegan2")
j_convert = importlib.import_module("ssar_tpu.gan.convert")
j_wrap = importlib.import_module("ssar_tpu.gan.wrapper")
j_render = importlib.import_module("ssar_tpu.gan.render")
j_a2v = importlib.import_module("ssar_tpu.generate.audio2video")

CFG = dict(resolution=32, max_channels=16)
JC, TC = js.StyleGAN2Config(**CFG), ts.StyleGAN2Config(**CFG)


def _close(got, want, rtol=1e-5):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.fixture(scope="module")
def jparams():
    """A JAX random init with non-zero biases, noise weights and w_avg."""
    rng = np.random.RandomState(5)
    p = jax.tree_util.tree_map(np.asarray, js.init_generator(jax.random.PRNGKey(0), JC))
    for layer in [p["conv1"], p["to_rgb1"], *p["convs"], *p["to_rgbs"]]:
        layer["bias"] = (layer["bias"] + 0.1 * rng.randn(*layer["bias"].shape)).astype(np.float32)
        if "noise_weight" in layer:
            layer["noise_weight"] = np.float32(rng.randn())
    p["w_avg"] = (0.1 * rng.randn(512)).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def files(jparams, tmp_path_factory):
    """The JAX tree as a rosinality .pt, an ada-pytorch .pkl and a JAX .npz."""
    d = tmp_path_factory.mktemp("ckpt")
    sd = {}

    def styled(prefix, q):
        sd[f"{prefix}.conv.weight"] = torch.tensor(q["weight"].transpose(3, 2, 0, 1)[None])
        sd[f"{prefix}.conv.modulation.weight"] = torch.tensor(q["mod"]["weight"].T)
        sd[f"{prefix}.conv.modulation.bias"] = torch.tensor(q["mod"]["bias"])
        if "noise_weight" in q:
            sd[f"{prefix}.noise.weight"] = torch.tensor(np.asarray(q["noise_weight"]).reshape(1))
            sd[f"{prefix}.activate.bias"] = torch.tensor(q["bias"])
        else:
            sd[f"{prefix}.bias"] = torch.tensor(q["bias"].reshape(1, 3, 1, 1))

    for i, lin in enumerate(jparams["mapping"]):
        sd[f"style.{i + 1}.weight"] = torch.tensor(lin["weight"].T)
        sd[f"style.{i + 1}.bias"] = torch.tensor(lin["bias"])
    sd["input.input"] = torch.tensor(jparams["const"].transpose(2, 0, 1)[None])
    styled("conv1", jparams["conv1"])
    styled("to_rgb1", jparams["to_rgb1"])
    for i, q in enumerate(jparams["convs"]):
        styled(f"convs.{i}", q)
    for i, q in enumerate(jparams["to_rgbs"]):
        styled(f"to_rgbs.{i}", q)
    sd["latent_avg"] = torch.tensor(jparams["w_avg"])
    torch.save({"g_ema": sd}, d / "g.pt")

    def ada(q):
        out = {"weight": q["weight"].transpose(3, 2, 0, 1), "bias": q["bias"],
               "affine.weight": q["mod"]["weight"].T, "affine.bias": q["mod"]["bias"]}
        if "noise_weight" in q:
            out["noise_strength"] = np.asarray(q["noise_weight"])
        return out

    flat = {"synthesis.b4.const": jparams["const"].transpose(2, 0, 1), "mapping.w_avg": jparams["w_avg"]}
    for i, lin in enumerate(jparams["mapping"]):
        flat[f"mapping.fc{i}.weight"], flat[f"mapping.fc{i}.bias"] = lin["weight"].T, lin["bias"]
    blocks = [("synthesis.b4.conv1", jparams["conv1"]), ("synthesis.b4.torgb", jparams["to_rgb1"])]
    for i in range(3, JC.log_size + 1):
        blocks += [(f"synthesis.b{2**i}.conv0", jparams["convs"][2 * (i - 3)]),
                   (f"synthesis.b{2**i}.conv1", jparams["convs"][2 * (i - 3) + 1]),
                   (f"synthesis.b{2**i}.torgb", jparams["to_rgbs"][i - 3])]
    for name, q in blocks:
        flat.update({f"{name}.{k}": v for k, v in ada(q).items()})
    (d / "net.pkl").write_bytes(pickle.dumps({"G_ema": {"state": flat}}))

    j_convert.save_npz(str(d / "g.npz"), jax.tree_util.tree_map(jnp.asarray, jparams))
    return {"pt": str(d / "g.pt"), "pkl": str(d / "net.pkl"), "npz": str(d / "g.npz")}


# ------------------------------------------------------------- checkpoints --
@pytest.mark.parametrize("kind", ["pt", "pkl", "npz"])
def test_loaders_give_the_jax_loaders_parameters(jparams, files, kind):
    """Each loader's parameters equal ``params_from_jax`` of the JAX loader's,
    leaf for leaf; through ``load_params`` the synthesis matches JAX's."""
    want = {"pt": lambda: j_convert.load_rosinality_pt(files["pt"], JC),
            "pkl": lambda: j_convert.load_nvidia_pkl(files["pkl"], JC),
            "npz": lambda: j_convert.load_npz(files["npz"])}[kind]()
    got = t_wrap.load_params(files[kind], TC, device="cpu")
    want_t = dict(_leaves(ts.params_from_jax(want)))
    got_t = dict(_leaves(got))
    assert set(got_t) == set(want_t)
    for k in want_t:
        assert torch.equal(got_t[k], want_t[k]), k
    lat = np.random.RandomState(1).randn(2, JC.n_latent, 512).astype(np.float32)
    _close(ts.synthesis(got, torch.as_tensor(lat), None, TC),
           js.synthesis(jax.tree_util.tree_map(jnp.asarray, want), jnp.asarray(lat), None, JC, s2d=False))


def test_save_npz_is_read_by_both_packages(jparams, tmp_path):
    params = ts.params_from_jax(jparams)
    t_convert.save_npz(str(tmp_path / "port.npz"), params)
    back = dict(_leaves(j_convert.load_npz(str(tmp_path / "port.npz"))))
    for k, v in _leaves(jparams):
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(v), err_msg=k)
    for (k, a), (_, b) in zip(_leaves(params), _leaves(t_convert.load_npz(str(tmp_path / "port.npz")))):
        assert torch.equal(a, b), k


# ------------------------------------------------------------------ resize --
@pytest.mark.parametrize("shape", [(2, 32, 24, 3), (2, 8, 24, 3), (2, 16, 48, 3), (2, 16, 12, 3), (2, 7, 37, 3),
                                   (2, 40, 9, 3), (3, 16, 24, 1)])
@pytest.mark.parametrize("antialias", [True, False])
def test_resize_matches_jax_image_resize(shape, antialias):
    """Up and down on each axis alone and on both, the batch axis too."""
    x = np.random.RandomState(0).randn(2, 16, 24, 3).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), shape, "bilinear", antialias=antialias)
    got = resize(torch.as_tensor(x), shape, antialias=antialias)
    assert tuple(got.shape) == shape
    _close(got, want)


# ------------------------------------------------------------------- bends --
def _bends():
    """(jax bends, port bends): a static scale at level 1, an animated shift
    at level 2 (a (B,) modulation), a replicate pad 4 x 4 -> 4 x 8 at 0."""
    jb = {0: lambda x: jnp.pad(x, ((0, 0), (0, 0), (2, 2), (0, 0)), mode="edge"),
          1: lambda x: 1.5 * x + 0.1,
          2: lambda x, m: x + m[:, None, None, None]}
    tb = {0: lambda x: F.pad(x, (2, 2, 0, 0), mode="replicate"),
          1: lambda x: 1.5 * x + 0.1,
          2: lambda x, m: x + m[:, None, None, None]}
    return jb, tb


def test_synthesis_bends_and_features_match_jax(jparams):
    jb, tb = _bends()
    lat = np.random.RandomState(2).randn(3, JC.n_latent, 512).astype(np.float32)
    mod = np.asarray([0.5, -1.0, 2.0], np.float32)
    img_j, feats_j = js.synthesis(jax.tree_util.tree_map(jnp.asarray, jparams), jnp.asarray(lat), None, JC,
                                  bends=jb, bend_mods={2: jnp.asarray(mod)}, return_features=True, s2d=False)
    img_t, feats_t = ts.synthesis(ts.params_from_jax(jparams), torch.as_tensor(lat), None, TC, bends=tb,
                                  bend_mods={2: torch.as_tensor(mod)}, return_features=True)
    assert tuple(img_t.shape) == img_j.shape == (3, 32, 64, 3)
    _close(img_t, img_j)
    assert len(feats_t) == len(feats_j) == JC.log_size - 1
    for ft, fj in zip(feats_t, feats_j):
        _close(ft.permute(0, 2, 3, 1), fj)


@pytest.mark.parametrize("output_size", [(48, 20), (12, 8), (32, 32), (4, 4)])
def test_synthesizer_sizes_bends_and_noise_keywords_match_jax(files, output_size):
    """Any (W, H): the early exit and the bilinear resize; the reference's
    list of bends with an animated one at `frame_idx` (clipped); noise as
    NCHW ``noise<i>`` keywords."""
    rng = np.random.RandomState(3)
    jsyn = j_wrap.StyleGAN2Synthesizer(files["npz"], output_size=output_size, config=JC, dtype=jnp.float32)
    tsyn = t_wrap.StyleGAN2Synthesizer(files["npz"], output_size=output_size, config=TC, dtype=torch.float32,
                                       device="cpu")
    assert tsyn.synth_res == jsyn.synth_res and tsyn.n_noises_used == jsyn.n_noises_used
    mod = rng.randn(5).astype(np.float32)
    for syn in (jsyn, tsyn):  # the same transforms: they read no spatial axis
        syn.set_bends([{"layer": 1, "transform": lambda x, m: x * (1 + m[:, None, None, None]), "modulation": mod},
                       {"layer": 0, "transform": lambda x: -x}])
    lat = rng.randn(3, JC.n_latent, 512).astype(np.float32)
    noise = {f"noise{i}": rng.randn(3, 1, h, w).astype(np.float32) for i, (h, w) in enumerate(JC.noise_shapes())}
    frame_idx = np.asarray([3, 4, 9])
    want = jsyn(lat, frame_idx=jnp.asarray(frame_idx), **{k: jnp.asarray(v) for k, v in noise.items()})
    got = tsyn(lat, frame_idx=frame_idx, **{k: torch.as_tensor(v) for k, v in noise.items()})
    assert tuple(got.shape) == want.shape == (3, output_size[1], output_size[0], 3)
    _close(got, want)


# ----------------------------------------------- pyramid, generate, seams --
def test_make_noise_pyramid_and_generate_match_jax(jparams):
    base = np.random.RandomState(4).randn(3, 1, 40, 40).astype(np.float32)
    want = j_wrap.make_noise_pyramid(jnp.asarray(base), layers=5, config=JC)
    got = t_wrap.make_noise_pyramid(torch.as_tensor(base), layers=5, config=TC)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want] == [(3, 1, h, w) for h, w in JC.noise_shapes()[:5]]
    for g, w in zip(got, want):
        _close(g, w)
    z = np.random.RandomState(5).randn(2, 512).astype(np.float32)
    _close(ts.generate(ts.params_from_jax(jparams), torch.as_tensor(z), TC, truncation=0.7),
           js.generate(jax.tree_util.tree_map(jnp.asarray, jparams), jnp.asarray(z), JC, truncation=0.7))


def _jax_draw(n, style_dim, seed):
    """The z the JAX package draws: (n, style_dim) for mean_latent, one
    (style_dim,) row per seed for get_w_latents."""
    key = jax.random.PRNGKey(seed)
    z = jax.random.normal(key, (style_dim,))[None] if n == 1 else jax.random.normal(key, (n, style_dim))
    return torch.as_tensor(np.asarray(z))


def test_mean_latent_and_w_latents_through_the_z_seam(files, monkeypatch):
    monkeypatch.setattr(t_wrap, "latent_draw", _jax_draw)
    jg = j_wrap.StyleGAN2(files["npz"], config=JC)
    tg = t_wrap.StyleGAN2(files["npz"], config=TC, device="cpu")
    assert tg.synthesizer.params is tg.mapper.params
    _close(tg.mapper.mean_latent(64, seed=7), jg.mapper.mean_latent(64, seed=7))
    _close(tg.get_w_latents("3,11"), jg.get_w_latents("3,11"))
    _close(tg.get_w_latents([5]), jg.get_w_latents([5]))


def test_stylegan2_render_matches_jax(files):
    rng = np.random.RandomState(6)
    jg = j_wrap.StyleGAN2(files["npz"], config=JC)
    jg.synthesizer = j_wrap.StyleGAN2Synthesizer(files["npz"], config=JC, dtype=jnp.float32)
    tg = t_wrap.StyleGAN2(files["npz"], config=TC, dtype=torch.float32, device="cpu")
    inputs = {"latents": rng.randn(7, JC.n_latent, 512).astype(np.float32),
              "noise": [rng.randn(7, 1, h, w).astype(np.float32) for h, w in JC.noise_shapes()]}
    want = np.stack(list(jg.render(inputs, batch_size=3, postprocess_fn=lambda f: f**2)))
    got = np.stack(list(tg.render(inputs, batch_size=3, postprocess_fn=lambda f: f**2)))
    assert got.shape == want.shape == (7, 32, 32, 3) and got.dtype == np.float32
    _close(got, want)


# ------------------------------------------------------------- render loop --
class _Sink:
    def __init__(self, *args, **kwargs):
        self.frames = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def write_i420(self, frame):
        self.frames.append(np.array(frame))

    def write(self, frame):
        self.frames.append(np.array(frame))


def _jax_sink(monkeypatch):
    sink = _Sink()
    monkeypatch.setattr(j_render, "VideoWriter", lambda *a, **k: sink)
    return sink


def _within_one_level(got, want):
    got, want = np.stack(got).astype(int), np.stack(want).astype(int)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1


@pytest.mark.parametrize("output_size", [(32, 32), (30, 18)])
def test_render_loop_options_match_jax(files, monkeypatch, output_size):
    """`postprocess_fn` (before the clip), a lazy noise callable, None noise
    entries and an animated bend fed `frame_idx`; I420 at (32, 32), uint8 RGB
    at (30, 18) (H % 4 != 0)."""
    rng = np.random.RandomState(8)
    T = 11
    mod = rng.randn(T).astype(np.float32)
    lat = rng.randn(T, JC.n_latent, 512).astype(np.float32)
    full = [rng.randn(T, 1, h, w).astype(np.float32) for h, w in JC.noise_shapes()]
    syns = [j_wrap.StyleGAN2Synthesizer(files["npz"], output_size=output_size, config=JC, dtype=jnp.float32),
            t_wrap.StyleGAN2Synthesizer(files["npz"], output_size=output_size, config=TC, dtype=torch.float32,
                                        device="cpu")]
    for syn in syns:
        syn.set_bends([{"layer": 2, "transform": lambda x, m: x + 0.3 * m[:, None, None, None], "modulation": mod}])

    def lazy(i, b):  # frames [i, i + b) of the third noise map, (b, H, W)
        return full[2][i : i + b, 0]

    noises = [full[0], None, lazy, None, full[4], full[5], full[6]]
    post = lambda f: 1.2 * f - 0.1  # noqa: E731  pushes some values out of [0, 1]
    sink = _jax_sink(monkeypatch)
    j_render.render_latents_to_video(syns[0], jnp.asarray(lat), noises, "unused.mp4", output_size=output_size,
                                     batch_size=4, postprocess_fn=post, progress=False)
    got = t_render.render_latents_to_video(syns[1], torch.as_tensor(lat), noises, output_size=output_size,
                                           batch_size=4, postprocess_fn=post, progress=False, writer=_Sink())
    assert len(got.frames) == len(sink.frames) == T
    assert got.frames[0].shape == ((48, 32) if output_size == (32, 32) else (18, 30, 3))
    _within_one_level(got.frames, sink.frames)


def test_latent2video_matches_jax(files, monkeypatch, tmp_path):
    """A saved (T, n_ws, 512) sequence with its four noise files, re-centred
    around the mapper's latent of a seeded z, rendered in float32 by both
    packages; without the noise files too."""
    rng = np.random.RandomState(9)
    T = 6
    path = str(tmp_path / "walk.npy")
    np.save(path, rng.randn(T, JC.n_latent, 512).astype(np.float32))
    for s in (4, 8, 16, 32):
        np.save(path.replace(".npy", f" - Noise {s}.npy"), rng.randn(T, s, s).astype(np.float32))
    monkeypatch.setattr(j_a2v, "StyleGAN2Synthesizer", functools.partial(j_wrap.StyleGAN2Synthesizer,
                                                                          dtype=jnp.float32))
    monkeypatch.setattr(t_a2v, "StyleGAN2Synthesizer", functools.partial(t_wrap.StyleGAN2Synthesizer,
                                                                          dtype=torch.float32))
    for with_noise in (True, False):
        if not with_noise:
            (tmp_path / "walk - Noise 32.npy").unlink()
        sink = _jax_sink(monkeypatch)
        j_a2v.latent2video(None, path, "unused.mp4", model_file=files["npz"], output_size=(32, 32), batch_size=4,
                           offset=1 / 24, seed=5, gan_config=JC)
        got = t_a2v.latent2video(None, path, model_file=files["npz"], output_size=(32, 32), batch_size=4,
                                 offset=1 / 24, seed=5, gan_config=TC, device="cpu", writer=_Sink())
        assert len(got.frames) == len(sink.frames) == T - 1
        _within_one_level(got.frames, sink.frames)
