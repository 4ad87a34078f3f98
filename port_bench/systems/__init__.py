"""One module a system under test, named by a configuration's ``system`` key:
``System(config, mix, seed, device, spans, tracks)`` builds it from the seed
and warms the cell's shapes; ``serve(track, sink)`` drives the port's entry
once; ``check(...)`` holds what the window produced against the plain
reference."""


def generator_config(g: dict):
    """The port's ``StyleGAN2Config`` of a configuration file's ``generator``."""
    from ssar_tpu_torch.gan.stylegan2 import StyleGAN2Config

    return StyleGAN2Config(resolution=g["resolution"], style_dim=g["style_dim"], n_mlp=g["n_mlp"],
                           channel_multiplier=g["channel_multiplier"], blur_kernel=tuple(g["blur_kernel"]),
                           lr_mlp=g["lr_mlp"], max_channels=g["max_channels"])
